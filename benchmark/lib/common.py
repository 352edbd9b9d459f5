"""Pieces the traffic generators share: building a model on the device from the
seed, merging configuration overrides, host timing and clean-up."""

from __future__ import annotations

import copy
import gc
import time

import torch

from lib import weights


def merged(base: dict, over: dict) -> dict:
    """A deep copy of `base` with the dicts of `over` merged in."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def on_device(make, seed: int, device):
    """The module `make()` builds, allocated on `device` (its own
    initialization runs there, and costs far less than building it on the
    meta device, whose first use imports torch's Python decompositions),
    then its parameters drawn by `weights.fill_`."""
    with torch.device(device):
        module = make()
    weights.fill_(module, seed, device)
    return module


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Host-clock spans of the calls into a layer."""

    def __init__(self, device):
        self.device = device
        self.spans: dict = {}

    def timed(self, name: str, fn, *args, device_sync: bool = True, **kw):
        """fn(*args, **kw), its span ended by a device synchronize unless
        device_sync is False (a host-side call such as a loader's next())."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        if device_sync:
            sync(self.device)
        self.spans.setdefault(name, []).append(time.perf_counter() - t)
        return out


class Phases:
    """Host-clock marks through a generator's set-up: {phase: seconds since
    the previous mark}."""

    def __init__(self):
        self.seconds: dict = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        t = time.perf_counter()
        self.seconds[name] = t - self._t
        self._t = t


def free_device(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


class Precision:
    """TF32 for matmuls and for cuDNN set inside the block, restored
    after: the reference states its float32 with these flags."""

    def __init__(self, matmul_tf32: bool = False, cudnn_tf32: bool = False):
        self.flags = (matmul_tf32, cudnn_tf32)

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.flags
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
