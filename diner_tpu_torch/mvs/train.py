"""Training of the MVS cascade (port of the train and finetune modes of
diner_tpu.cli.mvs), on one device.

Adam with optax's defaults over the net's parameters, its learning rate
from `warmup_multistep` at the count of updates already applied (so the
first update has lr 0, as optax evaluates its schedule at count 0). Each
epoch visits the dataset in np.random.RandomState(seed + epoch)'s
permutation, and a batch that runs past the epoch's end wraps around to its
start, so every batch is full. The net runs in train mode: BatchNorm on
the batch statistics, FeatureNet once per view (mvs/net.py).

Checkpoints go to <logdir>/ckpts/step_<8 digits>.pt through
train/ckpt_io.py's conventions (labelled by steps completed, re-saving a
step is a no-op, written through an atomic rename): {"model": the net's
state_dict (weights and BatchNorm statistics), "optimizer": Adam's
state_dict, "step"}. "model" is the reference checkpoints' key, so `write
--ckpt`, `eval --ckpt` and --torch-ckpt all load them. A resume adopts the
optimizer state only when its layout matches the net's parameters.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from diner_tpu_torch.data.contract import collate
from diner_tpu_torch.mvs.losses import mvs_loss, mvs_loss_focal
from diner_tpu_torch.train import ckpt_io


def warmup_multistep(lr: float, warmup_iters: int = 500,
                     milestones: Sequence[int] = (),
                     gamma: float = 0.5) -> Callable[[int], float]:
    """lr * min(step / warmup_iters, 1) * gamma ** (milestones passed), as
    a function of the count of applied updates (WarmupMultiStepLR)."""
    def schedule(step: int) -> float:
        warm = min(step / max(warmup_iters, 1), 1.0)
        decay = 1.0
        for m in milestones:
            if step >= m:
                decay *= gamma
        return lr * warm * decay
    return schedule


def batch_indices(step: int, batch_size: int, n: int, seed: int):
    """The dataset indices of a step's batch: the epoch's permutation from
    RandomState(seed + epoch), wrapping around within the epoch."""
    epoch, start = divmod(step * batch_size, n)
    order = np.random.RandomState(seed + epoch).permutation(n)
    return np.take(order, np.arange(start, start + batch_size), mode="wrap")


def _t(x, device):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def to_tensors(batch: Dict, device):
    """A collated batch -> the cascade's inputs (imgs (B, V, 3, H, W),
    proj_matrices, depth_values (B, D)) on `device`."""
    imgs = _t(batch["imgs"], device).permute(0, 1, 4, 2, 3).contiguous()
    projs = {k: _t(v, device) for k, v in batch["proj_matrices"].items()}
    return imgs, projs, _t(batch["depth_values"], device)


def gt_tensors(batch: Dict, device):
    """A collated training batch -> its depth and mask pyramids on
    `device`."""
    return ({k: _t(v, device) for k, v in batch["depth"].items()},
            {k: _t(v, device) for k, v in batch["mask"].items()})


def cascade_loss(net, batch: Dict, device, dlossw: Sequence[float],
                 focal: bool = False):
    """(total, aux) of the net on a collated batch. The focal loss takes
    the batch's depth_interval, or the hypotheses' spacing without one."""
    imgs, projs, dvals = to_tensors(batch, device)
    depth, mask = gt_tensors(batch, device)
    out = net(imgs, projs, dvals)
    if not focal:
        return mvs_loss(out, depth, mask, dlossw=dlossw)
    if "depth_interval" in batch:
        dint = _t(batch["depth_interval"], device)
    else:
        dint = dvals[:, 1] - dvals[:, 0]
    return mvs_loss_focal(out, depth, mask, dint[:, None, None],
                          dlossw=dlossw)


def adam_count(optimizer) -> int:
    """The count of updates in Adam's state (0 before the first)."""
    for st in optimizer.state.values():
        return int(st["step"])
    return 0


def make_optimizer(net, lr: float):
    """Adam with optax's defaults over the net's parameters."""
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def save_checkpoint(ckpt_dir, net, optimizer, step: int):
    return ckpt_io.save(ckpt_dir, step, {
        "model": net.state_dict(), "optimizer": optimizer.state_dict(),
        "step": step})


def _profile_start():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _profile_stop(prof, trace_dir: Path, n_steps: int):
    from diner_tpu_torch.utils.profiling import device_tables, print_tables

    prof.stop()
    trace_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_dir / "trace.json"))
    operators, kernels, busy_us = device_tables(prof)
    if busy_us > 0:
        print_tables(operators, kernels, busy_us, n_steps, "step", 20)
    print(f"trace written to {trace_dir}", flush=True)


def train(net, dataset, logdir, device, lr: float = 1e-3,
          milestones: Sequence[int] = (), gamma: float = 0.5,
          dlossw: Sequence[float] = (0.5, 1.0, 2.0), batch_size: int = 1,
          max_steps: int = 1000, log_every: int = 20, save_every: int = 0,
          resume: bool = False, profile: bool = False, seed: int = 0,
          focal: bool = False) -> List[Dict]:
    """Train `net` (on `device`) from `dataset` for steps [start,
    max_steps), start being 0 or, with resume, the latest checkpoint's
    step. Returns one record per step run: {"step", "loss", the aux
    losses, "seconds" (the step's wall time, synchronized)}."""
    logdir = Path(logdir)
    ckpt_dir = logdir / "ckpts"
    logdir.mkdir(parents=True, exist_ok=True)
    net.to(device).train()
    optimizer = make_optimizer(net, lr)
    schedule = warmup_multistep(lr, milestones=milestones, gamma=gamma)
    start = 0
    if resume:
        restored, start = ckpt_io.restore_latest(ckpt_dir)
        if restored is not None:
            net.load_state_dict(restored["model"])
            ckpt_io.adopt_opt_state(restored, optimizer)
            print(f"resumed from step {start}", flush=True)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    records, prof = [], None
    for it in range(start, max_steps):
        if profile and it == 5:
            prof = _profile_start()
        elif prof is not None and it == 10:
            _profile_stop(prof, logdir / "trace", 5)
            prof = None
        t = time.perf_counter()
        batch = collate([dataset[int(i)] for i in
                         batch_indices(it, batch_size, len(dataset), seed)])
        optimizer.zero_grad(set_to_none=True)
        total, aux = cascade_loss(net, batch, device, dlossw, focal)
        total.backward()
        for group in optimizer.param_groups:
            group["lr"] = schedule(adam_count(optimizer))
        optimizer.step()
        rec = {"step": it, "loss": total.item()}
        rec.update({k: float(v.detach()) for k, v in aux.items()})
        sync()
        rec["seconds"] = time.perf_counter() - t
        records.append(rec)
        if it % log_every == 0:
            print(f"step {it}: loss {rec['loss']:.4f}", flush=True)
        if save_every and (it + 1) % save_every == 0:
            save_checkpoint(ckpt_dir, net, optimizer, it + 1)
    if prof is not None:
        _profile_stop(prof, logdir / "trace", max_steps - 5)
    save_checkpoint(ckpt_dir, net, optimizer, max_steps)
    print("done ->", logdir, flush=True)
    return records
