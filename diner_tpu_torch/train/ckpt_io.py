"""Checkpoint IO of the trainer (port of diner_tpu.train.ckpt_io).

A checkpoint is one torch.save file `<dir>/step_<8 digits>.pt` holding
{"nerf": the PixelNeRF state_dict (parameters and the norms' running
statistics), "optimizer": Adam's state_dict, "scheduler": the schedule's
state_dict, "step": steps completed}. Conventions of the JAX package:
  - checkpoints are labelled by STEPS COMPLETED;
  - re-saving an existing step is a no-op (a resumed run's first periodic
    save can land on the step it restored from);
  - the optimizer state is adopted only when its layout still matches the
    optimizer's, else the optimizer starts afresh.
A save writes a temporary file in the same directory and renames it, so a
crash leaves no partial checkpoint.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

_NAME = re.compile(r"^step_(\d{8})\.pt$")


def checkpoint_path(ckpt_dir, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{step:08d}.pt"


def all_steps(ckpt_dir):
    """The steps of the checkpoints in ckpt_dir, ascending."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    return sorted(int(m.group(1)) for p in ckpt_dir.iterdir()
                  if (m := _NAME.match(p.name)))


def save(ckpt_dir, step: int, payload: dict) -> Path:
    """Write payload as the checkpoint of `step` (no-op if it exists)."""
    path = checkpoint_path(ckpt_dir, step)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_latest(ckpt_dir, step: Optional[int] = None):
    """(payload on the CPU, step) of the latest checkpoint (or of `step`),
    or (None, 0) when there is none. A file is a checkpoint path itself."""
    if Path(ckpt_dir).is_file():
        payload = torch.load(ckpt_dir, map_location="cpu", weights_only=True)
        return payload, int(payload["step"])
    steps = all_steps(ckpt_dir)
    if step is None:
        if not steps:
            return None, 0
        step = steps[-1]
    payload = torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu",
                         weights_only=True)
    return payload, int(payload["step"])


def adopt_opt_state(restored: dict, optimizer) -> bool:
    """Load the checkpoint's optimizer state into `optimizer` when its
    layout (the parameter groups' sizes, and each parameter's moment shape)
    still matches the optimizer's parameters; otherwise leave the optimizer
    fresh. Returns whether the state was adopted."""
    got = restored.get("optimizer")
    if got is None:
        print("resume: checkpoint has no optimizer state; reinitializing",
              flush=True)
        return False
    params = [p for g in optimizer.param_groups for p in g["params"]]
    groups = [len(g["params"]) for g in got["param_groups"]]
    moments = [tuple(st["exp_avg"].shape) for _, st in
               sorted(got["state"].items()) if "exp_avg" in st]
    if (groups != [len(g["params"]) for g in optimizer.param_groups]
            or (moments and moments != [tuple(p.shape) for p in params])):
        print("resume: optimizer state layout changed; reinitializing",
              flush=True)
        return False
    optimizer.load_state_dict(got)
    return True
