"""Train state: the model, Adam over the NeRF's parameters only, and the
learning-rate schedule (port of diner_tpu.train.state).

As in the reference (src/models/diner.py:332-334 in malteprinzler/diner),
the optimizer covers `model.nerf` alone; the VGG tower of the loss is
frozen. Adam takes optax's defaults (betas 0.9 and 0.999, eps 1e-8, no
weight decay). Schedules: "constant", or "cosine" to lr / 100 over
lr_decay_steps after an optional linear warmup from 0 (optax's
cosine_decay_schedule and warmup_cosine_decay_schedule), as a LambdaLR that
steps once per applied update, as optax's count does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

COSINE_ALPHA = 0.01   # the cosine schedule ends at lr * COSINE_ALPHA


def lr_factor(lr_schedule: str = "constant", lr_decay_steps: int = 0,
              lr_warmup_steps: int = 0):
    """The schedule as a function of the count of applied updates, relative
    to the peak lr. Raises for "cosine" without decay steps (it would train
    at a constant lr) and for an unknown schedule."""
    if lr_schedule == "constant":
        return lambda step: 1.0
    if lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
    if lr_decay_steps <= 0:
        raise ValueError("lr_schedule='cosine' requires lr_decay_steps > 0 "
                         "(omitting it would silently train at constant lr)")
    decay = lr_decay_steps - max(lr_warmup_steps, 0)
    if decay <= 0:
        raise ValueError(f"lr_decay_steps={lr_decay_steps} must exceed "
                         f"lr_warmup_steps={lr_warmup_steps}")

    def cosine(count):
        c = min(count, decay) / decay
        return ((1.0 - COSINE_ALPHA) * 0.5 * (1.0 + math.cos(math.pi * c))
                + COSINE_ALPHA)

    if lr_warmup_steps <= 0:
        return cosine
    return lambda step: (step / lr_warmup_steps if step < lr_warmup_steps
                         else cosine(step - lr_warmup_steps))


@dataclasses.dataclass
class TrainState:
    """`step` counts the updates applied (a skipped batch does not)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def create_train_state(model, lr: float = 1e-4, lr_schedule: str = "constant",
                       lr_decay_steps: int = 0,
                       lr_warmup_steps: int = 0) -> TrainState:
    """Adam (optax defaults) over model.nerf's parameters at `lr`, with the
    schedule of `lr_factor`."""
    factor = lr_factor(lr_schedule, lr_decay_steps, lr_warmup_steps)
    optimizer = torch.optim.Adam(model.nerf.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)
