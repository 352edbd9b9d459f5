"""Training loop: steps, JSONL metrics, checkpoints, validation in the loop
(port of diner_tpu.train.loop).

Behavioral reference: python_scripts/train.py and the Lightning wiring of
src/models/diner.py:292-330 in malteprinzler/diner: per-step loss logging,
periodic checkpoints, periodic validation.

One process drives one device. Across processes (a torch.distributed group,
`parallel.init_multihost`) each rank trains on its own slice of the data
with replicated parameters: the model is broadcast from rank 0 once it is
built (and restored), and each step averages the gradients (train/step.py).
Rank 0 alone logs, saves checkpoints and validates, as the reference's
rank-zero side effects; every rank waits at a checkpoint until it is
written, so that a resume never reads half a file. The other ranks wait in
their next collective while rank 0 validates.

Randomness: the draws of step s (pixel patches, sampler noise) come from a
generator seeded with (seed, s) and, across ranks, the rank, so a resumed
run draws what the straight run drew at the same step.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import torch

from diner_tpu_torch.core.device import resolve_device
from diner_tpu_torch.models.diner import to_tensors
from diner_tpu_torch.parallel import mesh
from diner_tpu_torch.train import ckpt_io
from diner_tpu_torch.train.state import TrainState, create_train_state
from diner_tpu_torch.train.step import train_step


class MetricLogger:
    """Appends {"step": s, name: value, ...} lines to <logdir>/metrics.jsonl,
    and writes the same scalars as TensorBoard events into <logdir>/tb when
    `torch.utils.tensorboard` imports (it needs the tensorboard package);
    without it, the JSONL lines alone. The reference logs through
    Lightning's TensorBoardLogger (SURVEY.md section 5.5). One process
    writes: rank 0's."""

    def __init__(self, logdir):
        self.path = Path(logdir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(str(Path(logdir) / "tb"))

    def log(self, step: int, scalars: dict):
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, int(step))
            self._tb.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def save_checkpoint(ckpt_dir, state: TrainState, step: int):
    return ckpt_io.save(ckpt_dir, step, {
        "nerf": state.model.nerf.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": step})


def restore_checkpoint(ckpt_dir, state: TrainState,
                       step: Optional[int] = None) -> int:
    """Load the latest checkpoint (or `step`) into `state`: the NeRF's
    parameters and running statistics, and the optimizer state with its
    schedule when the layout still matches (else both start afresh, as
    optax's count does). Returns the steps completed (0 when there is no
    checkpoint)."""
    restored, step = ckpt_io.restore_latest(ckpt_dir, step)
    if restored is None:
        return 0
    state.model.nerf.load_state_dict(restored["nerf"])
    if ckpt_io.adopt_opt_state(restored, state.optimizer):
        state.scheduler.load_state_dict(restored["scheduler"])
    state.step = step
    return step


def step_generator(device, seed: int, step: int, rank: int = 0,
                   world: int = 1) -> torch.Generator:
    """The generator of step `step`'s draws on rank `rank` of `world`: one
    stream a (step, rank), and at world 1 the single process's stream."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) * world + rank)


def train(model, train_batches: Iterable, logdir, *, lr: float = 1e-4,
          opt_kwargs=None, max_steps: int = 100, log_every: int = 50,
          ckpt_every: int = 10_000, val_every: Optional[int] = None,
          val_fn: Optional[Callable] = None, resume: bool = False,
          seed: int = 0, device="cuda") -> TrainState:
    """Train `model` (a DINER) on `device` (CUDA unless the caller asks for
    "cpu"; a rank's own card in a process group) for steps [start,
    max_steps), start being 0 or, with `resume`, the steps completed in
    <logdir>/ckpts. train_batches yields collated numpy batches (a rank's
    own rows) and is iterated anew when it runs out; its first batch is
    dropped, as the JAX loop spends it on initialization. val_fn(state,
    step) runs validation side effects on rank 0 every val_every steps and
    once at the end, after the final checkpoint."""
    dev = resolve_device(device)
    logdir = Path(logdir)
    main = mesh.is_main()
    logger = None
    if main:
        logdir.mkdir(parents=True, exist_ok=True)
        logger = MetricLogger(logdir)
    model.to(dev)
    state = create_train_state(model, lr, **(opt_kwargs or {}))
    start_step = 0
    if resume:
        start_step = restore_checkpoint(logdir / "ckpts", state)
    mesh.broadcast_module_(model)
    rank, world = mesh.rank(), mesh.world_size()

    def save(step):
        if main:
            save_checkpoint(logdir / "ckpts", state, step)
        mesh.barrier(dev)

    try:
        it = iter(train_batches)
        # the JAX loop draws the first batch for create_train_state's init
        # and trains from the second, on fresh runs and resumes alike; this
        # one drops it, so that its step s trains on JAX's step s batch
        next(it)
        t0 = time.perf_counter()
        last_logged = start_step - 1
        for step in range(start_step, max_steps):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(train_batches)
                batch = next(it)
            losses = train_step(state, to_tensors(batch, dev),
                                generator=step_generator(dev, seed, step,
                                                         rank, world))
            if main and (step % log_every == 0 or step == max_steps - 1):
                losses["steps_per_sec"] = (step - last_logged) / max(
                    time.perf_counter() - t0, 1e-9)
                last_logged = step
                t0 = time.perf_counter()
                logger.log(step, losses)
            # labels are STEPS COMPLETED (step + 1), as the final save's
            if ckpt_every and (step + 1) % ckpt_every == 0 \
                    and step + 1 < max_steps:
                save(step + 1)
            if main and val_every and val_fn and step > 0 \
                    and step % val_every == 0:
                val_fn(state, step)

        if max_steps > start_step:
            # only if steps ran (a no-op resume must not relabel), and before
            # the final validation, whose full renders must not lose the run
            save(max_steps)
        if main and val_every and val_fn and 0 < max_steps \
                and max_steps >= start_step:
            val_fn(state, max_steps)
        # every rank returns once rank 0's validation is done
        mesh.barrier(dev)
    finally:
        if logger is not None:
            logger.close()
    return state
