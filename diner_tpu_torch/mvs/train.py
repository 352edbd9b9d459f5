"""Training of the MVS cascade (port of the train and finetune modes of
diner_tpu.cli.mvs), on one device or data-parallel across ranks.

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

Across ranks (a torch.distributed process group, `cli/mvs train
--multihost`), `batch_size` is each rank's: a step's global batch is the
batch_size * world_size indices one process would draw at that size, and
rank r trains on rows [r * batch_size, (r + 1) * batch_size) of it. The
loss is a mean over samples, so the mean of the ranks' gradients
(`parallel.all_reduce_grads_`) is the global batch's, and BatchNorm
normalizes over the global batch (`nn/resnet.py`'s synced statistics, 2D
and 3D), as the JAX package's mesh does. The logged loss and aux values
are the global batch's (`global_values`), and `cli/mvs.py` counts the
learning rate's milestones in steps of the global batch. Rank 0's weights
are broadcast at the start; rank 0 alone writes checkpoints and prints,
and every rank waits for its saves.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from diner_tpu_torch.data.contract import collate
from diner_tpu_torch.mvs.losses import (aux_mask_stage, mvs_loss,
                                        mvs_loss_focal)
from diner_tpu_torch.parallel import mesh
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


def _t(x, device, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        device, dtype)


def to_tensors(batch: Dict, device, dtype=torch.float32):
    """A collated batch -> the cascade's inputs (imgs (B, V, 3, H, W),
    proj_matrices, depth_values (B, D)) on `device`, in `dtype`."""
    imgs = _t(batch["imgs"], device, dtype).permute(0, 1, 4, 2, 3
                                                    ).contiguous()
    projs = {k: _t(v, device, dtype)
             for k, v in batch["proj_matrices"].items()}
    return imgs, projs, _t(batch["depth_values"], device, dtype)


def gt_tensors(batch: Dict, device, dtype=torch.float32):
    """A collated training batch -> its depth and mask pyramids on
    `device`, in `dtype`."""
    return ({k: _t(v, device, dtype) for k, v in batch["depth"].items()},
            {k: _t(v, device, dtype) for k, v in batch["mask"].items()})


def cascade_loss(net, batch: Dict, device, dlossw: Sequence[float],
                 focal: bool = False):
    """(total, aux) of the net on a collated batch, its inputs in the
    net's parameter dtype. The focal loss takes the batch's
    depth_interval, or the hypotheses' spacing without one."""
    dtype = next(net.parameters()).dtype
    imgs, projs, dvals = to_tensors(batch, device, dtype)
    depth, mask = gt_tensors(batch, device, dtype)
    out = net(imgs, projs, dvals)
    if not focal:
        return mvs_loss(out, depth, mask, dlossw=dlossw)
    if "depth_interval" in batch:
        dint = _t(batch["depth_interval"], device, dtype)
    else:
        dint = dvals[:, 1] - dvals[:, 0]
    return mvs_loss_focal(out, depth, mask, dint[:, None, None],
                          dlossw=dlossw)


def global_values(total, aux: Dict, mask_ms: Dict, device) -> Dict:
    """A step's loss and aux values over the global batch, as python
    floats. The loss and the entropies are means over the samples, so the
    global value is the ranks' mean; a masked mean over the batch's pixels
    (`losses.aux_mask_stage`) is rebuilt from each rank's sum and count of
    masked pixels, with the loss's + 1e-6 in its denominator. One float64
    all-reduce; without a process group the values as they are."""
    names = ["loss"] + list(aux)
    vals = torch.stack([total.detach().double()]
                       + [aux[k].detach().double() for k in aux])
    counts, eps = [], []
    for k in names:
        stage = aux_mask_stage(k, list(mask_ms)) if k != "loss" else None
        counts.append(1.0 if stage is None
                      else float((mask_ms[stage] > 0.5).sum()))
        eps.append(0.0 if stage is None else 1e-6)
    counts = torch.tensor(counts, dtype=torch.float64, device=device)
    eps = torch.tensor(eps, dtype=torch.float64, device=device)
    packed = mesh.all_reduce_sum_(torch.cat([vals * (counts + eps), counts]))
    n = len(names)
    return dict(zip(names, (packed[:n] / (packed[n:] + eps)).tolist()))


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
    step. Returns one record per step run: {"step", "lr" (the update's),
    "loss" and the aux losses (over the global batch: `global_values`),
    "seconds" (the step's wall time, synchronized)} and, in a process
    group, "allreduce_seconds" (the gradient all-reduce's,
    synchronized)."""
    logdir = Path(logdir)
    ckpt_dir = logdir / "ckpts"
    main = mesh.is_main()
    rank, world = mesh.rank(), mesh.world_size()
    if main:
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
            if main:
                print(f"resumed from step {start}", flush=True)
    mesh.broadcast_module_(net)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def save(step):
        if main:
            save_checkpoint(ckpt_dir, net, optimizer, step)
        mesh.barrier(device)

    records, prof = [], None
    for it in range(start, max_steps):
        if profile and main and it == 5:
            prof = _profile_start()
        elif prof is not None and it == 10:
            _profile_stop(prof, logdir / "trace", 5)
            prof = None
        t = time.perf_counter()
        rows = batch_indices(it, batch_size * world, len(dataset), seed)
        batch = collate([dataset[int(i)] for i in
                         rows[rank * batch_size:(rank + 1) * batch_size]])
        optimizer.zero_grad(set_to_none=True)
        total, aux = cascade_loss(net, batch, device, dlossw, focal)
        total.backward()
        rec = {"step": it}
        if torch.distributed.is_initialized():
            sync()
            t_ar = time.perf_counter()
            mesh.all_reduce_grads_(net.parameters())
            sync()
            rec["allreduce_seconds"] = time.perf_counter() - t_ar
        rec["lr"] = schedule(adam_count(optimizer))
        for group in optimizer.param_groups:
            group["lr"] = rec["lr"]
        optimizer.step()
        rec.update(global_values(total, aux, batch["mask"], device))
        sync()
        rec["seconds"] = time.perf_counter() - t
        records.append(rec)
        if main and it % log_every == 0:
            print(f"step {it}: loss {rec['loss']:.4f}", flush=True)
        if save_every and (it + 1) % save_every == 0:
            save(it + 1)
    if prof is not None:
        _profile_stop(prof, logdir / "trace", max_steps - 5)
    save(max_steps)
    if main:
        print("done ->", logdir, flush=True)
    return records
