"""One training step with the NaN guard, and the eval step (port of
diner_tpu.train.step).

The guard: a non-finite total skips the whole batch. Its backward is not
run, and the parameters, Adam's moments and step count, the schedule and
the norms' running statistics stay as they were (the running statistics
are restored from a copy taken before the forward pass; the reference
raises NanError and skips the batch, deps/TransMVSNet/train.py:213-227).
The step logs `skipped_nonfinite` (1.0 for a skipped batch). Reading the
total's finiteness waits for the device once a step.

Across ranks (a process group of more than one) the step is the JAX
package's step on the global batch: each rank's losses are means over its
rows, of equal count on every rank, so their mean over the ranks is the
global batch's. One all-reduce a step, before the backward, sums the
losses and a non-finite flag: the logged losses are the global means, and
a batch that is not finite on any rank is skipped on every rank. After the
backward the gradients are averaged over the ranks
(`parallel.all_reduce_grads_`), which is the global batch's gradient.
"""

from __future__ import annotations

from typing import Dict

import torch

from diner_tpu_torch.parallel.mesh import (all_reduce_grads_,
                                           all_reduce_sum_, world_size)
from diner_tpu_torch.train.state import TrainState


def _norm_buffers(model):
    """The running statistics of the model's norms (BatchNorm buffers)."""
    return [b for m in model.modules()
            if isinstance(m, torch.nn.BatchNorm2d)
            for b in m.buffers()]


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               generator=None, pix=None, noise=None) -> Dict[str, float]:
    """One update of `state` from a batch of tensors on the model's device;
    returns the losses as floats and `skipped_nonfinite`. pix and noise
    replace the model's draws (see DINER.losses)."""
    model = state.model
    buffers = _norm_buffers(model)
    saved = [b.clone() for b in buffers]
    state.optimizer.zero_grad(set_to_none=True)
    losses = model.losses(batch, train=True, pix=pix, noise=noise,
                          generator=generator)
    world = world_size()
    names = list(losses)
    total = losses["total"].detach()
    packed = torch.stack([losses[k].detach().float() for k in names]
                         + [(~torch.isfinite(total)).float()])
    values = (all_reduce_sum_(packed) / world).tolist()
    finite = values[-1] == 0.0
    if finite:
        losses["total"].backward()
        all_reduce_grads_(p for g in state.optimizer.param_groups
                          for p in g["params"])
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
    else:
        with torch.no_grad():
            for b, s in zip(buffers, saved):
                b.copy_(s)
    out = dict(zip(names, values[:-1]))
    out["skipped_nonfinite"] = 0.0 if finite else 1.0
    return out


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor], generator=None, pix=None,
              noise=None) -> Dict[str, float]:
    """The losses of a batch with the norms in eval mode, no gradient."""
    losses = model.losses(batch, train=False, pix=pix, noise=noise,
                          generator=generator)
    return {k: float(v) for k, v in losses.items()}
