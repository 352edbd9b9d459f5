"""Faults planted in the program's timed path, to show that the check
catches them: each takes the generator's program object (a RenderServer, or a
TrainState) and breaks it in place."""

from __future__ import annotations


def frame_altered(server):
    """Every frame's rgb comes back with its top twentieth (one 4096-ray
    chunk of a 256x320 frame) set to 0."""
    render = server.render

    def wrapped(*args, **kw):
        rgb, depth = render(*args, **kw)
        rgb = rgb.clone()
        rgb[:, :max(1, rgb.shape[1] // 20)] = 0.0
        return rgb, depth

    server.render = wrapped


def state_unchanged(state):
    """The optimizer step does nothing: the parameters never move."""
    state.optimizer.step = lambda *a, **k: None


def half_batch(state):
    """The losses are the mean over the first half of the batch alone."""
    losses = state.model.losses

    def wrapped(batch, *args, **kw):
        half = batch["target_rgb"].shape[0] // 2
        gen = kw.get("generator")
        return losses({k: v[:half] for k, v in batch.items()}, *args,
                      **{**kw, "generator": gen})

    state.model.losses = wrapped


FAULTS = {"frame_altered": frame_altered, "state_unchanged": state_unchanged,
          "half_batch": half_batch}
