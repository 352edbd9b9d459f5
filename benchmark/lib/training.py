"""Training steps: the generator and the check of traffic whose `kind` is
"train".

Batches come from the port's BatchLoader (shuffled from the seed, its
reader threads) over DTUDataset, reading a DTU tree that lib/scenes.py
writes once into the checkout's build/benchmark/. Set-up builds one train
state (create_train_state over DINER with weights from the seed) and
drives it through `warmup_steps` steps of the window's own loop (the
loader, to_tensors, train_step with step_generator), which warm up every
shape; the window then goes on with that same state.

The check compares both stages with the plain reference: each step's
loss, the first gradient of every leaf (worked out from Adam's first
moment after the stage's first step) and every leaf's change over the
stage.
- set-up: the reference replays the warm-up steps from the seed's
  weights, from its own reading of the tree;
- window: the first `checked_steps` steps that the window ran. The
  reference follows them from the program's parameters and Adam state at
  the window's start (copied to the host at the end of set-up), which the
  set-up check holds to the reference's own steps up to there.
"""

from __future__ import annotations

import statistics
import time

import torch

from lib import common, scenes, weights

BETA1 = 0.9
STAGES = ("setup", "window")


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The draws of one step (train/loop.py's step_generator at one rank)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def leaf_norms(tensors: dict) -> dict:
    return {k: v.detach().double().norm().item() for k, v in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """{leaf: |prog - ref| / max(ref, the median leaf's ref)} of per-leaf
    norms, over the kept leaves."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def first_grad(m1, m0):
    """The gradient of the Adam step that took the first moment from m0
    (None: the first step) to m1 (None: no step was taken, 0)."""
    if m1 is None:
        return torch.zeros(())
    m1 = m1.double()
    return (m1 if m0 is None else m1 - BETA1 * m0.double()) / (1 - BETA1)


class Training:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fault=None):
        self.phases = common.Phases()
        from diner_tpu_torch.cli.build import build_diner, optimizer_kwargs
        from diner_tpu_torch.data.dtu import DTUDataset
        from diner_tpu_torch.data.loader import BatchLoader
        from diner_tpu_torch.models.diner import to_tensors
        from diner_tpu_torch.train import create_train_state, train_step

        self.phases.mark("import")
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = dev = torch.device(device)
        self._to_tensors, self._train_step = to_tensors, train_step
        train = config["train"]
        self.tree = scenes.tree_path(traffic)
        if not self.tree.exists():
            scenes.write_dtu_tree(self.tree, traffic["tree_seed"])
        self.phases.mark("tree")
        ds = DTUDataset(self.tree, stage="train",
                        split_dir=self.tree / "splits",
                        downsample=train["data"]["downsample"])
        self.conf = {k: train[k] for k in ("nerf", "renderer", "optimizer")}
        self.znear, self.zfar = ds.znear, ds.zfar
        model = common.on_device(
            lambda: build_diner(self.conf, ds.znear, ds.zfar), seed, dev)
        self.layout = weights.layout(model)
        opt = optimizer_kwargs(self.conf)
        self.state = create_train_state(model, opt.pop("lr"), **opt)
        if fault is not None:
            fault(self.state)
        self.loader_seed = weights.sub_seed(seed, "loader") % 2 ** 31
        self.loader = BatchLoader(ds, batch_size=traffic["batch_size"],
                                  shuffle=True, seed=self.loader_seed,
                                  num_threads=traffic["loader_threads"])
        self.step_seed = weights.sub_seed(seed, "steps") % 2 ** 32
        self.clock = common.Clock(dev)
        self._it = iter(self.loader)
        self.steps = 0
        self.phases.mark("model")

        self.nerf = dict(model.nerf.named_parameters())
        p0 = {k: v.detach().clone() for k, v in self.nerf.items()}
        warm = traffic["warmup_steps"]
        setup = {"losses": []}
        for s in range(warm):
            setup["losses"].append(self._step(s)["total"])
            if s == 0:
                setup["grad0"] = leaf_norms({
                    k: first_grad(m, None)
                    for k, m in self._moments().items()})
        setup["update"] = leaf_norms({k: v.detach() - p0[k]
                                      for k, v in self.nerf.items()})
        self.got = {"setup": setup}
        del p0
        # the window's start, for the reference to follow the window from
        self.start = {"params": self._host_copy(
            {k: v.detach() for k, v in self.nerf.items()}),
            "adam": self._host_copy(self._adam_state())}
        # host buffers for the moment after the window's first step and the
        # parameters after its checked steps, filled without a wait
        pinned = dev.type == "cuda"
        self._m_after = {k: torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=pinned)
                         for k, v in self.nerf.items()}
        self._p_after = {k: torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=pinned)
                         for k, v in self.nerf.items()}
        self._m_held = set()
        common.sync(dev)
        self.phases.mark("warmup_steps")
        self.first_window_step = warm
        self.window_losses: list = []

    def _next_batch(self):
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)

    def _step(self, step: int) -> dict:
        batch = (self.clock.timed("loader_next", self._next_batch,
                                  device_sync=False)
                 if self.steps else self._next_batch())
        return self._train_step(
            self.state, self._to_tensors(batch, self.device),
            generator=step_generator(self.device, self.step_seed, step))

    def _adam_state(self) -> dict:
        """{leaf: Adam's state of it}, for the leaves that have one."""
        st = self.state.optimizer.state
        return {k: st[p] for k, p in self.nerf.items() if p in st}

    def _moments(self) -> dict:
        """{leaf: Adam's first moment, or None before its first step}."""
        st = self._adam_state()
        return {k: st[k]["exp_avg"].detach() if k in st else None
                for k in self.nerf}

    @staticmethod
    def _host_copy(tree):
        if isinstance(tree, dict):
            return {k: Training._host_copy(v) for k, v in tree.items()}
        if torch.is_tensor(tree):
            return tree.detach().to("cpu", copy=True)
        return tree

    def window(self, seconds: float) -> float:
        """Train until `seconds` have passed and the checked steps are
        done. Right after the first step its first moments, and after the
        checked steps the parameters, are copied to the host without a
        wait (the stream orders them before the next step's update)."""
        t0 = time.perf_counter()
        step = self.first_window_step
        checked = self.traffic["checked_steps"]
        while True:
            self.steps += 1
            with torch.profiler.record_function("bench.train_step"):
                out = self._step(step)
            if self.steps <= checked:
                self.window_losses.append(out["total"])
            if self.steps == 1:
                for k, m in self._moments().items():
                    if m is not None:
                        self._m_after[k].copy_(m, non_blocking=True)
                        self._m_held.add(k)
            if self.steps == checked:
                for k, v in self.nerf.items():
                    self._p_after[k].copy_(v.detach(), non_blocking=True)
            step += 1
            if (self.steps >= checked
                    and time.perf_counter() - t0 >= seconds):
                common.sync(self.device)
                return time.perf_counter() - t0

    def end_to_end(self, window_s: float, peak_bytes: int) -> dict:
        return {"train_step_s": window_s / self.steps,
                "train_peak_gib": peak_bytes / 2 ** 30}

    def counts(self) -> dict:
        m = self.state.model
        sb = self.traffic["batch_size"]
        return {"steps": self.steps,
                "rays_per_step": sb * m.n_rays,
                "samples": self.steps * sb * m.n_rays
                * m.render_cfg.n_samples,
                "views": self.steps * sb * self.config["n_views"],
                "patches": self.steps * sb if m.w_vgg else 0,
                "patch": m.vgg_spatch}

    @property
    def attempted(self) -> int:
        return self.steps

    def release(self):
        """Stop the loader's threads, read the window's copies and free the
        program's state before the reference runs."""
        common.sync(self.device)
        m0 = {k: v["exp_avg"] for k, v in self.start["adam"].items()}
        self.got["window"] = {
            "losses": self.window_losses,
            "grad0": leaf_norms({
                k: first_grad(self._m_after[k] if k in self._m_held
                              else None, m0.get(k))
                for k in self.nerf}),
            "update": leaf_norms({k: self._p_after[k]
                                  - self.start["params"][k]
                                  for k in self.nerf})}
        self._it.close()
        self._it = self.state = self.loader = self.nerf = None
        self._m_after = self._p_after = None
        common.free_device(self.device)

    # -- the check ---------------------------------------------------------
    def reference_steps(self, precision: dict, stage: str) -> dict:
        """The reference's steps of `stage` in `precision` (the TF32 flags),
        from the same batches (read again from the tree) and the same
        draws: the losses, the first step's gradient by leaf norm and the
        leaves' change over the stage. "setup" starts from the seed's
        weights, "window" from the program's state at the window's start."""
        from reference import config as rconfig
        from reference import dtu
        from reference.models.diner import to_tensors

        dev = self.device
        model = common.on_device(
            lambda: rconfig.build_diner(self.conf, self.znear, self.zfar),
            self.seed, dev)
        if weights.layout(model) != self.layout:
            raise RuntimeError("the reference's parameters differ from the "
                               "program's")
        nerf = dict(model.nerf.named_parameters())
        lr = float(self.conf["optimizer"]["kwargs"]["lr"])
        opt = torch.optim.Adam(model.nerf.parameters(), lr=lr,
                               betas=(BETA1, 0.999), eps=1e-8)
        warm = self.traffic["warmup_steps"]
        steps = (range(warm) if stage == "setup"
                 else range(warm, warm + self.traffic["checked_steps"]))
        if stage == "window":
            with torch.no_grad():
                for k, p in nerf.items():
                    p.copy_(self.start["params"][k])
            for k, s in self.start["adam"].items():
                opt.state[nerf[k]] = {
                    n: v.clone() if n == "step" else v.to(dev, copy=True)
                    for n, v in s.items()}
        p0 = {k: v.detach().clone() for k, v in nerf.items()}
        samples = dtu.DTUSamples(
            self.tree, self.config["train"]["data"]["downsample"])
        order = dtu.shuffled_batches(len(samples), self.traffic["batch_size"],
                                     self.loader_seed, steps.stop)
        out = {"losses": []}
        with common.Precision(precision["matmul_tf32"],
                              precision["cudnn_tf32"]):
            for s in steps:
                batch = to_tensors(dtu.collate([samples[int(i)]
                                                for i in order[s]]), dev)
                opt.zero_grad(set_to_none=True)
                losses = model.losses(batch, train=True,
                                      generator=step_generator(
                                          dev, self.step_seed, s))
                losses["total"].backward()
                if s == steps.start:
                    out["grad0"] = leaf_norms({k: v.grad if v.grad is not None
                                               else torch.zeros(())
                                               for k, v in nerf.items()})
                opt.step()
                out["losses"].append(losses["total"].item())
        out["update"] = leaf_norms({k: nerf[k].detach() - p0[k] for k in p0})
        del model, opt, p0
        common.free_device(dev)
        return out

    @staticmethod
    def gaps(ref: dict, got: dict, prefix: str = "") -> dict:
        """The numbers compared for one stage: loss_gap, the largest |loss -
        reference loss| / |reference loss| over its steps (loss0_gap: the
        first step's); grad_gap and update_gap, the worst leaf's gap in the
        norm of the first gradient and of the change over the stage
        (leaf_gaps), grad_median_gap and update_median_gap the median
        leaf's. Leaves whose reference gradient is under a thousandth of the
        median leaf's move by round-off alone and are left out."""
        g = ref["grad0"]
        med = statistics.median(g.values())
        keep = [k for k in g if g[k] >= 1e-3 * med]
        loss = [abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(got["losses"], ref["losses"])]
        grad = leaf_gaps(got["grad0"], g, keep)
        update = leaf_gaps(got["update"], ref["update"], keep)
        out = {"loss_gap": max(loss), "loss0_gap": loss[0],
               "grad_gap": max(grad.values()),
               "grad_median_gap": statistics.median(grad.values()),
               "update_gap": max(update.values()),
               "update_median_gap": statistics.median(update.values())}
        return {prefix + k: v for k, v in out.items()}

    def _stage_gaps(self, refs: dict, got: dict) -> dict:
        return {**self.gaps(refs["setup"], got["setup"]),
                **self.gaps(refs["window"], got["window"], "window_")}

    def check(self) -> dict:
        self.refs = {st: self.reference_steps(
            self.config["train_reference"], st) for st in STAGES}
        return self._stage_gaps(self.refs, self.got)

    def control_check(self) -> dict:
        """{control: the numbers compared}, each control the reference in a
        precision of the configuration's `train_controls` put in the
        program's place (after check())."""
        return {name: self._stage_gaps(self.refs, {
            st: self.reference_steps(prec, st) for st in STAGES})
            for name, prec in self.config["train_controls"].items()}


GENERATOR = Training
