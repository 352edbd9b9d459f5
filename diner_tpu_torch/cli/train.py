"""Train entry point (port of diner_tpu.cli.train):

    python -m diner_tpu_torch.cli.train CONFIG.yaml [--run-dir DIR |
        --logdir DIR] [--max-steps N] [--seed S] [--resume]
        [--log-every N] [--device cuda|cpu]
        [--multihost [--coordinator HOST:PORT] [--num-processes N]
         [--process-id I]]

Builds the datasets, the loader and DINER from the config, snapshots the
config and the git revision into the run directory, and trains (see
train/loop.py): metrics.jsonl (and TensorBoard events under <run>/tb when
the tensorboard package is installed), checkpoints under <run>/ckpts (which
`cli.render_eval --ckpt` renders and scores), and validation renders scored
into <run>/eval_<step>/, with cam-sweep videos in <run>/eval_<step>/
cam_sweeps/ when the optimizer section has cam_sweep_settings. Runs on the
CUDA device unless --device cpu. --seed seeds the model and the draws; the
loader shuffles with its own seed, 0, as the JAX package's does.

--multihost trains data-parallel over torch.distributed, one process a
card (NCCL; gloo with --device cpu). On one machine with N cards:

    python -m torch.distributed.run --nproc-per-node N \\
        -m diner_tpu_torch.cli.train CONFIG.yaml --multihost

torchrun sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK;
--coordinator, --num-processes and --process-id stand for the first four;
--multihost without any of them raises rather than train as one process.
The config's batch_size is per process, as in the reference's DDP. Every
rank writes into one run directory: under --logdir, the one rank 0 stamps.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import time
from pathlib import Path


def _resolve_val_every(val_check_interval, loader):
    """Lightning's val_check_interval: an int is a step count, a float in
    (0, 1] a fraction of an epoch."""
    if not val_check_interval:
        return None
    if isinstance(val_check_interval, float) and 0 < val_check_interval <= 1:
        return max(1, int(round(val_check_interval * max(len(loader), 1))))
    return int(val_check_interval)


def _git_revision() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=30,
                             cwd=Path(__file__).parent)
    except OSError:
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--logdir", default=None,
                    help="parent dir; a timestamped run dir is created inside")
    ap.add_argument("--run-dir", default=None,
                    help="exact run dir (no timestamp); with --resume it "
                         "continues a previous invocation")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="model init and draws (not the loader's shuffle)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=50,
                    help="steps between metrics.jsonl lines")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--multihost", action="store_true",
                    help="join a torch.distributed process group before "
                         "training (reads MASTER_ADDR, MASTER_PORT, "
                         "WORLD_SIZE, RANK and LOCAL_RANK, or the flags "
                         "below)")
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's HOST:PORT")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from diner_tpu_torch.core.device import resolve_device
    from diner_tpu_torch.parallel import (init_multihost, rank,
                                          world_size)

    dev = resolve_device(args.device)
    own_group = args.multihost and not dist.is_initialized()
    if args.multihost:
        dev = init_multihost(args.coordinator, args.num_processes,
                             args.process_id, device=dev)
        if not dist.is_initialized():
            raise ValueError(
                "--multihost found no process group to join: pass "
                "--coordinator, --num-processes and --process-id, or launch "
                "under torchrun (python -m torch.distributed.run), which "
                "sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK")
        print(f"multihost: rank {rank()} of {world_size()} on {dev}")
    try:
        return _train(args, dev)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _time_stamp(dev) -> str:
    """Rank 0's local time as YYYYmmdd_HHMMSS, on every rank (each rank's
    own clock could name two run directories)."""
    import torch

    from diner_tpu_torch.parallel import world_size

    stamp = torch.tensor([int(time.strftime("%Y%m%d%H%M%S"))],
                         dtype=torch.int64, device=dev)
    if world_size() > 1:
        torch.distributed.broadcast(stamp, 0)
    v = int(stamp.item())
    return f"{v // 1_000_000:08d}_{v % 1_000_000:06d}"


def _train(args, dev):
    import torch

    from diner_tpu_torch.cli.build import (build_dataset, build_diner,
                                           build_loader, optimizer_kwargs)
    from diner_tpu_torch.core.config import load_config
    from diner_tpu_torch.eval.predict import create_prediction_folder
    from diner_tpu_torch.eval.suite import evaluate_folder
    from diner_tpu_torch.eval.sweep import create_cam_sweep
    from diner_tpu_torch.parallel import is_main
    from diner_tpu_torch.train.loop import MetricLogger, train

    conf = load_config(args.config)
    if args.run_dir:
        logdir = Path(args.run_dir)
    else:
        logdir = Path(args.logdir or conf.get("logger", {}).get(
            "kwargs", {}).get("save_dir", "outputs/run")) / _time_stamp(dev)
    main_rank = is_main()
    if main_rank:
        logdir.mkdir(parents=True, exist_ok=True)
        snap = logdir / "config.yaml"
        if Path(args.config).resolve() != snap.resolve():
            shutil.copy(args.config, snap)
        (logdir / "GIT_REVISION").write_text(_git_revision() + "\n")

    torch.manual_seed(args.seed)
    train_set = build_dataset(conf["data"]["train"], stage="train")
    val_set = build_dataset(conf["data"]["val"], stage="val")
    train_loader = build_loader(conf["data"]["train"], train_set, True)
    model = build_diner(conf, znear=train_set.znear, zfar=train_set.zfar)

    trainer_kw = conf.get("trainer", {}).get("kwargs", {})
    max_steps = args.max_steps or int(trainer_kw.get("max_steps", 100_000))
    opt_conf = conf.get("optimizer", {}).get("kwargs", {})
    n_score = int(opt_conf.get("n_samples_score_eval", 16))
    sweep_kw = dict(opt_conf.get("cam_sweep_settings") or {})
    # validation runs on rank 0 alone, which alone logs
    val_logger = MetricLogger(logdir) if main_rank else None

    def val_fn(state, step):
        eval_dir = logdir / f"eval_{step:06d}"

        def render_fn(batch, seed):
            rgb, depth = state.model.render_batch(batch, seed=seed,
                                                  device=dev)
            return rgb.cpu().numpy(), depth.cpu().numpy()

        visdir = create_prediction_folder(render_fn, val_set,
                                          eval_dir / "visualizations",
                                          n_samples=n_score)
        scores = evaluate_folder(visdir, eval_dir)
        val_logger.log(step, {f"valscores_{k}": v for k, v in scores.items()})

        if sweep_kw and hasattr(val_set, "get_cam_sweep_extrinsics"):
            def sweep_render(batch, target_ext, seed):
                rgb, depth = state.model.render_batch(
                    batch, target_extrinsics=target_ext, seed=seed,
                    device=dev)
                return rgb.cpu().numpy(), depth.cpu().numpy()

            create_cam_sweep(sweep_render, val_set, eval_dir / "cam_sweeps",
                             **sweep_kw)

    opt_kw = optimizer_kwargs(conf)
    try:
        state = train(
            model, train_loader, logdir, lr=opt_kw.pop("lr"),
            opt_kwargs=opt_kw, max_steps=max_steps,
            log_every=args.log_every,
            ckpt_every=int(conf.get("checkpointing", {}).get("kwargs", {})
                           .get("every_n_train_steps", 10_000)),
            val_every=_resolve_val_every(
                trainer_kw.get("val_check_interval"), train_loader),
            val_fn=val_fn, resume=args.resume, seed=args.seed, device=dev)
    finally:
        if val_logger is not None:
            val_logger.close()
    print(f"training done -> {logdir}")
    return state


if __name__ == "__main__":
    main()
