"""Process-group initialization (port of diner_tpu.parallel.multihost).

The JAX package calls `jax.distributed.initialize()` once per process,
reading JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID.
Here `init_multihost` calls `torch.distributed.init_process_group` with a
tcp:// coordinator, reading what torchrun (`python -m torch.distributed.run`)
sets: MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK. A rank
on CUDA drives the card of its LOCAL_RANK over NCCL; on the CPU the ranks
talk over gloo. Nothing falls back: a missing NCCL, an unreachable
coordinator or a missing rank raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from diner_tpu_torch.core.device import resolve_device

# Ranks other than 0 wait in their next collective while rank 0 renders and
# scores its validation (minutes at full width, with cam sweeps): torch's
# default timeout (10 minutes for NCCL) would end such a run.
TIMEOUT = datetime.timedelta(hours=2)


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device="cuda",
                   backend: Optional[str] = None,
                   timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join the process group and return the device this rank trains on.

    coordinator ("host:port", rank 0's address), num_processes and
    process_id default to MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK.
    Without a coordinator and with at most one process this is a
    single-process run: nothing is initialized and `device` is returned as
    resolve_device gives it. An initialized group is kept (idempotent).
    On CUDA the rank takes cuda:LOCAL_RANK (LOCAL_RANK defaults to 0) and
    the backend is NCCL; on the CPU gloo. `backend` overrides that choice
    (gloo over CUDA tensors: several ranks sharing one card).
    """
    dev = resolve_device(device)
    env = os.environ
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        return _bind(dev)
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if not coordinator and num_processes in (None, 1):
        return resolve_device(device)
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError(
            f"a process group needs a coordinator, the number of processes "
            f"and this process's rank: got coordinator={coordinator!r}, "
            f"num_processes={num_processes}, process_id={process_id} (pass "
            f"them, or set MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available in this torch build")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return _bind(dev)


def _bind(dev: torch.device) -> torch.device:
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev
