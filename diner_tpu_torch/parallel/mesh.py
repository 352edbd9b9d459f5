"""Data parallelism over torch.distributed (port of diner_tpu.parallel.mesh).

The JAX package builds a device mesh with a `data` axis, shards each batch
over it and replicates the parameters; XLA then inserts the gradient
all-reduce. Under torch, one process drives one device (a rank), so the
mesh is the process group itself:
- `make_mesh` and `make_data_mesh_for_batch` have no counterpart: the world
  size is the mesh's size, fixed when the group is initialized
  (`parallel.multihost.init_multihost`);
- `shard_batch` and `global_batch` have none either: each rank loads the
  rows of its own `process_local_slice` and keeps them, and the global
  batch is the rank-ordered concatenation of those rows;
- `replicate` becomes `broadcast_module_` (rank 0's parameters and buffers
  to every rank), and XLA's gradient all-reduce `all_reduce_grads_` (the
  mean over ranks, a few flat buckets).
Without an initialized group every function here is the one-process case:
rank 0 of 1, and the collectives do nothing; in a group of one they run
(NCCL on one card) and change nothing. The training path uses only
`all_reduce` and `broadcast`, which gloo also runs on CUDA tensors; its
waits (`barrier`) are an all-reduce read back on the host.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2 ** 20   # a flat bucket's size, as DDP's default


def _group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if _group_active() else 0


def world_size() -> int:
    """The number of ranks, 1 without a process group."""
    return dist.get_world_size() if _group_active() else 1


def is_main() -> bool:
    """Whether this process is rank 0, which alone logs, saves and
    validates."""
    return rank() == 0


def process_local_slice(n: int, process_index: Optional[int] = None,
                        process_count: Optional[int] = None,
                        pad_to_equal: bool = False) -> List[int]:
    """The indices of range(n) this process loads (DistributedSampler's
    role): every process_count-th from process_index, which default to the
    rank and world size. pad_to_equal wraps indices so that every process
    gets ceil(n / process_count) of them, as training needs (a short
    process would run out of batches and leave the others waiting in a
    collective)."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    idx = list(range(pi, n, pc))
    if pad_to_equal and n > 0:
        target = -(-n // pc)
        pos = pi + pc * len(idx)
        while len(idx) < target:  # wrap like padded[pos] = indices[pos - n]
            idx.append(pos - n)
            pos += pc
    return idx


def _buckets(tensors: List[torch.Tensor]):
    """Consecutive runs of tensors of one dtype and device, at most
    BUCKET_BYTES each (a larger tensor is a bucket of its own)."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device
                       or size + nbytes > BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def _flat(bucket: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in bucket])


def _unflat(flat: torch.Tensor, bucket: List[torch.Tensor]) -> None:
    offset = 0
    for t in bucket:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Give every rank rank `src`'s parameters and buffers, in place."""
    if not _group_active():
        return
    tensors = [t.data for t in (*module.parameters(), *module.buffers())]
    for bucket in _buckets(tensors):
        flat = _flat(bucket)
        dist.broadcast(flat, src)
        _unflat(flat, bucket)


@torch.no_grad()
def all_reduce_grads_(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each parameter's gradient by its mean over the ranks, in
    place. Every rank must hold gradients for the same parameters (the
    same graph on rows of equal count), as the training step does."""
    if not _group_active():
        return
    world = world_size()
    grads = [p.grad for p in params if p.grad is not None]
    for bucket in _buckets(grads):
        flat = _flat(bucket)
        dist.all_reduce(flat)
        flat.div_(world)
        _unflat(flat, bucket)


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks in place (no gradient); returns it."""
    if _group_active():
        dist.all_reduce(t)
    return t


def barrier(device) -> None:
    """Block this process until every rank has reached the barrier: an
    all-reduce of one element on `device` (NCCL needs a tensor on the
    rank's card; gloo takes it on either), read back on the host. Under
    NCCL the all-reduce alone returns once it is queued on the stream;
    reading its result waits for it, so no rank runs ahead (into
    destroying the group, or reading a checkpoint) before the others
    arrive."""
    if _group_active():
        t = torch.zeros(1, device=device)
        dist.all_reduce(t)
        t.item()
