"""Host-side batch loader with background prefetch (port of
diner_tpu.data.loader).

A thread pool builds the samples of the next batches while the device
steps. Each epoch reshuffles with numpy's RandomState(seed + epoch), so a
seed gives the JAX package's index order. Per-process index slices (the
DistributedSampler equivalent) come from
`parallel.mesh.process_local_slice`: each rank of a process group loads its
own slice, padded so that every rank yields the same number of batches.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from diner_tpu_torch.data.contract import collate, to_device_batch
from diner_tpu_torch.parallel.mesh import process_local_slice


class BatchLoader:
    """Iterable over collated batches; shuffle=True reshuffles per epoch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True,
                 num_threads: int = 4, prefetch: int = 2,
                 shard_across_processes: bool = True,
                 arrays_only: bool = True, io_retries: int = 3):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.arrays_only = arrays_only
        self.io_retries = io_retries
        if shard_across_processes:
            self.indices = process_local_slice(len(dataset),
                                               pad_to_equal=True)
        else:
            self.indices = list(range(len(dataset)))
        self._epoch = 0

    def __len__(self):
        n = len(self.indices)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _epoch_indices(self):
        idcs = np.array(self.indices)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idcs)
        return idcs

    def _fetch(self, i):
        # shared file systems fail transiently: bounded retries on OSError
        for attempt in range(self.io_retries):
            try:
                return self.dataset[int(i)]
            except OSError:
                if attempt == self.io_retries - 1:
                    raise
                time.sleep(0.5 * (attempt + 1))

    def __iter__(self):
        idcs = self._epoch_indices()
        self._epoch += 1
        n_batches = len(self)
        if n_batches == 0:
            raise ValueError(
                f"BatchLoader yields no batches: {len(self.indices)} local "
                f"indices < batch_size={self.batch_size} with drop_last; "
                "shrink the batch or grow the dataset")
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()  # set when the consumer leaves the epoch
        error: list = []

        def put(item) -> bool:
            # a bounded put that gives up once the consumer is gone, so an
            # abandoned iterator does not leave this thread blocked
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        chunk = idcs[b * self.batch_size:
                                     (b + 1) * self.batch_size]
                        batch = collate(list(pool.map(self._fetch, chunk)))
                        if self.arrays_only:
                            batch = to_device_batch(batch)
                        if not put(batch):
                            return
            except BaseException as e:  # raised in the consumer: an error
                error.append(e)         # must not end the epoch silently
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if error:
                        raise error[0]
                    break
                yield item
        finally:
            stop.set()
