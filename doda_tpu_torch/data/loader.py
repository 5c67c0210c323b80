"""Host input pipeline: epoch sampling + threaded prefetch.

A copy of ``doda_tpu/data/loader.py``.

Replaces torch DataLoader workers + DistributedSampler + SharedArray shm
(ref: dataset/__init__.py:21-76, util/common_utils.py:20-38,285-301) with
a simple deterministic design:

* ``ShardedSampler`` — seeded per-epoch permutation, padded to a multiple
  of (world_size x batch) and strided across ranks, mirroring the
  reference's pad+shard override (dataset/__init__.py:21-41),
* ``DataLoader`` — a thread pool maps ``dataset[idx]`` ahead of the
  consumer and collates on the producer side; NumPy releases the GIL in
  the hot augmentation loops,
* ``DataReader`` — infinite iterator over a loader for the self-training
  source stream (ref: util/common_utils.py:20-38).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue


class ShardedSampler:

    def __init__(self, n_items, batch_size, shuffle=True, world_size=1,
                 rank=0, drop_last=False, seed=0):
        self.n_items = n_items
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.world_size = world_size
        self.rank = rank
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def indices(self):
        import numpy as np
        rng = np.random.default_rng(self.seed + self.epoch)
        idx = rng.permutation(self.n_items) if self.shuffle \
            else np.arange(self.n_items)
        step = self.world_size
        if self.drop_last:
            per_rank = (self.n_items // (step * self.batch_size)) \
                * self.batch_size
            total = per_rank * step
            idx = idx[:total]
        else:
            per_rank = -(-self.n_items // step)
            per_rank = -(-per_rank // self.batch_size) * self.batch_size
            total = per_rank * step
            reps = -(-total // max(self.n_items, 1))
            idx = np.tile(idx, reps)[:total]
        return idx[self.rank::step]

    def __len__(self):
        return len(self.indices()) // self.batch_size


class _Failed:
    def __init__(self, error):
        self.error = error


class DataLoader:
    """Prefetching loader; yields collated batches."""

    def __init__(self, dataset, batch_size, sampler: ShardedSampler,
                 num_workers=4, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        # keep the dataset's per-item RNG streams in step with the
        # sampler's epoch (fresh augmentation draws every epoch)
        set_epoch = getattr(self.dataset, 'set_epoch', None)
        if set_epoch is not None:
            set_epoch(self.sampler.epoch)
        idx = self.sampler.indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        batches = [b for b in batches if len(b) == self.batch_size]
        q: Queue = Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            # an item or collate that raises ends the epoch with that
            # error in the consumer (the JAX package's loader leaves the
            # consumer waiting forever)
            try:
                fill()
            except BaseException as e:  # noqa: BLE001 — handed over
                q.put(_Failed(e))
            q.put(None)

        def fill():
            # item futures are submitted across batch boundaries (a
            # window of prefetch+1 batches), so workers never idle while
            # the current batch collates — batch-synchronous pool.map
            # left the pool empty during every collate.
            window = (self.prefetch + 1) * self.batch_size
            with ThreadPoolExecutor(self.num_workers) as pool:
                pending = []
                flat = [int(i) for b in batches for i in b]
                nxt = 0
                while nxt < len(flat) or pending:
                    if stop.is_set():
                        break
                    while nxt < len(flat) and len(pending) < window:
                        pending.append(pool.submit(
                            self.dataset.__getitem__, flat[nxt]))
                        nxt += 1
                    if len(pending) >= self.batch_size:
                        items = [f.result()
                                 for f in pending[:self.batch_size]]
                        del pending[:self.batch_size]
                        q.put(self.dataset.collate_batch(items))
                    else:
                        break

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                out = q.get()
                if out is None:
                    break
                if isinstance(out, _Failed):
                    raise out.error
                yield out
        finally:
            stop.set()


class DataReader:
    """Infinite iterator with epoch-aware reshuffle
    (ref: util/common_utils.py:20-38)."""

    def __init__(self, dataloader, sampler):
        self.dataloader = dataloader
        self.sampler = sampler
        self.cur_epoch = 0
        self._it = None

    def set_cur_epoch(self, epoch):
        self.cur_epoch = epoch

    def construct_iter(self):
        self._it = iter(self.dataloader)

    def read_data(self):
        if self._it is None:
            self.construct_iter()
        try:
            return next(self._it)
        except StopIteration:
            if self.sampler is not None:
                self.sampler.set_epoch(self.cur_epoch)
            self.construct_iter()
            return next(self._it)
