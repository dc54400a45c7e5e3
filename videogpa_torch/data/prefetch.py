"""Host -> device input pipeline with double-buffered prefetch
(``videogpa_tpu/data/prefetch.py``).

The counterpart of the reference's ``DataLoader(num_workers=4,
pin_memory=True)``: ``BatchLoader`` loads and collates batches on a thread
pool while the device computes, and ``prefetch_to_device`` copies each batch
from pinned host memory on a side stream, so the copy overlaps the current
step. No main path calls it yet, as in the JAX package.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from videogpa_torch.device import resolve_device


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def prefetch_to_device(iterator: Iterable[Any], buffer_size: int = 2,
                       sharding: Optional[Any] = None, device=None) -> Iterator[Any]:
    """Wrap an iterator of host batches (trees of numpy arrays or CPU
    tensors) so that up to ``buffer_size`` batches are already on ``device``
    (the card unless ``device="cpu"``) ahead of the consumer.

    ``sharding`` (a ``parallel.shard(mesh, "data")``), as in
    ``videogpa_tpu/data/prefetch.py:18-37``: each rank stages its own block
    of every array (``Sharding.local``), so a whole host batch arrives as
    this rank's ``batch_specs`` slice.

    On CUDA each array is pinned and copied with ``non_blocking=True`` on a
    side stream by a producer thread; a batch is yielded once its copy's
    event is recorded, and the consumer's stream waits on that event, so the
    first use orders after the copy. An exception in the iterator is raised
    in the consumer."""
    device = resolve_device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(x):
        if isinstance(x, (np.ndarray, np.generic)):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not isinstance(x, torch.Tensor):
            return x
        if sharding is not None:
            x = sharding.local(x).contiguous()
        if stream is None:
            return x.to(device)
        return x.pin_memory().to(device, non_blocking=True)

    def stage(batch):
        if stream is None:
            return _tree_map(put, batch), None
        with torch.cuda.stream(stream):
            out = _tree_map(put, batch)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    sentinel = object()
    err: list = []

    def producer():
        try:
            for batch in iterator:
                q.put(stage(batch))
        except BaseException as e:  # handed to the consumer below
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        batch, done = item
        if done is not None:
            torch.cuda.current_stream(device).wait_event(done)
        yield batch


class BatchLoader:
    """Threaded map-style loader: indices -> collated host batches, drop-last,
    reshuffled each epoch from ``shuffle_seed + epoch``."""

    def __init__(self, dataset, indices, batch_size: int, collate: Callable,
                 num_workers: int = 4, shuffle_seed: Optional[int] = None):
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.collate = collate
        self.num_workers = max(1, num_workers)
        self.shuffle_seed = shuffle_seed
        self._epoch = 0

    def __len__(self):
        return len(self.indices) // self.batch_size

    def __iter__(self):
        import concurrent.futures as cf

        order = list(self.indices)
        if self.shuffle_seed is not None:
            rng = np.random.default_rng(self.shuffle_seed + self._epoch)
            order = list(rng.permutation(order))
        self._epoch += 1
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order) - self.batch_size + 1, self.batch_size)]
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            def load(idxs):
                return self.collate([self.dataset[int(i)] for i in idxs])

            futures = [pool.submit(load, b) for b in batches]
            for fut in futures:
                yield fut.result()
