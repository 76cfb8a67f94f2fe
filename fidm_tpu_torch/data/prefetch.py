"""Host-to-device prefetching (PyTorch port of `fidm_tpu/data/prefetch.py`).

`device_prefetch` keeps `size` batches in flight: each array goes into
pinned host memory and is copied to the card with `non_blocking=True`, so
the copy overlaps the step that runs meanwhile. `ThreadedLoader` runs a
loader's CPU work (PIL decode, mask rasterisation, stacking) on a
background thread.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

__all__ = ["device_prefetch", "ThreadedLoader"]


def _to_device(v, device: torch.device):
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.array(v, copy=True) if not v.flags.writeable
                             else np.ascontiguousarray(v))
    if not isinstance(v, torch.Tensor):
        return v
    if device.type == "cuda":
        if v.device.type == "cpu":
            v = v.pin_memory()
        return v.to(device, non_blocking=True)
    return v.to(device)


def device_prefetch(iterator: Iterable, size: int = 2, device="cuda") -> Iterator:
    """Yield batches whose array entries are tensors on `device`, `size`
    transfers ahead; other entries (paths) pass through."""
    device = torch.device(device)
    queue = collections.deque()

    def put(batch):
        return {k: _to_device(v, device) for k, v in batch.items()}

    it = iter(iterator)
    for batch in it:
        queue.append(put(batch))
        if len(queue) >= size:
            break
    while queue:
        out = queue.popleft()
        for batch in it:
            queue.append(put(batch))
            break
        yield out


class ThreadedLoader:
    """Run a (CPU-bound PIL/numpy) loader iterator in a background thread."""

    def __init__(self, make_iterator: Callable[[], Iterable], queue_size: int = 4):
        self._make = make_iterator
        self._qsize = queue_size

    def __iter__(self):
        import queue as q

        buf: "q.Queue" = q.Queue(maxsize=self._qsize)
        END = object()
        stop = threading.Event()
        err: list = []

        def _put(item) -> bool:
            # a bounded put that gives up when the consumer is gone: an
            # abandoned iteration must not pin a blocked thread
            while not stop.is_set():
                try:
                    buf.put(item, timeout=0.5)
                    return True
                except q.Full:
                    continue
            return False

        def worker():
            try:
                for item in self._make():
                    if not _put(item):
                        return
            except BaseException as e:  # re-raised in the consumer
                err.append(e)
            finally:
                _put(END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = buf.get()
                if item is END:
                    break
                yield item
        finally:
            stop.set()
        if err:
            # an error must not silently truncate the epoch
            raise err[0]
