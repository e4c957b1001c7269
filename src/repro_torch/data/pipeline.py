"""Host data pipeline (port of ``repro.data.pipeline``): deterministic
shard-aware batching with a prefetch thread, and placement on one device.

``HostDataLoader`` slices the global batch by (host_id, num_hosts), as on a
multi-host pod each process feeds its own part of the batch. Placement is an
explicit ``device``, not a sharding. The prefetch thread only slices the
batch and turns it into host tensors (pinned when the device is a CUDA
device); it launches no CUDA work. The consumer copies each batch to the
card with ``non_blocking=True`` on a stream of its own, and the stream that
reads the batch waits for that copy.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


def _map(fn, batch):
    """Apply ``fn`` to every array of a batch: an array, or a tuple, list or
    dict of them."""
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


class HostDataLoader:
    """Prefetching loader. When the wrapped ``gen`` exposes a ``cursor()``
    (e.g. ``repro_torch.data.MarkovStream``), ``cursor()`` here returns that
    cursor advanced to the CONSUMER position — ``delivered`` counts batches
    handed to the trainer, not batches the prefetch thread has pulled ahead,
    so a resume from the cursor replays exactly the batches the trainer has
    not yet seen.

    ``device``: where batches are delivered (None keeps them as host
    tensors). Batches are numpy arrays (or tuples, lists or dicts of them)
    and come out as tensors of the same dtypes."""

    def __init__(self, gen: Iterator, host_id: int = 0, num_hosts: int = 1,
                 device=None, prefetch: int = 2):
        self.gen = gen
        self.host_id, self.num_hosts = host_id, num_hosts
        self.device = None if device is None else torch.device(device)
        self._pin = self.device is not None and self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._pin
                        else None)
        self.delivered = 0
        self._cursor0 = gen.cursor() if hasattr(gen, "cursor") else None
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _slice(self, batch):
        def f(x):
            per = x.shape[0] // self.num_hosts
            return x[self.host_id * per:(self.host_id + 1) * per]
        return _map(f, batch)

    def _host(self, batch):
        def f(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.pin_memory() if self._pin else t
        return _map(f, batch)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for item in self.gen:
                if self._stop.is_set() or not self._put(
                        self._host(self._slice(item))):
                    return
        except Exception as e:  # surface in consumer
            self._put(e)

    def _place(self, batch):
        if self.device is None:
            return batch
        if self._stream is None:
            return _map(lambda x: x.to(self.device), batch)
        cur = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            out = _map(lambda x: x.to(self.device, non_blocking=True), batch)
        cur.wait_stream(self._stream)
        _map(lambda x: x.record_stream(cur), out)
        return out

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        self.delivered += 1
        return self._place(item)

    def cursor(self) -> Optional[dict]:
        """Source cursor at the CONSUMER position (None when the wrapped
        generator has no ``cursor()``)."""
        if self._cursor0 is None:
            return None
        cur = dict(self._cursor0)
        cur["batches"] = cur.get("batches", 0) + self.delivered
        return cur

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)


def repeat_batches(fn: Callable[[int], np.ndarray]) -> Iterator:
    i = 0
    while True:
        yield fn(i)
        i += 1
