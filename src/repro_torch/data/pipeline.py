"""Double-buffered host -> device input pipeline (the PR² discipline
applied to the training input feed).

A background thread produces batch i+1 (synthetic generation + simulated
flash-tier read, then a copy to the device from pinned memory) while the
training step consumes batch i — the producer/consumer overlap of CACHE
READ.  ``stall_s`` is the time the consumer waited and ``produce_s`` the
producer's busy time (overlapped).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays of ``batch`` as tensors on ``device``: pinned host
    memory and a non-blocking copy on a CUDA device."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


class PrefetchPipeline:
    """Iterate device-ready batches with a bounded lookahead.

    ``device`` None leaves the batches as the host arrays ``read_fn``
    returns.  On a CUDA device the producer copies on a stream of its
    own and the consumer's stream waits for that copy before it sees
    the batch.
    """

    def __init__(self, read_fn: Callable[[int], dict], n_batches: int,
                 depth: int = 2, device=None, start_index: int = 0):
        self.read_fn = read_fn
        self.n_batches = n_batches
        self.depth = depth
        self.device = torch.device(device) if device is not None else None
        self.start_index = start_index
        self.stall_s = 0.0                # time the consumer waited
        self.produce_s = 0.0              # producer busy time (overlapped)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread: Optional[threading.Thread] = None

    def _producer(self):
        cuda = self.device is not None and self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        for i in range(self.start_index, self.start_index + self.n_batches):
            t0 = time.perf_counter()
            batch = self.read_fn(i)
            event = None
            if cuda:
                with torch.cuda.stream(stream):
                    batch = to_device(batch, self.device)
                    event = torch.cuda.Event()
                    event.record(stream)
            elif self.device is not None:
                batch = to_device(batch, self.device)
            self.produce_s += time.perf_counter() - t0
            self._q.put((i, batch, event))
        self._q.put((None, None, None))

    def __iter__(self) -> Iterator:
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        while True:
            t0 = time.perf_counter()
            i, batch, event = self._q.get()
            self.stall_s += time.perf_counter() - t0
            if i is None:
                break
            if event is not None:
                torch.cuda.current_stream(self.device).wait_event(event)
                for t in batch.values():
                    t.record_stream(torch.cuda.current_stream(self.device))
            yield i, batch
        self._thread.join()
