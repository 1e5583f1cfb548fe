"""Host-side input pipeline: a prefetch thread, and the upload of stacked
host batches to the device for the host-fed trainer.

``ThreadedPrefetcher`` keeps `depth` items queued on a daemon thread, so
host work (the native clip store's memcpy, numpy copies, both of which
release the interpreter lock) overlaps the device's work. ``HostFeed``
runs the stacking of k batches into pinned memory on that thread, so the
main thread only starts each stack's copy to the device, on a copy stream
of its own that overlaps the compute stream. Under data parallelism the
iterator yields the global batches on every rank, and the thread slices
each stack to the rank's rows before pinning it.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from mocogan_tpu_torch.parallel import mesh as pmesh


class ThreadedPrefetcher:
    """Wraps any batch iterator; prefetches `depth` batches on a daemon
    thread. Iteration order is preserved. Exceptions propagate to the
    consumer. ``wait_s`` sums the seconds the consumer waited for a
    batch."""

    _SENTINEL = object()

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, depth))
        self._err: Exception | None = None
        self._stop = threading.Event()
        self.wait_s = 0.0

        def put_or_stop(item) -> bool:
            """Bounded put that gives up once close() raised the stop flag
            (a plain blocking put would leave the worker stuck forever once
            the consumer stops draining, e.g. at depth 1)."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in it:
                    if not put_or_stop(item):
                        return
            except Exception as e:  # noqa: BLE001 — re-raised by __next__
                self._err = e
            finally:
                put_or_stop(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # drain so a worker mid-put can finish; its next put sees the stop
        # flag and gives up, so the thread (and the iterator it holds:
        # mmap'd stores, open files) always terminates
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


Stack = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def _pinned(t: torch.Tensor, pin: bool) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    buf.copy_(t)
    return buf


def _stacks(it: Iterator[Any], k: int, pin: bool,
            mesh: Optional[pmesh.Mesh] = None
            ) -> Iterator[Tuple[Stack, Optional[Stack]]]:
    """(stack, global stack) pairs. A stack is (batches (K, B, ...),
    frame_idx (K, B, T) or None, labels (K, B) or None) host tensors of k
    batches each, in pinned memory where `pin`; a fresh tensor per stack.
    Labels are stacked when every batch has them. Stops when fewer than k
    batches are left. With a mesh of several ranks the stack holds the
    rank's rows of each batch and the global stack (unpinned) all of them;
    otherwise the global stack is None."""
    split = mesh is not None and mesh.world_size > 1
    while True:
        items = list(itertools.islice(it, k))
        if len(items) < k:
            return
        if isinstance(items[0], dict):
            parts = [[b["raw"] for b in items],
                     [b["frame_idx"] for b in items]]
            labels = [b.get("labels") for b in items]
        else:
            parts = [[np.asarray(b[0], np.float32) for b in items], None]
            labels = [b[1] for b in items]
        parts.append(None if any(lab is None for lab in labels) else
                     [np.asarray(lab, np.int32) for lab in labels])
        out, whole = [], []
        for arrays in parts:
            if arrays is None:
                out.append(None)
                whole.append(None)
            elif split:
                full = torch.from_numpy(np.stack(arrays))
                whole.append(full)
                out.append(_pinned(pmesh.local_batch_slice(mesh, full,
                                                           axis=1), pin))
            else:
                buf = torch.empty((k, *arrays[0].shape), pin_memory=pin,
                                  dtype=torch.from_numpy(
                                      np.empty(0, arrays[0].dtype)).dtype)
                host = buf.numpy()
                for j, a in enumerate(arrays):
                    host[j] = a
                out.append(buf)
        yield tuple(out), (tuple(whole) if split else None)


class HostFeed:
    """Stacks of k host batches, uploaded to `device`.

    The iterator yields (videos (B, T, H, W, C) float32, labels) pairs or
    {"raw" (B, T_raw, H, W, C) uint8, "frame_idx" (B, T) int32, "labels"}
    dicts; ``next()`` returns (batches (K, B, ...), frame_idx (K, B, T) or
    None, labels (K, B) int32 or None) on the device, as
    ``step.multi_train_step`` takes them. The
    prefetch thread copies each stack once, from the host batches into
    pinned memory, and keeps `depth` stacks queued. ``next()`` starts the
    copy to the card on a side stream with ``non_blocking=True`` and makes
    the compute stream wait for it, so the copy overlaps the work already
    queued there and the host does not wait. A pinned stack is freed once
    its copy is queued; PyTorch's pinned-memory allocator recorded an event
    on that copy and does not hand the block out again before the event
    has passed, so a buffer is never rewritten while its copy is in
    flight. On the CPU the host stack is the batch itself.

    With a data-parallel `mesh` of several ranks the iterator yields the
    global batches and ``next()`` returns the rank's rows of them;
    ``last_global`` then holds the global host stack of the last ``next()``
    (None otherwise), for an eval pool that needs every rank's clips."""

    def __init__(self, data_iterator: Iterator[Any], k: int,
                 device: torch.device, depth: int,
                 mesh: Optional[pmesh.Mesh] = None):
        self.device = device
        cuda = device.type == "cuda"
        self._it = ThreadedPrefetcher(
            _stacks(iter(data_iterator), k, cuda, mesh), depth=depth)
        self._stream = torch.cuda.Stream(device) if cuda else None
        self.last_global: Optional[Stack] = None

    @property
    def wait_s(self) -> float:
        """Seconds spent waiting for the prefetch thread."""
        return self._it.wait_s

    def next(self) -> Stack:
        host, self.last_global = next(self._it)
        if self._stream is None:
            return host
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            out = tuple(None if t is None else
                        t.to(self.device, non_blocking=True) for t in host)
        compute.wait_stream(self._stream)
        for t in out:
            if t is not None:      # allocated on the copy stream, used here
                t.record_stream(compute)
        return out

    def close(self):
        self._it.close()
