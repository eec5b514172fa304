"""Epoch indexing with the reference's tail padding and host-to-device
streaming for datasets larger than device memory (counterpart of
deepprior_tpu/train/prefetch.py; the reference's para_load loader,
src/trainer/nettrainer.py:630-723).

``macro_chunks`` cuts the epochs' minibatch stream into (k, B, ...) stacks
on the host (``index_chunks``: their sample indices); ``DevicePrefetcher``
stages them on the card from a worker thread: each chunk's rows are
gathered into a pinned host slot and uploaded on a copy stream of its
own, and the training stream waits on the chunk's event before it reads
it.  For data that fits on the card, ``fit``'s
device-resident ``TrainData`` does no per-step host work at all.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


def aligned_epoch_indices(rng, n: int, batch_size: int):
    """One epoch's sample indices with the reference's alignData tail
    (nettrainer.py:365-413): a fresh permutation of all n samples, the last
    incomplete minibatch padded to batch_size with seeded-random repeats
    from ``RandomState(n)``, the reference's pad_random seeding quirk (the
    same pad every epoch), so every frame trains every epoch.

    Consumes exactly one rng.permutation(n).  Returns
    (ceil(n / batch_size) * batch_size,) indices."""
    perm = rng.permutation(n)
    rem = n % batch_size
    if rem == 0:
        return perm
    pad = np.random.RandomState(n).randint(0, n, size=batch_size - rem)
    return np.concatenate([perm, pad])


def chunked_epochs(arrays: dict, batch_size: int, n_epochs: int,
                   seed: int = 23455):
    """Host-side batch generator over a dict of co-indexed numpy arrays,
    reshuffled per epoch; the tail batch is alignData-padded."""
    n = next(iter(arrays.values())).shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(n_epochs):
        idx_all = aligned_epoch_indices(rng, n, batch_size)
        for s in range(0, idx_all.shape[0], batch_size):
            idx = idx_all[s : s + batch_size]
            yield {k: v[idx] for k, v in arrays.items()}


def index_chunks(n: int, batch_size: int, n_epochs: int, chunk_steps: int,
                 seed: int = 23455, start_epoch: int = 0, segment_steps: int = 0):
    """The sample indices of ``macro_chunks``' chunks, as (k, batch_size)
    arrays."""
    steps = -(-n // batch_size)  # tail batch alignData-padded, not dropped
    rng = np.random.default_rng(seed)
    for _ in range(start_epoch):
        rng.permutation(n)
    for _ in range(start_epoch, n_epochs):
        perm = aligned_epoch_indices(rng, n, batch_size)
        s0 = 0
        while s0 < steps:
            k = min(chunk_steps, steps - s0)
            if segment_steps > 0:
                k = min(k, (s0 // segment_steps + 1) * segment_steps - s0)
            yield perm[s0 * batch_size : (s0 + k) * batch_size].reshape(k, batch_size)
            s0 += k


def macro_chunks(arrays: dict, batch_size: int, n_epochs: int, chunk_steps: int,
                 seed: int = 23455, start_epoch: int = 0, segment_steps: int = 0):
    """(k, batch, ...) stacks of up to ``chunk_steps`` minibatches: exactly
    ``chunked_epochs``' batches in the same order, stacked.  Chunks never
    straddle an epoch (a short epoch tail yields a smaller chunk), nor,
    with ``segment_steps`` > 0, a multiple of that step count inside the
    epoch (fit_streamed's sub-epoch validation boundaries).

    start_epoch > 0 (resume) burns the permutations already consumed, so
    the remaining epochs see the stream an uninterrupted run would."""
    n = next(iter(arrays.values())).shape[0]
    for idx in index_chunks(n, batch_size, n_epochs, chunk_steps, seed, start_epoch,
                            segment_steps):
        yield {key: v[idx.reshape(-1)].reshape(idx.shape + v.shape[1:])
               for key, v in arrays.items()}


class _Slot:
    """One pinned staging buffer per key, reused across chunks; ``event``
    marks the end of the last upload that read it."""

    def __init__(self):
        self.host: Dict[str, torch.Tensor] = {}
        self.event: Optional[torch.cuda.Event] = None

    def view(self, key: str, shape, dtype) -> torch.Tensor:
        """A pinned tensor of ``shape`` and ``dtype``, grown when a chunk is
        larger than any before it."""
        size = int(np.prod(shape))
        buf = self.host.get(key)
        if buf is None or buf.numel() < size or buf.dtype != dtype:
            buf = torch.empty(size, dtype=dtype, pin_memory=True)
            self.host[key] = buf
        return buf[:size].view(shape)


class DevicePrefetcher:
    """Stages ``source``'s rows on ``device`` from a worker thread:
    ``index_iter`` yields (k, B) sample-index arrays (``index_chunks``), and
    the prefetcher yields for each a dict of (k, B, ...) tensors, one per
    key of ``source`` (a dict of co-indexed host tensors or arrays), up to
    ``depth`` chunks ahead of the consumer.  The worker gathers each
    chunk's rows with ``torch.index_select``, which holds no GIL while it
    copies, so the gather does not contend with the training loop's
    dispatch.

    On a CUDA device each chunk is gathered straight into one of
    ``depth + 1`` pinned slots and uploads on the prefetcher's own stream.
    The worker waits for a slot's previous upload to finish before it
    writes the slot again, and the consumer's stream waits on the chunk's
    event; ``record_stream`` tells the caching allocator that the
    consumer's stream uses the chunk, so its memory is not handed out again
    while a step still reads it.  On the CPU a chunk is gathered into fresh
    tensors.

    A worker error re-raises on the consumer side; an exhausted or closed
    prefetcher raises StopIteration on every later ``next``.  ``close()``
    stops the worker and drops the staged chunks.  ``stage_s`` holds the
    worker's seconds per chunk (the gather into the slot and the upload's
    launch)."""

    def __init__(self, index_iter: Iterator, source: dict, depth: int = 2, device=None):
        self.device = torch.device(device if device is not None else "cpu")
        self._index_iter = index_iter
        self._source = {k: torch.as_tensor(v) for k, v in source.items()}
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._done = object()
        self._error: Optional[BaseException] = None
        self._finished = False
        self._closed = threading.Event()
        self.stage_s: List[float] = []
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._slots = [_Slot() for _ in range(max(1, int(depth)) + 1)]
        self._n_staged = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _stage(self, chunk_idx):
        """(tensors, event) of one (k, B) index chunk on the device."""
        shape = tuple(np.shape(chunk_idx))
        idx = torch.from_numpy(np.asarray(chunk_idx, np.int64).reshape(-1))
        if not self._cuda:
            return {k: src.index_select(0, idx).view(shape + src.shape[1:])
                    for k, src in self._source.items()}, None
        slot = self._slots[self._n_staged % len(self._slots)]
        self._n_staged += 1
        if slot.event is not None:
            slot.event.synchronize()  # its last upload has read it
        out = {}
        with torch.cuda.stream(self._stream):
            for k, src in self._source.items():
                host = slot.view(k, (idx.numel(),) + src.shape[1:], src.dtype)
                torch.index_select(src, 0, idx, out=host)
                out[k] = host.to(self.device, non_blocking=True).view(shape + src.shape[1:])
            slot.event = torch.cuda.Event()
            slot.event.record(self._stream)
        return out, slot.event

    def _put(self, item) -> bool:
        """A put that gives up once the consumer closed the prefetcher: a
        worker blocked in put would pin its staged chunks for the life of
        the process after an abandoned iteration."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        # a worker failure must not look like the end of the data: it is
        # carried to the consumer and raised there
        try:
            for chunk_idx in self._index_iter:
                if self._closed.is_set():
                    return
                t0 = time.perf_counter()
                staged = self._stage(chunk_idx)
                self.stage_s.append(time.perf_counter() - t0)
                if not self._put(staged):
                    return
        except BaseException as exc:  # noqa: BLE001 - re-raised consumer-side
            self._error = exc
        finally:
            self._put(self._done)

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self):
        """Stop the worker and drop the staged chunks (idempotent); safe in
        a ``finally`` around a loop that may abandon the iteration."""
        self._closed.set()
        self._drain()
        self._thread.join(timeout=30.0)
        self._drain()  # a put racing the first drain can land one more
        if self._cuda:
            for slot in self._slots:
                if slot.event is not None:
                    slot.event.synchronize()
            self._slots = []

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished or self._closed.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._finished = True
            if self._error is not None:
                raise RuntimeError("DevicePrefetcher worker failed") from self._error
            raise StopIteration
        tensors, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in tensors.values():
                t.record_stream(consumer)
        return tensors
