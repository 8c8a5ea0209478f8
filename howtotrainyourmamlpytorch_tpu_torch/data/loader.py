"""Host-side batch pipeline with background prefetch to the device (the
port's counterpart of the JAX package's ``data/loader.py``).

A worker thread samples each meta-batch with the numpy
:class:`EpisodeSampler`, pins it and copies it to the device on a side
CUDA stream (``non_blocking``), so the copy overlaps the previous step's
compute; the consumer makes its current stream wait for the copy before
it hands the batch out. On the CPU the batch is handed out as tensors
over the sampler's arrays.

Episode-index contract (resume correctness, reference
``continue_from_iter``): train batch ``i`` uses episode indices
``[i·B, (i+1)·B)`` of a stream seeded by ``train_seed``, shifted by the
train salt (divergence rewinds) — resuming at iteration ``i`` reproduces
exactly the batches an uninterrupted run would have seen. Val/test use
fixed streams (``val_seed``; test ``val_seed + 104729``) with indices
``[0, num_evaluation_tasks)`` padded up to a full last batch, so
evaluation episodes are identical every epoch and across runs.

Telemetry: the train feed is metered by :attr:`feed`
(``telemetry/instruments.py § FeedStallMeter``): time the consumer spends
blocked on the next batch against time it spends in its step; with a
registry, skipped episodes count ``data/corrupt_episodes``.

Not ported yet: mesh placement and multi-host assembly (ROADMAP.md,
Queue 1: parallel/mesh slice), the elastic pad, and the watchdog and
fault hooks (resilience/ckpt slice).
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Iterator, Optional

import numpy as np
import torch

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.data.sampler import EpisodeSampler
from howtotrainyourmamlpytorch_tpu_torch.data.sources import build_source
from howtotrainyourmamlpytorch_tpu_torch.device import (DeviceLike,
                                                        resolve_device)
from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
from howtotrainyourmamlpytorch_tpu_torch.telemetry.instruments import (
    FeedStallMeter)

_STOP = object()

# A corrupt episode is replaced by episode index + k * stride (k = 1..3):
# deterministic (resume-safe), and the prime stride keeps replacements far
# outside the contiguous index range a real run ever visits.
_REPLACEMENT_STRIDE = 15_485_863
_MAX_REPLACEMENTS = 3
# One divergence rewind shifts the whole TRAIN episode stream by this
# much, so the re-run of the rewound window draws fresh episodes instead
# of replaying the batch that produced the NaN.
_REWIND_SALT_STRIDE = 2 ** 33
# Offset of the test stream's seed from the val stream's, so the two
# fixed evaluation streams differ.
_TEST_SEED_OFFSET = 104729


class MetaLearningDataLoader:
    """Per-split samplers yielding meta-batches as tensors on ``device``
    (the card by default; ``device="cpu"`` must be asked for).
    ``registry`` (a ``telemetry.MetricsRegistry``) receives the loader's
    counters."""

    def __init__(self, cfg: MAMLConfig, device: DeviceLike = None,
                 registry=None):
        if cfg.elastic_pad_tasks > 0:
            raise NotImplementedError(
                "elastic_pad_tasks > 0 (elastic pad-and-mask) is not ported "
                "yet (ROADMAP.md, Queue 1: parallel/mesh slice)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._samplers = {}
        self._train_salt = 0
        self._corrupt_warned = False
        self.registry = registry
        # Cumulative over the loader's life, train split only: eval
        # sweeps are not the training hot path.
        self.feed = FeedStallMeter()

    def set_train_salt(self, salt: int) -> None:
        """Shift the train episode stream (divergence rewinds); the
        persisted rewind count, so a resumed run reproduces the
        post-rewind stream exactly."""
        self._train_salt = int(salt)

    def sampler(self, split: str) -> EpisodeSampler:
        if split not in self._samplers:
            cfg = self.cfg
            seed = {"train": cfg.train_seed, "val": cfg.val_seed,
                    "test": cfg.val_seed + _TEST_SEED_OFFSET}[split]
            self._samplers[split] = EpisodeSampler(
                build_source(cfg, split), cfg, seed,
                # The reference augments classes for training only.
                augment_classes=cfg.augment_images and split == "train")
        return self._samplers[split]

    # -- fail-soft episode sampling --------------------------------------
    def _sample_episode(self, sampler: EpisodeSampler, idx: int) -> Episode:
        """One episode, skipping corrupt/unreadable ones: a failed sample
        is replaced by a deterministic alternate index (the batch stays
        full), with one warning per loader."""
        last: Optional[Exception] = None
        for attempt in range(_MAX_REPLACEMENTS + 1):
            j = int(idx) + attempt * _REPLACEMENT_STRIDE
            try:
                return sampler.sample(j)
            except Exception as e:
                last = e
                if self.registry is not None:
                    self.registry.counter("data/corrupt_episodes").inc()
                if not self._corrupt_warned:
                    self._corrupt_warned = True
                    warnings.warn(
                        f"corrupt/unreadable episode {j} "
                        f"({type(e).__name__}: {str(e)[:120]}); drawing a "
                        f"deterministic replacement (further skips are "
                        f"not warned)", stacklevel=2)
        raise last  # replacements exhausted: the split itself is broken

    def _sample_batch(self, sampler: EpisodeSampler, indices) -> Episode:
        """Stack episodes on the leading task axis, fail-soft per
        episode."""
        eps = [self._sample_episode(sampler, i) for i in indices]
        return Episode(*(np.stack(field) for field in zip(*eps)))

    # -- device placement -------------------------------------------------
    def _place(self, batch: Episode, stream):
        """Host batch -> ``(Episode of tensors on the device, event)``.
        Runs in the worker: on the card the pinned copies go out on
        ``stream`` and ``event`` marks their end; on the CPU the event is
        None."""
        host = [torch.from_numpy(np.ascontiguousarray(f)) for f in batch]
        if stream is None:
            return Episode(*host), None
        with torch.cuda.stream(stream):
            out = Episode(*(t.pin_memory().to(self.device, non_blocking=True)
                            for t in host))
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _batches(self, split: str, start_idx: int, num_batches: int,
                 batch_size: int) -> Iterator[Episode]:
        sampler = self.sampler(split)
        q: "queue.Queue" = queue.Queue(
            maxsize=max(1, self.cfg.prefetch_batches))
        abandoned = threading.Event()
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        # Divergence rewinds re-seed the TRAIN stream only; the fixed
        # val/test streams stay identical across rewinds.
        salt = (self._train_salt * _REWIND_SALT_STRIDE
                if split == "train" else 0)

        def put_bounded(item) -> None:
            # Bounded put so an abandoned consumer can't strand the worker
            # on a full queue.
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def worker():
            try:
                for b in range(num_batches):
                    if abandoned.is_set():
                        return
                    base = (start_idx + b) * batch_size + salt
                    batch = self._sample_batch(
                        sampler, range(base, base + batch_size))
                    put_bounded(self._place(batch, stream))
            except Exception as e:  # surface in the consumer, don't hang
                put_bounded(e)
            put_bounded(_STOP)

        # Time blocked in q.get() is input-pipeline stall; time inside
        # ``yield`` is the consumer's step.
        meter = self.feed if split == "train" else None
        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                if meter is not None:
                    meter.record_wait(time.perf_counter() - t0)
                if item is _STOP:
                    break
                if isinstance(item, Exception):
                    raise item
                batch, event = item
                if event is not None:
                    # The step runs on the consumer's current stream: it
                    # waits for the copy, and the caching allocator learns
                    # that the batch is used there.
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for f in batch:
                        f.record_stream(current)
                t1 = time.perf_counter()
                yield batch
                if meter is not None:
                    meter.record_dispatch(time.perf_counter() - t1)
        finally:
            # Consumer abandoned (error or early break): stop the worker
            # instead of letting it produce the rest of the epoch.
            abandoned.set()
            t.join(timeout=5)

    def get_train_batches(self, start_iter: int,
                          num_iters: int) -> Iterator[Episode]:
        """Batches for train iterations [start_iter, start_iter+num_iters)."""
        return self._batches("train", start_iter, num_iters,
                             self.cfg.batch_size)

    def _eval_batches(self, split: str) -> Iterator[Episode]:
        cfg = self.cfg
        b = cfg.effective_eval_batch_size
        # Pad the fixed episode count up to a full final batch; the caller
        # truncates to num_evaluation_tasks.
        return self._batches(split, 0, -(-cfg.num_evaluation_tasks // b), b)

    def get_val_batches(self) -> Iterator[Episode]:
        return self._eval_batches("val")

    def get_test_batches(self) -> Iterator[Episode]:
        return self._eval_batches("test")
