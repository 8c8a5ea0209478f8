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

Resilience, at the JAX package's sites: the consumer stamps the watchdog
phase ``feed`` before it blocks on the next batch (a wait past
``watchdog_feed_timeout_s`` is a wedged feed); the ``hang_feed`` fault
sleeps the worker at a train iteration and ``episode_corrupt`` fails the
first attempt at an episode index (``resilience/faults.py``).

Over a mesh of ranks (``mesh``, ``parallel/mesh.py``) each rank samples
only its own positions ``[r·L, (r+1)·L)`` of every global batch
(``parallel/multihost.py § assemble_global_batch``): the stream is
indexed as above, so the ranks agree on the global batch without
exchanging a byte. With ``elastic_pad_tasks`` the train batch's global
tail holds that many zero episodes, which the train step masks; the
stream stays indexed by the real ``batch_size``.
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
from howtotrainyourmamlpytorch_tpu_torch.parallel.multihost import (
    assemble_global_batch, local_batch_positions)
from howtotrainyourmamlpytorch_tpu_torch.resilience import faults, watchdog
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
    counters; ``mesh`` (a ``parallel.mesh.Mesh``) makes every batch this
    rank's shard."""

    def __init__(self, cfg: MAMLConfig, device: DeviceLike = None,
                 registry=None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
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
                if attempt == 0 and faults.maybe_fire("episode_corrupt",
                                                      step=int(idx)):
                    raise OSError(f"injected corrupt episode at index "
                                  f"{idx}")
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

    def _zero_episodes(self, n: int) -> Episode:
        """``n`` all-zero pad tasks in the wire dtypes. Elastic pad
        positions only: the train step gives them exactly zero weight,
        and zeros keep every forward finite."""
        cfg = self.cfg
        h, w, c = cfg.image_shape
        img = np.uint8 if cfg.transfer_images_uint8 else np.float32
        lbl = np.dtype(cfg.label_dtype)
        return Episode(
            np.zeros((n, cfg.num_support_per_task, h, w, c), img),
            np.zeros((n, cfg.num_support_per_task), lbl),
            np.zeros((n, cfg.num_target_per_task, h, w, c), img),
            np.zeros((n, cfg.num_target_per_task), lbl))

    # -- device placement -------------------------------------------------
    def _place(self, batch: Episode, stream):
        """Host batch -> ``(Episode of tensors on the device, event)``.
        Runs in the worker: on the card the pinned copies go out on
        ``stream`` and ``event`` marks their end; on the CPU the event is
        None. A packed source's episode rows are fancy-indexed copies out
        of its mapping (``PackedSource.get_images_raw``), so what is
        pinned is that copy, never the mapped file."""
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
                 batch_size: int, pad_tasks: int = 0) -> Iterator[Episode]:
        sampler = self.sampler(split)
        # The steps see batch_size + pad_tasks positions (pads are the
        # global tail); the stream stays indexed by batch_size. A rank
        # of a mesh samples only its own positions.
        padded = batch_size + pad_tasks
        positions = ((0, padded) if self.mesh is None
                     else local_batch_positions(self.mesh, padded))
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
                    # A wedged feed (hung mount, dead decoder): the worker
                    # sleeps past the feed deadline, the consumer blocks
                    # in q.get with 'feed' stamped, the watchdog trips.
                    if faults.maybe_fire("hang_feed", step=start_idx + b):
                        faults.hang()
                    base = (start_idx + b) * batch_size + salt

                    def sample_range(s: int, e: int) -> Episode:
                        parts = []
                        if s < batch_size:
                            parts.append(self._sample_batch(sampler, range(
                                base + s, base + min(e, batch_size))))
                        if e > batch_size:
                            parts.append(self._zero_episodes(
                                e - max(s, batch_size)))
                        return (parts[0] if len(parts) == 1 else Episode(
                            *(np.concatenate(f) for f in zip(*parts))))

                    batch = assemble_global_batch(
                        sample_range, padded, self.mesh,
                        positions=positions)
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
                # The consumer is about to block on the input pipeline.
                watchdog.stamp("feed", detail=split)
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
                             self.cfg.batch_size,
                             pad_tasks=self.cfg.elastic_pad_tasks)

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
