"""Image sources: where episode images come from (the port's copy of the
JAX package's ``data/sources.py``; numpy only, so it gives the JAX
package's arrays bit for bit).

Reference: ``data.py § FewShotLearningDatasetParallel.load_dataset`` builds a
class→image-path index from ``datasets/<name>/{train,val,test}/<class>/…``
(disjoint class splits per directory). The on-disk contract is kept
(:class:`DiskImageSource`), beside an in-memory :class:`ArraySource`, a
deterministic :class:`SyntheticSource` and the sinusoid regression source.

Packed shards (datastore/ subsystem, docs/DATA.md): when a
``<split>.mamlpack`` shard exists (``scripts/torch_dataset_pack.py``),
:func:`build_source` prefers the mmap-backed
:class:`~howtotrainyourmamlpytorch_tpu_torch.datastore.packed.PackedSource`
over the directory walk — O(header) open, zero decode, page cache shared
across a host's processes; a corrupt shard is quarantined (``*.corrupt``)
and the directory source takes over.

Normalization note: images are returned float32 in [0, 1]; per-dataset
affine normalization is applied by the sampler.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from howtotrainyourmamlpytorch_tpu_torch.resilience import (counter_inc,
                                                          get_registry)

SPLITS = ("train", "val", "test")

# Suffix of packed shards (datastore/format.py § MAMLPACK1), duplicated
# here so resolving "is there a pack?" never imports the datastore
# package for runs that have none.
PACK_SUFFIX = ".mamlpack"


def source_kind(source) -> str:
    """Stable short name of a source's implementation ('packed', 'disk',
    'synthetic', 'array') — the telemetry/bench vocabulary for "where do
    episodes come from?" (docs/DATA.md). Wrappers delegate to what they
    wrap."""
    return str(getattr(source, "kind", type(source).__name__.lower()))


class ArraySource:
    """Class-indexed images held in host memory as uint8 NHWC arrays."""

    kind = "array"

    def __init__(self, classes: Dict[str, np.ndarray]):
        if not classes:
            raise ValueError("ArraySource needs at least one class")
        for name, arr in classes.items():
            if arr.ndim != 4 or arr.dtype != np.uint8:
                raise ValueError(
                    f"class {name!r}: expected uint8 (n,H,W,C), got "
                    f"{arr.dtype} {arr.shape}")
        self._classes = classes

    @property
    def class_names(self) -> List[str]:
        return sorted(self._classes)

    def num_images(self, class_name: str) -> int:
        return len(self._classes[class_name])

    def get_images(self, class_name: str,
                   indices: np.ndarray) -> np.ndarray:
        """(len(indices), H, W, C) float32 in [0, 1]."""
        return (self._classes[class_name][indices].astype(np.float32)
                / 255.0)

    def get_images_raw(self, class_name: str,
                       indices: np.ndarray) -> np.ndarray:
        """(len(indices), H, W, C) uint8 — the wire format for the
        device-side normalization path (4x fewer host->device bytes)."""
        return self._classes[class_name][indices]

    def class_images(self, class_name: str) -> np.ndarray:
        """The class's whole ``(n, H, W, C)`` uint8 block (the pack
        CLI's bulk-read path; episodes use ``get_images_raw``)."""
        return self._classes[class_name]


class DiskImageSource:
    """Lazy class→file-path index over the reference's directory layouts.

    Flat ``root/<class>/<image files>`` and nested layouts (e.g. Omniglot's
    ``root/<alphabet>/<character>/<images>``) are both indexed; the class
    identity of an image is formed from the path components selected by
    ``class_key_indexes`` (reference ``indexes_of_folders_indicating_class``
    — negative indexes counted from the file name; components that fall
    outside the dataset root are ignored, so the reference default
    ``(-3, -2)`` resolves to ``alphabet/character`` in the nested layout and
    to ``<class>`` in the flat one). ``None`` uses the full relative
    directory path.

    Images are decoded with PIL and resized to ``image_size`` on access;
    decoded classes are memoized (the episodic benchmarks revisit classes
    constantly and fit in RAM). ``preload`` (reference ``load_into_memory``)
    decodes every class eagerly at construction. ``numeric_sort`` (reference
    ``labels_as_int``) orders integer-named classes numerically.
    """

    IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")

    kind = "disk"

    def __init__(self, root: str, image_size: Tuple[int, int, int],
                 preload: bool = False, numeric_sort: bool = False,
                 class_key_indexes: Optional[Sequence[int]] = None):
        self.root = root
        self.image_size = image_size
        self.numeric_sort = numeric_sort
        self._index: Dict[str, List[str]] = {}
        self._cache: Dict[str, np.ndarray] = {}
        self._corrupt_warned = False
        root_norm = root.rstrip("/\\") or root
        for dirpath, dirnames, filenames in os.walk(root_norm):
            dirnames.sort()
            files = sorted(
                os.path.join(dirpath, f) for f in filenames
                if f.lower().endswith(self.IMAGE_EXTS))
            if not files:
                continue
            rel = os.path.relpath(dirpath, root_norm)
            if rel == ".":
                continue  # images directly under root carry no class
            relparts = rel.split(os.sep)
            key = self._class_key(relparts, class_key_indexes)
            self._index.setdefault(key, []).extend(files)
        if not self._index:
            raise ValueError(f"no image classes found under {root}")
        if preload:
            for name in self._index:
                self._load_class(name)

    @staticmethod
    def _class_key(relparts: List[str],
                   indexes: Optional[Sequence[int]]) -> str:
        if indexes is None:
            return "/".join(relparts)
        # Index into the file's path components, file name at -1 (never a
        # class component) — i.e. -2 is the containing directory. Indexes
        # reaching above the dataset root are dropped.
        parts = relparts + [None]  # type: ignore[list-item]
        picked = [parts[i] for i in indexes
                  if -len(parts) <= i < 0 and parts[i] is not None]
        return "/".join(picked) if picked else "/".join(relparts)

    @property
    def class_names(self) -> List[str]:
        if self.numeric_sort:
            def key(name: str):
                try:
                    return (0, int(name), name)
                except ValueError:
                    return (1, 0, name)
            return sorted(self._index, key=key)
        return sorted(self._index)

    def num_images(self, class_name: str) -> int:
        return len(self._index[class_name])

    def _load_class(self, class_name: str) -> np.ndarray:
        """Decode + memoize one class, SKIPPING unreadable files.

        A raise here used to poison the class forever: the exception
        fired inside the memoized decode on every re-touch, so the
        loader's fail-soft episode replacement could never succeed for
        any episode that drew this class. Instead each bad file is
        skipped with a ``data/corrupt_images`` count (one warning per
        source), the class index shrinks to the readable files (so
        ``num_images`` tells the sampler the truth from then on), and
        only a class that loses EVERY image raises — that split really
        is broken."""
        if class_name not in self._cache:
            from PIL import Image
            h, w, c = self.image_size
            imgs, good, last_err = [], [], None
            for path in self._index[class_name]:
                try:
                    im = Image.open(path)
                    im = im.convert("L" if c == 1 else "RGB")
                    if im.size != (w, h):
                        im = im.resize((w, h), Image.LANCZOS)
                    arr = np.asarray(im, np.uint8)
                except Exception as e:  # PIL raises a zoo of types
                    last_err = e
                    counter_inc("data/corrupt_images")
                    if not self._corrupt_warned:
                        self._corrupt_warned = True
                        warnings.warn(
                            f"unreadable image {path} "
                            f"({type(e).__name__}: {str(e)[:120]}); "
                            f"skipping it (further corrupt images are "
                            f"counted, not warned)", stacklevel=3)
                    continue
                if c == 1:
                    arr = arr[..., None]
                imgs.append(arr)
                good.append(path)
            if not imgs:
                raise OSError(
                    f"class {class_name!r}: all "
                    f"{len(self._index[class_name])} image files "
                    f"unreadable (last: {type(last_err).__name__}: "
                    f"{str(last_err)[:120]})")
            if len(good) != len(self._index[class_name]):
                self._index[class_name] = good
            self._cache[class_name] = np.stack(imgs)
        return self._cache[class_name]

    def get_images(self, class_name: str,
                   indices: np.ndarray) -> np.ndarray:
        return (self._load_class(class_name)[indices].astype(np.float32)
                / 255.0)

    def get_images_raw(self, class_name: str,
                       indices: np.ndarray) -> np.ndarray:
        return self._load_class(class_name)[indices]

    def class_images(self, class_name: str) -> np.ndarray:
        """The class's whole decoded ``(n, H, W, C)`` uint8 block (the
        pack CLI's bulk-read path)."""
        return self._load_class(class_name)

    def evict_class(self, class_name: str) -> None:
        """Drop a memoized class block. The pack CLI streams a whole
        split through ``class_images``; without eviction the memo would
        pin the full decoded dataset in RAM on exactly the small login
        boxes packing targets. Episodic training never calls this —
        revisiting classes is the workload, the memo is the point."""
        self._cache.pop(class_name, None)


class SubsetSource:
    """Restrict a source to a subset of its classes, preserving order —
    the split view over one flat class pool (``sets_are_pre_split=False``).
    """

    def __init__(self, source, names: Sequence[str]):
        missing = set(names) - set(source.class_names)
        if missing:
            raise ValueError(f"classes not in source: {sorted(missing)}")
        if not names:
            raise ValueError("SubsetSource needs at least one class")
        self._source = source
        self._names = list(names)

    @property
    def kind(self) -> str:
        return source_kind(self._source)

    @property
    def class_names(self) -> List[str]:
        return self._names

    def num_images(self, class_name: str) -> int:
        return self._source.num_images(class_name)

    def get_images(self, class_name: str,
                   indices: np.ndarray) -> np.ndarray:
        return self._source.get_images(class_name, indices)

    def get_images_raw(self, class_name: str,
                       indices: np.ndarray) -> np.ndarray:
        return self._source.get_images_raw(class_name, indices)

    def class_images(self, class_name: str) -> np.ndarray:
        return self._source.class_images(class_name)

    def evict_class(self, class_name: str) -> None:
        evict = getattr(self._source, "evict_class", None)
        if evict is not None:
            evict(class_name)


def split_class_names(names: Sequence[str],
                      fractions: Sequence[float],
                      split: str) -> List[str]:
    """Deterministic contiguous class split of one flat pool by
    (train, val, test) fractions — reference ``data.py § load_dataset``
    when ``sets_are_pre_split`` is False. ASSUMPTION (mount empty, see
    MOUNT-AUDIT.md): classes are taken in the source's deterministic order
    and split contiguously; fractions are normalized by their sum."""
    if split not in SPLITS:
        raise ValueError(f"unknown split {split!r}")
    total = float(sum(fractions))
    if total <= 0:
        raise ValueError(f"train_val_test_split sums to {total}")
    n = len(names)
    # Cumulative rounding so per-split rounding errors can't leak classes
    # into a split whose fraction says it should be empty (independent
    # round(f*n) per split would: e.g. (0.5, 0.5, 0) over 5 classes).
    c1 = int(round(fractions[0] / total * n))
    c2 = int(round((fractions[0] + fractions[1]) / total * n))
    bounds = {"train": (0, c1), "val": (c1, c2), "test": (c2, n)}
    lo, hi = bounds[split]
    return list(names[lo:hi])


class SyntheticSource(ArraySource):
    """Deterministic procedurally-generated classes (tests / benchmarks).

    Each class is a fixed random prototype plus per-image noise, generated
    from ``seed`` — an int, or a tuple of ints fed to
    ``np.random.SeedSequence`` as independent entropy words so composite
    seeds like ``(split_id, cfg.seed)`` give disjoint streams with NO
    arithmetic collisions (the old ``1000*split_id + seed`` mixing made
    (seed=1000, train) and (seed=0, val) the same stream).
    """

    kind = "synthetic"

    def __init__(self, num_classes: int, images_per_class: int,
                 image_size: Tuple[int, int, int], seed=0):
        h, w, c = image_size
        rng = np.random.default_rng(
            np.random.SeedSequence(seed) if isinstance(seed, tuple)
            else seed)
        classes = {}
        for i in range(num_classes):
            proto = rng.uniform(0, 255, (1, h, w, c))
            noise = rng.normal(0, 40, (images_per_class, h, w, c))
            classes[f"class_{i:05d}"] = np.clip(
                proto + noise, 0, 255).astype(np.uint8)
        super().__init__(classes)


class SinusoidSource:
    """Few-shot sinusoid regression tasks (Finn et al. 2017 §5.1,
    arXiv:1703.03400).

    Each "class" is ONE sinusoid task ``y = A·sin(x − φ)`` with
    amplitude ``A ∈ [0.1, 5.0]`` and phase ``φ ∈ [0, π]``; its "images"
    are a fixed pool of x points drawn uniformly from ``[-5, 5]``,
    stored in the episode pipeline's ``(n, 1, 1, 1)`` float32 NHWC
    layout so every downstream shape contract (sampler, loader buckets,
    serve batcher) holds unchanged, and :meth:`get_targets` returns the
    matching float32 y values (the regression counterpart of the
    sampler's 0..N-1 relabeling). Deliberately NO ``get_images_raw``:
    x points are real-valued, so the uint8 wire does not apply (config
    validation rejects ``transfer_images_uint8`` for regression) and
    the sampler's float32 path engages naturally.

    Seeding matches :class:`SyntheticSource`: an int, or a tuple fed to
    ``np.random.SeedSequence`` as entropy words so ``(split_id, seed)``
    streams are disjoint with no arithmetic collisions.
    """

    kind = "sinusoid"

    AMP_RANGE = (0.1, 5.0)
    PHASE_RANGE = (0.0, np.pi)
    X_RANGE = (-5.0, 5.0)

    def __init__(self, num_tasks: int, points_per_task: int, seed=0):
        if num_tasks < 1 or points_per_task < 1:
            raise ValueError("SinusoidSource needs >=1 task and point")
        rng = np.random.default_rng(
            np.random.SeedSequence(seed) if isinstance(seed, tuple)
            else seed)
        self._x: Dict[str, np.ndarray] = {}
        self._y: Dict[str, np.ndarray] = {}
        for i in range(num_tasks):
            name = f"task_{i:05d}"
            amp = rng.uniform(*self.AMP_RANGE)
            phase = rng.uniform(*self.PHASE_RANGE)
            x = rng.uniform(*self.X_RANGE,
                            points_per_task).astype(np.float32)
            self._x[name] = x.reshape(-1, 1, 1, 1)
            self._y[name] = (amp * np.sin(x - phase)).astype(np.float32)

    @property
    def class_names(self) -> List[str]:
        return sorted(self._x)

    def num_images(self, class_name: str) -> int:
        return len(self._y[class_name])

    def get_images(self, class_name: str,
                   indices: np.ndarray) -> np.ndarray:
        """(len(indices), 1, 1, 1) float32 x points ("images")."""
        return self._x[class_name][indices]

    def get_targets(self, class_name: str,
                    indices: np.ndarray) -> np.ndarray:
        """(len(indices),) float32 regression targets."""
        return self._y[class_name][indices]


_SPLIT_SEEDS = {"train": 0, "val": 1, "test": 2}


def pack_shard_path(cfg, split: str) -> str:
    """Where ``build_source`` looks for ``split``'s packed shard:
    ``<cfg.dataset_pack_path>/<split>.mamlpack`` when the config points
    at a pack directory, else ``<cfg.dataset_dir>/<split>.mamlpack`` —
    next to the split subdirectories, where ``scripts/torch_dataset_pack.py``
    writes by default."""
    base = cfg.dataset_pack_path or cfg.dataset_dir
    return os.path.join(base, split + PACK_SUFFIX)


def _try_packed_source(cfg, split: str):
    """Open ``split``'s packed shard if one exists; None = no (usable)
    pack, fall through to the directory/synthetic resolution.

    A corrupt/truncated shard is QUARANTINED — renamed ``*.corrupt``
    (idempotent under multi-process races: the rename is attempted by
    whichever process notices first, losers tolerate the miss) and
    counted into ``resilience/quarantined``, consistent with the
    checkpoint policy (utils/checkpoint.py § _quarantine) — so every
    later open falls back to the directory source instead of re-parsing
    the same damaged bytes. A shard whose geometry merely disagrees with
    the config is left in place (it is a wrong file, not a damaged one)
    and skipped with a warning.
    """
    path = pack_shard_path(cfg, split)
    if not os.path.isfile(path):
        if cfg.dataset_pack_path:
            # An EXPLICIT pack path with no shard is warned about: a
            # typo'd path silently changing the run's cold-start class
            # is the quiet-fallback failure mode this config key's
            # did-you-mean validation exists to prevent. The implicit
            # next-to-the-dataset probe stays silent — most runs have
            # no pack and that is normal.
            warnings.warn(
                f"dataset_pack_path is set but {path!r} does not "
                f"exist; falling back to directory/synthetic "
                f"resolution for split {split!r}", stacklevel=4)
        return None
    from howtotrainyourmamlpytorch_tpu_torch.datastore.packed import (
        CorruptShardError, PackedSource)
    t0 = time.perf_counter()
    try:
        src = PackedSource(path, expected_image_shape=cfg.image_shape)
    except CorruptShardError as e:
        try:
            os.replace(path, path + ".corrupt")
            counter_inc("resilience/quarantined")
        except OSError:
            pass  # a peer quarantined it first, or the dir is read-only;
            #       the fallback below proceeds either way
        warnings.warn(
            f"packed shard {path} is corrupt "
            f"({type(e).__name__}: {str(e)[:160]}); quarantined to "
            f"*.corrupt, falling back to the directory source",
            stacklevel=3)
        return None
    except ValueError as e:
        warnings.warn(
            f"packed shard {path} skipped: {e} (not quarantined — the "
            f"file is intact, the config disagrees with it)",
            stacklevel=3)
        return None
    reg = get_registry()
    if reg is not None:
        reg.counter("data/pack_open_seconds").inc(
            time.perf_counter() - t0)
        reg.gauge("data/pack_bytes_mapped").set(src.nbytes_mapped)
    return src


def build_source(cfg, split: str):
    """Resolve a split's image source from the config.

    Resolution order:

    1. A packed shard (``<split>.mamlpack`` under ``dataset_pack_path``
       or next to the split dirs — :func:`pack_shard_path`): O(header)
       mmap open, zero decode, page cache shared across processes
       (docs/DATA.md). Corrupt shards are quarantined and fall through.
    2. ``sets_are_pre_split=True`` (default): disk layout
       ``<cfg.dataset_dir>/<split>/<class>/…`` when present — where
       ``dataset_dir`` is ``dataset_path/dataset_name`` (the reference's
       contract) or ``dataset_path`` itself if it already holds the
       split dirs. ``sets_are_pre_split=False``: one flat class pool
       under ``dataset_dir``, partitioned into class-disjoint splits by
       ``cfg.train_val_test_split``. Either way ``load_into_memory``,
       ``labels_as_int`` and ``indexes_of_folders_indicating_class``
       shape the disk index (see :class:`DiskImageSource`).
    3. A synthetic fallback (with a warning unless the dataset name says
       'synthetic') so the framework runs end-to-end with no datasets
       installed.

    Every resolution counts ``data/source_kind/<kind>`` into the
    process registry (when one is installed) so the telemetry report can
    answer "what actually fed this run?" after the fact.
    """
    if split not in SPLITS:
        raise ValueError(f"unknown split {split!r}")
    src = _resolve_source(cfg, split)
    counter_inc(f"data/source_kind/{source_kind(src)}")
    return src


def _resolve_source(cfg, split: str):
    if cfg.task_type == "regression":
        # Regression tasks are procedurally generated — there is no
        # disk/pack layout to probe, and the task distribution is the
        # dataset (Finn 2017 samples fresh sinusoids forever; a large
        # fixed per-split pool keeps the deterministic-episode contract
        # the samplers and eval seeds rely on).
        return SinusoidSource(
            num_tasks=max(40 * cfg.num_classes_per_set, 200),
            points_per_task=max(
                2 * (cfg.num_samples_per_class + cfg.num_target_samples),
                50),
            seed=(_SPLIT_SEEDS[split], cfg.seed))
    packed = _try_packed_source(cfg, split)
    if packed is not None:
        return packed
    disk_kwargs = dict(
        preload=cfg.load_into_memory,
        numeric_sort=cfg.labels_as_int,
        class_key_indexes=cfg.indexes_of_folders_indicating_class)
    if cfg.sets_are_pre_split:
        root = os.path.join(cfg.dataset_dir, split)
        if os.path.isdir(root):
            return DiskImageSource(root, cfg.image_shape, **disk_kwargs)
    else:
        root = cfg.dataset_dir
        if os.path.isdir(root):
            pool = DiskImageSource(root, cfg.image_shape, **disk_kwargs)
            return SubsetSource(pool, split_class_names(
                pool.class_names, cfg.train_val_test_split, split))
    if "synthetic" not in cfg.dataset_name:
        warnings.warn(
            f"dataset split directory {root!r} not found; using a "
            f"synthetic source", stacklevel=2)
    # Enough classes for 20-way sampling; disjoint per (split, seed) via
    # SeedSequence entropy words (no arithmetic seed collisions).
    return SyntheticSource(
        num_classes=max(4 * cfg.num_classes_per_set, 40),
        images_per_class=max(
            2 * (cfg.num_samples_per_class + cfg.num_target_samples), 20),
        image_size=cfg.image_shape,
        seed=(_SPLIT_SEEDS[split], cfg.seed))
