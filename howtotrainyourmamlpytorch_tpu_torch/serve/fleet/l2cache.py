"""Shared L2 adapted-params tier: a content-addressed blob store.

The port's own copy of the JAX package's ``serve/fleet/l2cache.py`` (the
same file framing: magic, CRC, header; so either package reads the
other's entries; the port's engine keys them apart (``backend=torch`` in
its fingerprint context)). It imports nothing of that package.

The per-replica L1 (``serve/cache.py``) dies with its process and its
capacity; the fleet needs a second tier so (a) a tenant adapted on
replica A is NOT re-adapted when a drain/spill/restart routes it to
replica B, and (b) a restarted replica re-warms from disk instead of
from traffic. This module is that tier: one file per cache entry under
a shared directory (the experiment dir — the same storage the
checkpoint subsystem already trusts), keyed by the engine's support
fingerprint, which folds in the adapt-step count AND the checkpoint
fingerprint — so a hot-swap invalidates the whole tier *structurally*
(new keys) with no coordination, exactly like the L1.

Write discipline is ``ckpt/manifest.py``'s, adapted to many concurrent
writers (several replicas publish at once, so a single-writer manifest
file is the one idiom that does NOT transfer):

* **CRC-framed**: ``MAMLL2C1`` magic + u64 payload length + u32 CRC32 +
  payload (an ``np.savez`` archive of the flattened trees + a JSON tree
  spec). Every read verifies magic, length and CRC before trusting a
  byte.
* **pending -> committed = tmp + fsync + rename**: the ``*.tmp.<pid>``
  file IS the pending state; the atomic rename IS the commit. A kill
  mid-write leaves a tmp (swept by :meth:`sweep`), never a torn final
  path. Concurrent same-key publishes are idempotent — the key is a
  content hash, so last-rename-wins installs identical bytes.
* **GC by recency**: a hit bumps the entry's mtime (best-effort), and
  past ``max_entries`` the oldest-mtime entries are unlinked — an LRU
  over files.

Failure discipline (the ``cache_errors`` rule): every damage mode
— missing, truncated, bit-flipped, unparseable, or a filesystem error
anywhere — is a **counted fail-soft miss** (``fleet/l2_errors``), never
a wrong answer and never an exception on the serve path; a provably
damaged file is quarantined (unlinked, best-effort) so it cannot keep
costing a verify-and-fail on every repeat.

Stdlib + numpy only, no package imports — loadable by file path (the
``ckpt/manifest.py`` discipline), so the torch-free bench/router process
can inspect the tier too. ``np.load(..., allow_pickle=False)``: the
payload is arrays + JSON, never pickled objects.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

L2_MAGIC = b"MAMLL2C1"
ENTRY_SUFFIX = ".l2"
_HEAD = struct.Struct("!QI")  # payload length, payload crc32

# Eagerly-registered metric names (telemetry satellite): a flush row
# must show zeros, not absent keys.
HITS = "fleet/l2_hits"
MISSES = "fleet/l2_misses"
ERRORS = "fleet/l2_errors"
PUBLISHES = "fleet/l2_publishes"
EVICTIONS = "fleet/l2_evictions"
ENTRIES_GAUGE = "fleet/l2_entries"


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# -- tree <-> flat arrays ----------------------------------------------------
# The adapted value is a pytree of arrays (nested dicts/lists/tuples);
# torch must not be imported here, so the flattener walks plain Python
# containers. Leaves are coerced through np.asarray (device arrays
# arrive pre-converted by the engine; python scalars become 0-d arrays
# — the predict path only ever stacks leaves, so the coercion is
# lossless where it matters).

def _flatten(tree: Any, leaves: List[np.ndarray]) -> Any:
    if isinstance(tree, dict):
        return {"k": "d", "v": {str(k): _flatten(tree[k], leaves)
                                for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"k": "l" if isinstance(tree, list) else "t",
                "v": [_flatten(x, leaves) for x in tree]}
    leaves.append(np.asarray(tree))
    return {"k": "a", "i": len(leaves) - 1}


def _unflatten(spec: Any, leaves: List[np.ndarray]) -> Any:
    kind = spec["k"]
    if kind == "d":
        return {k: _unflatten(v, leaves) for k, v in spec["v"].items()}
    if kind in ("l", "t"):
        seq = [_unflatten(v, leaves) for v in spec["v"]]
        return seq if kind == "l" else tuple(seq)
    return leaves[spec["i"]]


def encode_entry(fast: Any, bn_state: Any) -> bytes:
    """(fast, bn_state) trees -> one CRC-framed blob."""
    leaves: List[np.ndarray] = []
    spec = {"fast": _flatten(fast, leaves),
            "bn_state": _flatten(bn_state, leaves)}
    buf = io.BytesIO()
    np.savez(buf, spec=np.frombuffer(
        json.dumps(spec).encode(), dtype=np.uint8),
        **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    payload = buf.getvalue()
    return (L2_MAGIC
            + _HEAD.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
            + payload)


def decode_entry(blob: bytes) -> Dict[str, Any]:
    """Inverse of :func:`encode_entry`; raises ValueError on ANY damage
    (magic, length, CRC, archive, spec) — the caller converts that to a
    counted miss."""
    head = len(L2_MAGIC) + _HEAD.size
    if len(blob) < head or blob[:len(L2_MAGIC)] != L2_MAGIC:
        raise ValueError("bad L2 magic/header")
    length, crc = _HEAD.unpack(blob[len(L2_MAGIC):head])
    payload = blob[head:]
    if len(payload) != length:
        raise ValueError(f"L2 payload {len(payload)}B != framed {length}B")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise ValueError("L2 payload CRC mismatch")
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            spec = json.loads(bytes(z["spec"].tobytes()).decode())
            leaves = [z[f"leaf_{i}"]
                      for i in range(len(z.files) - 1)]
    except Exception as e:  # noqa: BLE001 — any archive damage is the
        # same verdict: not a valid entry.
        raise ValueError(f"L2 archive unreadable: {e}") from e
    return {"fast": _unflatten(spec["fast"], leaves),
            "bn_state": _unflatten(spec["bn_state"], leaves)}


class L2AdaptedParamsCache:
    """Filesystem-backed content-addressed adapted-params store.

    ``registry`` is duck-typed on the telemetry MetricsRegistry; None
    runs unobserved (counts still land on the plain attributes, the
    ``serve/cache.py`` pattern).
    """

    def __init__(self, directory: str, *, max_entries: int = 512,
                 registry: Optional[Any] = None):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.directory = directory
        self.max_entries = int(max_entries)
        self.registry = registry
        self.hits = 0
        self.misses = 0
        self.errors = 0
        self.publishes = 0
        self.evictions = 0
        # GC amortization: a full gc() is one listdir + a stat per
        # entry — O(max_entries) filesystem ops, far too much to pay
        # per publish on the serve path (worse on network mounts).
        # Run it once per _gc_every publishes instead; the cap is then
        # enforced within max_entries + _gc_every, which is the same
        # "bounded, eventually trimmed" contract GC-by-recency makes
        # anyway.
        self._gc_every = max(8, self.max_entries // 8)
        self._puts_since_gc = self._gc_every  # first publish sets the
        #                                      entries gauge
        if registry is not None:
            for name in (HITS, MISSES, ERRORS, PUBLISHES, EVICTIONS):
                registry.counter(name)

    def _count(self, attr: str, name: str) -> None:
        setattr(self, attr, getattr(self, attr) + 1)
        if self.registry is not None:
            try:
                self.registry.counter(name).inc()
            except Exception:
                pass

    def path(self, key: str) -> str:
        # Keys are hex fingerprints (filesystem-safe by construction);
        # anything else is a programming error worth failing loudly in
        # tests, but the serve path never passes one.
        return os.path.join(self.directory, f"{key}{ENTRY_SUFFIX}")

    # -- read path --------------------------------------------------------
    def get(self, key: str) -> Optional[Dict[str, Any]]:
        """The entry's (fast, bn_state) trees, or None. A plain absent
        key is a counted miss; damage is a counted error AND a miss,
        with the damaged file quarantined so repeats don't re-pay the
        verify-and-fail."""
        path = self.path(key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            self._count("misses", MISSES)
            return None
        except OSError:
            self._count("errors", ERRORS)
            self._count("misses", MISSES)
            return None
        try:
            entry = decode_entry(blob)
        except ValueError:
            self._count("errors", ERRORS)
            self._count("misses", MISSES)
            try:
                os.remove(path)  # quarantine: damaged bytes never serve
            except OSError:
                pass
            return None
        self._count("hits", HITS)
        try:
            os.utime(path)  # recency bump: GC is an LRU over mtimes
        except OSError:
            pass
        return entry

    # -- write path -------------------------------------------------------
    def put(self, key: str, fast: Any, bn_state: Any) -> bool:
        """Publish one adapted entry (pending = tmp, committed = the
        atomic rename). Fail-soft: False (counted) on any error — a
        failed publish only costs the next cross-replica repeat an
        adapt."""
        path = self.path(key)
        try:
            os.makedirs(self.directory, exist_ok=True)
            blob = encode_entry(fast, bn_state)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _fsync_dir(self.directory)
        except Exception:  # noqa: BLE001 — shared-storage publishes
            # fail for transient reasons a serve path must absorb.
            self._count("errors", ERRORS)
            return False
        self._count("publishes", PUBLISHES)
        self._puts_since_gc += 1
        if self._puts_since_gc >= self._gc_every:
            self._puts_since_gc = 0
            self.gc()
        return True

    # -- maintenance ------------------------------------------------------
    def entries(self) -> List[Tuple[str, float]]:
        """(key, mtime) per committed entry, oldest first, fail-soft."""
        out: List[Tuple[str, float]] = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if not name.endswith(ENTRY_SUFFIX) or ".tmp." in name:
                continue
            try:
                mtime = os.stat(os.path.join(self.directory, name)).st_mtime
            except OSError:
                continue
            out.append((name[:-len(ENTRY_SUFFIX)], mtime))
        out.sort(key=lambda kv: kv[1])
        return out

    def gc(self, max_entries: Optional[int] = None) -> int:
        """Unlink oldest-recency entries past the cap (counted). A
        concurrent GC racing this one just finds files already gone —
        idempotent by construction."""
        cap = self.max_entries if max_entries is None else int(max_entries)
        entries = self.entries()
        dropped = 0
        if self.registry is not None:
            try:
                self.registry.gauge(ENTRIES_GAUGE).set(len(entries))
            except Exception:
                pass
        for key, _ in entries[:max(len(entries) - cap, 0)]:
            try:
                os.remove(self.path(key))
                dropped += 1
                self._count("evictions", EVICTIONS)
            except OSError:
                pass
        return dropped

    def sweep(self, stale_tmp_s: float = 3600.0) -> int:
        """Drop ``*.tmp.*`` leftovers from killed writers, but only ones
        old enough that no live writer can still own them (a fresh tmp
        is a publish in flight on another replica)."""
        import time
        dropped = 0
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 0
        now = time.time()
        for name in names:
            if ".tmp." not in name:
                continue
            path = os.path.join(self.directory, name)
            try:
                if now - os.stat(path).st_mtime > stale_tmp_s:
                    os.remove(path)
                    dropped += 1
            except OSError:
                continue
        return dropped
