"""MAMLPACK1: the packed episodic dataset shard format (the port's copy of
the JAX package's ``datastore/format.py``; the same bytes from the same
classes, so either package reads a shard the other wrote).

One shard = one split's whole class-indexed image pool in a single file,
laid out for mmap consumption (docs/DATA.md):

    MAMLPACK1 ‖ crc32(header) ‖ len(header) ‖ header JSON ‖ image block

The framing reuses the checkpoint conventions (``utils/checkpoint.py §
MAMLCKP1``): magic, little-endian CRC32 and length of the payload —
except here the CRC-framed payload is only the *header*, so opening a
multi-GB shard validates O(header) bytes, never the image block. The
image block is one contiguous uint8 NHWC array (every class's images
back to back, in class order); per-class integrity rides CRC32s stored
in the header, checked by ``PackedSource.verify()`` / the pack CLI's
``--verify`` — a full-read operation by design, paid once at pack time
or on demand, never at open.

Why this exists: ``DiskImageSource`` rebuilds a class index with
``os.walk`` and PIL-decodes classes on first touch in EVERY process. On
a multi-host pod over network storage that is minutes of redundant
decode and a thundering herd of tiny reads. A packed shard is decoded
once (``scripts/torch_dataset_pack.py``); afterwards every process mmaps it —
open is O(header) with zero decode, and one host's page cache is shared
across its processes.

Header schema (JSON, versioned by the magic):

    {"format": "MAMLPACK1",
     "image_shape": [H, W, C],
     "dtype": "uint8",
     "total_images": M,
     "classes": [{"name": str, "offset": int, "count": int,
                  "crc32": int}, ...],          # offset/count in images
     "provenance": {...}}                       # pack tool bookkeeping

Every structural violation — bad magic, header CRC/length mismatch,
truncated or over-long image block, offsets that don't tile
``[0, total_images)`` — raises :class:`CorruptShardError`, the single
error type the data plane's quarantine-and-fallback path keys on
(``data/sources.py § build_source``).

Stdlib + numpy only: the pack CLI runs on login nodes with no
accelerator runtime.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

MAGIC = b"MAMLPACK1"
PACK_SUFFIX = ".mamlpack"
_FIXED_LEN = len(MAGIC) + 4 + 8  # magic ‖ crc32(header) ‖ len(header)

# Copy granularity for the data-block splice in write_shard (the image
# block is written to a sidecar tmp first, then spliced behind the
# header; holding a whole Mini-ImageNet split in RAM to avoid the copy
# would defeat the point of packing on small fleet boxes).
_COPY_CHUNK = 8 * 1024 * 1024


class CorruptShardError(RuntimeError):
    """MAMLPACK1 shard whose framing/geometry fails its integrity check."""


def block_crc32(images: np.ndarray) -> int:
    """CRC32 over a class's image block bytes (C-order uint8) — the ONE
    definition both the writer and every verifier use."""
    return zlib.crc32(np.ascontiguousarray(images, np.uint8).tobytes())


def write_shard(path: str, classes: Iterable[Tuple[str, np.ndarray]],
                provenance: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    """Write one MAMLPACK1 shard atomically; returns the header written.

    ``classes`` yields ``(name, uint8 (n, H, W, C) array)`` in the order
    the shard should store them (``PackedSource.class_names`` preserves
    it — pack in the source's deterministic order so packed and
    directory episodes stay bitwise identical). Streams class by class:
    the image block goes to a sidecar tmp while offsets/CRCs accumulate,
    then header + block are spliced into ``path + ".tmp"`` and renamed —
    a crashed pack never leaves a half-written shard under the real name.
    """
    entries = []
    geometry: Optional[Tuple[int, ...]] = None
    offset = 0
    data_tmp = path + ".tmp.data"
    final_tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        with open(data_tmp, "wb") as data_f:
            for name, arr in classes:
                arr = np.ascontiguousarray(arr)
                if arr.ndim != 4 or arr.dtype != np.uint8:
                    raise ValueError(
                        f"class {name!r}: expected uint8 (n,H,W,C), got "
                        f"{arr.dtype} {arr.shape}")
                if len(arr) == 0:
                    raise ValueError(
                        f"class {name!r} has zero images; an empty class "
                        f"can never be sampled and would poison N-way "
                        f"episode draws")
                if geometry is None:
                    geometry = arr.shape[1:]
                elif arr.shape[1:] != geometry:
                    raise ValueError(
                        f"class {name!r}: geometry {arr.shape[1:]} != "
                        f"shard geometry {geometry}")
                entries.append({"name": str(name), "offset": offset,
                                "count": int(len(arr)),
                                "crc32": block_crc32(arr)})
                offset += len(arr)
                data_f.write(arr.tobytes())
        if geometry is None:
            raise ValueError("write_shard needs at least one class")
        header = {
            "format": MAGIC.decode("ascii"),
            "image_shape": [int(d) for d in geometry],
            "dtype": "uint8",
            "total_images": offset,
            "classes": entries,
            "provenance": dict(provenance or {}),
        }
        payload = json.dumps(header, sort_keys=True).encode("utf-8")
        with open(final_tmp, "wb") as f:
            f.write(MAGIC)
            f.write(zlib.crc32(payload).to_bytes(4, "little"))
            f.write(len(payload).to_bytes(8, "little"))
            f.write(payload)
            with open(data_tmp, "rb") as data_f:
                while True:
                    chunk = data_f.read(_COPY_CHUNK)
                    if not chunk:
                        break
                    f.write(chunk)
        os.replace(final_tmp, path)
    finally:
        for tmp in (data_tmp, final_tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return header


def read_header(path: str) -> Tuple[Dict[str, Any], int]:
    """Parse + integrity-check a shard's header; O(header) IO.

    Returns ``(header, data_offset)``. Raises :class:`CorruptShardError`
    on any structural violation, including an image block whose length
    (from the file size — no data read) disagrees with the header: a
    truncated copy or partial write is caught at open, before a training
    run maps garbage.
    """
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            fixed = f.read(_FIXED_LEN)
            if len(fixed) < _FIXED_LEN or not fixed.startswith(MAGIC):
                raise CorruptShardError(
                    f"{path}: not a {MAGIC.decode()} shard (bad or "
                    f"truncated magic)")
            crc = int.from_bytes(fixed[len(MAGIC):len(MAGIC) + 4], "little")
            hlen = int.from_bytes(fixed[len(MAGIC) + 4:], "little")
            if _FIXED_LEN + hlen > size:
                raise CorruptShardError(
                    f"{path}: header claims {hlen} bytes but the file "
                    f"holds {size - _FIXED_LEN} past the magic (truncated)")
            payload = f.read(hlen)
    except OSError as e:
        raise CorruptShardError(f"{path}: unreadable ({e})") from e
    if len(payload) != hlen:
        raise CorruptShardError(f"{path}: short header read")
    if zlib.crc32(payload) != crc:
        raise CorruptShardError(
            f"{path}: header CRC mismatch (bit-rot or concurrent "
            f"overwrite)")
    try:
        header = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CorruptShardError(
            f"{path}: header JSON unparseable after CRC pass "
            f"({type(e).__name__})") from e
    _validate_header(header, path)
    data_offset = _FIXED_LEN + hlen
    h, w, c = header["image_shape"]
    expected = data_offset + header["total_images"] * h * w * c
    if size != expected:
        kind = "truncated" if size < expected else "over-long"
        raise CorruptShardError(
            f"{path}: {kind} image block — file is {size} bytes, header "
            f"geometry needs exactly {expected}")
    return header, data_offset


def _validate_header(header: Dict[str, Any], path: str) -> None:
    for key in ("format", "image_shape", "dtype", "total_images",
                "classes"):
        if key not in header:
            raise CorruptShardError(f"{path}: header missing {key!r}")
    if header["format"] != MAGIC.decode("ascii"):
        raise CorruptShardError(
            f"{path}: header format {header['format']!r} != "
            f"{MAGIC.decode()!r}")
    if header["dtype"] != "uint8":
        raise CorruptShardError(
            f"{path}: unsupported dtype {header['dtype']!r} (MAMLPACK1 "
            f"stores the uint8 wire format)")
    shape = header["image_shape"]
    if (not isinstance(shape, list) or len(shape) != 3
            or any(not isinstance(d, int) or d < 1 for d in shape)):
        raise CorruptShardError(
            f"{path}: bad image_shape {shape!r}")
    total = header["total_images"]
    if not isinstance(total, int) or total < 1:
        raise CorruptShardError(f"{path}: bad total_images {total!r}")
    # Class entries must tile [0, total) exactly — overlaps or holes mean
    # the offsets are lying about where each class's pixels live.
    expect = 0
    seen = set()
    for e in header["classes"]:
        if (not isinstance(e, dict)
                or not isinstance(e.get("name"), str)
                or not isinstance(e.get("offset"), int)
                or not isinstance(e.get("count"), int)
                or not isinstance(e.get("crc32"), int)
                or e["count"] < 1):
            raise CorruptShardError(f"{path}: bad class entry {e!r}")
        if e["offset"] != expect:
            raise CorruptShardError(
                f"{path}: class {e['name']!r} offset {e['offset']} != "
                f"expected {expect} (entries must tile the block)")
        if e["name"] in seen:
            raise CorruptShardError(
                f"{path}: duplicate class {e['name']!r}")
        seen.add(e["name"])
        expect += e["count"]
    if expect != total:
        raise CorruptShardError(
            f"{path}: class counts sum to {expect}, header says {total}")
