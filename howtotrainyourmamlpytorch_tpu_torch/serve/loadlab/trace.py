"""Traffic trace format: CRC-framed JSONL of request arrivals.

The port's own copy of the JAX package's ``serve/loadlab/trace.py`` (the
same trace file format). It imports nothing of that package.

One trace file = one shaped workload, replayable byte-for-byte. The
payload is plain JSONL — a header line followed by one line per
request record — framed exactly like an L2 cache entry
(``serve/fleet/l2cache.py``): an 8-byte magic, a u64 payload length
and a u32 CRC32, all verified before a single line is parsed. A
truncated copy, a bit flip or a foreign file is a loud
:class:`ValueError` at open, never a silently-shortened replay that
would flatter every latency number downstream.

Record schema (one JSON object per line):

* ``t``           — arrival instant, seconds relative to trace start
  (monotone non-decreasing; the replayer's clock).
* ``tenant``      — integer tenant id; the replayer maps it into its
  tenant pool (``workloads.tenant_pool``), so the same trace drives
  any pool size.
* ``bucket``      — ``[support, query]`` shape bucket the request
  pads into.
* ``deadline_ms`` — per-request deadline or ``null``.
* ``seed``        — per-request RNG seed for fresh query pixels
  (repeat tenants keep their support set; queries are always new).

Stdlib only, no package imports — loadable by file path (the
``ckpt/manifest.py`` discipline) so torch-free frontends can read and
write traces.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

TRACE_MAGIC = b"MAMLTRC1"
TRACE_VERSION = 1
TRACE_SUFFIX = ".trace"
_HEAD = struct.Struct("!QI")  # payload length, payload crc32


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


def trace_record(t: float, tenant: int, bucket: Sequence[int],
                 deadline_ms: Optional[float] = None,
                 seed: int = 0) -> Dict[str, Any]:
    """One normalized arrival record (types pinned here so every
    generator emits identical JSON for identical inputs)."""
    if t < 0:
        raise ValueError(f"arrival t must be >= 0, got {t}")
    return {"t": round(float(t), 6), "tenant": int(tenant),
            "bucket": [int(bucket[0]), int(bucket[1])],
            "deadline_ms": (None if deadline_ms is None
                            else float(deadline_ms)),
            "seed": int(seed)}


def encode_trace(records: Sequence[Dict[str, Any]],
                 meta: Optional[Dict[str, Any]] = None) -> bytes:
    """records (+ free-form meta) -> one CRC-framed blob."""
    header = {"kind": "header", "version": TRACE_VERSION,
              "records": len(records)}
    header.update(meta or {})
    lines = [json.dumps(header, sort_keys=True)]
    prev_t = 0.0
    for rec in records:
        t = float(rec["t"])
        if t < prev_t:
            raise ValueError(
                f"records must be sorted by arrival: {t} after {prev_t}")
        prev_t = t
        lines.append(json.dumps(rec, sort_keys=True))
    payload = ("\n".join(lines) + "\n").encode()
    return (TRACE_MAGIC
            + _HEAD.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
            + payload)


def decode_trace(blob: bytes) -> Tuple[Dict[str, Any],
                                       List[Dict[str, Any]]]:
    """Inverse of :func:`encode_trace`; raises ValueError on ANY damage
    (magic, length, CRC, JSON, header) — a trace either replays exactly
    or refuses to replay at all."""
    head = len(TRACE_MAGIC) + _HEAD.size
    if len(blob) < head or blob[:len(TRACE_MAGIC)] != TRACE_MAGIC:
        raise ValueError("bad trace magic")
    length, crc = _HEAD.unpack(blob[len(TRACE_MAGIC):head])
    payload = blob[head:]
    if len(payload) != length:
        raise ValueError(
            f"trace payload length {len(payload)} != framed {length}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise ValueError("trace payload CRC mismatch")
    lines = payload.decode().splitlines()
    if not lines:
        raise ValueError("empty trace payload")
    header = json.loads(lines[0])
    if not isinstance(header, dict) or header.get("kind") != "header":
        raise ValueError("first trace line is not a header record")
    if int(header.get("version", -1)) != TRACE_VERSION:
        raise ValueError(
            f"unsupported trace version {header.get('version')!r}")
    records = [json.loads(ln) for ln in lines[1:] if ln.strip()]
    if len(records) != int(header.get("records", -1)):
        raise ValueError(
            f"trace holds {len(records)} records, header says "
            f"{header.get('records')}")
    return header, records


def write_trace(path: str, records: Sequence[Dict[str, Any]],
                meta: Optional[Dict[str, Any]] = None) -> int:
    """Atomic commit (tmp + fsync + rename — the l2cache discipline):
    a kill mid-write leaves a ``*.tmp.<pid>``, never a torn trace.
    Returns the byte size written."""
    blob = encode_trace(records, meta)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(d)
    return len(blob)


def read_trace(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    with open(path, "rb") as f:
        return decode_trace(f.read())
