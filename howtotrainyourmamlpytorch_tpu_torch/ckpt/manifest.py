"""Committed-checkpoint manifest (the port's copy of the JAX package's
``ckpt/manifest.py``; ``MANIFEST.json`` is byte-compatible, so the JAX
package's ``scripts/ckpt_admin.py`` reads a port run's directory).

``MANIFEST.json`` holds one record per checkpoint tag —

    {"tag", "epoch", "iter", "bytes", "crc", "status", "val_acc", "file"}

with ``status`` moving ``pending`` → ``committed`` around the file write
(``utils/checkpoint.py § write_epoch_files``). A kill mid-write leaves a
``pending`` record and a ``*.tmp`` file; the final path is never torn
(atomic rename after fsync), so GC (:func:`sweep`) drops pending records
and tmp leftovers while every committed record names bytes it can verify
(whole-file CRC32 + length). A missing or damaged manifest degrades
readers to the directory-scan behavior, never to an error: the manifest
is an index, the checkpoint files stay the ground truth.

Stdlib only.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Optional

MANIFEST_FILE = "MANIFEST.json"
SCHEMA = "maml_ckpt_manifest_v1"
PENDING = "pending"
COMMITTED = "committed"

# Framed-checkpoint magic (the MAMLCKP1 layout lives in
# utils/checkpoint.py, which imports this constant).
CKPT_MAGIC = b"MAMLCKP1"


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory, making a just-renamed entry
    durable against a host crash; filesystems that cannot fsync a
    directory degrade silently (the rename itself is still atomic)."""
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


def atomic_write_json(path: str, obj: Any) -> None:
    """Durable atomic JSON rewrite: tmp + fsync(file) + rename +
    best-effort fsync(dir). A crash leaves either the old or the new
    content under ``path``, never a zero-length or torn file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def file_crc32(path: str, chunk_bytes: int = 1 << 20) -> int:
    """Streaming CRC32 over a whole file (the ``verify`` primitive)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def file_fingerprint(path: str) -> int:
    """Cheap content fingerprint: crc32 over size + head/tail 64 bytes,
    the JAX package's algorithm (the same bytes give the same value in
    both packages). -1 = unreadable."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(64)
            f.seek(max(size - 64, 0))
            tail = f.read(64)
    except OSError:
        return -1
    return zlib.crc32(size.to_bytes(8, "little") + head + tail)


class Manifest:
    """The ``MANIFEST.json`` record store for one checkpoint directory.

    Single-writer by contract; readers construct their own instance and
    treat the records as advisory — a tag without a record is simply
    pre-manifest.
    """

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, MANIFEST_FILE)
        self.records: Dict[str, Dict[str, Any]] = {}
        # Whether a readable manifest existed on disk: "no manifest yet"
        # is not "the manifest says nothing".
        self.loaded = False
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return  # absent or damaged: degrade to directory-scan truth
        recs = doc.get("records")
        if isinstance(recs, dict):
            self.records = {str(k): dict(v) for k, v in recs.items()
                            if isinstance(v, dict)}
            self.loaded = True

    def _write(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        atomic_write_json(self.path,
                          {"schema": SCHEMA, "records": self.records})

    # -- transitions ----------------------------------------------------
    def begin(self, tag, *, epoch: Optional[int] = None,
              iteration: int = 0, val_acc: Optional[float] = None,
              flush: bool = True) -> Dict[str, Any]:
        """Open a ``pending`` record for ``tag`` before its file write.
        ``flush=False`` mutates memory only; the caller batches several
        transitions into one durable rewrite via :meth:`flush`."""
        tag = str(tag)
        rec = {
            "tag": tag,
            "epoch": int(epoch) if epoch is not None else None,
            "iter": int(iteration),
            "bytes": 0,
            "crc": 0,
            "status": PENDING,
            "val_acc": float(val_acc) if val_acc is not None else None,
            "file": f"train_model_{tag}.ckpt",
        }
        self.records[tag] = rec
        if flush:
            self._write()
        return rec

    def commit(self, tag, *, nbytes: int, crc: int,
               flush: bool = True) -> Dict[str, Any]:
        """Mark ``tag``'s write durable: record the byte count and
        whole-file CRC32 the ``verify`` path checks against."""
        tag = str(tag)
        rec = self.records.get(tag)
        if rec is None:  # commit without begin: synthesize
            rec = self.begin(tag, flush=False)
        rec["bytes"] = int(nbytes)
        rec["crc"] = int(crc) & 0xFFFFFFFF
        rec["status"] = COMMITTED
        if flush:
            self._write()
        return rec

    def flush(self) -> None:
        """Durably rewrite the manifest with every in-memory change."""
        self._write()

    def remove(self, tag) -> bool:
        if str(tag) in self.records:
            del self.records[str(tag)]
            self._write()
            return True
        return False

    def remove_many(self, tags, flush: bool = True) -> int:
        """Drop several records in ONE durable rewrite."""
        dropped = 0
        for tag in tags:
            if str(tag) in self.records:
                del self.records[str(tag)]
                dropped += 1
        if dropped and flush:
            self._write()
        return dropped

    # -- queries --------------------------------------------------------
    def get(self, tag) -> Optional[Dict[str, Any]]:
        return self.records.get(str(tag))

    def committed(self) -> List[Dict[str, Any]]:
        """Committed records, newest first (by iteration; the 'latest'
        tag wins ties: it is by definition at least as new)."""
        recs = [r for r in self.records.values()
                if r.get("status") == COMMITTED]
        return sorted(recs, key=lambda r: (int(r.get("iter") or 0),
                                           r.get("tag") == "latest"),
                      reverse=True)

    def pending(self) -> List[Dict[str, Any]]:
        return [r for r in self.records.values()
                if r.get("status") != COMMITTED]


def verify_record(directory: str, record: Dict[str, Any]) -> Dict[str, Any]:
    """Full-read verification of one committed record: file present,
    byte count matches, whole-file CRC32 matches."""
    path = os.path.join(directory, record.get("file") or "")
    if record.get("status") != COMMITTED:
        return {"ok": False, "reason": "pending"}
    try:
        size = os.path.getsize(path)
    except OSError:
        return {"ok": False, "reason": "missing"}
    if size != int(record.get("bytes") or 0):
        return {"ok": False,
                "reason": f"size {size} != recorded {record.get('bytes')}"}
    if file_crc32(path) != int(record.get("crc") or 0):
        return {"ok": False, "reason": "crc mismatch"}
    return {"ok": True, "reason": "ok"}


def sweep(manifest: Manifest, keep_tags=None,
          remove_corrupt: bool = True,
          dry_run: bool = False) -> Dict[str, List[str]]:
    """Garbage-collect a checkpoint directory against its manifest (the
    JAX function). Removes ``*.tmp`` leftovers of a killed write;
    ``pending`` records (the record only: a file at the final path under a
    pending record is the PREVIOUS committed version, since writes are
    atomic renames); records whose file is gone; with ``keep_tags``,
    committed epoch records and files outside the retention set
    (``latest`` is never pruned); and ``*.corrupt`` quarantine leftovers
    (``remove_corrupt``; the writer's startup sweep leaves them for
    forensics). ``dry_run`` reports without touching anything. Returns
    ``{"deleted_files": [...], "dropped_records": [...]}``."""
    directory = manifest.directory
    deleted: List[str] = []
    dropped: List[str] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        names = []

    def unlink(name: str) -> None:
        deleted.append(name)
        if not dry_run:
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                deleted.pop()

    for name in names:
        if name.endswith(".tmp") or ".tmp." in name:
            unlink(name)
        elif remove_corrupt and name.endswith(".corrupt"):
            unlink(name)
    keep = (None if keep_tags is None
            else {str(t) for t in keep_tags} | {"latest"})
    for tag, rec in sorted(manifest.records.items()):
        path = os.path.join(directory, rec.get("file") or "")
        if rec.get("status") != COMMITTED or not os.path.isfile(path):
            dropped.append(tag)
        elif keep is not None and tag not in keep:
            unlink(rec["file"])
            dropped.append(tag)
    if not dry_run:
        for tag in dropped:
            manifest.records.pop(tag, None)
        if dropped:
            manifest._write()
    return {"deleted_files": deleted, "dropped_records": dropped}
