"""Packed episodic dataset store (the port's copy of the JAX package's
``datastore/``; docs/DATA.md).

MAML++ training is episodic: every outer step resamples support/query
sets from a class-indexed image pool, so the data plane is hit
constantly — and at pod scale its cold-start behavior is load-bearing.
This package holds the packed, integrity-checked alternative to the
per-process ``os.walk``-and-decode directory source:

* :mod:`~.format` — the MAMLPACK1 shard layout (CRC32+length-framed JSON
  header + one contiguous uint8 NHWC image block) and its reader/writer.
* :mod:`~.packed` — :class:`PackedSource`, the read-only mmap-backed
  drop-in for the ``ArraySource``/``DiskImageSource`` protocol: open is
  O(header) with no decode, page cache shared across processes.

Pack with ``scripts/torch_dataset_pack.py`` (once, e.g. on a login node), then
``data/sources.py § build_source`` prefers a ``<split>.mamlpack`` next
to the dataset dir (or under ``cfg.dataset_pack_path``) automatically —
corrupt shards are quarantined (``*.corrupt``) and the directory source
takes over, so a damaged pack degrades to the old behavior, never to a
dead run.

Stdlib + numpy only: the pack CLI and login-node tooling import this
without torch's device runtime.
"""

from howtotrainyourmamlpytorch_tpu_torch.datastore.format import (
    MAGIC,
    PACK_SUFFIX,
    CorruptShardError,
    block_crc32,
    read_header,
    write_shard,
)
from howtotrainyourmamlpytorch_tpu_torch.datastore.packed import PackedSource

__all__ = [
    "MAGIC", "PACK_SUFFIX", "CorruptShardError", "PackedSource",
    "block_crc32", "read_header", "write_shard",
]
