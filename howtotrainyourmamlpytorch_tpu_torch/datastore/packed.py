"""PackedSource: read-only mmap-backed episodic image source (the port's
copy of the JAX package's ``datastore/packed.py``).

A drop-in for the ``ArraySource``/``DiskImageSource`` protocol
(``class_names`` / ``num_images`` / ``get_images`` / ``get_images_raw``
/ ``class_images``) over one MAMLPACK1 shard (``datastore/format.py``):

* **Open is O(header), zero decode.** The constructor validates the
  framed header and ``np.memmap``-s the image block; no pixel is read
  until an episode actually samples it, and then the OS page cache —
  shared by every process on the host — serves it. The cold-start cost
  ``DiskImageSource`` pays per process (``os.walk`` + PIL decode of each
  first-touched class) is paid once at pack time instead.
* **Zero-copy class views.** ``class_images`` returns a view straight
  into the mapping; ``get_images_raw`` fancy-indexes that view, copying
  only the episode's selected rows — already the uint8 wire format the
  loader copies into pinned memory and ships to the device (the mapping
  itself is never pinned).
* **Integrity on demand.** ``verify()`` CRC-checks every class block
  against the header (a deliberate full read — the pack CLI's
  ``--verify`` and tests use it); open itself stays cheap and catches
  framing/truncation damage only (``format.read_header``).

Class order is the order the shard stores (the pack CLI writes the
source's deterministic order), NOT re-sorted here: bitwise episode
parity with the directory source requires the exact ``class_names``
sequence the sampler saw at pack time.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from howtotrainyourmamlpytorch_tpu_torch.datastore.format import (
    CorruptShardError, block_crc32, read_header)


class PackedSource:
    """Class-indexed uint8 images over one mmap-ed MAMLPACK1 shard."""

    kind = "packed"

    def __init__(self, path: str, expected_image_shape=None):
        self.path = path
        self.header, data_offset = read_header(path)
        h, w, c = self.header["image_shape"]
        if (expected_image_shape is not None
                and tuple(expected_image_shape) != (h, w, c)):
            # A geometry mismatch is a WRONG shard, not a damaged one —
            # ValueError (config error), never CorruptShardError (which
            # would quarantine a perfectly good file).
            raise ValueError(
                f"{path}: shard geometry {(h, w, c)} != configured "
                f"image_shape {tuple(expected_image_shape)}")
        total = self.header["total_images"]
        self._images = np.memmap(path, dtype=np.uint8, mode="r",
                                 offset=data_offset,
                                 shape=(total, h, w, c))
        self._names: List[str] = [e["name"]
                                  for e in self.header["classes"]]
        self._classes: Dict[str, Any] = {
            e["name"]: (e["offset"], e["count"], e["crc32"])
            for e in self.header["classes"]}

    @property
    def class_names(self) -> List[str]:
        return list(self._names)

    @property
    def nbytes_mapped(self) -> int:
        """Image-block bytes behind the mapping (telemetry:
        ``data/pack_bytes_mapped``)."""
        return int(self._images.size)

    def num_images(self, class_name: str) -> int:
        return self._classes[class_name][1]

    def class_images(self, class_name: str) -> np.ndarray:
        """The class's whole ``(n, H, W, C)`` block as a zero-copy view
        into the mapping."""
        offset, count, _ = self._classes[class_name]
        return self._images[offset:offset + count]

    def get_images_raw(self, class_name: str,
                       indices: np.ndarray) -> np.ndarray:
        """(len(indices), H, W, C) uint8 — the device wire format. Only
        the selected rows are materialized (fancy indexing on the
        mapped view)."""
        return self.class_images(class_name)[np.asarray(indices)]

    def get_images(self, class_name: str,
                   indices: np.ndarray) -> np.ndarray:
        """(len(indices), H, W, C) float32 in [0, 1]."""
        return (self.get_images_raw(class_name, indices)
                .astype(np.float32) / 255.0)

    def verify(self) -> Dict[str, int]:
        """CRC-check every class block against the header; returns
        ``{class: crc32}`` on success, raises :class:`CorruptShardError`
        naming the first damaged class otherwise. Reads the whole block
        by design — this is the pack CLI's ``--verify`` and the test
        suite's bit-flip detector, not an open-path cost."""
        out: Dict[str, int] = {}
        for name in self._names:
            crc = block_crc32(self.class_images(name))
            if crc != self._classes[name][2]:
                raise CorruptShardError(
                    f"{self.path}: class {name!r} CRC mismatch "
                    f"(stored {self._classes[name][2]}, read {crc}) — "
                    f"image block bit-rot")
            out[name] = crc
        return out
