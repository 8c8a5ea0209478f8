"""Pack a reference-layout image dataset into MAMLPACK1 shards (the
PyTorch port's counterpart of ``scripts/dataset_pack.py``: the same
flags, the same shards, the same last line and exit codes, over the
port's own ``datastore/`` and ``data/sources.py``).

Decode once, mmap forever (docs/DATA.md): this CLI walks a dataset
directory exactly as ``DiskImageSource`` would — same class-key rules,
same deterministic class order, same fail-soft skip of unreadable
files — PIL-decodes every class, and writes one ``<split>.mamlpack``
shard per split (``datastore/format.py``). Training processes then open
the shard O(header) with zero decode (``build_source`` prefers a shard
automatically), so a multi-host pod stops paying per-process
``os.walk`` + decode against shared storage.

Usage (pre-split layout ``<root>/{train,val,test}/<class>/…``):

    python scripts/torch_dataset_pack.py <root> --height 28 --width 28 \\
        --channels 1 [--splits train,val,test] [--out DIR] [--verify]

Flat class pool split by fractions (``sets_are_pre_split=False``):

    python scripts/torch_dataset_pack.py <root> --flat \\
        --fractions 0.64,0.16,0.20 --height 84 --width 84 --channels 3

Or take every layout/geometry knob from a shipped experiment config
(the recommended form — packed episodes are bitwise identical to what
that config's directory source would sample):

    python scripts/torch_dataset_pack.py --config experiment_config/x.json \\
        [--verify]

``--verify`` re-opens each written shard and CRC-checks EVERY class
block against the header (a deliberate full read).

The LAST stdout line is the JSON artifact (the repo's CLI contract):
``{"metric": "dataset_pack", "classes", "images", "bytes",
"verify_ok", ...}``. Exit 0 on success, 1 on any failure.

Imports the port only (no JAX). PIL is needed to decode a directory,
nowhere else.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.config import (  # noqa: E402
    MAMLConfig)
from howtotrainyourmamlpytorch_tpu_torch.data import (  # noqa: E402
    sources as _sources)
from howtotrainyourmamlpytorch_tpu_torch.datastore import (  # noqa: E402
    PACK_SUFFIX, PackedSource, write_shard)


def _split_sources(args):
    """Yield (split, source) pairs for the requested layout, built with
    the SAME index rules build_source uses for the directory path."""
    disk_kwargs = dict(numeric_sort=args.labels_as_int,
                       class_key_indexes=args.class_indexes)
    image_shape = (args.height, args.width, args.channels)
    if args.flat:
        pool = _sources.DiskImageSource(args.root, image_shape,
                                        **disk_kwargs)
        for split in args.splits:
            names = _sources.split_class_names(
                pool.class_names, args.fractions, split)
            if not names:
                continue  # a zero fraction legitimately empties a split
            yield split, _sources.SubsetSource(pool, names)
    else:
        for split in args.splits:
            root = os.path.join(args.root, split)
            if not os.path.isdir(root):
                continue
            yield split, _sources.DiskImageSource(root, image_shape,
                                                  **disk_kwargs)


def _class_stream(source):
    """Yield (name, full decoded class block) in the source's
    deterministic order — the order PackedSource will replay, so packed
    and directory episodes stay bitwise identical. Each class is
    EVICTED from the source's decode memo after the writer consumes it,
    so peak RSS is one class, not the whole split."""
    for name in source.class_names:
        yield name, source.class_images(name)
        evict = getattr(source, "evict_class", None)
        if evict is not None:
            evict(name)


def _pack_split(split, source, out_dir, root, verify):
    path = os.path.join(out_dir, split + PACK_SUFFIX)
    t0 = time.perf_counter()
    header = write_shard(path, _class_stream(source), provenance={
        "tool": "scripts/torch_dataset_pack.py",
        "source_root": os.path.abspath(root),
        "source_kind": _sources.source_kind(source),
        "split": split,
        "packed_unix": round(time.time(), 3),
    })
    info = {
        "path": path,
        "classes": len(header["classes"]),
        "images": header["total_images"],
        "bytes": os.path.getsize(path),
        "pack_seconds": round(time.perf_counter() - t0, 3),
    }
    if verify:
        t1 = time.perf_counter()
        PackedSource(path).verify()  # raises CorruptShardError on damage
        info["verify_seconds"] = round(time.perf_counter() - t1, 3)
    return info


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="pack a dataset directory into MAMLPACK1 shards")
    ap.add_argument("root", nargs="?", default=None,
                    help="dataset directory (holding split subdirs, or a "
                         "flat class pool with --flat); with --config, "
                         "defaults to the config's dataset_dir")
    ap.add_argument("--config", default=None, metavar="JSON",
                    help="take geometry/layout knobs (image shape, "
                         "labels_as_int, class-key indexes, pre-split vs "
                         "flat, fractions, pack output dir) from an "
                         "experiment config")
    ap.add_argument("--out", default=None,
                    help="output directory for <split>.mamlpack shards "
                         "(default: the config's dataset_pack_path, else "
                         "the dataset dir itself — where build_source "
                         "looks first)")
    ap.add_argument("--splits", default="train,val,test",
                    help="comma list of splits to pack (missing split "
                         "dirs are skipped)")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--channels", type=int, default=None)
    ap.add_argument("--flat", action="store_true",
                    help="root is one flat class pool; partition it by "
                         "--fractions (sets_are_pre_split=False layout)")
    ap.add_argument("--fractions", default=None,
                    help="train,val,test class fractions for --flat "
                         "(default 0.64,0.16,0.20; an explicit value "
                         "overrides --config)")
    ap.add_argument("--labels-as-int", action="store_true",
                    help="order integer-named classes numerically "
                         "(reference labels_as_int)")
    ap.add_argument("--class-indexes", default=None,
                    help="comma ints: path components forming the class "
                         "key (reference "
                         "indexes_of_folders_indicating_class; default "
                         "-3,-2; an explicit value overrides --config)")
    ap.add_argument("--verify", action="store_true",
                    help="re-read every written shard and CRC-check "
                         "every class block")
    args = ap.parse_args(argv)

    # Explicit CLI values ALWAYS win; --config (then the flag defaults)
    # fill whatever was not given.
    explicit_indexes = (tuple(int(v) for v in args.class_indexes.split(",")
                              if v)
                        if args.class_indexes is not None else None)
    explicit_fractions = (tuple(float(v)
                                for v in args.fractions.split(","))
                          if args.fractions is not None else None)
    if args.config:
        cfg = MAMLConfig.from_json_file(args.config)
        args.root = args.root or cfg.dataset_dir
        args.height = args.height or cfg.image_height
        args.width = args.width or cfg.image_width
        args.channels = args.channels or cfg.image_channels
        args.flat = args.flat or not cfg.sets_are_pre_split
        args.labels_as_int = args.labels_as_int or cfg.labels_as_int
        # None = class key is the full relative path (DiskImageSource).
        ks = cfg.indexes_of_folders_indicating_class
        args.class_indexes = (explicit_indexes if explicit_indexes
                              is not None
                              else tuple(ks) if ks is not None else None)
        args.fractions = explicit_fractions or tuple(
            cfg.train_val_test_split)
        args.out = args.out or cfg.dataset_pack_path or args.root
    else:
        if args.root is None:
            ap.error("either a dataset root or --config is required")
        if not (args.height and args.width and args.channels):
            ap.error("--height/--width/--channels are required without "
                     "--config")
        args.class_indexes = (explicit_indexes if explicit_indexes
                              is not None else (-3, -2))
        args.fractions = explicit_fractions or (0.64, 0.16, 0.20)
        args.out = args.out or args.root
    args.splits = tuple(s for s in str(args.splits).split(",") if s)
    for s in args.splits:
        if s not in _sources.SPLITS:
            ap.error(f"unknown split {s!r}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    shards = {}
    verify_ok = True if args.verify else None
    try:
        if not os.path.isdir(args.root):
            raise FileNotFoundError(
                f"dataset root {args.root!r} is not a directory")
        os.makedirs(args.out, exist_ok=True)
        packed_any = False
        for split, source in _split_sources(args):
            print(json.dumps({"split": split, "status": "packing",
                              "classes": len(source.class_names)}),
                  flush=True)
            shards[split] = _pack_split(split, source, args.out,
                                        args.root, args.verify)
            packed_any = True
        if not packed_any:
            raise FileNotFoundError(
                f"no packable splits found under {args.root!r} "
                f"(looked for {', '.join(args.splits)})")
    except Exception as e:  # noqa: BLE001 — the artifact line must exist
        print(json.dumps({
            "metric": "dataset_pack",
            "error": f"{type(e).__name__}: {e}",
            "classes": sum(s["classes"] for s in shards.values()),
            "images": sum(s["images"] for s in shards.values()),
            "bytes": sum(s["bytes"] for s in shards.values()),
            "verify_ok": False if args.verify else None,
            "shards": shards,
        }), flush=True)
        return 1
    artifact = {
        "metric": "dataset_pack",
        "value": float(sum(s["images"] for s in shards.values())),
        "unit": "images",
        "classes": sum(s["classes"] for s in shards.values()),
        "images": sum(s["images"] for s in shards.values()),
        "bytes": sum(s["bytes"] for s in shards.values()),
        "verify_ok": verify_ok,
        "out_dir": os.path.abspath(args.out),
        "shards": shards,
    }
    print(json.dumps(artifact), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
