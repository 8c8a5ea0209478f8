"""Checkpoint-directory administration of the PyTorch/CUDA port: list /
verify / gc / publish / rollback against a run's ``saved_models``
directory (the port's counterpart of ``scripts/ckpt_admin.py``, over the
port's ``ckpt/``; the same subcommands, last lines and exit codes).

Usage:
    python scripts/torch_ckpt_admin.py list     <dir>
    python scripts/torch_ckpt_admin.py verify   <dir>
    python scripts/torch_ckpt_admin.py gc       <dir> [--max-to-keep K] [--dry-run]
    python scripts/torch_ckpt_admin.py publish  <dir> --tag TAG
    python scripts/torch_ckpt_admin.py rollback <dir> --version V [--reason TEXT]

* ``list`` — the manifest's records (tag, status, iter, bytes, val acc)
  and the model registry's versions, human table + JSON artifact.
* ``verify`` — full-read CRC32 + length check of every COMMITTED
  manifest record against its file (``ckpt/manifest.py § verify_record``).
  Exit 1 if anything fails.
* ``gc`` — sweep ``*.tmp`` leftovers, ``*.corrupt`` quarantine files,
  pending records from a killed writer, records whose files are gone,
  and committed epoch checkpoints outside the top ``--max-to-keep`` by
  val accuracy (``latest`` is never pruned). ``--dry-run`` reports only.
* ``publish`` — register a COMMITTED manifest entry as a servable
  version in ``REGISTRY.json``.
* ``rollback`` — withdraw a published version (status ``rolled_back``);
  polling engines fall back to the newest remaining live version.

The LAST stdout line is the JSON artifact — ``{"metric": "ckpt_admin",
"command": ..., "ok": ...}`` plus per-command keys. Exit 0 iff ok.

Imports neither JAX nor torch: the port's ``ckpt/manifest.py`` and
``ckpt/registry.py`` are stdlib-only, and the port's package ``__init__``
imports only its config.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.ckpt import (  # noqa: E402
    manifest as _manifest, registry as _registry)


def resolve_dir(path: str) -> str:
    """Accept the saved_models dir itself or an experiment dir
    containing one."""
    candidate = os.path.join(path, "saved_models")
    if (not os.path.isfile(os.path.join(path, _manifest.MANIFEST_FILE))
            and os.path.isdir(candidate)):
        return candidate
    return path


def cmd_list(directory: str, args) -> dict:
    man = _manifest.Manifest(directory)
    reg = _registry.ModelRegistry(directory)
    rows = sorted(man.records.values(),
                  key=lambda r: int(r.get("iter") or 0))
    print(f"{'tag':>8}  {'status':<10}{'iter':>8}{'bytes':>12}"
          f"  val_acc")
    for rec in rows:
        acc = rec.get("val_acc")
        print(f"{rec['tag']:>8}  {rec['status']:<10}"
              f"{rec.get('iter') or 0:>8}{rec.get('bytes') or 0:>12}"
              f"  {'-' if acc is None else f'{acc:.4f}'}")
    for v in reg.versions:
        print(f"registry v{v['version']}: tag {v['tag']} "
              f"({v['status']}) val_acc "
              f"{'-' if v.get('val_acc') is None else v['val_acc']}")
    latest = reg.latest()
    return {"ok": True, "records": len(man.records),
            "committed": len(man.committed()),
            "pending": len(man.pending()),
            "versions": len(reg.versions),
            "live_version": (latest["version"] if latest else None)}


def cmd_verify(directory: str, args) -> dict:
    man = _manifest.Manifest(directory)
    bad = []
    checked = 0
    for tag, rec in sorted(man.records.items()):
        if rec.get("status") != _manifest.COMMITTED:
            continue  # pending records are GC's problem, not verify's
        checked += 1
        res = _manifest.verify_record(directory, rec)
        print(f"{tag}: {'OK' if res['ok'] else 'BAD — ' + res['reason']}")
        if not res["ok"]:
            bad.append({"tag": tag, "reason": res["reason"]})
    if not man.loaded:
        print("no readable MANIFEST.json (pre-manifest directory?)")
    return {"ok": not bad, "verified": checked, "bad": bad,
            "manifest_present": man.loaded}


def cmd_gc(directory: str, args) -> dict:
    man = _manifest.Manifest(directory)
    # Retention: top --max-to-keep committed EPOCH records by val acc
    # (ties to the newer epoch), mirroring CheckpointManager._prune.
    epochs = [r for r in man.committed()
              if str(r["tag"]).isdigit()]
    epochs.sort(key=lambda r: (float(r.get("val_acc") or 0.0),
                               int(r["tag"])), reverse=True)
    keep = [r["tag"] for r in epochs[:args.max_to_keep]]
    swept = _manifest.sweep(man, keep_tags=keep, remove_corrupt=True,
                            dry_run=args.dry_run)
    verb = "would delete" if args.dry_run else "deleted"
    print(f"{verb}: {swept['deleted_files'] or 'nothing'}")
    print(f"{'would drop' if args.dry_run else 'dropped'} records: "
          f"{swept['dropped_records'] or 'none'}")
    return {"ok": True, "deleted_files": len(swept["deleted_files"]),
            "dropped_records": len(swept["dropped_records"]),
            "kept_tags": keep, "dry_run": bool(args.dry_run)}


def cmd_publish(directory: str, args) -> dict:
    man = _manifest.Manifest(directory)
    rec = man.get(args.tag)
    if rec is None or rec.get("status") != _manifest.COMMITTED:
        print(f"tag {args.tag!r} has no COMMITTED manifest record "
              f"(status: {rec and rec.get('status')})")
        return {"ok": False, "tag": args.tag,
                "error": "not a committed manifest entry"}
    check = _manifest.verify_record(directory, rec)
    if not check["ok"]:
        print(f"refusing to publish {args.tag!r}: {check['reason']}")
        return {"ok": False, "tag": args.tag,
                "error": f"verify failed: {check['reason']}"}
    reg = _registry.ModelRegistry(directory)
    path = os.path.join(directory, rec["file"])
    version = reg.publish(
        tag=rec["tag"], epoch=rec.get("epoch"),
        iteration=int(rec.get("iter") or 0), val_acc=rec.get("val_acc"),
        fingerprint=_manifest.file_fingerprint(path))
    print(f"published tag {rec['tag']} as version "
          f"{version['version']}")
    return {"ok": True, "tag": rec["tag"],
            "version": version["version"]}


def cmd_rollback(directory: str, args) -> dict:
    reg = _registry.ModelRegistry(directory)
    try:
        rec = reg.rollback(args.version, reason=args.reason)
    except KeyError as e:
        print(str(e))
        return {"ok": False, "version": args.version,
                "error": "unknown version"}
    latest = reg.latest()
    print(f"rolled back version {rec['version']} (tag {rec['tag']}); "
          f"live is now "
          f"{'v%d' % latest['version'] if latest else 'NOTHING'}")
    return {"ok": True, "version": rec["version"],
            "live_version": (latest["version"] if latest else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Administer a run's checkpoint directory (manifest "
                    "+ model registry).")
    sub = ap.add_subparsers(dest="command", required=True)
    for name in ("list", "verify", "gc", "publish", "rollback"):
        p = sub.add_parser(name)
        p.add_argument("directory",
                       help="saved_models dir (or an experiment dir "
                            "containing one)")
        if name == "gc":
            p.add_argument("--max-to-keep", type=int, default=5,
                           help="retention: committed epoch checkpoints "
                                "kept, top-k by val accuracy "
                                "(default 5, the MAMLConfig default)")
            p.add_argument("--dry-run", action="store_true",
                           help="report what would be removed, touch "
                                "nothing")
        elif name == "publish":
            p.add_argument("--tag", required=True,
                           help="manifest tag to publish (an epoch "
                                "number or 'latest')")
        elif name == "rollback":
            p.add_argument("--version", type=int, required=True)
            p.add_argument("--reason", default="operator rollback")
    args = ap.parse_args(argv)

    directory = resolve_dir(args.directory)
    if not os.path.isdir(directory):
        print(json.dumps({"metric": "ckpt_admin",
                          "command": args.command, "ok": False,
                          "error": f"no such directory: {directory}"}))
        return 1
    try:
        result = {"list": cmd_list, "verify": cmd_verify, "gc": cmd_gc,
                  "publish": cmd_publish,
                  "rollback": cmd_rollback}[args.command](directory, args)
    except (OSError, ValueError) as e:
        result = {"ok": False, "error": f"{type(e).__name__}: {e}"}

    # The LAST stdout line is the machine-readable artifact (the
    # bench.py / dataset_pack.py contract).
    print(json.dumps({"metric": "ckpt_admin", "command": args.command,
                      "directory": directory, **result}), flush=True)
    return 0 if result.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
