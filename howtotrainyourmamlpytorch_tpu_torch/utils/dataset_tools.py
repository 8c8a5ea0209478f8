"""Dataset provisioning before training (the port's copy of the JAX
package's ``utils/dataset_tools.py § maybe_unzip_dataset``, without a
fetcher).

If ``cfg.dataset_dir`` holds no split directories, extract
``<dataset_path>.zip`` (or ``<parent>/<dataset_name>.zip``), zip-slip
safe. With no zip, the data layer's synthetic fallback applies. The port
downloads nothing: ``download_datasets=True`` raises.
"""

from __future__ import annotations

import os
import zipfile

from howtotrainyourmamlpytorch_tpu_torch.data.sources import SPLITS


def dataset_dir_is_ready(dataset_path: str) -> bool:
    """A dataset directory is usable when it holds at least one split
    subdirectory (the reference's ``{train,val,test}/<class>/...``)."""
    if not os.path.isdir(dataset_path):
        return False
    return any(os.path.isdir(os.path.join(dataset_path, s)) for s in SPLITS)


def _safe_extract(zip_path: str, dest_dir: str) -> None:
    """Extract ``zip_path`` under ``dest_dir``, rejecting members that would
    escape it (zip-slip)."""
    dest_real = os.path.realpath(dest_dir)
    with zipfile.ZipFile(zip_path) as zf:
        for member in zf.infolist():
            target = os.path.realpath(os.path.join(dest_dir, member.filename))
            if not (target == dest_real
                    or target.startswith(dest_real + os.sep)):
                raise ValueError(
                    f"zip member {member.filename!r} escapes {dest_dir!r}")
        zf.extractall(dest_dir)


def maybe_unzip_dataset(cfg, require: bool = False) -> bool:
    """Ensure ``cfg.dataset_dir`` is populated from a local zip if one is
    there; True when the directory is ready, False when the data layer
    will fall back to a synthetic source, unless ``require``, which
    raises ``FileNotFoundError`` with the provisioning instructions
    instead."""
    if cfg.download_datasets:
        raise NotImplementedError(
            "download_datasets=True: the port has no dataset fetcher "
            "(ROADMAP.md, Queue 1: dataset fetcher); place the packaged "
            "zip or the extracted splits under dataset_path")
    path = cfg.dataset_dir
    if dataset_dir_is_ready(path):
        return True
    stem = path.rstrip("/\\")
    candidates = list(dict.fromkeys([
        stem + ".zip",
        os.path.join(os.path.dirname(stem) or ".", cfg.dataset_name + ".zip"),
    ]))
    zip_path = next((c for c in candidates if os.path.isfile(c)), None)
    if zip_path is None and require:
        raise FileNotFoundError(
            f"dataset {cfg.dataset_name!r} not found: no directory at "
            f"{path!r}, no zip at {candidates}, and the port has no "
            f"fetcher. Place the packaged zip at "
            f"{candidates[0]!r} or the extracted splits under {path!r}.")
    if zip_path is None:
        return False
    # Zips may nest everything under a top-level <dataset_name>/ dir or
    # hold the split dirs at the root.
    parent = os.path.dirname(stem) or "."
    with zipfile.ZipFile(zip_path) as zf:
        top = {n.split("/", 1)[0] for n in zf.namelist() if n.strip("/")}
    _safe_extract(zip_path, parent if os.path.basename(stem) in top
                  else path)
    if dataset_dir_is_ready(path):
        return True
    raise ValueError(f"extracted {zip_path!r} but {path!r} still has no "
                     f"train/val/test split directories")
