"""Checkpoints with the reference's retention policy, in the JAX package's
file format (the port's counterpart of its ``utils/checkpoint.py §
CheckpointManager``): a checkpoint either package writes, the other
reads.

* A file is ``MAMLCKP1 ‖ crc32(payload) LE4 ‖ len(payload) LE8 ‖
  payload``; the payload is flax msgpack (``utils/msgpack.py``) of the
  state dict of the JAX package's ``MetaTrainState``: ``params``, ``lslr``,
  ``bn_state``, ``opt_state`` = optax's ``{"0": {"count", "mu", "nu"},
  "1": {"count"}}`` and a 0-d int32 ``step``, every weight and Adam moment
  in the JAX layout (HWIO convs, ``(in, out)`` linears; ``convert.py``).
  A CRC or length mismatch raises :class:`CorruptCheckpointError`.
* ``train_model_<epoch>.ckpt`` per epoch and ``train_model_latest.ckpt``
  as a hard link to the newest (a second write where the filesystem has
  no hard links); the top ``max_to_keep`` epochs by validation accuracy
  are kept (the ensemble test's members); ``state.json`` holds the
  iteration/epoch/val-accuracy bookkeeping.
* Every write fsyncs before its atomic rename and moves a
  ``MANIFEST.json`` record pending → committed (``ckpt/manifest.py``);
  resume prefers committed records and quarantines damaged files
  (``*.corrupt``) so they are paid for once; the writer's constructor
  sweeps ``*.tmp`` leftovers and pending records of a killed writer.

The fault-injection hooks and registry counters of the JAX package wait
for the resilience/ckpt and telemetry slices (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import os
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

from howtotrainyourmamlpytorch_tpu_torch.ckpt import manifest as manifest_mod
from howtotrainyourmamlpytorch_tpu_torch.convert import (STATE_FIELDS,
                                                         from_state_dict,
                                                         state_to_jax,
                                                         to_state_dict)
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import MetaTrainState
from howtotrainyourmamlpytorch_tpu_torch.resilience import counter_inc
from howtotrainyourmamlpytorch_tpu_torch.resilience.retry import retry_io
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves
from howtotrainyourmamlpytorch_tpu_torch.utils import msgpack
from howtotrainyourmamlpytorch_tpu_torch.utils.storage import (
    load_from_json, save_to_json)

LATEST = "latest"

# Framed checkpoint layout: magic ‖ crc32(payload) ‖ len(payload) ‖ payload.
# Files without the magic are pre-framing checkpoints and load as raw
# payload (no CRC coverage).
_MAGIC = manifest_mod.CKPT_MAGIC
_HEADER_LEN = len(_MAGIC) + 4 + 8


class CorruptCheckpointError(RuntimeError):
    """Framed checkpoint whose payload fails its CRC/length check."""


def frame_payload(payload: bytes) -> bytes:
    return (_MAGIC + zlib.crc32(payload).to_bytes(4, "little")
            + len(payload).to_bytes(8, "little") + payload)


def unframe_payload(blob: bytes, path: str) -> bytes:
    if not blob.startswith(_MAGIC):
        return blob  # pre-framing checkpoint: raw msgpack payload
    crc = int.from_bytes(blob[len(_MAGIC):len(_MAGIC) + 4], "little")
    n = int.from_bytes(blob[len(_MAGIC) + 4:_HEADER_LEN], "little")
    payload = blob[_HEADER_LEN:]
    if len(payload) != n:
        raise CorruptCheckpointError(
            f"{path}: payload length {len(payload)} != header {n} "
            f"(truncated write or partial copy)")
    if zlib.crc32(payload) != crc:
        raise CorruptCheckpointError(
            f"{path}: payload CRC mismatch (bit-rot or concurrent "
            f"overwrite)")
    return payload


def _restore(template: Any, loaded: Any, path: str = "") -> Any:
    """``loaded`` in ``template``'s structure, matched by key name as
    ``flax.serialization.from_bytes`` matches it: a missing or an extra
    key raises. Leaf shapes are not checked here
    (``meta/outer.py § reconcile_loaded_shapes`` does that)."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            raise ValueError(f"checkpoint has a leaf at {path or '/'} where "
                             f"the template state has a subtree")
        missing = sorted(set(template) - set(loaded))
        extra = sorted(set(loaded) - set(template))
        if missing or extra:
            raise ValueError(
                f"checkpoint keys at {path or '/'} do not match the "
                f"template state: missing {missing}, extra {extra}")
        return {k: _restore(v, loaded[k], f"{path}/{k}")
                for k, v in template.items()}
    if isinstance(loaded, dict):
        raise ValueError(f"checkpoint has a subtree at {path} where the "
                         f"template state has a leaf")
    return loaded


def decode_state(payload: bytes, template_state: MetaTrainState
                 ) -> MetaTrainState:
    """A msgpack payload restored into ``template_state``'s structure (its
    key order included), on the template's device."""
    template = dict(zip(STATE_FIELDS, state_to_jax(template_state)))
    loaded = _restore(template, msgpack.unpackb(payload))
    device = tree_leaves(template_state.params)[0].device
    return from_state_dict(loaded, device=device)


@retry_io("checkpoint write")
def _write_bytes_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        # Durability before atomicity: without the fsync a host crash can
        # commit a zero-length or torn tmp under the valid name.
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    manifest_mod.fsync_dir(os.path.dirname(path))


@retry_io("checkpoint read")
def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


class CheckpointManager:
    """Manages ``train_model_<epoch>.ckpt`` files + ``state.json``."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 quarantine: bool = True):
        self.directory = directory
        self.max_to_keep = max_to_keep
        # Whether this process writes the directory: it may rename damaged
        # files during fallback and sweeps a killed writer's leftovers. A
        # read-only consumer passes False and only skips.
        self.quarantine = quarantine
        os.makedirs(directory, exist_ok=True)
        self._meta_path = os.path.join(directory, "state.json")
        self.manifest = manifest_mod.Manifest(directory)
        if quarantine:
            self._sweep_stale()
        # Whether bookkeeping came from disk: a checkpoint FILE without
        # state.json (partial copy) must not be silently resumed with
        # default meta.
        self.meta_from_disk = os.path.isfile(self._meta_path)
        if self.meta_from_disk:
            self.meta: Dict[str, Any] = load_from_json(self._meta_path)
            self.meta.setdefault("iter_at_epoch", {})
            self.meta.setdefault("rewinds", 0)
        else:
            self.meta = {"current_iter": 0, "current_epoch": 0,
                         "val_acc_per_epoch": {}, "iter_at_epoch": {},
                         "best_val_acc": 0.0, "best_val_epoch": -1,
                         "rewinds": 0}

    def _sweep_stale(self) -> None:
        """GC a killed writer's ``*.tmp`` files and pending manifest
        records (``*.corrupt`` quarantine leftovers stay for forensics)."""
        swept = manifest_mod.sweep(self.manifest)
        n = len(swept["deleted_files"]) + len(swept["dropped_records"])
        if n:
            counter_inc("ckpt/gc_deletes", n)
            warnings.warn(
                f"checkpoint GC swept {swept['deleted_files']} and "
                f"pending record(s) {swept['dropped_records']} (a "
                f"previous writer died mid-save)", stacklevel=3)

    # -- paths ----------------------------------------------------------
    def path(self, tag) -> str:
        return os.path.join(self.directory, f"train_model_{tag}.ckpt")

    # -- save -----------------------------------------------------------
    def encode(self, state: MetaTrainState) -> bytes:
        """Host snapshot: fetch + msgpack + MAMLCKP1 framing."""
        return frame_payload(msgpack.packb(to_state_dict(state)))

    def record_save(self, epoch: int, current_iter: int,
                    val_acc: float) -> None:
        """Bookkeeping half of an epoch save (no IO)."""
        self.meta["current_iter"] = int(current_iter)
        self.meta["current_epoch"] = int(epoch)
        self.meta["val_acc_per_epoch"][str(epoch)] = float(val_acc)
        self.meta["iter_at_epoch"][str(epoch)] = int(current_iter)
        if val_acc >= self.meta["best_val_acc"]:
            self.meta["best_val_acc"] = float(val_acc)
            self.meta["best_val_epoch"] = int(epoch)

    def write_epoch_files(self, data: bytes, epoch: int,
                          current_iter: int, val_acc: float) -> None:
        """File half of an epoch save: the epoch checkpoint (manifest
        pending → committed), the 'latest' link, retention pruning and
        ``state.json``. Only the epoch tag's ``begin`` is flushed before
        the write; the commits, the latest record and the prune batch into
        one durable manifest rewrite at the end."""
        crc = zlib.crc32(data)
        epoch_path = self.path(epoch)
        self.manifest.begin(str(int(epoch)), epoch=int(epoch),
                            iteration=int(current_iter),
                            val_acc=float(val_acc))
        _write_bytes_atomic(epoch_path, data)
        self.manifest.commit(str(int(epoch)), nbytes=len(data), crc=crc,
                             flush=False)
        # 'latest' is a hard link to the epoch file (atomic via tmp link +
        # rename): one full write per save instead of two.
        self.manifest.begin(LATEST, epoch=int(epoch),
                            iteration=int(current_iter),
                            val_acc=float(val_acc), flush=False)
        latest_tmp = self.path(LATEST) + ".tmp"
        if os.path.exists(latest_tmp):
            os.remove(latest_tmp)
        try:
            os.link(epoch_path, latest_tmp)
        except OSError:
            with open(latest_tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
        os.replace(latest_tmp, self.path(LATEST))
        manifest_mod.fsync_dir(self.directory)
        self.manifest.commit(LATEST, nbytes=len(data), crc=crc, flush=False)
        self._prune(flush=False)
        self.manifest.flush()
        save_to_json(self._meta_path, self.meta)

    def save(self, state: MetaTrainState, epoch: int, current_iter: int,
             val_acc: float) -> int:
        """Write the epoch checkpoint + latest, update bookkeeping, prune
        checkpoints outside the top ``max_to_keep`` by val accuracy.
        Returns the file's size in bytes."""
        data = self.encode(state)
        self.record_save(epoch, current_iter, val_acc)
        self.write_epoch_files(data, epoch, current_iter, val_acc)
        return len(data)

    def save_latest(self, state: MetaTrainState, current_iter: int) -> None:
        """Write ONLY ``train_model_latest`` + iteration bookkeeping — the
        preemption path. No epoch entry is registered: a mid-epoch
        snapshot must not enter the top-k ensemble set."""
        self.meta["current_iter"] = int(current_iter)
        data = self.encode(state)
        self.manifest.begin(LATEST, iteration=int(current_iter))
        _write_bytes_atomic(self.path(LATEST), data)
        self.manifest.commit(LATEST, nbytes=len(data),
                             crc=zlib.crc32(data))
        save_to_json(self._meta_path, self.meta)

    def _prune(self, flush: bool = True) -> None:
        keep = {int(e) for e in self.top_epochs(self.max_to_keep)}
        pruned = []
        for name in self._ckpt_files_on_disk():
            tag = name[len("train_model_"):-len(".ckpt")]
            if tag == LATEST or not tag.isdigit():
                continue
            if int(tag) not in keep:
                os.remove(os.path.join(self.directory, name))
                pruned.append(tag)
        self.manifest.remove_many(pruned, flush=flush)

    # -- load -----------------------------------------------------------
    def load(self, template_state: MetaTrainState,
             tag=LATEST) -> Tuple[MetaTrainState, Dict[str, Any]]:
        """Restore a checkpoint into the template's structure, on its
        device. Returns (state, meta); for an epoch tag, meta's
        ``current_iter`` is that epoch's iteration."""
        path = self.path(tag)
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        payload = unframe_payload(_read_bytes(path), path)
        state = decode_state(payload, template_state)
        meta = dict(self.meta)
        if tag != LATEST:
            epoch_iter = self.meta["iter_at_epoch"].get(str(int(tag)))
            if epoch_iter is not None:
                meta["current_iter"] = epoch_iter
                meta["current_epoch"] = int(tag)
        return state, meta

    def _quarantine(self, tag) -> None:
        """Move an unreadable checkpoint aside (``<file>.corrupt``) and
        drop its bookkeeping, so no later resume or ensemble re-attempts
        it. No-op without ``quarantine`` or when the file is gone."""
        if not self.quarantine:
            return
        path = self.path(tag)
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            return
        self.manifest.remove(str(tag))
        counter_inc("resilience/quarantined")
        warnings.warn(
            f"quarantined unreadable checkpoint {os.path.basename(path)} "
            f"-> {os.path.basename(path)}.corrupt", stacklevel=3)
        if tag != LATEST:
            for key in ("val_acc_per_epoch", "iter_at_epoch"):
                self.meta[key].pop(str(int(tag)), None)
            self._recompute_best()
            try:
                save_to_json(self._meta_path, self.meta)
            except OSError:
                pass  # the rename alone already prevents the re-attempt

    def load_latest_or_fallback(self, template_state: MetaTrainState):
        """Restore ``latest``; on a damaged file, fall back to the newest
        readable epoch checkpoint, quarantining each damaged one. A
        ``pending`` manifest record is skipped without a read; a committed
        record whose size disagrees with the file is quarantined after
        one ``getsize``. If nothing is readable, raise (never restart a
        run silently). Returns ``(state, meta, tag)``."""
        def brief(e: Exception) -> str:
            return f"{type(e).__name__}: {str(e)[:160]}"

        def manifest_verdict(tag) -> Optional[Tuple[str, bool]]:
            """(reason, damaged) the manifest alone can prove, else None."""
            rec = self.manifest.get(str(tag))
            if rec is None:
                return None
            if rec.get("status") != manifest_mod.COMMITTED:
                return ("manifest records an uncommitted (pending) "
                        "write", False)
            try:
                size = os.path.getsize(self.path(tag))
            except OSError:
                return None  # missing file: the load attempt reports it
            if size != int(rec.get("bytes") or 0):
                return (f"size {size} != manifest-committed "
                        f"{rec.get('bytes')} bytes", True)
            return None

        def attempt(tag):
            verdict = manifest_verdict(tag)
            if verdict is not None:
                failures.append((tag, verdict[0]))
                if verdict[1]:
                    self._quarantine(tag)
                return None
            try:
                return self.load(template_state, tag)
            except Exception as e:  # missing file or damaged bytes
                failures.append((tag, brief(e)))
                if not isinstance(e, FileNotFoundError):
                    self._quarantine(tag)
                return None

        failures: List[Tuple[Any, str]] = []
        if not self.meta_from_disk:
            # Weights without bookkeeping are not resumable.
            failures.append((LATEST, "state.json missing — resume "
                                     "iteration unknown"))
        else:
            got = attempt(LATEST)
            if got is not None:
                return got[0], got[1], LATEST
        epochs = sorted(
            (int(e) for e in self.meta["iter_at_epoch"]
             if self.has_checkpoint(int(e))),
            key=lambda e: self.meta["iter_at_epoch"][str(e)], reverse=True)
        for epoch in epochs:
            got = attempt(epoch)
            if got is not None:
                warnings.warn(
                    f"checkpoint 'latest' unreadable ({failures[0][1]}); "
                    f"resuming from epoch {epoch} checkpoint instead",
                    stacklevel=2)
                return got[0], got[1], epoch
        bookkept = {f"train_model_{int(e)}.ckpt"
                    for e in self.meta["iter_at_epoch"]}
        bookkept.add(f"train_model_{LATEST}.ckpt")
        for name in sorted(set(self._ckpt_files_on_disk()) - bookkept):
            failures.append((name, "no iteration bookkeeping for this "
                                   "file (state.json missing or damaged)"))
        raise RuntimeError("no readable checkpoint: " + "; ".join(
            f"{tag}: {err}" for tag, err in failures))

    def rewind_to(self, epoch: int) -> None:
        """Discard bookkeeping newer than ``epoch`` (a resume from an
        epoch, or a divergence rewind): later epochs' val accuracies must
        not feed the top-k ensemble once retraining overwrites them."""
        epoch = int(epoch)
        if str(epoch) not in self.meta["iter_at_epoch"]:
            raise KeyError(f"no bookkeeping for epoch {epoch}")
        for key in ("val_acc_per_epoch", "iter_at_epoch"):
            self.meta[key] = {e: v for e, v in self.meta[key].items()
                              if int(e) <= epoch}
        self.meta["current_iter"] = self.meta["iter_at_epoch"][str(epoch)]
        self.meta["current_epoch"] = epoch
        self._recompute_best()
        save_to_json(self._meta_path, self.meta)

    def _recompute_best(self) -> None:
        kept = self.meta["val_acc_per_epoch"]
        if kept:
            best = max(kept.items(), key=lambda kv: (kv[1], int(kv[0])))
            self.meta["best_val_acc"] = best[1]
            self.meta["best_val_epoch"] = int(best[0])
        else:
            self.meta["best_val_acc"] = 0.0
            self.meta["best_val_epoch"] = -1

    # -- queries ---------------------------------------------------------
    def top_epochs(self, k: Optional[int] = None) -> List[int]:
        """Epochs sorted by val accuracy, best first (the ensemble set)."""
        k = k if k is not None else self.max_to_keep
        items = sorted(self.meta["val_acc_per_epoch"].items(),
                       key=lambda kv: (-kv[1], -int(kv[0])))
        return [int(e) for e, _ in items[:k]]

    def has_checkpoint(self, tag=LATEST) -> bool:
        return os.path.isfile(self.path(tag))

    def _ckpt_files_on_disk(self) -> List[str]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return [n for n in names
                if n.startswith("train_model_") and n.endswith(".ckpt")]

    def fingerprint(self, tag=LATEST) -> int:
        """Cheap content fingerprint (``ckpt/manifest.py §
        file_fingerprint``); -1 = unreadable."""
        return manifest_mod.file_fingerprint(self.path(tag))

    def has_any_checkpoint(self) -> bool:
        """Any checkpoint FILE at all — a disk scan, not the bookkeeping
        (which can itself be part of the damage)."""
        return bool(self._ckpt_files_on_disk())
