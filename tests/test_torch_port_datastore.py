"""Packed shards (MAMLPACK1) in the port, on the CPU: the port's
``datastore/`` and ``build_source``'s shard preference, held to the JAX
package's ``tests/test_datastore.py`` contract, and across the two
packages.

* Round trips: a shard of an ``ArraySource`` or a PNG directory gives
  back its classes bitwise, and its episodes equal the directory
  source's.
* Integrity: a truncated shard, a bit-flipped header and a wrong magic
  raise ``CorruptShardError`` at open; a bit-flipped image block passes
  the O(header) open and is caught by ``verify``.
* Resolution: a shard next to the split dirs (or under
  ``dataset_pack_path``) wins without a PIL decode and counts
  ``data/pack_open_seconds``, ``data/pack_bytes_mapped`` and
  ``data/source_kind/packed``; a corrupt one is quarantined to
  ``*.corrupt`` (``resilience/quarantined``) and resolution falls back;
  a geometry mismatch is skipped and left in place; the loader's resume
  alignment holds on a packed source.
* ``scripts/torch_dataset_pack.py``: the artifact schema, ``--config``,
  the error artifact, explicit flags over the config.
* Across packages: the two writers' shards are byte-identical; a
  JAX-written shard feeds the port's sampler the JAX sampler's episodes
  bitwise; a short CPU training trajectory on a pack equals the one on
  its directory source, bitwise.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from helpers import make_png_split_tree
from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.data import sampler as jsampler
from howtotrainyourmamlpytorch_tpu.datastore import (
    PackedSource as JaxPackedSource, write_shard as jax_write_shard)
from howtotrainyourmamlpytorch_tpu_torch import resilience
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.data import (
    ArraySource, DiskImageSource, EpisodeSampler, MetaLearningDataLoader,
    build_source, pack_shard_path, source_kind)
from howtotrainyourmamlpytorch_tpu_torch.datastore import (
    CorruptShardError, PackedSource, read_header, write_shard)
from howtotrainyourmamlpytorch_tpu_torch.meta import outer
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.telemetry import MetricsRegistry
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = os.path.join(REPO, "scripts", "torch_dataset_pack.py")

SMALL = dict(dataset_name="pack_test", image_height=12, image_width=12,
             image_channels=1, num_classes_per_set=5,
             num_samples_per_class=2, num_target_samples=3, batch_size=4,
             num_evaluation_tasks=10)
CFG = MAMLConfig(**SMALL)


def _array_classes(num_classes=8, images_per_class=6, shape=(12, 12, 1),
                   seed=0):
    rng = np.random.default_rng(seed)
    return {f"class_{i:03d}": rng.integers(
                0, 256, (images_per_class,) + shape, dtype=np.uint8)
            for i in range(num_classes)}


def _pack_from_source(path, source, writer=write_shard, provenance=None):
    return writer(str(path),
                  ((n, source.class_images(n)) for n in source.class_names),
                  provenance=provenance)


def _png_dataset(tmp_path, splits=("train",), classes=8,
                 images_per_class=6):
    rng = np.random.default_rng(7)
    root = tmp_path / CFG.dataset_name
    make_png_split_tree(root, {s: classes for s in splits}, rng,
                        images_per_class=images_per_class)
    return root


def _packed_dataset(tmp_path):
    """A PNG tree with its train shard next to the split dirs."""
    root = _png_dataset(tmp_path)
    cfg = CFG.replace(dataset_path=str(tmp_path))
    _pack_from_source(pack_shard_path(cfg, "train"),
                      DiskImageSource(str(root / "train"), cfg.image_shape))
    return root, cfg


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    prev = resilience.set_registry(reg)
    yield reg
    resilience.set_registry(prev)


# ---------------------------------------------------------------------------
# format + PackedSource round trip
# ---------------------------------------------------------------------------

def test_pack_roundtrip_arraysource_bitwise(tmp_path):
    src = ArraySource(_array_classes())
    path = tmp_path / "train.mamlpack"
    header = _pack_from_source(path, src)
    assert header["total_images"] == 8 * 6
    packed = PackedSource(str(path))
    assert packed.class_names == src.class_names
    rng = np.random.default_rng(1)
    for name in src.class_names:
        assert packed.num_images(name) == src.num_images(name)
        idx = rng.choice(6, size=4, replace=True)
        np.testing.assert_array_equal(packed.get_images_raw(name, idx),
                                      src.get_images_raw(name, idx))
        np.testing.assert_array_equal(packed.get_images(name, idx),
                                      src.get_images(name, idx))
    assert packed.verify()
    assert packed.nbytes_mapped == 8 * 6 * 12 * 12


def test_pack_roundtrip_disksource_and_episode_parity(tmp_path):
    root = _png_dataset(tmp_path)
    disk = DiskImageSource(str(root / "train"), CFG.image_shape)
    path = tmp_path / "train.mamlpack"
    _pack_from_source(path, disk)
    packed = PackedSource(str(path), expected_image_shape=CFG.image_shape)
    assert packed.class_names == disk.class_names
    for name in disk.class_names:
        np.testing.assert_array_equal(packed.class_images(name),
                                      disk.class_images(name))
    s_disk, s_pack = EpisodeSampler(disk, CFG, 0), EpisodeSampler(packed,
                                                                  CFG, 0)
    for idx in (0, 3, 17, 104729):
        for x, y in zip(s_disk.sample(idx), s_pack.sample(idx)):
            np.testing.assert_array_equal(x, y)


def test_write_shard_rejects_bad_classes(tmp_path):
    path = str(tmp_path / "bad.mamlpack")
    with pytest.raises(ValueError, match="uint8"):
        write_shard(path, [("a", np.zeros((2, 4, 4, 1), np.float32))])
    with pytest.raises(ValueError, match="zero images"):
        write_shard(path, [("a", np.zeros((0, 4, 4, 1), np.uint8))])
    with pytest.raises(ValueError, match="geometry"):
        write_shard(path, [("a", np.zeros((2, 4, 4, 1), np.uint8)),
                           ("b", np.zeros((2, 5, 4, 1), np.uint8))])
    with pytest.raises(ValueError, match="at least one class"):
        write_shard(path, [])
    assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# integrity
# ---------------------------------------------------------------------------

def test_truncated_shard_raises(tmp_path):
    path = tmp_path / "t.mamlpack"
    _pack_from_source(path, ArraySource(_array_classes()))
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 100)
    with pytest.raises(CorruptShardError, match="truncated"):
        PackedSource(str(path))
    with open(path, "r+b") as f:
        f.truncate(40)
    with pytest.raises(CorruptShardError):
        PackedSource(str(path))


def test_bitflipped_header_raises_at_open(tmp_path):
    path = tmp_path / "h.mamlpack"
    _pack_from_source(path, ArraySource(_array_classes()))
    _flip_byte(str(path), 30)
    with pytest.raises(CorruptShardError, match="CRC"):
        PackedSource(str(path))


def test_bitflipped_data_block_caught_by_verify(tmp_path):
    path = tmp_path / "d.mamlpack"
    _pack_from_source(path, ArraySource(_array_classes()))
    _, data_offset = read_header(str(path))
    _flip_byte(str(path), data_offset + 1000)
    packed = PackedSource(str(path))
    with pytest.raises(CorruptShardError, match="CRC mismatch"):
        packed.verify()


def test_wrong_magic_raises(tmp_path):
    path = tmp_path / "nota.mamlpack"
    path.write_bytes(b"GARBAGE FILE CONTENT")
    with pytest.raises(CorruptShardError, match="shard"):
        read_header(str(path))


# ---------------------------------------------------------------------------
# build_source: preference, quarantine, fallback
# ---------------------------------------------------------------------------

def test_build_source_prefers_pack_and_never_decodes(tmp_path, monkeypatch,
                                                     registry):
    _, cfg = _packed_dataset(tmp_path)
    import PIL.Image

    def trap(*a, **k):
        raise AssertionError("packed open path touched PIL decode")
    monkeypatch.setattr(PIL.Image, "open", trap)
    src = build_source(cfg, "train")
    assert source_kind(src) == "packed"
    assert EpisodeSampler(src, cfg, 0).sample(5).support_x.dtype == np.uint8
    snap = registry.snapshot()
    assert snap["data/pack_open_seconds"] > 0
    assert snap["data/pack_bytes_mapped"] == 8 * 6 * 12 * 12
    assert snap["data/source_kind/packed"] == 1


def test_build_source_quarantines_corrupt_pack_and_falls_back(tmp_path,
                                                              registry):
    _, cfg = _packed_dataset(tmp_path)
    pack = pack_shard_path(cfg, "train")
    _flip_byte(pack, 30)
    with pytest.warns(UserWarning, match="quarantined"):
        src = build_source(cfg, "train")
    assert source_kind(src) == "disk"
    assert os.path.isfile(pack + ".corrupt") and not os.path.exists(pack)
    snap = registry.snapshot()
    assert snap["resilience/quarantined"] == 1
    assert snap["data/source_kind/disk"] == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert source_kind(build_source(cfg, "train")) == "disk"
    assert registry.snapshot()["resilience/quarantined"] == 1


def test_build_source_skips_geometry_mismatch_without_quarantine(tmp_path):
    _, cfg = _packed_dataset(tmp_path)
    pack = pack_shard_path(cfg, "train")
    wrong = cfg.replace(image_height=16, image_width=16)
    with pytest.warns(UserWarning, match="not quarantined"):
        src = build_source(wrong, "train")
    assert source_kind(src) == "disk"
    assert os.path.isfile(pack)


def test_dataset_pack_path_config_key(tmp_path):
    root = _png_dataset(tmp_path)
    packdir = tmp_path / "packs"
    cfg = CFG.replace(dataset_path=str(tmp_path),
                      dataset_pack_path=str(packdir))
    _pack_from_source(packdir / "train.mamlpack",
                      DiskImageSource(str(root / "train"), cfg.image_shape))
    assert pack_shard_path(cfg, "train") == str(packdir / "train.mamlpack")
    assert source_kind(build_source(cfg, "train")) == "packed"
    missing = cfg.replace(dataset_pack_path=str(tmp_path / "nowhere"))
    with pytest.warns(UserWarning, match="does not exist"):
        assert source_kind(build_source(missing, "train")) == "disk"


def test_loader_resume_alignment_packed(tmp_path):
    """Batch i uses episode indices [i·B, (i+1)·B) under the pack too,
    and equals the directory source's batches bitwise."""
    _, cfg = _packed_dataset(tmp_path)
    loader = MetaLearningDataLoader(cfg, device="cpu")
    assert source_kind(loader.sampler("train").source) == "packed"
    full = list(loader.get_train_batches(0, 7))
    tail = list(MetaLearningDataLoader(cfg, device="cpu")
                .get_train_batches(5, 2))
    assert torch.equal(full[5].support_x, tail[0].support_x)
    assert torch.equal(full[6].target_x, tail[1].target_x)
    dir_loader = MetaLearningDataLoader(
        cfg.replace(dataset_pack_path=str(tmp_path / "empty")),
        device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert source_kind(dir_loader.sampler("train").source) == "disk"
    for a, b in zip(full[:3], dir_loader.get_train_batches(0, 3)):
        assert torch.equal(a.support_x, b.support_x)
        assert torch.equal(a.target_x, b.target_x)


# ---------------------------------------------------------------------------
# scripts/torch_dataset_pack.py
# ---------------------------------------------------------------------------

def _cli(*args):
    r = subprocess.run([sys.executable, CLI, *map(str, args)],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    return r, json.loads(r.stdout.strip().splitlines()[-1])


def test_pack_cli_artifact_schema(tmp_path):
    root = _png_dataset(tmp_path, splits=("train", "val"))
    r, art = _cli(root, "--height", 12, "--width", 12, "--channels", 1,
                  "--verify")
    assert r.returncode == 0, r.stderr[-2000:]
    for key in ("metric", "value", "unit", "classes", "images", "bytes",
                "verify_ok", "out_dir", "shards"):
        assert key in art, key
    assert art["metric"] == "dataset_pack"
    assert art["classes"] == 16 and art["images"] == 16 * 6
    assert art["verify_ok"] is True
    assert art["bytes"] > 16 * 6 * 12 * 12
    assert set(art["shards"]) == {"train", "val"}
    assert len(PackedSource(str(root / "train.mamlpack")).class_names) == 8
    assert not os.path.exists(root / "test.mamlpack")


def test_pack_cli_from_config(tmp_path):
    _png_dataset(tmp_path)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({
        "dataset_name": "pack_test", "dataset_path": str(tmp_path),
        "image_height": 12, "image_width": 12, "image_channels": 1}))
    r, art = _cli("--config", cfg_path, "--verify")
    assert r.returncode == 0, r.stderr[-2000:]
    assert art["verify_ok"] is True and art["classes"] == 8
    cfg = MAMLConfig.from_json_file(str(cfg_path))
    assert source_kind(build_source(cfg, "train")) == "packed"


def test_pack_cli_error_is_json_artifact(tmp_path):
    r, art = _cli(tmp_path / "missing", "--height", 12, "--width", 12,
                  "--channels", 1)
    assert r.returncode == 1
    assert art["metric"] == "dataset_pack" and "error" in art


def test_pack_cli_explicit_flags_override_config(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import torch_dataset_pack as pack
    finally:
        sys.path.pop(0)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({
        "dataset_name": "x", "dataset_path": str(tmp_path),
        "image_height": 12, "image_width": 12, "image_channels": 1,
        "sets_are_pre_split": False,
        "train_val_test_split": [0.8, 0.1, 0.1]}))
    a = pack.parse_args(["--config", str(cfg_path), "--fractions",
                         "0.5,0.25,0.25", "--class-indexes", "-2"])
    assert a.fractions == (0.5, 0.25, 0.25) and a.class_indexes == (-2,)
    b = pack.parse_args(["--config", str(cfg_path)])
    assert b.fractions == (0.8, 0.1, 0.1) and b.class_indexes == (-3, -2)
    c = pack.parse_args([str(tmp_path), "--height", "12", "--width", "12",
                         "--channels", "1"])
    assert c.fractions == (0.64, 0.16, 0.20) and c.class_indexes == (-3, -2)


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def test_shards_are_byte_identical_across_writers(tmp_path):
    classes = _array_classes(seed=4)
    src = ArraySource(classes)
    prov = {"tool": "test", "split": "train"}
    ours = _pack_from_source(tmp_path / "port.mamlpack", src,
                             provenance=prov)
    theirs = _pack_from_source(tmp_path / "jax.mamlpack", src,
                               writer=jax_write_shard, provenance=prov)
    assert ours == theirs
    assert ((tmp_path / "port.mamlpack").read_bytes()
            == (tmp_path / "jax.mamlpack").read_bytes())
    assert JaxPackedSource(str(tmp_path / "port.mamlpack")).verify() == (
        PackedSource(str(tmp_path / "jax.mamlpack")).verify())


def test_jax_written_shard_feeds_the_port_sampler_bitwise(tmp_path):
    path = tmp_path / "train.mamlpack"
    _pack_from_source(path, ArraySource(_array_classes(seed=5)),
                      writer=jax_write_shard)
    jcfg = JaxConfig(**SMALL)
    ours = EpisodeSampler(PackedSource(str(path)), CFG, 3)
    theirs = jsampler.EpisodeSampler(JaxPackedSource(str(path)), jcfg, 3)
    for idx in (0, 1, 9, 4242):
        for x, y in zip(ours.sample(idx), theirs.sample(idx)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_training_trajectory_on_pack_equals_directory(tmp_path):
    """Three port train steps on batches from the pack and from the
    directory it was packed from end in bitwise the same state."""
    root, cfg = _packed_dataset(tmp_path)
    cfg = cfg.replace(num_classes_per_set=3, num_samples_per_class=1,
                      num_target_samples=1, cnn_num_filters=4, num_stages=2,
                      number_of_training_steps_per_iter=1,
                      number_of_evaluation_steps_per_iter=1,
                      compute_dtype="float32", bn_fast_math=False,
                      bn_backend="composite")
    ends = []
    for c in (cfg, cfg.replace(dataset_pack_path=str(tmp_path / "none"))):
        loader = MetaLearningDataLoader(c, device="cpu")
        init, apply = make_model(c)
        state = outer.init_train_state(c, init, seed=0, device="cpu")
        step = outer.make_train_step(c, apply)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for batch in loader.get_train_batches(0, 3):
                state, _ = step(state, batch, 0, second_order=False,
                                use_msl=True)
        ends.append((source_kind(loader.sampler("train").source), state))
    (kind_a, a), (kind_b, b) = ends
    assert (kind_a, kind_b) == ("packed", "disk")
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves({"p": a.params, "l": a.lslr, "b": a.bn_state}),
        tree_leaves({"p": b.params, "l": b.lslr, "b": b.bn_state})))
