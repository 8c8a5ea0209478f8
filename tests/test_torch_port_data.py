"""The port's episode data path against the JAX package's: sources,
sampler and loader. Episodes are numpy in both packages, so they must be
bitwise equal (``np.array_equal``) for the same seeds and indices: uint8
wire path, host-f32 path, rotation augmentation, regression. Then the
loader's contracts on the port alone: the episode-index contract and
resume alignment, the fixed val/test streams, the train salt, the
corrupt-episode replacement, an abandoned consumer stopping its worker,
and device selection.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from helpers import make_png_split_tree
from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.data import loader as jloader
from howtotrainyourmamlpytorch_tpu.data import sampler as jsampler
from howtotrainyourmamlpytorch_tpu.data import sources as jsources
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.data import (
    ArraySource, DiskImageSource, EpisodeSampler, MetaLearningDataLoader,
    SinusoidSource, SyntheticSource, build_source, split_class_names)
from howtotrainyourmamlpytorch_tpu_torch.data import loader as ploader

# Square images: rotation augmentation turns them by quarter turns.
SMALL = dict(dataset_name="synthetic_data", image_height=10,
             image_width=10, image_channels=3, num_classes_per_set=3,
             num_samples_per_class=2, num_target_samples=3, batch_size=4,
             num_evaluation_tasks=10, eval_batch_size=4)


def _configs(**kw):
    kw = {**SMALL, **kw}
    return JaxConfig(**kw), MAMLConfig(**kw)


def _stacked(sampler, indices):
    """Episodes ``indices`` of ``sampler`` stacked on a leading task axis
    by hand, as a meta-batch."""
    eps = [sampler.sample(i) for i in indices]
    return [np.stack(field) for field in zip(*eps)]


def _whole_class(src, name):
    return src.get_images_raw(name, np.arange(src.num_images(name)))


def _assert_episodes_equal(a, b):
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        assert x.dtype == np.asarray(y).dtype
        assert np.array_equal(x, np.asarray(y))


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("channels,reverse", [(3, False), (3, True),
                                              (1, False)])
def test_sampler_episodes_bitwise_equal_jax(uint8, augment, channels,
                                            reverse):
    jcfg, cfg = _configs(transfer_images_uint8=uint8,
                         augment_images=augment, image_channels=channels,
                         reverse_channels=reverse)
    src = SyntheticSource(12, 9, cfg.image_shape, seed=(0, 7))
    jsrc = jsources.SyntheticSource(12, 9, cfg.image_shape, seed=(0, 7))
    for name in src.class_names:
        assert np.array_equal(src.get_images_raw(name, np.arange(9)),
                              jsrc.get_images_raw(name, np.arange(9)))
    ours = EpisodeSampler(src, cfg, split_seed=5)
    ref = jsampler.EpisodeSampler(jsrc, jcfg, split_seed=5)
    assert ours.emit_uint8 == uint8 and len(ours.classes) == len(
        ref.classes) == 12 * (4 if augment else 1)
    for idx in (0, 1, 17, 2 ** 33 + 3):
        _assert_episodes_equal(ours.sample(idx), ref.sample(idx))
    _assert_episodes_equal(_stacked(ours, range(4, 8)),
                           ref.sample_batch(range(4, 8)))


def test_sinusoid_regression_episodes_equal_jax():
    jcfg, cfg = _configs(task_type="regression", transfer_images_uint8=False,
                         image_height=1, image_width=1, image_channels=1,
                         num_classes_per_set=1)
    ours = EpisodeSampler(build_source(cfg, "train"), cfg, 3)
    ref = jsampler.EpisodeSampler(jsources.build_source(jcfg, "train"), jcfg,
                                  3)
    assert isinstance(ours.source, SinusoidSource)
    for idx in (0, 9):
        _assert_episodes_equal(ours.sample(idx), ref.sample(idx))


@pytest.mark.parametrize("fractions", [(0.64, 0.16, 0.2), (0.5, 0.5, 0.0),
                                       (1, 1, 1), (3, 0, 1)])
@pytest.mark.parametrize("n", [5, 17, 100])
def test_split_class_names_match_jax(fractions, n):
    names = [f"c{i:03d}" for i in range(n)]
    for split in ("train", "val", "test"):
        assert split_class_names(names, fractions, split) == \
            jsources.split_class_names(names, fractions, split)


@pytest.mark.parametrize("pre_split", [True, False])
def test_disk_source_episodes_equal_jax(tmp_path, pre_split):
    rng = np.random.default_rng(0)
    classes = ("alpha", "beta", "gamma", "delta", "eps", "zeta")
    if pre_split:
        make_png_split_tree(tmp_path / "disk", {"train": classes}, rng,
                            images_per_class=5)
    else:
        make_png_split_tree(tmp_path, {"disk": classes}, rng,
                            images_per_class=5)
    jcfg, cfg = _configs(dataset_name="disk", dataset_path=str(tmp_path),
                         image_height=12, image_width=12, image_channels=1,
                         sets_are_pre_split=pre_split,
                         train_val_test_split=(0.5, 0.25, 0.25))
    src, jsrc = build_source(cfg, "train"), jsources.build_source(jcfg,
                                                                  "train")
    assert src.class_names == jsrc.class_names
    assert src.kind == jsrc.kind == "disk"
    if pre_split:
        assert isinstance(src, DiskImageSource)
    for name in src.class_names:
        assert np.array_equal(_whole_class(src, name),
                              jsrc.class_images(name))
    jcfg, cfg = (c.replace(num_classes_per_set=2) for c in (jcfg, cfg))
    _assert_episodes_equal(EpisodeSampler(src, cfg, 1).sample(2),
                           jsampler.EpisodeSampler(jsrc, jcfg, 1).sample(2))


def test_synthetic_fallback_equals_jax_and_packed_shard_raises(tmp_path):
    """The synthetic fallback equals the JAX package's; a truncated
    ``b"MAMLPACK1"`` file where a shard belongs is handled as in JAX:
    quarantined to ``*.corrupt`` with a warning, and resolution falls
    back. (The name predates the port's shard reader, when such a file
    raised.)"""
    jcfg, cfg = _configs(dataset_name="mini_imagenet_full_size",
                         dataset_path=str(tmp_path / "absent"))
    with pytest.warns(UserWarning, match="synthetic"):
        src = build_source(cfg, "val")
    with pytest.warns(UserWarning, match="synthetic"):
        jsrc = jsources.build_source(jcfg, "val")
    assert isinstance(src, SyntheticSource) and src.kind == "synthetic"
    assert src.class_names == jsrc.class_names
    for name in src.class_names[:3]:
        assert np.array_equal(_whole_class(src, name),
                              jsrc.class_images(name))
    (tmp_path / "pack").mkdir()
    shard = tmp_path / "pack" / "val.mamlpack"
    shard.write_bytes(b"MAMLPACK1")
    packed = cfg.replace(dataset_pack_path=str(tmp_path / "pack"))
    with pytest.warns(UserWarning, match="quarantined"):
        src = build_source(packed, "val")
    assert not shard.exists()
    assert (tmp_path / "pack" / "val.mamlpack.corrupt").read_bytes() == (
        b"MAMLPACK1")
    assert isinstance(src, SyntheticSource)
    assert src.class_names == jsrc.class_names


def test_array_source_validates_like_jax():
    for bad in ({}, {"a": np.zeros((2, 3, 3), np.uint8)},
                {"a": np.zeros((2, 3, 3, 1), np.float32)}):
        with pytest.raises(ValueError):
            ArraySource(bad)
        with pytest.raises(ValueError):
            jsources.ArraySource(bad)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def _loaders(**kw):
    jcfg, cfg = _configs(**kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (jloader.MetaLearningDataLoader(jcfg),
                MetaLearningDataLoader(cfg, device="cpu"))


def test_loader_train_batches_equal_jax_and_index_contract():
    jl, pl = _loaders()
    ours = list(pl.get_train_batches(0, 3))
    ref = list(jl.get_train_batches(0, 3))
    assert len(ours) == 3
    for a, b in zip(ours, ref):
        _assert_episodes_equal(a, b)
        assert all(t.device.type == "cpu" for t in a)
    # Train batch i is episodes [i*B, (i+1)*B) of the train stream.
    sampler = pl.sampler("train")
    _assert_episodes_equal(ours[2], _stacked(sampler, range(8, 12)))
    # Resuming at iteration 2 reproduces the uninterrupted run's batch.
    (resumed,) = list(pl.get_train_batches(2, 1))
    _assert_episodes_equal(resumed, [t.numpy() for t in ours[2]])


def test_loader_train_salt_matches_jax():
    jl, pl = _loaders()
    jl.set_train_salt(2)
    pl.set_train_salt(2)
    (a,) = list(pl.get_train_batches(1, 1))
    (b,) = list(jl.get_train_batches(1, 1))
    _assert_episodes_equal(a, b)
    base = 1 * 4 + 2 * ploader._REWIND_SALT_STRIDE
    _assert_episodes_equal(a, _stacked(pl.sampler("train"),
                                       range(base, base + 4)))
    (val,) = list(pl.get_val_batches())[:1]
    pl.set_train_salt(0)
    _assert_episodes_equal(val, list(pl.get_val_batches())[0])


def test_loader_fixed_val_and_test_streams():
    jl, pl = _loaders()
    val1, val2 = list(pl.get_val_batches()), list(pl.get_val_batches())
    # 10 evaluation tasks in batches of 4: 3 batches, the last one padded.
    assert len(val1) == 3 and val1[0].support_x.shape[0] == 4
    for a, b, c in zip(val1, val2, jl.get_val_batches()):
        _assert_episodes_equal(a, b)
        _assert_episodes_equal(a, c)
    test = list(pl.get_test_batches())
    for a, c in zip(test, jl.get_test_batches()):
        _assert_episodes_equal(a, c)
    assert not np.array_equal(test[0].support_x.numpy(),
                              val1[0].support_x.numpy())
    assert pl.sampler("test").split_seed == pl.sampler("val").split_seed \
        + 104729


def test_loader_replaces_corrupt_episodes_deterministically():
    _, pl = _loaders()
    sampler = pl.sampler("train")
    orig = sampler.sample

    def flaky(idx):
        if idx == 5:
            raise OSError("unreadable image")
        return orig(idx)

    sampler.sample = flaky
    with pytest.warns(UserWarning, match="corrupt"):
        (batch,) = list(pl.get_train_batches(1, 1))
    want = orig(5 + ploader._REPLACEMENT_STRIDE)
    for got, w in zip(batch, want):
        assert np.array_equal(got[1].numpy(), w)
    sampler.sample = lambda idx: (_ for _ in ()).throw(OSError("broken"))
    with pytest.raises(OSError, match="broken"):
        list(pl.get_train_batches(0, 1))


def test_loader_abandoned_consumer_stops_worker():
    _, pl = _loaders(prefetch_batches=2)
    sampler = pl.sampler("train")
    calls = []
    orig = sampler.sample
    sampler.sample = lambda idx: calls.append(idx) or orig(idx)
    before = {t.ident for t in threading.enumerate()}
    gen = pl.get_train_batches(0, 500)
    next(gen)
    gen.close()
    time.sleep(0.3)
    n_after_close = len(calls)
    time.sleep(0.3)
    assert len(calls) == n_after_close < 500 * 4
    after = {t.ident for t in threading.enumerate()}
    assert after <= before


def test_loader_device_selection():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    _, cfg = _configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MetaLearningDataLoader(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MetaLearningDataLoader(cfg, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MetaLearningDataLoader(cfg.replace(elastic_pad_tasks=4),
                               device="cpu")
