"""The port's backend-option channel (``device.BACKEND_OPTIONS``, carried
by the ``xla_compiler_options`` config key), on the CPU: every spelling
of an option set canonicalizes as in the JAX package; the trainer's
numerics policy applies the options over its cuDNN flags and restores
them, and says which options give up the trainer's bitwise resume (the
trainer's ``warm_start`` row carries it); an unknown option or value,
or TF32, raises with the marker before anything is set; a tuned config's warm-start store lands in
another fingerprint directory than the untuned one, and runtime-only
keys still share one (``tests/test_tune.py §
test_fingerprint_tuned_vs_untuned_and_runtime_exclusion``)."""

import os

import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu_torch import device as dev
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.parallel import aot

TINY = dict(image_height=8, image_width=8, image_channels=1,
            num_classes_per_set=2, num_samples_per_class=1,
            num_target_samples=1, batch_size=2, cnn_num_filters=4,
            num_stages=2, number_of_training_steps_per_iter=1,
            number_of_evaluation_steps_per_iter=1, second_order=False,
            use_multi_step_loss_optimization=False, total_epochs=1,
            num_evaluation_tasks=2, compute_dtype="float32")


@pytest.mark.parametrize("spelling", [
    {"cudnn_deterministic": "false", "cudnn_benchmark": "true"},
    ["cudnn_benchmark=true", "cudnn_deterministic=false"],
    "cudnn_deterministic=false, cudnn_benchmark=true"])
def test_option_spellings_canonicalize_like_jax(spelling):
    ours = MAMLConfig.from_dict({"xla_compiler_options": spelling})
    ref = JaxConfig.from_dict({"xla_compiler_options": spelling})
    assert ours.xla_compiler_options == ref.xla_compiler_options == (
        "cudnn_benchmark=true", "cudnn_deterministic=false")
    assert ours.xla_compiler_options_dict == ref.xla_compiler_options_dict
    assert dev.parse_backend_options(ours.xla_compiler_options_dict) == {
        "benchmark": True, "deterministic": False}


def _flags():
    c = torch.backends.cudnn
    return (c.deterministic, c.benchmark, c.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("options, deterministic, want", [
    (None, True, (True, False)),
    ({}, False, None),
    ({"cudnn_deterministic": "false"}, True, (False, False)),
    ({"cudnn_deterministic": "False", "cudnn_benchmark": "TRUE"}, True,
     (False, True)),
    ({"cudnn_benchmark": "true"}, False, None)])
def test_policy_applies_options_and_restores(options, deterministic, want):
    saved = _flags()
    with dev.numerics_policy("float32", deterministic=deterministic,
                             options=options):
        c = torch.backends.cudnn
        got = (c.deterministic, c.benchmark)
        if want is None:  # the trainer's flags untouched but the option's
            want = (saved[0], True if options else saved[1])
        assert got == want
        assert not c.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    assert _flags() == saved


@pytest.mark.parametrize("options, want", [
    (None, True), ({"cudnn_deterministic": "true"}, True),
    ({"cudnn_benchmark": "false"}, True),
    ({"cudnn_deterministic": "false"}, False),
    ({"cudnn_benchmark": "true"}, False)])
def test_resume_is_bitwise_only_under_deterministic_algorithms(options,
                                                               want):
    assert dev.resume_is_bitwise(options) is want


@pytest.mark.parametrize("options, want", [
    ((), True), (("cudnn_deterministic=false",), False)])
def test_trainer_row_says_whether_resume_stays_bitwise(options, want,
                                                       tmp_path):
    from howtotrainyourmamlpytorch_tpu_torch.experiment import (
        ExperimentBuilder)
    from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import read_jsonl
    cfg = MAMLConfig(**TINY, dataset_name="synthetic",
                     experiment_root=str(tmp_path), total_iter_per_epoch=1,
                     xla_compiler_options=options)
    builder = ExperimentBuilder(cfg, device="cpu")
    builder.run_experiment()
    rows = [r for r in read_jsonl(os.path.join(builder.paths["logs"],
                                               "events.jsonl"))
            if r["event"] == "warm_start"]
    assert len(rows) == 1 and rows[0]["bitwise_resume"] is want


@pytest.mark.parametrize("options", [
    {"cudnn_fastest": "true"}, {"cudnn_deterministic": "maybe"},
    {"allow_tf32": "true"}, {"xla_llvm_disable_expensive_passes": "True"}])
def test_unknown_option_raises_before_anything_is_set(options):
    saved = _flags()
    with pytest.raises(ValueError) as e:
        with dev.numerics_policy("float32", deterministic=True,
                                 options=options):
            pytest.fail("the policy ran with an unknown option")
    assert str(e.value).startswith(dev.NO_SUCH_OPTION)
    assert _flags() == saved


def test_fingerprint_tuned_vs_untuned_and_runtime_exclusion():
    cfg = MAMLConfig(**TINY)
    fp = aot.store_fingerprint(cfg, "cpu")
    tuned = cfg.replace(xla_compiler_options=("cudnn_deterministic=false",))
    assert aot.store_fingerprint(tuned, "cpu") != fp
    tuned2 = cfg.replace(xla_compiler_options=("cudnn_deterministic=true",))
    assert aot.store_fingerprint(tuned2, "cpu") != aot.store_fingerprint(
        tuned, "cpu")
    assert aot.store_fingerprint(
        tuned.replace(aot_store_dir="/tmp/elsewhere"), "cpu") == \
        aot.store_fingerprint(tuned, "cpu")
    assert "xla_compiler_options" not in aot._RUNTIME_ONLY_KEYS
    assert aot.fingerprint_doc(tuned, "cpu")["config"][
        "xla_compiler_options"] == ("cudnn_deterministic=false",)
