"""The port's autotune search space against the JAX package's
(``tune/space.py``), on the CPU: the same spec files and the config
axes of the default space enumerate to the same trial ids,
assignments, channel splits and pruned lists (exact equality); option
syntax and malformed axes and specs are refused alike."""

import json

import pytest

from howtotrainyourmamlpytorch_tpu.tune import space as jspace
from howtotrainyourmamlpytorch_tpu_torch.tune import space

SPECS = [
    {"axes": [{"name": "remat_policy", "values": ["nothing", "dots"]},
              {"name": "xla_flag_a", "kind": "xla", "values": ["1", "2"]}]},
    {"axes": [{"name": "bn_fast_math", "values": [False, True]},
              {"name": "cudnn_deterministic", "kind": "xla",
               "values": ["true", "false"]},
              {"name": "task_microbatches", "values": [1, 2, 3]}]},
    {"axes": [{"name": "remat_policy", "values": ["nothing"]},
              {"name": "xla_cpu_enable_fast_math", "kind": "xla",
               "values": ["False", "bogus"]}]},
    {"axes": [{"name": "cudnn_benchmark", "kind": "xla",
               "values": ["true"]}]},
]


def _flat(trials, pruned):
    return ([(t.trial_id, t.assignment, t.compiler_options,
              t.config_overrides) for t in trials], pruned)


@pytest.mark.parametrize("spec", SPECS)
def test_spec_enumeration_equals_jax(spec):
    spec = json.loads(json.dumps(spec))  # what a --space file gives
    ours = _flat(*space.space_from_spec(spec).enumerate())
    ref = _flat(*jspace.space_from_spec(spec).enumerate())
    assert ours == ref
    assert ours[0][0][0] == space.BASELINE_TRIAL_ID


@pytest.mark.parametrize("per_device_tasks", [1, 2, 3, 12])
def test_default_config_axes_equal_jax(per_device_tasks):
    """The CPU default space is the JAX default's config axes: the same
    trials and pruned points with their refusing axis and reason; the
    card's adds one backend axis and nothing else."""
    ref_axes = [a for a in jspace.default_space(
        "cpu", per_device_tasks=per_device_tasks).axes
        if a.kind == "config"]
    ref = _flat(*jspace.SearchSpace(ref_axes).enumerate())
    ours = space.default_space("cpu", per_device_tasks=per_device_tasks)
    assert all(a.kind == "config" for a in ours.axes)
    assert _flat(*ours.enumerate()) == ref
    card = space.default_space("cuda", per_device_tasks=per_device_tasks)
    extra = [a for a in card.axes if a.kind == "xla"]
    assert [(a.name, a.values) for a in extra] == [
        ("cudnn_deterministic", ("true", "false"))]
    assert [a.name for a in card.axes if a.kind == "config"] == [
        a.name for a in ref_axes]
    trials, pruned = card.enumerate()
    assert len(trials) - 1 + len(pruned) == 4 * 4 * 2 * 2
    with pytest.raises(ValueError, match="platform"):
        space.default_space("tpu")


@pytest.mark.parametrize("pairs", [
    ["k=v", "k2=a=b"], ["noeq"], ["k="], ["=v"], ["k=1", "k=2"], [],
    ["cudnn_deterministic=false"]])
def test_parse_compiler_options_equals_jax(pairs):
    def outcome(fn):
        try:
            return fn(pairs)
        except ValueError as e:
            return ("ValueError", str(e))
    assert outcome(space.parse_compiler_options) == outcome(
        jspace.parse_compiler_options)


@pytest.mark.parametrize("build", [
    lambda s: s.Axis("a", (1,), kind="structural"),
    lambda s: s.Axis("a", ()),
    lambda s: s.Axis("a", (1, 1)),
    lambda s: s.SearchSpace([s.Axis("a", (1,)), s.Axis("a", (2,))]),
    lambda s: s.space_from_spec({}),
    lambda s: s.space_from_spec({"axes": []}),
    lambda s: s.space_from_spec({"axes": [{"values": [1]}]}),
    lambda s: s.space_from_spec({"axes": [{"name": "x"}]}),
    lambda s: s.space_from_spec({"axes": [
        {"name": "", "kind": "xla", "values": ["1"]}]}).enumerate(),
])
def test_malformed_axes_and_specs_raise_like_jax(build):
    with pytest.raises(ValueError) as ours:
        build(space)
    with pytest.raises(ValueError) as ref:
        build(jspace)
    assert str(ours.value) == str(ref.value)


def test_trial_ids_are_content_ids():
    for a in ({}, {"b": 1, "a": 2}, {"remat_policy": "dots",
                                     "cudnn_deterministic": "false"}):
        assert space.trial_id(a) == jspace.trial_id(a)
    assert space.trial_id({"b": 1, "a": 2}) == space.trial_id(
        {"a": 2, "b": 1})
    assert space.TUNE_SCHEMA == jspace.TUNE_SCHEMA
