"""The port's autotune ledger and adoption record against the JAX
package's (``tune/record.py``), on the CPU: the same begin / complete /
resume sequence writes equal ``TUNE.json`` documents, timestamps aside;
a cross-workload resume is refused and a corrupt ledger quarantined in
both; ``decide_adoption`` returns the same verdict over the refusal
matrix of ``tests/test_tune.py § test_gate_refusal_matrix``; each
package reads the other's ``TUNED.json``, and a rejected record is
refused."""

import json

import pytest

from howtotrainyourmamlpytorch_tpu.tune import record as jrecord
from howtotrainyourmamlpytorch_tpu_torch.tune import record

TIMESTAMPS = ("created", "started", "finished", "recorded", "written")


def _scrub(doc):
    if isinstance(doc, dict):
        return {k: _scrub(v) for k, v in doc.items() if k not in TIMESTAMPS}
    return doc


def _drive(mod, d):
    """A sweep killed mid-trial, then resumed by a fresh driver."""
    led = mod.TrialLedger(d)
    led.ensure_workload("aaaa")
    led.begin("t1", {"a": 1})
    led.complete("t1", {"outcome": "ok", "objective": 2.0,
                        "objective_key": "mfu"})
    led.begin("t2", {"a": 2})
    led.complete("t2", {"outcome": "crashed", "error": "sig"})
    led.begin("t3", {"a": 3})           # the driver dies here
    led2 = mod.TrialLedger(d)
    led2.ensure_workload("aaaa")
    seen = (sorted(led2.completed_ids()), led2.interrupted_ids())
    led2.begin("t3", {"a": 3})
    led2.complete("t3", {"outcome": "ok", "objective": 1.0,
                         "objective_key": "mfu"})
    led2.begin("t4", {"a": 4})
    led2.complete("t4", {"outcome": "ok", "objective": 46.2,
                         "objective_key": "tasks_per_sec_per_chip"})
    led2.record_gates("t1", {"pass": True, "mode": "bitwise"},
                      {"skipped": "no dataset"},
                      params={"parity_tolerance": 5e-3})
    return led2, seen


def test_resume_sequence_writes_the_jax_ledger(tmp_path):
    ours, seen = _drive(record, str(tmp_path / "ours"))
    ref, jseen = _drive(jrecord, str(tmp_path / "ref"))
    assert seen == jseen == (["t1", "t2"], ["t3"])
    assert ours.record("t3")["attempt"] == 2
    assert ours.counts() == ref.counts() == {
        "ok": 3, "failed": 1, "running": 0,
        "failed_by_outcome": {"crashed": 1}}
    for key in (None, "mfu", "tasks_per_sec_per_chip"):
        assert _scrub(ours.best(key)) == _scrub(ref.best(key))
    docs = [json.loads(p.read_text()) for p in (
        tmp_path / "ours" / "TUNE.json", tmp_path / "ref" / "TUNE.json")]
    assert _scrub(docs[0]) == _scrub(docs[1])
    assert docs[0]["schema"] == jrecord.LEDGER_SCHEMA
    # Either package resumes the other's ledger.
    assert sorted(jrecord.TrialLedger(str(tmp_path / "ours"))
                  .completed_ids()) == ["t1", "t2", "t3", "t4"]
    assert record.TrialLedger(str(tmp_path / "ref")).gates_for(
        "t1", params={"parity_tolerance": 5e-3})["parity"]["mode"] == \
        "bitwise"


@pytest.mark.parametrize("mod", [record, jrecord])
def test_cross_workload_resume_refused_and_corrupt_quarantined(tmp_path,
                                                               mod):
    led = mod.TrialLedger(str(tmp_path))
    led.ensure_workload("aaaa")
    mod.TrialLedger(str(tmp_path)).ensure_workload("aaaa")
    with pytest.raises(ValueError, match="fresh --out"):
        mod.TrialLedger(str(tmp_path)).ensure_workload("bbbb")
    bad = tmp_path / "torn"
    bad.mkdir()
    (bad / mod.LEDGER_FILE).write_text("{torn json")
    assert mod.TrialLedger(str(bad)).completed_ids() == []
    assert (bad / (mod.LEDGER_FILE + ".corrupt")).exists()


def _ok(tid, obj, key=None):
    row = {"trial_id": tid, "objective": obj, "status": "ok"}
    if key:
        row["objective_key"] = key
    return row


BASE, WIN = _ok("baseline", 5.0), _ok("abc", 6.0)
PAR_OK = {"pass": True, "mode": "bitwise"}
PAR_BAD = {"pass": False, "mode": "fail", "error": "rel 0.2"}
ACC_OK = {"pass": True}
MATRIX = [
    (None, BASE, None, None),
    (WIN, None, PAR_OK, ACC_OK),
    (_ok("abc", 4.0), BASE, PAR_OK, ACC_OK),
    (BASE, BASE, PAR_OK, ACC_OK),
    (_ok("abc", 46.2, "tasks_per_sec_per_chip"), _ok("baseline", 5.0, "mfu"),
     PAR_OK, ACC_OK),
    (WIN, BASE, PAR_BAD, ACC_OK),
    (WIN, BASE, None, ACC_OK),
    (WIN, BASE, PAR_OK, {"pass": False}),
    (WIN, BASE, PAR_OK, None),
    (WIN, BASE, PAR_OK, {"skipped": "no real dataset"}),
    (WIN, BASE, PAR_OK, ACC_OK),
    (WIN, {"trial_id": "baseline", "objective": None}, PAR_OK, ACC_OK),
]


@pytest.mark.parametrize("case", range(len(MATRIX)))
def test_decide_adoption_equals_jax(case):
    args = MATRIX[case]
    assert record.decide_adoption(*args) == jrecord.decide_adoption(*args)


def test_tuned_record_roundtrip_across_packages(tmp_path):
    doc = {"adopted": True, "xla_compiler_options": {"cudnn_benchmark":
                                                     "true"},
           "config_overrides": {"remat_policy": "dots"}}
    for writer, reader in ((record, jrecord), (jrecord, record)):
        d = tmp_path / writer.__name__.split(".")[0]
        d.mkdir()
        got = reader.read_tuned(writer.write_tuned(str(d), doc))
        assert _scrub(got) == {"schema": record.TUNED_SCHEMA, **doc}
    p = record.write_tuned(str(tmp_path), {"adopted": False,
                                           "reason": "parity"})
    for mod in (record, jrecord):
        with pytest.raises(ValueError, match="adopted=false"):
            mod.read_tuned(p)
    (tmp_path / "other.json").write_text("{}")
    with pytest.raises(ValueError, match="not a"):
        record.read_tuned(str(tmp_path / "other.json"))
