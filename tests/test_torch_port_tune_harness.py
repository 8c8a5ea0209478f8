"""The port's autotune harness against the JAX package's
(``tune/harness.py``), on the CPU, with fake trial children: a child
that succeeds, raises, aborts on a signal, hangs past its time limit,
runs out of memory or rejects an option (each harness's child prints
its own system's marker: ``No such compile option`` for the JAX one,
``No such backend option`` for the port's) gives the same outcome label
and the same ledger row from both harnesses (run time and error text
aside). A child that leaves a sleeping grandchild and times out leaves
no process alive after the port's ``run_trial``."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from howtotrainyourmamlpytorch_tpu.tune import harness as jharness
from howtotrainyourmamlpytorch_tpu.tune import record as jrecord
from howtotrainyourmamlpytorch_tpu.tune import space as jspace
from howtotrainyourmamlpytorch_tpu_torch import device
from howtotrainyourmamlpytorch_tpu_torch.tune import harness, record, space
from howtotrainyourmamlpytorch_tpu_torch.utils import reaper

# One fake child for both harnesses: it takes the JAX harness's bench
# flags and the port's trial-leg flags, and acts on the config's
# remat_policy.
FAKE = textwrap.dedent("""\
    import argparse, json, os, subprocess, sys, time
    ap = argparse.ArgumentParser()
    ap.add_argument("--config"); ap.add_argument("--steps")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device")
    ap.add_argument("--compiler-option", action="append", default=[])
    ap.add_argument("--backend-option", action="append", default=[])
    a, _ = ap.parse_known_args()
    cfg = json.load(open(a.config))
    mode = cfg.get("remat_policy", "ok")
    if any(kv.startswith("bogus=") for kv in a.compiler_option):
        sys.stderr.write("E0000 No such compile option: 'bogus'\\n")
        sys.exit(1)
    if any(kv.startswith("bogus=") for kv in a.backend_option):
        sys.stderr.write("ValueError: No such backend option: bogus='1'\\n")
        sys.exit(1)
    if mode == "raise":
        raise RuntimeError("the step failed")
    if mode == "abort":
        os.abort()
    if mode == "oom":
        raise MemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    if mode == "hang":
        time.sleep(60)
    if mode == "grandchild":
        kid = subprocess.Popen([sys.executable, "-c",
                                "import time; time.sleep(300)"])
        open(cfg["pid_file"], "w").write(str(kid.pid))
        time.sleep(60)
    n = len(a.compiler_option) + len(a.backend_option)
    print(json.dumps({"metric": "meta_tasks_per_sec_per_chip",
                      "value": 5.0 + n, "unit": "tasks/s/chip",
                      "mfu": (5.0 + n) / 100.0, "flops_per_task": 1e9,
                      "workload": cfg.get("experiment_name")}))
""")
MODES = {"ok": "ok", "raise": "error", "abort": "crashed", "oom": "oom",
         "hang": "timeout", "bogus": "invalid_flag"}
TIMEOUT_S = 4.0


@pytest.fixture
def fake(tmp_path):
    p = tmp_path / "fake_child.py"
    p.write_text(FAKE)
    return str(p)


def _trial(mod, mode):
    assignment = ({"bogus": "1"} if mode == "bogus"
                  else {"remat_policy": mode})
    return mod.Trial(mod.trial_id(assignment), assignment,
                     {"bogus": "1"} if mode == "bogus" else {},
                     {} if mode == "bogus" else {"remat_policy": mode})


def _sweep(harness_mod, record_mod, space_mod, fake, sweep, **kw):
    led = record_mod.TrialLedger(sweep)
    rows = {}
    for mode in MODES:
        t = _trial(space_mod, mode)
        led.begin(t.trial_id, t.assignment)
        row = harness_mod.run_trial(
            t, base_config={"experiment_name": "fake"}, sweep_dir=sweep,
            timeout_s=TIMEOUT_S, **kw)
        led.complete(t.trial_id, row)
        rows[mode] = row
    return led, rows


def _comparable(row):
    return {k: v for k, v in row.items() if k not in ("seconds", "error")}


def test_outcomes_and_rows_equal_jax(tmp_path, fake):
    led, ours = _sweep(harness, record, space, fake,
                       str(tmp_path / "ours"), trial_py=fake)
    jled, ref = _sweep(jharness, jrecord, jspace, fake,
                       str(tmp_path / "ref"), bench_py=fake)
    assert {m: r["outcome"] for m, r in ours.items()} == MODES
    for mode in MODES:
        assert _comparable(ours[mode]) == _comparable(ref[mode]), mode
    assert ours["ok"]["objective_key"] == "mfu"
    assert ours["ok"]["objective"] == pytest.approx(0.05)
    assert "No such backend option" in ours["bogus"]["error"]
    assert "CUDA out of memory" in ours["oom"]["error"]
    assert led.counts() == jled.counts()
    assert led.counts()["failed_by_outcome"] == {
        "error": 1, "crashed": 1, "oom": 1, "timeout": 1,
        "invalid_flag": 1}
    for mode in MODES:
        t = _trial(space, mode)
        for suffix in (".json", ".log"):
            assert (tmp_path / "ours" / "trials" /
                    f"{t.trial_id}{suffix}").exists()


def test_the_marker_is_the_option_tables():
    """The harness's invalid-option marker is what ``device.py`` raises
    with, and it classifies like the JAX harness's PJRT marker."""
    assert harness._INVALID_FLAG_MARKERS == (device.NO_SUCH_OPTION,)
    with pytest.raises(ValueError) as e:
        device.parse_backend_options({"bogus": "1"})
    assert str(e.value).startswith(device.NO_SUCH_OPTION)
    assert harness.classify_failure(1, str(e.value)) == "invalid_flag"
    for rc, tail, want in ((None, "", "timeout"),
                           (1, "RuntimeError: x", "error"),
                           (-6, "aborted", "crashed"),
                           (1, "MemoryError: y", "oom"),
                           (1, "torch.OutOfMemoryError: CUDA out of memory",
                            "oom")):
        assert harness.classify_failure(rc, tail) == want
        if "torch" not in tail:
            assert jharness.classify_failure(rc, tail) == want


def test_trial_config_strips_adopted_options_and_gets_a_fresh_store(
        tmp_path):
    t = space.Trial("abc", {"remat_policy": "dots"}, {},
                    {"remat_policy": "dots"})
    base = {"experiment_name": "re", "xla_compiler_options": {"a": "1"}}
    ours = json.load(open(harness.write_trial_config(
        t, base, str(tmp_path / "a"))))
    ref = json.load(open(jharness.write_trial_config(
        t, base, str(tmp_path / "b"))))
    assert ours == ref and "xla_compiler_options" not in ours
    stale = tmp_path / "c" / "abc_aot"
    stale.mkdir(parents=True)
    (stale / "STORE.json").write_text("{}")
    cfg = json.load(open(harness.write_trial_config(
        t, {**base, "aot_store_dir": "/elsewhere"}, str(tmp_path / "c"))))
    assert cfg["aot_store_dir"] == str(stale)
    assert not stale.exists()   # fresh: the trial captures its own


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # A zombie (exited, not yet waited for by its new parent) is gone.
    with open(f"/proc/{pid}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0] != "Z"


def test_timed_out_trial_leaves_no_grandchild(tmp_path, fake):
    pid_file = tmp_path / "grandchild.pid"
    t = space.Trial("gc", {"remat_policy": "grandchild"}, {},
                    {"remat_policy": "grandchild"})
    row = harness.run_trial(
        t, base_config={"experiment_name": "fake",
                        "pid_file": str(pid_file)},
        sweep_dir=str(tmp_path), trial_py=fake, timeout_s=TIMEOUT_S)
    assert row["outcome"] == "timeout"
    pid = int(pid_file.read_text())
    deadline = time.monotonic() + 10
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _alive(pid)


def test_reap_ends_a_tracked_group(tmp_path):
    """On the driver's exit (``reaper.reap``, also run on SIGTERM) a
    tracked group is killed, grandchildren included."""
    pid_file = tmp_path / "gc.pid"
    code = ("import subprocess, sys, time; k = subprocess.Popen("
            "[sys.executable, '-c', 'import time; time.sleep(300)']); "
            f"open({str(pid_file)!r}, 'w').write(str(k.pid)); "
            "time.sleep(300)")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            start_new_session=True)
    reaper.track(reaper.Group(proc))
    deadline = time.monotonic() + 20
    while not pid_file.exists() or not pid_file.read_text():
        assert time.monotonic() < deadline
        time.sleep(0.05)
    grandchild = int(pid_file.read_text())
    assert reaper.reap(grace_s=2.0) >= 1
    assert proc.returncode == -signal.SIGTERM
    deadline = time.monotonic() + 10
    while _alive(grandchild) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _alive(grandchild)
