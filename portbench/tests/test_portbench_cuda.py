"""On the card: one short run of each cell through the command, as the
benchmark's check runs it, with ``correct`` true and the contract's
keys; and each training cell at its own size with half of every batch
left out underneath, failing its own limits. Run on the card with
``python -m pytest portbench/tests/test_portbench_cuda.py -m cuda``."""

import json
import os
import subprocess
import sys

import pytest

from portbench.lib.spec import REPO_DIR, Bench

CELLS = [w["name"] for w in Bench().doc["workloads"]]
TRAIN_CELLS = [w["name"] for w in Bench().doc["workloads"]
               if w["traffic"].startswith("train")]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 12345), "--seconds", "3", "--trace", str(trace)],
        cwd=REPO_DIR, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    if trace:
        assert line["device"]["busy_s"] > 0
        assert line["device"]["busy_s"] <= line["device"]["window_s"]
        for name, m in line["metrics"].items():
            if name.startswith(("mfu", "bn_act_roofline")):
                assert 0 < m["value"] <= 100, (name, m)
    else:
        assert "setup_s" in line["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 901, 2 ** 31 + 902,
                                  2 ** 31 + 903])
def test_half_of_the_batch_left_out_fails_the_cells_own_limits(
        card, cell, seed, monkeypatch):
    """The timed step (the phase key's CUDA graph) gets every batch with
    its second half replaced by its first: the mean over the batch is
    then the mean over its first half, the rest left out."""
    import torch

    from portbench import run as bench_run
    from portbench.lib import port
    real = port.train_step

    def train_step(cfg, state, batch, epoch, device):
        step, phase = real(cfg, state, batch, epoch, device)

        def halved(state, batch):
            return step(state, type(batch)(*(
                torch.cat([f[:f.shape[0] // 2]] * 2) for f in batch)))
        return halved, phase
    monkeypatch.setattr(port, "train_step", train_step)
    line = bench_run.run(cell, seed, 1.0, False, torch.device("cuda", 0))
    print(json.dumps({"cell": cell, "seed": seed,
                      "checks": line["checks"]}))
    assert line["correct"] is False, line["checks"]
