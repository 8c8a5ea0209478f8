"""The benchmark as data: every cell, configuration, traffic mix, driver
and per-layer metric of ``BENCHMARK.json`` loads from its own file, the
file keeps to the contract's names and limits, and a cell or metric
added as files is found without a code change."""

import json
import os
import re
import shutil

import pytest

from portbench.lib.spec import NAME_RE, PKG_DIR, REPO_DIR, UNIT_RE, Bench

BENCH_JSON = os.path.join(REPO_DIR, "BENCHMARK.json")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|"
                   r"filters|_dim$|_rank$|head|expansion|width)")


@pytest.fixture(scope="module")
def doc():
    with open(BENCH_JSON) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(doc):
    assert set(doc) == TOP_KEYS
    assert doc["paths"] == ["portbench"]
    assert 1 <= len(doc["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in doc["command"])
    assert isinstance(doc["run_seconds"], int)
    assert 1 <= doc["run_seconds"] <= 51
    assert len(json.dumps(doc)) <= 64 * 1024


def test_names_units_and_entry_keys(doc):
    names = []
    for c in doc["configs"]:
        assert set(c) == CONFIG_KEYS
        assert _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(REPO_DIR, c["file"]))
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME_RE.match(key) and not WIDTH.search(key), key
        names.append(c["name"])
    for w in doc["workloads"]:
        assert set(w) == CELL_KEYS
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME_RE.match(w["traffic"]) and NAME_RE.match(w["config"])
        names.append(w["name"])
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in doc["per_layer"]:
        assert set(m) == LAYER_KEYS | {"workloads"} and m["workloads"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        names.append(m["name"])
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT_RE.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    assert all(NAME_RE.match(n) for n in names)
    assert len(names) == len(set(names))


def test_contract_pairings(doc):
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]
    cells = {w["name"] for w in doc["workloads"]}
    assert {w["config"] for w in doc["workloads"]} == {
        c["name"] for c in doc["configs"]}
    assert len({(w["config"], w["traffic"]) for w in doc["workloads"]}) \
        == len(doc["workloads"])
    four = sum(w["chips"] == 4 for w in doc["workloads"])
    assert four <= max(1, len(cells) // 4)
    bench = Bench()
    for cell in cells:
        reported = [m["name"] for m in bench.end_to_end(cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.per_layer(cell)
    for m in doc["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert m["moves"] in [x["name"] for x in bench.end_to_end(cell)]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_file_loads_by_name(doc):
    bench = Bench()
    for w in doc["workloads"]:
        cell = bench.cell(w["name"])
        assert set(cell["limits"]) and all(
            isinstance(v, (int, float)) for v in cell["limits"].values())
        assert "maml_config" in bench.config(cell["config"])
        driver = bench.traffic(cell["traffic"])["driver"]
        assert callable(bench.driver(driver).run)
    for m in doc["per_layer"]:
        assert callable(bench.reader(m["name"]).read)
    for c in doc["configs"]:
        assert bench.config(c["name"])["source"] == c["source"]
    assert sorted(bench.names("workloads")) == sorted(
        w["name"] for w in doc["workloads"])


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path, doc):
    for d in ("configs", "workloads", "traffic", "drivers", "metrics"):
        shutil.copytree(os.path.join(PKG_DIR, d), tmp_path / d)
    new = dict(doc)
    cell = {"name": "vgg_flagship.train_fo", "config": "vgg_flagship",
            "traffic": "train_epoch20", "chips": 1,
            "why": "first order, no MSL: 40 % of the flagship schedule"}
    new["workloads"] = doc["workloads"] + [cell]
    new["per_layer"] = doc["per_layer"] + [{
        "name": "steps_traced.train_fo", "unit": "steps", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "train_tasks_per_s", "workloads": [cell["name"]]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    (tmp_path / "traffic" / "train_epoch20.json").write_text(json.dumps(
        {"driver": "train_step", "epoch": 20, "pool_batches": 8,
         "check_steps": 3, "trace_steps": 2}))
    (tmp_path / "workloads" / "vgg_flagship.train_fo.json").write_text(
        json.dumps({"limits": {"loss_gap": 1, "grad_gap": 1,
                               "change_gap": 1}}))
    (tmp_path / "metrics" / "steps_traced.train_fo.py").write_text(
        "def read(outcome):\n    return 7.0\n")
    bench = Bench(str(tmp_path), str(tmp_path / "BENCHMARK.json"))
    loaded = bench.cell(cell["name"])
    assert loaded == {**cell, "limits": {"loss_gap": 1, "grad_gap": 1,
                                         "change_gap": 1}}
    assert bench.traffic(loaded["traffic"])["epoch"] == 20
    names = [m["name"] for m in bench.per_layer(cell["name"])]
    assert "steps_traced.train_fo" in names
    assert bench.reader("steps_traced.train_fo").read(None) == 7.0
    # The new metric lists only the new cell.
    assert "steps_traced.train_fo" not in [
        m["name"] for m in bench.per_layer("vgg_flagship.train")]


def test_a_cell_file_without_a_benchmark_json_entry_is_refused(
        tmp_path, doc):
    for d in ("configs", "workloads", "traffic", "drivers", "metrics"):
        shutil.copytree(os.path.join(PKG_DIR, d), tmp_path / d)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    (tmp_path / "workloads" / "vgg_flagship.orphan.json").write_text(
        json.dumps({"limits": {"loss_gap": 1}}))
    bench = Bench(str(tmp_path), str(tmp_path / "BENCHMARK.json"))
    with pytest.raises(KeyError, match="orphan"):
        bench.cell("vgg_flagship.orphan")
