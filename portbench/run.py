"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(or ``python3 -m portbench.run ...``) from the root of a checkout. It
loads the cell (``lib/spec.py``), runs its traffic driver on the card
(set-up, then ``--seconds`` of measured work; with ``--trace 1`` a
traced sub-window after it), judges what the timed path produced
against the plain reference, and prints as its last stdout line one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit, also the last lines on stderr.

It exits non-zero and prints no result when there is no card or fewer
cards than the cell asks for, when the run fails, and when ``jax``,
``jaxlib``, ``flax`` or the JAX package is loaded once the window has
closed. Caches (the kernel library, the warm-start store, Triton's and
the extension builder's) live in ``portbench/.cache`` of the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)
CACHE_DIR = os.path.join(PKG_DIR, ".cache")
# Whole top-level module names that must not be loaded by a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "howtotrainyourmamlpytorch_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules (compared
    whole: the port's package name begins with the JAX package's)."""
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def outcome(workload: str, seed: int, seconds: float, trace: bool, device,
            bench=None, t0: float = T0, program_overrides=None,
            cache_dir: str = CACHE_DIR):
    """Run one cell's driver: its ``Outcome``. ``program_overrides``
    replace the program settings a run gives (the cache directories
    under ``cache_dir``)."""
    from portbench.lib import port
    from portbench.lib.spec import Bench, Context
    bench = bench or Bench()
    cell = bench.cell(workload)
    traffic = bench.traffic(cell["traffic"])
    overrides = (port.cache_dirs(cache_dir) if program_overrides is None
                 else program_overrides)
    ctx = Context(cell=cell, config=bench.config(cell["config"]),
                  traffic=traffic, seed=seed, seconds=seconds, trace=trace,
                  device=device, cache_dir=cache_dir, t0=t0,
                  program_overrides=overrides)
    return bench.driver(traffic["driver"]).run(ctx)


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        bench=None, t0: float = T0, program_overrides=None,
        cache_dir: str = CACHE_DIR):
    """Run one cell: the result line as a dict."""
    from portbench.lib.spec import Bench
    bench = bench or Bench()
    out = outcome(workload, seed, seconds, trace, device, bench, t0,
                  program_overrides, cache_dir)
    metrics = {}
    if trace:
        for m in bench.per_layer(workload):
            value = bench.reader(m["name"]).read(out)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in bench.end_to_end(workload):
            metrics[m["name"]] = {"value": float(out.end_to_end[m["name"]]),
                                  "unit": m["unit"]}
    import torch
    dev = torch.device(device)
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics,
            "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": 1,
                       "memory_peak_bytes": int(out.memory_peak_bytes)}}
    if trace and out.trace:
        line["device"]["busy_s"] = out.trace["busy_s"]
        line["device"]["window_s"] = out.trace["window_s"]
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE_DIR,
                                                           "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE_DIR, "torch_extensions"))
    if REPO_DIR not in sys.path:
        sys.path.insert(0, REPO_DIR)
    import torch
    from portbench.lib.spec import Bench
    bench = Bench()
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = run(args.workload, args.seed, args.seconds, bool(args.trace),
               torch.device("cuda", 0), bench)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
