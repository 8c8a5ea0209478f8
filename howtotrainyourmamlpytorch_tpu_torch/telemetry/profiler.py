"""Perf lab: device-time attribution, FLOP cost cards and MFU (the port's
counterpart of the JAX package's ``telemetry/profiler.py``).

* **Sampled device-time attribution** — ``profile_every_n_steps`` wraps
  one train step in ``torch.profiler`` on its cadence
  (:class:`PerfSampler`). Device records are read from the profiler's raw
  results (``prof.profiler.kineto_results``): ``prof.events()`` builds a
  Python tree over every host op, over a minute for a ResNet-12 step. The
  window's wall time splits into device compute (the union of kernel
  spans), device idle (gaps inside the kernels' envelope) and the host
  gap outside it, as in the JAX package; device time is split further by
  kernel family (:data:`FAMILIES`, one table for the repo's profiles) and
  by named region (:data:`KNOWN_REGIONS`, the ``record_function`` labels
  of ``meta/``, ``ops/episode.py`` and ``serve/adapt.py``). A kernel
  belongs to the innermost label open on the host (on any thread) when
  the runtime call that launched it was made, found through the
  correlation ids the profiler gives both; kernels launched outside
  every label go to :data:`OTHER_REGION`, and those whose launch is not
  in the window to :data:`UNATTRIBUTED`.
  Each sample publishes ``perf/*`` gauges and counters and one
  ``perf_profile`` events.jsonl row with the JAX package's keys.
* **Cost cards** — the FLOPs of one train step per phase key
  (``train_so{0,1}_msl{0,1}``), counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (convolutions and matrix
  products, forward and backward) during a real step of that phase
  outside the sampled window: the mode passes every op through
  unchanged, so the step's weights are bitwise those of an uncounted
  step. MFU is the card's FLOPs over the window's wall time and the
  card's peak (:data:`DEVICE_PEAKS`). The cards persist as
  ``logs/PROFILE.json`` in the JAX package's schema; eager PyTorch
  reports no bytes accessed, so the roofline verdict reads "unknown".

On the CPU (the tests) there is no device lane: the outermost CPU
operators of the window stand for the device's work, and the row says so
(``device_lane: "cpu"``).

Every capture failure is counted (``perf/errors``) and warned once:
profiling never ends a run.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

PROFILE_SCHEMA = "maml_perf_profile_v1"
PROFILE_FILE = "PROFILE.json"
PERF_EVENT = "perf_profile"
# Host annotation bracketing the sampled window: device records outside
# its span are not the window's.
WINDOW_MARKER = "maml_perf_window"
# The window's last device work: one tiny kernel under this label, just
# before the closing sync. A complete capture holds its device record;
# when the tracer drops the window's tail, it is missing.
WINDOW_TAIL = "maml_perf_window_tail"

# Metric names (the registry naming convention: perf/<name>).
SAMPLES_COUNTER = "perf/samples"
SAMPLE_SECONDS_COUNTER = "perf/sample_seconds"
ERRORS_COUNTER = "perf/errors"
COMPUTE_FRAC_GAUGE = "perf/device_compute_frac"
IDLE_FRAC_GAUGE = "perf/device_idle_frac"
GAP_FRAC_GAUGE = "perf/dispatch_gap_frac"
MFU_GAUGE = "perf/mfu"

# Env overrides for cards the table doesn't know, or measured peaks:
# FLOP/s and GB/s.
PEAK_FLOPS_ENV = "MAML_PEAK_FLOPS"
HBM_GBPS_ENV = "MAML_HBM_GBPS"

# Dense bf16 tensor-core FLOP/s (no sparsity) and HBM bytes/s per card,
# matched by substring against torch.cuda.get_device_name, first hit
# wins ("pcie" before the bare "h100").
DEVICE_PEAKS: Tuple[Tuple[str, float, float], ...] = (
    # NVIDIA H100 Tensor Core GPU data sheet, H100 PCIe column: 1,513
    # TFLOPS bf16 with sparsity (756 dense), 2.0 TB/s HBM2e.
    ("h100 pcie", 756e12, 2.0e12),
    # Same data sheet, H100 SXM column: 1,979 TFLOPS bf16 with sparsity
    # (989 dense), 3.35 TB/s HBM3 ("NVIDIA H100 80GB HBM3").
    ("h100", 989e12, 3.35e12),
)

# record_function labels on the train, eval and serving paths (the JAX
# package's named_scope labels). A kernel maps to the innermost one open
# when its launching op started.
KNOWN_REGIONS: Tuple[str, ...] = (
    "episode_normalize", "inner_support_forward", "inner_support_grad",
    "inner_lslr_update", "inner_msl_target_forward",
    "final_target_forward", "task_adapt", "meta_update",
    "serve_adapt", "serve_predict",
)
OTHER_REGION = "other"           # launched outside every label
UNATTRIBUTED = "unattributed"    # launching op not in the window

# Kernel-name fragments -> family, first match wins: "pool" comes before
# "conv", whose "nhwc"/"nchw" fragments would take max_pool_*_nhwc.
FAMILIES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("bn_act", ("bn_act_persistent",)),
    ("pool", ("max_pool", "pool")),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "fprop", "dgrad",
              "wgrad", "winograd", "nhwc", "nchw")),
    ("gemm", ("gemm", "cutlass", "cublas", "splitk")),
    ("reduce", ("reduce", "norm")),
)
OTHER_FAMILY = "elementwise/other"

_warned_kinds: set = set()


def kernel_family(name: str) -> str:
    """The :data:`FAMILIES` family of a kernel (or CPU operator) name."""
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return OTHER_FAMILY


def region(name: str):
    """``record_function(name)`` while a profiler records, else nothing:
    the labels cost a range object per call only when a profile is being
    taken."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def resolve_peaks(device_kind: str,
                  env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Peak FLOP/s + HBM bytes/s for a device kind.

    Returns ``{"peak_flops", "hbm_bytes_per_s", "source"}`` where
    ``source`` is ``"override"`` (either env var set — the operator's
    measured number wins over the table), ``"table"`` (device-kind
    substring match) or ``"unknown"`` (neither; both peaks 0.0 and MFU is
    unavailable). An unmatched kind warns once per process."""
    env = os.environ if env is None else env
    kind = (device_kind or "").lower()
    peak = bw = 0.0
    source = "unknown"
    for sub, p, b in DEVICE_PEAKS:
        if sub in kind:
            peak, bw, source = p, b, "table"
            break
    override = False
    raw = env.get(PEAK_FLOPS_ENV)
    if raw:
        try:
            peak = float(raw)
            override = True
        except ValueError:
            warnings.warn(f"{PEAK_FLOPS_ENV}={raw!r} is not a number; "
                          f"ignoring the override")
    raw = env.get(HBM_GBPS_ENV)
    if raw:
        try:
            bw = float(raw) * 1e9
            override = True
        except ValueError:
            warnings.warn(f"{HBM_GBPS_ENV}={raw!r} is not a number; "
                          f"ignoring the override")
    if override:
        source = "override"
    elif source == "unknown" and kind not in _warned_kinds:
        _warned_kinds.add(kind)
        warnings.warn(
            f"device kind {device_kind!r} matches no entry in the peak "
            f"FLOPs/bandwidth table; MFU and roofline verdicts are "
            f"unavailable (set {PEAK_FLOPS_ENV} / {HBM_GBPS_ENV} to "
            f"supply measured peaks)")
    return {"peak_flops": peak, "hbm_bytes_per_s": bw, "source": source}


def roofline_verdict(flops: float, bytes_accessed: float,
                     peak_flops: float,
                     hbm_bytes_per_s: float) -> Dict[str, Any]:
    """Classify one step against the device roofline (the JAX function):
    "compute" at or above the ridge point, "memory" below it, "unknown"
    without both peaks, FLOPs and bytes."""
    ai = (flops / bytes_accessed) if bytes_accessed > 0 else None
    if peak_flops <= 0 or hbm_bytes_per_s <= 0 or ai is None or flops <= 0:
        return {"bound": "unknown", "arithmetic_intensity": ai,
                "ridge_flops_per_byte": None,
                "ceiling_flops_per_s": None}
    ridge = peak_flops / hbm_bytes_per_s
    return {
        "bound": "compute" if ai >= ridge else "memory",
        "arithmetic_intensity": ai,
        "ridge_flops_per_byte": ridge,
        "ceiling_flops_per_s": min(peak_flops, ai * hbm_bytes_per_s),
    }


def phase_card_name(second_order: bool, use_msl: bool) -> str:
    """Cost-card key of a train phase (the JAX package's executable-slot
    names)."""
    return f"train_so{int(second_order)}_msl{int(use_msl)}"


def device_kind(device: Any = None) -> str:
    """The card's name, or ``"cpu"``."""
    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    return (torch.cuda.get_device_name(device)
            if torch.cuda.is_available() else "cpu")


def count_flops(fn: Callable[[], Any]) -> Tuple[Any, float]:
    """``(fn(), FLOPs)``: ``fn`` run under ``FlopCounterMode``, which
    counts convolutions and matrix products (forward and backward) and
    passes every op through unchanged."""
    from torch.utils.flop_counter import FlopCounterMode
    mode = FlopCounterMode(display=False)
    with mode:
        out = fn()
    return out, float(mode.get_total_flops())


def build_cost_card(name: str, *, flops: float, kind: str,
                    peaks: Dict[str, Any]) -> Dict[str, Any]:
    """One cost card in the JAX package's card keys (bytes accessed and
    compiled memory unknown to eager PyTorch: 0.0 and None)."""
    return {"name": name, "fingerprint": None, "device_kind": kind,
            "flops": float(flops), "flops_source": "flop_counter_mode",
            "bytes_accessed": 0.0, "memory": None,
            **roofline_verdict(float(flops), 0.0, peaks["peak_flops"],
                               peaks["hbm_bytes_per_s"])}


def load_profile(path: str) -> Optional[Dict[str, Any]]:
    """Parse a PROFILE.json; None when missing, unreadable or of another
    schema."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != PROFILE_SCHEMA:
        return None
    if not isinstance(doc.get("cards"), dict):
        doc["cards"] = {}
    return doc


def merge_profile(path: str, cards: List[Dict[str, Any]], *,
                  device_kind: str = "",
                  peaks: Optional[Dict[str, Any]] = None,
                  fingerprint: Optional[str] = None) -> Dict[str, Any]:
    """Read-merge-write PROFILE.json atomically (the JAX function): cards
    keyed by name, newest wins."""
    peaks = peaks if peaks is not None else resolve_peaks(device_kind)
    doc = load_profile(path) or {"schema": PROFILE_SCHEMA, "cards": {}}
    doc.update(device_kind=device_kind or doc.get("device_kind", ""),
               peak_flops=peaks["peak_flops"],
               hbm_bytes_per_s=peaks["hbm_bytes_per_s"],
               peak_flops_source=peaks["source"],
               written_ts=time.time())
    if fingerprint is not None:
        doc["fingerprint"] = fingerprint
    for card in cards:
        doc["cards"][card["name"]] = card
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return doc


# ---------------------------------------------------------------------------
# Reading a window.

# (name, start_ns, end_ns, launch_ns or None)
Record = Tuple[str, int, int, Optional[int]]
# Runtime calls that put work on the device (kernels, copies, sets).
_LAUNCH_CALLS = ("Launch", "Memcpy", "Memset")


class Window(NamedTuple):
    """One capture's raw records, split (:func:`window_records`)."""
    records: List[Record]
    labels: List[Tuple[str, int, int]]
    span: Optional[Tuple[int, int]]
    lane: str
    lost: int   # device work launched in the span with no device record


def _activity(e) -> str:
    """The record's kineto activity type ("kernel", "gpu_memcpy",
    "gpu_user_annotation", "cpu_op", ...); "" where torch lacks it."""
    return getattr(e, "activity_type", lambda: "")()


def _is_annotation(e) -> bool:
    return e.is_user_annotation() or "annotation" in _activity(e)


def window_records(events: List[Any]) -> Window:
    """Split a profiler window's raw records (``kineto_results.events()``)
    into device records, region labels, the window span and the lane.

    Device records are the CUDA activity (kernels, copies, sets), each
    with the host start of the runtime call that launched it: the CPU
    record with the same correlation id and the same linked op (op ids
    and the runtime's correlation ids are separate counters, so the pair
    is what identifies the call). On a window with none (a CPU run) the
    records are the outermost CPU operators of each thread, launched at
    their own start. Region labels are the host ``record_function``
    ranges named in :data:`KNOWN_REGIONS`; the window span is the
    :data:`WINDOW_MARKER` range. ``lost`` counts the runtime calls in the
    span that put work on the device and have no device record: the
    tracer drops some device records early in a session. It may also
    drop the window's tail, launch records included; a window that holds
    the :data:`WINDOW_TAIL` label (the sampler's closing sentinel
    kernel) but no device record launched under it lost its tail, and
    ``lost`` then also counts the host operators (runtime calls aside)
    that started after the last recorded launch (the sentinel's among
    them, so at least one).
    The sentinel's own kernel is not one of the records."""
    from torch.autograd import DeviceType
    launches: Dict[Tuple[int, int], int] = {}
    labels: List[Tuple[str, int, int]] = []
    window: Optional[Tuple[int, int]] = None
    tail: Optional[Tuple[int, int]] = None
    device: List[Any] = []
    cpu_ops: List[Any] = []
    for e in events:
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() == DeviceType.CUDA:
            if not _is_annotation(e):
                device.append(e)
            continue
        if e.device_type() != DeviceType.CPU:
            continue
        linked = e.linked_correlation_id()
        if linked:
            if any(k in e.name() for k in _LAUNCH_CALLS):
                launches[(e.correlation_id(), linked)] = e.start_ns()
            continue
        if e.is_user_annotation():
            name = e.name()
            if name == WINDOW_MARKER:
                window = (e.start_ns(), e.end_ns())
            elif name == WINDOW_TAIL:
                tail = (e.start_ns(), e.end_ns())
            elif name in KNOWN_REGIONS:
                labels.append((name, e.start_ns(), e.end_ns()))
        elif _activity(e) in ("cpu_op", ""):
            cpu_ops.append(e)
    if device:
        keys = [(e.correlation_id(), e.linked_correlation_id())
                for e in device]
        records = [(e.name(), e.start_ns(), e.end_ns(), launches.get(key))
                   for e, key in zip(device, keys)]
        recorded = set(keys)
        in_window = (lambda t: window is None
                     or window[0] <= t <= window[1])
        lost = sum(1 for key, t in launches.items()
                   if key not in recorded and in_window(t))
        if tail is not None:
            in_tail = [r for r in records if r[3] is not None
                       and tail[0] <= r[3] <= tail[1]]
            records = [r for r in records if r not in in_tail]
            if not in_tail:
                last = max((r[3] for r in records if r[3] is not None),
                           default=window[0] if window else 0)
                lost += max(1, sum(1 for e in cpu_ops
                                   if e.start_ns() > last
                                   and in_window(e.start_ns())
                                   and not e.name().startswith("cuda")))
        return Window(records, labels, window, "cuda", lost)
    records = []
    cpu_ops.sort(key=lambda e: (e.start_thread_id(), e.start_ns(),
                                -e.end_ns()))
    thread, end = None, None
    for e in cpu_ops:
        if e.start_thread_id() != thread:
            thread, end = e.start_thread_id(), None
        if end is None or e.start_ns() >= end:
            records.append((e.name(), e.start_ns(), e.end_ns(),
                            e.start_ns()))
            end = e.end_ns()
    return Window(records, labels, window, "cpu", 0)


def _merged_length(intervals: List[Tuple[int, int]]) -> int:
    """Total length of the union of [start, end) intervals."""
    if not intervals:
        return 0
    intervals.sort()
    total = 0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def _regions_of(records: List[Record],
                labels: List[Tuple[str, int, int]]) -> List[str]:
    """Each record's region: the label open at its launch time with the
    latest start (the innermost), :data:`OTHER_REGION` when none is open,
    :data:`UNATTRIBUTED` without a launch time. One sweep over launches
    in time order."""
    out = [UNATTRIBUTED] * len(records)
    order = sorted((r[3], i) for i, r in enumerate(records)
                   if r[3] is not None)
    pending = sorted(labels, key=lambda lab: lab[1])
    active: List[Tuple[str, int, int]] = []
    j = 0
    for t, i in order:
        while j < len(pending) and pending[j][1] <= t:
            active.append(pending[j])
            j += 1
        active = [lab for lab in active if lab[2] > t]
        out[i] = (max(active, key=lambda lab: lab[1])[0] if active
                  else OTHER_REGION)
    return out


def summarize_records(records: List[Record],
                      labels: List[Tuple[str, int, int]],
                      window: Optional[Tuple[int, int]],
                      wall_seconds: float) -> Dict[str, Any]:
    """Device-time attribution of one window, in the JAX package's keys.

    Records are clipped to the window span when there is one, whose
    length is then the window's wall time (the same clock as the
    records, so the three fractions sum to 1); otherwise
    ``wall_seconds`` is. ``device_compute_seconds`` is the union of the
    records, ``device_idle_seconds`` the gaps inside their envelope,
    ``host_gap_seconds`` the wall time outside it. Per-family and
    per-region seconds sum the clipped durations."""
    if window is not None:
        lo, hi = window
        wall = (hi - lo) / 1e9
    else:
        lo = hi = None
        wall = max(float(wall_seconds), 0.0)
    kept: List[Record] = []
    for name, start, end, launch in records:
        if lo is not None:
            start, end = max(start, lo), min(end, hi)
        if end > start:
            kept.append((name, start, end, launch))
    regions = _regions_of(kept, labels)
    per_family: Dict[str, float] = {}
    per_family_n: Dict[str, int] = {}
    per_region: Dict[str, float] = {}
    for (name, start, end, _), reg in zip(kept, regions):
        fam = kernel_family(name)
        dur = (end - start) / 1e9
        per_family[fam] = per_family.get(fam, 0.0) + dur
        per_family_n[fam] = per_family_n.get(fam, 0) + 1
        per_region[reg] = per_region.get(reg, 0.0) + dur
    if kept:
        busy = _merged_length([(s, e) for _, s, e, _ in kept]) / 1e9
        envelope = (max(e for _, _, e, _ in kept)
                    - min(s for _, s, _, _ in kept)) / 1e9
    else:
        busy = envelope = 0.0
    idle = max(envelope - busy, 0.0)
    gap = max(wall - envelope, 0.0)
    ranked = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))
    return {
        "wall_seconds": wall,
        "device_compute_seconds": busy,
        "device_idle_seconds": idle,
        "host_gap_seconds": gap,
        "device_compute_frac": busy / wall if wall > 0 else 0.0,
        "device_idle_frac": idle / wall if wall > 0 else 0.0,
        "dispatch_gap_frac": gap / wall if wall > 0 else 0.0,
        "per_family_seconds": ranked(per_family),
        "per_family_kernels": {f: per_family_n[f]
                               for f in ranked(per_family)},
        "per_region_seconds": ranked(per_region),
        "device_spans": len(kept),
    }


def attach_card(summary: Dict[str, Any], executable: Optional[str],
                card: Optional[Dict[str, Any]],
                peaks: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's per-executable split (one executable per window:
    the step of ``executable``'s phase), its roofline entry, and the
    window's MFU: the card's FLOPs over the wall time and the peak (None
    without a card or a peak)."""
    secs = sum(summary["per_family_seconds"].values())
    summary["per_executable_seconds"] = ({executable: secs}
                                         if executable and secs > 0 else {})
    summary["top_executable"] = (executable if summary[
        "per_executable_seconds"] else None)
    summary["roofline"] = {}
    summary["flops"] = summary["mfu"] = None
    summary["peak_flops"] = peaks["peak_flops"]
    summary["peak_flops_source"] = peaks["source"]
    if card is None or not card.get("flops"):
        return summary
    flops = float(card["flops"])
    summary["flops"] = flops
    if secs > 0:
        summary["roofline"][executable] = {
            "achieved_flops_per_s": flops / summary["device_compute_seconds"],
            "bound": card.get("bound", "unknown")}
    if peaks["peak_flops"] > 0 and summary["wall_seconds"] > 0:
        summary["mfu"] = flops / summary["wall_seconds"] / peaks[
            "peak_flops"]
    return summary


# ---------------------------------------------------------------------------
# Live capture.

class PerfSampler:
    """The experiment loop's sampling half: cadence bookkeeping, a
    ``torch.profiler`` capture around one train step, and publication
    (``perf/*`` gauges and counters + one ``perf_profile`` row).

    Constructed iff ``profile_every_n_steps > 0``: the loop holds
    ``None`` otherwise. Every capture failure is counted
    (``perf/errors``) and warned once.

    The window runs under the profiler, so its absolute times carry the
    tracer's overhead (per host op); the split is the signal.
    """

    def __init__(self, every_n: int, registry=None, jsonl=None,
                 device: Any = None,
                 cards: Optional[Dict[str, Dict[str, Any]]] = None):
        if every_n < 1:
            raise ValueError(f"every_n must be >= 1, got {every_n}")
        self.every_n = int(every_n)
        self.registry = registry
        self.jsonl = jsonl
        self.device = torch.device("cpu" if device is None else device)
        self.kind = device_kind(self.device)
        self.peaks = resolve_peaks(self.kind)
        self.cards = cards if cards is not None else {}
        self._last_iter: Optional[int] = None
        # (profiler, marker, t0) while a capture is live.
        self._window: Optional[Tuple[Any, Any, float]] = None
        # The closing sentinel kernel's tensor (on the card only).
        self._sentinel: Optional[torch.Tensor] = None
        self._warned = False
        if registry is not None:
            # Eager registration: an armed run reports "0 samples".
            registry.counter(SAMPLES_COUNTER)
            registry.counter(SAMPLE_SECONDS_COUNTER)
            registry.counter(ERRORS_COUNTER)

    def due(self, iteration: int) -> bool:
        return (self._last_iter is None
                or iteration - self._last_iter >= self.every_n)

    def register_card(self, name: str, card: Dict[str, Any]) -> None:
        self.cards[name] = card

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _await_tracer(self) -> None:
        """Tiny kernels over ~50 ms of the new session before the window
        opens: the CUDA tracer drops device records early in a session
        (on an H100 with torch 2.11, up to ~7 ms of them, more often
        when the process has traced before), which would otherwise be
        the step's first kernels. What is still lost is counted
        (``device_records_lost``)."""
        if self.device.type != "cuda":
            return
        x = torch.zeros(1, device=self.device)
        for _ in range(50):
            x.add_(1.0)
            time.sleep(0.001)
        self._sync()
        self._sentinel = x

    def start_window(self, iteration: int) -> bool:
        """Drain the device's queue, then begin the capture; True iff
        armed. Never raises. The cadence slot is consumed by the attempt,
        so a profiler that cannot start fails once per period."""
        from torch.profiler import ProfilerActivity, profile
        self._last_iter = iteration
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = None
        try:
            self._sync()
            prof = profile(activities=activities)
            prof.__enter__()
            self._await_tracer()
            marker = torch.profiler.record_function(WINDOW_MARKER)
            marker.__enter__()
        except Exception as e:  # noqa: BLE001
            if prof is not None:
                with contextlib.suppress(Exception):
                    prof.__exit__(None, None, None)
            self._count_error(e)
            return False
        self._window = (prof, marker, time.perf_counter())
        return True

    def abort_window(self) -> None:
        """Tear a live capture down without publishing (an exception
        between start and end). Never raises."""
        if self._window is None:
            return
        prof, marker, _ = self._window
        self._window = None
        with contextlib.suppress(Exception):
            marker.__exit__(None, None, None)
        with contextlib.suppress(Exception):
            prof.__exit__(None, None, None)

    def end_window(self, iteration: int, epoch: Optional[int] = None,
                   executable: Optional[str] = None
                   ) -> Optional[Dict[str, Any]]:
        """Close the window: synchronize the device inside it (so the
        capture covers the whole step), stop the profiler, attribute and
        publish. ``executable`` names the step's phase card. Returns the
        summary row (None on failure, counted)."""
        if self._window is None:
            return None
        prof, marker, t0 = self._window
        self._window = None
        self._last_iter = iteration
        try:
            try:
                try:
                    if self._sentinel is not None:
                        with torch.profiler.record_function(WINDOW_TAIL):
                            self._sentinel.add_(1.0)
                    self._sync()
                finally:
                    marker.__exit__(None, None, None)
                wall = time.perf_counter() - t0
            finally:
                prof.__exit__(None, None, None)
            win = window_records(prof.profiler.kineto_results.events())
            if not win.records:
                raise RuntimeError("the profiler recorded no device "
                                   "activity in the window")
            summary = summarize_records(win.records, win.labels, win.span,
                                        wall)
            summary["device_lane"] = win.lane
            summary["device_records_lost"] = win.lost
            summary["device_kind"] = self.kind
            attach_card(summary, executable, self.cards.get(executable),
                        self.peaks)
        except Exception as e:  # noqa: BLE001
            self._count_error(e)
            return None
        self._publish(summary, iteration, epoch)
        return summary

    def _publish(self, summary: Dict[str, Any], iteration: int,
                 epoch: Optional[int]) -> None:
        reg = self.registry
        if reg is not None:
            reg.counter(SAMPLES_COUNTER).inc()
            reg.counter(SAMPLE_SECONDS_COUNTER).inc(summary["wall_seconds"])
            reg.gauge(COMPUTE_FRAC_GAUGE).set(summary["device_compute_frac"])
            reg.gauge(IDLE_FRAC_GAUGE).set(summary["device_idle_frac"])
            reg.gauge(GAP_FRAC_GAUGE).set(summary["dispatch_gap_frac"])
            if summary["mfu"] is not None:
                reg.gauge(MFU_GAUGE).set(summary["mfu"])
        if self.jsonl is not None:
            self.jsonl.log(PERF_EVENT, iter=iteration, epoch=epoch,
                           **summary)

    def _count_error(self, e: BaseException) -> None:
        if self.registry is not None:
            self.registry.counter(ERRORS_COUNTER).inc()
        if not self._warned:
            self._warned = True
            warnings.warn(
                f"perf profiling sample failed ({type(e).__name__}: "
                f"{e}); further failures are counted silently "
                f"(perf/errors)")
