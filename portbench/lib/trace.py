"""The traced sub-window: ``torch.profiler`` over a few steady steps or
requests, reduced to device time by kernel family, the device's busy
time (the union of its kernels' intervals), the longest device
operations and the longest idle gaps with what the host was doing.

The kernel families are the program's own table (``telemetry/profiler.py
§ FAMILIES``), copied here so that a change to the program cannot move
the yardstick: first matching name fragment wins.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

FAMILIES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("bn_act", ("bn_act_persistent",)),
    ("pool", ("max_pool", "pool")),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "fprop", "dgrad",
              "wgrad", "winograd", "nhwc", "nchw")),
    ("gemm", ("gemm", "cutlass", "cublas", "splitk")),
    ("reduce", ("reduce", "norm")),
)
OTHER_FAMILY = "elementwise/other"
WINDOW = "portbench.window"
TOP = 10
NAME_CHARS = 120


def kernel_family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return OTHER_FAMILY


def merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of ``[start, end)`` intervals, as disjoint sorted ones."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Summary(dict):
    """What a traced sub-window gives the per-layer readers: ``window_s``,
    ``busy_s``, ``family_s`` (device seconds by family), ``kernels``
    (device records), ``device_ops`` and ``idle_gaps`` (the breakdown),
    plus whatever the driver counted in it (``tasks``, ``requests``)."""


def _cpu_ranges(events) -> List[Tuple[int, int, str]]:
    return [(e.start_ns(), e.end_ns(), e.name()) for e in events]


def reduce(events: List[Any], window: Tuple[int, int]) -> Summary:
    """Reduce raw kineto events (``kineto_results.events()``) over the
    ``window`` span (ns, the trace's clock)."""
    from torch.autograd import DeviceType
    w0, w1 = window
    kernels: List[Tuple[str, int, int]] = []
    host: List[Any] = []
    for e in events:
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            activity = getattr(e, "activity_type", lambda: "")()
            if e.is_user_annotation() or "annotation" in activity:
                continue
            s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if t > s:
                kernels.append((e.name(), s, t))
        elif kind == DeviceType.CPU:
            host.append(e)
    family: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, t in kernels:
        family[kernel_family(name)] += (t - s) * 1e-9
        by_name[name[:NAME_CHARS]] += (t - s) * 1e-9
    busy = merged([(s, t) for _, s, t in kernels])
    gaps = []
    prev = w0
    for s, t in busy:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((w1 - prev, prev))
    gaps.sort(reverse=True)
    ranges = _cpu_ranges(host)
    idle = []
    for length, at in gaps[:TOP]:
        inside = [(e - s, n) for s, e, n in ranges
                  if s <= at < e and n != WINDOW]
        label = min(inside)[1] if inside else "host: nothing recorded"
        idle.append([label[:NAME_CHARS], length * 1e-9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(t - s for s, t in busy) * 1e-9,
        family_s=dict(family), kernels=len(kernels),
        device_ops=[[n, v] for n, v in top], idle_gaps=idle)


def traced(run: Callable[[], Dict[str, Any]], device) -> Summary:
    """Run ``run()`` (the sub-window's work, which returns its counts)
    under the profiler, synchronized on both sides, inside the
    :data:`WINDOW` range, and reduce what was recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            counts = run()
            torch.cuda.synchronize(device)
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    spans = [(e.start_ns(), e.end_ns()) for e in events
             if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not spans:
        raise RuntimeError("the profiler recorded no window range")
    summary = reduce(events, spans[0])
    summary.update(counts)
    return summary


@contextlib.contextmanager
def host_range(name: str):
    """A host range the idle gaps are labelled by, recorded only while
    the profiler records."""
    import torch
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(name):
            yield
    else:
        yield
