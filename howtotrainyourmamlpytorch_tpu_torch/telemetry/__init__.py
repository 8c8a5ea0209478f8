"""Telemetry: metrics registry, instrumentation, aggregation, alerts,
timeline, training health, the perf sampler and the run report (the
port's counterpart of the JAX package's ``telemetry/``).

A port run writes the JAX package's rows and files (``events.jsonl``,
``metrics.prom``, ``trace.json``, ``PROFILE.json``), so either package's
report (``telemetry/report.py``; ``scripts/torch_telemetry_report.py``,
``scripts/telemetry_report.py``) reads it. Not here: the
``CompileWatcher`` (eager PyTorch compiles nothing).
"""

from howtotrainyourmamlpytorch_tpu_torch.telemetry.aggregate import (
    emit_heartbeat,
    heartbeat_rows,
    host_step_skew,
)
from howtotrainyourmamlpytorch_tpu_torch.telemetry.health import (
    GRAD_NORM_WARN_COUNTER,
    GRAD_NORM_WARN_EVENT,
    HEALTH_EVENT,
    publish_health,
)
from howtotrainyourmamlpytorch_tpu_torch.telemetry.instruments import (
    FeedStallMeter,
    device_memory_stats,
)
from howtotrainyourmamlpytorch_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    exponential_buckets,
)
from howtotrainyourmamlpytorch_tpu_torch.telemetry.trace import (
    build_trace,
    validate_trace,
    write_trace,
)

__all__ = [
    "Counter", "FeedStallMeter", "GRAD_NORM_WARN_COUNTER",
    "GRAD_NORM_WARN_EVENT", "Gauge", "HEALTH_EVENT", "Histogram",
    "MetricsRegistry", "build_trace", "device_memory_stats",
    "emit_heartbeat", "exponential_buckets", "heartbeat_rows",
    "host_step_skew", "publish_health", "validate_trace", "write_trace",
]
