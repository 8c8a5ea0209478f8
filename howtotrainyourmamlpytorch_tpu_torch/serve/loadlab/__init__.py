"""Traffic lab: record, synthesize and replay request traffic (the
port's copies of the JAX package's ``serve/loadlab/``).

* ``trace.py`` — the CRC-framed trace file of (arrival, tenant, bucket,
  deadline, seed) records;
* ``workloads.py`` — the synthetic request generators
  (``synthetic_arrays`` / ``tenant_pool``) and traffic synthesizers
  (diurnal ramps, tenant churn, bursts); same seed, same trace;
* ``replay.py`` — open-loop replay off the trace clock.

Each module is stdlib + numpy only and loads by file path without
importing torch.
"""
