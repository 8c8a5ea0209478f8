"""Serving fleet: router + shared L2 cache + rolling-swap controller +
supervisor (the port's copies of the JAX package's ``serve/fleet/``).

router/l2cache/controller/supervisor are stdlib + numpy only and load
by file path without importing torch; importing them through this
package is the convenient path for code that already imports the port.
``replica`` is not imported here: it is a worker entry point that builds
a full engine (``python -m howtotrainyourmamlpytorch_tpu_torch.serve.fleet.replica``).
"""

from howtotrainyourmamlpytorch_tpu_torch.serve.fleet.controller import (
    FleetController,
    advise,
)
from howtotrainyourmamlpytorch_tpu_torch.serve.fleet.l2cache import (
    L2AdaptedParamsCache,
)
from howtotrainyourmamlpytorch_tpu_torch.serve.fleet.router import (
    FailoverPolicy,
    FleetRouter,
    HashRing,
    ReplicaBreaker,
    ReplicaLease,
    assign_canary,
    canary_fraction,
    read_members,
    routing_key,
)
from howtotrainyourmamlpytorch_tpu_torch.serve.fleet.supervisor import (
    CrashLoopBreaker,
    ReplicaSupervisor,
)

__all__ = [
    "CrashLoopBreaker", "FailoverPolicy", "FleetController",
    "FleetRouter", "HashRing", "L2AdaptedParamsCache", "ReplicaBreaker",
    "ReplicaLease", "ReplicaSupervisor", "advise", "assign_canary",
    "canary_fraction", "read_members", "routing_key",
]
