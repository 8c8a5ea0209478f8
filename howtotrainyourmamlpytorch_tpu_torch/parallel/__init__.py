"""The device mesh over ranks and the multi-process agreement around it
(the port's counterpart of the JAX package's ``parallel/``); the
warm-start store of CUDA-graph executables is ``parallel/aot.py``."""

from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import (
    Mesh,
    MeshPlan,
    batch_positions,
    degraded_mesh_shape,
    derive_degraded_config,
    make_mesh,
    make_sharded_steps,
)
from howtotrainyourmamlpytorch_tpu_torch.parallel.multihost import (
    abort_all_if_any,
    agree_int_from_main,
    any_process_true,
    any_process_true_each,
    assemble_global_batch,
    barrier,
    gather_host_floats,
    gather_host_ints,
    initialize_distributed,
    local_batch_positions,
)

__all__ = [
    "Mesh", "MeshPlan", "batch_positions", "degraded_mesh_shape",
    "derive_degraded_config", "make_mesh", "make_sharded_steps",
    "abort_all_if_any", "agree_int_from_main", "any_process_true",
    "any_process_true_each", "assemble_global_batch", "barrier",
    "gather_host_floats", "gather_host_ints", "initialize_distributed",
    "local_batch_positions",
]
