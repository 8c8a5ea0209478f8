"""Few-shot serving: batcher, adapted-params cache, adapt/predict, the
engine, and the fleet (``serve.fleet``: router, L2 tier, rolling-swap
controller, supervisor, replica worker) with its traffic lab
(``serve.loadlab``)."""

from howtotrainyourmamlpytorch_tpu_torch.serve.batcher import (
    AdmissionController,
    BucketError,
    FewShotRequest,
    QueueFullError,
    RequestBatcher,
    ShedError,
    estimate_queue_wait,
    pad_group,
)
from howtotrainyourmamlpytorch_tpu_torch.serve.cache import (
    AdaptedParamsLRU,
    support_fingerprint,
)
from howtotrainyourmamlpytorch_tpu_torch.serve.engine import (
    FewShotResponse,
    ServingEngine,
)

__all__ = [
    "AdaptedParamsLRU", "AdmissionController", "BucketError",
    "FewShotRequest", "FewShotResponse", "QueueFullError",
    "RequestBatcher", "ServingEngine", "ShedError",
    "estimate_queue_wait", "pad_group", "support_fingerprint",
]
