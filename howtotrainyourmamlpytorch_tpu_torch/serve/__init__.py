"""Few-shot serving: batcher, adapted-params cache, adapt/predict, engine."""

from howtotrainyourmamlpytorch_tpu_torch.serve.batcher import (
    BucketError, FewShotRequest, QueueFullError, RequestBatcher, pad_group)
from howtotrainyourmamlpytorch_tpu_torch.serve.cache import (
    AdaptedParamsLRU, support_fingerprint)
from howtotrainyourmamlpytorch_tpu_torch.serve.engine import (
    FewShotResponse, ServingEngine)

__all__ = ["AdaptedParamsLRU", "BucketError", "FewShotRequest",
           "FewShotResponse", "QueueFullError", "RequestBatcher",
           "ServingEngine", "pad_group", "support_fingerprint"]
