"""Episode data: image sources, the deterministic sampler and the
prefetching loader (counterpart of the JAX package's ``data/``)."""

from howtotrainyourmamlpytorch_tpu_torch.data.sources import (
    ArraySource,
    DiskImageSource,
    SinusoidSource,
    SubsetSource,
    SyntheticSource,
    build_source,
    pack_shard_path,
    source_kind,
    split_class_names,
)
from howtotrainyourmamlpytorch_tpu_torch.data.sampler import EpisodeSampler
from howtotrainyourmamlpytorch_tpu_torch.data.loader import (
    MetaLearningDataLoader)

__all__ = [
    "ArraySource", "DiskImageSource", "SinusoidSource", "SubsetSource",
    "SyntheticSource", "build_source", "pack_shard_path", "source_kind",
    "split_class_names", "EpisodeSampler", "MetaLearningDataLoader",
]
