"""Storage, checkpoints, event logs and the checkpoint payload's msgpack
codec (counterparts of the JAX package's ``utils/``)."""
