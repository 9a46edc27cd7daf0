"""Checkpoints of trees of tensors: per-host npz shards and a manifest in
the JAX package's layout (``ckpt``), and restore with a placement per leaf
(``elastic``)."""
from .ckpt import (  # noqa: F401
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
from .elastic import reshard_restore  # noqa: F401
