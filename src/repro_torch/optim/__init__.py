"""The optimizer stack of the LM train step: AdamW, global-norm clipping,
the cosine-warmup schedule and int8 gradient compression with error
feedback.

Counterpart of the JAX package's ``repro/optim``, with its arithmetic:
params and optimizer state are trees (nested dicts and lists) of tensors,
``m`` and ``v`` in float32, ``step`` a 0-d int32 tensor on the params'
device.
"""
from .adamw import (AdamWConfig, adamw_init, adamw_leaf,  # noqa: F401
                    adamw_scalars, adamw_update)
from .clip import clip_by_global_norm, clip_scale, global_norm  # noqa: F401
from .compression import (  # noqa: F401
    compress_int8,
    decompress_int8,
    ef_compress_grads,
    ef_compress_leaf,
)
from .schedule import cosine_warmup  # noqa: F401
from .tree import tree_leaves, tree_map, tree_unflatten  # noqa: F401
