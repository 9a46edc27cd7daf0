"""The synthetic token stream, the dry run's input specs and the
host-sharded, prefetching loader of the LM train step (the JAX package's
``repro/data``)."""
from .loader import Prefetcher, ShardedLoader  # noqa: F401
from .synthetic import SyntheticLM, make_batch_specs  # noqa: F401
