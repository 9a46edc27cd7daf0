"""The synthetic token stream and the host-sharded, prefetching loader of
the LM train step (the JAX package's ``repro/data``).  ``make_batch_specs``
belongs to the dry run and is not here."""
from .loader import Prefetcher, ShardedLoader  # noqa: F401
from .synthetic import SyntheticLM  # noqa: F401
