"""CUDA runtime calls that wait for the card (``bench.lib.spans.SYNCS``)
inside the program's ``repro.engine.*`` spans, over the number of those
spans: the host syncs of one prefill or decode step."""
from bench.lib import spans

spans.install()


def read(ctx):
    s = spans.of(ctx)
    if s is None or not s.steps:
        return None
    return sum(s.syncs.values()) / s.steps
