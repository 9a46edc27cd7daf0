"""Self time of the guard's ``repro.guard.verdict`` spans (the flag read,
which waits for the card, and the adjudication after it) over the time of
the ``repro.engine.*`` spans: how far the host ran ahead of the card."""
from bench.lib import spans

spans.install()


def read(ctx):
    s = spans.of(ctx)
    if s is None:
        return None
    steps_s = s.total(spans.ENGINE, "inclusive_s")
    if steps_s <= 0:
        return None
    return 100.0 * s.total("repro.guard.verdict") / steps_s
