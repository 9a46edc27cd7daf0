"""Device-idle time whose gap midpoint falls, on the host, inside a
``repro.moe.*`` span as the innermost program span, over the traced
window: the card's idle share that the MoE block's host work leaves."""
from bench.lib import spans

spans.install()


def read(ctx):
    s = spans.of(ctx)
    if s is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * s.total("repro.moe.", "idle_s") / ctx.trace.window_s
