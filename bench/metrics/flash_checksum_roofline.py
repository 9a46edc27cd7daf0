"""flash_checksum (B5): the least time of every prefill attention launch of
the window over the traced device time of its kernel."""
from bench.lib import arith


def read(ctx):
    if ctx.trace is None:
        return None
    spent = ctx.trace.device_seconds(ctx.metric.extra["kernels"])
    if spent <= 0:
        return None
    least = sum(arith.flash_least_s(ctx.run, b.size, b.prompt_len, ctx.checked,
                                    ctx.layout)
                for b in ctx.batches)
    return 100.0 * least / spent
