"""matmul_abft (B4, dense and grouped): the least time of every product of
the window, with the checks' extra column where the cell checks, over the
traced device time of its kernels."""
from bench.lib import arith


def read(ctx):
    if ctx.trace is None:
        return None
    spent = ctx.trace.device_seconds(ctx.metric.extra["kernels"])
    if spent <= 0:
        return None
    least = sum(arith.matmul_least_s(ctx.run, b.size, b.prompt_len, b.new,
                                     ctx.checked, ctx.layout)
                for b in ctx.batches)
    return 100.0 * least / spent
