"""Model FLOPs of the window's work over its seconds, as a share of the
card's float32 peak."""
from bench.lib import arith


def read(ctx):
    flops = sum(arith.model_flops(ctx.run, b.size, b.prompt_len, b.new,
                                   ctx.layout)
                for b in ctx.batches)
    return 100.0 * flops / ctx.window_s / arith.PEAK_F32_FLOPS
