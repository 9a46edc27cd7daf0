"""90th percentile of time to first token over every request of the window
(each request of a batch waits its batch's prefill)."""


def read(ctx):
    xs = sorted((b.t_first - b.t_start) * 1e3 for b in ctx.batches
                for _ in range(b.size))
    pos = 0.9 * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
