"""Host-clock ms of the window's prefill calls (each closed by a
synchronisation) per 1000 prompt tokens."""


def read(ctx):
    tokens = sum(b.size * b.prompt_len for b in ctx.batches)
    return 1e3 * sum(b.prefill_s for b in ctx.batches) / (tokens / 1e3)
