"""Tokens per second: every prompt and generated token of the window over
the host-clock time from its start to its last completion."""


def read(ctx):
    tokens = sum(b.size * (b.prompt_len + b.new) for b in ctx.batches)
    return tokens / ctx.window_s
