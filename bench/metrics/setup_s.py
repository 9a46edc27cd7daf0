"""Set-up seconds: from the process's start to the window's (imports, the
kernel library's build or load, the weights drawn, the engine built, one
warm-up batch)."""


def read(ctx):
    return ctx.setup_s
