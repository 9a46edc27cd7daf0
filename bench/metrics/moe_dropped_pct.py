"""The MoE block's dropped assignments (past their expert's capacity) over
its assignments, from the program's ``moe.assignments`` and ``moe.kept``
counters of the traced window."""


def read(ctx):
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    c = spans.read()
    if not c.get("moe.assignments"):
        return None
    return 100.0 * (c["moe.assignments"] - c["moe.kept"]) \
        / c["moe.assignments"]
