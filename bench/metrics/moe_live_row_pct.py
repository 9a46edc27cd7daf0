"""The MoE block's live capacity rows (its kept assignments, which fill
each expert's slots from 0) over its capacity rows, from the program's
``moe.kept`` and ``moe.capacity_rows`` counters of the traced window."""


def read(ctx):
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    c = spans.read()
    if not c.get("moe.capacity_rows"):
        return None
    return 100.0 * c["moe.kept"] / c["moe.capacity_rows"]
