"""Host microseconds of one checked-op wrapper call: the self time of the
``repro.op.*`` spans (``matmul_abft``, ``matmul_abft_grouped``,
``flash_checksum``: checks, the library's plan, allocation, the launch)
over their count."""
from bench.lib import spans

spans.install()


def read(ctx):
    s = spans.of(ctx)
    if s is None:
        return None
    n = sum(c for k, c in s.count.items() if k.startswith("repro.op."))
    if not n:
        return None
    return 1e6 * s.total("repro.op.") / n
