#!/usr/bin/env python3
"""B1 (``spmm_abft``) of several checkouts timed with one yardstick, side by
side on one NVIDIA GPU.

    python3 tools/spmm_ab.py PARENT . . PARENT     # roots of checkouts

Each root runs in a process of its own, in the order given, with its own
``src/`` first on the path, so its kernels are built from its own sources
into its own ``build/``.  The operands are the served two-pass batch's, made
by this checkout's ``chip_smoke.py`` (Cora's widths, the same seeds):
layer 0 (G 16) and layer 1 (G 8).  For each root and layer: ``ms`` as
``chip_smoke.py`` times every kernel (10 back-to-back launches after 2
warm-up ones, CUDA events), ``ms_50`` (50 launches), ``device_ms`` (20
launches replayed from a CUDA graph: no host dispatch between them) and
the largest difference from the plain version.  Prints one JSON object per
root, then the card's name and power limit (the harness: ``tools/_ab.py``).
"""
from __future__ import annotations

import os
import sys

import _ab


def measure(root: str) -> dict:
    cs = _ab.chip_smoke(root)
    import torch
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine import fold_w_r
    from repro_torch.engine.streaming import packed_step_args
    from repro_torch.kernels.spmm_abft import kernel

    _stream, batches = cs.make_stream_batches(cs.SERVE["block"])
    layers = fold_w_r(cs.make_params(torch),
                      ABFTConfig(mode="fused"))["layers"]
    cols, vals, _seg, h0 = packed_step_args(batches[0], "cuda")
    res = dict(root=root, package=os.path.dirname(kernel.__file__))
    for ell, (_h, x, xr, _w, _wr) in enumerate(
            cs.layer_operands(torch, cols, vals, h0, layers)):
        def launch():
            return kernel.spmm_abft_kernel(cols, vals, x, xr)
        err = max(cs.max_err(a, b) for a, b in zip(
            launch(), kernel.spmm_abft_plain(cols, vals, x, xr)))
        res[f"layer{ell}"] = dict(
            g=x.shape[1], ms=cs.time_ms(launch),
            ms_50=cs.time_ms(launch, reps=50),
            device_ms=cs.device_ms(launch, reps=20), max_abs_err=err)
    return res


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, measure))
