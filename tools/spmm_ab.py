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
root, then the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                 # puts ROOT/src on the path
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
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


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    for root in sys.argv[1:] or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
