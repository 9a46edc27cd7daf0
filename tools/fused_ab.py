#!/usr/bin/env python3
"""B2 (``gcn_fused``) and B3 (``gcn_network``) of several checkouts timed
with one yardstick, side by side on one NVIDIA GPU.

    python3 tools/fused_ab.py PARENT . . PARENT    # roots of checkouts

Each root runs in a process of its own, in the order given, with its own
``src/`` first on the path, so its kernels are built from its own sources
into its own ``build/``.  The operands are the served fused batch's, made
by this checkout's ``chip_smoke.py`` (Cora's widths 1433 -> 16 -> 7, the
same seeds, block 128): B2 at layer 0 (F 1433, G 16) and layer 1 (F 16,
G 8), and B3 over both layers; where the root has it, B2's combination
alone (``combine_device_ms``).  For each root and launch: ``ms`` as
``chip_smoke.py`` times every kernel (10 back-to-back launches after 2
warm-up ones, CUDA events), ``ms_50`` (50 launches), ``device_ms`` (20
launches replayed from a CUDA graph: no host dispatch between them), the
largest difference from the root's plain version, and a digest of the
outputs (equal digests: equal bits).  Prints one JSON object per root,
then the card's name and power limit (the harness: ``tools/_ab.py``).
"""
from __future__ import annotations

import hashlib
import os
import sys

import _ab


def _digest(tensors) -> str:
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                   for t in tensors)).hexdigest()[:16]


def measure(root: str) -> dict:
    cs = _ab.chip_smoke(root)
    import torch
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine import fold_w_r
    from repro_torch.engine.streaming import packed_step_args
    from repro_torch.kernels.gcn_fused import kernel
    from repro_torch.kernels.gcn_fused.ops import _network_weights

    _stream, batches = cs.make_stream_batches(cs.SERVE["block"])
    layers = fold_w_r(cs.make_params(torch),
                      ABFTConfig(mode="fused"))["layers"]
    cols, vals, _seg, h0 = packed_step_args(batches[0], "cuda")
    res = dict(root=root, package=os.path.dirname(kernel.__file__))

    def timed(launch, plain):
        got = launch()
        err = max(cs.max_err(a, b) for a, b in zip(got, plain())
                  if a is not None and b is not None)
        return dict(ms=cs.time_ms(launch), ms_50=cs.time_ms(launch, reps=50),
                    device_ms=cs.device_ms(launch, reps=20),
                    max_abs_err=err,
                    digest=_digest([t for t in got if t is not None]))

    block = tuple(vals.shape[2:])
    for ell, (h, _x, _xr, w, wr) in enumerate(
            cs.layer_operands(torch, cols, vals, h0, layers)):
        res[f"b2_layer{ell}"] = dict(f=h.shape[1], g=w.shape[1], **timed(
            lambda: kernel.gcn_fused_kernel(cols, vals, h, w, wr),
            lambda: kernel.gcn_fused_plain(cols, vals, h, w, wr)))
        if hasattr(kernel, "gcn_fused_combine"):   # phase A alone
            res[f"b2_layer{ell}"]["combine_device_ms"] = cs.device_ms(
                lambda: kernel.gcn_fused_combine(h, w, wr, block=block),
                reps=20)
    wps, wrps = _network_weights([la["w"] for la in layers],
                                 [la["w_r"] for la in layers], 128)
    res["b3"] = timed(
        lambda: kernel.gcn_network_kernel(cols, vals, h0, wps, wrps)[:3],
        lambda: kernel.gcn_network_plain(cols, vals, h0, wps, wrps)[:3])
    return res


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, measure))
