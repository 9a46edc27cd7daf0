#!/usr/bin/env python3
"""B5 (``flash_checksum``) of several checkouts timed with one yardstick,
side by side on one NVIDIA GPU.

    python3 tools/flash_ab.py PARENT . . PARENT    # roots of checkouts

Each root runs in a process of its own, in the order given, with its own
``src/`` first on the path, so its kernels are built from its own sources
into its own ``build/``.  The operands are the served prefill attention's
shape — gemma-2b (``chip_smoke.py``'s ``LM``: B 2, T = S 512, H 8, Kh 1,
dh 256), float32, with the carried column — drawn from one seeded
generator, the same in every root.  For each root: ``ms`` as
``chip_smoke.py`` times every kernel (10 back-to-back launches after 2
warm-up ones, CUDA events), ``ms_50`` (50 launches), ``device_ms`` (20
launches replayed from a CUDA graph), the largest difference from the
root's plain version, and a digest of o and o_extra (equal digests: equal
bits).  Then every other shape and mask ``chip_smoke.py`` launches B5 at,
each from a generator of its own, in float32 and bfloat16: the served
prefill attention of each model in its ``ARCHS`` (danube's window, the
hybrid's local window, whisper's non-causal encoder and cross-attention),
and the small ragged causal, windowed and non-causal shapes — a digest
each, and one over all of them (``digest_all``).  Prints one JSON object
per root, then the card's name and power limit (the harness:
``tools/_ab.py``).
"""
from __future__ import annotations

import hashlib
import os
import sys

import _ab


def measure(root: str) -> dict:
    cs = _ab.chip_smoke(root)
    import torch
    from repro_torch.kernels.flash_checksum import kernel

    cfg = cs.lm_config()
    b, t, h, kh, dh = cs.LM["batch"], cs.LM["prompt"], cfg.n_heads, \
        cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    q, k, v, vr = rnd(b, t, h, dh), rnd(b, t, kh, dh), rnd(b, t, kh, dh), \
        rnd(b, t, h)

    def launch():
        return kernel.flash_checksum_kernel(q, k, v, vr)
    got = launch()
    err = max(cs.max_err(x, y) for x, y in zip(
        got, kernel.flash_checksum_plain(q, k, v, vr)))
    digest = hashlib.sha256(b"".join(x.cpu().numpy().tobytes()
                                     for x in got)).hexdigest()[:16]
    bound, by, _n_bytes, _n_ops = cs.flash_bound(torch, b, t, t, h, kh, dh,
                                                 torch.float32)
    shapes = {}
    for i, (shape, causal, window) in enumerate(other_shapes(cs)):
        sgen = torch.Generator(device="cuda").manual_seed(100 + i)
        for dt in (torch.float32, torch.bfloat16):
            bb, tt, ss, hh, kk, dd = shape

            def draw(*dims):
                return torch.randn(*dims, generator=sgen,
                                   device="cuda").to(dt)
            ops = (draw(bb, tt, hh, dd), draw(bb, ss, kk, dd),
                   draw(bb, ss, kk, dd), draw(bb, ss, hh))
            out = kernel.flash_checksum_kernel(*ops, causal=causal,
                                               window=window)
            key = f"{shape} causal={causal} window={window} {dt}"
            shapes[key] = hashlib.sha256(b"".join(
                x.float().cpu().numpy().tobytes() for x in out)
            ).hexdigest()[:16]
    every = hashlib.sha256("".join(shapes.values()).encode()).hexdigest()
    return dict(root=root, package=os.path.dirname(kernel.__file__),
                shape=dict(b=b, t=t, s=t, h=h, kh=kh, dh=dh),
                ms=cs.time_ms(launch), ms_50=cs.time_ms(launch, reps=50),
                device_ms=cs.device_ms(launch, reps=20), bound_ms=bound,
                bound_by=by, max_abs_err=err, digest=digest,
                digest_all=every[:16], shapes=shapes)


def other_shapes(cs):
    """((B, T, S, H, Kh, dh), causal, window) of every other B5 launch
    ``chip_smoke.py`` holds: each served prefill attention of ``ARCHS``,
    then its small ragged causal, windowed and non-causal shapes."""
    out = []
    for spec in cs.ARCHS:
        cfg = cs.arch_config(spec["arch"], spec.get("layers"))
        if "attn" not in cfg.block_pattern:
            continue
        ta = spec.get("prefix", 0) + spec["prompt"]
        window = cfg.local_window if len(cfg.block_pattern) > 1 \
            else cfg.window
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        out.append(((spec["batch"], ta, ta, *heads), True, window))
        if cfg.family == "encdec":
            src = spec["src"]
            out += [((spec["batch"], src, src, *heads), False, 0),
                    ((spec["batch"], spec["prompt"], src, *heads), False, 0)]
    out += [(s, True, 0) for s in cs.FLASH_RAGGED]
    out += [(s, True, w) for s, windows in cs.FLASH_WINDOWED
            for w in windows]
    out += [(s, False, 0) for s in cs.FLASH_NONCAUSAL_RAGGED]
    return out


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, measure))
