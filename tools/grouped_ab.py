#!/usr/bin/env python3
"""B4 (``matmul_abft``) of several checkouts launched without row counts,
side by side on one NVIDIA GPU: every launch must keep its bits.

    python3 tools/grouped_ab.py PARENT . . PARENT    # roots of checkouts

Each root runs in a process of its own, in the order given, with its own
``src/`` first on the path, so its kernels are built from its own sources
into its own ``build/``.  For each root, a digest of the outputs (C, block
sums, extra column) of every launch ``chip_smoke.py`` makes, each shape's
operands from a generator of its own, the same in every root, in float32
and bfloat16: the single product at every LM launch shape (``lm_kernels``:
gemma-2b's and each ``ARCHS`` model's prefill and decode products) and its
ragged shapes; the grouped launch at every served expert and RG-LRU gate
shape and its ragged shapes; the backward launches (``lm_grads``,
``lm_train``: dA = dC·Bᵀ and dB = Aᵀ·dC of gemma-2b's prefill products,
both grouped ones of each served expert shape); and one over all of them
(``digest_all``).  The served expert shapes' and gemma-2b's product
shapes' device ms (CUDA-graph replay, f32, no row counts) beside them.  Then deepseek-moe-16b and qwen3-moe-30b-a3b
served at full width as ``lm_archs`` serves them (``ARCHS``: seed-0
weights, the guarded engine, B 2 × prompt 512, 8 greedy decode steps): a
digest of every step's logits and tokens, and the guard's counts.  Prints
one JSON object per root, then the card's name and power limit (the
harness: ``tools/_ab.py``).
"""
from __future__ import annotations

import gc
import hashlib
import os
import sys

import _ab

MOE_ARCHS = ("deepseek-moe-16b", "qwen3-moe-30b-a3b")


def _digest(torch, outs) -> str:
    return hashlib.sha256(b"".join(
        x.float().cpu().numpy().tobytes() for x in outs if x is not None)
    ).hexdigest()[:16]


def single_shapes(cs):
    """(M, K, N, trans_b) of every single B4 launch ``chip_smoke.py``
    holds, and the backward launches of gemma-2b's prefill products."""
    shapes = list(cs.lm_matmul_shapes(cs.lm_config()))
    for spec in cs.ARCHS:
        cfg = cs.arch_config(spec["arch"], spec.get("layers"))
        for key in cs.lm_matmul_shapes(cfg, spec["batch"], spec["prompt"],
                                       spec.get("src", 0),
                                       spec.get("prefix", 0)):
            if key not in shapes:
                shapes.append(key)
    shapes += list(cs.MATMUL_RAGGED)
    backward = []
    for m, k, n, tb in cs.lm_matmul_shapes(cs.lm_config()):
        if m > 16:
            # C = A·B: dA = dC·Bᵀ, dB = Aᵀ·dC; C = A·Wᵀ: dA = dC·W,
            # dW = dCᵀ·A (ops.MatmulAbftFunction)
            backward += [(m, n, k, not tb),
                         (n, m, k, False) if tb else (k, m, n, False)]
    return shapes + [s for s in backward if s not in shapes]


def grouped_shapes(cs):
    """(G, M, K, N, trans_b) of every grouped launch ``chip_smoke.py``
    holds: the served expert and gate shapes, the ragged ones at 5 groups,
    and both backward launches of each served expert shape."""
    shapes, served = [], []
    for spec in cs.ARCHS:
        cfg = cs.arch_config(spec["arch"], spec.get("layers"))
        for g, m, k, n in cs.lm_grouped_shapes(cfg, spec["batch"],
                                               spec["prompt"]):
            if (g, m, k, n, False) not in shapes:
                shapes.append((g, m, k, n, False))
                if cfg.moe is not None:
                    served.append((g, m, k, n, False))
    shapes += [(5, m, k, n, False) for m, k, n in cs.GROUPED_RAGGED]
    for g, m, k, n, _ in served:
        # da = dc·bᵀ (b as it lies, trans_b), db = aᵀ·dc
        shapes += [(g, m, n, k, True), (g, k, m, n, False)]
    return shapes, served


def measure(root: str) -> dict:
    cs = _ab.chip_smoke(root)
    import torch
    from repro_torch.kernels.matmul_abft import kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    dtypes = (torch.float32, torch.bfloat16)
    digests, single_ms = {}, {}
    gemma = list(cs.lm_matmul_shapes(cs.lm_config()))
    for i, (m, k, n, tb) in enumerate(single_shapes(cs)):
        gen = torch.Generator(device="cuda").manual_seed(1000 + i)
        for dt in dtypes:
            a = torch.randn(m, k, generator=gen, device="cuda").to(dt)
            b = (torch.randn(*((n, k) if tb else (k, n)), generator=gen,
                             device="cuda") * k ** -0.5).to(dt)
            br = b.float().sum(dim=0 if tb else 1).contiguous()

            def launch():
                return kernel.matmul_abft_kernel(a, b, br, trans_b=tb)
            digests[f"single {m}x{k}x{n} trans_b={tb} {dt}"] = _digest(
                torch, launch())
            if dt == torch.float32 and (m, k, n, tb) in gemma:
                single_ms[f"{m}x{k}x{n} trans_b={tb}"] = cs.device_ms(
                    launch, reps=5)
            del a, b
    shapes, served = grouped_shapes(cs)
    timed = {}
    for i, (g, m, k, n, tb) in enumerate(shapes):
        gen = torch.Generator(device="cuda").manual_seed(2000 + i)
        for dt in dtypes:
            a = torch.randn(g, m, k, generator=gen, device="cuda").to(dt)
            b = (torch.randn(*((g, n, k) if tb else (g, k, n)),
                             generator=gen, device="cuda")
                 * k ** -0.5).to(dt)
            br = b.float().sum(dim=1 if tb else 2).contiguous()

            def launch():
                return kernel.matmul_abft_grouped_kernel(a, b, br,
                                                         trans_b=tb)
            digests[f"grouped {g}x{m}x{k}x{n} trans_b={tb} {dt}"] = \
                _digest(torch, launch())
            if dt == torch.float32 and (g, m, k, n, tb) in served:
                timed[f"{g}x{m}x{k}x{n}"] = cs.device_ms(launch, reps=5)
            del a, b
    every = hashlib.sha256("".join(digests.values()).encode()).hexdigest()
    return dict(root=root, package=os.path.dirname(kernel.__file__),
                launches=len(digests), digest_all=every[:16],
                grouped_device_ms=timed, single_device_ms=single_ms,
                served=served_logits(cs, torch), digests=digests)


def served_logits(cs, torch) -> dict:
    """The MoE models served at full width as ``lm_archs`` serves them: a
    digest of every step's logits and tokens, and the guard's counts."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine.lm import LMEngine
    from repro_torch.models.transformer import init_model

    out = {}
    for spec in cs.ARCHS:
        if spec["arch"] not in MOE_ARCHS:
            continue
        spec = {**cs.LM, **spec}
        cfg = cs.arch_config(spec["arch"], spec.get("layers"))
        params = init_model(cfg, spec["seed"], device="cuda")
        eng = LMEngine(cfg, ABFTConfig(mode="fused", threshold=1e-3,
                                       relative=True),
                       params, cache_len=spec["cache"])
        gen = torch.Generator(device="cuda").manual_seed(spec["seed"] + 1)
        tokens = torch.randint(1, cfg.vocab_size,
                               (spec["batch"], spec["prompt"]), generator=gen,
                               device="cuda", dtype=torch.int32)
        logits, toks, _ = cs.lm_trajectory(
            torch, lambda tok, inj: eng.prefill(tok)[:2],
            lambda st, tok, pos, inj: eng.decode(st, tok, pos)[:2], tokens,
            spec["new"])
        out[cfg.name] = dict(logits=_digest(torch, logits),
                             tokens=_digest(torch, toks),
                             guard=eng.stats())
        del eng, params, logits, toks
        gc.collect()
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, measure))
