#!/usr/bin/env python3
"""rwkv6-7b's guarded prefill with the WKV scan's ``kᵀv`` and ``u·kᵀv`` made
``WKV_CHUNK`` steps at a time and all at once, side by side on one NVIDIA
GPU.

    python3 tools/wkv_chunk.py

The model is ``chip_smoke.py``'s: rwkv6-7b at its published widths, all 32
layers, float32, seeded weights, served through ``LMEngine`` (fused checks)
at its ``ARCHS`` batch and prompt (2 x 512).  After two warm-up prefills
it runs ``ROUNDS`` times four, in the order chunked, whole, whole, chunked
(``WKV_CHUNK`` the module's default, then the prompt's length), and for
each prints the host ms of the synchronised prefill, the peak of allocated
device memory during it, that peak less what was allocated before it (the
prefill's own transient), and a digest of the logits (equal digests: equal
bits, as both forms round every element alike).  Then the card's name and
power limit.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 3


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                 # puts ROOT/src on the path
    import torch

    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine.lm import LMEngine
    from repro_torch.models import rwkv6
    from repro_torch.models.transformer import init_model

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = {**cs.LM, **next(a for a in cs.ARCHS if a["arch"] == "rwkv6-7b")}
    cfg = cs.arch_config(spec["arch"])
    params = init_model(cfg, spec["seed"], device="cuda")
    eng = LMEngine(cfg, ABFTConfig(mode="fused", threshold=1e-3,
                                   relative=True), params,
                   cache_len=spec["cache"])
    gen = torch.Generator(device="cuda").manual_seed(spec["seed"] + 1)
    tokens = torch.randint(1, cfg.vocab_size, (spec["batch"],
                                               spec["prompt"]),
                           generator=gen, device="cuda", dtype=torch.int32)
    chunked = rwkv6.WKV_CHUNK

    def prefill():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, states, _ = eng.prefill(tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        digest = hashlib.sha256(logits.cpu().numpy().tobytes()).hexdigest()
        del logits, states
        return dict(host_ms=ms, peak_gb=peak / 1e9,
                    transient_gb=(peak - base) / 1e9, digest=digest[:16])

    prefill()
    prefill()
    whole = spec["prompt"]
    for chunk in (chunked, whole, whole, chunked) * ROUNDS:
        rwkv6.WKV_CHUNK = chunk
        print(json.dumps(dict(arch=cfg.name, batch=spec["batch"],
                              prompt=spec["prompt"], wkv_chunk=chunk,
                              **prefill())), flush=True)
    rwkv6.WKV_CHUNK = chunked
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
