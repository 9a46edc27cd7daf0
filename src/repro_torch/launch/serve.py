"""Serving entry point: batched prefill + greedy decode loop with
ABFT-checked steps, for every architecture the port runs.

Counterpart of the JAX package's ``repro/launch/serve.py``.  It feeds an
encoder-decoder (whisper) its ``src_embeds`` (``--prompt`` seeded normal
frames, the audio front end's stub) and a model with another front end
(internvl2) 8 zero ``prefix_embeds`` before the prompt (the vision front
end's stub; decode positions then start after them).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
        --smoke --batch 4 --prompt 64 --new 64 --abft fused    # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \\
        --smoke --device cpu                 # plain versions, on the CPU

Without ``--device cpu`` it runs on the card and raises when there is none.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.transformer import init_model

PREFIX = 8          # the stub front end's prefix embeddings


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--new", type=int, default=64)
    ap.add_argument("--abft", default="fused",
                    choices=["none", "split", "fused"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    abft = ABFTConfig(mode=args.abft, threshold=5e-2, relative=True)
    params = init_model(cfg, 0, device=dev)
    rng = np.random.default_rng(0)

    cache_len = args.prompt + args.new
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt)).astype(np.int32)).to(
            dev)}
    prefix = cfg.frontend and cfg.family != "encdec"
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.from_numpy(rng.normal(
            size=(args.batch, args.prompt, cfg.d_model)).astype(
                np.float32)).to(dev)
    elif prefix:
        batch["prefix_embeds"] = torch.zeros(
            (args.batch, PREFIX, cfg.d_model), dtype=torch.float32,
            device=dev)
        cache_len += PREFIX

    prefill = make_prefill_step(cfg, abft, cache_len)
    decode = make_decode_step(cfg, abft)

    t0 = time.perf_counter()
    logits, states, m = prefill(params, batch)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_flag = bool(m["abft_flag"])
    print(f"prefill: {prefill_s:.2f}s flag={prefill_flag}")
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    pos0 = args.prompt + (PREFIX if prefix else 0)
    t0 = time.perf_counter()
    flags = 0
    for i in range(args.new - 1):
        logits, states, m = decode(params, states, tok, pos0 + i)
        flags += int(bool(m["abft_flag"]))
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"decode: {args.new - 1} steps in {dt:.2f}s "
          f"({dt / max(args.new - 1, 1) * 1e3:.1f} ms/tok/batch), "
          f"flags={flags}")
    return {"model": cfg.name, "device": str(dev),
            "prefill_flag": prefill_flag, "decode_flags": flags,
            "logits_shape": tuple(logits.shape),
            "finite": bool(torch.isfinite(logits[..., :cfg.vocab_size])
                           .all()),
            "prefill_s": prefill_s, "decode_s": dt}


if __name__ == "__main__":
    main()
