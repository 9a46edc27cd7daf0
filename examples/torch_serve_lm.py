"""End-to-end driver 3: batched serving with KV cache + fused ABFT checks
on every decode step (the paper's error detection running live in an
inference server loop) — PyTorch port of ``examples/serve_lm.py``.

On the card every dense product runs on the hand-written checked matmul
kernel and prefill attention on the checksummed flash-attention kernel.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma-2b \\
        --new 32                                              # GPU
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

Without ``--device cpu`` it runs on the card and raises when there is none.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.transformer import init_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--mode", default="fused",
                    choices=["none", "split", "fused"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(get_config(args.arch))
    abft = ABFTConfig(mode=args.mode, threshold=5e-2, relative=True)
    params = init_model(cfg, 0, device=dev)
    rng = np.random.default_rng(0)

    cache_len = args.prompt + args.new
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt)).astype(
            np.int32)).to(dev)}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.from_numpy(rng.normal(
            size=(args.batch, args.prompt, cfg.d_model)).astype(
                np.float32)).to(dev)

    prefill = make_prefill_step(cfg, abft, cache_len)
    decode = make_decode_step(cfg, abft)

    def sync():
        # eager launches are asynchronous: a clock read waits for them
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.time()
    logits, states, m = prefill(params, batch)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    sync()
    t_prefill = time.time() - t0
    print(f"prefill {args.batch}×{args.prompt}: {t_prefill*1e3:.0f} ms  "
          f"abft_flag={bool(m['abft_flag'])}")

    out_tokens = [tok]
    flags = 0
    sync()
    t0 = time.time()
    for i in range(args.new - 1):
        logits, states, m = decode(params, states, tok, args.prompt + i)
        flags += int(bool(m["abft_flag"]))
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        out_tokens.append(tok)
    sync()
    dt = time.time() - t0
    toks = torch.cat(out_tokens, dim=1).cpu().numpy()
    print(f"decoded {args.new} tokens × {args.batch} seqs in {dt:.2f}s "
          f"({dt/max(args.new-1,1)*1e3:.1f} ms/step), ABFT flags: {flags}")
    print(f"sample continuation (seq 0): {toks[0][:16].tolist()}")


if __name__ == "__main__":
    main()
