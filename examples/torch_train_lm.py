"""End-to-end driver 2: train an LM (reduced config of any assigned arch)
on the synthetic token stream, ABFT-checked, with checkpoint/restore —
PyTorch port of ``examples/train_lm.py``.

The step is ``launch.steps.make_train_step`` run eagerly: on the card
every product, forward and backward, runs on the hand-written checked
matmul kernel and prefill attention on the checksummed flash-attention
kernel.  Checkpoints are the reference's layout, so either package
restores the other's.

    PYTHONPATH=src python examples/torch_train_lm.py --arch gemma-2b \\
        --steps 200                                           # GPU
    PYTHONPATH=src python examples/torch_train_lm.py --arch deepseek-moe-16b \\
        --steps 50 --width 128   # MoE routing exercised end to end
    PYTHONPATH=src python examples/torch_train_lm.py --steps 4 --batch 2 \\
        --seq 16 --device cpu

Without ``--device cpu`` it runs on the card and raises when there is none.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig, tree_leaves
from repro_torch.runtime import ABFTGuard, StragglerWatchdog


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--width", type=int, default=0,
                    help="override d_model for a bigger run")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--mode", default="fused",
                    choices=["none", "split", "fused"])
    ap.add_argument("--ckpt", default="results/ckpt_lm")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(get_config(args.arch))
    over = {}
    if args.width:
        over["d_model"] = args.width
        over["head_dim"] = max(16, args.width // cfg.n_heads)
    if args.layers:
        over["n_layers"] = args.layers
    if over:
        cfg = dataclasses.replace(cfg, **over)
    abft = ABFTConfig(mode=args.mode, threshold=5e-2, relative=True)

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       batch_size=args.batch, seed=0)
    it = data.batches()

    state = init_train_state(cfg, 0, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M abft={args.mode}")

    step_fn = make_train_step(cfg, abft, AdamWConfig(lr=1e-3),
                              total_steps=args.steps, warmup=20)
    ckpt = CheckpointManager(args.ckpt, keep=2)
    restored, at = ckpt.restore(state)
    if restored is not None:
        state = restored
        print(f"restored from step {at}")

    def sync():
        # eager launches are asynchronous: a clock read waits for them
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    guard = ABFTGuard()
    wd = StragglerWatchdog()
    losses = []
    sync()
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(it).items()}
        if cfg.family == "encdec":
            batch["src_embeds"] = torch.from_numpy(
                np.random.default_rng(i).normal(
                    size=(args.batch, args.seq, cfg.d_model)).astype(
                        np.float32)).to(dev)
        elif cfg.frontend:
            batch["prefix_embeds"] = torch.zeros(
                (args.batch, 4, cfg.d_model), dtype=torch.float32,
                device=dev)
        sync()
        wd.start()
        state, m = guard.run_step(lambda s, b=batch: step_fn(s, b), state)
        sync()
        slow = wd.stop()
        losses.append(float(m["loss"]))
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"gnorm={float(m['grad_norm']):.2f} "
                  f"abft_rel={float(m['abft_max_rel']):.1e} "
                  f"{'SLOW' if slow else ''}")
        if i and i % 100 == 0:
            ckpt.save(i, state)
    ckpt.save(args.steps, state)
    ckpt.wait()
    sync()
    dt = time.time() - t0
    improved = losses[-1] < losses[0] - 0.1
    print(f"\n{args.steps} steps in {dt:.1f}s ({dt/args.steps*1e3:.0f} "
          f"ms/step); loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(improved: {improved}); ABFT flags: {guard.flags}")


if __name__ == "__main__":
    main()
