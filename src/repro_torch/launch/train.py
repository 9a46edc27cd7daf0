"""Training driver: guarded train steps over the synthetic token stream,
with checkpoints to stop and resume.

Counterpart of the JAX package's ``repro/launch/train.py``: the same
flags (and ``--device``), the same printed lines and the same loop — the
step under ``ABFTGuard.run_step`` (restore: the latest checkpoint) inside a
``StragglerWatchdog``, a checkpoint every ``--ckpt-every`` steps and at
the end.  The step is :func:`~repro_torch.launch.steps.make_train_step`,
run eagerly.

Resume keeps the reference's semantics, which are not those of an
uninterrupted run: the state after step ``i`` is saved under the label
``i``, a resumed run starts its loop at the label, and the data stream
starts again from its first batch (ROADMAP Queue C, standing note).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --smoke --steps 100 --abft fused                  # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --smoke --steps 4 --ckpt-every 2 --device cpu     # on the CPU

Checkpoints go to ``--ckpt-dir`` (``results/ckpt``).  Without
``--device cpu`` it runs on the card and raises when there is none.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft import ABFTConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig, tree_leaves
from repro_torch.runtime import ABFTGuard, StragglerWatchdog

PREFIX = 8          # the stub front end's prefix embeddings


def train(cfg: ModelConfig, *, steps: int = 100, batch: int = 8,
          seq: int = 128, abft: str = "fused", compress_grads: bool = False,
          ckpt_dir: str = "results/ckpt", ckpt_every: int = 100,
          lr: float = 1e-3, device: DeviceLike = "cuda",
          log: Callable[[str], None] = print) -> dict:
    """Train ``cfg`` from the latest checkpoint in ``ckpt_dir`` (or from
    ``init_train_state(cfg, 0)``) up to ``steps``.  Returns the final
    ``state``, the step it ``started`` from, the last step's ``metrics``,
    the guard's ``flags``, the watchdog's ``straggler_events``, the
    ``seconds`` of the loop, the ``restore_s`` of the resume and the
    checkpoint manager's ``ckpt_timings``."""
    dev = resolve_device(device)
    abft_cfg = ABFTConfig(mode=abft, threshold=5e-2, relative=True)

    state = init_train_state(cfg, 0, compress_grads=compress_grads,
                             device=dev)
    n = sum(x.numel() for x in tree_leaves(state["params"]))
    log(f"arch={cfg.name} params={n/1e6:.2f}M abft={abft} "
        f"compress={compress_grads}")

    step_fn = make_train_step(
        cfg, abft_cfg, AdamWConfig(lr=lr), total_steps=steps,
        warmup=max(steps // 10, 1), compress_grads=compress_grads)
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    t_restore = time.perf_counter()
    restored, at = ckpt.restore(state)
    restore_s = time.perf_counter() - t_restore
    start = 0
    if restored is not None:
        state, start = restored, at
        del restored
        log(f"resumed from step {at}")

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       batch_size=batch, seed=0)
    it = data.batches()
    guard = ABFTGuard(restore_fn=lambda: ckpt.restore(state)[0])
    wd = StragglerWatchdog()
    t0 = time.time()
    rng = np.random.default_rng(0)
    m = None
    for i in range(start, steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        if cfg.family == "encdec":
            b["src_embeds"] = torch.from_numpy(rng.normal(
                size=(batch, seq, cfg.d_model)).astype(np.float32)).to(dev)
        elif cfg.frontend:
            b["prefix_embeds"] = torch.zeros(
                (batch, PREFIX, cfg.d_model), dtype=torch.float32,
                device=dev)
        wd.start()
        state, m = guard.run_step(lambda s, b=b: step_fn(s, b), state)
        wd.stop()
        if i % 20 == 0 or i == steps - 1:
            log(f"step {i:5d} loss={float(m['loss']):.4f} "  # abftlint: sync-ok (per-step logging is the demo)
                f"abft_rel={float(m['abft_max_rel']):.1e}")  # abftlint: sync-ok (per-step logging is the demo)
        if i and i % ckpt_every == 0:
            ckpt.save(i, state)
    ckpt.save(steps, state)
    ckpt.wait()
    dt = time.time() - t0
    log(f"done: {steps - start} steps, {dt:.1f}s, "
        f"abft flags {guard.flags}, straggler events {wd.events}")
    return dict(state=state, started=start, metrics=m, flags=guard.flags,
                straggler_events=wd.events, seconds=dt, restore_s=restore_s,
                ckpt_timings=ckpt.timings)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--abft", default="fused",
                    choices=["none", "split", "fused"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 abft=args.abft, compress_grads=args.compress_grads,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
