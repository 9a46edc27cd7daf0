"""End-to-end driver 1: train a GCN on a synthetic Cora-sized graph with
ABFT-checked steps (PyTorch port of ``examples/train_gcn.py``).

The step is autograd of ``gcn_loss`` (the dense backend's products) and
AdamW at the cosine-warmup rate, run under ``ABFTGuard.run_step``.

    PYTHONPATH=src python examples/torch_train_gcn.py --steps 300 \\
        --mode fused                                          # GPU
    PYTHONPATH=src python examples/torch_train_gcn.py --steps 300 \\
        --device cpu

Without ``--device cpu`` it runs on the card and raises when there is none.
"""
import argparse
import time

import torch

from repro_torch.core import ABFTConfig
from repro_torch.core.datasets import make_reduced
from repro_torch.core.gcn import dataset_to_dense, gcn_loss, init_gcn
from repro_torch.device import resolve_device
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_warmup, tree_leaves, tree_unflatten)
from repro_torch.runtime import ABFTGuard


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--mode", default="fused",
                    choices=["none", "split", "fused"])
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = make_reduced("cora", scale=args.scale, seed=0)
    s_np, h_np, y_np = dataset_to_dense(ds)
    s, h, y = (torch.from_numpy(a).to(dev) for a in (s_np, h_np, y_np))
    dims = ds.stats.layer_dims
    abft = ABFTConfig(mode=args.mode, threshold=1e-2, relative=True)
    opt_cfg = AdamWConfig(lr=1e-2, weight_decay=1e-4)

    params = init_gcn(torch.Generator().manual_seed(0), dims, device=dev)
    state = {"params": params, "opt": adamw_init(params)}

    def step(state):
        live = [p.detach().requires_grad_(True)
                for p in tree_leaves(state["params"])]
        loss, report = gcn_loss(tree_unflatten(state["params"], iter(live)),
                                s, h, y, None, abft, device=dev)
        grads = tree_unflatten(state["params"],
                               iter(torch.autograd.grad(loss, live)))
        lr = cosine_warmup(state["opt"]["step"], 20, args.steps)
        p2, o2 = adamw_update(state["params"], grads, state["opt"],
                              opt_cfg, lr)
        return {"params": p2, "opt": o2}, {
            "loss": loss.detach(), "abft_flag": report.flag,
            "abft_max_rel": report.max_rel.detach()}

    def sync():
        # eager launches are asynchronous: a clock read waits for them
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    guard = ABFTGuard()
    sync()
    t0 = time.time()
    for i in range(args.steps):
        state, m = guard.run_step(step, state)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"abft_max_rel={float(m['abft_max_rel']):.2e} "
                  f"flags={guard.flags}")
    sync()
    dt = time.time() - t0
    print(f"\n{args.steps} steps in {dt:.1f}s "
          f"({dt/args.steps*1e3:.1f} ms/step); ABFT mode={args.mode}; "
          f"flagged steps: {guard.flags}")


if __name__ == "__main__":
    main()
