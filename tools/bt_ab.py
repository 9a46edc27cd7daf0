#!/usr/bin/env python3
"""B4's wide Bᵀ path (``matmul_abft`` with ``trans_b`` at M > 16) of several
checkouts, side by side on one NVIDIA GPU: every launch must keep its bits.

    python3 tools/bt_ab.py PARENT . . PARENT    # roots of checkouts

Each root runs in a process of its own, in the order given, with its own
``src/`` first on the path, so its kernels are built from its own sources
into its own ``build/``.  For each root, gemma-2b's train step as
``chip_smoke.py``'s ``lm_train`` runs it (``TRAIN``: all 18 layers, f32,
seed 0, ``SyntheticLM(seed=0)`` batches of B 2 x T 512, fused mode, tau
1e-3 relative, AdamW):

- step 1 unguarded, then step 1 through ``ABFTGuard.run_step`` with every
  Bᵀ launch at M > 16 recorded in launch order — the dA = dC·Bᵀ of each
  layer product and the tied head's forward — as a digest of its C, block
  sums and extra column; whether the two steps' states are equal;
- step 2, guarded; the losses and a digest of the params after each step
  (``tree_digest``: exact integer sums of every leaf's bits, taken on the
  card);
- the device ms (CUDA-graph replay) of each recorded Bᵀ shape on operands
  of its own, beside the same launch on a transposed copy of B, and their
  sums over the step's launches;
- the grouped autograd Function's gradients without row counts at
  deepseek-moe-16b's prefill up/gate expert shape (``lm_grads``' expert
  entry), a digest.

Prints one JSON object per root, then the card's name and power limit (the
harness: ``tools/_ab.py``).
"""
from __future__ import annotations

import hashlib
import os
import sys

import _ab

WORDS = 1 << 24          # 32-bit words a digest sum takes at once


def _digest(torch, outs) -> str:
    return hashlib.sha256(b"".join(
        x.float().cpu().numpy().tobytes() for x in outs if x is not None)
    ).hexdigest()[:16]


def tree_digest(torch, tree) -> str:
    """A digest of every leaf's bits, summed on the card: per leaf, its
    32-bit words split into 16-bit halves, and the sums of the halves and
    of each half times its word's index mod 65521, plus one — integer
    sums, exact in int64 whatever the order of the reduction."""
    from repro_torch.optim import tree_leaves
    h = hashlib.sha256()
    for x in tree_leaves(tree):
        if not torch.is_tensor(x):
            h.update(repr(x).encode())
            continue
        raw = x.detach().contiguous().view(-1).view(torch.uint8)
        if raw.numel() % 4:
            raw = torch.cat([raw, raw.new_zeros(-raw.numel() % 4)])
        words = raw.view(torch.int32)
        sums = torch.zeros(4, dtype=torch.int64, device=x.device)
        for i in range(0, words.numel(), WORDS):
            v = words[i:i + WORDS].to(torch.int64)
            w = torch.arange(i, i + v.numel(), device=v.device) % 65521 + 1
            lo, hi = v & 0xFFFF, v >> 16
            sums += torch.stack([lo.sum(), hi.sum(), (lo * w).sum(),
                                 (hi * w).sum()])
        h.update(f"{x.dtype} {tuple(x.shape)} {sums.tolist()}".encode())
    return h.hexdigest()[:16]


def measure(root: str) -> dict:
    cs = _ab.chip_smoke(root)
    import torch
    from repro_torch.analysis.vmem import MATMUL_SMALL_M
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.data import Prefetcher, SyntheticLM
    from repro_torch.kernels.matmul_abft import kernel, ops
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.abft_guard import ABFTGuard

    torch.backends.cuda.matmul.allow_tf32 = False
    train = cs.TRAIN
    cfg = cs.lm_config()
    abft = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    sched = dict(total_steps=train["total"], warmup=train["warmup"])
    step = make_train_step(cfg, abft, AdamWConfig(), **sched)
    loose = make_train_step(cfg, abft, AdamWConfig(), guard_in_graph=False,
                            **sched)
    state = init_train_state(cfg, train["seed"], device="cuda")
    data = Prefetcher(SyntheticLM(cfg.vocab_size, train["seq"],
                                  train["batch"], seed=train["seed"]
                                  ).batches(), device="cuda")
    batches = [next(data) for _ in range(2)]
    guard = ABFTGuard()

    u1, _ = loose(state, batches[0])
    unguarded = tree_digest(torch, u1)
    del u1
    launches = []
    real = ops.matmul_abft_kernel

    def spy(a, b, br=None, *, trans_b=False):
        out = real(a, b, br, trans_b=trans_b)
        if trans_b and a.shape[0] > MATMUL_SMALL_M:
            launches.append(((a.shape[0], a.shape[1], b.shape[0],
                              br is not None), _digest(torch, out)))
        return out
    ops.matmul_abft_kernel = spy
    try:
        s1, m1 = guard.run_step(step, state, batches[0])
    finally:
        ops.matmul_abft_kernel = real
    del state
    guarded = tree_digest(torch, s1)
    params1 = tree_digest(torch, s1["params"])
    s2, m2 = guard.run_step(step, s1, batches[1])
    del s1
    params2 = tree_digest(torch, s2["params"])
    del s2, batches, data
    torch.cuda.empty_cache()

    counts = {}
    for key, _ in launches:
        counts[key] = counts.get(key, 0) + 1
    times = {}
    for i, (m, k, n, checked) in enumerate(counts):
        gen = torch.Generator(device="cuda").manual_seed(3000 + i)
        a = torch.randn(m, k, generator=gen, device="cuda")
        b = torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
        br = b.sum(dim=0).contiguous() if checked else None
        bt = b.t().contiguous()
        reps = 3 if n * k > 1 << 28 else 5
        times[f"{m}x{k}x{n} checked={checked}"] = dict(
            launches=counts[m, k, n, checked],
            device_ms=cs.device_ms(lambda: kernel.matmul_abft_kernel(
                a, b, br, trans_b=True), reps=reps),
            device_ms_b=cs.device_ms(lambda: kernel.matmul_abft_kernel(
                a, bt, br), reps=reps))
        del a, b, br, bt
    per_step = {key: sum(t[key] * t["launches"] for t in times.values())
                for key in ("device_ms", "device_ms_b")}
    every = hashlib.sha256("".join(d for _, d in launches).encode())
    return dict(root=root, package=os.path.dirname(kernel.__file__),
                bt_launches=len(launches), digest_all=every.hexdigest()[:16],
                losses=[float(m1["loss"]), float(m2["loss"])],
                flags=[bool(m1["abft_flag"]), bool(m2["abft_flag"])],
                guard=dict(flags=guard.flags, retries=guard.retries),
                params_digests=[params1, params2],
                state_digest_guarded=guarded,
                guarded_eq_unguarded=guarded == unguarded,
                grouped_expert_grads=grouped_grads(cs, torch, ops),
                per_step=per_step, times=times,
                digests=[f"{'x'.join(map(str, key))} {d}"
                         for key, d in launches])


def grouped_grads(cs, torch, ops) -> str:
    """A digest of the grouped Function's gradients without counts at
    deepseek-moe-16b's prefill up/gate expert shape (G, M, K, N), on seeded
    operands at ``lm_grads``' scales: a [G, M, K], b [G, K, N] / sqrt(K),
    dC."""
    g, m, k, n = next(iter(cs.lm_grouped_shapes(
        cs.arch_config("deepseek-moe-16b"))))
    gen = torch.Generator(device="cuda").manual_seed(12)
    xs = [torch.randn(g, m, k, generator=gen, device="cuda"),
          torch.randn(g, k, n, generator=gen, device="cuda") * k ** -0.5]
    dc = torch.randn(g, m, n, generator=gen, device="cuda")
    xs = [x.requires_grad_(True) for x in xs]
    c = ops.GroupedMatmulAbftFunction.apply(*xs, None, None)[0]
    return _digest(torch, torch.autograd.grad(c, xs, dc))


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, measure))
