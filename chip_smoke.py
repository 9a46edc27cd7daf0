#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card (and the
whole-network kernel bit for bit against a chain of single-layer launches;
``spmm_abft`` also at every tile shape and G it serves, a second run and a
gathered sub-system of stripes bit for bit the full launch's),
and drives the port's main paths — guarded packed block-ELL GCN serving
(two-pass, fused-layer and whole-network), the stripe/slot repair tiers and
the streaming server — at the published widths of Cora's 2-layer GCN
(1433 -> 16 -> 7), and the checked-op path — guarded LM serving (prefill,
greedy decode, the retry and restore ladder) at gemma-2b's published widths,
all 18 layers, float32, on the ``matmul_abft`` and ``flash_checksum``
kernels, then the same at the full widths of qwen1.5-4b, chatglm3-6b,
h2o-danube-3-4b (``lm_archs``; danube's 5120-token prompt runs past its
4096-key sliding window, which ``flash_checksum`` masks), deepseek-moe-16b
(all 28 layers) and qwen3-moe-30b-a3b (24 of its 48 layers), whose expert
products run on ``matmul_abft``'s grouped launch, rwkv6-7b (attention-free,
32 layers) and recurrentgemma-9b (38 layers, RG-LRU gates on the grouped
launch, local attention on ``flash_checksum`` with its 2048-key window;
the recurrent scans timed), whisper-medium (24 encoder and 24 decoder
layers over 1500 source frames: the encoder's self-attention and the
decoder's cross-attention on ``flash_checksum`` without the causal mask)
and internvl2-26b (32 of its 48 layers, 256 prefix embeddings before the
prompt), and guarded GAT serving on ``matmul_abft`` over full Cora and
full PubMed (``gat``) — through the entry points a user would call; then
``python -m repro_torch.launch.serve --smoke`` for whisper-medium and
internvl2-26b (``serve_cli``), and the port's five examples,
``examples/torch_*.py``, each as a process (``examples``: the fault demo,
the quickstart with B1 on its ``block_ell`` line, train_gcn at full Cora's
widths, train_lm with a restore from its checkpoint and serve_lm on B4, the
grouped B4 and B5).  Any phase that fails
raises and the run exits non-zero; without a CUDA device it exits non-zero
before printing anything.

``lm_kernels`` also times the thin (M <= 16) ``matmul_abft`` products from
CUDA graphs — the device's own time, with B in L2 and L2-cold — beside the
eager back-to-back time, and ``lm_serve`` traces one guarded decode step
with ``torch.profiler`` (device busy time, top kernels).

The chaos campaign (``repro_torch.faults``) runs on the card too: its GCN
lane sweeps every fault site x kind through the packed two-pass path (B1
with its accumulator ``inject=`` hook, the guard's repair tiers) at Cora's
widths, its LM lane the weight and attention-accumulator faults through the
guarded gemma-2b steps (B4, B5) at full width; each prints its
by-(site, kind) table and holds the campaign's gates.

The paper's layer API and the sparse path run in ``sparse``: the
quickstart's flow at full Cora (dense against sparse, two split checks
against one fused, B1 through ``gcn_layer_fused_sparse_kernel``), then full
NELL through ``gcn_apply_sparse`` on the ``"bcoo"`` backend against a
float64 forward, with an injected corruption and whether cuSPARSE repeats
bit for bit.  Stripe sharding runs in ``sharded``: full PubMed's block-ELL
at 1, 2 and 4 shards through B1 and B2, one launch a shard, rows and stripe
corners bit for bit the unsharded run's.

``lm_kernels`` also holds B4 at every launch shape the other LMs add, the
grouped B4 at every served expert and RG-LRU gate shape (bit for bit one
single launch a group, timed beside ``torch.bmm``) and at ragged shapes,
and B5 at each of their served prefill attentions (danube's with its
window, recurrentgemma's with its local window, also in bfloat16 on
``FLASH_SEEDS`` input streams; whisper's encoder and cross-attention
without the mask, timed beside SDPA with ``is_causal=False``) and at small
ragged windowed and non-causal shapes, the bfloat16 ones (windowed) also
on ``FLASH_SEEDS``, each bfloat16 chain corner with its float64 witness
(``chain_witness``).

Split mode, the paper's two-check baseline, runs a guarded prefill on the
card per attention kind (``split`` inside ``lm_serve`` for gemma-2b's causal
attention and inside ``lm_archs`` for h2o-danube-3-4b's window and
whisper-medium's encoder and cross-attention): B5 emits each row's softmax
statistics m and l, which the plain second scoring pass reads; every B5
check also holds m and l against the plain version's.  ``lm_grads`` holds
the backward of each kernel's autograd Function against autograd of its
plain version, and ``lm_train`` drives the LM train step
(``launch.steps.make_train_step`` under ``ABFTGuard.run_step``): three
guarded gemma-2b steps at full width (B 2 x T 512, an upset retried on
step 2), a 2-layer cut against the CPU, then one whisper-medium step.
``train_driver`` drives ``launch.train`` and the checkpoint package on a
2-layer full-width gemma-2b (uninterrupted, resumed, restored with the
embedding on the host, the CLI as processes) and a stream engine's degrade
checkpoints.  The card-vs-CPU cut of whisper-medium (and of any model
whose cut sits over half its gate) also reports each side's distance from
a float64 run of the same cut on the CPU (``card_vs_f64``, ``cpu_vs_f64``).

``coverage`` (after ``gat``) proves ABFT coverage on the card
(``analysis/coverage.py``): the packed GCN step at Cora's widths at every
granularity and tier, the engine forward and a train step on full Cora,
GAT on full Cora, gemma-2b at 18 layers, whisper-medium whole and every
other LM at its cut are traced under check tagging with their kernels
launching — 0 unchecked sites on every guarded step, the kernel site nodes
equal to the launches kernel by kernel, tagged outputs bit for bit the
untagged run's, gemma-2b's cut the same manifest on the card and the CPU,
and ``python -m repro_torch.analysis.lint`` as a process.

``mesh`` (last) runs the LM mesh on DTensor (``launch/mesh.py``): the
dry run's CLI as two processes, started before ``serve`` so that they
trace beside the card's phases (gemma-2b at every shape on (16, 16) and
(2, 16, 16), decode_32k for the nine others; ``meta`` shards over a fake
process group), gemma-2b at full width served on a real one-rank (1, 1)
mesh bit for bit the unsharded run, the cost model (``launch/costs.py``)
held against that run, and the 2-layer cut on a (2, 4) mesh of local
ranks (every rank's shard on the one card) for a train step and a
prefill within the LM gate.

One JSON object per phase is printed (``env``, ``build``, ``kernel_checks``,
``lm_kernels``, ``lm_grads``, ``serve``, ``fault``, ``stream``,
``full_graph``, ``campaign_gcn``, ``sparse``, ``sharded``, ``gat`` (one a
graph), ``coverage``, ``lm_serve``, ``campaign_lm``, ``lm_archs`` (one a
model), ``lm_train``, ``train_driver``, ``serve_cli``, ``examples``,
``mesh``), then the
``kernels``
summary line, the card's name and power limit as ``nvidia-smi`` gives them,
and a last line ``{"ok": true, "device": {...}}``.

Bounds use the published peaks of an H100 SXM: 3.35 TB/s of device memory,
67 TFLOP/s in float32 outside the tensor cores, 989 TFLOP/s in bfloat16.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

# the main path's configuration: Cora's published model and graph size
DIMS = (1433, 16, 7)
SERVE = dict(n_graphs=16, n_lo=1500, n_hi=2708, avg_deg=4, batch=8,
             block=128, stripe_multiple=4, width_multiple=4, seed=0)
# the streaming server: the same generator, rungs planned from the first
# `profile` requests (the closed-batch phases' stream)
STREAM = dict(n_requests=32, profile=16, n_slots=4)
OUT_ATOL = OUT_RTOL = 1e-4       # kernel vs plain version, every output
CORNER_RTOL = 1e-4               # clean |pred - actual| / max(1, |actual|)
# a clean LM check element over CORNER_RTOL passes only with its float64
# witness (clean_witness): each f32 rounding step between its two sides
# within one unit roundoff of the sum of |terms| that step rounds
U32 = 2.0 ** -24
# B4's block sums: an element over OUT_ATOL + OUT_RTOL · |want| passes (in
# float32) only within SUM_ULPS unit roundoffs of its tile's Σ|c| of the
# float64 sum of the kernel's own C (check_block_sums)
SUM_ULPS = 4
# B5's chain corner in bfloat16: over 5e-2 it passes only with its float64
# witness (chain_witness), each rounding step within one unit roundoff
# (bf16's or f32's) of the sum of |terms| that step rounds; FLASH_SEEDS are
# the input streams the windowed bf16 cases are also run on
U_BF16 = 2.0 ** -8
BF16_CORNER_RTOL = 5e-2
FLASH_SEEDS = tuple(range(100, 116))
LOGIT_ATOL = 1e-4                # vs the float64 dense forward
# the LM's logits card vs CPU: 1e-4, plus 1e-6 of |logit| — one f32 spacing
# is 1.22e-4 at |logit| >= 1024, which gemma's logit of the input token
# itself reaches (~1800: its embedding dominates the residual stream), so
# atol alone would ask for bit-identity there; 1e-6 is at most ~8 spacings
LM_LOGIT_RTOL = 1e-6
REPAIR_ATOL = 1e-5               # repaired vs clean logits
# the checked-op path: gemma-2b at its published widths, float32, depth not
# cut; 2 sequences of 512 prompt tokens, then 16 greedy decode steps
LM = dict(arch="gemma-2b", batch=2, prompt=512, new=16, seed=0,
          inject_at=3, inject_delta=25.0, flip_layer=5, flip_bit=30,
          cut_layers=2, cut_prompt=128, cut_decode=2)
BF16_TOL = dict(matmul_abft=2e-2, flash_checksum=3e-2)   # the JAX tests'
# the other attention decoders the port serves, each at its published
# widths, all layers, float32, seeded weights (LM's seed, upset and bit
# flip, and card-vs-CPU cut): qwen1.5-4b (MHA, QKV bias, untied head of
# 152,064), chatglm3-6b (GQA 16, half-dim RoPE, QKV bias) and
# h2o-danube-3-4b (GQA 4 at head 120, window 4096 — its 5120-token prompt
# runs past the window, so the last 1024 queries lose keys in prefill and
# every decode step masks by it); each master is freed before the next.
# The MoE decoders follow, at their published widths, f32, with the
# published capacity factor 1.25 (prefill drops assignments): deepseek-moe-16b
# with all 28 layers (67.5 GB of weights), qwen3-moe-30b-a3b with 24 of its
# 48 layers — all 48 would be 122 GB at f32, past the card's 80 GB
# (``layers`` is the cut).  Then the recurrent families, all layers, f32:
# rwkv6-7b (attention-free, 28.1 GB) and recurrentgemma-9b (the (rglru,
# rglru, attn) pattern, 38 = 12 x 3 + 2 layers, 34.3 GB; its 2560-token
# prompt runs 512 past the 2048-key local window), whose card-vs-CPU cut is
# one whole unit (``cut_layers`` 3: both RG-LRU layers and the attention).
# Then a model with a front end, its input a seeded normal stub:
# whisper-medium (24 encoder + 24 decoder layers, 3.0 GB) over 1500 source
# frames (``src``: whisper's n_audio_ctx) with a 224-token decoder prompt
# (half its n_text_ctx of 448), its card-vs-CPU cut 2 + 2 layers; and
# internvl2-26b with 256 ``prefix`` embeddings (one 448 x 448 image tile
# after pixel shuffle, arXiv:2404.16821) before a 512-token prompt, 32 of
# its 48 layers — all 48 would be 79.4 GB at f32, past the card's 80 GB
# with activations; 32 are 54.5 GB.
ARCHS = (
    dict(arch="qwen1.5-4b", batch=2, prompt=512, cache=528, new=8),
    dict(arch="chatglm3-6b", batch=2, prompt=512, cache=528, new=8),
    dict(arch="h2o-danube-3-4b", batch=1, prompt=5120, cache=5136, new=8),
    dict(arch="deepseek-moe-16b", batch=2, prompt=512, cache=528, new=8),
    dict(arch="qwen3-moe-30b-a3b", batch=2, prompt=512, cache=528, new=8,
         layers=24),
    dict(arch="rwkv6-7b", batch=2, prompt=512, cache=528, new=8),
    dict(arch="recurrentgemma-9b", batch=1, prompt=2560, cache=2576, new=8,
         cut_layers=3),
    dict(arch="whisper-medium", batch=2, prompt=224, cache=232, new=8,
         src=1500),
    dict(arch="internvl2-26b", batch=2, prompt=512, cache=776, new=8,
         prefix=256, layers=32))
# the LM train step (launch.steps.make_train_step under ABFTGuard.run_step):
# gemma-2b at its published widths, all 18 layers, f32, seed 0, batches of
# SyntheticLM(seed=0) at B 2 x T 512, 3 steps, an accumulator upset of
# `delta` on step 2's first attempt; AdamW at its defaults (lr 3e-4) with a
# 2-step warmup (step 1's learning rate is 0, step 2's half); the card
# against the CPU on a 2-layer cut at T 128; then one step of
# whisper-medium at its ARCHS spec (1500 source frames, T 224)
# the LM mesh (``mesh``): the dry run as two CLI processes beside the card's
# phases (gemma-2b at every shape on both production meshes; decode_32k on
# (16, 16) for the other nine models), gemma-2b served at lm_serve's cell
# on a one-rank (1, 1) mesh for ``decode`` greedy steps, and the 2-layer
# cut on a (2, 4) mesh of local ranks at lm_train's cut shape
MESH = dict(decode=8, local=(2, 4), dry_wait=900)
TRAIN = dict(batch=2, seq=512, steps=3, seed=0, delta=25.0, warmup=2,
             total=100, cut_layers=2, cut_seq=128)
# the training driver (launch.train) and its checkpoints: gemma-2b at its
# published widths cut to lm_train's 2 layers (744.7 M parameters: the
# 524.3 M embedding and 2 x 110.2 M; params, m and v are 8.94 GB a
# checkpoint — the 18-layer state, ~30 GB, is not written), batches of
# SyntheticLM(seed=0) at B 2 x T 512, fused mode; an uninterrupted run of
# `steps` saving every `ckpt_every`, a run of `first` steps resumed to
# `steps` (twice), the embedding restored onto the host, the CLI as
# processes; then a stream engine's degrade checkpoints (the sticky fault
# of tests/test_torch_stream.py) over the first `stream` graphs
TRAIN_DRIVER = dict(arch="gemma-2b", layers=2, batch=2, seq=512, steps=4,
                    ckpt_every=2, first=2, stream=12)
# the models whose split-mode prefill runs on the card, one an attention
# kind: gemma-2b (causal, in lm_serve), h2o-danube-3-4b (its window),
# whisper-medium (non-causal encoder, cross-attention)
SPLIT_ARCHS = ("h2o-danube-3-4b", "whisper-medium")
# the leaf a weight bit flip goes into: the first dense weight of unit
# ``flip_layer``'s first block
FLIP_LEAF = {"attn": ("attn", "wq"), "rwkv": ("tm", "wr"),
             "rglru": ("rglru", "proj_x")}
# B5's sliding window at small ragged shapes: T = S = 257 (B, H, Kh, dh),
# and danube's head dim at a short window
# B4's ragged shapes (M, K, N, trans_b).  The wide path's: one row past a
# 128-row block (129) and one short of two (255), K and N not multiples of
# 4, B and B^T.  The thin path's: K not a multiple of 32 or of the split,
# N (B) or K (B^T) not a multiple of 4 — the scalar tail
MATMUL_RAGGED = ((200, 100, 72, False), (17, 33, 65, True),
                 (129, 70, 130, False), (129, 70, 130, True),
                 (255, 99, 131, False), (255, 99, 131, True),
                 (1, 2050, 129, False), (2, 16384, 64, False),
                 (16, 2050, 130, False), (1, 33, 65, True),
                 (2, 100, 72, True))
# the grouped launch's (M, K, N) at 5 groups, both tile paths: K not a
# multiple of 4 (each group's b_r then starts off 16-byte alignment), of
# 32 or of the split, N not a multiple of 4
GROUPED_RAGGED = ((1, 33, 65), (6, 100, 72), (8, 70, 130), (16, 2050, 130),
                  (17, 33, 65), (120, 70, 130), (129, 99, 131))
FLASH_WINDOWS = (1, 31, 32, 33, 100, 300)
FLASH_WINDOWED = (((1, 257, 257, 4, 2, 64), FLASH_WINDOWS),
                  ((1, 300, 300, 8, 2, 120), (64,)))
# B5 at small ragged shapes (B, T, S, H, Kh, dh): causal (GQA, T < S, a
# ragged T, dh 16 and 70) and non-causal (S not a multiple of the 32-key
# block, T > S, T < S, S under one block, T 1 over 1500 keys, dh 70)
FLASH_RAGGED = ((1, 100, 100, 4, 2, 64), (2, 128, 256, 4, 2, 64),
                (1, 70, 70, 4, 4, 16), (1, 33, 50, 2, 2, 70))
FLASH_NONCAUSAL_RAGGED = ((1, 100, 100, 4, 2, 64), (1, 300, 70, 4, 2, 64),
                          (2, 40, 257, 4, 4, 64), (2, 33, 17, 2, 2, 64),
                          (2, 1, 1500, 16, 16, 64), (1, 33, 50, 2, 2, 70))
# guarded GAT (engine/gat.py): the adjacency pattern of make_dataset(graph,
# normalize=False), A + I, dense on the card, its raw features, weights
# from seed 0; 64 is the published GAT's hidden width (8 heads x 8,
# arXiv:1710.10903), served as the engine's single head
GAT = (dict(graph="cora", dims=(1433, 64, 7)),
       dict(graph="pubmed", dims=(500, 64, 3)))
GAT_SEED, GAT_DELTA, GAT_FLIP = 0, 50.0, dict(layer=1, index=5, bit=30)
# the chaos campaign (repro_torch.faults): the GCN lane on the first 8
# graphs of the served stream at Cora's widths, the default
# sweep_models(reps=2) grid (26 models) with the accumulator upsets at the
# fault phase's delta 50 (gated) and at the grid's own delta 1.0 (measured,
# not gated: it may sit below tau * max(1, |actual|) at this width); the LM
# lane on gemma-2b at full width with lm_sweep_models(reps=1)
CAMPAIGN = dict(n_graphs=8, n_lo=SERVE["n_lo"], n_hi=SERVE["n_hi"],
                feat=DIMS[0], hidden=DIMS[1], n_out=DIMS[2], block=128,
                n_steps=4, reps=2, gated_delta=50.0, seed=0,
                lm_reps=1, lm_decode=3)
# the sparse path (the paper's layer API and core/gcn.py over a torch sparse
# S on the "bcoo" backend): the quickstart's flow at full Cora, then full
# NELL (65,755 nodes, 5414 -> 64 -> 186), which only the sparse path serves
# (its block-ELL at 128 x 128 would be 13.6 GB, dense S 17.3 GB); weights
# from seed 0; the corrupted output element of tests/test_sparse_abft.py
SPARSE = dict(quick="cora", graph="nell", seed=0, corrupt=(11, 7), reps=5)
NELL_LOGIT_RTOL = 1e-6           # NELL's logits vs the f64 forward: + rtol
# stripe sharding (engine/sharded.py): full PubMed (19,717 nodes, 500 -> 16
# -> 3) at block 128, 155 stripes padded to 156 and staged once, 1, 2 and
# 4 shards on one card, the two-pass (B1) and fused-layer (B2) paths
SHARDED = dict(graph="pubmed", block=128, shards=(1, 2, 4), seed=0, reps=5)
# the ABFT coverage proof (analysis/coverage.py, the abftlint CLI's steps)
# traced on the card with the kernels launching: the packed GCN step on the
# first served batch at Cora's widths (block 128) at every granularity and
# fusion tier, and unguarded; the engine forward (dense and bcoo) and a GCN
# train step on full Cora; gemma-2b at all 18 layers (LM's batch and
# prompt); whisper-medium whole (its ARCHS spec); every other LM family at
# its card-vs-CPU cut (2 layers, recurrentgemma 3; B as in ARCHS, prompt
# cut_prompt); GAT on full Cora; gemma-2b's cut traced on the card and on
# the CPU; the CLI as processes.  `backward` is the GCN train step's
# unchecked products at 2 layers, the reference's count (ROADMAP A13.2)
COVERAGE = dict(backward=5)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def run_text(cmd) -> str:
    return subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=True).stdout.strip()


def time_ms(fn, warm: int = 2, reps: int = 10) -> float:
    """Mean milliseconds of ``fn()`` on the card: CUDA events around
    ``reps`` back-to-back calls after ``warm`` untimed ones."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int = 50) -> float:
    """Mean host milliseconds of one call of ``fn()``: the Python and CUDA
    launch work that dispatches it, with no synchronise inside the window
    (the launch queue takes the kernels)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def device_ms(fn, reps: int = 10, cold: bool = False) -> float:
    """Mean device milliseconds of ``fn()`` replayed from a CUDA graph, so
    no host dispatch sits between the launches.  ``cold``: the 50 MB L2
    cache is flushed before each call (a 64 MB read), as a decode step
    finds its next weight, and the flushes' own time is subtracted."""
    import torch
    flush = torch.empty(16 << 20, dtype=torch.float32, device="cuda") \
        if cold else None

    def graph_ms(with_fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()                  # the allocator and the library warm up
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                if flush is not None:
                    flush.sum()
                if with_fn:
                    fn()
        g.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    total = graph_ms(True) - (graph_ms(False) if cold else 0.0)
    return total / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def assert_close(name, got, want, atol=OUT_ATOL, rtol=OUT_RTOL) -> float:
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"{name}: max abs err {max_err(got, want):.3e} "
                             f"over atol={atol} rtol={rtol}")
    return max_err(got, want)


def check_block_sums(torch, name, c, got, want, acc=None) -> dict:
    """B4's block sums ``got`` against the plain version's ``want`` (both
    [..., tiles of M, tiles of N]; ``c`` [..., M, N] the kernel's output),
    element by element within OUT_ATOL + OUT_RTOL · |want|.  An element
    over it passes only with its float64 witness: the kernel's block sum
    within SUM_ULPS unit roundoffs of its tile's Σ|c| of the float64 sum of
    the tile's f32 accumulator — in float32 the kernel's own C (C itself
    is held against the plain version's); in bfloat16, whose C is rounded
    after the sum, ``acc``, the plain version's own f32 accumulator (the
    plain version on the operands widened to f32, exactly: it widens each
    chunk before its product).  A tile of large outputs that cancels (the
    4096-wide tied head, |c| ~ 64) rounds its sum past 1e-4 (ROADMAP C5),
    at a witness ratio far under 1.  Every call also plants the fault the
    rule exists for — every block sum moved by C's mean |c|, one dropped or
    doubled typical element, about 2^24 / (SUM_ULPS · n) times the witness
    bound of an n-element tile — and fails unless the rule rejects each
    planted sum.  Returns the max abs error, the elements over the
    tolerance and the largest witness ratio of all."""
    from repro_torch.kernels.matmul_abft.kernel import tile_sums
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite values")
    if c.dtype == torch.float32:
        acc = c
    elif acc is None or acc.dtype != torch.float32 \
            or acc.shape != c.shape:
        raise AssertionError(f"{name}: a {c.dtype} product's block sums "
                             f"need the plain version's f32 accumulator")
    m, n = acc.shape[-2:]
    cs = acc.reshape(-1, m, n).to(torch.float64)
    exact = torch.stack([tile_sums(x, m, n) for x in cs]).reshape(got.shape)
    scale = SUM_ULPS * U32 * torch.stack(
        [tile_sums(x.abs(), m, n) for x in cs]).reshape(got.shape)

    def witness(sums):
        return (sums.to(torch.float64) - exact).abs() / scale

    def rejected(sums):
        over = (sums - want).abs() > OUT_ATOL + OUT_RTOL * want.abs()
        return over & (witness(sums) > 1.0)
    bad = rejected(got)
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} block sums over "
                             f"atol={OUT_ATOL} rtol={OUT_RTOL}, max abs err "
                             f"{max_err(got, want):.3e}, and over "
                             f"{SUM_ULPS} unit roundoffs of Σ|c| from the "
                             f"float64 sum of the kernel's C")
    if not rejected(got + c.float().abs().mean()).all():
        raise AssertionError(f"{name}: the rule let a block sum off by one "
                             f"typical |c| pass")
    over = (got - want).abs() > OUT_ATOL + OUT_RTOL * want.abs()
    return dict(max_abs_err=max_err(got, want), over_tol=int(over.sum()),
                max_witness_ratio=float(witness(got).max()))


def check_extra(torch, name, a, br, got, want) -> dict:
    """B4's extra column ``got`` = A @ b_r [M, 1] against the plain
    version's ``want`` within OUT_ATOL + OUT_RTOL · |want|; an element over
    it passes only with its float64 witness, as a block sum does
    (:func:`check_block_sums`): within SUM_ULPS unit roundoffs of Σ_k
    |a_mk b_r,k| of the float64 product.  The tied head's b_r sums every
    row of the table (|b_r| ~ 500), so an entry that cancels to near 0
    rounds past 1e-4 (ROADMAP C5).  The planted fault, every entry moved
    by the mean |extra|, must be rejected.  Returns the max abs error, the
    elements over the tolerance and the largest witness ratio."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite values")
    a64, br64 = a.to(torch.float64), br.to(torch.float64).reshape(-1, 1)
    exact = a64 @ br64
    scale = SUM_ULPS * U32 * (a64.abs() @ br64.abs())

    def witness(x):
        return (x.to(torch.float64) - exact).abs() / scale

    def rejected(x):
        over = (x - want).abs() > OUT_ATOL + OUT_RTOL * want.abs()
        return over & (witness(x) > 1.0)
    if rejected(got).any():
        raise AssertionError(f"{name}: {int(rejected(got).sum())} entries "
                             f"over atol={OUT_ATOL} rtol={OUT_RTOL}, max abs "
                             f"err {max_err(got, want):.3e}, and over "
                             f"{SUM_ULPS} unit roundoffs of Σ|a b_r| from the "
                             f"float64 product")
    if not rejected(got + want.abs().mean()).all():
        raise AssertionError(f"{name}: the rule let an entry off by the mean "
                             f"|extra| pass")
    over = (got - want).abs() > OUT_ATOL + OUT_RTOL * want.abs()
    return dict(max_abs_err=max_err(got, want), over_tol=int(over.sum()),
                max_witness_ratio=float(witness(got).max()))


def bf16_acc(torch, a, b, trans_b=False):
    """A bfloat16 product's f32 accumulator in the plain version's
    association (the plain version on the operands widened to f32: it
    widens each chunk before its product, so the sums are the same), or
    None for a float32 product."""
    from repro_torch.kernels.matmul_abft.kernel import matmul_abft_plain
    if a.dtype == torch.float32:
        return None
    return matmul_abft_plain(a.float(), b.float(), trans_b=trans_b)[0]


def block_sums_second_draw(torch, a_shape, b_shape, b_std, kernel, plain,
                           tag) -> dict:
    """The bfloat16 block-sum gate (:func:`check_block_sums`) on a second
    operand draw of one shape, from a generator seeded by the shape alone:
    the gate does not rest on the operands one shape order draws.
    ``kernel(a, b)`` / ``plain(a, b)`` return (c, block_sums, ...)."""
    seed = hash((tuple(a_shape), tuple(b_shape))) % (2 ** 31)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(*a_shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    b = (torch.randn(*b_shape, generator=gen, device="cuda") * b_std).to(
        torch.bfloat16)
    got, want = kernel(a, b), plain(a, b)
    acc = plain(a.float(), b.float())[0]
    return dict(seed=seed, **check_block_sums(
        torch, f"{tag} block_sums (second draw)", got[0], got[1], want[1],
        acc))


def corner_rel(pred, actual) -> float:
    return float(((pred - actual).abs()
                  / actual.abs().clamp(min=1.0)).max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(torch) -> str:
    from repro_torch.kernels import runtime
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    nvcc = run_text([runtime.find_nvcc(), "--version"]).splitlines()[-2:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import importlib.util
    # how far one float32 torch.matmul (cuBLAS) lands from float64: the
    # plain versions and the plain decode attention run on it
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(16, 8, 256, generator=g, device="cuda")
    b = torch.randn(16, 256, 129, generator=g, device="cuda")
    ref = a.double() @ b.double()
    probe = float(((a @ b).double() - ref).abs().max()
                  / ref.abs().max())
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, cuda_available=torch.cuda.is_available(),
         triton_installed=importlib.util.find_spec("triton") is not None,
         nvcc=" | ".join(nvcc), nvidia_smi=smi,
         device=torch.cuda.get_device_name(0),
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         fp32_precision=getattr(torch.backends.cuda.matmul,
                                "fp32_precision", None),
         float32_matmul_precision=torch.get_float32_matmul_precision(),
         f32_matmul_max_rel_err_vs_f64=probe)
    return smi


def ptxas_summary(log: str) -> dict:
    """Registers, stack and spills of every function in a ``ptxas -v``
    log, keyed by the (mangled) name: registers for kernel entries, stack
    and spills for entries and for the never-inlined device functions they
    call."""
    import re
    out, entry, cur = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = cur = m.group(1)
            out.setdefault(entry, {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
    return out


def fused_ptxas() -> dict:
    """ptxas -v of the fused kernels (B2's combine and sweep kernels, B3,
    and the never-inlined phases they share), from this run's build."""
    from repro_torch.kernels import runtime
    return {name: v for name, v in ptxas_summary(
        runtime.last_build_log).items()
        if any(k in name for k in ("combine_", "sweep_", "gcn_network"))}


def graph_timing(launch) -> dict:
    """A kernel's three times: ``ms`` (10 back-to-back launches after 2
    warm-up ones, CUDA events: every kernel's yardstick), ``ms_50`` (50
    launches) and ``device_ms`` (20 launches replayed from a CUDA graph: no
    host dispatch between them)."""
    return dict(ms=time_ms(launch), ms_50=time_ms(launch, reps=50),
                device_ms=device_ms(launch, reps=20))


def phase_build() -> None:
    from repro_torch.kernels import runtime
    t0 = time.perf_counter()
    runtime.load_library(verbose=True)
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=round(runtime.last_build_seconds, 3),
         library=str(runtime.build_root()),
         sources=[str(p.relative_to(ROOT)) for p in runtime.source_paths()],
         ptxas=ptxas_summary(runtime.last_build_log))


def make_stream_batches(block: int):
    from repro_torch.engine import make_packed_batches, synth_graph_stream
    stream = synth_graph_stream(SERVE["n_graphs"], n_lo=SERVE["n_lo"],
                                n_hi=SERVE["n_hi"], feat=DIMS[0],
                                avg_deg=SERVE["avg_deg"], seed=SERVE["seed"])
    batches = make_packed_batches(stream, SERVE["batch"], block=block,
                                  stripe_multiple=SERVE["stripe_multiple"],
                                  width_multiple=SERVE["width_multiple"])
    return stream, batches


def make_params(torch, dims=None, seed=0):
    from repro_torch.core.gcn import init_gcn
    dims = DIMS if dims is None else dims
    return init_gcn(torch.Generator().manual_seed(seed), dims, device="cuda")


def bsr_library_ms(torch, cols, vals, xx, all_tiles=False):
    """Time one ``torch.sparse`` BSR product of the tiles against ``[x |
    x_r]`` — the yardstick only; nothing in the port calls it.  By default
    the BSR operand keeps the non-zero tiles (1090 of the served batch's
    3456: about 71 MB read); ``all_tiles`` keeps every stored tile, padding
    included, as B1 multiplies them (229 MB).  Returns (ms | None, note)."""
    try:
        nbm, width, bm, bk = vals.shape
        mask = torch.ones((nbm, width), dtype=torch.bool, device=vals.device)\
            if all_tiles else vals.abs().sum(dim=(2, 3)) > 0
        crow = torch.zeros(nbm + 1, dtype=torch.int64, device=vals.device)
        crow[1:] = mask.sum(dim=1).cumsum(0)
        bsr = torch.sparse_bsr_tensor(crow, cols[mask].long(), vals[mask],
                                      size=(nbm * bm, xx.shape[0]))
        y = bsr @ xx
        torch.cuda.synchronize()
        what = "every stored tile" if all_tiles else "the non-zero tiles"
        return time_ms(lambda: bsr @ xx), \
            f"torch.sparse BSR @ [x | x_r] over {what} " \
            f"({int(mask.sum())} of {nbm * width}), f32, out " \
            f"{tuple(y.shape)}"
    except Exception as exc:  # the yardstick may not exist in this build
        return None, f"BSR product unavailable: {type(exc).__name__}: {exc}"


def check_spmm(torch, cols, vals, x, xr, tag):
    """spmm_abft kernel vs plain on one operand set; returns max abs err."""
    from repro_torch.kernels.spmm_abft.kernel import (spmm_abft_kernel,
                                                      spmm_abft_plain)
    nbm, width = cols.shape
    worst = 0.0
    for inject in (None, (nbm // 2, width // 2, 3.0), (0, width - 1, -2.0)):
        got = spmm_abft_kernel(cols, vals, x, xr, inject=inject)
        again = spmm_abft_kernel(cols, vals, x, xr, inject=inject)
        torch.cuda.synchronize()
        want = spmm_abft_plain(cols, vals, x, xr, inject=inject)
        for name, g_, a_, w_ in zip(("out", "stripe_sums", "extra"), got,
                                    again, want):
            worst = max(worst, assert_close(f"spmm_abft[{tag}] {name} "
                                            f"inject={inject}", g_, w_))
            if not torch.equal(g_, a_):
                raise AssertionError(f"spmm_abft[{tag}] {name} inject="
                                     f"{inject}: a second run differs")
    return worst


def check_spmm_subsystem(torch, bell, cols, vals, x, xr, tag):
    """The surgical repair's replay: a launch on ``gather_stripe_system`` of
    three scattered stripes must give those stripes of the full launch bit
    for bit (out, stripe_sums, extra).  Returns the stripes."""
    from repro_torch.engine.localize import gather_stripe_system
    from repro_torch.kernels.spmm_abft.kernel import spmm_abft_kernel
    from repro_torch.kernels.spmm_abft.ops import device_block_ell
    nbm, _width, bm, _bk = vals.shape
    stripes = sorted({1 % nbm, nbm // 2, nbm - 2 if nbm > 2 else 0})
    sc, sv = device_block_ell(gather_stripe_system(bell, stripes), "cuda")
    full = spmm_abft_kernel(cols, vals, x, xr)
    sub = spmm_abft_kernel(sc, sv, x, xr)
    idx = torch.tensor(stripes, device="cuda")
    rows = (idx[:, None] * bm + torch.arange(bm, device="cuda")).reshape(-1)
    for name, f_, s_ in zip(("out", "stripe_sums", "extra"), full, sub):
        want = f_[idx] if name == "stripe_sums" else f_[rows]
        if not torch.equal(s_, want):
            raise AssertionError(f"spmm_abft[{tag}] sub-system {stripes} "
                                 f"{name}: not bit for bit the full launch's "
                                 f"(max abs diff {max_err(s_, want):.3e})")
    return stripes


def check_fused_subsystem(torch, bell, cols, vals, h, w, wr, tag):
    """The surgical repair's replay of a fused layer: a gcn_fused launch on
    ``gather_stripe_system`` of three scattered stripes (the full H, so the
    combination recomputes every row) must give those stripes of the full
    launch bit for bit (out, stripe sums, extra, slot telescopes).
    Returns the stripes."""
    from repro_torch.engine.localize import gather_stripe_system
    from repro_torch.kernels.gcn_fused.kernel import gcn_fused_kernel
    from repro_torch.kernels.spmm_abft.ops import device_block_ell
    nbm, _width, bm, _bk = vals.shape
    stripes = sorted({1 % nbm, nbm // 2, nbm - 2 if nbm > 2 else 0})
    sc, sv = device_block_ell(gather_stripe_system(bell, stripes), "cuda")
    full = gcn_fused_kernel(cols, vals, h, w, wr, with_slots=True)
    sub = gcn_fused_kernel(sc, sv, h, w, wr, with_slots=True)
    idx = torch.tensor(stripes, device="cuda")
    rows = (idx[:, None] * bm + torch.arange(bm, device="cuda")).reshape(-1)
    for name, f_, s_ in zip(("out", "stripe_sums", "extra", "slot_acts",
                             "slot_preds"), full, sub):
        want = f_[rows] if name in ("out", "extra") else f_[idx]
        if not torch.equal(s_, want):
            raise AssertionError(f"gcn_fused[{tag}] sub-system {stripes} "
                                 f"{name}: not bit for bit the full launch's "
                                 f"(max abs diff {max_err(s_, want):.3e})")
    return stripes


def check_fused(torch, cols, vals, h, w, wr, tag):
    """gcn_fused kernel vs plain: clean, injected, unchecked, telescopes;
    a second run bit for bit."""
    from repro_torch.kernels.gcn_fused.kernel import (gcn_fused_kernel,
                                                      gcn_fused_plain)
    nbm, width = cols.shape
    names = ("out", "stripe_sums", "extra", "slot_acts", "slot_preds")
    worst = 0.0
    cases = [dict(), dict(inject=(nbm // 2, width // 2, 3.0)),
             dict(with_check=False),
             dict(with_slots=True, inject=(1, 0, -2.0))]
    for kw in cases:
        got = gcn_fused_kernel(cols, vals, h, w, wr, **kw)
        again = gcn_fused_kernel(cols, vals, h, w, wr, **kw)
        torch.cuda.synchronize()
        want = gcn_fused_plain(cols, vals, h, w, wr, **kw)
        if len(got) != len(want):
            raise AssertionError(f"gcn_fused[{tag}] {kw}: {len(got)} outputs "
                                 f"vs {len(want)}")
        for name, g_, a_, w_ in zip(names, got, again, want):
            worst = max(worst, assert_close(f"gcn_fused[{tag}] {name} {kw}",
                                            g_, w_))
            if not torch.equal(g_, a_):
                raise AssertionError(f"gcn_fused[{tag}] {name} {kw}: a "
                                     f"second run differs")
        if kw.get("with_check") is False and float(got[2].abs().max()) != 0.0:
            raise AssertionError(f"gcn_fused[{tag}]: with_check=False left "
                                 f"extra non-zero")
    return worst


def b2_chain(torch, cols, vals, h0, wps, wrps, dims, inject=None,
             with_check=True):
    """The port's single-layer chain: one gcn_fused launch per layer with
    its slot telescopes, ReLU between layers — what the whole-network kernel
    must equal bit for bit.  Returns the network kernel's outputs."""
    from repro_torch.kernels.gcn_fused.kernel import gcn_fused_kernel
    h, tas, tps, acts = h0, [], [], []
    for ell, (w, wr) in enumerate(zip(wps, wrps)):
        hook = tuple(inject[1:]) if inject is not None \
            and inject[0] == ell else None
        o, _s, _e, sa, sp = gcn_fused_kernel(cols, vals, h, w, wr,
                                             inject=hook,
                                             with_check=with_check,
                                             with_slots=True)
        tas.append(sa)
        tps.append(sp)
        if ell < len(wps) - 1:
            h = torch.relu(o[:, :dims[ell + 1]]).contiguous()
            acts.append(h)
    return o, torch.stack(tas), torch.stack(tps), tuple(acts)


def check_network(torch, cols, vals, h0, wps, wrps, tag):
    """gcn_network kernel vs plain (clean, injected at the first and the
    last layer, unchecked, stashing), and bit for bit vs the B2 chain on
    the same operands and vs a second run; returns the max abs error
    against the plain version."""
    from repro_torch.kernels.gcn_fused.kernel import (_check_network_shapes,
                                                      gcn_network_kernel,
                                                      gcn_network_plain)
    dims = _check_network_shapes(cols, vals, h0, wps, wrps)
    nbm, width = cols.shape
    last = len(wps) - 1
    names = ("out", "tele_acts", "tele_preds")
    worst = 0.0
    cases = [dict(), dict(inject=(0, nbm // 2, width // 2, 3.0)),
             dict(inject=(last, 1, 0, -2.0), stash_acts=True),
             dict(with_check=False), dict(stash_acts=True)]
    for kw in cases:
        got = gcn_network_kernel(cols, vals, h0, wps, wrps, **kw)
        again = gcn_network_kernel(cols, vals, h0, wps, wrps, **kw)
        torch.cuda.synchronize()
        want = gcn_network_plain(cols, vals, h0, wps, wrps, **kw)
        for name, g_, a_, w_ in zip(names, got[:3], again[:3], want[:3]):
            worst = max(worst, assert_close(
                f"gcn_network[{tag}] {name} {kw}", g_, w_))
            if not torch.equal(g_, a_):
                raise AssertionError(f"gcn_network[{tag}] {name} {kw}: a "
                                     f"second run differs")
        if kw.get("stash_acts"):
            if got[3] is None or len(got[3]) != last:
                raise AssertionError(f"gcn_network[{tag}] {kw}: stash "
                                     f"{got[3]!r}")
            for ell, (g_, w_) in enumerate(zip(got[3], want[3])):
                worst = max(worst, assert_close(
                    f"gcn_network[{tag}] acts[{ell}] {kw}", g_, w_))
        elif got[3] is not None:
            raise AssertionError(f"gcn_network[{tag}]: stashed unasked")
        if kw.get("with_check") is False and float(got[2].abs().max()) != 0:
            raise AssertionError(f"gcn_network[{tag}]: with_check=False "
                                 f"left the pred telescopes non-zero")
        chain = b2_chain(torch, cols, vals, h0, wps, wrps, dims,
                         inject=kw.get("inject"),
                         with_check=kw.get("with_check", True))
        pairs = list(zip(names, got[:3], chain[:3]))
        if got[3] is not None:
            pairs += [(f"acts[{ell}]", g_, c_)
                      for ell, (g_, c_) in enumerate(zip(got[3], chain[3]))]
        for name, g_, c_ in pairs:
            if not torch.equal(g_, c_):
                raise AssertionError(
                    f"gcn_network[{tag}] {name} {kw}: not bit for bit the "
                    f"B2 chain (max abs diff {max_err(g_, c_):.3e})")
    return worst


def schedule_entry(n_bytes: int) -> dict:
    """The traffic a kernel's own tile schedule asks for (the
    ``schedule_bytes_*`` models of ``kernels/gcn_fused/ops.py``) and its
    time at the card's memory rate — beside ``bound_ms``, which counts
    every input once."""
    return dict(schedule_bytes=n_bytes,
                schedule_ms=n_bytes / PEAK_BYTES_PER_S * 1e3)


def network_entry(torch, cols, vals, h0, wps, wrps, segments, n_slots,
                  bell, err):
    """Time gcn_network at the main path's packed shape beside the B2 chain
    and the plain version, with its bound; returns the kernels-line entry."""
    from repro_torch.kernels.gcn_fused.kernel import (_check_network_shapes,
                                                      gcn_network_kernel,
                                                      gcn_network_plain)
    from repro_torch.kernels.gcn_fused.ops import (_network_checks,
                                                   schedule_bytes_network)
    dims = _check_network_shapes(cols, vals, h0, wps, wrps)
    nbm, width, bm, bk = vals.shape
    tiles = nbm * width
    rows = h0.shape[0]
    out, ta, tp, _ = gcn_network_kernel(cols, vals, h0, wps, wrps)
    rel = max(corner_rel(c.predicted, c.actual) for c in _network_checks(
        ta, tp, "graph", segments, n_slots))
    if not rel <= CORNER_RTOL:
        raise AssertionError(f"gcn_network: clean corner divergence "
                             f"{rel:.3e} over {CORNER_RTOL}")
    b3 = graph_timing(lambda: gcn_network_kernel(cols, vals, h0, wps, wrps))
    chain_ms = time_ms(lambda: b2_chain(torch, cols, vals, h0, wps, wrps,
                                        dims), reps=5)
    plain_ms = time_ms(lambda: gcn_network_plain(cols, vals, h0, wps, wrps),
                       warm=1, reps=2)
    # each input read once, each output (logits, telescopes) written once
    n_bytes = nbytes(cols, vals, h0, *wps, *wrps) + nbytes(out, ta, tp)
    # least work: per layer the combination once over the rows, then the
    # aggregation per stored tile, each with its check column
    n_ops = sum(2 * rows * w.shape[0] * (w.shape[1] + 1)
                + 2 * tiles * bm * bk * (w.shape[1] + 1) for w in wps)
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_o = n_ops / PEAK_F32_FLOPS * 1e3
    return dict(
        name="gcn_network", route="cuda",
        source="src/repro_torch/kernels/csrc/gcn_network.cu",
        replaces="src/repro/kernels/gcn_fused/kernel.py:256",
        max_abs_err=err, max_rel_corner=rel, ms=b3["ms"], ms_50=b3["ms_50"],
        device_ms=b3["device_ms"], plain_ms=plain_ms,
        bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o
        else "operations", library_ms=None,
        library_note="no single PyTorch call computes an L-layer GCN with "
                     "per-layer carried columns and slot telescopes",
        b2_chain_ms=chain_ms,
        **schedule_entry(schedule_bytes_network(bell, dims)),
        grid=gcn_network_kernel.last_grid, dims=dims,
        shape=dict(nbm=nbm, width=width, bm=bm, bk=bk, stored_tiles=tiles),
        bytes=n_bytes, flops=n_ops,
        ptxas={k: v for k, v in fused_ptxas().items()
               if "gcn_network" in k})


def layer_operands(torch, cols, vals, h0, layers):
    """Each layer's operands as the main path hands them to the kernels:
    (H, x = H W padded to the register-tile quantum, x_r = H w_r, W and w_r
    padded for the fused kernel); the next H from the plain version."""
    from repro_torch.analysis.vmem import _lanes
    from repro_torch.kernels.gcn_fused.ops import _pad_weights
    from repro_torch.kernels.spmm_abft.kernel import spmm_abft_plain
    from repro_torch.kernels.spmm_abft.ops import pad_features
    h, per_layer = h0, []
    for layer in layers:
        w, w_r = layer["w"], layer["w_r"]
        x = pad_features(h @ w, _lanes(w.shape[1])).contiguous()
        xr = (h @ w_r)[:, None].contiguous()
        wp, wrp = _pad_weights(w, w_r, 128)
        per_layer.append((h.contiguous(), x, xr, wp, wrp))
        h = torch.relu(spmm_abft_plain(cols, vals, x, xr)[0][:, :w.shape[1]])
    return per_layer


def spmm_timing(torch, cols, vals, x, xr) -> dict:
    """B1 at one launch shape: its time, the plain version's, both BSR
    yardsticks, the bound (every input read once, every output written once
    over the card's memory rate; the stored tiles' multiply-adds, the check
    column's included, over the f32 peak) and the rate at which it moves
    those bytes."""
    from repro_torch.kernels.spmm_abft.kernel import (spmm_abft_kernel,
                                                      spmm_abft_plain)
    nbm, width, bm, bk = vals.shape
    gp = x.shape[1]
    # `ms` is every kernel's yardstick (10 launches); the window opens on an
    # idle card, so it also holds the host's first dispatch, which 50
    # launches (`ms_50`) spread thinner; device_ms replays a CUDA graph, the
    # kernel's own time
    ms = time_ms(lambda: spmm_abft_kernel(cols, vals, x, xr))
    ms_50 = time_ms(lambda: spmm_abft_kernel(cols, vals, x, xr), reps=50)
    dev_ms = device_ms(lambda: spmm_abft_kernel(cols, vals, x, xr), reps=20)
    plain_ms = time_ms(lambda: spmm_abft_plain(cols, vals, x, xr),
                       warm=1, reps=3)
    xx = torch.cat([x, xr], dim=1).contiguous()
    lib_ms, lib_note = bsr_library_ms(torch, cols, vals, xx)
    all_ms, all_note = bsr_library_ms(torch, cols, vals, xx, all_tiles=True)
    n_bytes = nbytes(cols, vals, x, xr) + 4 * (nbm * bm * gp + nbm + nbm * bm)
    n_ops = 2 * nbm * width * bm * bk * (gp + 1)
    t_b, t_o = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_F32_FLOPS * 1e3
    return dict(ms=ms, ms_50=ms_50, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                gb_per_s=n_bytes / ms / 1e6, library_ms=lib_ms,
                library_note=lib_note, library_all_tiles_ms=all_ms,
                library_all_tiles_note=all_note, bytes=n_bytes, flops=n_ops,
                shape=dict(nbm=nbm, width=width, bm=bm, bk=bk, g=gp))


def phase_kernels(torch, batches, params):
    """Hold every kernel against its plain version at the main path's
    shapes (both layers of the Cora-width packed batch; the whole network),
    and at block 32; time them at the layer-0 shapes (the network whole)."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine import fold_w_r
    from repro_torch.engine.streaming import packed_step_args
    from repro_torch.analysis.vmem import fused_plan
    from repro_torch.kernels.gcn_fused.kernel import (gcn_fused_combine,
                                                      gcn_fused_kernel,
                                                      gcn_fused_plain)
    from repro_torch.kernels.gcn_fused.ops import (_network_weights,
                                                   _pad_weights,
                                                   schedule_bytes_fused,
                                                   schedule_bytes_twopass)
    from repro_torch.kernels.spmm_abft.kernel import spmm_abft_kernel

    cfg = ABFTConfig(mode="fused")
    layers = fold_w_r(params, cfg)["layers"]
    pb = batches[0]
    cols, vals, segments, h0 = packed_step_args(pb, "cuda")
    nbm, width, bm, bk = vals.shape
    tiles = nbm * width
    nnz_tiles = int((vals.abs().sum(dim=(2, 3)) > 0).sum())
    entries = {}

    per_layer = layer_operands(torch, cols, vals, h0, layers)

    spmm_err = max(check_spmm(torch, cols, vals, x, xr, f"layer{ell}")
                   for ell, (_, x, xr, _, _) in enumerate(per_layer))
    fused_err = max(check_fused(torch, cols, vals, h_, wp, wrp, f"layer{ell}")
                    for ell, (h_, _, _, wp, wrp) in enumerate(per_layer))

    # clean corners per graph within a tenth of tau
    from repro_torch.kernels.spmm_abft.ops import packed_check_corners
    _h, x, xr, wp, wrp = per_layer[0]
    o = spmm_abft_kernel(cols, vals, x, xr)
    c1 = packed_check_corners(o[1], o[2], segments, pb.n_slots)
    o = gcn_fused_kernel(cols, vals, _h, wp, wrp)
    c2 = packed_check_corners(o[1], o[2], segments, pb.n_slots)
    rels = {"spmm_abft": corner_rel(c1.predicted, c1.actual),
            "gcn_fused": corner_rel(c2.predicted, c2.actual)}
    for name, rel in rels.items():
        if not rel <= CORNER_RTOL:
            raise AssertionError(f"{name}: clean corner divergence {rel:.3e} "
                                 f"over {CORNER_RTOL}")

    # the surgical repair's replay: gathered stripes bit for bit
    from repro_torch.kernels import runtime
    sub_stripes = {"layer0": check_spmm_subsystem(
        torch, pb.bell, cols, vals, per_layer[0][1], per_layer[0][2],
        "layer0")}

    # ---- timing at the layer-0 shapes (the dominant launch of each path);
    # B1 also at layer 1 and at block 32, with its registers and spills
    h_, x, xr, wp, wrp = per_layer[0]
    f, gp = wp.shape
    f_model, g_model = layers[0]["w"].shape
    outs = nbm * bm * gp * 4 + nbm * 4 + nbm * bm * 4
    b_ops = 2 * tiles * bm * bk * (gp + 1)
    h1, x1, xr1, wp1, wrp1 = per_layer[1]
    b1_shapes = {"layer0": spmm_timing(torch, cols, vals, x, xr),
                 "layer1": spmm_timing(torch, cols, vals, x1, xr1)}
    b1 = b1_shapes["layer0"]
    entries["spmm_abft"] = dict(
        name="spmm_abft", route="cuda",
        source="src/repro_torch/kernels/csrc/spmm_abft.cu",
        replaces="src/repro/kernels/spmm_abft/kernel.py:75",
        max_abs_err=spmm_err, max_rel_corner=rels["spmm_abft"],
        **{k: b1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library_note",
                                "library_all_tiles_ms",
                                "library_all_tiles_note", "gb_per_s",
                                "ms_50", "device_ms")},
        layer1_ms=b1_shapes["layer1"]["ms"],
        # the schedule model prices the whole two-pass layer: the
        # combination and eq.-5 products before this launch, and the launch
        **schedule_entry(schedule_bytes_twopass(pb.bell, f_model, g_model)),
        shape=dict(nbm=nbm, width=width, bm=bm, bk=bk, g=gp,
                   stored_tiles=tiles, nonzero_tiles=nnz_tiles),
        bytes=b1["bytes"], flops=b1["flops"], shapes=b1_shapes,
        ptxas={k: v for k, v in ptxas_summary(
            runtime.last_build_log).items() if "spmm" in k})

    b2 = graph_timing(lambda: gcn_fused_kernel(cols, vals, h_, wp, wrp))
    b2_l1 = graph_timing(lambda: gcn_fused_kernel(cols, vals, h1, wp1, wrp1))
    # phase A alone (the combination into the workspace), both layers; its
    # X and x_r against the plain products
    combine = {}
    for ell, (hh, ww, wwr) in enumerate(((h_, wp, wrp), (h1, wp1, wrp1))):
        xa, xra = gcn_fused_combine(hh, ww, wwr, block=(bm, bk))
        combine[f"layer{ell}"] = dict(
            device_ms=device_ms(lambda: gcn_fused_combine(
                hh, ww, wwr, block=(bm, bk)), reps=20),
            x_max_abs_err=assert_close(f"gcn_fused_combine[layer{ell}] x",
                                       xa, hh @ ww),
            xr_max_abs_err=assert_close(
                f"gcn_fused_combine[layer{ell}] x_r", xra, hh @ wwr),
            bound_ms=nbytes(hh, ww, wwr, xa, xra) / PEAK_BYTES_PER_S * 1e3)
    plain_ms = time_ms(lambda: gcn_fused_plain(cols, vals, h_, wp, wrp),
                       warm=1, reps=2)
    f_bytes = nbytes(cols, vals, h_, wp, wrp) + outs
    # least work for the same function: the combination once over the rows,
    # then the aggregation per stored tile
    f_ops = 2 * h_.shape[0] * f * (gp + 1) + b_ops
    t_b, t_o = f_bytes / PEAK_BYTES_PER_S * 1e3, f_ops / PEAK_F32_FLOPS * 1e3
    entries["gcn_fused"] = dict(
        name="gcn_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/gcn_fused.cu",
        replaces="src/repro/kernels/gcn_fused/kernel.py:105",
        max_abs_err=fused_err, max_rel_corner=rels["gcn_fused"],
        ms=b2["ms"], ms_50=b2["ms_50"], device_ms=b2["device_ms"],
        plain_ms=plain_ms, bound_ms=max(t_b, t_o),
        bound_by="bytes" if t_b >= t_o else "operations",
        library_ms=None,
        library_note="no single PyTorch call computes S (H W) with the "
                     "carried column and the per-stripe sums",
        **schedule_entry(schedule_bytes_fused(pb.bell, f_model, g_model)),
        shape=dict(nbm=nbm, width=width, bm=bm, bk=bk, f=f, g=gp,
                   stored_tiles=tiles, nonzero_tiles=nnz_tiles),
        bytes=f_bytes, flops=f_ops, layer1=b2_l1, combine=combine,
        plan=fused_plan(gp, bm, bk).library_fields(),
        ptxas={k: v for k, v in fused_ptxas().items()
               if "gcn_network" not in k})

    # ---- B3: the whole network in one launch, at the same packed shape
    wps, wrps = _network_weights([layer["w"] for layer in layers],
                                 [layer["w_r"] for layer in layers], 128)
    net_err = check_network(torch, cols, vals, h0, wps, wrps, "cora")
    entries["gcn_network"] = network_entry(torch, cols, vals, h0, wps, wrps,
                                           segments, pb.n_slots, pb.bell,
                                           net_err)

    # ---- the other tile shape: block 32 at the serving CLI's default widths
    from repro_torch.engine import make_packed_batches, synth_graph_stream
    small = make_packed_batches(synth_graph_stream(16, seed=1), 8, block=32,
                                stripe_multiple=4, width_multiple=4)[0]
    sc, sv, _sg, sh = packed_step_args(small, "cuda")
    sp = fold_w_r(make_params(torch, (16, 16, 7), seed=1), cfg)["layers"][0]
    swp, swrp = _pad_weights(sp["w"], sp["w_r"], 128)
    sx = (sh @ swp).contiguous()
    sxr = (sh @ sp["w_r"])[:, None].contiguous()
    e32 = (check_spmm(torch, sc, sv, sx, sxr, "block32"),
           check_fused(torch, sc, sv, sh, swp, swrp, "block32"))
    sub_stripes["block32"] = check_spmm_subsystem(torch, small.bell, sc, sv,
                                                  sx, sxr, "block32")
    entries["spmm_abft"]["shapes"]["block32"] = spmm_timing(torch, sc, sv, sx,
                                                            sxr)
    sl = fold_w_r(make_params(torch, (16, 16, 7), seed=1), cfg)["layers"]
    e32 += (check_network(torch, sc, sv, sh, *_network_weights(
        [la["w"] for la in sl], [la["w_r"] for la in sl], 128), "block32"),)
    # shapes that take the kernels' other mappings: more register tiles than
    # threads (two passes), and a reduction axis split three and eight ways
    r = torch.Generator().manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, generator=r).to("cuda")
    odd = {}
    # the fused layer's replay of gathered stripes, bit for bit, at blocks
    # 128, 32 and (below) 16
    fused_sub = {
        "block128": check_fused_subsystem(torch, pb.bell, cols, vals, h_, wp,
                                          wrp, "block128"),
        "block32": check_fused_subsystem(torch, small.bell, sc, sv, sh, swp,
                                         swrp, "block32")}
    x72, xr72 = rand(vals.shape[0] * bk, 72), rand(vals.shape[0] * bk, 1)
    odd["spmm_abft block128 G=72"] = check_spmm(torch, cols, vals, x72, xr72,
                                                "block128-G72")
    sx72, sxr72 = rand(sv.shape[0] * 32, 72), rand(sv.shape[0] * 32, 1)
    odd["spmm_abft block32 G=72"] = check_spmm(torch, sc, sv, sx72, sxr72,
                                               "block32-G72")
    odd["spmm_abft block32 G=8"] = check_spmm(
        torch, sc, sv, sx72[:, :8].contiguous(), sxr72, "block32-G8")
    # one stripe (a one-stripe repair), and one slot per stripe
    odd["spmm_abft block128 one stripe"] = check_spmm(
        torch, cols[:1].contiguous(), vals[:1].contiguous(), x, xr,
        "block128-nbm1")
    odd["spmm_abft block128 width 1"] = check_spmm(
        torch, cols[:, :1].contiguous(), vals[:, :1].contiguous(), x, xr,
        "block128-width1")
    # block 16 (chunks of 16 k-columns read through the 64-byte swizzle, the
    # serving CLI's default block), and tall blocks cut into row slices
    # (192: 2 slices x 3 k-parts, 256: 2 x 4, one cluster of 6 and of 8)
    for blk in (16, 192, 256):
        tb = make_packed_batches(synth_graph_stream(16, seed=1), 8,
                                 block=blk, stripe_multiple=4,
                                 width_multiple=4)[0]
        tc, tv, _tg, _th = packed_step_args(tb, "cuda")
        for g in (8, 16, 72):
            tx, txr = rand(tv.shape[0] * blk, g), rand(tv.shape[0] * blk, 1)
            odd[f"spmm_abft block{blk} G={g}"] = check_spmm(
                torch, tc, tv, tx, txr, f"block{blk}-G{g}")
        sub_stripes[f"block{blk}"] = check_spmm_subsystem(
            torch, tb.bell, tc, tv, tx, txr, f"block{blk}")
        if blk == 16:
            w16 = rand(_th.shape[1], 16) * 0.2
            wr16 = rand(_th.shape[1], 1) * 0.2
            odd["gcn_fused block16 G=16"] = check_fused(
                torch, tc, tv, _th, w16, wr16, "block16-G16")
            fused_sub["block16"] = check_fused_subsystem(
                torch, tb.bell, tc, tv, _th, w16, wr16, "block16")
    w24, wr24 = rand(16, 24) * 0.2, rand(16, 1) * 0.2
    odd["gcn_fused block32 G=24"] = check_fused(torch, sc, sv, sh, w24, wr24,
                                                "block32-G24")
    w64, wr64 = rand(DIMS[0], 64) * 0.05, rand(DIMS[0], 1) * 0.05
    odd["gcn_fused block128 G=64"] = check_fused(torch, cols, vals, h_, w64,
                                                 wr64, "block128-G64")
    # three layers (two grid barriers), a hidden width of 24 and one of 64
    deep = [(16, 24), (24, 64), (64, 8)]
    odd["gcn_network block32 16-24-64-7"] = check_network(
        torch, sc, sv, sh, [rand(f, g) * 0.2 for f, g in deep],
        [rand(f, 1) * 0.2 for f, _ in deep], "block32-3layer")
    fused_spills = {name: v for name, v in fused_ptxas().items()
                    if v.get("spill_stores") or v.get("spill_loads")}
    emit("kernel_checks", tolerance=dict(atol=OUT_ATOL, rtol=OUT_RTOL,
                                         corner_rtol=CORNER_RTOL,
                                         network_vs_b2_chain="bitwise"),
         block32_max_abs_err=dict(spmm_abft=e32[0], gcn_fused=e32[1],
                                  gcn_network=e32[2]),
         spmm_subsystem_bitwise=sub_stripes,
         fused_subsystem_bitwise=fused_sub,
         network_vs_b2_chain_bitwise=["cora (block 128)", "block32",
                                      "block32-3layer"],
         second_run_bitwise=["spmm_abft", "gcn_fused", "gcn_network"],
         other_shapes_max_abs_err=odd,
         kernels=list(entries.values()))
    if fused_spills:
        raise AssertionError(f"gcn_fused / gcn_network spill: {fused_spills}")
    return entries


def dense_f64_logits(torch, pb, params):
    """Float64 dense forward S @ relu(S @ (H W0)) W1 per graph of a packed
    batch, with plain torch on the card."""
    ws = [layer["w"].double() for layer in params["layers"]]
    out = []
    for s, h0 in pb.items:
        s64 = torch.from_numpy(s).to("cuda").double()
        h = torch.from_numpy(h0).to("cuda").double()
        for i, w in enumerate(ws):
            h = s64 @ (h @ w)
            if i < len(ws) - 1:
                h = torch.relu(h)
        out.append(h)
    return out


def per_graph_rows(pb, logits):
    return [logits[int(o):int(o) + int(n)]
            for o, n in zip(pb.row_offsets, pb.n_nodes) if n > 0]


def phase_serve(torch, batches, params):
    """The main path: the closed-batch guarded server, two-pass, fused-layer
    and whole-network, with the launch counts read around each run."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine import fold_w_r
    from repro_torch.engine.streaming import PackedRunner
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve_gcn
    from repro_torch.runtime import ABFTGuard

    cfg = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    n_layers = len(params["layers"])
    shapes = {(b.bell.values.shape, b.h0.shape, b.n_slots) for b in batches}
    # path -> (serve options, its kernel, launches per step)
    paths = {"two_pass": ({}, "spmm_abft", n_layers),
             "fused_layer": ({"fused_layer": True}, "gcn_fused", n_layers),
             "fused_network": ({"fused_network": True}, "gcn_network", 1)}

    # logits of every path against the float64 dense forward, and each other
    folded = fold_w_r(params, cfg)
    logit_err = {}
    path_logits = {}
    split_ms = {name: [] for name in paths}
    for name, (opts, _kernel, _per) in paths.items():
        runner = PackedRunner(folded, cfg, 128, device="cuda", **opts)
        worst = 0.0
        path_logits[name] = []
        for pb in batches:
            t0 = time.perf_counter()
            args = runner.args_for(pb)           # host -> device staging
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, metrics = runner.step_for(pb)(*args)
            torch.cuda.synchronize()
            split_ms[name].append(dict(
                staging_ms=(t1 - t0) * 1e3,
                step_ms=(time.perf_counter() - t1) * 1e3,
                staged_bytes=nbytes(*args)))
            if logits.shape != (pb.bell.padded_rows, DIMS[-1]):
                raise AssertionError(f"{name}: logits {tuple(logits.shape)}")
            if bool(metrics["abft_graph_flags"].any()):
                raise AssertionError(f"{name}: clean batch flagged")
            path_logits[name].append(logits)
            for got, want in zip(per_graph_rows(pb, logits),
                                 dense_f64_logits(torch, pb, params)):
                worst = max(worst, assert_close(
                    f"{name} logits vs f64 dense", got.double(), want,
                    atol=LOGIT_ATOL, rtol=0.0))
        logit_err[name] = worst
    cross = max(assert_close("two-pass vs fused-layer logits", a, b,
                             atol=LOGIT_ATOL, rtol=0.0)
                for a, b in zip(path_logits["two_pass"],
                                path_logits["fused_layer"]))
    # the network runs each layer's stripes through the fused layer's code
    for a, b in zip(path_logits["fused_network"], path_logits["fused_layer"]):
        if not torch.equal(a, b):
            raise AssertionError(f"fused-network vs fused-layer logits: max "
                                 f"abs diff {max_err(a, b):.3e}, not bitwise")

    result = {"logits_max_abs_err_vs_f64": logit_err,
              "two_pass_vs_fused_max_abs": cross,
              "network_vs_fused_layer": "bitwise", "dims": list(DIMS),
              "batches": len(batches), "shapes": len(shapes),
              "per_batch_host_clock": split_ms}
    launches = {}
    for name, (opts, kernel, per_step) in paths.items():
        guard = ABFTGuard()
        runtime.reset_counts()
        stats = serve_gcn.serve(batches, params, cfg, guard=guard,
                                device="cuda", **opts)
        counts, plain = runtime.launch_counts(), runtime.plain_counts()
        timed = counts[kernel] - len(shapes) * per_step
        others = {k: v for k, v in counts.items() if k != kernel}
        if timed != len(batches) * per_step or any(others.values()):
            raise AssertionError(
                f"{name}: launches {counts} — expected {kernel} = (shapes "
                f"{len(shapes)} + batches {len(batches)}) x {per_step} and "
                f"no other kernel")
        if any(plain.values()):
            raise AssertionError(f"{name}: plain versions called {plain}")
        if stats["flags"] or stats["graph_flags"].any():
            raise AssertionError(f"{name}: clean stream flagged "
                                 f"{stats['graph_flags']}")
        want_hits = {"fused_layer": ("fused_hits", len(batches) * n_layers),
                     "fused_network": ("network_hits", len(batches))}
        if name in want_hits and stats[want_hits[name][0]] != \
                want_hits[name][1]:
            raise AssertionError(f"{name}: fusion counts {stats}")
        launches[kernel] = counts[kernel]
        result[name] = dict(
            graphs=stats["graphs"], seconds=stats["seconds"],
            graphs_per_sec=stats["graphs_per_sec"], launches=counts,
            launches_timed_phase=timed, plain_calls=plain,
            flags=int(stats["flags"]),
            max_rel=float(stats["graph_max_rel"].max()),
            **{k: stats[k] for k in ("fused_hits", "fused_fallbacks",
                                     "network_hits", "network_fallbacks")})

    # the other tile shape: block 32 at the CLI's default widths
    for name, extra in (("block32_two_pass", []),
                        ("block32_fused_layer", ["--fused-layer"]),
                        ("block32_fused_network_slot",
                         ["--fused-network", "--check-granularity", "slot"])):
        runtime.reset_counts()
        stats = serve_gcn.main(["--backend", "block_ell", "--graphs", "32",
                                "--block", "32"] + extra)
        if stats["flags"] or stats["graph_flags"].any() \
                or any(runtime.plain_counts().values()):
            raise AssertionError(f"{name}: {stats}")
        result[name] = dict(graphs_per_sec=stats["graphs_per_sec"],
                            launches=runtime.launch_counts())
    emit("serve", **result)
    return launches


def host(t):
    return t.cpu().numpy() if hasattr(t, "cpu") else t


def phase_fault(torch, batches, params):
    """Accumulator upsets at layer 0 and layer 1.  Two-pass and fused-layer
    at graph granularity: exactly the graph that owns the stripe flags, the
    per-graph retry clears it, and the repaired logits equal the clean
    run's.  Two-pass at stripe granularity: exactly the owner and the hit
    stripe flag, the stripe tier alone repairs it by replaying the stripe
    through spmm_abft against the stashed X, within ``REPAIR_ATOL`` of the
    clean logits (the downstream refresh of X is a product of another
    shape, so not bit for bit), from fewer rows than a per-graph retry.  The whole-network path at graph, stripe and slot granularity:
    exactly the owner flags (and, finer, exactly the hit stripe / slot),
    the matching tier repairs it and re-verifies clean, and the stripe and
    slot tiers' logits are bit for bit the clean run's, from fewer rows
    than the per-graph retry re-runs."""
    import numpy as np

    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine import fold_w_r
    from repro_torch.engine.streaming import PackedRunner
    from repro_torch.kernels import runtime
    from repro_torch.runtime import ABFTGuard

    cfg = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    folded = fold_w_r(params, cfg)
    pb = batches[0]
    # first stripe of the last graph: beyond every stripe index of the
    # one-graph retry pack, so the retry itself runs clean (a transient)
    owner = pb.n_graphs - 1
    stripe = int(pb.row_offsets[owner]) // pb.block
    cases = []
    for fused in (False, True):
        clean_runner = PackedRunner(folded, cfg, 128, fused_layer=fused,
                                    device="cuda")
        clean, _ = clean_runner.step_for(pb)(*clean_runner.args_for(pb))
        for layer in (0, 1):
            runner = PackedRunner(folded, cfg, 128, fused_layer=fused,
                                  inject=(layer, stripe, 1, 50.0),
                                  device="cuda")
            step, args = runner.step_for(pb), runner.args_for(pb)
            _, raw = step(*args)
            first = host(raw["abft_graph_flags"])
            want = [g == owner for g in range(pb.n_slots)]
            if first.tolist() != want:
                raise AssertionError(f"fault fused={fused} layer={layer}: "
                                     f"flags {first.tolist()}, owner {owner}")
            guard = ABFTGuard()
            out, metrics = guard.run_step_graphs(step, runner.retry_fn(pb),
                                                 *args)
            torch.cuda.synchronize()
            final = host(metrics["abft_graph_flags"])
            if final.any() or guard.graph_retries != 1 or guard.flags != 1:
                raise AssertionError(
                    f"fault fused={fused} layer={layer}: final flags "
                    f"{final.tolist()}, graph_retries {guard.graph_retries}")
            err = assert_close("repaired logits vs clean", out, clean,
                               atol=REPAIR_ATOL, rtol=0.0)
            cases.append(dict(fused_layer=fused, layer=layer, stripe=stripe,
                              owner_graph=owner, flagged=first.tolist(),
                              graph_retries=guard.graph_retries,
                              final_flags=final.tolist(),
                              repaired_max_abs_err=err))

    n_layers = len(params["layers"])
    per_graph_rows = int(pb.n_nodes[owner]) * n_layers
    # the two-pass path at stripe granularity: the stripe tier replays the
    # hit stripes through spmm_abft against the stashed X
    clean_runner = PackedRunner(folded, cfg, 128, device="cuda")
    clean, _ = clean_runner.step_for(pb)(*clean_runner.args_for(pb))
    for layer in (0, 1):
        runner = PackedRunner(folded, cfg, 128, granularity="stripe",
                              inject=(layer, stripe, 1, 50.0), device="cuda")
        step, args = runner.step_for(pb), runner.args_for(pb)
        _, raw = step(*args)
        tag = f"fault two-pass stripe layer={layer}"
        first = host(raw["abft_graph_flags"])
        if first.tolist() != [g == owner for g in range(pb.n_slots)]:
            raise AssertionError(f"{tag}: flags {first.tolist()}, owner "
                                 f"{owner}")
        got = [tuple(int(v) for v in ix)
               for ix in np.argwhere(host(raw["abft_stripe_flags"]))]
        if got != [(layer, stripe)]:
            raise AssertionError(f"{tag}: abft_stripe_flags at {got}, want "
                                 f"{[(layer, stripe)]}")
        guard = ABFTGuard()
        runtime.reset_counts()
        out, metrics = guard.run_step_graphs(
            step, runner.retry_fn(pb), *args,
            stripe_retry_fn=runner.stripe_retry_fn(pb))
        torch.cuda.synchronize()
        repair_launches = runtime.launch_counts()
        final = host(metrics["abft_graph_flags"])
        tiers = guard.repair_tiers()
        if final.any() or tiers["stripe"] < 1 or guard.flags != 1 or any(
                tiers[t] for t in ("slot", "graph", "restore")):
            raise AssertionError(f"{tag}: final flags {final.tolist()}, "
                                 f"tiers {tiers}")
        err = assert_close(f"{tag} repaired vs clean", out, clean,
                           atol=REPAIR_ATOL, rtol=0.0)
        if guard.recomputed_rows >= per_graph_rows:
            raise AssertionError(f"{tag}: {guard.recomputed_rows} rows "
                                 f"recomputed, per-graph retry "
                                 f"{per_graph_rows}")
        if repair_launches["spmm_abft"] < 1:
            raise AssertionError(f"{tag}: the stripe tier launched "
                                 f"{repair_launches}, no spmm_abft replay")
        cases.append(dict(fused_layer=False, granularity="stripe",
                          layer=layer, stripe=stripe, owner_graph=owner,
                          flagged=first.tolist(), stripe_flags=got,
                          repair_tiers={t: tiers[t] for t in
                                        ("slot", "stripe", "graph")},
                          recomputed_rows=guard.recomputed_rows,
                          per_graph_retry_rows=per_graph_rows,
                          repair_launches=repair_launches,
                          final_flags=final.tolist(),
                          repaired_bitwise=bool(torch.equal(out, clean)),
                          repaired_max_abs_err=err))

    clean_runner = PackedRunner(folded, cfg, 128, fused_network=True,
                                device="cuda")
    clean, _ = clean_runner.step_for(pb)(*clean_runner.args_for(pb))
    slot = 1
    for gran in ("graph", "stripe", "slot"):
        for layer in (0, 1):
            runner = PackedRunner(folded, cfg, 128, fused_network=True,
                                  granularity=gran,
                                  inject=(layer, stripe, slot, 50.0),
                                  device="cuda")
            step, args = runner.step_for(pb), runner.args_for(pb)
            _, raw = step(*args)
            tag = f"fault network {gran} layer={layer}"
            first = host(raw["abft_graph_flags"])
            if first.tolist() != [g == owner for g in range(pb.n_slots)]:
                raise AssertionError(f"{tag}: flags {first.tolist()}, "
                                     f"owner {owner}")
            hits = {"stripe": [(layer, stripe)],
                    "slot": [(layer, stripe, slot)]}
            for key, want in (("abft_stripe_flags", hits["stripe"]),
                              ("abft_slot_flags", hits["slot"])):
                if key in raw:
                    got = [tuple(int(v) for v in ix)
                           for ix in np.argwhere(host(raw[key]))]
                    if got != want:
                        raise AssertionError(f"{tag}: {key} at {got}, "
                                             f"want {want}")
            guard = ABFTGuard()
            runtime.reset_counts()
            out, metrics = guard.run_step_graphs(
                step, runner.retry_fn(pb), *args,
                stripe_retry_fn=(runner.stripe_retry_fn(pb)
                                 if gran != "graph" else None),
                slot_retry_fn=(runner.slot_retry_fn(pb)
                               if gran == "slot" else None))
            torch.cuda.synchronize()
            repair_launches = runtime.launch_counts()
            final = host(metrics["abft_graph_flags"])
            tiers = guard.repair_tiers()
            others = [t for t in ("slot", "stripe", "graph", "restore")
                      if t != gran and tiers[t]]
            # each tier counts what it re-ran (graphs, stripes)
            if final.any() or tiers[gran] < 1 or others or guard.flags != 1:
                raise AssertionError(f"{tag}: final flags {final.tolist()}, "
                                     f"tiers {tiers}")
            bitwise = bool(torch.equal(out, clean))
            if gran == "graph":
                err = assert_close(f"{tag} repaired vs clean", out, clean,
                                   atol=REPAIR_ATOL, rtol=0.0)
            elif not bitwise:
                raise AssertionError(f"{tag}: repaired logits differ from "
                                     f"the clean run by {max_err(out, clean)}")
            else:
                err = 0.0
            if gran != "graph" and guard.recomputed_rows >= per_graph_rows:
                raise AssertionError(f"{tag}: {guard.recomputed_rows} rows "
                                     f"recomputed, per-graph retry "
                                     f"{per_graph_rows}")
            cases.append(dict(fused_network=True, granularity=gran,
                              layer=layer, stripe=stripe, slot=slot,
                              owner_graph=owner, flagged=first.tolist(),
                              repair_tiers={t: tiers[t] for t in
                                            ("slot", "stripe", "graph")},
                              recomputed_rows=guard.recomputed_rows,
                              per_graph_retry_rows=per_graph_rows,
                              repair_launches=repair_launches,
                              final_flags=final.tolist(),
                              repaired_bitwise=bitwise,
                              repaired_max_abs_err=err))
    emit("fault", cases=cases)


def phase_stream(torch, params, smi):
    """The streaming server (``StreamingEngine``, whole-network path, slot
    corners) over a Cora-width stream, rungs planned from its first
    requests: every request served clean with logits against the float64
    dense forward, step shapes within the rung table, every batch through
    the network kernel, p50/p99 enqueue->verdict latency; then one upset
    in a single-batch stream, repaired by the slot tier bit for bit."""
    import numpy as np

    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine import (StreamingEngine, plan_rungs,
                                    synth_graph_stream)
    from repro_torch.engine.batching import graph_pack_stats, pack_graphs
    from repro_torch.kernels import runtime

    cfg = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    stream = synth_graph_stream(STREAM["n_requests"], n_lo=SERVE["n_lo"],
                                n_hi=SERVE["n_hi"], feat=DIMS[0],
                                avg_deg=SERVE["avg_deg"], seed=SERVE["seed"])
    rungs = plan_rungs(stream[:STREAM["profile"]],
                       n_slots=STREAM["n_slots"], block=SERVE["block"],
                       stripe_multiple=SERVE["stripe_multiple"],
                       width_multiple=SERVE["width_multiple"])

    # the host work one full bin costs before its step (host clock): the
    # rung fit of each request, then packing the bin
    first = stream[:STREAM["n_slots"]]
    t0 = time.perf_counter()
    for s, _ in first:
        graph_pack_stats(s, SERVE["block"])
    t1 = time.perf_counter()
    pack_graphs(first, block=rungs.block, n_slots=STREAM["n_slots"],
                stripe_multiple=rungs.stripe_multiple,
                width_multiple=rungs.width_multiple,
                stripe_cap=rungs.rungs[0].stripe_cap,
                width_cap=rungs.rungs[0].width_cap)
    host_ms = dict(fit_per_request=(t1 - t0) * 1e3 / len(first),
                   pack_per_bin=(time.perf_counter() - t1) * 1e3)

    def engine(**kw):
        return StreamingEngine(params, cfg, rungs, fused_network=True,
                               granularity="slot", device="cuda", **kw)

    def drive(eng, reqs):
        results = []
        for s, h0 in reqs:
            eng.submit(s, h0)
            results.extend(eng.take_results())
        return results + eng.drain()

    eng = engine()
    eng.warmup()
    runtime.reset_counts()
    results = drive(eng, stream)
    counts, plain = runtime.launch_counts(), runtime.plain_counts()
    stats = eng.stats(results)
    others = {k: v for k, v in counts.items() if k != "gcn_network"}
    if stats["served"] != len(stream) or stats["flagged"] \
            or stats["compiles"] > stats["rung_table_size"] \
            or stats["network_hits"] != stats["batches"] \
            or counts["gcn_network"] != stats["batches"] \
            or any(others.values()) or any(plain.values()):
        raise AssertionError(f"stream: {stats}, launches {counts}, plain "
                             f"{plain}")
    worst = 0.0
    ws = [layer["w"].double() for layer in params["layers"]]
    for r in results:
        s, h0 = stream[r.rid]
        h = torch.from_numpy(h0).to("cuda").double()
        s64 = torch.from_numpy(s).to("cuda").double()
        for i, w in enumerate(ws):
            h = s64 @ (h @ w)
            h = torch.relu(h) if i < len(ws) - 1 else h
        worst = max(worst, assert_close(
            f"stream rid {r.rid} logits vs f64 dense",
            torch.from_numpy(r.logits).to("cuda").double(), h,
            atol=LOGIT_ATOL, rtol=0.0))

    # one upset in a single-batch stream: a full bin of the first requests
    stripe = sum(graph_pack_stats(s, SERVE["block"])[0] for s, _ in first[:-1])
    faulty = engine(inject=(0, stripe, 1, 50.0))
    fres = drive(faulty, first)
    fstats = faulty.stats(fres)
    tiers = fstats["repair_tiers"]
    if fstats["served"] != len(first) or fstats["flagged"] \
            or fstats["guard_flags"] != 1 or tiers["slot"] < 1 \
            or tiers["stripe"] or tiers["graph"] or tiers["restore"] \
            or fstats["degrades"]:
        raise AssertionError(f"stream fault: {fstats}")
    clean = {r.rid: r.logits for r in results}
    for a in fres:
        if not np.array_equal(a.logits, clean[a.rid]):
            raise AssertionError(f"stream fault: rid {a.rid} repaired "
                                 f"logits differ from the clean stream's")
    emit("stream", nvidia_smi=smi, requests=stats["submitted"],
         served=stats["served"], batches=stats["batches"],
         rungs=[vars(r) for r in rungs.rungs],
         compiles=stats["compiles"], rung_table_size=stats["rung_table_size"],
         latency_p50_ms=stats["latency_p50_ms"],
         latency_p99_ms=stats["latency_p99_ms"],
         latency_max_ms=stats["latency_max_ms"],
         graphs_per_sec=stats["graphs_per_sec"], host_clock_ms=host_ms,
         network_hits=stats["network_hits"], launches=counts,
         logits_max_abs_err_vs_f64=worst,
         fault=dict(inject=[0, stripe, 1, 50.0], served=fstats["served"],
                    guard_flags=fstats["guard_flags"],
                    repair_tiers={t: tiers[t] for t in
                                  ("slot", "stripe", "graph", "restore")},
                    repaired_bitwise=True))


def phase_full_graph(torch, params):
    """One whole Cora-sized graph through gcn_apply on the block-ELL
    backend, every path, against the dense backend."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.core.datasets import make_dataset
    from repro_torch.engine import Graph, fold_w_r, gcn_apply
    from repro_torch.kernels import runtime

    cfg = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    folded = fold_w_r(params, cfg)
    ds = make_dataset("cora")
    bell = ds.s.to_block_ell(128, 128)
    h0 = ds.features.todense()
    dense, dense_rep = gcn_apply(folded, Graph(ds.s.todense(), h0), cfg,
                                 backend="dense", device="cuda")
    result = dict(nodes=int(h0.shape[0]), stripes=bell.n_block_rows,
                  width=bell.width)
    for name, opts in (("two_pass", {}), ("fused_layer", {"fused_layer": True}),
                       ("fused_network", {"fused_network": True})):
        runtime.reset_counts()
        logits, rep = gcn_apply(folded, Graph(bell, h0), cfg,
                                backend="block_ell", device="cuda", **opts)
        torch.cuda.synchronize()
        if logits.shape != (h0.shape[0], DIMS[-1]) or bool(rep.flag) \
                or bool(dense_rep.flag):
            raise AssertionError(f"full graph {name}: shape "
                                 f"{tuple(logits.shape)} flag {bool(rep.flag)}")
        result[name] = dict(
            max_abs_err_vs_dense=assert_close(
                f"full graph {name} vs dense", logits, dense,
                atol=LOGIT_ATOL, rtol=0.0),
            max_rel=float(rep.max_rel), launches=runtime.launch_counts(),
            plain_calls=runtime.plain_counts())
        if any(runtime.plain_counts().values()):
            raise AssertionError(f"full graph {name}: plain version called")
    emit("full_graph", **result)


def f64_forward(ds, params):
    """The float64 GCN forward S relu(S (H0 W0)) W1 ... on the host with
    scipy's sparse products (S and H0 stay sparse)."""
    import numpy as np
    import scipy.sparse as sp

    def csr(coo):
        return sp.csr_matrix((coo.data.astype(np.float64),
                              (coo.row, coo.col)), shape=coo.shape)

    s, h = csr(ds.s), csr(ds.features)
    ws = [layer["w"].double().cpu().numpy() for layer in params["layers"]]
    for i, w in enumerate(ws):
        h = s @ (h @ w)
        if i < len(ws) - 1:
            h = np.maximum(h, 0.0)
    return h


def phase_sparse(torch):
    """The paper's layer API and the sparse path on the card: the
    quickstart's flow at full Cora (dense against sparse, split against
    fused, B1 through gcn_layer_fused_sparse_kernel), then full NELL
    through dataset_to_sparse and gcn_apply_sparse on the "bcoo" backend,
    against a float64 forward; whether cuSPARSE repeats bit for bit, in
    COO and in CSR.  Returns the B1 launches of the driven run."""
    from repro_torch.core.abft import (ABFTConfig, Check, _total,
                                       gcn_layer_fused,
                                       gcn_layer_fused_sparse,
                                       gcn_layer_split)
    from repro_torch.core.datasets import make_dataset
    from repro_torch.core.gcn import (dataset_to_sparse, gcn_apply,
                                      gcn_apply_sparse, init_gcn,
                                      precompute_s_c)
    from repro_torch.engine import make_backend
    from repro_torch.kernels import runtime
    from repro_torch.kernels.spmm_abft.ops import \
        gcn_layer_fused_sparse_kernel

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("sparse: TF32 is on — f32 products must stay "
                             "on FFMA")
    cfg = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    gen = torch.Generator().manual_seed(SPARSE["seed"])
    result = {}

    # the quickstart's flow at full Cora
    ds = make_dataset(SPARSE["quick"])
    params = init_gcn(gen, ds.stats.layer_dims, device="cuda")
    s_sp, h_sp, _ = dataset_to_sparse(ds, device="cuda")
    runtime.reset_counts()
    dense, rep_d = gcn_apply(params, ds.s.todense(), ds.features.todense(),
                             cfg, device="cuda")
    sparse, rep_s = gcn_apply_sparse(params, s_sp, h_sp, cfg,
                                     precompute_s_c(s_sp, cfg),
                                     device="cuda")
    w0 = params["layers"][0]["w"]
    out_split, split_checks = gcn_layer_split(s_sp, h_sp, w0, cfg,
                                              device="cuda")
    out_fused, fused_chk = gcn_layer_fused(s_sp, h_sp, w0, cfg,
                                           device="cuda")
    out_kernel, kernel_chk = gcn_layer_fused_sparse_kernel(
        ds.s.to_block_ell(128, 128), h_sp, w0, w_r=w0.sum(dim=1),
        device="cuda")
    torch.cuda.synchronize()
    launches, plain = runtime.launch_counts(), runtime.plain_counts()
    flags = [bool(r.flag) for r in (rep_d, rep_s)] + [
        bool(c.flag(cfg)) for c in (*split_checks, fused_chk, kernel_chk)]
    if any(flags) or len(split_checks) != 2:
        raise AssertionError(f"sparse cora: flags {flags}, split checks "
                             f"{len(split_checks)}")
    if launches["spmm_abft"] != 1 or any(
            v for k, v in launches.items() if k != "spmm_abft") \
            or any(plain.values()):
        raise AssertionError(f"sparse cora: launches {launches}, plain "
                             f"{plain}")
    result["cora"] = dict(
        nodes=ds.stats.nodes, dims=list(ds.stats.layer_dims),
        sparse_vs_dense_max_abs=assert_close(
            "cora sparse vs dense logits", sparse, dense, atol=LOGIT_ATOL,
            rtol=0.0),
        split_vs_fused_bitwise=bool(torch.equal(out_split, out_fused)),
        split_vs_fused_max_abs=assert_close(
            "cora split vs fused layer", out_split, out_fused),
        kernel_vs_sparse_max_abs=assert_close(
            "cora B1 layer vs sparse layer", out_kernel, out_fused),
        checks_split=len(split_checks), checks_fused=1,
        max_rel=float(rep_s.max_rel), launches=launches)
    spmm_launches = launches["spmm_abft"]
    del params, s_sp, h_sp

    # full NELL on the sparse path
    t0 = time.perf_counter()
    ds = make_dataset(SPARSE["graph"])
    t1 = time.perf_counter()
    params = init_gcn(torch.Generator().manual_seed(SPARSE["seed"]),
                      ds.stats.layer_dims, device="cuda")
    s_sp, h_sp, _ = dataset_to_sparse(ds, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    s_c = precompute_s_c(s_sp, cfg)
    torch.cuda.synchronize()
    s_c_ms = (time.perf_counter() - t2) * 1e3
    want = torch.from_numpy(f64_forward(ds, params)).to("cuda")
    runtime.reset_counts()
    logits, rep = gcn_apply_sparse(params, s_sp, h_sp, cfg, s_c,
                                   device="cuda")
    again, _ = gcn_apply_sparse(params, s_sp, h_sp, cfg, s_c, device="cuda")
    torch.cuda.synchronize()
    if any(runtime.launch_counts().values()) \
            or any(runtime.plain_counts().values()):
        raise AssertionError(f"sparse nell: kernels {runtime.launch_counts()}"
                             f" on the bcoo path")
    if logits.shape != want.shape or bool(rep.flag) \
            or float(rep.max_rel) > CORNER_RTOL:
        raise AssertionError(f"sparse nell: logits {tuple(logits.shape)}, "
                             f"flag {bool(rep.flag)}, max_rel "
                             f"{float(rep.max_rel):.3e}")
    err = assert_close("nell logits vs f64", logits.double(), want,
                       atol=LOGIT_ATOL, rtol=NELL_LOGIT_RTOL)
    # a corrupted output element diverges past tau
    h_out, chk = gcn_layer_fused_sparse(s_sp, h_sp,
                                        params["layers"][0]["w"], cfg, s_c,
                                        device="cuda")
    bad = h_out.clone()
    i, j = SPARSE["corrupt"]
    bad[i, j] += 10.0 * max(float(bad.abs().max()), 1.0)
    bad_chk = Check(predicted=chk.predicted, actual=_total(bad, cfg))
    if bool(chk.flag(cfg)) or not bool(bad_chk.flag(cfg)):
        raise AssertionError(f"sparse nell: clean flag {bool(chk.flag(cfg))}"
                             f", corrupted flag {bool(bad_chk.flag(cfg))}")
    # does cuSPARSE repeat bit for bit?  The same product twice, per layout
    x = h_sp @ params["layers"][0]["w"]
    repeats = {}
    for name, layout in (("coo", torch.sparse_coo),
                         ("csr", torch.sparse_csr)):
        s_l = ds.s.to_sparse(device="cuda", layout=layout)
        s_l = s_l.coalesce() if layout == torch.sparse_coo else s_l
        a, b = torch.sparse.mm(s_l, x), torch.sparse.mm(s_l, x)
        torch.cuda.synchronize()
        repeats[name] = dict(bitwise=bool(torch.equal(a, b)),
                             max_abs=max_err(a, b),
                             ms=time_ms(lambda: torch.sparse.mm(s_l, x)))
        del s_l

    def forward():
        gcn_apply_sparse(params, s_sp, h_sp, cfg, s_c, device="cuda")

    result["nell"] = dict(
        nodes=ds.stats.nodes, dims=list(ds.stats.layer_dims),
        s_nnz=ds.s.nnz, features_nnz=ds.features.nnz,
        h0_bytes=nbytes(h_sp), layout=str(s_sp.layout),
        backend_layout=str(make_backend(s_sp, cfg, s_c=s_c,
                                        device="cuda").s.layout),
        logits_max_abs_err_vs_f64=err, max_rel=float(rep.max_rel),
        flags=int(bool(rep.flag)), two_runs_bitwise=bool(
            torch.equal(logits, again)),
        corrupted_divergence=float(bad_chk.diff()),
        threshold=cfg.threshold * max(1.0, abs(float(bad_chk.actual))),
        clean_divergence=float(chk.diff()),
        cusparse_repeats=repeats, forward_ms=time_ms(forward, warm=1,
                                                     reps=SPARSE["reps"]),
        s_c_precompute_ms=s_c_ms,
        host_seconds=dict(make_dataset=t1 - t0, to_device=t2 - t1))
    del params, s_sp, h_sp, want, x, logits, again, h_out, bad
    torch.cuda.empty_cache()
    emit("sparse", **result)
    return {"spmm_abft": spmm_launches}


def phase_sharded(torch):
    """Stripe sharding on the card: full PubMed at block 128, staged once,
    1, 2 and 4 shards on the two-pass (B1) and fused-layer (B2) paths at
    layer and stripe granularity, against the unsharded run (rows and
    stripe corners bit for bit, layer corners within rtol 1e-6) and the
    float64 forward.  Returns the B1 and B2 launches of the driven runs."""
    from repro_torch.core.abft import ABFTConfig, summarize
    from repro_torch.core.datasets import make_dataset
    from repro_torch.core.gcn import init_gcn
    from repro_torch.engine import Graph, Partition, fold_w_r, gcn_forward
    from repro_torch.engine.backends import BlockEllBackend
    from repro_torch.kernels import runtime
    from repro_torch.kernels.gcn_fused.kernel import gcn_fused_kernel
    from repro_torch.kernels.gcn_fused.ops import prepare_fused_operands
    from repro_torch.kernels.spmm_abft.kernel import spmm_abft_kernel
    from repro_torch.kernels.spmm_abft.layout import pad_block_rows
    from repro_torch.kernels.spmm_abft.ops import (device_block_ell,
                                                   prepare_operands)
    from repro_torch.launch.mesh import make_graph_mesh

    t0 = time.perf_counter()
    cfg = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    ds = make_dataset(SHARDED["graph"])
    params = fold_w_r(init_gcn(torch.Generator().manual_seed(
        SHARDED["seed"]), ds.stats.layer_dims, device="cuda"), cfg)
    n_layers = len(params["layers"])
    block = SHARDED["block"]
    raw = ds.s.to_block_ell(block, block)
    bell = pad_block_rows(raw, max(SHARDED["shards"]))
    staged = device_block_ell(bell, "cuda")
    h0 = torch.from_numpy(ds.features.todense()).to("cuda")
    graph = Graph(bell, h0)
    want = torch.from_numpy(f64_forward(ds, params)).to("cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cols, vals = staged
    nbm, width = bell.n_block_rows, bell.width
    result = dict(nodes=ds.stats.nodes, dims=list(ds.stats.layer_dims),
                  stripes=raw.n_block_rows, padded_stripes=nbm, width=width,
                  stored_tiles=nbm * width, nonzero_tiles=bell.nnz_tiles,
                  tile_bytes=nbytes(vals), setup_seconds=setup_s)
    launches = {"spmm_abft": 0, "gcn_fused": 0}
    paths = (("two_pass", {}, "spmm_abft"),
             ("fused_layer", {"fused_layer": True}, "gcn_fused"))
    for path, opts, kernel in paths:
        runs = {}
        for gran in ("layer", "stripe"):
            def backend(part):
                return BlockEllBackend(bell, cfg, partition=part,
                                       granularity=gran, staged=staged,
                                       device="cuda", **opts)
            base_bk = backend(None)
            base_logits, base_checks = gcn_forward(params, graph, cfg,
                                                   backend=base_bk)
            for n in SHARDED["shards"]:
                tag = f"sharded {path} {gran} x{n}"
                bk = backend(Partition(make_graph_mesh(n, device="cuda")))
                runtime.reset_counts()
                logits, checks = gcn_forward(params, graph, cfg, backend=bk)
                torch.cuda.synchronize()
                counts, plain = runtime.launch_counts(), \
                    runtime.plain_counts()
                others = {k: v for k, v in counts.items() if k != kernel}
                if counts[kernel] != n * n_layers or any(others.values()) \
                        or any(plain.values()):
                    raise AssertionError(f"{tag}: launches {counts}, plain "
                                         f"{plain}; expected {kernel} = "
                                         f"{n} x {n_layers}")
                launches[kernel] += counts[kernel]
                if not torch.equal(logits, base_logits):
                    raise AssertionError(f"{tag}: logits differ from the "
                                         f"unsharded run by "
                                         f"{max_err(logits, base_logits):.3e}"
                                         f", not bitwise")
                corner_err = 0.0
                for c, b in zip(checks, base_checks):
                    for got, ref in ((c.predicted, b.predicted),
                                     (c.actual, b.actual)):
                        if gran == "stripe" and not torch.equal(got, ref):
                            raise AssertionError(f"{tag}: stripe corners "
                                                 f"not bitwise")
                        if not torch.allclose(got, ref, rtol=1e-6, atol=0.0):
                            raise AssertionError(f"{tag}: layer corner "
                                                 f"{float(got)} vs "
                                                 f"{float(ref)}")
                        corner_err = max(corner_err, float(
                            ((got - ref).abs() / ref.abs().clamp(
                                min=1e-30)).max()))
                rep = summarize(checks, cfg)
                if bool(rep.flag):
                    raise AssertionError(f"{tag}: clean run flagged")
                err = assert_close(f"{tag} logits vs f64", logits.double(),
                                   want, atol=LOGIT_ATOL, rtol=0.0)
                entry = dict(launches=counts[kernel], logits_bitwise=True,
                             corners_bitwise=gran == "stripe",
                             corner_max_rel_vs_unsharded=corner_err,
                             logits_max_abs_err_vs_f64=err,
                             max_rel=float(rep.max_rel))
                if gran == "layer":
                    entry["forward_ms"] = time_ms(
                        lambda: gcn_forward(params, graph, cfg, backend=bk),
                        warm=1, reps=SHARDED["reps"])
                runs[f"{gran}_x{n}"] = entry
            if gran == "layer":
                runs["layer_unsharded_forward_ms"] = time_ms(
                    lambda: gcn_forward(params, graph, cfg,
                                        backend=base_bk),
                    warm=1, reps=SHARDED["reps"])
        result[path] = runs

    # one shard's launch alone, layer 0's operands: B1 on S (H0 W0), B2 on
    # H0, W0, w_r0; the slab of shard 0 at each shard count
    w0, wr0 = params["layers"][0]["w"], params["layers"][0]["w_r"]
    xp, xrp = prepare_operands(bell, h0 @ w0, (h0 @ wr0)[:, None], block)
    hp, wp, wrp = prepare_fused_operands(bell, h0, w0, wr0, block)
    out_bytes = nbm * block * (xp.shape[1] + 1) * 4 + nbm * 4
    bound_ms = (nbytes(cols, vals, xp, xrp) + out_bytes) \
        / PEAK_BYTES_PER_S * 1e3
    per_launch = {}
    for n in SHARDED["shards"]:
        per = nbm // n
        c, v = cols[:per], vals[:per]
        per_launch[f"x{n}"] = dict(
            stripes=per, b1_ms=time_ms(lambda: spmm_abft_kernel(c, v, xp,
                                                                 xrp)),
            b2_ms=time_ms(lambda: gcn_fused_kernel(c, v, hp, wp, wrp)))
    result.update(
        shard_launch_layer0=per_launch,
        b1_bound_ms_whole_table_layer0=bound_ms,
        b2_combination_recomputed_bytes={
            f"x{n}": (n - 1) * nbytes(hp) for n in SHARDED["shards"]},
        seconds=time.perf_counter() - t0)
    del staged, cols, vals, h0, want, xp, xrp, hp
    torch.cuda.empty_cache()
    emit("sharded", **result)
    return launches


def campaign_table(payload) -> None:
    """The campaign's by-(site, kind) table, repair tiers and clean
    control, one line each."""
    from repro_torch.launch.campaign import print_table
    print_table(payload)
    sys.stdout.flush()


def campaign_summary(payload) -> dict:
    return {k: payload[k] for k in ("backend", "authoritative", "config",
                                    "clean_control", "by_site_kind",
                                    "repair_tiers_total")}


def _experiments(payload, site, kind=None, nan=None):
    """The payload's experiments of one site (and kind; ``nan``: only the
    NaN stuck-ats, which ``FaultModel.to_dict`` writes as "nan")."""
    return [e for e in payload["experiments"]
            if e["model"]["site"] == site
            and (kind is None or e["model"]["kind"] == kind)
            and (nan is None or (e["model"]["stuck_value"] == "nan") == nan)]


def phase_campaign_gcn(torch):
    """The chaos campaign's GCN lane on the card: every fault site x kind
    of ``sweep_models`` through the packed two-pass path (B1 with its
    ``inject=`` hook) and the guard's repair tiers, at Cora's widths.
    Gates: the delta-50 accumulator upsets detected at latency 0, the
    sticky ones escalating; no clean flag; the NaN check-path stuck-ats
    would-be false negatives caught by the self-check; the sticky weight
    fault escalating as a persistent site; B1 launched, no plain version
    called.  The delta-1.0 accumulator upsets are measured beside the hit
    graph's threshold."""
    import dataclasses

    from repro_torch.faults import sweep_models
    from repro_torch.faults.campaign import run_fault_campaign
    from repro_torch.kernels import runtime

    kw = {k: CAMPAIGN[k] for k in ("n_graphs", "n_lo", "n_hi", "feat",
                                   "hidden", "n_out", "block", "seed")}
    grid = sweep_models(reps=CAMPAIGN["reps"], seed=CAMPAIGN["seed"])
    gated = [dataclasses.replace(m, delta=CAMPAIGN["gated_delta"])
             if m.site == "accumulator" else m for m in grid]
    measured = [m for m in grid if m.site == "accumulator"]

    runtime.reset_counts()
    t0 = time.perf_counter()
    payload = run_fault_campaign(gated, n_steps=CAMPAIGN["n_steps"],
                                 device="cuda", **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = runtime.launch_counts(), runtime.plain_counts()
    runtime.reset_counts()
    t0 = time.perf_counter()
    low = run_fault_campaign(measured, n_steps=CAMPAIGN["n_steps"],
                             device="cuda", **kw)
    torch.cuda.synchronize()
    low_seconds = time.perf_counter() - t0
    low_launches, low_plain = runtime.launch_counts(), runtime.plain_counts()

    # the accumulator's hit graph and its clean threshold at that layer,
    # from the campaign's own clean reference forward
    clean = low["clean_checks"]
    thresholds = []
    for e in low["experiments"]:
        m = e["model"]
        g = clean["stripe_graph"][m["stripe"]]
        thresholds.append(dict(
            label=e["label"], seed=m["seed"], layer=m["layer"],
            stripe=m["stripe"], slot=m["slot"], delta=m["delta"],
            hit_graph=g, actual=clean["actual"][m["layer"]][g],
            threshold=clean["threshold"][m["layer"]][g],
            detected=e["detected"], flagged_steps=e["flagged_steps"],
            sdc_steps=e["sdc_steps"], masked_steps=e["masked_steps"]))

    print("campaign gcn (accumulator delta "
          f"{CAMPAIGN['gated_delta']}, gated):")
    campaign_table(payload)
    print("campaign gcn (accumulator delta 1.0, measured):")
    campaign_table(low)
    emit("campaign_gcn", seconds=seconds, launches=launches,
         plain_calls=plain, gated=campaign_summary(payload),
         delta_1=dict(seconds=low_seconds, launches=low_launches,
                      plain_calls=low_plain,
                      by_site_kind=low["by_site_kind"],
                      repair_tiers_total=low["repair_tiers_total"],
                      hit_graph_thresholds=thresholds))

    agg = payload["by_site_kind"]
    failures = []
    for kind in ("bitflip", "stuck"):
        a = agg[f"accumulator/{kind}"]
        if a["detection_rate"] != 1.0 or a["mean_detection_latency"] != 0.0:
            failures.append(f"accumulator/{kind}: {a}")
    if agg["accumulator/stuck"]["escalations"] != \
            agg["accumulator/stuck"]["n"]:
        failures.append(f"accumulator/stuck escalations "
                        f"{agg['accumulator/stuck']}")
    if payload["clean_control"]["flagged"] or low["clean_control"]["flagged"]:
        failures.append(f"clean control {payload['clean_control']}")
    for site in ("w_r", "s_c"):
        nans = _experiments(payload, site, "stuck", nan=True)
        if not nans or not all(e["would_be_false_negative"]
                               and e["selfcheck_detected"] for e in nans):
            failures.append(f"{site} NaN stuck-at: {nans}")
    sticky = _experiments(payload, "weights", "stuck")
    if not sticky or not all(e["escalated"]
                             and e["repair_tiers"]["persistent_sites"]
                             for e in sticky):
        failures.append(f"weights/stuck: {sticky}")
    if launches["spmm_abft"] <= 0 or low_launches["spmm_abft"] <= 0 \
            or any(plain.values()) or any(low_plain.values()):
        failures.append(f"launches {launches}, {low_launches}, "
                        f"plain {plain}, {low_plain}")
    if not payload["authoritative"]:
        failures.append(f"payload stamp {payload['backend']}")
    if failures:
        raise AssertionError("campaign gcn: " + "; ".join(failures))
    return launches


def phase_campaign_lm(torch, cfg, master, cache_len):
    """The chaos campaign's LM lane on the card: ``lm_sweep_models`` (qkv_w
    and mlp_w weight faults, bit flip and stuck-at, and the attention
    accumulator upset) through guarded prefill and decode steps of gemma-2b
    at full width — every dense product on B4, the prefill attention on
    B5 — on the 18-layer master the serving phase built, with guarded
    steps for its cache length.  Gates: every gated site detected, no
    clean flag, B4 and B5 launched, no plain version called."""
    from repro_torch.faults.campaign import run_lm_fault_campaign
    from repro_torch.faults.model import lm_sweep_models
    from repro_torch.kernels import runtime
    from repro_torch.launch.campaign import gate_failures

    models = lm_sweep_models(reps=CAMPAIGN["lm_reps"], seed=CAMPAIGN["seed"])
    runtime.reset_counts()
    t0 = time.perf_counter()
    payload = run_lm_fault_campaign(
        models, n_decode=CAMPAIGN["lm_decode"], prompt_len=LM["prompt"],
        batch=LM["batch"], cache_len=cache_len, seed=CAMPAIGN["seed"],
        cfg=cfg, master=master, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = runtime.launch_counts(), runtime.plain_counts()
    print("campaign lm:")
    campaign_table(payload)
    emit("campaign_lm", seconds=seconds, launches=launches,
         plain_calls=plain, **campaign_summary(payload))
    failures = gate_failures(payload, "lm")
    if launches["matmul_abft"] <= 0 or launches["flash_checksum"] <= 0 \
            or any(plain.values()) or not payload["authoritative"]:
        failures.append(f"launches {launches}, plain {plain}")
    if failures:
        raise AssertionError("campaign lm: " + "; ".join(failures))
    return launches


# ---------------------------------------------------------------------------
# the checked-op path: guarded LM serving on matmul_abft and flash_checksum
# ---------------------------------------------------------------------------

def lm_config():
    """gemma-2b at its published widths, served in float32 (the dtype in
    which the JAX package serves and tests its LM)."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM["arch"]), dtype="float32")


def arch_config(name, layers=None):
    """A registered architecture at its published widths, served in
    float32; ``layers`` cuts its depth."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _mlp_products(cfg):
    """(K, N) of each matmul_abft launch of one attention or RG-LRU
    layer's MLP: a gated MLP's three or a plain (GELU) one's two, or an MoE
    layer's router and its shared experts' three (the experts themselves
    are grouped launches, :func:`lm_grouped_shapes`)."""
    d = cfg.d_model
    if cfg.moe is None:
        if cfg.mlp_act in ("swiglu", "geglu"):
            return [(d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
        return [(d, cfg.d_ff), (cfg.d_ff, d)]
    mc = cfg.moe
    out = [(d, mc.n_experts)]
    if mc.n_shared:
        sff = mc.d_ff_shared or mc.n_shared * mc.d_ff_expert
        out += [(d, sff), (d, sff), (sff, d)]
    return out


def layer_products(cfg, btype):
    """(K, N) of each matmul_abft launch of one layer of type ``btype``:
    attention's q, k, v, o; RWKV6's r, k, v, g, o and its channel mix's
    two; the RG-LRU's proj_x, proj_gate, proj_out (its gates are grouped
    launches); then the MLP's."""
    d = cfg.d_model
    if btype == "rwkv":
        return [(d, d)] * 5 + [(d, cfg.d_ff), (cfg.d_ff, d)]
    if btype == "rglru":
        dr = cfg.rglru_d or d
        return [(d, dr), (d, dr), (dr, d)] + _mlp_products(cfg)
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    return [(d, hq), (d, hkv), (d, hkv), (hq, d)] + _mlp_products(cfg)


def layer_checks(cfg, btype, step="prefill", cross=False, mode="fused"):
    """Checks of one fused-mode layer of type ``btype``: RWKV6's seven;
    attention's four — with ``cross``, then the cross-attention's four in
    prefill (q, k, v, its chain) and two in decode (q, its chain) — or the
    RG-LRU's five (proj_x, proj_gate, the two gates, proj_out), then a
    gated MLP's three, a plain one's two, or an MoE layer's router, up,
    gate and fused combine checks and its shared experts' three.  A
    split-mode prefill (``mode="split"``) checks W_o's product too: an
    attention block's five (q, k, v, o, its chain)."""
    if btype == "rwkv":
        return 7
    attn = 5 if mode == "split" else 4
    mixer = 5 if btype == "rglru" else attn
    if cross and btype == "attn":
        mixer += attn if step == "prefill" else 2
    if cfg.moe is None:
        return mixer + len(_mlp_products(cfg))
    return mixer + 4 + (3 if cfg.moe.n_shared else 0)


def layer_grouped(cfg, btype):
    """Grouped matmul_abft launches of one layer: the RG-LRU's two gates,
    an MoE layer's three expert products."""
    return (2 if btype == "rglru" else 0) + \
        (3 if cfg.moe is not None and btype != "rwkv" else 0)


def block_types(cfg):
    return [cfg.block_type(i) for i in range(cfg.n_layers)]


def _stacks(cfg, step):
    """(config, cross) of each layer stack a step runs: an encoder-decoder's
    encoder first in prefill, then the decoder."""
    from repro_torch.models.transformer import encoder_cfg
    encdec = cfg.family == "encdec"
    return ([(encoder_cfg(cfg), False)] if encdec and step == "prefill"
            else []) + [(cfg, encdec)]


def step_products(cfg, step, batch=LM["batch"], prompt=LM["prompt"], src=0,
                  prefix=0):
    """(M, K, N, trans_b) of every matmul_abft launch of one prefill or
    decode step at ``batch`` x ``prompt`` (after ``prefix`` embeddings; an
    encoder-decoder's encoder over ``src`` frames): each layer's products,
    a decoder layer's cross-attention q and o over its tokens and, in
    prefill, k and v over the encoder's output; then the head over the
    last position of each sequence — the tied one multiplies by the
    embedding table as it lies (B^T), an untied one by its [d, V]
    weight."""
    d = cfg.d_model
    out = []
    for c, cross in _stacks(cfg, step):
        m = batch * (prefix + prompt) if step == "prefill" else batch
        if c is not cfg:
            m = batch * src                        # the encoder
        for bt in block_types(c):
            prods = layer_products(c, bt)
            if cross and bt == "attn":
                hq, hkv = c.n_heads * c.hd, c.n_kv_heads * c.hd
                kv = [(batch * src, d, hkv, False)] * 2 \
                    if step == "prefill" else []
                out += [(m, k, n, False) for k, n in prods[:4]] + \
                    [(m, d, hq, False)] + kv + [(m, hq, d, False)] + \
                    [(m, k, n, False) for k, n in prods[4:]]
            else:
                out += [(m, k, n, False) for k, n in prods]
    return out + [(batch, d, cfg.padded_vocab, cfg.tie_embeddings)]


def lm_step_launches(cfg, step="prefill"):
    """matmul_abft and grouped matmul_abft launches of one prefill or
    decode step (the head included), and flash_checksum's (a prefill's
    attention layers — an encoder-decoder's encoder layers and each
    decoder layer's self- and cross-attention —; decode attention is
    plain)."""
    flash = 0
    if step == "prefill":
        for c, cross in _stacks(cfg, step):
            flash += block_types(c).count("attn") * (2 if cross else 1)
    return dict(
        matmul_abft=len(step_products(cfg, step)),
        matmul_abft_grouped=sum(layer_grouped(cfg, bt)
                                for bt in block_types(cfg)),
        flash_checksum=flash)


def check_segments(cfg, step="prefill", mode="fused"):
    """(checks a unit, units, stacked, [(offset, group)] of the attention
    chain checks in a unit that an accumulator upset reaches) of each
    segment of one step, an encoder's first: every attention chain in
    prefill (group ``encoder``, ``self`` or ``cross`` for an
    encoder-decoder, else ``attention``), a decoder's self-attention chain
    alone in decode (its cross-attention over the static encoder cache has
    no inject site, as in the reference); ``mode="split"``: a split-mode
    prefill's (the chain after W_o's check)."""
    from repro_torch.models.transformer import seg_structure
    segs = []
    attn = 5 if mode == "split" else 4
    for c, cross in _stacks(cfg, step):
        encdec = cfg.family == "encdec"
        group = "attention" if not encdec else \
            "encoder" if c is not cfg else "self"
        for pattern, count in seg_structure(c):
            n, sites = 0, []
            for bt in pattern:
                if bt == "attn":
                    sites.append((n + attn - 1, group))
                    if cross and step == "prefill":
                        sites.append((n + 2 * attn - 1, "cross"))
                n += layer_checks(c, bt, step, cross, mode)
            segs.append((n, count, count > 1 and c.scan_layers, sites))
    return segs


def _op_ids(cfg, step, mode="fused"):
    """(the per-op ids of one step's checks, {group: the ids an
    accumulator upset reaches}) — see :func:`lm_op_ids`."""
    ids, hit, off = [], {}, 0
    for n, count, stacked, at in check_segments(cfg, step, mode):
        if stacked:
            ids += [f"op{off + i}:L{j}" for i in range(n)
                    for j in range(count)]
            for i, group in at:
                hit.setdefault(group, []).extend(
                    f"op{off + i}:L{j}" for j in range(count))
            off += n
        else:
            for u in range(count):
                ids += [f"op{off + u * n + i}" for i in range(n)]
                for i, group in at:
                    hit.setdefault(group, []).append(f"op{off + u * n + i}")
            off += n * count
    return ids + [f"op{off}"], hit


def lm_op_ids(cfg, step="prefill", mode="fused"):
    """The per-op ids of one step's checks: a segment of several units
    stacks each position's checks (``op{i}:L{j}``), a segment of one unit
    keeps them flat, the head's last."""
    return _op_ids(cfg, step, mode)[0]


def lm_upset_sites(cfg, step="prefill", mode="fused"):
    """The ids of one step's checks that an accumulator upset reaches, by
    group (:func:`check_segments`)."""
    return _op_ids(cfg, step, mode)[1]


def first_check_id(cfg, seg, unit, step="prefill"):
    """The id of the first check of unit ``unit`` of segment ``seg`` (the
    product of its first block's first dense weight, where a weight flip
    lands)."""
    off = 0
    for n, count, stacked, _ in check_segments(cfg, step)[:seg]:
        off += n if stacked else n * count
    n, _count, stacked, _ = check_segments(cfg, step)[seg]
    return f"op{off}:L{unit}" if stacked else f"op{off + unit * n}"


def lm_grouped_shapes(cfg, batch=LM["batch"], prompt=LM["prompt"]):
    """Every (G, M, K, N) a run of ``cfg`` at ``batch`` x ``prompt``
    launches the grouped matmul_abft at, with its launches per prefill and
    per decode step: an MoE layer's G experts, M the capacity of the
    step's tokens (up and gate [M, d] @ [d, f], down [M, f] @ [f, d]); an
    RG-LRU layer's two gates, 16 blocks [M, dr/16] @ [dr/16, dr/16], M the
    step's tokens; {} for neither."""
    from repro_torch.models.moe import _capacity
    from repro_torch.models.rglru import GATE_BLOCKS
    types = block_types(cfg)
    shapes = {}

    def add(key, step, n):
        shapes.setdefault(key, {"prefill": 0, "decode": 0})
        shapes[key][step] += n
    d = cfg.d_model
    for tokens, step in ((batch * prompt, "prefill"), (batch, "decode")):
        if cfg.moe is not None:
            mc, cap = cfg.moe, _capacity(tokens, cfg.moe)
            moe_layers = sum(bt != "rwkv" for bt in types)
            for k, n, per in ((d, mc.d_ff_expert, 2),
                              (mc.d_ff_expert, d, 1)):
                add((mc.n_experts, cap, k, n), step, per * moe_layers)
        if "rglru" in types:
            r = (cfg.rglru_d or d) // GATE_BLOCKS
            add((GATE_BLOCKS, tokens, r, r), step, 2 * types.count("rglru"))
    return shapes


def lm_matmul_shapes(cfg, batch=LM["batch"], prompt=LM["prompt"], src=0,
                     prefix=0):
    """Every (M, K, N, trans_b) an LM run of ``cfg`` at ``batch`` x
    ``prompt`` (after ``prefix`` embeddings; an encoder over ``src``
    frames) launches matmul_abft at, with its launches per prefill and per
    decode step (:func:`step_products`)."""
    prods = [(step, step_products(cfg, step, batch, prompt, src, prefix))
             for step in ("prefill", "decode")]
    shapes = {}
    # the layers' products of both steps, then the head's: the order in
    # which lm_kernels draws each shape's operands
    for step, keys in [(st, p[:-1]) for st, p in prods] + \
            [(st, p[-1:]) for st, p in prods]:
        for key in keys:
            shapes.setdefault(key, {"prefill": 0, "decode": 0})[step] += 1
    return shapes


def matmul_bound(torch, m, k, n, dtype):
    """Least time of one product on the card: every input read once, every
    output written once, against 2MNK + 2MK operations at the type's peak."""
    from repro_torch.analysis.vmem import matmul_tile
    item = torch.empty((), dtype=dtype).element_size()
    tm, tn = matmul_tile(m)
    n_bytes = item * (m * k + k * n + m * n) + 4 * (
        k + m + -(-m // tm) * -(-n // tn))
    n_ops = 2 * m * n * k + 2 * m * k
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_b, t_o = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / peak * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), \
        n_bytes, n_ops


def check_matmul_shape(torch, m, k, n, trans_b, dtype, gen, timed,
                       extra_witness=False):
    """matmul_abft kernel vs plain at one launch shape (with and without the
    extra column), a second run bit for bit the first, the clean corner, a
    corrupted output that must diverge; optionally its times.  Operands
    scaled as the LM's: activations ~1, weights ~1/sqrt(K) (the head's
    table ~1).  ``extra_witness``: the extra column is held by
    :func:`check_extra` (the tied head at M > 16, whose 1024 entries of
    |terms| ~ 500 include some that cancel to near 0)."""
    from repro_torch.analysis.vmem import (MATMUL_THIN_N, MATMUL_WIDE_TILE,
                                           matmul_split_k, matmul_splits,
                                           matmul_thin_smem_bytes,
                                           matmul_tile,
                                           matmul_wide_smem_bytes)
    from repro_torch.kernels.matmul_abft.kernel import (matmul_abft_kernel,
                                                        matmul_abft_plain)
    from repro_torch.kernels.matmul_abft.ops import matmul_abft
    a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    std = 1.0 if trans_b else k ** -0.5
    b = (torch.randn(*((n, k) if trans_b else (k, n)), generator=gen,
                     device="cuda") * std).to(dtype)
    br = b.float().sum(dim=0 if trans_b else 1).contiguous()
    tag = f"matmul_abft M={m} K={k} N={n} trans_b={trans_b} {dtype}"
    tol = OUT_ATOL if dtype == torch.float32 else BF16_TOL["matmul_abft"]
    worst = worst_c = 0.0
    acc = bf16_acc(torch, a, b, trans_b)
    for with_br in (True, False):
        got = matmul_abft_kernel(a, b, br if with_br else None,
                                 trans_b=trans_b)
        torch.cuda.synchronize()
        want = matmul_abft_plain(a, b, br if with_br else None,
                                 trans_b=trans_b)
        worst_c = max(worst_c, assert_close(f"{tag} c", got[0].float(),
                                            want[0].float(), atol=tol,
                                            rtol=tol))
        worst = max(worst, worst_c)
        sums = check_block_sums(torch, f"{tag} block_sums", got[0], got[1],
                                want[1], acc)
        worst = max(worst, sums["max_abs_err"])
        if with_br and extra_witness:
            extra = check_extra(torch, f"{tag} extra", a, br, got[2],
                                want[2])
            worst = max(worst, extra["max_abs_err"])
        elif with_br:
            worst = max(worst, assert_close(f"{tag} extra", got[2], want[2],
                                            atol=OUT_ATOL, rtol=OUT_RTOL))
        if with_br:
            c_checked = got[0]
            again = matmul_abft_kernel(a, b, br, trans_b=trans_b)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{tag}: a second run differs (C, "
                                     f"block_sums or extra)")
        elif got[2] is not None or not torch.equal(got[0], c_checked):
            raise AssertionError(f"{tag}: the unchecked product differs "
                                 f"from the checked one")
    if dtype == torch.bfloat16:
        sums = dict(sums, second_draw=block_sums_second_draw(
            torch, (m, k), ((n, k) if trans_b else (k, n)), 1.0 if trans_b
            else k ** -0.5, lambda x, y: matmul_abft_kernel(
                x, y, None, trans_b=trans_b), lambda x, y: matmul_abft_plain(
                x, y, None, trans_b=trans_b), tag))
    c, chk = matmul_abft(a, b, br, trans_b=trans_b)
    rel = corner_rel(chk.predicted, chk.actual)
    if not rel <= (CORNER_RTOL if dtype == torch.float32 else 1e-2):
        raise AssertionError(f"{tag}: clean corner divergence {rel:.3e}")
    bad = c.float().clone()
    bad.view(-1)[c.numel() // 2] += 100.0
    div = float((chk.predicted - bad.sum()).abs())
    if not div > 50.0:
        raise AssertionError(f"{tag}: a corrupted output diverges by only "
                             f"{div}")
    # max_abs_err covers every output; the extra column of the head reaches
    # |2e4| (b_r sums 256000 table rows), so it is reported for C alone too
    splits = matmul_splits(m, n, k)
    # M <= 16: (column tile, split) items, taken by persistent blocks (as
    # many as are resident); M > 16: one block per wide C tile
    wm, wn = MATMUL_WIDE_TILE
    tiles = -(-n // MATMUL_THIN_N) if m <= 16 else -(-n // wn) * -(-m // wm)
    entry = dict(m=m, k=k, n=n, trans_b=trans_b, dtype=str(dtype),
                 splits=splits, split_k=matmul_split_k(m, n, k),
                 tile=list(matmul_tile(m)), items=splits * tiles,
                 thin_smem_bytes=matmul_thin_smem_bytes(
                     m, a.element_size(), trans_b) if m <= 16 else 0,
                 wide_tile=[wm, wn] if m > 16 else None,
                 wide_smem_bytes=matmul_wide_smem_bytes(
                     a.element_size(), trans_b) if m > 16 else 0,
                 repeat_bitwise=True, max_abs_err=worst,
                 max_abs_err_c=worst_c, block_sums=sums, max_rel_corner=rel,
                 corrupted_divergence=div)
    if extra_witness:
        entry["extra"] = extra
    if timed and dtype == torch.float32 and m <= 16:
        # the kernel, the plain version on the card and on the CPU, each
        # against float64 (the thin products the LM head and decode use)
        ref = (a.double() @ (b.double().t() if trans_b else b.double()))
        cpu = matmul_abft_plain(a.cpu(), b.cpu(), br.cpu(), trans_b=trans_b)
        entry["vs_f64"] = {
            name: float((x.double() - ref).abs().max())
            for name, x in (("kernel", c), ("plain_card", want[0]),
                            ("plain_cpu", cpu[0].to("cuda")))}
    if timed:
        bound, by, n_bytes, n_ops = matmul_bound(torch, m, k, n, dtype)
        lib_b = torch.cat([b.t() if trans_b else b, br[:, None].to(dtype)],
                          dim=1).contiguous()
        entry.update(
            ms=time_ms(lambda: matmul_abft_kernel(a, b, br, trans_b=trans_b),
                       reps=5),
            plain_ms=time_ms(lambda: matmul_abft_plain(a, b, br,
                                                       trans_b=trans_b),
                             warm=1, reps=2),
            library_ms=time_ms(lambda: torch.matmul(a, lib_b), reps=5),
            bound_ms=bound, bound_by=by, bytes=n_bytes, flops=n_ops)
        if m <= 16:
            # the eager `ms` above holds the host's dispatch of each call;
            # from a CUDA graph, the device's own time, with B in L2 and
            # (cold) not, as a decode step finds it
            def kern():
                return matmul_abft_kernel(a, b, br, trans_b=trans_b)

            def lib():
                return torch.matmul(a, lib_b)
            entry.update(
                device_ms=device_ms(kern), device_cold_ms=device_ms(
                    kern, reps=5, cold=True),
                library_device_ms=device_ms(lib),
                library_device_cold_ms=device_ms(lib, reps=5, cold=True))
    return entry


def check_grouped_shape(torch, g, m, k, n, dtype, gen, timed):
    """The grouped matmul_abft at one served expert shape (G products
    [M, K] @ [K, N]) against its plain version, with and without the extra
    column; bit for bit one single launch a group and a second grouped run;
    the clean corner and a corrupted output that must diverge; optionally
    its times beside torch.bmm (f32 with TF32 off: cuBLAS's batched GEMM)
    and the bound, summed over the groups.  Operands scaled as the LM's."""
    from repro_torch.analysis.vmem import (MATMUL_THIN_N, MATMUL_WIDE_TILE,
                                           matmul_split_k, matmul_splits,
                                           matmul_tile)
    from repro_torch.kernels.matmul_abft.kernel import (
        matmul_abft_grouped_kernel, matmul_abft_grouped_plain,
        matmul_abft_kernel)
    from repro_torch.kernels.matmul_abft.ops import matmul_abft_grouped
    a = torch.randn(g, m, k, generator=gen, device="cuda").to(dtype)
    b = (torch.randn(g, k, n, generator=gen, device="cuda")
         * k ** -0.5).to(dtype)
    br = b.float().sum(dim=2).contiguous()
    tag = f"matmul_abft_grouped G={g} M={m} K={k} N={n} {dtype}"
    tol = OUT_ATOL if dtype == torch.float32 else BF16_TOL["matmul_abft"]
    got = matmul_abft_grouped_kernel(a, b, br)
    torch.cuda.synchronize()
    want = matmul_abft_grouped_plain(a, b, br)
    worst_c = assert_close(f"{tag} c", got[0].float(), want[0].float(),
                           atol=tol, rtol=tol)
    sums = check_block_sums(torch, f"{tag} block_sums", got[0], got[1],
                            want[1], None if dtype == torch.float32 else
                            matmul_abft_grouped_plain(a.float(), b.float())[0])
    if dtype == torch.bfloat16:
        sums["second_draw"] = block_sums_second_draw(
            torch, (g, m, k), (g, k, n), k ** -0.5,
            lambda x, y: matmul_abft_grouped_kernel(x, y, None),
            lambda x, y: matmul_abft_grouped_plain(x, y, None), tag)
    worst = max(worst_c, sums["max_abs_err"],
                assert_close(f"{tag} extra", got[2], want[2], atol=OUT_ATOL,
                             rtol=OUT_RTOL))
    del want
    again = matmul_abft_grouped_kernel(a, b, br)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{tag}: a second run differs")
    bare = matmul_abft_grouped_kernel(a, b, None)
    if bare[2] is not None or not torch.equal(bare[0], got[0]):
        raise AssertionError(f"{tag}: the unchecked product differs from "
                             f"the checked one")
    for i in range(g):
        # a group's slice need not start 16-byte aligned (b_r at K % 4 != 0),
        # which the single launch requires: it takes its own copies
        single = matmul_abft_kernel(a[i].clone(), b[i].clone(),
                                    br[i].clone())
        if not all(torch.equal(x[i], y) for x, y in zip(got, single)):
            raise AssertionError(f"{tag}: group {i} differs from its single "
                                 f"launch")
    del again, bare, single
    c, chk, _ = matmul_abft_grouped(a, b, br)
    rel = corner_rel(chk.predicted, chk.actual)
    if not rel <= (CORNER_RTOL if dtype == torch.float32 else 1e-2):
        raise AssertionError(f"{tag}: clean corner divergence {rel:.3e}")
    bad = c.float().clone()
    bad.view(-1)[c.numel() // 2] += 100.0
    div = float((chk.predicted - bad.sum()).abs())
    del bad, c
    if not div > 50.0:
        raise AssertionError(f"{tag}: a corrupted output diverges by only "
                             f"{div}")
    splits = matmul_splits(m, n, k)
    wm, wn = MATMUL_WIDE_TILE
    tiles = -(-n // MATMUL_THIN_N) if m <= 16 else -(-n // wn) * -(-m // wm)
    entry = dict(groups=g, m=m, k=k, n=n, dtype=str(dtype), splits=splits,
                 split_k=matmul_split_k(m, n, k), tile=list(matmul_tile(m)),
                 items=g * splits * tiles, bitwise_single_launches=True,
                 repeat_bitwise=True, max_abs_err=worst, block_sums=sums,
                 max_abs_err_c=worst_c, max_rel_corner=rel,
                 corrupted_divergence=div)
    if timed:
        bound, by, n_bytes, n_ops = matmul_bound(torch, m, k, n, dtype)
        lib_b = torch.cat([b, br[..., None].to(dtype)], dim=2).contiguous()

        def kern():
            return matmul_abft_grouped_kernel(a, b, br)

        def lib():
            return torch.bmm(a, lib_b)
        entry.update(
            ms=time_ms(kern, reps=5), device_ms=device_ms(kern, reps=5),
            plain_ms=time_ms(lambda: matmul_abft_grouped_plain(a, b, br),
                             warm=1, reps=1),
            library_ms=time_ms(lib, reps=5),
            library_device_ms=device_ms(lib, reps=5),
            library_note="torch.bmm(a, [b | b_r]), TF32 off",
            library_blas=str(torch.backends.cuda.preferred_blas_library()),
            bound_ms=g * bound, bound_by=by, bytes=g * n_bytes,
            flops=g * n_ops)
    return entry


def bt_entry(torch, m, k, n, gen) -> dict:
    """B4's wide Bᵀ path at one backward shape: dA = dC·Bᵀ of a forward
    [M, K] @ [K, N] product — ``matmul_abft_kernel(dc, b, trans_b=True)``
    on B as it lies, unchecked, as the autograd Function launches it —
    against its plain version, and whether it equals the same product on a
    transposed copy of B (the B path) bit for bit; its device ms beside the
    B path's, ``torch.matmul(dc, b.mT)`` (TF32 off), the plain version's ms
    and the bound."""
    from repro_torch.kernels.matmul_abft.kernel import (matmul_abft_kernel,
                                                        matmul_abft_plain)
    dc = torch.randn(m, n, generator=gen, device="cuda")
    b = torch.randn(k, n, generator=gen, device="cuda") * n ** -0.5
    bt = b.t().contiguous()
    got = matmul_abft_kernel(dc, b, None, trans_b=True)[0]
    err = assert_close(f"matmul_abft B^T M={m} K={n} N={k} c", got,
                       matmul_abft_plain(dc, b, None, trans_b=True)[0])
    same = torch.equal(got, matmul_abft_kernel(dc, bt, None)[0])
    bound, by, _n_bytes, _n_ops = matmul_bound(torch, m, n, k, torch.float32)
    return dict(m=m, k=n, n=k, max_abs_err=err, bitwise_b_path=same,
                device_ms=device_ms(lambda: matmul_abft_kernel(
                    dc, b, None, trans_b=True), reps=5),
                device_ms_b=device_ms(lambda: matmul_abft_kernel(
                    dc, bt, None), reps=5),
                library_device_ms=device_ms(lambda: torch.matmul(dc, b.mT),
                                            reps=5),
                library_note="torch.matmul(dc, b.mT), TF32 off",
                plain_ms=time_ms(lambda: matmul_abft_plain(
                    dc, b, None, trans_b=True), warm=1, reps=1),
                bound_ms=bound, bound_by=by)


def bt_head_entry(torch, m, k, n, gen) -> dict:
    """B4's wide Bᵀ path at the tied head of a train step's forward: the
    logits of every position (M = B·T) on the embedding table [N, K] as it
    lies, checked — :func:`check_matmul_shape` (kernel vs plain with and
    without ``b_r``, a second run, the block sums, the clean corner, a
    corrupted output) — then, on operands of its own, C, block sums and
    extra bit for bit the same launch's on a transposed copy of the table
    (the B path), and the device ms of both beside ``torch.matmul(x,
    table.mT)`` (TF32 off), the plain version's ms and the bound.  Its
    extra column is held by :func:`check_extra`."""
    from repro_torch.kernels.matmul_abft.kernel import (matmul_abft_kernel,
                                                        matmul_abft_plain)
    entry = check_matmul_shape(torch, m, k, n, True, torch.float32, gen,
                               False, extra_witness=True)
    x = torch.randn(m, k, generator=gen, device="cuda")
    table = torch.randn(n, k, generator=gen, device="cuda")
    br = table.sum(dim=0).contiguous()
    table_t = table.t().contiguous()

    def kern():
        return matmul_abft_kernel(x, table, br, trans_b=True)
    same = all(torch.equal(u, v) for u, v in zip(
        kern(), matmul_abft_kernel(x, table_t, br)))
    bound, by, _n_bytes, _n_ops = matmul_bound(torch, m, k, n, torch.float32)
    entry.update(
        bitwise_b_path=same, device_ms=device_ms(kern, reps=3),
        device_ms_b=device_ms(lambda: matmul_abft_kernel(x, table_t, br),
                              reps=3),
        library_device_ms=device_ms(lambda: torch.matmul(x, table.mT),
                                    reps=3),
        library_note="torch.matmul(x, table.mT), TF32 off (no b_r column)",
        plain_ms=time_ms(lambda: matmul_abft_plain(x, table, br,
                                                   trans_b=True),
                         warm=1, reps=1),
        bound_ms=bound, bound_by=by)
    return entry


def bt_grouped_entry(torch, g, m, k, n, gen) -> dict:
    """B4's wide Bᵀ path in a grouped launch: dA = dC·Bᵀ of an expert
    product [G, M, K] @ [G, K, N] — ``matmul_abft_grouped_kernel(dc, b,
    trans_b=True)`` on B as it lies, unchecked, as the grouped autograd
    Function launches it — against its plain version, whether it equals the
    same launch on a transposed copy of B bit for bit, and its device ms
    beside that launch's, ``torch.matmul(dc, b.mT)`` (batched, TF32 off),
    the plain version's ms and the bound, summed over the groups."""
    from repro_torch.kernels.matmul_abft.kernel import (
        matmul_abft_grouped_kernel, matmul_abft_grouped_plain)
    dc = torch.randn(g, m, n, generator=gen, device="cuda")
    b = torch.randn(g, k, n, generator=gen, device="cuda") * n ** -0.5
    bt = b.transpose(1, 2).contiguous()

    def kern():
        return matmul_abft_grouped_kernel(dc, b, None, trans_b=True)
    got = kern()[0]
    err = assert_close(f"matmul_abft_grouped B^T G={g} M={m} K={n} N={k} c",
                       got, matmul_abft_grouped_plain(dc, b, None,
                                                      trans_b=True)[0])
    same = torch.equal(got, matmul_abft_grouped_kernel(dc, bt, None)[0])
    bound, by, _n_bytes, _n_ops = matmul_bound(torch, m, n, k, torch.float32)
    return dict(groups=g, m=m, k=n, n=k, max_abs_err=err, bitwise_b_path=same,
                device_ms=device_ms(kern, reps=5),
                device_ms_b=device_ms(lambda: matmul_abft_grouped_kernel(
                    dc, bt, None), reps=5),
                library_device_ms=device_ms(lambda: torch.matmul(dc, b.mT),
                                            reps=5),
                library_note="torch.matmul(dc, b.mT) batched, TF32 off",
                plain_ms=time_ms(lambda: matmul_abft_grouped_plain(
                    dc, b, None, trans_b=True), warm=1, reps=1),
                bound_ms=g * bound, bound_by=by)


def same_bits(torch, x, y) -> bool:
    """Equal bits, NaN exactly where NaN (a zero row's extra entry)."""
    if x is None or y is None:
        return x is None and y is None
    nx, ny = torch.isnan(x), torch.isnan(y)
    as_int = {4: torch.int32, 2: torch.int16}[x.element_size()]
    return x.dtype == y.dtype and torch.equal(nx, ny) and torch.equal(
        x.masked_fill(nx, 0).view(as_int), y.masked_fill(ny, 0).view(as_int))


def grouped_edge_counts(g, m):
    """Edge row counts of a G-group, M-row launch: all 0, all M, one full
    group among empty ones, and a mix of counts on either side of 16 and
    of 64 (of 0..M where M < 15), 0 and M."""
    sides = [c for c in (15, 16, 17, 63, 64, 65) if c <= m] or \
        list(range(m + 1))
    cycle = sides + [0, m]
    return {"zero": [0] * g, "full": [m] * g,
            "one_full": [m if i == g // 2 else 0 for i in range(g)],
            "mixed": [cycle[i % len(cycle)] for i in range(g)]}


def grouped_live_bound(torch, counts, m, k, n, dtype):
    """Least time of a counted grouped launch: the live rows of A, the B
    of the experts with a live row and every group's b_r read once (an
    idle group's for its zero rows' extra entries), all of C, block_sums
    and extra written once, against the live rows' 2 r N K + 2 r K
    operations at the type's peak (``matmul_bound`` over the live rows and
    experts)."""
    from repro_torch.analysis.vmem import matmul_tile
    item = torch.empty((), dtype=dtype).element_size()
    g = len(counts)
    tm, tn = matmul_tile(m)
    live = [r for r in counts if r]
    n_bytes = item * (sum(live) * k + len(live) * k * n + g * m * n) + 4 * (
        g * k + g * m + g * -(-m // tm) * -(-n // tn))
    n_ops = sum(2 * r * n * k + 2 * r * k for r in live)
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_b, t_o = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / peak * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def check_grouped_counts(torch, g, m, k, n, gen, sources, timed):
    """The grouped matmul_abft at one expert shape (f32) with per-group row
    counts: for each named set of counts in ``sources``, the kernel against
    its plain version and, bit for bit (NaN where NaN), against the launch
    without counts on A with the dead rows zeroed — A's dead rows keep their
    random values, which the counts must hide —, and a second run bit for
    bit the first; optionally its times with and without the counts beside
    torch.bmm over the capacity rows and both bounds (capacity rows; live
    rows and experts)."""
    from repro_torch.kernels.matmul_abft.kernel import (
        matmul_abft_grouped_kernel as kern, matmul_abft_grouped_plain,
        zero_dead_rows)
    a = torch.randn(g, m, k, generator=gen, device="cuda")
    b = torch.randn(g, k, n, generator=gen, device="cuda") * k ** -0.5
    br = b.sum(dim=2).contiguous()
    head = f"matmul_abft_grouped G={g} M={m} K={k} N={n} counted"
    entry = dict(groups=g, m=m, k=k, n=n, sets={})
    if timed:
        bound, by, _n_bytes, _n_ops = matmul_bound(torch, m, k, n,
                                                   torch.float32)
        lib_b = torch.cat([b, br[..., None]], dim=2).contiguous()
        entry.update(
            device_ms_uncounted=device_ms(lambda: kern(a, b, br), reps=5),
            library_device_ms=device_ms(lambda: torch.bmm(a, lib_b), reps=5),
            library_note="torch.bmm(a, [b | b_r]) over the capacity rows, "
                         "TF32 off",
            bound_ms=g * bound, bound_by=by)
        del lib_b
    for name, counts in sources.items():
        tag = f"{head} {name}"
        rows = torch.tensor(counts, dtype=torch.int32, device="cuda")
        got = kern(a, b, br, rows=rows)
        bare = kern(zero_dead_rows(a, rows), b, br)
        if not all(same_bits(torch, x, y) for x, y in zip(got, bare)):
            raise AssertionError(f"{tag}: not bit for bit the launch "
                                 f"without counts on the zeroed rows")
        want = matmul_abft_grouped_plain(a, b, br, rows=rows)
        # block sums within the tolerance, no float64 witness: the rows past
        # the counts dilute the typical |c| that check_block_sums plants
        worst = max(assert_close(f"{tag} c", got[0], want[0]),
                    assert_close(f"{tag} block_sums", got[1], want[1]),
                    assert_close(f"{tag} extra", got[2], want[2]))
        again = kern(a, b, br, rows=rows)
        if not all(same_bits(torch, x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{tag}: a second run differs")
        e = dict(live_experts=sum(c > 0 for c in counts),
                 live_rows=sum(counts), bitwise_uncounted_zeroed=True,
                 repeat_bitwise=True, max_abs_err=worst)
        if timed:
            live, live_by = grouped_live_bound(torch, counts, m, k, n,
                                               torch.float32)
            e.update(ms=time_ms(lambda: kern(a, b, br, rows=rows), reps=5),
                     device_ms=device_ms(lambda: kern(a, b, br, rows=rows),
                                         reps=5),
                     bound_live_ms=live, bound_live_by=live_by)
        entry["sets"][name] = e
        del got, bare, want, again
    return entry


class grouped_record:
    """Records the shape and row counts (a device copy: no host sync) of
    every grouped launch the MoE blocks make while entered."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.real, calls = moe, moe.matmul_abft_grouped, []

        def spy(a, b, br=None, rows=None):
            calls.append(((a.shape[0], a.shape[1], a.shape[2], b.shape[2]),
                          None if rows is None else rows.clone()))
            return self.real(a, b, br, rows)
        moe.matmul_abft_grouped = spy
        return calls

    def __exit__(self, *exc):
        self.mod.matmul_abft_grouped = self.real
        return False


def grouped_step_times(torch, calls, gen):
    """A step's grouped launches (:class:`grouped_record`) replayed from
    CUDA graphs on random operands of each call's shape: device ms with the
    call's row counts and without, both bounds, live experts and rows —
    summed over the calls."""
    from repro_torch.kernels.matmul_abft.kernel import \
        matmul_abft_grouped_kernel as kern
    ops = {}
    out = dict(launches=len(calls), device_ms=0.0, device_ms_uncounted=0.0,
               bound_ms=0.0, bound_live_ms=0.0)
    live_experts, live_rows = [], []
    for shape, rows in calls:
        g, m, k, n = shape
        if shape not in ops:
            a = torch.randn(g, m, k, generator=gen, device="cuda")
            b = torch.randn(g, k, n, generator=gen, device="cuda") * k ** -0.5
            br = b.sum(dim=2).contiguous()
            ops[shape] = (a, b, br,
                          device_ms(lambda: kern(a, b, br), reps=3))
        a, b, br, bare_ms = ops[shape]
        counts = rows.tolist()
        out["device_ms"] += device_ms(lambda: kern(a, b, br, rows=rows),
                                      reps=3)
        out["device_ms_uncounted"] += bare_ms
        out["bound_ms"] += g * matmul_bound(torch, m, k, n,
                                            torch.float32)[0]
        out["bound_live_ms"] += grouped_live_bound(torch, counts, m, k, n,
                                                   torch.float32)[0]
        live_experts.append(sum(c > 0 for c in counts))
        live_rows.append(sum(counts) / (g * m))
    del ops
    if calls:
        out.update(live_experts=dict(min=min(live_experts),
                                     max=max(live_experts),
                                     mean=sum(live_experts)
                                     / len(live_experts)),
                   live_row_share=dict(min=min(live_rows), max=max(live_rows),
                                       mean=sum(live_rows) / len(live_rows)))
    return out


def flash_bound(torch, b, t, s, h, kh, dh, dtype, window=0, causal=True):
    """Least time of one launch: q, k, v, vr, o, o_extra once against the
    valid pairs' work (q·k and p·v over dh, p·vr) at the type's peak; the
    causal mask keeps query i's keys 0..i — at most ``window`` of them with
    a sliding window —, without it every query has all S."""
    item = torch.empty((), dtype=dtype).element_size()
    n_bytes = item * (2 * b * t * h * dh + 2 * b * s * kh * dh + b * s * h) \
        + 4 * b * t * h
    pairs = b * h * (sum(min(i + 1, s, window or s) for i in range(t))
                     if causal else t * s)
    n_ops = pairs * (4 * dh + 2)
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_b, t_o = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / peak * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), \
        n_bytes, n_ops


def sdpa_ms(torch, q, k, v, backends, mask=None, causal=True):
    """Milliseconds of one ``scaled_dot_product_attention`` call
    (``is_causal=causal``) on the first of ``backends`` (``SDPBackend``
    names) that takes the operands (q, k, v in its [B, H, T, d] layout;
    ``mask``, a boolean [T, S] of the valid pairs, in place of
    ``is_causal`` for a sliding window), timed as every kernel is — the
    yardstick only; nothing in the port calls it.  Returns (ms, backend) or
    (None, why each backend refused)."""
    import torch.nn.functional as F
    kw = dict(is_causal=causal) if mask is None else dict(attn_mask=mask)
    refused = []
    for name in backends:
        try:
            from torch.nn.attention import SDPBackend, sdpa_kernel
            with sdpa_kernel(getattr(SDPBackend, name)):
                F.scaled_dot_product_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                return time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, **kw)), name
        except Exception as exc:  # the backend refuses these operands
            why = str(exc).splitlines()[0][:160] if str(exc) else ""
            refused.append(f"{name}: {type(exc).__name__}: {why}")
    return None, "; ".join(refused)


def sdpa_library_ms(torch, q, k, v, vr, window=0, causal=True):
    """SDPA yardsticks of a ``flash_checksum`` launch: o and o_extra
    together (vr as an extra value column, 257 wide at dh 256) on the
    memory-efficient backend, else the math one; and o alone (v, dh wide)
    on the memory-efficient backend; a sliding window as a boolean mask,
    ``causal=False`` as ``is_causal=False``.  Returns a dict of both times
    and the backend that served each (or why none did)."""
    h, t, s = q.shape[2], q.shape[1], k.shape[1]
    g = h // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(g, dim=2)
    vv = torch.cat([vt, vr[..., None]], dim=-1).transpose(1, 2).contiguous()
    mask = None
    if window:
        i = torch.arange(t, device=q.device)[:, None]
        j = torch.arange(s, device=q.device)[None, :]
        mask = (j <= i) & (j > i - window)
    ms, backend = sdpa_ms(torch, qt, kt, vv, ("EFFICIENT_ATTENTION", "MATH"),
                          mask, causal)
    o_ms, o_backend = sdpa_ms(torch, qt, kt, vt.transpose(1, 2).contiguous(),
                              ("EFFICIENT_ATTENTION",), mask, causal)
    how = f"is_causal={causal}" if not window else \
        f"attn_mask=(j <= i) & (j > i - {window})"
    return dict(library_ms=ms, library_backend=backend,
                library_note=f"F.scaled_dot_product_attention(q, k, [v | vr], "
                             f"{how})",
                library_o_only_ms=o_ms, library_o_only_backend=o_backend)


def chain_witness(torch, q, k, v, vr, wo, w_or, o, ex, out, chk, window=0,
                  causal=True):
    """The float64 witness of B5's clean chain corner (``causal`` or not,
    ``window`` > 0 the sliding window): ``actual − predicted`` = Σ out −
    Σ o_extra, out = o W_o on B4 in o's dtype, split into eight steps that
    sum to it exactly,

        (actual − Y) + (Y − Z) + (Z − W) + (W − V) + (V − O) + (O − E)
        + (E − X) + (X − predicted)

    Y = Σ out, Z = Σ o W_o(rounded), W = Σ o W_o, V = Σ o · w_or (o the
    kernel's), O = Σ o* · w_or and E = Σ A* vr with A* the exact attention
    weights and o* = A* v, X = Σ o_extra — all float64 from the operands.
    Each step is one rounding: the f32 sum of out, out's rounding (and B4's
    f32 accumulation), W_o's, the f32 fold w_or, the attention output's (p
    and o rounded), vr's, the column's p rounding, the f32 sum of o_extra.
    Each step's ratio is |step| over one unit roundoff of the |terms| it
    rounds; ``rounding`` (every ratio ≤ 1) holds for rounding, not for a
    wrong output or column beyond it."""
    f64 = torch.float64
    b, t, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    ke = k.to(f64).repeat_interleave(h // kh, dim=2)
    ve = v.to(f64).repeat_interleave(h // kh, dim=2)
    sc = torch.einsum("bthd,bshd->bhts", q.to(f64), ke) * dh ** -0.5
    i = torch.arange(t, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    ok = (j <= i) & (j > i - window) if window else j <= i
    if not causal:
        ok = torch.ones_like(ok)
    att = torch.softmax(sc.masked_fill(~ok, float("-inf")), dim=-1)
    att = torch.nan_to_num(att)          # a row with no key attends to none
    vr64 = vr.to(f64)
    o_star = torch.einsum("bhts,bshd->bthd", att, ve)
    a_v = torch.einsum("bhts,bshd->bthd", att, ve.abs())
    a_vr = float(torch.einsum("bhts,bsh->", att, vr64.abs()))
    wor = w_or.to(f64).reshape(h, dh)
    wo64 = wo.to(f64)
    ok64 = o.to(f64).reshape(b * t, h * dh)
    out64, ex64 = out.to(f64), ex.to(f64)
    pred, act = float(chk.predicted), float(chk.actual)
    y = float(out64.sum())
    z = float((ok64 @ wo.to(o.dtype).to(f64)).sum())
    w = float((ok64 @ wo64).sum())
    vv = float((ok64.reshape(b, t, h, dh) * wor).sum())
    oo = float((o_star * wor).sum())
    e = float(torch.einsum("bhts,bsh->", att, vr64))
    x = float(ex64.sum())
    s_out = float(out64.abs().sum())
    s_ow = float((ok64.abs() @ wo64.abs().sum(1)).sum())
    s_att = float(((ok64.abs().reshape(b, t, h, dh) + a_v)
                   * wor.abs()).sum())
    steps = dict(sum=(act - y, U32 * s_out), output=(y - z, U_BF16 * s_out),
                 w_o=(z - w, U_BF16 * s_ow), fold=(w - vv, U32 * s_ow),
                 attention=(vv - oo, U_BF16 * s_att),
                 carried=(oo - e, U_BF16 * a_vr),
                 column=(e - x, U_BF16 * a_vr),
                 predicted_sum=(x - pred, U32 * float(ex64.abs().sum())))
    terms = {name: dict(value=val, ratio=abs(val) / scale if scale else
                        (0.0 if val == 0 else float("inf")))
             for name, (val, scale) in steps.items()}
    max_ratio = max(tm["ratio"] for tm in terms.values())
    return dict(gap=act - pred, terms_sum=sum(val for val, _ in
                                              steps.values()),
                terms=terms, max_ratio=max_ratio, rounding=max_ratio <= 1.0)


def check_flash_shape(torch, b, t, s, h, kh, dh, dtype, gen, timed,
                      window=0, causal=True):
    """flash_checksum kernel vs plain (with and without the column), the
    chain identity Σ o_extra = Σ (o W_o) as a clean corner, a corrupted
    accumulator that must diverge; optionally its times.  ``window`` > 0:
    the sliding window's mask; ``causal=False``: no mask (an encoder's
    self-attention, T = S, or a decoder's cross-attention, T ≠ S)."""
    from repro_torch.kernels.flash_checksum.kernel import (
        flash_checksum_kernel, flash_checksum_plain)
    from repro_torch.kernels.flash_checksum.ops import (carried_column,
                                                        chain_check)
    from repro_torch.kernels.matmul_abft.ops import matmul_abft

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q, k, v = rnd(b, t, h, dh), rnd(b, s, kh, dh), rnd(b, s, kh, dh)
    d_model = 2048
    wo = (torch.randn(h * dh, d_model, generator=gen, device="cuda")
          * (h * dh) ** -0.5)
    w_or = wo.sum(dim=1).reshape(h, dh)
    vr = carried_column(v, w_or, h).to(dtype)
    tag = f"flash_checksum B={b} T={t} S={s} H={h} Kh={kh} dh={dh} " \
        f"window={window} causal={causal} {dtype}"
    tol = OUT_ATOL if dtype == torch.float32 else BF16_TOL["flash_checksum"]
    mask = dict(window=window, causal=causal)
    got = flash_checksum_kernel(q, k, v, vr, **mask)
    torch.cuda.synchronize()
    want = flash_checksum_plain(q, k, v, vr, with_stats=True, **mask)
    worst = max(assert_close(f"{tag} o", got[0].float(), want[0].float(),
                             atol=tol, rtol=tol),
                assert_close(f"{tag} o_extra", got[1], want[1],
                             atol=max(tol, OUT_ATOL) * 2,
                             rtol=max(tol, OUT_RTOL) * 2))
    o_bare, ex_bare = flash_checksum_kernel(q, k, v, None, **mask)
    if ex_bare is not None or not torch.equal(o_bare, got[0]):
        raise AssertionError(f"{tag}: o without the carried column differs")
    # the split baseline's statistics: m and l against the plain version's,
    # o and o_extra unchanged by asking for them, with or without vr
    st = flash_checksum_kernel(q, k, v, vr, with_stats=True, **mask)
    st_bare = flash_checksum_kernel(q, k, v, None, with_stats=True, **mask)
    stats = dict(max_abs_err_m=assert_close(f"{tag} m", st[2], want[2],
                                            atol=tol, rtol=tol),
                 max_abs_err_l=assert_close(f"{tag} l", st[3], want[3],
                                            atol=tol, rtol=tol))
    if not (torch.equal(st[0], got[0]) and torch.equal(st[1], got[1])
            and torch.equal(st_bare[0], got[0]) and st_bare[1] is None
            and torch.equal(st_bare[2], st[2])
            and torch.equal(st_bare[3], st[3])):
        raise AssertionError(f"{tag}: o, o_extra or the statistics change "
                             f"with the statistics asked for or vr left out")
    del st, st_bare
    again = flash_checksum_kernel(q, k, v, vr, **mask)
    if not all(torch.equal(x, y) for x, y in zip(again, got)):
        raise AssertionError(f"{tag}: a second run differs")
    o, ex = got
    wo_t = wo.to(dtype)
    out, _ = matmul_abft(o.reshape(b * t, h * dh), wo_t, with_check=False)
    chk = chain_check(ex, out)
    rel = corner_rel(chk.predicted, chk.actual)
    # bf16: the float64 witness of the corner, reported at every case and
    # deciding one over BF16_CORNER_RTOL
    witness = None if dtype == torch.float32 else chain_witness(
        torch, q, k, v, vr, wo, w_or, o, ex, out, chk, window, causal)
    if not (rel <= (CORNER_RTOL if witness is None else BF16_CORNER_RTOL)
            or (witness is not None and witness["rounding"])):
        raise AssertionError(f"{tag}: clean chain divergence {rel:.3e}"
                             + ("" if witness is None else
                                f"; witness {witness}"))
    # upset the accumulator element whose W_o row sum is largest, so the
    # chain's change (25 x that sum) cannot fall under tau by chance
    bad = o.clone()
    hh, dd = divmod(int(w_or.abs().argmax()), dh)
    bad[0, 0, hh, dd] += 25.0
    out_bad, _ = matmul_abft(bad.reshape(b * t, h * dh), wo_t,
                             with_check=False)
    div = float((chain_check(ex, out_bad).diff()))
    if not div > 1e-3 * max(1.0, float(chk.actual.abs())):
        raise AssertionError(f"{tag}: a corrupted accumulator diverges by "
                             f"only {div}")
    entry = dict(b=b, t=t, s=s, h=h, kh=kh, dh=dh, window=window,
                 causal=causal, dtype=str(dtype), max_abs_err=worst,
                 max_rel_corner=rel, stats=dict(stats, o_bitwise=True),
                 corrupted_divergence=div, repeat_bitwise=True)
    if witness is not None:
        entry["chain_witness"] = witness
    if timed:
        bound, by, n_bytes, n_ops = flash_bound(torch, b, t, s, h, kh, dh,
                                                dtype, window, causal)

        def kern():
            return flash_checksum_kernel(q, k, v, vr, **mask)
        # one yardstick with B1's: 10 launches after 2 warm-up ones, 50, and
        # the device's own time from a CUDA graph; and the wrapper's host
        # dispatch, which bounds the eager times from below
        entry.update(
            ms=time_ms(kern), ms_50=time_ms(kern, reps=50),
            device_ms=device_ms(kern), host_dispatch_ms=host_ms(kern),
            plain_ms=time_ms(lambda: flash_checksum_plain(
                q, k, v, vr, **mask), warm=1, reps=2),
            bound_ms=bound, bound_by=by, bytes=n_bytes, flops=n_ops,
            **sdpa_library_ms(torch, q, k, v, vr, window, causal))
    return entry


def phase_lm_kernels(torch):
    """Hold matmul_abft and flash_checksum against their plain versions at
    every launch shape of the LM run, in float32 (timed) and bfloat16, plus
    ragged and GQA shapes; returns the two kernels-line entries."""
    from repro_torch.analysis.vmem import (flash_blocks_per_sm,
                                           flash_smem_bytes)
    from repro_torch.kernels import runtime
    cfg = lm_config()
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = lm_matmul_shapes(cfg)
    per_shape = []
    for (m, k, n, tb), counts in shapes.items():
        e = check_matmul_shape(torch, m, k, n, tb, torch.float32, gen, True)
        e["launches_per_step"] = counts
        per_shape.append(e)
    bf16 = [check_matmul_shape(torch, m, k, n, tb, torch.bfloat16, gen,
                               False)
            for (m, k, n, tb) in shapes]
    # the Bᵀ path at the train step's dA shapes (each prefill product's
    # backward), a generator of its own
    bt_gen = torch.Generator(device="cuda").manual_seed(14)
    bt = []
    for (m, k, n, tb), counts in shapes.items():
        if m > 16 and not tb:
            bt.append(dict(bt_entry(torch, m, k, n, bt_gen),
                           launches_per_train_step=counts["prefill"]))
    bt_keys = ("device_ms", "device_ms_b", "library_device_ms", "plain_ms",
               "bound_ms")
    bt_step = {key: sum(e[key] * e["launches_per_train_step"] for e in bt)
               for key in bt_keys}
    # the tied head of a train step's forward (every position, checked, the
    # table as it lies) and the grouped Bᵀ launch at deepseek-moe-16b's
    # prefill up/gate expert shape (lm_grads' expert dA), each from a
    # generator of its own
    bt_head = dict(bt_head_entry(
        torch, LM["batch"] * LM["prompt"], cfg.d_model, cfg.padded_vocab,
        torch.Generator(device="cuda").manual_seed(15)),
        launches_per_train_step=1)
    bt_grouped = bt_grouped_entry(
        torch, *next(iter(lm_grouped_shapes(arch_config("deepseek-moe-16b")))),
        torch.Generator(device="cuda").manual_seed(16))
    if not all(e["bitwise_b_path"] for e in bt + [bt_head, bt_grouped]):
        raise AssertionError("matmul_bt: a Bᵀ launch differs from the same "
                             "launch on a transposed copy of B")
    bt_step_head = {key: bt_step[key] + bt_head[key] for key in bt_keys}
    # ragged shapes (MATMUL_RAGGED)
    ragged = [check_matmul_shape(torch, m, k, n, tb, dt, gen, False)
              for m, k, n, tb in MATMUL_RAGGED
              for dt in (torch.float32, torch.bfloat16)]
    b, t, h, kh, dh = LM["batch"], LM["prompt"], cfg.n_heads, \
        cfg.n_kv_heads, cfg.hd
    flash_main = check_flash_shape(torch, b, t, t, h, kh, dh, torch.float32,
                                   gen, True)
    flash_other = [check_flash_shape(torch, b, t, t, h, kh, dh,
                                     torch.bfloat16, gen, False)] + [
        check_flash_shape(torch, *shape, dt, gen, False)
        for shape in FLASH_RAGGED for dt in (torch.float32, torch.bfloat16)]

    # the other served models: B4 at every launch shape they add (f32,
    # prefill and decode, the untied heads, the MoE routers and shared
    # experts, RWKV6's and the RG-LRU's projections), the grouped B4 at
    # every expert and RG-LRU gate shape (f32 timed, and bf16), B5 at each
    # served prefill attention (danube's with its window, recurrentgemma's
    # with its local window — MQA at dh 256 —, also in bf16 on FLASH_SEEDS
    # streams), then windowed B5 at small ragged shapes, f32 and bf16
    checked = {(e["m"], e["k"], e["n"], e["trans_b"]): e for e in per_shape}
    grouped, grouped_bf16, counted = {}, [], {}
    # the expert shapes again with row counts (grouped_edge_counts), from a
    # generator of their own
    count_gen = torch.Generator(device="cuda").manual_seed(12)
    arch_steps, flash_archs, hybrid_flash = {}, [], []
    # the MoE models' operands come from a generator of their own, so the
    # dense models' checks and the windowed ones after them see the inputs
    # they saw before the MoE models were added
    moe_gen = torch.Generator(device="cuda").manual_seed(8)
    # so do the models with a front end, whose B5 also runs non-causal:
    # an encoder's self-attention (T = S) and a decoder's cross-attention
    # (T = prompt, S = the encoder's frames), both timed
    front_gen = torch.Generator(device="cuda").manual_seed(10)
    flash_noncausal, flash_noncausal_bf16 = [], []
    for spec in ARCHS:
        acfg = arch_config(spec["arch"], spec.get("layers"))
        agen = moe_gen if acfg.moe is not None else front_gen \
            if acfg.frontend else gen
        ashapes = lm_matmul_shapes(acfg, spec["batch"], spec["prompt"],
                                   spec.get("src", 0), spec.get("prefix", 0))
        for key, counts in ashapes.items():
            if key not in checked:
                checked[key] = check_matmul_shape(torch, *key, torch.float32,
                                                  agen, True)
            checked[key].setdefault("launches_per_step_by_arch", {})[
                acfg.name] = counts
        gshapes = lm_grouped_shapes(acfg, spec["batch"], spec["prompt"])
        for key, counts in gshapes.items():
            if key not in grouped:
                grouped[key] = check_grouped_shape(torch, *key,
                                                   torch.float32, agen, True)
                grouped_bf16.append(check_grouped_shape(
                    torch, *key, torch.bfloat16, agen, False))
            grouped[key].setdefault("launches_per_step_by_arch", {})[
                acfg.name] = counts
            if acfg.moe is not None and key not in counted:
                counted[key] = check_grouped_counts(
                    torch, *key, count_gen, grouped_edge_counts(*key[:2]),
                    True)
        both = [(checked[key], c) for key, c in ashapes.items()] + \
            [(grouped[key], c) for key, c in gshapes.items()]
        arch_steps[acfg.name] = {
            step: {k: sum(e[k] * c[step] for e, c in both if c[step])
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            for step in ("prefill", "decode")}
        arch_steps[acfg.name]["decode"]["device_ms"] = sum(
            e["device_ms"] * c["decode"] for e, c in both if c["decode"])
        if gshapes:
            arch_steps[acfg.name]["grouped"] = {
                step: {k: sum(grouped[key][k] * c[step]
                              for key, c in gshapes.items())
                       for k in ("ms", "device_ms", "library_ms",
                                 "library_device_ms", "bound_ms")}
                for step in ("prefill", "decode")}
        if "attn" not in acfg.block_pattern:
            continue
        ta = spec.get("prefix", 0) + spec["prompt"]
        shape = (spec["batch"], ta, ta, acfg.n_heads, acfg.n_kv_heads,
                 acfg.hd)
        window = acfg.local_window if len(acfg.block_pattern) > 1 \
            else acfg.window
        flash_archs.append(check_flash_shape(
            torch, *shape, torch.float32, agen, True, window=window))
        flash_archs[-1]["arch"] = acfg.name
        if len(acfg.block_pattern) > 1:
            hybrid_flash.append(dict(shape=shape, window=window,
                                     arch=acfg.name))
        if acfg.family == "encdec":
            src = spec["src"]
            for what, (tq, sk) in (("encoder", (src, src)),
                                   ("cross", (spec["prompt"], src))):
                nc = (spec["batch"], tq, sk, acfg.n_heads, acfg.n_kv_heads,
                      acfg.hd)
                flash_noncausal.append(dict(check_flash_shape(
                    torch, *nc, torch.float32, agen, True, causal=False),
                    arch=acfg.name, attention=what))
                flash_noncausal_bf16.append(dict(check_flash_shape(
                    torch, *nc, torch.bfloat16, agen, False, causal=False),
                    arch=acfg.name, attention=what))
    arch_matmul = [e for key, e in checked.items() if key not in shapes]
    # the grouped kernel at ragged shapes (GROUPED_RAGGED), 5 groups, a
    # generator of its own
    rgen = torch.Generator(device="cuda").manual_seed(9)
    grouped_ragged = [
        check_grouped_shape(torch, 5, m, k, n, dt, rgen, False)
        for m, k, n in GROUPED_RAGGED
        for dt in (torch.float32, torch.bfloat16)]
    # non-causal B5 at ragged shapes, f32 and bf16, a generator of its own:
    # S not a multiple of the 32-key block (T = S), T > S, T < S, S under
    # one block, T = 1 over whisper's 1500 frames, dh 70 with T != S
    ngen = torch.Generator(device="cuda").manual_seed(11)
    flash_noncausal_ragged = [
        check_flash_shape(torch, *shape, dt, ngen, False, causal=False)
        for shape in FLASH_NONCAUSAL_RAGGED
        for dt in (torch.float32, torch.bfloat16)]
    flash_window = [
        check_flash_shape(torch, *shape, dt, gen, False, window=w)
        for shape, windows in FLASH_WINDOWED
        for w in windows for dt in (torch.float32, torch.bfloat16)]
    # the windowed bf16 cases again on FLASH_SEEDS streams, a generator
    # each: the chain corner's gate must hold on more than one input; a
    # hybrid's served windowed prefill attention in bf16 on the same streams
    seed_cases, served_seed_cases = [], []
    for seed in FLASH_SEEDS:
        sgen = torch.Generator(device="cuda").manual_seed(seed)
        for w in FLASH_WINDOWS:
            e = check_flash_shape(torch, 1, 257, 257, 4, 2, 64,
                                  torch.bfloat16, sgen, False, window=w)
            seed_cases.append(_seed_case(seed, w, e))
        for hf in hybrid_flash:
            e = check_flash_shape(torch, *hf["shape"], torch.bfloat16, sgen,
                                  False, window=hf["window"])
            served_seed_cases.append(dict(_seed_case(seed, hf["window"], e),
                                          arch=hf["arch"],
                                          max_abs_err=e["max_abs_err"]))
    flash_seeds = dict(
        shape=dict(b=1, t=257, s=257, h=4, kh=2, dh=64), dtype="bfloat16",
        seeds=list(FLASH_SEEDS), windows=list(FLASH_WINDOWS),
        over_rtol=sum(c["rel"] > BF16_CORNER_RTOL for c in seed_cases),
        max_rel=max(c["rel"] for c in seed_cases),
        max_ratio=max(c["max_ratio"] for c in seed_cases), cases=seed_cases,
        served=dict(shapes=hybrid_flash, dtype="bfloat16",
                    over_rtol=sum(c["rel"] > BF16_CORNER_RTOL
                                  for c in served_seed_cases),
                    max_ratio=max((c["max_ratio"] for c in served_seed_cases),
                                  default=None),
                    cases=served_seed_cases))

    def step_ms(key, step):
        return sum(e[key] * e["launches_per_step"][step] for e in per_shape
                   if e["launches_per_step"][step])
    per_step = {step: {key: step_ms(key, step) for key in
                       ("ms", "plain_ms", "library_ms", "bound_ms")}
                for step in ("prefill", "decode")}
    per_step["decode"].update({key: step_ms(key, "decode") for key in (
        "device_ms", "device_cold_ms", "library_device_ms",
        "library_device_cold_ms")})
    # registers and spills of the thin path's two kernels and of the wide
    # path's (the build phase compiled with ptxas -v)
    ptxas = ptxas_summary(runtime.last_build_log)
    thin_ptxas = {name: v for name, v in ptxas.items()
                  if "thin_split" in name or "thin_reduce" in name}
    wide_ptxas = {name: v for name, v in ptxas.items()
                  if "wide_kernel" in name}
    flash_ptxas = {name: v for name, v in ptxas.items()
                   if "flash_checksum_kernel" in name}
    # each prefill product's share of the prefill's B4 time
    prefill = [dict(m=e["m"], k=e["k"], n=e["n"], items=e["items"],
                    launches=e["launches_per_step"]["prefill"], ms=e["ms"],
                    bound_ms=e["bound_ms"], library_ms=e["library_ms"],
                    share=e["ms"] * e["launches_per_step"]["prefill"]
                    / per_step["prefill"]["ms"])
               for e in per_shape if e["launches_per_step"]["prefill"]]
    main = max(per_shape, key=lambda e: e["flops"] * e["launches_per_step"][
        "prefill"])
    # the grouped kernel's line: deepseek-moe-16b's prefill up/gate shape,
    # the expert product that does the most work a prefill
    gmain = max(grouped.values(), key=lambda e: e["flops"] * max(
        c["prefill"] for c in e["launches_per_step_by_arch"].values()))
    entries = {
        "matmul_abft": dict(
            name="matmul_abft", route="cuda",
            source="src/repro_torch/kernels/csrc/matmul_abft.cu",
            replaces="src/repro/kernels/matmul_abft/kernel.py:65",
            max_abs_err=max(e["max_abs_err"] for e in per_shape),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"],
            library_note="torch.matmul(a, [b | b_r]) at the same shape",
            shape=dict(m=main["m"], k=main["k"], n=main["n"]),
            per_step_ms=per_step),
        "matmul_abft_grouped": dict(
            name="matmul_abft_grouped", route="cuda",
            source="src/repro_torch/kernels/csrc/matmul_abft.cu",
            replaces="src/repro/kernels/matmul_abft/kernel.py:65",
            max_abs_err=max(e["max_abs_err"] for e in grouped.values()),
            ms=gmain["ms"], device_ms=gmain["device_ms"],
            plain_ms=gmain["plain_ms"], bound_ms=gmain["bound_ms"],
            bound_by=gmain["bound_by"], library_ms=gmain["library_ms"],
            library_note=gmain["library_note"],
            library_blas=gmain["library_blas"],
            shape=dict(groups=gmain["groups"], m=gmain["m"], k=gmain["k"],
                       n=gmain["n"])),
        "flash_checksum": dict(
            name="flash_checksum", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_checksum.cu",
            replaces="src/repro/kernels/flash_checksum/kernel.py:88",
            max_abs_err=flash_main["max_abs_err"], ms=flash_main["ms"],
            plain_ms=flash_main["plain_ms"], bound_ms=flash_main["bound_ms"],
            bound_by=flash_main["bound_by"],
            library_ms=flash_main["library_ms"],
            library_note=flash_main["library_note"],
            library_backend=flash_main["library_backend"],
            library_o_only_ms=flash_main["library_o_only_ms"],
            ms_50=flash_main["ms_50"], device_ms=flash_main["device_ms"],
            host_dispatch_ms=flash_main["host_dispatch_ms"],
            per_prefill_ms=cfg.n_layers * flash_main["ms"],
            smem_bytes=flash_smem_bytes(dh),
            blocks_per_sm=flash_blocks_per_sm(dh),
            shape=dict(b=b, t=t, s=t, h=h, kh=kh, dh=dh),
            noncausal={e["attention"]: {k: e[k] for k in (
                "t", "s", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_o_only_ms",
                "max_abs_err")} for e in flash_noncausal})}
    emit("lm_kernels", tolerance=dict(f32=OUT_ATOL, bf16=BF16_TOL,
                                      corner_rtol=CORNER_RTOL,
                                      bf16_corner_rtol=BF16_CORNER_RTOL),
         matmul_f32=per_shape, matmul_bf16=bf16, matmul_ragged=ragged,
         flash_f32=flash_main, flash_other=flash_other, per_step=per_step,
         matmul_archs=arch_matmul, arch_per_step=arch_steps,
         matmul_grouped=list(grouped.values()),
         matmul_grouped_bf16=grouped_bf16,
         matmul_grouped_ragged=grouped_ragged,
         matmul_grouped_counted=list(counted.values()),
         matmul_bt=dict(shapes=bt, per_train_step=bt_step,
                        tied_head=bt_head, grouped=bt_grouped,
                        per_train_step_with_head=bt_step_head),
         flash_archs=flash_archs, flash_noncausal=flash_noncausal,
         flash_noncausal_bf16=flash_noncausal_bf16,
         flash_noncausal_ragged=flash_noncausal_ragged,
         flash_window=flash_window,
         flash_window_seeds=flash_seeds, prefill_shapes=prefill, thin_ptxas=thin_ptxas,
         wide_ptxas=wide_ptxas, flash_ptxas=flash_ptxas,
         kernels=list(entries.values()))
    spills = {name: v for name, v in flash_ptxas.items()
              if v.get("spill_stores") and "Li256E" in name}
    if spills:
        raise AssertionError(f"flash_checksum spills at dh 256: {spills}")
    return entries


def _seed_case(seed, window, entry):
    wit = entry["chain_witness"]
    return dict(seed=seed, window=window, rel=entry["max_rel_corner"],
                max_ratio=wit["max_ratio"],
                largest_step=max(wit["terms"],
                                 key=lambda n: wit["terms"][n]["ratio"]))


def _argmax_tokens(torch, logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def lm_trajectory(torch, step_prefill, step_decode, tokens, n_new, *,
                  inject_at=None, delta=0.0, timed=False, pos0=None):
    """Prefill then ``n_new`` greedy decode steps, the first at ``pos0``
    (default: the prompt's length); every step's logits and token, and
    (``timed``) host-clock ms around each synchronised step."""
    t0 = tokens.shape[1] if pos0 is None else pos0
    times = []
    start = time.perf_counter()
    logits, states = step_prefill(tokens, delta if inject_at == -1 else 0.0)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - start) * 1e3)
    out_logits, out_tokens = [logits], []
    for i in range(n_new):
        nxt = _argmax_tokens(torch, logits)
        out_tokens.append(nxt)
        start = time.perf_counter()
        logits, states = step_decode(states, nxt, t0 + i,
                                     delta if inject_at == i else 0.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        out_logits.append(logits)
    return out_logits, out_tokens, times


def lm_embeds(torch, cfg, spec, gen):
    """The front end's stub input of one run, seeded normal: an
    encoder-decoder's ``src_embeds`` [B, src, d], another front end's
    ``prefix_embeds`` [B, prefix, d]; {} for a decoder without one."""
    key = "src_embeds" if cfg.family == "encdec" else "prefix_embeds"
    n = spec.get("src" if cfg.family == "encdec" else "prefix", 0)
    if not n:
        return {}
    return {key: torch.randn(spec["batch"], n, cfg.d_model, generator=gen,
                             device="cuda")}


def embeds_engine(cfg, abft, params, cache_len, extra):
    """An ``LMEngine`` whose guarded prefill also passes ``extra`` (the
    front end's embeddings) beside the tokens: its step from
    ``make_guarded_prefill_step`` under its ``ABFTGuard.run_step``, whose
    ``restore_fn`` refolds the working params from the master.  The
    engine's own ``prefill`` takes tokens alone, as the reference's does."""
    from repro_torch.engine.lm import LMEngine

    class EmbedsEngine(LMEngine):
        def prefill(self, tokens, *, inject=0.0):
            pop = self._fire_once(inject)
            (logits, states), m = self.guard.run_step(
                lambda params, batch: self._prefill(params, batch, pop()),
                self.params, {"tokens": tokens, **extra})
            return logits, states, m

    return EmbedsEngine(cfg, abft, params, cache_len=cache_len)


class attempt_record:
    """Records the flagged op ids of every attempt of an engine's guarded
    prefill and decode steps (retries and replays included) while it is
    entered: one list of ids an attempt, empty for a clean one."""

    def __init__(self, eng):
        self.eng = eng

    def __enter__(self):
        import torch
        eng, self.saved, self.rows = self.eng, (self.eng._prefill,
                                                self.eng._decode), []

        def recorded(fn):
            def run(*args):
                out, m = fn(*args)
                flags = torch.as_tensor(m["abft_op_flags"]).reshape(-1)
                self.rows.append([m["abft_op_ids"][int(i)] for i in
                                  flags.nonzero().reshape(-1).tolist()])
                return out, m
            return run
        eng._prefill, eng._decode = recorded(eng._prefill), \
            recorded(eng._decode)
        return self.rows

    def __exit__(self, *exc):
        self.eng._prefill, self.eng._decode = self.saved
        return False


def flip_leaf(torch, params, path, layer, bit):
    """``params`` with a clone of the stacked weight at ``path`` whose
    element (``layer``, 0, ...) has ``bit`` flipped (the master, which
    shares every other tensor, stays pristine).  Returns (params, the
    corrupted weight)."""
    node = params
    for key in path[:-1]:
        node = node[key]
    w = node[path[-1]].clone()
    w.view(torch.int32)[(layer,) + (0,) * (w.dim() - 1)] ^= (1 << bit)

    def put(tree, keys):
        if not keys:
            return w
        key, rest = keys[0], keys[1:]
        if isinstance(tree, list):
            return [put(x, rest) if i == key else x
                    for i, x in enumerate(tree)]
        return dict(tree, **{key: put(tree[key], rest)})
    return put(params, list(path)), w


def site_corner(torch, abft, checks, site):
    """(predicted, actual) of the check element ``site`` names (an id of
    ``per_op_report``)."""
    from repro_torch.core.abft import per_op_report
    checks = [c for c in checks if c is not None]
    i = list(per_op_report(checks, abft)[0]).index(site)
    return tuple(torch.cat([getattr(c, side).reshape(-1) for c in checks])[i]
                 for side in ("predicted", "actual"))


def lm_gates(torch, cfg, params, spec, cache_len):
    """The guarded-LM gates on one full-width master ``params`` of ``cfg``
    (``spec``: batch, prompt, new, the front end's ``src`` frames or
    ``prefix`` embeddings, and LM's seed, upset, bit flip and cut):
    guarded == unguarded bit for bit with no clean flag, every product on
    matmul_abft (the MoE experts and the RG-LRU gates on its grouped
    launch) and every prefill attention on flash_checksum (an encoder's
    and a decoder's cross-attention non-causal), the op ids the block
    pattern gives a prefill and a decode step; an accumulator upset on a
    decode step and one in prefill, each flagging only attention chains
    (a decode step's self-attention chains, a prefill's every chain: the
    encoder's, and the self- and cross-attention's), retried bit for bit
    (a model without attention: no site, nothing flags, the logits the
    clean run's); a bit flip in the first dense weight of a unit's first
    block (an encoder-decoder's decoder and encoder ``wq``) flagging that
    product's check, whose predicted side stays the clean run's bit for bit
    (the master's fold: a fold missing from the flipped stack would read
    the corrupted weight), restored bit for bit; then the same params cut to
    ``cut_layers`` (whole units; an encoder to as many layers), the card
    against the CPU (the plain versions) — for an MoE model with the same
    routing on both and its smallest top-k margin reported.  A model with
    recurrent blocks also times its scans (:class:`scan_record`) over one
    guarded prefill and decode step.  Returns the measurements; raises on
    any gate but the cut's, which :func:`_raise_unless_cut_ok` holds after
    the caller has printed the numbers."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine.lm import LMEngine
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import (RECURRENT, model_decode,
                                                model_prefill)

    spec = {**LM, **spec}
    tag = cfg.name
    abft = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    off = ABFTConfig(mode="none")
    gen = torch.Generator(device="cuda").manual_seed(spec["seed"] + 1)
    tokens = torch.randint(1, cfg.vocab_size, (spec["batch"], spec["prompt"]),
                           generator=gen, device="cuda", dtype=torch.int32)
    extra = lm_embeds(torch, cfg, spec, gen)
    encdec = cfg.family == "encdec"
    offset = 0 if encdec else spec.get("prefix", 0)
    pos0 = offset + spec["prompt"]
    eng = embeds_engine(cfg, abft, params, cache_len, extra) if extra else \
        LMEngine(cfg, abft, params, cache_len=cache_len)
    per_step = {step: lm_step_launches(cfg, step)
                for step in ("prefill", "decode")}
    types = block_types(cfg)
    recurrent = any(bt in RECURRENT for bt in types)
    if recurrent and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"{tag}: TF32 is on — the recurrent blocks' "
                             f"unchecked f32 products must stay on FFMA")
    torch.cuda.reset_peak_memory_stats()

    # the bit-identity baseline: unguarded mode="none" on the master params
    runtime.reset_counts()
    ref_logits, ref_tokens, ref_ms = lm_trajectory(
        torch,
        lambda tok, inj: model_prefill(params, cfg, {"tokens": tok, **extra},
                                       off, cache_len)[:2],
        lambda st, tok, pos, inj: model_decode(params, cfg, st, tok, pos,
                                               off)[:2],
        tokens, spec["new"], pos0=pos0)
    ref_counts = runtime.launch_counts()

    # the main path: the guarded engine, clean
    def g_prefill(tok, inj):
        logits, states, m = eng.prefill(tok, inject=inj)
        metrics.append(m)
        return logits, states

    def g_decode(st, tok, pos, inj):
        logits, states, m = eng.decode(st, tok, pos, inject=inj)
        metrics.append(m)
        return logits, states

    metrics = []
    runtime.reset_counts()
    logits, toks, step_ms = lm_trajectory(torch, g_prefill, g_decode, tokens,
                                          spec["new"], pos0=pos0)
    counts, plain = runtime.launch_counts(), runtime.plain_counts()
    want = {name: per_step["prefill"][name]
            + spec["new"] * per_step["decode"][name]
            for name in per_step["prefill"]}
    want = {name: n for name, n in want.items() if n}
    others = {k: v for k, v in counts.items() if k not in want}
    if {k: counts[k] for k in want} != want or any(others.values()) \
            or any(plain.values()) or ref_counts != counts:
        raise AssertionError(f"{tag}: launches {counts} (want {want}, "
                             f"unguarded {ref_counts}), plain {plain}")
    identical = all(torch.equal(a, b) for a, b in zip(logits, ref_logits)) \
        and all(torch.equal(a, b) for a, b in zip(toks, ref_tokens))
    if not identical or eng.guard.flags:
        raise AssertionError(f"{tag}: guarded trajectory bit-identical "
                             f"{identical}, clean flags {eng.guard.flags}")
    ids = {step: lm_op_ids(cfg, step) for step in ("prefill", "decode")}
    if list(metrics[0]["abft_op_ids"]) != ids["prefill"] or any(
            list(m["abft_op_ids"]) != ids["decode"] for m in metrics[1:]):
        raise AssertionError(f"{tag}: op ids {metrics[0]['abft_op_ids'][:3]}"
                             f".. / {metrics[1]['abft_op_ids'][:3]}.. (want "
                             f"{ids['prefill'][:3]}.. / "
                             f"{ids['decode'][:3]}..)")
    max_rel = max(float(m["abft_max_rel"]) for m in metrics)
    witness = clean_witness(torch, cfg, eng.params, abft, tokens, toks,
                            cache_len, logits, extra=extra, pos0=pos0)
    if witness["max_rel"] != max_rel or not all(
            w["rounding"] for w in witness["over_tol"]):
        raise AssertionError(f"{tag}: clean max_rel {max_rel:.3e} (replay "
                             f"{witness['max_rel']:.3e}); over "
                             f"{CORNER_RTOL}: {witness['over_tol']}")
    finite = all(bool(torch.isfinite(x[..., :cfg.vocab_size]).all())
                 for x in logits)
    shape_ok = tuple(logits[0].shape) == (spec["batch"], 1,
                                          cfg.padded_vocab)
    if not (finite and shape_ok):
        raise AssertionError(f"{tag}: logits finite {finite}, shape "
                             f"{tuple(logits[0].shape)}")

    # a transient accumulator upset on one decode step, then one in
    # prefill: each flags only attention chains — a decode step's every
    # self-attention chain on the models with a front end, some on the
    # others; a prefill's some of each group of chains —, one retry, bit
    # for bit.  A model with no attention has no site: nothing may flag and
    # nothing may change
    site = "attention accumulator" if "attn" in types else None
    upsets = {}
    for step, at, n_new in (("decode", spec["inject_at"], spec["new"]),
                            ("prefill", -1, 0)):
        flags0, retries0 = eng.guard.flags, eng.guard.retries
        metrics = []
        with attempt_record(eng) as rows:
            inj_logits, _, _ = lm_trajectory(
                torch, g_prefill, g_decode, tokens, n_new, inject_at=at,
                delta=spec["inject_delta"], pos0=pos0)
        groups = lm_upset_sites(cfg, step)
        sites = [i for ids_ in groups.values() for i in ids_]
        flagged = [r for r in rows if r]
        hit = flagged[0] if flagged else []
        upsets[step] = dict(
            step=at, delta=spec["inject_delta"], site=site,
            flags=eng.guard.flags - flags0,
            retries=eng.guard.retries - retries0,
            sites=len(sites), sites_flagged=len(hit),
            groups_flagged={g: len(set(hit) & set(v))
                            for g, v in groups.items()},
            bitwise=all(torch.equal(a, b) for a, b in
                        zip(inj_logits, ref_logits)))
        exact = step == "decode" and bool(extra)
        ok = upsets[step]["bitwise"] and len(flagged) == (1 if sites else 0) \
            and upsets[step]["flags"] == upsets[step]["retries"] \
            == (1 if sites else 0) and set(hit) <= set(sites) \
            and all(upsets[step]["groups_flagged"].values()) \
            and (not exact or sorted(hit) == sorted(sites))
        if not ok:
            raise AssertionError(f"{tag}: injected upset {upsets[step]}; "
                                 f"flagged {hit[:8]}.. of sites "
                                 f"{sites[:8]}..")

    # a bit flip in one unit's first dense weight after load — the
    # decoder's and, for an encoder-decoder, the encoder's —: a corrupted
    # clone replaces the working leaf (the master shares the tensor and
    # stays pristine)
    block, name = FLIP_LEAF[cfg.block_pattern[0]]
    targets = [("decoder", ["segments", 0, "b0", block, name, "w"],
                1 if encdec else 0)]
    if encdec:
        targets.append(("encoder", ["encoder", "segments", 0, "b0", "attn",
                                    "wq", "w"], 0))
    flips = []
    batch = {"tokens": tokens, **extra}
    for where, path, seg in targets:
        at = first_check_id(cfg, seg, spec["flip_layer"])
        clean_pred, _ = site_corner(torch, abft, model_prefill(
            eng.params, cfg, batch, abft, cache_len, return_checks=True)[3],
            at)
        flags0, restores0 = eng.guard.flags, eng.guard.restores
        eng.params, w = flip_leaf(torch, eng.params, path,
                                  spec["flip_layer"], spec["flip_bit"])
        # the site's predicted side is the master's fold times the
        # unchanged input: the clean run's, bit for bit
        flip_pred, flip_act = site_corner(torch, abft, model_prefill(
            eng.params, cfg, batch, abft, cache_len, return_checks=True)[3],
            at)
        metrics = []
        with attempt_record(eng) as rows:
            flip_logits, _, _ = lm_trajectory(torch, g_prefill, g_decode,
                                              tokens, 2, pos0=pos0)
        master = params
        for key in path:
            master = master[key]
        hit = next((r for r in rows if r), [])
        flip = dict(where=where, layer=spec["flip_layer"],
                    bit=spec["flip_bit"], leaf=".".join(map(str, path)),
                    flags=eng.guard.flags - flags0,
                    restores=eng.guard.restores - restores0,
                    site=at, site_flagged=at in hit, flagged=hit[:8],
                    site_predicted_bitwise=torch.equal(flip_pred,
                                                       clean_pred),
                    site_predicted=float(flip_pred),
                    site_actual=float(flip_act),
                    bitwise=all(torch.equal(a, b) for a, b in
                                zip(flip_logits, ref_logits)),
                    master_pristine=not torch.equal(master, w))
        del w, master, flip_pred, flip_act
        flips.append(flip)
        if flip["flags"] != 1 or flip["restores"] != 1 \
                or not flip["bitwise"] or not flip["master_pristine"] \
                or not flip["site_flagged"] \
                or not flip["site_predicted_bitwise"]:
            raise AssertionError(f"{tag}: weight flip {flip}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    scans = scan_times(torch, eng, tokens, toks[0]) if recurrent else None

    # the same params cut to whole units (an encoder to as many layers):
    # the card against the CPU's plain versions, prefill and decode logits
    # within LOGIT_ATOL + LM_LOGIT_RTOL
    import dataclasses
    n_cut = spec["cut_layers"]
    unit = len(cfg.block_pattern)
    if n_cut % unit:
        raise AssertionError(f"{tag}: cut of {n_cut} layers is not whole "
                             f"units of {unit}")
    cut_cfg = dataclasses.replace(cfg, n_layers=n_cut,
                                  enc_layers=n_cut if encdec else 0)
    cut = dict(params, segments=[_slice_tree(params["segments"][0],
                                             n_cut // unit)])
    if encdec:
        cut["encoder"] = dict(params["encoder"], segments=[_slice_tree(
            params["encoder"]["segments"][0], n_cut)])
    cut_tokens = tokens[:, :spec["cut_prompt"]]
    cut_pos0 = offset + spec["cut_prompt"]
    cut_len = cut_pos0 + spec["cut_decode"]
    cut_args = (cut, extra, cut_tokens, cut_pos0, cut_len,
                spec["cut_decode"])
    runs = {dev: cut_run(torch, cut_cfg, abft, *cut_args, dev=dev)
            for dev in ("cuda", "cpu")}
    pairs = [(a[..., :cfg.vocab_size], b[..., :cfg.vocab_size])
             for a, b in zip(runs["cuda"]["logits"], runs["cpu"]["logits"])]
    cut_errs = [max_err(a, b) for a, b in pairs]
    # max |card - CPU| / (atol + rtol |CPU|): at most 1 passes
    cut_ratio = [float(((a - b).abs() / (LOGIT_ATOL + LM_LOGIT_RTOL
                                          * b.abs())).max()) for a, b in pairs]
    # the float64 witness (ROADMAP C10): the same cut, tokens and decode
    # steps on the CPU in float64, checks off (they do not move a logit);
    # each f32 run's distance from it, in the gate's own units
    f64_fields = {}
    if encdec or max(cut_ratio) > 0.5:
        f64 = cut_run(torch, dataclasses.replace(cut_cfg, dtype="float64"),
                      off, *cut_args, dev="cpu", feed=runs["cpu"]["fed"])
        f64_fields = dict(f64_seconds=f64["seconds"],
                       fed_tokens_equal=all(torch.equal(a, b) for a, b in zip(
                           runs["cuda"]["fed"], runs["cpu"]["fed"])),
                       **{f"{side}_vs_f64": f64_distance(
                           runs[dev]["logits"], f64["logits"],
                           cfg.vocab_size)
                          for side, dev in (("card", "cuda"),
                                            ("cpu", "cpu"))})
        del f64
    routing = None
    if cfg.moe is not None:
        card, cpu = runs["cuda"]["routes"], runs["cpu"]["routes"]
        routing = dict(
            calls=len(card),
            equal=len(card) == len(cpu) and all(
                torch.equal(x["experts"], y["experts"])
                for x, y in zip(card, cpu)),
            min_topk_margin_card=min(x["margin"] for x in card),
            min_topk_margin_cpu=min(x["margin"] for x in cpu),
            tokens=[int(x["experts"].shape[0]) for x in card])
    cut_ok = max(cut_ratio) <= 1.0 and not any(runs["cuda"]["flags"]) \
        and not any(runs["cpu"]["flags"]) \
        and (routing is None or routing["equal"])
    prefill_ms, decode_ms = step_ms[0], step_ms[1:]
    return dict(
        eng=eng, tokens=tokens, toks=toks, counts=counts, want=want,
        cut_ok=cut_ok, cut_errs=cut_errs, cut_flags=(runs["cuda"]["flags"],
                                                     runs["cpu"]["flags"]),
        fields=dict(
            model=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
            encoder_layers=cfg.enc_layers or None,
            d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
            padded_vocab=cfg.padded_vocab, window=cfg.window,
            block_pattern=list(cfg.block_pattern),
            local_window=(cfg.local_window if len(cfg.block_pattern) > 1
                          else None),
            batch=spec["batch"], prompt=spec["prompt"], new=spec["new"],
            src=spec.get("src"), prefix=spec.get("prefix"),
            cache_len=cache_len, launches=counts, plain_calls=plain,
            launches_per_step=per_step,
            checks_per_layer={step: {bt: layer_checks(cfg, bt, step, encdec)
                                     for bt in cfg.block_pattern}
                              for step in ("prefill", "decode")},
            moe=moe_fields(cfg, spec), scans=scans,
            clean=dict(bitwise_identical=identical, flags=0, max_rel=max_rel,
                       op_ids={k: len(v) for k, v in ids.items()},
                       over_tol=witness["over_tol"],
                       largest=witness["largest"]),
            prefill_ms=prefill_ms, unguarded_prefill_ms=ref_ms[0],
            decode_ms_per_step=sum(decode_ms) / len(decode_ms),
            decode_ms_min_max=[min(decode_ms), max(decode_ms)],
            unguarded_decode_ms_per_step=sum(ref_ms[1:]) / len(ref_ms[1:]),
            inject=upsets, weight_flip=flips, peak_memory_gb=peak_gb,
            cut=dict(layers=n_cut, prompt=spec["cut_prompt"],
                     decode=spec["cut_decode"],
                     max_abs_err_card_vs_cpu=max(cut_errs),
                     per_step_max_abs_err=cut_errs,
                     per_step_gate_ratio=cut_ratio,
                     max_abs_logit=max(float(b.abs().max())
                                       for _, b in pairs),
                     tolerance=dict(atol=LOGIT_ATOL, rtol=LM_LOGIT_RTOL),
                     routing=routing,
                     card_seconds=runs["cuda"]["seconds"],
                     cpu_seconds=runs["cpu"]["seconds"], **f64_fields)))


def cut_run(torch, cfg, abft, params, extra, tokens, pos0, cache_len,
            n_decode, *, dev, feed=None):
    """The card-vs-CPU cut's prefill and ``n_decode`` greedy decode steps
    on ``dev``: ``params`` and the front end's ``extra`` inputs moved there
    (cast to float64 when ``cfg.dtype`` is ``"float64"``: a witness run of
    the plain versions) and folded for ``abft``; each decode step fed the
    argmax of the step before, or the tokens of ``feed``.  Returns the
    logits (on the host), flags, the tokens fed, the routings and the
    seconds."""
    from repro_torch.engine.lm import fold_lm_w_r
    from repro_torch.models.transformer import model_decode, model_prefill

    dtype = torch.float64 if cfg.dtype == "float64" else None
    folded = fold_lm_w_r(_tree_to(params, dev, dtype), cfg, abft)
    batch = {k: v.to(dev, dtype or v.dtype) for k, v in extra.items()}
    t0 = time.perf_counter()
    fed = []
    with routing_record() as routes:
        lg, st, rep = model_prefill(
            folded, cfg, {"tokens": tokens.to(dev), **batch}, abft,
            cache_len)
        outs, flags = [lg], [bool(rep.flag)]
        for i in range(n_decode):
            nxt = _argmax_tokens(torch, outs[-1]) if feed is None \
                else feed[i].to(dev)
            fed.append(nxt.cpu())
            lg, st, rep = model_decode(folded, cfg, st, nxt, pos0 + i, abft)
            outs.append(lg)
            flags.append(bool(rep.flag))
    return dict(logits=[x.cpu() for x in outs], flags=flags, fed=fed,
                seconds=time.perf_counter() - t0, routes=routes)


def f64_distance(logits, f64, vocab):
    """Each step's max |f32 logit − float64 logit| and its largest ratio to
    the cut gate's ``LOGIT_ATOL + LM_LOGIT_RTOL · |float64 logit|``."""
    errs, ratios = [], []
    for a, w in zip(logits, f64):
        d = (a[..., :vocab].double() - w[..., :vocab]).abs()
        errs.append(float(d.max()))
        ratios.append(float((d / (LOGIT_ATOL + LM_LOGIT_RTOL
                                  * w[..., :vocab].abs())).max()))
    return dict(per_step_max_abs_err=errs, per_step_gate_ratio=ratios)


class _Witnessed:
    """``dense``'s :class:`MatmulAbftOp` and the RG-LRU gates' grouped
    ``matmul_abft_grouped``, keeping beside each checked product the
    float64 values its corner is held to (:func:`clean_witness`): the
    corner's two f32 sides, S, P, P_r, Σ|C|, Σ|A||B| and Σ|A||w_r| (a
    grouped product's summed over its groups)."""

    def __init__(self, torch, op, grouped_op):
        self.torch, self.op, self.grouped_op, self.rows = \
            torch, op, grouped_op, []

    def grouped(self, a, b, br=None):
        y, chk, extra = self.grouped_op(a, b, br)
        if chk is not None:
            f64 = self.torch.float64
            col, col_abs = a.sum(1, dtype=f64), a.abs().sum(1, dtype=f64)
            br64 = br.to(f64)
            self.rows.append(self.torch.stack([
                chk.predicted.to(f64), chk.actual.to(f64), y.sum(dtype=f64),
                (col * b.sum(2, dtype=f64)).sum(), (col * br64).sum(),
                y.abs().sum(dtype=f64),
                (col_abs * b.abs().sum(2, dtype=f64)).sum(),
                (col_abs * br64.abs()).sum()]))
        return y, chk, extra

    def __call__(self, cfg, a, b, *, w_r=None):
        from repro_torch.core.abft import resolve_w_r
        y, chk = self.op(cfg, a, b, w_r=w_r)
        if chk is not None:
            f64 = self.torch.float64
            wr = resolve_w_r(b, w_r, cfg).reshape(-1).to(f64)
            col, col_abs = a.sum(0, dtype=f64), a.abs().sum(0, dtype=f64)
            self.rows.append(self.torch.stack([
                chk.predicted.to(f64), chk.actual.to(f64), y.sum(dtype=f64),
                col @ b.sum(1, dtype=f64), col @ wr, y.abs().sum(dtype=f64),
                col_abs @ b.abs().sum(1, dtype=f64), col_abs @ wr.abs()]))
        return y, chk


def clean_witness(torch, cfg, params, abft, tokens, toks, cache_len, want,
                  extra=None, pos0=None):
    """Replays the guarded clean trajectory (the prompt with the front
    end's ``extra`` embeddings, then the guarded run's tokens ``toks`` from
    position ``pos0``; every step's logits must equal ``want``'s bit for
    bit) with each ``dense`` product witnessed in float64.  Returns the
    guard's largest clean ``|pred - actual| / max(1, |actual|)`` and, for
    every check element over CORNER_RTOL and for the largest, the witness
    of its gap, four f32 rounding steps that sum to it exactly:

        actual - predicted = (actual - S) + (S - P) + (P - P_r)
                             + (P_r - predicted)

    S is the float64 sum of the served output C = A B, P = (eᵀA)(B e) and
    P_r = (eᵀA) w_r in float64 from the f32 operands and the folded w_r:
    the block sums' rounding, C's own, the fold's and the predicted
    column's.  Each term's ratio is |term| over one unit roundoff of the
    |terms| it rounds (Σ|C|, Σ|A||B|, Σ|A||B|, Σ|A||w_r|); the textbook
    bound of such a sum is n units, so ``rounding`` (every ratio ≤ 1) holds
    only for f32 rounding, never for a wrong product or corner.  The
    RG-LRU's grouped gate products are witnessed the same way, each term
    summed over the groups (b_r = w e, recomputed every call, in the place
    of the fold).  An element no witnessed product made (an attention
    corner, a tied head) has no witness and is not ``rounding``."""
    from repro_torch.core.abft import per_op_report
    from repro_torch.models import common, rglru
    from repro_torch.models.transformer import model_decode, model_prefill
    f64 = torch.float64
    wit, found, max_rel = _Witnessed(torch, common._DENSE,
                                     rglru.matmul_abft_grouped), [], 0.0

    def note(step, logits, rep, checks):
        nonlocal max_rel
        if not torch.equal(logits, want[step]):
            raise AssertionError(f"{cfg.name}: witness replay step {step} "
                                 f"is not the guarded run's")
        max_rel = max(max_rel, float(rep.max_rel))
        rows, wit.rows = torch.stack(wit.rows), []
        checks = [c for c in checks if c is not None]
        ids, _, rel = per_op_report(checks, abft, prefix="op")
        pred = torch.cat([c.predicted.reshape(-1).to(f64) for c in checks])
        act = torch.cat([c.actual.reshape(-1).to(f64) for c in checks])
        pick = set((rel > CORNER_RTOL).nonzero().reshape(-1).tolist())
        for e in sorted(pick | {int(rel.argmax())}):
            w = dict(step=step, op=ids[e], rel=float(rel[e]),
                     predicted=float(pred[e]), actual=float(act[e]),
                     rounding=False)
            match = ((rows[:, 0] == pred[e]) & (rows[:, 1] == act[e])
                     ).nonzero().reshape(-1)
            if len(match):
                p32, a32, s, p, p_r, s_c, s_ab, s_awr = \
                    rows[int(match[0])].tolist()
                terms = dict(sum=(a32 - s, s_c), product=(s - p, s_ab),
                             fold=(p - p_r, s_ab), column=(p_r - p32, s_awr))
                w.update(f64_output_sum=s, f64_corner=p, terms={
                    k: dict(value=v, ratio=abs(v) / (U32 * scale))
                    for k, (v, scale) in terms.items()})
                w["rounding"] = all(t["ratio"] <= 1.0
                                    for t in w["terms"].values())
            found.append(w)

    common._DENSE, rglru.matmul_abft_grouped = wit, wit.grouped
    try:
        t0 = tokens.shape[1] if pos0 is None else pos0
        logits, states, rep, checks = model_prefill(
            params, cfg, {"tokens": tokens, **(extra or {})}, abft,
            cache_len, return_checks=True, attn_inject=0.0)
        note(0, logits, rep, checks)
        for i, nxt in enumerate(toks):
            logits, states, rep, checks = model_decode(
                params, cfg, states, nxt, t0 + i, abft, return_checks=True,
                attn_inject=0.0)
            note(i + 1, logits, rep, checks)
    finally:
        common._DENSE, rglru.matmul_abft_grouped = wit.op, wit.grouped_op
    return dict(max_rel=max_rel,
                over_tol=[w for w in found if w["rel"] > CORNER_RTOL],
                largest=max(found, key=lambda w: w["rel"]))


def _raise_unless_cut_ok(run) -> None:
    if not run["cut_ok"]:      # reported first, so the numbers are kept
        raise AssertionError(
            f"{run['fields']['model']}: {run['fields']['cut']['layers']}-"
            f"layer logits card vs CPU, per "
            f"step: {run['cut_errs']} (atol {LOGIT_ATOL}, rtol "
            f"{LM_LOGIT_RTOL}); flags {run['cut_flags']}; routing "
            f"{run['fields']['cut']['routing']}")


class routing_record:
    """Records every MoE routing while it is entered: each call of
    ``models.moe.route`` appends its experts [N, k] (on the host) and its
    smallest top-k margin, the k-th largest router probability minus the
    (k+1)-th, the distance to a flip of the routing."""

    def __enter__(self):
        import torch

        from repro_torch.models import moe
        self.moe, self.route, self.rows = moe, moe.route, []

        def recorded(p, xt, cfg, abft):
            probs, gates, experts, checks = self.route(p, xt, cfg, abft)
            top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
            self.rows.append(dict(experts=experts.cpu(), margin=float(
                (top[:, -2] - top[:, -1]).min())))
            return probs, gates, experts, checks
        moe.route = recorded
        return self.rows

    def __exit__(self, *exc):
        self.moe.route = self.route
        return False


class scan_record:
    """Times every call of the recurrent scans (``rwkv6._wkv_scan``,
    ``rglru._rglru_scan``) while it is entered: the host clock around the
    call (its launches' dispatch) and CUDA events before and after it (the
    span the device spends from the scan's first launch to its last, idle
    gaps while it waits on the host included).  Read the rows after a
    synchronise."""

    def __enter__(self):
        import torch

        from repro_torch.models import rglru, rwkv6
        self.saved = [(rwkv6, "_wkv_scan", rwkv6._wkv_scan),
                      (rglru, "_rglru_scan", rglru._rglru_scan)]
        self.rows = []

        def timed(name, fn):
            def run(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                out = fn(*args)
                end.record()
                self.rows.append(dict(
                    scan=name, steps=int(args[0].shape[1]),
                    host_ms=(time.perf_counter() - t0) * 1e3,
                    events=(start, end)))
                return out
            return run
        for mod, name, fn in self.saved:
            setattr(mod, name, timed(name, fn))
        return self.rows

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def scan_times(torch, eng, tokens, tok):
    """One guarded prefill of ``tokens`` and one guarded decode step of
    ``tok`` with the scans timed (:class:`scan_record`): per step the
    scans' calls, time steps, host ms and CUDA-event ms, the step's own
    host ms (synchronised) and the scans' share of it."""
    with scan_record() as rows:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, states, _ = eng.prefill(tokens)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        n_prefill = len(rows)
        t0 = time.perf_counter()
        eng.decode(states, tok, tokens.shape[1])
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3
    del states
    out = {}
    for step, part, step_ms in (("prefill", rows[:n_prefill], prefill_ms),
                                ("decode", rows[n_prefill:], decode_ms)):
        host = sum(r["host_ms"] for r in part)
        dev = sum(r["events"][0].elapsed_time(r["events"][1]) for r in part)
        out[step] = dict(calls=len(part), time_steps=sum(r["steps"]
                                                         for r in part),
                         host_ms=host, event_ms=dev, step_host_ms=step_ms,
                         host_share=host / step_ms, event_share=dev / step_ms)
    return out


def moe_fields(cfg, spec):
    """An MoE model's routing shape and each step's capacity (None for a
    dense MLP)."""
    if cfg.moe is None:
        return None
    from repro_torch.models.moe import _capacity
    mc = cfg.moe
    return dict(experts=mc.n_experts, top_k=mc.top_k,
                d_ff_expert=mc.d_ff_expert, shared=mc.n_shared,
                d_ff_shared=mc.d_ff_shared,
                capacity_factor=mc.capacity_factor,
                capacity=dict(prefill=_capacity(
                    spec["batch"] * spec["prompt"], mc),
                    decode=_capacity(spec["batch"], mc)))


# ---------------------------------------------------------------------------
# split mode (the paper's two-check baseline) on the card
# ---------------------------------------------------------------------------

class o_record:
    """Records the attention output o of every ``flash_checksum`` call the
    model's attention blocks make while entered."""

    def __enter__(self):
        from repro_torch.models import attention
        self.mod, self.real, outs = attention, attention.flash_checksum, []

        def spy(*args, **kw):
            out = self.real(*args, **kw)
            outs.append(out[0])
            return out
        attention.flash_checksum = spy
        return outs

    def __exit__(self, *exc):
        self.mod.flash_checksum = self.real
        return False


def second_pass_times(torch, cfg, params, batch, abft, cache_len):
    """One more split-mode prefill with each call of the plain second
    scoring pass (``models.attention._split_second_pass``) synchronised
    and timed on the host clock: its calls and total ms beside the
    prefill's."""
    from repro_torch.models import attention
    from repro_torch.models.transformer import model_prefill
    real, ms = attention._split_second_pass, []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        return out
    attention._split_second_pass = timed
    try:
        t0 = time.perf_counter()
        model_prefill(params, cfg, batch, abft, cache_len)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        attention._split_second_pass = real
    return dict(calls=len(ms), ms=sum(ms), prefill_ms=total,
                max_call_ms=max(ms))


def split_gates(torch, cfg, params, spec, cache_len):
    """One guarded split-mode prefill of the full-width master ``params``
    (``spec`` and the tokens and front-end input as :func:`lm_gates` draws
    them): every attention on B5, which emits m and l for the second
    scoring pass; every product on B4 (W_o's checked too), 0 plain calls;
    no clean flag; the split op ids; logits bit for bit the unguarded
    (``mode="none"``) prefill's; each attention's o bit for bit the
    fused-mode and the unguarded prefill's; an accumulator upset flagging
    only split chains — some of each group —, retried bit for bit."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine.lm import LMEngine, fold_lm_w_r
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import model_prefill

    spec = {**LM, **spec}
    tag = f"{cfg.name} split"
    split = ABFTConfig(mode="split", threshold=1e-3, relative=True)
    fused = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    gen = torch.Generator(device="cuda").manual_seed(spec["seed"] + 1)
    tokens = torch.randint(1, cfg.vocab_size, (spec["batch"], spec["prompt"]),
                           generator=gen, device="cuda", dtype=torch.int32)
    extra = lm_embeds(torch, cfg, spec, gen)
    batch = {"tokens": tokens, **extra}
    eng = embeds_engine(cfg, split, params, cache_len, extra) if extra else \
        LMEngine(cfg, split, params, cache_len=cache_len)
    with o_record() as o_none:
        ref = model_prefill(params, cfg, batch, ABFTConfig(mode="none"),
                            cache_len)[0]
    runtime.reset_counts()
    t0 = time.perf_counter()
    with o_record() as o_split:
        logits, _states, m = eng.prefill(tokens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts, plain = runtime.launch_counts(), runtime.plain_counts()
    del _states
    with o_record() as o_fused:
        model_prefill(fold_lm_w_r(params, cfg, fused), cfg, batch, fused,
                      cache_len)
    want = {k: n for k, n in lm_step_launches(cfg).items() if n}
    if {k: counts[k] for k in want} != want or any(plain.values()) or any(
            v for k, v in counts.items() if k not in want):
        raise AssertionError(f"{tag}: launches {counts} (want {want}), "
                             f"plain {plain}")
    ids = lm_op_ids(cfg, "prefill", "split")
    o_bitwise = len(o_split) == len(o_fused) == len(o_none) == want[
        "flash_checksum"] and all(torch.equal(a, b) and torch.equal(a, c)
                                  for a, b, c in zip(o_split, o_fused,
                                                     o_none))
    out = dict(
        prefill_ms=ms, launches=counts, plain_calls=plain,
        flags=eng.guard.flags, max_rel=float(m["abft_max_rel"]),
        op_ids=len(ids), guarded_bitwise=torch.equal(logits, ref),
        o_split_eq_fused_bitwise=o_bitwise,
        finite=bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()))
    del o_split, o_fused, o_none
    if list(m["abft_op_ids"]) != ids or eng.guard.flags \
            or not out["guarded_bitwise"] or not o_bitwise \
            or not out["finite"]:
        raise AssertionError(f"{tag}: {out}; op ids "
                             f"{list(m['abft_op_ids'])[:6]}.. (want "
                             f"{ids[:6]}..)")
    out["second_pass"] = second_pass_times(torch, cfg, eng.params, batch,
                                           split, cache_len)
    groups = lm_upset_sites(cfg, "prefill", "split")
    sites = {i for v in groups.values() for i in v}
    with attempt_record(eng) as rows:
        inj, _states, _ = eng.prefill(tokens, inject=spec["inject_delta"])
    del _states
    hit = next((r for r in rows if r), [])
    out["upset"] = dict(
        delta=spec["inject_delta"], flags=eng.guard.flags,
        retries=eng.guard.retries, sites=len(sites), sites_flagged=len(hit),
        groups_flagged={g: len(set(hit) & set(v)) for g, v in groups.items()},
        bitwise=torch.equal(inj, logits))
    up = out["upset"]
    if not (up["bitwise"] and up["flags"] == up["retries"] == 1
            and hit and set(hit) <= sites
            and all(up["groups_flagged"].values())):
        raise AssertionError(f"{tag}: upset {up}; flagged {hit[:8]}..")
    return out


# ---------------------------------------------------------------------------
# the kernels' autograd Functions: backward vs autograd of the plain version
# ---------------------------------------------------------------------------

def grad_entry(torch, tag, function, plain, inputs, grad_out, gate=None):
    """The Function's gradients (``function(*inputs)``'s first output) two
    runs, bit for bit, and each within ``atol = rtol = 1e-4`` of autograd
    of ``plain(*inputs)``'s first output; the kernel launches of one
    Function forward and backward.  ``gate(grads)``, when given, holds the
    Function's gradients to more (it raises) and returns fields to add."""
    from repro_torch.kernels import runtime

    def grads(fn):
        xs = [x.detach().requires_grad_(True) for x in inputs]
        return torch.autograd.grad(fn(*xs)[0], xs, grad_out)
    runtime.reset_counts()
    got = grads(function)
    torch.cuda.synchronize()
    launches = {k: v for k, v in runtime.launch_counts().items() if v}
    again = grads(function)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{tag}: a second backward differs")
    want = grads(plain)
    errs = [assert_close(f"{tag} grad {i}", g, w)
            for i, (g, w) in enumerate(zip(got, want))]
    return dict(launches=launches, max_abs_err=errs, repeat_bitwise=True,
                max_abs_grad=[float(w.abs().max()) for w in want],
                **(gate(got) if gate else {}))


def phase_lm_grads(torch):
    """Each kernel's autograd Function against autograd of its plain
    version on the card: B4 at gemma-2b's train-step MLP product (B 2 x T
    512: M 1024, K 2048, N 16384) and tied head (B^T, N 256,000; its output
    gradient that of ``lm_loss`` over random labels), the grouped B4 at
    deepseek-moe-16b's prefill expert up product, B5 at gemma-2b's causal
    attention and whisper-medium's encoder and cross-attention; one
    Function forward launches B4 once and its backward twice (B5 once, its
    backward none).  The grouped expert again with row counts
    (``grouped_edge_counts``' mix) and non-zero dead rows, against autograd
    of the plain version on ``zero_dead_rows``: dA's dead rows +0."""
    from repro_torch.kernels.flash_checksum.kernel import flash_checksum_plain
    from repro_torch.kernels.flash_checksum.ops import FlashChecksumFunction
    from repro_torch.kernels.matmul_abft.kernel import (
        matmul_abft_grouped_plain, matmul_abft_plain, zero_dead_rows)
    from repro_torch.kernels.matmul_abft.ops import (
        GroupedMatmulAbftFunction, MatmulAbftFunction)
    from repro_torch.models.transformer import lm_loss

    cfg = lm_config()
    gen = torch.Generator(device="cuda").manual_seed(12)
    d, m = cfg.d_model, LM["batch"] * LM["prompt"]

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std
    out = {}
    a, w = rnd(m, d), rnd(d, cfg.d_ff, std=d ** -0.5)
    out["matmul_mlp"] = dict(m=m, k=d, n=cfg.d_ff, **grad_entry(
        torch, "matmul_abft MLP", lambda x, y: MatmulAbftFunction.apply(
            x, y, None, False), lambda x, y: matmul_abft_plain(x, y),
        (a, w), rnd(m, cfg.d_ff)))
    table = rnd(cfg.padded_vocab, d)
    logits = (a @ table.t()).requires_grad_(True)
    labels = torch.randint(0, cfg.vocab_size, (m,), generator=gen,
                           device="cuda")
    dlogits, = torch.autograd.grad(lm_loss(logits, labels), logits)
    del logits
    out["matmul_tied_head"] = dict(m=m, k=d, n=cfg.padded_vocab, **grad_entry(
        torch, "matmul_abft tied head", lambda x, y: MatmulAbftFunction.apply(
            x, y, None, True), lambda x, y: matmul_abft_plain(
            x, y, trans_b=True), (a, table), dlogits))
    del table, dlogits, a, w
    acfg = arch_config("deepseek-moe-16b")
    g, gm, gk, gn = next(iter(lm_grouped_shapes(acfg)))
    out["matmul_grouped_expert"] = dict(g=g, m=gm, k=gk, n=gn, **grad_entry(
        torch, "matmul_abft_grouped expert",
        lambda x, y: GroupedMatmulAbftFunction.apply(x, y, None, None),
        lambda x, y: matmul_abft_grouped_plain(x, y),
        (rnd(g, gm, gk), rnd(g, gk, gn, std=gk ** -0.5)), rnd(g, gm, gn)))
    # with counts, its operands from a generator of its own
    cgen = torch.Generator(device="cuda").manual_seed(13)
    counts = grouped_edge_counts(g, gm)["mixed"]
    rows = torch.tensor(counts, dtype=torch.int32, device="cuda")
    dead = torch.arange(gm, device="cuda")[None, :, None] >= rows[:, None,
                                                                  None]

    def dead_rows_zero(grads):
        da = grads[0].masked_select(dead)
        if da.any() or torch.signbit(da).any():
            raise AssertionError("matmul_abft_grouped expert, counted: dA's "
                                 "rows past the counts are not +0")
        return dict(dead_rows=int(dead.sum()), dead_da_zero=True)

    def crnd(*shape, std=1.0):
        return torch.randn(*shape, generator=cgen, device="cuda") * std
    out["matmul_grouped_expert_counted"] = dict(
        g=g, m=gm, k=gk, n=gn, rows=counts, **grad_entry(
            torch, "matmul_abft_grouped expert, counted",
            lambda x, y: GroupedMatmulAbftFunction.apply(x, y, None, rows),
            lambda x, y: matmul_abft_grouped_plain(zero_dead_rows(x, rows),
                                                   y),
            (crnd(g, gm, gk), crnd(g, gk, gn, std=gk ** -0.5)),
            crnd(g, gm, gn), gate=dead_rows_zero))
    wcfg = arch_config("whisper-medium")
    spec = next(s for s in ARCHS if s["arch"] == "whisper-medium")
    shapes = (("gemma_causal", (LM["batch"], LM["prompt"], LM["prompt"],
                                cfg.n_heads, cfg.n_kv_heads, cfg.hd), True),
              ("whisper_encoder", (spec["batch"], spec["src"], spec["src"],
                                   wcfg.n_heads, wcfg.n_kv_heads, wcfg.hd),
               False),
              ("whisper_cross", (spec["batch"], spec["prompt"], spec["src"],
                                 wcfg.n_heads, wcfg.n_kv_heads, wcfg.hd),
               False))
    for name, (b, t, s, h, kh, dh), causal in shapes:
        q, k, v = rnd(b, t, h, dh), rnd(b, s, kh, dh), rnd(b, s, kh, dh)
        vr = rnd(b, s, h)
        out[f"flash_{name}"] = dict(
            b=b, t=t, s=s, h=h, kh=kh, dh=dh, causal=causal, **grad_entry(
                torch, f"flash_checksum {name}",
                lambda x, y, z: FlashChecksumFunction.apply(
                    x, y, z, vr, causal, 0, False),
                lambda x, y, z: flash_checksum_plain(x, y, z, vr,
                                                     causal=causal),
                (q, k, v), rnd(b, t, h, dh)))
    for name, e in out.items():
        want = {"matmul_abft_grouped": 3} if "grouped" in name else \
            {"flash_checksum": 1} if name.startswith("flash") else \
            {"matmul_abft": 3}
        if e["launches"] != want:
            raise AssertionError(f"{name}: a Function forward and backward "
                                 f"launched {e['launches']}, want {want}")
    emit("lm_grads", tolerance=dict(atol=OUT_ATOL, rtol=OUT_RTOL), **out)


# ---------------------------------------------------------------------------
# the LM train step
# ---------------------------------------------------------------------------

def _host_leaves(torch, tree):
    from repro_torch.optim import tree_leaves
    return [x.cpu() for x in tree_leaves(tree)]


def _equal_host(torch, tree, host):
    """Every leaf of the device ``tree`` equals its host copy bit for bit
    (each leaf copied to the host in turn)."""
    from repro_torch.optim import tree_leaves
    leaves = tree_leaves(tree)
    return len(leaves) == len(host) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y)
        for x, y in zip(leaves, host))


def _equal_trees(torch, a, b):
    from repro_torch.optim import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def train_trace(torch, step):
    """One call of ``step`` under ``torch.profiler``: the device time of its
    CUDA kernels summed, and B4's (its kernels ``wide_kernel``,
    ``thin_split_kernel``, ``thin_reduce_kernel``).  Returns (what
    ``step`` returned, the trace); where the profiler cannot trace the
    card, its error instead of the trace (``step`` then runs untraced if
    it has not run)."""
    result = None
    try:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) is not None
                   and "CUDA" in str(e.device_type)]

        def dev_us(e):
            return float(getattr(e, "self_device_time_total", None)
                         or getattr(e, "self_cuda_time_total", 0.0))
        b4 = [e for e in kernels if any(n in e.key for n in (
            "wide_kernel", "thin_split_kernel", "thin_reduce_kernel"))]
        return result, dict(
            profiled_wall_ms=wall_ms,
            device_busy_ms=sum(dev_us(e) for e in kernels) / 1e3,
            b4_device_ms=sum(dev_us(e) for e in b4) / 1e3,
            launches=sum(e.count for e in kernels),
            top=[dict(name=e.key[:80], count=e.count, ms=dev_us(e) / 1e3)
                 for e in sorted(kernels, key=dev_us, reverse=True)[:8]])
    except Exception as exc:  # the tracer may not reach this card
        return step() if result is None else result, dict(
            error=f"{type(exc).__name__}: {exc}")


def phase_lm_train(torch, smi):
    """The LM train step on the card (``launch.steps.make_train_step``,
    driven through ``ABFTGuard.run_step`` as the reference's
    ``launch/train.py`` drives it): gemma-2b at full width, all 18 layers,
    f32, seed 0, fused mode, tau 1e-3 relative, 3 steps of
    ``SyntheticLM(seed=0)`` batches of B 2 x T 512 through the
    ``Prefetcher``; every product forward and backward on B4, attention
    forward on B5, 0 plain calls, the launches derived from the layer
    products; guarded == unguarded and a second run bit for bit; an upset
    on step 2 flags, its attempt returns the input state bit for bit and
    the guard retries it; losses finite, no clean flag; a 2-layer cut at
    T 128, card against CPU (loss, every gradient leaf); then one guarded
    whisper-medium step (24 + 24 layers, 1500 frames, T 224), which puts
    B5's non-causal and cross launches under the backward.  Returns the
    launches of the counted clean steps."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.data import Prefetcher, SyntheticLM
    from repro_torch.kernels import runtime
    from repro_torch.launch.steps import (init_train_state, loss_and_grads,
                                          make_train_step)
    from repro_torch.models.attention import attention_fault_injection
    from repro_torch.models.transformer import model_forward
    from repro_torch.optim import AdamWConfig, tree_leaves
    from repro_torch.runtime.abft_guard import ABFTGuard

    abft = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    opt = AdamWConfig()
    sched = dict(total_steps=TRAIN["total"], warmup=TRAIN["warmup"])
    cfg = lm_config()
    step = make_train_step(cfg, abft, opt, **sched)
    loose = make_train_step(cfg, abft, opt, guard_in_graph=False, **sched)
    runtime.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, TRAIN["seed"], device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    data = Prefetcher(SyntheticLM(cfg.vocab_size, TRAIN["seq"],
                                  TRAIN["batch"], seed=TRAIN["seed"]
                                  ).batches(), device="cuda")
    batches = [next(data) for _ in range(TRAIN["steps"])]
    guard = ABFTGuard()
    per_step = lm_step_launches(cfg)
    want = {k: 3 * n if k.startswith("matmul") else n
            for k, n in per_step.items() if n}
    metrics, step_ms, counts = [], [], []

    def run(fn, *args):
        runtime.reset_counts()
        t = time.perf_counter()
        out, m = fn(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        counts.append({k: v for k, v in runtime.launch_counts().items()
                       if v})
        metrics.append({k: float(v) for k, v in m.items()})
        return out

    # step 1, through the guard; a host copy of its state; unguarded and
    # again from the same input, each compared with it leaf by leaf
    s1 = run(guard.run_step, step, state, batches[0])
    host = _host_leaves(torch, s1)
    del s1
    u1 = run(loose, state, batches[0])
    guarded_eq_unguarded = _equal_host(torch, u1, host)
    del u1
    r1 = run(guard.run_step, step, state, batches[0])
    repeat_bitwise = _equal_host(torch, r1, host)
    del host
    state = r1
    del r1
    # step 2: an accumulator upset strikes the first attempt, whose state
    # must be its input's bit for bit; the guard retries it clean
    attempt = {}

    def upset_once(st, b):
        if attempt:
            return step(st, b)
        with attention_fault_injection(TRAIN["delta"]):
            out, m = step(st, b)
        attempt.update(flag=bool(m["abft_flag"]),
                       max_rel=float(m["abft_max_rel"]),
                       state_bitwise=_equal_trees(torch, out, st))
        return out, m
    flags0, retries0 = guard.flags, guard.retries
    state = run(guard.run_step, upset_once, state, batches[1])
    upset = dict(delta=TRAIN["delta"], **attempt,
                 flags=guard.flags - flags0,
                 retries=guard.retries - retries0)
    # step 3, clean, traced on the device; the forward alone traced too
    (state, m3), trace = train_trace(
        torch, lambda: guard.run_step(step, state, batches[2]))
    metrics.append({k: float(v) for k, v in m3.items()})
    fwd_batch = {k: v for k, v in batches[2].items() if k != "labels"}
    with torch.no_grad():
        _, fwd_trace = train_trace(torch, lambda: model_forward(
            state["params"], cfg, fwd_batch, abft))
    if "b4_device_ms" in trace and "b4_device_ms" in fwd_trace:
        trace["b4_forward_device_ms"] = fwd_trace["b4_device_ms"]
        trace["b4_backward_device_ms"] = trace["b4_device_ms"] \
            - fwd_trace["b4_device_ms"]
        trace["forward_device_busy_ms"] = fwd_trace["device_busy_ms"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain = runtime.plain_counts()
    # the adopted steps 1, 2 and 3 (metrics 1 and 2 are step 1's reruns)
    losses = [metrics[i]["loss"] for i in (0, 3, 4)]
    fields = dict(
        model=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
        batch=TRAIN["batch"], seq=TRAIN["seq"], steps=TRAIN["steps"],
        optimizer=dict(lr=opt.lr, warmup=TRAIN["warmup"],
                       total_steps=TRAIN["total"]),
        init_seconds=t_init,
        runs=["step 1 guarded", "step 1 unguarded", "step 1 again",
              "step 2 (upset, retried)", "step 3 (traced)"],
        losses=losses, grad_norms=[m["grad_norm"] for m in metrics],
        max_rel=[m["abft_max_rel"] for m in metrics],
        clean_flags=sum(m["abft_flag"] for m in metrics),
        step_ms=step_ms, launches=counts, want_launches=want,
        plain_calls=plain, guarded_eq_unguarded=guarded_eq_unguarded,
        repeat_bitwise=repeat_bitwise, upset=upset, trace=trace,
        peak_memory_gb=peak_gb)
    ok = all(math.isfinite(x) for x in losses) and not fields["clean_flags"] \
        and guarded_eq_unguarded and repeat_bitwise \
        and all(c == want for i, c in enumerate(counts) if i != 3) \
        and not any(plain.values()) and upset.get("flag") \
        and upset.get("state_bitwise") and upset["flags"] == 1 \
        and upset["retries"] == 1
    if not ok:
        emit("lm_train", nvidia_smi=smi, **fields)
        raise AssertionError(f"lm_train: gates failed: {fields}")

    # a 2-layer cut at T 128: the card against the CPU's plain versions
    n_cut, t_cut = TRAIN["cut_layers"], TRAIN["cut_seq"]
    import dataclasses
    cut_cfg = dataclasses.replace(cfg, n_layers=n_cut)
    params = state["params"]
    cut = dict(params, segments=[_slice_tree(params["segments"][0], n_cut)])
    cut_batch = {k: v[:, :t_cut] for k, v in batches[0].items()}
    del state, batches, data
    gc.collect()
    torch.cuda.empty_cache()
    runs = {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        loss, rep, grads = loss_and_grads(
            _tree_to(cut, dev), cut_cfg,
            {k: v.to(dev) for k, v in cut_batch.items()}, abft)
        runs[dev] = dict(loss=float(loss), flag=bool(rep.flag),
                         grads=[g.cpu() for g in grads],
                         seconds=time.perf_counter() - t)
        del grads
    del cut, params
    ratios = [float((g - c).abs().max()) / max(float(c.abs().max()), 1e-30)
              / 1e-4 for g, c in zip(runs["cuda"]["grads"],
                                     runs["cpu"]["grads"])]
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    loss_ratio = abs(runs["cuda"]["loss"] - runs["cpu"]["loss"]) / (
        LOGIT_ATOL + LM_LOGIT_RTOL * abs(runs["cpu"]["loss"]))
    fields["cut"] = dict(
        layers=n_cut, seq=t_cut, loss_card=runs["cuda"]["loss"],
        loss_cpu=runs["cpu"]["loss"], loss_gate_ratio=loss_ratio,
        grad_leaves=len(ratios), worst_grad_leaf=worst,
        worst_grad_gate_ratio=ratios[worst],
        worst_grad_leaf_shape=list(runs["cpu"]["grads"][worst].shape),
        flags=[runs["cuda"]["flag"], runs["cpu"]["flag"]],
        tolerance=dict(loss=dict(atol=LOGIT_ATOL, rtol=LM_LOGIT_RTOL),
                       grad="1e-4 x max|g_cpu| a leaf"),
        card_seconds=runs["cuda"]["seconds"],
        cpu_seconds=runs["cpu"]["seconds"])
    del runs

    # whisper-medium: one guarded step, unguarded and again, from one state
    wcfg = arch_config("whisper-medium")
    wspec = next(s for s in ARCHS if s["arch"] == "whisper-medium")
    wstep = make_train_step(wcfg, abft, opt, **sched)
    wstate = init_train_state(wcfg, TRAIN["seed"], device="cuda")
    wbatch = next(Prefetcher(SyntheticLM(
        wcfg.vocab_size, wspec["prompt"], wspec["batch"],
        seed=TRAIN["seed"]).batches(), device="cuda"))
    wbatch["src_embeds"] = torch.randn(
        wspec["batch"], wspec["src"], wcfg.d_model, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(TRAIN["seed"]))
    wguard = ABFTGuard()
    runtime.reset_counts()
    t = time.perf_counter()
    ws, wm = wguard.run_step(wstep, wstate, wbatch)
    torch.cuda.synchronize()
    w_ms = (time.perf_counter() - t) * 1e3
    w_counts = {k: v for k, v in runtime.launch_counts().items() if v}
    w_plain = runtime.plain_counts()
    w_per = lm_step_launches(wcfg)
    w_want = {k: 3 * n if k.startswith("matmul") else n
              for k, n in w_per.items() if n}
    wu, _ = make_train_step(wcfg, abft, opt, guard_in_graph=False,
                            **sched)(wstate, wbatch)
    wr, _ = wstep(wstate, wbatch)
    fields["whisper"] = dict(
        model=wcfg.name, layers=wcfg.n_layers,
        encoder_layers=wcfg.enc_layers, batch=wspec["batch"],
        seq=wspec["prompt"], src=wspec["src"], loss=float(wm["loss"]),
        grad_norm=float(wm["grad_norm"]), flag=bool(wm["abft_flag"]),
        max_rel=float(wm["abft_max_rel"]), step_ms=w_ms, launches=w_counts,
        want_launches=w_want, plain_calls=w_plain,
        guarded_eq_unguarded=_equal_trees(torch, ws, wu),
        repeat_bitwise=_equal_trees(torch, ws, wr),
        moved=not _equal_trees(torch, ws["opt"], wstate["opt"]))
    del ws, wu, wr, wstate
    emit("lm_train", nvidia_smi=smi, **fields)
    w = fields["whisper"]
    if not (math.isfinite(w["loss"]) and not w["flag"]
            and w["launches"] == w_want and not any(w_plain.values())
            and w["guarded_eq_unguarded"] and w["repeat_bitwise"]
            and w["moved"]):
        raise AssertionError(f"lm_train whisper: {w}")
    c = fields["cut"]
    if not (c["loss_gate_ratio"] <= 1.0 and c["worst_grad_gate_ratio"] <= 1.0
            and not any(c["flags"])):
        raise AssertionError(f"lm_train cut, card vs CPU: {c}")
    gc.collect()
    torch.cuda.empty_cache()
    total = {}
    for cnt in (counts[0], w_counts):
        for k, v in cnt.items():
            total[k] = total.get(k, 0) + v
    return total


def _ckpt_base(need: int):
    """The directory the driver's checkpoints go under: the temp dir or
    the checkout's git-ignored ``build/``, whichever has more free space;
    raises when that is under ``need`` bytes."""
    import shutil
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    free = {d: shutil.disk_usage(d).free
            for d in (tempfile.gettempdir(), os.path.join(ROOT, "build"))}
    base = max(free, key=free.get)
    if free[base] < need:
        raise RuntimeError(
            f"train_driver: {free[base] / 1e9:.1f} GB free under {base} "
            f"(the most of {sorted(free)}), under the {need / 1e9:.1f} GB "
            f"of three checkpoints")
    return base, free


def phase_train_driver(torch, smi):
    """The training driver (``python -m repro_torch.launch.train``) and the
    checkpoint package on the card, at ``TRAIN_DRIVER``'s cut of gemma-2b:
    (a) an uninterrupted run (``steps``, a checkpoint every ``ckpt_every``)
    whose final state and last checkpoint, read back onto the card, equal
    the direct sequence of train steps over the stream's first batches bit
    for bit, its mid-run checkpoint labelled as the reference labels it
    (the state after step ``i`` under ``i``); (b) a run of ``first`` steps
    resumed to ``steps`` — the stream restarts, as the reference's does —
    equal to its direct sequence bit for bit, twice; (c) ``reshard_restore``
    of (a)'s checkpoint with the embedding on the host and every other
    leaf on the card, bit for bit; (d) the CLI as processes: gemma-2b
    trains, checkpoints and resumes, whisper-medium trains (B5's
    non-causal and cross launches under the driver); (e) a
    ``StreamingEngine(checkpoint_dir=)`` on the card under a sticky
    accumulator fault: every request served, the ladder degraded, each
    degrade's checkpoint with the reference's ``extra`` and the engine's
    folded params bit for bit.  Reports the bytes of a checkpoint, each
    save's blocking snapshot and writer seconds, and the restores'.
    Returns the launches of the driven runs ((a), (b), (e))."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import load_checkpoint, reshard_restore
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.engine import StreamingEngine, plan_rungs, \
        synth_graph_stream
    from repro_torch.kernels import runtime
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import AdamWConfig, tree_leaves, tree_map
    from repro_torch.runtime import ABFTGuard, GuardConfig

    spec = TRAIN_DRIVER
    cfg = arch_config(spec["arch"], layers=spec["layers"])
    n_params = sum(x.numel() for x in tree_leaves(
        init_model(cfg, 0, device="meta")))
    need = 3 * 12 * n_params               # params, m and v in f32
    base, free = _ckpt_base(need)
    root = tempfile.mkdtemp(prefix="train_driver_", dir=base)
    launches: dict = {}
    log: list = []
    run_kw = dict(batch=spec["batch"], seq=spec["seq"], device="cuda",
                  log=log.append)

    def driven(**kw):
        """One driver run, its launches added to ``launches``."""
        runtime.reset_counts()
        out = train(cfg, **run_kw, **kw)
        torch.cuda.synchronize()
        for k, v in runtime.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        if any(runtime.plain_counts().values()) or out["flags"]:
            raise AssertionError(f"train_driver {kw}: plain calls "
                                 f"{runtime.plain_counts()}, flags "
                                 f"{out['flags']}")
        return out

    def direct(state, steps, n, times=None):
        """``n`` train steps of a ``steps``-step run over the stream's first
        batches, built as the driver builds its step (``times``: each
        synchronised step's host ms appended)."""
        step = make_train_step(
            cfg, ABFTConfig(mode="fused", threshold=5e-2, relative=True),
            AdamWConfig(lr=1e-3), total_steps=steps,
            warmup=max(steps // 10, 1))
        it = SyntheticLM(cfg.vocab_size, spec["seq"], spec["batch"],
                         seed=0).batches()
        for _ in range(n):
            batch = {k: torch.from_numpy(v).to("cuda")
                     for k, v in next(it).items()}
            t = time.perf_counter()
            state, _m = step(state, batch)
            torch.cuda.synchronize()
            if times is not None:
                times.append((time.perf_counter() - t) * 1e3)
        return state

    fields = dict(model=cfg.name, layers=cfg.n_layers, params=n_params,
                  batch=spec["batch"], seq=spec["seq"], dir_base=base,
                  free_gb={d: f / 1e9 for d, f in free.items()},
                  need_gb=need / 1e9)
    t_phase = time.perf_counter()
    try:
        # (a) uninterrupted
        da = os.path.join(root, "a")
        out = driven(steps=spec["steps"], ckpt_dir=da,
                     ckpt_every=spec["ckpt_every"])
        step_ms: list = []
        want = direct(init_train_state(cfg, 0, device="cuda"),
                      spec["steps"], spec["steps"], step_ms)
        final_bitwise = _equal_trees(torch, out["state"], want)
        out.pop("state")
        t = time.perf_counter()
        saved, label = load_checkpoint(da, want)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t
        ckpt_bitwise = label == spec["steps"] and _equal_trees(
            torch, saved, want)
        del saved
        with np.load(os.path.join(
                da, f"step_{spec['ckpt_every']:08d}", "host0.npz")) as f:
            mid_opt_step = int(f["opt__step"])
        dirs = sorted(d for d in os.listdir(da) if d.startswith("step_"))
        ckpt_bytes = sum(os.path.getsize(os.path.join(da, dirs[-1], f))
                         for f in os.listdir(os.path.join(da, dirs[-1])))
        fields["uninterrupted"] = dict(
            steps=spec["steps"], ckpt_every=spec["ckpt_every"], dirs=dirs,
            final_bitwise=final_bitwise, checkpoint_bitwise=ckpt_bitwise,
            mid_label=spec["ckpt_every"], mid_opt_step=mid_opt_step,
            saves=out["ckpt_timings"], read_back_s=read_s,
            loop_s=out["seconds"], direct_step_ms=step_ms, log=log[-1:])
        fields["checkpoint_bytes"] = ckpt_bytes
        if not (final_bitwise and ckpt_bitwise
                and mid_opt_step == spec["ckpt_every"] + 1
                and dirs == [f"step_{spec['ckpt_every']:08d}",
                             f"step_{spec['steps']:08d}"]):
            raise AssertionError(f"train_driver (a): {fields}")

        # (c) placement: the embedding on the host, the rest on the card
        places = tree_map(lambda _: "cuda", want)
        places["params"]["embed"]["table"] = "cpu"
        t = time.perf_counter()
        placed, label = reshard_restore(da, want, places)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t
        where = [x.device.type for x in tree_leaves(placed)]
        placed_bitwise = all(torch.equal(x.to(y.device), y) for x, y in zip(
            tree_leaves(placed), tree_leaves(want)))
        host_leaves = [i for i, d in enumerate(where) if d == "cpu"]
        fields["placement"] = dict(
            label=label, seconds=place_s, host_leaves=len(host_leaves),
            card_leaves=where.count("cuda"), bitwise=placed_bitwise,
            embed_on_host=placed["params"]["embed"]["table"].device.type
            == "cpu")
        del placed, want
        shutil.rmtree(da)
        if not (placed_bitwise and len(host_leaves) == 1
                and fields["placement"]["embed_on_host"]):
            raise AssertionError(f"train_driver (c): {fields['placement']}")

        # (b) resumed, twice from a fresh first run
        db = os.path.join(root, "b")
        resumed = []
        for _ in range(2):
            shutil.rmtree(db, ignore_errors=True)
            first = driven(steps=spec["first"], ckpt_dir=db,
                           ckpt_every=spec["ckpt_every"])
            first.pop("state")
            res = driven(steps=spec["steps"], ckpt_dir=db,
                         ckpt_every=spec["ckpt_every"])
            resumed.append(dict(res, first_saves=first["ckpt_timings"]))
        want = direct(direct(init_train_state(cfg, 0, device="cuda"),
                             spec["first"], spec["first"]),
                      spec["steps"], spec["steps"] - spec["first"])
        fields["resumed"] = [dict(
            started=r["started"], bitwise=_equal_trees(torch, r["state"],
                                                        want),
            restore_s=r["restore_s"], first_saves=r["first_saves"],
            saves=r["ckpt_timings"], loop_s=r["seconds"])
            for r in resumed]
        del resumed, want, res, first
        shutil.rmtree(db)
        gc.collect()
        torch.cuda.empty_cache()
        if not all(r["bitwise"] and r["started"] == spec["first"]
                   for r in fields["resumed"]):
            raise AssertionError(f"train_driver (b): {fields['resumed']}")

        # (d) the CLI as processes
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
                "PYTHONPATH", "").split(os.pathsep) if p]))
        dc, dw = os.path.join(root, "cli"), os.path.join(root, "cli_w")
        cli = []
        for arch, extra_args, ckdir, want_line in (
                ("gemma-2b", ["--steps", "4", "--ckpt-every", "2"], dc,
                 "abft flags 0"),
                ("gemma-2b", ["--steps", "6", "--ckpt-every", "2"], dc,
                 "resumed from step 4"),
                ("whisper-medium", ["--steps", "2"], dw, "abft flags 0")):
            t = time.perf_counter()
            done = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 arch, "--smoke", "--ckpt-dir", ckdir, *extra_args],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, timeout=600)
            lines = done.stdout.strip().splitlines()
            cli.append(dict(arch=arch, args=extra_args,
                            returncode=done.returncode,
                            seconds=time.perf_counter() - t,
                            output=lines[-3:]))
            if done.returncode or want_line not in done.stdout \
                    or "abft flags 0" not in done.stdout:
                fields["cli"] = cli
                emit("train_driver", nvidia_smi=smi, log=lines[-20:],
                     **fields)
                raise AssertionError(f"launch.train {arch} {extra_args}: "
                                     f"{cli[-1]}")
        fields["cli"] = cli

        # (e) the stream engine's degrade checkpoints
        de = os.path.join(root, "stream")
        stream = synth_graph_stream(spec["stream"], n_lo=SERVE["n_lo"],
                                    n_hi=SERVE["n_hi"], feat=DIMS[0],
                                    avg_deg=SERVE["avg_deg"],
                                    seed=SERVE["seed"])
        rungs = plan_rungs(stream[:STREAM["n_slots"]],
                           n_slots=STREAM["n_slots"], block=SERVE["block"],
                           stripe_multiple=SERVE["stripe_multiple"],
                           width_multiple=SERVE["width_multiple"])
        eng = StreamingEngine(
            make_params(torch), ABFTConfig(mode="fused", threshold=1e-3,
                                           relative=True), rungs,
            guard=ABFTGuard(GuardConfig(max_retries=1, max_restores=1,
                                        persistent_window=4,
                                        persistent_threshold=2)),
            inject=(0, 0, 0, 100.0), checkpoint_dir=de, device="cuda")
        runtime.reset_counts()
        results = []
        for s, h0 in stream:
            eng.submit(s, h0)
            results.extend(eng.take_results())
        results += eng.drain()
        torch.cuda.synchronize()
        for k, v in runtime.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        stats = eng.stats(results)
        steps = sorted(d for d in os.listdir(de) if d.startswith("step_"))
        extras = [json.load(open(os.path.join(de, d, "manifest.json")))[
            "extra"] for d in steps]
        saved, label = load_checkpoint(de, eng.params)
        fields["stream"] = dict(
            requests=len(stream), served=stats["served"],
            statuses=sorted({r.status for r in results}),
            flagged=sum(bool(r.flag) for r in results),
            degrades=stats["degrades"], failovers=stats["failovers"],
            ladder=stats["backend_ladder"],
            active_backend=stats["active_backend"], checkpoints=steps,
            extras=extras,
            params_bitwise=label >= 0 and _equal_trees(torch, saved,
                                                       eng.params),
            on_card=all(x.is_cuda for x in tree_leaves(saved)))
        del eng, saved
        s = fields["stream"]
        if not (s["served"] == s["requests"] and s["statuses"] == ["served"]
                and s["degrades"] >= 1 and 1 <= len(steps) <= s["degrades"]
                and all(set(e) == {"reason", "backend", "degrade_level"}
                        and e["backend"] in s["ladder"] for e in extras)
                and s["params_bitwise"] and s["on_card"]
                and s["flagged"] == 0):
            raise AssertionError(f"train_driver (e): {s}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fields["seconds"] = time.perf_counter() - t_phase
    fields["launches"] = launches
    emit("train_driver", nvidia_smi=smi, **fields)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_lm_serve(torch, smi):
    """The checked-op main path: LMEngine at gemma-2b's full width, all 18
    layers, f32, through :func:`lm_gates`; then one guarded decode step
    traced on the device, and the campaign's LM lane on the same master."""
    from repro_torch.models.transformer import init_model

    cfg = lm_config()
    cache_len = LM["prompt"] + LM["new"]
    t_init = time.perf_counter()
    params = init_model(cfg, LM["seed"], device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    run = lm_gates(torch, cfg, params, {}, cache_len)
    run["fields"]["split"] = split_gates(torch, cfg, params, {}, cache_len)
    eng = run["eng"]

    # where a guarded decode step's time goes on the device
    _, st0, _ = eng.prefill(run["tokens"])
    trace = decode_trace(torch, lambda: eng.decode(
        st0, run["toks"][0], LM["prompt"], inject=0.0))
    del st0
    emit("lm_serve", nvidia_smi=smi, init_seconds=t_init, **run["fields"],
         decode_trace=trace, guard=eng.stats())
    _raise_unless_cut_ok(run)
    launches = run["want"]
    del run, eng
    # the 18-layer master is freed after this frame (the engine's cycle by
    # the collector): the campaign's LM lane runs on it first
    phase_campaign_lm(torch, cfg, params, cache_len)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_lm_archs(torch, smi):
    """qwen1.5-4b, chatglm3-6b, h2o-danube-3-4b, deepseek-moe-16b (all
    layers), qwen3-moe-30b-a3b (24 of 48 layers), rwkv6-7b,
    recurrentgemma-9b, whisper-medium (all layers; 1500 source frames) and
    internvl2-26b (32 of 48 layers; 256 prefix embeddings) served at full
    width, f32, seeded weights, one at a time through :func:`lm_gates`
    (each master freed before the next); one guarded decode step of each
    MoE, recurrent and front-end model traced on the device.  Returns the
    B4, grouped B4 and B5 launches of the guarded clean runs."""
    from repro_torch.models.transformer import init_model

    launches = {"matmul_abft": 0, "matmul_abft_grouped": 0,
                "flash_checksum": 0}
    for spec in ARCHS:
        cfg = arch_config(spec["arch"], spec.get("layers"))
        t0 = time.perf_counter()
        params = init_model(cfg, LM["seed"], device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(x.numel() for x in _leaves(params))
        run = lm_gates(torch, cfg, params, spec, spec["cache"])
        if spec["arch"] in SPLIT_ARCHS:
            run["fields"]["split"] = split_gates(torch, cfg, params, spec,
                                                 spec["cache"])
        trace, calls = None, []
        if cfg.moe is not None or run["fields"]["scans"] is not None \
                or cfg.frontend:
            eng = run["eng"]
            pos0 = spec["prompt"] + (0 if cfg.family == "encdec"
                                     else spec.get("prefix", 0))
            # an MoE model's grouped launches of one guarded prefill and
            # decode step: their shapes and routing's row counts
            with grouped_record() as calls:
                _, st0, _ = eng.prefill(run["tokens"])
                n_prefill = len(calls)
                if cfg.moe is not None:
                    eng.decode(st0, run["toks"][0], pos0)
            trace = decode_trace(torch, lambda: eng.decode(
                st0, run["toks"][0], pos0, inject=0.0))
            del eng, st0
        from repro_torch.configs import get_config
        emit("lm_archs", nvidia_smi=smi, init_seconds=t_init,
             params=n_params, weight_gb=4 * n_params / 1e9,
             published_layers=get_config(spec["arch"]).n_layers,
             **run["fields"], decode_trace=trace, guard=run["eng"].stats(),
             seconds=time.perf_counter() - t0)
        _raise_unless_cut_ok(run)
        for name in launches:
            launches[name] += run["want"].get(name, 0)
        # the engine and its guard hold each other (the guard's restore_fn
        # is the engine's method): only the cycle collector frees the master
        del run, params
        gc.collect()
        torch.cuda.empty_cache()
        if calls:
            moe_grouped(torch, cfg, calls[:n_prefill], calls[n_prefill:])
    return launches


def moe_grouped(torch, cfg, prefill, decode):
    """An MoE model's grouped launches of one guarded prefill and decode
    step (:class:`grouped_record`), each replayed on random operands with
    its routing's row counts and without (:func:`grouped_step_times`); the
    first MoE layer's up and down launches of each step held as
    ``lm_kernels`` holds the edge counts (:func:`check_grouped_counts`)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    steps = {"prefill": grouped_step_times(torch, prefill, gen),
             "decode": grouped_step_times(torch, decode, gen)}
    routing = []
    for step, calls in (("prefill", prefill), ("decode", decode)):
        for what, (shape, rows) in (("up", calls[0]), ("down", calls[2])):
            routing.append(check_grouped_counts(
                torch, *shape, gen, {f"routing {step} {what}":
                                     rows.tolist()}, False))
    emit("lm_archs_grouped", arch=cfg.name, per_step=steps,
         routing_checks=routing)


def phase_serve_cli(torch):
    """``python -m repro_torch.launch.serve --arch A --smoke`` on the card
    for whisper-medium and internvl2-26b (the smoke twins at the entry
    point's defaults: B 4, prompt 64, 64 new tokens), each in a process of
    its own that loads the library this run built: exit 0, no flag."""
    runs = []
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    for arch in ("whisper-medium", "internvl2-26b"):
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             arch, "--smoke"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=600)
        lines = done.stdout.strip().splitlines()
        runs.append(dict(arch=arch, returncode=done.returncode,
                         seconds=time.perf_counter() - t0,
                         output=lines[-2:]))
        if done.returncode or "flag=False" not in done.stdout \
                or "flags=0" not in done.stdout:
            emit("serve_cli", runs=runs, log=lines[-20:])
            raise AssertionError(f"launch.serve --arch {arch} --smoke: "
                                 f"{runs[-1]}")
    emit("serve_cli", runs=runs)



# runs one of the port's examples as ``__main__`` in the process it is
# started as, then prints the process's kernel launch counts and its
# seconds on a line of their own (the example's own output is unchanged
# above it)
EXAMPLE_RUNNER = """
import time
t0 = time.perf_counter()
import json, runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
from repro_torch.kernels import runtime
print("RESULT " + json.dumps({"launches": runtime.launch_counts(),
                              "seconds": time.perf_counter() - t0}),
      flush=True)
"""


def _block_ell_diff_ok(out):
    """The quickstart's ``block_ell`` line: |logit diff| <= 1e-4."""
    found = re.findall(r"^  block_ell +\|logit diff\|=(\S+) ", out, re.M)
    return len(found) == 1 and float(found[0]) <= 1e-4


def _loss_fell(out):
    """train_gcn: the last printed loss below the first."""
    losses = [float(x) for x in re.findall(r"^step +\d+ loss=(\S+) ", out,
                                           re.M)]
    return len(losses) >= 2 and losses[-1] < losses[0]


def example_runs(tmp):
    """The ``examples`` phase's runs: (example, argv, patterns its output
    must match — multiline regexes —, kernels that must launch, a further
    check of the output or None)."""
    gemma_ckpt = os.path.join(tmp, "ckpt_gemma")
    cuda, lm = ["--device", "cuda"], ["matmul_abft", "flash_checksum"]
    clean_lm = [r"ABFT flags: 0$"]
    return [
        ("fault_injection_demo", [],
         [r"^  split : detected \d+, silent 0,",
          r"^  fused : detected \d+, silent 0,"], [], None),
        ("quickstart", cuda,
         [r"^split : clean forward  flag=False ",
          r"^fused : clean forward  flag=False ", r"-> detected: True$",
          r"^  block_ell +\|logit diff\|=\S+ flag=False "],
         ["spmm_abft"], _block_ell_diff_ok),
        ("train_gcn", cuda + ["--scale", "1", "--steps", "50"],
         [r"flagged steps: 0$"], [], _loss_fell),
        ("train_lm", cuda + ["--arch", "gemma-2b", "--steps", "30",
                             "--ckpt", gemma_ckpt],
         [r"\(improved: True\); ABFT flags: 0$"], lm, None),
        ("train_lm", cuda + ["--arch", "gemma-2b", "--steps", "5",
                             "--ckpt", gemma_ckpt],
         [r"^restored from step 30$"] + clean_lm, lm, None),
        ("train_lm", cuda + ["--arch", "whisper-medium", "--steps", "1",
                             "--ckpt", os.path.join(tmp, "ckpt_whisper")],
         clean_lm, lm, None),
        ("train_lm", cuda + ["--arch", "internvl2-26b", "--steps", "1",
                             "--ckpt", os.path.join(tmp, "ckpt_internvl")],
         clean_lm, lm, None),
        ("serve_lm", cuda + ["--arch", "gemma-2b"],
         [r"abft_flag=False$"] + clean_lm, lm, None),
        ("serve_lm", cuda + ["--arch", "whisper-medium"],
         [r"abft_flag=False$"] + clean_lm, lm, None),
        ("serve_lm", cuda + ["--arch", "deepseek-moe-16b"],
         [r"abft_flag=False$"] + clean_lm, lm + ["matmul_abft_grouped"],
         None),
    ]


def phase_examples(torch):
    """The port's five examples (``examples/torch_*.py``), each a process
    of its own that loads the library this run built: the fault demo (numpy
    on the host, started first and run beside the others, as it uses no
    card), the quickstart (B1 on its ``block_ell`` line), train_gcn at full
    Cora's widths (2708 nodes, 1433 -> 16 -> 7) for 50 steps, train_lm on
    the gemma-2b smoke twin for 30 steps and again from its checkpoint, one
    step each of whisper-medium and internvl2-26b, and serve_lm for
    gemma-2b, whisper-medium and deepseek-moe-16b (B4, the grouped B4, B5)
    — the card's runs one after another, so each prints its own times.
    Each must exit 0, match its patterns and launch its kernels
    (:func:`example_runs`).  Returns the launches summed over the runs."""
    import tempfile
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    tmp = tempfile.mkdtemp(prefix="examples_")

    def start(name, argv):
        cmd = [sys.executable, "-c", EXAMPLE_RUNNER,
               os.path.join(ROOT, "examples", f"torch_{name}.py"), *argv]
        return time.perf_counter(), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def finish(run, started):
        name, argv, patterns, kernels, check = run
        t0, proc = started
        try:
            stdout, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        wall = time.perf_counter() - t0
        lines = stdout.strip().splitlines()
        result = [json.loads(x[len("RESULT "):]) for x in lines
                  if x.startswith("RESULT ")]
        result = result[-1] if result else {"launches": {}, "seconds": wall}
        launches = result["launches"]
        lines = [x for x in lines if not x.startswith("RESULT ")]
        out = "\n".join(lines)
        bad = ["exit 0"] if proc.returncode else []
        bad += [p for p in patterns if not re.search(p, out, re.M)]
        bad += [f"a {k} launch" for k in kernels if not launches.get(k)]
        if check is not None and not check(out):
            bad.append(check.__name__)
        runs.append(dict(
            example=f"torch_{name}", argv=argv, returncode=proc.returncode,
            seconds=result["seconds"],
            launches={k: v for k, v in launches.items() if v},
            output=lines[-2:],
            printed_times=[x for x in lines if re.search(r"\d ms\b|ms/step",
                                                         x)]))
        if bad:
            emit("examples", runs=runs, log=lines[-30:])
            raise AssertionError(f"examples/torch_{name}.py {argv}: not "
                                 f"shown: {bad}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    runs, total = [], {}
    plan = example_runs(tmp)
    host = [(run, start(*run[:2])) for run in plan if "--device" not in run[1]]
    try:
        for run in plan:
            if "--device" in run[1]:
                finish(run, start(*run[:2]))
        for run, started in host:
            finish(run, started)
    finally:
        for _run, (_t0, proc) in host:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    emit("examples", runs=runs, launches=total,
         seconds=time.perf_counter() - t_phase)
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def gat_f64_forward(torch, params, h, adj):
    """The GAT forward in float64 on the card, from the same weights: the
    yardstick of the served logits."""
    import torch.nn.functional as F
    x, mask = h.double(), adj > 0
    n_layers = len(params["layers"])
    for i, p in enumerate(params["layers"]):
        xw = x @ p["w"].double()
        sc = (xw @ p["a_l"].double())[:, None] \
            + (xw @ p["a_r"].double())[None, :]
        sc = F.leaky_relu(sc, 0.2).masked_fill_(~mask, -1e30)
        att = torch.softmax(sc, dim=-1)
        del sc
        x = att @ xw
        del att
        if i < n_layers - 1:
            x = F.elu(x)
    return x


def gat_b4_ms(torch, forward, reps=5):
    """CUDA-event ms of each ``matmul_abft`` launch inside the served GAT
    forward ``forward()`` (H W with its H w_r column, then att @ X, layer
    by layer), the mean over ``reps`` forwards after one warm-up, beside
    each launch's bound: a thin timed wrapper stands in for the engine's
    ``matmul_abft_kernel`` while it runs."""
    from repro_torch.engine import gat as gat_mod
    kernel, events = gat_mod.matmul_abft_kernel, []

    def timed(a, b, br=None, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = kernel(a, b, br, **kw)
        end.record()
        events.append((tuple(a.shape), b.shape[1], br is not None, start,
                       end))
        return out

    forward()
    gat_mod.matmul_abft_kernel = timed
    try:
        for _ in range(reps):
            forward()
    finally:
        gat_mod.matmul_abft_kernel = kernel
    torch.cuda.synchronize()
    per = len(events) // reps
    rows = []
    for i in range(per):
        (m, k), n, column, _, _ = events[i]
        bound, by, _, _ = matmul_bound(torch, m, k, n, torch.float32)
        rows.append(dict(launch=i, layer=i // 2,
                         product="h_w" if column else "att_x",
                         m=m, k=k, n=n, check_column=column,
                         rows_16b_aligned=(k * 4) % 16 == 0,
                         ms=sum(s.elapsed_time(e) for *_, s, e
                                in events[i::per]) / reps,
                         bound_ms=bound, bound_by=by))
    return rows


def phase_gat(torch):
    """Guarded GAT serving on the card (engine/gat.py): full Cora and full
    PubMed, the adjacency pattern A + I dense, weights from seed 0 — logits
    against a float64 forward, no clean flag, guarded == unguarded bit for
    bit, an upset in each layer flagging only that layer's site and retried
    bit for bit, a W bit flip after the fold restored bit for bit, exactly
    two matmul_abft launches a layer and no plain call.  Returns the B4
    launches of the guarded clean forwards, counted from 0 just before
    each."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.core.datasets import make_dataset
    from repro_torch.engine.gat import (GATEngine, gat_forward, init_gat,
                                        make_gat_serve_step)
    from repro_torch.faults.injectors import flip_bits_tensor
    from repro_torch.kernels import runtime

    cfg = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    off = ABFTConfig(mode="none")
    served = 0
    for spec in GAT:
        t0 = time.perf_counter()
        ds = make_dataset(spec["graph"], normalize=False)
        n, dims = ds.stats.nodes, spec["dims"]
        n_layers = len(dims) - 1
        if (n, dims[0]) != (ds.features.shape[0], ds.features.shape[1]):
            raise AssertionError(f"gat {spec['graph']}: {n} nodes x "
                                 f"{ds.features.shape[1]} features, dims "
                                 f"{dims}")
        adj = torch.zeros((n, n), dtype=torch.float32, device="cuda")
        adj[torch.from_numpy(ds.s.row).cuda(),
            torch.from_numpy(ds.s.col).cuda()] = 1.0
        h = torch.from_numpy(ds.features.todense()).cuda()
        params = init_gat(torch.Generator().manual_seed(GAT_SEED), dims,
                          device="cuda")
        eng = GATEngine(cfg, params)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        tag = f"gat {spec['graph']}"

        runtime.reset_counts()
        ref, _ = gat_forward(params, h, adj, off)           # unguarded
        ref_counts, ref_plain = runtime.launch_counts(), \
            runtime.plain_counts()
        # the main path: the guarded forward, its launches counted alone
        runtime.reset_counts()
        out, m = eng.forward(h, adj)
        counts, plain = runtime.launch_counts(), runtime.plain_counts()
        want_counts = {k: 0 for k in counts}
        want_counts["matmul_abft"] = 2 * n_layers
        if counts != want_counts or ref_counts != want_counts \
                or any(plain.values()) or any(ref_plain.values()):
            raise AssertionError(f"{tag}: launches guarded {counts}, "
                                 f"unguarded {ref_counts} (want "
                                 f"{want_counts}), plain {plain}, "
                                 f"{ref_plain}")
        served += counts["matmul_abft"]
        identical = torch.equal(out, ref)
        max_rel = float(m["abft_max_rel"])
        if not identical or eng.guard.flags or not max_rel <= CORNER_RTOL \
                or m["abft_op_ids"] != tuple(f"gat{i}"
                                             for i in range(n_layers)):
            raise AssertionError(f"{tag}: guarded == unguarded {identical}, "
                                 f"clean flags {eng.guard.flags}, max_rel "
                                 f"{max_rel:.3e}, ids {m['abft_op_ids']}")
        want = gat_f64_forward(torch, params, h, adj)
        ratio = float(((out.double() - want).abs()
                       / (LOGIT_ATOL + LM_LOGIT_RTOL * want.abs())).max())
        err = float((out.double() - want).abs().max())
        del want
        finite = bool(torch.isfinite(out).all()) and \
            tuple(out.shape) == (n, dims[-1])

        # an upset in each layer: only its site flags; the engine retries
        # it away bit for bit
        step = make_gat_serve_step(cfg)
        upsets = []
        for layer in range(n_layers):
            _, mi = step(eng.params, h, adj, layer, GAT_DELTA)
            flags0, retries0 = eng.guard.flags, eng.guard.retries
            again, _ = eng.forward(h, adj, inject_layer=layer,
                                   inject_delta=GAT_DELTA)
            upsets.append(dict(
                layer=layer, delta=GAT_DELTA,
                site_flags=mi["abft_op_flags"].tolist(),
                site_rel=mi["abft_op_rel"].tolist(),
                flags=eng.guard.flags - flags0,
                retries=eng.guard.retries - retries0,
                bitwise=torch.equal(again, ref)))
            if upsets[-1]["site_flags"] != [i == layer
                                            for i in range(n_layers)] \
                    or upsets[-1]["flags"] != 1 \
                    or upsets[-1]["retries"] != 1 \
                    or not upsets[-1]["bitwise"]:
                raise AssertionError(f"{tag}: upset {upsets[-1]}")

        # a bit flip in one layer's W after the fold: a corrupted clone
        # replaces the working leaf; the guard refolds from the master
        flags0, restores0 = eng.guard.flags, eng.guard.restores
        layers = list(eng.params["layers"])
        fl = GAT_FLIP["layer"]
        layers[fl] = dict(layers[fl], w=flip_bits_tensor(
            layers[fl]["w"], GAT_FLIP["index"], GAT_FLIP["bit"]))
        eng.params = dict(eng.params, layers=layers)
        del layers
        again, _ = eng.forward(h, adj)
        flip = dict(GAT_FLIP, flags=eng.guard.flags - flags0,
                    restores=eng.guard.restores - restores0,
                    bitwise=torch.equal(again, ref))
        if flip["flags"] != 1 or flip["restores"] != 1 \
                or not flip["bitwise"]:
            raise AssertionError(f"{tag}: weight flip {flip}")
        if any(runtime.plain_counts().values()):
            raise AssertionError(f"{tag}: plain calls in the repairs "
                                 f"{runtime.plain_counts()}")

        # forward times (CUDA events): guarded and unguarded, and each B4
        # launch at its served operands
        fwd_ms = time_ms(lambda: gat_forward(eng.params, h, adj, cfg),
                         warm=1, reps=5)
        fwd_off_ms = time_ms(lambda: gat_forward(params, h, adj, off),
                             warm=1, reps=5)
        b4 = gat_b4_ms(torch, lambda: gat_forward(eng.params, h, adj, cfg))
        b4_ms = sum(r["ms"] for r in b4)
        emit("gat", graph=spec["graph"], nodes=n, dims=list(dims),
             edges_with_self_loops=int(ds.s.nnz),
             adjacency_gb=nbytes(adj) / 1e9,
             setup_seconds=setup_s,
             launches_per_forward=dict(
                 guarded=counts["matmul_abft"],
                 unguarded=ref_counts["matmul_abft"]),
             logits=dict(max_abs_err_vs_f64=err, gate_ratio=ratio,
                         tolerance=dict(atol=LOGIT_ATOL, rtol=LM_LOGIT_RTOL),
                         finite_and_shaped=finite),
             clean=dict(bitwise_identical=identical, flags=0,
                        max_rel=max_rel),
             upsets=upsets, weight_flip=flip,
             forward_ms=fwd_ms, unguarded_forward_ms=fwd_off_ms,
             b4=b4, b4_ms=b4_ms, b4_share=b4_ms / fwd_ms,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             guard=eng.stats())
        if ratio > 1.0 or not finite:
            raise AssertionError(f"{tag}: logits vs float64 {err:.3e} "
                                 f"(ratio {ratio:.3f}), finite/shape "
                                 f"{finite}")
        del adj, h, params, eng, out, ref, again
        gc.collect()            # the engine and its guard form a cycle
        torch.cuda.empty_cache()
    return {"matmul_abft": served}


def decode_trace(torch, step):
    """One decode step under ``torch.profiler``: the device time of its CUDA
    kernels, summed, against the step's host-clock time (the profiler's own
    cost included), and the kernels that take the most.  Reports the
    profiler's error instead where it cannot trace the card."""
    try:
        from torch.profiler import ProfilerActivity, profile
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) is not None
                   and "CUDA" in str(e.device_type)]

        def dev_us(e):
            return float(getattr(e, "self_device_time_total", None)
                         or getattr(e, "self_cuda_time_total", 0.0))
        busy_ms = sum(dev_us(e) for e in kernels) / 1e3
        top = sorted(kernels, key=dev_us, reverse=True)[:10]
        return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                    kernels=len(kernels), launches=sum(e.count
                                                       for e in kernels),
                    top=[dict(name=e.key[:80], count=e.count,
                              ms=dev_us(e) / 1e3) for e in top])
    except Exception as exc:  # the tracer may not reach this card
        return dict(error=f"{type(exc).__name__}: {exc}")


def _slice_tree(tree, n):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, n) for k, v in tree.items()}
    return tree[:n]


def _tree_to(tree, dev, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev, dtype) for v in tree]
    return tree.to(dev, dtype or tree.dtype)


def coverage_trace(torch, rows, launches, name, fn, args, *, carry=(),
                   guarded=True, want=None, grans=None):
    """Trace ``fn(*args)`` under check tagging on the card
    (``analysis.coverage.trace``) and hold the proof's gates: no plain
    call; the kernel site nodes equal the launches of the trace kernel by
    kernel (and ``want``, a derived count, where given); a guarded step
    has 0 unchecked sites (an unguarded one, ``guarded=False``, no checked
    site and no sink; ``None`` leaves it to the caller) and sinks of
    granularities ``grans``; the traced run's outputs equal an untagged
    run's bit for bit.  Appends the trace's row (seconds, nodes, sites,
    sinks, peak GB) to ``rows``, its launches to ``launches``; returns the
    manifest."""
    from repro_torch.analysis.coverage import (analyze_graph, format_report,
                                               kernel_site_counts, trace)
    from repro_torch.kernels import runtime

    clean = [t for t in _leaves(fn(*args)) if isinstance(t, torch.Tensor)]
    outs = []

    def captured(*a):
        out = fn(*a)
        outs.append(out)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counts()
    t0 = time.perf_counter()
    gm = trace(captured, *args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in runtime.launch_counts().items() if v}
    plain = {k: v for k, v in runtime.plain_counts().items() if v}
    m = analyze_graph(gm, step=name, carry=carry)
    nodes = len(gm.graph.nodes)
    del gm
    sites = kernel_site_counts(m)
    tagged = [t for t in _leaves(outs) if isinstance(t, torch.Tensor)]
    rows.append(dict(
        step=name, seconds=seconds, nodes=nodes,
        sites=m.n_checked + m.n_unchecked, kernel_sites=sites,
        launches=counts, n_checked=m.n_checked, n_unchecked=m.n_unchecked,
        n_sinks=m.n_sinks, sink_granularities=list(m.sink_granularities),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9))
    del outs
    problems = []
    if plain:
        problems.append(f"plain calls {plain}")
    if sites != counts or (want is not None and sites != want):
        problems.append(f"kernel sites {sites}, launches {counts}, "
                        f"derived {want}")
    if guarded and (m.n_unchecked or not m.n_checked):
        problems.append(format_report(m))
    if guarded is False and (m.n_checked or not m.n_unchecked or m.n_sinks):
        problems.append(f"unguarded: {m.n_checked} checked, "
                        f"{m.n_unchecked} unchecked, {m.n_sinks} sinks")
    if grans is not None and m.sink_granularities != grans:
        problems.append(f"sinks {m.sink_granularities}, want {grans}")
    if len(clean) != len(tagged) or not all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(clean, tagged)):
        problems.append("tagged outputs differ from the untagged run's")
    if problems:
        emit("coverage", rows=rows)
        raise AssertionError(f"coverage {name}: " + "; ".join(problems))
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    return m


def _site_keys(m):
    return [(s.kind, s.name, s.out_shape, s.granularities, s.provenance,
             s.checked) for s in m.checked_ops + m.unchecked_ops]


def phase_coverage(torch):
    """The ABFT coverage proof on the card (``COVERAGE``): each step traced
    under check tagging with its kernels launching, every matmul-shaped
    node and kernel site walked back from the check sinks
    (:func:`coverage_trace`'s gates); gemma-2b's cut traced on the card
    and on the CPU, the same sites in the same order; the CLI as
    processes, exit 0 guarded and 1 with ``--mode none``.  Returns the
    kernel launches of the traces."""
    import dataclasses

    from repro_torch.analysis.coverage import analyze_step
    from repro_torch.analysis.lint import lm_step
    from repro_torch.core.abft import ABFTConfig, summarize
    from repro_torch.core.datasets import make_dataset
    from repro_torch.core.gcn import gcn_loss
    from repro_torch.engine import Graph, fold_w_r, gcn_forward
    from repro_torch.engine.gat import (fold_gat_w_r, init_gat,
                                        make_gat_serve_step)
    from repro_torch.engine.lm import fold_lm_w_r
    from repro_torch.engine.streaming import (make_packed_serve_step,
                                              packed_step_args)
    from repro_torch.models.transformer import init_model

    t_phase = time.perf_counter()
    cfg = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    rows, launches = [], {}

    # (a) GCN at Cora's widths: the first served batch, every tier
    _stream, batches = make_stream_batches(SERVE["block"])
    pb = batches[0]
    del batches
    params = make_params(torch)
    n_layers = len(params["layers"])
    folded = fold_w_r(params, cfg)
    args = packed_step_args(pb, "cuda")
    for gran, opts, kernel, per, sinks in (
            ("graph", {}, "spmm_abft", n_layers, "graph"),
            ("stripe", {}, "spmm_abft", n_layers, "stripe"),
            ("slot", {}, "spmm_abft", n_layers, "stripe"),
            ("graph", {"fused_layer": True}, "gcn_fused", n_layers, "graph"),
            ("slot", {"fused_network": True}, "gcn_network", 1, "slot")):
        step = make_packed_serve_step(folded, cfg, pb.n_slots,
                                      granularity=gran, **opts)
        tier = "".join(f" --{k.replace('_', '-')}" for k in opts)
        coverage_trace(torch, rows, launches, f"gcn-serve/{gran}{tier}",
                       step, args, want={kernel: per}, grans=(sinks,))
    off = ABFTConfig(mode="none")
    coverage_trace(torch, rows, launches, "gcn-serve/graph --mode none",
                   make_packed_serve_step(fold_w_r(params, off), off,
                                          pb.n_slots), args,
                   guarded=False, want={"spmm_abft": n_layers})
    del args, folded

    ds = make_dataset("cora")
    h0 = torch.from_numpy(ds.features.todense()).cuda()
    s_dense = torch.from_numpy(ds.s.todense()).cuda()
    for backend, s in (("dense", s_dense),
                       ("bcoo", ds.s.to_sparse(device="cuda"))):
        def fwd(h0, s=s, backend=backend):
            logits, checks = gcn_forward(params, Graph(s=s, h0=h0), cfg,
                                         backend=backend, device="cuda")
            rep = summarize(checks, cfg, device="cuda")
            return logits, rep.flag, rep.max_rel

        coverage_trace(torch, rows, launches, f"gcn-forward/{backend}", fwd,
                       (h0,), want={}, grans=("layer",))
    labels = torch.arange(h0.shape[0], device="cuda") % DIMS[-1]

    def train(h0, *ws):
        ws = [w.detach().requires_grad_() for w in ws]
        loss, rep = gcn_loss({"layers": [{"w": w} for w in ws]}, s_dense,
                             h0, labels, None, cfg, device="cuda")
        grads = torch.autograd.grad(loss, ws)
        return loss, rep.flag, [w - 1e-2 * g for w, g in zip(ws, grads)]

    m = coverage_trace(torch, rows, launches, "gcn-train", train,
                       (h0, *[lay["w"] for lay in params["layers"]]),
                       guarded=None, want={}, grans=("layer",))
    # the backward's products, and only they, are unchecked: each one
    # attributed to train's torch.autograd.grad line
    back = {x.provenance for x in m.unchecked_ops}
    if m.n_unchecked != COVERAGE["backward"] or len(back) != 1 or \
            not next(iter(back)).endswith("(train)") or not all(
                x.provenance.startswith("src/repro_torch/")
                for x in m.checked_ops):
        raise AssertionError(f"coverage gcn-train: {m.n_checked} checked, "
                             f"{m.n_unchecked} unchecked at {sorted(back)}")
    backward = dict(unchecked=m.n_unchecked, provenance=sorted(back),
                    shapes=[list(x.out_shape) for x in m.unchecked_ops])
    del s_dense, h0, params, ds

    # (e) GAT on full Cora (phase_gat's adjacency and weights)
    ds = make_dataset("cora", normalize=False)
    n, dims = ds.stats.nodes, GAT[0]["dims"]
    adj = torch.zeros((n, n), dtype=torch.float32, device="cuda")
    adj[torch.from_numpy(ds.s.row).cuda(),
        torch.from_numpy(ds.s.col).cuda()] = 1.0
    h = torch.from_numpy(ds.features.todense()).cuda()
    gat = fold_gat_w_r(init_gat(torch.Generator().manual_seed(GAT_SEED),
                                dims, device="cuda"), cfg)
    serve = make_gat_serve_step(cfg)
    coverage_trace(torch, rows, launches, "gat-serve",
                   lambda p, x, a: serve(p, x, a, -1, 0.0), (gat, h, adj),
                   want={"matmul_abft": 2 * (len(dims) - 1)},
                   grans=("layer",))
    del ds, adj, h, gat
    gc.collect()
    torch.cuda.empty_cache()

    # (b)-(d) the LMs: gemma-2b whole, whisper-medium whole, the others at
    # their cut; prefill and one decode step each
    abft = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    models = [(lm_config(), dict(batch=LM["batch"], prompt=LM["prompt"],
                                 cache=LM["prompt"] + LM["new"]))]
    for spec in ARCHS:
        whole = spec["arch"] == "whisper-medium"
        c = arch_config(spec["arch"], None if whole else
                        spec.get("cut_layers", LM["cut_layers"]))
        prompt = spec["prompt"] if whole else LM["cut_prompt"]
        models.append((c, dict(batch=spec["batch"], prompt=prompt,
                               cache=prompt + spec["new"],
                               src=spec.get("src"))))
    for c, size in models:
        lm_params = fold_lm_w_r(init_model(c, LM["seed"], device="cuda"),
                                c, abft)
        for step in ("lm-prefill", "lm-decode"):
            fn, ops, carry = lm_step(c, abft, step, "cuda",
                                     params=lm_params, **size)
            want = {k: v for k, v in lm_step_launches(
                c, step[3:]).items() if v}
            coverage_trace(torch, rows, launches,
                           f"{step}/{c.name}/{c.n_layers}", fn, ops,
                           carry=carry, want=want, grans=("layer",))
            del fn, ops
        del lm_params
        gc.collect()
        torch.cuda.empty_cache()

    # gemma-2b's cut, traced on the card and on the CPU: one manifest
    cut_cfg = dataclasses.replace(lm_config(), n_layers=LM["cut_layers"])
    host = init_model(cut_cfg, LM["seed"], device="cpu")
    size = dict(batch=LM["batch"], prompt=LM["cut_prompt"],
                cache=LM["cut_prompt"] + LM["cut_decode"])
    cut = {}
    for step in ("lm-prefill", "lm-decode"):
        sides = {}
        for dev in ("cuda", "cpu"):
            p = fold_lm_w_r(_tree_to(host, dev), cut_cfg, abft)
            fn, ops, carry = lm_step(cut_cfg, abft, step, dev, params=p,
                                     **size)
            t0 = time.perf_counter()
            sides[dev] = analyze_step(fn, *ops, step=step, carry=carry)
            sides[dev + "_seconds"] = time.perf_counter() - t0
            del p, fn, ops
        a, b = sides["cuda"], sides["cpu"]
        same = _site_keys(a) == _site_keys(b) and \
            (a.n_sinks, a.sink_granularities) == \
            (b.n_sinks, b.sink_granularities)
        cut[step] = dict(sites=len(_site_keys(a)), sinks=a.n_sinks,
                         same=same, card_seconds=sides["cuda_seconds"],
                         cpu_seconds=sides["cpu_seconds"])
        if not same:
            emit("coverage", rows=rows, cut=cut)
            raise AssertionError(f"coverage: gemma-2b cut {step}: the "
                                 f"card's manifest differs from the CPU's")
    del host
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI as processes, on the card (the smoke twin of gemma-2b)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    # both processes at once: each spends most of its time starting
    cli, procs = [], []
    t0 = time.perf_counter()
    for extra, want_rc in (([], 0), (["--mode", "none"], 1)):
        argv = [sys.executable, "-m", "repro_torch.analysis.lint",
                "--step", "lm-decode", "--arch", "gemma-2b", *extra]
        procs.append((argv, want_rc, subprocess.Popen(
            argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    try:
        for argv, want_rc, proc in procs:
            out, _ = proc.communicate(timeout=600)
            lines = out.strip().splitlines()
            cli.append(dict(argv=argv[3:], returncode=proc.returncode,
                            seconds=time.perf_counter() - t0,
                            output=lines[-1:]))
            if proc.returncode != want_rc:
                emit("coverage", rows=rows, cut=cut, cli=cli,
                     log=lines[-20:])
                raise AssertionError(f"abftlint {' '.join(argv[3:])}: exit "
                                     f"{proc.returncode}, want {want_rc}")
    finally:
        for _argv, _rc, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit("coverage", rows=rows, cut=cut, cli=cli, backward=backward,
         seconds=time.perf_counter() - t_phase)
    return launches


CHILDREN = []


def _stop_children() -> None:
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_dryrun(torch) -> dict:
    """The dry run's CLI (``python -m repro_torch.launch.dryrun``) as two
    processes, started now so that they trace beside the card's phases:
    gemma-2b at every shape on both production meshes, and decode_32k on
    the (16, 16) mesh for every other model.  Their shards are ``meta``
    tensors over a fake process group: CPU work, nothing on the card."""
    import atexit

    from repro_torch.configs import list_archs

    out = os.path.join(ROOT, "build", "dryrun")
    shutil.rmtree(out, ignore_errors=True)         # only this run's cells
    os.makedirs(out)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    others = [a for a in list_archs() if a != LM["arch"]]
    runs = []
    for tag, args in (("gemma", ["--arch", LM["arch"], "--shape", "all",
                                 "--mesh", "both"]),
                      ("others", ["--arch", ",".join(others), "--shape",
                                  "decode_32k", "--mesh", "pod1"])):
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                "--out", out, "--force"]
        log = open(os.path.join(out, f"{tag}.log"), "w")
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT, text=True)
        CHILDREN.append(proc)
        runs.append(dict(tag=tag, argv=argv[3:], proc=proc, log=log.name,
                         t0=time.perf_counter()))
    atexit.register(_stop_children)
    return dict(out=out, runs=runs, others=others)


def _dryrun_cells(dry) -> dict:
    """Wait for the dry-run processes; each one's exit code and seconds and
    every cell's record as its file holds it."""
    procs, cells = [], []
    for run in dry["runs"]:
        try:
            rc = run["proc"].wait(timeout=MESH["dry_wait"])
        except subprocess.TimeoutExpired:
            _stop_children()
            raise AssertionError(f"mesh: the dry run {run['tag']} did not "
                                 f"end within {MESH['dry_wait']} s")
        with open(run["log"]) as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith(("OK ", "SKIP", "ERROR", "done:"))]
        procs.append(dict(argv=run["argv"], returncode=rc,
                          seconds=time.perf_counter() - run["t0"],
                          lines=lines))
    for name in sorted(os.listdir(dry["out"])):
        if name.endswith(".json"):
            with open(os.path.join(dry["out"], name)) as f:
                rec = json.load(f)
            cell = {k: rec[k] for k in ("arch", "shape", "mesh", "status")}
            if rec["status"] == "ok":
                cell.update(
                    trace_s=rec["trace_s"],
                    flops_per_device=rec["flops_per_device"],
                    bytes_per_device=rec["bytes_per_device"],
                    peak_gib=rec["memory"]["peak_bytes"] / 2 ** 30,
                    argument_gib=rec["memory"]["argument_bytes"] / 2 ** 30,
                    collective_mib=rec["collectives"][
                        "per_device_bytes_unweighted"] / 2 ** 20,
                    collectives=rec["collectives"]["by_kind"],
                    n_devices=rec["n_devices"])
            else:
                cell.update(reason=rec.get("reason") or rec.get("error"))
            cells.append(cell)
    return dict(processes=procs, cells=cells)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _whole(torch, x):
    """A DTensor gathered (a LocalTensor's ranks must agree: rank 0's)."""
    from torch.distributed._local_tensor import LocalTensor
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, LocalTensor):
        vals = list(x._local_tensors.values())
        for v in vals[1:]:
            if not torch.equal(v, vals[0]):
                raise AssertionError("mesh: ranks disagree on a replica")
        x = vals[0]
    return x


def _nbytes(torch, tree):
    from repro_torch.optim import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _cost_vs_card(torch, name, fn, args, real_args):
    """The cost model (``launch.costs``) of ``fn(*args)`` on the card
    against the same run: its FLOPs against ``FlopCounterMode``'s, its
    argument bytes against the real inputs', its peak beside
    ``max_memory_allocated`` over the inputs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.costs import step_cost_analysis

    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    del out
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cost = step_cost_analysis(fn, *args)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - base
    real_args = _nbytes(torch, real_args)
    mem = cost["memory"]
    entry = dict(step=name, flops=cost["flops"],
                 flop_counter=counter.get_total_flops(),
                 argument_bytes=mem["argument_bytes"],
                 real_argument_bytes=real_args,
                 peak_bytes=mem["peak_bytes"],
                 card_peak_bytes=real_args + step_peak,
                 peak_ratio=mem["peak_bytes"] / (real_args + step_peak),
                 bytes_accessed=cost["bytes accessed"],
                 trace_s=cost["trace_s"])
    if entry["flops"] != entry["flop_counter"] or \
            entry["argument_bytes"] != real_args:
        raise AssertionError(f"mesh: the cost model of {name} disagrees "
                             f"with the card's run: {entry}")
    return entry


def phase_mesh(torch, smi, dry):
    """The LM mesh (``launch/mesh.py``) on DTensor: (b) gemma-2b at full
    width, all 18 layers, f32, served at lm_serve's cell (B 2, prompt 512)
    through ``make_prefill_step``/``make_decode_step`` on a real one-rank
    (1, 1) mesh with params and state as DTensors placed by
    ``ShardingRules`` — prefill and ``MESH['decode']`` greedy steps bit for
    bit the unsharded run's, 0 flags, B4/B5 launches equal to it, 0 plain
    calls; (d) the cost model held against the card at those shapes; (c)
    the 2-layer full-width cut on a (2, 4) mesh of local ranks (each rank a
    CUDA shard in this process) for one train step and one prefill, within
    the LM gate of the unsharded card run, 0 flags, 8 launches of each
    unsharded one; (a) the dry run's processes (started before the GCN
    phases): both exit 0, each cell's trace seconds, FLOPs a device, peak
    GiB and collective MiB.  Returns the launches of (b) and (c)'s sharded
    runs."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.core.abft import ABFTConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import runtime
    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import (ShardingRules, distribute_tree,
                                         make_test_mesh)
    from repro_torch.launch.steps import (init_train_state,
                                          make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import AdamWConfig

    t_phase = time.perf_counter()
    abft = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def plain_calls():
        return sum(runtime.plain_counts().values())

    # (b) one rank, full width: sharded serving bit for bit the unsharded
    cfg = lm_config()
    cache_len = LM["prompt"] + MESH["decode"]
    prefill = make_prefill_step(cfg, abft, cache_len=cache_len)
    decode = make_decode_step(cfg, abft)
    params = init_model(cfg, LM["seed"], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(LM["seed"])
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (LM["batch"], LM["prompt"]),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}

    def serve(p, b, place_state=None):
        logits, states, m = prefill(p, b)
        if place_state is not None:
            states = place_state(states)
        out, flags = [logits], [m["abft_flag"]]
        for i in range(MESH["decode"]):
            logits, states, m = decode(p, states,
                                       _argmax_tokens(torch, logits),
                                       LM["prompt"] + i)
            out.append(logits)
            flags.append(m["abft_flag"])
        torch.cuda.synchronize()
        return out, sum(int(_whole(torch, f)) for f in flags)

    runtime.reset_counts()
    t0 = time.perf_counter()
    want_logits, want_flags = serve(params, batch)
    plain_run = dict(seconds=time.perf_counter() - t0, flags=want_flags,
                     launches={k: v for k, v in runtime.launch_counts()
                               .items() if v}, plain_calls=plain_calls())
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), device="cuda")
        rules = ShardingRules(mesh)
        dparams = distribute_tree(params, rules.params_shardings(params))
        dbatch = distribute_tree(batch, rules.batch_shardings(batch))

        def place_state(states):
            return distribute_tree(states, rules.state_shardings(
                states, LM["batch"], cfg.n_kv_heads))
        runtime.reset_counts()
        t0 = time.perf_counter()
        got, got_flags = serve(dparams, dbatch, place_state)
        sharded = dict(seconds=time.perf_counter() - t0, flags=got_flags,
                       launches={k: v for k, v in runtime.launch_counts()
                                 .items() if v}, plain_calls=plain_calls())
        add(sharded["launches"])
        bitwise = [bool(torch.equal(_whole(torch, g), w))
                   for g, w in zip(got, want_logits)]
        one_rank = dict(cell=dict(batch=LM["batch"], prompt=LM["prompt"],
                                  decode=MESH["decode"], layers=cfg.n_layers),
                        unsharded=plain_run, sharded=sharded,
                        bitwise=bitwise)
        if not all(bitwise) or got_flags or want_flags or \
                sharded["launches"] != plain_run["launches"] or \
                sharded["plain_calls"] or plain_run["plain_calls"]:
            emit("mesh", one_rank=one_rank)
            raise AssertionError("mesh: the one-rank sharded serve is not "
                                 "the unsharded run")
        del got, want_logits

        # (d) the cost model against the card, at (b)'s shapes
        _, dstates, _ = prefill(dparams, dbatch)
        dstates = place_state(dstates)
        tok = distribute_tree(batch["tokens"][:, -1:],
                              rules.batch_shardings(batch["tokens"]))
        costs = [_cost_vs_card(torch, "prefill", prefill, (dparams, dbatch),
                               (params, batch)),
                 _cost_vs_card(torch, "decode",
                               lambda p, s, t: decode(p, s, t, LM["prompt"]),
                               (dparams, dstates, tok),
                               (params, dstates, tok))]
        del dparams, dbatch, dstates, tok
    finally:
        dist.destroy_process_group()
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the 2-layer cut on a (2, 4) mesh of local ranks
    from torch.distributed._local_tensor import (
        LocalTensorMode, maybe_disable_local_tensor_mode)
    cut = dataclasses.replace(cfg, n_layers=TRAIN["cut_layers"])
    world = math.prod(MESH["local"])
    sched = dict(total_steps=TRAIN["total"], warmup=TRAIN["warmup"])
    step = make_train_step(cut, abft, AdamWConfig(), **sched)
    cut_prefill = make_prefill_step(cut, abft, cache_len=TRAIN["cut_seq"])
    state = init_train_state(cut, TRAIN["seed"], device="cuda")
    tb = next(SyntheticLM(cut.vocab_size, TRAIN["cut_seq"], TRAIN["batch"],
                          seed=TRAIN["seed"]).batches())
    tb = {k: torch.from_numpy(v).to("cuda") for k, v in tb.items()}
    pb = {"tokens": tb["tokens"]}
    runtime.reset_counts()
    _, m = step(state, tb)
    unsharded = dict(loss=float(m["loss"]), flag=bool(m["abft_flag"]),
                     train_launches={k: v for k, v in runtime.launch_counts()
                                     .items() if v})
    runtime.reset_counts()
    logits, _, m = cut_prefill(state["params"], pb)
    unsharded.update(prefill_flag=bool(m["abft_flag"]),
                     prefill_launches={k: v for k, v in
                                       runtime.launch_counts().items() if v})
    per_step = lm_step_launches(cut)
    derived_train = {k: world * (3 * n if k.startswith("matmul") else n)
                     for k, n in per_step.items() if n}
    derived_prefill = {k: world * n for k, n in per_step.items() if n}
    with fake_process_group(world), LocalTensorMode(frozenset(range(world))):
        lmesh = make_test_mesh(MESH["local"], ("data", "model"),
                               device="cuda")
        rules = ShardingRules(lmesh)
        ps = rules.params_shardings(state["params"])
        sstate = {"params": distribute_tree(state["params"], ps),
                  "opt": {"m": distribute_tree(state["opt"]["m"], ps),
                          "v": distribute_tree(state["opt"]["v"], ps),
                          "step": distribute_tree(state["opt"]["step"],
                                                  rules.replicated())}}
        stb = distribute_tree(tb, rules.batch_shardings(tb))
        runtime.reset_counts()
        t0 = time.perf_counter()
        _, sm = step(sstate, stb)
        torch.cuda.synchronize()
        local = dict(train_seconds=time.perf_counter() - t0,
                     loss=float(_whole(torch, sm["loss"])),
                     flag=bool(_whole(torch, sm["abft_flag"])),
                     train_launches={k: v for k, v in
                                     runtime.launch_counts().items() if v},
                     train_plain_calls=plain_calls())
        del sm
        runtime.reset_counts()
        t0 = time.perf_counter()
        slogits, _, sm = cut_prefill(sstate["params"], {
            "tokens": stb["tokens"]})
        torch.cuda.synchronize()
        local.update(prefill_seconds=time.perf_counter() - t0,
                     prefill_flag=bool(_whole(torch, sm["abft_flag"])),
                     prefill_launches={k: v for k, v in
                                       runtime.launch_counts().items() if v},
                     prefill_plain_calls=plain_calls())
        got = _whole(torch, slogits)
        with maybe_disable_local_tensor_mode():
            gap = (got - logits).abs()
            logit_err = float(gap.max())
            logits_ok = bool((gap <= 1e-4 + 1e-6 * logits.abs()).all())
        add(local["train_launches"])
        add(local["prefill_launches"])
        del sstate, stb, slogits, sm, got
    loss_gap = abs(local["loss"] - unsharded["loss"])
    local_rank = dict(mesh=MESH["local"], layers=cut.n_layers,
                      batch=TRAIN["batch"], seq=TRAIN["cut_seq"],
                      unsharded=unsharded, sharded=local,
                      loss_gap=loss_gap,
                      loss_gate=1e-4 + 1e-6 * abs(unsharded["loss"]),
                      logit_max_abs_err=logit_err, logits_in_gate=logits_ok,
                      derived_train=derived_train,
                      derived_prefill=derived_prefill)
    del state, logits
    gc.collect()
    torch.cuda.empty_cache()
    if loss_gap > local_rank["loss_gate"] or local["flag"] or \
            local["prefill_flag"] or unsharded["flag"] or \
            local["train_launches"] != derived_train or \
            local["prefill_launches"] != derived_prefill or \
            local["train_plain_calls"] or local["prefill_plain_calls"] or \
            not logits_ok:
        emit("mesh", one_rank=one_rank, costs=costs, local_rank=local_rank)
        raise AssertionError("mesh: the (2, 4) local-rank cut is off the "
                             "unsharded card run")

    # (a) the dry run's processes
    dryrun = _dryrun_cells(dry)
    oks = [c for c in dryrun["cells"] if c["status"] == "ok"]
    skips = [c for c in dryrun["cells"] if c["status"] == "skipped"]
    gemma_ok = [c for c in oks if c["arch"] == LM["arch"]]
    emit("mesh", nvidia_smi=smi, one_rank=one_rank, costs=costs,
         local_rank=local_rank, dryrun=dryrun,
         seconds=time.perf_counter() - t_phase)
    if any(p["returncode"] for p in dryrun["processes"]) or \
            len(gemma_ok) != 6 or len(skips) != 2 or \
            len(oks) != 6 + len(dry["others"]):
        raise AssertionError(f"mesh: the dry run gave {len(oks)} ok and "
                             f"{len(skips)} skipped cells, exit codes "
                             f"{[p['returncode'] for p in dryrun['processes']]}")
    return launches


def run_only(torch, smi, names, archs=None) -> int:
    """The phases ``names`` alone, after the build (``lm_archs`` over the
    models ``archs`` when given); prints each phase's line and no final
    one."""
    global ARCHS
    if archs:
        ARCHS = tuple(s for s in ARCHS if s["arch"] in archs)
    phases = dict(lm_kernels=lambda: phase_lm_kernels(torch),
                  lm_grads=lambda: phase_lm_grads(torch),
                  lm_serve=lambda: phase_lm_serve(torch, smi),
                  lm_archs=lambda: phase_lm_archs(torch, smi),
                  lm_train=lambda: phase_lm_train(torch, smi),
                  train_driver=lambda: phase_train_driver(torch, smi),
                  serve_cli=lambda: phase_serve_cli(torch),
                  examples=lambda: phase_examples(torch),
                  sparse=lambda: phase_sparse(torch),
                  sharded=lambda: phase_sharded(torch),
                  gat=lambda: phase_gat(torch),
                  coverage=lambda: phase_coverage(torch),
                  mesh=lambda: phase_mesh(torch, smi, start_dryrun(torch)))
    unknown = [n for n in names if n not in phases]
    if unknown:
        raise SystemExit(f"chip_smoke: --only takes {sorted(phases)}, not "
                         f"{unknown}")
    for name in names:
        phases[name]()
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2

    # --stop-after build|kernels cuts the run short (a first look at a new
    # kernel); --only runs the build and the phases named (the LM phases,
    # train_driver, serve_cli, examples, coverage), --archs cuts lm_archs
    # to the models named: a first look at a changed phase.  Such runs
    # print no final "ok" line
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--stop-after", choices=("build", "kernels"))
    ap.add_argument("--only", type=lambda s: s.split(","))
    ap.add_argument("--archs", type=lambda s: s.split(","))
    args = ap.parse_args()
    stop_after = args.stop_after
    t0 = time.perf_counter()
    smi = phase_env(torch)
    phase_build()
    if stop_after == "build":
        return 0
    if args.only:
        return run_only(torch, smi, args.only, args.archs)
    _stream, batches = make_stream_batches(SERVE["block"])
    params = make_params(torch)
    entries = phase_kernels(torch, batches, params)
    entries.update(phase_lm_kernels(torch))
    phase_lm_grads(torch)
    if stop_after == "kernels":
        return 0
    dry = start_dryrun(torch)         # CPU processes beside the card's phases
    launches = phase_serve(torch, batches, params)
    phase_fault(torch, batches, params)
    phase_stream(torch, params, smi)
    phase_full_graph(torch, params)
    phase_campaign_gcn(torch)
    del batches, params
    for phase in (phase_sparse, phase_sharded, phase_gat, phase_coverage):
        for name, count in phase(torch).items():
            launches[name] = launches.get(name, 0) + count
    for phase in (phase_lm_serve, phase_lm_archs, phase_lm_train,
                  phase_train_driver):
        for name, count in phase(torch, smi).items():
            launches[name] = launches.get(name, 0) + count
    phase_serve_cli(torch)
    for name, count in phase_examples(torch).items():
        launches[name] = launches.get(name, 0) + count
    for name, count in phase_mesh(torch, smi, dry).items():
        launches[name] = launches.get(name, 0) + count

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, entry in entries.items():
        entry["launches"] = launches[name]
        if entry["launches"] <= 0:
            raise AssertionError(f"{name}: no launch on the main path")
        kernels.append({k: entry[k] for k in keys})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
