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
kernels — through the entry points a user would call.  Any phase that fails
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

One JSON object per phase is printed (``env``, ``build``, ``kernel_checks``,
``lm_kernels``, ``serve``, ``fault``, ``stream``, ``full_graph``,
``campaign_gcn``, ``sparse``, ``sharded``, ``lm_serve``, ``campaign_lm``),
then the ``kernels``
summary line, the card's name and power limit as ``nvidia-smi`` gives them,
and a last line ``{"ok": true, "device": {...}}``.

Bounds use the published peaks of an H100 SXM: 3.35 TB/s of device memory,
67 TFLOP/s in float32 outside the tensor cores, 989 TFLOP/s in bfloat16.
"""
from __future__ import annotations

import json
import os
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


def lm_matmul_shapes(cfg):
    """Every (M, K, N, trans_b) the LM run launches matmul_abft at, with its
    launches per prefill and per decode step."""
    d, hq = cfg.d_model, cfg.n_heads * cfg.hd
    hkv, ff, n = cfg.n_kv_heads * cfg.hd, cfg.d_ff, cfg.n_layers
    per_layer = [(d, hq), (d, hkv), (d, hkv), (hq, d), (d, ff), (d, ff),
                 (ff, d)]
    shapes = {}
    for m, step in ((LM["batch"] * LM["prompt"], "prefill"),
                    (LM["batch"], "decode")):
        for k, nn in per_layer:
            shapes.setdefault((m, k, nn, False), {"prefill": 0, "decode": 0})
            shapes[(m, k, nn, False)][step] += n
    # the tied head: the last position of each sequence, both steps
    head = (LM["batch"], d, cfg.padded_vocab, True)
    shapes[head] = {"prefill": 1, "decode": 1}
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


def check_matmul_shape(torch, m, k, n, trans_b, dtype, gen, timed):
    """matmul_abft kernel vs plain at one launch shape (with and without the
    extra column), a second run bit for bit the first, the clean corner, a
    corrupted output that must diverge; optionally its times.  Operands
    scaled as the LM's: activations ~1, weights ~1/sqrt(K) (the head's
    table ~1)."""
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
        worst = max(worst, assert_close(f"{tag} block_sums", got[1], want[1],
                                        atol=OUT_ATOL, rtol=OUT_RTOL))
        if with_br:
            worst = max(worst, assert_close(f"{tag} extra", got[2], want[2],
                                            atol=OUT_ATOL, rtol=OUT_RTOL))
            c_checked = got[0]
            again = matmul_abft_kernel(a, b, br, trans_b=trans_b)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{tag}: a second run differs (C, "
                                     f"block_sums or extra)")
        elif got[2] is not None or not torch.equal(got[0], c_checked):
            raise AssertionError(f"{tag}: the unchecked product differs "
                                 f"from the checked one")
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
                 max_abs_err_c=worst_c, max_rel_corner=rel,
                 corrupted_divergence=div)
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


def flash_bound(torch, b, t, s, h, kh, dh, dtype):
    """Least time of one causal launch: q, k, v, vr, o, o_extra once against
    the causal pairs' work (q·k and p·v over dh, p·vr) at the type's peak."""
    item = torch.empty((), dtype=dtype).element_size()
    n_bytes = item * (2 * b * t * h * dh + 2 * b * s * kh * dh + b * s * h) \
        + 4 * b * t * h
    pairs = b * h * sum(min(i + 1, s) for i in range(t))
    n_ops = pairs * (4 * dh + 2)
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_b, t_o = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / peak * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), \
        n_bytes, n_ops


def sdpa_ms(torch, q, k, v, backends):
    """Milliseconds of one causal ``scaled_dot_product_attention`` call on
    the first of ``backends`` (``SDPBackend`` names) that takes the operands
    (q, k, v in its [B, H, T, d] layout), timed as every kernel is — the
    yardstick only; nothing in the port calls it.  Returns (ms, backend) or
    (None, why each backend refused)."""
    import torch.nn.functional as F
    refused = []
    for name in backends:
        try:
            from torch.nn.attention import SDPBackend, sdpa_kernel
            with sdpa_kernel(getattr(SDPBackend, name)):
                F.scaled_dot_product_attention(q, k, v, is_causal=True)
                torch.cuda.synchronize()
                return time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True)), name
        except Exception as exc:  # the backend refuses these operands
            why = str(exc).splitlines()[0][:160] if str(exc) else ""
            refused.append(f"{name}: {type(exc).__name__}: {why}")
    return None, "; ".join(refused)


def sdpa_library_ms(torch, q, k, v, vr):
    """SDPA yardsticks of a ``flash_checksum`` launch: o and o_extra
    together (vr as an extra value column, 257 wide at dh 256) on the
    memory-efficient backend, else the math one; and o alone (v, dh wide)
    on the memory-efficient backend.  Returns a dict of both times and the
    backend that served each (or why none did)."""
    h = q.shape[2]
    g = h // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(g, dim=2)
    vv = torch.cat([vt, vr[..., None]], dim=-1).transpose(1, 2).contiguous()
    ms, backend = sdpa_ms(torch, qt, kt, vv, ("EFFICIENT_ATTENTION", "MATH"))
    o_ms, o_backend = sdpa_ms(torch, qt, kt, vt.transpose(1, 2).contiguous(),
                              ("EFFICIENT_ATTENTION",))
    return dict(library_ms=ms, library_backend=backend,
                library_note="F.scaled_dot_product_attention(q, k, [v | vr], "
                             "is_causal=True)",
                library_o_only_ms=o_ms, library_o_only_backend=o_backend)


def check_flash_shape(torch, b, t, s, h, kh, dh, dtype, gen, timed):
    """flash_checksum kernel vs plain (with and without the column), the
    chain identity Σ o_extra = Σ (o W_o) as a clean corner, a corrupted
    accumulator that must diverge; optionally its times."""
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
    tag = f"flash_checksum B={b} T={t} S={s} H={h} Kh={kh} dh={dh} {dtype}"
    tol = OUT_ATOL if dtype == torch.float32 else BF16_TOL["flash_checksum"]
    got = flash_checksum_kernel(q, k, v, vr)
    torch.cuda.synchronize()
    want = flash_checksum_plain(q, k, v, vr)
    worst = max(assert_close(f"{tag} o", got[0].float(), want[0].float(),
                             atol=tol, rtol=tol),
                assert_close(f"{tag} o_extra", got[1], want[1],
                             atol=max(tol, OUT_ATOL) * 2,
                             rtol=max(tol, OUT_RTOL) * 2))
    o_bare, ex_bare = flash_checksum_kernel(q, k, v, None)
    if ex_bare is not None or not torch.equal(o_bare, got[0]):
        raise AssertionError(f"{tag}: o without the carried column differs")
    again = flash_checksum_kernel(q, k, v, vr)
    if not all(torch.equal(x, y) for x, y in zip(again, got)):
        raise AssertionError(f"{tag}: a second run differs")
    o, ex = got
    wo_t = wo.to(dtype)
    out, _ = matmul_abft(o.reshape(b * t, h * dh), wo_t, with_check=False)
    chk = chain_check(ex, out)
    rel = corner_rel(chk.predicted, chk.actual)
    if not rel <= (CORNER_RTOL if dtype == torch.float32 else 5e-2):
        raise AssertionError(f"{tag}: clean chain divergence {rel:.3e}")
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
    entry = dict(b=b, t=t, s=s, h=h, kh=kh, dh=dh, dtype=str(dtype),
                 max_abs_err=worst, max_rel_corner=rel,
                 corrupted_divergence=div, repeat_bitwise=True)
    if timed:
        bound, by, n_bytes, n_ops = flash_bound(torch, b, t, s, h, kh, dh,
                                                dtype)

        def kern():
            return flash_checksum_kernel(q, k, v, vr)
        # one yardstick with B1's: 10 launches after 2 warm-up ones, 50, and
        # the device's own time from a CUDA graph; and the wrapper's host
        # dispatch, which bounds the eager times from below
        entry.update(
            ms=time_ms(kern), ms_50=time_ms(kern, reps=50),
            device_ms=device_ms(kern), host_dispatch_ms=host_ms(kern),
            plain_ms=time_ms(lambda: flash_checksum_plain(q, k, v, vr),
                             warm=1, reps=2),
            bound_ms=bound, bound_by=by, bytes=n_bytes, flops=n_ops,
            **sdpa_library_ms(torch, q, k, v, vr))
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
    # ragged shapes.  The wide path's: one row past a 128-row block (129)
    # and one short of two (255), K and N not multiples of 4, B and B^T.
    # The thin path's: K not a multiple of 32 or of the split, N (B) or K
    # (B^T) not a multiple of 4 — the scalar tail
    ragged = [check_matmul_shape(torch, m, k, n, tb, dt, gen, False)
              for m, k, n, tb in ((200, 100, 72, False), (17, 33, 65, True),
                                  (129, 70, 130, False), (129, 70, 130, True),
                                  (255, 99, 131, False), (255, 99, 131, True),
                                  (1, 2050, 129, False),
                                  (2, 16384, 64, False),
                                  (16, 2050, 130, False), (1, 33, 65, True),
                                  (2, 100, 72, True))
              for dt in (torch.float32, torch.bfloat16)]
    b, t, h, kh, dh = LM["batch"], LM["prompt"], cfg.n_heads, \
        cfg.n_kv_heads, cfg.hd
    flash_main = check_flash_shape(torch, b, t, t, h, kh, dh, torch.float32,
                                   gen, True)
    flash_other = [check_flash_shape(torch, b, t, t, h, kh, dh,
                                     torch.bfloat16, gen, False)] + [
        check_flash_shape(torch, *shape, dt, gen, False)
        for shape in ((1, 100, 100, 4, 2, 64), (2, 128, 256, 4, 2, 64),
                      (1, 70, 70, 4, 4, 16), (1, 33, 50, 2, 2, 70))
        for dt in (torch.float32, torch.bfloat16)]

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
            shape=dict(b=b, t=t, s=t, h=h, kh=kh, dh=dh))}
    emit("lm_kernels", tolerance=dict(f32=OUT_ATOL, bf16=BF16_TOL,
                                      corner_rtol=CORNER_RTOL),
         matmul_f32=per_shape, matmul_bf16=bf16, matmul_ragged=ragged,
         flash_f32=flash_main, flash_other=flash_other, per_step=per_step,
         prefill_shapes=prefill, thin_ptxas=thin_ptxas,
         wide_ptxas=wide_ptxas, flash_ptxas=flash_ptxas,
         kernels=list(entries.values()))
    spills = {name: v for name, v in flash_ptxas.items()
              if v.get("spill_stores") and "Li256E" in name}
    if spills:
        raise AssertionError(f"flash_checksum spills at dh 256: {spills}")
    return entries


def _argmax_tokens(torch, logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def lm_trajectory(torch, step_prefill, step_decode, tokens, n_new, *,
                  inject_at=None, delta=0.0, timed=False):
    """Prefill then ``n_new`` greedy decode steps; every step's logits and
    token, and (``timed``) host-clock ms around each synchronised step."""
    t0 = tokens.shape[1]
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


def phase_lm_serve(torch, smi):
    """The checked-op main path: LMEngine at gemma-2b's full width, all 18
    layers, f32 — guarded == unguarded bit for bit with no clean flag, an
    accumulator upset on a decode step and a wq bit flip each detected and
    repaired bit for bit, every product on matmul_abft and every prefill
    attention on flash_checksum; then the same params cut to 2 layers on the
    card against the CPU (the plain versions)."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine.lm import LMEngine, fold_lm_w_r
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import (init_model, model_decode,
                                                model_prefill)

    cfg = lm_config()
    abft = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    off = ABFTConfig(mode="none")
    cache_len = LM["prompt"] + LM["new"]
    t_init = time.perf_counter()
    params = init_model(cfg, LM["seed"], device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    eng = LMEngine(cfg, abft, params, cache_len=cache_len)
    gen = torch.Generator(device="cuda").manual_seed(LM["seed"] + 1)
    tokens = torch.randint(1, cfg.vocab_size, (LM["batch"], LM["prompt"]),
                           generator=gen, device="cuda", dtype=torch.int32)
    per_prefill = cfg.n_layers * 7 + 1
    torch.cuda.reset_peak_memory_stats()

    # the bit-identity baseline: unguarded mode="none" on the master params
    runtime.reset_counts()
    ref_logits, ref_tokens, ref_ms = lm_trajectory(
        torch,
        lambda tok, inj: model_prefill(params, cfg, {"tokens": tok}, off,
                                       cache_len)[:2],
        lambda st, tok, pos, inj: model_decode(params, cfg, st, tok, pos,
                                               off)[:2],
        tokens, LM["new"])
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
                                          LM["new"])
    counts, plain = runtime.launch_counts(), runtime.plain_counts()
    want = {"matmul_abft": per_prefill * (LM["new"] + 1),
            "flash_checksum": cfg.n_layers}
    others = {k: v for k, v in counts.items() if k not in want}
    if {k: counts[k] for k in want} != want or any(others.values()) \
            or any(plain.values()) or ref_counts != counts:
        raise AssertionError(f"lm_serve: launches {counts} (want {want}, "
                             f"unguarded {ref_counts}), plain {plain}")
    identical = all(torch.equal(a, b) for a, b in zip(logits, ref_logits)) \
        and all(torch.equal(a, b) for a, b in zip(toks, ref_tokens))
    if not identical or eng.guard.flags:
        raise AssertionError(f"lm_serve: guarded trajectory bit-identical "
                             f"{identical}, clean flags {eng.guard.flags}")
    ids = metrics[0]["abft_op_ids"]
    if len(ids) != 7 * cfg.n_layers + 1 or ids[0] != "op0:L0" \
            or ids[-1] != "op7":
        raise AssertionError(f"lm_serve: op ids {ids[:3]}..{ids[-2:]}")
    max_rel = max(float(m["abft_max_rel"]) for m in metrics)
    if not max_rel <= CORNER_RTOL:
        raise AssertionError(f"lm_serve: clean max_rel {max_rel:.3e}")
    finite = all(bool(torch.isfinite(x[..., :cfg.vocab_size]).all())
                 for x in logits)
    shape_ok = tuple(logits[0].shape) == (LM["batch"], 1, cfg.padded_vocab)
    if not (finite and shape_ok):
        raise AssertionError(f"lm_serve: logits finite {finite}, shape "
                             f"{tuple(logits[0].shape)}")

    # where a guarded decode step's time goes on the device
    _, st0, _ = eng.prefill(tokens)
    trace = decode_trace(torch, lambda: eng.decode(
        st0, toks[0], LM["prompt"], inject=0.0))
    del st0

    # a transient accumulator upset on one decode step: one retry, bit for bit
    flags0, retries0 = eng.guard.flags, eng.guard.retries
    metrics = []
    inj_logits, inj_toks, _ = lm_trajectory(
        torch, g_prefill, g_decode, tokens, LM["new"],
        inject_at=LM["inject_at"], delta=LM["inject_delta"])
    inject = dict(decode_step=LM["inject_at"], delta=LM["inject_delta"],
                  flags=eng.guard.flags - flags0,
                  retries=eng.guard.retries - retries0,
                  bitwise=all(torch.equal(a, b) for a, b in
                              zip(inj_logits, ref_logits)))
    if inject["flags"] != 1 or inject["retries"] != 1 \
            or not inject["bitwise"]:
        raise AssertionError(f"lm_serve: injected upset {inject}")

    # a bit flip in one layer's wq after load: a corrupted clone replaces
    # the working leaf (the master shares the tensor and stays pristine)
    flags0, restores0 = eng.guard.flags, eng.guard.restores
    seg = dict(eng.params["segments"][0])
    b0 = dict(seg["b0"])
    attn = dict(b0["attn"])
    wq = dict(attn["wq"])
    w = wq["w"].clone()
    word = w.view(torch.int32)
    word[LM["flip_layer"], 0, 0, 0] ^= (1 << LM["flip_bit"])
    wq["w"], attn["wq"], b0["attn"], seg["b0"] = w, wq, attn, b0
    eng.params = dict(eng.params, segments=[seg])
    metrics = []
    flip_logits, _, _ = lm_trajectory(torch, g_prefill, g_decode, tokens, 2)
    flip = dict(layer=LM["flip_layer"], bit=LM["flip_bit"],
                flags=eng.guard.flags - flags0,
                restores=eng.guard.restores - restores0,
                bitwise=all(torch.equal(a, b) for a, b in
                            zip(flip_logits, ref_logits)),
                master_pristine=not torch.equal(
                    params["segments"][0]["b0"]["attn"]["wq"]["w"], w))
    if flip["flags"] != 1 or flip["restores"] != 1 or not flip["bitwise"] \
            or not flip["master_pristine"]:
        raise AssertionError(f"lm_serve: weight flip {flip}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the same params cut to 2 layers: the card against the CPU's plain
    # versions, prefill and decode logits within LOGIT_ATOL
    n_cut = LM["cut_layers"]
    import dataclasses
    cut_cfg = dataclasses.replace(cfg, n_layers=n_cut)
    cut = dict(params, segments=[{"b0": {
        key: _slice_tree(val, n_cut)
        for key, val in params["segments"][0]["b0"].items()}}])
    cut_tokens = tokens[:, :LM["cut_prompt"]]
    cut_len = LM["cut_prompt"] + LM["cut_decode"]
    runs = {}
    for dev in ("cuda", "cpu"):
        p_dev = _tree_to(cut, dev)
        folded = fold_lm_w_r(p_dev, cut_cfg, abft)
        t0 = time.perf_counter()
        lg, st, rep = model_prefill(folded, cut_cfg,
                                    {"tokens": cut_tokens.to(dev)}, abft,
                                    cut_len)
        outs, flags = [lg], [bool(rep.flag)]
        for i in range(LM["cut_decode"]):
            nxt = _argmax_tokens(torch, outs[-1])
            lg, st, rep = model_decode(folded, cut_cfg, st, nxt,
                                       LM["cut_prompt"] + i, abft)
            outs.append(lg)
            flags.append(bool(rep.flag))
        runs[dev] = dict(logits=[x.cpu() for x in outs], flags=flags,
                         seconds=time.perf_counter() - t0)
        del p_dev, folded
    pairs = [(a[..., :cfg.vocab_size], b[..., :cfg.vocab_size])
             for a, b in zip(runs["cuda"]["logits"], runs["cpu"]["logits"])]
    cut_errs = [max_err(a, b) for a, b in pairs]
    cut_err = max(cut_errs)
    # max |card - CPU| / (atol + rtol |CPU|): at most 1 passes
    cut_ratio = [float(((a - b).abs() / (LOGIT_ATOL + LM_LOGIT_RTOL
                                          * b.abs())).max()) for a, b in pairs]
    cut_ok = max(cut_ratio) <= 1.0 and not any(runs["cuda"]["flags"]) \
        and not any(runs["cpu"]["flags"])

    prefill_ms, decode_ms = step_ms[0], step_ms[1:]
    emit("lm_serve", nvidia_smi=smi, model=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
         kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, batch=LM["batch"], prompt=LM["prompt"],
         new=LM["new"], cache_len=cache_len, init_seconds=t_init,
         launches=counts, plain_calls=plain,
         launches_per_step=dict(matmul_abft=per_prefill,
                                flash_checksum_per_prefill=cfg.n_layers),
         clean=dict(bitwise_identical=identical, flags=0, max_rel=max_rel,
                    op_ids=len(ids)),
         prefill_ms=prefill_ms, unguarded_prefill_ms=ref_ms[0],
         decode_ms_per_step=sum(decode_ms) / len(decode_ms),
         decode_ms_min_max=[min(decode_ms), max(decode_ms)],
         unguarded_decode_ms_per_step=sum(ref_ms[1:]) / len(ref_ms[1:]),
         decode_trace=trace,
         inject=inject, weight_flip=flip, peak_memory_gb=peak_gb,
         cut=dict(layers=n_cut, prompt=LM["cut_prompt"],
                  decode=LM["cut_decode"], max_abs_err_card_vs_cpu=cut_err,
                  per_step_max_abs_err=cut_errs,
                  per_step_gate_ratio=cut_ratio,
                  max_abs_logit=max(float(b.abs().max()) for _, b in pairs),
                  tolerance=dict(atol=LOGIT_ATOL, rtol=LM_LOGIT_RTOL),
                  card_seconds=runs["cuda"]["seconds"],
                  cpu_seconds=runs["cpu"]["seconds"]),
         guard=eng.stats())
    if not cut_ok:      # reported above first, so the numbers are kept
        raise AssertionError(f"2-layer logits card vs CPU, per step: "
                             f"{cut_errs} (atol {LOGIT_ATOL}, rtol "
                             f"{LM_LOGIT_RTOL}); flags "
                             f"{runs['cuda']['flags']} {runs['cpu']['flags']}")
    # the 18-layer master is freed with this frame: the campaign's LM lane
    # runs on it first
    phase_campaign_lm(torch, cfg, params, cache_len)
    return {k: counts[k] for k in want}


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


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


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
    # kernel); such a run prints no final "ok" line
    stop_after = sys.argv[2] if len(sys.argv) == 3 \
        and sys.argv[1] == "--stop-after" else None
    t0 = time.perf_counter()
    smi = phase_env(torch)
    phase_build()
    if stop_after == "build":
        return 0
    _stream, batches = make_stream_batches(SERVE["block"])
    params = make_params(torch)
    entries = phase_kernels(torch, batches, params)
    entries.update(phase_lm_kernels(torch))
    if stop_after == "kernels":
        return 0
    launches = phase_serve(torch, batches, params)
    phase_fault(torch, batches, params)
    phase_stream(torch, params, smi)
    phase_full_graph(torch, params)
    phase_campaign_gcn(torch)
    del batches, params
    for phase in (phase_sparse, phase_sharded):
        for name, count in phase(torch).items():
            launches[name] += count
    launches.update(phase_lm_serve(torch, smi))

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
