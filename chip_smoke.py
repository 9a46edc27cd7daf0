#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, and drives the
port's main path — guarded packed block-ELL GCN serving — at the published
widths of Cora's 2-layer GCN (1433 -> 16 -> 7), through the entry points a
user would call.  Any phase that fails raises and the run exits non-zero;
without a CUDA device it exits non-zero before printing anything.

One JSON object per phase is printed (``env``, ``build``, ``kernel_checks``,
``serve``, ``fault``, ``full_graph``), then the ``kernels`` summary line, the
card's name and power limit as ``nvidia-smi`` gives them, and a last line
``{"ok": true, "device": {...}}``.

Bounds use the published peaks of an H100 SXM: 3.35 TB/s of device memory
and 67 TFLOP/s in float32 outside the tensor cores.
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

# the main path's configuration: Cora's published model and graph size
DIMS = (1433, 16, 7)
SERVE = dict(n_graphs=16, n_lo=1500, n_hi=2708, avg_deg=4, batch=8,
             block=128, stripe_multiple=4, width_multiple=4, seed=0)
OUT_ATOL = OUT_RTOL = 1e-4       # kernel vs plain version, every output
CORNER_RTOL = 1e-4               # clean |pred - actual| / max(1, |actual|)
LOGIT_ATOL = 1e-4                # vs the float64 dense forward
REPAIR_ATOL = 1e-5               # repaired vs clean logits


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
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, cuda_available=torch.cuda.is_available(),
         triton_installed=importlib.util.find_spec("triton") is not None,
         nvcc=" | ".join(nvcc), nvidia_smi=smi,
         device=torch.cuda.get_device_name(0),
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import runtime
    t0 = time.perf_counter()
    runtime.load_library(verbose=True)
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=round(runtime.last_build_seconds, 3),
         library=str(runtime.build_root()),
         sources=[str(p.relative_to(ROOT)) for p in runtime.source_paths()])


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


def bsr_library_ms(torch, cols, vals, xx):
    """Time one ``torch.sparse`` BSR product of the same tiles against
    ``[x | x_r]`` — the yardstick only; nothing in the port calls it.
    Returns (ms | None, note)."""
    try:
        nbm, width, bm, bk = vals.shape
        mask = vals.abs().sum(dim=(2, 3)) > 0
        crow = torch.zeros(nbm + 1, dtype=torch.int64, device=vals.device)
        crow[1:] = mask.sum(dim=1).cumsum(0)
        bsr = torch.sparse_bsr_tensor(crow, cols[mask].long(), vals[mask],
                                      size=(nbm * bm, xx.shape[0]))
        y = bsr @ xx
        torch.cuda.synchronize()
        return time_ms(lambda: bsr @ xx), \
            f"torch.sparse BSR @ [x | x_r], f32, out {tuple(y.shape)}"
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
        torch.cuda.synchronize()
        want = spmm_abft_plain(cols, vals, x, xr, inject=inject)
        for name, g_, w_ in zip(("out", "stripe_sums", "extra"), got, want):
            worst = max(worst, assert_close(f"spmm_abft[{tag}] {name} "
                                            f"inject={inject}", g_, w_))
    return worst


def check_fused(torch, cols, vals, h, w, wr, tag):
    """gcn_fused kernel vs plain: clean, injected, unchecked, telescopes."""
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
        torch.cuda.synchronize()
        want = gcn_fused_plain(cols, vals, h, w, wr, **kw)
        if len(got) != len(want):
            raise AssertionError(f"gcn_fused[{tag}] {kw}: {len(got)} outputs "
                                 f"vs {len(want)}")
        for name, g_, w_ in zip(names, got, want):
            worst = max(worst, assert_close(f"gcn_fused[{tag}] {name} {kw}",
                                            g_, w_))
        if kw.get("with_check") is False and float(got[2].abs().max()) != 0.0:
            raise AssertionError(f"gcn_fused[{tag}]: with_check=False left "
                                 f"extra non-zero")
    return worst


def phase_kernels(torch, batches, params):
    """Hold both kernels against their plain versions at the main path's
    shapes (both layers of the Cora-width packed batch), and at block 32;
    time them at the layer-0 shapes."""
    from repro_torch.analysis.vmem import _lanes
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine import fold_w_r
    from repro_torch.engine.streaming import packed_step_args
    from repro_torch.kernels.gcn_fused.kernel import (gcn_fused_kernel,
                                                      gcn_fused_plain)
    from repro_torch.kernels.gcn_fused.ops import _pad_weights
    from repro_torch.kernels.spmm_abft.kernel import (spmm_abft_kernel,
                                                      spmm_abft_plain)
    from repro_torch.kernels.spmm_abft.ops import pad_features

    cfg = ABFTConfig(mode="fused")
    layers = fold_w_r(params, cfg)["layers"]
    pb = batches[0]
    cols, vals, segments, h0 = packed_step_args(pb, "cuda")
    nbm, width, bm, bk = vals.shape
    tiles = nbm * width
    nnz_tiles = int((vals.abs().sum(dim=(2, 3)) > 0).sum())
    entries = {}

    # operands of both layers, as the main path hands them to the kernels
    h = h0
    per_layer = []
    for ell, layer in enumerate(layers):
        w, w_r = layer["w"], layer["w_r"]
        gp = _lanes(w.shape[1])
        x = pad_features(h @ w, gp).contiguous()
        xr = (h @ w_r)[:, None].contiguous()
        wp, wrp = _pad_weights(w, w_r, 128)
        per_layer.append((h.contiguous(), x, xr, wp, wrp))
        h = torch.relu(spmm_abft_plain(cols, vals, x, xr)[0][:, :w.shape[1]])

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

    # ---- timing at the layer-0 shapes (the dominant launch of each path)
    h_, x, xr, wp, wrp = per_layer[0]
    f, gp = wp.shape
    ms = time_ms(lambda: spmm_abft_kernel(cols, vals, x, xr))
    plain_ms = time_ms(lambda: spmm_abft_plain(cols, vals, x, xr),
                       warm=1, reps=3)
    lib_ms, lib_note = bsr_library_ms(torch, cols, vals,
                                      torch.cat([x, xr], dim=1).contiguous())
    outs = nbm * bm * gp * 4 + nbm * 4 + nbm * bm * 4
    b_bytes = nbytes(cols, vals, x, xr) + outs
    b_ops = 2 * tiles * bm * bk * (gp + 1)
    t_b, t_o = b_bytes / PEAK_BYTES_PER_S * 1e3, b_ops / PEAK_F32_FLOPS * 1e3
    entries["spmm_abft"] = dict(
        name="spmm_abft", route="cuda",
        source="src/repro_torch/kernels/csrc/spmm_abft.cu",
        replaces="src/repro/kernels/spmm_abft/kernel.py:75",
        max_abs_err=spmm_err, max_rel_corner=rels["spmm_abft"], ms=ms,
        plain_ms=plain_ms, bound_ms=max(t_b, t_o),
        bound_by="bytes" if t_b >= t_o else "operations",
        library_ms=lib_ms, library_note=lib_note,
        shape=dict(nbm=nbm, width=width, bm=bm, bk=bk, g=gp,
                   stored_tiles=tiles, nonzero_tiles=nnz_tiles),
        bytes=b_bytes, flops=b_ops)

    ms = time_ms(lambda: gcn_fused_kernel(cols, vals, h_, wp, wrp), reps=5)
    plain_ms = time_ms(lambda: gcn_fused_plain(cols, vals, h_, wp, wrp),
                       warm=1, reps=2)
    f_bytes = nbytes(cols, vals, h_, wp, wrp) + outs
    # least work for the same function: the combination once over the rows,
    # then the aggregation per stored tile (the kernel recomputes the
    # combination per tile: `recompute_flops`)
    f_ops = 2 * h_.shape[0] * f * (gp + 1) + b_ops
    t_b, t_o = f_bytes / PEAK_BYTES_PER_S * 1e3, f_ops / PEAK_F32_FLOPS * 1e3
    entries["gcn_fused"] = dict(
        name="gcn_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/gcn_fused.cu",
        replaces="src/repro/kernels/gcn_fused/kernel.py:105",
        max_abs_err=fused_err, max_rel_corner=rels["gcn_fused"], ms=ms,
        plain_ms=plain_ms, bound_ms=max(t_b, t_o),
        bound_by="bytes" if t_b >= t_o else "operations",
        library_ms=None,
        library_note="no single PyTorch call computes S (H W) with the "
                     "carried column and the per-stripe sums",
        shape=dict(nbm=nbm, width=width, bm=bm, bk=bk, f=f, g=gp,
                   stored_tiles=tiles, nonzero_tiles=nnz_tiles),
        bytes=f_bytes, flops=f_ops,
        recompute_flops=2 * tiles * bk * f * (gp + 1) + b_ops)

    # layer-1 launch times (narrow F) for the record
    h1, x1, xr1, wp1, wrp1 = per_layer[1]
    entries["spmm_abft"]["layer1_ms"] = time_ms(
        lambda: spmm_abft_kernel(cols, vals, x1, xr1))
    entries["gcn_fused"]["layer1_ms"] = time_ms(
        lambda: gcn_fused_kernel(cols, vals, h1, wp1, wrp1))

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
    # shapes that take the kernels' other mappings: more register tiles than
    # threads (two passes), and a reduction axis split three and eight ways
    r = torch.Generator().manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, generator=r).to("cuda")
    odd = {}
    x72, xr72 = rand(vals.shape[0] * bk, 72), rand(vals.shape[0] * bk, 1)
    odd["spmm_abft block128 G=72"] = check_spmm(torch, cols, vals, x72, xr72,
                                                "block128-G72")
    sx72, sxr72 = rand(sv.shape[0] * 32, 72), rand(sv.shape[0] * 32, 1)
    odd["spmm_abft block32 G=72"] = check_spmm(torch, sc, sv, sx72, sxr72,
                                               "block32-G72")
    w24, wr24 = rand(16, 24) * 0.2, rand(16, 1) * 0.2
    odd["gcn_fused block32 G=24"] = check_fused(torch, sc, sv, sh, w24, wr24,
                                                "block32-G24")
    w64, wr64 = rand(DIMS[0], 64) * 0.05, rand(DIMS[0], 1) * 0.05
    odd["gcn_fused block128 G=64"] = check_fused(torch, cols, vals, h_, w64,
                                                 wr64, "block128-G64")
    emit("kernel_checks", tolerance=dict(atol=OUT_ATOL, rtol=OUT_RTOL,
                                         corner_rtol=CORNER_RTOL),
         block32_max_abs_err=dict(spmm_abft=e32[0], gcn_fused=e32[1]),
         other_shapes_max_abs_err=odd,
         kernels=list(entries.values()))
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
    """The main path: the closed-batch guarded server, two-pass then
    fused-layer, with the launch counts read around each run."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine import fold_w_r
    from repro_torch.engine.streaming import PackedRunner
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve_gcn
    from repro_torch.runtime import ABFTGuard

    cfg = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    n_layers = len(params["layers"])
    shapes = {(b.bell.values.shape, b.h0.shape, b.n_slots) for b in batches}

    # logits of both paths against the float64 dense forward, and each other
    folded = fold_w_r(params, cfg)
    logit_err = {}
    path_logits = {}
    split_ms = {"two_pass": [], "fused_layer": []}
    for name, fused in (("two_pass", False), ("fused_layer", True)):
        runner = PackedRunner(folded, cfg, 128, fused_layer=fused,
                              device="cuda")
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

    result = {"logits_max_abs_err_vs_f64": logit_err,
              "two_pass_vs_fused_max_abs": cross, "dims": list(DIMS),
              "batches": len(batches), "shapes": len(shapes),
              "per_batch_host_clock": split_ms}
    launches = {}
    for name, fused, kernel, other in (
            ("two_pass", False, "spmm_abft", "gcn_fused"),
            ("fused_layer", True, "gcn_fused", "spmm_abft")):
        guard = ABFTGuard()
        runtime.reset_counts()
        stats = serve_gcn.serve(batches, params, cfg, guard=guard,
                                fused_layer=fused, device="cuda")
        counts, plain = runtime.launch_counts(), runtime.plain_counts()
        timed = counts[kernel] - len(shapes) * n_layers
        if timed != len(batches) * n_layers or counts[other] != 0:
            raise AssertionError(
                f"{name}: launches {counts} — expected {kernel} = (shapes "
                f"{len(shapes)} + batches {len(batches)}) x layers "
                f"{n_layers} and {other} = 0")
        if any(plain.values()):
            raise AssertionError(f"{name}: plain versions called {plain}")
        if stats["flags"] or stats["graph_flags"].any():
            raise AssertionError(f"{name}: clean stream flagged "
                                 f"{stats['graph_flags']}")
        if fused and stats["fused_hits"] != len(batches) * n_layers:
            raise AssertionError(f"fusion counts {stats}")
        launches[kernel] = counts[kernel]
        result[name] = dict(
            graphs=stats["graphs"], seconds=stats["seconds"],
            graphs_per_sec=stats["graphs_per_sec"], launches=counts,
            launches_timed_phase=timed, plain_calls=plain,
            flags=int(stats["flags"]),
            max_rel=float(stats["graph_max_rel"].max()),
            fused_hits=stats["fused_hits"],
            fused_fallbacks=stats["fused_fallbacks"])

    # the other tile shape: block 32 at the CLI's default widths
    for name, extra in (("block32_two_pass", []),
                        ("block32_fused_layer", ["--fused-layer"])):
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


def phase_fault(torch, batches, params):
    """Accumulator upsets at layer 0 and layer 1, on both paths: exactly the
    graph that owns the stripe flags, the per-graph retry clears it, and the
    repaired logits equal the clean run's."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine import fold_w_r
    from repro_torch.engine.streaming import PackedRunner
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
            first = raw["abft_graph_flags"].cpu().numpy()
            want = [g == owner for g in range(pb.n_slots)]
            if first.tolist() != want:
                raise AssertionError(f"fault fused={fused} layer={layer}: "
                                     f"flags {first.tolist()}, owner {owner}")
            guard = ABFTGuard()
            out, metrics = guard.run_step_graphs(step, runner.retry_fn(pb),
                                                 *args)
            torch.cuda.synchronize()
            final = metrics["abft_graph_flags"]
            final = final.cpu().numpy() if hasattr(final, "cpu") else final
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
    emit("fault", cases=cases)


def phase_full_graph(torch, params):
    """One whole Cora-sized graph through gcn_apply on the block-ELL
    backend, both paths, against the dense backend."""
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
    for name, fused in (("two_pass", False), ("fused_layer", True)):
        runtime.reset_counts()
        logits, rep = gcn_apply(folded, Graph(bell, h0), cfg,
                                backend="block_ell", fused_layer=fused,
                                device="cuda")
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
    if stop_after == "kernels":
        return 0
    launches = phase_serve(torch, batches, params)
    phase_fault(torch, batches, params)
    phase_full_graph(torch, params)

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
