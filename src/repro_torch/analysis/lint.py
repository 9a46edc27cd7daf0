"""``abftlint`` CLI for the port: run the static-analysis passes over a
traced step.

    PYTHONPATH=src python -m repro_torch.analysis.lint --device cpu \\
        --step gcn-serve --granularity slot --fused-network

Counterpart of the JAX package's ``repro/analysis/lint.py``: the same
steps, flags and exit codes, and one flag of its own, ``--device`` (default
``cuda``; without a GPU it raises unless ``--device cpu`` is given).  Each
step builds a small synthetic instance of the real serving path from a
seed with numpy and traces it in real mode (``analysis/coverage.py``): on
the card the kernels launch, on the CPU their plain versions run.

* ``gcn-serve``    — the packed block-ELL serve step
  (``make_packed_serve_step``), what ``launch/serve_gcn.py`` dispatches;
* ``gcn-stream``   — the same step at every rung of a ``plan_rungs`` shape
  menu, plus the rung-table shared-memory lint *before* any trace;
* ``gcn-forward``  — the engine forward (``--backend dense|bcoo``);
* ``gcn-train``    — a GCN train step (``gcn_loss`` and
  ``torch.autograd.grad``); the backward's products are expected
  unchecked — ABFT covers the forward products, the paper's scope;
* ``lm-prefill`` / ``lm-decode`` — the guarded LM serving steps
  (``engine/lm.py``) at the ``smoke_config`` twin of ``--arch``; they gate
  on zero unchecked matmuls (``--mode none`` with ``--expect-unchecked``
  gives the unguarded baseline manifest);
* ``gat-serve``    — the guarded GAT serve step (``engine/gat.py``).

Passes (``--passes coverage,vmem,syncs``; default all): coverage traces the
step under check tagging and verifies every matmul-shaped ATen node and
every kernel site reaches an eq. 4-6 comparison; vmem prices every traced
kernel launch's shared memory (``analysis.vmem.graph_smem_report``) and,
for gcn-stream, every rung against the budget; syncs AST-lints the port's
engine, launch and fault layers (``analysis/syncs.py``).

Exit status: 0 clean, 1 findings, 2 usage error.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

STEPS = ("gcn-serve", "gcn-stream", "gcn-forward", "gcn-train",
         "lm-prefill", "lm-decode", "gat-serve")
PASSES = ("coverage", "vmem", "syncs")
# the LM steps' batch, prompt and cache length (the reference's)
LM_BATCH, LM_PROMPT, LM_CACHE = 2, 8, 16


def _synth_graphs(n_graphs: int, nodes: int, feat: int, seed: int = 0):
    """The reference's synthetic graphs: (S, H0) pairs, S with edge
    density 0.3 plus self-loops."""
    import numpy as np
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        s = (rng.random((nodes, nodes)) < 0.3).astype(np.float32)
        s += np.eye(nodes, dtype=np.float32)
        graphs.append((s, rng.random((nodes, feat)).astype(np.float32)))
    return graphs


def _gcn_params(dims, dev, seed: int = 0):
    import torch

    from repro_torch.core.gcn import init_gcn
    return init_gcn(torch.Generator().manual_seed(seed), dims, device=dev)


def _packed_step(args, dev, granularity: str):
    """(step, operands) of the packed GCN serve step."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine.api import fold_w_r
    from repro_torch.engine.batching import pack_graphs
    from repro_torch.engine.streaming import (make_packed_serve_step,
                                              packed_step_args)

    cfg = ABFTConfig(mode=args.mode)
    params = fold_w_r(_gcn_params(_dims(args), dev), cfg)
    graphs = _synth_graphs(args.graphs, args.nodes, args.feat)
    pb = pack_graphs(graphs, block=args.block, n_slots=args.graphs)
    step = make_packed_serve_step(
        params, cfg, pb.n_slots, granularity=granularity,
        fused_layer=args.fused_layer, fused_network=args.fused_network,
        vmem_budget=args.vmem_budget)
    return step, packed_step_args(pb, dev)


def _dims(args) -> list:
    return [args.feat, args.hidden, args.classes]


def lm_step(cfg, abft, step: str, dev, *, params=None, batch=LM_BATCH,
            prompt=LM_PROMPT, cache=LM_CACHE, src=None):
    """(fn, operands, carry) of a guarded LM step at a seeded instance of
    ``cfg`` (or at ``params``, already folded): the prefill of a ``batch``
    x ``prompt`` prompt (an encoder-decoder's over ``src`` source frames,
    ``prompt`` by default, as the reference's), or one decode step after it
    at position ``prompt`` (the prefill's states zeroed, as the
    reference's ``eval_shape`` zeros).  ``fn`` returns the step's tensors
    (the op-id strings are dropped), a decode step's new states right after
    its logits; ``carry`` pairs each state input leaf with its new state
    (``analysis.coverage.analyze_graph``)."""
    import numpy as np
    import torch

    from repro_torch.engine.lm import (fold_lm_w_r, make_guarded_decode_step,
                                       make_guarded_prefill_step)
    from repro_torch.models.transformer import init_model

    if params is None:
        params = fold_lm_w_r(init_model(cfg, 0, device=dev), cfg, abft)
    rng = np.random.default_rng(0)
    inputs = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch, prompt))).to(dev)}
    if cfg.family == "encdec":
        inputs["src_embeds"] = torch.from_numpy(rng.normal(
            size=(batch, src or prompt, cfg.d_model)).astype(
                np.float32)).to(dev)
    prefill = make_guarded_prefill_step(cfg, abft, cache)
    if step == "lm-prefill":
        return (lambda p, b: prefill(p, b, 0.0)), (params, inputs), ()
    (_logits, states), _m = prefill(params, inputs, 0.0)
    leaves = torch.utils._pytree.tree_leaves
    states = torch.utils._pytree.tree_map(torch.zeros_like, states)
    tok = torch.zeros((batch, 1), dtype=inputs["tokens"].dtype, device=dev)
    decode = make_guarded_decode_step(cfg, abft)
    first, n = len(leaves(params)), len(leaves(states))
    return ((lambda p, s, t: decode(p, s, t, prompt, 0.0)),
            (params, states, tok), [(first + i, 1 + i) for i in range(n)])


def _build_traces(args, dev):
    """([(name, graph module, carry)], extra findings) for the requested
    step — the rung-table lint's findings come before any trace."""
    import torch

    from repro_torch.analysis.coverage import trace
    from repro_torch.core.abft import ABFTConfig

    step, gran = args.step, args.granularity
    if step == "gcn-serve":
        fn, ops = _packed_step(args, dev, gran)
        return [(f"gcn-serve/{gran}", trace(fn, *ops), ())], []

    if step == "gcn-stream":
        from repro_torch.analysis.vmem import lint_rung_table
        from repro_torch.engine.api import fold_w_r
        from repro_torch.engine.batching import pack_graphs
        from repro_torch.engine.streaming import (make_packed_serve_step,
                                                  packed_step_args,
                                                  plan_rungs)

        cfg = ABFTConfig(mode=args.mode)
        params = fold_w_r(_gcn_params(_dims(args), dev), cfg)
        graphs = _synth_graphs(max(args.graphs, 4), args.nodes, args.feat)
        rungs = plan_rungs(graphs, n_slots=4, block=args.block)
        # the rung lint FIRST: an over-budget rung is rejected before any
        # rung shape is traced, let alone run
        verdicts = lint_rung_table(
            rungs, _dims(args), block=args.block,
            budget=args.vmem_budget or _default_budget(),
            fused_network=args.fused_network)
        for v in verdicts:
            print(f"[vmem] rung {v.stripe_cap}x{v.width_cap}x{v.n_slots}: "
                  f"layer={v.layer_bytes}B network={v.network_bytes}B / "
                  f"{v.budget}B {'ok' if v.fits else 'OVER BUDGET'}",
                  flush=True)
        extra = [f"rung {v.stripe_cap}x{v.width_cap}x{v.n_slots}: "
                 f"{v.network_bytes or v.layer_bytes} bytes over budget "
                 f"{v.budget}" for v in verdicts if not v.fits]
        if extra:
            return [], extra
        traces = []
        for r in rungs.rungs:
            pb = pack_graphs(graphs[:1], block=rungs.block,
                             n_slots=r.n_slots, stripe_cap=r.stripe_cap,
                             width_cap=r.width_cap,
                             stripe_multiple=rungs.stripe_multiple,
                             width_multiple=rungs.width_multiple)
            s = make_packed_serve_step(
                params, cfg, pb.n_slots, granularity=gran,
                fused_layer=args.fused_layer,
                fused_network=args.fused_network,
                vmem_budget=args.vmem_budget)
            traces.append((
                f"gcn-stream/rung{r.stripe_cap}x{r.width_cap}/{gran}",
                trace(s, *packed_step_args(pb, dev)), ()))
        return traces, []

    if step == "gcn-forward":
        from repro_torch.core.abft import summarize
        from repro_torch.engine import Graph, gcn_forward

        cfg = ABFTConfig(mode=args.mode)
        params = _gcn_params(_dims(args), dev)
        s, h0 = (torch.from_numpy(a).to(dev)
                 for a in _synth_graphs(1, args.nodes, args.feat)[0])
        if args.backend == "bcoo":
            s = s.to_sparse()

        def fwd(h0):
            logits, checks = gcn_forward(params, Graph(s=s, h0=h0), cfg,
                                         backend=args.backend, device=dev)
            rep = summarize(checks, cfg, device=dev)
            return logits, rep.flag, rep.max_rel

        return [(f"gcn-forward/{args.backend}", trace(fwd, h0), ())], []

    if step == "gcn-train":
        import numpy as np

        from repro_torch.core.gcn import gcn_loss

        cfg = ABFTConfig(mode=args.mode)
        params = _gcn_params(_dims(args), dev)
        s, h0 = (torch.from_numpy(a).to(dev)
                 for a in _synth_graphs(1, args.nodes, args.feat)[0])
        labels = torch.from_numpy(
            np.arange(args.nodes) % args.classes).to(dev)
        ws = [lay["w"] for lay in params["layers"]]

        def train(h0, *ws):
            ws = [w.detach().requires_grad_() for w in ws]
            p = {"layers": [{"w": w} for w in ws]}
            loss, rep = gcn_loss(p, s, h0, labels, None, cfg, device=dev)
            grads = torch.autograd.grad(loss, ws)
            return (loss, rep.flag,
                    [w - 1e-2 * g for w, g in zip(ws, grads)])

        return [("gcn-train", trace(train, h0, *ws), ())], []

    if step in ("lm-prefill", "lm-decode"):
        from repro_torch.configs import get_config, smoke_config

        cfg = smoke_config(get_config(args.arch))
        fn, ops, carry = lm_step(cfg, ABFTConfig(mode=args.mode), step, dev)
        return [(f"{step}/{cfg.name}", trace(fn, *ops), carry)], []

    if step == "gat-serve":
        from repro_torch.engine.gat import (fold_gat_w_r, init_gat,
                                            make_gat_serve_step)

        cfg = ABFTConfig(mode=args.mode)
        dims = (args.feat, args.hidden, args.hidden, args.classes)
        params = fold_gat_w_r(init_gat(torch.Generator().manual_seed(0),
                                       dims, device=dev), cfg)
        adj, h0 = (torch.from_numpy(a).to(dev)
                   for a in _synth_graphs(1, args.nodes, args.feat)[0])
        serve = make_gat_serve_step(cfg)
        return [("gat-serve", trace(lambda p, h, a: serve(p, h, a, -1, 0.0),
                                    params, h0, adj), ())], []

    raise SystemExit(2)


def _default_budget() -> int:
    from repro_torch.analysis.vmem import FUSED_SMEM_BUDGET
    return FUSED_SMEM_BUDGET


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="abftlint: static ABFT coverage / shared memory / sync "
                    "analysis of the port")
    ap.add_argument("--step", choices=STEPS, default="gcn-serve")
    ap.add_argument("--granularity", default="graph",
                    choices=["layer", "graph", "stripe", "slot"])
    ap.add_argument("--backend", default="dense",
                    choices=["dense", "bcoo", "block_ell"],
                    help="gcn-forward engine backend")
    ap.add_argument("--mode", default=None,
                    choices=["none", "split", "fused"],
                    help="ABFT mode for the traced step; default fused "
                         "(--mode none gives the unguarded baseline "
                         "manifest)")
    ap.add_argument("--arch", default="gemma-2b",
                    help="lm-* architecture (smoke-sized)")
    ap.add_argument("--fused-layer", action="store_true")
    ap.add_argument("--fused-network", action="store_true")
    ap.add_argument("--graphs", type=int, default=3)
    ap.add_argument("--nodes", type=int, default=24)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--feat", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--classes", type=int, default=3)
    ap.add_argument("--vmem-budget", type=int, default=None,
                    help="shared-memory budget of one block, bytes")
    ap.add_argument("--passes", default="coverage,vmem,syncs",
                    help="comma list of: coverage,vmem,syncs")
    ap.add_argument("--manifest", type=Path, default=None,
                    help="write the coverage manifest(s) as JSON")
    ap.add_argument("--expect-unchecked", action="store_true",
                    help="invert the coverage gate: succeed when unchecked "
                         "matmuls exist (the --mode none baseline "
                         "manifest)")
    ap.add_argument("--device", default="cuda",
                    help="where the traced step runs (default cuda: the "
                         "kernels launch; cpu: their plain versions)")
    ap.add_argument("--verbose", "-v", action="store_true")
    args = ap.parse_args(argv)
    if args.mode is None:
        args.mode = "fused"

    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    bad = [p for p in passes if p not in PASSES]
    if bad:
        print(f"abftlint: unknown pass(es) {bad}; choose from {PASSES}",
              file=sys.stderr)
        return 2
    if args.backend == "block_ell" and args.step == "gcn-forward":
        print("abftlint: --backend block_ell is exercised via --step "
              "gcn-serve (the packed path); gcn-forward takes dense|bcoo",
              file=sys.stderr)
        return 2

    failures = 0
    manifests = []

    need_trace = "coverage" in passes or "vmem" in passes
    traces, extra = [], []
    if need_trace:
        from repro_torch.device import resolve_device
        traces, extra = _build_traces(args, resolve_device(args.device))
    for msg in extra:
        print(f"[vmem] RUNG OVER BUDGET: {msg}")
        failures += 1

    if "coverage" in passes:
        from repro_torch.analysis.coverage import (analyze_graph,
                                                   format_report)
        for name, gm, carry in traces:
            m = analyze_graph(gm, step=name, carry=carry)
            manifests.append(m)
            print(format_report(m, verbose=args.verbose))
            if args.expect_unchecked:
                if m.n_unchecked == 0:
                    print(f"[coverage] {name}: expected unchecked matmuls "
                          f"but found none — remove --expect-unchecked "
                          f"(this path is now fully covered)")
                    failures += 1
            elif m.n_unchecked:
                failures += 1

    if "vmem" in passes:
        from repro_torch.analysis.vmem import graph_smem_report
        budget = args.vmem_budget or _default_budget()
        for name, gm, _carry in traces:
            for est in graph_smem_report(gm, budget=budget):
                status = "ok" if est.fits else "OVER BUDGET"
                print(f"[vmem] {name}: {est.name} shape={est.shape} "
                      f"smem={est.total_bytes}B / {est.budget}B {status}")
                if not est.fits:
                    failures += 1
    del traces

    if "syncs" in passes:
        from repro_torch.analysis.syncs import scan_tree
        root = Path(__file__).resolve().parents[3]
        findings = scan_tree(root)
        for f in findings:
            try:
                print(f"[syncs] {Path(f.path).relative_to(root)}:{f.line}:"
                      f"{f.col}: [{f.rule}] {f.message}")
            except ValueError:
                print(f"[syncs] {f}")
        print(f"[syncs] {len(findings)} finding(s) over engine/ + launch/ "
              f"+ faults/")
        failures += len(findings)

    if args.manifest is not None:
        payload = [m.to_dict() for m in manifests]
        args.manifest.write_text(json.dumps(
            payload[0] if len(payload) == 1 else payload, indent=2) + "\n")
        print(f"[coverage] manifest -> {args.manifest}")

    if failures:
        print(f"abftlint: {failures} failure(s)")
        return 1
    print("abftlint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
