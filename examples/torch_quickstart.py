"""Quickstart: the paper in 60 seconds (PyTorch port).

The port's counterpart of ``examples/quickstart.py``: builds a synthetic
Cora-sized GCN, runs inference with both ABFT variants, injects a fault,
and shows (a) identical clean behaviour, (b) detection by both, (c) the
op-count savings of the fused checksum.  On the card the ``block_ell``
engine line runs the hand-written block-ELL SpMM kernel.

    PYTHONPATH=src python examples/torch_quickstart.py              # GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Without ``--device cpu`` it runs on the card and raises when there is none.
"""
import argparse

import torch

from repro_torch.core import ABFTConfig, gcn_layer_fused
from repro_torch.core.datasets import make_reduced
from repro_torch.core.gcn import (
    dataset_to_dense,
    dataset_to_sparse,
    gcn_apply,
    gcn_apply_sparse,
    init_gcn,
    precompute_s_c,
)
from repro_torch.core.opcount import gcn_op_counts
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== GCN-ABFT quickstart ===\n")
    ds = make_reduced("cora", scale=4, seed=0)
    s_np, h_np, _ = dataset_to_dense(ds)
    s, h = torch.from_numpy(s_np).to(dev), torch.from_numpy(h_np).to(dev)
    dims = ds.stats.layer_dims
    params = init_gcn(torch.Generator().manual_seed(0), dims, device=dev)

    for mode in ("split", "fused"):
        cfg = ABFTConfig(mode=mode, threshold=1e-3, relative=True)
        logits, report = gcn_apply(params, s, h, cfg, device=dev)
        print(f"{mode:6s}: clean forward  flag={bool(report.flag)} "
              f"max_rel={float(report.max_rel):.2e} "
              f"checks={int(report.n_checks)}")

    # inject a fault into the first layer's combination output
    w = params["layers"][0]["w"]
    cfg = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    h_out, chk = gcn_layer_fused(s, h, w, cfg, device=dev)
    bad = h_out.clone()
    # the population std (ddof 0), as jnp.std computes it
    bad[5, 3] += h_out.std(correction=0) * 1e3
    diff = abs(float(chk.predicted) - float(bad.sum()))
    print(f"\ninjected fault: |predicted - actual| = {diff:.3e} "
          f"-> detected: {diff > 1e-3 * abs(float(bad.sum()))}")

    # sparse aggregation path: same logits, same checks, scales past toy
    # graphs — S stays a sparse tensor and s_c = e^T S is precomputed once
    # offline
    cfg = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    s_sp, h_sp, _ = dataset_to_sparse(ds, device=dev)
    s_c = precompute_s_c(s_sp, cfg)
    logits_sp, rep_sp = gcn_apply_sparse(params, s_sp, h_sp, cfg, s_c,
                                         device=dev)
    logits_d, _ = gcn_apply(params, s, h, cfg, device=dev)
    err = float((logits_sp - logits_d).abs().max())
    print(f"\nsparse (BCOO) path: max |logit diff| vs dense = {err:.2e} "
          f"flag={bool(rep_sp.flag)}")

    # unified engine: every backend behind one entry point — identical
    # logits and report semantics from dense, sparse, and the block-ELL
    # kernel (repro_torch.engine.gcn_apply; the core entry points above
    # are thin compat shims over this).
    from repro_torch.engine import Graph, gcn_apply as engine_apply
    from repro_torch.kernels.spmm_abft.layout import dense_to_block_ell

    bell = dense_to_block_ell(s_np, block_m=32, block_k=32)
    print("\nunified engine, one entry point per backend:")
    for backend, graph in (("dense", Graph(s, h)),
                           ("bcoo", Graph(s_sp, h_sp, s_c=s_c)),
                           ("block_ell", Graph(bell, h))):
        lg, rep = engine_apply(params, graph, cfg, backend=backend,
                               device=dev,
                               **({"block_g": 32}
                                  if backend == "block_ell" else {}))
        err = float((lg - logits_d).abs().max())
        print(f"  {backend:9s} |logit diff|={err:.2e} "
              f"flag={bool(rep.flag)} checks={int(rep.n_checks)}")
    print("  (batched multi-graph serving: "
          "python -m repro_torch.launch.serve_gcn)")

    print("\nop-count savings (full-size graphs, paper Table II):")
    for name in ("cora", "citeseer", "pubmed", "nell"):
        oc = gcn_op_counts(name)
        print(f"  {name:9s} check ops: split {oc.split_check/1e6:7.3f}M "
              f"fused {oc.fused_check/1e6:7.3f}M  "
              f"(saves {oc.check_savings*100:.1f}%)")


if __name__ == "__main__":
    main()
