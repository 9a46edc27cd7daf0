"""Fault-injection walkthrough: one campaign, narrated (PyTorch port).

The port's counterpart of ``examples/fault_injection_demo.py``: the same
mechanics — bit flip -> delta -> checksum divergence -> detection category,
for both ABFT variants on the same fault — on ``repro_torch.core.fault``,
which is numpy only, as the reference's is.  So it runs on the host and
takes no ``--device``; its output equals the reference example's line for
line.

    PYTHONPATH=src python examples/torch_fault_injection_demo.py
"""
import argparse

import numpy as np

from repro_torch.core.datasets import make_dataset
from repro_torch.core.fault import (
    NumpyGCN,
    flip_bit_f32,
    run_campaign,
    train_weights_numpy,
)


def main(argv=None):
    argparse.ArgumentParser(
        description="narrated fault-injection campaign (numpy, host)"
    ).parse_args(argv)
    print("=== single-fault walkthrough (synthetic Cora) ===\n")
    ds = make_dataset("cora", seed=0, normalize=False)
    ws = train_weights_numpy(ds, epochs=60, lr=0.02, seed=0)
    model = NumpyGCN(ds, weights=ws)
    acc = (model.pred_cls == ds.labels).mean()
    print(f"trained 2-layer GCN, train-acc {acc:.2f}")

    # manual single fault: flip a high mantissa bit of a partial sum
    st = model.layers[1]
    i, j, t = 7, 2, 3
    part, _ = model.comb_prefix(1, i, j, t)
    for bit in (30, 23, 12, 2):
        flipped = flip_bit_f32(part, bit)
        delta = float(flipped) - float(part)
        d2 = (st.sum_hout - st.pred2) + delta * float(model.s_c[i])
        print(f"bit {bit:2d}: partial {float(part):+.4e} -> "
              f"{float(flipped):+.4e}  delta={delta:+.3e}  "
              f"|checksum diff|={abs(d2):.3e}  "
              f"detected@1e-4={abs(d2) > 1e-4}")

    print("\n100 random campaigns, paired per mode:")
    for mode in ("split", "fused"):
        det = sil = fp = 0
        rngm = np.random.default_rng(0)
        for _ in range(100):
            o = run_campaign(model, mode, rngm)
            if o.target == "mm" and o.output_corrupted:
                det += o.diffs[1e-7]
                sil += not o.diffs[1e-7]
            else:
                fp += o.diffs[1e-7]
        print(f"  {mode:6s}: detected {det}, silent {sil}, "
              f"false-positive {fp}  (tau=1e-7)")


if __name__ == "__main__":
    main()
