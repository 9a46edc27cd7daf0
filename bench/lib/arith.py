"""The yardstick's arithmetic: the card's peaks, each kernel's least time,
and the model FLOPs of a batch, summed over the launches and layers that
the configuration's layout (``bench/layouts/``) lists.  A frozen copy of the
bound formulas of ``chip_smoke.py`` (``matmul_bound``, ``flash_bound``; its
``step_products`` is the decoder layout's), kept here so that a later change
to the program cannot move the yardstick.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 67 TFLOP/s in
float32 outside the tensor cores (the port's products run on FFMA, TF32
off), 3.35 TB/s of HBM.  A least time counts each input read once and each
output written once against the operations the product needs.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

from bench.layouts import decoder
# the default layout's launch lists, under the names they had here
from bench.layouts.decoder import (  # noqa: F401
    expert_products, step_products, weights_per_token)

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def matmul_bound(m: int, k: int, n: int, checked: bool = True
                 ) -> Tuple[float, int, int]:
    """(least seconds, operations, bytes) of one matmul_abft product
    [m, k] @ [k, n]: a checked product also multiplies by the right
    checksum b_r [k] into one extra output column [m] (2MK operations)."""
    ops = 2 * m * n * k + (2 * m * k if checked else 0)
    nbytes = F32 * (m * k + k * n + m * n + ((k + m) if checked else 0))
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S), ops, nbytes


def grouped_bound(rows: int, k: int, n: int, groups: int,
                  checked: bool = True) -> Tuple[float, int, int]:
    """One grouped launch over ``groups`` live experts holding ``rows``
    routed rows in all, each [rows_e, k] @ [k, n] (with its b_r and extra
    column when checked)."""
    ops = 2 * rows * n * k + (2 * rows * k if checked else 0)
    nbytes = F32 * (rows * k + groups * k * n + rows * n +
                    ((groups * k + rows) if checked else 0))
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S), ops, nbytes


def flash_bound(b: int, t: int, s: int, h: int, kh: int, dk: int,
                checked: bool = True, dv: Optional[int] = None
                ) -> Tuple[float, int, int]:
    """One causal flash_checksum launch: q and k of width dk, v and o of
    width dv (dk without one), each once, against the valid pairs' work
    (q·k over dk, p·v over dv); checked, also vr and o_extra once and
    p·vr."""
    dv = dk if dv is None else dv
    nbytes = F32 * (b * t * h * (dk + dv) + b * s * kh * (dk + dv))
    if checked:
        nbytes += F32 * (b * s * h + b * t * h)
    # query i of T (after S - T cached keys) sees keys 0 .. S - T + i
    pairs = b * h * sum(min(s - t + i + 1, s) for i in range(t))
    ops = pairs * (2 * dk + 2 * dv + (2 if checked else 0))
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S), ops, nbytes


def matmul_least_s(run: dict, batch: int, prompt: int, new: int,
                   checked: bool = True, layout=decoder) -> float:
    """Least seconds of every matmul_abft launch (dense and grouped) of one
    batch: its prefill and its new - 1 decode steps, with or without the
    checks."""
    total = 0.0
    for tokens, steps in ((prompt, 1), (1, new - 1)):
        if steps:
            one = sum(matmul_bound(m, k, n, c)[0] for m, k, n, c in
                      layout.step_products(run, batch, tokens, checked))
            one += sum(grouped_bound(r, k, n, g, checked)[0] for r, k, n, g
                       in layout.expert_products(run, batch, tokens))
            total += steps * one
    return total


def flash_least_s(run: dict, batch: int, prompt: int,
                  checked: bool = True, layout=decoder) -> float:
    """Least seconds of the flash_checksum launches of one prefill, each
    distinct launch bounded once and counted as often as it runs."""
    return sum(n * flash_bound(b, t, s, h, kh, dk, checked, dv)[0]
               for (b, t, s, h, kh, dk, dv), n in
               Counter(layout.flash_launches(run, batch, prompt,
                                             checked)).items())


def model_flops(run: dict, batch: int, prompt: int, new: int,
                layout=decoder) -> int:
    """Model FLOPs of one batch: 2 per weight used per token, attention's
    FLOPs per query-key pair over every pair of every layer, the head once
    per generated token."""
    per_tok = 2 * layout.weights_per_token(run)
    attn = sum(layout.pair_flops(run))
    head = 2 * run["d_model"] * run["vocab_size"]
    pre = batch * (prompt * per_tok + attn * prompt * (prompt + 1) // 2 + head)
    dec = sum(batch * (per_tok + attn * (prompt + i + 1) + head)
              for i in range(new - 1))
    return pre + dec
