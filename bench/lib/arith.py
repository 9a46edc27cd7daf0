"""The yardstick's arithmetic: the card's peaks, each kernel's least time,
and the model FLOPs of a batch.  A frozen copy of the bound formulas of
``chip_smoke.py`` (``matmul_bound``, ``flash_bound``, ``step_products``),
kept here so that a later change to the program cannot move the yardstick.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 67 TFLOP/s in
float32 outside the tensor cores (the port's products run on FFMA, TF32
off), 3.35 TB/s of HBM.  A least time counts each input read once and each
output written once against the operations the product needs.
"""
from __future__ import annotations

from typing import List, Tuple

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


def flash_bound(b: int, t: int, s: int, h: int, kh: int, dh: int,
                checked: bool = True) -> Tuple[float, int, int]:
    """One causal flash_checksum launch: q, k, v and o once against the
    valid pairs' work (q·k and p·v over dh); checked, also vr and o_extra
    once and p·vr."""
    nbytes = F32 * (2 * b * t * h * dh + 2 * b * s * kh * dh)
    if checked:
        nbytes += F32 * (b * s * h + b * t * h)
    # query i of T (after S - T cached keys) sees keys 0 .. S - T + i
    pairs = b * h * sum(min(s - t + i + 1, s) for i in range(t))
    ops = pairs * (4 * dh + (2 if checked else 0))
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S), ops, nbytes


def layer_products(run: dict) -> List[Tuple[int, int, bool]]:
    """(K, N, checked) of each dense matmul_abft launch of one layer:
    q, k, v, o (attention's W_o product is left to the fused chain check,
    so it carries no b_r), then a gated MLP's three or an MoE layer's
    router and its shared experts' three."""
    d, h, kh, hd = run["d_model"], run["n_heads"], run["n_kv_heads"], \
        run["head_dim"]
    out = [(d, h * hd, True), (d, kh * hd, True), (d, kh * hd, True),
           (h * hd, d, False)]
    moe = run.get("moe")
    if moe is None:
        f = run["d_ff"]
        return out + [(d, f, True), (d, f, True), (f, d, True)]
    out.append((d, moe["n_experts"], True))
    if moe["n_shared"]:
        f = moe["d_ff_shared"]
        out += [(d, f, True), (d, f, True), (f, d, True)]
    return out


def step_products(run: dict, batch: int, tokens: int, checked: bool = True
                  ) -> List[Tuple[int, int, int, bool]]:
    """(M, K, N, checked) of every dense matmul_abft launch of one step
    over ``tokens`` positions of each of ``batch`` sequences (a prefill of
    the prompt, or a decode step at tokens = 1): every layer's products at
    M = batch x tokens, then the head over the last position of each.
    With the checks off (``checked`` false) no product is checked."""
    m = batch * tokens
    out = []
    for _ in range(run["n_layers"]):
        out += [(m, k, n, c and checked) for k, n, c in layer_products(run)]
    v = -(-run["vocab_size"] // 512) * 512
    return out + [(batch, run["d_model"], v, checked)]


def expert_products(run: dict, batch: int, tokens: int
                    ) -> List[Tuple[int, int, int, int]]:
    """(routed rows, K, N, live experts) of each grouped launch of one
    step: up, gate and down a layer, every token routed to top_k experts
    (no assignment dropped: the configurations give every expert room)."""
    moe = run.get("moe")
    if moe is None:
        return []
    rows = batch * tokens * moe["top_k"]
    live = min(moe["n_experts"], rows)
    d, f = run["d_model"], moe["d_ff_expert"]
    return [(rows, d, f, live), (rows, d, f, live), (rows, f, d, live)] * \
        run["n_layers"]


def matmul_least_s(run: dict, batch: int, prompt: int, new: int,
                   checked: bool = True) -> float:
    """Least seconds of every matmul_abft launch (dense and grouped) of one
    batch: its prefill and its new - 1 decode steps, with or without the
    checks."""
    total = 0.0
    for tokens, steps in ((prompt, 1), (1, new - 1)):
        if steps:
            one = sum(matmul_bound(m, k, n, c)[0] for m, k, n, c in
                      step_products(run, batch, tokens, checked))
            one += sum(grouped_bound(r, k, n, g, checked)[0]
                       for r, k, n, g in expert_products(run, batch, tokens))
            total += steps * one
    return total


def flash_least_s(run: dict, batch: int, prompt: int,
                  checked: bool = True) -> float:
    """Least seconds of the flash_checksum launches of one prefill (decode
    attention is plain PyTorch, not this kernel)."""
    return run["n_layers"] * flash_bound(
        batch, prompt, prompt, run["n_heads"], run["n_kv_heads"],
        run["head_dim"], checked)[0]


def weights_per_token(run: dict) -> int:
    """Weights one token multiplies by in one pass through the layers
    (routed experts at top_k), without the head."""
    d, h, kh, hd = run["d_model"], run["n_heads"], run["n_kv_heads"], \
        run["head_dim"]
    attn = d * h * hd + 2 * d * kh * hd + h * hd * d
    moe = run.get("moe")
    if moe is None:
        mlp = 3 * d * run["d_ff"]
    else:
        mlp = d * moe["n_experts"] + moe["top_k"] * 3 * d * moe["d_ff_expert"]
        mlp += 3 * d * moe["d_ff_shared"] if moe["n_shared"] else 0
    return run["n_layers"] * (attn + mlp)


def model_flops(run: dict, batch: int, prompt: int, new: int) -> int:
    """Model FLOPs of one batch: 2 per weight used per token, attention
    4 · context · H · dh per token per layer, the head once per generated
    token."""
    per_tok = 2 * weights_per_token(run)
    attn = 4 * run["n_heads"] * run["head_dim"] * run["n_layers"]
    head = 2 * run["d_model"] * run["vocab_size"]
    pre = batch * (prompt * per_tok + attn * prompt * (prompt + 1) // 2 + head)
    dec = sum(batch * (per_tok + attn * (prompt + i + 1) + head)
              for i in range(new - 1))
    return pre + dec
