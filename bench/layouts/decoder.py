"""The decoder layout: one segment of identical layers, each grouped-query
attention (``wq``, ``wk``, ``wv``, ``wo`` of one head width, optional QKV
bias) followed by a gated MLP or a uniform MoE layer (router, routed experts,
optional shared experts), then the final norm and an untied head.  The tree
is the one the program's ``LMEngine`` takes: ``{"embed": {"table"},
"segments": [{"b0": {...}}], "final_norm": {"scale"}, "head": {"w"}}`` with
every layer leaf stacked on a leading axis of ``n_layers``.

Weights ``N(0, 1 / d_in)``, biases ``N(0, 0.02^2)``, norm scales (held as
``1 + scale``) ``N(0, 0.1^2)``, the embedding ``N(0, 1)``."""
from __future__ import annotations

from typing import List, Tuple

NORM_STD = 0.1
BIAS_STD = 0.02


def padded_vocab(run: dict) -> int:
    return -(-run["vocab_size"] // 512) * 512


def leaf_specs(run: dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...],
                                        float]]:
    """(path, shape, std) of every leaf, in the order they are drawn."""
    L, d = run["n_layers"], run["d_model"]
    h, kh, hd = run["n_heads"], run["n_kv_heads"], run["head_dim"]
    v = padded_vocab(run)
    seg = ("segments", "0", "b0")
    out = [(("embed", "table"), (v, d), 1.0),
           (seg + ("ln1", "scale"), (L, d), NORM_STD),
           (seg + ("ln2", "scale"), (L, d), NORM_STD)]
    for name, heads in (("wq", h), ("wk", kh), ("wv", kh)):
        out.append((seg + ("attn", name, "w"), (L, d, heads, hd), d ** -0.5))
        if run["qkv_bias"]:
            out.append((seg + ("attn", name, "b"), (L, heads, hd), BIAS_STD))
    out.append((seg + ("attn", "wo", "w"), (L, h * hd, d), (h * hd) ** -0.5))
    moe = run.get("moe")
    if moe is None:
        out += _mlp(seg + ("mlp",), L, d, run["d_ff"])
    else:
        e, f = moe["n_experts"], moe["d_ff_expert"]
        m = seg + ("moe",)
        out += [(m + ("router", "w"), (L, d, e), d ** -0.5),
                (m + ("w_up",), (L, e, d, f), d ** -0.5),
                (m + ("w_gate",), (L, e, d, f), d ** -0.5),
                (m + ("w_down",), (L, e, f, d), f ** -0.5)]
        if moe["n_shared"]:
            out += _mlp(m + ("shared",), L, d, moe["d_ff_shared"])
    out.append((("final_norm", "scale"), (d,), NORM_STD))
    if not run["tie_embeddings"]:
        out.append((("head", "w"), (d, v), d ** -0.5))
    return out


def _mlp(prefix, L, d, f):
    return [(prefix + ("wi", "w"), (L, d, f), d ** -0.5),
            (prefix + ("wg", "w"), (L, d, f), d ** -0.5),
            (prefix + ("wo", "w"), (L, f, d), f ** -0.5)]


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
    return out + [(batch, run["d_model"], padded_vocab(run), checked)]


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


def flash_launches(run: dict, batch: int, prompt: int, checked: bool = True
                   ) -> List[Tuple[int, int, int, int, int, int, int]]:
    """One causal launch a layer over the whole prompt, q, k and v of one
    head width (decode attention is plain PyTorch, not this kernel)."""
    hd = run["head_dim"]
    return [(batch, prompt, prompt, run["n_heads"], run["n_kv_heads"], hd,
             hd)] * run["n_layers"]


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


def pair_flops(run: dict) -> List[int]:
    """q·k and p·v over the head width, for every head: 4 · H · dh a pair,
    each layer alike."""
    return [4 * run["n_heads"] * run["head_dim"]] * run["n_layers"]
