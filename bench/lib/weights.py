"""Weights drawn on the device from the run's seed, in the param-tree layout
the program's ``LMEngine`` takes: ``{"embed": {"table"}, "segments": [{"b0":
{...}}], "final_norm": {"scale"}, "head": {"w"}}`` with every layer leaf
stacked on a leading axis of ``n_layers``.

One ``normal_`` call a leaf on a CUDA generator, float32 (the served type):
weights ``N(0, 1 / d_in)``, biases ``N(0, 0.02^2)``, norm scales (held as
``1 + scale``) ``N(0, 0.1^2)``, the embedding ``N(0, 1)``."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench.lib import seeds

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


def draw(run: dict, seed: int, device) -> Dict:
    """The param tree for ``run`` from ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(
        seeds.stream(seed, "weights"))
    tree: Dict = {}
    for path, shape, std in leaf_specs(run):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t.normal_(0.0, std, generator=gen)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    tree["segments"] = [tree["segments"]["0"]]
    return tree
