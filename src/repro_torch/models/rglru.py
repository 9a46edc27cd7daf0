"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Counterpart of the JAX package's ``repro/models/rglru.py``::

    i_t = sigmoid(W_x x_t)         input gate
    r_t = sigmoid(W_a x_t)         recurrence gate
    a_t = exp(-c · softplus(Λ) · r_t)          per-channel decay, c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The block is proj-in → causal depthwise conv (width K) → RG-LRU, gated by a
parallel GeLU branch → proj-out.  As in RWKV6, the data-dependent diagonal
recurrence breaks the fused chain, so the products carry split checks:
proj_x, proj_gate and proj_out through
:func:`~repro_torch.models.common.dense` (``matmul_abft``), and the two
block-diagonal gates through ``matmul_abft``'s grouped launch — 16 groups
``[B·T, dr/16] @ [dr/16, dr/16]`` in one launch, its one check over all
groups exactly the reference's ``Σ_g (eᵀA_g)(B_g e)`` against ``Σ y``.  The
reference computes the gates with ``jnp.einsum`` outside any kernel; the
port keeps every checked product on the one kernel, so each is summed in
one fixed order on the card.  The gates' ``b_r = w.sum(-1)`` are summed
from the weights on every call, as the reference does (neither package
folds them: a post-load flip in a gate weight enters both sides and
cancels, ROADMAP C8).

The scan is a Python loop over time steps with the reference's per-step
arithmetic (a multiply, then an add); the gated input ``gx`` does not
depend on the step and is computed for all steps at once.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft import ABFTConfig, Check
from repro_torch.kernels import acc_dtype
from repro_torch.kernels.matmul_abft.ops import matmul_abft_grouped
from repro_torch.models.common import dense, gelu, gen_device, init_dense, \
    trunc_normal

Tensor = torch.Tensor
Params = Dict[str, Any]

RGLRU_C = 8.0
GATE_BLOCKS = 16       # Griffin's block-diagonal gate matrices


def _d_rnn(cfg: ModelConfig) -> int:
    return cfg.rglru_d or cfg.d_model


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig,
                     lead: Tuple[int, ...] = ()) -> Params:
    d, dr = cfg.d_model, _d_rnn(cfg)
    r = dr // GATE_BLOCKS
    dev = gen_device(gen)
    lam = torch.linspace(0.3, 1.5, dr, dtype=torch.float32, device=dev)
    return {
        "proj_x": init_dense(gen, d, dr, lead=lead),
        "proj_gate": init_dense(gen, d, dr, lead=lead),
        "proj_out": init_dense(gen, dr, d, lead=lead),
        "conv_w": trunc_normal(gen, (*lead, cfg.conv1d_width, dr), 0.3),
        "conv_b": torch.zeros((*lead, dr), dtype=torch.float32, device=dev),
        "gate_x": {"w": trunc_normal(gen, (*lead, GATE_BLOCKS, r, r),
                                     r ** -0.5)},
        "gate_a": {"w": trunc_normal(gen, (*lead, GATE_BLOCKS, r, r),
                                     r ** -0.5)},
        # Λ so that softplus(Λ)·c gives decays in a useful range
        "lam": lam.expand(*lead, dr).clone(),
    }


def _conv1d(x: Tensor, w: Tensor, b: Tensor, x_hist: Tensor
            ) -> Tuple[Tensor, Tensor]:
    """Causal depthwise conv, width K.  x: [B, T, dr]; x_hist: [B, K-1, dr]
    from the previous segment.  Returns (y, new history)."""
    k, t = w.shape[0], x.shape[1]
    xfull = torch.cat([x_hist.to(x.dtype), x], dim=1)
    y = xfull[:, 0:t] * w[0].to(x.dtype)
    for i in range(1, k):
        y = y + xfull[:, i:i + t] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    return y, (xfull[:, -(k - 1):].clone() if k > 1 else x_hist)


def _rglru_scan(x: Tensor, i_gate: Tensor, a: Tensor, h0: Tensor
                ) -> Tuple[Tensor, Tensor]:
    """h_t = a_t h_{t-1} + sqrt(1 - a_t²)(i_t ⊙ x_t).  All [B, T, dr];
    h0 [B, dr].  Returns (every h_t [B, T, dr], the last)."""
    gx = i_gate * x * torch.sqrt(torch.clamp_min(1.0 - torch.square(a),
                                                 1e-9)).to(x.dtype)
    a32 = a.to(acc_dtype(x.dtype))
    g32 = gx.to(acc_dtype(x.dtype))
    h = h0
    ys = []
    for t in range(x.shape[1]):
        h = a32[:, t] * h + g32[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1), h


def _block_diag_dense(p: Params, x: Tensor, abft: ABFTConfig
                      ) -> Tuple[Tensor, List[Check]]:
    """y[..., n, s] = x[..., n, r] @ w[n, r, s]  (block-diagonal gates): one
    grouped ``matmul_abft`` launch over the n blocks, on a [n, M, r] copy of
    ``x`` (M = the rows of ``x``), and one copy of y back."""
    nb, r, _ = p["w"].shape
    xb = x.reshape(-1, nb, r).transpose(0, 1).contiguous()   # [nb, M, r]
    w = p["w"].to(x.dtype)
    br = w.to(abft.dtype).sum(-1) if abft.enabled else None   # [nb, r]
    y, chk, _ = matmul_abft_grouped(xb, w, br)
    y = y.transpose(0, 1).reshape(x.shape)
    return y, ([chk] if chk is not None else [])


def rglru_block(p: Params, x: Tensor, cfg: ModelConfig, abft: ABFTConfig,
                state: Dict[str, Tensor]
                ) -> Tuple[Tensor, Dict[str, Tensor], List[Check]]:
    """x: [B, T, d]; state = {'h': [B, dr] f32, 'conv': [B, K-1, dr]}.
    Returns (y, new state, checks: proj_x, proj_gate, gate_x, gate_a,
    proj_out)."""
    del cfg
    xr, c1 = dense(p["proj_x"], x, abft)
    gate, c2 = dense(p["proj_gate"], x, abft)
    xr, conv_hist = _conv1d(xr, p["conv_w"], p["conv_b"], state["conv"])

    ig, c3 = _block_diag_dense(p["gate_x"], xr, abft)
    rg, c4 = _block_diag_dense(p["gate_a"], xr, abft)
    i_gate = torch.sigmoid(ig)
    f32 = acc_dtype(rg.dtype)
    log_a = -RGLRU_C * F.softplus(p["lam"]).to(f32) * \
        torch.sigmoid(rg.to(f32))
    a = torch.exp(log_a)

    ys, h = _rglru_scan(xr, i_gate, a.to(xr.dtype), state["h"])
    out = ys.to(x.dtype) * gelu(gate)
    y, c5 = dense(p["proj_out"], out, abft)
    # the history in float32, as the zero state holds it (float64 in a
    # witness run)
    new_state = {"h": h, "conv": conv_hist.to(acc_dtype(conv_hist.dtype))}
    return y, new_state, c1 + c2 + c3 + c4 + c5


def rglru_state_init(cfg: ModelConfig, batch: int,
                     device=None) -> Dict[str, Tensor]:
    dr = _d_rnn(cfg)
    return {
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, dr),
                            dtype=torch.float32, device=device),
    }
