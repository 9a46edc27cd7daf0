"""Mixture-of-Experts with top-k routing, capacity, shared experts — and the
paper's fused ABFT chain on the combine path.

Counterpart of the JAX package's ``repro/models/moe.py``, with its
semantics kept exactly: an f32 softmax over the router logits, ``top_k``,
the gates renormalised by ``max(Σ, 1e-9)``, the Switch load-balancing aux
loss, capacity ``max(int(N·k·cf/E), k)`` with cumsum slot positions and
GShard drops, the dispatch into ``[E, cap, d]``, the gather and the
gate-weighted combine, and the shared experts as a dense MLP beside them.

The combine step is structurally the GCN aggregation: ``Y = C · Z`` where
C [T, E·cap] is the sparse gate/combine matrix and ``Z = G · W₂`` the
per-expert down-projections.  GCN-ABFT eq. (4) fuses the check::

    eᵀ(C · G · W₂)e = (eᵀC) · G · (W₂ e)

On the card every expert product is one launch of ``matmul_abft``'s grouped
kernel over all E experts (up, gate and down: three a layer), given each
expert's count of kept assignments — they fill its capacity rows from 0,
so the kernel skips the rows past the count and the experts with none
(the counts stay on the device; the rows they skip are zeros here, so
every output is the one without them, bit for bit) — and the down
launch's extra column with ``b_r = W₂ e`` **is** the reference's
``z_extra = G_e @ w2r_e`` — the fused check costs the kernel's one extra
column.  The router and the shared experts go through
:func:`~repro_torch.models.common.dense` (``matmul_abft``).  The expert
``b_r`` are summed from the weights on every call, as the reference does:
neither package folds expert weights (``fold_w_r_tree`` folds ``"w"``
leaves only), so a post-load flip in ``w_up``, ``w_gate`` or ``w_down``
enters both sides of every MoE check and cancels (ROADMAP C6).

Determinism: no atomics.  The dispatch writes each kept (token, slot) to
its own row of a flat ``[E·cap + 1, d]`` buffer — dropped ones to the
dummy last row, which is cut off, so no zero overwrites the token that
really holds slot ``cap − 1`` — and the combine gathers ``z[e, slot]`` and
sums over k in one fixed order.  The reference's ``_pin_experts`` is a
sharding hint for an expert-parallel mesh; on one card it has no
counterpart and is left out.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft import ABFTConfig, Check
from repro_torch.kernels.matmul_abft.ops import matmul_abft_grouped
from repro_torch.models.common import dense, init_dense, trunc_normal
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.runtime.spans import count, recording, span

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             lead: Tuple[int, ...] = ()) -> Params:
    mc = cfg.moe
    d, f, e = cfg.d_model, mc.d_ff_expert, mc.n_experts
    p = {
        "router": init_dense(gen, d, e, lead=lead),
        "w_up": trunc_normal(gen, (*lead, e, d, f), d ** -0.5),
        "w_gate": trunc_normal(gen, (*lead, e, d, f), d ** -0.5),
        "w_down": trunc_normal(gen, (*lead, e, f, d), f ** -0.5),
    }
    if mc.n_shared:
        shared_ff = mc.d_ff_shared or mc.n_shared * mc.d_ff_expert
        p["shared"] = init_mlp(gen, cfg, d_ff=shared_ff, lead=lead)
    return p


def _capacity(tokens: int, mc) -> int:
    cap = int(tokens * mc.top_k * mc.capacity_factor / mc.n_experts)
    return max(cap, mc.top_k)


def route(p: Params, xt: Tensor, cfg: ModelConfig, abft: ABFTConfig
          ) -> Tuple[Tensor, Tensor, Tensor, List[Check]]:
    """The router: ``xt`` [N, d] -> (probs [N, E] f32, renormalised gates
    [N, k], experts [N, k] in descending probability, the router's
    checks)."""
    logits, checks = dense(p["router"], xt, abft)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate_vals, experts = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, experts, checks


def assign(experts: Tensor, mc) -> Tuple[Tensor, Tensor, Tensor, int]:
    """Capacity assignment: (flat experts [N·k], each (token, slot)'s
    position in its expert [N·k], kept [N·k], capacity).  Positions count
    the expert's earlier assignments in (token, slot) order (an exact
    integer cumsum); those at or past the capacity are dropped."""
    n_tok = experts.shape[0]
    cap = _capacity(n_tok, mc)
    flat_expert = experts.reshape(-1)
    onehot = F.one_hot(flat_expert, mc.n_experts).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0) * onehot - 1
    slot_pos = pos_in_e.max(dim=1).values
    return flat_expert, slot_pos, slot_pos < cap, cap


def expert_rows(flat_expert: Tensor, keep: Tensor, n_experts: int
                ) -> Tensor:
    """Each expert's live capacity rows, int32 [E]: its kept assignments,
    which hold its slots 0..n_e − 1 (``assign``) — counted on the device,
    with no host sync."""
    onehot = F.one_hot(flat_expert, n_experts) * keep[:, None]
    return onehot.sum(0).to(torch.int32)


def moe_block(p: Params, x: Tensor, cfg: ModelConfig, abft: ABFTConfig
              ) -> Tuple[Tensor, List[Check], Tensor]:
    """x: [B, T, d] -> (y, checks, aux_loss).  Checks in the reference's
    order: the router's, up, gate, then the fused combine (or, split, the
    down product's and the combine's), then the shared MLP's."""
    mc = cfg.moe
    b, t, d = x.shape
    n_tok = b * t
    k, n_exp = mc.top_k, mc.n_experts
    xt = x.reshape(n_tok, d)
    checks: List[Check] = []

    # --- routing
    with span("moe.route"):
        probs, gate_vals, experts, rc = route(p, xt, cfg, abft)
        checks += rc
        # load-balancing auxiliary loss (Switch-style)
        me = probs.mean(0)
        ce = F.one_hot(experts[:, 0], n_exp).to(torch.float32).mean(0)
        aux = n_exp * torch.sum(me * ce)

    # --- capacity assignment
    with span("moe.assign"):
        flat_expert, slot_pos, keep, cap = assign(experts, mc)
        gate_keep = torch.where(keep, gate_vals.reshape(-1),
                                torch.zeros_like(gate_vals.reshape(-1)))
        rows = expert_rows(flat_expert, keep, n_exp)
    if recording():
        # live rows equal the kept assignments (slots fill from 0)
        count("moe.assignments", n_tok * k)
        count("moe.kept", keep.sum())
        count("moe.capacity_rows", n_exp * cap)

    # --- dispatch: kept (token, slot)s to their own rows of [E·cap, d],
    # dropped ones to the dummy row E·cap, cut off
    with span("moe.dispatch"):
        tok_idx = torch.arange(n_tok, device=x.device).repeat_interleave(k)
        row = torch.where(keep, flat_expert * cap + slot_pos,
                          torch.full_like(slot_pos, n_exp * cap))
        flat = torch.zeros((n_exp * cap + 1, d), dtype=xt.dtype,
                           device=x.device).index_put((row,), xt[tok_idx])
        buf = flat[:n_exp * cap].view(n_exp, cap, d)

    # --- expert MLPs: one grouped launch a product over all E experts,
    # each multiplying its live rows only (silu(0)·0 = 0: the down
    # product's rows past the counts are zeros too)
    on = abft.enabled
    brs = [None] * 3
    if on:
        with span("moe.br"):
            brs = [p[w].to(abft.dtype).sum(-1)
                   for w in ("w_up", "w_gate", "w_down")]
            # an expert whose weights are not all finite multiplies every
            # row, as the reference's einsum does, so that 0·Inf and 0·NaN
            # reach the checks (the down product's too) exactly as there
            finite = sum(br.sum(-1) for br in brs).isfinite()
            rows = torch.where(finite, rows, cap)
    with span("moe.experts"):
        w_up = p["w_up"].to(buf.dtype)
        w_gate = p["w_gate"].to(buf.dtype)
        up, c_up, _ = matmul_abft_grouped(buf, w_up, brs[0], rows)
        gt, c_gate, _ = matmul_abft_grouped(buf, w_gate, brs[1], rows)
        g = F.silu(gt) * up                                 # [E, cap, f]
        # the down launch's extra column with b_r = W₂ e is z_extra [E, cap]
        z, c_down, z_extra = matmul_abft_grouped(
            g, p["w_down"].to(g.dtype), brs[2], rows)
    if on:
        checks += [c_up, c_gate]

    # --- combine: Y = C · Z, a gather and a gate-weighted sum over k
    with span("moe.combine"):
        safe_slot = torch.where(keep, slot_pos,
                                torch.full_like(slot_pos, cap - 1))
        gather = flat_expert * cap + safe_slot
        zg = z.reshape(n_exp * cap, d)[gather]              # [N·k, d]
        y = (gate_keep[:, None].to(z.dtype) * zg).reshape(n_tok, k,
                                                          d).sum(1)

        if on:
            gk = gate_keep.to(abft.dtype)
            actual = y.to(abft.dtype).sum()
            if abft.mode == "fused":
                # eᵀ(C·G·W₂)e = (eᵀC)·G·(W₂ e): the down launch's extra
                # column
                pred = torch.dot(gk, z_extra.reshape(-1)[gather].to(
                    abft.dtype))
                checks.append(Check(predicted=pred, actual=actual))
            else:
                # split: G @ W₂ per expert (the down launch's corners),
                # then the combine on its own
                checks.append(c_down)
                pred = torch.dot(gk, zg.to(abft.dtype).sum(-1))
                checks.append(Check(predicted=pred, actual=actual))

    y = y.reshape(b, t, d)
    # --- shared experts run densely alongside
    if "shared" in p:
        with span("moe.shared"):
            ys, sc = mlp_block(p["shared"], x, cfg, abft)
            y = y + ys
        checks += sc
    return y, checks, aux
