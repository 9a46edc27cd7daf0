"""Guarded transformer LM serving on the checked-op protocol.

Counterpart of the JAX package's ``repro/engine/lm.py``.  The eq. 4–6
algebra that checks a GCN layer checks every linear chain of a transformer
step: the QKV / attention-out / MLP / head products are checked ops (split
corners from :class:`~repro_torch.kernels.matmul_abft.ops.MatmulAbftOp`, the
``matmul_abft`` kernel on the card), attention is the fused chain
``eᵀ(A V W_o)e = Σ o_extra`` with the carried column ``vr = V·w_or`` (the
``flash_checksum`` kernel in prefill).  This module adds the serving shell:

* :func:`fold_lm_w_r` — one offline pass at weight load folding every dense
  weight to its right checksum ``w_r``, so the predicted side of every check
  comes from the *master* weights and post-load corruption is detectable;
* :func:`make_guarded_prefill_step` / :func:`make_guarded_decode_step` —
  steps that emit per-op verdict vectors (``abft_op_flags`` aligned to the
  ``abft_op_ids`` tuple) beside the scalar ``abft_flag``, in the metrics
  shape :class:`ABFTGuard` adjudicates;
* :class:`LMEngine` — holds the pristine master params and serves
  prefill/decode under the guard's retry → restore ladder.

Checks are side computations: guarded logits are bit-identical to the
unguarded forward on clean runs (the same kernels compute the products and
the attention output with or without the check columns).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft import ABFTConfig, fold_w_r_tree, per_op_report
from repro_torch.device import DeviceLike
from repro_torch.models.common import cdtype
from repro_torch.models.transformer import (
    init_model,
    model_decode,
    model_prefill,
)
from repro_torch.runtime.abft_guard import ABFTGuard, GuardConfig
from repro_torch.runtime.spans import span

Tensor = torch.Tensor
Params = Dict[str, Any]


def fold_lm_w_r(params: Params, cfg: ModelConfig, abft: ABFTConfig) -> Params:
    """Fold right checksums into an LM param tree at weight load.

    Segment trees are layer-stacked on a leading axis, so they fold with
    ``lead_axes=1``: ``w [L, d_in, *out] -> w_r [L, d_in]``, sliced per
    layer to the ``[d_in]`` vector :func:`~repro_torch.models.common.dense`
    consumes.  The head folds flat, an encoder's segments as the decoder's
    (a decoder layer's cross-attention ``xattn`` lies in its segment).
    Folds are taken through the compute dtype so the comparison sees the
    quantization the product does.  The embed table is left alone — the
    tied head checks against the table directly.  In an MoE layer the
    router and the shared experts fold (their ``"w"`` leaves); the stacked
    expert weights ``w_up``, ``w_gate``, ``w_down`` are not ``"w"`` leaves
    and do not, as in the reference — ``moe_block`` sums their ``b_r`` on
    every call.  Returns a new tree that shares the weight tensors with
    ``params``; ``params`` is not mutated (so a fault must replace a leaf of
    the returned tree, never write into a shared tensor)."""
    if not abft.enabled:
        return params
    cdt = cdtype(cfg)
    out = dict(params)
    out["segments"] = [fold_w_r_tree(seg, abft, lead_axes=1,
                                     compute_dtype=cdt)
                       for seg in params["segments"]]
    if "head" in params:
        out["head"] = fold_w_r_tree(params["head"], abft, compute_dtype=cdt)
    if isinstance(params.get("encoder"), dict):
        enc = dict(params["encoder"])
        if "segments" in enc:
            enc["segments"] = [fold_w_r_tree(seg, abft, lead_axes=1,
                                             compute_dtype=cdt)
                               for seg in enc["segments"]]
        out["encoder"] = enc
    return out


def _metrics(rep, checks, abft: ABFTConfig, device) -> dict:
    with span("model.report"):
        ids, op_flags, op_rel = per_op_report(checks, abft, prefix="op",
                                              device=device)
    return {"abft_flag": rep.flag, "abft_max_rel": rep.max_rel,
            "abft_op_ids": ids, "abft_op_flags": op_flags,
            "abft_op_rel": op_rel}


def make_guarded_prefill_step(cfg: ModelConfig, abft: ABFTConfig,
                              cache_len: int) -> Callable:
    """``step(params, batch, inject=0.0) -> ((logits, states), metrics)`` —
    the :meth:`ABFTGuard.run_step` shape, with per-op verdicts.  ``inject``
    is the attention-accumulator fault (0.0 = clean)."""

    def step(params, batch, inject=0.0):
        logits, states, rep, checks = model_prefill(
            params, cfg, batch, abft, cache_len,
            return_checks=True, attn_inject=float(inject))
        return (logits, states), _metrics(rep, checks, abft, logits.device)

    return step


def make_guarded_decode_step(cfg: ModelConfig, abft: ABFTConfig) -> Callable:
    """``step(params, states, tokens, pos, inject=0.0) -> ((logits, states),
    metrics)`` with per-op verdicts (see :func:`make_guarded_prefill_step`)."""

    def step(params, states, tokens, pos, inject=0.0):
        # int(pos) reads the position on the host: ROADMAP rule-2 item 1's
        # known sync, which goes when a decode step becomes a CUDA graph
        logits, new_states, rep, checks = model_decode(
            params, cfg, states, tokens, int(pos), abft,  # abftlint: sync-ok (ROADMAP rule-2 item 1)
            return_checks=True, attn_inject=float(inject))
        return (logits, new_states), _metrics(rep, checks, abft,
                                              logits.device)

    return step


class LMEngine:
    """Guarded LM serving: prefill + decode under the ABFT ladder.

    Keeps the pristine master params; the working copy carries the folded
    checksums.  ``restore_fn`` refolds from the master — this both rewinds
    any in-memory weight corruption of the working tree and refreshes every
    ``w_r``, and its return value is adopted as the step's params operand by
    :meth:`ABFTGuard.run_step`'s checkpoint-rollback convention.
    """

    def __init__(self, cfg: ModelConfig, abft: ABFTConfig, params: Params,
                 *, cache_len: int = 128,
                 guard_cfg: Optional[GuardConfig] = None):
        self.cfg = cfg
        self.abft = abft
        self.cache_len = cache_len
        self._master = params
        self.params = fold_lm_w_r(params, cfg, abft)
        self.guard = ABFTGuard(guard_cfg or GuardConfig(),
                               restore_fn=self._restore)
        self._prefill = make_guarded_prefill_step(cfg, abft, cache_len)
        self._decode = make_guarded_decode_step(cfg, abft)

    @classmethod
    def init(cls, cfg: ModelConfig, abft: ABFTConfig, generator=0, *,
             device: DeviceLike = "cuda", **kw) -> "LMEngine":
        """An engine over random params (:func:`init_model`; ``generator``
        is a seed or a ``torch.Generator``)."""
        return cls(cfg, abft, init_model(cfg, generator, device=device), **kw)

    def _restore(self) -> Params:
        self.params = fold_lm_w_r(self._master, self.cfg, self.abft)
        return self.params

    @staticmethod
    def _fire_once(inject: float):
        """A transient fault strikes one execution, not every replay: the
        inject value is consumed by the first attempt, so the guard's retry
        re-executes clean (persistent faults live in the params and survive
        retries on their own)."""
        box = {"v": float(inject)}

        def pop():
            v, box["v"] = box["v"], 0.0
            return v
        return pop

    def prefill(self, tokens: Tensor, *, inject: float = 0.0
                ) -> Tuple[Tensor, List[Params], dict]:
        """Run the prompt under the guard.  Returns (last-token logits,
        decode states, metrics)."""
        pop = self._fire_once(inject)
        with span("engine.prefill"):
            (logits, states), m = self.guard.run_step(
                lambda params, batch: self._prefill(params, batch, pop()),
                self.params, {"tokens": tokens})
        return logits, states, m

    def decode(self, states: List[Params], tokens: Tensor, pos,
               *, inject: float = 0.0
               ) -> Tuple[Tensor, List[Params], dict]:
        """One guarded decode step.  tokens: [B,1]; pos: its position."""
        pop = self._fire_once(inject)
        with span("engine.decode"):
            (logits, new_states), m = self.guard.run_step(
                lambda params, states_, tokens_, pos_:
                    self._decode(params, states_, tokens_, pos_, pop()),
                self.params, states, tokens, pos)
        return logits, new_states, m

    def generate(self, tokens: Tensor, n_steps: int,
                 *, inject_at: Optional[int] = None,
                 inject_delta: float = 0.0) -> Tuple[Tensor, dict]:
        """Greedy generation: prefill then ``n_steps`` decode steps.
        ``inject_at`` fires the accumulator fault on that decode step (−1 =
        during prefill).  Returns ([B, n_steps] token ids, final stats)."""
        _b, t = tokens.shape
        inj = inject_delta if inject_at == -1 else 0.0
        logits, states, _ = self.prefill(tokens, inject=inj)
        outs = []
        for i in range(n_steps):
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            outs.append(nxt)
            inj = inject_delta if inject_at == i else 0.0
            logits, states, _ = self.decode(states, nxt[:, None], t + i,
                                            inject=inj)
        return torch.stack(outs, dim=1), self.stats()

    def stats(self) -> dict:
        s = {"steps": self.guard.steps, "flags": self.guard.flags,
             "retries": self.guard.retries, "restores": self.guard.restores,
             "flag_rate": self.guard.flag_rate}
        s.update(self.guard.repair_tiers())
        return s
