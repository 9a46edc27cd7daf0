"""Guarded GAT serving: attention-weighted aggregation as a checked op.

Counterpart of the JAX package's ``repro/engine/gat.py``.  A GAT layer is
``H' = A (H W)`` where the attention matrix A is a row-softmax of LeakyReLU
pairwise scores masked to the adjacency.  However A is *computed*, the
product itself is a three-matrix chain, so the paper's eq. 4–6 applies
verbatim:

    eᵀ(A H W)e  =  (eᵀA) · (H w_r),      w_r = W e  (folded offline)

One scalar corner per layer covers both matmuls: a corruption of
X = H·W that also perturbs A still breaks the identity, because the
predicted side re-reads H and the folded master w_r while the actual
side sums the served output.  Checks are pre-activation (ELU between
layers breaks the chain, exactly like ReLU in the GCN stack).

Where the work runs: both dense products of a layer go through the
``matmul_abft`` kernel (the CUDA kernel for tensors on the card, its plain
version on the CPU), as every dense product of the port does.  The first
launch takes ``b_r = w_r``, so one launch gives ``X = H W`` and eq. 5's
``H w_r`` (its extra column); the second is ``att @ X``.  The kernel's C
does not depend on the extra column, so the unguarded forward (no column)
serves the same bits.  The scores and the row softmax over n x n are plain
PyTorch, as the reference computes them outside any Pallas kernel.

:class:`GATEngine` serves layers under the same
:class:`~repro_torch.runtime.abft_guard.ABFTGuard` restore→retry→suspect
ladder as the GCN and LM engines, keyed by ``op:gat{i}`` sites.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.abft import (
    ABFTConfig,
    Check,
    CheckedOp,
    fold_w_r_tree,
    per_op_report,
    resolve_w_r,
    summarize,
)
from repro_torch.core.checksum import col_checksum
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.matmul_abft.kernel import matmul_abft_kernel
from repro_torch.runtime.abft_guard import ABFTGuard, GuardConfig

Tensor = torch.Tensor
Params = Dict[str, Any]

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_gat(generator: Optional[torch.Generator], dims: Tuple[int, ...], *,
             device: DeviceLike = "cuda") -> Params:
    """dims = (f_in, g1, ..., gL): L layers, each {w [f,g], a_l [g],
    a_r [g]} — w ~ N(0, 1/f), a_l and a_r ~ N(0, 0.01), drawn in that
    order, layer by layer, from ``generator`` (on its device) and moved to
    ``device``.  ``device="meta"`` builds the shapes alone (``generator``
    unused)."""
    dev = resolve_device(device)
    layers = []
    for i in range(len(dims) - 1):
        f, g = dims[i], dims[i + 1]
        if dev.type == "meta":
            layers.append({k: torch.empty(shape, device=dev)
                           for k, shape in (("w", (f, g)), ("a_l", (g,)),
                                            ("a_r", (g,)))})
            continue
        gd = generator.device
        w = torch.randn((f, g), generator=generator, device=gd) / math.sqrt(f)
        a_l = torch.randn((g,), generator=generator, device=gd) * 0.1
        a_r = torch.randn((g,), generator=generator, device=gd) * 0.1
        layers.append({"w": w.to(dev), "a_l": a_l.to(dev),
                       "a_r": a_r.to(dev)})
    return {"layers": layers}


def fold_gat_w_r(params: Params, cfg: ABFTConfig) -> Params:
    """Offline eq.-5 fold for every layer's W (tree-generic; a_l/a_r are
    1-D and pass through untouched).  The returned tree shares the weight
    tensors with ``params``."""
    return fold_w_r_tree(params, cfg)


# ---------------------------------------------------------------------------
# layer / forward
# ---------------------------------------------------------------------------

def gat_layer(p: Params, h: Tensor, adj: Tensor, cfg: ABFTConfig, *,
              w_r: Optional[Tensor] = None,
              inject: Optional[float] = None
              ) -> Tuple[Tensor, Optional[Check]]:
    """One GAT layer (single head).  h: [n, f]; adj: [n, n] (nonzero =
    edge, self-loops included by the caller).  Returns pre-activation
    (out, Check|None).

    ``inject`` is the accumulator fault operand: a scalar delta added to
    out[0, 0] *after* the aggregation.  The actual side sums the served
    output after that point (the kernel's own block sums of ``att @ X``
    are taken before it and would hide the upset); the predicted corner
    comes from the operands, so the upset is strictly detectable."""
    w = p["w"].to(h.dtype)
    wr = resolve_w_r(p["w"], w_r if w_r is not None else p.get("w_r"), cfg)
    br = None if wr is None else wr.reshape(-1).to(torch.float32)
    # one launch: X = H W and, with the check on, its extra column H w_r
    x, _, hw_r = matmul_abft_kernel(h.contiguous(), w.contiguous(),
                                    None if br is None else br.contiguous())
    scores = (x @ p["a_l"].to(x.dtype))[:, None] \
        + (x @ p["a_r"].to(x.dtype))[None, :]
    scores = F.leaky_relu(scores, 0.2, inplace=True)
    scores = scores.masked_fill_(~(adj > 0), _NEG_INF)
    att = torch.softmax(scores, dim=-1)                  # [n, n] rows sum 1
    del scores
    out, _, _ = matmul_abft_kernel(att, x)               # out = att @ X
    if inject is not None:
        out[0, 0] += torch.as_tensor(inject, dtype=out.dtype,
                                     device=out.device)
    if not cfg.enabled:
        return out, None
    pred = torch.dot(col_checksum(att, cfg.dtype), hw_r[:, 0].to(cfg.dtype))
    actual = out.to(cfg.dtype).sum()
    return out, Check(predicted=pred, actual=actual)


class GATLayerOp(CheckedOp):
    """The GAT layer as a protocol checked op (layer granularity)."""

    op_id = "gat_layer"
    granularity = "layer"

    def __call__(self, cfg: ABFTConfig, h: Tensor, adj: Tensor, p: Params,
                 **folded):
        return gat_layer(p, h, adj, cfg, w_r=folded.get("w_r"))


def gat_forward(params: Params, h: Tensor, adj: Tensor, cfg: ABFTConfig, *,
                inject_layer: Optional[int] = None,
                inject_delta: Optional[float] = None
                ) -> Tuple[Tensor, List[Optional[Check]]]:
    """Multi-layer GAT with ELU between layers; checks pre-activation.
    ``inject_delta`` fires in the one layer whose index is
    ``inject_layer`` (none when it is ``None``)."""
    checks: List[Optional[Check]] = []
    n_layers = len(params["layers"])
    for i, p in enumerate(params["layers"]):
        inj = inject_delta if inject_delta is not None \
            and inject_layer is not None and int(inject_layer) == i else None
        h, c = gat_layer(p, h, adj, cfg, inject=inj)
        checks.append(c)
        if i < n_layers - 1:
            h = F.elu(h)
    return h, checks


# ---------------------------------------------------------------------------
# guarded serving
# ---------------------------------------------------------------------------

def make_gat_serve_step(cfg: ABFTConfig) -> Callable:
    """``step(params, h, adj, inject_layer=-1, inject_delta=0.0)
    -> (out, metrics)`` with per-op verdicts keyed ``gat{i}`` — the
    :meth:`ABFTGuard.run_step` metrics shape."""

    def step(params, h, adj, inject_layer=-1, inject_delta=0.0):
        out, checks = gat_forward(params, h, adj, cfg,
                                  inject_layer=int(inject_layer),
                                  inject_delta=float(inject_delta))
        rep = summarize([c for c in checks if c is not None], cfg,
                        device=out.device)
        ids, op_flags, op_rel = per_op_report(checks, cfg, prefix="gat",
                                              device=out.device)
        return out, {"abft_flag": rep.flag, "abft_max_rel": rep.max_rel,
                     "abft_op_ids": ids, "abft_op_flags": op_flags,
                     "abft_op_rel": op_rel}

    return step


class GATEngine:
    """Guarded GAT serving, mirroring :class:`~repro_torch.engine.lm.LMEngine`:
    pristine master params, folded working copy, and the
    restore→retry→suspect ladder with ``op:gat{i}`` sites.  The working tree
    shares its weight tensors with the master, so a weight fault must
    replace a leaf of ``eng.params``, never write into a shared tensor."""

    def __init__(self, cfg: ABFTConfig, params: Params, *,
                 guard_cfg: Optional[GuardConfig] = None):
        self.cfg = cfg
        self._master = params
        self.params = fold_gat_w_r(params, cfg)
        self.guard = ABFTGuard(guard_cfg or GuardConfig(),
                               restore_fn=self._restore)
        self._step = make_gat_serve_step(cfg)

    @classmethod
    def init(cls, cfg: ABFTConfig, generator: torch.Generator,
             dims: Tuple[int, ...], *, device: DeviceLike = "cuda", **kw
             ) -> "GATEngine":
        return cls(cfg, init_gat(generator, dims, device=device), **kw)

    def _restore(self) -> Params:
        self.params = fold_gat_w_r(self._master, self.cfg)
        return self.params

    def forward(self, h: Tensor, adj: Tensor, *, inject_layer: int = -1,
                inject_delta: float = 0.0) -> Tuple[Tensor, dict]:
        """One guarded forward.  An inject operand fires once (the
        transient-fault convention — retries re-execute clean)."""
        box = {"l": int(inject_layer), "d": float(inject_delta)}

        def step(params, h_, adj_):
            l, d = box["l"], box["d"]
            box["l"], box["d"] = -1, 0.0
            return self._step(params, h_, adj_, l, d)

        out, m = self.guard.run_step(step, self.params, h, adj)
        return out, m

    def stats(self) -> dict:
        s = {"steps": self.guard.steps, "flags": self.guard.flags,
             "retries": self.guard.retries, "restores": self.guard.restores,
             "flag_rate": self.guard.flag_rate}
        s.update(self.guard.repair_tiers())
        return s
