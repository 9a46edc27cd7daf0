"""Unified GCN engine: one entry point, backend-dispatched aggregation.

This module is the ONE place where the paper's check algebra lives:

  * eq. (5): the extra column x_r = H w_r formed during the combination;
  * eq. (4)/(6): the fused corner comparison s_c H w_r vs e^T H_out e,
    produced by the backend's ``aggregate(x, x_r)``;
  * split baseline (eqs. 2–3): the per-matmul check of X = H W plus the
    same aggregation corner;
  * ReLU chain-breaking: checks are taken pre-activation; every layer is
    one linear chain, activations end it (paper §III);
  * report reduction: ``summarize`` / ``merge_reports`` from core.abft.

Counterpart of the JAX package's ``repro/engine/api.py``.

    logits, report = gcn_apply(params, Graph(bell, h0), cfg,
                               backend="block_ell", fused_layer=True)
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.core.abft import (
    ABFTConfig,
    ABFTReport,
    Check,
    fold_w_r_tree,
    resolve_w_r,
    summarize,
)
from repro_torch.device import DeviceLike, resolve_device

from .backends import AggregationBackend, make_backend

Tensor = torch.Tensor
Params = Any


@dataclasses.dataclass
class Graph:
    """One graph as the engine consumes it.

    ``s`` is the normalized adjacency in any backend format (dense array or
    tensor, or host-side BlockEll / PackedGraphs); ``h0`` the dense node
    features (tensor or numpy array — moved to the engine's device);
    ``s_c`` the optional offline column checksum e^T S (precompute once per
    static graph — computed once and auto-stashed back here on the first
    ``gcn_forward`` call when absent).  Dense ``s``/``h0`` may carry
    leading batch axes (batched multi-graph serving).

    The auto-stash assumes a *static* graph: it is invalidated when ``s``
    is rebound to a new object or the checksum dtype changes, but cannot
    see in-place mutation of ``s`` — mutate-in-place callers must reset
    ``s_c = None`` (or build a fresh Graph) themselves.
    """

    s: Any
    h0: Any
    s_c: Optional[Tensor] = None

    @property
    def n(self) -> int:
        return int(self.h0.shape[-2])


def gcn_layer(bk: AggregationBackend, h: Tensor, w: Tensor, cfg: ABFTConfig,
              *, w_r: Optional[Tensor] = None, return_x: bool = False
              ) -> Tuple[Tensor, List[Check]]:
    """One pre-activation GCN layer H_out = S (H W) under ABFT policy.

    The canonical eq. 4–6 algebra: ``w_r = W e`` (offline in deployment —
    pass it in to fold at weight-load time), the eq.-5 column
    ``x_r = H w_r`` taken from the *independent* path (never from row-sums
    of the computed X: a fault in X would cancel), and the backend's fused
    corner check.  ``fused`` emits that single check; ``split`` adds the
    combination-matmul check (eq. 2–3 baseline); ``none`` emits nothing.

    Backends with a whole-layer hook (:meth:`AggregationBackend.layer` —
    the block-ELL backend's single-pass fused kernel) take the fused/none
    modes without ever materializing X; the split baseline needs X for its
    combination check, so it always runs the generic two-pass path below.
    The combination ``h @ w`` and the column ``h @ w_r`` of that path are
    plain ``torch.matmul`` products outside any kernel.

    A passed-in ``w_r`` must have been folded at this config's checksum
    dtype: consuming a stale fold verbatim would silently run every check
    at the old precision, so a mismatch raises instead.

    ``return_x=True`` appends the materialized combination output X to the
    result — ``None`` when the backend's fused layer hook ran (X never
    existed).
    """
    w_r = resolve_w_r(w, w_r, cfg)
    if cfg.mode != "split":
        fused = bk.layer(h, w, cfg, w_r=w_r)
        if fused is not NotImplemented:
            h_out, chk = fused
            checks = [] if chk is None else [chk]
            return (h_out, checks, None) if return_x else (h_out, checks)
    x = h @ w
    if not cfg.enabled:
        h_out, _ = bk.aggregate(x, None)
        return (h_out, [], x) if return_x else (h_out, [])
    x_r = h.to(cfg.dtype) @ w_r
    h_out, chk = bk.aggregate(x, x_r)
    if cfg.mode == "split":
        # the backend owns the split check's granularity: generic
        # check_matmul scalars, or per-graph corners on the packed path
        checks = [bk.combination_check(h, w, x, cfg, w_r=w_r), chk]
    else:
        checks = [chk]
    return (h_out, checks, x) if return_x else (h_out, checks)


def fold_w_r(params: Params, cfg: ABFTConfig) -> Params:
    """Fold the per-layer right checksum w_r = W·e into the params, once,
    at weight-load time (the paper's "offline" eq.-5 convention).

    Without the fold :func:`gcn_forward` recomputes ``row_checksum(w)``
    every layer every step; with it, each layer carries a ``w_r`` entry in
    ``cfg.dtype`` that the layer math consumes verbatim — identical checks,
    zero per-step recompute.  Re-fold after any weight update (or if
    ``cfg.dtype`` changes).  Delegates to the tree-generic
    :func:`repro_torch.core.abft.fold_w_r_tree`.
    """
    return fold_w_r_tree(params, cfg)


def gcn_forward(params: Params, graph: Graph, cfg: ABFTConfig, *,
                backend=None, partition=None, return_intermediates=False,
                return_x=False, device: DeviceLike = "cuda",
                **backend_opts) -> Tuple[Tensor, List[Check]]:
    """Forward pass through all layers; returns (logits, per-layer checks).

    The backend is constructed once per call on ``device`` (s_c
    staged/computed once, shared by every layer) — or passed in as an
    already-built :class:`AggregationBackend` instance (the packed serving
    step builds one from staged tensors; ``device`` is then the backend's).
    For the fused/none check modes the backend's whole-network hook is
    consulted first; on ``NotImplemented`` the per-layer loop below runs
    (which in turn consults the per-layer hook).  ReLU between layers breaks
    the checksum chain, so each layer carries its own check — the paper's
    per-layer fused granularity.  Layers carrying a folded ``w_r``
    (:func:`fold_w_r`) skip the per-step row_checksum recompute.  ``params``
    must already live on the device.

    ``return_intermediates=True`` appends a result: the tuple of every
    layer's *input* activations (h_layers[0] is h0, h_layers[l] the
    post-ReLU input to layer l).  ``return_x=True`` appends one more: the
    tuple of per-layer combination outputs X (``None`` for layers a fused
    hook ran), letting a repair replay a two-pass layer's aggregation
    bit-for-bit.
    """
    if isinstance(backend, AggregationBackend):
        bk = backend
        dev = bk.device
    else:
        dev = resolve_device(device)
        s_c = graph.s_c
        if s_c is not None and getattr(graph, "_s_c_auto", False) and (
                getattr(graph, "_s_c_dtype", None) != cfg.dtype
                or getattr(graph, "_s_c_src", None) is not graph.s):
            # an auto-stash from an earlier call under a different checksum
            # dtype, or for a since-replaced adjacency operand: reusing it
            # would run this call's checks at a stale precision / against a
            # stale e^T S.  User-provided s_c is trusted verbatim.
            s_c = None
        bk = make_backend(graph.s, cfg, backend=backend, s_c=s_c,
                          partition=partition, device=dev, **backend_opts)
        if s_c is None:
            # stash the backend's column checksum back on the graph:
            # repeated gcn_apply/gcn_forward calls on the same staged Graph
            # reuse it instead of recomputing every call
            stashed = getattr(bk, "s_c", None)
            graph.s_c = stashed
            graph._s_c_auto = stashed is not None
            graph._s_c_dtype = cfg.dtype
            graph._s_c_src = graph.s
    h = torch.as_tensor(graph.h0).to(dev)
    layers = params["layers"]
    wrs: Optional[List[Optional[Tensor]]] = None
    if cfg.mode != "split":
        wrs = [resolve_w_r(layer["w"], layer.get("w_r"), cfg)
               for layer in layers]
        net = bk.network(h, [layer["w"] for layer in layers], wrs, cfg,
                         stash=return_intermediates)
        if net is not NotImplemented:
            logits, layer_checks, net_h_layers = net
            checks = [c for c in layer_checks if c is not None]
            xs = (None,) * len(layers)
            if return_intermediates:
                return ((logits, checks, net_h_layers, xs) if return_x
                        else (logits, checks, net_h_layers))
            return (logits, checks, xs) if return_x else (logits, checks)
    checks = []
    h_layers: List[Tensor] = []
    x_layers: List[Optional[Tensor]] = []
    for i, layer in enumerate(layers):
        h_layers.append(h)
        w_r = wrs[i] if wrs is not None else layer.get("w_r")
        h_out, cs, x = gcn_layer(bk, h, layer["w"], cfg, w_r=w_r,
                                 return_x=True)
        checks.extend(cs)
        x_layers.append(x)
        h = torch.relu(h_out) if i < len(layers) - 1 else h_out
    if return_intermediates:
        return ((h, checks, tuple(h_layers), tuple(x_layers)) if return_x
                else (h, checks, tuple(h_layers)))
    return (h, checks, tuple(x_layers)) if return_x else (h, checks)


def gcn_apply(params: Params, graph: Graph, cfg: ABFTConfig, *,
              backend: Optional[str] = None, partition=None,
              device: DeviceLike = "cuda",
              **backend_opts) -> Tuple[Tensor, ABFTReport]:
    """The engine entry point: logits + one ABFTReport.

    ``backend`` is ``"dense" | "bcoo" | "block_ell"`` (inferred from the
    adjacency operand when omitted); ``partition`` a
    :class:`~repro_torch.engine.sharded.Partition` for stripe-sharded
    block-ELL aggregation (the shards' partial checks summed into this same
    report); ``device`` defaults to the GPU and raises when there is none
    (pass ``device="cpu"`` for the plain PyTorch versions).
    """
    logits, checks = gcn_forward(params, graph, cfg, backend=backend,
                                 partition=partition, device=device,
                                 **backend_opts)
    return logits, summarize(checks, cfg, device=logits.device)
