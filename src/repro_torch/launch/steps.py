"""Train, prefill and decode step factories shared by the drivers.

Counterpart of the JAX package's ``repro/launch/steps.py``: pure
``(state, batch) -> (state, metrics)``, ``(params, batch) -> (logits,
states, metrics)`` and ``(params, states, tokens, pos) -> (logits, states,
metrics)`` functions whose metrics carry the step's ABFT flag and largest
divergence.  In the train step the flag also gates state adoption on the
device (a flagged step returns its input state), so the runtime guard can
retry it without corrupting anything; the step itself never reads the flag
on the host.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft import ABFTConfig
from repro_torch.device import DeviceLike
from repro_torch.kernels import any_dtensor
from repro_torch.models.transformer import (init_model, lm_loss,
                                            model_decode, model_forward,
                                            model_prefill)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_leaf,
                               adamw_scalars, clip_scale, cosine_warmup,
                               ef_compress_leaf, global_norm, tree_leaves,
                               tree_map, tree_unflatten)

Tensor = torch.Tensor


def _on_mesh(step: Callable) -> Callable:
    """``step`` as it is; when its inputs are DTensors (a sharded step,
    ``launch/mesh.py``), run under DTensor's implicit replication — a
    tensor the model makes on the way (positions, masks, zero
    accumulators) is then a replicated DTensor, as the reference's SPMD
    partitioner treats a constant — and :class:`~repro_torch.launch.mesh.
    ReshardViews`, which gathers before a view DTensor cannot propagate,
    as XLA reshards around a reshape."""
    @functools.wraps(step)
    def run(*args):
        if not any_dtensor(*tree_leaves(args)):
            return step(*args)
        from torch.distributed.tensor.experimental import \
            implicit_replication

        from repro_torch.launch.mesh import ReshardViews
        with implicit_replication(), ReshardViews():
            return step(*args)
    return run


def loss_and_grads(params: Any, cfg: ModelConfig, batch: Dict[str, Tensor],
                   abft: ABFTConfig, *, aux_weight: float = 1e-2
                   ) -> Tuple[Tensor, Any, List[Tensor]]:
    """(loss, the forward's ABFT report, the gradient of every leaf of
    ``params`` in :func:`~repro_torch.optim.tree_leaves` order) — the
    reference's ``jax.value_and_grad`` of ``lm_loss(logits, labels) +
    aux_weight · aux``; on DTensor params each gradient comes in its
    param's layout.  The params are not written: autograd runs on
    detached leaves that share their storage; a leaf the loss does not
    reach gets a zero gradient."""
    old = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in old]
    fwd_batch = {k: v for k, v in batch.items() if k != "labels"}
    logits, report, aux = model_forward(
        tree_unflatten(params, iter(live)), cfg, fwd_batch, abft)
    loss = lm_loss(logits, batch["labels"]) + aux_weight * aux
    del logits
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), report, [torch.zeros_like(p) if g is None else
                                   _placed_like(g, p)
                                   for g, p in zip(grads, old)]


def _placed_like(g: Tensor, p: Tensor) -> Tensor:
    """A DTensor gradient in its param's layout — the data-parallel
    reduction: a partial sum over the batch shards becomes the param's own
    shards (a reduce-scatter or an all-reduce); anything else as it is."""
    if any_dtensor(g) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, abft: ABFTConfig, opt: AdamWConfig,
                    *, total_steps: int = 10000, warmup: int = 200,
                    aux_weight: float = 1e-2, guard_in_graph: bool = True,
                    compress_grads: bool = False) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``: the loss
    ``lm_loss(logits, labels) + aux_weight · aux`` of
    :func:`~repro_torch.models.transformer.model_forward` over ``batch``
    (``tokens``, ``labels`` and the model's ``src_embeds`` or
    ``prefix_embeds``), its gradients by autograd — every product forward
    and backward on ``matmul_abft``, attention forward on
    ``flash_checksum`` —, global-norm clipping, optionally the int8
    error-feedback round trip (``state["ef"]``), and AdamW at the
    cosine-warmup rate.  Metrics: ``loss``, ``grad_norm``, ``abft_flag``,
    ``abft_max_rel``, ``abft_n_checks`` (device tensors).

    With ``guard_in_graph`` (and checks on) each leaf's new params, ``m``
    and ``v`` — and ``step`` — are ``torch.where(flag, old, new)``, leaf by
    leaf: a leaf's update is made and selected before the next one's, so
    the step holds one leaf's transients beyond the old and the new state
    (the reference's whole-tree "new, then select" form would hold a
    second new state).  A flagged step returns values equal to its input
    bit for bit; the input state is never written.  The error-feedback
    buffers are adopted unguarded, as the reference adopts them.  Params
    are used as ``init_model`` draws them, without a folded ``w_r``: each
    product sums its ``b_r`` from the weights it multiplies, which stay
    current as the weights change."""
    def train_step(state: Dict[str, Any], batch: Dict[str, Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, Tensor]]:
        old = tree_leaves(state["params"])
        loss, report, grads = loss_and_grads(state["params"], cfg, batch,
                                             abft, aux_weight=aux_weight)
        gnorm = global_norm(grads)
        scale = clip_scale(gnorm, opt.grad_clip)
        lr_scale = cosine_warmup(state["opt"]["step"], warmup, total_steps)
        step, lr, b1t, b2t = adamw_scalars(state["opt"]["step"], opt,
                                           lr_scale)
        flag = report.flag.detach()
        guard = guard_in_graph and abft.enabled

        def sel(new, prev):
            # in place over ``new``: one leaf's update holds no third copy
            return torch.where(flag, prev, new, out=new) if guard else new
        old_m = tree_leaves(state["opt"]["m"])
        old_v = tree_leaves(state["opt"]["v"])
        old_e = tree_leaves(state["ef"]) if compress_grads else None
        new_p, new_m, new_v, new_e = [], [], [], []
        for i, p in enumerate(old):
            g, grads[i] = grads[i], None
            g = (g.to(torch.float32) * scale).to(g.dtype)
            if compress_grads:
                g, e = ef_compress_leaf(g, old_e[i])
                new_e.append(e)
            p1, m1, v1 = adamw_leaf(p, g, old_m[i], old_v[i], opt, lr, b1t,
                                    b2t)
            del g
            new_p.append(sel(p1, p))
            new_m.append(sel(m1, old_m[i]))
            new_v.append(sel(v1, old_v[i]))
            del p1, m1, v1
        new_state = {
            "params": tree_unflatten(state["params"], iter(new_p)),
            "opt": {"m": tree_unflatten(state["opt"]["m"], iter(new_m)),
                    "v": tree_unflatten(state["opt"]["v"], iter(new_v)),
                    "step": sel(step, state["opt"]["step"])}}
        if compress_grads:
            new_state["ef"] = tree_unflatten(state["ef"], iter(new_e))
        metrics = {
            "loss": loss.to(torch.float32),
            "grad_norm": gnorm.to(torch.float32),
            "abft_flag": flag,
            "abft_max_rel": report.max_rel.detach(),
            "abft_n_checks": report.n_checks.detach(),
        }
        return new_state, metrics

    return _on_mesh(train_step)


def init_train_state(cfg: ModelConfig, generator=0, *,
                     compress_grads: bool = False,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    """``{"params": init_model(cfg, generator, device=device), "opt":
    adamw_init(params)}`` (+ ``"ef"``, float32 zeros like params, with
    ``compress_grads``).  The params are not folded (no ``w_r``)."""
    params = init_model(cfg, generator, device=device)
    state = {"params": params, "opt": adamw_init(params)}
    if compress_grads:
        state["ef"] = tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), params)
    return state


def make_prefill_step(cfg: ModelConfig, abft: ABFTConfig, cache_len: int
                      ) -> Callable:
    """``prefill(params, batch) -> (last-token logits, states, metrics)``;
    ``batch`` as :func:`~repro_torch.models.transformer.model_prefill`
    takes it (``tokens``, and ``src_embeds`` or ``prefix_embeds``)."""
    def prefill(params, batch):
        logits, states, report = model_prefill(params, cfg, batch, abft,
                                               cache_len)
        return logits, states, {"abft_flag": report.flag,
                                "abft_max_rel": report.max_rel}
    return _on_mesh(prefill)


def make_decode_step(cfg: ModelConfig, abft: ABFTConfig) -> Callable:
    """``decode(params, states, tokens [B, 1], pos) -> (logits, states,
    metrics)``."""
    def decode(params, states, tokens, pos):
        logits, states, report = model_decode(params, cfg, states, tokens,
                                              pos, abft)
        return logits, states, {"abft_flag": report.flag,
                                "abft_max_rel": report.max_rel}
    return _on_mesh(decode)
