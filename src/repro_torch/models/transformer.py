"""Model assembly for decoders: layer-stacked params, prefill with cache and
state building, one-token decode, the tied LM head.

Counterpart of the JAX package's ``repro/models/transformer.py``, for its
decoders: attention blocks with dense or mixture-of-experts MLPs
(:mod:`repro_torch.models.moe` when ``cfg.moe`` is set), RWKV6 blocks
(:mod:`repro_torch.models.rwkv6`) and RG-LRU blocks
(:mod:`repro_torch.models.rglru`), alone or in a hybrid pattern whose
attention blocks take ``cfg.local_window``.  Layer stacks are grouped into
*segments* of a repeating block-pattern unit whose params are stacked on a
leading axis, as the reference's vmapped init makes them; a trailing partial
unit (38 = 12 × 3 + 2) is a segment of its own.  The port applies the units
in a Python loop (no scan) and stacks each position's per-unit checks into
one :class:`Check` with ``[count]`` fields, so :func:`per_op_report` names
the layer a flag fired in with the reference's ``op{i}:L{j}`` ids.  A
segment of one unit, or ``cfg.scan_layers=False``, keeps its checks flat,
as the reference's unrolled path does.

Recurrent blocks carry float32 decode state (RWKV6: the last token of each
mix and the WKV matrix; RG-LRU: ``h`` and the conv history) that ignores
``cache_len``; prefill starts from the zero state and a decode step runs a
one-token sequence with the state carried.

An encoder-decoder model (``cfg.family == "encdec"``, whisper) runs its
encoder (:func:`encode`: non-causal attention blocks, no RoPE, sinusoid
positions) over the caller's ``src_embeds`` once in prefill; each decoder
attention block then cross-attends to the encoder output after its
self-attention (``lnx``, ``xattn``) and caches the cross keys, values and
check column (``xk``, ``xv``, ``xvr``), over which every decode step
attends in plain PyTorch.  A model with a ``frontend`` that is not an
encoder-decoder (internvl2) prepends the caller's ``prefix_embeds`` to the
token embeddings; decode positions then count the prefix.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft import ABFTConfig, Check, summarize
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import acc_dtype
from repro_torch.kernels.matmul_abft.ops import matmul_abft
from repro_torch.models.attention import (
    attention_block,
    attention_decode,
    attention_fault_injection,
    init_attention,
    init_cache,
    streaming_attention,
)
from repro_torch.models.common import (
    cdtype,
    dense,
    embed,
    gen_device,
    init_dense,
    init_embed,
    init_norm,
    norm_apply,
    sinusoid_positions,
)
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.rglru import init_rglru_block, rglru_block, \
    rglru_state_init
from repro_torch.models.rwkv6 import (
    init_rwkv_channel_mix,
    init_rwkv_time_mix,
    rwkv_channel_mix,
    rwkv_state_init,
    rwkv_time_mix,
)

Tensor = torch.Tensor
Params = Dict[str, Any]


RECURRENT = ("rglru", "rwkv")


def seg_structure(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    bp, n = cfg.block_pattern, cfg.n_layers
    unit = len(bp)
    segs: List[Tuple[Tuple[str, ...], int]] = []
    if n // unit:
        segs.append((bp, n // unit))
    if n % unit:
        segs.append((bp[: n % unit], 1))
    return segs


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, btype: str,
               cross: bool, lead: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    p = {"ln1": init_norm(d, lead, gen_device(gen)),
         "ln2": init_norm(d, lead, gen_device(gen))}
    if btype == "attn":
        p["attn"] = init_attention(gen, cfg, lead=lead)
    elif btype == "rglru":
        p["rglru"] = init_rglru_block(gen, cfg, lead)
    elif btype == "rwkv":
        p["tm"] = init_rwkv_time_mix(gen, cfg, lead)
    else:
        raise ValueError(btype)
    if btype == "rwkv":
        p["cm"] = init_rwkv_channel_mix(gen, cfg, lead)
    elif cfg.moe is not None:
        p["moe"] = init_moe(gen, cfg, lead=lead)
    else:
        p["mlp"] = init_mlp(gen, cfg, lead=lead)
    if cross:
        p["lnx"] = init_norm(d, lead, gen_device(gen))
        p["xattn"] = init_attention(gen, cfg, cross=True, lead=lead)
    return p


def init_unit(gen: torch.Generator, cfg: ModelConfig,
              pattern: Tuple[str, ...], cross: bool,
              lead: Tuple[int, ...] = ()) -> Params:
    return {f"b{i}": init_layer(gen, cfg, bt, cross, lead)
            for i, bt in enumerate(pattern)}


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder of an encoder-decoder ``cfg``: ``enc_layers`` attention
    blocks, non-causal, without RoPE, a window or experts."""
    return dataclasses.replace(
        cfg, n_layers=cfg.enc_layers, causal=False, rope_frac=0.0,
        block_pattern=("attn",), moe=None, window=0)


def init_model(cfg: ModelConfig,
               generator: Union[int, torch.Generator, None] = 0, *,
               device: DeviceLike = "cuda") -> Params:
    """Random params for ``cfg``: ``{"embed", "segments": [stacked unit
    params, leading axis = unit count], "final_norm"}`` (+ ``"head"`` when
    the embeddings are untied; + ``"encoder": {"segments", "final_norm"}``
    and each decoder layer's ``"lnx"``, ``"xattn"`` for an encoder-decoder),
    truncated-normal weights as the reference draws them.  ``generator`` is
    a seed (the draws are then made on ``device``) or a ``torch.Generator``
    (draws on its device, then moved to ``device``).  ``device="meta"``
    builds the shapes alone."""
    dev = resolve_device(device)
    gen = generator
    if dev.type == "meta":
        gen = None
    elif not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen or 0))
    cross = cfg.family == "encdec"
    p: Params = {"embed": init_embed(gen, cfg.padded_vocab, cfg.d_model)}
    p["segments"] = [init_unit(gen, cfg, pattern, cross, (count,))
                     for pattern, count in seg_structure(cfg)]
    p["final_norm"] = init_norm(cfg.d_model, device=gen_device(gen))
    if not cfg.tie_embeddings:
        p["head"] = init_dense(gen, cfg.d_model, cfg.padded_vocab)
    if cross:
        ecfg = encoder_cfg(cfg)
        p["encoder"] = {
            "segments": [init_unit(gen, ecfg, pattern, False, (count,))
                         for pattern, count in seg_structure(ecfg)],
            "final_norm": init_norm(cfg.d_model, device=gen_device(gen))}
    return _map(p, lambda t: t.to(dev))


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, Tensor) else tree


def _index(tree: Any, i: int) -> Any:
    """Unit ``i`` of a layer-stacked tree."""
    return _map(tree, lambda t: t[i])


def _unstack(tree: Any, n: int) -> List[Any]:
    """The ``n`` units of a layer-stacked tree, each leaf unbound once:
    unit ``i``'s leaves are the views ``_index`` gives, and autograd
    stacks their gradients into the stacked leaf's in one write (indexing
    each unit would add a full-size zero-filled gradient a unit)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(v, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    return list(tree.unbind(0)) if isinstance(tree, Tensor) else [tree] * n


def _stack(trees: List[Any]) -> Any:
    """Stack per-unit trees of one structure on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _stack_checks(per_unit: List[List[Check]]) -> List[Check]:
    """One Check per op position, its fields stacked over the units."""
    out = []
    for cs in zip(*per_unit):
        out.append(Check(predicted=torch.stack([c.predicted for c in cs]),
                         actual=torch.stack([c.actual for c in cs]),
                         granularity=cs[0].granularity))
    return out


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def layer_state_init(cfg: ModelConfig, btype: str, batch: int,
                     cache_len: int, dtype, cross: bool,
                     device=None) -> Params:
    """A layer's zeroed decode state: an attention block's cache (with
    ``cross``, its cross-attention's ``xk``, ``xv``, ``xvr`` beside it) or
    a recurrent block's state."""
    if btype != "attn":
        return _zero_recurrent_state(cfg, btype, batch, device)
    st = init_cache(cfg, batch, cache_len, dtype, device)
    if cross:
        kv = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
        st["xk"] = torch.zeros(kv, dtype=dtype, device=device)
        st["xv"] = torch.zeros(kv, dtype=dtype, device=device)
        st["xvr"] = torch.zeros((batch, cache_len, cfg.n_heads), dtype=dtype,
                                device=device)
    return st


def _zero_recurrent_state(cfg: ModelConfig, btype: str, batch: int,
                          device=None) -> Params:
    """A recurrent block's float32 zero state (no cache length)."""
    if btype == "rglru":
        return rglru_state_init(cfg, batch, device)
    return rwkv_state_init(cfg, batch, device)


def layer_apply_seq(lp: Params, x: Tensor, btype: str, cfg: ModelConfig,
                    abft: ABFTConfig, positions: Optional[Tensor],
                    enc_out: Optional[Tensor], state: Optional[Params],
                    build_cache: bool, cache_len: int
                    ) -> Tuple[Tensor, List[Check], Tensor,
                               Optional[Params]]:
    """Returns (x, checks, aux_loss, new cache or state).  A recurrent block
    starts from ``state`` (``None``: the zero state) and returns its new
    state when ``build_cache``; ``positions=None`` means 0..T-1.  An
    attention block given ``enc_out`` [B, S, d] cross-attends to it after
    its self-attention and caches the cross keys, values and column."""
    checks: List[Check] = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    b, t, _ = x.shape
    if btype in RECURRENT:
        st = state or _zero_recurrent_state(cfg, btype, b, x.device)
        h = norm_apply(x, lp["ln1"], cfg)
        if btype == "rwkv":
            y, x_tm, wkv, cs = rwkv_time_mix(lp["tm"], h, cfg, abft,
                                             st["x_tm"].to(h.dtype),
                                             st["wkv"])
        else:
            y, rgst, cs = rglru_block(lp["rglru"], h, cfg, abft, st)
        x = x + y
        checks += cs
        h = norm_apply(x, lp["ln2"], cfg)
        if btype == "rwkv":
            y, x_cm, cs = rwkv_channel_mix(lp["cm"], h, cfg, abft,
                                           st["x_cm"].to(h.dtype))
        else:
            y, cs = mlp_block(lp["mlp"], h, cfg, abft)
        x = x + y
        checks += cs
        new_state = None
        if build_cache:
            new_state = rgst if btype == "rglru" else {
                "wkv": wkv, "x_tm": x_tm.to(torch.float32),
                "x_cm": x_cm.to(torch.float32)}
        return x, checks, aux, new_state
    if btype != "attn":
        raise ValueError(btype)
    window = cfg.window
    if len(cfg.block_pattern) > 1:      # hybrid: local attention
        window = cfg.local_window
    h = norm_apply(x, lp["ln1"], cfg)
    y, cs, (k, v, kpos, vr) = attention_block(
        lp["attn"], h, cfg, abft, positions=positions, window=window)
    x = x + y
    checks += cs
    if enc_out is not None:
        h = norm_apply(x, lp["lnx"], cfg)
        y, cs, (xk, xv, _, xvr) = attention_block(
            lp["xattn"], h, cfg, abft, kv_x=enc_out, positions=positions,
            causal=False, use_rope=False)
        x = x + y
        checks += cs
    h = norm_apply(x, lp["ln2"], cfg)
    if "moe" in lp:
        y, cs, aux = moe_block(lp["moe"], h, cfg, abft)
    else:
        y, cs = mlp_block(lp["mlp"], h, cfg, abft)
    x = x + y
    checks += cs
    new_state = None
    if build_cache:
        pad = cache_len - t
        if vr is None:
            vr = torch.zeros((*k.shape[:2], cfg.n_heads), dtype=k.dtype,
                             device=k.device)
        fpad = torch.nn.functional.pad
        new_state = {
            "k": fpad(k, (0, 0, 0, 0, 0, pad)),
            "v": fpad(v, (0, 0, 0, 0, 0, pad)),
            "vr": fpad(vr.to(k.dtype), (0, 0, 0, pad)),
            "pos": fpad(kpos.to(torch.int32), (0, pad),
                        value=2 ** 30),            # unwritten -> masked
        }
        if enc_out is not None:
            new_state["xk"], new_state["xv"] = xk, xv
            new_state["xvr"] = xvr.to(k.dtype) if xvr is not None else \
                torch.zeros((*xk.shape[:2], cfg.n_heads), dtype=k.dtype,
                            device=k.device)
    return x, checks, aux, new_state


def _cross_attention_decode(p: Params, h: Tensor, state: Params, pos: int,
                            cfg: ModelConfig, abft: ABFTConfig
                            ) -> Tuple[Tensor, List[Check]]:
    """One query over the static encoder cache (``xk``, ``xv`` and the check
    column ``xvr``, all S keys valid), in plain PyTorch as the reference
    computes it; no accumulator inject site, as in the reference."""
    b = h.shape[0]
    s = state["xk"].shape[1]
    kvpos = torch.arange(s, device=h.device)[None].expand(b, s)
    q, c1 = dense(p["wq"], h, abft)
    vr = state["xvr"].to(q.dtype) if abft.mode == "fused" else None
    o, o_extra, _, _ = streaming_attention(
        q, state["xk"], state["xv"], vr,
        q_positions=torch.full((b, 1), pos, dtype=torch.int32,
                               device=h.device),
        k_positions=kvpos, causal=False, window=0,
        chunk=min(cfg.attn_chunk, s))
    y, c2 = dense(p["wo"], o.reshape(b, 1, -1).to(h.dtype),
                  abft if abft.mode == "split" else ABFTConfig(mode="none"))
    checks = c1 + c2
    if abft.mode == "fused":
        checks.append(Check(predicted=o_extra.to(torch.float32).sum(),
                            actual=y.to(abft.dtype).sum()))
    return y, checks


def layer_apply_decode(lp: Params, x: Tensor, btype: str, cfg: ModelConfig,
                       abft: ABFTConfig, pos: int, state: Params
                       ) -> Tuple[Tensor, List[Check], Params]:
    if btype in RECURRENT:
        # a one-token sequence from the carried state
        x, checks, _aux, new_state = layer_apply_seq(
            lp, x, btype, cfg, abft, None, None, state, True, 1)
        return x, checks, new_state
    window = cfg.window
    if len(cfg.block_pattern) > 1:
        window = cfg.local_window
    h = norm_apply(x, lp["ln1"], cfg)
    y, new_state, checks = attention_decode(lp["attn"], h, state, pos, cfg,
                                            abft, window=window)
    x = x + y
    if "xattn" in lp:
        h = norm_apply(x, lp["lnx"], cfg)
        y, cs = _cross_attention_decode(lp["xattn"], h, state, pos, cfg,
                                        abft)
        x = x + y
        checks += cs
        new_state = dict(new_state, xk=state["xk"], xv=state["xv"],
                         xvr=state["xvr"])
    h = norm_apply(x, lp["ln2"], cfg)
    if "moe" in lp:
        y, cs, _ = moe_block(lp["moe"], h, cfg, abft)
    else:
        y, cs = mlp_block(lp["mlp"], h, cfg, abft)
    x = x + y
    return x, checks + cs, new_state


def _apply_segments(params_segs, cfg: ModelConfig, x: Tensor,
                    abft: ABFTConfig, unit_fn) -> Tuple[Tensor, List[Check],
                                                        List[Params]]:
    """Run every unit of every segment in order; ``unit_fn(x, unit_params,
    si, ui) -> (x, unit_checks, unit_state)``.  Returns (x, checks, per
    segment stacked states)."""
    all_checks: List[Check] = []
    states: List[Params] = []
    for si, ((pattern, count), seg_p) in enumerate(
            zip(seg_structure(cfg), params_segs)):
        per_unit, outs = [], []
        for ui, unit_p in enumerate(_unstack(seg_p, count)):
            x, cs, ns = unit_fn(x, unit_p, si, ui, pattern)
            per_unit.append(cs)
            outs.append(ns)
        if count == 1 or not cfg.scan_layers:
            for cs in per_unit:
                all_checks += cs
        else:
            all_checks += _stack_checks(per_unit)
        states.append(None if outs[0] is None else _stack(outs))
    return x, all_checks, states


# ---------------------------------------------------------------------------
# model-level entry points
# ---------------------------------------------------------------------------

def _lm_head(params: Params, cfg: ModelConfig, x: Tensor,
             abft: ABFTConfig) -> Tuple[Tensor, List[Check]]:
    """Logits [B, T, V_padded] f32 and the head's check.  The tied head
    multiplies by the embedding table as it lies (the kernel's transposed-B
    operand); its right checksum is the table's column sum, recomputed each
    step — the table has no fold, as in the reference."""
    checks: List[Check] = []
    b, t, d = x.shape
    if cfg.tie_embeddings:
        w = params["embed"]["table"].to(x.dtype)
        br = w.to(abft.dtype).sum(dim=0) if abft.enabled else None
        logits, chk = matmul_abft(x.reshape(-1, d).contiguous(), w, br,
                                  trans_b=True, with_check=abft.enabled)
        logits = logits.reshape(b, t, -1)
        if chk is not None:
            checks.append(chk)
    else:
        logits, checks = dense(params["head"], x, abft)
    logits = logits.to(acc_dtype(logits.dtype))
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = torch.where(pad_mask, torch.full_like(logits, -1e30),
                             logits)
    return logits, checks


def _run_layers(params_segs, cfg: ModelConfig, x: Tensor, abft: ABFTConfig,
                enc_out: Optional[Tensor], build_cache: bool,
                cache_len: int) -> Tuple[Tensor, List[Check], Tensor,
                                         List[Params]]:
    """Every layer of ``params_segs`` over the whole sequence x (positions
    0..T-1, from the zero state).  Returns (x, checks, the summed aux loss,
    per segment stacked caches or ``None``s)."""
    aux = [torch.zeros((), dtype=torch.float32, device=x.device)]

    def unit_fn(x, unit_p, si, ui, pattern):
        cs_all: List[Check] = []
        ns = {}
        for i, bt in enumerate(pattern):
            x, cs, a, ns[f"b{i}"] = layer_apply_seq(
                unit_p[f"b{i}"], x, bt, cfg, abft, None, enc_out, None,
                build_cache, cache_len)
            cs_all += cs
            aux[0] = aux[0] + a
        return x, cs_all, (ns if build_cache else None)

    x, checks, states = _apply_segments(params_segs, cfg, x, abft, unit_fn)
    return x, checks, aux[0], states


def encode(params: Params, cfg: ModelConfig, src_embeds: Tensor,
           abft: ABFTConfig) -> Tuple[Tensor, List[Check]]:
    """The encoder of an encoder-decoder over ``src_embeds`` [B, S, d] (the
    front end's frames) with sinusoid positions: (its normed output
    [B, S, d], its checks)."""
    ecfg = encoder_cfg(cfg)
    b, s, _ = src_embeds.shape
    positions = torch.arange(s, device=src_embeds.device)[None].expand(b, s)
    x = src_embeds.to(cdtype(cfg)) + sinusoid_positions(
        positions, cfg.d_model, cdtype(cfg))
    x, checks, _aux, _ = _run_layers(params["encoder"]["segments"], ecfg, x,
                                     abft, None, False, 0)
    return norm_apply(x, params["encoder"]["final_norm"], cfg), checks


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
                  abft: ABFTConfig
                  ) -> Tuple[Tensor, int, Optional[Tensor], List[Check]]:
    """The decoder's input [B, P + T, d]: the token embeddings after the
    ``prefix_embeds`` [B, P, d] of a non-encoder-decoder model, or with
    sinusoid positions added for an encoder-decoder, whose encoder runs
    over ``src_embeds`` here.  Returns (x, P, encoder output or None, the
    encoder's checks)."""
    x = embed(params["embed"], batch["tokens"], cfg)
    offset = 0
    if "prefix_embeds" in batch and cfg.family != "encdec":
        pre = batch["prefix_embeds"].to(x.dtype)
        x = torch.cat([pre, x], dim=1)
        offset = pre.shape[1]
    enc_out, checks = None, []
    if cfg.family == "encdec":
        enc_out, checks = encode(params, cfg, batch["src_embeds"], abft)
        b, tt = x.shape[:2]
        positions = torch.arange(tt, device=x.device)[None].expand(b, tt)
        x = x + sinusoid_positions(positions, cfg.d_model, x.dtype)
    return x, offset, enc_out, checks


def model_forward(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
                  abft: ABFTConfig):
    """The whole-sequence forward (no cache).  ``batch``: ``"tokens"``
    [B, T]; ``"prefix_embeds"`` [B, P, d] (a front end's stub) or, for an
    encoder-decoder, ``"src_embeds"`` [B, S, d].  Returns (logits
    [B, T, V_padded] of the token positions, report, aux loss)."""
    x, offset, enc_out, checks = _embed_inputs(params, cfg, batch, abft)
    x, cs, aux, _ = _run_layers(params["segments"], cfg, x, abft, enc_out,
                                False, 0)
    checks += cs
    x = norm_apply(x, params["final_norm"], cfg)
    if offset:
        x = x[:, offset:]
    logits, lc = _lm_head(params, cfg, x, abft)
    checks += lc
    return logits, summarize(checks, abft, device=logits.device), aux


def constrain_batch(x: Tensor) -> Tensor:
    """The identity.  The reference pins activations to a batch-sharded
    layout at block boundaries so its SPMD partitioner keeps weight
    shardings off the residual stream; on one card there is no layout to
    pin."""
    return x


def lm_loss(logits: Tensor, labels: Tensor, mask: Optional[Tensor] = None
            ) -> Tensor:
    """Mean token cross-entropy: ``logsumexp(logits) - logits[label]``
    over [B, T] (over ``mask``'s tokens when given, divided by
    ``max(Σ mask, 1)``), as the reference's.

    The picked logit is a ``gather`` along the vocabulary.  The reference
    multiplies by a one-hot [B, T, V] and sums, to keep its sharded
    backward elementwise; on one card that one-hot would be another
    [B, T, V] f32 buffer (1 GB at gemma-2b's B 2 x T 512), and both forms
    pick the same value: the one-hot sum adds exact zeros to it."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - picked
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int, *,
                      device: DeviceLike = "cuda") -> List[Params]:
    """Zeroed per-segment stacked decode states."""
    dev = resolve_device(device)
    dtype = cdtype(cfg)
    cross = cfg.family == "encdec"
    states = []
    for pattern, count in seg_structure(cfg):
        unit = {f"b{i}": layer_state_init(cfg, bt, batch, cache_len, dtype,
                                          cross, dev)
                for i, bt in enumerate(pattern)}
        states.append(_map(unit, lambda a: a[None].expand(
            count, *a.shape).clone()))
    return states


def model_prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
                  abft: ABFTConfig, cache_len: int, *,
                  return_checks: bool = False,
                  attn_inject: Optional[float] = None):
    """Run the prompt, build decode state.  ``batch`` as
    :func:`model_forward` takes it.  Returns (last-token logits
    [B, 1, V_padded], states, report) — plus the flat per-op Check list when
    ``return_checks=True`` (the guarded engine's per-op verdict source;
    multi-unit segments contribute stacked per-layer checks, the encoder's
    first).

    ``attn_inject``, when given, is added to element 0 of every attention
    accumulator O = A·V (the fault-campaign accumulator site); 0.0 is a
    fault-free step."""
    if attn_inject is not None:
        with attention_fault_injection(attn_inject):
            return model_prefill(params, cfg, batch, abft, cache_len,
                                 return_checks=return_checks)
    x, _offset, enc_out, checks = _embed_inputs(params, cfg, batch, abft)
    x, cs, _aux, states = _run_layers(params["segments"], cfg, x, abft,
                                      enc_out, True, cache_len)
    checks += cs
    x = norm_apply(x, params["final_norm"], cfg)
    logits, lc = _lm_head(params, cfg, x[:, -1:], abft)
    checks += lc
    rep = summarize(checks, abft, device=logits.device)
    if return_checks:
        return logits, states, rep, checks
    return logits, states, rep


def model_decode(params: Params, cfg: ModelConfig, states: List[Params],
                 tokens: Tensor, pos: int, abft: ABFTConfig, *,
                 return_checks: bool = False,
                 attn_inject: Optional[float] = None):
    """One decode step.  tokens: [B,1]; pos: the position of the token (a
    prefix counts).  ``return_checks=True`` appends the flat per-op Check
    list; ``attn_inject`` is the attention-accumulator fault (see
    :func:`model_prefill`)."""
    if attn_inject is not None:
        with attention_fault_injection(attn_inject):
            return model_decode(params, cfg, states, tokens, pos, abft,
                                return_checks=return_checks)
    pos = int(pos)
    x = embed(params["embed"], tokens, cfg)
    if cfg.family == "encdec":
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                               device=x.device)
        x = x + sinusoid_positions(positions, cfg.d_model, x.dtype)

    def unit_fn(x, unit_p, si, ui, pattern):
        unit_state = _index(states[si], ui)
        cs_all: List[Check] = []
        ns = {}
        for i, bt in enumerate(pattern):
            x, cs, ns[f"b{i}"] = layer_apply_decode(
                unit_p[f"b{i}"], x, bt, cfg, abft, pos, unit_state[f"b{i}"])
            cs_all += cs
        return x, cs_all, ns

    x, checks, new_states = _apply_segments(params["segments"], cfg, x, abft,
                                            unit_fn)
    x = norm_apply(x, params["final_norm"], cfg)
    logits, lc = _lm_head(params, cfg, x, abft)
    checks += lc
    rep = summarize(checks, abft, device=logits.device)
    if return_checks:
        return logits, new_states, rep, checks
    return logits, new_states, rep
