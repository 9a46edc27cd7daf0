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

Encoder-decoder models (cross-attention) and prefix or source embeddings
raise ``NotImplementedError`` (ROADMAP A10.7).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft import ABFTConfig, Check, summarize
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.matmul_abft.ops import matmul_abft
from repro_torch.models.attention import (
    attention_block,
    attention_decode,
    attention_fault_injection,
    init_attention,
    init_cache,
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


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: the port runs decoders without cross-"
        f"attention or prefix embeddings (ROADMAP A10.7)")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family != "decoder":
        raise _unported(f"family {cfg.family!r}")


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
    if cross:
        raise _unported("cross-attention")
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
    return p


def init_unit(gen: torch.Generator, cfg: ModelConfig,
              pattern: Tuple[str, ...], cross: bool,
              lead: Tuple[int, ...] = ()) -> Params:
    return {f"b{i}": init_layer(gen, cfg, bt, cross, lead)
            for i, bt in enumerate(pattern)}


def init_model(cfg: ModelConfig,
               generator: Union[int, torch.Generator, None] = 0, *,
               device: DeviceLike = "cuda") -> Params:
    """Random params for ``cfg``: ``{"embed", "segments": [stacked unit
    params, leading axis = unit count], "final_norm"}`` (+ ``"head"`` when
    the embeddings are untied), truncated-normal weights as the reference
    draws them.  ``generator`` is a seed (the draws are then made on
    ``device``) or a ``torch.Generator`` (draws on its device, then moved to
    ``device``).  ``device="meta"`` builds the shapes alone."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = generator
    if dev.type == "meta":
        gen = None
    elif not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen or 0))
    p: Params = {"embed": init_embed(gen, cfg.padded_vocab, cfg.d_model)}
    p["segments"] = [init_unit(gen, cfg, pattern, False, (count,))
                     for pattern, count in seg_structure(cfg)]
    p["final_norm"] = init_norm(cfg.d_model, device=gen_device(gen))
    if not cfg.tie_embeddings:
        p["head"] = init_dense(gen, cfg.d_model, cfg.padded_vocab)
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
    if cross:
        raise _unported(f"decode state of {btype!r} with cross-attention")
    if btype == "attn":
        return init_cache(cfg, batch, cache_len, dtype, device)
    return _zero_recurrent_state(cfg, btype, batch, device)


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
    state when ``build_cache``; ``positions=None`` means 0..T-1."""
    if enc_out is not None:
        raise _unported("cross-attention")
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
    return x, checks, aux, new_state


def layer_apply_decode(lp: Params, x: Tensor, btype: str, cfg: ModelConfig,
                       abft: ABFTConfig, pos: int, state: Params
                       ) -> Tuple[Tensor, List[Check], Params]:
    if btype in RECURRENT:
        # a one-token sequence from the carried state
        x, checks, _aux, new_state = layer_apply_seq(
            lp, x, btype, cfg, abft, None, None, state, True, 1)
        return x, checks, new_state
    if "xattn" in lp:
        raise _unported("cross-attention")
    window = cfg.window
    if len(cfg.block_pattern) > 1:
        window = cfg.local_window
    h = norm_apply(x, lp["ln1"], cfg)
    y, new_state, checks = attention_decode(lp["attn"], h, state, pos, cfg,
                                            abft, window=window)
    x = x + y
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
        for ui in range(count):
            x, cs, ns = unit_fn(x, _index(seg_p, ui), si, ui, pattern)
            per_unit.append(cs)
            outs.append(ns)
        if count == 1 or not cfg.scan_layers:
            for cs in per_unit:
                all_checks += cs
        else:
            all_checks += _stack_checks(per_unit)
        states.append(_stack(outs))
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
    logits = logits.to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = torch.where(pad_mask, torch.full_like(logits, -1e30),
                             logits)
    return logits, checks


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int, *,
                      device: DeviceLike = "cuda") -> List[Params]:
    """Zeroed per-segment stacked decode states."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dtype = cdtype(cfg)
    states = []
    for pattern, count in seg_structure(cfg):
        unit = {f"b{i}": layer_state_init(cfg, bt, batch, cache_len, dtype,
                                          False, dev)
                for i, bt in enumerate(pattern)}
        states.append(_map(unit, lambda a: a[None].expand(
            count, *a.shape).clone()))
    return states


def model_prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
                  abft: ABFTConfig, cache_len: int, *,
                  return_checks: bool = False,
                  attn_inject: Optional[float] = None):
    """Run the prompt, build decode state.  Returns (last-token logits
    [B, 1, V_padded], states, report) — plus the flat per-op Check list when
    ``return_checks=True`` (the guarded engine's per-op verdict source;
    multi-unit segments contribute stacked per-layer checks).

    ``attn_inject``, when given, is added to element 0 of every attention
    accumulator O = A·V (the fault-campaign accumulator site); 0.0 is a
    fault-free step."""
    if attn_inject is not None:
        with attention_fault_injection(attn_inject):
            return model_prefill(params, cfg, batch, abft, cache_len,
                                 return_checks=return_checks)
    _require_ported(cfg)
    if "prefix_embeds" in batch or "src_embeds" in batch:
        raise _unported("prefix / source embeddings")
    tokens = batch["tokens"]
    b, t = tokens.shape
    x = embed(params["embed"], tokens, cfg)

    def unit_fn(x, unit_p, si, ui, pattern):
        cs_all: List[Check] = []
        ns = {}
        for i, bt in enumerate(pattern):
            # positions None: 0..T-1, the prompt from its start
            x, cs, _aux, ns[f"b{i}"] = layer_apply_seq(
                unit_p[f"b{i}"], x, bt, cfg, abft, None, None, None,
                True, cache_len)
            cs_all += cs
        return x, cs_all, ns

    x, checks, states = _apply_segments(params["segments"], cfg, x, abft,
                                        unit_fn)
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
    """One decode step.  tokens: [B,1]; pos: the position of the token.
    ``return_checks=True`` appends the flat per-op Check list;
    ``attn_inject`` is the attention-accumulator fault (see
    :func:`model_prefill`)."""
    if attn_inject is not None:
        with attention_fault_injection(attn_inject):
            return model_decode(params, cfg, states, tokens, pos, abft,
                                return_checks=return_checks)
    _require_ported(cfg)
    pos = int(pos)
    x = embed(params["embed"], tokens, cfg)

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
