"""Prefill and decode step factories shared by the serving entry points.

Counterpart of the JAX package's ``repro/launch/steps.py`` for serving:
pure ``(params, batch) -> (logits, states, metrics)`` and ``(params,
states, tokens, pos) -> (logits, states, metrics)`` functions whose metrics
carry the step's ABFT flag and largest divergence.  The reference's
``make_train_step`` and ``init_train_state`` need its optimizer, which the
port does not have yet (ROADMAP A12): they are left out.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft import ABFTConfig
from repro_torch.models.transformer import model_decode, model_prefill


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
    return prefill


def make_decode_step(cfg: ModelConfig, abft: ABFTConfig) -> Callable:
    """``decode(params, states, tokens [B, 1], pos) -> (logits, states,
    metrics)``."""
    def decode(params, states, tokens, pos):
        logits, states, report = model_decode(params, cfg, states, tokens,
                                              pos, abft)
        return logits, states, {"abft_flag": report.flag,
                                "abft_max_rel": report.max_rel}
    return decode
