"""Deterministic synthetic token pipeline.

A copy of the JAX package's ``repro/data/synthetic.py`` generator (numpy
only): for one ``seed`` and host id its batches are the reference's bit for
bit.  :func:`make_batch_specs` gives the dry run's input specs: tensors on
the ``meta`` device (shapes and dtypes only, nothing allocated).  The
stream is a seeded Markov-ish mixture so the LM loss actually
decreases (pure-uniform tokens would have irreducible loss = log V): token t
is a deterministic function of token t-1 with probability ``structure``,
else fresh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_size: int          # per-host batch
    seed: int = 0
    structure: float = 0.75  # P(next token is a deterministic successor)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._succ = rng.permutation(self.vocab_size)

    def batches(self, host_id: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """``{"tokens", "labels"}`` int32 [batch, seq_len] numpy batches,
        labels the tokens shifted by one."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, host_id]))
        while True:
            fresh = rng.integers(0, self.vocab_size,
                                 size=(self.batch_size, self.seq_len + 1))
            keep = rng.random((self.batch_size, self.seq_len + 1)) \
                < self.structure
            toks = fresh.copy()
            for t in range(1, self.seq_len + 1):
                toks[:, t] = np.where(keep[:, t],
                                      self._succ[toks[:, t - 1]],
                                      fresh[:, t])
            yield {
                "tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
            }


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                     prefix_len: int = 64, *, device: DeviceLike = "meta"
                     ) -> Dict[str, torch.Tensor]:
    """Every model input of a shape cell as an empty tensor on ``device``
    (``meta``: shapes only), the reference's keys, shapes and dtypes: int32
    ``tokens`` (and ``labels`` to train), float32 ``src_embeds`` for an
    encoder-decoder or ``prefix_embeds`` for a model with a front end; a
    decode step takes one new token (its state comes from the model)."""
    dev = resolve_device(device)
    b, t = shape.global_batch, shape.seq_len

    def spec(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=dev)

    if shape.kind == "decode":
        return {"tokens": spec(b, 1)}
    specs = {"tokens": spec(b, t)}
    if shape.kind == "train":
        specs["labels"] = spec(b, t)
    if cfg.family == "encdec":
        specs["src_embeds"] = spec(b, t, cfg.d_model, dtype=torch.float32)
    elif cfg.frontend:
        specs["prefix_embeds"] = spec(b, prefix_len, cfg.d_model,
                                      dtype=torch.float32)
    return specs
