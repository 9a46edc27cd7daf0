"""Check-the-check: periodic re-derivation of the checksum path.

The eq. 4–6 corners compare the computation against *precomputed*
checksum operands — the folded per-layer ``w_r = W·e`` (the source of
the carried eq.-5 column ``x_r = H·w_r``) and, on the dense path, the
offline adjacency column checksum ``s_c = e^T·S``.  A memory fault
in those operands makes every check a lie: a finite corruption turns the
stream into a false-positive storm (burning the guard's retry ladder on
phantom faults), and a NaN corruption would — under a naive ``d > tau``
comparison — silently pass every check forever, disabling ABFT without
any observable symptom.

The defense is cheap because the fold is tiny (one f32 vector per layer,
one per graph): on a sampled cadence, re-derive the fold from its source
operand and compare BITWISE.  The derivation is deterministic (the same
reduction on the same input), so any discrepancy is corruption — of the
fold, or of the source weights *after* folding; either way the fold is
stale and must be rebuilt.  ``repair`` refolds from the current source,
which restores check integrity (data-path weight corruption remains the
ordinary checks' job — and with a consistent refold it is invisible to
ABFT by construction, which is exactly the consistent-corruption caveat
the README documents).

The port's counterpart of the JAX package's ``repro/faults/selfcheck.py``.
Bitwise only holds for the same reduction on the same device, so each
re-derivation calls the function that made the stash — ``engine.fold_w_r``
for ``w_r``, ``core.checksum.col_checksum`` (what ``DenseBackend`` stashes)
for ``s_c`` — on the tensors where they live.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.core.abft import ABFTConfig
from repro_torch.core.checksum import col_checksum


def _mismatch(a, b) -> bool:
    """Inequality that treats NaN as corruption (NaN != NaN is exactly the
    property we want here: a NaN fold can never be the honest derivation
    of finite weights)."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b).to(a.device)
    if a.shape != b.shape:
        return True
    dt = torch.promote_types(a.dtype, b.dtype)
    return not torch.equal(a.to(dt), b.to(dt))


def verify_w_r(params, cfg: ABFTConfig) -> List[int]:
    """Re-derive every layer's eq.-5 fold and compare against the folded
    copy; returns the indices of mismatched layers (empty = clean)."""
    if not cfg.enabled:
        return []
    from repro_torch.engine.api import fold_w_r

    layers = params["layers"]
    # refold the source weights alone: the same function, on the same
    # device, as the fold under test
    fresh = fold_w_r({"layers": [{"w": layer["w"]} for layer in layers]},
                     cfg)["layers"]
    bad = []
    for i, layer in enumerate(layers):
        w_r = layer.get("w_r")
        if w_r is None:
            continue            # unfolded layer: derived per step, no copy
        if _mismatch(fresh[i]["w_r"], w_r):
            bad.append(i)
    return bad


def verify_s_c(graph, cfg: ABFTConfig) -> bool:
    """Re-derive a Graph's staged adjacency column checksum; True when the
    stash diverges from e^T·S (corruption, or a stale stash)."""
    if not cfg.enabled or graph.s_c is None:
        return False
    s = torch.as_tensor(graph.s)
    if isinstance(graph.s_c, torch.Tensor):
        s = s.to(graph.s_c.device)
    return _mismatch(col_checksum(s, cfg.dtype), graph.s_c)


def refold(params, cfg: ABFTConfig):
    """Rebuild every folded w_r from its source weights (the repair)."""
    from repro_torch.engine.api import fold_w_r
    return fold_w_r(params, cfg)


@dataclasses.dataclass
class CheckPathSelfCheck:
    """Sampled-cadence self-check of the checksum operands.

    ``maybe_check(params, step)`` runs the w_r verification every
    ``interval`` calls (step 0 included, so corruption predating a run is
    caught before the first flagged dispatch) and returns the mismatched
    layer indices, or ``None`` when this step was off-cadence.  The
    caller decides the repair policy — the streaming engine refolds and
    rebuilds its steps; the campaign records the detection.
    """

    cfg: ABFTConfig
    interval: int = 64
    checks_run: int = 0
    trips: int = 0
    last_bad: Optional[List[int]] = None

    def __post_init__(self):
        if self.interval < 1:
            raise ValueError("selfcheck interval must be >= 1")

    def maybe_check(self, params, step: int) -> Optional[List[int]]:
        if step % self.interval != 0:
            return None
        self.checks_run += 1
        bad = verify_w_r(params, self.cfg)
        if bad:
            self.trips += 1
            self.last_bad = list(bad)
        return bad

    def repair(self, params):
        return refold(params, self.cfg)
