"""Declarative fault models for the chaos campaign.

The port's own copy of the JAX package's ``repro/faults/model.py`` (pure
data, no array library): the same grids, model for model.

A :class:`FaultModel` names WHERE a fault lands (``site``), WHAT it does
(``kind``) and WHEN it fires (``timing``) — the axes PyGFI-style GNN
robustness campaigns sweep.  The model is pure data; the matching
stateful process (choosing coordinates, latching sticky corruption,
re-applying it each step) lives in :mod:`repro_torch.faults.injectors`.

Sites (what the bits belong to):

* ``weights``     — an element of a layer's weight matrix W.  The fold
  ``w_r = W·e`` predates the corruption, so the eq. 4–6 check sees the
  divergence: this is the *detectable memory fault* class.
* ``features``    — an element of the request's node features H0.  The
  carried column x_r = H·w_r is computed from the SAME corrupted H, so
  the check is consistent by construction — ABFT does not claim this
  site; the campaign measures its SDC rate honestly.
* ``cols_table``  — an entry of the packed block-ELL column-index table
  (a corrupted pointer landing on a valid but wrong column block).  Both
  the aggregation and its checksum corner read the same table, so this
  site is also architecturally silent — measured, not asserted.
* ``accumulator`` — the paper's fault model: a delta added into one
  (layer, stripe, slot) accumulation step inside the kernel, via the
  existing ``inject=`` hook.  Single upsets above threshold must be
  detected 100% (the CI gate).
* ``w_r``         — the folded eq.-5 checksum-column source; corrupting
  it corrupts the carried column x_r = H·w_r, i.e. the CHECK path, not
  the data path.  Caught by the periodic self-check
  (:mod:`repro_torch.faults.selfcheck`).
* ``s_c``         — the offline adjacency column checksum e^T·S (dense /
  BCOO serving path).  Check path again; self-check territory.

LM sites (the guarded transformer lane — :class:`~repro_torch.engine.lm.LMEngine`):

* ``qkv_w``       — an element of a layer's stacked attention projection
  weights (Q by convention; ``index`` addresses the flat slice).  The
  offline fold predates the corruption → detectable, repaired by the
  guard's restore-and-refold.
* ``mlp_w``       — same class, the layer's MLP input projection.
* ``attn_accumulator`` — the attention output accumulator O = A·V, via
  the ``attn_inject`` operand: the carried column o_extra is accumulated
  independently, so the fused chain check must flag it 100% (the LM CI
  gate, mirroring the GCN ``accumulator`` gate).

Kinds: ``bitflip`` (transient single-event upset — fires once, the
corrupted value is overwritten by the next clean write/retry),
``stuck`` (sticky stuck-at — the corruption re-applies every step from
its first firing; retries on the same unit are doomed), ``multi``
(multi-bit/multi-element upset in one event).

Timing: ``targeted`` (fires at ``step``; sticky kinds stay latched from
there) or ``bernoulli`` (each step fires with probability ``p``; sticky
kinds latch on the first firing).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

SITES = ("weights", "features", "cols_table", "accumulator", "w_r", "s_c",
         "qkv_w", "mlp_w", "attn_accumulator")
# the LM lane's sites (guarded transformer serving)
LM_SITES = ("qkv_w", "mlp_w", "attn_accumulator")
# the GCN serving lane's sites (everything the packed/dense hooks serve)
GCN_SITES = tuple(s for s in SITES if s not in LM_SITES)
KINDS = ("bitflip", "stuck", "multi")
TIMINGS = ("targeted", "bernoulli")

# sites that corrupt the checksum path itself rather than the data path
CHECK_PATH_SITES = ("w_r", "s_c")
# sites the eq. 4-6 algebra cannot see by construction (consistent
# corruption of both sides) — expected-silent, measured for SDC rate
CONSISTENT_SITES = ("features", "cols_table")


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One declarative fault: site x kind x timing + coordinates.

    ``index`` pins the flat element index inside the target array (or the
    (stripe, slot) pair of a ``cols_table`` entry); ``None`` draws it from
    the injector's seeded rng.  ``bit`` is the IEEE bit to flip
    (``bitflip``/``multi``); ``stuck_value`` overrides the stuck-at value
    (default: the bit-flipped value sticks — stuck-at the upset).
    ``delta`` / ``stripe`` / ``slot`` parameterize the ``accumulator``
    site's kernel ``inject=`` tuple.
    """

    site: str
    kind: str = "bitflip"
    timing: str = "targeted"
    step: int = 0                 # targeted firing step (latch point)
    p: float = 0.0                # bernoulli per-step firing probability
    layer: int = 0                # weights / w_r / accumulator sites
    index: Optional[int] = None   # flat element index; None = seeded draw
    bit: int = 30                 # IEEE-754 bit to flip
    n_upsets: int = 1             # elements hit per event (kind="multi")
    stuck_value: Optional[float] = None
    delta: float = 1.0            # accumulator injection magnitude
    stripe: int = 0               # accumulator stripe coordinate
    slot: int = 0                 # accumulator ell-slot coordinate
    seed: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"fault site {self.site!r} not in {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {KINDS}")
        if self.timing not in TIMINGS:
            raise ValueError(f"fault timing {self.timing!r} not in "
                             f"{TIMINGS}")
        if self.timing == "bernoulli" and not (0.0 < self.p <= 1.0):
            raise ValueError("bernoulli timing needs 0 < p <= 1, got "
                             f"{self.p}")
        if not (0 <= self.bit < 64):
            raise ValueError(f"bit {self.bit} out of range [0, 64)")
        if self.kind == "multi" and self.n_upsets < 2:
            raise ValueError("kind='multi' needs n_upsets >= 2")
        if self.kind != "multi" and self.n_upsets != 1:
            raise ValueError("n_upsets != 1 is kind='multi' only")
        if self.stuck_value is not None and self.kind != "stuck":
            raise ValueError("stuck_value is kind='stuck' only")
        if self.site in ("accumulator", "attn_accumulator") \
                and not math.isfinite(self.delta):
            raise ValueError("accumulator delta must be finite (the hook "
                             "adds it into one accumulation step)")

    @property
    def sticky(self) -> bool:
        """Sticky faults re-apply every step once latched."""
        return self.kind == "stuck"

    @property
    def check_path(self) -> bool:
        return self.site in CHECK_PATH_SITES

    @property
    def expected_silent(self) -> bool:
        """Sites the eq. 4-6 algebra cannot flag by construction."""
        return self.site in CONSISTENT_SITES

    def label(self) -> str:
        return f"{self.site}/{self.kind}/{self.timing}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # NaN stuck values must survive the JSON round trip
        if d["stuck_value"] is not None and math.isnan(d["stuck_value"]):
            d["stuck_value"] = "nan"
        return d


def lm_sweep_models(*, reps: int = 2, step: int = 1, bit: int = 30,
                    delta: float = 25.0, seed: int = 0) -> list:
    """The LM lane's grid: weight sites x {bitflip, stuck} plus the
    attention-accumulator transient (the LM analog of the GCN
    ``accumulator`` gate site)."""
    models = []
    for site in ("qkv_w", "mlp_w"):
        for kind in ("bitflip", "stuck"):
            for r in range(reps):
                models.append(FaultModel(site=site, kind=kind, step=step,
                                         bit=bit, seed=seed + 1000 * r))
    for r in range(reps):
        models.append(FaultModel(site="attn_accumulator", kind="bitflip",
                                 step=step, delta=delta,
                                 seed=seed + 1000 * r))
    return models


def sweep_models(sites: Tuple[str, ...] = GCN_SITES,
                 kinds: Tuple[str, ...] = ("bitflip", "stuck"),
                 *, reps: int = 2, step: int = 1, bit: int = 30,
                 seed: int = 0) -> list:
    """The default campaign grid: ``reps`` seeded models per (site, kind),
    plus the check-path NaN stuck-at that exercises the would-be
    false-negative path (a naive ``d > tau`` comparison is silent on
    NaN)."""
    models = []
    for site in sites:
        for kind in kinds:
            for r in range(reps):
                models.append(FaultModel(
                    site=site, kind=kind, step=step, bit=bit,
                    seed=seed + 1000 * r))
        if site in CHECK_PATH_SITES and "stuck" in kinds:
            models.append(FaultModel(site=site, kind="stuck", step=step,
                                     stuck_value=float("nan"), seed=seed))
    return models
