"""ABFT guard: closes the loop from error *detection* to *recovery*.

The port's copy of the JAX package's ``repro/runtime/abft_guard.py``; the
policy is unchanged, only the host reads of step metrics go through
:func:`_host` because the metrics are torch tensors.

The paper detects faults; a 1000-node deployment must also act on them.
Policy (per train/serve step):

  1. run the step; the ABFTReport flag is a replicated scalar in the step
     outputs (one host read, no extra collective beyond the checksum psum);
  2. flag set  -> retry the step from the same inputs (bounded retries) —
     transient SDC almost never repeats on identical data;
  3. still flagged -> restore from the last checkpoint and *replay the step*
     — this is the persistent-fault path (bad chip).  The replay is
     re-verified: a restore whose replay still flags is retried up to
     ``max_restores`` times and then raised, so the guard never adopts
     unverified state or reports the failed attempt's metrics as the
     step's outcome;
  4. track flag-rate statistics: a chip flagging above `evict_rate` is
     reported via `should_evict` for the cluster layer to act on.

Sticky-fault discrimination: a transient SDC does not recur at one
coordinate, a stuck-at cell does — so the guard remembers the finest
flagged (layer, stripe, slot) sites of its recent flagged steps, and a
site recurring ``persistent_threshold`` times within a
``persistent_window`` of flagged steps is classified *persistent*.  From
then on that site's flags skip the doomed surgical/graph retry tiers
(every re-execution on the same unit re-reads the same stuck state) and
escalate straight to restore->replay with exponential backoff
(``restore_backoff``/``max_backoff``); the guard marks itself ``suspect``
so the serving layer (``engine.streaming.StreamingEngine``) can drain,
checkpoint, and swap to a degraded backend.  ``repair_tiers()`` surfaces
the slot/stripe/graph/restore repair distribution plus the
persistent-site and backoff state for serve stats and BENCH payloads.

Batched multi-graph serving uses :meth:`ABFTGuard.run_step_graphs` instead:
the step emits a *per-graph* verdict vector (the packed block-ELL segmented
epilogue or the dense batched checks), and only the flagged graphs are
retried — a bit flip in one packed graph costs one small re-pack, not a
whole-bucket replay.

At stripe granularity the ladder gains its cheapest rung: when the step
also emits per-stripe verdicts (``abft_stripe_flags``) and a
``stripe_retry_fn`` is given, the guard first attempts a *surgical* repair
— re-execute only the flagged stripes' rows, splice, re-verify
(``engine.localize.surgical_stripe_retry``) — and only escalates to the
per-graph retry, and then to restore->replay, when the repair cannot be
verified.  At slot granularity there is one rung below that: per-(stripe,
ell-slot) verdicts (``abft_slot_flags``) plus a ``slot_retry_fn``
(``engine.localize.surgical_slot_retry``) repair with row-level downstream
propagation, escalating slot -> stripe -> graph -> restore.
``guard.retries`` counts re-executions *performed* on every tier (never
mere intents); ``slot_retries`` / ``stripe_retries`` /
``recomputed_rows`` track the surgical tiers' row economics.

Because the checked step is pure (params, batch) -> outputs, the retry is
exact replay; no optimizer state was committed for a flagged step (the guard
runs *before* state adoption).  ``restore_fn`` either rewinds external state
by side effect (and returns None), or returns the restored *state*, which
the guard substitutes for the step's first positional argument on replay —
so ``restore_fn=lambda: ckpt.restore(state)[0]`` rolls training back to the
checkpoint and the replayed step runs from it.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)


def _host(x: Any, dtype: Any = None) -> np.ndarray:
    """A step metric as a host numpy array.  Metrics arrive as tensors on
    the step's device; ``np.asarray`` of a CUDA tensor raises, so every
    read in this module goes through here.  The first call on a step's
    metrics is that step's first host synchronization."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


@dataclasses.dataclass
class GuardConfig:
    max_retries: int = 2
    max_restores: int = 1        # bounded restore->replay->verify attempts
    evict_rate: float = 1e-3     # flags per step above which chip is suspect
    window: int = 1000           # rolling window (steps) for should_evict
    min_samples: int = 100       # steps seen before eviction is judged
    # sticky-fault discrimination: the same (layer, stripe, slot) site
    # flagging >= persistent_threshold times within the last
    # persistent_window FLAGGED steps is classified *persistent* — a
    # transient SDC does not recur at one coordinate; a stuck-at cell
    # does.  Persistent faults skip the doomed retry tiers (re-executing
    # on the same unit re-reads the same stuck value) and escalate
    # straight to restore->replay.
    persistent_window: int = 8
    persistent_threshold: int = 3
    # exponential backoff between restore escalations: the r-th restore
    # round sleeps restore_backoff * 2^level (capped at max_backoff)
    # before replaying, so a host thrashing on a persistent fault does
    # not hammer the restore path.  0 disables (the default: tests and
    # single-step callers should not sleep).
    restore_backoff: float = 0.0
    max_backoff: float = 30.0


class ABFTGuard:
    def __init__(self, cfg: Optional[GuardConfig] = None,
                 restore_fn: Optional[Callable[[], Any]] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        # cfg is constructed per guard — a dataclass default instance would
        # be one shared mutable object across every guard in the process.
        self.cfg = cfg if cfg is not None else GuardConfig()
        self.restore_fn = restore_fn
        self._sleep = sleep_fn   # injectable: tests assert backoff delays
        self.steps = 0
        self.flags = 0           # lifetime count of flagged steps
        self.retries = 0         # re-executions PERFORMED (any tier)
        self.graph_retries = 0   # individual graphs re-run by partial retry
        self.stripe_retries = 0  # individual stripes re-run surgically
        self.slot_retries = 0    # stripes re-run by the slot-surgical tier
        self.recomputed_rows = 0  # rows re-executed by partial retries
        self.restores = 0
        # per-step flagged? outcomes, newest last; drives the rolling rate —
        # a chip that degraded an hour in must look bad *now*, not diluted
        # by its clean history.
        self._recent: collections.deque = collections.deque(
            maxlen=max(self.cfg.window, 1))
        # sticky-fault discrimination state: the finest flagged coordinates
        # of the last persistent_window FLAGGED adjudications, and the set
        # of sites classified persistent from their recurrence
        self._site_history: collections.deque = collections.deque(
            maxlen=max(self.cfg.persistent_window, 1))
        self.persistent_sites: set = set()
        self.persistent_escalations = 0   # tier-skips on persistent sites
        self.suspect = False              # backend marked suspect
        self._backoff_level = 0           # consecutive restore escalations

    # -- sticky-fault discrimination --------------------------------------

    @staticmethod
    def _flag_sites(metrics, flags: np.ndarray) -> frozenset:
        """The finest available coordinates of this step's flags, as
        stable string keys: per-op ids when the step carries op-keyed
        verdicts (``abft_op_flags`` aligned to the static
        ``abft_op_ids`` tuple — the checked-op serving paths: LM
        prefill/decode, GAT), (layer, stripe, slot) when the step carries
        slot corners, (layer, stripe) at stripe granularity, the graph
        slot otherwise.  Capped at 64 sites — a step that floods more
        coordinates than that is a step-wide event, not a stuck cell."""
        ids = metrics.get("abft_op_ids") if isinstance(metrics, dict) \
            else None
        if ids is not None:
            a = _host(metrics.get("abft_op_flags", False),
                           dtype=bool).ravel()
            ids = tuple(ids)
            if a.any() and a.size == len(ids):
                return frozenset(f"op:{ids[int(i)]}"
                                 for i in np.nonzero(a)[0][:64])
        for key, fmt in (("abft_slot_flags",
                          lambda c: "slot:L{}:S{}:E{}".format(*c)),
                         ("abft_stripe_flags",
                          lambda c: "stripe:L{}:S{}".format(*c))):
            a = _host(metrics.get(key, False), dtype=bool)
            if a.ndim and a.any():
                return frozenset(fmt(tuple(int(v) for v in c))
                                 for c in np.argwhere(a)[:64])
        return frozenset(f"graph:{int(g)}"
                         for g in np.nonzero(flags)[0][:64])

    def _note_sites(self, sites: frozenset) -> frozenset:
        """Record one flagged step's sites; classify any site recurring
        ``persistent_threshold`` times within the window as persistent.
        Returns this step's sites that are (now) classified persistent."""
        self._site_history.append(sites)
        for s in sites:
            if s in self.persistent_sites:
                continue
            if sum(s in past for past in self._site_history) \
                    >= self.cfg.persistent_threshold:
                self.persistent_sites.add(s)
                self.suspect = True
                log.error(
                    "ABFT: site %s flagged %d times within the last %d "
                    "flagged steps — classified PERSISTENT (stuck-at); "
                    "backend marked suspect", s,
                    self.cfg.persistent_threshold,
                    len(self._site_history))
        return sites & self.persistent_sites

    def reset_backend_state(self) -> None:
        """Called by the serving layer after it acts on eviction advice
        (drain + checkpoint + swap to a degraded backend): the rolling
        window, site classifications, suspect mark, and backoff level all
        describe the REPLACED execution path.  Lifetime counters stand."""
        self._recent.clear()
        self._site_history.clear()
        self.persistent_sites.clear()
        self.suspect = False
        self._backoff_level = 0

    def run_step(self, step_fn: Callable[..., Tuple[Any, Any]], *args):
        """step_fn returns (new_state, metrics) where metrics['abft_flag'] is
        the replicated detection scalar.  Returns the adopted (state, metrics)
        — always from a *verified* (unflagged) execution.

        When the metrics carry per-op verdicts (``abft_op_ids`` /
        ``abft_op_flags``, as emitted by the checked-op serving engines —
        LM prefill/decode, GAT) the flagged op ids feed the same site
        history that per-graph serving uses, so a recurring ``op:<id>``
        site is classified persistent and short-circuits the doomed
        retries straight to restore-and-replay.
        """
        self.steps += 1
        step_flagged = False
        metrics = None
        for attempt in range(self.cfg.max_retries + 1):
            out, metrics = step_fn(*args)
            if attempt:
                # counted AFTER the call returns: ``retries`` means
                # re-executions performed, never intents — the same
                # convention as run_step_graphs' partial retries
                self.retries += 1
            flagged = bool(metrics["abft_flag"])
            if not flagged:
                if attempt:
                    log.warning("ABFT: retry %d succeeded", attempt)
                else:
                    self._backoff_level = 0   # clean first try
                self._recent.append(step_flagged)
                return out, metrics
            if not step_flagged:
                step_flagged = True
                self.flags += 1
                sites = self._flag_sites(metrics, np.zeros((0,), bool))
                if sites and self._note_sites(sites):
                    # a known-persistent site flagged again: retrying the
                    # same execution path is wasted work
                    log.error("ABFT: persistent site(s) %s re-flagged — "
                              "skipping retries, restoring",
                              sorted(sites & self.persistent_sites))
                    break
            log.error("ABFT flag on step %d (attempt %d): max_rel=%.3e",
                      self.steps, attempt, float(metrics.get("abft_max_rel", -1)))
        # persistent failure: roll back, replay, and re-verify
        self._recent.append(True)
        return self._restore_and_replay(step_fn, args)

    def run_step_graphs(self, step_fn: Callable[..., Tuple[Any, Any]],
                        retry_fn: Callable[[Any, np.ndarray],
                                           Tuple[Any, Any]], *args,
                        stripe_retry_fn: Optional[
                            Callable[[Any, Any], Tuple[Any, Any]]] = None,
                        slot_retry_fn: Optional[
                            Callable[[Any, Any], Tuple[Any, Any]]] = None):
        """Per-graph guarded batch step for multi-graph serving.

        ``step_fn(*args)`` returns (out, metrics) where
        ``metrics['abft_graph_flags']`` is the per-graph verdict vector (the
        packed segmented check corners, or the dense batched checks).
        Equivalent to dispatching the step yourself and handing its outputs
        to :meth:`adjudicate` — which is exactly what the streaming engine
        does to overlap host-side packing with device execution.
        """
        out, metrics = step_fn(*args)
        return self.adjudicate(out, metrics, retry_fn,
                               stripe_retry_fn=stripe_retry_fn,
                               slot_retry_fn=slot_retry_fn,
                               replay=(step_fn, args))

    @staticmethod
    def _adopt(metrics):
        """Adopted-metrics hygiene: the step's intermediate activations
        (``abft_h_layers``, every layer's full input; ``abft_x_layers``,
        the stashed two-pass combination outputs) exist ONLY so a surgical
        retry can re-execute flagged rows.  Once the ladder has resolved
        they are dead weight — a serving loop that retains per-batch
        metrics would pin every batch's activations for the whole run —
        so they never leave the guard."""
        if isinstance(metrics, dict) and (
                "abft_h_layers" in metrics or "abft_x_layers" in metrics):
            metrics = {k: v for k, v in metrics.items()
                       if k not in ("abft_h_layers", "abft_x_layers")}
        return metrics

    def _surgical_adopt(self, metrics, sub, flags, grel, name: str):
        """Adopted metrics of a verified surgical repair: every fault flag
        cleared, the discarded execution's divergence magnitudes dropped
        (the repair does not reconstruct them), the repaired graphs'
        max_rel replaced from the sub-sweep's corners."""
        metrics = {**metrics, "abft_flag": False,
                   "abft_graph_flags": _host(sub["abft_graph_flags"],
                                                  dtype=bool)}
        for key in ("abft_stripe_flags", "abft_slot_flags"):
            if key in metrics:
                metrics[key] = np.zeros_like(
                    _host(metrics[key], dtype=bool))
        metrics.pop("abft_stripe_max_rel", None)
        metrics.pop("abft_slot_max_rel", None)
        if grel is not None and "abft_graph_max_rel" in sub:
            sub_rel = _host(sub["abft_graph_max_rel"], np.float32)
            if sub_rel.shape != grel.shape:
                raise ValueError(
                    f"{name}_retry_fn returned abft_graph_max_rel "
                    f"of shape {sub_rel.shape}; expected the full "
                    f"batch vector {grel.shape}")
            # replace only the repaired graphs' divergences; the
            # untouched graphs' adopted values stand
            grel = np.where(flags, sub_rel, grel)
            metrics["abft_graph_max_rel"] = grel
            metrics["abft_max_rel"] = grel.max(initial=0.0)
        else:
            metrics.pop("abft_max_rel", None)
        return metrics

    def adjudicate(self, out, metrics,
                   retry_fn: Callable[[Any, np.ndarray], Tuple[Any, Any]],
                   *, stripe_retry_fn: Optional[
                       Callable[[Any, Any], Tuple[Any, Any]]] = None,
                   slot_retry_fn: Optional[
                       Callable[[Any, Any], Tuple[Any, Any]]] = None,
                   replay: Optional[Tuple[Callable[..., Tuple[Any, Any]],
                                          tuple]] = None):
        """Adjudicate one already-dispatched batch step's verdicts.

        ``(out, metrics)`` are a step's raw outputs; reading
        ``metrics['abft_graph_flags']`` here is the first host-side
        synchronization, so a caller that dispatches step N, packs batch
        N+1, and only then adjudicates N gets pack/execute overlap for free
        (CUDA launches are asynchronous) — the streaming engine's double buffer.

        When any graph flags, ``retry_fn(out, flagged_idx)`` re-runs *only*
        those graphs and returns (patched_out, sub_metrics) with the
        per-graph entries of ``sub_metrics`` aligned to ``flagged_idx`` —
        linearity of the checksum makes the per-graph decomposition exact,
        so the untouched graphs' verified results are kept and the returned
        metrics reflect the *adopted* executions, not the failed attempts.
        The retry's returned vectors are validated against ``flagged_idx``:
        a full-batch-aligned vector would silently misattribute verdicts to
        the wrong graphs, so a shape mismatch raises.  Bounded like
        :meth:`run_step`; persistently flagged graphs fall back to the
        restore->replay->verify path via ``replay=(step_fn, args)`` (no
        ``replay`` -> the escalation raises instead of replaying).

        ``stripe_retry_fn(out, metrics)`` is the optional surgical tier,
        tried when the step carries per-stripe verdicts
        (``metrics['abft_stripe_flags']``, granularity="stripe"): it
        re-executes only the flagged stripes' rows and returns
        (patched_out, sub_metrics) with a FULL-batch
        ``sub_metrics['abft_graph_flags']`` vector (all-False on verified
        success) plus ``abft_rows_recomputed`` / ``abft_stripes_recomputed``
        accounting.  An unverified repair escalates to the per-graph tier.
        ``slot_retry_fn(out, metrics)`` is one rung finer, tried FIRST
        when the step carries per-(stripe, slot) verdicts
        (``metrics['abft_slot_flags']``, granularity="slot"): same
        contract, row-level downstream propagation; an unverified slot
        repair escalates to the stripe tier, then per-graph, then
        restore->replay.

        Adopted metrics never carry ``abft_h_layers`` / ``abft_x_layers``
        (the per-layer operand stashes exist for the surgical closures
        only — retaining them per batch would leak every batch's
        activations over a sustained stream); the closures see the full
        metrics.
        """
        self.steps += 1
        flags = _host(metrics["abft_graph_flags"], dtype=bool).copy()
        if not flags.any():
            self._recent.append(False)
            self._backoff_level = 0
            return out, self._adopt(metrics)
        self.flags += 1
        # sticky-fault discrimination BEFORE any repair work: a site
        # already classified persistent makes every surgical/graph retry
        # doomed (the re-execution re-reads the same stuck state), so the
        # ladder is skipped and the step escalates straight to the
        # restore->replay path — with exponential backoff, and the
        # backend marked suspect for the serving layer's eviction logic.
        persistent = self._note_sites(self._flag_sites(metrics, flags))
        if persistent:
            self.persistent_escalations += 1
            self._recent.append(True)
            log.error(
                "ABFT: step %d flags persistent site(s) %s — skipping "
                "the doomed retry tiers, escalating to restore",
                self.steps, sorted(persistent)[:4])
            if replay is None:
                raise RuntimeError(
                    f"ABFT: persistent fault at {sorted(persistent)[:4]} "
                    f"and no replay=(step_fn, args) to escalate to — "
                    f"evict or degrade this backend")
            step_fn, args = replay
            out, metrics = self._restore_and_replay(step_fn, args,
                                                    adopt_state=False)
            return out, self._adopt(metrics)
        grel = None
        if "abft_graph_max_rel" in metrics:
            grel = _host(metrics["abft_graph_max_rel"],
                            dtype=np.float32).copy()
        # --- tier -1: slot-surgical repair -------------------------------
        slflags = _host(metrics.get("abft_slot_flags", False),
                             dtype=bool)
        if slot_retry_fn is not None and slflags.any():
            log.error("ABFT: step %d: %d slot corner(s) flagged; "
                      "attempting slot-surgical repair", self.steps,
                      int(slflags.sum()))
            out2, sub = slot_retry_fn(out, metrics)
            performed = int(sub.get("abft_stripes_recomputed", 0))
            self.retries += int(performed > 0)
            self.slot_retries += performed
            self.recomputed_rows += int(sub.get("abft_rows_recomputed", 0))
            new_flags = _host(sub["abft_graph_flags"], dtype=bool)
            if new_flags.shape != flags.shape:
                raise ValueError(
                    f"slot_retry_fn returned abft_graph_flags of shape "
                    f"{new_flags.shape}; the surgical tier's contract is "
                    f"the FULL batch vector {flags.shape}")
            if not new_flags.any():
                log.warning("ABFT: slot-surgical repair adopted")
                self._recent.append(True)
                metrics = self._surgical_adopt(metrics, sub, flags, grel,
                                               "slot")
                return out2, self._adopt(metrics)
            out, flags = out2, new_flags.copy()
        # --- tier 0: stripe-surgical repair ------------------------------
        sflags = _host(metrics.get("abft_stripe_flags", False),
                            dtype=bool)
        if stripe_retry_fn is not None and sflags.any():
            log.error("ABFT: step %d: %d stripe corner(s) flagged; "
                      "attempting surgical repair", self.steps,
                      int(sflags.sum()))
            out2, sub = stripe_retry_fn(out, metrics)
            performed = int(sub.get("abft_stripes_recomputed", 0))
            # retries counts re-executions PERFORMED: an escalation that
            # bailed before touching any stripe re-executed nothing
            self.retries += int(performed > 0)
            self.stripe_retries += performed
            self.recomputed_rows += int(sub.get("abft_rows_recomputed", 0))
            new_flags = _host(sub["abft_graph_flags"], dtype=bool)
            if new_flags.shape != flags.shape:
                raise ValueError(
                    f"stripe_retry_fn returned abft_graph_flags of shape "
                    f"{new_flags.shape}; the surgical tier's contract is "
                    f"the FULL batch vector {flags.shape}")
            if not new_flags.any():
                log.warning("ABFT: surgical stripe repair adopted")
                self._recent.append(True)
                # adopted metrics only: the per-stripe divergences belong
                # to the discarded execution and are not reconstructed by
                # the repair — drop them rather than report fault-magnitude
                # values under a clean flag
                metrics = self._surgical_adopt(metrics, sub, flags, grel,
                                               "stripe")
                return out2, self._adopt(metrics)
            out, flags = out2, new_flags.copy()
        # --- tier 1: per-graph retry -------------------------------------
        for attempt in range(1, self.cfg.max_retries + 1):
            idx = np.nonzero(flags)[0]
            log.error("ABFT: step %d: %d/%d graphs flagged; retrying them "
                      "(attempt %d)", self.steps, len(idx), len(flags),
                      attempt)
            out, sub = retry_fn(out, idx)
            self.retries += 1
            self.graph_retries += len(idx)
            if "abft_rows_recomputed" in sub:
                self.recomputed_rows += int(sub["abft_rows_recomputed"])
            sub_flags = _host(sub["abft_graph_flags"], dtype=bool)
            if sub_flags.shape != (len(idx),):
                raise ValueError(
                    f"retry_fn returned abft_graph_flags of shape "
                    f"{sub_flags.shape}; expected ({len(idx)},) aligned to "
                    f"flagged_idx — a full-batch vector would be silently "
                    f"misattributed to the wrong graphs")
            flags[idx] = sub_flags
            if grel is not None and "abft_graph_max_rel" in sub:
                sub_rel = _host(sub["abft_graph_max_rel"],
                                     dtype=np.float32)
                if sub_rel.shape != (len(idx),):
                    raise ValueError(
                        f"retry_fn returned abft_graph_max_rel of shape "
                        f"{sub_rel.shape}; expected ({len(idx)},) aligned "
                        f"to flagged_idx")
                grel[idx] = sub_rel
            if not flags.any():
                log.warning("ABFT: per-graph retry %d succeeded", attempt)
                self._recent.append(True)
                metrics = {**metrics, "abft_flag": False,
                           "abft_graph_flags": flags}
                if sflags.any():
                    metrics["abft_stripe_flags"] = np.zeros_like(sflags)
                    metrics.pop("abft_stripe_max_rel", None)
                if slflags.any():
                    metrics["abft_slot_flags"] = np.zeros_like(slflags)
                    metrics.pop("abft_slot_max_rel", None)
                # adopted metrics only: the failed attempts' divergences
                # were replaced along with their outputs — when we cannot
                # reconstruct max_rel per graph, drop it rather than return
                # the discarded execution's value under a clean flag
                if grel is not None:
                    metrics["abft_graph_max_rel"] = grel
                    metrics["abft_max_rel"] = grel.max(initial=0.0)
                else:
                    metrics.pop("abft_max_rel", None)
                return out, self._adopt(metrics)
        self._recent.append(True)
        if replay is None:
            raise RuntimeError(
                "ABFT: persistent per-graph fault and no replay=(step_fn, "
                "args) to escalate to — the dispatching caller must keep "
                "the step closure alive until adjudication")
        # batch steps take data operands, not model state: a state-returning
        # restore_fn cannot be spliced into the args (run_step's convention)
        step_fn, args = replay
        out, metrics = self._restore_and_replay(step_fn, args,
                                                adopt_state=False)
        return out, self._adopt(metrics)

    def _restore_and_replay(self, step_fn, args, *,
                            adopt_state: bool = True) -> Tuple[Any, Any]:
        """Persistent-fault path: restore, replay the step, verify the
        replay.  ``restore_fn`` either rewinds external state by side
        effect (return None) or returns the restored *state*, which — on
        the :meth:`run_step` path, where the first positional argument IS
        the state — replaces it for the replay (the checkpoint-rollback
        convention ``ABFTGuard(restore_fn=lambda: ckpt.restore(state)[0])``
        that train.py uses).  Batch-serving steps (:meth:`run_step_graphs`)
        pass ``adopt_state=False``: their args are data operands, so a
        returned state is ignored.  Never returns flagged metrics; raises
        after ``max_restores`` failed restore+replay rounds."""
        if self.restore_fn is None:
            raise RuntimeError("ABFT: persistent fault and no restore_fn "
                               "given")
        for r in range(1, self.cfg.max_restores + 1):
            if self.cfg.restore_backoff > 0:
                delay = min(self.cfg.restore_backoff
                            * (2 ** self._backoff_level),
                            self.cfg.max_backoff)
                log.error("ABFT: restore backoff %.3fs (level %d)",
                          delay, self._backoff_level)
                self._sleep(delay)
            self._backoff_level += 1
            log.error("ABFT: persistent fault; restore %d/%d + replay",
                      r, self.cfg.max_restores)
            self.restores += 1
            restored = self.restore_fn()
            replay_args = args
            if adopt_state and restored is not None and args:
                replay_args = (restored,) + tuple(args[1:])
            out, metrics = step_fn(*replay_args)
            # batch steps are only required to emit the per-graph vector
            flag = metrics.get(
                "abft_flag",
                _host(metrics["abft_graph_flags"]).any()
                if "abft_graph_flags" in metrics else True)
            if not bool(_host(flag).any()):
                log.warning("ABFT: replay after restore %d verified clean", r)
                return out, metrics
        raise RuntimeError(
            f"ABFT: step still flagged after {self.cfg.max_restores} "
            f"restore+replay attempt(s) — refusing to adopt unverified "
            f"state (suspect persistent hardware fault; evict this host)")

    @property
    def flag_rate(self) -> float:
        """Flagged-step rate over the rolling window (recent behaviour)."""
        if not self._recent:
            return 0.0
        return sum(self._recent) / len(self._recent)

    @property
    def lifetime_flag_rate(self) -> float:
        return self.flags / max(self.steps, 1)

    def should_evict(self) -> bool:
        seen = len(self._recent)
        need = min(self.cfg.min_samples, self.cfg.window)
        return seen >= need and self.flag_rate > self.cfg.evict_rate

    def repair_tiers(self) -> dict:
        """The repair-tier distribution + persistent-fault/backoff state,
        JSON-ready — surfaced by serve() stats, StreamingEngine.stats(),
        and the BENCH payloads."""
        return {
            "slot": self.slot_retries,
            "stripe": self.stripe_retries,
            "graph": self.graph_retries,
            "restore": self.restores,
            "persistent_sites": sorted(self.persistent_sites),
            "persistent_escalations": self.persistent_escalations,
            "suspect": self.suspect,
            "backoff_level": self._backoff_level,
        }
