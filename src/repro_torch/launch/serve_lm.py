"""Guarded transformer LM serving driver.

Counterpart of the JAX package's ``repro/launch/serve_lm.py``: prefill +
greedy decode through :class:`~repro_torch.engine.lm.LMEngine`, i.e. under
the full ABFT ladder — every dense product is a checked op on the
``matmul_abft`` kernel, prefill attention is the fused carried-column chain
on the ``flash_checksum`` kernel, per-op verdicts are keyed ``op:<id>`` for
the guard, a flagged step retries, a persistent flag refolds the working
params from the pristine master and replays.

The driver makes the two acceptance claims executable:

* **clean overhead is checks-only** — on a clean run the guarded logits are
  verified bit-identical to the unguarded (``mode="none"``) forward,
  prefill and every decode step;
* **the ladder repairs** — ``--inject-at`` fires the attention accumulator
  fault on one step and the driver verifies it was flagged, repaired, and
  the final tokens match the clean reference.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --new 16 \\
        --inject-at 3 --assert-clean              # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu \\
        --assert-clean                            # plain versions, CPU

The model is ``smoke_config(get_config(--arch))``, as in the JAX driver.
``--json PATH`` writes the payload (nothing is written by default).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig
from repro_torch.device import resolve_device
from repro_torch.engine.lm import LMEngine
from repro_torch.models.transformer import model_decode, model_prefill


def _next_tokens(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def _clean_reference(engine: LMEngine, tokens, n_new: int):
    """The unguarded ``mode='none'`` trajectory on the MASTER params:
    per-step logits + greedy tokens, the bit-identity baseline."""
    off = ABFTConfig(mode="none")
    cfg, params = engine.cfg, engine._master
    logits, states, _ = model_prefill(params, cfg, {"tokens": tokens}, off,
                                      engine.cache_len)
    ref_logits, ref_tokens = [logits], []
    t0 = tokens.shape[1]
    for i in range(n_new):
        nxt = _next_tokens(logits)
        ref_tokens.append(nxt)
        logits, states, _ = model_decode(params, cfg, states, nxt, t0 + i,
                                         off)
        ref_logits.append(logits)
    return ref_logits, ref_tokens


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--new", type=int, default=16,
                    help="greedy decode steps after the prefill")
    ap.add_argument("--mode", default="fused",
                    choices=["none", "split", "fused"])
    ap.add_argument("--threshold", type=float, default=1e-3)
    ap.add_argument("--inject-at", type=int, default=None,
                    help="fire the attention-accumulator fault on this "
                         "decode step (-1 = during prefill) and verify the "
                         "guard detects + repairs it")
    ap.add_argument("--inject-delta", type=float, default=25.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="",
                    help="write the machine-readable payload here "
                         "('' — the default — writes nothing)")
    ap.add_argument("--assert-clean", action="store_true",
                    help="exit non-zero unless guarded logits are "
                         "bit-identical to the unguarded forward (and the "
                         "injected fault, if any, was detected+repaired)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(get_config(args.arch))
    abft = ABFTConfig(mode=args.mode, threshold=args.threshold,
                      relative=True)
    cache_len = args.prompt + args.new
    engine = LMEngine.init(cfg, abft, args.seed, device=dev,
                           cache_len=cache_len)
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(args.batch, args.prompt)).astype(
            np.int32)).to(dev)
    print(f"=== serve_lm: {cfg.name} batch={args.batch} "
          f"prompt={args.prompt} new={args.new} abft={args.mode} "
          f"({dev}) ===")

    # the bit-identity baseline: unguarded mode="none" on the master
    ref_logits, ref_tokens = _clean_reference(engine, tokens, args.new)

    # clean guarded pass
    logits, states, _m = engine.prefill(tokens)
    identical = bool(torch.equal(logits, ref_logits[0]))
    for i in range(args.new):
        nxt = _next_tokens(logits)
        identical &= bool(torch.equal(nxt, ref_tokens[i]))
        logits, states, _m = engine.decode(states, nxt, args.prompt + i)
        identical &= bool(torch.equal(logits, ref_logits[i + 1]))
    clean_flags = engine.guard.flags
    print(f"clean guarded trajectory bit-identical to unguarded: "
          f"{identical} (flags={clean_flags})")

    # timed sustained phase (measures the guarded steps)
    _sync(dev)
    t0 = time.perf_counter()
    logits, states, _m = engine.prefill(tokens)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(args.new):
        nxt = _next_tokens(logits)
        logits, states, _m = engine.decode(states, nxt, args.prompt + i)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    ms_step = t_decode / max(args.new, 1) * 1e3
    print(f"prefill {args.batch}x{args.prompt}: {t_prefill*1e3:.0f} ms; "
          f"decoded {args.new} steps in {t_decode:.2f}s "
          f"({ms_step:.1f} ms/step)")

    # fault demo: one transient accumulator upset through the full ladder
    fault = None
    if args.inject_at is not None:
        flags0, retries0 = engine.guard.flags, engine.guard.retries
        toks, _stats = engine.generate(tokens, args.new,
                                       inject_at=args.inject_at,
                                       inject_delta=args.inject_delta)
        detected = engine.guard.flags > flags0
        repaired = bool(torch.equal(
            toks, torch.cat(ref_tokens, dim=1)[:, :args.new]))
        fault = {"inject_at": args.inject_at,
                 "inject_delta": args.inject_delta,
                 "detected": bool(detected),
                 "repaired_bitwise": repaired,
                 "retries": engine.guard.retries - retries0}
        print(f"fault demo: inject_at={args.inject_at} "
              f"delta={args.inject_delta} detected={fault['detected']} "
              f"repaired_bitwise={fault['repaired_bitwise']}")

    stats = engine.stats()
    print(f"guard: steps={stats['steps']} flags={stats['flags']} "
          f"retries={stats['retries']} restores={stats['restores']} "
          f"flag_rate={stats['flag_rate']:.4f}")
    if dev.type != "cuda":
        print("WARNING: plain PyTorch versions on the CPU (no GPU kernel "
              "ran) — detection results are functional, timings are not "
              "device timings")

    payload = {
        "benchmark": "lm_serve",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "authoritative": dev.type == "cuda",
        "config": {"arch": args.arch, "model": cfg.name,
                   "batch": args.batch, "prompt": args.prompt,
                   "new": args.new, "mode": args.mode,
                   "threshold": args.threshold, "seed": args.seed},
        "clean": {"bitwise_identical": identical,
                  "flags": int(clean_flags)},
        "timings": {"prefill_ms": t_prefill * 1e3,
                    "decode_ms_per_step": ms_step},
        "fault": fault,
        "guard": stats,
    }
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.json}")

    if args.assert_clean:
        failures = []
        if not identical:
            failures.append("guarded logits diverged from the unguarded "
                            "forward on a clean run")
        if clean_flags:
            failures.append(f"clean run flagged {clean_flags} steps")
        if fault is not None and not (fault["detected"]
                                      and fault["repaired_bitwise"]):
            failures.append(f"injected fault not repaired: {fault}")
        if failures:
            for f in failures:
                print(f"FAIL: {f}", file=sys.stderr)
            sys.exit(1)
        print("gates: clean bit-identity" +
              (", fault detected+repaired" if fault else "") + " — ok")
    return payload


if __name__ == "__main__":
    main()
