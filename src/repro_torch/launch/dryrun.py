"""Multi-pod dry run: trace every (arch × shape × mesh) cell once on fake
DTensors and record its per-device cost.

Counterpart of the JAX package's ``repro/launch/dryrun.py``, which forces
512 host devices and lowers + compiles each cell's jitted step with its
inputs sharded by ``ShardingRules`` on the production mesh.  Here a cell
builds that mesh over a ``"fake"`` process group of 256 or 512 ranks (this
process is rank 0; collectives move nothing), makes params, optimizer
state, batch and decode state as DTensors placed by
:class:`~repro_torch.launch.mesh.ShardingRules` whose local shards are
``meta`` tensors (shapes only: nothing is allocated, no kernel runs — the
sites' fake implementations give their outputs) and runs the step once
under :func:`~repro_torch.launch.costs.step_cost_analysis`; its outputs
are then redistributed to the reference's ``out_shardings``.
Each cell is written to ``<out>/<arch>__<shape>__<mesh>__<abft>.json``:
``flops_per_device``, ``bytes_per_device``, ``collectives``, ``memory``,
``n_devices`` and ``trace_s`` (there is no compile; the reference records
``lower_s`` and ``compile_s``).  ``argument_bytes`` is the exact sum of
rank 0's local input shards, the decode position counted as the int32
scalar the reference passes (the port's step takes it as an ``int``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --mesh pod1 --device cpu

``--device`` is the mesh's device type (default ``cuda``, which asks for
the card; the shards stay on ``meta`` either way).  Exits 1 when a cell
fails.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import traceback
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.abft import ABFTConfig
from repro_torch.data.synthetic import make_batch_specs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.costs import step_cost_analysis
from repro_torch.launch.mesh import (NamedSharding, ShardingRules,
                                     local_shape, make_production_mesh,
                                     make_test_mesh, sharding_leaves)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.transformer import init_decode_state, init_model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.tree import tree_leaves, tree_unflatten

RESULTS = os.environ.get("DRYRUN_OUT", "results/dryrun")


# long_500k needs sub-quadratic attention — skips recorded per DESIGN.md.
def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: 500k decode is quadratic (DESIGN.md)"
    return None


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A default process group of ``world_size`` ranks on the ``"fake"``
    backend (this process is rank 0), destroyed on exit; an existing
    default group of that size is used as it is."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks exists; the cell needs {world_size}")
        yield
        return
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def meta_dtensor(like: torch.Tensor, sharding: NamedSharding):
    """A DTensor of ``like``'s shape and dtype placed by ``sharding``, its
    local shard a ``meta`` tensor (every rank's shard has one shape: the
    rules' shardings divide exactly)."""
    from torch.distributed.tensor import DTensor

    mesh, placements = sharding
    shape = tuple(like.shape)
    return DTensor.from_local(
        torch.empty(local_shape(shape, sharding), dtype=like.dtype,
                    device="meta"), mesh, placements, run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _meta_tree(tree: Any, shardings: Any) -> Any:
    shs = sharding_leaves(tree, shardings)
    return tree_unflatten(tree, iter([
        meta_dtensor(t, sh) for t, sh in zip(tree_leaves(tree), shs)]))


def _place(out: Any, shardings: Any) -> Any:
    """Each DTensor of ``out`` redistributed to the matching sharding (the
    reference's ``out_shardings``)."""
    return tree_unflatten(out, iter([
        t.redistribute(*sh) if hasattr(t, "redistribute") else t
        for t, sh in zip(tree_leaves(out), sharding_leaves(out, shardings))]))


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, abft: ABFTConfig
               ) -> Tuple[Any, tuple, int]:
    """``(fn, args, extra argument bytes)``: the cell's step with its
    outputs placed as the reference places them, and its sharded ``meta``
    inputs; the extra bytes are the decode position's int32 scalar."""
    rules = ShardingRules(mesh)
    params = init_model(cfg, device="meta")
    pshard = rules.params_shardings(params)
    batch = make_batch_specs(cfg, shape)
    bshard = rules.batch_shardings(batch)
    rep = rules.replicated()
    fparams = _meta_tree(params, pshard)
    fbatch = _meta_tree(batch, bshard)
    b = shape.global_batch
    logits_shard = NamedSharding(
        mesh, rules.batch_spec((b, 1, cfg.padded_vocab), b))

    if shape.kind == "train":
        opt = {"m": params, "v": params,
               "step": torch.empty((), dtype=torch.int32, device="meta")}
        oshard = {"m": pshard, "v": pshard, "step": rep}
        state = {"params": fparams, "opt": _meta_tree(opt, oshard)}
        sshard = {"params": pshard, "opt": oshard}
        step = make_train_step(cfg, abft, AdamWConfig())

        def train(state, batch):
            new, metrics = step(state, batch)
            return _place(new, sshard), _place(metrics, rep)
        return train, (state, fbatch), 0

    if shape.kind == "prefill":
        # VLM/audio stubs prepend 64 frame/patch embeddings to the stream
        prefix = 64 if (cfg.frontend and cfg.family != "encdec") else 0
        cache_len = shape.seq_len + prefix
        step = make_prefill_step(cfg, abft, cache_len=cache_len)
        st_shard = rules.state_shardings(
            init_decode_state(cfg, b, cache_len, device="meta"), b,
            cfg.n_kv_heads)

        def prefill(params, batch):
            logits, states, metrics = step(params, batch)
            return (_place(logits, logits_shard), _place(states, st_shard),
                    _place(metrics, rep))
        return prefill, (fparams, fbatch), 0

    # decode
    states = init_decode_state(cfg, b, shape.seq_len, device="meta")
    st_shard = rules.state_shardings(states, b, cfg.n_kv_heads)
    step = make_decode_step(cfg, abft)
    pos = shape.seq_len - 1

    def decode(params, states, tokens):
        logits, states, metrics = step(params, states, tokens, pos)
        return (_place(logits, logits_shard), _place(states, st_shard),
                _place(metrics, rep))
    return decode, (fparams, _meta_tree(states, st_shard),
                    fbatch["tokens"]), 4


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             abft_mode: str = "fused", out_dir: str = RESULTS,
             force: bool = False, device: DeviceLike = "cuda",
             cfg: Optional[ModelConfig] = None,
             mesh_shape: Optional[Tuple[int, ...]] = None) -> Dict[str, Any]:
    """One cell, cached in ``out_dir`` (an ``ok`` or ``skipped`` record is
    read back unless ``force``; an error is always retried).  ``cfg`` and
    ``mesh_shape`` replace the arch's config and the production mesh's
    shape (a smoke twin on a small fake mesh, for tests); the file name
    keeps the arch and mesh tags."""
    mesh_tag = "pod2" if multi_pod else "pod1"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_tag}__{abft_mode}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            cached = json.load(f)
        if cached.get("status") in ("ok", "skipped"):
            return cached        # errors are always retried

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "abft": abft_mode, "status": "?",
    }
    skip = cell_supported(cfg, shape)
    if skip:
        rec.update(status="skipped", reason=skip)
        _write(out_path, rec)
        return rec

    abft = ABFTConfig(mode=abft_mode, threshold=2e-2, relative=True)
    try:
        dev = resolve_device(device)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        n = math.prod(mesh_shape) if mesh_shape else (512 if multi_pod
                                                      else 256)
        with fake_process_group(n):
            mesh = make_test_mesh(mesh_shape, axes, device=dev) \
                if mesh_shape else \
                make_production_mesh(multi_pod=multi_pod, device=dev)
            fn, args, pos_bytes = build_cell(cfg, shape, mesh, abft)
            cost = step_cost_analysis(fn, *args)
            del fn, args
        cost["memory"]["argument_bytes"] += pos_bytes
        cost["memory"]["peak_bytes"] += pos_bytes
        rec.update(
            status="ok",
            trace_s=round(cost["trace_s"], 1),
            flops_per_device=cost["flops"],
            bytes_per_device=cost["bytes accessed"],
            collectives=cost["collectives"],
            memory=cost["memory"],
            n_devices=n,
        )
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug to record
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    _write(out_path, rec)
    return rec


def _write(path: str, rec: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["pod1", "pod2", "both"])
    ap.add_argument("--abft", default="fused")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (default cuda; cpu on "
                         "a machine without a card)")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"pod1": [False], "pod2": [True],
              "both": [False, True]}[args.mesh]
    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, multi_pod=mp,
                               abft_mode=args.abft, out_dir=args.out,
                               force=args.force, device=args.device)
                tag = f"{arch:22s} {shape:12s} {'pod2' if mp else 'pod1'}"
                if rec["status"] == "ok":
                    n_ok += 1
                    coll = rec["collectives"]["per_device_bytes_unweighted"]
                    print(f"OK    {tag} trace={rec['trace_s']}s "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"peak={rec['memory']['peak_bytes']/2**30:.2f}GiB "
                          f"coll(unw)={coll / 2**20:.1f}MiB", flush=True)
                elif rec["status"] == "skipped":
                    n_skip += 1
                    print(f"SKIP  {tag} — {rec['reason']}", flush=True)
                else:
                    n_err += 1
                    print(f"ERROR {tag} — {rec['error']}", flush=True)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
