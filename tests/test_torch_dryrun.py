"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's reckoning.

Each cell runs through ``run_cell`` on a smoke twin over a fake (2, 4)
("data", "model") mesh: gemma-2b at every shape, and one cell each of a
model with a front end (internvl2-26b), a mixture of experts
(qwen3-moe-30b-a3b) and the two recurrent families (recurrentgemma-9b,
rwkv6-7b at long_500k).  Its ``argument_bytes`` equal, exactly, the
reference's per-device reckoning from its own specs: Σ local shape ×
itemsize over the reference's ``jax.eval_shape`` trees (params, and the
optimizer state to train, or the decode state and the int32 position to
decode; the batch from its ``make_batch_specs``), each leaf divided by
the reference's ``ShardingRules`` spec — computed here without compiling.
The skipped cells are the reference's ``cell_supported``'s; a second call
reads the cache, an error is retried; the CLI exits 0 on skipped cells.
The ``"fake"`` process group lives for this module only."""
import importlib
import json
import math
import os

import jax
import numpy as np
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.data.synthetic import make_batch_specs as jmake_batch_specs
from repro.launch.mesh import ShardingRules as JShardingRules
from repro.models.transformer import init_decode_state as jinit_decode_state
from repro.models.transformer import init_model as jinit_model
from repro_torch.configs import SHAPES, get_config, list_archs, smoke_config
from repro_torch.launch import dryrun

MESH = (2, 4)
AXES = ("data", "model")
CELLS = [("gemma-2b", "train_4k"), ("gemma-2b", "prefill_32k"),
         ("gemma-2b", "decode_32k"), ("gemma-2b", "long_500k"),
         ("internvl2-26b", "decode_32k"), ("qwen3-moe-30b-a3b", "decode_32k"),
         ("recurrentgemma-9b", "decode_32k"), ("rwkv6-7b", "long_500k")]


class StandIn:
    axis_names = AXES
    shape = dict(zip(AXES, MESH))


@pytest.fixture(scope="module")
def fake_group():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", rank=0, world_size=math.prod(MESH),
                            store=FakeStore())
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module; it sets ``XLA_FLAGS`` when
    imported, which is put back."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


def _local_bytes(tree, spec_of):
    """Σ over the leaves of an eval_shape tree of the local shape (each dim
    over the mesh axes its spec names) × itemsize."""
    total = 0
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        spec = tuple(spec_of(key, tuple(leaf.shape)))
        n = 1
        for i, d in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else \
                (entry,) if isinstance(entry, str) else entry
            size = math.prod(StandIn.shape[a] for a in axes)
            assert d % size == 0
            n *= d // size
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def reference_argument_bytes(arch, shape_name):
    jcfg = jsmoke_config(jget_config(arch))
    shape = JSHAPES[shape_name]
    rules = JShardingRules(StandIn())
    params = jax.eval_shape(lambda: jinit_model(jcfg, jax.random.PRNGKey(0)))
    p_bytes = _local_bytes(params, rules.param_spec)
    batch = jmake_batch_specs(jcfg, shape)
    b_bytes = _local_bytes(batch, lambda k, s: rules.batch_spec(s, s[0]))
    if shape.kind == "train":
        return 3 * p_bytes + 4 + b_bytes               # params, m, v, step
    if shape.kind == "prefill":
        return p_bytes + b_bytes
    b = shape.global_batch
    state = jax.eval_shape(lambda: jinit_decode_state(jcfg, b,
                                                      shape.seq_len))
    s_bytes = _local_bytes(state, lambda k, s: rules.cache_spec(
        k, s, b, jcfg.n_kv_heads))
    return p_bytes + s_bytes + b_bytes + 4             # + the int32 pos


def _run(arch, shape, out_dir, force=True):
    return dryrun.run_cell(arch, shape, multi_pod=False, out_dir=out_dir,
                           force=force, device="cpu",
                           cfg=smoke_config(get_config(arch)),
                           mesh_shape=MESH)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_argument_bytes_equal_the_reference_reckoning(
        fake_group, ref_dryrun, tmp_path, arch, shape):
    rec = _run(arch, shape, str(tmp_path))
    skip = ref_dryrun.cell_supported(jget_config(arch), JSHAPES[shape])
    if skip:
        assert rec["status"] == "skipped" and rec["reason"] == skip
        return
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["memory"]["argument_bytes"] == \
        reference_argument_bytes(arch, shape)
    assert rec["n_devices"] == math.prod(MESH)
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    coll = rec["collectives"]
    assert coll["by_depth"] == {"0": coll["per_device_bytes_unweighted"]}
    assert coll["per_device_bytes_unweighted"] == sum(
        coll["by_kind"].values())
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["temp_bytes"]
    assert set(rec) >= {"trace_s", "flops_per_device", "bytes_per_device",
                        "collectives", "memory", "n_devices"}
    path = tmp_path / f"{arch}__{shape}__pod1__fused.json"
    assert json.loads(path.read_text()) == rec


def test_skipped_cells_equal_cell_supported(ref_dryrun):
    for arch in list_archs():
        for name in SHAPES:
            assert dryrun.cell_supported(get_config(arch), SHAPES[name]) == \
                ref_dryrun.cell_supported(jget_config(arch), JSHAPES[name])


def test_second_call_reads_the_cache_and_errors_are_retried(
        fake_group, tmp_path, monkeypatch):
    first = _run("gemma-2b", "decode_32k", str(tmp_path))
    assert first["status"] == "ok"

    def no_trace(*a, **kw):
        raise AssertionError("a cached cell was traced again")
    monkeypatch.setattr(dryrun, "step_cost_analysis", no_trace)
    assert _run("gemma-2b", "decode_32k", str(tmp_path), force=False) == \
        first
    err = _run("gemma-2b", "decode_32k", str(tmp_path))       # forced
    assert err["status"] == "error" and "traced again" in err["error"]
    monkeypatch.undo()
    again = _run("gemma-2b", "decode_32k", str(tmp_path), force=False)
    assert again["status"] == "ok"
    assert again["memory"] == first["memory"]


def test_cli_skips_full_attention_at_long_500k(tmp_path, capsys):
    dryrun.main(["--arch", "gemma-2b", "--shape", "long_500k", "--mesh",
                 "both", "--out", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("SKIP  gemma-2b") == 2
    assert "done: 0 ok, 2 skipped, 0 errors" in out


def test_a_failed_cell_exits_1(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **kw: {
        "status": "error", "error": "RuntimeError: boom"})
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                     "--mesh", "pod1", "--out", str(tmp_path), "--device",
                     "cpu"])
    assert ex.value.code == 1
    assert "ERROR gemma-2b" in capsys.readouterr().out
