"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): the reference's own checkpoint tests
(round trip, retention, async, elastic restore) on the port, then the two
packages' files — a tree written by either restores into the other leaf for
leaf and bit for bit, with the same npz names and manifest entries — on
the reference's test tree and on a smoke train state.  bfloat16 leaves are
written with the reference's bytes and restore in the port; the reference
cannot read them back (ROADMAP Queue C, standing note on the reference's
checkpoints).  Everything runs on the CPU."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.launch.steps import init_train_state as jinit_train_state
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    reshard_restore, save_checkpoint)
from repro_torch.checkpoint.ckpt import _flatten, latest_step_dir
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.steps import init_train_state
from repro_torch.optim import tree_leaves


def _np_tree(seed=0):
    """The reference's ``tests/test_infra.py`` ``_tree()``, as numpy."""
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(4, 8)).astype(np.float32),
            "b": [rng.normal(size=(3,)).astype(np.float32),
                  {"c": np.asarray(7, np.int32)}]}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _tree(seed=0):
    return _map(_np_tree(seed), torch.from_numpy)


def _jtree(seed=0):
    return _map(_np_tree(seed), jnp.asarray)


def _pair(kind):
    """(the port's tree, the reference's tree) of one structure: the
    reference's test tree with the same values, or a smoke gemma-2b train
    state (each package's own draw)."""
    if kind == "test_tree":
        return _tree(), _jtree()
    state = init_train_state(smoke_config(get_config("gemma-2b")), 0,
                             device="cpu")
    jstate = jinit_train_state(jsmoke_config(jget_config("gemma-2b")),
                               jax.random.PRNGKey(0))
    return state, jstate


def _host_leaves(tree):
    """A tree's leaves as numpy arrays, whichever package's tree it is."""
    if isinstance(tree_leaves(tree)[0], torch.Tensor):
        return [x.numpy() for x in tree_leaves(tree)]
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _assert_leaves_bitwise(got, want):
    got_l, want_l = _host_leaves(got), _host_leaves(want)
    assert len(got_l) == len(want_l) > 0
    for x, y in zip(got_l, want_l):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


# ---------------------------------------------------------------------------
# the reference's checkpoint tests (tests/test_infra.py), on the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree)
    restored, step = load_checkpoint(str(tmp_path), tree)
    assert step == 5
    for x, y in zip(tree_leaves(tree), tree_leaves(restored)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = _tree()
    for s in (1, 2, 3):
        mgr.save(s, tree)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000002", "step_00000003"]
    restored, step = mgr.restore(tree)
    assert step == 3
    assert [t["step"] for t in mgr.timings] == [1, 2, 3]
    assert all(t["snapshot_s"] >= 0 and t["write_s"] >= 0
               for t in mgr.timings)


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    mgr.save(1, _tree())
    mgr.wait()
    _, step = mgr.restore(_tree())
    assert step == 1


def test_checkpoint_snapshot_is_taken_before_save_returns(tmp_path):
    """The writer thread writes the values the tree held when ``save`` was
    called, whatever happens to the tensors afterwards."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    tree = _tree()
    want = [x.clone() for x in tree_leaves(tree)]
    mgr.save(1, tree)
    for x in tree_leaves(tree):
        x.add_(1)
    mgr.wait()
    restored, _ = mgr.restore(tree)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(restored),
                                                  want))


def test_elastic_reshard_restore(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 9, tree)
    placements = _map(tree, lambda _: None)
    restored, step = reshard_restore(str(tmp_path), tree, placements)
    assert step == 9
    placements["a"] = "cpu"
    placements["b"][0] = torch.device("cpu")
    restored, step = reshard_restore(str(tmp_path), tree, placements)
    assert step == 9
    for x, y in zip(tree_leaves(tree), tree_leaves(restored)):
        assert y.device.type == "cpu" and torch.equal(x, y)
    assert reshard_restore(str(tmp_path / "none"), tree, placements) == \
        (None, -1)


def test_no_checkpoint_restores_nothing(tmp_path):
    assert load_checkpoint(str(tmp_path), _tree()) == (None, -1)
    assert j_load(str(tmp_path), _jtree()) == (None, -1)


# ---------------------------------------------------------------------------
# the two packages' files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["test_tree", "train_state"])
def test_keys_are_the_references(kind):
    """Leaf keys: dict keys sorted, list indices, ``/``-joined — what the
    reference derives from ``jax.tree_util.tree_flatten_with_path``."""
    tree, jtree = _pair(kind)
    want = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert [k for k, _ in _flatten(tree)] == want


@pytest.mark.parametrize("kind", ["test_tree", "train_state"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, kind):
    tree, jtree = _pair(kind)
    j_save(str(tmp_path), 4, jtree, extra={"who": "reference"})
    restored, step = load_checkpoint(str(tmp_path), tree)
    assert step == 4
    _assert_leaves_bitwise(restored, jtree)


@pytest.mark.parametrize("kind", ["test_tree", "train_state"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, kind):
    tree, jtree = _pair(kind)
    save_checkpoint(str(tmp_path), 4, tree, extra={"who": "port"})
    restored, step = j_load(str(tmp_path), jtree)
    assert step == 4
    _assert_leaves_bitwise(restored, tree)


@pytest.mark.parametrize("kind", ["test_tree", "train_state"])
def test_both_packages_write_the_same_files(tmp_path, kind):
    """One tree's values written by each package: the same npz names, the
    same manifest (keys, shapes, dtypes, step, extra), the same bytes."""
    tree, jtree = _pair(kind)
    jtree = _map(tree, lambda t: jnp.asarray(t.numpy()))
    save_checkpoint(str(tmp_path / "port"), 2, tree, extra={"k": 1})
    j_save(str(tmp_path / "ref"), 2, jtree, extra={"k": 1})
    dirs = [str(tmp_path / who / "step_00000002") for who in ("port", "ref")]
    assert [sorted(os.listdir(d)) for d in dirs] == [
        ["host0.npz", "manifest.json"]] * 2
    manifests = [json.load(open(os.path.join(d, "manifest.json")))
                 for d in dirs]
    assert manifests[0] == manifests[1]
    assert list(manifests[0]["leaves"]) == list(manifests[1]["leaves"])
    files = [np.load(os.path.join(d, "host0.npz")) for d in dirs]
    assert files[0].files == files[1].files
    for name in files[0].files:
        x, y = files[0][name], files[1][name]
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert [open(str(tmp_path / who / "LATEST")).read()
            for who in ("port", "ref")] == ["step_00000002"] * 2


def test_manager_interop_keeps_the_references_retention(tmp_path):
    """The two managers write into one directory in turn: each restores
    the other's latest step, and retention counts both packages' dirs."""
    tree, jtree = _tree(), _jtree(seed=1)
    port = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    ref = JManager(str(tmp_path), keep=2, async_write=False)
    port.save(1, tree)
    ref.save(2, jtree)
    restored, step = port.restore(tree)
    assert step == 2
    _assert_leaves_bitwise(restored, jtree)
    port.save(3, tree)
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == ["step_00000002",
                                                "step_00000003"]
    restored, step = ref.restore(jtree)
    assert step == 3
    _assert_leaves_bitwise(restored, tree)


# ---------------------------------------------------------------------------
# bfloat16, None leaves, and the reference's _gc
# ---------------------------------------------------------------------------

def _bf16():
    return torch.arange(-3, 3, dtype=torch.float32).reshape(2, 3).div(
        7).to(torch.bfloat16)


def test_bf16_leaf_round_trips_in_the_port(tmp_path):
    tree = {"a": _bf16(), "f": torch.ones(2)}
    save_checkpoint(str(tmp_path), 1, tree)
    manifest = json.load(open(tmp_path / "step_00000001" / "manifest.json"))
    assert manifest["leaves"]["a"] == {"shape": [2, 3], "dtype": "bfloat16"}
    restored, _ = load_checkpoint(str(tmp_path), tree)
    assert restored["a"].dtype == torch.bfloat16
    assert torch.equal(restored["a"], tree["a"])


def test_bf16_leaf_has_the_references_bytes(tmp_path):
    """The port writes a bfloat16 leaf as the reference does (``|V2``, the
    same bytes, ``"bfloat16"`` in the manifest), and restores the
    reference's bfloat16 file."""
    tree = {"a": _bf16()}
    jtree = {"a": jnp.asarray(tree["a"].float().numpy(), jnp.bfloat16)}
    save_checkpoint(str(tmp_path / "port"), 1, tree)
    j_save(str(tmp_path / "ref"), 1, jtree)
    arrs = [np.load(str(tmp_path / who / "step_00000001" / "host0.npz"))["a"]
            for who in ("port", "ref")]
    assert arrs[0].dtype == arrs[1].dtype == np.dtype("V2")
    assert arrs[0].tobytes() == arrs[1].tobytes()
    assert [json.load(open(tmp_path / who / "step_00000001" /
                           "manifest.json")) for who in ("port", "ref")][0] \
        == json.load(open(tmp_path / "ref" / "step_00000001" /
                          "manifest.json"))
    restored, _ = load_checkpoint(str(tmp_path / "ref"), tree)
    assert torch.equal(restored["a"], tree["a"])


def test_reference_cannot_restore_a_bf16_leaf(tmp_path):
    """Pins the reference's defect (ROADMAP Queue C standing note): its
    own bfloat16 file does not load — the port keeps writing the same bytes
    and restores them itself."""
    jtree = {"a": jnp.asarray(_bf16().float().numpy(), jnp.bfloat16)}
    j_save(str(tmp_path), 1, jtree)
    with pytest.raises(TypeError, match="V2"):
        j_load(str(tmp_path), jtree)


def test_none_is_no_leaf(tmp_path):
    tree = {"a": torch.ones(2), "n": None, "l": [None, torch.zeros(1)]}
    save_checkpoint(str(tmp_path), 1, tree)
    manifest = json.load(open(tmp_path / "step_00000001" / "manifest.json"))
    assert list(manifest["leaves"]) == ["a", "l/1"]
    restored, _ = load_checkpoint(str(tmp_path), tree)
    assert restored["n"] is None and restored["l"][0] is None
    assert torch.equal(restored["l"][1], tree["l"][1])


@pytest.mark.parametrize("package", ["port", "reference"])
def test_gc_counts_a_half_written_dir_as_the_reference_does(tmp_path,
                                                            package):
    """A half-written ``step_N.tmp0`` dir does not end in "tmp", so both
    managers count it as a step and it can push a real one out (ROADMAP
    Queue C standing note)."""
    os.makedirs(tmp_path / "step_00000009.tmp0")
    if package == "port":
        mgr, tree = CheckpointManager(str(tmp_path), keep=2,
                                      async_write=False), _tree()
    else:
        mgr, tree = JManager(str(tmp_path), keep=2, async_write=False), \
            _jtree()
    for s in (1, 2):
        mgr.save(s, tree)
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == ["step_00000002",
                                                "step_00000009.tmp0"]
    assert latest_step_dir(str(tmp_path)).endswith("step_00000002")
