"""The port's training driver (``repro_torch.launch.train``) against the JAX
package's ``repro/launch/train.py``, on the CPU.

Within the port, on the gemma-2b smoke twin: an uninterrupted run and a
resumed one equal, bit for bit, the direct sequences of train steps that
the reference's resume semantics give (the state after step ``i`` saved
under the label ``i``; a resumed run starts at the label with the data
stream from its first batch — ROADMAP Queue C, standing note).  Across
packages: a run that one package starts is resumed by the other and by
itself, and the two final checkpoints agree within ``ATOL`` (the train
step's parity tolerance, ``tests/test_torch_train.py``).  The CLI runs as
a process with ``--device cpu``, and the encoder-decoder and prefix
families train through the driver with no flag."""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.launch import train as jtrain
from repro.launch.steps import init_train_state as jinit_train_state
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig, tree_leaves

ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(batch=2, seq=16, lr=1e-3)
FLAGS = ["--batch", "2", "--seq", "16", "--ckpt-every", "2"]


def _cfg(arch="gemma-2b"):
    return smoke_config(get_config(arch))


def _quiet(_line):
    pass


def _run(cfg, path, steps, ckpt_every=2):
    return train.train(cfg, steps=steps, ckpt_dir=str(path),
                       ckpt_every=ckpt_every, device="cpu", log=_quiet,
                       **RUN)


def _direct(cfg, state, steps, n_batches):
    """``n_batches`` train steps of a ``--steps steps`` run from ``state``
    over the stream's first batches, as the driver builds its step."""
    step = make_train_step(
        cfg, ABFTConfig(mode="fused", threshold=5e-2, relative=True),
        AdamWConfig(lr=RUN["lr"]), total_steps=steps,
        warmup=max(steps // 10, 1))
    it = SyntheticLM(cfg.vocab_size, RUN["seq"], RUN["batch"],
                     seed=0).batches()
    for _ in range(n_batches):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in next(it).items()})
        assert not bool(m["abft_flag"])
    return state


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) > 0 and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _init(cfg):
    return init_train_state(cfg, 0, device="cpu")


def test_uninterrupted_run_is_its_direct_sequence(tmp_path):
    """``--steps 4 --ckpt-every 2`` from an empty dir: the final state and
    ``step_00000004`` are four direct steps over b0..b3; ``step_00000002``
    holds the state after three (``opt.step == 3``, the reference's
    labelling)."""
    cfg = _cfg()
    out = _run(cfg, tmp_path, 4)
    assert out["started"] == 0 and out["flags"] == 0
    want4 = _direct(cfg, _init(cfg), 4, 4)
    assert _bitwise(out["state"], want4)
    saved, step = load_checkpoint(str(tmp_path), _init(cfg))
    assert step == 4 and _bitwise(saved, want4)
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) \
        == ["step_00000002", "step_00000004"]
    os.remove(tmp_path / "LATEST")
    with open(tmp_path / "LATEST", "w") as f:
        f.write("step_00000002")
    saved, step = load_checkpoint(str(tmp_path), _init(cfg))
    assert step == 2 and int(saved["opt"]["step"]) == 3
    assert _bitwise(saved, _direct(cfg, _init(cfg), 4, 3))
    assert [t["step"] for t in out["ckpt_timings"]] == [2, 4]


def test_resumed_run_replays_the_stream_as_the_reference(tmp_path):
    """``--steps 2`` then ``--steps 4`` on one dir: b0, b1 under the first
    run's schedule, then b0, b1 again (the stream restarts) under the
    second's — bit for bit; a second resume from the same checkpoint gives
    the same bits."""
    cfg = _cfg()
    first = _run(cfg, tmp_path / "a", 2)
    assert first["started"] == 0
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    resumed = _run(cfg, tmp_path / "a", 4)
    assert resumed["started"] == 2 and resumed["flags"] == 0
    want = _direct(cfg, _direct(cfg, _init(cfg), 2, 2), 4, 2)
    assert _bitwise(resumed["state"], want)
    again = _run(cfg, tmp_path / "b", 4)
    assert again["started"] == 2 and _bitwise(again["state"], want)
    saved, step = load_checkpoint(str(tmp_path / "b"), _init(cfg))
    assert step == 4 and _bitwise(saved, want)


def _jmain(monkeypatch, path, steps):
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "gemma-2b", "--smoke", "--steps", str(steps),
        "--ckpt-dir", str(path), *FLAGS])
    jtrain.main()


def _tmain(path, steps):
    return train.main(["--arch", "gemma-2b", "--smoke", "--steps",
                       str(steps), "--ckpt-dir", str(path), "--device", "cpu",
                       *FLAGS])


def _final_leaves(path):
    """The latest checkpoint's label, ``opt.step`` and leaves as numpy,
    read by the reference."""
    jcfg = jsmoke_config(jget_config("gemma-2b"))
    tree, step = j_load(str(path), jinit_train_state(jcfg,
                                                     jax.random.PRNGKey(0)))
    return step, int(tree["opt"]["step"]), [np.asarray(x)
                                            for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("first", ["reference", "port"])
def test_cross_package_resume(tmp_path, monkeypatch, capsys, first):
    """One package writes ``--steps 2``; the other package and the writer
    itself each resume a copy to ``--steps 4``; the two final checkpoints
    agree within ``ATOL`` leaf by leaf."""
    if first == "reference":
        _jmain(monkeypatch, tmp_path / "x", 2)
    else:
        _tmain(tmp_path / "x", 2)
    shutil.copytree(tmp_path / "x", tmp_path / "y")
    out = _tmain(tmp_path / "x", 4)
    assert out["started"] == 2 and out["flags"] == 0
    _jmain(monkeypatch, tmp_path / "y", 4)
    printed = capsys.readouterr().out
    assert printed.count("resumed from step 2") == 2
    assert "abft flags 0" in printed
    (sp, op, port), (sr, orf, ref) = _final_leaves(tmp_path / "x"), \
        _final_leaves(tmp_path / "y")
    assert sp == sr == op == orf == 4 and len(port) == len(ref) > 0
    for x, y in zip(port, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_allclose(x, y, atol=ATOL, rtol=0)


def test_cli_runs_as_a_process_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma-2b", "--smoke", "--steps", "2", "--device", "cpu",
         "--ckpt-dir", str(tmp_path), *FLAGS],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "abft flags 0" in done.stdout
    assert os.listdir(tmp_path / "step_00000002")


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_front_end_families_train_through_the_driver(tmp_path, arch):
    """whisper's seeded ``src_embeds`` (the reference's draw) and
    internvl2's 8 zero ``prefix_embeds``: two steps, no flag, params
    moved, a checkpoint that restores bit for bit."""
    cfg = _cfg(arch)
    out = _run(cfg, tmp_path, 2)
    assert out["flags"] == 0 and np.isfinite(float(out["metrics"]["loss"]))
    assert not _bitwise(out["state"]["params"], _init(cfg)["params"])
    saved, step = load_checkpoint(str(tmp_path), _init(cfg))
    assert step == 2 and _bitwise(saved, out["state"])


def test_driver_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "gemma-2b", "--smoke", "--steps", "1"])

