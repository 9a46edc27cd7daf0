"""Runs one of the port's examples as a process, for the examples' CPU
parity tests (``tests/test_torch_examples_{gcn,lm}.py``)."""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = {"jax", "jaxlib", "repro"}


def run_example(name, *args, cwd=ROOT, timeout=300):
    """``examples/torch_<name>.py args`` as a process: its stdout.  Asserts
    exit 0 and that no module of ``jax`` or of the JAX package ``repro`` was
    imported (``-X importtime`` lists every import on stderr)."""
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src")}
    done = subprocess.run(
        [sys.executable, "-X", "importtime",
         str(ROOT / "examples" / f"torch_{name}.py"), *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    assert done.returncode == 0, done.stderr[-4000:]
    imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                for line in done.stderr.splitlines()
                if line.startswith("import time:")}
    assert "repro_torch" in imported
    assert not imported & _FORBIDDEN, sorted(imported & _FORBIDDEN)
    return done.stdout


def chip_smoke_gates(name, out):
    """Asserts that ``out``, the output of ``examples/torch_<name>.py`` run
    on the CPU, shows what ``chip_smoke.py``'s ``examples`` phase asks of
    that example on the card (its patterns and further check), so that
    the phase's gates and the examples' printed lines cannot drift apart.
    Returns how many runs of the phase were held."""
    import importlib.util
    import re
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    n = 0
    for ex, _argv, patterns, _kernels, check in chip_smoke.example_runs(
            "unused"):
        if ex != name:
            continue
        n += 1
        assert [p for p in patterns if not re.search(p, out, re.M)] == []
        assert check is None or check(out), check.__name__
    return n
