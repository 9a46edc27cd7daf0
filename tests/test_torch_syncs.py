"""The port's host-sync lint (``repro_torch.analysis.syncs``): the cases of
the reference's ``tests/test_abftlint.py`` syncs section with PyTorch
fixtures — every rule fires, suppressions (generic and rule-scoped) work,
constants and top-level calls do not fire, and the port's dispatch layers
(``engine/``, ``launch/``, ``faults/``) sweep clean — and, on the
framework-neutral fixtures, the reference's own findings."""
import pathlib

import pytest

from repro.analysis.syncs import scan_source as j_scan_source
from repro_torch.analysis import syncs
from repro_torch.analysis.syncs import scan_source, scan_tree

REPO = pathlib.Path(__file__).resolve().parents[1]

SYNC_SNIPPETS = {
    "implicit-sync-in-loop": "for r in batch:\n    x = float(vals[r])\n",
    "backend-query-in-loop":
        "import torch\nwhile run:\n    b = torch.cuda.is_available()\n",
    "jit-in-loop":
        "import torch\nfor s in steps:\n    f = torch.compile(step)\n",
    "pack-without-caps": "pb = pack_graphs(graphs, block=8)\n",
    "mutable-default": "def f(x, acc=[]):\n    return acc\n",
    "fold-in-loop": "for s in steps:\n    p = fold_w_r(params, cfg)\n",
}

# the fixtures that name no framework: the reference's findings, as they are
NEUTRAL = ("implicit-sync-in-loop", "pack-without-caps", "mutable-default",
           "fold-in-loop")


@pytest.mark.parametrize("rule", sorted(SYNC_SNIPPETS))
def test_rule_fires(rule):
    findings = scan_source(SYNC_SNIPPETS[rule], path=f"<{rule}>")
    assert any(f.rule == rule for f in findings), findings


@pytest.mark.parametrize("tag", ["ok", "sync-ok", "implicit-sync-in-loop-ok"])
def test_suppression(tag):
    src = ("for r in batch:\n"
           f"    x = float(vals[r])  # abftlint: {tag} (a reason)\n")
    assert scan_source(src) == []


def test_suppression_is_rule_scoped():
    # a fold-in-loop tag must NOT silence a sync finding
    src = ("for r in batch:\n"
           "    x = float(vals[r])  # abftlint: fold-ok\n")
    assert [f.rule for f in scan_source(src)] == ["implicit-sync-in-loop"]


def test_sync_methods_and_numpy_copies():
    src = ("import numpy as np\n"
           "import torch\n"
           "for r in batch:\n"
           "    a = out.item()\n"
           "    b = np.asarray(out)\n"
           "    c = vals.tolist()\n"
           "    d = out.cpu()\n"
           "    e = out.numpy()\n"
           "    torch.cuda.synchronize()\n"
           "    done.synchronize()\n"
           "    f = int(n)\n"
           "    g = bool(flag)\n")
    findings = scan_source(src)
    assert [f.rule for f in findings] == ["implicit-sync-in-loop"] * 9
    assert [f.line for f in findings] == list(range(4, 13))


@pytest.mark.parametrize("call", ["torch.cuda.is_available()",
                                  "torch.cuda.device_count()",
                                  "torch.cuda.get_device_name(0)"])
def test_backend_queries(call):
    src = f"import torch\nfor r in batch:\n    x = {call}\n"
    assert [f.rule for f in scan_source(src)] == ["backend-query-in-loop"]
    assert scan_source(f"import torch\nx = {call}\n") == []


@pytest.mark.parametrize("call", [
    "torch.compile(step)", "torch.cuda.CUDAGraph()",
    "functools.partial(torch.compile, mode='reduce-overhead')(step)"])
def test_compiles_and_captures_in_a_loop(call):
    src = f"import functools, torch\nwhile run:\n    f = {call}\n"
    assert "jit-in-loop" in [f.rule for f in scan_source(src)]
    assert scan_source(f"import functools, torch\nf = {call}\n") == []


def test_lm_fold_in_a_loop():
    src = "for s in steps:\n    p = fold_lm_w_r(params, cfg, abft)\n"
    assert [f.rule for f in scan_source(src)] == ["fold-in-loop"]


def test_constants_and_top_level_calls_are_fine():
    src = ("x = float(vals[0])\n"            # not in a loop
           "y = out.item()\n"
           "for r in batch:\n"
           "    z = int(8)\n")               # constant operand
    assert scan_source(src) == []


def test_resolution_sites_are_exempt(tmp_path):
    site = tmp_path / "repro_torch" / "device.py"
    site.parent.mkdir()
    site.write_text(SYNC_SNIPPETS["backend-query-in-loop"])
    other = tmp_path / "repro_torch" / "other.py"
    other.write_text(SYNC_SNIPPETS["backend-query-in-loop"])
    found = syncs.scan_paths([site, other])
    assert [pathlib.Path(f.path).name for f in found] == ["other.py"]


def test_port_dispatch_layers_sweep_clean():
    findings = scan_tree(REPO)
    assert findings == [], "\n".join(str(f) for f in findings)
    files = [p for d in syncs.DEFAULT_SCAN_DIRS
             for p in (REPO / d).rglob("*.py")]
    assert {p.parent.name for p in files} == {"engine", "launch", "faults"}


def test_every_suppression_in_the_dispatch_layers_gives_a_reason():
    bare = []
    for d in syncs.DEFAULT_SCAN_DIRS:
        for p in (REPO / d).rglob("*.py"):
            for i, line in enumerate(p.read_text().splitlines(), 1):
                if "# abftlint:" in line and "(" not in line.split(
                        "# abftlint:", 1)[1]:
                    bare.append(f"{p.relative_to(REPO)}:{i}")
    assert bare == []


@pytest.mark.parametrize("rule", NEUTRAL)
def test_neutral_fixtures_give_the_references_findings(rule):
    src = SYNC_SNIPPETS[rule]
    mine = [f.to_dict() for f in scan_source(src, path="<x>")]
    theirs = [f.to_dict() for f in j_scan_source(src, path="<x>")]
    assert mine == theirs and mine
