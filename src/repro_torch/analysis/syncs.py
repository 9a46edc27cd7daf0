"""Host-sync & recompile lint: AST rules over the port's dispatch layers.

Counterpart of the JAX package's ``repro/analysis/syncs.py``, its rules
retargeted to PyTorch.  The streaming engine's performance contract is
"one bounded host sync per adjudicated batch"; this pass holds it
statically over ``src/repro_torch/{engine,launch,faults}/``.

Rules (all stdlib ``ast`` — no new dependencies):

* ``implicit-sync-in-loop`` — ``float()``, ``int()``, ``bool()`` of a
  non-constant, ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``np.asarray()`` / ``np.array()``, ``torch.cuda.synchronize()`` and an
  event's ``.synchronize()`` inside a ``for`` / ``while`` body.  On a
  tensor on the card each of these blocks the Python thread until the
  device has caught up; inside a dispatch loop that serializes the stream.
* ``backend-query-in-loop`` — ``torch.cuda.is_available()`` /
  ``device_count()`` / ``get_device_name()`` in a loop; the answer never
  changes.  The resolution sites ``repro_torch/device.py`` and
  ``kernels/runtime.py`` are exempt.
* ``jit-in-loop`` — ``torch.compile(...)`` (or a ``functools.partial`` of
  it) or ``torch.cuda.CUDAGraph()`` built inside a loop: every iteration
  compiles or captures anew — the unbounded-recompile bug class.
* ``pack-without-caps`` — a ``pack_graphs(...)`` call with none of
  ``stripe_cap`` / ``width_cap`` / ``stripe_multiple`` /
  ``width_multiple``: every distinct graph shape then mints a distinct
  packed shape (bounded-shape discipline).
* ``mutable-default`` — list/dict/set (or call) default argument
  values; and
* ``fold-in-loop`` — ``fold_w_r(...)`` or ``fold_lm_w_r(...)`` inside a
  loop body: the fold is weight-load-time work, re-folding per step
  recomputes every layer's w_r.

Suppression: append ``# abftlint: <rule>-ok`` (or the generic
``# abftlint: ok``) to the flagged line, with the reason after it —
intended syncs (the guard's verdict read, a benchmark's result collection)
are annotated at the site, so the gate stays zero-findings.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Set

# call names that force a device->host transfer (or wait on the device)
# when applied to a tensor on the card
_SYNC_BUILTINS = {"float", "int", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_SYNC_NP_FUNCS = {"asarray", "array"}
_BACKEND_QUERIES = {"is_available", "device_count", "get_device_name"}
_COMPILES = {"torch.compile", "torch.cuda.CUDAGraph", "CUDAGraph"}
_FOLDS = {"fold_w_r", "fold_lm_w_r"}

_SUPPRESS_RE = re.compile(r"#\s*abftlint:\s*([a-z0-9_,\- ]+)")

DEFAULT_SCAN_DIRS = ("src/repro_torch/engine", "src/repro_torch/launch",
                     "src/repro_torch/faults")
# the blessed resolution sites for backend queries
EXEMPT_FILES = ("repro_torch/device.py", "kernels/runtime.py")


@dataclasses.dataclass(frozen=True)
class SyncFinding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"


def _suppressions(source: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            tags = {t.strip() for t in m.group(1).replace(",", " ").split()}
            out[i] = tags
    return out


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('np.asarray',
    'torch.cuda.synchronize')."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.loop_depth = 0
        self.findings: List[SyncFinding] = []

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(SyncFinding(
            rule=rule, path=self.path, line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0), message=message))

    # -- loops ------------------------------------------------------------

    def visit_For(self, node: ast.For) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_While = visit_For  # type: ignore[assignment]
    visit_AsyncFor = visit_For  # type: ignore[assignment]

    # -- defs: mutable defaults ------------------------------------------

    def visit_FunctionDef(self, node) -> None:
        for default in list(node.args.defaults) + \
                [d for d in node.args.kw_defaults if d is not None]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set, ast.Call)):
                self._flag("mutable-default", default,
                           f"mutable default argument in {node.name}(); "
                           f"shared across calls — default to None")
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    # -- calls ------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        tail = name.rsplit(".", 1)[-1]

        if self.loop_depth > 0:
            if name in _SYNC_BUILTINS and node.args and \
                    not isinstance(node.args[0], ast.Constant):
                self._flag("implicit-sync-in-loop", node,
                           f"{name}(...) in a loop blocks on device "
                           f"transfer when its operand is traced/device "
                           f"data; hoist to the stats flush or annotate")
            elif tail in _SYNC_METHODS and isinstance(node.func,
                                                      ast.Attribute):
                self._flag("implicit-sync-in-loop", node,
                           f".{tail}() in a loop is a per-iteration host "
                           f"sync; batch the transfer outside the loop")
            elif tail in _SYNC_NP_FUNCS and name.split(".")[0] in \
                    ("np", "numpy", "onp"):
                self._flag("implicit-sync-in-loop", node,
                           f"{name}(...) in a loop copies device data to "
                           f"host per iteration; hoist one bulk transfer")
            elif tail in _BACKEND_QUERIES and name.startswith("torch.cuda"):
                self._flag("backend-query-in-loop", node,
                           f"{name}() in a loop; resolve the device once "
                           f"via repro_torch.device.resolve_device")
            if name in _COMPILES or (
                    tail == "partial" and node.args and
                    _dotted(node.args[0]) == "torch.compile"):
                self._flag("jit-in-loop", node,
                           f"{name} inside a loop compiles or captures "
                           f"anew every iteration (unbounded recompiles); "
                           f"build it once outside")

        if tail == "pack_graphs":
            kw = {k.arg for k in node.keywords}
            if not kw & {"stripe_cap", "width_cap", "stripe_multiple",
                         "width_multiple"}:
                self._flag("pack-without-caps", node,
                           "pack_graphs without stripe/width caps or "
                           "multiples: every graph-shape mix mints a new "
                           "packed shape -> a new compile; quantize the "
                           "shape menu")
        if tail in _FOLDS and self.loop_depth > 0:
            self._flag("fold-in-loop", node,
                       f"{tail} inside a loop re-derives every layer's "
                       f"w_r per iteration; fold once at weight load")
        self.generic_visit(node)


def scan_source(source: str, path: str = "<string>") -> List[SyncFinding]:
    """Lint one module's source; suppressed findings are dropped."""
    tree = ast.parse(source, filename=path)
    v = _Visitor(path)
    v.visit(tree)
    sup = _suppressions(source)
    out = []
    for f in v.findings:
        if not any(_suppresses(t, f.rule) for t in sup.get(f.line, ())):
            out.append(f)
    return out


def _suppresses(tag: str, rule: str) -> bool:
    """``# abftlint: ok`` silences everything on the line; a rule tag
    (``implicit-sync-in-loop-ok``) or an unambiguous shorthand whose stem
    appears in the rule name (``sync-ok``, ``backend-query-ok``) silences
    just that rule."""
    if tag == "ok" or tag == rule or tag == f"{rule}-ok":
        return True
    return tag.endswith("-ok") and tag[:-3] in rule


def scan_file(path: Path) -> List[SyncFinding]:
    return scan_source(path.read_text(), str(path))


def scan_paths(paths: Iterable[Path], *,
               exempt: Sequence[str] = EXEMPT_FILES) -> List[SyncFinding]:
    findings: List[SyncFinding] = []
    for p in sorted(paths):
        if any(p.as_posix().endswith(e) for e in exempt):
            continue
        findings.extend(scan_file(p))
    return findings


def scan_tree(root: Path, *, dirs: Sequence[str] = DEFAULT_SCAN_DIRS
              ) -> List[SyncFinding]:
    """Lint the port's dispatch layers (engine/, launch/, faults/) under
    ``root``."""
    files: List[Path] = []
    for d in dirs:
        base = root / d
        if base.is_dir():
            files.extend(base.rglob("*.py"))
    return scan_paths(files)
