"""The harness of the kernel-variant tools (``wide_tile_variants.py``,
``spmm_variants.py``): variants of one CUDA source built side by side with
``nvcc`` for ``sm_90a``, run in turns, twice, and held against the base.

A tool states the source, its variants (name -> [(text in the source, its
replacement)]; every replaced text must be found, or the run stops), a C
``main`` with the placeholder ``SHAPES`` and the shapes to put there (one
``{d0, d1, ...}`` initialiser each), and a parser of ``ptxas -v``'s output.
A variant's ``main`` takes one argument, a path prefix; for each shape it
writes its outputs as float32 to ``<prefix>_<d0>_<d1>_....bin`` and prints
one line: the shape's numbers, the mean milliseconds of a launch, and a CUDA
error code.  The ``diag_*`` variants drop work to show where the time goes;
their outputs are wrong and not compared.
"""
from __future__ import annotations

import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Variants = Dict[str, List[Tuple[str, str]]]


def variant_source(source: str, variants: Variants, main: str,
                   shapes: Sequence[Sequence[int]], name: str) -> str:
    text = Path(source).read_text()
    for old, new in variants[name]:
        if old not in text:
            raise SystemExit(f"{name}: text to replace not found:\n{old}")
        text = text.replace(old, new, 1)
    inits = ", ".join("{%s}" % ", ".join(map(str, s)) for s in shapes)
    return text + main.replace("SHAPES", inits)


def build(out: str, name: str, text: str, parse_registers: Callable):
    """Compile one variant into ``out``; returns what ``parse_registers``
    makes of ``ptxas -v``'s output."""
    src, exe = os.path.join(out, name + ".cu"), os.path.join(out, name)
    Path(src).write_text(text)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    done = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                           "-std=c++17", "-O3", "-Xptxas", "-v", "-o", exe,
                           src], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{done.stdout}")
    return parse_registers(done.stdout)


def run(names: Sequence[str], *, source: str, variants: Variants, main: str,
        shapes: Sequence[Sequence[int]], out: str,
        parse_registers: Callable,
        same_association: Optional[set] = None,
        describe: Optional[Callable] = None) -> int:
    """Build ``names`` (every variant when empty; the base always), run
    them in turns twice and print one JSON object per run and variant, then
    the card's name and power limit.  A variant in ``same_association``
    (None: every one but the ``diag_*``) must give the base's outputs bit
    for bit; the others report their largest difference from the base.
    ``describe(dims, ms)`` gives the JSON value of a shape's time (default:
    the milliseconds)."""
    names = list(names) or list(variants)
    if "base" not in names:
        names = ["base"] + names
    os.makedirs(out, exist_ok=True)

    def one(name):
        text = variant_source(source, variants, main, shapes, name)
        return name, build(out, name, text, parse_registers)
    with ThreadPoolExecutor(len(names)) as pool:
        regs = dict(pool.map(one, names))
    for run_ in (1, 2):
        for name in names:
            text = subprocess.run([os.path.join(out, name),
                                   os.path.join(out, "o_" + name)],
                                  stdout=subprocess.PIPE, text=True,
                                  check=True).stdout
            times, diffs = {}, {}
            for line in text.split("\n"):
                if not line.strip():
                    continue
                *dims, ms, err = line.split()
                if int(err):
                    raise SystemExit(f"{name}: CUDA error {err}")
                tag = "x".join(dims)
                times[tag] = describe(dims, float(ms)) if describe \
                    else float(ms)
                if name.startswith("diag_"):
                    continue
                suffix = "_".join(dims) + ".bin"
                a = np.fromfile(os.path.join(out, f"o_{name}_{suffix}"),
                                np.float32)
                b = np.fromfile(os.path.join(out, f"o_base_{suffix}"),
                                np.float32)
                same = same_association is None or name in same_association
                if same and a.tobytes() != b.tobytes():
                    raise SystemExit(f"{name}: {tag} differs from the base")
                diffs[tag] = float(np.abs(a - b).max())
            print(json.dumps(dict(run=run_, variant=name,
                                  registers=regs[name], times=times,
                                  max_abs_diff_vs_base=diffs or None)),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip())
    return 0
