"""The harness of the A/B tools (``spmm_ab.py``, ``flash_ab.py``): one
kernel of several checkouts timed with one yardstick, side by side on one
NVIDIA GPU.

A tool states ``measure(root) -> dict``, which times the kernel of the
checkout at ``root`` on operands made by this checkout's ``chip_smoke.py``;
``main`` runs it once per root given on the command line, in the order
given, each in a process of its own with that root's ``src/`` first on the
path (so its kernels are built from its own sources into its own
``build/``), prints one JSON object per root, then the card's name and
power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke(root: str):
    """This checkout's ``chip_smoke`` module, with ``root``'s ``src/``
    ahead of this checkout's on the path; call before importing
    ``repro_torch``."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                 # puts ROOT/src on the path
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    return cs


def main(script: str, measure) -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    for root in sys.argv[1:] or ["."]:
        subprocess.run([sys.executable, os.path.abspath(script), "--one",
                        root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip())
    return 0
