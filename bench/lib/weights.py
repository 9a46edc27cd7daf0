"""Weights drawn on the device from the run's seed, in the param-tree layout
the program takes, leaf by leaf as the configuration's layout
(``bench/layouts/``) lists them: one ``normal_`` call a leaf on a CUDA
generator, float32 (the served type), at the standard deviation the layout
gives."""
from __future__ import annotations

from typing import Dict

import torch

from bench.layouts import decoder
from bench.lib import seeds


def draw(run: dict, seed: int, device, layout=decoder) -> Dict:
    """The param tree for ``run`` from ``seed``, on ``device``: every leaf
    of ``layout.leaf_specs(run)``, with ``segments`` a list whose entry i is
    the drawn segment ``"<i>"``."""
    gen = torch.Generator(device=device).manual_seed(
        seeds.stream(seed, "weights"))
    tree: Dict = {}
    for path, shape, std in layout.leaf_specs(run):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t.normal_(0.0, std, generator=gen)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    segs = tree.get("segments", {})
    if set(segs) != {str(i) for i in range(len(segs))}:
        raise ValueError(f"segments {sorted(segs)} are not numbered 0 .. "
                         f"{len(segs) - 1}")
    tree["segments"] = [segs[str(i)] for i in range(len(segs))]
    return tree
