"""Independent streams from one ``--seed``: every draw of a run (weights,
the order of lengths, each batch's tokens, the sample compared) takes its
own 63-bit seed, made from the run's seed and the draw's labels."""
from __future__ import annotations

import hashlib


def stream(seed: int, *labels) -> int:
    text = "/".join(str(x) for x in (int(seed),) + labels)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1
