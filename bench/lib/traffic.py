"""The one traffic generator: closed-loop batches read from a cell's
``traffic`` parameters.

``{"loop": "closed", "batch": B, "prompt_lengths": [...], "new_tokens": n,
"cache_len": c}``: batch i holds B prompts of one length, the i-th of the
multiset ``prompt_lengths`` cycled in an order the seed shuffles, so every
whole cycle does the same work whatever the seed; token ids uniform over
the vocabulary, drawn on the device from the seed and the batch's index.
Each prompt is followed by ``new_tokens`` greedy tokens (the first from the
prefill), decoded through a cache of ``cache_len`` positions."""
from __future__ import annotations

import random
from typing import List

import torch

from bench.lib import seeds

KEYS = {"loop", "batch", "prompt_lengths", "new_tokens", "cache_len"}


class Traffic:
    def __init__(self, spec: dict, seed: int, vocab: int):
        if set(spec) != KEYS or spec["loop"] != "closed":
            raise ValueError(f"traffic parameters {sorted(spec)}: want "
                             f"{sorted(KEYS)} with loop 'closed'")
        self.batch = int(spec["batch"])
        self.new = int(spec["new_tokens"])
        self.cache_len = int(spec["cache_len"])
        lengths: List[int] = [int(x) for x in spec["prompt_lengths"]]
        if self.batch < 1 or self.new < 1 or not lengths or min(lengths) < 1:
            raise ValueError(f"empty or non-positive traffic: {spec}")
        if max(lengths) + self.new - 1 > self.cache_len:
            raise ValueError(f"cache_len {self.cache_len} holds no prompt of "
                             f"{max(lengths)} and {self.new - 1} more tokens")
        random.Random(seeds.stream(seed, "order")).shuffle(lengths)
        self.cycle = lengths
        self.seed = seed
        self.vocab = vocab

    def length(self, i: int) -> int:
        return self.cycle[i % len(self.cycle)]

    def tokens(self, i: int, device, label: str = "tokens") -> torch.Tensor:
        """Batch i's prompts, int32 [B, T]."""
        gen = torch.Generator(device=device).manual_seed(
            seeds.stream(self.seed, label, i))
        return torch.randint(0, self.vocab, (self.batch, self.length(i)),
                             generator=gen, device=device, dtype=torch.int32)

    def warmup_indices(self) -> List[int]:
        """Index of one batch of each length of the first cycle, longest
        first: every shape the window serves."""
        return [self.cycle.index(n) for n in sorted(set(self.cycle),
                                                    reverse=True)]
