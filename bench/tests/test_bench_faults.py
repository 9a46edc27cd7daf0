"""The comparison that decides ``correct`` fails where it should: the
lower precision's control, served in the program's place, comes out not
correct in every cell, and so does a run driven with the timed path broken
underneath (each fault a cell can have).  At smoke widths on the CPU; the
cells' own sizes are read on the card by ``bench/calibrate.py``."""
import pytest
import torch

from bench.tests.smoke import CELLS, run_cpu, smoke_cell


class _Pass:
    def __init__(self, eng):
        self.eng = eng

    def prefill(self, tokens):
        return self.eng.prefill(tokens)

    def decode(self, states, tokens, pos):
        return self.eng.decode(states, tokens, pos)

    def stats(self):
        return self.eng.stats()


class AlteredToken(_Pass):
    """A token altered where it is produced: the first request's first
    logits put another token first."""

    def prefill(self, tokens):
        logits, states, m = self.eng.prefill(tokens)
        logits = logits.clone()
        top = int(torch.argmax(logits[0, -1, :256]))
        logits[0, -1, (top + 1) % 256] += 100.0
        return logits, states, m


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = smoke_cell(name, lengths=(32, 48, 64, 80), requests=64)
    # depth enough for bfloat16's rounding to add up, as it does over the
    # published 28 layers
    cell.config["run"]["n_layers"] = 8
    assert run_cpu(cell)["correct"] is True
    out = run_cpu(cell, control=True)
    assert out["correct"] is False, out["checks"]


FAULTS = [(name, AlteredToken) for name in CELLS]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_fault_is_not_correct(name, fault):
    out = run_cpu(smoke_cell(name, requests=64), wrap_engine=fault)
    assert out["correct"] is False, out["checks"]
