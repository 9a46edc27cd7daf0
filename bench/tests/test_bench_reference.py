"""The plain references against the program at smoke widths on the CPU:
the same weights (the benchmark's draw), the same tokens, logits at every
position within float32 rounding.  The test imports both; the reference
modules import nothing of the program."""
import pytest
import torch

from bench.lib import runner, spec, weights
from bench.reference import common, moe
from bench.tests.smoke import smoke_cell


def _port_logits(config, params, tokens):
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.models.transformer import model_forward

    cfg = runner.model_config(config)
    logits, _rep, _aux = model_forward(params, cfg, {"tokens": tokens},
                                       ABFTConfig(mode="none"))
    return logits


DENSE, MOE = "chatglm3-6b.long_doc_unguarded", \
    "deepseek-moe-16b.score_unguarded"


@pytest.mark.parametrize("name,cf", [(DENSE, None), (MOE, None), (MOE, 0.5)])
def test_reference_equals_program(name, cf):
    cell = smoke_cell(name)
    run = cell.config["run"]
    if cf is not None:       # a capacity that drops assignments
        run["moe"] = dict(run["moe"], capacity_factor=cf)
    runner.set_numerics()
    params = weights.draw(run, 11, "cpu")
    tokens = torch.randint(0, run["vocab_size"], (1, 24),
                           generator=torch.Generator().manual_seed(3))
    want = _port_logits(cell.config, params, tokens)[0, :, :run["vocab_size"]]
    ref = spec.reference_module(cell.config)
    got, stats = ref.logits(params, run, tokens, list(range(24)), 0.0)
    got = torch.stack([c[0] for c in got[0]])[:, :run["vocab_size"]]
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4), \
        (got - want).abs().max()
    if cf is not None:
        assert stats["dropped"] > 0


def test_moe_near_tie_candidates():
    cell = smoke_cell(MOE)
    run = cell.config["run"]
    runner.set_numerics()
    params = weights.draw(run, 5, "cpu")
    tokens = torch.randint(0, run["vocab_size"], (1, 16),
                           generator=torch.Generator().manual_seed(1))
    # every layer a "near tie": 2 layers, 4 candidates, the first the
    # main pass
    cands, stats = moe.logits(params, run, tokens, [15], tie=1e9)
    assert cands[0][0].shape[0] == 4 and stats["ties"] == 2
    main, _ = moe.logits(params, run, tokens, [15], tie=0.0)
    assert torch.equal(cands[0][0][0], main[0][0][0])
    # following the position alone with nothing swapped is the main pass
    cap = common.Capture()
    before = []
    k, e = run["moe"]["top_k"], run["moe"]["n_experts"]

    def mlp(lp, h, layer):
        lg, ex, gates = moe._route(lp, h, k)
        oh = torch.nn.functional.one_hot(ex.reshape(-1), e)
        seen = torch.cumsum(oh, 0) - oh
        before.append(seen[15 * k][None, None])
        return moe._experts(lp, h, ex, gates, torch.ones_like(ex, dtype=bool)
                            ) + moe._shared(lp, h)

    common.forward(params, run, tokens, [15], mlp, cap)
    alone = moe._follow(params, run, cap, before, 0, 0, 15, 0, set(), 10 ** 6)
    assert torch.allclose(alone, main[0][0][0], atol=1e-4, rtol=1e-4)
    # a swap changes the logits
    assert not torch.allclose(cands[0][0][1], main[0][0][0])


def test_reference_needs_tf32_off():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            common.require_f32_matmul()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
