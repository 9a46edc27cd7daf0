"""Layouts (``bench/layouts/``) on the CPU: the default layout draws both
configurations' trees and gives their arithmetic exactly as the harness did
before layouts existed (values pinned from that harness), and a layout in a
file outside ``bench/`` with two segments and ``dk != dv`` is drawn and
counted with no file of the benchmark changed."""
import ast
import hashlib
import json
import textwrap

import pytest
import torch

from bench.layouts import decoder
from bench.lib import arith, spec, weights
from bench.tests.smoke import ROOT, smoke_run

BENCH = spec.load_json(ROOT / "BENCHMARK.json")
CONFIGS = {c["name"]: spec.load_json(ROOT / c["file"])
           for c in BENCH["configs"]}


def tree_digest(tree) -> str:
    """sha256 over every leaf's path, dtype, shape and bytes, keys sorted."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            t = node.detach().to("cpu").contiguous()
            h.update(f"{'/'.join(path)}{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.numpy().tobytes())

    walk(tree, ())
    return h.hexdigest()


# the harness before layouts: weights.draw(smoke_run(run), 11, "cpu")
DRAW_SHA256 = {
    "chatglm3-6b":
        "6237fee7ed1d33fdbfdb544ed80d4ca2114485905f0761b42f49e60384a2eaf4",
    "deepseek-moe-16b":
        "a4a56c51fcf95929af52843a16b42030e871f429091b0c7be477314543270f90",
}
# the same harness at published widths: (sha256 of json.dumps(leaf_specs),
# leaf count) and, by prompt length at B 1 and one new token,
# (matmul_least_s checked, unchecked, flash_least_s checked, unchecked,
# model_flops)
SPECS = {
    "chatglm3-6b": (
        "2302eb754980bf9e87a75f08b8fdb96c7180e4d794641041869507ad192ac2e0",
        15),
    "deepseek-moe-16b": (
        "88f4f49248014197b3f276cb74d24c2d95b6f3649825c00c00c914f3d3d3481e",
        16),
}
ARITH = {
    "chatglm3-6b": {
        4096: (0.6986557591625074, 0.6985387519694328, 0.05767561607259701,
               0.05745119733301492, 50630546685952),
        6144: (1.047824587089433, 1.047649078745791, 0.12975957802029853,
               0.12925467693850745, 78831771713536),
        8192: (1.396993415016358, 1.3967594055221493, 0.23067430924226864,
               0.2297767438366567, 108957142089728)},
    "deepseek-moe-16b": {
        512: (0.03712291023976119, 0.03710231188250746,
              0.0004513606151641791, 0.0004496043481791045, 2499612246016),
        1024: (0.07399528710997015, 0.07395409284202985,
               0.0018036827701492539, 0.0017966645492537314,
               5058934603776),
        1536: (0.11086766398017911, 0.11080587380155223,
               0.004056966464955224, 0.004041180603223881, 7678386503680),
        2048: (0.14774004085038805, 0.14765765476107462,
               0.00721121169958209, 0.007183152510089553, 10357967945728)},
}


def _prompt_lengths(config: str):
    return sorted({n for w in BENCH["workloads"] if w["config"] == config
                   for n in spec.load_json(
                       ROOT / "bench" / "workloads" / f"{w['name']}.json")
                   ["traffic"]["prompt_lengths"]})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_default_layout_draws_the_same_tree(name):
    config = CONFIGS[name]
    assert "layout" not in config
    layout = spec.layout_module(config)
    assert layout is decoder
    tree = weights.draw(smoke_run(config["run"]), 11, "cpu", layout)
    assert tree_digest(tree) == DRAW_SHA256[name]
    # the default argument is the same layout
    assert tree_digest(weights.draw(smoke_run(config["run"]), 11, "cpu")) \
        == DRAW_SHA256[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_default_layout_gives_the_same_arithmetic(name):
    run = CONFIGS[name]["run"]
    specs = decoder.leaf_specs(run)
    assert (hashlib.sha256(json.dumps(specs).encode()).hexdigest(),
            len(specs)) == SPECS[name]
    lengths = _prompt_lengths(name)
    assert lengths == sorted(ARITH[name])
    for n in lengths:
        got = (arith.matmul_least_s(run, 1, n, 1, True, decoder),
               arith.matmul_least_s(run, 1, n, 1, False, decoder),
               arith.flash_least_s(run, 1, n, True, decoder),
               arith.flash_least_s(run, 1, n, False, decoder),
               arith.model_flops(run, 1, n, 1, decoder))
        assert got == ARITH[name][n], n
        # the old signatures, without a layout
        assert (arith.matmul_least_s(run, 1, n, 1, True),
                arith.matmul_least_s(run, 1, n, 1, False),
                arith.flash_least_s(run, 1, n, True),
                arith.flash_least_s(run, 1, n, False),
                arith.model_flops(run, 1, n, 1)) == got


# a family the harness does not hold: one dense layer, then MoE layers, and
# attention whose keys are wider than its values
TOY = '''
"""A toy layout: segment 0 one dense layer, segment 1 the MoE layers;
q and k of width dk, v and o of width dv."""


def _attn(seg, n, r):
    d, h, kh, dk, dv = (r["d_model"], r["n_heads"], r["n_kv_heads"],
                        r["dk"], r["dv"])
    return [(seg + ("ln1", "scale"), (n, d), 0.1),
            (seg + ("wq", "w"), (n, d, h, dk), d ** -0.5),
            (seg + ("wk", "w"), (n, d, kh, dk), d ** -0.5),
            (seg + ("wv", "w"), (n, d, kh, dv), d ** -0.5),
            (seg + ("wo", "w"), (n, h * dv, d), (h * dv) ** -0.5)]


def leaf_specs(r):
    d, f, e, fe = r["d_model"], r["d_ff"], r["n_experts"], r["d_ff_expert"]
    n = r["n_layers"] - 1
    dense, moe = ("segments", "0", "b0"), ("segments", "1", "b0")
    return ([(("embed", "table"), (r["vocab_size"], d), 1.0)]
            + _attn(dense, 1, r)
            + [(dense + ("mlp", "wi", "w"), (1, d, f), d ** -0.5),
               (dense + ("mlp", "wo", "w"), (1, f, d), f ** -0.5)]
            + _attn(moe, n, r)
            + [(moe + ("router", "w"), (n, d, e), d ** -0.5),
               (moe + ("w_up",), (n, e, d, fe), d ** -0.5),
               (moe + ("w_down",), (n, e, fe, d), fe ** -0.5),
               (("head", "w"), (d, r["vocab_size"]), d ** -0.5)])


def _attn_products(r):
    d, h, kh, dk, dv = (r["d_model"], r["n_heads"], r["n_kv_heads"],
                        r["dk"], r["dv"])
    return [(d, h * dk), (d, kh * dk), (d, kh * dv), (h * dv, d)]


def step_products(r, batch, tokens, checked=True):
    m, d = batch * tokens, r["d_model"]
    dense = _attn_products(r) + [(d, r["d_ff"]), (r["d_ff"], d)]
    moe = _attn_products(r) + [(d, r["n_experts"])]
    out = [(m, k, n, checked) for k, n in dense]
    for _ in range(r["n_layers"] - 1):
        out += [(m, k, n, checked) for k, n in moe]
    return out + [(batch, d, r["vocab_size"], checked)]


def expert_products(r, batch, tokens):
    rows = batch * tokens * r["top_k"]
    live = min(r["n_experts"], rows)
    d, fe = r["d_model"], r["d_ff_expert"]
    return [(rows, d, fe, live), (rows, fe, d, live)] * (r["n_layers"] - 1)


def flash_launches(r, batch, prompt, checked=True):
    return [(batch, prompt, prompt, r["n_heads"], r["n_kv_heads"], r["dk"],
             r["dv"])] * r["n_layers"]


def weights_per_token(r):
    d, h, kh, dk, dv = (r["d_model"], r["n_heads"], r["n_kv_heads"],
                        r["dk"], r["dv"])
    attn = d * h * dk + d * kh * dk + d * kh * dv + h * dv * d
    moe = d * r["n_experts"] + r["top_k"] * 2 * d * r["d_ff_expert"]
    return r["n_layers"] * attn + 2 * d * r["d_ff"] + \\
        (r["n_layers"] - 1) * moe


def pair_flops(r):
    return [2 * r["n_heads"] * (r["dk"] + r["dv"])] * r["n_layers"]
'''

TOY_RUN = {"n_layers": 3, "d_model": 32, "n_heads": 4, "n_kv_heads": 2,
           "dk": 12, "dv": 8, "d_ff": 48, "n_experts": 8, "top_k": 2,
           "d_ff_expert": 16, "vocab_size": 100}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    (tmp_path / "toy_family.py").write_text(TOY)
    monkeypatch.syspath_prepend(str(tmp_path))
    return spec.layout_module({"layout": "toy_family.py"})


def test_a_layout_outside_bench_is_drawn(toy):
    r = TOY_RUN
    tree = weights.draw(r, 2 ** 31 + 9, "cpu", toy)
    assert isinstance(tree["segments"], list) and len(tree["segments"]) == 2
    dense, moe = (s["b0"] for s in tree["segments"])
    assert set(dense) == {"ln1", "wq", "wk", "wv", "wo", "mlp"}
    assert set(moe) == {"ln1", "wq", "wk", "wv", "wo", "router", "w_up",
                        "w_down"}
    assert dense["wk"]["w"].shape == (1, 32, 2, 12)
    assert dense["wv"]["w"].shape == (1, 32, 2, 8)
    assert moe["wo"]["w"].shape == (2, 32, 32)
    assert moe["w_up"].shape == (2, 8, 32, 16)
    assert tree["head"]["w"].shape == (32, 100)
    # every leaf drawn at its stated deviation, each its own draw
    drawn = []
    for path, shape, std in toy.leaf_specs(r):
        node = tree
        for key in path:
            node = node[int(key)] if isinstance(node, list) else node[key]
        assert tuple(node.shape) == shape and node.dtype == torch.float32
        drawn.append(node)
    assert len(drawn) == len(toy.leaf_specs(r))
    assert not torch.equal(dense["wq"]["w"][0, :, :, :8],
                           moe["wq"]["w"][0, :, :, :8])
    # the same seed gives the same tree
    assert tree_digest(tree) == tree_digest(
        weights.draw(r, 2 ** 31 + 9, "cpu", toy))


def test_a_layout_outside_bench_is_counted(toy):
    r, b, p = TOY_RUN, 2, 24
    # flash: q and k over dk = 12, v and o over dv = 8, every layer alike
    t, ops, nbytes = arith.flash_bound(b, p, p, 4, 2, 12, True, dv=8)
    pairs = b * 4 * p * (p + 1) // 2
    assert ops == pairs * (2 * 12 + 2 * 8 + 2)
    assert nbytes == 4 * (b * p * 4 * 12 + b * p * 4 * 8 + b * p * 2 * 12
                          + b * p * 2 * 8 + b * p * 4 + b * p * 4)
    assert arith.flash_least_s(r, b, p, True, toy) == 3 * t
    # matmul_abft: the dense layer's six products, two MoE layers' five,
    # the head; the MoE layers' grouped up and down
    prods = toy.step_products(r, b, p, False)
    assert len(prods) == 6 + 2 * 5 + 1
    assert prods[2] == (b * p, 32, 2 * 8, False)         # v over dv
    assert prods[3] == (b * p, 4 * 8, 32, False)         # o over dv
    want = sum(arith.matmul_bound(m, k, n, c)[0] for m, k, n, c in prods)
    want += sum(arith.grouped_bound(rows, k, n, g, False)[0]
                for rows, k, n, g in toy.expert_products(r, b, p))
    assert arith.matmul_least_s(r, b, p, 1, False, toy) == want
    # model FLOPs: 2 a weight a token, 2 · H · (dk + dv) a pair a layer
    per_tok = 2 * toy.weights_per_token(r)
    attn = 3 * 2 * 4 * (12 + 8)
    head = 2 * 32 * 100
    flops = b * (p * per_tok + attn * p * (p + 1) // 2 + head) + \
        b * (per_tok + attn * (p + 1) + head)
    assert arith.model_flops(r, b, p, 2, toy) == flops


def test_segments_must_be_numbered_from_zero(tmp_path, monkeypatch):
    (tmp_path / "toy_gap.py").write_text(textwrap.dedent('''
        def leaf_specs(r):
            return [(("segments", "1", "w"), (2, 2), 1.0)]
        '''))
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(ValueError, match="segments"):
        weights.draw({}, 1, "cpu",
                     spec.layout_module({"layout": "toy_gap.py"}))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_layouts_import_neither_the_program_nor_jax():
    files = sorted((ROOT / "bench" / "layouts").rglob("*.py"))
    assert len(files) >= 2
    for p in files:
        assert not set(_imports(p)) & {"repro_torch", "repro", "jax",
                                       "jaxlib", "flax"}, p
