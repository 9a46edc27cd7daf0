"""The yardstick's arithmetic against hand counts at one chatglm3-6b shape
and one deepseek-moe-16b expert shape."""
import json

import pytest

from bench.lib import arith
from bench.tests.smoke import ROOT

RUN = {n: json.load(open(ROOT / "bench" / "configs" / f"{n}.json"))["run"]
       for n in ("chatglm3-6b", "deepseek-moe-16b")}


def test_matmul_bound_chatglm_mlp_up():
    # a chatglm3-6b prefill of 16 x 1024 tokens: x [16384, 4096] @ wi
    m, k, n = 16384, 4096, 13696
    t, ops, nbytes = arith.matmul_bound(m, k, n)
    assert ops == 2 * 16384 * 13696 * 4096 + 2 * 16384 * 4096
    assert nbytes == 4 * (16384 * 4096 + 4096 * 13696 + 16384 * 13696
                          + 4096 + 16384)
    assert t == pytest.approx(ops / 67e12)          # bound by operations
    assert arith.matmul_bound(m, k, n, checked=False)[1] == 2 * m * n * k


def test_grouped_bound_deepseek_expert_up():
    # one layer's up launch of a 2048-token deepseek-moe-16b prefill:
    # 12288 routed rows over 64 live experts, [rows_e, 2048] @ [2048, 1408]
    t, ops, nbytes = arith.grouped_bound(12288, 2048, 1408, 64)
    assert ops == 2 * 12288 * 1408 * 2048 + 2 * 12288 * 2048
    assert nbytes == 4 * (12288 * 2048 + 64 * 2048 * 1408 + 12288 * 1408
                          + 64 * 2048 + 12288)
    assert t == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))
    _, ops, nbytes = arith.grouped_bound(12288, 2048, 1408, 64, False)
    assert ops == 2 * 12288 * 1408 * 2048
    assert nbytes == 4 * (12288 * 2048 + 64 * 2048 * 1408 + 12288 * 1408)
    ex = arith.expert_products(RUN["deepseek-moe-16b"], 1, 2048)
    assert ex[0] == (12288, 2048, 1408, 64) and len(ex) == 3 * 28


def test_flash_bound_causal_pairs():
    # chatglm3-6b, B 1, T = S 4, H 32, Kh 2, dh 128: 1 + 2 + 3 + 4 pairs
    t, ops, nbytes = arith.flash_bound(1, 4, 4, 32, 2, 128)
    assert ops == 32 * 10 * (4 * 128 + 2)
    assert nbytes == 4 * (2 * 4 * 32 * 128 + 2 * 4 * 2 * 128 + 4 * 32) \
        + 4 * 4 * 32
    # without the checks: no vr, no o_extra, no p·vr
    t, ops, nbytes = arith.flash_bound(1, 4, 4, 32, 2, 128, checked=False)
    assert ops == 32 * 10 * 4 * 128
    assert nbytes == 4 * (2 * 4 * 32 * 128 + 2 * 4 * 2 * 128)


def test_flash_bound_keys_wider_than_values():
    # DeepSeek-V2-Lite's latent attention: q·k over 192, p·v over 128
    b, t, s, h = 1, 6, 6, 16
    pairs = h * 21
    _, ops, nbytes = arith.flash_bound(b, t, s, h, h, 192, dv=128)
    assert ops == pairs * (2 * 192 + 2 * 128 + 2)
    assert nbytes == 4 * (t * h * 192 + t * h * 128 + s * h * 192
                          + s * h * 128 + s * h + t * h)
    _, ops, nbytes = arith.flash_bound(b, t, s, h, h, 192, False, dv=128)
    assert (ops, nbytes) == (pairs * (2 * 192 + 2 * 128),
                             4 * (t * h + s * h) * (192 + 128))
    # at dk = dv the formula of one width dh: 4·dh a pair, 2·dh a row
    for checked in (True, False):
        for dh in (64, 128, 256):
            old_ops = 32 * 10 * (4 * dh + (2 if checked else 0))
            old_bytes = 4 * (2 * 4 * 32 * dh + 2 * 4 * 2 * dh) + \
                (4 * (4 * 32 + 4 * 32) if checked else 0)
            t_old = max(old_ops / 67e12, old_bytes / 3.35e12)
            assert arith.flash_bound(1, 4, 4, 32, 2, dh, checked, dv=dh) == \
                arith.flash_bound(1, 4, 4, 32, 2, dh, checked) == \
                (t_old, old_ops, old_bytes)


def test_step_products_chatglm():
    prods = arith.step_products(RUN["chatglm3-6b"], 16, 1024)
    layer = [(16384, 4096, 4096, True), (16384, 4096, 256, True),
             (16384, 4096, 256, True), (16384, 4096, 4096, False),
             (16384, 4096, 13696, True), (16384, 4096, 13696, True),
             (16384, 13696, 4096, True)]
    assert prods == layer * 28 + [(16, 4096, 65024, True)]
    off = arith.step_products(RUN["chatglm3-6b"], 16, 1024, checked=False)
    assert off == [(m, k, n, False) for m, k, n, _ in prods]
    run = RUN["chatglm3-6b"]
    assert arith.matmul_least_s(run, 1, 4096, 1, checked=False) < \
        arith.matmul_least_s(run, 1, 4096, 1)


def test_model_flops_by_hand():
    run = RUN["chatglm3-6b"]
    d, f, v = 4096, 13696, 65024
    per_layer = d * 4096 + 2 * d * 256 + 4096 * d + 3 * d * f
    assert arith.weights_per_token(run) == 28 * per_layer
    # B 1, one prompt token, no decode: 2 per weight, one context pair a
    # layer, the head once
    assert arith.model_flops(run, 1, 1, 1) == \
        2 * 28 * per_layer + 4 * 32 * 128 * 28 + 2 * d * v
    moe = RUN["deepseek-moe-16b"]
    attn = 4 * 2048 * 2048
    mlp = 2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816
    assert arith.weights_per_token(moe) == 28 * (attn + mlp)
