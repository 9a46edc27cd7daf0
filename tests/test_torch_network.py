"""The whole-network kernel of the port against the TPU original.

On the CPU the port's wrapper runs ``gcn_network_plain``; the JAX side runs
``gcn_network_kernel`` in interpret mode with its weights stacked through
``_network_weight_stacks`` (one shared padded width), the port with its own
per-layer widths.  The same numpy inputs go through both.  ``atol 1e-5`` on
the raw outputs (same f32 arithmetic, different summation order), ``1e-4``
on logits and ``predicted/actual`` through the wrappers and the engine; the
port's plain network equals the port's plain single-layer chain bit for bit.
The CUDA kernel is held against the same plain version on a GPU
(``chip_smoke.py``; the ``cuda``-marked test below)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.abft import ABFTConfig as JConfig
from repro.core.gcn import init_gcn as j_init_gcn
from repro.engine import fold_w_r as j_fold
from repro.engine import streaming as j_streaming
from repro.kernels.gcn_fused import kernel as jfk
from repro.kernels.gcn_fused import ops as jfo
from repro.kernels.spmm_abft.layout import dense_to_block_ell as j_to_bell
from repro_torch import convert
from repro_torch.analysis import vmem
from repro_torch.core.abft import ABFTConfig as TConfig
from repro_torch.engine import Graph, fold_w_r, gcn_forward, make_backend, \
    pack_graphs, synth_graph_stream
from repro_torch.engine import streaming as t_streaming
from repro_torch.kernels.gcn_fused import kernel as tfk
from repro_torch.kernels.gcn_fused import ops as tfo
from repro_torch.kernels.gcn_fused.ref import gcn_network_ref
from repro_torch.kernels.spmm_abft.layout import dense_to_block_ell

ATOL = 1e-5
DIMS = {"2-layer": (16, 16, 7), "3-layer": (12, 8, 8, 3)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, what="", atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol,
                               rtol=1e-5, err_msg=what)


def _packed(feat, block=8, seed=4, n_graphs=3):
    """<= 8 stripes of width <= 4 at block 8."""
    stream = synth_graph_stream(n_graphs, n_lo=10, n_hi=22, feat=feat,
                                seed=seed)
    return pack_graphs(stream, block=block, n_slots=4, stripe_multiple=4,
                       width_multiple=2)


def _weights(dims, seed=0):
    r = np.random.default_rng(seed)
    ws = [r.normal(0, 0.4, (f, g)).astype(np.float32)
          for f, g in zip(dims[:-1], dims[1:])]
    return ws, [w.sum(1).astype(np.float32) for w in ws]


def _raw_both(pb, dims, **kw):
    ws, wrs = _weights(dims)
    cols, vals, h0 = pb.bell.block_cols, pb.bell.values, pb.h0
    wstack, wrstack, p, _ = jfo._network_weight_stacks(
        [jnp.asarray(w) for w in ws], [jnp.asarray(w) for w in wrs], 128)
    hp = np.zeros((h0.shape[0], p), np.float32)
    hp[:, :dims[0]] = h0
    want = jfk.gcn_network_kernel(jnp.asarray(cols), jnp.asarray(vals),
                                  jnp.asarray(hp), wstack, wrstack,
                                  interpret=True, **kw)
    wps, wrps = tfo._network_weights([_t(w) for w in ws],
                                     [_t(w) for w in wrs], 128)
    got = tfk.gcn_network_kernel(_t(cols), _t(vals), _t(h0), wps, wrps,
                                 **kw)
    return got, want, (ws, wrs, wps, wrps)


KWS = [dict(), dict(inject=(0, 1, 1, 3.0)), dict(inject=(1, 2, 0, -2.0)),
       dict(with_check=False), dict(stash_acts=True),
       dict(stash_acts=True, inject=(1, 0, 1, 1.5))]


@pytest.mark.parametrize("kw", KWS, ids=["clean", "inject-l0", "inject-l1",
                                         "nocheck", "stash", "stash-inject"])
@pytest.mark.parametrize("dims", list(DIMS.values()), ids=list(DIMS))
def test_network_kernel_raw_outputs(dims, kw):
    pb = _packed(dims[0])
    before = tfk.gcn_network_plain.calls
    got, want, _ = _raw_both(pb, dims, **kw)
    assert tfk.gcn_network_plain.calls == before + 1   # CPU -> plain version
    out, ta, tp, acts = got
    jout, jta, jtp, jacts = want
    assert tuple(out.shape) == (pb.bell.padded_rows, vmem._lanes(dims[-1]))
    _close(out[:, :dims[-1]], np.asarray(jout)[:, :dims[-1]], "out")
    _close(ta, jta, "tele_acts")
    _close(tp, jtp, "tele_preds")
    if kw.get("with_check") is False:
        assert float(tp.abs().max()) == 0.0
    if kw.get("stash_acts"):
        assert len(acts) == len(dims) - 2
        for ell, a in enumerate(acts):
            assert tuple(a.shape) == (pb.bell.padded_rows, dims[ell + 1])
            _close(a, np.asarray(jacts)[ell][:, :dims[ell + 1]],
                   f"acts[{ell}]")
    else:
        assert acts is None


@pytest.mark.parametrize("kw", KWS[:4], ids=["clean", "inject-l0",
                                             "inject-l1", "nocheck"])
@pytest.mark.parametrize("dims", list(DIMS.values()), ids=list(DIMS))
def test_plain_network_equals_plain_layer_chain_bitwise(dims, kw):
    """Per layer the network runs the single-layer sweep: logits,
    telescopes and activations equal a chain of gcn_fused calls with ReLU
    between, bit for bit — the contract the CUDA kernels keep too."""
    pb = _packed(dims[0], seed=6)
    (out, ta, tp, acts), _, (_, _, wps, wrps) = _raw_both(
        pb, dims, stash_acts=True, **kw)
    cols, vals = _t(pb.bell.block_cols), _t(pb.bell.values)
    h = _t(pb.h0)
    inject = kw.get("inject")
    for ell, (w, wr) in enumerate(zip(wps, wrps)):
        hook = tuple(inject[1:]) if inject and inject[0] == ell else None
        o, _s, _e, sa, sp = tfk.gcn_fused_plain(
            cols, vals, h, w, wr, inject=hook,
            with_check=kw.get("with_check", True), with_slots=True)
        assert torch.equal(sa, ta[ell]) and torch.equal(sp, tp[ell])
        if ell < len(wps) - 1:
            h = torch.relu(o[:, :dims[ell + 1]]).contiguous()
            assert torch.equal(h, acts[ell])
    assert torch.equal(o, out)


def test_network_plain_matches_dense_oracle():
    dims = DIMS["3-layer"]
    s, h0 = synth_graph_stream(1, n_lo=30, n_hi=30, feat=dims[0], seed=2)[0]
    bell = dense_to_block_ell(s, 8, 8)
    ws, wrs = _weights(dims, seed=3)
    out, checks, h_layers = tfo.gcn_network_layer(
        bell, _t(h0), [_t(w) for w in ws], [_t(w) for w in wrs],
        stash_acts=True)
    ref, corners = gcn_network_ref(bell, h0, ws)
    _close(out, ref, "logits", atol=1e-4)
    for chk, (pred, actual) in zip(checks, corners):
        np.testing.assert_allclose(float(chk.predicted), pred, atol=1e-4)
        np.testing.assert_allclose(float(chk.actual), actual, atol=1e-4)
    assert len(h_layers) == 3 and h_layers[0].shape[0] == bell.padded_rows


def _check_close(tc, jc, what=""):
    if jc is None:
        assert tc is None
        return
    assert tc.granularity == jc.granularity, what
    assert tuple(tc.predicted.shape) == tuple(jc.predicted.shape), what
    _close(tc.predicted, jc.predicted, what + " predicted", atol=1e-4)
    _close(tc.actual, jc.actual, what + " actual", atol=1e-4)


@pytest.mark.parametrize("inject", [None, (1, 3, 0, 5.0)])
@pytest.mark.parametrize("granularity", ["graph", "stripe", "slot"])
@pytest.mark.parametrize("checked", [True, False])
def test_network_packed_wrapper(granularity, checked, inject):
    dims = DIMS["2-layer"]
    pb = _packed(dims[0], seed=9)
    ws, wrs = _weights(dims, seed=9)
    cfg = JConfig()
    cols, vals, seg, h0 = (pb.bell.block_cols, pb.bell.values,
                           pb.stripe_graph, pb.h0)
    jw = [jnp.asarray(w) for w in ws]
    jwr = [jnp.asarray(w) for w in wrs] if checked else [None] * len(ws)
    jout, jchecks, jh = jfo.gcn_network_packed(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(h0), jw, jwr,
        jnp.asarray(seg), num_segments=pb.n_slots, interpret=True,
        granularity=granularity, inject=inject, stash_acts=True)
    tout, tchecks, th = tfo.gcn_network_packed(
        _t(cols), _t(vals), _t(h0), [_t(w) for w in ws],
        [_t(w) for w in wrs] if checked else [None] * len(ws), _t(seg),
        num_segments=pb.n_slots, granularity=granularity, inject=inject,
        stash_acts=True)
    _close(tout, jout, "logits", atol=1e-4)
    assert len(tchecks) == len(jchecks) == 2
    for ell, (tc, jc) in enumerate(zip(tchecks, jchecks)):
        _check_close(tc, jc, f"{granularity} layer {ell}")
        if jc is not None:
            np.testing.assert_array_equal(
                _np(tc.flag(TConfig())), np.asarray(jc.flag(cfg)))
    for a, b in zip(th, jh):
        _close(a, b, "h_layers", atol=1e-4)


@pytest.mark.parametrize("granularity", ["layer", "stripe", "slot"])
def test_network_single_graph_wrapper(granularity):
    dims = DIMS["3-layer"]
    s, h0 = synth_graph_stream(1, n_lo=37, n_hi=37, feat=dims[0], seed=5)[0]
    ws, wrs = _weights(dims, seed=5)
    inject = (2, 1, 1, -4.0)
    jout, jchecks, jh = jfo.gcn_network_layer(
        j_to_bell(s, 8, 8), jnp.asarray(h0), [jnp.asarray(w) for w in ws],
        [jnp.asarray(w) for w in wrs], interpret=True,
        granularity=granularity, inject=inject, stash_acts=True)
    tout, tchecks, th = tfo.gcn_network_layer(
        dense_to_block_ell(s, 8, 8), _t(h0), [_t(w) for w in ws],
        [_t(w) for w in wrs], granularity=granularity, inject=inject,
        stash_acts=True)
    assert tuple(tout.shape) == (37, dims[-1])
    _close(tout, jout, "logits", atol=1e-4)
    for tc, jc in zip(tchecks, jchecks):
        _check_close(tc, jc, granularity)
    for a, b in zip(th, jh):
        _close(a, b, "h_layers", atol=1e-4)
    with pytest.raises(ValueError, match="square"):
        tfo.gcn_network_layer(dense_to_block_ell(s, 8, 16), _t(h0),
                              [_t(w) for w in ws], [None] * 3)
    with pytest.raises(ValueError, match="packed"):
        tfo.gcn_network_layer(dense_to_block_ell(s, 8, 8), _t(h0),
                              [_t(w) for w in ws], [None] * 3,
                              granularity="graph")


def test_network_wrapper_rejects_bad_operands():
    pb = _packed(16)
    cols, vals, h0 = _t(pb.bell.block_cols), _t(pb.bell.values), _t(pb.h0)
    w0, w1 = torch.zeros(16, 16), torch.zeros(16, 8)
    wr0, wr1 = torch.zeros(16, 1), torch.zeros(16, 1)
    with pytest.raises(ValueError, match="nbm \\* bm"):
        tfk.gcn_network_kernel(cols, vals, h0[:-1], [w0, w1], [wr0, wr1])
    with pytest.raises(ValueError, match="layer 0"):       # G not padded
        tfk.gcn_network_kernel(cols, vals, h0, [torch.zeros(16, 12), w1],
                               [wr0, torch.zeros(12, 1)])
    with pytest.raises(ValueError, match="one of each"):
        tfk.gcn_network_kernel(cols, vals, h0, [w0, w1], [wr0])
    with pytest.raises(ValueError, match="square"):
        tfk.gcn_network_kernel(cols, vals[..., :4], h0, [w0, w1],
                               [wr0, wr1])


def test_network_predicate_is_the_ports_own():
    """The network model is one object shared by the backend, the serving
    statistics and the wrapper; it takes Cora at block 128 (activations in
    device memory), and declines non-square blocks, a layer width outside
    the register tile, and more layers than the launcher takes."""
    from repro_torch.engine import backends, streaming
    assert tfo.fused_network_fits is vmem.fused_network_fits
    assert tfo.network_vmem_bytes is vmem.network_vmem_bytes
    assert tfk.fused_network_fits is vmem.fused_network_fits
    assert streaming.fused_network_fits is vmem.fused_network_fits
    del backends
    cora = [1433, 16, 7]
    assert vmem.fused_network_fits(cora, 128, 18432)
    assert vmem.network_vmem_bytes(cora, 128, 18432) == \
        vmem.fused_vmem_bytes(1433, 16, 128, 128) == 88_320
    # rows do not enter: the activations live in device memory
    assert vmem.network_vmem_bytes(cora, 128, 10 ** 9) == 88_320
    assert not vmem.fused_network_fits(cora, 128, 18432, bk=64)
    assert not vmem.fused_network_fits([16, 72, 7], 128, 1024)
    assert vmem.fused_network_fits([16] * 9, 8, 64)
    assert vmem.MAX_NETWORK_LAYERS == 8
    assert not vmem.fused_network_fits([16] * 10, 8, 64)
    assert not vmem.fused_network_fits(cora, 128, 18432, budget=86_000)
    assert vmem.network_vmem_bytes([16, 64, 7], 32, 256) > \
        vmem.network_vmem_bytes([16, 16, 7], 32, 256)


def test_schedule_byte_models():
    pb = _packed(16)
    bell = pb.bell
    nbm, width, bm, bk = bell.values.shape
    tiles = nbm * width
    rows = nbm * bm
    k_pad = max(bell.padded_cols, bk)
    fused = tfo.schedule_bytes_fused(bell, 16, 7)
    # H read once, the workspace X [k_pad, 8] + x_r written once, then per
    # stored tile the S tile and the X and x_r tiles it meets
    assert fused == 4 * (k_pad * 16 + 16 * 8 + 16 + k_pad * 8 + k_pad
                         + tiles * (bm * bk + bk * 8 + bk) + tiles
                         + rows * 8 + nbm + rows)
    net = tfo.schedule_bytes_network(bell, [16, 16, 7])
    per_layer = [rows * 16 + 16 * gp + 16 + rows * gp + rows
                 + tiles * (bm * bk + bk * gp + bk) + tiles + 2 * tiles
                 for gp in (16, 8)]
    assert net == 4 * (sum(per_layer) + rows * 16 + rows * 8)
    # the two-pass layer reads H twice (X and the eq.-5 column), the fused
    # one once
    two = tfo.schedule_bytes_twopass(bell, 16, 7)
    assert two > fused
    # F is not padded: a wider F grows the fused model by one column of H
    # and one row of W and of w_r
    assert tfo.schedule_bytes_fused(bell, 17, 7) - fused == \
        4 * (k_pad + 8 + 1)


def _engine_setup(dims=DIMS["3-layer"], seed=1):
    stream = synth_graph_stream(3, n_lo=12, n_hi=30, feat=dims[0], seed=seed)
    pb = pack_graphs(stream, block=8)
    jp = j_init_gcn(jax.random.PRNGKey(seed), dims)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return pb, jp, tp


@pytest.mark.parametrize("granularity", ["graph", "stripe", "slot"])
def test_packed_step_network_parity_and_counts(granularity):
    """The packed serving step with fused_network=True against the JAX
    package's: logits, verdicts, the stashed activations; one network hit
    per batch; and the port's network step equals its fused-layer step bit
    for bit."""
    pb, jp, tp = _engine_setup()
    jcfg, tcfg = JConfig(), TConfig()
    inject = (1, 2, 0, 7.0)
    jr = j_streaming.PackedRunner(j_fold(jp, jcfg), jcfg, 128,
                                  granularity=granularity,
                                  fused_network=True, inject=inject)
    tr = t_streaming.PackedRunner(fold_w_r(tp, tcfg), tcfg, 128,
                                  granularity=granularity,
                                  fused_network=True, inject=inject,
                                  device="cpu")
    jl, jm = jr.step_for(pb)(*j_streaming.packed_step_args(pb))
    tl, tm = tr.step_for(pb)(*tr.args_for(pb))
    _close(tl, jl, "logits", atol=1e-4)
    assert set(tm) == set(jm)
    for key in ("abft_graph_flags", "abft_stripe_flags", "abft_slot_flags"):
        if key in jm:
            np.testing.assert_array_equal(_np(tm[key]), np.asarray(jm[key]))
    assert _np(tm["abft_graph_flags"]).any()
    if granularity != "graph":
        for a, b in zip(tm["abft_h_layers"], jm["abft_h_layers"]):
            _close(a, b, "h_layers", atol=1e-4)
        assert all(x is None for x in tm["abft_x_layers"])
    assert tr.fusion_counts(pb) == jr.fusion_counts(pb) == {
        "fused_hits": 0, "fused_fallbacks": 0, "network_hits": 1,
        "network_fallbacks": 0}
    layer = t_streaming.PackedRunner(fold_w_r(tp, tcfg), tcfg, 128,
                                     fused_layer=True,
                                     granularity=granularity,
                                     inject=inject, device="cpu")
    ll, lm = layer.step_for(pb)(*layer.args_for(pb))
    assert torch.equal(ll, tl)
    for key in ("abft_graph_max_rel", "abft_stripe_max_rel",
                "abft_slot_max_rel"):
        if key in tm:
            assert torch.equal(lm[key], tm[key]), key


def test_backend_network_hook_counts_and_falls_back():
    pb, jp, tp = _engine_setup(seed=2)
    cfg = TConfig()
    params = fold_w_r(tp, cfg)
    bk = make_backend(pb, cfg, fused_network=True, device="cpu")
    logits, checks = gcn_forward(params, Graph(s=pb, h0=pb.h0), cfg,
                                 backend=bk)
    assert (bk.network_hits, bk.network_fallbacks) == (1, 0)
    assert len(checks) == 3 and all(c.granularity == "graph"
                                    for c in checks)
    # a budget below one block's working set: the per-layer ladder runs
    tight = make_backend(pb, cfg, fused_network=True, fused_layer=True,
                         vmem_budget=64, device="cpu")
    again, _ = gcn_forward(params, Graph(s=pb, h0=pb.h0), cfg, backend=tight)
    assert (tight.network_hits, tight.network_fallbacks) == (0, 1)
    assert (tight.fused_hits, tight.fused_fallbacks) == (0, 3)
    _close(again, _np(logits), "fallback logits", atol=1e-5)
    # the split baseline needs X, which the network never materializes
    split = make_backend(pb, TConfig(mode="split"), fused_network=True,
                         device="cpu")
    gcn_forward(params, Graph(s=pb, h0=pb.h0), TConfig(mode="split"),
                backend=split)
    assert (split.network_hits, split.network_fallbacks) == (0, 0)
    runner = t_streaming.PackedRunner(params, cfg, 128, fused_layer=True,
                                      fused_network=True, vmem_budget=64,
                                      device="cpu")
    assert runner.fusion_counts(pb) == {
        "fused_hits": 0, "fused_fallbacks": 3, "network_hits": 0,
        "network_fallbacks": 1}
    with pytest.warns(UserWarning, match="fused-network"):
        runner.step_for(pb)


# ---------------------------------------------------------------------------
# on a GPU: the CUDA kernel against its plain version and the B2 chain
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_network_kernel_matches_plain_and_b2_chain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no "
                    "interpret mode)")
    dims = (21, 16, 7)
    pb = _packed(dims[0], block=32)
    dev = torch.device("cuda")
    cols, vals = _t(pb.bell.block_cols).to(dev), _t(pb.bell.values).to(dev)
    h0 = _t(pb.h0).to(dev)
    ws, wrs = _weights(dims, seed=2)
    wps, wrps = tfo._network_weights([_t(w).to(dev) for w in ws],
                                     [_t(w).to(dev) for w in wrs], 128)
    n0 = tfk.gcn_network_kernel.launches
    for inject in (None, (1, 1, 0, 2.0)):
        got = tfk.gcn_network_kernel(cols, vals, h0, wps, wrps,
                                     inject=inject, stash_acts=True)
        want = tfk.gcn_network_plain(cols, vals, h0, wps, wrps,
                                     inject=inject, stash_acts=True)
        for a, b in zip(got[:3], want[:3]):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        h = h0
        for ell, (w, wr) in enumerate(zip(wps, wrps)):
            hook = tuple(inject[1:]) if inject and inject[0] == ell else None
            o, _s, _e, sa, sp = tfk.gcn_fused_kernel(
                cols, vals, h, w, wr, inject=hook, with_slots=True)
            assert torch.equal(sa, got[1][ell]) and \
                torch.equal(sp, got[2][ell])
            if ell < len(wps) - 1:
                h = torch.relu(o[:, :dims[ell + 1]]).contiguous()
                assert torch.equal(h, got[3][ell])
        assert torch.equal(o, got[0])
    assert tfk.gcn_network_kernel.launches == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(5, 16, 7), (33, 24, 8), (1433, 16, 7),
                                  (21, 8, 24, 16)])
def test_cuda_network_two_phases_match_plain_chain_and_rerun(dims):
    """B3's two phases a layer at ragged F and hidden widths 8 / 16 / 24,
    blocks 16, 32 and 128, checked and unchecked, with the inject hook at
    the first and the last layer: within 1e-4 of the plain version, bit for
    bit the chain of B2 launches (logits, telescopes, stash), and a second
    run bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no "
                    "interpret mode)")
    dev = torch.device("cuda")
    last = len(dims) - 2
    for block in (16, 32, 128):
        pb = _packed(dims[0], block=block)
        cols = _t(pb.bell.block_cols).to(dev)
        vals = _t(pb.bell.values).to(dev)
        h0 = _t(pb.h0).to(dev)
        nbm, width = cols.shape
        ws, wrs = _weights(dims, seed=block)
        wps, wrps = tfo._network_weights([_t(w).to(dev) for w in ws],
                                         [_t(w).to(dev) for w in wrs], 128)
        for kw in (dict(stash_acts=True), dict(with_check=False),
                   dict(inject=(0, nbm // 2, width // 2, 3.0),
                        stash_acts=True),
                   dict(inject=(last, nbm - 1, 0, -2.0))):
            got = tfk.gcn_network_kernel(cols, vals, h0, wps, wrps, **kw)
            again = tfk.gcn_network_kernel(cols, vals, h0, wps, wrps, **kw)
            want = tfk.gcn_network_plain(cols, vals, h0, wps, wrps, **kw)
            for a, a2, b in zip(got[:3], again[:3], want[:3]):
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
                assert torch.equal(a, a2)
            inject = kw.get("inject")
            h = h0
            for ell, (w, wr) in enumerate(zip(wps, wrps)):
                hook = tuple(inject[1:]) if inject and inject[0] == ell \
                    else None
                o, _s, _e, sa, sp = tfk.gcn_fused_kernel(
                    cols, vals, h, w, wr, inject=hook, with_slots=True,
                    with_check=kw.get("with_check", True))
                assert torch.equal(sa, got[1][ell])
                assert torch.equal(sp, got[2][ell])
                if ell < len(wps) - 1:
                    h = torch.relu(o[:, :dims[ell + 1]]).contiguous()
                    if got[3] is not None:
                        assert torch.equal(h, got[3][ell])
                        torch.testing.assert_close(h, want[3][ell],
                                                   atol=1e-4, rtol=1e-4)
            assert torch.equal(o, got[0])
