"""The port's data pipeline (``repro_torch.data``) against the JAX
package's ``repro.data``: ``SyntheticLM`` batches bit for bit the
reference's for several seeds, host ids and shapes (tokens, labels, their
dtypes); ``ShardedLoader``'s local batch; ``Prefetcher`` on the CPU keeps
the stream's order and depth, ends with it, and asks for a card unless
told ``device="cpu"``.  Everything runs on the CPU."""
import itertools

import numpy as np
import pytest
import torch

from repro.data import ShardedLoader as JShardedLoader
from repro.data import SyntheticLM as JSyntheticLM
from repro_torch.data import Prefetcher, ShardedLoader, SyntheticLM


@pytest.mark.parametrize("vocab,seq,batch,seed,host", [
    (256, 16, 2, 0, 0), (256, 16, 2, 0, 1), (1000, 33, 3, 5, 0),
    (256000, 64, 2, 0, 0)])
def test_synthetic_batches_are_the_reference_bit_for_bit(vocab, seq, batch,
                                                         seed, host):
    ours = SyntheticLM(vocab, seq, batch, seed=seed).batches(host)
    theirs = JSyntheticLM(vocab, seq, batch, seed=seed).batches(host)
    for a, b in itertools.islice(zip(ours, theirs), 3):
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            assert a[k].shape == (batch, seq)
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][:, 1:],
                                      a["labels"][:, :-1])


def test_sharded_loader_is_the_reference():
    it = SyntheticLM(256, 8, 2).batches()
    ld, jld = ShardedLoader(it, 8, 4, 1), JShardedLoader(iter(()), 8, 4, 1)
    assert (ld.local, ld.host_id) == (jld.local, jld.host_id) == (2, 1)
    first = next(ld)
    np.testing.assert_array_equal(first["tokens"], next(
        SyntheticLM(256, 8, 2).batches())["tokens"])
    with pytest.raises(AssertionError):
        ShardedLoader(it, 7, 4, 0)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetcher_keeps_the_stream_order(depth):
    want = list(itertools.islice(SyntheticLM(256, 8, 2).batches(), 5))
    pf = Prefetcher(iter(want), device="cpu", depth=depth)
    assert len(pf.buf) == depth
    got = list(pf)
    assert len(got) == 5
    for g, w in zip(got, want):
        for k in w:
            assert g[k].device.type == "cpu" and g[k].dtype == torch.int32
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    with pytest.raises(StopIteration):
        next(pf)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_prefetcher_asks_for_a_card_by_default():
    with pytest.raises(RuntimeError, match="cuda"):
        Prefetcher(iter(()))
