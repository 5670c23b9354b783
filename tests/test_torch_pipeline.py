"""The port's LM data pipeline (``data/pipeline.py``) against the JAX
package's on the CPU.

Tolerances: none.  Corpus rows, loader batches (from a fresh loader, after
``restore``, on the shards of four hosts, with a dead host's shards
migrated), the code matrix and its row ids are bit-equal to the
reference's; ``select_corpus_subset`` on the reference's own draws
(``JaxDraws`` replaying its key) returns the reference's sequence ids.
"""
import jax
import numpy as np
import pytest

from repro.core.gen_dst import GenDSTConfig as JGenDSTConfig
from repro.data import pipeline as jpipe
from repro_torch.core.gen_dst import GenDSTConfig
from repro_torch.data import pipeline as tpipe
from _torch_port import JaxDraws, np_


@pytest.fixture(scope="module")
def corpora():
    return (jpipe.SyntheticCorpus(n_seqs=512, seq_len=64, vocab=1000, seed=3),
            tpipe.SyntheticCorpus(n_seqs=512, seq_len=64, vocab=1000, seed=3))


def _equal_batches(a, b):
    assert sorted(a) == sorted(b) == ["labels", "tokens"]
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_corpus_rows_equal_the_reference(corpora):
    jc, tc = corpora
    idx = np.array([0, 3, 7, 511, 3])
    np.testing.assert_array_equal(tc.rows(idx), jc.rows(idx))
    assert tc.rows(idx).dtype == np.int32 and len(tc) == 512


def test_loader_batches_and_resume_equal_the_reference(corpora):
    jc, tc = corpora
    jl = jpipe.ShardedLoader(jc, global_batch=16, seed=1)
    tl = tpipe.ShardedLoader(tc, global_batch=16, seed=1)
    for _ in range(3):
        _equal_batches(tl.next(), jl.next())
    st = tl.state()
    assert st == tpipe.LoaderState(3) and jl.state().step == 3
    ahead = tl.next()
    tl.restore(st)
    _equal_batches(tl.next(), ahead)
    _equal_batches(ahead, jl.next())
    # a subset pool smaller than the batch draws with replacement
    sub = np.array([5, 9, 11])
    _equal_batches(tpipe.ShardedLoader(tc, 8, seed=2, subset=sub).next(),
                   jpipe.ShardedLoader(jc, 8, seed=2, subset=sub).next())


@pytest.mark.parametrize("alive", [None, [0, 2, 3], [1]])
def test_host_shards_equal_the_reference(corpora, alive):
    """Four hosts' slices, with dead hosts' shards migrated to survivors."""
    jc, tc = corpora
    hosts = range(4) if alive is None else alive
    total = 0
    for h in hosts:
        tb = tpipe.ShardedLoader(tc, 16, n_hosts=4, host_id=h, seed=3).next(alive)
        jb = jpipe.ShardedLoader(jc, 16, n_hosts=4, host_id=h, seed=3).next(alive)
        _equal_batches(tb, jb)
        total += tb["tokens"].shape[0]
    assert total == 16


def test_corpus_to_coded_equals_the_reference(corpora):
    jc, tc = corpora
    for sample_rows in (128, None):
        jcoded, jids = jpipe.corpus_to_coded(jc, n_position_buckets=16, sample_rows=sample_rows)
        tcoded, tids = tpipe.corpus_to_coded(tc, n_position_buckets=16, sample_rows=sample_rows,
                                             device="cpu")
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(np_(tcoded.codes), np.asarray(jcoded.codes))
        np.testing.assert_array_equal(np_(tcoded.values), np.asarray(jcoded.values))
        np.testing.assert_array_equal(np_(tcoded.n_bins), np.asarray(jcoded.n_bins))
        assert (tcoded.target_col, tcoded.max_bins) == (jcoded.target_col, jcoded.max_bins)
        assert tcoded.codes.device.type == "cpu"


@pytest.mark.parametrize("seed", [0, 5])
def test_select_corpus_subset_equals_the_reference(corpora, seed):
    jc, tc = corpora
    key = jax.random.key(seed)
    want = jpipe.select_corpus_subset(jc, 32, key=key, cfg=JGenDSTConfig(psi=3, phi=8),
                                      n_position_buckets=16, sample_rows=128)
    got = tpipe.select_corpus_subset(tc, 32, draws=JaxDraws(key), cfg=GenDSTConfig(psi=3, phi=8),
                                     n_position_buckets=16, sample_rows=128, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert len(got) == 32 and ((got >= 0) & (got < len(tc))).all()
    b = tpipe.ShardedLoader(tc, global_batch=8, seed=0, subset=got).next()
    assert b["tokens"].shape == (8, 63)
