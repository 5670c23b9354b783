"""Deterministic, resumable, sharded LM data pipeline, with SubStrat's
measure-preserving subset selection as a corpus operation, after the JAX
package's ``data/pipeline.py``.

* ``SyntheticCorpus``: deterministic Zipf-ish token corpus (seeded, lazy;
  host numpy, the reference's rows bit for bit).
* ``ShardedLoader``: host-sharded batches; ``state()``/``restore()`` make it
  resumable; shard assignment is recomputed per step from the alive-host
  set (``distributed/fault.assign_shards``).
* ``corpus_to_coded``: the (sequences x position-buckets) code matrix as the
  port's ``CodedDataset`` on a device.
* ``select_corpus_subset``: Gen-DST over that code matrix (B1 and B2 on a
  card) picks an entropy-preserving subset of sequences: SubStrat's step 1
  at LM scale (DESIGN.md §3).  It takes a generator (or a draw provider)
  where the reference takes a key.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import coded_from_numpy
from ..core.gen_dst import GenDSTConfig, gen_dst
from ..core.measures import CodedDataset
from ..device import DeviceLike, resolve_device
from ..distributed.fault import assign_shards

__all__ = ["SyntheticCorpus", "LoaderState", "ShardedLoader", "select_corpus_subset",
           "corpus_to_coded"]


class SyntheticCorpus:
    """Deterministic synthetic corpus: (n_seqs, seq_len) int32, lazy rows.

    Sequences are drawn from per-sequence topic distributions over a Zipfian
    vocabulary: different rows have different entropy profiles, which is
    what Gen-DST selects over."""

    def __init__(self, n_seqs: int, seq_len: int, vocab: int, seed: int = 0,
                 n_topics: int = 16):
        self.n_seqs, self.seq_len, self.vocab, self.seed = n_seqs, seq_len, vocab, seed
        self.n_topics = n_topics
        base = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        zipf = 1.0 / ranks ** 1.1
        self._topic_probs = np.stack([
            np.roll(zipf, int(base.integers(0, vocab))) for _ in range(n_topics)
        ])
        self._topic_probs /= self._topic_probs.sum(axis=1, keepdims=True)

    def rows(self, idx: np.ndarray) -> np.ndarray:
        out = np.empty((len(idx), self.seq_len), np.int32)
        for j, i in enumerate(np.asarray(idx)):
            rng = np.random.default_rng(self.seed * 1_000_003 + int(i))
            topic = int(rng.integers(0, self.n_topics))
            out[j] = rng.choice(
                self.vocab, size=self.seq_len, p=self._topic_probs[topic]
            ).astype(np.int32)
        return out

    def __len__(self):
        return self.n_seqs


@dataclasses.dataclass
class LoaderState:
    step: int


class ShardedLoader:
    """Deterministic global-batch loader sharded across hosts.

    Every host computes the same global permutation; each takes the slice
    assigned by ``assign_shards(step, alive_hosts)``: a dead or straggling
    host's slice migrates to survivors with no coordination.  Batches are
    host numpy; the caller moves them to its device."""

    def __init__(self, corpus: SyntheticCorpus, global_batch: int,
                 n_hosts: int = 1, host_id: int = 0, seed: int = 0,
                 subset: Optional[np.ndarray] = None):
        self.corpus = corpus
        self.global_batch = global_batch
        self.n_hosts, self.host_id, self.seed = n_hosts, host_id, seed
        self.pool = np.arange(len(corpus)) if subset is None else np.asarray(subset)
        self._step = 0

    def _global_indices(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + step)
        return rng.choice(self.pool, size=self.global_batch,
                          replace=len(self.pool) < self.global_batch)

    def next(self, alive_hosts: Optional[Sequence[int]] = None) -> Dict[str, np.ndarray]:
        alive = list(range(self.n_hosts)) if alive_hosts is None else list(alive_hosts)
        gidx = self._global_indices(self._step)
        shard_of = assign_shards(self.n_hosts, alive, self.n_hosts)
        mine = [s for s, h in shard_of.items() if h == self.host_id]
        per = self.global_batch // self.n_hosts
        rows = np.concatenate([gidx[s * per:(s + 1) * per] for s in mine]) if mine \
            else np.empty((0,), np.int64)
        toks = self.corpus.rows(rows)
        self._step += 1
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}

    def state(self) -> LoaderState:
        return LoaderState(self._step)

    def restore(self, st: LoaderState):
        self._step = st.step


def corpus_to_coded(
    corpus: SyntheticCorpus,
    *,
    n_position_buckets: int = 32,
    code_bins: int = 256,
    sample_rows: Optional[int] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[CodedDataset, np.ndarray]:
    """Build the (sequences x position-buckets) code matrix for Gen-DST, on
    ``device`` (default the card).

    Column j = the token at a representative position of bucket j, coded by
    ``id % code_bins``.  Returns (CodedDataset, row_ids): row_ids maps
    code-matrix rows back to corpus sequence ids when subsampling."""
    n = len(corpus)
    if sample_rows is not None and sample_rows < n:
        rng = np.random.default_rng(seed)
        row_ids = np.sort(rng.choice(n, sample_rows, replace=False))
    else:
        row_ids = np.arange(n)
    toks = corpus.rows(row_ids)                                 # (R, S)
    S = toks.shape[1]
    cols = np.linspace(0, S - 1, n_position_buckets).astype(int)
    codes = (toks[:, cols] % code_bins).astype(np.int32)
    coded = coded_from_numpy(codes, codes.astype(np.float32),
                             np.full((codes.shape[1],), code_bins, np.int32),
                             codes.shape[1] - 1, code_bins, device=device)
    return coded, row_ids


def select_corpus_subset(
    corpus: SyntheticCorpus,
    n_subset: int,
    *,
    generator: Optional[torch.Generator] = None,
    draws=None,
    cfg: GenDSTConfig = GenDSTConfig(),
    n_position_buckets: int = 32,
    sample_rows: Optional[int] = 8192,
    device: DeviceLike = None,
) -> np.ndarray:
    """Entropy-preserving subset of sequence ids (SubStrat step 1 at LM
    scale): Gen-DST on ``device`` (default the card) seeded by ``generator``
    (None: seed 0 on the device) or drawing from ``draws``."""
    dev = resolve_device(device)
    coded, row_ids = corpus_to_coded(corpus, n_position_buckets=n_position_buckets,
                                     sample_rows=sample_rows, device=dev)
    res = gen_dst(generator, coded, n=min(n_subset, len(row_ids)),
                  m=max(2, n_position_buckets // 4), cfg=cfg, device=dev, draws=draws)
    return row_ids[res.row_idx.cpu().numpy()]
