"""The paper's baseline DST generators (SubStrat §4.2, Table 3), in PyTorch.

The port of the JAX package's ``core/baselines.py``; read its docstring for
the categories (Monte-Carlo, bandit, greedy, k-means, information gain).
Each baseline takes ``(generator, coded, n, m, *, <the reference's options>,
device=None, draws=None)`` and returns a ``DSTResult`` on the device, as
``gen_dst`` does.  What differs here:

* **Draws apart from the search**, as in Gen-DST.  A baseline draws through a
  provider: ``gen_dst.TorchDraws`` on ``generator`` in production; the tests
  replay the reference's key splits through theirs.  The provider stands for
  the reference's key: ``split`` gives the sub-keys' providers, and where the
  reference draws twice from one key (``mab``'s pick draws its noise and its
  exploration scores from one key, ``_km_rows`` hands one key to two
  ``choice`` calls), the port draws once and uses the draw twice, or asks
  the same provider twice.
* **mc through the kernels.**  Each batch of candidates is scored as Gen-DST
  scores its initial population: B1 gathers and counts the rows, B2 reduces
  them with a zero delta.  The other baselines run plain torch on the
  device, as the reference runs jitted ``jnp``.
* **Picks from exact sums.**  The greedy searches compare losses built from
  per-column entropies rounded to float32 (each summed in float64, as
  everywhere in the port) and added in float64, which is exact for them.
  So candidates whose columns have the same entropies score the same on any
  device and in any column order, and the first of them wins, as
  ``argmin`` picks it.  The reference's float32 sums may order such
  candidates by rounding; the tests hold picks equal where the reference's
  winner leads by more than 1e-5.  Fitnesses (the reported
  ``-|F(d) - F(D)|``, the bandit's reward) take F(d) as ``measures`` does:
  float64 sums, rounded to float32 once.
* **No host wait.**  Best-so-far, arm values and column masks are updated
  with ``torch.where`` and ``index_add``; nothing is read back until the
  caller converts the result.  The reference's initial best (a population
  drawn from the run's key, ``baselines.py:82-83, 150-154``) is always
  replaced at the first step, whose fitness beats ``-inf``, so the port
  starts from zeros and makes no such draw.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..device import DeviceLike
from .gen_dst import (
    DSTResult,
    _default_draws,
    _entropy_fitness,
    _init_population,
    _on_device,
    _resolve_nm,
    _target_mask,
)
from .measures import (
    CodedDataset, _masked_mean_entropy, column_entropy_from_counts, full_column_entropy,
    subset_counts,
)

__all__ = [
    "mc_dst",
    "mab_dst",
    "greedy_seq_dst",
    "greedy_mult_dst",
    "km_dst",
    "ig_rand_dst",
    "ig_km_dst",
    "information_gain",
    "kmeans",
]

_INF = float("inf")


def _setup(generator, coded: CodedDataset, n, m, device: DeviceLike, draws):
    coded, dev = _on_device(coded, device)
    n, m = _resolve_nm(coded, n, m)
    return coded, dev, n, m, (_default_draws(generator, dev) if draws is None else draws)


def _take_first(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without reading it back to the host."""
    return torch.index_select(x, 0, i.reshape(1))[0]


def _f_ref(coded: CodedDataset) -> torch.Tensor:
    """F(D), as Gen-DST takes it: the float32 mean of the column entropies."""
    return full_column_entropy(coded.codes, coded.max_bins).mean()


def _counts_fitness(counts: torch.Tensor, col_mask: torch.Tensor, f_ref) -> torch.Tensor:
    """-|F(d) - F(D)| of (M, B) counts under ``col_mask``, F(d) the port's
    dataset entropy (float64 sums, rounded to float32 once)."""
    return -(_masked_mean_entropy(counts, col_mask) - f_ref).abs()


def _subset_fitness(coded: CodedDataset, rows: torch.Tensor, col_mask: torch.Tensor):
    """``(fitness, F(D))`` of the DST ``(rows, col_mask)`` of ``coded``."""
    f_ref = _f_ref(coded)
    counts = subset_counts(coded.codes, rows, coded.max_bins)
    return _counts_fitness(counts, col_mask, f_ref), f_ref


def _mean_h(h: torch.Tensor, col_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of float32 column entropies (..., M) over every column, or over
    ``col_mask`` (M,), added in float64: exact, so independent of order."""
    h = h.to(torch.float64)
    if col_mask is None:
        return h.sum(-1) / h.shape[-1]
    cm = col_mask.to(torch.float64)
    return (h * cm).sum(-1) / cm.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# A. Monte-Carlo search
# ---------------------------------------------------------------------------


def _mc_batch(d, coded: CodedDataset, f_ref, n: int, m: int, batch: int):
    """One batch of random candidates, ``(rows (batch, n), masks (batch, M),
    fitness (batch,))``, scored by B1 and B2."""
    N, M = coded.codes.shape
    rows, cols = _init_population(d.init(1, batch, N, M, n), N, M, n, m, coded.target_col)
    fit = _entropy_fitness(coded.codes, coded.max_bins, f_ref, rows, cols)
    return rows[0], cols[0], fit[0]


def mc_dst(generator: Optional[torch.Generator], coded: CodedDataset, n=None, m=None, *,
           budget: int = 100, batch: int = 50, device: DeviceLike = None,
           draws=None) -> DSTResult:
    """Monte-Carlo search over random DSTs with a candidate budget: the
    best of ``budget // batch`` batches of ``batch`` random candidates.
    ``history`` holds each batch's best fitness."""
    coded, dev, n, m, draws = _setup(generator, coded, n, m, device, draws)
    batch = min(batch, budget)
    f_ref = _f_ref(coded)
    best_f = torch.full((), -_INF, device=dev)
    best_r = torch.zeros(n, dtype=torch.int32, device=dev)
    best_c = _target_mask(coded.num_cols, coded.target_col, dev)
    hist = []
    for d in draws.split(max(1, budget // batch)):
        rows, cols, fit = _mc_batch(d, coded, f_ref, n, m, batch)
        i = torch.argmax(fit)
        f_i = _take_first(fit, i)
        better = f_i > best_f                      # strictly larger replaces
        best_f = torch.where(better, f_i, best_f)
        best_r = torch.where(better, _take_first(rows, i), best_r)
        best_c = torch.where(better, _take_first(cols, i), best_c)
        hist.append(f_i)
    return DSTResult(best_r, best_c, best_f, torch.stack(hist), f_ref)


# ---------------------------------------------------------------------------
# B. Multi-Arm Bandit (eps-greedy over row-arms and column-arms)
# ---------------------------------------------------------------------------


def _pick(d, values: torch.Tensor, k: int, eps: float,
          forbid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """eps-greedy: the k best of ``values`` plus 1e-3 x noise, or with
    probability eps the k best of the noise alone (int64 indices).  The
    reference draws the noise and the exploration scores from one key, so
    they are one draw here."""
    kn, ke = d.split()
    u = kn.uniform(*values.shape)
    explore = ke.uniform() < eps
    scores = torch.where(explore, u, values + u * 1e-3)
    if forbid is not None:
        scores = scores - torch.where(forbid, _INF, 0.0)
    return torch.argsort(-scores, stable=True)[:k]


def _mab_round(d, state, coded: CodedDataset, f_ref, tgt, n: int, m: int, eps: float):
    """One bandit round from ``state`` = (row values, column values, row
    pulls, column pulls): pick rows and columns, score the DST, update the
    chosen arms' incremental means.  Returns (state, reward, rows, mask)."""
    rv, cv, rn, cn = state
    kr, kc = d.split()
    r = _pick(kr, rv, n, eps)
    c_sel = _pick(kc, cv, m - 1, eps, forbid=tgt)
    cm = tgt.index_fill(0, c_sel, True)
    reward = _counts_fitness(subset_counts(coded.codes, r, coded.max_bins), cm, f_ref)
    rn = rn.index_add(0, r, torch.ones_like(r, dtype=torch.float32))
    cn = cn.index_add(0, c_sel, torch.ones_like(c_sel, dtype=torch.float32))
    rv = rv.index_add(0, r, (reward - rv[r]) / rn[r])
    cv = cv.index_add(0, c_sel, (reward - cv[c_sel]) / cn[c_sel])
    return (rv, cv, rn, cn), reward, r.to(torch.int32), cm


def mab_dst(generator: Optional[torch.Generator], coded: CodedDataset, n=None, m=None, *,
            rounds: int = 200, eps: float = 0.15, device: DeviceLike = None,
            draws=None) -> DSTResult:
    """eps-greedy multi-arm bandit over row arms and column arms; the reward
    of a round is its DST's fitness.  ``history`` holds each round's reward."""
    coded, dev, n, m, draws = _setup(generator, coded, n, m, device, draws)
    N, M = coded.codes.shape
    f_ref = _f_ref(coded)
    tgt = _target_mask(M, coded.target_col, dev)
    state = (torch.zeros(N, device=dev), torch.zeros(M, device=dev),
             torch.zeros(N, device=dev), torch.zeros(M, device=dev))
    best_f = torch.full((), -_INF, device=dev)
    best_r = torch.zeros(n, dtype=torch.int32, device=dev)
    best_c = tgt
    hist = []
    for d in draws.split(rounds):
        state, reward, r, cm = _mab_round(d, state, coded, f_ref, tgt, n, m, eps)
        better = reward > best_f
        best_f = torch.where(better, reward, best_f)
        best_r = torch.where(better, r, best_r)
        best_c = torch.where(better, cm, best_c)
        hist.append(reward)
    return DSTResult(best_r, best_c, best_f, torch.stack(hist), f_ref)


# ---------------------------------------------------------------------------
# C. Greedy selection
# ---------------------------------------------------------------------------


def _greedy_col_pick(h: torch.Tensor, cm: torch.Tensor, f_ref) -> torch.Tensor:
    """The column outside ``cm`` whose inclusion brings the mean of the
    float32 entropies ``h`` (M,) over the mask closest to F(D)."""
    cmf = cm.to(torch.float64)
    cnt = cmf.sum()
    h64 = h.to(torch.float64)
    cur = (h64 * cmf).sum() / cnt.clamp_min(1.0)
    cand = (cur * cnt + h64) / (cnt + 1)
    loss = (cand - f_ref.to(torch.float64)).abs() + torch.where(cm, _INF, 0.0)
    return torch.argmin(loss)


def _greedy_cols(h: torch.Tensor, f_ref, m: int, target: int) -> torch.Tensor:
    """Greedy column selection given per-column entropies h (M,): m - 1
    times, add the column whose inclusion brings the mean closest to F(D)."""
    M = h.shape[0]
    cols = torch.arange(M, device=h.device)
    cm = cols == target
    for _ in range(m - 1):
        cm = cm | (cols == _greedy_col_pick(h, cm, f_ref))
    return cm


def _greedy_row_step(codes: torch.Tensor, B: int, counts: torch.Tensor, cand: torch.Tensor,
                     f_ref, cm: Optional[torch.Tensor] = None):
    """Each candidate row added to ``counts`` (M, B): the counts (pool, M, B),
    the float32 column entropies (pool, M), the float64 losses
    ``|mean - F(D)|`` over every column or over ``cm``, and the first
    best candidate's index."""
    new_counts = counts + F.one_hot(codes[cand.long()].long(), B).to(torch.float32)
    h = column_entropy_from_counts(new_counts)
    loss = (_mean_h(h, cm) - f_ref.to(torch.float64)).abs()
    return new_counts, h, loss, torch.argmin(loss)


def greedy_seq_dst(generator: Optional[torch.Generator], coded: CodedDataset, n=None, m=None,
                   *, pool: int = 64, device: DeviceLike = None, draws=None) -> DSTResult:
    """Greedy rows (each step the best of ``pool`` random rows, all columns
    active), then greedy columns for the chosen rows."""
    coded, dev, n, m, draws = _setup(generator, coded, n, m, device, draws)
    codes, B = coded.codes, coded.max_bins
    N, M = codes.shape
    f_ref = _f_ref(coded)
    counts = torch.zeros((M, B), device=dev)
    rows, hist = [], []
    for d in draws.split(n):
        cand = d.randint(N, pool)
        new_counts, _, loss, i = _greedy_row_step(codes, B, counts, cand, f_ref)
        counts = _take_first(new_counts, i)
        rows.append(_take_first(cand, i))
        hist.append(_take_first(loss, i).to(torch.float32))
    cm = _greedy_cols(column_entropy_from_counts(counts), f_ref, m, coded.target_col)
    return DSTResult(torch.stack(rows), cm, _counts_fitness(counts, cm, f_ref),
                     torch.stack(hist), f_ref)


def greedy_mult_dst(generator: Optional[torch.Generator], coded: CodedDataset, n=None, m=None,
                    *, pool: int = 64, device: DeviceLike = None, draws=None) -> DSTResult:
    """Greedy row+column co-selection: each step adds the best of ``pool``
    random rows, measured on the growing subset's columns, then the best
    column while fewer than m are selected."""
    coded, dev, n, m, draws = _setup(generator, coded, n, m, device, draws)
    codes, B = coded.codes, coded.max_bins
    N, M = codes.shape
    f_ref = _f_ref(coded)
    cols = torch.arange(M, device=dev)
    cm = cols == coded.target_col
    counts = torch.zeros((M, B), device=dev)
    rows, hist = [], []
    for d in draws.split(n):
        cand = d.randint(N, pool)
        new_counts, h, loss, i = _greedy_row_step(codes, B, counts, cand, f_ref, cm)
        counts = _take_first(new_counts, i)
        rows.append(_take_first(cand, i))
        hist.append(_take_first(loss, i).to(torch.float32))
        j = _greedy_col_pick(_take_first(h, i), cm, f_ref)
        # a device-side condition: no read of the count back to the host
        cm = torch.where(cm.sum() < m, cm | (cols == j), cm)
    return DSTResult(torch.stack(rows), cm, _counts_fitness(counts, cm, f_ref),
                     torch.stack(hist), f_ref)


# ---------------------------------------------------------------------------
# D. K-Means clustering
# ---------------------------------------------------------------------------


def kmeans(generator: Optional[torch.Generator], points: torch.Tensor, k: int,
           iters: int = 10, *, draws=None):
    """Lloyd's k-means from k distinct points drawn as the initial
    centroids; returns (centroids (k, d), nearest-point index (k,) int32).

    The points are standardised with the population std; squared distances
    are summed over the differences, as the reference does (a matmul
    expansion such as ``torch.cdist``'s rounds otherwise and moves argmins).
    At D1 the (points, k, d) differences are 16,384 x 322 x 23 float32,
    485 MB per iteration."""
    if draws is None:
        draws = _default_draws(generator, points.device)
    P = points.shape[0]
    mu = points.std(0, correction=0) + 1e-9
    z = (points - points.mean(0)) / mu
    cent = z[draws.choice(P, k)]
    for _ in range(iters):
        d2 = ((z[:, None, :] - cent[None, :, :]) ** 2).sum(-1)      # (P, k)
        onehot = F.one_hot(d2.argmin(1), k).to(torch.float32)       # (P, k)
        sums = onehot.T @ z                                          # (k, d)
        cnts = onehot.sum(0)[:, None]
        cent = torch.where(cnts > 0, sums / cnts.clamp_min(1.0), cent)
    d2 = ((z[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
    return cent, d2.argmin(0).to(torch.int32)


def _km_rows(d, values: torch.Tensor, n: int, max_points: int = 16384) -> torch.Tensor:
    """n representative rows = nearest rows to n k-means centroids, over at
    most ``max_points`` rows drawn from the table.  The reference hands one
    key to both draws, so both come from the provider ``d``."""
    N = values.shape[0]
    if N > max_points:
        sel = d.choice(N, max_points)
        _, nearest = kmeans(None, values[sel], n, draws=d)
        return sel[nearest.long()].to(torch.int32)
    return kmeans(None, values, n, draws=d)[1]


def _km_cols(d, values: torch.Tensor, m: int, target: int, max_dims: int = 2048):
    """m representative columns = the target and the nearest columns to
    m - 1 k-means centroids of the column vectors (over at most ``max_dims``
    rows drawn from the table)."""
    N, M = values.shape
    colpts = (values[d.choice(N, max_dims)] if N > max_dims else values).T.contiguous()
    _, nearest = kmeans(None, colpts, min(m - 1, M - 1), draws=d)
    return _target_mask(M, target, values.device).index_fill(0, nearest.long(), True)


def km_dst(generator: Optional[torch.Generator], coded: CodedDataset, n=None, m=None, *,
           device: DeviceLike = None, draws=None) -> DSTResult:
    """k-means representatives: rows nearest to n centroids of the rows,
    columns nearest to m - 1 centroids of the columns."""
    coded, dev, n, m, draws = _setup(generator, coded, n, m, device, draws)
    kr, kc = draws.split()
    rows = _km_rows(kr, coded.values, n)
    cm = _km_cols(kc, coded.values, m, coded.target_col)
    fitness, f_ref = _subset_fitness(coded, rows, cm)
    return DSTResult(rows, cm, fitness, torch.zeros(0, device=dev), f_ref)


# ---------------------------------------------------------------------------
# E. Information gain
# ---------------------------------------------------------------------------


def information_gain(codes: torch.Tensor, B: int, target: int) -> torch.Tensor:
    """IG(col j; y) = H(y) - H(y | x_j) (M,), float32, from the joint code
    histograms of every column with the target (one flat ``scatter_add_``
    into (M, B, B)); the target's own gain is -inf, so it never selects
    itself."""
    N, M = codes.shape
    dev = codes.device
    y = codes[:, target].long()
    flat = codes.long() * B + y[:, None] + torch.arange(M, device=dev) * (B * B)
    joint = torch.zeros(M * B * B, device=dev).scatter_add_(
        0, flat.reshape(-1), torch.ones(N * M, device=dev)).reshape(M, B, B)
    pj = joint.sum(2)                                               # (M, B): count of x = v
    cond = joint / pj[..., None].clamp_min(1e-12)
    h_cond = -torch.where(cond > 0, cond * torch.log2(cond.clamp_min(1e-30)), 0.0).sum(2)
    h_y_given_x = ((pj / N) * h_cond).sum(1)                        # (M,)
    py = torch.zeros(B, device=dev).scatter_add_(0, y, torch.ones(N, device=dev)) / N
    h_y = -torch.where(py > 0, py * torch.log2(py.clamp_min(1e-30)), 0.0).sum()
    ig = h_y - h_y_given_x
    return torch.where(torch.arange(M, device=dev) == target, -_INF, ig)


def _ig_cols(coded: CodedDataset, m: int) -> torch.Tensor:
    """The target and the m - 1 columns of highest information gain."""
    ig = information_gain(coded.codes, coded.max_bins, coded.target_col)
    top = torch.argsort(-ig, stable=True)[:m - 1]
    return _target_mask(coded.num_cols, coded.target_col, ig.device).index_fill(0, top, True)


def ig_rand_dst(generator: Optional[torch.Generator], coded: CodedDataset, n=None, m=None, *,
                device: DeviceLike = None, draws=None) -> DSTResult:
    """Information-gain columns and n distinct random rows."""
    coded, dev, n, m, draws = _setup(generator, coded, n, m, device, draws)
    cm = _ig_cols(coded, m)
    rows = draws.choice(coded.num_rows, n).to(torch.int32)
    fitness, f_ref = _subset_fitness(coded, rows, cm)
    return DSTResult(rows, cm, fitness, torch.zeros(0, device=dev), f_ref)


def ig_km_dst(generator: Optional[torch.Generator], coded: CodedDataset, n=None, m=None, *,
              device: DeviceLike = None, draws=None) -> DSTResult:
    """Information-gain columns and k-means representative rows."""
    coded, dev, n, m, draws = _setup(generator, coded, n, m, device, draws)
    cm = _ig_cols(coded, m)
    rows = _km_rows(draws, coded.values, n)
    fitness, f_ref = _subset_fitness(coded, rows, cm)
    return DSTResult(rows, cm, fitness, torch.zeros(0, device=dev), f_ref)
