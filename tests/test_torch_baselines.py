"""The paper's baselines in the port (core/baselines.py) against the reference's.

Each baseline of the port is a pure function of its draws; fed the draws the
reference makes from a key (``_torch_port.JaxKey`` replays its splits), it
must find the reference's subset.  Data as in ``tests/test_baselines.py``:
800 rows, 5 features and the target, n = 20, m = 3.

Tolerances: rows, masks and indices bit-equal; fitness, history, F(D) and
information gain within 1e-6 (1e-5 for the gain); k-means centroids within
1e-5.  The port sums entropies in float64 and the reference in float32, so
two candidates whose losses lie within ~1e-6 can swap.  Where an argmin,
argmax or argsort over floats decides a pick, the test asserts on the
reference's own values that the pick is clear: the winner is the first of
the candidates within 1e-5 of it, and the others are tied with it in exact
arithmetic (the same column count multisets; identical points), which the
port scores exactly equal, so that the first index decides in both
packages.  The seeds are ones whose picks are clear.  For mab and the greedy pair the reference's
steps are closures; the test transcribes them below (``_ref_*``) and holds
a whole run of the transcription bit-equal to the reference's run before
reading margins from it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.baselines as JB
import repro.core.gen_dst as JG
import repro.core.measures as JM
import repro_torch.core.baselines as TB
from repro_torch.core.measures import factorize as t_factorize
from repro_torch.device import make_generator
from _torch_port import JaxKey, np_, t

n, m = 20, 3
MARGIN = 1e-5


@pytest.fixture(scope="module")
def coded():
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 800)
    informative = y * 3 + rng.integers(0, 3, 800)      # strongly y-dependent
    noise = [rng.integers(0, 8, 800) for _ in range(4)]
    X = np.column_stack([informative] + noise).astype(float)
    return JM.factorize(X, y.astype(float)), t_factorize(X, y.astype(float), device="cpu")


def _clear(values, i, larger=False, tied=None):
    """Whether index ``i`` wins ``values`` (argmin; argmax with ``larger``)
    clearly: it is the first of the entries within MARGIN of it, and every
    other such entry is ``tied`` with it (its inputs equal up to order,
    which the port scores exactly equal), so that the first index decides
    in both packages."""
    v = np.asarray(values, np.float64) * (-1.0 if larger else 1.0)
    close = np.flatnonzero(v - v[i] <= MARGIN)
    return close[0] == i and all(j == i or (tied is not None and tied[j]) for j in close)


def _count_sets(counts):
    """Each column's multiset of counts, (..., M, B) -> nested tuples: two
    columns with equal ones have the same entropy."""
    c = np.asarray(counts)
    return [tuple(sorted(col[col > 0])) for col in c.reshape(-1, c.shape[-1])]


def _signatures(counts, cols=None):
    """Per candidate (P, M, B), the multiset of the (selected) columns' count
    multisets: candidates with equal ones have the same loss."""
    P, M, _ = np.shape(counts)
    sel = np.arange(M) if cols is None else np.flatnonzero(np.asarray(cols))
    sets = _count_sets(counts)
    return [tuple(sorted(sets[p * M + j] for j in sel)) for p in range(P)]


def _assert_same_dst(out, ref, history=True):
    np.testing.assert_array_equal(np_(out.row_idx), np.asarray(ref.row_idx))
    np.testing.assert_array_equal(np_(out.col_mask), np.asarray(ref.col_mask))
    np.testing.assert_allclose(float(out.fitness), float(ref.fitness), atol=1e-6)
    np.testing.assert_allclose(float(out.f_ref), float(ref.f_ref), atol=1e-6)
    if history:
        np.testing.assert_allclose(np_(out.history), np.asarray(ref.history), atol=1e-6)


def _f_ref(cj):
    return JM.full_column_entropy(cj.codes, cj.max_bins).mean()


# ---------------------------------------------------------------------------
# A. Monte-Carlo search
# ---------------------------------------------------------------------------

_j_init = jax.jit(JG._init_population, static_argnums=(1, 2, 3, 4, 5, 6))
_j_fitness = jax.jit(JG._entropy_fitness, static_argnums=(1,))


def _ref_mc_batch(cj, key, batch):
    N, M = cj.codes.shape
    rows, cols = _j_init(key, N, M, n, m, batch, cj.target_col)
    return rows, cols, _j_fitness(cj.codes, cj.max_bins, _f_ref(cj), rows, cols)


def test_mc_batch_equal(coded):
    """One batch from the same draws: the same candidates, the same fitness
    (B1 + B2's plain versions against the reference's gather-recompute)."""
    cj, ct = coded
    key = jax.random.key(4)
    rows, cols, fit = TB._mc_batch(JaxKey(key), ct, TB._f_ref(ct), n, m, 20)
    rj, cmj, fj = _ref_mc_batch(cj, key, 20)
    np.testing.assert_array_equal(np_(rows), np.asarray(rj))
    np.testing.assert_array_equal(np_(cols), np.asarray(cmj))
    np.testing.assert_allclose(np_(fit), np.asarray(fj), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mc_whole_run(coded, seed):
    cj, ct = coded
    key = jax.random.key(seed)
    ref = JB.mc_dst(key, cj, n, m, budget=60, batch=20)
    best = -np.inf
    for kb in jax.random.split(key, 3):          # the reference's batches, margins
        fit = np.asarray(_ref_mc_batch(cj, kb, 20)[2])
        i = int(np.argmax(fit))
        assert _clear(fit, i, larger=True)
        assert abs(fit[i] - best) > MARGIN
        best = max(best, fit[i])
    out = TB.mc_dst(None, ct, n, m, budget=60, batch=20, device="cpu", draws=JaxKey(key))
    _assert_same_dst(out, ref)


# ---------------------------------------------------------------------------
# B. Multi-Arm Bandit
# ---------------------------------------------------------------------------


def _ref_pick(key, values, k, eps, forbid_mask=None):
    """The reference's ``pick`` (baselines.py:114-121), with its scores."""
    kn, ke = jax.random.split(key)
    noise = jax.random.uniform(kn, values.shape) * 1e-3
    explore = jax.random.uniform(ke, ()) < eps
    scores = jnp.where(explore, jax.random.uniform(kn, values.shape), values + noise)
    if forbid_mask is not None:
        scores = scores - jnp.where(forbid_mask, jnp.inf, 0.0)
    return jnp.argsort(-scores)[:k], scores, explore


@functools.partial(jax.jit, static_argnames=("B", "target", "eps"))
def _ref_mab_round(key_t, carry, codes, f_ref, *, B, target, eps):
    """The reference's round (baselines.py:123-145), returning its scores."""
    M = codes.shape[1]
    tgt = jnp.zeros((M,), bool).at[target].set(True)
    rv, cv, rn, cn, best_f, best_r, best_c = carry
    kr, kc = jax.random.split(key_t)
    r, r_scores, r_explore = _ref_pick(kr, rv, n, eps)
    c_sel, c_scores, c_explore = _ref_pick(kc, cv, m - 1, eps, forbid_mask=tgt)
    r, c_sel = r.astype(jnp.int32), c_sel.astype(jnp.int32)
    cm = tgt.at[c_sel].set(True)
    h = JM.column_entropy_from_counts(JM.subset_counts(codes, r, B))
    cmf = cm.astype(jnp.float32)
    f_d = jnp.sum(h * cmf) / jnp.maximum(cmf.sum(), 1.0)
    reward = -jnp.abs(f_d - f_ref)
    rn = rn.at[r].add(1.0)
    cn2 = cn.at[c_sel].add(1.0)
    rv = rv.at[r].add((reward - rv[r]) / rn[r])
    cv = cv.at[c_sel].add((reward - cv[c_sel]) / cn2[c_sel])
    better = reward > best_f
    carry = (rv, cv, rn, cn2, jnp.where(better, reward, best_f),
             jnp.where(better, r, best_r), jnp.where(better, cm, best_c))
    return carry, reward, (r_scores, r_explore, c_scores, c_explore)


def _pick_clear(scores, explore, pulled, k):
    """The top-k pick is clear where an arm's value can differ between the
    packages (a pulled arm: rewards agree to ~1e-6): every selected arm
    leads every unselected one by more than MARGIN where either is pulled."""
    if explore:
        return True                       # scores are the shared draw alone
    s = np.asarray(scores, np.float64)
    order = np.argsort(-s, kind="stable")
    sel, rest = order[:k], order[k:]
    rest = rest[np.isfinite(s[rest])]
    p = np.asarray(pulled)
    for a_set, b_set in ((sel[p[sel]], rest), (sel, rest[p[rest]])):
        if len(a_set) and len(b_set) and not s[a_set].min() - s[b_set].max() > MARGIN:
            return False
    return True


def test_mab_pick_equal(coded):
    """``_pick`` from the same values and draws: the reference's picks."""
    key = jax.random.key(8)
    rng = np.random.default_rng(0)
    values = -rng.random(50).astype(np.float32) * (rng.random(50) < 0.5)
    forbid = np.arange(50) == 7
    for i, kk in enumerate(jax.random.split(key, 6)):
        eps = (0.15, 1.0)[i % 2]                 # greedy and exploring picks
        ref, _, _ = _ref_pick(kk, jnp.asarray(values), 9, eps, jnp.asarray(forbid))
        out = TB._pick(JaxKey(kk), t(values), 9, eps, forbid=t(forbid))
        np.testing.assert_array_equal(np_(out), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mab_whole_run(coded, seed):
    """Round by round from the same state, then the whole run."""
    cj, ct = coded
    N, M = cj.codes.shape
    key = jax.random.key(seed)
    eps = 0.15
    f_ref = _f_ref(cj)
    r0, c0 = _j_init(key, N, M, n, m, 2, cj.target_col)
    carry = (jnp.zeros((N,)), jnp.zeros((M,)), jnp.zeros((N,)), jnp.zeros((M,)),
             jnp.float32(-jnp.inf), r0[0], c0[0])
    tgt = t(np.arange(M) == cj.target_col)
    rewards = []
    for kt in jax.random.split(key, 30):
        rv, cv, rn, cn = carry[:4]
        state = tuple(t(x) for x in (rv, cv, rn, cn))
        new, reward, (rs, rx, cs, cx) = _ref_mab_round(
            kt, carry, cj.codes, f_ref, B=cj.max_bins, target=cj.target_col, eps=eps)
        assert _pick_clear(rs, bool(rx), np.asarray(rn) > 0, n)
        assert _pick_clear(cs, bool(cx), np.asarray(cn) > 0, m - 1)
        assert abs(float(reward) - float(carry[4])) > MARGIN
        (rv2, cv2, rn2, cn2), t_reward, _, _ = TB._mab_round(
            JaxKey(kt), state, ct, torch.tensor(float(f_ref)),
            tgt, n, m, eps)
        np.testing.assert_allclose(float(t_reward), float(reward), atol=1e-6)
        np.testing.assert_array_equal(np_(rn2), np.asarray(new[2]))
        np.testing.assert_array_equal(np_(cn2), np.asarray(new[3]))
        np.testing.assert_allclose(np_(rv2), np.asarray(new[0]), atol=1e-6)
        np.testing.assert_allclose(np_(cv2), np.asarray(new[1]), atol=1e-6)
        rewards.append(float(reward))
        carry = new
    ref = JB.mab_dst(key, cj, n, m, rounds=30, eps=eps)
    # the transcription is the reference's run
    np.testing.assert_array_equal(np.asarray(carry[5]), np.asarray(ref.row_idx))
    np.testing.assert_array_equal(np.asarray(ref.history), np.float32(rewards))
    out = TB.mab_dst(None, ct, n, m, rounds=30, eps=eps, device="cpu", draws=JaxKey(key))
    _assert_same_dst(out, ref)


# ---------------------------------------------------------------------------
# C. Greedy selection
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("B", "masked"))
def _ref_row_step(codes, counts, cand, f_ref, cm, *, B, masked):
    """The reference's greedy row step (baselines.py:185-193, 237-245)."""
    new_counts = counts[None] + jax.nn.one_hot(jnp.take(codes, cand, axis=0), B,
                                               dtype=jnp.float32)
    h = JM.column_entropy_from_counts(new_counts)
    if not masked:
        return new_counts, h, jnp.abs(h.mean(axis=-1) - f_ref)
    cmf = cm.astype(jnp.float32)
    f_d = jnp.sum(h * cmf[None], axis=-1) / jnp.maximum(cmf.sum(), 1.0)
    return new_counts, h, jnp.abs(f_d - f_ref)


def _ref_col_loss(h_i, cm, f_ref):
    """The reference's column step's losses (baselines.py:250-253)."""
    cmf = cm.astype(jnp.float32)
    cnt = cm.sum()
    cur = jnp.sum(h_i * cmf) / jnp.maximum(cnt, 1)
    return jnp.abs((cur * cnt + h_i) / (cnt + 1) - f_ref) + jnp.where(cm, jnp.inf, 0.0)


def _greedy_steps(cj, ct, key, pool, masked):
    """Walk the reference's greedy steps (transcribed) beside the port's
    from the same state: each step's losses within 1e-6 and its pick equal,
    the reference's pick asserted clear; the same for the column picks.
    Returns the reference's rows and losses."""
    codes, B = cj.codes, cj.max_bins
    N, M = codes.shape
    f_ref = _f_ref(cj)
    f_ref_t = torch.tensor(float(f_ref))
    counts = jnp.zeros((M, B))
    cm = jnp.zeros((M,), bool).at[cj.target_col].set(True)
    rows, losses = [], []
    for kt in jax.random.split(key, n):
        cand = jax.random.randint(kt, (pool,), 0, N, dtype=jnp.int32)
        new_counts, h, loss = _ref_row_step(codes, counts, cand, f_ref, cm, B=B, masked=masked)
        i = int(jnp.argmin(loss))
        sig = _signatures(new_counts, cm if masked else None)
        assert _clear(loss, i, tied=[x == sig[i] for x in sig])
        _, h_t, loss_t, i_t = TB._greedy_row_step(
            ct.codes, B, t(counts), t(cand), f_ref_t, t(cm) if masked else None)
        np.testing.assert_allclose(np_(loss_t), np.asarray(loss), atol=1e-6)
        np.testing.assert_allclose(np_(h_t), np.asarray(h), atol=1e-6)
        assert int(i_t) == i
        rows.append(int(cand[i]))
        losses.append(float(loss[i]))
        counts = new_counts[i]
        if masked and int(cm.sum()) < m:        # the column step adds a column
            cm = _col_step(h[i], counts, cm, f_ref)
    if not masked:                              # then the columns, greedily
        h = JM.column_entropy_from_counts(counts)
        for _ in range(m - 1):
            cm = _col_step(h, counts, cm, f_ref)
    return np.int32(rows), np.float32(losses)


def _col_step(h, counts, cm, f_ref):
    """One greedy column pick of the reference from the entropies ``h`` of
    ``counts``, asserted clear and equal to the port's from the same state;
    returns the grown mask."""
    closs = _ref_col_loss(h, cm, f_ref)
    j = int(jnp.argmin(closs))
    sets = _count_sets(counts)
    assert _clear(closs, j, tied=[x == sets[j] for x in sets])
    assert int(TB._greedy_col_pick(t(h), t(cm), torch.tensor(float(f_ref)))) == j
    return cm.at[j].set(True)


# seeds whose reference picks are clear at every step (searched over 0-59)
@pytest.mark.parametrize("seed", [1, 32])
def test_greedy_seq_steps_and_run(coded, seed):
    cj, ct = coded
    key = jax.random.key(seed)
    rows, losses = _greedy_steps(cj, ct, key, 16, masked=False)
    ref = JB.greedy_seq_dst(key, cj, n, m, pool=16)
    np.testing.assert_array_equal(rows, np.asarray(ref.row_idx))
    np.testing.assert_array_equal(losses, np.asarray(ref.history))
    out = TB.greedy_seq_dst(None, ct, n, m, pool=16, device="cpu", draws=JaxKey(key))
    _assert_same_dst(out, ref)


@pytest.mark.parametrize("seed", [3, 27, 30])
def test_greedy_mult_steps_and_run(coded, seed):
    cj, ct = coded
    key = jax.random.key(seed)
    rows, losses = _greedy_steps(cj, ct, key, 16, masked=True)
    ref = JB.greedy_mult_dst(key, cj, n, m, pool=16)
    np.testing.assert_array_equal(rows, np.asarray(ref.row_idx))
    np.testing.assert_array_equal(losses, np.asarray(ref.history))
    out = TB.greedy_mult_dst(None, ct, n, m, pool=16, device="cpu", draws=JaxKey(key))
    _assert_same_dst(out, ref)


@pytest.mark.parametrize("m_cols", [2, 3, 5])
def test_greedy_cols_equal(m_cols):
    rng = np.random.default_rng(m_cols)
    h = (rng.random(9) * 4).astype(np.float32)
    f_ref = jnp.float32(2.1)
    ref = JB._greedy_cols(jnp.asarray(h), f_ref, m_cols, 4)
    cm = jnp.zeros((9,), bool).at[4].set(True)
    for _ in range(m_cols - 1):                   # the reference's picks are clear
        closs = _ref_col_loss(jnp.asarray(h), cm, f_ref)
        assert _clear(closs, int(jnp.argmin(closs)))
        cm = cm.at[jnp.argmin(closs)].set(True)
    out = TB._greedy_cols(t(h), torch.tensor(2.1), m_cols, 4)
    np.testing.assert_array_equal(np_(out), np.asarray(ref))


# ---------------------------------------------------------------------------
# D. K-Means clustering
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def _ref_kmeans_path(key, points, k, iters=10):
    """The reference's Lloyd iterations (baselines.py:288-304), transcribed
    to return the standardised points and every iterate's centroids."""
    mu = points.std(axis=0) + 1e-9
    z = (points - points.mean(axis=0)) / mu
    cent = z[jax.random.choice(key, points.shape[0], (k,), replace=False)]

    def step(cent, _):
        d2 = ((z[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
        onehot = jax.nn.one_hot(jnp.argmin(d2, axis=1), k, dtype=jnp.float32)
        cnts = onehot.sum(0)[:, None]
        new = jnp.where(cnts > 0, (onehot.T @ z) / jnp.maximum(cnts, 1), cent)
        return new, cent

    last, path = jax.lax.scan(step, cent, None, length=iters)
    return z, jnp.concatenate([path, last[None]])


def _kmeans_clear(key, points, k, iters=10):
    """Every assignment of the reference's Lloyd iterations, and its final
    nearest points, won clearly (identical centroids or points aside)."""
    z, path = (np.asarray(a) for a in _ref_kmeans_path(key, points, k, iters))
    np.testing.assert_array_equal(path[-1], np.asarray(JB.kmeans(key, points, k, iters)[0]))
    for it, cent in enumerate(path):
        d2 = ((z[:, None, :] - cent[None]) ** 2).sum(-1)
        if it < iters:
            for p in range(len(z)):
                i = int(np.argmin(d2[p]))
                if not _clear(d2[p], i, tied=(cent == cent[i]).all(1)):
                    return False
    for c in range(k):
        i = int(np.argmin(d2[:, c]))
        if not _clear(d2[:, c], i, tied=(z == z[i]).all(1)):
            return False
    return True


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_equal(seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(-5, 0.3, (50, 3)), rng.normal(5, 0.3, (50, 3)),
                          rng.normal(0, 1.0, (40, 3))]).astype(np.float32)
    key = jax.random.key(seed)
    assert _kmeans_clear(key, jnp.asarray(pts), 4)
    cent, nearest = JB.kmeans(key, jnp.asarray(pts), 4)
    tc, tn = TB.kmeans(None, t(pts), 4, draws=JaxKey(key))
    np.testing.assert_allclose(np_(tc), np.asarray(cent), atol=1e-5)
    np.testing.assert_array_equal(np_(tn), np.asarray(nearest))
    # from a generator: valid indices, one centroid per cluster found
    tc, tn = TB.kmeans(make_generator(seed), t(pts), 4)
    assert tc.shape == (4, 3) and tn.dtype == torch.int32 and int(tn.max()) < len(pts)


@pytest.mark.parametrize("max_points", [300, 16384])
def test_km_rows_equal(coded, max_points):
    """Representative rows over all rows, and over a drawn subsample."""
    cj, ct = coded
    key = jax.random.key(3)
    N = cj.codes.shape[0]
    if N > max_points:
        sel = jax.random.choice(key, N, (max_points,), replace=False)
        assert _kmeans_clear(key, jnp.take(cj.values, sel, axis=0), n)
    else:
        assert _kmeans_clear(key, cj.values, n)
    ref = JB._km_rows(key, cj, n, max_points=max_points)
    out = TB._km_rows(JaxKey(key), ct.values, n, max_points=max_points)
    np.testing.assert_array_equal(np_(out), np.asarray(ref))


@pytest.mark.parametrize("seed", [3, 7])
def test_km_dst_equal(coded, seed):
    cj, ct = coded
    key = jax.random.key(seed)
    kr, kc = jax.random.split(key)
    assert _kmeans_clear(kr, cj.values, n)
    assert _kmeans_clear(kc, cj.values.T, m - 1)
    ref = JB.km_dst(key, cj, n, m)
    out = TB.km_dst(None, ct, n, m, device="cpu", draws=JaxKey(key))
    _assert_same_dst(out, ref)


# ---------------------------------------------------------------------------
# E. Information gain
# ---------------------------------------------------------------------------


def _ig_clear(cj):
    """The reference's IG ranking separates the chosen m - 1 columns from
    the rest by more than MARGIN."""
    ig = np.sort(np.asarray(JB.information_gain(cj.codes, cj.max_bins, cj.target_col)))[::-1]
    return ig[m - 2] - ig[m - 1] > MARGIN


def test_information_gain_equal(coded):
    cj, ct = coded
    ref = np.asarray(JB.information_gain(cj.codes, cj.max_bins, cj.target_col))
    out = np_(TB.information_gain(ct.codes, ct.max_bins, ct.target_col))
    assert out[ct.target_col] == -np.inf
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert out.argmax() == 0, "IG picks the y-correlated column"


@pytest.mark.parametrize("seed", [0, 3])
def test_ig_rand_and_ig_km_equal(coded, seed):
    cj, ct = coded
    key = jax.random.key(seed)
    assert _ig_clear(cj)
    _assert_same_dst(TB.ig_rand_dst(None, ct, n, m, device="cpu", draws=JaxKey(key)),
                     JB.ig_rand_dst(key, cj, n, m), history=False)
    assert _kmeans_clear(key, cj.values, n)
    _assert_same_dst(TB.ig_km_dst(None, ct, n, m, device="cpu", draws=JaxKey(key)),
                     JB.ig_km_dst(key, cj, n, m), history=False)


# ---------------------------------------------------------------------------
# every baseline from a generator: a valid DST (tests/test_baselines.py)
# ---------------------------------------------------------------------------

ALL_BASELINES = [
    ("mc", lambda g, c: TB.mc_dst(g, c, n, m, budget=60, batch=20, device="cpu")),
    ("mab", lambda g, c: TB.mab_dst(g, c, n, m, rounds=30, device="cpu")),
    ("greedy_seq", lambda g, c: TB.greedy_seq_dst(g, c, n, m, pool=16, device="cpu")),
    ("greedy_mult", lambda g, c: TB.greedy_mult_dst(g, c, n, m, pool=16, device="cpu")),
    ("km", lambda g, c: TB.km_dst(g, c, n, m, device="cpu")),
    ("ig_rand", lambda g, c: TB.ig_rand_dst(g, c, n, m, device="cpu")),
    ("ig_km", lambda g, c: TB.ig_km_dst(g, c, n, m, device="cpu")),
]


@pytest.mark.parametrize("name,fn", ALL_BASELINES, ids=[name for name, _ in ALL_BASELINES])
def test_baseline_valid_dst_from_generator(name, fn, coded):
    _, ct = coded
    res = fn(make_generator(0), ct)
    rows = np_(res.row_idx)
    assert res.row_idx.shape == (n,) and res.row_idx.dtype == torch.int32
    assert (rows >= 0).all() and (rows < ct.num_rows).all()
    assert bool(res.col_mask[ct.target_col]) and 2 <= int(res.col_mask.sum()) <= m
    f_plain = TB._subset_fitness(ct, res.row_idx, res.col_mask)[0]
    assert np.isfinite(float(res.fitness))
    np.testing.assert_allclose(float(res.fitness), float(f_plain), atol=1e-6)
