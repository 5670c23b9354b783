"""Gen-DST of the port against the reference's, on the CPU.

Every GA operator of the port is a pure function of its draws; fed the
draws the reference makes from a key (``_torch_port.JaxDraws`` replays its
splits), each operator must be bit-equal to the reference's, and whole runs
must find the same subset.

Tolerances: rows, masks, indices and counts bit-equal; fitness 1e-6
absolute (the port sums entropies in float64, the reference in float32).
Over 5 seeds with its own torch draws, the port's mean loss |F(d) - F(D)|
may exceed the reference's mean by at most 2 standard deviations of the
reference's losses + 0.01 bits.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.gen_dst as J
import repro_torch.core.gen_dst as T
from repro.core.measures import factorize as j_factorize
from repro_torch.core.measures import factorize as t_factorize
from repro_torch.device import make_generator
from repro_torch.kernels.entropy.ops import population_histogram
from repro_torch.kernels.gen_dst.ops import fused_delta_fitness
from _torch_port import (
    JaxDraws, cross_draws, init_draws, mutate_draws, np_, t, to_port,
)

N, M, n, m, PHI = 400, 7, 20, 3, 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = np.column_stack([rng.integers(0, k, N) for k in (3, 5, 17, 2, 40, 7)]).astype(float)
    y = rng.integers(0, 2, N).astype(float)
    return X, y


@pytest.fixture(scope="module")
def coded(data):
    return j_factorize(*data), t_factorize(*data, device="cpu")


# the reference's operators, jitted once per file (eager JAX compiles op by op)
_j_init = jax.jit(J._init_population, static_argnums=(1, 2, 3, 4, 5, 6))


@functools.partial(jax.jit, static_argnames=("target",))
def _j_mutate(key, rows, cols, xi, p_rc, *, target):
    return J._mutate_core(key, rows, cols, N=N, M=M, n=n, m=m, xi=xi, p_rc=p_rc, target=target)


@functools.partial(jax.jit, static_argnames=("target",))
def _j_crossover(key, rows, cols, p_rc, *, target):
    return J._crossover(key, rows, cols, N=N, M=M, n=n, m=m, p_rc=p_rc, target=target)


@pytest.fixture(scope="module")
def pop(coded):
    """A reference population to mutate and cross."""
    cj, _ = coded
    return _j_init(jax.random.key(3), N, M, n, m, PHI, cj.target_col)


def test_mask_utilities_bit_equal():
    key = jax.random.key(0)
    rng = np.random.default_rng(0)
    masks = rng.random((6, 11)) < 0.5
    for i, mask in enumerate(masks):
        k = jax.random.fold_in(key, i)
        u = t(jax.random.uniform(k, (11,)))
        scores = np.where(mask, rng.random(11), -np.inf).astype(np.float32)  # tied -inf
        np.testing.assert_array_equal(np_(T._rank_desc(t(scores))),
                                      np.asarray(J._rank_desc(jnp.asarray(scores))))
        for kk in (0, 1, 3, 20):
            np.testing.assert_array_equal(
                np_(T._sample_members(u, t(mask), kk)),
                np.asarray(J._sample_members(k, jnp.asarray(mask), kk)))
        forbidden = rng.random(11) < 0.3
        np.testing.assert_array_equal(
            np_(T._refill_to(u, t(mask), 6, t(forbidden))),
            np.asarray(J._refill_to(k, jnp.asarray(mask), 6, jnp.asarray(forbidden))))
        rows = rng.integers(0, 9, 12).astype(np.int32)            # many duplicates
        fresh = t(jax.random.randint(k, (12,), 0, 9, dtype=jnp.int32))
        np.testing.assert_array_equal(np_(T._dedup_rows(fresh, t(rows))),
                                      np.asarray(J._dedup_rows(k, jnp.asarray(rows), 9)))


def test_init_population_bit_equal(coded):
    cj, _ = coded
    key = jax.random.key(5)
    rj, cmj = _j_init(key, N, M, n, m, PHI, cj.target_col)
    rt, cmt = T._init_population(to_port([init_draws(key, PHI, N, M, n)]), N, M, n, m,
                                 cj.target_col)
    np.testing.assert_array_equal(np_(rt[0]), np.asarray(rj))
    np.testing.assert_array_equal(np_(cmt[0]), np.asarray(cmj))
    assert (np_(cmt).sum(-1) == m).all()


@pytest.mark.parametrize("xi", [0.025, 0.9])
def test_mutate_core_bit_equal(coded, pop, xi):
    cj, _ = coded
    rows, cols = pop
    key = jax.random.key(11)
    kw = dict(N=N, M=M, n=n, m=m, xi=xi, p_rc=0.5, target=cj.target_col)
    ref = _j_mutate(key, rows, cols, xi, 0.5, target=cj.target_col)
    out = T._mutate_core(to_port([mutate_draws(key, PHI, N, M, n)]),
                         t(rows)[None], t(cols)[None], **kw)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np_(a[0]), np.asarray(b))


def test_permutation_draw_applies_index_permutation():
    """``permutation(k, r)`` equals ``r[permutation(k, len(r))]``, which is
    what lets the port take row permutations as index draws."""
    r = jnp.arange(100, 130, dtype=jnp.int32)
    for i in range(4):
        k = jax.random.key(i)
        np.testing.assert_array_equal(np.asarray(jax.random.permutation(k, r)),
                                      np.asarray(r[jax.random.permutation(k, 30)]))


@pytest.mark.parametrize("p_rc", [0.9, 0.3])
def test_crossover_bit_equal(coded, pop, p_rc):
    cj, _ = coded
    rows, cols = pop
    key = jax.random.key(13)
    kw = dict(N=N, M=M, n=n, m=m, p_rc=p_rc, target=cj.target_col)
    rj, cmj = _j_crossover(key, rows, cols, p_rc, target=cj.target_col)
    rt, cmt = T._crossover(to_port([cross_draws(key, PHI, N, M, n, m)]),
                           t(rows)[None], t(cols)[None], **kw)
    np.testing.assert_array_equal(np_(rt[0]), np.asarray(rj))
    np.testing.assert_array_equal(np_(cmt[0]), np.asarray(cmj))


def test_crossover_splits_ranges_and_independence():
    gen = make_generator(0)
    s_r, s_c = T._crossover_splits(gen, (4, 500), 5, 6, "cpu")
    assert int(s_r.min()) == 1 and int(s_r.max()) == 4
    assert int(s_c.min()) == 1 and int(s_c.max()) == 4
    assert not torch.equal(s_r, s_c), "row and column splits must be drawn apart"


def test_select_idx_bit_equal():
    rng = np.random.default_rng(2)
    fit = -np.abs(rng.normal(0, 1, 20)).astype(np.float32)
    fit[[3, 7, 11]] = fit[5]                               # ties: stable order
    key = jax.random.key(17)
    ref = J._select_idx(key, jnp.asarray(fit), alpha=0.15)
    probs = T._selection_probs(t(fit)[None])
    np.testing.assert_allclose(np_(probs[0]), (fit - fit.min() + 1e-9) / (fit - fit.min() + 1e-9).sum(),
                               rtol=1e-6)
    n_elite = max(1, int(round(0.15 * 20)))
    drawn = jax.random.choice(key, 20, (20 - n_elite,), replace=True,
                              p=jnp.asarray(np_(probs[0])))
    out = T._select_idx(t(fit)[None], t(drawn, torch.int64)[None], alpha=0.15)
    np.testing.assert_array_equal(np_(out[0]), np.asarray(ref))


def test_ring_migrate_bit_equal():
    rng = np.random.default_rng(4)
    I, phi = 3, 10
    rows = rng.integers(0, 50, (I, phi, 4)).astype(np.int32)
    cols = rng.random((I, phi, 5)) < 0.5
    counts = rng.random((I, phi, 5, 8)).astype(np.float32)
    fit = np.round(-rng.random((I, phi)), 1).astype(np.float32)   # many ties
    ref = jax.jit(functools.partial(J._ring_migrate, k=2))(
        *(jnp.asarray(a) for a in (rows, cols, counts, fit)))
    out = T._ring_migrate(t(rows), t(cols), t(counts), t(fit), k=2)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np_(a), np.asarray(b))


def test_incremental_counts_equal_recompute(coded, pop):
    """A generation's delta-updated counts equal a full recompute, bit for bit."""
    cj, ct = coded
    rows, cols = pop
    key = jax.random.key(19)
    d = to_port([mutate_draws(key, PHI, N, M, n)])
    d["u_mut"] = torch.zeros_like(d["u_mut"])                # every candidate mutates
    r0, c0 = t(rows)[None], t(cols)[None]
    r1, c1, applied, old, fresh = T._mutate_core(
        d, r0, c0, N=N, M=M, n=n, m=m, xi=0.5, p_rc=1.0, target=cj.target_col)
    assert bool(applied.any())
    B = ct.max_bins

    def recount(r):
        return population_histogram(ct.codes[r.reshape(-1, n).long()], B).reshape(1, PHI, M, B)

    counts, _ = fused_delta_fitness(recount(r0), ct.codes[old.long()], ct.codes[fresh.long()],
                                    applied, c1, 0.0)
    assert torch.equal(counts, recount(r1))


# one reference config, compiled once for the file: islands with ring
# migration, crossover every other generation and incremental counts between,
# so a run takes every branch of the generation loop
CFG = J.GenDSTConfig(psi=4, phi=PHI, num_islands=2, cross_every=2, migrate_every=2,
                     migrate_frac=0.25)


def _port_cfg(cfg):
    return T.GenDSTConfig(**{k: v for k, v in cfg._asdict().items() if k != "backend"})


def test_whole_run_on_reference_draws(coded):
    """Generations composed from the port's operators and kernels' plain
    versions, on the reference's draws, reproduce the reference's run."""
    cj, ct = coded
    key = jax.random.key(21)
    ref = J.gen_dst(key, cj, n, m, CFG)
    out = T.gen_dst(None, ct, n, m, _port_cfg(CFG), device="cpu", draws=JaxDraws(key))
    np.testing.assert_array_equal(np_(out.row_idx), np.asarray(ref.row_idx))
    np.testing.assert_array_equal(np_(out.col_mask), np.asarray(ref.col_mask))
    np.testing.assert_allclose(float(out.fitness), float(ref.fitness), atol=1e-6)
    np.testing.assert_allclose(np_(out.history), np.asarray(ref.history), atol=1e-6)
    np.testing.assert_allclose(float(out.f_ref), float(ref.f_ref), atol=1e-6)


def test_search_quality_over_seeds(coded):
    cj, ct = coded
    ref_loss = np.array([-float(J.gen_dst(jax.random.key(s), cj, n, m, CFG).fitness)
                         for s in range(5)])
    port_loss = np.array([-float(T.gen_dst(make_generator(s), ct, n, m, _port_cfg(CFG),
                                           device="cpu").fitness) for s in range(5)])
    assert port_loss.mean() <= ref_loss.mean() + 2 * ref_loss.std() + 0.01, (port_loss, ref_loss)


def test_result_invariants(coded):
    _, ct = coded
    res = T.gen_dst(make_generator(1), ct, n, m, T.GenDSTConfig(psi=5, phi=PHI), device="cpu")
    assert res.row_idx.shape == (n,) and res.row_idx.dtype == torch.int32
    assert int(res.col_mask.sum()) == m and bool(res.col_mask[ct.target_col])
    assert (np.diff(np_(res.history)) >= 0).all(), "best-so-far is monotone"
    rd = T.random_dst(make_generator(2), ct, n, m, device="cpu")
    assert rd.row_idx.shape == (n,) and int(rd.col_mask.sum()) == m
    with pytest.raises(ValueError):
        T.gen_dst(None, ct, n, m, T.GenDSTConfig(phi=7), device="cpu")


@pytest.mark.parametrize("measure", ["pnorm", "mean_correlation", "coeff_variation"])
def test_whole_run_other_measures_on_reference_draws(coded, measure):
    """The values-based measures, with islands, crossover every other
    generation and recomputed (not incremental) counts: the reference's run."""
    cj, ct = coded
    cfg = J.GenDSTConfig(psi=3, phi=PHI, num_islands=2, cross_every=2, migrate_every=2,
                         migrate_frac=0.25, measure=measure, incremental=False)
    key = jax.random.key(23)
    ref = J.gen_dst(key, cj, n, m, cfg)
    out = T.gen_dst(None, ct, n, m, _port_cfg(cfg), device="cpu", draws=JaxDraws(key))
    np.testing.assert_array_equal(np_(out.row_idx), np.asarray(ref.row_idx))
    np.testing.assert_array_equal(np_(out.col_mask), np.asarray(ref.col_mask))
    np.testing.assert_allclose(float(out.fitness), float(ref.fitness), atol=1e-6)
    np.testing.assert_allclose(np_(out.history), np.asarray(ref.history), atol=1e-6)


def _tables(count):
    """``count`` same-shaped factorized tables (same column cardinalities)."""
    out = []
    for i in range(count):
        rng = np.random.default_rng(100 + i)
        X = np.column_stack([rng.permutation(np.arange(N) % k)
                             for k in (3, 5, 17, 2, 40, 7)]).astype(float)
        y = rng.permutation(np.arange(N) % 2).astype(float)
        out.append((j_factorize(X, y), t_factorize(X, y, device="cpu")))
    return out


def test_gen_dst_batch_equals_solo_and_reference():
    """D = 3 searches as one: each bit-equal to its solo run (the port's own
    draws) and to the reference's ``gen_dst_batch`` (its replayed draws),
    with islands, so migration must stay within each dataset's ring."""
    tables = _tables(3)
    cts = [ct for _, ct in tables]
    cfg = _port_cfg(CFG)
    gens = [make_generator(s) for s in (0, 1, 2)]
    batch = T.gen_dst_batch(gens, cts, n, m, cfg, device="cpu")
    for s, ct, b in zip((0, 1, 2), cts, batch):
        solo = T.gen_dst(make_generator(s), ct, n, m, cfg, device="cpu")
        for a, c in zip(solo, b):
            assert torch.equal(a, c)
    keys = [jax.random.key(s) for s in (30, 31, 32)]
    ref = J.gen_dst_batch(keys, [cj for cj, _ in tables], n, m, CFG)
    out = T.gen_dst_batch([None] * 3, cts, n, m, cfg, device="cpu",
                          draws=[JaxDraws(k) for k in keys])
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np_(o.row_idx), np.asarray(r.row_idx))
        np.testing.assert_array_equal(np_(o.col_mask), np.asarray(r.col_mask))
        np.testing.assert_allclose(float(o.fitness), float(r.fitness), atol=1e-6)
        np.testing.assert_allclose(np_(o.history), np.asarray(r.history), atol=1e-6)
        np.testing.assert_allclose(float(o.f_ref), float(r.f_ref), atol=1e-6)


def test_gen_dst_batch_rejects_mismatched_inputs(coded):
    _, ct = coded
    cfg = T.GenDSTConfig(psi=2, phi=4)
    short = ct._replace(codes=ct.codes[:300], values=ct.values[:300])
    with pytest.raises(ValueError, match="share"):
        T.gen_dst_batch([None, None], [ct, short], n, m, cfg, device="cpu")
    with pytest.raises(ValueError, match="share"):
        T.gen_dst_batch([None, None], [ct, ct._replace(target_col=0)], n, m, cfg,
                        device="cpu")
    with pytest.raises(ValueError, match="equal-length"):
        T.gen_dst_batch([None], [ct, ct], n, m, cfg, device="cpu")
    with pytest.raises(ValueError, match="equal-length"):
        T.gen_dst_batch([], [], n, m, cfg, device="cpu")
    with pytest.raises(ValueError):
        T.gen_dst_batch([None], [ct], n, m, T.GenDSTConfig(phi=7), device="cpu")
