"""Gen-DST's generation body and CUDA-graph path against the loop they
replaced.

``core/gen_dst._gen_dst_run`` runs one generation body: it reads the
carried state and returns the next, writing the generation's best fitness
into the history at a device counter.  On the CPU (and on a card wherever
the search cannot be captured) the body runs eagerly, generation by
generation; on a card each generation kind runs once eagerly and is then
replayed from a CUDA graph (``_GenerationGraphs``).  ``_loop_gen_dst`` below
is the out-of-place loop that ``_gen_dst_run`` ran before the body existed,
which ``test_torch_gen_dst.py`` held to the reference.

The CPU cases hold the body to that loop bit for bit (crossing and
incremental generations, recomputes, islands with migration, a batch of
datasets, a values-based measure) and check that every generation span
carries ``gen_graphed`` 0 there.  The ``cuda`` cases hold the graph path to
the eager loop on the card, from one generator seed: the eager loop is
reached through ``_Forward``, a draw provider that forwards every draw to a
``TorchDraws`` on the same generator and that the graph path does not take.
They compare rows, mask, fitness, history and F(D) bit for bit at D1's and
D6's training tables, at the largest and smallest partitions of the
many-models cell, for a batch of four tables, for island search and for
crossover every second generation, and check that a graphed search waits
for no host sync, replays psi - 1 generations at the paper's defaults, and
counts psi + 1 launches of each kernel.

This file imports no JAX, so the ``cuda`` cases run on a card machine:
``python -m pytest -q -m cuda tests/test_torch_gen_dst_graph.py`` with
``src`` on the path.
"""
import numpy as np
import pytest
import torch

import repro_torch.core.gen_dst as T
from _card import no_host_sync, skip_without_cuda
from repro_torch import kernels as K
from repro_torch.core.gen_dst import GenDSTConfig, TorchDraws, gen_dst, gen_dst_batch
from repro_torch.core.measures import MEASURES, factorize, full_column_entropy
from repro_torch.device import make_generator
from repro_torch.obs import trace


def _loop_gen_dst(codes, values, N, n, m, cfg, B, target, draws):
    """The generation loop as it was before the generation body: new tensors
    every generation, the history stacked at the end."""
    M = codes.shape[1]
    D = codes.shape[0] // N
    I, phi = cfg.num_islands, cfg.phi
    G = D * I
    dev = codes.device
    entropy = cfg.measure == "entropy"
    parts = [slice(d * N, (d + 1) * N) for d in range(D)]
    if entropy:
        f_refs = [full_column_entropy(codes[p], B).mean() for p in parts]
    else:
        measure_fn = MEASURES[cfg.measure]
        f_refs = [measure_fn(values[p]) for p in parts]
    if D == 1:
        f_ref = f_cand = f_refs[0]
        offset = None
    else:
        f_ref = torch.stack(f_refs)
        f_cand = f_ref[:, None, None].expand(D, I, phi).reshape(G, phi)
        offset = (torch.arange(D, device=dev, dtype=torch.int32) * N)[:, None].expand(
            D, I).reshape(G, 1)

    def in_table(idx):
        if offset is None:
            return idx
        return idx + offset.reshape((G,) + (1,) * (idx.dim() - 1))

    def pop_counts(rows):
        return T.population_histogram_rows(codes, in_table(rows).reshape(-1, n), B).reshape(
            G, phi, M, B)

    def fitness(rows, cols, counts, applied, old_codes, new_codes):
        if not entropy:
            return None, -(measure_fn(values, in_table(rows), cols) - f_cand).abs()
        return T.fused_delta_fitness(counts, old_codes, new_codes, applied, cols, f_cand)

    def best_of(fit, rows, cols):
        flat = fit.reshape(D, I * phi)
        g = flat.argmax(1, keepdim=True)
        return (flat.gather(1, g)[:, 0],
                rows.reshape(D, I * phi, n).gather(1, g[..., None].expand(D, 1, n))[:, 0],
                cols.reshape(D, I * phi, M).gather(1, g[..., None].expand(D, 1, M))[:, 0])

    no_delta = torch.zeros((G, phi), dtype=torch.float32, device=dev)
    rows, cols = T._init_population(draws.init(I, phi, N, M, n), N, M, n, m, target)
    counts = pop_counts(rows) if entropy else None
    zero_codes = torch.zeros((G, phi, M), dtype=torch.int32, device=dev)
    counts, fit0 = fitness(rows, cols, counts, no_delta, zero_codes, zero_codes)
    best_f, best_r, best_c = best_of(fit0, rows, cols)
    op_kw = dict(N=N, M=M, n=n, m=m, p_rc=cfg.p_rc, target=target)
    k_mig = max(1, int(round(cfg.migrate_frac * phi)))
    n_drawn = phi - T._n_elite(phi, cfg.alpha)
    history = []
    for gen_idx in range(cfg.psi):
        g = draws.generation()
        rows1, cols1, applied, old_vals, fresh = T._mutate_core(
            g.mutate(I, phi, N, M, n), rows, cols, xi=cfg.xi, **op_kw)
        if gen_idx % cfg.cross_every == 0:
            rows2, cols2 = T._crossover(g.cross(I, phi, N, M, n, m), rows1, cols1, **op_kw)
            counts_b = pop_counts(rows2) if entropy else None
            app = no_delta
        elif not entropy:
            rows2, cols2, counts_b, app = rows1, cols1, None, no_delta
        elif cfg.incremental:
            rows2, cols2, counts_b, app = rows1, cols1, counts, applied.to(torch.float32)
        else:
            rows2, cols2, counts_b, app = rows1, cols1, pop_counts(rows1), no_delta
        counts2, fit = fitness(rows2, cols2, counts_b, app,
                               codes[in_table(old_vals).long()], codes[in_table(fresh).long()])
        f_best, r_best, c_best = best_of(fit, rows2, cols2)
        better = f_best > best_f
        best_f = torch.where(better, f_best, best_f)
        best_r = torch.where(better[:, None], r_best, best_r)
        best_c = torch.where(better[:, None], c_best, best_c)
        if I > 1 and (gen_idx + 1) % cfg.migrate_every == 0:
            rows2, cols2, counts2, fit = T._ring_migrate(rows2, cols2, counts2, fit, k=k_mig,
                                                         groups=D)
        keep = T._select_idx(fit, g.select(T._selection_probs(fit), n_drawn), alpha=cfg.alpha)
        rows, cols = T._gather_cands(rows2, keep), T._gather_cands(cols2, keep)
        counts = None if counts2 is None else T._gather_cands(counts2, keep)
        history.append(best_f)
    hist = torch.stack(history, dim=1) if history else torch.zeros((D, 0), device=dev)
    return best_r, best_c, best_f, hist, f_ref.reshape(D)


def _small_coded(seed):
    """400 rows of six coded columns and a binary target, on the CPU."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([rng.integers(0, k, 400) for k in (3, 5, 17, 2, 40, 7)]).astype(float)
    return factorize(X, rng.integers(0, 2, 400).astype(float), device="cpu")


CPU_CFGS = {
    "paper": GenDSTConfig(psi=6, phi=16),
    "cross_every_2": GenDSTConfig(psi=7, phi=16, cross_every=2),
    "recompute": GenDSTConfig(psi=6, phi=16, cross_every=3, incremental=False),
    "islands": GenDSTConfig(psi=7, phi=16, num_islands=3, migrate_every=2),
    "pnorm": GenDSTConfig(psi=5, phi=16, cross_every=2, measure="pnorm"),
    "no_generation": GenDSTConfig(psi=0, phi=16),
}


@pytest.mark.parametrize("batch", [1, 2], ids=["solo", "batch_of_2"])
@pytest.mark.parametrize("name", list(CPU_CFGS))
def test_eager_search_equals_the_old_loop_on_cpu(name, batch):
    cfg = CPU_CFGS[name]
    codeds = [_small_coded(s) for s in range(batch)]
    c0, n, m = codeds[0], 20, 3
    seeds = [5 + s for s in range(batch)]
    stacked = T._StackedDraws([TorchDraws(make_generator(s), "cpu") for s in seeds],
                              cfg.num_islands)
    want = _loop_gen_dst(torch.cat([c.codes for c in codeds]),
                         torch.cat([c.values for c in codeds]), c0.num_rows, n, m, cfg,
                         c0.max_bins, c0.target_col, stacked)
    if batch == 1:
        got = [gen_dst(make_generator(seeds[0]), c0, n, m, cfg, device="cpu")]
    else:
        got = gen_dst_batch([make_generator(s) for s in seeds], codeds, n, m, cfg, device="cpu")
    for d, res in enumerate(got):
        for field, a, b in zip(res._fields, res, want):
            assert a.dtype == b.dtype and torch.equal(a, b[d]), (field, a, b[d])
    assert tuple(got[0].history.shape) == (cfg.psi,)


@pytest.mark.parametrize("name", ["paper", "cross_every_2", "islands", "pnorm"])
def test_cpu_generation_spans_carry_gen_graphed_zero(name):
    cfg = CPU_CFGS[name]
    sink = []
    with trace.collect(sink):
        gen_dst(make_generator(3), _small_coded(0), 20, 3, cfg, device="cpu")
    gens = [sp for sp in sink if sp["name"] == "gen_dst.generation"]
    assert [sp["attrs"] for sp in gens] == [{"gen": g, "gen_graphed": 0}
                                            for g in range(cfg.psi)]


def test_graph_generators_choose_the_eager_loop_on_cpu():
    cfg = GenDSTConfig()
    draws = TorchDraws(make_generator(0), "cpu")
    assert T._graph_generators(cfg, torch.device("cpu"), draws) is None
    assert T._graph_generators(cfg, torch.device("cpu"), T._StackedDraws([draws], 1)) is None


# ---------------------------------------------------------------------------
# the card: the graph path against the eager loop
# ---------------------------------------------------------------------------


class _Forward:
    """A draw provider that forwards every draw to a ``TorchDraws`` on the
    same generator: the same draws in the same order, through a provider the
    graph path does not take, so the search runs its eager loop."""

    def __init__(self, gen, device):
        self.inner = TorchDraws(gen, device)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def generation(self):
        return self


def _kinds(cfg):
    """The generation kinds of ``cfg``'s schedule: (crosses, migrates)."""
    return {(g % cfg.cross_every == 0, cfg.num_islands > 1 and (g + 1) % cfg.migrate_every == 0)
            for g in range(cfg.psi)}


def _graphed_count(fn):
    """``fn()``'s result and the sum of ``gen_graphed`` over its spans."""
    sink = []
    with trace.collect(sink):
        out = fn()
    torch.cuda.synchronize()
    gens = [sp["attrs"]["gen_graphed"] for sp in sink if sp["name"] == "gen_dst.generation"]
    return out, sum(gens), len(gens)


def _assert_equal(a, b):
    for field, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), (field, x, y)


def _d1_train(name="D1", seed=None):
    import dataclasses
    from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
    spec = PAPER_DATASETS[name]
    if seed is not None:
        spec = dataclasses.replace(spec, seed=seed)
    return train_test_split(*make_dataset(spec, scale=1.0))[:2]


def _zipf_sizes(n_rows, partitions=8, s=1.0):
    """The many-models cell's partition sizes: Zipf shares of the rows."""
    w = 1.0 / np.arange(1, partitions + 1, dtype=np.float64) ** s
    sizes = np.floor(n_rows * w / w.sum() + 0.5).astype(np.int64)
    sizes[0] += n_rows - sizes.sum()
    return [int(v) for v in sizes]


@pytest.fixture(scope="module")
def tables():
    """The training tables of the cases, factorized on the card: D1 and D6
    in full, the many-models cell's largest and smallest D1 partitions."""
    skip_without_cuda()
    X1, y1 = _d1_train("D1")
    sizes = _zipf_sizes(len(y1))
    assert (sizes[0], sizes[-1]) == (38230, 4779)
    return {"d1": factorize(X1, y1, device="cuda"),
            "d6": factorize(*_d1_train("D6"), device="cuda"),
            "mm_largest": factorize(X1[:sizes[0]], y1[:sizes[0]], device="cuda"),
            "mm_smallest": factorize(X1[-sizes[-1]:], y1[-sizes[-1]:], device="cuda")}


CARD_CASES = {
    "d1": ("d1", GenDSTConfig()),
    "d6": ("d6", GenDSTConfig()),
    "mm_largest": ("mm_largest", GenDSTConfig()),
    "mm_smallest": ("mm_smallest", GenDSTConfig()),
    # the gen_dst_islands strategy's configuration
    "islands": ("d1", GenDSTConfig(num_islands=4, migrate_every=5)),
    "cross_every_2": ("d1", GenDSTConfig(cross_every=2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_graphed_search_equals_the_eager_loop_on_card(tables, case):
    skip_without_cuda()
    table, cfg = CARD_CASES[case]
    coded = tables[table]
    graphed, n_graphed, n_gens = _graphed_count(
        lambda: gen_dst(make_generator(11, "cuda"), coded, cfg=cfg, device="cuda"))
    eager, n_eager, _ = _graphed_count(
        lambda: gen_dst(None, coded, cfg=cfg, device="cuda",
                        draws=_Forward(make_generator(11, "cuda"), "cuda")))
    assert n_gens == cfg.psi
    assert (n_graphed, n_eager) == (cfg.psi - len(_kinds(cfg)), 0)
    _assert_equal(graphed, eager)


@pytest.mark.cuda
def test_graphed_batch_equals_the_eager_loop_on_card(tables):
    """A four-dataset ``gen_dst_batch``: D1 and three copies of its spec with
    other dataset seeds."""
    skip_without_cuda()
    codeds = [tables["d1"]] + [factorize(*_d1_train("D1", s), device="cuda")
                               for s in (11, 12, 13)]
    seeds, cfg = (0, 1, 2, 3), GenDSTConfig()
    graphed, n_graphed, _ = _graphed_count(
        lambda: gen_dst_batch([make_generator(s, "cuda") for s in seeds], codeds, cfg=cfg,
                              device="cuda"))
    eager, n_eager, _ = _graphed_count(
        lambda: gen_dst_batch([None] * 4, codeds, cfg=cfg, device="cuda",
                              draws=[_Forward(make_generator(s, "cuda"), "cuda") for s in seeds]))
    assert (n_graphed, n_eager) == (cfg.psi - 1, 0)
    for a, b in zip(graphed, eager):
        _assert_equal(a, b)


@pytest.mark.cuda
def test_graphed_search_has_no_host_sync_on_card(tables):
    skip_without_cuda()
    with no_host_sync():
        _, n_graphed, _ = _graphed_count(
            lambda: gen_dst(make_generator(3, "cuda"), tables["d1"], device="cuda"))
    assert n_graphed == GenDSTConfig().psi - 1


@pytest.mark.cuda
def test_graphed_search_replays_psi_minus_one_generations_on_card(tables):
    """At the paper's defaults: generation 0 eager, the other 29 replayed;
    below ``GEN_DST_GRAPH_MIN_GENS``, from a CPU generator and through
    another provider, none."""
    skip_without_cuda()
    coded, cfg = tables["d6"], GenDSTConfig()
    runs = {
        "paper": (lambda: gen_dst(make_generator(4, "cuda"), coded, cfg=cfg, device="cuda"),
                  cfg.psi - 1),
        "short": (lambda: gen_dst(make_generator(4, "cuda"), coded, device="cuda",
                                  cfg=cfg._replace(psi=T.GEN_DST_GRAPH_MIN_GENS - 1)), 0),
        "cpu_generator": (lambda: gen_dst(make_generator(4), coded, cfg=cfg, device="cuda"), 0),
        "forwarded": (lambda: gen_dst(None, coded, cfg=cfg, device="cuda",
                                      draws=_Forward(make_generator(4, "cuda"), "cuda")), 0),
    }
    got = {name: _graphed_count(fn)[1] for name, (fn, _) in runs.items()}
    assert got == {name: want for name, (_, want) in runs.items()}


@pytest.mark.cuda
def test_graphed_search_counts_each_kernel_psi_plus_one_times_on_card(tables):
    """The initial population's launch and one a generation, whether the
    generation ran eagerly or from a replay; the capture counts none."""
    skip_without_cuda()
    cfg = GenDSTConfig()
    K.reset_launch_counts()
    gen_dst(make_generator(5, "cuda"), tables["d1"], cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    assert launches["masked_histogram"] == launches["fused_delta_fitness"] == cfg.psi + 1
