"""The tabular path on a card: Gen-DST, ``execute``, the AutoML backends and
the other subset strategies, against the CPU and against plain
recomputations.

* Gen-DST on the card (kernels) = on the CPU (plain versions) from the same
  draws; the generation loop under ``torch.cuda.set_sync_debug_mode
  ("error")``.
* ``execute(plan("gen_dst"))`` on D1 at full scale: both Gen-DST kernels'
  launch counters rise, the batched backend runs both passes, the DST
  fitness matches a plain recomputation, the subset has the paper's shape.
* The batched rung on the card = on the CPU, and its one host sync; on D1's
  sub-AutoML input the batched rung against the loop backend, hetero and
  mixed-step merges against solo runs, a time budget that stops between
  sub-batches.
* Every other strategy: card = CPU at a small size, at D1 with its fitness
  recomputed and no host sync; every registered strategy through
  ``execute``; ``gen_dst_batch`` on four D1-sized tables bit-equal to its
  solo runs.

Every case is marked ``cuda`` and skips without a card.  No JAX:

    python -m pytest -q -m cuda tests/test_torch_tabular_card.py

Tolerances: subsets equal; fitness within 1e-6 (float64 entropy sums, one
float32 rounding); per-trial validation accuracy within 2/N_val between
backends, devices and merges (float32 trajectories summed in another order
may flip a prediction near the decision boundary; ``tests/test_torch_automl.py``).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from _card import finite_acc, no_host_sync, plain_fitness, requires_cuda, skip_without_cuda
from _port_cases import AUTOML_CFG, automl_table
from repro_torch import kernels as K
from repro_torch.automl import batched as TB
from repro_torch.automl import engine as TE
from repro_torch.core.gen_dst import GenDSTConfig, TorchDraws, gen_dst, gen_dst_batch
from repro_torch.core.measures import factorize
from repro_torch.core.plan import execute, plan
from repro_torch.device import make_generator

pytestmark = requires_cuda

FIT_TOL = 1e-6
AUTOML_TOL_ROWS = 2
# the paper's baselines and asp_proxy
NEW_STRATEGIES = ("mc", "mab", "greedy_seq", "greedy_mult", "km", "ig_rand", "ig_km",
                  "asp_proxy")


def _small_table():
    """800 rows of six coded columns and a binary target."""
    rng = np.random.default_rng(0)
    X = np.column_stack([rng.integers(0, k, 800) for k in (3, 5, 17, 2, 40, 7)]).astype(float)
    return X, rng.integers(0, 2, 800).astype(float)


def _d1_split(seed=None):
    from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
    spec = PAPER_DATASETS["D1"]
    if seed is not None:
        spec = dataclasses.replace(spec, seed=seed)
    return train_test_split(*make_dataset(spec, scale=1.0))


@pytest.fixture(scope="module")
def d1():
    """D1 at full scale: its split and its training table factorized on the
    card."""
    skip_without_cuda()
    X_tr, y_tr, X_te, y_te = _d1_split()
    return X_tr, y_tr, X_te, y_te, factorize(X_tr, y_tr, device="cuda")


@pytest.fixture(scope="module")
def main_path(d1):
    """``execute(plan("gen_dst"))`` on D1 at the paper's defaults, with both
    Gen-DST kernels' launches counted from zero."""
    X_tr, y_tr, X_te, y_te, _ = d1
    K.reset_launch_counts()
    result = execute(plan("gen_dst"), X_tr, y_tr, X_test=X_te, y_test=y_te, seed=0,
                     device="cuda")
    torch.cuda.synchronize()
    return result, K.launch_counts()


def _assert_trials_close(got, ref, n_val, tol_rows=AUTOML_TOL_ROWS):
    """Two rung outputs ((spec, accuracy, ...) per trial, positions): equal
    trials and positions, each accuracy within ``tol_rows`` / N_val."""
    (scored_g, pos_g), (scored_r, pos_r) = got, ref
    assert list(pos_g) == list(pos_r)
    assert [s[0] for s in scored_g] == [s[0] for s in scored_r]
    for a, b in zip(scored_g, scored_r):
        assert abs(a[1] - b[1]) <= tol_rows / n_val + 1e-9, (a[0], a[1], b[1])


# ---------------------------------------------------------------------------
# Gen-DST and the main path
# ---------------------------------------------------------------------------


def test_gen_dst_card_equals_cpu_from_the_same_draws():
    skip_without_cuda()
    Xs, ys = _small_table()
    res = {}
    for d in ("cuda", "cpu"):
        draws = TorchDraws(make_generator(7), d)       # the same CPU draws for both
        r = gen_dst(None, factorize(Xs, ys, device=d), 28, 3, GenDSTConfig(psi=6, phi=16),
                    device=d, draws=draws)
        res[d] = (r.row_idx.cpu(), r.col_mask.cpu(), float(r.fitness))
    assert torch.equal(res["cuda"][0], res["cpu"][0])
    assert torch.equal(res["cuda"][1], res["cpu"][1])
    assert abs(res["cuda"][2] - res["cpu"][2]) <= FIT_TOL


def test_gen_dst_generation_loop_has_no_host_sync(d1):
    """A search at D1's full size: no operation of the generation loop waits
    for the host."""
    skip_without_cuda()
    coded = d1[4]
    with no_host_sync():
        gen_dst(make_generator(3, "cuda"), coded, device="cuda")


def test_execute_launches_both_kernels_and_its_fitness_is_plain(d1, main_path):
    skip_without_cuda()
    coded = d1[4]
    result, launches = main_path
    assert result.intermediate.backend == result.final.backend == "batched"
    assert launches["masked_histogram"] > 0 and launches["fused_delta_fitness"] > 0
    f_plain = plain_fitness(coded, result.row_idx, result.col_idx)
    assert math.isfinite(result.dst_fitness)
    assert abs(result.dst_fitness - f_plain) <= FIT_TOL
    assert finite_acc(result.final.test_acc)
    N, M = coded.codes.shape
    n_cols = len({int(c) for c in result.col_idx} | {int(coded.target_col)})
    assert (len(result.row_idx), n_cols) == (round(N ** 0.5), round(0.25 * M))


# ---------------------------------------------------------------------------
# the AutoML backends
# ---------------------------------------------------------------------------


def test_batched_rung_on_card_matches_cpu():
    skip_without_cuda()
    X, y, _, _ = automl_table()
    outs, states = {}, {}
    for dev in ("cuda", "cpu"):
        st = states[dev] = TE.search_init(X, y, config=TE.AutoMLConfig(**AUTOML_CFG), device=dev)
        cohort, tids, epochs, _ = TE.search_cohort(st)
        outs[dev] = TB.eval_rung_batched(cohort, tids, 0, epochs, st.ctx, st.out_of_budget)
    _assert_trials_close(outs["cuda"], outs["cpu"], len(states["cpu"].ctx["y_val"]))
    params = outs["cuda"][0][0][2]()
    from repro_torch.automl import models as TM
    assert all(x.is_cuda for x in TM._leaves(params))


def test_batched_rung_has_no_host_sync_on_card():
    skip_without_cuda()
    X, y, _, _ = automl_table()
    st = TE.search_init(X, y, config=TE.AutoMLConfig(**AUTOML_CFG), device="cuda")
    cohort, tids, epochs, _ = TE.search_cohort(st)
    d, c = st.ctx["X_tr"].shape[1], st.ctx["n_classes"]
    trials, variants, subbatches, common = TB._rung_inputs(cohort, tids, 0, epochs, st.ctx)
    with no_host_sync():
        evaluated = TB._run_subbatches(subbatches, common, c, d, epochs)
    results = TB._unpack_results(evaluated, trials, variants, False)
    assert sorted(results) == list(range(len(cohort)))


@pytest.fixture(scope="module")
def sub_input(d1, main_path):
    """The sub-AutoML's input exactly as ``execute(seed=0)`` built it."""
    from repro_torch.core.substrat import build_subset
    X_tr, y_tr = d1[:2]
    result = main_path[0]
    return build_subset(X_tr, y_tr, result.row_idx, result.col_idx, make_generator(0 ^ 0x5AB5))


def test_rung_zero_batched_equals_loop_on_d1_subset(sub_input):
    """Rung 0 of D1's sub-AutoML (24 sampled specs on the subset) through
    both backends, and the batched rung under sync-debug "error" from its
    inputs on the card to its one copy back, equal to the first."""
    skip_without_cuda()
    st = TE.search_init(*sub_input, config=TE.AutoMLConfig(), device="cuda")
    cohort, tids, epochs, _ = TE.search_cohort(st)
    n_val = len(st.ctx["y_val"])
    bat = TB.eval_rung_batched(cohort, tids, 0, epochs, st.ctx, st.out_of_budget, True)
    loop = TE._eval_rung_loop(cohort, tids, 0, epochs, st.ctx, st.out_of_budget, True)
    _assert_trials_close(bat, loop, n_val)
    trials, variants, subbatches, common = TB._rung_inputs(cohort, tids, 0, epochs, st.ctx)
    d, c = st.ctx["X_tr"].shape[1], st.ctx["n_classes"]
    with no_host_sync():
        evaluated = TB._run_subbatches(subbatches, common, c, d, epochs)
    again = TB._unpack_results(evaluated, trials, variants, False)
    assert all(again[i][0] == bat[0][i][1] for i in range(len(cohort)))


def test_hetero_merge_and_megabatch_match_solo_on_card(d1, sub_input):
    """Job A (D1's subset) with job B (601 rows of all 22 features, another
    seed): ``eval_rung_cohorts`` against each cohort run solo, then
    ``eval_trial_megabatch`` with job A one rung ahead (mixed steps)."""
    skip_without_cuda()
    X_tr, y_tr = d1[:2]
    st = TE.search_init(*sub_input, config=TE.AutoMLConfig(), device="cuda")
    cohort, tids, epochs, _ = TE.search_cohort(st)
    soloA = TB.eval_rung_batched(cohort, tids, 0, epochs, st.ctx, st.out_of_budget, False)
    stB = TE.search_init(X_tr[:601], y_tr[:601], config=TE.AutoMLConfig(seed=1), device="cuda")
    cohortB, tidsB, epochsB, _ = TE.search_cohort(stB)
    soloB = TB.eval_rung_batched(cohortB, tidsB, 0, epochsB, stB.ctx, stB.out_of_budget, False)
    nA, nB = len(st.ctx["y_val"]), len(stB.ctx["y_val"])
    mA, mB = TB.eval_rung_cohorts([TE.search_trial_cohort(st), TE.search_trial_cohort(stB)])
    _assert_trials_close(mA, soloA, nA)
    _assert_trials_close(mB, soloB, nB)
    TE.search_eval_rung(st)                               # job A one rung ahead
    tcA, tcB = TE.search_trial_cohort(st), TE.search_trial_cohort(stB)
    soloA1 = TB.eval_rung_batched(tcA.specs, tcA.tids, tcA.rung_i, tcA.epochs, st.ctx,
                                  st.out_of_budget, False)
    gA, gB = TB.eval_trial_megabatch([tcA, tcB])
    _assert_trials_close(gA, soloA1, nA)
    _assert_trials_close(gB, soloB, nB)


def test_time_budget_stops_between_subbatches_on_card(sub_input):
    """A budget spent at once stops rung 0 after its first sub-batch."""
    skip_without_cuda()
    st = TE.search_init(*sub_input, config=TE.AutoMLConfig(), device="cuda")
    cohort, tids, epochs, _ = TE.search_cohort(st)
    first = len(TB._rung_inputs(cohort, tids, 0, epochs, st.ctx)[2][0][0])
    stD = TE.search_init(*sub_input, config=TE.AutoMLConfig(time_budget_s=1e-9), device="cuda")
    TE.search_eval_rung(stD)
    res = TE.search_result(stD)
    assert stD.stopped and 1 <= res.n_trials == first < len(cohort)


# ---------------------------------------------------------------------------
# the other subset strategies
# ---------------------------------------------------------------------------


def _small_strategy(name, coded, device, draws):
    """``name`` at a small size with the options of a quick search."""
    from repro_torch.core import baselines as BL
    from repro_torch.core.strategies import asp_proxy_dst
    fn, opts = {
        "mc": (BL.mc_dst, dict(budget=60, batch=20)),
        "mab": (BL.mab_dst, dict(rounds=30)),
        "greedy_seq": (BL.greedy_seq_dst, dict(pool=16)),
        "greedy_mult": (BL.greedy_mult_dst, dict(pool=16)),
        "km": (BL.km_dst, {}),
        "ig_rand": (BL.ig_rand_dst, {}),
        "ig_km": (BL.ig_km_dst, {}),
        "asp_proxy": (asp_proxy_dst, {}),
    }[name]
    return fn(None, coded, 20, 3, device=device, draws=draws, **opts)


@pytest.mark.parametrize("name", NEW_STRATEGIES)
def test_strategy_card_equals_cpu_at_a_small_size(name):
    """The card (kernels) against the CPU (plain versions) from the same CPU
    draws: the same subset, or at a fitness near-tie one whose fitness is
    within 1e-6."""
    skip_without_cuda()
    Xs, ys = _small_table()
    res = {}
    for d in ("cuda", "cpu"):
        r = _small_strategy(name, factorize(Xs, ys, device=d), d, TorchDraws(make_generator(7), d))
        res[d] = float(r.fitness)
    assert abs(res["cuda"] - res["cpu"]) <= FIT_TOL


@pytest.mark.parametrize("name", NEW_STRATEGIES)
def test_strategy_at_d1(d1, name):
    """Each strategy at D1 with the reference's default options: its fitness
    against a plain recomputation, mc through both Gen-DST kernels, and
    (all but ``asp_proxy``, host numpy by design) no host sync inside the
    search."""
    skip_without_cuda()
    from repro_torch.core.strategies import get_strategy, run_strategy
    coded = d1[4]
    K.reset_launch_counts()
    sub = run_strategy(name, make_generator(0, "cuda"), coded, None, None)
    launches = K.launch_counts()
    assert math.isfinite(sub.fitness)
    assert abs(sub.fitness - plain_fitness(coded, sub.row_idx, sub.col_mask)) <= FIT_TOL
    if name == "mc":
        assert launches["masked_histogram"] > 0 and launches["fused_delta_fitness"] > 0
    if name != "asp_proxy":
        fn = get_strategy(name).fn
        with no_host_sync():
            fn(make_generator(0, "cuda"), coded, None, None)


def test_every_strategy_through_execute(d1):
    skip_without_cuda()
    from repro_torch.core.strategies import available_strategies
    X_tr, y_tr, X_te, y_te, coded = d1
    for name in available_strategies():
        r = execute(plan(name), X_tr, y_tr, X_test=X_te, y_test=y_te, seed=0, device="cuda")
        assert finite_acc(r.final.test_acc), name
        if name != "random":
            assert abs(r.dst_fitness - plain_fitness(coded, r.row_idx, r.col_idx)) <= FIT_TOL, name


def test_gen_dst_batch_equals_its_solo_runs(d1):
    """D1 and three copies of its spec with other dataset seeds: each result
    bit-equal to its solo run, B1 and B2 launched once per generation (and
    once for the initial population) for all four, no host sync."""
    skip_without_cuda()
    codeds = [d1[4]] + [factorize(*_d1_split(s)[:2], device="cuda") for s in (11, 12, 13)]
    assert len({(c.codes.shape, c.max_bins, c.target_col) for c in codeds}) == 1
    cfg, seeds = GenDSTConfig(), (0, 1, 2, 3)
    solos = [gen_dst(make_generator(s, "cuda"), c, cfg=cfg, device="cuda")
             for s, c in zip(seeds, codeds)]

    def batch_run():
        return gen_dst_batch([make_generator(s, "cuda") for s in seeds], codeds, cfg=cfg,
                             device="cuda")
    K.reset_launch_counts()
    batch = batch_run()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    for a, b in zip(solos, batch):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert launches["masked_histogram"] == launches["fused_delta_fitness"] == cfg.psi + 1
    with no_host_sync():
        batch_run()
