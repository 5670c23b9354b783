"""CPU tests of the ``serve_round`` entry (``manymodels.d1``): a round of Zipf
partitions served through ``SubStratServer`` is correct against the plain
reference and its control is not; served alone (no padded merge) every
partition answers as a solo ``execute`` of it, bit for bit; the readers the
cell lists read a recorded round, and the ``round_*`` readers read None
where a program records no such span."""
import copy
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

from pbcore import compare, tables                # noqa: E402
from pbcore.cell import readings, run_cell        # noqa: E402
from pbcore.spec import Cell, load_module         # noqa: E402

ROWS, PARTITIONS = 1500, 4   # a round a test can hold: 4 partitions of 576..144 rows
SEED = 2 ** 31 + 12345
SCHED_READERS = ("round_jobs_per_dispatch", "round_pad_waste", "round_dst_batched_share")
READERS = ("round_automl_s",) + SCHED_READERS
# readers of the other cells that read a round as one job
SHARED_READERS = ("job_mfu", "device_idle", "device_ops_per_job", "factorize_s", "gen_dst_s",
                  "factorize_host_s", "factorize_copy_s", "gen_dst_gen_s", "gen_dst_to_host_s",
                  "gen_dst_ops_per_gen")


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py").read


def small_cell(**server) -> Cell:
    cell = Cell(ROOT, "manymodels.d1")
    cell.mix["n_rows"] = ROWS
    cell.config = copy.deepcopy(cell.config)
    cell.config["deployment"]["partitions"] = PARTITIONS
    cell.config["server"].update(server)
    return cell


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the test suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def wrapped_factorize(monkeypatch):
    """The plan's and the scheduler's ``factorize``, restored after each
    test (the entries wrap them)."""
    import importlib
    for name in ("repro_torch.core.plan", "repro_torch.service.scheduler"):
        mod = importlib.import_module(name)
        monkeypatch.setattr(mod, "factorize", mod.factorize)


def one_round(cell):
    """(entry, table, X, y, seed, record) of pool entry 0 served as one round."""
    table = tables.make_table(cell.mix)
    entry = cell.entry_module().Entry(cell.config, table, torch.device("cpu"))
    perm, seed = tables.pool_input(cell.mix, 0, len(table.y_tr))
    X, y = table.X_tr[perm], table.y_tr[perm]
    return entry, table, X, y, seed, entry.job(X, y, table.X_te, table.y_te, seed, keep=True)


def test_partition_sizes_are_zipf_shares_of_d1():
    mod = load_module(HERE / "entries" / "serve_round.py")
    assert mod.partition_sizes(103904, 8, 1.0) == [38230, 19115, 12743, 9558, 7646, 6372,
                                                   5461, 4779]
    assert sum(mod.partition_sizes(1201, 4, 1.0)) == 1201


def test_round_on_cpu_is_correct():
    out = run_cell(small_cell(), SEED, 0.5, False, "cpu", time.time(), log=lambda m: None)
    assert out["correct"], out["checked"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "job_s", "test_acc"}


def test_control_is_not_correct():
    cell = small_cell()
    rows = readings(cell, [SEED, 11], 0.5, "cpu", True, jobs=1, log=lambda r: None)
    sound, _, _ = compare.verdict([r["program"] for r in rows], cell.limits)
    ctl, _, fails = compare.verdict([r["control"] for r in rows], cell.limits)
    assert sound and not ctl and fails


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [torch.as_tensor(tree)]


def test_partitions_served_without_padded_merges_equal_solo_execute():
    from repro_torch.core.plan import execute
    entry, table, X, y, seed, rec = one_round(small_cell(hetero_merge=False))
    answers = entry.answers(rec)
    for i, (Xk, yk, sk) in enumerate(entry.split(X, y, seed)):
        solo = execute(entry.parts[i].plan, Xk, yk, seed=sk, X_test=table.X_te,
                       y_test=table.y_te, device="cpu")
        want = compare.pass_answers(solo.intermediate), compare.pass_answers(solo.final)
        got = answers[i]
        assert np.array_equal(got["rows"], solo.row_idx)
        assert np.array_equal(got["cols"], solo.col_idx)
        assert got["fitness"] == solo.dst_fitness
        for have, ref in zip((got["sub"], got["ft"]), want):
            for key in ("trials", "winner", "val_acc", "test_acc"):
                assert have[key] == ref[key], (i, key)
            a, b = _leaves(have["params"]), _leaves(ref["params"])
            assert len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.fixture(scope="module")
def recorded():
    """One served round at the cell's server settings, as a window of one."""
    import importlib
    mods = [importlib.import_module(n) for n in ("repro_torch.core.plan",
                                                 "repro_torch.service.scheduler")]
    saved = [m.factorize for m in mods]
    try:
        entry, table, X, y, seed, rec = one_round(small_cell())
    finally:
        for m, f in zip(mods, saved):
            m.factorize = f
    return entry, X, y, seed, rec


def _stretch(rec):
    """A traced stretch of the round: one device operation inside each of
    its spans, none between them."""
    from pbcore.profiling import Stretch
    spans = [(sp["name"], sp["t0"] * 1e9, sp["t1"] * 1e9) for sp in rec["spans"]]
    ops = sorted(((name, s, (s + e) / 2) for name, s, e in spans), key=lambda o: o[1])
    lo, hi = min(s for _, s, _ in spans), max(e for _, _, e in spans)
    return Stretch(ops, (lo, hi + 1e9), spans, 1)


def _run(recorded, rec=None, stretch=None):
    entry, X, y, seed, rec0 = recorded
    rec = rec or rec0
    return types.SimpleNamespace(jobs=[{"job": 0, "record": rec,
                                        "phase_s": entry.phase_seconds(rec)}],
                                 window_s=2.0, stretch=stretch, entry=entry,
                                 job_input=lambda j: (X, y, seed))


def test_readers_read_a_recorded_round(recorded):
    run = _run(recorded)
    times = [r.times for r in recorded[4]["results"]]
    assert reader("round_automl_s")(run) == pytest.approx(
        sum(t["automl_sub_s"] + t["fine_tune_s"] for t in times), rel=1e-12)
    # the same seconds as the partitions' own records: a merged dispatch's
    # equal shares add up to its wall time
    assert reader("round_automl_s")(run) == pytest.approx(
        sum(sp["attrs"]["seconds"] for sp in recorded[4]["spans"]
            if sp["name"].startswith(("sub_automl/", "fine_tune/"))), rel=1e-12)
    # every rung of the 4 partitions rode one padded megabatch; no two coded
    # tables share a shape, so every subset search ran alone
    assert reader("round_jobs_per_dispatch")(run) == 4.0
    assert reader("round_pad_waste")(run) > 1.0
    assert reader("round_dst_batched_share")(run) == 0.0


@pytest.mark.parametrize("name", SHARED_READERS)
def test_shared_readers_read_a_recorded_round(recorded, name):
    run = _run(recorded, stretch=_stretch(recorded[4]))
    value = reader(name)(run)
    assert value is not None and value > 0, name
    if name == "factorize_s":
        assert value == pytest.approx(sum(r.times["factorize_s"] for r in recorded[4]["results"]))
    if name == "gen_dst_ops_per_gen":
        assert value == 1.0


def test_readers_arithmetic_on_hand_made_spans(recorded):
    def sp(name, **attrs):
        return {"trace_id": "t", "span_id": f"{name}{sorted(attrs.items())}", "name": name,
                "t0": 0.0, "t1": 1.0, "attrs": attrs}
    rec = {"spans": [sp("sched.dst", searches=8, batched=0),
                     sp("sched.dst", searches=4, batched=3),
                     sp("sched.rungs", jobs=8, dispatches=1, padded_flops=30.0,
                        useful_flops=20.0),
                     sp("sched.rungs", jobs=8, dispatches=2, padded_flops=10.0,
                        useful_flops=10.0)],
           "results": [types.SimpleNamespace(times={"automl_sub_s": 0.125, "fine_tune_s": 1.0}),
                       types.SimpleNamespace(times={"factorize_s": 0.25})]}
    run = _run(recorded, rec)
    assert reader("round_jobs_per_dispatch")(run) == 16 / 3
    assert reader("round_pad_waste")(run) == 40 / 30
    assert reader("round_dst_batched_share")(run) == 3 / 12
    assert reader("round_automl_s")(run) == 1.125


@pytest.mark.parametrize("name", READERS)
def test_readers_read_none_without_their_spans(recorded, name):
    rec = recorded[4]
    # a program without the scheduler's sched.* spans, as the parent's
    no_sched = dict(rec, spans=[s for s in rec["spans"] if not s["name"].startswith("sched.")])
    if name in SCHED_READERS:
        assert reader(name)(_run(recorded, no_sched)) is None
    else:
        # a window with no rounds
        assert reader(name)(types.SimpleNamespace(jobs=[])) is None
