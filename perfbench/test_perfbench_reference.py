"""CPU tests of the comparison that decides ``correct``: the reference agrees
with the port run with ``device="cpu"`` on tiny tables, and the control (the
reference in the precision below the configuration's, in the program's
place) comes out not correct."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

from pbcore import compare, reference, tables   # noqa: E402
from pbcore.cell import readings, run_cell       # noqa: E402
from pbcore.spec import Cell                     # noqa: E402

ROWS = 600   # a table a test run can hold; every other size is the cell's


def small_cell(name: str) -> Cell:
    cell = Cell(ROOT, name)
    cell.mix["n_rows"] = ROWS
    return cell


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the test suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def plan_module(monkeypatch):
    """The port's plan module, its ``factorize`` restored after the test
    (the execute adapter wraps it)."""
    import importlib
    mod = importlib.import_module("repro_torch.core.plan")
    monkeypatch.setattr(mod, "factorize", mod.factorize)
    return mod


@pytest.mark.parametrize("name", ["substrat.d1", "automl.d6"])
def test_port_on_cpu_is_correct(name, plan_module):
    out = run_cell(small_cell(name), 2 ** 31 + 12345, 0.5, False, "cpu", time.time(),
                   log=lambda m: None)
    assert out["correct"], out["checked"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "job_s", "test_acc"}


def test_reference_codes_and_fitness_match_the_port():
    from repro_torch.core.gen_dst import _entropy_fitness
    from repro_torch.core.measures import factorize, full_column_entropy
    mix = small_cell("automl.d6").mix
    t = tables.make_table(mix)
    coded = factorize(t.X_tr, t.y_tr, device="cpu")
    codes, n_bins, target, B = reference.factorize(t.X_tr, t.y_tr)
    assert np.array_equal(codes, coded.codes.numpy()) and B == coded.max_bins
    assert np.array_equal(n_bins, coded.n_bins.numpy()) and target == coded.target_col
    rng = np.random.default_rng(0)
    rows = rng.choice(len(t.y_tr), 24, replace=False)
    mask = np.zeros(codes.shape[1], bool)
    mask[[1, 4, target]] = True
    f_ref = full_column_entropy(coded.codes, B).mean()
    port = _entropy_fitness(coded.codes, B, f_ref, torch.as_tensor(rows[None], dtype=torch.int32),
                            torch.as_tensor(mask[None]))
    assert abs(float(port[0]) - reference.dst_fitness(codes, B, rows, mask)) < 1e-6


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -10 - 2 ** -12])
    assert reference.to_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -1.0 - 2 ** -10]


def _control_readings(name):
    cell = small_cell(name)
    return cell, readings(cell, [2 ** 31 + 3, 11], 0.5, "cpu", True, jobs=1, log=lambda r: None)


@pytest.mark.parametrize("name", ["substrat.d1", "automl.d6"])
def test_control_is_not_correct(name, plan_module):
    cell, rows = _control_readings(name)
    sound, _, _ = compare.verdict([r["program"] for r in rows], cell.limits)
    ctl, _, fails = compare.verdict([r["control"] for r in rows], cell.limits)
    assert sound and not ctl and fails


def test_control_separates_automl_d1(plan_module):
    """automl.d1's control fails its Adam-trained trials' row gaps on the card
    (a dozen rows over a run's six jobs of 20,780 validation rows each); a
    test-size table has too few validation rows for that count, so here the
    control is held to reading far from the program on the winner's
    parameters."""
    cell, rows = _control_readings("automl.d1")
    sound, _, _ = compare.verdict([r["program"] for r in rows], cell.limits)
    prog = max(r["program"]["winner_gap"] for r in rows)
    ctl = min(r["control"]["winner_gap"] for r in rows)
    assert sound and ctl > 20 * max(prog, 1e-7)
