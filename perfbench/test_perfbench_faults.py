"""CPU tests that a run whose timed path is broken underneath comes out not
correct: a training step that returns its state unchanged, half of the batch
left out of the loss, and answers altered where they are produced.  (The
cells run on one card: there is no exchange between chips to leave out.)"""
import importlib
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

from pbcore.cell import run_cell   # noqa: E402
from pbcore.spec import Cell       # noqa: E402

models = importlib.import_module("repro_torch.automl.models")
batched = importlib.import_module("repro_torch.automl.batched")
engine = importlib.import_module("repro_torch.automl.engine")
plan_mod = importlib.import_module("repro_torch.core.plan")


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the test suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name: str) -> dict:
    cell = Cell(ROOT, name)
    cell.mix["n_rows"] = 600
    return run_cell(cell, 2 ** 31 + 77, 0.5, False, "cpu", time.time(), log=lambda m: None)


def step_unchanged(mp):
    def adam_unchanged(loss_fn, params0, lr, epochs, n_steps=None):
        return models._rebuild(params0, [p.detach().clone() for p in models._leaves(params0)])
    mp.setattr(models, "adam_train", adam_unchanged)
    mp.setattr(batched, "adam_train", adam_unchanged)


def half_batch(mp):
    search_init = engine.search_init

    def first_half(*args, **kwargs):
        state = search_init(*args, **kwargs)
        ctx, h = state.ctx, max(1, len(state.ctx["y_tr"]) // 2)
        for key in ("X_tr", "y_tr", "y_tr_t"):
            ctx[key] = ctx[key][:h]
        return state
    mp.setattr(engine, "search_init", first_half)


def fitness_altered(mp):
    run_strategy = plan_mod.run_strategy

    def altered(*args, **kwargs):
        res = run_strategy(*args, **kwargs)
        return type(res)(res.row_idx, res.col_mask, res.fitness + 1e-4, res.strategy, res.time_s)
    mp.setattr(plan_mod, "run_strategy", altered)


def code_altered(mp):
    factorize = plan_mod.factorize

    def altered(*args, **kwargs):
        coded = factorize(*args, **kwargs)
        codes = coded.codes.clone()
        codes[0, 0] = (codes[0, 0] + 1) % coded.n_bins[0]
        return coded._replace(codes=codes)
    mp.setattr(plan_mod, "factorize", altered)


def accuracy_altered(mp):
    accuracy = engine.accuracy

    def altered(params, X, y, family):
        return accuracy(params, X, y, family) - 0.05
    mp.setattr(engine, "accuracy", altered)


def winner_altered(mp):
    search_result = engine.search_result

    def altered(state, X_test=None, y_test=None):
        res = search_result(state, X_test, y_test)
        res.params = {k: (v * 1.01 if isinstance(v, torch.Tensor) else v)
                      for k, v in res.params.items()}
        return res
    mp.setattr(engine, "search_result", altered)


@pytest.mark.parametrize("name,fault", [
    ("substrat.d1", step_unchanged), ("substrat.d1", half_batch),
    ("substrat.d1", fitness_altered), ("substrat.d1", code_altered),
    ("automl.d6", step_unchanged), ("automl.d6", half_batch),
    ("automl.d6", accuracy_altered), ("automl.d6", winner_altered),
])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(plan_mod, "factorize", plan_mod.factorize)
    fault(monkeypatch)
    out = _run(name)
    assert not out["correct"], out["checked"]
