"""The entry points of the JAX package's ``examples/`` through their port
modules, on a card, at the CI's smoke configuration.

* ``launch.quickstart`` three ways (the batched default, ``--backend loop``,
  ``--strategy ig_km``): test accuracies finite in [0, 1].
* ``launch.compare.run_dataset`` on D6 with all nine methods: every accuracy
  finite in [0, 1], each Gen-DST method's DST fitness equal to a plain
  recomputation (1e-6), B1 and B2 launched in SubStrat and SubStrat-NF and
  neither in Full-AutoML.
* The four gates return 0: warm start, metrics, recompile budget, and chaos
  parity between ``serve_tabular --json`` in process and with two workers,
  worker 0 killed.
* ``launch.serve_lm`` (B3 launched, finite logits) and ``launch.train_lm
  --steps 2`` at both presets (B4 launched, finite parameters) in a
  temporary working directory.

Every case is marked ``cuda`` and skips without a card.  No JAX:

    python -m pytest -q -m cuda tests/test_torch_examples_card.py
"""
import pytest
import torch

from _card import finite_acc, plain_fitness, requires_cuda, skip_without_cuda
from repro_torch import kernels as K

pytestmark = requires_cuda

CI_SMOKE = ["--scale", "0.1", "--trials", "4"]


def _counted(fn):
    """``fn()`` with the kernels' launches counted from zero."""
    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, K.launch_counts()


@pytest.mark.parametrize("extra", [[], ["--backend", "loop"], ["--strategy", "ig_km"]],
                         ids=["batched", "loop", "ig_km"])
def test_quickstart_on_card(extra):
    skip_without_cuda()
    from repro_torch.launch import quickstart
    out, launches = _counted(lambda: quickstart.main(CI_SMOKE + extra))
    assert finite_acc(out["full"].test_acc) and finite_acc(out["substrat"].final.test_acc)
    if not extra:
        assert all(launches[k] > 0 for k in K.GEN_DST_KERNELS)


def test_compare_run_dataset_on_card():
    skip_without_cuda()
    from repro_torch.core.measures import factorize
    from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
    from repro_torch.launch import compare
    spec, scale = PAPER_DATASETS["D6"], 0.1
    X_tr, y_tr, _, _ = train_test_split(*make_dataset(spec, scale=scale), 0.2, seed=0)
    coded = factorize(X_tr, y_tr, device="cuda")
    full, results = compare.run_dataset(spec, scale=scale, device="cuda")
    for r in [full] + results:
        assert finite_acc(r.test_acc), r.method
    assert not any(full.launches[k] for k in K.GEN_DST_KERNELS)
    for r in results:
        if r.method in ("SubStrat", "SubStrat-NF"):
            assert all(r.launches[k] > 0 for k in K.GEN_DST_KERNELS), r.method
            f_plain = plain_fitness(coded, r.result.row_idx, r.result.col_idx)
            assert abs(r.result.dst_fitness - f_plain) <= 1e-6, r.method


@pytest.mark.parametrize("gate,argv", [
    ("check_warm_start", []),
    ("check_metrics", ["--jobs", "2"] + CI_SMOKE),
    ("check_recompile_budget", ["--rounds", "2", "--jobs", "2"] + CI_SMOKE),
])
def test_gate_passes_on_card(gate, argv):
    skip_without_cuda()
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{gate}")
    assert mod.main(argv) in (0, None)


def test_chaos_parity_on_card(tmp_path):
    """``serve_tabular --json`` in process and with two workers on the card,
    worker 0 killed; ``check_chaos_parity`` finds the two equal."""
    skip_without_cuda()
    from repro_torch.launch import check_chaos_parity, serve_tabular
    smoke = ["--jobs", "2"] + CI_SMOKE + ["--json"]
    for name, extra in (("base.json", []),
                        ("chaos.json", ["--workers", "2", "--kill-worker", "0"])):
        payload = serve_tabular.main(smoke + [str(tmp_path / name)] + extra)
        accs = [job["test_acc"] for job in payload["jobs"]]
        assert len(accs) == 2 and all(finite_acc(a) for a in accs)
    assert check_chaos_parity.main([str(tmp_path / "base.json"),
                                    str(tmp_path / "chaos.json")]) in (0, None)


def test_serve_lm_on_card():
    skip_without_cuda()
    from repro_torch.launch import serve_lm
    res, launches = _counted(lambda: serve_lm.main([]))
    assert bool(torch.isfinite(res.last_logits).all()) and launches["flash_attention"] > 0


@pytest.mark.parametrize("argv", [["--steps", "2"], ["--preset", "full", "--steps", "2"]],
                         ids=["smoke", "full"])
def test_train_lm_on_card(argv, tmp_path, monkeypatch):
    """``train_lm`` writes ``checkpoints/`` in the working directory: run it
    in a temporary one."""
    skip_without_cuda()
    from repro_torch.launch import train_lm
    monkeypatch.chdir(tmp_path)
    states, launches = _counted(lambda: train_lm.main(argv))
    assert launches["ssd_scan"] > 0
    assert all(bool(torch.isfinite(p.float()).all()) for s in states
               for p in s.params.parameters())
