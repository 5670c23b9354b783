"""The port's entry points for the JAX package's ``examples/`` on the CPU.

- Each entry point's ``main`` runs at the CI's smoke configuration
  (``.github/workflows/ci.yml:85-118``) with ``--device cpu``: the
  quickstart with the batched and the loop backend and with ``ig_km``, the
  serving example in process and on two worker processes with worker 0
  killed, diffed by the chaos-parity gate, and the metrics, recompile-budget
  and warm-start gates, each returning 0.  The Table-4 entry point, which CI does
  not run, at D6 scale 0.05 with two methods; the LM wrappers at their own
  presets.
- The quickstart's values come from an MLP-sampling AutoML seed, whose
  inits the port draws with torch and the reference with ``jax.random``,
  and no seam reaches them through the command line: the tests hold the
  structure (the reference's printed lines, accuracies in [0, 1], the
  time-reduction and relative-accuracy formulas exactly).
  ``tests/test_torch_compare.py`` holds the comparison's values.
- The LM wrappers hand their launchers exactly the reference's argument
  lists, plus ``--device``.
- ``check_chaos_parity`` passes on equal artifacts and fails on a
  ``test_acc`` moved by 1e-5 and on a dead worker that counted no failure.
- Every entry point that runs on a device raises without ``--device cpu``
  on this machine, which has no card.  ``check_chaos_parity`` reads two JSON
  files and touches no device.
"""
import importlib.util
import json
import re
from pathlib import Path

import pytest
import torch

from repro_torch.data.tabular import PAPER_DATASETS
from repro_torch.launch import (
    automl_tabular, check_chaos_parity, check_metrics, check_recompile_budget,
    check_warm_start, compare, quickstart, serve_lm, serve_tabular, train_lm,
)

ROOT = Path(__file__).resolve().parents[1]
CI_SMOKE = ["--scale", "0.1", "--trials", "4"]


def _load_example(name):
    """A module of the reference's ``examples/`` (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--backend", "loop"], ["--strategy", "ig_km"]],
                         ids=["batched", "loop", "ig_km"])
def test_quickstart_at_the_ci_configs(extra, capsys):
    out = quickstart.main(CI_SMOKE + extra + ["--device", "cpu"])
    res, full = out["substrat"], out["full"]
    assert 0.0 <= full.test_acc <= 1.0 and 0.0 <= res.final.test_acc <= 1.0
    assert out["time_reduction"] == 1 - res.total_time_s / out["t_full"]
    assert out["relative_accuracy"] == res.final.test_acc / full.test_acc
    assert res.strategy == (extra[1] if extra[:1] == ["--strategy"] else "gen_dst")
    want_backend = extra[1] if extra[:1] == ["--backend"] else "batched"
    assert full.backend == res.final.backend == want_backend
    text = capsys.readouterr().out
    for pattern in (r"^dataset D3 \(car insurance\): 800 train rows, 17 columns",
                    r"^Full-AutoML : +[0-9.]+s  test-acc [0-9.]+ \(\w+, \d+ trials\)$",
                    r"^SubStrat    : +[0-9.]+s  test-acc [0-9.]+ \(\w+\)$",
                    r"^  subset: \d+ rows x \d+\(\+target\) cols, \|H\(d\)-H\(D\)\| = [0-9.]+$",
                    r"^  phases: factorize_s=",
                    r"^time-reduction     = [+-][0-9.]+%$",
                    r"^relative-accuracy  = [0-9.]+%$"):
        assert re.search(pattern, text, re.M), pattern


def test_automl_tabular_runs_two_methods(capsys):
    full, results = automl_tabular.main(
        ["--dataset", "D6", "--scale", "0.05", "--methods", "SubStrat", "MC-100",
         "--device", "cpu"])
    assert [r.method for r in results] == ["SubStrat", "MC-100"]
    for r in [full] + results:
        assert 0.0 <= r.test_acc <= 1.0 and r.dataset == "D6"
    text = capsys.readouterr().out
    assert re.search(r"^D6: Full-AutoML [0-9.]+s, test-acc [0-9.]+$", text, re.M)
    assert re.search(r"^method +time +time-red +acc +rel-acc$", text, re.M)


@pytest.mark.parametrize("gate, argv", [
    (check_metrics, ["--jobs", "2"] + CI_SMOKE),
    (check_recompile_budget, ["--rounds", "2", "--jobs", "2"] + CI_SMOKE),
    (check_warm_start, []),
], ids=["metrics", "recompile_budget", "warm_start"])
def test_gates_pass_on_cpu(gate, argv):
    assert gate.main(argv + ["--device", "cpu"]) == 0


def test_check_metrics_reads_labelled_launches():
    text = ('# HELP kernel_launches_total launches\n# TYPE kernel_launches_total counter\n'
            'kernel_launches_total{kernel="masked_histogram"} 31\n'
            'kernel_launches_total{kernel="fused_delta_fitness"} 0\n')
    sums, typed = check_metrics.parse_exposition(text)
    assert sums == {"kernel_launches_total": 31.0} and typed == {"kernel_launches_total"}
    assert check_metrics.labelled_values(text, "kernel_launches_total", "kernel") == {
        "masked_histogram": 31.0, "fused_delta_fitness": 0.0}


def test_serving_chaos_parity_on_cpu(tmp_path):
    """The CI's chaos gate: the same two jobs in process and on two worker
    processes with worker 0 killed at its first task."""
    smoke = ["--jobs", "2", "--device", "cpu"] + CI_SMOKE + ["--json"]
    base = serve_tabular.main(smoke + [str(tmp_path / "base.json")])
    chaos = serve_tabular.main(smoke + [str(tmp_path / "chaos.json"), "--workers", "2",
                                        "--kill-worker", "0"])
    assert chaos["transport"]["worker_failures"] == 1 and base["transport"] is None
    assert check_chaos_parity.main([str(tmp_path / "base.json"),
                                    str(tmp_path / "chaos.json")]) == 0


def _artifact(test_acc=0.9, transport=None):
    return {"jobs": [{"job": 0, "dataset": "D3", "family": "logreg", "preproc": "standardize",
                      "test_acc": test_acc, "trials": [0.5, 0.75], "sub_trials": [0.25]}],
            "transport": transport}


ALIVE = {"workers_total": 2, "workers_alive": 2, "worker_failures": 0, "redispatched_tasks": 0}
DEAD_UNSEEN = dict(ALIVE, workers_alive=1)
DEAD_SEEN = dict(ALIVE, workers_alive=1, worker_failures=1, redispatched_tasks=1)


@pytest.mark.parametrize("chaos, passes", [
    (_artifact(), True),
    (_artifact(transport=ALIVE), True),
    (_artifact(transport=DEAD_SEEN), True),
    (_artifact(test_acc=0.9 + 1e-5), False),
    (_artifact(transport=DEAD_UNSEEN), False),
], ids=["equal", "equal_workers_alive", "kill_seen", "test_acc_moved", "dead_worker_unseen"])
def test_check_chaos_parity_cases(tmp_path, chaos, passes):
    (tmp_path / "a.json").write_text(json.dumps(_artifact()))
    (tmp_path / "b.json").write_text(json.dumps(chaos))
    argv = [str(tmp_path / "a.json"), str(tmp_path / "b.json")]
    if passes:
        assert check_chaos_parity.main(argv) == 0
    else:
        with pytest.raises(AssertionError):
            check_chaos_parity.main(argv)


def test_lm_wrappers_pass_the_references_arguments(monkeypatch):
    calls = {"jax": [], "torch": []}
    ref_serve, ref_train = _load_example("serve_lm"), _load_example("train_lm")
    monkeypatch.setattr(ref_serve, "serve_main", calls["jax"].append)
    monkeypatch.setattr(ref_train, "train_main", calls["jax"].append)
    monkeypatch.setattr(serve_lm, "serve_main", calls["torch"].append)
    monkeypatch.setattr(train_lm, "train_main", calls["torch"].append)
    for argv in ([], ["--arch", "mamba2-130m", "--gen", "32"]):
        monkeypatch.setattr("sys.argv", ["serve_lm.py"] + argv)
        ref_serve.main()
        serve_lm.main(argv + ["--device", "cpu"])
    for argv in ([], ["--preset", "full", "--steps", "3"]):
        monkeypatch.setattr("sys.argv", ["train_lm.py"] + argv)
        ref_train.main()
        train_lm.main(argv + ["--device", "cpu"])
    assert len(calls["torch"]) == len(calls["jax"]) == 6
    for got, want in zip(calls["torch"], calls["jax"]):
        assert _flags(got) == {**_flags(want), "--device": "cpu"}


def _flags(argv) -> dict:
    """A launcher argument list (flag, value pairs) as a dict."""
    assert len(argv) % 2 == 0 and all(a.startswith("--") for a in argv[::2])
    return dict(zip(argv[::2], argv[1::2]))


def test_lm_wrappers_run_on_cpu(tmp_path, monkeypatch):
    res = serve_lm.main(["--device", "cpu"])
    assert res.ids.shape == (4, 16) and bool(torch.isfinite(res.last_logits).all())
    monkeypatch.chdir(tmp_path)
    states = train_lm.main(["--steps", "2", "--device", "cpu"])
    assert len(states) == 2
    for state in states:
        assert int(state.step) == 2
        assert all(bool(torch.isfinite(p).all()) for p in state.params.parameters())


@pytest.mark.parametrize("call", [
    lambda: quickstart.main(CI_SMOKE),
    lambda: automl_tabular.main(["--scale", "0.01"]),
    lambda: compare.run_dataset(PAPER_DATASETS["D6"], scale=0.01),
    lambda: check_warm_start.main([]),
    lambda: check_metrics.main(["--jobs", "1"] + CI_SMOKE),
    lambda: check_recompile_budget.main(["--rounds", "1", "--jobs", "1"] + CI_SMOKE),
    lambda: serve_lm.main([]),
    lambda: train_lm.main(["--steps", "1"]),
], ids=["quickstart", "automl_tabular", "compare", "check_warm_start", "check_metrics",
        "check_recompile_budget", "serve_lm", "train_lm"])
def test_entry_points_raise_without_a_card(call, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert not (tmp_path / "checkpoints").exists()


def test_wrappers_keep_the_references_flags():
    """Each port entry point takes the reference's flags, plus ``--device``."""
    for name, mod in (("quickstart", quickstart), ("automl_tabular", automl_tabular),
                      ("check_metrics", check_metrics),
                      ("check_recompile_budget", check_recompile_budget),
                      ("serve_lm", serve_lm), ("train_lm", train_lm)):
        src = (ROOT / "examples" / f"{name}.py").read_text()
        ref_flags = set(re.findall(r'add_argument\("(--[a-z-]+)"', src))
        port_flags = set(re.findall(r'add_argument\("(--[a-z-]+)"',
                                    Path(mod.__file__).read_text()))
        assert port_flags == ref_flags | {"--device"}, name
