"""CPU tests of the harness's plumbing: cells resolve to their files by name,
a new cell is added without editing a file, the module check, and the shape
of the result line."""
import hashlib
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

from pbcore import costs, spec            # noqa: E402
from pbcore.modules import forbidden_loaded   # noqa: E402
from pbcore.output import result_line     # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_workload_resolves_by_name(name):
    cell = spec.Cell(ROOT, name)
    assert cell.chips == 1
    mod = cell.entry_module()
    assert hasattr(mod, "Entry")
    readers = cell.per_layer()
    assert readers and all(callable(r.read) for _, r in readers)
    assert {m["name"] for m in cell.end_to_end()} == {"setup_s", "job_s", "test_acc"}
    # every per-layer metric this cell reports moves an end-to-end metric it reports
    assert all(m["moves"] == "job_s" for m, _ in readers)
    assert cell.limits and all(v >= 0 for v in cell.limits.values())


def test_benchmark_names_and_files_are_well_formed():
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names) and all(name.match(n) for n in names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def _tree_digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_config_mix_and_metric_are_found_without_edits(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_digest(bench_dir)

    cfg = json.loads((bench_dir / "configs" / "automl-full.json").read_text())
    cfg["name"] = "dummy-config"
    (bench_dir / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "d6-full.json").read_text())
    mix.update(name="dummy-mix", n_rows=300)
    (bench_dir / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "dummy_metric.py").write_text("def read(run):\n    return 1.5\n")
    (bench_dir / "limits" / "dummy.cell.json").write_text(json.dumps({"faults": 0}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-config", "source": "x",
                             "file": "perfbench/configs/dummy-config.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-config",
                               "traffic": "dummy-mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "x", "moves": "job_s",
                               "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.Cell(tmp_path, "dummy.cell", bench_dir)
    assert cell.config["name"] == "dummy-config" and cell.mix["n_rows"] == 300
    assert [m["name"] for m, _ in cell.per_layer()] == ["dummy_metric"]
    assert cell.per_layer()[0][1].read(None) == 1.5
    assert cell.limits == {"faults": 0}
    after = _tree_digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.core.plan", "numpy", "jaxtyping", "reproducible"], []),
    (["repro", "numpy"], ["repro"]),
    (["repro.core.plan"], ["repro"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
])
def test_module_check_compares_whole_top_level_names(names, found):
    assert forbidden_loaded(names) == found


def test_result_line_shape():
    out = {"correct": True, "attempted": 12, "failed": 0,
           "metrics": {"job_s": {"value": 2.5, "unit": "s"}},
           "device": {"memory_peak_bytes": 123, "busy_s": 1.0, "window_s": 2.0},
           "breakdown": {"device_ops": [["k", 0.1]], "idle_gaps": [["fine_tune", 0.2]]},
           "checked": {"fitness_gap": [1e-8, 1e-6], "faults": [math.inf, 0]}, "fails": ["faults"]}
    line, err = result_line(out, "NVIDIA H100 80GB HBM3", 1)
    obj = json.loads(line)
    assert list(obj) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checked"]
    assert obj["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                             "memory_peak_bytes": 123, "busy_s": 1.0, "window_s": 2.0}
    assert obj["checked"]["faults"] == ["inf", 0]
    assert err[0].startswith("correct True") and err[-1] == "check faults inf limit 0"


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA card here: the run exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "automl.d6",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_roofline_byte_counts():
    # D1's B1/B2 shapes (100 candidates, 322 rows, 23 columns, 256 bins), as
    # the kernel table in PERF.md states their bounds: 0.00163 and 0.00071 ms
    assert costs.least_seconds(costs.b1_bytes(100, 322, 23, 256)) * 1e3 == pytest.approx(
        0.00163, abs=1e-5)
    assert costs.least_seconds(costs.b2_bytes(100, 23, 256)) * 1e3 == pytest.approx(
        0.00071, abs=1e-5)
    per_gen = costs.b1_bytes(100, 322, 23, 256) + costs.b2_bytes(100, 23, 256)
    assert costs.gen_dst_bytes(30, 100, 1, 322, 23, 256, 1, True) == 31 * per_gen


def test_trial_flops_count_products():
    # logreg: forward and weight gradient per row and step, then one scoring pass
    assert costs.trial_flops("logreg", {}, 100, 10, 4, 2, 3) == 3 * 100 * 2 * 16 + 10 * 16
    hp = {"width": 8, "depth": 1}
    fwd = 2 * (4 * 8 + 8 * 2)
    assert costs.trial_flops("mlp", hp, 100, 10, 4, 2, 1) == 100 * (2 * fwd + 2 * 8 * 2) + 10 * fwd
