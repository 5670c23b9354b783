"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix.  Every piece is a file of its own, found by its name, so a
new cell, configuration, mix, entry point or per-layer metric is added by
adding files and entries, never by editing a file that is there:

* a configuration: the ``file`` its entry in ``configs`` gives;
* a traffic mix: ``perfbench/traffic/<traffic>.json``;
* an entry point: ``perfbench/entries/<entry>.py``, ``entry`` named in the
  configuration's file;
* a per-layer metric: ``perfbench/metrics/<name>.py``, a ``read(run)`` that
  returns the number, or None where it finds nothing to read;
* the limits of a cell's comparison: ``perfbench/limits/<workload>.json``.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parents[1]       # perfbench/


def load_module(path: Path) -> ModuleType:
    name = "perfbench_" + re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, root: Path, name: str, bench_dir: Path = HERE):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                           f"{', '.join(sorted(cells))}")
        self.name, self.cell = name, cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = json.loads((self.root / configs[self.cell["config"]]["file"]).read_text())
        self.mix = json.loads((self.dir / "traffic" / f"{self.cell['traffic']}.json").read_text())
        self.limits = json.loads((self.dir / "limits" / f"{name}.json").read_text())
        self.chips = int(self.cell["chips"])

    def entry_module(self) -> ModuleType:
        return load_module(self.dir / "entries" / f"{self.config['entry']}.py")

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports, each with its reader."""
        out = []
        for m in self.bench["per_layer"]:
            if self.name in m.get("workloads", [self.name]):
                out.append((m, load_module(self.dir / "metrics" / f"{m['name']}.py")))
        return out
