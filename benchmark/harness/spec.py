"""What one run of the benchmark is made of, found by name.

``BENCHMARK.json`` at the checkout's root names each cell (``workloads``),
its configuration and its traffic mix. Everything that belongs to one of
them is a file of its own, found by its name:

  * a configuration: ``benchmark/configs/<config>.json``, whose ``entry``
    names the driver ``benchmark/drivers/<entry>.py`` that builds the
    program's entry point and calls it;
  * a traffic mix: ``benchmark/traffic/<traffic>.json``, whose
    ``generator`` names ``benchmark/gen/<generator>.py``;
  * a metric: ``benchmark/metrics/<name>.py``, a reader with one function
    ``read(record)`` that returns the metric's value, or None where the run
    holds nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = HERE.parent  # the checkout


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module named ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # the cell's entries of BENCHMARK.json's end_to_end
    per_layer: list  # and of its per_layer

    def driver(self):
        return load_module(HERE / "drivers" / f"{self.config['entry']}.py",
                           f"bench_driver_{self.config['entry']}")

    def generator(self):
        return load_module(HERE / "gen" / f"{self.traffic['generator']}.py",
                           f"bench_gen_{self.traffic['generator']}")


def metric_reader(name: str):
    """The ``read(record)`` of ``benchmark/metrics/<name>.py``."""
    return load_module(HERE / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_").replace("-", "_")).read


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    # A per-layer metric belongs to the cells that report the end-to-end
    # metric it moves (and, where it lists them, to those cells alone).
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, workload) and m["moves"] in moved]
    return Cell(workload, config, traffic, int(w["chips"]), e2e, layer)
