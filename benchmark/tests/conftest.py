"""Fixtures of the benchmark's own tests (CPU; tests marked ``card`` skip
without an NVIDIA card, decided inside the ``card`` fixture)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")


@pytest.fixture
def checkout(tmp_path):
    """A checkout holding BENCHMARK.json and a copy of benchmark/, with the
    program linked in; returns (root, BENCHMARK.json as a dict, write)."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    (root / "robocheck_tpu_torch").symlink_to(ROOT / "robocheck_tpu_torch")
    bench = json.loads((root / "BENCHMARK.json").read_text())

    def write():
        (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    return root, bench, write


def add_cell(root: Path, bench: dict, name: str, config: str, traffic: str,
             metrics_from: str) -> None:
    """A cell ``name`` of ``config`` and ``traffic`` that reports every
    metric the cell ``metrics_from`` reports."""
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                               "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if metrics_from in m.get("workloads", []):
            m["workloads"].append(name)


def tiny_cells(root: Path, bench: dict) -> None:
    """Cells small enough for the CPU twins: 48 hard rows, and 4 queries
    of a refine-1 robot."""
    traffic = root / "benchmark" / "traffic"
    (traffic / "tinyhard.json").write_text(json.dumps(
        {"generator": "alpha_bot", "box": "hard", "rows": 48, "pool": 2}))
    (traffic / "tinynear.json").write_text(json.dumps(
        {"generator": "clearance_queries", "rows": 4, "pool": 2, "reach": 0.6}))
    cfg = json.loads((root / "benchmark/configs/alpha1.0-clearance.json").read_text())
    cfg.update(name="tiny-clearance", refine=1)
    (root / "benchmark/configs/tiny-clearance.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-clearance", "source": "a test configuration",
                             "file": "benchmark/configs/tiny-clearance.json",
                             "reduced": ["refine"], "why": "a test configuration"})
    add_cell(root, bench, "tiny.hard", "alpha1.0-check", "tinyhard", "alpha1.0-check.hard100k")
    add_cell(root, bench, "tiny.near", "tiny-clearance", "tinynear", "alpha1.0-clearance.near256")


def run_cell(root: Path, workload: str, *extra: str, prelude: str = "", trace: int = 0,
             seconds: float = 1.0) -> tuple[dict | None, subprocess.CompletedProcess]:
    """Run the checkout's harness on the CPU in a fresh process, after
    ``prelude`` (Python that may break the program underneath); returns (the
    result line or None, the process)."""
    argv = ["--workload", workload, "--seed", "2718281828", "--seconds", str(seconds),
            "--trace", str(trace), "--device", "cpu", *extra]
    code = (f"import sys; sys.path[:0] = [{str(root / 'benchmark')!r}, {str(root)!r}]\n"
            f"{prelude}\nfrom harness.cli import main\nsys.exit(main({argv!r}))\n")
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    done = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, env=env, timeout=600)
    lines = done.stdout.strip().splitlines()
    return (json.loads(lines[-1]) if done.returncode == 0 and lines else None), done
