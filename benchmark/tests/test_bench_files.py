"""A configuration, a traffic mix and a metric added as files are found and
run with no edit to the harness; faults planted in the program turn
``correct`` false; the control of the clearance cell is refused."""
import json

import pytest

from conftest import add_cell, run_cell, tiny_cells


def test_a_config_a_mix_and_a_metric_added_as_files_run(checkout):
    root, bench, write = checkout
    tiny_cells(root, bench)
    (root / "benchmark/metrics/pool_size.tiny.py").write_text(
        "def read(record):\n    return len(set(record['window']['batches']))\n")
    bench["end_to_end"].append({"name": "pool_size.tiny", "unit": "batches",
                                "better": "higher", "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny.near"]})
    write()
    result, done = run_cell(root, "tiny.near")
    assert result is not None, done.stderr
    assert result["correct"] and not result["failed"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"configs_per_s", "setup_s", "pool_size.tiny"}
    assert result["metrics"]["pool_size.tiny"]["value"] == 2
    assert list(result)[-1] == "compared"
    assert set(result["compared"]) == {"above_truth", "below_truth"}


def test_a_traced_run_reports_the_per_layer_metrics(checkout):
    root, bench, write = checkout
    tiny_cells(root, bench)
    write()
    result, done = run_cell(root, "tiny.hard", trace=1)
    assert result is not None, done.stderr
    assert result["correct"]
    # No kernel runs on the CPU: the kernel readers find nothing and stay out.
    assert set(result["metrics"]) == {"device_idle_pct.checks", "resolve_rows_per_call.checks"}
    assert {"busy_s", "window_s"} <= set(result["device"])



def test_a_reader_that_loads_the_jax_package_stops_the_result(checkout):
    """A metric's reader is loaded after the window; a module of the JAX
    package that it pulls in, even through another module, still keeps the
    run from printing a result."""
    root, bench, write = checkout
    tiny_cells(root, bench)
    (root / "robocheck_tpu").mkdir()
    (root / "robocheck_tpu" / "__init__.py").write_text("")
    (root / "benchmark/metrics/helper_tiny.py").write_text("import robocheck_tpu\n")
    (root / "benchmark/metrics/loads.tiny.py").write_text(
        "import importlib\nimportlib.import_module('helper_tiny')\n"
        "def read(record):\n    return 1.0\n")
    bench["end_to_end"].append({"name": "loads.tiny", "unit": "calls", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny.near"]})
    write()
    prelude = f"sys.path.append({str(root / 'benchmark/metrics')!r})"
    result, done = run_cell(root, "tiny.near", prelude=prelude)
    assert done.returncode != 0 and result is None
    assert not done.stdout.strip()
    assert "robocheck_tpu" in done.stderr.splitlines()[-1]

ALTER = {  # one answer altered where it is produced
    "tiny.hard": ("import robocheck_tpu_torch.kernels.megakernel as m\n"
                  "f = m.MegaKernelChecker.check_valid_resolved\n"
                  "def g(self, confs, chunk=None):\n"
                  "    v = f(self, confs, chunk).copy(); v[3] = ~v[3]; return v\n"
                  "m.MegaKernelChecker.check_valid_resolved = g\n"),
    "tiny.near": ("import robocheck_tpu_torch.planner.clearance as c\n"
                  "f = c.ClearanceEngine.min_distances\n"
                  "def g(self, confs):\n"
                  "    d = f(self, confs).copy(); d[1] += 2 * self.err_bound(confs); return d\n"
                  "c.ClearanceEngine.min_distances = g\n"),
}
HALF = {  # half of the batch left out: its second half never checked
    "tiny.hard": ("import numpy as np, robocheck_tpu_torch.kernels.megakernel as m\n"
                  "f = m.MegaKernelChecker.check_valid_resolved\n"
                  "def g(self, confs, chunk=None):\n"
                  "    h = len(confs) // 2\n"
                  "    return np.concatenate([f(self, confs[:h], chunk), np.ones(len(confs) - h, bool)])\n"
                  "m.MegaKernelChecker.check_valid_resolved = g\n"),
    "tiny.near": ("import numpy as np, robocheck_tpu_torch.planner.clearance as c\n"
                  "f = c.ClearanceEngine.min_distances\n"
                  "def g(self, confs):\n"
                  "    h = len(confs) // 2; d = f(self, confs[:h])\n"
                  "    return np.concatenate([d, np.full(len(confs) - h, d.max())])\n"
                  "c.ClearanceEngine.min_distances = g\n"),
}


@pytest.mark.parametrize("fault", ["alter", "half"])
@pytest.mark.parametrize("workload", ["tiny.hard", "tiny.near"])
def test_a_broken_program_is_not_correct(checkout, workload, fault):
    root, bench, write = checkout
    tiny_cells(root, bench)
    write()
    prelude = (ALTER if fault == "alter" else HALF)[workload]
    result, done = run_cell(root, workload, prelude=prelude)
    assert result is not None, done.stderr
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["compared"].values())


def test_the_clearance_control_is_not_correct(checkout):
    """The plain reference in float32 in the engine's place reads above the
    float64 truth (a test size of the control run on the card)."""
    root, bench, write = checkout
    tiny_cells(root, bench)
    write()
    result, done = run_cell(root, "tiny.near", "--control", "f32")
    assert result is not None, done.stderr
    assert result["correct"] is False
    assert result["compared"]["above_truth"]["value"] > 0


def test_a_run_without_the_program_prints_no_result(tmp_path):
    from conftest import BENCH, ROOT
    import shutil
    import subprocess
    import sys

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    done = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "alpha1.0-check.hard100k", "--seed", "1", "--seconds", "1",
                           "--trace", "0", "--device", "cpu"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert not done.stdout.strip()
