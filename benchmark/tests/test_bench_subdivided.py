"""The subdivided-obstacle clearance cell at a CPU size: its driver runs
`correct`, a fault planted in the program turns `correct` false, and its
control is not correct."""
import json

import pytest

from conftest import add_cell, run_cell

FAULTS = {  # an answer raised above the truth; an answer lowered past 2 err
    "above": ("import robocheck_tpu_torch.planner.clearance as c\n"
              "f = c.ClearanceEngine.min_distances\n"
              "def g(self, confs):\n"
              "    d = f(self, confs).copy(); d[1] += 2 * self.err_bound(confs); return d\n"
              "c.ClearanceEngine.min_distances = g\n"),
    "below": ("import robocheck_tpu_torch.planner.clearance as c\n"
              "f = c.ClearanceEngine.min_distances\n"
              "def g(self, confs):\n"
              "    d = f(self, confs).copy(); d[0] -= 3 * self.err_bound(confs); return d\n"
              "c.ClearanceEngine.min_distances = g\n"),
}


def _tiny_sub_cell(root, bench) -> str:
    """4 queries a call, a refine-1 robot, the obstacle at one round
    (4,032 triangles)."""
    (root / "benchmark/traffic/tinynear.json").write_text(json.dumps(
        {"generator": "clearance_queries", "rows": 4, "pool": 2, "reach": 0.6}))
    cfg = json.loads((root / "benchmark/configs/alpha1.0-sub3-clearance.json").read_text())
    cfg.update(name="tiny-sub-clearance", refine=1, obstacle_refine=1)
    (root / "benchmark/configs/tiny-sub-clearance.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-sub-clearance", "source": "a test configuration",
                             "file": "benchmark/configs/tiny-sub-clearance.json",
                             "reduced": ["refine", "obstacle_refine"],
                             "why": "a test configuration"})
    add_cell(root, bench, "tiny.sub", "tiny-sub-clearance", "tinynear",
             "alpha1.0-sub3-clearance.near256")
    return "tiny.sub"


def test_the_subdivided_cell_runs_correct(checkout):
    root, bench, write = checkout
    cell = _tiny_sub_cell(root, bench)
    write()
    result, done = run_cell(root, cell)
    assert result is not None, done.stderr
    assert result["correct"] and not result["failed"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"configs_per_s", "setup_s"}
    assert set(result["compared"]) == {"above_truth", "below_truth"}
    assert result["compared"]["above_truth"]["value"] <= 0
    # A traced run reads the new counter; no kernel runs on the CPU, so the
    # device-trace readers find nothing.
    result, done = run_cell(root, cell, trace=1)
    assert result is not None, done.stderr
    assert set(result["metrics"]) == {"device_idle_pct.clearance", "bounds_ms_per_call.clearance",
                                      "waves_per_call.clearance", "k3_kept_pct.clearance"}
    assert 0 < result["metrics"]["k3_kept_pct.clearance"]["value"] <= 100


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_subdivided_cell_is_not_correct(checkout, fault):
    root, bench, write = checkout
    cell = _tiny_sub_cell(root, bench)
    write()
    result, done = run_cell(root, cell, prelude=FAULTS[fault])
    assert result is not None, done.stderr
    assert result["correct"] is False
    name = "above_truth" if fault == "above" else "below_truth"
    assert result["compared"][name]["value"] > result["compared"][name]["limit"]


def test_the_subdivided_control_is_not_correct(checkout):
    root, bench, write = checkout
    cell = _tiny_sub_cell(root, bench)
    write()
    result, done = run_cell(root, cell, "--control", "f32")
    assert result is not None, done.stderr
    assert result["correct"] is False
    assert result["compared"]["above_truth"]["value"] > 0
