"""Each cell's control, at the cell's own size on the card, comes out not
correct on three seeds (run on the card: python3 -m pytest benchmark/tests
-m card). The control takes the program's place for one pass over the pool
(`--control`, which the benchmark's own runs never pass)."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT

CONTROLS = [("alpha1.0-check.hard100k", "conservative"),
            ("alpha1.0-check.step2048", "conservative"),
            ("alpha1.0-check.easy100k", "broad"),
            ("alpha1.0-clearance.near256", "f32")]
SEEDS = (3000000001, 3000000002, 3000000003)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload,control", CONTROLS)
def test_the_control_is_not_correct(card, workload, control, seed):
    done = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                           "--seed", str(seed), "--seconds", "1", "--trace", "0",
                           "--control", control], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    print(workload, control, seed, json.dumps(result["compared"]))
    assert result["correct"] is False
