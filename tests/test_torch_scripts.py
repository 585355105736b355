"""The port's instruments and `torch_certify_alpha.py` against the JAX
scripts they port: their flags, their defaults and what they do without a
card, on the CPU."""
import re
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from robocheck_tpu_torch.io import assets

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"


def _run(script, *args, timeout=300):
    return subprocess.run([sys.executable, str(SCRIPTS / script), *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def _flags(path: Path) -> set:
    return set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', path.read_text()))


def test_gate_study_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card error")
    out = _run("torch_gate_study.py", "--dataset", "hard10k")
    assert out.returncode != 0 and "torch_gate_study: no CUDA device" in out.stderr
    assert out.stdout == ""
    src = (SCRIPTS / "torch_gate_study.py").read_text()
    assert re.search(r'add_argument\("--device", default="cuda"\)', src)


def test_gate_study_runs_on_the_cpu_when_asked():
    out = _run("torch_gate_study.py", "--device", "cpu", "--dataset", "hard10k", "--n", "64")
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()
    assert len(line) == 1 and '"set": "hard10k", "n": 64, "device": "cpu"' in line[0]


@pytest.mark.parametrize("port,jax", [("torch_roofline.py", "roofline.py"),
                                      ("torch_gate_study.py", "gate_study.py"),
                                      ("torch_tile_sweep.py", "tile_sweep_exp.py"),
                                      ("torch_certify_alpha.py", "certify_alpha.py")])
def test_instruments_take_the_jax_scripts_flags(port, jax):
    # Every flag of the JAX script, and --dataset on each instrument (for
    # certify_alpha, --out is the trajectory and --record the record).
    assert _flags(SCRIPTS / jax) <= _flags(SCRIPTS / port)
    if jax != "certify_alpha.py":
        assert "--dataset" in _flags(SCRIPTS / port)
    out = _run(port, "--help")
    assert out.returncode == 0, out.stderr
    for flag in _flags(SCRIPTS / port):
        assert flag in out.stdout, flag


def test_instruments_default_to_the_jax_scripts_sets():
    def default(script):
        m = re.search(r'add_argument\("--dataset",[^)]*?default=(\[[^\]]*\]|"[^"]*")',
                      (SCRIPTS / script).read_text(), re.S)
        return m.group(1)

    assert default("torch_gate_study.py") == '["hard100k"]'
    assert default("gate_study.py") == '"hard100k"'
    assert default("torch_tile_sweep.py") == default("gate_study.py")
    assert 'dataset_path("hard100k")' in (SCRIPTS / "tile_sweep_exp.py").read_text()
    assert default("torch_roofline.py") == '["hard100k", "easy100k"]'
    jax_roofline = (SCRIPTS / "roofline.py").read_text()
    assert all(f'dataset_path("{k}")' in jax_roofline for k in ("hard100k", "easy100k"))


@pytest.mark.parametrize("script", ["torch_roofline.py", "torch_tile_sweep.py",
                                    "torch_certify_alpha.py"])
def test_card_scripts_refuse_to_run_without_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card error")
    out = _run(script)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert out.stdout == ""


def test_certify_alpha_levels_default_to_the_legs():
    ns = runpy.run_path(str(SCRIPTS / "torch_certify_alpha.py"), run_name="imported")
    legs, parse = ns["LEGS"], ns["parse_levels"]
    src = (SCRIPTS / "certify_alpha.py").read_text()
    raw = re.search(r'"--raw-levels", default="([^"]+)"', src).group(1)
    smooth = re.search(r'"--smooth-levels", default="([^"]+)"', src).group(1)
    assert legs["raw"][1] == raw and legs["smoothed"][1] == legs["sqp"][1] == smooth
    assert parse(raw) == ((2, 8), (4, 10), (6, 12), (7, 14))
    assert set(ns["RECORD_KEYS"]) == set(legs)
    assert {"raw_rrt_path", "sqp_smoothed_path"} <= set(ns["RECORD_KEYS"].values())
    out = _run("torch_certify_alpha.py", "--smooth-levels", "2:8,4")
    assert out.returncode == 2 and "refine:depth" in out.stderr


def test_missing_100k_set_names_its_command(monkeypatch, tmp_path):
    monkeypatch.setattr(assets, "_REPO_ROOT", tmp_path)
    monkeypatch.delenv("ROBOCHECK_ASSETS", raising=False)
    monkeypatch.delenv("ROBOCHECK_REFERENCE_DIR", raising=False)
    for key in ("hard100k", "easy100k"):
        with pytest.raises(FileNotFoundError, match="scripts/torch_make_datasets.py"):
            assets.dataset_path(key)
    with pytest.raises(FileNotFoundError) as e:
        assets.dataset_path("hard10k")
    assert "torch_make_datasets" not in str(e.value)
