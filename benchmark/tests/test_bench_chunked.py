"""The chunked check cell and the million-row mix at CPU sizes: the scaling
reference gives `MeshPair`'s three columns, the chunked driver runs
`correct` through `make_checker`'s chunk pairs and refuses any other
checker, a planted fault and the `broad` control turn `correct` false, and
the `hard1m` mix draws its rows."""
import json

import numpy as np
import pytest
import torch

from conftest import BENCH, add_cell, run_cell
from ref.blocked_clearance import subdivided_mesh
from ref.blocked_tritri import BlockedMeshPair
from ref.mesh import read_obj
from ref.tritri import MeshPair

DATA = BENCH / "data" / "alpha1.0"
FLIP = ("import robocheck_tpu_torch.kernels.chunked as c\n"
        "f = c.ChunkedMegaKernelChecker.check_valid_resolved\n"
        "def g(self, confs, chunk=None, compact=False):\n"
        "    v = f(self, confs, chunk, compact).copy(); v[3] = ~v[3]; return v\n"
        "c.ChunkedMegaKernelChecker.check_valid_resolved = g\n")


def _gen():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_gen_alpha_bot",
                                                  BENCH / "gen" / "alpha_bot.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


@pytest.mark.parametrize("refine", [0, 1])
def test_the_blocked_reference_gives_meshpairs_columns(refine):
    """On 64 hard and 64 easy rows, against the obstacle as published and
    at one round of subdivision."""
    robot, obstacle = read_obj(DATA / "robot.obj"), read_obj(DATA / "obstacle.obj")
    obstacle = subdivided_mesh(*obstacle, refine)
    rng = np.random.default_rng(4100000000 + refine)
    confs = np.concatenate([_gen().batches(rng, robot[0], {"box": box, "rows": 64, "pool": 1})[0]
                            for box in ("hard", "easy")])
    want = MeshPair(robot, obstacle, "cpu", torch.float64).check(confs, 32)
    got = BlockedMeshPair(robot, obstacle, "cpu", torch.float64).check(confs, 32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    valid, pairs, broad = got
    assert broad[:64].any() and not broad.all() and (pairs[~broad] == 0).all()
    assert valid.any() and not valid.all() and pairs.max() > 0


def _tiny_chunked_cell(root, bench, refine=2, chunk_pairs=3) -> str:
    """48 hard rows a call against the obstacle at ``refine`` rounds (16,128
    triangles at 2: 3 obstacle chunks)."""
    (root / "benchmark/traffic/tinyhard.json").write_text(json.dumps(
        {"generator": "alpha_bot", "box": "hard", "rows": 48, "pool": 2}))
    cfg = json.loads((root / "benchmark/configs/alpha1.0-sub3-check.json").read_text())
    cfg.update(name="tiny-sub-check", obstacle_refine=refine, chunk_pairs=chunk_pairs)
    (root / "benchmark/configs/tiny-sub-check.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-sub-check", "source": "a test configuration",
                             "file": "benchmark/configs/tiny-sub-check.json",
                             "reduced": ["obstacle_refine"], "why": "a test configuration"})
    add_cell(root, bench, "tiny.subcheck", "tiny-sub-check", "tinyhard",
             "alpha1.0-sub3-check.hard100k")
    return "tiny.subcheck"


def test_the_chunked_cell_runs_correct(checkout):
    root, bench, write = checkout
    cell = _tiny_chunked_cell(root, bench)
    write()
    result, done = run_cell(root, cell)
    assert result is not None, done.stderr
    assert result["correct"] and not result["failed"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"checks_per_s", "setup_s"}
    assert result["compared"] == {"wrong_verdicts": {"value": 0, "limit": 0}}
    # A traced run reads the chunk pairs' counter: every row goes to each of
    # the 3 chunk pairs. No kernel runs on the CPU, so the device-trace
    # readers find nothing.
    result, done = run_cell(root, cell, trace=1)
    assert result is not None, done.stderr
    assert result["correct"]
    assert set(result["metrics"]) == {"device_idle_pct.checks", "resolve_rows_per_call.checks",
                                      "pair_rows_per_row.chunked"}
    assert result["metrics"]["pair_rows_per_row.chunked"]["value"] == 3.0


def test_a_pair_that_fits_one_block_is_refused(checkout):
    """At one round (4,032 triangles) make_checker gives the plain checker:
    the cell does not run in its place."""
    root, bench, write = checkout
    cell = _tiny_chunked_cell(root, bench, refine=1, chunk_pairs=1)
    write()
    result, done = run_cell(root, cell)
    assert result is None and done.returncode != 0
    assert "not the chunked checker" in done.stderr


@pytest.mark.parametrize("fault", ["flip", "broad"])
def test_a_fault_in_the_chunked_cell_is_not_correct(checkout, fault):
    root, bench, write = checkout
    cell = _tiny_chunked_cell(root, bench)
    write()
    if fault == "flip":
        result, done = run_cell(root, cell, prelude=FLIP)
    else:
        result, done = run_cell(root, cell, "--control", "broad")
    assert result is not None, done.stderr
    assert result["correct"] is False
    assert result["compared"]["wrong_verdicts"]["value"] > 0


def test_the_million_row_mix_draws_its_rows():
    mix = json.loads((BENCH / "traffic" / "hard1m.json").read_text())
    assert mix["generator"] == "alpha_bot" and mix["pool"] == 2
    pool = _gen().batches(np.random.default_rng(3000000000), read_obj(DATA / "robot.obj")[0],
                          mix)
    assert len(pool) == 2
    for batch in pool:
        assert batch.shape == (1_000_000, 6) and batch.dtype == np.float32
        assert np.isfinite(batch).all()
    assert not np.array_equal(pool[0], pool[1])
