"""The port's spans (`profiling.timers.span`) and the clearance engine's wave
counter: under a profiler the check and clearance calls mark each layer with
a host range named ``rc.*``, nested as the calls nest; with none running they
enter nothing.

The CPU tests run the kernels' twins. The card test (``-m card``) holds the
spans to the device records' clock on a traced 100,000-row call; it skips
without an NVIDIA card. This file imports no JAX, so on the card it runs
without the suite's conftest:
``python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -m card``.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.datagen import alpha_bot_configurations
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.kernels.chunked import ChunkedMegaKernelChecker
from robocheck_tpu_torch.kernels.megakernel import MegaKernelChecker
from robocheck_tpu_torch.models.shapes import box, icosphere
from robocheck_tpu_torch.planner.clearance import BLOCK, ClearanceEngine
from robocheck_tpu_torch.profiling import timers

# ``check_valid_resolved``'s steps under ``rc.check``: the resolution is
# issued on the device before the one fetch. ``check_packed`` alone has no
# resolve step.
CHECK_STEPS = ["rc.check.validate", "rc.check.upload", "rc.check.pose", "rc.check.kernel",
               "rc.check.resolve", "rc.check.fetch"]
PACKED_STEPS = [name for name in CHECK_STEPS if name != "rc.check.resolve"]


def _tree(prof) -> list:
    """The profiled ``rc.*`` spans as (name, children) trees in time order,
    each child under its nearest ``rc.*`` ancestor."""
    events = sorted((e for e in prof.profiler.function_events if e.name.startswith("rc.")),
                    key=lambda e: e.time_range.start)
    nodes = {id(e): (e.name, []) for e in events}
    roots = []
    for e in events:
        up = e.cpu_parent
        while up is not None and id(up) not in nodes:
            up = up.cpu_parent
        (roots if up is None else nodes[id(up)][1]).append(nodes[id(e)])
        if up is not None:
            lo, hi = up.time_range.start, up.time_range.end
            assert lo <= e.time_range.start <= e.time_range.end <= hi, (e.name, up.name)
    return roots


def _names(nodes) -> list:
    return [name for name, _ in nodes]


@pytest.fixture(scope="module")
def checker():
    return MegaKernelChecker(icosphere(1, radius=0.3, name="r"), box(name="o"), device="cpu")


def _confs(n: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    confs = rng.uniform(-np.pi, np.pi, (n, 6)).astype(np.float32)
    confs[:, 0:3] = rng.uniform(-1.0, 1.0, (n, 3))
    return confs


def test_check_emits_its_steps_in_order_under_its_root(checker):
    confs = _confs(40)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = checker.check_valid_resolved(confs)
    np.testing.assert_array_equal(got, checker.check_valid_resolved(confs))
    [(root, children)] = _tree(prof)
    assert root == "rc.check"
    assert _names(children) == CHECK_STEPS
    assert all(not grand for _, grand in children)


def test_check_with_nonfinite_rows_emits_its_steps_once(checker):
    confs = _confs(40)
    confs[[3, 17], 1] = np.nan
    confs[29, 4] = -np.inf
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = checker.check_valid_resolved(confs)
    assert not got[3] and not got[17] and not got[29]
    [(root, children)] = _tree(prof)
    # The kernel answers the non-finite rows: one pass over the whole batch,
    # no nested second call on the finite rows.
    assert root == "rc.check"
    assert _names(children) == CHECK_STEPS
    assert all(not grand for _, grand in children)
    # check_packed alone has no root and no resolve step.
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        checker.check_packed(confs)
    assert _names(_tree(prof)) == PACKED_STEPS


def test_resolution_runs_under_its_span_before_the_fetch():
    """A flagged valid row (two triangles in one tilted plane, which float64
    finds intersecting): the twin's float64 pose (its three cos) lies inside
    ``rc.check.resolve``, K2's twin's inside ``rc.check.pose``, and the
    resolution ends before ``rc.check.fetch`` starts."""
    tris = np.array([[0, 1, 2]], np.int32)
    robot = Mesh(np.array([[-172.35173, 118.57849, -337.86478], [-168.62619, 71.0307, -215.03616],
                           [-280.98154, 165.06941, -53.021297]], np.float32), tris, "r")
    obstacle = Mesh(np.array([[-148.91972, 43.489243, -211.57489],
                              [-222.59364, 145.73175, -222.42876],
                              [-204.12267, 60.86192, -48.782146]], np.float32), tris, "o")
    face = MegaKernelChecker(robot, obstacle, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert not face.check_valid_resolved(np.zeros((1, 6), np.float32))[0]
    events = prof.profiler.function_events

    def ranges(name):
        return [(e.time_range.start, e.time_range.end) for e in events if e.name == name]

    [(lo, hi)] = ranges("rc.check.resolve")
    [(pose_lo, pose_hi)] = ranges("rc.check.pose")
    [(fetch_lo, _)] = ranges("rc.check.fetch")
    cos = ranges("aten::cos")
    inside = [(a, b) for a, b in cos if lo <= a and b <= hi]
    assert len(inside) == 3
    assert all(pose_lo <= a and b <= pose_hi for a, b in cos if (a, b) not in inside)
    assert hi <= fetch_lo


@pytest.mark.parametrize("compact", [False, True])
def test_chunked_check_emits_its_steps_in_order_with_each_pairs_steps_inside(compact):
    """A chunked ``check_valid_resolved`` is the root ``rc.chunked``:
    ``rc.chunked.broad`` (with ``compact`` only), ``rc.chunked.pairs``
    (holding each chunk pair's ``check_packed`` steps with ``compact``; by
    default the chunk pairs run on the device inside it, with no step of
    their own), ``rc.chunked.resolve`` and ``rc.chunked.fetch``;
    ``check_packed`` alone has no root."""
    ck = ChunkedMegaKernelChecker(icosphere(1, radius=0.3, name="r"), box(name="o"),
                                  device="cpu", max_obs_tris=4)
    assert ck.num_chunk_pairs == 3
    confs = _confs(40)
    confs[::4, 0] += 5.0  # rows that miss every chunk's box
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = ck.check_valid_resolved(confs, compact=compact)
    pairs_run = ck.counters()["pair_launches"]
    assert pairs_run == ck.num_chunk_pairs or (compact and 0 < pairs_run)
    np.testing.assert_array_equal(got, ck.check_valid_resolved(confs))
    [(root, children)] = _tree(prof)
    assert root == "rc.chunked"
    steps = ["rc.chunked.pairs", "rc.chunked.resolve", "rc.chunked.fetch"]
    assert _names(children) == (["rc.chunked.broad"] if compact else []) + steps
    pairs = children[-3][1]
    assert _names(pairs) == (PACKED_STEPS * pairs_run if compact else [])
    assert all(not grand for _, grand in pairs)
    assert all(not grand for name, grand in children if name != "rc.chunked.pairs")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ck.check_packed(confs, compact=compact)
    assert _names(_tree(prof)) == (["rc.chunked.broad", "rc.chunked.pairs"] if compact
                                   else ["rc.chunked.pairs", "rc.chunked.fetch"])


def _wave_engine():
    """Five blocks of points well inside a box obstacle: every block's box
    meets the obstacle's one group box, so every pair survives the bounds
    and 420 configurations need two waves."""
    rng = np.random.default_rng(11)
    points = rng.uniform(-0.2, 0.2, (4 * BLOCK + 1, 3)).astype(np.float32)
    return ClearanceEngine(points, box(extent=(4.0, 4.0, 4.0), name="o"), device="cpu")


def test_clearance_emits_one_exact_span_a_wave_and_counts_the_waves(monkeypatch):
    eng = _wave_engine()
    assert eng.num_blocks == 5
    rng = np.random.default_rng(12)
    confs = rng.uniform(-np.pi, np.pi, (420, 6)).astype(np.float32)
    confs[:, 0:3] = rng.uniform(-0.1, 0.1, (420, 3))
    runs = []
    run_pairs = eng._run_pairs

    def counted(rows, cfg_ids, *rest):
        runs.append(len(cfg_ids))
        return run_pairs(rows, cfg_ids, *rest)

    monkeypatch.setattr(eng, "_run_pairs", counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        d = eng.min_distances(confs)
    assert np.isfinite(d).all()
    [(root, children)] = _tree(prof)
    assert root == "rc.clearance"
    waves = sum(1 for k in runs if k)
    assert waves == eng.stats["waves"] == 2
    assert _names(children) == (["rc.clearance.upload", "rc.clearance.bounds"]
                                + ["rc.clearance.exact"] * waves)
    bounds = children[1][1]
    assert _names(bounds) == ["rc.clearance.reps"]
    assert _names(bounds[0][1]) == ["rc.clearance.fetch"]
    for _, exact in children[2:]:
        assert _names(exact) == ["rc.clearance.fetch", "rc.clearance.scatter"]
    # The counter counts calls that ran pairs only, over calls.
    eng.min_distances(confs[:4])
    assert eng.stats["waves"] == sum(1 for k in runs if k) == 3 and eng.stats["calls"] == 2


def test_no_span_is_entered_without_a_profiler(checker, monkeypatch):
    entered = []

    def counting(name):
        entered.append(name)
        return torch.autograd.profiler.record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    checker.check_valid_resolved(_confs(8))
    assert entered == []
    with timers.span("rc.test"):
        pass
    assert entered == [] and timers.span("a") is timers.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        checker.check_valid_resolved(_confs(8))
    assert entered == ["rc.check"] + CHECK_STEPS


@pytest.mark.card
def test_k1_records_lie_inside_their_calls_kernel_to_fetch_spans(tmp_path):
    """In a traced 100,000-row hard call, K1 is one record a call, which
    starts after its call's ``rc.check.kernel`` span starts and ends before
    its ``rc.check.fetch`` span ends: the host spans and the device records
    share one clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    robot = load_obj(assets.alpha_robot_path())
    checker = MegaKernelChecker(robot, load_obj(assets.alpha_obstacle_path()), device="cuda")
    confs = alpha_bot_configurations(robot, 100_000, hard=True, seed=2718281828)
    checker.check_valid_resolved(confs)
    torch.cuda.synchronize()
    with timers.trace(str(tmp_path)) as path:
        for _ in range(3):
            checker.check_valid_resolved(confs)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    host = [e for e in events if e.get("cat") == "user_annotation"]

    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == name)

    kernel, fetch = spans("rc.check.kernel"), spans("rc.check.fetch")
    assert len(kernel) == len(fetch) == 3
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")}
    k1 = [e for e in events if e.get("cat") == "kernel" and "megakernel" in e.get("name", "")]
    assert len(k1) == 3  # one K1 launch a call
    for e in k1:
        [call] = [i for i, (lo, hi) in enumerate(kernel)
                  if lo <= launch[e["args"]["correlation"]] <= hi]
        assert kernel[call][0] <= e["ts"] and e["ts"] + e["dur"] <= fetch[call][1]


@pytest.mark.card
def test_resolve_records_lie_inside_their_calls_resolve_to_fetch_spans(tmp_path):
    """In a traced 100,000-row hard call, the resolution is one kernel
    record a call, launched inside ``rc.check.resolve``, after the call's
    last K1 record and done before its ``rc.check.fetch`` span ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    robot = load_obj(assets.alpha_robot_path())
    checker = MegaKernelChecker(robot, load_obj(assets.alpha_obstacle_path()), device="cuda")
    confs = alpha_bot_configurations(robot, 100_000, hard=True, seed=2718281828)
    checker.check_valid_resolved(confs)
    torch.cuda.synchronize()
    with timers.trace(str(tmp_path)) as path:
        for _ in range(3):
            checker.check_valid_resolved(confs)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    host = [e for e in events if e.get("cat") == "user_annotation"]

    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == name)

    resolve, fetch = spans("rc.check.resolve"), spans("rc.check.fetch")
    assert len(resolve) == len(fetch) == 3
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    records = [e for e in kernels if "resolve_kernel" in e.get("name", "")]
    assert len(records) == 3
    k1_ends = [e["ts"] + e["dur"] for e in kernels if "megakernel" in e.get("name", "")]
    for e in records:
        [call] = [i for i, (lo, hi) in enumerate(resolve)
                  if lo <= launch[e["args"]["correlation"]] <= hi]
        before = [t for t in k1_ends if t <= e["ts"] and t >= resolve[call][0] - 1e5]
        assert before and e["ts"] + e["dur"] <= fetch[call][1]
