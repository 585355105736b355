"""Two gloo ranks of the port on the CPU: two OS processes of
`scripts/torch_multihost_worker.py`, joined through
`runtime.distributed.initialize_from_env` (a localhost coordinator), as
`tests/test_distributed.py` runs the JAX package's two processes.

Each rank reads only its rows of hard10k[:256] (`shard_bounds`) and checks
them with `ShardedChecker.check_valid_distributed`: the verdicts must equal
the goldens. The worker's small scenes, run under the two-rank mesh, are
held to a world of 1 here (the sharded checker's verdicts and totals and the
engine's distances exactly; the SQP's blocks within the tolerances of
`tests/test_torch_sqp.py`: rtol 2e-5 / atol 1e-6 on g, rtol 2e-4 / atol 1e-5
on J, the penalty total rel 1e-5 as its merit, since the all-reduce sums the
ranks' partial totals in another order) and to the JAX package (its
`ShardedChecker` on an 8-device mesh, in interpret mode; its single-device
SQP blocks). `torch_graft_entry.py --cpu` runs the dryrun over two spawned
ranks.
"""
import os
import runpy
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robocheck_tpu.models.shapes import box as j_box
from robocheck_tpu.models.shapes import icosphere as j_icosphere
from robocheck_tpu.parallel.sharding import ShardedChecker as JShardedChecker
from robocheck_tpu.parallel.sharding import make_mesh as j_make_mesh
from robocheck_tpu.planner import sdf as j_sdf
from robocheck_tpu.planner import sqp as j_sqp
from robocheck_tpu_torch.kernels.megakernel import MegaKernelChecker
from robocheck_tpu_torch.planner.clearance import ClearanceEngine
from robocheck_tpu_torch.runtime.distributed import free_port

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "scripts" / "torch_multihost_worker.py"
W = runpy.run_path(str(WORKER), run_name="imported")
N = 256
TIMEOUT = 300  # seconds, each subprocess


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' logs, verdict shards and small-scene results."""
    tmp = tmp_path_factory.mktemp("ranks")
    port = free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({"COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "NUM_PROCESSES": "2",
                    "PROCESS_ID": str(pid), "OMP_NUM_THREADS": "2"})
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), "--device", "cpu", "--dataset", "hard10k",
             "--n", str(N), "--out", str(tmp / f"v{pid}.npy"),
             "--scenes", str(tmp / f"s{pid}.npz")],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log}"
    return (logs, [np.load(tmp / f"v{pid}.npy") for pid in range(2)],
            [dict(np.load(tmp / f"s{pid}.npz")) for pid in range(2)])


def test_two_process_distributed_matches_goldens(two_ranks, hard10k):
    logs, shards, _ = two_ranks
    assert '"process_count": 2' in logs[0] and '"backend": "gloo"' in logs[0]
    assert '"rows": [0, 128]' in logs[0] and '"rows": [128, 256]' in logs[1]
    valid = np.concatenate(shards)
    assert valid.shape == (N,)
    np.testing.assert_array_equal(valid, hard10k.valid[:N])


def test_ranks_agree(two_ranks):
    # Every gathered or all-reduced result is the same on both ranks.
    _, _, (s0, s1) = two_ranks
    assert s0.keys() == s1.keys()
    for key in s0:
        np.testing.assert_array_equal(s0[key], s1[key], err_msg=key)


def test_two_rank_checker_matches_world_of_one(two_ranks):
    s = two_ranks[2][0]
    robot, obstacle, confs = W["sphere_scene"]()
    single = MegaKernelChecker(robot, obstacle, device="cpu")
    for name, want in zip(("valid", "coplanar", "num_pairs", "broad"),
                          single.check(confs, two_phase=False)):
        np.testing.assert_array_equal(s[f"sphere_{name}"], want, err_msg=name)
    block = single.check_block(confs).numpy()
    np.testing.assert_array_equal(s["sphere_block"], block)
    np.testing.assert_array_equal(s["sphere_totals"], [block[:, 0].sum(),
                                                       (1 - block[:, 0]).sum(),
                                                       block[:, 1].sum()])
    # 37 rows: a batch the world size does not divide.
    np.testing.assert_array_equal(s["sphere_packed37"], single.check_packed(confs[:37]))


def test_two_rank_checker_matches_jax_sharded(two_ranks):
    s = two_ranks[2][0]
    _, _, confs = W["sphere_scene"]()
    ref = JShardedChecker(j_icosphere(1, 1.0, name="robot"),
                          j_icosphere(1, 1.5, name="obstacle"), mesh=j_make_mesh(8),
                          interpret=True)
    v, c, n, b = ref.check(confs)
    np.testing.assert_array_equal(s["sphere_valid"], v)
    np.testing.assert_array_equal(s["sphere_broad"], b)
    # JAX's check_block takes a multiple of 256 rows: the 64 rows 4 times.
    assert ref._block_multiple == 4 * len(confs)
    _, totals = ref.check_block(np.tile(confs, (4, 1)))
    np.testing.assert_array_equal(4 * s["sphere_totals"], np.asarray(totals))


def test_two_rank_engine_bit_equal(two_ranks):
    s = two_ranks[2][0]
    verts, obstacle, queries = W["engine_scene"]()
    eng = ClearanceEngine(verts, obstacle, device="cpu")
    assert eng.num_blocks == 3
    d = eng.min_distances(queries)
    np.testing.assert_array_equal(s["engine_dist"], d)
    assert int(s["engine_pairs"]) == eng.stats["pairs"] > 0


def _jax_sqp(opt):
    """JAX's single-device optimizer on the port's grid (the same surface
    samples: both packages draw them with one numpy function and seed)."""
    g = opt.grid
    grid = j_sdf.DistanceGrid(jnp.asarray(g.values.numpy()), jnp.asarray(g.origin.numpy()),
                              jnp.asarray(g.spacing.numpy()))
    ref = j_sqp.SQPOptimizer(j_box(extent=(0.3, 0.3, 0.3)), j_icosphere(1, radius=0.6),
                             j_sqp.SQPConfig(**opt.cfg.__dict__), grid=grid, checker=object())
    np.testing.assert_array_equal(np.asarray(ref._samples), opt._samples.numpy())
    return ref


def test_two_rank_sqp_blocks(two_ranks):
    s = two_ranks[2][0]
    opt, q = W["sqp_scene"]("cpu")
    g, J, tot = opt._constraint_blocks(torch.from_numpy(q))
    scale = max(1.0, float(np.abs(q[:, :3]).max()) + 0.3)
    ref = _jax_sqp(opt)
    for want_g, want_J in ((g.numpy(), J.numpy()),
                           (np.asarray(ref._residuals(jnp.asarray(q))),
                            np.asarray(ref._jacobians(jnp.asarray(q))))):
        np.testing.assert_allclose(s["sqp_g"], want_g, rtol=2e-5, atol=1e-6 * scale)
        np.testing.assert_allclose(s["sqp_J"], want_J, rtol=2e-4, atol=1e-5 * scale)
    assert float(s["sqp_total"]) == pytest.approx(tot, rel=1e-5)
    assert float(s["sqp_penalty"]) == pytest.approx(tot, rel=1e-5)
    assert tot > 0  # the straight line passes through the ball
    res = opt.plan(W["SQP_START"], W["SQP_GOAL"])
    assert (bool(s["sqp_certified"]), int(s["sqp_outer"])) == (res.certified, res.outer_iters)
    assert float(s["sqp_merit"]) == pytest.approx(res.merit, rel=1e-5)
    np.testing.assert_allclose(s["sqp_traj"], res.trajectory, rtol=0, atol=1e-5)


def test_dryrun_multichip_two_cpu_ranks():
    env = dict(os.environ, DRYRUN_DEVICES="2", OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, str(REPO / "torch_graft_entry.py"), "--cpu"],
                         env=env, cwd=str(REPO), capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "entry ok: (64, 8)" in out.stdout
    assert "dryrun_multichip(2): ok" in out.stdout and "golden=checked" in out.stdout
