"""Host layer of the PyTorch port (`robocheck_tpu_torch`): its copies of the
numpy modules give arrays identical to `robocheck_tpu`'s on the same inputs,
and the port never imports JAX."""
import os
import subprocess
import sys

import numpy as np
import pytest

from robocheck_tpu.io import assets as j_assets
from robocheck_tpu.io import byu as j_byu
from robocheck_tpu.io import datagen as j_datagen
from robocheck_tpu.io import parasol as j_parasol
from robocheck_tpu.io.conf import read_conf_file as j_read_conf
from robocheck_tpu.io.obj import load_obj as j_load_obj
from robocheck_tpu.models import shapes as j_shapes
from robocheck_tpu.oracle import cpu_oracle as j_oracle
from robocheck_tpu.utils.morton import morton_argsort as j_morton
from robocheck_tpu_torch.core.types import Mesh, validate_confs
from robocheck_tpu_torch.io import assets, byu, datagen, parasol
from robocheck_tpu_torch.io.conf import read_conf_file, write_conf_file
from robocheck_tpu_torch.io.obj import load_obj, save_obj
from robocheck_tpu_torch.models import shapes
from robocheck_tpu_torch.oracle import cpu_oracle, resolve_coplanar
from robocheck_tpu_torch.utils.morton import morton_argsort

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    # A fresh interpreter: the package, its kernels, chunked, planner (with the
    # distance grid, clearance engine, certifier and gradient planners), io,
    # runtime, profiling, pipeline and sharding modules, `torch_graft_entry` and
    # the entry-point scripts (their imports, not main()) load torch and numpy
    # only, never jax or the JAX package.
    code = ("import sys, runpy; import robocheck_tpu_torch; "
            "import robocheck_tpu_torch.kernels.megakernel; "
            "import robocheck_tpu_torch.kernels._build; "
            "import robocheck_tpu_torch.oracle; "
            "import robocheck_tpu_torch.profiling.bounds; "
            "import robocheck_tpu_torch.profiling.counters; "
            "import robocheck_tpu_torch.profiling.timers; "
            "import robocheck_tpu_torch.profiling.probes; "
            "import robocheck_tpu_torch.kernels.chunked; "
            "import robocheck_tpu_torch.planner; "
            "import robocheck_tpu_torch.planner.knn; "
            "import robocheck_tpu_torch.planner.sdf, robocheck_tpu_torch.planner.clearance; "
            "import robocheck_tpu_torch.planner.ccd, robocheck_tpu_torch.kernels.clearance; "
            "import robocheck_tpu_torch.kernels.sdf; "
            "import robocheck_tpu_torch.io.datagen, robocheck_tpu_torch.io.parasol; "
            "import robocheck_tpu_torch.io.byu; "
            "import robocheck_tpu_torch.planner.trajopt, robocheck_tpu_torch.planner.sqp; "
            "import robocheck_tpu_torch.runtime.checkpoint; "
            "from robocheck_tpu_torch.planner import plan_and_smooth; "
            "import robocheck_tpu_torch.ops.pipeline, robocheck_tpu_torch.parallel.sharding; "
            "import robocheck_tpu_torch.runtime.distributed; import torch_graft_entry; "
            "[runpy.run_path(f'scripts/{n}.py', run_name='imported') for n in "
            "('torch_run_integration', 'torch_roofline', 'torch_bisect', 'torch_profile', "
            "'torch_k1_compare', 'torch_gate_study', 'torch_demo_planner', "
            "'torch_bench_chunked', 'torch_certify_alpha', 'torch_clearance_study', "
            "'torch_multihost_worker', 'torch_bench_scaling', 'torch_bench', "
            "'torch_make_datasets', 'torch_tile_sweep', 'torch_front_compare', "
            "'torch_grid_compare', 'torch_span_idle')]; "
            "runpy.run_path('chip_smoke.py', run_name='imported'); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'robocheck_tpu' or m.startswith('robocheck_tpu.')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("which", ["robot", "obstacle"])
def test_alpha_mesh_identical(which):
    path = getattr(assets, f"alpha_{which}_path")()
    assert path == getattr(j_assets, f"alpha_{which}_path")()
    mine, ref = load_obj(path), j_load_obj(path)
    np.testing.assert_array_equal(mine.vertices, ref.vertices)
    np.testing.assert_array_equal(mine.triangles, ref.triangles)
    assert mine.vertices.dtype == np.float32 and mine.triangles.dtype == np.int32
    np.testing.assert_array_equal(mine.aabb, ref.aabb)


@pytest.mark.parametrize("key", ["hard10k", "easy10k", "samples10k"])
def test_conf_reader_identical(key):
    path = assets.dataset_path(key)
    mine, ref = read_conf_file(path), j_read_conf(path)
    np.testing.assert_array_equal(mine.confs, ref.confs)
    np.testing.assert_array_equal(mine.valid, ref.valid)
    assert (mine.header_valid, mine.header_invalid) == (ref.header_valid,
                                                        ref.header_invalid)
    assert mine.tags_match_header == ref.tags_match_header


def test_conf_and_obj_roundtrip(tmp_path, rng):
    confs = rng.normal(size=(16, 6)).astype(np.float32)
    valid = rng.random(16) > 0.5
    write_conf_file(tmp_path / "c.conf", confs, valid)
    back = j_read_conf(tmp_path / "c.conf")
    np.testing.assert_allclose(back.confs, confs, rtol=1e-5)
    np.testing.assert_array_equal(back.valid, valid)
    mesh = shapes.icosphere(1)
    save_obj(mesh, tmp_path / "m.obj")
    np.testing.assert_array_equal(load_obj(tmp_path / "m.obj").triangles,
                                  j_load_obj(tmp_path / "m.obj").triangles)


def test_morton_argsort_identical(rng):
    pts = rng.normal(size=(5000, 3)) * np.array([1.0, 10.0, 0.1])
    np.testing.assert_array_equal(morton_argsort(pts), j_morton(pts))
    # Degenerate axis (zero span) and duplicates.
    flat = np.concatenate([pts[:100], pts[:100]]) * np.array([1.0, 0.0, 1.0])
    np.testing.assert_array_equal(morton_argsort(flat), j_morton(flat))


@pytest.mark.parametrize("name,args", [
    ("tetrahedron", {}), ("tetrahedron", {"scale": 1.0e4}),
    ("box", {"extent": (2.0, 2.0, 2.0)}), ("icosphere", {"subdivisions": 2}),
])
def test_shapes_identical(name, args):
    mine, ref = getattr(shapes, name)(**args), getattr(j_shapes, name)(**args)
    np.testing.assert_array_equal(mine.vertices, ref.vertices)
    np.testing.assert_array_equal(mine.triangles, ref.triangles)


def test_cpu_oracle_identical(hard10k):
    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    j_robot = j_load_obj(assets.alpha_robot_path())
    j_obstacle = j_load_obj(assets.alpha_obstacle_path())
    confs = hard10k.confs[:32]
    mine = cpu_oracle.check_configs(robot, obstacle, confs)
    np.testing.assert_array_equal(mine, j_oracle.check_configs(j_robot, j_obstacle, confs))
    np.testing.assert_array_equal(mine, hard10k.valid[:32])


def test_tri_tri_and_transform_f64_identical(rng):
    t1 = rng.normal(size=(256, 3, 3))
    t2 = t1 + rng.normal(scale=0.5, size=(256, 3, 3))
    np.testing.assert_array_equal(cpu_oracle.tri_tri_intersect(t1, t2),
                                  j_oracle.tri_tri_intersect(t1, t2))
    conf = rng.normal(size=6)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(cpu_oracle.transform_vertices_f64(conf, v),
                                  j_oracle.transform_vertices_f64(conf, v))


def test_resolve_coplanar_keeps_invalid_and_clean_rows():
    tris = np.array([[0, 1, 2]], np.int32)
    robot = Mesh(np.eye(3, dtype=np.float32), tris)
    valid = np.array([False, True])
    cop = np.array([True, False])
    out = resolve_coplanar(robot, robot, np.zeros((2, 6), np.float32), valid, cop)
    np.testing.assert_array_equal(out, [False, True])
    # Nothing flagged: the input array comes back untouched.
    assert resolve_coplanar(robot, robot, np.zeros((2, 6), np.float32), valid,
                            np.zeros(2, bool)) is valid


def test_mesh_and_conf_validation():
    with pytest.raises(ValueError):
        Mesh(np.zeros((4, 2), np.float32), np.zeros((1, 3), np.int32))
    with pytest.raises(ValueError):
        validate_confs(np.zeros((3, 5)))
    assert validate_confs(np.zeros((3, 6), np.float64)).dtype == np.float32


@pytest.mark.parametrize("hard", [True, False])
def test_datagen_identical(hard):
    robot = load_obj(assets.alpha_robot_path())
    mine = datagen.alpha_bot_configurations(robot, 257, hard=hard, seed=11)
    ref = j_datagen.alpha_bot_configurations(j_load_obj(assets.alpha_robot_path()), 257,
                                             hard=hard, seed=11)
    assert mine.dtype == np.float32 and mine.shape == (257, 6)
    np.testing.assert_array_equal(mine, ref)
    box = ((-1.0, 2.0), (0.0, 5.0), (-3.0, -1.0))
    np.testing.assert_array_equal(datagen.generate_confs(np.random.default_rng(3), 64, *box),
                                  j_datagen.generate_confs(np.random.default_rng(3), 64, *box))


def test_parasol_identical():
    query = assets.find_asset("models/alpha1.0/alpha.query")
    mine = parasol.read_query(query)
    assert mine.shape == (2, 6)
    np.testing.assert_array_equal(mine, j_parasol.read_query(query))
    env = assets.find_asset("models/alpha1.0/alpha.env")
    mine_env, ref_env = parasol.read_env(env), j_parasol.read_env(env)
    np.testing.assert_array_equal(mine_env.boundary, ref_env.boundary)
    assert (mine_env.active_meshes, mine_env.passive_meshes) == (
        ref_env.active_meshes, ref_env.passive_meshes) == (("robot.obj",), ("obstacle.obj",))


def test_byu_identical(tmp_path):
    # One quad (a fan of two triangles) and one triangle, two parts.
    g = tmp_path / "m.g"
    g.write_text("2 5 2 7\n1 1\n2 2\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n0.5 0.5 1\n"
                 "1 2 3 -4\n1 2 -5\n")
    mine, ref = byu.load_byu(g), j_byu.load_byu(g)
    np.testing.assert_array_equal(mine.vertices, ref.vertices)
    np.testing.assert_array_equal(mine.triangles, ref.triangles)
    assert mine.num_triangles == 3 and mine.name == ref.name == "m"
    byu.byu_to_obj(g, tmp_path / "m.obj")
    np.testing.assert_array_equal(j_load_obj(tmp_path / "m.obj").triangles, ref.triangles)
