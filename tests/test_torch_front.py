"""The check's front end in the port (`kernels/front.py`, `csrc/front.cu`):
the pose rows (K2) and the robot box with the mesh-box broad phase (K5).

On the CPU the public functions (`megakernel.poses_from_confs`,
`robot_bounds`, `mesh_broad`) run their plain twins, which are held here
against the JAX package's jitted XLA on the same configurations, on the
adversarial rows of `io.datagen.adversarial_confs`. Rotation entries are
compared within POSE_ATOL (torch and XLA round sin / cos and the fused
products differently), copied entries bit for bit, boxes within the pose
tolerance times the corners' magnitude and broad-phase bits exactly away
from that tolerance of the obstacle box's faces. K5's vertex table
(`robot_vertices`) and its twin over it (`robot_bounds_vertices_reference`)
are held to the corner twin exactly: boxes as values, NaN for NaN, hit bits
identical. The CUDA kernels run only on the card: `chip_smoke.py` phase 14
holds them against these twins.
"""
import dataclasses

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robocheck_tpu.kernels import megakernel as jmk
from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.datagen import adversarial_confs
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.kernels import _build, chunked, front
from robocheck_tpu_torch.kernels import megakernel as mk
from robocheck_tpu_torch.models.shapes import triangle_soup

REPO = Path(__file__).resolve().parents[1]
# Pose entries (tests/test_torch_transform.py): torch and XLA round sin/cos
# to within an ulp of each other; 3e-7 ~ 2.5 ulp at 1.
POSE_ATOL = 3e-7


@pytest.fixture(scope="module")
def adversarial():
    return adversarial_confs()


@pytest.fixture(scope="module")
def alpha_prep():
    return mk.MegaKernelPrep.build(load_obj(assets.alpha_robot_path()),
                                   load_obj(assets.alpha_obstacle_path())).to("cpu")


def test_adversarial_rows_reach_every_family(adversarial):
    angles = adversarial[:, 3:6]
    assert adversarial.shape == (65536, 6) and adversarial.dtype == np.float32
    assert np.isfinite(adversarial).all()
    assert (np.signbit(angles) & (angles == 0)).any()  # -0.0
    tiny = np.abs(angles)
    assert ((tiny > 0) & (tiny < np.finfo(np.float32).tiny)).any()  # denormals
    assert (tiny > 1e30).any() and ((tiny > 1e3) & (tiny <= 1e4)).any()
    for special in (np.pi / 2, np.pi, np.pi / 4):
        assert np.isin(np.float32(special), angles) and np.isin(np.float32(-special), angles)


def test_pose_rows_match_jax_on_adversarial_rows(adversarial):
    ref = np.asarray(jax.jit(jmk.poses_from_confs)(jnp.asarray(adversarial)))
    got = mk.poses_from_confs(torch.from_numpy(adversarial)).numpy()
    assert got.shape == (len(adversarial), 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got, mk.poses_from_confs_reference(
        torch.from_numpy(adversarial)).numpy())
    np.testing.assert_allclose(got, ref, rtol=0, atol=POSE_ATOL)
    # Translations and the zero pad are copied, not computed: bit for bit.
    for col in (3, 7, 11, 12, 13, 14, 15):
        np.testing.assert_array_equal(got[:, col].view(np.int32), ref[:, col].view(np.int32))


# The alpha robot's chunks at MAX_ROB_TRIS = 256: four robot groups of 252
# triangles, each with the tables `ChunkedMegaKernelChecker` builds.
CHUNK_GROUPS = 4


@pytest.fixture(scope="module")
def robot_tables(alpha_prep):
    return _tables(alpha_prep)


def _tables(prep):
    """Robot tables (`MegaKernelPrep`s on the CPU with the alpha obstacle):
    the alpha robot's (Morton-ordered, padded to 1,024), its cuts to Tr
    1008 (its real triangles, no padding), 77 and 1, a one-triangle robot's
    padded table, an all-padding one and the robot groups of the alpha pair
    chunked at 256 robot triangles."""
    one = np.array([[0, 1, 2]], np.int32)
    tri = mk.MegaKernelPrep.build(Mesh(np.eye(3, dtype=np.float32), one),
                                  Mesh(np.eye(3, dtype=np.float32) + 0.5, one)).rob_base
    padding = prep.rob_base.clone()
    padding[9] = 0.0
    cuts = {"alpha": prep.rob_base, "tr1008": prep.rob_base[:, :1008],
            "tr77": prep.rob_base[:, :77], "tr1": prep.rob_base[:, :1],
            "one_triangle": torch.from_numpy(tri), "all_padding": padding}
    out = {k: dataclasses.replace(prep, rob_base=v).to("cpu") for k, v in cuts.items()}
    ck = chunked.ChunkedMegaKernelChecker(load_obj(assets.alpha_robot_path()),
                                          load_obj(assets.alpha_obstacle_path()), device="cpu",
                                          max_rob_tris=256)
    assert ck.num_chunk_pairs == CHUNK_GROUPS
    out.update({f"chunk_group{k}": c.tables for k, c in enumerate(ck.checkers)})
    return out


def _same_values(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal as values (-0.0 == +0.0, infinities included) or NaN in both."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _non_finite(confs: np.ndarray, seed: int = 14) -> np.ndarray:
    """``confs`` with NaN / +-inf in a sixteenth of each column's rows."""
    bad = np.array(confs)
    rng = np.random.default_rng(seed)
    for col in range(6):
        rows = rng.choice(len(bad), len(bad) // 16, replace=False)
        bad[rows, col] = rng.choice(np.float32([np.nan, np.inf, -np.inf]), len(rows))
    return bad


def _jax_bounds(confs, rob_base):
    rb = rob_base.numpy()
    pts = rb[0:9].T.reshape(-1, 3)
    mask = np.repeat(rb[9] > 0, 3)
    lo, hi = jmk._robot_bounds(jnp.asarray(confs), jnp.asarray(pts), jnp.asarray(mask))
    return np.concatenate([np.asarray(lo), np.asarray(hi)], axis=1), pts, mask


TABLES = ["alpha", "tr1008", "tr77", "tr1", "one_triangle", "all_padding",
          *(f"chunk_group{k}" for k in range(CHUNK_GROUPS))]


@pytest.mark.parametrize("table", TABLES)
def test_robot_bounds_and_broad_match_jax(table, adversarial, alpha_prep, robot_tables,
                                          hard10k):
    tables = robot_tables[table]
    rob_base, obs = tables.rob_base, alpha_prep.obs_mesh
    confs = np.concatenate([hard10k.confs[:2048], adversarial[:4096]])
    poses = mk.poses_from_confs(torch.from_numpy(confs))
    bounds = mk.robot_bounds(poses, tables).numpy()
    np.testing.assert_array_equal(bounds, mk.robot_bounds_reference(poses, rob_base).numpy())
    # K5's twin over the vertex table: the corner twin's values, NaN for NaN,
    # on these rows and on rows with NaN / +-inf entries (whose boxes reach
    # the padding's 3.0e38 fold or pass it where there is no padding).
    for rows in (poses, mk.poses_from_confs(torch.from_numpy(_non_finite(confs)))):
        corner = mk.robot_bounds_reference(rows, rob_base)
        vert = mk.robot_bounds_vertices_reference(rows, tables.rob_verts, tables.rob_padded)
        assert _same_values(vert, corner)
        assert torch.equal(mk.boxes_overlap(vert, obs[None])[0],
                           mk.mesh_broad_reference(rows, rob_base, obs))
    ref, pts, mask = _jax_bounds(confs, rob_base)
    if table == "all_padding":
        sentinel = np.float32([3.0e38] * 3 + [-3.0e38] * 3)
        np.testing.assert_array_equal(bounds, np.broadcast_to(sentinel, bounds.shape))
        np.testing.assert_array_equal(ref, bounds)
        return
    # Each posed coordinate is |r| <= 1 times three corner coordinates plus
    # t: the pose tolerance times the corners' magnitude, and the rounding
    # of the sums at the result's magnitude.
    scale = np.abs(pts[mask]).max()
    atol = 3 * POSE_ATOL * scale + 4 * np.spacing(np.abs(ref).max(axis=1, keepdims=True))
    assert (np.abs(bounds - ref) <= atol).all()
    vert = mk.robot_bounds_vertices_reference(poses, tables.rob_verts, tables.rob_padded)
    assert (np.abs(vert.numpy() - ref) <= atol).all()
    broad = mk.mesh_broad(poses, dataclasses.replace(tables, obs_mesh=obs)).numpy()
    np.testing.assert_array_equal(broad, mk.mesh_broad_reference(poses, rob_base, obs).numpy())
    j_broad = np.asarray(jmk._broad_overlap(jnp.asarray(confs), jnp.asarray(pts),
                                            jnp.asarray(mask), jnp.asarray(obs[:3].numpy()),
                                            jnp.asarray(obs[3:].numpy())))
    o = obs.numpy()
    margin = np.minimum(np.abs(bounds[:, :3] - o[3:]), np.abs(o[:3] - bounds[:, 3:])).min(1)
    clear = margin > atol[:, 0]
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(broad[clear], j_broad[clear])
    if table == "alpha":
        assert broad.any() and not broad.all()


def _corner_bits(rob_base: torch.Tensor) -> np.ndarray:
    """The real triangles' corners as int32 (X, Y, Z) rows, by numpy."""
    rb = rob_base.numpy()
    real = rb[9] > 0
    pts = np.stack([rb[3 * c : 3 * c + 3, real].T for c in range(3)]).reshape(-1, 3)
    return np.ascontiguousarray(pts, np.float32).view(np.int32)


@pytest.mark.parametrize("table", [*TABLES, "signed_zeros", "soup"])
def test_robot_vertices_are_the_distinct_real_corners(table, robot_tables):
    if table == "signed_zeros":
        # Two triangles sharing two corners, and corners equal as values
        # but for the sign of a zero: kept apart.
        rob_base = torch.zeros((10, 4))
        rob_base[0:9, 0] = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
        rob_base[0:9, 1] = torch.tensor([-0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
        rob_base[9, :2] = 1.0
        rob_base[0:9, 2] = 7.0  # a padding column's corners are dropped
    elif table == "soup":
        # No shared corners: three vertices a triangle (the vertex table of
        # a soup of 2,200 triangles spans two 4,096-vertex tiles of K5).
        soup = triangle_soup(np.random.default_rng(508), 2200, extent=1.0)
        rob_base = mk.MegaKernelPrep.build(soup, soup).to("cpu").rob_base
    else:
        rob_base = robot_tables[table].rob_base
    verts = mk.robot_vertices(rob_base)
    assert verts.dtype == torch.float32 and verts.is_contiguous()
    want = np.unique(_corner_bits(rob_base), axis=0)
    got = verts.T.contiguous().view(torch.int32).numpy()
    np.testing.assert_array_equal(got, want)  # sorted as int32 patterns: a fixed order
    assert torch.equal(mk.robot_vertices(rob_base).view(torch.int32), verts.view(torch.int32))
    expect = {"alpha": 792, "tr1008": 792, "tr1": 3, "one_triangle": 3, "all_padding": 0,
              "signed_zeros": 4, "soup": 6600}
    if table in expect:
        assert verts.shape == (3, expect[table])
    if table == "all_padding":
        box = mk.robot_bounds_vertices_reference(torch.zeros((2, 16)), verts)
        np.testing.assert_array_equal(box.numpy(), np.float32([[3.0e38] * 3 + [-3.0e38] * 3] * 2))


def test_broad_block_on_non_finite_rows(alpha_prep, hard10k):
    # broad_block takes rows as they are (check_packed filters non-finite
    # ones): a NaN or infinite entry gives NaN or infinite box entries, and
    # every comparison with NaN fails, so such a row is never a hit.
    robot, obstacle = load_obj(assets.alpha_robot_path()), load_obj(assets.alpha_obstacle_path())
    checker = mk.MegaKernelChecker(robot, obstacle, device="cpu")
    bad = np.array(hard10k.confs[:384])
    rng = np.random.default_rng(14)
    for col in range(6):
        rows = rng.choice(len(bad), 48, replace=False)
        bad[rows, col] = rng.choice(np.float32([np.nan, np.inf, -np.inf]), len(rows))
    finite = np.isfinite(bad).all(axis=1)
    assert 0 < finite.sum() < len(bad)
    got = checker.broad_block(bad).numpy()
    poses = mk.poses_from_confs_reference(torch.from_numpy(bad))
    rob_base = checker.tables.rob_base
    np.testing.assert_array_equal(got, mk.mesh_broad_reference(
        poses, rob_base, checker.tables.obs_mesh).numpy())
    assert not got[~finite & np.isnan(bad).any(axis=1)].any()
    np.testing.assert_array_equal(got[finite], checker.broad_block(bad[finite]).numpy())
    # NaN for NaN, and the infinities, against JAX's `_robot_bounds`.
    bounds = mk.robot_bounds(poses, checker.tables).numpy()
    ref, _, _ = _jax_bounds(bad, rob_base)
    vert = mk.robot_bounds_vertices_reference(poses, checker.tables.rob_verts,
                                              checker.tables.rob_padded)
    assert _same_values(vert, torch.from_numpy(bounds))
    np.testing.assert_array_equal(np.isnan(bounds), np.isnan(ref))
    np.testing.assert_array_equal(np.isinf(bounds), np.isinf(ref))
    np.testing.assert_array_equal(bounds[np.isinf(bounds)], ref[np.isinf(ref)])


def test_cpu_tensors_never_reach_the_build():
    # A fresh interpreter: every front-end route and the checker on CPU
    # tensors run the twins and never import the nvcc build module.
    code = (
        "import sys, numpy as np, torch\n"
        "from robocheck_tpu_torch import MegaKernelChecker, make_checker\n"
        "from robocheck_tpu_torch.io import assets\n"
        "from robocheck_tpu_torch.io.obj import load_obj\n"
        "from robocheck_tpu_torch.kernels import chunked, megakernel as mk\n"
        "from robocheck_tpu_torch.models.shapes import icosphere\n"
        "r, o = icosphere(1, 0.3), icosphere(2, 1.5)\n"
        "confs = np.random.default_rng(0).uniform(-2, 2, (16, 6)).astype(np.float32)\n"
        "ck = MegaKernelChecker(r, o, device='cpu')\n"
        "ck.check_valid(confs); ck.check_valid(confs, presort=True); ck.check(confs)\n"
        "ck.broad_block(confs)\n"
        "p = mk.poses_from_confs(torch.from_numpy(confs))\n"
        "mk.robot_bounds(p, ck.tables); mk.mesh_broad(p, ck.tables)\n"
        "big = chunked.ChunkedMegaKernelChecker(r, o, device='cpu', max_obs_tris=128)\n"
        "big.check_packed(confs, compact=True)\n"
        "assert 'robocheck_tpu_torch.kernels._build' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_wrappers_refuse_cpu_tensors(alpha_prep):
    poses = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        front.poses_from_confs_cuda(torch.zeros((4, 6)))
    with pytest.raises(ValueError, match="CUDA"):
        front.robot_bounds_cuda(poses, alpha_prep.rob_verts, padded=True)
    with pytest.raises(ValueError, match="CUDA"):
        front.robot_bounds_cuda(poses, alpha_prep.rob_verts, alpha_prep.obs_mesh, padded=True)
    assert front.poses_from_confs_cuda.launches == 0
    assert front.robot_bounds_cuda.launches == 0


def test_front_cu_declares_every_bound_entry():
    # Every entry `kernels/front.py` calls is bound in `_build.library` and
    # declared in `csrc/front.cu` with as many parameters as its argtypes.
    assert _build.SOURCES["front"] == REPO / "robocheck_tpu_torch" / "csrc" / "front.cu"
    src = _build.SOURCES["front"].read_text()
    extern = src[src.index('extern "C" {'):]
    declared = {name: len([a for a in args.split(",") if a.strip()])
                for name, args in re.findall(r"\n(?:int|const char\*) (rc_\w+)\(([^)]*)\)",
                                             extern)}
    build_src = Path(_build.__file__).read_text()
    block = build_src[build_src.index('elif name == "front":'):]
    block = block[:block.index("return lib")]
    bound = {name: len([a for a in args.split(",") if a.strip()])
             for name, args in re.findall(r"_bind\(lib\.(rc_\w+), [\w.]+, \[([^\]]*)\]", block)}
    called = set(re.findall(r"lib\.(rc_\w+)", Path(front.__file__).read_text()))
    assert called and called <= set(bound)
    assert bound == declared
    assert {"rc_pose_rows", "rc_robot_bounds", "rc_front_error_string"} <= set(declared)
    # K5 takes the vertex table and its corner table's padding flag, not the
    # corner table; its rows per warp are fixed when it is built.
    params = re.search(r"\nint rc_robot_bounds\(([^)]*)\)", extern).group(1)
    names = [a.split()[-1].lstrip("*") for a in params.split(",")]
    assert names == ["poses", "n", "verts", "nv", "padded", "obs_box", "out_box", "out_hit",
                     "stream"]
    assert re.search(r"\n#define RC_BOX_ROWS ([1-4])\n", src)
