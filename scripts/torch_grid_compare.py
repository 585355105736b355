#!/usr/bin/env python3
"""K4's design on one CUDA card: the culled kernel the package builds against
the full scan before the cull (an older copy of `csrc/clearance.cu`) and
against copies of the package's source at other brick shapes, ring depths
and resident blocks, all timed in turns in one process.

    mkdir -p build/grid_old
    git show 548e05c:robocheck_tpu_torch/csrc/clearance.cu > build/grid_old/clearance.cu
    python3 scripts/torch_grid_compare.py [--old build/grid_old/clearance.cu]
                                          [--variants 8,8,4/2,4,4/2 ...]
                                          [--res 64 96] [--res16 32 64] [--res256 32]
                                          [--reps 10]

``--old`` is a copy of clearance.cu whose `rc_sdf_grid` has the full
scan's C interface (ax, ay, az, nx, ny, nz, gtab, nt, signed_, dx, dy, dz,
out, stream): every node against every triangle, one node a thread over
256-triangle tiles. A variant is "BX,BY,BZ/WX,WY,WZ/RING[/MIN]": the culled
kernel with a block brick of BX x BY x BZ nodes, warp bricks of WX x WY x
WZ, RING shared-memory slots and MIN blocks an SM in its launch bounds
(`RC_GRID_BX` ... `RC_GRID_MIN_BLOCKS`, defined before the source). Every
copy is built with the package's nvcc flags into `build/grid_variants/`,
all at once (`kernels/_build.build_copies`). The runs go old, shipped, the
rest of the variants, shipped, old: the shipped build and the old one are
each timed twice, first and last, so that the drift shows. For each run it
prints one JSON line: the ptxas register and spill lines of both
`grid_kernel` instances, whether its grids equal the package's as float32
bits (they must: no build reorders arithmetic), its kept (warp, group)
distance and ray scans (the culled builds'), and K4's device ms by CUDA
events (a launch takes ms) on the alpha obstacle at each ``--res``, on its
16x subdivision (`planner/ccd.subdivide_mesh(obstacle, 2)`, 16,128
triangles) at each ``--res16`` and on its 256x one (258,048 triangles,
whose groups a block's shared memory does not hold) at each ``--res256``,
signed, with the card's name and power limit. Imports neither JAX nor the
JAX package.
"""
import argparse
import ctypes
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robocheck_tpu_torch import load_obj  # noqa: E402
from robocheck_tpu_torch.io import assets  # noqa: E402
from robocheck_tpu_torch.kernels import _build  # noqa: E402
from robocheck_tpu_torch.kernels import sdf as ks  # noqa: E402
from robocheck_tpu_torch.planner.ccd import subdivide_mesh  # noqa: E402
from robocheck_tpu_torch.planner.sdf import grid_inputs  # noqa: E402
from robocheck_tpu_torch.profiling.timers import card_line, event_ms  # noqa: E402

SHIPPED = "shipped"
OLD = "old"
VARIANTS = ["8,8,4/2,4,4/4", "4,8,8/2,4,4/4", "16,4,4/2,4,4/4", "4,4,16/2,4,4/4",
            "8,4,8/4,2,4/4", "8,4,8/2,4,4/2", "8,4,8/2,4,4/3", "8,4,8/2,4,4/8", "8,4,8/2,4,4/4/4"]
_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


def variant_defines(spec: str) -> str:
    """The macros a variant defines before the source."""
    parts = spec.split("/")
    block, warp = ([int(x) for x in p.split(",")] for p in parts[:2])
    ring, minb = int(parts[2]), int(parts[3]) if len(parts) > 3 else None
    if (len(block) != 3 or len(warp) != 3 or np.prod(block) != 256 or np.prod(warp) != 32
            or any(b % w for b, w in zip(block, warp)) or not 2 <= ring <= 8):
        raise ValueError(f"variant {spec}: need a 256-node block brick tiled by 32-node warp "
                         "bricks and a ring of 2-8 slots")
    names = ("BX", "BY", "BZ", "WX", "WY", "WZ", "RING") + (("MIN_BLOCKS",) if minb else ())
    values = (*block, *warp, ring) + ((minb,) if minb else ())
    return "".join(f"#define RC_GRID_{n} {v}\n" for n, v in zip(names, values))


def variant_libraries(specs: list[str], old: Path | None) -> dict[str, tuple[ctypes.CDLL, str]]:
    """{spec: (library, nvcc log)}: copies of clearance.cu with the
    variant's macros defined first, and ``old`` as it is, compiled at once,
    K4's entries bound (the old one with the full scan's signature)."""
    out_dir = REPO / "build" / "grid_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = _build.SOURCES["clearance"].read_text()
    sources = {}
    for spec in specs:
        name = "clearance_" + "".join(c if c.isalnum() else "_" for c in spec)
        sources[spec] = out_dir / f"{name}.cu"
        sources[spec].write_text(variant_defines(spec) + text)
    if old is not None:
        sources[OLD] = out_dir / "clearance_old.cu"
        sources[OLD].write_text(old.read_text())
    _build.build_copies(sources.values())
    libs = {}
    for spec, src in sources.items():
        path = _build.copy_path(src.resolve())
        lib = ctypes.CDLL(str(path))
        lib.rc_sdf_grid.restype = _I32
        if spec == OLD:
            lib.rc_sdf_grid.argtypes = [_PTR, _PTR, _PTR, _I32, _I32, _I32, _PTR, _I32, _I32,
                                        _F32, _F32, _F32, _PTR, _PTR]
        else:
            lib.rc_sdf_grid.argtypes = [_PTR, _PTR, _PTR, _I32, _I32, _I32, _PTR, _I32, _PTR,
                                        _PTR, _PTR, _I32, _F32, _I32, _F32, _F32, _F32, _PTR,
                                        _PTR, _PTR, _I64, _PTR]
            lib.rc_sdf_grid_scratch_bytes.restype = _I64
            lib.rc_sdf_grid_scratch_bytes.argtypes = [_I32, _I32, _I32, _I32]
        libs[spec] = lib, path.with_suffix(".log").read_text()
    return libs


def launch(lib, old: bool, axes, table, cull, counts=None) -> torch.Tensor:
    """One signed launch of a copy's K4 (the package's wrapper's checks
    aside)."""
    out = torch.empty(tuple(a.shape[0] for a in axes), dtype=torch.float32, device=table.device)
    stream = torch.cuda.current_stream().cuda_stream
    ray = (float(x) for x in ks.RAY_DIR)
    if old:
        err = lib.rc_sdf_grid(*(a.data_ptr() for a in axes), *out.shape, table.data_ptr(),
                              table.shape[0], 1, *ray, out.data_ptr(), stream)
    else:
        ng = cull.boxes.shape[0]
        need = lib.rc_sdf_grid_scratch_bytes(*out.shape, ng)
        scratch = torch.empty(max(need, 0), dtype=torch.uint8, device=table.device)
        err = lib.rc_sdf_grid(*(a.data_ptr() for a in axes), *out.shape, table.data_ptr(),
                              table.shape[0], cull.boxes.data_ptr(), cull.always.data_ptr(),
                              cull.ray_slack.data_ptr(), ng, float(cull.slack), 1, *ray,
                              out.data_ptr(), None if counts is None else counts.data_ptr(),
                              scratch.data_ptr() if need > 0 else None, need, stream)
    if err:
        raise RuntimeError(f"rc_sdf_grid of a copy failed: cudaError {err}")
    return out


def grid_ptxas(log: str) -> list[str]:
    """The register and spill lines of `grid_kernel`'s instances in an
    nvcc -Xptxas -v log."""
    lines, in_grid = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            in_grid = "grid_kernel" in line
        elif in_grid and ("spill" in line or "registers" in line):
            lines.append(line.strip())
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="a clearance.cu whose rc_sdf_grid is the full scan")
    ap.add_argument("--variants", nargs="*", default=VARIANTS,
                    help="BX,BY,BZ/WX,WY,WZ/RING[/MIN] per variant")
    ap.add_argument("--res", type=int, nargs="*", default=[64, 96])
    ap.add_argument("--res16", type=int, nargs="*", default=[32, 64])
    ap.add_argument("--res256", type=int, nargs="*", default=[32])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_grid_compare: no CUDA device")
    card = card_line()
    device = torch.device("cuda", 0)
    shipped_log = _build.build()["clearance"][1]
    specs = list(dict.fromkeys(args.variants))
    libs = {SHIPPED: (None, shipped_log), **variant_libraries(specs, args.old)}
    obstacle = load_obj(assets.alpha_obstacle_path())
    scenes = {**{f"alpha {r}^3": grid_inputs(obstacle, r, device=device) for r in args.res},
              **{f"16x {r}^3": grid_inputs(subdivide_mesh(obstacle, 2), r, device=device)
                 for r in args.res16},
              **{f"256x {r}^3": grid_inputs(subdivide_mesh(obstacle, 4), r, device=device)
                 for r in args.res256}}
    want = {name: ks.sdf_grid_cuda(s["axes"], s["table"], s["cull"])
            for name, s in scenes.items()}
    ends = [OLD] if args.old is not None else []
    ok = True
    for spec in [*ends, SHIPPED, *specs, SHIPPED, *ends]:
        lib, log = libs[spec]

        def run(s, counts=None, lib=lib, spec=spec):
            if lib is None:
                return ks.sdf_grid_cuda(s["axes"], s["table"], s["cull"], counts=counts)
            return launch(lib, spec == OLD, s["axes"], s["table"], s["cull"], counts)

        same, kept, ms = True, {}, {}
        for name, s in scenes.items():
            counts = torch.zeros(2, dtype=torch.int32, device=device)
            got = run(s, counts)
            same = same and torch.equal(got.view(torch.int32), want[name].view(torch.int32))
            kept[name] = counts.tolist() if spec != OLD else None
            ms[name] = event_ms(lambda s=s: run(s), args.reps)
        print(json.dumps({"variant": spec, "bit_equal_to_shipped": same, "kernel_ms": ms,
                          "kept_scans": kept, "ptxas": grid_ptxas(log), "card": card}),
              flush=True)
        ok = ok and same
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
