#!/usr/bin/env python3
"""K4's geometry on one CUDA card: copies of `csrc/clearance.cu` at other
nodes per thread and triangles per shared-memory tile, timed against the
package's build on the alpha obstacle's grids.

    python3 scripts/torch_grid_compare.py [--variants 1,1024 2,1024 4,1024 2,512 2,2048]
                                          [--res 64 96] [--reps 10]

A variant N,T defines `RC_GRID_NODES` (nodes a thread holds) and
`RC_GRID_TILE` (triangles staged at once) before the source; every copy is
built with the package's nvcc flags into `build/grid_variants/`, all at once
(`kernels/_build.build_copies`). For each variant, and for the package's
build first and last (the drift between the two), it prints one JSON line:
the ptxas registers and spill lines of both `grid_kernel` instances, whether
its grids equal the package's as float32 bits on every resolution (they
must: the variants reorder no arithmetic), and K4's device ms by trace
(`timers.kernel_ms`) at each ``--res`` on the alpha obstacle, signed and
unsigned, with the card's name and power limit. Imports neither JAX nor the
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
from robocheck_tpu_torch.planner.sdf import grid_axes  # noqa: E402
from robocheck_tpu_torch.profiling.timers import card_line, kernel_ms  # noqa: E402

SHIPPED = "shipped"
VARIANTS = ["1,1024", "2,1024", "4,1024", "2,512", "2,2048"]


def variant_libraries(specs: list[str]) -> dict[str, tuple[ctypes.CDLL, str]]:
    """{spec: (library, nvcc log)}: copies of clearance.cu with the
    variant's geometry defined first, compiled at once, K4's entry bound."""
    out_dir = REPO / "build" / "grid_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = _build.SOURCES["clearance"].read_text()
    sources = {}
    for spec in specs:
        nodes, tile = (int(x) for x in spec.split(","))
        if not (1 <= nodes <= 8 and 1 <= tile and tile * ks.ROW * 4 <= 227 * 1024):
            raise ValueError(f"variant {spec}: need 1-8 nodes and a tile within 227 KB")
        sources[spec] = out_dir / f"clearance_n{nodes}_t{tile}.cu"
        sources[spec].write_text(f"#define RC_GRID_NODES {nodes}\n#define RC_GRID_TILE {tile}\n"
                                 + text)
    _build.build_copies(sources.values())
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for spec, src in sources.items():
        path = _build.copy_path(src.resolve())
        lib = ctypes.CDLL(str(path))
        lib.rc_sdf_grid.restype = i32
        lib.rc_sdf_grid.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr, i32, i32, f32, f32, f32,
                                    ptr, ptr]
        libs[spec] = lib, path.with_suffix(".log").read_text()
    return libs


def launch(lib, axes, table, signed: bool) -> torch.Tensor:
    """One launch of a copy's K4 (the package's wrapper's checks aside)."""
    out = torch.empty(tuple(a.shape[0] for a in axes), dtype=torch.float32, device=table.device)
    err = lib.rc_sdf_grid(*(a.data_ptr() for a in axes), *out.shape, table.data_ptr(),
                          table.shape[0], int(signed), *(float(x) for x in ks.RAY_DIR),
                          out.data_ptr(), torch.cuda.current_stream().cuda_stream)
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
    ap.add_argument("--variants", nargs="+", default=VARIANTS, help="nodes,tile per variant")
    ap.add_argument("--res", type=int, nargs="+", default=[64, 96])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_grid_compare: no CUDA device")
    card = card_line()
    device = torch.device("cuda", 0)
    shipped_log = _build.build()["clearance"][1]
    libs = {SHIPPED: (None, shipped_log), **variant_libraries(list(dict.fromkeys(args.variants)))}
    obstacle = load_obj(assets.alpha_obstacle_path())
    tris = torch.from_numpy(obstacle.triangle_vertices.astype(np.float32).reshape(-1, 9))
    table = ks.grid_table(tris.to(device))
    grids = {res: [a.to(device) for a in grid_axes(obstacle, res)[0]] for res in args.res}
    want = {(res, signed): ks.sdf_grid_cuda(axes, table, signed)
            for res, axes in grids.items() for signed in (True, False)}
    ok = True
    for spec in [SHIPPED, *(k for k in libs if k != SHIPPED), SHIPPED]:
        lib, log = libs[spec]

        def run(axes, signed, lib=lib):
            return (ks.sdf_grid_cuda(axes, table, signed) if lib is None
                    else launch(lib, axes, table, signed))

        same = all(torch.equal(run(grids[res], signed).view(torch.int32),
                               w.view(torch.int32)) for (res, signed), w in want.items())
        ms = {f"{res}^3 {'signed' if signed else 'unsigned'}":
              kernel_ms(lambda a=grids[res], s=signed: run(a, s), args.reps)
              for res in args.res for signed in (True, False)}
        print(json.dumps({"variant": spec, "bit_equal_to_shipped": same, "kernel_ms": ms,
                          "ptxas": grid_ptxas(log), "card": card}), flush=True)
        ok = ok and same
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
