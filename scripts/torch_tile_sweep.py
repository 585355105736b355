#!/usr/bin/env python3
"""K1's block geometry on one CUDA card (the counterpart of
`scripts/tile_sweep_exp.py`, which sweeps the Pallas kernel's tiles).

    python3 scripts/torch_tile_sweep.py [--variants 4,4,1 8,4,1 ...] [--reps 20]
        [--dataset hard100k] [--chunk 16384] [--valid-only | --invalid-only] [--counters]

A variant W,R,B defines `RC_WARPS` (warps sharing one row), `RC_ROWS` (rows
in flight per block, one per team of W warps) and `RC_MIN_BLOCKS` (the
launch bound's resident blocks per SM) of `csrc/megakernel.cu`: a copy of
the source with those defined first, built with the package's nvcc flags
into `build/` (`kernels/_build.build_copies`, every copy compiled at once,
and `copy_library`). The robot tile (`kRobTile`) and the obstacle group
(`kGroup`) are not swept: the host's tables and shared-memory budget depend
on them (`kernels/megakernel.py` ROB_TILE, GROUP and `smem_bytes`).

For each variant, on the alpha-1.0 pair and ``--dataset`` (default hard100k,
as `tile_sweep_exp.py:61`; a missing 100k set raises with the command that
makes it), it prints one JSON line: the ptxas registers and spill bytes of
every instance of the kernel, the resident blocks per SM, the golden
mismatches of its verdicts after the float64 resolution of bits 1-2 (must be
0, or the script fails), and the CUDA-event µs per configuration (mean of
``--reps`` launches) on the set's first ``--chunk`` rows (default 16,384),
on its first ``--chunk`` valid rows and on its first ``--chunk`` invalid
rows (`tile_sweep_exp.py:63-77`), each as one launch; ``--valid-only`` or
``--invalid-only`` keeps that one. ``--counters`` adds, per row set, the
counter kernel's line of `tile_sweep_exp.py:104-113` (broad-phase hit rate,
pairs, gated, plane and interval tile pairs per hit) once: the variants
change the block geometry, not the tiles those count. The default variant
(4,4,1, the shipped geometry) is timed first and again last, for the drift
between the two, and its SASS (`cuobjdump -sass`) is compared with the
package's own build: it must be the same kernel. Every line carries the
card's name and power limit. Imports neither JAX nor the JAX package.
"""
import argparse
import json
import re
import runpy
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robocheck_tpu_torch import MegaKernelChecker, load_obj, read_conf_file  # noqa: E402
from robocheck_tpu_torch.io import assets  # noqa: E402
from robocheck_tpu_torch.kernels import _build  # noqa: E402
from robocheck_tpu_torch.kernels import megakernel as mk  # noqa: E402
from robocheck_tpu_torch.oracle import resolve_coplanar  # noqa: E402
from robocheck_tpu_torch.profiling.timers import card_line, event_ms  # noqa: E402

DEFAULT = "4,4,1"
VARIANTS = [DEFAULT, "4,4,2", "2,4,1", "8,4,1", "4,2,1", "4,8,1", "2,8,1"]


def parse(spec: str) -> tuple[int, int, int]:
    warps, rows, blocks = (int(x) for x in spec.split(","))
    if not (1 <= rows <= 15 and warps >= 1 and blocks >= 1 and 32 * warps * rows <= 1024):
        raise ValueError(f"variant {spec}: need rows in 1..15 and 32 x warps x rows <= 1024")
    return warps, rows, blocks


def variant_source(spec: str, out_dir: Path) -> Path:
    """A copy of `csrc/megakernel.cu` with the variant's geometry defined
    first."""
    warps, rows, blocks = parse(spec)
    path = out_dir / f"megakernel_w{warps}_r{rows}_b{blocks}.cu"
    path.write_text(f"#define RC_WARPS {warps}\n#define RC_ROWS {rows}\n"
                    f"#define RC_MIN_BLOCKS {blocks}\n"
                    + _build.SOURCES["megakernel"].read_text())
    return path


def ptxas(log: str) -> dict:
    """{instance: [registers, spill store bytes, spill load bytes]} of an
    nvcc -Xptxas -v log; an instance is the template suffix of its name."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?10megakernel(I\w+?E)vPK", line)
        if m:
            name = m.group(1)
            out[name] = [None, 0, 0]
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line)):
            out[name][1:] = [max(out[name][1], int(m.group(1))),
                             max(out[name][2], int(m.group(2)))]
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name][0] = int(m.group(1))
    return out


def sass(lib: Path) -> dict:
    """{instance: its SASS instruction lines} of a built library."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME) / "bin" / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*?10megakernel(I\w+?E)vPK", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and line.strip().startswith("/*"):
            out[name].append(line.strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=VARIANTS,
                    help="warps,rows,min_blocks per variant")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dataset", default="hard100k", choices=sorted(assets.DATASET_FILES))
    ap.add_argument("--chunk", type=int, default=16384)
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--valid-only", action="store_true")
    only.add_argument("--invalid-only", action="store_true")
    ap.add_argument("--counters", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_tile_sweep: no CUDA device")
    card = card_line()
    device = torch.device("cuda", 0)
    launch = runpy.run_path(str(REPO / "scripts" / "torch_k1_compare.py"),
                            run_name="imported")["launch"]

    out_dir = REPO / "build" / "tile_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = list(dict.fromkeys(args.variants))
    if DEFAULT not in specs:
        specs.insert(0, DEFAULT)
    sources = {spec: variant_source(spec, out_dir) for spec in specs}
    shipped_lib, _ = _build.build()["megakernel"]
    _build.build_copies(sources.values())

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    checker = MegaKernelChecker(robot, obstacle, device=device)
    tables = checker.tables
    hard = read_conf_file(assets.dataset_path(args.dataset))
    C = args.chunk
    sets = {"all": np.arange(min(C, len(hard.confs))),
            "valid": np.flatnonzero(hard.valid)[:C], "invalid": np.flatnonzero(~hard.valid)[:C]}
    if args.valid_only or args.invalid_only:
        sets = {k: v for k, v in sets.items() if k == ("valid" if args.valid_only else "invalid")}
    poses = {k: mk.poses_from_confs(torch.from_numpy(hard.confs[idx]).to(device))
             for k, idx in sets.items()}
    if args.counters:
        for k, idx in sets.items():
            out = checker.check_block(hard.confs[idx]).cpu().numpy()
            bh = out[:, 3] > 0
            print(json.dumps({
                "counters": True, "dataset": args.dataset, "rows": k, "n": len(idx),
                "broad_hit_rate": float(bh.mean()), "mean_pairs_bh": float(out[bh, 2].mean()),
                "mean_gated_bh": float((out[bh, 4] + out[bh, 5]).mean()),
                "mean_plane_bh": float(out[bh, 4].mean()),
                "mean_interval_bh": float(out[bh, 6].mean()), "card": card}), flush=True)

    same = sass(shipped_lib) == sass(_build.copy_path(sources[DEFAULT]))
    print(json.dumps({"default": DEFAULT, "sass_equals_shipped_build": same, "card": card}),
          flush=True)
    ok = same
    for spec in [*specs, DEFAULT]:
        lib, log = _build.copy_library(str(sources[spec]))
        mism = 0
        for k, idx in sets.items():
            packed = launch(lib, poses[k], tables).cpu().numpy()
            valid = resolve_coplanar(robot, obstacle, hard.confs[idx], (packed & 1).astype(bool),
                                     (packed & 6).astype(bool))
            mism += int((valid != hard.valid[idx]).sum())
        us = {k: event_ms(lambda p=p: launch(lib, p, tables), args.reps) * 1e3 / len(p)
              for k, p in poses.items()}
        print(json.dumps({"variant": spec, "warps_rows_min_blocks": parse(spec),
                          "blocks_per_sm": int(lib.rc_megakernel_blocks_per_sm(1024, 8)),
                          "smem_bytes": int(lib.rc_megakernel_smem_bytes(1024, 8)),
                          "dataset": args.dataset, "golden_mismatches": mism,
                          "us_per_config": us,
                          "ptxas": ptxas(log), "card": card}), flush=True)
        ok = ok and mism == 0
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
