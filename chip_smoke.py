"""GPU smoke check of the PyTorch/CUDA port (`robocheck_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:
  1. the card: name, and `nvidia-smi` name and power limit;
  2. build the CUDA sources `robocheck_tpu_torch/csrc/megakernel.cu`,
     `stage_probes.cu`, `clearance.cu` and `front.cu` (sm_90a, -fmad=false;
     one nvcc each, started together, beside `make -C native`, the float64
     oracle) and print the ptxas register / shared-memory / spill lines of
     every kernel instance (the front end's with 0 spill bytes), and the
     fused kernel's shared memory per block and resident blocks per SM for
     the alpha-1.0 tables; the native library against the io modules: its
     `parse_conf` on hard10k must equal `io.conf`'s rows and tags, its
     `parse_obj` of both alpha-1.0 meshes `io.obj.load_obj`'s vertices and
     triangles, and its `write_conf` of hard10k the bytes of
     `io.conf.write_conf_file`'s, parsing back (native and `io.conf`) to
     hard10k's rows and tags;
  3. the kernel against its plain PyTorch twin on the card, on the same pose
     rows: alpha-1.0 meshes over hard10k[:2048] and easy10k[:2048], two
     icosphere scenes (one with a 2200-triangle soup obstacle), the
     tetrahedra fixture and two coplanar fixtures. `valid`
     must be identical on every row, `coplanar` (bit 1) and `uncertain`
     (bit 2) on every valid row (the tolerance is exact: both compute the
     same float32 operations); then hard10k[:2048] with NaN, +inf and -inf
     planted in every column on 18 rows around the boundaries of chunks of
     512, through `check_packed(chunk=512)`: its bytes equal to the twin's
     by the same rule, 0 on every planted row, presort on equal to off by
     that rule too (a colliding row's bits 1-2 follow the run-time order of
     the any-hit exit, which presort's chunks change), the counter kernel's
     rows all zero there, and the checker's
     `counters()["nonfinite_rows"]` and the twin's count each rising by the
     planted count a call;
  3b. the counter kernel against its twin on the same scenes and the JAX
     package's TestCoplanarResolution fixture: columns 0-6 identical on valid
     rows, columns 0 and 3 on every row; on colliding rows the kernel's
     columns 2 and 4-6 at most the twin's (its any-hit exit stops the
     counts), with nrest >= 1; the JAX fixture's row must carry bit 2 and
     resolve colliding through `check_valid_resolved` on the card, by one
     launch of the resolution kernel (`csrc/resolve.cu`), its counters
     `resolved_rows` and `resolved_colliding` each rising by one;
  4. the main path, `MegaKernelChecker(..., device="cuda").check_valid_resolved`,
     on all 10,000 rows of hard10k and easy10k (0 golden mismatches each) and
     of 10,000samples (7296 valid, the file header's count), with the
     kernel's launch counter above 0, one resolution launch a call, and the
     rows each set sends to float64 resolution by bit 1 and by bit 2; then
     the resolution kernel on K1's bytes, bit-equal to its twin on the card
     on every row (counters alike) and equal to the native float64 oracle on
     every flagged row, of the three 10k sets, of the 8 batches of the
     benchmark's hard100k pool for seed 2718281828 and of planted rows that
     float64 overturns (the face-on-face row at 10 places in 100,000 far
     rows, also through a world-of-one `ShardedChecker` held against
     `oracle.resolve_coplanar`, the JAX fixture, the mismatched-scale
     scene, the band-hidden contacts of 80 x 81,920 triangles through the
     chunked checker's whole-pair tables (in global memory), the
     near-coplanar and touching-interval pairs of `io.datagen`), and on a
     2,200-triangle soup (its boxes alone in shared memory), each checker's
     own `check_valid_resolved` equal to the kernel's verdicts; the largest
     ulp difference of the pose's float64 sin / cos, card against host
     (numpy); the kernel's device
     time at hard100k's shape (with its flagged rows, and with none) beside
     its twin and its bound (`profiling.bounds.resolve_work`), and
     `check_valid_resolved` against `check_packed` plus the host oracle on
     one hard100k batch, in turns;
  5. times: end-to-end checks/s (best of 5 after a warm-up, each run ending
     in torch.cuda.synchronize()), and the kernel alone and its twin alone
     at the main path's shape, all 10,000 rows of hard10k and of easy10k in
     one launch (CUDA events); their outputs are held against each other as
     in phase 3;
  4b. the stats path: `checker.check` with two_phase True and False on all
     10,000 rows of hard10k and easy10k (`valid` equal to `check_valid`'s on
     every row; the counter kernel's broad column equal to `broad_block` on
     every row with two_phase False, and 1 on every survivor of
     `broad_block` with two_phase True), with the counter kernel's launch
     counter above 0; `check_valid(presort=True)` equal to presort=False on
     the three 10k sets; the counter kernel and its twin timed on hard10k and
     held against each other as in 3b;
  6. the stage-decomposition surface: every stage variant of the kernel on
     hard10k (`scripts/torch_roofline.py`; the byte 1 on every row, timed
     beside the full kernel) and every probe piece of P1-P3 at its script's
     shape (`scripts/torch_bisect.py`; equal to its plain version, tolerance
     0), each launched once with the launch counters set to 0 just before,
     then timed by its device duration from a trace (`timers.kernel_ms`, the
     kernel table's figure) and by CUDA events around back-to-back calls,
     with its plain version by CUDA events; each P1-P3 piece's launch
     shape (block, shared memory, blocks per SM, grid, registers, local
     bytes) beside K1's packed instance on the same tables (512 threads, 0
     local bytes), its shared-memory map as built equal to
     `probes.probe_map`'s, P1 and P2's scratch pieces at K1's shared memory,
     P3's at `probes.probe_smem_bytes("invariant")` (K1's plus its table's
     overhang), all of these at K1's blocks per SM and grid, 0 spill bytes in
     every probe instance; K1 and P1 level 2 on 16,384 rows at x = 1e9 (every K1 row a
     broad-phase miss) by trace;
  7. the oversized-mesh path: `smem_bytes` against the compiled layout's
     `rc_megakernel_smem_bytes` on 8 shapes (the chunk caps among them) and
     the card's opt-in shared memory per block against `SMEM_LIMIT`; then
     `make_checker(..., device="cuda")` on `scripts/bench_chunked.py`'s two
     scenes (80 x 81,920 and 20,480 x 20,480 triangles, 8,192 rows, seed 7)
     must be a `ChunkedMegaKernelChecker` whose `check_valid_resolved` (one
     launch of the resolution kernel) equals the float64 oracle (native,
     built here with make) on every row, whose
     bytes are identical with `compact` on and off, and, on the first 512
     rows, equal to one unchunked twin (`check_poses_reference`) on the card
     (valid on every row, bits 1 and 2 on valid rows); chunk pairs, launches
     and host-clock times printed; then the alpha 1.0 robot against
     `subdivide_mesh(obstacle, 3)` (64,512 triangles) through
     `make_checker(..., device="cuda")`: 11 chunk pairs, one K1 launch a pair,
     the first 512 of 8,192 hard rows equal to one unchunked twin by the same
     rule, `compact` on equal to off byte for byte, and `counters()` moved by
     the phase's own count of chunk pairs, rows, uploads (one a call by
     default) and flagged rows; `check_valid_resolved`'s host-clock time and
     uploads a call with `compact` off and on, in turns;
  8. the planners on the card, alpha-1.0 pair, `alpha.query`: RRT-Connect
     (the demo's config: 16 iterations of 256 samples, step 0.35 x the
     robot's smallest extent, 48 checks per edge, surface bias 0.6, seed 0)
     and PRM (4,096 samples, 12 neighbours, 32 checks per edge), each with
     its default checker (`make_checker` on the card); each must find a path
     whose densification at 0.1 x extent is valid under
     `check_valid_resolved`. The RRT path is compared with
     `data/alpha_certified_path.npy` (the same planner and config on a TPU);
     where they differ, the first planner batch whose verdicts differ from
     the float64 oracle is printed (a difference fails no phase);
  9. the continuous certifier, on bench.py's clearance scene (refine-4 alpha
     robot, 133,902 vertices, 131 blocks; 256 near-contact queries, seed 5)
     and its obstacle subdivided twice (16x: 16,128 triangles): (a) the
     clearance scan (`robocheck_tpu_torch/csrc/clearance.cu`), culled and
     nocull, bit-equal to its twin (max abs err 0, NaN for NaN) on small
     random scenes that reach every path of the kernel, every (configuration,
     block) pair of the first 16 queries and the same pairs of 1-vertex
     representative blocks, the first 1,024 pairs the engine's exact phase
     launches (the survivor dispatch) and the first 128 of the 16x scene;
     the culled kernel's count of (unit, group) scans equal to `cull_plan`'s
     on every pair, and its kept-scan counter to their sum; (b)
     `min_distances` at or below the native float64 BVH (and within 2 x
     err_bound) on the first 32 queries, on 8 near-contact
     waypoints of the certified path at refine 6, on the scene moved 10^3
     obstacle extents from the origin and on the 16x scene, the worst
     float32 deviation in ulp x scale beside the 128 of `err_bound`; (c)
     the old dispatch (the first 1,024 of (a)'s pairs) and the survivor
     dispatch, culled, nocull and the twin by CUDA events, beside the
     culled-work bound (`cull_plan`'s distances by region, and the culling)
     and the full-scan bound (every distance by region); the
     representatives culled per thread and nocull; configurations/s of
     `min_distances` (warm, best of 3), its per-call stats and
     `clearance_vs_native` (the native BVH on 32 queries); (d) both alpha
     legs of `scripts/torch_certify_alpha.py` through `certify_multires`
     with `make_checker` on the card: certified, no collision, 0
     uncertified steps, exactly 1,196 and 1,309 checks, with their
     `exact_kernel_s` and `rep_kernel_s`, K1 and the scan kernel launched;
     (e) the tunneling path through `tests/test_clearance.py`'s wall
     refuted; (f) `min_distances` on the 1x and the 16x obstacle, culled and
     nocull: configurations/s, exact_s and the 16x / 1x ratio; (g) the
     obstacle subdivided three times (64,512 triangles, the benchmark's
     `alpha1.0-sub3-clearance`): `min_distances` on the first 32 queries at
     or below the native float64 BVH and within 2 x err_bound, the first 64
     survivor pairs as in (a), and the engine's kept-scan counter over a
     call equal to `cull_plan`'s count over the call's launches;
 10. the gradient planners on the card: (a) SQP smoothing of the alpha RRT
     path as `scripts/torch_certify_alpha.py --smooth` runs it (the settings
     of `certify_alpha.py:104-128`), which must certify, and its output
     through `certify_multires` on 2:8,4:10,6:12 with 0 uncertified steps,
     the check count beside ALPHA_CCD.json's 1,390 (the TPU run's own SQP
     output: another run's trajectory) and its outer iterations, with the
     96^3 grid's own time (`grid_s`, K4) inside `construct_s`; (b) the wall
     scene's `plan_and_smooth` with `swept_certify` (`scripts/torch_demo_planner.py
     --wall --ccd`), certified discretely and continuously; K1 and the scan
     kernel launched in (a)-(b); (c) the card against the CPU on the alpha
     init of (a): the SQP constraint blocks (g, J, penalty total) and the
     TrajOpt cost and gradient, within the cross-package tolerances of
     `tests/test_torch_{sqp,trajopt}.py`; (d) times: an SQP outer iteration
     split into constraint blocks, subproblem, merit and certification, one
     Adam step and one TrajOpt round of the wall scene, and the card's idle
     share over (a) from a `torch.profiler` trace; K4's launches in (a)-(d)
     (every grid they build), which must be above 0;
 11. the dense reference pipeline, `CollisionWorld(..., device="cuda")`
     (torch ops, no kernel): 0 golden mismatches on all 10,000 rows of
     hard10k and easy10k, 7296 valid on 10,000samples, the same verdicts at
     `narrow_chunk` 8 and 64, and ms per 10k rows beside phase 5's
     `check_valid_resolved`;
 12. scale-out: two ranks of one gloo process group, spawned on the one
     card (`runtime.distributed.launch`), run (a) `ShardedChecker` on all of
     hard10k at the alpha pair's full width: bytes equal to the world of 1's
     by phase 3's rule (bit 0 on every row, the byte on valid rows: a
     colliding row's bits 1-2 follow the kernel's run-time order, and two
     world-of-1 runs are counted where they differ), 0 golden mismatches
     resolved (the resolution kernel launched in every rank), totals equal
     to the rows' counts, the
     counter rows' valid and broad columns equal to the world of 1's, and
     `check_valid_distributed` on 256 rows (each rank reading its shard)
     equal to the goldens; (b) the sharded `ClearanceEngine` on bench.py's
     clearance scene, bit-equal to the world of 1's; (c) phase 10 (a)'s SQP
     with waypoint-sharded blocks, certified at phase 10 (a)'s outer
     iteration with its merit within rel 1e-5, and its sharded certificate's
     checks beside ALPHA_CCD.json's 1,390; (d) `torch_graft_entry.
     dryrun_multichip(2)`; checks/s and configurations/s at 1 and 2 ranks,
     the SQP's `plan` seconds; each kernel's launches in the ranks;
 13. the port's bench: (a) `scripts/torch_make_datasets.py --sizes 100000`
     (files that exist are skipped; native float64 tags), its time, then
     `check_valid_resolved` on all 100,000 rows of hard100k and easy100k
     against their tags: 0 golden mismatches each (a mismatching row is
     printed with its tag, verdict and packed byte); (b)
     `scripts/torch_bench.py` in a process of its own: rc 0, its stdout and
     stderr lines printed, the headline on hard100k with 0 golden
     mismatches, 0 on easy100k, presort verdicts identical, and both kernels
     launched; their launches and (a)'s join the kernel table's counts;
     (c) K1 against its twin (max abs err 0, phase 3's rule) at the shapes
     the bench launches it: all of hard100k in one launch [100000,16] (the
     main path's launch) and the latency leg's [2048,16]; the kernel
     table's K1 times, bound and share are those of the [100000,16]
     launch; then `check_packed`'s one K1 launch against `chunk=CHUNK` on
     hard100k, easy100k and a mixed pool (their rows interleaved 50/50, as
     the benchmark's mixed100k): 1 launch against 7, bit 0 equal on every
     row and the byte on valid rows (phase 3's rule), and K1 alone both
     ways by CUDA events.
Every check path above poses its rows through K2 (`csrc/front.cu`, the pose
rows), and presort, the stats path's broad phase and the chunked `compact=`
pre-filter go through K5 (the robot box); phases 4, 4b, 7, 8, 9 (d), 10,
12's ranks and 13 set K2's and K5's launch counters to 0 before their path
and fail if K2 (and K5 in 4b) did not launch.
 14. the front end: (a) K2 against its twin `poses_from_confs_reference`,
     bit for bit (the int32 views equal), on all rows of the three 10k sets,
     hard100k and easy100k and on 65,536 adversarial rows
     (`io.datagen.adversarial_confs`: multiples of pi/4 and their
     neighbours, +-1e4 rad, denormals, magnitudes to 1e38); (b) K5 over the
     robot's vertex table (`robot_vertices`, 792 vertices for alpha-1.0)
     against `robot_bounds_reference` / `mesh_broad_reference` (corner
     table) and `robot_bounds_vertices_reference`, boxes equal as values
     (the min of -0.0 and +0.0 may be either zero), NaN for NaN, hit bytes
     identical, on the alpha table and its cuts to Tr 1008 (no padding), 77
     and 1, a one-triangle robot, an all-padding table (the 3.0e38 sentinel
     box), the phase-3 scenes, every robot group of phase 7's scenes and of
     a 3,000-triangle soup whose 9,000 vertices take three 4,096-vertex
     tiles (its `compact=True` bytes identical to `compact=False`'s), all
     100,000 rows of hard100k, and hard10k rows with NaN / +-inf entries
     through `broad_block` (and on the Tr 1008 cut); (c) K2's and K5's
     launch counters above 0 on `check_valid_resolved` (K2),
     `check_valid(presort=True)`, `check(two_phase=True)` and
     `ChunkedMegaKernelChecker` with `compact=True` (K2 and K5), each set to
     0 just before; (d) K2 and K5 on hard100k's first 2,048 and 16,384 and
     all 100,000 rows by their device duration from a trace
     (`timers.kernel_ms`), beside CUDA events around back-to-back calls,
     the wrappers' host µs a call, their torch-ops twins and their bounds
     (`profiling.bounds.pose_rows_work`; `robot_bounds_work`, the vertex
     bound and the corner bound), and `check_valid` with presort off and
     on on hard100k and easy100k (checks/s, best of 5, verdicts
     identical). K2's and K5's kernel-table
     entries carry the [100000] device times and the launches of every
     path above.
 15. the gradient planners' distance grid, K4 (`csrc/clearance.cu`
     `grid_kernel`, which culls triangle groups per warp brick of nodes,
     for the distance and for the ray, and stages the groups it keeps by
     bulk copies): (a) its ptxas lines (0 spills required), K4 against its
     full twin `kernels/sdf.grid_values_reference` as float32 bits (the
     sign of zero included, NaN for NaN), signed and unsigned, and its kept
     (warp, group) distance and ray scans against
     `kernels/sdf.grid_cull_plan`'s (equal required), on the alpha obstacle
     at 64^3 and 96^3 (phase 10 (a)'s grid), icosphere(2) and box(0.4, 2,
     1) at 32^3, the 16x obstacle (16,128 triangles: 504 groups) at 32^3,
     the box with a zero-area and a ray-parallel triangle (the flat path),
     the box with an a = b != c triangle (NaN nodes required), box(2, 2,
     2) at 25^3, whose faces hold nodes (-0.0 required) and whose bricks the
     lattice's edge cuts, a triangle nearly parallel to the ray whose plane
     holds lattice nodes (16^3; with its box grown by the distance slack
     alone K4 must lose the crossings the plan says it loses), and the 256x
     obstacle (258,048 triangles: 8,064 groups, past a block's shared
     memory) at 16^3; each grid also through `rc_sdf_grid` with the
     groups' arrays in device scratch and three blocks a launch; (b) on the
     alpha obstacle at 64^3 and 96^3 K4's time by CUDA events (signed and
     unsigned; the kernel table's figure) and by trace
     (`timers.kernel_ms`), the twin's time, the culled-work bound (the
     plan's pairs) and the full-scan bound (every pair) of this run's work
     (`profiling.bounds.grid_work` from `kernels/sdf.grid_work_counts`)
     and both shares, the kept shares of
     the pairs, and the nodes whose sign the build before K4 (torch ops
     summing by `.sum(-1)`) gave otherwise. K4's kernel-table entry carries
     the 96^3 times, both bounds and the launches of phases 10 and 12.
The line before the last is the kernel table as JSON, each kernel with its
bound (`profiling.bounds`, from this run's inputs and counter rows); the
last line is the result as JSON. Without a CUDA device, or without the package beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import runpy
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
REPLACES = "robocheck_tpu/kernels/megakernel.py:358"
SOURCE = "robocheck_tpu_torch/csrc/megakernel.cu"
PROBE_SOURCE = "robocheck_tpu_torch/csrc/stage_probes.cu"
CLEARANCE_SOURCE = "robocheck_tpu_torch/csrc/clearance.cu"
CLEARANCE_REPLACES = "robocheck_tpu/planner/clearance.py:312"
FRONT_SOURCE = "robocheck_tpu_torch/csrc/front.cu"
RESOLVE_SOURCE = "robocheck_tpu_torch/csrc/resolve.cu"
# The resolution replaces no TPU kernel: the JAX package (and the port before
# it) resolves flagged rows with the float64 oracle on the host.
RESOLVE_REPLACES = "none (host oracle: robocheck_tpu/oracle/__init__.py:31 resolve_coplanar)"
# One seed of the benchmark's hard100k pool (`benchmark/gen/alpha_bot.py`).
BENCH_SEED = 2718281828
# Rows of a 100,000-row batch of far rows where phase 4 plants the
# face-on-face fixture's row: both ends, both sides of the kernel's tiles
# (1,024 rows) and of CHUNK, and two rows of one tile.
RESOLVE_PLANTED = [0, 1, 1023, 1024, 2047, 16383, 16384, 50000, 50001, 99999]
POSE_REPLACES = "robocheck_tpu/kernels/megakernel.py:1099"
BOX_REPLACES = "robocheck_tpu/kernels/megakernel.py:1209"
GRID_REPLACES = "robocheck_tpu/planner/sdf.py:127,148"
# K4's launches in each path's run, by path (phases 10 and 12).
GRID_LAUNCHES = {}
# K2's and K5's launches in each path's run, by path (`read_front`).
FRONT_LAUNCHES = {}
# The rows of `scripts/torch_bench.py`'s latency batch.
LATENCY_BATCH = 2048
# Phase 13 (c)'s rows per K1 launch of the split side: `check_packed`'s
# launch size before one launch a call.
CHUNK = 16384
# Phase 9's alpha legs (`scripts/torch_certify_alpha.py`) and the checks
# each must take: the port's counts since its certifier was ported (the raw
# leg's is the JAX package's too; the stored smoothed file has no JAX count:
# ALPHA_CCD.json's 1,390 is of a fresh SQP output, which phase 10 (a)
# reproduces). The scan's distances are bit-equal to the full scan's, so the
# counts cannot move.
CERTIFY_LEGS = ("smoothed", "raw")
CERTIFY_CHECKS = {"raw": 1196, "smoothed": 1309}
# Phase 10 (c): the card against the CPU, at the cross-package tolerances of
# tests/test_torch_sqp.py (g, J: (rtol, atol), atol times the coordinate
# scale) and tests/test_torch_trajopt.py (the TrajOpt cost; its gradient with
# atol times the largest component).
G_TOL, J_TOL = (2e-5, 1e-6), (2e-4, 1e-5)
COST_RTOL, GRAD_TOL = 1e-5, (1e-4, 1e-5)
# The JAX knob each stage variant replaces (robocheck_tpu/kernels/megakernel.py).
STAGE_REPLACES = {"nosweep": "robocheck_tpu/kernels/megakernel.py:625",
                  "maskonly": "robocheck_tpu/kernels/megakernel.py:761",
                  "planesonly": "robocheck_tpu/kernels/megakernel.py:770",
                  "nodiv": "robocheck_tpu/kernels/megakernel.py:775"}
# The probe pieces each kernel-table entry is timed on, and the pallas_calls.
PROBES = {1: ("P1_pose_probe", "mini_level3", "scripts/bisect_stage1.py:142,165"),
          2: ("P2_empty_probe", "pose_only", "scripts/bisect_stage2.py:73"),
          3: ("P3_invariant_probe", "auto_invariant_vmem",
              "scripts/bisect_stage3.py:66,86,105")}
# TestCoplanarResolution's face-on-face pair (tests/test_torch_megakernel.py):
# two triangles in one tilted plane that float32 flags and float64 finds
# intersecting at the identity pose.
FACE_R = [[-172.35173, 118.57849, -337.86478], [-168.62619, 71.0307, -215.03616],
          [-280.98154, 165.06941, -53.021297]]
FACE_O = [[-148.91972, 43.489243, -211.57489], [-222.59364, 145.73175, -222.42876],
          [-204.12267, 60.86192, -48.782146]]
# tests/test_megakernel.py::TestCoplanarResolution (JAX package), identity pose.
JAX_COPLANAR_RT = [[-88.58568, -287.5827, -148.07309], [-105.54053, -122.13013, -65.34459],
                   [9.788717, -353.9158, -98.061005]]
JAX_COPLANAR_OT = [[-163.90807, -449.27316, -312.38596], [55.186058, -181.60817, 45.36783],
                   [-9.889383, -480.09338, -190.76962]]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def zero_front() -> None:
    """Set the front end's launch counters (K2, K5) to 0, just before a
    path's run."""
    from robocheck_tpu_torch.kernels import front

    front.poses_from_confs_cuda.launches = 0
    front.robot_bounds_cuda.launches = 0


def read_front(path: str, k5: bool = False) -> dict:
    """K2's and K5's launches in ``path``'s run, read just after it and kept
    in FRONT_LAUNCHES; fails unless K2 (and K5, where ``k5``) launched."""
    from robocheck_tpu_torch.kernels import front

    torch.cuda.synchronize()
    got = {"pose_rows": front.poses_from_confs_cuda.launches,
           "robot_bounds": front.robot_bounds_cuda.launches}
    FRONT_LAUNCHES[path] = got
    require(got["pose_rows"] > 0, f"{path}: K2 (the pose rows) was not launched")
    require(got["robot_bounds"] > 0 or not k5, f"{path}: K5 (the robot box) was not launched")
    return got


def compare_on_card(mk, name, robot, obstacle, confs, device, scenes):
    """Phase 3 for one scene: the kernel and its twin on the same pose rows.
    Appends the scene to `scenes` for phase 3b."""
    prep = mk.MegaKernelPrep.build(robot, obstacle).to(device)
    poses = mk.poses_from_confs(torch.from_numpy(confs).to(device))
    scenes.append((name, prep, poses))
    return compare_bits(name, mk.check_poses_cuda(poses, prep),
                        mk.check_poses_reference(poses, prep))


def compare_nonfinite(mk, robot, obstacle, confs, device) -> int:
    """Phase 3's non-finite rows: NaN, +inf and -inf in every column on rows
    around the boundaries of chunks of 512 of ``confs``, checked on the card
    through `check_packed(chunk=512)` and against the twin. Returns the max
    abs difference of the compared bits."""
    confs = confs.copy()
    chunk = 512
    rows = [0, chunk - 1, chunk, 2 * chunk - 1, 2 * chunk, 2 * chunk + 1, 3 * chunk - 2,
            3 * chunk - 1, 3 * chunk, len(confs) - 1]
    rows += list(np.random.default_rng(31).choice(
        np.setdiff1d(np.arange(len(confs)), rows), 18 - len(rows), replace=False))
    for i, r in enumerate(rows):
        confs[r, i % 6] = (np.nan, np.inf, -np.inf)[i % 3]
    bad = ~np.isfinite(confs).all(1)
    planted = int(bad.sum())
    require(planted == 18, f"non-finite rows: planted {planted}, meant 18")
    checker = mk.MegaKernelChecker(robot, obstacle, device=device)
    got = checker.check_packed(confs, chunk=chunk)
    counted = checker.counters()["nonfinite_rows"]
    presorted = checker.check_packed(confs, chunk=chunk, presort=True)
    poses = mk.poses_from_confs(torch.from_numpy(confs).to(device))
    twin_count = torch.zeros((), dtype=torch.int64, device=device)
    want = mk.check_poses_reference(poses, checker.tables, twin_count)
    stats = mk.check_poses_stats_cuda(poses, checker.tables).cpu().numpy()
    err, *_ = compare_bits(f"alpha hard10k[:{len(confs)}] with {planted} non-finite rows, "
                           f"chunks of {chunk}", torch.from_numpy(got), want)
    err = max(err, compare_bits("the same rows, presort on vs off", torch.from_numpy(presorted),
                                torch.from_numpy(got))[0])
    print(f"  non-finite rows: kernel bytes there {sorted(set(got[bad].tolist()))}, with "
          f"presort {sorted(set(presorted[bad].tolist()))}, counter kernel rows there "
          f"all zero {not stats[bad].any()}, counted by the checker {counted} then "
          f"{checker.counters()['nonfinite_rows']} (after presort), by the twin "
          f"{int(twin_count.item())}, planted {planted}")
    require(not got[bad].any(), "non-finite rows: a planted row's byte is not 0")
    require(not presorted[bad].any(), "non-finite rows: a planted row's byte is not 0 (presort)")
    require(not stats[bad].any(), "non-finite rows: a counter kernel row there is not zero")
    require(counted == planted and checker.counters()["nonfinite_rows"] == 2 * planted,
            "non-finite rows: the checker's counter is not the planted count")
    require(int(twin_count.item()) == planted, "non-finite rows: the twin counts otherwise")
    return err


def compare_stats(name, got, want):
    """Counter rows of the kernel `got` against the twin's `want`: columns
    0-6 identical on valid rows, 0 and 3 on every row; on colliding rows the
    kernel's columns 2 and 4-6 at most the twin's and nrest >= 1. Returns the
    max abs difference of the compared entries."""
    got, want = got.cpu().numpy().astype(np.int64), want.cpu().numpy().astype(np.int64)
    valid = want[:, 0] == 1
    hit = ~valid
    err = max(int(np.abs(got[valid, :7] - want[valid, :7]).max(initial=0)),
              int(np.abs(got[:, [0, 3]] - want[:, [0, 3]]).max(initial=0)))
    print(f"  {name}: {len(got)} rows ({int(valid.sum())} valid), pairs kernel/twin "
          f"{int(got[:, 2].sum())}/{int(want[:, 2].sum())}, nfull "
          f"{int(got[:, 4].sum())}/{int(want[:, 4].sum())}, ngate "
          f"{int(got[:, 5].sum())}/{int(want[:, 5].sum())}, nrest "
          f"{int(got[:, 6].sum())}/{int(want[:, 6].sum())}, max abs err {err}")
    require(err == 0, f"{name}: counter rows differ from the twin")
    require(bool((got[hit][:, [2, 4, 5, 6]] <= want[hit][:, [2, 4, 5, 6]]).all()),
            f"{name}: a colliding row counts more than the twin")
    require(bool((got[hit, 6] >= 1).all()), f"{name}: a colliding row has nrest 0")
    require(not got[:, 7].any(), f"{name}: column 7 is not zero")
    return err


def compare_bits(name, got, want):
    """Kernel bytes `got` against twin bytes `want`: `valid` (bit 0) identical
    on every row, `coplanar` (bit 1) and `uncertain` (bit 2) on every valid
    row. Returns (max abs difference of the compared bits, valid rows,
    coplanar-flagged valid rows, uncertain-flagged valid rows)."""
    got, want = got.cpu().numpy().astype(int), want.cpu().numpy().astype(int)
    v_got, v_want = got & 1, want & 1
    valid = v_want == 1
    err = int(np.abs(v_got - v_want).max())
    flags = {}
    for bit, what in ((1, "coplanar"), (2, "uncertain")):
        f_got, f_want = (got[valid] >> bit) & 1, (want[valid] >> bit) & 1
        err = max(err, int(np.abs(f_got - f_want).max(initial=0)))
        flags[what] = (int(f_got.sum()), int(f_want.sum()))
    print(f"  {name}: {len(got)} rows, valid kernel/twin "
          f"{int(v_got.sum())}/{int(v_want.sum())}, on valid rows coplanar "
          f"{'/'.join(map(str, flags['coplanar']))}, uncertain "
          f"{'/'.join(map(str, flags['uncertain']))}, max abs err {err}")
    require(np.array_equal(v_got, v_want), f"{name}: valid differs from the twin")
    require(err == 0, f"{name}: bit 1 or bit 2 differs from the twin on valid rows")
    return err, int(valid.sum()), flags["coplanar"][1], flags["uncertain"][1]


def bench_chunked_scene(big: bool, n: int = 8192):
    """`scripts/bench_chunked.py`'s meshes and rows (seed 7)."""
    from robocheck_tpu_torch.models.shapes import icosphere

    if big:
        robot, obstacle = icosphere(5, radius=0.3), icosphere(5, radius=1.5)
    else:
        robot, obstacle = icosphere(1, radius=0.3), icosphere(6, radius=1.5)
    rng = np.random.default_rng(7)
    confs = np.zeros((n, 6), np.float32)
    confs[:, 0:3] = rng.uniform(-4, 4, (n, 3))
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (n, 3))
    return robot, obstacle, confs


def phase7(lib, card: str, device) -> tuple[int, int, list]:
    """The oversized-mesh path on the card; returns (kernel launches of its
    main-path runs, max abs err of the chunked bytes against the twin, and
    each scene's (name, chunked checker, rows) for phase 14)."""
    from robocheck_tpu_torch.kernels import chunked
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.kernels import resolve as rs
    from robocheck_tpu_torch.oracle import check_configs
    from robocheck_tpu_torch.runtime import native

    optin = lib.rc_smem_optin_bytes()
    print(f"[7] oversized meshes; opt-in shared memory per block {optin} bytes "
          f"(SMEM_LIMIT {mk.SMEM_LIMIT})")
    require(optin == mk.SMEM_LIMIT, "the card's opt-in shared memory is not SMEM_LIMIT")
    caps = (chunked.MAX_ROB_TRIS, chunked.MAX_OBS_TRIS // mk.GROUP)
    for tr, g in ((1024, 8), (4096, 8), (96, 48), (96, 64), caps, (128, 46), (1024, 40),
                  (32, 1)):
        mine, compiled = mk.smem_bytes(tr, g), lib.rc_megakernel_smem_bytes(tr, g)
        print(f"  smem_bytes({tr}, {g}) = {mine}, rc_megakernel_smem_bytes = {compiled}")
        require(mine == compiled, f"smem_bytes({tr}, {g}) differs from the kernel's layout")
    launches, max_err, made = 0, 0, []
    for big in (False, True):
        robot, obstacle, confs = bench_chunked_scene(big)
        name = f"{robot.num_triangles} x {obstacle.num_triangles} triangles"
        t0 = time.perf_counter()
        ck = chunked.make_checker(robot, obstacle, device="cuda")
        t_build = time.perf_counter() - t0
        require(isinstance(ck, chunked.ChunkedMegaKernelChecker), f"{name}: not chunked")
        mk.check_poses_cuda.launches = 0
        rs.resolve_rows_cuda.launches = 0
        zero_front()
        t0 = time.perf_counter()
        resolved = ck.check_valid_resolved(confs)
        t_main = time.perf_counter() - t0
        n_launch = mk.check_poses_cuda.launches
        require(n_launch > 0, f"{name}: the chunked path launched no kernel")
        require(rs.resolve_rows_cuda.launches == 1,
                f"{name}: {rs.resolve_rows_cuda.launches} resolution launches, not 1")
        read_front(f"oversized meshes (7), {name}")
        launches += n_launch
        t0 = time.perf_counter()
        oracle = check_configs(robot, obstacle, confs)
        t_oracle = time.perf_counter() - t0
        mism = int((resolved != oracle).sum())
        times = {}
        packed = {}
        for compact in (True, False):
            packed[compact] = ck.check_packed(confs, compact=compact)
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                ck.check_packed(confs, compact=compact)
                runs.append(time.perf_counter() - t0)
            times[compact] = min(runs)
        print(f"  {name}: {ck.num_chunk_pairs} chunk pairs (built in {t_build} s), "
              f"{int(resolved.sum())}/{len(confs)} valid, {mism} mismatches against the "
              f"{'native' if native.available() else 'numpy'} float64 oracle "
              f"({t_oracle} s); check_valid_resolved {t_main} s with {n_launch} kernel launches")
        n_res = int((((packed[False] & 1) == 1) & ((packed[False] & 6) > 0)).sum())
        print(f"  [{card}] {name}: check_packed best of 3, compact on {times[True]} s, "
              f"off {times[False]} s; bytes identical: "
              f"{bool(np.array_equal(packed[True], packed[False]))}; {n_res} rows to "
              f"float64 resolution")
        require(mism == 0, f"{name}: {mism} rows differ from the float64 oracle")
        require(np.array_equal(packed[True], packed[False]), f"{name}: compact changes a byte")
        prep = mk.MegaKernelPrep.build(robot, obstacle).to(device)
        poses = mk.poses_from_confs(torch.from_numpy(confs[:512]).to(device))
        err, *_ = compare_bits(f"{name}[:512], chunked kernel vs one unchunked twin",
                               torch.from_numpy(packed[False][:512]),
                               mk.check_poses_reference(poses, prep))
        max_err = max(max_err, err)
        made.append((name, ck, confs))
    n_launch, err = phase7_alpha_sub3(device)
    return launches + n_launch, max(max_err, err), made


def phase7_alpha_sub3(device) -> tuple[int, int]:
    """The benchmark's sub3 check configuration on the card: the alpha 1.0
    robot against `subdivide_mesh(obstacle, 3)` (64,512 triangles) through
    `make_checker`'s 11 chunk pairs; the bytes of the first 512 of 8,192
    hard rows held to one unchunked twin and ``counters()`` to the phase's
    own count of chunk pairs, rows and uploads; ``compact`` on must keep
    every byte. By default a call uploads the batch once and runs every
    chunk pair's K1 on its pose rows; the call's time and uploads with
    ``compact`` off and on are printed, in turns. Returns (K1 launches of
    the resolved call, max abs err against the twin)."""
    from robocheck_tpu_torch import load_obj
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.io.datagen import alpha_bot_configurations
    from robocheck_tpu_torch.kernels import chunked
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.planner.ccd import subdivide_mesh

    robot = load_obj(assets.alpha_robot_path())
    obstacle = subdivide_mesh(load_obj(assets.alpha_obstacle_path()), 3)
    name = f"alpha {robot.num_triangles} x subdivide_mesh(obstacle, 3) {obstacle.num_triangles}"
    ck = chunked.make_checker(robot, obstacle, device="cuda")
    require(isinstance(ck, chunked.ChunkedMegaKernelChecker) and ck.num_chunk_pairs == 11,
            f"{name}: make_checker gave {type(ck).__name__}, not 11 chunk pairs")
    confs = alpha_bot_configurations(robot, 8192, hard=True, seed=2718281828)
    before = ck.counters()
    mk.check_poses_cuda.launches = 0
    t0 = time.perf_counter()
    resolved = ck.check_valid_resolved(confs)
    t_main = time.perf_counter() - t0
    n_launch = mk.check_poses_cuda.launches
    packed = ck.check_packed(confs)
    after = ck.counters()
    delta = {k: after[k] - before[k] for k in after}
    flagged = ((packed & 1) == 1) & ((packed & 6) != 0)
    print(f"  {name}: {ck.num_chunk_pairs} chunk pairs, {int(resolved.sum())}/{len(confs)} "
          f"valid, check_valid_resolved {t_main} s with {n_launch} K1 launches; counters "
          f"moved by {delta}; {int(flagged.sum())} rows to float64 resolution")
    require(n_launch == ck.num_chunk_pairs, f"{name}: {n_launch} K1 launches, not one a pair")
    want = {"pair_launches": 2 * ck.num_chunk_pairs,
            "pair_rows": 2 * ck.num_chunk_pairs * len(confs), "batch_uploads": 2,
            "nonfinite_rows": 0, "resolved_rows": int(flagged.sum())}
    require(all(delta[k] == v for k, v in want.items()),
            f"{name}: counters moved by {delta}, the phase counts {want}")
    require(not (resolved & ~(packed & 1).astype(bool)).any(),
            f"{name}: a row K1 found colliding resolved valid")
    compact = ck.check_packed(confs, compact=True)
    print(f"  {name}: compact=True bytes identical to compact=False: "
          f"{bool(np.array_equal(compact, packed))}")
    require(np.array_equal(compact, packed), f"{name}: compact changes a byte")
    times, uploads = {False: [], True: []}, {}
    for on in (False, True, True, False, False, True):
        c0 = ck.counters()["batch_uploads"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ck.check_valid_resolved(confs, compact=on)
        times[on].append(time.perf_counter() - t0)
        uploads[on] = ck.counters()["batch_uploads"] - c0
        require(np.array_equal(got, resolved), f"{name}: compact={on} changes a verdict")
    print(f"  {name}: check_valid_resolved of {len(confs)} rows in turns, compact off "
          f"{times[False]} s ({uploads[False]} batch uploads a call), on {times[True]} s "
          f"({uploads[True]} batch uploads a call)")
    require(uploads[False] == 1, f"{name}: {uploads[False]} uploads a call, not 1")
    prep = mk.MegaKernelPrep.build(robot, obstacle).to(device)
    poses = mk.poses_from_confs(torch.from_numpy(confs[:512]).to(device))
    err, *_ = compare_bits(f"{name}[:512], chunked kernel vs one unchunked twin",
                           torch.from_numpy(packed[:512]), mk.check_poses_reference(poses, prep))
    return n_launch, err


class RecordingChecker:
    """A checker's ``check_valid_resolved`` that keeps every batch and its
    verdicts."""

    def __init__(self, checker):
        self.checker = checker
        self.batches = []

    def check_valid_resolved(self, confs):
        out = self.checker.check_valid_resolved(confs)
        self.batches.append((np.array(confs, np.float32), out))
        return out


def phase8(robot, obstacle, card: str) -> int:
    """The planners on the card; returns the kernel launches of the run."""
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.io.parasol import read_query
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.oracle import check_configs
    from robocheck_tpu_torch.planner import (PRMConfig, PRMPlanner, RRTConfig,
                                             RRTConnectPlanner, densify)

    query = read_query(assets.find_asset("models/alpha1.0/alpha.query"))
    ext = float((robot.aabb[3:] - robot.aabb[:3]).min())
    print(f"[8] planners on the card, alpha-1.0 pair, alpha.query; robot extent {ext}")
    mk.check_poses_cuda.launches = 0
    zero_front()
    rrt = RRTConnectPlanner(robot, obstacle,
                            RRTConfig(max_iters=16, batch=256, step=0.35 * ext,
                                      edge_resolution=48, surface_bias=0.6, seed=0))
    prm = PRMPlanner(robot, obstacle,
                     PRMConfig(num_samples=4096, k_neighbors=12, edge_resolution=32))
    require(type(rrt.checker) is mk.MegaKernelChecker and rrt.checker.device.type == "cuda",
            "the planner's default checker is not the card's")
    rrt.checker = RecordingChecker(rrt.checker)
    paths = {}
    for name, planner in (("RRT-Connect", rrt), ("PRM", prm)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = planner.plan(query[0], query[1])
        wall = time.perf_counter() - t0
        size = (f"{res.num_nodes} nodes, {res.iters} iterations" if name == "RRT-Connect"
                else f"{res.num_vertices} vertices, {res.num_edges_checked} edges")
        print(f"  [{card}] {name}: {size}, {res.num_confs_checked} checks in {wall} s "
              f"({res.num_confs_checked / wall} checks/s), path "
              f"{'none' if res.path is None else f'of {len(res.path)} waypoints'}")
        require(res.path is not None, f"{name} found no path")
        dense, _ = densify(res.path, step=0.1 * ext)
        ok = planner.checker.check_valid_resolved(dense)
        print(f"  {name} path densified at 0.1x extent: {int(ok.sum())}/{len(ok)} valid")
        require(bool(ok.all()), f"{name}: the densified path is not all valid")
        paths[name] = res.path
    launches = mk.check_poses_cuda.launches
    require(launches > 0, "the planners launched no kernel")
    read_front("planners (8)")
    tpu = np.load(assets.find_asset("data/alpha_certified_path.npy"))
    path = paths["RRT-Connect"]
    same = path.shape == tpu.shape
    diff = float(np.abs(path - tpu).max()) if same else float("nan")
    print(f"  RRT path {len(path)} waypoints; data/alpha_certified_path.npy {len(tpu)}; "
          f"largest abs difference {diff if same else 'n/a (shapes differ)'}")
    if not (same and diff == 0.0):
        for k, (confs, got) in enumerate(rrt.checker.batches):
            want = check_configs(robot, obstacle, confs)
            if not np.array_equal(got, want):
                row = int(np.flatnonzero(got != want)[0])
                print(f"  first planner batch whose verdicts differ from the oracle: "
                      f"batch {k} ({len(confs)} rows), {int((got != want).sum())} rows, "
                      f"first row {row} conf {confs[row].tolist()}: card {bool(got[row])}, "
                      f"oracle {bool(want[row])}")
                break
        else:
            print("  every planner batch agrees with the float64 oracle")
    print(f"  kernel launches in the planners' run: {launches}")
    return launches


def survivor_dispatch(eng, confs, n: int, device):
    """The first ``n`` (configuration, block) pairs that `min_distances`
    launches on ``confs`` (its ascending-LB order), as the exact phase
    gives them to the kernel: (pose rows, block ids, slack 2 x err_bound)."""
    from robocheck_tpu_torch.kernels import clearance as kc

    err = eng.err_bound(confs)
    dev_confs = torch.from_numpy(confs).to(device)
    rows = kc.pose_rows(dev_confs)
    surv_c, surv_b, _ = eng._survivors(dev_confs, rows, np.full(len(confs), np.inf), err)
    ci = torch.as_tensor(surv_c[:n]).to(device)
    return rows[ci].contiguous(), torch.as_tensor(surv_b[:n].astype(np.int32)).to(device), 2 * err


def same_bits(got, want) -> bool:
    """Equal on every pair, a NaN matching a NaN (the kernel's rule)."""
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


def hold_scan(name, rows, ids, table, tris, groups, slack, device, finite: bool = True):
    """Phase 9 (a) for one dispatch over ``tris`` [nt, 9] in ``groups``: the
    culled and the nocull kernel against the twin, bit for bit, and the
    culled kernel's scan count against `cull_plan`'s on every pair. Returns
    (max abs err over the finite distances, plan)."""
    from robocheck_tpu_torch.kernels import clearance as kc

    tab = kc.tri_table(tris)
    want = kc.pair_min_reference(rows, ids, table, tris)
    nocull = kc.pair_min_cuda(rows, ids, table, tab)
    visits = torch.zeros(len(rows), dtype=torch.int32, device=device)
    kept = torch.zeros((), dtype=torch.int64, device=device)
    culled = kc.pair_min_cuda(rows, ids, table, tab, groups, slack, visits, kept)
    plan = kc.cull_plan(rows, ids, table, tris, groups, slack)
    torch.cuda.synchronize()
    require(not finite or bool(torch.isfinite(want).all()), f"(a) {name}: a non-finite twin "
            "distance")
    ok = torch.isfinite(want)
    err = max(float((got[ok].double() - want[ok].double()).abs().max())
              if ok.any() else 0.0 for got in (nocull, culled))
    planned = plan.sum(dim=(1, 2)).int()
    print(f"  (a) {name}: {len(rows)} pairs ({int((~ok).sum())} not finite), culled and nocull "
          f"vs twin max abs err {err}; scans kernel {int(visits.sum())} (counter "
          f"{int(kept)}) / cull_plan {int(planned.sum())} of {plan.numel()} "
          f"({float(plan.float().mean())} visited)")
    require(same_bits(culled, want) and same_bits(nocull, want),
            f"(a) {name}: a kernel differs from its twin")
    require(torch.equal(visits, planned), f"(a) {name}: the kernel's scans differ from cull_plan's")
    require(int(kept) == int(planned.sum()),
            f"(a) {name}: the kept-scan counter differs from cull_plan's count")
    return err, plan


def edge_dispatches(device) -> float:
    """Phase 9 (a) on small random scenes that reach every path of the
    kernel: 1-, 37-, 100- and 1,100-vertex blocks (lanes 1, 16, 32, 256 with
    two passes), triangle counts that are no multiple of 32, a zero-area and
    a non-finite triangle (their groups always scanned), ids outside the
    table."""
    from robocheck_tpu_torch.kernels import clearance as kc

    rng = np.random.default_rng(6)
    worst = 0.0
    for block, nt, odd in ((1, 45, "zero-area"), (37, 70, "zero-area"), (100, 33, "none"),
                           (1100, 97, "non-finite")):
        tris = (rng.normal(size=(nt, 9)) * 2.0).astype(np.float32)
        if odd == "zero-area":
            tris[nt // 2, 3:6] = tris[nt // 2, 0:3]  # b = a: NaN at many points
        elif odd == "non-finite":
            tris[nt - 1, 0] = np.inf
        tris = torch.from_numpy(tris).to(device)
        groups = kc.make_groups(tris, 32)
        blocks = torch.from_numpy((rng.normal(size=(5, block, 3)) * 0.5).astype(np.float32))
        confs = rng.uniform(-np.pi, np.pi, (64, 6)).astype(np.float32)
        confs[:, 0:3] = rng.uniform(-4.0, 4.0, (64, 3))
        rows = kc.pose_rows(torch.from_numpy(confs).to(device))
        ids = torch.from_numpy(rng.integers(-1, 6, 64).astype(np.int32)).to(device)
        err, _ = hold_scan(f"edge scene, block {block}, {nt} triangles ({odd}; "
                           f"{int(groups.always.sum())} groups always scanned)", rows, ids,
                           blocks.to(device), tris, groups, 1e-3, device, finite=False)
        worst = max(worst, err)
    return worst


def phase9_kernel(eng, eng16, confs, device) -> float:
    """Phase 9 (a) on bench.py's scene and on its 16x obstacle; returns the
    max abs err over every dispatch (0: bit-equal)."""
    from robocheck_tpu_torch.kernels import clearance as kc
    from robocheck_tpu_torch.planner.clearance import PAIR_CHUNK

    nb = eng.num_blocks
    rows = kc.pose_rows(torch.from_numpy(confs[:16]).to(device)).repeat_interleave(nb, 0)
    ids = torch.arange(nb, dtype=torch.int32, device=device).repeat(16)
    slack = 2 * eng.err_bound(confs)
    errs = [edge_dispatches(device)]
    for name, table in (("old dispatch, blocks", eng._blocks),
                        ("old dispatch, representatives", eng._reps)):
        errs.append(hold_scan(name, rows, ids, table, eng._tris, eng._groups, slack, device)[0])
    for name, e, n in (("survivor dispatch", eng, PAIR_CHUNK),
                       ("16x obstacle, survivors", eng16, 128)):
        s_rows, s_ids, s_slack = survivor_dispatch(e, confs, n, device)
        errs.append(hold_scan(name, s_rows, s_ids, e._blocks, e._tris, e._groups, s_slack,
                              device)[0])
    return max(errs)


def sweep_soundness(name, eng, robot_verts, obstacle, confs) -> float:
    """`min_distances` against the native float64 BVH on ``confs``: every
    answer at or below the truth (and above truth - 2 err); returns the
    worst float32 deviation in ulp x scale."""
    from robocheck_tpu_torch.planner.clearance import native_min_distances

    eps = float(np.finfo(np.float32).eps)
    err = eng.err_bound(confs)
    scale = err / (128.0 * eps)
    d = eng.min_distances(confs)
    truth = native_min_distances(robot_verts, obstacle, confs)
    dev_ulp = float(np.abs(d + err - truth).max() / (eps * scale))
    print(f"  (b) {name}: {len(confs)} queries, truth - answer in [{float((truth - d).min())}, "
          f"{float((truth - d).max())}] (2 x err_bound {2 * err}); worst float32 deviation "
          f"{dev_ulp} ulp x scale (scale {scale}; err_bound is 128)")
    require(bool((d <= truth).all()), f"(b) {name}: an answer is above the float64 truth")
    require(bool((truth - d <= 2 * err).all()), f"(b) {name}: an answer is below truth - 2 err")
    return dev_ulp


def phase9_soundness(robot, obstacle, rob4, eng, eng16, obstacle16, confs, device) -> None:
    """Phase 9 (b): soundness against the native BVH on the 32 first
    queries, 8 near-contact waypoints of the certified path at refine 6,
    the scene moved 10^3 obstacle extents from the origin and the 16x
    obstacle."""
    from robocheck_tpu_torch.core.types import Mesh
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.planner.ccd import subdivide_vertices
    from robocheck_tpu_torch.planner.clearance import ClearanceEngine

    sweep_soundness("bench scene, first 32", eng, rob4.vertices, obstacle, confs[:32])
    verts6 = subdivide_vertices(robot, 6)
    eng6 = ClearanceEngine(verts6, obstacle, device=device)
    path = np.load(assets.find_asset("data/alpha_certified_path.npy")).astype(np.float32)
    near = np.argsort(eng6.min_distances(path), kind="stable")[:8]
    sweep_soundness(f"refine 6 ({len(verts6)} vertices), certified path waypoints "
                    f"{sorted(near.tolist())}", eng6, verts6, obstacle, path[near])
    off = (1e3 * (obstacle.aabb[3:] - obstacle.aabb[:3])).astype(np.float32)
    far = Mesh(obstacle.vertices + off, obstacle.triangles, "obstacle+1e3ext")
    far_confs = confs[:32].copy()
    far_confs[:, 0:3] += off
    sweep_soundness(f"moved by {off.tolist()}", ClearanceEngine(rob4.vertices, far, device=device),
                    rob4.vertices, far, far_confs)
    sweep_soundness("16x obstacle, first 32", eng16, rob4.vertices, obstacle16, confs[:32])


def time_dispatch(name, eng, rows, ids, slack, plan, card) -> dict:
    """Phase 9 (c) for one 1,024-vertex-block dispatch: the culled and the
    nocull kernel and the twin by CUDA events, beside the full-scan bound
    (every distance, by region) and the culled-work bound (`cull_plan`'s
    distances and culling work)."""
    from robocheck_tpu_torch.kernels import clearance as kc
    from robocheck_tpu_torch.planner.clearance import BLOCK
    from robocheck_tpu_torch.profiling import bounds
    from robocheck_tpu_torch.profiling.timers import event_ms

    k = len(rows)
    ms = event_ms(lambda: kc.pair_min_cuda(rows, ids, eng._blocks, eng._tab, eng._groups, slack),
                  10)
    ms_nocull = event_ms(lambda: kc.pair_min_cuda(rows, ids, eng._blocks, eng._tab), 10)
    plain = event_ms(lambda: kc.pair_min_reference(rows, ids, eng._blocks, eng._tris), 1)
    read = len(set(ids.tolist()))
    full = kc.region_counts(rows, ids, eng._blocks, eng._tris).cpu().numpy()
    part = kc.region_counts(rows, ids, eng._blocks, eng._tris, plan, eng._groups.size)
    part = part.cpu().numpy()
    b_full, by_full = bounds.bound_ms(*bounds.clearance_work(
        k, BLOCK, eng.num_triangles, read, full))
    b_cull, by_cull = bounds.bound_ms(*bounds.clearance_work(
        k, BLOCK, eng.num_triangles, read, part, plan.cpu().numpy()))
    share = ", ".join(f"{r} {n / full.sum()}" for r, n in zip(kc.REGIONS, full))
    print(f"  (c) {name}: {int(full.sum())} distances in full ({share}); the culled kernel "
          f"takes {int(part.sum())} ({part.sum() / full.sum()})")
    print(f"  (c) [{card}] {name}, {k} pairs: culled {ms} ms, nocull {ms_nocull} ms "
          f"({ms_nocull / ms}x), twin {plain} ms; culled-work bound {b_cull} ms by {by_cull} "
          f"({100 * b_cull / ms}% of culled); full-scan bound {b_full} ms by {by_full} "
          f"({100 * b_full / ms}% of culled, {100 * b_full / ms_nocull}% of nocull)")
    return {"ms": ms, "ms_nocull": ms_nocull, "plain_ms": plain, "bound_ms": b_cull,
            "bound_by": by_cull, "bound_full_ms": b_full}


def phase9_times(obstacle, rob4, eng, confs, card, device) -> dict:
    """Phase 9 (c): the old and the survivor dispatch, the representatives'
    dispatch culled and nocull, and `min_distances` end to end. Returns the
    kernel-table entry (survivor dispatch; launches filled in by the
    caller)."""
    from robocheck_tpu_torch.kernels import clearance as kc
    from robocheck_tpu_torch.planner.clearance import PAIR_CHUNK, native_min_distances
    from robocheck_tpu_torch.profiling.timers import benchmark, event_ms

    nb = eng.num_blocks
    rows = kc.pose_rows(torch.from_numpy(confs[:16]).to(device)).repeat_interleave(nb, 0)
    ids = torch.arange(nb, dtype=torch.int32, device=device).repeat(16)
    slack = 2 * eng.err_bound(confs)
    sl = slice(0, PAIR_CHUNK)
    plan = kc.cull_plan(rows[sl], ids[sl], eng._blocks, eng._tris, eng._groups, slack)
    time_dispatch("old dispatch (16 queries x 131 blocks, first 1,024)", eng, rows[sl], ids[sl],
                  slack, plan, card)
    s_rows, s_ids, s_slack = survivor_dispatch(eng, confs, PAIR_CHUNK, device)
    plan = kc.cull_plan(s_rows, s_ids, eng._blocks, eng._tris, eng._groups, s_slack)
    entry = time_dispatch("survivor dispatch (min_distances' first launch)", eng, s_rows, s_ids,
                          s_slack, plan, card)
    # The representatives as the engine launches them: per-thread culling
    # against the nocull instance it runs.
    all_rows = kc.pose_rows(torch.from_numpy(confs).to(device)).repeat_interleave(nb, 0)
    all_ids = torch.arange(nb, dtype=torch.int32, device=device).repeat(len(confs))
    r_cull = event_ms(lambda: kc.pair_min_cuda(all_rows, all_ids, eng._reps, eng._tab,
                                               eng._groups, slack), 10)
    r_nocull = event_ms(lambda: kc.pair_min_cuda(all_rows, all_ids, eng._reps, eng._tab), 10)
    print(f"  (c) [{card}] representatives, {len(all_rows)} 1-vertex pairs: nocull {r_nocull} "
          f"ms (the engine's), per-thread culled {r_cull} ms")
    for key in eng.stats:
        eng.stats[key] = 0 if isinstance(eng.stats[key], int) else 0.0
    best = benchmark(eng.min_distances, confs, runs=3)
    per = {key: eng.stats[key] / eng.stats["calls"]
           for key in ("pairs", "bounds_s", "exact_s", "exact_kernel_s", "rep_kernel_s")}
    t0 = time.perf_counter()
    native_min_distances(rob4.vertices, obstacle, confs[:32])
    native_s = time.perf_counter() - t0
    print(f"  (c) [{card}] min_distances: {len(confs) / best} configurations/s (best of 3, "
          f"warm, host clock after synchronize; {best} s); per call {per}")
    print(f"  (c) native BVH on the first 32 queries: {native_s} s, {32 / native_s} "
          f"configurations/s; clearance_vs_native {(len(confs) / best) / (32 / native_s)}")
    return {"name": "clearance_pair_min", "route": "cuda", "source": CLEARANCE_SOURCE,
            "replaces": CLEARANCE_REPLACES, "launches": 0, "max_abs_err": 0.0,
            **entry, "library_ms": None, "dispatch": "survivors"}


def nocull_engine(eng):
    """``eng`` with its exact phase on the nocull instance: the scan before
    culling, timed end to end beside the engine."""
    from robocheck_tpu_torch.planner.clearance import ClearanceEngine

    class NocullEngine(ClearanceEngine):
        def _scan(self, phase, rows, ids, table, slack=None):
            return super()._scan(phase, rows, ids, table)

    out = NocullEngine.__new__(NocullEngine)
    out.__dict__.update(eng.__dict__, stats=dict(eng.stats), _events=[])
    return out


def phase9_scaling(eng, eng16, confs, card) -> None:
    """Phase 9 (f): `min_distances` on the 1x and the 16x obstacle, culled
    and nocull, best of 3 calls on the 256 queries; the exact phase's 16x /
    1x ratio beside the JAX package's 14x on a TPU (DESIGN.md:455-462) and
    the 3x target (VERDICT.md, next #1)."""
    from robocheck_tpu_torch.profiling.timers import benchmark

    res = {}
    for name, culled in (("1x", eng), ("16x", eng16)):
        for cull in (True, False):
            e = culled if cull else nocull_engine(culled)
            for key in e.stats:
                e.stats[key] = 0 if isinstance(e.stats[key], int) else 0.0
            best = benchmark(e.min_distances, confs, runs=3)
            calls = e.stats["calls"]
            res[name, cull] = {"configs_per_s": len(confs) / best,
                               "exact_s": e.stats["exact_s"] / calls,
                               "exact_kernel_s": e.stats["exact_kernel_s"] / calls,
                               "pairs": e.stats["pairs"] / calls}
            print(f"  (f) [{card}] {name} obstacle ({e.num_triangles} triangles), "
                  f"{'culled' if cull else 'nocull'}: {json.dumps(res[name, cull])}")
    for cull in (True, False):
        a, b = res["1x", cull], res["16x", cull]
        print(f"  (f) {'culled' if cull else 'nocull'}: 16x / 1x exact_s "
              f"{b['exact_s'] / a['exact_s']}, exact_kernel_s "
              f"{b['exact_kernel_s'] / a['exact_kernel_s']}, configurations/s "
              f"{a['configs_per_s'] / b['configs_per_s']}x fewer (JAX on a TPU: 14x; target "
              f"<= 3x)")


def phase9_subdivided(obstacle, rob4, card: str, device) -> None:
    """Phase 9 (g): the obstacle at three rounds of subdivision (64,512
    triangles): soundness against the native BVH on the first 32 queries,
    the first 64 survivor pairs held as in (a), and the engine's kept-scan
    counter over one call against `cull_plan` over that call's launches."""
    from robocheck_tpu_torch.kernels import _build
    from robocheck_tpu_torch.kernels import clearance as kc
    from robocheck_tpu_torch.planner.ccd import subdivide_mesh
    from robocheck_tpu_torch.planner.clearance import ClearanceEngine, clearance_queries

    obstacle64 = subdivide_mesh(obstacle, 3)
    eng = ClearanceEngine(rob4.vertices, obstacle64, device=device)
    require(eng.num_triangles == 64 * 1008, "not the 64x obstacle")
    smem = _build.library("clearance").rc_clearance_smem_bytes(eng.num_triangles)
    print(f"  (g) 64x obstacle: {eng.num_triangles} triangles in {eng.num_groups} groups "
          f"({int(eng._groups.always.sum())} always scanned), engine built in "
          f"{eng.stats['construct_s']} s; the table "
          f"{'staged in' if smem else 'read through the L2 by'} the scanning blocks")
    confs = clearance_queries(obstacle)[:32]
    sweep_soundness("64x obstacle, first 32", eng, rob4.vertices, obstacle64, confs)
    s_rows, s_ids, s_slack = survivor_dispatch(eng, confs, 64, device)
    hold_scan("64x obstacle, survivors", s_rows, s_ids, eng._blocks, eng._tris, eng._groups,
              s_slack, device)
    launches = []
    scan = eng._scan

    def recorded(phase, rows, ids, table, slack=None):
        if slack is not None:
            launches.append((rows, ids, table, slack))
        return scan(phase, rows, ids, table, slack)

    eng._scan = recorded
    before = eng.counters()
    t0 = time.perf_counter()
    eng.min_distances(confs)
    wall = time.perf_counter() - t0
    after = eng.counters()
    planned = sum(int(kc.cull_plan(r, i, t, eng._tris, eng._groups, sl).sum())
                  for r, i, t, sl in launches)
    kept = after["scans_kept"] - before["scans_kept"]
    scans = after["scans"] - before["scans"]
    print(f"  (g) [{card}] 64x obstacle, one call of {len(confs)} queries ({wall} s, "
          f"{len(launches)} exact launches): kept scans {kept} of {scans} "
          f"({100 * kept / max(scans, 1)}%), cull_plan {planned}")
    require(kept == planned, "(g) the engine's kept-scan counter differs from cull_plan's count")


def phase9_engine(robot, obstacle, card: str, device) -> dict:
    """Phase 9 (a)-(c) and (f) on bench.py's clearance scene and its 16x
    obstacle, (g) on its 64x obstacle. Returns the scan kernel's table entry
    (launches filled in by the caller)."""
    from robocheck_tpu_torch.kernels import _build
    from robocheck_tpu_torch.planner.ccd import subdivide_mesh
    from robocheck_tpu_torch.planner.clearance import ClearanceEngine, clearance_queries

    rob4 = subdivide_mesh(robot, 4)
    eng = ClearanceEngine(rob4.vertices, obstacle, device="cuda")
    obstacle16 = subdivide_mesh(obstacle, 2)
    eng16 = ClearanceEngine(rob4.vertices, obstacle16, device="cuda")
    print(f"[9] clearance engine on bench.py's scene: refine-4 alpha robot, "
          f"{eng.num_vertices} vertices, {eng.num_blocks} blocks, {eng.num_triangles} "
          f"obstacle triangles in {eng.num_groups} groups ({int(eng._groups.always.sum())} "
          f"always scanned); engine built in {eng.stats['construct_s']} s; 16x obstacle "
          f"{eng16.num_triangles} triangles in {eng16.num_groups} groups "
          f"({int(eng16._groups.always.sum())} always scanned)")
    require((eng.num_vertices, eng.num_blocks) == (133902, 131), "not bench.py's robot")
    require(eng16.num_triangles == 16 * eng.num_triangles, "not the 16x obstacle")
    spills = [ln.strip() for ln in _build.build()["clearance"][1].splitlines()
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    require(not spills, f"the scan kernel spills registers: {spills}")
    lib = _build.library("clearance")
    for name, e in (("1x", eng), ("16x", eng16)):
        smem = lib.rc_clearance_smem_bytes(e.num_triangles)
        print(f"  {name} obstacle: the table {'staged in' if smem else 'read through the L2 by'} "
              f"the scanning blocks ({smem} bytes of dynamic shared memory)")
    confs = clearance_queries(obstacle)
    err = phase9_kernel(eng, eng16, confs, device)
    phase9_soundness(robot, obstacle, rob4, eng, eng16, obstacle16, confs, device)
    entry = phase9_times(obstacle, rob4, eng, confs, card, device)
    phase9_scaling(eng, eng16, confs, card)
    phase9_subdivided(obstacle, rob4, card, device)
    entry["max_abs_err"] = err
    return entry


def phase9_certify(robot, obstacle, card: str) -> tuple[int, int]:
    """Phase 9 (d)-(e): both alpha legs through `certify_multires` on the
    card, and a tunneling path refuted. Returns the launches of K1 and of
    the scan kernel in the legs' run."""
    from robocheck_tpu_torch import make_checker
    from robocheck_tpu_torch.kernels import clearance as kc
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.kernels import sdf as ks
    from robocheck_tpu_torch.models.shapes import box
    from robocheck_tpu_torch.planner.ccd import certify_multires

    cert_alpha = runpy.run_path(os.path.join(ROOT, "scripts", "torch_certify_alpha.py"),
                                run_name="imported")
    checker = make_checker(robot, obstacle, device="cuda")
    mk.check_poses_cuda.launches = 0
    kc.pair_min_cuda.launches = 0
    ks.sdf_grid_cuda.launches = 0
    zero_front()
    records = [cert_alpha["certify_leg"](leg, robot, obstacle, checker) for leg in CERTIFY_LEGS]
    torch.cuda.synchronize()
    k1, scans = mk.check_poses_cuda.launches, kc.pair_min_cuda.launches
    # certify_multires measures exact distances (the engine): no grid.
    GRID_LAUNCHES["certifier (9 (d))"] = ks.sdf_grid_cuda.launches
    read_front("certifier (9 (d))")
    for rec in records:
        print(f"  (d) [{card}] {json.dumps(rec)}")
        require(rec["certified"] and not rec["collision"] and rec["uncertified_steps"] == 0,
                f"(d) the {rec['leg']} leg is not certified with 0 uncertified steps")
        stats = rec["engine_stats"]
        ref = rec["reference_num_checks"] or "no count"
        print(f"  (d) {rec['leg']} leg: {rec['num_checks']} checks (must be "
              f"{CERTIFY_CHECKS[rec['leg']]}; JAX package: {ref} on "
              f"{rec['reference_of'] or 'this file'}), {rec['wall_s']} s; exact_kernel_s "
              f"{stats['exact_kernel_s']}, rep_kernel_s {stats['rep_kernel_s']}, exact_s "
              f"{stats['exact_s']}, pairs {stats['pairs']}")
        require(rec["num_checks"] == CERTIFY_CHECKS[rec["leg"]],
                f"(d) the {rec['leg']} leg took {rec['num_checks']} checks")
    print(f"  (d) launches in the legs' run: K1 {k1}, scan kernel {scans}, K4 "
          f"{GRID_LAUNCHES['certifier (9 (d))']} (exact distances, no grid)")
    require(k1 > 0 and scans > 0, "(d) the legs did not launch both kernels")

    robot_box, wall = box(extent=(0.1, 0.1, 0.1), name="r"), box(extent=(0.4, 4.0, 4.0))
    tun = np.zeros((2, 6), np.float32)
    tun[0, 0], tun[1, 0] = -2.0, 2.0
    res = certify_multires(robot_box, wall, tun,
                           make_checker(robot_box, wall, device="cuda"), levels=((0, 6), (2, 8)))
    print(f"  (e) tunneling path through tests/test_clearance.py's wall: collision "
          f"{res.collision}, certified {res.certified}, {res.num_checks} checks")
    require(res.collision and not res.certified, "(e) the tunneling path is not refuted")
    return k1, scans


def phase10_parity(opt, robot, obstacle, init, card: str) -> dict:
    """Phase 10 (c): the SQP constraint blocks and the TrajOpt cost and
    gradient on the card and on the CPU (the same grid values, moved), on
    the alpha init; returns each one's worst error over its tolerance (1.0:
    at the tolerance)."""
    from robocheck_tpu_torch.planner import (SQPOptimizer, TrajectoryOptimizer, TrajOptConfig,
                                             grid_from_arrays)
    from robocheck_tpu_torch.planner.trajopt import _pose_points

    grid = opt.grid
    cpu_grid = grid_from_arrays(grid.values.cpu().numpy(), grid.origin.cpu().numpy(),
                                grid.spacing.cpu().numpy(), device="cpu")
    cpu = SQPOptimizer(robot, obstacle, opt.cfg, grid=cpu_grid, checker=opt.checker,
                       device="cpu")
    q_card, q_cpu = torch.from_numpy(init).cuda(), torch.from_numpy(init)
    g, J, tot = opt._constraint_blocks(q_card)
    g_ref, J_ref, tot_ref = cpu._constraint_blocks(q_cpu)
    g, J = g.cpu(), J.cpu()
    idx, idx_ref = opt._top_residuals(q_card)[1].cpu(), cpu._top_residuals(q_cpu)[1]
    scale = max(1.0, float(_pose_points(q_cpu, cpu._samples).abs().max()))
    d = cpu.grid.query(_pose_points(q_cpu, cpu._samples))
    top = torch.topk(cpu.cfg.margin - d, cpu.cfg.top_k + 1, dim=-1)[0]
    gap = (top[:, -2] - top[:, -1]).numpy()
    same = (idx.sort(dim=1)[0] == idx_ref.sort(dim=1)[0]).all(dim=1).numpy()

    def worst(got, want, rtol, atol):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max(initial=0.0))

    out = {"g": worst(g, g_ref, G_TOL[0], G_TOL[1] * scale),
           "J": worst(J[same], J_ref[same], J_TOL[0], J_TOL[1] * scale),
           "total": abs(tot - tot_ref) / (1e-4 * max(1.0, abs(tot_ref)))}
    print(f"  (c) SQP blocks, card vs CPU, alpha init ({len(init)} waypoints, coordinate scale "
          f"{scale}): top-K samples equal on {int(same.sum())}/{len(same)} waypoints "
          f"(smallest K/K+1 gap {float(gap.min())}); g max abs err "
          f"{float((g - g_ref).abs().max())}, J {float((J - J_ref)[same].abs().max())}, "
          f"total {tot} / {tot_ref}; worst error over tolerance {json.dumps(out)}")
    require(bool(same[gap > 1e-3].all()), "(c) the card picks other top-K samples at a clear gap")
    topt = TrajOptConfig(num_waypoints=len(init), margin=opt.cfg.margin,
                         grid_resolution=opt.cfg.grid_resolution)
    card_opt = TrajectoryOptimizer(robot, obstacle, topt, grid=grid, checker=opt.checker)
    cpu_opt = TrajectoryOptimizer(robot, obstacle, topt, grid=cpu_grid, checker=opt.checker,
                                  device="cpu")
    for w in (10.0, 640.0):
        grads, costs = [], []
        for o, q in ((card_opt, q_card), (cpu_opt, q_cpu)):
            free = q[1:-1].clone().requires_grad_(True)
            c = o.cost(free, (q[0], q[-1]), w)
            c.backward()
            costs.append(float(c.detach()))
            grads.append(free.grad.cpu().numpy())
        gmax = float(np.abs(grads[1]).max())
        err = {"cost": abs(costs[0] - costs[1]) / (COST_RTOL * abs(costs[1])),
               "grad": worst(grads[0], grads[1], GRAD_TOL[0], GRAD_TOL[1] * gmax)}
        print(f"  (c) TrajOpt cost and gradient, w {w}, card vs CPU: cost {costs[0]} / {costs[1]},"
              f" gradient max abs err {float(np.abs(grads[0] - grads[1]).max())} (largest "
              f"component {gmax}); worst error over tolerance {json.dumps(err)}")
        out[f"cost_w{w:g}"], out[f"grad_w{w:g}"] = err["cost"], err["grad"]
    require(all(v <= 1.0 for v in out.values()), f"(c) card and CPU disagree: {out}")
    return out


def phase10_times(opt, init, card: str) -> dict:
    """Phase 10 (d): an SQP outer iteration's parts on the alpha init (host
    clock after synchronize, best of 5), one Adam step and one round of the
    wall scene's optimizer (host clock, and the device's busy share of the
    round from a trace)."""
    from robocheck_tpu_torch.models.shapes import box, icosphere
    from robocheck_tpu_torch.planner import TrajectoryOptimizer, TrajOptConfig
    from robocheck_tpu_torch.profiling import timers

    q = torch.from_numpy(init).cuda()
    mu, delta = opt.cfg.penalty_init, opt.cfg.trust_init
    g0, J, tot = opt._constraint_blocks(q)
    dq = opt._solve_subproblem(q, g0, J, mu, delta)
    t = {"blocks_s": timers.benchmark(opt._constraint_blocks, q),
         "subproblem_s": timers.benchmark(opt._solve_subproblem, q, g0, J, mu, delta),
         "merit_s": timers.benchmark(
             lambda: float(opt._smooth_cost(q)) + mu * tot + opt._merit(q + dq, mu)),
         "certify_s": timers.benchmark(opt._certify, init)}
    t["outer_s"] = t["blocks_s"] + t["subproblem_s"] + t["merit_s"]
    print(f"  (d) [{card}] SQP outer iteration on the alpha init ({len(init)} waypoints x "
          f"{opt.cfg.num_surface_samples} samples, {opt.cfg.subproblem_iters} subproblem "
          f"steps; outer_s = blocks + subproblem + merit; certify_s: one trajectory's "
          f"certification, the most a harvest waits): {json.dumps(t)}")
    robot, wall = icosphere(1, radius=0.3, name="robot"), box(extent=(0.5, 3.0, 3.0), name="wall")
    topt = TrajectoryOptimizer(robot, wall, TrajOptConfig(num_waypoints=24, iters_per_round=150,
                                                          max_rounds=4, margin=0.25))
    start = np.array([-3, 0, 0, 0, 0, 0], np.float32)
    q0 = topt.initial_trajectory(start, -start)
    ends = (torch.from_numpy(start).cuda(), torch.from_numpy(-start).cuda())
    free0 = torch.from_numpy(q0[1:-1].copy()).cuda()
    free = free0.clone().requires_grad_(True)
    adam = torch.optim.Adam([free], lr=topt.cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    w = topt.cfg.collision_weight
    t["adam_step_s"] = timers.benchmark(topt.adam_step, free, adam, ends, w, runs=20)
    t["adam_step_event_ms"] = timers.event_ms(lambda: topt.adam_step(free, adam, ends, w), 50)
    t["round_s"] = timers.benchmark(topt.optimize_round, free0, ends, w, runs=3)
    busy, _, profiled_ms = timers.device_busy(lambda: topt.optimize_round(free0, ends, w))
    busy, profiled_ms = busy * 1e3, profiled_ms * 1e3
    t["round_busy_ms"], t["round_profiled_ms"] = busy, profiled_ms
    t["round_busy_share"] = busy / (t["round_s"] * 1e3)
    print(f"  (d) [{card}] wall-scene TrajOpt (24 waypoints x 256 samples, 4 subsamples): "
          f"Adam step {t['adam_step_s'] * 1e3} ms (host, synchronised; back to back by events "
          f"{t['adam_step_event_ms']} ms), round of {topt.cfg.iters_per_round} steps "
          f"{t['round_s'] * 1e3} ms; device busy {busy} ms of the round "
          f"({100 * t['round_busy_share']}% of the unprofiled round; profiled {profiled_ms} ms)")
    return t


def phase10_idle(runs, card: str) -> None:
    """Phase 10 (d): the card's busy and idle share over (a), each of
    ``runs`` ((name, a call repeating it, its unprofiled wall s)) again under
    a `torch.profiler` trace."""
    from robocheck_tpu_torch.profiling import timers

    for name, fn, unprofiled in runs:
        torch.cuda.synchronize()
        busy, records, profiled = timers.device_busy(fn)
        print(f"  (d) [{card}] (a) {name}: device busy {busy} s in {records} device events; "
              f"unprofiled wall {unprofiled} s, profiled {profiled} s; idle share "
              f"{1.0 - busy / unprofiled} of the unprofiled wall ({1.0 - busy / profiled} of "
              f"the profiled)")


def phase10(robot, obstacle, card: str) -> tuple[int, int, dict]:
    """The gradient planners on the card (phase 10). Returns the launches of
    K1 and of the scan kernel in (a)-(b), and (a)'s SQP record."""
    from robocheck_tpu_torch import make_checker
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.io.parasol import read_query
    from robocheck_tpu_torch.kernels import clearance as kc
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.kernels import sdf as ks
    from robocheck_tpu_torch.planner import resample

    cert_alpha = runpy.run_path(os.path.join(ROOT, "scripts", "torch_certify_alpha.py"),
                                run_name="imported")
    demo = runpy.run_path(os.path.join(ROOT, "scripts", "torch_demo_planner.py"),
                          run_name="imported")
    query = read_query(assets.find_asset("models/alpha1.0/alpha.query"))
    stored = {k: np.load(assets.find_asset(f"data/alpha_{k}_path.npy"))
              for k in ("certified", "smoothed")}
    init = resample(stored["certified"], 48)
    checker = make_checker(robot, obstacle, device="cuda")
    print("[10] gradient planners on the card")
    t_start = time.perf_counter()
    mk.check_poses_cuda.launches = 0
    kc.pair_min_cuda.launches = 0
    ks.sdf_grid_cuda.launches = 0
    zero_front()
    res, opt, rec = cert_alpha["smooth_alpha"](robot, obstacle, checker)
    print(f"  (a) [{card}] SQP smoothing of the alpha RRT path: {json.dumps(rec)}")
    require(res.certified, "(a) the SQP-smoothed alpha path is not certified")
    leg = cert_alpha["certify_leg"]("sqp", robot, obstacle, checker, path=res.trajectory)
    print(f"  (a) [{card}] {json.dumps(leg)}")
    require(leg["certified"] and not leg["collision"] and leg["uncertified_steps"] == 0,
            "(a) the smoothed path is not certified with 0 uncertified steps")
    diff = float(np.abs(res.trajectory - stored["smoothed"]).max())
    print(f"  (a) smoothed path: {leg['num_checks']} checks (ALPHA_CCD.json: "
          f"{leg['reference_num_checks']}, {leg['reference_of']}); {rec['outer_iters']} outer "
          f"iterations (12 since PR 7); largest abs difference from "
          f"data/alpha_smoothed_path.npy {diff}; the 96^3 grid (K4) {rec['grid_s']} s of "
          f"construct_s {rec['construct_s']} s")
    wall = demo["wall_demo"]("cuda", ccd=True)
    print(f"  (b) [{card}] wall scene, plan_and_smooth with swept_certify: {json.dumps(wall)}")
    require(wall["found"] and wall["certified"] and wall["swept"]["certified"],
            "(b) the wall scene's path is not certified discretely and continuously")
    torch.cuda.synchronize()
    k1, scans = mk.check_poses_cuda.launches, kc.pair_min_cuda.launches
    read_front("gradient planners (10 (a)-(b))")
    print(f"  launches in (a)-(b): K1 {k1}, scan kernel {scans}")
    require(k1 > 0 and scans > 0, "(a)-(b) did not launch both kernels")
    t_ab = time.perf_counter() - t_start
    phase10_parity(opt, robot, obstacle, init, card)
    phase10_times(opt, init, card)
    phase10_idle((("SQP plan", lambda: opt.plan(query[0], query[1], init=init), rec["plan_s"]),
                  ("certify_multires", lambda: cert_alpha["certify_leg"](
                      "sqp", robot, obstacle, checker, verbose=False, path=res.trajectory),
                   leg["wall_s"])), card)
    torch.cuda.synchronize()
    grids = GRID_LAUNCHES["gradient planners (10 (a)-(d))"] = ks.sdf_grid_cuda.launches
    print(f"  K4 launches in (a)-(d): {grids}")
    require(grids > 0, "(a)-(d) built no distance grid with K4")
    print(f"  [{card}] phase 10: {time.perf_counter() - t_start} s, of which (a)-(b) {t_ab} s "
          f"((a) SQP {rec['sqp_smooth_wall_s']} s and its certificate {leg['wall_s']} s, (b) "
          f"{wall['wall_s']} s)")
    return k1, scans, rec


def phase11(robot, obstacle, data, card: str, resolved_s: dict) -> None:
    """The dense reference pipeline `CollisionWorld` on the card (phase 11):
    0 golden mismatches on hard10k and easy10k, the header's valid count on
    10,000samples; ms per 10k rows beside phase 5's `check_valid_resolved`,
    and at ``narrow_chunk`` 64 (fewer syncs) beside the default 8. It runs
    no kernel of its own (the JAX package's is XLA)."""
    from robocheck_tpu_torch.ops.pipeline import CollisionWorld, PipelineConfig

    print("[11] CollisionWorld (torch ops, no kernel) on the card")
    t_start = time.perf_counter()
    worlds = {8: CollisionWorld(robot, obstacle, device="cuda"),
              64: CollisionWorld(robot, obstacle, PipelineConfig(narrow_chunk=64), device="cuda")}
    for w in worlds.values():
        w.check(data["hard10k"].confs[:64])  # warm-up
    for key, ds in data.items():
        # The default (narrow_chunk 8) on every set, timed by the pass
        # itself (`check` returns host arrays); 64 on hard10k and easy10k.
        t0 = time.perf_counter()
        valid, res = worlds[8].check(ds.confs, return_result=True)
        ms = {8: (time.perf_counter() - t0) * 1e3 * 1e4 / len(ds.confs)}
        msg = (f"  {key}: {int(valid.sum())} valid, {int(res.coplanar.sum())} flagged coplanar "
               f"(to float64), {int((~res.broad_valid).sum())} broad-phase hits, "
               f"{int(res.num_pairs.sum())} box-overlapping pairs, overflow "
               f"{int(res.overflow.sum())}")
        if key == "samples10k":
            print(f"{msg}; header says {ds.header_valid} valid")
            require(int(valid.sum()) == ds.header_valid, f"[11] {key}: valid count off the header")
            continue
        mism = int((valid != ds.valid).sum())
        print(f"{msg}; {mism} golden mismatches")
        require(mism == 0, f"[11] {key}: {mism} golden mismatches")
        t0 = time.perf_counter()
        require(np.array_equal(worlds[64].check(ds.confs), valid),
                f"{key}: narrow_chunk 64 changes a verdict")
        ms[64] = (time.perf_counter() - t0) * 1e3 * 1e4 / len(ds.confs)
        print(f"  [{card}] {key}: CollisionWorld {ms[8]} ms per 10k rows (narrow_chunk 8; 64: "
              f"{ms[64]} ms, the same verdicts); check_valid_resolved "
              f"{resolved_s[key] * 1e3 * 1e4 / len(ds.confs)} ms per 10k rows (phase 5)")
    print(f"  [{card}] phase 11: {time.perf_counter() - t_start} s")


def phase12_rank() -> dict:
    """One rank of phase 12 (a)-(c), in a spawned process of a gloo group of
    2 on the one card. Counts the kernels' launches of the legs from 0 (a
    fresh process); the timed reruns come after the counts are read."""
    from robocheck_tpu_torch import load_obj, read_conf_file
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.kernels import clearance as kc
    from robocheck_tpu_torch.kernels import front
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.kernels import resolve as rs
    from robocheck_tpu_torch.kernels import sdf as ks
    from robocheck_tpu_torch.parallel.sharding import ShardedChecker, make_mesh
    from robocheck_tpu_torch.planner.ccd import subdivide_mesh
    from robocheck_tpu_torch.planner.clearance import ClearanceEngine, clearance_queries
    from robocheck_tpu_torch.profiling.timers import benchmark
    from robocheck_tpu_torch.runtime.distributed import shard_bounds

    mesh = make_mesh(2, "cuda", backend="gloo")
    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    hard = read_conf_file(assets.dataset_path("hard10k")).confs
    checker = ShardedChecker(robot, obstacle, mesh)
    out = {"rank": mesh.rank, "device": str(mesh.device)}
    # (a) the checker on all of hard10k, and 256 rows read per rank.
    out["packed"] = checker.check_packed(hard)
    out["resolved"] = checker.check_valid_resolved(hard)
    out["resolve_launches"] = rs.resolve_rows_cuda.launches
    block, totals = checker.check_block(hard)
    out["block"], out["totals"] = block.numpy(), totals.numpy()
    lo, hi = shard_bounds(256)
    out["dist_rows"] = (lo, hi)
    out["dist_valid"] = checker.check_valid_distributed(hard[lo:hi], 256)[0]
    # (b) the engine on bench.py's clearance scene.
    eng = ClearanceEngine(subdivide_mesh(robot, 4).vertices, obstacle, mesh=mesh)
    queries = clearance_queries(obstacle)
    out["dist"] = eng.min_distances(queries)
    # (c) phase 10 (a)'s SQP with sharded blocks and checker, and its
    # certificate with the engine sharded.
    cert_alpha = runpy.run_path(os.path.join(ROOT, "scripts", "torch_certify_alpha.py"),
                                run_name="imported")
    res, _, rec = cert_alpha["smooth_alpha"](robot, obstacle, checker, mesh=mesh)
    out["sqp"] = rec
    out["sqp_cert"] = cert_alpha["certify_leg"]("sqp", robot, obstacle, checker, verbose=False,
                                                path=res.trajectory, mesh=mesh)
    torch.cuda.synchronize()
    out["launches"] = {"megakernel": mk.check_poses_cuda.launches,
                       "megakernel_stats": mk.check_poses_stats_cuda.launches,
                       "clearance": kc.pair_min_cuda.launches}
    out["front"] = {"pose_rows": front.poses_from_confs_cuda.launches,
                    "robot_bounds": front.robot_bounds_cuda.launches}
    out["sdf_grid"] = ks.sdf_grid_cuda.launches
    out["check_s"] = benchmark(checker.check_valid_resolved, hard)
    out["engine_s"] = benchmark(eng.min_distances, queries, runs=3)
    return out


def phase12(robot, obstacle, data, checker, card: str, sqp_ref: dict) -> dict:
    """Scale-out on the card (phase 12): two gloo ranks spawned on the one
    card run (a) `ShardedChecker` on hard10k, (b) the sharded engine, (c)
    the sharded SQP and its certificate; (d) `torch_graft_entry.
    dryrun_multichip(2)`. Everything is held against a world of 1 here.
    Returns the launches of each kernel in the ranks."""
    import torch_graft_entry
    from robocheck_tpu_torch.parallel.sharding import ShardedChecker
    from robocheck_tpu_torch.planner.ccd import subdivide_mesh
    from robocheck_tpu_torch.planner.clearance import ClearanceEngine, clearance_queries
    from robocheck_tpu_torch.profiling.timers import benchmark
    from robocheck_tpu_torch.runtime.distributed import launch

    print("[12] scale-out: 2 gloo ranks (spawned processes) on the one card")
    t_start = time.perf_counter()
    hard = data["hard10k"]
    ranks = launch(phase12_rank, 2, timeout=600.0)
    t_ranks = time.perf_counter() - t_start
    r0 = ranks[0]
    print(f"  ranks on {[r['device'] for r in ranks]}, done in {t_ranks} s")
    # (a) against the world of 1 and the goldens. Bits 1-2 of a colliding
    # row depend on the pairs the kernel reached before its any-hit exit, an
    # order its warps settle at run time: phase 3's rule compares bit 0 on
    # every row and the whole byte on valid rows. Two world-of-1 runs show
    # how often a colliding row's bits move.
    packed1 = checker.check_packed(hard.confs)
    moved = int((checker.check_packed(hard.confs) != packed1).sum())
    block1 = checker.check_block(hard.confs).cpu().numpy()
    mism = int((r0["resolved"] != hard.valid).sum())
    tot = r0["totals"]
    dist_valid = np.concatenate([r["dist_valid"] for r in ranks])
    print(f"  (a) check_packed on hard10k: bytes equal to the world of 1's on "
          f"{int((r0['packed'] == packed1).sum())} / {len(packed1)} rows (two world-of-1 runs: "
          f"{moved} rows differ); check_valid_resolved "
          f"{int(r0['resolved'].sum())} valid, {mism} golden mismatches; check_block totals "
          f"{tot.tolist()} (valid, colliding, coplanar); check_valid_distributed on rows "
          f"{[r['dist_rows'] for r in ranks]}: {int(dist_valid.sum())} valid, "
          f"{int((dist_valid != hard.valid[:256]).sum())} golden mismatches")
    for r in ranks:
        compare_bits(f"(a) rank {r['rank']} bytes vs the world of 1's",
                     torch.from_numpy(r["packed"]), torch.from_numpy(packed1))
    require(mism == 0, f"(a) {mism} golden mismatches under sharding")
    require(all(r["resolve_launches"] == 1 for r in ranks),
            "(a) a rank's check_valid_resolved did not launch the resolution kernel once")
    require(tot[0] == r0["block"][:, 0].sum() and tot[0] + tot[1] == len(hard.confs)
            and tot[2] == r0["block"][:, 1].sum(), "(a) the totals differ from the rows' counts")
    require(np.array_equal(r0["block"][:, [0, 3]], block1[:, [0, 3]]),
            "(a) the counter rows' valid or broad column differs from the world of 1's")
    require(np.array_equal(dist_valid, hard.valid[:256])
            and np.array_equal(dist_valid, (packed1[:256] & 1) == 1),
            "(a) check_valid_distributed differs from the goldens or the world of 1")
    s1 = benchmark(ShardedChecker(robot, obstacle).check_valid_resolved, hard.confs)
    s2 = max(r["check_s"] for r in ranks)
    print(f"  (a) [{card}] check_valid_resolved on hard10k, best of 5: 1 rank {s1 * 1e3} ms "
          f"({len(hard.confs) / s1} checks/s); 2 ranks {s2 * 1e3} ms ({len(hard.confs) / s2} "
          f"checks/s)")
    # (b) bit-equal to the world of 1's engine.
    eng = ClearanceEngine(subdivide_mesh(robot, 4).vertices, obstacle, device="cuda")
    queries = clearance_queries(obstacle)
    d1 = eng.min_distances(queries)
    same = all(np.array_equal(r["dist"], d1) for r in ranks)
    print(f"  (b) engine distances on bench.py's scene ({len(queries)} queries): bit-equal to "
          f"the world of 1's: {same} (max abs diff {float(np.abs(r0['dist'] - d1).max())})")
    require(same, "(b) the sharded engine's distances differ from the world of 1's")
    e1 = benchmark(eng.min_distances, queries, runs=3)
    e2 = max(r["engine_s"] for r in ranks)
    print(f"  (b) [{card}] min_distances: 1 rank {len(queries) / e1} configurations/s, 2 ranks "
          f"{len(queries) / e2}")
    # (c) the sharded SQP against phase 10 (a).
    rec, cert = r0["sqp"], r0["sqp_cert"]
    print(f"  (c) [{card}] sharded SQP: {json.dumps(rec)}")
    print(f"  (c) its certificate: {cert['num_checks']} checks (ALPHA_CCD.json: "
          f"{cert['reference_num_checks']}), certified {cert['certified']}, uncertified steps "
          f"{cert['uncertified_steps']}, {cert['wall_s']} s; phase 10 (a): outer iterations "
          f"{sqp_ref['outer_iters']}, merit {sqp_ref['merit']}, plan {sqp_ref['plan_s']} s")
    require(rec["sqp_smooth_certified"] and rec["outer_iters"] == sqp_ref["outer_iters"],
            "(c) the sharded SQP does not certify at phase 10 (a)'s outer iteration")
    require(abs(rec["merit"] - sqp_ref["merit"]) <= 1e-5 * abs(sqp_ref["merit"]),
            "(c) the sharded SQP's merit is off phase 10 (a)'s (rel 1e-5)")
    require(cert["certified"] and not cert["collision"] and cert["uncertified_steps"] == 0,
            "(c) the sharded SQP's path is not certified with 0 uncertified steps")
    # (d) torch_graft_entry's dryrun.
    dry = torch_graft_entry.dryrun_multichip(2, "cuda")
    launches = {k: sum(r["launches"][k] for r in ranks + dry) for k in r0["launches"]}
    front12 = FRONT_LAUNCHES["scale-out (12), ranks (a)-(c)"] = {
        k: sum(r["front"][k] for r in ranks) for k in r0["front"]}
    print(f"  launches in the ranks (a)-(d): {launches}; K2 and K5 in (a)-(c): {front12}")
    require(all(launches.values()), "phase 12 did not launch every kernel of its path")
    require(front12["pose_rows"] > 0, "phase 12's ranks did not launch K2")
    grids = GRID_LAUNCHES["scale-out (12), ranks (c)"] = sum(r["sdf_grid"] for r in ranks)
    print(f"  K4 launches in the ranks: {grids}")
    require(grids > 0, "phase 12's ranks built no distance grid with K4")
    print(f"  [{card}] phase 12: {time.perf_counter() - t_start} s")
    return launches


def phase13_shapes(checker, card: str) -> dict:
    """Phase 13 (c): K1 against its twin on all of hard100k in one launch
    (the main path's) and on the latency leg's batch posed on its own.
    Times the one launch (kernel: CUDA events, mean of 20; twin: one call)
    and returns them with the max abs error and the launch's counter rows
    (for its bound)."""
    from robocheck_tpu_torch import read_conf_file
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.profiling.timers import event_ms

    confs = read_conf_file(assets.dataset_path("hard100k")).confs
    tables = checker.tables
    poses = mk.poses_from_confs(torch.from_numpy(confs).to(checker.device))
    shapes = {"one launch": poses,
              "latency batch": mk.poses_from_confs(
                  torch.from_numpy(confs[:LATENCY_BATCH]).to(checker.device))}
    out = {"max_abs_err": 0}
    for name, rows in shapes.items():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = mk.check_poses_reference(rows, tables)
        end.record()
        end.synchronize()
        got = mk.check_poses_cuda(rows, tables)
        err, *_ = compare_bits(f"(c) hard100k {name} {list(rows.shape)}, kernel vs twin",
                               got, want)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if name == "one launch":
            out["plain_ms"] = start.elapsed_time(end)
            out["ms"] = event_ms(lambda: mk.check_poses_cuda(rows, tables), 20)
            out["counter_rows"] = mk.check_poses_stats_cuda(rows, tables).cpu().numpy()
            print(f"  (c) [{card}] kernel alone, hard100k {list(rows.shape)}: {out['ms']} ms; "
                  f"twin: {out['plain_ms']} ms")
    return out


def phase13_one_launch(checker, card: str) -> None:
    """Phase 13 (c): `check_packed`'s one K1 launch against launches of
    CHUNK rows on hard100k, easy100k and a mixed pool (their rows
    interleaved 50/50): one launch against ceil(n / CHUNK), bit 0 equal on
    every row and the byte on valid rows (a colliding row's bits 1-2 follow
    the kernel's run-time order), and K1 alone both ways (CUDA events, mean
    of 20)."""
    from robocheck_tpu_torch import read_conf_file
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.profiling.timers import event_ms

    hard, easy = (read_conf_file(assets.dataset_path(k)).confs for k in ("hard100k", "easy100k"))
    mixed = np.empty_like(hard)
    mixed[0::2], mixed[1::2] = hard[: (len(hard) + 1) // 2], easy[: len(hard) // 2]
    for key, confs in (("hard100k", hard), ("easy100k", easy), ("mixed", mixed)):
        n, k0 = len(confs), mk.check_poses_cuda.launches
        one = checker.check_packed(confs)
        k1 = mk.check_poses_cuda.launches
        split = checker.check_packed(confs, chunk=CHUNK)
        launches = (k1 - k0, mk.check_poses_cuda.launches - k1)
        valid = (split & 1) == 1
        bit0 = int(((one ^ split) & 1).sum())
        byte = int((one[valid] != split[valid]).sum())
        poses = mk.poses_from_confs(torch.from_numpy(confs).to(checker.device))

        def chunked(poses=poses):
            for lo in range(0, len(poses), CHUNK):
                mk.check_poses_cuda(poses[lo : lo + CHUNK], checker.tables)

        t_one = event_ms(lambda: mk.check_poses_cuda(poses, checker.tables), 20)
        t_split = event_ms(chunked, 20)
        print(f"  (c) [{card}] {key} [{n},16]: K1 launches {launches[0]} / {launches[1]} "
              f"(one launch / chunk={CHUNK}); {int(valid.sum())} valid; bit 0 differs on {bit0} "
              f"rows, the byte on {byte} valid rows; K1 alone {t_one} ms in one launch, "
              f"{t_split} ms in {-(-n // CHUNK)}")
        require(launches == (1, -(-n // CHUNK)), f"(c) {key}: K1 launches {launches}")
        require(bit0 == 0 and byte == 0,
                f"(c) {key}: one launch and chunks of {CHUNK} differ ({bit0}, {byte})")


def phase13(checker, card: str) -> tuple[int, int, dict]:
    """The 100k sets and the port's bench (phase 13). Returns the launches
    of K1 and of the scan kernel in (a) and in the bench's run, and (c)'s
    record."""
    from robocheck_tpu_torch import read_conf_file
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.kernels import megakernel as mk

    t_start = time.perf_counter()
    make = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "torch_make_datasets.py"),
                           "--sizes", "100000"], capture_output=True, text=True, timeout=900)
    for line in make.stdout.splitlines():
        print(f"  (a) {line}")
    require(make.returncode == 0, f"(a) torch_make_datasets.py failed: {make.stderr[-2000:]}")
    print(f"  (a) [{card}] torch_make_datasets.py --sizes 100000: "
          f"{time.perf_counter() - t_start} s")
    mk.check_poses_cuda.launches = 0
    zero_front()
    for key in ("hard100k", "easy100k"):
        ds = read_conf_file(assets.dataset_path(key))
        require(len(ds.confs) == 100000 and ds.tags_match_header is True,
                f"(a) {key}: not 100,000 rows tagged as its header says")
        t0 = time.perf_counter()
        valid = checker.check_valid_resolved(ds.confs)
        dt = time.perf_counter() - t0
        bad = np.flatnonzero(valid != ds.valid)
        print(f"  (a) [{card}] {key}: {ds.num_valid} tagged valid, check_valid_resolved "
              f"{int(valid.sum())} valid in {dt} s (first call), {len(bad)} golden mismatches")
        if len(bad):
            packed = checker.check_packed(ds.confs[bad[:8]])
            for i, b in zip(bad[:8], packed):
                print(f"    row {i}: conf {ds.confs[i].tolist()}, float64 tag {bool(ds.valid[i])}, "
                      f"port {bool(valid[i])}, packed byte {int(b)}")
        require(not len(bad), f"(a) {key}: {len(bad)} golden mismatches")
    torch.cuda.synchronize()
    k1 = mk.check_poses_cuda.launches
    front13 = read_front("100k sets (13 (a))")
    print(f"  (a) K1 launches: {k1}; K2 {front13['pose_rows']}")

    t0 = time.perf_counter()
    bench = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "torch_bench.py")],
                           capture_output=True, text=True, timeout=900)
    out, err = bench.stdout.strip().splitlines(), bench.stderr.strip().splitlines()
    print(f"  (b) [{card}] torch_bench.py: rc {bench.returncode}, {time.perf_counter() - t0} s")
    require(bench.returncode == 0 and out and err,
            f"(b) torch_bench.py failed: {bench.stderr[-3000:]}")
    print(f"  (b) stdout: {out[-1]}")
    print(f"  (b) stderr: {err[-1]}")
    result, extra = json.loads(out[-1]), json.loads(err[-1])
    require(result["metric"] == "collision_checks_per_s_hard100k", "(b) the bench did not "
            "run hard100k")
    require(extra["golden_mismatches"] == 0, "(b) golden mismatches on hard100k")
    require(extra["easy100k_mismatches"] == 0, "(b) golden mismatches on easy100k")
    require(extra["presort_verdicts_identical"], "(b) presort changes a verdict byte")
    launches = extra["kernel_launches"]
    require(all(launches.values()), f"(b) the bench did not launch every kernel: {launches}")
    FRONT_LAUNCHES["bench (13 (b))"] = {k: launches[k] for k in ("pose_rows", "robot_bounds")}
    shapes = phase13_shapes(checker, card)
    phase13_one_launch(checker, card)
    print(f"  [{card}] phase 13: {time.perf_counter() - t_start} s; launches: K1 {k1} in (a), "
          f"{launches['megakernel']} in the bench; scan kernel {launches['clearance']}")
    return k1 + launches["megakernel"], launches["clearance"], shapes


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want|: entries equal as values (infinities included,
    -0.0 == +0.0) or NaN in both count 0, a NaN in one of them inf."""
    if not got.numel():
        return 0.0
    same = (got == want) | (got.isnan() & want.isnan())
    diff = (got.double() - want.double()).abs().nan_to_num(nan=float("inf"))
    return float(torch.where(same, 0.0, diff).max())


def phase14_poses(sets: dict, device) -> float:
    """Phase 14 (a): K2 against its twin on every row of each set, bit for
    bit (the int32 views equal). Returns the max abs err."""
    from robocheck_tpu_torch.kernels import front
    from robocheck_tpu_torch.kernels import megakernel as mk

    worst = 0.0
    for name, confs in sets.items():
        x = torch.from_numpy(confs).to(device)
        got, want = front.poses_from_confs_cuda(x), mk.poses_from_confs_reference(x)
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        err = max_abs_err(got, want)
        print(f"  (a) {name} {list(x.shape)}: K2 vs twin, {n_diff} of {got.numel()} entries "
              f"differ in any bit, max abs err {err}")
        require(n_diff == 0, f"(a) {name}: K2's pose rows differ from the twin's")
        worst = max(worst, err)
    return worst


def hold_box(poses, tables, obs_box) -> dict:
    """Phase 14 (b) on one robot table (a `MegaKernelPrep` on the card, with
    its vertex table) and obstacle box: K5 with and without the box against
    `robot_bounds_reference` / `mesh_broad_reference` over the corner table
    and `robot_bounds_vertices_reference` over the vertex table, on the same
    pose rows. Boxes are held as values (the min of -0.0 and +0.0 may be
    either zero), NaN for NaN; the hit bytes exactly."""
    from robocheck_tpu_torch.kernels import front
    from robocheck_tpu_torch.kernels import megakernel as mk

    box, hit = front.robot_bounds_cuda(poses, tables.rob_verts, obs_box,
                                       padded=tables.rob_padded)
    alone = front.robot_bounds_cuda(poses, tables.rob_verts, padded=tables.rob_padded)
    want = mk.robot_bounds_reference(poses, tables.rob_base)
    want_v = mk.robot_bounds_vertices_reference(poses, tables.rob_verts, tables.rob_padded)
    want_hit = mk.mesh_broad_reference(poses, tables.rob_base, obs_box)
    return {"err": max(max_abs_err(box, want), max_abs_err(alone, want),
                       max_abs_err(box, want_v)),
            "hits": int(hit.sum()), "twin_hits": int(want_hit.sum()),
            "hits_equal": bool(torch.equal(hit, want_hit)),
            "nan": int(want.isnan().sum()), "box": box}


def multi_tile_group(device):
    """A chunked checker with one robot group whose vertex table spans more
    than one of K5's 4,096-vertex shared-memory tiles: a soup of 3,000
    triangles (9,000 vertices, no two shared) against icosphere(4) cut into
    ten 512-triangle chunks; and 2,048 rows around it (seed 9)."""
    from robocheck_tpu_torch.kernels.chunked import ChunkedMegaKernelChecker
    from robocheck_tpu_torch.models.shapes import icosphere, triangle_soup

    robot = triangle_soup(np.random.default_rng(11), 3000, extent=0.5)
    ck = ChunkedMegaKernelChecker(robot, icosphere(4, radius=1.5), device=device,
                                  max_rob_tris=4096, max_obs_tris=512)
    rng = np.random.default_rng(9)
    confs = np.zeros((2048, 6), np.float32)
    confs[:, 0:3] = rng.uniform(-2.5, 2.5, (2048, 3))
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (2048, 3))
    return ck, confs


def phase14_boxes(checker, data, big, scenes, chunked_scenes, device) -> float:
    """Phase 14 (b): K5 against its twins on the alpha tables, the phase-3
    scenes, every robot group of phase 7's chunked scenes and of a robot
    group past one shared-memory tile, tables whose Tr is not a multiple of
    32, an all-padding table, all of hard100k, and non-finite rows through
    `broad_block`. Returns the max abs err."""
    import dataclasses

    from robocheck_tpu_torch.core.types import Mesh
    from robocheck_tpu_torch.io.datagen import adversarial_confs
    from robocheck_tpu_torch.kernels import megakernel as mk

    worst = 0.0

    def held(name, poses, tables, obs_box) -> dict:
        nonlocal worst
        r = hold_box(poses, tables, obs_box)
        worst = max(worst, r["err"])
        require(r["err"] == 0 and r["hits_equal"],
                f"(b) {name}: K5 differs from its twins (max abs err {r['err']}, hits "
                f"{r['hits']}/{r['twin_hits']})")
        return r

    def line(name, poses, tables, r):
        real = int((tables.rob_base[9] > 0).sum())
        print(f"  (b) {name}: {poses.shape[0]} rows, Tr {tables.rob_base.shape[1]} ({real} real, "
              f"{tables.rob_verts.shape[1]} vertices, padded {tables.rob_padded}): boxes equal "
              f"as values ({r['nan']} NaN entries, NaN for NaN), hits {r['hits']} / twin "
              f"{r['twin_hits']}, max abs err {r['err']}")

    alpha_t, obs_mesh = checker.tables, checker.tables.obs_mesh
    rob = alpha_t.rob_base.cpu()
    alpha = {key: data[key].confs for key in ("hard10k", "easy10k")}
    alpha["adversarial"] = adversarial_confs()
    one = np.array([[0, 1, 2]], np.int32)
    tri = mk.MegaKernelPrep.build(Mesh(np.eye(3, dtype=np.float32), one),
                                  Mesh(np.eye(3, dtype=np.float32) + 0.5, one)).rob_base
    padding = rob.clone()
    padding[9] = 0.0
    cuts = {"alpha Tr 1008 (its real triangles)": rob[:, :1008], "alpha Tr 1": rob[:, :1],
            "alpha Tr 77": rob[:, :77], "one-triangle robot (Tr 128)": tri,
            "all padding": padding}
    tables = {"alpha": alpha_t}
    tables.update({k: dataclasses.replace(alpha_t, rob_base=torch.as_tensor(v).to(device)
                                          .contiguous()) for k, v in cuts.items()})
    require(alpha_t.rob_verts.shape[1] == 792, "the alpha robot's vertex table is not 792 "
            f"vertices: {tuple(alpha_t.rob_verts.shape)}")
    for key, confs in alpha.items():
        poses = mk.poses_from_confs_reference(torch.from_numpy(confs).to(device))
        for name, t in tables.items():
            r = held(f"{name}, {key}", poses, t, obs_mesh)
            line(f"{name}, {key}", poses, t, r)
            if name == "all padding":
                sentinel = torch.tensor([3.0e38] * 3 + [-3.0e38] * 3, device=device)
                require(bool((r["box"] == sentinel).all()),
                        "(b) an all-padding table does not give the 3.0e38 sentinel box")
    for name, prep, poses in scenes:
        line(name, poses, prep, held(name, poses, prep, prep.obs_mesh))
    ck_tiles, confs_tiles = multi_tile_group(device)
    groups = [*chunked_scenes, ("soup of 3,000 triangles x icosphere(4)", ck_tiles, confs_tiles)]
    for name, ck, confs in groups:
        poses = mk.poses_from_confs_reference(torch.from_numpy(confs).to(device))
        n_groups, n_boxes, hits, most = 0, 0, 0, 0
        for lo in range(0, ck.num_chunk_pairs, ck._n_obs_chunks):
            group = ck.checkers[lo : lo + ck._n_obs_chunks]
            n_groups += 1
            most = max(most, group[0].tables.rob_verts.shape[1])
            for c in group:
                hits += held(f"{name}, robot group {n_groups}", poses, group[0].tables,
                             c.tables.obs_mesh)["hits"]
                n_boxes += 1
        print(f"  (b) {name}: {n_groups} robot groups x their {n_boxes} obstacle-chunk boxes, "
              f"{len(confs)} rows each (at most {most} vertices a group): equal to the twins, "
              f"{hits} hits in all")
    most = ck_tiles.checkers[0].tables.rob_verts.shape[1]
    require(most > 4096, f"the multi-tile robot group has {most} vertices, not over 4,096")
    on, off = (ck_tiles.check_packed(confs_tiles, compact=c) for c in (True, False))
    print(f"  (b) its compact=True bytes (K5 over {most} vertices, {-(-most // 4096)} tiles) "
          f"identical to compact=False: {bool(np.array_equal(on, off))} "
          f"({int((on & 1).sum())} valid of {len(on)})")
    require(np.array_equal(on, off), "(b) the multi-tile group's compact= bytes differ")
    # All 100,000 rows of hard100k on the alpha table.
    poses = mk.poses_from_confs_reference(torch.from_numpy(big["hard100k"]).to(device))
    line("alpha, hard100k", poses, alpha_t, held("alpha, hard100k", poses, alpha_t, obs_mesh))
    # Non-finite rows, which broad_block takes as they are (check_packed
    # filters them): K2 then K5 against the twins, on the alpha table and on
    # its cut to Tr 1008, which has no padding column to fold 3.0e38 in.
    bad = np.array(data["hard10k"].confs[:4096])
    rng = np.random.default_rng(14)
    for col in range(6):
        rows = rng.choice(len(bad), len(bad) // 16, replace=False)
        bad[rows, col] = rng.choice(np.float32([np.nan, np.inf, -np.inf]), len(rows))
    x = torch.from_numpy(bad).to(device)
    got = checker.broad_block(bad)
    twin_poses = mk.poses_from_confs_reference(x)
    want = mk.mesh_broad_reference(twin_poses, alpha_t.rob_base, obs_mesh)
    r = held("non-finite rows", twin_poses, alpha_t, obs_mesh)
    cut = tables["alpha Tr 1008 (its real triangles)"]
    line("non-finite rows, alpha Tr 1008", twin_poses, cut,
         held("non-finite rows, alpha Tr 1008", twin_poses, cut, obs_mesh))
    print(f"  (b) broad_block on {len(bad)} hard10k rows with NaN / +-inf entries "
          f"({int((~np.isfinite(bad).all(1)).sum())} non-finite rows): {int(got.sum())} hits, "
          f"twin {int(want.sum())}, equal {bool(torch.equal(got, want))}; boxes NaN for NaN "
          f"({r['nan']} NaN entries), max abs err {r['err']}")
    require(torch.equal(got, want), "(b) broad_block differs from the twin on non-finite rows")
    return worst


def host_us(fn, reps: int = 100) -> float:
    """Host µs of one ``fn()`` call (its issue: checks, allocation, launch),
    over ``reps`` calls started after a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def phase14(checker, data, scenes, chunked_scenes, card: str, device) -> list:
    """The front end (phase 14): (a) K2 and (b) K5 against their twins, (c)
    their launch counters on the four paths that reach them, (d) times
    beside the twins and the bounds, presort on and off. Returns the two
    kernels' entries of the kernel table."""
    from robocheck_tpu_torch import read_conf_file
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.io.datagen import adversarial_confs
    from robocheck_tpu_torch.kernels import front
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.profiling import bounds
    from robocheck_tpu_torch.profiling.timers import benchmark, event_ms, kernel_ms

    print("[14] front end: K2 (pose rows) and K5 (robot box), csrc/front.cu")
    t_start = time.perf_counter()
    big = {key: read_conf_file(assets.dataset_path(key)).confs
           for key in ("hard100k", "easy100k")}
    sets = {key: ds.confs for key, ds in data.items()}
    sets.update(big)
    sets["adversarial"] = adversarial_confs()
    err2 = phase14_poses(sets, device)
    err5 = phase14_boxes(checker, data, big, scenes, chunked_scenes, device)

    # (c) each path with the counters set to 0 just before it.
    hard = data["hard10k"].confs
    name7, ck7, confs7 = chunked_scenes[0]
    paths = {"check_valid_resolved": (lambda: checker.check_valid_resolved(hard), False),
             "check_valid(presort=True)": (lambda: checker.check_valid(hard, presort=True),
                                           True),
             "check(two_phase=True)": (lambda: checker.check(hard, two_phase=True), True),
             f"ChunkedMegaKernelChecker(compact=True), {name7}": (
                 lambda: ck7.check_packed(confs7, compact=True), True)}
    for name, (run, k5) in paths.items():
        zero_front()
        run()
        got = read_front(f"(14 (c)) {name}", k5)
        print(f"  (c) {name}: K2 {got['pose_rows']} launches, K5 {got['robot_bounds']}")

    # (d) times at the bench's shapes: each kernel's device duration from a
    # trace (`kernel_ms`), beside CUDA events around 20 back-to-back calls
    # (which read the wrapper's issue time where it exceeds the kernel's),
    # the wrapper's host µs a call, the twins and the bounds; K5 against its
    # vertex bound and its corner bound.
    tables = checker.tables
    rob_np, nv = tables.rob_base.cpu().numpy(), tables.rob_verts.shape[1]
    times = {}
    for n in (2048, 16384, 100000):
        x = torch.from_numpy(big["hard100k"][:n]).to(device)
        poses = mk.poses_from_confs_reference(x)

        def k2_run():
            return front.poses_from_confs_cuda(x)

        def k5_run():
            return front.robot_bounds_cuda(poses, tables.rob_verts, tables.obs_mesh,
                                           padded=tables.rob_padded)

        k2 = {"ms": kernel_ms(k2_run), "event_ms": event_ms(k2_run, 20),
              "host_us": host_us(k2_run),
              "plain_ms": event_ms(lambda: mk.poses_from_confs_reference(x), 20)}
        k2["bound_ms"], k2["bound_by"] = bounds.bound_ms(*bounds.pose_rows_work(n))
        k5 = {"ms": kernel_ms(k5_run), "event_ms": event_ms(k5_run, 20),
              "host_us": host_us(k5_run),
              "plain_ms": event_ms(lambda: mk.mesh_broad_reference(poses, tables.rob_base,
                                                                   tables.obs_mesh), 3)}
        k5["bound_ms"], k5["bound_by"] = bounds.bound_ms(
            *bounds.robot_bounds_work(rob_np, n, True, nv=nv))
        k5["corner_bound_ms"], _ = bounds.bound_ms(*bounds.robot_bounds_work(rob_np, n, True))
        times[n] = (k2, k5)
        print(f"  (d) [{card}] K2 pose rows, hard100k[:{n}]: {k2['ms']} ms device (trace), "
              f"{k2['event_ms']} ms by events, wrapper {k2['host_us']} us of host time a call; "
              f"torch-ops twin {k2['plain_ms']} ms; bound {k2['bound_ms']} ms "
              f"({k2['bound_by']}), {100 * k2['bound_ms'] / k2['ms']:.1f}% of it")
        print(f"  (d) [{card}] K5 robot box + mesh-box test, hard100k[:{n}], {nv} vertices: "
              f"{k5['ms']} ms device (trace), {k5['event_ms']} ms by events, wrapper "
              f"{k5['host_us']} us a call; torch-ops twin {k5['plain_ms']} ms; vertex bound {k5['bound_ms']} ms "
              f"({k5['bound_by']}), {100 * k5['bound_ms'] / k5['ms']:.1f}% of it; corner "
              f"bound {k5['corner_bound_ms']} ms, {100 * k5['corner_bound_ms'] / k5['ms']:.1f}%")
    for key, confs in big.items():
        plain, sorted_ = (checker.check_valid(confs), checker.check_valid(confs, presort=True))
        same = all(np.array_equal(a, b) for a, b in zip(plain, sorted_))
        off = benchmark(lambda: checker.check_valid(confs))
        on = benchmark(lambda: checker.check_valid(confs, presort=True))
        print(f"  (d) [{card}] check_valid on {key}, best of 5: presort off {len(confs) / off} "
              f"checks/s ({off * 1e3} ms), on {len(confs) / on} checks/s ({on * 1e3} ms); "
              f"verdicts identical {same}")
        require(same, f"(d) {key}: presort changes a verdict")
    total = {k: sum(v[k] for v in FRONT_LAUNCHES.values()) for k in ("pose_rows", "robot_bounds")}
    print(f"  K2 / K5 launches by path: {json.dumps(FRONT_LAUNCHES)}")
    print(f"  traces retaken by kernel_ms for a lost kernel record, phases 6 and 14: "
          f"{kernel_ms.lost}")
    print(f"  [{card}] phase 14: {time.perf_counter() - t_start} s")
    k2, k5 = times[100000]
    # No single PyTorch call computes either function: library_ms null. ms is
    # the device duration by trace; event_ms the CUDA-event figure beside it.
    return [{"name": "pose_rows", "route": "cuda", "source": FRONT_SOURCE,
             "replaces": POSE_REPLACES, "launches": total["pose_rows"], "max_abs_err": err2,
             "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
             "bound_by": k2["bound_by"], "library_ms": None, "event_ms": k2["event_ms"]},
            {"name": "robot_bounds", "route": "cuda", "source": FRONT_SOURCE,
             "replaces": BOX_REPLACES, "launches": total["robot_bounds"],
             "max_abs_err": err5, "ms": k5["ms"], "plain_ms": k5["plain_ms"],
             "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"], "library_ms": None,
             "event_ms": k5["event_ms"], "corner_bound_ms": k5["corner_bound_ms"]}]


def same_f32(got: torch.Tensor, want: torch.Tensor) -> int:
    """Entries whose float32 bits differ (the sign of zero included), a NaN
    matching a NaN (the twin's -NaN may carry another payload)."""
    ok = (got.view(torch.int32) == want.view(torch.int32)) | (torch.isnan(got) & torch.isnan(want))
    return int((~ok).sum())


def grid_scenes(obstacle):
    """Phase 15 (a)'s meshes and lattices: (name, mesh, nodes per axis)."""
    from robocheck_tpu_torch.core.types import Mesh
    from robocheck_tpu_torch.kernels.sdf import RAY_DIR
    from robocheck_tpu_torch.models.shapes import box, icosphere
    from robocheck_tpu_torch.planner.ccd import subdivide_mesh

    slab = box(extent=(0.4, 2.0, 1.0))

    def plus(extra, name):
        n = len(slab.vertices)
        tris = [[n + 3 * i, n + 3 * i + 1, n + 3 * i + 2] for i in range(len(extra) // 3)]
        return Mesh(np.concatenate([slab.vertices, np.array(extra, np.float32)]),
                    np.concatenate([slab.triangles, tris]).astype(np.int32), name)

    # Three collinear corners (zero area), an edge c - a along the ray (det
    # exactly 0): both flat; a = b != c gives 0 / 0 on part of its edge region.
    degenerate = plus([[0.0, -0.5, 0.0], [0.125, -0.5, 0.0], [0.25, -0.5, 0.0],
                       [0.0, 0.0, 0.0], [0.0, 0.3, 0.1], list(0.125 * RAY_DIR)], "degenerate")
    nan = plus([[0.1, 0.0, 0.0], [0.1, 0.0, 0.0], [0.1, 0.4, 0.0]], "a = b != c")
    return [("alpha", obstacle, 64), ("alpha", obstacle, 96), ("icosphere(2)", icosphere(2), 32),
            ("box(0.4, 2, 1)", slab, 32), ("16x alpha", subdivide_mesh(obstacle, 2), 32),
            ("box + zero-area + ray-parallel", degenerate, 32), ("box + a = b != c", nan, 32),
            ("box(2, 2, 2), nodes on its faces", box(extent=(2.0, 2.0, 2.0)), 25),
            ("grazing sliver", grazing_sliver(), 16),
            ("256x alpha", subdivide_mesh(obstacle, 4), 16)]


def grazing_sliver():
    """A well-shaped triangle nearly parallel to the ray (not thin, |det|
    ~2.4e-7) whose plane holds two lattice directions, so that the 16^3
    lattice's nodes in that plane past its box get rounded crossings, in a
    group with 31 tiny triangles at its middle; 32 tiny triangles at each
    corner of [0, 10] x [0, 10] x [0, 10 d_z / d_y] fix the lattice."""
    from robocheck_tpu_torch.core.types import Mesh
    from robocheck_tpu_torch.kernels.sdf import RAY_DIR
    from robocheck_tpu_torch.planner.sdf import grid_axes

    d = RAY_DIR.astype(np.float64)
    hi = np.array([10.0, 10.0, 10.0 * d[2] / d[1] * (1 + 1e-7)])
    small = np.float32([[0, 0, 0], [0.2, 0, 0], [0, 0.2, 0]])
    corners = np.concatenate([small, hi - small]).astype(np.float32)
    lattice = grid_axes(Mesh(corners, np.arange(6, dtype=np.int32).reshape(2, 3), "corners"),
                        16)[0]
    a, b, c = (np.float32([float(x[n]) for x, n in zip(lattice, ijk)])
               for ijk in ((4, 4, 4), (8, 4, 4), (4, 8, 8)))
    tiny = np.float32([[0, 0, 0], [0.01, 0, 0], [0, 0.01, 0]])
    step = [np.float32([0, 0.001 * i, 0]) for i in range(32)]
    fill = [a + 0.5 * (b - a) + tiny + step[i] for i in range(31)]
    low = [small + step[i][[1, 0, 2]] for i in range(32)]
    high = [corners[3:] - step[i][[1, 0, 2]] for i in range(32)]
    verts = np.concatenate([np.stack([a, b, c]), *fill, *low, *high]).astype(np.float32)
    return Mesh(verts, np.arange(len(verts), dtype=np.int32).reshape(-1, 3), "grazing sliver")


def k4_scratch_bytes(axes, cull) -> int:
    """The device scratch `sdf_grid_cuda` gives K4 on this lattice and these
    groups (`rc_sdf_grid_scratch_bytes`; 0 where they fit a block's shared
    memory)."""
    from robocheck_tpu_torch.kernels import _build

    need = _build.library("clearance").rc_sdf_grid_scratch_bytes(
        *(a.shape[0] for a in axes), cull.boxes.shape[0])
    require(need >= 0, f"rc_sdf_grid_scratch_bytes failed: {need}")
    return int(need)


def k4_in_scratch(axes, table, cull, signed, counts, blocks: int) -> torch.Tensor:
    """K4 through `rc_sdf_grid` with the groups' arrays in device scratch
    for ``blocks`` blocks, so in launches of ``blocks`` blocks each: the
    path of groups past a block's shared memory, on any scene. A
    comparison's launch: the wrapper's count does not move."""
    from robocheck_tpu_torch.kernels import _build
    from robocheck_tpu_torch.kernels import sdf as ks

    lib = _build.library("clearance")
    ng = cull.boxes.shape[0]
    per_block = (ng * 4 + 15) // 16 * 16 * 2 + (ng + 15) // 16 * 16  # grid_block_scratch
    scratch = torch.empty(per_block * blocks, dtype=torch.uint8, device=table.device)
    out = torch.empty(tuple(a.shape[0] for a in axes), dtype=torch.float32, device=table.device)
    err = lib.rc_sdf_grid(*(a.data_ptr() for a in axes), *out.shape, table.data_ptr(),
                          table.shape[0], cull.boxes.data_ptr(), cull.always.data_ptr(),
                          cull.ray_slack.data_ptr(), ng, float(cull.slack), int(signed),
                          *(float(x) for x in ks.RAY_DIR), out.data_ptr(),
                          None if counts is None else counts.data_ptr(), scratch.data_ptr(),
                          scratch.numel(), torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"rc_sdf_grid through scratch failed: cudaError {err}")
    return out


def pr11_inside(points, table) -> torch.Tensor:
    """The parity of the grid build before K4 (its torch ops, each 3-term
    sum by `.sum(-1)`, torch's reduction order): bool [N]."""
    from robocheck_tpu_torch.kernels.sdf import RAY_DIR

    d = torch.as_tensor(RAY_DIR).to(points.device)
    v0, e1, e2 = table[:, 0:3], table[:, 9:12], table[:, 12:15]
    pvec = torch.stack([d[1] * e2[:, 2] - d[2] * e2[:, 1], d[2] * e2[:, 0] - d[0] * e2[:, 2],
                        d[0] * e2[:, 1] - d[1] * e2[:, 0]], dim=-1)
    det = (e1 * pvec).sum(-1)
    flat = det.abs() < 1e-12
    inv_det = torch.where(flat, 0.0, 1.0 / torch.where(flat, 1.0, det))
    out = torch.empty(points.shape[0], dtype=torch.bool, device=points.device)
    for lo in range(0, points.shape[0], 2048):
        tv = points[lo : lo + 2048, None, :] - v0[None]
        u = (tv * pvec[None]).sum(-1) * inv_det[None]
        e = e1[None].expand_as(tv)
        q = torch.stack([tv[..., 1] * e[..., 2] - tv[..., 2] * e[..., 1],
                         tv[..., 2] * e[..., 0] - tv[..., 0] * e[..., 2],
                         tv[..., 0] * e[..., 1] - tv[..., 1] * e[..., 0]], dim=-1)
        v = (q * d).sum(-1) * inv_det[None]
        t = (q * e2[None]).sum(-1) * inv_det[None]
        crossing = ~flat[None] & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
        out[lo : lo + 2048] = crossing.sum(1) % 2 == 1
    return out


def phase15(obstacle, log: str, card: str, device) -> dict:
    """The gradient planners' distance grid, K4 (phase 15): (a) K4 against
    its full twin as float32 bits and its kept scans against
    `grid_cull_plan`'s on every scene of `grid_scenes`, signed and unsigned,
    and its ptxas lines; (b) on the alpha obstacle at 64^3 and 96^3 K4's
    device time (events and trace) beside the twin's, its culled-work and
    full-scan bounds and shares, the kept shares, and the nodes whose sign
    the build before K4 gave otherwise. Returns K4's kernel-table entry."""
    from robocheck_tpu_torch.kernels import sdf as ks
    from robocheck_tpu_torch.planner.sdf import build_distance_grid, grid_inputs
    from robocheck_tpu_torch.profiling import bounds, timers

    print("[15] the distance grid, K4 (csrc/clearance.cu grid_kernel), against its twin")
    t_start = time.perf_counter()
    grid_lines = runpy.run_path(os.path.join(ROOT, "scripts", "torch_grid_compare.py"),
                                run_name="imported")["grid_ptxas"](log)
    print("  " + "; ".join(grid_lines))
    require(sum("registers" in ln for ln in grid_lines) == 2
            and all("0 bytes spill stores, 0 bytes spill loads" in ln
                    for ln in grid_lines if "spill" in ln),
            f"(a) K4's two instances spill or are missing from the build log: {grid_lines}")
    ks.sdf_grid_cuda.launches = 0
    max_err, launched = 0.0, 0
    for name, mesh, res in grid_scenes(obstacle):
        g = grid_inputs(mesh, res, device=device)
        axes, table, cull = g["axes"], g["table"], g["cull"]
        pts = ks.grid_points(axes)
        plan = ks.grid_cull_plan(axes, table, cull)
        cells = plan.dist.numel()
        scratch = k4_scratch_bytes(axes, cull)
        for signed in (True, False):
            want = ks.grid_values_reference(pts, table, signed).view(res, res, res)
            counts = torch.zeros(2, dtype=torch.int32, device=device)
            got = ks.sdf_grid_cuda(axes, table, cull, signed, counts)
            launched += 1
            counts_s = torch.zeros(2, dtype=torch.int32, device=device)
            in_scratch = k4_in_scratch(axes, table, cull, signed, counts_s, blocks=3)
            torch.cuda.synchronize()
            n_diff = same_f32(got, want)
            n_diff_s = same_f32(in_scratch, want)
            ok = torch.isfinite(want) & torch.isfinite(got)
            err = float((got[ok].double() - want[ok].double()).abs().max())
            max_err = max(max_err, err)
            neg_zero = int(((got == 0) & torch.signbit(got)).sum())
            n_nan = int(torch.isnan(got).sum())
            kept = [int(plan.dist.sum()), int(plan.ray.sum()) if signed else 0]
            print(f"  (a) {name} ({len(table)} triangles, {cull.boxes.shape[0]} groups, "
                  f"{res}^3, signed {signed}; the wrapper's scratch {scratch} bytes): {n_diff} of "
                  f"{got.numel()} entries differ from the twin as float32 bits ({n_diff_s} "
                  f"through scratch, 3 blocks a launch); {int((got < 0).sum())} negative, "
                  f"{neg_zero} -0.0, {n_nan} NaN; max abs err {err}; kept (warp, group) scans "
                  f"{counts.tolist()} ({counts_s.tolist()} through scratch), grid_cull_plan "
                  f"{kept} of {cells}")
            require(n_diff == 0 and n_diff_s == 0,
                    f"(a) {name} {res}^3 signed {signed}: K4 differs from its twin")
            require(counts.tolist() == kept and counts_s.tolist() == kept,
                    f"(a) {name} {res}^3 signed {signed}: K4's kept scans {counts.tolist()} / "
                    f"{counts_s.tolist()} are not grid_cull_plan's {kept}")
            if name.startswith("256x"):
                require(scratch > 0, "(a) the 256x obstacle's groups fit a block's shared memory")
            if signed and name.startswith("grazing"):
                # With the boxes grown by the distance slack alone, the plan
                # loses crossings the full scan counts, and K4 loses them too.
                flat = dataclasses.replace(cull, ray_slack=torch.full_like(cull.ray_slack,
                                                                           cull.slack))
                lost = ks.grid_values_planned(axes, table, ks.grid_cull_plan(axes, table, flat))
                old = k4_in_scratch(axes, table, flat, True, None, blocks=3)
                n_lost, n_old = same_f32(lost, want), same_f32(old, lost)
                print(f"  (a) {name}, boxes grown by the distance slack alone: the plan's grid "
                      f"differs from the twin on {n_lost} nodes, K4's from the plan's on {n_old}")
                require(n_lost > 0 and n_old == 0,
                        "(a) the grazing sliver does not show the distance slack's loss")
            if signed and name.startswith("box(2"):
                require(neg_zero > 0, "(a) no node on the box's faces reads -0.0")
            if name.endswith("!= c"):
                require(n_nan > 0, "(a) the a = b != c triangle gave no NaN")
    require(ks.sdf_grid_cuda.launches == launched, "(a) K4's count is not one per call")
    print(f"  (a) [{card}] {launched} grids bit-equal to the twin, kept scans equal to the plan's, "
          f"in {time.perf_counter() - t_start} s")

    out = {}
    for res in (64, 96):
        g = grid_inputs(obstacle, res, device=device)
        axes, table, cull = g["axes"], g["table"], g["cull"]
        pts = ks.grid_points(axes)
        nodes, nt, ng = len(pts), len(table), cull.boxes.shape[0]

        def k4(signed=True):
            return ks.sdf_grid_cuda(axes, table, cull, signed)

        # CUDA events around back-to-back calls read the kernel (the wrapper
        # issues in ~30 us); the trace's figure is printed beside them.
        e_ms = timers.event_ms(k4, 10)
        k_ms = timers.kernel_ms(k4, 5)
        u_ms = timers.event_ms(lambda: k4(False), 10)
        p_ms = timers.benchmark(ks.grid_values_reference, pts, table, runs=1, warmup=0) * 1e3
        plan = ks.grid_cull_plan(axes, table, cull)
        d_pairs, r_pairs = plan.pairs(nt)
        regions, ray = ks.grid_work_counts(pts, table)
        c_regions, c_ray = ks.grid_work_counts(pts, table, plan)
        b_ms, b_by = bounds.bound_ms(*bounds.grid_work(nodes, nt, True, c_regions, c_ray,
                                                       r_pairs, ng))
        f_ms, f_by = bounds.bound_ms(*bounds.grid_work(nodes, nt, True, regions, ray))
        flips = int((pr11_inside(pts, table)
                     != torch.signbit(ks.grid_values_reference(pts, table))).sum())
        build_s = timers.benchmark(build_distance_grid, obstacle, res, runs=3)
        pairs = nodes * nt
        print(f"  (b) [{card}] alpha {res}^3 ({nodes} nodes x {nt} triangles, {ng} groups): K4 "
              f"{e_ms} ms by events ({k_ms} ms device by trace); unsigned {u_ms} ms; twin "
              f"{p_ms} ms; kept pairs: distance {d_pairs / pairs}, ray {r_pairs / pairs} "
              f"(warp-group cells {int(plan.dist.sum())} / {int(plan.ray.sum())} of "
              f"{plan.dist.numel()}); culled-work bound {b_ms} ms ({b_by}), share "
              f"{b_ms / e_ms}; full-scan bound {f_ms} ms ({f_by}), share {f_ms / e_ms}; "
              f"distances by region {regions.tolist()} (kept {c_regions.tolist()}), ray-test "
              f"stages {ray.tolist()} (kept {c_ray.tolist()}); nodes whose sign the build "
              f"before K4 gave otherwise: {flips}; build_distance_grid warm, best of 3 (host "
              f"clock) {build_s * 1e3} ms")
        out[res] = {"ms": e_ms, "trace_ms": k_ms, "unsigned_ms": u_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "bound_full_ms": f_ms,
                    "kept_dist": d_pairs / pairs, "kept_ray": r_pairs / pairs, "flips": flips,
                    "build_s": build_s}
    launches = sum(GRID_LAUNCHES.values())
    print(f"  K4 launches by path: {GRID_LAUNCHES}")
    print(f"  [{card}] phase 15: {time.perf_counter() - t_start} s")
    big = out[96]
    return {"name": "sdf_grid", "route": "cuda", "source": CLEARANCE_SOURCE,
            "replaces": GRID_REPLACES, "launches": launches, "max_abs_err": max_err,
            "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": None, "shape": [96, 96, 96, 1008],
            "bound_full_ms": big["bound_full_ms"], "trace_ms": big["trace_ms"],
            "kept_dist": big["kept_dist"], "kept_ray": big["kept_ray"], "ms_64": out[64]["ms"],
            "plain_ms_64": out[64]["plain_ms"], "bound_ms_64": out[64]["bound_ms"],
            "bound_full_ms_64": out[64]["bound_full_ms"]}


def phase2_native(native, hard10k) -> None:
    """Phase 2, the native parsers and writer against the io modules: the
    native `parse_obj` of both alpha-1.0 meshes against `io.obj.load_obj`,
    and hard10k through the native `write_conf`, whose file must hold the
    bytes of `io.conf.write_conf_file`'s and parse back (native `parse_conf`
    and `io.conf.read_conf_file`) to hard10k's rows and tags."""
    import filecmp

    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.io.conf import read_conf_file, write_conf_file
    from robocheck_tpu_torch.io.obj import load_obj

    for path in (assets.alpha_robot_path(), assets.alpha_obstacle_path()):
        verts, tris = native.parse_obj(str(path))
        mesh = load_obj(path)
        same = np.array_equal(verts, mesh.vertices) and np.array_equal(tris, mesh.triangles)
        print(f"  native parse_obj on {os.path.basename(str(path))}: {len(verts)} vertices, "
              f"{len(tris)} triangles, identical to io.obj's: {same}")
        require(same, f"the native parse_obj differs from io.obj on {path}")
    with tempfile.TemporaryDirectory() as tmp:
        mine, ref = os.path.join(tmp, "native.conf"), os.path.join(tmp, "io.conf")
        native.write_conf(mine, hard10k.confs, hard10k.valid)
        write_conf_file(ref, hard10k.confs, hard10k.valid)
        same_bytes = filecmp.cmp(mine, ref, shallow=False)
        n_confs, n_valid = native.parse_conf(mine)
        back = read_conf_file(mine)
        same = all(np.array_equal(a, b) for a, b in (
            (n_confs, hard10k.confs), (n_valid, hard10k.valid), (back.confs, hard10k.confs),
            (back.valid, hard10k.valid)))
    print(f"  native write_conf of hard10k: the bytes of io.conf's {same_bytes}; parsed back "
          f"(native parse_conf, io.conf) to its rows and tags: {same}")
    require(same_bytes and same, "the native write_conf / parse_conf round trip of hard10k "
            "differs from io.conf")


def ptxas_info(log: str, entry: str) -> dict:
    """Registers and spill bytes of the kernel instance whose mangled name
    contains ``entry``, from an nvcc -Xptxas -v log."""
    info, compiling, props = {}, "", ""
    for line in log.splitlines():
        parts = line.replace(",", "").split()
        if "Compiling entry function" in line:
            compiling = line
        elif "Function properties for" in line:
            props = line
        elif "spill stores" in line and entry in props:
            info["spill_bytes"] = (int(parts[parts.index("stores") - 3])
                                   + int(parts[parts.index("loads") - 3]))
        elif "registers" in line and entry in compiling:
            info["registers"] = int(parts[parts.index("registers") - 1])
    return info


def phase6_shapes(pieces, lib, built, card: str) -> None:
    """Phase 6: every P1-P3 piece's launch shape beside K1's packed instance
    on the same tables (512 threads, 0 local bytes); its shared-memory map
    against the CPU replay; P1 and P2's scratch pieces at K1's shared memory,
    P3's pieces at `probes.probe_smem_bytes("invariant")`, and all of these
    at K1's blocks per SM and grid; 0 spill bytes in every probe instance."""
    from robocheck_tpu_torch.profiling import probes

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k1_ptx = ptxas_info(built["megakernel"][1], "megakernelILb0ELi0E")
    spills = [ln.strip() for ln in built["stage_probes"][1].splitlines()
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    print(f"  ptxas, every probe instance: {spills or '0 bytes spill stores and loads'}; "
          f"K1 <false,kFull>: {k1_ptx}")
    require(not spills, f"a probe instance spills registers: {spills}")
    for st in (1, 2, 3):
        for piece in pieces[st]:
            lay = probes.piece_layout(piece)
            tr, n_groups = lay["tr"], lay["n_groups"]
            per_sm = lib.rc_megakernel_blocks_per_sm(tr, n_groups)
            k1 = {"block": 512, "smem": lib.rc_megakernel_smem_bytes(tr, n_groups),
                  "blocks_per_sm": per_sm, "grid": min(-(-piece.n // 4), per_sm * sms),
                  "registers": k1_ptx.get("registers"), "spill_bytes": k1_ptx.get("spill_bytes")}
            shape = probes.launch_shape(piece)
            print(f"  [{card}] {piece.name} [{piece.n}]: {shape}; K1 on its tables "
                  f"({tr}, {n_groups} groups): {k1}")
            require(shape["local_bytes"] == 0, f"{piece.name}: {shape['local_bytes']} local bytes")
            require(shape["block"] == k1["block"], f"{piece.name}: {shape['block']} threads")
            regions = [(first, size) for _, first, size in probes.probe_map(piece.probe, **lay)]
            require(probes.compiled_map(piece) == regions,
                    f"{piece.name}: the built shared-memory map differs from probes.probe_map")
            if st == 2 and not lay["scratch"]:
                continue
            smem = probes.probe_smem_bytes("invariant", **lay) if st == 3 else k1["smem"]
            require(shape["smem"] == smem and shape["blocks_per_sm"] == per_sm
                    and shape["grid"] == k1["grid"],
                    f"{piece.name}: shared memory / blocks per SM / grid {shape['smem']} / "
                    f"{shape['blocks_per_sm']} / {shape['grid']}, want {smem} / {per_sm} / "
                    f"{k1['grid']} (K1's blocks per SM and grid)")


def hold_resolve(name: str, checker, confs: np.ndarray, quiet: bool = False,
                 tables=None) -> dict:
    """Phase 4: the resolution kernel against its twin on the card (every
    byte, and the counters) and against the native float64 oracle (every
    flagged row), on K1's bytes of ``confs`` by ``checker``, over the
    checker's resolution tables or ``tables``, and the checker's own
    ``check_valid_resolved`` against the kernel's verdicts. Returns the
    flagged rows' configurations and verdicts, and the largest byte
    difference from the twin."""
    from robocheck_tpu_torch.kernels import resolve as rs
    from robocheck_tpu_torch.runtime import native

    dev = checker.device
    tables = checker.resolve_tables if tables is None else tables
    dev_confs = torch.from_numpy(confs).to(dev)
    packed = torch.from_numpy(checker.check_packed(confs)).to(dev)
    counts, twin_counts = (torch.zeros(2, dtype=torch.int64, device=dev) for _ in range(2))
    got = rs.resolve_rows_cuda(packed, dev_confs, tables, counts)
    want = rs.resolve_rows_reference(packed, dev_confs, tables, twin_counts)
    err = int((got.int() - want.int()).abs().max()) if len(confs) else 0
    p, g = packed.cpu().numpy(), got.cpu().numpy()
    flagged = np.flatnonzero(((p & 1) == 1) & ((p & 6) != 0))
    oracle = (native.oracle_check(checker.robot.vertices, checker.robot.triangles,
                                  checker.obstacle.vertices, checker.obstacle.triangles,
                                  confs[flagged]) if len(flagged) else np.zeros(0, bool))
    mism = int((g[flagged].astype(bool) != oracle).sum())
    rest = np.setdiff1d(np.arange(len(confs)), flagged)
    kept = bool((g[rest] == (p[rest] & 1)).all())
    overturned = int((~oracle).sum())
    if not quiet or err or mism or not kept:
        print(f"  {name}: {len(confs)} rows, {len(flagged)} flagged valid, {overturned} of "
              f"them colliding in float64; kernel vs twin max abs err {err}, vs the native "
              f"oracle {mism} mismatches; counters {counts.tolist()}")
    require(err == 0, f"{name}: the resolution kernel differs from its twin")
    require(mism == 0, f"{name}: the resolution kernel differs from the native oracle")
    require(kept, f"{name}: an unflagged row's byte is not K1's bit 0")
    require(np.array_equal(checker.check_valid_resolved(confs), g.astype(bool)),
            f"{name}: the checker's check_valid_resolved differs from the kernel's verdicts")
    require(counts.tolist() == twin_counts.tolist() == [len(flagged), overturned],
            f"{name}: counters {counts.tolist()} / twin {twin_counts.tolist()}, want "
            f"[{len(flagged)}, {overturned}]")
    return {"confs": confs[flagged], "overturned": overturned, "err": err,
            "packed": packed, "dev_confs": dev_confs, "verdicts": g[flagged]}


def bench_pool(key: str, seed: int) -> list:
    """The benchmark's pool of traffic ``key`` for ``seed``, drawn as
    `benchmark/gen/alpha_bot.py` draws it (the module loaded by its path)."""
    import importlib.util

    from robocheck_tpu_torch import load_obj

    spec = importlib.util.spec_from_file_location(
        "bench_alpha_bot", os.path.join(ROOT, "benchmark", "gen", "alpha_bot.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{key}.json")) as f:
        params = json.load(f)
    robot = load_obj(os.path.join(ROOT, "benchmark", "data", "alpha1.0", "robot.obj"))
    return gen.batches(np.random.default_rng(seed % (1 << 64)), robot.vertices, params)


def trig_ulps(confs: np.ndarray, device) -> int:
    """Largest difference in units in the last place between the card's
    float64 sin / cos (torch on ``device``, as the kernel and its twin call
    them) and the host's (numpy) of the angles of ``confs``."""
    angles = np.asarray(confs, np.float32)[:, 3:6].astype(np.float64).ravel()
    if not len(angles):
        return 0
    on_card = torch.from_numpy(angles).to(device)
    worst = 0
    for card_fn, host_fn in ((torch.sin, np.sin), (torch.cos, np.cos)):
        a = card_fn(on_card).cpu().numpy().view(np.int64)
        b = host_fn(angles).view(np.int64)
        worst = max(worst, int(np.abs(a - b).max()))
    return worst


def phase4_resolve(checker, data, card: str, device) -> dict:
    """Phase 4's resolution kernel (`csrc/resolve.cu`): against its twin and
    the native oracle on every flagged row of the 10k sets, of the
    benchmark's hard100k pool of BENCH_SEED and of planted rows that float64
    overturns; the pose's sin / cos against the host's; its device time and
    bound at hard100k's shape. Returns its kernel-table entry."""
    from robocheck_tpu_torch import MegaKernelChecker
    from robocheck_tpu_torch.core.types import Mesh
    from robocheck_tpu_torch.io.datagen import near_coplanar_pairs, touching_interval_pairs
    from robocheck_tpu_torch.kernels import resolve as rs
    from robocheck_tpu_torch.kernels.chunked import make_checker
    from robocheck_tpu_torch.models.shapes import box, icosphere, tetrahedron, triangle_soup
    from robocheck_tpu_torch.oracle import resolve_coplanar
    from robocheck_tpu_torch.parallel.sharding import ShardedChecker, make_mesh
    from robocheck_tpu_torch.profiling import bounds, timers
    from robocheck_tpu_torch.profiling.timers import benchmark, event_ms

    print("[4] the resolution kernel against its twin (every byte) and the native oracle "
          "(flagged rows)")
    held = {key: hold_resolve(key, checker, ds.confs) for key, ds in data.items()}
    pool = bench_pool("hard100k", BENCH_SEED)
    for k, batch in enumerate(pool):
        held[f"hard100k[{k}]"] = hold_resolve(f"benchmark hard100k pool, seed {BENCH_SEED}, "
                                              f"batch {k}", checker, batch)
    one = np.array([[0, 1, 2]], np.int32)
    face = MegaKernelChecker(Mesh(np.array(FACE_R, np.float32), one),
                             Mesh(np.array(FACE_O, np.float32), one), device="cuda")
    planted = np.zeros((100000, 6), np.float32)
    planted[:, 0] = 1.0e5
    planted[RESOLVE_PLANTED] = 0.0
    got = hold_resolve("face on face planted in 100,000 far rows", face, planted)
    require(got["overturned"] == len(RESOLVE_PLANTED) and len(got["confs"]) == len(RESOLVE_PLANTED),
            "the planted face-on-face rows did not all resolve colliding")
    held["planted"] = got
    sharded = ShardedChecker(face.robot, face.obstacle, make_mesh(1, "cuda"))
    got = hold_resolve("the same through a world-of-one ShardedChecker", sharded, planted,
                       tables=face.resolve_tables)
    p = sharded.check_packed(planted)
    host = resolve_coplanar(face.robot, face.obstacle, planted, (p & 1).astype(bool),
                            (p & 6).astype(bool))
    require(got["overturned"] == len(RESOLVE_PLANTED)
            and np.array_equal(sharded.check_valid_resolved(planted), host),
            "the world-of-one ShardedChecker's resolution differs from resolve_coplanar")
    held["planted, sharded"] = got
    jax = MegaKernelChecker(Mesh(np.array(JAX_COPLANAR_RT, np.float32), one),
                            Mesh(np.array(JAX_COPLANAR_OT, np.float32), one), device="cuda")
    held["jax fixture"] = hold_resolve("JAX coplanar fixture", jax, np.zeros((4, 6), np.float32))
    cop_confs = np.zeros((8, 6), np.float32)
    cop_confs[:, 0:3] = [[6.0e3, 1.8e4, 1.0e4], [6.0e3 + 0.5, 1.8e4, 1.0e4],
                         [2.0e4 - 10.0, 1.9e4, 1.99e4], [0.0, 1.99e4, 5.0],
                         [6.0e3, 1.8e4, 1.0e4 - 2.0], [0.0, 5.0e3, 5.0e3],
                         [1.0, 5.0e3, 5.0e3], [9.0e5, 9.0e5, 9.0e5]]
    cop_confs[:, 3:6] = np.random.default_rng(3).uniform(-np.pi, np.pi, (8, 3))
    held["mismatched scale"] = hold_resolve(
        "unit box on 1e4 tetrahedron", MegaKernelChecker(box(extent=(2.0, 2.0, 2.0)),
                                                         tetrahedron(scale=1.0e4), device="cuda"),
        cop_confs)
    # Obstacles whose tables fit the kernel's shared memory in part (the
    # 2,200-triangle soup: its boxes only) and not at all (81,920 triangles,
    # past one K1 block: the chunked checker's bytes of rows whose contacts
    # hide under K1's +-TOL band).
    soup = triangle_soup(np.random.default_rng(508), 2200, extent=1.0)
    soup_confs = np.random.default_rng(5).uniform(-1.5, 1.5, (4096, 6)).astype(np.float32)
    held["soup"] = hold_resolve("icosphere(3) in a 2200-triangle soup", MegaKernelChecker(
        icosphere(3, 0.3), soup, device="cuda"), soup_confs)
    band = np.array([[0.8576694, -0.8420993, 0.14767459, 0.7203785, 3.0436065, 2.2627144],
                     [0.9153341, 1.5401433, -0.13083363, 1.2929987, 3.1224608, 2.1998174]],
                    np.float32)
    sphere_r, sphere_o = icosphere(1, radius=0.3), icosphere(6, radius=1.5)
    got = hold_resolve("band-hidden contacts, 80 x 81,920 triangles",
                       make_checker(sphere_r, sphere_o, device="cuda"), band)
    require(got["overturned"] == 2, "the band-hidden rows did not resolve colliding")
    held["band-hidden"] = got
    for name, make, seed in (("near-coplanar", near_coplanar_pairs, 2024),
                             ("touching-interval", touching_interval_pairs, 2025)):
        rows = overturned = 0
        for r, o in make(np.random.default_rng(seed)):
            got = hold_resolve(name, MegaKernelChecker(Mesh(r, one), Mesh(o, one), device="cuda"),
                               np.zeros((1, 6), np.float32), quiet=True)
            rows += len(got["confs"])
            overturned += got["overturned"]
        print(f"  {name} pairs (seed {seed}), each at the identity pose: {rows} flagged valid, "
              f"{overturned} colliding in float64; every byte equal to the twin and the oracle")
        held[name] = {"confs": np.zeros((0, 6), np.float32), "overturned": overturned}
    overturned = {k: v["overturned"] for k, v in held.items() if v["overturned"]}
    print(f"  rows float64 overturned, by source: {overturned}")
    flagged = np.concatenate([v["confs"] for v in held.values()])
    ulps = trig_ulps(flagged, device)
    ulps_10k = trig_ulps(data["hard10k"].confs, device)
    print(f"  the pose's sin / cos, card (float64) against host (numpy): at most {ulps} ulp on "
          f"the {len(flagged)} flagged rows, {ulps_10k} ulp on all of hard10k")

    # Times at hard100k's shape: the first pool batch and its flagged rows.
    first = held["hard100k[0]"]
    packed, dev_confs, tables = first["packed"], first["dev_confs"], checker.resolve_tables
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    k_ms = timers.kernel_ms(lambda: rs.resolve_rows_cuda(packed, dev_confs, tables, counts), 20)
    e_ms = event_ms(lambda: rs.resolve_rows_cuda(packed, dev_confs, tables, counts), 20)
    p_ms = event_ms(lambda: rs.resolve_rows_reference(packed, dev_confs, tables), 2)
    pairs = []
    for conf, valid in zip(first["confs"], first["verdicts"]):
        rob = rs.posed_robot_reference(torch.from_numpy(conf).to(device), tables)
        n_pairs = (0 if rob is None
                   else sum(len(ri) for ri, _ in rs.box_pairs_reference(rob, tables)))
        pairs.append(n_pairs if valid else min(1, n_pairs))
    b_ms, b_by = bounds.bound_ms(*bounds.resolve_work(
        len(dev_confs), tables.rob_verts.shape[0], tables.rob_tris.shape[0], pairs),
        bounds.FP64_OPS_PER_S)
    none = torch.ones_like(packed)  # no flagged row: the byte pass alone
    pass_ms = timers.kernel_ms(lambda: rs.resolve_rows_cuda(none, dev_confs, tables, counts), 20)
    print(f"  [{card}] resolution kernel, hard100k batch 0 [{len(dev_confs)}] with "
          f"{len(pairs)} flagged rows ({pairs} box-overlapping pairs needed): {k_ms} ms device "
          f"(trace), {e_ms} ms by events; with no flagged row {pass_ms} ms; twin {p_ms} ms; "
          f"bound {b_ms} ms ({b_by})")
    # The call it serves, in turns with the host's oracle it replaces.
    batch = pool[0]

    def host_resolved(confs):
        packed_np = checker.check_packed(confs)
        return resolve_coplanar(checker.robot, checker.obstacle, confs,
                                (packed_np & 1).astype(bool), (packed_np & 6).astype(bool))

    require(np.array_equal(host_resolved(batch), checker.check_valid_resolved(batch)),
            "check_valid_resolved differs from the host oracle's resolution on hard100k batch 0")
    turns = [("host", host_resolved), ("card", checker.check_valid_resolved)] * 2
    ms = {"host": [], "card": []}
    for name, fn in turns[:2] + turns[2:][::-1]:
        ms[name].append(benchmark(fn, batch) * 1e3)
    print(f"  [{card}] hard100k batch 0, best of 5 in turns (host, card, card, host): "
          f"check_packed + the host oracle {ms['host']} ms, check_valid_resolved {ms['card']} ms")
    return {"name": "resolve", "route": "cuda", "source": RESOLVE_SOURCE,
            "replaces": RESOLVE_REPLACES, "launches": rs.resolve_rows_cuda.launches,
            "max_abs_err": max(v.get("err", 0) for v in held.values()), "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "event_ms": e_ms, "byte_pass_ms": pass_ms, "trig_ulps": ulps}


def main() -> None:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from robocheck_tpu_torch import MegaKernelChecker, load_obj, read_conf_file
    from robocheck_tpu_torch.core.types import Mesh
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.kernels import _build
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.models.shapes import box, icosphere, tetrahedron, triangle_soup
    from robocheck_tpu_torch.profiling import bounds, probes, timers
    from robocheck_tpu_torch.profiling.timers import benchmark, card_line, event_ms
    from robocheck_tpu_torch.runtime import native

    require("jax" not in sys.modules and "robocheck_tpu" not in sys.modules,
            "the port imported JAX or the JAX package")
    device = torch.device("cuda", 0)

    # ---- 1. The card. ----
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[1] nvidia-smi name, power.limit: {card}")

    # ---- 2. Build. ----
    t0 = time.perf_counter()
    native_build = native.start_build()
    built = _build.build()
    for name in built:
        _build.library(name)
    native.finish_build(native_build)
    require(native.available(), "the native float64 oracle did not load")
    print(f"[2] built {', '.join(p.name for p, _ in built.values())} and the native oracle in "
          f"{time.perf_counter() - t0:.1f} s ({' '.join(_build.NVCC_FLAGS)})")
    for name, (_, log) in built.items():
        print(f"  {name}:")
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "smem",
                                       "stack frame")):
                print(f"    {line.strip()}")
    spills = [ln.strip() for ln in built["front"][1].splitlines()
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    require(not spills, f"the front end's kernels spill registers: {spills}")
    lib = _build.library()
    per_sm = lib.rc_megakernel_blocks_per_sm(1024, 8)
    require(per_sm > 0, f"the fused kernel fits no block on an SM ({per_sm})")
    print(f"  fused kernel, alpha-1.0 tables [10,1024] / [1024,20]: "
          f"{lib.rc_megakernel_smem_bytes(1024, 8)} bytes of shared memory per block, "
          f"{per_sm} resident blocks per SM")

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    data = {key: read_conf_file(assets.dataset_path(key))
            for key in ("hard10k", "easy10k", "samples10k")}
    n_confs, n_valid = native.parse_conf(str(assets.dataset_path("hard10k")))
    same = (np.array_equal(n_confs, data["hard10k"].confs)
            and np.array_equal(n_valid, data["hard10k"].valid))
    print(f"  native parse_conf on hard10k: {len(n_confs)} rows, identical to io.conf's: {same}")
    require(same, "the native parse_conf differs from io.conf on hard10k")
    phase2_native(native, data["hard10k"])

    # ---- 3. Kernel against its twin, same pose rows. ----
    print("[3] kernel vs twin on the card (exact: valid on every row, "
          "coplanar and uncertain on valid rows)")
    max_err = 0
    scenes = []  # (name, tables, poses) for phase 3b
    for key in ("hard10k", "easy10k"):
        err, *_ = compare_on_card(mk, f"alpha {key}[:2048]", robot, obstacle,
                                  data[key].confs[:2048], device, scenes)
        max_err = max(max_err, err)
    rng = np.random.default_rng(77)
    sphere = np.zeros((256, 6), np.float32)
    sphere[:, 0] = rng.uniform(0.0, 3.0, 256)
    sphere[:, 3:6] = rng.uniform(-np.pi, np.pi, (256, 3))
    err, *_ = compare_on_card(mk, "icospheres r1.0/r1.5", icosphere(1, 1.0),
                              icosphere(1, 1.5), sphere, device, scenes)
    max_err = max(max_err, err)
    # 40 robot tiles x 18 obstacle groups: the gate's compaction takes
    # three rounds (the alpha pair fits one).
    soup = triangle_soup(np.random.default_rng(508), 2200, extent=1.0)
    soup_confs = np.random.default_rng(5).uniform(-1.5, 1.5, (512, 6)).astype(np.float32)
    err, n_valid, *_ = compare_on_card(mk, "icosphere(3) in a 2200-triangle soup",
                                       icosphere(3, 0.3), soup, soup_confs, device, scenes)
    require(0 < n_valid < len(soup_confs), "soup scene: expected both verdicts")
    max_err = max(max_err, err)
    tet = tetrahedron()
    tet_obs = Mesh(np.array([[1, 0.1, 0], [1.5, 1, 2.2], [1, 2.4, 0], [3.3, 2, 2]],
                            np.float32), tet.triangles, "obs-tetra")
    tet_confs = np.zeros((2, 6), np.float32)
    tet_confs[1, 0] = 100.0
    err, n_valid, *_ = compare_on_card(mk, "tetrahedra", tet, tet_obs, tet_confs, device,
                                       scenes)
    require(n_valid == 1, "tetrahedra: expected row 0 colliding, row 1 clear")
    max_err = max(max_err, err)
    cop_confs = np.zeros((8, 6), np.float32)
    cop_confs[:, 0:3] = [[6.0e3, 1.8e4, 1.0e4], [6.0e3 + 0.5, 1.8e4, 1.0e4],
                         [2.0e4 - 10.0, 1.9e4, 1.99e4], [0.0, 1.99e4, 5.0],
                         [6.0e3, 1.8e4, 1.0e4 - 2.0], [0.0, 5.0e3, 5.0e3],
                         [1.0, 5.0e3, 5.0e3], [9.0e5, 9.0e5, 9.0e5]]
    cop_confs[:, 3:6] = np.random.default_rng(3).uniform(-np.pi, np.pi, (8, 3))
    err, _, n_cop, _ = compare_on_card(mk, "unit box on 1e4 tetrahedron (coplanar)",
                                       box(extent=(2.0, 2.0, 2.0)),
                                       tetrahedron(scale=1.0e4), cop_confs, device, scenes)
    require(n_cop > 0, "coplanar fixture flagged no valid row coplanar")
    max_err = max(max_err, err)
    one = np.array([[0, 1, 2]], np.int32)
    face_r, face_o = np.array(FACE_R, np.float32), np.array(FACE_O, np.float32)
    err, _, n_cop, _ = compare_on_card(mk, "face on face (coplanar)", Mesh(face_r, one),
                                       Mesh(face_o, one), np.zeros((1, 6), np.float32),
                                       device, scenes)
    require(n_cop == 1, "face-on-face fixture not flagged coplanar")
    max_err = max(max_err, err)
    jax_rt = Mesh(np.array(JAX_COPLANAR_RT, np.float32), one)
    jax_ot = Mesh(np.array(JAX_COPLANAR_OT, np.float32), one)
    err, _, _, n_unc = compare_on_card(mk, "JAX TestCoplanarResolution fixture, identity pose",
                                       jax_rt, jax_ot, np.zeros((1, 6), np.float32), device,
                                       scenes)
    require(n_unc == 1, "the JAX coplanar fixture is not flagged uncertain")
    max_err = max(max_err, err)
    max_err = max(max_err, compare_nonfinite(mk, robot, obstacle, data["hard10k"].confs[:2048],
                                             device))

    # ---- 3b. The counter kernel against its twin, same pose rows. ----
    print("[3b] counter kernel vs twin on the card (exact: columns 0-6 on valid rows, "
          "0 and 3 on every row; colliding rows count at most the twin's)")
    stats_err = 0
    for name, prep, poses in scenes:
        got = mk.check_poses_stats_cuda(poses, prep)
        stats_err = max(stats_err, compare_stats(
            name, got, mk.check_poses_stats_reference(poses, prep)))
    print(f"  JAX coplanar fixture, card row [valid, coplanar, num_pairs, broad, nfull, "
          f"ngate, nrest, 0] = {got[0].tolist()}")
    fixture = MegaKernelChecker(jax_rt, jax_ot, device="cuda")
    zero = np.zeros((1, 6), np.float32)
    from robocheck_tpu_torch.kernels import resolve as rs
    f_launches, f_before = rs.resolve_rows_cuda.launches, fixture.counters()
    f_packed, f_valid = fixture.check_packed(zero)[0], fixture.check_valid_resolved(zero)[0]
    f_after = fixture.counters()
    print(f"  JAX coplanar fixture on the card: packed byte {int(f_packed)}, "
          f"check_valid_resolved {bool(f_valid)} (the float64 oracle says colliding), "
          f"through the resolution kernel ({rs.resolve_rows_cuda.launches - f_launches} "
          f"launch); counters {f_before} -> {f_after}")
    require(f_packed == 0b101 and not f_valid,
            "the JAX coplanar fixture does not resolve colliding on the card")
    require(rs.resolve_rows_cuda.launches == f_launches + 1
            and f_after["resolved_rows"] == f_before["resolved_rows"] + 1
            and f_after["resolved_colliding"] == f_before["resolved_colliding"] + 1,
            "the JAX coplanar fixture's row did not go through the resolution kernel once")

    # ---- 4. The main path. ----
    checker = MegaKernelChecker(robot, obstacle, device="cuda")
    print("[4] main path: MegaKernelChecker(device='cuda').check_valid_resolved; "
          "float64 resolution by the resolution kernel (csrc/resolve.cu)")
    mk.check_poses_cuda.launches = 0
    rs.resolve_rows_cuda.launches = 0
    zero_front()
    resolved = {key: checker.check_valid_resolved(ds.confs) for key, ds in data.items()}
    torch.cuda.synchronize()
    launches = mk.check_poses_cuda.launches
    resolve_launches = rs.resolve_rows_cuda.launches
    require(launches > 0, "the main path launched no kernel")
    require(resolve_launches == len(data), f"the main path launched the resolution kernel "
            f"{resolve_launches} times, not once a call")
    front4 = read_front("main path (4)")
    for key, ds in data.items():
        packed = checker.check_packed(ds.confs)
        valid = (packed & 1) == 1
        n_cop = int((valid & ((packed & 2) > 0)).sum())
        n_unc = int((valid & ((packed & 4) > 0)).sum())
        n_res = int((valid & ((packed & 6) > 0)).sum())
        n_valid = int(resolved[key].sum())
        msg = (f"  {key}: {len(ds.confs)} rows, {n_valid} valid, {n_res} rows to float64 "
               f"resolution ({n_cop} by bit 1 coplanar, {n_unc} by bit 2 uncertain; bit 2 "
               f"on {int(((packed & 4) > 0).sum())} rows in all)")
        if key == "samples10k":
            print(f"{msg}, header says {ds.header_valid} valid")
            require(n_valid == ds.header_valid, f"{key}: valid count off the header")
        else:
            mism = int((resolved[key] != ds.valid).sum())
            print(f"{msg}, {mism} golden mismatches")
            require(mism == 0, f"{key}: {mism} golden mismatches")
    print(f"  kernel launches in the main path: {launches}; K2 {front4['pose_rows']}; "
          f"resolution {resolve_launches}")
    resolve_entry = phase4_resolve(checker, data, card, device)

    # ---- 5. Times. ----
    print(f"[5] times on {card}")
    resolved_s = {}
    for key in ("hard10k", "easy10k"):
        confs = data[key].confs
        s = resolved_s[key] = benchmark(checker.check_valid_resolved, confs)
        print(f"  [{card}] {key}: check_valid_resolved best of 5 {s * 1e3} ms, "
              f"{len(confs) / s} checks/s")
    # The kernel and its twin at the main path's shape (all rows of a set in
    # one launch, as check_valid gives them), timed and then held against
    # each other like phase 3.
    tables = checker.tables
    times = {}
    for key in ("hard10k", "easy10k"):
        poses = mk.poses_from_confs(torch.from_numpy(data[key].confs).to(device))
        k_ms = event_ms(lambda: mk.check_poses_cuda(poses, tables), 20)
        p_ms = event_ms(lambda: mk.check_poses_reference(poses, tables), 1)
        got = mk.check_poses_cuda(poses, tables)
        want = mk.check_poses_reference(poses, tables)
        times[key] = (k_ms, p_ms)
        print(f"  [{card}] kernel alone, {key} {list(poses.shape)} poses: {k_ms} ms; "
              f"twin: {p_ms} ms")
        err, *_ = compare_bits(f"alpha {key} {list(poses.shape)}, kernel vs twin",
                               got, want)
        max_err = max(max_err, err)
    kernel_ms, plain_ms = times["hard10k"]

    # ---- 4b. The stats path. ----
    print("[4b] stats path: MegaKernelChecker(device='cuda').check, broad_block, "
          "check_valid(presort=True)")
    mk.check_poses_stats_cuda.launches = 0
    mk.check_poses_cuda.launches = 0
    zero_front()
    checks = {(key, tp): checker.check(data[key].confs, two_phase=tp)
              for key in ("hard10k", "easy10k") for tp in (True, False)}
    presorted = {key: checker.check_valid(ds.confs, presort=True)
                 for key, ds in data.items()}
    torch.cuda.synchronize()
    front4b = read_front("stats path and presort (4b)", k5=True)
    stats_launches = mk.check_poses_stats_cuda.launches
    presort_launches = mk.check_poses_cuda.launches
    require(stats_launches > 0, "the stats path launched no counter kernel")
    for (key, tp), (valid, cop, pairs, broad) in checks.items():
        packed = checker.check_packed(data[key].confs)
        ref_valid, tie_free = (packed & 1) == 1, (packed & 4) == 0
        ref_broad = checker.broad_block(data[key].confs).cpu().numpy()
        print(f"  check({key}, two_phase={tp}): {int(valid.sum())} valid, "
              f"{int(broad.sum())} broad, {int(cop.sum())} coplanar, mean pairs on broad "
              f"rows {float(pairs[broad].mean())}")
        # The counter kernel counts an interval tie as the hit or miss it
        # computes, the packed kernel sets bit 2 and no hit: equal verdicts
        # on rows without bit 2, and never valid where the packed byte is not.
        require(np.array_equal(valid[tie_free], ref_valid[tie_free])
                and not (valid & ~ref_valid).any(), f"check({key}, {tp}): valid != check_valid")
        if tp:
            # check() returns broad_block's own mask here; hold the counter
            # kernel's broad column on the survivors to it instead.
            surv = np.flatnonzero(ref_broad)
            col = checker.check_block(data[key].confs[surv])[:, 3].cpu().numpy()
            require(bool((col == 1).all()), f"check({key}, True): the counter kernel's "
                    "broad column is 0 on a broad_block survivor")
        else:
            require(np.array_equal(broad, ref_broad),
                    f"check({key}, False): the counter kernel's broad != broad_block")
    for key, (v_sorted, c_sorted) in presorted.items():
        v_plain, c_plain = checker.check_valid(data[key].confs)
        print(f"  check_valid({key}, presort=True): {int(v_sorted.sum())} valid")
        require(np.array_equal(v_sorted, v_plain) and np.array_equal(c_sorted, c_plain),
                f"{key}: presort changes a verdict")
    print(f"  counter-kernel launches in the stats path: {stats_launches}; kernel "
          f"launches under presort: {presort_launches}; K2 {front4b['pose_rows']}, K5 "
          f"{front4b['robot_bounds']}")
    hard_poses = mk.poses_from_confs(torch.from_numpy(data["hard10k"].confs).to(device))
    stats_ms = event_ms(lambda: mk.check_poses_stats_cuda(hard_poses, tables), 20)
    stats_plain_ms = event_ms(lambda: mk.check_poses_stats_reference(hard_poses, tables), 1)
    hard_rows = mk.check_poses_stats_cuda(hard_poses, tables)
    hard_rows_twin = mk.check_poses_stats_reference(hard_poses, tables)
    print(f"  [{card}] counter kernel alone, hard10k {list(hard_poses.shape)}: {stats_ms} ms; "
          f"twin: {stats_plain_ms} ms")
    stats_err = max(stats_err, compare_stats("alpha hard10k, counter kernel vs twin",
                                             hard_rows, hard_rows_twin))
    hard_rows, hard_rows_twin = hard_rows.cpu().numpy(), hard_rows_twin.cpu().numpy()

    # ---- 6. The stage-decomposition surface. ----
    print(f"[6] stage variants on hard10k {list(hard_poses.shape)} and probe pieces")
    mk.check_poses_stage_cuda.launches = dict.fromkeys(mk.STAGES, 0)
    probes.reset_launches()
    stage_out = {s: mk.check_poses_stage_cuda(hard_poses, tables, s) for s in mk.STAGES}
    pieces = {st: probes.stage_pieces(st, device, tables.rob_base,
                                      n_groups=tables.obs_groups.shape[0]) for st in (1, 2, 3)}
    piece_out = {p.name: p.kernel() for st in pieces for p in pieces[st]}
    torch.cuda.synchronize()
    stage_launches = dict(mk.check_poses_stage_cuda.launches)
    probe_launches = {1: sum(probes.pose_probe_cuda.launches.values()),
                      2: probes.empty_probe_cuda.launches,
                      3: sum(probes.invariant_probe_cuda.launches.values())}
    print(f"  launches: stage variants {stage_launches}; probes P1 "
          f"{probes.pose_probe_cuda.launches}, P2 {probe_launches[2]}, P3 "
          f"{probes.invariant_probe_cuda.launches}")
    phase6_shapes(pieces, lib, built, card)
    # P1 level 2 does what a K1 row that misses in the broad phase does.
    far = np.zeros((probes.PROBE_BATCH, 6), np.float32)
    far[:, 0] = 1.0e9
    far_poses = mk.poses_from_confs(torch.from_numpy(far).to(device))
    k1_far = timers.kernel_ms(lambda: mk.check_poses_cuda(far_poses, tables), 20)
    p1_far = timers.kernel_ms(lambda: probes.pose_probe_cuda(
        far_poses, tables.rob_base, 2, tables.obs_groups.shape[0]), 20)
    print(f"  [{card}] {probes.PROBE_BATCH} rows at x = 1e9 (all broad-phase misses), device "
          f"ms by trace: K1 {k1_far}, P1 mini_level2 {p1_far}")
    # Bounds of this run's work on hard10k: the packed and counter kernels
    # from the counter kernel's rows (what their any-hit exit needed), the
    # stage variants (no exit) from the twin's.
    rob_np = tables.rob_base.cpu().numpy()
    n_obs, n_groups = tables.obs.shape[0], tables.obs_groups.shape[0]

    def bound(rows, stage="full", out_bytes=1):
        ms, by = bounds.bound_ms(*bounds.check_work(rob_np, n_obs, n_groups, rows, stage,
                                                    out_bytes))
        return {"bound_ms": ms, "bound_by": by}

    # No single PyTorch call computes any of these functions: library_ms null.
    entries = [
        {"name": "megakernel", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
         "ms": kernel_ms, "plain_ms": plain_ms, **bound(hard_rows), "library_ms": None},
        {"name": "megakernel_stats", "route": "cuda", "source": SOURCE,
         "replaces": "robocheck_tpu/kernels/megakernel.py:1126", "launches": stats_launches,
         "max_abs_err": stats_err, "ms": stats_ms, "plain_ms": stats_plain_ms,
         **bound(hard_rows, out_bytes=4 * mk.OUT_COLS), "library_ms": None}]
    full_ms = event_ms(lambda: mk.check_poses_cuda(hard_poses, tables), 20)
    for stage, out in stage_out.items():
        require(stage_launches[stage] > 0, f"stage variant {stage} was not launched")
        err = int((out.int() - 1).abs().max())
        s_ms = event_ms(lambda: mk.check_poses_stage_cuda(hard_poses, tables, stage), 20)
        p_ms = event_ms(lambda: torch.ones_like(out), 20)
        print(f"  [{card}] {stage}: {s_ms} ms (full kernel {full_ms} ms on the same rows); "
              f"plain (the byte 1) {p_ms} ms; max abs err {err}")
        require(err == 0, f"stage variant {stage}: a row is not the byte 1")
        entries.append({"name": f"megakernel_{stage}", "route": "cuda", "source": SOURCE,
                        "replaces": STAGE_REPLACES[stage], "launches": stage_launches[stage],
                        "max_abs_err": err, "ms": s_ms, "plain_ms": p_ms,
                        **bound(hard_rows_twin, stage), "library_ms": None})
    for st, (name, timed, replaces) in PROBES.items():
        require(probe_launches[st] > 0, f"probe {name} was not launched")
        worst, timing = 0, None
        for piece in pieces[st]:
            err = int((piece_out[piece.name].long() - piece.plain().long()).abs().max())
            # The device duration by trace (the share's figure), and CUDA
            # events around back-to-back calls beside it (at µs scale they
            # read the wrapper's issue time).
            k_ms = timers.kernel_ms(piece.kernel, 20)
            e_ms = event_ms(piece.kernel, 20)
            p_ms = event_ms(piece.plain, 2)
            print(f"  [{card}] {name} {piece.name} [{piece.n}]: {k_ms} ms device (trace), "
                  f"{e_ms} ms by events, plain {p_ms} ms, max abs err {err}")
            require(err == 0, f"{name} {piece.name}: differs from its plain version")
            worst = max(worst, err)
            if piece.name == timed:
                timing = (k_ms, p_ms, piece.n, e_ms)
        b_ms, b_by = bounds.bound_ms(*bounds.probe_work(timed, timing[2]))
        entries.append({"name": name, "route": "cuda", "source": PROBE_SOURCE,
                        "replaces": replaces, "launches": probe_launches[st],
                        "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                        "piece": timed, "event_ms": timing[3]})

    # ---- 7-10. The oversized-mesh path, the planners, the certifier, the
    # gradient planners. ----
    launches7, chunk_err, chunked_scenes = phase7(lib, card, device)
    launches8 = phase8(robot, obstacle, card)
    clearance_entry = phase9_engine(robot, obstacle, card, device)
    launches9, scans9 = phase9_certify(robot, obstacle, card)
    launches10, scans10, sqp_rec = phase10(robot, obstacle, card)

    # ---- 11-12. The dense reference pipeline; scale-out. ----
    phase11(robot, obstacle, data, card, resolved_s)
    launches12 = phase12(robot, obstacle, data, checker, card, sqp_rec)

    # ---- 13. The 100k sets and the bench. ----
    print("[13] the 100k sets (scripts/torch_make_datasets.py) and scripts/torch_bench.py")
    launches13, scans13, shapes13 = phase13(checker, card)
    clearance_entry["launches"] = scans9 + scans10 + launches12["clearance"] + scans13
    entries.append(clearance_entry)
    entries[0]["launches"] = (launches + launches7 + launches8 + launches9 + launches10
                              + launches12["megakernel"] + launches13)
    entries[0]["max_abs_err"] = max(max_err, chunk_err, shapes13["max_abs_err"])
    # K1's times and bound at the shape the headline bench launches it.
    entries[0].update(ms=shapes13["ms"], plain_ms=shapes13["plain_ms"],
                      **bound(shapes13["counter_rows"]))
    print(f"  [{card}] K1 at hard100k [100000,16] in one launch: {entries[0]['ms']} ms, bound "
          f"{entries[0]['bound_ms']} ms ({entries[0]['bound_by']}), "
          f"{100 * entries[0]['bound_ms'] / entries[0]['ms']}% of it; at hard10k [10000,16]: "
          f"{kernel_ms} ms, bound {bound(hard_rows)['bound_ms']} ms")
    entries[1]["launches"] = stats_launches + launches12["megakernel_stats"]
    resolve_entry["launches"] = rs.resolve_rows_cuda.launches
    entries.append(resolve_entry)
    entries += phase14(checker, data, scenes, chunked_scenes, card, device)
    entries.append(phase15(obstacle, built["clearance"][1], card, device))
    print(f"  megakernel launches by path: main {launches}, oversized meshes {launches7}, "
          f"planners {launches8}, certifier {launches9}, gradient planners {launches10}, "
          f"scale-out {launches12['megakernel']}, bench {launches13}; counter kernel: stats "
          f"path {stats_launches}, scale-out {launches12['megakernel_stats']}; scan kernel: "
          f"certifier {scans9}, gradient planners {scans10}, scale-out "
          f"{launches12['clearance']}, bench {scans13}")

    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
