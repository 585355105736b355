// Fused collision check for a batch of robot poses against one obstacle mesh.
//
// Replaces the Pallas TPU kernel `_kernel` + `_one_config` of
// robocheck_tpu/kernels/megakernel.py (launched by `_mega_call`). It computes
// what that kernel computes, in the same float32 operation order, and writes
// one byte per configuration: bit 0 = valid (no intersecting triangle pair),
// bit 1 = some live pair was flagged coplanar, bit 2 = some box-overlapping
// pair is uncertain: not live, though each triangle may straddle the other's
// plane once rounding is accounted for (see kErr below; the +-TOL band or
// rounding decided it), or live with an interval test that rounding could
// flip (a tie, see kErrI), which is neither a hit nor a miss. The checker
// sends valid rows with bit 1 or bit 2 to the float64 oracle. Its plain
// PyTorch twin is `check_poses_reference` in
// robocheck_tpu_torch/kernels/megakernel.py.
//
// What bounds it on an H100: it moves almost no bytes (64 B of pose in, 1 B
// out; the tables are read once per resident block), and its arithmetic is
// ~0.8 G single-lane float32 operations per 10,000 hard rows, ~0.02 ms at the
// card's peak. What it has to overcome is latency: each configuration is a
// chain of dependent steps (pose -> mesh box -> gate -> gated pair sweep with
// an any-hit exit) whose tests branch on data, and a few rows hold thousands
// of box-overlapping pairs. The first port (one 256-thread block per row)
// held 80 KB of posed robot per block, so two rows were in flight per SM,
// and its warps stepped through every obstacle row of a gated tile pair in
// lock-step, one overlapping lane taking the whole warp into the plane stage.
//
// What the design does about it:
//   * nothing posed is stored: a block stages the configuration-invariant
//     tables into shared memory once (rest-frame robot corners in a
//     tile-transposed, 33-padded layout, the obstacle triangles' boxes as a
//     structure of arrays, the group boxes, the real-triangle bits; ~62 KB
//     for the alpha-1.0 pair), stays resident (grid = resident blocks x
//     SMs), and posed triangles are recomputed from the rest-frame corners
//     where a step needs them (bit-identical: the same operations);
//   * several rows per block: the block's 16 warps form 4 teams of 4, each
//     team checks one row at a time, taken from the batch's counter, and
//     its warps meet at the team's own named barrier, so 4 rows share one
//     copy of the tables; one block (83 KB, 128 registers, no spills) fits
//     an SM. (Measured on an H100 against this: one warp per row lost on
//     easy10k, whose few heavy rows then ran on one warp each; one row per
//     block of 4 or 8 warps, the tables copied per block, fitted 2-3 rows
//     per SM and was 16-25% slower on hard10k; 3 teams were slower, and 5
//     or 6 teams spilled registers.)
//   * the pose pass gives lane l robot tile l of each block of 32 tiles and
//     splits a tile's 32 triangles over the team's warps (conflict-free
//     thanks to the padding); tile boxes meet in shared memory, and the mesh
//     box ends a broad-phase miss;
//   * the gate keeps (robot tile x obstacle group) pairs whose boxes overlap,
//     compacted in Morton order (tile-major), and the team's warps take
//     them in that order from a shared counter;
//   * a two-sided gate inside each gated tile pair: the lanes test 32
//     obstacle rows' boxes against the robot tile's box per ballot, and only
//     the rows whose bits are set are swept (the JAX gate's `cc > 0` made per
//     row);
//   * compaction instead of lock-step branches: each swept row's
//     box-overlapping (robot, obstacle) pairs are appended to the warp's
//     queue in shared memory with ballot prefix sums; every 32 queued pairs
//     the plane stage, the uncertain test, the interval stage and the
//     coplanar test run one pair per lane (`run_pairs`, kept out of line so
//     that its registers stay out of the sweep's loops), so obstacle rows
//     are read only for queued pairs;
//   * the any-hit exit: a warp that finds a hit after a flush raises a
//     shared flag, and every warp stops at its next tile pair;
//   * non-finite rows end at the load: a row whose 12 pose floats are not all
//     finite (K2 makes them so exactly where the configuration row is) gets
//     the byte 0 (invalid, nothing flagged), or an all-zero counter row, and
//     is counted in `nonfinite` (when given). Every thread of the team tests
//     the same 12 floats, so the branch is uniform; the checker then needs no
//     host pass over the batch.

// Instances (`template <bool kStats, int kStage>`):
//   * <false, kFull>: the packed byte above, the checker's main path;
//   * <true, kFull>: the counter row of the JAX kernel's stats output
//     (`megakernel.py:1116-1120`), int32 [n, 8]: 0 valid, 1 coplanar,
//     2 num_pairs, 3 broad, 4 nfull, 5 ngate, 6 nrest, 7 zero. Columns 4-6
//     count this kernel's tile pairs (32 robot x 128 obstacle triangles),
//     not the JAX kernel's 128 x 128 tiles, in the same units as the first
//     port: nfull = gated tile pairs with at least one box-overlapping pair
//     (real robot triangle), ngate = gated tile pairs with none, nrest = tile
//     pairs with at least one live pair (both planes straddle the +-TOL
//     band). Counts cover what was visited before the any-hit exit, as the
//     JAX kernel's do; every count is a sum of ballot popcounts, so they are
//     deterministic. This instance leaves out both uncertain tests (column
//     7 stays 0), so an interval tie counts as the hit or miss it computes;
//   * <false, kNoSweep / kMaskOnly / kPlanesOnly / kNoDiv>: the
//     stage-isolating variants of the JAX kernel's `sweep=False` and
//     `stage_cap` 0 / 1 / 3 (`megakernel.py:625-643, 761-775`), which
//     `scripts/torch_roofline.py` times: the gate only; the sweep up to the
//     queue (box tests and compaction); the plane stage on queued pairs
//     (with the uncertain test of the pairs that are not live); and the full
//     sweep with every divide of the interval stage and the coplanar test
//     replaced by a multiply (`_probe_div`). Each keeps its stage's work
//     live with `hit = count > 0 && rt_false` (rt_false is a kernel
//     argument, always 0), so it never sets hit, coplanar or uncertain and
//     writes the byte 1 on every finite row; none takes the any-hit exit. Table
//     values are never multiplied by that zero: the obstacle padding rows
//     hold +-inf.
// `if constexpr` keeps the counter and variant code out of the packed
// instance.
//
// Arithmetic: build with -fmad=false and without fast math. The TOL=1e-6
// bands and the >= interval tests were validated on arithmetic that rounds
// each multiply and each add on its own; IEEE division and denormals stay at
// nvcc's defaults. Box minima and maxima propagate NaN (min.NaN / max.NaN),
// as torch.minimum and jnp.minimum do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The block's geometry, which only this file reads (the host's tables do not
// depend on it): `scripts/torch_tile_sweep.py` builds copies of this file
// with other values defined first. kRows <= 15 (named barriers 1..kRows),
// 32 * kWarps * kRows <= 1024.
#ifndef RC_WARPS
#define RC_WARPS 4
#endif
#ifndef RC_ROWS
#define RC_ROWS 4
#endif
#ifndef RC_MIN_BLOCKS
#define RC_MIN_BLOCKS 1
#endif

namespace {

constexpr int kWarps = RC_WARPS;       // warps sharing one row
constexpr int kRows = RC_ROWS;         // rows in flight per block, one per team of kWarps warps
constexpr int kTeamThreads = 32 * kWarps;
constexpr int kThreads = kTeamThreads * kRows;
constexpr int kMinBlocks = RC_MIN_BLOCKS;  // resident blocks per SM
constexpr int kRobTile = 32;           // robot triangles per tile: one per lane
constexpr int kGroup = 128;            // obstacle triangles per group box
constexpr int kObsCols = 20;           // obstacle row: corners 0-8, n 9-11, d 12,
                                       // box lo 13-15, box hi 16-18, zero 19
constexpr int kObsLo = 13;
constexpr int kPad = 33;               // padded row of the transposed robot table
constexpr int kTileBlock = 32 * kPad;  // floats of one field of 32 robot tiles
constexpr int kQueue = 64;             // per-warp pair queue: < 32 left + 32 new
constexpr float kTol = 1e-6f;
constexpr float kBig = 3.0e38f;        // fill of boxes with no real triangle
constexpr int kStatCols = 8;           // columns of the stats instance's output row
constexpr unsigned kAll = 0xffffffffu;

// Rounding bound of a signed distance s = ((nx*cx + ny*cy) + nz*cz) + d,
// evaluated in float32 from float32 corners and planes, one rounding per
// multiply and add (-fmad=false). The product nx*cx passes through four
// roundings (its own and three adds), so with u = 2^-24 the standard bound
// for a dot product (Higham, Accuracy and Stability, 3.1) gives
//   |fl(s) - s| <= gamma_4 * (|nx*cx| + |ny*cy| + |nz*cz| + |d|),
//   gamma_4 = 4u / (1 - 4u) = 2.3841864e-7.
// kErr is that gamma_4 times a safety factor of 2 (2 * gamma_4 =
// 4.7683727e-7, rounded up): the factor covers the float32 rounding of the
// bound itself (relative <= gamma_4) and of the shifted comparisons
// d +- e against 0 (one rounding each), with a margin of gamma_4 times the
// sum left over, far above the error of a float64 evaluation of the same
// inputs. Underflow adds at most 2^-149 per operation. An overflowing sum
// gives e = inf, which marks the pair uncertain: conservative. The
// comparison is against 0, not +-TOL: a pair that the +-TOL band alone keeps
// from being live (a penetration shallower than TOL / |n| of small
// triangles, whose unnormalised distances are small) is uncertain too, and
// its row goes to the float64 oracle, which has no band.
constexpr float kErr = 4.7684e-07f;

// Rounding bound of an interval end (`endpoint`) of a live pair,
//   t = pa + (pb - pa) * s,  s = da / (da - db),
// pa = ((Dx*ax + Dy*ay) + Dz*az) the projection of corner a on the computed
// line direction D, da its signed distance to the other plane (bound ga =
// kErr * (...), above, which is twice the distance's own bound e_a), and
// likewise for corner b. D's own rounding does not enter: the interval test
// compares points of the two planes' line of intersection, and projecting
// points of one line onto any direction not normal to it keeps their order;
// so D is taken as exact. With u = 2^-24, s in [0, 1] (da and db have
// opposite signs in the canonical permutation, and fl(da - db) >= |da|),
// aa = |Dx*ax| + |Dy*ay| + |Dz*az| and w = |pb - pa|:
//   * |pa - Pa| <= gamma_3 aa (a dot product of three terms), and the same
//     for pb, so fl(pb - pa) is off by gamma_3 (aa + ab) + u w;
//   * |s - S| <= (e_a + e_b) / (|dd| - e_a - e_b), dd = da - db: at most
//     2 (e_a + e_b) / |dd| <= (ga + gb) / |dd| while e_a + e_b <= |dd| / 2;
//     past that, (ga + gb) / |dd| >= 1 and w (ga + gb) / |dd| covers the
//     whole edge, which holds both ends. The divide and the subtraction add
//     gamma_2 s;
//   * the multiply and the add round once each (u |w s| + u |t|, and
//     |t| <= aa + w up to rounding).
// Summed, |t - T| <= 10u aa + 6u ab + 5u w + w (ga + gb) / |dd| to first
// order in u, where the cross term of a saturated |s - S| with the error of
// pb - pa is counted in. kErrI = 32u = 1.9073486e-6 covers that sum twice
// over, which leaves a margin for the float32 rounding of the bound itself
// and of the shifted comparisons below (each t moves by E >= 32u |t|, so one
// rounding of t + E is at most 1/32 of E). The bound of an interval's ends is
// the larger of its two endpoints' (min and max move each end by at most
// that), and the pair's interval test is uncertain when moving each end by
// it could flip the test. An overflowing bound is inf: uncertain.
constexpr float kErrI = 1.9073486e-06f;

enum Stage : int { kFull = 0, kNoSweep = 1, kMaskOnly = 2, kPlanesOnly = 3, kNoDiv = 4 };

// NaN-propagating min / max (torch.minimum / jnp.minimum), one instruction each.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = min_nan(v, __shfl_xor_sync(kAll, v, s));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = max_nan(v, __shfl_xor_sync(kAll, v, s));
  return v;
}

// Closed-interval overlap of boxes a and b, each lo x,y,z then hi x,y,z.
__device__ __forceinline__ bool boxes_touch(const float a[6], const float b[6]) {
  return a[0] <= b[3] && b[0] <= a[3] && a[1] <= b[4] && b[1] <= a[4] &&
         a[2] <= b[5] && b[2] <= a[5];
}

// Offset of robot triangle t in one field of the transposed table: 32 tiles
// of 32 triangles per tile block, triangle k of tile l at k * kPad + l.
__device__ __forceinline__ int rob_slot(int t) {
  return (t >> 10) * kTileBlock + (t & 31) * kPad + ((t >> 5) & 31);
}

// Posed corners of the triangle whose fields start at `s` (field stride
// `fs`): r0*x + r1*y + r2*z + t per axis, as the twin and the JAX kernel.
__device__ __forceinline__ void pose_tri(const float* s, int fs, const float p[12],
                                         float c[9]) {
#pragma unroll
  for (int cc = 0; cc < 3; ++cc) {
    const float X = s[(3 * cc) * fs], Y = s[(3 * cc + 1) * fs], Z = s[(3 * cc + 2) * fs];
    c[3 * cc + 0] = p[0] * X + p[1] * Y + p[2] * Z + p[3];
    c[3 * cc + 1] = p[4] * X + p[5] * Y + p[6] * Z + p[7];
    c[3 * cc + 2] = p[8] * X + p[9] * Y + p[10] * Z + p[11];
  }
}

__device__ __forceinline__ void tri_box(const float c[9], float box[6]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    box[k] = min_nan(min_nan(c[k], c[3 + k]), c[6 + k]);
    box[3 + k] = max_nan(max_nan(c[k], c[3 + k]), c[6 + k]);
  }
}

// Plane n = (c1 - c0) x (c2 - c1), d = -n.c0 of posed corners c[0..8],
// written to c[9..12].
__device__ __forceinline__ void tri_plane(float c[13]) {
  const float e1x = c[3] - c[0], e1y = c[4] - c[1], e1z = c[5] - c[2];
  const float e2x = c[6] - c[3], e2y = c[7] - c[4], e2z = c[8] - c[5];
  c[9] = e1y * e2z - e1z * e2y;
  c[10] = e1z * e2x - e1x * e2z;
  c[11] = e1x * e2y - e1y * e2x;
  c[12] = -(c[9] * c[0] + c[10] * c[1] + c[11] * c[2]);
}

// a / b, or a * b in the kNoDiv variant (`_probe_div`).
template <bool kDiv>
__device__ __forceinline__ float dv(float a, float b) {
  if constexpr (kDiv) return a / b;
  else return a * b;
}

// Some corner at or above +TOL and some at or below -TOL.
__device__ __forceinline__ bool straddles(const float d[3]) {
  return (d[0] >= kTol || d[1] >= kTol || d[2] >= kTol) &&
         (d[0] <= -kTol || d[1] <= -kTol || d[2] <= -kTol);
}

// Whether the triangle may straddle the plane itself (no +-TOL band) once
// each distance moves by its rounding bound e: some d + e >= 0 and some
// d - e <= 0. A pair that is not live but passes this for both triangles is
// uncertain: rounding or the band decided it (see kErr).
__device__ __forceinline__ bool may_straddle(const float d[3], const float e[3]) {
  return (d[0] + e[0] >= 0.f || d[1] + e[1] >= 0.f || d[2] + e[2] >= 0.f) &&
         (d[0] - e[0] <= 0.f || d[1] - e[1] <= 0.f || d[2] - e[2] <= 0.f);
}

// Signed distances of corners `c` to plane `pl` (nx, ny, nz, d), and (if
// `err`) their rounding bounds.
__device__ __forceinline__ void dists(const float pl[4], const float c[9], float d[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    d[k] = pl[0] * c[3 * k] + pl[1] * c[3 * k + 1] + pl[2] * c[3 * k + 2] + pl[3];
}
__device__ __forceinline__ void dist_errs(const float pl[4], const float c[9], float e[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    e[k] = kErr * (((fabsf(pl[0] * c[3 * k]) + fabsf(pl[1] * c[3 * k + 1])) +
                    fabsf(pl[2] * c[3 * k + 2])) + fabsf(pl[3]));
}

template <bool kDiv>
__device__ __forceinline__ float endpoint(float pa, float pb, float da, float db) {
  float dd = da - db;
  if (dd == 0.f) dd = 1.f;
  return pa + (pb - pa) * dv<kDiv>(da, dd);
}

// The rounding bound of endpoint(pa, pb, da, db) (kErrI above): ga, gb the
// distances' bounds, aa, ab the projections' sums of absolute terms.
template <bool kDiv>
__device__ __forceinline__ float endpoint_err(float pa, float pb, float da, float db,
                                              float ga, float gb, float aa, float ab) {
  float dd = da - db;
  if (dd == 0.f) dd = 1.f;
  const float w = fabsf(pb - pa);
  return kErrI * ((aa + ab) + w) + w * dv<kDiv>(ga + gb, fabsf(dd));
}

// Canonical permutation of a corner field: x[0..2] -> the order of
// `interval`'s ends (the lone corner in the middle).
__device__ __forceinline__ void canon(bool c01, bool c02, const float x[3], float y[3]) {
  y[0] = c01 ? x[0] : (c02 ? x[0] : x[1]);
  y[1] = c01 ? x[2] : (c02 ? x[1] : x[0]);
  y[2] = c01 ? x[1] : x[2];
}

// Canonical permutation and interval ends on the intersection line; with
// kErr, also the bound `err` of the ends, from the distances' bounds g and
// the projections' sums of absolute terms a.
template <bool kDiv, bool kErr>
__device__ __forceinline__ void interval(const float p[3], const float d[3], const float g[3],
                                         const float a[3], float& lo, float& hi, float& err) {
  const bool c01 = (d[0] > 0.f && d[1] > 0.f) || (d[0] < 0.f && d[1] < 0.f);
  const bool c02 = (d[0] > 0.f && d[2] > 0.f) || (d[0] < 0.f && d[2] < 0.f);
  float q[3], e[3];
  canon(c01, c02, p, q);
  canon(c01, c02, d, e);
  const float t01 = endpoint<kDiv>(q[0], q[1], e[0], e[1]);
  const float t12 = endpoint<kDiv>(q[1], q[2], e[1], e[2]);
  lo = min_nan(t01, t12);
  hi = max_nan(t01, t12);
  if constexpr (kErr) {
    float gg[3], aa[3];
    canon(c01, c02, g, gg);
    canon(c01, c02, a, aa);
    err = max_nan(endpoint_err<kDiv>(q[0], q[1], e[0], e[1], gg[0], gg[1], aa[0], aa[1]),
                  endpoint_err<kDiv>(q[1], q[2], e[1], e[2], gg[1], gg[2], aa[1], aa[2]));
  }
}

template <bool kDiv>
__device__ __forceinline__ bool isclose(float v1, float v2) {
  const float a1 = fabsf(v1), a2 = fabsf(v2);
  const bool both = a1 < kTol && a2 < kTol;
  const bool one = a1 < kTol || a2 < kTol;
  const bool rel = fabsf(dv<kDiv>(v1 - v2, a1 < kTol ? 1.f : v1)) < kTol;
  return both || (!one && rel);
}

// Exact component-ratio coplanarity test of planes r and o (nx, ny, nz, d).
template <bool kDiv>
__device__ __forceinline__ bool ratio_coplanar(const float r[4], const float o[4]) {
  bool mismatch = false, valid[4];
  float ratio[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool zr = fabsf(r[k]) < kTol, zo = fabsf(o[k]) < kTol;
    mismatch |= zr != zo;
    valid[k] = !zr && !zo;
    ratio[k] = dv<kDiv>(r[k], valid[k] ? o[k] : 1.f);
  }
  const float ratio0 = valid[0] ? ratio[0]
                     : valid[1] ? ratio[1]
                     : valid[2] ? ratio[2] : ratio[3];
  bool ok = !mismatch;
#pragma unroll
  for (int k = 0; k < 4; ++k) ok = ok && (!valid[k] || isclose<kDiv>(ratio0, ratio[k]));
  return ok;
}

// Projection of corners c[0..8] on D, and (kErr) each one's sum of
// absolute terms.
template <bool kErr>
__device__ __forceinline__ void project(float Dx, float Dy, float Dz, const float c[9],
                                        float p[3], float a[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float x = Dx * c[3 * k], y = Dy * c[3 * k + 1], z = Dz * c[3 * k + 2];
    p[k] = (x + y) + z;
    if constexpr (kErr) a[k] = (fabsf(x) + fabsf(y)) + fabsf(z);
  }
}

// Interval stage and coplanar flag of one live pair: robot fields rf
// (corners 0-8, plane 9-12), obstacle corners oc and plane op, the signed
// distances and (kTie) their bounds e_o, e_r. With kTie, a pair whose
// interval test could flip with each interval end moved by its bound
// (kErrI) is a tie: neither hit nor miss. Coplanar pairs are flagged as
// such, never as ties or hits.
template <bool kDiv, bool kTie>
__device__ __forceinline__ void interval_stage(const float rf[13], const float oc[9],
                                               const float op[4], const float dist_o[3],
                                               const float dist_r[3], const float e_o[3],
                                               const float e_r[3], bool& hit, bool& cop,
                                               bool& tie) {
  const float nrx = rf[9], nry = rf[10], nrz = rf[11];
  const float nox = op[0], noy = op[1], noz = op[2];
  const float Dx = nry * noz - nrz * noy;
  const float Dy = nrz * nox - nrx * noz;
  const float Dz = nrx * noy - nry * nox;
  float pr[3], po[3], ar[3], ao[3];
  project<kTie>(Dx, Dy, Dz, rf, pr, ar);
  project<kTie>(Dx, Dy, Dz, oc, po, ao);
  float min_r, max_r, min_o, max_o, err_r = 0.f, err_o = 0.f;
  interval<kDiv, kTie>(pr, dist_r, e_r, ar, min_r, max_r, err_r);
  interval<kDiv, kTie>(po, dist_o, e_o, ao, min_o, max_o, err_o);
  const bool isect = !(min_r >= max_o || min_o >= max_r);
  const bool coplanar = ratio_coplanar<kDiv>(rf + 9, op);
  tie = false;
  if constexpr (kTie) {
    const float E = err_r + err_o;
    tie = !coplanar && (min_r + E >= max_o || min_o + E >= max_r) &&
          min_r < max_o + E && min_o < max_r + E;
  }
  hit = isect && !coplanar && !tie;
  cop = coplanar;
}

// Barrier of the kWarps warps (team t) checking one row, and the same with
// an OR of `v` over their threads (named barriers 1..kRows; 0 is the block's).
__device__ __forceinline__ void team_sync(int t) {
  asm volatile("bar.sync %0, %1;" ::"r"(t + 1), "r"(kTeamThreads) : "memory");
}
__device__ __forceinline__ bool team_or(int t, bool v) {
  int r;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.u32 p, %1, 0;\n bar.red.or.pred q, %2, %3, p;\n"
      " selp.s32 %0, 1, 0, q;\n}"
      : "=r"(r)
      : "r"(int(v)), "r"(t + 1), "r"(kTeamThreads)
      : "memory");
  return r != 0;
}

// Per-warp state of one configuration's sweep. hit / cop / unc / keep are
// per lane; the counters are warp-uniform.
struct Acc {
  bool hit = false, cop = false, unc = false;
  int keep = 0;  // work kept live in the stage variants
  int pairs = 0, full = 0, gate = 0, rest = 0, last_seq = -1;  // kStats
};

// The queued pairs 0..cnt-1, lane l taking pair l: plane stage, then the
// interval stage (with its tie test) of live pairs and the uncertain test of
// the others. Not
// inlined: its registers (the interval stage and IEEE divides) stay out of
// the sweep's loops, which call it once per 32 queued pairs.
template <bool kStats, int kStage>
__device__ __noinline__ Acc run_pairs(int cnt, const int* queue, const int* qseq,
                                      const float* rob_s, int fs, const float* pose,
                                      const float4* __restrict__ obs4, Acc a) {
  const int lane = threadIdx.x & 31;
  bool live = false;
  if (lane < cnt) {
    if constexpr (kStage == kMaskOnly) {
      ++a.keep;
    } else {
      const int e = queue[lane];
      float p[12], rf[13];
#pragma unroll
      for (int k = 0; k < 12; ++k) p[k] = pose[k];
      pose_tri(rob_s + rob_slot(e >> 16), fs, p, rf);
      tri_plane(rf);
      const float4* row = obs4 + size_t(e & 0xffff) * (kObsCols / 4);
      const float4 a0 = __ldg(row), a1 = __ldg(row + 1), a2 = __ldg(row + 2);
      const float4 a3 = __ldg(row + 3);
      const float oc[9] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x};
      const float op[4] = {a2.y, a2.z, a2.w, a3.x};
      float dist_o[3], dist_r[3], e_o[3] = {}, e_r[3] = {};
      dists(rf + 9, oc, dist_o);  // obstacle corners to the robot plane
      dists(op, rf, dist_r);      // robot corners to the obstacle plane
      if constexpr (!kStats) {
        dist_errs(rf + 9, oc, e_o);
        dist_errs(op, rf, e_r);
      }
      live = straddles(dist_o) && straddles(dist_r);
      if (live) {
        if constexpr (kStage == kPlanesOnly) {
          ++a.keep;
        } else {
          bool h, c, u;
          interval_stage<kStage != kNoDiv, !kStats>(rf, oc, op, dist_o, dist_r, e_o, e_r, h,
                                                    c, u);
          if constexpr (kStage == kNoDiv) {
            a.keep += h || c || u;
          } else {
            a.hit = a.hit || h;
            a.cop = a.cop || c;
            a.unc = a.unc || u;
          }
        }
      } else if constexpr (!kStats) {
        const bool u = may_straddle(dist_o, e_o) && may_straddle(dist_r, e_r);
        if constexpr (kStage == kFull) a.unc = a.unc || u;
        else a.keep += u;
      }
    }
  }
  if constexpr (kStats) {
    // nrest: the tile pairs (sequence numbers, ascending along the queue)
    // with a live pair, each counted once across flushes.
    const unsigned lb = __ballot_sync(kAll, live);
    if (lb) {
      const int sq = lane < cnt ? qseq[lane] : 0;
      const unsigned before = lb & ((1u << lane) - 1u);
      int prev_sq = __shfl_sync(kAll, sq, before ? 31 - __clz(before) : 0);
      if (!before) prev_sq = a.last_seq;
      a.rest += __popc(__ballot_sync(kAll, live && sq != prev_sq));
      a.last_seq = __shfl_sync(kAll, sq, 31 - __clz(lb));
    }
  }
  return a;
}

// Control words (shared) of the row a team is checking: its index, the
// next gated tile pair to take, the any-hit flag, the counter sums, and the
// gate's per-warp counts.
enum Ctl : int {
  cRow = 0, cNext, cHit, cPairs, cFull, cGate, cRest, cWCount, cWords = cWCount + kWarps
};

// Shared-memory layout (floats) of one block for tr robot and to obstacle rows.
struct Layout {
  int n_tiles, n_groups, to, fs;  // fs: field stride of the transposed robot table
  __host__ __device__ Layout(int tr, int to_, int groups)
      : n_tiles(tr / kRobTile), n_groups(groups), to(to_),
        fs(((tr / kRobTile + 31) / 32) * kTileBlock) {}
  // The tables: rest-frame robot corners [9][fs], obstacle boxes [6][to],
  // group boxes [n_groups][6], real-triangle bits [n_tiles].
  __host__ __device__ int obox() const { return 9 * fs; }
  __host__ __device__ int gbox() const { return obox() + 6 * to; }
  __host__ __device__ int realw() const { return gbox() + 6 * n_groups; }
  // Per team t: control words [cWords], pose [16], tile boxes
  // [n_tiles][6], gated tile pairs [n_tiles * n_groups], and scratch: the
  // pose pass's partial tile boxes [kWarps][6][32], later the warps' pair
  // queues and tags [kWarps][2 * kQueue].
  __host__ __device__ int row_floats() const {
    const int part = kWarps * 6 * 32, queues = kWarps * 2 * kQueue;
    return cWords + 16 + 6 * n_tiles + n_tiles * n_groups + (part > queues ? part : queues);
  }
  __host__ __device__ int ctl(int t) const { return realw() + n_tiles + t * row_floats(); }
  __host__ __device__ int pose(int t) const { return ctl(t) + cWords; }
  __host__ __device__ int tile_box(int t) const { return pose(t) + 16; }
  __host__ __device__ int items(int t) const { return tile_box(t) + 6 * n_tiles; }
  __host__ __device__ int scratch(int t) const { return items(t) + n_tiles * n_groups; }
  __host__ __device__ size_t bytes() const { return 4 * size_t(ctl(kRows)); }
};

// `out` is uint8 [n] (packed instances) or int32 [n, kStatCols] (kStats);
// `work` is the batch's row counter, 0 at launch; `nonfinite` (may be null)
// counts the rows with a non-finite pose float.
template <bool kStats, int kStage>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
megakernel(const float* __restrict__ poses, int n_confs,
           const float* __restrict__ rob_base, int tr,
           const float* __restrict__ obs, int to,
           const float* __restrict__ obs_mesh,
           const float* __restrict__ obs_groups, int n_groups,
           void* __restrict__ out_ptr, int* __restrict__ work,
           int64_t* __restrict__ nonfinite, int rt_false) {
  static_assert(!kStats || kStage == kFull, "counters come with the full sweep only");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(tr, to, n_groups);
  const int n_tiles = L.n_tiles, fs = L.fs;
  float* rob_s = smem + 0;                // [9][fs] rest-frame corners, transposed
  float* obox = smem + L.obox();          // [6][to] obstacle boxes lo x,y,z, hi x,y,z
  float* gbox = smem + L.gbox();          // [n_groups][6] group boxes
  unsigned* realw = reinterpret_cast<unsigned*>(smem + L.realw());  // real bits per tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // This thread's team (the warps checking one row), its warp and thread
  // index within the team.
  const int team = warp / kWarps, twarp = warp % kWarps, ttid = tid % kTeamThreads;
  volatile int* ctl = reinterpret_cast<int*>(smem + L.ctl(team));
  float* pose = smem + L.pose(team);
  float* tile_box = smem + L.tile_box(team);
  int* items = reinterpret_cast<int*>(smem + L.items(team));
  float* part = smem + L.scratch(team);
  int* queue = reinterpret_cast<int*>(part) + twarp * 2 * kQueue;  // robot << 16 | obs
  int* qseq = queue + kQueue;                                     // tile-pair tags (kStats)
  const float4* obs4 = reinterpret_cast<const float4*>(obs);
  uint8_t* out = static_cast<uint8_t*>(out_ptr);
  int32_t* out_stats = static_cast<int32_t*>(out_ptr);

  // ---- The configuration-invariant tables, once per block. ----
  for (int i = tid; i < 9 * tr; i += kThreads) {
    const int f = i / tr, t = i - f * tr;
    rob_s[f * fs + rob_slot(t)] = rob_base[i];
  }
  for (int i = tid; i < 6 * to; i += kThreads) {
    const int s = i / to, o = i - s * to;
    obox[i] = obs[size_t(o) * kObsCols + kObsLo + s];
  }
  for (int i = tid; i < 6 * n_groups; i += kThreads) gbox[i] = obs_groups[i];
  for (int tile = warp; tile < n_tiles; tile += kThreads / 32) {
    const unsigned w = __ballot_sync(kAll, rob_base[9 * tr + tile * kRobTile + lane] > 0.f);
    if (lane == 0) realw[tile] = w;
  }
  __syncthreads();
  const int total = n_tiles * n_groups;
  // Rows are taken one at a time from the batch's counter, the next row's
  // index fetched while this one is checked.
  int next_row = 0;
  if (ttid == 0) next_row = atomicAdd(work, 1);

  for (;;) {
    if (ttid == 0) {
      ctl[cRow] = next_row;
      next_row = atomicAdd(work, 1);
      for (int c = cNext; c < cWCount; ++c) ctl[c] = 0;
    }
    team_sync(team);  // also: the previous row's readers of the scratch are done
    const int b = ctl[cRow];
    if (b >= n_confs) break;
    if (ttid < 12) pose[ttid] = __ldg(poses + size_t(b) * 16 + ttid);
    team_sync(team);
    float p[12];
    bool finite = true;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      p[k] = pose[k];
      finite &= bool(isfinite(p[k]));
    }
    if (!finite) {  // the same 12 floats on every thread of the team
      if (ttid == 0) {
        if constexpr (kStats) {
#pragma unroll
          for (int c = 0; c < kStatCols; ++c) out_stats[size_t(b) * kStatCols + c] = 0;
        } else {
          out[b] = 0;
        }
        if (nonfinite) atomicAdd(reinterpret_cast<unsigned long long*>(nonfinite), 1ull);
      }
      continue;
    }

    // ---- Pose pass: lane l poses robot tile l of each tile block, its
    // triangles split across the team's warps; partial boxes meet in
    // `part`. ----
    for (int tb = 0; tb * 32 < n_tiles; ++tb) {
      const int tile = tb * 32 + lane;
      float t[6] = {kBig, kBig, kBig, -kBig, -kBig, -kBig};
      if (tile < n_tiles) {
        const float* base = rob_s + tb * kTileBlock + lane;
        const unsigned rw = realw[tile];
#pragma unroll
        for (int j = 0; j < (kRobTile + kWarps - 1) / kWarps; ++j) {
          const int k = twarp + kWarps * j;
          if (k >= kRobTile) break;
          float c[9], box[6];
          pose_tri(base + k * kPad, fs, p, c);
          tri_box(c, box);
          const bool real = (rw >> k) & 1u;
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            t[ax] = min_nan(t[ax], real ? box[ax] : kBig);
            t[3 + ax] = max_nan(t[3 + ax], real ? box[3 + ax] : -kBig);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) part[(twarp * 6 + k) * 32 + lane] = t[k];
      team_sync(team);
      for (int e = ttid; e < 6 * 32; e += kTeamThreads) {
        const int k = e >> 5;
        float v = part[e];
        for (int w = 1; w < kWarps; ++w) {
          const float x = part[w * 6 * 32 + e];
          v = k < 3 ? min_nan(v, x) : max_nan(v, x);
        }
        if (tb * 32 + lane < n_tiles) tile_box[(tb * 32 + lane) * 6 + k] = v;
      }
      team_sync(team);
    }
    // Mesh-box broad phase (closed intervals), on every warp alike.
    float m[6] = {kBig, kBig, kBig, -kBig, -kBig, -kBig};
    for (int tile = lane; tile < n_tiles; tile += 32) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        m[k] = min_nan(m[k], tile_box[tile * 6 + k]);
        m[3 + k] = max_nan(m[3 + k], tile_box[tile * 6 + 3 + k]);
      }
    }
    bool broad = true;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      broad = broad && warp_min(m[k]) <= __ldg(obs_mesh + 3 + k) &&
              __ldg(obs_mesh + k) <= warp_max(m[3 + k]);
    if (!broad) {
      if (ttid == 0) {
        if constexpr (kStats) {
#pragma unroll
          for (int c = 0; c < kStatCols; ++c) out_stats[size_t(b) * kStatCols + c] = c == 0;
        } else {
          out[b] = 1;
        }
      }
      continue;
    }

    // ---- Gate: robot tile box x obstacle group box, compacted in order. ----
    int n_items = 0;
    for (int q0 = 0; q0 < total; q0 += kTeamThreads) {
      const int q = q0 + ttid;
      const bool pass =
          q < total && boxes_touch(tile_box + (q / n_groups) * 6, gbox + (q % n_groups) * 6);
      const unsigned ballot = __ballot_sync(kAll, pass);
      if (lane == 0) ctl[cWCount + twarp] = __popc(ballot);
      team_sync(team);
      int off = n_items, round_total = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int cnt = ctl[cWCount + w];
        if (w < twarp) off += cnt;
        round_total += cnt;
      }
      if (pass) items[off + __popc(ballot & ((1u << lane) - 1u))] = q;
      n_items += round_total;
      team_sync(team);
    }

    // ---- Sweep: the team's warps take gated tile pairs in order from a
    // shared counter; two-sided gate, compaction, pair stages; any-hit
    // exit. ----
    Acc a;
    if constexpr (kStage == kNoSweep) {
      a.keep = n_items;
    } else {
      int qn = 0;      // queued pairs
      int posed = -1;  // robot tile whose triangle this lane holds
      float rb[6];     // this lane's robot triangle posed_tile*32+lane: box, real
      bool real = false;
      for (;;) {
        int k = 0;
        if (lane == 0) k = atomicAdd(const_cast<int*>(ctl + cNext), 1);
        k = __shfl_sync(kAll, k, 0);
        if (k >= n_items) break;
        if (kStage == kFull && ctl[cHit]) goto swept;  // another warp found a hit
        const int q = items[k];
        const int i = q / n_groups, j = q - i * n_groups;
        float tbox[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) tbox[c] = tile_box[i * 6 + c];
        if (posed != i) {
          float c[9];
          pose_tri(rob_s + rob_slot(i * kRobTile + lane), fs, p, c);
          tri_box(c, rb);
          real = (realw[i] >> lane) & 1u;
          posed = i;
        }
        int tp_pairs = 0;
        for (int s = 0; s < kGroup / 32; ++s) {
          const int o0 = j * kGroup + s * 32;
          float ob[6];
#pragma unroll
          for (int c = 0; c < 6; ++c) ob[c] = obox[c * to + o0 + lane];
          for (unsigned rows = __ballot_sync(kAll, boxes_touch(tbox, ob)); rows;
               rows &= rows - 1) {
            const int src = __ffs(rows) - 1;
            float x[6];
#pragma unroll
            for (int c = 0; c < 6; ++c) x[c] = __shfl_sync(kAll, ob[c], src);
            const bool ov = real && boxes_touch(rb, x);
            const unsigned hits = __ballot_sync(kAll, ov);
            if (!hits) continue;
            if (ov) {
              const int at = qn + __popc(hits & ((1u << lane) - 1u));
              queue[at] = ((i * kRobTile + lane) << 16) | (o0 + src);
              if constexpr (kStats) qseq[at] = k;
            }
            const int added = __popc(hits);
            if constexpr (kStats) {
              a.pairs += added;
              a.full += tp_pairs == 0;
            }
            tp_pairs += added;
            qn += added;
            if (qn >= 32) {
              __syncwarp();
              a = run_pairs<kStats, kStage>(32, queue, qseq, rob_s, fs, pose, obs4, a);
              const int left = qn - 32;
              int e = 0, es = 0;
              if (lane < left) {
                e = queue[32 + lane];
                es = qseq[32 + lane];
              }
              __syncwarp();
              if (lane < left) {
                queue[lane] = e;
                qseq[lane] = es;
              }
              __syncwarp();
              qn = left;
              if constexpr (kStage == kFull) {
                if (__any_sync(kAll, a.hit)) {  // any-hit exit
                  if (lane == 0) ctl[cHit] = 1;
                  goto swept;
                }
              }
            }
          }
        }
        if constexpr (kStats) a.gate += tp_pairs == 0;
      }
      if (qn > 0) {
        __syncwarp();
        a = run_pairs<kStats, kStage>(qn, queue, qseq, rob_s, fs, pose, obs4, a);
      }
    }
  swept:
    if constexpr (kStats) {
      if (lane == 0) {
        atomicAdd(const_cast<int*>(ctl + cPairs), a.pairs);
        atomicAdd(const_cast<int*>(ctl + cFull), a.full);
        atomicAdd(const_cast<int*>(ctl + cGate), a.gate);
        atomicAdd(const_cast<int*>(ctl + cRest), a.rest);
      }
    }
    if constexpr (kStage == kFull) {
      const bool any_hit = team_or(team, a.hit);
      const bool any_cop = team_or(team, a.cop);
      const bool any_unc = team_or(team, a.unc);
      if (ttid == 0) {
        if constexpr (kStats) {
          int32_t* row = out_stats + size_t(b) * kStatCols;
          row[0] = any_hit ? 0 : 1;
          row[1] = any_cop ? 1 : 0;
          row[2] = ctl[cPairs];
          row[3] = 1;
          row[4] = ctl[cFull];
          row[5] = ctl[cGate];
          row[6] = ctl[cRest];
          row[7] = 0;
        } else {
          out[b] = uint8_t((any_hit ? 0 : 1) | (any_cop ? 2 : 0) | (any_unc ? 4 : 0));
        }
      }
    } else {
      const bool hit = team_or(team, a.keep > 0) && rt_false;
      if (ttid == 0) out[b] = hit ? 0 : 1;
    }
  }
}

template <bool kStats, int kStage>
int resident_blocks(const Layout& L, int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, megakernel<kStats, kStage>,
                                                       kThreads, L.bytes());
}

// Checks the launch's arguments, sets the instance's shared memory, zeroes
// the row counter `work` (one int32 on the device) and launches the instance
// on `stream` with as many blocks as stay resident (at most one team per
// row); returns the cudaError_t (0 = launched).
template <bool kStats, int kStage>
int launch(const float* poses, int64_t n, const float* rob_base, int tr,
           const float* obs, int to, const float* obs_mesh, const float* obs_groups,
           int n_groups, void* out, int* work, int64_t* nonfinite, int rt_false,
           cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (n > (int64_t(1) << 30) || tr <= 0 || tr % kRobTile != 0 || tr >= 65536 ||
      n_groups <= 0 || to != n_groups * kGroup || to >= 65536)
    return cudaErrorInvalidValue;
  const Layout L(tr, to, n_groups);
  cudaError_t err = cudaFuncSetAttribute(megakernel<kStats, kStage>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(L.bytes()));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaError_t(resident_blocks<kStats, kStage>(L, &per_sm))) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaMemsetAsync(work, 0, sizeof(int), stream)) != cudaSuccess) return err;
  const int64_t want = (n + kRows - 1) / kRows;
  const int grid = int(want < int64_t(per_sm) * sms ? want : int64_t(per_sm) * sms);
  megakernel<kStats, kStage><<<grid, kThreads, L.bytes(), stream>>>(
      poses, int(n), rob_base, tr, obs, to, obs_mesh, obs_groups, n_groups, out, work,
      nonfinite, rt_false);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for a robot table of `tr` rows and
// `n_groups` obstacle groups.
int64_t rc_megakernel_smem_bytes(int tr, int n_groups) {
  return int64_t(Layout(tr, n_groups * kGroup, n_groups).bytes());
}

// Blocks of the packed instance resident on one SM for these tables (0 if
// none fits), or a negative cudaError_t.
int rc_megakernel_blocks_per_sm(int tr, int n_groups) {
  const Layout L(tr, n_groups * kGroup, n_groups);
  cudaError_t err = cudaFuncSetAttribute(megakernel<false, kFull>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(L.bytes()));
  if (err != cudaSuccess) return -int(err);
  int per_sm = 0;
  err = cudaError_t(resident_blocks<false, kFull>(L, &per_sm));
  return err != cudaSuccess ? -int(err) : per_sm;
}

// The current device's opt-in dynamic shared memory per block
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), or a negative cudaError_t.
int rc_smem_optin_bytes() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err != cudaSuccess ? -int(err) : bytes;
}

const char* rc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Whether the entries below take the non-finite row counter after `work`
// (copies of this file built from older revisions do not export this).
int rc_megakernel_counts_nonfinite() { return 1; }

// Checks n pose rows (poses [n,16] f32) against the tables; writes out[n]
// uint8 on `stream`. rob_base [10,tr], obs [to,20], obs_mesh [6],
// obs_groups [to/128,6], all f32, contiguous, on the current device; work:
// one int32 of scratch on that device (the row counter, zeroed here);
// nonfinite: null or one int64 on that device, raised by 1 for each row with
// a non-finite pose float (which gets the byte 0).
// Returns the launch's cudaError_t (0 = launched); does not synchronise.
int rc_megakernel_check(const float* poses, int64_t n, const float* rob_base,
                        int tr, const float* obs, int to, const float* obs_mesh,
                        const float* obs_groups, int n_groups, uint8_t* out, int* work,
                        int64_t* nonfinite, cudaStream_t stream) {
  return launch<false, kFull>(poses, n, rob_base, tr, obs, to, obs_mesh, obs_groups,
                              n_groups, out, work, nonfinite, 0, stream);
}

// As rc_megakernel_check, with the counter row: out[n, 8] int32 (columns in
// the header comment; all zero on a non-finite row).
int rc_megakernel_check_stats(const float* poses, int64_t n, const float* rob_base,
                              int tr, const float* obs, int to, const float* obs_mesh,
                              const float* obs_groups, int n_groups, int32_t* out,
                              int* work, int64_t* nonfinite, cudaStream_t stream) {
  return launch<true, kFull>(poses, n, rob_base, tr, obs, to, obs_mesh, obs_groups,
                             n_groups, out, work, nonfinite, 0, stream);
}

// A stage-isolating variant (stage 1 = no sweep, 2 = box tests only, 3 = box
// tests and planes, 4 = the full sweep with multiplies for divides), packed
// output; rt_false must be 0.
int rc_megakernel_check_stage(const float* poses, int64_t n, const float* rob_base,
                              int tr, const float* obs, int to, const float* obs_mesh,
                              const float* obs_groups, int n_groups, uint8_t* out,
                              int* work, int64_t* nonfinite, int stage, int rt_false,
                              cudaStream_t stream) {
  switch (stage) {
    case kNoSweep:
      return launch<false, kNoSweep>(poses, n, rob_base, tr, obs, to, obs_mesh, obs_groups,
                                     n_groups, out, work, nonfinite, rt_false, stream);
    case kMaskOnly:
      return launch<false, kMaskOnly>(poses, n, rob_base, tr, obs, to, obs_mesh, obs_groups,
                                      n_groups, out, work, nonfinite, rt_false, stream);
    case kPlanesOnly:
      return launch<false, kPlanesOnly>(poses, n, rob_base, tr, obs, to, obs_mesh, obs_groups,
                                        n_groups, out, work, nonfinite, rt_false, stream);
    case kNoDiv:
      return launch<false, kNoDiv>(poses, n, rob_base, tr, obs, to, obs_mesh, obs_groups,
                                   n_groups, out, work, nonfinite, rt_false, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
