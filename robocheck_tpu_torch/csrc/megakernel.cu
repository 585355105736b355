// Fused collision check for a batch of robot poses against one obstacle mesh.
//
// Replaces the Pallas TPU kernel `_kernel` + `_one_config` of
// robocheck_tpu/kernels/megakernel.py (launched by `_mega_call`). It computes
// what that kernel computes, in the same float32 operation order, and writes
// one byte per configuration: bit 0 = valid (no intersecting triangle pair),
// bit 1 = some live pair was flagged coplanar. Its plain PyTorch twin is
// `check_poses_reference` in robocheck_tpu_torch/kernels/megakernel.py.
//
// What bounds it on an H100: each configuration is a short chain of
// dependent stages (pose -> mesh box -> gate -> gated pair sweep with an
// any-hit exit), and the pair tests branch on data. It moves almost no bytes:
// 64 B of pose in, 1 B out, and the mesh tables (~40 KB robot, ~80 KB
// obstacle for the alpha-1.0 pair) stay in L2 and L1 for the whole launch.
// It is latency- and issue-bound per configuration, not bandwidth-bound.
//
// What the design does about it:
//   * one thread block (256 threads) per configuration, grid-stride over the
//     batch, so the 132 SMs work on independent configurations and
//     latency hides across resident blocks;
//   * the posed robot (19 fields per triangle) is built once per
//     configuration in shared memory (dynamic, 19 x 4 x Tr bytes: 77,824 for
//     the 1024-row alpha table), with each warp's 32 triangles forming one
//     robot tile whose box is reduced with shuffles on the way;
//   * the mesh-box broad phase ends a miss after the pose stage;
//   * the gate keeps only (robot tile x obstacle group) pairs whose boxes
//     overlap (a necessary condition for any pair-box overlap), compacted in
//     order into a work list;
//   * each warp takes one gated tile pair at a time (lane = robot triangle,
//     loop over the group's 128 obstacle triangles, read as broadcast float4
//     loads), and the block takes the any-hit exit between rounds of tiles
//     with __syncthreads_or.
//
// Instances (`template <bool kStats, int kStage>`):
//   * <false, kFull>: the packed byte above, the checker's main path;
//   * <true, kFull>: the counter row of the JAX kernel's stats output
//     (`megakernel.py:1116-1120`), int32 [n, 8]: 0 valid, 1 coplanar,
//     2 num_pairs, 3 broad, 4 nfull, 5 ngate, 6 nrest, 7 zero. Columns 4-6
//     count THIS kernel's tile pairs (32 robot x 128 obstacle triangles),
//     not the JAX kernel's 128 x 128 tiles: nfull = gated tile pairs with at
//     least one box-overlapping pair (real robot triangle), ngate = gated
//     tile pairs with none, nrest = tile pairs with at least one live pair
//     (both planes straddle the +-TOL band). Counts cover the tile pairs
//     visited before the any-hit exit, as the JAX kernel's do; warp sums
//     are taken with __reduce_add_sync, so they are deterministic;
//   * <false, kNoSweep / kMaskOnly / kPlanesOnly>: the stage-isolating
//     variants of the JAX kernel's `sweep=False` and `stage_cap` 0 / 1
//     (`megakernel.py:625-643, 761-774`), which `scripts/torch_roofline.py`
//     times. Each keeps its stage's work live with `hit |= any && rt_false`
//     (rt_false is a kernel argument, always 0), so it never sets hit or
//     coplanar and writes the byte 1 on every row. Table values are never
//     multiplied by that zero: the obstacle padding rows hold +-inf.
// `if constexpr` keeps the counter and variant code out of the packed
// instance.
//
// Arithmetic: build with -fmad=false and without fast math. The TOL=1e-6
// bands and the >= interval tests were validated on arithmetic that rounds
// each multiply and each add on its own; IEEE division and denormals stay at
// nvcc's defaults.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRobTile = 32;   // robot triangles per tile: one per lane
constexpr int kGroup = 128;    // obstacle triangles per group box
constexpr int kObsCols = 20;   // obstacle row: corners 0-8, n 9-11, d 12,
                               // box lo 13-15, box hi 16-18, zero 19
constexpr int kRobFields = 19; // posed corners 0-8, n 9-11, d 12, lo 13-15, hi 16-18
constexpr int kF_N = 9, kF_D = 12, kF_LO = 13, kF_HI = 16;
constexpr float kTol = 1e-6f;
constexpr float kBig = 3.0e38f;  // fill of masked robot boxes
constexpr int kStatCols = 8;     // columns of the stats instance's output row

enum Stage : int { kFull = 0, kNoSweep = 1, kMaskOnly = 2, kPlanesOnly = 3 };

// NaN-propagating min / max, as torch.minimum / jnp.minimum.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = min_nan(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// Some corner at or above +TOL and some at or below -TOL.
__device__ __forceinline__ bool straddles(float d0, float d1, float d2) {
  return (d0 >= kTol || d1 >= kTol || d2 >= kTol) &&
         (d0 <= -kTol || d1 <= -kTol || d2 <= -kTol);
}

__device__ __forceinline__ float endpoint(float pa, float pb, float da, float db) {
  float dd = da - db;
  if (dd == 0.f) dd = 1.f;
  return pa + (pb - pa) * (da / dd);
}

// Canonical permutation and interval ends on the intersection line.
__device__ __forceinline__ void interval(float p0, float p1, float p2, float d0,
                                         float d1, float d2, float& lo, float& hi) {
  const bool c01 = (d0 > 0.f && d1 > 0.f) || (d0 < 0.f && d1 < 0.f);
  const bool c02 = (d0 > 0.f && d2 > 0.f) || (d0 < 0.f && d2 < 0.f);
  const float q0 = c01 ? p0 : (c02 ? p0 : p1);
  const float q1 = c01 ? p2 : (c02 ? p1 : p0);
  const float q2 = c01 ? p1 : p2;
  const float e0 = c01 ? d0 : (c02 ? d0 : d1);
  const float e1 = c01 ? d2 : (c02 ? d1 : d0);
  const float e2 = c01 ? d1 : d2;
  const float t01 = endpoint(q0, q1, e0, e1);
  const float t12 = endpoint(q1, q2, e1, e2);
  lo = min_nan(t01, t12);
  hi = max_nan(t01, t12);
}

__device__ __forceinline__ bool isclose(float v1, float v2) {
  const float a1 = fabsf(v1), a2 = fabsf(v2);
  const bool both = a1 < kTol && a2 < kTol;
  const bool one = a1 < kTol || a2 < kTol;
  const bool rel = fabsf((v1 - v2) / (a1 < kTol ? 1.f : v1)) < kTol;
  return both || (!one && rel);
}

// Exact component-ratio coplanarity test of planes (nr, dr) and (no, do).
__device__ __forceinline__ bool ratio_coplanar(const float r[4], const float o[4]) {
  bool mismatch = false, valid[4];
  float ratio[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool zr = fabsf(r[k]) < kTol, zo = fabsf(o[k]) < kTol;
    mismatch |= zr != zo;
    valid[k] = !zr && !zo;
    ratio[k] = r[k] / (valid[k] ? o[k] : 1.f);
  }
  const float ratio0 = valid[0] ? ratio[0]
                     : valid[1] ? ratio[1]
                     : valid[2] ? ratio[2] : ratio[3];
  bool ok = !mismatch;
#pragma unroll
  for (int k = 0; k < 4; ++k) ok = ok && (!valid[k] || isclose(ratio0, ratio[k]));
  return ok;
}

// Plane stage of one pair: the signed corner distances to the other plane.
__device__ __forceinline__ void plane_dists(const float rf[kRobFields], const float oc[9],
                                            const float4 a2, const float4 a3,
                                            float dist_o[3], float dist_r[3]) {
  const float nox = a2.y, noy = a2.z, noz = a2.w, dob = a3.x;
  const float nrx = rf[kF_N], nry = rf[kF_N + 1], nrz = rf[kF_N + 2], drb = rf[kF_D];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dist_o[c] = nrx * oc[3 * c] + nry * oc[3 * c + 1] + nrz * oc[3 * c + 2] + drb;
    dist_r[c] = nox * rf[3 * c] + noy * rf[3 * c + 1] + noz * rf[3 * c + 2] + dob;
  }
}

// Plane stage, interval stage and coplanar flag of one box-overlapping pair.
// Returns whether the pair is live (both planes straddled).
__device__ __forceinline__ bool pair_test(const float rf[kRobFields], const float4 a0,
                                          const float4 a1, const float4 a2,
                                          const float4 a3, bool& hit, bool& cop) {
  const float oc[9] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x};
  const float nox = a2.y, noy = a2.z, noz = a2.w, dob = a3.x;
  const float nrx = rf[kF_N], nry = rf[kF_N + 1], nrz = rf[kF_N + 2], drb = rf[kF_D];

  float dist_o[3], dist_r[3];
  plane_dists(rf, oc, a2, a3, dist_o, dist_r);
  if (!straddles(dist_o[0], dist_o[1], dist_o[2]) ||
      !straddles(dist_r[0], dist_r[1], dist_r[2]))
    return false;

  const float Dx = nry * noz - nrz * noy;
  const float Dy = nrz * nox - nrx * noz;
  const float Dz = nrx * noy - nry * nox;
  float pr[3], po[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pr[c] = Dx * rf[3 * c] + Dy * rf[3 * c + 1] + Dz * rf[3 * c + 2];
    po[c] = Dx * oc[3 * c] + Dy * oc[3 * c + 1] + Dz * oc[3 * c + 2];
  }
  float min_r, max_r, min_o, max_o;
  interval(pr[0], pr[1], pr[2], dist_r[0], dist_r[1], dist_r[2], min_r, max_r);
  interval(po[0], po[1], po[2], dist_o[0], dist_o[1], dist_o[2], min_o, max_o);
  const bool isect = !(min_r >= max_o || min_o >= max_r);

  const float pl_r[4] = {nrx, nry, nrz, drb};
  const float pl_o[4] = {nox, noy, noz, dob};
  const bool coplanar = ratio_coplanar(pl_r, pl_o);
  hit = hit || (isect && !coplanar);
  cop = cop || coplanar;
  return true;
}

// Plane stage only (the kPlanesOnly variant): whether the pair is live.
__device__ __forceinline__ bool pair_live(const float rf[kRobFields], const float4 a0,
                                          const float4 a1, const float4 a2,
                                          const float4 a3) {
  const float oc[9] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x};
  float dist_o[3], dist_r[3];
  plane_dists(rf, oc, a2, a3, dist_o, dist_r);
  return straddles(dist_o[0], dist_o[1], dist_o[2]) &&
         straddles(dist_r[0], dist_r[1], dist_r[2]);
}

__host__ __device__ constexpr size_t smem_floats(int tr) {
  // posed robot fields, tile boxes, per-warp reduction, mesh box, pose
  return size_t(kRobFields) * tr + size_t(tr / kRobTile) * 6 + kWarps * 6 + 8 + 16;
}

__host__ __device__ constexpr size_t smem_bytes(int tr, int n_groups) {
  return 4 * (smem_floats(tr) + size_t(tr / kRobTile) * n_groups + kWarps);
}

// `out` is uint8 [n] (packed instances) or int32 [n, kStatCols] (kStats).
template <bool kStats, int kStage>
__global__ void __launch_bounds__(kThreads)
megakernel(const float* __restrict__ poses, int64_t n_confs,
           const float* __restrict__ rob_base, int tr,
           const float* __restrict__ obs,
           const float* __restrict__ obs_mesh,
           const float* __restrict__ obs_groups, int n_groups,
           void* __restrict__ out_ptr, int rt_false) {
  static_assert(!kStats || kStage == kFull, "counters come with the full sweep only");
  extern __shared__ float smem[];
  uint8_t* out = static_cast<uint8_t*>(out_ptr);
  int32_t* out_stats = static_cast<int32_t*>(out_ptr);
  const int n_tiles = tr / kRobTile;
  float* rob = smem;                              // [kRobFields][tr]
  float* tile_box = rob + size_t(kRobFields) * tr;  // [n_tiles][6]
  float* red = tile_box + n_tiles * 6;            // [kWarps][6]
  float* mesh = red + kWarps * 6;                 // [6] (+2 pad)
  float* pose = mesh + 8;                         // [12] (+4 pad)
  int* items = reinterpret_cast<int*>(smem + smem_floats(tr));  // [n_tiles * n_groups]
  int* wcount = items + n_tiles * n_groups;       // [kWarps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* rob_real = rob_base + 9 * tr;
  const float4* obs4 = reinterpret_cast<const float4*>(obs);

  for (int64_t b = blockIdx.x; b < n_confs; b += gridDim.x) {
    __syncthreads();  // the previous configuration's readers are done
    if (tid < 12) pose[tid] = poses[b * 16 + tid];
    __syncthreads();
    float p[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) p[k] = pose[k];

    // ---- Pose the corners; planes, boxes, tile boxes, mesh box. ----
    float m_lo[3] = {kBig, kBig, kBig}, m_hi[3] = {-kBig, -kBig, -kBig};
    for (int r = tid; r < tr; r += kThreads) {  // tr % 32 == 0: whole warps
      float c[9];
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const float X = rob_base[(3 * cc) * tr + r];
        const float Y = rob_base[(3 * cc + 1) * tr + r];
        const float Z = rob_base[(3 * cc + 2) * tr + r];
        c[3 * cc + 0] = p[0] * X + p[1] * Y + p[2] * Z + p[3];
        c[3 * cc + 1] = p[4] * X + p[5] * Y + p[6] * Z + p[7];
        c[3 * cc + 2] = p[8] * X + p[9] * Y + p[10] * Z + p[11];
      }
      const float e1x = c[3] - c[0], e1y = c[4] - c[1], e1z = c[5] - c[2];
      const float e2x = c[6] - c[3], e2y = c[7] - c[4], e2z = c[8] - c[5];
      const float nx = e1y * e2z - e1z * e2y;
      const float ny = e1z * e2x - e1x * e2z;
      const float nz = e1x * e2y - e1y * e2x;
      const float d = -(nx * c[0] + ny * c[1] + nz * c[2]);
#pragma unroll
      for (int f = 0; f < 9; ++f) rob[f * tr + r] = c[f];
      rob[kF_N * tr + r] = nx;
      rob[(kF_N + 1) * tr + r] = ny;
      rob[(kF_N + 2) * tr + r] = nz;
      rob[kF_D * tr + r] = d;
      const bool real = rob_real[r] > 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float lo = min_nan(min_nan(c[k], c[3 + k]), c[6 + k]);
        const float hi = max_nan(max_nan(c[k], c[3 + k]), c[6 + k]);
        rob[(kF_LO + k) * tr + r] = lo;
        rob[(kF_HI + k) * tr + r] = hi;
        const float tlo = warp_min(real ? lo : kBig);
        const float thi = warp_max(real ? hi : -kBig);
        m_lo[k] = min_nan(m_lo[k], tlo);
        m_hi[k] = max_nan(m_hi[k], thi);
        if (lane == 0) {
          tile_box[(r / kRobTile) * 6 + k] = tlo;
          tile_box[(r / kRobTile) * 6 + 3 + k] = thi;
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        red[warp * 6 + k] = m_lo[k];
        red[warp * 6 + 3 + k] = m_hi[k];
      }
    }
    __syncthreads();
    if (tid < 6) {
      float v = red[tid];
      for (int w = 1; w < kWarps; ++w)
        v = tid < 3 ? min_nan(v, red[w * 6 + tid]) : max_nan(v, red[w * 6 + tid]);
      mesh[tid] = v;
    }
    __syncthreads();

    // ---- Mesh-box broad phase (closed intervals). ----
    bool broad = true;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      broad = broad && mesh[k] <= obs_mesh[3 + k] && obs_mesh[k] <= mesh[3 + k];
    if (!broad) {
      if (tid == 0) {
        if constexpr (kStats) {
#pragma unroll
          for (int c = 0; c < kStatCols; ++c) out_stats[b * kStatCols + c] = c == 0;
        } else {
          out[b] = 1;
        }
      }
      continue;
    }

    // ---- Gate: robot tile box x obstacle group box, compacted in order. ----
    const int total = n_tiles * n_groups;
    int n_items = 0;
    for (int q0 = 0; q0 < total; q0 += kThreads) {
      const int q = q0 + tid;
      bool pass = false;
      if (q < total) {
        const int i = q / n_groups, j = q - i * n_groups;
        const float* tb = tile_box + i * 6;
        const float* gb = obs_groups + j * 6;
        pass = tb[0] <= gb[3] && gb[0] <= tb[3] && tb[1] <= gb[4] &&
               gb[1] <= tb[4] && tb[2] <= gb[5] && gb[2] <= tb[5];
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, pass);
      if (lane == 0) wcount[warp] = __popc(ballot);
      __syncthreads();
      int off = n_items, round_total = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int cnt = wcount[w];
        if (w < warp) off += cnt;
        round_total += cnt;
      }
      if (pass) items[off + __popc(ballot & ((1u << lane) - 1u))] = q;
      n_items += round_total;
      __syncthreads();
    }

    if constexpr (kStage == kNoSweep) {
      // Stage 1 and the epilogue only; the gate's work list stays live.
      const bool hit = n_items > 0 && rt_false;
      if (tid == 0) out[b] = hit ? 0 : 1;
      continue;
    }

    // ---- Gated pair sweep: one tile pair per warp, any-hit exit. ----
    bool hit = false, cop = false;
    int any_hit = 0;
    // Per-warp counters of the tile pairs this warp visited (kStats only):
    // box-overlapping pairs, tile pairs with some / no such pair, tile
    // pairs with some live pair. Warp-uniform after __reduce_add_sync.
    int w_pairs = 0, w_full = 0, w_gate = 0, w_rest = 0;
    for (int base = 0; base < n_items; base += kWarps) {
      const int k = base + warp;
      if (k < n_items) {
        const int q = items[k];
        const int i = q / n_groups, j = q - i * n_groups;
        const int r = i * kRobTile + lane;
        const bool real = rob_real[r] > 0.f;
        float rf[kRobFields];
#pragma unroll
        for (int f = 0; f < kRobFields; ++f) rf[f] = rob[f * tr + r];
        const float4* grp = obs4 + size_t(j) * kGroup * (kObsCols / 4);
        // Box-overlapping pairs of this lane (kStats, kMaskOnly), or its live
        // pairs (kPlanesOnly: a count, so the plane stage runs on every
        // box-overlapping pair, as in the full kernel, and is never skipped
        // once one pair is live).
        int n_pairs = 0;
        bool live = false;  // some live pair on this lane (kStats)
        for (int o = 0; o < kGroup && real; ++o) {
          const float4* row = grp + o * (kObsCols / 4);
          const float4 a3 = __ldg(row + 3);  // d, lo x, lo y, lo z
          const float4 a4 = __ldg(row + 4);  // hi x, hi y, hi z, 0
          const bool overlap =
              rf[kF_LO] <= a4.x && a3.y <= rf[kF_HI] &&
              rf[kF_LO + 1] <= a4.y && a3.z <= rf[kF_HI + 1] &&
              rf[kF_LO + 2] <= a4.z && a3.w <= rf[kF_HI + 2];
          if constexpr (kStage == kMaskOnly) {
            n_pairs += overlap;
            continue;
          }
          if (!overlap) continue;
          if constexpr (kStage == kPlanesOnly) {
            n_pairs += pair_live(rf, __ldg(row), __ldg(row + 1), __ldg(row + 2), a3);
            continue;
          }
          const bool pair_is_live =
              pair_test(rf, __ldg(row), __ldg(row + 1), __ldg(row + 2), a3, hit, cop);
          if constexpr (kStats) {
            ++n_pairs;
            live = live || pair_is_live;
          }
        }
        if constexpr (kStage == kMaskOnly || kStage == kPlanesOnly)
          hit = hit || (n_pairs > 0 && rt_false);
        if constexpr (kStats) {
          const int t_pairs = int(__reduce_add_sync(0xffffffffu, unsigned(n_pairs)));
          w_pairs += t_pairs;
          w_full += t_pairs > 0;
          w_gate += t_pairs == 0;
          w_rest += __any_sync(0xffffffffu, live);
        }
      }
      any_hit = __syncthreads_or(hit);
      if (any_hit) break;
    }
    if constexpr (kStats) {
      // `red` is free after the mesh box; __syncthreads_or below orders
      // these writes before thread 0 reads them.
      int* w_stats = reinterpret_cast<int*>(red);  // [kWarps][4]
      if (lane == 0) {
        w_stats[warp * 4 + 0] = w_pairs;
        w_stats[warp * 4 + 1] = w_full;
        w_stats[warp * 4 + 2] = w_gate;
        w_stats[warp * 4 + 3] = w_rest;
      }
    }
    const int any_cop = __syncthreads_or(cop);
    if (tid == 0) {
      if constexpr (kStats) {
        int sums[4] = {0, 0, 0, 0};
        const int* w_stats = reinterpret_cast<const int*>(red);
        for (int w = 0; w < kWarps; ++w)
#pragma unroll
          for (int c = 0; c < 4; ++c) sums[c] += w_stats[w * 4 + c];
        int32_t* row = out_stats + b * kStatCols;
        row[0] = any_hit ? 0 : 1;
        row[1] = any_cop ? 1 : 0;
        row[2] = sums[0];
        row[3] = 1;
        row[4] = sums[1];
        row[5] = sums[2];
        row[6] = sums[3];
        row[7] = 0;
      } else {
        out[b] = uint8_t((any_hit ? 0 : 1) | (any_cop ? 2 : 0));
      }
    }
  }
}

// Checks the launch's arguments, sets the instance's shared memory and
// launches it on `stream`; returns the cudaError_t (0 = launched).
template <bool kStats, int kStage>
int launch(const float* poses, int64_t n, const float* rob_base, int tr,
           const float* obs, int to, const float* obs_mesh, const float* obs_groups,
           int n_groups, void* out, int rt_false, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (tr <= 0 || tr % kRobTile != 0 || to != n_groups * kGroup)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(tr, n_groups);
  cudaError_t err = cudaFuncSetAttribute(megakernel<kStats, kStage>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const int grid = int(n < 65535 ? n : 65535);
  megakernel<kStats, kStage><<<grid, kThreads, smem, stream>>>(
      poses, n, rob_base, tr, obs, obs_mesh, obs_groups, n_groups, out, rt_false);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for a robot table of `tr` rows.
int64_t rc_megakernel_smem_bytes(int tr, int n_groups) {
  return int64_t(smem_bytes(tr, n_groups));
}

const char* rc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Checks n pose rows (poses [n,16] f32) against the tables; writes out[n]
// uint8 on `stream`. rob_base [10,tr], obs [to,20], obs_mesh [6],
// obs_groups [to/128,6], all f32, contiguous, on the current device.
// Returns the launch's cudaError_t (0 = launched); does not synchronise.
int rc_megakernel_check(const float* poses, int64_t n, const float* rob_base,
                        int tr, const float* obs, int to, const float* obs_mesh,
                        const float* obs_groups, int n_groups, uint8_t* out,
                        cudaStream_t stream) {
  return launch<false, kFull>(poses, n, rob_base, tr, obs, to, obs_mesh, obs_groups,
                              n_groups, out, 0, stream);
}

// As rc_megakernel_check, with the counter row: out[n, 8] int32 (columns in
// the header comment).
int rc_megakernel_check_stats(const float* poses, int64_t n, const float* rob_base,
                              int tr, const float* obs, int to, const float* obs_mesh,
                              const float* obs_groups, int n_groups, int32_t* out,
                              cudaStream_t stream) {
  return launch<true, kFull>(poses, n, rob_base, tr, obs, to, obs_mesh, obs_groups,
                             n_groups, out, 0, stream);
}

// A stage-isolating variant (stage 1 = no sweep, 2 = box test only, 3 = box
// test and planes), packed output; rt_false must be 0.
int rc_megakernel_check_stage(const float* poses, int64_t n, const float* rob_base,
                              int tr, const float* obs, int to, const float* obs_mesh,
                              const float* obs_groups, int n_groups, uint8_t* out,
                              int stage, int rt_false, cudaStream_t stream) {
  switch (stage) {
    case kNoSweep:
      return launch<false, kNoSweep>(poses, n, rob_base, tr, obs, to, obs_mesh,
                                     obs_groups, n_groups, out, rt_false, stream);
    case kMaskOnly:
      return launch<false, kMaskOnly>(poses, n, rob_base, tr, obs, to, obs_mesh,
                                      obs_groups, n_groups, out, rt_false, stream);
    case kPlanesOnly:
      return launch<false, kPlanesOnly>(poses, n, rob_base, tr, obs, to, obs_mesh,
                                        obs_groups, n_groups, out, rt_false, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
