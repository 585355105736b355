// The clearance engine's exact scan on the card: for each (configuration,
// vertex block) pair i,
//
//     out[i] = sqrt(min over the block's vertices v and every obstacle
//                   triangle T of d2(R_i v + t_i, T)),
//
// d2 the squared point-to-triangle distance by Ericson's region
// classification (Real-Time Collision Detection 5.1.5), in the operation
// order of the PyTorch twin `kernels/clearance.point_tri_d2`.
//
// Replaces the XLA scan of `robocheck_tpu/planner/clearance.py`:
// `TpuClearanceEngine._exact_fn` (lines 312-354: 1,024 posed vertices x all
// obstacle triangles per pair, the sqrt after the min) and, with one vertex
// per block, the representative-vertex scan of `_bounds_fn` (279-288).
//
// Inputs, all on one device, row-major, float32 unless said:
//   rows   [k, 12]   R (row-major, from `ops/transform.rotation_matrices`) and t
//   ids    [k] int32 block of each pair; an id outside [0, nb) gives NaN
//   blocks [nb, block, 3] body-frame vertices (a short last block is padded
//                     with copies of a real vertex by the caller)
//   tab    [nt, 18]  obstacle triangles: corners a, b, c, then the edges
//                     b - a, c - a, c - b (`kernels/clearance.tri_table`, the
//                     twin's float32 differences); no padding
//   out    [k]
// and, for the culled instance (`gbox` not null):
//   gbox   [ng, 6]   conservative boxes (lo xyz, hi xyz) of the triangle
//                     groups [g * gsize, (g + 1) * gsize)
//   always [ng] uint8 groups that are scanned whatever their box says (a
//                     thin or non-finite triangle can give NaN)
//   slack  the engine's 2 x err_bound
//   visits [k] int32 or null: each pair's count of (vertex unit, group)
//                     scans is added to it
//   kept   one int64 or null: the launch's count of (pair, vertex unit,
//                     group) scans is added to it (`finish_kernel`)
//   tasks  room for k x units x ng int2, and `scratch`: work space
//
// Bound: operations. A 1,024-pair dispatch of the alpha-1.0 scene is ~1.06e9
// vertex-triangle distances of 21 to 79 operations (`profiling/bounds.py`),
// 91% of them ending in a vertex region: most obstacle groups are far from
// most of a block. The culled instance does less of that work instead of
// doing it faster:
//
//   * Exact culling inside a pair. The block's vertices are cut into units
//     of `unit = s * kVpt` Morton-contiguous vertices, one unit per team (the
//     pair's lanes inside one warp, s = min(lanes, 32)); each team builds the
//     box of its own posed vertices with shuffles (no inflation: the
//     distances are taken from the same floats). Pass 1: g0, the group
//     nearest the pair's box (ties to the lowest index), is scanned by every
//     vertex, and m0 is the pair's squared minimum over it. Pass 2: each unit
//     scans every other group that is `always` or whose box distance to the
//     unit's box is not above sqrt(m0) + slack (a NaN means scan). A skipped
//     triangle's distance exceeds sqrt(m0) by more than the rounding that
//     `err_bound` covers, so the min, an exact operation, is the full
//     scan's, bit for bit. The rule reads the inputs only, so
//     `kernels/clearance.cull_plan` reproduces every (pair, unit, group)
//     scan on the host.
//   * Pass 2 spread over the whole card. A pair near the obstacle keeps most
//     of its 8 x 32 (unit, group) scans, a far one a few: run by the pair's
//     own block, the near pairs alone would set a dispatch's time. So the
//     culled instance is three launches: `plan_kernel` (a block per pair:
//     box, g0, pass 1, the cull tests) appends each kept (pair, unit, group)
//     scan to a task list; `task_kernel` (persistent, a warp per task from a
//     counter) runs them, meeting in each pair's minimum by an atomic min on
//     the float's bits (exact for non-negative floats; a NaN sets the pair's
//     flag); `finish_kernel` takes the sqrt.
//   * The obstacle table staged once per resident block of `task_kernel` and
//     of the nocull instance (which scans every triangle per pair): a
//     persistent grid copies it into dynamic shared memory with cp.async
//     before its first item. Where it would leave fewer than two resident
//     blocks per SM (above ~1,600 triangles) it is read through the L2
//     (__ldg) instead.
//   * Lazy arithmetic: d1 and d2 decide vertex a before bp, d3 and d4 are
//     formed, and so on in the twin's priority (a, b, c, ab, ac, bc, face).
//     A warp's vertices are Morton neighbours, so its lanes mostly end in
//     the same region of a far triangle and the early returns seldom
//     diverge.
//
// A pair takes `lanes` threads of a block (a power of two, up to kThreads,
// kVpt vertices each), so a 1,024-vertex block fills a thread block (eight
// units of 128) and 1-vertex blocks (the representatives) run kThreads
// pairs a block, each thread its own team.
//
// Arithmetic: built with -fmad=false and no fast math, so every multiply
// and add rounds on its own, divides and the sqrt are IEEE, as in the twin.
// A NaN distance wins the min and stays (torch.minimum's rule), so a
// degenerate triangle can only make a pair's answer NaN, never drop it.
//
// The file also holds K4, the gradient planners' distance grid
// (`grid_kernel`, `rc_sdf_grid`), which shares `point_tri_d2` and `min_nan`
// with the scan: one device function, held bit for bit by both kernels'
// twins.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kVpt = 4;        // vertices a thread holds at once
constexpr int kTabFloats = 18;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float f32_nan() { return __int_as_float(0x7fc00000); }

// One row of the table, in its column order.
struct Tri {
  float ax, ay, az, bx, by, bz, cx, cy, cz;
  float abx, aby, abz, acx, acy, acz, bcx, bcy, bcz;
};

__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2) {
  return (x0 * y0 + x1 * y1) + x2 * y2;
}

// torch.minimum's rule: a NaN operand wins, and a NaN minimum stays.
__device__ __forceinline__ float min_nan(float x, float m) {
  return (x < m || x != x) ? x : m;
}

// The twin's cascade of selects, earliest first: vertex a, b, c, then edge
// ab, ac, bc, then the face; each value is formed only once the tests
// before it have failed. Where the closest point is a corner the twin's
// p - q is the same difference as ap, bp or cp.
__device__ __forceinline__ float point_tri_d2(float px, float py, float pz,
                                              const Tri& t) {
  const float apx = px - t.ax, apy = py - t.ay, apz = pz - t.az;
  const float d1 = dot3(t.abx, t.aby, t.abz, apx, apy, apz);
  const float d2 = dot3(t.acx, t.acy, t.acz, apx, apy, apz);
  if (d1 <= 0.f && d2 <= 0.f) return dot3(apx, apy, apz, apx, apy, apz);
  const float bpx = px - t.bx, bpy = py - t.by, bpz = pz - t.bz;
  const float d3 = dot3(t.abx, t.aby, t.abz, bpx, bpy, bpz);
  const float d4 = dot3(t.acx, t.acy, t.acz, bpx, bpy, bpz);
  if (d3 >= 0.f && d4 <= d3) return dot3(bpx, bpy, bpz, bpx, bpy, bpz);
  const float cpx = px - t.cx, cpy = py - t.cy, cpz = pz - t.cz;
  const float d5 = dot3(t.abx, t.aby, t.abz, cpx, cpy, cpz);
  const float d6 = dot3(t.acx, t.acy, t.acz, cpx, cpy, cpz);
  if (d6 >= 0.f && d5 <= d6) return dot3(cpx, cpy, cpz, cpx, cpy, cpz);
  float qx, qy, qz;
  const float vc = d1 * d4 - d3 * d2;
  if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) {
    const float v = d1 / (d1 - d3);
    qx = t.ax + v * t.abx; qy = t.ay + v * t.aby; qz = t.az + v * t.abz;
  } else {
    const float vb = d5 * d2 - d1 * d6;
    if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) {
      const float v = d2 / (d2 - d6);
      qx = t.ax + v * t.acx; qy = t.ay + v * t.acy; qz = t.az + v * t.acz;
    } else {
      const float va = d3 * d6 - d5 * d4;
      if (va <= 0.f && d4 - d3 >= 0.f && d5 - d6 >= 0.f) {
        const float w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
        qx = t.bx + w * t.bcx; qy = t.by + w * t.bcy; qz = t.bz + w * t.bcz;
      } else {
        const float denom = (va + vb) + vc;
        const float v = vb / denom, w = vc / denom;
        qx = (t.ax + v * t.abx) + w * t.acx;
        qy = (t.ay + v * t.aby) + w * t.acy;
        qz = (t.az + v * t.abz) + w * t.acz;
      }
    }
  }
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  return dot3(dx, dy, dz, dx, dy, dz);
}

// Row t of the table, from shared memory (kSmem) or through the read-only
// cache; rows are 72 bytes, so 8-byte loads.
template <bool kSmem>
__device__ __forceinline__ Tri load_tri(const float* tab, int t) {
  const float2* s = reinterpret_cast<const float2*>(tab + size_t(t) * kTabFloats);
  float2 v[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = kSmem ? s[i] : __ldg(s + i);
  Tri r;
  r.ax = v[0].x; r.ay = v[0].y; r.az = v[1].x; r.bx = v[1].y; r.by = v[2].x; r.bz = v[2].y;
  r.cx = v[3].x; r.cy = v[3].y; r.cz = v[4].x; r.abx = v[4].y; r.aby = v[5].x;
  r.abz = v[5].y; r.acx = v[6].x; r.acy = v[6].y; r.acz = v[7].x; r.bcx = v[7].y;
  r.bcy = v[8].x; r.bcz = v[8].y;
  return r;
}

// The distance's gap term: x where x > 0, else 0 (a NaN gives 0).
__device__ __forceinline__ float gap(float x) { return x > 0.f ? x : 0.f; }

// Squared distance between the box [lo, hi] and group box g (lo xyz, hi
// xyz), as `kernels/clearance._box_d2` computes it; never NaN.
__device__ __forceinline__ float box_d2(const float lo[3], const float hi[3],
                                        const float* g) {
  const float gx = gap(g[0] - hi[0]) + gap(lo[0] - g[3]);
  const float gy = gap(g[1] - hi[1]) + gap(lo[1] - g[4]);
  const float gz = gap(g[2] - hi[2]) + gap(lo[2] - g[5]);
  return (gx * gx + gy * gy) + gz * gz;
}

// Reductions over a team of s lanes (a power of two, aligned in the warp);
// every lane of the warp calls them.
__device__ __forceinline__ float team_min_nan(float x, int s) {
  for (int o = s / 2; o > 0; o >>= 1) x = min_nan(__shfl_xor_sync(kAll, x, o), x);
  return x;
}

__device__ __forceinline__ void team_box(float lo[3], float hi[3], int s) {
  for (int o = s / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(kAll, lo[c], o));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(kAll, hi[c], o));
    }
  }
}

struct Args {
  const float* rows;
  const int32_t* ids;
  int k;
  const float* blocks;
  int nb, block;
  const float* tab;
  int nt;
  float* out;
  int lanes;
  int items;  // work items of kThreads / lanes pairs each
  // scratch: [0] the item counter, and for the culled instance [1] the
  // tasks appended, [2] the task counter, then from [4] each pair's minimum
  // (float bits) [k] and NaN flag [k].
  int* scratch;
  // The culled instance's.
  const float* gbox;
  const uint8_t* always;
  int ng, gsize;
  float slack;
  int32_t* visits;
  int2* tasks;  // {pair, unit << 16 | group}
};

__device__ __forceinline__ unsigned* pair_min_bits(const Args& a) {
  return reinterpret_cast<unsigned*>(a.scratch + 4);
}
__device__ __forceinline__ int* pair_nan(const Args& a) { return a.scratch + 4 + a.k; }

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Copy the table (nt rows of 72 bytes, 16-byte aligned) into shared `dst`
// with cp.async and wait for this thread's copies; the caller's
// __syncthreads publishes them.
__device__ __forceinline__ void stage_table(float* dst, const float* src, int nt, int tid) {
  char* d = reinterpret_cast<char*>(dst);
  const char* s = reinterpret_cast<const char*>(src);
  const size_t bytes = size_t(nt) * 72, n16 = bytes / 16;
  for (size_t i = tid; i < n16; i += kThreads) cp_async16(d + 16 * i, s + 16 * i);
  for (size_t i = 4 * n16 + tid; i < bytes / 4; i += kThreads) cp_async4(d + 4 * i, s + 4 * i);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// R v + t in the twin's order.
__device__ __forceinline__ void pose(const float r[12], const float* v, float& x, float& y,
                                     float& z) {
  const float vx = v[0], vy = v[1], vz = v[2];
  x = ((r[0] * vx + r[1] * vy) + r[2] * vz) + r[9];
  y = ((r[3] * vx + r[4] * vy) + r[5] * vz) + r[10];
  z = ((r[6] * vx + r[7] * vy) + r[8] * vz) + r[11];
}

// This thread's kVpt posed vertices of the run starting at vertex u0, the
// thread being lane tl of s: vertices u0 + j * s + tl below `end`; `on`
// where a vertex is posed.
__device__ __forceinline__ void pose_run(const float r[12], const float* verts, int u0, int s,
                                         int tl, int end, bool live, float px[kVpt],
                                         float py[kVpt], float pz[kVpt], bool on[kVpt]) {
#pragma unroll
  for (int j = 0; j < kVpt; ++j) {
    const int v = u0 + j * s + tl;
    on[j] = live && v < end;
    px[j] = py[j] = pz[j] = 0.f;
    if (on[j]) pose(r, verts + 3 * v, px[j], py[j], pz[j]);
  }
}

// The running minimum `m` over this thread's vertices and triangles [t0, t1).
template <bool kSmem>
__device__ __forceinline__ void scan(const float* tab, int t0, int t1, const float px[kVpt],
                                     const float py[kVpt], const float pz[kVpt],
                                     const bool on[kVpt], float& m) {
  for (int t = t0; t < t1; ++t) {
    const Tri T = load_tri<kSmem>(tab, t);
#pragma unroll
    for (int j = 0; j < kVpt; ++j)
      if (on[j]) m = min_nan(point_tri_d2(px[j], py[j], pz[j], T), m);
  }
}

// The pair that this thread serves in work item `item`, its pose row and
// vertices: whether it is a pair of the launch (`active`) with a block
// (`live`).
struct Pair {
  int index;
  bool active, live;
  float r[12];
  const float* verts;
};

__device__ __forceinline__ Pair load_pair(const Args& a, int item, int tid) {
  Pair p;
  p.index = item * (kThreads / a.lanes) + tid / a.lanes;
  p.active = p.index < a.k;
  bool bad = true;
  int64_t base = 0;
#pragma unroll
  for (int j = 0; j < 12; ++j) p.r[j] = 0.f;
  if (p.active) {
#pragma unroll
    for (int j = 0; j < 12; ++j) p.r[j] = __ldg(a.rows + int64_t(p.index) * 12 + j);
    const int32_t b = __ldg(a.ids + p.index);
    bad = b < 0 || b >= a.nb;
    base = bad ? 0 : int64_t(b) * a.block * 3;
  }
  p.live = p.active && !bad;
  p.verts = a.blocks + base;
  return p;
}

// The next work item of the block from the launch's counter, double-buffered
// in `slot` so that a fast thread 0 cannot overwrite the item a slow thread
// has yet to read. Every thread of the block calls it.
__device__ __forceinline__ int next_item(int* counter, int slot[2], int it, int tid) {
  if (tid == 0) slot[it & 1] = atomicAdd(counter, 1);
  __syncthreads();
  return slot[it & 1];
}

// The min over a pair's lanes of `m`, on every one of them: its team's
// shuffles, then (lanes > 32) its warps through `part`. Every thread of the
// block calls it.
__device__ __forceinline__ float pair_min(float m, int lanes, int s, int warp, int lane,
                                          int team, float* part) {
  m = team_min_nan(m, s);
  if (lanes > 32) {
    if (lane == 0) part[warp] = m;
    __syncthreads();
    for (int w = warp - team; w < warp - team + lanes / 32; ++w) m = min_nan(part[w], m);
  }
  return m;
}

// ---- The nocull instance: a block takes kThreads / lanes pairs at a time
// and scans every triangle for each. ----
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 3) nocull_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  __shared__ int s_item[2];
  __shared__ float s_min[kWarps];
  const float* tab = kStaged ? reinterpret_cast<const float*>(smem4) : a.tab;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lanes = a.lanes, s = lanes < 32 ? lanes : 32;
  const int plane = tid % lanes, tl = lane % s, team = plane / s;
  if (kStaged) stage_table(reinterpret_cast<float*>(smem4), a.tab, a.nt, tid);
  for (int it = 0;; ++it) {
    const int item = next_item(a.scratch, s_item, it, tid);  // publishes the table too
    if (item >= a.items) break;
    const Pair p = load_pair(a, item, tid);
    float m = f32_inf(), px[kVpt], py[kVpt], pz[kVpt];
    bool on[kVpt];
    for (int v0 = team * s * kVpt; v0 < a.block; v0 += lanes * kVpt) {
      pose_run(p.r, p.verts, v0, s, tl, a.block, p.live, px, py, pz, on);
      scan<kStaged>(tab, 0, a.nt, px, py, pz, on, m);
    }
    m = pair_min(m, lanes, s, warp, lane, team, s_min);
    if (p.active && plane == 0) a.out[p.index] = p.live ? sqrtf(m) : f32_nan();
  }
}

// ---- Culled, launch 1 of 3: per pair its box, g0, pass 1 and the cull
// tests; each kept (pair, unit, group) scan is appended to `tasks`, and m0
// starts the pair's minimum. Group boxes and flags in dynamic shared
// memory; g0's triangles read through the L2. ----
__global__ void __launch_bounds__(kThreads, 3) plan_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  __shared__ int s_item[2];
  __shared__ float s_box[kWarps][6], s_m0[kWarps];
  float* gbox = reinterpret_cast<float*>(smem4);
  uint8_t* always = reinterpret_cast<uint8_t*>(gbox + 6 * a.ng);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lanes = a.lanes, s = lanes < 32 ? lanes : 32;
  const int plane = tid % lanes, tl = lane % s, team = plane / s, unit = s * kVpt;
  const unsigned below = (1u << lane) - 1u;  // the warp's lanes before this one
  for (int i = tid; i < 6 * a.ng; i += kThreads) gbox[i] = a.gbox[i];
  for (int i = tid; i < a.ng; i += kThreads) always[i] = a.always[i];

  for (int it = 0;; ++it) {
    const int item = next_item(a.scratch, s_item, it, tid);  // publishes the groups too
    if (item >= a.items) break;
    const Pair p = load_pair(a, item, tid);
    float px[kVpt], py[kVpt], pz[kVpt];
    bool on[kVpt];

    // The pair's box and g0.
    float lo[3] = {f32_inf(), f32_inf(), f32_inf()};
    float hi[3] = {-f32_inf(), -f32_inf(), -f32_inf()};
    for (int v0 = team * unit; v0 < a.block; v0 += lanes * kVpt) {
      pose_run(p.r, p.verts, v0, s, tl, a.block, p.live, px, py, pz, on);
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        if (on[j]) {
          lo[0] = fminf(lo[0], px[j]); lo[1] = fminf(lo[1], py[j]); lo[2] = fminf(lo[2], pz[j]);
          hi[0] = fmaxf(hi[0], px[j]); hi[1] = fmaxf(hi[1], py[j]); hi[2] = fmaxf(hi[2], pz[j]);
        }
      }
    }
    team_box(lo, hi, s);
    if (lanes > 32) {
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) { s_box[warp][c] = lo[c]; s_box[warp][3 + c] = hi[c]; }
      }
      __syncthreads();
      for (int w = warp - team; w < warp - team + lanes / 32; ++w) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          lo[c] = fminf(lo[c], s_box[w][c]);
          hi[c] = fmaxf(hi[c], s_box[w][3 + c]);
        }
      }
    }
    // The team's lanes split the groups, then meet (ties to the lowest
    // index); every team of a pair finds the same g0.
    float best = f32_inf();
    int g0 = a.ng;
    for (int g = tl; g < a.ng; g += s) {
      const float d = box_d2(lo, hi, gbox + 6 * g);
      if (d < best || (d == best && g < g0)) { best = d; g0 = g; }
    }
    for (int o = s / 2; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(kAll, best, o);
      const int og = __shfl_xor_sync(kAll, g0, o);
      if (od < best || (od == best && og < g0)) { best = od; g0 = og; }
    }

    // Pass 1: every vertex against g0's triangles; m0 starts the pair's
    // minimum.
    float m = f32_inf();
    const int t_lo = g0 * a.gsize, t_hi = min(a.nt, t_lo + a.gsize);
    for (int v0 = team * unit; v0 < a.block; v0 += lanes * kVpt) {
      pose_run(p.r, p.verts, v0, s, tl, a.block, p.live, px, py, pz, on);
      scan<false>(a.tab, t_lo, t_hi, px, py, pz, on, m);
    }
    m = pair_min(m, lanes, s, warp, lane, team, s_m0);
    if (p.live && plane == 0) {
      pair_min_bits(a)[p.index] = __float_as_uint(m != m ? f32_inf() : m);
      pair_nan(a)[p.index] = m != m;
    }
    const float thr = sqrtf(m) + a.slack;

    // Pass 2's tests, unit by unit: the warp's kept (pair, unit, group)
    // cells are appended together.
    for (int v0 = team * unit; v0 < a.block; v0 += lanes * kVpt) {
      pose_run(p.r, p.verts, v0, s, tl, a.block, p.live, px, py, pz, on);
      float ulo[3] = {f32_inf(), f32_inf(), f32_inf()};
      float uhi[3] = {-f32_inf(), -f32_inf(), -f32_inf()};
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        if (on[j]) {
          ulo[0] = fminf(ulo[0], px[j]); ulo[1] = fminf(ulo[1], py[j]);
          ulo[2] = fminf(ulo[2], pz[j]); uhi[0] = fmaxf(uhi[0], px[j]);
          uhi[1] = fmaxf(uhi[1], py[j]); uhi[2] = fmaxf(uhi[2], pz[j]);
        }
      }
      team_box(ulo, uhi, s);
      const int u = v0 / unit;
      int scans = 1;  // g0, in pass 1
      for (int g_base = 0; g_base < a.ng; g_base += s) {
        const int g = g_base + tl;
        const bool want = p.live && g < a.ng && g != g0 &&
                          (always[g] != 0 || !(sqrtf(box_d2(ulo, uhi, gbox + 6 * g)) > thr));
        const unsigned bits = __ballot_sync(kAll, want);
        scans += __popc(s < 32 ? (bits >> (lane - tl)) & ((1u << s) - 1u) : bits);
        int at = 0;
        if (lane == 0 && bits) at = atomicAdd(a.scratch + 1, __popc(bits));
        at = __shfl_sync(kAll, at, 0);
        if (want) a.tasks[at + __popc(bits & below)] = make_int2(p.index, (u << 16) | g);
      }
      if (a.visits != nullptr && p.live && tl == 0) atomicAdd(a.visits + p.index, scans);
    }
  }
}

// ---- Culled, launch 2 of 3: a warp per kept (pair, unit, group) scan,
// taken from a counter (a scan near the obstacle costs more than a far
// one); the warp's minimum goes into the pair's by an atomic min on the
// float's bits (non-negative floats order as their bits), a NaN into the
// pair's flag. ----
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 3) task_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const float* tab = kStaged ? reinterpret_cast<const float*>(smem4) : a.tab;
  const int tid = threadIdx.x, lane = tid & 31;
  const int unit = (a.lanes < 32 ? a.lanes : 32) * kVpt;
  if (kStaged) {
    stage_table(reinterpret_cast<float*>(smem4), a.tab, a.nt, tid);
    __syncthreads();
  }
  const int n = a.scratch[1];  // the tasks plan_kernel appended
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(a.scratch + 2, 1);
    t = __shfl_sync(kAll, t, 0);
    if (t >= n) break;
    const int2 task = a.tasks[t];
    const int pair = task.x, u = task.y >> 16, g = task.y & 0xffff;
    float r[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) r[j] = __ldg(a.rows + int64_t(pair) * 12 + j);
    const float* verts = a.blocks + int64_t(__ldg(a.ids + pair)) * a.block * 3;
    float px[kVpt], py[kVpt], pz[kVpt];
    bool on[kVpt];
    // Lane l holds vertices u * unit + l + 32 j of the unit.
    pose_run(r, verts, u * unit, 32, lane, min(a.block, (u + 1) * unit), true, px, py, pz, on);
    float m = f32_inf();
    scan<kStaged>(tab, g * a.gsize, min(a.nt, (g + 1) * a.gsize), px, py, pz, on, m);
    m = team_min_nan(m, 32);
    if (lane == 0) {
      if (m != m) pair_nan(a)[pair] = 1;
      else atomicMin(pair_min_bits(a) + pair, __float_as_uint(m));
    }
  }
}

// ---- Culled, launch 3 of 3: each pair's answer; with `kept` (this launch's
// own argument, so that the Args the other launches read stay as they
// were), the launch's scans added to it: the tasks plan_kernel appended and
// g0's, which every unit of a pair with a block scans in pass 1. ----
__global__ void finish_kernel(const Args a, unsigned long long* kept) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = false;
  if (i < a.k) {
    const int32_t b = a.ids[i];
    live = b >= 0 && b < a.nb;
    const bool nan = !live || pair_nan(a)[i] != 0;
    a.out[i] = nan ? f32_nan() : sqrtf(__uint_as_float(pair_min_bits(a)[i]));
  }
  if (kept == nullptr) return;
  const int pairs = __syncthreads_count(live);  // every thread of the block reaches it
  if (threadIdx.x == 0) {
    const int unit = (a.lanes < 32 ? a.lanes : 32) * kVpt;
    unsigned long long scans = (a.block + unit - 1) / unit;
    scans *= static_cast<unsigned long long>(pairs);
    if (blockIdx.x == 0) scans += static_cast<unsigned>(a.scratch[1]);
    if (scans != 0) atomicAdd(kept, scans);
  }
}

// ---- K4, the gradient planners' distance grid: for every node of the
// lattice ax x ay x az (node (i, j, k) at (i * ny + j) * nz + k), the
// distance to the nearest obstacle triangle, negated where a ray from the
// node along `dir` crosses the mesh an odd number of times.
//
// Replaces the XLA of `robocheck_tpu/planner/sdf.py`: `_grid_distances`
// (lines 127-139, the min over every triangle of the point-triangle
// distance) and `_grid_inside` (148-178, the parity of Moller-Trumbore
// crossings along `_RAY_DIR`), which `build_distance_grid` runs once per
// obstacle for every `SQPOptimizer`, `TrajectoryOptimizer` and grid-backed
// `SweptCertifier`.
//
// Inputs, on one device, float32 unless said:
//   ax, ay, az [nx], [ny], [nz]  the lattice's axes
//   gtab [nt, 24]  per triangle (`kernels/sdf.grid_table`): the scan
//                  table's 18 columns (corners a, b, c; edges ab, ac, bc),
//                  pvec = dir x ac, inv_det (0 where flat), flat (1.0 / 0.0)
//                  and a zero; in the Morton order of the centroids
//                  (`kernels/sdf.grid_groups`); 16-byte aligned
//   gbox [ng, 6]   conservative boxes (lo xyz, hi xyz) of the groups of
//                  kGroup consecutive rows, ng = ceil(nt / kGroup)
//   always [ng] uint8  groups measured and tested whatever their box says
//                  (a thin or non-finite triangle)
//   rslack [ng]    what the ray cull grows each box by
//                  (`kernels/sdf.grid_ray_slack`)
//   slack          2 x err_bound (`kernels/sdf.grid_slack`)
//   out [nx * ny * nz]
//   counts [2] int32 or null: the kept (warp, group) distance scans and
//                  ray scans are added to it
//   scratch        device memory for the groups' per-block arrays where
//                  they do not fit a block's shared memory, or null
//
// Bound: operations. A full scan of the alpha obstacle's 96^3 grid is
// 8.9e8 node-triangle pairs of a distance (21 to 79 operations by region)
// and a ray test (1 to 34); bytes are a few MB. Most of those pairs cannot
// move a node's value: a far triangle is not the nearest, and a ray meets
// few triangles. So the kernel does less of that work instead of doing it
// faster:
//   * A block is a brick of kBx x kBy x kBz nodes and a warp a brick of
//     kWx x kWy x kWz (a run of the flat index would be a sliver, whose box
//     no test could cull against). A brick cut by the lattice's edge
//     repeats the edge's nodes and writes only its own.
//   * Culling for the distance, by the clearance engine's rule (K3's). A
//     block orders the groups by the squared distance of their boxes to
//     its brick's box (ties to the lower index), so it starts with its
//     nearest (the scan's g0). Each warp keeps M, the largest running min
//     of its nodes (a NaN node, final already, left out), and measures
//     group g unless sqrt(box_d2(warp brick, g)) > sqrt(M) + slack and g is
//     not `always`. M only falls, so a test on the running value is
//     conservative: a skipped triangle's distance exceeds every node's min
//     by more than the rounding err_bound covers, and the min, an exact
//     operation, is the full scan's, bit for bit.
//   * Culling for the ray, on its own: a warp tests g's triangles for
//     crossings only where g's box grown by rslack[g] meets the sweep of
//     the warp's brick along +dir (the slab test over s >= 0; every
//     component of dir is positive), or g is `always`. rslack is slack plus
//     a bound on how far from its triangle the rounded test can declare a
//     crossing (`kernels/sdf.ray_error`: it grows as a triangle turns
//     parallel to dir, to inf). A pair that both rules skip costs nothing;
//     one that both keep shares p - a.
//   * Staging by the copy engine. A group's rows are 3 KB, contiguous in
//     the Morton-ordered table. Thread 0 copies the groups the block may
//     need, one `cp.async.bulk` each, into a ring of kRing shared-memory
//     slots, each with a full mbarrier (the copy completes it) and an empty
//     one (every warp arrives when done with the slot), so the copy of a
//     later group overlaps the scan of this one. A group is staged once for
//     the block where it is `always`, the block brick's sweep meets it, or
//     it passes some warp's distance test on the threshold that warp last
//     published (a stale one is larger: conservative); a warp that needs
//     nothing of a staged group passes it by.
//   * The groups' boxes, ray slacks and flags, their distances to the
//     block's brick and their order (38 bytes a group) live in shared
//     memory; past what a block can hold (~5,700 groups), the distances,
//     order and flags go to `scratch` (9 bytes a group per resident block)
//     and the rest is read from global memory, in launches of as many
//     blocks as the scratch holds. The order is ranked in tiles staged in
//     the ring before any group is: O(ng^2 / 256) a thread, under a full
//     scan's O(ng x 32 x 54) for any ng below ~400,000.
//   * The rules read only the inputs and the minima they produce, so
//     `kernels/sdf.grid_cull_plan` reproduces every (warp, group) scan on
//     the host, and `counts` must equal its.
// The arithmetic is the full scan's: a node's min squared distance over
// `point_tri_d2` (K3's, in the twin's priority) and its crossing parity in
// one pass over a triangle (both share the row and p - a); the sqrt once,
// of the min (sqrt is correctly rounded and monotone, so sqrt(min d2) is
// min sqrt(d2), NaN for NaN); the sign by its bit; each multiply and add
// rounded on its own (-fmad=false). Every value is the full twin's
// (`kernels/sdf.grid_values_reference`).
//
// The brick shapes, the ring depth and the blocks an SM must hold are
// build-time macros, tuned on the H100 by `scripts/torch_grid_compare.py`
// (which also times the full scan before the cull, from an older copy of
// this file): with 8 x 4 x 8 blocks of 2 x 4 x 4 warps, 4 slots and 5
// blocks (48 registers) the alpha grids ran within 2% of the fastest shape
// swept, and the 16x obstacle's 32^3 grid 14% faster than with 8 x 8 x 4
// blocks (8 slots gain 4% more there, for twice the shared memory); warp
// bricks flat along one axis (4 x 4 x 2, 1 x 8 x 4) keep more scans and
// run slower.
constexpr int kGridRow = 24;  // floats per table row

struct GridArgs {
  const float *ax, *ay, *az;
  int nx, ny, nz;
  const float* tab;
  int nt, signed_;
  float dx, dy, dz;
  float* out;
  const float* gbox;
  const uint8_t* always;
  const float* rslack;
  int ng;
  float slack;
  float rx, ry, rz;  // 1 / dx, 1 / dy, 1 / dz
  int32_t* counts;
  uint8_t* scratch;     // null: the groups' arrays in shared memory
  int nbx, nby, nbz;    // bricks along each axis
  int64_t first;        // the launch's first brick (z fastest, then y, x)
};

// Whether the ray from p along d crosses the triangle: the twin's
// Moller-Trumbore test with its per-triangle terms (pvec, inv_det, flat)
// from the table; tvec = p - a.
__device__ __forceinline__ bool ray_crosses(float tx, float ty, float tz, const Tri& t,
                                            const float4& ray, float flat, const GridArgs& g) {
  if (flat != 0.f) return false;
  const float u = dot3(tx, ty, tz, ray.x, ray.y, ray.z) * ray.w;
  if (!(u >= 0.f)) return false;
  const float qx = ty * t.abz - tz * t.aby;
  const float qy = tz * t.abx - tx * t.abz;
  const float qz = tx * t.aby - ty * t.abx;
  const float v = dot3(qx, qy, qz, g.dx, g.dy, g.dz) * ray.w;
  if (!(v >= 0.f) || !(u + v <= 1.f)) return false;
  return dot3(qx, qy, qz, t.acx, t.acy, t.acz) * ray.w > 0.f;
}

#ifndef RC_GRID_BX
#define RC_GRID_BX 8
#endif
#ifndef RC_GRID_BY
#define RC_GRID_BY 4
#endif
#ifndef RC_GRID_BZ
#define RC_GRID_BZ 8
#endif
#ifndef RC_GRID_WX
#define RC_GRID_WX 2
#endif
#ifndef RC_GRID_WY
#define RC_GRID_WY 4
#endif
#ifndef RC_GRID_WZ
#define RC_GRID_WZ 4
#endif
#ifndef RC_GRID_RING
#define RC_GRID_RING 4
#endif
constexpr int kBx = RC_GRID_BX, kBy = RC_GRID_BY, kBz = RC_GRID_BZ;  // a block's brick
constexpr int kWx = RC_GRID_WX, kWy = RC_GRID_WY, kWz = RC_GRID_WZ;  // a warp's brick
constexpr int kRing = RC_GRID_RING;  // shared-memory slots of one group each
constexpr int kGroup = 32;           // triangles a group
constexpr int kGroupFloats = kGroup * kGridRow;
static_assert(kBx * kBy * kBz == kThreads, "a block's brick holds one node a thread");
static_assert(kWx * kWy * kWz == 32, "a warp's brick holds one node a lane");
static_assert(kBx % kWx == 0 && kBy % kWy == 0 && kBz % kWz == 0,
              "warp bricks tile the block's brick");
static_assert(kRing >= 2 && kRing <= 8, "a ring of 2 to 8 slots");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return unsigned(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrive and expect `bytes` of copies to complete the phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed. A wait
// past 2^35 cycles (~17 s) traps, a launch failure the wrapper raises,
// rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 35)) __trap();
  } while (!done);
}
// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global memory into shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Whether the sweep of the box [lo, hi] along +dir (s >= 0) meets group box
// `gb` (lo xyz, hi xyz) grown by `rs`: per axis the sweep is inside the
// slab for s in [a, b], a = ((glo - rs) - hi) / d, b = ((ghi + rs) - lo) / d
// (as products with 1 / d); it meets where 0 <= every b and every a <=
// every b. A NaN term meets (`kernels/sdf._sweep_meets`).
__device__ __forceinline__ bool sweep_meets(const float lo[3], const float hi[3],
                                            const float* gb, float rs, const GridArgs& g) {
  const float inv[3] = {g.rx, g.ry, g.rz};
  float a[3], b[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] = ((gb[c] - rs) - hi[c]) * inv[c];
    b[c] = ((gb[3 + c] + rs) - lo[c]) * inv[c];
  }
  bool miss = false;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    miss = miss || 0.f > b[c];
#pragma unroll
    for (int e = 0; e < 3; ++e) miss = miss || a[c] > b[e];
  }
  return !miss;
}

#ifndef RC_GRID_MIN_BLOCKS
#define RC_GRID_MIN_BLOCKS 5
#endif
// Blocks an SM must hold at once: 5 leave 48 registers a thread.
constexpr int kGridMinBlocks = RC_GRID_MIN_BLOCKS;

// What lives in shared memory rather than registers, which bound how many
// blocks an SM holds: per warp its brick box, threshold and scan counts,
// per thread its output index, and thread 0's place in the order.
struct GridShared {
  uint64_t full[kRing], empty[kRing];
  int slot[kRing];     // the group in each slot, -1 past the last
  float thr[kWarps];   // each warp's threshold (the staging reads it)
  float wbox[kWarps][6];
  int count[kWarps][2];
  int64_t dst[kThreads];  // each thread's output index, -1 past the lattice
  int cursor, done;
};

// Bytes of `scratch` a block takes for `ng` groups: their distances to its
// brick, their order and their staging flags, each 16-byte aligned.
__host__ __device__ inline size_t grid_block_scratch(int ng) {
  const size_t words = (size_t(ng) * 4 + 15) / 16 * 16;
  return 2 * words + (size_t(ng) + 15) / 16 * 16;
}

template <bool kSigned>
__global__ void __launch_bounds__(kThreads, kGridMinBlocks) grid_kernel(const GridArgs g) {
  extern __shared__ float4 smem4[];
  __shared__ GridShared sh;
  float* ring = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The groups' arrays: in shared memory after the ring, or (g.scratch) the
  // inputs in global memory and this block's slot of the scratch.
  const float *gbox = g.gbox, *rslack = g.rslack;
  const uint8_t* always = g.always;
  float* bd;       // box_d2 to the block's brick
  int* order;      // groups by ascending bd
  uint8_t* fixed;  // staged whatever the minima
  if (g.scratch == nullptr) {
    float* gb = ring + kRing * kGroupFloats;
    float* rs = gb + 6 * g.ng;
    bd = rs + g.ng;
    order = reinterpret_cast<int*>(bd + g.ng);
    uint8_t* al = reinterpret_cast<uint8_t*>(order + g.ng);
    fixed = al + g.ng;
    for (int x = tid; x < 6 * g.ng; x += kThreads) gb[x] = __ldg(g.gbox + x);
    for (int x = tid; x < g.ng; x += kThreads) {
      rs[x] = __ldg(g.rslack + x);
      al[x] = __ldg(g.always + x);
    }
    gbox = gb;
    rslack = rs;
    always = al;
  } else {
    uint8_t* mine = g.scratch + size_t(blockIdx.x) * grid_block_scratch(g.ng);
    const size_t words = (size_t(g.ng) * 4 + 15) / 16 * 16;
    bd = reinterpret_cast<float*>(mine);
    order = reinterpret_cast<int*>(mine + words);
    fixed = mine + 2 * words;
  }

  // This lane's node: warp bricks in the block's brick, lanes in the warp's,
  // z fastest; past the lattice it repeats the edge's node.
  constexpr int kNwy = kBy / kWy, kNwz = kBz / kWz;
  const int64_t brick = g.first + blockIdx.x;
  const int bk = int(brick % g.nbz), bj = int(brick / g.nbz % g.nby);
  const int bi = int(brick / (int64_t(g.nbz) * g.nby));
  const int i0 = bi * kBx + warp / (kNwy * kNwz) * kWx;
  const int j0 = bj * kBy + warp / kNwz % kNwy * kWy;
  const int k0 = bk * kBz + warp % kNwz * kWz;
  const bool live = i0 < g.nx && j0 < g.ny && k0 < g.nz;  // the warp holds a node of its own
  const int i = i0 + lane / (kWy * kWz), j = j0 + lane / kWz % kWy, k = k0 + lane % kWz;
  const float px = __ldg(g.ax + min(i, g.nx - 1));
  const float py = __ldg(g.ay + min(j, g.ny - 1));
  const float pz = __ldg(g.az + min(k, g.nz - 1));
  sh.dst[tid] = i < g.nx && j < g.ny && k < g.nz ? (int64_t(i) * g.ny + j) * g.nz + k : -1;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&sh.full[s], 1);
      mbar_init(&sh.empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sh.cursor = sh.done = 0;
  }
  {
    // The warp's brick box (NaN coordinates stay out).
    float lo[3] = {px == px ? px : f32_inf(), py == py ? py : f32_inf(),
                   pz == pz ? pz : f32_inf()};
    float hi[3] = {px == px ? px : -f32_inf(), py == py ? py : -f32_inf(),
                   pz == pz ? pz : -f32_inf()};
    team_box(lo, hi, 32);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) { sh.wbox[warp][c] = lo[c]; sh.wbox[warp][3 + c] = hi[c]; }
      sh.thr[warp] = live ? f32_inf() : -f32_inf();
      sh.count[warp][0] = sh.count[warp][1] = 0;
    }
  }
  __syncthreads();
  {
    // The block's brick box (a repeated node is one of the block's), each
    // group's distance to it and whether it is staged whatever the minima.
    float lo[3], hi[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = sh.wbox[0][c];
      hi[c] = sh.wbox[0][3 + c];
      for (int w = 1; w < kWarps; ++w) {
        lo[c] = fminf(lo[c], sh.wbox[w][c]);
        hi[c] = fmaxf(hi[c], sh.wbox[w][3 + c]);
      }
    }
    for (int x = tid; x < g.ng; x += kThreads) {
      bd[x] = box_d2(lo, hi, gbox + 6 * x);
      fixed[x] = always[x] != 0 || (kSigned && sweep_meets(lo, hi, gbox + 6 * x, rslack[x], g));
    }
  }
  // Rank by (bd, index), never NaN, against tiles of bd staged in the ring
  // (no group is staged yet).
  constexpr int kTile = kRing * kGroupFloats;
  for (int x0 = 0; x0 < g.ng; x0 += kThreads) {
    const int x = x0 + tid;
    const float d = x < g.ng ? bd[x] : 0.f;
    int rank = 0;
    for (int t0 = 0; t0 < g.ng; t0 += kTile) {
      const int n = min(kTile, g.ng - t0);
      __syncthreads();
      for (int y = tid; y < n; y += kThreads) ring[y] = bd[t0 + y];
      __syncthreads();
      for (int h = 0; h < n; ++h) rank += ring[h] < d || (ring[h] == d && t0 + h < x);
    }
    if (x < g.ng) order[rank] = x;
  }
  __syncthreads();

  // Thread 0 stages the next group the block may need into `slot`, or marks
  // the end there.
  auto stage = [&](int slot) {
    const volatile float* thr_of = sh.thr;
    while (sh.cursor < g.ng) {
      const int grp = order[sh.cursor++];
      bool want = fixed[grp] != 0;
      const float d = sqrtf(bd[grp]);
      for (int w = 0; w < kWarps && !want; ++w) want = !(d > thr_of[w]);
      if (want) {
        const unsigned bytes = unsigned(min(kGroup, g.nt - grp * kGroup) * kGridRow * 4);
        sh.slot[slot] = grp;
        mbar_arrive_tx(&sh.full[slot], bytes);
        bulk_copy(ring + slot * kGroupFloats, g.tab + size_t(grp) * kGroupFloats, bytes,
                  &sh.full[slot]);
        return;
      }
    }
    sh.slot[slot] = -1;
    sh.done = 1;
    mbar_arrive(&sh.full[slot]);
  };
  if (tid == 0) {
    // The rank tiles' generic accesses to the ring come before the copies'.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int s = 0; s < kRing && !sh.done; ++s) stage(s);
  }

  float m = f32_inf();
  unsigned odd = 0u;
  for (int step = 0;; ++step) {
    const int slot = step % kRing;
    const unsigned parity = unsigned(step / kRing) & 1u;
    mbar_wait(&sh.full[slot], parity);
    const int grp = sh.slot[slot];
    if (grp < 0) break;
    if (live) {
      const float* gb = gbox + 6 * grp;
      const float wlo[3] = {sh.wbox[warp][0], sh.wbox[warp][1], sh.wbox[warp][2]};
      const float whi[3] = {sh.wbox[warp][3], sh.wbox[warp][4], sh.wbox[warp][5]};
      const bool forced = always[grp] != 0;
      const bool keep_d = forced || !(sqrtf(box_d2(wlo, whi, gb)) > sh.thr[warp]);
      const bool keep_r = kSigned && (forced || sweep_meets(wlo, whi, gb, rslack[grp], g));
      if (keep_d || keep_r) {
        const float4* rows = reinterpret_cast<const float4*>(ring + slot * kGroupFloats);
        const int n = min(kGroup, g.nt - grp * kGroup);
        for (int t = 0; t < n; ++t) {  // a row is six 16-byte broadcasts
          const float4* row = rows + t * (kGridRow / 4);
          const float4 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3], r4 = row[4];
          const Tri T{r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x,
                      r2.y, r2.z, r2.w, r3.x, r3.y, r3.z, r3.w, r4.x, r4.y};
          if (keep_d) m = min_nan(point_tri_d2(px, py, pz, T), m);
          if (keep_r) {
            const float4 r5 = row[5];
            const float4 ray = make_float4(r4.z, r4.w, r5.x, r5.y);  // pvec, inv_det
            odd ^= unsigned(ray_crosses(px - T.ax, py - T.ay, pz - T.az, T, ray, r5.z, g));
          }
        }
        if (keep_d) {  // M over the warp's nodes, a NaN node left out
          const unsigned big = __reduce_max_sync(kAll, m != m ? 0u : __float_as_uint(m));
          if (lane == 0) sh.thr[warp] = sqrtf(__uint_as_float(big)) + g.slack;
        }
      }
      if (lane == 0) {
        sh.count[warp][0] += keep_d;
        sh.count[warp][1] += keep_r;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sh.empty[slot]);
    if (tid == 0 && !sh.done) {
      mbar_wait(&sh.empty[slot], parity);  // every warp is done with the slot
      stage(slot);
    }
    __syncwarp();
  }
  if (g.counts != nullptr && live && lane == 0) {
    atomicAdd(g.counts, sh.count[warp][0]);
    if (kSigned) atomicAdd(g.counts + 1, sh.count[warp][1]);
  }
  const int64_t dst = sh.dst[tid];
  if (dst >= 0)  // the sign by its bit: -d of the twin, NaN and 0 included
    g.out[dst] = __int_as_float(__float_as_int(sqrtf(m)) ^ int(odd << 31));
}

// The dynamic shared memory of a block on `ng` groups: the ring, and where
// the groups' arrays live there (not in scratch), their boxes, ray slacks,
// distances and order and two flags a group.
size_t grid_smem(int ng, bool local) {
  const size_t ring = size_t(kRing) * kGroupFloats * 4;
  return local ? (ring + size_t(ng) * (24 + 4 + 4 + 4 + 2) + 15) / 16 * 16 : ring;
}

// Threads per pair for blocks of `block` vertices: the least power of two
// that holds them kVpt to a thread, at most kThreads.
int lanes_for(int block) {
  const int want = (block + kVpt - 1) / kVpt;
  int lanes = 1;
  while (lanes < want && lanes < kThreads) lanes <<= 1;
  return lanes;
}

// Whether the table is staged in a scanning block's shared memory: where at
// least two such blocks stay resident per SM with it.
bool staged_table(int nt, int optin) { return size_t(nt) * 72 <= size_t(optin) / 2; }

// Launch `kernel` on as many blocks as stay resident, at most `items`.
template <typename Kernel>
cudaError_t launch_persistent(Kernel kernel, const Args& a, int items, size_t smem, int sms,
                              cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t cap = int64_t(per_sm) * sms;
  kernel<<<int(items < cap ? items : cap), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int device_limits(int* sms, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return int(err);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launches (0 =
// launched). `gbox` null: the nocull instance (`always` to `kept` unused).
// `scratch`: int32 device scratch, 1 entry for nocull, 4 + 2k culled;
// `tasks`: room for k x units x ng int2 (units = ceil(block / unit)). `tab`
// must be 16-byte aligned.
int rc_clearance_pair_min(const float* rows, const int32_t* ids, int64_t k,
                          const float* blocks, int nb, int block, const float* tab, int nt,
                          const float* gbox, const uint8_t* always, int ng, int gsize,
                          float slack, float* out, int32_t* visits, int64_t* kept, void* tasks,
                          int* scratch, void* stream) {
  if (k <= 0) return 0;
  const bool cull = gbox != nullptr;
  const int lanes = lanes_for(block > 0 ? block : 1), per_item = kThreads / lanes;
  const int unit = (lanes < 32 ? lanes : 32) * kVpt;
  if (k > (int64_t(1) << 30) || nb <= 0 || block <= 0 || nt < 0 ||
      (reinterpret_cast<uintptr_t>(tab) & 15) != 0 ||
      (cull && (gsize <= 0 || ng != (nt + gsize - 1) / gsize || ng >= (1 << 16) ||
                (block + unit - 1) / unit >= (1 << 15) || always == nullptr ||
                tasks == nullptr)))
    return int(cudaErrorInvalidValue);
  const Args a{rows, ids, int(k), blocks, nb, block, tab, nt, out, lanes,
               int((k + per_item - 1) / per_item), scratch, gbox, always, ng, gsize, slack,
               visits, static_cast<int2*>(tasks)};
  int sms = 0, optin = 0;
  cudaError_t err = cudaError_t(device_limits(&sms, &optin));
  if (err != cudaSuccess) return int(err);
  const bool staged = staged_table(nt, optin);
  const size_t tab_bytes = staged ? size_t(nt) * 72 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cull) {
    if ((err = cudaMemsetAsync(scratch, 0, sizeof(int), st)) != cudaSuccess) return int(err);
    return int(staged ? launch_persistent(nocull_kernel<true>, a, a.items, tab_bytes, sms, st)
                      : launch_persistent(nocull_kernel<false>, a, a.items, 0, sms, st));
  }
  // The counters and NaN flags to 0; plan_kernel writes the minimum of
  // every pair with a block before task_kernel reads it.
  if ((err = cudaMemsetAsync(scratch, 0, 3 * sizeof(int), st)) != cudaSuccess ||
      (err = cudaMemsetAsync(scratch + 4 + k, 0, k * sizeof(int), st)) != cudaSuccess)
    return int(err);
  if ((err = launch_persistent(plan_kernel, a, a.items, size_t(ng) * 25, sms, st)) !=
      cudaSuccess)
    return int(err);
  err = staged ? launch_persistent(task_kernel<true>, a, 1 << 30, tab_bytes, sms, st)
               : launch_persistent(task_kernel<false>, a, 1 << 30, 0, sms, st);
  if (err != cudaSuccess) return int(err);
  finish_kernel<<<int((k + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      a, reinterpret_cast<unsigned long long*>(kept));
  return int(cudaGetLastError());
}

// K4's scratch for a lattice nx x ny x nz over `ng` groups: 0 where a
// block holds the groups' arrays in shared memory; else the bytes that
// give one block's arrays to each of the blocks the card holds at once
// (SMs x kGridMinBlocks), or to every brick if there are fewer. A negative
// cudaError_t on failure.
int64_t rc_sdf_grid_scratch_bytes(int nx, int ny, int nz, int ng) {
  int sms = 0, optin = 0;
  const int err = device_limits(&sms, &optin);
  if (err != 0) return -int64_t(err);
  if (nx <= 0 || ny <= 0 || nz <= 0 || ng <= 0) return -int64_t(cudaErrorInvalidValue);
  if (grid_smem(ng, true) <= size_t(optin)) return 0;
  const int64_t bricks = int64_t((nx + kBx - 1) / kBx) * ((ny + kBy - 1) / kBy) *
                         ((nz + kBz - 1) / kBz);
  const int64_t resident = int64_t(sms) * kGridMinBlocks;
  return int64_t(grid_block_scratch(ng)) * (bricks < resident ? bricks : resident);
}

// K4 on `stream`: the grid over the axes ax [nx], ay [ny], az [nz] against
// the grid table gtab [nt, 24] (16-byte aligned) and its groups' boxes
// gbox [ng, 6], flags always [ng] and ray slacks rslack [ng] (ng =
// ceil(nt / 32)), culled with `slack`, signed by the parity of the ray
// along (dx, dy, dz) where `signed_`; out [nx * ny * nz]; the kept scans
// added to counts [2] unless it is null. With `scratch` null a block keeps
// the groups' arrays in shared memory (refused where they do not fit; see
// `rc_sdf_grid_scratch_bytes`) and one launch covers the lattice; with
// `scratch_bytes` of scratch, they live there and each launch takes as
// many blocks as it holds, one after another on `stream`. Returns the
// cudaError_t of the launches (0 = launched).
int rc_sdf_grid(const float* ax, const float* ay, const float* az, int nx, int ny, int nz,
                const float* gtab, int nt, const float* gbox, const uint8_t* always,
                const float* rslack, int ng, float slack, int signed_, float dx, float dy,
                float dz, float* out, int32_t* counts, void* scratch, int64_t scratch_bytes,
                void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || nt <= 0 || gbox == nullptr || always == nullptr ||
      rslack == nullptr || ng != (nt + kGroup - 1) / kGroup ||
      (reinterpret_cast<uintptr_t>(gtab) & 15) != 0)
    return int(cudaErrorInvalidValue);
  const int nbx = (nx + kBx - 1) / kBx, nby = (ny + kBy - 1) / kBy, nbz = (nz + kBz - 1) / kBz;
  const int64_t bricks = int64_t(nbx) * nby * nbz;
  const bool local = scratch == nullptr;
  const int64_t per_launch = local ? bricks : scratch_bytes / int64_t(grid_block_scratch(ng));
  if (per_launch < 1 || bricks > (int64_t(1) << 31) - 1) return int(cudaErrorInvalidValue);
  int sms = 0, optin = 0;
  cudaError_t err = cudaError_t(device_limits(&sms, &optin));
  if (err != cudaSuccess) return int(err);
  const size_t smem = grid_smem(ng, local);
  if (smem > size_t(optin)) return int(cudaErrorInvalidValue);  // too many groups to hold
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = signed_ ? cudaFuncSetAttribute(grid_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem))
                : cudaFuncSetAttribute(grid_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  GridArgs g{ax, ay, az, nx, ny, nz, gtab, nt, signed_, dx, dy, dz, out,
             gbox, always, rslack, ng, slack, 1.f / dx, 1.f / dy, 1.f / dz, counts,
             static_cast<uint8_t*>(scratch), nbx, nby, nbz, 0};
  for (; g.first < bricks; g.first += per_launch) {
    const int64_t rest = bricks - g.first;
    const unsigned blocks = unsigned(rest < per_launch ? rest : per_launch);
    if (signed_)
      grid_kernel<true><<<blocks, kThreads, smem, st>>>(g);
    else
      grid_kernel<false><<<blocks, kThreads, smem, st>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  return 0;
}

// The dynamic shared memory of a scanning block (nocull, or culled pass 2)
// on `nt` triangles: the staged table, or 0 where it is read through the
// L2; a negative cudaError_t on failure.
int64_t rc_clearance_smem_bytes(int nt) {
  int sms = 0, optin = 0;
  const int err = device_limits(&sms, &optin);
  if (err != 0) return -int64_t(err);
  return staged_table(nt, optin) ? int64_t(nt) * 72 : 0;
}

const char* rc_clearance_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
