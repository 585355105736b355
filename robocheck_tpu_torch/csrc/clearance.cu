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
//   tris   [nt, 9]   obstacle triangles, corners a, b, c; no padding
//   out    [k]
//
// Bound: operations. A 1,024-pair dispatch on the alpha-1.0 obstacle is
// ~1.06e9 vertex-triangle distances of 21 to 79 operations each, by the
// region the closest point lies in (`profiling/bounds.py`), against ~12 KB
// of block vertices per pair. The design keeps the arithmetic fed: each thread holds
// kVpt posed vertices in registers, the block stages kTile obstacle
// triangles at a time in shared memory (corners and edges, computed once per
// triangle) that every warp reads as broadcasts, the running min stays in
// registers, and a warp shuffle plus one shared-memory step reduce it per
// pair. A pair takes
// `lanes` threads (a power of two, up to kThreads), so a 1,024-vertex block
// fills a thread block and 1-vertex blocks run kThreads pairs per block.
//
// Arithmetic: built with -fmad=false and no fast math, so every multiply
// and add rounds on its own, divides and the sqrt are IEEE, as in the twin.
// A NaN distance wins the min and stays (torch.minimum's rule), so a
// degenerate triangle can only make a pair's answer NaN, never drop it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kVpt = 4;        // vertices a thread holds at once
constexpr int kTile = 128;     // obstacle triangles staged per step

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float f32_nan() { return __int_as_float(0x7fc00000); }

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

__device__ __forceinline__ float point_tri_d2(float px, float py, float pz,
                                              const Tri& t) {
  const float apx = px - t.ax, apy = py - t.ay, apz = pz - t.az;
  const float d1 = dot3(t.abx, t.aby, t.abz, apx, apy, apz);
  const float d2 = dot3(t.acx, t.acy, t.acz, apx, apy, apz);
  const float bpx = px - t.bx, bpy = py - t.by, bpz = pz - t.bz;
  const float d3 = dot3(t.abx, t.aby, t.abz, bpx, bpy, bpz);
  const float d4 = dot3(t.acx, t.acy, t.acz, bpx, bpy, bpz);
  const float cpx = px - t.cx, cpy = py - t.cy, cpz = pz - t.cz;
  const float d5 = dot3(t.abx, t.aby, t.abz, cpx, cpy, cpz);
  const float d6 = dot3(t.acx, t.acy, t.acz, cpx, cpy, cpz);
  float qx, qy, qz;
  // The twin's cascade of selects, latest first: vertex a, b, c, then edge
  // ab, ac, bc, then the face.
  if (d1 <= 0.f && d2 <= 0.f) {
    qx = t.ax; qy = t.ay; qz = t.az;
  } else if (d3 >= 0.f && d4 <= d3) {
    qx = t.bx; qy = t.by; qz = t.bz;
  } else if (d6 >= 0.f && d5 <= d6) {
    qx = t.cx; qy = t.cy; qz = t.cz;
  } else {
    const float vc = d1 * d4 - d3 * d2;
    const float vb = d5 * d2 - d1 * d6;
    const float va = d3 * d6 - d5 * d4;
    if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) {
      const float v = d1 / (d1 - d3);
      qx = t.ax + v * t.abx; qy = t.ay + v * t.aby; qz = t.az + v * t.abz;
    } else if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) {
      const float v = d2 / (d2 - d6);
      qx = t.ax + v * t.acx; qy = t.ay + v * t.acy; qz = t.az + v * t.acz;
    } else if (va <= 0.f && d4 - d3 >= 0.f && d5 - d6 >= 0.f) {
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
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  return dot3(dx, dy, dz, dx, dy, dz);
}

__global__ void __launch_bounds__(kThreads)
pair_min_kernel(const float* __restrict__ rows, const int32_t* __restrict__ ids,
                int64_t k, const float* __restrict__ blocks, int nb, int block,
                const float* __restrict__ tris, int nt, int lanes,
                float* __restrict__ out) {
  __shared__ Tri tile[kTile];
  __shared__ float warp_min[kThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid % lanes;
  const int64_t pair = (int64_t)blockIdx.x * (kThreads / lanes) + tid / lanes;
  const bool active = pair < k;
  float r[12];
  bool bad = true;
  int64_t base = 0;
#pragma unroll
  for (int j = 0; j < 12; ++j) r[j] = 0.f;
  if (active) {
#pragma unroll
    for (int j = 0; j < 12; ++j) r[j] = rows[pair * 12 + j];
    const int32_t b = ids[pair];
    bad = b < 0 || b >= nb;
    base = bad ? 0 : (int64_t)b * block * 3;
  }
  float m = f32_inf();
  // The trip counts depend on `block` and `nt` only, the same for every
  // thread of the block, so every thread reaches each __syncthreads.
  for (int v0 = 0; v0 < block; v0 += lanes * kVpt) {
    float px[kVpt], py[kVpt], pz[kVpt], mv[kVpt];
    bool on[kVpt];
#pragma unroll
    for (int j = 0; j < kVpt; ++j) {
      const int v = v0 + lane + j * lanes;
      on[j] = active && !bad && v < block;
      px[j] = py[j] = pz[j] = 0.f;
      mv[j] = f32_inf();
      if (on[j]) {
        const float* p = blocks + base + (int64_t)v * 3;
        const float x = p[0], y = p[1], z = p[2];
        px[j] = ((r[0] * x + r[1] * y) + r[2] * z) + r[9];
        py[j] = ((r[3] * x + r[4] * y) + r[5] * z) + r[10];
        pz[j] = ((r[6] * x + r[7] * y) + r[8] * z) + r[11];
      }
    }
    for (int t0 = 0; t0 < nt; t0 += kTile) {
      const int n = min(kTile, nt - t0);
      __syncthreads();
      for (int i = tid; i < n; i += kThreads) {
        const float* s = tris + (int64_t)(t0 + i) * 9;
        Tri t;
        t.ax = s[0]; t.ay = s[1]; t.az = s[2];
        t.bx = s[3]; t.by = s[4]; t.bz = s[5];
        t.cx = s[6]; t.cy = s[7]; t.cz = s[8];
        t.abx = t.bx - t.ax; t.aby = t.by - t.ay; t.abz = t.bz - t.az;
        t.acx = t.cx - t.ax; t.acy = t.cy - t.ay; t.acz = t.cz - t.az;
        t.bcx = t.cx - t.bx; t.bcy = t.cy - t.by; t.bcz = t.cz - t.bz;
        tile[i] = t;
      }
      __syncthreads();
      for (int i = 0; i < n; ++i) {
#pragma unroll
        for (int j = 0; j < kVpt; ++j) {
          if (on[j]) mv[j] = min_nan(point_tri_d2(px[j], py[j], pz[j], tile[i]), mv[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kVpt; ++j) m = min_nan(mv[j], m);
  }
  // The pair's min over its lanes: a shuffle inside each warp (lanes is a
  // power of two, so a pair's lanes never straddle another pair's), then
  // across the pair's warps through shared memory.
  const int span = lanes < 32 ? lanes : 32;
  for (int off = span / 2; off > 0; off >>= 1) {
    m = min_nan(__shfl_xor_sync(0xffffffffu, m, off), m);
  }
  if (lanes > 32) {
    if ((tid & 31) == 0) warp_min[tid >> 5] = m;
    __syncthreads();
    if (lane == 0) {
      for (int w = 1; w < lanes / 32; ++w) m = min_nan(warp_min[(tid >> 5) + w], m);
    }
  }
  if (active && lane == 0) out[pair] = bad ? f32_nan() : sqrtf(m);
}

// Threads per pair for blocks of `block` vertices: the least power of two
// that holds them kVpt to a thread, at most kThreads.
int lanes_for(int block) {
  const int want = (block + kVpt - 1) / kVpt;
  int lanes = 1;
  while (lanes < want && lanes < kThreads) lanes <<= 1;
  return lanes;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = launched).
extern "C" int rc_clearance_pair_min(const float* rows, const int32_t* ids,
                                     int64_t k, const float* blocks, int nb,
                                     int block, const float* tris, int nt,
                                     float* out, void* stream) {
  if (k <= 0) return 0;
  if (nb <= 0 || block <= 0 || nt < 0) return (int)cudaErrorInvalidValue;
  const int lanes = lanes_for(block);
  const int64_t grid = (k + kThreads / lanes - 1) / (kThreads / lanes);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  pair_min_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      rows, ids, k, blocks, nb, block, tris, nt, lanes, out);
  return (int)cudaGetLastError();
}

extern "C" const char* rc_clearance_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
