// The check's front end on the card: the pose rows (K2) and the robot box
// with the mesh-box broad phase (K5).
//
// Replaces two jitted XLA functions of robocheck_tpu/kernels/megakernel.py,
// which XLA fuses into one or two device programs each:
//   * K2, `poses_from_confs` (lines 1099-1113, over ops/transform.py:43-51):
//     [n,6] configurations (x, y, z, pitch, yaw, roll) -> [n,16] pose rows
//     r00 r01 r02 tx, r10 r11 r12 ty, r20 r21 r22 tz, 0 0 0 0, with
//     R = Rz(yaw) Ry(pitch) Rx(roll);
//   * K5, `_robot_bounds` / `_broad_overlap` (lines 1209-1248): [n,16] pose
//     rows and the robot corner table rob_base [10,tr] (rows 0-8 the corners
//     c0x..c2z, row 9 > 0 for a real triangle) -> the [n,6] box (lo xyz, hi
//     xyz) of the posed robot's real triangles and, given an obstacle box
//     [6], one byte a row: the two boxes overlap on closed intervals.
// Their PyTorch twins are `poses_from_confs_reference`,
// `robot_bounds_reference` and `mesh_broad_reference` in
// robocheck_tpu_torch/kernels/megakernel.py; the wrappers are in
// robocheck_tpu_torch/kernels/front.py.
//
// What bounds them on an H100, and what the design does about it:
//   * K2 reads 24 B and writes 64 B a row and computes six sin/cos and 21
//     multiplies and adds: bytes. The twin is ~20 eager launches, each
//     writing an [n] column to memory; here one thread computes its row in
//     registers and stores it as four float4.
//   * K5 poses three corners of every real robot triangle of every row
//     (9 coordinates of 3 multiplies and 3 adds, the triangle's box and its
//     share of the mesh box: `POSE_OPS` = 72 operations in
//     profiling/bounds.py), ~7.3e9 operations for 100,000 rows of the
//     alpha-1.0 robot: operations. The twin writes a [n, tr] float32 tensor
//     per corner and axis (~GBs per 100,000 rows). Here a warp takes a row:
//     its lanes stride over the triangles, keep the six running extremes in
//     registers and meet by shuffles, so nothing of size [n, tr] is stored;
//     the table (40 B a triangle) is read through the read-only cache.
//
// Arithmetic: build with -fmad=false and without fast math. Each multiply
// and add rounds on its own and in the twin's order, as torch's separate
// launches round them; sinf / cosf are libdevice's, as torch's sin / cos
// are. Extremes propagate NaN (min.NaN / max.NaN, as torch.minimum and
// amin do), and a box with no real triangle is (kBig, -kBig), K1's
// sentinel. So K2's rows equal the twin's bit for bit, and K5's boxes equal
// the twin's as values (the min of -0.0 and +0.0 may be either zero).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPoseThreads = 256;  // K2: rows per block, one a thread
constexpr int kBoxWarps = 8;       // K5: rows per block, one a warp
constexpr float kBig = 3.0e38f;    // K1's fill of boxes with no real triangle
constexpr unsigned kAll = 0xffffffffu;

// NaN-propagating min / max (torch.minimum / jnp.minimum), one instruction
// each; the same as csrc/megakernel.cu's.
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

// K2: one row a thread. The entry formulas and operand order of
// `ops/transform.rotation_matrices` (A = yaw, B = pitch, C = roll):
// cosA * sinB * sinC - sinA * cosC is ((cosA * sinB) * sinC) - (sinA * cosC).
__global__ void __launch_bounds__(kPoseThreads)
pose_rows_kernel(const float* __restrict__ confs, int64_t n, float4* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * kPoseThreads + threadIdx.x;
  if (i >= n) return;
  const float* c = confs + i * 6;
  const float x = __ldg(c), y = __ldg(c + 1), z = __ldg(c + 2);
  const float pitch = __ldg(c + 3), yaw = __ldg(c + 4), roll = __ldg(c + 5);
  const float cosB = cosf(pitch), sinB = sinf(pitch);
  const float cosA = cosf(yaw), sinA = sinf(yaw);
  const float cosC = cosf(roll), sinC = sinf(roll);
  float4* row = out + i * 4;
  row[0] = make_float4(cosA * cosB, cosA * sinB * sinC - sinA * cosC,
                       cosA * sinB * cosC + sinA * sinC, x);
  row[1] = make_float4(sinA * cosB, sinA * sinB * sinC + cosA * cosC,
                       sinA * sinB * cosC - cosA * sinC, y);
  row[2] = make_float4(-sinB, cosB * sinC, cosB * cosC, z);
  row[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// K5: one row a warp. Lane l poses triangles l, l + 32, ... as
// r0 * X + r1 * Y + r2 * Z + t, left to right (K1's pose pass, `pose_tri`
// in csrc/megakernel.cu), takes each triangle's box per axis as
// min(min(c0, c1), c2), and folds it into the row's box where the triangle
// is real (kBig / -kBig where not).
__global__ void __launch_bounds__(32 * kBoxWarps)
robot_bounds_kernel(const float* __restrict__ poses, int64_t n,
                    const float* __restrict__ rob, int tr,
                    const float* __restrict__ obs_box, float* __restrict__ out_box,
                    uint8_t* __restrict__ out_hit) {
  const int lane = threadIdx.x & 31;
  const int64_t b = int64_t(blockIdx.x) * kBoxWarps + (threadIdx.x >> 5);
  if (b >= n) return;  // the same for every lane of a warp
  float p[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) p[k] = __ldg(poses + b * 16 + k);
  float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
  for (int t = lane; t < tr; t += 32) {
    float c[9];
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      const float X = __ldg(rob + (3 * cc) * tr + t);
      const float Y = __ldg(rob + (3 * cc + 1) * tr + t);
      const float Z = __ldg(rob + (3 * cc + 2) * tr + t);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        c[3 * cc + k] = p[4 * k] * X + p[4 * k + 1] * Y + p[4 * k + 2] * Z + p[4 * k + 3];
    }
    const bool real = __ldg(rob + 9 * tr + t) > 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float tlo = min_nan(min_nan(c[k], c[3 + k]), c[6 + k]);
      const float thi = max_nan(max_nan(c[k], c[3 + k]), c[6 + k]);
      lo[k] = min_nan(lo[k], real ? tlo : kBig);
      hi[k] = max_nan(hi[k], real ? thi : -kBig);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = warp_min(lo[k]);
    hi[k] = warp_max(hi[k]);
  }
  if (lane != 0) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out_box[b * 6 + k] = lo[k];
    out_box[b * 6 + 3 + k] = hi[k];
  }
  if (obs_box != nullptr) {
    bool hit = true;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      hit = hit && lo[k] <= __ldg(obs_box + 3 + k) && __ldg(obs_box + k) <= hi[k];
    out_hit[b] = hit;
  }
}

}  // namespace

extern "C" {

const char* rc_front_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2: confs [n,6] f32 -> out [n,16] f32 (16-byte aligned), both contiguous
// on the current device, on `stream`. Returns the launch's cudaError_t
// (0 = launched); does not synchronise.
int rc_pose_rows(const float* confs, int64_t n, float* out, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t blocks = (n + kPoseThreads - 1) / kPoseThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  pose_rows_kernel<<<unsigned(blocks), kPoseThreads, 0, stream>>>(
      confs, n, reinterpret_cast<float4*>(out));
  return cudaGetLastError();
}

// K5: poses [n,16] and rob_base [10,tr] f32 -> out_box [n,6] f32 and, when
// obs_box [6] is not null, out_hit [n] uint8 (1 = the boxes overlap); all
// contiguous on the current device, on `stream`. tr >= 1. Returns the
// launch's cudaError_t (0 = launched); does not synchronise.
int rc_robot_bounds(const float* poses, int64_t n, const float* rob_base, int tr,
                    const float* obs_box, float* out_box, uint8_t* out_hit,
                    cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (tr < 1 || (obs_box != nullptr && out_hit == nullptr)) return cudaErrorInvalidValue;
  const int64_t blocks = (n + kBoxWarps - 1) / kBoxWarps;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  robot_bounds_kernel<<<unsigned(blocks), 32 * kBoxWarps, 0, stream>>>(
      poses, n, rob_base, tr, obs_box, out_box, out_hit);
  return cudaGetLastError();
}

}  // extern "C"
