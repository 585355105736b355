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
//     rows and the robot's corner table -> the [n,6] box (lo xyz, hi xyz) of
//     the posed robot's real triangles and, given an obstacle box [6], one
//     byte a row: the two boxes overlap on closed intervals. K5 reads the
//     robot as its vertex table [3, nv] (SoA X, Y, Z): the distinct corners
//     of the real triangles, by exact bits, built once per robot table
//     (`robot_vertices` in robocheck_tpu_torch/kernels/megakernel.py).
// Their PyTorch twins are `poses_from_confs_reference`,
// `robot_bounds_reference` / `mesh_broad_reference` (over the corner table)
// and `robot_bounds_vertices_reference` (over the vertex table, in this
// kernel's operation order) in robocheck_tpu_torch/kernels/megakernel.py;
// the wrappers are in robocheck_tpu_torch/kernels/front.py.
//
// What bounds them on an H100, and what the design does about it:
//   * K2 reads 24 B and writes 64 B a row and computes six sin/cos and 21
//     multiplies and adds: bytes. A block stages its rows' configurations
//     and pose rows in shared memory, so both its loads and its stores are
//     contiguous; a thread computes one row.
//   * K5: a box is a min / max over the posed coordinates, and a vertex
//     posed as r0 * X + r1 * Y + r2 * Z + t (each operation rounded on its
//     own) gives the same float from whichever triangle it comes, so posing
//     each distinct real vertex once gives the same set of values as posing
//     every corner (the alpha-1.0 robot: 792 vertices for 3,024 corners of
//     1,008 triangles in a 1,024-column table). Rounding is monotone, so
//     min over v of fl(s_v + t) is fl(min over v of s_v + t) for a finite t
//     (with s_v = r0 * X + r1 * Y + r2 * Z); for t = +-inf the selection in
//     `finish_axis` gives what every vertex would (NaN where some s_v is the
//     opposite infinity). So a vertex costs 9 multiplies, 6 adds and 6 min /
//     max a row: operations. A persistent grid walks row groups by grid
//     stride; each block stages the vertex table into shared memory once
//     (in tiles of kTile vertices, restaged per row group where it takes
//     more than one); each warp owns R rows, whose 9 rotation entries stay
//     in registers, so a vertex read from shared memory serves R rows; lanes
//     stride over the vertices, keep 6 R running extremes and meet by
//     shuffles. Nothing of size [n, nv] is stored.
//
// Arithmetic: build with -fmad=false and without fast math. Each multiply
// and add rounds on its own and in the twins' order, as torch's separate
// launches round them; sinf / cosf are libdevice's, as torch's sin / cos
// are. Extremes propagate NaN (min.NaN / max.NaN, as torch.minimum and
// amin do). K1's sentinel (kBig, -kBig) is the box of a table with no real
// triangle, and K5 folds it into every box where the corner table has
// padding, as the twins' masked reductions fold it (`padded`; K1 itself
// starts from it everywhere). So K2's rows equal the twin's bit for bit, and
// K5's boxes equal the twins' as values (the min of -0.0 and +0.0 may be
// either zero), also where a posed coordinate passes +-kBig.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

// K5's rows per warp (R): each vertex read from shared memory serves R rows.
// R = 1-4 are within 10% of each other on 100,000 rows, 3 the fastest; another
// R is timed by building a copy of this file with -DRC_BOX_ROWS=<R>.
#ifndef RC_BOX_ROWS
#define RC_BOX_ROWS 3
#endif

constexpr int kPoseThreads = 256;  // K2: rows per block, one a thread
constexpr int kBoxWarps = 8;       // K5: warps per block
constexpr int kBoxRows = RC_BOX_ROWS;
constexpr int kTile = 4096;        // K5: vertices per shared-memory tile (48 KB)
static_assert(kBoxRows >= 1 && kBoxRows <= 4, "RC_BOX_ROWS must be 1, 2, 3 or 4");
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

// K2's row from one configuration. The entry formulas and operand order of
// `ops/transform.rotation_matrices` (A = yaw, B = pitch, C = roll):
// cosA * sinB * sinC - sinA * cosC is ((cosA * sinB) * sinC) - (sinA * cosC).
__device__ __forceinline__ void pose_row(const float* c, float4* row) {
  const float x = c[0], y = c[1], z = c[2];
  const float cosB = cosf(c[3]), sinB = sinf(c[3]);
  const float cosA = cosf(c[4]), sinA = sinf(c[4]);
  const float cosC = cosf(c[5]), sinC = sinf(c[5]);
  row[0] = make_float4(cosA * cosB, cosA * sinB * sinC - sinA * cosC,
                       cosA * sinB * cosC + sinA * sinC, x);
  row[1] = make_float4(sinA * cosB, sinA * sinB * sinC + cosA * cosC,
                       sinA * sinB * cosC - cosA * sinC, y);
  row[2] = make_float4(-sinB, cosB * sinC, cosB * cosC, z);
  row[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The shared-memory float4 slot of float4 k = 4 * row + j of a block's pose
// rows: one slot of padding after every 8, so both the row-wise writes (a
// thread's row) and the contiguous reads hit 8 distinct 16-byte bank groups
// per quarter warp.
__device__ __forceinline__ int pose_slot(int k) { return k + (k >> 3); }

// K2: one row a thread, with a staged memory path: a block's [256, 6]
// configurations are read coalesced into shared memory, each thread computes
// its row there, and the block's 16 KB of rows are stored as contiguous
// float4 (a warp's store is 512 contiguous bytes, not 32 rows at a 64 B
// stride).
__global__ void __launch_bounds__(kPoseThreads)
pose_rows_kernel(const float* __restrict__ confs, int64_t n, float4* __restrict__ out) {
  __shared__ float sc[kPoseThreads * 6];
  __shared__ float4 so[kPoseThreads * 4 + kPoseThreads / 2];
  const int64_t base = int64_t(blockIdx.x) * kPoseThreads;
  const int rows = n - base < kPoseThreads ? int(n - base) : kPoseThreads;
  for (int k = threadIdx.x; k < rows * 6; k += kPoseThreads) sc[k] = __ldg(confs + base * 6 + k);
  __syncthreads();
  if (int(threadIdx.x) < rows) {
    float4 row[4];
    pose_row(sc + threadIdx.x * 6, row);
#pragma unroll
    for (int j = 0; j < 4; ++j) so[pose_slot(4 * threadIdx.x + j)] = row[j];
  }
  __syncthreads();
  float4* dst = out + base * 4;
  for (int k = threadIdx.x; k < rows * 4; k += kPoseThreads) dst[k] = so[pose_slot(k)];
}

// K5's last step for one axis of one row: lo_s / hi_s are the min / max over
// the vertices of s = r0 * X + r1 * Y + r2 * Z (NaN if any s is), t the
// translation. For t = -inf every fl(s + t) is -inf except where s is +inf
// or NaN (then NaN), which hi_s tells; for t = +inf likewise by lo_s; a NaN
// t makes every value NaN. Then the fold of cap (kBig where the corner
// table has padding, else +inf: nothing).
__device__ __forceinline__ void finish_axis(float lo_s, float hi_s, float t, float cap,
                                            float& lo, float& hi) {
  lo = min_nan(cap, (t == -INFINITY ? hi_s : lo_s) + t);
  hi = max_nan(-cap, (t == INFINITY ? lo_s : hi_s) + t);
}

// K5: warp w of a block takes rows (g * kBoxWarps + w) * R + r, r < R, of
// row group g = blockIdx.x, blockIdx.x + gridDim.x, ...; rows past n repeat
// row n - 1 and are not written. The vertex table lives in shared memory
// as X[tile], Y[tile], Z[tile] (tile = min(nv, kTile)).
__global__ void __launch_bounds__(32 * kBoxWarps)
robot_bounds_kernel(const float* __restrict__ poses, int64_t n,
                    const float* __restrict__ verts, int nv, float cap,
                    const float* __restrict__ obs_box, float* __restrict__ out_box,
                    uint8_t* __restrict__ out_hit) {
  constexpr int R = kBoxRows;
  extern __shared__ float smem[];
  const int tile = nv < kTile ? nv : kTile;
  float* sx = smem;
  float* sy = smem + tile;
  float* sz = smem + 2 * tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = (nv + kTile - 1) / kTile;
  const int64_t groups = (n + kBoxWarps * R - 1) / (kBoxWarps * R);

  auto stage = [&](int v0) {
    const int cnt = nv - v0 < kTile ? nv - v0 : kTile;
    for (int v = threadIdx.x; v < cnt; v += 32 * kBoxWarps) {
      sx[v] = __ldg(verts + v0 + v);
      sy[v] = __ldg(verts + nv + v0 + v);
      sz[v] = __ldg(verts + 2 * nv + v0 + v);
    }
  };
  if (n_tiles == 1) {
    stage(0);
    __syncthreads();
  }

  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t row0 = (g * kBoxWarps + warp) * R;
    float rot[R][9], lo[R][3], hi[R][3];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t b = row0 + r < n ? row0 + r : n - 1;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int j = 0; j < 3; ++j) rot[r][3 * k + j] = __ldg(poses + b * 16 + 4 * k + j);
        lo[r][k] = INFINITY;
        hi[r][k] = -INFINITY;
      }
    }
    for (int t0 = 0; t0 < nv; t0 += kTile) {
      if (n_tiles > 1) {
        __syncthreads();  // every warp is done with the previous tile
        stage(t0);
        __syncthreads();
      }
      const int cnt = nv - t0 < kTile ? nv - t0 : kTile;
      for (int v = lane; v < cnt; v += 32) {
        const float X = sx[v], Y = sy[v], Z = sz[v];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float s = rot[r][3 * k] * X + rot[r][3 * k + 1] * Y + rot[r][3 * k + 2] * Z;
            lo[r][k] = min_nan(lo[r][k], s);
            hi[r][k] = max_nan(hi[r][k], s);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[r][k] = warp_min(lo[r][k]);
        hi[r][k] = warp_max(hi[r][k]);
      }
    }
    // Lane r writes row r (every lane holds every extreme after the shuffles).
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t b = row0 + r;
      if (lane != r || b >= n) continue;
      float box[6];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (nv == 0) {
          box[k] = kBig;
          box[3 + k] = -kBig;
        } else {
          finish_axis(lo[r][k], hi[r][k], __ldg(poses + b * 16 + 4 * k + 3), cap, box[k],
                      box[3 + k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) out_box[b * 6 + k] = box[k];
      if (obs_box != nullptr) {
        bool hit = true;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          hit = hit && box[k] <= __ldg(obs_box + 3 + k) && __ldg(obs_box + k) <= box[3 + k];
        out_hit[b] = hit;
      }
    }
  }
}

// Resident K5 blocks on the whole card at a full tile's shared memory, per
// device (0 = not yet asked): asked once, not on every launch. A smaller
// table needs less shared memory, so as many blocks are resident for it (K5's
// registers limit it before its tile does: 3 blocks an SM at R = 3); and a
// grid-stride walk is right at any grid.
constexpr int kMaxDevices = 64;
std::atomic<int> box_blocks_resident[kMaxDevices];

// K5's persistent launch: min(row groups, resident blocks x SMs) blocks,
// each with the vertex table's first tile in shared memory.
cudaError_t launch_bounds(const float* poses, int64_t n, const float* verts, int nv,
                          float cap, const float* obs_box, float* out_box,
                          uint8_t* out_hit, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int resident = box_blocks_resident[dev].load(std::memory_order_relaxed);
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, robot_bounds_kernel, 32 * kBoxWarps, size_t(3) * sizeof(float) * kTile);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
    box_blocks_resident[dev].store(resident, std::memory_order_relaxed);
  }
  const size_t smem = size_t(3) * sizeof(float) * (nv < kTile ? nv : kTile);
  const int64_t groups = (n + kBoxWarps * kBoxRows - 1) / (kBoxWarps * kBoxRows);
  const unsigned blocks = unsigned(groups < resident ? groups : resident);
  robot_bounds_kernel<<<blocks, 32 * kBoxWarps, smem, stream>>>(
      poses, n, verts, nv, cap, obs_box, out_box, out_hit);
  return cudaGetLastError();
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

// K5: poses [n,16] and the vertex table verts [3,nv] f32 (nv >= 0) of a
// corner table with (padded != 0) or without padding columns -> out_box
// [n,6] f32 and, when obs_box [6] is not null, out_hit [n] uint8 (1 = the
// boxes overlap); all contiguous on the current device, on `stream`.
// Returns the launch's cudaError_t (0 = launched); does not synchronise.
int rc_robot_bounds(const float* poses, int64_t n, const float* verts, int nv, int padded,
                    const float* obs_box, float* out_box, uint8_t* out_hit,
                    cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (nv < 0 || (obs_box != nullptr && out_hit == nullptr)) return cudaErrorInvalidValue;
  return launch_bounds(poses, n, verts, nv, padded ? kBig : INFINITY, obs_box, out_box, out_hit,
                       stream);
}

}  // extern "C"
