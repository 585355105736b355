// Stage-isolating probe kernels of the fused check, with the launch shape of
// its first design.
//
// Replace the Pallas probe kernels of the JAX package's bisection scripts:
//   P1 `mini_kernel`, `mini_kernel_t` (scripts/bisect_stage1.py:73,117):
//      K1's stage 1 one piece at a time (`pose_probe`);
//   P2 `kern` in `run` (scripts/bisect_stage2.py:67): an empty K1-shaped
//      grid with invariant inputs, scratch, batch and configurations per
//      block toggled (`empty_probe`);
//   P3 `kern_manual`, `kern_smem`, `kern_auto` (scripts/bisect_stage3.py:
//      56,81,100): three ways to bring an invariant table into the kernel
//      (`invariant_dma`, `invariant_const`, `invariant_ldg`).
// Their plain PyTorch versions are in robocheck_tpu_torch/profiling/probes.py;
// each probe computes the same float32 operations as its plain version, so the
// two agree exactly.
//
// Launch shape, unless a probe says otherwise: that of the fused kernel K1's
// first design (one 256-thread block per configuration with the posed robot
// in shared memory), grid-stride over the batch, with that design's dynamic
// shared memory (`k1_smem_bytes` in profiling/probes.py, ~78 KB for the
// alpha-1.0 tables), so two blocks are resident per SM. The probes are
// instruments of those costs, as the TPU probes are of the TPU kernel's;
// their shape is that design's on purpose, not the fastest for the little
// work each does, and stays fixed so that their times stay comparable.
//
// What bounds each, and what the design does about it:
//   * P2 is launch- and scheduling-bound: a block does a 64-byte pose read
//     and a 512-byte row write, so its time is block dispatch and, with the
//     table switches on, the per-configuration copy of the tables into
//     shared memory (float4 loads, whole block, L2-resident after the first
//     wave). Configurations per block (1 or 8, one warp each) and the
//     shared-memory allocation (0 or K1's) set how many blocks are resident.
//   * P3 and P1 levels 0-2 are bound by L2 and L1 latency: each
//     configuration's chain is pose load -> table reads -> (block reduction)
//     -> store, with little arithmetic. P3's modes differ only in where the
//     table comes from: `cp.async` into shared memory once per persistent
//     block (2 x SM count blocks), the constant cache, or `__ldg` per
//     configuration through L1 (how K1's first design reads rob_base).
//   * P1 level 3 is bound by shared-memory bandwidth and bank conflicts: 19
//     fields per triangle, written field-major ([19][Tr], consecutive lanes on
//     consecutive banks, conflict-free) as K1's first design does; the
//     transposed probe writes triangle-major ([Tr][20], 80 B per triangle),
//     whose 20-float stride puts 4 lanes of a warp on each bank used (4-way
//     conflicts).
//
// Level 1 keeps the corner transforms of every triangle live by folding their
// bits into a word that is stored only when rt_false (an argument, always 0)
// is set; nothing multiplies a table value by a runtime zero.
//
// Arithmetic: built like megakernel.cu, -fmad=false and no fast math.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOutCols = 128;   // output row: int32 [B, 128], as the TPU probes
// Posed fields of K1's first design: corners 0-8, n 9-11, d 12, lo 13-15, hi 16-18.
constexpr int kRobFields = 19;
constexpr int kTStride = 20;    // triangle-major row of the transposed probe (80 B)
constexpr int kTransposed = 4;  // pose_probe level of the triangle-major writes
constexpr float kBig = 3.0e38f;

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

int grid_for(int64_t blocks) { return int(blocks < 65535 ? blocks : 65535); }

// ---- P1: K1's stage 1, one piece at a time (bisect_stage1.py:73-136). ----
//   level 0: acc = pose0
//   level 1: + corner transforms of every robot triangle; acc += c0x[l]
//   level 2: + masked boxes, block reduction to the mesh box; acc += broad
//            against the [-1,1]^3 cube
//   level 3: + the 19 posed fields of K1's first design, field-major [19][Tr];
//            acc += smem[0][l]
//   kTransposed: corners, planes and boxes written triangle-major
//            [Tr][20]; out = c0x[l] + smem[l][0]
// out[b][l] = int(acc), l < 128 (thread l poses triangle l first).
template <int kLevel>
__global__ void __launch_bounds__(kThreads)
pose_probe(const float* __restrict__ poses, int64_t n, const float* __restrict__ rob_base,
           int tr, int rt_false, int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  float* fields = smem;                          // [19][tr] or [tr][20]
  float* red = smem + size_t(kTStride) * tr;     // [kWarps][6]
  float* mesh = red + kWarps * 6;                // [6] (+2 pad)
  float* pose = mesh + 8;                        // [12] (+4 pad)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* rob_real = rob_base + 9 * tr;

  for (int64_t b = blockIdx.x; b < n; b += gridDim.x) {
    __syncthreads();
    if (tid < 12) pose[tid] = poses[b * 16 + tid];
    __syncthreads();
    float p[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) p[k] = pose[k];
    float acc = p[0];
    float c0x_own = 0.f;  // c0x of triangle tid (tid < 128 writes the output)
    unsigned keep = 0u;   // level 1: bits of every corner
    float m_lo[3] = {kBig, kBig, kBig}, m_hi[3] = {-kBig, -kBig, -kBig};

    if constexpr (kLevel >= 1) {
      for (int r = tid; r < tr; r += kThreads) {
        float c[9];
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {  // K1's order (megakernel.cu, pose stage)
          const float X = rob_base[(3 * cc) * tr + r];
          const float Y = rob_base[(3 * cc + 1) * tr + r];
          const float Z = rob_base[(3 * cc + 2) * tr + r];
          c[3 * cc + 0] = p[0] * X + p[1] * Y + p[2] * Z + p[3];
          c[3 * cc + 1] = p[4] * X + p[5] * Y + p[6] * Z + p[7];
          c[3 * cc + 2] = p[8] * X + p[9] * Y + p[10] * Z + p[11];
        }
        if (r == tid) c0x_own = c[0];
        if constexpr (kLevel == 1) {
#pragma unroll
          for (int f = 0; f < 9; ++f) keep ^= __float_as_uint(c[f]);
        }
        if constexpr (kLevel >= 2 && kLevel != kTransposed) {
          const bool real = rob_real[r] > 0.f;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float lo = min_nan(min_nan(c[k], c[3 + k]), c[6 + k]);
            const float hi = max_nan(max_nan(c[k], c[3 + k]), c[6 + k]);
            m_lo[k] = min_nan(m_lo[k], warp_min(real ? lo : kBig));
            m_hi[k] = max_nan(m_hi[k], warp_max(real ? hi : -kBig));
          }
        }
        if constexpr (kLevel == 3 || kLevel == kTransposed) {
          const float e1x = c[3] - c[0], e1y = c[4] - c[1], e1z = c[5] - c[2];
          const float e2x = c[6] - c[3], e2y = c[7] - c[4], e2z = c[8] - c[5];
          float v[kRobFields];
#pragma unroll
          for (int f = 0; f < 9; ++f) v[f] = c[f];
          v[9] = e1y * e2z - e1z * e2y;
          v[10] = e1z * e2x - e1x * e2z;
          v[11] = e1x * e2y - e1y * e2x;
          v[12] = -(v[9] * c[0] + v[10] * c[1] + v[11] * c[2]);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            v[13 + k] = min_nan(min_nan(c[k], c[3 + k]), c[6 + k]);
            v[16 + k] = max_nan(max_nan(c[k], c[3 + k]), c[6 + k]);
          }
#pragma unroll
          for (int f = 0; f < kRobFields; ++f) {
            if constexpr (kLevel == kTransposed)
              fields[size_t(r) * kTStride + f] = v[f];
            else
              fields[size_t(f) * tr + r] = v[f];
          }
        }
      }
    }
    if constexpr (kLevel == kTransposed) {
      if (tid < kOutCols)
        out[b * kOutCols + tid] = int32_t(c0x_own + fields[size_t(tid) * kTStride]);
      continue;
    }
    if constexpr (kLevel >= 1) acc = acc + c0x_own;
    if constexpr (kLevel == 1) {
      if (rt_false && tid < kOutCols) out[b * kOutCols + tid] = int32_t(keep);
    }
    if constexpr (kLevel >= 2) {
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
      bool broad = true;
#pragma unroll
      for (int k = 0; k < 3; ++k) broad = broad && mesh[k] <= 1.f && -1.f <= mesh[3 + k];
      acc = acc + (broad ? 1.f : 0.f);
    }
    if constexpr (kLevel >= 3) {
      if (tid < kOutCols) acc = acc + fields[tid];  // field 0 (c0x), triangle tid
    }
    if (tid < kOutCols && !(kLevel == 1 && rt_false)) out[b * kOutCols + tid] = int32_t(acc);
  }
}

// ---- P2: an empty K1-shaped grid (bisect_stage2.py:53-96). ----
// Each block takes kCpb configurations at a time (1: the whole block, as
// K1; 8: one warp each), copies the enabled tables into shared memory after
// `scratch_floats` floats of unused allocation, and writes int(pose0) across
// each configuration's output row.
template <int kCpb>
__global__ void __launch_bounds__(kThreads)
empty_probe(const float* __restrict__ poses, int64_t n, const float4* __restrict__ rob,
            int rob_f4, const float4* __restrict__ obs, int obs_f4,
            const float4* __restrict__ groups, int groups_f4, int scratch_floats,
            int32_t* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float4* s_rob = smem4 + scratch_floats / 4;
  float4* s_obs = s_rob + rob_f4;
  float4* s_groups = s_obs + obs_f4;
  const int tid = threadIdx.x;
  const int64_t n_blocks = (n + kCpb - 1) / kCpb;
  for (int64_t blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    __syncthreads();
    for (int i = tid; i < rob_f4; i += kThreads) s_rob[i] = __ldg(rob + i);
    for (int i = tid; i < obs_f4; i += kThreads) s_obs[i] = __ldg(obs + i);
    for (int i = tid; i < groups_f4; i += kThreads) s_groups[i] = __ldg(groups + i);
    __syncthreads();
    if constexpr (kCpb == 1) {
      if (tid < kOutCols) out[blk * kOutCols + tid] = int32_t(poses[blk * 16]);
    } else {
      const int64_t b = blk * kCpb + (tid >> 5);
      if ((tid >> 5) < kCpb && b < n) {
        const int32_t v = int32_t(poses[b * 16]);
        for (int l = tid & 31; l < kOutCols; l += 32) out[b * kOutCols + l] = v;
      }
    }
  }
}

// ---- P3: an invariant table three ways (bisect_stage3.py:55-115). ----
__constant__ float c_table[64];  // the 8 x 8 table of `invariant_const`

// Persistent blocks copy table row 0 (and the rest of the [rows, cols]
// table) into shared memory once with cp.async, then stride over
// configurations: out[b][l] = int(pose0 * tab[0][l]).
__global__ void __launch_bounds__(kThreads)
invariant_dma(const float* __restrict__ poses, int64_t n, const float* __restrict__ table,
              int table_floats, int32_t* __restrict__ out) {
  extern __shared__ float s_tab[];
  for (int i = threadIdx.x * 4; i < table_floats; i += kThreads * 4)
    __pipeline_memcpy_async(s_tab + i, table + i, 16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int tid = threadIdx.x;
  for (int64_t b = blockIdx.x; b < n; b += gridDim.x)
    if (tid < kOutCols) out[b * kOutCols + tid] = int32_t(poses[b * 16] * s_tab[tid]);
}

// out[b][l] = int(pose0 * tab[0][0]) from the constant cache.
__global__ void __launch_bounds__(kThreads)
invariant_const(const float* __restrict__ poses, int64_t n, int32_t* __restrict__ out) {
  const int tid = threadIdx.x;
  for (int64_t b = blockIdx.x; b < n; b += gridDim.x)
    if (tid < kOutCols) out[b * kOutCols + tid] = int32_t(poses[b * 16] * c_table[0]);
}

// out[b][l] = int(pose0 * tab[0][l]), row 0 read with __ldg per configuration.
__global__ void __launch_bounds__(kThreads)
invariant_ldg(const float* __restrict__ poses, int64_t n, const float* __restrict__ table,
              int32_t* __restrict__ out) {
  const int tid = threadIdx.x;
  for (int64_t b = blockIdx.x; b < n; b += gridDim.x)
    if (tid < kOutCols)
      out[b * kOutCols + tid] = int32_t(poses[b * 16] * __ldg(table + tid));
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int kLevel>
int launch_pose(const float* poses, int64_t n, const float* rob_base, int tr, int rt_false,
                int32_t* out, size_t smem, cudaStream_t stream) {
  cudaError_t err = set_smem(pose_probe<kLevel>, smem);
  if (err != cudaSuccess) return err;
  pose_probe<kLevel><<<grid_for(n), kThreads, smem, stream>>>(poses, n, rob_base, tr,
                                                              rt_false, out);
  return cudaGetLastError();
}

template <int kCpb>
int launch_empty(const float* poses, int64_t n, const float* rob, int rob_floats,
                 const float* obs, int obs_floats, const float* groups, int groups_floats,
                 int scratch_floats, int32_t* out, cudaStream_t stream) {
  const size_t smem = 4 * size_t(scratch_floats + rob_floats + obs_floats + groups_floats);
  cudaError_t err = set_smem(empty_probe<kCpb>, smem);
  if (err != cudaSuccess) return err;
  empty_probe<kCpb><<<grid_for((n + kCpb - 1) / kCpb), kThreads, smem, stream>>>(
      poses, n, reinterpret_cast<const float4*>(rob), rob_floats / 4,
      reinterpret_cast<const float4*>(obs), obs_floats / 4,
      reinterpret_cast<const float4*>(groups), groups_floats / 4, scratch_floats, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of pose_probe for a robot table of `tr` rows (the
// triangle-major layout is the larger; the wrapper takes the larger of this
// and K1's).
int64_t rc_pose_probe_smem_bytes(int tr) {
  return 4 * (int64_t(kTStride) * tr + kWarps * 6 + 8 + 16);
}

// P1: poses [n,16], rob_base [10,tr] f32 -> out [n,128] int32. level 0-3, or
// 4 for the triangle-major writes. rt_false must be 0. smem >= the bytes
// above. Returns the launch's cudaError_t; does not synchronise.
int rc_pose_probe(const float* poses, int64_t n, const float* rob_base, int tr, int level,
                  int rt_false, int32_t* out, int64_t smem, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (tr < kOutCols || tr % 32 != 0 || smem < rc_pose_probe_smem_bytes(tr))
    return cudaErrorInvalidValue;
  switch (level) {
    case 0: return launch_pose<0>(poses, n, rob_base, tr, rt_false, out, smem, stream);
    case 1: return launch_pose<1>(poses, n, rob_base, tr, rt_false, out, smem, stream);
    case 2: return launch_pose<2>(poses, n, rob_base, tr, rt_false, out, smem, stream);
    case 3: return launch_pose<3>(poses, n, rob_base, tr, rt_false, out, smem, stream);
    case kTransposed:
      return launch_pose<kTransposed>(poses, n, rob_base, tr, rt_false, out, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// P2: poses [n,16] -> out [n,128] int32. Each table pointer may be null
// (its float count 0); counts are multiples of 4 and pointers 16-byte
// aligned. scratch_floats (a multiple of 4) of shared memory are allocated
// and left unused. cpb is 1 or 8.
int rc_empty_probe(const float* poses, int64_t n, const float* rob, int rob_floats,
                   const float* obs, int obs_floats, const float* groups, int groups_floats,
                   int scratch_floats, int cpb, int32_t* out, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if ((rob_floats | obs_floats | groups_floats | scratch_floats) % 4 != 0)
    return cudaErrorInvalidValue;
  if (cpb == 1)
    return launch_empty<1>(poses, n, rob, rob_floats, obs, obs_floats, groups,
                           groups_floats, scratch_floats, out, stream);
  if (cpb == 8)
    return launch_empty<8>(poses, n, rob, rob_floats, obs, obs_floats, groups,
                           groups_floats, scratch_floats, out, stream);
  return cudaErrorInvalidValue;
}

// P3: poses [n,16] -> out [n,128] int32. mode 0: `table` [rows, >=128] f32
// copied whole into shared memory by 2 x SM-count persistent blocks (smem
// bytes >= its size); mode 1: `table` is the 8 x 8 table, copied to
// constant memory on `stream` first; mode 2: row 0 of `table` read with
// __ldg per configuration.
int rc_invariant_probe(const float* poses, int64_t n, const float* table, int table_floats,
                       int mode, int32_t* out, int64_t smem, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  cudaError_t err;
  switch (mode) {
    case 0: {
      if (table_floats % 4 != 0 || smem < 4 * int64_t(table_floats))
        return cudaErrorInvalidValue;
      int dev = 0, sms = 0;
      if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
        return err;
      if ((err = set_smem(invariant_dma, smem)) != cudaSuccess) return err;
      const int64_t blocks = 2 * int64_t(sms);
      invariant_dma<<<grid_for(blocks < n ? blocks : n), kThreads, smem, stream>>>(
          poses, n, table, table_floats, out);
      return cudaGetLastError();
    }
    case 1:
      if (table_floats != 64) return cudaErrorInvalidValue;
      if ((err = cudaMemcpyToSymbolAsync(c_table, table, 64 * sizeof(float), 0,
                                         cudaMemcpyDeviceToDevice, stream)) != cudaSuccess)
        return err;
      if ((err = set_smem(invariant_const, smem)) != cudaSuccess) return err;
      invariant_const<<<grid_for(n), kThreads, smem, stream>>>(poses, n, out);
      return cudaGetLastError();
    case 2:
      if ((err = set_smem(invariant_ldg, smem)) != cudaSuccess) return err;
      invariant_ldg<<<grid_for(n), kThreads, smem, stream>>>(poses, n, table, out);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
