// Stage-isolating probe kernels of the fused check K1.
//
// Replace the Pallas probe kernels of the JAX package's bisection scripts:
//   P1 `mini_kernel`, `mini_kernel_t` (scripts/bisect_stage1.py:73,117):
//      K1's pose pass one piece at a time (`pose_probe`);
//   P2 `kern` in `run` (scripts/bisect_stage2.py:67): an empty kernel of K1's
//      launch shape with its tables, shared memory, batch and rows per warp
//      toggled (`empty_probe`);
//   P3 `kern_manual`, `kern_smem`, `kern_auto` (scripts/bisect_stage3.py:
//      56,81,100): three ways to bring an invariant table into the kernel
//      (`invariant_probe`, an instance a mode).
// Their plain PyTorch versions are in robocheck_tpu_torch/profiling/probes.py;
// each probe computes the same float32 operations as its plain version, so the
// two agree exactly.
//
// P1-P3 run on K1's launch shape (csrc/megakernel.cu `launch`), so that
// they split the cost of the kernel that runs: 512-thread blocks, one
// resident per SM, of 4 teams of 4 warps; a grid of min(row groups,
// resident blocks x SMs) with the occupancy queried at the shared memory
// allocated; rows taken one at a time from an atomic counter (zeroed by
// cudaMemsetAsync in each launch), the next one fetched ahead; the row's 16
// pose floats read into the team's shared slot between two named team
// barriers; output rows written as 16-byte stores. P1 and P2's `scratch`
// pieces allocate exactly K1's shared memory for the tables, P3 K1's plus
// its table's overhang, and all of them hold K1's blocks per SM: K1's one
// block an SM comes from its registers (126-128 a thread), which the probes
// do not need, so their launch also sets the shared-memory carveout to the
// smallest that holds K1's resident blocks. K1's shared-memory layout and
// device helpers are copied here (namespace k1), operation for operation,
// and so are K4's bulk-copy and mbarrier helpers (csrc/clearance.cu).
//
// What bounds each on an H100, and what the design does about it:
//   * P2 moves 64 B of pose in and 512 B out a row and computes nothing: it
//     is bound by K1's skeleton: a row's atomic on the one row counter, whose
//     same-address updates serialise (its floor rises with the teams that
//     contend), two team barriers, a dependent pose load and the store; and,
//     per launch, by the attribute call, the occupancy query, the memset and
//     the staging of the tables into shared memory once per block (the robot
//     corners transposed into 33-float slots, the obstacle boxes as a
//     structure of arrays, the group boxes), which K1 pays too. Its time
//     against batch size gives K1's per-row floor (slope) and fixed cost
//     (intercept).
//   * P1 is K1's pose pass: lane l poses robot tile l of each block of 32
//     tiles, the tile's 32 triangles split over the team's warps (K1's
//     `pose_tri` and `tri_box`, in K1's order), reading the staged table
//     from shared memory. Its levels are bound by the latency of that chain
//     (pose load -> 1,024 corner transforms a row over 128 threads, 9
//     shared-memory reads a triangle -> tile boxes meeting in shared memory
//     -> mesh box), well under the card's float32 rate; level 3 adds one
//     shared store a triangle, a warp's 32 lanes on 32 consecutive words
//     (lane = tile); `mini_writes_transposed` writes the same fields with
//     stride 32, the layout without K1's padding, which changes only the
//     read-back of 128 of them by columns (4 consecutive triangles a thread,
//     8-way bank conflicts). K1's padding serves its sweep, where lane =
//     triangle.
//   * P3 runs on the same shape, over P2's skeleton, with one read of a
//     configuration-invariant table a row (the 128 floats of its row 0,
//     which the row's 128 multiplies take): its modes differ only in where
//     the table comes from. `manual_dma` copies the whole [16, Tr] table
//     into shared memory once per block with the Tensor Memory
//     Accelerator's bulk copy (`cp.async.bulk`, completed on an mbarrier:
//     one thread issues it, no thread spends a register on it), and serves
//     rows from there; `smem_invariant` reads the 8 x 8 table's first word
//     from constant memory, one broadcast a row (the TPU's scalar memory);
//     `auto` reads row 0 through the read-only path (`ld.global.nc`), as K1
//     reads its obstacle rows. Each mode's row read is one volatile load, so
//     the compiler keeps it in the row loop. P3 is bound by P2's skeleton:
//     on an H100 (700 W) the row's read hides under it from every source,
//     and `manual_dma`'s 64 KB copy a block, from L2 after the first block,
//     adds ~0.6 us a launch (PERF.md section 6). Its shared memory is
//     K1's layout with the table at float 0 and the team slots moved past
//     its end: K1's allocation plus the table's overhang over K1's tables,
//     so that it holds K1's blocks per SM as P1 does.
//
// Level 1 keeps the corner transforms of every triangle live by folding their
// bits into a word that is stored only when rt_false (an argument, always 0)
// is set; the transposed piece keeps its broad flag live the same way.
// Nothing multiplies a table value by a runtime zero.
//
// Arithmetic: built like megakernel.cu, -fmad=false and no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOutCols = 128;   // output row: int32 [B, 128], as the TPU probes
constexpr int kTransposed = 4;  // pose_probe level of the stride-32 stores
constexpr float kBig = 3.0e38f;

// ---- K1's geometry, layout and pose-pass helpers (csrc/megakernel.cu), and
// the probes P1-P3 on K1's launch shape. ----
namespace k1 {

constexpr int kWarps = 4;  // warps sharing one row
constexpr int kRows = 4;   // rows in flight per block, one per team
constexpr int kTeamThreads = 32 * kWarps;
constexpr int kThreads = kTeamThreads * kRows;
constexpr int kRobTile = 32;
constexpr int kGroup = 128;
constexpr int kObsCols = 20;
constexpr int kObsLo = 13;
constexpr int kPad = 33;
constexpr int kTileBlock = 32 * kPad;
constexpr int kQueue = 64;
constexpr int kCtlWords = 11;  // K1's `Ctl` words a team (cWords)
constexpr unsigned kAll = 0xffffffffu;

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

// Triangle t in one field of the transposed table: triangle k of tile l of
// a 32-tile block at k * kPad + l.
__device__ __forceinline__ int rob_slot(int t) {
  return (t >> 10) * kTileBlock + (t & 31) * kPad + ((t >> 5) & 31);
}

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

// Barrier of the kTeamWarps warps of team t (named barrier t + 1).
template <int kTeamWarps>
__device__ __forceinline__ void team_sync(int t) {
  if constexpr (kTeamWarps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(t + 1), "r"(32 * kTeamWarps) : "memory");
}

// K1's `Layout` (floats) for tr robot and to obstacle rows.
struct Layout {
  int n_tiles, n_groups, to, fs;
  __host__ __device__ Layout(int tr, int to_, int groups)
      : n_tiles(tr / kRobTile), n_groups(groups), to(to_),
        fs(((tr / kRobTile + 31) / 32) * kTileBlock) {}
  __host__ __device__ int obox() const { return 9 * fs; }
  __host__ __device__ int gbox() const { return obox() + 6 * to; }
  __host__ __device__ int realw() const { return gbox() + 6 * n_groups; }
  __host__ __device__ int row_floats() const {
    const int part = kWarps * 6 * 32, queues = kWarps * 2 * kQueue;
    return kCtlWords + 16 + 6 * n_tiles + n_tiles * n_groups + (part > queues ? part : queues);
  }
  __host__ __device__ int ctl(int t) const { return realw() + n_tiles + t * row_floats(); }
  __host__ __device__ int pose(int t) const { return ctl(t) + kCtlWords; }
  __host__ __device__ int tile_box(int t) const { return pose(t) + 16; }
  __host__ __device__ int items(int t) const { return tile_box(t) + 6 * n_tiles; }
  __host__ __device__ int scratch(int t) const { return items(t) + n_tiles * n_groups; }
  __host__ __device__ size_t bytes() const { return 4 * size_t(ctl(kRows)); }
};

// K1's staging of the robot table: corners into the transposed, padded
// slots, real-triangle bits one word a tile.
__device__ __forceinline__ void stage_robot(const float* __restrict__ rob_base, int tr, int fs,
                                            float* rob_s, unsigned* realw) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 9 * tr; i += kThreads) {
    const int f = i / tr, t = i - f * tr;
    rob_s[f * fs + rob_slot(t)] = rob_base[i];
  }
  for (int tile = warp; tile < tr / kRobTile; tile += kThreads / 32) {
    const unsigned w = __ballot_sync(kAll, rob_base[9 * tr + tile * kRobTile + lane] > 0.f);
    if (lane == 0) realw[tile] = w;
  }
}

// ---- P1: K1's pose pass, one piece at a time (bisect_stage1.py:73-136). ----
// Shared memory: K1's layout for (tr, n_groups): the robot table, the real
// bits and each team's row word, pose, tile boxes and partial-box scratch
// where K1 keeps them; team t's c0x field ([32 tiles][32 triangles] per
// tile block, stride kPad, or 32 in the transposed piece) at
// obox + t * fs, in the space of K1's obstacle and group boxes, which P1
// does not stage.
struct PoseMap {
  Layout L;
  explicit __host__ __device__ PoseMap(int tr, int n_groups)
      : L(tr, n_groups * kGroup, n_groups) {}
  __host__ __device__ int c0x(int t) const { return L.obox() + t * L.fs; }
  __host__ __device__ bool fits() const { return c0x(kRows) <= L.realw(); }
  __host__ __device__ int part_end(int t) const {
    return L.scratch(t) + kWarps * 6 * 32;
  }
};

//   level 0: acc = pose0
//   level 1: + corner transforms of every robot triangle; acc += c0x[l]
//   level 2: + tile boxes meeting in the team's scratch, the mesh box and
//            the broad flag against the [-1,1]^3 cube; acc += broad
//   level 3: + c0x of every triangle stored in the padded layout (levels
//            1-2 store only the 128 the output reads); acc += c0x[l] read
//            back
//   kTransposed: level 3's work and stores with stride 32;
//            out = c0x[l] + c0x[l] read back
// out[b][l] = int(acc), l < 128. Triangle l is posed by lane l / 32 of warp
// (l % 32) % 4; the thread writing columns 4i..4i+3 reads their c0x from
// shared memory.
template <int kLevel>
__global__ void __launch_bounds__(kThreads, 1)
pose_probe(const float* __restrict__ poses, int n, const float* __restrict__ rob_base, int tr,
           int n_groups, int rt_false, int32_t* __restrict__ out, int* __restrict__ work) {
  constexpr int kStride = kLevel == kTransposed ? 32 : kPad;  // c0x slot stride
  constexpr bool kBoxes = kLevel >= 2, kStoreAll = kLevel >= 3;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const PoseMap M(tr, n_groups);
  const Layout& L = M.L;
  const int n_tiles = L.n_tiles, fs = L.fs;
  float* rob_s = smem;
  unsigned* realw = reinterpret_cast<unsigned*>(smem + L.realw());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = warp / kWarps, twarp = warp % kWarps, ttid = tid % kTeamThreads;
  volatile int* ctl = reinterpret_cast<int*>(smem + L.ctl(team));
  float* pose = smem + L.pose(team);
  float* tile_box = smem + L.tile_box(team);
  float* part = smem + L.scratch(team);
  float* c0x = smem + M.c0x(team);

  stage_robot(rob_base, tr, fs, rob_s, realw);
  __syncthreads();
  int next_row = 0;
  if (ttid == 0) next_row = atomicAdd(work, 1);

  for (;;) {
    if (ttid == 0) {
      ctl[0] = next_row;
      next_row = atomicAdd(work, 1);
    }
    team_sync<kWarps>(team);
    const int b = ctl[0];
    if (b >= n) break;
    if (ttid < 16) pose[ttid] = __ldg(poses + size_t(b) * 16 + ttid);
    team_sync<kWarps>(team);
    float p[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) p[k] = pose[k];
    unsigned keep = 0u;  // level 1: bits of every corner
    bool broad = true;

    if constexpr (kLevel >= 1) {
      for (int tb = 0; tb * 32 < n_tiles; ++tb) {
        const int tile = tb * 32 + lane;
        float t[6] = {kBig, kBig, kBig, -kBig, -kBig, -kBig};
        if (tile < n_tiles) {
          const float* base = rob_s + tb * kTileBlock + lane;
          float* field = c0x + tb * 32 * kStride + lane;
          const unsigned rw = kBoxes ? realw[tile] : 0u;
#pragma unroll
          for (int j = 0; j < (kRobTile + kWarps - 1) / kWarps; ++j) {
            const int k = twarp + kWarps * j;
            if (k >= kRobTile) break;
            float c[9];
            pose_tri(base + k * kPad, fs, p, c);
            if (kStoreAll || tile < kOutCols / kRobTile) field[k * kStride] = c[0];
            if constexpr (kLevel == 1) {
#pragma unroll
              for (int f = 0; f < 9; ++f) keep ^= __float_as_uint(c[f]);
            }
            if constexpr (kBoxes) {
              float box[6];
              tri_box(c, box);
              const bool real = (rw >> k) & 1u;
#pragma unroll
              for (int ax = 0; ax < 3; ++ax) {
                t[ax] = min_nan(t[ax], real ? box[ax] : kBig);
                t[3 + ax] = max_nan(t[3 + ax], real ? box[3 + ax] : -kBig);
              }
            }
          }
        }
        if constexpr (kBoxes) {
#pragma unroll
          for (int k = 0; k < 6; ++k) part[(twarp * 6 + k) * 32 + lane] = t[k];
          team_sync<kWarps>(team);
          for (int e = ttid; e < 6 * 32; e += kTeamThreads) {
            const int k = e >> 5;
            float v = part[e];
            for (int w = 1; w < kWarps; ++w) {
              const float x = part[w * 6 * 32 + e];
              v = k < 3 ? min_nan(v, x) : max_nan(v, x);
            }
            if (tb * 32 + lane < n_tiles) tile_box[(tb * 32 + lane) * 6 + k] = v;
          }
          team_sync<kWarps>(team);
        }
      }
      if constexpr (kBoxes) {
        // K1's mesh-box broad phase, against the [-1,1]^3 cube.
        float m[6] = {kBig, kBig, kBig, -kBig, -kBig, -kBig};
        for (int tile = lane; tile < n_tiles; tile += 32) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            m[k] = min_nan(m[k], tile_box[tile * 6 + k]);
            m[3 + k] = max_nan(m[3 + k], tile_box[tile * 6 + 3 + k]);
          }
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
          broad = broad && warp_min(m[k]) <= 1.f && -1.f <= warp_max(m[3 + k]);
      } else {
        team_sync<kWarps>(team);  // the 128 c0x the writers read
      }
    }

    if (ttid < kOutCols / 4) {
      int v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = 4 * ttid + q;
        float acc = p[0];
        if constexpr (kLevel >= 1) {
          const float cx = c0x[(l & 31) * kStride + (l >> 5)];
          if constexpr (kLevel == kTransposed) {
            acc = cx + cx;
          } else {
            acc = acc + cx;
            if constexpr (kBoxes) acc = acc + (broad ? 1.f : 0.f);
            if constexpr (kStoreAll) acc = acc + cx;
          }
        }
        v[q] = int32_t(acc);
        if (kLevel == 1 && rt_false) v[q] = int32_t(keep);
        if (kLevel == kTransposed && rt_false) v[q] = broad;
      }
      reinterpret_cast<int4*>(out + size_t(b) * kOutCols)[ttid] =
          make_int4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ---- P2: an empty kernel of K1's shape (bisect_stage2.py:53-96). ----
// Shared memory (floats): the staged tables (each at K1's offset with
// `scratch`, else packed in order, only those passed), then one slot a row
// in flight: its row word and pose (K1's team control words and pose with
// `scratch`, whose allocation is K1's whole layout).
struct EmptyMap {
  int tr, to, n_groups, fs;
  int rob, realw, obox, gbox;    // offsets, -1 where that table is not staged
  int slot, slot_floats, pose;   // row r's word at slot + r * slot_floats, pose + 16 after it
  int end;
};

EmptyMap empty_map(int tr, int to, int n_groups, bool rob, bool obs, bool groups, bool scratch,
                   int rows) {
  const Layout L(tr, to, n_groups);
  EmptyMap m{tr, to, n_groups, L.fs, -1, -1, -1, -1, 0, 0, 0, 0};
  if (scratch) {
    if (rob) {
      m.rob = 0;
      m.realw = L.realw();
    }
    if (obs) m.obox = L.obox();
    if (groups) m.gbox = L.gbox();
    m.slot = L.ctl(0);
    m.slot_floats = L.row_floats();
    m.pose = kCtlWords;
    m.end = L.ctl(kRows);
    return m;
  }
  int at = 0;
  if (rob) {
    m.rob = at;
    m.realw = at + 9 * L.fs;
    at = m.realw + L.n_tiles;
  }
  if (obs) {
    m.obox = at;
    at += 6 * to;
  }
  if (groups) {
    m.gbox = at;
    at += 6 * n_groups;
  }
  m.slot = at;
  m.slot_floats = 1 + 16;
  m.pose = 1;
  m.end = at + rows * m.slot_floats;
  return m;
}

// kTeamWarps warps a row (4: K1's team; 1: a row a warp, 16 in flight);
// out[b][l] = int(pose0), written by the row's first 32 threads, 4 columns
// each.
template <int kTeamWarps>
__global__ void __launch_bounds__(kThreads, 1)
empty_probe(const float* __restrict__ poses, int n, const float* __restrict__ rob,
            const float* __restrict__ obs, const float* __restrict__ groups, EmptyMap m,
            int32_t* __restrict__ out, int* __restrict__ work) {
  constexpr int kRowThreads = 32 * kTeamWarps;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int team = tid / kRowThreads, ttid = tid % kRowThreads;
  if (m.rob >= 0)
    stage_robot(rob, m.tr, m.fs, smem + m.rob, reinterpret_cast<unsigned*>(smem + m.realw));
  if (m.obox >= 0) {
    for (int i = tid; i < 6 * m.to; i += kThreads) {
      const int s = i / m.to, o = i - s * m.to;
      smem[m.obox + i] = obs[size_t(o) * kObsCols + kObsLo + s];
    }
  }
  if (m.gbox >= 0)
    for (int i = tid; i < 6 * m.n_groups; i += kThreads) smem[m.gbox + i] = groups[i];
  __syncthreads();
  volatile int* ctl = reinterpret_cast<int*>(smem + m.slot + team * m.slot_floats);
  float* pose = smem + m.slot + team * m.slot_floats + m.pose;
  int next_row = 0;
  if (ttid == 0) next_row = atomicAdd(work, 1);
  for (;;) {
    if (ttid == 0) {
      ctl[0] = next_row;
      next_row = atomicAdd(work, 1);
    }
    team_sync<kTeamWarps>(team);
    const int b = ctl[0];
    if (b >= n) break;
    if (ttid < 16) pose[ttid] = __ldg(poses + size_t(b) * 16 + ttid);
    team_sync<kTeamWarps>(team);
    if (ttid < kOutCols / 4) {
      const int v = int32_t(pose[0]);
      reinterpret_cast<int4*>(out + size_t(b) * kOutCols)[ttid] = make_int4(v, v, v, v);
    }
  }
}

// ---- P3: an invariant table three ways (bisect_stage3.py:55-115). ----
constexpr int kDma = 0, kConst = 1, kLdg = 2;  // modes, as INVARIANT_MODES codes them
constexpr int kTableRows = 16;                 // the script's [16, Tr] table
// The most bytes one mbarrier transaction counts (its tx-count, 2^20 - 1),
// to a multiple of 16: the largest bulk copy issued.
constexpr unsigned kTxMax = (1u << 20) - 16;

// P3's shared memory (floats): the [16, tr] table at 0, then K1's layout
// for (tr, n_groups) from its team slots on, `shift` floats later, where
// the table overhangs K1's tables (656 floats for the probes' tables). The
// bulk copy's mbarrier takes 8 bytes of team 0's control words, past its
// row word.
struct InvariantMap {
  Layout L;
  int table, shift;
  __host__ __device__ InvariantMap(int tr, int n_groups)
      : L(tr, n_groups * kGroup, n_groups), table(kTableRows * tr),
        shift(kTableRows * tr > L.ctl(0) ? kTableRows * tr - L.ctl(0) : 0) {}
  __host__ __device__ int ctl(int t) const { return L.ctl(t) + shift; }
  __host__ __device__ int pose(int t) const { return L.pose(t) + shift; }
  __host__ __device__ int bar() const { return (ctl(0) + 3) & ~1; }  // 8-byte aligned
  __host__ __device__ int end() const { return ctl(kRows); }
};

// K4's bulk-copy and mbarrier helpers (csrc/clearance.cu).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return unsigned(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
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

// A row's table read, one volatile load each: 16 bytes of shared memory,
// 16 bytes through the read-only path, one word of constant memory (at
// state-space addresses).
__device__ __forceinline__ float4 ld_shared4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_u32(p)));
  return v;
}
__device__ __forceinline__ float4 ld_nc4(size_t global_addr) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(global_addr));
  return v;
}
__device__ __forceinline__ float ld_const(size_t const_addr) {
  float v;
  asm volatile("ld.const.f32 %0, [%1];\n" : "=f"(v) : "l"(const_addr));
  return v;
}

__constant__ float c_table[64];  // the 8 x 8 table of `smem_invariant`

// P2's skeleton (K1's team a row, the row counter, the pose between two team
// barriers), and a row's table read by the 32 writers:
//   kDma:   out[b][l] = int(pose0 * tab[0][l]), tab bulk-copied into shared
//           memory (table_floats of it) once per block;
//   kConst: out[b][l] = int(pose0 * tab[0][0]), tab in constant memory;
//   kLdg:   out[b][l] = int(pose0 * tab[0][l]), row 0 by ld.global.nc.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
invariant_probe(const float* __restrict__ poses, int n, const float* __restrict__ table,
                int table_floats, InvariantMap m, int32_t* __restrict__ out,
                int* __restrict__ work) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int team = tid / kTeamThreads, ttid = tid % kTeamThreads;
  if constexpr (kMode == kDma) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + m.bar());
    if (tid == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const unsigned bytes = 4u * unsigned(table_floats);
      mbar_arrive_tx(bar, bytes);
      for (unsigned at = 0; at < bytes; at += kTxMax)
        bulk_copy(smem + at / 4, table + at / 4, bytes - at < kTxMax ? bytes - at : kTxMax,
                  bar);
    }
    __syncthreads();  // the barrier is initialised before any thread waits on it
    mbar_wait(bar, 0);
  }
  const size_t row0 = __cvta_generic_to_global(table) + 16 * size_t(ttid);
  const size_t tab00 = __cvta_generic_to_constant(c_table);
  volatile int* ctl = reinterpret_cast<int*>(smem + m.ctl(team));
  float* pose = smem + m.pose(team);
  int next_row = 0;
  if (ttid == 0) next_row = atomicAdd(work, 1);
  for (;;) {
    if (ttid == 0) {
      ctl[0] = next_row;
      next_row = atomicAdd(work, 1);
    }
    team_sync<kWarps>(team);
    const int b = ctl[0];
    if (b >= n) break;
    if (ttid < 16) pose[ttid] = __ldg(poses + size_t(b) * 16 + ttid);
    team_sync<kWarps>(team);
    if (ttid < kOutCols / 4) {
      const float p0 = pose[0];
      float4 t;
      if constexpr (kMode == kDma) {
        t = ld_shared4(smem + 4 * ttid);
      } else if constexpr (kMode == kLdg) {
        t = ld_nc4(row0);
      } else {
        const float c = ld_const(tab00);
        t = make_float4(c, c, c, c);
      }
      reinterpret_cast<int4*>(out + size_t(b) * kOutCols)[ttid] =
          make_int4(int32_t(p0 * t.x), int32_t(p0 * t.y), int32_t(p0 * t.z), int32_t(p0 * t.w));
    }
  }
}

// K1's launch shape for `kernel` over n rows, `rows` in flight a block, with
// `smem` bytes of dynamic shared memory: sets the attribute and queries the
// occupancy as K1's `launch` does; grid = min(row groups, resident blocks x
// SMs). With resident > 0 it first sets the shared-memory carveout to the
// smallest that holds `resident` blocks: K1's residency, which K1's
// registers set, for a probe that needs fewer registers.
struct Shape {
  int per_sm, grid;
};
template <typename Kernel>
cudaError_t shape(Kernel kernel, int64_t n, int rows, size_t smem, int resident, Shape* s) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if (resident > 0) {
    int sm_bytes = 0, reserved = 0;
    if ((err = cudaDeviceGetAttribute(&sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                                      dev)) != cudaSuccess)
      return err;
    const int64_t need = int64_t(resident) * (int64_t(smem) + reserved);
    const int64_t pct = (100 * need + sm_bytes - 1) / sm_bytes;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    int(pct < 100 ? pct : 100))) != cudaSuccess)
      return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s->per_sm, kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (s->per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t want = (n + rows - 1) / rows;
  s->grid = int(want < int64_t(s->per_sm) * sms ? want : int64_t(s->per_sm) * sms);
  return cudaSuccess;
}

// K1's launch: shape, zero the row counter, launch on `stream`.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int64_t n, int rows, size_t smem, int resident, int* work,
           cudaStream_t stream, Args... args) {
  Shape s;
  cudaError_t err = shape(kernel, n, rows, smem, resident, &s);
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(work, 0, sizeof(int), stream)) != cudaSuccess) return err;
  kernel<<<s.grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The shape above and the kernel's registers and local (spill and stack)
// bytes: out = {block, smem, blocks per SM, grid, registers, local bytes}.
template <typename Kernel>
int shape_query(Kernel kernel, int64_t n, int rows, size_t smem, int resident, int* out) {
  Shape s;
  cudaError_t err = shape(kernel, n, rows, smem, resident, &s);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  const int v[6] = {kThreads, int(smem), s.per_sm, s.grid, attr.numRegs,
                    int(attr.localSizeBytes)};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return cudaSuccess;
}

bool pose_args_ok(int64_t n, int tr, int n_groups) {
  return n <= (int64_t(1) << 30) && tr >= kOutCols && tr % kRobTile == 0 && tr < 65536 &&
         n_groups > 0 && n_groups * kGroup < 65536 && PoseMap(tr, n_groups).fits();
}

bool empty_args_ok(int64_t n, int tr, int to, int n_groups, bool scratch, int cpb) {
  return n <= (int64_t(1) << 30) && tr > 0 && tr % kRobTile == 0 && tr < 65536 &&
         to >= 0 && to < 65536 && n_groups >= 0 && (cpb == 1 || (cpb == 8 && !scratch));
}

// P3's layout for (tr, n_groups), and a table of table_floats for `mode`:
// the [16, tr] table's region at most (and whole float4s) for kDma, the
// 8 x 8 table for kConst, at least row 0's 128 floats for kDma and kLdg.
bool invariant_args_ok(int64_t n, int tr, int n_groups, int mode, int table_floats) {
  if (!(n <= (int64_t(1) << 30) && tr >= kOutCols && tr % kRobTile == 0 && tr < 65536 &&
        n_groups > 0 && n_groups * kGroup < 65536))
    return false;
  switch (mode) {
    case kDma:
      return table_floats >= kOutCols && table_floats % 4 == 0 &&
             table_floats <= InvariantMap(tr, n_groups).table;
    case kConst: return table_floats == 64;
    case kLdg: return table_floats >= kOutCols;
    default: return false;
  }
}

// Rows in flight a block of empty_probe: 4 teams, or 16 warps at cpb 8.
int empty_rows(int cpb) { return cpb == 8 ? kThreads / 32 : kRows; }

// Bytes a P1 launch needs at least: the end of its map (the last team's
// partial boxes).
int64_t pose_map_bytes(int tr, int n_groups) {
  return 4 * int64_t(PoseMap(tr, n_groups).part_end(kRows - 1));
}

// The P1 instance of a level, the P2 instance of a mapping, the P3 instance
// of a mode (nullptr if none).
using PoseKernel = void (*)(const float*, int, const float*, int, int, int, int32_t*, int*);
using EmptyKernel = void (*)(const float*, int, const float*, const float*, const float*,
                             EmptyMap, int32_t*, int*);
PoseKernel pose_kernel(int level) {
  switch (level) {
    case 0: return pose_probe<0>;
    case 1: return pose_probe<1>;
    case 2: return pose_probe<2>;
    case 3: return pose_probe<3>;
    case kTransposed: return pose_probe<kTransposed>;
    default: return nullptr;
  }
}
EmptyKernel empty_kernel(int cpb) {
  return cpb == 1 ? empty_probe<kWarps> : cpb == 8 ? empty_probe<1> : nullptr;
}
using InvariantKernel = void (*)(const float*, int, const float*, int, InvariantMap, int32_t*,
                                 int*);
InvariantKernel invariant_kernel(int mode) {
  switch (mode) {
    case kDma: return invariant_probe<kDma>;
    case kConst: return invariant_probe<kConst>;
    case kLdg: return invariant_probe<kLdg>;
    default: return nullptr;
  }
}

}  // namespace k1

}  // namespace

extern "C" {

// The regions (first float, floats) of a probe's shared memory, in order,
// as {start, floats} pairs in out[2 * cap]; returns their count, or -1 for
// arguments the probe refuses. probe 0 (P1): rob, realw, then per team row
// word, pose, tile boxes, partial boxes, c0x field. probe 1 (P2): of rob,
// realw, obox, gbox those staged (tables: bit 0 rob, 1 obs, 2 groups), then
// per row in flight its row word and pose. probe 2 (P3; to, tables,
// scratch and cpb unused): the [16, tr] table, the mbarrier, then per team
// its row word and pose.
int rc_probe_map(int probe, int tr, int to, int n_groups, int tables, int scratch, int cpb,
                 int* out, int cap) {
  int k = 0;
  auto put = [&](int start, int floats) {
    if (k < cap) {
      out[2 * k] = start;
      out[2 * k + 1] = floats;
    }
    ++k;
  };
  if (probe == 0) {
    if (!k1::pose_args_ok(1, tr, n_groups)) return -1;
    const k1::PoseMap M(tr, n_groups);
    const k1::Layout& L = M.L;
    put(0, 9 * L.fs);
    put(L.realw(), L.n_tiles);
    for (int t = 0; t < k1::kRows; ++t) {
      put(L.ctl(t), 1);
      put(L.pose(t), 16);
      put(L.tile_box(t), 6 * L.n_tiles);
      put(L.scratch(t), k1::kWarps * 6 * 32);
      put(M.c0x(t), L.fs);
    }
    return k;
  }
  if (probe == 2) {
    if (!k1::invariant_args_ok(1, tr, n_groups, k1::kLdg, kOutCols)) return -1;
    const k1::InvariantMap m(tr, n_groups);
    put(0, m.table);
    put(m.bar(), 2);
    for (int t = 0; t < k1::kRows; ++t) {
      put(m.ctl(t), 1);
      put(m.pose(t), 16);
    }
    return k;
  }
  if (probe != 1 || !k1::empty_args_ok(1, tr, to, n_groups, scratch, cpb)) return -1;
  const k1::EmptyMap m = k1::empty_map(tr, to, n_groups, tables & 1, tables & 2, tables & 4,
                                       scratch, k1::empty_rows(cpb));
  if (m.rob >= 0) {
    put(m.rob, 9 * m.fs);
    put(m.realw, tr / k1::kRobTile);
  }
  if (m.obox >= 0) put(m.obox, 6 * to);
  if (m.gbox >= 0) put(m.gbox, 6 * n_groups);
  for (int r = 0; r < k1::empty_rows(cpb); ++r) {
    put(m.slot + r * m.slot_floats, 1);
    put(m.slot + r * m.slot_floats + m.pose, 16);
  }
  return k;
}

// P1: poses [n,16], rob_base [10,tr] f32 -> out [n,128] int32 (16-byte
// aligned). level 0-3, or 4 for the stride-32 stores. n_groups sets K1's
// layout; work: one int32 on the device (the row counter, zeroed here);
// rt_false must be 0; smem >= the end of its map; resident: the
// blocks an SM to hold the launch to (K1's), 0 for as many as fit. Returns
// the launch's cudaError_t; does not synchronise.
int rc_pose_probe(const float* poses, int64_t n, const float* rob_base, int tr, int n_groups,
                  int level, int rt_false, int32_t* out, int* work, int64_t smem, int resident,
                  cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (!k1::pose_args_ok(n, tr, n_groups) || smem < k1::pose_map_bytes(tr, n_groups))
    return cudaErrorInvalidValue;
  const k1::PoseKernel kernel = k1::pose_kernel(level);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  return k1::launch(kernel, n, k1::kRows, smem, resident, work, stream, poses, int(n),
                    rob_base, tr, n_groups, rt_false, out, work);
}

// P2: poses [n,16] -> out [n,128] int32 (16-byte aligned). rob [10,tr],
// obs [to,20] and groups [n_groups,6] f32 may each be null (not staged);
// tr, to and n_groups set the layout all the same. scratch: K1's layout
// (cpb 1 only); cpb 1: a team of 4 warps a row, 8: a warp a row. work,
// smem and resident as rc_pose_probe's.
int rc_empty_probe(const float* poses, int64_t n, const float* rob, int tr, const float* obs,
                   int to, const float* groups, int n_groups, int scratch, int cpb,
                   int32_t* out, int* work, int64_t smem, int resident, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (!k1::empty_args_ok(n, tr, to, n_groups, scratch, cpb)) return cudaErrorInvalidValue;
  const k1::EmptyMap m =
      k1::empty_map(tr, to, n_groups, rob, obs, groups, scratch, k1::empty_rows(cpb));
  if (smem < 4 * int64_t(m.end)) return cudaErrorInvalidValue;
  return k1::launch(k1::empty_kernel(cpb), n, k1::empty_rows(cpb), smem, resident, work,
                    stream, poses, int(n), rob, obs, groups, m, out, work);
}

// The launch shape of a P1 level (probe 0, variant = level), a P2 mapping
// (probe 1, variant = cpb) or a P3 mode (probe 2, variant = mode) over n
// rows with smem bytes and resident, as
// the launch computes it, and the instance's registers and local bytes:
// out[6] = {block, smem, blocks per SM, grid, registers, local bytes}.
int rc_probe_shape(int probe, int variant, int64_t n, int64_t smem, int resident, int* out) {
  if (probe == 0 && k1::pose_kernel(variant) != nullptr)
    return k1::shape_query(k1::pose_kernel(variant), n, k1::kRows, size_t(smem), resident,
                           out);
  if (probe == 1 && k1::empty_kernel(variant) != nullptr)
    return k1::shape_query(k1::empty_kernel(variant), n, k1::empty_rows(variant), size_t(smem),
                           resident, out);
  if (probe == 2 && k1::invariant_kernel(variant) != nullptr)
    return k1::shape_query(k1::invariant_kernel(variant), n, k1::kRows, size_t(smem), resident,
                           out);
  return cudaErrorInvalidValue;
}

// P3: poses [n,16] -> out [n,128] int32 (16-byte aligned), on K1's launch
// shape. mode 0: `table` (table_floats, whole float4s, at most [16, tr])
// bulk-copied into shared memory once per block; mode 1: `table` is the
// 8 x 8 table, copied to constant memory on `stream` first; mode 2: row 0 of
// `table` (at least 128 floats) read through the read-only path a row. tr
// and n_groups set the layout; work, smem (at least the end of the map) and
// resident as rc_pose_probe's.
int rc_invariant_probe(const float* poses, int64_t n, const float* table, int table_floats,
                       int mode, int tr, int n_groups, int32_t* out, int* work, int64_t smem,
                       int resident, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (!k1::invariant_args_ok(n, tr, n_groups, mode, table_floats)) return cudaErrorInvalidValue;
  const k1::InvariantMap m(tr, n_groups);
  if (smem < 4 * int64_t(m.end())) return cudaErrorInvalidValue;
  if (mode == k1::kConst) {
    const cudaError_t err = cudaMemcpyToSymbolAsync(k1::c_table, table, 64 * sizeof(float), 0,
                                                    cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return err;
  }
  return k1::launch(k1::invariant_kernel(mode), n, k1::kRows, smem, resident, work, stream,
                    poses, int(n), table, table_floats, m, out, work);
}

}  // extern "C"
