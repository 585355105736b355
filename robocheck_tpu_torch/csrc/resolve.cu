// The float64 resolution of flagged rows on the card.
//
// K1, the fused float32 check, answers each row of a batch with one byte:
// bit 0 valid, bit 1 a live pair flagged coplanar, bit 2 a pair whose float32
// verdict rounding could flip. A valid row with bit 1 or bit 2 set is a
// verdict that float32 cannot settle. This kernel settles it in float64, as
// the host oracle `rc_oracle_check` (native/robocheck_native.cpp:556-636)
// does, and writes one byte a row: the resolved verdict, 1 collision-free,
// 0 colliding. A row that is not both valid and flagged gets bit 0 of its
// byte. It replaces no TPU kernel: the JAX package resolves flagged rows on
// the host (`oracle.resolve_coplanar`), as this port did after fetching K1's
// bytes; here the rows are resolved on the card before the one fetch.
//
// What bounds it on an H100: almost no row is flagged (1-2 of 100,000 on the
// benchmark's hard batches), so the pass over the batch is bytes (one byte
// read and one written a row), and a flagged row is latency: one block poses
// the robot in float64, culls pairs by boxes and runs the exact triangle test
// on the pairs that remain, stopping at the first hit. A first design gave
// each thread a robot triangle and walked the obstacle's groups and
// triangles from global memory: 80-280 µs a row, the loop waiting on the
// L2, and a robot triangle near the contact holding its thread (and the
// block) for hundreds of box tests. The design: each block takes tiles of
// kTile rows; in a tile it writes every row's byte, gathers the tile's
// flagged rows in shared memory and then resolves them one at a time, the
// whole block on a row. The obstacle's group and triangle boxes rounded
// outward to float32 (a prefilter: boxes they keep apart are apart in
// float64) and, where they fit too, its float64 corners are staged once in
// the block's shared memory (global memory where they do not fit). The
// robot's triangles are posed kChunk at a time into shared memory, a thread
// a triangle, its box rounded outward to float32. Each round, every thread
// tests its triangle against kRoundGroups group boxes in float32 and queues
// the pairs whose boxes meet; then the block spreads the queued pairs'
// (robot triangle, obstacle triangle) pairs evenly over its threads: the
// float32 prefilter, the oracle's float64 box test (both boxes from their
// corners, as the oracle's) and the exact test on what remains. A shared
// flag ends the row at the first intersecting pair. Two counters on the card
// (int64) count the rows resolved and those found colliding, one atomic add
// each a flagged row. Nothing waits for the host, and the host waits for
// nothing before its fetch. The tables live in global memory, so any mesh
// pair the check accepts fits.
//
// Arithmetic: float64 throughout, built with -fmad=false and without fast
// math, every operation in rc_oracle_check's order: the pose from the double
// of each float32 column, sin / cos in double and the oracle's matrix, a
// vertex p = ((R0 * v0 + R1 * v1) + R2 * v2) + t; boxes with fmin / fmax; the
// mesh-box gate over every robot vertex; the oracle's closed box test; and
// tri_tri_intersect with its coplanar 2-D path (orient2d, on_segment,
// segments_cross_2d, point_in_tri_2d) and its NaN behaviour. Culling only
// prunes pairs whose closed box test fails, so the verdict is the same
// predicate over the same pairs. The kernel's PyTorch twin
// `resolve_rows_reference` (robocheck_tpu_torch/kernels/resolve.py) makes
// the same operations as separate torch ops, so the two agree bit for bit on
// the card; the oracle on the host may contract multiply-adds and uses the
// host's sin / cos, so it is held to the kernel by its verdicts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block
constexpr int kTile = 1024;    // rows a block scans before resolving their flagged rows
constexpr int kChunk = kThreads;  // robot triangles posed into shared memory at once
constexpr int kQueue = 4096;   // (robot triangle, obstacle group) pairs a round tests
constexpr int kRoundGroups = kQueue / kChunk;  // groups a thread tests a round
constexpr int kGroup = 32;     // obstacle triangles a group box covers (GROUP in resolve.py)
constexpr int kWarps = kThreads / 32;
constexpr int kDevices = 64;   // cards whose launch limits rc_resolve keeps
constexpr unsigned kAll = 0xffffffffu;

struct Tables {
  const double* rob_verts;  // [nrv, 3] every robot vertex
  const int32_t* rob_tris;  // [nrt, 3] the robot's triangles
  const double* obs_tri;    // [nto, 9] obstacle corners c0, c1, c2 (x, y, z each)
  const float* boxes32;     // [nto + ng, 6] the triangles' boxes (lo x, y, z, hi x, y, z), then
                            // each group's (triangles [g * kGroup, min((g + 1) * kGroup, nto))),
                            // rounded outward
  const double* obs_mesh;   // [6] box of every obstacle corner
  int nrv, nrt, nto, ng;
  int staged;               // what the block copies to shared memory: 0 nothing, 1 boxes32,
                            // 2 boxes32 and obs_tri (at shared byte corners_at)
  int corners_at;
};

struct Vec3 {
  double x, y, z;
};

__device__ __forceinline__ Vec3 sub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ double dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ double comp(Vec3 v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : v.z);
}

__device__ __forceinline__ Vec3 pick(Vec3 a, Vec3 b, Vec3 c, int i) {
  return i == 0 ? a : (i == 1 ? b : c);
}

__device__ __forceinline__ double pick(double a, double b, double c, int i) {
  return i == 0 ? a : (i == 1 ? b : c);
}

__device__ __forceinline__ int dominant_axis(Vec3 v) {
  double ax = fabs(v.x), ay = fabs(v.y), az = fabs(v.z);
  if (ax >= ay && ax >= az) return 0;
  return (ay >= az) ? 1 : 2;
}

// Interval of a triangle on the planes' line, projected on axis `ax`, its
// corners permuted so that corner `alone` is by itself (the oracle's).
__device__ __forceinline__ void interval(Vec3 t0, Vec3 t1, Vec3 t2, double e0, double e1,
                                         double e2, int ax, int alone, double* lo, double* hi) {
  int o1 = (alone + 1) % 3, o2 = (alone + 2) % 3;
  double pa = comp(pick(t0, t1, t2, alone), ax), pb = comp(pick(t0, t1, t2, o1), ax),
         pc = comp(pick(t0, t1, t2, o2), ax);
  double da = pick(e0, e1, e2, alone), db = pick(e0, e1, e2, o1), dc = pick(e0, e1, e2, o2);
  double ta = pa + (pb - pa) * da / (da - db);
  double tb = pa + (pc - pa) * da / (da - dc);
  *lo = ta < tb ? ta : tb;
  *hi = ta < tb ? tb : ta;
}

__device__ __forceinline__ int alone_corner(double e0, double e1, double e2) {
  if (e0 * e1 > 0) return 2;
  if (e0 * e2 > 0) return 1;
  return 0;
}

__device__ __forceinline__ double orient2d(double ax, double ay, double bx, double by, double cx,
                                           double cy) {
  return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
}

__device__ __forceinline__ bool on_segment(double px, double py, double qx, double qy, double rx,
                                           double ry) {
  return fmin(px, qx) <= rx && rx <= fmax(px, qx) && fmin(py, qy) <= ry && ry <= fmax(py, qy);
}

__device__ bool segments_cross_2d(double p1x, double p1y, double p2x, double p2y, double p3x,
                                  double p3y, double p4x, double p4y) {
  double d1 = orient2d(p3x, p3y, p4x, p4y, p1x, p1y);
  double d2 = orient2d(p3x, p3y, p4x, p4y, p2x, p2y);
  double d3 = orient2d(p1x, p1y, p2x, p2y, p3x, p3y);
  double d4 = orient2d(p1x, p1y, p2x, p2y, p4x, p4y);
  if (((d1 > 0) != (d2 > 0)) && ((d3 > 0) != (d4 > 0)) && d1 != 0 && d2 != 0 && d3 != 0 &&
      d4 != 0)
    return true;
  if (d1 == 0 && on_segment(p3x, p3y, p4x, p4y, p1x, p1y)) return true;
  if (d2 == 0 && on_segment(p3x, p3y, p4x, p4y, p2x, p2y)) return true;
  if (d3 == 0 && on_segment(p1x, p1y, p2x, p2y, p3x, p3y)) return true;
  if (d4 == 0 && on_segment(p1x, p1y, p2x, p2y, p4x, p4y)) return true;
  return false;
}

__device__ __forceinline__ bool point_in_tri_2d(double px, double py, const double tx[3],
                                                const double ty[3]) {
  double o1 = orient2d(tx[0], ty[0], tx[1], ty[1], px, py);
  double o2 = orient2d(tx[1], ty[1], tx[2], ty[2], px, py);
  double o3 = orient2d(tx[2], ty[2], tx[0], ty[0], px, py);
  return (o1 >= 0 && o2 >= 0 && o3 >= 0) || (o1 <= 0 && o2 <= 0 && o3 <= 0);
}

__device__ bool coplanar_overlap(Vec3 a0, Vec3 a1, Vec3 a2, Vec3 b0, Vec3 b1, Vec3 b2, Vec3 n) {
  int ax = dominant_axis(n);
  int u = (ax + 1) % 3, v = (ax + 2) % 3;
  double aux[3] = {comp(a0, u), comp(a1, u), comp(a2, u)};
  double auy[3] = {comp(a0, v), comp(a1, v), comp(a2, v)};
  double bux[3] = {comp(b0, u), comp(b1, u), comp(b2, u)};
  double buy[3] = {comp(b0, v), comp(b1, v), comp(b2, v)};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (segments_cross_2d(aux[i], auy[i], aux[(i + 1) % 3], auy[(i + 1) % 3], bux[j], buy[j],
                            bux[(j + 1) % 3], buy[(j + 1) % 3]))
        return true;
  if (point_in_tri_2d(aux[0], auy[0], bux, buy)) return true;
  if (point_in_tri_2d(bux[0], buy[0], aux, auy)) return true;
  return false;
}

__device__ bool tri_tri_intersect(Vec3 a0, Vec3 a1, Vec3 a2, Vec3 b0, Vec3 b1, Vec3 b2) {
  Vec3 n1 = cross(sub(a1, a0), sub(a2, a0));
  double d1 = -dot(n1, a0);
  Vec3 n2 = cross(sub(b1, b0), sub(b2, b0));
  double d2 = -dot(n2, b0);
  double e0 = dot(n2, a0) + d2, e1 = dot(n2, a1) + d2, e2 = dot(n2, a2) + d2;  // a vs plane(b)
  double f0 = dot(n1, b0) + d1, f1 = dot(n1, b1) + d1, f2 = dot(n1, b2) + d1;  // b vs plane(a)
  if ((e0 > 0 && e1 > 0 && e2 > 0) || (e0 < 0 && e1 < 0 && e2 < 0)) return false;
  if ((f0 > 0 && f1 > 0 && f2 > 0) || (f0 < 0 && f1 < 0 && f2 < 0)) return false;
  if (e0 == 0 && e1 == 0 && e2 == 0) return coplanar_overlap(a0, a1, a2, b0, b1, b2, n1);
  int ax = dominant_axis(cross(n1, n2));
  double lo1, hi1, lo2, hi2;
  interval(a0, a1, a2, e0, e1, e2, ax, alone_corner(e0, e1, e2), &lo1, &hi1);
  interval(b0, b1, b2, f0, f1, f2, ax, alone_corner(f0, f1, f2), &lo2, &hi2);
  return !(hi1 < lo2 || hi2 < lo1);
}

// The oracle's closed box test of box a (lo x, y, z, hi x, y, z) against box
// b (true where a NaN makes every compare false); on boxes rounded outward to
// float32, a prefilter: false only where the float64 boxes are apart too.
template <typename T>
__device__ __forceinline__ bool box_overlap(const T* a, const T* b) {
  return !(a[0] > b[3] || b[0] > a[3] || a[1] > b[4] || b[1] > a[4] || a[2] > b[5] ||
           b[2] > a[5]);
}

// A triangle's box as the oracle builds it: per axis, fmin / fmax from
// +-1e300 over the corners (c: 9 doubles, x, y, z a corner).
__device__ __forceinline__ void tri_box(const double* c, double* box) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    box[k] = fmin(fmin(fmin(1e300, c[k]), c[3 + k]), c[6 + k]);
    box[3 + k] = fmax(fmax(fmax(-1e300, c[k]), c[3 + k]), c[6 + k]);
  }
}

__device__ __forceinline__ Vec3 load3(const double* p) { return {p[0], p[1], p[2]}; }

// The pose (R row-major, then t) applied to a vertex.
__device__ __forceinline__ Vec3 posed(const double* pose, Vec3 v) {
  return {pose[0] * v.x + pose[1] * v.y + pose[2] * v.z + pose[9],
          pose[3] * v.x + pose[4] * v.y + pose[5] * v.z + pose[10],
          pose[6] * v.x + pose[7] * v.y + pose[8] * v.z + pose[11]};
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmin(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmax(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// Whether the configuration `conf` (6 float32) is collision-free, by the whole
// block; every thread returns the same. `boxes32` and `obs_tri` are the
// tables' or their copies in shared memory.
__device__ bool resolve_row(const float* conf, const Tables& t, const float* boxes32,
                            const double* obs_tri) {
  __shared__ double trig[6];             // sin, cos of pitch, yaw, roll
  __shared__ double pose[12];
  __shared__ double red[kWarps][6];
  __shared__ double corners[kChunk][9];  // the chunk's posed robot triangles
  __shared__ float rbox[kChunk][6];      // and their boxes, rounded outward
  __shared__ int queue[kQueue];          // (group << 16) | chunk triangle
  __shared__ int queued[2];              // a round's count, and the next round's
  __shared__ int gate;
  __shared__ volatile int hit;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 3) {
    const double angle = conf[3 + tid];
    trig[2 * tid] = sin(angle);
    trig[2 * tid + 1] = cos(angle);
  }
  __syncthreads();
  if (tid == 0) {
    const double sb = trig[0], cb = trig[1], sa = trig[2], ca = trig[3], sc = trig[4],
                 cc = trig[5];
    pose[0] = ca * cb;
    pose[1] = ca * sb * sc - sa * cc;
    pose[2] = ca * sb * cc + sa * sc;
    pose[3] = sa * cb;
    pose[4] = sa * sb * sc + ca * cc;
    pose[5] = sa * sb * cc - ca * sc;
    pose[6] = -sb;
    pose[7] = cb * sc;
    pose[8] = cb * cc;
    pose[9] = conf[0];
    pose[10] = conf[1];
    pose[11] = conf[2];
    hit = 0;
    queued[0] = queued[1] = 0;
  }
  __syncthreads();

  // The mesh-box gate over every robot vertex, as the oracle's.
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int v = tid; v < t.nrv; v += kThreads) {
    Vec3 p = posed(pose, load3(t.rob_verts + 3 * v));
    lo[0] = fmin(lo[0], p.x), hi[0] = fmax(hi[0], p.x);
    lo[1] = fmin(lo[1], p.y), hi[1] = fmax(hi[1], p.y);
    lo[2] = fmin(lo[2], p.z), hi[2] = fmax(hi[2], p.z);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = warp_min(lo[k]);
    hi[k] = warp_max(hi[k]);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) red[warp][k] = lo[k], red[warp][3 + k] = hi[k];
  }
  __syncthreads();
  if (tid == 0) {
    bool in = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      double l = red[0][k], h = red[0][3 + k];
      for (int w = 1; w < kWarps; ++w) l = fmin(l, red[w][k]), h = fmax(h, red[w][3 + k]);
      in = in && l <= t.obs_mesh[3 + k] && t.obs_mesh[k] <= h;
    }
    gate = in;
  }
  __syncthreads();
  if (!gate) return true;

  // `hit` is read in the loops' conditions only between barriers, where
  // every thread sees the same value.
  const float* groups32 = boxes32 + 6 * t.nto;
  int round = 0;
  for (int c0 = 0; c0 < t.nrt && !hit; c0 += kChunk) {
    const int cn = min(kChunk, t.nrt - c0);
    float box32[6];
    if (tid < cn) {
      const int32_t* tri = t.rob_tris + 3 * (c0 + tid);
      double* c = corners[tid];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Vec3 a = posed(pose, load3(t.rob_verts + 3 * tri[j]));
        c[3 * j] = a.x;
        c[3 * j + 1] = a.y;
        c[3 * j + 2] = a.z;
      }
      double box[6];
      tri_box(c, box);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        box32[k] = rbox[tid][k] = __double2float_rd(box[k]);
        box32[3 + k] = rbox[tid][3 + k] = __double2float_ru(box[3 + k]);
      }
    }
    __syncthreads();
    for (int g0 = 0; g0 < t.ng && !hit; g0 += kRoundGroups, ++round) {
      // A round: each thread queues the groups of [g0, g0 + kRoundGroups)
      // whose boxes meet its triangle's.
      int* count = &queued[round & 1];
      if (tid == 0) queued[(round + 1) & 1] = 0;  // the last round's, read before its barrier
      if (tid < cn) {
        const int g1 = min(t.ng, g0 + kRoundGroups);
        for (int g = g0; g < g1; ++g)
          if (box_overlap(box32, groups32 + 6 * g)) queue[atomicAdd(count, 1)] = (g << 16) | tid;
      }
      __syncthreads();
      // Their (robot triangle, obstacle triangle) pairs, evenly over the block.
      const int total = *count * kGroup;
      for (int w = tid; w < total && !hit; w += kThreads) {
        const int e = queue[w / kGroup];
        const int r = e & 0xffff, s = (e >> 16) * kGroup + w % kGroup;
        if (s >= t.nto || !box_overlap(rbox[r], boxes32 + 6 * s)) continue;
        const double* a = corners[r];
        const double* b = obs_tri + 9 * s;
        double abox[6], bbox[6];
        tri_box(a, abox);
        tri_box(b, bbox);
        if (box_overlap(abox, bbox) &&
            tri_tri_intersect(load3(a), load3(a + 3), load3(a + 6), load3(b), load3(b + 3),
                              load3(b + 6)))
          hit = 1;
      }
      __syncthreads();
    }
  }
  const bool valid = !hit;
  __syncthreads();  // every thread has read `hit` before the next row resets it
  return valid;
}

__global__ void __launch_bounds__(kThreads, 1)
    resolve_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ confs, int64_t n,
                   Tables t, uint8_t* __restrict__ out, unsigned long long* counts) {
  extern __shared__ __align__(16) unsigned char staged[];  // what t.staged says
  __shared__ int rows[kTile];
  __shared__ int count;
  bool copied = false;
  for (int64_t base = (int64_t)blockIdx.x * kTile; base < n;
       base += (int64_t)gridDim.x * kTile) {
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    const int len = (int)min((int64_t)kTile, n - base);
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const unsigned b = packed[base + i];
      out[base + i] = (uint8_t)(b & 1u);
      if ((b & 1u) && (b & 6u)) rows[atomicAdd(&count, 1)] = i;
    }
    __syncthreads();
    const int k = count;
    float* boxes = reinterpret_cast<float*>(staged);
    double* tris = reinterpret_cast<double*>(staged + t.corners_at);
    if (k && t.staged && !copied) {
      for (int i = threadIdx.x; i < 6 * (t.nto + t.ng); i += kThreads) boxes[i] = t.boxes32[i];
      if (t.staged == 2)
        for (int i = threadIdx.x; i < 9 * t.nto; i += kThreads) tris[i] = t.obs_tri[i];
      __syncthreads();
      copied = true;
    }
    for (int j = 0; j < k; ++j) {
      const int64_t row = base + rows[j];
      const bool valid = resolve_row(confs + 6 * row, t, t.staged ? boxes : t.boxes32,
                                     t.staged == 2 ? tris : t.obs_tri);
      if (threadIdx.x == 0) {
        out[row] = valid ? 1 : 0;
        atomicAdd(counts, 1ull);
        if (!valid) atomicAdd(counts + 1, 1ull);
      }
    }
    __syncthreads();  // `count` and `rows` are reused by the next tile
  }
}

}  // namespace

extern "C" {

const char* rc_resolve_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// One launch on `stream`: packed [n] uint8 (K1's bytes), confs [n, 6] float32
// (the batch on the card), the float64 tables and the float32 boxes rounded
// outward (Tables), out [n] uint8 (the resolved verdicts) and counts [2] int64
// (rows resolved, rows found colliding; added to). The boxes, and then the
// obstacle's corners, are staged in shared memory where they fit beside the
// kernel's own. Returns the launch's cudaError_t.
int rc_resolve(const uint8_t* packed, const float* confs, int64_t n, const double* rob_verts,
               int nrv, const int32_t* rob_tris, int nrt, const double* obs_tri, int nto,
               const float* boxes32, int ng, const double* obs_mesh, uint8_t* out,
               unsigned long long* counts, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (ng != (nto + kGroup - 1) / kGroup) return (int)cudaErrorInvalidValue;
  // The card's opt-in shared memory and the kernel's own, read once a device;
  // the dynamic limit raised once a device to the most a launch asks.
  static int optin[kDevices], static_smem[kDevices], max_dyn[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (!optin[dev]) {
    cudaFuncAttributes attr;
    int limit = 0;
    err = cudaFuncGetAttributes(&attr, resolve_kernel);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    static_smem[dev] = (int)attr.sharedSizeBytes;
    max_dyn[dev] = attr.maxDynamicSharedSizeBytes;
    optin[dev] = limit;  // last: a nonzero limit marks the entry read
  }
  const size_t room = (size_t)(optin[dev] - static_smem[dev]);
  const size_t boxes = sizeof(float) * 6 * ((size_t)nto + ng);
  const size_t corners_at = (boxes + 15) / 16 * 16;
  const size_t both = corners_at + sizeof(double) * 9 * (size_t)nto;
  const int staged = both <= room ? 2 : (boxes <= room ? 1 : 0);
  const size_t dyn = staged == 2 ? both : (staged ? boxes : 0);
  if ((int)dyn > max_dyn[dev]) {
    err = cudaFuncSetAttribute(resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn);
    if (err != cudaSuccess) return (int)err;
    max_dyn[dev] = (int)dyn;
  }
  Tables t{rob_verts, rob_tris, obs_tri, boxes32, obs_mesh, nrv, nrt, nto, ng, staged,
           (int)corners_at};
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int grid = (int)(tiles < 65535 ? tiles : 65535);
  resolve_kernel<<<grid, kThreads, dyn, stream>>>(packed, confs, n, t, out, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
