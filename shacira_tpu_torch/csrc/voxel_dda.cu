// Kernel V1: the bounded DDA walk of the 'voxel' march on Hopper.
//
// Computes shacira_tpu/accel/occupancy.py::voxel_crossings, which is no
// Pallas kernel: the JAX package runs the walk as a lax.scan of 3 * res + 2
// dependent steps (vmapped over rays), then compacts the occupied steps
// into [R, I] slots with a cumsum and one scatter.
//
// Per ray r: clip [dist_min, dist_max] to the ray's [-1, 1]^3 box
// interval [tmin, tmax], then from t = tmin step cell by cell:
//     p     = fma(d, t + eps, o)                eps = 1e-6
//     cell  = floor((p * 0.5 + 0.5) * res)      (clamped for the lookup)
//     exit  = max(min_a((bound_a - o_a) / d_a), t + eps)
// and record (t, min(exit, tmax)) in the next free slot when the cell is
// inside the grid, t < tmax and the cell is occupied; then t = exit.  The
// first I such crossings, in depth order, fill entries / exits [R, I];
// valid[r, k] = k < count; slots past the count hold 0, as the JAX
// scatter leaves them.
//
// What bounds it.  The bytes are few (one occupancy byte a step walked,
// the rays, the [R, I] slots: ~1 us at 3.35 TB/s) and so are the f32
// operations (~33 a step).  A ray's steps form one dependent chain and a
// training step's 4096 rays are 128 warps of rays, about one for each SM:
// nothing hides a step's latency but the warp's own instructions.  So the
// time is the longest walk times the time a warp takes for one step of it,
// and that time is set by instruction issue and latency of a single warp:
// the three IEEE divisions of a step (each an RCP, four FMAs, a range
// check and a branch) are about half of it, the cell's floor and clamp and
// the exit's min / max most of the rest.  The design takes everything else
// off the walking warp:
//
// 1. Walk ahead, read together.  The walk's geometry (t, the cell, the
//    exit) does not depend on the occupancy; the occupancy decides only
//    whether a step is recorded and where the walk stops once it has I
//    crossings.  So the walk goes kLookahead steps at a time, and the
//    batch's occupancy reads are issued back to back afterwards: an L2
//    read's latency falls once per batch instead of once per step.
// 2. A walker warp and a recorder warp.  Each block of 32 rays has two
//    warps: the walker walks batch b (one t a step into shared memory)
//    while the recorder records batch b - 1 (each step's cell recomputed
//    from its t with the walker's arithmetic, so the same cell; the
//    batch's reads; the crossings in order).  The walker stops a ray at
//    t >= tmax, at the last step, or at I crossings by the recorder's
//    count of two batches back; the steps it walks past the stop are
//    never recorded.
// 3. Warps spread over SMs: a block is 32 rays (64 threads), so a
//    step's 4096 rays reach 128 SMs.
// 4. Coalesced output.  The recorder stages a ray's first kStageSlots
//    crossings in shared memory (an odd row stride: lanes writing equal
//    counts hit distinct banks); then both warps write the block's 32
//    consecutive [I]-rows of entries, exits and valid as one flat run,
//    consecutive threads on consecutive addresses, zeros past each count.
//    Crossings beyond kStageSlots (I > 64) go straight to their slots.
//
// Not used, measured slower (PERF.md §6): exit faces cached per axis
// with one division a step for the face two cells ahead (its selects and
// rare-path branch cost more issue slots than the two divisions saved);
// one warp that walks a batch and then records it; 8 or 32 steps a batch;
// 64 rays a block.
//
// Exactness: the cell comes from a floor, so whether a product and a sum
// are rounded once (FMA) or twice can move a crossing into the neighbouring
// cell.  The reference's XLA contracts o + d * (t + eps) into one FMA and
// fuses nothing else whose rounding matters (the other products are exact
// powers-of-two scalings), so the kernel computes exactly that one
// product-sum as __fmaf_rn and every other product and sum as an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn: never
// contracted), with IEEE division (__fdiv_rn), in the order of the scan
// body; locate() and face_t() are that body, shared by the walker and the
// recorder.  A step is recorded only if t < tmax, it is one of the first
// 3 * res + 2 and fewer than I crossings came before it: exactly the steps
// the sequential walk records, whatever the walker computed past its
// stop.  The plain PyTorch version beside the wrapper emulates the one FMA
// (occupancy.fma_f32), and the two agree bit for bit.  The reference's
// stall (a direction component in (-1e-9, 0]: its divisor is +1e-9 and
// its face lies behind, so t crawls by eps) is walked as it is.
//
// The launch goes on the caller's stream; the return value is
// cudaGetLastError() (0 on success).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLookahead = 16;     // steps a batch
constexpr int kThreads = 64;       // a walker and a recorder warp
constexpr int kStageSlots = 64;    // crossings staged a ray
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-6f;

// Crossings staged per ray and the odd row stride of the staging rows.
__host__ __device__ inline int staged_slots(int max_isect) {
  return max_isect < kStageSlots ? max_isect : kStageSlots;
}
__host__ __device__ inline int stage_stride(int max_isect) {
  return staged_slots(max_isect) | 1;
}
// Shared words of a block's 32 rays: two batches of kLookahead + 1 t
// values a lane, two count rows, the batch flags, the staged crossings.
__host__ __device__ inline int block_words(int max_isect) {
  return 32 * (2 * (kLookahead + 1) + 3 + 2 * stage_stride(max_isect));
}

struct Line {
  float o[3], d[3], sd[3];
};

// The ray's [dist_min, dist_max] clipped to its [-1, 1]^3 box interval.
__device__ __forceinline__ void box_interval(const Line& L, float dmin,
                                             float dmax, float& tmin,
                                             float& tmax) {
  tmin = -INFINITY;
  tmax = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = __fdiv_rn(__fsub_rn(-1.0f, L.o[a]), L.sd[a]);
    const float t1 = __fdiv_rn(__fsub_rn(1.0f, L.o[a]), L.sd[a]);
    tmin = fmaxf(tmin, fminf(t0, t1));
    tmax = fminf(tmax, fmaxf(t0, t1));
  }
  tmin = fmaxf(tmin, dmin);
  tmax = fminf(tmax, dmax);
}

// The clamped cell of the point at te = t + eps, and whether the unclamped
// cell lies inside the grid: the scan body's arithmetic.
__device__ __forceinline__ void locate(const Line& L, float te, float fres,
                                       float x[3], bool& inside) {
  inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = __fmaf_rn(L.d[a], te, L.o[a]);
    const float f =
        floorf(__fmul_rn(__fadd_rn(__fmul_rn(p, 0.5f), 0.5f), fres));
    inside = inside && f >= 0.0f && f < fres;
    x[a] = fminf(fmaxf(f, 0.0f), fres - 1.0f);
  }
}

// The t at which the ray leaves, along one axis, the cell whose clamped
// index along it is c: the reference's expression on the same operands
// ((float)(c + up) is exact, so is c + up in f32).
__device__ __forceinline__ float face_t(float c, float up, float cell_w,
                                        float o, float sd) {
  const float bound = __fsub_rn(__fmul_rn(__fadd_rn(c, up), cell_w), 1.0f);
  return __fdiv_rn(__fsub_rn(bound, o), sd);
}

// The walker's state of one ray.
struct Walk {
  Line L;
  float up[3];
  float t, tmax;
};

// kLookahead steps of the walk; tb[k * 32] = the t of step k, tb[K * 32]
// the t after the batch (so step k's exit is tb[(k + 1) * 32]).
__device__ __forceinline__ void walk_batch(Walk& w, float fres, float cell_w,
                                           float* tb) {
#pragma unroll 1
  for (int k = 0; k < kLookahead; ++k) {
    const float te = __fadd_rn(w.t, kEps);
    float x[3];
    bool inside;
    locate(w.L, te, fres, x, inside);
    float t_exit = INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      t_exit = fminf(t_exit,
                     face_t(x[a], w.up[a], cell_w, w.L.o[a], w.L.sd[a]));
    tb[k * 32] = w.t;
    w.t = fmaxf(t_exit, te);
  }
  tb[kLookahead * 32] = w.t;
}

// The recorder's state of one ray and where its crossings go.
struct Record {
  Line L;
  float tmax;
  int count;
  float *my_ent, *my_exi;    // staged slots (shared)
  float *ent, *exi;          // the ray's rows (global), for slots past them
};

// Records the occupied steps of a batch of the walk (steps s, s + 1, ...):
// recomputes each step's cell from its t (the walker's arithmetic, so the
// same cell), issues the batch's occupancy reads back to back, then fills
// the next free slots in order.
__device__ __forceinline__ void record_batch(
    Record& rc, const float* tb, int s, int n_steps, float fres, int res,
    const uint8_t* __restrict__ occ, int max_isect, int n_staged) {
  float tk[kLookahead + 1];
  int64_t cell[kLookahead];
#pragma unroll
  for (int k = 0; k <= kLookahead; ++k) tk[k] = tb[k * 32];
#pragma unroll
  for (int k = 0; k < kLookahead; ++k) {
    float x[3];
    bool inside;
    locate(rc.L, __fadd_rn(tk[k], kEps), fres, x, inside);
    cell[k] = inside && tk[k] < rc.tmax && s + k < n_steps
                  ? ((int64_t)x[0] * res + (int64_t)x[1]) * res + (int64_t)x[2]
                  : -1;
  }
  uint8_t hit[kLookahead];
#pragma unroll
  for (int k = 0; k < kLookahead; ++k)
    hit[k] = cell[k] >= 0 ? __ldg(occ + cell[k]) : 0;
#pragma unroll
  for (int k = 0; k < kLookahead; ++k) {
    if (hit[k] && rc.count < max_isect) {
      const float e = tk[k], x = fminf(tk[k + 1], rc.tmax);
      if (rc.count < n_staged) {
        rc.my_ent[rc.count] = e;
        rc.my_exi[rc.count] = x;
      } else {
        rc.ent[rc.count] = e;
        rc.exi[rc.count] = x;
      }
      ++rc.count;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
voxel_dda_kernel(const float* __restrict__ origins,
                 const float* __restrict__ dirs,
                 const float* __restrict__ dist_min,
                 const float* __restrict__ dist_max,
                 const uint8_t* __restrict__ occ, float* __restrict__ entries,
                 float* __restrict__ exits, uint8_t* __restrict__ valid,
                 int64_t n_rays, int res, int max_isect) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const bool walker = threadIdx.x < 32;    // warp 1 records
  const int64_t row0 = (int64_t)blockIdx.x * 32;
  const int64_t r = row0 + lane;
  const bool active = r < n_rays;
  const int n_staged = staged_slots(max_isect);
  const int stride = stage_stride(max_isect);
  float* tbuf = smem;
  int* cnt = reinterpret_cast<int*>(tbuf + 2 * (kLookahead + 1) * 32);
  int* produced = cnt + 2 * 32;
  float* st_ent = reinterpret_cast<float*>(produced + 32);
  float* st_exi = st_ent + 32 * stride;

  Line L;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    L.o[a] = active ? origins[r * 3 + a] : 0.0f;
    L.d[a] = active ? dirs[r * 3 + a] : 1.0f;
    L.sd[a] = fabsf(L.d[a]) < 1e-9f ? 1e-9f : L.d[a];
  }
  float tmin, tmax;
  box_interval(L, active ? dist_min[r] : 0.0f, active ? dist_max[r] : 0.0f,
               tmin, tmax);
  const float fres = (float)res;
  const float cell_w = 2.0f / fres;
  const int n_steps = 3 * res + 2;

  Walk w;
  w.L = L;
#pragma unroll
  for (int a = 0; a < 3; ++a) w.up[a] = L.d[a] > 0.0f ? 1.0f : 0.0f;
  w.t = tmin;
  w.tmax = tmax;
  Record rc;
  rc.L = L;
  rc.tmax = tmax;
  rc.count = 0;
  rc.my_ent = st_ent + lane * stride;
  rc.my_exi = st_exi + lane * stride;
  rc.ent = entries + r * max_isect;
  rc.exi = exits + r * max_isect;

  // The walker warp walks batch b into buffer b % 2 while the recorder
  // warp records batch b - 1; the walker stops a ray at t >= tmax, at the
  // last step, or at I crossings by the recorder's count of two batches
  // back (steps past the stop are walked and discarded).
  if (!walker) cnt[32 + lane] = 0;
  __syncthreads();
  int s_walk = 0, s_rec = 0;
  for (int b = 0;; ++b) {
    bool walking = false;
    if (walker) {
      const bool live = active && w.t < w.tmax && s_walk < n_steps &&
                        cnt[((b + 1) & 1) * 32 + lane] < max_isect;
      walking = __any_sync(kFull, live);
      if (walking) {
        walk_batch(w, fres, cell_w, tbuf + (b & 1) * (kLookahead + 1) * 32 +
                                        lane);
        s_walk += kLookahead;
      }
      if (lane == 0) produced[b & 1] = walking;
    } else {
      if (b > 0 && produced[(b - 1) & 1]) {
        record_batch(rc, tbuf + ((b - 1) & 1) * (kLookahead + 1) * 32 + lane,
                     s_rec, n_steps, fres, res, occ, max_isect, n_staged);
        s_rec += kLookahead;
      }
      cnt[(b & 1) * 32 + lane] = rc.count;
    }
    if (!__syncthreads_or(walking)) break;
  }
  if (!walker) cnt[lane] = rc.count;
  __syncthreads();

  // The block's rows [row0, row0 + rows) are one flat run of rows * I
  // slots: element f is slot k of row `row`, advanced kThreads at a time.
  const int rows = (int)(n_rays - row0 < 32 ? n_rays - row0 : 32);
  const int total = rows * max_isect;
  const int64_t base = row0 * max_isect;
  int row = 0, k = threadIdx.x;
  while (k >= max_isect) {
    k -= max_isect;
    ++row;
  }
  for (int f = threadIdx.x; f < total; f += kThreads) {
    const bool v = k < cnt[row];
    valid[base + f] = v;
    if (!v) {
      entries[base + f] = 0.0f;
      exits[base + f] = 0.0f;
    } else if (k < n_staged) {
      entries[base + f] = st_ent[row * stride + k];
      exits[base + f] = st_exi[row * stride + k];
    }
    k += kThreads;
    while (k >= max_isect) {
      k -= max_isect;
      ++row;
    }
  }
}

}  // namespace

extern "C" int voxel_dda(const void* origins, const void* dirs,
                         const void* dist_min, const void* dist_max,
                         const void* occ, void* entries, void* exits,
                         void* valid, long long n_rays, int res, int max_isect,
                         void* stream) {
  if (n_rays <= 0 || max_isect <= 0) return 0;
  const long long blocks = (n_rays + 31) / 32;
  // at most 32 * (2 * 17 + 3 + 2 * 65) words: 21 KiB, under the default
  // 48 KiB of dynamic shared memory for any I
  const size_t smem = (size_t)block_words(max_isect) * 4;
  voxel_dda_kernel<<<(unsigned)blocks, kThreads, smem,
                     (cudaStream_t)stream>>>(
      (const float*)origins, (const float*)dirs, (const float*)dist_min,
      (const float*)dist_max, (const uint8_t*)occ, (float*)entries,
      (float*)exits, (uint8_t*)valid, (int64_t)n_rays, res, max_isect);
  return (int)cudaGetLastError();
}
