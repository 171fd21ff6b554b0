// Kernel V1: the bounded DDA walk of the 'voxel' march on Hopper.
//
// Computes shacira_tpu/accel/occupancy.py::voxel_crossings, which is no
// Pallas kernel: the JAX package runs the walk as a lax.scan of 3 * res + 2
// dependent steps (vmapped over rays), then compacts the occupied steps
// into [R, I] slots with a cumsum and one scatter.  On the TPU the scan is
// one device loop; in eager PyTorch each step would be some 25 small
// launches.  Here one thread walks one ray.
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
// Exactness: the cell comes from a floor, so whether a product and a sum
// are rounded once (FMA) or twice can move a crossing into the neighbouring
// cell.  The reference's XLA contracts o + d * (t + eps) into one FMA and
// fuses nothing else whose rounding matters (the other products are exact
// powers-of-two scalings), so the kernel computes exactly that one
// product-sum as __fmaf_rn and every other product and sum as an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn: never
// contracted), with IEEE division (__fdiv_rn), in the order of the scan
// body.  The plain PyTorch version beside the wrapper emulates the one FMA
// (occupancy.fma_f32), and the two agree bit for bit.
//
// Early exit: t never decreases (exit >= t + eps >= t), so once t >= tmax
// no later step can record a crossing and the walk stops; it also stops
// when all I slots are full (later crossings are dropped).  The result is
// the same as walking all 3 * res + 2 steps.
//
// Bound on an H100 (3.35 TB/s): one occupancy byte read per step walked
// (the 2 MiB grid of res 128 lives in the 50 MB L2) plus the rays read and
// the outputs written once.  The walk is a chain of dependent steps, each
// waiting on an L2 read and a division, so it is latency-bound far above
// that byte bound; making it faster (several rays a warp in flight,
// skipping empty coarse cells) is later work.
//
// The launch goes on the caller's stream; the return value is
// cudaGetLastError() (0 on success).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
voxel_dda_kernel(const float* __restrict__ origins,
                 const float* __restrict__ dirs,
                 const float* __restrict__ dist_min,
                 const float* __restrict__ dist_max,
                 const uint8_t* __restrict__ occ, float* __restrict__ entries,
                 float* __restrict__ exits, uint8_t* __restrict__ valid,
                 int64_t n_rays, int res, int max_isect) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  float o[3], d[3], sd[3];
  float tmin = -INFINITY, tmax = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = origins[r * 3 + a];
    d[a] = dirs[r * 3 + a];
    sd[a] = fabsf(d[a]) < 1e-9f ? 1e-9f : d[a];
    const float t0 = __fdiv_rn(__fsub_rn(-1.0f, o[a]), sd[a]);
    const float t1 = __fdiv_rn(__fsub_rn(1.0f, o[a]), sd[a]);
    tmin = fmaxf(tmin, fminf(t0, t1));
    tmax = fminf(tmax, fmaxf(t0, t1));
  }
  tmin = fmaxf(tmin, dist_min[r]);
  tmax = fminf(tmax, dist_max[r]);

  const float fres = (float)res;
  const float cell_w = 2.0f / fres;
  const float eps = 1e-6f;
  const int n_steps = 3 * res + 2;
  float* ent = entries + r * max_isect;
  float* exi = exits + r * max_isect;
  int count = 0;
  float t = tmin;
  for (int s = 0; s < n_steps && count < max_isect; ++s) {
    if (!(t < tmax)) break;
    const float te = __fadd_rn(t, eps);
    bool inside = true;
    int cell[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float p = __fmaf_rn(d[a], te, o[a]);
      const float x =
          floorf(__fmul_rn(__fadd_rn(__fmul_rn(p, 0.5f), 0.5f), fres));
      inside = inside && x >= 0.0f && x < fres;
      cell[a] = (int)fminf(fmaxf(x, 0.0f), fres - 1.0f);
    }
    float t_exit = INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float bound =
          __fsub_rn(__fmul_rn((float)(cell[a] + (d[a] > 0.0f)), cell_w), 1.0f);
      t_exit = fminf(t_exit, __fdiv_rn(__fsub_rn(bound, o[a]), sd[a]));
    }
    t_exit = fmaxf(t_exit, te);
    if (inside && occ[((int64_t)cell[0] * res + cell[1]) * res + cell[2]]) {
      ent[count] = t;
      exi[count] = fminf(t_exit, tmax);
      ++count;
    }
    t = t_exit;
  }
  uint8_t* val = valid + r * max_isect;
  for (int k = 0; k < max_isect; ++k) {
    val[k] = k < count;
    if (k >= count) {
      ent[k] = 0.0f;
      exi[k] = 0.0f;
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
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  voxel_dda_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)origins, (const float*)dirs, (const float*)dist_min,
      (const float*)dist_max, (const uint8_t*)occ, (float*)entries,
      (float*)exits, (uint8_t*)valid, (int64_t)n_rays, res, max_isect);
  return (int)cudaGetLastError();
}
