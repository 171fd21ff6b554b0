// Row scatter-add for Hopper: out[idx[n], :] += vals[n, :].
//
// Replaces shacira_tpu/ops/pallas_scatter.py::_scatter_kernel, the TPU's
// one-hot MXU matmul scatter.  The TPU factored the scatter into matmuls
// only because TPU scatters are slow; on Hopper an update is a float
// atomicAdd resolved in the 50 MB L2 cache.
//
// Bound on an H100 (3.35 TB/s): the kernel must read idx (4 B) and vals
// (4 B per column) once and write out once.
//   (a) hash-grid backward of the lego config, one launch over 24 LODs:
//       201,326,592 updates of one column -> about 1.61 GB -> >= 0.48 ms,
//       into a 31.5 MB table that fits in L2;
//   (b) per-ray sums of the compact volume integration: 1,048,576 rows x 5
//       columns into 4096 x 5 addresses -> about 25 MB -> >= 7.5 us.
// One global atomic per update does not reach (a)'s byte bound: L2 retires
// about 100 G float atomics a second, and (b) piles ~256 rows onto each
// address.  Both inputs repeat indices at a stride of 8 rows: (a) lists
// the 8 corners of samples that follow each other along a ray, so corner j
// of one sample is often corner j of the next; (b) is sorted by ray.  So
// the kernel merges those runs on chip before its global atomics: a warp
// walks a run of `chunk` consecutive rows 32 at a time, with one coalesced
// load, and sums each run of an equal index among rows 8 apart with a
// segmented scan over lanes (shuffles), carried from one 32 rows to the
// next; a run issues one global atomicAdd where it ends.  Merging in shared
// memory (a hash table of a tile's indices, windows) was slower: sm_90 has
// no native shared-memory float add, and nvcc turns one into a compare-
// and-swap loop.  So was a lane walking rows of its own: a warp's loads then
// touch 4 to 32 cache lines instead of 1.  On input with nothing to merge
// (uniformly random points) the kernel pays 2 shuffles and a vote per 32
// rows on top of one atomic per update.
//
// Rows whose index lies outside [0, t) and zero values are skipped: once a
// prune leaves fewer occupied samples than the budget, the zero-weight tail
// of the compaction repeats one sample.  The result is unchanged (x + 0 ==
// x but for the sign of a zero).
//
// Float atomics make the summation order change from run to run, so unlike
// the JAX path the result is not bitwise deterministic; it agrees with the
// plain version to 1e-5 of the largest value.
//
// Built with -DCOUNT_GLOBAL_ATOMICS (kernels/build.py, for measurement
// only) the same kernel also counts the global float atomics it issues;
// take_global_atomics() reads and clears the count.
//
// The caller zero-fills `out`.  Indices outside [0, t) are dropped, as the
// Pallas one-hot kernel drops them (no one-hot column matches) and as the
// plain PyTorch version beside the wrapper does.  The launch goes on the
// caller's stream; the return value is cudaGetLastError() (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

#ifdef COUNT_GLOBAL_ATOMICS
__device__ unsigned long long global_atomics;
#endif

// Adds a thread's count of issued global atomics to `global_atomics`; a
// no-op (and `issued` dead code) in the normal build.
__device__ __forceinline__ void count_global_atomics(unsigned issued) {
#ifdef COUNT_GLOBAL_ATOMICS
  if (issued) atomicAdd(&global_atomics, (unsigned long long)issued);
#endif
}

// A warp walks `chunk` consecutive rows 32 at a time (one coalesced load):
// lane l takes row l, which is row j = l % 8 of the q = l / 8-th group of 8
// rows.  Row j of consecutive groups forms one run sequence: it holds the
// same corner of consecutive samples.  A run is summed by a segmented scan
// over q (lanes 8 apart), carried from q = 3 into q = 0 of the next 32
// rows, and issued with one global atomicAdd where it ends.  A zero value
// or an index outside [0, t) ends a run.  When every lane starts a run
// (nothing to merge, as on random points) the scan is skipped.
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                        const float* __restrict__ vals,
                        float* __restrict__ out, int64_t n, int f, int64_t t,
                        int chunk) {
  const int lane = threadIdx.x & 31;
  const int q = lane >> 3;
  const int from = q == 0 ? lane + 24 : lane - 8;   // the row before
  const int64_t r0 =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32 * chunk;
  if (r0 >= n) return;                       // whole warps leave together
  const int64_t r1 = n - r0 < chunk ? n : r0 + chunk;
  unsigned issued = 0;
  for (int c = 0; c < f; ++c) {
    int key = -1;          // this lane's row of the last 32; at q = 3 the
    float sum = 0.0f;      // run carried on, with its sum so far
    // rows of the next 32 are loaded before these are merged
    int64_t r = r0 + lane;
    int64_t next_k = r < r1 ? (int64_t)idx[r] : -1;
    float next_v = r < r1 ? vals[r * f + c] : 0.0f;
    for (int64_t base = r0; base < r1; base += 32) {
      int k = next_v != 0.0f && next_k >= 0 && next_k < t ? (int)next_k : -1;
      const float v = k >= 0 ? next_v : 0.0f;
      r += 32;
      next_k = r < r1 ? (int64_t)idx[r] : -1;
      next_v = r < r1 ? vals[r * f + c] : 0.0f;
      const int prev = __shfl_sync(kFull, q == 3 ? key : k, from);
      const float carried = __shfl_sync(kFull, sum, from);
      int head = k != prev;                  // a run starts at this row
      float s = q == 0 && !head ? v + carried : v;
      const unsigned heads = __ballot_sync(kFull, head);
      if (heads != kFull) {
        // segmented inclusive scan over q: s sums the run up to this row
#pragma unroll
        for (int d = 1; d < 4; d *= 2) {
          const float s_up = __shfl_up_sync(kFull, s, 8 * d);
          const int head_up = __shfl_up_sync(kFull, head, 8 * d);
          if (q >= d) {
            if (!head) s += s_up;
            head |= head_up;
          }
        }
      }
      // a run ends where the row after starts another: at q < 3 a run of
      // these rows, at q = 3 the run carried from the last 32 rows (its
      // row after is row 0 of these)
      const int end_k = q < 3 ? k : key;
      const float end_s = q < 3 ? s : sum;
      if ((heads >> ((lane + 8) & 31) & 1u) && end_k >= 0 && end_s != 0.0f) {
        atomicAdd(out + (int64_t)end_k * f + c, end_s);
        ++issued;
      }
      key = k;
      sum = s;
    }
    if (q == 3 && key >= 0 && sum != 0.0f) {
      atomicAdd(out + (int64_t)key * f + c, sum);
      ++issued;
    }
  }
  count_global_atomics(issued);
}

}  // namespace

extern "C" int scatter_add_rows(const void* idx, const void* vals, void* out,
                                long long n, int f, long long t,
                                void* stream) {
  if (n <= 0 || f <= 0) return 0;
  // rows a warp walks: 2 a lane, doubled up to 32 a lane while at least
  // 2^20 lanes (about 8,000 a multiprocessor) stay busy
  long long chunk = 2 * 32;
  while (chunk < 32 * 32 && n / (2 * chunk / 32) >= (1 << 20)) chunk *= 2;
  const long long threads = (n + chunk - 1) / chunk * 32;
  scatter_add_rows_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                            kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)vals, (float*)out, (int64_t)n, f,
      (int64_t)t, (int)chunk);
  return (int)cudaGetLastError();
}

#ifdef COUNT_GLOBAL_ATOMICS
// The global atomics issued since the last call into *count; clears them.
extern "C" int take_global_atomics(unsigned long long* count) {
  const unsigned long long zero = 0;
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(count, global_atomics, sizeof(zero));
  cudaMemcpyToSymbol(global_atomics, &zero, sizeof(zero));
  return (int)cudaGetLastError();
}
#endif
