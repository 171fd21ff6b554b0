// Row scatter-add for Hopper: out[idx[n], :] += vals[n, :].
//
// Replaces shacira_tpu/ops/pallas_scatter.py::_scatter_kernel, the TPU's
// one-hot MXU matmul scatter.  The TPU factored the scatter into matmuls
// only because TPU scatters are slow; on Hopper each (row, column) update is
// one float atomicAdd, resolved in the 50 MB L2 cache.
//
// Bound on an H100 (3.35 TB/s): the kernel must read idx (4 B) and vals
// (4 B per column) once and write out once.
//   (a) hash-grid backward of the lego config, one launch over 24 LODs:
//       201,326,592 updates of one column -> about 1.61 GB -> >= 0.48 ms
//       before atomic throughput, into a 31.5 MB table that fits in L2;
//   (b) per-ray sums of the compact volume integration: 1,048,576 rows x 5
//       columns into 4096 x 5 addresses -> about 25 MB -> >= 7.5 us, with
//       heavy contention (about 256 rows per ray).
// This first kernel is the simple form: one thread per (row, column) in a
// grid-stride loop, no warp aggregation.  Zero values are skipped: once a
// prune leaves fewer occupied samples than the budget, the zero-weight tail
// of the compaction (up to 90 % of the rows) would otherwise pile its
// atomics onto the same few addresses.  The result is unchanged (x + 0 == x
// for every x but the sign of a zero).
//
// Float atomics make the summation order change from run to run, so unlike
// the JAX path the result is not bitwise deterministic.
//
// The caller zero-fills `out`.  Indices outside [0, t) are dropped, as the
// Pallas one-hot kernel drops them (no one-hot column matches) and as the
// plain PyTorch version beside the wrapper does.  The launch goes on the
// caller's stream; the
// return value is cudaGetLastError() (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                                        const float* __restrict__ vals,
                                        float* __restrict__ out,
                                        int64_t n, int f, int64_t t) {
  const int64_t total = n * f;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const int64_t row = i / f;
    const int64_t col = i - row * f;
    const float v = vals[i];
    const int64_t target = idx[row];
    // Adding zero changes nothing, and the zero rows are the contended
    // ones: the compacted tail repeats one sample, whose gradient and
    // integration weight are exactly zero.
    if (v != 0.0f && target >= 0 && target < t) {
      atomicAdd(out + target * f + col, v);
    }
  }
}

extern "C" int scatter_add_rows(const void* idx, const void* vals, void* out,
                                long long n, int f, long long t,
                                void* stream) {
  if (n <= 0 || f <= 0) return 0;
  const int threads = 256;
  const long long total = n * (long long)f;
  long long blocks = (total + threads - 1) / threads;
  const long long max_blocks = 132LL * 16;  // 16 resident blocks per SM
  if (blocks > max_blocks) blocks = max_blocks;
  scatter_add_rows_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)vals, (float*)out, (int64_t)n, f,
      (int64_t)t);
  return (int)cudaGetLastError();
}
