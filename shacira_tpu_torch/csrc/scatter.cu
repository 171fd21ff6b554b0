// Row scatter-add for Hopper: out[idx[n], :] += vals[n, :] (kernel B1),
// and the row gather out[n, :] = table[idx[n], :] (kernel R1, below).
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
//       columns into 4096 x 5 addresses -> about 25 MB -> >= 7.5 us;
//   (f) the backward of VQAD's corner-logit gather: 134,217,728 rows x 16
//       columns into 19,431,844 rows -> 8.6 GB of vals, 0.54 GB of idx,
//       1.24 GB of table -> >= 3.1 ms.  The wide rows bound it by bytes.
// One global atomic per update does not reach (a)'s byte bound: L2 retires
// about 100 G float atomics a second, and (b) piles ~256 rows onto each
// address.  Both inputs repeat indices at a stride of 8 rows: (a) lists
// the 8 corners of samples that follow each other along a ray, so corner j
// of one sample is often corner j of the next; (b) is sorted by ray.  So
// the kernel merges those runs on chip before its global atomics: a warp
// walks a run of `chunk` consecutive rows a step at a time, with coalesced
// loads, and sums each run of an equal index among rows 8 apart -- with a
// segmented scan over lanes (shuffles) where one step holds several groups
// of 8 rows, in the lane's own registers where it holds one -- carried from
// one step to the next; a run issues its global atomics where it ends.
// Merging in shared memory (a hash table of a tile's indices, windows) was
// slower: sm_90 has no native shared-memory float add, and nvcc turns one
// into a compare-and-swap loop.  On input with nothing to merge (uniformly
// random points) the kernel pays 2 shuffles and a vote per 32 rows on top
// of one atomic per update.
//
// Wide rows.  Each row and its index are read once, with all F columns
// held in registers: an earlier walk looped over the columns outside the
// walk and so read every 32-byte sector of vals once per column (16 times
// at F = 16, from HBM, since 8.6 GB does not stay in L2).  Run detection
// (index, liveness, heads) is done once per row for all its columns; only
// the value scan is per column.  The lanes of a step split the rows so that
// every load is coalesced: P lanes share a row of F columns (P = 4 at
// F % 16 == 0, 2 at F % 8 == 0, else 1), each holding C = F / P of them,
// loaded as float4 (C % 4 == 0) or float2; a step takes 32 / P rows, so at
// F = 16 a step is one group of 8 rows and the merge runs in registers with
// no shuffle.  Odd widths above 1 (F = 5) stage the warp's 32 rows in
// shared memory with one coalesced load and read each row back at the odd
// stride F, free of bank conflicts.
//
// Vector atomics.  sm_90 adds float2 and float4 to global memory in one
// atomic (red.global.add.v2/v4.f32), so a run's sums go out as float4 where
// F % 4 == 0, float2 where F % 2 == 0 and one float otherwise: at F = 16 a
// run costs 4 atomics, not 16, and L2's atomic rate stops bounding it.  A
// vector atomic whose sums are all zero is not issued.
//
// A row is skipped (no update, and it ends a run) when its index lies
// outside [0, t) or every one of its values is zero: once a prune leaves
// fewer occupied samples than the budget, the zero-weight tail of the
// compaction repeats one sample.  A zero value inside a live row adds 0.
// The result is unchanged (x + 0 == x but for the sign of a zero).
//
// F is a template parameter for the widths the port launches (1, 2, 4, 5,
// 8, 16); F = 0 instantiates the same walk for a width known only at run
// time: one lane a row, columns in passes of 4, each pass reading the
// whole row for its liveness.
//
// Float atomics make the summation order change from run to run, so unlike
// the JAX path the result is not bitwise deterministic; it agrees with the
// plain version to 1e-5 of the largest value.
//
// Built with -DCOUNT_GLOBAL_ATOMICS (kernels/build.py, for measurement
// only) the same kernel also counts the global atomics it issues, one per
// vector atomic; take_global_atomics() reads and clears the count.
//
// The caller zero-fills `out`; vals and out must be aligned to the vector
// width (16 B where F % 4 == 0, 8 B where F % 2 == 0).  Indices outside
// [0, t) are dropped, as the Pallas one-hot kernel drops them (no one-hot
// column matches) and as the plain PyTorch version beside the wrapper does.
// The launch goes on the caller's stream; the return value is
// cudaGetLastError() (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// The walk's shape at F columns (F = 0: the width is known at run time).
template <int F>
struct Shape {
  // lanes that share a row
  static constexpr int P = F > 0 && F % 16 == 0 ? 4
                           : F > 0 && F % 8 == 0 ? 2 : 1;
  static constexpr int C = F > 0 ? F / P : 4;    // columns a lane holds
  static constexpr int Q = 4 / P;                // groups of 8 rows a step
  // columns one atomic adds
  static constexpr int V = F % 4 == 0 ? 4 : F % 2 == 0 ? 2 : 1;
  // rows staged through shared memory
  static constexpr bool kStaged = F > 1 && F % 2 == 1;
};

// Loads the lane's `C` columns from `col` of row `r` (zero beyond `f`).
template <int F>
__device__ __forceinline__ void load_cols(float (&v)[Shape<F>::C],
                                          const float* __restrict__ vals,
                                          int64_t r, int f, int col) {
  constexpr int C = Shape<F>::C;
  const float* p = vals + r * (F > 0 ? F : f) + col;
  if constexpr (F > 0 && C % 4 == 0) {
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x; v[i + 1] = x.y; v[i + 2] = x.z; v[i + 3] = x.w;
    }
  } else if constexpr (F > 0 && C % 2 == 0) {
#pragma unroll
    for (int i = 0; i < C; i += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + i);
      v[i] = x.x; v[i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = F > 0 || col + i < f ? p[i] : 0.0f;
  }
}

// Issues the sums `s` of a run into `dst` (the run's row at the lane's
// first column): one atomic per group of `vec` columns with a non-zero sum.
// Returns the atomics issued.
template <int F>
__device__ __forceinline__ unsigned issue(float* __restrict__ dst,
                                          const float (&s)[Shape<F>::C],
                                          int cols, int vec) {
  constexpr int C = Shape<F>::C, V = Shape<F>::V;
  unsigned n = 0;
  if (F > 0 ? V == 4 : vec == 4) {            // F % 4 == 0: C % 4 == 0
#pragma unroll
    for (int i = 0; i + 3 < C; i += 4) {
      if (s[i] != 0.0f || s[i + 1] != 0.0f || s[i + 2] != 0.0f ||
          s[i + 3] != 0.0f) {
        atomicAdd(reinterpret_cast<float4*>(dst + i),
                  make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]));
        ++n;
      }
    }
  } else if (F > 0 ? V == 2 : vec == 2) {     // F % 2 == 0: cols even
#pragma unroll
    for (int i = 0; i + 1 < C; i += 2) {
      if (i < cols && (s[i] != 0.0f || s[i + 1] != 0.0f)) {
        atomicAdd(reinterpret_cast<float2*>(dst + i),
                  make_float2(s[i], s[i + 1]));
        ++n;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (i < cols && s[i] != 0.0f) {
        atomicAdd(dst + i, s[i]);
        ++n;
      }
    }
  }
  return n;
}

// A warp walks `chunk` consecutive rows, R = 32 / P rows a step (coalesced
// loads of the next step's rows before this step's are merged): lane l
// takes row l / P of the step, which is row j = (l / P) % 8 of the
// q = l / (8 P)-th group of 8 rows, and its C columns from (l % P) * C.
// Row j of consecutive groups forms one run sequence: it holds the same
// corner of consecutive samples.  A run is summed by a segmented scan over
// q (lanes 8 P apart), carried from q = Q - 1 into q = 0 of the next step,
// and issued where it ends.  A row that is not live (index outside [0, t),
// or every value zero) ends a run.  When every lane starts a run (nothing
// to merge, as on random points) the scan is skipped.
template <int F>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                        const float* __restrict__ vals,
                        float* __restrict__ out, int64_t n, int f_rt,
                        int64_t t, int chunk) {
  using S = Shape<F>;
  constexpr int P = S::P, C = S::C, Q = S::Q, R = 32 / P;
  __shared__ float stage[S::kStaged ? kThreads * F : 1];
  const int f = F > 0 ? F : f_rt;
  const int vec = F > 0 ? S::V : f % 4 == 0 ? 4 : f % 2 == 0 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int row = lane / P;                    // the lane's row of a step
  const int q = row >> 3;
  const int from = (lane + 32 - 8 * P) & 31;   // the lane of the row before
  const bool last = q == Q - 1;    // its run goes on into the next step
  float* my_stage = stage + (S::kStaged ? (threadIdx.x & ~31) * F : 0);
  const int64_t r0 =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32 * chunk;
  if (r0 >= n) return;                       // whole warps leave together
  const int64_t r1 = n - r0 < chunk ? n : r0 + chunk;
  unsigned issued = 0;
  const int passes = F > 0 ? 1 : (f + C - 1) / C;
  for (int pass = 0; pass < passes; ++pass) {
    const int col = F > 0 ? (lane % P) * C : pass * C;
    const int cols = F > 0 ? C : min(C, f - col);
    int key = -1;          // this lane's row of the last step; at q = Q - 1
    float sum[C];          // the run carried on, with its sums so far
#pragma unroll
    for (int i = 0; i < C; ++i) sum[i] = 0.0f;
    // rows of the next step are loaded before these are merged
    int64_t r = r0 + row;
    int64_t next_k = r < r1 ? (int64_t)idx[r] : -1;
    float next_v[S::kStaged ? F : C];          // staged: the coalesced load
    if constexpr (S::kStaged) {
#pragma unroll
      for (int i = 0; i < F; ++i) {
        const int64_t e = r0 * F + lane + 32 * i;
        next_v[i] = e < r1 * F ? vals[e] : 0.0f;
      }
    } else if (r < r1) {
      load_cols<F>(next_v, vals, r, f, col);
    } else {
#pragma unroll
      for (int i = 0; i < C; ++i) next_v[i] = 0.0f;
    }
    for (int64_t base = r0; base < r1; base += R) {
      const int64_t kk = next_k;
      float v[C];
      if constexpr (S::kStaged) {
#pragma unroll
        for (int i = 0; i < F; ++i) my_stage[lane + 32 * i] = next_v[i];
        __syncwarp();
#pragma unroll
        for (int i = 0; i < F; ++i) v[i] = my_stage[lane * F + i];
        __syncwarp();
      } else {
#pragma unroll
        for (int i = 0; i < C; ++i) v[i] = next_v[i];
      }
      r += R;
      next_k = r < r1 ? (int64_t)idx[r] : -1;
      if constexpr (S::kStaged) {
#pragma unroll
        for (int i = 0; i < F; ++i) {
          const int64_t e = (base + R) * F + lane + 32 * i;
          next_v[i] = e < r1 * F ? vals[e] : 0.0f;
        }
      } else if (r < r1) {
        load_cols<F>(next_v, vals, r, f, col);
      } else {
#pragma unroll
        for (int i = 0; i < C; ++i) next_v[i] = 0.0f;
      }
      // liveness of the row, over all its columns
      bool nz = false;
#pragma unroll
      for (int i = 0; i < C; ++i) nz |= v[i] != 0.0f;
      if constexpr (P > 1) {
        const unsigned b = __ballot_sync(kFull, nz);
        nz = (b >> (lane & -P) & ((1u << P) - 1)) != 0;
      }
      if (F == 0 && f > C && kk >= 0 && kk < t) {
        const float* p = vals + (base + row) * f;
        nz = false;
        for (int c = 0; c < f && !nz; ++c) nz = p[c] != 0.0f;
      }
      const int k = nz && kk >= 0 && kk < t ? (int)kk : -1;
      int head;
      float s[C];
      bool ends;
      if constexpr (Q > 1) {
        const int prev = __shfl_sync(kFull, last ? key : k, from);
        head = k != prev;                    // a run starts at this row
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const float carried = __shfl_sync(kFull, sum[i], from);
          const float x = k >= 0 ? v[i] : 0.0f;
          s[i] = q == 0 && !head ? x + carried : x;
        }
        const unsigned heads = __ballot_sync(kFull, head);
        if (heads != kFull) {
          // segmented inclusive scan over q: s sums the run up to this row
#pragma unroll
          for (int d = 1; d < Q; d *= 2) {
            const int head_up = __shfl_up_sync(kFull, head, 8 * P * d);
            const bool add = q >= d && !head;
#pragma unroll
            for (int i = 0; i < C; ++i) {
              const float s_up = __shfl_up_sync(kFull, s[i], 8 * P * d);
              if (add) s[i] += s_up;
            }
            if (q >= d) head |= head_up;
          }
        }
        // a run ends where the row after starts another: at q < Q - 1 a
        // run of these rows, at q = Q - 1 the run carried from the last
        // step (its row after is row q = 0 of these)
        ends = heads >> ((lane + 8 * P) & 31) & 1u;
      } else {
        // one group of 8 rows a step: the lane's rows form its sequence
        head = k != key;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const float x = k >= 0 ? v[i] : 0.0f;
          s[i] = head ? x : x + sum[i];
        }
        ends = head;
      }
      const int end_k = last ? key : k;
      if (ends && end_k >= 0) {
        float e[C];
#pragma unroll
        for (int i = 0; i < C; ++i) e[i] = last ? sum[i] : s[i];
        issued += issue<F>(out + (int64_t)end_k * f + col, e, cols, vec);
      }
      key = k;
#pragma unroll
      for (int i = 0; i < C; ++i) sum[i] = s[i];
    }
    if (last && key >= 0)
      issued += issue<F>(out + (int64_t)key * f + col, sum, cols, vec);
  }
  count_global_atomics(issued);
}

template <int F>
int launch(const void* idx, const void* vals, void* out, long long n, int f,
           long long t, long long chunk, cudaStream_t stream) {
  const long long threads = (n + chunk - 1) / chunk * 32;
  scatter_add_rows_kernel<F>
      <<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>((const int32_t*)idx, (const float*)vals, (float*)out,
                   (int64_t)n, f, (int64_t)t, (int)chunk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel R1: the row gather of ops/scatter.py::gather_rows' forward,
// out_k[r, :] = table_k[idx_k[r], :] for every table k, in one launch.
//
// It replaces no Pallas kernel: the JAX package gathers the corner rows
// with jnp.take (shacira_tpu/models/grids/octree_grid.py:152, :196; the
// triplanar texels likewise) and leaves them to XLA.  The port ran
// t[i.long()] a table: an int32 -> int64 copy of the indices, then
// PyTorch's vectorized_gather_kernel, which launches one block of 32
// threads for each row (4 of them live at 64-byte rows) -- 33.5 M blocks
// a LOD at VQAD's step -- so the card holds a few rows in flight a
// multiprocessor: 20.2 ms a LOD, on random and on sequential rows alike
// (times here on an H100 80GB HBM3 at 700 W).
//
// Bound on an H100 (3.35 TB/s): the gathered rows written once and their
// indices read once; the table's reads are left out, since samples that
// follow each other along a ray share most corners and find them in L2.
// VQAD's step: 134,217,728 rows of 16 f32 and their int32 indices ->
// 9.13 GB -> >= 2.72 ms.  The stores set the time: writing the same
// outputs alone (fill_) takes 2.62 ms, this kernel 3.43 ms, and 3.20 ms
// with its table loads taken out.
//
// Design: a copy of rows of bytes in the widest vector (16, 8, 4, 2 or 1
// bytes) that divides the row and the address of every table and output,
// so a row is w vectors (w = 4 at F = 16 f32, 1 at F = 4, 5 scalars at
// F = 5).  A block is w x (256 / w) threads: thread (x, y) copies vector x
// of rows y, y + R, ... (kGatherUnroll of them, R = 256 / w), all loads of
// a thread issued before its stores.  Consecutive threads hold consecutive
// vectors of consecutive rows, so each store instruction of a warp writes
// 32 contiguous vectors (at F = 16, 8 whole rows, 512 bytes).  Indices and
// rows are read through the read-only path; the rows are written
// evict-first (st.global.cs): 8.6 GB of output a step is 170x the 50 MB
// L2, and cached stores would evict the table rows that the next samples
// of a ray read again (3.50 ms with them).  Two rows a thread time the
// same as four; eight lose a quarter.  The blocks of each table follow
// those of the one before it, so one launch covers every table, each
// writing its own output tensor.  Row offsets are 64-bit: one LOD's
// output at VQAD's step holds 537 M floats.
//
// The output equals t[i.long()] bit for bit (a copy).  A negative index
// counts from the table's end, as in PyTorch; an index outside [-rows,
// rows) gives a row of zeros where PyTorch raises.  Indices come as int32
// or int64, one template instance each, read where they lie.
constexpr int kGatherThreads = 256;
constexpr int kGatherUnroll = 4;      // rows a thread copies, loads first
constexpr int kMaxGatherTables = 64;

// One table of a launch, as ops/scatter.py packs it (ctypes _GatherTable).
struct GatherTable {
  const void* table;        // [rows, row bytes]
  const void* idx;          // [n] int32 or int64
  void* out;                // [n, row bytes]
  long long rows;
  long long n;
  long long first_block;    // the table's first block of the launch
};

struct GatherTables {
  GatherTable t[kMaxGatherTables];
  int count;
};

template <typename V, typename I>
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const GatherTables p, int w) {
  int k = 0;                                    // the block's table
  while (k + 1 < p.count && p.t[k + 1].first_block <= (long long)blockIdx.x)
    ++k;
  const V* __restrict__ table = static_cast<const V*>(p.t[k].table);
  const I* __restrict__ idx = static_cast<const I*>(p.t[k].idx);
  V* __restrict__ out = static_cast<V*>(p.t[k].out);
  const int64_t rows = p.t[k].rows, n = p.t[k].n;
  const int64_t r0 = ((int64_t)blockIdx.x - p.t[k].first_block) *
                         blockDim.y * kGatherUnroll + threadIdx.y;
  int64_t src[kGatherUnroll];    // the table row of each row, -1: zeros
#pragma unroll
  for (int u = 0; u < kGatherUnroll; ++u) {
    const int64_t r = r0 + (int64_t)u * blockDim.y;
    int64_t i = r < n ? (int64_t)__ldg(idx + r) : -1;
    if (r < n && i < 0) i += rows;
    src[u] = i < rows ? i : -1;
  }
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    V v[kGatherUnroll];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      v[u] = V{};
      if (src[u] >= 0) v[u] = __ldg(table + src[u] * w + c);
    }
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int64_t r = r0 + (int64_t)u * blockDim.y;
      if (r < n) __stcs(out + r * w + c, v[u]);
    }
  }
}

template <typename V>
int launch_gather(GatherTables& p, long long row_bytes, bool idx64,
                  cudaStream_t stream) {
  const int w = (int)(row_bytes / (long long)sizeof(V));
  const int bx = w < kGatherThreads ? w : kGatherThreads;
  const int by = kGatherThreads / bx;
  long long blocks = 0;
  for (int k = 0; k < p.count; ++k) {
    p.t[k].first_block = blocks;
    blocks += (p.t[k].n + (long long)by * kGatherUnroll - 1) /
              ((long long)by * kGatherUnroll);
  }
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 block(bx, by);
  if (idx64)
    gather_rows_kernel<V, long long>
        <<<(unsigned)blocks, block, 0, stream>>>(p, w);
  else
    gather_rows_kernel<V, int><<<(unsigned)blocks, block, 0, stream>>>(p, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int scatter_add_rows(const void* idx, const void* vals, void* out,
                                long long n, int f, long long t,
                                void* stream) {
  if (n <= 0 || f <= 0) return 0;
  const uintptr_t align = f % 4 == 0 ? 16 : f % 2 == 0 ? 8 : 4;
  if ((uintptr_t)vals % align || (uintptr_t)out % align)
    return (int)cudaErrorMisalignedAddress;
  // rows a warp walks: 2 a lane, doubled up to 32 a lane while at least
  // 2^20 lanes (about 8,000 a multiprocessor) stay busy
  long long chunk = 2 * 32;
  while (chunk < 32 * 32 && n / (2 * chunk / 32) >= (1 << 20)) chunk *= 2;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (f) {
    case 1: return launch<1>(idx, vals, out, n, f, t, chunk, s);
    case 2: return launch<2>(idx, vals, out, n, f, t, chunk, s);
    case 4: return launch<4>(idx, vals, out, n, f, t, chunk, s);
    case 5: return launch<5>(idx, vals, out, n, f, t, chunk, s);
    case 8: return launch<8>(idx, vals, out, n, f, t, chunk, s);
    case 16: return launch<16>(idx, vals, out, n, f, t, chunk, s);
    default: return launch<0>(idx, vals, out, n, f, t, chunk, s);
  }
}

// R1 over `count` tables (a host array of GatherTable, first_block unset)
// of rows of `row_bytes` bytes, int64 indices where idx64 (int32
// otherwise), on `stream`.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int gather_rows(const void* tables, int count, long long row_bytes,
                           int idx64, void* stream) {
  if (count < 1 || count > kMaxGatherTables || row_bytes < 1 ||
      row_bytes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  GatherTables p;
  memcpy(p.t, tables, sizeof(GatherTable) * count);
  p.count = count;
  // the widest vector that divides the row and every address
  uintptr_t bits = (uintptr_t)row_bytes;
  for (int k = 0; k < count; ++k)
    bits |= (uintptr_t)p.t[k].table | (uintptr_t)p.t[k].out;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool i64 = idx64 != 0;
  if (bits % 16 == 0) return launch_gather<uint4>(p, row_bytes, i64, s);
  if (bits % 8 == 0) return launch_gather<uint2>(p, row_bytes, i64, s);
  if (bits % 4 == 0) return launch_gather<unsigned>(p, row_bytes, i64, s);
  if (bits % 2 == 0)
    return launch_gather<unsigned short>(p, row_bytes, i64, s);
  return launch_gather<unsigned char>(p, row_bytes, i64, s);
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
