// Block-local paged hash-grid encode for Hopper: B2 (forward gather) and B3
// (backward scatter).
//
// Replaces the two Pallas kernels of shacira_tpu/ops/paged_hash.py:
//   paged_gather  <- _gather_kernel  (:720), the forward of paged_interp_lods;
//   paged_scatter <- _scatter_kernel (:786), its backward.
// The TPU kernels stage each grouping cell's 4^3-page neighbourhood (and
// the direct LODs' slab windows) into VMEM and contract one-hot matrices
// on the MXU, because TPU gathers and scatters are slow; their window
// partials are then folded back into the table by XLA.
//
// B2: one thread per (slot, LOD) recomputes the eight corner rows from the
// slot's coords exactly as the Pallas kernel does and gathers from the
// [T, ld] table (31.5 MB on lego, inside the 50 MB L2).  It does not reach
// its byte bound: staging the block's neighbourhood in shared memory is
// left for a later change.
//
// B3: one global f32 atomic per (slot, LOD, corner) made 60M atomics a
// lego step, though the slots of a segment are consecutive samples along a
// ray that share most corners at a LOD.  So one thread walks a chain of
// CHAIN consecutive slots at one LOD, and GroupMerge carries each corner's
// w * g into the next slot's corner of the same row, issuing one global
// atomic per row that the next slot does not touch.  Adjacent threads take
// the LODs of one chain, so the gradient reads are coalesced.  A shared-
// memory window per kernel block and LOD was slower: sm_90 has no native
// shared-memory float add, and nvcc turns one into a compare-and-swap loop.
//
// Bound on an H100 (3.35 TB/s), lego train shapes (458,752 slots, 24 LODs,
// ld 1): B2 must read the coords and the touched table rows and write
// [458,752, 24] f32 (44 MB); B3 reads the live slots' gradient and writes
// the 31.5 MB table.  Both are bound by bytes.
//
// Exactness: the cell/fraction transform uses __fmul_rn/__fadd_rn so nvcc
// cannot contract res * (c * 0.5 + 0.5) into an FMA (which would move cell
// indices at boundaries away from the reference); hashes are uint32; the
// page axis (cell * page_res) / res is integer arithmetic.  Pad blocks
// (block_cell == n_cells) and invalid slots write 0 (B2) or add nothing
// (B3); B3 also skips zero gradients.  Float atomics make B3's sums change
// order from run to run: the result is not bitwise deterministic, and
// agrees with the plain version to 1e-5 of the largest value.
//
// Launches go on the caller's stream; each entry point returns
// cudaGetLastError() (0 on success).  B3's caller zero-fills `grad`.
//
// Built with -DCOUNT_GLOBAL_ATOMICS (kernels/build.py, for measurement
// only) B3 also counts the global float atomics it issues;
// take_global_atomics() reads and clears the count.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LODS 32
#define CHAIN 16        // consecutive slots a B3 thread walks at a LOD

#ifdef COUNT_GLOBAL_ATOMICS
namespace {
__device__ unsigned long long global_atomics;
}
#endif

// Adds a thread's count of issued global atomics to `global_atomics`; a
// no-op (and `issued` dead code) in the normal build.
__device__ __forceinline__ void count_global_atomics(unsigned issued) {
#ifdef COUNT_GLOBAL_ATOMICS
  if (issued) atomicAdd(&global_atomics, (unsigned long long)issued);
#endif
}

// Mirror of ops/paged_hash.py::_KernelParams (passed by value).
struct PagedParams {
  int n_lods;                  // direct LODs first, then paged
  int n_direct;
  int res[MAX_LODS];
  int width[MAX_LODS];         // slab window width (direct LODs)
  float hi[MAX_LODS];          // f32(res - 1 - 1e-5), the coordinate clamp
  long long row_off[MAX_LODS]; // first row of the LOD in the table
  int entries;                 // E, entries per page (paged LODs)
  int page_res;                // P
  int group_res;               // G = P / 2 grouping cells per axis
  int margin32;                // slab margin in units of 1/32
  int ld;                      // latent width
  int block_rows;              // slot rows per block
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Eight corner rows (global) and trilinear weights of slot `s` at LOD `l`.
__device__ __forceinline__ void corners(const float* __restrict__ coords,
                                        long long s, int bc, int l,
                                        const PagedParams& p,
                                        long long row[8], float w[8]) {
  const int g = p.group_res;
  const int c3[3] = {bc / (g * g), (bc / g) % g, bc % g};
  const int res = p.res[l];
  const float pmax = (float)(res - 2 > 0 ? res - 2 : 0);
  int pos[3];
  float wt[3][2];
  for (int d = 0; d < 3; ++d) {
    const float c = coords[3 * s + d];
    float x = __fmul_rn((float)res, __fadd_rn(__fmul_rn(c, 0.5f), 0.5f));
    x = fminf(fmaxf(x, 0.0f), p.hi[l]);
    const float cell = fminf(floorf(x), pmax);
    const float f = fminf(fmaxf(__fsub_rn(x, cell), 0.0f), 1.0f);
    pos[d] = (int)cell;
    wt[d][0] = __fsub_rn(1.0f, f);
    wt[d][1] = f;
  }
  for (int j = 0; j < 8; ++j) {
    const int o[3] = {(j >> 2) & 1, (j >> 1) & 1, j & 1};
    w[j] = __fmul_rn(__fmul_rn(wt[0][o[0]], wt[1][o[1]]), wt[2][o[2]]);
  }
  if (l < p.n_direct) {
    // dense LOD through the grouping cell's slab window
    const int width = p.width[l];
    int st[3], lb[3];
    for (int d = 0; d < 3; ++d) {
      st[d] = clampi(floordiv((c3[d] * (32 / g) - p.margin32) * res, 32), 0,
                     res - width);
      lb[d] = pos[d] - st[d];
    }
    for (int j = 0; j < 8; ++j) {
      const int o[3] = {(j >> 2) & 1, (j >> 1) & 1, j & 1};
      long long cell[3];
      for (int d = 0; d < 3; ++d)
        cell[d] = st[d] + clampi(lb[d] + o[d], 0, width - 1);
      row[j] = p.row_off[l] + cell[0] + cell[1] * res +
               cell[2] * (long long)res * res;
    }
  } else {
    // hashed LOD through the grouping cell's 4^3 page neighbourhood
    const int P = p.page_res;
    const uint32_t e = (uint32_t)p.entries;
    for (int j = 0; j < 8; ++j) {
      const int o[3] = {(j >> 2) & 1, (j >> 1) & 1, j & 1};
      int cp[3];
      for (int d = 0; d < 3; ++d) cp[d] = pos[d] + o[d];
      uint32_t acc = (uint32_t)cp[0] * 1u;
      acc ^= (uint32_t)cp[1] * 2654435761u;
      acc ^= (uint32_t)cp[2] * 805459861u;
      if (e < 32u) acc ^= (acc >> 8) ^ (acc >> 16) ^ (acc >> 24);
      const long long ent = acc & (e - 1u);
      long long page = 0;
      for (int d = 0; d < 3; ++d) {
        const int pax = (cp[d] * P) / res;
        const int psel = clampi(pax - (2 * c3[d] - 1), 0, 3);
        page = page * P + clampi(2 * c3[d] - 1 + psel, 0, P - 1);
      }
      row[j] = p.row_off[l] + page * e + ent;
    }
  }
}

__global__ void paged_gather_kernel(const float* __restrict__ coords,
                                    const uint8_t* __restrict__ valid,
                                    const int32_t* __restrict__ block_cell,
                                    const float* __restrict__ z,
                                    float* __restrict__ out, long long ns,
                                    const PagedParams p) {
  const long long total = ns * p.n_lods;
  const int n_cells = p.group_res * p.group_res * p.group_res;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long s = i / p.n_lods;
    const int l = (int)(i - s * p.n_lods);
    float* o = out + i * p.ld;
    const int bc = block_cell[s / p.block_rows];
    if (bc >= n_cells || !valid[s]) {
      for (int d = 0; d < p.ld; ++d) o[d] = 0.0f;
      continue;
    }
    long long row[8];
    float w[8];
    corners(coords, s, bc, l, p, row, w);
    for (int d = 0; d < p.ld; ++d) {
      float acc = 0.0f;
      for (int j = 0; j < 8; ++j) acc += w[j] * z[row[j] * p.ld + d];
      o[d] = acc;
    }
  }
}

// GroupMerge holds the (row, sum) pairs of the last slot's 8 corners.
// next() merges equal rows among the new slot's corners into the first of
// them (the corner clamps can repeat a row), adds each held pair whose row
// reappears into it, issues the other held pairs to `out` with one global
// atomicAdd each, and holds the new corners.  flush() issues the held
// pairs.  Every value reaches `out` exactly once, inside one sum; a sum
// that is exactly zero is dropped.  All indexing is static, so the pairs
// stay in registers.  ops/paged_hash.py::group_merge is its plain mirror.
constexpr int kGroup = 8;    // corners of a slot
constexpr int kNoKey = -1;   // no update; indices are >= 0

struct GroupMerge {
  int key[kGroup];
  float sum[kGroup];
  unsigned issued = 0;         // global atomics issued

  __device__ __forceinline__ GroupMerge() {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      key[j] = kNoKey;
      sum[j] = 0.0f;
    }
  }

  // out[k[j] * stride] += v[j] for the group, now or at a later call.
  __device__ __forceinline__ void next(int k[kGroup], float v[kGroup],
                                       float* out, int stride) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) any |= k[j] != kNoKey;
    if (!any) return;
#pragma unroll
    for (int j = 1; j < kGroup; ++j) {
#pragma unroll
      for (int i = 0; i < j; ++i) {
        if (k[j] != kNoKey && k[j] == k[i]) {
          v[i] += v[j];
          k[j] = kNoKey;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      bool kept = false;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (key[i] != kNoKey && key[i] == k[j]) {
          v[j] += sum[i];
          kept = true;
        }
      }
      if (!kept && key[i] != kNoKey && sum[i] != 0.0f) {
        atomicAdd(out + (int64_t)key[i] * stride, sum[i]);
        ++issued;
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      key[j] = k[j];
      sum[j] = v[j];
    }
  }

  __device__ __forceinline__ void flush(float* out, int stride) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (key[j] != kNoKey && sum[j] != 0.0f) {
        atomicAdd(out + (int64_t)key[j] * stride, sum[j]);
        ++issued;
      }
    }
  }
};

__global__ void paged_scatter_kernel(const float* __restrict__ coords,
                                     const uint8_t* __restrict__ valid,
                                     const int32_t* __restrict__ block_cell,
                                     const float* __restrict__ g,
                                     float* __restrict__ grad, long long ns,
                                     const PagedParams p) {
  const long long total = (ns + CHAIN - 1) / CHAIN * p.n_lods;
  const int n_cells = p.group_res * p.group_res * p.group_res;
  const long long step = (long long)gridDim.x * blockDim.x;
  unsigned issued = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long chain = i / p.n_lods;
    const int l = (int)(i - chain * p.n_lods);
    const long long s0 = chain * CHAIN;
    const long long s1 = ns - s0 < CHAIN ? ns : s0 + CHAIN;
    for (int d = 0; d < p.ld; ++d) {
      // keys are rows of LOD l, counted from its first row
      float* out = grad + p.row_off[l] * p.ld + d;
      GroupMerge merge;
      for (long long s = s0; s < s1; ++s) {
        const int bc = block_cell[s / p.block_rows];
        if (bc >= n_cells || !valid[s]) continue;
        const float gv = g[(s * p.n_lods + l) * p.ld + d];
        if (gv == 0.0f) continue;
        int key[kGroup];
        long long row[8];
        float w[8];
        corners(coords, s, bc, l, p, row, w);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          key[j] = (int)(row[j] - p.row_off[l]);
          w[j] *= gv;
        }
        merge.next(key, w, out, p.ld);
      }
      merge.flush(out, p.ld);
      issued += merge.issued;
    }
  }
  count_global_atomics(issued);
}

static unsigned grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  const long long max_blocks = 132LL * 64;  // grid-stride beyond this
  return (unsigned)(blocks < max_blocks ? blocks : max_blocks);
}

extern "C" int paged_gather(const void* coords, const void* valid,
                            const void* block_cell, const void* z, void* out,
                            long long ns, const PagedParams* p,
                            void* stream) {
  const long long total = ns * p->n_lods;
  if (total <= 0) return 0;
  const int threads = 256;
  paged_gather_kernel<<<grid_for(total, threads), threads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)coords, (const uint8_t*)valid,
      (const int32_t*)block_cell, (const float*)z, (float*)out, ns, *p);
  return (int)cudaGetLastError();
}

extern "C" int paged_scatter(const void* coords, const void* valid,
                             const void* block_cell, const void* g,
                             void* grad, long long ns, const PagedParams* p,
                             void* stream) {
  const long long total = (ns + CHAIN - 1) / CHAIN * p->n_lods;
  if (total <= 0) return 0;
  const int threads = 256;
  paged_scatter_kernel<<<grid_for(total, threads), threads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)coords, (const uint8_t*)valid,
      (const int32_t*)block_cell, (const float*)g, (float*)grad, ns, *p);
  return (int)cudaGetLastError();
}

#ifdef COUNT_GLOBAL_ATOMICS
// B3's global atomics issued since the last call into *count; clears them.
extern "C" int take_global_atomics(unsigned long long* count) {
  const unsigned long long zero = 0;
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(count, global_atomics, sizeof(zero));
  cudaMemcpyToSymbol(global_atomics, &zero, sizeof(zero));
  return (int)cudaGetLastError();
}
#endif
