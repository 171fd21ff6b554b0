// Block-local paged hash-grid encode for Hopper: B2 (forward gather) and B3
// (backward scatter).
//
// Replaces the two Pallas kernels of shacira_tpu/ops/paged_hash.py:
//   paged_gather  <- _gather_kernel  (:720), the forward of paged_interp_lods;
//   paged_scatter <- _scatter_kernel (:786), its backward.
// The TPU kernels stage each grouping cell's 4^3-page neighbourhood (and
// the direct LODs' slab windows) into VMEM and contract one-hot matrices
// on the MXU, because TPU gathers and scatters are slow; their window
// partials are then folded back into the table by XLA.  On Hopper a
// gather is a load and a scatter an atomic, resolved in the 50 MB L2 that
// holds the whole lego table (31.5 MB), so this first version reads and
// writes the [T, ld] table directly: one thread per (slot, LOD) recomputes
// the eight corner rows from the slot's coords exactly as the Pallas
// kernel does, then gathers (B2) or atomically adds (B3).
//
// Bound on an H100 (3.35 TB/s), lego train shapes (458,752 slots, 24 LODs,
// ld 1): B2 must read the coords (5.5 MB) and the touched table rows and
// write [458,752, 24] f32 (44 MB) -- a few hundredths of a millisecond; B3
// reads the same gradient (44 MB) and writes the 31.5 MB table.  Both are
// bound by bytes; this simple form does not reach the bound (each thread
// issues 8 dependent-address loads or atomics).  Staging the neighbourhood
// in shared memory (B2) and accumulating per-block partials before one
// flush (B3) are left for a later change.
//
// Exactness: the cell/fraction transform uses __fmul_rn/__fadd_rn so nvcc
// cannot contract res * (c * 0.5 + 0.5) into an FMA (which would move cell
// indices at boundaries away from the reference); hashes are uint32; the
// page axis (cell * page_res) / res is integer arithmetic.  Pad blocks
// (block_cell == n_cells) and invalid slots write 0 (B2) or add nothing
// (B3); B3 also skips zero gradients.  Float atomics make B3's sums change
// order from run to run: the result is not bitwise deterministic.
//
// Launches go on the caller's stream; each entry point returns
// cudaGetLastError() (0 on success).  B3's caller zero-fills `grad`.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LODS 32

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

__global__ void paged_scatter_kernel(const float* __restrict__ coords,
                                     const uint8_t* __restrict__ valid,
                                     const int32_t* __restrict__ block_cell,
                                     const float* __restrict__ g,
                                     float* __restrict__ grad, long long ns,
                                     const PagedParams p) {
  const long long total = ns * p.n_lods;
  const int n_cells = p.group_res * p.group_res * p.group_res;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long s = i / p.n_lods;
    const int l = (int)(i - s * p.n_lods);
    const int bc = block_cell[s / p.block_rows];
    if (bc >= n_cells || !valid[s]) continue;
    const float* gi = g + i * p.ld;
    bool any = false;
    for (int d = 0; d < p.ld; ++d) any |= gi[d] != 0.0f;
    if (!any) continue;
    long long row[8];
    float w[8];
    corners(coords, s, bc, l, p, row, w);
    for (int j = 0; j < 8; ++j) {
      for (int d = 0; d < p.ld; ++d) {
        const float v = w[j] * gi[d];
        if (v != 0.0f) atomicAdd(grad + row[j] * p.ld + d, v);
      }
    }
  }
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
  const long long total = ns * p->n_lods;
  if (total <= 0) return 0;
  const int threads = 256;
  paged_scatter_kernel<<<grid_for(total, threads), threads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)coords, (const uint8_t*)valid,
      (const int32_t*)block_cell, (const float*)g, (float*)grad, ns, *p);
  return (int)cudaGetLastError();
}
