// Block-local paged hash-grid encode for Hopper: B2 (forward gather) and B3
// (backward scatter).
//
// Replaces the two Pallas kernels of shacira_tpu/ops/paged_hash.py:
//   paged_gather  <- _gather_kernel  (:720), the forward of paged_interp_lods,
//                    with its optional occupancy row (_kernel_occ_query, :415);
//   paged_scatter <- _scatter_kernel (:786), its backward.
// The TPU kernels stage each grouping cell's 4^3-page neighbourhood (and
// the direct LODs' slab windows) into VMEM and contract one-hot matrices
// on the MXU, because TPU gathers and scatters are slow; their window
// partials are then folded back into the table by XLA.
//
// B2: bound by arithmetic, not bytes (without its table reads it takes
// ~80 % of its time).  The table (31.5 MB on lego) sits in
// the 50 MB L2 and the slots of a segment are consecutive samples of one
// ray, so the L1 serves most corner reads; a thread per (slot, LOD) that
// recomputed every corner spent ~27 integer divisions on it.  So one CUDA
// block takes the slots of one kernel block (up to kMaxChunk of them) and
// works out the block's constants once: its grouping cell, each direct
// LOD's slab starts (shared memory), the page range 2c - 1 .. 2c + 2 and
// the occupancy window.  A warp takes 32 consecutive slots at one LOD, so
// branches stay uniform and the LOD's parameters stay in registers.  The
// corner math runs per axis, not per corner: for each axis the cell, its
// two weights, and for both corner offsets the hash term and the page
// select; the eight corners combine those with XOR and adds
// (lod_corners, shared with B3).  The page
// axis (cell * page_res) / res divides by a runtime res through a
// multiply-high reciprocal (recip = ceil(2^32 / res), exact for every
// numerator and res that _kernel_params admits, checked exhaustively by a
// CPU test).  Results go to a [slots, rows, ld] tile in shared memory,
// written out coalesced.  The occupancy row is one more row of that tile.
// Latent width 1 (the lego config) is compiled as its own case.
// Staging the table windows in shared memory was not done: a block's 128
// slots touch at most 1,024 of a paged LOD's 8,192 neighbourhood entries.
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
// The corners come from B2's per-axis lod_corners, with the grouping
// cell's constants worked out where a chain enters a kernel block rather
// than at every slot.
//
// Bound on an H100 (3.35 TB/s), lego train shapes (458,752 slots, 24 LODs,
// ld 1): B2 must read the coords and the touched table rows and write
// [458,752, 24] f32 (44 MB); B3 reads the live slots' gradient and writes
// the 31.5 MB table.  Both are bound by bytes.
//
// Exactness: the cell/fraction transform uses __fmul_rn/__fadd_rn so nvcc
// cannot contract res * (c * 0.5 + 0.5) into an FMA (which would move cell
// indices at boundaries away from the reference); hashes are uint32; the
// page axis (cell * page_res) / res is exact integer arithmetic.  Pad blocks
// (block_cell == n_cells) and invalid slots write 0 (B2) or add nothing
// (B3); B3 also skips zero gradients.  Float atomics make B3's sums change
// order from run to run: the result is not bitwise deterministic, and
// agrees with the plain version to 1e-5 of the largest value.  B2's
// occupancy row equals the plain version's exactly.
//
// Launches go on the caller's stream; each entry point returns
// cudaGetLastError() (0 on success).  B3's caller zero-fills `grad`.
//
// Built with -DCOUNT_GLOBAL_ATOMICS (kernels/build.py, for measurement
// only) B3 also counts the global float atomics it issues;
// take_global_atomics() reads and clears the count.  Built with
// -DGATHER_WITHOUT_LOADS (compare_kernels.py, for measurement only) B2
// does all its arithmetic but reads no table row: its time says what the
// loads cost.
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
  // appended fields, so that a library built from an older source reads
  // the prefix it knows
  unsigned recip[MAX_LODS];    // ceil(2^32 / res) of the paged LODs
  const uint8_t* occ;          // B2: packed occupancy grid, or null: no row
  int occ_res;                 // [res, res, res / 8 + 1] bytes
  int occ_w;                   // occupancy window: cells along x and y
  int occ_wb;                  // and bytes along z
  float occ_hi;                // f32(occ_res - 1e-5), the coordinate clamp
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

constexpr int kGatherThreads = 256;
constexpr int kMaxChunk = 128;         // slots a B2 CUDA block takes
constexpr int kTileBytes = 48 * 1024;    // B2's shared tile and coords

// Constants of a grouping cell, shared by its block's slots.
struct CellConsts {
  int c3[3];          // grouping cell
  int plo[3], phi[3]; // page range of the 4^3 neighbourhood, clamped
};

// group_res g is a power of two dividing 32 (_kernel_params checks it).
__device__ __forceinline__ CellConsts cell_consts(int bc,
                                                  const PagedParams& p) {
  const int g = p.group_res, lg = __ffs(g) - 1;
  CellConsts cc;
  cc.c3[0] = bc >> (2 * lg);
  cc.c3[1] = (bc >> lg) & (g - 1);
  cc.c3[2] = bc & (g - 1);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    cc.plo[d] = max(2 * cc.c3[d] - 1, 0);
    cc.phi[d] = min(2 * cc.c3[d] + 2, p.page_res - 1);
  }
  return cc;
}

// Start of a grouping cell's window along one axis at resolution res:
// floor((c / g - margin) * res) in units of 1/32 (floor(x / 32) is an
// arithmetic shift), clipped to [0, res - width].
__device__ __forceinline__ int window_start(int c, int res, int width,
                                            const PagedParams& p) {
  const int per32 = 32 >> (__ffs(p.group_res) - 1);
  return clampi(((c * per32 - p.margin32) * res) >> 5, 0, res - width);
}

// Cell of one coordinate at a LOD and its two linear weights.
__device__ __forceinline__ int axis_cell(float c, float fres, float hi,
                                         float pmax, float& w0, float& w1) {
  float x = __fmul_rn(fres, __fadd_rn(__fmul_rn(c, 0.5f), 0.5f));
  x = fminf(fmaxf(x, 0.0f), hi);
  const float cell = fminf(floorf(x), pmax);
  const float f = fminf(fmaxf(__fsub_rn(x, cell), 0.0f), 1.0f);
  w0 = __fsub_rn(1.0f, f);
  w1 = f;
  return (int)cell;
}

// LOD-local rows of the eight corners of one (slot, LOD) and their
// weights' factors (corner j weighs wxy[j >> 1] * wz[j & 1], wxy[k] the
// x weight times the y weight), from per-axis terms: the cell, its two
// weights, and for both corner offsets the hash term and the page select
// (or, for a direct LOD, the cell in the slab window starting at
// st[0..3)).
__device__ __forceinline__ void lod_corners(const float c[3], int l,
                                            const CellConsts& cc,
                                            const int* st,
                                            const PagedParams& p, int row[8],
                                            float wxy[4], float wz[2]) {
  const int res = p.res[l];
  const float pmax = (float)(res - 2 > 0 ? res - 2 : 0);
  float wt[2][2];
  int pos[3];
#pragma unroll
  for (int d = 0; d < 2; ++d)
    pos[d] = axis_cell(c[d], (float)res, p.hi[l], pmax, wt[d][0], wt[d][1]);
  pos[2] = axis_cell(c[2], (float)res, p.hi[l], pmax, wz[0], wz[1]);
#pragma unroll
  for (int k = 0; k < 4; ++k) wxy[k] = __fmul_rn(wt[0][k >> 1], wt[1][k & 1]);
  if (l < p.n_direct) {
    // dense LOD through the grouping cell's slab window
    const int width = p.width[l];
    const int scale[3] = {1, res, res * res};
    int a[3][2];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int lb = pos[d] - st[d];
#pragma unroll
      for (int o = 0; o < 2; ++o)
        a[d][o] = (st[d] + clampi(lb + o, 0, width - 1)) * scale[d];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      row[j] = a[0][j >> 2] + a[1][(j >> 1) & 1] + a[2][j & 1];
  } else {
    // hashed LOD through the grouping cell's 4^3 page neighbourhood; the
    // page axis (cell * P) / res is a multiply-high by recip
    const int P = p.page_res;
    const uint32_t e = (uint32_t)p.entries;
    const unsigned recip = p.recip[l];
    const uint32_t prime[3] = {1u, 2654435761u, 805459861u};
    const int scale[3] = {P * P * p.entries, P * p.entries, p.entries};
    uint32_t h[3][2];
    int a[3][2];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int cp = pos[d] + o;
        h[d][o] = (uint32_t)cp * prime[d];
        const int pax = (int)__umulhi((unsigned)(cp * P), recip);
        a[d][o] = clampi(pax, cc.plo[d], cc.phi[d]) * scale[d];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ox = j >> 2, oy = (j >> 1) & 1, oz = j & 1;
      uint32_t acc = h[0][ox] ^ h[1][oy] ^ h[2][oz];
      if (e < 32u) acc ^= (acc >> 8) ^ (acc >> 16) ^ (acc >> 24);
      row[j] = a[0][ox] + a[1][oy] + a[2][oz] + (int)(acc & (e - 1u));
    }
  }
}

// Interpolated latents of one (slot, LOD) into dst[0 .. ld).  kLd is the
// latent width when known at compile time, else 0 (p.ld).
template <int kLd>
__device__ __forceinline__ void gather_lod(const float c[3], int l,
                                           const CellConsts& cc,
                                           const int* st, const float* z,
                                           const PagedParams& p,
                                           float* dst) {
  int row[8];
  float wxy[4], wz[2];
  lod_corners(c, l, cc, st, p, row, wxy, wz);
  const int ld = kLd > 0 ? kLd : p.ld;
  const float* zl = z + p.row_off[l] * ld;
  for (int d = 0; d < ld; ++d) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#ifdef GATHER_WITHOUT_LOADS
      acc += __fmul_rn(wxy[j >> 1], wz[j & 1]) * (float)(row[j] * ld + d);
#else
      acc += __fmul_rn(wxy[j >> 1], wz[j & 1]) * zl[row[j] * ld + d];
#endif
    dst[d] = acc;
  }
}

// Fine occupancy of the slot's cell, read through the block's window as
// the TPU kernel reads it: x and y clamped in cells, z in bytes.
__device__ __forceinline__ float occupancy(const float c[3],
                                           const int ost[3],
                                           const PagedParams& p) {
  const int res = p.occ_res;
  int pos[3];
  bool inside = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float x = __fmul_rn(__fadd_rn(__fmul_rn(c[d], 0.5f), 0.5f), (float)res);
    x = fminf(fmaxf(x, 0.0f), p.occ_hi);
    pos[d] = (int)floorf(x);
    inside = inside && c[d] >= -1.0f && c[d] <= 1.0f;
  }
  const int x = ost[0] + clampi(pos[0] - ost[0], 0, p.occ_w - 1);
  const int y = ost[1] + clampi(pos[1] - ost[1], 0, p.occ_w - 1);
  const int zb0 = ost[2] >> 3;
  const int zb = zb0 + clampi((pos[2] >> 3) - zb0, 0, p.occ_wb - 1);
  const int byte = p.occ[((long long)x * res + y) * (res / 8 + 1) + zb];
  return inside ? (float)((byte >> (pos[2] & 7)) & 1) : 0.0f;
}

template <int kLd>
__global__ void __launch_bounds__(kGatherThreads)
paged_gather_kernel(const float* __restrict__ coords,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ block_cell,
                    const float* __restrict__ z, float* __restrict__ out,
                    const PagedParams p, int chunk) {
  extern __shared__ float smem[];
  __shared__ int st[MAX_LODS * 3];      // direct LODs' slab starts
  const int n_rows = p.n_lods + (p.occ != nullptr ? 1 : 0);
  const int ld = kLd > 0 ? kLd : p.ld;
  const int per_block = (p.block_rows + chunk - 1) / chunk;
  const long long kb = blockIdx.x / per_block;
  const int c0 = (int)(blockIdx.x - kb * per_block) * chunk;
  const int n_slots = min(chunk, p.block_rows - c0);
  const long long s0 = kb * p.block_rows + c0;
  float* out_b = out + s0 * n_rows * ld;
  const int n_out = n_slots * n_rows * ld;
  const int g = p.group_res;
  const int bc = block_cell[kb];
  if (bc >= g * g * g) {                // pad block
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) out_b[i] = 0.0f;
    return;
  }
  float* tile = smem;                               // [chunk, n_rows, ld]
  float* crd = smem + chunk * n_rows * ld;          // [chunk, 3]
  uint8_t* vld = (uint8_t*)(crd + 3 * chunk);       // [chunk]
  for (int i = threadIdx.x; i < 3 * n_slots; i += blockDim.x)
    crd[i] = coords[3 * s0 + i];
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x)
    vld[i] = valid[s0 + i];

  // the block's constants
  const CellConsts cc = cell_consts(bc, p);
  int ost[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    ost[d] = window_start(cc.c3[d], p.occ_res, p.occ_w, p);
  if (threadIdx.x < 3 * p.n_direct) {
    const int l = threadIdx.x / 3;
    st[threadIdx.x] = window_start(cc.c3[threadIdx.x - 3 * l], p.res[l],
                                   p.width[l], p);
  }
  __syncthreads();

  // a warp takes 32 consecutive slots at one output row: item
  // l * n_groups + group, stepping by the warp count without a division
  const int n_warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int n_groups = (n_slots + 31) >> 5;
  const int dl = n_warps / n_groups, dgrp = n_warps - dl * n_groups;
  int l = (threadIdx.x >> 5) / n_groups;
  int grp = (threadIdx.x >> 5) - l * n_groups;
  for (; l < n_rows; l += dl, grp += dgrp) {
    if (grp >= n_groups) {
      grp -= n_groups;
      ++l;
      if (l >= n_rows) break;
    }
    const int sl = grp * 32 + lane;
    if (sl >= n_slots) continue;
    float* dst = tile + (sl * n_rows + l) * ld;
    if (!vld[sl]) {
      for (int d = 0; d < ld; ++d) dst[d] = 0.0f;
      continue;
    }
    const float c[3] = {crd[3 * sl], crd[3 * sl + 1], crd[3 * sl + 2]};
    if (l == p.n_lods) {
      const float v = occupancy(c, ost, p);
      for (int d = 0; d < ld; ++d) dst[d] = v;
    } else {
      gather_lod<kLd>(c, l, cc, st + 3 * l, z, p, dst);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) out_b[i] = tile[i];
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
      // the kernel block of slot s and its constants, recomputed only
      // where the chain enters a block
      long long block_end = s0;
      int bc = n_cells;
      CellConsts cc;
      int st[3];
      for (long long s = s0; s < s1; ++s) {
        if (s >= block_end) {
          const long long kb = s / p.block_rows;
          block_end = (kb + 1) * p.block_rows;
          bc = block_cell[kb];
          if (bc < n_cells) {
            cc = cell_consts(bc, p);
            if (l < p.n_direct) {
#pragma unroll
              for (int a = 0; a < 3; ++a)
                st[a] = window_start(cc.c3[a], p.res[l], p.width[l], p);
            }
          }
        }
        if (bc >= n_cells || !valid[s]) continue;
        const float gv = g[(s * p.n_lods + l) * p.ld + d];
        if (gv == 0.0f) continue;
        const float c[3] = {coords[3 * s], coords[3 * s + 1],
                            coords[3 * s + 2]};
        int key[kGroup];
        float wxy[4], wz[2], w[kGroup];
        lod_corners(c, l, cc, st, p, key, wxy, wz);
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          w[j] = __fmul_rn(wxy[j >> 1], wz[j & 1]) * gv;
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
  if (ns <= 0 || p->block_rows <= 0) return 0;
  const int n_rows = p->n_lods + (p->occ != nullptr ? 1 : 0);
  // shared bytes a slot takes: its tile row, its coords, its validity
  const int slot_bytes = n_rows * p->ld * 4 + 3 * 4 + 1;
  int chunk = p->block_rows < kMaxChunk ? p->block_rows : kMaxChunk;
  if (chunk * slot_bytes > kTileBytes) chunk = kTileBytes / slot_bytes;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const long long blocks =
      ns / p->block_rows * ((p->block_rows + chunk - 1) / chunk);
  auto kernel = p->ld == 1 ? paged_gather_kernel<1> : paged_gather_kernel<0>;
  kernel<<<(unsigned)blocks, kGatherThreads, (size_t)chunk * slot_bytes,
           (cudaStream_t)stream>>>(
      (const float*)coords, (const uint8_t*)valid,
      (const int32_t*)block_cell, (const float*)z, (float*)out, *p, chunk);
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
