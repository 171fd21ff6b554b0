// Flat multi-LOD hash-grid encode, forward, for Hopper (kernel E1): the
// features of N points at every LOD of a concatenated hash table, in one
// launch over all LODs.  Its backward up to the scatter, kernel E1(b), is
// further down, with a note of its own.
//
// It replaces no Pallas kernel.  The JAX package's flat forward
// (shacira_tpu/ops/hashgrid.py, hash_encode) is a plain gather left to
// XLA.  The port ran it as ~30 eager PyTorch operations a LOD
// (ops/hashgrid.py: _all_corners, _interp), each reading and writing
// tensors of N x 8 corners in int64 or f32: ~800 launches and tens of GB
// a step at the lego config's 1,048,576 samples x 24 LODs.
//
// What bounds it.  The forward has to write the features [N, L, F] and,
// where a gradient is needed, the tensors the backward reads: the global
// corner rows gidx [L, N, C] int32 and their weights w [L, N, C] f32
// (C = 2^dim corners), and on the affine path the blended latents
// zbar [L, N, ld].  At the lego step that is 2,113,929,216 bytes written
// plus 12.6 MB of coordinates read: >= 0.64 ms at 3.35 TB/s.  The gathers
// add little there: ~11 % of the rows are live samples, the coarse LODs
// stay in L2, and every padding row of the compaction repeats one
// coordinate, so its corners hit in cache.  So the kernel is bound by the
// bytes it writes where the rows are mostly padding, and by the random
// sectors of its gathers where every row is a distinct point.
//
// Design: one thread a point, looping over the LODs.  A thread reads its
// coordinates once and, for each LOD, computes in registers the cell and
// fraction, its C corners' rows (direct index, XOR-prime hash, or the
// paged layout's page * E + fold_hash), their weights, gathers the C
// table rows and blends them.  Nothing but the outputs goes to memory.
// The other design, a warp a LOD slice, would read each point's
// coordinates once a LOD and gains nothing on the stores below.
//
// The stores decide the time.  Consecutive threads hold consecutive
// points, so a warp's corner rows at one LOD, [l, n..n+31, :], are 1 KB
// of contiguous memory, and its features of kChunk LODs, [n..n+31, l..,
// :], are 32 contiguous runs of kChunk * F floats.  Stored straight from
// the threads, each store instruction writes 16 bytes a lane at a
// stride, half or less of each 32-byte sector it touches; the features'
// stride of L * F floats made their stores alone cost more than all the
// rest of the kernel (at lego's shape 1.8 of 2.7 ms).  So each warp stages
// them in shared memory (rows padded against bank conflicts) and writes
// them out with consecutive lanes on consecutive 16-byte vectors, whole
// lines a store: the corner rows and weights every LOD, the features
// every kChunk LODs.
//
// The affine path's two tables, the decoded features [T, F] and the
// latents z [T, ld], are read where they lie rather than as one
// concatenated [T, F + ld] table: a row of 4 + 1 floats is 20 bytes, off
// the 16-byte grid, and costs five scalar loads of scattered addresses a
// corner where the two tables cost one float4 and one float (the L1's
// throughput on scattered loads bounds the gather), and the copy that
// concatenates them is a launch and 158 MB a step fewer.
//
// The arithmetic is that of the PyTorch version beside the wrapper as it
// runs on the card, bit for bit: x = clamp(res * (c * 0.5 + 0.5), 0, hi)
// with __fmul_rn / __fadd_rn (nvcc would otherwise contract c * 0.5 + 0.5
// into an FMA, which rounds once where PyTorch rounds twice) and hi =
// (float)(res - 1 - 1e-5); the cell floor(x) clamped to res - 2; the
// fraction x - cell clamped to [0, 1]; the XOR-prime hash in uint32,
// equal to PyTorch's (c * prime) & 0xFFFFFFFF in int64; each weight the
// product over the axes, and each blend the sum of the corners' rounded
// products, in the orders of PyTorch's CUDA reductions (ReduceOp: a
// product of 3 over two lanes, (x * z) * y; a sum of 8 in four
// accumulators, ((c0 + c4) + (c1 + c5)) + ...).  So gidx, w and the
// features equal the PyTorch version's on the card, and a run trains as
// it did before the kernel; on the CPU (another order) w is within 2 ulps
// and the features within 1e-6 of the largest value.
//
// The LODs' parameters come as one struct passed by value with the launch
// (no host-to-device copy: that would synchronise the stream).  dim (2, 3)
// and the widths F and ld are template parameters: F = 4, ld = 1 the lego
// affine step; 4/0 the decoded table; 2/0 HashGrid; 1/1 the image's affine
// step.  Other widths take a loop over columns known at run time (F = 0),
// as kernel B1 does with F = 0.
//
// gidx and w are written where both pointers are given, zbar where its
// pointer is; the caller passes none of them when nothing needs a
// gradient.  The tables, feats and zbar must be aligned to their vector
// width, gidx and w to 16 bytes.  The launch goes on the caller's stream;
// the return value is cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue / cudaErrorMisalignedAddress for arguments it does
// not take.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLods = 64;
constexpr int kChunk = 8;             // LODs of features staged a flush
constexpr int kDirect = 0;
constexpr int kXor = 1;
constexpr int kPaged = 2;
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr uint32_t kSmallPage = 32;   // hashgrid.SMALL_PAGE_ENTRIES

// One LOD, as ops/hashgrid.py::lod_params packs it (ctypes struct _Lod).
struct Lod {
  int32_t res;        // grid resolution
  int32_t first;      // the LOD's first row in the concatenated table
  int32_t size;       // the LOD's rows; a hashed LOD masks with size - 1
  int32_t mode;       // kDirect, kXor or kPaged
  int32_t entries;    // kPaged: entries a page (a power of two)
  float hi;           // (float)(res - 1 - 1e-5), the coordinate's clamp
  float cell_max;     // max(res - 2, 0), the cell's clamp
};

struct Lods {
  Lod lod[kMaxLods];
  int32_t count;
  int32_t page_res;
};

// The N floats at p (read-only), as float4 / float2 where N allows.
template <int N>
__device__ __forceinline__ void load_row(float* v, const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + k);
      v[4 * k] = q.x; v[4 * k + 1] = q.y; v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p) + k);
      v[2 * k] = q.x; v[2 * k + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = __ldg(p + k);
  }
}

// Writes the N values v to p, as float4 / float2 where N allows.
template <int N, typename T>
__device__ __forceinline__ void store_row(T* p, const T* v) {
  if constexpr (N % 4 == 0 && sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      float4 q;
      memcpy(&q, v + 4 * k, 16);
      reinterpret_cast<float4*>(p)[k] = q;
    }
  } else if constexpr (N % 2 == 0 && sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      float2 q;
      memcpy(&q, v + 2 * k, 8);
      reinterpret_cast<float2*>(p)[k] = q;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = v[k];
  }
}

// Global rows (the LOD-local index plus the LOD's first row) and weights
// of the C corners of point c (each coordinate already c * 0.5 + 0.5) at
// one LOD, in reference order: the first axis is the high bit of j.
template <int DIM>
__device__ __forceinline__ void corners(const float (&c)[DIM], const Lod& lod,
                                        uint32_t page_res,
                                        int32_t (&idx)[1 << DIM],
                                        float (&w)[1 << DIM]) {
  const float res = (float)lod.res;
  uint32_t cell[DIM];
  float frac[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const float x = fminf(fmaxf(__fmul_rn(res, c[d]), 0.0f), lod.hi);
    const float pos = fminf(floorf(x), lod.cell_max);
    frac[d] = fminf(fmaxf(__fsub_rn(x, pos), 0.0f), 1.0f);
    cell[d] = (uint32_t)pos;
  }
#pragma unroll
  for (int j = 0; j < (1 << DIM); ++j) {
    uint32_t cp[DIM];
    float fw[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const uint32_t bit = (j >> (DIM - 1 - d)) & 1;
      cp[d] = cell[d] + bit;
      fw[d] = bit ? frac[d] : __fsub_rn(1.0f, frac[d]);
    }
    // PyTorch's CUDA product over the axes: two lanes, the first taking
    // axes 0 and 2, then the second's axis 1
    float wj = __fmul_rn(fw[0], fw[DIM - 1]);
    if constexpr (DIM == 3) wj = __fmul_rn(wj, fw[1]);
    int64_t e;
    if (lod.mode == kDirect) {
      const int64_t r = lod.res;
      e = (int64_t)cp[0] + (int64_t)cp[1] * r;
      if constexpr (DIM == 3) e += (int64_t)cp[2] * r * r;
    } else {
      uint32_t acc = cp[0] ^ (cp[1] * kPrime1);
      if constexpr (DIM == 3) acc ^= cp[2] * kPrime2;
      if (lod.mode == kXor) {
        e = acc & (uint32_t)(lod.size - 1);
      } else {
        const uint32_t ent = (uint32_t)lod.entries;
        uint32_t page = 0;
#pragma unroll
        for (int d = 0; d < DIM; ++d)
          page = page * page_res + cp[d] * page_res / (uint32_t)lod.res;
        if (ent < kSmallPage)
          acc = acc ^ (acc >> 8) ^ (acc >> 16) ^ (acc >> 24);
        e = (int64_t)page * ent + (acc & (ent - 1));
      }
    }
    idx[j] = (int32_t)(e + lod.first);
    w[j] = wj;
  }
}

// The sum of the C corners' products in the order of PyTorch's CUDA sum
// over them: four accumulators, corner j going to j % 4, then added up in
// accumulator order.
template <int C>
__device__ __forceinline__ float corner_sum(const float (&p)[C]) {
  float a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    a[j] = C > 4 ? __fadd_rn(p[j], p[j + 4 < C ? j + 4 : j]) : p[j];
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
}

// The warp writes the rows it staged in shared memory: point p's `per`
// vectors of V 32-bit values, at src + p * src_row, go to
// dst + p * dst_row, for the warp's first `valid` points.  Consecutive
// lanes take consecutive vectors, so one store covers whole lines.
template <int V, typename T>
__device__ __forceinline__ void write_staged(T* dst, int64_t dst_row,
                                             const T* src, int src_row,
                                             int per, int valid, int lane) {
  for (int g = lane; g < valid * per; g += 32) {
    const int p = g / per, r = g - p * per;
    T* to = dst + p * dst_row + r * V;
    const T* from = src + p * src_row + r * V;
    if constexpr (V == 4)
      *reinterpret_cast<int4*>(to) = *reinterpret_cast<const int4*>(from);
    else if constexpr (V == 2)
      *reinterpret_cast<int2*>(to) = *reinterpret_cast<const int2*>(from);
    else
      *to = *from;
  }
}

template <int DIM, int F, int LD>
__global__ void __launch_bounds__(kThreads)
hash_encode_kernel(const float* __restrict__ coords,
                   const float* __restrict__ table,
                   const float* __restrict__ ztab, const Lods lods,
                   int64_t n, int f_rt, int ld_rt,
                   float* __restrict__ feats, float* __restrict__ zbar,
                   int32_t* __restrict__ gidx, float* __restrict__ wts) {
  constexpr int C = 1 << DIM;
  // Shared memory of each warp, rows padded against bank conflicts: the
  // corner rows, then the weights, of one LOD (kSaved 32-bit values a
  // point), and the features of kChunk LODs (kFeats floats a point, in
  // vectors of V).
  constexpr int kSaved = C + 4;
  constexpr int V = F % 4 == 0 ? 4 : F % 2 == 0 ? 2 : 1;
  constexpr int kFeats = F > 0 ? kChunk * F + V : 1;
  __shared__ __align__(16) int32_t saved_rows[kThreads / 32][32 * kSaved];
  __shared__ __align__(16) float feat_rows[kThreads / 32][32 * kFeats];
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x - lane;
  if (first >= n) return;              // the whole warp: no lane waits
  const int64_t i = first + lane;
  const bool live = i < n;             // a tail lane computes point n - 1
  const int64_t pt = live ? i : n - 1; // and writes nothing
  const int valid = n - first < 32 ? (int)(n - first) : 32;
  const int f = F > 0 ? F : f_rt;
  const int ld = F > 0 ? LD : ld_rt;
  const int nl = lods.count;
  const uint32_t page_res = (uint32_t)lods.page_res;
  int32_t* saved = saved_rows[threadIdx.x / 32];
  float* staged = feat_rows[threadIdx.x / 32];
  float c[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d)
    c[d] = __fadd_rn(__fmul_rn(__ldg(coords + pt * DIM + d), 0.5f), 0.5f);
  for (int l = 0; l < nl; ++l) {
    int32_t idx[C];
    float w[C];
    corners<DIM>(c, lods.lod[l], page_res, idx, w);
    if (gidx != nullptr) {
      const int64_t at = ((int64_t)l * n + first) * C;
      store_row<C>(saved + lane * kSaved, idx);
      __syncwarp();
      write_staged<4>(gidx + at, C, saved, kSaved, C / 4, valid, lane);
      __syncwarp();
      store_row<C>(reinterpret_cast<float*>(saved) + lane * kSaved, w);
      __syncwarp();
      write_staged<4>(wts + at, C, reinterpret_cast<float*>(saved), kSaved,
                      C / 4, valid, lane);
      __syncwarp();
    }
    float* zout = zbar + ((int64_t)l * n + i) * ld;
    if constexpr (F > 0) {
      float row[C][F];
#pragma unroll
      for (int j = 0; j < C; ++j)
        load_row<F>(row[j], table + (int64_t)idx[j] * F);
      float s[F];
#pragma unroll
      for (int k = 0; k < F; ++k) {
        float p[C];
#pragma unroll
        for (int j = 0; j < C; ++j) p[j] = __fmul_rn(row[j][k], w[j]);
        s[k] = corner_sum<C>(p);
      }
      const int slot = l % kChunk;
      store_row<F>(staged + lane * kFeats + slot * F, s);
      if (slot == kChunk - 1 || l == nl - 1) {
        // LODs l - slot .. l: slot + 1 rows of F floats a point,
        // contiguous in [N, L, F]
        __syncwarp();
        write_staged<V>(feats + (first * nl + l - slot) * F, (int64_t)nl * F,
                        staged, kFeats, (slot + 1) * (F / V), valid, lane);
        __syncwarp();
      }
      if constexpr (LD > 0) {
        if (live && zbar != nullptr) {
          float zrow[C][LD];
#pragma unroll
          for (int j = 0; j < C; ++j)
            load_row<LD>(zrow[j], ztab + (int64_t)idx[j] * LD);
          float z[LD];
#pragma unroll
          for (int k = 0; k < LD; ++k) {
            float p[C];
#pragma unroll
            for (int j = 0; j < C; ++j) p[j] = __fmul_rn(zrow[j][k], w[j]);
            z[k] = corner_sum<C>(p);
          }
          store_row<LD>(zout, z);
        }
      }
    } else if (live) {
      float* out = feats + (i * nl + l) * f;
      for (int k = 0; k < f + (zbar != nullptr ? ld : 0); ++k) {
        const float* col = k < f ? table + k : ztab + (k - f);
        const int stride = k < f ? f : ld;
        float p[C];
#pragma unroll
        for (int j = 0; j < C; ++j)
          p[j] = __fmul_rn(__ldg(col + (int64_t)idx[j] * stride), w[j]);
        const float s = corner_sum<C>(p);
        if (k < f)
          out[k] = s;
        else
          zout[k - f] = s;
      }
    }
  }
}

template <int DIM, int F, int LD>
int launch(const void* coords, const void* table, const void* ztab,
           const Lods& lods, long long n, int f, int ld, void* feats,
           void* zbar, void* gidx, void* w, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  hash_encode_kernel<DIM, F, LD><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const float*)coords, (const float*)table, (const float*)ztab, lods,
      (int64_t)n, f, ld, (float*)feats, (float*)zbar, (int32_t*)gidx,
      (float*)w);
  return (int)cudaGetLastError();
}

template <int DIM>
int launch_width(const void* coords, const void* table, const void* ztab,
                 const Lods& lods, long long n, int f, int ld, void* feats,
                 void* zbar, void* gidx, void* w, cudaStream_t s) {
  if (f == 4 && ld == 1)
    return launch<DIM, 4, 1>(coords, table, ztab, lods, n, f, ld, feats,
                             zbar, gidx, w, s);
  if (f == 4 && ld == 0)
    return launch<DIM, 4, 0>(coords, table, ztab, lods, n, f, ld, feats,
                             zbar, gidx, w, s);
  if (f == 2 && ld == 0)
    return launch<DIM, 2, 0>(coords, table, ztab, lods, n, f, ld, feats,
                             zbar, gidx, w, s);
  if (f == 1 && ld == 1)
    return launch<DIM, 1, 1>(coords, table, ztab, lods, n, f, ld, feats,
                             zbar, gidx, w, s);
  return launch<DIM, 0, 0>(coords, table, ztab, lods, n, f, ld, feats, zbar,
                           gidx, w, s);
}

uintptr_t vector_bytes(int cols) {
  return cols % 4 == 0 ? 16 : cols % 2 == 0 ? 8 : 4;
}

// ---------------------------------------------------------------------------
// Kernel E1(b): the flat encode's backward up to the scatter.
//
// It replaces no Pallas kernel: the JAX package takes the encode's VJP
// through XLA (shacira_tpu/ops/hashgrid.py, hash_encode and
// hash_encode_affine).  The port ran it as eager PyTorch
// (ops/hashgrid.py, backward_updates_plain): a GEMM gz = g @ scale^T, its
// permute, the broadcast product upd = gz * w, a copy of upd where that
// product came out strided, and two einsums for grad_scale and
// grad_shift, which copy g into [L, N, F] order or reduce w first.  At
// V8's step (N = 4,194,304 slots, L = 20, C = 8, F = 4, ld = 2) that was
// ~30 ms of device time a step.
//
// What bounds it.  It has to read g [N, L, F], the corner weights w
// [L, N, C] and the blended latents zbar [L, N, ld] once, and write the
// scatter's rows upd [L, N, C, W] (W = ld, or F without the affine decode)
// once: 10.07 GB at V8's step, 3.0 ms at 3.35 TB/s.  Where a row of g is
// all zero (a masked slot, a padding row) w and zbar need not be read: at
// V8's 36 % masked slots the bound is 2.65 ms.  The arithmetic, W x F
// products a row, is far below the card's.
//
// Design.  g is n-outer and every other tensor l-outer.  A block of 4
// warps takes a tile of 32 consecutive points and stages their g rows at
// every LOD (32 x L x F floats, contiguous in g) in shared memory with
// coalesced loads.  Then each warp takes LODs warp, warp + 4, ...: lane i
// holds point n0 + i at LOD l, reads its w and zbar rows (consecutive
// lanes on consecutive rows: a warp reads 1 KB of w in whole lines),
// computes gz = g . scale^T in registers and adds its terms of grad_scale
// and grad_shift to sums of its own.  The warp stages its 32 rows of w and
// gz in shared memory and writes upd with consecutive lanes on consecutive
// 16-byte vectors (a row of C x W floats is a multiple of 16 bytes), so
// every store fills whole lines.  A row whose g is all zero writes zeros
// and reads neither w nor zbar; that is exact, its products being zero.
//
// grad_scale and grad_shift are deterministic: the grid is one wave of
// blocks that walk the tiles; each block adds its threads' sums in a
// fixed order (a warp butterfly, then the warps in turn) into one column
// of a scratch buffer, and the last block to finish (an integer counter,
// no float atomics) adds the columns in block order.
//
// upd is the eager product's rounding of gz * w; gz is a sum of F products
// (fmaf in order), which the GEMM may take in another order, so upd lies
// within an ulp or two of the eager rows and the two gradients within
// their f32 sums' rounding.  C (4 or 8) and the widths the port's configs
// run are template parameters (C 8: F 4 with ld 2, 1 or none, F 2 with
// none; C 4: F 1 with ld 1); other F and ld up to kMaxWidth take loops
// over columns known at run time.

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdTile = 32;                  // points a tile, one a lane
constexpr int kMaxWidth = 8;                  // the largest F and ld
constexpr int kMaxSums = kMaxWidth * kMaxWidth + kMaxWidth;

// The sum of v over the warp, every lane adding in the same fixed order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// F > 0: F columns of g; F == 0: f_rt of them (up to kMaxWidth).  LD > 0:
// the affine path at ld = LD; LD == -1: the affine path at ld_rt; LD == 0:
// no decode, upd = w * g.
template <int C, int F, int LD>
__global__ void __launch_bounds__(kBwdThreads)
hash_encode_backward_kernel(const float* __restrict__ g,
                            const float* __restrict__ w,
                            const float* __restrict__ zbar,
                            const float* __restrict__ scale, int64_t n,
                            int nl, int f_rt, int ld_rt, int gstride,
                            float* __restrict__ upd,
                            float* __restrict__ partials,
                            unsigned int* __restrict__ done,
                            float* __restrict__ grad_scale,
                            float* __restrict__ grad_shift) {
  constexpr bool kAffine = LD != 0;
  constexpr int kF = F > 0 ? F : kMaxWidth;
  constexpr int kLd = LD > 0 ? LD : LD == 0 ? 1 : kMaxWidth;
  constexpr int kW = kAffine ? kLd : kF;
  const int f = F > 0 ? F : f_rt;
  const int ld = LD > 0 ? LD : ld_rt;
  const int wd = kAffine ? ld : f;            // upd's columns
  extern __shared__ float g_tile[];           // [kBwdTile][gstride]
  __shared__ float w_rows[kBwdWarps][kBwdTile * C];
  __shared__ float gz_rows[kBwdWarps][kBwdTile * kW];
  __shared__ float sc[kAffine ? kLd * kF : 1];
  __shared__ float sums[kBwdWarps][kAffine ? kMaxSums : 1];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lf = nl * f;
  if constexpr (kAffine) {
    for (int i = threadIdx.x; i < kLd * kF; i += kBwdThreads) {
      const int d = i / kF, k = i - d * kF;
      sc[i] = d < ld && k < f ? scale[d * f + k] : 0.0f;
    }
  }
  // this thread's terms of grad_scale [ld, F] and grad_shift [F]
  float acc_s[kLd][kF], acc_h[kF];
#pragma unroll
  for (int k = 0; k < kF; ++k) {
    acc_h[k] = 0.0f;
#pragma unroll
    for (int d = 0; d < kLd; ++d) acc_s[d][k] = 0.0f;
  }
  const int64_t tiles = (n + kBwdTile - 1) / kBwdTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t n0 = t * kBwdTile;
    const int rows = n - n0 < kBwdTile ? (int)(n - n0) : kBwdTile;
    const float* src = g + n0 * lf;
    const int count = rows * lf;
    __syncthreads();              // the last tile's rows (and sc) are done
    if ((lf & 3) == 0) {          // each vector within one point's row
      for (int q = threadIdx.x; 4 * q < count; q += kBwdThreads) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(src) + q);
        const int r = 4 * q / lf;
        float* to = g_tile + r * gstride + (4 * q - r * lf);
        to[0] = v.x; to[1] = v.y; to[2] = v.z; to[3] = v.w;
      }
    } else {
      for (int e = threadIdx.x; e < count; e += kBwdThreads) {
        const int r = e / lf;
        g_tile[r * gstride + (e - r * lf)] = __ldcs(src + e);
      }
    }
    __syncthreads();
    for (int l = warp; l < nl; l += kBwdWarps) {
      float gr[kF], wr[C], gz[kW];
      bool live = false;
#pragma unroll
      for (int k = 0; k < kF; ++k) {
        gr[k] = k < f && lane < rows ? g_tile[lane * gstride + l * f + k]
                                     : 0.0f;
        live |= gr[k] != 0.0f;
      }
#pragma unroll
      for (int j = 0; j < C; ++j) wr[j] = 0.0f;
#pragma unroll
      for (int d = 0; d < kW; ++d) gz[d] = 0.0f;
      if (live) {
        const int64_t row = (int64_t)l * n + n0 + lane;
        load_row<C>(wr, w + row * C);
        if constexpr (kAffine) {
          float zr[kLd];
          if constexpr (LD > 0) {
            load_row<LD>(zr, zbar + row * LD);
          } else {
#pragma unroll
            for (int d = 0; d < kLd; ++d)
              zr[d] = d < ld ? __ldg(zbar + row * ld + d) : 0.0f;
          }
          float ws = 0.0f;
#pragma unroll
          for (int j = 0; j < C; ++j) ws += wr[j];
#pragma unroll
          for (int d = 0; d < kLd; ++d) {
            float s = 0.0f;
#pragma unroll
            for (int k = 0; k < kF; ++k) {
              s = fmaf(gr[k], sc[d * kF + k], s);
              acc_s[d][k] = fmaf(zr[d], gr[k], acc_s[d][k]);
            }
            gz[d] = s;
          }
#pragma unroll
          for (int k = 0; k < kF; ++k) acc_h[k] = fmaf(ws, gr[k], acc_h[k]);
        } else {
#pragma unroll
          for (int d = 0; d < kW; ++d) gz[d] = gr[d];
        }
      }
#pragma unroll
      for (int j = 0; j < C; ++j) w_rows[warp][lane * C + j] = wr[j];
#pragma unroll
      for (int d = 0; d < kW; ++d) gz_rows[warp][lane * kW + d] = gz[d];
      __syncwarp();
      // the warp's rows of upd, [l, n0 .. n0 + rows, C, W]: contiguous
      const int per = C * wd / 4;             // 16-byte vectors a row
      float4* dst = reinterpret_cast<float4*>(
          upd + ((int64_t)l * n + n0) * C * wd);
      for (int q = lane; q < rows * per; q += 32) {
        const int r = q / per, e0 = 4 * (q - r * per);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = (e0 + j) / wd, d = e0 + j - c * wd;
          v[j] = __fmul_rn(gz_rows[warp][r * kW + d],
                           w_rows[warp][r * C + c]);
        }
        __stcs(dst + q, make_float4(v[0], v[1], v[2], v[3]));
      }
      __syncwarp();
    }
  }
  if constexpr (kAffine) {
    // the block's sums: each warp's lanes, then the warps in turn
    const int np = ld * f + f;
#pragma unroll
    for (int d = 0; d < kLd; ++d) {
#pragma unroll
      for (int k = 0; k < kF; ++k) {
        const float v = warp_sum(acc_s[d][k]);
        if (lane == 0 && d < ld && k < f) sums[warp][d * f + k] = v;
      }
    }
#pragma unroll
    for (int k = 0; k < kF; ++k) {
      const float v = warp_sum(acc_h[k]);
      if (lane == 0 && k < f) sums[warp][ld * f + k] = v;
    }
    __syncthreads();
    const int cols = gridDim.x;
    if (threadIdx.x < np) {
      float s = sums[0][threadIdx.x];
      for (int i = 1; i < kBwdWarps; ++i) s += sums[i][threadIdx.x];
      partials[(int64_t)threadIdx.x * cols + blockIdx.x] = s;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(done, 1u) == (unsigned)cols - 1;
    __syncthreads();
    if (!last) return;
    // the last block: every column in block order
    __threadfence();
    for (int p = 0; p < np; ++p) {
      float s = 0.0f;
      for (int b = threadIdx.x; b < cols; b += kBwdThreads)
        s += __ldcg(partials + (int64_t)p * cols + b);
      s = warp_sum(s);
      __syncthreads();            // the last sum's warp totals are read
      if (lane == 0) sums[warp][0] = s;
      __syncthreads();
      if (threadIdx.x == 0) {
        float total = sums[0][0];
        for (int i = 1; i < kBwdWarps; ++i) total += sums[i][0];
        if (p < ld * f)
          grad_scale[p] = total;
        else
          grad_shift[p - ld * f] = total;
      }
    }
  }
}

template <int C, int F, int LD>
int launch_backward(const void* g, const void* w, const void* zbar,
                    const void* scale, long long n, int nl, int f, int ld,
                    void* upd, void* partials, int partial_cols,
                    void* grad_scale, void* grad_shift, cudaStream_t s) {
  const auto kernel = hash_encode_backward_kernel<C, F, LD>;
  const int lf = nl * f;
  const int gstride = lf | 1;       // odd: the lanes' rows on other banks
  const int smem = kBwdTile * gstride * (int)sizeof(float);
  // past 48 KB with the static arrays only where this allows it
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBwdThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // one wave: every block resident, walking the tiles
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long tiles = (n + kBwdTile - 1) / kBwdTile;
  if (blocks > tiles) blocks = tiles;
  unsigned int* done = nullptr;
  if (LD != 0) {
    if (blocks > partial_cols) blocks = partial_cols;
    done = reinterpret_cast<unsigned int*>(
        (float*)partials + (long long)(ld * f + f) * partial_cols);
    err = cudaMemsetAsync(done, 0, sizeof(unsigned int), s);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, kBwdThreads, smem, s>>>(
      (const float*)g, (const float*)w, (const float*)zbar,
      (const float*)scale, (int64_t)n, nl, f, ld, gstride, (float*)upd,
      (float*)partials, done, (float*)grad_scale, (float*)grad_shift);
  return (int)cudaGetLastError();
}

}  // namespace

// coords [n, dim] f32; table [rows, f] f32 (the feature columns) and ztab
// [rows, ld] f32 (the latent columns, ld = 0 and null on the plain path);
// lods points to num_lods host structs Lod; feats [n, num_lods, f] f32;
// zbar [num_lods, n, ld] f32 or null; gidx [num_lods, n, 2^dim] int32 and
// w (the same shape, f32) both given or both null.
extern "C" int hash_encode_forward(const void* coords, const void* table,
                                   int f, const void* ztab, int ld,
                                   const void* lods, int num_lods,
                                   int page_res, long long n, int dim,
                                   void* feats, void* zbar, void* gidx,
                                   void* w, void* stream) {
  if (num_lods < 1 || num_lods > kMaxLods || (dim != 2 && dim != 3) ||
      f < 1 || ld < 0 || page_res < 1 || (ld > 0) != (ztab != nullptr) ||
      (zbar != nullptr && ld == 0) || (gidx == nullptr) != (w == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  if ((uintptr_t)table % vector_bytes(f) ||
      (uintptr_t)feats % vector_bytes(f) ||
      (ld > 0 && ((uintptr_t)ztab % vector_bytes(ld) ||
                  (uintptr_t)zbar % vector_bytes(ld))) ||
      (uintptr_t)gidx % 16 || (uintptr_t)w % 16)
    return (int)cudaErrorMisalignedAddress;
  Lods p;
  memcpy(p.lod, lods, sizeof(Lod) * num_lods);
  p.count = num_lods;
  p.page_res = page_res;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dim == 3)
    return launch_width<3>(coords, table, ztab, p, n, f, ld, feats, zbar,
                           gidx, w, s);
  return launch_width<2>(coords, table, ztab, p, n, f, ld, feats, zbar, gidx,
                         w, s);
}

// Kernel E1(b).  g [n, num_lods, f] f32; w [num_lods, n, corners] f32;
// on the affine path (ld > 0) zbar [num_lods, n, ld] and scale [ld, f]
// f32, partials (at least (ld * f + f) * partial_cols + 1 floats of
// scratch), grad_scale [ld, f] and grad_shift [f] f32, all five null with
// ld = 0; upd [num_lods, n, corners, ld, or f with ld = 0] f32.  With
// n = 0 it launches nothing and leaves grad_scale and grad_shift as they
// are.
extern "C" int hash_encode_backward(const void* g, const void* w,
                                    const void* zbar, const void* scale,
                                    long long n, int num_lods, int corners,
                                    int f, int ld, void* upd, void* partials,
                                    int partial_cols, void* grad_scale,
                                    void* grad_shift, void* stream) {
  const bool affine = ld > 0;
  if (num_lods < 1 || num_lods > kMaxLods ||
      (corners != 4 && corners != 8) || f < 1 || f > kMaxWidth || ld < 0 ||
      ld > kMaxWidth || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;       // the caller zeroes the two sums
  if ((zbar != nullptr) != affine || (scale != nullptr) != affine ||
      (partials != nullptr) != affine || (grad_scale != nullptr) != affine ||
      (grad_shift != nullptr) != affine || (affine && partial_cols < 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if ((uintptr_t)g % 16 || (uintptr_t)w % 16 || (uintptr_t)upd % 16 ||
      (affine && (uintptr_t)zbar % vector_bytes(ld)))
    return (int)cudaErrorMisalignedAddress;
#define E1B_ARGS g, w, zbar, scale, n, num_lods, f, ld, upd, partials, \
                 partial_cols, grad_scale, grad_shift, s
  if (corners == 8) {
    if (f == 4 && ld == 2) return launch_backward<8, 4, 2>(E1B_ARGS);
    if (f == 4 && ld == 1) return launch_backward<8, 4, 1>(E1B_ARGS);
    if (f == 4 && ld == 0) return launch_backward<8, 4, 0>(E1B_ARGS);
    if (f == 2 && ld == 0) return launch_backward<8, 2, 0>(E1B_ARGS);
    if (ld == 0) return launch_backward<8, 0, 0>(E1B_ARGS);
    return launch_backward<8, 0, -1>(E1B_ARGS);
  }
  if (f == 1 && ld == 1) return launch_backward<4, 1, 1>(E1B_ARGS);
  if (ld == 0) return launch_backward<4, 0, 0>(E1B_ARGS);
  return launch_backward<4, 0, -1>(E1B_ARGS);
#undef E1B_ARGS
}
