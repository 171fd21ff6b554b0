// The octree grids' corner query for Hopper (kernel Q1): for every point
// and every active LOD, its cell, the cell's index among the LOD's sorted
// morton codes, the cell's 8 corner rows (its trinket) and the 8
// trilinear weights, in one launch over every LOD.
//
// It replaces no Pallas kernel.  The JAX package leaves the query to XLA
// (shacira_tpu/ops/spc.py:125 query_cells' searchsorted and take, :155
// trilinear_coeffs; shacira_tpu/models/grids/octree_grid.py:132 the
// trinkets' take).  The port ran it as eager PyTorch a LOD at a time
// (ops/spc.py octree_corners_plain): the cell (floor, cast, clamp), three
// spread_bits of about nine int64 ops each, torch.searchsorted, a clamp,
// the compare's gather, a where, the trinkets' gather (one block of
// PyTorch's vectorized gather a 32-byte row) and about twenty elementwise
// ops of trilinear_coeffs and their torch.cat: some forty launches a LOD,
// each taking [N] int64 or f32 temporaries through device memory.
//
// What it computes, for point i of [n, 3] f32 coordinates c and LOD l of
// resolution r = 2^l, as octree_corners_plain computes it:
//   u = c * 0.5 + 0.5 and x = u * r, rounded as PyTorch's elementwise ops
//   round them (each product and sum on its own); cell = clamp(int(floor
//   x), 0, r - 1); key = the cell's morton code (spc.spread_bits /
//   spc.morton3d, x the high bit); j = the first index of the LOD's sorted
//   codes that is >= key (torch.searchsorted, left side), clamped to
//   [0, m - 1]; pidx = codes[j] == key ? j : -1; corner_idx[i, :] =
//   trinkets[max(pidx, 0), :] (a miss takes row 0, as the eager code
//   does); frac = clamp(x - float(cell), 0, 1), g = 1 - frac, and
//   w[i, j] = (X * Y) * Z for corner j at offset ((j >> 2) & 1,
//   (j >> 1) & 1, j & 1), each factor frac where its bit is set and g
//   where not; valid[i] = pidx >= 0.  Every float operation is an
//   explicitly rounded one (__fmul_rn, __fadd_rn, __fsub_rn), so nvcc
//   contracts none into an FMA and the outputs equal the eager code's on
//   the card bit for bit: corner_idx and valid are exact, and w is what
//   spc.trilinear_coeffs gives.
//
// The search is the general one over sorted codes: nothing keys on an
// octree being dense (whose codes are arange), so the sparse point-cloud
// octrees of NGLOD on RTMV and of the SDF datasets take the same path.
//
// What bounds it.  Per point and LOD the kernel writes 32 bytes of corner
// rows, 32 bytes of weights and 1 byte of valid and reads one 32-byte
// trinket row and the matched 8-byte code; the 12 bytes of coordinates
// are read once for all LODs.  At VQAD's step (4 LODs x 4,194,304 points)
// that is 4 x 4,194,304 x 105 + 50,331,648 bytes = 1.81 GB, 0.54 ms at
// 3.35 TB/s.  The binary search adds up to 24 dependent loads a query at
// LOD 8 (16,777,216 codes, 134 MB), whose upper levels stay in L1 and L2:
// points that follow each other along a ray search for nearby keys, so
// the lanes of a warp read the same or neighbouring codes.
//
// Design.  One thread a point, looping over the LODs: the coordinates are
// read once, and the LODs' outputs follow each other.  The search is
// branch-free and takes ceil(log2 m) steps whatever the key, so the lanes
// of a warp never diverge in it.  Codes and trinket rows go through the
// read-only path; a point's corner rows and weights go out as two 16-byte
// stores each, evict-first (st.global.cs): 1.1 GB of outputs a step would
// otherwise push the codes' upper levels out of L2.
//
// Every tensor must be contiguous; the trinkets, corner rows and weights
// 16-byte aligned.  LODs lie in [0, kMaxQueryLod] (10 bits an axis, as
// spc.spread_bits keeps), every LOD has at least one code.  The launch
// goes on the caller's stream; the entry point returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue / cudaErrorMisalignedAddress
// for arguments it does not take.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQueryLods = 16;
constexpr int kMaxQueryLod = 10;

// One LOD of a launch, as ops/spc.py packs it (ctypes _QueryLod).
struct QueryLod {
  const long long* codes;   // [m] int64, sorted ascending
  const int* trinkets;      // [m, 8] int32
  int* corner_idx;          // [n, 8] int32
  float* w;                 // [n, 8] f32
  bool* valid;              // [n]
  long long m;
  int lod;
};

struct QueryLods {
  QueryLod lod[kMaxQueryLods];
  int count;
};

// spc.spread_bits: two zeros between each of the low 10 bits of x.
__device__ __forceinline__ unsigned spread_bits(unsigned x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

// torch.searchsorted(codes, key) on its left side: the first index whose
// code is >= key, in [0, m], m >= 1.  The steps depend on m alone.
__device__ __forceinline__ long long lower_bound(const long long* codes,
                                                 long long m, long long key) {
  long long base = 0;
  for (long long n = m; n > 1;) {
    const long long half = n >> 1;
    base = __ldg(codes + base + half) < key ? base + half : base;
    n -= half;
  }
  return base + (__ldg(codes + base) < key ? 1 : 0);
}

__global__ void __launch_bounds__(kThreads)
octree_query_kernel(const float* __restrict__ coords, long long n,
                    const QueryLods p) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float u[3];                             // c * 0.5 + 0.5
#pragma unroll
  for (int a = 0; a < 3; ++a)
    u[a] = __fadd_rn(__fmul_rn(__ldg(coords + 3 * i + a), 0.5f), 0.5f);
#pragma unroll 1
  for (int k = 0; k < p.count; ++k) {
    const QueryLod& t = p.lod[k];
    const int res = 1 << t.lod;
    unsigned key = 0;
    float f[3], g[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float x = __fmul_rn(u[a], (float)res);
      // a saturating conversion (NaN -> 0), as PyTorch's cast on the card
      int cell = (int)floorf(x);
      cell = cell < 0 ? 0 : (cell > res - 1 ? res - 1 : cell);
      key |= spread_bits((unsigned)cell) << (2 - a);
      float d = __fsub_rn(x, (float)cell);
      d = d < 0.f ? 0.f : (d > 1.f ? 1.f : d);   // torch.clamp: NaN stays
      f[a] = d;
      g[a] = __fsub_rn(1.f, d);
    }
    long long j = lower_bound(t.codes, t.m, (long long)key);
    if (j > t.m - 1) j = t.m - 1;
    const bool hit = __ldg(t.codes + j) == (long long)key;
    const int4* row = reinterpret_cast<const int4*>(t.trinkets) +
                      2 * (hit ? j : 0);
    int4* out_idx = reinterpret_cast<int4*>(t.corner_idx) + 2 * i;
    __stcs(out_idx, __ldg(row));
    __stcs(out_idx + 1, __ldg(row + 1));
    const float xy[4] = {__fmul_rn(g[0], g[1]), __fmul_rn(g[0], f[1]),
                         __fmul_rn(f[0], g[1]), __fmul_rn(f[0], f[1])};
    float4* out_w = reinterpret_cast<float4*>(t.w) + 2 * i;
    __stcs(out_w, make_float4(__fmul_rn(xy[0], g[2]), __fmul_rn(xy[0], f[2]),
                              __fmul_rn(xy[1], g[2]),
                              __fmul_rn(xy[1], f[2])));
    __stcs(out_w + 1, make_float4(__fmul_rn(xy[2], g[2]),
                                  __fmul_rn(xy[2], f[2]),
                                  __fmul_rn(xy[3], g[2]),
                                  __fmul_rn(xy[3], f[2])));
    t.valid[i] = hit;
  }
}

}  // namespace

// Q1 over `count` LODs (a host array of QueryLod) for the n points of
// `coords` ([n, 3] f32), on `stream`: each LOD's corner rows, weights and
// valid flags into its outputs.
extern "C" int octree_query_forward(const void* coords, long long n,
                                    const void* lods, int count,
                                    void* stream) {
  if (count < 1 || count > kMaxQueryLods || n < 0)
    return (int)cudaErrorInvalidValue;
  QueryLods p;
  memcpy(p.lod, lods, sizeof(QueryLod) * count);
  p.count = count;
  for (int k = 0; k < count; ++k) {
    const QueryLod& l = p.lod[k];
    if (l.m < 1 || l.lod < 0 || l.lod > kMaxQueryLod || !l.codes ||
        !l.trinkets || !l.corner_idx || !l.w || !l.valid)
      return (int)cudaErrorInvalidValue;
    if ((uintptr_t)l.trinkets % 16 || (uintptr_t)l.corner_idx % 16 ||
        (uintptr_t)l.w % 16)
      return (int)cudaErrorMisalignedAddress;
  }
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (!coords || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  octree_query_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(coords), n, p);
  return (int)cudaGetLastError();
}
