// VQAD's straight-through codebook mix and trilinear blend, for Hopper
// (kernels M1 and M1(b)): every LOD of a training step in one launch each
// way.
//
// It replaces no Pallas kernel.  The JAX package leaves the mix to XLA
// (shacira_tpu/models/grids/octree_grid.py:194-203, _codebook_lookup:
// softmax, argmax, one-hot, y_soft + stop_gradient(hard - y_soft), the
// einsum with the dictionary) and blends the corners with a plain sum.
// The port ran that as eager PyTorch over the gathered logits [N, 8, D]
// of each LOD: softmax, argmax, zeros_like, scatter_, the subtract, the
// add, an f32 GEMM and the blend, each reading or writing the whole
// tensor, and as many again in the backward, with y_soft and the keys
// kept for it.
//
// What it computes.  For sample n of a LOD, corner c and its row of
// logits l[c, :D]: y = softmax(l[c]) as PyTorch's warp softmax computes
// it (m = max, e = expf(l - m), s = the sum of e in that kernel's order,
// y = e / s); a = the first maximum of y; the keys y_d + ((d == a) - y_d)
// in f32, which are exactly 0 off a and y_a + (1 - y_a) at a, y_a = 1 /
// s.  Forward: out[n, :] = v[n] ? sum_c w[n, c] * keys[c, a_c] *
// dict[a_c, :] : 0, the products rounded as PyTorch rounds cf * w and the
// corners summed in the order of PyTorch's sum over them.  Backward, from
// the output gradient g[n, :]: gv = v ? g : 0, the keys' gradient t_d =
// w[c] * (dict[d, :] . gv), and the softmax's gradient dl[c, d] = y_d t_d
// - y_d sum_e y_e t_e (softmax_backward's form); the dictionary's
// gradient ddict[a_c, :] += keys[c, a_c] * w[c] * gv, summed per sample
// over the corners, per lane over its samples, per block in shared memory
// and then one atomic add per entry and block.  No
// gradient goes to w.  Everything is f32; expf, the reciprocal and the
// divisions are the IEEE ones (no fast math), so y, a and the keys equal
// PyTorch's on the card bit for bit, in both directions, and so do the
// forward's features.
//
// What bounds it.  The least time is set by the bytes.  At VQAD's step
// (4 LODs x 4,194,304 samples x 8 corners, D 16, F 5) the forward reads
// the logits (8.59 GB), the weights (0.54 GB) and the masks and writes
// the features (0.34 GB): 9.48 GB, 2.83 ms at 3.35 TB/s.  The backward
// reads the logits, weights, masks and the output gradients again and
// writes the logits' gradients (8.59 GB): 18.07 GB, 5.39 ms.  Nothing
// else goes to memory: y, a and the keys are recomputed in registers in
// the backward, not saved by the forward.  On an H100 SXM (700 W) the
// kernels take 4.19 and 7.56 ms there, about 70 % of those bounds: the
// instructions a sample needs (the IEEE expf and divisions, which the
// bit-equal argmax asks for, and the shuffles) are what is left.
//
// Design.  A warp takes one sample at a time: lane 4c + j holds floats
// [jV, jV + V) of corner c's row (V = D / 4), so one load instruction of
// the warp reads the sample's 8 x D contiguous floats whole (16 bytes a
// lane at D = 16).  A row's max, sum and argmax are reduced with
// shuffles among its 4 lanes, the blend over the 8 corners with shuffles
// across the warp; the dictionary of the block's LOD sits in shared
// memory.  Each warp walks its LOD's samples with a grid stride, one at a
// time: two or four in flight a warp were slower on the card, the
// registers they take costing more occupancy than they hide.  The blocks
// of a launch are as many as the card holds at once, split among the
// LODs by their samples, and each block takes one LOD.
//
// D (the dictionary size: 4 to 64, codebook_bitwidth 2 to 6) and FP (F
// rounded up to 4, 8 or 16) are template parameters; F itself (1 to 16)
// comes at run time.  Other widths return cudaErrorInvalidValue; the
// wrapper (ops/codebook.py) refuses them first.  The logits and their
// gradients must be aligned to their vector width (16 bytes from D 16),
// every tensor contiguous.  Launches
// go on the caller's stream; each entry point returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue / cudaErrorMisalignedAddress
// for arguments it does not take.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMixLods = 16;
constexpr unsigned kFull = 0xffffffffu;
// e_d / s can round to 1 / s, and tie with the maximum, only where e_d is
// within a few ulps of 1 (s >= 1): below 1 - 2^-20 the division is
// skipped.
constexpr float kNearOne = 0.99999904632568359375f;

// One LOD of a launch, as ops/codebook.py packs it (ctypes _MixLod).
struct MixLod {
  const void* logits;       // [n, 8, D] f32
  const void* weights;      // [n, 8] f32
  const void* valid;        // [n] bool
  const void* dictionary;   // [D, F] f32
  const void* grad_out;     // [n, F] f32 (backward)
  void* out;                // [n, F] f32 (forward)
  void* grad_logits;        // [n, 8, D] f32 (backward; null: not written)
  void* grad_dictionary;    // [D, F] f32, zeroed (backward; null: none)
  long long n;
  long long first_block;    // set by the launcher
  long long blocks;         // set by the launcher
};

struct MixLods {
  MixLod lod[kMaxMixLods];
  int count;
  int f;
};

__device__ __forceinline__ int block_lod(const MixLods& p) {
  int k = 0;
  while (k + 1 < p.count && p.lod[k + 1].first_block <= (long long)blockIdx.x)
    ++k;
  return k;
}

// The lane's V floats of a row, read once (streaming).
template <int V>
__device__ __forceinline__ void load_part(const float* p, float (&x)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 q = __ldcs(reinterpret_cast<const float4*>(p) + k);
      x[4 * k] = q.x, x[4 * k + 1] = q.y, x[4 * k + 2] = q.z;
      x[4 * k + 3] = q.w;
    }
  } else if constexpr (V == 2) {
    const float2 q = __ldcs(reinterpret_cast<const float2*>(p));
    x[0] = q.x, x[1] = q.y;
  } else {
    x[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void store_part(float* p, const float (&x)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k)
      __stcs(reinterpret_cast<float4*>(p) + k,
             make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
    __stcs(p, x[0]);
  }
}

// e = expf(l - max) of a row held by its 4 lanes (lane j: elements jV +
// i), and the row's sum of e in the order of PyTorch's warp softmax: it
// adds the elements d and d + D/2 first, then halves again down to
// neighbours.  The top two bits of d are the lane's, so those two steps
// are shuffles, the rest in registers.  Every lane of the row returns the
// same sum.
template <int V>
__device__ __forceinline__ float row_exp_sum(const float (&x)[V],
                                             float (&e)[V]) {
  float m = x[0];
#pragma unroll
  for (int i = 1; i < V; ++i) m = fmaxf(m, x[i]);
#pragma unroll
  for (int off = 1; off <= 2; off *= 2)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  float t[V];
#pragma unroll
  for (int i = 0; i < V; ++i) t[i] = e[i] = expf(__fsub_rn(x[i], m));
#pragma unroll
  for (int off = 2; off >= 1; off /= 2) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      t[i] = __fadd_rn(t[i], __shfl_xor_sync(kFull, t[i], off));
  }
#pragma unroll
  for (int h = V / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int i = 0; i < h; ++i) t[i] = __fadd_rn(t[i], t[i + h]);
  }
  return t[0];
}

// The first index of the row's maximum of y among the 4 lanes' marks
// (lane j marks its first element equal to the maximum, else D).  A row
// with a NaN has none and takes entry 0: its keys are NaN either way.
template <int V>
__device__ __forceinline__ int row_first(int mark) {
#pragma unroll
  for (int off = 1; off <= 2; off *= 2)
    mark = min(mark, __shfl_xor_sync(kFull, mark, off));
  return mark < 4 * V ? mark : 0;
}

// The first maximum of y = e / s from e alone.  y_d is 1 / s where e_d
// is 1, and an e_d just below 1 may round to it too: only where one does
// (rarely) are the divisions made, in a branch the whole warp takes or
// skips.
template <int V>
__device__ __forceinline__ int first_max_of_y(const float (&e)[V], float s,
                                              float rcp, int j) {
  bool near = false;
#pragma unroll
  for (int i = 0; i < V; ++i) near |= e[i] >= kNearOne && e[i] != 1.0f;
  int mark = 4 * V;
  if (__any_sync(kFull, near)) {
#pragma unroll
    for (int i = V - 1; i >= 0; --i)
      if (__fdiv_rn(e[i], s) == rcp) mark = j * V + i;
  } else {
#pragma unroll
    for (int i = V - 1; i >= 0; --i)
      if (e[i] == 1.0f) mark = j * V + i;
  }
  return row_first<V>(mark);
}

// The keys' one non-zero value, y_a + (1 - y_a), y_a = 1 / s.
__device__ __forceinline__ float key_of(float rcp) {
  return __fadd_rn(rcp, __fsub_rn(1.0f, rcp));
}

template <int D, int FP>
__global__ void __launch_bounds__(kThreads)
mix_forward_kernel(const MixLods p) {
  constexpr int V = D / 4;
  __shared__ float dict_s[D * FP];
  const int k = block_lod(p);
  const float* __restrict__ logits = static_cast<const float*>(p.lod[k].logits);
  const float* __restrict__ weights =
      static_cast<const float*>(p.lod[k].weights);
  const bool* __restrict__ valid = static_cast<const bool*>(p.lod[k].valid);
  const float* __restrict__ dict =
      static_cast<const float*>(p.lod[k].dictionary);
  float* __restrict__ out = static_cast<float*>(p.lod[k].out);
  const long long n = p.lod[k].n;
  const int F = p.f;
  for (int i = threadIdx.x; i < D * F; i += kThreads) dict_s[i] = dict[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, c = lane >> 2, j = lane & 3;
  const long long stride = p.lod[k].blocks * kWarps;
  const long long first =
      ((long long)blockIdx.x - p.lod[k].first_block) * kWarps +
      (threadIdx.x >> 5);
  // the warp's sample t: the same for all its lanes, so every branch on it
  // is uniform
  for (long long t = first; t < n; t += stride) {
    float x[V], e[V];
    load_part<V>(logits + (t * 8 + c) * D + j * V, x);
    const float w = __ldg(weights + t * 8 + c);
    const bool ok = valid[t];
    const float s = row_exp_sum<V>(x, e);
    const float rcp = __frcp_rn(s);
    const int a = first_max_of_y<V>(e, s, rcp, j);
    const float key = key_of(rcp);
#pragma unroll
    for (int q = 0; q < FP / 4; ++q) {
      const int f = j + 4 * q;
      // cf = key * dict (the product with the keys' zeros adds nothing),
      // then cf * w, rounded apart as PyTorch rounds them
      float v = f < F ? __fmul_rn(__fmul_rn(key, dict_s[a * F + f]), w)
                      : 0.0f;
      // PyTorch's sum over the 8 corners: four accumulators, corner c into
      // c % 4, added in accumulator order
      v = __fadd_rn(v, __shfl_xor_sync(kFull, v, 16));
      const float v1 = __shfl_sync(kFull, v, j + 4);
      const float v2 = __shfl_sync(kFull, v, j + 8);
      const float v3 = __shfl_sync(kFull, v, j + 12);
      if (c == 0 && f < F)
        out[t * F + f] =
            ok ? __fadd_rn(__fadd_rn(__fadd_rn(v, v1), v2), v3) : 0.0f;
    }
  }
}

// One level of a sum over the 8 corners (lanes 4c + j of one j; `off`
// flips a bit of c) of the C values u[0..C) a lane holds.  With C > 1 the
// lane keeps half, the upper where `upper`, in u[0..C/2), and adds the
// partner's; with C = 1 both lanes keep the whole sum.
template <int C>
__device__ __forceinline__ void corner_level(float* u, int off, bool upper) {
  if constexpr (C > 1) {
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float give = upper ? u[i] : u[i + C / 2];
      const float keep = upper ? u[i + C / 2] : u[i];
      u[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, give, off));
    }
  } else {
    u[0] = __fadd_rn(u[0], __shfl_xor_sync(kFull, u[0], off));
  }
}

template <int D, int FP>
__global__ void __launch_bounds__(kThreads)
mix_backward_kernel(const MixLods p) {
  constexpr int V = D / 4;
  constexpr int P = V > 8 ? V / 8 : 1;    // products dict[d, :] . gv a lane
  // the corner sums leave C3 entries a lane; lanes 4c + j that share them
  // (R of them, c >> LS their rank) split the columns
  constexpr int C1 = V > 1 ? V / 2 : 1, C2 = C1 > 1 ? C1 / 2 : 1;
  constexpr int C3 = C2 > 1 ? C2 / 2 : 1;
  constexpr int LS = V >= 8 ? 3 : V == 4 ? 2 : V == 2 ? 1 : 0;
  constexpr int R = 8 >> LS;
  constexpr int FR = (FP + R - 1) / R;    // columns a lane sums
  __shared__ float dict_s[D * FP];
  __shared__ float part_s[kWarps][D * FP];
  const int k = block_lod(p);
  const float* __restrict__ logits = static_cast<const float*>(p.lod[k].logits);
  const float* __restrict__ weights =
      static_cast<const float*>(p.lod[k].weights);
  const bool* __restrict__ valid = static_cast<const bool*>(p.lod[k].valid);
  const float* __restrict__ dict =
      static_cast<const float*>(p.lod[k].dictionary);
  const float* __restrict__ grad = static_cast<const float*>(p.lod[k].grad_out);
  float* __restrict__ dl = static_cast<float*>(p.lod[k].grad_logits);
  float* __restrict__ ddict = static_cast<float*>(p.lod[k].grad_dictionary);
  const long long n = p.lod[k].n;
  const int F = p.f;
  for (int i = threadIdx.x; i < D * F; i += kThreads) dict_s[i] = dict[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, c = lane >> 2, j = lane & 3;
  const int warp = threadIdx.x >> 5, rank = c >> LS;
  // the lane's corner sums are of entries jV + at + q, q < C3
  const int at = (V > 1 && (c & 1) ? V / 2 : 0) +
                 (C1 > 1 && ((c >> 1) & 1) ? C1 / 2 : 0) +
                 (C2 > 1 && ((c >> 2) & 1) ? C2 / 2 : 0);
  const long long stride = p.lod[k].blocks * kWarps;
  const long long first =
      ((long long)blockIdx.x - p.lod[k].first_block) * kWarps + warp;
  float acc[C3][FR];        // ddict[jV + at + q, rank + R m] of the lane
#pragma unroll
  for (int q = 0; q < C3; ++q)
#pragma unroll
    for (int m = 0; m < FR; ++m) acc[q][m] = 0.0f;
  for (long long t = first; t < n; t += stride) {   // the warp's sample
    float x[V], e[V], y[V], g[FP];
    load_part<V>(logits + (t * 8 + c) * D + j * V, x);
    const float w = __ldg(weights + t * 8 + c);
    const bool ok = valid[t];
#pragma unroll
    for (int f = 0; f < FP; ++f)
      g[f] = ok && f < F ? __ldg(grad + t * F + f) : 0.0f;
    const float s = row_exp_sum<V>(x, e);
    const float rcp = __frcp_rn(s);
    int mark = D;
#pragma unroll
    for (int i = V - 1; i >= 0; --i) {
      y[i] = __fdiv_rn(e[i], s);
      if (y[i] == rcp) mark = j * V + i;
    }
    const int a = row_first<V>(mark);
    if (dl != nullptr) {
      // the keys' gradient t_d = w_c * (dict[d, :] . gv): the products are
      // the sample's, so the row's 8 lanes of one j share them
      float pv[P];
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int i = V > 8 ? c + 8 * r : c % V;
        float sum = 0.0f;
#pragma unroll
        for (int f = 0; f < FP; ++f)
          if (f < F) sum = fmaf(dict_s[(j * V + i) * F + f], g[f], sum);
        pv[r] = sum;
      }
      // softmax_backward: y * t - y * sum(y * t)
      float td[V], sum = 0.0f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float pd = __shfl_sync(kFull, pv[i / 8], (i % 8) * 4 + j);
        td[i] = __fmul_rn(__fmul_rn(w, pd), y[i]);
        sum = __fadd_rn(sum, td[i]);
      }
      sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, 2));
      float d[V];
#pragma unroll
      for (int i = 0; i < V; ++i) d[i] = fmaf(-y[i], sum, td[i]);
      store_part<V>(dl + (t * 8 + c) * D + j * V, d);
    }
    if (ddict != nullptr) {
      // h_d = the sum over the corners whose key is d of key * w_c, then
      // ddict[d, f] += h_d * gv_f
      const float kw = __fmul_rn(key_of(rcp), w);
      float h[V];
#pragma unroll
      for (int i = 0; i < V; ++i) h[i] = j * V + i == a ? kw : 0.0f;
      corner_level<V>(h, 4, c & 1);
      corner_level<C1>(h, 8, (c >> 1) & 1);
      corner_level<C2>(h, 16, (c >> 2) & 1);
#pragma unroll
      for (int f = 0; f < FP; ++f) {
        if (f % R == rank) {
#pragma unroll
          for (int q = 0; q < C3; ++q)
            acc[q][f / R] = fmaf(h[q], g[f], acc[q][f / R]);
        }
      }
    }
  }
  if (ddict == nullptr) return;                 // uniform over the block
  // each (d, f) of the dictionary is one lane's of every warp
#pragma unroll
  for (int q = 0; q < C3; ++q)
#pragma unroll
    for (int f = 0; f < FP; ++f)
      if (f % R == rank && f < F)
        part_s[warp][(j * V + at + q) * F + f] = acc[q][f / R];
  __syncthreads();
  for (int i = threadIdx.x; i < D * F; i += kThreads) {
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) sum += part_s[q][i];
    if (sum != 0.0f) atomicAdd(ddict + i, sum);
  }
}

// The blocks of a launch: as many as the card holds at once, split among
// the LODs in proportion to their samples (at least one a LOD with
// samples, at most one a sample of each warp).
template <typename Kernel>
long long split_blocks(MixLods& p, Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long target = (long long)sms * (per_sm > 0 ? per_sm : 1);
  long long total = 0, blocks = 0;
  for (int k = 0; k < p.count; ++k) total += p.lod[k].n;
  for (int k = 0; k < p.count; ++k) {
    const long long n = p.lod[k].n;
    const long long most = (n + kWarps - 1) / kWarps;
    long long b = n > 0 ? (target * n + total - 1) / total : 0;
    b = b < 1 && n > 0 ? 1 : b;
    p.lod[k].first_block = blocks;
    p.lod[k].blocks = b < most ? b : most;
    blocks += p.lod[k].blocks;
  }
  return blocks;
}

template <int D, int FP>
int launch(MixLods& p, bool backward, cudaStream_t stream) {
  if (backward) {
    const long long blocks = split_blocks(p, mix_backward_kernel<D, FP>);
    if (blocks > 0)
      mix_backward_kernel<D, FP><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  } else {
    const long long blocks = split_blocks(p, mix_forward_kernel<D, FP>);
    if (blocks > 0)
      mix_forward_kernel<D, FP><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_width(MixLods& p, bool backward, cudaStream_t stream) {
  if (p.f <= 4) return launch<D, 4>(p, backward, stream);
  if (p.f <= 8) return launch<D, 8>(p, backward, stream);
  return launch<D, 16>(p, backward, stream);
}

int run(const void* lods, int count, int d, int f, bool backward,
        void* stream) {
  if (count < 1 || count > kMaxMixLods || f < 1 || f > 16 ||
      (d != 4 && d != 8 && d != 16 && d != 32 && d != 64))
    return (int)cudaErrorInvalidValue;
  MixLods p;
  memcpy(p.lod, lods, sizeof(MixLod) * count);
  p.count = count;
  p.f = f;
  const uintptr_t align = d >= 16 ? 16 : (uintptr_t)d;   // V floats
  for (int k = 0; k < count; ++k) {
    const MixLod& l = p.lod[k];
    if (l.n < 0 || (backward ? l.grad_out == nullptr : l.out == nullptr))
      return (int)cudaErrorInvalidValue;
    if ((uintptr_t)l.logits % align || (uintptr_t)l.grad_logits % align)
      return (int)cudaErrorMisalignedAddress;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 4: return launch_width<4>(p, backward, s);
    case 8: return launch_width<8>(p, backward, s);
    case 16: return launch_width<16>(p, backward, s);
    case 32: return launch_width<32>(p, backward, s);
    default: return launch_width<64>(p, backward, s);
  }
}

}  // namespace

// M1 over `count` LODs (a host array of MixLod, first_block and blocks
// unset) of dictionary size d and feature width f, on `stream`: each
// LOD's blended features into its `out`.
extern "C" int codebook_mix_forward(const void* lods, int count, int d, int f,
                                    void* stream) {
  return run(lods, count, d, f, false, stream);
}

// M1(b): each LOD's logits' gradient into `grad_logits` and its
// dictionary's added into the zeroed `grad_dictionary` (either null: not
// computed), from the output gradients `grad_out`.
extern "C" int codebook_mix_backward(const void* lods, int count, int d,
                                     int f, void* stream) {
  return run(lods, count, d, f, true, stream);
}
