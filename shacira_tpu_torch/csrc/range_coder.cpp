// Native arithmetic coder for SHACIRA latent streams (host code, built with
// g++ by shacira_tpu_torch/ops/coding.py; not a CUDA kernel).
//
// A copy of the JAX package's shacira_tpu/csrc/range_coder.cpp: the
// static-CDF Witten-Neal-Cleary arithmetic coder of ops/coding.py, same
// bitstream as its pure-Python plain version (tested byte for byte).  The
// Python coder is exact but takes minutes on a lego-scale table (7,879,908
// symbols per latent channel).
//
// Exposed as a C ABI consumed via ctypes.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecision = 16;
constexpr uint64_t kFull = 0xFFFFFFFFull;
constexpr uint64_t kHalf = 0x80000000ull;
constexpr uint64_t kQuarter = 0x40000000ull;

struct BitWriter {
  std::vector<uint8_t>* out;
  uint8_t acc = 0;
  int nbits = 0;
  void write(int bit) {
    acc = static_cast<uint8_t>((acc << 1) | bit);
    if (++nbits == 8) {
      out->push_back(acc);
      acc = 0;
      nbits = 0;
    }
  }
  void finish() {
    if (nbits) out->push_back(static_cast<uint8_t>(acc << (8 - nbits)));
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos = 0;
  int read() {
    int64_t byte_i = pos >> 3;
    int bit_i = static_cast<int>(pos & 7);
    ++pos;
    if (byte_i >= size) return 0;
    return (data[byte_i] >> (7 - bit_i)) & 1;
  }
};

// Quantized strictly-increasing integer CDF; mirrors coding._quantize_cdf.
std::vector<int64_t> quantize_cdf(const double* probs, int n) {
  double total = 0;
  for (int i = 0; i < n; ++i) total += probs[i];
  int64_t scale = (1ll << kPrecision) - n;
  std::vector<int64_t> cdf(n + 1, 0);
  int64_t acc = 0;
  for (int i = 0; i < n; ++i) {
    double p = probs[i] / total;
    // round-half-to-even to match numpy's np.round in coding._quantize_cdf
    int64_t f = llrint(p * scale);
    if (f < 1) f = 1;
    acc += f;
    cdf[i + 1] = acc;
  }
  int64_t tot = cdf[n];
  for (int i = 0; i <= n; ++i) cdf[i] = cdf[i] * scale / tot + i;
  return cdf;
}

}  // namespace

extern "C" {

// Encode `num` symbols (each in [0, n_symbols)) with shared probabilities.
// Returns number of bytes written into `out` (caller provides capacity
// >= num * 4 + 16 bytes which upper-bounds any stream this coder emits for
// n_symbols <= 2^16).
int64_t rc_encode(const int32_t* symbols, int64_t num, const double* probs,
                  int n_symbols, uint8_t* out, int64_t out_capacity) {
  std::vector<int64_t> cdf = quantize_cdf(probs, n_symbols);
  int64_t total = cdf[n_symbols];
  std::vector<uint8_t> buf;
  buf.reserve(num / 2 + 64);
  BitWriter w{&buf};
  uint64_t low = 0, high = kFull;
  int64_t pending = 0;
  auto emit = [&](int bit) {
    w.write(bit);
    for (; pending > 0; --pending) w.write(1 - bit);
  };
  for (int64_t k = 0; k < num; ++k) {
    int s = symbols[k];
    uint64_t span = high - low + 1;
    high = low + span * static_cast<uint64_t>(cdf[s + 1]) / total - 1;
    low = low + span * static_cast<uint64_t>(cdf[s]) / total;
    for (;;) {
      if (high < kHalf) {
        emit(0);
      } else if (low >= kHalf) {
        emit(1);
        low -= kHalf;
        high -= kHalf;
      } else if (low >= kQuarter && high < 3 * kQuarter) {
        ++pending;
        low -= kQuarter;
        high -= kQuarter;
      } else {
        break;
      }
      low <<= 1;
      high = (high << 1) | 1;
    }
  }
  ++pending;
  emit(low < kQuarter ? 0 : 1);
  w.finish();
  if (static_cast<int64_t>(buf.size()) > out_capacity) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

// Decode `num` symbols; returns 0 on success.
int rc_decode(const uint8_t* data, int64_t data_size, int64_t num,
              const double* probs, int n_symbols, int32_t* out) {
  std::vector<int64_t> cdf = quantize_cdf(probs, n_symbols);
  int64_t total = cdf[n_symbols];
  BitReader r{data, data_size};
  uint64_t code = 0;
  for (int i = 0; i < 32; ++i) code = (code << 1) | r.read();
  uint64_t low = 0, high = kFull;
  for (int64_t k = 0; k < num; ++k) {
    uint64_t span = high - low + 1;
    int64_t val = static_cast<int64_t>(
        ((code - low + 1) * static_cast<uint64_t>(total) - 1) / span);
    // binary search: largest s in [0, n_symbols-1] with cdf[s] <= val
    int lo = 0, hi = n_symbols - 1;
    while (lo < hi) {
      int mid = (lo + hi + 1) / 2;
      if (cdf[mid] <= val) lo = mid; else hi = mid - 1;
    }
    int s = lo;
    out[k] = s;
    high = low + span * static_cast<uint64_t>(cdf[s + 1]) / total - 1;
    low = low + span * static_cast<uint64_t>(cdf[s]) / total;
    for (;;) {
      if (high < kHalf) {
      } else if (low >= kHalf) {
        low -= kHalf;
        high -= kHalf;
        code -= kHalf;
      } else if (low >= kQuarter && high < 3 * kQuarter) {
        low -= kQuarter;
        high -= kQuarter;
        code -= kQuarter;
      } else {
        break;
      }
      low <<= 1;
      high = (high << 1) | 1;
      code = (code << 1) | r.read();
    }
  }
  return 0;
}

}  // extern "C"
