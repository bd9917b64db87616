// Stochastic quantize + bit-pack, and unpack + dequantize, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of src/repro/kernels/quant_pack.py:
//   quant_pack_kernel     <- `_quant_pack_kernel` (:28), driven by `quant_pack` (:63)
//   dequant_unpack_kernel <- `_dequant_unpack_kernel` (:49), driven by `dequant_unpack` (:103)
//
// quant_pack, per 4-row group g of x [R, F] (R % 4 == 0):
//   lo = min, hi = max over the group's 4*F values
//   scale = (hi - lo) / levels            (levels = 2^bits - 1; 0 if hi == lo)
//   rcp = scale > 0 ? 1 / scale : 0
//   q = clip(floor((x - lo) * rcp + noise), 0, levels)
//   packed[r, w] = sum_j q[r, w*per_word + j] << (j*bits),  per_word = 32/bits
// F need not be a multiple of per_word: a row takes ceil(F / per_word) words
// and the fields past F stay zero. dequant_unpack: out = q * scale + zero.
//
// Bit-exactness with the plain PyTorch versions (kernels/ref.py): every
// operation is rounded on its own, as the plain version's separate tensor
// ops are. The arithmetic is written with __fsub_rn / __fmul_rn / __fadd_rn /
// __fdiv_rn, which nvcc never contracts into an FMA (an FMA would skip the
// rounding of the product and move values across floor()). The scale is a
// true IEEE division, as the training path of the JAX package divides
// (ROADMAP C-ref2), not the Pallas kernel's multiply by 1/levels. Never
// build this file with --use_fast_math.
//
// What bounds it on this card: memory. quant_pack reads x and noise (8 B per
// value) and writes bits/8 B per value plus 8 B per group; it does a few
// operations per value, far below the H100's ~20 flop/byte fp32 balance.
// dequant_unpack is the reverse. The design:
//   * quant_pack: one block per 4-row group. Its 4*F values (4 KB at
//     F = 256) are read once for the min/max (warp shuffles, then one warp
//     over the per-warp results) and again, from L1/L2, by one thread per
//     packed word, which builds the word in a register and stores it once;
//   * dequant_unpack: one thread per output value, neighbouring threads on
//     neighbouring outputs (coalesced fp32 stores); the packed word and the
//     group's zero/scale are re-read from L1 by the threads that share them.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowGroup = 4;
constexpr int kPackThreads = 128;
constexpr int kUnpackThreads = 256;

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

__global__ void __launch_bounds__(kPackThreads)
quant_pack_kernel(const float* __restrict__ x, const float* __restrict__ noise,
                  int* __restrict__ packed, float* __restrict__ zero,
                  float* __restrict__ scale, int feat, int words, int bits) {
  __shared__ float s_lo[kPackThreads / 32];
  __shared__ float s_hi[kPackThreads / 32];
  const int g = blockIdx.x;
  const int n = kRowGroup * feat;
  const float* xg = x + static_cast<int64_t>(g) * n;
  const float* ug = noise + static_cast<int64_t>(g) * n;

  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kPackThreads) {
    const float v = __ldg(xg + i);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  warp_minmax(lo, hi);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kPackThreads / 32 ? s_lo[lane] : INFINITY;
    hi = lane < kPackThreads / 32 ? s_hi[lane] : -INFINITY;
    warp_minmax(lo, hi);
    if (lane == 0) {
      s_lo[0] = lo;
      s_hi[0] = hi;
    }
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];

  const float levels = static_cast<float>((1 << bits) - 1);
  const float sc = __fdiv_rn(__fsub_rn(hi, lo), levels);
  const bool pos = sc > 0.0f;
  const float rcp = pos ? __fdiv_rn(1.0f, sc) : 0.0f;
  const int per_word = 32 / bits;

  for (int i = threadIdx.x; i < kRowGroup * words; i += kPackThreads) {
    const int r = i / words, wd = i % words;
    const int f0 = wd * per_word;
    const int nf = min(per_word, feat - f0);
    const float* xr = xg + r * feat + f0;
    const float* ur = ug + r * feat + f0;
    unsigned int word = 0u;
    for (int j = 0; j < nf; ++j) {
      const float xs = __fmul_rn(__fsub_rn(__ldg(xr + j), lo), rcp);
      const float q = fminf(fmaxf(floorf(__fadd_rn(xs, __ldg(ur + j))), 0.0f), levels);
      word |= static_cast<unsigned int>(q) << (j * bits);
    }
    packed[(static_cast<int64_t>(g) * kRowGroup + r) * words + wd] =
        static_cast<int>(word);
  }
  if (threadIdx.x == 0) {
    zero[g] = lo;
    scale[g] = pos ? sc : 0.0f;
  }
}

__global__ void __launch_bounds__(kUnpackThreads)
dequant_unpack_kernel(const int* __restrict__ packed, const float* __restrict__ zero,
                      const float* __restrict__ scale, float* __restrict__ out,
                      int64_t total, int feat, int words, int bits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kUnpackThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t r = i / feat;
  const int f = static_cast<int>(i - r * feat);
  const int per_word = 32 / bits;
  const unsigned int word =
      static_cast<unsigned int>(__ldg(packed + r * words + f / per_word));
  const unsigned int q = (word >> ((f % per_word) * bits)) & ((1u << bits) - 1u);
  const int64_t g = r / kRowGroup;
  out[i] = __fadd_rn(__fmul_rn(static_cast<float>(q), __ldg(scale + g)), __ldg(zero + g));
}

}  // namespace

// x, noise [groups*4, feat] f32 -> packed [groups*4, words] i32 (words =
// ceil(feat / (32/bits))), zero, scale [groups] f32; all contiguous on the
// current device. Launches on `stream`, returns cudaGetLastError() (0 = ok).
extern "C" int quant_pack_f32(const void* x, const void* noise, void* packed,
                              void* zero, void* scale, int groups, int feat,
                              int bits, void* stream) {
  if (groups <= 0 || feat <= 0 || (bits != 2 && bits != 4 && bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (feat + 32 / bits - 1) / (32 / bits);
  quant_pack_kernel<<<groups, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(noise),
      static_cast<int*>(packed), static_cast<float*>(zero),
      static_cast<float*>(scale), feat, words, bits);
  return static_cast<int>(cudaGetLastError());
}

// packed [rows, words] i32, zero/scale [rows/4] f32 -> out [rows, feat] f32.
extern "C" int dequant_unpack_f32(const void* packed, const void* zero,
                                  const void* scale, void* out, int rows,
                                  int feat, int bits, void* stream) {
  if (rows <= 0 || rows % kRowGroup || feat <= 0 ||
      (bits != 2 && bits != 4 && bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (feat + 32 / bits - 1) / (32 / bits);
  const int64_t total = static_cast<int64_t>(rows) * feat;
  const int64_t blocks = (total + kUnpackThreads - 1) / kUnpackThreads;
  dequant_unpack_kernel<<<static_cast<unsigned int>(blocks), kUnpackThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), static_cast<const float*>(zero),
      static_cast<const float*>(scale), static_cast<float*>(out), total, feat,
      words, bits);
  return static_cast<int>(cudaGetLastError());
}
