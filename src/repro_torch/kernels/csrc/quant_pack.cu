// Stochastic quantize + bit-pack, and unpack + dequantize, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of src/repro/kernels/quant_pack.py:
//   quant_pack_regs / quant_pack_loop <- `_quant_pack_kernel` (:28), driven by `quant_pack` (:63)
//   dequant_unpack_kernel             <- `_dequant_unpack_kernel` (:49), driven by `dequant_unpack` (:103)
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
// (ROADMAP C-ref2), not the Pallas kernel's multiply by 1/levels. The min,
// the max and the clip are fminf / fmaxf. Never build this file with
// --use_fast_math.
//
// What bounds it on this card: memory. quant_pack reads x and noise (8 B per
// value) and writes bits/8 B per value plus 8 B per group; it does a few
// operations per value, far below the H100's ~20 flop/byte fp32 balance.
// dequant_unpack is the reverse. Every kernel is templated on `bits`, so
// per_word, the shifts and the masks are compile-time constants; all index
// arithmetic is 32-bit (the wrapper keeps every tensor below 2^31 elements)
// and no index is divided by a runtime value. The design:
//
//   * The packed layout makes a float4 a whole unit of the output: four
//     consecutive features from f % 4 == 0 quantize to 4*bits bits, which
//     are byte c (Int2), half-word c (Int4) or word c (Int8) of the packed
//     row for the c-th float4 of the row (little-endian words, field j at
//     bits [j*bits, (j+1)*bits)).
//
//   * quant_pack, F % 4 == 0 and F <= 256 (the wire's F = 100 and 256):
//     one warp per 4-row group, kPackWarps groups per block, no shared
//     memory and no __syncthreads. Lane l holds float4s l, l+32, ... of the
//     group's 4*F/4 (NV = ceil(F/32) of them, NV in {1, 2, 4, 8}): it issues
//     all its loads of x and of noise first, so noise is in flight while the
//     min and max are taken in registers and across the warp with
//     __shfl_xor_sync. At F = 256 that is 8 float4s of each: 64 of the 80
//     registers `ptxas -v` reports for that instantiation, no spill. Each warp
//     load reads 512 contiguous bytes, and every value of x and noise leaves
//     device memory once. The lane then quantizes its float4s from
//     registers and stores each one's 4*bits bits as its byte / half-word /
//     word of the packed row: lanes that share a packed word write disjoint
//     bytes of it, so the word is assembled by the stores' byte masks
//     rather than by shuffles, and a warp store covers 32*bits/2
//     contiguous bytes. Of the two ways to build words in a warp, lanes
//     on word-aligned chunks or lanes on consecutive float4s whose
//     partial words are OR-ed across lanes, this is the second without
//     the OR. Both alternatives were built and timed on the H100 with
//     `chip_smoke.py --wire` at 28,032 rows, Int2: at F = 256 both were
//     slower (word-aligned chunks, whose lanes load 64 bytes apart so
//     that each load instruction touches 16 cache lines; and the OR by
//     __shfl_xor_sync), and both spilled registers there; at F = 100 the
//     word-aligned chunks were as fast within the run's spread. A
//     shuffle OR would also need a segmented combine for ragged rows
//     (F = 100 at Int2: 25 float4s a row, 6 full words and one of 4
//     fields), whose words start at no fixed lane and can straddle two
//     of a lane's loads; the stores' byte masks merge them regardless. The lane
//     of float4 i finds its row as (i >= F/4) + (i >= 2F/4) + (i >= 3F/4),
//     since a group has 4 rows. Lanes 0-3 then store the zero bytes of
//     their row's last word past F (at most 3 bytes).
//
//   * quant_pack, every other width (F % 4 != 0, F > 256, or x / noise not
//     16-byte aligned): quant_pack_loop, one warp per group as above, in
//     two passes. Pass 1 loops over the group's 4*F values with coalesced
//     scalar loads for the min and max. Pass 2 gives each lane whole packed
//     words (word u of the group: row (u >= W) + (u >= 2W) + (u >= 3W) for
//     W words a row) and re-reads their x from L1/L2 and their noise from
//     device memory with scalar loads. It is tested (F = 47, 1024) but not
//     on the training path.
//
//   * dequant_unpack: a 2-D block, threadIdx.x over a row's units (float4s
//     when F % 4 == 0, else single features: the scalar path) and
//     threadIdx.y over groups, looping where a row has more units than the
//     block is wide. A thread loads its group's zero and scale once and
//     makes its unit in all 4 rows of the group: the 4 packed words are
//     loaded together, then 4 stores (float4 stores: one warp store covers
//     512 contiguous bytes at F >= 128).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowGroup = 4;
constexpr int kPackWarps = 4;           // groups (warps) per quant_pack block
constexpr int kPackThreads = 32 * kPackWarps;
constexpr int kRegsMaxFeat = 256;       // widest row held in registers
constexpr int kUnpackThreads = 256;

template <int BITS>
struct Bits {
  static constexpr int kPerWord = 32 / BITS;
  static constexpr unsigned kMask = (1u << BITS) - 1u;
  static constexpr float kLevels = static_cast<float>((1 << BITS) - 1);
  // log2(kPerWord): f >> kLogPerWord is f's word, f & (kPerWord - 1) its field.
  static constexpr int kLogPerWord = BITS == 2 ? 4 : BITS == 4 ? 3 : 2;
};

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// One stochastically rounded field, exactly as the plain version rounds it.
template <int BITS>
__device__ __forceinline__ unsigned quantize(float v, float u, float lo, float rcp) {
  const float xs = __fmul_rn(__fsub_rn(v, lo), rcp);
  return static_cast<unsigned>(
      fminf(fmaxf(floorf(__fadd_rn(xs, u)), 0.0f), Bits<BITS>::kLevels));
}

// (scale as shipped, reciprocal used to quantize) of a group's range.
template <int BITS>
__device__ __forceinline__ void group_scale(float lo, float hi, float& sc, float& rcp) {
  sc = __fdiv_rn(__fsub_rn(hi, lo), Bits<BITS>::kLevels);
  const bool pos = sc > 0.0f;
  rcp = pos ? __fdiv_rn(1.0f, sc) : 0.0f;
  sc = pos ? sc : 0.0f;
}

// Row (0-3) of unit i of a group whose rows hold n units each.
__device__ __forceinline__ int group_row(int i, int n) {
  return (i >= n) + (i >= 2 * n) + (i >= 3 * n);
}

template <int BITS>
__device__ __forceinline__ void store_chunk(unsigned char* row, int c, unsigned chunk) {
  if constexpr (BITS == 2) row[c] = static_cast<unsigned char>(chunk);
  else if constexpr (BITS == 4) reinterpret_cast<unsigned short*>(row)[c] =
      static_cast<unsigned short>(chunk);
  else reinterpret_cast<unsigned*>(row)[c] = chunk;
}

// F % 4 == 0, F <= 32 * NV, x and noise 16-byte aligned. f4 = F / 4.
template <int BITS, int NV>
__global__ void __launch_bounds__(kPackThreads)
quant_pack_regs(const float4* __restrict__ x, const float4* __restrict__ noise,
                unsigned* __restrict__ packed, float* __restrict__ zero,
                float* __restrict__ scale, int groups, int f4, int words) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  if (g >= groups) return;                     // whole warps only
  const int n4 = kRowGroup * f4;
  const float4* xg = x + g * n4;
  const float4* ug = noise + g * n4;

  float4 xv[NV], uv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + 32 * k;
    if (i < n4) {
      xv[k] = __ldg(xg + i);
      uv[k] = __ldg(ug + i);
    }
  }
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (lane + 32 * k < n4) {
      lo = fminf(lo, fminf(fminf(xv[k].x, xv[k].y), fminf(xv[k].z, xv[k].w)));
      hi = fmaxf(hi, fmaxf(fmaxf(xv[k].x, xv[k].y), fmaxf(xv[k].z, xv[k].w)));
    }
  }
  warp_minmax(lo, hi);
  float sc, rcp;
  group_scale<BITS>(lo, hi, sc, rcp);

  unsigned* pg = packed + g * kRowGroup * words;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + 32 * k;
    if (i < n4) {
      const int r = group_row(i, f4);
      const unsigned chunk = quantize<BITS>(xv[k].x, uv[k].x, lo, rcp)
          | quantize<BITS>(xv[k].y, uv[k].y, lo, rcp) << BITS
          | quantize<BITS>(xv[k].z, uv[k].z, lo, rcp) << (2 * BITS)
          | quantize<BITS>(xv[k].w, uv[k].w, lo, rcp) << (3 * BITS);
      store_chunk<BITS>(reinterpret_cast<unsigned char*>(pg + r * words), i - r * f4,
                        chunk);
    }
  }
  // Zero bytes of each row's last word past F (F = 100 at Int2: bytes 25-27).
  if (lane < kRowGroup) {
    unsigned char* row = reinterpret_cast<unsigned char*>(pg + lane * words);
    for (int b = f4 * BITS / 2; b < 4 * words; ++b) row[b] = 0;
  }
  if (lane == 0) {
    zero[g] = lo;
    scale[g] = sc;
  }
}

// Any F, any alignment: min/max pass, then whole words built by lanes.
template <int BITS>
__global__ void __launch_bounds__(kPackThreads)
quant_pack_loop(const float* __restrict__ x, const float* __restrict__ noise,
                unsigned* __restrict__ packed, float* __restrict__ zero,
                float* __restrict__ scale, int groups, int feat, int words) {
  using B = Bits<BITS>;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  if (g >= groups) return;
  const int n = kRowGroup * feat;
  const float* xg = x + g * n;
  const float* ug = noise + g * n;

  float lo = INFINITY, hi = -INFINITY;
  for (int i = lane; i < n; i += 32) {
    const float v = __ldg(xg + i);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  warp_minmax(lo, hi);
  float sc, rcp;
  group_scale<BITS>(lo, hi, sc, rcp);

  unsigned* pg = packed + g * kRowGroup * words;
  for (int u = lane; u < kRowGroup * words; u += 32) {
    const int r = group_row(u, words);
    const int f0 = (u - r * words) << B::kLogPerWord;
    const int nf = min(B::kPerWord, feat - f0);
    const float* xr = xg + r * feat + f0;
    const float* ur = ug + r * feat + f0;
    unsigned word = 0u;
    for (int j = 0; j < nf; ++j)
      word |= quantize<BITS>(__ldg(xr + j), __ldg(ur + j), lo, rcp) << (j * BITS);
    pg[u] = word;
  }
  if (lane == 0) {
    zero[g] = lo;
    scale[g] = sc;
  }
}

// VEC = 4: units are float4s (F % 4 == 0, out 16-byte aligned); VEC = 1:
// single features. units = F / VEC.
template <int BITS, int VEC>
__global__ void __launch_bounds__(kUnpackThreads)
dequant_unpack_kernel(const unsigned* __restrict__ packed, const float* __restrict__ zero,
                      const float* __restrict__ scale, float* __restrict__ out,
                      int groups, int units, int feat, int words) {
  using B = Bits<BITS>;
  const int g = blockIdx.x * blockDim.y + threadIdx.y;
  if (g >= groups) return;
  const float z = __ldg(zero + g), s = __ldg(scale + g);
  const unsigned* pg = packed + g * kRowGroup * words;
  float* og = out + g * kRowGroup * feat;
  for (int c = threadIdx.x; c < units; c += blockDim.x) {
    const int f0 = c * VEC;
    const int w = f0 >> B::kLogPerWord;
    const int shift = (f0 & (B::kPerWord - 1)) * BITS;
    unsigned wd[kRowGroup];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) wd[r] = __ldg(pg + r * words + w) >> shift;
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      auto deq = [&](int j) {
        const float q = static_cast<float>((wd[r] >> (j * BITS)) & B::kMask);
        return __fadd_rn(__fmul_rn(q, s), z);
      };
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(og + r * feat + f0) =
            make_float4(deq(0), deq(1), deq(2), deq(3));
      } else {
        og[r * feat + f0] = deq(0);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int BITS>
void launch_pack(const float* x, const float* noise, unsigned* packed, float* zero,
                 float* scale, int groups, int feat, int words, cudaStream_t stream) {
  const int blocks = (groups + kPackWarps - 1) / kPackWarps;
  if (feat % 4 || feat > kRegsMaxFeat || !aligned16(x) || !aligned16(noise)) {
    quant_pack_loop<BITS><<<blocks, kPackThreads, 0, stream>>>(
        x, noise, packed, zero, scale, groups, feat, words);
    return;
  }
  const auto* x4 = reinterpret_cast<const float4*>(x);
  const auto* u4 = reinterpret_cast<const float4*>(noise);
  const int f4 = feat / 4;
  // Lane l holds float4s l, l+32, ... of the group's 4*f4 = feat.
  if (feat <= 32)
    quant_pack_regs<BITS, 1><<<blocks, kPackThreads, 0, stream>>>(
        x4, u4, packed, zero, scale, groups, f4, words);
  else if (feat <= 64)
    quant_pack_regs<BITS, 2><<<blocks, kPackThreads, 0, stream>>>(
        x4, u4, packed, zero, scale, groups, f4, words);
  else if (feat <= 128)
    quant_pack_regs<BITS, 4><<<blocks, kPackThreads, 0, stream>>>(
        x4, u4, packed, zero, scale, groups, f4, words);
  else
    quant_pack_regs<BITS, 8><<<blocks, kPackThreads, 0, stream>>>(
        x4, u4, packed, zero, scale, groups, f4, words);
}

template <int BITS>
void launch_unpack(const unsigned* packed, const float* zero, const float* scale,
                   float* out, int groups, int feat, int words, cudaStream_t stream) {
  const bool vec = feat % 4 == 0 && aligned16(out);
  const int units = vec ? feat / 4 : feat;
  int bx = 32;
  while (bx < units && bx < kUnpackThreads) bx *= 2;
  const dim3 block(bx, kUnpackThreads / bx);
  const int blocks = (groups + block.y - 1) / block.y;
  if (vec)
    dequant_unpack_kernel<BITS, 4><<<blocks, block, 0, stream>>>(
        packed, zero, scale, out, groups, units, feat, words);
  else
    dequant_unpack_kernel<BITS, 1><<<blocks, block, 0, stream>>>(
        packed, zero, scale, out, groups, units, feat, words);
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
  const auto* xf = static_cast<const float*>(x);
  const auto* uf = static_cast<const float*>(noise);
  auto* p = static_cast<unsigned*>(packed);
  auto* z = static_cast<float*>(zero);
  auto* s = static_cast<float*>(scale);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bits == 2) launch_pack<2>(xf, uf, p, z, s, groups, feat, words, st);
  else if (bits == 4) launch_pack<4>(xf, uf, p, z, s, groups, feat, words, st);
  else launch_pack<8>(xf, uf, p, z, s, groups, feat, words, st);
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
  const auto* p = static_cast<const unsigned*>(packed);
  const auto* z = static_cast<const float*>(zero);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  const int groups = rows / kRowGroup;
  const auto st = static_cast<cudaStream_t>(stream);
  if (bits == 2) launch_unpack<2>(p, z, s, o, groups, feat, words, st);
  else if (bits == 4) launch_unpack<4>(p, z, s, o, groups, feat, words, st);
  else launch_unpack<8>(p, z, s, o, groups, feat, words, st);
  return static_cast<int>(cudaGetLastError());
}
