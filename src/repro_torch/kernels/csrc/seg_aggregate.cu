// Degree-bucketed blocked-ELL neighbour aggregation for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel of src/repro/kernels/seg_aggregate.py:
// the kernel body `_seg_aggregate_kernel` (:67) driven by `seg_aggregate`
// (:91), together with the per-bucket scatter `out.at[b.rows].add(...)`
// (:194) of `_bucketed_forward` (:185), which this kernel fuses into its
// store:
//
//     out[rows[r], f] = sum_{k=0..K-1} w[r, k] * x[idx[r, k], f]
//
// (rows == nullptr means rows[r] = r: the plain `seg_aggregate`). Over the
// reverse-graph layout `ell_t` the same kernel is the backward
// (`_bucketed_aggregate_bwd`, :218): A^T @ g. A layout is one graph or a
// stack of P workers' graphs (the JAX package's vmap over the worker axis).
//
// One launch covers every bucket of a layout: the wrapper passes a table of
// up to kMaxBuckets buckets by value (pointers, K, padded and real rows).
//
// What bounds it on this card: bytes, not arithmetic. Per output value it
// does about three flops per gathered float (a compensated sum, below),
// under one flop per gathered byte, far below the ~20 flop/byte at which fp32 arithmetic would become the limit on an H100
// (67 TFLOP/s over 3.35 TB/s). The HBM bytes are small (the index and
// weight arrays, each source row once, the output once); what a gather
// moves is much more: every slot re-reads a whole source row (each
// local-graph source row is named by ~19 edges), served from the 50 MB L2
// when the sources fit there. So the kernel keeps many gathers in flight
// and skips the ones that add nothing:
//
//   * A block is a tile of rows of one bucket of one worker; the block
//     finds its bucket by a scan over the table's tile offsets.
//   * Each thread owns 4 consecutive features (one float4 load per slot
//     when F % 4 == 0 and the rows are 16-byte aligned, scalar loads
//     otherwise); the K loop loads 4 slots' idx and w (one 16-byte load
//     each when K % 4 == 0) and issues their 4 gathers before the
//     sums.
//   * Slots with w == 0 (the layouts pad rows to their bucket's K with
//     (idx 0, w 0) slots: 30% of the local graph's) are not gathered.
//
// Its time is the L2's rate for the gathered rows. (The TPU kernel kept
// each worker's source slab resident in VMEM instead; a shared-memory slab
// measured slower than this gather on every layout of the training path
// on the H100, PERF.md.)
//
// The weight of a slot is the same for all threads of its row, so the
// w == 0 branch does not diverge within a row (skipping the slot changes
// no value, below). An infinite or NaN x in a padded slot gives NaN in
// the plain version (0 * inf) and not in the kernel.
//
// Each output value is a compensated sum: the slots are taken in groups
// of 4 (0-3, 4-7, ...; the K % 4 last ones alone), each group's products
// summed in a fixed tree, and each group's sum added into a running sum
// whose rounding errors a second term collects (TwoSum); the value stored
// is the two terms' sum. The running sum's error, which grows with K in a
// plain chain, is so carried, and a long row that cancels keeps its
// digits: a plain fmaf chain over the 512-slot receive rows of 256
// stacked workers (the dry-run's R-MAT hubs) left rtol = atol = 1e-5 of
// the plain version where a result cancels (PERF.md). It costs about
// three flops per gathered float, still far below the bytes' bound.
//
// Order of the sums, and so the bits of the result, do not depend on the
// grid or a bucket's row count: the groups are taken in slot order, with
// no atomics; every destination row lies in exactly one bucket and is
// stored once. So two launches agree bit for bit, and a served row equals
// the same row of the full-batch forward bit for bit. A slot with w == 0
// is not gathered (its product is +0), and a group or a last slot with
// none of w != 0 is not added.
//
// Padding rows (a stack pads every worker's bucket to the largest worker's
// count; a shape class pads further) point at row 0 with zero weights; the
// kernel covers only each worker's real rows (counts[p], or n for one
// graph), so they are neither read nor stored over a real row 0.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBuckets = 16;
constexpr int kGatherThreads = 256;  // lanes * rows_per_tile <= this

struct Bucket {
  const int* idx;     // [P, bucket_rows, k] (one graph: [bucket_rows, k])
  const float* w;     // same shape
  const int* rows;    // [P, bucket_rows] destination rows, or null: rows[r] = r
  const int* counts;  // [P] real rows per worker, or null: n (one graph)
  int k;
  int bucket_rows;
  int n;              // most real rows of any worker
  int tile_start;     // the bucket's first tile (blockIdx.x)
};

struct Table {
  Bucket b[kMaxBuckets];
  int nb;             // buckets in use (each with n > 0)
  int f;              // features per row
  int lanes;          // threads per row, 4 features each
  int rows_per_tile;  // rows per block
  long long x_stride;    // elements per worker of x
  long long out_stride;  // elements per worker of out
};

// The table's bucket i, read with constant offsets only (a select per
// field), so the by-value parameter is never copied to local memory.
__device__ __forceinline__ Bucket pick(const Table& t, int i) {
  Bucket b = t.b[0];
#pragma unroll
  for (int j = 1; j < kMaxBuckets; ++j)
    if (j == i) b = t.b[j];
  return b;
}

__device__ __forceinline__ int real_rows(const Bucket& b, int p) {
  return b.counts != nullptr ? __ldg(b.counts + p) : b.n;
}

// s + c += g, compensated (Knuth's TwoSum: the add's exact rounding error
// goes into c). The intrinsics keep nvcc from contracting the error terms
// into fmas.
__device__ __forceinline__ void two_sum(float& s, float& c, float g) {
  const float t = __fadd_rn(s, g);
  const float z = __fsub_rn(t, s);
  c = __fadd_rn(c, __fadd_rn(__fsub_rn(s, __fsub_rn(t, z)), __fsub_rn(g, z)));
  s = t;
}

// The running sum of 4 features: sum s and error term c.
struct Acc4 {
  float4 s, c;
};

__device__ __forceinline__ void add4(Acc4& a, const float4& g) {
  two_sum(a.s.x, a.c.x, g.x);
  two_sum(a.s.y, a.c.y, g.y);
  two_sum(a.s.z, a.c.z, g.z);
  two_sum(a.s.w, a.c.w, g.w);
}

// (w0 v0 + w1 v1) + (w2 v2 + w3 v3), one feature: a group's partial sum.
__device__ __forceinline__ float group(const float (&w)[4], float v0, float v1, float v2,
                                       float v3) {
  return __fadd_rn(__fmaf_rn(w[1], v1, __fmul_rn(w[0], v0)),
                   __fmaf_rn(w[3], v3, __fmul_rn(w[2], v2)));
}

__device__ __forceinline__ float4 group4(const float (&w)[4], const float4 (&v)[4]) {
  return make_float4(group(w, v[0].x, v[1].x, v[2].x, v[3].x),
                     group(w, v[0].y, v[1].y, v[2].y, v[3].y),
                     group(w, v[0].z, v[1].z, v[2].z, v[3].z),
                     group(w, v[0].w, v[1].w, v[2].w, v[3].w));
}

__device__ __forceinline__ float4 scale4(float w, const float4& v) {
  return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y), __fmul_rn(w, v.z),
                     __fmul_rn(w, v.w));
}

__device__ __forceinline__ float4 total4(const Acc4& a) {
  return make_float4(__fadd_rn(a.s.x, a.c.x), __fadd_rn(a.s.y, a.c.y),
                     __fadd_rn(a.s.z, a.c.z), __fadd_rn(a.s.w, a.c.w));
}

// 4 features at p (valid: how many of them lie inside the row, >= 1).
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, int valid) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    v.x = __ldg(p);
    if (valid > 1) v.y = __ldg(p + 1);
    if (valid > 2) v.z = __ldg(p + 2);
    if (valid > 3) v.w = __ldg(p + 3);
    return v;
  }
}

// Slots j..j+3 of a row: one 16-byte load each of idx and w when the
// bucket's slots allow it (K % 4 == 0 and both arrays 16-byte aligned).
__device__ __forceinline__ void load_slots(const int* idx_r, const float* w_r, int j,
                                           bool vec, int (&s)[4], float (&wt)[4]) {
  if (vec) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(idx_r + j));
    const float4 b = __ldg(reinterpret_cast<const float4*>(w_r + j));
    s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w;
    wt[0] = b.x, wt[1] = b.y, wt[2] = b.z, wt[3] = b.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s[u] = __ldg(idx_r + j + u);
      wt[u] = __ldg(w_r + j + u);
    }
  }
}

__device__ __forceinline__ bool vec_slots(const Bucket& b) {
  return (b.k & 3) == 0 &&
         ((reinterpret_cast<uintptr_t>(b.idx) | reinterpret_cast<uintptr_t>(b.w)) & 15) == 0;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, const float4& v, int valid) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x;
    if (valid > 1) p[1] = v.y;
    if (valid > 2) p[2] = v.z;
    if (valid > 3) p[3] = v.w;
  }
}

// blockIdx.x is a tile of rows_per_tile rows of one bucket of
// one worker (tiles of bucket i: [tile_start, tile_start + ceil(n / rows) *
// P), worker-major); blockIdx.y a slice of lanes * 4 features.
template <bool kVec>
__global__ void __launch_bounds__(kGatherThreads)
seg_aggregate_gather(const float* __restrict__ x, float* __restrict__ out, const Table t) {
  const int tile = blockIdx.x;
  int bi = 0;
#pragma unroll
  for (int j = 1; j < kMaxBuckets; ++j)
    if (j < t.nb && tile >= t.b[j].tile_start) bi = j;
  const Bucket b = pick(t, bi);
  const int row_tiles = (b.n + t.rows_per_tile - 1) / t.rows_per_tile;
  const int local = tile - b.tile_start;
  const int p = local / row_tiles;
  const int r = (local - p * row_tiles) * t.rows_per_tile + threadIdx.x / t.lanes;
  const int f = t.f;
  const int f4 = 4 * (blockIdx.y * t.lanes + threadIdx.x % t.lanes);
  if (threadIdx.x >= t.lanes * t.rows_per_tile || f4 >= f) return;
  if (r >= real_rows(b, p)) return;  // this worker's padding rows
  const int valid = f - f4;
  const int64_t slot = static_cast<int64_t>(p) * b.bucket_rows + r;
  const float* xp = x + p * t.x_stride + f4;
  const int* idx_r = b.idx + slot * b.k;
  const float* w_r = b.w + slot * b.k;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool vslots = vec_slots(b);
  Acc4 acc{zero, zero};
  int j = 0;
  for (; j + 4 <= b.k; j += 4) {
    int s[4];
    float wt[4];
    load_slots(idx_r, w_r, j, vslots, s, wt);
    float4 v[4];  // the 4 gathers in flight before the sums
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = wt[u] != 0.f ? load4<kVec>(xp + static_cast<int64_t>(s[u]) * f, valid) : zero;
    if (wt[0] != 0.f || wt[1] != 0.f || wt[2] != 0.f || wt[3] != 0.f)
      add4(acc, group4(wt, v));
  }
  for (; j < b.k; ++j) {
    const float wj = __ldg(w_r + j);
    if (wj != 0.f)
      add4(acc, scale4(wj, load4<kVec>(xp + static_cast<int64_t>(__ldg(idx_r + j)) * f, valid)));
  }
  const int64_t dst = b.rows != nullptr ? __ldg(b.rows + slot) : r;
  store4<kVec>(out + p * t.out_stride + dst * f + f4, total4(acc), valid);
}

}  // namespace

// One aggregation over `nb` buckets in one launch.
//   x    [P, .., f] f32 (one graph: P = 1), x_stride elements per worker
//   out  [P, .., f] f32, out_stride elements per worker; rows not named by
//        any bucket are left as they are (the wrapper zero-fills out)
//   ptrs nb * 4 addresses: idx, w, rows (or 0), counts (or 0) per bucket
//   dims nb * 4 ints: k, bucket_rows, n, tile_start per bucket
//   grid `tiles` x ceil(ceil(f / 4) / lanes) blocks of lanes * rows_per_tile
//        threads
//   vec  1: f % 4 == 0 and x, out 16-byte aligned (float4 loads and stores)
// All arrays contiguous on the current device. Launches on `stream` and
// returns a CUDA error code (0 on success).
extern "C" int seg_aggregate_f32(const void* x, void* out, const long long* ptrs,
                                 const int* dims, int nb, int workers, int f,
                                 long long x_stride, long long out_stride, int lanes,
                                 int rows_per_tile, int tiles, int vec, void* stream) {
  if (nb <= 0 || nb > kMaxBuckets || workers <= 0 || f <= 0 || lanes <= 0 ||
      rows_per_tile <= 0 || lanes * rows_per_tile > kGatherThreads || tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  for (int i = 0; i < nb; ++i) {
    Bucket& b = t.b[i];
    b.idx = reinterpret_cast<const int*>(ptrs[4 * i]);
    b.w = reinterpret_cast<const float*>(ptrs[4 * i + 1]);
    b.rows = reinterpret_cast<const int*>(ptrs[4 * i + 2]);
    b.counts = reinterpret_cast<const int*>(ptrs[4 * i + 3]);
    b.k = dims[4 * i];
    b.bucket_rows = dims[4 * i + 1];
    b.n = dims[4 * i + 2];
    b.tile_start = dims[4 * i + 3];
    if (b.idx == nullptr || b.w == nullptr || b.k <= 0 || b.n <= 0 ||
        b.n > b.bucket_rows || (workers > 1 && b.counts == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  t.nb = nb;
  t.f = f;
  t.lanes = lanes;
  t.rows_per_tile = rows_per_tile;
  t.x_stride = x_stride;
  t.out_stride = out_stride;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xf = static_cast<const float*>(x);
  const auto of = static_cast<float*>(out);
  const int chunks = (f + 3) / 4;
  const dim3 grid(tiles, (chunks + lanes - 1) / lanes);
  const dim3 block(lanes * rows_per_tile);
  if (vec)
    seg_aggregate_gather<true><<<grid, block, 0, s>>>(xf, of, t);
  else
    seg_aggregate_gather<false><<<grid, block, 0, s>>>(xf, of, t);
  return static_cast<int>(cudaGetLastError());
}
