// Degree-bucketed blocked-ELL neighbour aggregation for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel of src/repro/kernels/seg_aggregate.py:
// the kernel body `_seg_aggregate_kernel` (:67) driven by `seg_aggregate`
// (:91), together with the per-bucket scatter `out.at[b.rows].add(...)` of
// `_bucketed_forward` (:194), which this kernel fuses into its store:
//
//     out[rows[r], f] = sum_{k=0..K-1} w[r, k] * x[idx[r, k], f]
//
// (rows == nullptr means rows[r] = r: the plain `seg_aggregate`).
//
// The same kernel is the backward of the bucketed aggregation
// (`_bucketed_aggregate_bwd`, :218): over the reverse-graph layout `ell_t`
// it computes A^T @ g. And it covers a stack of P workers' layouts in one
// launch (blockIdx.z = worker, per-worker strides), as the JAX package's
// vmap over the worker axis runs the Pallas kernel once per worker.
//
// What bounds it on this card: memory. Per output value it does K fused
// multiply-adds on K gathered floats, far below the ~20 flop/byte at which
// fp32 arithmetic would become the limit on an H100 (67 TFLOP/s over
// 3.35 TB/s). The bytes it must move are the index and weight arrays of the
// bucket's real rows, the source rows it gathers, and the output rows.
// What the design does about that:
//   * a warp covers 32 consecutive features of one destination row, so
//     each gathered source row is read as 128-byte coalesced segments and
//     the row's idx/w entries are one broadcast load per warp;
//   * source rows are re-read by every destination that names them; at the
//     serving shapes the whole source matrix (a few MB) stays in the 50 MB
//     L2, so the repeats cost L2 bandwidth rather than device memory;
//   * the sum stays in a register over the whole K loop and each output
//     value is stored once: no atomics, no shared-memory staging, and no
//     read-modify-write of `out`;
//   * the grid covers only the bucket's real rows (`n_rows`; per worker,
//     `counts[p]`, since a stack pads every worker's bucket to the largest
//     worker's count), so the padding rows a fixed shape class or a stack
//     adds (rows = 0, w = 0) are neither read nor allowed to overwrite
//     destination row 0.
//
// Determinism: every thread sums its K slots in the fixed order 0..K-1 in
// fp32 and every destination row lies in exactly one bucket, so a row's
// result depends only on that row's slots. A served row therefore equals
// the same row of the full-batch forward bit for bit.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFeatTile = 32;  // threads along features: one warp
constexpr int kRowTile = 8;    // warps per block: one destination row each

// kStacked = false is one graph: the grid covers exactly its n_rows real
// rows and every offset is the row's own. kStacked = true adds the worker
// axis: worker p's real-row count is loaded from counts[p] and its arrays
// start p strides in. The one-graph path (serving) thus carries neither the
// counts load nor the per-worker offsets.
template <bool kStacked>
__global__ void __launch_bounds__(kFeatTile * kRowTile)
seg_aggregate_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                     const float* __restrict__ w, const int* __restrict__ rows,
                     const int* __restrict__ counts, float* __restrict__ out,
                     int n_rows, int bucket_rows, int k, int f,
                     int64_t x_stride, int64_t out_stride) {
  const int r = blockIdx.x * kRowTile + threadIdx.y;
  const int c = blockIdx.y * kFeatTile + threadIdx.x;
  int64_t slot = r;
  if constexpr (kStacked) {
    const int p = blockIdx.z;
    if (r >= __ldg(counts + p) || c >= f) return;  // this worker's padding rows
    slot += static_cast<int64_t>(p) * bucket_rows;
    x += p * x_stride;
    out += p * out_stride;
  } else {
    if (r >= n_rows || c >= f) return;  // ragged row and feature edges
  }
  const int* idx_r = idx + slot * k;
  const float* w_r = w + slot * k;
  float acc = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int64_t src = __ldg(idx_r + j);
    acc = fmaf(__ldg(w_r + j), __ldg(x + src * f + c), acc);
  }
  const int64_t dst = rows != nullptr ? __ldg(rows + slot) : r;
  out[dst * f + c] = acc;
}

}  // namespace

// One graph (workers = 1, counts = null): x [N, f] f32, idx [bucket_rows, k]
// i32, w [bucket_rows, k] f32, rows [bucket_rows] i32 or null, out [.., f] f32;
// rows r < n_rows are computed. A stack of `workers` graphs: each array gains
// a leading worker axis (x and out with `x_stride` / `out_stride` elements
// per worker) and counts[p] (device i32) bounds worker p's real rows, n_rows
// being the largest. All contiguous on the current device. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int seg_aggregate_f32(const void* x, const void* idx, const void* w,
                                 const void* rows, const void* counts, void* out,
                                 int workers, int n_rows, int bucket_rows, int k,
                                 int f, long long x_stride, long long out_stride,
                                 void* stream) {
  if (workers <= 0 || workers > 65535 || n_rows <= 0 || n_rows > bucket_rows ||
      k <= 0 || f <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kFeatTile, kRowTile);
  const dim3 grid((n_rows + kRowTile - 1) / kRowTile,
                  (f + kFeatTile - 1) / kFeatTile, workers);
  const auto kernel = counts != nullptr ? seg_aggregate_kernel<true>
                                         : seg_aggregate_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const int*>(rows),
      static_cast<const int*>(counts), static_cast<float*>(out), n_rows,
      bucket_rows, k, f, x_stride, out_stride);
  return static_cast<int>(cudaGetLastError());
}
