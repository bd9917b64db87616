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
//   * the grid covers only the bucket's real rows (`n_rows`), so the
//     padding rows a fixed shape class adds (rows = 0, w = 0) are neither
//     read nor allowed to overwrite destination row 0.
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

__global__ void __launch_bounds__(kFeatTile * kRowTile)
seg_aggregate_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                     const float* __restrict__ w, const int* __restrict__ rows,
                     float* __restrict__ out, int n_rows, int k, int f) {
  const int r = blockIdx.x * kRowTile + threadIdx.y;
  const int c = blockIdx.y * kFeatTile + threadIdx.x;
  if (r >= n_rows || c >= f) return;  // ragged row and feature edges
  const int* idx_r = idx + static_cast<int64_t>(r) * k;
  const float* w_r = w + static_cast<int64_t>(r) * k;
  float acc = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int64_t src = __ldg(idx_r + j);
    acc = fmaf(__ldg(w_r + j), __ldg(x + src * f + c), acc);
  }
  const int64_t dst = rows != nullptr ? __ldg(rows + r) : r;
  out[dst * f + c] = acc;
}

}  // namespace

// x [N, f] f32, idx [n_rows, k] i32, w [n_rows, k] f32, rows [n_rows] i32 or
// null, out [.., f] f32; all contiguous on the current device. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int seg_aggregate_f32(const void* x, const void* idx, const void* w,
                                 const void* rows, void* out, int n_rows,
                                 int k, int f, void* stream) {
  if (n_rows <= 0 || k <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kFeatTile, kRowTile);
  const dim3 grid((n_rows + kRowTile - 1) / kRowTile,
                  (f + kFeatTile - 1) / kFeatTile);
  seg_aggregate_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const int*>(rows),
      static_cast<float*>(out), n_rows, k, f);
  return static_cast<int>(cudaGetLastError());
}
