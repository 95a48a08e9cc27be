// IoU matching of boxes against padded ground truth, the whole batch in one launch.
//
// Replaces: replication_faster_rcnn_tpu/ops/pallas/iou_kernel.py::_match_kernel
// (wrappers match_boxes_pallas, iou_matrix_pallas). Plain version:
// replication_faster_rcnn_tpu_torch/ops/iou_match.py::match_boxes, which this
// kernel matches bit for bit in all four outputs:
//   * IoU [B, M, G] (written only when asked), -1 on padded gt columns;
//   * row argmax [B, M] int64, first occurrence on ties;
//   * row max(max(iou, 0)) [B, M] float32;
//   * column argmax [B, G] int64 (optional), first occurrence on ties.
// boxes are [B, M, 4] or, with a batch stride of 0, one [M, 4] set shared by
// every image (the anchors); gt is [B, G, 4] and the mask [B, G].
//
// What bounds it on the H100: neither. At the anchor site (8 x 12996 x 32)
// the IoUs are ~53 MFLOP and the inputs and outputs ~1.5 MB, microseconds of
// either; the launch and the per-row loop over G dominate.
//
// What the design does about it:
//   * One thread per box row, the image's gt boxes and mask in shared memory;
//     each thread walks the G columns in order, so the row argmax is a
//     strictly-greater running update (first occurrence) and the row max an
//     exact running maximum. The IoU matrix is never written unless asked:
//     neither training caller reads it past these reductions.
//   * The TPU kernel carries the column argmax across its sequential grid
//     steps in VMEM scratch. Blocks on the H100 run in no order, so the
//     column argmax is a packed 64-bit atomicMax instead: the high word is
//     the IoU's bits mapped to an unsigned integer of the same order, the
//     low word is 0xffffffff - row, so on equal IoUs the lowest row wins.
//     The maximum does not depend on the order of the atomics, so the result
//     is deterministic. Each warp reduces its 32 keys with shuffles, each
//     block its warps in shared memory, and one atomic per (block, column)
//     reaches device memory. Rows beyond M take no part, so they never win.
//     The int64 output holds the keys and a second small kernel turns them
//     into row indices in place.
//
// Strict IEEE: the IoU repeats ops/boxes.py::iou operation for operation with
// the round-to-nearest intrinsics (the NMS kernel's iou_strict), and this file
// is built with -fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float iou_strict(float4 a, float4 b) {
  const float tl_r = fmaxf(a.x, b.x);
  const float tl_c = fmaxf(a.y, b.y);
  const float br_r = fminf(a.z, b.z);
  const float br_c = fminf(a.w, b.w);
  const float wh_r = __fsub_rn(br_r, tl_r);
  const float wh_c = __fsub_rn(br_c, tl_c);
  const float inter = (wh_r > 0.f && wh_c > 0.f) ? __fmul_rn(wh_r, wh_c) : 0.f;
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// float -> uint32 with the same order (for finite values and infinities)
__device__ __forceinline__ uint32_t ordered_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long col_key(float v, int row) {
  return (static_cast<unsigned long long>(ordered_bits(v)) << 32) |
         static_cast<unsigned long long>(0xffffffffu - static_cast<uint32_t>(row));
}

__global__ void __launch_bounds__(THREADS)
iou_match_kernel(const float4* __restrict__ boxes,   // [B or 1, M]
                 int64_t box_stride,                  // M, or 0 for shared boxes
                 const float4* __restrict__ gt,       // [B, G]
                 const bool* __restrict__ gt_mask,    // [B, G]
                 int m_rows, int g_cols,
                 float* __restrict__ iou_out,         // [B, M, G] or null
                 int64_t* __restrict__ argmax_out,    // [B, M]
                 float* __restrict__ max_out,         // [B, M]
                 unsigned long long* __restrict__ col_out) {  // [B, G] keys or null
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_gt = reinterpret_cast<float4*>(smem);                                     // [G]
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(s_gt + g_cols);  // [G]
  bool* s_mask = reinterpret_cast<bool*>(s_key + g_cols);                             // [G]

  const int img = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * THREADS + tid;
  const bool active = row < m_rows;
  for (int g = tid; g < g_cols; g += THREADS) {
    s_gt[g] = gt[static_cast<int64_t>(img) * g_cols + g];
    s_mask[g] = gt_mask[static_cast<int64_t>(img) * g_cols + g];
    s_key[g] = 0ull;
  }
  __syncthreads();

  const float4 box = active ? boxes[img * box_stride + row] : make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t out_row = static_cast<int64_t>(img) * m_rows + row;
  float best = 0.f;
  int best_g = 0;
  float row_max = 0.f;
  for (int g = 0; g < g_cols; ++g) {
    const float v = s_mask[g] ? iou_strict(box, s_gt[g]) : -1.f;
    if (g == 0 || v > best) {  // strictly greater: the first maximum stays
      best = v;
      best_g = g;
    }
    row_max = fmaxf(row_max, fmaxf(v, 0.f));
    if (active && iou_out != nullptr) iou_out[out_row * g_cols + g] = v;
    if (col_out != nullptr) {  // uniform branch: every lane shuffles
      unsigned long long key = active ? col_key(v, row) : 0ull;
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
        key = other > key ? other : key;
      }
      if ((tid & 31) == 0 && key != 0ull) atomicMax(&s_key[g], key);
    }
  }
  if (active) {
    argmax_out[out_row] = best_g;
    max_out[out_row] = row_max;
  }
  if (col_out != nullptr) {
    __syncthreads();
    for (int g = tid; g < g_cols; g += THREADS) {
      if (s_key[g] != 0ull) atomicMax(&col_out[static_cast<int64_t>(img) * g_cols + g], s_key[g]);
    }
  }
}

// keys -> row indices, in place
__global__ void col_finalize_kernel(unsigned long long* __restrict__ col, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long key = col[i];
    const int64_t row = key == 0ull ? 0 : static_cast<int64_t>(0xffffffffu - static_cast<uint32_t>(key));
    reinterpret_cast<int64_t*>(col)[i] = row;
  }
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launches (0 = cudaSuccess). iou_out and
// col_out may be null; col_out, when given, is [batch, G] int64.
int iou_match_launch(const void* boxes, long long box_stride, const void* gt,
                     const void* gt_mask, int batch, int m_rows, int g_cols,
                     void* iou_out, void* argmax_out, void* max_out, void* col_out,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* col = static_cast<unsigned long long*>(col_out);
  if (col != nullptr) {
    cudaError_t err = cudaMemsetAsync(col, 0, sizeof(unsigned long long) * batch * g_cols, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (batch > 0 && m_rows > 0) {
    const dim3 grid((m_rows + THREADS - 1) / THREADS, batch);
    const size_t smem = static_cast<size_t>(g_cols) *
                        (sizeof(float4) + sizeof(unsigned long long) + sizeof(bool));
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          iou_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    iou_match_kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const float4*>(boxes), box_stride, static_cast<const float4*>(gt),
        static_cast<const bool*>(gt_mask), m_rows, g_cols, static_cast<float*>(iou_out),
        static_cast<int64_t*>(argmax_out), static_cast<float*>(max_out), col);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (col != nullptr && batch * g_cols > 0) {
    const int n = batch * g_cols;
    col_finalize_kernel<<<(n + 255) / 256, 256, 0, s>>>(col, n);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* iou_match_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
