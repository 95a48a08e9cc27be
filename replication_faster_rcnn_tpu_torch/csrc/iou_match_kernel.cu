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
// What bounds it on the H100: neither bytes nor operations. At the anchor
// site (8 x 12996 x 32) the IoUs are ~53 MFLOP and the inputs and outputs
// ~1.5 MB, about a microsecond of either; at the proposal site (8 x 632 x 32)
// a few blocks run. The launch, the instructions issued per IoU (strict IEEE,
// a checked division) and the last block's reduction set the time.
//
// What the design does about it:
//   * A block owns 128 rows of one image, a warp a tile of 32 rows; the
//     tile's boxes and areas and the image's gt boxes sit in shared memory,
//     all loaded at once.
//   * Only the unpadded gt columns are computed. Warp 0 compacts them in
//     order (ballots); a padded column is -1 in every row, so it is never a
//     row's best beside an unpadded one (an IoU is >= 0), and its column
//     argmax is row 0. The train step's images hold a few objects in 32
//     padded slots, so most of the work of a dense 32-column sweep goes.
//   * Lanes over (row, column), then lanes over rows, through shared memory.
//     For each chunk of up to 32 unpadded columns (in order), `width` lanes
//     (the chunk's size rounded up to a power of two) own one column each,
//     its box and area in registers, and 32 / width rows are computed per
//     step. Each lane walks its rows in order and keeps its column's best on
//     strictly greater (the first row on ties); the lanes of one column then
//     combine (greater value, then lower row), and every value goes to a
//     32 x 33 tile (no bank conflicts). Then lane l owns tile row l and walks
//     the chunk's columns in order through the tile, keeping the row's best on
//     strictly greater (the first column on ties).
//   * The column argmax takes one launch, with no memset: warps combine
//     in row order through shared memory, and each block folds its best
//     (value, row) per column into a 64-bit key (value order above reversed
//     row) with one atomicMax. The maximum does not depend on the order of
//     the atomics, so the result is deterministic. The last block of each
//     image (an atomic ticket after a __threadfence) swaps each key for 0 and
//     writes the int64 row, and resets the ticket counter: keys and counters
//     are 0 again for the next launch. Rows beyond M take no part, so they
//     never win.
//   * Box areas are computed once per row and once per column, with the same
//     operations as inside the IoU, and a pair without overlap or with a
//     union <= 0 (the plain version's +0 either way) divides 1 by 1 and
//     selects +0: no branch, and not the checked slow path of a zero
//     dividend. Every value is unchanged.
//
// Strict IEEE: the IoU repeats ops/boxes.py::iou operation for operation with
// the round-to-nearest intrinsics (the NMS kernel's iou_strict), and this file
// is built with -fmad=false.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = THREADS;  // rows per block: one 32-row tile per warp
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 a) {
  return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

__device__ __forceinline__ float iou_strict(float4 a, float area_a, float4 b, float area_b) {
  const float tl_r = fmaxf(a.x, b.x);
  const float tl_c = fmaxf(a.y, b.y);
  const float br_r = fminf(a.z, b.z);
  const float br_c = fminf(a.w, b.w);
  const float wh_r = __fsub_rn(br_r, tl_r);
  const float wh_c = __fsub_rn(br_c, tl_c);
  const bool overlap = wh_r > 0.f && wh_c > 0.f;
  const float inter = overlap ? __fmul_rn(wh_r, wh_c) : 0.f;
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  // the plain version's 0 / union without overlap, and its 0 where union <= 0,
  // are both +0: those pairs divide 1 by 1 (no branch, and not the checked
  // slow path that a zero dividend takes) and select +0
  const bool pos = overlap && uni > 0.f;
  const float q = __fdiv_rn(pos ? inter : 1.f, pos ? uni : 1.f);
  return pos ? q : 0.f;
}

// (v, i) beats (best, best_i): a greater value, or the same value at a lower index
__device__ __forceinline__ bool beats(float v, int i, float best, int best_i) {
  return v > best || (v == best && i < best_i);
}

// (value, row) as one 64-bit key whose unsigned order is a greater value, then
// a lower row: the value's bits mapped to an unsigned integer of the same
// order (an IoU is never NaN), above 0xffffffff - row. 0 is below every key.
__device__ __forceinline__ unsigned long long col_key(float v, int row) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ordered) << 32) | (0xffffffffu - static_cast<uint32_t>(row));
}

constexpr int TILE_LD = 33;  // row stride of a warp's 32 x 32 value tile: no bank conflicts

// dynamic shared memory: the image's gt boxes, the warps' value tiles, the
// unpadded columns, and with the column argmax each warp's best (value, row)
// per unpadded column
__host__ __device__ constexpr int smem_bytes(int g_cols, bool want_col) {
  return static_cast<int>(sizeof(float)) * (4 * g_cols + WARPS * 32 * TILE_LD + g_cols +
                                            (want_col ? 2 * WARPS * g_cols : 0));
}

template <bool WANT_COL, bool WANT_IOU>
__global__ void __launch_bounds__(THREADS)
iou_match_kernel(const float4* __restrict__ boxes,   // [B or 1, M]
                 long long box_stride,                // M, or 0 for shared boxes
                 const float4* __restrict__ gt,       // [B, G]
                 const bool* __restrict__ gt_mask,    // [B, G]
                 int m_rows, int g_cols,
                 float* __restrict__ iou_out,         // [B, M, G] or null
                 int64_t* __restrict__ argmax_out,    // [B, M]
                 float* __restrict__ max_out,         // [B, M]
                 unsigned long long* keys,            // [B, G], 0 between launches
                 unsigned* counters,                  // [B], 0 between launches
                 int64_t* __restrict__ col_out) {     // [B, G]
  __shared__ float4 s_box[ROWS];
  __shared__ float s_area[ROWS];
  __shared__ int s_active;
  __shared__ bool s_last;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_gt = reinterpret_cast<float4*>(smem);               // [G]
  float* s_val = reinterpret_cast<float*>(s_gt + g_cols);       // [WARPS, 32, TILE_LD]
  int* s_cols = reinterpret_cast<int*>(s_val + WARPS * 32 * TILE_LD);  // [G] unpadded, ascending
  float* s_cv = reinterpret_cast<float*>(s_cols + g_cols);  // [WARPS, G] by unpadded index
  int* s_cr = reinterpret_cast<int*>(s_cv + WARPS * g_cols);

  const int img = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;
  const float4* img_gt = gt + static_cast<long long>(img) * g_cols;
  const bool* img_mask = gt_mask + static_cast<long long>(img) * g_cols;
  {
    const int r = row0 + tid;
    const float4 b = r < m_rows ? boxes[img * box_stride + r] : make_float4(0.f, 0.f, 0.f, 0.f);
    s_box[tid] = b;
    s_area[tid] = box_area(b);
  }
  for (int g = tid; g < g_cols; g += THREADS) s_gt[g] = img_gt[g];
  if (warp == 0) {  // the unpadded columns, in order
    int count = 0;
    for (int c0 = 0; c0 < g_cols; c0 += 32) {
      const bool on = c0 + lane < g_cols && img_mask[c0 + lane];
      const unsigned ballot = __ballot_sync(FULL, on);
      if (on) s_cols[count + __popc(ballot & ((1u << lane) - 1u))] = c0 + lane;
      count += __popc(ballot);
    }
    if (lane == 0) s_active = count;
  }
  __syncthreads();
  const int active = s_active;

  const int tile = row0 + warp * 32;
  const int rows = min(32, m_rows - tile);  // rows of this warp's tile below M (may be <= 0)
  const float4* t_box = s_box + warp * 32;
  const float* t_area = s_area + warp * 32;
  float* t_val = s_val + warp * 32 * TILE_LD;
  float* img_iou = WANT_IOU ? iou_out + static_cast<long long>(img) * m_rows * g_cols : nullptr;

  float best = -INFINITY;  // row state of tile row `lane`: greatest IoU, its first unpadded index
  int best_k = 0;
  for (int k0 = 0; k0 < active; k0 += 32) {
    // a chunk of up to 32 unpadded columns: `width` lanes (a power of two) per
    // row, 32 / width rows per step
    const int span = min(32, active - k0);
    const int width = span == 1 ? 1 : 1 << (32 - __clz(span - 1));
    const int per_step = 32 / width;
    const int k = lane & (width - 1);
    const bool live = k < span;
    float4 gb = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) gb = s_gt[s_cols[k0 + k]];
    const float area_g = box_area(gb);
    // 1. lanes over (row, column): each lane walks its rows in order, keeping
    //    its column's best on strictly greater (the first row on ties)
    float cbest = -INFINITY;
    int crow = INT_MAX;
#pragma unroll 4
    for (int t = lane / width; t < rows; t += per_step) {
      const float v = iou_strict(t_box[t], t_area[t], gb, area_g);
      if (WANT_COL && v > cbest) {
        cbest = v;
        crow = tile + t;
      }
      t_val[t * TILE_LD + k] = v;
      if (WANT_IOU && live) {
        img_iou[static_cast<long long>(tile + t) * g_cols + s_cols[k0 + k]] = v;
      }
    }
    if (WANT_COL) {  // the lanes of one column: greater value, then lower row
      for (int off = width; off < 32; off <<= 1) {
        const float ov = __shfl_xor_sync(FULL, cbest, off);
        const int orow = __shfl_xor_sync(FULL, crow, off);
        if (beats(ov, orow, cbest, crow)) {
          cbest = ov;
          crow = orow;
        }
      }
      if (lane < span) {
        s_cv[warp * g_cols + k0 + lane] = cbest;
        s_cr[warp * g_cols + k0 + lane] = crow;
      }
    }
    __syncwarp();
    // 2. lane = row: its IoUs with the chunk's columns in order, kept on
    //    strictly greater (the first column on ties)
    const float* my = t_val + lane * TILE_LD;
#pragma unroll 4
    for (int kk = 0; kk < span; ++kk) {
      const float v = my[kk];
      if (v > best) {
        best = v;
        best_k = k0 + kk;
      }
    }
    __syncwarp();
  }
  // a padded column is -1 in every row: never a row's best beside an
  // unpadded one (an IoU is >= 0); with none unpadded, column 0 and 0 win
  if (lane < rows) {
    const long long out_row = static_cast<long long>(img) * m_rows + tile + lane;
    argmax_out[out_row] = active > 0 ? s_cols[best_k] : 0;
    max_out[out_row] = fmaxf(best, 0.f);
  }
  if (WANT_IOU && active < g_cols) {
    for (int t = 0; t < rows; ++t) {
      for (int g = lane; g < g_cols; g += 32) {
        if (!img_mask[g]) img_iou[static_cast<long long>(tile + t) * g_cols + g] = -1.f;
      }
    }
  }
  if (!WANT_COL) return;

  // this block's best row per unpadded column -> one 64-bit atomicMax each (the
  // maximum of the keys does not depend on the order of the atomics); a padded
  // column's key stays 0
  __syncthreads();
  const int warps_here = min(WARPS, (m_rows - row0 + 31) / 32);  // warps with rows below M
  unsigned long long* img_keys = keys + static_cast<long long>(img) * g_cols;
  for (int k = tid; k < active; k += THREADS) {
    float v = s_cv[k];
    int r = s_cr[k];
    for (int w = 1; w < warps_here; ++w) {  // ascending rows: strictly greater keeps the first
      const float v2 = s_cv[w * g_cols + k];
      if (v2 > v) {
        v = v2;
        r = s_cr[w * g_cols + k];
      }
    }
    atomicMax(&img_keys[s_cols[k]], col_key(v, r));
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[img], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // the image's last block: every key is final; take it, leave 0 for the next
  // launch and write the row (a padded column's -1 everywhere: row 0)
  for (int g = tid; g < g_cols; g += THREADS) {
    const unsigned long long key = atomicExch(&img_keys[g], 0ull);
    col_out[static_cast<long long>(img) * g_cols + g] =
        key == 0ull ? 0 : static_cast<int64_t>(0xffffffffu - static_cast<uint32_t>(key));
  }
  if (tid == 0) counters[img] = 0u;  // every block of this image has taken its ticket
}

// One instantiation's launch, first letting it take the dynamic shared memory
// that G needs (its limit raised once, when a launch first needs more).
// Returns the CUDA error.
template <bool WANT_COL, bool WANT_IOU>
int launch(dim3 grid, cudaStream_t s, const float4* boxes, long long box_stride,
           const float4* gt, const bool* mask, int m_rows, int g_cols, float* iou,
           int64_t* argmax, float* mx, unsigned long long* keys, int64_t* col) {
  static int smem_set = 0;
  const int smem = smem_bytes(g_cols, WANT_COL);
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(iou_match_kernel<WANT_COL, WANT_IOU>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  unsigned* counters =
      WANT_COL ? reinterpret_cast<unsigned*>(keys + static_cast<long long>(grid.y) * g_cols) : nullptr;
  iou_match_kernel<WANT_COL, WANT_IOU><<<grid, THREADS, smem, s>>>(
      boxes, box_stride, gt, mask, m_rows, g_cols, iou, argmax, mx, keys, counters, col);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 = cudaSuccess). iou_out may be null.
// col_out null skips the column argmax; otherwise state holds batch * g_cols
// 64-bit keys, then batch 32-bit counters, all 0 (the kernel leaves them 0).
int iou_match_launch(const void* boxes, long long box_stride, const void* gt,
                     const void* gt_mask, int batch, int m_rows, int g_cols,
                     void* iou_out, void* argmax_out, void* max_out, void* col_out,
                     void* state, void* stream) {
  if (batch <= 0 || m_rows <= 0 || g_cols <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m_rows + ROWS - 1) / ROWS, batch);
  const auto* b = static_cast<const float4*>(boxes);
  const auto* g = static_cast<const float4*>(gt);
  const auto* mask = static_cast<const bool*>(gt_mask);
  auto* iou = static_cast<float*>(iou_out);
  auto* amax = static_cast<int64_t*>(argmax_out);
  auto* mx = static_cast<float*>(max_out);
  if (col_out == nullptr) {
    return iou_out == nullptr
               ? launch<false, false>(grid, s, b, box_stride, g, mask, m_rows, g_cols, iou, amax,
                                      mx, nullptr, nullptr)
               : launch<false, true>(grid, s, b, box_stride, g, mask, m_rows, g_cols, iou, amax,
                                     mx, nullptr, nullptr);
  }
  auto* keys = static_cast<unsigned long long*>(state);
  auto* col = static_cast<int64_t*>(col_out);
  return iou_out == nullptr
             ? launch<true, false>(grid, s, b, box_stride, g, mask, m_rows, g_cols, iou, amax, mx,
                                   keys, col)
             : launch<true, true>(grid, s, b, box_stride, g, mask, m_rows, g_cols, iou, amax, mx,
                                  keys, col);
}

const char* iou_match_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
