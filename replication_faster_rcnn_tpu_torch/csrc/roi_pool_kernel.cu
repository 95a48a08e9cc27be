// ROIPool forward and backward (Caffe/torchvision quantized max pooling)
// over NHWC features.
//
// Replaces: no Pallas kernel. The JAX package runs ROIPool as XLA masked
// maxes, replication_faster_rcnn_tpu/ops/roi_ops.py::roi_pool (and its VJP
// for training). Plain version in the port:
// replication_faster_rcnn_tpu_torch/ops/roi_ops.py::roi_pool, the same
// masked-max formulation: for each of the out columns a torch.where over
// [N, R, H, W, C], then one per row over [N, R, H, out, C]. That plain
// version writes and reads tens of gigabytes at the serving shape; these
// kernels read each bin of the map once per roi.
//
// Semantics, which the forward repeats bit for bit (built with -fmad=false):
//   * roi corners (already in feature coordinates) round half to even;
//   * extent max(r2 - r1 + 1, 1), a NaN extent stays NaN, times the float32
//     reciprocal of out (the JAX package's compiled program folds the
//     division by the constant into that multiply);
//   * bin p spans [floor(p * size) + start, ceil((p + 1) * size) + start),
//     both edges clamped to [0, extent]; a NaN edge (a NaN roi) makes the
//     bin empty, as the plain version's comparisons with NaN are false;
//   * the value is the maximum over the bin, NaN propagating as amax does
//     (fmaxf would drop it); a non-finite result (NaN, +-inf, or an empty
//     bin's -inf) becomes 0. The output keeps the feature's dtype, so the
//     bfloat16 maximum is exact.
//
// Backward: the plain version's VJP (autograd of the masked maxes, and the
// JAX VJP alike) splits a tied maximum's gradient evenly in two stages. For
// bin (i, j) with value m, row h of the bin gets g / (number of rows h' of
// the bin whose column maximum col[h', j] over column bin j equals m); the
// feature at (h, w) gets, summed over the bins (i, j) that hold it, that row
// share divided by the number of columns w' of column bin j with
// feat[h, w'] == col[h, j], where feat[h, w] == col[h, j] == m. A bin whose
// value is not finite passes nothing. Overlapping bins and rois add up.
// Where a NaN lies in a bin, the plain VJP computes 0 / 0 and turns whole
// channels of the gradient into NaN; the kernel passes nothing through a
// NaN and stays finite (the gradients agree wherever the plain one is
// finite).
//
// What bounds them on the H100: bytes, on paper. Forward at the serving
// shape (8 images, 300 rois, [38, 38, 256] bfloat16): the map once (5.9 MB,
// it stays in L2) and the output once (60.2 MB): 0.0197 ms. Backward at the
// training shape (8 x 128 rois): grad_out once (25.7 MB in bfloat16), the
// map once and grad_feat once (5.9 MB each): ~0.011 ms. In practice each
// bin's pixels are gathered from L2 by the warp that owns the bin, once per
// roi, and the backward's two passes add their scratch traffic.
//
// Forward design (roi_pool_kernel): one 256-thread block per (image, roi),
// its bins split over a few blocks when there are too few rois to fill the
// card. The block computes the roi's 2 * out bin edges once into shared
// memory; a warp then takes one bin at a time and each lane 8 consecutive
// channels (16-byte loads and stores), or single channels where C is not a
// multiple of 8 or a base is not 16-byte aligned (a second instantiation).
//
// Backward design: two passes, deterministic, no atomics.
//   1. roi_pool_bwd_bins_kernel, laid out like the forward: for every roi
//      bin and channel, the bin's maximum m and the number of its rows whose
//      column maximum equals m, in one walk over the bin; it writes m and the
//      row share a = g / count (0 where m is not finite) to two float32
//      scratch arrays [N, R, out, out, C] that the wrapper allocates: 51.4 MB
//      each at 8 x 128 x 7 x 7 x 256, freed when the backward returns. The
//      forward saves nothing but references to its inputs.
//   2. roi_pool_bwd_kernel gathers: a warp owns one pixel and a lane 8
//      channels (a block, 8 pixels of one row and 256 channels). It walks the
//      image's rois in index order, their bin edges staged in shared memory a
//      chunk at a time; for each roi and column bin that hold the pixel it
//      computes the column maximum of the pixel's row over the bin and its
//      tie count, and where the pixel equals it, adds the row shares of the
//      row bins that hold the pixel and whose m equals that maximum, divided
//      by the count. Each pixel is written once, in the feature's dtype, with
//      the same sums in the same order in every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_OUT = 256;  // bins along one axis
constexpr int EDGE_BUDGET = 24 * 1024;  // shared bytes of staged roi edges in pass 2

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 8 channels from a 16-byte aligned address, as float32
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// A lane's 8 channel slots: 8 consecutive channels from p (VEC), or every
// 32nd channel from p, the first nch of them. Missing slots read -inf.
template <bool VEC, typename T>
__device__ __forceinline__ void load_lane(const T* p, int nch, float (&v)[8]) {
  if (VEC) {
    load8(p, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = k < nch ? to_f32(p[32 * k]) : -INFINITY;
}

template <bool VEC, typename T>
__device__ __forceinline__ void store_lane(T* p, int nch, const float (&v)[8]) {
  if (VEC) {
    store8(p, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < nch) store1(p + 32 * k, v[k]);
  }
}

// Bins along one axis: [lo, hi), empty when lo >= hi.
struct Span {
  int lo, hi;
};

// torch.clamp / jnp.clip: NaN passes through
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Bin p of a roi along one axis, from its two corners (feature coordinates).
__device__ __forceinline__ Span bin_span(float a, float b, int p, float inv_out, int extent) {
  const float start = rintf(a);
  float ext = __fadd_rn(__fsub_rn(rintf(b), start), 1.f);
  ext = ext < 1.f ? 1.f : ext;  // NaN stays NaN
  const float size = __fmul_rn(ext, inv_out);
  const float pf = static_cast<float>(p);
  const float e = static_cast<float>(extent);
  const float lo = clamp_keep_nan(__fadd_rn(floorf(__fmul_rn(pf, size)), start), 0.f, e);
  const float hi = clamp_keep_nan(
      __fadd_rn(ceilf(__fmul_rn(__fadd_rn(pf, 1.f), size)), start), 0.f, e);
  Span s;
  if (isnan(lo) || isnan(hi)) {
    s.lo = 0;
    s.hi = 0;
  } else {
    s.lo = static_cast<int>(lo);
    s.hi = static_cast<int>(hi);
  }
  return s;
}

// The 2 * out spans of a roi into shared memory: rows first, then columns.
__device__ __forceinline__ void roi_spans(const float* roi, int out, int h, int w, Span* spans,
                                          int t, int stride) {
  const float inv_out = __fdiv_rn(1.f, static_cast<float>(out));
  for (int k = t; k < 2 * out; k += stride) {
    spans[k] = k < out ? bin_span(roi[0], roi[2], k, inv_out, h)
                       : bin_span(roi[1], roi[3], k - out, inv_out, w);
  }
}

// amax's maximum: NaN propagates
__device__ __forceinline__ float max_nan(float m, float v) { return (v > m || isnan(v)) ? v : m; }

// Running maximum and the number of values equal to it (NaN sticks).
__device__ __forceinline__ void max_count(float v, float& m, int& n) {
  if (isnan(m)) return;
  if (isnan(v) || v > m) {
    m = v;
    n = 1;
  } else if (v == m) {
    ++n;
  }
}

// A lane's first channel and how many of its 8 slots are real.
template <bool VEC>
__device__ __forceinline__ int lane_channels(int base, int lane, int c, int& ch) {
  ch = base + (VEC ? 8 * lane : lane);
  if (VEC) return max(0, min(8, c - ch));
  int n = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) n += ch + 32 * k < c;
  return n;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
roi_pool_kernel(const T* __restrict__ feat,      // [N, H, W, C]
                const float* __restrict__ rois,  // [N, R, 4] feature coords
                int h, int w, int c, int r, int out,
                T* __restrict__ dst) {           // [N, R, out, out, C]
  extern __shared__ Span spans[];                // [out] rows, then [out] columns
  const int64_t nr = blockIdx.x;
  const int n = static_cast<int>(nr / r);
  roi_spans(rois + nr * 4, out, h, w, spans, threadIdx.x, blockDim.x);
  __syncthreads();

  const T* img = feat + static_cast<int64_t>(n) * h * w * c;
  const int lane = threadIdx.x & 31;
  const int bins = out * out;
  for (int b = blockIdx.y * WARPS + (threadIdx.x >> 5); b < bins; b += gridDim.y * WARPS) {
    const Span ry = spans[b / out], rx = spans[out + b % out];
    T* o = dst + (nr * bins + b) * c;
    for (int base = 0; base < c; base += 256) {
      int ch;
      const int nch = lane_channels<VEC>(base, lane, c, ch);
      if (nch <= 0) break;
      float m[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) m[k] = -INFINITY;
      for (int y = ry.lo; y < ry.hi; ++y) {
        const T* row = img + static_cast<int64_t>(y) * w * c + ch;
        for (int x = rx.lo; x < rx.hi; ++x) {
          float v[8];
          load_lane<VEC>(row + static_cast<int64_t>(x) * c, nch, v);
#pragma unroll
          for (int k = 0; k < 8; ++k) m[k] = max_nan(m[k], v[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) m[k] = isfinite(m[k]) ? m[k] : 0.f;
      store_lane<VEC>(o + ch, nch, m);
    }
  }
}

// Pass 1 of the backward: per roi bin and channel, the maximum m and the row
// share a = g / (rows of the bin whose column maximum equals m).
template <typename T, typename G, bool VEC>
__global__ void __launch_bounds__(THREADS)
roi_pool_bwd_bins_kernel(const T* __restrict__ feat,      // [N, H, W, C]
                         const G* __restrict__ grad_out,  // [N, R, out, out, C]
                         const float* __restrict__ rois,  // [N, R, 4] feature coords
                         int h, int w, int c, int r, int out,
                         float* __restrict__ bin_max,     // [N, R, out, out, C]
                         float* __restrict__ row_share) { // [N, R, out, out, C]
  extern __shared__ Span spans[];
  const int64_t nr = blockIdx.x;
  const int n = static_cast<int>(nr / r);
  roi_spans(rois + nr * 4, out, h, w, spans, threadIdx.x, blockDim.x);
  __syncthreads();

  const T* img = feat + static_cast<int64_t>(n) * h * w * c;
  const int lane = threadIdx.x & 31;
  const int bins = out * out;
  for (int b = blockIdx.y * WARPS + (threadIdx.x >> 5); b < bins; b += gridDim.y * WARPS) {
    const Span ry = spans[b / out], rx = spans[out + b % out];
    const int64_t at = (nr * bins + b) * c;
    for (int base = 0; base < c; base += 256) {
      int ch;
      const int nch = lane_channels<VEC>(base, lane, c, ch);
      if (nch <= 0) break;
      float m[8];
      int cnt[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        m[k] = -INFINITY;
        cnt[k] = 0;
      }
      for (int y = ry.lo; y < ry.hi; ++y) {
        const T* row = img + static_cast<int64_t>(y) * w * c + ch;
        float rm[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) rm[k] = -INFINITY;
        for (int x = rx.lo; x < rx.hi; ++x) {
          float v[8];
          load_lane<VEC>(row + static_cast<int64_t>(x) * c, nch, v);
#pragma unroll
          for (int k = 0; k < 8; ++k) rm[k] = max_nan(rm[k], v[k]);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) max_count(rm[k], m[k], cnt[k]);
      }
      float g[8], a[8];
      load_lane<VEC>(grad_out + at + ch, nch, g);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        a[k] = isfinite(m[k]) ? __fdiv_rn(g[k], static_cast<float>(cnt[k])) : 0.f;
      }
      store_lane<VEC>(bin_max + at + ch, nch, m);
      store_lane<VEC>(row_share + at + ch, nch, a);
    }
  }
}

// Pass 2 of the backward: a warp per pixel gathers what the rois' bins give
// it (see the note at the top).
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
roi_pool_bwd_kernel(const T* __restrict__ feat,            // [N, H, W, C]
                    const float* __restrict__ rois,        // [N, R, 4] feature coords
                    const float* __restrict__ bin_max,     // [N, R, out, out, C]
                    const float* __restrict__ row_share,   // [N, R, out, out, C]
                    int h, int w, int c, int r, int out, int tiles_x, int chunk,
                    T* __restrict__ grad_feat) {           // [N, H, W, C]
  extern __shared__ Span spans[];                          // [chunk][2 * out]
  int idx = blockIdx.x;
  const int x = (idx % tiles_x) * WARPS + (threadIdx.x >> 5);
  idx /= tiles_x;
  const int y = idx % h;
  const int n = idx / h;
  const int lane = threadIdx.x & 31;
  int ch;
  const int nch = lane_channels<VEC>(blockIdx.y * 256, lane, c, ch);
  const bool active = x < w && nch > 0;

  const T* pix_row = feat + (static_cast<int64_t>(n) * h + y) * w * c + ch;
  float v[8], acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = -INFINITY;
    acc[k] = 0.f;
  }
  if (active) load_lane<VEC>(pix_row + static_cast<int64_t>(x) * c, nch, v);
  const int bins = out * out;
  const int per_roi = 2 * out;

  for (int r0 = 0; r0 < r; r0 += chunk) {
    const int m_rois = min(chunk, r - r0);
    __syncthreads();  // the previous chunk's spans are no longer read
    for (int k = threadIdx.x; k < m_rois * per_roi; k += blockDim.x) {
      const int j = k / per_roi;
      roi_spans(rois + (static_cast<int64_t>(n) * r + r0 + j) * 4, out, h, w,
                spans + j * per_roi, k - j * per_roi, per_roi);
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < m_rois; ++j) {
      const Span* ry = spans + j * per_roi;
      const Span* rx = ry + out;
      if (y < ry[0].lo || y >= ry[out - 1].hi || x < rx[0].lo || x >= rx[out - 1].hi) continue;
      const int64_t roi_at = ((static_cast<int64_t>(n) * r + r0 + j) * bins) * c + ch;
      for (int bj = 0; bj < out; ++bj) {
        const Span sx = rx[bj];
        if (x < sx.lo || x >= sx.hi) continue;
        // the column maximum of this row over column bin bj, and its ties
        float cm[8];
        int cnt[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          cm[k] = -INFINITY;
          cnt[k] = 0;
        }
        for (int xx = sx.lo; xx < sx.hi; ++xx) {
          float u[8];
          load_lane<VEC>(pix_row + static_cast<int64_t>(xx) * c, nch, u);
#pragma unroll
          for (int k = 0; k < 8; ++k) max_count(u[k], cm[k], cnt[k]);
        }
        bool hit[8], any = false;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          hit[k] = v[k] == cm[k] && isfinite(cm[k]);
          any = any || hit[k];
        }
        if (!any) continue;
        float s[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) s[k] = 0.f;
        for (int bi = 0; bi < out; ++bi) {
          if (y < ry[bi].lo || y >= ry[bi].hi) continue;
          const int64_t at = roi_at + static_cast<int64_t>(bi * out + bj) * c;
          float m[8], a[8];
          load_lane<VEC>(bin_max + at, nch, m);
          load_lane<VEC>(row_share + at, nch, a);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (hit[k] && cm[k] == m[k]) s[k] = __fadd_rn(s[k], a[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (hit[k]) acc[k] = __fadd_rn(acc[k], __fdiv_rn(s[k], static_cast<float>(cnt[k])));
        }
      }
    }
  }
  if (active) {
    store_lane<VEC>(grad_feat + (static_cast<int64_t>(n) * h + y) * w * c +
                        static_cast<int64_t>(x) * c + ch,
                    nch, acc);
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int ceil_div(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

// Blocks per roi: enough for two full waves of 256-thread blocks, at most
// one bin per warp.
dim3 roi_grid(int64_t n_rois, int out) {
  const int max_splits = ceil_div(static_cast<int64_t>(out) * out, WARPS);
  const int splits = ceil_div(2LL * sm_count() * (2048 / THREADS), n_rois);
  return dim3(static_cast<unsigned int>(n_rois),
              static_cast<unsigned int>(max(1, min(splits, max_splits))));
}

template <typename T>
int launch_fwd(const void* feat, const void* rois, int batch, int h, int w, int c, int r,
               int out, void* dst, cudaStream_t stream) {
  const int64_t n_rois = static_cast<int64_t>(batch) * r;
  if (n_rois == 0 || c == 0) return 0;
  if (out < 1 || out > MAX_OUT) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = c % 8 == 0 && aligned(feat, 16) && aligned(dst, 16);
  auto kernel = vec ? roi_pool_kernel<T, true> : roi_pool_kernel<T, false>;
  kernel<<<roi_grid(n_rois, out), THREADS, 2 * out * sizeof(Span), stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois), h, w, c, r, out,
      static_cast<T*>(dst));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename G>
int launch_bwd(const void* feat, const void* grad_out, const void* rois, int batch, int h,
               int w, int c, int r, int out, void* bin_max, void* row_share, void* grad_feat,
               cudaStream_t stream) {
  const int64_t pixels = static_cast<int64_t>(batch) * h * w;
  if (pixels == 0 || c == 0) return 0;
  if (out < 1 || out > MAX_OUT) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = c % 8 == 0 && aligned(feat, 16) && aligned(grad_out, 16) &&
                   aligned(grad_feat, 16) && aligned(bin_max, 16) && aligned(row_share, 16);
  const int64_t n_rois = static_cast<int64_t>(batch) * r;
  if (n_rois > 0) {
    auto bins = vec ? roi_pool_bwd_bins_kernel<T, G, true> : roi_pool_bwd_bins_kernel<T, G, false>;
    bins<<<roi_grid(n_rois, out), THREADS, 2 * out * sizeof(Span), stream>>>(
        static_cast<const T*>(feat), static_cast<const G*>(grad_out),
        static_cast<const float*>(rois), h, w, c, r, out, static_cast<float*>(bin_max),
        static_cast<float*>(row_share));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const int per_roi = 2 * out * static_cast<int>(sizeof(Span));
  const int chunk = max(1, min(max(r, 1), EDGE_BUDGET / per_roi));
  const int tiles_x = ceil_div(w, WARPS);
  const dim3 grid(static_cast<unsigned int>(static_cast<int64_t>(batch) * h * tiles_x),
                  static_cast<unsigned int>(ceil_div(c, 256)));
  auto gather = vec ? roi_pool_bwd_kernel<T, true> : roi_pool_bwd_kernel<T, false>;
  gather<<<grid, THREADS, chunk * per_roi, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois),
      static_cast<const float*>(bin_max), static_cast<const float*>(row_share), h, w, c, r, out,
      tiles_x, chunk, static_cast<T*>(grad_feat));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Forward: feat [batch, h, w, c] (bf16 when feat_bf16, else f32), rois
// [batch, r, 4] f32 in feature coordinates -> dst [batch, r, out, out, c] in
// the feature's dtype. Returns the CUDA error of the launch (0 = cudaSuccess).
int roi_pool_fwd(const void* feat, int feat_bf16, const void* rois, int batch, int h, int w,
                 int c, int r, int out, void* dst, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return feat_bf16 ? launch_fwd<__nv_bfloat16>(feat, rois, batch, h, w, c, r, out, dst, st)
                   : launch_fwd<float>(feat, rois, batch, h, w, c, r, out, dst, st);
}

// Backward: feat as in the forward, grad_out [batch, r, out, out, c] (bf16
// when grad_bf16, else f32), two float32 scratch arrays of grad_out's shape
// -> grad_feat [batch, h, w, c] in the feature's dtype, every element written
// once. Two launches on the stream; returns the first CUDA error.
int roi_pool_bwd(const void* feat, int feat_bf16, const void* grad_out, int grad_bf16,
                 const void* rois, int batch, int h, int w, int c, int r, int out,
                 void* bin_max, void* row_share, void* grad_feat, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feat_bf16) {
    return grad_bf16 ? launch_bwd<__nv_bfloat16, __nv_bfloat16>(
                           feat, grad_out, rois, batch, h, w, c, r, out, bin_max, row_share,
                           grad_feat, st)
                     : launch_bwd<__nv_bfloat16, float>(feat, grad_out, rois, batch, h, w, c, r,
                                                        out, bin_max, row_share, grad_feat, st);
  }
  return grad_bf16 ? launch_bwd<float, __nv_bfloat16>(feat, grad_out, rois, batch, h, w, c, r,
                                                      out, bin_max, row_share, grad_feat, st)
                   : launch_bwd<float, float>(feat, grad_out, rois, batch, h, w, c, r, out,
                                              bin_max, row_share, grad_feat, st);
}

const char* roi_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
