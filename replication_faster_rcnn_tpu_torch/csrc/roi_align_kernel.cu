// ROIAlign forward and backward (aligned=False, bin mean) over NHWC features.
//
// Forward replaces: replication_faster_rcnn_tpu/ops/pallas/roi_kernel.py::_roi_kernel
// (wrapper roi_align_pallas). Plain version:
// replication_faster_rcnn_tpu_torch/ops/roi_ops.py::roi_align(method="gather"),
// which this kernel matches bit for bit: same sample coordinates, same four
// taps, same products and sums in the same order, built with -fmad=false.
//
// Backward: the JAX package has no backward kernel (its custom_vjp replays
// the XLA einsum formulation's VJP, roi_kernel.py:99-112). The port needs
// one because its forward is this hand-written kernel, which autograd cannot
// see through. Plain version: ops/roi_ops.py::roi_align_backward. See the
// note above roi_align_bwd_kernel.
//
// Semantics (torchvision aligned=False, as ops/roi_ops.py in the JAX package):
//   * roi extents have a 1-pixel minimum; bin = extent * (1/out), the float32
//     reciprocal, as the JAX package's compiled program computes it;
//   * sample i of bin p sits at r1 + ((p*s + i) + 0.5) / s * bin;
//   * a point outside [-1, extent] contributes 0, an in-range point clamps
//     to [0, extent-1] (so at the border the tent collapses onto one tap);
//   * the s*s samples of a bin are averaged. Accumulation is float32 and the
//     output is float32 for float32 or bfloat16 features (the JAX package's
//     default einsum path promotes bf16 features against f32 weights).
//
// What bounds it on the H100: bytes. Each output element needs 4*s*s feature
// reads (16 at s=2) and ~50 flops, but the feature map of an image (38x38x256
// bf16 = 740 KB) stays in L2, so device memory sees the map once and the f32
// output once: at B=8, 300 rois, 7x7x256 that is ~120 MB of output against
// ~6 MB of input.
//
// What the design does about it: the TPU kernel's two dense tent-weight
// products (there for the MXU) are dropped; one block per (image, roi, bin)
// and one thread per channel read the 4 taps of each sample straight from
// feat. Consecutive threads take consecutive channels, so every tap load and
// the output store are coalesced in NHWC. Nothing is staged in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One axis of the sampling grid: clamped tap pair, weights, in-range flag.
struct Axis {
  int i0, i1;
  float w0, w1;
  bool in_range;
};

__device__ __forceinline__ Axis sample_axis(float start, float bin, int k, int s,
                                            int extent) {
  const float pts = __fdiv_rn(__fadd_rn(static_cast<float>(k), 0.5f),
                              static_cast<float>(s));
  const float coord = __fadd_rn(start, __fmul_rn(pts, bin));
  Axis a;
  a.in_range = coord >= -1.f && coord <= static_cast<float>(extent);
  const float x = fminf(fmaxf(coord, 0.f), static_cast<float>(extent - 1));
  const float x0 = floorf(x);
  const float frac = __fsub_rn(x, x0);
  a.i0 = static_cast<int>(x0);
  a.i1 = min(a.i0 + 1, extent - 1);
  a.w0 = __fsub_rn(1.f, frac);
  a.w1 = frac;
  return a;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
roi_align_kernel(const T* __restrict__ feat,       // [N, H, W, C]
                 const float* __restrict__ rois,   // [N, R, 4] feature coords
                 int h, int w, int c, int r, int out, int s,
                 float* __restrict__ dst) {        // [N, R, out, out, C]
  const int64_t bin_id = blockIdx.x;               // ((n * R + roi) * out + py) * out + px
  const int px = static_cast<int>(bin_id % out);
  const int py = static_cast<int>((bin_id / out) % out);
  const int64_t nr = bin_id / (static_cast<int64_t>(out) * out);
  const int n = static_cast<int>(nr / r);

  const float* roi = rois + nr * 4;
  const float r1 = roi[0], c1 = roi[1], r2 = roi[2], c2 = roi[3];
  // extent (1-pixel minimum) times the float32 reciprocal of the bin count
  const float inv_out = __fdiv_rn(1.f, static_cast<float>(out));
  const float bin_h = __fmul_rn(fmaxf(__fsub_rn(r2, r1), 1.f), inv_out);
  const float bin_w = __fmul_rn(fmaxf(__fsub_rn(c2, c1), 1.f), inv_out);

  const T* img = feat + static_cast<int64_t>(n) * h * w * c;
  float* out_ptr = dst + bin_id * c;
  const float n_samples = static_cast<float>(s * s);

  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float acc = 0.f;
    for (int iy = 0; iy < s; ++iy) {
      const Axis ay = sample_axis(r1, bin_h, py * s + iy, s, h);
      for (int ix = 0; ix < s; ++ix) {
        const Axis ax = sample_axis(c1, bin_w, px * s + ix, s, w);
        const float f00 = to_f32(img[(static_cast<int64_t>(ay.i0) * w + ax.i0) * c + ch]);
        const float f01 = to_f32(img[(static_cast<int64_t>(ay.i0) * w + ax.i1) * c + ch]);
        const float f10 = to_f32(img[(static_cast<int64_t>(ay.i1) * w + ax.i0) * c + ch]);
        const float f11 = to_f32(img[(static_cast<int64_t>(ay.i1) * w + ax.i1) * c + ch]);
        float v = __fmul_rn(f00, __fmul_rn(ay.w0, ax.w0));
        v = __fadd_rn(v, __fmul_rn(f01, __fmul_rn(ay.w0, ax.w1)));
        v = __fadd_rn(v, __fmul_rn(f10, __fmul_rn(ay.w1, ax.w0)));
        v = __fadd_rn(v, __fmul_rn(f11, __fmul_rn(ay.w1, ax.w1)));
        acc = __fadd_rn(acc, (ay.in_range && ax.in_range) ? v : 0.f);
      }
    }
    out_ptr[ch] = __fdiv_rn(acc, n_samples);
  }
}

template <typename T>
int launch(const void* feat, const void* rois, int batch, int h, int w, int c,
           int r, int out, int s, void* dst, void* stream) {
  const int64_t bins = static_cast<int64_t>(batch) * r * out * out;
  if (bins == 0) return 0;
  roi_align_kernel<T><<<static_cast<unsigned int>(bins), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois), h, w, c, r,
      out, s, static_cast<float*>(dst));
  return static_cast<int>(cudaGetLastError());
}

// Backward: scatter grad_out [N, R, out, out, C] (float32) through the same
// taps and weights as the forward into a zeroed float32 grad_feat
// [N, H, W, C]; the wrapper casts it to the feature's dtype. Every rule of
// the forward is repeated by sharing sample_axis: the 1-pixel minimum
// extent, the float32 reciprocal of out, the [-1, extent] range test (a
// sample outside it contributes nothing) and the clamp, so at the border
// i1 == i0 and both taps land on one pixel. Each contribution is
// (grad / (s*s)) * (wy * wx), the product the plain version forms.
//
// What bounds it on the H100: the atomics. At the training shape (8 images,
// 128 rois, 7x7, s=2, 256 channels) it performs 4 * s * s = 16 float atomic
// adds per output element, ~205 M in all, into an 11.8 MB float32 gradient
// that stays in L2; the bytes it must move (grad_out 51.4 MB in, grad_feat
// 11.8 MB out) take ~0.019 ms at 3.35 TB/s.
//
// Design: the forward's layout (one block per bin, one thread per channel),
// so a warp's 32 atomics go to 32 consecutive floats of one pixel and
// coalesce. atomicAdd makes the result NOT deterministic bit for bit: the
// float sums of overlapping rois happen in launch order, which varies from
// run to run (differences of a few ulps of the summed gradient).
__global__ void __launch_bounds__(THREADS)
roi_align_bwd_kernel(const float* __restrict__ grad_out,  // [N, R, out, out, C]
                     const float* __restrict__ rois,      // [N, R, 4] feature coords
                     int h, int w, int c, int r, int out, int s,
                     float* __restrict__ grad_feat) {     // [N, H, W, C], zeroed
  const int64_t bin_id = blockIdx.x;
  const int px = static_cast<int>(bin_id % out);
  const int py = static_cast<int>((bin_id / out) % out);
  const int64_t nr = bin_id / (static_cast<int64_t>(out) * out);
  const int n = static_cast<int>(nr / r);

  const float* roi = rois + nr * 4;
  const float r1 = roi[0], c1 = roi[1], r2 = roi[2], c2 = roi[3];
  const float inv_out = __fdiv_rn(1.f, static_cast<float>(out));
  const float bin_h = __fmul_rn(fmaxf(__fsub_rn(r2, r1), 1.f), inv_out);
  const float bin_w = __fmul_rn(fmaxf(__fsub_rn(c2, c1), 1.f), inv_out);

  float* img = grad_feat + static_cast<int64_t>(n) * h * w * c;
  const float* g_ptr = grad_out + bin_id * c;
  const float n_samples = static_cast<float>(s * s);

  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float g = __fdiv_rn(g_ptr[ch], n_samples);
    for (int iy = 0; iy < s; ++iy) {
      const Axis ay = sample_axis(r1, bin_h, py * s + iy, s, h);
      if (!ay.in_range) continue;
      for (int ix = 0; ix < s; ++ix) {
        const Axis ax = sample_axis(c1, bin_w, px * s + ix, s, w);
        if (!ax.in_range) continue;
        atomicAdd(&img[(static_cast<int64_t>(ay.i0) * w + ax.i0) * c + ch],
                  __fmul_rn(g, __fmul_rn(ay.w0, ax.w0)));
        atomicAdd(&img[(static_cast<int64_t>(ay.i0) * w + ax.i1) * c + ch],
                  __fmul_rn(g, __fmul_rn(ay.w0, ax.w1)));
        atomicAdd(&img[(static_cast<int64_t>(ay.i1) * w + ax.i0) * c + ch],
                  __fmul_rn(g, __fmul_rn(ay.w1, ax.w0)));
        atomicAdd(&img[(static_cast<int64_t>(ay.i1) * w + ax.i1) * c + ch],
                  __fmul_rn(g, __fmul_rn(ay.w1, ax.w1)));
      }
    }
  }
}

}  // namespace

extern "C" {

// Return the CUDA error of the launch (0 = cudaSuccess).
int roi_align_fwd_f32(const void* feat, const void* rois, int batch, int h, int w,
                      int c, int r, int out, int s, void* dst, void* stream) {
  return launch<float>(feat, rois, batch, h, w, c, r, out, s, dst, stream);
}

int roi_align_fwd_bf16(const void* feat, const void* rois, int batch, int h, int w,
                       int c, int r, int out, int s, void* dst, void* stream) {
  return launch<__nv_bfloat16>(feat, rois, batch, h, w, c, r, out, s, dst, stream);
}

// grad_feat must be [batch, h, w, c] float32; it is zeroed here, on the stream.
int roi_align_bwd_f32(const void* grad_out, const void* rois, int batch, int h, int w,
                      int c, int r, int out, int s, void* grad_feat, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t feat_bytes = sizeof(float) * static_cast<size_t>(batch) * h * w * c;
  cudaError_t err = cudaMemsetAsync(grad_feat, 0, feat_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t bins = static_cast<int64_t>(batch) * r * out * out;
  if (bins == 0) return 0;
  roi_align_bwd_kernel<<<static_cast<unsigned int>(bins), THREADS, 0, st>>>(
      static_cast<const float*>(grad_out), static_cast<const float*>(rois), h, w, c, r,
      out, s, static_cast<float*>(grad_feat));
  return static_cast<int>(cudaGetLastError());
}

const char* roi_align_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
