// ROIAlign forward and backward (aligned=False, bin mean) over NHWC features,
// and the FPN's multi-level ROIAlign forward and backward over P2..P5 (see
// the note above multilevel_roi_align_kernel).
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
//   * the s*s samples of a bin are averaged. Accumulation is float32; the
//     forward stores float32 (the JAX package's default einsum path, which
//     promotes bf16 features against f32 weights) or the caller's dtype
//     (bfloat16, as the Pallas kernel stores), rounding the finished float32
//     value once to nearest even, which is what a later .to(bfloat16) of the
//     float32 output gives.
//
// Forward, what bounds it on the H100: bytes, on paper. Device memory sees
// the feature map once (8 x 38x38x256 bf16 = 5.9 MB, which stays in L2) and
// the output once (8 x 300 x 7x7x256: 120 MB in float32, 60 MB in bfloat16):
// 0.038 / 0.020 ms. In practice it is bound by instructions: the bit-exact
// contract fixes 8 float32 operations per channel and sample (4 products, 3
// tap sums, 1 accumulation; no fused multiply-add), and bf16 features add a
// widening per tap. Measured on the H100 at b8, a float32 and a bfloat16
// output take the same time.
//
// Forward design: one block per (image, roi) [x a few bin splits when there
// are too few rois to fill the card]. A prologue computes the roi's out*s
// row and out*s column sample axes (taps, weights, range flag) once, into
// shared memory, with the same sample_axis arithmetic as the plain version;
// the correctly rounded divisions drop from several per output element to
// 2*out*s per roi, and the final division by s*s becomes the exact multiply
// by its reciprocal when s*s is a power of two. Each warp then takes one
// bin at a time and each lane 8 consecutive channels: one 16-byte load per
// tap in bf16 (two in f32) and 16-byte stores. Each lane still sums its own
// channels in the plain version's order. Where C is not a multiple of 8 or
// a base is not 16-byte aligned, a second instantiation of the same kernel
// takes single channels. No shared staging of the map: the gathers come
// from L2/L1. benchmarks/roi_align_variants.py times the alternatives on
// the card (a division by s*s, branch-free samples, 128-thread blocks,
// streaming stores); PERF.md has the numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FWD_THREADS = 256;
constexpr int MAX_SAMPLES = 224;  // out * s along one axis
constexpr int BWD_ROWS = 2;  // a backward block owns BWD_ROWS x BWD_COLS pixels,
constexpr int BWD_COLS = 4;  // a warp each (8 channels a lane)
constexpr int BWD_WARPS = BWD_ROWS * BWD_COLS;
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int BWD_MIN_BLOCKS = 4;  // blocks per SM: caps the registers at 64
constexpr int BWD_BIN_BUDGET = 448;  // rois per chunk x out: <= 32 KB of bins
constexpr int BWD_TERMS = 128;  // terms a warp buffers before it sums them

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 8 consecutive channels from a 16-byte aligned address, as float32
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

// One axis of the sampling grid: clamped tap pair, weights, in-range flag.
struct Axis {
  int i0, i1;
  float w0, w1;
  bool in_range;
};

// The sample at pts bins from start (pts = (k + 0.5) / s for sample k).
__device__ __forceinline__ Axis sample_at(float start, float bin, float pts, int extent) {
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

__device__ __forceinline__ Axis sample_axis(float start, float bin, int k, int s,
                                            int extent) {
  return sample_at(start, bin,
                   __fdiv_rn(__fadd_rn(static_cast<float>(k), 0.5f), static_cast<float>(s)),
                   extent);
}

// extent (1-pixel minimum) times the float32 reciprocal of the bin count; a
// NaN extent stays NaN (as torch.clamp and jnp.maximum keep it; fmaxf alone
// would turn it into 1 and sample a roi whose far corner is NaN)
__device__ __forceinline__ float bin_size(float lo, float hi, float inv_out) {
  const float extent = __fsub_rn(hi, lo);
  return __fmul_rn(extent != extent ? extent : fmaxf(extent, 1.f), inv_out);
}

// The four taps of one sample, weighted, in the plain version's order.
__device__ __forceinline__ float tap_sum(float f00, float f01, float f10, float f11,
                                         float w00, float w01, float w10, float w11) {
  float v = __fmul_rn(f00, w00);
  v = __fadd_rn(v, __fmul_rn(f01, w01));
  v = __fadd_rn(v, __fmul_rn(f10, w10));
  return __fadd_rn(v, __fmul_rn(f11, w11));
}

// VEC: C is a multiple of 8 and both bases are 16-byte aligned (a lane takes
// 8-channel vectors); otherwise a lane takes single channels.
template <typename T, typename O, bool VEC>
__global__ void __launch_bounds__(FWD_THREADS)
roi_align_kernel(const T* __restrict__ feat,       // [N, H, W, C]
                 const float* __restrict__ rois,   // [N, R, 4] feature coords
                 int h, int w, int c, int r, int out, int s,
                 O* __restrict__ dst) {            // [N, R, out, out, C]
  extern __shared__ Axis axes[];                   // [P] row samples, then [P] columns
  const int64_t nr = blockIdx.x;                   // n * R + roi
  const int n = static_cast<int>(nr / r);
  const int p_total = out * s;

  const float* roi = rois + nr * 4;
  const float r1 = roi[0], c1 = roi[1], r2 = roi[2], c2 = roi[3];
  const float inv_out = __fdiv_rn(1.f, static_cast<float>(out));
  const float bin_h = bin_size(r1, r2, inv_out);
  const float bin_w = bin_size(c1, c2, inv_out);
  for (int k = threadIdx.x; k < 2 * p_total; k += blockDim.x) {
    axes[k] = k < p_total ? sample_axis(r1, bin_h, k, s, h)
                          : sample_axis(c1, bin_w, k - p_total, s, w);
  }
  __syncthreads();

  const T* img = feat + static_cast<int64_t>(n) * h * w * c;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int bins = out * out;
  const int ns = s * s;
  const float n_samples = static_cast<float>(ns);
  // acc / (s*s) is exactly acc * (1 / (s*s)) when s*s is a power of two: both
  // round the same real number once
  const bool pow2 = (ns & (ns - 1)) == 0;
  const float inv_ns = __fdiv_rn(1.f, n_samples);
  // bins are dealt to warps round-robin over the blockIdx.y splits of the roi
  for (int b = blockIdx.y * warps + (threadIdx.x >> 5); b < bins; b += gridDim.y * warps) {
    const int py = b / out, px = b % out;
    O* o = dst + (nr * bins + b) * c;
    if (VEC) {
      for (int ch = lane * 8; ch < c; ch += 32 * 8) {
        float acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = 0.f;
        for (int iy = 0; iy < s; ++iy) {
          const Axis ay = axes[py * s + iy];
          const T* row0 = img + static_cast<int64_t>(ay.i0) * w * c + ch;
          const T* row1 = img + static_cast<int64_t>(ay.i1) * w * c + ch;
          for (int ix = 0; ix < s; ++ix) {
            const Axis ax = axes[p_total + px * s + ix];
            if (!(ay.in_range && ax.in_range)) {  // contributes +0, as in the plain version
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], 0.f);
              continue;
            }
            const float w00 = __fmul_rn(ay.w0, ax.w0), w01 = __fmul_rn(ay.w0, ax.w1);
            const float w10 = __fmul_rn(ay.w1, ax.w0), w11 = __fmul_rn(ay.w1, ax.w1);
            float f00[8], f01[8], f10[8], f11[8];
            load8(row0 + ax.i0 * c, f00);
            load8(row0 + ax.i1 * c, f01);
            load8(row1 + ax.i0 * c, f10);
            load8(row1 + ax.i1 * c, f11);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc[j] = __fadd_rn(acc[j], tap_sum(f00[j], f01[j], f10[j], f11[j],
                                                 w00, w01, w10, w11));
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j] = pow2 ? __fmul_rn(acc[j], inv_ns) : __fdiv_rn(acc[j], n_samples);
        }
        store8(o + ch, acc);
      }
    } else {
      for (int ch = lane; ch < c; ch += 32) {
        float acc = 0.f;
        for (int iy = 0; iy < s; ++iy) {
          const Axis ay = axes[py * s + iy];
          const T* row0 = img + static_cast<int64_t>(ay.i0) * w * c + ch;
          const T* row1 = img + static_cast<int64_t>(ay.i1) * w * c + ch;
          for (int ix = 0; ix < s; ++ix) {
            const Axis ax = axes[p_total + px * s + ix];
            if (!(ay.in_range && ax.in_range)) {
              acc = __fadd_rn(acc, 0.f);
              continue;
            }
            acc = __fadd_rn(acc, tap_sum(to_f32(row0[ax.i0 * c]), to_f32(row0[ax.i1 * c]),
                                         to_f32(row1[ax.i0 * c]), to_f32(row1[ax.i1 * c]),
                                         __fmul_rn(ay.w0, ax.w0), __fmul_rn(ay.w0, ax.w1),
                                         __fmul_rn(ay.w1, ax.w0), __fmul_rn(ay.w1, ax.w1)));
          }
        }
        store1(o + ch, pow2 ? __fmul_rn(acc, inv_ns) : __fdiv_rn(acc, n_samples));
      }
    }
  }
}

// Backward: grad_out [N, R, out, out, C] (float32 or bfloat16) through the
// same taps and weights as the forward into grad_feat [N, H, W, C], stored
// in the feature's dtype. Every rule of the forward is repeated by sharing
// sample_axis: the 1-pixel minimum extent, the float32 reciprocal of out,
// the [-1, extent] range test (a sample outside it contributes nothing) and
// the clamp, so at the border i1 == i0 and both taps land on one pixel. The
// plain version scatters (grad / (s*s)) * (wy * wx) per tap pair; this
// kernel groups those terms by bin, which the tent weights allow exactly in
// real arithmetic: a pixel receives from bin (py, px) the bin's gradient
// times ((sum of its row taps' wy on the pixel's row) * (sum of its column
// taps' wx on the pixel's column)) / (s*s), added with one fused
// multiply-add. The float32 roundings and the order of the sums differ from
// the plain version's index_add_, hence the tolerance.
//
// What bounds it on the H100: bytes. At the training shape (8 images, 128
// rois, 7x7, s=2, 256 channels) it must read grad_out once (51.4 MB in
// float32, 25.7 MB in bfloat16) and write grad_feat once (5.9 MB in bf16).
// In practice each bin's gradient is read by every block whose pixels it
// reaches, mostly from L2.
//
// Design: deterministic, no atomics. Owner computes: one block per (image,
// tile of BWD_ROWS x BWD_COLS pixels, 256 channels); a warp owns one pixel,
// each lane 8 channels summed in registers, so no two threads ever write
// one word. The block walks the image's rois in index order. A roi is kept
// when the bounding box of its taps (the taps of its first and last
// samples: they are monotone in the sample index) touches the tile; the
// kept list is compacted in order with ballots. For a chunk of kept rois, a
// warp per roi computes, a lane per bin row or column, the summed row
// weight of each bin row on each row of the tile and the summed column
// weight of each bin column on each column of the tile, and compacts the
// bins that have a tap there (a zero weight included), in order. Each warp
// then expands its pixel's (bin row, bin column) pairs, roi by roi, into a
// list of terms (grad_out offset, weight) in shared memory, a lane per term;
// only when the list is full, and at the end, does it walk the list in order
// with 16-byte gathers of 8 channels, eight in flight, so that the gathers
// of many rois overlap. The block
// writes each pixel once, in the feature's dtype: no memset, no atomics, no
// cast pass, and the same sums in the same order in every run.
//
// Earlier versions, slower on the card: owners of whole rows with
// shared-memory accumulators (one thread walked hundreds of dependent
// gathers); per-pixel owners with one term per tap pair (the grouping by
// bin cuts the gathers of 256 channels to one per pixel and bin); the
// vector path chosen by a runtime flag instead of a template parameter.
// benchmarks/roi_align_variants.py times the tile shape and the register
// cap against the committed source; PERF.md has the numbers.
struct Bin {
  float w;  // summed tap weight of the bin row (or column) on the pixel's row (column)
  int off;  // grad_out offset of the bin row (from the image's first roi) or column
};

struct Term {
  int off;  // grad_out offset of the bin, from the image's first roi
  float w;  // (row weight * column weight) / (s*s)
};

// 8 consecutive channels back from float32; vec: all 8 present and 16-byte
// aligned
template <typename T>
__device__ __forceinline__ void store8m(T* p, int nch, bool vec, const float (&v)[8]) {
  if (vec) {
    store8(p, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < nch) store1(p + i, v[i]);
  }
}

// Append the lanes whose flag is set to a list, in lane order; returns the
// list's new length (the same in every lane).
__device__ __forceinline__ int append_bin(Bin* list, int len, int lane, bool hit, Bin b) {
  const unsigned bits = __ballot_sync(0xffffffffu, hit);
  if (hit) list[len + __popc(bits & ((1u << lane) - 1u))] = b;
  return len + __popc(bits);
}

// Add the tap weights of one sample axis that land on pixel index t.
__device__ __forceinline__ void add_taps(const Axis& a, int t, float& wsum, bool& hit) {
  if (!a.in_range) return;
  if (a.i0 == t) {
    wsum = __fadd_rn(wsum, a.w0);
    hit = true;
  }
  if (a.i1 == t) {
    wsum = __fadd_rn(wsum, a.w1);
    hit = true;
  }
}

// Gather and sum a warp's (or the lanes in sync's) buffered terms in order,
// 8 channels a lane. The vector loop has no branch, so its unrolled gathers
// issue together.
template <bool VEC, typename G>
__device__ __forceinline__ void sum_terms(const Term* terms, int count, const G* g, int nch,
                                          float (&acc)[8], unsigned sync = 0xffffffffu) {
  if (VEC) {
    if (nch == 8) {  // else the lane is past the last channel tile's end
#pragma unroll 4
      for (int e = 0; e < count; ++e) {
        const Term term = terms[e];
        float v[8];
        load8(g + term.off, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = __fmaf_rn(v[i], term.w, acc[i]);
      }
    }
  } else {
    for (int e = 0; e < count; ++e) {
      const Term term = terms[e];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < nch) acc[i] = __fmaf_rn(to_f32(g[term.off + i]), term.w, acc[i]);
      }
    }
  }
  __syncwarp(sync);  // the buffer is rewritten next
}

// VEC: C is a multiple of 8 and both bases are 16-byte aligned (8-channel
// vectors); otherwise a lane reads and writes its channels one by one.
template <typename G, typename F, bool VEC>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
roi_align_bwd_kernel(const G* __restrict__ grad_out,  // [N, R, out, out, C]
                     const float* __restrict__ rois,  // [N, R, 4] feature coords
                     int h, int w, int c, int r, int out, int s, int tiles_y, int tiles_x,
                     int chunk, F* __restrict__ grad_feat) {  // [N, H, W, C]
  extern __shared__ __align__(16) unsigned char smem[];
  Term* terms = reinterpret_cast<Term*>(smem);               // [BWD_WARPS][BWD_TERMS]
  int* kept = reinterpret_cast<int*>(terms + BWD_WARPS * BWD_TERMS);  // [BWD_THREADS]
  int* warp_kept = kept + BWD_THREADS;                       // [BWD_WARPS] per-warp counts
  int* n_rows = warp_kept + BWD_WARPS;                       // [chunk][BWD_ROWS]
  int* n_cols = n_rows + chunk * BWD_ROWS;                   // [chunk][BWD_COLS]
  int* starts = n_cols + chunk * BWD_COLS;                   // [BWD_WARPS][chunk + 1]
  Bin* rows = reinterpret_cast<Bin*>(starts + BWD_WARPS * (chunk + 1));  // [chunk][BWD_ROWS][out]
  Bin* cols = rows + chunk * BWD_ROWS * out;                 // [chunk][BWD_COLS][out]

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int ty = warp / BWD_COLS, tx = warp % BWD_COLS;  // this warp's pixel in the tile
  int idx = blockIdx.x;
  const int x_lo = (idx % tiles_x) * BWD_COLS;
  idx /= tiles_x;
  const int y_lo = (idx % tiles_y) * BWD_ROWS;
  const int n = idx / tiles_y;
  const int x_hi = min(x_lo + BWD_COLS, w), y_hi = min(y_lo + BWD_ROWS, h);
  const int ch = blockIdx.y * 256 + 8 * lane;
  const int nch = max(0, min(8, c - ch));

  const int p_total = out * s;
  const float inv_out = __fdiv_rn(1.f, static_cast<float>(out));
  const float n_samples = static_cast<float>(s * s);
  const int bins = out * out;
  const float* img_rois = rois + static_cast<int64_t>(n) * r * 4;
  const G* g_img = grad_out + static_cast<int64_t>(n) * r * bins * c + ch;
  Term* my_terms = terms + warp * BWD_TERMS;
  int* my_starts = starts + warp * (chunk + 1);
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  int n_terms = 0;  // terms buffered in my_terms, summed when it is full and at the end

  for (int base = 0; base < r; base += BWD_THREADS) {
    bool keep = false;
    if (base + t < r) {
      const float* roi = img_rois + static_cast<int64_t>(base + t) * 4;
      const float r1 = roi[0], c1 = roi[1];
      const float bin_h = bin_size(r1, roi[2], inv_out);
      const float bin_w = bin_size(c1, roi[3], inv_out);
      keep = sample_axis(r1, bin_h, 0, s, h).i0 < y_hi &&
             sample_axis(r1, bin_h, p_total - 1, s, h).i1 >= y_lo &&
             sample_axis(c1, bin_w, 0, s, w).i0 < x_hi &&
             sample_axis(c1, bin_w, p_total - 1, s, w).i1 >= x_lo;
    }
    const unsigned kb = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(kb);
    __syncthreads();
    int offset = 0, n_kept = 0;
    for (int i = 0; i < BWD_WARPS; ++i) {
      offset += i < warp ? warp_kept[i] : 0;
      n_kept += warp_kept[i];
    }
    if (keep) kept[offset + __popc(kb & ((1u << lane) - 1u))] = base + t;

    for (int c0 = 0; c0 < n_kept; c0 += chunk) {
      const int m = min(chunk, n_kept - c0);
      __syncthreads();  // kept is written; the previous chunk's bins are no longer read
      for (int j = warp; j < m; j += BWD_WARPS) {  // a warp per roi, a lane per bin row/column
        const int roi_id = kept[c0 + j];
        const float* roi = img_rois + static_cast<int64_t>(roi_id) * 4;
        const float r1 = roi[0], c1 = roi[1];
        const float bin_h = bin_size(r1, roi[2], inv_out);
        const float bin_w = bin_size(c1, roi[3], inv_out);
        const int roi_off = roi_id * bins * c;
        int kr[BWD_ROWS], kc[BWD_COLS];
#pragma unroll
        for (int i = 0; i < BWD_ROWS; ++i) kr[i] = 0;
#pragma unroll
        for (int i = 0; i < BWD_COLS; ++i) kc[i] = 0;
        for (int b0 = 0; b0 < out; b0 += 32) {
          const int bi = b0 + lane;
          float wy[BWD_ROWS], wx[BWD_COLS];
          bool hy[BWD_ROWS], hx[BWD_COLS];
#pragma unroll
          for (int i = 0; i < BWD_ROWS; ++i) {
            wy[i] = 0.f;
            hy[i] = false;
          }
#pragma unroll
          for (int i = 0; i < BWD_COLS; ++i) {
            wx[i] = 0.f;
            hx[i] = false;
          }
          if (bi < out) {
            for (int k = 0; k < s; ++k) {  // the bin's samples in order, tap 0 before tap 1
              const Axis ar = sample_axis(r1, bin_h, bi * s + k, s, h);
              const Axis ac = sample_axis(c1, bin_w, bi * s + k, s, w);
#pragma unroll
              for (int i = 0; i < BWD_ROWS; ++i) add_taps(ar, y_lo + i, wy[i], hy[i]);
#pragma unroll
              for (int i = 0; i < BWD_COLS; ++i) add_taps(ac, x_lo + i, wx[i], hx[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < BWD_ROWS; ++i) {
            kr[i] = append_bin(rows + (j * BWD_ROWS + i) * out, kr[i], lane, hy[i],
                               Bin{wy[i], roi_off + bi * out * c});
          }
#pragma unroll
          for (int i = 0; i < BWD_COLS; ++i) {
            kc[i] = append_bin(cols + (j * BWD_COLS + i) * out, kc[i], lane, hx[i],
                               Bin{wx[i], bi * c});
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < BWD_ROWS; ++i) n_rows[j * BWD_ROWS + i] = kr[i];
#pragma unroll
          for (int i = 0; i < BWD_COLS; ++i) n_cols[j * BWD_COLS + i] = kc[i];
        }
      }
      __syncthreads();

      // this warp's pixel: the terms of the chunk's rois start at my_starts[j]
      if (lane == 0) {
        int sum = 0;
        for (int j = 0; j < m; ++j) {
          my_starts[j] = sum;
          sum += n_rows[j * BWD_ROWS + ty] * n_cols[j * BWD_COLS + tx];
        }
        my_starts[m] = sum;
      }
      __syncwarp();
      const int total = my_starts[m];
      for (int e0 = 0; e0 < total;) {
        if (n_terms == BWD_TERMS) {
          sum_terms<VEC>(my_terms, n_terms, g_img, nch, acc);
          n_terms = 0;
        }
        const int take = min(BWD_TERMS - n_terms, total - e0);
        for (int e = e0 + lane; e < e0 + take; e += 32) {  // expand: a lane per term
          int j = 0;
          while (e >= my_starts[j + 1]) ++j;
          const int local = e - my_starts[j];
          const int nc = n_cols[j * BWD_COLS + tx];
          const int k = local / nc, q = local - k * nc;
          const Bin br = rows[(j * BWD_ROWS + ty) * out + k];
          const Bin bc = cols[(j * BWD_COLS + tx) * out + q];
          my_terms[n_terms + e - e0] = Term{br.off + bc.off,
                                            __fdiv_rn(__fmul_rn(br.w, bc.w), n_samples)};
        }
        __syncwarp();
        n_terms += take;
        e0 += take;
      }
    }
    __syncthreads();  // kept and the bins are rewritten by the next block of rois
  }
  sum_terms<VEC>(my_terms, n_terms, g_img, nch, acc);
  const int y = y_lo + ty, x = x_lo + tx;
  if (y < y_hi && x < x_hi && nch > 0) {
    store8m(grad_feat + ((static_cast<int64_t>(n) * h + y) * w + x) * c + ch, nch, VEC, acc);
  }
}

// ---------------------------------------------------------------------------
// Multi-level ROIAlign (FPN): the rois of an image are each assigned one of
// the four pyramid levels P2..P5 and aligned on that level alone.
//
// Replaces no Pallas kernel: the JAX package runs it as XLA gathers
// (replication_faster_rcnn_tpu/models/fpn.py::multilevel_roi_align, the
// default method="flat", and its autodiff VJP), on the FPN preset's hot
// path in both directions. Plain version:
// replication_faster_rcnn_tpu_torch/models/fpn.py::multilevel_roi_align_plain,
// which the forward matches bit for bit, and its autograd VJP.
//
// The level of each roi comes in as an int32 array computed by the plain
// models/fpn.py::roi_levels on the card (floor(4 + log2(sqrt(area)/224)),
// clipped): a level that differed at a boundary area would be a large
// error, so the kernels and the plain version read the same levels instead
// of rounding log2 each their own way.
//
// Geometry (method="flat"): the roi is scaled into its level by
// (h_l / img_h, w_l / img_w) (correctly rounded divisions), the bin is the
// 1-pixel-minimum extent divided by out (a division, not the reciprocal
// multiply of the single-level kernel), samples sit at r1 + ((k + 0.5)/s) *
// bin, and the border rule is sample_axis's. Each sample's 4-tap sum is
// multiplied by its range flag (1 or 0, as the plain version multiplies by
// the float mask) and the s*s samples are summed in row-major order from
// 0, then divided by s*s.
//
// Forward, what bounds it on the H100: bytes on paper. At serving b8 x 300
// rois the output is 8 x 300 x 7x7x256 (60 MB in bf16) and the level pixels
// the samples touch, each read once, about as much again (P2 alone is 92 MB
// in bf16 at b8 and does not stay in L2): 0.036 ms. In practice it is bound
// by the latency of its gathers: a roi's 14 sample columns lie 1-2 pixels
// apart on its level, so most pixels are taps of two samples along each
// axis (L1 serves the second read), and a loop over a runtime s waits on
// each sample's four taps before it issues the next. Design: a block per
// roi and bin split, the roi's sample axes in shared memory, a warp per bin,
// 8 channels a lane; s = 2 (every preset) is a template constant, so the
// sample loops unroll and a lane's 16 tap loads for a bin are in flight
// together, and the register cap leaves room for three blocks an SM in
// bfloat16. Other s, C not a multiple of 8 and unaligned bases take the
// same kernel with s as given. A staged design (each bin row's distinct tap
// rows and columns copied into a cp.async ring in shared memory, a block per
// roi and 32 channels) measured slower: tools/roi_multilevel_staged.cu,
// PERF.md.
//
// Backward, what bounds it: bytes on paper (grad_out read once, the four
// levels' gradients written once: 0.044 ms at the training shape, most of
// it P2's 92 MB of gradient, about half of it zeros), in practice the
// latency of each pass below: a mask word and a box, the bins, the terms'
// gathers, with block barriers between. Design: deterministic, no atomics
// on the gradient, every pixel written once by its owner. A prologue kernel
// computes each roi's level, its geometry on that level and the box of its
// taps once (RoiGeom), and sets the roi's bit in the mask of every tile of
// ML_TILE_Y x ML_TILE_X pixels of its level that the box touches (atomicOr
// into zeroed words: the same bits in every run). The main kernel has a
// block per (level, image, tile, ML_CT channels), the coarsest level's
// tiles first (they hold the most rois, and would otherwise make the last
// wave); no block scans its image's rois or recomputes their geometry. A
// block whose mask is empty stores zeros over its tile and exits; any other
// walks its tile in passes of ML_PASS_ROWS x ML_PASS_COLS pixels
// (ML_PIX_LANES lanes a pixel, 8 channels a lane), each pass keeping, in
// ascending roi id, the masked rois whose box reaches it, and builds and
// sums their bins' terms as roi_align_bwd_kernel does (see there), a group
// of lanes per roi in the bin step. So a pixel receives its terms in one
// fixed order (roi id, bin row, bin column; each term (wy * wx) / (s*s),
// summed with fused multiply-adds) and gets the same bits at any tile size
// as a walk over all rois would. Larger tiles serialise
// more passes in a block and were slower where many rois crowd a few
// tiles, half-warp pixels spilled more; tools/roi_multilevel_variants.py
// times the choices against the first design. P6 gets no gradient here
// (only the RPN reads it).

constexpr int LEVELS = 4;
constexpr int ML_CT = 256;  // channels of a backward block, 8 a lane
constexpr int ML_PIX_LANES = ML_CT / 8;            // lanes of a pixel
constexpr int ML_PPW = 32 / ML_PIX_LANES;          // pixels of a warp
constexpr int ML_PASS_PIXELS = BWD_WARPS * ML_PPW;  // a pass: ML_PASS_ROWS x ML_PASS_COLS
constexpr int ML_PASS_ROWS = 2;
constexpr int ML_PASS_COLS = ML_PASS_PIXELS / ML_PASS_ROWS;
constexpr int ML_TILE_Y = 4;  // a backward block owns ML_TILE_Y x ML_TILE_X pixels of
constexpr int ML_TILE_X = 8;  // a level, in passes
constexpr int ML_PASSES = (ML_TILE_Y / ML_PASS_ROWS) * (ML_TILE_X / ML_PASS_COLS);
constexpr int ML_GEOM_THREADS = 256;
constexpr int ML_BWD_MIN_BLOCKS = 3;  // backward blocks per SM: caps the registers at 80
constexpr int ML_BIN_BUDGET = 256;    // rois per chunk x out: <= 20 KB of bins
constexpr bool ML_COARSE_FIRST = true;  // backward: P5's tiles first (they hold the most rois)
constexpr int ML_FWD_THREADS = 256;   // direct forward: a warp per bin
constexpr int ML_FWD_MIN_BLOCKS = 3;  // direct forward blocks per SM (float32 taps: 2)
static_assert(ML_PIX_LANES == 16 || ML_PIX_LANES == 32, "a pixel is a warp or half of one");
static_assert(ML_TILE_Y % ML_PASS_ROWS == 0 && ML_TILE_X % ML_PASS_COLS == 0,
              "a tile is whole passes");

template <typename T>
struct Pyramid {
  T* base[LEVELS];
  int h[LEVELS], w[LEVELS];
  int tiles_y[LEVELS], tiles_x[LEVELS];
  int first_block[LEVELS], end_block[LEVELS];  // backward: the level's tiles (blocks)
};

// The roi in its level's units: start corners and bin sizes.
struct LevelRoi {
  float r1, c1, bin_h, bin_w;
};

// What the backward's prologue computes once per roi.
struct RoiGeom {
  LevelRoi lr;
  int level;               // 0..3
  unsigned short y0, y1;   // the box of its taps on that level: rows [y0, y1],
  unsigned short x0, x1;   // columns [x0, x1]
  int pad;
};
static_assert(sizeof(RoiGeom) == 32, "8 words per roi");

// extent (1-pixel minimum; a NaN extent stays NaN) divided by the bin count
__device__ __forceinline__ float bin_div(float lo, float hi, int out) {
  const float extent = __fsub_rn(hi, lo);
  return __fdiv_rn(extent != extent ? extent : fmaxf(extent, 1.f), static_cast<float>(out));
}

__device__ __forceinline__ LevelRoi level_roi(const float* roi, int h, int w, float img_h,
                                              float img_w, int out) {
  const float sr = __fdiv_rn(static_cast<float>(h), img_h);
  const float sc = __fdiv_rn(static_cast<float>(w), img_w);
  const float r1 = __fmul_rn(roi[0], sr), c1 = __fmul_rn(roi[1], sc);
  const float r2 = __fmul_rn(roi[2], sr), c2 = __fmul_rn(roi[3], sc);
  return LevelRoi{r1, c1, bin_div(r1, r2, out), bin_div(c1, c2, out)};
}

__device__ __forceinline__ int roi_level(const int* levels, int64_t i) {
  return min(max(levels[i], 0), LEVELS - 1);
}

// One level of a pyramid. Selected with constant indices: indexing the
// kernel parameter with a runtime level would copy it to local memory.
template <typename T>
struct Level {
  T* base;
  int h, w, tiles_y, tiles_x, first_block;
};

template <typename T>
__device__ __forceinline__ Level<T> pick_level(const Pyramid<T>& pyr, int lv) {
  Level<T> l{pyr.base[0], pyr.h[0], pyr.w[0], pyr.tiles_y[0], pyr.tiles_x[0],
             pyr.first_block[0]};
#pragma unroll
  for (int i = 1; i < LEVELS; ++i) {
    if (lv == i) {
      l = Level<T>{pyr.base[i], pyr.h[i], pyr.w[i], pyr.tiles_y[i], pyr.tiles_x[i],
                   pyr.first_block[i]};
    }
  }
  return l;
}

// (k + 0.5) / s: the product by 1/s when s is a power of two (the same
// correctly rounded value), else the division.
__device__ __forceinline__ float ml_pts(int k, int s, float inv_s, bool pow2) {
  const float num = __fadd_rn(static_cast<float>(k), 0.5f);
  return pow2 ? __fmul_rn(num, inv_s) : __fdiv_rn(num, static_cast<float>(s));
}

// Append the lanes of one group (bits set in group) whose flag is set to a
// list, in lane order; returns the list's new length (the same in every
// lane of the group).
__device__ __forceinline__ int append_bin_group(Bin* list, int len, int lane, unsigned group,
                                                bool hit, Bin b) {
  const unsigned bits = __ballot_sync(0xffffffffu, hit) & group;
  if (hit) list[len + __popc(bits & ((1u << lane) - 1u))] = b;
  return len + __popc(bits);
}

// The sample loops of one bin: 8 channels from 16-byte aligned taps (VEC)
// or one channel, in the plain version's order.
template <typename T, int S, bool VEC>
__device__ __forceinline__ void ml_bin(const T* img, const Axis* axes, int p_total, int w, int c,
                                       int s, int py, int px, int ch, float (&acc)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
  for (int iy = 0; iy < (S > 0 ? S : s); ++iy) {
    const Axis ay = axes[py * (S > 0 ? S : s) + iy];
    const T* row0 = img + static_cast<int64_t>(ay.i0) * w * c + ch;
    const T* row1 = img + static_cast<int64_t>(ay.i1) * w * c + ch;
#pragma unroll
    for (int ix = 0; ix < (S > 0 ? S : s); ++ix) {
      const Axis ax = axes[p_total + px * (S > 0 ? S : s) + ix];
      const float flag = (ay.in_range && ax.in_range) ? 1.f : 0.f;
      const float w00 = __fmul_rn(ay.w0, ax.w0), w01 = __fmul_rn(ay.w0, ax.w1);
      const float w10 = __fmul_rn(ay.w1, ax.w0), w11 = __fmul_rn(ay.w1, ax.w1);
      if (VEC) {
        float f00[8], f01[8], f10[8], f11[8];
        load8(row0 + ax.i0 * c, f00);
        load8(row0 + ax.i1 * c, f01);
        load8(row1 + ax.i0 * c, f10);
        load8(row1 + ax.i1 * c, f11);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = tap_sum(f00[j], f01[j], f10[j], f11[j], w00, w01, w10, w11);
          acc[j] = __fadd_rn(acc[j], __fmul_rn(v, flag));
        }
      } else {
        const float v = tap_sum(to_f32(row0[ax.i0 * c]), to_f32(row0[ax.i1 * c]),
                                to_f32(row1[ax.i0 * c]), to_f32(row1[ax.i1 * c]),
                                w00, w01, w10, w11);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(v, flag));
      }
    }
  }
}

// The direct forward. VEC: C is a multiple of 8 and every base is 16-byte
// aligned. S > 0: s is the constant S (the sample loops unroll); S = 0: s
// as given.
template <typename T, typename O, bool VEC, int S>
__global__ void __launch_bounds__(ML_FWD_THREADS,
                                  sizeof(T) == 2 ? ML_FWD_MIN_BLOCKS : ML_FWD_MIN_BLOCKS - 1)
multilevel_roi_align_kernel(Pyramid<const T> pyr,           // P2..P5 [N, Hl, Wl, C]
                            const float* __restrict__ rois,  // [N, R, 4] image coords
                            const int* __restrict__ levels,  // [N, R] 0..3
                            float img_h, float img_w, int c, int r, int out, int s_arg,
                            O* __restrict__ dst) {           // [N, R, out, out, C]
  extern __shared__ Axis axes[];                            // [P] row samples, then [P] columns
  const int s = S > 0 ? S : s_arg;
  const int64_t nr = blockIdx.x;                            // n * R + roi
  const int n = static_cast<int>(nr / r);
  const int p_total = out * s;
  const Level<const T> level = pick_level(pyr, roi_level(levels, nr));
  const int h = level.h, w = level.w;
  const LevelRoi lr = level_roi(rois + nr * 4, h, w, img_h, img_w, out);
  for (int k = threadIdx.x; k < 2 * p_total; k += blockDim.x) {
    axes[k] = k < p_total ? sample_axis(lr.r1, lr.bin_h, k, s, h)
                          : sample_axis(lr.c1, lr.bin_w, k - p_total, s, w);
  }
  __syncthreads();

  const T* img = level.base + static_cast<int64_t>(n) * h * w * c;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int bins = out * out;
  const int ns = s * s;
  const float n_samples = static_cast<float>(ns);
  const bool pow2 = (ns & (ns - 1)) == 0;  // then acc * (1/ns) == acc / ns
  const float inv_ns = __fdiv_rn(1.f, n_samples);
  for (int b = blockIdx.y * warps + (threadIdx.x >> 5); b < bins; b += gridDim.y * warps) {
    const int py = b / out, px = b % out;
    O* o = dst + (nr * bins + b) * c;
    for (int ch = lane * (VEC ? 8 : 1); ch < c; ch += 32 * (VEC ? 8 : 1)) {
      float acc[8];
      ml_bin<T, S, VEC>(img, axes, p_total, w, c, s, py, px, ch, acc);
      if (VEC) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j] = pow2 ? __fmul_rn(acc[j], inv_ns) : __fdiv_rn(acc[j], n_samples);
        }
        store8(o + ch, acc);
      } else {
        store1(o + ch, pow2 ? __fmul_rn(acc[0], inv_ns) : __fdiv_rn(acc[0], n_samples));
      }
    }
  }
}

// Backward prologue: a thread per (image, roi). The roi's level, its
// geometry there and the box of its taps (the first sample's i0 and the
// last sample's i1 on each axis: taps are monotone in the sample index),
// and its bit in the mask of every tile of its level that the box touches.
template <typename F>
__global__ void __launch_bounds__(ML_GEOM_THREADS)
multilevel_roi_geometry_kernel(const float* __restrict__ rois,  // [N, R, 4] image coords
                               const int* __restrict__ levels,  // [N, R] 0..3
                               Pyramid<F> pyr, float img_h, float img_w, int n_rois, int r,
                               int out, int s, int words,
                               RoiGeom* __restrict__ geom,        // [N, R]
                               unsigned* __restrict__ masks) {    // [tiles][words], zeroed
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rois) return;
  const int n = i / r, j = i - n * r;
  const int lv = roi_level(levels, i);
  const Level<F> level = pick_level(pyr, lv);
  const int h = level.h, w = level.w;
  const int p_total = out * s;
  const LevelRoi lr = level_roi(rois + static_cast<int64_t>(i) * 4, h, w, img_h, img_w, out);
  const int y0 = sample_axis(lr.r1, lr.bin_h, 0, s, h).i0;
  const int y1 = sample_axis(lr.r1, lr.bin_h, p_total - 1, s, h).i1;
  const int x0 = sample_axis(lr.c1, lr.bin_w, 0, s, w).i0;
  const int x1 = sample_axis(lr.c1, lr.bin_w, p_total - 1, s, w).i1;
  RoiGeom g;
  g.lr = lr;
  g.level = lv;
  g.y0 = static_cast<unsigned short>(y0);
  g.y1 = static_cast<unsigned short>(y1);
  g.x0 = static_cast<unsigned short>(x0);
  g.x1 = static_cast<unsigned short>(x1);
  g.pad = 0;
  geom[i] = g;
  const int tiles_x = level.tiles_x;
  unsigned* m = masks + (static_cast<int64_t>(level.first_block) +
                         static_cast<int64_t>(n) * level.tiles_y * tiles_x) * words + (j >> 5);
  for (int ty = y0 / ML_TILE_Y; ty <= y1 / ML_TILE_Y; ++ty) {
    for (int tx = x0 / ML_TILE_X; tx <= x1 / ML_TILE_X; ++tx) {
      atomicOr(m + (static_cast<int64_t>(ty) * tiles_x + tx) * words, 1u << (j & 31));
    }
  }
}

// The backward of the forward kernels (see the note above):
// roi_align_bwd_kernel's passes and sums over each tile's masked rois, with
// ML_PIX_LANES lanes a pixel (a pass is ML_PASS_PIXELS pixels) and a group
// of lanes per roi in the bin step, so that a chunk holds up to 32 rois at
// out = 7.
template <typename G, typename F, bool VEC>
__global__ void __launch_bounds__(BWD_THREADS, ML_BWD_MIN_BLOCKS)
multilevel_roi_align_bwd_kernel(const G* __restrict__ grad_out,     // [N, R, out, out, C]
                                const RoiGeom* __restrict__ geom,    // [N, R]
                                const unsigned* __restrict__ masks,  // [tiles][words]
                                Pyramid<F> pyr,                      // grad P2..P5 [N, Hl, Wl, C]
                                int c, int r, int out, int s, int words, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  Term* terms = reinterpret_cast<Term*>(smem);               // [ML_PASS_PIXELS][BWD_TERMS]
  int* kept = reinterpret_cast<int*>(terms + ML_PASS_PIXELS * BWD_TERMS);  // [BWD_THREADS]
  int* warp_kept = kept + BWD_THREADS;                       // [BWD_WARPS] per-warp counts
  int* n_rows = warp_kept + BWD_WARPS;                       // [chunk][ML_PASS_ROWS]
  int* n_cols = n_rows + chunk * ML_PASS_ROWS;               // [chunk][ML_PASS_COLS]
  int* starts = n_cols + chunk * ML_PASS_COLS;               // [ML_PASS_PIXELS][chunk + 1]
  Bin* rows = reinterpret_cast<Bin*>(starts + ML_PASS_PIXELS * (chunk + 1));
  Bin* cols = rows + chunk * ML_PASS_ROWS * out;             // rows [chunk][ML_PASS_ROWS][out],
                                                             // cols [chunk][ML_PASS_COLS][out]
  int lv = 0;
#pragma unroll
  for (int l = 1; l < LEVELS; ++l) {
    const int b = static_cast<int>(blockIdx.x);
    if (b >= pyr.first_block[l] && b < pyr.end_block[l]) lv = l;
  }
  const Level<F> level = pick_level(pyr, lv);
  const int h = level.h, w = level.w;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int pix = warp * ML_PPW + lane / ML_PIX_LANES;  // this lane's pixel in a pass
  const int ty = pix / ML_PASS_COLS, tx = pix % ML_PASS_COLS;
  const int pl = lane % ML_PIX_LANES;  // the lane within its pixel
  const unsigned pmask = (ML_PIX_LANES == 32 ? 0xffffffffu : (1u << ML_PIX_LANES) - 1u)
                         << (lane / ML_PIX_LANES * ML_PIX_LANES);
  int idx = static_cast<int>(blockIdx.x) - level.first_block;
  const int tile_x = (idx % level.tiles_x) * ML_TILE_X;
  idx /= level.tiles_x;
  const int tile_y = (idx % level.tiles_y) * ML_TILE_Y;
  const int n = idx / level.tiles_y;
  const int ch = blockIdx.y * ML_CT + 8 * pl;
  const int nch = max(0, min(8, c - ch));
  F* img = level.base + static_cast<int64_t>(n) * h * w * c + ch;
  float acc[8];

  const unsigned* mask = masks + static_cast<int64_t>(blockIdx.x) * words;
  bool any = false;
  for (int i = t; i < words; i += BWD_THREADS) any = any || mask[i] != 0u;
  if (!__syncthreads_or(any)) {  // no roi reaches the tile
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int p = pix; p < ML_TILE_Y * ML_TILE_X; p += ML_PASS_PIXELS) {
      const int y = tile_y + p / ML_TILE_X, x = tile_x + p % ML_TILE_X;
      if (y < h && x < w && nch > 0) {
        store8m(img + (static_cast<int64_t>(y) * w + x) * c, nch, VEC, acc);
      }
    }
    return;
  }

  const int ns = s * s;
  const float n_samples = static_cast<float>(ns);
  const bool pow2 = (ns & (ns - 1)) == 0;  // then x / (s*s) == x * (1 / (s*s)), and
  const float inv_ns = __fdiv_rn(1.f, n_samples);  // (k + 0.5) / s == (k + 0.5) * (1 / s)
  const float inv_s = __fdiv_rn(1.f, static_cast<float>(s));
  const int bins = out * out;
  // a group of glanes lanes per roi (the power of two >= out, at most 32)
  const int glanes = min(32, 1 << (32 - __clz(max(out - 1, 0))));
  const int per_warp = 32 / glanes;
  const int group = lane / glanes, gl = lane % glanes;
  const unsigned gmask = (glanes == 32 ? 0xffffffffu : (1u << glanes) - 1u) << (group * glanes);
  const RoiGeom* img_geom = geom + static_cast<int64_t>(n) * r;
  const G* g_img = grad_out + static_cast<int64_t>(n) * r * bins * c + ch;
  Term* my_terms = terms + pix * BWD_TERMS;
  int* my_starts = starts + pix * (chunk + 1);

  for (int pass = 0; pass < ML_PASSES; ++pass) {
    const int y_lo = tile_y + (pass / (ML_TILE_X / ML_PASS_COLS)) * ML_PASS_ROWS;
    const int x_lo = tile_x + (pass % (ML_TILE_X / ML_PASS_COLS)) * ML_PASS_COLS;
    if (y_lo >= h || x_lo >= w) continue;  // the same in every thread
    const int x_hi = min(x_lo + ML_PASS_COLS, w), y_hi = min(y_lo + ML_PASS_ROWS, h);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    int n_terms = 0;  // terms buffered in my_terms, summed when it is full and at the end

    for (int base = 0; base < r; base += BWD_THREADS) {
      const int roi = base + t;
      bool keep = false;
      if (roi < r) {  // the mask word and the box are loaded together
        const unsigned word = mask[roi >> 5];
        const RoiGeom gm = img_geom[roi];
        keep = ((word >> (roi & 31)) & 1u) && gm.y0 < y_hi && gm.y1 >= y_lo && gm.x0 < x_hi &&
               gm.x1 >= x_lo;
      }
      const unsigned kb = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) warp_kept[warp] = __popc(kb);
      __syncthreads();
      int offset = 0, n_kept = 0;
      for (int i = 0; i < BWD_WARPS; ++i) {
        offset += i < warp ? warp_kept[i] : 0;
        n_kept += warp_kept[i];
      }
      if (keep) kept[offset + __popc(kb & ((1u << lane) - 1u))] = roi;

      for (int c0 = 0; c0 < n_kept; c0 += chunk) {
        const int m = min(chunk, n_kept - c0);
        __syncthreads();  // kept is written; the previous chunk's bins are no longer read
        // a group per roi, a lane per bin row/column
        for (int j0 = warp * per_warp; j0 < m; j0 += BWD_WARPS * per_warp) {
          const int j = j0 + group;
          const bool live = j < m;
          const int roi_id = live ? kept[c0 + j] : 0;
          const LevelRoi lr = img_geom[roi_id].lr;
          const int roi_off = roi_id * bins * c;
          int kr[ML_PASS_ROWS], kc[ML_PASS_COLS];
#pragma unroll
          for (int i = 0; i < ML_PASS_ROWS; ++i) kr[i] = 0;
#pragma unroll
          for (int i = 0; i < ML_PASS_COLS; ++i) kc[i] = 0;
          for (int b0 = 0; b0 < out; b0 += glanes) {
            const int bi = b0 + gl;
            float wy[ML_PASS_ROWS], wx[ML_PASS_COLS];
            bool hy[ML_PASS_ROWS], hx[ML_PASS_COLS];
#pragma unroll
            for (int i = 0; i < ML_PASS_ROWS; ++i) {
              wy[i] = 0.f;
              hy[i] = false;
            }
#pragma unroll
            for (int i = 0; i < ML_PASS_COLS; ++i) {
              wx[i] = 0.f;
              hx[i] = false;
            }
            if (live && bi < out) {
              for (int k = 0; k < s; ++k) {  // the bin's samples in order, tap 0 before tap 1
                const float pts = ml_pts(bi * s + k, s, inv_s, pow2);
                const Axis ar = sample_at(lr.r1, lr.bin_h, pts, h);
                const Axis ac = sample_at(lr.c1, lr.bin_w, pts, w);
#pragma unroll
                for (int i = 0; i < ML_PASS_ROWS; ++i) add_taps(ar, y_lo + i, wy[i], hy[i]);
#pragma unroll
                for (int i = 0; i < ML_PASS_COLS; ++i) add_taps(ac, x_lo + i, wx[i], hx[i]);
              }
            }
#pragma unroll
            for (int i = 0; i < ML_PASS_ROWS; ++i) {
              kr[i] = append_bin_group(rows + (j * ML_PASS_ROWS + i) * out, kr[i], lane, gmask,
                                       hy[i], Bin{wy[i], roi_off + bi * out * c});
            }
#pragma unroll
            for (int i = 0; i < ML_PASS_COLS; ++i) {
              kc[i] = append_bin_group(cols + (j * ML_PASS_COLS + i) * out, kc[i], lane, gmask,
                                       hx[i], Bin{wx[i], bi * c});
            }
          }
          if (live && gl == 0) {
#pragma unroll
            for (int i = 0; i < ML_PASS_ROWS; ++i) n_rows[j * ML_PASS_ROWS + i] = kr[i];
#pragma unroll
            for (int i = 0; i < ML_PASS_COLS; ++i) n_cols[j * ML_PASS_COLS + i] = kc[i];
          }
        }
        __syncthreads();

        // this lane's pixel: the terms of the chunk's rois start at my_starts[j]
        if (pl == 0) {
          int sum = 0;
          for (int j = 0; j < m; ++j) {
            my_starts[j] = sum;
            sum += n_rows[j * ML_PASS_ROWS + ty] * n_cols[j * ML_PASS_COLS + tx];
          }
          my_starts[m] = sum;
        }
        __syncwarp();
        const int total = my_starts[m];  // the pixels of a warp may differ from here on
        for (int e0 = 0; e0 < total;) {
          if (n_terms == BWD_TERMS) {
            sum_terms<VEC>(my_terms, n_terms, g_img, nch, acc, pmask);
            n_terms = 0;
          }
          const int take = min(BWD_TERMS - n_terms, total - e0);
          for (int e = e0 + pl; e < e0 + take; e += ML_PIX_LANES) {  // expand: a lane per term
            int j = 0;
            while (e >= my_starts[j + 1]) ++j;
            const int local = e - my_starts[j];
            const int nc = n_cols[j * ML_PASS_COLS + tx];
            const int k = local / nc, q = local - k * nc;
            const Bin br = rows[(j * ML_PASS_ROWS + ty) * out + k];
            const Bin bc = cols[(j * ML_PASS_COLS + tx) * out + q];
            const float prod = __fmul_rn(br.w, bc.w);
            my_terms[n_terms + e - e0] =
                Term{br.off + bc.off, pow2 ? __fmul_rn(prod, inv_ns) : __fdiv_rn(prod, n_samples)};
          }
          __syncwarp(pmask);
          n_terms += take;
          e0 += take;
        }
      }
      __syncthreads();  // kept and the bins are rewritten by the next block of rois
    }
    sum_terms<VEC>(my_terms, n_terms, g_img, nch, acc, pmask);
    const int y = y_lo + ty, x = x_lo + tx;
    if (y < y_hi && x < x_hi && nch > 0) {
      store8m(img + (static_cast<int64_t>(y) * w + x) * c, nch, VEC, acc);
    }
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

template <typename T, typename O>
int launch_fwd(const void* feat, const void* rois, int batch, int h, int w, int c, int r,
               int out, int s, void* dst, int splits, cudaStream_t stream) {
  const int64_t n_rois = static_cast<int64_t>(batch) * r;
  if (n_rois == 0 || c == 0) return 0;
  const int p_total = out * s;
  if (p_total > MAX_SAMPLES) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = FWD_THREADS / 32;
  const int max_splits = ceil_div(static_cast<int64_t>(out) * out, warps);
  if (splits <= 0) {  // enough blocks for two full waves of 256-thread blocks
    splits = ceil_div(2LL * sm_count() * (2048 / FWD_THREADS), n_rois);
  }
  splits = max(1, min(splits, max_splits));
  const dim3 grid(static_cast<unsigned int>(n_rois), static_cast<unsigned int>(splits));
  auto kernel = c % 8 == 0 && aligned(feat, 16) && aligned(dst, 16) ? roi_align_kernel<T, O, true>
                                                                    : roi_align_kernel<T, O, false>;
  kernel<<<grid, FWD_THREADS, 2 * p_total * sizeof(Axis), stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois), h, w, c, r, out, s,
      static_cast<O*>(dst));
  return static_cast<int>(cudaGetLastError());
}

template <typename G, typename F>
int launch_bwd(const void* grad_out, const void* rois, int batch, int h, int w, int c, int r,
               int out, int s, void* grad_feat, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(batch) * h;
  if (rows == 0 || w == 0 || c == 0) return 0;
  const int p_total = out * s;
  if (p_total > MAX_SAMPLES) return static_cast<int>(cudaErrorInvalidValue);
  // term offsets are 32-bit: one image's grad_out must index with an int
  if (static_cast<int64_t>(r) * out * out * c > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunk = max(1, min(BWD_WARPS, BWD_BIN_BUDGET / out));
  const int tiles_y = ceil_div(h, BWD_ROWS), tiles_x = ceil_div(w, BWD_COLS);
  const int ctiles = ceil_div(c, 256);
  const size_t smem = BWD_WARPS * BWD_TERMS * sizeof(Term) +
                      (BWD_THREADS + BWD_WARPS + chunk * (BWD_ROWS + BWD_COLS) +
                       BWD_WARPS * (chunk + 1)) * sizeof(int) +
                      static_cast<size_t>(chunk) * (BWD_ROWS + BWD_COLS) * out * sizeof(Bin);
  const dim3 grid(static_cast<unsigned int>(batch * tiles_y * tiles_x),
                  static_cast<unsigned int>(ctiles));
  auto kernel = c % 8 == 0 && aligned(grad_out, 16) && aligned(grad_feat, 16)
                    ? roi_align_bwd_kernel<G, F, true>
                    : roi_align_bwd_kernel<G, F, false>;
  kernel<<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const G*>(grad_out), static_cast<const float*>(rois), h, w, c, r, out, s,
      tiles_y, tiles_x, chunk, static_cast<F*>(grad_feat));
  return static_cast<int>(cudaGetLastError());
}

// The four levels' bases and extents from the host arrays; false if an
// extent is not positive.
template <typename T>
bool make_pyramid(Pyramid<T>& pyr, void* const* bases, const int* hs, const int* ws) {
  for (int l = 0; l < LEVELS; ++l) {
    if (hs[l] <= 0 || ws[l] <= 0) return false;
    pyr.base[l] = static_cast<T*>(bases[l]);
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
  }
  return true;
}

// The backward's tiles: each level's tile counts and its range of tiles,
// laid out level after level (the coarsest first with ML_COARSE_FIRST, so
// the blocks with the most rois do not make the launch's last wave);
// returns the number of tiles (-1 past the int range, or for an extent
// RoiGeom's 16-bit box cannot hold).
template <typename T>
int64_t lay_tiles(Pyramid<T>& pyr, int batch) {
  int64_t tiles = 0;
  for (int i = 0; i < LEVELS; ++i) {
    const int l = ML_COARSE_FIRST ? LEVELS - 1 - i : i;
    if (pyr.h[l] > UINT16_MAX || pyr.w[l] > UINT16_MAX) return -1;
    pyr.tiles_y[l] = ceil_div(pyr.h[l], ML_TILE_Y);
    pyr.tiles_x[l] = ceil_div(pyr.w[l], ML_TILE_X);
    pyr.first_block[l] = static_cast<int>(tiles);
    tiles += static_cast<int64_t>(batch) * pyr.tiles_y[l] * pyr.tiles_x[l];
    if (tiles > INT32_MAX) return -1;
    pyr.end_block[l] = static_cast<int>(tiles);
  }
  return tiles;
}

// Bytes of the backward's scratch: the rois' geometry, then the tiles' masks.
int64_t ml_bwd_scratch_bytes(int64_t tiles, int batch, int r) {
  return static_cast<int64_t>(batch) * r * sizeof(RoiGeom) +
         tiles * ceil_div(r, 32) * static_cast<int64_t>(sizeof(unsigned));
}

template <typename T, typename O>
int launch_multilevel_fwd(void* const* feats, const int* hs, const int* ws, const void* rois,
                          const void* levels, int batch, int c, int r, float img_h, float img_w,
                          int out, int s, void* dst, cudaStream_t stream) {
  const int64_t n_rois = static_cast<int64_t>(batch) * r;
  if (n_rois == 0 || c == 0) return 0;
  const int p_total = out * s;
  if (p_total > MAX_SAMPLES) return static_cast<int>(cudaErrorInvalidValue);
  Pyramid<const T> pyr{};
  if (!make_pyramid(pyr, feats, hs, ws)) return static_cast<int>(cudaErrorInvalidValue);
  bool vec = c % 8 == 0 && aligned(dst, 16);
  for (int l = 0; l < LEVELS; ++l) vec = vec && aligned(feats[l], 16);
  const int warps = ML_FWD_THREADS / 32;
  const int max_splits = ceil_div(static_cast<int64_t>(out) * out, warps);
  // enough blocks for two full waves
  const int want = ceil_div(2LL * sm_count() * (2048 / ML_FWD_THREADS), n_rois);
  const int splits = max(1, min(want, max_splits));
  const dim3 grid(static_cast<unsigned int>(n_rois), static_cast<unsigned int>(splits));
  auto kernel = !vec     ? multilevel_roi_align_kernel<T, O, false, 0>
                : s == 2 ? multilevel_roi_align_kernel<T, O, true, 2>
                         : multilevel_roi_align_kernel<T, O, true, 0>;
  kernel<<<grid, ML_FWD_THREADS, 2 * p_total * sizeof(Axis), stream>>>(
      pyr, static_cast<const float*>(rois), static_cast<const int*>(levels), img_h, img_w, c, r,
      out, s, static_cast<O*>(dst));
  return static_cast<int>(cudaGetLastError());
}

template <typename G, typename F>
int launch_multilevel_bwd(const void* grad_out, const void* rois, const void* levels, int batch,
                          const int* hs, const int* ws, int c, int r, float img_h, float img_w,
                          int out, int s, void* const* grads, void* scratch,
                          cudaStream_t stream) {
  if (batch == 0 || c == 0) return 0;
  const int p_total = out * s;
  if (p_total > MAX_SAMPLES) return static_cast<int>(cudaErrorInvalidValue);
  // term offsets are 32-bit: one image's grad_out must index with an int
  if (static_cast<int64_t>(r) * out * out * c > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pyramid<F> pyr{};
  if (!make_pyramid(pyr, grads, hs, ws)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = lay_tiles(pyr, batch);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(batch) * r > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int n_rois = batch * r;
  const int words = ceil_div(r, 32);
  RoiGeom* geom = static_cast<RoiGeom*>(scratch);
  unsigned* masks = reinterpret_cast<unsigned*>(geom + n_rois);
  if (n_rois > 0) {
    cudaError_t err = cudaMemsetAsync(masks, 0, tiles * words * sizeof(unsigned), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    multilevel_roi_geometry_kernel<F>
        <<<ceil_div(n_rois, ML_GEOM_THREADS), ML_GEOM_THREADS, 0, stream>>>(
            static_cast<const float*>(rois), static_cast<const int*>(levels), pyr, img_h, img_w,
            n_rois, r, out, s, words, geom, masks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int glanes = 1;  // lanes per roi in the kernel's bin step: the power of two >= out, <= 32
  while (glanes < out && glanes < 32) glanes *= 2;
  const int chunk = max(1, min(BWD_WARPS * (32 / glanes), ML_BIN_BUDGET / out));
  const int ctiles = ceil_div(c, ML_CT);
  const size_t smem = ML_PASS_PIXELS * BWD_TERMS * sizeof(Term) +
                      (BWD_THREADS + BWD_WARPS + chunk * (ML_PASS_ROWS + ML_PASS_COLS) +
                       ML_PASS_PIXELS * (chunk + 1)) * sizeof(int) +
                      static_cast<size_t>(chunk) * (ML_PASS_ROWS + ML_PASS_COLS) * out *
                          sizeof(Bin);
  bool vec = c % 8 == 0 && aligned(grad_out, 16);
  for (int l = 0; l < LEVELS; ++l) vec = vec && aligned(grads[l], 16);
  const dim3 grid(static_cast<unsigned int>(tiles), static_cast<unsigned int>(ctiles));
  auto kernel = vec ? multilevel_roi_align_bwd_kernel<G, F, true>
                    : multilevel_roi_align_bwd_kernel<G, F, false>;
  kernel<<<grid, BWD_THREADS, smem, stream>>>(static_cast<const G*>(grad_out), geom, masks, pyr,
                                              c, r, out, s, words, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Forward: feat [batch, h, w, c] (bf16 when feat_bf16, else f32), rois
// [batch, r, 4] f32 -> dst [batch, r, out, out, c] (bf16 when out_bf16, else
// f32). splits <= 0 picks the number of blocks per roi. Returns the CUDA
// error of the launch (0 = cudaSuccess).
int roi_align_fwd(const void* feat, int feat_bf16, const void* rois, int batch, int h, int w,
                  int c, int r, int out, int s, void* dst, int out_bf16, int splits,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feat_bf16) {
    return out_bf16 ? launch_fwd<__nv_bfloat16, __nv_bfloat16>(feat, rois, batch, h, w, c, r,
                                                               out, s, dst, splits, st)
                    : launch_fwd<__nv_bfloat16, float>(feat, rois, batch, h, w, c, r, out, s,
                                                       dst, splits, st);
  }
  return out_bf16 ? launch_fwd<float, __nv_bfloat16>(feat, rois, batch, h, w, c, r, out, s, dst,
                                                     splits, st)
                  : launch_fwd<float, float>(feat, rois, batch, h, w, c, r, out, s, dst, splits,
                                             st);
}

// Backward: grad_out [batch, r, out, out, c] (bf16 when grad_bf16, else f32),
// rois [batch, r, 4] f32 -> grad_feat [batch, h, w, c] (bf16 when feat_bf16,
// else f32), every element written once.
int roi_align_bwd(const void* grad_out, int grad_bf16, const void* rois, int batch, int h, int w,
                  int c, int r, int out, int s, void* grad_feat, int feat_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grad_bf16) {
    return feat_bf16 ? launch_bwd<__nv_bfloat16, __nv_bfloat16>(grad_out, rois, batch, h, w, c,
                                                                r, out, s, grad_feat, st)
                     : launch_bwd<__nv_bfloat16, float>(grad_out, rois, batch, h, w, c, r, out,
                                                        s, grad_feat, st);
  }
  return feat_bf16 ? launch_bwd<float, __nv_bfloat16>(grad_out, rois, batch, h, w, c, r, out, s,
                                                      grad_feat, st)
                   : launch_bwd<float, float>(grad_out, rois, batch, h, w, c, r, out, s,
                                              grad_feat, st);
}

// Multi-level forward: feats[4] (P2..P5, each [batch, hs[l], ws[l], c], bf16
// when feat_bf16, else f32), rois [batch, r, 4] f32 image coordinates,
// levels [batch, r] int32 (0..3) -> dst [batch, r, out, out, c] (bf16 when
// out_bf16, else f32). feats, hs and ws are host arrays of 4.
int multilevel_roi_align_fwd(void* const* feats, const int* hs, const int* ws, int feat_bf16,
                             const void* rois, const void* levels, int batch, int c, int r,
                             float img_h, float img_w, int out, int s, void* dst, int out_bf16,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feat_bf16) {
    return out_bf16 ? launch_multilevel_fwd<__nv_bfloat16, __nv_bfloat16>(
                          feats, hs, ws, rois, levels, batch, c, r, img_h, img_w, out, s, dst, st)
                    : launch_multilevel_fwd<__nv_bfloat16, float>(
                          feats, hs, ws, rois, levels, batch, c, r, img_h, img_w, out, s, dst, st);
  }
  return out_bf16 ? launch_multilevel_fwd<float, __nv_bfloat16>(
                        feats, hs, ws, rois, levels, batch, c, r, img_h, img_w, out, s, dst, st)
                  : launch_multilevel_fwd<float, float>(feats, hs, ws, rois, levels, batch, c, r,
                                                        img_h, img_w, out, s, dst, st);
}

// Multi-level backward: grad_out [batch, r, out, out, c] (bf16 when
// grad_bf16, else f32), the forward's rois and levels -> grads[4] (P2..P5,
// each [batch, hs[l], ws[l], c], bf16 when feat_bf16, else f32), every
// element written once. scratch: multilevel_roi_align_bwd_scratch bytes on
// the device, 16-byte aligned (its masks are zeroed on the stream here).
int multilevel_roi_align_bwd(const void* grad_out, int grad_bf16, const void* rois,
                             const void* levels, int batch, const int* hs, const int* ws, int c,
                             int r, float img_h, float img_w, int out, int s, void* const* grads,
                             int feat_bf16, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grad_bf16) {
    return feat_bf16 ? launch_multilevel_bwd<__nv_bfloat16, __nv_bfloat16>(
                           grad_out, rois, levels, batch, hs, ws, c, r, img_h, img_w, out, s,
                           grads, scratch, st)
                     : launch_multilevel_bwd<__nv_bfloat16, float>(
                           grad_out, rois, levels, batch, hs, ws, c, r, img_h, img_w, out, s,
                           grads, scratch, st);
  }
  return feat_bf16 ? launch_multilevel_bwd<float, __nv_bfloat16>(
                         grad_out, rois, levels, batch, hs, ws, c, r, img_h, img_w, out, s, grads,
                         scratch, st)
                   : launch_multilevel_bwd<float, float>(grad_out, rois, levels, batch, hs, ws, c,
                                                         r, img_h, img_w, out, s, grads, scratch,
                                                         st);
}

// Bytes of the multi-level backward's device scratch for these levels and
// rois (-1: the levels are refused).
long long multilevel_roi_align_bwd_scratch(int batch, const int* hs, const int* ws, int r) {
  void* none[LEVELS] = {};
  Pyramid<float> pyr{};
  if (!make_pyramid(pyr, none, hs, ws)) return -1;
  const int64_t tiles = lay_tiles(pyr, batch);
  return tiles < 0 ? -1 : ml_bwd_scratch_bytes(tiles, batch, r);
}

const char* roi_align_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
