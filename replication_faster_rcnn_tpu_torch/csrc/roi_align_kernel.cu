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

// Gather and sum a warp's buffered terms in order, 8 channels a lane. The
// vector loop has no branch, so its unrolled gathers issue together.
template <bool VEC, typename G>
__device__ __forceinline__ void sum_terms(const Term* terms, int count, const G* g, int nch,
                                          float (&acc)[8]) {
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
  __syncwarp();  // the buffer is rewritten next
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

const char* roi_align_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
