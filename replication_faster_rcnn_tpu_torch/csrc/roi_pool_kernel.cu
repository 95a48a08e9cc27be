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
// kernels read each roi's window of the map once.
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
// map once and grad_feat once (5.9 MB each): ~0.011 ms. In practice both
// are bound by latency and by per-channel instructions: the tie rule costs
// comparisons, counts and float32 divisions per channel. No element these
// kernels load is read by more than one thread, so staging it in shared
// memory buys no reuse: tools/roi_pool_staged.cu (the roi's rows staged
// through a ring by TMA, then column-pooled; the gather's slabs staged ahead
// of use) is bitwise equal to this source and measured 1.5-2.8x slower
// (tools/roi_pool_variants.py). These kernels instead keep many
// independent loads and warps in flight.
//
// Forward design (roi_pool_kernel): a 128-thread block per roi (its bins
// split over a few blocks when there are too few rois for two waves, as at
// b1) with the roi's bin edges in shared memory; a warp per bin, a lane per
// 8 channels (16-byte loads and stores, or single channels when C is not a
// multiple of 8 or a base is not 16-byte aligned). A lane issues the loads
// of FWD_LOADS of the bin's pixels together before it reduces them, with
// one __hmax2_nan per bfloat16 pair (float32: a NaN-propagating maximum).
// The maximum is exact and its NaN does not depend on the order, so it
// equals the plain one.
//
// Backward design: two passes, deterministic, no atomics.
//   1. roi_pool_bwd_bins_kernel, the forward's bin walk with a tie count:
//      per roi bin and channel, each row's column maximum, folded in row
//      order into the bin's maximum m and the number of rows whose column
//      maximum equals m. It writes m in the feature's dtype (raw: +-inf and
//      NaN kept; exact, since m is one of the map's values) and the count
//      in uint8 (maps of at most 255 rows, else TOO_MANY_ROWS): [N, R, out,
//      out, C] each, 25.7 MB + 12.8 MB at 8 x 128 x 7 x 7 x 256 in bfloat16
//      (the first design wrote m and g / count in float32: 103 MB). The
//      wrapper allocates this scratch and frees it when the backward
//      returns. It does not read grad_out.
//   2. roi_pool_bwd_kernel owns one feature row: a 256-thread block per
//      (image, row y, tile of 64 channels). The row's [W, 64] features and
//      a float32 accumulator of the same shape sit in shared memory. The
//      block lists the image's rois whose rows hold y, in index order (a
//      chunk at a time), then takes them GATHER_GROUP at a time in two
//      phases, a lane per 8 channels. Phase A, items (roi, column bin j,
//      lane) all independent: the row's maximum cm and tie count over
//      segment j (bfloat16: __hmax2_nan); s, the sum over the row bins i
//      that hold y, ascending, of g(i, j) / count(i, j) where m(i, j) == cm
//      (grad_out and the scratch read from L2 in 16-byte loads; a count of 1
//      divides by nothing); q = s / ties. Phase B, items (pixel x, lane):
//      for the group's rois in index order and their column bins holding x
//      (a per-pixel table of bin ranges, built beside phase A) in ascending
//      order, add q where feat[y, x] == cm. Each pixel thus receives the
//      same float32 terms in the same order as in the first design (roi
//      index, column bin; row bins ascending inside q): the gradient is
//      bitwise the first design's, written once in the feature's dtype.
//      Each scratch and grad_out entry is read once per row of its bin, not
//      once per covered pixel and column bin.
//
// Shared memory bounds the gather's shapes: a [W, 64] row twice, so a map
// too wide for the card's shared memory returns SHAPE_TOO_LARGE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FWD_THREADS = 128;       // forward and bins pass: threads per block
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int FWD_LOADS = 8;           // pixels whose loads a bfloat16 forward lane issues together
constexpr int FWD_LOADS_F32 = 4;       // the same for float32 (twice the registers a pixel)
constexpr int BINS_LOADS = 2;          // the same in the bins pass
constexpr int GATHER_THREADS = 256;    // gather pass: threads per block
constexpr int GATHER_CT = 64;          // gather pass: channels per block, 8 per lane
constexpr int GATHER_GROUP = 8;        // rois per phase of the gather (8 spans: 16 bytes)
constexpr int GATHER_ROIS = 128;       // rois per listed chunk (<= GATHER_THREADS)
constexpr int MAX_OUT = 255;           // bins along one axis (uint8 bin indices in the list)
constexpr int MAX_ROWS = 255;          // map rows the uint8 tie counts take
constexpr int SHAPE_TOO_LARGE = -1;
constexpr int TOO_MANY_ROWS = -2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
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

// amax's maximum: NaN propagates
__device__ __forceinline__ float max_nan(float m, float v) { return (v > m || isnan(v)) ? v : m; }

// x / d for a count d >= 1 (as float32), rounded to nearest: x / 1 is x, so
// only a tie pays for the division.
__device__ __forceinline__ float div_count(float x, float d) {
  return d == 1.f ? x : __fdiv_rn(x, d);
}

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

// A lane's 8 channel slots: 8 consecutive channels from p (VEC), or every
// 32nd channel from p, the first nch of them. Missing slots read -inf.
template <bool VEC, typename T>
__device__ __forceinline__ void load_lane(const T* p, int nch, float (&v)[8]) {
  if constexpr (VEC) {
    load8(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = k < nch ? to_f32(p[32 * k]) : -INFINITY;
  }
}

template <bool VEC, typename T>
__device__ __forceinline__ void store_lane(T* p, int nch, const float (&v)[8]) {
  if constexpr (VEC) {
    store8(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < nch) store1(p + 32 * k, v[k]);
    }
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

// A lane's running maximum over its 8 channel slots, NaN propagating. Pixels
// are loaded (load) apart from being taken (take), so a lane can have several
// loads in flight.
template <typename T, bool VEC>
struct Lane8 {
  struct Raw {
    float v[8];
  };
  float v[8];
  static __device__ __forceinline__ Raw load(const T* p, int nch) {
    Raw r;
    load_lane<VEC>(p, nch, r.v);
    return r;
  }
  __device__ __forceinline__ void fill() {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = -INFINITY;
  }
  __device__ __forceinline__ void take(const Raw& r) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = max_nan(v[k], r.v[k]);
  }
  __device__ __forceinline__ float get(int k) const { return v[k]; }
};

// 8 consecutive bfloat16 channels as four pairs: one __hmax2_nan per pair
template <>
struct Lane8<__nv_bfloat16, true> {
  using Raw = uint4;
  uint4 raw;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p, int) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void fill() {
    const __nv_bfloat162 neg = __float2bfloat162_rn(-INFINITY);
    const unsigned u = *reinterpret_cast<const unsigned*>(&neg);
    raw = make_uint4(u, u, u, u);
  }
  __device__ __forceinline__ void take(const Raw& r) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __hmax2_nan(h[k], q[k]);
  }
  __device__ __forceinline__ float get(int k) const {
    const __nv_bfloat162 h = reinterpret_cast<const __nv_bfloat162*>(&raw)[k >> 1];
    return (k & 1) ? __high2float(h) : __low2float(h);
  }
};

// Bins along one axis: [lo, hi), empty when lo >= hi.
struct Span {
  int lo, hi;
};

// torch.clamp / jnp.clip: NaN passes through
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Bin p of a roi along one axis, from its two corners (feature coordinates).
// Both edges are non-decreasing in p, so the bins that hold a row are one run.
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

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// q / d for 0 <= q < 2^16 and 1 <= d <= 255 without an integer division:
// the float32 quotient of q + 0.5 lies at least 1 / 510 from an integer,
// far beyond its rounding error.
__device__ __forceinline__ int div_small(int q, float inv_d) {
  return __float2int_rd(__fmul_rn(static_cast<float>(q) + 0.5f, inv_d));
}

// One (roi, split) block: the roi's 2 * out spans in shared memory, then a
// warp per bin and a lane per 8 channels, each lane with FWD_LOADS pixels'
// loads in flight. COUNT (the bins pass) reduces each row of the bin to its
// column maximum, folds those in row order with a tie count and writes the
// maximum and the count raw; the forward writes the maximum, a non-finite
// one as 0.
template <typename T, bool VEC, bool COUNT>
__device__ __forceinline__ void pool_bins(const T* __restrict__ feat,
                                          const float* __restrict__ rois, int h, int w, int c,
                                          int r, int out, T* __restrict__ dst,
                                          uint8_t* __restrict__ ties) {
  extern __shared__ __align__(16) unsigned char smem[];
  Span* spans = reinterpret_cast<Span*>(smem);  // [out] rows, then [out] columns
  using Lanes = Lane8<T, VEC>;
  constexpr int LOADS = COUNT ? BINS_LOADS : (sizeof(T) == 2 ? FWD_LOADS : FWD_LOADS_F32);
  const int64_t nr = blockIdx.x;
  const int n = static_cast<int>(nr / r);
  const float* roi = rois + nr * 4;
  const float inv_out = __fdiv_rn(1.f, static_cast<float>(out));
  for (int k = threadIdx.x; k < 2 * out; k += blockDim.x) {
    spans[k] = k < out ? bin_span(roi[0], roi[2], k, inv_out, h)
                       : bin_span(roi[1], roi[3], k - out, inv_out, w);
  }
  __syncthreads();

  const T* img = feat + static_cast<int64_t>(n) * h * w * c;
  const int lane = threadIdx.x & 31;
  const int bins = out * out;
  for (int b = blockIdx.y * FWD_WARPS + (threadIdx.x >> 5); b < bins;
       b += gridDim.y * FWD_WARPS) {
    const int bi = div_small(b, inv_out);
    const Span ry = spans[bi], rx = spans[out + b - bi * out];
    const int bw = rx.hi - rx.lo;
    const int area = ry.hi > ry.lo && bw > 0 ? (ry.hi - ry.lo) * bw : 0;
    const int64_t at = (nr * bins + b) * c;
    for (int base = 0; base < c; base += 256) {
      int ch;
      const int nch = lane_channels<VEC>(base, lane, c, ch);
      if (nch <= 0) break;
      Lanes m, rm;  // the bin's maximum; COUNT: the current row's
      m.fill();
      rm.fill();
      float mc[8];  // COUNT: the maximum of the row maxima and its tie count
      int cnt[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        mc[k] = -INFINITY;
        cnt[k] = 0;
      }
      const T* p0 = img + ch;
      int y = ry.lo, x = rx.lo;
      for (int p = 0; p < area; p += LOADS) {
        typename Lanes::Raw u[LOADS];
        bool row_end[LOADS];
#pragma unroll
        for (int k = 0; k < LOADS; ++k) {
          if (p + k < area) {
            u[k] = Lanes::load(p0 + (static_cast<int64_t>(y) * w + x) * c, nch);
            row_end[k] = x == rx.hi - 1;
            if (++x == rx.hi) {
              x = rx.lo;
              ++y;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < LOADS; ++k) {
          if (p + k >= area) break;
          if constexpr (COUNT) {
            rm.take(u[k]);
            if (row_end[k]) {
#pragma unroll
              for (int q = 0; q < 8; ++q) max_count(rm.get(q), mc[q], cnt[q]);
              rm.fill();
            }
          } else {
            m.take(u[k]);
          }
        }
      }
      if constexpr (COUNT) {
        store_lane<VEC>(dst + at + ch, nch, mc);
        if constexpr (VEC) {
          uint2 packed;
          uint8_t* bytes = reinterpret_cast<uint8_t*>(&packed);
#pragma unroll
          for (int k = 0; k < 8; ++k) bytes[k] = static_cast<uint8_t>(cnt[k]);
          *reinterpret_cast<uint2*>(ties + at + ch) = packed;
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (k < nch) ties[at + ch + 32 * k] = static_cast<uint8_t>(cnt[k]);
          }
        }
      } else {
        float f[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          f[k] = m.get(k);
          f[k] = isfinite(f[k]) ? f[k] : 0.f;
        }
        store_lane<VEC>(dst + at + ch, nch, f);
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(FWD_THREADS)
roi_pool_kernel(const T* __restrict__ feat,      // [N, H, W, C]
                const float* __restrict__ rois,  // [N, R, 4] feature coords
                int h, int w, int c, int r, int out,
                T* __restrict__ dst) {           // [N, R, out, out, C]
  pool_bins<T, VEC, false>(feat, rois, h, w, c, r, out, dst, nullptr);
}

// Pass 1 of the backward: per roi bin and channel, the maximum m and the
// number of the bin's rows whose column maximum equals m.
template <typename T, bool VEC>
__global__ void __launch_bounds__(FWD_THREADS)
roi_pool_bwd_bins_kernel(const T* __restrict__ feat,        // [N, H, W, C]
                         const float* __restrict__ rois,    // [N, R, 4] feature coords
                         int h, int w, int c, int r, int out,
                         T* __restrict__ bin_max,           // [N, R, out, out, C]
                         uint8_t* __restrict__ tie_rows) {  // [N, R, out, out, C]
  pool_bins<T, VEC, true>(feat, rois, h, w, c, r, out, bin_max, tie_rows);
}

// Shared memory of the gather (pass 2): the listed rois (index, first and
// last row bin holding the row, column spans), the row [w][64] and its
// float32 accumulator, a group's per-column-bin maximum (feature dtype) and
// share q (float32) [GATHER_GROUP][out][64], the column bins holding each
// pixel per roi of the group [w][GATHER_GROUP], and the list's warp counts.
struct GatherLayout {
  size_t bins, cols, row, acc, cm, q, tab, warps, total;
};

template <typename T>
__host__ __device__ inline GatherLayout gather_layout(int w, int out, int chunk) {
  GatherLayout l;
  const size_t group = static_cast<size_t>(GATHER_GROUP) * out * GATHER_CT;
  l.bins = align16(chunk * sizeof(int));
  l.cols = align16(l.bins + chunk * sizeof(uchar2));
  l.row = align16(l.cols + static_cast<size_t>(chunk) * out * sizeof(short2));
  l.acc = align16(l.row + static_cast<size_t>(w) * GATHER_CT * sizeof(T));
  l.cm = align16(l.acc + static_cast<size_t>(w) * GATHER_CT * sizeof(float));
  l.q = align16(l.cm + group * sizeof(T));
  l.tab = align16(l.q + group * sizeof(float));
  l.warps = align16(l.tab + static_cast<size_t>(GATHER_GROUP) * w * sizeof(uchar2));
  l.total = l.warps + (GATHER_THREADS / 32) * sizeof(int);
  return l;
}

// 8 uint8 counts from an 8-byte aligned address, as float32
__device__ __forceinline__ void load8(const uint8_t* p, float (&v)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = static_cast<float>((u.x >> (8 * k)) & 0xffu);
    v[4 + k] = static_cast<float>((u.y >> (8 * k)) & 0xffu);
  }
}

// A gather lane's 8 channels cl.. of the tile from a global array: one
// vector load (VEC: C a multiple of 8, 16-byte aligned bases) or one load
// each; channels past the tile read 0 and are never stored.
template <bool VEC, typename T>
__device__ __forceinline__ void load_lane8(const T* p, int cl, int nc, float (&v)[8]) {
  if constexpr (VEC) {
    if (cl < nc) {
      load8(p, v);
      return;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = 0.f;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = cl + k < nc ? to_f32(p[k]) : 0.f;
  }
}

// The maximum of a row segment [lo, hi) of 8 channels (row stride
// GATHER_CT), NaN propagating, and its number of ties where it is finite
// (elsewhere the gather uses neither): max_count's maximum and count.
__device__ __forceinline__ void segment_max(const float* row, int lo, int hi, float (&m)[8],
                                            float (&ties)[8]) {
  int n[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    m[k] = -INFINITY;
    n[k] = 0;
  }
  for (int x = lo; x < hi; ++x) {
    float u[8];
    load8(row + x * GATHER_CT, u);
#pragma unroll
    for (int k = 0; k < 8; ++k) max_count(u[k], m[k], n[k]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) ties[k] = static_cast<float>(n[k]);
}

// bfloat16: the maximum with one __hmax2_nan per pixel and pair, then the ties
__device__ __forceinline__ void segment_max(const __nv_bfloat16* row, int lo, int hi,
                                            float (&m)[8], float (&ties)[8]) {
  Lane8<__nv_bfloat16, true> m8;
  m8.fill();
  for (int x = lo; x < hi; ++x) m8.take(Lane8<__nv_bfloat16, true>::load(row + x * GATHER_CT, 8));
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    m[k] = m8.get(k);
    ties[k] = 0.f;
  }
  for (int x = lo; x < hi; ++x) {
    float u[8];
    load8(row + x * GATHER_CT, u);
#pragma unroll
    for (int k = 0; k < 8; ++k) ties[k] += u[k] == m[k] ? 1.f : 0.f;
  }
}

// Pass 2 of the backward: a block owns one feature row and gathers what the
// rois' bins give it (see the note at the top).
template <typename T, typename G, bool VEC>
__global__ void __launch_bounds__(GATHER_THREADS)
roi_pool_bwd_kernel(const T* __restrict__ feat,              // [N, H, W, C]
                    const float* __restrict__ rois,          // [N, R, 4] feature coords
                    const G* __restrict__ grad_out,          // [N, R, out, out, C]
                    const T* __restrict__ bin_max,           // [N, R, out, out, C]
                    const uint8_t* __restrict__ tie_rows,    // [N, R, out, out, C]
                    int h, int w, int c, int r, int out, int chunk,
                    T* __restrict__ grad_feat) {             // [N, H, W, C]
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CT = GATHER_CT;
  constexpr int LANES = CT / 8;  // a lane per 8 channels of the tile
  const GatherLayout lay = gather_layout<T>(w, out, chunk);
  int* l_roi = reinterpret_cast<int*>(smem);
  uchar2* l_bins = reinterpret_cast<uchar2*>(smem + lay.bins);
  short2* l_cols = reinterpret_cast<short2*>(smem + lay.cols);
  T* row = reinterpret_cast<T*>(smem + lay.row);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  T* g_cm = reinterpret_cast<T*>(smem + lay.cm);  // [GATHER_GROUP][out][CT]
  float* g_q = reinterpret_cast<float*>(smem + lay.q);
  uchar2* g_tab = reinterpret_cast<uchar2*>(smem + lay.tab);  // [w][GATHER_GROUP]
  int* warp_hits = reinterpret_cast<int*>(smem + lay.warps);

  const int y = blockIdx.x % h;
  const int n = blockIdx.x / h;
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, c - c0);
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int64_t pix0 = (static_cast<int64_t>(n) * h + y) * w;
  for (int q = t; q < w * CT; q += GATHER_THREADS) {
    const int k = q % CT;
    store1(row + q, k < nc ? to_f32(feat[(pix0 + q / CT) * c + c0 + k]) : 0.f);
    acc[q] = 0.f;
  }
  const float inv_out = __fdiv_rn(1.f, static_cast<float>(out));
  const int64_t img_rois = static_cast<int64_t>(n) * r;

  for (int r0 = 0; r0 < r; r0 += chunk) {
    const int m_rois = min(chunk, r - r0);
    __syncthreads();  // the row is staged; the previous chunk's list is no longer read
    // the list: the chunk's rois whose rows hold y, in index order
    int blo = 0, bhi = -1;
    float a1 = 0.f, a3 = 0.f;
    if (t < m_rois) {
      const float* roi = rois + (img_rois + r0 + t) * 4;
      const float a0 = roi[0], a2 = roi[2];
      a1 = roi[1];
      a3 = roi[3];
      if (bin_span(a0, a2, 0, inv_out, h).lo <= y && y < bin_span(a0, a2, out - 1, inv_out, h).hi) {
        for (int p = 0; p < out; ++p) {
          const Span s = bin_span(a0, a2, p, inv_out, h);
          if (s.lo <= y && y < s.hi) {
            if (bhi < 0) blo = p;
            bhi = p;
          }
        }
      }
    }
    const bool hit = bhi >= 0;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int pos = __popc(mask & ((1u << lane) - 1u)), hits = 0;
    for (int k = 0; k < GATHER_THREADS / 32; ++k) {
      pos += k < warp ? warp_hits[k] : 0;
      hits += warp_hits[k];
    }
    if (hit) {
      l_roi[pos] = r0 + t;
      l_bins[pos] = make_uchar2(static_cast<unsigned char>(blo), static_cast<unsigned char>(bhi));
      for (int p = 0; p < out; ++p) {
        const Span s = bin_span(a1, a3, p, inv_out, w);
        l_cols[pos * out + p] = make_short2(static_cast<short>(s.lo), static_cast<short>(s.hi));
      }
    }
    __syncthreads();

    for (int e0 = 0; e0 < hits; e0 += GATHER_GROUP) {
      const int ng = min(GATHER_GROUP, hits - e0);
      // the column bins [lo, hi) that hold each pixel, per roi of the group
      for (int it = t; it < w * GATHER_GROUP; it += GATHER_THREADS) {
        const int g = it % GATHER_GROUP;
        const int x = it / GATHER_GROUP;
        int lo = 0, hi = 0;  // edges rise with the bin: count, do not search
        if (g < ng) {
          const short2* cols = l_cols + (e0 + g) * out;
          for (int bj = 0; bj < out; ++bj) {
            const short2 sx = cols[bj];
            lo += sx.y <= x;
            hi += sx.x <= x;
          }
        }
        g_tab[it] = make_uchar2(static_cast<unsigned char>(lo), static_cast<unsigned char>(hi));
      }
      // phase A: per (roi, column bin, 8 channels) the segment's maximum and
      // ties, then q = (sum over the row bins holding y of g / count where
      // m equals that maximum) / ties
      for (int it = t; it < ng * out * LANES; it += GATHER_THREADS) {
        const int cl = 8 * (it % LANES);
        const int gb = it / LANES;  // g * out + bj
        const int g = div_small(gb, inv_out);
        const int e = e0 + g;
        const int bj = gb - g * out;
        const short2 sx = l_cols[e * out + bj];
        float cm[8], ties[8], s[8];
        segment_max(row + cl, sx.x, sx.y, cm, ties);
        bool f[8], any = false;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          f[k] = isfinite(cm[k]);
          any = any || f[k];
          s[k] = 0.f;
        }
        if (any) {
          // the row bins holding y, ascending
          const uchar2 bins = l_bins[e];
          const int64_t stride = static_cast<int64_t>(out) * c;  // one row of bins
          int64_t at = ((img_rois + l_roi[e]) * out + bins.x) * stride + bj * c + c0 + cl;
          for (int bi = bins.x; bi <= bins.y; ++bi, at += stride) {
            float m[8], gr[8], cnt[8];
            load_lane8<VEC>(bin_max + at, cl, nc, m);
            load_lane8<VEC>(grad_out + at, cl, nc, gr);
            load_lane8<VEC>(tie_rows + at, cl, nc, cnt);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              if (f[k] && m[k] == cm[k]) s[k] = __fadd_rn(s[k], div_count(gr[k], cnt[k]));
            }
          }
        }
        float q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) q[k] = f[k] ? div_count(s[k], ties[k]) : 0.f;
        const int st = gb * CT + cl;
        store8(g_cm + st, cm);
        store8(g_q + st, q);
      }
      __syncthreads();
      // phase B: per (pixel, 8 channels), the group's rois in index order
      // and their column bins holding the pixel in ascending order
      for (int it = t; it < w * LANES; it += GATHER_THREADS) {
        const int x = it / LANES;
        const int cl = 8 * (it % LANES);
        float u[8], a[8];
        load8(row + x * CT + cl, u);
        load8(acc + x * CT + cl, a);
        const uint4 tab = *reinterpret_cast<const uint4*>(g_tab + x * GATHER_GROUP);
        const unsigned words[4] = {tab.x, tab.y, tab.z, tab.w};
#pragma unroll
        for (int g = 0; g < GATHER_GROUP; ++g) {
          if (g >= ng) break;
          const unsigned span = words[g / 2] >> (16 * (g % 2));  // lo | hi << 8
          for (int bj = span & 0xffu; bj < ((span >> 8) & 0xffu); ++bj) {
            const int st = (g * out + bj) * CT + cl;
            float cm[8], q[8];
            load8(g_cm + st, cm);
            load8(g_q + st, q);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              if (isfinite(cm[k]) && u[k] == cm[k]) a[k] = __fadd_rn(a[k], q[k]);
            }
          }
        }
        store8(acc + x * CT + cl, a);
      }
      __syncthreads();  // the group's maxima, shares and spans are written again
    }
  }
  __syncthreads();

  // the row, every pixel once, in the feature's dtype
  for (int q = t; q < w * CT; q += GATHER_THREADS) {
    const int k = q % CT;
    if (k < nc) store1(grad_feat + (pix0 + q / CT) * c + c0 + k, acc[q]);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int ceil_div(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

int max_shared() {
  int dev = 0, bytes = 48 * 1024;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}

// Let `kernel` take `bytes` of dynamic shared memory (above the default 48 KB).
template <typename K>
int allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes)));
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Forward and bins pass: a block per roi, its bins split over a few blocks
// when there are too few rois for two full waves of the card, at most one
// bin per warp.
dim3 roi_grid(int64_t n_rois, int out) {
  const int max_splits = ceil_div(static_cast<int64_t>(out) * out, FWD_WARPS);
  const int splits = ceil_div(2LL * sm_count() * (2048 / FWD_THREADS), n_rois);
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
  kernel<<<roi_grid(n_rois, out), FWD_THREADS, 2 * out * sizeof(Span), stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois), h, w, c, r, out,
      static_cast<T*>(dst));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename G>
int launch_bwd(const void* feat, const void* grad_out, const void* rois, int batch, int h,
               int w, int c, int r, int out, void* bin_max, void* tie_rows, void* grad_feat,
               cudaStream_t stream) {
  if (h > MAX_ROWS) return TOO_MANY_ROWS;
  const int64_t pixels = static_cast<int64_t>(batch) * h * w;
  if (pixels == 0 || c == 0) return 0;
  if (out < 1 || out > MAX_OUT) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = c % 8 == 0 && aligned(feat, 16) && aligned(bin_max, 16) &&
                   aligned(tie_rows, 16);
  const int64_t n_rois = static_cast<int64_t>(batch) * r;
  const int chunk = max(1, min(r, GATHER_ROIS));
  const size_t gather_bytes = gather_layout<T>(w, out, chunk).total;
  if (gather_bytes > static_cast<size_t>(max_shared())) return SHAPE_TOO_LARGE;
  if (n_rois > 0) {
    auto bins = vec ? roi_pool_bwd_bins_kernel<T, true> : roi_pool_bwd_bins_kernel<T, false>;
    bins<<<roi_grid(n_rois, out), FWD_THREADS, 2 * out * sizeof(Span), stream>>>(
        static_cast<const T*>(feat), static_cast<const float*>(rois), h, w, c, r, out,
        static_cast<T*>(bin_max), static_cast<uint8_t*>(tie_rows));
    const int launched = static_cast<int>(cudaGetLastError());
    if (launched != 0) return launched;
  }
  auto gather = vec && aligned(grad_out, 16) ? roi_pool_bwd_kernel<T, G, true>
                                              : roi_pool_bwd_kernel<T, G, false>;
  const int err = allow_shared(gather, gather_bytes);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned int>(pixels / w),
                  static_cast<unsigned int>(ceil_div(c, GATHER_CT)));
  gather<<<grid, GATHER_THREADS, gather_bytes, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois),
      static_cast<const G*>(grad_out), static_cast<const T*>(bin_max),
      static_cast<const uint8_t*>(tie_rows), h, w, c, r, out, chunk,
      static_cast<T*>(grad_feat));
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
// when grad_bf16, else f32), scratch of grad_out's shape: bin_max in the
// feature's dtype and tie_rows in uint8 -> grad_feat [batch, h, w, c] in the
// feature's dtype, every element written once. Two launches on the stream;
// returns the first CUDA error, SHAPE_TOO_LARGE (-1) or TOO_MANY_ROWS (-2).
int roi_pool_bwd(const void* feat, int feat_bf16, const void* grad_out, int grad_bf16,
                 const void* rois, int batch, int h, int w, int c, int r, int out,
                 void* bin_max, void* tie_rows, void* grad_feat, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feat_bf16) {
    return grad_bf16 ? launch_bwd<__nv_bfloat16, __nv_bfloat16>(
                           feat, grad_out, rois, batch, h, w, c, r, out, bin_max, tie_rows,
                           grad_feat, st)
                     : launch_bwd<__nv_bfloat16, float>(feat, grad_out, rois, batch, h, w, c, r,
                                                        out, bin_max, tie_rows, grad_feat, st);
  }
  return grad_bf16 ? launch_bwd<float, __nv_bfloat16>(feat, grad_out, rois, batch, h, w, c, r,
                                                      out, bin_max, tie_rows, grad_feat, st)
                   : launch_bwd<float, float>(feat, grad_out, rois, batch, h, w, c, r, out,
                                              bin_max, tie_rows, grad_feat, st);
}

// The message of a return code: the shapes the kernels refuse, else CUDA's.
const char* roi_pool_error_string(int err) {
  if (err == SHAPE_TOO_LARGE) {
    return "the map is too wide for the ROIPool backward's shared-memory row";
  }
  if (err == TOO_MANY_ROWS) {
    return "the ROIPool backward counts tied rows in uint8: the map may have at most 255 rows";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
