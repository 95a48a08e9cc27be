// ROIPool forward and backward with staged rows: an alternative design to
// replication_faster_rcnn_tpu_torch/csrc/roi_pool_kernel.cu, with the same
// C interface, scratch, semantics and bits (see that file's note). The port
// does not build it: tools/roi_pool_variants.py compiles it beside the
// port's source and times both on the card, to keep the comparison that
// chose the port's design reproducible.
//
// Forward and bins pass (pool_rows): a 128-thread block per (roi, tile of
// up to 128 channels, POOL_ROW_BINS row bins). The block walks the roi's
// clamped rows in order, in bands of as many rows as fit in half of a
// POOL_RING-pixel ring in shared memory; the next band is copied by TMA
// (cp.async.bulk, one copy per pixel, an mbarrier per half; element by
// element for C not a multiple of 8 or an unaligned base) while this one is
// pooled. Each staged row is column-pooled once by a thread per (column bin,
// 8 channels) and folded into the running maxima of the row bins that hold
// it ([row bins, out, tile] in shared memory; the bins pass keeps the tie
// counts beside them), and each bin is written once, 16 bytes a store.
//
// Gather (roi_pool_bwd_kernel): the port's two-phase row owner, with each
// group's slabs (grad_out, the bin maxima and the counts over [out, 64
// channels] per (roi, row bin holding the row)) copied by TMA into one half
// of a double buffer while the group before it is summed. A group holds at
// most GATHER_GROUP rois and GATHER_SLABS slabs.
//
// Why it loses on the H100 (PERF.md): no staged element is read by more
// than one thread, so the shared-memory hop buys no reuse; a block waits on
// one band after another, and the ring and the bins' maxima cap the blocks
// an SM holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int POOL_THREADS = 128;      // forward and bins pass: threads per block
constexpr int POOL_CT = 128;           // forward and bins pass: the widest channel tile
constexpr int POOL_RING = 64;          // pixels x tile of staged rows: two bands
constexpr int POOL_ROW_BINS = 7;       // row bins per block (a roi's rows split over blocks)
constexpr int POOL_SMEM = 56 * 1024;   // shared memory that picks the channel tile
constexpr int GATHER_THREADS = 256;    // gather pass: threads per block
constexpr int GATHER_CT = 64;          // gather pass: channels per block, 8 per lane
constexpr int GATHER_GROUP = 8;        // rois per group of the gather (8 spans: 16 bytes)
constexpr int GATHER_SLABS = 12;       // slabs per group (at least out)
constexpr int GATHER_ROIS = 128;       // rois per listed chunk (<= GATHER_THREADS)
constexpr int MAX_OUT = 255;           // bins along one axis (uint8 bin indices in the list)
constexpr int MAX_ROWS = 255;          // map rows the uint8 tie counts take
constexpr int SHAPE_TOO_LARGE = -1;
constexpr int TOO_MANY_ROWS = -2;

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

// 8 uint8 counts from an 8-byte aligned address, as float32
__device__ __forceinline__ void load8(const uint8_t* p, float (&v)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = static_cast<float>((u.x >> (8 * k)) & 0xffu);
    v[4 + k] = static_cast<float>((u.y >> (8 * k)) & 0xffu);
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

// 8 channels to global memory: 16-byte stores (VEC) or the first nch one by one
template <bool VEC, typename T>
__device__ __forceinline__ void store_out(T* p, int nch, const float (&v)[8]) {
  if constexpr (VEC) {
    store8(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < nch) store1(p + k, v[k]);
    }
  }
}

// TMA (cp.async.bulk): a contiguous copy of a multiple of 16 bytes from
// global to shared memory (both 16-byte aligned), issued by one thread,
// whose bytes complete a phase of an mbarrier. One thread arms each phase
// with the bytes it waits for; every reader waits on the phase's parity.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
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

// A running maximum over 8 consecutive channels of a 16-byte aligned row in
// shared memory, NaN propagating.
template <typename T>
struct Max8 {
  float v[8];
  __device__ __forceinline__ void fill() {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = -INFINITY;
  }
  __device__ __forceinline__ void set(const T* p) { load8(p, v); }
  __device__ __forceinline__ void take(const T* p) {
    float u[8];
    load8(p, u);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = max_nan(v[k], u[k]);
  }
  __device__ __forceinline__ void take(const Max8& o) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = max_nan(v[k], o.v[k]);
  }
  __device__ __forceinline__ void put(T* p) const { store8(p, v); }
  __device__ __forceinline__ float get(int k) const { return v[k]; }
};

// bfloat16 as four pairs: one __hmax2_nan per pair, values kept raw
template <>
struct Max8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void fill() {
    const __nv_bfloat162 neg = __float2bfloat162_rn(-INFINITY);
    const unsigned u = *reinterpret_cast<const unsigned*>(&neg);
    raw = make_uint4(u, u, u, u);
  }
  __device__ __forceinline__ void set(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void take(const uint4& r) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __hmax2_nan(h[k], q[k]);
  }
  __device__ __forceinline__ void take(const __nv_bfloat16* p) {
    take(*reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void take(const Max8& o) { take(o.raw); }
  __device__ __forceinline__ void put(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = raw;
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

// Shared memory of the forward and the bins pass: the roi's spans ([out]
// rows, then [out] columns), the ring of staged rows (two bands of
// POOL_RING / 2 pixels x tile), the bins' running maxima [out][out][tile]
// (the bins pass: and their tie counts in uint8), and a row's column maxima
// [out][tile] carried from one piece of a wide row to the next.
struct PoolLayout {
  size_t spans, ring, acc, carry, ties, total;
};

template <typename T, bool COUNT>
__host__ __device__ inline PoolLayout pool_layout(int out, int ct) {
  PoolLayout l;
  const size_t bins = static_cast<size_t>(min(out, POOL_ROW_BINS)) * out * ct;
  l.spans = 2 * sizeof(uint64_t);  // after the two halves' mbarriers
  l.ring = align16(l.spans + 2 * out * sizeof(Span));
  l.acc = align16(l.ring + static_cast<size_t>(POOL_RING) * ct * sizeof(T));
  l.carry = align16(l.acc + bins * sizeof(T));
  l.ties = align16(l.carry + static_cast<size_t>(out) * ct * sizeof(T));
  l.total = l.ties + (COUNT ? bins : 0);
  return l;
}

// One (roi, channel tile) block: the roi's rows staged in order, a band at
// a time, through two halves of a ring (see the note at the top); each row
// column-pooled once by a thread per (column bin, 8 channels) and folded
// into the row bins holding it. COUNT (the bins pass) folds with a tie count
// and writes the maximum and the count raw; the forward writes the maximum,
// a non-finite one as 0.
template <typename T, bool VEC, bool COUNT>
__device__ __forceinline__ void pool_rows(const T* __restrict__ feat,
                                          const float* __restrict__ rois, int h, int w, int c,
                                          int r, int out, int ct, T* __restrict__ dst,
                                          uint8_t* __restrict__ ties) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int HALF = POOL_RING / 2;
  const PoolLayout lay = pool_layout<T, COUNT>(out, ct);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  Span* spans = reinterpret_cast<Span*>(smem + lay.spans);
  T* ring = reinterpret_cast<T*>(smem + lay.ring);
  T* acc = reinterpret_cast<T*>(smem + lay.acc);
  T* carry = reinterpret_cast<T*>(smem + lay.carry);
  uint8_t* cnt = smem + lay.ties;

  const int64_t nr = blockIdx.x;
  const int n = static_cast<int>(nr / r);
  const int c0 = blockIdx.y * ct;
  const int nc = min(ct, c - c0);
  const int t = threadIdx.x;
  const float* roi = rois + nr * 4;
  const float inv_out = __fdiv_rn(1.f, static_cast<float>(out));
  if (VEC && t == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    mbar_init_fence();
  }
  for (int k = t; k < 2 * out; k += blockDim.x) {
    spans[k] = k < out ? bin_span(roi[0], roi[2], k, inv_out, h)
                       : bin_span(roi[1], roi[3], k - out, inv_out, w);
  }
  const int i0 = blockIdx.z * POOL_ROW_BINS;  // this block's row bins [i0, i1)
  const int i1 = min(out, i0 + POOL_ROW_BINS);
  const int bins = (i1 - i0) * out;
  const int lane_shift = __ffs(ct >> 3) - 1;  // ct / 8 lanes of 8 channels, a power of two
  const int lanes = 1 << lane_shift;
  Max8<T> neg;
  neg.fill();
  for (int it = t; it < bins * lanes; it += blockDim.x) {
    neg.put(acc + it * 8);
    if constexpr (COUNT) *reinterpret_cast<uint2*>(cnt + it * 8) = make_uint2(0u, 0u);
  }
  __syncthreads();

  // The roi's clamped window (both edges of the bins rise with the bin),
  // walked in pieces of wpx pixels: a whole row, or a part of a row wider
  // than a band. A band holds as many pieces as fit in half the ring.
  const int ylo = spans[i0].lo, xlo = spans[out].lo;
  const int rows = max(0, spans[i1 - 1].hi - ylo);
  const int cols = max(0, spans[2 * out - 1].hi - xlo);
  const int wpx = min(cols, HALF);
  const int per_row = wpx > 0 ? (cols + wpx - 1) / wpx : 0;
  const int pieces = rows * per_row;
  const int band = wpx > 0 ? HALF / wpx : 1;
  const int bands = (pieces + band - 1) / band;
  const float inv_wpx = __fdiv_rn(1.f, static_cast<float>(max(wpx, 1)));
  const T* img = feat + static_cast<int64_t>(n) * h * w * c + c0;

  // band b into half b & 1 of the ring, one TMA copy per pixel (VEC; its
  // mbarrier counts the bytes) or element by element; piece j of the band
  // at pixel j * wpx of the half
  auto stage = [&](int b) {
    if (b < bands) {
      T* half = ring + static_cast<size_t>(b & 1) * HALF * ct;
      const int k0 = b * band;
      const int y0 = ylo + k0 / per_row;
      const int xb = xlo + (k0 % per_row) * wpx;
      const int px = min(band, pieces - k0) * wpx;
      if constexpr (VEC) {
        const unsigned bytes = nc * sizeof(T);
        const int valid = per_row == 1 ? px : min(wpx, xlo + cols - xb);
        for (int p = t; p < valid; p += blockDim.x) {
          const int j = div_small(p, inv_wpx);
          const int x = xb + p - j * wpx;
          bulk_copy(half + p * ct, img + (static_cast<int64_t>(y0 + j) * w + x) * c, bytes,
                    &bars[b & 1]);
        }
        if (t == 0) mbar_expect(&bars[b & 1], valid * bytes);
      } else {
        const int cshift = lane_shift + 3;  // ct elements per pixel
        for (int q = t; q < px * ct; q += blockDim.x) {
          const int p = q >> cshift, e = q & (ct - 1);
          const int j = div_small(p, inv_wpx);
          const int x = xb + p - j * wpx;
          if (e < nc && x < xlo + cols) {
            half[p * ct + e] = img[(static_cast<int64_t>(y0 + j) * w + x) * c + e];
          }
        }
      }
    }
  };

  int ia = i0, ib = i0;  // the row bins [ia, ib) hold the current row
  stage(0);
  for (int b = 0; b < bands; ++b) {
    if constexpr (VEC) mbar_wait(&bars[b & 1], (b >> 1) & 1);  // band b is in
    __syncthreads();  // band b - 1's half is no longer read
    stage(b + 1);
    const T* half = ring + static_cast<size_t>(b & 1) * HALF * ct;
    const int k0 = b * band;
    for (int k = k0; k < min(pieces, k0 + band); ++k) {
      const int part = k % per_row;
      const int y = ylo + k / per_row;
      const int x0 = xlo + part * wpx;
      const int x1 = min(x0 + wpx, xlo + cols);
      const T* slot = half + static_cast<size_t>(k - k0) * wpx * ct;
      while (ib < i1 && spans[ib].lo <= y) ++ib;
      while (ia < ib && spans[ia].hi <= y) ++ia;
      for (int it = t; it < out * lanes; it += blockDim.x) {
        const int j = it >> lane_shift;
        const int cl = (it & (lanes - 1)) * 8;
        if (cl >= nc) continue;
        const Span sx = spans[out + j];
        Max8<T> m;
        if (part == 0) {
          m.fill();
        } else {
          m.set(carry + j * ct + cl);
        }
        for (int x = max(sx.lo, x0); x < min(sx.hi, x1); ++x) m.take(slot + (x - x0) * ct + cl);
        if (part + 1 < per_row) {
          m.put(carry + j * ct + cl);
          continue;
        }
        if (sx.hi <= sx.lo) continue;  // an empty column bin holds no row
        for (int i = ia; i < ib; ++i) {
          const int at = ((i - i0) * out + j) * ct + cl;
          if constexpr (COUNT) {
            float mv[8];
            int nv[8];
            load8(acc + at, mv);
            uint2 packed = *reinterpret_cast<const uint2*>(cnt + at);
            uint8_t* bytes = reinterpret_cast<uint8_t*>(&packed);
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              nv[q] = bytes[q];
              max_count(m.get(q), mv[q], nv[q]);
              bytes[q] = static_cast<uint8_t>(nv[q]);
            }
            store8(acc + at, mv);
            *reinterpret_cast<uint2*>(cnt + at) = packed;
          } else {
            Max8<T> a;
            a.set(acc + at);
            a.take(m);
            a.put(acc + at);
          }
        }
      }
    }
  }
  __syncthreads();

  // every bin once
  for (int it = t; it < bins * lanes; it += blockDim.x) {
    const int cl = (it & (lanes - 1)) * 8;
    if (cl >= nc) continue;
    const int bin = it >> lane_shift;
    const int64_t at = (nr * out * out + i0 * out + bin) * c + c0 + cl;
    float v[8];
    load8(acc + bin * ct + cl, v);
    if constexpr (COUNT) {
      store_out<VEC>(dst + at, nc - cl, v);
      const uint8_t* src = cnt + bin * ct + cl;
      if constexpr (VEC) {
        *reinterpret_cast<uint2*>(ties + at) = *reinterpret_cast<const uint2*>(src);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (k < nc - cl) ties[at + k] = src[k];
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = isfinite(v[k]) ? v[k] : 0.f;
      store_out<VEC>(dst + at, nc - cl, v);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(POOL_THREADS)
roi_pool_kernel(const T* __restrict__ feat,      // [N, H, W, C]
                const float* __restrict__ rois,  // [N, R, 4] feature coords
                int h, int w, int c, int r, int out, int ct,
                T* __restrict__ dst) {           // [N, R, out, out, C]
  pool_rows<T, VEC, false>(feat, rois, h, w, c, r, out, ct, dst, nullptr);
}

// Pass 1 of the backward: per roi bin and channel, the maximum m and the
// number of the bin's rows whose column maximum equals m.
template <typename T, bool VEC>
__global__ void __launch_bounds__(POOL_THREADS)
roi_pool_bwd_bins_kernel(const T* __restrict__ feat,        // [N, H, W, C]
                         const float* __restrict__ rois,    // [N, R, 4] feature coords
                         int h, int w, int c, int r, int out, int ct,
                         T* __restrict__ bin_max,           // [N, R, out, out, C]
                         uint8_t* __restrict__ tie_rows) {  // [N, R, out, out, C]
  pool_rows<T, VEC, true>(feat, rois, h, w, c, r, out, ct, bin_max, tie_rows);
}

// Shared memory of the gather (pass 2): the listed rois (index, first and
// last row bin holding the row, first slab, column spans), the row [w][64]
// and its float32 accumulator, a group's per-column-bin maximum (feature
// dtype) and share q (float32) [GATHER_GROUP][out][64], the column bins
// holding each pixel per roi of the group [w][GATHER_GROUP], the list's warp
// counts, and two slab buffers, each [slabs][out][64] of m, of grad_out and
// of the counts.
struct GatherLayout {
  size_t bins, first, cols, row, acc, cm, q, tab, warps, bars, buf, buf_g, buf_c, buf_bytes,
      total;
};

template <typename T, typename G>
__host__ __device__ inline GatherLayout gather_layout(int w, int out, int chunk, int slabs) {
  GatherLayout l;
  const size_t group = static_cast<size_t>(GATHER_GROUP) * out * GATHER_CT;
  const size_t slab = static_cast<size_t>(slabs) * out * GATHER_CT;
  l.bins = align16(chunk * sizeof(int));
  l.first = align16(l.bins + chunk * sizeof(uchar2));
  l.cols = align16(l.first + chunk * sizeof(int));
  l.row = align16(l.cols + static_cast<size_t>(chunk) * out * sizeof(short2));
  l.acc = align16(l.row + static_cast<size_t>(w) * GATHER_CT * sizeof(T));
  l.cm = align16(l.acc + static_cast<size_t>(w) * GATHER_CT * sizeof(float));
  l.q = align16(l.cm + group * sizeof(T));
  l.tab = align16(l.q + group * sizeof(float));
  l.warps = align16(l.tab + static_cast<size_t>(GATHER_GROUP) * w * sizeof(uchar2));
  l.bars = align16(l.warps + 2 * (GATHER_THREADS / 32) * sizeof(int));
  l.buf = align16(l.bars + 2 * sizeof(uint64_t));
  l.buf_g = align16(slab * sizeof(T));  // offsets inside one buffer
  l.buf_c = align16(l.buf_g + slab * sizeof(G));
  l.buf_bytes = align16(l.buf_c + slab);
  l.total = l.buf + 2 * l.buf_bytes;
  return l;
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
  Max8<__nv_bfloat16> m8;
  m8.fill();
  for (int x = lo; x < hi; ++x) m8.take(row + x * GATHER_CT);
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
                    int h, int w, int c, int r, int out, int chunk, int slabs,
                    T* __restrict__ grad_feat) {             // [N, H, W, C]
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CT = GATHER_CT;
  constexpr int LANES = CT / 8;  // a lane per 8 channels of the tile
  const GatherLayout lay = gather_layout<T, G>(w, out, chunk, slabs);
  int* l_roi = reinterpret_cast<int*>(smem);
  uchar2* l_bins = reinterpret_cast<uchar2*>(smem + lay.bins);
  int* l_first = reinterpret_cast<int*>(smem + lay.first);  // first slab, over the list
  short2* l_cols = reinterpret_cast<short2*>(smem + lay.cols);
  T* row = reinterpret_cast<T*>(smem + lay.row);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  T* g_cm = reinterpret_cast<T*>(smem + lay.cm);  // [GATHER_GROUP][out][CT]
  float* g_q = reinterpret_cast<float*>(smem + lay.q);
  uchar2* g_tab = reinterpret_cast<uchar2*>(smem + lay.tab);  // [w][GATHER_GROUP]
  int* warp_hits = reinterpret_cast<int*>(smem + lay.warps);
  int* warp_slabs = warp_hits + GATHER_THREADS / 32;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);  // one per slab buffer

  const int y = blockIdx.x % h;
  const int n = blockIdx.x / h;
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, c - c0);
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int64_t pix0 = (static_cast<int64_t>(n) * h + y) * w;
  if (VEC && t == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    mbar_init_fence();
  }
  for (int q = t; q < w * CT; q += GATHER_THREADS) {
    const int k = q % CT;
    store1(row + q, k < nc ? to_f32(feat[(pix0 + q / CT) * c + c0 + k]) : 0.f);
    acc[q] = 0.f;
  }
  const float inv_out = __fdiv_rn(1.f, static_cast<float>(out));
  const int64_t img_rois = static_cast<int64_t>(n) * r;
  const int64_t bin_row = static_cast<int64_t>(out) * c;  // one row of bins

  // Groups staged and summed so far, over all chunks: group k sits in buffer
  // k & 1, whose mbarrier completes its (k >> 1)-th phase when it is in.
  int staged = 0, summed = 0;
  // the slabs of listed rois [e0, e1) into the next buffer: per (slab,
  // column bin) three TMA copies, m, grad_out and the counts (VEC), or
  // element by element
  auto stage = [&](int e0, int e1) {
    if (e0 < e1) {
      const int b = staged & 1;
      unsigned char* buf = smem + lay.buf + b * lay.buf_bytes;
      T* s_m = reinterpret_cast<T*>(buf);
      G* s_g = reinterpret_cast<G*>(buf + lay.buf_g);
      uint8_t* s_c = buf + lay.buf_c;
      const int s0 = l_first[e0];
      const int ns = l_first[e1 - 1] + l_bins[e1 - 1].y - l_bins[e1 - 1].x + 1 - s0;
      constexpr int U = VEC ? 3 : CT;  // items per (slab, column bin)
      for (int q = t; q < ns * out * U; q += GATHER_THREADS) {
        const int rw = q / U, u = q - rw * U;
        const int s = div_small(rw, inv_out);
        const int bj = rw - s * out;
        int e = e0;
        while (e + 1 < e1 && l_first[e + 1] - s0 <= s) ++e;
        const int bi = l_bins[e].x + s - (l_first[e] - s0);
        const int64_t at = ((img_rois + l_roi[e]) * out + bi) * bin_row + bj * c + c0;
        const int sa = rw * CT;
        if constexpr (VEC) {
          if (u == 0) {
            bulk_copy(s_m + sa, bin_max + at, nc * sizeof(T), &bars[b]);
          } else if (u == 1) {
            bulk_copy(s_g + sa, grad_out + at, nc * sizeof(G), &bars[b]);
          } else {
            bulk_copy(s_c + sa, tie_rows + at, nc, &bars[b]);
          }
        } else {
          const bool in = u < nc;
          s_m[sa + u] = in ? bin_max[at + u] : T(0.f);
          s_g[sa + u] = in ? grad_out[at + u] : G(0.f);
          s_c[sa + u] = in ? tie_rows[at + u] : 1;
        }
      }
      if (VEC && t == 0) mbar_expect(&bars[b], ns * out * nc * (sizeof(T) + sizeof(G) + 1));
      ++staged;
    }
  };

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
    int nslab = bhi - blo + 1;  // inclusive scan of the slab counts over the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, nslab, d);
      if (lane >= d) nslab += v;
    }
    if (lane == 31) {
      warp_hits[warp] = __popc(mask);
      warp_slabs[warp] = nslab;
    }
    __syncthreads();
    int pos = __popc(mask & ((1u << lane) - 1u)), hits = 0;
    int first = nslab - (bhi - blo + 1);
    for (int k = 0; k < GATHER_THREADS / 32; ++k) {
      pos += k < warp ? warp_hits[k] : 0;
      first += k < warp ? warp_slabs[k] : 0;
      hits += warp_hits[k];
    }
    if (hit) {
      l_roi[pos] = r0 + t;
      l_bins[pos] = make_uchar2(static_cast<unsigned char>(blo), static_cast<unsigned char>(bhi));
      l_first[pos] = first;
      for (int p = 0; p < out; ++p) {
        const Span s = bin_span(a1, a3, p, inv_out, w);
        l_cols[pos * out + p] = make_short2(static_cast<short>(s.lo), static_cast<short>(s.hi));
      }
    }
    __syncthreads();

    // the group starting at listed roi e: at most GATHER_GROUP rois and slabs slabs
    auto group_end = [&](int e) {
      if (e >= hits) return e;
      const int s0 = l_first[e];
      int f = e + 1;
      while (f < hits && f - e < GATHER_GROUP &&
             l_first[f] + l_bins[f].y - l_bins[f].x + 1 - s0 <= slabs) {
        ++f;
      }
      return f;
    };
    int e0 = 0, e1 = group_end(0);
    stage(e0, e1);
    while (e0 < hits) {
      const int e2 = group_end(e1);
      stage(e1, e2);  // the next group's slabs, while this one is summed
      if constexpr (VEC) mbar_wait(&bars[summed & 1], (summed >> 1) & 1);
      __syncthreads();  // this group's slabs are in
      const int ng = e1 - e0;
      const unsigned char* buf = smem + lay.buf + (summed & 1) * lay.buf_bytes;
      const T* s_m = reinterpret_cast<const T*>(buf);
      const G* s_g = reinterpret_cast<const G*>(buf + lay.buf_g);
      const uint8_t* s_c = buf + lay.buf_c;
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
        if (any && cl < nc) {
          // the row bins holding y, ascending: this roi's slabs in order
          const uchar2 bins = l_bins[e];
          int at = ((l_first[e] - l_first[e0]) * out + bj) * CT + cl;
          for (int bi = bins.x; bi <= bins.y; ++bi, at += out * CT) {
            float m[8], gr[8], cnt[8];
            load8(s_m + at, m);
            load8(s_g + at, gr);
            load8(s_c + at, cnt);
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
      __syncthreads();  // the group's maxima, shares, spans and buffer are written again
      ++summed;
      e0 = e1;
      e1 = e2;
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

// The forward's and the bins pass's launch shape: the widest channel tile
// (a power of two, 8 to POOL_CT, no wider than C needs) whose shared memory
// fits POOL_SMEM, else the narrowest that fits the card; 0 when none does.
struct PoolShape {
  int ct;
  size_t bytes;
};

template <typename T, bool COUNT>
PoolShape pool_shape(int c, int out) {
  PoolShape s;
  int ct = 8;
  while (ct < POOL_CT && ct < c) ct *= 2;
  for (; ct >= 8; ct /= 2) {
    s.ct = ct;
    s.bytes = pool_layout<T, COUNT>(out, ct).total;
    if (s.bytes <= static_cast<size_t>(POOL_SMEM)) return s;
  }
  s.ct = 8;
  s.bytes = pool_layout<T, COUNT>(out, 8).total;
  if (s.bytes > static_cast<size_t>(max_shared())) s.ct = 0;
  return s;
}

template <typename T>
int launch_fwd(const void* feat, const void* rois, int batch, int h, int w, int c, int r,
               int out, void* dst, cudaStream_t stream) {
  const int64_t n_rois = static_cast<int64_t>(batch) * r;
  if (n_rois == 0 || c == 0) return 0;
  if (out < 1 || out > MAX_OUT) return static_cast<int>(cudaErrorInvalidValue);
  const PoolShape s = pool_shape<T, false>(c, out);
  if (s.ct == 0) return SHAPE_TOO_LARGE;
  const bool vec = c % 8 == 0 && aligned(feat, 16) && aligned(dst, 16);
  auto kernel = vec ? roi_pool_kernel<T, true> : roi_pool_kernel<T, false>;
  const int err = allow_shared(kernel, s.bytes);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned int>(n_rois), static_cast<unsigned int>(ceil_div(c, s.ct)),
                  static_cast<unsigned int>(ceil_div(out, POOL_ROW_BINS)));
  kernel<<<grid, POOL_THREADS, s.bytes, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois), h, w, c, r, out, s.ct,
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
  const int slabs = max(GATHER_SLABS, out);
  const size_t gather_bytes = gather_layout<T, G>(w, out, chunk, slabs).total;
  const PoolShape s = pool_shape<T, true>(c, out);
  if (gather_bytes > static_cast<size_t>(max_shared()) || s.ct == 0) return SHAPE_TOO_LARGE;
  if (n_rois > 0) {
    auto bins = vec ? roi_pool_bwd_bins_kernel<T, true> : roi_pool_bwd_bins_kernel<T, false>;
    const int err = allow_shared(bins, s.bytes);
    if (err != 0) return err;
    const dim3 grid(static_cast<unsigned int>(n_rois),
                    static_cast<unsigned int>(ceil_div(c, s.ct)),
                    static_cast<unsigned int>(ceil_div(out, POOL_ROW_BINS)));
    bins<<<grid, POOL_THREADS, s.bytes, stream>>>(
        static_cast<const T*>(feat), static_cast<const float*>(rois), h, w, c, r, out, s.ct,
        static_cast<T*>(bin_max), static_cast<uint8_t*>(tie_rows));
    const int launched = static_cast<int>(cudaGetLastError());
    if (launched != 0) return launched;
  }
  // the gather's TMA copies of the uint8 counts need rows of 16-byte multiples
  auto gather = vec && c % 16 == 0 && aligned(grad_out, 16) ? roi_pool_bwd_kernel<T, G, true>
                                                             : roi_pool_bwd_kernel<T, G, false>;
  const int err = allow_shared(gather, gather_bytes);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned int>(pixels / w),
                  static_cast<unsigned int>(ceil_div(c, GATHER_CT)));
  gather<<<grid, GATHER_THREADS, gather_bytes, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois),
      static_cast<const G*>(grad_out), static_cast<const T*>(bin_max),
      static_cast<const uint8_t*>(tie_rows), h, w, c, r, out, chunk, slabs,
      static_cast<T*>(grad_feat));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Forward: feat [batch, h, w, c] (bf16 when feat_bf16, else f32), rois
// [batch, r, 4] f32 in feature coordinates -> dst [batch, r, out, out, c] in
// the feature's dtype. Returns the CUDA error of the launch (0 = cudaSuccess)
// or SHAPE_TOO_LARGE (-1).
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
    return "the map is too wide, or out_size too large, for the ROIPool kernels' shared memory";
  }
  if (err == TOO_MANY_ROWS) {
    return "the ROIPool backward counts tied rows in uint8: the map may have at most 255 rows";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
