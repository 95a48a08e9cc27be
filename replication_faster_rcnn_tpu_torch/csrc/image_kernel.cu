// The training data path's image kernels: on-card augmentation (flip,
// translation, fixed-canvas scale jitter), the device cache's gather and the
// multi-scale bucket resample.
//
// Replaces no Pallas kernel: the JAX package runs these as XLA ops in its
// train step (replication_faster_rcnn_tpu/ops/image.py: augment_batch,
// augment_draws, hflip_batch_with_boxes, translate_batch_with_boxes,
// batched_scale_jitter, jitter_boxes_batch, resize_batch_with_boxes; and
// data/device_cache.py::materialize_batch). The port writes them as kernels
// so no plain code runs on the card on the step's path. Plain versions:
// replication_faster_rcnn_tpu_torch/ops/image.py.
//
// Four kernels (wrapper: ops/cuda/image_kernel.py):
//   * augment_geometry_kernel: a thread per (image, box). The splitmix64
//     draws of (seed, epoch, idx) in native uint64 (the plain version runs
//     them on 32-bit limbs), the flip bit, the translation (dy, dx) and the
//     jitter geometry (ch, cw, shy, shx) in float32 as JAX does, or the
//     host's flip / shifts / jitter; then the box's, label's and mask's
//     transforms of flip -> translate -> jitter, in JAX's order. Writes one
//     int32 row of 8 per image: flip, dy, dx, ch, cw, shy, shx, resample.
//   * augment_prepare_kernel: the same geometry (with GEOM) and each
//     image's two channel fills in one launch, a thread block cluster per
//     image. The translation's fill is the mean of the (flipped) image; the
//     jitter's is the mean of the translated image, computed as the source's
//     sum over the translation window plus the fill pixels times the first
//     fill, without the translated image. uint8 sums are exact integers;
//     float32 sums double in a fixed order (threads, warps, the cluster's
//     blocks in rank order). Without GEOM it reads the geometry rows
//     (image_fill_launch).
//   * augment_image_kernel: flip -> translate (integer gather, fill) ->
//     jitter (half-pixel bilinear over the translated image with
//     edge-clamped taps, fill outside [0, ch) x [0, cw)) of the batch's
//     rows, or of the cache's rows idx[n]. uint8 rounds half to even and
//     clips after each op.
//   * resize_aa_kernel: jax.image.resize(method="bilinear", antialias=True)
//     as separable band passes (rows, then columns) with the band weights
//     the wrapper computed on the host, applied in tap order; float32
//     between the passes; one block per image also scales the boxes.
//
// What bounds them on the H100: bytes. A 600x600 uint8 batch of 8 is 8.6 MB
// in and out (2.6 us each way at 3.35 TB/s), float32 four times that; the
// geometry kernel's work is a few hundred boxes, so its launch is its floor.
//
// The first design of the geometry and the fills (the data path's first
// slice) ran the geometry as one thread per image walking its G boxes in
// turn (G = 32 or 100), and the fills as two more launches: 16 row bands a
// block per image, one pixel a thread as three dependent byte loads and a
// 64-bit division and modulo, float64 partial sums through device memory,
// and a one-thread-per-image finishing launch summing the bands. The fused
// prepare kernel makes the step's chain geometry -> fills -> image pass one
// launch shorter and two launches fewer; its blocks read 16-byte vectors,
// several in flight a thread, and reduce through distributed shared memory.
//
// The first design of the image pass and the resize ran one thread per
// output pixel (image) or element (resize, one launch per pass). That put
// three 64-bit divisions and modulos in every thread (emulated on this card
// at dozens of instructions each: at b8 600->480 the resize's 12 M threads
// spent about its whole time there), reloaded each image's geometry row and
// fills and recomputed its two quotients per pixel, re-read the band weights
// from global memory per element, moved uint8 one byte a thread, made 12
// scattered byte loads per jittered pixel, and sent the resize's float32
// intermediate through device memory between its two launches (41.5 MB at
// b8 600->720).
//
// The design here:
//   * resize_aa_kernel: one launch per call, grid (output column tiles,
//     output row tiles, image). A block stages its rows' and columns' band
//     starts and weights in shared memory, runs the rows pass over the
//     input-column span its tile's column taps need (a host table, the span
//     rounded out to 8-element boundaries: the horizontal halo recomputes
//     about 1-2% of the rows pass at 128-column tiles) with 8- or 16-byte
//     loads, all of an element's taps in flight at once, into float32
//     channel planes in shared memory, then the columns pass out of them,
//     one output pixel a thread (neighbouring threads read neighbouring
//     words), into staged output rows written back as 16-byte vectors. A
//     call that resizes one axis runs that pass alone (the columns pass over
//     the converted input rows, or the rows pass straight to the output).
//   * augment_image_kernel: grid (column tiles, row pairs, image). A block
//     loads its image's geometry row, fills and the two quotients once into
//     shared memory. A row that is not resampled is one source row, shifted
//     and possibly reversed, plus runs of fill: the source run is staged
//     with 16-byte loads at its own vector phase, the pixels are reversed in
//     the read from shared memory. A resampled row's two vertical taps
//     depend on the row alone and its horizontal taps on the column alone:
//     the block stages the two translated-and-flipped source rows of each
//     output row once, and a per-tile table of each column's two staged
//     offsets (or fill) and weight. One output pixel a thread, into staged
//     output rows written back as 16-byte vectors.
//   * No 64-bit division anywhere: indices come from blockIdx and
//     multiplications. Vector accesses need a vector boundary in the tensor (the wrapper
//     hands 16-byte aligned bases); the groups that straddle a row's ends,
//     or rows not on a boundary, move element by element.
//
// Float arithmetic is strict IEEE (-fmad=false) and repeats the plain
// versions' operations in their order, so the results are bitwise theirs
// and the first design's; the float32 fills sum in another order and stay
// within 1 float32 ulp of them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <set>

namespace {

constexpr unsigned long long GAMMA = 0x9E3779B97F4A7C15ull;
constexpr unsigned long long MIX_EPOCH = 0xBF58476D1CE4E5B9ull;
constexpr unsigned long long MIX_IDX = 0x94D049BB133111EBull;
constexpr int GEOM_COLS = 8;  // flip, dy, dx, ch, cw, shy, shx, resample

__device__ __forceinline__ unsigned long long splitmix(unsigned long long z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// the top 24 bits scaled by 2^-24: exact in float32
__device__ __forceinline__ float uniform24(unsigned long long z) {
  return __fmul_rn(static_cast<float>(static_cast<unsigned int>(z >> 40)), 1.0f / 16777216.0f);
}

// jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi); NaN passes through
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  float y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

struct Geometry {
  const float* __restrict__ boxes;          // [M or N, G, 4] (null when g == 0)
  const int* __restrict__ labels;           // [M or N, G]
  const unsigned char* __restrict__ mask;   // [M or N, G] or null
  const int* __restrict__ idx;              // [N] rows of boxes (and of images), or null
  const int* __restrict__ aug;              // [N, 2] (idx, epoch), or null
  unsigned long long seed_mix;              // seed * GAMMA mod 2^64
  int hflip, do_scale, do_translate;
  float scale_lo, scale_span, amp_y, amp_x;
  const unsigned char* __restrict__ flip_in;  // [N] or null
  const int* __restrict__ shifts_in;          // [N, 2] or null
  const int* __restrict__ jitter_in;          // [N, 4] or null
  const unsigned char* __restrict__ apply_in; // [N] or null
  int resample_mode;  // image resample: 0 the rows whose boxes jitter, 1 all, 2 none
  int n, g, h, w;
  float* __restrict__ boxes_out;
  int* __restrict__ labels_out;
  unsigned char* __restrict__ mask_out;  // null when mask is null
  int* __restrict__ geom_out;            // [N, 8]
  float* __restrict__ draws_out;         // [N, 6] or null
};

// One image's decisions: its geometry row and what its box transforms read.
struct Decision {
  int flip, dy, dx, ch, cw, shy, shx, resample;
  int translate, apply_boxes;
};

// Image i's decisions from its (idx, epoch) draws or the host's flip /
// shifts / jitter; the draws go to draws[0..5] when it is not null.
__device__ __forceinline__ Decision decide(const Geometry& p, int i, float* draws) {
  Decision d;
  d.flip = 0;
  d.dy = 0;
  d.dx = 0;
  d.ch = p.h;
  d.cw = p.w;
  d.shy = 0;
  d.shx = 0;
  d.apply_boxes = 0;
  d.translate = p.aug != nullptr ? p.do_translate != 0 : p.shifts_in != nullptr;
  int jitter = 0;
  if (p.aug != nullptr) {
    const unsigned long long idx = static_cast<unsigned int>(p.aug[2 * i]);
    const unsigned long long epoch = static_cast<unsigned int>(p.aug[2 * i + 1]);
    unsigned long long z = splitmix(p.seed_mix + epoch * MIX_EPOCH + idx * MIX_IDX);
    const int bit = static_cast<int>(z & 1ull);
    float u[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      z = splitmix(z + GAMMA);
      u[k] = uniform24(z);
    }
    if (draws != nullptr) {
      draws[0] = static_cast<float>(bit);
#pragma unroll
      for (int k = 0; k < 5; ++k) draws[k + 1] = u[k];
    }
    if (p.hflip) d.flip = bit;
    if (p.do_translate) {
      // round((2 u - 1) * amp), half to even
      d.dy = static_cast<int>(rintf(__fmul_rn(__fsub_rn(__fmul_rn(2.0f, u[3]), 1.0f), p.amp_y)));
      d.dx = static_cast<int>(rintf(__fmul_rn(__fsub_rn(__fmul_rn(2.0f, u[4]), 1.0f), p.amp_x)));
    }
    if (p.do_scale) {
      const float scale = __fadd_rn(p.scale_lo, __fmul_rn(p.scale_span, u[0]));
      d.ch = static_cast<int>(fmaxf(1.0f, rintf(__fmul_rn(static_cast<float>(p.h), scale))));
      d.cw = static_cast<int>(fmaxf(1.0f, rintf(__fmul_rn(static_cast<float>(p.w), scale))));
      d.shy = static_cast<int>(
          rintf(__fmul_rn(static_cast<float>(d.ch - p.h), clipf(u[1], 0.0f, 1.0f))));
      d.shx = static_cast<int>(
          rintf(__fmul_rn(static_cast<float>(d.cw - p.w), clipf(u[2], 0.0f, 1.0f))));
      jitter = 1;
      d.apply_boxes = d.ch != p.h || d.cw != p.w || d.shy != 0 || d.shx != 0;
    }
  } else {
    if (p.flip_in != nullptr) d.flip = p.flip_in[i] != 0;
    if (p.shifts_in != nullptr) {
      d.dy = p.shifts_in[2 * i];
      d.dx = p.shifts_in[2 * i + 1];
    }
    if (p.jitter_in != nullptr) {
      d.ch = p.jitter_in[4 * i];
      d.cw = p.jitter_in[4 * i + 1];
      d.shy = p.jitter_in[4 * i + 2];
      d.shx = p.jitter_in[4 * i + 3];
      jitter = 1;
      d.apply_boxes = p.apply_in != nullptr
                          ? p.apply_in[i] != 0
                          : (d.ch != p.h || d.cw != p.w || d.shy != 0 || d.shx != 0);
    }
  }
  d.resample = jitter && p.resample_mode != 2 && (p.resample_mode == 1 || d.apply_boxes);
  return d;
}

__device__ __forceinline__ void write_geom(int* __restrict__ row, const Decision& d) {
  row[0] = d.flip;
  row[1] = d.dy;
  row[2] = d.dx;
  row[3] = d.ch;
  row[4] = d.cw;
  row[5] = d.shy;
  row[6] = d.shx;
  row[7] = d.resample;
}

// Box j of image i: flip -> translate -> jitter, in JAX's order. Its loads
// come before its stores and it shares no address with another thread's.
__device__ __forceinline__ void transform_box(const Geometry& p, const Decision& d, int i,
                                              int j) {
  const float hf = static_cast<float>(p.h), wf = static_cast<float>(p.w);
  const long src = p.idx != nullptr ? p.idx[i] : i;
  const long at = src * p.g + j;
  const float4 in = reinterpret_cast<const float4*>(p.boxes)[at];
  float b0 = in.x, b1 = in.y, b2 = in.z, b3 = in.w;
  int label = p.labels[at];
  unsigned char m = p.mask != nullptr ? p.mask[at] : 0;
  if (d.flip && label >= 0) {  // (y1, x1, y2, x2) -> (y1, W - x2, y2, W - x1)
    const float n1 = __fsub_rn(wf, b3), n3 = __fsub_rn(wf, b1);
    b1 = n1;
    b3 = n3;
  }
  if (d.translate && label >= 0) {
    const float tdy = static_cast<float>(d.dy), tdx = static_cast<float>(d.dx);
    const float t0 = clipf(__fsub_rn(b0, tdy), 0.0f, hf);
    const float t1 = clipf(__fsub_rn(b1, tdx), 0.0f, wf);
    const float t2 = clipf(__fsub_rn(b2, tdy), 0.0f, hf);
    const float t3 = clipf(__fsub_rn(b3, tdx), 0.0f, wf);
    if (__fsub_rn(t2, t0) < 1.0f || __fsub_rn(t3, t1) < 1.0f) {
      b0 = b1 = b2 = b3 = -1.0f;
      label = -1;
      m = 0;
    } else {
      b0 = t0; b1 = t1; b2 = t2; b3 = t3;
    }
  }
  if (d.apply_boxes && label >= 0) {
    const float sy = __fdiv_rn(static_cast<float>(d.ch), hf);
    const float sx = __fdiv_rn(static_cast<float>(d.cw), wf);
    const float fy = static_cast<float>(d.shy), fx = static_cast<float>(d.shx);
    const float t0 = clipf(__fsub_rn(__fmul_rn(b0, sy), fy), 0.0f, hf);
    const float t1 = clipf(__fsub_rn(__fmul_rn(b1, sx), fx), 0.0f, wf);
    const float t2 = clipf(__fsub_rn(__fmul_rn(b2, sy), fy), 0.0f, hf);
    const float t3 = clipf(__fsub_rn(__fmul_rn(b3, sx), fx), 0.0f, wf);
    if (__fsub_rn(t2, t0) < 1.0f || __fsub_rn(t3, t1) < 1.0f) {
      b0 = b1 = b2 = b3 = -1.0f;
      label = -1;
      m = 0;
    } else {
      b0 = t0; b1 = t1; b2 = t2; b3 = t3;
    }
  }
  const long out = static_cast<long>(i) * p.g + j;
  reinterpret_cast<float4*>(p.boxes_out)[out] = make_float4(b0, b1, b2, b3);
  p.labels_out[out] = label;
  if (p.mask_out != nullptr) p.mask_out[out] = m;
}

// grid (n, box tiles), blockDim.x threads: a thread per (image, box), box j
// = blockIdx.y * blockDim.x + threadIdx.x. Each thread derives its image's
// decisions itself (a few dozen dependent operations, no barrier); the
// thread of box 0 also writes the image's geometry row and draws (G = 0
// still runs that thread).
__global__ void augment_geometry_kernel(Geometry p) {
  const int i = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j > 0 && j >= p.g) return;
  const Decision d =
      decide(p, i, j == 0 && p.draws_out != nullptr ? p.draws_out + 6 * i : nullptr);
  if (j == 0) write_geom(p.geom_out + GEOM_COLS * i, d);
  if (j < p.g) transform_box(p, d, i, j);
}

// The translation window of an image in source coordinates: rows [r0, r1),
// columns [c0, c1) of the flipped-and-translated frame's valid reads.
struct Window {
  int r0, r1, c0, c1;
};

__device__ __forceinline__ Window window_of(int flip, int dy, int dx, int h, int w) {
  Window win;
  win.r0 = max(0, dy);
  win.r1 = min(h, h + dy);
  const int f0 = max(0, dx), f1 = min(w, w + dx);  // columns of the flipped frame
  win.c0 = flip ? w - f1 : f0;
  win.c1 = flip ? w - f0 : f1;
  return win;
}

// One channel's two fills (translation, jitter) from its sums over the
// image (all) and over the window (in), in double as the plain version:
// the jitter's fill is the mean of the translated image, the window's sum
// plus the fill pixels times the first fill. uint8 fills round half to
// even and clip to [0, 255].
__device__ __forceinline__ void finish_fills(double all, double in, const Window& win, int h,
                                             int w, bool is_u8, float* fill1, float* fill2) {
  const double area = static_cast<double>(h) * w;
  const double n_fill =
      area - static_cast<double>(max(0, win.r1 - win.r0)) * max(0, win.c1 - win.c0);
  double f1 = all / area;
  if (is_u8) f1 = fmin(fmax(rint(f1), 0.0), 255.0);
  const float first = static_cast<float>(f1);
  double f2 = (in + n_fill * static_cast<double>(first)) / area;
  if (is_u8) f2 = fmin(fmax(rint(f2), 0.0), 255.0);
  *fill1 = first;
  *fill2 = static_cast<float>(f2);
}

template <typename T>
__device__ __forceinline__ T store_value(float v);

template <>
__device__ __forceinline__ float store_value<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ unsigned char store_value<unsigned char>(float v) {
  return static_cast<unsigned char>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

// Groups of N = BYTES / sizeof(T) elements that move as one vector (8 or 16
// bytes) when they start at a multiple of N elements of a tensor whose base
// is 16-byte aligned; partial or unaligned groups move element by element.
// Lanes [lo, hi) are valid.
template <int BYTES>
struct VecOf;

template <>
struct VecOf<8> {
  using type = uint2;
};

template <>
struct VecOf<16> {
  using type = uint4;
};

template <typename T, int BYTES>
struct Group {
  static constexpr int N = BYTES / static_cast<int>(sizeof(T));
  using V = typename VecOf<BYTES>::type;
  union {
    V v;
    T e[N];
  };
};

template <typename T, int BYTES>
__device__ __forceinline__ void load_group(const T* p, long start, int lo, int hi,
                                           Group<T, BYTES>& out) {
  constexpr int N = Group<T, BYTES>::N;
  if (lo == 0 && hi == N && start % N == 0) {
    out.v = *reinterpret_cast<const typename Group<T, BYTES>::V*>(p + start);
  } else {
#pragma unroll
    for (int l = 0; l < N; ++l) out.e[l] = (l >= lo && l < hi) ? p[start + l] : T(0);
  }
}

template <typename T, int BYTES>
__device__ __forceinline__ void store_group(T* p, long start, int lo, int hi,
                                            const Group<T, BYTES>& in) {
  constexpr int N = Group<T, BYTES>::N;
  if (lo == 0 && hi == N && start % N == 0) {
    *reinterpret_cast<typename Group<T, BYTES>::V*>(p + start) = in.v;
  } else {
#pragma unroll
    for (int l = 0; l < N; ++l)
      if (l >= lo && l < hi) p[start + l] = in.e[l];
  }
}

// The valid lanes of the group at element g over elements [a, b).
template <int N>
__device__ __forceinline__ int lane_lo(long g, long a) {
  return static_cast<int>(max(0L, min(static_cast<long>(N), a - g)));
}

template <int N>
__device__ __forceinline__ int lane_hi(long g, long b) {
  return static_cast<int>(max(0L, min(static_cast<long>(N), b - g)));
}

// ----------------------------------------------------------- the fills

// A block's and a cluster's sums: exact for uint8, double for float32.
template <typename T>
struct SumOf;

template <>
struct SumOf<unsigned char> {
  using type = unsigned long long;
};

template <>
struct SumOf<float> {
  using type = double;
};

constexpr int PREPARE_LOADS = 4;  // 16-byte vectors a thread keeps in flight

// 0x01 in the bytes of word q (lanes 4q .. 4q + 3) of a 16-byte vector whose
// lane holds lane class (lane mod 3) k
__host__ __device__ constexpr unsigned class_mask(int q, int k) {
  unsigned m = 0;
  for (int j = 0; j < 4; ++j)
    if ((4 * q + j) % 3 == k) m |= 1u << (8 * j);
  return m;
}

// A whole vector's sums by lane class: 16 bytes as four dp4a a class (exact
// 32-bit integers); 4 floats as x0 + x3, x1, x2 in double.
__device__ __forceinline__ void class_sums(const Group<unsigned char, 16>& v, unsigned (&s)[3]) {
  const unsigned word[4] = {v.v.x, v.v.y, v.v.z, v.v.w};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    unsigned acc = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc = __dp4a(word[q], class_mask(q, k), acc);
    s[k] = acc;
  }
}

__device__ __forceinline__ void class_sums(const Group<float, 16>& v, double (&s)[3]) {
  s[0] = static_cast<double>(v.e[0]) + static_cast<double>(v.e[3]);
  s[1] = static_cast<double>(v.e[1]);
  s[2] = static_cast<double>(v.e[2]);
}

template <typename T>
struct LaneSum;  // a vector's class sums: exact for uint8

template <>
struct LaneSum<unsigned char> {
  using type = unsigned;
};

template <>
struct LaneSum<float> {
  using type = double;
};

// grid (K, n) in clusters of (K, 1, 1): one cluster per image n, blockDim.x
// a multiple of 96. With GEOM the cluster also computes image n's decisions
// (as augment_geometry_kernel), writes its geometry row (block 0) and
// transforms its boxes (box j on block j mod K); without, it reads the row
// from geom_in. Block r sums rows [r h / K, (r + 1) h / K) of the image
// (images[idx[n]] with idx) by channel, all of them and those inside the
// translation window: each thread reads 16-byte vectors at a stride of
// blockDim.x vectors, PREPARE_LOADS in flight (the first batch issued
// before thread 0 decides). A vector's lanes hold consecutive elements and
// 16 = 4 = 1 (mod 3) elements a vector, so with the stride a multiple of 3
// every vector of a thread starts on the same channel: lane l sums into
// class l mod 3, mapped to channels once at the end. A vector inside one
// row sums its classes at once (uint8: a dp4a per 4 bytes and class) and
// adds them to the window's sums when it lies inside the window, lane by
// lane only across the window's edge; a vector across a row end or the
// band's edge walks its lanes' (row, element). uint8 sums are integers
// (Acc: 32-bit while h w 255 < 2^31), float32 sums double. Then a warp
// shuffle tree, the warps in order, the cluster barrier,
// and block 0 reads the K blocks' sums through distributed shared memory in
// rank order and writes the two fills (finish_fills). No float64 partial
// goes through device memory; the order is fixed, so a float32 fill is
// bitwise the same at every launch and replay.
template <typename T, typename Acc, bool GEOM>
__global__ void augment_prepare_kernel(Geometry p, const T* __restrict__ images,
                                       const int* __restrict__ geom_in,
                                       float* __restrict__ fills) {
  namespace cg = cooperative_groups;
  using G = Group<T, 16>;
  using Sum = typename SumOf<T>::type;
  constexpr int N = G::N;
  constexpr int U = PREPARE_LOADS;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 prepare_smem[];
  const int t = threadIdx.x, nt = blockDim.x, warps = nt / 32;
  const int rank = blockIdx.x, k = gridDim.x, n = blockIdx.y, h = p.h, w = p.w;
  Sum* part = reinterpret_cast<Sum*>(prepare_smem);  // [6]: this block's sums
  Sum* warp_part = part + 8;                         // [warps][6]
  Decision* dec = reinterpret_cast<Decision*>(warp_part + 6 * warps);

  const int rw = 3 * w;
  const long src = p.idx != nullptr ? p.idx[n] : n;
  const int ya = rank * h / k, yb = (rank + 1) * h / k;
  const long a = (src * h + ya) * rw;  // the band's first element
  const int len = (yb - ya) * rw;
  // rel: the element of lane 0 of the thread's next vector, from the band's
  // first; (row, col) its row and element in the row
  int rel = static_cast<int>((a / N + t) * N - a);
  const int q0 = rel >= 0 ? rel / rw : -((rw - 1 - rel) / rw);
  int row = ya + q0, col = rel - q0 * rw;
  const int phase = (rel % 3 + 3) % 3;  // the channel of lane 0
  const int step = nt * N, dq = step / rw, dr = step - dq * rw;
  G v[U];
  // the first vectors are in flight while thread 0 decides
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long g = a + rel + static_cast<long>(u) * step;
    load_group<T, 16>(images, g, lane_lo<N>(g, a), lane_hi<N>(g, a + len), v[u]);
  }
  if (t == 0) {
    Decision d{};
    if constexpr (GEOM) {
      d = decide(p, n, nullptr);
      if (rank == 0) write_geom(p.geom_out + GEOM_COLS * n, d);
    } else {
      const int* row_in = geom_in + GEOM_COLS * n;
      d.flip = row_in[0];
      d.dy = row_in[1];
      d.dx = row_in[2];
    }
    *dec = d;
  }
  __syncthreads();
  const Decision d = *dec;
  const Window win = window_of(d.flip, d.dy, d.dx, h, w);
  const int e0 = 3 * win.c0, e1 = 3 * win.c1;  // the window's elements of a row

  Acc all[3] = {Acc(0), Acc(0), Acc(0)}, in[3] = {Acc(0), Acc(0), Acc(0)};
  while (true) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (rel >= 0 && rel + N <= len && col + N <= rw) {  // inside one row of the band
        const bool row_in = row >= win.r0 && row < win.r1;
        const int lo = row_in ? min(max(e0 - col, 0), N) : 0;
        const int hi = row_in ? min(max(e1 - col, 0), N) : 0;
        typename LaneSum<T>::type s[3];
        class_sums(v[u], s);
#pragma unroll
        for (int c = 0; c < 3; ++c) all[c] += static_cast<Acc>(s[c]);
        if (lo == 0 && hi == N) {
#pragma unroll
          for (int c = 0; c < 3; ++c) in[c] += static_cast<Acc>(s[c]);
        } else if (lo < hi) {  // across the window's edge
#pragma unroll
          for (int l = 0; l < N; ++l)
            in[l % 3] += (l >= lo && l < hi) ? static_cast<Acc>(v[u].e[l]) : Acc(0);
        }
      } else {  // across a row's end or the band's edge: lanes outside the band are 0
        int r = row, c = col;
#pragma unroll
        for (int l = 0; l < N; ++l) {
          const Acc x = static_cast<Acc>(v[u].e[l]);
          all[l % 3] += x;
          in[l % 3] += (r >= win.r0 && r < win.r1 && c >= e0 && c < e1) ? x : Acc(0);
          if (++c == rw) {
            c = 0;
            ++r;
          }
        }
      }
      rel += step;
      row += dq;
      col += dr;
      if (col >= rw) {
        col -= rw;
        ++row;
      }
    }
    if (rel >= len) break;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long g = a + rel + static_cast<long>(u) * step;
      load_group<T, 16>(images, g, lane_lo<N>(g, a), lane_hi<N>(g, a + len), v[u]);
    }
  }
  if constexpr (GEOM) {
    for (int j = t * k + rank; j < p.g; j += nt * k) transform_box(p, d, n, j);
  }

  // channel c holds class (c - phase) mod 3
  Sum s[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s[c] = static_cast<Sum>(phase == 0 ? all[c] : phase == 1 ? all[(c + 2) % 3] : all[(c + 1) % 3]);
    s[3 + c] = static_cast<Sum>(phase == 0 ? in[c] : phase == 1 ? in[(c + 2) % 3] : in[(c + 1) % 3]);
  }
#pragma unroll
  for (int q = 0; q < 6; ++q)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[q] += __shfl_down_sync(0xffffffffu, s[q], off);
  if ((t & 31) == 0)
#pragma unroll
    for (int q = 0; q < 6; ++q) warp_part[(t >> 5) * 6 + q] = s[q];
  __syncthreads();
  if (t < 6) {
    Sum acc = 0;
    for (int i = 0; i < warps; ++i) acc += warp_part[i * 6 + t];
    part[t] = acc;
  }
  cluster.sync();
  if (rank == 0 && t < 3) {
    Sum sa = 0, si = 0;
    for (int r = 0; r < k; ++r) {
      const Sum* remote = cluster.map_shared_rank(part, r);
      sa += remote[t];
      si += remote[3 + t];
    }
    finish_fills(static_cast<double>(sa), static_cast<double>(si), win, h, w, sizeof(T) == 1,
                 fills + 6L * n + t, fills + 6L * n + 3 + t);
  }
  cluster.sync();  // every block's sums stay until block 0 has read them
}

// The half-pixel source coordinate of content index i: (i + 0.5) * q - 0.5.
__device__ __forceinline__ float source_coord(int i, float q) {
  return __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(i), 0.5f), q), 0.5f);
}

constexpr int IMAGE_BYTES = 16;  // the image pass's vector: 16 uint8 or 4 float32

// Group gi of the copy of elements [g0, g0 + len) of src into dst, dst[0]
// holding element g0 & ~(N - 1): the source's vector phase is kept, so
// whole groups move as vectors.
template <typename T>
__device__ __forceinline__ void stage_group(const T* __restrict__ src, long g0, int len, T* dst,
                                            int gi) {
  using G = Group<T, IMAGE_BYTES>;
  constexpr int N = G::N;
  const long g = (g0 & ~static_cast<long>(N - 1)) + static_cast<long>(gi) * N;
  G v;
  load_group<T, IMAGE_BYTES>(src, g, lane_lo<N>(g, g0), lane_hi<N>(g, g0 + len), v);
  store_group<T, IMAGE_BYTES>(dst, static_cast<long>(gi) * N, 0, N, v);
}

// grid (column tiles, row blocks, n), blockDim.x threads: output rows
// [y0, y0 + rows) of image n, pixels [x0, x0 + tile), one output pixel a
// thread at a time. Dynamic shared memory: the horizontal tap table of the
// tile (resampled images: per pixel the two taps' staged offsets, -1 for a
// fill tap, and the weight), the staged source rows (T, `stage_stride`
// elements each: one per output row, or two for a resampled image) and the
// staged output rows (T, `out_stride` elements each, at the output's
// 16-byte phase).
template <typename T>
__global__ void augment_image_kernel(const T* __restrict__ images, const int* __restrict__ idx,
                                     const int* __restrict__ geom,
                                     const float* __restrict__ fills, int h, int w, int tile,
                                     int rows, int stage_stride, int out_stride,
                                     T* __restrict__ out) {
  using G = Group<T, IMAGE_BYTES>;
  constexpr int N = G::N;
  extern __shared__ float4 image_smem[];
  __shared__ int gs[GEOM_COLS];
  __shared__ float fs[6], qs[2];
  __shared__ int src_s;
  const int b = blockIdx.z, t = threadIdx.x, nt = blockDim.x;
  if (t < GEOM_COLS) {
    gs[t] = geom[GEOM_COLS * b + t];
  } else if (t < GEOM_COLS + 6) {
    fs[t - GEOM_COLS] = fills != nullptr ? fills[6 * b + t - GEOM_COLS] : 0.0f;
  } else if (t == GEOM_COLS + 6) {
    src_s = idx != nullptr ? idx[b] : b;
  } else if (t == GEOM_COLS + 7) {
    qs[0] = __fdiv_rn(static_cast<float>(h), static_cast<float>(geom[GEOM_COLS * b + 3]));
    qs[1] = __fdiv_rn(static_cast<float>(w), static_cast<float>(geom[GEOM_COLS * b + 4]));
  }
  __syncthreads();
  int* tap0 = reinterpret_cast<int*>(image_smem);
  int* tap1 = tap0 + tile;
  float* wxs = reinterpret_cast<float*>(tap1 + tile);
  T* stage = reinterpret_cast<T*>(wxs + tile);
  T* ostage = stage + 2 * rows * stage_stride;
  const long row_elems = 3L * w;
  const long img = static_cast<long>(src_s) * h * row_elems;  // the source image's first element
  const int x0 = blockIdx.x * tile, x1 = min(w, x0 + tile);
  const int y0 = blockIdx.y * rows, n_rows = min(rows, h - y0);
  const int flip = gs[0], dy = gs[1], dx = gs[2];

  if (!gs[7]) {
    // each output row is one source row, shifted and possibly reversed,
    // plus runs of fill: the source run of every row staged, then written
    const int xa = max(x0, -dx), xb = max(xa, min(x1, w - dx));
    const int sa = flip ? w - xb - dx : xa + dx;  // the first source pixel read
    const int len = 3 * (xb - xa), seg_groups = (len + 2 * N - 2) / N;
#pragma unroll 4
    for (int i = t; i < n_rows * seg_groups; i += nt) {
      const int r = i / seg_groups, iy = y0 + r + dy;
      if (iy >= 0 && iy < h && len > 0)
        stage_group(images, img + iy * row_elems + 3L * sa, len, stage + r * stage_stride,
                    i - r * seg_groups);
    }
    __syncthreads();
    for (int r = 0; r < n_rows; ++r) {
      const int iy = y0 + r + dy;
      const bool row_in = iy >= 0 && iy < h;
      const long r_out = (static_cast<long>(b) * h + y0 + r) * row_elems;
      const T* src = stage + r * stage_stride +
                     static_cast<int>((img + iy * row_elems + 3L * sa) & (N - 1)) - 3 * sa;
      T* dst = ostage + r * out_stride + static_cast<int>((r_out + 3L * x0) & (N - 1)) - 3 * x0;
      for (int x = x0 + t; x < x1; x += nt) {
        if (row_in && x >= xa && x < xb) {
          const T* px = src + 3 * (flip ? w - 1 - (x + dx) : x + dx);
          dst[3 * x] = px[0];
          dst[3 * x + 1] = px[1];
          dst[3 * x + 2] = px[2];
        } else {
          for (int c = 0; c < 3; ++c) dst[3 * x + c] = store_value<T>(fs[c]);
        }
      }
    }
  } else {
    // resampled: output row y reads rows y0c and y1c of the translated,
    // flipped image; its columns' taps are the same for every row
    const int shx = gs[6], cw = gs[4], ch = gs[3];
    const int xa = max(x0, -shx), xb = max(xa, min(x1, cw - shx));
    int ta = 0, tb = 0;  // translated columns staged: [ta, tb)
    if (xa < xb) {
      const int lo =
          min(max(static_cast<int>(floorf(source_coord(xa + shx, qs[1]))), 0), w - 1);
      const int hi =
          min(max(static_cast<int>(floorf(source_coord(xb - 1 + shx, qs[1]))) + 1, 0), w - 1);
      ta = max(lo + dx, 0);
      tb = max(ta, min(hi + 1 + dx, w));
    }
    const int sa = flip ? w - tb : ta;  // the first source pixel staged
    for (int x = x0 + t; x < x1; x += nt) {
      int i0 = -2, i1 = -2;
      float wx = 0.0f;
      if (x >= xa && x < xb) {
        const float xs = source_coord(x + shx, qs[1]);
        const int xf = static_cast<int>(floorf(xs));
        wx = __fsub_rn(xs, static_cast<float>(xf));
        const int c0 = min(max(xf, 0), w - 1) + dx, c1 = min(max(xf + 1, 0), w - 1) + dx;
        i0 = (c0 < 0 || c0 >= w) ? -1 : 3 * ((flip ? w - 1 - c0 : c0) - sa);
        i1 = (c1 < 0 || c1 >= w) ? -1 : 3 * ((flip ? w - 1 - c1 : c1) - sa);
      }
      tap0[x - x0] = i0;
      tap1[x - x0] = i1;
      wxs[x - x0] = wx;
    }
    const int len = 3 * (tb - ta), seg_groups = (len + 2 * N - 2) / N;
#pragma unroll 4
    for (int i = t; i < 2 * n_rows * seg_groups; i += nt) {
      const int k = i / seg_groups, iy = y0 + k / 2 + gs[5];
      const int yf = static_cast<int>(floorf(source_coord(iy, qs[0])));
      const int ty = min(max(yf + (k & 1), 0), h - 1) + dy;
      if (iy >= 0 && iy < ch && ty >= 0 && ty < h && len > 0)
        stage_group(images, img + ty * row_elems + 3L * sa, len, stage + k * stage_stride,
                    i - k * seg_groups);
    }
    __syncthreads();
    for (int r = 0; r < n_rows; ++r) {
      const int iy = y0 + r + gs[5];
      const bool row_in = iy >= 0 && iy < ch;
      const float ys = source_coord(iy, qs[0]);
      const int yf = static_cast<int>(floorf(ys));
      const float wy = __fsub_rn(ys, static_cast<float>(yf)), owy = __fsub_rn(1.0f, wy);
      const int ty0 = min(max(yf, 0), h - 1) + dy, ty1 = min(max(yf + 1, 0), h - 1) + dy;
      const bool in0 = ty0 >= 0 && ty0 < h, in1 = ty1 >= 0 && ty1 < h;
      const long s0 = img + 3L * sa;
      const T* top = stage + (2 * r) * stage_stride +
                     static_cast<int>((s0 + ty0 * row_elems) & (N - 1));
      const T* bot = stage + (2 * r + 1) * stage_stride +
                     static_cast<int>((s0 + ty1 * row_elems) & (N - 1));
      const long r_out = (static_cast<long>(b) * h + y0 + r) * row_elems;
      T* dst = ostage + r * out_stride + static_cast<int>((r_out + 3L * x0) & (N - 1)) - 3 * x0;
      for (int x = x0 + t; x < x1; x += nt) {
        if (row_in && x >= xa && x < xb) {
          const int i0 = tap0[x - x0], i1 = tap1[x - x0];
          const float wx = wxs[x - x0], owx = __fsub_rn(1.0f, wx);
          for (int c = 0; c < 3; ++c) {
            const float f1 = fs[c];
            const float va = in0 && i0 >= 0 ? static_cast<float>(top[i0 + c]) : f1;
            const float vb = in0 && i1 >= 0 ? static_cast<float>(top[i1 + c]) : f1;
            const float vc = in1 && i0 >= 0 ? static_cast<float>(bot[i0 + c]) : f1;
            const float vd = in1 && i1 >= 0 ? static_cast<float>(bot[i1 + c]) : f1;
            const float up = __fadd_rn(__fmul_rn(va, owx), __fmul_rn(vb, wx));
            const float down = __fadd_rn(__fmul_rn(vc, owx), __fmul_rn(vd, wx));
            dst[3 * x + c] = store_value<T>(__fadd_rn(__fmul_rn(up, owy), __fmul_rn(down, wy)));
          }
        } else {
          for (int c = 0; c < 3; ++c) dst[3 * x + c] = store_value<T>(fs[3 + c]);
        }
      }
    }
  }
  __syncthreads();
  // the staged output rows to the output in 16-byte vectors
  const int out_groups = (3 * (x1 - x0) + 2 * N - 2) / N;  // per output row, at most
  for (int i = t; i < n_rows * out_groups; i += nt) {
    const int r = i / out_groups;
    const long r_out = (static_cast<long>(b) * h + y0 + r) * row_elems;
    const long a = r_out + 3L * x0, e = r_out + 3L * x1;
    const long base = a & ~static_cast<long>(N - 1);
    const long g = base + static_cast<long>(i - r * out_groups) * N;
    if (g >= e) continue;
    const int lo = lane_lo<N>(g, a), hi = lane_hi<N>(g, e);
    G v;
    load_group<T, IMAGE_BYTES>(ostage + r * out_stride, g - base, lo, hi, v);
    store_group<T, IMAGE_BYTES>(out, g, lo, hi, v);
  }
}

// The resize's arguments. Row band: start [h], weight [h, row_taps] (null
// when the rows keep their size); column band likewise over w, with
// col_span [column tiles, 2]: the first and end element (of an input row) of
// each column tile's staged span, and plane: the pixels of a staged row's
// channel plane.
struct Resize {
  int ih, iw, h, w;
  const int* row_start;
  const float* row_weight;
  int row_taps;
  const int* col_start;
  const float* col_weight;
  int col_taps;
  const int* col_span;
  int plane;
  int tile_y, tile_x;
  const float* boxes;  // [n_box] or null
  float* boxes_out;
  long n_box, box_chunk;
  float sy, sx;
};

// The resize's vectors: input groups of 8 bytes (8 uint8, the rows of the
// buckets' widths are 8-byte aligned) or 16 (4 float32); output groups of
// 16 bytes. Taps load RESIZE_TAPS at a time, all in flight together.
template <typename T>
struct ResizeVec {
  static constexpr int IN_BYTES = sizeof(T) == 1 ? 8 : 16;
  static constexpr int NI = IN_BYTES / static_cast<int>(sizeof(T));
  static constexpr int NO = 16 / static_cast<int>(sizeof(T));
};
constexpr int RESIZE_TAPS = 4;

constexpr int RGB = 3;  // the resize's channels

// Elements of a staged output row: its columns' elements at the output's
// vector phase.
template <typename T>
__host__ __device__ inline int resize_out_stride(int tile_x) {
  constexpr int NO = ResizeVec<T>::NO;
  return (tile_x * RGB + 2 * NO - 2) / NO * NO;
}

template <typename T>
__host__ __device__ inline long resize_smem_bytes(const Resize& p, bool rows, bool cols) {
  return (cols ? 4L * p.tile_y * RGB * p.plane +
                     static_cast<long>(sizeof(T)) * p.tile_y * resize_out_stride<T>(p.tile_x) +
                     4L * p.tile_x * (p.col_taps + 1)
               : 0L) +
         (rows ? 4L * p.tile_y * (p.row_taps + 1) : 0L);
}

// acc[l] += w_k * x_k[l] over the row taps k of the group at element `at`
// of output row r's first tap row, in tap order, RESIZE_TAPS loads at once.
template <typename T, int BYTES>
__device__ __forceinline__ void row_taps(const T* __restrict__ in, long at, long in_row, int lo,
                                         int hi, int start, const float* wt, int taps,
                                         float* acc) {
  constexpr int N = Group<T, BYTES>::N;
  for (int k0 = 0; k0 < taps; k0 += RESIZE_TAPS) {
    Group<T, BYTES> v[RESIZE_TAPS];
#pragma unroll
    for (int k = 0; k < RESIZE_TAPS; ++k)
      if (k0 + k < taps) load_group<T, BYTES>(in, at + (start + k0 + k) * in_row, lo, hi, v[k]);
#pragma unroll
    for (int k = 0; k < RESIZE_TAPS; ++k)
      if (k0 + k < taps) {
#pragma unroll
        for (int l = 0; l < N; ++l)
          acc[l] = __fadd_rn(acc[l], __fmul_rn(wt[k0 + k], static_cast<float>(v[k].e[l])));
      }
  }
}

// grid (column tiles, row tiles, n), block (x: along a row, y: rows).
// Output rows [oy0, oy0 + tile_y) x columns [ox0, ox0 + tile_x) of image n;
// ROWS and COLS say which axes are resized. Dynamic shared memory: the
// staged float32 rows [tile_y, 3, plane] (channel planes, so the columns
// pass's neighbouring threads read neighbouring words) and the staged
// output rows (T) when COLS, then the columns' band, then the rows' band.
template <typename T, bool ROWS, bool COLS>
__global__ void resize_aa_kernel(const T* __restrict__ in, T* __restrict__ out, Resize p) {
  constexpr int IB = ResizeVec<T>::IN_BYTES, NI = ResizeVec<T>::NI, NO = ResizeVec<T>::NO;
  extern __shared__ float4 resize_smem[];
  const int n = blockIdx.z;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nthreads = blockDim.x * blockDim.y;
  if (p.boxes_out != nullptr && blockIdx.x == 0 && blockIdx.y == 0) {
    const long b1 = min(p.n_box, (n + 1) * p.box_chunk);
    for (long t = n * p.box_chunk + tid; t < b1; t += nthreads)
      p.boxes_out[t] = __fmul_rn(p.boxes[t], (t & 1) ? p.sx : p.sy);
  }
  const int oy0 = blockIdx.y * p.tile_y, rows = min(p.tile_y, p.h - oy0);
  const int ox0 = blockIdx.x * p.tile_x, cols = min(p.tile_x, p.w - ox0);
  const int ostride = COLS ? resize_out_stride<T>(p.tile_x) : 0;
  float* tmp = reinterpret_cast<float*>(resize_smem);  // [tile_y, 3, plane] when COLS
  T* otile = reinterpret_cast<T*>(tmp + (COLS ? p.tile_y * RGB * p.plane : 0));
  float* cwt = reinterpret_cast<float*>(otile + p.tile_y * ostride);
  float* rwt = cwt + (COLS ? p.tile_x * p.col_taps : 0);
  int* cst = reinterpret_cast<int*>(rwt + (ROWS ? p.tile_y * p.row_taps : 0));
  int* rst = cst + (COLS ? p.tile_x : 0);
  if (ROWS) {
    for (int i = tid; i < rows * p.row_taps; i += nthreads)
      rwt[i] = p.row_weight[oy0 * p.row_taps + i];
    for (int i = tid; i < rows; i += nthreads) rst[i] = p.row_start[oy0 + i];
  }
  if (COLS) {
    for (int i = tid; i < cols * p.col_taps; i += nthreads) {
      const int j = i / p.col_taps;  // the weights tap-major: [col_taps, tile_x]
      cwt[(i - j * p.col_taps) * p.tile_x + j] = p.col_weight[ox0 * p.col_taps + i];
    }
    for (int i = tid; i < cols; i += nthreads) cst[i] = p.col_start[ox0 + i];
  }
  __syncthreads();
  const long in_row = static_cast<long>(p.iw) * RGB, out_row = static_cast<long>(p.w) * RGB;
  const long img = static_cast<long>(n) * p.ih * in_row;

  if (!COLS) {
    // the rows band straight to the output (the rows keep their width)
    for (int r = threadIdx.y; r < rows; r += blockDim.y) {
      const long r_out = (static_cast<long>(n) * p.h + oy0 + r) * out_row;
      const long a = r_out + static_cast<long>(ox0) * RGB, b = a + static_cast<long>(cols) * RGB;
      for (long g = (a & ~static_cast<long>(NI - 1)) + NI * threadIdx.x; g < b;
           g += NI * blockDim.x) {
        const int lo = lane_lo<NI>(g, a), hi = lane_hi<NI>(g, b);
        float acc[NI];
#pragma unroll
        for (int l = 0; l < NI; ++l) acc[l] = 0.0f;
        row_taps<T, IB>(in, img + (g - r_out), in_row, lo, hi, rst[r], rwt + r * p.row_taps,
                        p.row_taps, acc);
        Group<T, IB> o;
#pragma unroll
        for (int l = 0; l < NI; ++l) o.e[l] = store_value<T>(acc[l]);
        store_group<T, IB>(out, g, lo, hi, o);
      }
    }
    return;
  }

  // the rows pass (or the converted input rows) over this tile's span
  const int e0 = p.col_span[2 * blockIdx.x], e1 = p.col_span[2 * blockIdx.x + 1];
  const int px0 = e0 / RGB;
  for (int r = threadIdx.y; r < rows; r += blockDim.y) {
    for (int e = e0 + NI * threadIdx.x; e < e1; e += NI * blockDim.x) {
      const int hi = min(NI, e1 - e);
      float acc[NI];
      if (ROWS) {
#pragma unroll
        for (int l = 0; l < NI; ++l) acc[l] = 0.0f;
        row_taps<T, IB>(in, img + e, in_row, 0, hi, rst[r], rwt + r * p.row_taps, p.row_taps,
                        acc);
      } else {
        Group<T, IB> v;
        load_group<T, IB>(in, img + (oy0 + r) * in_row + e, 0, hi, v);
#pragma unroll
        for (int l = 0; l < NI; ++l) acc[l] = static_cast<float>(v.e[l]);
      }
      int x = e / RGB, c = e - x * RGB;
#pragma unroll
      for (int l = 0; l < NI; ++l) {
        if (l < hi) tmp[(r * RGB + c) * p.plane + x - px0] = acc[l];
        if (++c == RGB) {
          c = 0;
          ++x;
        }
      }
    }
  }
  __syncthreads();
  // the columns pass out of shared memory, one output pixel a thread, into
  // the staged output rows at the output's vector phase
  for (int r = threadIdx.y; r < rows; r += blockDim.y) {
    const long a = (static_cast<long>(n) * p.h + oy0 + r) * out_row + static_cast<long>(ox0) * RGB;
    T* orow = otile + r * ostride + static_cast<int>(a & (NO - 1));
    for (int j = threadIdx.x; j < cols; j += blockDim.x) {
      const float* x = tmp + r * RGB * p.plane + cst[j] - px0;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;  // each channel's sum in tap order
      for (int k = 0; k < p.col_taps; ++k) {
        const float wk = cwt[k * p.tile_x + j];
        a0 = __fadd_rn(a0, __fmul_rn(wk, x[k]));
        a1 = __fadd_rn(a1, __fmul_rn(wk, x[p.plane + k]));
        a2 = __fadd_rn(a2, __fmul_rn(wk, x[2 * p.plane + k]));
      }
      orow[3 * j] = store_value<T>(a0);
      orow[3 * j + 1] = store_value<T>(a1);
      orow[3 * j + 2] = store_value<T>(a2);
    }
  }
  __syncthreads();
  // the staged output rows to the output in 16-byte vectors
  for (int r = threadIdx.y; r < rows; r += blockDim.y) {
    const long a = (static_cast<long>(n) * p.h + oy0 + r) * out_row + static_cast<long>(ox0) * RGB;
    const long b = a + static_cast<long>(cols) * RGB, base = a & ~static_cast<long>(NO - 1);
    const T* orow = otile + r * ostride;
    for (long g = base + NO * threadIdx.x; g < b; g += NO * blockDim.x) {
      const int lo = lane_lo<NO>(g, a), hi = lane_hi<NO>(g, b);
      Group<T, 16> v;
      load_group<T, 16>(orow, g - base, lo, hi, v);
      store_group<T, 16>(out, g, lo, hi, v);
    }
  }
}

constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100 (opt-in above 48 KB)

// Opts a kernel in to `bytes` of dynamic shared memory above the default
// 48 KB, once per kernel and size (not per launch, so a captured launch
// makes no attribute call).
template <typename K>
cudaError_t allow_smem(K* kernel, long bytes) {
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  static std::mutex lock;
  static std::map<const void*, long> allowed;
  std::lock_guard<std::mutex> hold(lock);
  long& have = allowed[reinterpret_cast<const void*>(kernel)];
  if (bytes <= have) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
  if (e == cudaSuccess) have = bytes;
  return e;
}

// Opts a kernel in to clusters of more than 8 blocks, once per kernel.
template <typename K>
cudaError_t allow_cluster(K* kernel, int blocks) {
  if (blocks <= 8) return cudaSuccess;
  static std::mutex lock;
  static std::set<const void*> allowed;
  std::lock_guard<std::mutex> hold(lock);
  if (allowed.count(reinterpret_cast<const void*>(kernel))) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) allowed.insert(reinterpret_cast<const void*>(kernel));
  return e;
}

// grid (cluster, n) in clusters of (cluster, 1, 1) through cudaLaunchKernelEx.
template <typename T, typename Acc, bool GEOM>
int prepare_launch_as(const Geometry& p, const void* images, const void* geom_in, void* fills,
                      int cluster, int threads, cudaStream_t s) {
  auto* kernel = augment_prepare_kernel<T, Acc, GEOM>;
  cudaError_t e = allow_cluster(kernel, cluster);
  if (e != cudaSuccess) return static_cast<int>(e);
  using Sum = typename SumOf<T>::type;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, p.n, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = (8 + 6 * (threads / 32)) * sizeof(Sum) + sizeof(Decision);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p, static_cast<const T*>(images),
                         static_cast<const int*>(geom_in), static_cast<float*>(fills));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The prepare kernel for uint8 (is_u8) or float32 images: 32-bit uint8 sums
// while no channel of an image can reach 2^31.
template <bool GEOM>
int prepare_launch(const Geometry& p, const void* images, int is_u8, const void* geom_in,
                   void* fills, int cluster, int threads, cudaStream_t s) {
  if (p.n > 65535 || cluster < 1 || cluster > 16 || threads < 96 || threads > 1024 ||
      threads % 96 != 0 || 3LL * p.h * p.w >= (1LL << 31) - 16LL * threads ||
      static_cast<long long>(p.h) * cluster >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!is_u8)
    return prepare_launch_as<float, double, GEOM>(p, images, geom_in, fills, cluster, threads, s);
  if (255LL * p.h * p.w < (1LL << 31))
    return prepare_launch_as<unsigned char, unsigned int, GEOM>(p, images, geom_in, fills,
                                                                cluster, threads, s);
  return prepare_launch_as<unsigned char, unsigned long long, GEOM>(p, images, geom_in, fills,
                                                                    cluster, threads, s);
}

// The Geometry of the C interface's arguments (see augment_geometry_launch).
Geometry geometry_of(const void* boxes, const void* labels, const void* mask, const void* idx,
                     const void* aug, unsigned long long seed_mix, int hflip, int do_scale,
                     float scale_lo, float scale_span, int do_translate, float amp_y,
                     float amp_x, const void* flip_in, const void* shifts_in,
                     const void* jitter_in, const void* apply_in, int resample_mode, int n,
                     int g, int h, int w, void* boxes_out, void* labels_out, void* mask_out,
                     void* geom_out, void* draws_out) {
  Geometry p;
  p.boxes = static_cast<const float*>(boxes);
  p.labels = static_cast<const int*>(labels);
  p.mask = static_cast<const unsigned char*>(mask);
  p.idx = static_cast<const int*>(idx);
  p.aug = static_cast<const int*>(aug);
  p.seed_mix = seed_mix;
  p.hflip = hflip;
  p.do_scale = do_scale;
  p.do_translate = do_translate;
  p.scale_lo = scale_lo;
  p.scale_span = scale_span;
  p.amp_y = amp_y;
  p.amp_x = amp_x;
  p.flip_in = static_cast<const unsigned char*>(flip_in);
  p.shifts_in = static_cast<const int*>(shifts_in);
  p.jitter_in = static_cast<const int*>(jitter_in);
  p.apply_in = static_cast<const unsigned char*>(apply_in);
  p.resample_mode = resample_mode;
  p.n = n;
  p.g = g;
  p.h = h;
  p.w = w;
  p.boxes_out = static_cast<float*>(boxes_out);
  p.labels_out = static_cast<int*>(labels_out);
  p.mask_out = static_cast<unsigned char*>(mask_out);
  p.geom_out = static_cast<int*>(geom_out);
  p.draws_out = static_cast<float*>(draws_out);
  return p;
}

// Column tiles of at most max_tile pixels, as even as 4-pixel steps allow;
// `rows` output rows a block; threads: enough for per_thread pixels of a
// row each (32 to 1024).
template <typename T>
int image_launch(const void* images, const void* idx, const void* geom, const void* fills, int n,
                 int h, int w, int max_tile, int rows, int per_thread, void* out,
                 cudaStream_t s) {
  constexpr int N = Group<T, IMAGE_BYTES>::N;
  const int tiles0 = (w + max_tile - 1) / max_tile;
  const int tile = ((w + tiles0 - 1) / tiles0 + 3) / 4 * 4;
  const int tiles = (w + tile - 1) / tile;
  const int threads =
      std::min(1024, std::max(32, ((tile + per_thread - 1) / per_thread + 31) / 32 * 32));
  // a staged source row: a whole row (a resampled row's taps may span it)
  // at any vector phase; a staged output row: the tile's at any phase
  const int stage_stride = (3 * w + 2 * N - 2) / N * N;
  const int out_stride = (3 * tile + 2 * N - 2) / N * N;
  const long smem = 12L * tile + (2L * stage_stride + out_stride) * rows *
                                     static_cast<long>(sizeof(T));
  const cudaError_t e = allow_smem(augment_image_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  augment_image_kernel<T><<<dim3(tiles, (h + rows - 1) / rows, n), threads, smem, s>>>(
      static_cast<const T*>(images), static_cast<const int*>(idx), static_cast<const int*>(geom),
      static_cast<const float*>(fills), h, w, tile, rows, stage_stride, out_stride,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ROWS, bool COLS>
int resize_launch(const void* in, void* out, const Resize& p, int n, int threads_x, int threads_y,
                  cudaStream_t s) {
  const long smem = resize_smem_bytes<T>(p, ROWS, COLS);
  const cudaError_t e = allow_smem(resize_aa_kernel<T, ROWS, COLS>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.w + p.tile_x - 1) / p.tile_x, (p.h + p.tile_y - 1) / p.tile_y, n);
  resize_aa_kernel<T, ROWS, COLS><<<grid, dim3(threads_x, threads_y), smem, s>>>(
      static_cast<const T*>(in), static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int resize_modes(const void* in, void* out, const Resize& p, int n, int tx, int ty,
                 cudaStream_t s) {
  if (p.row_start != nullptr && p.col_start != nullptr)
    return resize_launch<T, true, true>(in, out, p, n, tx, ty, s);
  if (p.row_start != nullptr) return resize_launch<T, true, false>(in, out, p, n, tx, ty, s);
  return resize_launch<T, false, true>(in, out, p, n, tx, ty, s);
}

}  // namespace

extern "C" {

const char* image_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns the CUDA error of the launch (0 = cudaSuccess). Pointers that a
// mode does not use are null (see Geometry). A thread per (image, box): grid
// (n, box tiles) of up to 128 threads.
int augment_geometry_launch(const void* boxes, const void* labels, const void* mask,
                            const void* idx, const void* aug, unsigned long long seed_mix,
                            int hflip, int do_scale, float scale_lo, float scale_span,
                            int do_translate, float amp_y, float amp_x, const void* flip_in,
                            const void* shifts_in, const void* jitter_in, const void* apply_in,
                            int resample_mode, int n, int g, int h, int w, void* boxes_out,
                            void* labels_out, void* mask_out, void* geom_out, void* draws_out,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (g < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry p = geometry_of(boxes, labels, mask, idx, aug, seed_mix, hflip, do_scale,
                                 scale_lo, scale_span, do_translate, amp_y, amp_x, flip_in,
                                 shifts_in, jitter_in, apply_in, resample_mode, n, g, h, w,
                                 boxes_out, labels_out, mask_out, geom_out, draws_out);
  const int jobs = std::max(g, 1);
  const int threads = std::min(128, (jobs + 31) / 32 * 32);
  const int tiles = (jobs + threads - 1) / threads;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  augment_geometry_kernel<<<dim3(n, tiles), threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One launch: the geometry arguments of augment_geometry_launch (no draws)
// and the images (is_u8: uint8, else float32; [M, h, w, 3] read by idx, or
// [n, h, w, 3]) -> the box outputs, geom_out and fills [n, 2, 3]. A cluster
// of `cluster` blocks of `threads` threads (a multiple of 96) per image.
int augment_prepare_launch(const void* boxes, const void* labels, const void* mask,
                           const void* idx, const void* aug, unsigned long long seed_mix,
                           int hflip, int do_scale, float scale_lo, float scale_span,
                           int do_translate, float amp_y, float amp_x, const void* flip_in,
                           const void* shifts_in, const void* jitter_in, const void* apply_in,
                           int resample_mode, int n, int g, int h, int w, const void* images,
                           int is_u8, int cluster, int threads, void* boxes_out,
                           void* labels_out, void* mask_out, void* geom_out, void* fills,
                           void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (g < 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry p = geometry_of(boxes, labels, mask, idx, aug, seed_mix, hflip, do_scale,
                                 scale_lo, scale_span, do_translate, amp_y, amp_x, flip_in,
                                 shifts_in, jitter_in, apply_in, resample_mode, n, g, h, w,
                                 boxes_out, labels_out, mask_out, geom_out, nullptr);
  return prepare_launch<true>(p, images, is_u8, nullptr, fills, cluster, threads,
                              static_cast<cudaStream_t>(stream));
}

// The fills alone from the geometry rows geom [n, 8]: the prepare kernel
// without its geometry. images as in augment_prepare_launch.
int image_fill_launch(const void* images, const void* idx, const void* geom, int n, int h, int w,
                      int is_u8, int cluster, int threads, void* fills, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry p = geometry_of(nullptr, nullptr, nullptr, idx, nullptr, 0, 0, 0, 0.0f, 0.0f,
                                 0, 0.0f, 0.0f, nullptr, nullptr, nullptr, nullptr, 2, n, 0, h,
                                 w, nullptr, nullptr, nullptr, nullptr, nullptr);
  return prepare_launch<false>(p, images, is_u8, geom, fills, cluster, threads,
                               static_cast<cudaStream_t>(stream));
}

// fills may be null when no row reads a fill (flip only). max_tile: the
// most output pixels a block; rows: output rows a block; per_thread:
// pixels of a row a thread.
int augment_image_launch(const void* images, const void* idx, const void* geom, const void* fills,
                         int n, int h, int w, int is_u8, int max_tile, int rows, int per_thread,
                         void* out, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  if (max_tile < 4 || rows < 1 || per_thread < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_u8 ? image_launch<unsigned char>(images, idx, geom, fills, n, h, w, max_tile, rows,
                                             per_thread, out, s)
               : image_launch<float>(images, idx, geom, fills, n, h, w, max_tile, rows,
                                     per_thread, out, s);
}

// One launch: images [n, ih, iw, 3] -> out [n, h, w, 3] in the same dtype
// (is_u8: uint8, else float32). A band's pointers are null for an axis that
// keeps its size (not both). boxes_out null: no box scaling; else block
// (0, 0, i) scales elements [i * box_chunk, (i + 1) * box_chunk) of boxes.
int resize_aa_launch(const void* in, int is_u8, void* out, int n, int ih, int iw, int h, int w,
                     const void* row_start, const void* row_weight, int row_taps,
                     const void* col_start, const void* col_weight, int col_taps,
                     const void* col_span, int plane, int tile_y, int tile_x, int threads_x,
                     int threads_y, const void* boxes, void* boxes_out, long long n_box,
                     long long box_chunk, float sy, float sx, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  if ((row_start == nullptr && col_start == nullptr) || tile_x < 1 || tile_y < 1 ||
      (col_start != nullptr && (col_span == nullptr || plane < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Resize p;
  p.ih = ih;
  p.iw = iw;
  p.h = h;
  p.w = w;
  p.row_start = static_cast<const int*>(row_start);
  p.row_weight = static_cast<const float*>(row_weight);
  p.row_taps = row_taps;
  p.col_start = static_cast<const int*>(col_start);
  p.col_weight = static_cast<const float*>(col_weight);
  p.col_taps = col_taps;
  p.col_span = static_cast<const int*>(col_span);
  p.plane = plane;
  p.tile_y = tile_y;
  p.tile_x = tile_x;
  p.boxes = static_cast<const float*>(boxes);
  p.boxes_out = static_cast<float*>(boxes_out);
  p.n_box = boxes_out != nullptr ? n_box : 0;
  p.box_chunk = box_chunk;
  p.sy = sy;
  p.sx = sx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_u8 ? resize_modes<unsigned char>(in, out, p, n, threads_x, threads_y, s)
               : resize_modes<float>(in, out, p, n, threads_x, threads_y, s);
}

}  // extern "C"
