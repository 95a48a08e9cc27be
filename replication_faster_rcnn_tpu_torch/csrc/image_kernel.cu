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
//   * augment_geometry_kernel: one thread per image. The splitmix64 draws of
//     (seed, epoch, idx) in native uint64 (the plain version runs them on
//     32-bit limbs), the flip bit, the translation (dy, dx) and the jitter
//     geometry (ch, cw, shy, shx) in float32 as JAX does, or the host's
//     flip / shifts / jitter; then the box, label and mask transforms of
//     flip -> translate -> jitter, in JAX's order. Writes one int32 row of 8
//     per image: flip, dy, dx, ch, cw, shy, shx, resample.
//   * image_fill_kernel (two launches, one call): each image's two channel
//     fills. The translation's is the mean of the (flipped) image; the
//     jitter's is the mean of the translated image, computed as the source's
//     sum over the translation window plus the fill pixels times the first
//     fill, without the translated image. Sums in double in a fixed order:
//     partial sums per row band, then the bands in order. uint8 sums are
//     exact in double.
//   * augment_image_kernel: one thread per output pixel (3 channels). Reads
//     the source row (the batch's, or the cache's row idx[n]), and applies
//     flip -> translate (integer gather, fill) -> jitter (half-pixel bilinear
//     over the translated image with edge-clamped taps, fill outside
//     [0, ch) x [0, cw)). uint8 rounds half to even and clips after each op.
//   * resize_aa_kernel: jax.image.resize(method="bilinear", antialias=True)
//     as separable band passes (rows, then columns) with the band weights
//     the wrapper computed on the host, applied in tap order; a float32
//     intermediate; the last pass also scales the boxes.
//
// What bounds them on the H100: bytes. A 600x600 uint8 batch of 8 is 8.6 MB
// in and out (2.6 us at 3.35 TB/s), float32 four times that; the geometry
// kernel's work is a few hundred boxes. These first kernels are simple: the
// fill's bands give each image 16 blocks; the image and resize kernels read
// their taps through the cache. Float arithmetic is strict IEEE (-fmad=false)
// so the results repeat the plain versions' operations exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long GAMMA = 0x9E3779B97F4A7C15ull;
constexpr unsigned long long MIX_EPOCH = 0xBF58476D1CE4E5B9ull;
constexpr unsigned long long MIX_IDX = 0x94D049BB133111EBull;
constexpr int FILL_BANDS = 16;
constexpr int FILL_THREADS = 256;

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
  const float* boxes;          // [M or N, G, 4] (null when g == 0)
  const int* labels;           // [M or N, G]
  const unsigned char* mask;   // [M or N, G] or null
  const int* idx;              // [N] rows of boxes, or null
  const int* aug;              // [N, 2] (idx, epoch), or null
  unsigned long long seed_mix; // seed * GAMMA mod 2^64
  int hflip, do_scale, do_translate;
  float scale_lo, scale_span, amp_y, amp_x;
  const unsigned char* flip_in;  // [N] or null
  const int* shifts_in;          // [N, 2] or null
  const int* jitter_in;          // [N, 4] or null
  const unsigned char* apply_in; // [N] or null
  int resample_mode;  // image resample: 0 the rows whose boxes jitter, 1 all, 2 none
  int n, g, h, w;
  float* boxes_out;
  int* labels_out;
  unsigned char* mask_out;  // null when mask is null
  int* geom_out;            // [N, 8]
  float* draws_out;         // [N, 6] or null
};

__global__ void augment_geometry_kernel(Geometry p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  int flip = 0, dy = 0, dx = 0, ch = p.h, cw = p.w, shy = 0, shx = 0;
  int jitter = 0, apply_boxes = 0;
  const bool translate = p.aug != nullptr ? p.do_translate != 0 : p.shifts_in != nullptr;
  if (p.aug != nullptr) {
    const unsigned long long idx = static_cast<unsigned int>(p.aug[2 * i]);
    const unsigned long long epoch = static_cast<unsigned int>(p.aug[2 * i + 1]);
    unsigned long long z = splitmix(p.seed_mix + epoch * MIX_EPOCH + idx * MIX_IDX);
    const int bit = static_cast<int>(z & 1ull);
    float u[5];
    for (int k = 0; k < 5; ++k) {
      z = splitmix(z + GAMMA);
      u[k] = uniform24(z);
    }
    if (p.draws_out != nullptr) {
      float* d = p.draws_out + 6 * i;
      d[0] = static_cast<float>(bit);
      for (int k = 0; k < 5; ++k) d[k + 1] = u[k];
    }
    if (p.hflip) flip = bit;
    if (p.do_translate) {
      // round((2 u - 1) * amp), half to even
      dy = static_cast<int>(rintf(__fmul_rn(__fsub_rn(__fmul_rn(2.0f, u[3]), 1.0f), p.amp_y)));
      dx = static_cast<int>(rintf(__fmul_rn(__fsub_rn(__fmul_rn(2.0f, u[4]), 1.0f), p.amp_x)));
    }
    if (p.do_scale) {
      const float scale = __fadd_rn(p.scale_lo, __fmul_rn(p.scale_span, u[0]));
      ch = static_cast<int>(fmaxf(1.0f, rintf(__fmul_rn(static_cast<float>(p.h), scale))));
      cw = static_cast<int>(fmaxf(1.0f, rintf(__fmul_rn(static_cast<float>(p.w), scale))));
      shy = static_cast<int>(rintf(__fmul_rn(static_cast<float>(ch - p.h), clipf(u[1], 0.0f, 1.0f))));
      shx = static_cast<int>(rintf(__fmul_rn(static_cast<float>(cw - p.w), clipf(u[2], 0.0f, 1.0f))));
      jitter = 1;
      apply_boxes = ch != p.h || cw != p.w || shy != 0 || shx != 0;
    }
  } else {
    if (p.flip_in != nullptr) flip = p.flip_in[i] != 0;
    if (p.shifts_in != nullptr) {
      dy = p.shifts_in[2 * i];
      dx = p.shifts_in[2 * i + 1];
    }
    if (p.jitter_in != nullptr) {
      ch = p.jitter_in[4 * i];
      cw = p.jitter_in[4 * i + 1];
      shy = p.jitter_in[4 * i + 2];
      shx = p.jitter_in[4 * i + 3];
      jitter = 1;
      apply_boxes = p.apply_in != nullptr
                        ? p.apply_in[i] != 0
                        : (ch != p.h || cw != p.w || shy != 0 || shx != 0);
    }
  }
  int* geom = p.geom_out + 8 * i;
  geom[0] = flip;
  geom[1] = dy;
  geom[2] = dx;
  geom[3] = ch;
  geom[4] = cw;
  geom[5] = shy;
  geom[6] = shx;
  geom[7] = jitter && p.resample_mode != 2 && (p.resample_mode == 1 || apply_boxes);
  if (p.g == 0) return;

  const float hf = static_cast<float>(p.h), wf = static_cast<float>(p.w);
  const float sy = __fdiv_rn(static_cast<float>(ch), hf);
  const float sx = __fdiv_rn(static_cast<float>(cw), wf);
  const float fy = static_cast<float>(shy), fx = static_cast<float>(shx);
  const float tdy = static_cast<float>(dy), tdx = static_cast<float>(dx);
  const long src = p.idx != nullptr ? p.idx[i] : i;
  for (int j = 0; j < p.g; ++j) {
    const long at = src * p.g + j;
    const float4 in = reinterpret_cast<const float4*>(p.boxes)[at];
    float b0 = in.x, b1 = in.y, b2 = in.z, b3 = in.w;
    int label = p.labels[at];
    unsigned char m = p.mask != nullptr ? p.mask[at] : 0;
    if (flip && label >= 0) {  // (y1, x1, y2, x2) -> (y1, W - x2, y2, W - x1)
      const float n1 = __fsub_rn(wf, b3), n3 = __fsub_rn(wf, b1);
      b1 = n1;
      b3 = n3;
    }
    if (translate && label >= 0) {
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
    if (apply_boxes && label >= 0) {
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
}

template <typename T>
__device__ __forceinline__ double as_double(T v) {
  return static_cast<double>(v);
}

// The translation window of image n in source coordinates: rows [r0, r1),
// columns [c0, c1) of the flipped-and-translated frame's valid reads.
struct Window {
  int r0, r1, c0, c1;
};

__device__ __forceinline__ Window window_of(const int* geom, int h, int w) {
  const int flip = geom[0], dy = geom[1], dx = geom[2];
  Window win;
  win.r0 = max(0, dy);
  win.r1 = min(h, h + dy);
  const int f0 = max(0, dx), f1 = min(w, w + dx);  // columns of the flipped frame
  win.c0 = flip ? w - f1 : f0;
  win.c1 = flip ? w - f0 : f1;
  return win;
}

// grid (FILL_BANDS, N): block (band, n) sums rows [band * h / B, (band+1) * h / B)
// of image n: all pixels, and those inside the translation window. partial is
// [N, FILL_BANDS, 2, 3] double.
template <typename T>
__global__ void image_fill_kernel(const T* images, const int* idx, const int* geom, int h, int w,
                                  double* partial) {
  const int band = blockIdx.x, n = blockIdx.y;
  const long src = idx != nullptr ? idx[n] : n;
  const T* im = images + src * static_cast<long>(h) * w * 3;
  const Window win = window_of(geom + 8 * n, h, w);
  const int r0 = band * h / FILL_BANDS, r1 = (band + 1) * h / FILL_BANDS;
  double all[3] = {0.0, 0.0, 0.0}, in[3] = {0.0, 0.0, 0.0};
  const long count = static_cast<long>(r1 - r0) * w;
  for (long p = threadIdx.x; p < count; p += blockDim.x) {
    const int y = r0 + static_cast<int>(p / w), x = static_cast<int>(p % w);
    const T* px = im + (static_cast<long>(y) * w + x) * 3;
    const bool inside = y >= win.r0 && y < win.r1 && x >= win.c0 && x < win.c1;
    for (int c = 0; c < 3; ++c) {
      const double v = as_double(px[c]);
      all[c] += v;
      if (inside) in[c] += v;
    }
  }
  __shared__ double red[FILL_THREADS][6];
  for (int c = 0; c < 3; ++c) {
    red[threadIdx.x][c] = all[c];
    red[threadIdx.x][3 + c] = in[c];
  }
  __syncthreads();
  for (int stride = FILL_THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride)
      for (int k = 0; k < 6; ++k) red[threadIdx.x][k] += red[threadIdx.x + stride][k];
    __syncthreads();
  }
  if (threadIdx.x < 6) partial[(static_cast<long>(n) * FILL_BANDS + band) * 6 + threadIdx.x] =
      red[0][threadIdx.x];
}

// one thread per image: the bands in order, then the two fills ([N, 2, 3]
// float32). uint8 fills are round-half-even and clipped to [0, 255].
__global__ void image_fill_finish_kernel(const double* partial, const int* geom, int n, int h,
                                         int w, int is_u8, float* fills) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Window win = window_of(geom + 8 * i, h, w);
  const double area = static_cast<double>(h) * w;
  const double n_fill =
      area - static_cast<double>(max(0, win.r1 - win.r0)) * max(0, win.c1 - win.c0);
  for (int c = 0; c < 3; ++c) {
    double all = 0.0, in = 0.0;
    for (int b = 0; b < FILL_BANDS; ++b) {
      all += partial[(static_cast<long>(i) * FILL_BANDS + b) * 6 + c];
      in += partial[(static_cast<long>(i) * FILL_BANDS + b) * 6 + 3 + c];
    }
    double f1 = all / area;
    if (is_u8) f1 = fmin(fmax(rint(f1), 0.0), 255.0);
    const float fill1 = static_cast<float>(f1);
    double f2 = (in + n_fill * static_cast<double>(fill1)) / area;
    if (is_u8) f2 = fmin(fmax(rint(f2), 0.0), 255.0);
    fills[6 * i + c] = fill1;
    fills[6 * i + 3 + c] = static_cast<float>(f2);
  }
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

// The translated, flipped image's value at (y, x), channel c, as float.
template <typename T>
__device__ __forceinline__ float translated(const T* im, int y, int x, int c, int h, int w,
                                            int flip, int dy, int dx, const float* fill1) {
  const int iy = y + dy, ix = x + dx;
  if (iy < 0 || iy >= h || ix < 0 || ix >= w) return fill1[c];
  const int sx = flip ? w - 1 - ix : ix;
  return static_cast<float>(im[(static_cast<long>(iy) * w + sx) * 3 + c]);
}

template <typename T>
__global__ void augment_image_kernel(const T* images, const int* idx, const int* geom,
                                     const float* fills, int n, int h, int w, T* out) {
  const long pix = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  const long per_image = static_cast<long>(h) * w;
  if (pix >= per_image * n) return;
  const int b = static_cast<int>(pix / per_image);
  const int y = static_cast<int>((pix % per_image) / w), x = static_cast<int>(pix % w);
  const long src = idx != nullptr ? idx[b] : b;
  const T* im = images + src * per_image * 3;
  const int* g = geom + 8 * b;
  const int flip = g[0], dy = g[1], dx = g[2];
  const float zero[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float* f = fills != nullptr ? fills + 6 * b : zero;
  T* o = out + pix * 3;
  if (!g[7]) {
    for (int c = 0; c < 3; ++c) {
      const int iy = y + dy, ix = x + dx;
      if (iy < 0 || iy >= h || ix < 0 || ix >= w) {
        o[c] = store_value<T>(f[c]);
      } else {
        o[c] = im[(static_cast<long>(iy) * w + (flip ? w - 1 - ix : ix)) * 3 + c];
      }
    }
    return;
  }
  const int ch = g[3], cw = g[4];
  const int iy = y + g[5], ix = x + g[6];
  const bool valid = iy >= 0 && iy < ch && ix >= 0 && ix < cw;
  const float ys = __fsub_rn(
      __fmul_rn(__fadd_rn(static_cast<float>(iy), 0.5f),
                __fdiv_rn(static_cast<float>(h), static_cast<float>(ch))),
      0.5f);
  const float xs = __fsub_rn(
      __fmul_rn(__fadd_rn(static_cast<float>(ix), 0.5f),
                __fdiv_rn(static_cast<float>(w), static_cast<float>(cw))),
      0.5f);
  const int y0 = static_cast<int>(floorf(ys)), x0 = static_cast<int>(floorf(xs));
  const float wy = __fsub_rn(ys, static_cast<float>(y0));
  const float wx = __fsub_rn(xs, static_cast<float>(x0));
  const int y0c = min(max(y0, 0), h - 1), y1c = min(max(y0 + 1, 0), h - 1);
  const int x0c = min(max(x0, 0), w - 1), x1c = min(max(x0 + 1, 0), w - 1);
  const float owy = __fsub_rn(1.0f, wy), owx = __fsub_rn(1.0f, wx);
  for (int c = 0; c < 3; ++c) {
    float v;
    if (valid) {
      const float a = translated(im, y0c, x0c, c, h, w, flip, dy, dx, f);
      const float bb = translated(im, y0c, x1c, c, h, w, flip, dy, dx, f);
      const float cc = translated(im, y1c, x0c, c, h, w, flip, dy, dx, f);
      const float d = translated(im, y1c, x1c, c, h, w, flip, dy, dx, f);
      const float top = __fadd_rn(__fmul_rn(a, owx), __fmul_rn(bb, wx));
      const float bot = __fadd_rn(__fmul_rn(cc, owx), __fmul_rn(d, wx));
      v = __fadd_rn(__fmul_rn(top, owy), __fmul_rn(bot, wy));
    } else {
      v = f[3 + c];
    }
    o[c] = store_value<T>(v);
  }
}

// One separable band pass of the antialiased resize: in [outer, len_in, inner]
// -> out [outer, len_out, inner], out[o] = sum_k weight[o, k] * in[start[o] + k]
// accumulated from 0 in tap order. The last pass also scales n_box box
// coordinates by (sy, sx, sy, sx).
template <typename Tin, typename Tout>
__global__ void resize_aa_kernel(const Tin* in, Tout* out, const int* start, const float* weight,
                                 int taps, long outer, int len_in, int len_out, long inner,
                                 const float* boxes, float* boxes_out, long n_box, float sy,
                                 float sx) {
  const long t = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (boxes_out != nullptr && t < n_box) {
    boxes_out[t] = __fmul_rn(boxes[t], (t & 1) ? sx : sy);
  }
  const long total = outer * len_out * inner;
  if (t >= total) return;
  const long i = t % inner;
  const int o = static_cast<int>((t / inner) % len_out);
  const long r = t / (inner * len_out);
  const Tin* base = in + r * len_in * inner + i;
  const int s = start[o];
  const float* wt = weight + static_cast<long>(o) * taps;
  float acc = 0.0f;
  for (int k = 0; k < taps; ++k) {
    acc = __fadd_rn(acc, __fmul_rn(wt[k], static_cast<float>(base[(s + k) * inner])));
  }
  out[t] = store_value<Tout>(acc);
}

constexpr int THREADS = 256;

template <typename T>
int fill_launch(const void* images, const void* idx, const void* geom, int n, int h, int w,
                void* partial, void* fills, cudaStream_t s) {
  image_fill_kernel<T><<<dim3(FILL_BANDS, n), FILL_THREADS, 0, s>>>(
      static_cast<const T*>(images), static_cast<const int*>(idx),
      static_cast<const int*>(geom), h, w, static_cast<double*>(partial));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  image_fill_finish_kernel<<<(n + 31) / 32, 32, 0, s>>>(
      static_cast<const double*>(partial), static_cast<const int*>(geom), n, h, w,
      sizeof(T) == 1, static_cast<float*>(fills));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int image_launch(const void* images, const void* idx, const void* geom, const void* fills, int n,
                 int h, int w, void* out, cudaStream_t s) {
  const long total = static_cast<long>(n) * h * w;
  augment_image_kernel<T><<<static_cast<unsigned>((total + THREADS - 1) / THREADS), THREADS, 0,
                            s>>>(static_cast<const T*>(images), static_cast<const int*>(idx),
                                 static_cast<const int*>(geom), static_cast<const float*>(fills),
                                 n, h, w, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int resize_launch(const void* in, void* out, const void* start, const void* weight, int taps,
                  long outer, int len_in, int len_out, long inner, const void* boxes,
                  void* boxes_out, long n_box, float sy, float sx, cudaStream_t s) {
  long total = outer * len_out * inner;
  if (n_box > total) total = n_box;
  resize_aa_kernel<Tin, Tout><<<static_cast<unsigned>((total + THREADS - 1) / THREADS), THREADS,
                                0, s>>>(
      static_cast<const Tin*>(in), static_cast<Tout*>(out), static_cast<const int*>(start),
      static_cast<const float*>(weight), taps, outer, len_in, len_out, inner,
      static_cast<const float*>(boxes), static_cast<float*>(boxes_out), n_box, sy, sx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* image_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns the CUDA error of the launch (0 = cudaSuccess). Pointers that a
// mode does not use are null (see Geometry).
int augment_geometry_launch(const void* boxes, const void* labels, const void* mask,
                            const void* idx, const void* aug, unsigned long long seed_mix,
                            int hflip, int do_scale, float scale_lo, float scale_span,
                            int do_translate, float amp_y, float amp_x, const void* flip_in,
                            const void* shifts_in, const void* jitter_in, const void* apply_in,
                            int resample_mode, int n, int g, int h, int w, void* boxes_out,
                            void* labels_out, void* mask_out, void* geom_out, void* draws_out,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
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
  augment_geometry_kernel<<<(n + 31) / 32, 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// is_u8: images are uint8, else float32. partial: [N, 16, 6] double scratch.
int image_fill_launch(const void* images, const void* idx, const void* geom, int n, int h, int w,
                      int is_u8, void* partial, void* fills, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_u8 ? fill_launch<unsigned char>(images, idx, geom, n, h, w, partial, fills, s)
               : fill_launch<float>(images, idx, geom, n, h, w, partial, fills, s);
}

// fills may be null when no row reads a fill (flip only).
int augment_image_launch(const void* images, const void* idx, const void* geom, const void* fills,
                         int n, int h, int w, int is_u8, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_u8 ? image_launch<unsigned char>(images, idx, geom, fills, n, h, w, out, s)
               : image_launch<float>(images, idx, geom, fills, n, h, w, out, s);
}

// One band pass. in_kind / out_kind: 0 float32, 1 uint8. boxes_out null: no
// box scaling in this pass.
int resize_aa_launch(const void* in, int in_kind, void* out, int out_kind, const void* start,
                     const void* weight, int taps, long long outer, int len_in, int len_out,
                     long long inner, const void* boxes, void* boxes_out, long long n_box,
                     float sy, float sx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (outer * len_out * inner <= 0 && n_box <= 0) return static_cast<int>(cudaGetLastError());
  if (in_kind == 0 && out_kind == 0)
    return resize_launch<float, float>(in, out, start, weight, taps, outer, len_in, len_out, inner,
                                       boxes, boxes_out, n_box, sy, sx, s);
  if (in_kind == 1 && out_kind == 0)
    return resize_launch<unsigned char, float>(in, out, start, weight, taps, outer, len_in,
                                               len_out, inner, boxes, boxes_out, n_box, sy, sx, s);
  if (in_kind == 0 && out_kind == 1)
    return resize_launch<float, unsigned char>(in, out, start, weight, taps, outer, len_in,
                                               len_out, inner, boxes, boxes_out, n_box, sy, sx, s);
  return resize_launch<unsigned char, unsigned char>(in, out, start, weight, taps, outer, len_in,
                                                     len_out, inner, boxes, boxes_out, n_box, sy,
                                                     sx, s);
}

}  // extern "C"
