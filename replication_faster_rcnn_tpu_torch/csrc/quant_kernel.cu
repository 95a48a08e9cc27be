// int8 kernels of the quantized serving path: an int8 x int8 -> int32 GEMM and
// a per-channel dequantize.
//
// int8_matmul_kernel replaces:
//   replication_faster_rcnn_tpu/ops/pallas/quant_kernel.py::_matmul_kernel
//   (pallas_call in _quant_matmul, wrapper quant_matmul_pallas).
// It computes x [M, K] int8 @ w [K, N] int8 -> [M, N] int32 with an int32
// accumulator, taking w as its transpose wt [N, K] (row-major, K contiguous:
// the port's Linear layout). Integer products and sums do not round, so the
// result is bitwise equal to the Pallas kernel and to the plain version
// (replication_faster_rcnn_tpu_torch/ops/quant_ops.py::int8_matmul_plain).
//
// What bounds it on the H100: bytes. The serving head's GEMMs are
// [300 or 2400, 512] x [512, 21 or 84]: at M = 2400, N = 21 they move ~1.4 MB
// (0.4 us at 3.35 TB/s) for 52 M int8 operations (0.03 us at 1979 TOP/s).
//
// What the design does about it: a simple shared-memory tiled kernel. The TPU
// kernel pads both operands to its (32, 128) int8 tile in device memory; here
// nothing is padded in device memory. A 256-thread block owns a 64 x 32 output
// tile and walks K in 64-byte steps: it stages 64 rows of x and 32 rows of wt
// as 32-bit words (4 int8 each) in shared memory, zero-filling past M, N and K
// (so any M, N and K work, K need not be a multiple of 4), and each thread
// accumulates 8 outputs of one column with __dp4a (4 signed byte products
// added to an int32 per instruction). The wt rows are padded to 17 words so
// that the 32 lanes of a warp read 32 banks; the x rows are read by the whole
// warp at once (a broadcast). Tensor cores (mma.sync / wgmma s8) and TMA are
// left for a later version: at these sizes the launch dominates.
//
// dequantize_kernel replaces:
//   replication_faster_rcnn_tpu/ops/pallas/quant_kernel.py::_dequant_kernel
//   (pallas_call in _dequantize, wrapper dequantize_pallas).
// It computes out[i] = float(w[i]) * scale[channel(i)] in float32 (one
// rounding), written as float32 or converted once, round-to-nearest-even, to
// bfloat16. The tensor is seen as [outer, C, inner] with the channel on the
// middle axis: inner = 1 is the JAX layout (channel last: HWIO, [in, out]),
// outer = 1 the port's (channel first: OIHW, Linear [out, in]). Plain version:
// ops/quant_ops.py::dequantize_plain, equal bit for bit.
//
// What bounds it on the H100: bytes (1 byte read and 2 or 4 written per
// element, one multiply). The largest leaf on the serving path, layer4's
// 3x3x512x512 conv, is 2.4 M elements: 7.1 MB with a bfloat16 output, ~2 us.
//
// What the design does about it: one pass, each thread 4 consecutive elements
// with one 4-byte load and one 8- or 16-byte store when aligned; the channel
// of the first element costs one division, the next three step a counter.
// Writing the compute dtype directly halves the bytes written against f32
// followed by a cast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MM_THREADS = 256;
constexpr int TILE_M = 64;
constexpr int TILE_N = 32;
constexpr int TILE_K = 64;                  // bytes of K per step
constexpr int K_WORDS = TILE_K / 4;         // 16 words of 4 int8
constexpr int LDS = K_WORDS + 1;            // padded shared-memory row, in words
constexpr int ROWS_PER_THREAD = TILE_M / (MM_THREADS / TILE_N);  // 8

// 4 int8 of row `row` starting at column k, packed little-endian (byte j of
// the word is column k + j) as __dp4a reads them; zero past the edges.
__device__ __forceinline__ int load_word(const int8_t* __restrict__ a, int row, int rows,
                                         int k, int cols, bool vec) {
  if (row >= rows || k >= cols) return 0;
  const int8_t* p = a + static_cast<long long>(row) * cols + k;
  if (vec && k + 4 <= cols) return *reinterpret_cast<const int*>(p);
  uint32_t word = 0;
  for (int j = 0; j < 4 && k + j < cols; ++j) {
    word |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * j);
  }
  return static_cast<int>(word);
}

__global__ void __launch_bounds__(MM_THREADS)
int8_matmul_kernel(const int8_t* __restrict__ x,   // [M, K]
                   const int8_t* __restrict__ wt,  // [N, K]
                   int32_t* __restrict__ out,      // [M, N]
                   int m_rows, int n_cols, int k_len, bool vec) {
  __shared__ int xs[TILE_M * LDS];
  __shared__ int ws[TILE_N * LDS];
  const int tid = threadIdx.x;
  const int tx = tid % TILE_N;  // output column within the tile
  const int ty = tid / TILE_N;  // rows ty * 8 .. ty * 8 + 7 of the tile
  const int m0 = blockIdx.y * TILE_M;
  const int n0 = blockIdx.x * TILE_N;

  int acc[ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] = 0;

  for (int k0 = 0; k0 < k_len; k0 += TILE_K) {
    for (int i = tid; i < TILE_M * K_WORDS; i += MM_THREADS) {
      const int r = i / K_WORDS, w = i % K_WORDS;
      xs[r * LDS + w] = load_word(x, m0 + r, m_rows, k0 + 4 * w, k_len, vec);
    }
    for (int i = tid; i < TILE_N * K_WORDS; i += MM_THREADS) {
      const int r = i / K_WORDS, w = i % K_WORDS;
      ws[r * LDS + w] = load_word(wt, n0 + r, n_cols, k0 + 4 * w, k_len, vec);
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < K_WORDS; ++w) {
      const int b = ws[tx * LDS + w];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r) {
        acc[r] = __dp4a(xs[(ty * ROWS_PER_THREAD + r) * LDS + w], b, acc[r]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= n_cols) return;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int m = m0 + ty * ROWS_PER_THREAD + r;
    if (m < m_rows) out[static_cast<long long>(m) * n_cols + n] = acc[r];
  }
}

constexpr int DQ_THREADS = 256;

__device__ __forceinline__ void store4(float* out, long long i, const float v[4], int count,
                                       bool vec) {
  if (vec && count == 4) {
    *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int e = 0; e < count; ++e) out[i + e] = v[e];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, long long i, const float v[4],
                                       int count, bool vec) {
  if (vec && count == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + i) = packed;
  } else {
    for (int e = 0; e < count; ++e) out[i + e] = __float2bfloat16_rn(v[e]);
  }
}

template <typename Out>
__global__ void __launch_bounds__(DQ_THREADS)
dequantize_kernel(const int8_t* __restrict__ w,      // [outer, C, inner]
                  const float* __restrict__ scale,   // [C]
                  Out* __restrict__ out,             // like w
                  long long n, long long inner, int channels, bool vec) {
  const long long i0 = (static_cast<long long>(blockIdx.x) * DQ_THREADS + threadIdx.x) * 4;
  if (i0 >= n) return;
  const int count = n - i0 < 4 ? static_cast<int>(n - i0) : 4;
  int8_t q[4];
  if (vec && count == 4) {
    const char4 c4 = *reinterpret_cast<const char4*>(w + i0);
    q[0] = c4.x; q[1] = c4.y; q[2] = c4.z; q[3] = c4.w;
  } else {
    for (int e = 0; e < count; ++e) q[e] = w[i0 + e];
  }
  const long long outer_idx = i0 / inner;
  long long j = i0 - outer_idx * inner;        // position along inner
  int c = static_cast<int>(outer_idx % channels);
  float v[4];
  for (int e = 0; e < count; ++e) {
    v[e] = __fmul_rn(static_cast<float>(q[e]), scale[c]);
    if (++j == inner) {
      j = 0;
      if (++c == channels) c = 0;
    }
  }
  store4(out, i0, v, count, vec);
}

template <typename Out>
int dequantize_launch(const void* w, const void* scale, void* out, long long n,
                      long long inner, int channels, int vec, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long threads_needed = (n + 3) / 4;
  const long long blocks = (threads_needed + DQ_THREADS - 1) / DQ_THREADS;
  dequantize_kernel<Out><<<static_cast<unsigned>(blocks), DQ_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<const float*>(scale), static_cast<Out*>(out),
      n, inner, channels, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [m, k] and wt [n, k] int8, row-major; out [m, n] int32. vec != 0 when k
// is a multiple of 4 and both bases are 4-byte aligned (word loads).
// Returns the CUDA error of the launch (0 = cudaSuccess).
int int8_matmul_launch(const void* x, const void* wt, void* out, int m, int n, int k, int vec,
                       void* stream) {
  if (m > 0 && n > 0) {
    const dim3 grid((n + TILE_N - 1) / TILE_N, (m + TILE_M - 1) / TILE_M);
    int8_matmul_kernel<<<grid, MM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
        static_cast<int32_t*>(out), m, n, k, vec != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// w int8 and out (float32 / bfloat16) hold n elements, seen as [outer, channels,
// inner]; scale [channels] float32. vec != 0 when w is 4-byte and out 16- /
// 8-byte aligned (vector loads and stores).
int dequantize_launch_f32(const void* w, const void* scale, void* out, long long n,
                          long long inner, int channels, int vec, void* stream) {
  return dequantize_launch<float>(w, scale, out, n, inner, channels, vec, stream);
}

int dequantize_launch_bf16(const void* w, const void* scale, void* out, long long n,
                           long long inner, int channels, int vec, void* stream) {
  return dequantize_launch<__nv_bfloat16>(w, scale, out, n, inner, channels, vec, stream);
}

const char* quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
