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
// What bounds it on the H100: neither bytes nor operations but latency. The
// serving head's GEMMs are [300 or 2400, 512] x [512, 21 or 84]: at M = 2400,
// N = 84 they move ~1.4 MB (0.6 us at 3.35 TB/s) for 206 M int8 operations
// (0.1 us at 1979 TOP/s). A kernel that walks K in steps of load, barrier,
// multiply, barrier pays one memory latency per step with nothing in flight
// while it computes (eight steps of 64 bytes take ~16 us at every shape), and
// large output tiles leave most of the 132 SMs idle at these M.
//
// What this design does about it:
//   * Tensor cores: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. x [M, K]
//     and wt [N, K] are both K-major, which is what the A (row) and B (col)
//     operands take, so nothing is transposed. N is padded up to a multiple
//     of 8 (21 -> 24, 84 -> 88) in shared memory only, with zeros.
//   * One-shot staging: a 256-thread block owns 32 rows of x and up to 128
//     columns (all of N on the head). It issues every load of its K range at
//     the start as 16-byte cp.async copies (32 x 512 + 88 x 512 bytes = 60 KB
//     at the head's reg shape), waits once and computes: one memory latency
//     instead of eight. K longer than 512 is staged in 512-byte chunks through
//     a two-stage ring, the next chunk in flight while this one is multiplied.
//   * Blocks: ceil(M / 32) x ceil(N / 128), 75 at M = 2400 (10 at M = 300).
//     Warp w multiplies rows 16 (w % 2) .. +15 against the 8-column tiles
//     w / 2, w / 2 + 4, ...; its A fragment is loaded once per 64 bytes of K
//     and reused across its column tiles.
//   * K order: integer sums are exact, so any permutation of K applied to both
//     operands gives the same result. Each thread loads 16 contiguous bytes of
//     a row (two k32 steps' worth) with one 128-bit shared load and feeds them
//     to the fragment slots of two MMAs; rows are padded so that these loads
//     hit 32 distinct banks per quarter warp.
//   * Any M, N, K: rows past M or N and bytes past K are zero-filled (cp.async
//     with a source size below 16). When K is not a multiple of 16 or a base
//     is not 16-byte aligned, the same tiles are filled byte by byte.
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
// dequantize_many_kernel is the same computation over every leaf of a list
// in one launch (ops/quant_ops.py::dequantize_many): the int8 serving path
// reconstructs all of its conv weights with it once per flush.
//
// What bounds it on the H100: bytes (1 byte read and 2 or 4 written per
// element, one multiply). The largest leaf on the serving path, layer4's
// 3x3x512x512 conv, is 2.4 M elements: 7.1 MB with a bfloat16 output, ~2 us;
// one flush's 23 conv weights are 11.8 M elements, 35 MB, ~10.5 us. A launch
// per leaf made the flush cost 23 launches and their tails: most leaves are
// small enough that the launch is their whole time.
//
// What the design does about it:
//   * 16 elements per thread, as two 8-byte loads and two 16-byte stores
//     (bfloat16) or four 4-byte loads and four 16-byte stores (float32), laid
//     out so that every load and store instruction of a warp covers one
//     contiguous span (one 16-byte load and 32 or 64 contiguous bytes of
//     stores per thread write half sectors, and measured slower in float32
//     than 4 elements per thread); a block covers 4096 elements, and all of a
//     thread's loads are in flight before its first store.
//   * The channel is found once per vector, with 32-bit index arithmetic
//     wherever the launch's indices fit; in the port's channel-first layout a
//     vector lies in one channel, so it loads one scale.
//   * Misaligned bases and the ragged end take a scalar path.
//   * Grouped: the wrapper builds a descriptor table once for a fixed list of
//     leaves (int8 and scale pointers, n, inner, channels, the output's offset
//     in one arena, the leaf's first block); block b finds its leaf by binary
//     search over the first blocks. The outputs are 256-byte aligned views of
//     one arena allocated per call, so no float copy outlives it.
//   * Writing the compute dtype directly halves the bytes written against f32
//     followed by a cast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MM_THREADS = 256;  // 8 warps
constexpr int MM_BM = 32;        // rows of x per block: two 16-row MMA tiles
constexpr int MM_MAX_NT = 16;    // 8-column MMA tiles per block (128 columns)
constexpr int MM_KC = 512;       // bytes of K staged at once
constexpr int MM_KB = 64;        // bytes of K per inner step: two k32 MMAs

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes) : "memory");
}

// Stage K bytes [k0, k0 + span) of x rows m0 .. m0 + MM_BM - 1 and wt rows
// n0 .. n0 + rows_w - 1 into xs [MM_BM][lds] and ws [rows_w][lds], zero past
// M, N and K. span is a multiple of MM_KB.
__device__ __forceinline__ void stage_chunk(int8_t* xs, int8_t* ws, const int8_t* x,
                                            const int8_t* wt, int m0, int n0, int rows_w,
                                            int m, int n, int k, int k0, int span, int lds,
                                            bool vec) {
  const int rows = MM_BM + rows_w;
  if (vec) {
    const int segs = span / 16;
    for (int t = threadIdx.x; t < rows * segs; t += MM_THREADS) {
      const int r = t / segs;
      const int kpos = k0 + (t - r * segs) * 16;
      const bool is_x = r < MM_BM;
      const int row = is_x ? m0 + r : n0 + r - MM_BM;
      const int8_t* base = is_x ? x : wt;
      int8_t* dst = is_x ? xs + r * lds : ws + (r - MM_BM) * lds;
      const int left = (row < (is_x ? m : n)) ? k - kpos : 0;
      const int bytes = left < 0 ? 0 : (left > 16 ? 16 : left);
      const int8_t* src = bytes > 0 ? base + static_cast<long long>(row) * k + kpos : base;
      cp_async16_zfill(dst + (kpos - k0), src, bytes);
    }
  } else {
    for (int t = threadIdx.x; t < rows * span; t += MM_THREADS) {
      const int r = t / span;
      const int c = t - r * span;
      const bool is_x = r < MM_BM;
      const int row = is_x ? m0 + r : n0 + r - MM_BM;
      const int8_t* base = is_x ? x : wt;
      int8_t* dst = is_x ? xs + r * lds : ws + (r - MM_BM) * lds;
      const bool in = row < (is_x ? m : n) && k0 + c < k;
      dst[c] = in ? base[static_cast<long long>(row) * k + k0 + c] : int8_t(0);
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(MM_THREADS)
int8_matmul_kernel(const int8_t* __restrict__ x,   // [M, K]
                   const int8_t* __restrict__ wt,  // [N, K]
                   int32_t* __restrict__ out,      // [M, N]
                   int m, int n, int k, int kc, int lds, int rows_w_max, bool vec) {
  extern __shared__ __align__(16) int8_t mm_smem[];
  const int stage_bytes = (MM_BM + rows_w_max) * lds;
  const int nt_all = (n + 7) / 8;
  const int nt0 = blockIdx.y * MM_MAX_NT;
  const int nt_blk = min(MM_MAX_NT, nt_all - nt0);
  const int rows_w = nt_blk * 8;
  const int m0 = blockIdx.x * MM_BM;
  const int n0 = nt0 * 8;
  const int chunks = (k + kc - 1) / kc;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // fragment row (A) / column (B, C)
  const int tig = lane & 3;   // thread in group: which 16 bytes of a 64-byte step
  const int mt = warp & 1;    // 16-row MMA tile
  const int wn = warp >> 1;   // first 8-column tile; then every 4th

  int acc[MM_MAX_NT / 4][4];
#pragma unroll
  for (int j = 0; j < MM_MAX_NT / 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  auto stage = [&](int c) {
    int8_t* xs = mm_smem + (c & 1) * stage_bytes;
    const int k0 = c * kc;
    const int span = ((min(kc, k - k0) + MM_KB - 1) / MM_KB) * MM_KB;
    stage_chunk(xs, xs + MM_BM * lds, x, wt, m0, n0, rows_w, m, n, k, k0, span, lds, vec);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (chunks > 0) stage(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int8_t* xs = mm_smem + (c & 1) * stage_bytes;
    const int8_t* ws = xs + MM_BM * lds;
    const int steps = (min(kc, k - c * kc) + MM_KB - 1) / MM_KB;
    const int8_t* xa = xs + (mt * 16 + g) * lds + tig * 16;
    for (int kb = 0; kb < steps; ++kb) {
      // bytes 0-7 of the thread's 16 feed the first k32 MMA (A slots a0/a2 of
      // row g, a1/a3 of row g + 8; B slots b0/b1), bytes 8-15 the second
      const uint4 lo = *reinterpret_cast<const uint4*>(xa + kb * MM_KB);
      const uint4 hi = *reinterpret_cast<const uint4*>(xa + 8 * lds + kb * MM_KB);
#pragma unroll
      for (int j = 0; j < MM_MAX_NT / 4; ++j) {
        const int nt = wn + 4 * j;
        if (nt < nt_blk) {
          const uint4 b =
              *reinterpret_cast<const uint4*>(ws + (nt * 8 + g) * lds + kb * MM_KB + tig * 16);
          mma_s8(acc[j], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
          mma_s8(acc[j], lo.z, hi.z, lo.w, hi.w, b.z, b.w);
        }
      }
    }
    __syncthreads();  // this stage is refilled two chunks on
  }

  // C fragment: c0, c1 at row g, columns 2 tig, 2 tig + 1; c2, c3 at row g + 8
#pragma unroll
  for (int j = 0; j < MM_MAX_NT / 4; ++j) {
    const int nt = wn + 4 * j;
    if (nt >= nt_blk) continue;
    const int col = n0 + nt * 8 + tig * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + mt * 16 + g + 8 * h;
      if (row >= m) continue;
      int32_t* o = out + static_cast<long long>(row) * n + col;
      if (col < n) o[0] = acc[j][2 * h];
      if (col + 1 < n) o[1] = acc[j][2 * h + 1];
    }
  }
}

int g_mm_smem_set = 48 * 1024;  // dynamic shared memory the GEMM may use so far

constexpr int DQ_THREADS = 256;
constexpr int DQ_PER_THREAD = 16;                     // elements per thread
constexpr int DQ_WARP = 32 * DQ_PER_THREAD;             // elements per warp
constexpr int DQ_BLOCK = DQ_THREADS * DQ_PER_THREAD;  // elements per block

// One leaf of a grouped dequantize, as the wrapper writes it: 8 int64 words.
struct DqLeaf {
  long long w;         // const int8_t*
  long long scale;     // const float*
  long long n;         // elements
  long long inner;     // elements per step of the channel
  long long channels;
  long long out_off;   // byte offset of the output in the arena (a multiple of 256)
  long long vec;       // w is 4- (float32) or 8-byte (bfloat16) aligned: vector loads
  long long block0;    // first block of the leaf: prefix sum of ceil(n / DQ_BLOCK)
};

// A thread's 16 elements are DQ_PER_THREAD / E vectors of E elements, E = 4
// for a float32 output (a 4-byte load, a 16-byte store) and 8 for bfloat16
// (an 8-byte load, a 16-byte store). Vector q of lane l starts at element
// q * 32 * E + l * E of its warp's DQ_WARP, so every load and store instruction
// of a warp covers one contiguous span.
template <typename Out> struct DqVec;
template <> struct DqVec<float> {
  static constexpr int E = 4;
  using Raw = int;
};
template <> struct DqVec<__nv_bfloat16> {
  static constexpr int E = 8;
  using Raw = int2;
};

// element offset of vector q of lane `lane` in its warp's span
template <int E>
__device__ __forceinline__ int vec_offset(int q, int lane) {
  return q * 32 * E + lane * E;
}

__device__ __forceinline__ float byte_at(int raw, int k) {
  return static_cast<float>(static_cast<int8_t>(raw >> (8 * k)));
}
__device__ __forceinline__ float byte_at(int2 raw, int k) {
  return byte_at(k < 4 ? raw.x : raw.y, k & 3);
}

__device__ __forceinline__ void store_vec(float* out, const float (&v)[4]) {
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* out, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(out) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ void store1(float* out, float v) { *out = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float v) { *out = __float2bfloat16_rn(v); }

// The 16 elements of lane `lane` in the warp span starting at element `base`
// of one tensor seen as [outer, channels, inner]. I is the index type: int
// where every index of the launch fits, else long long. vec: w is E-byte and
// out 16-byte aligned.
template <typename Out, typename I>
__device__ __forceinline__ void dequant_lane(const int8_t* __restrict__ w,
                                             const float* __restrict__ scale,
                                             Out* __restrict__ out, I n, I inner, I channels,
                                             bool vec, I base, int lane) {
  constexpr int E = DqVec<Out>::E;
  constexpr int V = DQ_PER_THREAD / E;
  using Raw = typename DqVec<Out>::Raw;
  Raw raw[V];
  if (vec) {  // every load in flight before the first store
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const I i = base + static_cast<I>(vec_offset<E>(q, lane));
      if (n - i >= E) raw[q] = __ldg(reinterpret_cast<const Raw*>(w + i));
    }
  }
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const I i = base + static_cast<I>(vec_offset<E>(q, lane));
    if (i >= n) return;
    const I outer = i / inner;
    I j = i - outer * inner;  // position along inner
    I c = outer % channels;
    if (vec && n - i >= E) {
      float v[E];
      if (j + E <= inner) {  // one channel for the whole vector: the port's layout
        const float s = scale[c];
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = __fmul_rn(byte_at(raw[q], e), s);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          v[e] = __fmul_rn(byte_at(raw[q], e), scale[c]);
          if (++j == inner) {
            j = 0;
            if (++c == channels) c = 0;
          }
        }
      }
      store_vec(out + i, v);
    } else {  // a misaligned base or the ragged end
      const int count = n - i < E ? static_cast<int>(n - i) : E;
      for (int e = 0; e < count; ++e) {
        store1(out + i + e, __fmul_rn(static_cast<float>(w[i + e]), scale[c]));
        if (++j == inner) {
          j = 0;
          if (++c == channels) c = 0;
        }
      }
    }
  }
}

template <typename Out, typename I>
__global__ void __launch_bounds__(DQ_THREADS)
dequantize_kernel(const int8_t* __restrict__ w,      // [outer, C, inner]
                  const float* __restrict__ scale,   // [C]
                  Out* __restrict__ out,             // like w
                  I n, I inner, I channels, bool vec) {
  const I base = static_cast<I>(blockIdx.x) * DQ_BLOCK + static_cast<I>(threadIdx.x >> 5) * DQ_WARP;
  dequant_lane<Out, I>(w, scale, out, n, inner, channels, vec, base, threadIdx.x & 31);
}

// Every leaf of a flush in one grid: block b belongs to the last leaf whose
// first block is <= b (empty leaves own no block).
template <typename Out, typename I>
__global__ void __launch_bounds__(DQ_THREADS)
dequantize_many_kernel(const DqLeaf* __restrict__ table, int leaves,
                       unsigned char* __restrict__ arena) {
  const long long b = blockIdx.x;
  int lo = 0;
  int hi = leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&table[mid].block0) <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const DqLeaf* leaf = table + lo;
  const I base = static_cast<I>(b - __ldg(&leaf->block0)) * DQ_BLOCK +
                 static_cast<I>(threadIdx.x >> 5) * DQ_WARP;
  dequant_lane<Out, I>(reinterpret_cast<const int8_t*>(__ldg(&leaf->w)),
                       reinterpret_cast<const float*>(__ldg(&leaf->scale)),
                       reinterpret_cast<Out*>(arena + __ldg(&leaf->out_off)),
                       static_cast<I>(__ldg(&leaf->n)), static_cast<I>(__ldg(&leaf->inner)),
                       static_cast<I>(__ldg(&leaf->channels)), __ldg(&leaf->vec) != 0, base,
                       threadIdx.x & 31);
}

// int indices are enough when every index a launch forms stays below 2^31
bool narrow(long long n) { return n <= 0x7fffffffLL - DQ_BLOCK; }

template <typename Out>
int dequantize_launch(const void* w, const void* scale, void* out, long long n,
                      long long inner, int channels, int vec, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((n + DQ_BLOCK - 1) / DQ_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  auto* o = static_cast<Out*>(out);
  if (narrow(n)) {
    dequantize_kernel<Out, int><<<blocks, DQ_THREADS, 0, s>>>(
        wq, sc, o, static_cast<int>(n), static_cast<int>(inner), channels, vec != 0);
  } else {
    dequantize_kernel<Out, long long><<<blocks, DQ_THREADS, 0, s>>>(
        wq, sc, o, n, inner, static_cast<long long>(channels), vec != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Out>
int dequantize_many_launch(const void* table, int leaves, long long blocks, long long max_n,
                           void* arena, void* stream) {
  if (leaves <= 0 || blocks <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const DqLeaf*>(table);
  auto* a = static_cast<unsigned char*>(arena);
  if (narrow(max_n)) {
    dequantize_many_kernel<Out, int><<<static_cast<unsigned>(blocks), DQ_THREADS, 0, s>>>(t, leaves, a);
  } else {
    dequantize_many_kernel<Out, long long><<<static_cast<unsigned>(blocks), DQ_THREADS, 0, s>>>(
        t, leaves, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [m, k] and wt [n, k] int8, row-major; out [m, n] int32. vec != 0 when k
// is a multiple of 16 and both bases are 16-byte aligned (cp.async copies).
// Returns the CUDA error of the launch (0 = cudaSuccess).
int int8_matmul_launch(const void* x, const void* wt, void* out, int m, int n, int k, int vec,
                       void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int kc = k <= 0 ? MM_KB : (k < MM_KC ? (k + MM_KB - 1) / MM_KB * MM_KB : MM_KC);
  // rows of 16 bytes x 4 threads: a row stride of 16 mod 32 words spreads
  // each quarter warp's 128-bit loads (rows g, g + 1) over all 32 banks
  const int lds = kc + ((kc / 4) % 32 == 0 ? 64 : 0);
  const int nt_all = (n + 7) / 8;
  const int rows_w_max = (nt_all < MM_MAX_NT ? nt_all : MM_MAX_NT) * 8;
  const int stages = k > kc ? 2 : 1;
  const int smem = stages * (MM_BM + rows_w_max) * lds;
  if (smem > g_mm_smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_mm_smem_set = smem;
  }
  const dim3 grid((m + MM_BM - 1) / MM_BM, (nt_all + MM_MAX_NT - 1) / MM_MAX_NT);
  int8_matmul_kernel<<<grid, MM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt), static_cast<int32_t*>(out),
      m, n, k, kc, lds, rows_w_max, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

// w int8 and out (float32 / bfloat16) hold n elements, seen as [outer, channels,
// inner]; scale [channels] float32. vec != 0 when w is 4-byte (float32 out)
// or 8-byte (bfloat16 out) aligned and out 16-byte aligned.
int dequantize_launch_f32(const void* w, const void* scale, void* out, long long n,
                          long long inner, int channels, int vec, void* stream) {
  return dequantize_launch<float>(w, scale, out, n, inner, channels, vec, stream);
}

int dequantize_launch_bf16(const void* w, const void* scale, void* out, long long n,
                           long long inner, int channels, int vec, void* stream) {
  return dequantize_launch<__nv_bfloat16>(w, scale, out, n, inner, channels, vec, stream);
}

// table: leaves x 8 int64 on the card (DqLeaf); blocks: the total of
// ceil(n / 4096) over the leaves; max_n: the largest leaf; arena: the
// outputs, each at its byte offset (256-byte aligned).
int dequantize_many_launch_f32(const void* table, int leaves, long long blocks, long long max_n,
                               void* arena, void* stream) {
  return dequantize_many_launch<float>(table, leaves, blocks, max_n, arena, stream);
}

int dequantize_many_launch_bf16(const void* table, int leaves, long long blocks, long long max_n,
                                void* arena, void* stream) {
  return dequantize_many_launch<__nv_bfloat16>(table, leaves, blocks, max_n, arena, stream);
}

int dequantize_block_elements() { return DQ_BLOCK; }

const char* quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
