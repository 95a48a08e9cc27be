// An alternative design of the multi-level ROIAlign forward, kept for
// timing: the staged forward (s = 2). One block per (roi, MLF_CT channels)
// lists the roi's distinct tap columns (at most 2*out*s) and each bin row's
// distinct tap rows (at most 2s), and copies those pixels' channel tiles
// into a ring of MLF_STAGES shared-memory stages with cp.async, bin row py +
// MLF_STAGES - 1 in flight while bin row py is summed, with the direct
// kernel's arithmetic (bitwise the same outputs). It measured slower than
// the direct kernel with s = 2 unrolled (PERF.md, section 6).
//
// Not a translation unit of its own: tools/roi_multilevel_variants.py
// inserts this text into replication_faster_rcnn_tpu_torch/csrc/roi_align_kernel.cu
// before sm_count() and routes launch_multilevel_fwd's s = 2, 8-channel
// vector calls to launch_staged, which uses that file's helpers (Pyramid,
// pick_level, level_roi, sample_axis, load8, store8, tap_sum).

constexpr int MLF_CT = 32;       // channels of a staged forward block
constexpr int MLF_THREADS = 32;  // threads of a staged forward block
constexpr int MLF_STAGES = 2;    // bin rows in the ring
constexpr int MLF_ROWS = 4;      // distinct tap rows of a bin row at s = 2
static_assert(MLF_CT % 8 == 0, "a staged channel tile is whole 8-channel vectors");

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Append tap index v to a sorted list of distinct taps and return its
// slot. Taps come in sample order (i0, i1 of sample 0, then of sample 1,
// ...), and both i0 and i1 are monotone in the sample index with i1 <= i0
// + 1, so a tap not above the last one listed is the last or the one
// before it.
__device__ __forceinline__ int list_tap(int* list, int& count, int v) {
  if (count == 0 || v > list[count - 1]) {
    list[count++] = v;
    return count - 1;
  }
  return v == list[count - 1] ? count - 1 : count - 2;
}

// The staged forward at s = 2 (see the note above): one block per (image x
// roi, tile of MLF_CT channels); C is a multiple of 8 and every base is
// 16-byte aligned.
template <typename T, typename O>
__global__ void __launch_bounds__(MLF_THREADS)
multilevel_roi_align_staged_kernel(Pyramid<const T> pyr,           // P2..P5 [N, Hl, Wl, C]
                                   const float* __restrict__ rois,  // [N, R, 4] image coords
                                   const int* __restrict__ levels,  // [N, R] 0..3
                                   float img_h, float img_w, int c, int r, int out,
                                   O* __restrict__ dst) {           // [N, R, out, out, C]
  constexpr int S = 2;
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int p_total = out * S;
  const int dmax = 2 * p_total;  // distinct tap columns at most
  T* ring = reinterpret_cast<T*>(smem);  // [MLF_STAGES][MLF_ROWS][dmax][MLF_CT]
  Axis* axes = reinterpret_cast<Axis*>(ring + MLF_STAGES * MLF_ROWS * dmax * MLF_CT);  // [2P]
  int* col_list = reinterpret_cast<int*>(axes + 2 * p_total);  // [dmax] distinct tap columns
  int* row_list = col_list + dmax;                             // [out][MLF_ROWS] per bin row
  int* counts = row_list + out * MLF_ROWS;                     // [out] rows, then columns
  short* col_slot = reinterpret_cast<short*>(counts + out + 1);  // [P][2] of i0, i1
  short* row_slot = col_slot + 2 * p_total;                      // [P][2] in its bin row

  const int t = threadIdx.x;
  const int64_t nr = blockIdx.x;  // n * R + roi
  const int n = static_cast<int>(nr / r);
  const Level<const T> level = pick_level(pyr, roi_level(levels, nr));
  const int h = level.h, w = level.w;
  const LevelRoi lr = level_roi(rois + nr * 4, h, w, img_h, img_w, out);
  for (int k = t; k < 2 * p_total; k += MLF_THREADS) {
    axes[k] = k < p_total ? sample_axis(lr.r1, lr.bin_h, k, S, h)
                          : sample_axis(lr.c1, lr.bin_w, k - p_total, S, w);
  }
  __syncthreads();
  for (int py = t; py <= out; py += MLF_THREADS) {  // each bin row's rows; py == out: columns
    const bool cols = py == out;
    int* list = cols ? col_list : row_list + py * MLF_ROWS;
    short* slot = cols ? col_slot : row_slot + 2 * py * S;
    const Axis* a = cols ? axes + p_total : axes + py * S;
    int count = 0;
    for (int k = 0; k < (cols ? p_total : S); ++k) {
      slot[2 * k] = static_cast<short>(list_tap(list, count, a[k].i0));
      slot[2 * k + 1] = static_cast<short>(list_tap(list, count, a[k].i1));
    }
    counts[py] = count;
  }
  __syncthreads();

  const int ct0 = blockIdx.y * MLF_CT;
  const int nc = min(MLF_CT, c - ct0);  // channels of this tile, a multiple of 8
  const int chunks = nc / V;            // 16-byte copies per pixel
  const int n_cols = counts[out];
  const T* img = level.base + static_cast<int64_t>(n) * h * w * c + ct0;
  const int stage_elems = MLF_ROWS * dmax * MLF_CT;

  auto issue = [&](int py) {  // bin row py's pixels into its stage
    T* buf = ring + (py % MLF_STAGES) * stage_elems;
    const int* rows = row_list + py * MLF_ROWS;
    const int total = counts[py] * n_cols * chunks;
    for (int e = t; e < total; e += MLF_THREADS) {
      const int q = e % chunks, pix = e / chunks;
      const int b = pix % n_cols, a = pix / n_cols;
      cp_async16(buf + (a * dmax + b) * MLF_CT + q * V,
                 img + (static_cast<int64_t>(rows[a]) * w + col_list[b]) * c + q * V);
    }
  };

#pragma unroll
  for (int k = 0; k < MLF_STAGES - 1; ++k) {
    if (k < out) issue(k);
    cp_async_commit();
  }
  const int groups = nc / 8;
  const int bins = out * out;
  const float inv_ns = __fdiv_rn(1.f, static_cast<float>(S * S));  // exact: S*S is 4
  for (int py = 0; py < out; ++py) {
    if (py + MLF_STAGES - 1 < out) issue(py + MLF_STAGES - 1);
    cp_async_commit();
    cp_async_wait<MLF_STAGES - 1>();  // bin row py's copies have landed
    __syncthreads();
    const T* buf = ring + (py % MLF_STAGES) * stage_elems;
    for (int e = t; e < out * groups; e += MLF_THREADS) {
      const int px = e / groups, g = e % groups;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
      for (int iy = 0; iy < S; ++iy) {
        const int ky = py * S + iy;
        const Axis ay = axes[ky];
        const T* row0 = buf + row_slot[2 * ky] * dmax * MLF_CT + g * 8;
        const T* row1 = buf + row_slot[2 * ky + 1] * dmax * MLF_CT + g * 8;
#pragma unroll
        for (int ix = 0; ix < S; ++ix) {
          const int kx = px * S + ix;
          const Axis ax = axes[p_total + kx];
          const int x0 = col_slot[2 * kx] * MLF_CT, x1 = col_slot[2 * kx + 1] * MLF_CT;
          const float flag = (ay.in_range && ax.in_range) ? 1.f : 0.f;
          const float w00 = __fmul_rn(ay.w0, ax.w0), w01 = __fmul_rn(ay.w0, ax.w1);
          const float w10 = __fmul_rn(ay.w1, ax.w0), w11 = __fmul_rn(ay.w1, ax.w1);
          float f00[8], f01[8], f10[8], f11[8];
          load8(row0 + x0, f00);
          load8(row0 + x1, f01);
          load8(row1 + x0, f10);
          load8(row1 + x1, f11);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float v = tap_sum(f00[j], f01[j], f10[j], f11[j], w00, w01, w10, w11);
            acc[j] = __fadd_rn(acc[j], __fmul_rn(v, flag));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = __fmul_rn(acc[j], inv_ns);
      store8(dst + (nr * bins + py * out + px) * c + ct0 + g * 8, acc);
    }
    __syncthreads();  // the stage is rewritten next
  }
}

// Dynamic shared memory of the staged forward kernel.
size_t staged_smem(int out, size_t elem) {
  const int p_total = out * 2, dmax = 2 * p_total;
  return static_cast<size_t>(MLF_STAGES) * MLF_ROWS * dmax * MLF_CT * elem +
         2 * p_total * sizeof(Axis) + (dmax + out * MLF_ROWS + out + 1) * sizeof(int) +
         4 * p_total * sizeof(short);
}

int ceil_div(int64_t a, int64_t b);

template <typename T, typename O>
int launch_staged(const Pyramid<const T>& pyr, const void* rois, const void* levels,
                  int64_t n_rois, int c, int r, float img_h, float img_w, int out, void* dst,
                  cudaStream_t stream) {
  const size_t smem = staged_smem(out, sizeof(T));
  auto kernel = multilevel_roi_align_staged_kernel<T, O>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>(n_rois),
                  static_cast<unsigned int>(ceil_div(c, MLF_CT)));
  kernel<<<grid, MLF_THREADS, smem, stream>>>(
      pyr, static_cast<const float*>(rois), static_cast<const int*>(levels), img_h, img_w, c, r,
      out, static_cast<O*>(dst));
  return static_cast<int>(cudaGetLastError());
}
