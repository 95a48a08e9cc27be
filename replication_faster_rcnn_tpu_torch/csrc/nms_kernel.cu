// Exact greedy NMS over descending-score candidates: IoU suppression bitmasks
// computed across the whole card, and a short greedy walk over them, one
// block per image, taken in chunks of candidates so that a mask entry is
// computed only where the walk can still read it.
//
// Replaces: replication_faster_rcnn_tpu/ops/pallas/nms_kernel.py::_nms_kernel
// (wrapper nms_fixed_pallas). Same contract as the plain version
// replication_faster_rcnn_tpu_torch/ops/nms_tiled.py::nms_fixed_tiled:
// idx [B, max_out] int64 in selection order, valid [B, max_out], selections
// bit-identical.
//
// What bounds it on the H100: neither bytes nor FLOPs. The candidates of an
// image are a few tens of KB, and the IoU work is at most N^2 / 2 cheap float
// ops per image. Greedy selection is a chain of dependent decisions: box k may
// be kept only once every earlier kept box is known. Run with its IoUs in one
// block per image, that chain keeps 8 of 132 SMs busy at batch 8 and costs
// ~N x max_out strict IoUs in series per image.
//
// What this design does about it: it takes every IoU off the serial chain.
//   * The sorted candidates are taken in chunks of 256, 512, 1024, then 2048
//     (a chunk is up to 32 words of 64 candidates). Two kernels per chunk:
//   * nms_mask_kernel, across the card: one block per (image, 64-column tile
//     of the chunk, slice of rows). The tile's boxes sit in shared memory.
//     (a) Each box kept in an earlier chunk (at most max_out) is tested
//     against the tile, and the suppressed bits are ORed into the chunk's
//     removed set. (b) Each live candidate of the chunk up to the tile's end
//     is tested against the tile's later candidates: bit j of mask[i, t] says
//     that candidate i suppresses candidate 64 (chunk start + t) + j.
//   * nms_walk_kernel, one 256-thread block per image, walks the chunk's
//     words in order. Warp 0 resolves the greedy order inside a word from its
//     diagonal 64x64 block as a fixpoint, g = alive & ~OR{row i : i in g}
//     (the rows' bits only point forward, so after k sweeps the first k
//     candidates are settled and the fixpoint is the greedy answer, the
//     recurrence of the plain version): one OR-reduction across the warp per
//     sweep, and two or three sweeps when few boxes of a word overlap. The
//     block then ORs the kept rows into the chunk's later words, and the next
//     word's rows are prefetched with cp.async while this one is walked.
//     When max_out is reached the image's done flag is set and the later
//     chunks' kernels exit at once.
//   * Work: (boxes kept so far + chunk) x chunk per chunk, against N^2 / 2 for
//     the whole mask: when the walk reaches max_out early the rest is never
//     computed. The serial chain is ~ceil(E / 64) short steps for the E
//     candidates walked, plus two launches per chunk (8 chunks at N = 12000).
//   * The IoU test is exact without a division on almost every pair: the
//     sign of inter - thresh * union from one fused multiply-add decides
//     every pair whose IoU is not within 2^-22 (relative) of the threshold;
//     those few take the strict division of iou_strict.
//
// Scratch, allocated by the wrapper with torch.empty (the kernels allocate
// nothing), per image: the mask N x 32 uint64 (each candidate's row within
// its own chunk), the chunk's removed set (32 uint64) and 2 int32 of state
// (count, done): 8 x 12000 -> 600 (training) 24.6 MB, 8 x 3000 -> 300
// (serving proposals) 6.1 MB, 8 x 6300 -> 100 (serving detection) 12.9 MB.
// The kept candidates' sorted positions go into idx_out itself until the
// last walk maps them to original indices.
//
// Strict IEEE: the IoU repeats ops/boxes.py::iou operation for operation
// (max/min, subtract, multiply, select, add, subtract, divide) with the
// round-to-nearest intrinsics, the earlier box first, and this file is built
// with -fmad=false, so no product is contracted into an add. A one-ulp drift
// flips comparisons that sit on the threshold (see the JAX kernel's _iou_cols
// note). Equal IoUs give the unique greedy answer that the plain version gives.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int TILE = 64;            // candidates per word
constexpr int CW = 32;              // words per chunk at most (2048 candidates)
constexpr int FIRST_CHUNK = 4;      // words of the first chunk; each next one doubles
constexpr int MASK_THREADS = 128;
constexpr int ROW_SLICES = 4;       // blocks sharing one column tile's rows
constexpr int WALK_THREADS = 256;
constexpr int STATE_INTS = 2;       // count, done

// one image's pieces of the scratch buffer
struct Scratch {
  u64* mask;      // [n, CW]
  u64* removed;   // [CW] the current chunk's words removed by earlier chunks' keeps
  int* state;     // [STATE_INTS]
};

__device__ __forceinline__ Scratch scratch_of(void* base, int batch, int n, int img) {
  u64* mask = static_cast<u64*>(base);
  u64* removed = mask + static_cast<long long>(batch) * n * CW;
  int* state = reinterpret_cast<int*>(removed + static_cast<long long>(batch) * CW);
  return {mask + static_cast<long long>(img) * n * CW, removed + img * CW,
          state + img * STATE_INTS};
}

__device__ __forceinline__ float iou_strict(float4 a, float4 b) {
  const float tl_r = fmaxf(a.x, b.x);
  const float tl_c = fmaxf(a.y, b.y);
  const float br_r = fminf(a.z, b.z);
  const float br_c = fminf(a.w, b.w);
  const float wh_r = __fsub_rn(br_r, tl_r);
  const float wh_c = __fsub_rn(br_c, tl_c);
  const float inter = (wh_r > 0.f && wh_c > 0.f) ? __fmul_rn(wh_r, wh_c) : 0.f;
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__device__ __forceinline__ float area(float4 a) {
  return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

// iou_strict(a, b) > thresh, with area_a = area(a) and area_b = area(b).
// `tol` = thresh * 2^-21 when thresh lies in [2^-40, 2^100] (else 0: the
// division decides every pair). With u = union >= 2^-60 and q = inter / u,
// the fused d = fl(inter - thresh * u) has the exact sign of q - thresh:
// d < 0 means fl(q) <= thresh; d > u * tol means q > thresh (1 + 2^-22),
// beyond the midpoint between thresh and the next float, so fl(q) > thresh.
// Only pairs in between, or with a smaller or non-finite union, divide.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b, float area_b,
                                           float thresh, float tol) {
  const float wh_r = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float wh_c = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  const float inter = (wh_r > 0.f && wh_c > 0.f) ? __fmul_rn(wh_r, wh_c) : 0.f;
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float d = __fmaf_rn(-thresh, uni, inter);
  if (tol > 0.f && uni >= 0x1p-60f && (d < 0.f || d > __fmul_rn(uni, tol))) return d > 0.f;
  return iou_strict(a, b) > thresh;
}

// Bits j >= j_from of `a` (area area_a) against the tile's boxes 0 .. jmax - 1.
__device__ __forceinline__ u64 row_bits(float4 a, float area_a, const float4* cols,
                                        const float* col_area, int j_from, int jmax,
                                        float thresh, float tol) {
  u64 bits = 0;
  if (j_from == 0 && jmax == TILE) {
#pragma unroll 16
    for (int j = 0; j < TILE; ++j) {
      if (suppresses(a, area_a, cols[j], col_area[j], thresh, tol)) bits |= 1ull << j;
    }
  } else {
    for (int j = j_from; j < jmax; ++j) {
      if (suppresses(a, area_a, cols[j], col_area[j], thresh, tol)) bits |= 1ull << j;
    }
  }
  return bits;
}

__global__ void __launch_bounds__(MASK_THREADS)
nms_mask_kernel(const float4* __restrict__ boxes,    // [B, N] sorted
                const float* __restrict__ scores,    // [B, N] sorted, -inf = never
                const int64_t* __restrict__ kept,    // [B, max_out] sorted positions so far
                int batch, int n, int max_out, int w0, float thresh, float tol,
                void* scratch) {
  __shared__ float4 cols[TILE];
  __shared__ float col_area[TILE];
  __shared__ u64 s_sup;
  const int img = blockIdx.y;
  const Scratch sc = scratch_of(scratch, batch, n, img);
  // the first chunk reads no state: the scratch is not initialised
  if (w0 > 0 && sc.state[1]) return;  // the walk already reached max_out
  const int t = blockIdx.x;            // tile within the chunk
  const int j0 = (w0 + t) * TILE;
  const int jmax = min(TILE, n - j0);
  const float4* img_boxes = boxes + static_cast<long long>(img) * n;
  const float* img_scores = scores + static_cast<long long>(img) * n;
  if (threadIdx.x < TILE) {
    const float4 b = threadIdx.x < jmax ? img_boxes[j0 + threadIdx.x]
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
    cols[threadIdx.x] = b;
    col_area[threadIdx.x] = area(b);
  }
  if (threadIdx.x == 0) s_sup = 0;
  __syncthreads();

  const int step = MASK_THREADS * ROW_SLICES;
  const int first = blockIdx.z * MASK_THREADS + threadIdx.x;
  // (a) the boxes kept in earlier chunks against the whole tile
  const int n_kept = w0 > 0 ? sc.state[0] : 0;
  u64 sup = 0;
  for (int q = first; q < n_kept; q += step) {
    const float4 a = img_boxes[kept[static_cast<long long>(img) * max_out + q]];
    sup |= row_bits(a, area(a), cols, col_area, 0, jmax, thresh, tol);
  }
  if (n_kept > 0) {
    for (int o = 16; o > 0; o >>= 1) sup |= __shfl_xor_sync(0xffffffffu, sup, o);
    if ((threadIdx.x & 31) == 0 && sup) atomicOr(&s_sup, sup);
    __syncthreads();
    if (threadIdx.x == 0 && s_sup) atomicOr(sc.removed + t, s_sup);
  }
  // (b) the chunk's live candidates up to the tile's last one, forward bits
  // (the tile's own rows too, down to the last one's empty row: the walk
  // reads every kept row's word in full)
  for (int i = w0 * TILE + first; i < j0 + jmax; i += step) {
    if (!(img_scores[i] > -INFINITY)) continue;
    const float4 a = img_boxes[i];
    sc.mask[static_cast<long long>(i) * CW + t] =
        row_bits(a, area(a), cols, col_area, max(0, i - j0 + 1), jmax, thresh, tol);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying the mask rows of the chunk's word `wl` (chunk words wl & ~1 ..
// nw - 1, nw even) into dst [TILE][CW]. Rows already removed (or dead) are
// skipped: they may never have been computed and are never read.
__device__ __forceinline__ void prefetch_rows(u64* dst, const u64* img_mask, u64 removed_wl,
                                              int row0, int wl, int nw) {
  const int base = wl & ~1;
  const int segs = (nw - base) / 2;  // 16-byte segments per row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < TILE; r += WALK_THREADS / 32) {
    if ((removed_wl >> r) & 1ull) continue;
    const u64* src = img_mask + static_cast<long long>(row0 + r) * CW + base;
    for (int sg = lane; sg < segs; sg += 32) {
      cp_async16(dst + r * CW + base + 2 * sg, src + 2 * sg);
    }
  }
}

__global__ void __launch_bounds__(WALK_THREADS)
nms_walk_kernel(const float* __restrict__ scores,    // [B, N] sorted, -inf = never
                const int64_t* __restrict__ order,   // [B, N] original index
                int batch, int n, int words, int max_out, int w0, int w1, void* scratch,
                int64_t* __restrict__ idx_out,       // [B, max_out]
                bool* __restrict__ valid_out) {      // [B, max_out]
  __shared__ __align__(16) u64 bufs[2][TILE * CW];  // the rows of two words
  __shared__ u64 removed[CW];
  __shared__ int kept_list[TILE];
  __shared__ int s_nk;
  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Scratch sc = scratch_of(scratch, batch, n, img);
  if (w0 > 0 && sc.state[1]) return;
  int count = w0 > 0 ? sc.state[0] : 0;
  int64_t* img_idx = idx_out + static_cast<long long>(img) * max_out;
  const int nw = w1 - w0;
  const int nw_even = nw + (nw & 1);
  const int row0 = w0 * TILE;

  // the chunk's removed set: dead candidates (and the slots past N), one
  // 32-bit ballot per warp, and what earlier chunks' keeps suppress
  const float* img_scores = scores + static_cast<long long>(img) * n;
  uint32_t* removed32 = reinterpret_cast<uint32_t*>(removed);
  for (int base = 0; base < nw * TILE; base += WALK_THREADS) {
    const int i = row0 + base + tid;
    const uint32_t bal = __ballot_sync(0xffffffffu, i >= n || !(img_scores[i] > -INFINITY));
    if (lane == 0 && base + tid < nw * TILE) removed32[(base + tid) >> 5] = bal;
  }
  __syncthreads();
  if (w0 > 0 && tid < nw) removed[tid] |= sc.removed[tid];
  __syncthreads();

  prefetch_rows(bufs[0], sc.mask, removed[0], row0, 0, nw_even);
  cp_async_commit();
  for (int wl = 0; wl < nw && count < max_out; ++wl) {
    const u64* cur = bufs[wl & 1];
    if (wl + 1 < nw) {
      // removed[wl + 1] holds every keep up to word wl - 1: a superset of the
      // rows that word wl + 1 can keep is fetched
      prefetch_rows(bufs[(wl + 1) & 1], sc.mask, removed[wl + 1], row0 + (wl + 1) * TILE,
                    wl + 1, nw_even);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // word wl's rows have landed for every thread

    if (warp == 0) {
      // greedy order inside the word: the fixpoint of g = alive & ~OR{row i : i in g}
      const u64 alive = ~removed[wl];
      const u64 r_lo = cur[lane * CW + wl];
      const u64 r_hi = cur[(lane + 32) * CW + wl];
      u64 g = alive;
      // rows point forward only, so after k sweeps the first k candidates are
      // settled: 65 sweeps always reach the fixpoint
      for (int sweep = 0; sweep <= TILE; ++sweep) {
        u64 m = (((g >> lane) & 1ull) ? r_lo : 0ull) | (((g >> (lane + 32)) & 1ull) ? r_hi : 0ull);
        for (int o = 16; o > 0; o >>= 1) m |= __shfl_xor_sync(0xffffffffu, m, o);
        const u64 g2 = alive & ~m;
        if (g2 == g) break;
        g = g2;
      }
      const int room = max_out - count;
      while (__popcll(g) > room) g &= ~(1ull << (63 - __clzll(static_cast<long long>(g))));
      // selection order is ascending position: slot = keeps before the bit
      for (int h = 0; h < 2; ++h) {
        const int b = lane + 32 * h;
        if ((g >> b) & 1ull) {
          const int k = __popcll(g & ((1ull << b) - 1ull));
          img_idx[count + k] = row0 + wl * TILE + b;  // sorted position, mapped at the end
          kept_list[k] = b;
        }
      }
      if (lane == 0) s_nk = __popcll(g);
    }
    __syncthreads();
    const int nk = s_nk;
    count += nk;
    if (nk > 0 && count < max_out) {
      // the keeps suppress the chunk's later candidates: warp k ORs keeps
      // k, k + 8, ... into the word of its lane
      const int wd = wl + 1 + lane;
      if (wd < nw) {
        u64 acc = 0;
        for (int q = warp; q < nk; q += WALK_THREADS / 32) acc |= cur[kept_list[q] * CW + wd];
        if (acc) atomicOr(&removed[wd], acc);
      }
    }
    __syncthreads();  // removed is final up to word wl + 1; word wl's buffer is free
  }
  cp_async_wait_all();  // no copy may land after the block has gone

  if (count >= max_out || w1 >= words) {
    const int64_t* img_order = order + static_cast<long long>(img) * n;
    bool* img_valid = valid_out + static_cast<long long>(img) * max_out;
    for (int k = tid; k < max_out; k += WALK_THREADS) {
      img_idx[k] = k < count ? img_order[img_idx[k]] : 0;
      img_valid[k] = k < count;
    }
    if (tid == 0) sc.state[1] = 1;
    return;
  }
  if (tid < CW) sc.removed[tid] = 0;  // the next chunk's mask kernel ORs into it
  if (tid == 0) {
    sc.state[0] = count;
    sc.state[1] = 0;
  }
}

}  // namespace

extern "C" {

// scratch: batch * (n * 32 + 32 + 1) uint64 (ops/cuda/nms_kernel.py::
// scratch_words). Returns the CUDA error of the launches (0 = cudaSuccess).
int nms_greedy_launch(const void* boxes, const void* scores, const void* order,
                      int batch, int n, float thresh, int max_out, void* scratch,
                      void* idx_out, void* valid_out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (n + TILE - 1) / TILE;
  // the exact fused-sign test needs thresh * 2^-21 exact and normal
  const float tol = (thresh >= 0x1p-40f && thresh <= 0x1p100f) ? thresh * 0x1p-21f : 0.f;
  int chunk = FIRST_CHUNK;
  for (int w0 = 0, w1 = 0; w0 < words; w0 = w1) {
    w1 = w0 + chunk < words ? w0 + chunk : words;
    if (chunk < CW) chunk *= 2;
    nms_mask_kernel<<<dim3(w1 - w0, batch, ROW_SLICES), MASK_THREADS, 0, st>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(scores),
        static_cast<const int64_t*>(idx_out), batch, n, max_out, w0, thresh, tol, scratch);
    nms_walk_kernel<<<batch, WALK_THREADS, 0, st>>>(
        static_cast<const float*>(scores), static_cast<const int64_t*>(order), batch, n, words,
        max_out, w0, w1, scratch, static_cast<int64_t*>(idx_out),
        static_cast<bool*>(valid_out));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
