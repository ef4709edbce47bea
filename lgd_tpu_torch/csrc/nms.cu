// Exact greedy NMS for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel lgd_tpu/ops/nms.py::_sweep_kernel (a sequential
// sweep over a score-sorted, upper-triangular `IoU > thr` suppressor held
// in VMEM). Here the same keep mask comes from two launches:
//
//   1. nms_mask_kernel: one block of 64 threads per 64 x 64 tile on or
//      above the diagonal (a folded grid launches no other). Thread i
//      tests its box against the tile's 64 column boxes (staged in shared
//      memory with their areas) and writes one 64-bit word of the row
//      mask: bit j = (j > i) && IoU(i, j) > thr. The diagonal tiles also
//      write each row's column word: bit j < i = IoU(j, i) > thr, and bit
//      i = the row is invalid.
//   2. nms_sweep_kernel: one warp per image walks the rows in blocks of
//      64 (one mask word). A `removed` bitset of ceil(N / 64) words lives
//      in shared memory. For block r the warp
//        - resolves the block in registers: lane l holds the column words
//          of rows l and l + 32, and keep = alive & ~(OR of the column
//          words of kept rows) is iterated to its fixed point, one ballot
//          per half and iteration (row i depends only on rows < i, so the
//          fixed point is unique, and it is reached within 65 iterations:
//          as many as the longest chain of suppressions, plus one);
//        - writes the block's 64 keep bytes in two coalesced stores;
//        - ORs the kept rows' words of the later columns into `removed`,
//          a lane per word, from the block's tile of the row mask in
//          shared memory: every row's word is loaded and selected by its
//          kept bit, so that no load waits on another. The tiles are
//          staged kStages - 1 blocks ahead by 1-D bulk copies completing
//          on mbarriers: a row block's whole mask rows in one copy (they
//          are contiguous) where they fit a buffer (N <= 4096), else
//          chunks of kChunk words right of the diagonal, a copy per row.
//      Invalid rows (and the rows past N) start removed, so they are never
//      kept and never suppress (as the Pallas kernel's `suppressed =
//      1 - valid` start).
//
// What bounds it on this card: the sweep is serial within an image, so an
// image runs on one SM at the rate of one warp's instructions; no kept
// row waits on device memory (the first form loaded each kept row's mask
// row in a chain of dependent L2 latencies: 0.6 ms at 8 x 2000 on an
// H100). A row block costs about as much in the apply's shared loads and
// selects as in its fixed cost (the copies' issue and wait, the ballots,
// the keep stores, the warp barrier); images run in parallel, a warp
// each. The mask is O(B * N^2 / 64) words (2000 boxes: 0.5 MB per image),
// written once and read once through L2; its kernel is bound by the IoU
// arithmetic, which skips the division where the boxes do not intersect
// (the IoU is then 0, as the division would give).
//
// The IoU repeats lgd_tpu.structures.boxes.pairwise_iou operation for
// operation, with every product and sum rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn: no fused multiply-add) and an IEEE division, so
// that a pair exactly at the threshold compares the same as on the host.
// A column word's bit j is computed as the row word of row j computes it,
// from the same operands in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;   // boxes per mask word, rows per row block
constexpr int kChunk = 64;   // most words of a tile row staged at once
constexpr int kStages = 4;   // chunks in flight: three ahead of the sweep
constexpr int kMaxSpin = 1 << 22;
constexpr int kMaxDevices = 64;
// the sweep's most dynamic shared memory: kStages tiles of 64 x kChunk
// words and their column words, and the `removed` bitset at the wrapper's
// largest N (6144 words)
constexpr int kMaxShared = (kStages * kBlock * (kChunk + 1) + 6144) * 8;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(a, b) > thr, with a1 and a2 the areas of a and b
__device__ __forceinline__ bool suppresses(float4 a, float a1, float4 b,
                                           float a2, float thr) {
  const float lt_x = fmaxf(a.x, b.x);
  const float lt_y = fmaxf(a.y, b.y);
  const float rb_x = fminf(a.z, b.z);
  const float rb_y = fminf(a.w, b.w);
  const float w = fmaxf(__fsub_rn(rb_x, lt_x), 0.0f);
  const float h = fmaxf(__fsub_rn(rb_y, lt_y), 0.0f);
  const float inter = __fmul_rn(w, h);
  float iou = 0.0f;
  if (inter != 0.0f) {
    const float uni = __fsub_rn(__fadd_rn(a1, a2), inter);
    if (uni > 0.0f) iou = __fdiv_rn(inter, fmaxf(uni, 1e-7f));
  }
  return iou > thr;
}

// grid (words + 1, (words + 1) / 2, batch): row pair y of the upper
// triangle's rows y and words - 1 - y (words - y and y + 1 tiles) folded
// into one grid row of words + 1 blocks
__global__ void __launch_bounds__(kBlock)
nms_mask_kernel(const float4* __restrict__ boxes,
                const bool* __restrict__ valid, int n, int words,
                int stride, float thr, u64* __restrict__ mask,
                u64* __restrict__ cols) {
  const int x = blockIdx.x, y = blockIdx.y;
  int row_block = y, col_block = y + x;
  if (x >= words - y) {
    row_block = words - 1 - y;
    if (row_block == y) return;  // words odd: the middle row is whole
    col_block = row_block + x - (words - y);
  }
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int row_size = min(n - row_block * kBlock, kBlock);
  const int col_size = min(n - col_block * kBlock, kBlock);
  const float4* img = boxes + static_cast<int64_t>(b) * n;

  __shared__ float4 col[kBlock];
  __shared__ float col_area[kBlock];
  if (t < col_size) {
    const float4 c = img[col_block * kBlock + t];
    col[t] = c;
    col_area[t] = box_area(c);
  }
  __syncthreads();
  if (t >= row_size) return;

  const int i = row_block * kBlock + t;
  const float4 me = img[i];
  const float me_area = box_area(me);
  u64 bits = 0ULL;
  if (row_block == col_block) {
    u64 col_bits = valid[static_cast<int64_t>(b) * n + i] ? 0ULL
                                                           : 1ULL << t;
    for (int j = 0; j < t; ++j) {
      if (suppresses(col[j], col_area[j], me, me_area, thr))
        col_bits |= 1ULL << j;
    }
    cols[static_cast<int64_t>(b) * words * kBlock + i] = col_bits;
    for (int j = t + 1; j < col_size; ++j) {
      if (suppresses(me, me_area, col[j], col_area[j], thr))
        bits |= 1ULL << j;
    }
  } else if (col_size == kBlock) {
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      if (suppresses(me, me_area, col[j], col_area[j], thr))
        bits |= 1ULL << j;
    }
  } else {
    for (int j = 0; j < col_size; ++j) {
      if (suppresses(me, me_area, col[j], col_area[j], thr))
        bits |= 1ULL << j;
    }
  }
  mask[(static_cast<int64_t>(b) * n + i) * stride + col_block] = bits;
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(u64* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void bar_expect(u64* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(u64* bar, uint32_t parity) {
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > kMaxSpin) __trap();  // a copy that never lands: fail loudly
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// One step of the sweep: the chunk of row block r's tile that starts at
// mask word c0 (even, so that every copy is 16-byte aligned). Where whole
// mask rows fit a buffer (pitch == stride), a row block is one step of
// whole rows, contiguous in the mask and so one copy; else a row block's
// first step starts at the even word at or before r + 1, a chunk is one
// copy per row, and a block with no word right of its own has one empty
// step. A row block's first step also resolves the block.
struct Step {
  int r, c0;
};

__device__ __forceinline__ int first_word(int r, int stride, int pitch) {
  return pitch == stride ? 0 : min((r + 1) & ~1, stride);
}

__device__ __forceinline__ Step next_step(Step s, int stride, int pitch) {
  if (s.c0 + pitch < stride) return {s.r, s.c0 + pitch};
  return {s.r + 1, first_word(s.r + 1, stride, pitch)};
}

// shared memory: tiles [kStages][64][pitch], column words [kStages][64],
// removed [words]; the mbarriers, one per stage, static
__global__ void __launch_bounds__(32)
nms_sweep_kernel(const u64* __restrict__ mask, const u64* __restrict__ cols,
                 int n, int words, int stride, int pitch,
                 bool* __restrict__ keep) {
  extern __shared__ __align__(16) u64 sm[];
  __shared__ __align__(8) u64 bar[kStages];
  u64* tiles = sm;
  u64* col_words = tiles + kStages * kBlock * pitch;
  u64* removed = col_words + kStages * kBlock;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const u64* m = mask + static_cast<int64_t>(b) * n * stride;
  const u64* c = cols + static_cast<int64_t>(b) * words * kBlock;
  bool* k = keep + static_cast<int64_t>(b) * n;

  const int tail = n - (words - 1) * kBlock;  // rows of the last block
  for (int w = lane; w < words; w += 32)
    removed[w] = (w == words - 1 && tail < kBlock) ? ~0ULL << tail : 0ULL;
  if (lane < kStages) bar_init(&bar[lane]);
  if (lane == 0)
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncwarp();

  // copies of step s into buffer q, counted on bar[q]
  auto issue = [&](Step s, int q) {
    const int width = min(pitch, stride - s.c0);
    const int rows = min(n - s.r * kBlock, kBlock);
    const bool first = s.c0 == first_word(s.r, stride, pitch);
    const u64* src = m + static_cast<int64_t>(s.r * kBlock) * stride + s.c0;
    if (lane == 0) {
      bar_expect(&bar[q], static_cast<uint32_t>(rows * width * 8 +
                                                (first ? kBlock * 8 : 0)));
      if (first)
        bulk_copy(col_words + q * kBlock, c + s.r * kBlock, kBlock * 8,
                  &bar[q]);
      if (width == stride)
        bulk_copy(tiles + q * kBlock * pitch, src, rows * width * 8,
                  &bar[q]);
    }
    if (width > 0 && width < stride) {
      for (int i = lane; i < rows; i += 32)
        bulk_copy(tiles + (q * kBlock + i) * pitch, src + i * stride,
                  width * 8, &bar[q]);
    }
  };

  // step k is staged in buffer k % kStages; the copies of step k +
  // kStages - 1 go out while step k is swept, into the buffer of step k - 1
  Step fetch = {0, 0};
  int fetched = 0;
  for (; fetched < kStages - 1 && fetch.r < words; ++fetched) {
    issue(fetch, fetched);
    fetch = next_step(fetch, stride, pitch);
  }
  Step s = {0, 0};
  u64 kept = 0ULL;
  for (int step = 0; s.r < words; ++step) {
    if (fetch.r < words) {
      issue(fetch, fetched % kStages);
      fetch = next_step(fetch, stride, pitch);
      ++fetched;
    }
    const int q = step % kStages;
    bar_wait(&bar[q], (step / kStages) & 1);

    if (s.c0 == first_word(s.r, stride, pitch)) {
      // resolve row block s.r: lane l holds rows l and l + 32
      const u64 gone = removed[s.r];
      const u64 col_lo = col_words[q * kBlock + lane];
      const u64 col_hi = col_words[q * kBlock + 32 + lane];
      const bool alive_lo = !((gone >> lane) & 1) && !((col_lo >> lane) & 1);
      const bool alive_hi =
          !((gone >> (lane + 32)) & 1) && !((col_hi >> (lane + 32)) & 1);
      bool keep_lo = alive_lo, keep_hi = alive_hi;
      kept = static_cast<u64>(__ballot_sync(0xffffffffu, keep_lo)) |
             static_cast<u64>(__ballot_sync(0xffffffffu, keep_hi)) << 32;
      for (;;) {
        keep_lo = alive_lo && !(col_lo & kept);
        keep_hi = alive_hi && !(col_hi & kept);
        const u64 again =
            static_cast<u64>(__ballot_sync(0xffffffffu, keep_lo)) |
            static_cast<u64>(__ballot_sync(0xffffffffu, keep_hi)) << 32;
        if (again == kept) break;
        kept = again;
      }
      const int row = s.r * kBlock + lane;
      if (row < n) k[row] = keep_lo;
      if (row + 32 < n) k[row + 32] = keep_hi;
    }

    // the kept rows' words right of block s.r, a lane per word (the rows
    // past N hold stale words, and are never kept)
    const u64* tile = tiles + q * kBlock * pitch;
    const int width = min(pitch, stride - s.c0);
    for (int j = lane; j < width; j += 32) {
      const int w = s.c0 + j;
      if (w > s.r && w < words) {
        const uint32_t lo = static_cast<uint32_t>(kept);
        const uint32_t hi = static_cast<uint32_t>(kept >> 32);
        u64 acc = 0ULL;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const u64 top = tile[i * pitch + j];
          const u64 bottom = tile[(i + 32) * pitch + j];
          acc |= ((lo >> i) & 1u) ? top : 0ULL;
          acc |= ((hi >> i) & 1u) ? bottom : 0ULL;
        }
        removed[w] |= acc;
      }
    }
    __syncwarp();
    s = next_step(s, stride, pitch);
  }
}

}  // namespace

// boxes (B, N, 4) float32, score-sorted, 16-byte aligned; valid (B, N)
// bool; scratch of B * (N * stride + words * 64) uint64 (words = ceil(N /
// 64), stride = words rounded up to even): the row mask (B, N, stride),
// then the column words (B, words * 64); keep (B, N) bool, written in
// sorted order. Returns the cudaError_t of the launches (0 on success).
extern "C" int lgd_nms_keep_sorted(const float* boxes, const bool* valid,
                                   int batch, int n, float thr,
                                   unsigned long long* scratch, bool* keep,
                                   void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int words = (n + kBlock - 1) / kBlock;
  const int stride = words + (words & 1);
  const int pitch = min(kChunk, stride);
  u64* mask = scratch;
  u64* cols = scratch + static_cast<int64_t>(batch) * n * stride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words + 1, (words + 1) / 2, batch), kBlock, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), valid, n, words, stride, thr,
      mask, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the sweep's shared-memory limit, once per card, at its first launch
  // there (so outside any graph capture that follows)
  static std::atomic<bool> shared_set[kMaxDevices];
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!shared_set[device]) {
    err = cudaFuncSetAttribute(nms_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    shared_set[device] = true;
  }
  const size_t shared = (kStages * kBlock * (pitch + 1) + words) * 8;
  nms_sweep_kernel<<<batch, 32, shared, s>>>(mask, cols, n, words, stride,
                                              pitch, keep);
  return static_cast<int>(cudaGetLastError());
}
