// Exact greedy NMS for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel lgd_tpu/ops/nms.py::_sweep_kernel (a sequential
// sweep over a score-sorted, upper-triangular `IoU > thr` suppressor held
// in VMEM). Here the same keep mask comes from two launches:
//
//   1. nms_mask_kernel: grid (column block, row block, image), 64 threads.
//      Thread i of a row block tests its box against the 64 boxes of one
//      column block (staged in shared memory) and writes one 64-bit word:
//      bit j = (j > i) && IoU(i, j) > thr. Blocks left of the diagonal hold
//      no bits and are skipped; the sweep never reads them.
//   2. nms_sweep_kernel: one warp per image. A `removed` bitset of
//      ceil(N / 64) words lives in shared memory, born with the invalid
//      rows set, so invalid rows are never kept and never suppress (as the
//      Pallas kernel's `suppressed = 1 - valid` start). Rows are visited in
//      score order; a row whose bit is clear is kept and its mask row is
//      ORed into `removed`, one word per lane.
//
// What bounds it on this card: the sweep is a serial latency chain, one
// dependent global load of a mask row per kept row plus a warp barrier per
// row, so a block runs at a few hundred ns per row whatever the card's
// bandwidth; images run in parallel, one warp each. The mask is
// O(B * N^2 / 64) words (2000 boxes: 0.5 MB per image), written once and
// read once. A simple kernel that is right comes first; overlapping the
// sweep's loads is later work.
//
// The IoU repeats lgd_tpu.structures.boxes.pairwise_iou operation for
// operation, with every product and sum rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn: no fused multiply-add) and an IEEE division, so
// that a pair exactly at the threshold compares the same as on the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;  // boxes per mask word

__device__ __forceinline__ float iou(const float* a, const float* b) {
  const float lt_x = fmaxf(a[0], b[0]);
  const float lt_y = fmaxf(a[1], b[1]);
  const float rb_x = fminf(a[2], b[2]);
  const float rb_y = fminf(a[3], b[3]);
  const float w = fmaxf(__fsub_rn(rb_x, lt_x), 0.0f);
  const float h = fmaxf(__fsub_rn(rb_y, lt_y), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float a1 = __fmul_rn(__fsub_rn(a[2], a[0]), __fsub_rn(a[3], a[1]));
  const float a2 = __fmul_rn(__fsub_rn(b[2], b[0]), __fsub_rn(b[3], b[1]));
  const float uni = __fsub_rn(__fadd_rn(a1, a2), inter);
  return uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-7f)) : 0.0f;
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int words, float thr,
                                unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  if (col_block < row_block) return;  // strictly below the diagonal: no bits
  const int b = blockIdx.z;
  const int row_size = min(n - row_block * kBlock, kBlock);
  const int col_size = min(n - col_block * kBlock, kBlock);
  const float* img = boxes + static_cast<int64_t>(b) * n * 4;

  __shared__ float col[kBlock * 4];
  if (threadIdx.x < col_size) {
    const float* src = img + (col_block * kBlock + threadIdx.x) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) col[threadIdx.x * 4 + k] = src[k];
  }
  __syncthreads();
  if (threadIdx.x >= row_size) return;

  const int i = row_block * kBlock + threadIdx.x;
  float me[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) me[k] = img[i * 4 + k];
  unsigned long long bits = 0ULL;
  const int start = (row_block == col_block) ? threadIdx.x + 1 : 0;
  for (int j = start; j < col_size; ++j) {
    if (iou(me, col + j * 4) > thr) bits |= 1ULL << j;
  }
  mask[(static_cast<int64_t>(b) * n + i) * words + col_block] = bits;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const bool* __restrict__ valid, int n,
                                 int words, bool* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const bool* v = valid + static_cast<int64_t>(b) * n;
  const unsigned long long* m = mask + static_cast<int64_t>(b) * n * words;
  bool* k = keep + static_cast<int64_t>(b) * n;

  for (int w = lane; w < words; w += warpSize) {
    unsigned long long born = 0ULL;
    for (int j = 0; j < kBlock; ++j) {
      const int i = w * kBlock + j;
      if (i >= n || !v[i]) born |= 1ULL << j;
    }
    removed[w] = born;
  }
  __syncwarp();

  for (int i = 0; i < n; ++i) {
    const int wi = i / kBlock;
    const bool kept = !((removed[wi] >> (i % kBlock)) & 1ULL);
    if (kept) {
      const unsigned long long* row = m + static_cast<int64_t>(i) * words;
      for (int w = wi + lane; w < words; w += warpSize) removed[w] |= row[w];
    }
    if (lane == 0) k[i] = kept;
    __syncwarp();
  }
}

}  // namespace

// boxes (B, N, 4) float32, score-sorted; valid (B, N) bool; mask scratch
// (B, N, ceil(N / 64)) uint64; keep (B, N) bool, written in sorted order.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int lgd_nms_keep_sorted(const float* boxes, const bool* valid,
                                   int batch, int n, float thr,
                                   unsigned long long* mask, bool* keep,
                                   void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int words = (n + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words, batch), kBlock, 0, s>>>(
      boxes, n, words, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<batch, 32, words * sizeof(unsigned long long), s>>>(
      mask, valid, n, words, keep);
  return static_cast<int>(cudaGetLastError());
}
