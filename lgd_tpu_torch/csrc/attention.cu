// Masked multi-head attention of the LGD teacher for Hopper (sm_90a),
// float32 on the CUDA cores, bound to Python through ctypes. Kernels K1a
// and K1b.
//
// K1a, attn_fwd_kernel, replaces the TPU kernel
// lgd_tpu/ops/attention.py::_pallas_fwd_impl (body _attn_kernel):
//     out = softmax(where(valid, Q K^T * scale, -1e9)) V
// and also writes each query row's softmax max m and sum s.
// K1b, attn_bwd_kernel, replaces lgd_tpu/ops/attention.py::_pallas_bwd_impl
// (body _attn_bwd_kernel): from q, k, v, out, m, s and the output gradient
// it recomputes P and writes dQ, dK and dV.
//
// The mask follows the plain reference (masked_attention_reference): an
// invalid key's logit is replaced by -1e9, so a query whose keys are all
// invalid averages V uniformly, and no gradient reaches Q or K through an
// invalid key's logit (the Pallas kernel adds (valid - 1) * 1e9 instead;
// the two differ only when every key is invalid). m and s stay two numbers:
// at an all-invalid row m = -1e9, whose float32 ulp is 64, so a folded
// log-sum-exp m + log s would round back to m and give P = 1, not 1 / Nk.
//
// What bounds it on this card. At the teacher's shapes (B 16 x 8 heads,
// 101 tokens, D 32) the forward does ~0.18 GFLOP and moves ~1.7 MB, the
// backward ~0.43 GFLOP and ~2.9 MB: 3 and 6 us at the card's float32 peak,
// well under that at its memory rate. The first port (one block per
// (batch, head), a warp walking 13 rows in series, a single accumulator
// per sum) was bound by that chain's latency at 0.088 and 0.174 ms. This
// design is bound by the instructions of its dot products and weighted
// sums, shared-memory loads and FMAs: test builds without either ran
// markedly faster, and builds without the staging loads little faster.
//   - Grid (row tiles, B * H): a block takes up to kTileRows = 48 query
//     rows (K1a, K1b's dQ blocks) or keys (K1b's dK/dV blocks) of one head,
//     4 per warp, so that hundreds of blocks fill the card; the launcher
//     shrinks the tile to the least multiple of 4 that needs no more tiles
//     (36 for 101 tokens in 3 tiles), so that few padded rows are computed.
//     48 was the fastest of the tiles timed on the card (PERF.md).
//   - The other side's tokens stream through shared memory in chunks of
//     128, 4 per lane (tokens lane + 32 u), so shared memory does not
//     depend on N: no token limit. K1a keeps a running max and sum per row
//     (online softmax); K1b needs none, having m and s.
//   - Register tiles: a warp's 4 rows against a lane's 4 tokens (16 dot
//     products, 32 in K1b with dP), so that each shared-memory load feeds
//     4 FMAs; then the weighted sums with a lane per column, the weights of
//     the 4 rows read as one float4 broadcast.
//   - Layouts without bank conflicts: chunks transposed (D x 128, row
//     stride 129), so that 32 lanes reading 32 tokens of one column, or 32
//     columns of one token, hit 32 banks; a block's own rows transposed
//     (D x rows), read as float4 broadcasts. Global loads are 16 bytes,
//     four per thread and source in flight together.
//   - Short chains: explicit __fmaf_rn (the build's -fmad=false, which
//     K2 and K4 need, does not split it), 16 or 32 independent sums per
//     lane, two partial sums per weighted sum.
//   - Backward as FlashAttention-2 splits it: delta_i = dO_i . O_i (equal
//     to rowsum(P * dP) over all keys, the uniformly averaged all-invalid
//     row included); P = exp(logit - m_i) / s_i, the logits in the
//     forward's arithmetic and order, so the same bits; query-row blocks
//     write dQ, key blocks loop over all query rows of their head and
//     write dK and dV, in one launch (blockIdx.x picks the role). Every
//     output element is written by one lane: no atomics, so the result is
//     the same from run to run.
// D is a template parameter, built for the head widths 8, 16, 32 and 64
// (the configs' FPN widths over 8 heads). The dot products loop over the D
// columns at any width; the weighted sums give a lane one column below
// D = 64 and D / 32 columns from there, and below D = 32 split a chunk's
// tokens among the 32 / D lanes of each column and add their sums with
// shuffles (Lanes<D>). At D = 32 the arithmetic and its order are those
// of the D = 32-only build that came before.
// Shared memory at D = 32: at most 63 KB for K1a and 94 KB for K1b (48
// rows per tile; 55 and 79 KB at the 36 rows used for 101 tokens), so that
// two K1b blocks fit on an SM; at D = 64 103 and 142 KB, one K1b block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxWarps = 12;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kMinBlocks = 2;  // per SM: caps the registers at 85
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kRowsPerWarp * kMaxWarps;  // rows of a full tile
constexpr int kChunk = 128;       // tokens streamed per step, 4 per lane
constexpr int kLd = kChunk + 1;   // row stride of a transposed chunk: odd
constexpr float kMasked = -1e9f;
constexpr int kMaxDevices = 64;

// How a warp's 32 lanes cover D columns in the weighted sums: kColLanes
// lanes per set of columns, kCols columns per lane, kGroups lane groups
// that split the tokens, kParts partial sums per column (two, as short
// chains, while a lane has one column), kAcc sums per row and lane.
template <int D>
struct Lanes {
  static_assert(D % 4 == 0 && (D <= 32 ? 32 % D == 0 : D % 32 == 0),
                "D divides 32 or is a multiple of 32");
  static constexpr int kColLanes = D < 32 ? D : 32;
  static constexpr int kGroups = 32 / kColLanes;
  static constexpr int kCols = D / kColLanes;
  static constexpr int kParts = kCols == 1 ? 2 : 1;
  static constexpr int kAcc = kCols * kParts;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float part(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// n rows (n, D) of each of kCount sources into its dst[c * ld + j] for
// j < n, zeros for n <= j < n_pad; 16-byte loads, four per thread and
// source in flight together. With the chunks' odd ld the stores of a warp
// (4 rows x 8 column quads) hit 32 banks.
template <int D, int kCount>
__device__ void stage_transposed(float* const* dst,
                                 const float* const* src, int n, int n_pad,
                                 int ld) {
  constexpr int kQuads = D / 4, kDepth = 4;
  const int total = n_pad * kQuads, loaded = n * kQuads;
  for (int base = threadIdx.x; base < total; base += kDepth * blockDim.x) {
    float4 x[kCount][kDepth];
#pragma unroll
    for (int t = 0; t < kDepth; ++t) {
      const int idx = base + t * blockDim.x;
#pragma unroll
      for (int a = 0; a < kCount; ++a)
        x[a][t] = idx < loaded ? reinterpret_cast<const float4*>(src[a])[idx]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int t = 0; t < kDepth; ++t) {
      const int idx = base + t * blockDim.x;
      if (idx >= total) break;
      const int j = idx / kQuads;
      const int c = (idx - j * kQuads) * 4;
#pragma unroll
      for (int a = 0; a < kCount; ++a) {
        dst[a][(c + 0) * ld + j] = x[a][t].x;
        dst[a][(c + 1) * ld + j] = x[a][t].y;
        dst[a][(c + 2) * ld + j] = x[a][t].z;
        dst[a][(c + 3) * ld + j] = x[a][t].w;
      }
    }
  }
}

// dO_i . O_i of token i of transposed dO and O, a chain over the columns in
// order: where a row's P is one-hot, O_i = v_j exactly and this equals
// K1b's dP_ij bit for bit, so that dS_ij = P_ij (dP_ij - delta_i) is
// exactly 0, as it is exactly rowsum(P * dP) - dP in the plain version's
// softmax backward
template <int D>
__device__ float row_delta(const float* gt, const float* ot, int ld, int i) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < D; ++c)
    acc = __fmaf_rn(gt[c * ld + i], ot[c * ld + i], acc);
  return acc;
}

// the logit of a dot product: -1e9 for an invalid key, -inf past the keys
__device__ __forceinline__ float masked_logit(float dot, float scale,
                                              bool in_range, float valid) {
  return !in_range ? -INFINITY : valid != 0.0f ? dot * scale : kMasked;
}

// acc[r][.] += w_r(j) x(j) over the chunk's tokens j < n, for the warp's 4
// rows (weights w4[j], a float4 per token) and the lane's columns of a
// transposed chunk xt (row stride ld): the lane's group takes tokens
// 4 g + 4 kGroups u, in order, alternating between its two partial sums
template <int D>
__device__ __forceinline__ void weighted_sum(float (&acc)[4][Lanes<D>::kAcc],
                                             const float4* w4,
                                             const float* xt, int ld, int n,
                                             int lane) {
  using L = Lanes<D>;
  const int grp = lane / L::kColLanes, col = lane % L::kColLanes;
  for (int j = 4 * grp; j < n; j += 4 * L::kGroups) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float4 w = w4[j + t];
#pragma unroll
      for (int cc = 0; cc < L::kCols; ++cc) {
        const float x = xt[(col + 32 * cc) * ld + j + t];
        const int a = cc * L::kParts + t % L::kParts;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[r][a] = __fmaf_rn(part(w, r), x, acc[r][a]);
      }
    }
  }
}

// Adds the lane groups' sums of each column (below D = 32); every lane of
// the warp takes part
template <int D>
__device__ __forceinline__ void reduce_groups(
    float (&acc)[4][Lanes<D>::kAcc]) {
  using L = Lanes<D>;
#pragma unroll
  for (int o = L::kColLanes; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int a = 0; a < L::kAcc; ++a)
        acc[r][a] += __shfl_xor_sync(0xffffffffu, acc[r][a], o);
}

// Column col + 32 cc of a row's sums
template <int D>
__device__ __forceinline__ float column_total(const float* acc, int cc) {
  using L = Lanes<D>;
  return L::kParts == 2 ? acc[2 * cc] + acc[2 * cc + 1] : acc[cc];
}

// K1a. A block takes `rows` query rows of one head, 4 per warp; the keys
// stream through in chunks of 128, 4 per lane (keys lane + 32 u), with an
// online softmax (running max and sum per row, rescaled per chunk).
template <int D>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v,
                const uint8_t* __restrict__ key_valid,
                float* __restrict__ out, float* __restrict__ row_m,
                float* __restrict__ row_s, int heads, int nq, int nk,
                int rows, float scale) {
  using L = Lanes<D>;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / heads;
  const int row0 = static_cast<int>(blockIdx.x) * rows;
  const int n_rows = min(rows, nq - row0);
  float4* ebuf = reinterpret_cast<float4*>(smem);  // rows / 4 * kChunk
  float* qt = smem + rows * kChunk;                // D * rows, transposed
  float* kt = qt + D * rows;                       // D * kLd, transposed
  float* vt = kt + D * kLd;                        // D * kLd
  float* valid = vt + D * kLd;                     // kChunk

  const int64_t q0 = (static_cast<int64_t>(bh) * nq + row0) * D;
  const int64_t kv = static_cast<int64_t>(bh) * nk * D;
  {
    float* dst[1] = {qt};
    const float* src[1] = {q + q0};
    stage_transposed<D, 1>(dst, src, n_rows, rows, rows);
  }
  const int r0 = kRowsPerWarp * warp;
  float4* e4 = ebuf + warp * kChunk;
  float m[4], s[4], o[4][L::kAcc];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.0f;
#pragma unroll
    for (int a = 0; a < L::kAcc; ++a) o[r][a] = 0.0f;
  }
  for (int k0 = 0; k0 < nk; k0 += kChunk) {
    const int n = min(kChunk, nk - k0);
    __syncthreads();  // the previous chunk is read
    {
      float* dst[2] = {kt, vt};
      const float* src[2] = {k + kv + static_cast<int64_t>(k0) * D,
                             v + kv + static_cast<int64_t>(k0) * D};
      stage_transposed<D, 2>(dst, src, n, kChunk, kLd);
    }
    for (int j = threadIdx.x; j < kChunk; j += blockDim.x)
      valid[j] = j < n && key_valid[static_cast<int64_t>(b) * nk + k0 + j];
    __syncthreads();
    // logits of the warp's 4 rows against the lane's 4 keys
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][u] = 0.0f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float4 qc = *reinterpret_cast<const float4*>(qt + c * rows + r0);
      float kc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) kc[u] = kt[c * kLd + lane + 32 * u];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[r][u] = __fmaf_rn(part(qc, r), kc[u], acc[r][u]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = lane + 32 * u;
        acc[r][u] = masked_logit(acc[r][u], scale, j < n, valid[j]);
        cmax = fmaxf(cmax, acc[r][u]);
      }
      const float m_new = fmaxf(m[r], warp_max(cmax));
      const float alpha = expf(m[r] - m_new);
      float csum = 0.0f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[r][u] = expf(acc[r][u] - m_new);
        csum += acc[r][u];
      }
      m[r] = m_new;
      s[r] = s[r] * alpha + warp_sum(csum);
#pragma unroll
      for (int a = 0; a < L::kAcc; ++a) o[r][a] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      e4[lane + 32 * u] =
          make_float4(acc[0][u], acc[1][u], acc[2][u], acc[3][u]);
    __syncwarp();
    // out[i, d] += e_ij v_j[d]
    weighted_sum<D>(o, e4, vt, kLd, n, lane);
  }
  reduce_groups<D>(o);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + r;
    if (i >= n_rows) break;
    const int64_t row = static_cast<int64_t>(bh) * nq + row0 + i;
    if (lane < L::kColLanes) {
#pragma unroll
      for (int cc = 0; cc < L::kCols; ++cc)
        out[row * D + lane + 32 * cc] =
            nk > 0 ? column_total<D>(o[r], cc) / s[r] : 0.0f;
    }
    if (lane == 0) {
      row_m[row] = m[r];
      row_s[row] = s[r];
    }
  }
}

// K1b's query-row blocks: dQ of `rows` query rows, 4 per warp, against the
// keys streamed in chunks of 128
template <int D>
__device__ void attn_bwd_dq(float* smem, const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const uint8_t* __restrict__ key_valid,
                            const float* __restrict__ o,
                            const float* __restrict__ row_m,
                            const float* __restrict__ row_s,
                            const float* __restrict__ g,
                            float* __restrict__ dq, int tile, int heads,
                            int nq, int nk, int rows, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / heads;
  const int row0 = tile * rows, n_rows = min(rows, nq - row0);
  float4* dsbuf = reinterpret_cast<float4*>(smem);  // rows / 4 * kChunk
  float* ot = smem;  // D * rows, transposed, read before dsbuf is written
  float* qt = smem + rows * kChunk;                 // D * rows, transposed
  float* gt = qt + D * rows;                        // D * rows
  float* stat = gt + D * rows;                      // 3 * rows: m, s, delta
  float* kt = stat + 3 * rows;                      // D * kLd, transposed
  float* vt = kt + D * kLd;                         // D * kLd
  float* valid = vt + D * kLd;                      // kChunk

  const int64_t q0 = (static_cast<int64_t>(bh) * nq + row0) * D;
  const int64_t kv = static_cast<int64_t>(bh) * nk * D;
  {
    float* dst[3] = {qt, gt, ot};
    const float* src[3] = {q + q0, g + q0, o + q0};
    stage_transposed<D, 3>(dst, src, n_rows, rows, rows);
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const bool in = r < n_rows;
    stat[r] = in ? row_m[q0 / D + r] : 0.0f;
    stat[rows + r] = in ? row_s[q0 / D + r] : 1.0f;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    stat[2 * rows + r] = row_delta<D>(gt, ot, rows, r);
  const int r0 = kRowsPerWarp * warp;
  const bool active = r0 < rows;  // a block's warps cover both roles' tiles
  float4* ds4 = dsbuf + warp * kChunk;
  float acc_q[4][Lanes<D>::kAcc] = {};
  for (int k0 = 0; k0 < nk; k0 += kChunk) {
    const int n = min(kChunk, nk - k0);
    __syncthreads();
    {
      float* dst[2] = {kt, vt};
      const float* src[2] = {k + kv + static_cast<int64_t>(k0) * D,
                             v + kv + static_cast<int64_t>(k0) * D};
      stage_transposed<D, 2>(dst, src, n, kChunk, kLd);
    }
    for (int j = threadIdx.x; j < kChunk; j += blockDim.x)
      valid[j] = j < n && key_valid[static_cast<int64_t>(b) * nk + k0 + j];
    __syncthreads();
    if (!active) continue;
    // logits and dP = dO v of the warp's 4 rows against the lane's 4 keys
    float sacc[4][4], pacc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) sacc[r][u] = pacc[r][u] = 0.0f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float4 qc = *reinterpret_cast<const float4*>(qt + c * rows + r0);
      const float4 gc = *reinterpret_cast<const float4*>(gt + c * rows + r0);
      float kc[4], vc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        kc[u] = kt[c * kLd + lane + 32 * u];
        vc[u] = vt[c * kLd + lane + 32 * u];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          sacc[r][u] = __fmaf_rn(part(qc, r), kc[u], sacc[r][u]);
          pacc[r][u] = __fmaf_rn(part(gc, r), vc[u], pacc[r][u]);
        }
    }
    // dS = P (dP - delta), P = exp(logit - m) / s
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = lane + 32 * u;
      const bool in = j < n, live = in && valid[j] != 0.0f;
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p =
            in ? expf(masked_logit(sacc[r][u], scale, in, valid[j]) -
                      stat[r0 + r]) /
                     stat[rows + r0 + r]
               : 0.0f;
        ds[r] = live ? p * (pacc[r][u] - stat[2 * rows + r0 + r]) : 0.0f;
      }
      ds4[j] = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();
    // dq[i, d] += dS_ij k_j[d]
    weighted_sum<D>(acc_q, ds4, kt, kLd, n, lane);
  }
  if (!active) return;
  reduce_groups<D>(acc_q);
  if (lane >= Lanes<D>::kColLanes) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r0 + r >= n_rows) break;
#pragma unroll
    for (int cc = 0; cc < Lanes<D>::kCols; ++cc)
      dq[q0 + static_cast<int64_t>(r0 + r) * D + lane + 32 * cc] =
          column_total<D>(acc_q[r], cc) * scale;
  }
}

// K1b's key blocks: dK and dV of `rows` keys, 4 per warp, against the query
// rows streamed in chunks of 128, 4 per lane (rows lane + 32 u)
template <int D>
__device__ void attn_bwd_dkv(float* smem, const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const uint8_t* __restrict__ key_valid,
                             const float* __restrict__ o,
                             const float* __restrict__ row_m,
                             const float* __restrict__ row_s,
                             const float* __restrict__ g,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int tile, int heads, int nq, int nk, int rows,
                             float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / heads;
  const int key0 = tile * rows, n_keys = min(rows, nk - key0);
  float4* pbuf = reinterpret_cast<float4*>(smem);   // rows / 4 * kChunk
  float4* dsbuf = pbuf + rows / kRowsPerWarp * kChunk;
  float* ot = smem;  // D * kLd, transposed, read before pbuf is written
  float* ktile = smem + max(2 * rows * kChunk, D * kLd);  // D * rows
  float* vtile = ktile + D * rows;                  // D * rows
  float* kvalid = vtile + D * rows;                 // rows
  float* stat = kvalid + rows;                      // 3 * kChunk
  float* qt = stat + 3 * kChunk;                    // D * kLd, transposed
  float* gt = qt + D * kLd;                         // D * kLd

  const int64_t k0 = (static_cast<int64_t>(bh) * nk + key0) * D;
  const int64_t qg = static_cast<int64_t>(bh) * nq * D;
  {
    float* dst[2] = {ktile, vtile};
    const float* src[2] = {k + k0, v + k0};
    stage_transposed<D, 2>(dst, src, n_keys, rows, rows);
  }
  for (int t = threadIdx.x; t < rows; t += blockDim.x)
    kvalid[t] =
        t < n_keys && key_valid[static_cast<int64_t>(b) * nk + key0 + t];
  const int r0 = kRowsPerWarp * warp;
  const bool active = r0 < rows;
  float4* p4 = pbuf + warp * kChunk;
  float4* ds4 = dsbuf + warp * kChunk;
  float acc_v[4][Lanes<D>::kAcc] = {}, acc_k[4][Lanes<D>::kAcc] = {};
  for (int i0 = 0; i0 < nq; i0 += kChunk) {
    const int n = min(kChunk, nq - i0);
    __syncthreads();
    const int64_t off = qg + static_cast<int64_t>(i0) * D;
    {
      float* dst[3] = {qt, gt, ot};
      const float* src[3] = {q + off, g + off, o + off};
      stage_transposed<D, 3>(dst, src, n, kChunk, kLd);
    }
    for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
      const bool in = i < n;
      stat[i] = in ? row_m[off / D + i] : 0.0f;
      stat[kChunk + i] = in ? row_s[off / D + i] : 1.0f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk; i += blockDim.x)
      stat[2 * kChunk + i] = row_delta<D>(gt, ot, kLd, i);
    __syncthreads();
    if (!active) continue;
    // logits and dP of the lane's 4 query rows against the warp's 4 keys
    float sacc[4][4], pacc[4][4];  // [key][row]
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) sacc[r][u] = pacc[r][u] = 0.0f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float4 kc =
          *reinterpret_cast<const float4*>(ktile + c * rows + r0);
      const float4 vc =
          *reinterpret_cast<const float4*>(vtile + c * rows + r0);
      float qc[4], gc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        qc[u] = qt[c * kLd + lane + 32 * u];
        gc[u] = gt[c * kLd + lane + 32 * u];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          sacc[r][u] = __fmaf_rn(qc[u], part(kc, r), sacc[r][u]);
          pacc[r][u] = __fmaf_rn(gc[u], part(vc, r), pacc[r][u]);
        }
    }
    // P = exp(logit - m) / s and dS = P (dP - delta) for the 4 x 4
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = lane + 32 * u;
      const bool in = i < n;
      const float m = stat[i], s = stat[kChunk + i];
      const float delta = stat[2 * kChunk + i];
      float p[4], ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float kv_ok = kvalid[r0 + r];
        p[r] = in ? expf(masked_logit(sacc[r][u], scale, true, kv_ok) - m) / s
                  : 0.0f;
        ds[r] = in && kv_ok != 0.0f ? p[r] * (pacc[r][u] - delta) : 0.0f;
      }
      p4[i] = make_float4(p[0], p[1], p[2], p[3]);
      ds4[i] = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();
    // dv[j, d] += P_ij dO_i[d], dk[j, d] += dS_ij q_i[d]
    weighted_sum<D>(acc_v, p4, gt, kLd, n, lane);
    weighted_sum<D>(acc_k, ds4, qt, kLd, n, lane);
  }
  if (!active) return;
  reduce_groups<D>(acc_v);
  reduce_groups<D>(acc_k);
  if (lane >= Lanes<D>::kColLanes) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r0 + r >= n_keys) break;
    const int64_t row = k0 + static_cast<int64_t>(r0 + r) * D;
#pragma unroll
    for (int cc = 0; cc < Lanes<D>::kCols; ++cc) {
      dv[row + lane + 32 * cc] = column_total<D>(acc_v[r], cc);
      dk[row + lane + 32 * cc] = column_total<D>(acc_k[r], cc) * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v,
                const uint8_t* __restrict__ key_valid,
                const float* __restrict__ o, const float* __restrict__ row_m,
                const float* __restrict__ row_s, const float* __restrict__ g,
                float* __restrict__ dq, float* __restrict__ dk,
                float* __restrict__ dv, int heads, int nq, int nk,
                int q_rows, int k_rows, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int q_tiles = (nq + q_rows - 1) / q_rows;
  if (static_cast<int>(blockIdx.x) < q_tiles)
    attn_bwd_dq<D>(smem, q, k, v, key_valid, o, row_m, row_s, g, dq,
                   blockIdx.x, heads, nq, nk, q_rows, scale);
  else
    attn_bwd_dkv<D>(smem, q, k, v, key_valid, o, row_m, row_s, g, dk, dv,
                    blockIdx.x - q_tiles, heads, nq, nk, k_rows, scale);
}

// warps of a block that takes `rows` rows, 4 per warp
int warps_for(int rows) { return rows / kRowsPerWarp; }

// The rows of a tile for n rows: as many tiles as kTileRows gives, each as
// small a multiple of 4 as covers n (36 for 101 rows in 3 tiles, not 48),
// so that fewer padded rows are computed.
int fit_rows(int n) {
  if (n <= 0) return kTileRows;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int per = (n + tiles - 1) / tiles;
  return (per + kRowsPerWarp - 1) / kRowsPerWarp * kRowsPerWarp;
}

size_t fwd_smem(int d, int rows) {
  return sizeof(float) * (rows * kChunk + d * rows + 2 * d * kLd + kChunk);
}

// K1b's query-row blocks alias O's tile with dS's buffers, and its key
// blocks O's chunk with P's and dS's: O is read first, for delta
size_t bwd_smem(int d, int q_rows, int k_rows) {
  const size_t dq_buf = q_rows * kChunk, o_tile = d * q_rows;
  const size_t kv_buf = 2 * k_rows * kChunk, o_chunk = d * kLd;
  const size_t dq = (dq_buf > o_tile ? dq_buf : o_tile) + 2 * d * q_rows +
                    3 * q_rows + 2 * d * kLd + kChunk;
  const size_t dkv = (kv_buf > o_chunk ? kv_buf : o_chunk) + 2 * d * k_rows +
                     k_rows + 3 * kChunk + 2 * d * kLd;
  return sizeof(float) * (dq > dkv ? dq : dkv);
}

// Lets `kernel` take up to `limit` bytes of dynamic shared memory on
// `device`, once per kernel and device.
int allow_smem(const void* kernel, std::atomic<bool>* done, int device,
               int limit) {
  if (device >= 0 && device < kMaxDevices && done[device].load()) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
    done[device].store(true);
  return static_cast<int>(err);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v,
               const uint8_t* key_valid, float* out, float* m, float* s,
               int batch, int heads, int nq, int nk, float scale, int device,
               int smem_limit, cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  const int rows = fit_rows(nq);
  const size_t smem = fwd_smem(D, rows);
  if (smem > static_cast<size_t>(smem_limit))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = allow_smem(reinterpret_cast<const void*>(attn_fwd_kernel<D>),
                       ready, device, smem_limit);
  if (err != 0) return err;
  const dim3 grid((nq + rows - 1) / rows, batch * heads);
  attn_fwd_kernel<D><<<grid, 32 * warps_for(rows), smem, stream>>>(
      q, k, v, key_valid, out, m, s, heads, nq, nk, rows, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v,
               const uint8_t* key_valid, const float* o, const float* m,
               const float* s, const float* g, float* dq, float* dk,
               float* dv, int batch, int heads, int nq, int nk, float scale,
               int device, int smem_limit, cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  const int q_rows = fit_rows(nq), k_rows = fit_rows(nk);
  const size_t smem = bwd_smem(D, q_rows, k_rows);
  if (smem > static_cast<size_t>(smem_limit))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = allow_smem(reinterpret_cast<const void*>(attn_bwd_kernel<D>),
                       ready, device, smem_limit);
  if (err != 0) return err;
  const dim3 grid((nq + q_rows - 1) / q_rows + (nk + k_rows - 1) / k_rows,
                  batch * heads);
  const int threads = 32 * warps_for(q_rows > k_rows ? q_rows : k_rows);
  attn_bwd_kernel<D><<<grid, threads, smem, stream>>>(
      q, k, v, key_valid, o, m, s, g, dq, dk, dv, heads, nq, nk, q_rows,
      k_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, Nq, D), k and v (B, H, Nk, D) float32 contiguous, 16-byte
// aligned, D one of 8, 16, 32 and 64; key_valid (B, Nk) bool; writes out
// (B, H, Nq, D) and the rows' softmax max m and sum s (B, H, Nq). The
// kernel may take `smem_limit` bytes of shared memory on `device`. Shared
// memory does not depend on the number of tokens, which stream through in
// chunks. Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// another D).
extern "C" int lgd_attn_fwd(const float* q, const float* k, const float* v,
                            const uint8_t* key_valid, float* out, float* m,
                            float* s, int batch, int heads, int nq, int nk,
                            int d, float scale, int device, int smem_limit,
                            void* stream) {
  if (batch * heads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || heads == 0 || nq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LGD_ATTN_FWD(D)                                                    \
  case D:                                                                  \
    return launch_fwd<D>(q, k, v, key_valid, out, m, s, batch, heads, nq, \
                         nk, scale, device, smem_limit, st);
  switch (d) {
    LGD_ATTN_FWD(8)
    LGD_ATTN_FWD(16)
    LGD_ATTN_FWD(32)
    LGD_ATTN_FWD(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LGD_ATTN_FWD
}

// As lgd_attn_fwd's inputs plus its out, m and s and the output gradient g
// (B, H, Nq, D); writes dq (B, H, Nq, D), dk and dv (B, H, Nk, D).
extern "C" int lgd_attn_bwd(const float* q, const float* k, const float* v,
                            const uint8_t* key_valid, const float* o,
                            const float* m, const float* s, const float* g,
                            float* dq, float* dk, float* dv, int batch,
                            int heads, int nq, int nk, int d, float scale,
                            int device, int smem_limit, void* stream) {
  if (batch * heads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || heads == 0 || (nq == 0 && nk == 0)) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LGD_ATTN_BWD(D)                                                   \
  case D:                                                                 \
    return launch_bwd<D>(q, k, v, key_valid, o, m, s, g, dq, dk, dv,     \
                         batch, heads, nq, nk, scale, device, smem_limit, \
                         st);
  switch (d) {
    LGD_ATTN_BWD(8)
    LGD_ATTN_BWD(16)
    LGD_ATTN_BWD(32)
    LGD_ATTN_BWD(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LGD_ATTN_BWD
}
