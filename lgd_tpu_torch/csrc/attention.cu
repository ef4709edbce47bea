// Masked multi-head attention of the LGD teacher for Hopper (sm_90a),
// float32, bound to Python through ctypes. Kernels K1a and K1b.
//
// K1a, attn_fwd_kernel, replaces the TPU kernel
// lgd_tpu/ops/attention.py::_pallas_fwd_impl (body _attn_kernel):
//     out = softmax(where(valid, Q K^T * scale, -1e9)) V
// K1b, attn_bwd_kernel, replaces lgd_tpu/ops/attention.py::_pallas_bwd_impl
// (body _attn_bwd_kernel): it recomputes P and writes dQ, dK and dV.
//
// The mask follows the plain reference (masked_attention_reference): an
// invalid key's logit is replaced by -1e9, so a query whose keys are all
// invalid averages V uniformly, and no gradient reaches Q or K through an
// invalid key's logit (the Pallas kernel adds (valid - 1) * 1e9 instead;
// the two differ only when every key is invalid).
//
// Design. One block of 8 warps per (batch, head), as the Pallas grid has
// one step per (batch, head). The block stages its Q, K, V (and G) rows in
// shared memory with a row stride of D + 1 floats, so that lanes reading
// 32 different rows at one column hit 32 different banks. Nothing of size
// N x N is ever stored: query rows stream through the warps, one row per
// warp at a time, with that row's probabilities in a per-warp buffer.
//   forward:  warp per query row i: logits over the keys (lane per key),
//             warp max and sum, P row, then out[i, d] (lane per d).
//   backward: pass 1, warp per query row i: P row, dP row = g_i . v_j,
//             rowsum_i = sum_j P dP, dS = P (dP - rowsum_i), then
//             dQ[i, d] = scale * sum_j dS_j k_j[d]; the row's softmax max,
//             sum and rowsum stay in shared memory.
//             pass 2, warp per key j: recompute P[:, j] and dS[:, j] from
//             those statistics (same arithmetic in the same order, so the
//             same bits), then dV[j, d] = sum_i P g_i[d] and
//             dK[j, d] = scale * sum_i dS q_i[d].
//   Every output element is written by one lane: no atomics, so the
//   result does not change from run to run.
//
// What bounds it on this card: at the teacher's shapes (B x 8 heads,
// N = 101, D = 32) the work is ~1.3 MFLOP (forward) to ~3.3 MFLOP
// (backward) per block and the bytes are 39-65 KB per block: the card
// could do all of it in a few microseconds, so the kernels are bound by
// latency (one block per head, a serial loop over rows in each warp, the
// launch itself). The design keeps every byte read once from device
// memory and the N x N matrix out of it; tensor cores and tiling are later
// work. Shared memory grows as O(N * D), so N is limited only by the 227 KB
// a block may hold: about 380 tokens at D = 32 (lgd_attn_smem_bytes gives
// the bytes; the wrapper raises above the card's limit).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kMasked = -1e9f;

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

// rows (n, d) from global memory into shared memory with row stride d + 1
__device__ void stage_rows(float* dst, const float* __restrict__ src, int n,
                           int d) {
  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int r = idx / d;
    dst[r * (d + 1) + (idx - r * d)] = src[idx];
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int d) {
  float s = 0.0f;
  for (int c = 0; c < d; ++c) s += a[c] * b[c];
  return s;
}

__device__ __forceinline__ float logit(const float* q_row, const float* k_row,
                                       int d, float scale, float valid) {
  return valid != 0.0f ? dot(q_row, k_row, d) * scale : kMasked;
}

// Softmax of query row q_row against every key into p[0, nk); returns its
// max and sum (for recomputation) through m_out / sum_out. Warp-wide.
__device__ void softmax_row(const float* q_row, const float* ks,
                            const float* valid, int nk, int d, float scale,
                            float* p, float* m_out, float* sum_out) {
  const int lane = threadIdx.x & 31;
  const int ld = d + 1;
  float m = -INFINITY;
  for (int j = lane; j < nk; j += 32) {
    const float l = logit(q_row, ks + j * ld, d, scale, valid[j]);
    p[j] = l;
    m = fmaxf(m, l);
  }
  m = warp_max(m);
  float s = 0.0f;
  for (int j = lane; j < nk; j += 32) {
    const float e = expf(p[j] - m);
    p[j] = e;
    s += e;
  }
  s = warp_sum(s);
  for (int j = lane; j < nk; j += 32) p[j] = p[j] / s;
  __syncwarp();
  *m_out = m;
  *sum_out = s;
}

__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v,
                const uint8_t* __restrict__ key_valid,
                float* __restrict__ out, int heads, int nq, int nk, int d,
                float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  float* qs = smem;                   // nq * ld
  float* ks = qs + nq * ld;           // nk * ld
  float* vs = ks + nk * ld;           // nk * ld
  float* valid = vs + nk * ld;        // nk
  float* prow = valid + nk;           // kWarps * nk

  stage_rows(qs, q + static_cast<int64_t>(bh) * nq * d, nq, d);
  stage_rows(ks, k + static_cast<int64_t>(bh) * nk * d, nk, d);
  stage_rows(vs, v + static_cast<int64_t>(bh) * nk * d, nk, d);
  for (int j = threadIdx.x; j < nk; j += blockDim.x)
    valid[j] = key_valid[static_cast<int64_t>(b) * nk + j] ? 1.0f : 0.0f;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* p = prow + warp * nk;
  for (int i = warp; i < nq; i += kWarps) {
    float m, s;
    softmax_row(qs + i * ld, ks, valid, nk, d, scale, p, &m, &s);
    float* o = out + (static_cast<int64_t>(bh) * nq + i) * d;
    for (int c = lane; c < d; c += 32) {
      float acc = 0.0f;
      for (int j = 0; j < nk; ++j) acc += p[j] * vs[j * ld + c];
      o[c] = acc;
    }
    __syncwarp();  // p is rewritten by the next row
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v,
                const uint8_t* __restrict__ key_valid,
                const float* __restrict__ g, float* __restrict__ dq,
                float* __restrict__ dk, float* __restrict__ dv, int heads,
                int nq, int nk, int d, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int nmax = nq > nk ? nq : nk;
  float* qs = smem;                   // nq * ld
  float* gs = qs + nq * ld;           // nq * ld
  float* ks = gs + nq * ld;           // nk * ld
  float* vs = ks + nk * ld;           // nk * ld
  float* valid = vs + nk * ld;        // nk
  float* row_m = valid + nk;          // nq: softmax max of each query row
  float* row_s = row_m + nq;          // nq: softmax sum
  float* row_r = row_s + nq;          // nq: rowsum(P * dP)
  float* buf = row_r + nq;            // kWarps * 2 * nmax

  stage_rows(qs, q + static_cast<int64_t>(bh) * nq * d, nq, d);
  stage_rows(gs, g + static_cast<int64_t>(bh) * nq * d, nq, d);
  stage_rows(ks, k + static_cast<int64_t>(bh) * nk * d, nk, d);
  stage_rows(vs, v + static_cast<int64_t>(bh) * nk * d, nk, d);
  for (int j = threadIdx.x; j < nk; j += blockDim.x)
    valid[j] = key_valid[static_cast<int64_t>(b) * nk + j] ? 1.0f : 0.0f;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* pa = buf + warp * 2 * nmax;  // P row (pass 1) / P column (pass 2)
  float* pb = pa + nmax;              // dS row / dS column

  // pass 1: one query row per warp -> dQ and the row statistics
  for (int i = warp; i < nq; i += kWarps) {
    const float* q_row = qs + i * ld;
    const float* g_row = gs + i * ld;
    float m, s;
    softmax_row(q_row, ks, valid, nk, d, scale, pa, &m, &s);
    float r = 0.0f;
    for (int j = lane; j < nk; j += 32) {
      const float dp = dot(g_row, vs + j * ld, d);
      pb[j] = dp;
      r += pa[j] * dp;
    }
    r = warp_sum(r);
    for (int j = lane; j < nk; j += 32)
      pb[j] = valid[j] != 0.0f ? pa[j] * (pb[j] - r) : 0.0f;
    __syncwarp();
    float* o = dq + (static_cast<int64_t>(bh) * nq + i) * d;
    for (int c = lane; c < d; c += 32) {
      float acc = 0.0f;
      for (int j = 0; j < nk; ++j) acc += pb[j] * ks[j * ld + c];
      o[c] = acc * scale;
    }
    if (lane == 0) {
      row_m[i] = m;
      row_s[i] = s;
      row_r[i] = r;
    }
    __syncwarp();
  }
  __syncthreads();

  // pass 2: one key per warp -> dK and dV
  for (int j = warp; j < nk; j += kWarps) {
    const float* k_row = ks + j * ld;
    const float* v_row = vs + j * ld;
    const float vj = valid[j];
    for (int i = lane; i < nq; i += 32) {
      const float l = logit(qs + i * ld, k_row, d, scale, vj);
      const float p = expf(l - row_m[i]) / row_s[i];
      const float dp = dot(gs + i * ld, v_row, d);
      pa[i] = p;
      pb[i] = vj != 0.0f ? p * (dp - row_r[i]) : 0.0f;
    }
    __syncwarp();
    float* odk = dk + (static_cast<int64_t>(bh) * nk + j) * d;
    float* odv = dv + (static_cast<int64_t>(bh) * nk + j) * d;
    for (int c = lane; c < d; c += 32) {
      float acc_v = 0.0f, acc_k = 0.0f;
      for (int i = 0; i < nq; ++i) {
        acc_v += pa[i] * gs[i * ld + c];
        acc_k += pb[i] * qs[i * ld + c];
      }
      odv[c] = acc_v;
      odk[c] = acc_k * scale;
    }
    __syncwarp();
  }
}

size_t fwd_smem(int nq, int nk, int d) {
  return sizeof(float) *
         (static_cast<size_t>(nq + 2 * nk) * (d + 1) + nk + kWarps * nk);
}

size_t bwd_smem(int nq, int nk, int d) {
  const int nmax = nq > nk ? nq : nk;
  return sizeof(float) * (static_cast<size_t>(2 * nq + 2 * nk) * (d + 1) +
                          nk + 3 * nq + kWarps * 2 * nmax);
}

int launch_setup(const void* kernel, size_t smem) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

// Shared memory the two kernels need, in bytes, for nq queries and nk keys
// of width d (the wrapper checks it against the card's per-block limit).
extern "C" long long lgd_attn_smem_bytes(int nq, int nk, int d) {
  const size_t f = fwd_smem(nq, nk, d), b = bwd_smem(nq, nk, d);
  return static_cast<long long>(f > b ? f : b);
}

// q (B, H, Nq, D), k and v (B, H, Nk, D) float32 contiguous; key_valid
// (B, Nk) bool; out (B, H, Nq, D). Returns the cudaError_t of the launch.
extern "C" int lgd_attn_fwd(const float* q, const float* k, const float* v,
                            const uint8_t* key_valid, float* out, int batch,
                            int heads, int nq, int nk, int d, float scale,
                            void* stream) {
  if (batch == 0 || heads == 0 || nq == 0) return 0;
  const size_t smem = fwd_smem(nq, nk, d);
  int err = launch_setup(reinterpret_cast<const void*>(attn_fwd_kernel), smem);
  if (err != 0) return err;
  attn_fwd_kernel<<<batch * heads, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      q, k, v, key_valid, out, heads, nq, nk, d, scale);
  return static_cast<int>(cudaGetLastError());
}

// As lgd_attn_fwd plus the output gradient g (B, H, Nq, D); writes dq
// (B, H, Nq, D), dk and dv (B, H, Nk, D).
extern "C" int lgd_attn_bwd(const float* q, const float* k, const float* v,
                            const uint8_t* key_valid, const float* g,
                            float* dq, float* dk, float* dv, int batch,
                            int heads, int nq, int nk, int d, float scale,
                            void* stream) {
  if (batch == 0 || heads == 0 || (nq == 0 && nk == 0)) return 0;
  const size_t smem = bwd_smem(nq, nk, d);
  int err = launch_setup(reinterpret_cast<const void*>(attn_bwd_kernel), smem);
  if (err != 0) return err;
  attn_bwd_kernel<<<batch * heads, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      q, k, v, key_valid, g, dq, dk, dv, heads, nq, nk, d, scale);
  return static_cast<int>(cudaGetLastError());
}
