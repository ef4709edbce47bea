// Modulated deformable sampling (DCNv2) for Hopper (sm_90a), forward and
// backward, bound to Python through ctypes: kernel K4 of the port.
//
// Replaces the TPU kernel lgd_tpu/ops/deform_conv.py::_pallas_sampler (per
// output row, a 2-hot interpolation matrix built in VMEM and contracted
// against the input window) and its custom VJP, the VJP of the dense
// one-hot-matmul path. The port follows the exact gather form of that file
// (_sample_gather, detectron2's deform_conv.cu semantics), not the windowed
// TPU paths, which clamp offsets beyond about 6 feature px.
//
// Layouts: x (B, C, H, W) float32 or bfloat16; offsets (B, 2K, Ho, Wo)
// float32, channels (2k, 2k + 1) = (dy, dx) of tap k = ky * kw + kx; mask
// (B, K, Ho, Wo) float32 or null (unmodulated); columns (B, C, K, Ho, Wo)
// in x's dtype, so that the weight contraction (F, C * K) x (C * K, Ho * Wo)
// writes NCHW directly.
//
//   deform_fwd_kernel: one thread per (b, k, output position), neighbouring
//     threads on neighbouring positions. Each thread computes its tap's
//     geometry once (the sample point, its floor corners, their validity
//     and the bilinear fractions), then loops over the channels: four
//     corner reads and one column write each. A warp's writes are one
//     contiguous row of 32 columns; its reads hit neighbouring texels.
//   deform_bwd_kernel: the same walk over the columns' gradient. It adds
//     each valid corner's share to a zeroed float32 copy of x with float32
//     atomics (the caller casts it once); the warp's 32 threads add to 32
//     neighbouring texels of one channel, distinct addresses unless two
//     offsets put their corners on one texel. Each thread keeps the sums
//     over the channels of its offset's and mask's gradients in registers
//     and writes them once (no reduction across threads), and writes the
//     columns again for the weight's gradient (the forward keeps none).
//
// Arithmetic: each sample is computed in float32 as
//   g00 * (1 - wy) * (1 - wx) + g01 * (1 - wy) * wx
//     + g10 * wy * (1 - wx) + g11 * wy * wx,
// left to right, then times the mask, and rounded once to the output's
// dtype: the plain version's operations in the plain version's order
// (build flag -fmad=false: no fused multiply-add), so the float32 forward
// agrees with it bit for bit. The offset's derivative uses the floor
// corners (y0, y0 + 1) at every position, integer ones and -1 included,
// as the gather form's autograd does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Geometry {
  int B, C, H, W, Ho, Wo, kh, kw, stride, pad, dilation;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One tap's sample: the four corners' flat texel indices (-1 where the
// corner lies outside the image), the bilinear fractions and the mask.
struct Tap {
  int i00, i01, i10, i11;
  float a, ay, bx, ax;  // 1 - wy, wy, 1 - wx, wx
  float m;
};

__device__ __forceinline__ int texel(float yc, float xc, int H, int W) {
  const bool valid = yc >= 0.0f && yc < static_cast<float>(H) &&
                     xc >= 0.0f && xc < static_cast<float>(W);
  return valid ? static_cast<int>(yc) * W + static_cast<int>(xc) : -1;
}

__device__ __forceinline__ Tap tap_at(const Geometry& g,
                                      const float* __restrict__ offsets,
                                      const float* __restrict__ mask, int b,
                                      int k, int64_t p) {
  const int64_t P = static_cast<int64_t>(g.Ho) * g.Wo;
  const int K = g.kh * g.kw;
  const int ho = static_cast<int>(p / g.Wo);
  const int wo = static_cast<int>(p % g.Wo);
  const int ky = k / g.kw, kx = k % g.kw;
  const float* off = offsets + (static_cast<int64_t>(b) * 2 * K + 2 * k) * P;
  const float py =
      static_cast<float>(ho * g.stride - g.pad + ky * g.dilation) + off[p];
  const float px =
      static_cast<float>(wo * g.stride - g.pad + kx * g.dilation) + off[P + p];
  const float y0 = floorf(py);
  const float x0 = floorf(px);
  const float wy = py - y0;
  const float wx = px - x0;
  Tap t;
  t.i00 = texel(y0, x0, g.H, g.W);
  t.i01 = texel(y0, x0 + 1.0f, g.H, g.W);
  t.i10 = texel(y0 + 1.0f, x0, g.H, g.W);
  t.i11 = texel(y0 + 1.0f, x0 + 1.0f, g.H, g.W);
  t.a = 1.0f - wy;
  t.ay = wy;
  t.bx = 1.0f - wx;
  t.ax = wx;
  t.m = mask != nullptr ? mask[(static_cast<int64_t>(b) * K + k) * P + p]
                        : 1.0f;
  return t;
}

template <typename T>
__device__ __forceinline__ float corner(const T* __restrict__ xc, int i) {
  return i >= 0 ? to_float(xc[i]) : 0.0f;
}

template <typename T>
__global__ void deform_fwd_kernel(const T* __restrict__ x,
                                  const float* __restrict__ offsets,
                                  const float* __restrict__ mask, Geometry g,
                                  T* __restrict__ cols) {
  const int K = g.kh * g.kw;
  const int64_t P = static_cast<int64_t>(g.Ho) * g.Wo;
  const int64_t HW = static_cast<int64_t>(g.H) * g.W;
  const int64_t total = static_cast<int64_t>(g.B) * K * P;
  const bool modulated = mask != nullptr;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(blockDim.x) * gridDim.x) {
    const int64_t p = i % P;
    const int k = static_cast<int>((i / P) % K);
    const int b = static_cast<int>(i / (P * K));
    const Tap t = tap_at(g, offsets, mask, b, k, p);
    const T* xb = x + static_cast<int64_t>(b) * g.C * HW;
    T* out = cols + (static_cast<int64_t>(b) * g.C * K + k) * P + p;
#pragma unroll 4
    for (int c = 0; c < g.C; ++c) {
      const T* xc = xb + c * HW;
      const float v00 = corner(xc, t.i00);
      const float v01 = corner(xc, t.i01);
      const float v10 = corner(xc, t.i10);
      const float v11 = corner(xc, t.i11);
      float s = v00 * t.a * t.bx + v01 * t.a * t.ax + v10 * t.ay * t.bx +
                v11 * t.ay * t.ax;
      if (modulated) s = s * t.m;
      out[c * K * P] = from_float<T>(s);
    }
  }
}

template <typename T>
__global__ void deform_bwd_kernel(const T* __restrict__ grad,
                                  const T* __restrict__ x,
                                  const float* __restrict__ offsets,
                                  const float* __restrict__ mask, Geometry g,
                                  float* __restrict__ dx,
                                  float* __restrict__ doffsets,
                                  float* __restrict__ dmask,
                                  T* __restrict__ cols) {
  const int K = g.kh * g.kw;
  const int64_t P = static_cast<int64_t>(g.Ho) * g.Wo;
  const int64_t HW = static_cast<int64_t>(g.H) * g.W;
  const int64_t total = static_cast<int64_t>(g.B) * K * P;
  const bool modulated = mask != nullptr;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(blockDim.x) * gridDim.x) {
    const int64_t p = i % P;
    const int k = static_cast<int>((i / P) % K);
    const int b = static_cast<int>(i / (P * K));
    const Tap t = tap_at(g, offsets, mask, b, k, p);
    const int64_t plane = static_cast<int64_t>(b) * g.C * HW;
    const int64_t col0 = (static_cast<int64_t>(b) * g.C * K + k) * P + p;
    float sum_dy = 0.0f, sum_dx = 0.0f, sum_dm = 0.0f;
#pragma unroll 2
    for (int c = 0; c < g.C; ++c) {
      const T* xc = x + plane + c * HW;
      float* dxc = dx + plane + c * HW;
      const float v00 = corner(xc, t.i00);
      const float v01 = corner(xc, t.i01);
      const float v10 = corner(xc, t.i10);
      const float v11 = corner(xc, t.i11);
      const float val = v00 * t.a * t.bx + v01 * t.a * t.ax +
                        v10 * t.ay * t.bx + v11 * t.ay * t.ax;
      cols[col0 + c * K * P] = from_float<T>(modulated ? val * t.m : val);
      const float gc = to_float(grad[col0 + c * K * P]);
      const float gm = modulated ? gc * t.m : gc;
      if (gm != 0.0f) {
        // each corner's share, as autograd of the plain version forms it
        const float s00 = gm * t.bx * t.a, s01 = gm * t.ax * t.a;
        const float s10 = gm * t.bx * t.ay, s11 = gm * t.ax * t.ay;
        if (t.i00 >= 0 && s00 != 0.0f) atomicAdd(dxc + t.i00, s00);
        if (t.i01 >= 0 && s01 != 0.0f) atomicAdd(dxc + t.i01, s01);
        if (t.i10 >= 0 && s10 != 0.0f) atomicAdd(dxc + t.i10, s10);
        if (t.i11 >= 0 && s11 != 0.0f) atomicAdd(dxc + t.i11, s11);
      }
      sum_dy += gm * t.bx * (v10 - v00) + gm * t.ax * (v11 - v01);
      sum_dx += gm * t.a * (v01 - v00) + gm * t.ay * (v11 - v10);
      sum_dm += gc * val;
    }
    float* doff = doffsets + (static_cast<int64_t>(b) * 2 * K + 2 * k) * P;
    doff[p] = sum_dy;
    doff[P + p] = sum_dx;
    if (modulated) dmask[(static_cast<int64_t>(b) * K + k) * P + p] = sum_dm;
  }
}

int grid_for(int64_t total) {
  // a grid-stride loop over at most this many blocks (132 SMs x 32)
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
}

Geometry make_geometry(int B, int C, int H, int W, int Ho, int Wo, int kh,
                       int kw, int stride, int pad, int dilation) {
  Geometry g = {B, C, H, W, Ho, Wo, kh, kw, stride, pad, dilation};
  return g;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x, the columns and their gradient).
// mask may be null (unmodulated). Returns the cudaError_t of the launch (0
// on success; an unsupported dtype is cudaErrorInvalidValue).
extern "C" int lgd_deform_sample_fwd(const void* x, int dtype,
                                     const float* offsets, const float* mask,
                                     int B, int C, int H, int W, int Ho,
                                     int Wo, int kh, int kw, int stride,
                                     int pad, int dilation, void* cols,
                                     void* stream) {
  const Geometry g =
      make_geometry(B, C, H, W, Ho, Wo, kh, kw, stride, pad, dilation);
  const int64_t total = static_cast<int64_t>(B) * kh * kw * Ho * Wo;
  if (total == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    deform_fwd_kernel<float><<<grid_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(x), offsets, mask, g,
        static_cast<float*>(cols));
  } else if (dtype == 1) {
    deform_fwd_kernel<__nv_bfloat16><<<grid_for(total), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), offsets, mask, g,
        static_cast<__nv_bfloat16*>(cols));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad and cols (B, C, K, Ho, Wo) of dtype; dx a zeroed float32 (B, C, H, W)
// buffer; doffsets (B, 2K, Ho, Wo) and dmask (B, K, Ho, Wo, null without a
// mask) float32, every element written.
extern "C" int lgd_deform_sample_bwd(const void* grad, const void* x,
                                     int dtype, const float* offsets,
                                     const float* mask, int B, int C, int H,
                                     int W, int Ho, int Wo, int kh, int kw,
                                     int stride, int pad, int dilation,
                                     float* dx, float* doffsets, float* dmask,
                                     void* cols, void* stream) {
  const Geometry g =
      make_geometry(B, C, H, W, Ho, Wo, kh, kw, stride, pad, dilation);
  const int64_t total = static_cast<int64_t>(B) * kh * kw * Ho * Wo;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    deform_bwd_kernel<float><<<grid_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(grad), static_cast<const float*>(x),
        offsets, mask, g, dx, doffsets, dmask, static_cast<float*>(cols));
  } else if (dtype == 1) {
    deform_bwd_kernel<__nv_bfloat16><<<grid_for(total), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(grad),
        static_cast<const __nv_bfloat16*>(x), offsets, mask, g, dx, doffsets,
        dmask, static_cast<__nv_bfloat16*>(cols));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
