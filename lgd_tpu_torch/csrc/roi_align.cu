// Multilevel ROIAlign (V2, aligned) for Hopper (sm_90a), forward and
// backward, bound to Python through ctypes: kernel K3 of the port.
//
// Replaces the TPU kernel lgd_tpu/ops/roi_align.py::_roi_pallas_fwd (per ROI,
// a DMA of a texel window of its level into VMEM and one interpolation
// matmul) and its custom VJP, the transpose of the dense interpolation-matmul
// path (_roi_pallas_vjp_bwd). The routing of each ROI to a level and its
// geometry (batch index, level, samples per axis, origin, bin sizes) come in
// from lgd_tpu_torch/ops/roi_align.py::roi_geometry; the kernels never route.
//
//   roi_align_fwd_kernel: one thread per output element (roi, channel, bin
//     row, bin column), as detectron2's ROIAlign_forward_kernel. It walks the
//     ROI's actual ny x nx samples of its bin (at most s_max x s_max), reads
//     the four bilinear corners of each from the NCHW level, and sums in
//     float32; it writes in the output's dtype. An invalid ROI (level -1)
//     writes zeros.
//   roi_align_bwd_kernel: the transpose, in the TPU kernel's own form: per
//     ROI a texel window of its level and an interpolation product. A
//     sample's weight is separable, wy * wx (axis_sample folds the 1 / n
//     share and the inside test into each axis), so for each ROI and
//     channel the level's gradient over the ROI's window is Ay^T G Ax, G
//     the pooled out x out gradient, Ay (out x window rows) and Ax (out x
//     window columns) each bin's summed sample weights per texel (a
//     clamped high corner c1 == c0 adds both weights to one texel). A
//     block takes one ROI and a chunk of channels: it builds Ay and Ax in
//     shared memory; a thread per (channel, window column) forms
//     T = G Ax[:, x] in registers and walks the column's rows, each the
//     sum over the bins of Ay[ph][y] T[ph], with no atomics inside the
//     ROI, and adds each non-zero texel to a zeroed float32 buffer of the
//     level with one global atomic (ROIs overlap), a warp's texels
//     neighbours in a row; the caller casts the buffer to the level's
//     dtype. The window is the span of the first and the last sample's
//     corners (the positions grow with the bin and the sample): about
//     out * S_MAX + 2 texels per axis where a bin spans at most S_MAX
//     texels, as FPN routing keeps it for boxes near square; a wider one
//     (an elongated box, or a top-level ROI that spans the whole level) is
//     taken in kWinTile x kWinTile tiles. Invalid ROIs (level -1) add
//     nothing. The atomics make the order of the sums change from run to
//     run.
//
// The sample positions and weights repeat the plain version's float32
// arithmetic operation for operation (build flag -fmad=false: no fused
// multiply-add; IEEE divisions), so the forward agrees with it bit for bit
// in float32.
//
// What bounds the forward on this card: neither bandwidth nor arithmetic.
// Each output element does up to 16 samples x 4 scattered reads that mostly
// hit L2 (neighbouring threads read neighbouring columns of one channel, so
// a warp's reads coalesce only partly). A channels-last layout with
// shared-memory staging of each ROI's window is later work. The backward
// before this form gave each (ROI, channel, bin) a thread and added every
// corner's share with a global atomic: a warp's 32 neighbouring bins
// collided on shared texels and the atomics serialised. This one is bound
// by its global atomics, one per window texel and channel (a test build
// without them ran in well under half the time), added at about the
// card's rate for coalesced float atomics; float2 and float4 atomics add
// no more floats per second.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kWinTile = 32;       // rows and columns of a window tile
constexpr int kMaxChannels = 64;   // channels of a backward block
constexpr int kMaxOut = 16;        // bins per side the backward takes
constexpr int kStaticSmem = 48 * 1024;  // no opt-in needed

template <typename T>
struct Levels {
  T* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
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

struct Axis {
  int c0, c1;
  float w0, w1;
};

// Sample i of n along one axis of bin p: position start + bin * (p + (i +
// 0.5) / n), then detectron2's bilinear rule (outside [-1, size] weighs 0;
// clamp into [0, size - 1]; the high corner clamps to size - 1), with the
// sample's share 1 / n folded into both weights.
__device__ __forceinline__ Axis axis_sample(float start, float bin, int p,
                                            int i, int n, int size) {
  const float nf = static_cast<float>(n);
  const float t = (static_cast<float>(i) + 0.5f) / nf;
  const float c = start + bin * (static_cast<float>(p) + t);
  const float share = 1.0f / nf;
  const float sizef = static_cast<float>(size);
  const bool inside = c >= -1.0f && c <= sizef;
  const float cc = fminf(fmaxf(c, 0.0f), sizef - 1.0f);
  const float c0 = floorf(cc);
  const float frac = cc - c0;
  Axis a;
  a.c0 = static_cast<int>(c0);
  a.c1 = min(a.c0 + 1, size - 1);
  a.w0 = inside ? (1.0f - frac) * share : 0.0f;
  a.w1 = inside ? frac * share : 0.0f;
  return a;
}

struct Roi {
  int b, level, ny, nx;
  float y0, x0, bin_h, bin_w;
};

__device__ __forceinline__ Roi load_roi(const int* index, const float* coords,
                                        int64_t r) {
  Roi roi;
  roi.b = index[r * 4 + 0];
  roi.level = index[r * 4 + 1];
  roi.ny = index[r * 4 + 2];
  roi.nx = index[r * 4 + 3];
  roi.y0 = coords[r * 4 + 0];
  roi.x0 = coords[r * 4 + 1];
  roi.bin_h = coords[r * 4 + 2];
  roi.bin_w = coords[r * 4 + 3];
  return roi;
}

template <typename Tin, typename Tout>
__global__ void roi_align_fwd_kernel(Levels<const Tin> levels,
                                     const int* __restrict__ index,
                                     const float* __restrict__ coords,
                                     int64_t total, int channels, int out,
                                     Tout* __restrict__ y) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(blockDim.x) * gridDim.x) {
    const int pw = static_cast<int>(i % out);
    const int ph = static_cast<int>((i / out) % out);
    const int c = static_cast<int>((i / (out * out)) % channels);
    const int64_t r = i / (static_cast<int64_t>(out) * out * channels);
    const Roi roi = load_roi(index, coords, r);
    float acc = 0.0f;
    if (roi.level >= 0) {
      const int H = levels.h[roi.level];
      const int W = levels.w[roi.level];
      const Tin* f = levels.ptr[roi.level] +
                     (static_cast<int64_t>(roi.b) * channels + c) * H * W;
      for (int iy = 0; iy < roi.ny; ++iy) {
        const Axis ay = axis_sample(roi.y0, roi.bin_h, ph, iy, roi.ny, H);
        for (int ix = 0; ix < roi.nx; ++ix) {
          const Axis ax = axis_sample(roi.x0, roi.bin_w, pw, ix, roi.nx, W);
          const float v00 = to_float(f[ay.c0 * W + ax.c0]);
          const float v01 = to_float(f[ay.c0 * W + ax.c1]);
          const float v10 = to_float(f[ay.c1 * W + ax.c0]);
          const float v11 = to_float(f[ay.c1 * W + ax.c1]);
          const float v = v00 * (ay.w0 * ax.w0) + v01 * (ay.w0 * ax.w1) +
                          v10 * (ay.w1 * ax.w0) + v11 * (ay.w1 * ax.w1);
          acc = acc + v;
        }
      }
    }
    y[i] = from_float<Tout>(acc);
  }
}

// The summed weight of bin p's samples on texel t along one axis: each
// sample's two corners, both on t where the high corner is clamped.
__device__ __forceinline__ float bin_weight(float start, float bin, int p,
                                            int n, int size, int t) {
  float w = 0.0f;
  for (int i = 0; i < n; ++i) {
    const Axis a = axis_sample(start, bin, p, i, n, size);
    if (a.c0 == t) w += a.w0;
    if (a.c1 == t) w += a.w1;
  }
  return w;
}

// The bins per side, out, at run time up to kMaxOut: the loops over the
// bins are unrolled to kMaxOut and skip the bins past out.
template <typename Tg>
__global__ void __launch_bounds__(kThreads, 4)  // 64 registers
roi_align_bwd_kernel(Levels<float> levels, const int* __restrict__ index,
                     const float* __restrict__ coords, int channels, int out,
                     int chunk, const Tg* __restrict__ grad) {
  extern __shared__ float smem[];
  float* ay = smem;                     // kMaxOut x kWinTile
  float* ax = ay + kMaxOut * kWinTile;  // kMaxOut x kWinTile
  float* gs = ax + kMaxOut * kWinTile;  // chunk x out x out: G
  const int64_t r = blockIdx.x;
  const Roi roi = load_roi(index, coords, r);
  const int c0 = blockIdx.y * chunk;
  const int n = min(chunk, channels - c0);
  if (roi.level < 0 || n <= 0) return;  // the whole block
  const int H = levels.h[roi.level];
  const int W = levels.w[roi.level];
  const int64_t HW = static_cast<int64_t>(H) * W;
  float* f = levels.ptr[roi.level] +
             (static_cast<int64_t>(roi.b) * channels + c0) * HW;
  const int oo = out * out;
  const Tg* g = grad + (r * channels + c0) * oo;
  for (int i = threadIdx.x; i < n * oo; i += blockDim.x)
    gs[i] = to_float(g[i]);
  // the window: the first sample's low corner to the last one's high corner
  const int y_lo = axis_sample(roi.y0, roi.bin_h, 0, 0, roi.ny, H).c0;
  const int y_hi =
      axis_sample(roi.y0, roi.bin_h, out - 1, roi.ny - 1, roi.ny, H).c1;
  const int x_lo = axis_sample(roi.x0, roi.bin_w, 0, 0, roi.nx, W).c0;
  const int x_hi =
      axis_sample(roi.x0, roi.bin_w, out - 1, roi.nx - 1, roi.nx, W).c1;
  for (int ty = y_lo; ty <= y_hi; ty += kWinTile) {
    const int th = min(kWinTile, y_hi - ty + 1);
    for (int tx = x_lo; tx <= x_hi; tx += kWinTile) {
      const int tw = min(kWinTile, x_hi - tx + 1);
      __syncthreads();  // G staged; the last tile's Ay and Ax read
      for (int i = threadIdx.x; i < out * (th + tw); i += blockDim.x) {
        const int p = i / (th + tw), t = i - p * (th + tw);
        if (t < th)
          ay[p * kWinTile + t] =
              bin_weight(roi.y0, roi.bin_h, p, roi.ny, H, ty + t);
        else
          ax[p * kWinTile + t - th] =
              bin_weight(roi.x0, roi.bin_w, p, roi.nx, W, tx + t - th);
      }
      __syncthreads();
      // a thread per (channel, window column): T = G Ax[:, x] in
      // registers, then each row's sum over ph of Ay[ph][y] T[ph]
      for (int i = threadIdx.x; i < n * tw; i += blockDim.x) {
        const int c = i / tw, xx = i - c * tw;
        float axr[kMaxOut], t[kMaxOut];
#pragma unroll
        for (int pw = 0; pw < kMaxOut; ++pw)
          axr[pw] = pw < out ? ax[pw * kWinTile + xx] : 0.0f;
        const float* gc = gs + c * oo;
#pragma unroll
        for (int ph = 0; ph < kMaxOut; ++ph) {
          float acc = 0.0f;
          if (ph < out) {
#pragma unroll
            for (int pw = 0; pw < kMaxOut; ++pw)
              if (pw < out) acc += gc[ph * out + pw] * axr[pw];
          }
          t[ph] = acc;
        }
        float* dst = f + c * HW + static_cast<int64_t>(ty) * W + tx + xx;
        for (int yy = 0; yy < th; ++yy) {
          float v = 0.0f;
#pragma unroll
          for (int ph = 0; ph < kMaxOut; ++ph)
            if (ph < out) v += ay[ph * kWinTile + yy] * t[ph];
          if (v != 0.0f) atomicAdd(dst + static_cast<int64_t>(yy) * W, v);
        }
      }
    }
  }
}

int grid_for(int64_t total) {
  // a grid-stride loop over at most this many blocks (132 SMs x 16)
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <typename T>
Levels<T> make_levels(void* const* ptrs, const int* hs, const int* ws,
                      int num_levels) {
  Levels<T> lv = {};
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = static_cast<T*>(ptrs[l]);
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
  }
  return lv;
}

template <typename Tin, typename Tout>
int launch_fwd(void* const* feats, const int* hs, const int* ws,
               int num_levels, int channels, const int* index,
               const float* coords, int64_t total, int out, void* y,
               cudaStream_t s) {
  roi_align_fwd_kernel<Tin, Tout><<<grid_for(total), kThreads, 0, s>>>(
      make_levels<const Tin>(feats, hs, ws, num_levels), index, coords, total,
      channels, out, static_cast<Tout*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename Tg>
int launch_bwd(const Levels<float>& lv, const int* index, const float* coords,
               int channels, int out, int chunk, const void* grad, dim3 grid,
               size_t smem, cudaStream_t s) {
  roi_align_bwd_kernel<Tg><<<grid, kThreads, smem, s>>>(
      lv, index, coords, channels, out, chunk, static_cast<const Tg*>(grad));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.
// feats: num_levels pointers to (B, C, H_l, W_l) levels of one dtype, with
// their heights hs and widths ws; index (R, 4) int32 (batch, level or -1,
// ny, nx); coords (R, 4) float32 (y0, x0, bin_h, bin_w); y (R, C, out, out)
// of out_dtype (float32, or bfloat16 for bfloat16 levels). Returns the
// cudaError_t of the launch (0 on success; an unsupported combination is
// cudaErrorInvalidValue).
extern "C" int lgd_roi_align_fwd(void* const* feats, const int* hs,
                                 const int* ws, int num_levels, int channels,
                                 int feat_dtype, const int* index,
                                 const float* coords, int num_rois, int out,
                                 void* y, int out_dtype, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(num_rois) * channels * out * out;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feat_dtype == 0 && out_dtype == 0) {
    return launch_fwd<float, float>(feats, hs, ws, num_levels, channels,
                                    index, coords, total, out, y, s);
  }
  if (feat_dtype == 1 && out_dtype == 1) {
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(
        feats, hs, ws, num_levels, channels, index, coords, total, out, y, s);
  }
  if (feat_dtype == 1 && out_dtype == 0) {
    return launch_fwd<__nv_bfloat16, float>(feats, hs, ws, num_levels,
                                            channels, index, coords, total,
                                            out, y, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// grad (R, C, out, out) of grad_dtype; grad_feats: num_levels zeroed float32
// (B, C, H_l, W_l) buffers that receive the levels' gradients.
extern "C" int lgd_roi_align_bwd(const void* grad, int grad_dtype,
                                 const int* index, const float* coords,
                                 int num_rois, int channels, int out,
                                 void* const* grad_feats, const int* hs,
                                 const int* ws, int num_levels,
                                 void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0 || channels == 0) return 0;
  if (out > kMaxOut) return static_cast<int>(cudaErrorInvalidValue);
  // shared memory: Ay and Ax, then G per channel of a block
  const int64_t fixed = 2LL * kMaxOut * kWinTile;
  const int64_t per_channel = static_cast<int64_t>(out) * out;
  int64_t chunk = (kStaticSmem / static_cast<int64_t>(sizeof(float)) -
                   fixed) / per_channel;
  if (chunk > kMaxChannels) chunk = kMaxChannels;
  const int64_t chunks = (channels + chunk - 1) / chunk;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (fixed + chunk * per_channel);
  const dim3 grid(static_cast<unsigned>(num_rois),
                  static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Levels<float> lv = make_levels<float>(grad_feats, hs, ws, num_levels);
  if (grad_dtype == 0) {
    return launch_bwd<float>(lv, index, coords, channels, out,
                             static_cast<int>(chunk), grad, grid, smem, s);
  }
  if (grad_dtype == 1) {
    return launch_bwd<__nv_bfloat16>(lv, index, coords, channels, out,
                                     static_cast<int>(chunk), grad, grid,
                                     smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
