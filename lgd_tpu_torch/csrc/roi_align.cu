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
//   roi_align_bwd_kernel: the same walk over the pooled gradient; each
//     corner's share (gradient times weight) is atomically added into a
//     zeroed float32 buffer of the level, which the caller casts to the
//     level's dtype. Atomics make the order of the sums change from run to
//     run.
//
// The sample positions and weights repeat the plain version's float32
// arithmetic operation for operation (build flag -fmad=false: no fused
// multiply-add; IEEE divisions), so the forward agrees with it bit for bit
// in float32.
//
// What bounds it on this card: neither bandwidth nor arithmetic at first.
// Each output element does up to 16 samples x 4 scattered reads that mostly
// hit L2 (neighbouring threads read neighbouring columns of one channel, so
// a warp's reads coalesce only partly), and the backward's atomics collide
// where neighbouring bins share texels. A simple kernel that is right comes
// first; a channels-last layout with shared-memory staging of each ROI's
// window is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

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

template <typename Tg>
__global__ void roi_align_bwd_kernel(Levels<float> levels,
                                     const int* __restrict__ index,
                                     const float* __restrict__ coords,
                                     int64_t total, int channels, int out,
                                     const Tg* __restrict__ grad) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(blockDim.x) * gridDim.x) {
    const float g = to_float(grad[i]);
    if (g == 0.0f) continue;  // every share would be 0
    const int pw = static_cast<int>(i % out);
    const int ph = static_cast<int>((i / out) % out);
    const int c = static_cast<int>((i / (out * out)) % channels);
    const int64_t r = i / (static_cast<int64_t>(out) * out * channels);
    const Roi roi = load_roi(index, coords, r);
    if (roi.level < 0) continue;
    const int H = levels.h[roi.level];
    const int W = levels.w[roi.level];
    float* f = levels.ptr[roi.level] +
               (static_cast<int64_t>(roi.b) * channels + c) * H * W;
    for (int iy = 0; iy < roi.ny; ++iy) {
      const Axis ay = axis_sample(roi.y0, roi.bin_h, ph, iy, roi.ny, H);
      for (int ix = 0; ix < roi.nx; ++ix) {
        const Axis ax = axis_sample(roi.x0, roi.bin_w, pw, ix, roi.nx, W);
        atomicAdd(f + ay.c0 * W + ax.c0, g * (ay.w0 * ax.w0));
        atomicAdd(f + ay.c0 * W + ax.c1, g * (ay.w0 * ax.w1));
        atomicAdd(f + ay.c1 * W + ax.c0, g * (ay.w1 * ax.w0));
        atomicAdd(f + ay.c1 * W + ax.c1, g * (ay.w1 * ax.w1));
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
  if (num_levels < 1 || num_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(num_rois) * channels * out * out;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Levels<float> lv = make_levels<float>(grad_feats, hs, ws, num_levels);
  if (grad_dtype == 0) {
    roi_align_bwd_kernel<float><<<grid_for(total), kThreads, 0, s>>>(
        lv, index, coords, total, channels, out,
        static_cast<const float*>(grad));
  } else if (grad_dtype == 1) {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid_for(total), kThreads, 0, s>>>(
        lv, index, coords, total, channels, out,
        static_cast<const __nv_bfloat16*>(grad));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
