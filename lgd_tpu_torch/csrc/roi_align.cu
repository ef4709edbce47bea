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
//   roi_align_fwd_kernel: the TPU kernel's own form, per ROI the separable
//     interpolation product Ay F Ax^T. A block takes one ROI and a chunk of
//     channels. It lists once, in shared memory, the texels that each bin's
//     samples touch along each axis with their summed weights (bin_texels;
//     the same sums as the backward's Ay and Ax, from axis_sample), then a
//     thread per bin and kFwdWays channels, neighbouring threads on
//     neighbouring bins, sums over the bin's rows the weighted sum of the
//     bin's columns: every texel the bin's samples touch is read once per
//     channel, in the level's layout, and the bin's lists once for all its
//     channels. It writes in the output's dtype; the chunk's output is one
//     run. An invalid ROI (level -1) writes zeros.
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
// multiply-add; IEEE divisions). The forward then sums the weighted texels
// in another order than the plain version (each bin's columns, then its
// rows, with fused multiply-adds), so its float32 result agrees with the
// plain version's within float32 rounding, not bit for bit.
//
// What bounds the forward on this card (PERF.md): the old form gave
// each output element a thread that recomputed every sample's position
// (two IEEE divisions each) and read its four corners, so each texel was
// read again for every sample that touches it (3.28 ms at 16 x 512 ROIs,
// 14.5 times the bound). Staging each ROI's window in shared memory a
// tile of channels at a time, as the TPU kernel does, was slower in test
// builds (10.7 ms): with half the ROIs over several 32 x 32 tiles, the
// per-step barriers, index arithmetic and list rebuilding took more than
// the loads they saved. This form has one barrier per block; a thread's
// four channels share each list entry it loads. It is bound by the
// corner loads through L1 (each warp's loads fall on several rows of a
// level), at about five times the bound.
//
// The backward before this form gave each (ROI, channel, bin) a thread and
// added every corner's share with a global atomic: a warp's 32
// neighbouring bins collided on shared texels and the atomics serialised. This one is bound
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
constexpr int kMaxOut = 16;        // bins per side the kernels take
constexpr int kStaticSmem = 48 * 1024;  // no opt-in needed
constexpr int kFwdChunk = 64;      // channels of a forward block
constexpr int kFwdWays = 4;        // channels of a forward thread
constexpr int kMaxTexels = 32;     // texels a bin touches along an axis
constexpr int kListPitch = kMaxTexels + 1;  // a bin's list, in words

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

// The texels that bin p's samples touch along one axis, each once, in ts
// with its summed weight in ws: each sample's corners in order, both on
// one texel where the high corner is clamped, summed as bin_weight sums
// them. A sample outside [-1, size] keeps its corners with weight 0, as
// the plain version multiplies them too. At most 2n texels (kMaxTexels:
// roi_geometry takes at most kMaxTexels / 2 samples per axis); returns
// the count.
__device__ __forceinline__ int bin_texels(float start, float bin, int p,
                                          int n, int size, int* ts,
                                          float* ws) {
  int count = 0;
  for (int i = 0; i < n; ++i) {
    const Axis a = axis_sample(start, bin, p, i, n, size);
    for (int corner = 0; corner < 2; ++corner) {
      const int t = corner ? a.c1 : a.c0;
      int e = 0;
      while (e < count && ts[e] != t) ++e;
      if (e == count) {
        if (count == kMaxTexels) return count;  // beyond what the caller
        ts[count] = t;                          // may ask
        ws[count++] = 0.0f;
      }
      ws[e] += corner ? a.w1 : a.w0;
    }
  }
  return count;
}

// A ROI's texel window on its level: the first sample's low corner to the
// last one's high corner (the positions grow with the bin and the sample).
struct Window {
  int y_lo, y_hi, x_lo, x_hi;
};

__device__ __forceinline__ Window roi_window(const Roi& roi, int out, int H,
                                             int W) {
  Window w;
  w.y_lo = axis_sample(roi.y0, roi.bin_h, 0, 0, roi.ny, H).c0;
  w.y_hi = axis_sample(roi.y0, roi.bin_h, out - 1, roi.ny - 1, roi.ny, H).c1;
  w.x_lo = axis_sample(roi.x0, roi.bin_w, 0, 0, roi.nx, W).c0;
  w.x_hi = axis_sample(roi.x0, roi.bin_w, out - 1, roi.nx - 1, roi.nx, W).c1;
  return w;
}

// The level of a ROI, without indexing the kernel's parameters at run time
// (which copies them to local memory in every thread).
template <typename T>
__device__ __forceinline__ void pick_level(const Levels<T>& lv, int level,
                                           T*& ptr, int& h, int& w) {
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l == level) {
      ptr = lv.ptr[l];
      h = lv.h[l];
      w = lv.w[l];
    }
  }
}

// The bins per side, out, at run time up to kMaxOut. A block takes one ROI
// and kFwdChunk channels: it lists each bin's texels and weights along
// each axis once, then a thread per bin and kFwdWays channels,
// neighbouring threads on neighbouring bins, sums the bin's rows, each the
// sum of the bin's columns: Ay F Ax^T restricted to the bin, every texel
// the bin's samples touch read once per channel.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(Levels<const Tin> levels, const int* __restrict__ index,
                     const float* __restrict__ coords, int channels, int out,
                     Tout* __restrict__ y) {
  __shared__ int ry[kMaxOut * kListPitch], rx[kMaxOut * kListPitch];
  __shared__ float wy[kMaxOut * kListPitch], wx[kMaxOut * kListPitch];
  __shared__ int ny[kMaxOut], nx[kMaxOut];
  const int tid = threadIdx.x;
  const int64_t r = blockIdx.x;
  const Roi roi = load_roi(index, coords, r);
  const int c_begin = blockIdx.y * kFwdChunk;
  const int chunk = min(kFwdChunk, channels - c_begin);
  const int oo = out * out;
  Tout* yr = y + (r * channels + c_begin) * oo;  // the chunk: one run
  if (roi.level < 0) {
    for (int i = tid; i < chunk * oo; i += kThreads)
      yr[i] = from_float<Tout>(0.0f);
    return;
  }
  const Tin* level = nullptr;
  int H = 0, W = 0;
  pick_level(levels, roi.level, level, H, W);
  const int64_t HW = static_cast<int64_t>(H) * W;
  const Tin* f = level + (static_cast<int64_t>(roi.b) * channels + c_begin) *
                             HW;
  if (tid < out)
    ny[tid] = bin_texels(roi.y0, roi.bin_h, tid, roi.ny, H,
                         ry + tid * kListPitch, wy + tid * kListPitch);
  else if (tid < 2 * out)
    nx[tid - out] = bin_texels(roi.x0, roi.bin_w, tid - out, roi.nx, W,
                               rx + (tid - out) * kListPitch,
                               wx + (tid - out) * kListPitch);
  __syncthreads();
  // a thread per bin (ph, pw) of kFwdWays channels c, c + part, ...: value
  // i = (c * out + ph) * out + pw for c under part; the next kThreads on
  const int part = (chunk + kFwdWays - 1) / kFwdWays;
  int c = tid / oo, ph = tid % oo / out, pw = tid % out;
  const int dc = kThreads / oo, dph = kThreads % oo / out,
            dpw = kThreads % out;
  for (int i = tid; i < part * oo; i += kThreads) {
    const Tin* fc[kFwdWays];
#pragma unroll
    for (int j = 0; j < kFwdWays; ++j)
      fc[j] = f + min(c + j * part, chunk - 1) * HW;
    const int* rxp = rx + pw * kListPitch;
    const float* wxp = wx + pw * kListPitch;
    const int mx = nx[pw];
    float acc[kFwdWays];
#pragma unroll
    for (int j = 0; j < kFwdWays; ++j) acc[j] = 0.0f;
    for (int e = 0; e < ny[ph]; ++e) {
      const int64_t ro = static_cast<int64_t>(ry[ph * kListPitch + e]) * W;
      float t[kFwdWays];
#pragma unroll
      for (int j = 0; j < kFwdWays; ++j) t[j] = 0.0f;
      for (int q = 0; q < mx; ++q) {
        const int xq = rxp[q];
        const float wq = wxp[q];
#pragma unroll
        for (int j = 0; j < kFwdWays; ++j)
          t[j] = __fmaf_rn(to_float(fc[j][ro + xq]), wq, t[j]);
      }
      const float we = wy[ph * kListPitch + e];
#pragma unroll
      for (int j = 0; j < kFwdWays; ++j) acc[j] = __fmaf_rn(we, t[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kFwdWays; ++j)
      if (c + j * part < chunk)
        yr[i + j * part * oo] = from_float<Tout>(acc[j]);
    pw += dpw;
    ph += dph;
    c += dc;
    if (pw >= out) {
      pw -= out;
      ++ph;
    }
    if (ph >= out) {
      ph -= out;
      ++c;
    }
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
  const Window win = roi_window(roi, out, H, W);
  for (int ty = win.y_lo; ty <= win.y_hi; ty += kWinTile) {
    const int th = min(kWinTile, win.y_hi - ty + 1);
    for (int tx = win.x_lo; tx <= win.x_hi; tx += kWinTile) {
      const int tw = min(kWinTile, win.x_hi - tx + 1);
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
               const float* coords, int num_rois, int out, void* y,
               cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(num_rois),
                  static_cast<unsigned>((channels + kFwdChunk - 1) /
                                        kFwdChunk));
  roi_align_fwd_kernel<Tin, Tout><<<grid, kThreads, 0, s>>>(
      make_levels<const Tin>(feats, hs, ws, num_levels), index, coords,
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
  if (num_levels < 1 || num_levels > kMaxLevels || out < 1 ||
      out > kMaxOut || (channels + kFwdChunk - 1) / kFwdChunk > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0 || channels == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feat_dtype == 0 && out_dtype == 0) {
    return launch_fwd<float, float>(feats, hs, ws, num_levels, channels,
                                    index, coords, num_rois, out, y, s);
  }
  if (feat_dtype == 1 && out_dtype == 1) {
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(
        feats, hs, ws, num_levels, channels, index, coords, num_rois, out, y,
        s);
  }
  if (feat_dtype == 1 && out_dtype == 0) {
    return launch_fwd<__nv_bfloat16, float>(feats, hs, ws, num_levels,
                                            channels, index, coords,
                                            num_rois, out, y, s);
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
