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
//   deform_fwd_kernel: a block per run of kRun consecutive output
//     positions of one image (a thread each) and a group of channels. It
//     computes each (tap, position)'s geometry once, into shared memory: the
//     sample's corner, its bilinear fractions and its mask. Then, a stage
//     of channels at a time (8 in bfloat16, 4 in float32: 16 bytes), it
//     stages the run's input window in shared memory: every column of the
//     rows that the run's unmoved taps reach, kFwdHalo rows more on each
//     side, kFwdHalo zero columns on each side and zero rows outside the
//     image, each texel holding the stage's channels side by side. Where
//     such a window of full rows does not fit (a wide map), each run lies
//     in one output row and its window spans only the columns that its
//     unmoved taps reach, kFwdHalo more on each side, cut to what fits. A
//     sample whose corners lie in the window reads each corner as one
//     16-byte load that serves every channel of the stage, with no test of
//     the corners' validity; any other sample (an offset beyond the halo)
//     reads x. Each (channel, tap) row of the columns that a block writes
//     is one run of up to kRun positions.
//   deform_bwd_kernel: the same walk over the columns' gradient, by tiles.
//     A block takes kTileH x kTileW output positions of one image (a
//     thread each) and a group of channels, kMaxStage or fewer at a time.
//     For each stage it copies the tile's input window into shared memory
//     (the footprint of the unmoved taps, widened by kHalo texels on every
//     side; zeros outside the image) and keeps an accumulator of the same
//     window there. A sample whose four corners lie in the window reads
//     them there and adds each corner's share to the accumulator with
//     shared-memory atomics; any other sample (a large offset, or one
//     leaving the tile's footprint) reads x and adds its valid corners'
//     shares to dx with global float atomics. After each stage the window
//     is added to dx, a zeroed float32 copy of x (the caller casts it
//     once), cell by cell with coalesced global atomics, in the image
//     only: neighbouring tiles overlap only in their halos. Each thread
//     sums its offset's and mask's gradients over a stage's channels in
//     registers and adds them to its own slots in shared memory; a block
//     writes them once, or adds them atomically where several blocks
//     split the channels. It writes the columns again for the weight's
//     gradient (the forward keeps none).
//
//     The accumulator is fixed point. A float atomicAdd on shared memory
//     is a compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN in the SASS)
//     and took about half of the kernel's time; an integer one is native.
//     Once per block the kernel counts the (sample, corner) pairs that
//     each window cell takes, and per stage it takes the largest |gradient
//     x mask|: their product bounds every cell's sum, so with a scale of
//     2^(30 - e), 2^e above that bound, every sum fits an int, and each
//     share is rounded to 2^(e - 30), under 2^-29 of the bound. A stage
//     whose bound is not finite (a share of NaN or inf among them) or
//     under 2^-96 keeps float atomics.
//
// What bounds the backward on this card: each sample's serial work at the
// occupancy that the windows' shared memory leaves, then the shared
// atomics. Test builds (PERF.md) with a counting sort of the samples by
// cell and a gather in place of the atomics, with the tap sums in
// registers, with hand-interleaved compare-and-swap loops, and with other
// tiles and stages were all slower. The global atomics per sample and
// channel fall from 4 to about 0.3 (the window's cells per tile position
// over 9 taps, and the rare samples that leave the window).
//
// What bounds the forward on this card (PERF.md): the old form, a
// thread per (image, tap, position) walking every channel with four
// scalar corner gathers through L1, was bound by issuing those loads and
// their latency (0.48 ms at R-101 res4, about 4.6 times its bound); test
// builds that staged x in shared memory but still loaded each corner per
// channel, with its address and validity, were no faster (about 5
// instructions per corner in the SASS). With the corners of all of a
// stage's channels in one load, a sample takes about 20 instructions: its
// 12 float32 products and sums in the plain version's order, 4
// conversions, and the column store with its address. That form was then
// bound by the samples that leave the window: 1-2% of them (offsets past
// the halo, or past a border of res5's 42 columns) took a fifth to a
// third of its time, since one lane reading x channel by channel held up
// its whole warp. Three zero columns on each side of the window, and the
// leaving samples listed per block and sampled after the window's pass,
// a thread each (spill_stage), took res4 from 0.39 to 0.27 ms; a halo of
// 4 helped independent offsets and cost smooth ones (a larger window to
// stage), so it stays at 3. What bounds it now, by test
// builds with a part removed (res4): the window's sampling pass, about
// half of its time (0.125 of 0.267 ms without it), and the geometry,
// the loads of x that stage the window and the barriers, the other half,
// one after the other; the column stores take about 6%, the spill pass
// and the window's shared-memory writes no measurable time, and the
// bound (the column writes at the memory's rate) is two fifths of its
// time. Copying the next stage's rows with cp.async while sampling this
// one, then spreading them into the texels, was slower (one more pass
// through shared memory, and two blocks per SM); so were two positions a
// thread with packed column stores (128 registers) and other runs and
// block counts.

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

// the forward's runs: output positions of a block, a thread each
constexpr int kRun = 256;
constexpr int kFwdHalo = 3;       // window rows past the unmoved taps' reach
constexpr int kMaxTaps = 9;       // taps per position the forward takes
constexpr int kFwdTargetBlocks = 2048;  // about 5 waves at 3 blocks per SM
constexpr int kFwdWindowSmem = 96 * 1024;  // a stage's window at most
// shared memory of a forward block at most: the taps' geometry, the window
constexpr int kFwdSmem = 16 * kMaxTaps * kRun + kFwdWindowSmem;
// the backward's tiles: output rows x columns of a block, a thread each
constexpr int kTileH = 8, kTileW = 16, kTileThreads = kTileH * kTileW;
constexpr int kHalo = 2;       // window texels past the unmoved taps' reach
constexpr int kMaxStage = 4;   // channels staged at a time (the fastest)
constexpr int kStaticSmem = 48 * 1024;  // no opt-in needed
constexpr int kTargetBlocks = 2048;     // enough blocks to balance 132 SMs

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

// One tap's sample: its floor corner (y0, x0), the bilinear fractions
// and the mask.
struct Sample {
  float y0, x0;
  float a, ay, bx, ax;  // 1 - wy, wy, 1 - wx, wx
  float m;
};

__device__ __forceinline__ int texel(float yc, float xc, int H, int W) {
  const bool valid = yc >= 0.0f && yc < static_cast<float>(H) &&
                     xc >= 0.0f && xc < static_cast<float>(W);
  return valid ? static_cast<int>(yc) * W + static_cast<int>(xc) : -1;
}

// tap (ky, kx) of output position (ho, wo) of image b
__device__ __forceinline__ Sample sample_at(
    const Geometry& g, const float* __restrict__ offsets,
    const float* __restrict__ mask, int b, int ky, int kx, int ho, int wo) {
  const int64_t P = static_cast<int64_t>(g.Ho) * g.Wo;
  const int64_t p = static_cast<int64_t>(ho) * g.Wo + wo;
  const int K = g.kh * g.kw;
  const int k = ky * g.kw + kx;
  const float* off = offsets + (static_cast<int64_t>(b) * 2 * K + 2 * k) * P;
  const float py =
      static_cast<float>(ho * g.stride - g.pad + ky * g.dilation) + off[p];
  const float px =
      static_cast<float>(wo * g.stride - g.pad + kx * g.dilation) + off[P + p];
  Sample s;
  s.y0 = floorf(py);
  s.x0 = floorf(px);
  const float wy = py - s.y0;
  const float wx = px - s.x0;
  s.a = 1.0f - wy;
  s.ay = wy;
  s.bx = 1.0f - wx;
  s.ax = wx;
  s.m = mask != nullptr ? mask[(static_cast<int64_t>(b) * K + k) * P + p]
                        : 1.0f;
  return s;
}

template <typename T>
__device__ __forceinline__ float corner(const T* __restrict__ xc, int i) {
  return i >= 0 ? to_float(xc[i]) : 0.0f;
}

// The forward's runs and their windows. A run is kRun consecutive output
// positions: where a window of full rows fits in shared memory, across row
// ends (per_row 0, window columns -kFwdHalo to W + kFwdHalo - 1); else a
// run lies in one output row (per_row runs to a row) and its window spans
// its own columns.
struct Run {
  int rows;     // rows of a run's window (the most that any run needs)
  int cols;     // columns of a run's window
  int per_row;  // runs per output row, 0 where runs cross rows
  int group;    // channels per block, a multiple of a stage's
};

// Rows of a run's window: the corners y0 and y0 + 1 of the unmoved taps of
// `spanned` output rows span (spanned - 1) * stride + dilation * (k - 1) +
// 2 rows; kFwdHalo more on each side hold the samples that move by up to
// kFwdHalo. Likewise the columns of `spanned` output columns.
__host__ __device__ inline int run_rows(int spanned, int stride, int k,
                                        int dilation) {
  return (spanned - 1) * stride + dilation * (k - 1) + 2 + 2 * kFwdHalo;
}

// A window texel holds a stage's channels side by side in 16 bytes: 8
// bfloat16s or 4 float32s.
template <typename T>
__host__ __device__ constexpr int stage_of() {
  return 16 / static_cast<int>(sizeof(T));
}

template <typename T>
struct Texel {
  uint32_t w[4];
};

template <typename T>
__device__ __forceinline__ Texel<T> load_texel(const Texel<T>* p) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  return Texel<T>{{q.x, q.y, q.z, q.w}};
}

// channel c of a texel in float32
__device__ __forceinline__ float channel(const Texel<float>& t, int c) {
  return __uint_as_float(t.w[c]);
}
__device__ __forceinline__ float channel(const Texel<__nv_bfloat16>& t,
                                         int c) {
  const uint32_t w = t.w[c / 2];
  return __uint_as_float(c % 2 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ uint32_t bits_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}

// One stage of the forward for one output position: at each tap whose
// sample's corners lie in the window, the stage's n channels (all
// stage_of<T>() where kFull), each corner one texel of every channel.
// The other samples are left to spill_stage.
template <bool kFull, typename T>
__device__ __forceinline__ void sample_stage(
    const float4* __restrict__ taps, int tid, int K,
    const Texel<T>* __restrict__ win, int pitch, T* __restrict__ out0,
    int64_t P, int64_t KP, int n, bool modulated) {
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const float4 t = taps[k * kRun + tid];
    const int code = __float_as_int(t.x);
    if (code < 0) continue;
    // the sample's weights as the plain version forms them
    const float ay = t.y, a = 1.0f - t.y, ax = t.z, bx = 1.0f - t.z;
    const float m = t.w;
    T* out = out0 + k * P;
    const Texel<T> t00 = load_texel(win + code);
    const Texel<T> t01 = load_texel(win + code + 1);
    const Texel<T> t10 = load_texel(win + code + pitch);
    const Texel<T> t11 = load_texel(win + code + pitch + 1);
#pragma unroll
    for (int c = 0; c < stage_of<T>(); ++c) {
      if (kFull || c < n) {
        float s = channel(t00, c) * a * bx + channel(t01, c) * a * ax +
                  channel(t10, c) * ay * bx + channel(t11, c) * ay * ax;
        if (modulated) s = s * m;
        out[c * KP] = from_float<T>(s);
      }
    }
  }
}

// The stage's samples whose corners leave the window, listed in `spill`
// (tap * kRun + thread), a thread each in turn: the n channels from x (xb,
// the stage's first channel), an invalid corner as 0. Taking them apart
// from sample_stage keeps a warp from waiting on one lane's reads of x.
template <typename T>
__device__ __forceinline__ void spill_stage(
    const float4* __restrict__ taps, const uint16_t* __restrict__ spill,
    int spills, int tid, int W, int H, const T* __restrict__ xb, int64_t HW,
    T* __restrict__ out0, int64_t P, int64_t KP, int n, bool modulated) {
  for (int i = tid; i < spills; i += kRun) {
    const int e = spill[i];
    const int k = e / kRun, q = e - k * kRun;
    const float4 t = taps[e];
    const int tt = -1 - __float_as_int(t.x);
    const float ay = t.y, a = 1.0f - t.y, ax = t.z, bx = 1.0f - t.z;
    const float m = t.w;
    const int y0 = tt / (W + 3) - 2;
    const int x0 = tt - (y0 + 2) * (W + 3) - 2;
    const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
    const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
    const int64_t i00 = static_cast<int64_t>(y0) * W + x0;
    T* out = out0 + k * P + q;
    for (int c = 0; c < n; ++c) {
      const T* xc = xb + c * HW;
      const float v00 = vy0 && vx0 ? to_float(xc[i00]) : 0.0f;
      const float v01 = vy0 && vx1 ? to_float(xc[i00 + 1]) : 0.0f;
      const float v10 = vy1 && vx0 ? to_float(xc[i00 + W]) : 0.0f;
      const float v11 = vy1 && vx1 ? to_float(xc[i00 + W + 1]) : 0.0f;
      float s = v00 * a * bx + v01 * a * ax + v10 * ay * bx + v11 * ay * ax;
      if (modulated) s = s * m;
      out[c * KP] = from_float<T>(s);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kRun, 3)
deform_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                  const float* __restrict__ mask, Geometry g, Run run,
                  T* __restrict__ cols) {
  constexpr int kStage = stage_of<T>();  // channels staged at a time
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  // each tap's geometry, tap-major: (code, wy, wx, mask) per position
  float4* taps = reinterpret_cast<float4*>(fwd_smem);
  Texel<T>* win = reinterpret_cast<Texel<T>*>(taps + kMaxTaps * kRun);
  __shared__ uint16_t spill[kMaxTaps * kRun];  // samples beyond the window
  __shared__ int spills;
  const int tid = threadIdx.x;
  const int K = g.kh * g.kw;
  const int W = g.W;
  const int pitch = run.cols;  // texels of a window row
  const int64_t P = static_cast<int64_t>(g.Ho) * g.Wo;
  const int64_t KP = K * P;  // channel stride of the columns
  const int64_t HW = static_cast<int64_t>(g.H) * W;
  // the run's positions [p0, end), its output rows and its window's first
  // column: across rows -kFwdHalo, else its unmoved taps' first less
  // kFwdHalo
  int64_t p0, end;
  int ho_first, ho_last, wx0;
  if (run.per_row == 0) {
    p0 = static_cast<int64_t>(blockIdx.x) * kRun;
    end = min(p0 + kRun, P);
    ho_first = static_cast<int>(p0 / g.Wo);
    ho_last = static_cast<int>((end - 1) / g.Wo);
    wx0 = -kFwdHalo;
  } else {
    ho_first = ho_last = blockIdx.x / run.per_row;
    const int wo0 = (blockIdx.x % run.per_row) * kRun;
    p0 = static_cast<int64_t>(ho_first) * g.Wo + wo0;
    end = p0 + min(kRun, g.Wo - wo0);
    wx0 = wo0 * g.stride - g.pad - kFwdHalo;
  }
  const int64_t p = p0 + tid;
  const bool live = p < end;
  const int b = blockIdx.z;
  const int c_begin = blockIdx.y * run.group;
  const int c_end = min(g.C, c_begin + run.group);
  // the window: the run's output rows' unmoved taps' rows and kFwdHalo
  // more on each side (at most run.rows), across pitch columns from wx0
  // (rows and columns outside x hold zeros)
  const int rows = min(run.rows, run_rows(ho_last - ho_first + 1, g.stride,
                                          g.kh, g.dilation));
  const int wy0 = ho_first * g.stride - g.pad - kFwdHalo;
  const bool modulated = mask != nullptr;
  if (tid == 0) spills = 0;
  __syncthreads();
  // Each tap's geometry, once per block: the window texel of the sample's
  // top-left corner (code >= 0) where all four corners lie in the window,
  // else -1 minus its floor corner clamped to [-2, H] x [-2, W] (NaN to
  // -2), which keeps each corner's validity, and the sample listed in
  // `spill`; then the bilinear fractions and the mask.
  if (live) {
    const int ho = static_cast<int>(p / g.Wo);
    const int wo = static_cast<int>(p - static_cast<int64_t>(ho) * g.Wo);
    Sample sm[kMaxTaps];
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k)  // the loads all in flight at once
      if (k < K)
        sm[k] = sample_at(g, offsets, mask, b, k / g.kw, k % g.kw, ho, wo);
    const float wy0f = static_cast<float>(wy0);
    const float wx0f = static_cast<float>(wx0);
    const float last_y = static_cast<float>(rows - 2);
    const float last_x = static_cast<float>(pitch - 2);
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      if (k >= K) break;
      const Sample& s = sm[k];
      const float ly = s.y0 - wy0f, lx = s.x0 - wx0f;
      int code;
      if (ly >= 0.0f && ly <= last_y && lx >= 0.0f && lx <= last_x) {
        code = static_cast<int>(ly) * pitch + static_cast<int>(lx);
      } else {
        const float yc = fminf(fmaxf(s.y0, -2.0f), static_cast<float>(g.H));
        const float xc = fminf(fmaxf(s.x0, -2.0f), static_cast<float>(W));
        code = -1 - (static_cast<int>(yc) + 2) * (W + 3) -
               (static_cast<int>(xc) + 2);
        spill[atomicAdd(&spills, 1)] = static_cast<uint16_t>(k * kRun + tid);
      }
      taps[k * kRun + tid] =
          make_float4(__int_as_float(code), s.ay, s.ax, s.m);
    }
  }
  for (int c0 = c_begin; c0 < c_end; c0 += kStage) {
    const int n = min(kStage, c_end - c0);
    const int64_t first = static_cast<int64_t>(b) * g.C + c0;
    const T* xb = x + first * HW;
    __syncthreads();  // the last stage's window sampled
    // the stage's window: a thread per texel, its channels side by side;
    // neighbouring threads on neighbouring texels of a row
#pragma unroll 2
    for (int q = tid; q < rows * pitch; q += kRun) {
      const int ry = q / pitch;
      const int xx = wx0 + q - ry * pitch;
      const int y = wy0 + ry;
      const bool in = y >= 0 && y < g.H && xx >= 0 && xx < W;
      const T* src = xb + (in ? static_cast<int64_t>(y) * W + xx : 0);
      uint32_t v[kStage];
#pragma unroll
      for (int c = 0; c < kStage; ++c)
        v[c] = in && c < n ? bits_of(src[c * HW]) : 0u;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = kStage == 4 ? v[i] : v[2 * i] | v[2 * i + 1] << 16;
      *reinterpret_cast<uint4*>(win + q) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
    T* out0 = cols + first * K * P + p0;
    // a full stage unguarded, so that its channels' products interleave;
    // a partial one (the last of a group) guarded
    if (live && n == kStage)
      sample_stage<true>(taps, tid, K, win, pitch, out0 + tid, P, KP, n,
                         modulated);
    else if (live)
      sample_stage<false>(taps, tid, K, win, pitch, out0 + tid, P, KP, n,
                          modulated);
    spill_stage(taps, spill, spills, tid, W, g.H, xb, HW, out0, P, KP, n,
                modulated);
  }
}

// The backward's tiles along Wo, the rows and columns of a tile's window,
// and the channels per stage and per block.
struct Window {
  int tiles_w;  // tiles along Wo
  int h, w;     // rows and columns of a tile's window
  int stage;    // channels staged at a time (shared memory)
  int group;    // channels per block, a multiple of stage
};

// Rows (or columns) of a tile's window: the corners y0 and y0 + 1 of the
// tile's unmoved taps span (tile - 1) * stride + dilation * (k - 1) + 2
// rows; kHalo more on each side hold the samples that move by up to kHalo.
__host__ __device__ inline int window_span(int tile, int stride, int k,
                                           int dilation) {
  return (tile - 1) * stride + dilation * (k - 1) + 2 * kHalo + 2;
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
deform_bwd_kernel(const T* __restrict__ grad, const T* __restrict__ x,
                  const float* __restrict__ offsets,
                  const float* __restrict__ mask, Geometry g, Window win,
                  float* __restrict__ dx, float* __restrict__ doffsets,
                  float* __restrict__ dmask, T* __restrict__ cols) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int K = g.kh * g.kw;
  const int plane = win.h * win.w;
  float* xs = smem;                        // stage x plane: x's window
  float* acc = xs + win.stage * plane;     // stage x plane: dx's window
  float* sums = acc + win.stage * plane;   // 3K x threads: each thread's
                                           // dy, dx, dm sums per tap
  const int ty = blockIdx.x / win.tiles_w, tx = blockIdx.x % win.tiles_w;
  const int b = blockIdx.z;
  const int c_begin = blockIdx.y * win.group;
  const int c_end = min(g.C, c_begin + win.group);
  const int ho = ty * kTileH + tid / kTileW;
  const int wo = tx * kTileW + tid % kTileW;
  const bool live = ho < g.Ho && wo < g.Wo;
  const int wy0 = ty * kTileH * g.stride - g.pad - kHalo;
  const int wx0 = tx * kTileW * g.stride - g.pad - kHalo;
  const float wy0f = static_cast<float>(wy0), wx0f = static_cast<float>(wx0);
  const float last_y = static_cast<float>(win.h - 2);
  const float last_x = static_cast<float>(win.w - 2);
  const int64_t P = static_cast<int64_t>(g.Ho) * g.Wo;
  const int64_t KP = K * P;  // channel stride of the columns
  const int64_t HW = static_cast<int64_t>(g.H) * g.W;
  const int64_t p = live ? static_cast<int64_t>(ho) * g.Wo + wo : 0;
  const bool modulated = mask != nullptr;
  int* iacc = reinterpret_cast<int*>(acc);  // the window in fixed point
  __shared__ int most_hits;
  __shared__ unsigned most_share[2];  // per stage parity, as float bits
  for (int i = tid; i < win.stage * plane; i += kTileThreads) acc[i] = 0.0f;
  for (int j = 0; j < 3 * K; ++j) sums[j * kTileThreads + tid] = 0.0f;
  if (tid == 0) {
    most_hits = 0;
    most_share[0] = most_share[1] = 0u;
  }
  __syncthreads();
  // Once per block: the (sample, corner) pairs that each window cell
  // takes; the most that any cell takes, times a stage's largest share,
  // bounds every cell's sum.
  for (int k = 0; live && k < K; ++k) {
    const Sample sm = sample_at(g, offsets, mask, b, k / g.kw, k % g.kw, ho,
                                wo);
    const float ly = sm.y0 - wy0f, lx = sm.x0 - wx0f;
    if (ly >= 0.0f && ly <= last_y && lx >= 0.0f && lx <= last_x) {
      const int l00 = static_cast<int>(ly) * win.w + static_cast<int>(lx);
      atomicAdd(iacc + l00, 1);
      atomicAdd(iacc + l00 + 1, 1);
      atomicAdd(iacc + l00 + win.w, 1);
      atomicAdd(iacc + l00 + win.w + 1, 1);
    }
  }
  __syncthreads();
  {
    int most = 0;
    for (int r = tid; r < plane; r += kTileThreads) {
      most = max(most, iacc[r]);
      iacc[r] = 0;
    }
    atomicMax(&most_hits, most);
  }

  for (int c0 = c_begin, stage = 0; c0 < c_end; c0 += win.stage, ++stage) {
    const int n = min(win.stage, c_end - c0);
    const int64_t first = static_cast<int64_t>(b) * g.C + c0;
    const T* xb = x + first * HW;
    // the stage's largest |gradient x mask|, which bounds every share;
    // +inf where one is not finite (NaN, inf, 0 x inf), so that the stage
    // adds in float32 and a NaN or an inf reaches dx as in the plain
    // version (fmaxf alone would drop a NaN)
    {
      float most = 0.0f;
      for (int k = 0; live && k < K && most != INFINITY; ++k) {
        const int64_t col0 = (first * K + k) * P + p;
        const float m =
            modulated ? mask[(static_cast<int64_t>(b) * K + k) * P + p] : 1.0f;
        for (int c = 0; c < n; ++c) {
          const float share = fabsf(to_float(grad[col0 + c * KP]) * m);
          most = isfinite(share) ? fmaxf(most, share) : INFINITY;
        }
      }
      // non-negative floats order as their bits, +inf above every other
      atomicMax(most_share + (stage & 1), __float_as_uint(most));
      if (tid == 0) most_share[(stage + 1) & 1] = 0u;  // read a stage ago
    }
    // a cell per thread, the stage's channels each
    for (int r = tid; r < plane; r += kTileThreads) {
      const int ry = r / win.w;
      const int y = wy0 + ry, xx = wx0 + r - ry * win.w;
      const bool in = y >= 0 && y < g.H && xx >= 0 && xx < g.W;
      const T* xr = xb + (in ? static_cast<int64_t>(y) * g.W + xx : 0);
#pragma unroll
      for (int c = 0; c < kMaxStage; ++c)
        if (c < n) xs[c * plane + r] = in ? to_float(xr[c * HW]) : 0.0f;
    }
    __syncthreads();  // x staged, the bounds taken; the last stage flushed
    // the stage's fixed point: 2^e above the bound, ints of 2^(e - 30)
    const float bound =
        static_cast<float>(most_hits) * __uint_as_float(most_share[stage & 1]);
    int e = 0;
    frexpf(bound, &e);
    const bool fixed = isfinite(bound) && e >= -96;
    const float scale = fixed ? ldexpf(1.0f, 30 - e) : 1.0f;
    const float unscale = fixed ? ldexpf(1.0f, e - 30) : 1.0f;
    for (int k = 0; live && k < K; ++k) {
      const int ky = k / g.kw, kx = k - ky * g.kw;
      const Sample sm = sample_at(g, offsets, mask, b, ky, kx, ho, wo);
      const float ly = sm.y0 - wy0f, lx = sm.x0 - wx0f;
      // both corners of both axes in the window (false for NaN)
      const bool inside = ly >= 0.0f && ly <= last_y && lx >= 0.0f &&
                          lx <= last_x;
      const int l00 =
          inside ? static_cast<int>(ly) * win.w + static_cast<int>(lx) : 0;
      int i00 = -1, i01 = -1, i10 = -1, i11 = -1;
      if (!inside) {
        i00 = texel(sm.y0, sm.x0, g.H, g.W);
        i01 = texel(sm.y0, sm.x0 + 1.0f, g.H, g.W);
        i10 = texel(sm.y0 + 1.0f, sm.x0, g.H, g.W);
        i11 = texel(sm.y0 + 1.0f, sm.x0 + 1.0f, g.H, g.W);
      }
      float sum_dy = 0.0f, sum_dx = 0.0f, sum_dm = 0.0f;
      const int64_t col0 = (first * K + k) * P + p;
      // the stage's gradients first, all loads in flight together
      float gv[kMaxStage];
#pragma unroll
      for (int c = 0; c < kMaxStage; ++c)
        gv[c] = c < n ? to_float(grad[col0 + c * KP]) : 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxStage; ++c) {
        if (c >= n) break;
        const int64_t col = col0 + c * KP;
        float v00, v01, v10, v11;
        if (inside) {
          const float* xw = xs + c * plane + l00;
          v00 = xw[0];
          v01 = xw[1];
          v10 = xw[win.w];
          v11 = xw[win.w + 1];
        } else {
          const T* xc = xb + c * HW;
          v00 = corner(xc, i00);
          v01 = corner(xc, i01);
          v10 = corner(xc, i10);
          v11 = corner(xc, i11);
        }
        const float val = v00 * sm.a * sm.bx + v01 * sm.a * sm.ax +
                          v10 * sm.ay * sm.bx + v11 * sm.ay * sm.ax;
        cols[col] = from_float<T>(modulated ? val * sm.m : val);
        const float gc = gv[c];
        const float gm = modulated ? gc * sm.m : gc;
        if (gm != 0.0f) {
          // each corner's share, as autograd of the plain version forms it
          const float s00 = gm * sm.bx * sm.a, s01 = gm * sm.ax * sm.a;
          const float s10 = gm * sm.bx * sm.ay, s11 = gm * sm.ax * sm.ay;
          if (inside && fixed) {
            int* aw = iacc + c * plane + l00;
            atomicAdd(aw, __float2int_rn(s00 * scale));
            atomicAdd(aw + 1, __float2int_rn(s01 * scale));
            atomicAdd(aw + win.w, __float2int_rn(s10 * scale));
            atomicAdd(aw + win.w + 1, __float2int_rn(s11 * scale));
          } else if (inside) {
            float* aw = acc + c * plane + l00;
            atomicAdd(aw, s00);
            atomicAdd(aw + 1, s01);
            atomicAdd(aw + win.w, s10);
            atomicAdd(aw + win.w + 1, s11);
          } else {
            float* dxc = dx + (first + c) * HW;
            if (i00 >= 0 && s00 != 0.0f) atomicAdd(dxc + i00, s00);
            if (i01 >= 0 && s01 != 0.0f) atomicAdd(dxc + i01, s01);
            if (i10 >= 0 && s10 != 0.0f) atomicAdd(dxc + i10, s10);
            if (i11 >= 0 && s11 != 0.0f) atomicAdd(dxc + i11, s11);
          }
        }
        sum_dy += gm * sm.bx * (v10 - v00) + gm * sm.ax * (v11 - v01);
        sum_dx += gm * sm.a * (v01 - v00) + gm * sm.ay * (v11 - v10);
        sum_dm += gc * val;
      }
      sums[(3 * k + 0) * kTileThreads + tid] += sum_dy;
      sums[(3 * k + 1) * kTileThreads + tid] += sum_dx;
      sums[(3 * k + 2) * kTileThreads + tid] += sum_dm;
    }
    __syncthreads();  // every share of this stage is in the window
    // the window into dx, in the image only, and zeroed for the next stage
    for (int r = tid; r < plane; r += kTileThreads) {
      const int ry = r / win.w;
      const int y = wy0 + ry, xx = wx0 + r - ry * win.w;
      const bool in = y >= 0 && y < g.H && xx >= 0 && xx < g.W;
      float* dxr = dx + first * HW + (in ? static_cast<int64_t>(y) * g.W + xx
                                         : 0);
#pragma unroll
      for (int c = 0; c < kMaxStage; ++c) {
        if (c >= n) break;
        const int cell = c * plane + r;
        const float v =
            fixed ? __int2float_rn(iacc[cell]) * unscale : acc[cell];
        if (v == 0.0f) continue;
        iacc[cell] = 0;
        if (in) atomicAdd(dxr + c * HW, v);
      }
    }
  }
  if (!live) return;
  const bool split = gridDim.y > 1;  // other blocks add to the same sums
  float* doff = doffsets + static_cast<int64_t>(b) * 2 * K * P + p;
  float* dm = modulated ? dmask + static_cast<int64_t>(b) * K * P + p
                        : nullptr;
  for (int k = 0; k < K; ++k) {
    const float dy = sums[(3 * k + 0) * kTileThreads + tid];
    const float dxs = sums[(3 * k + 1) * kTileThreads + tid];
    const float dms = sums[(3 * k + 2) * kTileThreads + tid];
    if (split) {
      atomicAdd(doff + 2 * k * P, dy);
      atomicAdd(doff + (2 * k + 1) * P, dxs);
      if (modulated) atomicAdd(dm + k * P, dms);
    } else {
      doff[2 * k * P] = dy;
      doff[(2 * k + 1) * P] = dxs;
      if (modulated) dm[k * P] = dms;
    }
  }
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
  const int64_t P = static_cast<int64_t>(Ho) * Wo;
  if (static_cast<int64_t>(B) * kh * kw * P == 0 || C == 0) return 0;
  if ((dtype != 0 && dtype != 1) || kh * kw > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  Run run;
  // the most output rows that kRun consecutive positions touch
  const int64_t spanned = (Wo - 1 + kRun - 1) / Wo + 1;
  run.rows = run_rows(static_cast<int>(spanned < Ho ? spanned : Ho), stride,
                      kh, dilation);
  run.cols = W + 2 * kFwdHalo;
  run.per_row = 0;
  // the window's texels of 16 bytes at most
  constexpr int most = kFwdWindowSmem / 16;
  if (static_cast<int64_t>(run.rows) * run.cols > most) {
    // too wide for full rows: runs along one output row each, a window
    // over their own columns, cut to fit (samples beyond it read x)
    run.per_row = (Wo + kRun - 1) / kRun;
    run.rows = run_rows(1, stride, kh, dilation);
    run.cols = run_rows(Wo < kRun ? Wo : kRun, stride, kw, dilation);
    if (run.rows > most / 2) run.rows = most / 2;
    if (run.rows * run.cols > most) run.cols = most / run.rows;
  }
  const int64_t window = static_cast<int64_t>(run.rows) * run.cols * 16;
  const int stage = dtype == 0 ? stage_of<float>() : stage_of<__nv_bfloat16>();
  const int64_t runs = run.per_row ? static_cast<int64_t>(Ho) * run.per_row
                                   : (P + kRun - 1) / kRun;
  // split the channels among enough blocks to fill the SMs evenly
  const int64_t stages = (C + stage - 1) / stage;
  int64_t groups = (kFwdTargetBlocks + runs * B - 1) / (runs * B);
  groups = groups < 1 ? 1 : groups > stages ? stages : groups;
  run.group = static_cast<int>((stages + groups - 1) / groups) * stage;
  groups = (C + run.group - 1) / run.group;
  if (runs > 0x7fffffff || groups > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(runs), static_cast<unsigned>(groups),
                  B);
  const size_t smem =
      sizeof(float4) * kMaxTaps * kRun + static_cast<size_t>(window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static const cudaError_t opted[2] = {
      cudaFuncSetAttribute(deform_fwd_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kFwdSmem),
      cudaFuncSetAttribute(deform_fwd_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kFwdSmem)};
  if (opted[dtype] != cudaSuccess) return static_cast<int>(opted[dtype]);
  if (dtype == 0) {
    deform_fwd_kernel<float><<<grid, kRun, smem, s>>>(
        static_cast<const float*>(x), offsets, mask, g, run,
        static_cast<float*>(cols));
  } else {
    deform_fwd_kernel<__nv_bfloat16><<<grid, kRun, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), offsets, mask, g, run,
        static_cast<__nv_bfloat16*>(cols));
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
  const int K = kh * kw;
  const int64_t P = static_cast<int64_t>(Ho) * Wo;
  if (static_cast<int64_t>(B) * K * P == 0 || C == 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Window win;
  win.h = window_span(kTileH, stride, kh, dilation);
  win.w = window_span(kTileW, stride, kw, dilation);
  const int64_t plane = static_cast<int64_t>(win.h) * win.w;
  // the tap sums, then the most channels per stage that fit (beside the
  // kernel's few static bytes)
  const int64_t sums = 3LL * K * kTileThreads * sizeof(float);
  const int64_t fit =
      (kStaticSmem - 64 - sums) / (2 * plane * sizeof(float));
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  win.stage = static_cast<int>(fit < kMaxStage ? fit : kMaxStage);
  const int64_t tiles_h = (Ho + kTileH - 1) / kTileH;
  win.tiles_w = (Wo + kTileW - 1) / kTileW;
  const int64_t tiles = tiles_h * win.tiles_w;
  // split the channels among enough blocks to balance the SMs
  const int64_t stages = (C + win.stage - 1) / win.stage;
  int64_t groups = (kTargetBlocks + tiles * B - 1) / (tiles * B);
  groups = groups < 1 ? 1 : groups > stages ? stages : groups;
  win.group = static_cast<int>((stages + groups - 1) / groups) * win.stage;
  groups = (C + win.group - 1) / win.group;
  if (tiles > 0x7fffffff || groups > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups > 1) {  // the blocks add their sums into zeros
    cudaError_t err = cudaMemsetAsync(
        doffsets, 0, sizeof(float) * B * 2 * K * P, s);
    if (err == cudaSuccess && mask != nullptr)
      err = cudaMemsetAsync(dmask, 0, sizeof(float) * B * K * P, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(groups), B);
  const size_t smem = sizeof(float) * 2 * win.stage * plane + sums;
  if (dtype == 0) {
    deform_bwd_kernel<float><<<grid, kTileThreads, smem, s>>>(
        static_cast<const float*>(grad), static_cast<const float*>(x),
        offsets, mask, g, win, dx, doffsets, dmask,
        static_cast<float*>(cols));
  } else {
    deform_bwd_kernel<__nv_bfloat16><<<grid, kTileThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(grad),
        static_cast<const __nv_bfloat16*>(x), offsets, mask, g, win, dx,
        doffsets, dmask, static_cast<__nv_bfloat16*>(cols));
  }
  return static_cast<int>(cudaGetLastError());
}
