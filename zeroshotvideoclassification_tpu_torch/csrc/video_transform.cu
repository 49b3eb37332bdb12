// K1: the fused video input transform on Hopper (sm_90a).
//
// Replaces zeroshotvideoclassification_tpu/ops/resample_pallas.py:
// fused_video_transform_pallas, which ran the separable bilinear resample as
// two interpolation-matrix products per (sample, frame, channel) plane on the
// TPU's matrix unit. With two taps per axis a GPU reads the four source
// pixels directly, so this kernel is a plain 4-tap gather:
//
//   out[b, t, oy, ox, c] = (((lerp_x(lerp_y(canvas)) / 255) - 1) / 2
//
// with the taps y0/y1/wy (per output row) and x0/x1/wx (per output column)
// of sample b, into which resize, crop and flip were folded on the host
// (data/transform_params.py:resample_indices).
//
// Bound: bytes. At the serving shape (bucket 8, 64 frames, a 226x226 window)
// it reads about 78 MB of uint8 canvas and writes 38.5 MB of bf16, against a
// few flops per byte. Design: one thread per (sample, frame, output pixel),
// all three channels in that thread; blockIdx.y is the frame, so the tap
// vectors of a block's sample are read from global memory (L1/L2-resident)
// and output pixels of neighbouring threads are neighbours in memory, which
// keeps the stores coalesced. Any canvas height and width is accepted (no
// padding to a tile). Staging the frame in shared memory, vector loads and a
// padded channel count are left for later.
//
// Arithmetic: the order of ops/resample.py:38-50 (row lerp at both source
// columns, then the column lerp, then /255, -1, /2), every step rounded on
// its own (the _rn intrinsics keep nvcc from contracting into FMAs), so the
// float32 output equals the plain PyTorch version's.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Memory safety only: the host builds in-range taps, which this never changes.
__device__ __forceinline__ int clamp_index(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

template <typename OutT>
__global__ void video_transform_kernel(
    const uint8_t* __restrict__ canvas,  // [B, T, Hc, Wc, 3]
    const int32_t* __restrict__ y0, const int32_t* __restrict__ y1,
    const float* __restrict__ wy,  // [B, S]
    const int32_t* __restrict__ x0, const int32_t* __restrict__ x1,
    const float* __restrict__ wx,  // [B, S]
    OutT* __restrict__ out,        // [B, T, S, S, 3]
    int T, int Hc, int Wc, int S) {
  const int frame = blockIdx.y;  // b * T + t
  const int p = blockIdx.x * blockDim.x + threadIdx.x;  // oy * S + ox
  if (p >= S * S) return;
  const int b = frame / T;
  const int oy = p / S;
  const int ox = p - oy * S;
  const int ty = b * S + oy;
  const int tx = b * S + ox;
  const size_t row = static_cast<size_t>(Wc) * 3;
  const uint8_t* f = canvas + static_cast<size_t>(frame) * Hc * row;
  const uint8_t* ra = f + clamp_index(y0[ty], Hc - 1) * row;
  const uint8_t* rb = f + clamp_index(y1[ty], Hc - 1) * row;
  const int xa = clamp_index(x0[tx], Wc - 1) * 3;
  const int xb = clamp_index(x1[tx], Wc - 1) * 3;
  const float fy = wy[ty];
  const float fx = wx[tx];
  const float gy = __fsub_rn(1.0f, fy);
  const float gx = __fsub_rn(1.0f, fx);
  OutT* o = out + (static_cast<size_t>(frame) * S * S + p) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ca = __fadd_rn(__fmul_rn(static_cast<float>(ra[xa + c]), gy),
                               __fmul_rn(static_cast<float>(rb[xa + c]), fy));
    const float cb = __fadd_rn(__fmul_rn(static_cast<float>(ra[xb + c]), gy),
                               __fmul_rn(static_cast<float>(rb[xb + c]), fy));
    float v = __fadd_rn(__fmul_rn(ca, gx), __fmul_rn(cb, fx));
    v = __fdiv_rn(__fsub_rn(__fdiv_rn(v, 255.0f), 1.0f), 2.0f);
    store(o + c, v);
  }
}

template <typename OutT>
int launch(const void* canvas, const void* y0, const void* y1, const void* wy,
           const void* x0, const void* x1, const void* wx, void* out, int B,
           int T, int Hc, int Wc, int S, void* stream) {
  constexpr int kThreads = 256;
  const dim3 grid((S * S + kThreads - 1) / kThreads, B * T);
  video_transform_kernel<OutT><<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(canvas), static_cast<const int32_t*>(y0),
      static_cast<const int32_t*>(y1), static_cast<const float*>(wy),
      static_cast<const int32_t*>(x0), static_cast<const int32_t*>(x1),
      static_cast<const float*>(wx), static_cast<OutT*>(out), T, Hc, Wc, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The caller
// checks shapes, types and contiguity, and that B*T <= 65535 (grid.y).
extern "C" int zsvc_video_transform_f32(const void* canvas, const void* y0,
                                        const void* y1, const void* wy,
                                        const void* x0, const void* x1,
                                        const void* wx, void* out, int B,
                                        int T, int Hc, int Wc, int S,
                                        void* stream) {
  return launch<float>(canvas, y0, y1, wy, x0, x1, wx, out, B, T, Hc, Wc, S,
                       stream);
}

extern "C" int zsvc_video_transform_bf16(const void* canvas, const void* y0,
                                         const void* y1, const void* wy,
                                         const void* x0, const void* x1,
                                         const void* wx, void* out, int B,
                                         int T, int Hc, int Wc, int S,
                                         void* stream) {
  return launch<__nv_bfloat16>(canvas, y0, y1, wy, x0, x1, wx, out, B, T, Hc,
                               Wc, S, stream);
}
