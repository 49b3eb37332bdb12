// K4: the still-image camera-motion transform on Hopper (sm_90a).
//
// Replaces zeroshotvideoclassification_tpu/ops/resample_pallas.py:
// fused_image_motion_transform_pallas, which resized each of a sample's T
// crop boxes with two interpolation-matrix products per (frame, channel)
// plane on the TPU's matrix unit. With two taps per axis a GPU thread reads
// its four source pixels directly, so this kernel is the 4-tap gather of K1
// (video_transform.cu) with three differences:
//
//   * the taps are per FRAME: y0/y1/wy and x0/x1/wx are [B, T, S], row
//     (b * T + t) * S + oy (or + ox) of them belongs to output pixel
//     (b, t, oy, ox);
//   * the source is ONE image per sample, [B, Hc, Wc, 3]: all T frames of a
//     sample read the same image (263 KB at 256x342), which therefore stays
//     in L2 after the first frame touched it;
//   * the epilogue is the per-channel affine v * scale[c] + offset[c], with
//     the six constants passed as kernel arguments.
//
//   out[b, t, oy, ox, c] = lerp_x(lerp_y(image[b])) * scale[c] + offset[c]
//
// Bound: bytes. At the SUN training shape (16 images of 256x342, 16 frames,
// 112x112 out) it reads 4.2 MB of images and 0.7 MB of taps and writes
// 19.3 MB of bf16: a few microseconds of memory traffic, so the launch
// itself is most of its time. Design: one thread per (sample, frame, output
// pixel), all three channels in that thread; blockIdx.y is the frame, so
// neighbouring threads write neighbouring output pixels (coalesced stores)
// and share their row taps. Any image height and width is accepted.
//
// Arithmetic: the order of ops/resample.py:fused_image_motion_transform
// (row lerp at both source columns, the column lerp, then * scale, +
// offset), every step rounded on its own (the _rn intrinsics keep nvcc from
// contracting into FMAs), so the float32 output equals the plain version's.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Affine {
  float scale[3];
  float offset[3];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Memory safety only: the host builds in-range taps, which this never changes.
__device__ __forceinline__ int clamp_index(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

template <typename OutT>
__global__ void image_motion_transform_kernel(
    const uint8_t* __restrict__ images,  // [B, Hc, Wc, 3]
    const int32_t* __restrict__ y0, const int32_t* __restrict__ y1,
    const float* __restrict__ wy,  // [B, T, S]
    const int32_t* __restrict__ x0, const int32_t* __restrict__ x1,
    const float* __restrict__ wx,  // [B, T, S]
    OutT* __restrict__ out,        // [B, T, S, S, 3]
    Affine affine, int T, int Hc, int Wc, int S) {
  const int frame = blockIdx.y;  // b * T + t
  const int p = blockIdx.x * blockDim.x + threadIdx.x;  // oy * S + ox
  if (p >= S * S) return;
  const int b = frame / T;
  const int oy = p / S;
  const int ox = p - oy * S;
  const int ty = frame * S + oy;
  const int tx = frame * S + ox;
  const size_t row = static_cast<size_t>(Wc) * 3;
  const uint8_t* img = images + static_cast<size_t>(b) * Hc * row;
  const uint8_t* ra = img + clamp_index(y0[ty], Hc - 1) * row;
  const uint8_t* rb = img + clamp_index(y1[ty], Hc - 1) * row;
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
    const float v = __fadd_rn(__fmul_rn(ca, gx), __fmul_rn(cb, fx));
    store(o + c, __fadd_rn(__fmul_rn(v, affine.scale[c]), affine.offset[c]));
  }
}

template <typename OutT>
int launch(const void* images, const void* y0, const void* y1, const void* wy,
           const void* x0, const void* x1, const void* wx, void* out,
           const Affine& affine, int B, int T, int Hc, int Wc, int S,
           void* stream) {
  constexpr int kThreads = 256;
  const dim3 grid((S * S + kThreads - 1) / kThreads, B * T);
  image_motion_transform_kernel<OutT><<<grid, kThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(images), static_cast<const int32_t*>(y0),
      static_cast<const int32_t*>(y1), static_cast<const float*>(wy),
      static_cast<const int32_t*>(x0), static_cast<const int32_t*>(x1),
      static_cast<const float*>(wx), static_cast<OutT*>(out), affine, T, Hc,
      Wc, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). s0..s2 and
// o0..o2 are the per-channel scale and offset. The caller checks shapes,
// types and contiguity, and that B*T <= 65535 (grid.y).
extern "C" int zsvc_image_motion_transform_f32(
    const void* images, const void* y0, const void* y1, const void* wy,
    const void* x0, const void* x1, const void* wx, void* out, float s0,
    float s1, float s2, float o0, float o1, float o2, int B, int T, int Hc,
    int Wc, int S, void* stream) {
  const Affine affine = {{s0, s1, s2}, {o0, o1, o2}};
  return launch<float>(images, y0, y1, wy, x0, x1, wx, out, affine, B, T, Hc,
                       Wc, S, stream);
}

extern "C" int zsvc_image_motion_transform_bf16(
    const void* images, const void* y0, const void* y1, const void* wy,
    const void* x0, const void* x1, const void* wx, void* out, float s0,
    float s1, float s2, float o0, float o1, float o2, int B, int T, int Hc,
    int Wc, int S, void* stream) {
  const Affine affine = {{s0, s1, s2}, {o0, o1, o2}};
  return launch<__nv_bfloat16>(images, y0, y1, wy, x0, x1, wx, out, affine, B,
                               T, Hc, Wc, S, stream);
}
