// K3: the (3,1,1) temporal convolution of R(2+1)D blocks on Hopper (sm_90a).
//
// Replaces zeroshotvideoclassification_tpu/ops/temporal_conv.py:
// _pallas_forward (temporal_conv3), which streamed a zero-padded [T+2, PT,
// Ci] slab of one sample through the TPU's fast memory and ran three
// matrix-unit products per grid cell. What it computes, with (H, W)
// flattened into p and stride 1, SAME padding:
//
//   y[n, t, p, :] = sum_{dt=0..2} x[n, t + dt - 1, p, :] @ W[dt]
//
// in float32 accumulation, rounded once to the output type. x is
// [N, T, P, Ci] and y [N, T, P, Co], both contiguous (channels innermost,
// the port's channels-last-3d); W is [3, Ci, Co].
//
// Here the three products are ONE implicit GEMM over K = 3 * Ci: the rows
// (n, t, p) are flat, row r shifted by dt is row r + (dt - 1) * P of the
// same tensor, and a shifted row whose t + dt - 1 falls outside [0, T)
// contributes zero by predicate. No padded copy of x is made (the TPU
// wrapper's pad was a whole extra pass over x). Ci and Co are ragged in
// this network (144, 230, 288, 460, 576, 921, 1152 in; 45 in at the stem):
// the tails of every tile are predicated, so any Ci, Co and row count is
// accepted. Offsets are 64-bit.
//
// Design: a classic register-tiled GEMM on the CUDA cores. A block of 256
// threads owns kTileRows x kTileCo = 128 x 64 outputs; per step of kTileCi =
// 16 input channels it stages the x tile (transposed, converted to float32)
// and the W tile in shared memory, and each thread accumulates an 8 x 4
// patch in registers, reading its operands as float4. The tile plan (how
// many row and channel tiles) is computed in Python
// (ops/temporal_conv.tile_plan) and checked here.
//
// Bound: at the layer1 shape ([16,16,56*56,144] -> 64, bf16) the bytes (231
// MB read, 103 MB written) take 0.10 ms at 3.35 TB/s and the 44.4 GFLOP half
// of that on the bf16 tensor cores, so the card's bound is bytes. This
// kernel multiplies in float32 on the CUDA cores, whose 67 TFLOP/s put ITS
// floor at 0.66 ms; tensor cores (wgmma on TMA-fed tiles) are the redesign
// that can reach the card's bound.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 128;  // output rows (n, t, p) per block
constexpr int kTileCo = 64;     // output channels per block
constexpr int kTileCi = 16;     // input channels per staging step
constexpr int kThreads = 256;   // 16 x 16 threads, an 8 x 4 patch each
constexpr int kPatchRows = 8;
constexpr int kPatchCo = 4;
constexpr int kPad = 4;  // keeps As rows 16-byte aligned, spreads the banks

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) temporal_conv3_kernel(
    const T* __restrict__ x,  // [rows, Ci], rows = N * T * P
    const T* __restrict__ w,  // [3, Ci, Co]
    T* __restrict__ y,        // [rows, Co]
    long long rows, int Tlen, int P, int Ci, int Co) {
  __shared__ __align__(16) float As[kTileCi][kTileRows + kPad];
  __shared__ __align__(16) float Bs[kTileCi][kTileCo];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // patch column: channels tx * 4 .. + 3
  const int ty = tid / 16;  // patch row: rows ty * 8 .. + 7
  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const int co0 = blockIdx.y * kTileCo;

  // staging roles: 16 consecutive threads read 16 consecutive channels of
  // one row of x; 64 consecutive threads read 64 consecutive channels of W
  constexpr int kRowsPerPass = kThreads / kTileCi;           // 16
  constexpr int kRowPasses = kTileRows / kRowsPerPass;       // 8
  constexpr int kCiPerPass = kThreads / kTileCo;             // 4
  constexpr int kCiPasses = kTileCi / kCiPerPass;            // 4
  const int a_k = tid % kTileCi;
  const int a_m = tid / kTileCi;
  const int b_n = tid % kTileCo;
  const int b_k = tid / kTileCo;

  int a_t[kRowPasses];  // the frame index t of each row this thread stages
#pragma unroll
  for (int i = 0; i < kRowPasses; ++i) {
    const long long r = row0 + a_m + i * kRowsPerPass;
    a_t[i] = static_cast<int>((r / P) % Tlen);
  }

  float acc[kPatchRows][kPatchCo];
#pragma unroll
  for (int i = 0; i < kPatchRows; ++i)
#pragma unroll
    for (int j = 0; j < kPatchCo; ++j) acc[i][j] = 0.0f;

  for (int dt = 0; dt < 3; ++dt) {
    const int shift = dt - 1;
    const T* wd = w + static_cast<long long>(dt) * Ci * Co;
    for (int ci0 = 0; ci0 < Ci; ci0 += kTileCi) {
      const bool a_k_ok = ci0 + a_k < Ci;
#pragma unroll
      for (int i = 0; i < kRowPasses; ++i) {
        const int m = a_m + i * kRowsPerPass;
        const long long r = row0 + m;
        const int ts = a_t[i] + shift;
        float v = 0.0f;
        if (a_k_ok && r < rows && ts >= 0 && ts < Tlen) {
          v = to_float(
              x[(r + static_cast<long long>(shift) * P) * Ci + ci0 + a_k]);
        }
        As[a_k][m] = v;
      }
#pragma unroll
      for (int i = 0; i < kCiPasses; ++i) {
        const int k = b_k + i * kCiPerPass;
        float v = 0.0f;
        if (ci0 + k < Ci && co0 + b_n < Co) {
          v = to_float(wd[static_cast<long long>(ci0 + k) * Co + co0 + b_n]);
        }
        Bs[k][b_n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTileCi; ++k) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(&As[k][ty * kPatchRows]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[k][ty * kPatchRows + 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * kPatchCo]);
        const float a[kPatchRows] = {a0.x, a0.y, a0.z, a0.w,
                                     a1.x, a1.y, a1.z, a1.w};
        const float bb[kPatchCo] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kPatchRows; ++i)
#pragma unroll
          for (int j = 0; j < kPatchCo; ++j)
            acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kPatchRows; ++i) {
    const long long r = row0 + ty * kPatchRows + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kPatchCo; ++j) {
      const int co = co0 + tx * kPatchCo + j;
      if (co < Co) store(y + r * Co + co, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, long long rows, int Tlen,
           int P, int Ci, int Co, int row_tiles, int co_tiles, void* stream) {
  // the plan comes from Python; refuse one that does not cover the output
  if (static_cast<long long>(row_tiles) * kTileRows < rows ||
      static_cast<long long>(row_tiles - 1) * kTileRows >= rows ||
      co_tiles * kTileCo < Co || (co_tiles - 1) * kTileCo >= Co) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(row_tiles, co_tiles);
  temporal_conv3_kernel<T><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      rows, Tlen, P, Ci, Co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a tile plan that is not this source's. The
// caller checks shapes, types and contiguity.
extern "C" int zsvc_temporal_conv3_f32(const void* x, const void* w, void* y,
                                       long long rows, int T, int P, int Ci,
                                       int Co, int row_tiles, int co_tiles,
                                       void* stream) {
  return launch<float>(x, w, y, rows, T, P, Ci, Co, row_tiles, co_tiles,
                       stream);
}

extern "C" int zsvc_temporal_conv3_bf16(const void* x, const void* w, void* y,
                                        long long rows, int T, int P, int Ci,
                                        int Co, int row_tiles, int co_tiles,
                                        void* stream) {
  return launch<__nv_bfloat16>(x, w, y, rows, T, P, Ci, Co, row_tiles,
                               co_tiles, stream);
}
