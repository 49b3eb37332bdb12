// What the BN kernels share: K2 (bn_apply_relu.cu) and the BN statistics'
// sums (bn_stats.cu). Element access in float32, 16-byte packs, the check
// of a plan of the folded [rows, Wf] view (ops/bn_cuda._plan), and the two
// fixed-order stages of a per-channel sum over that view: one partial per
// block and channel, then the partials added in a fixed order by a second
// kernel (no atomics, so two runs agree bit for bit).

#pragma once

#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load(const float* p) { return *p; }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int kVec>
struct Pack;  // kVec consecutive elements as one access
template <>
struct Pack<float, 4> { typedef float4 type; };
template <>
struct Pack<__nv_bfloat16, 8> { typedef uint4 type; };
template <>
struct Pack<float, 1> { typedef float type; };
template <>
struct Pack<__nv_bfloat16, 1> { typedef __nv_bfloat16 type; };

template <typename T, int kVec>
__device__ __forceinline__ void load_pack(const T* p, float (&v)[kVec]) {
  const typename Pack<T, kVec>::type raw =
      *reinterpret_cast<const typename Pack<T, kVec>::type*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = load(e + k);
}

template <typename T, int kVec>
__device__ __forceinline__ void store_pack(T* p, const float (&v)[kVec]) {
  typename Pack<T, kVec>::type raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec; ++k) store(e + k, v[k]);
  *reinterpret_cast<typename Pack<T, kVec>::type*>(p) = raw;
}

constexpr int kMaxThreads = 512;  // threads per block, at most (every plan)

// A plan (ops/bn_cuda.fwd_plan or bwd_plan) against these sources and the
// pointers: Wf a multiple of C and of vec, vec 1 or the 16-byte width (then
// every pointer 16-byte aligned), col_tiles blocks of `threads` threads
// cover Wf / vec columns, chunks * rows_per_chunk cover ceil(n / Wf) rows.
template <typename T>
bool plan_ok(long long n, int C, int Wf, int vec, int threads, int col_tiles,
             int chunks, int rows_per_chunk,
             std::initializer_list<const void*> ptrs) {
  constexpr int kFull = 16 / static_cast<int>(sizeof(T));
  const long long rows = (n + Wf - 1) / Wf;
  bool ok = C >= 1 && Wf >= C && (vec == 1 || vec == kFull) && Wf % C == 0 &&
            Wf % vec == 0 && threads >= 32 && threads <= kMaxThreads &&
            threads % 32 == 0 &&
            static_cast<long long>(col_tiles) * threads * vec >= Wf &&
            static_cast<long long>(col_tiles - 1) * threads * vec < Wf &&
            chunks >= 1 && chunks <= 65535 && rows_per_chunk >= 1 &&
            static_cast<long long>(chunks) * rows_per_chunk >= rows;
  if (vec != 1) {
    for (const void* p : ptrs)
      ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  }
  return ok;
}

// Stage 1's end, in a block of a [col_tiles, chunks] grid whose thread
// owns kVec consecutive columns of the folded view: the block adds, for
// each channel, its threads' column sums s1 and s2 in column order through
// `sh` (dynamic shared memory of 2 * blockDim.x * kVec floats) and writes
// ONE partial per channel: partial[2][blocks][C].
template <int kVec>
__device__ __forceinline__ void write_block_partials(
    float* sh, const float (&s1)[kVec], const float (&s2)[kVec], int C,
    int Wf, float* __restrict__ partial) {
  const int width = blockDim.x * kVec;  // columns per block
  const int j_lo = blockIdx.x * width;  // the block's first column
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    sh[threadIdx.x * kVec + k] = s1[k];
    sh[width + threadIdx.x * kVec + k] = s2[k];
  }
  __syncthreads();
  // one partial per channel: the block's columns of that channel, in order
  const int j_hi = min(j_lo + width, Wf);
  const size_t blocks = static_cast<size_t>(gridDim.x) * gridDim.y;
  const size_t block = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int q = j_lo + (c - j_lo % C + C) % C; q < j_hi; q += C) {
      t1 = __fadd_rn(t1, sh[q - j_lo]);
      t2 = __fadd_rn(t2, sh[width + q - j_lo]);
    }
    partial[block * C + c] = t1;
    partial[(blocks + block) * C + c] = t2;
  }
}

constexpr int kRedLanes = 32;  // stage 2: channels per block ...
constexpr int kRedRows = 32;   // ... times strides over the partials

// Stage 2, in a block of kRedLanes x kRedRows threads for kRedLanes
// channels: each thread adds every kRedRows-th partial in index order, and
// a fixed-shape tree adds the kRedRows results. Afterwards
// sh[which][0][threadIdx.x] holds sum over blocks of
// partial[which][block][c] for c = blockIdx.x * kRedLanes + threadIdx.x.
__device__ __forceinline__ void sum_block_partials(
    const float* __restrict__ partial, int C, int blocks,
    float (&sh)[2][kRedRows][kRedLanes + 1]) {
  const int c = blockIdx.x * kRedLanes + threadIdx.x;
  float acc[2] = {0.0f, 0.0f};
  if (c < C) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* p = partial + static_cast<size_t>(which) * blocks * C + c;
#pragma unroll 4
      for (int k = threadIdx.y; k < blocks; k += kRedRows)
        acc[which] = __fadd_rn(acc[which], p[static_cast<size_t>(k) * C]);
    }
  }
  sh[0][threadIdx.y][threadIdx.x] = acc[0];
  sh[1][threadIdx.y][threadIdx.x] = acc[1];
  __syncthreads();
  for (int half = kRedRows / 2; half > 0; half /= 2) {
    if (threadIdx.y < half) {
#pragma unroll
      for (int which = 0; which < 2; ++which)
        sh[which][threadIdx.y][threadIdx.x] =
            __fadd_rn(sh[which][threadIdx.y][threadIdx.x],
                      sh[which][threadIdx.y + half][threadIdx.x]);
    }
    __syncthreads();
  }
}

}  // namespace
