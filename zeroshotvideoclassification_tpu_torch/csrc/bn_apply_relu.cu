// K2 (forward): the BatchNorm-apply (+ residual) (+ ReLU) block epilogue on
// Hopper (sm_90a).
//
// Replaces the forward half of zeroshotvideoclassification_tpu/ops/
// bn_pallas.py:bn_apply_relu_pallas (_fwd_kernel, _fwd_res_kernel):
//
//   y = [relu](x * a[c] + b[c] [+ r])      c = i % C
//
// on a channels-last contiguous tensor, where the caller has folded the
// eval-mode statistics into a = scale * rsqrt(var + eps) and
// b = bias - mean * a (float32, bn_pallas.py:144-146). The math is float32
// with one rounding at the store: under bf16 the residual add rounds once,
// as in bn_pallas, where the unfused path rounds after BN and again after
// the add.
//
// Bound: bytes. One read of x (and r) and one write of y, about 0.5 flop per
// byte. The plain PyTorch chain spends six passes over the tensor (cast,
// mul, add, add, relu, cast); this kernel spends one. Design: a grid-stride
// loop over the flat index, with a 32-bit index wherever the tensor allows
// it (the channel is a modulo on every element). The TPU kernel's
// lane-folding of W into the channel axis has no purpose here: a GPU thread
// reads any channel count at full coalescing. Vector loads are left for
// later.

#include <cstdint>
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

template <typename T, bool kResidual, bool kRelu, typename IndexT>
__global__ void bn_apply_relu_kernel(const T* __restrict__ x,
                                     const T* __restrict__ r,
                                     const float* __restrict__ a,
                                     const float* __restrict__ b,
                                     T* __restrict__ y, IndexT n, int C) {
  const IndexT stride = static_cast<IndexT>(gridDim.x) * blockDim.x;
  for (IndexT i = static_cast<IndexT>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int c = static_cast<int>(i % static_cast<IndexT>(C));
    // separate roundings, no FMA: the order of the plain version
    float v = __fadd_rn(__fmul_rn(load(x + i), a[c]), b[c]);
    if (kResidual) v = __fadd_rn(v, load(r + i));
    if (kRelu) v = v < 0.0f ? 0.0f : v;  // NaN passes, as in torch.relu
    store(y + i, v);
  }
}

template <typename T, bool kResidual, bool kRelu>
void launch_typed(const void* x, const void* r, const void* a, const void* b,
                  void* y, long long n, int C, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const float* at = static_cast<const float*>(a);
  const float* bt = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  if (n < (1LL << 31)) {
    bn_apply_relu_kernel<T, kResidual, kRelu, uint32_t>
        <<<blocks, kThreads, 0, stream>>>(xt, rt, at, bt, yt,
                                          static_cast<uint32_t>(n), C);
  } else {
    bn_apply_relu_kernel<T, kResidual, kRelu, uint64_t>
        <<<blocks, kThreads, 0, stream>>>(xt, rt, at, bt, yt,
                                          static_cast<uint64_t>(n), C);
  }
}

template <typename T>
int launch(const void* x, const void* r, const void* a, const void* b, void* y,
           long long n, int C, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r != nullptr) {
    if (relu) launch_typed<T, true, true>(x, r, a, b, y, n, C, s);
    else      launch_typed<T, true, false>(x, r, a, b, y, n, C, s);
  } else {
    if (relu) launch_typed<T, false, true>(x, r, a, b, y, n, C, s);
    else      launch_typed<T, false, false>(x, r, a, b, y, n, C, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; `r` may be NULL (no residual). Returns
// cudaGetLastError() (0 = launched). The caller checks that x, r and y are
// contiguous with C innermost, a and b are float32 [C], and n > 0.
extern "C" int zsvc_bn_apply_relu_f32(const void* x, const void* r,
                                      const void* a, const void* b, void* y,
                                      long long n, int C, int relu,
                                      void* stream) {
  return launch<float>(x, r, a, b, y, n, C, relu, stream);
}

extern "C" int zsvc_bn_apply_relu_bf16(const void* x, const void* r,
                                       const void* a, const void* b, void* y,
                                       long long n, int C, int relu,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, r, a, b, y, n, C, relu, stream);
}
