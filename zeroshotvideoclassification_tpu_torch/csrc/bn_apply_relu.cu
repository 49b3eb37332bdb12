// K2: the BatchNorm-apply (+ residual) (+ ReLU) block epilogue on Hopper
// (sm_90a), forward and backward.
//
// FORWARD. Replaces the forward half of zeroshotvideoclassification_tpu/ops/
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
//
// BACKWARD. Replaces bn_pallas.py:_bwd (_bwd_kernel): with
// g = dy * (y > 0) under ReLU (the mask read from the stored, already
// rounded y), else g = dy, and x_hat = x * sinv[c] - (mean * sinv)[c]:
//
//   dx = g * a[c]        d_residual = g (written only when asked for)
//   S1[c] = sum g        S2[c] = sum g * x_hat          (float32)
//
// Bound: bytes. It reads x, y and dy and writes dx (and g) once, 4-5 passes
// over the tensor; the plain PyTorch chain takes about twenty. The TPU
// kernel carried S1/S2 from one step of its sequential grid to the next;
// blocks of a GPU run in no order, so the sums take two kernels and no
// atomics. The tensor is seen as [rows, Wf] with Wf = m * C (m consecutive
// [.., C] rows folded into one, so that Wf fills whole 256-thread blocks
// whatever C is; the wrapper picks m). Pass 1: a thread owns one column j
// (one channel, j % C) of one chunk of rows, walks its rows in order,
// writes dx (and g) and leaves its two sums in partial[2][chunks][Wf].
// Pass 2: for each channel, 32 threads each add every 32nd of the
// chunks * m partial sums in index order, and one thread adds the 32
// results in order. Every sum has one fixed order, so two runs agree bit for
// bit. No FMA contraction: the elementwise results equal the plain
// version's.

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

// ---------------------------------------------------------------- backward ---

constexpr int kBwdThreads = 256;  // pass 1: columns per block
constexpr int kRedLanes = 32;     // pass 2: channels per block ...
constexpr int kRedRows = 32;      // ... times partial-sum strides

template <typename T, bool kRelu, bool kWantG, typename IndexT>
__global__ void bn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                              const T* __restrict__ dy,
                              const float* __restrict__ a,
                              const float* __restrict__ sinv,
                              const float* __restrict__ msinv,
                              T* __restrict__ dx, T* __restrict__ g_out,
                              float* __restrict__ partial, IndexT n, int C,
                              int Wf, IndexT rows, int rows_per_chunk) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wf) return;
  const int c = j % C;
  const float ac = a[c], sc = sinv[c], mc = msinv[c];
  const IndexT r0 = static_cast<IndexT>(blockIdx.y) * rows_per_chunk;
  IndexT r1 = r0 + rows_per_chunk;
  if (r1 > rows) r1 = rows;
  float s1 = 0.0f, s2 = 0.0f;
  for (IndexT r = r0; r < r1; ++r) {
    const IndexT i = r * Wf + j;
    if (i >= n) break;  // the ragged last folded row
    float g = load(dy + i);
    // a product, as bn_pallas.py:97: a NaN in dy stays a NaN under the mask
    if (kRelu) g = __fmul_rn(g, load(y + i) > 0.0f ? 1.0f : 0.0f);
    const float xh = __fsub_rn(__fmul_rn(load(x + i), sc), mc);
    store(dx + i, __fmul_rn(g, ac));
    if (kWantG) store(g_out + i, g);
    s1 = __fadd_rn(s1, g);
    s2 = __fadd_rn(s2, __fmul_rn(g, xh));
  }
  const size_t chunks = gridDim.y;
  partial[static_cast<size_t>(blockIdx.y) * Wf + j] = s1;
  partial[(chunks + blockIdx.y) * Wf + j] = s2;
}

// sums[which][c] = sum over (chunk, fold) of partial[which][chunk][fold*C + c]
__global__ void bn_bwd_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ sums, int C, int Wf,
                                     int chunks) {
  __shared__ float sh[kRedRows][kRedLanes + 1];
  const int c = blockIdx.x * kRedLanes + threadIdx.x;
  const float* p = partial + static_cast<size_t>(blockIdx.y) * chunks * Wf;
  const int m = Wf / C;
  const int K = chunks * m;
  float acc = 0.0f;
  if (c < C) {
    for (int k = threadIdx.y; k < K; k += kRedRows) {
      const int chunk = k / m, f = k - chunk * m;
      acc = __fadd_rn(acc, p[static_cast<size_t>(chunk) * Wf + f * C + c]);
    }
  }
  sh[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t = sh[0][threadIdx.x];
    for (int q = 1; q < kRedRows; ++q) t = __fadd_rn(t, sh[q][threadIdx.x]);
    sums[blockIdx.y * C + c] = t;
  }
}

template <typename T, bool kRelu, bool kWantG>
void launch_bwd_typed(const void* x, const void* y, const void* dy,
                      const float* a, const float* sinv, const float* msinv,
                      void* dx, void* g, float* partial, long long n, int C,
                      int Wf, int chunks, int rows_per_chunk,
                      cudaStream_t stream) {
  const dim3 grid((Wf + kBwdThreads - 1) / kBwdThreads, chunks);
  const long long rows = (n + Wf - 1) / Wf;
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  T* gt = static_cast<T*>(g);
  if (n < (1LL << 31)) {
    bn_bwd_kernel<T, kRelu, kWantG, uint32_t>
        <<<grid, kBwdThreads, 0, stream>>>(
            xt, yt, dyt, a, sinv, msinv, dxt, gt, partial,
            static_cast<uint32_t>(n), C, Wf, static_cast<uint32_t>(rows),
            rows_per_chunk);
  } else {
    bn_bwd_kernel<T, kRelu, kWantG, uint64_t>
        <<<grid, kBwdThreads, 0, stream>>>(
            xt, yt, dyt, a, sinv, msinv, dxt, gt, partial,
            static_cast<uint64_t>(n), C, Wf, static_cast<uint64_t>(rows),
            rows_per_chunk);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* y, const void* dy, const void* a,
               const void* sinv, const void* msinv, void* dx, void* g,
               void* partial, void* sums, long long n, int C, int Wf,
               int chunks, int rows_per_chunk, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* at = static_cast<const float*>(a);
  const float* st = static_cast<const float*>(sinv);
  const float* mt = static_cast<const float*>(msinv);
  float* pt = static_cast<float*>(partial);
  if (relu) {
    if (g != nullptr)
      launch_bwd_typed<T, true, true>(x, y, dy, at, st, mt, dx, g, pt, n, C,
                                      Wf, chunks, rows_per_chunk, s);
    else
      launch_bwd_typed<T, true, false>(x, y, dy, at, st, mt, dx, g, pt, n, C,
                                       Wf, chunks, rows_per_chunk, s);
  } else {
    if (g != nullptr)
      launch_bwd_typed<T, false, true>(x, y, dy, at, st, mt, dx, g, pt, n, C,
                                       Wf, chunks, rows_per_chunk, s);
    else
      launch_bwd_typed<T, false, false>(x, y, dy, at, st, mt, dx, g, pt, n,
                                        C, Wf, chunks, rows_per_chunk, s);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 rgrid((C + kRedLanes - 1) / kRedLanes, 2);
  bn_bwd_reduce_kernel<<<rgrid, dim3(kRedLanes, kRedRows), 0, s>>>(
      pt, static_cast<float*>(sums), C, Wf, chunks);
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

// Backward, both passes on `stream`. `y` is read only when relu != 0; `g`
// may be NULL (no d_residual wanted). The caller checks that x, y, dy, dx and
// g are contiguous with C innermost, that a, sinv and msinv are float32 [C],
// that Wf is a multiple of C, chunks * rows_per_chunk covers
// ceil(n / Wf) rows with chunks <= 65535, and allocates
// partial float32 [2][chunks][Wf] and sums float32 [2][C]. Returns
// cudaGetLastError() of the first launch that failed (0 = both launched).
extern "C" int zsvc_bn_bwd_f32(const void* x, const void* y, const void* dy,
                               const void* a, const void* sinv,
                               const void* msinv, void* dx, void* g,
                               void* partial, void* sums, long long n, int C,
                               int Wf, int chunks, int rows_per_chunk,
                               int relu, void* stream) {
  return launch_bwd<float>(x, y, dy, a, sinv, msinv, dx, g, partial, sums, n,
                           C, Wf, chunks, rows_per_chunk, relu, stream);
}

extern "C" int zsvc_bn_bwd_bf16(const void* x, const void* y, const void* dy,
                                const void* a, const void* sinv,
                                const void* msinv, void* dx, void* g,
                                void* partial, void* sums, long long n, int C,
                                int Wf, int chunks, int rows_per_chunk,
                                int relu, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, y, dy, a, sinv, msinv, dx, g, partial,
                                   sums, n, C, Wf, chunks, rows_per_chunk,
                                   relu, stream);
}
