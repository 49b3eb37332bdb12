// K2: the BatchNorm-apply (+ residual) (+ ReLU) block epilogue on Hopper
// (sm_90a), forward and backward.
//
// FORWARD. Replaces the forward half of zeroshotvideoclassification_tpu/ops/
// bn_pallas.py:bn_apply_relu_pallas (_fwd_kernel, _fwd_res_kernel):
//
//   y = [relu](x * a[c] + b[c] [+ r])      c = i % C
//   a = scale * rsqrt(var + eps),  b = bias - mean * a     (float32,
//                                                  bn_pallas.py:144-146)
//
// on a channels-last contiguous tensor. The math is float32 with one
// rounding at the store: under bf16 the residual add rounds once, as in
// bn_pallas, where the unfused path rounds after BN and again after the add.
//
// Bound: bytes. One read of x (and r) and one write of y, about 0.5 flop per
// byte; 37 launches a forward, most of them a few MB, so the host's cost of
// a call counts as much as the device's. Design: the tensor is seen as
// [rows, Wf] with Wf = m * C (m consecutive [.., C] rows folded into one;
// ops/bn_cuda.fwd_plan picks m so that Wf is a multiple of the vector width
// and fills whole warps). A thread owns kVec CONSECUTIVE columns (16 bytes:
// 8 bf16 or 4 float32), computes their a and b once in registers from
// scale, bias, mean, var and eps (no PyTorch op prepares them: a call is one
// allocation and one launch), and walks a chunk of rows two at a time: per
// row one 16-byte load of x (and of r) and one 16-byte store of y. The grid
// has enough chunks of rows to fill the card several times over. The ragged
// last folded row takes a scalar tail; tensors that are not 16-byte aligned
// take the same kernel at kVec = 1. No FMA contraction: rsqrtf and the
// separate roundings give the plain version's float32 values (fold_affine
// and the chain of PyTorch ops in ops/bn_cuda.bn_apply_relu_plain).
//
// BACKWARD. Replaces bn_pallas.py:_bwd (_bwd_kernel): with
// g = dy * (y > 0) under ReLU (the mask read from the stored, already
// rounded y), else g = dy, sinv = rsqrt(var + eps), a = scale * sinv and
// x_hat = x * sinv[c] - (mean * sinv)[c]:
//
//   dx = g * a[c]        d_residual = g (written only when asked for)
//   S1[c] = sum g        S2[c] = sum g * x_hat          (float32)
//   d_scale = S2   d_bias = S1   d_mean = -a * S1
//   d_var = -1/2 * scale * sinv^2 * S2
//
// Bound: bytes. It reads x, y and dy and writes dx (and g) once, 4-5 passes
// over the tensor; the plain PyTorch chain takes about twenty. So the design
// is about the memory system and about the host: two launches and nothing
// else per call.
//
// The TPU kernel carried S1/S2 from one step of its sequential grid to the
// next; blocks of a GPU run in no order, so the sums take two kernels and no
// atomics. The tensor is seen as [rows, Wf] with Wf = m * C (m consecutive
// [.., C] rows folded into one; the wrapper's plan picks m so that Wf is a
// multiple of the vector width and fills whole warps).
//
// Pass 1: a thread owns kVec CONSECUTIVE columns (16 bytes: 8 bf16 or 4
// float32) of one chunk of rows and walks its rows in order, two rows in
// flight: one 16-byte load each of x, y, dy and one 16-byte store each of dx,
// g per row. Its per-channel constants (sinv, a, mean * sinv) are computed in
// its registers from scale, mean, var and eps: no PyTorch op prepares them.
// The ragged last folded row takes a scalar tail. A tensor whose pointers
// are not 16-byte aligned takes the same kernel at kVec = 1. At the end the
// block adds, for each channel, its threads' column sums in column order
// through shared memory and writes ONE partial per channel:
// partial[2][blocks][C].
// Pass 2: for 32 channels a block of 32 x 32 threads: each thread adds every
// 32nd partial in index order, a fixed-shape tree in shared memory adds the
// 32 results, and one thread per channel writes d_scale, d_bias, d_mean and
// d_var into out[4][C]. Every sum has one fixed order, so two runs agree bit
// for bit. No FMA contraction and no fast-math: rsqrtf and the separate
// roundings give the plain version's float32 values.

#include "bn_common.cuh"  // packs, plan_ok and the two stages of the sums

namespace {

constexpr int kUnroll = 2;  // rows in flight per thread (both kernels)

// --------------------------------------------------------------- forward ---

template <bool kResidual, bool kRelu>
__device__ __forceinline__ float fwd_element(float xv, float rv, float ac,
                                             float bc) {
  // separate roundings, no FMA: the order of the plain version
  float v = __fadd_rn(__fmul_rn(xv, ac), bc);
  if (kResidual) v = __fadd_rn(v, rv);
  if (kRelu) v = v < 0.0f ? 0.0f : v;  // NaN passes, as in torch.relu
  return v;
}

template <typename T, int kVec, bool kResidual, bool kRelu, typename IndexT>
__global__ void __launch_bounds__(kMaxThreads) bn_apply_relu_kernel(
    const T* __restrict__ x, const T* __restrict__ r,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ var, float eps,
    T* __restrict__ y, IndexT n, int C, int Wf, IndexT rows,
    int rows_per_chunk) {
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  if (j >= Wf) return;  // Wf % kVec == 0: all of a thread's columns or none
  float ac[kVec], bc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {  // fold_affine's order
    const int c = (j + k) % C;
    const float sinv = rsqrtf(__fadd_rn(var[c], eps));
    ac[k] = __fmul_rn(scale[c], sinv);
    bc[k] = __fsub_rn(bias[c], __fmul_rn(mean[c], ac[k]));
  }
  const IndexT r0 = static_cast<IndexT>(blockIdx.y) * rows_per_chunk;
  IndexT r1 = r0 + rows_per_chunk;
  if (r1 > rows) r1 = rows;
  // rows of which every column exists (all but a ragged last one)
  const IndexT full = n / static_cast<IndexT>(Wf);
  IndexT r1_full = r1 < full ? r1 : full;
  if (r1_full < r0) r1_full = r0;
  IndexT row = r0;
  for (; row + kUnroll <= r1_full; row += kUnroll) {
    float xv[kUnroll][kVec], rv[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const IndexT i = (row + u) * Wf + j;
      load_pack<T, kVec>(x + i, xv[u]);
      if (kResidual) load_pack<T, kVec>(r + i, rv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float yv[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        yv[k] = fwd_element<kResidual, kRelu>(
            xv[u][k], kResidual ? rv[u][k] : 0.0f, ac[k], bc[k]);
      store_pack<T, kVec>(y + (row + u) * Wf + j, yv);
    }
  }
  for (; row < r1_full; ++row) {  // a last whole row of an odd count
    const IndexT i = row * Wf + j;
    float xv[kVec], rv[kVec], yv[kVec];
    load_pack<T, kVec>(x + i, xv);
    if (kResidual) load_pack<T, kVec>(r + i, rv);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      yv[k] = fwd_element<kResidual, kRelu>(xv[k], kResidual ? rv[k] : 0.0f,
                                            ac[k], bc[k]);
    store_pack<T, kVec>(y + i, yv);
  }
  for (; row < r1; ++row) {  // the ragged last row, element by element
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const IndexT i = row * Wf + j + k;
      if (i >= n) break;
      store(y + i, fwd_element<kResidual, kRelu>(
                       load(x + i), kResidual ? load(r + i) : 0.0f, ac[k],
                       bc[k]));
    }
  }
}

template <typename T, int kVec, bool kResidual, bool kRelu>
void launch_fwd_typed(const void* x, const void* r, const float* scale,
                      const float* bias, const float* mean, const float* var,
                      float eps, void* y, long long n, int C, int Wf,
                      int threads, int col_tiles, int chunks,
                      int rows_per_chunk, cudaStream_t stream) {
  const dim3 grid(col_tiles, chunks);
  const long long rows = (n + Wf - 1) / Wf;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  T* yt = static_cast<T*>(y);
  if (n < (1LL << 31)) {
    bn_apply_relu_kernel<T, kVec, kResidual, kRelu, uint32_t>
        <<<grid, threads, 0, stream>>>(
            xt, rt, scale, bias, mean, var, eps, yt, static_cast<uint32_t>(n),
            C, Wf, static_cast<uint32_t>(rows), rows_per_chunk);
  } else {
    bn_apply_relu_kernel<T, kVec, kResidual, kRelu, uint64_t>
        <<<grid, threads, 0, stream>>>(
            xt, rt, scale, bias, mean, var, eps, yt, static_cast<uint64_t>(n),
            C, Wf, static_cast<uint64_t>(rows), rows_per_chunk);
  }
}

template <typename T, int kVec, typename... Args>
void launch_fwd_variant(bool residual, bool relu, Args... args) {
  if (residual) {
    if (relu) launch_fwd_typed<T, kVec, true, true>(args...);
    else      launch_fwd_typed<T, kVec, true, false>(args...);
  } else {
    if (relu) launch_fwd_typed<T, kVec, false, true>(args...);
    else      launch_fwd_typed<T, kVec, false, false>(args...);
  }
}

template <typename T>
int launch(const void* x, const void* r, const void* scale, const void* bias,
           const void* mean, const void* var, float eps, void* y, long long n,
           int C, int Wf, int vec, int threads, int col_tiles, int chunks,
           int rows_per_chunk, int relu, void* stream) {
  constexpr int kFull = 16 / static_cast<int>(sizeof(T));
  if (!plan_ok<T>(n, C, Wf, vec, threads, col_tiles, chunks, rows_per_chunk,
                  {x, r != nullptr ? r : x, static_cast<const void*>(y)}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* mn = static_cast<const float*>(mean);
  const float* vr = static_cast<const float*>(var);
  if (vec == 1)
    launch_fwd_variant<T, 1>(r != nullptr, relu != 0, x, r, sc, bi, mn, vr,
                             eps, y, n, C, Wf, threads, col_tiles, chunks,
                             rows_per_chunk, s);
  else
    launch_fwd_variant<T, kFull>(r != nullptr, relu != 0, x, r, sc, bi, mn,
                                 vr, eps, y, n, C, Wf, threads, col_tiles,
                                 chunks, rows_per_chunk, s);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- backward ---

// one element: g, dx, the two sums (the order of the plain version)
template <bool kRelu>
__device__ __forceinline__ float bwd_element(float xv, float yv, float dyv,
                                             float ac, float sc, float mc,
                                             float* dxv, float* s1,
                                             float* s2) {
  float g = dyv;
  // a product, as bn_pallas.py:97: a NaN in dy stays a NaN under the mask
  if (kRelu) g = __fmul_rn(g, yv > 0.0f ? 1.0f : 0.0f);
  const float xh = __fsub_rn(__fmul_rn(xv, sc), mc);
  *dxv = __fmul_rn(g, ac);
  *s1 = __fadd_rn(*s1, g);
  *s2 = __fadd_rn(*s2, __fmul_rn(g, xh));
  return g;
}

template <typename T, int kVec, bool kRelu, bool kWantG, typename IndexT>
__global__ void __launch_bounds__(kMaxThreads) bn_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ dy, const float* __restrict__ scale,
    const float* __restrict__ mean, const float* __restrict__ var, float eps,
    T* __restrict__ dx, T* __restrict__ g_out, float* __restrict__ partial,
    IndexT n, int C, int Wf, IndexT rows, int rows_per_chunk) {
  extern __shared__ float sh[];  // [2][blockDim.x * kVec] column sums
  const int width = blockDim.x * kVec;          // columns per block
  const int j_lo = blockIdx.x * width;          // the block's first column
  const int j = j_lo + threadIdx.x * kVec;      // the thread's first column
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) s1[k] = s2[k] = 0.0f;
  if (j < Wf) {  // Wf % kVec == 0: a thread's columns are all in or all out
    float ac[kVec], sc[kVec], mc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int c = (j + k) % C;
      sc[k] = rsqrtf(__fadd_rn(var[c], eps));
      ac[k] = __fmul_rn(scale[c], sc[k]);
      mc[k] = __fmul_rn(mean[c], sc[k]);
    }
    const IndexT r0 = static_cast<IndexT>(blockIdx.y) * rows_per_chunk;
    IndexT r1 = r0 + rows_per_chunk;
    if (r1 > rows) r1 = rows;
    // rows of which every column exists (all but a ragged last one)
    const IndexT full = n / static_cast<IndexT>(Wf);
    IndexT r1_full = r1 < full ? r1 : full;
    if (r1_full < r0) r1_full = r0;
    IndexT r = r0;
    for (; r + kUnroll <= r1_full; r += kUnroll) {
      float xv[kUnroll][kVec], yv[kUnroll][kVec], dv[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const IndexT i = (r + u) * Wf + j;
        load_pack<T, kVec>(x + i, xv[u]);
        load_pack<T, kVec>(dy + i, dv[u]);
        if (kRelu) load_pack<T, kVec>(y + i, yv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const IndexT i = (r + u) * Wf + j;
        float dxv[kVec], gv[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          gv[k] = bwd_element<kRelu>(xv[u][k], kRelu ? yv[u][k] : 0.0f,
                                     dv[u][k], ac[k], sc[k], mc[k], &dxv[k],
                                     &s1[k], &s2[k]);
        store_pack<T, kVec>(dx + i, dxv);
        if (kWantG) store_pack<T, kVec>(g_out + i, gv);
      }
    }
    for (; r < r1; ++r) {  // the rows left over, and the ragged last row
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const IndexT i = r * Wf + j + k;
        if (i >= n) break;
        float dxv;
        const float g = bwd_element<kRelu>(
            load(x + i), kRelu ? load(y + i) : 0.0f, load(dy + i), ac[k],
            sc[k], mc[k], &dxv, &s1[k], &s2[k]);
        store(dx + i, dxv);
        if (kWantG) store(g_out + i, g);
      }
    }
  }
  write_block_partials<kVec>(sh, s1, s2, C, Wf, partial);
}

// S[which][c] = sum over blocks of partial[which][block][c], then the four
// per-channel gradients into out[4][C]
__global__ void bn_bwd_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ var, float eps,
                                     float* __restrict__ out, int C,
                                     int blocks) {
  __shared__ float sh[2][kRedRows][kRedLanes + 1];
  sum_block_partials(partial, C, blocks, sh);
  const int c = blockIdx.x * kRedLanes + threadIdx.x;
  if (threadIdx.y == 0 && c < C) {
    const float s1 = sh[0][0][threadIdx.x], s2 = sh[1][0][threadIdx.x];
    const float sinv = rsqrtf(__fadd_rn(var[c], eps));
    const float a = __fmul_rn(scale[c], sinv);
    out[c] = s2;                                  // d_scale
    out[C + c] = s1;                              // d_bias
    out[2 * C + c] = __fmul_rn(-a, s1);           // d_mean
    out[3 * C + c] = __fmul_rn(                   // d_var, left to right
        __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, scale[c]), sinv), sinv), s2);
  }
}

template <typename T, int kVec, bool kRelu, bool kWantG>
void launch_bwd_pass1(const void* x, const void* y, const void* dy,
                      const float* scale, const float* mean, const float* var,
                      float eps, void* dx, void* g, float* partial,
                      long long n, int C, int Wf, int threads, int col_tiles,
                      int chunks, int rows_per_chunk, cudaStream_t stream) {
  const dim3 grid(col_tiles, chunks);
  const size_t smem = 2 * sizeof(float) * threads * kVec;
  const long long rows = (n + Wf - 1) / Wf;
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  T* gt = static_cast<T*>(g);
  if (n < (1LL << 31)) {
    bn_bwd_kernel<T, kVec, kRelu, kWantG, uint32_t>
        <<<grid, threads, smem, stream>>>(
            xt, yt, dyt, scale, mean, var, eps, dxt, gt, partial,
            static_cast<uint32_t>(n), C, Wf, static_cast<uint32_t>(rows),
            rows_per_chunk);
  } else {
    bn_bwd_kernel<T, kVec, kRelu, kWantG, uint64_t>
        <<<grid, threads, smem, stream>>>(
            xt, yt, dyt, scale, mean, var, eps, dxt, gt, partial,
            static_cast<uint64_t>(n), C, Wf, static_cast<uint64_t>(rows),
            rows_per_chunk);
  }
}

template <typename T, int kVec, typename... Args>
void launch_bwd_variant(bool relu, bool want_g, Args... args) {
  if (relu) {
    if (want_g) launch_bwd_pass1<T, kVec, true, true>(args...);
    else        launch_bwd_pass1<T, kVec, true, false>(args...);
  } else {
    if (want_g) launch_bwd_pass1<T, kVec, false, true>(args...);
    else        launch_bwd_pass1<T, kVec, false, false>(args...);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* y, const void* dy,
               const void* scale, const void* mean, const void* var,
               float eps, void* dx, void* g, void* partial, void* out,
               long long n, int C, int Wf, int vec, int threads,
               int col_tiles, int chunks, int rows_per_chunk, int relu,
               int passes, void* stream) {
  constexpr int kFull = 16 / static_cast<int>(sizeof(T));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* mn = static_cast<const float*>(mean);
  const float* vr = static_cast<const float*>(var);
  float* pt = static_cast<float*>(partial);
  // refuse a plan that is not this source's or that the pointers do not fit
  if (!plan_ok<T>(n, C, Wf, vec, threads, col_tiles, chunks, rows_per_chunk,
                  {x, dy, static_cast<const void*>(dx), relu ? y : x,
                   g != nullptr ? g : x}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (passes & 1) {
    if (vec == 1)
      launch_bwd_variant<T, 1>(relu != 0, g != nullptr, x, y, dy, sc, mn, vr,
                               eps, dx, g, pt, n, C, Wf, threads, col_tiles,
                               chunks, rows_per_chunk, s);
    else
      launch_bwd_variant<T, kFull>(relu != 0, g != nullptr, x, y, dy, sc, mn,
                                   vr, eps, dx, g, pt, n, C, Wf, threads,
                                   col_tiles, chunks, rows_per_chunk, s);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (passes & 2) {
    bn_bwd_reduce_kernel<<<(C + kRedLanes - 1) / kRedLanes,
                           dim3(kRedLanes, kRedRows), 0, s>>>(
        pt, sc, vr, eps, static_cast<float*>(out), C, col_tiles * chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward on `stream`; `r` may be NULL (no residual). The caller checks that
// x, r and y are contiguous with C innermost, that scale, bias, mean and var
// are float32 [C], and that n > 0. The plan (ops/bn_cuda.fwd_plan) is
// checked here as the backward's is (plan_ok; with vec > 1 x, r and y must be
// 16-byte aligned). Returns cudaErrorInvalidValue for a plan that fails,
// else cudaGetLastError() (0 = launched).
extern "C" int zsvc_bn_apply_relu_f32(const void* x, const void* r,
                                      const void* scale, const void* bias,
                                      const void* mean, const void* var,
                                      float eps, void* y, long long n, int C,
                                      int Wf, int vec, int threads,
                                      int col_tiles, int chunks,
                                      int rows_per_chunk, int relu,
                                      void* stream) {
  return launch<float>(x, r, scale, bias, mean, var, eps, y, n, C, Wf, vec,
                       threads, col_tiles, chunks, rows_per_chunk, relu,
                       stream);
}

extern "C" int zsvc_bn_apply_relu_bf16(const void* x, const void* r,
                                       const void* scale, const void* bias,
                                       const void* mean, const void* var,
                                       float eps, void* y, long long n, int C,
                                       int Wf, int vec, int threads,
                                       int col_tiles, int chunks,
                                       int rows_per_chunk, int relu,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, r, scale, bias, mean, var, eps, y, n, C,
                               Wf, vec, threads, col_tiles, chunks,
                               rows_per_chunk, relu, stream);
}

// Backward on `stream`: pass 1 (passes & 1) and pass 2 (passes & 2); a call
// of the op takes both (3), the separate bits exist to time them. `y` is read
// only when relu != 0; `g` may be NULL (no d_residual wanted). The caller
// checks that x, y, dy, dx and g are contiguous with C innermost and that
// scale, mean and var are float32 [C], and allocates partial float32
// [2][col_tiles * chunks][C] and out float32 [4][C] (d_scale, d_bias,
// d_mean, d_var). The plan (ops/bn_cuda.bwd_plan) is checked here: Wf a
// multiple of C and of vec, vec 1 or the 16-byte width (8 bf16, 4 float32;
// then x, y, dy, dx and g must be 16-byte aligned), col_tiles blocks of
// `threads` (a multiple of 32, at most 512) threads cover Wf / vec, chunks *
// rows_per_chunk cover ceil(n / Wf) rows with chunks <= 65535 (plan_ok). Returns
// cudaErrorInvalidValue for a plan that fails, else cudaGetLastError() of
// the first launch that failed (0 = launched).
extern "C" int zsvc_bn_bwd_f32(const void* x, const void* y, const void* dy,
                               const void* scale, const void* mean,
                               const void* var, float eps, void* dx, void* g,
                               void* partial, void* out, long long n, int C,
                               int Wf, int vec, int threads, int col_tiles,
                               int chunks, int rows_per_chunk, int relu,
                               int passes, void* stream) {
  return launch_bwd<float>(x, y, dy, scale, mean, var, eps, dx, g, partial,
                           out, n, C, Wf, vec, threads, col_tiles, chunks,
                           rows_per_chunk, relu, passes, stream);
}

extern "C" int zsvc_bn_bwd_bf16(const void* x, const void* y, const void* dy,
                                const void* scale, const void* mean,
                                const void* var, float eps, void* dx, void* g,
                                void* partial, void* out, long long n, int C,
                                int Wf, int vec, int threads, int col_tiles,
                                int chunks, int rows_per_chunk, int relu,
                                int passes, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, y, dy, scale, mean, var, eps, dx, g,
                                   partial, out, n, C, Wf, vec, threads,
                                   col_tiles, chunks, rows_per_chunk, relu,
                                   passes, stream);
}
