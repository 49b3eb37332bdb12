// The BN statistics' sums on Hopper (sm_90a), forward and gradient: the op
// ops/bn_stats.bn_sums that models/layers.bn_statistics takes in train mode.
//
//   S[c] = sum (x - m0[c])      Q[c] = sum (x - m0[c])^2       (float32)
//   dx = dS[c] + (x - m0[c]) * (2 * dQ[c])       (float32, one rounding to
//                                                 x's dtype)
//
// over every row of a contiguous [..., C] tensor; x bf16 or float32, m0
// float32 [C] (the running mean: the shift keeps E[s^2] - E[s]^2 from
// cancelling on activations with a large offset).
//
// It replaces no TPU kernel: the JAX package leaves these statistics to XLA
// (zeroshotvideoclassification_tpu/models/layers.py:bn_statistics), which
// fuses both sums into one read of x. In plain PyTorch they were a chain of
// full-size float32 ops, forward and backward, with s = x - m0 saved for the
// backward.
//
// Bound: bytes. The sums read x once (4 flops an element); the gradient
// reads x and writes dx (3 flops an element). Both take K2's folded
// [rows, Wf] view (Wf = m * C, ops/bn_cuda._fold picks m so that Wf is a
// multiple of the vector width and fills whole warps) with 16-byte accesses:
// a thread owns kVec CONSECUTIVE columns (8 bf16 or 4 float32; 1 where x is
// not 16-byte aligned) and its channels' constants sit in its registers.
//
// SUMS. Stage 1 (bn_sums_kernel, on K2 backward's plan: at most 264 blocks):
// a thread walks its chunk of rows four at a time (one stream to read, so
// more rows in flight than K2 keeps) and accumulates s and s * s of each of
// its columns in registers, in row order, in runs of 64 rows whose sums then
// join the thread's (a chunk holds up to thousands of rows: float32's error
// grows with the length of a chain of adds); the block folds its columns
// into one partial per channel (bn_common.cuh). Stage 2
// (bn_sums_reduce_kernel): the partials added in a fixed order into
// out[0][C] (S) and out[1][C] (Q), and m0 copied into out[2][C]: the
// backward's m0, since the caller moves its running mean in place before
// the backward runs. No atomics, so two runs agree bit for bit; no float32
// copy of x is written.
//
// GRADIENT (bn_sums_grad_kernel, on K2 forward's plan: enough blocks to fill
// the card several times over): a thread walks its chunk two rows at a
// time, per row one 16-byte load of x and one 16-byte store of dx. Separate
// roundings, no FMA contraction: the plain version's
// (ops/bn_stats.bn_sums_grad_plain) values bit for bit.
//
// MOMENTS (bn_moments_kernel, bn_moments_grad_kernel): the [C]-sized rest of
// the statistics, one thread a channel, from the sums and the count n (both
// summed over the data group in between, where there is one; n is read from
// the device, so the host never waits for it):
//
//   s_mean = S / n   s_sq = Q / n   mean = s_mean + m0   d = s_sq - s_mean^2
//   var = max(d, 0)   new_mean = (1 - momentum) * m0 + momentum * mean
//   new_var = (1 - momentum) * running_var + momentum * var * n / (n - 1)
//
// and their gradient, dS = (dmean - 2 * dd * s_mean) / n, dQ = dd / n with
// dd = dvar where d >= 0, else 0. Bound by the host: as a dozen PyTorch ops
// forward and eight autograd nodes backward a layer they cost the host more
// than the device spends in the sums at the train step's 64 clips. Each op
// rounds where the plain version's PyTorch ops round (ops/bn_stats.
// bn_moments_plain, bn_moments_grad_plain), so the results are theirs bit
// for bit.

#include "bn_common.cuh"

namespace {

constexpr int kSumRows = 4;   // sums: rows in flight per thread ...
constexpr int kRun = 64;      // ... and rows summed apart before they join
                              // the thread's sums: a chain of at most
                              // kRun + rows / kRun float32 adds, not rows
constexpr int kGradRows = 2;  // gradient: rows in flight per thread

// one element into a thread's two sums
__device__ __forceinline__ void sums_element(float xv, float mc, float* s1,
                                             float* s2) {
  const float s = __fsub_rn(xv, mc);
  *s1 = __fadd_rn(*s1, s);
  *s2 = __fadd_rn(*s2, __fmul_rn(s, s));
}

template <typename T, int kVec, typename IndexT>
__global__ void __launch_bounds__(kMaxThreads) bn_sums_kernel(
    const T* __restrict__ x, const float* __restrict__ m0,
    float* __restrict__ partial, IndexT n, int C, int Wf, IndexT rows,
    int rows_per_chunk) {
  extern __shared__ float sh[];  // [2][blockDim.x * kVec] column sums
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) s1[k] = s2[k] = 0.0f;
  if (j < Wf) {  // Wf % kVec == 0: a thread's columns are all in or all out
    float mc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) mc[k] = m0[(j + k) % C];
    const IndexT r0 = static_cast<IndexT>(blockIdx.y) * rows_per_chunk;
    IndexT r1 = r0 + rows_per_chunk;
    if (r1 > rows) r1 = rows;
    // rows of which every column exists (all but a ragged last one)
    const IndexT full = n / static_cast<IndexT>(Wf);
    IndexT r1_full = r1 < full ? r1 : full;
    if (r1_full < r0) r1_full = r0;
    IndexT r = r0;
    while (r < r1_full) {  // the whole rows, a run of kRun at a time
      const IndexT r_end = r1_full - r > kRun ? r + kRun : r1_full;
      float t1[kVec], t2[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) t1[k] = t2[k] = 0.0f;
      for (; r + kSumRows <= r_end; r += kSumRows) {
        float xv[kSumRows][kVec];
#pragma unroll
        for (int u = 0; u < kSumRows; ++u)
          load_pack<T, kVec>(x + (r + u) * Wf + j, xv[u]);
#pragma unroll
        for (int u = 0; u < kSumRows; ++u) {
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            sums_element(xv[u][k], mc[k], &t1[k], &t2[k]);
        }
      }
      for (; r < r_end; ++r) {  // the last run's rows left over
        float xv[kVec];
        load_pack<T, kVec>(x + r * Wf + j, xv);
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          sums_element(xv[k], mc[k], &t1[k], &t2[k]);
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        s1[k] = __fadd_rn(s1[k], t1[k]);
        s2[k] = __fadd_rn(s2[k], t2[k]);
      }
    }
    for (; r < r1; ++r) {  // the ragged last row, element by element
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const IndexT i = r * Wf + j + k;
        if (i >= n) break;
        sums_element(load(x + i), mc[k], &s1[k], &s2[k]);
      }
    }
  }
  write_block_partials<kVec>(sh, s1, s2, C, Wf, partial);
}

// out[0..1][c] = the partials' sums, out[2][c] = m0[c]
__global__ void bn_sums_reduce_kernel(const float* __restrict__ partial,
                                      const float* __restrict__ m0,
                                      float* __restrict__ out, int C,
                                      int blocks) {
  __shared__ float sh[2][kRedRows][kRedLanes + 1];
  sum_block_partials(partial, C, blocks, sh);
  const int c = blockIdx.x * kRedLanes + threadIdx.x;
  if (threadIdx.y == 0 && c < C) {
    out[c] = sh[0][0][threadIdx.x];
    out[C + c] = sh[1][0][threadIdx.x];
    out[2 * C + c] = m0[c];
  }
}

// one element of the gradient, in the plain version's order
__device__ __forceinline__ float grad_element(float xv, float mc, float ds,
                                              float dq2) {
  return __fadd_rn(ds, __fmul_rn(__fsub_rn(xv, mc), dq2));
}

template <typename T, int kVec, typename IndexT>
__global__ void __launch_bounds__(kMaxThreads) bn_sums_grad_kernel(
    const T* __restrict__ x, const float* __restrict__ m0,
    const float* __restrict__ dsums, T* __restrict__ dx, IndexT n, int C,
    int Wf, IndexT rows, int rows_per_chunk) {
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  if (j >= Wf) return;  // Wf % kVec == 0: all of a thread's columns or none
  float mc[kVec], ds[kVec], dq2[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int c = (j + k) % C;
    mc[k] = m0[c];
    ds[k] = dsums[c];
    dq2[k] = __fmul_rn(2.0f, dsums[C + c]);  // exact
  }
  const IndexT r0 = static_cast<IndexT>(blockIdx.y) * rows_per_chunk;
  IndexT r1 = r0 + rows_per_chunk;
  if (r1 > rows) r1 = rows;
  const IndexT full = n / static_cast<IndexT>(Wf);
  IndexT r1_full = r1 < full ? r1 : full;
  if (r1_full < r0) r1_full = r0;
  IndexT r = r0;
  for (; r + kGradRows <= r1_full; r += kGradRows) {
    float xv[kGradRows][kVec];
#pragma unroll
    for (int u = 0; u < kGradRows; ++u)
      load_pack<T, kVec>(x + (r + u) * Wf + j, xv[u]);
#pragma unroll
    for (int u = 0; u < kGradRows; ++u) {
      float dv[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        dv[k] = grad_element(xv[u][k], mc[k], ds[k], dq2[k]);
      store_pack<T, kVec>(dx + (r + u) * Wf + j, dv);
    }
  }
  for (; r < r1_full; ++r) {  // a last whole row of an odd count
    float xv[kVec], dv[kVec];
    load_pack<T, kVec>(x + r * Wf + j, xv);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      dv[k] = grad_element(xv[k], mc[k], ds[k], dq2[k]);
    store_pack<T, kVec>(dx + r * Wf + j, dv);
  }
  for (; r < r1; ++r) {  // the ragged last row, element by element
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const IndexT i = r * Wf + j + k;
      if (i >= n) break;
      store(dx + i, grad_element(load(x + i), mc[k], ds[k], dq2[k]));
    }
  }
}

constexpr int kMomentThreads = 128;  // moments: threads a block

// out[6][C]: mean, var, new_mean, new_var, then s_mean and d for the
// backward; keep = 1 - momentum as float32, the unbiased factor
// n / max(n - 1, 1) in float32 as the plain version's tensors compute it
__global__ void bn_moments_kernel(const float* __restrict__ sums,
                                  const float* __restrict__ count,
                                  const float* __restrict__ m0,
                                  const float* __restrict__ running_var,
                                  float keep, float momentum,
                                  float* __restrict__ out, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float n = *count;
  const float factor = __fdiv_rn(n, fmaxf(__fsub_rn(n, 1.0f), 1.0f));
  const float s_mean = __fdiv_rn(sums[c], n);
  const float s_sq = __fdiv_rn(sums[C + c], n);
  const float mean = __fadd_rn(s_mean, m0[c]);
  const float d = __fsub_rn(s_sq, __fmul_rn(s_mean, s_mean));
  const float var = d < 0.0f ? 0.0f : d;  // NaN passes, as torch.clamp_min's
  out[c] = mean;
  out[C + c] = var;
  out[2 * C + c] =
      __fadd_rn(__fmul_rn(keep, m0[c]), __fmul_rn(momentum, mean));
  out[3 * C + c] = __fadd_rn(__fmul_rn(keep, running_var[c]),
                             __fmul_rn(momentum, __fmul_rn(var, factor)));
  out[4 * C + c] = s_mean;
  out[5 * C + c] = d;
}

// dsums[2][C] from dmean, dvar and saved[2][C] (s_mean, d): the order of
// autograd's nodes for the plain version's ops
__global__ void bn_moments_grad_kernel(const float* __restrict__ dmean,
                                       const float* __restrict__ dvar,
                                       const float* __restrict__ saved,
                                       const float* __restrict__ count,
                                       float* __restrict__ dsums, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float n = *count;
  const float dd = saved[C + c] >= 0.0f ? dvar[c] : 0.0f;  // clamp_min's
  const float g = __fmul_rn(-dd, saved[c]);  // each factor of s_mean^2
  dsums[c] = __fdiv_rn(__fadd_rn(dmean[c], __fadd_rn(g, g)), n);
  dsums[C + c] = __fdiv_rn(dd, n);
}

template <typename T, int kVec>
void launch_sums_pass1(const void* x, const float* m0, float* partial,
                       long long n, int C, int Wf, int threads, int col_tiles,
                       int chunks, int rows_per_chunk, cudaStream_t stream) {
  const dim3 grid(col_tiles, chunks);
  const size_t smem = 2 * sizeof(float) * threads * kVec;
  const long long rows = (n + Wf - 1) / Wf;
  const T* xt = static_cast<const T*>(x);
  if (n < (1LL << 31)) {
    bn_sums_kernel<T, kVec, uint32_t><<<grid, threads, smem, stream>>>(
        xt, m0, partial, static_cast<uint32_t>(n), C, Wf,
        static_cast<uint32_t>(rows), rows_per_chunk);
  } else {
    bn_sums_kernel<T, kVec, uint64_t><<<grid, threads, smem, stream>>>(
        xt, m0, partial, static_cast<uint64_t>(n), C, Wf,
        static_cast<uint64_t>(rows), rows_per_chunk);
  }
}

template <typename T>
int launch_sums(const void* x, const void* m0, void* partial, void* out,
                long long n, int C, int Wf, int vec, int threads,
                int col_tiles, int chunks, int rows_per_chunk, void* stream) {
  constexpr int kFull = 16 / static_cast<int>(sizeof(T));
  if (!plan_ok<T>(n, C, Wf, vec, threads, col_tiles, chunks, rows_per_chunk,
                  {x}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mc = static_cast<const float*>(m0);
  float* pt = static_cast<float*>(partial);
  if (vec == 1)
    launch_sums_pass1<T, 1>(x, mc, pt, n, C, Wf, threads, col_tiles, chunks,
                            rows_per_chunk, s);
  else
    launch_sums_pass1<T, kFull>(x, mc, pt, n, C, Wf, threads, col_tiles,
                                chunks, rows_per_chunk, s);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bn_sums_reduce_kernel<<<(C + kRedLanes - 1) / kRedLanes,
                          dim3(kRedLanes, kRedRows), 0, s>>>(
      pt, mc, static_cast<float*>(out), C, col_tiles * chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec>
void launch_grad_typed(const void* x, const float* m0, const float* dsums,
                       void* dx, long long n, int C, int Wf, int threads,
                       int col_tiles, int chunks, int rows_per_chunk,
                       cudaStream_t stream) {
  const dim3 grid(col_tiles, chunks);
  const long long rows = (n + Wf - 1) / Wf;
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  if (n < (1LL << 31)) {
    bn_sums_grad_kernel<T, kVec, uint32_t><<<grid, threads, 0, stream>>>(
        xt, m0, dsums, dxt, static_cast<uint32_t>(n), C, Wf,
        static_cast<uint32_t>(rows), rows_per_chunk);
  } else {
    bn_sums_grad_kernel<T, kVec, uint64_t><<<grid, threads, 0, stream>>>(
        xt, m0, dsums, dxt, static_cast<uint64_t>(n), C, Wf,
        static_cast<uint64_t>(rows), rows_per_chunk);
  }
}

template <typename T>
int launch_grad(const void* x, const void* m0, const void* dsums, void* dx,
                long long n, int C, int Wf, int vec, int threads,
                int col_tiles, int chunks, int rows_per_chunk, void* stream) {
  constexpr int kFull = 16 / static_cast<int>(sizeof(T));
  if (!plan_ok<T>(n, C, Wf, vec, threads, col_tiles, chunks, rows_per_chunk,
                  {x, static_cast<const void*>(dx)}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mc = static_cast<const float*>(m0);
  const float* dsc = static_cast<const float*>(dsums);
  if (vec == 1)
    launch_grad_typed<T, 1>(x, mc, dsc, dx, n, C, Wf, threads, col_tiles,
                            chunks, rows_per_chunk, s);
  else
    launch_grad_typed<T, kFull>(x, mc, dsc, dx, n, C, Wf, threads, col_tiles,
                                chunks, rows_per_chunk, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The sums on `stream`: stage 1 into `partial` (float32
// [2][col_tiles * chunks][C]), stage 2 into `out` (float32 [3][C]: S, Q and
// a copy of m0). The caller checks that x is contiguous with C innermost,
// that m0 is float32 [C] and that n > 0; the plan (ops/bn_cuda.bwd_plan) is
// checked here (plan_ok; with vec > 1 x must be 16-byte aligned). Returns
// cudaErrorInvalidValue for a plan that fails, else cudaGetLastError() of
// the first launch that failed (0 = launched).
extern "C" int zsvc_bn_sums_f32(const void* x, const void* m0, void* partial,
                                void* out, long long n, int C, int Wf,
                                int vec, int threads, int col_tiles,
                                int chunks, int rows_per_chunk,
                                void* stream) {
  return launch_sums<float>(x, m0, partial, out, n, C, Wf, vec, threads,
                            col_tiles, chunks, rows_per_chunk, stream);
}

extern "C" int zsvc_bn_sums_bf16(const void* x, const void* m0,
                                 void* partial, void* out, long long n,
                                 int C, int Wf, int vec, int threads,
                                 int col_tiles, int chunks,
                                 int rows_per_chunk, void* stream) {
  return launch_sums<__nv_bfloat16>(x, m0, partial, out, n, C, Wf, vec,
                                    threads, col_tiles, chunks,
                                    rows_per_chunk, stream);
}

// The gradient on `stream`: dx (x's dtype and layout) from x, m0 and dsums
// (float32 [2][C]: dS, dQ). The caller checks that x and dx are contiguous
// with C innermost, that m0 is float32 [C] and dsums float32 [2][C], and
// that n > 0; the plan (ops/bn_cuda.fwd_plan) is checked here (with vec > 1
// x and dx must be 16-byte aligned). Returns cudaErrorInvalidValue for a
// plan that fails, else cudaGetLastError() (0 = launched).
extern "C" int zsvc_bn_sums_grad_f32(const void* x, const void* m0,
                                     const void* dsums, void* dx,
                                     long long n, int C, int Wf, int vec,
                                     int threads, int col_tiles, int chunks,
                                     int rows_per_chunk, void* stream) {
  return launch_grad<float>(x, m0, dsums, dx, n, C, Wf, vec, threads,
                            col_tiles, chunks, rows_per_chunk, stream);
}

extern "C" int zsvc_bn_sums_grad_bf16(const void* x, const void* m0,
                                      const void* dsums, void* dx,
                                      long long n, int C, int Wf, int vec,
                                      int threads, int col_tiles, int chunks,
                                      int rows_per_chunk, void* stream) {
  return launch_grad<__nv_bfloat16>(x, m0, dsums, dx, n, C, Wf, vec, threads,
                                    col_tiles, chunks, rows_per_chunk,
                                    stream);
}

// The moments on `stream`: out (float32 [6][C]) from sums (float32 [2][C]),
// count (float32 [1]: the rows' count), m0 and running_var (float32 [C]);
// keep 1 - momentum. The caller checks the operands. Returns
// cudaGetLastError() (0 = launched).
extern "C" int zsvc_bn_moments(const void* sums, const void* count,
                               const void* m0, const void* running_var,
                               float keep, float momentum, void* out, int C,
                               void* stream) {
  bn_moments_kernel<<<(C + kMomentThreads - 1) / kMomentThreads,
                      kMomentThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sums), static_cast<const float*>(count),
      static_cast<const float*>(m0), static_cast<const float*>(running_var),
      keep, momentum, static_cast<float*>(out), C);
  return static_cast<int>(cudaGetLastError());
}

// The moments' gradient on `stream`: dsums (float32 [2][C]) from dmean and
// dvar (float32 [C]), the forward's saved rows (float32 [2][C]: s_mean, d)
// and count (float32 [1]). The caller checks the operands. Returns
// cudaGetLastError().
extern "C" int zsvc_bn_moments_grad(const void* dmean, const void* dvar,
                                    const void* saved, const void* count,
                                    void* dsums, int C, void* stream) {
  bn_moments_grad_kernel<<<(C + kMomentThreads - 1) / kMomentThreads,
                           kMomentThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dmean), static_cast<const float*>(dvar),
      static_cast<const float*>(saved), static_cast<const float*>(count),
      static_cast<float*>(dsums), C);
  return static_cast<int>(cudaGetLastError());
}
