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
// the port's channels-last-3d); W is [3, Ci, Co]. Any Ci, Co and row count;
// offsets are 64-bit; no padded copy of x is made.
//
// Bound: at the layer1 shape ([16,16,56*56,144] -> 64, bf16) the bytes (231
// MB read, 103 MB written) take 0.10 ms at 3.35 TB/s and the 44.4 GFLOP half
// of that on the bf16 tensor cores: the card's bound is bytes, and a design
// has to (a) multiply on the tensor cores and (b) fetch x from device
// memory once, not once per tap.
//
// BF16: tensor cores (wgmma.mma_async m64n64k16, float32 accumulators in
// registers, both operands read from shared memory through descriptors).
// Operands lie in shared memory as the 128-byte-swizzled K-major layout
// wgmma reads without bank conflicts: slabs of 64 input channels, a row of
// 128 bytes per output row (A) or output channel (B), the 16-byte chunk c
// of row r stored at chunk c ^ (r % 8). A small first kernel lays W out as
// wt[3][Co_pad][Ci_pad] (K-major, zero-padded), so that the main kernels
// copy it with aligned 16-byte cp.async whatever Ci and Co are. How x
// reaches that layout depends on Ci and on x's alignment (the wrapper's
// plan says which, this file checks it):
//
//   tma         Ci % 8 == 0 and x 16-byte aligned: a 3-D tensor map over
//               (Ci, P, N * T); one thread asks for a tile (a box of 64
//               channels x the block's positions per slab), the hardware
//               swizzles, fills channels >= Ci and positions >= P with
//               zeros and counts the bytes into an mbarrier. No thread
//               computes an address; the loads of the next frames or
//               stages run while the warps multiply. (The streamed kernel
//               fetches its W slabs the same way, from a 2-D map of wt.)
//   bulk4/bulk2 Ci % 8 != 0 (230; 45) in the resident kernel, where a
//               tile's rows are one 16-byte-aligned run of x of a multiple
//               of 16 bytes (64 * 230 * 2; true of the network's shapes):
//               one thread asks for those bytes as they lie in x
//               (cp.async.bulk into a staging area, an mbarrier counting),
//               and the threads move them into the swizzled slabs 4 (Ci
//               even) or 2 bytes at a time inside shared memory, one frame
//               ahead of the wgmmas. Narrow copies from device memory are
//               the alternative and ten times slower:
//   cp.async4   Ci even, x 4-byte aligned (460 in the streamed kernel; any
//               view that is not 16-byte aligned): 4 bytes a copy, about
//               one pair of channels a clock on an SM
//   scalar      otherwise (921): 2-byte loads through registers, 8 in
//               flight a thread
//
// Columns between Ci and the depth the wgmmas read are zero-filled in
// shared memory by every path. Two main kernels, chosen by
// ops/temporal_conv.tile_plan and checked here; in both a block's rows are
// positions of ONE frame, so a tap whose frame t + dt - 1 lies outside
// [0, T) is simply skipped: the SAME padding needs no predicate and no
// zeros.
//
//   resident  (W for one 64-channel tile and a ring of 4-6 x tiles fit in
//             the 227 KB of a block: Ci <= 256 or so) A block fixes a
//             sample n and 64 or 128 positions p, keeps all of W[.., co
//             tile] in shared memory and WALKS t in order: the x tile of
//             frame t is tap 2 of output t-1, tap 1 of t and tap 0 of t+1,
//             so each x element is read from device memory once per
//             64-channel tile of Co (once in all at layer1). The tiles of
//             frames t+2 .. t+ring-2 are in flight while frame t is
//             multiplied.
//   streamed  (everything else: Ci 288 .. 1152) A block owns 128 positions
//             of one frame (n, t) by 64 channels and runs the reduction
//             over its taps and Ci as a 4-stage ring of [128 x 64] x slabs
//             and [64 x 64] W slabs. These tensors are small (x of
//             layer3/4 fits the L2 cache), the taps' re-reads are served
//             there.
//
// Three things the card forced beyond that (measured with
// tools/profile_k3.py, which times the kernel with parts taken out):
// (1) The tensor cores add into their accumulator with truncation, so a
// sum of 3 * Ci products drifts from the float32 sum of the plain version
// by more than the op's bar allows where an output cancels: a wgmma chain
// runs over at most 10 steps of 16 channels from a zero accumulator, and
// the chains' results are added in registers with round-to-nearest adds;
// two accumulators take turns so that one chain runs while the other is
// added. (2) The accumulator fragment of a lane holds columns 8j + 2q + e
// (q = lane % 4) of rows lane / 4 and lane / 4 + 8; W's rows are placed in
// shared memory permuted so that those columns are the 16 CONSECUTIVE
// channels 16q + 2j + e. Stored straight from there, an instruction would
// still touch 8 rows and half of each 128-byte line, which runs at a fifth
// of the memory rate: a warp passes its rows through 512 bytes of shared
// memory and stores whole lines (store_tile). (3) 16-byte cp.async copies
// of a tile stall the four warps of a block while they start them (1.9 TB/s
// at best), 4-byte ones far more: hence TMA and the bulk copy.
//
// FLOAT32 keeps full float32 products (no TF32: the bar is 1e-5): the
// register-tiled CUDA-core GEMM below (128 x 64 tiles, 16 channels a
// step), level with cuDNN's float32 kernel and held by the 67 TFLOP/s of
// the CUDA cores (0.66 ms at layer1).

#include <cstdint>
#include <cstring>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------- float32 ---

constexpr int kTileRows = 128;  // output rows (n, t, p) per block
constexpr int kTileCo = 64;     // output channels per block
constexpr int kTileCi = 16;     // input channels per staging step
constexpr int kThreads = 256;   // 16 x 16 threads, an 8 x 4 patch each
constexpr int kPatchRows = 8;
constexpr int kPatchCo = 4;
constexpr int kPad = 4;  // keeps As rows 16-byte aligned, spreads the banks

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// ------------------------------------------------------------------- bf16 ---

typedef __nv_bfloat16 bf16;

constexpr int kBN = 64;              // output channels per block (wgmma n64)
constexpr int kSlab = 64;            // input channels per 128-byte smem row
constexpr int kWSlabBytes = kBN * 128;
constexpr int kMaxSmem = 232448;     // 227 KB: the most a block may take
constexpr int kStages = 4;           // streamed kernel: ring depth
constexpr int kStreamRows = 128;     // streamed kernel: rows per block
constexpr int kStageBytes = kStreamRows * 128 + kWSlabBytes;
constexpr int kOutStage = 512;       // a warp's staging of 4 output rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of the 16-byte chunk `chunk` (0..7) of row `row` in a
// [rows][128 B] slab under the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// where channel ch (0..63) of a block's W tile lies among the 64 rows of B
__device__ __forceinline__ int b_row_of_channel(int ch) {
  return 8 * ((ch & 15) >> 1) + 2 * (ch >> 4) + (ch & 1);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared memory written through the generic proxy (cp.async, st.shared)
// made visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of an accumulator across the wait
// that completes it (the wait itself names no register)
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// mbarriers: a TMA load reports the bytes it has written to one
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of a 3-D tensor map -> shared memory (swizzled by the hardware,
// zeros where the box leaves the tensor), completion reported to `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// descriptor of a K-major, 128-byte-swizzled operand at shared address
// `addr` (1024-byte aligned tile, plus 32 bytes per 16 channels of depth):
// 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// acc (+)= A[64 x 16] * B[16 x 64], bf16 in, float32 out; scale_d = 0
// starts a new sum
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One group: acc = A[64 x 16 * kLen] * B[.. x 64] over kLen steps of 16
// channels, from a zero accumulator, committed. a_desc / b_desc describe the
// operands at the group's first step, which starts a 64-channel slab
// (kASlab / kWSlabBytes from one slab to the next): every later step is a
// constant added to the descriptor. The tensor cores add into their
// accumulator with truncation, and the error grows with the running sum: so
// a sum never runs longer than kMaxGroup steps there, and the groups'
// results are added in registers with round-to-nearest float32 adds
// (add_into), which keeps the result as close to the plain version's as a
// float32 sum in another order is. The steps are unrolled at compile time
// and every group of a launch has the same length (the last steps of a tap
// run into zero-filled columns): ptxas keeps wgmmas in flight across other
// work only in straight-line code.
constexpr int kMaxGroup = 10;

template <int kLen, int kASlab>
__device__ __forceinline__ void run_chain(float (&acc)[32], uint64_t a_desc,
                                            uint64_t b_desc) {
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < kLen; ++i)
    wgmma_m64n64k16(
        acc, a_desc + (((i >> 2) * kASlab + (i & 3) * 32) >> 4),
        b_desc + (((i >> 2) * kWSlabBytes + (i & 3) * 32) >> 4),
        i > 0 ? 1 : 0);
  wgmma_commit();
}

__device__ __forceinline__ void add_into(float (&total)[32],
                                         float (&acc)[32]) {
  pin(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) total[i] = __fadd_rn(total[i], acc[i]);
}

// W [3][Ci][Co] -> wt [3][Co_pad][Ci_pad], zero beyond Ci and Co, the rows
// of each 64-channel tile in the order B takes them (b_row_of_channel): a
// 32 x 32 transpose through shared memory, both sides coalesced
__global__ void tconv_prep_w_kernel(const bf16* __restrict__ w,
                                    bf16* __restrict__ wt, int Ci, int Co,
                                    int Ci_pad, int Co_pad) {
  __shared__ bf16 tile[32][33];
  const int dt = blockIdx.z;
  const int ci0 = blockIdx.x * 32, co0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int ci = ci0 + i, co = co0 + threadIdx.x;
    tile[i][threadIdx.x] =
        (ci < Ci && co < Co)
            ? w[(static_cast<long long>(dt) * Ci + ci) * Co + co]
            : __float2bfloat16_rn(0.0f);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int co = co0 + i, ci = ci0 + threadIdx.x;
    if (co < Co_pad && ci < Ci_pad)
      wt[(static_cast<long long>(dt) * Co_pad + (co & ~63) +
          b_row_of_channel(co & 63)) *
             Ci_pad +
         ci] = tile[threadIdx.x][i];
  }
}

// Stage columns [col0, col0 + ncols) (col0 a multiple of 64, ncols of 16) of
// `nrows` consecutive rows of x, the first at flat row `row_off`, into
// swizzled slabs at `dst` (`slab_stride` bytes from one 64-column slab to
// the next). valid(r) says whether row r exists; rows that do not, and
// columns >= Ci, become zeros. kMode is the bytes per copy: 4 by cp.async
// (x 4-byte aligned and Ci even), 2 by plain loads and stores. (Where 16
// bytes would fit, whole tiles come by TMA instead.)
template <int kMode, typename Valid>
__device__ __forceinline__ void stage_x(unsigned char* dst,
                                        uint32_t slab_stride,
                                        const bf16* __restrict__ x,
                                        long long row_off, int Ci, int col0,
                                        int ncols, int nrows, int tid,
                                        int nthreads, Valid valid) {
  const uint32_t dst32 = smem_u32(dst);
  // `per_row` copies per row; a thread keeps its copy's place in the row
  // and steps over rows (one division per call, none per copy)
  const int per_row = kMode == 4 ? ncols >> 1 : ncols;
  const int tpr = min(per_row, nthreads);  // threads per row
  const int rpp = nthreads / tpr;          // rows per pass
  const int lane_r = tid / tpr, lane_c = tid - lane_r * tpr;
  if (lane_r >= rpp) return;
  if (kMode == 4) {
    for (int r = lane_r; r < nrows; r += rpp) {
      const bool row_ok = valid(r);
      const bf16* row = x + (row_off + r) * Ci;
      for (int q = lane_c; q < per_row; q += tpr) {
        const int col = col0 + q * 2;
        const bool ok = row_ok && col < Ci;
        cp_async4(dst32 + (q >> 5) * slab_stride + swz(r, (q >> 2) & 7) +
                      (q & 3) * 4,
                  ok ? row + col : x, ok ? 4 : 0);
      }
    }
  } else {
    // no asynchronous copy is this narrow: 8 rows' loads in flight per
    // thread, then their 8 stores
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
    for (int e = lane_c; e < per_row; e += tpr) {
      const int col = col0 + e;
      const uint32_t off = (e >> 6) * slab_stride + (e & 7) * 2;
      for (int r0 = lane_r; r0 < nrows; r0 += 8 * rpp) {
        unsigned short v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r0 + u * rpp;
          v[u] = (r < nrows && col < Ci && valid(r))
                     ? xs[(row_off + r) * Ci + col]
                     : static_cast<unsigned short>(0);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r0 + u * rpp;
          if (r < nrows)
            *reinterpret_cast<unsigned short*>(dst + off +
                                               swz(r, (e >> 3) & 7)) = v[u];
        }
      }
    }
  }
}

// `bytes` (a multiple of 16) contiguous bytes of device memory -> shared
// memory, both 16-byte aligned, by one thread's request; completion is
// counted into `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Rows of Ci channels lying back to back in shared memory at `lin` (as they
// lie in x) -> the swizzled slabs at `dst`: columns [0, ncols) of `nrows`
// rows, zeros for rows >= nvalid and columns >= Ci. kPiece is the bytes a
// thread moves at a time: 4 (Ci even) or 2.
template <int kPiece>
__device__ __forceinline__ void relayout(unsigned char* dst,
                                         uint32_t slab_stride,
                                         const unsigned char* lin, int Ci,
                                         int ncols, int nrows, int nvalid,
                                         int tid, int nthreads) {
  const int per_row = kPiece == 4 ? ncols >> 1 : ncols;
  const int tpr = min(per_row, nthreads);
  const int rpp = nthreads / tpr;
  const int lane_r = tid / tpr, lane_c = tid - lane_r * tpr;
  if (lane_r >= rpp) return;
  for (int c = lane_c; c < per_row; c += tpr) {
    const int col = kPiece == 4 ? 2 * c : c;
    const bool in_row = col < Ci;
    unsigned char* at =
        dst + (col >> 6) * slab_stride + (col & 7) * 2;  // + the row's part
    const int chunk = (col >> 3) & 7;
    for (int r = lane_r; r < nrows; r += rpp) {
      const bool ok = in_row && r < nvalid;
      const unsigned char* src = lin + (r * Ci + col) * 2;
      if (kPiece == 4)
        *reinterpret_cast<uint32_t*>(at + swz(r, chunk)) =
            ok ? *reinterpret_cast<const uint32_t*>(src) : 0u;
      else
        *reinterpret_cast<unsigned short*>(at + swz(r, chunk)) =
            ok ? *reinterpret_cast<const unsigned short*>(src)
               : static_cast<unsigned short>(0);
    }
  }
}

// One 64-channel W slab range of the block's tile: `nslabs` slabs of
// wt[dt][co0 .. co0 + 63][slab0 * 64 ..] into `dst` (wt's rows are already
// in B's order)
__device__ __forceinline__ void stage_w(unsigned char* dst,
                                        const bf16* __restrict__ wt_rows,
                                        int Ci_pad, int slab0, int nslabs,
                                        int tid, int nthreads) {
  const uint32_t dst32 = smem_u32(dst);
  const int per_row = nslabs * 8;
  for (int i = tid; i < kBN * per_row; i += nthreads) {
    const int ch = i / per_row, c = i - ch * per_row;
    cp_async16(dst32 + (c >> 3) * kWSlabBytes + swz(ch, c & 7),
               wt_rows + static_cast<long long>(ch) * Ci_pad + slab0 * kSlab +
                   c * 8,
               16);
  }
}

// A warp's accumulators -> y: the 16 rows from `row0` of the block's tile
// (y_tile points at the tile's first row, channel co0) by 64 channels; rows
// >= rows_left are not written. A lane holds 16 consecutive channels (32
// bytes) of rows lane / 4 and lane / 4 + 8: written straight from there, a
// store instruction would touch 8 rows and half of each 128-byte line, and
// such stores run at a fifth of the memory rate. So the rows pass through
// `stage` (512 bytes of shared memory of the warp's own), four at a time,
// and leave as whole lines: 8 lanes a row, 16 bytes a lane.
__device__ __forceinline__ void store_tile(const float (&acc)[32],
                                           bf16* __restrict__ y_tile, int row0,
                                           long long rows_left, int Co,
                                           int co0, int lane,
                                           unsigned char* stage) {
  const int q = lane & 3;
  if ((Co % 8 == 0) && (co0 + kBN <= Co)) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      constexpr int kHalfOf[4] = {0, 0, 1, 1};
      const int h = kHalfOf[k];
      if ((lane >> 4) == (k & 1)) {  // the lanes that hold rows 4k .. 4k+3
        const int rr = (lane >> 2) & 3;
        uint32_t pk[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          pk[j] = *reinterpret_cast<const uint32_t*>(&v);
        }
        // 16-byte pieces 2q and 2q+1 of the row; odd rows swap neighbours,
        // which keeps the banks apart
        uint4* line = reinterpret_cast<uint4*>(stage + rr * 128);
        line[(2 * q) ^ (rr & 1)] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
        line[(2 * q + 1) ^ (rr & 1)] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
      }
      __syncwarp();
      const int rr = lane >> 3, piece = lane & 7;
      const uint4 v =
          reinterpret_cast<const uint4*>(stage + rr * 128)[piece ^ (rr & 1)];
      const int r = row0 + 4 * k + rr;
      if (r < rows_left)
        *reinterpret_cast<uint4*>(y_tile + static_cast<long long>(r) * Co +
                                  piece * 8) = v;
      __syncwarp();
    }
  } else {  // a ragged channel tile: element by element
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + (lane >> 2) + 8 * h;
      if (r >= rows_left) continue;
      bf16* out = y_tile + static_cast<long long>(r) * Co + 16 * q;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (co0 + 16 * q + 2 * j + e < Co)
            out[2 * j + e] = __float2bfloat16_rn(acc[4 * j + 2 * h + e]);
    }
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// resident: see the header. grid (N * p_tiles, co_tiles), kWgs warpgroups,
// each 64 of the block's 64 * kWgs positions; a tap is per_tap (1 or 2)
// groups of kLen steps (two only as 2 x 8 steps over 4 slabs).
template <int kWgs, int kMode, int kLen>
__device__ __forceinline__ void resident_walk(
    const bf16* __restrict__ x, const bf16* __restrict__ wt,
    bf16* __restrict__ y, int Tlen, int P, int Ci, int Co, int Ci_pad,
    int Co_pad, int p_tiles, int ring, int per_tap, const CUtensorMap* xmap) {
  constexpr int kRows = 64 * kWgs;
  constexpr int kThreads = 128 * kWgs;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int slabs = Ci_pad / kSlab;
  const uint32_t tile_bytes = static_cast<uint32_t>(slabs) * kRows * 128;
  const uint32_t tap_bytes = static_cast<uint32_t>(slabs) * kWSlabBytes;
  unsigned char* Ws = smem;
  unsigned char* As = smem + 3 * tap_bytes;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n = blockIdx.x / p_tiles;
  const int p0 = (blockIdx.x - n * p_tiles) * kRows;
  const int co0 = blockIdx.y * kBN;
  const long long frame0 = static_cast<long long>(n) * Tlen;  // in frames

  for (int dt = 0; dt < 3; ++dt)
    stage_w(Ws + dt * tap_bytes,
            wt + (static_cast<long long>(dt) * Co_pad + co0) * Ci_pad, Ci_pad,
            0, slabs, tid, kThreads);
  // kMode 0: one thread asks the TMA unit for the tile, a box of kRows
  // positions by 64 channels per slab, and the slot's mbarrier counts the
  // bytes in; positions >= P and channels >= Ci arrive as zeros
  const uint32_t bars =
      smem_u32(As + ring * tile_bytes + kWgs * 4 * kOutStage);
  if (kMode == 0) {
    if (tid == 0) {
      for (int i = 0; i < ring; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    fence_async_proxy();
    __syncthreads();
  }
  auto load_tile = [&](int tt, int slot) {
    if (tid == 0) {
      mbar_expect_tx(bars + 8 * slot, tile_bytes);
      for (int sl = 0; sl < slabs; ++sl)
        tma_load_3d(smem_u32(As) + slot * tile_bytes + sl * kRows * 128, xmap,
                    sl * kSlab, p0, static_cast<int>(frame0) + tt,
                    bars + 8 * slot);
    }
  };
  // kMode 4, 2: every thread copies its share of the tile
  auto copy_tile = [&](int tt, int slot) {
    stage_x<(kMode & 7)>(As + slot * tile_bytes, kRows * 128, x,
                         (frame0 + tt) * P + p0, Ci, 0, per_tap * kLen * 16,
                         kRows, tid, kThreads,
                         [&](int r) { return p0 + r < P; });
  };
  // kBulk (kMode 32 + 4 or 2; the plan takes it where a tile's rows are one
  // 16-byte-aligned run of x of a multiple of 16 bytes): one thread asks
  // for the tile's bytes as they lie in x, into `lin`, and once they are
  // there (the mbarrier at `bars`) the threads move them into the slot's
  // slabs through shared memory, which is ten times faster than 4-byte
  // cp.async from device memory. One tile ahead: frame t+2 loads while
  // frame t is multiplied.
  constexpr bool kBulk = kMode >= 32;
  unsigned char* lin = As + ring * tile_bytes + kWgs * 4 * kOutStage + 64;
  const int nvalid = min(kRows, P - p0);
  uint32_t lin_phase = 0;
  auto bulk_tile = [&](int tt) {
    if (tid == 0) {
      const uint32_t bytes = static_cast<uint32_t>(nvalid) * Ci * 2;
      mbar_expect_tx(bars, bytes);
      bulk_load(smem_u32(lin), x + ((frame0 + tt) * P + p0) * Ci, bytes,
                bars);
    }
  };
  auto place_tile = [&](int slot) {  // wait for `lin`, then lin -> slot
    mbar_wait(bars, lin_phase);
    lin_phase ^= 1;
    relayout<(kMode & 7) == 4 ? 4 : 2>(As + slot * tile_bytes, kRows * 128,
                                       lin, Ci, per_tap * kLen * 16, kRows,
                                       nvalid, tid, kThreads);
  };
  // frame tt lies in slot tt % ring. TMA and cp.async: frames 0 .. ring-3
  // are asked for now, frame t+ring-2 at step t (cp.async: one group per
  // frame, W rides in the first). Bulk: frame 0 is placed now, frame 1 asked
  // for, frame t+1 placed and frame t+2 asked for at step t.
  if (kBulk) {
    if (tid == 0) {
      mbar_init(bars, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    fence_async_proxy();
    __syncthreads();
    bulk_tile(0);
    place_tile(0);
    __syncthreads();  // every thread has read `lin`
    if (1 < Tlen) bulk_tile(1);
    cp_async_commit();  // W
  } else {
    for (int tt = 0; tt <= ring - 3; ++tt) {
      if (tt < Tlen) {
        if (kMode == 0) load_tile(tt, tt);
        else copy_tile(tt, tt);
      }
      cp_async_commit();
    }
  }

  unsigned char* out_stage = As + ring * tile_bytes + (tid >> 5) * kOutStage;
  const uint64_t a_desc0 = wgmma_desc(smem_u32(As) + wg * 64 * 128);
  const uint64_t b_desc0 = wgmma_desc(smem_u32(Ws));
  const uint32_t tile16 = tile_bytes >> 4, tap16 = tap_bytes >> 4;
  float total[32], acc_a[32], acc_b[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_a[i] = acc_b[i] = 0.0f;
  int slot_prev = ring - 1;  // the slot of frame t-1 (t % ring, less one)
  int slot_next = 1;         // the slot of frame t+1 and its mbarrier's
  uint32_t phase_next = 0;   // parity: which use of the slot this is
  for (int t = 0; t < Tlen; ++t) {
    if (kMode == 0) {
      cp_async_wait<0>();  // W
      if (t == 0) mbar_wait(bars, 0);
      if (t + 1 < Tlen) mbar_wait(bars + 8 * slot_next, phase_next);
      if (++slot_next == ring) {
        slot_next = 0;
        phase_next ^= 1;
      }
    } else if (kBulk) {
      __syncthreads();  // every warp is done with frame t-2's slot
      if (t + 1 < Tlen) place_tile(slot_next);
      if (++slot_next == ring) slot_next = 0;
      cp_async_wait<0>();  // W
    } else if (ring == 4) {
      // frame t+1 has landed when at most ring-4 later groups are pending
      cp_async_wait<0>();
    } else if (ring == 5) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<2>();
    }
    fence_async_proxy();
    __syncthreads();  // and every warp is done with frame t-2's slot
    if (kBulk) {
      if (t + 2 < Tlen) bulk_tile(t + 2);  // `lin` has been read by all
    } else if (t + ring - 2 < Tlen) {  // into the slot before frame t-1's
      const int slot = slot_prev == 0 ? ring - 1 : slot_prev - 1;
      if (kMode == 0) load_tile(t + ring - 2, slot);
      else copy_tile(t + ring - 2, slot);
    }
    cp_async_commit();

    // the taps whose frame exists, each in per_tap groups of kLen steps; two
    // accumulators take turns, so that the tensor cores run one group while
    // the other's result is added
    const int dt_lo = t == 0 ? 1 : 0;
    const int groups = ((t == Tlen - 1 ? 1 : 2) - dt_lo + 1) * per_tap;
    int g_dt = dt_lo, g_half = 0;
    int g_slot = slot_prev + dt_lo;  // the slot of frame t + g_dt - 1
    if (g_slot >= ring) g_slot -= ring;
    auto next_chain = [&](float (&acc)[32]) {  // the next group
      run_chain<kLen, kRows * 128>(
          acc, a_desc0 + g_slot * tile16 + g_half * (2 * kRows * 128 >> 4),
          b_desc0 + g_dt * tap16 + g_half * (2 * kWSlabBytes >> 4));
      if (++g_half == per_tap) {
        g_half = 0;
        ++g_dt;
        if (++g_slot == ring) g_slot = 0;
      }
    };
#pragma unroll
    for (int i = 0; i < 32; ++i) total[i] = 0.0f;
    next_chain(acc_a);
    int g = 1;
    for (; g + 1 < groups; g += 2) {
      next_chain(acc_b);
      wgmma_wait<1>();
      add_into(total, acc_a);
      next_chain(acc_a);
      wgmma_wait<1>();
      add_into(total, acc_b);
    }
    if (g < groups) {
      next_chain(acc_b);
      wgmma_wait<1>();
      add_into(total, acc_a);
      wgmma_wait<0>();
      add_into(total, acc_b);
    } else {
      wgmma_wait<0>();
      add_into(total, acc_a);
    }
    store_tile(total, y + ((frame0 + t) * P + p0) * Co + co0,
               wg * 64 + warp * 16, P - p0, Co, co0, lane, out_stage);
    if (++slot_prev == ring) slot_prev = 0;
  }
}

template <int kWgs, int kMode>
__global__ void __launch_bounds__(kWgs * 128, 1) tconv_resident_kernel(
    const bf16* __restrict__ x,   // [N, T, P, Ci]
    const bf16* __restrict__ wt,  // [3, Co_pad, Ci_pad]
    bf16* __restrict__ y,         // [N, T, P, Co]
    int Tlen, int P, int Ci, int Co, int Ci_pad, int Co_pad, int p_tiles,
    int ring, const __grid_constant__ CUtensorMap xmap) {
  // a tap's (Ci + 15) / 16 steps: up to kMaxGroup as one group of an even
  // length, more as two groups of 8 (Ci_pad is 256 then)
  const int ksteps = (Ci + 15) / 16;
  const int per_tap = ksteps > kMaxGroup ? 2 : 1;
#define ZSVC_WALK(LEN)                                                  \
  case LEN:                                                             \
    resident_walk<kWgs, kMode, LEN>(x, wt, y, Tlen, P, Ci, Co, Ci_pad,  \
                                    Co_pad, p_tiles, ring, per_tap,     \
                                    &xmap);                             \
    break;
  switch (per_tap == 2 ? 8 : (ksteps + 1) / 2 * 2) {
    ZSVC_WALK(2) ZSVC_WALK(4) ZSVC_WALK(6) ZSVC_WALK(8) ZSVC_WALK(10)
  }
#undef ZSVC_WALK
}

// streamed: see the header. grid (N * T * p_tiles, co_tiles), 256 threads:
// two warpgroups, 64 positions each.
template <int kMode>
__global__ void __launch_bounds__(256) tconv_streamed_kernel(
    const bf16* __restrict__ x,   // [N * T, P, Ci]
    const bf16* __restrict__ wt,  // [3, Co_pad, Ci_pad]
    bf16* __restrict__ y,         // [N * T, P, Co]
    int Tlen, int P, int Ci, int Co, int Ci_pad, int Co_pad, int p_tiles,
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap) {
  constexpr int kThreads = 256;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int slabs = Ci_pad / kSlab;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int frame = blockIdx.x / p_tiles;  // n * T + t
  const int p0 = (blockIdx.x - frame * p_tiles) * kStreamRows;
  const int t = frame % Tlen;
  const int co0 = blockIdx.y * kBN;
  // the taps whose frame exists, a stage per tap and slab
  const int dt_lo = t == 0 ? 1 : 0;
  const int nk = ((t == Tlen - 1 ? 1 : 2) - dt_lo + 1) * slabs;

  // kMode 0: one thread asks the TMA unit for a stage's two boxes and the
  // stage's mbarrier counts the bytes in
  const uint32_t bars = smem_u32(smem + kStages * kStageBytes);
  if (kMode == 0) {
    if (tid == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    fence_async_proxy();
    __syncthreads();
  }
  auto load_stage = [&](int ks) {
    const int tap = ks / slabs, sl = ks - tap * slabs, dt = dt_lo + tap;
    const int slot = ks % kStages;
    unsigned char* st = smem + slot * kStageBytes;
    if (kMode == 0) {
      if (tid == 0) {
        mbar_expect_tx(bars + 8 * slot, kStageBytes);
        tma_load_3d(smem_u32(st), &xmap, sl * kSlab, p0, frame + dt - 1,
                    bars + 8 * slot);
        tma_load_2d(smem_u32(st) + kStreamRows * 128, &wmap, sl * kSlab,
                    dt * Co_pad + co0, bars + 8 * slot);
      }
    } else {
      stage_x<kMode>(st, 0, x,
                     static_cast<long long>(frame + dt - 1) * P + p0, Ci,
                     sl * kSlab, kSlab, kStreamRows, tid, kThreads,
                     [&](int r) { return p0 + r < P; });
      stage_w(st + kStreamRows * 128,
              wt + (static_cast<long long>(dt) * Co_pad + co0) * Ci_pad,
              Ci_pad, sl, 1, tid, kThreads);
    }
  };
  for (int ks = 0; ks < kStages - 2; ++ks) {
    if (ks < nk) load_stage(ks);
    cp_async_commit();
  }

  // a stage is a group (64 channels); two accumulators take turns: stage
  // ks multiplies while stage ks-1's result is added and stage ks+2 loads
  // into the slot stage ks-2 has left. (In this kernel ptxas still puts a
  // full wait before each add, its note C7517 in the build log, so the two
  // do not overlap yet.)
  float total[32], acc_a[32], acc_b[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) total[i] = acc_a[i] = acc_b[i] = 0.0f;
  auto step = [&](float (&acc)[32], int ks) {
    if (kMode == 0)  // stage ks has landed: its slot's (ks / kStages)-th use
      mbar_wait(bars + 8 * (ks % kStages), (ks / kStages) & 1);
    else
      cp_async_wait<kStages - 3>();
    fence_async_proxy();
    __syncthreads();  // and every warp has waited for stage ks-2's wgmmas
    if (ks + kStages - 2 < nk) load_stage(ks + kStages - 2);
    cp_async_commit();
    const uint32_t stage = smem_u32(smem) + (ks % kStages) * kStageBytes;
    // the last slab of a tap runs into its zero-filled columns
    run_chain<4, 0>(acc, wgmma_desc(stage + wg * 64 * 128),
                      wgmma_desc(stage + kStreamRows * 128));
  };
  step(acc_a, 0);
  int ks = 1;
  for (; ks + 1 < nk; ks += 2) {
    step(acc_b, ks);
    wgmma_wait<1>();
    add_into(total, acc_a);
    step(acc_a, ks + 1);
    wgmma_wait<1>();
    add_into(total, acc_b);
  }
  if (ks < nk) {
    step(acc_b, ks);
    wgmma_wait<1>();
    add_into(total, acc_a);
    wgmma_wait<0>();
    add_into(total, acc_b);
  } else {
    wgmma_wait<0>();
    add_into(total, acc_a);
  }
  store_tile(total, y + (static_cast<long long>(frame) * P + p0) * Co + co0,
             wg * 64 + warp * 16, P - p0, Co, co0, lane,
             smem + kStages * kStageBytes + 64 + (tid >> 5) * kOutStage);
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// libcuda's cuTensorMapEncodeTiled, fetched at run time (nothing links it)
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// A bf16 tensor of `rank` (2 or 3) axes, innermost first, contiguous, as a
// tensor map with the given box, 128-byte swizzled; the parts of a box that
// leave the tensor read as zeros
int make_map(CUtensorMap* map, const bf16* base, int rank,
             const cuuint64_t* dims, const cuuint32_t* box) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                                    &fn, cudaEnableDefault);
    if (err != cudaSuccess || fn == nullptr)
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};  // bytes
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
      const_cast<void*>(static_cast<const void*>(base)), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// x [N * T, P, Ci]: a box is `rows` positions by 64 channels of one frame
int make_x_map(CUtensorMap* map, const bf16* x, long long frames, int P,
               int Ci, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Ci),
                              static_cast<cuuint64_t>(P),
                              static_cast<cuuint64_t>(frames)};
  const cuuint32_t box[3] = {kSlab, static_cast<cuuint32_t>(rows), 1};
  return make_map(map, x, 3, dims, box);
}

// wt [3 * Co_pad, Ci_pad]: a box is one 64 x 64 slab of one tap
int make_w_map(CUtensorMap* map, const bf16* wt, int Ci_pad, int Co_pad) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Ci_pad),
                              static_cast<cuuint64_t>(3) * Co_pad};
  const cuuint32_t box[2] = {kSlab, kBN};
  return make_map(map, wt, 2, dims, box);
}

template <int kWgs, int kMode>
int launch_resident(const bf16* x, const bf16* wt, bf16* y, int N, int Tlen,
                    int P, int Ci, int Co, int Ci_pad, int Co_pad, int ring,
                    int smem, cudaStream_t s) {
  const int p_tiles = (P + 64 * kWgs - 1) / (64 * kWgs);
  const long long gx = static_cast<long long>(N) * p_tiles;
  if (gx >= (1LL << 31) || Co_pad / kBN > 65535 ||
      static_cast<long long>(N) * Tlen >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap;
  std::memset(&xmap, 0, sizeof(xmap));
  if (kMode == 0) {
    const int err = make_x_map(&xmap, x, static_cast<long long>(N) * Tlen, P,
                               Ci, 64 * kWgs);
    if (err != 0) return err;
  }
  int err = set_smem(tconv_resident_kernel<kWgs, kMode>, smem);
  if (err != 0) return err;
  tconv_resident_kernel<kWgs, kMode>
      <<<dim3(static_cast<unsigned>(gx), Co_pad / kBN), kWgs * 128, smem, s>>>(
          x, wt, y, Tlen, P, Ci, Co, Ci_pad, Co_pad, p_tiles, ring, xmap);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_streamed(const bf16* x, const bf16* wt, bf16* y, int N, int Tlen,
                    int P, int Ci, int Co, int Ci_pad, int Co_pad, int smem,
                    cudaStream_t s) {
  const int p_tiles = (P + kStreamRows - 1) / kStreamRows;
  const long long frames = static_cast<long long>(N) * Tlen;
  const long long gx = frames * p_tiles;
  if (gx >= (1LL << 31) || Co_pad / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  std::memset(&xmap, 0, sizeof(xmap));
  std::memset(&wmap, 0, sizeof(wmap));
  if (kMode == 0) {
    int err = make_x_map(&xmap, x, frames, P, Ci, kStreamRows);
    if (err == 0) err = make_w_map(&wmap, wt, Ci_pad, Co_pad);
    if (err != 0) return err;
  }
  int err = set_smem(tconv_streamed_kernel<kMode>, smem);
  if (err != 0) return err;
  tconv_streamed_kernel<kMode>
      <<<dim3(static_cast<unsigned>(gx), Co_pad / kBN), 256, smem, s>>>(
          x, wt, y, Tlen, P, Ci, Co, Ci_pad, Co_pad, p_tiles, xmap, wmap);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_resident_wgs(int wgs, const bf16* x, const bf16* wt, bf16* y,
                        int N, int Tlen, int P, int Ci, int Co, int Ci_pad,
                        int Co_pad, int ring, int smem, cudaStream_t s) {
  return wgs == 1 ? launch_resident<1, kMode>(x, wt, y, N, Tlen, P, Ci, Co,
                                              Ci_pad, Co_pad, ring, smem, s)
                  : launch_resident<2, kMode>(x, wt, y, N, Tlen, P, Ci, Co,
                                              Ci_pad, Co_pad, ring, smem, s);
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

// bf16, two launches on `stream`: W's re-layout into `wt` (scratch of
// 3 * Co_pad * Ci_pad bf16, Ci_pad and Co_pad the next multiples of 64),
// then the main kernel the plan names: resident != 0 with `wgs` (1 or 2)
// warpgroups and a ring of `ring` (4..6) x tiles, else streamed; `mode` is
// the bytes per staging access of x and must fit Ci and x's alignment:
// 0 (whole tiles by TMA), 4 (cp.async) or 2 (plain loads), or 32 + 4 / 32 +
// 2 (resident only: a tile's bytes by one bulk copy, then moved 4 or 2
// bytes at a time inside shared memory); `smem` the dynamic shared memory the plan computed.
// Returns the first error (0 = both launched), cudaErrorInvalidValue for a
// plan that is not this source's.
extern "C" int zsvc_temporal_conv3_bf16(const void* x, const void* w, void* y,
                                        void* wt, int N, int T, int P, int Ci,
                                        int Co, int resident, int wgs,
                                        int ring, int mode, int smem,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xt = static_cast<const bf16*>(x);
  bf16* wtt = static_cast<bf16*>(wt);
  bf16* yt = static_cast<bf16*>(y);
  // 64-channel slabs; two groups of 8 steps a tap (resident, more than
  // kMaxGroup steps) read 4 of them
  const int Ci_pad = (resident && (Ci + 15) / 16 > kMaxGroup)
                         ? 4 * kSlab
                         : (Ci + kSlab - 1) / kSlab * kSlab;
  const int Co_pad = (Co + kBN - 1) / kBN * kBN;
  const int slabs = Ci_pad / kSlab;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  // bulk: a tile's rows (64 * wgs positions, fewer in a frame's last tile)
  // are one aligned run of x of a multiple of 16 bytes
  const int tile_rows = 64 * wgs;
  const bool bulk = mode == 36 || mode == 34;
  const bool bulk_ok =
      resident && xa % 16 == 0 &&
      (static_cast<long long>(P) * Ci * 2) % 16 == 0 &&
      (static_cast<long long>(tile_rows) * Ci * 2) % 16 == 0 &&
      (static_cast<long long>(P % tile_rows) * Ci * 2) % 16 == 0;
  const bool mode_ok = (mode == 0 && Ci % 8 == 0 && xa % 16 == 0) ||
                       (mode == 4 && Ci % 2 == 0 && xa % 4 == 0) ||
                       mode == 2 || (mode == 36 && Ci % 2 == 0 && bulk_ok) ||
                       (mode == 34 && bulk_ok);
  int need;
  if (resident) {
    if ((wgs != 1 && wgs != 2) || ring < (bulk ? 3 : 4) || ring > 6)
      return static_cast<int>(cudaErrorInvalidValue);
    need = 1024 + 3 * slabs * kWSlabBytes + ring * slabs * wgs * 64 * 128 +
           wgs * 4 * kOutStage + (mode == 0 || bulk ? 64 : 0) +
           (bulk ? (tile_rows * Ci * 2 + 15) / 16 * 16 : 0);
  } else {
    need = 1024 + kStages * kStageBytes + 64 + 8 * kOutStage;
  }
  if (!mode_ok || smem != need || smem > kMaxSmem ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);

  tconv_prep_w_kernel<<<dim3(Ci_pad / 32, Co_pad / 32, 3), dim3(32, 8), 0,
                        s>>>(static_cast<const bf16*>(w), wtt, Ci, Co, Ci_pad,
                             Co_pad);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  if (resident) {
    switch (mode) {
      case 36:
        return launch_resident_wgs<36>(wgs, xt, wtt, yt, N, T, P, Ci, Co,
                                       Ci_pad, Co_pad, ring, smem, s);
      case 34:
        return launch_resident_wgs<34>(wgs, xt, wtt, yt, N, T, P, Ci, Co,
                                       Ci_pad, Co_pad, ring, smem, s);
      case 0:
        return launch_resident_wgs<0>(wgs, xt, wtt, yt, N, T, P, Ci, Co,
                                      Ci_pad, Co_pad, ring, smem, s);
      case 4:
        return launch_resident_wgs<4>(wgs, xt, wtt, yt, N, T, P, Ci, Co,
                                      Ci_pad, Co_pad, ring, smem, s);
      default:
        return launch_resident_wgs<2>(wgs, xt, wtt, yt, N, T, P, Ci, Co,
                                      Ci_pad, Co_pad, ring, smem, s);
    }
  }
  switch (mode) {
    case 0:
      return launch_streamed<0>(xt, wtt, yt, N, T, P, Ci, Co, Ci_pad, Co_pad,
                                smem, s);
    case 4:
      return launch_streamed<4>(xt, wtt, yt, N, T, P, Ci, Co, Ci_pad, Co_pad,
                                smem, s);
    default:
      return launch_streamed<2>(xt, wtt, yt, N, T, P, Ci, Co, Ci_pad, Co_pad,
                                smem, s);
  }
}
