// K1 and K4: the fused input transforms on Hopper (sm_90a), one kernel
// template for both.
//
// K1 replaces zeroshotvideoclassification_tpu/ops/resample_pallas.py:
// fused_video_transform_pallas, which ran the separable bilinear resample as
// two interpolation-matrix products per (sample, frame, channel) plane on the
// TPU's matrix unit. With two taps per axis a GPU reads the four source
// pixels directly:
//
//   out[b, t, oy, ox, c] = (((lerp_x(lerp_y(canvas[b, t])) / 255) - 1) / 2
//
// with the taps y0/y1/wy (per output row) and x0/x1/wx (per output column)
// of sample b ([B, S]), into which resize, crop and flip were folded on the
// host (data/transform_params.py:resample_indices).
//
// K4 replaces resample_pallas.py:fused_image_motion_transform_pallas, the
// SUN camera-motion inflation, which the JAX package runs through K1's own
// kernel body (_kernel(..., affine=)). It differs from K1 in three ways:
//   * its taps are per FRAME, [B, T, S]: frame (b, t) reads row
//     (b * T + t) * S of them, where K1's frame reads row b * S;
//   * its source is ONE image per sample, [B, Hc, Wc, 3]: every frame of
//     sample b reads image b (263 KB at 256x342, which stays in L2 while
//     the sample's frames read it);
//   * its epilogue is the per-channel affine v * scale[c] + offset[c], the
//     six constants a kernel argument:
//
//   out[b, t, oy, ox, c] = lerp_x(lerp_y(image[b])) * scale[c] + offset[c]
//
// The kernel template takes the difference as a policy (VideoFrames or
// ImageMotion): which source frame and which row of taps a frame reads, and
// the epilogue.
//
// Bound: bytes. At the serving shape (bucket 8, 64 frames, a 226x226 window)
// K1 reads about 78 MB of uint8 canvas and writes 38.5 MB of bf16; at the
// SUN training shape (16 images of 256x342, 16 frames, 112x112) K4 reads
// 4.2 MB of images and writes 19.3 MB of bf16; both against a few flops per
// byte. A thread that gathers its own pixel from global memory makes twelve
// 1-byte loads and stores 6 bytes: small scattered requests. Design: one
// block per band of `band_rows` output rows of one frame
// (ops/resample_cuda.transform_plan sizes them, for both kernels), which
//   1. finds the span of source rows the band touches, from the least to
//      the greatest row tap (computed here, not assumed monotone): each warp
//      reads the band's row taps and reduces them with redux.sync;
//   2. stages that span, which in a frame is one contiguous run of bytes,
//      by 16-byte cp.async (the unaligned head and tail byte by byte), and
//      while it is in flight loads its row taps and all S column taps into
//      shared memory;
//   3. computes its pixels from shared memory into an output tile in shared
//      memory: a thread owns an output column (its taps in registers) and
//      walks rows; a source pixel's three bytes come as two 4-byte words
//      and a funnel shift;
//   4. writes the tile, which is one contiguous run of the output, with
//      16-byte stores (an unaligned head and tail element by element).
// Several blocks share an SM, so one block's copies overlap another's
// compute. (Staging a band in two to four groups, each part of its rows
// computed as soon as its group landed, ran slower on the card.)
// Where the span of a band's taps exceeds the `stage_rows` the plan made
// room for (taps that jump about), the band is done in pieces: the longest
// runs of its output rows whose span fits, each staged and computed in turn;
// an output row whose own two taps lie further apart than that stages just
// those two source rows. Any canvas or image size is accepted. K4 stages
// whole image rows, as K1 does, though a crop reads at most 256 of a row's
// 342 pixels.
//
// Arithmetic: the order of ops/resample.py (row lerp at both source
// columns, then the column lerp, then K1's /255, -1, /2 or K4's * scale,
// + offset), every step rounded on its own (the _rn intrinsics keep nvcc
// from contracting into FMAs), so the float32 output equals the plain
// PyTorch version's. Three of K1's steps take an exact shortcut: a byte
// becomes a float by an add (byte_value), /255 is a product and a fused
// correction (div255), and /2 is a product by 0.5 (the same real number,
// so the same rounding). K4's epilogue takes none.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // what a block may use on an H100

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Memory safety only: the host builds in-range taps, which this never changes.
__device__ __forceinline__ int clamp_index(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// Byte c of `px` as a float, exactly: 2^23 + b has b in its low mantissa bits
// (a byte permute and an add at full rate, where a conversion instruction
// runs at a quarter of the rate).
template <int c>
__device__ __forceinline__ float byte_value(uint32_t px) {
  return __fsub_rn(__uint_as_float(__byte_perm(px, 0x4B000000u, 0x7440 + c)),
                   8388608.0f);
}

// The three bytes of a source pixel at byte offset `off` of shared memory,
// in the low three bytes: the two 4-byte words that hold them and a funnel
// shift (a staging area has slack past its last byte for the second word).
__device__ __forceinline__ uint32_t pixel_bytes(const uint32_t* words,
                                                int off) {
  const int w = off >> 2;
  return __funnelshift_r(words[w], words[w + 1], (off & 3) * 8);
}

// v / 255 rounded once, as __fdiv_rn(v, 255.0f) gives it, in three steps:
// the product by the rounded reciprocal and one fused correction by the
// exact remainder. Over every float below 256 this equals the division (its
// float64 emulation in tests/test_torch_plans.py, run at every one of them),
// and its steps scale by powers of two, so it does for every finite float;
// inf and NaN take the division itself.
__device__ __forceinline__ float div255(float v) {
  constexpr float r = 1.0f / 255.0f;
  const float q = __fmul_rn(v, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-q, 255.0f, v), r, q);
  if (isfinite(q1)) return q1;
  return __fdiv_rn(v, 255.0f);
}

// K1's policy: taps [B, S] of sample frame / T, canvas frame `frame` of
// [B, T, Hc, Wc, 3], and the normalisation ((v / 255) - 1) / 2.
struct VideoFrames {
  __device__ __forceinline__ int source(int frame, int) const {
    return frame;
  }
  __device__ __forceinline__ int taps(int frame, int T) const {
    return frame / T;
  }
  template <int c>
  __device__ __forceinline__ float finish(float v) const {
    // x / 2 and x * 0.5 are one real number, so one rounding
    return __fmul_rn(__fsub_rn(div255(v), 1.0f), 0.5f);
  }
};

// K4's policy: taps [B, T, S] of the frame itself, image frame / T of
// [B, Hc, Wc, 3], and the per-channel affine v * scale[c] + offset[c].
struct ImageMotion {
  float scale[3];
  float offset[3];
  __device__ __forceinline__ int source(int frame, int T) const {
    return frame / T;
  }
  __device__ __forceinline__ int taps(int frame, int) const { return frame; }
  template <int c>
  __device__ __forceinline__ float finish(float v) const {
    return __fadd_rn(__fmul_rn(v, scale[c]), offset[c]);
  }
};

__host__ __device__ __forceinline__ size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

// The block's shared memory, in this order (each part 16-byte aligned): the
// output tile, the taps (xa, xb, fx of the S columns; ya, yb, fy of the
// band's rows) and the staging area. The tile and the staging area have
// slack for the unaligned start of the run they mirror (16 bytes; 64 in the
// staging area, which holds two runs in the pair mode: the second one from
// the first 16-byte boundary at least 16 bytes past a row).
struct Layout {
  size_t tile, taps, stage, total;
  __host__ __device__ Layout(int band_rows, int stage_rows, int S, int Wc,
                             int out_size) {
    tile = 0;
    taps = align16(static_cast<size_t>(band_rows) * S * 3 * out_size + 16);
    stage = taps + align16(static_cast<size_t>(S) * 12 +
                           static_cast<size_t>(band_rows) * 12);
    total = stage + align16(static_cast<size_t>(stage_rows) * Wc * 3 + 64);
  }
};

// A block's work: `nrows` output rows of one frame, which reads source
// frame `src` and the row `tap` of the taps (Mode says which).
struct Band {
  int frame, src, tap, oy0, nrows;
  template <class Mode>
  __device__ Band(Mode mode, int band_rows, int S, int T) {
    frame = blockIdx.y;
    src = mode.source(frame, T);
    tap = mode.taps(frame, T);
    oy0 = blockIdx.x * band_rows;
    nrows = min(band_rows, S - oy0);
  }
};

struct Taps {  // a band's taps in shared memory (clamped; columns x 3)
  int *xa, *xb, *ya, *yb;
  float *fx, *fy;
  __device__ Taps(unsigned char* base, int S, int band_rows) {
    xa = reinterpret_cast<int*>(base);
    xb = xa + S;
    fx = reinterpret_cast<float*>(xb + S);
    ya = reinterpret_cast<int*>(fx + S);
    yb = ya + band_rows;
    fy = reinterpret_cast<float*>(yb + band_rows);
  }
};

__device__ __forceinline__ void load_taps(
    const Taps& tp, const Band& w, const int32_t* y0, const int32_t* y1,
    const float* wy, const int32_t* x0, const int32_t* x1, const float* wx,
    int Hc, int Wc, int S) {
  const int o = w.tap * S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    tp.xa[i] = clamp_index(x0[o + i], Wc - 1) * 3;
    tp.xb[i] = clamp_index(x1[o + i], Wc - 1) * 3;
    tp.fx[i] = wx[o + i];
  }
  for (int i = threadIdx.x; i < w.nrows; i += blockDim.x) {
    tp.ya[i] = clamp_index(y0[o + w.oy0 + i], Hc - 1);
    tp.yb[i] = clamp_index(y1[o + w.oy0 + i], Hc - 1);
    tp.fy[i] = wy[o + w.oy0 + i];
  }
}

struct Piece {  // output rows [i0, i1) of a band, source rows [lo, hi]
  int i1, lo, hi;
  bool pair;  // one output row whose two taps lie too far apart
};

// Every thread plans a piece alike from the row taps.
__device__ __forceinline__ Piece plan_piece(const Taps& tp, int i0,
                                            int nrows, int stage_rows) {
  Piece p;
  p.lo = min(tp.ya[i0], tp.yb[i0]);
  p.hi = max(tp.ya[i0], tp.yb[i0]);
  p.pair = p.hi - p.lo + 1 > stage_rows;
  p.i1 = i0 + 1;
  if (!p.pair) {
    for (; p.i1 < nrows; ++p.i1) {
      const int lo = min(p.lo, min(tp.ya[p.i1], tp.yb[p.i1]));
      const int hi = max(p.hi, max(tp.ya[p.i1], tp.yb[p.i1]));
      if (hi - lo + 1 > stage_rows) break;
      p.lo = lo;
      p.hi = hi;
    }
  }
  return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy the `nbytes` at `src` into shared memory at `dst` (16-byte aligned),
// so that global 16-byte boundaries fall on shared ones: byte src[k] lands at
// dst[src % 16 + k]. Whole 16-byte pieces go by cp.async (not waited for
// here), the cut ones at either end byte by byte.
__device__ __forceinline__ void stage_run(unsigned char* dst,
                                          const uint8_t* src,
                                          size_t nbytes) {
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(src);
  const uintptr_t g1 = g0 + nbytes;
  const uintptr_t ga = g0 & ~static_cast<uintptr_t>(15);
  const size_t pieces = (g1 - ga + 15) / 16;
  for (size_t q = threadIdx.x; q < pieces; q += blockDim.x) {
    const uintptr_t g = ga + 16 * q;
    if (g >= g0 && g + 16 <= g1) {
      cp_async16(dst + 16 * q, reinterpret_cast<const void*>(g));
    } else {
      const uintptr_t lo = g < g0 ? g0 : g;
      const uintptr_t hi = g + 16 < g1 ? g + 16 : g1;
      for (uintptr_t a = lo; a < hi; ++a)
        dst[a - ga] = *reinterpret_cast<const uint8_t*>(a);
    }
  }
}

// Write the `n` output elements at `go` from the tile at `t0`, which mirrors
// them from go's 16-byte boundary on: whole 16-byte pieces as one store
// each, the cut ones at either end element by element.
template <typename OutT>
__device__ __forceinline__ void write_tile(const unsigned char* t0, OutT* go,
                                           size_t n) {
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(go);
  const uintptr_t g1 = g0 + n * sizeof(OutT);
  const uintptr_t ga = g0 & ~static_cast<uintptr_t>(15);
  const size_t pieces = (g1 - ga + 15) / 16;
  for (size_t q = threadIdx.x; q < pieces; q += blockDim.x) {
    const uintptr_t a = ga + 16 * q;
    if (a >= g0 && a + 16 <= g1) {
      *reinterpret_cast<uint4*>(a) =
          *reinterpret_cast<const uint4*>(t0 + 16 * q);
    } else {
      const uintptr_t lo = a < g0 ? g0 : a;
      const uintptr_t hi = a + 16 < g1 ? a + 16 : g1;
      for (uintptr_t e = lo; e < hi; e += sizeof(OutT))
        *reinterpret_cast<OutT*>(e) =
            *reinterpret_cast<const OutT*>(t0 + (e - ga));
    }
  }
}

// Channel c of one output pixel from its four source pixels (a0, b0 at the
// first column tap of the rows ya, yb; a1, b1 at the second) and weights,
// finished by the mode's epilogue.
template <int c, typename OutT, class Mode>
__device__ __forceinline__ void put_channel(OutT* o, Mode mode,
                                            uint32_t a0, uint32_t b0,
                                            uint32_t a1, uint32_t b1,
                                            float gy, float wy, float gx,
                                            float wx) {
  const float ca = __fadd_rn(__fmul_rn(byte_value<c>(a0), gy),
                             __fmul_rn(byte_value<c>(b0), wy));
  const float cb = __fadd_rn(__fmul_rn(byte_value<c>(a1), gy),
                             __fmul_rn(byte_value<c>(b1), wy));
  const float v = __fadd_rn(__fmul_rn(ca, gx), __fmul_rn(cb, wx));
  store(o + c, mode.template finish<c>(v));
}

// The pixels of output rows [i0, i1) into the tile. Source row r of the
// piece starts at byte `a + (r - lo) * rowb` of shared memory, or in the
// pair mode row ya[i0] at `a` and row yb[i0] at `b`. A thread owns a column
// (its taps in registers) and walks the rows `groups` apart: per pixel
// three row-tap loads (broadcasts within a warp) and four source pixels of
// two words each.
template <typename OutT, class Mode>
__device__ __forceinline__ void compute_rows(OutT* tile, Mode mode,
                                             const Taps& tp,
                                             const uint32_t* words, int S,
                                             int i0, int i1, int a, int b,
                                             bool pair, int lo, int rowb) {
  const int span = min(S, static_cast<int>(blockDim.x));
  const int groups = blockDim.x / span;
  const int g = threadIdx.x / span;
  if (g >= groups) return;
  for (int ox = threadIdx.x - g * span; ox < S; ox += span) {
    const int ca0 = tp.xa[ox], cb0 = tp.xb[ox];
    const float wxv = tp.fx[ox];
    const float gx = __fsub_rn(1.0f, wxv);
    for (int i = i0 + g; i < i1; i += groups) {
      const int ra = pair ? a : a + (tp.ya[i] - lo) * rowb;
      const int rb = pair ? b : a + (tp.yb[i] - lo) * rowb;
      const float wyv = tp.fy[i];
      const float gy = __fsub_rn(1.0f, wyv);
      const uint32_t pa0 = pixel_bytes(words, ra + ca0);
      const uint32_t pb0 = pixel_bytes(words, rb + ca0);
      const uint32_t pa1 = pixel_bytes(words, ra + cb0);
      const uint32_t pb1 = pixel_bytes(words, rb + cb0);
      OutT* o = tile + (static_cast<size_t>(i) * S + ox) * 3;
      put_channel<0>(o, mode, pa0, pb0, pa1, pb1, gy, wyv, gx, wxv);
      put_channel<1>(o, mode, pa0, pb0, pa1, pb1, gy, wyv, gx, wxv);
      put_channel<2>(o, mode, pa0, pb0, pa1, pb1, gy, wyv, gx, wxv);
    }
  }
}

template <typename OutT, class Mode>
__global__ void __launch_bounds__(kMaxThreads) video_transform_kernel(
    const uint8_t* __restrict__ canvas,  // K1 [B,T,Hc,Wc,3]; K4 [B,Hc,Wc,3]
    const int32_t* __restrict__ y0, const int32_t* __restrict__ y1,
    const float* __restrict__ wy,  // K1 [B, S]; K4 [B, T, S]
    const int32_t* __restrict__ x0, const int32_t* __restrict__ x1,
    const float* __restrict__ wx,  // K1 [B, S]; K4 [B, T, S]
    OutT* __restrict__ out,        // [B, T, S, S, 3]
    Mode mode, int T, int Hc, int Wc, int S, int band_rows,
    int stage_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(band_rows, stage_rows, S, Wc, sizeof(OutT));
  const int rowb = Wc * 3;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(smem);
  unsigned char* stage = smem + L.stage;
  const Band w(mode, band_rows, S, T);
  const Taps tp(smem + L.taps, S, band_rows);
  const uint8_t* f = canvas + w.src * static_cast<size_t>(Hc) * rowb;

  // the band's span of source rows, in every warp (blockDim is a multiple
  // of 32): staged at once where it fits, its taps loaded meanwhile
  int lo = Hc, hi = -1;
  for (int i = threadIdx.x & 31; i < w.nrows; i += 32) {
    const int o = w.tap * S + w.oy0 + i;
    const int ya = clamp_index(y0[o], Hc - 1);
    const int yb = clamp_index(y1[o], Hc - 1);
    lo = min(lo, min(ya, yb));
    hi = max(hi, max(ya, yb));
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const bool whole = hi - lo + 1 <= stage_rows;
  const uint8_t* run = f + static_cast<size_t>(lo) * rowb;
  if (whole) stage_run(stage, run, static_cast<size_t>(hi - lo + 1) * rowb);
  load_taps(tp, w, y0, y1, wy, x0, x1, wx, Hc, Wc, S);
  if (whole) cp_async_wait_all();
  __syncthreads();

  // the band is one run of the output; the tile mirrors its 16-byte phase
  OutT* go = out + (static_cast<size_t>(w.frame) * S + w.oy0) * S * 3;
  OutT* tile = reinterpret_cast<OutT*>(smem + L.tile +
                                       (reinterpret_cast<uintptr_t>(go) & 15));
  // a run's bytes start at its address's 16-byte phase in the area
  auto at = [&](const uint8_t* src, int area) {
    return static_cast<int>(L.stage) + area +
           static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  };
  if (whole) {
    compute_rows(tile, mode, tp, words, S, 0, w.nrows, at(run, 0),
                 at(run, 0), false, lo, rowb);
  } else {
    for (int i0 = 0; i0 < w.nrows;) {
      const Piece p = plan_piece(tp, i0, w.nrows, stage_rows);
      if (i0 > 0) __syncthreads();  // the last piece is done with the area
      // rows lo..hi as one run, or in the pair mode row ya[i0] and, from
      // the first 16-byte boundary 16 bytes past a row, row yb[i0]
      const uint8_t* ra =
          f + static_cast<size_t>(p.pair ? tp.ya[i0] : p.lo) * rowb;
      const uint8_t* rb = f + static_cast<size_t>(tp.yb[i0]) * rowb;
      const int b_at = static_cast<int>(align16(rowb + 16));
      if (p.pair) {
        stage_run(stage, ra, rowb);
        stage_run(stage + b_at, rb, rowb);
      } else {
        stage_run(stage, ra, static_cast<size_t>(p.hi - p.lo + 1) * rowb);
      }
      cp_async_wait_all();
      __syncthreads();
      compute_rows(tile, mode, tp, words, S, i0, p.i1, at(ra, 0),
                   at(rb, b_at), p.pair, p.lo, rowb);
      i0 = p.i1;
    }
  }
  __syncthreads();  // the tile is whole
  write_tile(smem + L.tile, go, static_cast<size_t>(w.nrows) * S * 3);
}

template <typename OutT, class Mode>
int launch(const void* canvas, const void* y0, const void* y1, const void* wy,
           const void* x0, const void* x1, const void* wx, void* out,
           Mode mode, int B, int T, int Hc, int Wc, int S,
           int band_rows, int stage_rows, int threads, int smem,
           void* stream) {
  // refuse a plan that is not this source's (ops/resample_cuda.
  // transform_plan): the layout's size must be the plan's, within the card
  const Layout L(band_rows, stage_rows, S, Wc, sizeof(OutT));
  const long long frames = static_cast<long long>(B) * T;
  if (Hc < 1 || Wc < 1 || band_rows < 1 || band_rows > S ||
      stage_rows < 2 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || frames < 1 || frames > 65535 ||
      static_cast<size_t>(smem) != L.total || smem > kMaxSmem ||
      reinterpret_cast<uintptr_t>(out) % sizeof(OutT) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = video_transform_kernel<OutT, Mode>;
  if (smem > 48 * 1024) {  // past the default allowance (per device)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + band_rows - 1) / band_rows, static_cast<int>(frames));
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(canvas), static_cast<const int32_t*>(y0),
      static_cast<const int32_t*>(y1), static_cast<const float*>(wy),
      static_cast<const int32_t*>(x0), static_cast<const int32_t*>(x1),
      static_cast<const float*>(wx), static_cast<OutT*>(out), mode, T, Hc,
      Wc, S, band_rows, stage_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaErrorInvalidValue for a plan that is not
// this source's, else cudaGetLastError() (0 = launched). The caller checks
// shapes, types and contiguity; the plan (band_rows, stage_rows, threads,
// smem) comes from ops/resample_cuda.transform_plan, with B*T <= 65535
// (grid.y: a frame each; grid.x: its bands).
extern "C" int zsvc_video_transform_f32(const void* canvas, const void* y0,
                                        const void* y1, const void* wy,
                                        const void* x0, const void* x1,
                                        const void* wx, void* out, int B,
                                        int T, int Hc, int Wc, int S,
                                        int band_rows, int stage_rows,
                                        int threads, int smem,
                                        void* stream) {
  return launch<float>(canvas, y0, y1, wy, x0, x1, wx, out, VideoFrames{}, B,
                       T, Hc, Wc, S, band_rows, stage_rows, threads, smem,
                       stream);
}

extern "C" int zsvc_video_transform_bf16(const void* canvas, const void* y0,
                                         const void* y1, const void* wy,
                                         const void* x0, const void* x1,
                                         const void* wx, void* out, int B,
                                         int T, int Hc, int Wc, int S,
                                         int band_rows, int stage_rows,
                                         int threads, int smem,
                                         void* stream) {
  return launch<__nv_bfloat16>(canvas, y0, y1, wy, x0, x1, wx, out,
                               VideoFrames{}, B, T, Hc, Wc, S, band_rows,
                               stage_rows, threads, smem, stream);
}

// K4, the same contract: images [B, Hc, Wc, 3], taps [B, T, S]; s0..s2 and
// o0..o2 are the per-channel scale and offset; the plan is transform_plan's
// for (B, T, Hc, Wc, S).
extern "C" int zsvc_image_motion_transform_f32(
    const void* images, const void* y0, const void* y1, const void* wy,
    const void* x0, const void* x1, const void* wx, void* out, float s0,
    float s1, float s2, float o0, float o1, float o2, int B, int T, int Hc,
    int Wc, int S, int band_rows, int stage_rows, int threads, int smem,
    void* stream) {
  const ImageMotion mode = {{s0, s1, s2}, {o0, o1, o2}};
  return launch<float>(images, y0, y1, wy, x0, x1, wx, out, mode, B, T, Hc,
                       Wc, S, band_rows, stage_rows, threads, smem, stream);
}

extern "C" int zsvc_image_motion_transform_bf16(
    const void* images, const void* y0, const void* y1, const void* wy,
    const void* x0, const void* x1, const void* wx, void* out, float s0,
    float s1, float s2, float o0, float o1, float o2, int B, int T, int Hc,
    int Wc, int S, int band_rows, int stage_rows, int threads, int smem,
    void* stream) {
  const ImageMotion mode = {{s0, s1, s2}, {o0, o1, o2}};
  return launch<__nv_bfloat16>(images, y0, y1, wy, x0, x1, wx, out, mode, B,
                               T, Hc, Wc, S, band_rows, stage_rows, threads,
                               smem, stream);
}
