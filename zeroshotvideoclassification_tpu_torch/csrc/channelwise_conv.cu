// The channel-wise 3D convolution of X3D on Hopper (sm_90a): forward, data
// gradient and weight gradient, the op ops/channelwise_conv.
// channelwise_conv3d that models/x3d.channelwise takes for each of X3D-M's
// 27 channel-wise convs (groups = C_in = C_out).
//
//   y[n, t, h, w, c] = sum_{dt,dh,dw} x[n, t + dt - PT, h*S + dh - PH,
//                                         w*S + dw - PW, c] * W[c, dt, dh, dw]
//
// x [N, T, H, W, C] and y contiguous (the port's channels-last-3d), W float32
// [C][KT * KH * KW] (the master weight; each kernel rounds it to x's type as
// it loads it, as layers.Conv3d rounds its cast copy). Three shapes, each a
// template instance: (3,3,3) at stride 1 or (1,2,2), padding 1, and the
// stem's (5,1,1) at stride 1, padding (2,0,0). Float32 sums; an output or a
// data-gradient element is rounded to x's type once; the weight gradient
// stays float32.
//
// It replaces no TPU kernel: the JAX package has no X3D. It was written
// because cuDNN's grouped kernels (implicit GEMMs of group width 1, with
// layout transforms on both sides) took 475 of the 593 ms of X3D-M's
// 64-clip train step on an H100, 56x the bound below.
//
// Bound: bytes. A train step moves every operand once in each of three
// passes, forward (x, y), data gradient (dy, dx) and weight gradient (x,
// dy): 148.6 MB a clip in bf16 at X3D-M's 27 shapes, 8.52 ms at 64 clips at
// 3.35 TB/s (benchmark/yardstick/channelwise.py counts the same). The
// arithmetic, 27 float32 multiply-adds an output in each pass, takes about
// half of that at the card's float32 peak, so a design has to (a) read each
// byte from device memory about once and (b) spend few instructions besides
// the multiply-adds: no reduction over channels exists to hide them behind.
//
// DESIGN. A thread owns ONE 32-bit word of channels (2 bf16 or 1 float32,
// so C must be even in bf16) at a tile of RH x RW output positions of one
// clip, and walks the clip's frames once: each source frame's footprint of
// its tile (the rows and columns its taps reach) feeds KT rolling float32
// accumulators, one per output frame that source frame reaches, and after
// each source frame the one output frame that is whole is written, channels
// innermost. So each source word is loaded once per frame (not once per
// temporal tap), and the thread's 27 (or 5) weights per channel stay in
// registers for the whole clip (read once, from a tap-major copy that a
// first small kernel of the call makes, so that a warp reads consecutive
// channels). Neighbouring threads take neighbouring words of a position,
// so a warp's loads and stores are runs of a row's bytes; the halo words a
// thread shares with its neighbours come from L1 and L2, not from device
// memory again. The footprint words reach the thread's OWN staging words in
// shared memory by 4-byte cp.async copies (zero-filled outside the frame:
// the padding), kStages - 1 frames ahead of the products: several frames'
// loads in flight a thread without holding them in registers, and no
// barrier, since no thread reads another's words. The words are the
// vectors: a wider one would take a thread's weights out of registers (27
// x 8 floats at 16 bytes), and a 16-byte vector does not divide X3D's 54-
// and 108-channel rows into aligned pieces. On an H100 the three kernels
// take 23.5 ms at the 64-clip step's 27 shapes, 36% of the bound: issuing
// the multiply-adds and the copies and loads that feed them, with the
// warps that the registers leave, bounds them before the bytes do.
//
//   FORWARD (gather): y from x, stride S in h and w.
//   DATA GRADIENT (the transposed gather): dx[i] = sum_d dy[(i + P - d) / S]
//               W[d] where S divides i + P - d. At stride 1 this is the
//               forward with the kernel flipped; at (1,2,2) an even dx row
//               or column takes one tap of the three, an odd one two. A
//               block's first row and column are multiples of S, so which
//               taps reach which dx position is known at compile time.
//   WEIGHT GRADIENT: dW[c, tap] = sum over n, t, h, w of dy * x shifted by
//               the tap. A block's threads share a slab of channel words
//               and take clips' position tiles in turn (items), each walking
//               the frames with a rolling window of KT dy frames (staged as
//               above, with the x footprint); a thread sums KT*KH*KW float32
//               products per channel in registers. The block adds its
//               threads' sums in a fixed order and writes one float32
//               partial per block (a few hundred blocks); a second kernel
//               adds the partials in a fixed order. No atomics, so two runs
//               agree bit for bit.
//
// Three passes, as the bound counts them: fusing the two gradients would
// read dy once less than benchmark/yardstick/channelwise.py counts.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a weight-gradient block, at most
constexpr int kGatherThreads = 128;  // threads a gather block
constexpr int kMinBlocks = 2;  // blocks an SM holds, at least
constexpr int kStages = 3;  // frames (steps) a thread has in flight
constexpr int kNone = -1000000;

// ---------------------------------------------------------- one word ----

template <typename T>
struct Word;  // one 32-bit word of channels, in float32

template <>
struct Word<float> {
  static constexpr int kVt = 1;
  __device__ static void unpack(uint32_t w, float (&v)[1]) {
    v[0] = __uint_as_float(w);
  }
  __device__ static uint32_t pack(const float (&v)[1]) {
    return __float_as_uint(v[0]);
  }
  __device__ static float round(float w) { return w; }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int kVt = 2;
  __device__ static void unpack(uint32_t w, float (&v)[2]) {
    v[0] = __uint_as_float(w << 16);  // the lower address: channel 2k
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static uint32_t pack(const float (&v)[2]) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static float round(float w) {
    return __bfloat162float(__float2bfloat16_rn(w));
  }
};

// ------------------------------------------------- one spatial axis ----

__host__ __device__ constexpr int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// An axis of kernel K, stride S, padding K / 2 and R outputs a thread. The
// source index that output i of a block takes through tap d, relative to
// the block's source base (kNone where none: the transposed gather's taps
// that S does not divide), the count of source indices a block loads, and
// the base.
template <int K, int S, int R, bool kTr>
struct Axis {
  static constexpr int P = K / 2;
  __host__ __device__ static constexpr int raw(int i, int d) {
    return kTr ? ((i + P - d) % S == 0 ? floor_div(i + P - d, S) : kNone)
               : i * S + d - P;
  }
  __host__ __device__ static constexpr int lo() {
    int m = 1 << 30;
    for (int i = 0; i < R; ++i)
      for (int d = 0; d < K; ++d)
        if (raw(i, d) != kNone && raw(i, d) < m) m = raw(i, d);
    return m;
  }
  __host__ __device__ static constexpr int hi() {
    int m = -(1 << 30);
    for (int i = 0; i < R; ++i)
      for (int d = 0; d < K; ++d)
        if (raw(i, d) != kNone && raw(i, d) > m) m = raw(i, d);
    return m;
  }
  static constexpr int kN = hi() - lo() + 1;
  __host__ __device__ static constexpr int at(int i, int d) {
    return raw(i, d) == kNone ? -1 : raw(i, d) - lo();
  }
  // the first source index a block loads, for its first output o0 (a
  // multiple of S in the transposed gather)
  __device__ static int base(int o0) {
    return (kTr ? o0 / S : o0 * S) + lo();
  }
};

// Sizes of a call: the source (x for the forward and the weight gradient,
// dy for the data gradient) and the output (y, dx; dy for the weight
// gradient), in frames, rows, columns, and 32-bit words a position.
struct Geometry {
  int n, ts, hs, ws;
  int to, ho, wo;
  int cw;
};

// One 4-byte asynchronous copy from device memory into the thread's own
// staging words (zeros where `ok` is false: no byte is read then, and
// `fallback`, a valid address, stands in for the source)
__device__ __forceinline__ void copy_word(uint32_t* dst, const uint32_t* src,
                                          bool ok, const uint32_t* fallback) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(ok ? src : fallback), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of the thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------- the gathers ----

// The weights as the gathers read them: wt[tap][c] = W[c][tap] rounded to
// T's precision (tap-major, so that a warp's threads read consecutive
// channels of a tap)
template <typename T>
__global__ void channelwise_weight_kernel(const float* __restrict__ w,
                                          float* __restrict__ wt, int C,
                                          int taps) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < C * taps) wt[e] = Word<T>::round(w[(e % C) * taps + e / C]);
}

// The forward (kTr false) or the data gradient (kTr true): a thread's
// RH x RW outputs of one channel word, every frame of one clip. A source
// frame's NR x NC footprint words reach the thread's own staging words in
// shared memory by asynchronous copies kStages - 1 frames ahead of the
// products (no barrier: no thread reads another's words), so a thread keeps
// several frames' loads in flight without holding them in registers.
template <typename T, int KT, int KH, int KW, int S, bool kTr, int RH,
          int RW>
__global__ void __launch_bounds__(kGatherThreads, kMinBlocks)
    channelwise_gather_kernel(const uint32_t* __restrict__ src,
                              const float* __restrict__ weight,  // wt
                              uint32_t* __restrict__ out, Geometry g,
                              int hb_count, int wb_count) {
  using Wd = Word<T>;
  using AH = Axis<KH, S, RH, kTr>;
  using AW = Axis<KW, S, RW, kTr>;
  constexpr int VT = Wd::kVt;
  constexpr int PT = KT / 2;
  constexpr int NR = AH::kN, NC = AW::kN;
  constexpr int TAPS = KT * KH * KW;
  // [kStages][NR * NC][blockDim.x]: consecutive threads, consecutive banks
  extern __shared__ uint32_t stage[];

  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int cwi = static_cast<int>(idx % g.cw);
  long long rest = idx / g.cw;
  const int wb = static_cast<int>(rest % wb_count);
  rest /= wb_count;
  const int hb = static_cast<int>(rest % hb_count);
  const int n = static_cast<int>(rest / hb_count);
  if (n >= g.n) return;

  // the weights of the thread's channels, from the tap-major table (one
  // run of a warp's channels a tap)
  float wr[TAPS][VT];
  const float* wc = weight + cwi * VT;
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap) {
    if (VT == 2) {
      const float2 p = __ldg(reinterpret_cast<const float2*>(
          wc + tap * g.cw * VT));
      wr[tap][0] = p.x;
      wr[tap][VT - 1] = p.y;
    } else {
      wr[tap][0] = __ldg(wc + tap * g.cw * VT);
    }
  }

  const int oh0 = hb * RH, ow0 = wb * RW;
  const int row0 = AH::base(oh0), col0 = AW::base(ow0);
  bool row_ok[NR], col_ok[NC];
#pragma unroll
  for (int r = 0; r < NR; ++r)
    row_ok[r] = row0 + r >= 0 && row0 + r < g.hs;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    col_ok[c] = col0 + c >= 0 && col0 + c < g.ws;

  const int src_row = g.ws * g.cw, out_row = g.wo * g.cw;
  const long long src_frame = static_cast<long long>(g.hs) * src_row;
  const long long out_frame = static_cast<long long>(g.ho) * out_row;
  const uint32_t* sp = src + static_cast<long long>(n) * g.ts * src_frame +
                       static_cast<long long>(row0) * src_row +
                       static_cast<long long>(col0) * g.cw + cwi;
  uint32_t* op = out + static_cast<long long>(n) * g.to * out_frame +
                 static_cast<long long>(oh0) * out_row +
                 static_cast<long long>(ow0) * g.cw + cwi;
  const int nt = blockDim.x;
  uint32_t* mine = stage + threadIdx.x;

  // frame t's words into stage t % kStages, as one group (empty past the
  // last frame, so that every step commits one)
  auto issue = [&](int t) {
    if (t < g.ts) {
      const uint32_t* fp = sp + t * src_frame;
      uint32_t* st = mine + (t % kStages) * (NR * NC) * nt;
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          copy_word(st + (r * NC + c) * nt, fp + (r * src_row + c * g.cw),
                    row_ok[r] && col_ok[c], src);
    }
    copy_commit();
  };

  float acc[KT][RH][RW][VT];
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int i = 0; i < RH; ++i)
#pragma unroll
      for (int k = 0; k < RW; ++k)
#pragma unroll
        for (int v = 0; v < VT; ++v) acc[j][i][k][v] = 0.0f;

#pragma unroll
  for (int t = 0; t + 1 < kStages; ++t) issue(t);
  // source frame t feeds output frames t + PT - (KT - 1) .. t + PT: acc[j]
  // is output frame t + PT - (KT - 1) + j; after frame t, acc[0] is whole
  const int t_end = g.to + KT - 1 - PT;
  for (int t = 0; t < t_end; ++t) {
    issue(t + kStages - 1);
    copy_wait<kStages - 1>();  // frame t has landed
    if (t < g.ts) {
      const uint32_t* st = mine + (t % kStages) * (NR * NC) * nt;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float xv[NC][VT];
#pragma unroll
        for (int c = 0; c < NC; ++c) Wd::unpack(st[(r * NC + c) * nt], xv[c]);
#pragma unroll
        for (int i = 0; i < RH; ++i)
#pragma unroll
          for (int dh = 0; dh < KH; ++dh) {
            if (AH::at(i, dh) != r) continue;
#pragma unroll
            for (int k = 0; k < RW; ++k)
#pragma unroll
              for (int dw = 0; dw < KW; ++dw) {
                const int c = AW::at(k, dw);
                if (c < 0) continue;
#pragma unroll
                for (int dt = 0; dt < KT; ++dt) {
                  const int j = kTr ? dt : KT - 1 - dt;
                  const int tap = (dt * KH + dh) * KW + dw;
#pragma unroll
                  for (int v = 0; v < VT; ++v)
                    acc[j][i][k][v] =
                        fmaf(xv[c][v], wr[tap][v], acc[j][i][k][v]);
                }
              }
          }
      }
    }
    const int to = t + PT - (KT - 1);
    if (to >= 0) {
      uint32_t* fo = op + to * out_frame;
#pragma unroll
      for (int i = 0; i < RH; ++i)
#pragma unroll
        for (int k = 0; k < RW; ++k)
          if (oh0 + i < g.ho && ow0 + k < g.wo)
            fo[i * out_row + k * g.cw] = Wd::pack(acc[0][i][k]);
    }
#pragma unroll
    for (int j = 0; j + 1 < KT; ++j)
#pragma unroll
      for (int i = 0; i < RH; ++i)
#pragma unroll
        for (int k = 0; k < RW; ++k)
#pragma unroll
          for (int v = 0; v < VT; ++v) acc[j][i][k][v] = acc[j + 1][i][k][v];
#pragma unroll
    for (int i = 0; i < RH; ++i)
#pragma unroll
      for (int k = 0; k < RW; ++k)
#pragma unroll
        for (int v = 0; v < VT; ++v) acc[KT - 1][i][k][v] = 0.0f;
  }
}

// ------------------------------------------------ the weight gradient ----

// Stage 1: a block of `lanes` x `csw` threads, channel words blockIdx.y *
// csw + (threadIdx.x % csw); lane l takes items l + lanes * (blockIdx.x +
// gridDim.x * m), an item being RH x RW dy positions of one clip over every
// frame. partial[blockIdx.x][c][tap] = the block's sums, its lanes added in
// lane order. Dynamic shared memory: the threads' staging words
// ([kStages][NR * NC + RH * RW][blockDim.x]: step t's x footprint and its
// newest dy words, kStages - 1 steps ahead), then csw * VT * TAPS floats
// for the lanes' sums.
template <typename T, int KT, int KH, int KW, int S, int RH, int RW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    channelwise_wgrad_kernel(const uint32_t* __restrict__ x,
                             const uint32_t* __restrict__ dy,
                             float* __restrict__ partial, Geometry g,
                             int hb_count, int wb_count, int csw) {
  using Wd = Word<T>;
  using AH = Axis<KH, S, RH, false>;
  using AW = Axis<KW, S, RW, false>;
  constexpr int VT = Wd::kVt;
  constexpr int PT = KT / 2;
  constexpr int NR = AH::kN, NC = AW::kN;
  constexpr int TAPS = KT * KH * KW;
  constexpr int kWords = NR * NC + RH * RW;
  extern __shared__ uint32_t stage[];
  float* red = reinterpret_cast<float*>(stage + kStages * kWords * blockDim.x);

  const int lanes = blockDim.x / csw;
  const int lane = threadIdx.x / csw;
  const int cl = threadIdx.x % csw;
  const int cwi = blockIdx.y * csw + cl;
  const long long items = static_cast<long long>(g.n) * hb_count * wb_count;
  const int nt = blockDim.x;
  uint32_t* mine = stage + threadIdx.x;

  float acc[TAPS][VT];
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
    for (int v = 0; v < VT; ++v) acc[tap][v] = 0.0f;

  const int x_row = g.ws * g.cw, dy_row = g.wo * g.cw;
  const long long x_frame = static_cast<long long>(g.hs) * x_row;
  const long long dy_frame = static_cast<long long>(g.ho) * dy_row;
  if (cwi < g.cw) {
    for (long long item = static_cast<long long>(blockIdx.x) * lanes + lane;
         item < items; item += static_cast<long long>(gridDim.x) * lanes) {
      const int wb = static_cast<int>(item % wb_count);
      const long long rest = item / wb_count;
      const int hb = static_cast<int>(rest % hb_count);
      const int n = static_cast<int>(rest / hb_count);
      const int oh0 = hb * RH, ow0 = wb * RW;
      const int row0 = AH::base(oh0), col0 = AW::base(ow0);
      bool row_ok[NR], col_ok[NC], pos_ok[RH][RW];
#pragma unroll
      for (int r = 0; r < NR; ++r)
        row_ok[r] = row0 + r >= 0 && row0 + r < g.hs;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        col_ok[c] = col0 + c >= 0 && col0 + c < g.ws;
#pragma unroll
      for (int i = 0; i < RH; ++i)
#pragma unroll
        for (int k = 0; k < RW; ++k)
          pos_ok[i][k] = oh0 + i < g.ho && ow0 + k < g.wo;
      const uint32_t* xp = x + static_cast<long long>(n) * g.ts * x_frame +
                           static_cast<long long>(row0) * x_row +
                           static_cast<long long>(col0) * g.cw + cwi;
      const uint32_t* dp = dy + static_cast<long long>(n) * g.to * dy_frame +
                           static_cast<long long>(oh0) * dy_row +
                           static_cast<long long>(ow0) * g.cw + cwi;
      // step t (from -PT): x frame t (t >= 0) and dy frame t + PT into
      // stage (t + PT) % kStages, one group a step
      auto issue = [&](int t) {
        if (t < g.ts) {
          uint32_t* st = mine + ((t + PT) % kStages) * kWords * nt;
          if (t >= 0) {
            const uint32_t* fp = xp + t * x_frame;
#pragma unroll
            for (int r = 0; r < NR; ++r)
#pragma unroll
              for (int c = 0; c < NC; ++c)
                copy_word(st + (r * NC + c) * nt,
                          fp + (r * x_row + c * g.cw),
                          row_ok[r] && col_ok[c], x);
          }
          const int tn = t + PT;
          const uint32_t* dq = dp + tn * dy_frame;
#pragma unroll
          for (int i = 0; i < RH; ++i)
#pragma unroll
            for (int k = 0; k < RW; ++k)
              copy_word(st + (NR * NC + i * RW + k) * nt,
                        dq + (i * dy_row + k * g.cw),
                        tn < g.to && pos_ok[i][k], dy);
        }
        copy_commit();
      };
      // win[j]: dy frame t + PT - (KT - 1) + j, zero outside [0, to)
      float win[KT][RH][RW][VT];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int i = 0; i < RH; ++i)
#pragma unroll
          for (int k = 0; k < RW; ++k)
#pragma unroll
            for (int v = 0; v < VT; ++v) win[j][i][k][v] = 0.0f;
#pragma unroll
      for (int s = 0; s + 1 < kStages; ++s) issue(s - PT);
      for (int t = -PT; t < g.ts; ++t) {
        issue(t + kStages - 1);
        copy_wait<kStages - 1>();  // step t has landed
        const uint32_t* st = mine + ((t + PT) % kStages) * kWords * nt;
#pragma unroll
        for (int j = 0; j + 1 < KT; ++j)
#pragma unroll
          for (int i = 0; i < RH; ++i)
#pragma unroll
            for (int k = 0; k < RW; ++k)
#pragma unroll
              for (int v = 0; v < VT; ++v)
                win[j][i][k][v] = win[j + 1][i][k][v];
#pragma unroll
        for (int i = 0; i < RH; ++i)
#pragma unroll
          for (int k = 0; k < RW; ++k)
            Wd::unpack(st[(NR * NC + i * RW + k) * nt], win[KT - 1][i][k]);
        if (t < 0) continue;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          float xv[NC][VT];
#pragma unroll
          for (int c = 0; c < NC; ++c)
            Wd::unpack(st[(r * NC + c) * nt], xv[c]);
#pragma unroll
          for (int i = 0; i < RH; ++i)
#pragma unroll
            for (int dh = 0; dh < KH; ++dh) {
              if (AH::at(i, dh) != r) continue;
#pragma unroll
              for (int k = 0; k < RW; ++k)
#pragma unroll
                for (int dw = 0; dw < KW; ++dw) {
                  const int c = AW::at(k, dw);
#pragma unroll
                  for (int dt = 0; dt < KT; ++dt) {
                    const int tap = (dt * KH + dh) * KW + dw;
#pragma unroll
                    for (int v = 0; v < VT; ++v)
                      acc[tap][v] = fmaf(xv[c][v], win[KT - 1 - dt][i][k][v],
                                         acc[tap][v]);
                  }
                }
            }
        }
      }
    }
  }
  // the block's lanes, added in lane order
  for (int l = 0; l < lanes; ++l) {
    if (lane == l) {
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
        for (int v = 0; v < VT; ++v) {
          float* s = red + (cl * VT + v) * TAPS + tap;
          *s = l == 0 ? acc[tap][v] : __fadd_rn(*s, acc[tap][v]);
        }
    }
    __syncthreads();
  }
  const int C = g.cw * VT;
  const int c0 = blockIdx.y * csw * VT;
  float* pb = partial + static_cast<long long>(blockIdx.x) * C * TAPS;
  for (int e = threadIdx.x; e < csw * VT * TAPS; e += blockDim.x) {
    if (c0 + e / TAPS < C) pb[c0 * TAPS + e] = red[e];
  }
}

// Stage 2: out[e] = sum over p of partial[p][e], p in order, for every e
// of [C][TAPS]
__global__ void channelwise_wgrad_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int elems,
    int parts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  float s = 0.0f;
  for (int p = 0; p < parts; ++p)
    s = __fadd_rn(s, partial[static_cast<long long>(p) * elems + e]);
  out[e] = s;
}

// ------------------------------------------------------------ launch ----

// kind 0: (3,3,3) stride 1; 1: (3,3,3) stride (1,2,2); 2: (5,1,1) stride 1.
// The tile (RH, RW) a thread takes per kind: the mirror of
// ops/channelwise_conv.TILES, which the wrapper passes and this file checks.
// The transposed gather's tile at stride 2 is a multiple of 2 both ways.
constexpr int kFwdTiles[3][2] = {{2, 4}, {1, 4}, {2, 4}};
constexpr int kDgradTiles[3][2] = {{2, 4}, {2, 4}, {2, 4}};
constexpr int kWgradTiles[3][2] = {{2, 4}, {1, 4}, {2, 4}};

// Let `kernel` take `bytes` of dynamic shared memory (past the default 48
// KiB only by asking, once per kernel and device: all the card allows, so
// that no later call, one inside a CUDA graph's capture among them, asks
// again); false where the card has less. `most`, the kernel's own, holds
// per device the limit once asked, else 0.
template <typename K>
bool allow_smem(K kernel, size_t bytes, int (&most)[64]) {
  if (bytes <= 48 * 1024) return true;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return false;
  if (most[dev] == 0) {
    int limit = 0;
    if (cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit) != cudaSuccess)
      return false;
    most[dev] = limit;
  }
  return bytes <= static_cast<size_t>(most[dev]);
}

bool geometry_ok(const Geometry& g, int kind, bool transposed) {
  if (g.n < 1 || g.ts < 1 || g.hs < 1 || g.ws < 1 || g.to != g.ts ||
      g.ho < 1 || g.wo < 1 || g.cw < 1 || kind < 0 || kind > 2)
    return false;
  const int s = kind == 1 ? 2 : 1;
  const int kh = kind == 2 ? 1 : 3;
  const int p = kh / 2;
  // the source rows and columns of the output's (or, transposed, of the
  // input's) forward conv
  const int big_h = transposed ? g.ho : g.hs, big_w = transposed ? g.wo : g.ws;
  const int small_h = transposed ? g.hs : g.ho;
  const int small_w = transposed ? g.ws : g.wo;
  return (big_h + 2 * p - kh) / s + 1 == small_h &&
         (big_w + 2 * p - kh) / s + 1 == small_w;
}

template <typename T, int KT, int KH, int KW, int S, bool kTr, int RH,
          int RW>
int launch_gather(const void* src, const void* weight, void* out,
                  const Geometry& g, cudaStream_t stream) {
  constexpr int NR = Axis<KH, S, RH, kTr>::kN, NC = Axis<KW, S, RW, kTr>::kN;
  const int hb = (g.ho + RH - 1) / RH, wb = (g.wo + RW - 1) / RW;
  const long long threads = static_cast<long long>(g.n) * hb * wb * g.cw;
  const long long blocks = (threads + kGatherThreads - 1) / kGatherThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) * kStages * NR * NC * kGatherThreads;
  auto kernel = channelwise_gather_kernel<T, KT, KH, KW, S, kTr, RH, RW>;
  static int most[64];
  if (!allow_smem(kernel, smem, most))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kGatherThreads, smem, stream>>>(
      static_cast<const uint32_t*>(src), static_cast<const float*>(weight),
      static_cast<uint32_t*>(out), g, hb, wb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gather(const void* src, const void* weight, void* wt_, void* out,
           Geometry g, int kind, int transposed, int rh, int rw,
           void* stream) {
  if (!geometry_ok(g, kind, transposed != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int(*tiles)[2] = transposed ? kDgradTiles : kFwdTiles;
  if (rh != tiles[kind][0] || rw != tiles[kind][1])
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(src) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(wt_) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = g.cw * Word<T>::kVt, taps = kind == 2 ? 5 : 27;
  float* wt = static_cast<float*>(wt_);
  channelwise_weight_kernel<T><<<(C * taps + kThreads - 1) / kThreads,
                                 kThreads, 0, s>>>(
      static_cast<const float*>(weight), wt, C, taps);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  weight = wt;
  if (!transposed) {
    switch (kind) {
      case 0:
        return launch_gather<T, 3, 3, 3, 1, false, kFwdTiles[0][0],
                             kFwdTiles[0][1]>(src, weight, out, g, s);
      case 1:
        return launch_gather<T, 3, 3, 3, 2, false, kFwdTiles[1][0],
                             kFwdTiles[1][1]>(src, weight, out, g, s);
      default:
        return launch_gather<T, 5, 1, 1, 1, false, kFwdTiles[2][0],
                             kFwdTiles[2][1]>(src, weight, out, g, s);
    }
  }
  switch (kind) {
    case 0:
      return launch_gather<T, 3, 3, 3, 1, true, kDgradTiles[0][0],
                           kDgradTiles[0][1]>(src, weight, out, g, s);
    case 1:
      return launch_gather<T, 3, 3, 3, 2, true, kDgradTiles[1][0],
                           kDgradTiles[1][1]>(src, weight, out, g, s);
    default:
      return launch_gather<T, 5, 1, 1, 1, true, kDgradTiles[2][0],
                           kDgradTiles[2][1]>(src, weight, out, g, s);
  }
}

template <typename T, int KT, int KH, int KW, int S, int RH, int RW>
int launch_wgrad(const void* x, const void* dy, float* partial, float* out,
                 const Geometry& g, int csw, int lanes, int parts,
                 cudaStream_t stream) {
  constexpr int TAPS = KT * KH * KW;
  constexpr int VT = Word<T>::kVt;
  const int hb = (g.ho + RH - 1) / RH, wb = (g.wo + RW - 1) / RW;
  constexpr int kWords = Axis<KH, S, RH, false>::kN *
                             Axis<KW, S, RW, false>::kN + RH * RW;
  const int slabs = (g.cw + csw - 1) / csw;
  const size_t smem = sizeof(uint32_t) * kStages * kWords * csw * lanes +
                      sizeof(float) * csw * VT * TAPS;
  auto kernel = channelwise_wgrad_kernel<T, KT, KH, KW, S, RH, RW>;
  static int most[64];
  if (!allow_smem(kernel, smem, most))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(parts, slabs), csw * lanes, smem, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(dy),
      partial, g, hb, wb, csw);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int elems = g.cw * VT * TAPS;
  channelwise_wgrad_reduce_kernel<<<(elems + kThreads - 1) / kThreads,
                                    kThreads, 0, stream>>>(partial, out,
                                                           elems, parts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int wgrad(const void* x, const void* dy, void* partial, void* out, Geometry g,
          int kind, int rh, int rw, int csw, int lanes, int parts,
          void* stream) {
  if (!geometry_ok(g, kind, false) || rh != kWgradTiles[kind][0] ||
      rw != kWgradTiles[kind][1] || csw < 1 || lanes < 1 ||
      csw * lanes > kThreads || parts < 1 || parts > 65535 ||
      (g.cw + csw - 1) / csw > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(dy) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  switch (kind) {
    case 0:
      return launch_wgrad<T, 3, 3, 3, 1, kWgradTiles[0][0],
                          kWgradTiles[0][1]>(x, dy, pt, o, g, csw, lanes,
                                             parts, s);
    case 1:
      return launch_wgrad<T, 3, 3, 3, 2, kWgradTiles[1][0],
                          kWgradTiles[1][1]>(x, dy, pt, o, g, csw, lanes,
                                             parts, s);
    default:
      return launch_wgrad<T, 5, 1, 1, 1, kWgradTiles[2][0],
                          kWgradTiles[2][1]>(x, dy, pt, o, g, csw, lanes,
                                             parts, s);
  }
}

Geometry make_geometry(int n, int ts, int hs, int ws, int to, int ho, int wo,
                       int cw) {
  Geometry g;
  g.n = n; g.ts = ts; g.hs = hs; g.ws = ws;
  g.to = to; g.ho = ho; g.wo = wo; g.cw = cw;
  return g;
}

}  // namespace

// The forward (transposed 0: y from x) or the data gradient (transposed 1:
// dx from dy) on `stream`. src [n][ts][hs][ws][cw words] and out
// [n][to][ho][wo][cw words], contiguous, 4-byte aligned; weight float32
// [C][taps] (C = cw words x the channels a word holds), wt float32
// [taps][C] scratch (8-byte aligned) for its rounded, tap-major copy, made
// by a first small kernel of the call. kind as above;
// (rh, rw) the tile the wrapper planned, checked against this file's.
// Returns cudaErrorInvalidValue for sizes, a tile or pointers that fail,
// else cudaGetLastError() (0 = launched).
extern "C" int zsvc_channelwise_gather_f32(
    const void* src, const void* weight, void* wt, void* out, int n, int ts,
    int hs, int ws, int to, int ho, int wo, int cw, int kind, int transposed,
    int rh, int rw, void* stream) {
  return gather<float>(src, weight, wt, out,
                       make_geometry(n, ts, hs, ws, to, ho, wo, cw), kind,
                       transposed, rh, rw, stream);
}

extern "C" int zsvc_channelwise_gather_bf16(
    const void* src, const void* weight, void* wt, void* out, int n, int ts,
    int hs, int ws, int to, int ho, int wo, int cw, int kind, int transposed,
    int rh, int rw, void* stream) {
  return gather<__nv_bfloat16>(src, weight, wt, out,
                               make_geometry(n, ts, hs, ws, to, ho, wo, cw),
                               kind, transposed, rh, rw, stream);
}

// The weight gradient on `stream`: stage 1 into `partial` (float32
// [parts][C][taps]), stage 2 into `out` (float32 [C][taps]). x [n][ts][hs]
// [ws][cw], dy [n][to][ho][wo][cw], contiguous, 4-byte aligned; (rh, rw)
// checked as above; blocks of lanes x csw threads over ceil(cw / csw) slabs
// of words and `parts` blocks of items.
extern "C" int zsvc_channelwise_wgrad_f32(
    const void* x, const void* dy, void* partial, void* out, int n, int ts,
    int hs, int ws, int to, int ho, int wo, int cw, int kind, int rh, int rw,
    int csw, int lanes, int parts, void* stream) {
  return wgrad<float>(x, dy, partial, out,
                      make_geometry(n, ts, hs, ws, to, ho, wo, cw), kind, rh,
                      rw, csw, lanes, parts, stream);
}

extern "C" int zsvc_channelwise_wgrad_bf16(
    const void* x, const void* dy, void* partial, void* out, int n, int ts,
    int hs, int ws, int to, int ho, int wo, int cw, int kind, int rh, int rw,
    int csw, int lanes, int parts, void* stream) {
  return wgrad<__nv_bfloat16>(x, dy, partial, out,
                              make_geometry(n, ts, hs, ws, to, ho, wo, cw),
                              kind, rh, rw, csw, lanes, parts, stream);
}
