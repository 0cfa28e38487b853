// The whole ARSNN sampler scan, forward only: both depth-stacked k x k
// conv stacks (input: events -> 2C, gate: previous spikes -> 2C) computed
// inside the kernel as f32 stencils, then the gated LIF update, Heaviside
// spike, soft or hard reset, the no-reset integral, the slot counter and
// last-spike time, the slot writes, and at the last micro-step the residual
// write, zeros in the slots left unwritten, and use_abs. C = Cin = 2, 2C = 4 conv outputs, depth 1 or 2, odd
// ksize <= 7.
//
// Replaces: eas_snn_tpu/ops/arsnn_pallas.py:_v2_kernel (pallas_call at
// :579, via arsnn_fused_v2). The TPU kernel ran a sequential grid (N, Tm)
// and kept one batch element's whole state (5 planes x 2 channels of
// H x W) resident in VMEM across its Tm steps. Hopper's blocks run in no
// order and hold at most 227 KB of shared memory, far less than one
// element's 3.3 MB of state at 256x320, and the recurrence couples
// neighbours (step t's gate stack reads step t-1's spikes over a
// (2 * depth * (k/2) + 1)^2 window). So here:
//
// * one launch per micro-step (Tm launches a forward); the grid covers
//   (32x32 pixel tiles, N); the state lives in device memory between the
//   launches: membrane and no-reset integral in f32, slot counter and
//   last-spike time in int8, spikes in u8, double-buffered so that every
//   block of step t reads step t-1's spikes. One launch for the whole
//   scan would need a halo that grows by depth * (k/2) px a step: at Tm 4
//   step 0 would be computed over (32 + 24)^2 px for every 32^2 px tile,
//   about twice the stencil work on average against ~0.4 ms of state
//   traffic saved, and this kernel is bound by its stencils;
// * each block stages its tile of the step's event planes and of the
//   previous spikes in shared memory as f32, with a depth * (k/2) px halo
//   (zero outside the image): every thread issues all its global loads
//   before its first shared store, so their latencies overlap, and the
//   weights come in by cp.async;
// * it computes the first layer of both stacks over the tile plus a k/2
//   halo into shared memory (ReLU, and 0 at positions outside the image:
//   the intermediate layer's zero padding), then the second layer over
//   the tile in registers, and runs the elementwise chain there. While the
//   second layer runs, cp.async brings the tile's state into the staged
//   planes' shared memory (depth 2, W a multiple of 4), so the chain waits
//   on no load;
// * a thread owns strips of 4 adjacent outputs and all 4 output channels:
//   it reads each input row segment with 16-byte shared loads and the 4
//   channels' weights of a tap with one broadcast 16-byte load, and keeps
//   its 16 sums in registers: one second-layer strip of each stack, and
//   the first layer's 36x36 region (at k 5) in 648 strips, 3 rounds of
//   256 (other blocks fill the idle lanes of the last). 72 KB of shared
//   memory and at most 80 registers a thread: 3 blocks an SM (a 64x32
//   tile, 2 blocks an SM, cut the halo from 27% to 20% of the first layer
//   but ran slower: the kernel is latency-bound, not issue-bound);
// * at t = 0 the gate stack sees zero spikes, and a sum plus w * 0 is the
//   sum itself unless it is -0: where no gate bias is -0, its first layer
//   is relu(bias) in the image and its second layer one constant a
//   channel wherever the window lies in the image (4 threads sum it in
//   the same order), so the kernel skips those stencils and gives the
//   same bits;
// * state moves as 16-byte (f32) and 4-byte (int8, u8) vectors where W is
//   a multiple of 4; every slot is written once: when its pixel spikes, or
//   at the last launch, which writes the residual and zeros in the slots
//   left over, applies use_abs and writes no state.
//
// Arithmetic: the stencils are fused multiply-adds (__fmaf_rn, one
// rounding each; nvcc would contract a * b + c on its own, so the
// intrinsic states it) in the JAX kernel's order: bias, then dy, ci, dx
// for each output channel. The elementwise chain rounds every operation
// on its own (_rn intrinsics, no contraction), the sigmoid as
// 1 / (1 + expf(-x)) (ops/arsnn_fused.py:sigmoid). The slots equal the
// plain version (ops/arsnn_fused.py:arsnn_fused_v2_plain, whose stencils
// emulate each FMA exactly with fma_f32) bit for bit.
//
// Bound on the H100: operations. Per pixel and step the two stacks take
// (Cin*2C + (depth-1)*2C*2C + C*2C + (depth-1)*2C*2C) * k^2 multiply-adds,
// 1,200 at the flagship (depth 2, k 5): ~100 GFLOP a forward at B=128
// (256x320, Tm 4), ~1.53 ms at 67 TFLOP/s (FMA), against ~0.13 ms to move
// the bf16 events in and the f32 slots out. With the first layer's halo
// this kernel does 1,306 multiply-adds a pixel and step (about 1,140 on
// average over Tm 4, with the zero-spike gate stack skipped at t = 0).
#include "common.cuh"

namespace {

constexpr int TH = 32, TW = 32, THREADS = 256;
constexpr int STRIPS_PER_ROW = TW / 4;  // 8 strips x 32 rows = 256 threads
constexpr int MIN_BLOCKS = 3;           // blocks an SM

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int K, int DEPTH>
struct Geo {
  static constexpr int P = K / 2;
  static constexpr int R = DEPTH * P;       // halo of the staged planes
  static constexpr int L1 = (DEPTH - 1) * P;  // halo of the first layer
  static constexpr int NV = (K + 6) / 4;   // 4-float groups a strip row
  // first layer's output region (for depth 1: the tile)
  static constexpr int OH = TH + 2 * L1;
  static constexpr int OW = DEPTH == 2
      ? round4(imax(TW + 2 * L1, TW + 4 * (NV - 1))) : TW;
  // staged input planes
  static constexpr int IH = OH + 2 * P;
  static constexpr int IW = round4(OW + 4 * (NV - 1));
  static constexpr int W1 = 2 * K * K;                   // float4s, layer 1
  static constexpr int W2 = DEPTH == 2 ? 4 * K * K : 0;  // float4s, layer 2
  static constexpr int MID = DEPTH == 2 ? 4 * OH * OW : 0;
  // a tile's state, membrane and integral [2][TH][TW] f32, slot counter
  // and last-spike time [2][TH][TW] int8, goes into the staged planes'
  // shared memory at depth 2 where it fits (not at ksize 1)
  static constexpr bool STATE_SMEM =
      DEPTH == 2 &&
      2 * (2 * TH * TW * 4) + 2 * (2 * TH * TW) <= (int)sizeof(float) * 4 *
                                                        IH * IW;
  // weights, biases, the zero-spike gate sums, both first-layer outputs,
  // the event and spike planes (f32)
  static constexpr size_t BYTES =
      sizeof(float4) * 2 * (W1 + W2) +
      sizeof(float) * (8 * DEPTH + 4 + 2 * MID + 4 * IH * IW);
};

struct Args {
  const void* ev;  // (Tm, N, 2, H, W), E
  const float* iw; const float* ib; const float* gw; const float* gb;
  float* out;      // (Ts, N, 2, H, W)
  float* vmem; float* vavg;     // (N, 2, H, W)
  int8_t* seg; int8_t* tlast;   // (N, 2, H, W)
  const uint8_t* sp_prev; uint8_t* sp_next;  // (N, 2, H, W)
  int N, H, W, Tm, Ts, t;
  float th, vreset;
  int hard, readout, write_zero, use_abs;
};

__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// CB (4 or 16) bytes global -> shared; ok = false zero-fills.
template <int CB>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

// acc[co][j] = b[co] + sum over (dy, ci, dx) of w[co][ci][dy][dx] *
// in[ci][r + dy][c + j + dx], in that order, one FMA a term, for the
// strip of 4 outputs at (r, c) of the output region (c a multiple of 4);
// `in` holds CI planes of BW floats a row, its (0, 0) the tap (0, 0) of
// output (0, 0).
template <int K, int CI, int BW>
__device__ __forceinline__ void conv_strip(const float* __restrict__ in,
                                           int plane, int r, int c,
                                           const float4* __restrict__ w,
                                           const float* __restrict__ b,
                                           float acc[4][4]) {
  constexpr int NV = (K + 6) / 4;
#pragma unroll
  for (int co = 0; co < 4; ++co)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[co][j] = b[co];
#pragma unroll 1
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int ci = 0; ci < CI; ++ci) {
      const float4* row = reinterpret_cast<const float4*>(
          in + ci * plane + (r + dy) * BW + c);
      float x[4 * NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 q = row[v];
        x[4 * v] = q.x; x[4 * v + 1] = q.y; x[4 * v + 2] = q.z;
        x[4 * v + 3] = q.w;
      }
      const float4* wr = w + (ci * K + dy) * K;
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float4 q = wr[dx];
        const float wc[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int co = 0; co < 4; ++co)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[co][j] = __fmaf_rn(wc[co], x[j + dx], acc[co][j]);
      }
    }
  }
}

// One layer's OIHW weights (4 outputs, CI inputs) as [ci][dy][dx] float4s
// over the output channel, and its 4 biases, by cp.async: no thread waits
// on these loads before the block's first barrier.
template <int K>
__device__ __forceinline__ void stage_weights(const float* __restrict__ w,
                                              const float* __restrict__ b,
                                              int CI, float4* ws, float* bs) {
  // w[co][ci][dy][dx] flat at i = co * CI*K*K + (ci*K*K + tap)
  for (int i = threadIdx.x; i < 4 * CI * K * K; i += THREADS) {
    const int co = i / (CI * K * K), rem = i - co * (CI * K * K);
    cp_async<4>(reinterpret_cast<float*>(ws + rem) + co, w + i, true);
  }
  if (threadIdx.x < 4) cp_async<4>(bs + threadIdx.x, b + threadIdx.x, true);
}

// One pixel and channel of the elementwise chain: the gate and current
// from the stacks' sums, the state update, the slot write (and at the
// last step the residual). Returns the spike.
__device__ __forceinline__ bool chain(const Args& a, float gi, float gg,
                                      float ci, float cg, float& vm,
                                      float& va, int& sg, int& tl,
                                      long long idx, bool last) {
  const float g = __fadd_rn(gi, gg);
  const float gate = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
  const float cur = __fadd_rn(ci, cg);
  const float v = __fadd_rn(__fmul_rn(gate, vm), cur);
  const bool s = __fsub_rn(v, a.th) > 0.f;
  const float sf = s ? 1.f : 0.f;
  const float v_after =
      a.hard ? __fadd_rn(__fmul_rn(v, __fsub_rn(1.f, sf)),
                         __fmul_rn(a.vreset, sf))
             : __fsub_rn(v, __fmul_rn(a.th, sf));
  va = __fadd_rn(va, v);
  const long long slot = (long long)a.N * 2 * a.H * a.W;  // one slot's size
  if (s && sg < a.Ts) {
    float w = a.readout == 0 ? va : v_after;
    if (a.readout == 2)
      w = __fdiv_rn(va, fmaxf(__fsub_rn((float)a.t, (float)tl), 1.f));
    w = __fadd_rn(0.f, w);
    a.out[sg * slot + idx] = a.use_abs ? relu(w) : w;
    ++sg;
    tl = a.t;
  }
  if (s) va = 0.f;
  if (last) {
    int z = sg;  // the first slot the scan leaves unwritten
    if (!s && sg < a.Ts) {
      // residual write for an element whose last slot never closed
      float w = a.readout == 0 ? va : v_after;
      if (a.readout == 2)
        w = __fdiv_rn(va,
                      fmaxf(__fsub_rn((float)(a.Tm - 1), (float)tl), 1.f));
      if (a.write_zero) w = __fmul_rn(w, 0.f);
      w = __fadd_rn(0.f, w);
      a.out[sg * slot + idx] = a.use_abs ? relu(w) : w;
      ++z;
    }
    for (; z < a.Ts; ++z) a.out[z * slot + idx] = 0.f;
  }
  vm = v_after;
  return s;
}

// Whether none of the n values is -0.
__device__ __forceinline__ bool no_neg_zero(const float* v, int n) {
  bool ok = true;
  for (int i = 0; i < n; ++i) ok = ok && __float_as_uint(v[i]) != 0x80000000u;
  return ok;
}

__device__ __forceinline__ long long plane_idx(const Args& a, int n, int ch,
                                               int y, int x) {
  return ((long long)n * 2 + ch) * a.H * a.W + (long long)y * a.W + x;
}

// The tile's state (rows y0.., columns x0.. of both channels) into shared
// memory with cp.async: membrane and integral [2][TH][TW] f32 in 16-byte
// copies, then slot counter and last-spike time [2][TH][TW] int8 in 4-byte
// copies; groups of 4 pixels outside the image zero-fill (W is a multiple
// of 4).
__device__ __forceinline__ void fetch_state(const Args& a, int n, int y0,
                                            int x0, unsigned char* st) {
  constexpr int GROUPS = 2 * TH * TW / 4;  // 4-pixel groups, both channels
  for (int q = threadIdx.x; q < 2 * GROUPS; q += THREADS) {
    const int arr = q / GROUPS, g = q % GROUPS;  // arr 0 vmem, 1 vavg
    const int ch = g / (TH * TW / 4), rem = g % (TH * TW / 4);
    const int y = y0 + rem / (TW / 4), x = x0 + (rem % (TW / 4)) * 4;
    const bool ok = y < a.H && x < a.W;
    const float* src = (arr ? a.vavg : a.vmem) +
                       (ok ? plane_idx(a, n, ch, y, x) : 0);
    cp_async<16>(st + 16 * q, src, ok);
  }
  unsigned char* st8 = st + 2 * 2 * TH * TW * 4;
  for (int q = threadIdx.x; q < 2 * GROUPS; q += THREADS) {
    const int arr = q / GROUPS, g = q % GROUPS;  // arr 0 seg, 1 tlast
    const int ch = g / (TH * TW / 4), rem = g % (TH * TW / 4);
    const int y = y0 + rem / (TW / 4), x = x0 + (rem % (TW / 4)) * 4;
    const bool ok = y < a.H && x < a.W;
    const int8_t* src = (arr ? a.tlast : a.seg) +
                        (ok ? plane_idx(a, n, ch, y, x) : 0);
    cp_async<4>(st8 + 4 * q, src, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The chain for the 4 pixels x .. x + 3 of row y, both channels, from the
// stacks' sums of those pixels (ii / ig [co][j]: channels 0-1 gate, 2-3
// current). Where W is a multiple of 4 and the 4 pixels lie in the image,
// state moves as vectors: read from `st` (the tile's state in shared
// memory, at the strip's offset `o` into each [2][TH][TW] array) or,
// where `st` is null, from device memory; else pixel by pixel.
__device__ __forceinline__ void chain4(const Args& a, int n, int y, int x,
                                       const unsigned char* st, int o,
                                       const float (&ii)[4][4],
                                       const float (&ig)[4][4]) {
  const bool first = a.t == 0, last = a.t == a.Tm - 1;
  if (a.W % 4 == 0 && x + 3 < a.W) {
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const long long base = plane_idx(a, n, ch, y, x);
      float4 vm4 = make_float4(0.f, 0.f, 0.f, 0.f), va4 = vm4;
      uint32_t sg4 = 0, tl4 = 0xffffffffu;  // seg 0, t_last -1 (int8)
      if (!first && st) {
        const int e = ch * TH * TW + o;  // element of each array
        const float* f = reinterpret_cast<const float*>(st);
        vm4 = *reinterpret_cast<const float4*>(f + e);
        va4 = *reinterpret_cast<const float4*>(f + 2 * TH * TW + e);
        const unsigned char* b = st + 2 * 2 * TH * TW * 4;
        sg4 = *reinterpret_cast<const uint32_t*>(b + e);
        tl4 = *reinterpret_cast<const uint32_t*>(b + 2 * TH * TW + e);
      } else if (!first) {
        vm4 = *reinterpret_cast<const float4*>(a.vmem + base);
        va4 = *reinterpret_cast<const float4*>(a.vavg + base);
        sg4 = *reinterpret_cast<const uint32_t*>(a.seg + base);
        tl4 = *reinterpret_cast<const uint32_t*>(a.tlast + base);
      }
      float m[4] = {vm4.x, vm4.y, vm4.z, vm4.w};
      float v[4] = {va4.x, va4.y, va4.z, va4.w};
      uint32_t sp4 = 0, so = 0, to = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int sg = (int8_t)(sg4 >> (8 * j)), tl = (int8_t)(tl4 >> (8 * j));
        const bool s = chain(a, ii[ch][j], ig[ch][j], ii[2 + ch][j],
                             ig[2 + ch][j], m[j], v[j], sg, tl, base + j,
                             last);
        sp4 |= (uint32_t)s << (8 * j);
        so |= (uint32_t)(uint8_t)sg << (8 * j);
        to |= (uint32_t)(uint8_t)tl << (8 * j);
      }
      if (!last) {
        *reinterpret_cast<float4*>(a.vmem + base) =
            make_float4(m[0], m[1], m[2], m[3]);
        *reinterpret_cast<float4*>(a.vavg + base) =
            make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<uint32_t*>(a.seg + base) = so;
        *reinterpret_cast<uint32_t*>(a.tlast + base) = to;
        *reinterpret_cast<uint32_t*>(a.sp_next + base) = sp4;
      }
    }
    return;
  }
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    for (int j = 0; j < 4 && x + j < a.W; ++j) {
      const long long idx = plane_idx(a, n, ch, y, x + j);
      float vm = 0.f, va = 0.f;
      int sg = 0, tl = -1;
      if (!first) {
        vm = a.vmem[idx]; va = a.vavg[idx]; sg = a.seg[idx];
        tl = a.tlast[idx];
      }
      const bool s = chain(a, ii[ch][j], ig[ch][j], ii[2 + ch][j],
                           ig[2 + ch][j], vm, va, sg, tl, idx, last);
      if (!last) {
        a.vmem[idx] = vm;
        a.vavg[idx] = va;
        a.seg[idx] = (int8_t)sg;
        a.tlast[idx] = (int8_t)tl;
        a.sp_next[idx] = s ? 1 : 0;
      }
    }
  }
}

template <int K, int DEPTH, typename E>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    arsnn_v2_kernel(const Args a) {
  using G = Geo<K, DEPTH>;
  static_assert(DEPTH == 2 || !G::STATE_SMEM, "state in shared memory");
  extern __shared__ float4 smem4[];
  float4* w_i1 = smem4;
  float4* w_i2 = w_i1 + G::W1;
  float4* w_g1 = w_i2 + G::W2;
  float4* w_g2 = w_g1 + G::W1;
  float* bias = reinterpret_cast<float*>(w_g2 + G::W2);  // [stack][layer][4]
  float* s_gc = bias + 8 * DEPTH;         // [4]
  float* s_mi = s_gc + 4;
  float* s_mg = s_mi + G::MID;
  float* s_ev = s_mg + G::MID;            // [2][IH][IW], then the spikes
  float* s_sp = s_ev + 2 * G::IH * G::IW;

  const int H = a.H, W = a.W, N = a.N, t = a.t;
  const long long HW = (long long)H * W;
  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int n = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  stage_weights<K>(a.iw, a.ib, 2, w_i1, bias);
  stage_weights<K>(a.gw, a.gb, 2, w_g1, bias + 4 * DEPTH);
  if constexpr (DEPTH == 2) {
    stage_weights<K>(a.iw + 4 * 2 * K * K, a.ib + 4, 4, w_i2, bias + 4);
    stage_weights<K>(a.gw + 4 * 2 * K * K, a.gb + 4, 4, w_g2,
                     bias + 4 * DEPTH + 4);
  }
  {
    // this step's event planes and the previous spikes, with the halo: a
    // warp a staged row, a lane a column; all loads first, then the stores
    constexpr int ROWS = cdiv(G::IH, THREADS / 32), COLS = cdiv(G::IW, 32);
    const E* ev =
        static_cast<const E*>(a.ev) + ((long long)t * N + n) * 2 * HW;
    const uint8_t* sp = a.sp_prev + (long long)n * 2 * HW;
    float e[2][ROWS][COLS], s[2][ROWS][COLS];
#pragma unroll
    for (int ci = 0; ci < 2; ++ci)
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
          const int row = warp + (THREADS / 32) * i, col = lane + 32 * k;
          const int y = y0 - G::R + row, x = x0 - G::R + col;
          const bool in = row < G::IH && col < G::IW && y >= 0 && y < H &&
                          x >= 0 && x < W;
          const long long off = ci * HW + (long long)y * W + x;
          e[ci][i][k] = in ? to_f32(ev[off]) : 0.f;
          s[ci][i][k] = (in && t > 0) ? (float)sp[off] : 0.f;
        }
#pragma unroll
    for (int ci = 0; ci < 2; ++ci)
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
          const int row = warp + (THREADS / 32) * i, col = lane + 32 * k;
          if (row < G::IH && col < G::IW) {
            s_ev[(ci * G::IH + row) * G::IW + col] = e[ci][i][k];
            s_sp[(ci * G::IH + row) * G::IW + col] = s[ci][i][k];
          }
        }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // the weights
  __syncthreads();

  // the tile's state comes into shared memory during the second layer
  // (STATE_SMEM, W a multiple of 4, t > 0); else the chain reads it itself
  unsigned char* st = nullptr;
  const int r = tid / STRIPS_PER_ROW, c = (tid % STRIPS_PER_ROW) * 4;
  // At t = 0 the gate stack sees zero spikes: each of its sums is the
  // bias plus terms w * 0, which leave it as it is unless it is -0. So
  // where no gate bias is -0, its first layer is relu(bias) inside the
  // image (0 outside), and its output is that of the bias alone (depth 1)
  // or, at every pixel whose window lies in the image, one constant a
  // channel (depth 2), which 4 threads sum in the kernel's order: the same
  // values, bit for bit, for a fraction of the work.
  const bool zero_gate = t == 0 && no_neg_zero(bias + 4 * DEPTH, 4 * DEPTH);
  float acc_i[4][4], acc_g[4][4];
  if constexpr (DEPTH == 2) {
    // first layer over the tile and a k/2 halo, in strips of 4: the input
    // stack's NS, then the gate stack's NS
    constexpr int SPR = G::OW / 4, NS = G::OH * SPR;
    for (int q = tid; q < (zero_gate ? NS : 2 * NS); q += THREADS) {
      const bool gate = q >= NS;
      const int qq = gate ? q - NS : q;
      const int mr = qq / SPR, mc = (qq % SPR) * 4;
      float acc[4][4];
      conv_strip<K, 2, G::IW>(gate ? s_sp : s_ev, G::IH * G::IW, mr, mc,
                              gate ? w_g1 : w_i1, bias + (gate ? 8 : 0),
                              acc);
      float* mid = gate ? s_mg : s_mi;
      const int y = y0 - G::L1 + mr;
      float o[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = x0 - G::L1 + mc + j;
        const bool in = y >= 0 && y < H && x >= 0 && x < W;
#pragma unroll
        for (int co = 0; co < 4; ++co)
          o[co][j] = in ? relu(acc[co][j]) : 0.f;
      }
#pragma unroll
      for (int co = 0; co < 4; ++co)
        *reinterpret_cast<float4*>(mid + (co * G::OH + mr) * G::OW + mc) =
            make_float4(o[co][0], o[co][1], o[co][2], o[co][3]);
    }
    if (zero_gate) {
      for (int q = tid; q < NS; q += THREADS) {
        const int mr = q / SPR, mc = (q % SPR) * 4;
        const int y = y0 - G::L1 + mr;
        float o[4];
#pragma unroll
        for (int co = 0; co < 4; ++co) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int x = x0 - G::L1 + mc + j;
            const bool in = y >= 0 && y < H && x >= 0 && x < W;
            o[j] = in ? relu(bias[8 + co]) : 0.f;
          }
          *reinterpret_cast<float4*>(s_mg + (co * G::OH + mr) * G::OW +
                                     mc) = make_float4(o[0], o[1], o[2], o[3]);
        }
      }
      if (tid < 4) {
        // the second layer's sum at a pixel whose window is in the image
        float s = bias[12 + tid];
        for (int dy = 0; dy < K; ++dy)
          for (int ci = 0; ci < 4; ++ci)
            for (int dx = 0; dx < K; ++dx)
              s = __fmaf_rn(reinterpret_cast<const float*>(
                                w_g2 + (ci * K + dy) * K + dx)[tid],
                            relu(bias[8 + ci]), s);
        s_gc[tid] = s;
      }
    }
    __syncthreads();
    if (G::STATE_SMEM && W % 4 == 0 && t > 0) {
      st = reinterpret_cast<unsigned char*>(s_ev);
      fetch_state(a, n, y0, x0, st);
    }
    // the second layer
    conv_strip<K, 4, G::OW>(s_mi, G::OH * G::OW, r, c, w_i2, bias + 4,
                            acc_i);
    const int y = y0 + r, x = x0 + c;
    if (zero_gate && y - G::P >= 0 && y + G::P < H && x - G::P >= 0 &&
        x + 3 + G::P < W) {
#pragma unroll
      for (int co = 0; co < 4; ++co)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_g[co][j] = s_gc[co];
    } else {
      conv_strip<K, 4, G::OW>(s_mg, G::OH * G::OW, r, c, w_g2, bias + 12,
                              acc_g);
    }
  } else {
    conv_strip<K, 2, G::IW>(s_ev, G::IH * G::IW, r, c, w_i1, bias, acc_i);
    if (zero_gate) {
#pragma unroll
      for (int co = 0; co < 4; ++co)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_g[co][j] = bias[4 + co];
    } else {
      conv_strip<K, 2, G::IW>(s_sp, G::IH * G::IW, r, c, w_g1, bias + 4,
                              acc_g);
    }
  }
  if (st) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  // the elementwise chain for the thread's strip
  const int y = y0 + r, x = x0 + c;
  if (y < H && x < W) chain4(a, n, y, x, st, r * TW + c, acc_i, acc_g);
}

template <int K, int DEPTH, typename E>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = arsnn_v2_kernel<K, DEPTH, E>;
  constexpr size_t bytes = Geo<K, DEPTH>::BYTES;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const int tiles = ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
  kernel<<<dim3(tiles, a.N), THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const Args& a, int depth, int ksize, cudaStream_t s) {
  if (depth == 1) {
    switch (ksize) {
      case 1: return launch<1, 1, E>(a, s);
      case 3: return launch<3, 1, E>(a, s);
      case 5: return launch<5, 1, E>(a, s);
      case 7: return launch<7, 1, E>(a, s);
    }
  } else if (depth == 2) {
    switch (ksize) {
      case 1: return launch<1, 2, E>(a, s);
      case 3: return launch<3, 2, E>(a, s);
      case 5: return launch<5, 2, E>(a, s);
      case 7: return launch<7, 2, E>(a, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// One micro-step t of the scan. ev: (Tm, N, 2, H, W) events, dtype 0 f32,
// 1 bf16; iw/ib, gw/gb: the input and gate stacks' f32 weights, layer by
// layer, each OIHW flat (w[co][ci][dy][dx]), and biases; out: (Ts, N, 2,
// H, W) f32, every value written by the last step; vmem, vavg (f32), seg,
// tlast (int8):
// (N, 2, H, W) state, not read at t = 0 and not written at t = Tm - 1;
// sp_prev / sp_next: (N, 2, H, W) u8 spikes of steps t - 1 and t; every
// tensor 16-byte aligned. readout 0 sum, 1 last, 2 avg; hard 1 for a hard
// reset to vreset.
extern "C" int arsnn_v2_step(const void* ev, const void* iw, const void* ib,
                             const void* gw, const void* gb, void* out,
                             void* vmem, void* vavg, void* seg, void* tlast,
                             const void* sp_prev, void* sp_next, int N, int H,
                             int W, int Tm, int Ts, int t, int depth,
                             int ksize, float th, float vreset, int hard,
                             int readout, int write_zero, int use_abs,
                             int dtype, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || Tm < 1 || Tm > 127 ||
      Ts < 1 || Ts > 127 || t < 0 || t >= Tm || readout < 0 || readout > 2)
    return (int)cudaErrorInvalidValue;
  const void* state[] = {vmem, vavg, seg, tlast, sp_prev, sp_next};
  for (const void* p : state)
    if ((uintptr_t)p % 16) return (int)cudaErrorInvalidValue;
  Args a{ev, (const float*)iw, (const float*)ib, (const float*)gw,
         (const float*)gb, (float*)out, (float*)vmem, (float*)vavg,
         (int8_t*)seg, (int8_t*)tlast, (const uint8_t*)sp_prev,
         (uint8_t*)sp_next, N, H, W, Tm, Ts, t, th, vreset, hard, readout,
         write_zero, use_abs};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(a, depth, ksize, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, depth, ksize, s);
  return (int)cudaErrorInvalidValue;
}
