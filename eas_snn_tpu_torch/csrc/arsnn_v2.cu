// The whole ARSNN sampler scan, forward only: both depth-stacked k x k
// conv stacks (input: events -> 2C, gate: previous spikes -> 2C) computed
// inside the kernel as f32 stencils, then the gated LIF update, Heaviside
// spike, soft or hard reset, the no-reset integral, the slot counter and
// last-spike time, the slot writes, and at the last micro-step the residual
// write and use_abs. C = Cin = 2, 2C = 4 conv outputs, depth 1 or 2, odd
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
//   block of step t reads step t-1's spikes;
// * each block stages its tile of the step's event planes and of the
//   previous spikes in shared memory with a depth * (k/2) px halo (zero
//   outside the image), computes the first layer of both stacks over the
//   tile plus a k/2 halo into shared memory (ReLU, and 0 at positions
//   outside the image: the intermediate layer's zero padding), then the
//   second layer over the tile in registers, and runs the elementwise
//   chain there;
// * a thread owns a strip of 4 adjacent outputs and all 4 output
//   channels: it reads each input row segment with 16-byte shared loads
//   and the 4 channels' weights of a tap with one broadcast 16-byte load,
//   and keeps its 16 sums in registers;
// * the slots are written once each into the zero-filled output; the
//   last launch writes the residual, applies use_abs and writes no state.
//
// Arithmetic: f32 with every multiply and add rounded on its own
// (__fmul_rn / __fadd_rn, no FMA), the stencil summed in the JAX kernel's
// order (bias, then dy, ci, dx for each output channel), the sigmoid as
// 1 / (1 + expf(-x)) (ops/arsnn_fused.py:sigmoid): the slots equal the
// plain version (ops/arsnn_fused.py:arsnn_fused_v2_plain) bit for bit. That
// doubles the instruction count against FMA, a trade a later change may
// revisit.
//
// Bound on the H100: operations. Per pixel and step the two stacks take
// (Cin*2C + (depth-1)*2C*2C + C*2C + (depth-1)*2C*2C) * k^2 multiply-adds,
// 1,200 at the flagship (depth 2, k 5): 2,400 flops, ~100 GFLOP a forward
// at B=128 (256x320, Tm 4), ~1.5 ms at 67 TFLOP/s, against ~0.13 ms to
// move the bf16 events in and the f32 slots out. The halo costs ~9% more
// work (layer 1 over 36x36 for a 32x32 tile at k 5), and unfused
// multiply-adds double the instructions.
#include "common.cuh"

namespace {

constexpr int TH = 32, TW = 32, THREADS = 256;
constexpr int STRIPS_PER_ROW = TW / 4;  // 8 strips x 32 rows = 256 threads

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

template <int K, int DEPTH>
struct Geo {
  static constexpr int P = K / 2;
  static constexpr int R = DEPTH * P;       // halo of the staged planes
  static constexpr int L1 = (DEPTH - 1) * P;  // halo of the first layer
  static constexpr int NV = (K + 6) / 4;   // float4s per strip row
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
  static constexpr size_t BYTES =
      sizeof(float4) * 2 * (W1 + W2) + sizeof(float) * 8 * DEPTH +
      sizeof(float) * (2 * 2 * IH * IW + 2 * MID);
};

struct Args {
  const void* ev;  // (Tm, N, 2, H, W), E
  const float* iw; const float* ib; const float* gw; const float* gb;
  float* out;      // (Ts, N, 2, H, W), zero-filled
  float* vmem; float* vavg;     // (N, 2, H, W)
  int8_t* seg; int8_t* tlast;   // (N, 2, H, W)
  const uint8_t* sp_prev; uint8_t* sp_next;  // (N, 2, H, W)
  int N, H, W, Tm, Ts, t;
  float th, vreset;
  int hard, readout, write_zero, use_abs;
};

__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// acc[co][j] = b[co] + sum over (dy, ci, dx) of w[co][ci][dy][dx] *
// in[ci][r + dy][c + j + dx], in that order, for the strip of 4 outputs at
// (r, c) of the output region (c a multiple of 4); `in` holds CI planes of
// BW floats a row, its (0, 0) the tap (0, 0) of output (0, 0).
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
            acc[co][j] = __fadd_rn(acc[co][j], __fmul_rn(wc[co], x[j + dx]));
      }
    }
  }
}

// One layer's OIHW weights (4 outputs, CI inputs) as [ci][dy][dx] float4s
// over the output channel, and its 4 biases.
template <int K>
__device__ __forceinline__ void stage_weights(const float* __restrict__ w,
                                              const float* __restrict__ b,
                                              int CI, float4* ws, float* bs) {
  for (int i = threadIdx.x; i < CI * K * K; i += THREADS) {
    const int ci = i / (K * K), tap = i % (K * K);
    ws[i] = make_float4(w[(0 * CI + ci) * K * K + tap],
                        w[(1 * CI + ci) * K * K + tap],
                        w[(2 * CI + ci) * K * K + tap],
                        w[(3 * CI + ci) * K * K + tap]);
  }
  if (threadIdx.x < 4) bs[threadIdx.x] = b[threadIdx.x];
}

template <int K, int DEPTH, typename E>
__global__ void __launch_bounds__(THREADS) arsnn_v2_kernel(const Args a) {
  using G = Geo<K, DEPTH>;
  extern __shared__ float4 smem4[];
  float4* w_i1 = smem4;
  float4* w_i2 = w_i1 + G::W1;
  float4* w_g1 = w_i2 + G::W2;
  float4* w_g2 = w_g1 + G::W1;
  float* bias = reinterpret_cast<float*>(w_g2 + G::W2);  // [stack][layer][4]
  float* s_ev = bias + 8 * DEPTH;
  float* s_sp = s_ev + 2 * G::IH * G::IW;
  float* s_mi = s_sp + 2 * G::IH * G::IW;
  float* s_mg = s_mi + G::MID;

  const int H = a.H, W = a.W, N = a.N, t = a.t;
  const long long HW = (long long)H * W;
  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;

  stage_weights<K>(a.iw, a.ib, 2, w_i1, bias);
  stage_weights<K>(a.gw, a.gb, 2, w_g1, bias + 4 * DEPTH);
  if constexpr (DEPTH == 2) {
    stage_weights<K>(a.iw + 4 * 2 * K * K, a.ib + 4, 4, w_i2, bias + 4);
    stage_weights<K>(a.gw + 4 * 2 * K * K, a.gb + 4, 4, w_g2,
                     bias + 4 * DEPTH + 4);
  }
  // this step's event planes and the previous spikes, with the halo
  const E* ev = static_cast<const E*>(a.ev) + ((long long)t * N + n) * 2 * HW;
  const uint8_t* sp = a.sp_prev + (long long)n * 2 * HW;
  for (int i = tid; i < 2 * G::IH * G::IW; i += THREADS) {
    const int ci = i / (G::IH * G::IW), rem = i % (G::IH * G::IW);
    const int y = y0 - G::R + rem / G::IW, x = x0 - G::R + rem % G::IW;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const long long off = ci * HW + (long long)y * W + x;
    s_ev[i] = in ? to_f32(ev[off]) : 0.f;
    s_sp[i] = (in && t > 0) ? (float)sp[off] : 0.f;
  }
  __syncthreads();

  float acc_i[4][4], acc_g[4][4];
  const int r = tid / STRIPS_PER_ROW, c = (tid % STRIPS_PER_ROW) * 4;
  if constexpr (DEPTH == 2) {
    // first layer of both stacks over the tile and a k/2 halo
    constexpr int SPR = G::OW / 4, NS = G::OH * SPR;
    for (int s = tid; s < 2 * NS; s += THREADS) {
      const bool gate = s >= NS;
      const int q = gate ? s - NS : s;
      const int mr = q / SPR, mc = (q % SPR) * 4;
      float acc[4][4];
      conv_strip<K, 2, G::IW>(gate ? s_sp : s_ev, G::IH * G::IW, mr, mc,
                              gate ? w_g1 : w_i1, bias + (gate ? 8 : 0),
                              acc);
      float* mid = gate ? s_mg : s_mi;
      const int y = y0 - G::L1 + mr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = x0 - G::L1 + mc + j;
        const bool in = y >= 0 && y < H && x >= 0 && x < W;
#pragma unroll
        for (int co = 0; co < 4; ++co)
          mid[(co * G::OH + mr) * G::OW + mc + j] = in ? relu(acc[co][j]) : 0.f;
      }
    }
    __syncthreads();
    conv_strip<K, 4, G::OW>(s_mi, G::OH * G::OW, r, c, w_i2, bias + 4, acc_i);
    conv_strip<K, 4, G::OW>(s_mg, G::OH * G::OW, r, c, w_g2, bias + 12,
                            acc_g);
  } else {
    conv_strip<K, 2, G::IW>(s_ev, G::IH * G::IW, r, c, w_i1, bias, acc_i);
    conv_strip<K, 2, G::IW>(s_sp, G::IH * G::IW, r, c, w_g1, bias + 4,
                            acc_g);
  }

  // the elementwise chain for the strip's pixels, both channels
  const int y = y0 + r;
  if (y >= H) return;
  const bool first = t == 0, last = t == a.Tm - 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = x0 + c + j;
    if (x >= W) break;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const long long idx = ((long long)n * 2 + ch) * HW + (long long)y * W + x;
      float vm = 0.f, va = 0.f;
      int sg = 0, tl = -1;
      if (!first) {
        vm = a.vmem[idx]; va = a.vavg[idx]; sg = a.seg[idx]; tl = a.tlast[idx];
      }
      const float g = __fadd_rn(acc_i[ch][j], acc_g[ch][j]);
      const float gate = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
      const float cur = __fadd_rn(acc_i[2 + ch][j], acc_g[2 + ch][j]);
      const float v = __fadd_rn(__fmul_rn(gate, vm), cur);
      const bool s = __fsub_rn(v, a.th) > 0.f;
      const float sf = s ? 1.f : 0.f;
      const float v_after =
          a.hard ? __fadd_rn(__fmul_rn(v, __fsub_rn(1.f, sf)),
                             __fmul_rn(a.vreset, sf))
                 : __fsub_rn(v, __fmul_rn(a.th, sf));
      va = __fadd_rn(va, v);
      const long long slot = (long long)a.N * 2 * HW;  // one slot's size
      if (s && sg < a.Ts) {
        float w = a.readout == 0 ? va : v_after;
        if (a.readout == 2)
          w = __fdiv_rn(va, fmaxf(__fsub_rn((float)t, (float)tl), 1.f));
        w = __fadd_rn(0.f, w);
        a.out[sg * slot + idx] = a.use_abs ? relu(w) : w;
        ++sg;
        tl = t;
      }
      if (s) va = 0.f;
      if (last) {
        // residual write for an element whose last slot never closed
        if (!s && sg < a.Ts) {
          float w = a.readout == 0 ? va : v_after;
          if (a.readout == 2)
            w = __fdiv_rn(va, fmaxf(__fsub_rn((float)(a.Tm - 1), (float)tl),
                                    1.f));
          if (a.write_zero) w = __fmul_rn(w, 0.f);
          w = __fadd_rn(0.f, w);
          a.out[sg * slot + idx] = a.use_abs ? relu(w) : w;
        }
      } else {
        a.vmem[idx] = v_after;
        a.vavg[idx] = va;
        a.seg[idx] = (int8_t)sg;
        a.tlast[idx] = (int8_t)tl;
        a.sp_next[idx] = s ? 1 : 0;
      }
    }
  }
}

template <int K, int DEPTH, typename E>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = arsnn_v2_kernel<K, DEPTH, E>;
  constexpr size_t bytes = Geo<K, DEPTH>::BYTES;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
// H, W) f32, zero before step 0; vmem, vavg (f32), seg, tlast (int8):
// (N, 2, H, W) state, not read at t = 0 and not written at t = Tm - 1;
// sp_prev / sp_next: (N, 2, H, W) u8 spikes of steps t - 1 and t.
// readout 0 sum, 1 last, 2 avg; hard 1 for a hard reset to vreset.
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
