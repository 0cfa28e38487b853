// Whole-site 3x3 stride-2 conv + folded BatchNorm + PLIF (eval), int8
// spikes out: output (h, w) taps input (2h + dy - 1, 2w + dx - 1), zero
// outside. (The 1x1 and the stride-1 3x3 are in conv_wgmma.cu.)
//
// Replaces: eas_snn_tpu/ops/conv_plif_pallas.py
//   :_kernel3s2 (pallas_call at :581, conv3x3s2_plif_fused)
//
// Inputs: x (T*B, Cin, H, W), NCHW, int8, bf16 or f32; BN-folded weights
// in bf16, (3, Cout, 3*Cin) with the last axis (dx, ci) (fold_conv3x3);
// the folded bias (Cout) in f32; the decay a = 1 - sigmoid(w_plif) as a
// device scalar. Output (T*B, Cout, ceil(H/2), ceil(W/2)). The entry point
// refuses (cudaErrorInvalidValue) a layout whose rows or weight rows do
// not split into whole aligned copies: Cin a multiple of 8, W a whole
// number of 4-byte copies and every tensor 16-byte aligned.
//
// Design: a direct convolution on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 accumulation), M = Cout, N = output pixels, K = taps x
// channels, with the PLIF recurrence in its epilogue. A block owns 64
// output channels x an 8x16 output tile of one image b and loops t =
// 0..T-1. For each t it walks the input channels in chunks of 16.
// cp.async copies each chunk's input tile raw, in the input's own dtype
// and with the halo, plus the weights of all taps into a 2-stage ring of
// shared memory, so the next chunk is in flight while one multiplies and
// no register holds a load. Each warp multiplies its 32x32 sub-tile over
// every tap, reading the fragments straight from shared memory and
// rounding the input to bf16 as it reads it; a tap is an offset into the
// halo tile, so no im2col is ever built. The f32 sums stay in registers;
// the epilogue adds the bias and advances the f32 membranes, which stay in
// registers across t, and stages the spikes in shared memory for
// coalesced stores. The preactivation never reaches device memory.
//
// Bound on the H100: the flagship site (48->96 from 128x160 bf16, B=128)
// moves ~0.94 GB (byte-bound, ~0.28 ms). This version is still far from
// it: mma.sync reaches a fraction of the wgmma rate, weights are re-read
// from L2 for every chunk and t, and the 64-row tile is not sized to Cout.
#include "common.cuh"

namespace {

constexpr int CO_TILE = 64;
constexpr int PX_TILE = 128;
constexpr int THREADS = 256;
constexpr int OUT_LD = PX_TILE + 4;  // bytes per row of the spike stage

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Word of weight pair kw of row (output channel) r within a slab of KP
// words a row. The XOR of kw's 4-word group with the row's place in its
// bank cycle keeps the A fragment loads of a warp on 32 distinct banks;
// 16-byte segments (4 words) stay contiguous.
template <int KP>
__device__ __forceinline__ int w_word(int r, int kw) {
  return r * KP + (kw ^ (((r / (32 / KP)) % (KP / 4)) << 2));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of k-step ks (16 channels) for the warp's two 16-row
// tiles, from a weight slab of KP words a row.
template <int KP>
__device__ __forceinline__ void load_a(uint32_t (&af)[2][4],
                                       const uint32_t* Wt, int wco, int g,
                                       int tig, int ks) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wco + 16 * i + g;
    af[i][0] = Wt[w_word<KP>(r, 8 * ks + tig)];
    af[i][1] = Wt[w_word<KP>(r + 8, 8 * ks + tig)];
    af[i][2] = Wt[w_word<KP>(r, 8 * ks + tig + 4)];
    af[i][3] = Wt[w_word<KP>(r + 8, 8 * ks + tig + 4)];
  }
}

// CP (4 or 16) bytes global -> shared without registers; src_bytes < CP
// zero-fills.
template <int CP>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (CP == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The weight segment (8 channels from k, one 16-byte copy) of output
// channel co, zero past Cout or the piece's lim channels.
__device__ __forceinline__ void load_w_seg(uint32_t* dst,
                                           const __nv_bfloat16* w,
                                           long long idx, int co, int Cout,
                                           int k, int lim) {
  const bool ok = co < Cout && k < lim;
  cp_async<16>(dst, ok ? (const void*)(w + idx) : (const void*)w, ok ? 16 : 0);
}

// Epilogue part 1: bias and one PLIF step per accumulator; the spikes go to
// the shared stage sO[row][pixel].
__device__ __forceinline__ void stage_spikes(
    int8_t* sO, float (&acc)[2][4][4], float (&v)[2][4][4],
    const float (&bco)[2][2], float a, float th, int ge, int wco, int wpx,
    int g, int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wco + 16 * i + g + (e >= 2 ? 8 : 0);
        const int pix = wpx + 8 * j + 2 * tig + (e & 1);
        const float pre = __fadd_rn(bco[i][e >> 1], acc[i][j][e]);
        sO[r * OUT_LD + pix] = plif_step(v[i][j][e], pre, a, th, ge);
      }
}

// Per-thread bias of the four output rows it accumulates.
__device__ __forceinline__ void load_bias(float (&bco)[2][2],
                                          const float* bias, int co0,
                                          int wco, int g, int Cout) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + wco + 16 * i + g + 8 * h;
      bco[i][h] = co < Cout ? bias[co] : 0.f;
    }
}

// ---------------------------------------------------------------- kernel

struct Pieces {
  const void* ptr[4];
  int cin[4];
  int n;
};

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

template <typename T, int KS, int S>
struct Geo {
  static_assert(KS == 3 && S == 2, "the 3x3 stride-2 site only");
  static constexpr int TAPS = KS * KS;
  static constexpr int P = (KS - 1) / 2;  // padding
  static constexpr int KC = 16;           // channels a chunk
  static constexpr int KP = KC / 2;       // weight words a row
  static constexpr int STAGES = 2;
  static constexpr int TH = 8;  // output tile rows x cols
  static constexpr int TW = 16;
  static constexpr int CP = 4;  // bytes a copy
  static constexpr int EPC = CP / (int)sizeof(T);
  // the tile starts HALO_L columns left of the first output's first input,
  // a whole copy, so that copies stay aligned
  static constexpr int HALO_L = P == 0 ? 0 : EPC;
  static constexpr int IH = S * (TH - 1) + KS;
  static constexpr int IW = round_up(S * (TW - 1) + KS - P + HALO_L, EPC);
  static constexpr int ROW_COPIES = IW / EPC;
  // bytes a channel plane, = 16 (mod 64): the four channels a B fragment
  // load reads fall on distinct banks
  static constexpr int PLANE = round_up(IH * IW * (int)sizeof(T), 64) + 16;
  static constexpr int X_BYTES = KC * PLANE;
  static constexpr int W_BYTES = TAPS * CO_TILE * KP * 4;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE + CO_TILE * OUT_LD;
};

// Chunk c of the concat: piece j, channel c0 inside it, coff channels
// before piece j.
template <int KC>
__device__ __forceinline__ void locate(const Pieces& pc, int c, int& j,
                                       int& c0, int& coff) {
  coff = 0;
  for (j = 0; j < pc.n - 1; ++j) {
    const int nc = (pc.cin[j] + KC - 1) / KC;
    if (c < nc) break;
    c -= nc;
    coff += pc.cin[j];
  }
  c0 = c * KC;
}

// Every input row and weight row splits into aligned copies (launch()
// refuses other layouts).
template <typename T, int KS, int S>
__global__ void __launch_bounds__(THREADS, 2) conv_plif_kernel(
    Pieces pc, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ a_ptr,
    int8_t* __restrict__ out, int B, int steps, int Cin, int Cout, int H,
    int W, int Ho, int Wo, int tiles_w, float th, int ge) {
  using G = Geo<T, KS, S>;
  constexpr int PE = G::PLANE / (int)sizeof(T);  // elements a plane
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sO = reinterpret_cast<int8_t*>(smem + G::STAGES * G::STAGE);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int wco = (warp >> 2) * 32;         // the warp's 32x32 sub-tile
  const int wpx = (warp & 3) * 32;
  const int co0 = blockIdx.y * CO_TILE;
  const int b = blockIdx.z;
  const int oh0 = (blockIdx.x / tiles_w) * G::TH;
  const int ow0 = (blockIdx.x % tiles_w) * G::TW;
  const int rs = S * oh0 - G::P;       // input row of tile row 0
  const int cs = S * ow0 - G::HALO_L;  // input column of tile column 0
  const float a = *a_ptr;

  int nchunks = 0;
  for (int j = 0; j < pc.n; ++j) nchunks += (pc.cin[j] + G::KC - 1) / G::KC;

  // tile offset of the warp's B fragment columns (tap 0, channel 0)
  int boff[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = wpx + 8 * j + g;
    boff[j] = S * (n / G::TW) * G::IW + S * (n % G::TW) + G::HALO_L - G::P;
  }

  float v[2][4][4], bco[2][2];
  load_bias(bco, bias, co0, wco, g, Cout);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][j][e] = 0.f;

  for (int t = 0; t < steps; ++t) {
    const long long img = (long long)t * B + b;

    // chunk c -> ring stage s
    auto fetch = [&](int c, int s) {
      int j, c0, coff;
      locate<G::KC>(pc, c, j, c0, coff);
      const int lim = pc.cin[j];
      unsigned char* Xs = smem + s * G::STAGE;
      uint32_t* Ws = reinterpret_cast<uint32_t*>(Xs + G::X_BYTES);
      const T* x = static_cast<const T*>(pc.ptr[j]);
      for (int q = tid; q < G::KC * G::IH * G::ROW_COPIES; q += THREADS) {
        const int ch_l = q / (G::IH * G::ROW_COPIES);
        const int row = (q / G::ROW_COPIES) % G::IH;
        const int col_l = (q % G::ROW_COPIES) * G::EPC;
        const int ch = c0 + ch_l, h = rs + row, col = cs + col_l;
        unsigned char* dst =
            Xs + ch_l * G::PLANE + (row * G::IW + col_l) * (int)sizeof(T);
        const long long src = ((img * lim + ch) * H + h) * (long long)W + col;
        const bool ok = ch < lim && h >= 0 && h < H && col >= 0 && col < W;
        cp_async<G::CP>(dst, ok ? (const void*)(x + src) : (const void*)x,
                        ok ? G::CP : 0);
      }
      for (int q = tid; q < G::TAPS * CO_TILE * (G::KC / 8); q += THREADS) {
        const int tap = q / (CO_TILE * (G::KC / 8));
        const int r = (q / (G::KC / 8)) % CO_TILE, sg = q % (G::KC / 8);
        const int co = co0 + r, k = c0 + 8 * sg;
        const long long idx = ((long long)(tap / 3) * Cout + co) * (3 * Cin) +
                              (tap % 3) * Cin + k;
        load_w_seg(Ws + tap * CO_TILE * G::KP + w_word<G::KP>(r, 4 * sg), w,
                   idx, co, Cout, k, lim);
      }
    };

    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
    for (int s = 0; s < G::STAGES - 1; ++s) {
      if (s < nchunks) fetch(s, s);
      cp_async_commit();
    }
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait<G::STAGES - 2>();
      __syncthreads();  // chunk c landed; every warp is done with c - 1
      if (c + G::STAGES - 1 < nchunks)
        fetch(c + G::STAGES - 1, (c + G::STAGES - 1) % G::STAGES);
      cp_async_commit();
      const unsigned char* Xs = smem + (c % G::STAGES) * G::STAGE;
      const uint32_t* Ws = reinterpret_cast<const uint32_t*>(Xs + G::X_BYTES);
#pragma unroll
      for (int tap = 0; tap < G::TAPS; ++tap) {
        const int toff = (tap / KS) * G::IW + tap % KS;
#pragma unroll
        for (int ks = 0; ks < G::KC / 16; ++ks) {
          uint32_t af[2][4];
          load_a<G::KP>(af, Ws + tap * CO_TILE * G::KP, wco, g, tig, ks);
          const T* xc = reinterpret_cast<const T*>(Xs) +
                        (16 * ks + 2 * tig) * PE + toff;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const T* xb = xc + boff[j];
            const uint32_t b0 = pack2(to_bf16(xb[0]), to_bf16(xb[PE]));
            const uint32_t b1 =
                pack2(to_bf16(xb[8 * PE]), to_bf16(xb[9 * PE]));
#pragma unroll
            for (int i = 0; i < 2; ++i) mma16816(acc[i][j], af[i], b0, b1);
          }
        }
      }
    }

    stage_spikes(sO, acc, v, bco, a, th, ge, wco, wpx, g, tig);
    __syncthreads();
    for (int q = tid; q < CO_TILE * PX_TILE; q += THREADS) {
      const int r = q / PX_TILE, pix = q % PX_TILE;
      const int co = co0 + r;
      const int oh = oh0 + pix / G::TW, ow = ow0 + pix % G::TW;
      if (co < Cout && oh < Ho && ow < Wo)
        out[((img * Cout + co) * Ho + oh) * Wo + ow] = sO[r * OUT_LD + pix];
    }
  }
}

template <typename T, int KS, int S>
cudaError_t launch(const Pieces& pc, const void* w, const void* bias,
                   const void* a, void* out, int B, int steps, int Cout,
                   int H, int W, float th, int ge, cudaStream_t stream) {
  using G = Geo<T, KS, S>;
  // every copy must be whole and aligned: rows of whole copies, channel
  // counts in 8s (16-byte weight segments), 16-byte aligned tensors
  bool aligned = (W * (int)sizeof(T)) % G::CP == 0 && (uintptr_t)w % 16 == 0;
  int Cin = 0;
  for (int j = 0; j < pc.n; ++j) {
    Cin += pc.cin[j];
    aligned = aligned && pc.cin[j] % 8 == 0 && (uintptr_t)pc.ptr[j] % 16 == 0;
  }
  if (!aligned) return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_plif_kernel<T, KS, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int Ho = (H + 2 * G::P - KS) / S + 1;
  const int Wo = (W + 2 * G::P - KS) / S + 1;
  const int tiles_w = (Wo + G::TW - 1) / G::TW;
  const dim3 grid(((Ho + G::TH - 1) / G::TH) * tiles_w,
                  (Cout + CO_TILE - 1) / CO_TILE, B);
  conv_plif_kernel<T, KS, S><<<grid, THREADS, G::SMEM_BYTES, stream>>>(
      pc, (const __nv_bfloat16*)w, (const float*)bias, (const float*)a,
      (int8_t*)out, B, steps, Cin, Cout, H, W, Ho, Wo, tiles_w, th, ge);
  return cudaGetLastError();
}

cudaError_t dispatch(int dtype, const Pieces& pc, const void* w,
                     const void* bias, const void* a, void* out, int B,
                     int steps, int Cout, int H, int W, float th, int ge,
                     cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch<float, 3, 2>(pc, w, bias, a, out, B, steps, Cout, H, W,
                                 th, ge, s);
    case 1:
      return launch<__nv_bfloat16, 3, 2>(pc, w, bias, a, out, B, steps, Cout,
                                         H, W, th, ge, s);
    case 2:
      return launch<int8_t, 3, 2>(pc, w, bias, a, out, B, steps, Cout, H, W,
                                  th, ge, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (T*B, Cin, H, W); dtype 0 = f32, 1 = bf16, 2 = int8.
extern "C" int conv3x3s2_plif(const void* x, const void* w3,
                              const void* bias, const void* a, void* out,
                              int B, int steps, int Cin, int Cout, int H,
                              int W, float th, int ge, int dtype,
                              void* stream) {
  if (Cin < 1) return (int)cudaErrorInvalidValue;
  Pieces pc;
  pc.ptr[0] = x;
  pc.cin[0] = Cin;
  for (int j = 1; j < 4; ++j) {
    pc.ptr[j] = nullptr;
    pc.cin[j] = 0;
  }
  pc.n = 1;
  return (int)dispatch(dtype, pc, w3, bias, a, out, B, steps, Cout, H, W, th,
                       ge, (cudaStream_t)stream);
}
