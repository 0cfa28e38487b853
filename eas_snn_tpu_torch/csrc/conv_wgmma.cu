// Whole-site conv + folded BatchNorm + PLIF (eval) on Hopper's warpgroup
// tensor-core products (wgmma), int8 spikes out: a 1x1 conv over a
// virtual concat of up to 4 pieces, and a 3x3 conv with pad 1 and stride
// 1 or 2.
//
// Replaces: eas_snn_tpu/ops/conv_plif_pallas.py
//   :_kernel    (pallas_call at :155, conv1x1_plif_fused) -> conv1x1_plif
//   :_kernel3   (pallas_call at :359, conv3x3_plif_fused) -> conv3x3_plif
//   :_kernel3s2 (pallas_call at :581, conv3x3s2_plif_fused)
//                                                      -> conv3x3s2_plif
//
// Computes, per time step t: acc = bias_f + sum bf16(w_f) * bf16(x) in f32
// and the f32 PLIF recurrence on acc; spikes (T*B, Cout, Ho, Wo) int8.
// Inputs: pieces x_j (T*B, C_j, H, W) NCHW of one dtype (int8, bf16 or
// f32), never concatenated in memory; BN-folded weights in bf16, (Cout,
// sum C_j) for 1x1 or (3, Cout, 3*Cin) with the last axis (dx, ci) for
// 3x3; the folded bias (Cout) in f32; the decay a = 1 - sigmoid(w_plif) as
// a device scalar.
//
// Design. An implicit GEMM with output pixels on M and output channels on
// N: each wgmma.mma_async m64nNk16 multiplies 64 pixels by N <= 96
// channels over 16 input channels, both operands bf16 in shared memory in
// wgmma's K-major, no-swizzle layout (core matrices of 8 rows x 16 bytes).
// A block is one producer warpgroup and two consumer warpgroups (384
// threads). It owns one chunk of the output channels (N = 32, 48, 64 or
// 96 wide, blockIdx.y; the host picks the fewest chunks whose weights
// fit, so Cout 48 and 96 run whole and 192 / 384 / 768 as 2 / 4 / 8
// chunks of 96) and keeps that chunk's weights for all taps and input
// channels resident in shared memory, loaded once. The grid is persistent
// (about one block per SM): each consumer warpgroup walks its own list of
// 64-pixel tiles (1x1: 64 consecutive pixels of the flattened B*H*W, so a
// tile may span images; 3x3: an 8x8 output tile of one image) and, inside
// a tile, runs t = 0..T-1 with the tile's f32 membranes in registers.
// Half of the producer warpgroup (64 threads) serves each consumer: it
// copies the input chunk by chunk with cp.async (64 channels for 1x1 in
// 16-byte copies; 32 channels with the 1-pixel halo for 3x3, in 4-byte
// copies, which zero-fill outside the image) into a raw ring one to three
// chunks ahead, widens each element to bf16 once and writes it into the
// consumer's 2-stage bf16 ring, which mbarriers hand back and forth. For
// the 3x3 a bf16 stage holds the 10x10 halo tile, pixel-major per 8-channel
// group, and tap (dy, dx) is the same descriptor with its start moved by
// (dy*10 + dx)*16 bytes (the stride between core matrices along M is one
// halo row): no im2col is built and no element is widened twice. At
// stride 2 the 8 rows of a core matrix (8 output pixels of a row) read
// every other input pixel, so a stage holds the 17x17 input halo of the
// 8x8 output tile as four 9x9 parity planes (even / odd input rows x even
// / odd input columns), which the producers scatter into as they widen;
// output (h, w) reads input (2h + dy - 1, 2w + dx - 1), so tap (dy, dx)
// starts at plane (dy & 1, dx & 1), pixel (dy / 2, dx / 2), and SBO is
// one plane row: the 9 taps again share one stage. Its K chunks are 16
// channels (dark2's 48 in 3 chunks, and the 9 taps' resident weights
// leave room for 4 raw stages). Each chunk issues a fixed, fully unrolled
// run of products (K is padded to whole chunks with zeros), so the
// compiler never serializes them. The
// epilogue adds the bias, steps the membranes with plif_step, stages the
// spikes in shared memory and stores whole NCHW row segments (1x1: up to
// 16 bytes; 3x3: the tile's 8-byte rows). The preactivation never reaches
// device memory.
//
// Bound on the H100 at the flagship sites (B=128, T=3): the 3x3 site
// (96 -> 96 at 32x40, int8) does 81.5 GFLOP of bf16 products against
// 0.1 GB (tensor-core bound, 0.087 ms at 989 TFLOP/s); the stride-2 site
// (48 -> 96 from 128x160, bf16) moves 0.94 GB, mostly its input (byte
// bound, 0.28 ms), for 34 GFLOP; the 1x1 sites move
// 0.07-0.28 GB for 2*Cin flops an output (byte-bound, 0.02-0.085 ms, but
// for 768 -> 768 at 8x10, operation-bound at 0.039 ms). The products
// themselves run near that bound (the consumers alone take 0.08 ms at the
// 3x3 site); what is left is the producers' copies and widening and the
// epilogue's stores, measured in PERF.md.
//
// Layout rules (the entry points return cudaErrorInvalidValue, and the
// wrappers raise, otherwise): every C_j a multiple of 8, every tensor
// 16-byte aligned; 1x1: H*W*sizeof(T) a multiple of 16 (a copy never
// spans images); 3x3 (both strides): W*sizeof(T) a multiple of 4; and the
// chunk's resident weights plus the rings within the 232,448 bytes of
// shared memory a block may use (conv_plif.py:conv_plan).
#include "common.cuh"

namespace {

constexpr int M_TILE = 64;    // output pixels a consumer tile (one wgmma M)
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int TILE = 8;       // 3x3: output tile rows and columns
constexpr int SMEM_LIMIT = 232448;
// The convolutions (the OP template argument): 1x1, 3x3 stride 1, and
// 3x3 stride 2 copying 4 or (C3X3S2V, where W * sizeof(T) is a multiple
// of 16) 16 bytes at a time.
constexpr int C1X1 = 0, C3X3 = 1, C3X3S2 = 2, C3X3S2V = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, LBO =
// bytes between core matrices along K, SBO = along M (or N).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT;\n}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}

// Shared-memory writes of this thread become visible to wgmma (the async
// proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier among `count` threads (whole warps) of the block.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
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

// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N f32, the warpgroup's fragment) = [d +] A (64 x 16) * B (16 x
// N), both bf16 K-major in shared memory; acc = 0 ignores d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t da,
                                           uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<48> {
  __device__ __forceinline__ static void run(float (&d)[24], uint64_t da,
                                           uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void run(float (&d)[48], uint64_t da,
                                           uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(acc));
  }
};


// ---------------------------------------------------------------- layout

struct Pieces {
  const void* ptr[4];
  int cin[4];
  int n;
};

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

template <int OP, typename T>
struct Geo;

// 1x1: a tile is 64 consecutive pixels of the flattened (b, h, w); a K
// chunk is 64 channels. cp.async brings each channel's 64 pixels raw in
// 16-byte copies (PX pixels, never across an image: H*W*sizeof(T) % 16 ==
// 0): raw [channel][64 pixels], the 16-byte slots of a channel XOR-rotated
// by its channel group so that the widening reads spread over the banks.
// A producer thread owns 8 channels x 8 pixels of the chunk and widens
// them into the bf16 stage: one 8-channel group after the other, each 64
// pixels x 16 bytes plus a 16-byte pad (the 16-byte stores of 8 groups
// fall on 8 bank quads).
template <typename T>
struct Geo<C1X1, T> {
  static constexpr int TAPS = 1, KC = 64, STAGES = 2;
  static constexpr int RAW_STAGES = sizeof(T) == 1 ? 4 : 2;
  static constexpr int PX = 16 / (int)sizeof(T);  // pixels a copy
  static constexpr int ROW = M_TILE * (int)sizeof(T);  // raw bytes a channel
  static constexpr int A_LBO = M_TILE * 16 + 16;
  static constexpr int A_SBO = 8 * 16;
  static constexpr int STAGE = (KC / 8) * A_LBO;
  static constexpr int RAW = KC * ROW;
  static constexpr int OUT_LD = M_TILE + 16;  // bytes a spike-stage row
  __device__ static constexpr int tap_off(int) { return 0; }
};

// 3x3, stride 1: a tile is 8x8 output pixels; a K chunk is KC channels.
// cp.async brings, for each of the chunk's channels and each of the 10
// input rows oh0-1.. of the tile, the row segment [ow0 - EPC, ow0 + 8 +
// EPC) in whole aligned 4-byte copies (EPC elements each; a TMA box
// cannot start at the halo's unaligned column): raw [channel][row][RW].
// Copies outside the image zero-fill. The bf16 stage holds the 10x10
// halo, one 8-channel group after the other, pixel-major at 16 bytes a
// pixel: output row i of the tile reads halo row i + dy, so SBO is one
// halo row.
template <typename T>
struct Geo<C3X3, T> {
  static constexpr int TAPS = 9, STAGES = 2, RAW_STAGES = 2;
  static constexpr int KC = sizeof(T) == 4 ? 16 : 32;
  static constexpr int TH = TILE, TW = TILE, IH = TH + 2, IW = TW + 2;
  static constexpr int EPC = 4 / (int)sizeof(T);  // elements a copy
  static constexpr int RW = TW + 2 * EPC;         // elements a raw row
  static constexpr int RB = RW * (int)sizeof(T);  // bytes a raw row
  static constexpr int A_LBO = IH * IW * 16;
  static constexpr int A_SBO = IW * 16;
  static constexpr int STAGE = (KC / 8) * A_LBO;
  static constexpr int RAW = KC * IH * RB;
  static constexpr int OUT_LD = TH * TW + 8;  // bytes a spike-stage row
  // bytes from the stage's start to tap (dy, dx) of output (0, 0)
  __device__ static constexpr int tap_off(int tap) {
    return ((tap / 3) * IW + tap % 3) * 16;
  }
};

// 3x3, stride 2: a tile is 8x8 output pixels, reading the 17x17 input
// halo from row 2*oh0 - 1 and column 2*ow0 - 1; a K chunk is 16 channels.
// cp.async brings, for each channel and each of the 17 halo rows, the row
// segment [2*ow0 - EPC, 2*ow0 + 16) in whole aligned CB-byte copies of EPC
// elements (the halo's first column is odd: the copies start EPC - 1
// columns before it, and the scatter drops those): raw [channel][row][RW].
// The bf16 stage holds, for each 8-channel group, the four 9x9 parity
// planes [row parity][column parity][9][9], pixel-major at 16 bytes a
// pixel (the odd planes use 8x8 of theirs); halo pixel (i, j) lies in
// plane (i & 1, j & 1) at (i / 2, j / 2), so output row h of the tile
// reads plane row h + dy / 2 of tap (dy, dx): SBO is one plane row.
template <typename T, int CB>
struct GeoS2 {
  static constexpr int TAPS = 9, STAGES = 2, KC = 16;
  static constexpr int RAW_STAGES = sizeof(T) == 4 ? 2 : CB == 16 ? 3 : 4;
  static constexpr int TH = TILE, TW = TILE;
  static constexpr int IH = 2 * TH + 1;              // halo rows
  static constexpr int PW = TW + 1;                  // plane rows, columns
  static constexpr int EPC = CB / (int)sizeof(T);    // elements a copy
  static constexpr int RW = 2 * TW + EPC;            // elements a raw row
  static constexpr int RB = RW * (int)sizeof(T);     // bytes a raw row
  static constexpr int PLANE = PW * PW * 16;
  static constexpr int A_LBO = 4 * PLANE;
  static constexpr int A_SBO = PW * 16;
  static constexpr int STAGE = (KC / 8) * A_LBO;
  static constexpr int RAW = KC * IH * RB;
  static constexpr int OUT_LD = TH * TW + 8;  // bytes a spike-stage row
  __device__ static constexpr int tap_off(int tap) {
    return (((tap / 3) & 1) * 2 + ((tap % 3) & 1)) * PLANE +
           (((tap / 3) >> 1) * PW + ((tap % 3) >> 1)) * 16;
  }
};

template <typename T>
struct Geo<C3X3S2, T> : GeoS2<T, 4> {};
template <typename T>
struct Geo<C3X3S2V, T> : GeoS2<T, 16> {};

// Shared memory, each part 128-byte aligned: resident weights [tap][k/8]
// [n][8 k] (K-major, core matrices of 8 channels n x 8 k), the chunk's
// bias, for each consumer a ring of STAGES bf16 stages, its producers'
// RAW_STAGES raw stages and its spike stage, and the barriers.
template <int OP, typename T>
struct Smem {
  using G = Geo<OP, T>;
  int bias, ring, raw, out, bars, bytes;
  __host__ __device__ Smem(int nw, int kp) {
    bias = round_up(G::TAPS * kp * nw * 2, 128);
    ring = bias + round_up(nw * 4, 128);
    raw = ring + 2 * G::STAGES * G::STAGE;
    out = raw + 2 * G::RAW_STAGES * G::RAW;
    bars = out + round_up(2 * nw * G::OUT_LD, 128);
    bytes = bars + 2 * 2 * G::STAGES * 8;
  }
};

// Padded K: every piece rounded up to whole K chunks, so that every chunk
// issues the same, fully unrolled products (zeros in the padding).
template <int KC>
__host__ __device__ inline int padded_k(const Pieces& pc) {
  int kp = 0;
  for (int j = 0; j < pc.n; ++j) kp += round_up(pc.cin[j], KC);
  return kp;
}

// ---------------------------------------------------------------- copies

// N bytes global -> shared without registers; ok = false zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// CB (4 or 16) bytes global -> shared; ok = false zero-fills.
template <int CB>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           bool ok) {
  if constexpr (CB == 16)
    cp_async16(dst, src, ok);
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// 4 consecutive elements -> 2 words of bf16 pairs.
__device__ __forceinline__ void widen4(const int8_t* p, uint32_t* o) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const __nv_bfloat162 b =
        __floats2bfloat162_rn((float)(int8_t)(x >> (16 * k)),
                              (float)(int8_t)(x >> (16 * k + 8)));
    o[k] = *reinterpret_cast<const uint32_t*>(&b);
  }
}

__device__ __forceinline__ void widen4(const __nv_bfloat16* p, uint32_t* o) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  o[0] = r.x;
  o[1] = r.y;
}

__device__ __forceinline__ void widen4(const float* p, uint32_t* o) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  const __nv_bfloat162 b0 = __floats2bfloat162_rn(r.x, r.y);
  const __nv_bfloat162 b1 = __floats2bfloat162_rn(r.z, r.w);
  o[0] = *reinterpret_cast<const uint32_t*>(&b0);
  o[1] = *reinterpret_cast<const uint32_t*>(&b1);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// ---------------------------------------------------------------- chunks

struct Site {
  int B, steps, Cout, H, W, Ho, Wo;
  int R;  // 1x1: B*H*W pixels
  int tiles_w, tiles_img, n_tiles;
  int kp;       // padded K
  float th;
  int ge;
};

// Chunk ci of a time step's K: piece j, its first channel c0 and the
// offset kp0 into the padded K of the resident weights.
struct Chunk {
  int j, c0, kp0;
};

template <int KC>
__device__ __forceinline__ Chunk chunk_at(const Pieces& pc, int ci) {
  int kp0 = 0, j = 0;
  for (; j < pc.n - 1; ++j) {
    const int nj = (pc.cin[j] + KC - 1) / KC;
    if (ci < nj) break;
    ci -= nj;
    kp0 += nj * KC;
  }
  return Chunk{j, ci * KC, kp0 + ci * KC};
}

// Step q of a consumer's work: its tile, time step and chunk.
struct Work {
  int tile, t, ci;
};

__device__ __forceinline__ Work work_at(int q, int first, int stride,
                                        int steps, int nck) {
  return Work{first + (q / (nck * steps)) * stride, (q / nck) % steps,
              q % nck};
}

// 1x1 copies of one chunk, by the 64 producer threads: 16 bytes of a
// channel's pixels each; copies past Cin or past the last pixel
// zero-fill.
template <typename T>
__device__ __forceinline__ void issue1(unsigned char* raw, const Pieces& pc,
                                       const Site& s, const Chunk& ch,
                                       int tile, int t, int ptid) {
  using G = Geo<C1X1, T>;
  constexpr int PER = M_TILE / G::PX;  // copies a channel
  static_assert(64 % PER == 0, "a thread's copies share one pixel group");
  const T* x = static_cast<const T*>(pc.ptr[ch.j]);
  const int C = pc.cin[ch.j], HW = s.H * s.W;
  // every copy of this thread reads pixel group k: one division a chunk
  const int k = ptid % PER;
  const int r = tile * M_TILE + k * G::PX;
  const int b = r / HW, p = r - b * HW;
  const T* base = x + ((long long)(t * s.B + b) * C + ch.c0) * HW + p;
  for (int cl = ptid / PER; cl < G::KC; cl += 64 / PER) {
    const bool ok = r < s.R && ch.c0 + cl < C;
    cp_async16(raw + cl * G::ROW + ((k ^ ((cl >> 3) & 3)) << 4),
               ok ? base + (long long)cl * HW : x, ok);
  }
}

// 3x3 copies of one chunk, by the 64 producer threads: the raw halo rows,
// 4 bytes a copy; copies outside the image (or past Cin) zero-fill.
template <typename T>
__device__ __forceinline__ void issue3(unsigned char* raw, const Pieces& pc,
                                       const Site& s, const Chunk& ch,
                                       int tile, int t, int ptid) {
  using G = Geo<C3X3, T>;
  constexpr int ROW_COPIES = G::RW / G::EPC;
  const T* x = static_cast<const T*>(pc.ptr[0]);
  const int C = pc.cin[0];
  const int b = tile / s.tiles_img, rem = tile % s.tiles_img;
  const int h0 = (rem / s.tiles_w) * G::TH - 1;
  const int c0w = (rem % s.tiles_w) * G::TW - G::EPC;
  const long long img = (long long)t * s.B + b;
  constexpr int n = G::KC * G::IH * ROW_COPIES;
  for (int q = ptid; q < n; q += 64) {
    const int cl = q / (G::IH * ROW_COPIES);
    const int row = (q / ROW_COPIES) % G::IH, k = q % ROW_COPIES;
    const int c = ch.c0 + cl, h = h0 + row, w = c0w + k * G::EPC;
    const bool ok = c < C && h >= 0 && h < s.H && w >= 0 && w < s.W;
    const T* src = x + (ok ? ((img * C + c) * s.H + h) * s.W + w : 0);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(raw + (cl * G::IH + row) * G::RB + k * 4)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

// 3x3 stride-2 copies of one chunk, by the 64 producer threads: a thread
// takes (halo row, copy) pairs, works out each one's source and whether it
// lies in the image once, and issues its copy for the chunk's 16 channels;
// copies outside the image (or past Cin) zero-fill.
template <int OP, typename T>
__device__ __forceinline__ void issue3s2(unsigned char* raw,
                                         const Pieces& pc, const Site& s,
                                         const Chunk& ch, int tile, int t,
                                         int ptid) {
  using G = Geo<OP, T>;
  constexpr int CB = G::EPC * (int)sizeof(T);  // bytes a copy
  constexpr int ROW_COPIES = G::RW / G::EPC;
  const T* x = static_cast<const T*>(pc.ptr[0]);
  const int C = pc.cin[0];
  const int b = tile / s.tiles_img, rem = tile % s.tiles_img;
  const int h0 = (rem / s.tiles_w) * 2 * G::TH - 1;
  const int c0w = (rem % s.tiles_w) * 2 * G::TW - G::EPC;
  const long long HW = (long long)s.H * s.W;
  const T* img = x + (((long long)t * s.B + b) * C + ch.c0) * HW;
  const int ncl = C - ch.c0;  // channels of the chunk in the input
  for (int pr = ptid; pr < G::IH * ROW_COPIES; pr += 64) {
    const int row = pr / ROW_COPIES, k = pr - row * ROW_COPIES;
    const int h = h0 + row, w = c0w + k * G::EPC;
    const bool in = h >= 0 && h < s.H && w >= 0 && w < s.W;
    const T* src = img + (in ? (long long)h * s.W + w : 0);
    unsigned char* dst = raw + row * G::RB + k * CB;
#pragma unroll 4
    for (int cl = 0; cl < G::KC; ++cl) {
      const bool ok = in && cl < ncl;
      cp_async_n<CB>(dst, ok ? src : x, ok);
      src += HW;
      dst += G::IH * G::RB;
    }
  }
}

// 1x1 widen: thread ptid takes channel group ptid % 8 and row group
// ptid / 8: 8 channels x 8 pixels read, widened, transposed, and 8
// 16-byte stores of 8 channels (one a pixel).
template <typename T>
__device__ __forceinline__ void widen1(unsigned char* st,
                                       const unsigned char* raw, int ptid) {
  using G = Geo<C1X1, T>;
  const int cg = ptid & 7, rg = ptid >> 3;
  uint32_t v[8][4];
#pragma unroll
  for (int cc = 0; cc < 8; ++cc) {
    const unsigned char* row = raw + (8 * cg + cc) * G::ROW;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = (8 * rg + 4 * h) * (int)sizeof(T);  // byte in the row
      widen4(reinterpret_cast<const T*>(
                 row + ((((o >> 4) ^ (cg & 3)) << 4) | (o & 15))),
             &v[cc][2 * h]);
    }
  }
  unsigned char* dst = st + cg * G::A_LBO + rg * 8 * 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t sel = (i & 1) ? 0x7632 : 0x5410;
    uint4 o;
    o.x = __byte_perm(v[0][i >> 1], v[1][i >> 1], sel);
    o.y = __byte_perm(v[2][i >> 1], v[3][i >> 1], sel);
    o.z = __byte_perm(v[4][i >> 1], v[5][i >> 1], sel);
    o.w = __byte_perm(v[6][i >> 1], v[7][i >> 1], sel);
    *reinterpret_cast<uint4*>(dst + i * 16) = o;
  }
}

// 3x3 widen. int8: one (8-channel group, halo row, 4 pixels) item at a
// time: two 4-byte raw reads a channel, funnel-shifted to the item's 4
// pixels, and 4 16-byte stores (one a pixel). Other dtypes: one
// (8-channel group, halo pixel) item at a time, 8 raw reads and one
// 16-byte store.
template <typename T>
__device__ __forceinline__ void widen3(unsigned char* st,
                                       const unsigned char* raw, int ptid) {
  using G = Geo<C3X3, T>;
  constexpr int PIX = G::IH * G::IW;
  constexpr int CS = G::IH * G::RB;  // raw bytes between channels
  if constexpr (sizeof(T) == 1) {
    constexpr int QUADS = (G::IW + 3) / 4;
    constexpr int n = G::KC / 8 * G::IH * QUADS;
    for (int q = ptid; q < n; q += 64) {
      const int cg = q / (G::IH * QUADS);
      const int hy = (q / QUADS) % G::IH, m = q % QUADS;
      // halo pixel hx = 4m + j is raw byte EPC - 1 + hx = 3 + 4m + j
      const unsigned char* r = raw + (8 * cg * G::IH + hy) * G::RB + 4 * m;
      uint32_t x[8];
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const uint32_t* wp = reinterpret_cast<const uint32_t*>(r + cc * CS);
        x[cc] = __funnelshift_r(wp[0], wp[1], 24);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * m + j >= G::IW) break;
        uint32_t o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(
              (float)(int8_t)(x[2 * k] >> (8 * j)),
              (float)(int8_t)(x[2 * k + 1] >> (8 * j)));
          o[k] = *reinterpret_cast<const uint32_t*>(&b);
        }
        *reinterpret_cast<uint4*>(st + cg * G::A_LBO +
                                  (hy * G::IW + 4 * m + j) * 16) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  } else {
    constexpr int n = G::KC / 8 * PIX;
    for (int q = ptid; q < n; q += 64) {
      const int cg = q / PIX, pix = q % PIX;
      const int hy = pix / G::IW, hx = pix % G::IW;
      const T* r = reinterpret_cast<const T*>(raw + (8 * cg * G::IH + hy) *
                                                        G::RB) +
                   (G::EPC - 1 + hx);
      constexpr int CE = CS / (int)sizeof(T);  // elements between channels
      uint4 o;
      o.x = pack_bf16(to_bf16(r[0]), to_bf16(r[CE]));
      o.y = pack_bf16(to_bf16(r[2 * CE]), to_bf16(r[3 * CE]));
      o.z = pack_bf16(to_bf16(r[4 * CE]), to_bf16(r[5 * CE]));
      o.w = pack_bf16(to_bf16(r[6 * CE]), to_bf16(r[7 * CE]));
      *reinterpret_cast<uint4*>(st + cg * G::A_LBO + pix * 16) = o;
    }
  }
}

// Element e of a 4-byte raw word as the bf16 multiply operand's bits.
template <typename T>
__device__ __forceinline__ uint32_t word_bf16(uint32_t x, int e) {
  if constexpr (sizeof(T) == 1)
    return __bfloat16_as_ushort(
        __float2bfloat16_rn((float)(int8_t)(x >> (8 * e))));
  else if constexpr (sizeof(T) == 2)
    return (x >> (16 * e)) & 0xffff;
  else
    return __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(x)));
}

// 3x3 stride-2 widen and scatter: one (8-channel group, halo row, raw
// word) item at a time: the word of each of the 8 channels (4 / sizeof(T)
// halo pixels), widened and packed into one 16-byte store a pixel, into
// the parity plane of the pixel's row and column; the EPC - 1 columns
// copied before the halo are dropped.
template <int OP, typename T>
__device__ __forceinline__ void widen3s2(unsigned char* st,
                                         const unsigned char* raw,
                                         int ptid) {
  using G = Geo<OP, T>;
  constexpr int EPW = 4 / (int)sizeof(T);  // elements a word
  constexpr int OFF = G::EPC - 1;          // raw elements before the halo
  constexpr int W0 = OFF / EPW;            // first word with a halo pixel
  constexpr int WORDS = G::RB / 4 - W0;    // words with halo pixels a row
  constexpr int CS = G::IH * G::RB;        // raw bytes between channels
  constexpr int n = G::KC / 8 * G::IH * WORDS;
  for (int q = ptid; q < n; q += 64) {
    const int cg = q / (G::IH * WORDS);
    const int i = (q / WORDS) % G::IH, w = W0 + q % WORDS;
    const unsigned char* r = raw + (8 * cg * G::IH + i) * G::RB + 4 * w;
    uint32_t x[8];
#pragma unroll
    for (int cc = 0; cc < 8; ++cc)
      x[cc] = *reinterpret_cast<const uint32_t*>(r + cc * CS);
    unsigned char* row = st + cg * G::A_LBO + (i & 1) * 2 * G::PLANE +
                         (i >> 1) * G::PW * 16;
#pragma unroll
    for (int e = 0; e < EPW; ++e) {
      const int j = EPW * w + e - OFF;  // halo column
      if (j < 0) continue;
      uint4 o;
      o.x = word_bf16<T>(x[0], e) | (word_bf16<T>(x[1], e) << 16);
      o.y = word_bf16<T>(x[2], e) | (word_bf16<T>(x[3], e) << 16);
      o.z = word_bf16<T>(x[4], e) | (word_bf16<T>(x[5], e) << 16);
      o.w = word_bf16<T>(x[6], e) | (word_bf16<T>(x[7], e) << 16);
      *reinterpret_cast<uint4*>(row + (j & 1) * G::PLANE + (j >> 1) * 16) =
          o;
    }
  }
}

// ---------------------------------------------------------------- kernel

template <typename T, int OP, int NW>
__global__ void __launch_bounds__(THREADS, 1) conv_wgmma_kernel(
    Pieces pc, const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ a_ptr, int8_t* __restrict__ out, Site s,
    int chunk) {
  using G = Geo<OP, T>;
  constexpr int R = NW / 2;  // accumulators (and membranes) a thread
  constexpr int STAGES = G::STAGES, RS = G::RAW_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<OP, T> lay(NW, s.kp);
  const int kp8 = s.kp / 8;
  unsigned char* sW = smem;
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  // bars, per consumer c: full[STAGES], empty[STAGES]
  constexpr int NB = 2 * STAGES;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * chunk;
  const int nvalid = min(chunk, s.Cout - n0);
  int Cin = 0;
  for (int j = 0; j < pc.n; ++j) Cin += pc.cin[j];

  // resident weights of the chunk, zero past nvalid and in the padding
  for (int q = tid; q < G::TAPS * kp8 * NW; q += THREADS) {
    const int n = q % NW, kg = (q / NW) % kp8, tap = q / (NW * kp8);
    int kp = 8 * kg, coff = 0, j = 0;
    for (; j < pc.n - 1; ++j) {
      const int kpj = round_up(pc.cin[j], G::KC);
      if (kp < kpj) break;
      kp -= kpj;
      coff += pc.cin[j];
    }
    const bool ok = n < nvalid && kp < pc.cin[j];
    const long long co = n0 + n;
    const long long idx =
        OP == C1X1 ? co * Cin + coff + kp
                   : ((long long)(tap / 3) * s.Cout + co) * (3 * Cin) +
                         (tap % 3) * Cin + kp;
    cp_async16(sW + ((tap * kp8 + kg) * NW + n) * 16, ok ? w + idx : w, ok);
  }
  for (int n = tid; n < NW; n += THREADS)
    sBias[n] = n < nvalid ? bias[n0 + n] : 0.f;
  if (tid == 0) {
    for (int c = 0; c < 2; ++c) {
      uint64_t* b = bars + c * NB;
      for (int i = 0; i < STAGES; ++i) {
        mbar_init(&b[i], 64);
        mbar_init(&b[STAGES + i], 128);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  // the warpgroup index, broadcast so that the compiler sees it uniform
  // (wgmma on a path it cannot prove warpgroup-uniform is serialized)
  const int wg = __shfl_sync(0xffffffff, tid >> 7, 0);
  // consumer c's tiles: first, first + stride, ...; nq work steps
  const int c = wg == 0 ? tid >> 6 : wg - 1;
  const int first = 2 * blockIdx.x + c, stride = 2 * gridDim.x;
  const int nck = s.kp / G::KC;
  const int my_tiles =
      first < s.n_tiles ? (s.n_tiles - 1 - first) / stride + 1 : 0;
  const int nq = my_tiles * s.steps * nck;
  unsigned char* ring = smem + lay.ring + c * STAGES * G::STAGE;
  uint64_t* full = bars + c * NB;
  uint64_t* empty = full + STAGES;

  if (wg == 0) {
    // ------------------------------------------------------ producers
    // 64 threads a consumer: every thread issues cp.async copies, which
    // run RS - 1 chunks ahead of the widening.
    const int ptid = tid & 63;
    unsigned char* raw = smem + lay.raw + c * RS * G::RAW;
    auto fetch = [&](int q) {
      if (q < nq) {
        const Work wk = work_at(q, first, stride, s.steps, nck);
        const Chunk ch = chunk_at<G::KC>(pc, wk.ci);
        unsigned char* dst = raw + (q % RS) * G::RAW;
        if constexpr (OP == C1X1)
          issue1<T>(dst, pc, s, ch, wk.tile, wk.t, ptid);
        else if constexpr (OP == C3X3)
          issue3<T>(dst, pc, s, ch, wk.tile, wk.t, ptid);
        else
          issue3s2<OP, T>(dst, pc, s, ch, wk.tile, wk.t, ptid);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    for (int q = 0; q < RS - 1; ++q) fetch(q);
    for (int q = 0; q < nq; ++q) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(RS - 2) : "memory");
      // every copy of chunk q landed; every widen of chunk q - 1 is done
      named_sync(3 + c, 64);
      fetch(q + RS - 1);
      const int st = q % STAGES, k = q / STAGES;
      if (k > 0) mbar_wait(&empty[st], (k - 1) & 1);
      const unsigned char* src = raw + (q % RS) * G::RAW;
      if constexpr (OP == C1X1)
        widen1<T>(ring + st * G::STAGE, src, ptid);
      else if constexpr (OP == C3X3)
        widen3<T>(ring + st * G::STAGE, src, ptid);
      else
        widen3s2<OP, T>(ring + st * G::STAGE, src, ptid);
      fence_proxy_async();
      mbar_arrive(&full[st]);
    }
    return;
  }

  // -------------------------------------------------------- consumers
  const int ctid = tid & 127;
  const int wq = ctid >> 5, lane = ctid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const uint32_t ring_a = smem_u32(ring), w_a = smem_u32(sW);
  int8_t* sO = reinterpret_cast<int8_t*>(smem + lay.out) + c * NW * G::OUT_LD;
  const float a = *a_ptr;
  float acc[R], v[R];
  int prev = 0;
  for (int q = 0; q < nq; ++q) {
    const Work wk = work_at(q, first, stride, s.steps, nck);
    const Chunk ch = chunk_at<G::KC>(pc, wk.ci);
    if (wk.ci == 0 && wk.t == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = 0.f;
    }
    const int st = q % STAGES;
    mbar_wait(&full[st], (q / STAGES) & 1);
    wgmma_fence();
    const uint32_t sa = ring_a + st * G::STAGE;
#pragma unroll
    for (int tap = 0; tap < G::TAPS; ++tap) {
#pragma unroll
      for (int ks = 0; ks < G::KC / 16; ++ks) {
        const uint64_t da = make_desc(
            sa + 2 * ks * G::A_LBO + G::tap_off(tap), G::A_LBO, G::A_SBO);
        const uint64_t db = make_desc(
            w_a + ((tap * kp8 + ch.kp0 / 8 + 2 * ks) * NW) * 16, NW * 16,
            128);
        Wgmma<NW>::run(acc, da, db,
                       wk.ci == 0 && tap == 0 && ks == 0 ? 0 : 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (wk.ci > 0) mbar_arrive(&empty[prev]);
    prev = st;
    if (wk.ci < nck - 1) continue;
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);

    // epilogue: bias and one PLIF step a value; the spikes go to the
    // stage sO[n][pixel], then out as NCHW row segments. 1x1: 16-, 8- or
    // 4-byte segments (the tile's 64 pixels of a channel are contiguous
    // within an image); 3x3 (both strides): the 8-byte rows of the 8x8
    // tile.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = 16 * wq + g + ((i & 2) ? 8 : 0);
      const int col = 8 * (i >> 2) + 2 * tig + (i & 1);
      const float pre = __fadd_rn(sBias[col], acc[i]);
      sO[col * G::OUT_LD + row] = plif_step(v[i], pre, a, s.th, s.ge);
    }
    named_sync(1 + c, 128);
    if constexpr (OP == C1X1) {
      const int HW = s.H * s.W;
      const int vec = HW % 16 == 0 ? 16 : HW % 8 == 0 ? 8 : 4;
      const int per = M_TILE / vec;
      for (int e = ctid; e < nvalid * per; e += 128) {
        const int n = e / per, p0 = (e % per) * vec;
        const int r = wk.tile * M_TILE + p0;
        if (r >= s.R) continue;
        const int b = r / HW, p = r - b * HW;
        int8_t* dst = out + ((wk.t * (long long)s.B + b) * s.Cout + n0 + n) *
                                HW + p;
        const int8_t* src = sO + n * G::OUT_LD + p0;
        if (vec == 16)
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        else if (vec == 8)
          *reinterpret_cast<uint2*>(dst) =
              *reinterpret_cast<const uint2*>(src);
        else
          *reinterpret_cast<uint32_t*>(dst) =
              *reinterpret_cast<const uint32_t*>(src);
      }
    } else {
      const int b = wk.tile / s.tiles_img, rem = wk.tile % s.tiles_img;
      const int HWo = s.Ho * s.Wo;
      const int oh0 = (rem / s.tiles_w) * G::TH;
      const int ow0 = (rem % s.tiles_w) * G::TW;
      for (int e = ctid; e < nvalid * G::TH; e += 128) {
        const int n = e / G::TH, oy = e % G::TH, oh = oh0 + oy;
        if (oh >= s.Ho) continue;
        int8_t* dst = out +
                      ((wk.t * (long long)s.B + b) * s.Cout + n0 + n) * HWo +
                      (long long)oh * s.Wo + ow0;
        const int8_t* src = sO + n * G::OUT_LD + oy * G::TW;
        if (s.Wo % 8 == 0) {
          *reinterpret_cast<uint2*>(dst) =
              *reinterpret_cast<const uint2*>(src);
        } else {
          for (int i = 0; i < G::TW && ow0 + i < s.Wo; ++i) dst[i] = src[i];
        }
      }
    }
    named_sync(1 + c, 128);
  }
}

// ---------------------------------------------------------------- launch

template <typename T, int OP, int NW>
cudaError_t launch_nw(const Pieces& pc, const void* w, const void* bias,
                      const void* a, void* out, const Site& s, int chunk,
                      int n_chunks, int grid_x, cudaStream_t stream) {
  Site st = s;
  st.kp = padded_k<Geo<OP, T>::KC>(pc);
  const int bytes = Smem<OP, T>(NW, st.kp).bytes;
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  static int set_bytes = 0;
  if (bytes > set_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_wgmma_kernel<T, OP, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    set_bytes = bytes;
  }
  conv_wgmma_kernel<T, OP, NW><<<dim3(grid_x, n_chunks), THREADS, bytes,
                                 stream>>>(
      pc, (const __nv_bfloat16*)w, (const float*)bias, (const float*)a,
      (int8_t*)out, st, chunk);
  return cudaGetLastError();
}

template <typename T, int OP>
cudaError_t launch_t(int nw, const Pieces& pc, const void* w,
                     const void* bias, const void* a, void* out,
                     const Site& s, int chunk, int n_chunks, int grid_x,
                     cudaStream_t stream) {
  switch (nw) {
    case 32:
      return launch_nw<T, OP, 32>(pc, w, bias, a, out, s, chunk, n_chunks,
                                  grid_x, stream);
    case 48:
      return launch_nw<T, OP, 48>(pc, w, bias, a, out, s, chunk, n_chunks,
                                  grid_x, stream);
    case 64:
      return launch_nw<T, OP, 64>(pc, w, bias, a, out, s, chunk, n_chunks,
                                  grid_x, stream);
    case 96:
      return launch_nw<T, OP, 96>(pc, w, bias, a, out, s, chunk, n_chunks,
                                  grid_x, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Checks what the host decided (the wrapper's conv_plan) and dispatches
// on the input dtype: 0 = f32, 1 = bf16, 2 = int8.
template <int OP>
cudaError_t launch(int dtype, const Pieces& pc, const void* w,
                   const void* bias, const void* a, void* out, Site s,
                   int nw, int chunk, int n_chunks, int grid_x,
                   cudaStream_t stream) {
  bool ok = (uintptr_t)w % 16 == 0 && (uintptr_t)out % 16 == 0 &&
            chunk >= 1 && chunk <= nw && n_chunks >= 1 &&
            (long long)chunk * n_chunks >= s.Cout &&
            (long long)chunk * (n_chunks - 1) < s.Cout && grid_x >= 1 &&
            s.B >= 1 && s.steps >= 1 && s.H >= 1 && s.W >= 1 &&
            // pixel and image indices stay in 32 bits
            (long long)s.B * s.steps * s.H * s.W < (1LL << 31);
  for (int j = 0; j < pc.n; ++j)
    ok = ok && pc.cin[j] >= 8 && pc.cin[j] % 8 == 0 &&
         (uintptr_t)pc.ptr[j] % 16 == 0;
  // 1x1: H*W in whole 16-byte copies; 3x3: rows of whole 4-byte copies
  const int esize = dtype == 0 ? 4 : dtype == 1 ? 2 : 1;
  ok = ok && (OP == C1X1 ? ((long long)s.H * s.W * esize) % 16
                         : (s.W * esize) % 4) == 0;
  if (!ok) return cudaErrorInvalidValue;
  if (OP == C1X1) {
    s.Ho = s.H;
    s.Wo = s.W;
    s.R = s.B * s.H * s.W;
    s.tiles_w = s.tiles_img = 0;
    s.n_tiles = (s.R + M_TILE - 1) / M_TILE;
  } else {
    const int stride = OP == C3X3S2 || OP == C3X3S2V ? 2 : 1;
    s.Ho = (s.H - 1) / stride + 1;
    s.Wo = (s.W - 1) / stride + 1;
    s.R = 0;
    s.tiles_w = (s.Wo + TILE - 1) / TILE;
    s.tiles_img = s.tiles_w * ((s.Ho + TILE - 1) / TILE);
    s.n_tiles = s.B * s.tiles_img;
  }
  switch (dtype) {
    case 0:
      return launch_t<float, OP>(nw, pc, w, bias, a, out, s, chunk, n_chunks,
                                 grid_x, stream);
    case 1:
      return launch_t<__nv_bfloat16, OP>(nw, pc, w, bias, a, out, s, chunk,
                                         n_chunks, grid_x, stream);
    case 2:
      return launch_t<int8_t, OP>(nw, pc, w, bias, a, out, s, chunk,
                                  n_chunks, grid_x, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ptrs/cins: host arrays of n_pieces (1..4) input pointers and channel
// counts; (nw, chunk, n_chunks, grid_x): the wgmma width, the output
// channels a block owns, the number of such chunks and the blocks a chunk
// (conv_plif.py:conv_plan).
extern "C" int conv1x1_plif(const void** ptrs, const int* cins, int n_pieces,
                            const void* w, const void* bias, const void* a,
                            void* out, int B, int steps, int Cout, int H,
                            int W, int nw, int chunk, int n_chunks,
                            int grid_x, float th, int ge, int dtype,
                            void* stream) {
  if (n_pieces < 1 || n_pieces > 4) return (int)cudaErrorInvalidValue;
  Pieces pc;
  for (int j = 0; j < 4; ++j) {
    pc.ptr[j] = j < n_pieces ? ptrs[j] : nullptr;
    pc.cin[j] = j < n_pieces ? cins[j] : 0;
  }
  pc.n = n_pieces;
  Site s{};
  s.B = B;
  s.steps = steps;
  s.Cout = Cout;
  s.H = H;
  s.W = W;
  s.th = th;
  s.ge = ge;
  return (int)launch<C1X1>(dtype, pc, w, bias, a, out, s, nw, chunk,
                           n_chunks, grid_x, (cudaStream_t)stream);
}

namespace {

template <int OP>
int conv3x3_entry(const void* x, const void* w3, const void* bias,
                  const void* a, void* out, int B, int steps, int Cin,
                  int Cout, int H, int W, int nw, int chunk, int n_chunks,
                  int grid_x, float th, int ge, int dtype, void* stream) {
  Pieces pc;
  pc.ptr[0] = x;
  pc.cin[0] = Cin;
  for (int j = 1; j < 4; ++j) {
    pc.ptr[j] = nullptr;
    pc.cin[j] = 0;
  }
  pc.n = 1;
  Site s{};
  s.B = B;
  s.steps = steps;
  s.Cout = Cout;
  s.H = H;
  s.W = W;
  s.th = th;
  s.ge = ge;
  return (int)launch<OP>(dtype, pc, w3, bias, a, out, s, nw, chunk, n_chunks,
                         grid_x, (cudaStream_t)stream);
}

}  // namespace

// x (T*B, Cin, H, W), stride 1, pad 1; arguments as above.
extern "C" int conv3x3_plif(const void* x, const void* w3, const void* bias,
                            const void* a, void* out, int B, int steps,
                            int Cin, int Cout, int H, int W, int nw,
                            int chunk, int n_chunks, int grid_x, float th,
                            int ge, int dtype, void* stream) {
  return conv3x3_entry<C3X3>(x, w3, bias, a, out, B, steps, Cin, Cout, H, W,
                             nw, chunk, n_chunks, grid_x, th, ge, dtype,
                             stream);
}

// x (T*B, Cin, H, W), stride 2, pad 1: out (T*B, Cout, ceil(H/2),
// ceil(W/2)); arguments as above.
extern "C" int conv3x3s2_plif(const void* x, const void* w3,
                              const void* bias, const void* a, void* out,
                              int B, int steps, int Cin, int Cout, int H,
                              int W, int nw, int chunk, int n_chunks,
                              int grid_x, float th, int ge, int dtype,
                              void* stream) {
  const int esize = dtype == 0 ? 4 : dtype == 1 ? 2 : 1;
  if ((W * esize) % 16 == 0)
    return conv3x3_entry<C3X3S2V>(x, w3, bias, a, out, B, steps, Cin, Cout,
                                  H, W, nw, chunk, n_chunks, grid_x, th, ge,
                                  dtype, stream);
  return conv3x3_entry<C3X3S2>(x, w3, bias, a, out, B, steps, Cin, Cout, H,
                               W, nw, chunk, n_chunks, grid_x, th, ge, dtype,
                               stream);
}
