// PLIF forward over T time steps with the site's BatchNorm folded in front
// of it: int8 spikes at eval (plif_fwd), spikes in x's dtype in training
// (plif_train_fwd).
//
// Replaces: eas_snn_tpu/ops/plif_pallas.py:_fwd_kernel (pallas_call at
// :302, via plif_fused(out_int8='direct')) at eval, and
// plif_pallas.py:_fwd_kernel_aff (pallas_call at :389, the train-mode BN
// normalize fused into the PLIF forward) in training. At eval the BN is the
// running-statistics one (on the TPU eas_snn_tpu/models/blocks.py:256-296
// leaves it to XLA, which fuses it); in training its (mean, mul, bias) come
// from the batch statistics. Both compute y = (x - mean[c]) * mul[c] +
// bias[c] in f32, rounded to the storage dtype, which is what the plain BN
// computes. A caller without a BN passes the identity terms (0, 1, 0),
// which leave x unchanged bit for bit.
//
// x is the (T*B, C, H, W) conv output, t-major, in bf16 or f32. Each
// element is independent across B*C*H*W and sequential over T. The work is
// cut into items of E adjacent elements of one (b, c) plane, one item a
// thread, with a 32-bit (plane, item) decomposition: item q lies in plane
// p = q / ipp (ipp = H*W / E items a plane), whose channel is p % C. The
// host plan (ops/plif.py:plif_fwd_plan) picks E: one 16-byte vector (8
// bf16 or 4 f32 elements) where H*W splits into them; else, for a ragged
// H*W or an unaligned x, one element (the scalar tail: loads and stores
// one element wide, still adjacent across the warp). At T <= 8 the steps
// are unrolled and all T loads are issued before the recurrence runs;
// larger T runs a loop over the steps.
//
// Bound on the H100: bytes. Per element and step it reads 2 (bf16) or 4
// (f32) bytes and writes 1 (eval) or 2/4 (train), for ~9 flops: ~3
// flop/byte, far below the ~20 flop/byte where f32 CUDA-core arithmetic
// would bind. The design moves each byte once (the BN output and the
// membrane never leave registers) and keeps T * 16 bytes of loads in
// flight a thread; nothing is staged in shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename Out> __device__ __forceinline__ Out spike_as(int8_t s);
template <> __device__ __forceinline__ int8_t spike_as<int8_t>(int8_t s) {
  return s;
}
template <> __device__ __forceinline__ float spike_as<float>(int8_t s) {
  return s ? 1.f : 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 spike_as<__nv_bfloat16>(int8_t s) {
  return __float2bfloat16_rn(s ? 1.f : 0.f);
}

// Blocks an SM the registers must allow: all T raw loads stay in
// registers at T <= 4; a longer unrolled recurrence gets more of them.
constexpr int min_blocks(int steps) { return steps <= 4 ? 4 : 2; }

// One step of E elements: spikes of the BN output of `in`, stored at o.
template <typename T, typename Out, int E>
__device__ __forceinline__ void fwd_step(const Vals<T, E>& in, Out* o,
                                         float (&v)[E], float a, float th,
                                         int ge, float mn, float ml,
                                         float bs) {
  T buf[E];
  in.get(buf);
  Out s[E];
#pragma unroll
  for (int i = 0; i < E; ++i)
    s[i] = spike_as<Out>(
        plif_step(v[i], bn_apply(to_f32(buf[i]), mn, ml, bs, T()), a, th, ge));
  Vals<Out, E> sv;
  sv.set(s);
  sv.store(o);
}

// STEPS > 0: T = STEPS, unrolled; STEPS == 0: T = steps, looped.
template <typename T, typename Out, int E, int STEPS>
__global__ void __launch_bounds__(kThreads, min_blocks(STEPS))
    plif_fwd_kernel(const T* __restrict__ x, Out* __restrict__ out,
                    const float* __restrict__ a_ptr, long long n, int steps,
                    float th, int ge, const float* __restrict__ mean,
                    const float* __restrict__ mul,
                    const float* __restrict__ bias, unsigned C, unsigned HW,
                    unsigned ipp, unsigned items) {
  const unsigned q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= items) return;
  const unsigned p = q / ipp;
  const unsigned c = p % C;
  const unsigned off = p * HW + (q - p * ipp) * E;
  const float a = *a_ptr, mn = mean[c], ml = mul[c], bs = bias[c];
  const T* xs = x + off;
  Out* os = out + off;
  float v[E];
#pragma unroll
  for (int i = 0; i < E; ++i) v[i] = 0.f;
  if constexpr (STEPS > 0) {
    Vals<T, E> in[STEPS];
#pragma unroll
    for (int t = 0; t < STEPS; ++t) in[t].load(xs + t * n);
#pragma unroll
    for (int t = 0; t < STEPS; ++t)
      fwd_step<T, Out, E>(in[t], os + t * n, v, a, th, ge, mn, ml, bs);
  } else {
    for (int t = 0; t < steps; ++t) {
      Vals<T, E> in;
      in.load(xs + t * n);
      fwd_step<T, Out, E>(in, os + t * n, v, a, th, ge, mn, ml, bs);
    }
  }
}

template <typename T, typename Out, int E>
cudaError_t launch_steps(const T* x, Out* out, const float* a, long long n,
                         int steps, float th, int ge, const float* mean,
                         const float* mul, const float* bias, unsigned C,
                         unsigned HW, unsigned grid, cudaStream_t s) {
  const unsigned ipp = HW / E, items = (unsigned)(n / E);
#define PLIF_FWD_STEPS(N)                                                  \
  case N:                                                                  \
    plif_fwd_kernel<T, Out, E, N><<<grid, kThreads, 0, s>>>(              \
        x, out, a, n, steps, th, ge, mean, mul, bias, C, HW, ipp, items); \
    break;
  switch (steps) {
    PLIF_FWD_STEPS(1)
    PLIF_FWD_STEPS(2)
    PLIF_FWD_STEPS(3)
    PLIF_FWD_STEPS(4)
    PLIF_FWD_STEPS(5)
    PLIF_FWD_STEPS(6)
    PLIF_FWD_STEPS(7)
    PLIF_FWD_STEPS(8)
    default:
      plif_fwd_kernel<T, Out, E, 0><<<grid, kThreads, 0, s>>>(
          x, out, a, n, steps, th, ge, mean, mul, bias, C, HW, ipp, items);
  }
#undef PLIF_FWD_STEPS
  return cudaGetLastError();
}

template <typename T, typename Out>
cudaError_t launch(const void* x, void* out, const void* a, long long n,
                   int steps, float th, int ge, const float* mean,
                   const float* mul, const float* bias, int C, int HW, int E,
                   int grid, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  // an item of E elements must lie in one plane, every item at an address
  // aligned to its chunks, and the grid must cover every item
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out;
  if ((E != 1 && E != VEC) || HW % E ||
      (E > 1 && align % 16) || (long long)grid * kThreads < n / E)
    return cudaErrorInvalidValue;
  const T* xp = (const T*)x;
  Out* op = (Out*)out;
  const float* ap = (const float*)a;
  if (E == VEC)
    return launch_steps<T, Out, VEC>(xp, op, ap, n, steps, th, ge, mean, mul,
                                     bias, C, HW, grid, s);
  return launch_steps<T, Out, 1>(xp, op, ap, n, steps, th, ge, mean, mul,
                                 bias, C, HW, grid, s);
}

// train: spikes in x's dtype; eval: int8
template <bool TRAIN>
int dispatch(const void* x, void* out, const void* a, long long n, int steps,
             float th, int ge, int dtype, const void* mean, const void* mul,
             const void* bias, int C, int HW, int E, int grid, void* stream) {
  if (n <= 0) return 0;
  if (!mean || !mul || !bias || C < 1 || HW < 1 || steps < 1 || grid < 1 ||
      n % ((long long)C * HW) || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* m = (const float*)mean;
  const float* k = (const float*)mul;
  const float* b = (const float*)bias;
  if (dtype == 0)
    return (int)launch<float, typename std::conditional<TRAIN, float,
                                                        int8_t>::type>(
        x, out, a, n, steps, th, ge, m, k, b, C, HW, E, grid, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16,
                       typename std::conditional<TRAIN, __nv_bfloat16,
                                                 int8_t>::type>(
        x, out, a, n, steps, th, ge, m, k, b, C, HW, E, grid, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (steps * n) elements of an NCHW tensor with C channels of HW pixels,
// dtype 0 = f32, 1 = bf16; out: int8 (plif_fwd) or x's dtype
// (plif_train_fwd), same count; a: device pointer to the f32 decay
// multiplier 1 - sigmoid(w); mean, mul, bias: f32 per-channel BN; E, grid:
// the plan's item width (1, or one 16-byte vector) and blocks of 256
// threads (ops/plif.py:plif_fwd_plan). n < 2^31: offsets within a step
// are 32-bit.
extern "C" int plif_fwd(const void* x, void* out, const void* a, long long n,
                        int steps, float th, int ge, int dtype,
                        const void* mean, const void* mul, const void* bias,
                        int C, int HW, int E, int grid, void* stream) {
  return dispatch<false>(x, out, a, n, steps, th, ge, dtype, mean, mul, bias,
                         C, HW, E, grid, stream);
}

extern "C" int plif_train_fwd(const void* x, void* out, const void* a,
                              long long n, int steps, float th, int ge,
                              int dtype, const void* mean, const void* mul,
                              const void* bias, int C, int HW, int E,
                              int grid, void* stream) {
  return dispatch<true>(x, out, a, n, steps, th, ge, dtype, mean, mul, bias,
                        C, HW, E, grid, stream);
}
