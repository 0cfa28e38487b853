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
// element is independent across B*C*H*W and sequential over T, so one
// thread owns VEC adjacent elements (of one channel), keeps their f32
// membranes in registers for all T steps, reads x_t with one 16-byte load
// and writes the VEC spikes with one store. The entry points refuse a
// layout that does not split into such vectors (x or out not 16-byte
// aligned, H*W not a multiple of VEC).
//
// Bound on the H100: bytes. Per element and step it reads 2 (bf16) or 4
// (f32) bytes and writes 1 (eval) or 2/4 (train), for ~9 flops: ~3
// flop/byte, far below the ~20 flop/byte where f32 CUDA-core arithmetic
// would bind. The design moves each byte once (the BN output and the
// membrane never leave registers) with 16-byte vector loads and a
// grid-stride loop; nothing is staged in shared memory.
#include "common.cuh"

namespace {

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

template <typename T, typename Out, int VEC>
__global__ void __launch_bounds__(256) plif_fwd_kernel(
    const T* __restrict__ x, Out* __restrict__ out,
    const float* __restrict__ a_ptr, long long n, int steps, float th,
    int ge, const float* __restrict__ mean, const float* __restrict__ mul,
    const float* __restrict__ bias, int C, int HW) {
  using RawIn = typename Raw<sizeof(T) * VEC>::type;
  using RawOut = typename Raw<sizeof(Out) * VEC>::type;
  const float a = *a_ptr;
  const long long groups = n / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int c = (int)((g * VEC / HW) % C);
    const float mn = mean[c], ml = mul[c], bs = bias[c];
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    for (int t = 0; t < steps; ++t) {
      const long long off = (long long)t * n + g * VEC;
      RawIn raw = *reinterpret_cast<const RawIn*>(x + off);
      T buf[VEC];
      memcpy(buf, &raw, sizeof(raw));
      Out s[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        s[i] = spike_as<Out>(plif_step(
            v[i], bn_apply(to_f32(buf[i]), mn, ml, bs, T()), a, th, ge));
      RawOut o;
      memcpy(&o, s, sizeof(o));
      *reinterpret_cast<RawOut*>(out + off) = o;
    }
  }
}

template <typename T, typename Out>
cudaError_t launch(const void* x, void* out, const void* a, long long n,
                   int steps, float th, int ge, const float* mean,
                   const float* mul, const float* bias, int C, int HW,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // a vector of VEC elements must be aligned and lie in one channel
  if (HW % VEC != 0 || ((uintptr_t)x % 16) != 0 || ((uintptr_t)out % 16) != 0)
    return cudaErrorInvalidValue;
  long long blocks = (n / VEC + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  plif_fwd_kernel<T, Out, VEC><<<(unsigned)blocks, 256, 0, stream>>>(
      (const T*)x, (Out*)out, (const float*)a, n, steps, th, ge, mean, mul,
      bias, C, HW);
  return cudaGetLastError();
}

// train: spikes in x's dtype; eval: int8
template <bool TRAIN>
int dispatch(const void* x, void* out, const void* a, long long n, int steps,
             float th, int ge, int dtype, const void* mean, const void* mul,
             const void* bias, int C, int HW, void* stream) {
  if (n <= 0) return 0;
  if (!mean || !mul || !bias || C < 1 || HW < 1 || n % ((long long)C * HW))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* m = (const float*)mean;
  const float* k = (const float*)mul;
  const float* b = (const float*)bias;
  if (dtype == 0)
    return (int)launch<float, typename std::conditional<TRAIN, float,
                                                        int8_t>::type>(
        x, out, a, n, steps, th, ge, m, k, b, C, HW, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16,
                       typename std::conditional<TRAIN, __nv_bfloat16,
                                                 int8_t>::type>(
        x, out, a, n, steps, th, ge, m, k, b, C, HW, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (steps * n) elements of an NCHW tensor with C channels of HW pixels,
// dtype 0 = f32, 1 = bf16; out: int8 (plif_fwd) or x's dtype
// (plif_train_fwd), same count; a: device pointer to the f32 decay
// multiplier 1 - sigmoid(w); mean, mul, bias: f32 per-channel BN.
extern "C" int plif_fwd(const void* x, void* out, const void* a, long long n,
                        int steps, float th, int ge, int dtype,
                        const void* mean, const void* mul, const void* bias,
                        int C, int HW, void* stream) {
  return dispatch<false>(x, out, a, n, steps, th, ge, dtype, mean, mul, bias,
                         C, HW, stream);
}

extern "C" int plif_train_fwd(const void* x, void* out, const void* a,
                              long long n, int steps, float th, int ge,
                              int dtype, const void* mean, const void* mul,
                              const void* bias, int C, int HW, void* stream) {
  return dispatch<true>(x, out, a, n, steps, th, ge, dtype, mean, mul, bias,
                        C, HW, stream);
}
