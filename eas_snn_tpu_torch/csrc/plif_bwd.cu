// PLIF backward over T time steps with the train-mode BatchNorm folded in
// front of the neuron: dx in x's dtype, and deterministic f32 sums da (the
// decay multiplier's gradient), ds, db and dm per channel.
//
// Replaces: eas_snn_tpu/ops/plif_pallas.py:_bwd_kernel_aff (pallas_call at
// :419, the backward of the train PLIF op with the BN normalize fused in)
// and, with the identity BN terms (mean 0, mul 1, bias 0, exact in both
// dtypes), plif_pallas.py:_bwd_kernel (pallas_call at :338).
//
// Per element, with xm = x - mean, a = 1 - sigmoid(w), th the threshold
// and f' the surrogate derivative (plif_pallas.py:_surrogate_deriv):
//   forward, recomputed in f32 exactly as csrc/plif.cu computes it:
//     v_t = v_{t-1} * a + round(xm * mul + bias); s_t = [v_t - th (>=|>) 0];
//     v_t <- v_t - th * s_t
//   backward, t = T-1 ... 0, from g_after = 0:
//     g_pre = g_after + (g_t - th * g_after) * f'(v_pre_t - th)
//     dx_t = g_pre * mul (rounded to x's dtype)
//     da += g_pre * v_after_{t-1}; ds += g_pre * xm; db += g_pre
//     g_after = g_pre * a
//   dm = -mul * db.
// Every float operation has an explicit _rn intrinsic (no FMA contraction)
// and the atan term divides exactly (__fdiv_rn), so dx equals the plain
// PyTorch backward bit for bit on the same card.
//
// Layout and grid: x, g and dx are (T*B, C, H, W), t-major. Pass 1 gives
// each channel NB blocks; a block walks a fixed range of that channel's
// B*H*W/VEC vectors (a vector is VEC adjacent elements of one (b, c)
// plane, one 16-byte load) and one thread keeps a vector's membranes for
// all T steps in registers. The sums are taken in a fixed order: each
// thread over its vectors, then warp shuffles and the block's warps in a
// fixed tree, into partials[c][block] (no float atomics). Pass 2 (one block
// a channel) sums a channel's partials in a fixed tree into ds, db, dm and
// the channel's share of da; pass 3 (one block) sums those shares into da.
// The run-to-run result is therefore identical.
//
// Bound on the H100: bytes. Per element it reads x and g and writes dx:
// 6 bytes in bf16 (12 in f32) for ~25 flops, ~4 flop/byte, below the ~20
// where f32 CUDA-core arithmetic would bind. Each byte moves once, the
// recomputed forward never leaves registers, and the partials are a few
// KB.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// f'(x) of the surrogate `kind` (0 atan, 1 rect, 2 sigmoid, 3 tanh) with
// its host-computed constants p0, p1 (see plif_train_bwd).
__device__ __forceinline__ float surrogate_deriv(int kind, float p0, float p1,
                                                 float x) {
  switch (kind) {
    case 0: {  // (alpha/2) / (1 + t*t), t = ((pi/2) * alpha) * x
      const float t = __fmul_rn(p0, x);
      return __fdiv_rn(p1, __fadd_rn(1.f, __fmul_rn(t, t)));
    }
    case 1:  // [|x| < 0.5/alpha] * alpha
      return fabsf(x) < p0 ? p1 : 0.f;
    case 2: {  // alpha * s * (1 - s), s = sigmoid(alpha * x)
      const float s =
          __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(p0, x))));
      return __fmul_rn(__fmul_rn(p1, s), __fsub_rn(1.f, s));
    }
    default: {  // (0.5 * alpha) * (1 - t*t), t = tanh(alpha * x)
      const float t = tanhf(__fmul_rn(p0, x));
      return __fmul_rn(p1, __fsub_rn(1.f, __fmul_rn(t, t)));
    }
  }
}

__device__ __forceinline__ float from_f32(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

// Sum of `v` over the block's threads in a fixed order; the result is
// valid in thread 0. `red` holds one float per warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  __syncthreads();
  return v;
}

template <typename T, int VEC, int STEPS>
__global__ void __launch_bounds__(kThreads) plif_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
    const float* __restrict__ a_ptr, const float* __restrict__ mean,
    const float* __restrict__ mul, const float* __restrict__ bias,
    float* __restrict__ partials, int B, int C, int HW, int nb, float th,
    int ge, int kind, float p0, float p1) {
  using Raw16 = typename Raw<sizeof(T) * VEC>::type;
  __shared__ float red[3][kThreads / 32];
  const int c = blockIdx.x / nb, j = blockIdx.x % nb;
  const float a = *a_ptr, mn = mean[c], ml = mul[c], bs = bias[c];
  const int hv = HW / VEC;  // vectors in a (b, c) plane
  const long long per_c = (long long)B * hv;
  const long long chunk = (per_c + nb - 1) / nb;
  const long long lo = j * chunk;
  const long long hi = lo + chunk < per_c ? lo + chunk : per_c;
  const long long n = (long long)B * C * HW;  // elements per time step
  float ds = 0.f, db = 0.f, da = 0.f;
  for (long long q = lo + threadIdx.x; q < hi; q += kThreads) {
    const long long b = q / hv;
    const long long off = (b * C + c) * HW + (q % hv) * VEC;
    float xm[STEPS][VEC], d[STEPS][VEC], vprev[STEPS][VEC];
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = 0.f;
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      Raw16 raw = *reinterpret_cast<const Raw16*>(x + t * n + off);
      T buf[VEC];
      memcpy(buf, &raw, sizeof(raw));
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        vprev[t][i] = v[i];
        xm[t][i] = __fsub_rn(to_f32(buf[i]), mn);
        const float xa = bn_apply(to_f32(buf[i]), mn, ml, bs, T());
        v[i] = __fadd_rn(__fmul_rn(v[i], a), xa);
        d[t][i] = __fsub_rn(v[i], th);
        const bool s = ge ? (d[t][i] >= 0.f) : (d[t][i] > 0.f);
        v[i] = __fsub_rn(v[i], __fmul_rn(th, s ? 1.f : 0.f));
      }
    }
    float gaf[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) gaf[i] = 0.f;
#pragma unroll
    for (int t = STEPS - 1; t >= 0; --t) {
      Raw16 raw = *reinterpret_cast<const Raw16*>(g + t * n + off);
      T buf[VEC], out[VEC];
      memcpy(buf, &raw, sizeof(raw));
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float fp = surrogate_deriv(kind, p0, p1, d[t][i]);
        const float gpre = __fadd_rn(
            gaf[i],
            __fmul_rn(__fsub_rn(to_f32(buf[i]), __fmul_rn(th, gaf[i])), fp));
        out[i] = from_f32(__fmul_rn(gpre, ml), T());
        ds = __fadd_rn(ds, __fmul_rn(gpre, xm[t][i]));
        db = __fadd_rn(db, gpre);
        da = __fadd_rn(da, __fmul_rn(gpre, vprev[t][i]));
        gaf[i] = __fmul_rn(gpre, a);
      }
      memcpy(&raw, out, sizeof(raw));
      *reinterpret_cast<Raw16*>(dx + t * n + off) = raw;
    }
  }
  ds = block_sum(ds, red[0]);
  db = block_sum(db, red[1]);
  da = block_sum(da, red[2]);
  if (threadIdx.x == 0) {
    float* p = partials + 3 * (long long)blockIdx.x;
    p[0] = ds;
    p[1] = db;
    p[2] = da;
  }
}

// One block a channel: ds, db, dm and the channel's share of da.
__global__ void __launch_bounds__(kThreads) plif_bwd_channel_sums(
    const float* __restrict__ partials, const float* __restrict__ mul,
    int nb, float* __restrict__ ds, float* __restrict__ db,
    float* __restrict__ dm, float* __restrict__ da_c) {
  __shared__ float red[3][kThreads / 32];
  const int c = blockIdx.x;
  const float* p = partials + 3 * (long long)c * nb;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    s0 = __fadd_rn(s0, p[3 * j]);
    s1 = __fadd_rn(s1, p[3 * j + 1]);
    s2 = __fadd_rn(s2, p[3 * j + 2]);
  }
  s0 = block_sum(s0, red[0]);
  s1 = block_sum(s1, red[1]);
  s2 = block_sum(s2, red[2]);
  if (threadIdx.x == 0) {
    ds[c] = s0;
    db[c] = s1;
    dm[c] = -__fmul_rn(mul[c], s1);
    da_c[c] = s2;
  }
}

// One block: da = sum over channels of their shares.
__global__ void __launch_bounds__(kThreads) plif_bwd_total(
    const float* __restrict__ da_c, int C, float* __restrict__ da) {
  __shared__ float red[kThreads / 32];
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) s = __fadd_rn(s, da_c[c]);
  s = block_sum(s, red);
  if (threadIdx.x == 0) da[0] = s;
}

template <typename T, int STEPS>
cudaError_t launch(const void* x, const void* g, void* dx, const float* a,
                   const float* mean, const float* mul, const float* bias,
                   float* partials, int B, int C, int HW, int nb, float th,
                   int ge, int kind, float p0, float p1, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  plif_bwd_kernel<T, VEC, STEPS><<<(unsigned)((long long)C * nb), kThreads,
                                   0, s>>>(
      (const T*)x, (const T*)g, (T*)dx, a, mean, mul, bias, partials, B, C,
      HW, nb, th, ge, kind, p0, p1);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_steps(int steps, const void* x, const void* g, void* dx,
                         const float* a, const float* mean, const float* mul,
                         const float* bias, float* partials, int B, int C,
                         int HW, int nb, float th, int ge, int kind, float p0,
                         float p1, cudaStream_t s) {
#define PLIF_BWD_STEPS(N)                                                   \
  case N:                                                                   \
    return launch<T, N>(x, g, dx, a, mean, mul, bias, partials, B, C, HW,   \
                        nb, th, ge, kind, p0, p1, s);
  switch (steps) {
    PLIF_BWD_STEPS(1)
    PLIF_BWD_STEPS(2)
    PLIF_BWD_STEPS(3)
    PLIF_BWD_STEPS(4)
    PLIF_BWD_STEPS(5)
    PLIF_BWD_STEPS(6)
    PLIF_BWD_STEPS(7)
    PLIF_BWD_STEPS(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PLIF_BWD_STEPS
}

}  // namespace

// x, g, dx: (steps * B * C * HW) elements, t-major NCHW, dtype 0 = f32,
// 1 = bf16, each 16-byte aligned with HW a multiple of 16 / element size;
// a: device pointer to the f32 decay multiplier; mean, mul, bias: f32 (C,);
// partials: f32 scratch of 3 * C * nb; da_c: f32 scratch of C; outputs
// da (1,), ds, db, dm (C,) f32. steps 1..8; kind 0 atan, 1 rect,
// 2 sigmoid, 3 tanh with constants p0, p1 (atan: (pi/2)*alpha, alpha/2;
// rect: 0.5/alpha, alpha; sigmoid: alpha, alpha; tanh: alpha, 0.5*alpha).
extern "C" int plif_train_bwd(const void* x, const void* g, void* dx,
                              const void* a, const void* mean,
                              const void* mul, const void* bias,
                              void* partials, void* da_c, void* da, void* ds,
                              void* db, void* dm, int steps, int B, int C,
                              int HW, int nb, float th, int ge, int kind,
                              float p0, float p1, int dtype, void* stream) {
  if (B < 1 || C < 1 || HW < 1 || nb < 1 || kind < 0 || kind > 3)
    return (int)cudaErrorInvalidValue;
  const int vec = dtype == 0 ? 4 : 8;
  if (HW % vec || ((uintptr_t)x | (uintptr_t)g | (uintptr_t)dx) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* af = (const float*)a;
  const float* m = (const float*)mean;
  const float* k = (const float*)mul;
  const float* b = (const float*)bias;
  float* part = (float*)partials;
  cudaError_t err;
  if (dtype == 0)
    err = launch_steps<float>(steps, x, g, dx, af, m, k, b, part, B, C, HW,
                              nb, th, ge, kind, p0, p1, s);
  else if (dtype == 1)
    err = launch_steps<__nv_bfloat16>(steps, x, g, dx, af, m, k, b, part, B,
                                      C, HW, nb, th, ge, kind, p0, p1, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  plif_bwd_channel_sums<<<C, kThreads, 0, s>>>(part, k, nb, (float*)ds,
                                               (float*)db, (float*)dm,
                                               (float*)da_c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  plif_bwd_total<<<1, kThreads, 0, s>>>((const float*)da_c, C, (float*)da);
  return (int)cudaGetLastError();
}
