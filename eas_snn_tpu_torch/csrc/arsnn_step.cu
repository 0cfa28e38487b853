// One ARSNN micro-step's elementwise chain (the fused v1 sampler step):
// gated LIF update, Heaviside spike, soft or hard reset, the no-reset
// integral, the slot counter and last-spike time, and the write of the
// readout into the spiking element's next slot. The convs stay outside.
//
// Replaces: eas_snn_tpu/ops/arsnn_pallas.py:_step_kernel (pallas_call at
// :147, via _fused_step and arsnn_scan_fused). The TPU kernel walked
// (R, 128) tiles of the flattened state (_to_tiles / _pad_rows); here the
// state stays NCHW and one thread owns VEC adjacent elements.
//
// Arithmetic: in the state dtype S (f32 or bf16), every operation computed
// in f32 and rounded to S, with explicit _rn intrinsics so that nvcc
// contracts nothing into an FMA: the result equals the plain PyTorch
// version (ops/arsnn_fused.py:fused_step_plain), which rounds after every
// eager operation, bit for bit. The sigmoid is 1 / (1 + expf(-x)) rounded
// after the exp, the add and the divide, as XLA expands jax.nn.sigmoid.
//
// In place: vmem, vavg, seg, tlast and agg are updated where they lie (the
// JAX kernel's input_output_aliases); spike is written to its own plane.
// Only the slot that an element writes is read and written.
//
// Bound on the H100: bytes. Per element it reads the four gate/current
// planes, vmem, vavg (S each) and the int8 seg and tlast, and writes
// vmem, vavg, spike (S) and seg, tlast: 9 S + 4 bytes (22 B in bf16, 40 B
// in f32) plus one slot element for each spiking element, for ~25
// operations: ~1 flop/byte, far below where f32 arithmetic would bind.
// The design moves each byte once with 16-byte vector loads and stores
// (seg and tlast as VEC-byte vectors) in a grid-stride loop.
#include "common.cuh"

namespace {

__device__ __forceinline__ float rnd(float x, float) { return x; }
__device__ __forceinline__ float rnd(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float from_f32(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}

template <typename S, int VEC>
__global__ void __launch_bounds__(256) arsnn_step_kernel(
    const S* __restrict__ gin, const S* __restrict__ grec,
    const S* __restrict__ cin, const S* __restrict__ crec, long long in_sn,
    S* __restrict__ vmem, S* __restrict__ vavg, S* __restrict__ spike,
    int8_t* __restrict__ seg, int8_t* __restrict__ tlast, S* __restrict__ agg,
    long long M, int CHW, int t, int Ts, float th, float vreset, int hard,
    int readout, int attach) {
  using RawS = typename Raw<sizeof(S) * VEC>::type;
  using RawI = typename Raw<VEC>::type;
  const S tag{};
  const long long groups = M / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long e0 = g * VEC;
    const long long n = e0 / CHW;
    const long long ioff = n * in_sn + (e0 - n * CHW);
    S a_gi[VEC], a_gr[VEC], a_ci[VEC], a_cr[VEC], a_vm[VEC], a_va[VEC];
    int8_t a_sg[VEC], a_tl[VEC];
    {
      RawS r;
      r = *reinterpret_cast<const RawS*>(gin + ioff);
      memcpy(a_gi, &r, sizeof(r));
      r = *reinterpret_cast<const RawS*>(grec + ioff);
      memcpy(a_gr, &r, sizeof(r));
      r = *reinterpret_cast<const RawS*>(cin + ioff);
      memcpy(a_ci, &r, sizeof(r));
      r = *reinterpret_cast<const RawS*>(crec + ioff);
      memcpy(a_cr, &r, sizeof(r));
      r = *reinterpret_cast<const RawS*>(vmem + e0);
      memcpy(a_vm, &r, sizeof(r));
      r = *reinterpret_cast<const RawS*>(vavg + e0);
      memcpy(a_va, &r, sizeof(r));
      RawI q = *reinterpret_cast<const RawI*>(seg + e0);
      memcpy(a_sg, &q, sizeof(q));
      q = *reinterpret_cast<const RawI*>(tlast + e0);
      memcpy(a_tl, &q, sizeof(q));
    }
    S o_vm[VEC], o_va[VEC], o_sp[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float g_ = rnd(__fadd_rn(to_f32(a_gi[i]), to_f32(a_gr[i])), tag);
      const float gate = rnd(
          __fdiv_rn(1.f, rnd(__fadd_rn(1.f, rnd(expf(-g_), tag)), tag)),
          tag);
      const float cur = rnd(__fadd_rn(to_f32(a_ci[i]), to_f32(a_cr[i])), tag);
      const float v = rnd(
          __fadd_rn(rnd(__fmul_rn(gate, to_f32(a_vm[i])), tag), cur), tag);
      const bool s = rnd(__fsub_rn(v, th), tag) > 0.f;
      const float sf = s ? 1.f : 0.f;
      float v_after;
      if (hard)
        v_after = rnd(
            __fadd_rn(rnd(__fmul_rn(v, rnd(__fsub_rn(1.f, sf), tag)), tag),
                      rnd(__fmul_rn(vreset, sf), tag)),
            tag);
      else
        v_after = rnd(__fsub_rn(v, rnd(__fmul_rn(th, sf), tag)), tag);
      const float avg = rnd(__fadd_rn(to_f32(a_va[i]), v), tag);
      const int sg = a_sg[i];
      const bool valid = s && sg < Ts;
      if (valid) {
        float w = readout == 0 ? avg : readout == 1 ? v_after : 0.f;
        if (readout == 2) {
          const int dt = t - (int)a_tl[i];
          w = rnd(__fdiv_rn(avg, (float)(dt > 1 ? dt : 1)), tag);
        }
        if (attach) w = rnd(__fmul_rn(w, sf), tag);
        S* slot = agg + (long long)sg * M + e0 + i;
        *slot = from_f32(__fadd_rn(to_f32(*slot), w), tag);
      }
      o_vm[i] = from_f32(v_after, tag);
      o_va[i] = from_f32(s ? 0.f : avg, tag);
      o_sp[i] = from_f32(sf, tag);
      a_sg[i] = (int8_t)(sg + (valid ? 1 : 0));
      a_tl[i] = valid ? (int8_t)t : a_tl[i];
    }
    RawS r;
    memcpy(&r, o_vm, sizeof(r));
    *reinterpret_cast<RawS*>(vmem + e0) = r;
    memcpy(&r, o_va, sizeof(r));
    *reinterpret_cast<RawS*>(vavg + e0) = r;
    memcpy(&r, o_sp, sizeof(r));
    *reinterpret_cast<RawS*>(spike + e0) = r;
    RawI q;
    memcpy(&q, a_sg, sizeof(q));
    *reinterpret_cast<RawI*>(seg + e0) = q;
    memcpy(&q, a_tl, sizeof(q));
    *reinterpret_cast<RawI*>(tlast + e0) = q;
  }
}

template <typename S>
cudaError_t launch(const void* gin, const void* grec, const void* cin,
                   const void* crec, long long in_sn, void* vmem, void* vavg,
                   void* spike, void* seg, void* tlast, void* agg,
                   long long M, int CHW, int t, int Ts, float th,
                   float vreset, int hard, int readout, int attach,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(S);
  const void* ptrs[] = {gin, grec, cin, crec, vmem, vavg, spike, agg};
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return cudaErrorInvalidValue;
  if (CHW % VEC || in_sn % VEC || (uintptr_t)seg % VEC ||
      (uintptr_t)tlast % VEC)
    return cudaErrorInvalidValue;
  long long blocks = (M / VEC + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  arsnn_step_kernel<S, VEC><<<(unsigned)blocks, 256, 0, stream>>>(
      (const S*)gin, (const S*)grec, (const S*)cin, (const S*)crec, in_sn,
      (S*)vmem, (S*)vavg, (S*)spike, (int8_t*)seg, (int8_t*)tlast, (S*)agg,
      M, CHW, t, Ts, th, vreset, hard, readout, attach);
  return cudaGetLastError();
}

}  // namespace

// gin, grec, cin, crec: (N, C, H, W) planes in S with NCHW strides and one
// batch stride in_sn (elements); vmem, vavg, spike: contiguous (N, C, H, W)
// S; seg, tlast: int8, same shape; agg: (Ts, N, C, H, W) S. M = N*C*H*W,
// CHW = C*H*W. readout 0 sum, 1 last, 2 avg; hard 1 for a hard reset to
// vreset; dtype 0 f32, 1 bf16.
extern "C" int arsnn_step(const void* gin, const void* grec, const void* cin,
                          const void* crec, long long in_sn, void* vmem,
                          void* vavg, void* spike, void* seg, void* tlast,
                          void* agg, long long M, int CHW, int t, int Ts,
                          float th, float vreset, int hard, int readout,
                          int attach, int dtype, void* stream) {
  if (M <= 0) return 0;
  if (CHW < 1 || M % CHW || readout < 0 || readout > 2 || t < 0 || t > 126)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(gin, grec, cin, crec, in_sn, vmem, vavg, spike,
                              seg, tlast, agg, M, CHW, t, Ts, th, vreset,
                              hard, readout, attach, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(gin, grec, cin, crec, in_sn, vmem,
                                      vavg, spike, seg, tlast, agg, M, CHW,
                                      t, Ts, th, vreset, hard, readout,
                                      attach, s);
  return (int)cudaErrorInvalidValue;
}
