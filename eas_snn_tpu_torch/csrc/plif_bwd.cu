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
// One launch a call. Layout and grid (ops/plif.py:plif_bwd_plan): x, g
// and dx are (T*B, C, H, W), t-major. An item is E adjacent elements of
// one (b, c) plane: one 16-byte vector, or one element where H*W does not
// split into vectors (the scalar tail). Each channel's B*H*W/E items are
// cut into nb equal ranges, one a block (blockIdx = c * nb + j), which its
// threads walk in steps of the block size; all index arithmetic within a
// step is 32-bit. A thread loads the T raw vectors of x and of g (2 * T *
// 16 bytes) at once, then takes the E elements one at a time: the
// element's forward keeps only v_pre - th and v_after_{t-1} for its T
// steps (2T floats; xm is recomputed from the raw x), and its backward
// writes dx into T raw vectors stored at the end. So registers hold raw
// data, not 3 * T * E floats, and __launch_bounds__ asks for 3 blocks an
// SM at T <= 4.
//
// The sums are taken in a fixed order: each thread over its items, then
// warp shuffles and the block's warps in a fixed tree, into the block's
// partials (no float atomics). The block then bumps a ticket (an integer
// atomic, after a __threadfence); the last block to arrive sums every
// channel's nb partials in block order (one thread a channel, so that all
// channels' loads go out together; a warp a channel would walk 96
// channels in turn at 768), writes ds, db, dm, takes da as the block
// sum of the threads' shares, and resets the ticket. The order depends on
// the plan only, never on which block arrived last, so the result is
// identical from run to run. Ticket and partials live in a scratch buffer
// the wrapper keeps per device and stream.
//
// Bound on the H100: bytes. Per element it reads x and g and writes dx:
// 6 bytes in bf16 (12 in f32) for ~30 flops, ~5 flop/byte, below the ~20
// where f32 CUDA-core arithmetic would bind. Each byte moves once and the
// partials are a few KB.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Blocks an SM that __launch_bounds__ asks for (ops/plif.py mirrors it
// as _BWD_BLOCKS_PER_SM to plan the grid): 2 * T raw vectors and T dx
// vectors a thread.
constexpr int bwd_min_blocks(int steps) {
  return steps <= 4 ? 3 : steps <= 6 ? 2 : 1;
}

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

// Sum of `v` over a warp in a fixed tree; the result is valid in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// Sum of `v` over the block's threads in a fixed order; the result is
// valid in thread 0. `red` holds one float per warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.f;
    v = warp_sum(v);
  }
  __syncthreads();
  return v;
}

struct Surrogate {
  float th, p0, p1;
  int ge, kind;
};

// One item: E elements at `off` of every step; dx stored, the item's
// terms added to ds, db, da.
template <typename T, int E, int STEPS>
__device__ __forceinline__ void bwd_item(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
    long long n, unsigned off, float a, float mn, float ml, float bs,
    const Surrogate& sg, float& ds, float& db, float& da) {
  Vals<T, E> xr[STEPS], gr[STEPS], dr[STEPS] = {};
#pragma unroll
  for (int t = 0; t < STEPS; ++t) xr[t].load(x + t * n + off);
#pragma unroll
  for (int t = 0; t < STEPS; ++t) gr[t].load(g + t * n + off);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    float d[STEPS], vprev[STEPS];
    float v = 0.f;
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      T xv[E];
      xr[t].get(xv);
      vprev[t] = v;
      const float xa = bn_apply(to_f32(xv[i]), mn, ml, bs, T());
      v = __fadd_rn(__fmul_rn(v, a), xa);
      d[t] = __fsub_rn(v, sg.th);
      const bool s = sg.ge ? (d[t] >= 0.f) : (d[t] > 0.f);
      v = __fsub_rn(v, __fmul_rn(sg.th, s ? 1.f : 0.f));
    }
    float gaf = 0.f;
#pragma unroll
    for (int t = STEPS - 1; t >= 0; --t) {
      T xv[E], gv[E], dv[E];
      xr[t].get(xv);
      gr[t].get(gv);
      dr[t].get(dv);
      const float fp = surrogate_deriv(sg.kind, sg.p0, sg.p1, d[t]);
      const float gpre = __fadd_rn(
          gaf, __fmul_rn(__fsub_rn(to_f32(gv[i]), __fmul_rn(sg.th, gaf)), fp));
      dv[i] = from_f32(__fmul_rn(gpre, ml), T());
      dr[t].set(dv);
      ds = __fadd_rn(ds, __fmul_rn(gpre, __fsub_rn(to_f32(xv[i]), mn)));
      db = __fadd_rn(db, gpre);
      da = __fadd_rn(da, __fmul_rn(gpre, vprev[t]));
      gaf = __fmul_rn(gpre, a);
    }
  }
#pragma unroll
  for (int t = 0; t < STEPS; ++t) dr[t].store(dx + t * n + off);
}

// partials: 3 * gridDim.x floats (ds, db, da of each block); ticket: a
// zeroed counter, zero again on return; sums: da (1), dm, ds, db (C
// each).
template <typename T, int E, int STEPS>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks(STEPS))
    plif_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    T* __restrict__ dx, const float* __restrict__ a_ptr,
                    const float* __restrict__ mean,
                    const float* __restrict__ mul,
                    const float* __restrict__ bias, float* partials,
                    unsigned* ticket, float* __restrict__ sums, long long n,
                    unsigned C, unsigned HW, unsigned ipp, unsigned per_c,
                    unsigned nb, unsigned chunk, Surrogate sg) {
  __shared__ float red[3][kThreads / 32];
  __shared__ bool last;
  const unsigned c = blockIdx.x / nb, j = blockIdx.x - c * nb;
  const unsigned lo = j * chunk;
  const unsigned hi = lo + chunk < per_c ? lo + chunk : per_c;
  const float a = *a_ptr, mn = mean[c], ml = mul[c], bs = bias[c];
  float ds = 0.f, db = 0.f, da = 0.f;
  for (unsigned q = lo + threadIdx.x; q < hi; q += kThreads) {
    const unsigned b = q / ipp;
    const unsigned off = (b * C + c) * HW + (q - b * ipp) * E;
    bwd_item<T, E, STEPS>(x, g, dx, n, off, a, mn, ml, bs, sg, ds, db, da);
  }
  ds = block_sum(ds, red[0]);
  db = block_sum(db, red[1]);
  da = block_sum(da, red[2]);
  // partials of block (c, j) at j * C + c: the last block reads a
  // channel's in order, neighbouring channels in neighbouring threads
  const unsigned nblocks = gridDim.x, slot = j * C + c;
  if (threadIdx.x == 0) {
    partials[slot] = ds;
    partials[nblocks + slot] = db;
    partials[2 * nblocks + slot] = da;
    __threadfence();
    last = atomicAdd(ticket, 1u) == nblocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: one thread a channel sums its nb partials in block
  // order; da is the block sum of the threads' channel shares
  float da_t = 0.f;
  for (unsigned cc = threadIdx.x; cc < C; cc += kThreads) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (unsigned k = 0; k < nb; ++k) {
      const unsigned i = k * C + cc;
      s0 = __fadd_rn(s0, __ldcg(partials + i));
      s1 = __fadd_rn(s1, __ldcg(partials + nblocks + i));
      s2 = __fadd_rn(s2, __ldcg(partials + 2 * nblocks + i));
    }
    sums[1 + cc] = -__fmul_rn(mul[cc], s1);
    sums[1 + C + cc] = s0;
    sums[1 + 2 * C + cc] = s1;
    da_t = __fadd_rn(da_t, s2);
  }
  da_t = block_sum(da_t, red[0]);
  if (threadIdx.x == 0) {
    sums[0] = da_t;
    *ticket = 0u;
  }
}

struct Args {
  const void *x, *g;
  void* dx;
  const float *a, *mean, *mul, *bias;
  float* partials;
  unsigned* ticket;
  float* sums;
  long long n;
  unsigned C, HW, ipp, per_c, nb, chunk, grid;
  Surrogate sg;
};

template <typename T, int E, int STEPS>
cudaError_t launch(const Args& r, cudaStream_t s) {
  plif_bwd_kernel<T, E, STEPS><<<r.grid, kThreads, 0, s>>>(
      (const T*)r.x, (const T*)r.g, (T*)r.dx, r.a, r.mean, r.mul, r.bias,
      r.partials, r.ticket, r.sums, r.n, r.C, r.HW, r.ipp, r.per_c, r.nb,
      r.chunk, r.sg);
  return cudaGetLastError();
}

template <typename T, int E>
cudaError_t launch_steps(int steps, const Args& r, cudaStream_t s) {
#define PLIF_BWD_STEPS(N) \
  case N:                 \
    return launch<T, E, N>(r, s);
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

template <typename T>
cudaError_t launch_items(int steps, int E, const Args& r, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (E == VEC) return launch_steps<T, VEC>(steps, r, s);
  return launch_steps<T, 1>(steps, r, s);
}

}  // namespace

// x, g, dx: (steps * B * C * HW) elements, t-major NCHW, dtype 0 = f32,
// 1 = bf16; a: device pointer to the f32 decay multiplier; mean, mul,
// bias: f32 (C,); steps 1..8; the plan (ops/plif.py:plif_bwd_plan): item
// width E (16 / element size, needing 16-byte aligned x, g, dx and HW a
// multiple of E; or 1), nb blocks a channel of `chunk` items each;
// scratch: 4 + 3 * C * nb f32, the first word a zeroed ticket (zero again
// after the kernel); sums: f32 da (1), dm, ds, db (C each). kind 0 atan,
// 1 rect, 2 sigmoid, 3 tanh with constants p0, p1 (atan: (pi/2)*alpha,
// alpha/2; rect: 0.5/alpha, alpha; sigmoid: alpha, alpha; tanh: alpha,
// 0.5*alpha). B * C * HW < 2^31.
extern "C" int plif_train_bwd(const void* x, const void* g, void* dx,
                              const void* a, const void* mean,
                              const void* mul, const void* bias,
                              void* scratch, void* sums, int steps, int B,
                              int C, int HW, int E, int nb, int chunk,
                              float th, int ge, int kind, float p0, float p1,
                              int dtype, void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  const long long n = (long long)B * C * HW;
  if (B < 1 || C < 1 || HW < 1 || nb < 1 || chunk < 1 || kind < 0 ||
      kind > 3 || (dtype != 0 && dtype != 1) || n > 0x7fffffffLL ||
      (E != 1 && E != vec) || HW % E ||
      (E > 1 && ((uintptr_t)x | (uintptr_t)g | (uintptr_t)dx) % 16))
    return (int)cudaErrorInvalidValue;
  const long long per_c = (long long)B * (HW / E);
  if ((long long)nb * chunk < per_c || (long long)C * nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args r;
  r.x = x;
  r.g = g;
  r.dx = dx;
  r.a = (const float*)a;
  r.mean = (const float*)mean;
  r.mul = (const float*)mul;
  r.bias = (const float*)bias;
  r.ticket = (unsigned*)scratch;
  r.partials = (float*)scratch + 4;
  r.sums = (float*)sums;
  r.n = n;
  r.C = C;
  r.HW = HW;
  r.ipp = HW / E;
  r.per_c = (unsigned)per_c;
  r.nb = nb;
  r.chunk = chunk;
  r.grid = (unsigned)(C * nb);
  r.sg = Surrogate{th, p0, p1, ge, kind};
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      dtype == 0 ? launch_items<float>(steps, E, r, s)
                 : launch_items<__nv_bfloat16>(steps, E, r, s);
  return (int)err;
}
