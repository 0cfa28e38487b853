"""The port's ops (eas_snn_tpu_torch.ops) against the JAX package's.

Inputs are made with numpy from a seed and handed to both sides; the port
runs its plain PyTorch versions (its tensors lie on the CPU). Two kinds of
data:

* quarter-valued weights on 0/1 spikes (or on eighth-valued bf16 inputs):
  every product and every partial sum is exact in f32, so the port and JAX
  must agree bitwise whatever order each sums in;
* real-valued weights: the f32 preactivations agree to 1e-5, and a spike
  may differ only where the membrane lies within 1e-4 of the threshold,
  where the two frameworks' summation orders can land on either side.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eas_snn_tpu.ops import conv_plif_pallas as jcp
from eas_snn_tpu.ops.lif import plif_scan as j_plif_scan
from eas_snn_tpu.ops.plif_pallas import plif_fused as j_plif_fused
from eas_snn_tpu.ops.surrogate import get_spike_fn as j_spike_fn

from eas_snn_tpu_torch.models import blocks as pblocks
from eas_snn_tpu_torch.ops import conv_plif as pcp
from eas_snn_tpu_torch.ops import plif as pplif
from eas_snn_tpu_torch.ops.conv_plif_policy import should_fuse
from eas_snn_tpu_torch.ops.lif import plif_scan
from eas_snn_tpu_torch.ops.plif import (plif_forward, plif_forward_plain,
                                        plif_train_backward,
                                        plif_train_forward)
from eas_snn_tpu_torch.ops.surrogate import get_spike_fn, spike_ge
from torch_meta import MetaAsCuda

T = 3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def nchw(x):
    """(N, H, W, C) numpy/JAX -> (N, C, H, W) torch."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x):
    return np.asarray(x).transpose(0, 2, 3, 1)


def quarters(rng, shape, lo=-6, hi=7):
    return (rng.integers(lo, hi, shape) * 0.25).astype(np.float32)


def margins(preact_tb, w_plif, thresh=1.0):
    """Smallest |v_t - thresh| over t per element of a (T*B, ...) f32
    preactivation, by the PLIF recurrence in numpy."""
    a = np.float32(1.0) - np.float32(1.0 / (1.0 + np.exp(-np.float32(w_plif))))
    xs = preact_tb.reshape((T, -1) + preact_tb.shape[1:])
    v = np.zeros_like(xs[0])
    m = np.full_like(xs[0], np.inf)
    for t in range(T):
        v = v * a + xs[t]
        d = v - thresh
        m = np.minimum(m, np.abs(d))
        v = v - thresh * (d >= 0)
    return np.concatenate([m] * T)


def assert_spikes_match(got, want, margin, tol=1e-4):
    """Equal spikes, except where the membrane is within ``tol`` of the
    threshold (summation order may put it on either side there)."""
    bad = np.asarray(got) != np.asarray(want)
    assert not (bad & (margin >= tol)).any(), (
        f"{int((bad & (margin >= tol)).sum())} spikes differ away from "
        "the threshold")
    assert 0.02 < np.asarray(want, np.float32).mean() < 0.98


# ------------------------------------------------------------- spikes, PLIF

@pytest.mark.parametrize("kind", ["rect", "atan", "sigmoid", "tanh", "patan"])
def test_heaviside_matches_jax_forward(kind):
    x = np.array([-1.0, -1e-7, 0.0, 1e-7, 2.0], np.float32)
    want = np.asarray(j_spike_fn(kind)(jnp.asarray(x)))
    got = get_spike_fn(kind)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert spike_ge(kind) == bool(got[2])


@pytest.mark.parametrize("kind", ["atan", "rect"])
def test_plif_plain_bit_equal_to_jax_scan_f32(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(0.6, 1.0, (T * 4, 8, 5, 6)).astype(np.float32)
    w = np.float32(-0.4)
    fn = j_spike_fn(kind)
    want, _ = j_plif_scan(jnp.asarray(x.reshape(T, 4, 8, 5, 6)),
                          jnp.asarray(w), fn)
    got = plif_forward(torch.from_numpy(x), T, torch.tensor(w), kind=kind)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(x.shape))
    assert 0.05 < got.float().mean() < 0.95
    # the port's scan with the hard spike is the same function
    sp, _ = plif_scan(torch.from_numpy(x).reshape(T, 4, 8, 5, 6),
                      torch.tensor(w), get_spike_fn(kind))
    np.testing.assert_array_equal(sp.reshape(x.shape).numpy(), got.numpy())


def test_plif_bf16_storage_matches_interpret_kernel():
    """bf16 storage, f32 membrane: the JAX kernel in interpret mode at
    B=128 (its lane gate) with a tiny H*W*C."""
    rng = np.random.default_rng(1)
    B = 128
    x32 = rng.normal(0.5, 1.0, (T * B, 4, 4, 16)).astype(np.float32)
    xb = jnp.asarray(x32).astype(jnp.bfloat16)
    w = jnp.float32(0.3)
    want = j_plif_fused(xb, T, w, spike_fn="atan", interpret=True,
                        out_int8=True)
    xt = nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = plif_forward(xt, T, torch.tensor(0.3), kind="atan")
    np.testing.assert_array_equal(nhwc(got.numpy()), np.asarray(want))


def test_plif_with_bn_matches_jax_bn_then_kernel():
    """The eval BN folded into the PLIF op: the JAX package's BN arithmetic
    rounded to bf16, then its kernel in interpret mode."""
    rng = np.random.default_rng(8)
    B, C = 128, 16
    x32 = rng.normal(0.0, 2.0, (T * B, 4, 4, C)).astype(np.float32)
    xb = jnp.asarray(x32).astype(jnp.bfloat16)
    mean = rng.normal(0, 0.3, C).astype(np.float32)
    mul = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0.4, 0.2, C).astype(np.float32)
    y = ((xb.astype(jnp.float32) - mean) * mul + bias).astype(jnp.bfloat16)
    want = j_plif_fused(y, T, jnp.float32(-0.2), spike_fn="atan",
                        interpret=True, out_int8=True)
    xt = nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = plif_forward(xt, T, torch.tensor(-0.2), kind="atan",
                       bn=tuple(torch.from_numpy(p) for p in (mean, mul, bias)))
    np.testing.assert_array_equal(nhwc(got.numpy()), np.asarray(want))
    assert 0.05 < float(np.asarray(want, np.float32).mean()) < 0.95


def test_plif_rejects_other_devices_and_dtypes():
    """A wrapper runs the plain version only on CPU tensors: any other
    device must launch the kernel or raise, never fall back (meta tensors
    stand in for CUDA ones, ``tests/torch_meta.py``)."""
    w = torch.tensor(0.0)
    with pytest.raises(ValueError), MetaAsCuda():
        plif_forward(torch.empty(6, 2, 2, 2, device="meta"), T, w)
    with pytest.raises(ValueError):
        plif_forward(torch.zeros(6, 2, 2, 2), T, w, out_dtype=torch.float32)
    with pytest.raises(ValueError):
        plif_forward(torch.zeros(5, 2, 2, 2), T, w)
    with pytest.raises(ValueError), MetaAsCuda():
        pcp.conv1x1_plif(torch.empty(6, 4, 2, 2, device="meta"),
                         torch.zeros(3, 4), torch.zeros(3), T, w)


@pytest.mark.parametrize("case", [
    "plif_hw", "plif_3d", "c1_channels", "c1_row", "c3_channels", "c3_row",
    "c3s1_row", "c1_weights", "c3_weights", "c3s2_channels", "c3s2_row_bf16",
    "c3s2_weights", "train_fwd_hw", "train_bwd_hw", "train_bwd_steps"])
def test_wrappers_refuse_layouts_the_kernels_cannot_copy(monkeypatch, case):
    """On a non-CPU tensor a wrapper raises for a layout that does not
    split into the kernel's whole aligned copies (meta tensors stand in
    for CUDA ones, ``tests/torch_meta.py``; the library is never
    reached)."""
    from eas_snn_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "get_lib", lambda name: pytest.fail(name))
    w = torch.tensor(0.0)

    def meta(*shape, dtype=torch.int8):
        return torch.empty(shape, dtype=dtype, device="meta")

    def z(*shape):
        return torch.zeros(shape, device="meta")

    calls = {
        # any H*W, but a step's offsets are 32-bit: 2^31 elements are too
        # many (a ragged H*W takes the scalar tail: see the plan tests)
        "plif_hw": lambda: plif_forward(
            meta(T, 1, 2**16, 2**15, dtype=torch.bfloat16), T, w),
        "plif_3d": lambda: plif_forward(meta(6, 8, 16, dtype=torch.float32),
                                        T, w),
        "c1_channels": lambda: pcp.conv1x1_plif(
            (meta(6, 8, 4, 4), meta(6, 4, 4, 4)), z(8, 12), z(8), T, w),
        # int8 H*W must be a multiple of 16 (whole 16-byte copies)
        "c1_row": lambda: pcp.conv1x1_plif(meta(6, 8, 3, 4), z(8, 8), z(8),
                                           T, w),
        "c3_channels": lambda: pcp.conv3x3_plif(meta(6, 12, 4, 4),
                                                z(3, 8, 36), z(8), T, w),
        # int8 W must be a multiple of 4 (whole 4-byte row copies)
        "c3_row": lambda: pcp.conv3x3s2_plif(meta(6, 8, 4, 6), z(3, 8, 24),
                                             z(8), T, w),
        "c3s1_row": lambda: pcp.conv3x3_plif(meta(6, 8, 4, 6), z(3, 8, 24),
                                             z(8), T, w),
        # a chunk of the weights must stay resident in shared memory
        "c1_weights": lambda: pcp.conv1x1_plif(meta(6, 4096, 4, 4),
                                               z(8, 4096), z(8), T, w),
        "c3_weights": lambda: pcp.conv3x3_plif(meta(6, 512, 4, 4),
                                               z(3, 8, 1536), z(8), T, w),
        # stride 2: channels in 8s, bf16 W even (whole 4-byte copies), and
        # 9 taps x 384 channels x 32 outputs do not stay resident (dark5)
        "c3s2_channels": lambda: pcp.conv3x3s2_plif(
            meta(6, 12, 8, 8), z(3, 8, 36), z(8), T, w),
        "c3s2_row_bf16": lambda: pcp.conv3x3s2_plif(
            meta(6, 8, 8, 7, dtype=torch.bfloat16), z(3, 8, 24), z(8), T, w),
        "c3s2_weights": lambda: pcp.conv3x3s2_plif(
            meta(6, 384, 16, 20), z(3, 768, 1152), z(768), T, w),
        # the train kernels: a step's offsets in 32 bits, T at most 8
        "train_fwd_hw": lambda: plif_train_forward(
            meta(T, 1, 2**16, 2**15, dtype=torch.bfloat16), z(1), z(1), z(1),
            z(1), T),
        "train_bwd_hw": lambda: plif_train_backward(
            meta(T, 1, 2**16, 2**15, dtype=torch.float32),
            meta(T, 1, 2**16, 2**15, dtype=torch.float32), z(1), z(1), z(1),
            z(1), T),
        "train_bwd_steps": lambda: plif_train_backward(
            meta(9, 8, 4, 2, dtype=torch.bfloat16),
            meta(9, 8, 4, 2, dtype=torch.bfloat16), z(1), z(8), z(8), z(8),
            9),
    }
    with pytest.raises(ValueError, match="kernel"), MetaAsCuda():
        calls[case]()


# ------------------------------------------- PLIF forward plan and cache

# the flagship's unfused eval sites (gen1_syolox_m, B=128, T=3): (C, H, W)
EVAL_SITES = [(48, 64, 80), (192, 32, 40), (96, 32, 40), (384, 16, 20),
              (192, 16, 20), (768, 8, 10), (384, 8, 10)]


def _fwd_items(plan, B, C, HW):
    """Each item's first element within a step and its channel, by the
    index arithmetic of csrc/plif.cu:plif_fwd_kernel over the whole grid."""
    q = np.arange(plan.grid * pplif.THREADS, dtype=np.int64)
    q = q[q < plan.items]
    p = q // plan.ipp
    k = q - p * plan.ipp
    assert (k * plan.E + plan.E <= HW).all()  # an item lies in one plane
    return p * HW + k * plan.E, p % C


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("site", EVAL_SITES + [
    "ragged_7x9", "one_vector_4x6", "unaligned_8x8", "tiny_1x1"])
def test_plif_fwd_plan_covers_every_element_once(site, dtype):
    """The forward kernel's items cover each element of a step exactly once
    and stay in bounds (and so in every step: a step adds n to both), at
    every flagship eval geometry, and off it: a ragged H*W and an x off
    16-byte alignment take one-element items (the scalar tail), any other
    H*W one 16-byte vector a thread."""
    dt = getattr(torch, dtype)
    B, aligned = 128, True
    if isinstance(site, str):
        B, aligned = 3, site != "unaligned_8x8"
        H, W = {"ragged_7x9": (7, 9), "one_vector_4x6": (4, 6),
                "unaligned_8x8": (8, 8), "tiny_1x1": (1, 1)}[site]
        C = 16
    else:
        C, H, W = site
    HW = H * W
    plan = pplif.plif_fwd_plan(B, C, HW, dt, aligned)
    vec = 16 // torch.empty((), dtype=dt).element_size()
    want_E = {"ragged_7x9": 1, "unaligned_8x8": 1, "tiny_1x1": 1,
              "one_vector_4x6": vec}
    assert plan.E == (want_E[site] if isinstance(site, str) else vec)
    n = B * C * HW
    off, ch = _fwd_items(plan, B, C, HW)
    assert off.min() >= 0 and off.max() + plan.E <= n
    np.testing.assert_array_equal(np.sort(off), np.arange(0, n, plan.E))
    np.testing.assert_array_equal(ch, (off // HW) % C)
    assert plan.grid == -(-plan.items // pplif.THREADS)
    if not isinstance(site, str):
        # every flagship site fills the H100: at least the 4 blocks an SM
        # that csrc/plif.cu's launch bounds ask, on each of its 132 SMs
        assert plan.grid >= 132 * 4


def _site(T_=T, cin=8, cout=16, seed=0):
    """An unfused spiking 1x1 site at eval with random BN statistics."""
    g = torch.Generator().manual_seed(seed)
    site = pblocks.BaseConv(cin, cout, 1, 1, neuron=pblocks.Neuron(
        spiking=True, T=T_, fuse="never"))
    with torch.no_grad():
        site.weight.copy_(torch.randn(site.weight.shape, generator=g) * 0.5)
        bn = site.bn
        bn.running_mean.copy_(torch.randn(cout, generator=g) * 0.2)
        bn.running_var.copy_(torch.rand(cout, generator=g) + 0.5)
        bn.weight.copy_(torch.rand(cout, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(cout, generator=g) * 0.2 + 0.5)
    x = (torch.rand((T_ * 2, cin, 5, 6), generator=g) < 0.5).float()
    return site.eval(), x


def _uncached(site, x):
    """The site's spikes with its eval constants computed afresh, as the
    site computed them on every call before they were kept."""
    bn = site.bn
    y = torch.nn.functional.conv2d(x, site.weight)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return plif_forward_plain(y, T, site.act.w, site.neuron.thresh,
                              site.act.kind,
                              bn=(bn.running_mean, mul, bn.bias))


def _change(case, site, x):
    with torch.no_grad():
        if case == "running_var":
            site.bn.running_var.mul_(9.0)
        elif case == "bn_weight":
            site.bn.weight.mul_(3.0)
        elif case == "w":
            site.act.w.add_(2.0)
        elif case == "load_state_dict":
            other, _ = _site(seed=1)
            site.load_state_dict(other.state_dict())
        else:
            site.train()
            site(x)  # a train forward moves the running statistics
            site.eval()


@pytest.mark.parametrize("case", ["running_var", "bn_weight", "w",
                                  "load_state_dict", "train_eval"])
def test_eval_constants_are_kept_and_refreshed(case):
    """An unfused spiking site keeps its BN's (mean, mul, bias) and its
    neuron's decay between eval calls: the kept values give the spikes of
    the uncached path bit for bit, a second call reuses them, and an
    in-place change of a source (running_var, the BN weight, w),
    load_state_dict or a train() / eval() round computes them again."""
    site, x = _site()
    with torch.no_grad():
        y0 = site(x)
        np.testing.assert_array_equal(y0.numpy(), _uncached(site, x).numpy())
        terms, a = site.bn.eval_terms(), site.act.decay()
        site(x)
        assert site.bn.eval_terms() is terms and site.act.decay() is a
        _change(case, site, x)
        if case == "train_eval":
            assert site.bn._kept_value is None
            assert site.act._kept_value is None
        y1 = site(x)
        kept = (site.bn.eval_terms(), site.act.decay())
    np.testing.assert_array_equal(y1.numpy(), _uncached(site, x).numpy())
    assert (y1 != y0).any()
    assert 0.05 < float(y1.float().mean()) < 0.95
    if case == "w":
        assert kept[0] is terms and kept[1] is not a
    else:
        assert kept[0] is not terms


def test_eval_terms_stay_differentiable_where_a_gradient_is_wanted():
    """With autograd on and a BN weight that wants its gradient, the eval
    terms are computed afresh (kept ones carry no graph)."""
    bn = pblocks.BatchNorm(4).eval()
    x = torch.randn(2, 4, 3, 3)
    bn(x, torch.float32).sum().backward()
    assert bn.weight.grad is not None and bn._kept_value is None
    with torch.no_grad():
        terms = bn.eval_terms()
    assert bn._kept_value[1] is terms


@pytest.mark.parametrize("case", ["fwd", "fwd_ragged", "train_fwd",
                                  "bwd", "bwd_ragged"])
def test_plif_wrappers_launch_with_their_plans(monkeypatch, case):
    """On a non-CPU tensor (meta tensors stand in for CUDA ones,
    ``tests/torch_meta.py``) the PLIF wrappers hand the kernels their plans' item width and grid, any H*W
    included, and the backward its plan, the kept scratch buffer and one
    f32 buffer whose views are da, dm, ds and db."""
    from eas_snn_tpu_torch.ops import _build
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "get_lib", lambda name: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 7)
    B, C = 4, 16
    H, W = (7, 9) if case.endswith("ragged") else (8, 10)
    x = torch.empty((T * B, C, H, W), dtype=torch.bfloat16, device="meta")
    z = torch.zeros(C, device="meta")
    a = torch.zeros(1, device="meta")
    if case.startswith("fwd"):
        with MetaAsCuda():
            out = plif_forward(x, T, torch.tensor(0.0, device="meta"))
    elif case == "train_fwd":
        out = plif_train_forward(x, a, z, z, z, T)
    else:
        out = plif_train_backward(x, x, a, z, z, z, T)
    (name, args), = calls
    if not case.startswith("bwd"):
        plan = pplif.plif_fwd_plan(B, C, H * W, x.dtype)
        assert name == ("plif_fwd" if case.startswith("fwd")
                        else "plif_train_fwd")
        assert args[3] == B * C * H * W and args[-3:] == (plan.E, plan.grid,
                                                          7)
        assert out.shape == x.shape
        return
    plan = pplif.plif_bwd_plan(B, C, H * W, x.dtype, T)
    assert plan.E == (1 if case == "bwd_ragged" else 8)
    assert name == "plif_train_bwd"
    assert args[9:16] == (T, B, C, H * W, plan.E, plan.nb, plan.chunk)
    scratch = pplif._BWD_SCRATCH[("meta", 7)]
    assert scratch.numel() >= plan.scratch
    dx, da, dm, ds, db = out
    assert dx.shape == x.shape and da.shape == (1,)
    assert all(v.shape == (C,) for v in (dm, ds, db))
    assert da._base is dm._base is ds._base is db._base is not None


# ------------------------------------------------------ conv + BN + PLIF

def _jax_preact(x_nhwc_list, w_oihw_bf16_f32, bias, stride, ksize):
    """The JAX references' preactivation: bf16 operands, f32 sums."""
    xs = [jnp.asarray(x).astype(jnp.bfloat16) for x in x_nhwc_list]
    k = jnp.asarray(w_oihw_bf16_f32.transpose(2, 3, 1, 0)).astype(jnp.bfloat16)
    x = jnp.concatenate(xs, -1) if len(xs) > 1 else xs[0]
    pad = (ksize - 1) // 2
    acc = jax.lax.conv_general_dilated(
        x, k, (stride, stride), [(pad, pad)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    return np.asarray(acc + bias)


def _inputs(rng, shape, in_dt):
    """0/1 spikes (int8 or bf16) or, for f32, eighth-valued analog values
    that bf16 holds exactly."""
    if in_dt == "f32":
        return (rng.integers(-16, 17, shape) * 0.125).astype(np.float32)
    return rng.integers(0, 2, shape).astype(np.int8)


def _torch_in(x, in_dt):
    t = nchw(x)
    return {"int8": t, "bf16": t.to(torch.bfloat16), "f32": t}[in_dt]


def _jax_in(x, in_dt):
    return jnp.asarray(x, {"int8": jnp.int8, "bf16": jnp.bfloat16,
                           "f32": jnp.float32}[in_dt])


@pytest.mark.parametrize("in_dt", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("cins", [(16,), (8, 24)])
def test_conv1x1_plif_bitwise_vs_reference(in_dt, cins):
    rng = np.random.default_rng(2)
    B, H, W, Cout = 2, 5, 6, 24
    xs = [_inputs(rng, (T * B, H, W, c), in_dt) for c in cins]
    w_oc = quarters(rng, (Cout, sum(cins)))
    bias = quarters(rng, (Cout,))
    wp = np.float32(-1.1)
    want = jcp.conv1x1_plif_reference(
        tuple(_jax_in(x, in_dt) for x in xs), jnp.asarray(w_oc),
        jnp.asarray(bias), T, jnp.asarray(wp))
    got = pcp.conv1x1_plif(tuple(_torch_in(x, in_dt) for x in xs),
                           torch.from_numpy(w_oc), torch.from_numpy(bias), T,
                           torch.tensor(wp))
    assert got.dtype == torch.int8 and got.shape == (T * B, Cout, H, W)
    np.testing.assert_array_equal(nhwc(got.numpy()), np.asarray(want))
    assert 0.05 < got.float().mean() < 0.95


@pytest.mark.parametrize("in_dt", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_plif_bitwise_vs_reference(in_dt, stride):
    rng = np.random.default_rng(3)
    B, H, W, Cin, Cout = 2, 8, 6, 8, 16
    x = _inputs(rng, (T * B, H, W, Cin), in_dt)
    w3 = quarters(rng, (3, Cout, 3 * Cin), -2, 3)
    bias = quarters(rng, (Cout,))
    wp = np.float32(0.2)
    ref = (jcp.conv3x3_plif_reference if stride == 1
           else jcp.conv3x3s2_plif_reference)
    op = pcp.conv3x3_plif if stride == 1 else pcp.conv3x3s2_plif
    want = ref(_jax_in(x, in_dt), jnp.asarray(w3), jnp.asarray(bias), T,
               jnp.asarray(wp))
    got = op(_torch_in(x, in_dt), torch.from_numpy(w3),
             torch.from_numpy(bias), T, torch.tensor(wp))
    assert got.shape == (T * B, Cout, H // stride, W // stride)
    np.testing.assert_array_equal(nhwc(got.numpy()), np.asarray(want))
    assert 0.05 < got.float().mean() < 0.95


@pytest.mark.parametrize("site", [
    # (ksize, stride, cins, in_dt)
    (1, 1, (16, 24), "int8"),
    (3, 1, (16,), "int8"),
    (3, 2, (12,), "f32"),   # the stem's analog output at the downsample
])
def test_conv_plif_real_valued_vs_reference(site):
    """Real-valued BN-folded weights: f32 preactivation within 1e-5 of the
    JAX references' conv; spikes equal except within 1e-4 of threshold."""
    ksize, stride, cins, in_dt = site
    rng = np.random.default_rng(4)
    B, H, W, Cout = 2, 8, 10, 32
    if in_dt == "f32":
        xs = [rng.normal(0, 1, (T * B, H, W, c)).astype(np.float32)
              for c in cins]
    else:
        xs = [rng.integers(0, 2, (T * B, H, W, c)).astype(np.int8)
              for c in cins]
    cin = sum(cins)
    kernel = rng.normal(0, 1.5 / np.sqrt(cin * ksize * ksize),
                        (Cout, cin, ksize, ksize)).astype(np.float32)
    mul = rng.uniform(0.8, 1.6, Cout).astype(np.float32)
    bias = rng.normal(0.3, 0.2, Cout).astype(np.float32)
    wp = np.float32(-0.3)
    xt = tuple(nchw(x) for x in xs)
    kt, mt = torch.from_numpy(kernel), torch.from_numpy(mul)
    bt = torch.from_numpy(bias)
    if ksize == 1:
        w = pcp.fold_conv1x1(kt, mt)
        preact = pcp.conv1x1_preact_plain(xt, w, bt)
        got = pcp.conv1x1_plif(xt, w, bt, T, torch.tensor(wp))
        want = jcp.conv1x1_plif_reference(
            tuple(jnp.asarray(x) for x in xs), jnp.asarray(w.numpy()),
            jnp.asarray(bias), T, jnp.asarray(wp))
        w_oihw = w.numpy()[:, :, None, None]
    else:
        w = pcp.fold_conv3x3(kt, mt)
        preact = pcp.conv3x3_preact_plain(xt[0], w, bt, stride)
        op = pcp.conv3x3_plif if stride == 1 else pcp.conv3x3s2_plif
        ref = (jcp.conv3x3_plif_reference if stride == 1
               else jcp.conv3x3s2_plif_reference)
        got = op(xt[0], w, bt, T, torch.tensor(wp))
        want = ref(jnp.asarray(xs[0]), jnp.asarray(w.numpy()),
                   jnp.asarray(bias), T, jnp.asarray(wp))
        w_oihw = kernel * mul[:, None, None, None]
    w16 = np.asarray(jnp.asarray(w_oihw).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    jpre = _jax_preact(xs, w16, bias, stride, ksize)
    np.testing.assert_allclose(nhwc(preact.numpy()), jpre, rtol=0, atol=1e-5)
    assert_spikes_match(nhwc(got.numpy()), want, margins(jpre, wp))


# ------------------------------------------- the wgmma kernels' launch plan

# (ksize, cins, cout, H, W): every flagship site the TPU's policy table
# fuses onto the wgmma kernels (ops/conv_plif_policy.py), then the small
# shapes of this file's conv tests.
PLAN_SITES = [
    (1, (96,), 48, 64, 80), (1, (48, 48), 96, 64, 80),
    (3, (96,), 96, 32, 40), (1, (96, 96), 192, 32, 40),
    (1, (384,), 192, 16, 20), (1, (192, 192), 384, 16, 20),
    (1, (384, 384), 768, 8, 10),
    (1, (16,), 24, 5, 6), (1, (8, 24), 24, 5, 6), (3, (8,), 16, 8, 6),
    (1, (16, 24), 32, 8, 10), (3, (16,), 32, 8, 10),
]


def _tile_pixels(ksize, tile, B, H, W):
    """The output pixels (b, h, w) of one 64-pixel tile, as the kernel
    maps them: 1x1, 64 consecutive of the flattened (b, h, w); 3x3, an 8x8
    block, row-major over the 8-wide tiles of each image."""
    if ksize == 1:
        r = np.arange(64 * tile, 64 * tile + 64)
        r = r[r < B * H * W]
        return {(int(i) // (H * W), int(i) % (H * W) // W, int(i) % W)
                for i in r}
    tw = -(-W // 8)
    per = tw * -(-H // 8)
    b, rem = divmod(tile, per)
    h0, w0 = (rem // tw) * 8, (rem % tw) * 8
    return {(b, h, w) for h in range(h0, min(h0 + 8, H))
            for w in range(w0, min(w0 + 8, W))}


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("B", [2, 128])
@pytest.mark.parametrize("site", PLAN_SITES)
def test_conv_plan_covers_every_output_once(site, B, itemsize):
    """The host's launch plan for the wgmma kernels, at every flagship
    fused geometry (B=128 as deployed, B=2 as the card-vs-CPU check runs
    it) and the small shapes of this file: legal wgmma widths, shared
    memory within a block's 232,448 bytes, and the blocks' tiles and
    channel chunks cover every output pixel and channel exactly once."""
    ksize, cins, cout, H, W = site
    plan = pcp.conv_plan(ksize, cins, cout, B, H, W, itemsize)
    assert plan.width in pcp.WGMMA_WIDTHS
    assert plan.width % 8 == 0 and plan.width <= 256
    assert plan.chunk % 8 == 0 and plan.chunk <= plan.width
    assert plan.smem <= pcp.SMEM_LIMIT
    assert plan.smem == pcp.wgmma_smem_bytes(ksize, plan.width, plan.k_pad,
                                             itemsize)
    assert plan.k_pad >= sum(cins)
    chans = [c for y in range(plan.n_chunks)
             for c in range(y * plan.chunk, min((y + 1) * plan.chunk, cout))]
    assert sorted(chans) == list(range(cout))
    assert plan.n_chunks * plan.grid_x <= pcp.H100_SMS
    tiles = [2 * x + c + 2 * plan.grid_x * i for x in range(plan.grid_x)
             for c in (0, 1) for i in range(plan.n_tiles)
             if 2 * x + c + 2 * plan.grid_x * i < plan.n_tiles]
    assert sorted(tiles) == list(range(plan.n_tiles))
    seen = []
    for t in tiles:
        seen += _tile_pixels(ksize, t, B, H, W)
    assert len(seen) == len(set(seen)) == B * H * W


# (cins, cout, H, W) of the stride-2 kernel: the dark2-dark4 downsamples,
# odd and ragged sizes, and the small shapes of this file's conv tests
PLAN_SITES_S2 = [
    ((48,), 96, 128, 160), ((96,), 192, 64, 80), ((192,), 384, 32, 40),
    ((16,), 24, 9, 12), ((8,), 16, 8, 6), ((24,), 8, 17, 20),
]


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("B", [2, 128])
@pytest.mark.parametrize("site", PLAN_SITES_S2)
def test_conv_plan_stride2_covers_every_output_once(site, B, itemsize):
    """The stride-2 kernel's plan: K in 16-channel chunks, the four parity
    planes and the raw stages (16-byte copies where an input row is whole
    16-byte copies, else 4-byte) within the 232,448 bytes, and the blocks'
    8x8 output tiles over (ceil(H/2), ceil(W/2)) and channel chunks cover
    every output exactly once. Where the plan refuses (dark4 in bf16 or
    f32), even 32 resident output channels overflow."""
    cins, cout, H, W = site
    k_pad = -(-cins[0] // 16) * 16
    copy = pcp.s2_copy_bytes(W, itemsize)
    assert copy == (16 if W * itemsize % 16 == 0 else 4)
    try:
        plan = pcp.conv_plan(3, cins, cout, B, H, W, itemsize, stride=2)
    except ValueError as e:
        assert "resident" in str(e) and cins[0] >= 192
        assert pcp.wgmma_smem_bytes(3, 32, k_pad, itemsize, 2,
                                    copy) > pcp.SMEM_LIMIT
        return
    assert plan.width in pcp.WGMMA_WIDTHS and plan.chunk <= plan.width
    assert plan.k_pad == k_pad
    assert plan.smem == pcp.wgmma_smem_bytes(3, plan.width, plan.k_pad,
                                             itemsize, 2,
                                             copy) <= pcp.SMEM_LIMIT
    chans = [c for y in range(plan.n_chunks)
             for c in range(y * plan.chunk, min((y + 1) * plan.chunk, cout))]
    assert sorted(chans) == list(range(cout))
    assert plan.n_chunks * plan.grid_x <= pcp.H100_SMS
    ho, wo = (H + 1) // 2, (W + 1) // 2
    tiles = [2 * x + c + 2 * plan.grid_x * i for x in range(plan.grid_x)
             for c in (0, 1) for i in range(plan.n_tiles)
             if 2 * x + c + 2 * plan.grid_x * i < plan.n_tiles]
    assert sorted(tiles) == list(range(plan.n_tiles))
    seen = []
    for t in tiles:
        seen += _tile_pixels(3, t, B, ho, wo)
    assert len(seen) == len(set(seen)) == B * ho * wo


def test_conv_plan_sizes_the_downsample_sites():
    """At B=128: the fused dark2 downsample (48 -> 96 from 128x160, bf16)
    runs whole, its 9 x 48 x 96 weights resident (K 48 in 3 chunks of
    16); dark3 (96 -> 192, int8) takes 3 chunks of 64 and dark4 (192 ->
    384) 12 of 32; dark5 (384 -> 768) is refused: 9 taps x 384 channels
    do not fit even for 32 outputs. A 3x3 has no other stride and a 1x1
    none but 1."""
    want = {((48,), 96, 128, 160, 2): (96, 1, 217_024),
            ((96,), 192, 64, 80, 1): (64, 3, 213_824),
            ((192,), 384, 32, 40, 1): (32, 12, 200_384)}
    for (cins, cout, H, W, isz), (width, n, smem) in want.items():
        plan = pcp.conv_plan(3, cins, cout, 128, H, W, isz, stride=2)
        assert (plan.width, plan.chunk, plan.n_chunks, plan.smem) == (
            width, width, n, smem)
    plan = pcp.conv_plan(3, (48,), 96, 128, 128, 160, 2, stride=2)
    assert plan.k_pad == 48 and plan.grid_x == pcp.H100_SMS
    assert plan.n_tiles == 128 * 8 * 10
    with pytest.raises(ValueError, match="conv3x3s2_plif.*resident"):
        pcp.conv_plan(3, (384,), 768, 128, 16, 20, 1, stride=2)
    for ksize, stride in ((3, 3), (1, 2)):
        with pytest.raises(ValueError, match="stride"):
            pcp.conv_plan(ksize, (8,), 8, 1, 8, 8, 1, stride=stride)


def test_conv3x3s2_wrapper_launches_the_wgmma_kernel_with_its_plan(
        monkeypatch):
    """On a non-CPU tensor ``conv3x3s2_plif`` launches the wgmma library's
    ``conv3x3s2_plif`` once with the stride-2 plan (width, chunk, chunks,
    grid), the geometry of the input and an int8 (T*B, Cout, ceil(H/2),
    ceil(W/2)) output, and counts the launch (meta tensors stand in for
    CUDA ones, ``tests/torch_meta.py``)."""
    from eas_snn_tpu_torch.ops import _build
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "get_lib", lambda name: calls.append(
        ("lib", name)) or Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(pcp, "_operands", lambda w, b, wp, dev, what: (
        w, b, wp))
    x = torch.empty((6, 48, 9, 12), dtype=torch.bfloat16, device="meta")
    w3 = torch.zeros((3, 96, 144), device="meta")
    before = pcp.conv3x3s2_plif.launches
    with MetaAsCuda():
        out = pcp.conv3x3s2_plif(x, w3, torch.zeros(96, device="meta"), T,
                                 torch.zeros((), device="meta"))
    assert out.shape == (6, 96, 5, 6) and out.dtype == torch.int8
    assert pcp.conv3x3s2_plif.launches == before + 1
    assert calls[0] == ("lib", "conv_wgmma")
    name, args = calls[1]
    plan = pcp.conv_plan(3, (48,), 96, 6 // T, 9, 12, 2, 132, 2)
    assert name == "conv3x3s2_plif"
    assert args[5:15] == (6 // T, T, 48, 96, 9, 12, plan.width, plan.chunk,
                          plan.n_chunks, plan.grid_x)
    assert args[17] == 1  # bf16


def test_conv_plan_sizes_the_flagship_sites():
    """Flagship (B=128, int8 spikes): Cout 48 and 96 run whole, 192 in two
    chunks of 96, 384 in four and 768 in eight; nothing is padded to 64
    output channels, and the 3x3 keeps all 9 x 96 x 96 weights resident."""
    want = {(1, (96,), 48, 64, 80): (48, 1), (1, (48, 48), 96, 64, 80):
            (96, 1), (3, (96,), 96, 32, 40): (96, 1),
            (1, (96, 96), 192, 32, 40): (96, 2),
            (1, (384,), 192, 16, 20): (96, 2),
            (1, (192, 192), 384, 16, 20): (96, 4),
            (1, (384, 384), 768, 8, 10): (96, 8)}
    for (ksize, cins, cout, H, W), (width, n) in want.items():
        plan = pcp.conv_plan(ksize, cins, cout, 128, H, W, 1)
        assert (plan.width, plan.chunk, plan.n_chunks) == (width, width, n)
    plan = pcp.conv_plan(3, (96,), 96, 128, 32, 40, 1)
    assert plan.k_pad == 96 and plan.grid_x == pcp.H100_SMS
    with pytest.raises(ValueError, match="resident"):
        pcp.conv_plan(3, (512,), 8, 2, 4, 4, 1)


def test_fold_conv3x3_matches_jax_exactly():
    rng = np.random.default_rng(5)
    kernel = rng.normal(0, 1, (24, 16, 3, 3)).astype(np.float32)
    mul = rng.uniform(0.5, 2, 24).astype(np.float32)
    want = jcp.fold_conv3x3(jnp.asarray(kernel.transpose(2, 3, 1, 0)),
                            jnp.asarray(mul))
    got = pcp.fold_conv3x3(torch.from_numpy(kernel), torch.from_numpy(mul))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_policy_table_and_modes():
    assert should_fuse(3, 2, 128, 160, (48,), 96)
    assert should_fuse(1, 1, 64, 80, (48, 48), 96)
    assert not should_fuse(3, 1, 64, 80, (48,), 48)
    assert should_fuse(3, 1, 64, 80, (48,), 48, mode="always")
    assert not should_fuse(3, 2, 128, 160, (48,), 96, mode="never")
    with pytest.raises(ValueError):
        should_fuse(1, 1, 4, 4, (8,), 8, mode="1x1")
