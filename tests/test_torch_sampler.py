"""The port's fused ARSNN sampler (``eas_snn_tpu_torch/ops/arsnn_fused.py``,
the ``fused_sampler`` route of the embedding and the detector) against the
JAX package's fused sampler (``eas_snn_tpu/ops/arsnn_pallas.py``, its
Pallas kernels in interpret mode) on the CPU, where the port's wrappers run
their plain versions.

Inputs are drawn with numpy from a seed and handed to both sides. Each
route is compared with the same route in JAX: the whole-scan kernel (v2)
computes in f32 whatever the state dtype, so under ``deploy()`` it gives
other numbers than the plain scan.
"""

import functools
import importlib.util
import os
from fractions import Fraction

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from eas_snn_tpu.models import EASYOLOX as JEASYOLOX
from eas_snn_tpu.models.embedding import ARSNNEmbedding as JARSNNEmbedding
from eas_snn_tpu.ops import arsnn_pallas as jfused
from eas_snn_tpu.ops.surrogate import get_spike_fn

from eas_snn_tpu_torch.exp import get_exp
from eas_snn_tpu_torch.models import ARSNNEmbedding, EASYOLOX
from eas_snn_tpu_torch.models import embedding as pemb
from eas_snn_tpu_torch.ops import arsnn_fused as pf
from eas_snn_tpu_torch.utils import state_dict_from_jax

from test_torch_model import SMALL, _np_tree, _random_variables
from torch_meta import MetaAsCuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                      torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def nchw(x):
    """(..., H, W, C) numpy -> (..., C, H, W) torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def nhwc(x):
    return np.moveaxis(x.float().numpy(), -3, -1)


# --------------------------------------------------------- v1: one step

def _step_inputs(rng, shape, Ts, t):
    f = lambda s=1.0, m=0.0: (m + s * rng.standard_normal(shape)).astype(  # noqa
        np.float32)
    planes = [f(1.5), f(1.5), f(1.0, 0.8), f(0.5)]    # g_in g_rec c_in c_rec
    vmem, vavg = f(1.0, 0.5), f(2.0)
    seg = rng.integers(0, Ts + 1, shape).astype(np.int8)
    tlast = rng.integers(-1, t, shape).astype(np.int8)
    agg = (rng.standard_normal((Ts,) + shape) * 0.5).astype(np.float32)
    return planes, vmem, vavg, seg, tlast, agg


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("readout,vreset,attach", [
    ("sum", None, False), ("last", 0.0, True), ("avg", None, True)])
def test_fused_step_matches_jax_kernel_and_reference(dt, readout, vreset,
                                                     attach):
    """``fused_step_plain`` (and ``fused_step`` on CPU tensors, in place)
    against JAX ``_fused_step(interpret=True)`` and
    ``fused_step_reference`` on the same state: state within 1e-6
    relative in f32 and one bf16 ulp in bf16; spikes, seg and t_last
    equal."""
    jdt, tdt = BF16[dt]
    rng = np.random.default_rng(11)
    Ts, t, shape = 3, 2, (2, 2, 64, 256)   # 65,536 = one (512, 128) tile
    planes, vmem, vavg, seg, tlast, agg = _step_inputs(rng, shape, Ts, t)
    kw = dict(Ts=Ts, thresh=1.0, vreset=vreset, readout=readout,
              spike_attach=attach)

    def rnd(x):  # the inputs in the state dtype, as numpy f32
        return np.asarray(jnp.asarray(x).astype(jdt).astype(jnp.float32))

    planes, vmem, vavg, agg = ([rnd(p) for p in planes], rnd(vmem),
                               rnd(vavg), rnd(agg))
    tiles = lambda x: jnp.asarray(x.reshape(-1, 128)).astype(jdt)  # noqa
    j_args = ([tiles(p) for p in planes] + [tiles(vmem), tiles(vavg)]
              + [jnp.asarray(seg.reshape(-1, 128), jnp.int32),
                 jnp.asarray(tlast.reshape(-1, 128), jnp.int32),
                 jnp.asarray(agg.reshape(Ts, -1, 128)).astype(jdt)])
    want = jfused._fused_step(t, *j_args, interpret=True, **kw)
    ref = jfused.fused_step_reference(t, *j_args, spike_fn=get_spike_fn(
        "rect", 1.0), **kw)

    tt = lambda x: torch.from_numpy(x).to(tdt)  # noqa
    p_args = ([tt(p) for p in planes] + [tt(vmem), tt(vavg)]
              + [torch.from_numpy(seg), torch.from_numpy(tlast), tt(agg)])
    got = pf.fused_step_plain(t, *p_args, **kw)
    state = [a.clone() for a in p_args[4:]]
    inplace = pf.fused_step(t, *p_args[:4], *state, **kw)
    assert all(a is b for a, b in zip(inplace[:2] + inplace[3:], state))

    names = ("vmem", "vavg", "spike", "seg", "tlast", "agg")
    for name, g, w, r, ip in zip(names, got, want, ref, inplace):
        g, ip = g.float().numpy(), ip.float().numpy()
        np.testing.assert_array_equal(ip, g, err_msg=name)
        for other in (w, r):
            o = np.asarray(jnp.asarray(other).astype(jnp.float32)).reshape(
                g.shape)
            if name in ("spike", "seg", "tlast"):
                np.testing.assert_array_equal(g, o, err_msg=name)
            elif dt == "f32":
                np.testing.assert_allclose(g, o, rtol=1e-6, atol=1e-6,
                                           err_msg=name)
            else:  # one bf16 ulp: 2^-7 relative
                np.testing.assert_allclose(g, o, rtol=2.0 ** -7, atol=1e-30,
                                           err_msg=name)
    spike = got[2].float()
    assert 0.1 < float(spike.mean()) < 0.9
    assert int((got[3] != p_args[6]).sum()) > 1000   # slots were written


# ------------------------------------------------------ v1: the scan

def _make_convs(rng, cin, cout, ksize=3, depth=1, bias=False, scale=0.5):
    """Depth-stacked conv[ReLU conv] weights (numpy HWIO, bias) and the
    same stack as a JAX and a torch closure."""
    ws = []
    dims = [(cin, 2 * cout)] + [(2 * cout, 2 * cout)] * (depth - 1)
    for ci, co in dims:
        k = (rng.standard_normal((ksize, ksize, ci, co)) * scale).astype(
            np.float32)
        b = ((rng.standard_normal(co) * 0.1) if bias else np.zeros(co)
             ).astype(np.float32)
        ws.append((k, b))
    pad = [(ksize // 2,) * 2] * 2

    def japply(x):
        for i, (k, b) in enumerate(ws):
            if i:
                x = jax.nn.relu(x)
            x = jax.lax.conv_general_dilated(
                x, jnp.asarray(k).astype(x.dtype), (1, 1), pad,
                dimension_numbers=("NHWC", "HWIO", "NHWC")) + b.astype(x.dtype)
        return x

    tw = [(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
           torch.from_numpy(b)) for k, b in ws]

    def tapply(x):
        for i, (k, b) in enumerate(tw):
            if i:
                x = torch.relu(x)
            x = F.conv2d(x, k.to(x.dtype), padding=ksize // 2) + \
                b.to(x.dtype)[None, :, None, None]
        return x

    return ws, tw, japply, tapply


@pytest.mark.parametrize("case", [
    ("sum", False, False, None), ("last", False, False, None),
    ("avg", False, False, None), ("sum", True, True, None),
    ("last", True, True, None), ("avg", True, True, None),
    ("hard", False, False, 0.0)])
def test_scan_fused_matches_jax(case):
    """The port's ``arsnn_scan_fused`` (v1 steps, convs outside) against
    JAX ``arsnn_scan_fused(interpret=True)`` on the cases of
    ``tests/test_arsnn_pallas.py`` (test_fused_matches_scan and
    test_fused_hard_reset), at 1e-5."""
    readout, write_zero, attach, vreset = case
    hard = readout == "hard"
    rng = np.random.default_rng(3 if hard else 0)
    Tm, N, H, W, C = (4, 1, 6, 6, 2) if hard else (5, 2, 8, 8, 2)
    Ts = 2 if hard else 3
    readout = "sum" if hard else readout
    ev = (rng.standard_normal((Tm, N, H, W, C)) * 2.0).astype(np.float32)
    _, _, jin, tin = _make_convs(rng, C, C)
    _, _, jgate, tgate = _make_convs(rng, C, C)
    kw = dict(Ts=Ts, thresh=1.0, vreset=vreset, readout=readout,
              spike_attach=attach, write_zero=write_zero)
    want = np.asarray(jfused.arsnn_scan_fused(
        jnp.asarray(ev), jin, jgate, spike_fn=get_spike_fn("rect", 1.0),
        interpret=True, **kw))
    got = pf.arsnn_scan_fused(nchw(ev), tin, tgate, **kw)
    assert got.shape == (Ts, N, C, H, W)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)
    assert (want != 0).mean() > 0.2


@pytest.mark.parametrize("readout,vreset", [("sum", None), ("last", None),
                                            ("avg", 0.0)])
def test_plain_scan_bf16_gate_chain_equals_jax_bitwise(readout, vreset):
    """The port's plain ``arsnn_scan`` in bf16 against the JAX
    ``arsnn_scan`` in bf16, bit for bit: the aggregation (every written
    membrane and slot) and, through the JAX scan's recorded last-spike
    times, every spike. The input and gate "convs" are 1x1 maps scaled by
    powers of two (g = x, c = x/2 on the events; g = 3/4 s - 1/2, c = s/2
    on the spikes), exact in bf16 on both sides, so the comparison sees
    only the gate chain: XLA expands ``jax.nn.sigmoid`` in bf16 as
    1/(1+exp(-x)) rounded after every op, which ``torch.sigmoid``, with
    its single rounding, does not equal (it differs from it in about a
    third of N(0, 3) bf16 inputs)."""
    from eas_snn_tpu.ops.arsnn import arsnn_scan as jscan
    from eas_snn_tpu_torch.ops.arsnn import arsnn_scan as tscan
    from eas_snn_tpu_torch.ops.surrogate import get_spike_fn as tspike

    rng = np.random.default_rng(11)
    Tm, N, H, W, C = 6, 2, 16, 16, 2
    ev = (rng.standard_normal((Tm, N, H, W, C)) * 3.0).astype(np.float32)
    kw = dict(Ts=3, thresh=1.0, vreset=vreset, readout=readout)

    want, t_last = jscan(
        jnp.asarray(ev, jnp.bfloat16),
        lambda x: jnp.concatenate([x, x * 0.5], -1),
        lambda s: jnp.concatenate([s * 0.75 - 0.5, s * 0.5], -1),
        spike_fn=get_spike_fn("rect", 1.0), record=True, **kw)
    got = tscan(
        nchw(ev).to(torch.bfloat16),
        lambda x: torch.cat([x, x * 0.5], 1),
        lambda s: torch.cat([s * 0.75 - 0.5, s * 0.5], 1),
        spike_fn=tspike("rect", 1.0), **kw)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    assert (want != 0).mean() > 0.2
    t_last = np.asarray(t_last)
    assert 0 < (t_last >= 0).mean() < 1
    np.testing.assert_array_equal(nhwc(got), want)


# ------------------------------------------------------ v2: whole scan

V2_CASES = {
    "sum-soft-d2k3-zero": ("sum", None, True, False, 2, 3),
    "last-hard-d2k5-abs": ("last", 0.0, False, True, 2, 5),
    "avg-soft-d1k7-zero-abs": ("avg", None, True, True, 1, 7),
    "avg-hard-d2k7": ("avg", 0.0, False, False, 2, 7),
    "sum-hard-d1k5-abs": ("sum", 0.0, False, True, 1, 5),
    "last-soft-d1k3-zero": ("last", None, True, False, 1, 3),
}


def _v2_pair(ev, iw, gw, kw):
    want = np.asarray(jfused.arsnn_fused_v2(
        jnp.asarray(ev), [(jnp.asarray(k), jnp.asarray(b)) for k, b in iw],
        [(jnp.asarray(k), jnp.asarray(b)) for k, b in gw], interpret=True,
        **kw))
    tw = lambda ws: [(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),  # noqa
                      torch.from_numpy(b)) for k, b in ws]
    got = pf.arsnn_fused_v2(nchw(ev), tw(iw), tw(gw), **kw)
    return got, want


@pytest.mark.parametrize("name", list(V2_CASES))
def test_fused_v2_matches_jax(name):
    """``arsnn_fused_v2`` (its plain version on the CPU) against JAX
    ``arsnn_fused_v2(interpret=True)`` at 16x17: every readout, soft and
    hard reset, write_zero, use_abs, depth 1 and 2, ksize 3, 5 and 7, at
    1e-5."""
    readout, vreset, write_zero, use_abs, depth, ksize = V2_CASES[name]
    rng = np.random.default_rng(sorted(V2_CASES).index(name))
    Tm, N, H, W, C = 4, 2, 16, 17, 2
    ev = (rng.standard_normal((Tm, N, H, W, C)) * 2.0).astype(np.float32)
    iw, _, _, _ = _make_convs(rng, C, C, ksize, depth, bias=True, scale=0.4)
    gw, _, _, _ = _make_convs(rng, C, C, ksize, depth, bias=True, scale=0.4)
    kw = dict(Ts=3, thresh=1.0, vreset=vreset, readout=readout,
              spike_attach=True, write_zero=write_zero, use_abs=use_abs)
    got, want = _v2_pair(ev, iw, gw, kw)
    assert got.dtype == torch.float32 and got.shape == (3, N, C, H, W)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)
    # every slot is written somewhere (a hard reset zeroes the 'last'
    # readout of a spiking element: only the residual is non-zero then)
    for s in range(3 if readout != "last" or vreset is None else 0):
        assert (want[s] != 0).mean() > 0.01, s
    if use_abs:
        assert want.min() >= 0


def test_fused_v2_intermediate_layer_is_zero_padded():
    """A large first-layer bias makes relu(bias) != 0 at the border: the
    second layer must see zeros outside the image there, not relu(bias +
    conv), or the border pixels change. Held to JAX, and the border moves
    when the padding is taken as relu(bias) instead."""
    rng = np.random.default_rng(21)
    Tm, N, H, W, C = 3, 1, 16, 17, 2
    ev = (rng.standard_normal((Tm, N, H, W, C)) * 2.0).astype(np.float32)
    iw, _, _, _ = _make_convs(rng, C, C, 5, 2, bias=True, scale=0.3)
    gw, _, _, _ = _make_convs(rng, C, C, 5, 2, bias=True, scale=0.3)
    iw[0] = (iw[0][0], np.full(4, 1.5, np.float32))
    gw[0] = (gw[0][0], np.full(4, 1.5, np.float32))
    kw = dict(Ts=3, thresh=1.0, vreset=None, readout="sum",
              spike_attach=False, write_zero=False, use_abs=False)
    got, want = _v2_pair(ev, iw, gw, kw)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)

    # the same stack with the intermediate layer padded by relu(bias)
    x = torch.zeros(1, 2, H, W)
    tw = [(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
           torch.from_numpy(b)) for k, b in gw]
    zero_pad = pf._stack_plain(x, tw)
    mid = torch.relu(pf._stencil_plain(x, *tw[0]))
    mid = F.pad(mid, (2, 2, 2, 2), value=1.5)   # relu(bias) outside
    wrong = pf._stencil_plain(mid, *tw[1])[..., 2:-2, 2:-2]
    assert not torch.allclose(zero_pad[..., :2, :], wrong[..., :2, :])
    torch.testing.assert_close(zero_pad[..., 2:-2, 2:-2],
                               wrong[..., 2:-2, 2:-2], rtol=0, atol=0)


def test_fused_v2_first_step_runs_the_gate_stack_on_zero_spikes():
    """At t = 0 the gate stack still runs, on zero spikes: its output is
    the bias (through both layers) and drives the gate. With a gate bias
    that closes the gate and a current bias of 1.5, step 0 alone fires
    everywhere; with a zero gate-stack bias it fires nowhere."""
    H, W = 8, 8
    ev = torch.zeros(1, 1, 2, H, W)
    zeros = lambda ci: (torch.zeros(4, ci, 3, 3), torch.zeros(4))  # noqa
    iw = [zeros(2)]
    kw = dict(Ts=1, thresh=1.0, vreset=None, readout="sum",
              write_zero=False)
    gw = [(torch.zeros(4, 2, 3, 3), torch.tensor([-9.0, -9.0, 1.5, 1.5]))]
    out = pf.arsnn_fused_v2(ev, iw, gw, **kw)
    torch.testing.assert_close(out, torch.full_like(out, 1.5))
    assert float(pf.arsnn_fused_v2(ev, iw, [zeros(2)], **kw).abs().max()) == 0


def _round_f32(x: Fraction) -> np.float32:
    """The f32 nearest the rational x, ties to even."""
    c0 = np.float32(float(x))
    cands = (np.nextafter(c0, np.float32(-np.inf)), c0,
             np.nextafter(c0, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.int32)) & 1))


def test_fma_f32_rounds_once_as_exact_rationals():
    """``fma_f32`` (the v2 plain version's multiply-add) against a * b + c
    computed exactly with fractions and rounded once to f32, ties to even:
    2,400 values with plain draws, operands scaled by 2^30 and 2^-30,
    near-cancellations (c within 1e-6 relative of -a*b) and cases where
    the f64 sum lands exactly on an f32 tie that the exact sum is off (a
    plain f64 sum, then a conversion, rounds those the wrong way). The
    unfused ``a * b + c`` in f32 differs from it on many."""
    rng = np.random.default_rng(8)
    n = 600
    a, b, c = (rng.standard_normal(4 * n).astype(np.float32) for _ in "abc")
    a[:n] *= np.float32(2.0 ** 30)
    b[n:2 * n] *= np.float32(2.0 ** -30)
    c[2 * n:3 * n] = -(a[2 * n:3 * n] * b[2 * n:3 * n]) * (
        1 + 1e-6 * rng.standard_normal(n)).astype(np.float32)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24: an f32 tie, broken by a tiny c
    tie = np.float32(1 + 2.0 ** -12) * np.float32(
        [1, -1] * (n // 2)) * np.float32(2.0) ** rng.integers(
            -20, 20, n).astype(np.float32)
    a[3 * n:], b[3 * n:] = tie, np.abs(tie)
    c[3 * n:] = np.float32(2.0 ** -60) * np.sign(
        rng.standard_normal(n)).astype(np.float32) * np.abs(tie) ** 2
    got = pf.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    unfused = (torch.from_numpy(a) * torch.from_numpy(b)
               + torch.from_numpy(c)).numpy()
    assert (unfused != want).sum() > 100
    via_f64 = (torch.from_numpy(a).double() * torch.from_numpy(b).double()
               + torch.from_numpy(c).double()).float().numpy()
    assert (via_f64[3 * n:] != want[3 * n:]).sum() > n // 4


def test_stencil_plain_rounds_once_per_multiply_add():
    """``_stencil_plain`` equals a scalar loop of ``fma_f32`` in the JAX
    kernel's order (bias, then dy, ci, dx) at every output, and so differs
    from the same loop with the multiply and the add rounded apart."""
    rng = np.random.default_rng(9)
    N, ci_n, co_n, k, H, W = 1, 2, 4, 3, 5, 6
    x = torch.from_numpy(rng.standard_normal((N, ci_n, H, W)).astype(
        np.float32) * 2)
    w = torch.from_numpy(rng.standard_normal((co_n, ci_n, k, k)).astype(
        np.float32) * 0.4)
    b = torch.from_numpy(rng.standard_normal(co_n).astype(np.float32) * 0.1)
    got = pf._stencil_plain(x, w, b)
    xp = F.pad(x, (1, 1, 1, 1))
    want = torch.empty_like(got)
    unfused = torch.empty_like(got)
    for co in range(co_n):
        for h in range(H):
            for j in range(W):
                acc = acc_u = b[co]
                for dy in range(k):
                    for ci in range(ci_n):
                        for dx in range(k):
                            wv, xv = w[co, ci, dy, dx], xp[0, ci, h + dy,
                                                           j + dx]
                            acc = pf.fma_f32(wv, xv, acc)
                            acc_u = acc_u + wv * xv
                want[0, co, h, j], unfused[0, co, h, j] = acc, acc_u
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got != unfused).any()


def test_fused_v2_plain_scans_the_batch_in_chunks(monkeypatch):
    """The plain version scans the batch in chunks that keep its f64
    temporaries small; the batch elements are independent, so any chunking
    gives the same slots bit for bit."""
    rng = np.random.default_rng(10)
    Tm, N, H, W = 3, 5, 12, 13
    ev = torch.from_numpy((rng.standard_normal((Tm, N, 2, H, W)) * 2).astype(
        np.float32))

    def conv(ci, co):
        return (torch.from_numpy(rng.standard_normal((co, ci, 3, 3)).astype(
            np.float32) * 0.4), torch.from_numpy(
                rng.standard_normal(co).astype(np.float32) * 0.1))

    iw, gw = [conv(2, 4), conv(4, 4)], [conv(2, 4), conv(4, 4)]
    kw = dict(Ts=3, thresh=1.0, vreset=None, readout="avg")
    whole = pf.arsnn_fused_v2_plain(ev, iw, gw, **kw)
    monkeypatch.setattr(pf, "PLAIN_CHUNK_ELEMS", 2 * 4 * H * W)
    chunked = pf.arsnn_fused_v2_plain(ev, iw, gw, **kw)
    assert (whole != 0).float().mean() > 0.05
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


# ------------------------------------------------------ the embedding

EMB_KW = dict(ksize=5, depth=2, Ts=3, readout="sum", write_zero=True,
              thresh=1.0, vreset=None)


@pytest.mark.parametrize("case", ["v2-f32", "v2-deploy", "v1-f32"])
def test_embedding_fused_route_matches_jax(case):
    """``ARSNNEmbedding(fused_sampler='always')`` against the JAX
    ``ARSNNEmbedding(use_pallas='always')`` with the same weights: the v2
    route in f32 and under ``deploy()``'s bf16 state and conv dtypes (the
    kernel computes in f32 on the bf16-rounded events), and the v1 route
    (depth 3, outside v2's gate) in f32; at 1e-5. JAX's own v1 route
    launches its Pallas kernel without interpret mode, so it runs only on
    a TPU: the v1 case holds the port to the JAX plain scan, whose forward
    the JAX v1 equals (``tests/test_arsnn_pallas.py``)."""
    route, prec = case.split("-")
    rng = np.random.default_rng(4)
    ev = (rng.standard_normal((2, 1, 4, 16, 24, 2)) * 2.0).astype(np.float32)
    kw = dict(EMB_KW, depth=3, ksize=3) if route == "v1" else EMB_KW
    jkw, tkw = {}, {}
    if prec == "deploy":
        jkw = dict(dtype=jnp.bfloat16, state_dtype="bfloat16")
        tkw = dict(dtype=torch.bfloat16, state_dtype=torch.bfloat16)
    je = JARSNNEmbedding(use_pallas="never" if route == "v1" else "always",
                         spike_attach=True, **kw, **jkw)
    v = _np_tree(je.init(jax.random.PRNGKey(0), jnp.asarray(ev)))
    # non-zero biases, so that the bias paths are held too
    for k in v["params"]:
        if "bias" in k:
            v["params"][k] = (rng.standard_normal(v["params"][k].shape)
                              * 0.1).astype(np.float32)
    want = np.asarray(je.apply(v, jnp.asarray(ev)))
    pe = ARSNNEmbedding(fused_sampler="always", spike_attach=True, **kw,
                        **tkw).eval()
    sd = state_dict_from_jax({"params": {"embedding": v["params"]}})
    pe.load_state_dict({k[len("embedding."):]: t for k, t in sd.items()},
                       strict=True)
    ev_t = torch.from_numpy(ev)
    assert pe.route(pemb.fold_time(ev_t).permute(0, 1, 4, 2, 3)) == route
    with torch.no_grad():
        got = pe(ev_t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)
    assert all((want[s] != 0).mean() > 0.002 for s in range(3))


def test_fused_sampler_routing(monkeypatch):
    """'never' and 'auto' take the plain scan on the CPU; 'always' takes
    v2 at the flagship geometry and v1 at depth 3 or ksize 9; a training
    module never takes v2 and raises when the gradient is needed."""
    flagship = torch.empty((4, 128, 2, 256, 320), device="meta")
    for mode, want in (("never", "plain"), ("auto", "plain"),
                       ("always", "v2")):
        e = ARSNNEmbedding(fused_sampler=mode, **EMB_KW).eval()
        assert e.route(flagship) == want, mode
    for kw in (dict(depth=3), dict(ksize=9)):
        e = ARSNNEmbedding(fused_sampler="always", **dict(EMB_KW, **kw)).eval()
        assert e.route(flagship) == "v1"
    e = ARSNNEmbedding(fused_sampler="always", **EMB_KW).train()
    assert e.route(flagship) == "v1"
    with pytest.raises(ValueError, match="fused_sampler"):
        ARSNNEmbedding(fused_sampler="sometimes")

    calls = []
    for name in ("arsnn_scan", "arsnn_scan_fused", "arsnn_fused_v2"):
        orig = getattr(pemb, name)
        monkeypatch.setattr(pemb, name, lambda *a, _n=name, _o=orig, **k:
                            calls.append(_n) or _o(*a, **k))
    ev = torch.poisson(torch.full((1, 1, 3, 8, 8, 2), 0.5),
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ARSNNEmbedding(fused_sampler="auto", **EMB_KW).eval()(ev)
        ARSNNEmbedding(fused_sampler="always", **EMB_KW).eval()(ev)
        ARSNNEmbedding(fused_sampler="always", **EMB_KW).train()(ev)
    assert calls == ["arsnn_scan", "arsnn_fused_v2", "arsnn_scan_fused"]
    with pytest.raises(RuntimeError, match="no gradient"):
        ARSNNEmbedding(fused_sampler="always", **EMB_KW).train()(ev)
    out = ARSNNEmbedding(fused_sampler="never", **EMB_KW).train()(ev)
    assert out.requires_grad


def test_deploy_engages_the_fused_sampler_on_the_card():
    """``deploy()`` sets fused_sampler='auto' (measured faster on the H100,
    PERF.md): the whole-scan kernel on CUDA events, the plain scan on the
    CPU; the train precision keeps 'never'."""
    exp = get_exp("gen1_syolox_m").deploy()
    assert exp.fused_sampler == "auto"
    emb = exp.get_model(device="cpu").embedding
    assert emb.fused_sampler == "auto"
    assert emb.route(torch.empty((4, 128, 2, 256, 320), device="meta",
                                 dtype=torch.bfloat16)) == "plain"
    assert get_exp("gen1_syolox_m").fused_sampler == "never"
    assert get_exp("gen1_syolox_m").get_model(
        device="cpu", train=True).embedding.fused_sampler == "never"


# ------------------------------------------------------ the detector

def test_whole_model_fused_route_matches_jax():
    """A small EASYOLOX with the fused sampler route (v2) against the JAX
    EASYOLOX(use_pallas='always') with the same weights, in f32: the
    backbone's spikes equal, the decoded outputs within the tolerances of
    ``test_whole_slice_matches_jax_f32``."""
    rng = np.random.default_rng(0)
    ev = rng.poisson(0.4, (2, 1, 4, 64, 64, 2)).astype(np.float32)
    jm = JEASYOLOX(use_spike="backbone", embedding="arsnn",
                   use_pallas="always", **SMALL)
    v = _random_variables(jm, ev, rng)
    apply = jax.jit(functools.partial(
        jm.apply, mutable=["intermediates"],
        capture_intermediates=lambda m, _: type(m).__name__ == "CSPDarknet"))
    want, st = apply(v, jnp.asarray(ev))
    want = np.asarray(want)
    jfeats = st["intermediates"]["backbone"]["backbone"]["__call__"][0]

    pm = EASYOLOX(use_spike="backbone", fused_sampler="always", **SMALL)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    pm.eval()
    feats = {}
    pm.backbone.backbone.register_forward_hook(lambda m, i, o: feats.update(o))
    with torch.no_grad():
        got = pm(torch.from_numpy(ev)).numpy()
    assert got.shape == want.shape == (2, 84, 7)
    for stage in ("dark3", "dark4", "dark5"):
        s_j = np.asarray(jfeats[stage])
        np.testing.assert_array_equal(
            feats[stage].permute(0, 2, 3, 1).numpy(), s_j)
        assert 0.02 < s_j.mean() < 0.6, stage
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# ------------------------------------------------- layouts and geometry

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _step_call(dtype=torch.bfloat16, shape=(2, 2, 4, 4), Ts=3,
               channels_last=False, agg_Ts=None):
    x = [_meta(*shape, dtype=dtype) for _ in range(6)]
    if channels_last:
        x[0] = x[0].to(memory_format=torch.channels_last)
    seg, tlast = _meta(*shape, dtype=torch.int8), _meta(*shape,
                                                       dtype=torch.int8)
    agg = _meta(agg_Ts or Ts, *shape, dtype=dtype)
    return lambda: pf.fused_step(1, *x[:4], x[4], x[5], seg, tlast, agg,
                                 Ts=Ts, thresh=1.0, vreset=None)


def _v2_call(depth=2, ksize=5, C=2, dtype=torch.float32, Tm=4):
    ev = _meta(Tm, 2, 2, 8, 8, dtype=dtype)
    dims = [(2, 2 * C)] + [(2 * C, 2 * C)] * (depth - 1)
    ws = [(_meta(co, ci, ksize, ksize), _meta(co)) for ci, co in dims]
    gs = [(_meta(co, ci if i else C, ksize, ksize), _meta(co))
          for i, (ci, co) in enumerate(dims)]
    return lambda: pf.arsnn_fused_v2(ev, ws, gs, Ts=3, thresh=1.0,
                                     vreset=None)


@pytest.mark.parametrize("case", [
    "step_dtype", "step_strides", "step_vectors", "step_agg", "step_time",
    "v2_depth", "v2_ksize", "v2_even_ksize", "v2_channels", "v2_dtype",
    "v2_steps"])
def test_wrappers_refuse_what_the_sampler_kernels_cannot_take(monkeypatch,
                                                             case):
    """On a non-CPU tensor the sampler wrappers raise for a dtype, layout
    or geometry their kernels do not take (meta tensors stand in for CUDA
    ones, ``tests/torch_meta.py``; the library is never reached)."""
    from eas_snn_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "get_lib", lambda name: pytest.fail(name))
    calls = {
        "step_dtype": _step_call(dtype=torch.float16),
        # the four planes need NCHW strides
        "step_strides": _step_call(channels_last=True),
        # bf16 C*H*W must split into 8-element vectors
        "step_vectors": _step_call(shape=(2, 2, 3, 3)),
        "step_agg": _step_call(agg_Ts=2),
        "step_time": lambda: pf.fused_step(
            127, *[_meta(1, 2, 4, 4)] * 6, _meta(1, 2, 4, 4, dtype=torch.int8),
            _meta(1, 2, 4, 4, dtype=torch.int8), _meta(1, 1, 2, 4, 4), Ts=1,
            thresh=1.0, vreset=None),
        "v2_depth": _v2_call(depth=3),
        "v2_ksize": _v2_call(ksize=9),
        "v2_even_ksize": _v2_call(ksize=4),
        "v2_channels": _v2_call(C=4),
        "v2_dtype": _v2_call(dtype=torch.float16),
        "v2_steps": _v2_call(Tm=128),
    }
    with pytest.raises(ValueError, match="fused_step|arsnn_fused_v2"), \
            MetaAsCuda():
        calls[case]()


@pytest.mark.parametrize("name,B,want", [
    ("gen1_syolox_m", 1, {"plif_fwd": 35, "conv1x1_plif": 8,
                          "conv3x3_plif": 6, "conv3x3s2_plif": 1,
                          "arsnn_v2": 4}),
    ("gen4_rvt_syolox_m", 1, {"plif_fwd": 50, "arsnn_v2": 3}),
    ("ncaltech_syolox_m", 1, {"plif_fwd": 50, "arsnn_v2": 4})])
def test_fused_route_sites_pass_the_kernel_wrappers_checks(monkeypatch, name,
                                                           B, want):
    """The deploy forward with the fused route at the flagship, the Gen4
    and the N-Caltech geometry, on meta tensors as on the card
    (``tests/torch_meta.py``; the library replaced by stubs that launch
    nothing): every kernel wrapper
    takes its inputs, and a forward launches the whole-scan kernel Tm times
    (at 384x640 and 640x640 no site is in the TPU's fusion table, so all
    50 spiking sites take the PLIF kernel)."""
    from eas_snn_tpu_torch.ops import _build, launch_counts, reset_launches

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "get_lib", lambda name: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    exp = get_exp(name).deploy()
    exp.fused_sampler = "always"
    model = exp.get_model(device="cpu").to("meta")
    H, W = exp.test_size
    reset_launches()
    with MetaAsCuda():
        out = model(torch.empty((B, exp.Tl, exp.Tm, H, W, 2),
                                device="meta"))
    counts = launch_counts()
    reset_launches()
    assert out.shape[0] == B * exp.Tl and out.shape[2] == 5 + exp.num_classes
    assert counts == {k: want.get(k, 0) for k in counts}


def test_gen4_preset_fields_equal_the_jax_exp():
    """``get_exp('gen4_rvt_syolox_m')`` carries the model and test fields
    of ``exps/default/gen4_rvt_syolox_m.py``."""
    spec = importlib.util.spec_from_file_location(
        "gen4_exp", os.path.join(REPO, "exps", "default",
                                 "gen4_rvt_syolox_m.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jexp, pexp = mod.Exp(), get_exp("gen4_rvt_syolox_m")
    fields = ("exp_name", "depth", "width", "num_classes", "test_size",
              "use_spike", "embedding", "embedding_depth",
              "embedding_ksize", "readout", "write_zero", "reset", "thresh",
              "spike_fn", "spike_attach", "abs", "Tl", "Tm", "Ts", "T",
              "compute_dtype", "max_epoch", "scheduler", "basic_lr_per_img",
              "in_dim", "act", "test_conf", "nmsthre")
    for f in fields:
        assert getattr(pexp, f) == getattr(jexp, f), f
    assert pexp.fused_sampler == "never" and jexp.use_pallas == "never"
