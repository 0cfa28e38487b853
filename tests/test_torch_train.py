"""The port's training ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the port
runs its plain PyTorch versions (its tensors lie on the CPU). Where a JAX
Pallas backward runs (in interpret mode), ``EAS_PLIF_FAST_MATH=0`` pins
its atan surrogate to exact division, as the port's kernel divides.
Covered: the surrogate spike functions, the train PLIF op (the plain
versions of kernels 6, 7 and 8), train-mode BatchNorm, SimOTA and the
YOLOX losses, the LR schedules, the optimizer groups and the EMA.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from eas_snn_tpu.core import optim as joptim
from eas_snn_tpu.core.train_state import ema_update as j_ema_update
from eas_snn_tpu.models import simota as jsimota
from eas_snn_tpu.models.blocks import BatchNormFusable
from eas_snn_tpu.ops import boxes as jboxes
from eas_snn_tpu.ops.lif import plif_scan as j_plif_scan
from eas_snn_tpu.ops.plif_pallas import plif_fused as j_plif_fused
from eas_snn_tpu.ops.surrogate import get_spike_fn as j_spike_fn

from eas_snn_tpu_torch.core import optim as poptim
from eas_snn_tpu_torch.core.train_state import (ema_update, init_ema,
                                                optimizer_update)
from eas_snn_tpu_torch.models import simota as psimota
from eas_snn_tpu_torch.models.blocks import PLIF, BatchNorm
from eas_snn_tpu_torch.ops import boxes as pboxes
from eas_snn_tpu_torch.ops import plif as pplif
from eas_snn_tpu_torch.ops.plif import plif_train
from eas_snn_tpu_torch.ops.surrogate import get_spike_fn

T = 3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def exact_math(monkeypatch):
    monkeypatch.setenv("EAS_PLIF_FAST_MATH", "0")


def nchw(x):
    """(N, H, W, C) numpy/JAX -> (N, C, H, W) torch, f32."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy().transpose(0, 2, 3, 1)


# ------------------------------------------------------------- surrogates

@pytest.mark.parametrize("kind", ["rect", "atan", "sigmoid", "tanh"])
def test_surrogate_forward_and_gradient_match_jax(kind):
    """Exact for rect and atan (the same elementwise formula in the same
    order); 1e-6 for sigmoid and tanh, whose transcendental functions
    differ between the frameworks by an ulp or so (absolute as well as
    relative: near saturation 1 - t*t cancels, so an ulp of t is a large
    share of a tiny derivative)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([np.array([-1.0, -1e-7, 0.0, 1e-7, 0.5, -0.5],
                                 np.float32),
                        rng.normal(0, 1.0, 250).astype(np.float32)])
    g = rng.normal(0, 1.0, x.shape).astype(np.float32)
    fn = j_spike_fn(kind)
    want = np.asarray(fn(jnp.asarray(x)))
    want_dx = np.asarray(jax.grad(lambda v: (fn(v) * g).sum())(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = get_spike_fn(kind)(xt)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    if kind in ("rect", "atan"):
        np.testing.assert_array_equal(xt.grad.numpy(), want_dx)
    else:
        np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=1e-6,
                                   atol=1e-6)
    assert np.abs(want_dx).max() > 0


@pytest.mark.parametrize("gran", ["layer", "neuron"])
def test_patan_training_matches_jax(gran):
    """A patan (ASGL) site in training, the port's ``PLIF`` against the JAX
    package's (``eas_snn_tpu/models/blocks.py:PLIF``, its plain scan with
    ``asgl_spike``): the spikes exact; the gradients of x, w and the
    learnable alpha (a scalar, or one a neuron: (H, W, C) in JAX,
    (C, H, W) here) 1e-5 relative to their largest magnitude (sums in
    another order). ``get_spike_fn('patan')`` and ``plif_train``'s kind
    no longer raise for patan: the op routes by ``spike_fn``."""
    from eas_snn_tpu.models.blocks import PLIF as JPLIF

    rng = np.random.default_rng(11)
    B, H, W, C = 4, 5, 6, 8
    x = rng.normal(0.4, 1.0, (T * B, H, W, C)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    jp = JPLIF(T=T, spike_fn="patan", alpha=2.0, alpha_granularity=gran,
               fuse="never")
    v = jp.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    params = {"w": jnp.float32(-0.3),
              "alpha": jnp.asarray(rng.uniform(1, 3, v["params"]["alpha"]
                                               .shape).astype(np.float32))}

    def loss(p, xx):
        y = jp.apply({"params": p}, xx, train=True)
        return (y * g).sum(), y

    (_, want), (gp, gx) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        params, jnp.asarray(x))
    site = PLIF(T, "patan", alpha=2.0, alpha_granularity=gran,
                channels=C).train()
    alpha = np.asarray(params["alpha"])
    if gran == "neuron":
        site.materialize_alpha((C, H, W))
        alpha = alpha.transpose(2, 0, 1)
    with torch.no_grad():
        site.w.fill_(-0.3)
        site.asgl_alpha.copy_(torch.from_numpy(np.ascontiguousarray(alpha)))
    xt = nchw(x).requires_grad_()
    y = site(xt)
    (y * nchw(g)).sum().backward()
    np.testing.assert_array_equal(nhwc(y), np.asarray(want))
    assert 0.05 < float(y.mean()) < 0.95
    da = site.asgl_alpha.grad.numpy()
    if gran == "neuron":
        da = da.transpose(1, 2, 0)
    for name, a, b in (("x", nhwc(xt.grad), gx), ("w", site.w.grad.numpy(),
                                                   gp["w"]),
                       ("alpha", da, gp["alpha"])):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
        assert np.abs(b).max() > 0, name
    xs = torch.zeros(4, requires_grad=True)
    get_spike_fn("patan")(xs).sum().backward()
    assert torch.allclose(xs.grad, torch.full((4,), 1.0))  # alpha / 2
    with pytest.raises(NotImplementedError, match="plain scan"):
        plif_train(torch.zeros(3, 8, 2, 2), 3, torch.ones(1),
                   *(torch.zeros(8),) * 3, kind="patan")


# ---------------------------------------------------------- train PLIF op

def _plif_inputs(seed, C=16, B=128, H=4, W=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.0, (T * B, H, W, C)).astype(np.float32)
    mean = rng.normal(0.1, 0.3, C).astype(np.float32)
    mul = rng.normal(1.0, 0.2, C).astype(np.float32)
    bias = rng.normal(0.5, 0.2, C).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    return x, np.float32(-0.7), (mean, mul, bias), g


def _port_grads(x, w, bn, g, dtype, kind="atan"):
    """Spikes and (dx, dw, dmean, dmul, dbias) of sum(spikes * g) through
    the port's train PLIF op."""
    xt = nchw(x).to(dtype).requires_grad_()
    wt = torch.tensor(w, requires_grad=True)
    bt = [torch.from_numpy(p).requires_grad_() for p in bn]
    a = 1.0 - torch.sigmoid(wt)
    y = plif_train(xt, T, a, *bt, kind=kind)
    assert y.dtype == dtype
    (y.float() * nchw(g)).sum().backward()
    return y, [xt.grad, wt.grad] + [p.grad for p in bt]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_plif_matches_jax_affine_kernel(exact_math, dtype):
    """The plain train forward and backward (kernels 7 and 8) against the
    JAX affine kernel in interpret mode (``out_int8='view'``, the train
    store) at B=128 with a tiny H*W*C. Spikes equal; dx, dw and the BN
    terms' gradients to 1e-5 (f32 sums taken in another order; dx itself
    is one rounding of the same expression)."""
    x, w, bn, g = _plif_inputs(1)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x).astype(jdt)
    x = np.asarray(xj.astype(jnp.float32))  # the same values on both sides

    def loss(xx, ww, m, s, b):
        y = j_plif_fused(xx, T, ww, spike_fn="atan", interpret=True,
                         out_int8="view", affine=(m, s, b))
        return (y.astype(jnp.float32) * g).sum(), y

    (_, want), jg = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                       has_aux=True)(xj, jnp.float32(w),
                                                     *map(jnp.asarray, bn))
    y, pg = _port_grads(x, w, bn, g, getattr(torch, dtype))
    np.testing.assert_array_equal(nhwc(y), np.asarray(want, np.float32))
    assert 0.05 < float(y.detach().float().mean()) < 0.95
    got = [nhwc(pg[0])] + [p.numpy() for p in pg[1:]]
    for a, b in zip(got, jg):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=1e-5,
                                   atol=1e-5)


def test_train_plif_matches_jax_grad_of_bn_then_scan():
    """f32: the op against ``jax.grad`` of the BN normalize followed by the
    XLA ``plif_scan`` with the atan surrogate (autodiff through the scan,
    another association of the same chain rule): 1e-5."""
    x, w, bn, g = _plif_inputs(2, B=4, H=5, W=6)

    def loss(xx, ww, m, s, b):
        xn = (xx - m) * s + b
        sp, _ = j_plif_scan(xn.reshape((T, -1) + xn.shape[1:]), ww,
                            j_spike_fn("atan"))
        return (sp.reshape(xx.shape) * g).sum(), sp.reshape(xx.shape)

    (_, want), jg = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                       has_aux=True)(
        jnp.asarray(x), jnp.float32(w), *map(jnp.asarray, bn))
    y, pg = _port_grads(x, w, bn, g, torch.float32)
    np.testing.assert_array_equal(nhwc(y), np.asarray(want))
    got = [nhwc(pg[0])] + [p.numpy() for p in pg[1:]]
    for a, b in zip(got, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["atan", "rect", "sigmoid", "tanh"])
def test_train_plif_identity_bn_matches_jax_plain_kernel(exact_math, kind):
    """Kernel 6: the JAX backward without BN (``_bwd_kernel``) against the
    port's op with the identity BN terms, for every surrogate. dx and dw
    to 1e-5 relative (f32 sums in another order); dx also to 1e-6
    absolute, 5e-6 for sigmoid and tanh, whose transcendentals differ by
    an ulp between the frameworks and saturate."""
    x, w, _, g = _plif_inputs(3)
    C = x.shape[-1]

    def loss(xx, ww):
        y = j_plif_fused(xx, T, ww, spike_fn=kind, alpha=2.0, interpret=True)
        return (y * g).sum(), y

    (_, want), (jdx, jdw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.float32(w))
    ident = (np.zeros(C, np.float32), np.ones(C, np.float32),
             np.zeros(C, np.float32))
    y, pg = _port_grads(x, w, ident, g, torch.float32, kind=kind)
    np.testing.assert_array_equal(nhwc(y), np.asarray(want))
    atol = 1e-6 if kind in ("atan", "rect") else 5e-6
    np.testing.assert_allclose(nhwc(pg[0]), np.asarray(jdx), rtol=1e-5,
                               atol=atol)
    np.testing.assert_allclose(float(pg[1]), float(jdw), rtol=1e-5)


def test_plif_module_trains_through_the_op():
    """The PLIF module in train mode is the op on a = 1 - sigmoid(w), and
    its w takes the gradient."""
    x, w, bn, g = _plif_inputs(4, B=2)
    m = PLIF(T).train()
    with torch.no_grad():
        m.w.fill_(float(w))
    xt = nchw(x).requires_grad_()
    y = m(xt, bn=tuple(torch.from_numpy(p) for p in bn))
    (y * nchw(g)).sum().backward()
    _, pg = _port_grads(x, w, bn, g, torch.float32)
    assert torch.equal(xt.grad, pg[0]) and torch.equal(m.w.grad, pg[1])


# the flagship train step's spiking sites (gen1_syolox_m, B=64, T=3,
# bf16): (C, H, W)
TRAIN_SITES = [(96, 64, 80), (48, 64, 80), (192, 32, 40), (96, 32, 40),
               (384, 16, 20), (192, 16, 20), (768, 8, 10), (384, 8, 10)]


def _bwd_items(plan, B, C, HW):
    """Each item's first element within a step, and the channel of the
    block that owns it, by the index arithmetic of
    csrc/plif_bwd.cu:plif_bwd_kernel over the whole grid: block c * nb + j
    walks items j * chunk ... of channel c in steps of THREADS."""
    blk = np.arange(plan.grid, dtype=np.int64)
    c, j = blk // plan.nb, blk % plan.nb
    lo = j * plan.chunk
    hi = np.minimum(lo + plan.chunk, plan.per_c)
    cnt = np.maximum(hi - lo, 0)
    assert (cnt <= plan.ipt * pplif.THREADS).all()  # ipt items a thread
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    q = np.repeat(lo, cnt) + np.arange(cnt.sum()) - first
    ch = np.repeat(c, cnt)
    b = q // plan.ipp
    return (b * C + ch) * HW + (q - b * plan.ipp) * plan.E, ch


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("site", TRAIN_SITES + ["ragged_7x9",
                                                "unaligned_8x8"])
def test_plif_bwd_plan_covers_every_element_once(site, dtype):
    """The backward kernel's blocks cover each element of a step exactly
    once, in bounds, each inside its own channel (whose sums are the
    block's), at every flagship train geometry, where the grid also fills
    at least two waves of resident blocks; a ragged H*W or an x off
    16-byte alignment takes one-element items (the scalar tail)."""
    dt = getattr(torch, dtype)
    B, aligned = 64, True
    if isinstance(site, str):
        B, aligned = 3, site != "unaligned_8x8"
        C, (H, W) = 16, {"ragged_7x9": (7, 9), "unaligned_8x8": (8, 8)}[site]
    else:
        C, H, W = site
    HW = H * W
    plan = pplif.plif_bwd_plan(B, C, HW, dt, T, aligned)
    vec = 16 // torch.empty((), dtype=dt).element_size()
    assert plan.E == (1 if isinstance(site, str) else vec)
    n = B * C * HW
    off, ch = _bwd_items(plan, B, C, HW)
    assert off.min() >= 0 and off.max() + plan.E <= n
    np.testing.assert_array_equal(np.sort(off), np.arange(0, n, plan.E))
    np.testing.assert_array_equal(ch, (off // HW) % C)
    assert plan.grid == C * plan.nb and plan.scratch == 4 + 3 * plan.grid
    if not isinstance(site, str) and dtype == "bfloat16":
        assert plan.waves >= 2.0 and plan.ipt in (1, 2, 4, 8)


# --------------------------------------------------------------- train BN

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax(dtype):
    """BatchNorm in train mode against BatchNormFusable(train=True): the
    output, the updated running mean and (biased) variance, and the input,
    scale and bias gradients; 1e-5 in f32 (sums in another order), one
    bf16 ulp in bf16."""
    rng = np.random.default_rng(5)
    C = 8
    x = rng.normal(0.3, 1.2, (6, 4, 5, C)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x).astype(jdt)
    x = np.asarray(xj.astype(jnp.float32))
    bn = BatchNormFusable(momentum=0.97, epsilon=1e-3, dtype=jdt)
    v = jax.tree_util.tree_map(np.asarray, bn.init(jax.random.PRNGKey(0),
                                                   xj, True))
    v["params"]["scale"] = rng.uniform(0.5, 1.5, C).astype(np.float32)
    v["params"]["bias"] = rng.normal(0, 0.3, C).astype(np.float32)
    v["batch_stats"]["mean"] = rng.normal(0, 0.1, C).astype(np.float32)
    v["batch_stats"]["var"] = rng.uniform(0.5, 1.5, C).astype(np.float32)

    def loss(params, xx):
        y, upd = bn.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, xx, True,
                          mutable=["batch_stats"])
        return (y.astype(jnp.float32) * g).sum(), (y, upd)

    (_, (want, upd)), (jgp, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], xj)

    pb = BatchNorm(C).train()
    with torch.no_grad():
        pb.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        pb.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        pb.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        pb.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    xt = nchw(x).to(getattr(torch, dtype)).requires_grad_()
    y = pb(xt, xt.dtype)
    (y.float() * nchw(g)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(nhwc(y), np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jgx, np.float32),
                               **tol)
    for got, key in ((pb.running_mean, "mean"), (pb.running_var, "var")):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pb.weight.grad.numpy(),
                               np.asarray(jgp["scale"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pb.bias.grad.numpy(), np.asarray(jgp["bias"]),
                               rtol=1e-5, atol=1e-5)
    assert int(pb.num_batches_tracked) == 1


# --------------------------------------------------------- SimOTA, losses

def _head_geometry(H=64, W=64, strides=(8, 16, 32)):
    gx, gy, sv = [], [], []
    for s in strides:
        yy, xx = np.meshgrid(np.arange(H // s), np.arange(W // s),
                             indexing="ij")
        gx.append(xx.reshape(-1))
        gy.append(yy.reshape(-1))
        sv.append(np.full(xx.size, s))
    return (np.concatenate(gx).astype(np.float32),
            np.concatenate(gy).astype(np.float32),
            np.concatenate(sv).astype(np.float32))


def _loss_case(seed=0):
    """Two images at 64x64 (84 anchors), 2 classes, 6 label rows each:

    * image 0: a large gt whose 22 in-centre anchors outnumber its
      dynamic k; a gt given twice, whose two rows claim the same anchors
      with equal costs (the conflict's argmin gives every one to the
      first row); padded rows;
    * image 1: one gt whose in-centre anchors all carry the same
      prediction, so their costs tie exactly (all of them match, where a
      top-k would keep k), and padded rows.
    """
    rng = np.random.default_rng(seed)
    gx, gy, sv = _head_geometry()
    A = gx.size
    reg = rng.normal(0, 0.4, (2, A, 4)).astype(np.float32)
    logits = rng.normal(-1.0, 1.0, (2, A, 3)).astype(np.float32)
    labels = np.zeros((2, 6, 5), np.float32)
    labels[0, 0] = [1, 30, 30, 50, 44]
    labels[0, 1] = [0, 14, 14, 12, 10]
    labels[0, 2] = labels[0, 1]
    labels[1, 0] = [0, 40, 24, 20, 16]
    # image 1: identical predictions at every anchor in the gt's centre
    # region, boxes on the gt
    acx, acy = (gx + 0.5) * sv, (gy + 0.5) * sv
    near = (np.abs(acx - 40) < 1.5 * sv) & (np.abs(acy - 24) < 1.5 * sv)
    assert near.sum() > 3
    reg[1, near] = [0.1, 0.2, np.log(18.0), np.log(14.0)]
    reg[1, near, :2] = 0.0
    logits[1, near] = [0.3, 0.5, -0.2]
    xy = (reg[..., :2] + np.stack([gx, gy], -1)[None]) * sv[None, :, None]
    # the tied anchors: the same decoded box, whatever their cell
    xy[1, near] = [40.5, 23.5]
    wh = np.exp(reg[..., 2:]) * sv[None, :, None]
    wh[1, near] = [18.0, 14.0]
    xy[0, 9], wh[0, 9] = [15.0, 16.0], [13.0, 11.0]
    outputs = np.concatenate([xy, wh, logits], -1).astype(np.float32)
    return outputs, reg, labels, gx, gy, sv


def test_box_ops_match_jax():
    """cxcywh2xyxy, pairwise_iou and iou_loss: the same elementwise
    arithmetic, 1e-6."""
    rng = np.random.default_rng(3)
    a = np.concatenate([rng.uniform(0, 60, (7, 2)), rng.uniform(1, 30, (7, 2))],
                       1).astype(np.float32)
    b = np.concatenate([rng.uniform(0, 60, (9, 2)), rng.uniform(1, 30, (9, 2))],
                       1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(pboxes.cxcywh2xyxy(ta).numpy(),
                               np.asarray(jboxes.cxcywh2xyxy(a)), rtol=1e-6)
    want = np.asarray(jboxes.pairwise_iou(a, b))
    np.testing.assert_allclose(pboxes.pairwise_iou(ta, tb).numpy(), want,
                               rtol=1e-6, atol=1e-7)
    assert 0 < (want > 0).mean() < 1
    np.testing.assert_allclose(pboxes.iou_loss(ta, tb[:7]).numpy(),
                               np.asarray(jboxes.iou_loss(a, b[:7])),
                               rtol=1e-6, atol=1e-7)


def test_simota_assign_matches_jax():
    outputs, _, labels, gx, gy, sv = _loss_case()
    valid = labels.sum(2) > 0
    acx, acy = (gx + 0.5) * sv, (gy + 0.5) * sv
    jres = jax.vmap(lambda gb, gc, gv, pb, cl, ob: jsimota.simota_assign(
        gb, gc, gv, pb, cl, ob, acx, acy, sv, 2))(
        labels[..., 1:5], labels[..., 0], valid, outputs[..., :4],
        outputs[..., 5:], outputs[..., 4:5])
    t = torch.from_numpy
    pres = psimota.simota_assign(
        t(labels[..., 1:5]), t(labels[..., 0]), t(valid),
        t(outputs[..., :4]), t(outputs[..., 5:]), t(outputs[..., 4:5]),
        t(acx), t(acy), t(sv), 2)
    for name in ("fg_mask", "matched_gt", "num_fg", "num_gt"):
        np.testing.assert_array_equal(getattr(pres, name).numpy(),
                                      np.asarray(getattr(jres, name)), name)
    np.testing.assert_allclose(pres.pred_iou.numpy(),
                               np.asarray(jres.pred_iou), rtol=1e-6,
                               atol=1e-7)
    # the case is what it claims: the tie admits more anchors than any k
    # (k <= 10), the large gt keeps fewer anchors than it has in its
    # centre region, and the doubled gt's first row keeps every anchor
    # both rows claimed
    fg, gt = pres.fg_mask.numpy(), pres.matched_gt.numpy()
    assert fg[1].sum() > 10
    in_centre = ((np.abs(acx - 30) < 1.5 * sv)
                 & (np.abs(acy - 30) < 1.5 * sv)).sum()
    assert 0 < (fg[0] & (gt[0] == 0)).sum() < in_centre
    assert (fg[0] & (gt[0] == 1)).sum() > 0
    assert (fg[0] & (gt[0] == 2)).sum() == 0


@pytest.mark.parametrize("use_l1", [False, True])
def test_yolox_losses_and_gradients_match_jax(use_l1):
    """Each loss term and num_fg to 1e-6 relative, the gradients with
    respect to the outputs and the raw reg outputs to 1e-5 (f32 sums in
    another order)."""
    outputs, reg, labels, gx, gy, sv = _loss_case()

    def loss(o, r):
        out = jsimota.yolox_losses(o, r, jnp.asarray(labels), gx, gy, sv, 2,
                                   use_l1=use_l1)
        return out.total_loss, out

    (_, jout), (jgo, jgr) = jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True)(outputs, reg)
    o = torch.from_numpy(outputs).requires_grad_()
    r = torch.from_numpy(reg).requires_grad_()
    t = torch.from_numpy
    pout = psimota.yolox_losses(o, r, t(labels), t(gx), t(gy), t(sv), 2,
                                use_l1=use_l1)
    pout.total_loss.backward()
    for name in psimota.LossOutput._fields:
        np.testing.assert_allclose(float(getattr(pout, name).detach()),
                                   float(getattr(jout, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert (float(pout.l1_loss.detach()) > 0) == use_l1
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jgo), rtol=1e-5,
                               atol=1e-6)
    if use_l1:
        np.testing.assert_allclose(r.grad.numpy(), np.asarray(jgr),
                                   rtol=1e-5, atol=1e-6)
    else:
        assert r.grad is None and not np.asarray(jgr).any()
    assert np.abs(np.asarray(jgo)[..., :4]).max() > 0


# ------------------------------------------------- schedules, optimizer

_SCHEDULES = [
    ("fixed", {}),
    ("cos", {}),
    ("warmcos", dict(warmup_epochs=2, warmup_lr_start=1e-4)),
    ("yoloxwarmcos", dict(warmup_epochs=2, no_aug_epochs=3,
                          min_lr_ratio=0.05)),
    ("yoloxsemiwarmcos", dict(warmup_epochs=1, no_aug_epochs=2,
                              semi_epoch=4, iters_per_epoch_semi=7)),
    ("multistep", dict(milestones=(3, 7), gamma=0.1)),
]


@pytest.mark.parametrize("name,kw", _SCHEDULES, ids=[s for s, _ in
                                                     _SCHEDULES])
def test_lr_schedules_match_jax(name, kw):
    """The port's schedules run in double, the JAX ones in f32: 1e-6
    relative, 1e-6 of the base lr absolute (cos ends at 0)."""
    args = (name, 0.01, 10, 12)
    js, ps = joptim.build_lr_schedule(*args, **kw), \
        poptim.build_lr_schedule(*args, **kw)
    steps = list(range(0, 121, 3)) + [19, 20, 21, 89, 90, 91, 119, 120]
    want = [float(js(s)) for s in steps]
    got = [ps(s) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
    assert len(set(np.round(want, 8))) > (1 if name != "fixed" else 0)


class _Tiny(torch.nn.Module):
    """A small tree with every group: embedding convs, a conv kernel and
    bias (head-pred style), a BN and a PLIF decay."""

    def __init__(self):
        super().__init__()
        self.embedding = torch.nn.Sequential(torch.nn.Conv2d(2, 4, 3))
        self.conv = torch.nn.Conv2d(4, 6, 1)
        self.bn = BatchNorm(6)
        self.act = PLIF(T)


def _tiny_jax_params(m):
    def np_(t):
        return t.detach().numpy().copy()

    return {
        "embedding": {"input_conv_kernel0": np_(m.embedding[0].weight),
                      "input_conv_bias0": np_(m.embedding[0].bias)},
        "conv": {"kernel": np_(m.conv.weight), "bias": np_(m.conv.bias)},
        "bn": {"scale": np_(m.bn.weight), "bias": np_(m.bn.bias)},
        "PLIF_0": {"w": np_(m.act.w)},
    }


_TINY_KEYS = {"embedding.0.weight": ("embedding", "input_conv_kernel0"),
              "embedding.0.bias": ("embedding", "input_conv_bias0"),
              "conv.weight": ("conv", "kernel"), "conv.bias": ("conv", "bias"),
              "bn.weight": ("bn", "scale"), "bn.bias": ("bn", "bias"),
              "act.w": ("PLIF_0", "w")}


@pytest.mark.parametrize("opt_name", ["ADAM", "SGD"])
def test_optimizer_groups_match_optax(opt_name):
    """Three updates with weight decay and emb_lr against the JAX
    package's ``optax.multi_transform``: decay on the conv kernel only,
    the embedding at emb_lr / base_lr, the lr of update t schedule(t).
    1e-5 relative: torch and optax order Adam's arithmetic differently."""
    torch.manual_seed(0)
    m = _Tiny()
    with torch.no_grad():
        m.act.w.fill_(0.3)
        m.bn.weight.uniform_(0.5, 1.5)
    base_lr = 1e-2
    kw = dict(warmup_epochs=1, min_lr_ratio=0.05)
    sched = ("yoloxwarmcos", base_lr, 2, 3)
    jparams = _tiny_jax_params(m)
    tx = joptim.build_optimizer(
        jparams, joptim.build_lr_schedule(*sched, **kw), optimizer=opt_name,
        weight_decay=5e-2, momentum=0.9, emb_lr=3e-3, base_lr=base_lr)
    state = tx.init(jparams)
    opt = poptim.build_optimizer(
        m, poptim.build_lr_schedule(*sched, **kw), optimizer=opt_name,
        weight_decay=5e-2, momentum=0.9, emb_lr=3e-3, base_lr=base_lr)
    assert [g["lr_scale"] for g in opt.param_groups] == [1.0, 1.0, 0.3]
    assert [len(g["params"]) for g in opt.param_groups] == [1, 4, 2]
    rng = np.random.default_rng(1)
    for step in range(3):
        grads = {n: rng.normal(size=p.shape).astype(np.float32)
                 for n, p in m.named_parameters()}
        jg = jax.tree_util.tree_map(np.zeros_like, jparams)
        for n, gv in grads.items():
            a, b = _TINY_KEYS[n]
            jg[a][b] = gv
        upd, state = tx.update(jg, state, jparams)
        jparams = jax.tree_util.tree_map(np.asarray,
                                         optax.apply_updates(jparams, upd))
        for n, p in m.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        optimizer_update(m, opt, None)
        assert poptim.updates(opt) == step + 1
        for n, p in m.named_parameters():
            a, b = _TINY_KEYS[n]
            np.testing.assert_allclose(p.detach().numpy(), jparams[a][b],
                                       rtol=1e-5, atol=1e-7, err_msg=n)


def test_ema_update_matches_jax():
    torch.manual_seed(1)
    m = _Tiny()
    ema = init_ema(m)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn_like(p))
    je = {n: e.numpy().copy() for n, e in ema.items()}
    for step in (1, 7, 2000, 100000):
        je = j_ema_update(je, {n: p.detach().numpy()
                               for n, p in m.named_parameters()},
                          jnp.asarray(step))
        ema_update(ema, m, step)
        for n in ema:
            np.testing.assert_allclose(ema[n].numpy(), np.asarray(je[n]),
                                       rtol=1e-6, atol=1e-7)
