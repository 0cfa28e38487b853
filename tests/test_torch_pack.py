"""The space-to-depth packing of the port (``eas_snn_tpu_torch/ops/
pack.py``) and its packed sampler route against the JAX package's
(``eas_snn_tpu/ops/pack.py``, ``ARSNNEmbedding(packed='auto')``), on the
CPU: each pack function bit for bit on numpy inputs from a seed, the
packed conv equal to the unpacked stencil (the pattern of
``tests/test_pack.py``), the packed scan forward and gradients in f64
(where summation order cannot flip a threshold, as ``tests/test_pack.py``
holds JAX's to its own), the routing, the exp field, and a whole small
detector with ``packed_embedding='auto'`` against JAX's in f32, eval and
one train step, with the tolerances of ``tests/test_torch_variants_
model.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from eas_snn_tpu.models.embedding import ARSNNEmbedding as JARSNNEmbedding
from eas_snn_tpu.ops import pack as jpack

from eas_snn_tpu_torch.exp import get_exp
from eas_snn_tpu_torch.exp.build import get_exp_by_file
from eas_snn_tpu_torch.models import ARSNNEmbedding
from eas_snn_tpu_torch.models import embedding as pemb
from eas_snn_tpu_torch.ops import pack
from eas_snn_tpu_torch.utils import state_dict_from_jax

from test_torch_variants_model import _check_eval, check_train, pair

GEOMETRIES = [(5, 2, 4, 8), (3, 4, 4, 4), (7, 2, 2, 8), (5, 2, 4, 4),
              (5, 2, 4, 2), (3, 2, 4, 2)]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _oihw(hwio):
    return np.ascontiguousarray(np.asarray(hwio).transpose(3, 2, 0, 1))


# --------------------------------------------------------------- functions

@pytest.mark.parametrize("block", [2, 4, 8])
def test_space_depth_equal_jax(block):
    """``space_to_depth`` and ``depth_to_space`` on (Tm, N, C, H, W)
    against JAX's on the (Tm, N, H, W, C) transpose, bit for bit, and the
    round trip."""
    x = np.random.default_rng(block).normal(
        size=(2, 3, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jpack.space_to_depth(jnp.asarray(x), block))
    got = pack.space_to_depth(torch.from_numpy(x).permute(0, 1, 4, 2, 3),
                              block)
    assert got.shape == (2, 3, 3 * block * block, 16 // block, 24 // block)
    np.testing.assert_array_equal(got.permute(0, 1, 3, 4, 2).numpy(), want)
    back = pack.depth_to_space(got, block, 3)
    np.testing.assert_array_equal(back.permute(0, 1, 3, 4, 2).numpy(), x)
    np.testing.assert_array_equal(
        back.permute(0, 1, 3, 4, 2).numpy(),
        np.asarray(jpack.depth_to_space(jnp.asarray(want), block, 3)))


@pytest.mark.parametrize("ksize,ci,co,block", GEOMETRIES)
def test_pack_conv_kernel_and_bias_equal_jax(ksize, ci, co, block):
    """The packed (b*b*co, b*b*ci, 3, 3) weights equal the transpose of
    JAX's (3, 3, b*b*ci, b*b*co), bit for bit; the bias likewise."""
    rng = np.random.default_rng(ksize * 100 + block)
    k = rng.normal(size=(ksize, ksize, ci, co)).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    want = _oihw(jpack.pack_conv_kernel(jnp.asarray(k), block))
    got = pack.pack_conv_kernel(torch.from_numpy(_oihw(k)), block)
    assert got.shape == (block * block * co, block * block * ci, 3, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pack.pack_bias(torch.from_numpy(b), block).numpy(),
        np.asarray(jpack.pack_bias(jnp.asarray(b), block)))


@pytest.mark.parametrize("ksize,ci,co,block", GEOMETRIES)
def test_packed_conv_equals_the_stencil(ksize, ci, co, block):
    """A 3x3 conv of the packed weights over the packed input, unpacked,
    is the k x k stencil (zero padding included), in f64; the weight
    transform's gradient sums each tap's routes."""
    rng = np.random.default_rng(0)
    H, W = 2 * block, 3 * block
    x = torch.from_numpy(rng.normal(size=(2, ci, H, W)))
    k = torch.from_numpy(rng.normal(size=(co, ci, ksize, ksize)) * 0.3)
    b = torch.from_numpy(rng.normal(size=(co,)) * 0.1)
    k.requires_grad_(True)
    ref = F.conv2d(x, k, b, padding=ksize // 2)
    out = pack.depth_to_space(F.conv2d(
        pack.space_to_depth(x, block), pack.pack_conv_kernel(k, block),
        pack.pack_bias(b, block), padding=1), block, co)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-10, atol=1e-10)
    g = torch.from_numpy(rng.normal(size=ref.shape))
    (gr,) = torch.autograd.grad((ref * g).sum(), k)
    (gp,) = torch.autograd.grad((out * g).sum(), k)
    np.testing.assert_allclose(gp.numpy(), gr.numpy(), rtol=1e-9, atol=1e-9)


def test_packable_gate():
    assert pack.packable(256, 320, 5, 4) and pack.packable(256, 320, 5, 8)
    assert not pack.packable(250, 320, 5, 8)
    assert not pack.packable(256, 320, 21, 8)  # k // 2 > b
    assert all(pack.packable(256, 320, k, b) == jpack.packable(256, 320, k, b)
               for k in (3, 5, 7, 9) for b in (1, 2, 4, 8))


# ------------------------------------------------------------- the route

EMB_KW = dict(ksize=5, depth=2, Ts=3, readout="sum", spike_attach=True,
              write_zero=True, thresh=1.0, vreset=None)


@pytest.mark.parametrize("block", [4, 8])
def test_packed_scan_matches_jax_x64(block):
    """``ARSNNEmbedding(packed='auto')`` against JAX's with the same
    weights, in f64 (JAX under ``jax.enable_x64``): the slots within
    1e-8 and the gradients of every conv weight and bias within 1e-7 of
    JAX's packed route (``tests/test_pack.py``'s bounds, JAX's packed
    route against its own unpacked one)."""
    ev = np.random.default_rng(3).poisson(
        0.3, size=(2, 1, 4, 16, 24, 2)).astype(np.float64)
    mix = np.random.default_rng(4).normal(size=(3, 2, 16, 24, 2))
    with jax.enable_x64(True):
        je = JARSNNEmbedding(packed="auto", packed_block=block, **EMB_KW)
        x = jnp.asarray(ev)
        # f32 values (the port's weights bridge carries f32) held in f64
        v = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64),
            je.init(jax.random.PRNGKey(0), x))
        want = np.asarray(je.apply(v, x))
        jg = jax.grad(lambda p: (je.apply({"params": p}, x)
                                 * jnp.asarray(mix)).sum())(v["params"])
        jg = jax.tree_util.tree_map(np.asarray, jg)
    pe = ARSNNEmbedding(packed="auto", packed_block=block,
                        **EMB_KW).double()
    sd = state_dict_from_jax({"params": {"embedding": jax.tree_util.tree_map(
        np.asarray, v["params"])}})
    pe.load_state_dict({k[len("embedding."):]: t.double()
                        for k, t in sd.items()}, strict=True)
    ev_t = torch.from_numpy(ev)
    assert pe.route(pemb.fold_time(ev_t).permute(0, 1, 4, 2, 3)) == "packed"
    got = pe(ev_t)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().permute(0, 1, 3, 4, 2).numpy(),
                               want, rtol=1e-8, atol=1e-8)
    assert all((want[s] != 0).mean() > 0.01 for s in range(3))
    (got * torch.from_numpy(mix).permute(0, 1, 4, 2, 3)).sum().backward()
    gsd = state_dict_from_jax({"params": {"embedding": jg}})
    params = dict(pe.named_parameters())
    assert len(params) == len(gsd) == 8
    for name, g in gsd.items():
        p = params[name[len("embedding."):]]
        assert float(p.grad.abs().max()) > 0, name
        np.testing.assert_allclose(p.grad.numpy(), g.double().numpy(),
                                   rtol=1e-7, atol=1e-8, err_msg=name)


def test_packed_route_order_and_fallback():
    """Packed first where 'auto' and the frame packs (before the fused
    sampler, as in JAX ``embedding.py:329-344``); then the fused routes;
    a frame that does not pack (10 % 4) takes the next route and equals
    the module without packing."""
    pe = ARSNNEmbedding(packed="auto", fused_sampler="always", **EMB_KW)
    pe.eval()

    def ev(h, w):
        return torch.zeros((4, 1, 2, h, w))

    assert pe.route(ev(16, 24)) == "packed"
    assert pe.route(ev(10, 12)) == "v2"
    pe.packed = "never"
    assert pe.route(ev(16, 24)) == "v2"
    with pytest.raises(ValueError, match="packed"):
        ARSNNEmbedding(packed="always")
    x = torch.from_numpy(np.random.default_rng(5).poisson(
        0.3, size=(1, 1, 3, 10, 12, 2)).astype(np.float32))
    a = ARSNNEmbedding(packed="auto", ksize=5, depth=1, Ts=2)
    a.reset_parameters(torch.Generator().manual_seed(0))
    b = ARSNNEmbedding(ksize=5, depth=1, Ts=2)
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        assert torch.equal(a(x), b(x))


def test_packed_embedding_field_and_exp_file(tmp_path):
    """``packed_embedding`` defaults to 'never' (as JAX's), ``deploy()``
    keeps it, the ``key value`` override and an exp file's
    ``self.packed_embedding`` reach the embedding."""
    exp = get_exp("gen1_syolox_m")
    assert exp.packed_embedding == "never"
    assert exp.deploy().packed_embedding == "never"
    exp.merge(["packed_embedding", "auto", "width", "0.125"])
    assert exp.get_model(device="cpu").embedding.packed == "auto"
    path = tmp_path / "packed_exp.py"
    path.write_text(
        "from eas_snn_tpu_torch.exp import EventExp\n\n\n"
        "class Exp(EventExp):\n"
        "    def __init__(self):\n"
        "        super().__init__()\n"
        "        self.width = 0.125\n"
        "        self.embedding = 'arsnn'\n"
        "        self.packed_embedding = 'auto'\n")
    m = get_exp_by_file(str(path)).get_model(device="cpu")
    assert m.embedding.packed == "auto" and m.embedding.packed_block == 4


# -------------------------------------------------------- whole detector

@pytest.mark.parametrize("mode", ["none", "backbone"])
def test_packed_detector_eval_matches_jax(mode):
    """The small detector (64x64, arsnn 5x5 depth 2) with
    ``packed_embedding='auto'`` on both sides: eval outputs within rtol
    1e-5, atol 1e-4 (``_check_eval``)."""
    jm, pm, v, ev, _ = pair(mode, "arsnn", 60 + (mode == "backbone"),
                            packed_embedding="auto")
    assert pm.embedding.packed == "auto"
    _check_eval(jm, pm, v, ev)


def test_packed_detector_train_step_matches_jax():
    """One train step of the analog small detector with the packed
    sampler: loss terms within 1e-5 and every gradient within 1e-3 of its
    largest magnitude (``check_train``); the sampler's weights get
    theirs through the packed weights' gather."""
    jm, pm, v, ev, lab = pair("none", "arsnn", 62, packed_embedding="auto")
    params = check_train("none", jm, pm, v, ev, lab)
    for name in ("embedding.input_conv.0.weight",
                 "embedding.gate_conv.2.weight"):
        assert float(params[name].grad.abs().max()) > 0, name

