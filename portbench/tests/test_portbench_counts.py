"""The frozen FLOP and byte arithmetic against hand-worked shapes and
the bound column of PERF.md's kernel table."""

import pytest

from counts import shapes

GEN1 = dict(input_size=[256, 320], use_spike=True, T=3, depth=0.67,
            width=0.75, embedding="arsnn", embedding_ksize=5,
            embedding_depth=2, Tm=4, Tl=1, Ts=3, num_classes=2,
            dtype="bfloat16", sampler_dtype="float32")
EYOLOX = dict(GEN1, use_spike=False, embedding="count",
              input_size=[640, 640], num_classes=100, dtype="float32")


def test_conv_macs_by_hand():
    c = shapes.Conv("x", (48,), 96, 3, 2, 128, 160, 3, True, False)
    assert c.out_hw == (64, 80)
    assert c.macs() == 3 * 64 * 80 * 96 * 48 * 9
    assert c.out_elems() == 3 * 96 * 64 * 80


def test_flagship_sites_and_the_policy():
    sites = shapes.sites(GEN1)
    assert len(sites) == 50
    fused = [c for c in sites if shapes.fused(c)]
    assert len(fused) == 15
    assert sum(c.k == 1 for c in fused) == 8
    assert sum(c.k == 3 and c.stride == 1 for c in fused) == 6
    assert sum(c.stride == 2 for c in fused) == 1


def test_bounds_match_the_kernel_table():
    # PERF.md section 6, bound column: rows 7 and 8 a step at B=64, rows
    # 1-5 a forward at B=128
    row78 = shapes.plif_train_bound_ms(GEN1, 64)
    assert row78 == pytest.approx(1.4156 + 2.1235, abs=2e-4)
    ev = shapes.eval_sites_bound_ms(GEN1, 128)
    assert ev["plif_fwd_kernel"] == pytest.approx(1.1726, abs=1e-4)
    assert ev["conv_wgmma_kernel"] == pytest.approx(0.46 + 0.52 + 0.2817,
                                                    abs=2e-4)
    assert ev["arsnn_v2_kernel"] == pytest.approx(1.3397, abs=1e-4)


def test_bound_ms_by_hand():
    ms, by = shapes.bound_ms(3.35e9, 0.0, 0.0)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = shapes.bound_ms(0.0, 989e9, 67e9)
    assert ms == pytest.approx(2.0) and by == "operations"


def test_model_flops():
    # YOLOX-M at 640x640: ~73 GFLOP a forward (2 a multiply-add)
    f = shapes.forward_flops(EYOLOX, 1)
    assert set(f) == {"float32"}
    assert 70e9 < f["float32"] < 76e9
    t = shapes.train_flops(EYOLOX, 32)
    assert t["float32"] == pytest.approx(3 * 32 * f["float32"])
    g = shapes.forward_flops(GEN1, 1)
    # the sampler: 4 micro-steps of two 2-layer 5x5 stacks (2->4, 4->4)
    px = 256 * 320
    assert g["float32"] == 2 * 4 * 2 * px * 25 * (2 * 4 + 4 * 4)
    assert shapes.peak_seconds({"bfloat16": 989e12, "float32": 67e12}) \
        == pytest.approx(2.0)
