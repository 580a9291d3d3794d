"""Each per-layer reader on a synthetic slice, and the union of busy spans."""

import json
import os

import pytest

import readers
import run
import slices
import work


def cfg(name="resnet50-224"):
    with open(os.path.join(work.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def reader(name):
    return run.load_module(os.path.join(work.HERE, "layer_metrics", name + ".py"),
                           "m_" + name.replace(".", "_"))


def test_union_of_overlaps():
    assert slices.union_us([(0, 10), (5, 15), (20, 30), (25, 26)]) == 25
    assert slices.union_us([]) == 0
    assert slices.union_us([(3, 4), (0, 10)]) == 10


CONV = "void conv_wgmma_kernel<128, true, false, 1>(Args)"
RED = "void stats_reduce_kernel<4, 8>(float const*, float*, int, int)"
BNS = "void bn_act_sums_kernel<__nv_bfloat16, true, 8>(...)"
CUDNN = "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64"
ADD = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"
H2D = "Memcpy HtoD (Pageable -> Device)"


def synthetic(steps=2):
    dev = [(CONV, 0, 10, "kernel"), (RED, 10, 11, "kernel"), (BNS, 12, 14, "kernel"),
           (RED, 14, 15, "kernel"), (CUDNN, 15, 25, "kernel"), (ADD, 20, 30, "kernel"),
           (H2D, 40, 50, "memcpy")]
    host = [("train_epoch", 0, 100), ("cudaStreamSynchronize", 30, 40)]
    return slices.Slice(device=dev, host=host, window_us=100.0, steps=steps, images=512)


def ctx():
    return {"cfg": cfg(), "peaks": work.load_peaks(), "batch": 256}


def test_idle_share():
    sl = synthetic()
    # busy: [0, 11), [12, 30) and [40, 50) -> 39 of 100 us
    assert reader("idle_share.train").read(sl, ctx()) == pytest.approx(61.0)
    assert reader("idle_share.serve").read(sl, ctx()) == pytest.approx(61.0)


def test_conv_time_counts_only_the_convs_reductions():
    sl = synthetic()
    # the reduction after the conv counts, the one after the BN sums does not
    assert readers.conv_us(sl, True) == 11
    assert readers.conv_us(sl, False) == 10
    bound = 1e6 * sum(work.conv_bounds_s(cfg(), 256, work.load_peaks()).values())
    assert reader("conv_roofline.train").read(sl, ctx()) == pytest.approx(100 * 2 * bound / 11)
    assert reader("conv_roofline.serve").read(sl, ctx()) == pytest.approx(100 * 2 * bound / 10)


def test_groups_per_step():
    sl = synthetic()
    # eager: the add alone (10 us over 2 steps)
    assert reader("eager_ms.train").read(sl, ctx()) == pytest.approx(0.005)
    assert reader("cudnn_ms.train").read(sl, ctx()) == pytest.approx(0.005)
    assert reader("launches.train").read(sl, ctx()) == 3
    assert reader("h2d_ms.serve").read(sl, ctx()) == pytest.approx(0.005)


def test_mfu():
    sl = synthetic()
    c, peaks = cfg(), work.load_peaks()
    want = 100 * 512 * 3 * work.forward_flops_per_image(c) / (100e-6 * peaks["bf16_flops_per_s"])
    assert reader("mfu.train").read(sl, ctx()) == pytest.approx(want)
    assert reader("mfu.serve").read(sl, ctx()) == pytest.approx(want / 3)


def test_nothing_to_read_gives_nothing():
    empty = slices.Slice(device=[], host=[], window_us=100.0, steps=2, images=512)
    for name in ("idle_share.train", "conv_roofline.train", "conv_roofline.serve",
                 "eager_ms.train", "cudnn_ms.train", "launches.train", "h2d_ms.serve"):
        assert reader(name).read(empty, ctx()) is None, name


def test_breakdown_names_the_host():
    b = slices.breakdown(synthetic())
    assert b["device_ops"][0][0] in (CUDNN, ADD, CONV)
    labels = dict(b["idle_gaps"])
    # the gap [30, 40) falls in the synchronize; [11, 12) and [50, 100) only in the epoch
    assert labels["cudaStreamSynchronize"] == pytest.approx(10e-6)
    assert labels["train_epoch"] == pytest.approx(51e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
