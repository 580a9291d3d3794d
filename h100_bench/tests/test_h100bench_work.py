"""The work arithmetic: FLOPs of both configurations and a conv's bound."""

import json
import os

import pytest

import work

CONFIGS = os.path.join(work.HERE, "configs")


def cfg(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,gflop", [("resnet50-224", 8.174), ("resnext50_32x4d_flathead-224", 8.457)])
def test_conv_flops_per_image(name, gflop):
    got = work.conv_flops_per_image(cfg(name)) / 1e9
    assert abs(got - gflop) / gflop < 0.01


def test_heads():
    assert work.head_flops_per_image(cfg("resnet50-224")) == 2 * 2048 * 1000
    # the flatten head reads the whole 7x7x2048 map
    assert work.head_flops_per_image(cfg("resnext50_32x4d_flathead-224")) == 2 * 7 * 7 * 2048 * 1000
    assert work.train_flops_per_image(cfg("resnet50-224")) == \
        3 * work.forward_flops_per_image(cfg("resnet50-224"))


def test_conv_count_and_shapes():
    convs = work.convs(cfg("resnet50-224"))
    assert len(convs) == 53
    assert convs[0].out_hw == (112, 112)
    assert convs[-1].out_hw == (7, 7) and convs[-1].cout == 2048
    grouped = [c for c in work.convs(cfg("resnext50_32x4d_flathead-224")) if c.groups > 1]
    assert len(grouped) == 16 and all(c.groups == 32 for c in grouped)


def test_one_bound_by_hand():
    peaks = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
    c = work.Conv("x", 56, 56, 64, 64, 3, 1, 1)
    n = 256
    flops = 2 * n * 56 * 56 * 64 * 64 * 9
    nbytes = 2 * (n * 56 * 56 * 64 + 9 * 64 * 64 + n * 56 * 56 * 64)
    assert c.flops(n) == flops and c.bytes(n) == nbytes
    assert c.bound_s(n, peaks) == pytest.approx(max(nbytes / 3.35e12, flops / 989e12))
    # memory-bound at this shape: 205.5 MB over 3.35 TB/s is 61.4 us, 59.2 GFLOP 59.8 us
    assert c.bound_s(n, peaks) == pytest.approx(nbytes / 3.35e12)


def test_rn50_bound_sum():
    peaks = work.load_peaks()
    total = sum(work.conv_bounds_s(cfg("resnet50-224"), 256, peaks).values())
    assert total == pytest.approx(3.859e-3, rel=1e-3)
