"""The dense conv kernels' dispatch (`conv_plan`, ops/kernels/conv.py) and
the ctypes signatures of the kernel library, on the CPU.

`conv_plan` maps dtype and shape to the main loop that runs a conv on the
card: bf16 on the tensor cores (csrc/conv_wgmma.cu), fp32 on the CUDA cores
(csrc/conv_fused.cu). The card's kernels cannot run here; chip_smoke.py
holds each plan against the plain version there. These tests walk every
dense conv of the four families at 224² (module shapes only, no weights)
and check the plan each one gets, and check `_SIGNATURES` against the
`extern "C"` entry points of csrc/*.cu, where a pointer passed as an int
would be cut to 32 bits on the card.
"""

import ctypes
import glob
import os
import re

import pytest
import torch

import chip_smoke
from convnets_tpu_torch import nn
from convnets_tpu_torch.core.precision import policy_from_setting
from convnets_tpu_torch.core.shapes import conv_out_size
from convnets_tpu_torch.models import base
from convnets_tpu_torch.ops import kernels
from test_torch_kernels import CONV_CASES

FAMILIES = ["resnet", "mobilenet_v1", "densenet", "resnext"]


def _dense_convs(arch):
    """(H, W, Cin, Cout, k, stride, pad) of every dense conv (ConvBNReLU or
    Conv2d, groups 1) of the family at 224², from its unbuilt modules."""
    setting = chip_smoke.model_setting(arch, 0, True)
    with nn.use_policy(policy_from_setting(setting)):
        model = base._REGISTRY[arch](setting)
    return [(h, w, cin, cout, k, s, p) for kind, h, w, cin, cout, k, s, p, _, g
            in chip_smoke.model_layers(model) if kind in ("conv", "plainconv") and g == 1]


def _check_plan(m, cin, cout):
    bf = kernels.conv_plan(torch.bfloat16, m, cin, cout)
    assert (bf.route, bf.bm) == ("wgmma", 128)
    assert bf.bn in (32, 64, 128)
    assert (bf.bn == 32) == (cout <= 32)
    assert bf.bn == 32 or 2 * cout > bf.bn  # no tile more than half empty
    assert bf.gather == ("vector" if cin % 8 == 0 else "scalar")
    assert bf.partial_rows(m) == -(-m // 128)
    assert bf.args() == (1, 128, bf.bn, int(cin % 8 == 0))
    fp = kernels.conv_plan(torch.float32, m, cin, cout)
    assert fp == kernels.ConvPlan("simt", 128, 64, "scalar")
    assert fp.args() == (0, 128, 64, 0)
    assert fp.partial_rows(m) == -(-m // 128)


@pytest.mark.parametrize("batch", [1, 8, 256])
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_dense_conv_has_a_tensor_core_plan(arch, batch):
    convs = _dense_convs(arch)
    # one conv2d_fused launch per dense conv of a served forward
    assert len(convs) == chip_smoke.SERVE_LAUNCHES[arch]["conv2d_fused"]
    for h, w, cin, cout, k, s, p in convs:
        assert kernels.fits_conv(s, 1, 1)
        _check_plan(batch * conv_out_size(h, k, s, p) * conv_out_size(w, k, s, p), cin, cout)


def test_plans_of_the_families_cover_every_branch():
    """Across the four families the bf16 plans reach every tile width and
    both gathers; the 3-channel stems take the scalar gather."""
    seen = set()
    for arch in FAMILIES:
        for batch in (8, 256):
            for h, w, cin, cout, k, s, p in _dense_convs(arch):
                m = batch * conv_out_size(h, k, s, p) * conv_out_size(w, k, s, p)
                plan = kernels.conv_plan(torch.bfloat16, m, cin, cout)
                seen.add((plan.bn, plan.gather))
                if cin == 3:
                    assert plan.gather == "scalar"
    assert {bn for bn, _ in seen} == {32, 64, 128}
    assert {g for _, g in seen} == {"vector", "scalar"}


@pytest.mark.parametrize("batch", [64, 256])
def test_rn26_at_32_has_a_tensor_core_plan_at_every_conv(batch):
    """chip_smoke.py phase 10's model, RN26@32 (the Trainer's CINIC-shaped
    fit at b256; its fp32 check at b64): the plans were chosen for 224²,
    and the last stage runs at 2² → 1², where M = N·H·W is the batch."""
    setting = chip_smoke.trainer_setting(0, "")
    with nn.use_policy(policy_from_setting(setting)):
        model = base._REGISTRY["resnet"](setting)
    convs = [(h, w, cin, cout, k, s, p) for kind, h, w, cin, cout, k, s, p, _, g
             in chip_smoke.model_layers(model) if kind == "conv" and g == 1]
    assert len(convs) == chip_smoke.conv_count(model) == 29  # stem, 8 × 3, 4 shortcuts
    ms = set()
    for h, w, cin, cout, k, s, p in convs:
        assert kernels.fits_conv(s, 1, 1)
        m = batch * conv_out_size(h, k, s, p) * conv_out_size(w, k, s, p)
        ms.add(m)
        _check_plan(m, cin, cout)
    assert min(ms) == batch and max(ms) == batch * 16 * 16


@pytest.mark.parametrize("stride,padding,k,cin", CONV_CASES)
def test_plan_of_the_kernel_test_shapes(stride, padding, k, cin):
    n, hw, cout = 2, 16, 16  # test_torch_kernels.py's _conv_inputs
    oh = conv_out_size(hw, k, stride, padding)
    _check_plan(n * oh * oh, cin, cout)


@pytest.mark.parametrize("m,cin,cout,bn", [
    (392, 512, 2048, 64),      # N=8 7×7: 4 × 16 tiles of 128 would idle SMs
    (200704, 1024, 256, 128),  # b256 14²
    (25088, 64, 64, 64),       # Cout 64
    (6272, 128, 32, 32),       # DN121 growth conv
    (98, 64, 24, 32),          # Cout 24: one ragged 32-wide tile
])
def test_plan_tile_width(m, cin, cout, bn):
    assert kernels.conv_plan(torch.bfloat16, m, cin, cout).bn == bn


def test_plan_gather_and_dtypes():
    # a misaligned input takes the scalar gather; other dtypes have no plan
    assert kernels.conv_plan(torch.bfloat16, 128, 64, 64, aligned=False).gather == "scalar"
    with pytest.raises(TypeError):
        kernels.conv_plan(torch.float16, 128, 64, 64)


def _entry_points():
    """{name: [argument declarations]} of every extern "C" int function in
    convnets_tpu_torch/csrc/*.cu."""
    found = {}
    for path in sorted(glob.glob(os.path.join(kernels.CSRC_DIR, "*.cu"))):
        with open(path) as f:
            src = f.read()
        for name, args in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', src):
            assert name not in found, f"{name} defined twice"
            found[name] = [a.strip() for a in args.split(",") if a.strip()]
    return found


def test_signatures_name_every_entry_point():
    assert set(_entry_points()) == set(kernels._SIGNATURES)


@pytest.mark.parametrize("name", sorted(kernels._SIGNATURES))
def test_signature_matches_source(name):
    decls = _entry_points()[name]
    want = kernels._SIGNATURES[name]
    assert len(decls) == len(want), f"{name}: {len(decls)} arguments in the source"
    for i, (decl, argtype) in enumerate(zip(decls, want)):
        if "*" in decl:
            assert argtype is ctypes.c_void_p, f"{name} argument {i} ({decl}) is a pointer"
        else:
            assert re.fullmatch(r"int\s+\w+", decl), f"{name} argument {i}: {decl}"
            assert argtype is ctypes.c_int, f"{name} argument {i} ({decl}) is an int"
