"""The reference against the port, fp32 on the CPU, batch 2: the served
logits at 32x32 (folded BN in the port, the plain formula in the
reference) and the first train steps at 64x64 (dropout masks and rows
worked out by the benchmark), for both configurations at their widths and
depths. The train step runs at 64x64 because at 32x32 the last stage's
map is 1x1, so its train-mode BN normalizes over the batch's two values
and rounding alone moves the loss by a percent."""

import copy

import pytest
import torch

import run
from reference import resnet as ref

BENCH = run.benchmark()


def small_spec(cell, side=32, **traffic):
    spec = copy.deepcopy(run.cell_spec(BENCH, cell))
    spec["cfg"]["input_size"] = [3, side, side]
    spec["cfg"]["precision"]["compute"] = "float32"
    spec["traffic"].update(traffic)
    return spec


def mix_for(spec, seed):
    ctx = {"cfg": spec["cfg"], "traffic": spec["traffic"], "seed": seed, "device": "cpu",
           "peaks": {}, "batch": int(spec["traffic"]["batch"])}
    return run.load_module(spec["mix_path"], "mix_" + spec["traffic"]["mix"]).Mix(ctx)


@pytest.mark.parametrize("cell", ["rn50-serve-b256"])
def test_served_logits(cell):
    spec = small_spec(cell, batch=2, pool=2, sample=4)
    mix = mix_for(spec, 11)
    mix.setup()
    mix.window(0.0, False)
    mix.release()
    assert mix.numbers()["logit_gap"] < 1e-5


@pytest.mark.parametrize("cell", ["rn50-train-resident-b256", "resnext50-train-resident-b256"])
def test_first_train_step(cell):
    spec = small_spec(cell, side=64, batch=2, images=8)
    mix = mix_for(spec, 2 ** 31 + 5)
    mix.setup()
    mix.release()
    ref_out, start = mix.reference()
    # the first step: the loss, and the gradient as Adam got it by the worst leaf
    assert abs(mix.snap["losses"][0] - ref_out["losses"][0]) <= 1e-4 * abs(ref_out["losses"][0])
    numbers = mix.numbers()
    # the first step's gradient and BN statistics, and the third's (the
    # port's first replayed step on the card; eager here)
    for name in ("grad_gap", "stats_gap", "replay_grad_gap", "replay_stats_gap"):
        assert numbers[name] < 1e-3, (name, numbers)


def test_eval_forward_against_a_plain_module():
    """The functional reference against torch.nn modules of the same
    network at RN50's first block: conv, BN in eval and train mode, pool."""
    spec = small_spec("rn50-serve-b256")
    cfg = spec["cfg"]
    import weights
    t = weights.make_tensors(cfg, 3, "cpu")
    x = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
    conv = torch.nn.Conv2d(3, 64, 7, 2, 3, bias=False)
    bn = torch.nn.BatchNorm2d(64).eval()
    with torch.no_grad():
        conv.weight.copy_(t["stem.weight"])
        bn.weight.copy_(t["stem.bn.weight"])
        bn.bias.copy_(t["stem.bn.bias"])
        bn.running_mean.copy_(t["stem.bn.running_mean"])
        bn.running_var.copy_(t["stem.bn.running_var"])
        want = torch.relu(bn(conv(x.float().permute(0, 3, 1, 2) / 255.0)))
        got = torch.relu(ref._bn(torch.nn.functional.conv2d(
            x.float().permute(0, 3, 1, 2) / 255.0, t["stem.weight"], stride=2, padding=3),
            t, "stem", False, cfg["batch_norm"], {}))
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    stats = {}
    y = torch.randn(4, 64, 5, 5)
    ref._bn(y, t, "stem", True, cfg["batch_norm"], stats)
    bn.train()
    bn(y)
    assert torch.allclose(stats["stem.bn.running_var"], bn.running_var, rtol=1e-5)
    assert torch.allclose(stats["stem.bn.running_mean"], bn.running_mean, atol=1e-6)
