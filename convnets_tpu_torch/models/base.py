"""Model wrapper, Builder and registry (counterpart of convnets_tpu/models/base.py).

`build_model(arch, setting)` takes a `convnets_tpu_torch.settings.Settings`
or any object with the fields the builders read: kind, input_size (C, H, W),
num_classes, batch_norm, init_params, dropout_rate, mixed_precision,
remat and seed. The model comes back initialized and in eval mode;
`.train()` switches it to the train-mode forward that
`train.engine.build_train_step` drives.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from convnets_tpu_torch import nn
from convnets_tpu_torch.core.precision import policy_from_setting


class Model(torch.nn.Module):
    """A named, configured network: one root module whose output is the logits."""

    def __init__(self, name: str, setting, module: nn.Module):
        super().__init__()
        self.arch = name
        self.model_name = name + str(setting.kind)
        # the checkpoint file names' version, as in the JAX package
        self.version = int(time.time())
        self.setting = setting
        self.module = module
        self.policy = policy_from_setting(setting)
        c, h, w = setting.input_size
        self.input_shape_nhwc = (h, w, c)

    def batch_shape(self, batch_size: int):
        return (batch_size, *self.input_shape_nhwc)

    def init(self, generator: Optional[torch.Generator] = None) -> "Model":
        """(Re-)create every parameter; default generator seeded from setting.seed."""
        if generator is None:
            generator = torch.Generator().manual_seed(int(getattr(self.setting, "seed", 0)))
        device = next(self.parameters(), torch.empty(0)).device
        self.module.init(generator, self.batch_shape(1))
        return self.to(device)

    def forward(self, x):
        """NHWC input → logits in the output dtype (fp32)."""
        return self.module(x).to(self.policy.output_dtype)

    def summary(self) -> str:
        """The top-level children with their output shapes and parameter
        counts, and the total (Trainer.print_summary)."""
        shape = self.batch_shape(1)
        lines = [f"=== {self.model_name} (input {shape}) ==="]
        for name, child in self.module.named_children():
            shape = child.out_shape(shape)
            count = sum(p.numel() for p in child.parameters())
            lines.append(f"{name:>4} {type(child).__name__:<16} out {shape}  params {count:,}")
        lines.append(f"total params {sum(p.numel() for p in self.parameters()):,}")
        return "\n".join(lines)


class Builder:
    """Tracks the current channel count and maps Settings fields
    (batch_norm / init_params / dropout_rate) onto layers."""

    def __init__(self, setting):
        self.setting = setting
        self.in_channels = setting.input_size[0]
        self.bn = bool(getattr(setting, "batch_norm", True))
        init_params = getattr(setting, "init_params", True)
        self.conv_init = "he" if init_params else "default"
        self.linear_init = "normal" if init_params else "default"

    def conv(self, num_filters, **kw) -> nn.Conv2d:
        """A bare conv, bias off iff BN on."""
        self.in_channels = num_filters
        return nn.Conv2d(num_filters, bias=not self.bn, init_mode=self.conv_init, **kw)

    def conv_block(self, num_filters, activation=True, set_output=True, groups=1,
                   kernel=3, stride=1, padding=0, dilation=1) -> nn.Sequential:
        block = nn.conv_block(num_filters, kernel, stride=stride, padding=padding,
                              dilation=dilation, groups=groups, batch_norm=self.bn,
                              act=activation, init_mode=self.conv_init)
        if set_output:
            self.in_channels = num_filters
        return block

    def conv_block_depthwise(self, kernel=3, stride=1, padding=0,
                             activation=True) -> nn.Sequential:
        """Depthwise conv (+BN+ReLU): groups = the current channel count,
        multiplier 1."""
        c = self.in_channels
        return self.conv_block(c, kernel=kernel, stride=stride, padding=padding, groups=c,
                               activation=activation)

    def linear(self, out_features) -> nn.Linear:
        return nn.Linear(out_features, init_mode=self.linear_init)

    def dropout(self) -> nn.Dropout:
        return nn.Dropout(getattr(self.setting, "dropout_rate", 0.5))


_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def build_model(arch: str, setting, device="cuda",
                generator: Optional[torch.Generator] = None) -> Model:
    """Construct under the settings' dtype policy, initialize, move to
    `device` and switch to eval mode. The model goes to the card unless the
    caller asks for another device (`device="cpu"`, as the tests do); with
    no CUDA device present that default raises rather than falling back."""
    if arch not in _REGISTRY:
        raise KeyError(f"unknown architecture '{arch}'; have {sorted(_REGISTRY)} "
                       f"(the rest of the zoo is ROADMAP.md modules item 5)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"build_model: device {str(device)!r} asked for, but no CUDA "
                           f"device is available; pass device='cpu' to build on the CPU")
    with nn.use_policy(policy_from_setting(setting)):
        model = _REGISTRY[arch](setting)
    model.registry_name = arch
    model.init(generator)
    model.to(device)
    return model.eval()
