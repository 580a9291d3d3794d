"""Leaf layers and combinators (counterpart of convnets_tpu/nn/layers.py).

Children carry the JAX variable-path names: Sequential children '0',
'1', …; ConvBNReLU '0' conv, '1' BN, '2' ReLU; Add and Concat '0', '1', …
in branch order. Activations are NHWC. Every conv and pool runs a kernel
of `ops.kernels` in both modes: in eval mode conv2d_fused and
grouped_conv2d_fused (BN folded into their epilogue), depthwise_conv2d,
max_pool2d and avg_pool2d; in train mode conv_bn_relu_train (conv2d_stats
or grouped_conv2d_stats), conv2d_train, grouped_conv2d_train,
depthwise_train and pool2d_train. A conv is dense, depthwise or grouped
(`_check_conv_envelope`, tested in the JAX package's order). A depthwise
ConvBNReLU runs unfused, as in the JAX package: the depthwise kernel, then
BatchNorm2d, then ReLU; a grouped one runs fused, as a dense one. Train
mode updates the BN running statistics in place, once per forward. What
the port does not have yet (grouped convs outside `fits_grouped`, dilated
convs, Remat in train mode) raises NotImplementedError naming the
ROADMAP.md item that ports it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from convnets_tpu_torch import ops
from convnets_tpu_torch.core import shapes
from convnets_tpu_torch.nn.module import Module, current_generator
from convnets_tpu_torch.ops import initializers as init
from convnets_tpu_torch.ops import kernels
from convnets_tpu_torch.ops.norm import running_update


def not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {item})")


DENSE, DEPTHWISE, GROUPED = "dense", "depthwise", "grouped"


def _check_conv_envelope(conv: "Conv2d", cin: int) -> str:
    """Which kernel family takes the conv: DENSE (conv2d_fused),
    DEPTHWISE (depthwise_conv2d) or GROUPED (the grouped kernels), tested
    in the JAX package's order (nn/layers.py:91-105); raises for what no
    ported kernel takes."""
    if kernels.fits_conv(conv.stride, conv.dilation, conv.groups):
        return DENSE
    if kernels.fits_depthwise(cin, conv.out_channels, conv.dilation, conv.groups):
        return DEPTHWISE
    if kernels.fits_grouped(cin, conv.out_channels, conv.stride, conv.dilation, conv.groups):
        return GROUPED
    if conv.groups > 1:
        raise not_ported(f"grouped conv (groups={conv.groups}, Cin={cin}, dilation "
                         f"{conv.dilation}) outside fits_grouped",
                         "modules item 5, the SKNet/ShuffleNet grouped convs")
    raise not_ported(f"conv with stride {conv.stride}, dilation {conv.dilation}",
                     "kernels conv2d_fused envelope (stride 1 or 2, no dilation)")


class Conv2d(Module):
    """2-D convolution; `weight` is HWIO (kh, kw, Cin/groups, Cout).

    init_mode 'he': He normal (fan_out) and zero bias; 'default': the
    torch constructor's uniform distributions."""

    JAX_LEAVES = {"weight": ("params", "w"), "bias": ("params", "b")}

    def __init__(self, out_channels, kernel, stride=1, padding=0, dilation=1,
                 groups=1, bias=True, init_mode="he"):
        super().__init__()
        self.out_channels = int(out_channels)
        self.kernel = shapes.to_pair(kernel)
        self.stride = shapes.to_pair(stride)
        self.padding = shapes.to_pair(padding)
        self.dilation = shapes.to_pair(dilation)
        self.groups = int(groups)
        self.use_bias = bool(bias)
        self.init_mode = init_mode
        self.weight = self.bias = None

    def init(self, generator, in_shape):
        cin = in_shape[-1]
        assert cin % self.groups == 0, f"C={cin} not divisible by groups={self.groups}"
        kh, kw = self.kernel
        wshape = (kh, kw, cin // self.groups, self.out_channels)
        dtype = self.policy.param_dtype
        if self.init_mode == "he":
            w = init.he_normal_conv(wshape, generator, dtype)
            b = torch.zeros(self.out_channels, dtype=dtype)
        else:
            w = init.he_uniform_conv_default(wshape, generator, dtype)
            b = init.conv_bias_default((self.out_channels,), (cin // self.groups) * kh * kw,
                                       generator, dtype)
        self.weight = torch.nn.Parameter(w)
        self.bias = torch.nn.Parameter(b) if self.use_bias else None

    def out_shape(self, in_shape):
        return shapes.conv2d_out_shape(in_shape, self.out_channels, self.kernel,
                                       self.stride, self.padding, self.dilation)

    def forward(self, x):
        family = _check_conv_envelope(self, x.shape[-1])
        cd = self.policy.compute_dtype
        x, w = x.to(cd), self.weight.to(cd)
        if family == DEPTHWISE and self.training:
            y = kernels.depthwise_train(x, w, self.stride, self.padding)
        elif family == DEPTHWISE:
            y = kernels.depthwise_conv2d(x, w, stride=self.stride, padding=self.padding)
        elif family == GROUPED and self.training:
            y = kernels.grouped_conv2d_train(x, w, self.groups, self.stride, self.padding)
        elif family == GROUPED:
            y = kernels.grouped_conv2d_fused(x, w, self.groups, stride=self.stride,
                                             padding=self.padding)
        elif self.training:
            y = kernels.conv2d_train(x, w, self.stride, self.padding)
        else:
            y = kernels.conv2d_fused(x, w, stride=self.stride, padding=self.padding)
        if self.bias is not None:
            y = y + self.bias.to(cd)
        return y

    def extra_repr(self):
        return (f"{self.out_channels}, k={self.kernel}, s={self.stride}, "
                f"p={self.padding}, d={self.dilation}, g={self.groups}")


class BatchNorm2d(Module):
    """torch-parity batch norm (eps 1e-5, momentum 0.1, unbiased running
    var); `weight`/`bias` are the JAX scale/bias and the running buffers
    the JAX state mean/var."""

    JAX_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                  "running_mean": ("state", "mean"), "running_var": ("state", "var")}

    def __init__(self, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = self.bias = None
        self.register_buffer("running_mean", None)
        self.register_buffer("running_var", None)

    def init(self, generator, in_shape):
        c = in_shape[-1]
        dtype = self.policy.param_dtype
        self.weight = torch.nn.Parameter(torch.ones(c, dtype=dtype))
        self.bias = torch.nn.Parameter(torch.zeros(c, dtype=dtype))
        self.running_mean = torch.zeros(c, dtype=torch.float32)
        self.running_var = torch.ones(c, dtype=torch.float32)

    def folded(self):
        """(s, shift) in fp32: BN as y·s + shift, s = scale·rsqrt(var + eps)."""
        s = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        return s, self.bias.float() - self.running_mean.float() * s

    def update_running(self, mean, var, n: int) -> None:
        """The running-statistics update, in place and outside autograd."""
        with torch.no_grad():
            new_mean, new_var = running_update(self.running_mean, self.running_var,
                                               mean.detach(), var.detach(), n, self.momentum)
            self.running_mean.copy_(new_mean)
            self.running_var.copy_(new_var)

    def forward(self, x):
        if self.training:
            y, new_mean, new_var = ops.batch_norm_train(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                eps=self.eps, momentum=self.momentum)
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
            return y
        return ops.batch_norm_inference(x, self.running_mean, self.running_var,
                                        self.weight, self.bias, eps=self.eps)


class Linear(Module):
    """Dense layer; `weight` is (in, out) as in JAX. init_mode 'normal' = N(0, 0.01)."""

    JAX_LEAVES = {"weight": ("params", "w"), "bias": ("params", "b")}

    def __init__(self, out_features, bias=True, init_mode="normal"):
        super().__init__()
        self.out_features = int(out_features)
        self.use_bias = bool(bias)
        self.init_mode = init_mode
        self.weight = self.bias = None

    def init(self, generator, in_shape):
        fan_in = in_shape[-1]
        shape = (fan_in, self.out_features)
        dtype = self.policy.param_dtype
        if self.init_mode == "normal":
            w = init.normal_linear(shape, generator, dtype)
            b = torch.zeros(self.out_features, dtype=dtype)
        else:
            w = init.linear_default(shape, generator, dtype)
            b = init.conv_bias_default((self.out_features,), fan_in, generator, dtype)
        self.weight = torch.nn.Parameter(w)
        self.bias = torch.nn.Parameter(b) if self.use_bias else None

    def out_shape(self, in_shape):
        return (*in_shape[:-1], self.out_features)

    def forward(self, x):
        cd = self.policy.compute_dtype
        return ops.linear(x.to(cd), self.weight.to(cd),
                          None if self.bias is None else self.bias.to(cd))


class ReLU(Module):
    def forward(self, x):
        return ops.relu(x)


class Dropout(Module):
    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        """At train time the mask comes from the generator of the enclosing
        `use_generator` context."""
        return ops.dropout(x, self.rate, current_generator(), train=self.training)


class _Pool2d(Module):
    MODE = ""

    def __init__(self, kernel, stride=None, padding=0):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def out_shape(self, in_shape):
        return shapes.pool2d_out_shape(in_shape, self.kernel, self.stride, self.padding)

    def forward(self, x):
        if self.training:
            return kernels.pool2d_train(x, self.MODE, self.kernel, self.stride, self.padding)
        pool = kernels.max_pool2d if self.MODE == "max" else kernels.avg_pool2d
        return pool(x, self.kernel, self.stride, self.padding)


class MaxPool2d(_Pool2d):
    """-inf padded max pool (torch MaxPool2d)."""
    MODE = "max"


class AvgPool2d(_Pool2d):
    """count_include_pad average pool (torch AvgPool2d)."""
    MODE = "avg"


class GlobalAvgPool2d(Module):
    def out_shape(self, in_shape):
        *lead, h, w, c = in_shape
        return (*lead, c)

    def forward(self, x):
        return ops.global_avg_pool2d(x)


class Flatten(Module):
    """(N, H, W, C) → (N, H·W·C) in NHWC order (nn/layers.py:Flatten)."""

    def out_shape(self, in_shape):
        return (in_shape[0], math.prod(in_shape[1:]))

    def forward(self, x):
        return ops.flatten(x)


class Identity(Module):
    def forward(self, x):
        return x


def _named(mods) -> Dict[str, Module]:
    if isinstance(mods, dict):
        return dict(mods)
    return {str(i): m for i, m in enumerate(mods)}


class Sequential(Module):
    """Ordered composition; children named '0', '1', … or by the given names."""

    def __init__(self, layers: Sequence[Module] | Dict[str, Module]):
        super().__init__()
        for name, layer in _named(layers).items():
            self.add_module(name, layer)

    def init(self, generator, in_shape):
        shape = tuple(in_shape)
        for layer in self._modules.values():
            layer.init(generator, shape)
            shape = layer.out_shape(shape)

    def out_shape(self, in_shape):
        shape = tuple(in_shape)
        for layer in self._modules.values():
            shape = layer.out_shape(shape)
        return shape

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class Remat(Module):
    """Rematerialization wrapper (nn/layers.py:Remat in the JAX package):
    its child's variables sit at the child's own paths. Eval mode runs the
    child. Train mode is not ported: under torch.utils.checkpoint the
    recomputed forward would apply every BN running update a second time,
    which JAX's functional state never does."""

    JAX_TRANSPARENT = True

    def __init__(self, child: Module):
        super().__init__()
        self.child = child

    def init(self, generator, in_shape):
        self.child.init(generator, in_shape)

    def out_shape(self, in_shape):
        return self.child.out_shape(in_shape)

    def forward(self, x):
        if self.training:
            raise not_ported("train-mode Remat (a recompute would update the BN running "
                             "statistics twice)", "modules item 8, Remat")
        return self.child(x)


class _MultiBranch(Module):
    """Parallel branches over one input, children named '0', '1', …"""

    def __init__(self, branches):
        super().__init__()
        for name, branch in _named(branches).items():
            self.add_module(name, branch)

    def init(self, generator, in_shape):
        for branch in self._modules.values():
            branch.init(generator, in_shape)


class Concat(_MultiBranch):
    """Parallel branches concatenated on the channel (last) axis in branch order."""

    def out_shape(self, in_shape):
        outs = [branch.out_shape(in_shape) for branch in self._modules.values()]
        return (*outs[0][:-1], sum(o[-1] for o in outs))

    def forward(self, x):
        return torch.cat([branch(x) for branch in self._modules.values()], dim=-1)


class Add(_MultiBranch):
    """Parallel branches summed in the compute dtype; optional post-ReLU."""

    def __init__(self, branches, post_relu=False):
        super().__init__(branches)
        self.post_relu = post_relu

    def out_shape(self, in_shape):
        return next(iter(self._modules.values())).out_shape(in_shape)

    def forward(self, x):
        outs = [branch(x) for branch in self._modules.values()]
        y = outs[0]
        for o in outs[1:]:
            y = y + o
        if self.post_relu:
            y = ops.relu(y)
        return y


class ConvBNReLU(Sequential):
    """conv → BN → [ReLU] on the kernels. Eval mode folds BN into the conv
    kernel's epilogue: s = scale·rsqrt(var + eps) and shift = bias − mean·s
    in fp32, applied after the fp32 accumulation (never folded into the
    weights), then one rounding to the compute dtype. Train mode runs
    conv_bn_relu_train (the conv2d_stats kernel, or grouped_conv2d_stats
    for a grouped conv; batch statistics, ReLU) and then the running update
    of the JAX layer (:574-583). Children stay '0' Conv2d, '1'
    BatchNorm2d, ('2' ReLU), so the variable tree is the unfused one. A
    conv with a bias, and a depthwise conv (which fits neither fused kernel
    in the JAX package either, :539-547), runs the unfused composition."""

    def __init__(self, conv: Conv2d, bn: BatchNorm2d, act: bool):
        layers: List[Module] = [conv, bn]
        if act:
            layers.append(ReLU())
        super().__init__(layers)
        self.act = act

    def forward(self, x):
        conv, bn = self._modules["0"], self._modules["1"]
        family = _check_conv_envelope(conv, x.shape[-1])
        if conv.bias is not None or family == DEPTHWISE:
            return super().forward(x)
        cd = conv.policy.compute_dtype
        x, w = x.to(cd), conv.weight.to(cd)
        if self.training:
            out, mean, var = kernels.conv_bn_relu_train(
                x, w, bn.weight, bn.bias, conv.stride, conv.padding, bn.eps, self.act,
                groups=conv.groups)
            bn.update_running(mean, var, out.shape[0] * out.shape[1] * out.shape[2])
            return out
        s, sh = bn.folded()
        kw = dict(stride=conv.stride, padding=conv.padding, relu=self.act)
        if family == GROUPED:
            return kernels.grouped_conv2d_fused(x, w, conv.groups, s, sh, **kw)
        return kernels.conv2d_fused(x, w, s, sh, **kw)


def conv_block(out_channels, kernel, stride=1, padding=0, dilation=1, groups=1,
               batch_norm=True, act=True, init_mode="he") -> Sequential:
    """conv → [BN] → [ReLU], bias off iff BN on."""
    conv = Conv2d(out_channels, kernel, stride=stride, padding=padding,
                  dilation=dilation, groups=groups, bias=not batch_norm,
                  init_mode=init_mode)
    if batch_norm:
        return ConvBNReLU(conv, BatchNorm2d(), act)
    layers: List[Module] = [conv]
    if act:
        layers.append(ReLU())
    return Sequential(layers)
