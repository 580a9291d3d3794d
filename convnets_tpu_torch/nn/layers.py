"""Leaf layers and combinators (counterpart of convnets_tpu/nn/layers.py).

Children carry the JAX variable-path names: Sequential children '0',
'1', …; ConvBNReLU '0' conv, '1' BN, '2' ReLU; Add and Concat '0', '1', …
in branch order. Activations are NHWC. Every conv and pool runs a kernel
of `ops.kernels` in both modes: in eval mode conv2d_fused and
grouped_conv2d_fused (BN folded into their epilogue), depthwise_conv2d,
max_pool2d and avg_pool2d, called as the custom ops of
`ops/kernels/library.py` (torch.ops.convnets_torch.*), so that the live
model, the Trainer's eval step and an exported program run the same graph;
in train mode conv_bn_relu_train (conv2d_stats
or grouped_conv2d_stats), conv2d_train, grouped_conv2d_train,
depthwise_train and pool2d_train. A conv is dense, depthwise or grouped
(`_check_conv_envelope`, tested in the JAX package's order), each of any
stride and dilation per axis: a dense conv, a depthwise one (groups = Cin,
any channel multiplier), or a grouped one (Cin/G >= 2, any number of
groups). So every conv the JAX package's Conv2d takes, one whose groups
divide both channel counts, runs on a kernel. A depthwise ConvBNReLU runs
unfused, as in the JAX package: the depthwise kernel, then BatchNorm2d,
then ReLU; a grouped one runs fused, as a dense one. Train mode updates
the BN running statistics in place, once per forward (not again in a
Remat recompute). With CONVNETS_TPU_WINOGRAD set (ops/winograd.py, read on
every forward), a dense 3x3 stride-1 conv, bare or BN-fused, runs Winograd
F(2,3) or F(4,3) instead (ops/kernels/winograd.py), in both modes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.utils.checkpoint

from convnets_tpu_torch import ops
from convnets_tpu_torch.core import shapes
from convnets_tpu_torch.nn.module import (
    MaskTape, Module, current_generator, current_tape, recomputing,
)
from convnets_tpu_torch.ops import initializers as init
from convnets_tpu_torch.ops import kernels, winograd
from convnets_tpu_torch.ops.kernels import library
from convnets_tpu_torch.ops.norm import running_update
from convnets_tpu_torch.parallel.mesh import global_count

_OPS = getattr(torch.ops, library.NAMESPACE)


DENSE, DEPTHWISE, GROUPED = "dense", "depthwise", "grouped"


def _check_conv_envelope(conv: "Conv2d", cin: int) -> str:
    """Which kernel family takes the conv: DENSE (conv2d_fused),
    DEPTHWISE (depthwise_conv2d) or GROUPED (the grouped kernels), tested
    in the JAX package's order (nn/layers.py:91-105). Every conv whose
    groups divide both channel counts has one; any other is no conv (lax
    refuses it in the JAX package too) and raises ValueError."""
    if kernels.fits_conv(conv.stride, conv.dilation, conv.groups):
        return DENSE
    if kernels.fits_depthwise(cin, conv.out_channels, conv.dilation, conv.groups):
        return DEPTHWISE
    if kernels.fits_grouped(cin, conv.out_channels, conv.stride, conv.dilation, conv.groups):
        return GROUPED
    raise ValueError(f"a conv with groups={conv.groups}, Cin={cin}, Cout={conv.out_channels}, "
                     f"stride {conv.stride}, dilation {conv.dilation}: the groups must divide "
                     f"both channel counts, stride and dilation must be >= 1")


def _winograd_m(conv: "Conv2d", x) -> Optional[int]:
    """The Winograd gate of the JAX layer (nn/layers.py:126-146): F(m,3)'s
    m for a dense 3x3 stride-1 conv that ops/winograd.py:route sends there,
    else None (the direct kernels). Read on every call."""
    if not winograd.fits(conv.kernel, conv.stride, conv.dilation, conv.groups):
        return None
    return winograd.route(x.shape[1], x.shape[-1], conv.out_channels)


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
        m = _winograd_m(self, x)
        if m is not None:
            # the bias rounded to cd, then added in fp32 inside (JAX's b.astype(cd))
            b = None if self.bias is None else self.bias.to(cd)
            if self.training:
                return kernels.winograd_conv2d_train(x, w, b, self.padding, m)
            return _OPS.winograd_conv2d(x, w, b, None, None, list(self.padding), False, m)
        geo = (list(self.stride), list(self.padding))
        if family == DEPTHWISE and self.training:
            y = kernels.depthwise_train(x, w, self.stride, self.padding, self.dilation)
        elif family == DEPTHWISE:
            y = _OPS.depthwise_conv2d(x, w, *geo, list(self.dilation))
        elif family == GROUPED and self.training:
            y = kernels.grouped_conv2d_train(x, w, self.groups, self.stride, self.padding,
                                             self.dilation)
        elif family == GROUPED:
            y = _OPS.grouped_conv2d_fused(x, w, self.groups, None, None, *geo, False,
                                          list(self.dilation))
        elif self.training:
            y = kernels.conv2d_train(x, w, self.stride, self.padding, self.dilation)
        else:
            y = _OPS.conv2d_fused(x, w, None, None, *geo, False, list(self.dilation))
        if self.bias is not None:
            y = y + self.bias.to(cd)
        return y

    def extra_repr(self):
        return (f"{self.out_channels}, k={self.kernel}, s={self.stride}, "
                f"p={self.padding}, d={self.dilation}, g={self.groups}")

    def summary_label(self):
        return f"Conv2d({self.extra_repr()})"


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
        """The running-statistics update, in place and outside autograd;
        none in a Remat recompute. n: the count per channel behind mean and
        var (the global count under a data-parallel mesh)."""
        write_running(self, *running_update(self.running_mean, self.running_var,
                                            mean.detach(), var.detach(), n, self.momentum))

    def forward(self, x):
        if self.training:
            y, new_mean, new_var = ops.batch_norm_train(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                eps=self.eps, momentum=self.momentum)
            write_running(self, new_mean, new_var)
            return y
        return ops.batch_norm_inference(x, self.running_mean, self.running_var,
                                        self.weight, self.bias, eps=self.eps)

    def summary_label(self):
        return "BatchNorm2d()"


def write_running(mod, new_mean, new_var) -> None:
    """Copy new running statistics into `mod`'s buffers, except in a Remat
    recompute."""
    if recomputing():
        return
    with torch.no_grad():
        mod.running_mean.copy_(new_mean)
        mod.running_var.copy_(new_var)


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

    def summary_label(self):
        return f"Linear({self.out_features})"


class ReLU(Module):
    def forward(self, x):
        return ops.relu(x)


class Sigmoid(Module):
    def forward(self, x):
        return ops.sigmoid(x)


def dropout(x, rate: float, train: bool):
    """ops.dropout with the mask from the generator of the enclosing
    `use_generator` context; inside a train-mode Remat the mask is kept on
    its MaskTape, and its recompute takes it from there."""
    if not train or rate <= 0.0:
        return x
    tape = current_tape()
    if tape is not None and tape.cursor is not None:
        mask = tape.next_mask(x.shape)
    else:
        mask = ops.dropout_mask(x, rate, current_generator())
        if tape is not None:
            tape.masks.append(mask)
    return ops.apply_dropout(x, mask, rate)


class Dropout(Module):
    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        return dropout(x, self.rate, self.training)

    def summary_label(self):
        return f"Dropout({self.rate})"


def _pool2d(x, mode, kernel, stride, padding, train):
    """The pool kernels: pool2d_train in train mode, else the max- or
    avg-pool custom op."""
    if train:
        return kernels.pool2d_train(x, mode, kernel, stride, padding)
    pool = _OPS.max_pool2d if mode == "max" else _OPS.avg_pool2d
    return pool(x, *library.pool_args(kernel, stride, padding))


class _Pool2d(Module):
    MODE = ""

    def __init__(self, kernel, stride=None, padding=0):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def out_shape(self, in_shape):
        return shapes.pool2d_out_shape(in_shape, self.kernel, self.stride, self.padding)

    def forward(self, x):
        return _pool2d(x, self.MODE, self.kernel, self.stride, self.padding, self.training)

    def summary_label(self):
        return f"{type(self).__name__}(k={self.kernel}, s={self.stride}, p={self.padding})"


class MaxPool2d(_Pool2d):
    """-inf padded max pool (torch MaxPool2d)."""
    MODE = "max"


class AvgPool2d(_Pool2d):
    """count_include_pad average pool (torch AvgPool2d)."""
    MODE = "avg"


class AdaptiveAvgPool2d(Module):
    """Adaptive average pool to output_size (ops.adaptive_avg_pool2d).
    Where (H, W) divide into it, the avg pool of window and stride (H/oh,
    W/ow) runs on the pool kernels as AvgPool2d's does; uneven bins are
    plain."""

    def __init__(self, output_size):
        super().__init__()
        self.output_size = shapes.to_pair(output_size)

    def out_shape(self, in_shape):
        *lead, _, _, c = in_shape
        return (*lead, *self.output_size, c)

    def forward(self, x):
        (oh, ow), (_, h, w, _) = self.output_size, x.shape
        if (h, w) == (oh, ow) or h % oh or w % ow:
            return ops.adaptive_avg_pool2d(x, self.output_size)
        k = (h // oh, w // ow)
        return _pool2d(x, "avg", k, k, 0, self.training)


class GlobalAvgPool2d(Module):
    """The mean over H and W: (N, C), or (N, 1, 1, C) with keepdims."""

    def __init__(self, keepdims=False):
        super().__init__()
        self.keepdims = keepdims

    def out_shape(self, in_shape):
        *lead, h, w, c = in_shape
        return (*lead, 1, 1, c) if self.keepdims else (*lead, c)

    def forward(self, x):
        return ops.global_avg_pool2d(x, keepdims=self.keepdims)


class Flatten(Module):
    """(N, H, W, C) → (N, H·W·C) in NHWC order (nn/layers.py:Flatten)."""

    def out_shape(self, in_shape):
        return (in_shape[0], shapes.num_flat_features(in_shape))

    def forward(self, x):
        return ops.flatten(x)


class ChannelShuffle(Module):
    """ShuffleNet's channel shuffle (ops.channel_shuffle) as a layer."""

    def __init__(self, groups):
        super().__init__()
        self.groups = int(groups)

    def forward(self, x):
        return ops.channel_shuffle(x, self.groups)

    def summary_label(self):
        return f"ChannelShuffle(g={self.groups})"


class Identity(Module):
    def forward(self, x):
        return x


class Lambda(Module):
    """A pure elementwise or shape op fn(x) (nn/layers.py:Lambda); shape_fn
    gives its output shape (the input's by default)."""

    def __init__(self, fn: Callable, shape_fn: Optional[Callable] = None, name="Lambda"):
        super().__init__()
        self.fn = fn
        self.shape_fn = shape_fn
        self._name = name

    def out_shape(self, in_shape):
        return tuple(in_shape) if self.shape_fn is None else tuple(self.shape_fn(in_shape))

    def forward(self, x):
        return self.fn(x)

    def extra_repr(self):
        return self._name

    def summary_label(self):
        return self._name


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

    def summary_label(self):
        return f"Sequential[{len(self._modules)}]"


class Remat(Module):
    """Rematerialization wrapper (nn/layers.py:Remat in the JAX package):
    its child's variables sit at the child's own paths. Eval mode runs the
    child. Train mode runs it under torch.utils.checkpoint (non-reentrant):
    autograd keeps only the child's input, and the backward runs the
    child's forward again, kernels included, to rebuild what it needs. The
    recompute writes no running statistics (`recomputing`) and reuses the
    dropout masks the forward drew (MaskTape: capture-safe, unlike saving
    and restoring a generator's state); it always runs the whole forward
    (no early stop), so its launches are those of one forward. A Remat
    inside another's forward runs its child directly: the outer recompute
    covers it."""

    JAX_TRANSPARENT = True

    def __init__(self, child: Module):
        super().__init__()
        self.child = child

    def init(self, generator, in_shape):
        self.child.init(generator, in_shape)

    def out_shape(self, in_shape):
        return self.child.out_shape(in_shape)

    def forward(self, x):
        if not (self.training and torch.is_grad_enabled()) or current_tape() is not None:
            return self.child(x)
        tape = MaskTape()
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            return torch.utils.checkpoint.checkpoint(
                self.child, x, use_reentrant=False, preserve_rng_state=False,
                context_fn=lambda: (tape.recording(), tape.replaying()))

    def summary_label(self):
        return f"Remat({self.child.summary_label()})"


class _MultiBranch(Module):
    """Parallel branches over one input, children named '0', '1', …"""

    def __init__(self, branches):
        super().__init__()
        for name, branch in _named(branches).items():
            self.add_module(name, branch)

    def init(self, generator, in_shape):
        for branch in self._modules.values():
            branch.init(generator, in_shape)

    def shape_flow(self, in_shape):
        """Every branch takes the block's input."""
        return {name: tuple(in_shape) for name in self._modules}


class Concat(_MultiBranch):
    """Parallel branches concatenated on the channel (last) axis in branch order."""

    def out_shape(self, in_shape):
        outs = [branch.out_shape(in_shape) for branch in self._modules.values()]
        return (*outs[0][:-1], sum(o[-1] for o in outs))

    def forward(self, x):
        return torch.cat([branch(x) for branch in self._modules.values()], dim=-1)

    def summary_label(self):
        return f"Concat[{len(self._modules)}]"


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

    def summary_label(self):
        return f"Add[{len(self._modules)}]{'+ReLU' if self.post_relu else ''}"


class ConvBNReLU(Sequential):
    """conv → BN → [ReLU] on the kernels. Eval mode folds BN into the conv
    kernel's epilogue: s = scale·rsqrt(var + eps) and shift = bias − mean·s
    in fp32, applied after the fp32 accumulation (never folded into the
    weights), then one rounding to the compute dtype. Train mode runs
    conv_bn_relu_train (the conv2d_stats kernel, or grouped_conv2d_stats
    for a grouped conv; batch statistics, ReLU) and then the running update
    of the JAX layer (:574-583). Children stay '0' Conv2d, '1'
    BatchNorm2d, ('2' ReLU), so the variable tree is the unfused one. A
    conv with a bias, and a depthwise conv of any multiplier and dilation
    (which fits neither fused kernel in the JAX package either, :539-547),
    runs the unfused composition. A dilated conv, and a grouped conv
    outside JAX's Pallas envelope (more than 64 groups, Cin/G above 32, a
    stride other than 1 or 2 or different strides per axis), runs fused
    too, where the JAX package runs it unfused on XLA (conv, then
    BatchNorm2d): the values agree in fp32; in bf16 the fused path rounds y
    once (train: the stored y the statistics are taken from; eval: after
    the folded epilogue) where the JAX package rounds the conv output and
    then the BN output. A conv that the Winograd gate takes (`_winograd_m`)
    runs the Winograd kernels at this site: in train mode
    conv_bn_relu_train with the output transform's statistics epilogue in
    place of conv2d_stats, in eval mode its folded-BN epilogue in place of
    conv2d_fused's. The JAX package runs that conv unfused (Winograd conv,
    then BatchNorm2d), so in bf16 the port rounds once where it rounds
    twice, as for a dilated conv."""

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
        m = _winograd_m(conv, x)
        if self.training:
            out, mean, var = kernels.conv_bn_relu_train(
                x, w, bn.weight, bn.bias, conv.stride, conv.padding, bn.eps, self.act,
                groups=conv.groups, dilation=conv.dilation, winograd=m)
            bn.update_running(mean, var, global_count(out.shape[0] * out.shape[1] * out.shape[2]))
            return out
        s, sh = bn.folded()
        if m is not None:
            return _OPS.winograd_conv2d(x, w, None, s, sh, list(conv.padding), self.act, m)
        geo = (list(conv.stride), list(conv.padding), self.act, list(conv.dilation))
        if family == GROUPED:
            return _OPS.grouped_conv2d_fused(x, w, conv.groups, s, sh, *geo)
        return _OPS.conv2d_fused(x, w, s, sh, *geo)

    def summary_label(self):
        return f"ConvBNReLU({self._modules['0'].summary_label()}){'+ReLU' if self.act else ''}"


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
