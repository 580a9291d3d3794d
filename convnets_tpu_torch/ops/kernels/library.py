"""The eval path's kernels as torch custom ops, in the `convnets_torch`
namespace: conv2d_fused, grouped_conv2d_fused, depthwise_conv2d,
max_pool2d, avg_pool2d and winograd_conv2d (the Winograd path of a gated
3x3 stride-1 conv: bias, or folded BN and ReLU).

`torch.export` cannot trace a ctypes launch: the wrappers read
`data_ptr()`, which a fake tensor does not have. As custom ops the kernels
become nodes of the traced graph, called by name, so a program saved with
`torch.export.save` runs them again once this module is imported.

Each op has two implementations and no other:
- a fake one (`register_fake`), which gives the output's shape and dtype
  from the inputs', the batch left as it comes (symbolic under export);
  nothing is planned and nothing is counted at trace time;
- one for the `cpu` and `cuda` device types: the kernel's wrapper, which
  for a CUDA tensor picks its plan (tile, route, alignment) from the
  concrete shapes and pointers of this call, launches the kernel or raises,
  and counts the launch in LAUNCHES / ROUTE_LAUNCHES (so a loaded
  program's launches are counted too), and for a CPU tensor computes the
  plain version.
There is no composite or default implementation: a tensor on any other
device raises, and a CUDA tensor never reaches a plain version.

The three direct conv ops take the dilation as their last argument, with the
default [1, 1] in their schema, so a program saved before the argument
existed still loads and runs undilated.

Importing this module registers the ops; it compiles nothing.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch.library import custom_op

from convnets_tpu_torch.core.shapes import conv_out_size, to_pair
from convnets_tpu_torch.ops import kernels as _k

NAMESPACE = "convnets_torch"
OPS = ("conv2d_fused", "grouped_conv2d_fused", "depthwise_conv2d", "max_pool2d", "avg_pool2d",
       "winograd_conv2d")


def _out_hw(x, kernel, stride, padding, dilation=1):
    (kh, kw), (sh, sw), (ph, pw) = to_pair(kernel), to_pair(stride), to_pair(padding)
    dh, dw = to_pair(dilation)
    return (conv_out_size(x.shape[1], kh, sh, ph, dh), conv_out_size(x.shape[2], kw, sw, pw, dw))


def _conv_fake(x, w, stride, padding, dilation):
    oh, ow = _out_hw(x, w.shape[:2], stride, padding, dilation)
    return x.new_empty((x.shape[0], oh, ow, w.shape[-1]))


_EPILOGUE = "Tensor? scale, Tensor? shift, int[] stride, int[] padding, bool relu"
_DILATION = "int[2] dilation=[1, 1]"


def _pool_fake(x, kernel, stride, padding):
    oh, ow = _out_hw(x, kernel, stride, padding)
    return x.new_empty((x.shape[0], oh, ow, x.shape[-1]))


@custom_op(f"{NAMESPACE}::conv2d_fused", mutates_args=(), device_types=("cpu", "cuda"),
           schema=f"(Tensor x, Tensor w, {_EPILOGUE}, {_DILATION}) -> Tensor")
def conv2d_fused(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                 shift: Optional[torch.Tensor], stride: List[int], padding: List[int],
                 relu: bool, dilation: List[int] = (1, 1)) -> torch.Tensor:
    """ops/kernels/conv.py:conv2d_fused as an op: x NHWC, w HWIO, the fp32
    epilogue scale/shift (or None), stride, padding and dilation pairs."""
    return _k.conv2d_fused(x, w, scale, shift, stride=stride, padding=padding, relu=relu,
                           dilation=dilation)


@conv2d_fused.register_fake
def _(x, w, scale, shift, stride, padding, relu, dilation=(1, 1)):
    return _conv_fake(x, w, stride, padding, dilation)


@custom_op(f"{NAMESPACE}::grouped_conv2d_fused", mutates_args=(), device_types=("cpu", "cuda"),
           schema=f"(Tensor x, Tensor w, SymInt groups, {_EPILOGUE}, {_DILATION}) -> Tensor")
def grouped_conv2d_fused(x: torch.Tensor, w: torch.Tensor, groups: int,
                         scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                         stride: List[int], padding: List[int], relu: bool,
                         dilation: List[int] = (1, 1)) -> torch.Tensor:
    """ops/kernels/conv.py:grouped_conv2d_fused as an op: w (kh, kw, Cin/G,
    Cout)."""
    return _k.grouped_conv2d_fused(x, w, groups, scale, shift, stride=stride, padding=padding,
                                   relu=relu, dilation=dilation)


@grouped_conv2d_fused.register_fake
def _(x, w, groups, scale, shift, stride, padding, relu, dilation=(1, 1)):
    return _conv_fake(x, w, stride, padding, dilation)


@custom_op(f"{NAMESPACE}::depthwise_conv2d", mutates_args=(), device_types=("cpu", "cuda"),
           schema=f"(Tensor x, Tensor w, int[] stride, int[] padding, {_DILATION}) -> Tensor")
def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, stride: List[int], padding: List[int],
                     dilation: List[int] = (1, 1)) -> torch.Tensor:
    """ops/kernels/depthwise.py:depthwise_conv2d as an op: w (kh, kw, 1,
    m·C), m the channel multiplier."""
    return _k.depthwise_conv2d(x, w, stride=stride, padding=padding, dilation=dilation)


@depthwise_conv2d.register_fake
def _(x, w, stride, padding, dilation=(1, 1)):
    return _conv_fake(x, w, stride, padding, dilation)


@custom_op(f"{NAMESPACE}::max_pool2d", mutates_args=(), device_types=("cpu", "cuda"))
def max_pool2d(x: torch.Tensor, kernel: List[int], stride: List[int],
               padding: List[int]) -> torch.Tensor:
    """ops/kernels/pool.py:max_pool2d as an op (-inf padding)."""
    return _k.max_pool2d(x, kernel, stride, padding)


@max_pool2d.register_fake
def _(x, kernel, stride, padding):
    return _pool_fake(x, kernel, stride, padding)


@custom_op(f"{NAMESPACE}::avg_pool2d", mutates_args=(), device_types=("cpu", "cuda"))
def avg_pool2d(x: torch.Tensor, kernel: List[int], stride: List[int],
               padding: List[int]) -> torch.Tensor:
    """ops/kernels/pool.py:avg_pool2d as an op (count_include_pad)."""
    return _k.avg_pool2d(x, kernel, stride, padding)


@avg_pool2d.register_fake
def _(x, kernel, stride, padding):
    return _pool_fake(x, kernel, stride, padding)


@custom_op(f"{NAMESPACE}::winograd_conv2d", mutates_args=(), device_types=("cpu", "cuda"),
           schema="(Tensor x, Tensor w, Tensor? bias, Tensor? scale, Tensor? shift, "
                  "int[] padding, bool relu, int m) -> Tensor")
def winograd_conv2d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                    padding: List[int], relu: bool, m: int) -> torch.Tensor:
    """ops/kernels/winograd.py:winograd_conv2d as an op: w (3, 3, Cin,
    Cout), stride 1; the bias (in x.dtype) or the fp32 scale/shift; F(m,3)."""
    return _k.winograd_conv2d(x, w, bias, scale, shift, padding=padding, m=m, relu=relu)


@winograd_conv2d.register_fake
def _(x, w, bias, scale, shift, padding, relu, m):
    return _conv_fake(x, w, 1, padding, 1)


def pool_args(kernel, stride, padding):
    """The pool ops' (kernel, stride, padding) pairs from a layer's
    arguments: stride None is the kernel (torch's MaxPool2d)."""
    return (list(to_pair(kernel)), list(to_pair(kernel if stride is None else stride)),
            list(to_pair(padding)))
