"""Per-module activation trace for debug mode (counterpart of
convnets_tpu/nn/trace.py).

Within `activation_trace(root)` every module under `root` prints, each
time its own forward runs, its path, output shape (NHWC), dtype and the
output's mean and population std in fp32, in the JAX package's line
format. The path is the root's class name, then the child names ('0', '1',
…; a Remat's 'child', which the weight paths skip). A module whose parent
computes its work without calling it (ConvBNReLU's fused kernels, the
tensors DenseBlockFused holds) prints nothing, as in the JAX package.
Forward hooks do it, each module hooked once under its first path, and
all are removed when the context ends.
"""

from __future__ import annotations

import contextlib

import torch


def _emit(printer, path, shape, dtype, mean, std):
    printer(f"[trace] {path:<44} out={shape!s:<22} {dtype:<9} "
            f"mean={float(mean):+.4e} std={float(std):.4e}")


@contextlib.contextmanager
def activation_trace(root: torch.nn.Module, printer=print):
    """Scope in which every module under `root` prints its output stats."""
    handles, seen = [], set()

    def hook(path):
        def report(module, inputs, out):
            y = out[0] if isinstance(out, tuple) else out
            if isinstance(y, torch.Tensor):
                yf = y.detach().float()
                _emit(printer, path, tuple(int(d) for d in y.shape),
                      str(y.dtype).replace("torch.", ""), yf.mean(), yf.std(correction=0))
        return report

    def wrap(mod, path):
        if id(mod) in seen:
            return
        seen.add(id(mod))
        handles.append(mod.register_forward_hook(hook(path)))
        for name, child in mod.named_children():
            wrap(child, f"{path}/{name}")

    wrap(root, type(root).__name__)
    try:
        yield root
    finally:
        for h in handles:
            h.remove()
