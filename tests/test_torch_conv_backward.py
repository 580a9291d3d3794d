"""ops/kernels/conv.py:conv2d_backward on operands that are no dense NHWC
tensors: the cotangent of a conv whose output goes into a concat along C,
as DenseNet's dense layers hand it back (autograd's cat backward narrows
the concat's gradient, e.g. (2, 1, 1, 32) with strides (1024, 1024, 1024,
1)), and an input sliced out of a concat. dx and dw must equal the dense
operands' bit for bit."""

import numpy as np
import pytest
import torch

from convnets_tpu_torch.ops.kernels.conv import conv2d_backward

# (N, H, W, concat channels, slice start, Cin, Cout, k, stride, padding):
# DenseNet-121@32's last block at 1x1 (32 of 1024 channels) and a padded 3x3
CASES = [(2, 1, 1, 1024, 512, 128, 32, 1, 1, 0), (2, 4, 4, 48, 16, 8, 16, 3, 1, 1),
         (3, 5, 6, 40, 8, 12, 24, 3, 2, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_conv2d_backward_of_concat_slices_is_the_dense_operands(case, dtype):
    n, h, w, c_all, c0, cin, cout, k, s, p = case
    rng = np.random.RandomState(c_all + cin)
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    feats = torch.from_numpy(rng.randn(n, h, w, c_all).astype(np.float32)).to(dtype)
    wt = torch.from_numpy(rng.randn(k, k, cin, cout).astype(np.float32) * 0.1).to(dtype)
    other = torch.zeros(n, oh, ow, c_all - cout, dtype=dtype, requires_grad=True)
    y = torch.zeros(n, oh, ow, cout, dtype=dtype, requires_grad=True)
    cot = torch.from_numpy(rng.randn(n, oh, ow, c_all).astype(np.float32)).to(dtype)
    # the slice autograd hands a conv whose output was concatenated along C
    seen = {}
    y.register_hook(lambda g: seen.setdefault("g", g))
    torch.cat([other, y], dim=-1).backward(cot)
    g = seen["g"]
    x = feats[..., c0:c0 + cin]
    assert not x.is_contiguous() and not g.is_contiguous()
    dx, dw = conv2d_backward(x, wt, g, s, p)
    dx_ref, dw_ref = conv2d_backward(x.contiguous(), wt, g.contiguous(), s, p)
    assert dx.dtype == dw.dtype == dtype
    assert torch.equal(dx, dx_ref) and torch.equal(dw, dw_ref)
    # and they are the conv's VJP
    xr = x.float().permute(0, 3, 1, 2).detach().requires_grad_()
    wr = wt.float().permute(3, 2, 0, 1).detach().requires_grad_()
    yr = torch.nn.functional.conv2d(xr, wr, stride=s, padding=p)
    yr.backward(g.to(dtype).float().permute(0, 3, 1, 2))
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(dx.float().numpy(), xr.grad.permute(0, 2, 3, 1).numpy(),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(dw.float().numpy(), wr.grad.permute(2, 3, 1, 0).numpy(),
                               rtol=tol, atol=tol * max(1.0, float(wr.grad.abs().max())))
