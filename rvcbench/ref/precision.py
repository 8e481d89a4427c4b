"""The arithmetic the reference runs in: fp32 with TF32 off (the
configuration's precision), or TF32 (the control, one step below)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


FP8_MAX = 448.0          # float8_e4m3fn's largest finite value


class _ToFP8(torch.autograd.Function):
    """x rounded to float8 e4m3 with a per-tensor scale (its amax to 448),
    the gradient passed straight through."""

    @staticmethod
    def forward(ctx, x):
        scale = torch.clamp(x.detach().abs().amax().float(), min=1e-12) / \
            FP8_MAX
        return ((x.float() / scale).to(torch.float8_e4m3fn).float()
                * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


_PRODUCTS = {torch.conv1d, torch.conv2d, torch.conv_transpose1d,
             torch.nn.functional.conv1d, torch.nn.functional.conv2d,
             torch.nn.functional.conv_transpose1d,
             torch.nn.functional.linear, torch.matmul, torch.bmm, torch.mm,
             torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__}


class fp8_products(torch.overrides.TorchFunctionMode):
    """Every matrix product and convolution takes its two operands rounded
    to float8 e4m3 (per-tensor scales), as a step computed in fp8 would;
    everything else runs as the caller's precision has it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS and len(args) >= 2:
            args = tuple(_ToFP8.apply(a) if i < 2 and torch.is_tensor(a)
                         and a.is_floating_point() else a
                         for i, a in enumerate(args))
        return func(*args, **kwargs)
