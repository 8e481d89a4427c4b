"""ResBlock1 stage: CUDA kernels K2/K3 and their plain twin.

Port of tpu_rvc/ops/pallas/resblock.py: `fused_stage` (the mean of
n_rb ResBlock1s of one decoder upsample level) and `fused_resblock`
(one ResBlock1).  Both launch the same kernel, `csrc/resblock.cu`, once
per conv of the chain: 18 launches for the stock 3-resblock stage, 6 for
a single resblock.  Activations are channel-first (C, T) rows with
B = 1; weights are relaid once per module to (K, C_in, C_out) by
`stage_weights`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .counts import launch_counts

LRELU_SLOPE = 0.1
_fn = None


@dataclass(frozen=True)
class StageWeights:
    """One stage's conv weights in the kernel layout.  For resblock r and
    dilation m, `w[r][2m]`/`w[r][2m+1]` are conv1/conv2 as (K, C_in, C_out)
    contiguous tensors and `b[r][...]` their (C,) biases."""

    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[int, ...]
    w: Tuple[Tuple[torch.Tensor, ...], ...]
    b: Tuple[Tuple[torch.Tensor, ...], ...]


def stage_weights(resblocks: Sequence[torch.nn.Module]) -> StageWeights:
    """Relayout the (C_out, C_in, K) conv weights of ResBlock1 modules
    (`convs1`/`convs2`) for the kernel.  Call once and keep the result."""
    ws, bs = [], []
    dil = tuple(resblocks[0].dilation)
    for rb in resblocks:
        if tuple(rb.dilation) != dil:
            raise ValueError("fused_stage: resblocks must share dilations")
        w_r, b_r = [], []
        for c1, c2 in zip(rb.convs1, rb.convs2):
            for conv in (c1, c2):
                w_r.append(conv.weight.detach().permute(2, 1, 0).contiguous())
                b_r.append(conv.bias.detach().contiguous())
        ws.append(tuple(w_r))
        bs.append(tuple(b_r))
    return StageWeights(tuple(rb.kernel_size for rb in resblocks), dil,
                        tuple(ws), tuple(bs))


def stage_plain(x: torch.Tensor, sw: StageWeights) -> torch.Tensor:
    """The stage in plain PyTorch: x (C, T) -> mean_r ResBlock1_r(x).
    F.conv1d zero-pads the true length T, which is the kernel's mask:
    rows outside [0, T) are zero before every conv, the intermediate
    included."""
    acc = None
    for r, K in enumerate(sw.kernel_sizes):
        cur = x[None]
        for m, d in enumerate(sw.dilations):
            w1, w2 = sw.w[r][2 * m], sw.w[r][2 * m + 1]
            b1, b2 = sw.b[r][2 * m], sw.b[r][2 * m + 1]
            t = F.leaky_relu(cur, LRELU_SLOPE)
            t = F.conv1d(t, w1.permute(2, 1, 0), b1,
                         padding=(K - 1) // 2 * d, dilation=d)
            t = F.leaky_relu(t, LRELU_SLOPE)
            t = F.conv1d(t, w2.permute(2, 1, 0), b2, padding=(K - 1) // 2)
            cur = cur + t
        acc = cur if acc is None else acc + cur
    return (acc * (1.0 / len(sw.kernel_sizes)))[0]


def _kernel():
    global _fn
    if _fn is None:
        from .build import load
        fn = load("resblock").resblock_conv_f32
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x: torch.Tensor, sw: StageWeights) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_stage: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("fused_stage: x must be a contiguous float32 (C, T) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    C = x.shape[0]
    if C % 16 != 0:
        raise ValueError(f"fused_stage: C={C} must be a multiple of 16")
    for r, K in enumerate(sw.kernel_sizes):
        if K % 2 == 0:
            raise ValueError(f"fused_stage: even kernel size {K}")
        for w, b in zip(sw.w[r], sw.b[r]):
            if w.device != x.device or w.dtype != torch.float32 or \
                    tuple(w.shape) != (K, C, C) or not w.is_contiguous() or \
                    b.device != x.device or tuple(b.shape) != (C,) or \
                    b.dtype != torch.float32 or not b.is_contiguous():
                raise ValueError("fused_stage: weights must be contiguous "
                                 f"float32 ({K}, {C}, {C}) on {x.device}")


def _launch(x: torch.Tensor, sw: StageWeights, counter: str) -> torch.Tensor:
    """Two launches per (resblock, dilation) pair: u = lrelu(conv1(lrelu
    (x)) + b1), then x + conv2(u) + b2 into the next x and/or the stage
    output."""
    _check(x, sw)
    C, T = x.shape
    fn = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty_like(x)
    u = torch.empty_like(x)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    n_rb, n_d = len(sw.kernel_sizes), len(sw.dilations)

    def conv(src, w, b, res, dst, K, d, in_lrelu, out_lrelu, acc_mode):
        rc = fn(src.data_ptr(), w.data_ptr(), b.data_ptr(),
                0 if res is None else res.data_ptr(),
                0 if dst is None else dst.data_ptr(), out.data_ptr(), C, T,
                K, d, in_lrelu, out_lrelu, acc_mode, 1.0 / n_rb, stream)
        if rc != 0:
            raise RuntimeError(f"{counter}: CUDA error {rc}")
        launch_counts[counter] += 1

    for r, K in enumerate(sw.kernel_sizes):
        src = x
        for m, d in enumerate(sw.dilations):
            last = m == n_d - 1
            dst = None if last else bufs[m % 2]
            conv(src, sw.w[r][2 * m], sw.b[r][2 * m], None, u, K, d, 1, 1, 0)
            conv(u, sw.w[r][2 * m + 1], sw.b[r][2 * m + 1], src, dst, K, 1,
                 0, 0, 0 if not last else (1 if r == 0 else 2))
            src = dst
    return out


def fused_stage(x: torch.Tensor, sw: StageWeights) -> torch.Tensor:
    """mean_r ResBlock1_r(x) for x (C, T).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (two launches per resblock and
    dilation) or raise."""
    if x.device.type == "cpu":
        return stage_plain(x, sw)
    return _launch(x, sw, "fused_stage")


def fused_resblock(x: torch.Tensor, sw: StageWeights) -> torch.Tensor:
    """One ResBlock1 (the n_rb = 1 stage) for x (C, T)."""
    if len(sw.kernel_sizes) != 1:
        raise ValueError("fused_resblock takes one resblock's weights")
    if x.device.type == "cpu":
        return stage_plain(x, sw)
    return _launch(x, sw, "fused_resblock")
