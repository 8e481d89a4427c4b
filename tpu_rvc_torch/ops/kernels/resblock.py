"""ResBlock1 stage: CUDA kernels K2/K3 and their plain twin.

Port of tpu_rvc/ops/pallas/resblock.py: `fused_stage` (the mean of
n_rb ResBlock1s of one decoder upsample level) and `fused_resblock`
(one ResBlock1).  Both launch the same kernel, `csrc/resblock.cu`, once
per conv of the chain: 18 launches for the stock 3-resblock stage, 6 for
a single resblock.  Activations are channel-first (C, T) rows with
B = 1.

On the H100 the kernel is bound by tensor-core operations at C >= 64 and
by bytes at C <= 32: every fp32 product runs as three TF32 products
(3xTF32, `tf32.py`) through `wgmma`, 165 TFLOP/s fp32-equivalent at the
peak.  The weights are its register operand: `stage_weights` keeps them
twice, as `w` in [tap][c_out][c_in] order for the plain twin, and as
`packed`, the same values in the order of the instruction's A fragment
(`pack_conv_weight`), which a thread fetches with one 16-byte load per
(tap, 8 input channels) step and splits into hi and lo in registers.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .build import RESBLOCK_CHANNELS as CHANNELS  # widths it is built for
from .counts import launch_counts

LRELU_SLOPE = 0.1
MAX_PAD = 32                       # (k - 1) / 2 * dilation at most
_fns = {}


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """(K, C_out, C_in) -> the kernel's flat fragment order
    [c_in / 16][tap][k8][m-tile][warp][lane][4]: thread (warp, lane) of a
    warpgroup holds, for m-tile mt and the 8 input channels of step k8 in
    chunk ch, W[64 mt + 16 warp + lane // 4 + 8 (e % 2),
    16 ch + 8 k8 + lane % 4 + 4 (e // 2)] for e = 0..3.  Rows are padded
    with zeros to a multiple of 64 (C_out = 16, 32), columns to one of 16."""
    K, co, ci_true = w.shape
    M, ci = -(-co // 64) * 64, -(-ci_true // 16) * 16
    wp = w.new_zeros(K, M, ci)
    wp[:, :co, :ci_true] = w
    # co = 64 mt + 16 warp + 8 e0 + r;  ci = 16 ch + 8 k8 + 4 e1 + c
    wp = wp.reshape(K, M // 64, 4, 2, 8, ci // 16, 2, 2, 4)
    #               tap mt     w  e0 r  ch       k8 e1 c
    return wp.permute(5, 0, 6, 1, 2, 4, 8, 7, 3).contiguous().reshape(-1)


def unpack_conv_weight(packed: torch.Tensor, K: int, c_out: int,
                       c_in: int) -> torch.Tensor:
    """The inverse of `pack_conv_weight`: (K, C_out, C_in)."""
    M, ci = -(-c_out // 64) * 64, -(-c_in // 16) * 16
    wp = packed.reshape(ci // 16, K, 2, M // 64, 4, 8, 4, 2, 2)
    #                   ch        tap k8 mt     w  r  c  e1 e0
    wp = wp.permute(1, 3, 4, 8, 5, 0, 2, 7, 6).reshape(K, M, ci)
    return wp[:, :c_out, :c_in].contiguous()


@dataclass(frozen=True)
class StageWeights:
    """One stage's conv weights.  For resblock r and dilation m,
    `w[r][2m]`/`w[r][2m+1]` are conv1/conv2 as (K, C_out, C_in) contiguous
    tensors ([tap][c_out][c_in]), `packed[r][...]` the same in the kernel's
    fragment order and `b[r][...]` their (C,) biases."""

    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[int, ...]
    w: Tuple[Tuple[torch.Tensor, ...], ...]
    b: Tuple[Tuple[torch.Tensor, ...], ...]
    packed: Tuple[Tuple[torch.Tensor, ...], ...]


def pack_stage(kernel_sizes: Sequence[int], dilations: Sequence[int],
               w: Sequence[Sequence[torch.Tensor]],
               b: Sequence[Sequence[torch.Tensor]]) -> StageWeights:
    """StageWeights from (K, C_out, C_in) weights and (C,) biases."""
    w = tuple(tuple(t.contiguous() for t in w_r) for w_r in w)
    b = tuple(tuple(t.contiguous() for t in b_r) for b_r in b)
    packed = tuple(tuple(pack_conv_weight(t) for t in w_r) for w_r in w)
    return StageWeights(tuple(kernel_sizes), tuple(dilations), w, b, packed)


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
                w_r.append(conv.weight.detach().permute(2, 0, 1))
                b_r.append(conv.bias.detach())
        ws.append(w_r)
        bs.append(b_r)
    return pack_stage(tuple(rb.kernel_size for rb in resblocks), dil, ws, bs)


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
            t = F.conv1d(t, w1.permute(1, 2, 0), b1,
                         padding=(K - 1) // 2 * d, dilation=d)
            t = F.leaky_relu(t, LRELU_SLOPE)
            t = F.conv1d(t, w2.permute(1, 2, 0), b2, padding=(K - 1) // 2)
            cur = cur + t
        acc = cur if acc is None else acc + cur
    return (acc * (1.0 / len(sw.kernel_sizes)))[0]


def _kernel(C: int):
    """The conv launcher of the library built for width C."""
    if C not in _fns:
        from .build import load
        fn = load(f"resblock_c{C}").resblock_conv_3xtf32
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[C] = fn
    return _fns[C]


def _check(x: torch.Tensor, sw: StageWeights) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_stage: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("fused_stage: x must be a contiguous float32 (C, T) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    C = x.shape[0]
    if C not in CHANNELS:
        raise ValueError(f"fused_stage: C={C} must be one of {CHANNELS}")
    for r, K in enumerate(sw.kernel_sizes):
        if K % 2 == 0:
            raise ValueError(f"fused_stage: even kernel size {K}")
        if (K - 1) // 2 * max(sw.dilations) > MAX_PAD:
            raise ValueError(f"fused_stage: kernel size {K} with dilations "
                             f"{sw.dilations} pads more than {MAX_PAD}")
        for p, b in zip(sw.packed[r], sw.b[r]):
            if p.device != x.device or p.dtype != torch.float32 or \
                    p.numel() != K * max(C, 64) * C or \
                    not p.is_contiguous() or \
                    b.device != x.device or tuple(b.shape) != (C,) or \
                    b.dtype != torch.float32 or not b.is_contiguous():
                raise ValueError("fused_stage: weights must be packed "
                                 f"float32 ({K}, {C}, {C}) on {x.device}")


def _launch(x: torch.Tensor, sw: StageWeights, counter: str) -> torch.Tensor:
    """Two launches per (resblock, dilation) pair: u = lrelu(conv1(lrelu
    (x)) + b1), then x + conv2(u) + b2 into the next x and/or the stage
    output."""
    _check(x, sw)
    C, T = x.shape
    fn = _kernel(C)
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
            conv(src, sw.packed[r][2 * m], sw.b[r][2 * m], None, u, K, d,
                 1, 1, 0)
            conv(u, sw.packed[r][2 * m + 1], sw.b[r][2 * m + 1], src, dst,
                 K, 1, 0, 0, 0 if not last else (1 if r == 0 else 2))
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
