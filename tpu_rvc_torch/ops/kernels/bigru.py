"""RMVPE's bidirectional GRU: the persistent CUDA kernel and its plain twin.

Replaces no TPU kernel: the JAX package runs both directions in one
`lax.scan` (tpu_rvc/models/rmvpe.py `_bigru_fused`), and the port handed
the recurrence to cuDNN's GRU, which at batch 1 queues two small kernels
a frame and direction.  Here the input projection of both directions is
one fp32 product, x @ [W_ih_f; W_ih_b]^T + b_ih, as cuDNN and the JAX
package hoist it, and `csrc/bigru.cu` runs the whole T-step recurrence of
both directions in one launch (one 8-CTA cluster a direction and slice of
rows, W_hh in registers, h exchanged through distributed shared memory).
Forward only, like the other wrappers.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_rvc_torch.core.device import fp32_math
from .counts import active_count, launch_counts, launch_device, refuse_grad

HIDDEN = 256  # the width the kernel is built for (RMVPE's 384 -> 2 x 256)
_fn = None


def _params(gru: torch.nn.GRU):
    return (gru.weight_ih_l0, gru.weight_ih_l0_reverse, gru.bias_ih_l0,
            gru.bias_ih_l0_reverse, gru.weight_hh_l0,
            gru.weight_hh_l0_reverse, gru.bias_hh_l0, gru.bias_hh_l0_reverse)


def _projection(x: torch.Tensor, gru: torch.nn.GRU) -> torch.Tensor:
    """gi (B, T, 2, 3H): both directions' input gates in one product, in
    x's precision whatever autocast is on (the kernel reads fp32)."""
    B, T, I = x.shape
    w_f, w_b, b_f, b_b = _params(gru)[:4]
    with fp32_math(), torch.autocast(x.device.type, enabled=False):
        gi = torch.addmm(torch.cat([b_f, b_b]), x.reshape(B * T, I),
                         torch.cat([w_f, w_b]).t())
    return gi.view(B, T, 2, -1)


def bigru_plain(x: torch.Tensor, gru: torch.nn.GRU) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the hoisted projection,
    then one loop over T for both directions (the backward one on the
    time-flipped gates) in torch's gate order r, z, n, which is
    `_bigru_fused`'s math.  x (B, T, I) -> (B, T, 2H), nn.GRU's layout."""
    B, H = x.shape[0], gru.hidden_size
    gi = _projection(x, gru)
    gi = torch.stack([gi[:, :, 0], gi[:, :, 1].flip(1)])   # (2, B, T, 3H)
    gi_rz, gi_n = gi[..., :2 * H].unbind(2), gi[..., 2 * H:].unbind(2)
    wh = torch.stack([gru.weight_hh_l0, gru.weight_hh_l0_reverse])
    wh = wh.transpose(1, 2)                                # (2, H, 3H)
    bh = torch.stack([gru.bias_hh_l0, gru.bias_hh_l0_reverse])[:, None]
    h = x.new_zeros(2, B, H)
    ys = []
    for g_rz, g_n in zip(gi_rz, gi_n):   # few ops a step: the CPU's path
        gh = torch.baddbmm(bh, h, wh)
        r, z = torch.sigmoid(g_rz + gh[..., :2 * H]).chunk(2, -1)
        n = torch.tanh(torch.addcmul(g_n, r, gh[..., 2 * H:]))
        h = torch.lerp(n, h, z)                            # (1 - z) n + z h
        ys.append(h)
    ys = torch.stack(ys, 2)                                # (2, B, T, H)
    return torch.cat([ys[0], ys[1].flip(1)], -1)


def bigru_flops(B: int, T: int, in_features: int, hidden: int = HIDDEN
                ) -> int:
    """The operations of one call, as `utils/roofline.py`'s
    `_cudnn_rnn_flops` counts cuDNN's GRU: 2 * 3H * (I + H) a row, step
    and direction, the input projection and the recurrence."""
    return 2 * B * T * 2 * 3 * hidden * (in_features + hidden)


def _kernel():
    global _fn
    if _fn is None:
        from .build import load
        fn = load("bigru").bigru_fp32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x: torch.Tensor, gru: torch.nn.GRU) -> None:
    if gru.hidden_size != HIDDEN:
        raise ValueError(f"bigru: the kernel takes hidden size {HIDDEN}, "
                         f"got {gru}")
    if x.dim() != 3 or x.shape[0] < 1 or x.shape[1] < 1 or \
            x.shape[2] != gru.input_size or x.dtype != torch.float32:
        raise ValueError(f"bigru: x must be a float32 (B, T, "
                         f"{gru.input_size}) tensor with B, T >= 1, got "
                         f"{x.dtype} {tuple(x.shape)}")
    for p in _params(gru):
        if p.device != x.device or p.dtype != torch.float32 or \
                not p.is_contiguous() or p.data_ptr() % 16 != 0:
            raise ValueError("bigru: the GRU's parameters must be contiguous, "
                             f"16-byte aligned float32 tensors on {x.device}, "
                             f"got {p.dtype} on {p.device}")


def bigru(x: torch.Tensor, gru: torch.nn.GRU) -> torch.Tensor:
    """`gru(x)[0]` of a one-layer bidirectional batch-first GRU, forward
    only: x (B, T, I) -> (B, T, 512).  CPU tensors take `bigru_plain`;
    CUDA tensors launch the kernel or raise; inside `counts.counting()` it
    counts `bigru_flops` and returns zeros.  Raises on any device when
    grad mode is on and an input requires grad (`refuse_grad`)."""
    refuse_grad("bigru", x, *gru.parameters())
    if not (gru.num_layers == 1 and gru.bidirectional and gru.bias and
            gru.batch_first):
        raise ValueError("bigru: a one-layer bidirectional batch-first GRU "
                         f"with biases, got {gru}")
    count = active_count()
    if count is not None:
        B, T, I = x.shape
        count.add("bigru", bigru_flops(B, T, I, gru.hidden_size), 1)
        return x.new_zeros(B, T, 2 * gru.hidden_size)
    if x.device.type == "cpu":
        return bigru_plain(x, gru)
    if x.device.type != "cuda":
        raise ValueError(f"bigru: unsupported device {x.device}")
    _check(x, gru)
    B, T, _ = x.shape
    gi = _projection(x, gru)
    y = torch.empty(B, T, 2 * HIDDEN, device=x.device)
    wf, wb, bf, bb = _params(gru)[4:]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with launch_device(x):
        rc = _kernel()(gi.data_ptr(), wf.data_ptr(), wb.data_ptr(),
                       bf.data_ptr(), bb.data_ptr(), y.data_ptr(), B, T,
                       stream)
    if rc != 0:
        raise RuntimeError(f"bigru: CUDA error {rc}")
    launch_counts["bigru"] += 1
    return y
