"""FLOP / MFU accounting: the roofline numerator and denominator of a path
(the counterpart of tpu_rvc/utils/roofline.py, with its names and fields).

FLOPs are those of one call of the path at its shapes: the products
`torch.utils.flop_counter.FlopCounterMode` counts (matmuls and
convolutions, 2 per multiply-add; elementwise work is not counted), plus
two things it cannot see:
  * the hand-written kernels, launched through ctypes, which no dispatch
    mode sees.  The call runs inside `ops/kernels/counts.counting()`, where
    each wrapper adds its formula (what `FlopCounterMode` counts over its
    plain twin at the same shapes) and returns zeros, so the count is the
    same whichever device runs the call, and is what the JAX package's
    count traces: the dense formulation in place of the kernel;
  * the recurrent layers, which reach it as cuDNN's `_cudnn_rnn` on the
    card and as oneDNN's `mkldnn_rnn_layer` (the LSTM) on the CPU, neither
    in its table (`aten.lstm` and `aten.gru` decompose before a dispatch
    mode sees them): 2 * 4H * (I + H) per step, layer and direction for
    an LSTM, 3H for a GRU, read off the weights' shapes, as XLA counts the
    JAX nets' products.  RMVPE's GRU is a kernel wrapper
    (`ops/kernels/bigru.py`), whose `bigru_flops` is this GRU formula.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from tpu_rvc_torch.ops.kernels.counts import counting

# Dense peak TFLOP/s per dtype, keyed by `torch.cuda.get_device_name`
# prefix; override with TPU_RVC_PEAK_TFLOPS for a card not listed.  The
# "NVIDIA H100 80GB HBM3" is the SXM part: bf16 989.4 on the tensor cores;
# fp32 164.9, the 3xTF32 rate (TF32's 494.7 over 3 products) that the
# kernels run at and no fp32 path of the port can pass.
PEAK_TFLOPS = (
    ("NVIDIA H100 80GB HBM3", {torch.bfloat16: 989.4, torch.float16: 989.4,
                               torch.float32: 164.9}),
)


def device_peak_tflops(dtype: torch.dtype = torch.float32,
                       device=None) -> Optional[float]:
    """The peak of `device` (default: the current card) for `dtype`, or
    None on the CPU, for a card or dtype the table lacks."""
    env = os.environ.get("TPU_RVC_PEAK_TFLOPS")
    if env:
        return float(env)
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    for prefix, peaks in PEAK_TFLOPS:
        if name.startswith(prefix):
            return peaks.get(dtype)
    return None


def _rnn_rows(input_shape) -> int:
    """Time steps x batch rows of an RNN input, (T, B, I) or (B, T, I), or
    (rows, I) packed."""
    return math.prod(input_shape) // input_shape[-1]


def _cudnn_rnn_flops(input, weight, weight_stride0, *args, out_shape=None,
                     **kwargs) -> int:
    """`aten._cudnn_rnn`: `weight` holds w_ih, w_hh (and the biases)
    for each layer and direction, `weight_stride0` tensors apart."""
    per_row = sum(math.prod(weight[i]) + math.prod(weight[i + 1])
                  for i in range(0, len(weight), weight_stride0))
    return 2 * _rnn_rows(input) * per_row


def _mkldnn_rnn_layer_flops(input, w_ih, w_hh, *args, out_shape=None,
                            **kwargs) -> int:
    """`aten.mkldnn_rnn_layer`: one layer in one direction."""
    return 2 * _rnn_rows(input) * (math.prod(w_ih) + math.prod(w_hh))


RNN_FLOPS = {torch.ops.aten._cudnn_rnn: _cudnn_rnn_flops,
             torch.ops.aten.mkldnn_rnn_layer: _mkldnn_rnn_layer_flops}


def graph_flops(fn, *args) -> float:
    """Total FLOPs of one call `fn(*args)`, which runs once: under
    `FlopCounterMode` (with the RNN formulas) and inside the kernels'
    counting context, so its kernels return zeros and launch nothing.
    Where the JAX function returns None after a failed lowering, this one
    raises what the call raised."""
    with counting() as kernels, \
            FlopCounterMode(display=False, custom_mapping=RNN_FLOPS) as dense:
        fn(*args)
    return float(dense.get_total_flops() + kernels.total())


def mfu_fields(flops: Optional[float], seconds: float,
               peak_tflops: Optional[float] = None,
               prefix: str = "") -> Dict[str, Any]:
    """The three roofline fields every artifact block carries.

    seconds is the wall of one item; peak_tflops defaults to
    `device_peak_tflops()` (fp32, the current card)."""
    if peak_tflops is None:
        peak_tflops = device_peak_tflops()
    out: Dict[str, Any] = {prefix + "flops_per_item": flops}
    if flops is None or seconds <= 0:
        out[prefix + "achieved_tflops"] = None
        out[prefix + "mfu_pct"] = None
        return out
    achieved = flops / seconds / 1e12
    out[prefix + "achieved_tflops"] = round(achieved, 3)
    out[prefix + "mfu_pct"] = (round(100.0 * achieved / peak_tflops, 2)
                               if peak_tflops else None)
    return out
