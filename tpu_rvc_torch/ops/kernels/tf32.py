"""3xTF32 in plain PyTorch: the split the CUDA kernels make in registers.

A TF32 value is an fp32 value whose low 13 mantissa bits are zero.  The
tensor cores truncate their fp32 inputs to it, so one TF32 product keeps
about 10 bits.  The kernels keep fp32 accuracy by splitting each operand
into `hi = tf32(x)` and `lo = tf32(x - hi)` and summing
`lo.hi + hi.lo + hi.hi` in fp32 (the `lo.lo` term, about 2^-22 relative,
is dropped): three tensor-core products for one fp32 product.  These
functions state that arithmetic where the CPU tests can reach it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> nearest TF32 value, ties away from zero (`cvt.rna.tf32.f32`):
    add half a TF32 unit to the magnitude bits and clear the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo), both TF32 values, hi + lo = x to 2^-21 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels form it: small terms first, fp32 sums."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
