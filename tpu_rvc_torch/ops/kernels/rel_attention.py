"""Banded relative-position attention: CUDA kernel K1 and its plain twin.

Port of tpu_rvc/ops/pallas/rel_attention.py (`banded_rel_attention`).
The kernel is `csrc/rel_attention.cu`: one pass with an online softmax,
both products on the tensor cores as 3xTF32 (`mma.sync`, fp32-accurate,
see `tf32.py`), K and V streamed through shared memory where the TPU
kernel kept them resident.  At the encoder's shape the call is 1.8 GFLOP,
0.011 ms at the 3xTF32 peak: what decides its time on the H100 is how
long one warp's instruction stream is and how many SMs the call fills,
which is what the kernel's layout (16 query rows a warp, the keys of a
block split over two warp pairs) is about.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .counts import launch_counts

HEAD_WIDTHS = (32, 64, 96, 128)  # dk the kernel is built for
MAX_WINDOW = 16
_fn = None


def banded_rel_attention_plain(q, k, v, emb_rel_k, emb_rel_v, lengths,
                               window: int = 10):
    """The kernel's function in plain PyTorch, with explicit banded
    scatter/gather.  q/k/v: (BH, T, dk); emb_rel_*: (2W+1, dk); lengths:
    (BH,) true key lengths.  Keys j >= length are SET to -1e4; padded query
    rows keep a softmax over the keys, as the Pallas kernel does."""
    BH, T, dk = q.shape
    W = window
    qs = q * (1.0 / math.sqrt(dk))
    scores = qs @ k.transpose(1, 2)                      # (BH, T, T)
    band = qs @ emb_rel_k.t()                            # (BH, T, 2W+1)
    rows = torch.arange(T, device=q.device)[:, None]
    cols = rows + torch.arange(-W, W + 1, device=q.device)[None, :]
    valid = (cols >= 0) & (cols < T)
    cols_c = cols.clamp(0, T - 1).expand(BH, T, 2 * W + 1)
    scores = scores.scatter_add(2, cols_c,
                                torch.where(valid, band, torch.zeros_like(band)))
    keys = torch.arange(T, device=q.device)[None, None, :]
    lens = lengths.to(q.device).reshape(-1, 1, 1)
    scores = torch.where(keys < lens, scores, torch.full_like(scores, -1e4))
    p = torch.softmax(scores, dim=-1)
    out = p @ v
    rel_w = torch.where(valid, torch.gather(p, 2, cols_c),
                        torch.zeros((), dtype=p.dtype, device=p.device))
    return out + rel_w @ emb_rel_v


def _kernel():
    global _fn
    if _fn is None:
        from .build import load
        fn = load("rel_attention").banded_rel_attention_3xtf32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def banded_rel_attention(q, k, v, emb_rel_k, emb_rel_v, lengths,
                         window: int = 10):
    """(BH, T, dk) fused attention.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return banded_rel_attention_plain(q, k, v, emb_rel_k, emb_rel_v,
                                          lengths, window)
    if q.device.type != "cuda":
        raise ValueError(f"banded_rel_attention: unsupported device {q.device}")
    BH, T, dk = q.shape
    nb = 2 * window + 1
    for name, t, shape in (("q", q, (BH, T, dk)), ("k", k, (BH, T, dk)),
                           ("v", v, (BH, T, dk)), ("emb_rel_k", emb_rel_k,
                                                   (nb, dk)),
                           ("emb_rel_v", emb_rel_v, (nb, dk))):
        if t.device != q.device or t.dtype != torch.float32 or \
                tuple(t.shape) != shape or not t.is_contiguous() or \
                t.data_ptr() % 16 != 0:
            raise ValueError(f"banded_rel_attention: {name} must be a "
                             f"contiguous, 16-byte aligned float32 {shape} "
                             f"tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if lengths.device != q.device or lengths.dtype != torch.int32 or \
            tuple(lengths.shape) != (BH,) or not lengths.is_contiguous():
        raise ValueError("banded_rel_attention: lengths must be a contiguous "
                         f"int32 ({BH},) tensor on {q.device}")
    if dk not in HEAD_WIDTHS or window > MAX_WINDOW:
        # the kernel keeps Q and the output as register fragments, so it is
        # compiled per head width
        raise ValueError(f"banded_rel_attention: dk={dk} (one of "
                         f"{HEAD_WIDTHS}), window={window} (max "
                         f"{MAX_WINDOW}) unsupported")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   emb_rel_k.data_ptr(), emb_rel_v.data_ptr(),
                   lengths.data_ptr(), out.data_ptr(), BH, T, dk, window,
                   stream)
    if rc != 0:
        raise RuntimeError(f"banded_rel_attention: CUDA error {rc}")
    launch_counts["banded_rel_attention"] += 1
    return out
