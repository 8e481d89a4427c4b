"""Seeded numpy inputs for the tpu_rvc_torch kernel tests.  Imports no JAX,
so the CUDA tests that use it also run where JAX is not installed."""

import numpy as np
import torch

from tpu_rvc_torch.ops.kernels.resblock import pack_stage

W = 10


def attn_inputs(rng, BH, T, dk, lengths):
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (arr(BH, T, dk), arr(BH, T, dk), arr(BH, T, dk),
            arr(2 * W + 1, dk) * dk ** -0.5, arr(2 * W + 1, dk) * dk ** -0.5,
            np.asarray(lengths, np.int32))


def gru_inputs(rng, B, T, device="cpu"):
    """RMVPE's GRU (384 -> 2 x 256) at torch's initialisation from a seed,
    and an input (B, T, 384) of unit scale."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(rng.integers(2 ** 31)))
        gru = torch.nn.GRU(384, 256, batch_first=True, bidirectional=True)
    x = torch.from_numpy(rng.standard_normal((B, T, 384)).astype(np.float32))
    return gru.eval().to(device), x.to(device)


def stage_inputs(rng, C, T, ks):
    x = rng.standard_normal((T, C)).astype(np.float32) * 0.3
    ws = [rng.standard_normal((k, C, C)).astype(np.float32) * 0.05
          for k in ks for _ in range(6)]
    bs = [rng.standard_normal((C,)).astype(np.float32) * 0.1
          for _ in ks for _ in range(6)]
    return x, ws, bs


def stage_weights(ws, bs, ks, device="cpu"):
    """`ws` are (K, C_in, C_out), the JAX kernels' layout; the port keeps
    (K, C_out, C_in)."""
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return pack_stage(ks, (1, 3, 5),
                      [[t(w.transpose(0, 2, 1).copy())
                        for w in ws[6 * r:6 * r + 6]] for r in range(len(ks))],
                      [[t(b) for b in bs[6 * r:6 * r + 6]]
                       for r in range(len(ks))])
