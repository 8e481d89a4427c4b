"""tpu_rvc_torch's CUDA kernels against their plain twins, on the card.

Skipped without a CUDA card.  This file imports no JAX, so on a machine
without JAX it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpu_rvc_torch.core.device import fp32_math
from tpu_rvc_torch.ops.kernels import (banded_rel_attention,
                                       banded_rel_attention_plain,
                                       fused_resblock, fused_stage,
                                       launch_counts, reset_launch_counts,
                                       stage_plain)

from _torch_inputs import W, attn_inputs, stage_inputs, stage_weights


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    with fp32_math():
        yield torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1598, 77])
def test_rel_attention_kernel_matches_plain(rng, cuda, T):
    """rtol/atol 1e-4 (fp32, other summation order)."""
    q, k, v, ek, ev, lens = attn_inputs(rng, 4, T, 96, [T, T - 13, T // 2, 5])
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, ek, ev, lens)]
    reset_launch_counts()
    got = banded_rel_attention(*args, W)
    assert launch_counts["banded_rel_attention"] == 1
    want = banded_rel_attention_plain(*args, W)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("C,T,ks", [(256, 1000, (3, 7, 11)),
                                    (32, 5000, (3, 7, 11)),
                                    (16, 900, (3, 7, 11)),
                                    (64, 50, (3, 7, 11)), (64, 3000, (7,))])
def test_stage_kernel_matches_plain(rng, cuda, C, T, ks):
    """rtol 1e-3, atol 1e-4: 18 chained fp32 convs summed in another
    order than cuDNN's.  C = 16 is the v1 presets' last stage."""
    x, ws, bs = stage_inputs(rng, C, T, ks)
    sw = stage_weights(ws, bs, ks, cuda)
    xt = torch.from_numpy(x.T.copy()).to(cuda)
    name = "fused_resblock" if len(ks) == 1 else "fused_stage"
    reset_launch_counts()
    got = (fused_resblock if len(ks) == 1 else fused_stage)(xt, sw)
    assert launch_counts[name] == 6 * len(ks)
    torch.testing.assert_close(got, stage_plain(xt, sw), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(rng, cuda):
    q, k, v, ek, ev, lens = attn_inputs(rng, 2, 40, 96, [40, 30])
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, ek, ev, lens)]
    with pytest.raises(ValueError, match="lengths must be"):
        banded_rel_attention(*args[:5], args[5].long(), W)
    with pytest.raises(ValueError, match="contiguous"):
        banded_rel_attention(args[0].transpose(1, 2).contiguous()
                             .transpose(1, 2), *args[1:], W)
    x, ws, bs = stage_inputs(rng, 24, 100, (3,))
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_resblock(torch.from_numpy(x.T.copy()).to(cuda),
                       stage_weights(ws, bs, (3,), cuda))
