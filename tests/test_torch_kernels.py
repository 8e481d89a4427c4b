"""tpu_rvc_torch kernels: the plain twins against the JAX Pallas kernels
(interpret mode on the CPU).  All fp32; tolerances stated per test.  The
CUDA kernels against the plain twins are in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_rvc.nn.attention import MultiHeadRelAttention as JaxAttention
from tpu_rvc.ops.pallas.rel_attention import (
    banded_rel_attention as jax_banded)
from tpu_rvc.ops.pallas.resblock import (fused_resblock as jax_resblock,
                                         fused_stage as jax_stage)
from tpu_rvc_torch.nn.attention import MultiHeadRelAttention
from tpu_rvc_torch.ops.kernels import (banded_rel_attention, fused_resblock,
                                       fused_stage, launch_counts,
                                       reset_launch_counts)

from _torch_inputs import W, attn_inputs, stage_inputs, stage_weights


# ---------------------------------------------------------------------------
# K1: banded relative attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [64, 70])
def test_rel_attention_plain_matches_pallas_interpret(rng, T):
    """All rows, mixed lengths, T a multiple of the 32-row q tile and
    not.  rtol/atol 1e-5: the same fp32 math in another summation order."""
    q, k, v, ek, ev, lens = attn_inputs(rng, 4, T, 24, [T, T - 13, 20, 1])
    want = jax_banded.__wrapped__(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ek),
        jnp.asarray(ev), jnp.asarray(lens), window=W, q_tile=32,
        interpret=True)
    t = torch.from_numpy
    got = banded_rel_attention(t(q), t(k), t(v), t(ek), t(ev), t(lens), W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_rel_attention_plain_matches_xla_path_on_valid_rows(rng):
    """The port's attention module (plain K1) against the JAX module's XLA
    banded path: equal on valid rows (atol 1e-5); the XLA path masks
    padded query rows as whole rows, the kernel does not."""
    B, T, C = 2, 40, 32
    lens = np.asarray([T, T - 13], np.int32)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    attn_mask = mask[:, None, :, None] * mask[:, None, None, :]
    mod = JaxAttention(C, C, 2, W)
    params = mod.init(jax.random.PRNGKey(3), jnp.asarray(x),
                      jnp.asarray(attn_mask))
    want = np.asarray(mod.apply(params, jnp.asarray(x),
                                jnp.asarray(attn_mask)))
    port = MultiHeadRelAttention(C, C, 2, W)
    p = params["params"]
    sd = {}
    for nm in ("conv_q", "conv_k", "conv_v", "conv_o"):
        sd[f"{nm}.weight"] = torch.from_numpy(
            np.asarray(p[nm]["kernel"]).transpose(2, 1, 0).copy())
        sd[f"{nm}.bias"] = torch.tensor(np.asarray(p[nm]["bias"]))
    sd["emb_rel_k"] = torch.tensor(np.asarray(p["emb_rel_k"]))
    sd["emb_rel_v"] = torch.tensor(np.asarray(p["emb_rel_v"]))
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    for b in range(B):
        np.testing.assert_allclose(got[b, :lens[b]], want[b, :lens[b]],
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K2 / K3: ResBlock1 stage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [700, 50])
def test_stage_plain_matches_pallas_interpret(rng, T):
    """Three resblocks k = 3/7/11 and their mean; T = 50 is below the
    k = 11 halo of 60.  rtol 1e-4, atol 1e-5 (18 chained fp32 convs)."""
    ks = (3, 7, 11)
    x, ws, bs = stage_inputs(rng, 64, T, ks)
    want = jax_stage.__wrapped__(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, bs)), kernel_sizes=ks, interpret=True)
    got = fused_stage(torch.from_numpy(x.T.copy()),
                      stage_weights(ws, bs, ks))
    np.testing.assert_allclose(got.numpy().T, np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("K", [7, 11])
def test_resblock_plain_matches_pallas_interpret(rng, K):
    """One ResBlock1 (the kernel's n_rb = 1 case).  rtol 1e-4, atol 1e-5."""
    x, ws, bs = stage_inputs(rng, 32, 300, (K,))
    want = jax_resblock.__wrapped__(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, bs)), kernel_size=K, interpret=True)
    got = fused_resblock(torch.from_numpy(x.T.copy()),
                         stage_weights(ws, bs, (K,)))
    np.testing.assert_allclose(got.numpy().T, np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_cpu_tensors_never_launch(rng):
    """CPU tensors take the plain versions: no launch is counted."""
    reset_launch_counts()
    q, k, v, ek, ev, lens = attn_inputs(rng, 2, 30, 16, [30, 12])
    t = torch.from_numpy
    banded_rel_attention(t(q), t(k), t(v), t(ek), t(ev), t(lens), W)
    x, ws, bs = stage_inputs(rng, 16, 80, (3, 7, 11))
    fused_stage(t(x.T.copy()), stage_weights(ws, bs, (3, 7, 11)))
    x, ws, bs = stage_inputs(rng, 16, 80, (3,))
    fused_resblock(t(x.T.copy()), stage_weights(ws, bs, (3,)))
    assert launch_counts == {"banded_rel_attention": 0, "fused_stage": 0,
                             "fused_resblock": 0}


def test_wrappers_reject_other_devices(rng):
    q, k, v, ek, ev, lens = attn_inputs(rng, 1, 16, 8, [16])
    meta = lambda a: torch.empty(a.shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        banded_rel_attention(meta(q), meta(k), meta(v), meta(ek), meta(ev),
                             torch.from_numpy(lens), W)
    x, ws, bs = stage_inputs(rng, 8, 40, (3,))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_resblock(meta(x.T), stage_weights(ws, bs, (3,)))
