"""tpu_rvc_torch kernels: the plain twins against the JAX Pallas kernels
(interpret mode on the CPU).  All fp32; tolerances stated per test.  The
CUDA kernels against the plain twins are in test_torch_cuda.py."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from tpu_rvc.nn.attention import MultiHeadRelAttention as JaxAttention
from tpu_rvc.ops.pallas.rel_attention import (
    banded_rel_attention as jax_banded)
from tpu_rvc.ops.pallas.resblock import (fused_resblock as jax_resblock,
                                         fused_stage as jax_stage)
from tpu_rvc_torch.nn.attention import MultiHeadRelAttention
from tpu_rvc_torch.nn.modules import ResBlock1
from tpu_rvc_torch.ops.kernels import (banded_rel_attention, fused_resblock,
                                       fused_stage, launch_counts,
                                       matmul_3xtf32, reset_launch_counts,
                                       stage_plain, tf32_round, tf32_split)
from tpu_rvc_torch.ops.kernels import stage_weights as module_stage_weights
from tpu_rvc_torch.ops.kernels.resblock import (pack_conv_weight,
                                                unpack_conv_weight)

from _torch_inputs import W, attn_inputs, stage_inputs, stage_weights


# ---------------------------------------------------------------------------
# K1: banded relative attention
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes, and
    torch's default pool in each of them oversubscribes the cores (this
    file's small operations ran 5-25x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ---------------------------------------------------------------------------
# 3xTF32: the split the CUDA kernels make, and the weight layout they read
# ---------------------------------------------------------------------------


def _check_split(x):
    hi, lo = tf32_split(torch.from_numpy(x))
    for part in (hi, lo):   # TF32 values: the low 13 mantissa bits are zero
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - torch.from_numpy(x).double()).abs()
    assert torch.all(err <= 2.0 ** -21 * torch.from_numpy(x).double().abs())


@pytest.mark.parametrize("scale", [1.0, 1e-30, -1e-30, 3e4, -7.5])
def test_tf32_split_is_tf32_and_exact_to_2_pow_minus_21(rng, scale):
    """hi and lo are TF32 values and hi + lo = x to 2^-21 relative, for
    normal, tiny (but normal: lo stays above the subnormals) and negative
    values; exact powers of two and zero split to (x, 0)."""
    _check_split((rng.standard_normal(4096) * scale).astype(np.float32))
    x = torch.tensor([0.0, 1.0, -2.0, 2.0 ** -100, 1.0 + 2.0 ** -11])
    hi, lo = tf32_split(x)
    assert torch.equal(hi[:4], x[:4]) and not lo[:4].any()
    # a tie rounds away from zero, as cvt.rna does
    assert hi[4] == 1.0 + 2.0 ** -10 and lo[4] == -(2.0 ** -11)


@settings(max_examples=200, deadline=None, database=None)
@given(st.floats(min_value=2.0 ** -100, max_value=2.0 ** 100, width=32),
       st.booleans())
def test_tf32_split_property(mag, negative):
    _check_split(np.asarray([-mag if negative else mag], np.float32))


def test_3xtf32_dot_is_fp32_accurate_and_one_tf32_is_not(rng):
    """256-deep dots: lo.hi + hi.lo + hi.hi summed in fp32 is within 2x of
    the plain fp32 product's error against fp64, and a single TF32 product
    (hi.hi) is more than 100x worse: the stated reason for 3xTF32."""
    a = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    err = lambda y: float((y.double() - exact).abs().max())  # noqa: E731
    e_fp32 = err(a @ b)
    e_3x = err(matmul_3xtf32(a, b))
    e_1x = err(tf32_round(a) @ tf32_round(b))
    assert e_3x <= 2 * e_fp32
    assert e_1x > 100 * e_fp32


@pytest.mark.parametrize("C,K", [(16, 3), (32, 11), (64, 7), (128, 3),
                                 (256, 3)])
def test_packed_weights_round_trip_and_follow_the_fragment_order(rng, C, K):
    """`pack_conv_weight` is a permutation (padded with zero rows below 64
    channels) that `unpack_conv_weight` inverts, and entry (chunk, tap, k8,
    m-tile, warp, lane, e) is the wgmma A fragment's element."""
    w = torch.from_numpy(rng.standard_normal((K, C, C)).astype(np.float32))
    packed = pack_conv_weight(w)
    M = max(C, 64)
    assert packed.shape == (K * M * C,)
    assert torch.equal(unpack_conv_weight(packed, K, C, C), w)
    frag = packed.reshape(C // 16, K, 2, M // 64, 4, 32, 4)
    for ch, tap, k8, mt, warp, lane, e in rng.integers(
            0, [C // 16, K, 2, M // 64, 4, 32, 4], size=(64, 7)):
        co = 64 * mt + 16 * warp + lane // 4 + 8 * (e % 2)
        ci = 16 * ch + 8 * k8 + lane % 4 + 4 * (e // 2)
        want = w[tap, co, ci] if co < C else 0.0
        assert frag[ch, tap, k8, mt, warp, lane, e] == want


def test_stage_weights_round_trip_to_the_modules(rng):
    """`stage_weights` keeps [tap][c_out][c_in] and the packed order, both
    equal to the modules' (C_out, C_in, K) weights, and the plain stage on
    them is the modules' own convs."""
    torch.manual_seed(0)
    blocks = [ResBlock1(32, k) for k in (3, 7, 11)]
    for rb in blocks:
        for conv in list(rb.convs1) + list(rb.convs2):
            conv.weight.data.normal_(0, 0.05)
            conv.bias.data.normal_(0, 0.1)
    sw = module_stage_weights(blocks)
    for r, rb in enumerate(blocks):
        convs = [c for pair in zip(rb.convs1, rb.convs2) for c in pair]
        for i, conv in enumerate(convs):
            K = rb.kernel_size
            assert sw.w[r][i].shape == (K, 32, 32)
            assert torch.equal(sw.w[r][i].permute(1, 2, 0), conv.weight)
            assert torch.equal(
                unpack_conv_weight(sw.packed[r][i], K, 32, 32)
                .permute(1, 2, 0), conv.weight)
            assert torch.equal(sw.b[r][i], conv.bias)
    x = torch.from_numpy(rng.standard_normal((32, 200)).astype(np.float32))
    want = 0
    with torch.no_grad():
        for rb in blocks:
            cur = x[None]
            for c1, c2 in zip(rb.convs1, rb.convs2):
                t = c1(torch.nn.functional.leaky_relu(cur, 0.1))
                cur = cur + c2(torch.nn.functional.leaky_relu(t, 0.1))
            want = want + cur[0] / 3
    torch.testing.assert_close(stage_plain(x, sw), want, rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the training attention's band (nn/attention.py's differentiable branch)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [12, 13, 40])
def test_band_skew_equals_clamped_scatter_and_gather(T):
    """The training attention adds its band by pads and reshapes
    (`band_to_dense`, `dense_to_band`), where the JAX branch scatters and
    gathers at clamped columns (tpu_rvc/nn/attention.py:206-225): the same
    values and the same gradients, bit for bit, fp32 and bf16."""
    from tpu_rvc_torch.nn.attention import band_to_dense, dense_to_band

    W = 10
    rng = np.random.default_rng(T)
    rows = torch.arange(T)[:, None]
    cols = rows + torch.arange(-W, W + 1)[None, :]
    valid = ((cols >= 0) & (cols < T)).float()
    cols_c = cols.clamp(0, T - 1).expand(2, 3, T, 2 * W + 1)
    for dtype in (torch.float32, torch.bfloat16):
        mk = lambda *shape: torch.from_numpy(  # noqa: E731
            rng.standard_normal(shape).astype(np.float32)).to(dtype)
        band0 = mk(2, 3, T, 2 * W + 1)
        dense0 = mk(2, 3, T, T)
        w_out = mk(2, 3, T, 2 * W + 1)
        results = []
        for skew in (False, True):
            band = band0.clone().requires_grad_()
            dense = dense0.clone().requires_grad_()
            if skew:
                scores = dense + band_to_dense(band, W)
                read = dense_to_band(scores.softmax(-1), W)
            else:
                scores = dense.scatter_add(-1, cols_c,
                                           band * valid.to(dtype))
                read = torch.gather(scores.softmax(-1), -1, cols_c) * \
                    valid.to(dtype)
            (read * w_out).float().sum().backward()
            results.append((scores, read, band.grad, dense.grad))
        for want, got in zip(*results):
            assert torch.equal(got, want)
