"""tpu_rvc_torch's synthesizer and its modules against their tpu_rvc (JAX)
counterparts on the CPU: the same seeded numpy inputs and the same weights
(carried across by `synthesizer_state_from_jax`) through both, fp32,
tolerances stated per test.  Also the traps of the port (floor-mod phase
wrap, the two leaky-ReLU slopes, half-to-even rounding, the transposed-conv
flip), the device rule and the package's isolation from JAX.  (The presets
are in tests/test_torch_config.py; HuBERT, pm f0, retrieval and
resampling in tests/test_torch_frontend.py.)"""

import functools
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_rvc.ckpt.convert import state_dict_from_synthesizer_params
from tpu_rvc.f0.device import post_process_jax
from tpu_rvc.models.synthesizer import Synthesizer as JaxSynthesizer
from tpu_rvc.nn.encoders import TextEncoder as JaxTextEncoder
from tpu_rvc.nn.flows import ResidualCouplingBlock as JaxFlow
from tpu_rvc.nn.generators import NSFGenerator as JaxNSF
from tpu_rvc.nn.generators import f0_to_sine_phases as jax_phases
from tpu_rvc.nn.modules import WN as JaxWN
from tpu_rvc.nn.modules import LayerNorm1d as JaxLayerNorm
from tpu_rvc.nn.modules import ResBlock1 as JaxResBlock1
from tpu_rvc.ops.conv import conv_transpose1d_poly

from tpu_rvc_torch.ckpt.convert import (synthesizer_state_from_jax,
                                        synthesizer_state_from_reference)
from tpu_rvc_torch.core.config import hparams_for
from tpu_rvc_torch.f0.device import post_process
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.nn.generators import f0_to_sine_phases
from tpu_rvc_torch.ops.kernels.resblock import fused_resblock, stage_weights

from _torch_parity import (SMALL_SYNTH, jax_synth_params, reference_state,
                           seeded)

# three resblocks per stage and two encoder layers: the stock decoder shape
STAGE_SYNTH = dict(SMALL_SYNTH, n_layers=2, resblock_kernel_sizes=(3, 7, 11),
                   resblock_dilation_sizes=((1, 3, 5),) * 3)

T = 48


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes, and
    torch's default pool in each of them oversubscribes the cores (this
    file's small operations ran 5-25x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def japply(module, variables, *args, **static):
    """module.apply under jax.jit (one XLA compile instead of one per op);
    keyword arguments are static."""
    return jax.jit(functools.partial(module.apply, **static))(variables,
                                                              *args)


@pytest.fixture(scope="module")
def pair():
    """tpu_rvc's synthesizer (weight norm as (g, v)) and the port's, both
    loaded from one seeded reference-layout state_dict."""
    sd = reference_state(seeded(Synthesizer, 1, **STAGE_SYNTH), 2)
    port = Synthesizer(**STAGE_SYNTH).eval()
    port.load_state_dict(synthesizer_state_from_reference(sd))
    return (JaxSynthesizer(**STAGE_SYNTH, weight_norm=True),
            jax_synth_params(sd, STAGE_SYNTH), port)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    phone = rng.standard_normal((2, T, 64)).astype(np.float32)
    pitch = rng.integers(1, 255, (2, T)).astype(np.int32)
    pitchf = rng.uniform(90, 330, (2, T)).astype(np.float32)
    pitchf[:, 10:14] = 0.0  # an unvoiced stretch
    return phone, pitch, pitchf


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def test_state_from_jax_matches_reference_state_dict(pair):
    """With weight norm (g, v) in the JAX tree: the port's state_dict
    equals tpu_rvc's reference-layout state_dict key for key once each
    (g, v) pair is folded (numpy here, norm over all axes but 0)."""
    _, v, _ = pair
    ref = state_dict_from_synthesizer_params(v, use_f0=True, num_kernels=3)
    folded = {}
    for k, a in ref.items():
        a = np.asarray(a, np.float32)
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            g = np.asarray(ref[k[:-1] + "g"], np.float32)
            norm = np.sqrt((a * a).sum(axis=tuple(range(1, a.ndim)),
                                       keepdims=True))
            folded[k[:-len("_v")]] = g * a / norm
        else:
            folded[k] = a
    got = synthesizer_state_from_jax(v)
    assert sorted(got) == sorted(folded)
    for k in folded:
        np.testing.assert_allclose(got[k].numpy(), folded[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    port = Synthesizer(**STAGE_SYNTH)
    assert sorted(port.state_dict()) == sorted(got)


# ---------------------------------------------------------------------------
# the synthesizer and its parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("streamed", [False, True])
def test_synthesizer_infer_matches_jax(pair, inputs, streamed):
    """Deterministic, noise_scale 0, lengths [T, T-9], weight norm folded
    by the converter: atol 1e-4 on the waveform.  Streamed: skip_head 32 /
    return_length 16 / return_length2 16 with the flow pre-roll."""
    phone, pitch, pitchf = inputs
    syn, v, port = pair
    lens = np.asarray([T, T - 9], np.int32)
    sid = np.asarray([1, 0], np.int32)
    kw = dict(skip_head=32, return_length=16, return_length2=16) \
        if streamed else {}
    want = japply(syn, v, jnp.asarray(phone), jnp.asarray(lens),
                  jnp.asarray(sid), jnp.asarray(pitch), jnp.asarray(pitchf),
                  noise_scale=0.0, deterministic=True,
                  method=JaxSynthesizer.infer, **kw)
    got = port.infer(t(phone), t(lens), t(sid), t(pitch), t(pitchf),
                     noise_scale=0.0, deterministic=True, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_infer_external_noise_matches_jax(pair, inputs):
    """The prior eps handed in from outside (the ONNX `rnd` contract),
    noise_scale 0.66666: atol 1e-4."""
    syn, v, port = pair
    phone, pitch, pitchf = inputs
    eps = np.random.default_rng(9).standard_normal((2, T, 32)).astype(
        np.float32)
    lens, sid = np.asarray([T, T]), np.asarray([0, 1])
    want = jax.jit(lambda v_, *a, noise: syn.apply(
        v_, *a, deterministic=True, noise=noise,
        method=JaxSynthesizer.infer))(
        v, jnp.asarray(phone), jnp.asarray(lens), jnp.asarray(sid),
        jnp.asarray(pitch), jnp.asarray(pitchf), noise=jnp.asarray(eps))
    got = port.infer(t(phone), t(lens), t(sid), t(pitch), t(pitchf),
                     deterministic=True, noise=t(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_text_encoder_matches_jax(pair, inputs):
    """enc_p with lengths [T, T-13] (the banded kernel's plain twin for
    T > 11): m, logs and mask within atol 1e-5."""
    _, v, port = pair
    phone, pitch, _ = inputs
    lens = np.asarray([T, T - 13])
    c = STAGE_SYNTH
    enc = JaxTextEncoder(c["inter_channels"], c["hidden_channels"],
                         c["filter_channels"], c["n_heads"], c["n_layers"],
                         c["kernel_size"], 0.0, f0=True)
    want = japply(enc, {"params": v["params"]["enc_p"]}, jnp.asarray(phone),
                  jnp.asarray(pitch), jnp.asarray(lens))
    with torch.no_grad():
        got = port.enc_p(t(phone), t(pitch), t(lens))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-5)


def test_flow_reverse_matches_jax(pair):
    """Reverse coupling flow, channel-last in JAX, channel-first in the
    port: atol 1e-5."""
    _, v, port = pair
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, T, 32)).astype(np.float32)
    mask = (np.arange(T)[None, :, None] < np.asarray([T, 30])[:, None, None]
            ).astype(np.float32)
    g = rng.standard_normal((2, 1, 16)).astype(np.float32)
    flow = JaxFlow(32, 32, 5, 1, 3, gin_channels=16, weight_norm=True)
    want = jax.jit(lambda v_, x_, m_, g_: flow.apply(v_, x_, m_, g=g_,
                                                     reverse=True))(
        {"params": v["params"]["flow"]}, jnp.asarray(x), jnp.asarray(mask),
        jnp.asarray(g))
    with torch.no_grad():
        got = port.flow(t(x).transpose(1, 2), t(mask).transpose(1, 2),
                        g=t(g).transpose(1, 2))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               atol=1e-5)


def test_nsf_generator_matches_jax(pair):
    """Deterministic NSF decoder with three resblocks per stage (the
    stage kernel's plain twin): atol 1e-5."""
    _, v, port = pair
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 20, 32)).astype(np.float32)
    f0 = rng.uniform(80, 400, (1, 20)).astype(np.float32)
    g = rng.standard_normal((1, 1, 16)).astype(np.float32)
    c = STAGE_SYNTH
    dec = JaxNSF(32, "1", c["resblock_kernel_sizes"],
                 c["resblock_dilation_sizes"], c["upsample_rates"],
                 c["upsample_initial_channel"], c["upsample_kernel_sizes"],
                 16, 16000, weight_norm=True)
    want = jax.jit(lambda v_, x_, f_, g_: dec.apply(
        v_, x_, f_, g=g_, deterministic=True))(
        {"params": v["params"]["dec"]}, jnp.asarray(x), jnp.asarray(f0),
        jnp.asarray(g))
    with torch.no_grad():
        got = port.dec(t(x).transpose(1, 2), t(f0), g=t(g).transpose(1, 2),
                       deterministic=True)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               atol=1e-5)


def test_resblock_wn_layernorm_match_jax(pair):
    """ResBlock1 (through the stage wrapper, which takes the plain twin
    for CPU tensors), WN with conditioning, LayerNorm1d: atol 1e-5."""
    _, v, port = pair
    p = v["params"]
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 40, 32)).astype(np.float32)
    want = japply(JaxResBlock1(32, 3, (1, 3, 5), weight_norm=True),
                  {"params": p["dec"]["resblock_0_0"]}, jnp.asarray(x))
    with torch.no_grad():
        sw = stage_weights([port.dec.resblocks[0]])
        got = torch.stack([fused_resblock(xb.T.contiguous(), sw).T
                           for xb in t(x)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    mask = np.ones((2, 40, 1), np.float32)
    mask[1, 31:] = 0
    g = rng.standard_normal((2, 1, 16)).astype(np.float32)
    want = jax.jit(JaxWN(32, 5, 1, 3, 16, weight_norm=True).apply)(
        {"params": p["flow"]["flow_0"]["enc"]}, jnp.asarray(x),
        jnp.asarray(mask), jnp.asarray(g))
    with torch.no_grad():
        got = port.flow.flows[0].enc(t(x).transpose(1, 2),
                                     t(mask).transpose(1, 2),
                                     g=t(g).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    want = JaxLayerNorm().apply(
        {"params": p["enc_p"]["encoder"]["norm1_0"]}, jnp.asarray(x * 3))
    with torch.no_grad():
        got = port.enc_p.encoder.norm_layers_1[0](t(x * 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# the port's traps
# ---------------------------------------------------------------------------


def test_decoder_last_leaky_relu_slope_is_0_01(pair):
    """Slope 0.1 between layers but the default 0.01 before conv_post."""
    _, _, port = pair
    dec = port.dec
    w = torch.zeros_like(dec.conv_post.weight)
    w[0, 0, 3] = 1.0  # centre tap of channel 0
    saved = dec.conv_post.weight.data.clone()
    dec.conv_post.weight.data.copy_(w)
    try:
        out = dec._post(-torch.ones(1, w.shape[1], 5))
    finally:
        dec.conv_post.weight.data.copy_(saved)
    np.testing.assert_allclose(out.detach().numpy(), np.tanh(-0.01),
                               rtol=1e-6)


def test_sine_phases_floor_mod_matches_jax():
    """`jnp.mod` is floor-mod (torch.remainder, not fmod): the wrapped
    frame advances are negative half the time.  High f0 makes the wrap
    matter; phases agree to atol 1e-4 cycles."""
    rng = np.random.default_rng(14)
    f0 = rng.uniform(300, 1100, (2, 64)).astype(np.float32)
    want = jax_phases(jnp.asarray(f0), 160, 16000, 1, None)
    got = f0_to_sine_phases(t(f0), 160, 16000, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_post_process_rounds_half_to_even_like_jax():
    """Coarse pitch bins on a dense f0 grid, transposed by +3 and -5
    semitones, equal to the JAX `jnp.rint` quantisation everywhere."""
    f0 = np.concatenate([[0.0], np.linspace(30, 1500, 20001)]).astype(
        np.float32)
    for key in (3.0, -5.0):
        c_want, f_want = post_process_jax(jnp.asarray(f0), jnp.asarray(key))
        c_got, f_got = post_process(t(f0), key)
        np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_want))
        np.testing.assert_allclose(f_got.numpy(), np.asarray(f_want),
                                   rtol=1e-6)


def test_transposed_conv_layout_flip_matches_jax():
    """JAX keeps transposed-conv kernels (K, in, out) flipped; the port
    keeps torch's (in, out, K): the converter's flip gives equal output."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((1, 9, 6)).astype(np.float32)
    w = rng.standard_normal((24, 6, 4)).astype(np.float32)
    want = conv_transpose1d_poly(jnp.asarray(x), jnp.asarray(w), stride=12,
                                 padding=6)
    w_torch = t(np.transpose(w, (1, 2, 0))[:, :, ::-1])
    got = torch.nn.functional.conv_transpose1d(
        t(x).transpose(1, 2), w_torch, stride=12, padding=6).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# isolation and the device rule
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    """Every module of tpu_rvc_torch, imported in a fresh interpreter,
    leaves jax, flax and tpu_rvc out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys, tpu_rvc_torch\n"
        "for m in pkgutil.walk_packages(tpu_rvc_torch.__path__,"
        " 'tpu_rvc_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpu_rvc'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda():
    """Without a device argument the entry points mean CUDA, and raise on
    a machine without it rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from tpu_rvc_torch.models.synthesizer import make_synthesizer
    from tpu_rvc_torch.pipeline.vc import VC, Pipeline
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VC()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Pipeline(16000, hubert=torch.nn.Identity(), synth=torch.nn.Identity())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_synthesizer(hparams_for("v2", 48000))
