"""The rest of the model family against tpu_rvc (JAX) on the CPU: v1 and
v2 at 32, 40 and 48 kHz, with and without f0.  Narrow widths, each
preset's own decoder geometry (upsample rates and kernels, so four or five
levels and the NSF source's strides), the version's phone width (256 for
v1, 768 for v2), weights carried across by one seeded reference-layout
state_dict, the same seeded numpy inputs through both, fp32:

- `Synthesizer.infer` for the five distinct decoders with f0 and a
  four- and a five-level one without (atol 1e-4, as
  tests/test_torch_modules.py holds v2/48k's);
- HuBERT with the v1 tap (a layer below the last one, `final_proj`),
  masked and unmasked (atol 1e-4);
- `Pipeline.pipeline` for a v1/40k model (256-d features and index)
  with if_f0 0, protect 0.5 (off), f0_up_key 12 and -5;
- `VC.get_vc` + `vc_single` from a `.pth` of two kinds (v1/32k with f0,
  v2/40k without).

The conversions are held as tests/test_torch_pipeline.py holds them: int16
outputs of equal length within MCD 0.1 dB and 2e-3 of full scale."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_rvc.ckpt.convert import synthesizer_params_from_state_dict
from tpu_rvc.ckpt.hubert_loader import hubert_params_from_fairseq
from tpu_rvc.ckpt.torch_pth import save_pth
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.models.synthesizer import Synthesizer as JaxSynthesizer
from tpu_rvc.pipeline.vc import VC as JaxVC
from tpu_rvc.pipeline.vc import Pipeline as JaxPipeline
from tpu_rvc.retrieval.index import FeatureIndex as JaxIndex
from tpu_rvc.utils.mcd import mcd

from tpu_rvc_torch.audio.io import save_wav
from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
from tpu_rvc_torch.ckpt.hubert_loader import hubert_state_from_fairseq
from tpu_rvc_torch.core.config import hparams_for
from tpu_rvc_torch.models.hubert import Hubert
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.pipeline.vc import VC, Pipeline
from tpu_rvc_torch.retrieval.index import FeatureIndex

from _torch_parity import SMALL_HUBERT, hubert_pair, reference_state, seeded

SR16 = 16000
T = 20
GEOMETRY = dict(x_pad=0.5, x_query=2.0, x_center=5.0, x_max=6.0)
# HuBERT's v1 tap at narrow width: the weights hold one layer more than
# the tap reads, and final_proj projects to the v1 phone width
V1_HUBERT = dict(SMALL_HUBERT, output_layer=1, final_proj=True,
                 final_dim=256)
V2_HUBERT = dict(SMALL_HUBERT, output_layer=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def narrow(version, sr, use_f0, encoder_dim=None):
    """A narrow synthesizer with the preset's decoder geometry."""
    m = hparams_for(version, sr).model
    return dict(
        spec_channels=129, segment_size=640, inter_channels=16,
        hidden_channels=16, filter_channels=32, n_heads=2, n_layers=1,
        kernel_size=3, p_dropout=0.0, resblock="1",
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
        upsample_rates=tuple(m.upsample_rates), upsample_initial_channel=64,
        upsample_kernel_sizes=tuple(m.upsample_kernel_sizes),
        spk_embed_dim=2, gin_channels=8, sr=sr,
        encoder_dim=encoder_dim or (256 if version == "v1" else 768),
        use_f0=use_f0)


def small_config(cfg):
    """The `.pth` config list of a `narrow` synthesizer."""
    return [cfg["spec_channels"], cfg["segment_size"], cfg["inter_channels"],
            cfg["hidden_channels"], cfg["filter_channels"], cfg["n_heads"],
            cfg["n_layers"], cfg["kernel_size"], cfg["p_dropout"],
            cfg["resblock"], list(cfg["resblock_kernel_sizes"]),
            [list(d) for d in cfg["resblock_dilation_sizes"]],
            list(cfg["upsample_rates"]), cfg["upsample_initial_channel"],
            list(cfg["upsample_kernel_sizes"]), cfg["spk_embed_dim"],
            cfg["gin_channels"], cfg["sr"]]


def synth_pair(cfg, seed):
    """(reference-layout state_dict, port Synthesizer, JAX Synthesizer,
    JAX variables), the weight norm folded at load in both packages (the
    JAX module's in-graph fold, which tests/test_torch_modules.py holds,
    would add to every compile here).  The upsamplers are scaled 30x
    from their initialisation, as `serving_world` scales them: at 1x or
    5x the five-level decoder's output is the biases' offset with 3% of
    audio on it, whose upper mel bands hold only the int16 rounding, and
    the MCD of two conversions 1 LSB apart reads 0.26-0.42 dB; at 30x,
    9e-4."""
    net = seeded(Synthesizer, seed, **cfg)
    with torch.no_grad():
        for up in net.dec.ups:
            up.weight.mul_(30.0)
    sd = reference_state(net, seed + 1)
    port = Synthesizer(**cfg).eval()
    port.load_state_dict(synthesizer_state_from_reference(sd))
    params = synthesizer_params_from_state_dict(
        sd, n_layers=cfg["n_layers"], n_ups=len(cfg["upsample_rates"]),
        num_kernels=len(cfg["resblock_kernel_sizes"]), use_f0=cfg["use_f0"])
    return (sd, port, JaxSynthesizer(**cfg, weight_norm=False),
            {"params": params})


def tapped_hubert_pair(cfg, seed):
    """(port Hubert, JAX variables) tapping layer cfg["output_layer"] of
    weights that hold one layer more, through the fairseq layout."""
    full = seeded(Hubert, seed, **dict(cfg,
                                       output_layer=cfg["output_layer"] + 1))
    sd = dict(full.state_dict())
    w = sd.pop("encoder.pos_conv.0.weight")
    sd["encoder.pos_conv.0.weight_g"] = torch.sqrt(
        (w * w).sum(dim=(0, 1), keepdim=True))
    sd["encoder.pos_conv.0.weight_v"] = w
    port = Hubert(**cfg).eval()
    port.load_state_dict(hubert_state_from_fairseq(
        sd, cfg["output_layer"], cfg["final_proj"]))
    params = hubert_params_from_fairseq(
        {k: v.numpy() for k, v in sd.items()}, cfg["output_layer"],
        cfg["final_proj"])
    return port, {"params": params}


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def japply(module, variables, *args, **static):
    return jax.jit(functools.partial(module.apply, **static))(variables,
                                                              *args)


def voice(dur, seed=0):
    """A gliding two-harmonic tone with a little noise, 16 kHz."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(SR16 * dur)) / SR16
    ph = 2 * np.pi * np.cumsum(180 + 40 * np.sin(2 * np.pi * 0.5 * tt)) / SR16
    x = 0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)
    return (x + 0.005 * rng.standard_normal(tt.shape)).astype(np.float32)


def assert_same_conversion(got, want, sr):
    """tests/test_torch_pipeline.py's gate at the output's own rate."""
    assert got.dtype == np.int16 and want.dtype == np.int16
    assert got.shape == want.shape
    got, want = got.astype(np.float64) / 32768, want.astype(np.float64) / 32768
    assert mcd(got, want, sr) < 0.1
    assert np.abs(got - want).max() < 2e-3


def index_pair(dim, seed):
    vecs = np.random.default_rng(seed).standard_normal((200, dim)).astype(
        np.float32)
    return (FeatureIndex(vecs, (vecs * vecs).sum(1)),
            JaxIndex(vecs, (vecs * vecs).sum(1)))


# ---------------------------------------------------------------------------
# Synthesizer.infer for each decoder geometry
# ---------------------------------------------------------------------------

KINDS = [("v1", 32000, True), ("v1", 40000, True), ("v1", 48000, True),
         ("v2", 32000, True), ("v2", 48000, True), ("v2", 40000, False),
         ("v1", 32000, False)]


@pytest.mark.parametrize("version,sr,use_f0", KINDS,
                         ids=[f"{v}-{sr // 1000}k-{'f0' if f else 'nof0'}"
                              for v, sr, f in KINDS])
def test_synthesizer_infer_matches_jax(version, sr, use_f0):
    """Deterministic, noise_scale 0, lengths [T, T-5], unvoiced frames in
    pitchf: atol 1e-4 on the waveform, T x hop samples of it."""
    cfg = narrow(version, sr, use_f0)
    _, port, jsyn, jv = synth_pair(cfg, 40 + len(cfg["upsample_rates"]))
    assert len(port.dec.ups) == len(cfg["upsample_rates"])
    rng = np.random.default_rng(sr + use_f0)
    phone = rng.standard_normal((2, T, cfg["encoder_dim"])).astype(
        np.float32)
    lens = np.asarray([T, T - 5], np.int32)
    sid = np.asarray([1, 0], np.int32)
    f0 = ()
    if use_f0:
        pitch = rng.integers(1, 255, (2, T)).astype(np.int32)
        pitchf = rng.uniform(90, 330, (2, T)).astype(np.float32)
        pitchf[:, 6:9] = 0.0
        f0 = (pitch, pitchf)
    want = japply(jsyn, jv, *(jnp.asarray(a) for a in (phone, lens, sid)
                              + f0),
                  noise_scale=0.0, deterministic=True,
                  method=JaxSynthesizer.infer)
    got = port.infer(*(t(a) for a in (phone, lens, sid) + f0),
                     noise_scale=0.0, deterministic=True)
    hop = int(np.prod(cfg["upsample_rates"]))
    assert hop == hparams_for(version, sr).data.hop_length
    assert got.shape == want.shape == (2, T * hop, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# HuBERT's v1 tap
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def v1_hubert():
    return tapped_hubert_pair(V1_HUBERT, 51)


@pytest.mark.parametrize("masked", [False, True])
def test_hubert_v1_tap_matches_jax(v1_hubert, masked):
    """Layer 1 of 2 and final_proj (64 -> 256), with and without a
    wave-level padding mask: atol 1e-4."""
    port, v = v1_hubert
    assert port.final_proj is not None and len(port.encoder.layers) == 1
    rng = np.random.default_rng(52)
    wav = rng.standard_normal((2, 8000)).astype(np.float32) * 0.1
    pad = np.zeros((2, 8000), bool)
    pad[1, 5200:] = True
    want = japply(JaxHubert(**V1_HUBERT), v, jnp.asarray(wav),
                  jnp.asarray(pad) if masked else None)
    got = port(t(wav), t(pad) if masked else None)
    assert got.shape[-1] == 256
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# Pipeline.pipeline and VC for v1 models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def v1_world(v1_hubert):
    """A v1/40k model with f0 and one without, both packages' pipelines on
    the 256-d HuBERT tap, and a 256-d index."""
    port_hub, jax_hub_vars = v1_hubert
    port_index, jax_index = index_pair(256, 53)
    pipes = {}
    for use_f0, seed in ((True, 54), (False, 56)):
        cfg = narrow("v1", 40000, use_f0)
        _, port, jsyn, jv = synth_pair(cfg, seed)
        pipes[use_f0] = (
            JaxPipeline(40000, hubert=JaxHubert(**V1_HUBERT),
                        hubert_vars=jax_hub_vars, synth=jsyn, synth_vars=jv,
                        version="v1", noise_scale=0.0, deterministic=True,
                        **GEOMETRY),
            Pipeline(40000, hubert=port_hub, synth=port, version="v1",
                     noise_scale=0.0, deterministic=True, device="cpu",
                     **GEOMETRY))
    return dict(pipes=pipes, port_index=port_index, jax_index=jax_index)


CASES = [(0, 0, 0.33), (1, 0, 0.5), (1, 12, 0.33), (1, -5, 0.33)]


@pytest.mark.parametrize("if_f0,key,protect", CASES,
                         ids=["no-f0", "protect-off", "key+12", "key-5"])
def test_v1_pipeline_matches_jax(v1_world, if_f0, key, protect):
    """2 s through the single-chunk device path, pm, the 256-d index at
    0.75, RMS mix 0.25: the same int16 conversion."""
    jax_pipe, port_pipe = v1_world["pipes"][bool(if_f0)]
    audio = voice(2.0, seed=57)
    args = (if_f0, 3, 0, 0.25, protect)
    want = jax_pipe.pipeline(0, audio, [0.0] * 3, key, "pm",
                             v1_world["jax_index"], 0.75, *args)
    got = port_pipe.pipeline(0, audio, [0.0] * 3, key, "pm",
                             v1_world["port_index"], 0.75, *args)
    assert_same_conversion(got, np.asarray(want), 40000)


@pytest.mark.parametrize("version,sr,use_f0", [("v1", 32000, True),
                                               ("v2", 40000, False)],
                         ids=["v1-32k-f0", "v2-40k-nof0"])
def test_vc_single_from_pth_matches_jax(v1_hubert, tmp_path, version, sr,
                                        use_f0):
    """VC.get_vc on a `.pth` written by tpu_rvc's save_pth (fp16 weights,
    weight norm as (g, v)), then vc_single with pm and the index: the
    same conversion as tpu_rvc's VC given the same HuBERT.  v2 reads the
    narrow 64-d layer tap, v1 its 256-d projection."""
    if version == "v1":
        port_hub, jax_hub_vars = v1_hubert
        jax_hub, dim = JaxHubert(**V1_HUBERT), 256
    else:
        port_hub, jax_hub_vars = hubert_pair(V2_HUBERT, 58)
        jax_hub, dim = JaxHubert(**V2_HUBERT), 64
    cfg = narrow(version, sr, use_f0, encoder_dim=dim)
    sd, _, _, _ = synth_pair(cfg, 59)
    mp = str(tmp_path / "m.pth")
    save_pth({"weight": {k: w.astype(np.float16) for k, w in sd.items()},
              "config": small_config(cfg), "sr": f"{sr // 1000}k",
              "f0": int(use_f0), "version": version, "info": "t"}, mp)
    wav = str(tmp_path / "in.wav")
    save_wav(wav, voice(1.5, seed=60), SR16)
    port_index, jax_index = index_pair(dim, 61)

    jvc = JaxVC(hubert_path="random", x_pad=0.5)
    jvc.get_vc(mp, hubert=jax_hub, hubert_vars=jax_hub_vars)
    vc = VC(hubert_path="random", x_pad=0.5, device="cpu")
    meta = vc.get_vc(mp, hubert=port_hub)
    assert (meta["version"], vc.tgt_sr, vc.if_f0) == (version, sr,
                                                      int(use_f0))
    assert vc.pipeline.synth.enc_p.emb_phone.in_features == dim
    for v in (jvc, vc):
        v.pipeline.noise_scale, v.pipeline.deterministic = 0.0, True
    kw = dict(f0_method="pm", index_rate=0.75, rms_mix_rate=0.25)
    _, (sr_j, want) = jvc.vc_single(0, wav, index=jax_index, **kw)
    _, (sr_p, got) = vc.vc_single(0, wav, index=port_index, **kw)
    assert sr_p == sr_j == sr
    assert_same_conversion(got, np.asarray(want), sr)
