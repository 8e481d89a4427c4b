"""tpu_rvc_torch's RMVPE f0 path against tpu_rvc's on the CPU: the STFT and
HTK mel frontend, the E2E salience net (one seeded state dict in the
reference `rmvpe.pt` layout, BatchNorm statistics drawn, loaded by both
packages' own loaders), the on-device f0 chain, and the offline pipeline
with f0_method="rmvpe" on both of its paths (the decode and resize alone
are in tests/test_torch_f0_decode.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_rvc.f0 import device as jax_dev
from tpu_rvc.f0.rmvpe import RMVPE as JaxRMVPE
from tpu_rvc.f0.rmvpe import rmvpe_mel as jax_rmvpe_mel
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.models.synthesizer import Synthesizer as JaxSynthesizer
from tpu_rvc.ops.mel import mel_filterbank as jax_mel_filterbank
from tpu_rvc.ops.stft import stft as jax_stft
from tpu_rvc.pipeline.vc import Pipeline as JaxPipeline
from tpu_rvc.retrieval.index import FeatureIndex as JaxIndex
from tpu_rvc.utils.mcd import mcd

from tpu_rvc_torch.audio.io import save_wav
from tpu_rvc_torch.ckpt.convert import (rmvpe_state_from_jax,
                                        synthesizer_state_from_reference)
from tpu_rvc_torch.ckpt.rmvpe_loader import (load_rmvpe,
                                             random_rmvpe_reference_state,
                                             rmvpe_state_from_reference)
from tpu_rvc_torch.f0 import device as port_dev
from tpu_rvc_torch.f0.gen import Generator
from tpu_rvc_torch.f0.rmvpe import RMVPE, rmvpe_mel
from tpu_rvc_torch.models.rmvpe import E2E
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.ops.mel import mel_filterbank
from tpu_rvc_torch.ops.stft import stft
from tpu_rvc_torch.pipeline.vc import VC, Pipeline
from tpu_rvc_torch.retrieval.index import FeatureIndex

from _torch_parity import (FULL, SMALL_HUBERT, SMALL_SYNTH, TINY, e2e_pair,
                           hubert_pair, jax_synth_params, reference_state,
                           seeded)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes, and
    torch's default pool in each of them oversubscribes the cores (this
    file's small operations ran 5-25x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def voice(n, seed=0, sr=16000):
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / sr
    ph = 2 * np.pi * np.cumsum(180 + 40 * np.sin(2 * np.pi * 0.5 * tt)) / sr
    x = 0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)
    return (x + 0.005 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    return e2e_pair(TINY, 11)


def test_stft_matches_jax():
    """center=False STFT of a reflect-padded signal, rtol 1e-4 (atol 1e-4
    on bins whose magnitude is near zero)."""
    y = np.pad(voice(4000, 1), (512, 512), mode="reflect")[None]
    want = np.asarray(jax_stft(jnp.asarray(y), 1024, 160))
    got = stft(torch.from_numpy(y), 1024, 160).numpy()
    assert got.shape == want.shape == (1, 513, 1 + (5024 - 1024) // 160)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_htk_mel_filterbank_and_rmvpe_mel_match_jax():
    args = (16000, 1024, 128, 30.0, 8000.0)
    np.testing.assert_allclose(mel_filterbank(*args, htk=True),
                               jax_mel_filterbank(*args, htk=True),
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(mel_filterbank(16000, 1024, 80),
                               jax_mel_filterbank(16000, 1024, 80),
                               rtol=1e-4, atol=1e-9)
    assert mel_filterbank(*args, htk=True) is mel_filterbank(*args, htk=True)
    wav = voice(4800, 2)[None]
    want = np.asarray(jax_rmvpe_mel(jnp.asarray(wav)))
    got = rmvpe_mel(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (1, 128, 31)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw,frames", [(TINY, 64), (FULL, 32)],
                         ids=["tiny", "full"])
def test_e2e_salience_matches_jax(kw, frames):
    """Salience atol 1e-5, the full constructor and the tiny one."""
    port, jmodel, jvars = e2e_pair(kw, 7)
    mel = np.random.default_rng(3).standard_normal(
        (1, 128, frames)).astype(np.float32) * 2 - 4
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(mel)))
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, frames, 360)
    assert 0.02 < got.min() and got.max() < 0.98  # not saturated
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_rmvpe_state_from_jax_round_trip(tiny):
    """reference layout -> JAX params -> port state dict equals the
    port's own load of the reference layout."""
    port, _, jvars = tiny
    back = rmvpe_state_from_jax(jvars)
    own = port.state_dict()
    assert set(back) == set(own)
    for k in own:
        np.testing.assert_allclose(back[k].numpy(), own[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    fresh = E2E(**TINY)
    fresh.load_state_dict(back)


def test_load_rmvpe_reads_the_reference_file(tmp_path):
    path = str(tmp_path / "rmvpe.pt")
    sd = random_rmvpe_reference_state(5, **FULL)
    assert "unet.encoder.layers.0.conv.0.conv.1.running_var" in sd
    assert "fc.0.gru.weight_ih_l0_reverse" in sd and "fc.1.weight" in sd
    assert "unet.decoder.layers.4.conv1.0.weight" in sd
    torch.save(sd, path)
    model = load_rmvpe(path, "cpu")
    assert not model.training
    want = rmvpe_state_from_reference(sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(FileNotFoundError):
        RMVPE(str(tmp_path / "missing" / "rmvpe.pt"), device="cpu")
    with pytest.raises(FileNotFoundError):
        Generator(tmp_path / "missing", device="cpu")._get("rmvpe")


@pytest.mark.parametrize("n,up_key", [(16000, 0.0), (5120 * 2 - 160, -3.0)])
def test_rmvpe_f0_device_matches_jax(tiny, n, up_key):
    """The whole chain wav -> (coarse, f0): coarse pitch equal, f0 rtol
    1e-4.  The second length is the streaming tail's 5120-sample grid."""
    port, jmodel, jvars = tiny
    wav = voice(n, 6)
    p_len = n // 160
    cj, fj = jax.jit(lambda w: jax_dev.rmvpe_f0_device(
        w, p_len, up_key, jmodel, jvars))(jnp.asarray(wav))
    with torch.no_grad():
        c, f = port_dev.rmvpe_f0_device(torch.from_numpy(wav), p_len, up_key,
                                        port)
    assert c.dtype == torch.int32 and c.shape == f.shape == (p_len,)
    np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=1e-4)
    assert (f.numpy() > 0).all()


def test_rmvpe_estimator_and_generator_match_jax(tiny, tmp_path,
                                                 monkeypatch):
    """The host estimator (`RMVPE.compute_f0`, numpy decode) and the
    dispatcher's `calculate`, against the JAX ones; dio and harvest give
    the JAX tracks; crepe without weights raises ValueError, as in the
    JAX package, and fcpe without its checkpoint FileNotFoundError, where
    the JAX one runs pm."""
    port, jmodel, jvars = tiny
    wav = voice(8000, 8)
    jest = JaxRMVPE(variables=jvars)
    jest.model = jmodel
    want = jest.compute_f0(wav, p_len=60)
    est = RMVPE(model=port, device="cpu")
    got = est.compute_f0(wav, p_len=60)
    assert got.shape == (60,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4)

    from tpu_rvc.f0.gen import Generator as JaxGenerator
    gen, jgen = Generator("none", x_pad=0, device="cpu"), JaxGenerator(
        "none", x_pad=0)
    gen._estimators["rmvpe"], jgen._estimators["rmvpe"] = est, jest
    for method in ("rmvpe", "pm", "dio", "harvest"):
        c, f = gen.calculate(wav, None, 2.0, method)
        cj, fj = jgen.calculate(wav, None, 2.0, method, None)
        np.testing.assert_array_equal(c, cj)
        np.testing.assert_allclose(f, fj, rtol=1e-4)
    monkeypatch.chdir(tmp_path)   # no assets/fcpe/ here
    with pytest.raises(ValueError, match="CREPE requires weights"):
        gen.calculate(wav, None, 0.0, "crepe")
    with pytest.raises(FileNotFoundError, match="fcpe"):
        gen.calculate(wav, None, 0.0, "fcpe")
    with pytest.raises(ValueError, match="not supported"):
        gen.calculate(wav, None, 0.0, "yin")


# ---------------------------------------------------------------------------
# the offline pipeline with f0_method="rmvpe"
# ---------------------------------------------------------------------------

SR = 16000
GEOMETRY = dict(x_pad=0.5, x_query=2.0, x_center=5.0, x_max=6.0)
SMALL_CONFIG = [129, 32, 32, 32, 64, 2, 1, 3, 0.0, "1", [3], [[1, 3, 5]],
                [10, 16], 64, [20, 32], 2, 16, 16000]


@pytest.fixture(scope="module")
def pipelines(tiny):
    port_e2e, jmodel, jvars = tiny
    sd = reference_state(seeded(Synthesizer, 41, **SMALL_SYNTH), 42)
    port_synth = Synthesizer(**SMALL_SYNTH).eval()
    port_synth.load_state_dict(synthesizer_state_from_reference(sd))
    port_hub, jax_hub_vars = hubert_pair(SMALL_HUBERT, 43)
    vecs = np.random.default_rng(44).standard_normal((200, 64)).astype(
        np.float32)
    jax_pipe = JaxPipeline(
        SR, hubert=JaxHubert(**SMALL_HUBERT), hubert_vars=jax_hub_vars,
        synth=JaxSynthesizer(**SMALL_SYNTH, weight_norm=True),
        synth_vars=jax_synth_params(sd, SMALL_SYNTH), version="v2",
        noise_scale=0.0, deterministic=True, **GEOMETRY)
    jest = JaxRMVPE(variables=jvars)
    jest.model = jmodel
    jax_pipe.f0_gen._estimators["rmvpe"] = jest
    port_pipe = Pipeline(SR, hubert=port_hub, synth=port_synth, version="v2",
                         noise_scale=0.0, deterministic=True, device="cpu",
                         **GEOMETRY)
    port_pipe.f0_gen._estimators["rmvpe"] = RMVPE(model=port_e2e,
                                                  device="cpu")
    return dict(jax=jax_pipe, port=port_pipe, sd=sd, port_hub=port_hub,
                jax_index=JaxIndex(vecs, (vecs * vecs).sum(1)),
                port_index=FeatureIndex(vecs, (vecs * vecs).sum(1)))


@pytest.mark.parametrize("dur,rms_mix_rate", [(2.0, 0.25), (7.0, 0.5)])
def test_pipeline_rmvpe_matches_jax(pipelines, dur, rms_mix_rate):
    """MCD < 0.1 dB and 2e-3 of full scale.  2 s takes the single-chunk
    path (RMVPE decoded on the device), 7 s (over x_max = 6 s) the
    silence-chunked path (the estimator's numpy decode)."""
    p = pipelines
    audio = voice(int(dur * SR), seed=int(dur))
    if dur > 6:
        audio[3 * SR: 3 * SR + 800] = 0  # a quiet notch for the splitter
    args = (1, 3, 0, rms_mix_rate, 0.33)
    want = p["jax"].pipeline(0, audio, [0.0] * 3, 2, "rmvpe", p["jax_index"],
                             0.75, *args)
    times = [0.0] * 3
    got = p["port"].pipeline(0, audio, times, 2, "rmvpe", p["port_index"],
                             0.75, *args)
    assert got.dtype == np.int16 and got.shape == want.shape
    g, w = got.astype(np.float64) / 32768, want.astype(np.float64) / 32768
    assert mcd(g, w, SR) < 0.1
    assert np.abs(g - w).max() < 2e-3
    assert times[2] > 0 and (dur < 6 or times[1] > 0)


def test_vc_single_default_f0_method_is_rmvpe(pipelines, tmp_path):
    """`VC.vc_single` with its default f0_method converts a file on the
    CPU, given `rmvpe_root` with a full-width rmvpe.pt in the reference
    layout; the pitch it used is the file's model's."""
    torch.save(random_rmvpe_reference_state(9, **FULL),
               str(tmp_path / "rmvpe.pt"))
    from tpu_rvc.ckpt.torch_pth import save_pth
    mp, wav = str(tmp_path / "m.pth"), str(tmp_path / "in.wav")
    save_pth({"weight": {k: w.astype(np.float16)
                         for k, w in pipelines["sd"].items()},
              "config": SMALL_CONFIG, "sr": "40k", "f0": 1, "version": "v2",
              "info": "t"}, mp)
    save_wav(wav, voice(SR, seed=3), SR)
    vc = VC(rmvpe_root=str(tmp_path), hubert_path="random", x_pad=0.5,
            device="cpu")
    vc.get_vc(mp, hubert=pipelines["port_hub"])
    info, (sr, out) = vc.vc_single(0, wav)
    assert sr == SR and info.startswith("npy:")
    assert out.dtype == np.int16 and abs(out.shape[0] - SR) < 1600
    assert np.abs(out).max() > 0
    est = vc.pipeline.f0_gen._estimators["rmvpe"]
    assert sum(p.numel() for p in est.model.parameters()) > 9e7
    _, (_, out_pm) = vc.vc_single(0, wav, f0_method="pm")
    assert np.abs(out.astype(np.int32) - out_pm).max() > 0
