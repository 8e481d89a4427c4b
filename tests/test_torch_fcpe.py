"""tpu_rvc_torch's FCPE f0 path against tpu_rvc's on the CPU: the model
(one random torchfcpe bundled checkpoint, written by the port's
`random_fcpe_reference_state` and read by both packages' loaders), the
Slaney log-mel frontend, the local_argmax decode, the on-device track,
the offline pipeline on its fused and its chunked path, the fused
streaming session and a two-slot scheduler."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_rvc.ckpt.fcpe_loader import load_fcpe as jax_load_fcpe
from tpu_rvc.f0 import device as jax_dev
from tpu_rvc.f0.fcpe import FCPE as JaxFCPE
from tpu_rvc.models import fcpe as jax_fcpe
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.models.synthesizer import Synthesizer as JaxSynthesizer
from tpu_rvc.pipeline import rt as jax_rt
from tpu_rvc.pipeline import serve as jax_serve
from tpu_rvc.pipeline.vc import Pipeline as JaxPipeline
from tpu_rvc.retrieval.index import FeatureIndex as JaxIndex
from tpu_rvc.utils.mcd import mcd

from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
from tpu_rvc_torch.ckpt.fcpe_loader import (load_fcpe,
                                            random_fcpe_reference_state)
from tpu_rvc_torch.f0 import device as port_dev
from tpu_rvc_torch.f0.fcpe import FCPE
from tpu_rvc_torch.models import fcpe as port_fcpe
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.pipeline import rt, serve
from tpu_rvc_torch.pipeline.vc import Pipeline
from tpu_rvc_torch.retrieval.index import FeatureIndex

from _torch_parity import (SERVE_GEOMETRY, SMALL_HUBERT, SMALL_SYNTH,
                           FakeClock, engine_pair, hubert_pair,
                           jax_synth_params, reference_state, seeded,
                           serving_world, spy_chunks, stream_voice)

SR = 16000
SMALL_FCPE = dict(in_dims=128, hidden_dims=32, out_dims=360, n_layers=2)
GEOMETRY = dict(x_pad=0.5, x_query=2.0, x_center=5.0, x_max=6.0)
TOL = 2e-3  # of full scale


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes, and
    torch's default pool in each of them oversubscribes the cores (this
    file's small operations ran 5-25x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def voice(n, seed=0, sr=SR):
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / sr
    ph = 2 * np.pi * np.cumsum(180 + 40 * np.sin(2 * np.pi * 0.5 * tt)) / sr
    x = 0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)
    return (x + 0.005 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def fcpe(tmp_path_factory):
    """(port model, JAX model, JAX variables) from one checkpoint file in
    the torchfcpe bundled layout, weight norm on the output projection."""
    path = str(tmp_path_factory.mktemp("fcpe") / "fcpe.pt")
    torch.save(random_fcpe_reference_state(5, **SMALL_FCPE), path)
    jmodel, jvars = jax_load_fcpe(path)
    return load_fcpe(path, "cpu"), jmodel, jvars


def estimators(fcpe):
    port, jmodel, jvars = fcpe
    return FCPE(model=port, device="cpu"), JaxFCPE(model=jmodel,
                                                   variables=jvars)


def test_fcpe_model_matches_jax(fcpe):
    """The latent of a log-mel batch, 1e-5 abs."""
    port, jmodel, jvars = fcpe
    mel = np.random.default_rng(1).standard_normal((2, 128, 70)).astype(
        np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(mel.transpose(0, 2, 1))))
    assert got.shape == want.shape == (2, 70, 360)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_fcpe_mel_matches_jax():
    wav = np.stack([voice(9000, 2), voice(9000, 3) * 0.1])
    got = port_fcpe.fcpe_mel(torch.from_numpy(wav)).numpy()
    want = np.asarray(jax_fcpe.fcpe_mel(jnp.asarray(wav)))
    assert got.shape == (2, 128, 9000 // 160 + 1)
    err = np.abs(got.transpose(0, 2, 1) - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


def test_fcpe_decode_matches_jax(fcpe):
    """fcpe_infer: f0 within 1e-4 where both argmaxes pick the same bin,
    and they do on at least 99% of the frames; a peak at or below the
    threshold decodes to 0 Hz in both."""
    port, jmodel, jvars = fcpe
    wav = np.stack([voice(16000, 4), voice(16000, 5) * 0.3])
    with torch.no_grad():
        got = port_fcpe.fcpe_infer(port, torch.from_numpy(wav)).numpy()
        latent = port(port_fcpe.fcpe_mel(torch.from_numpy(wav))).numpy()
    want, jlatent = (np.asarray(a) for a in jax.jit(lambda v, w: (
        jax_fcpe.fcpe_infer(jmodel, v, w),
        jmodel.apply(v, jax_fcpe.fcpe_mel(w))))(jvars, jnp.asarray(wav)))
    agree = latent.argmax(-1) == jlatent.argmax(-1)
    assert got.shape == want.shape == (2, 101) and agree.mean() >= 0.99
    np.testing.assert_allclose(got[agree], want[agree], rtol=1e-4)
    table = port.cent_table("cpu")
    np.testing.assert_allclose(
        table.numpy(), np.asarray(jmodel.cent_table()), rtol=1e-6)
    y = np.full((1, 2, 360), 1e-4, np.float32)
    y[0, 0, 100] = 0.9
    y[0, 1, 100] = 0.006
    cents = port_fcpe.latent2cents_local(torch.from_numpy(y), table)
    f0 = port_fcpe.cents_to_f0(cents).numpy()
    jf0 = np.asarray(jax_fcpe.cents_to_f0(jax_fcpe.latent2cents_local(
        jnp.asarray(y), jmodel.cent_table())))
    np.testing.assert_allclose(f0, jf0, rtol=1e-5)
    assert f0[0, 1] == 0.0 and f0[0, 0] > 0


def test_fcpe_f0_device_and_estimator_match_jax(fcpe):
    """The on-device track for two signals at once: coarse pitch equal,
    f0 within 1e-4 of the JAX track of each; the estimator's numpy
    resize and interpolation against the JAX estimator's."""
    port, jmodel, jvars = fcpe
    wav = np.stack([voice(12000, 6), voice(12000, 7) * 0.5])
    with torch.no_grad():
        c, f = port_dev.fcpe_f0_device(torch.from_numpy(wav), 70, 3.0, port)
    jax_track = jax.jit(lambda v, w: jax_dev.fcpe_f0_device(
        w, 70, 3.0, jmodel, v))
    for i in range(2):
        cj, fj = jax_track(jvars, jnp.asarray(wav[i]))
        np.testing.assert_array_equal(c[i].numpy(), np.asarray(cj))
        np.testing.assert_allclose(f[i].numpy(), np.asarray(fj), rtol=1e-4)
    est, jest = estimators(fcpe)
    got, want = est.compute_f0(wav[0], p_len=70), jest.compute_f0(wav[0], 70)
    assert got.shape == (70,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_fcpe_loader_takes_every_bundled_layout(tmp_path):
    """torch's newer weight-norm naming, the depthwise key without
    `.conv` and a folded output projection load to the same model as the
    layout `random_fcpe_reference_state` writes."""
    ckpt = random_fcpe_reference_state(7, **SMALL_FCPE)
    sd = ckpt["model"]
    alt = {k.replace(".conformer.net.4.conv.", ".conformer.net.4."): v
           for k, v in sd.items()}
    alt["output_proj.parametrizations.weight.original0"] = alt.pop(
        "output_proj.weight_g")
    alt["output_proj.parametrizations.weight.original1"] = alt.pop(
        "output_proj.weight_v")
    folded = dict(sd)
    v, g = folded.pop("output_proj.weight_v"), folded.pop(
        "output_proj.weight_g")
    folded["output_proj.weight"] = g * v / v.norm(dim=1, keepdim=True)
    models = []
    for i, model_sd in enumerate((sd, alt, folded)):
        path = str(tmp_path / f"{i}.pt")
        torch.save({"config_dict": ckpt["config"], "model": model_sd}, path)
        models.append(load_fcpe(path, "cpu").state_dict())
    for other in models[1:]:
        assert other.keys() == models[0].keys()
        for k in other:
            torch.testing.assert_close(other[k], models[0][k], rtol=1e-6,
                                       atol=0)


def test_fcpe_without_a_checkpoint_raises(tmp_path, monkeypatch):
    """No model, no model_path, none of DEFAULT_PATHS: FileNotFoundError
    (the JAX estimator runs pm there); a model found through
    DEFAULT_PATHS from the working directory is loaded."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="assets/fcpe/fcpe.pt"):
        FCPE(device="cpu")
    with pytest.raises(FileNotFoundError):
        FCPE(model_path=str(tmp_path / "none.pt"), device="cpu")
    os.makedirs("assets/fcpe")
    torch.save(random_fcpe_reference_state(6, **SMALL_FCPE),
               "assets/fcpe/fcpe.pt")
    est = FCPE(device="cpu")
    assert est.model.output_proj.weight.shape == (360, 32)


# ---------------------------------------------------------------------------
# the offline pipeline, both paths
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipelines(fcpe):
    sd = reference_state(seeded(Synthesizer, 71, **SMALL_SYNTH), 72)
    port_synth = Synthesizer(**SMALL_SYNTH).eval()
    port_synth.load_state_dict(synthesizer_state_from_reference(sd))
    port_hub, jax_hub_vars = hubert_pair(SMALL_HUBERT, 73)
    vecs = np.random.default_rng(74).standard_normal((200, 64)).astype(
        np.float32)
    jax_pipe = JaxPipeline(
        SR, hubert=JaxHubert(**SMALL_HUBERT), hubert_vars=jax_hub_vars,
        synth=JaxSynthesizer(**SMALL_SYNTH, weight_norm=True),
        synth_vars=jax_synth_params(sd, SMALL_SYNTH), version="v2",
        noise_scale=0.0, deterministic=True, **GEOMETRY)
    port_pipe = Pipeline(SR, hubert=port_hub, synth=port_synth, version="v2",
                         noise_scale=0.0, deterministic=True, device="cpu",
                         **GEOMETRY)
    est, jest = estimators(fcpe)
    port_pipe.f0_gen._estimators["fcpe"] = est
    jax_pipe.f0_gen._estimators["fcpe"] = jest
    return dict(jax=jax_pipe, port=port_pipe,
                jax_index=JaxIndex(vecs, (vecs * vecs).sum(1)),
                port_index=FeatureIndex(vecs, (vecs * vecs).sum(1)))


@pytest.mark.parametrize("dur,rms_mix_rate", [(2.0, 0.25), (7.0, 0.5)])
def test_pipeline_fcpe_matches_jax(pipelines, dur, rms_mix_rate):
    """2 s takes the fused single-chunk path (FCPE on the device), 7 s
    (over x_max = 6 s) the silence-chunked path (the estimator's numpy
    decode).  The int16 outputs within 2e-3 of full scale.  The MCD gate
    (< 0.1 dB) is held on float audio before int16 scaling, where int16
    rounding cannot set it (ROADMAP.md C): on the chunked path the
    chunks' float audio; the fused path scales inside the JAX package's
    compiled graph, so there the gate reads the int16 output."""
    p = pipelines
    audio = voice(int(dur * SR), seed=int(dur))
    if dur > 6:
        audio[3 * SR: 3 * SR + 800] = 0  # a quiet notch for the splitter
    args = (1, 3, 0, rms_mix_rate, 0.33)
    chunks = {"port": [], "jax": []}
    inner = {k: spy_chunks(p[k], chunks[k]) for k in chunks}
    try:
        want = p["jax"].pipeline(0, audio, [0.0] * 3, 2, "fcpe",
                                 p["jax_index"], 0.75, *args)
        times = [0.0] * 3
        got = p["port"].pipeline(0, audio, times, 2, "fcpe", p["port_index"],
                                 0.75, *args)
    finally:
        for k in chunks:
            p[k].vc_chunk = inner[k]
    assert got.dtype == np.int16 and got.shape == want.shape
    g, w = got.astype(np.float64) / 32768, want.astype(np.float64) / 32768
    assert np.abs(g - w).max() < TOL
    assert len(chunks["port"]) == len(chunks["jax"]) == (2 if dur > 6 else 0)
    if dur > 6:
        g, w = np.concatenate(chunks["port"]), np.concatenate(chunks["jax"])
        assert g.shape == w.shape and np.abs(g - w).max() < TOL
    assert mcd(g, w, SR) < 0.1
    assert times[2] > 0 and (dur < 6 or times[1] > 0)


# ---------------------------------------------------------------------------
# streaming and serving: the fcpe branch of the fused block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    return serving_world(81)


def fcpe_engines(world, fcpe, n_streams=None):
    port, jeng = engine_pair(world, n_streams=n_streams)
    est, jest = estimators(fcpe)
    port.f0_gen._estimators["fcpe"] = est
    jeng.f0_gen._estimators["fcpe"] = jest
    return port, jeng


def test_stream_session_fcpe_matches_jax(world, fcpe):
    """6 blocks through both packages' fused sessions: every block within
    2e-3 of full scale, the pitch caches equal, the window within 1e-5."""
    port, jeng = fcpe_engines(world, fcpe)
    kw = dict(f0method="fcpe", protect=0.33, **SERVE_GEOMETRY)
    sess = rt.StreamSession(port, fused=True, **kw)
    jsess = jax_rt.StreamSession(jeng, fused=True, **kw)
    assert sess._fused is not None and jsess._fused is not None
    assert jsess._fused.f0method == "fcpe"   # not the JAX pm fallback
    audio = voice(sess.block_frame * 6, seed=9)
    for i in range(6):
        block = audio[i * sess.block_frame: (i + 1) * sess.block_frame]
        got, want = sess.feed(block), jsess.feed(block)
        assert got.shape == want.shape == (sess.block_frame,)
        assert np.abs(got - want).max() < TOL, i
    st, jst = sess._fused_state, jsess._fused_state
    np.testing.assert_array_equal(st["cache_pitch"].numpy(),
                                  np.asarray(jst["cache_pitch"]))
    np.testing.assert_allclose(st["wav16"].numpy(), np.asarray(jst["wav16"]),
                               atol=1e-5)
    assert (st["cache_pitch"].numpy()[-40:] > 0).all()   # fcpe filled them


def test_two_slot_scheduler_fcpe_matches_jax(world, fcpe):
    """A 2-slot SlotScheduler(f0method="fcpe") against the JAX one: two
    clients, 4 ticks in lockstep, every block within 2e-3 of full scale."""
    port, jeng = fcpe_engines(world, fcpe)
    clock = FakeClock()
    args = dict(n_slots=2, f0method="fcpe", clock=clock, **SERVE_GEOMETRY)
    sched = serve.SlotScheduler(port, **args)
    jsched = jax_serve.SlotScheduler(jeng, **args)
    assert jsched.fused.f0method == "fcpe"
    bf = sched.block_frame
    audios = [stream_voice(4 * bf, seed=90), stream_voice(4 * bf, seed=91,
                                                          f0=300.0)]
    for s in (sched, jsched):
        assert [s.attach(), s.attach()] == [0, 1]
    for i in range(4):
        for s in (sched, jsched):
            for slot, a in enumerate(audios):
                s.submit(slot, a[i * bf: (i + 1) * bf])
            s.tick()
        for slot in (0, 1):
            got, want = sched.collect(slot), jsched.collect(slot)
            assert len(got) == len(want) == bf
            assert np.abs(got - want).max() < TOL, (i, slot)
    assert sched.stats() == jsched.stats()
