"""tpu_rvc_torch's host-side f0 paths against tpu_rvc's on the CPU: the
WORLD-style DIO, StoneMask and Harvest (the port's own numpy copy, held
bit for bit), CREPE full (one random torchcrepe `full.pth`, read by both
packages' loaders), `Generator.calculate` for all six methods, the
manual-curve splice, the offline pipeline with a manual curve, a
precomputed track and Harvest, a Harvest streaming session, Harvest
extraction for training; and the three rules that keep the fused graphs
from computing one method in place of another."""

import numpy as np
import pytest
import torch

from tpu_rvc.ckpt.crepe_loader import load_crepe as jax_load_crepe
from tpu_rvc.ckpt.fcpe_loader import load_fcpe as jax_load_fcpe
from tpu_rvc.f0 import base as jax_base
from tpu_rvc.f0 import world as jax_world
from tpu_rvc.f0.crepe import CRePE as JaxCRePE
from tpu_rvc.f0.fcpe import FCPE as JaxFCPE
from tpu_rvc.f0.gen import Generator as JaxGenerator
from tpu_rvc.f0.rmvpe import RMVPE as JaxRMVPE
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.models.synthesizer import Synthesizer as JaxSynthesizer
from tpu_rvc.pipeline import rt as jax_rt
from tpu_rvc.pipeline.vc import Pipeline as JaxPipeline
from tpu_rvc.train.extract import extract_f0 as jax_extract_f0
from tpu_rvc.utils.mcd import mcd

from tpu_rvc_torch.audio.io import save_wav
from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
from tpu_rvc_torch.ckpt.crepe_loader import (load_crepe,
                                             random_crepe_reference_state)
from tpu_rvc_torch.ckpt.fcpe_loader import (load_fcpe,
                                            random_fcpe_reference_state)
from tpu_rvc_torch.f0 import base
from tpu_rvc_torch.f0 import world as port_world
from tpu_rvc_torch.f0.crepe import CRePE
from tpu_rvc_torch.f0.fcpe import FCPE
from tpu_rvc_torch.f0.gen import Generator
from tpu_rvc_torch.f0.harvest import Harvest
from tpu_rvc_torch.f0.rmvpe import RMVPE
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.pipeline import rt, serve
from tpu_rvc_torch.pipeline.vc import Pipeline
from tpu_rvc_torch.train.extract import extract_f0

from _torch_parity import (SERVE_GEOMETRY, SMALL_HUBERT, SMALL_SYNTH, TINY,
                           FakeClock, e2e_pair, engine_pair, hubert_pair,
                           jax_synth_params, reference_state, seeded,
                           serving_world, spy_chunks)

SR = 16000
GEOMETRY = dict(x_pad=0.5, x_query=2.0, x_center=5.0, x_max=6.0)
TOL = 2e-3  # of full scale


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """CREPE full is about 2 GFLOP a frame: with torch's default thread
    pool in each of the suite's worker processes the cores would be
    oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def voice(n, seed=0, sr=SR, f0=180.0):
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / sr
    ph = 2 * np.pi * np.cumsum(f0 + 40 * np.sin(2 * np.pi * 0.5 * tt)) / sr
    x = 0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph) + 0.08 * np.sin(3 * ph)
    return (x + 0.005 * rng.standard_normal(n)).astype(np.float32)


SIGNALS = {
    "tone": lambda: (0.5 * np.sin(2 * np.pi * 220 * np.arange(SR) / SR)
                     ).astype(np.float32),
    "voice": lambda: voice(SR, seed=1),
    "silence": lambda: np.zeros(SR, np.float32),
}


@pytest.mark.parametrize("signal", sorted(SIGNALS))
def test_world_matches_jax_bit_for_bit(signal):
    """dio, stonemask and harvest at the generator's settings (hop 10 ms,
    50-1100 Hz): the port's copy gives the JAX package's arrays exactly."""
    x = SIGNALS[signal]()
    kw = dict(f0_floor=50.0, f0_ceil=1100.0, frame_period_ms=10.0)
    f0, t = port_world.dio(x, SR, **kw)
    jf0, jt = jax_world.dio(x, SR, **kw)
    np.testing.assert_array_equal(f0, jf0)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(port_world.stonemask(x, SR, f0, t),
                                  jax_world.stonemask(x, SR, jf0, jt))
    h, ht = port_world.harvest(x, SR, **kw)
    jh, jht = jax_world.harvest(x, SR, **kw)
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(ht, jht)
    if signal == "silence":
        assert not f0.any() and not h.any()
    else:
        assert (h > 0).mean() > 0.5


# ---------------------------------------------------------------------------
# CREPE, and the dispatcher with all six methods
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """Random CREPE full, small FCPE and tiny RMVPE weights, each loaded
    into both packages: {method: (port estimator, JAX estimator)}."""
    d = tmp_path_factory.mktemp("f0_nets")
    torch.save(random_crepe_reference_state(7), str(d / "full.pth"))
    torch.save(random_fcpe_reference_state(
        8, in_dims=128, hidden_dims=32, out_dims=360, n_layers=2),
        str(d / "fcpe.pt"))
    jcrepe, jcrepe_vars = jax_load_crepe(str(d / "full.pth"))
    jcrepe_est = JaxCRePE(variables=jcrepe_vars)
    jcrepe_est.model = jcrepe
    jfcpe, jfcpe_vars = jax_load_fcpe(str(d / "fcpe.pt"))
    e2e, je2e, je2e_vars = e2e_pair(TINY, 9)
    jrmvpe = JaxRMVPE(variables=je2e_vars)
    jrmvpe.model = je2e
    return {
        "crepe": (CRePE(model_path=str(d / "full.pth"), device="cpu"),
                  jcrepe_est),
        "fcpe": (FCPE(model=load_fcpe(str(d / "fcpe.pt"), "cpu"),
                      device="cpu"),
                 JaxFCPE(model=jfcpe, variables=jfcpe_vars)),
        "rmvpe": (RMVPE(model=e2e, device="cpu"), jrmvpe),
    }


def test_crepe_matches_jax(nets):
    """0.3 s (31 frames): the salience within 1e-5 abs, the estimator's
    f0 within 1e-4."""
    est, jest = nets["crepe"]
    x = voice(4800, seed=2)
    sal, jsal = est.salience(x), jest._salience(x)
    assert sal.shape == jsal.shape == (31, 360)
    np.testing.assert_allclose(sal, jsal, rtol=0, atol=1e-5)
    got, want = est.compute_f0(x, p_len=30), jest.compute_f0(x, p_len=30)
    assert got.shape == (30,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert (got > 0).all()


@pytest.mark.parametrize("method,radius", [
    ("pm", None), ("dio", None), ("harvest", None), ("harvest", 3),
    ("crepe", None), ("rmvpe", None), ("fcpe", None)])
def test_generator_matches_jax(nets, method, radius):
    """`calculate` for every method on 0.3 s, transposed by 2 semitones,
    with the crepe, fcpe and rmvpe estimators given: coarse pitch equal,
    f0 within 1e-4 (dio and harvest exactly)."""
    gen = Generator("none", x_pad=0, device="cpu")
    jgen = JaxGenerator("none", x_pad=0)
    for name, (est, jest) in nets.items():
        gen._estimators[name], jgen._estimators[name] = est, jest
    x = voice(4800, seed=3)
    c, f = gen.calculate(x, 30, 2.0, method, radius)
    cj, fj = jgen.calculate(x, 30, 2.0, method, radius)
    assert c.shape == f.shape == (30,)
    assert c.dtype == np.int32 and f.dtype == np.float32
    np.testing.assert_array_equal(c, cj)
    np.testing.assert_allclose(f, fj, rtol=0 if method in ("dio", "harvest")
                               else 1e-4)


@pytest.mark.parametrize("x_pad,span", [(0.5, 1.0), (0.0, 3.0)])
def test_post_process_manual_curve_matches_jax(x_pad, span):
    """The manual curve, spliced from x_pad seconds on: inside the track,
    and running past its end (cut there)."""
    f0 = np.linspace(100, 300, 200).astype(np.float32)
    manual = np.stack([np.linspace(0, span, 7),
                       [200, 220, 0, 260, 240, 230, 210]], 1)
    c, f = base.post_process(f0, 2.0, manual_f0=manual, x_pad=x_pad, tf0=100)
    cj, fj = jax_base.post_process(100, f0, 2.0, x_pad, manual_f0=manual)
    np.testing.assert_array_equal(c, cj)
    np.testing.assert_array_equal(f, fj)
    assert f[int(x_pad * 100)] == 200


def test_generator_passes_filter_radius_to_harvest(monkeypatch):
    """harvest is given `filter_radius` (it median-filters above 2), rmvpe
    0.03, the others their defaults, as `tpu_rvc/f0/gen.py:57-75` does;
    a manual curve reaches the splice."""
    seen = {}

    class Recording:
        def __init__(self, name):
            self.name = name

        def compute_f0(self, x, p_len=None, **kw):
            seen[self.name] = kw
            return np.full(p_len, 150.0, np.float32)

    gen = Generator("none", x_pad=0.5, device="cpu")
    for name in ("pm", "dio", "harvest", "crepe", "rmvpe", "fcpe"):
        gen._estimators[name] = Recording(name)
        gen.calculate(np.zeros(8000, np.float32), 50, 0.0, name, 3)
    assert seen == {"pm": {}, "dio": {}, "harvest": {"filter_radius": 3},
                    "crepe": {}, "rmvpe": {"filter_radius": 0.03},
                    "fcpe": {}}
    _, f = gen.calculate(np.zeros(8000, np.float32), 100, 0.0, "pm",
                         manual_f0=np.array([[0.0, 300.0], [0.2, 300.0]]))
    assert (f[50:71] == 300).all() and (f[:50] == 150).all()
    x = voice(SR, seed=4, f0=120.0)
    x[6000:6400] = np.random.default_rng(5).standard_normal(400) * 0.3
    assert not np.array_equal(Harvest().compute_f0(x, 100, 3),
                              Harvest().compute_f0(x, 100, None))


# ---------------------------------------------------------------------------
# the offline pipeline: manual curve, precomputed track, host methods
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipelines():
    sd = reference_state(seeded(Synthesizer, 91, **SMALL_SYNTH), 92)
    port_synth = Synthesizer(**SMALL_SYNTH).eval()
    port_synth.load_state_dict(synthesizer_state_from_reference(sd))
    port_hub, jax_hub_vars = hubert_pair(SMALL_HUBERT, 93)
    jax_pipe = JaxPipeline(
        SR, hubert=JaxHubert(**SMALL_HUBERT), hubert_vars=jax_hub_vars,
        synth=JaxSynthesizer(**SMALL_SYNTH, weight_norm=True),
        synth_vars=jax_synth_params(sd, SMALL_SYNTH), version="v2",
        noise_scale=0.0, deterministic=True, **GEOMETRY)
    port_pipe = Pipeline(SR, hubert=port_hub, synth=port_synth, version="v2",
                         noise_scale=0.0, deterministic=True, device="cpu",
                         **GEOMETRY)
    return jax_pipe, port_pipe


MANUAL = np.array([[0.0, 220.0], [0.4, 260.0], [0.8, 0.0], [1.2, 240.0]])


def track(n):
    """A precomputed (coarse, f0) pair of n frames, voiced but for a gap."""
    f0 = (160 + 40 * np.sin(np.arange(n) / 15)).astype(np.float32)
    f0[100:120] = 0
    return base.coarse_f0(f0), f0


CASES = {
    "manual_curve": dict(f0_method="pm", f0_file=MANUAL),
    "precomputed": dict(f0_method=track(330), if_f0=2),
    "harvest": dict(f0_method="harvest"),
    "dio": dict(f0_method="dio"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_host_f0_matches_jax(pipelines, case):
    """2 s, which the fused path would take with plain pm: a manual
    curve, a precomputed track (330 frames, cut to the padded input's
    300), harvest (filter_radius 3) and dio take the chunked path in both
    packages.  The float audio of the chunks within 2e-3 of full scale and
    MCD < 0.1 dB; the int16 output within 2e-3."""
    jax_pipe, port_pipe = pipelines
    kw = {"if_f0": 1, "f0_file": None, **CASES[case]}
    audio = voice(2 * SR, seed=6)
    chunks = {"port": [], "jax": []}
    pipes = {"port": port_pipe, "jax": jax_pipe}
    inner = {k: spy_chunks(pipes[k], chunks[k]) for k in pipes}
    out = {}
    try:
        for k, pipe in pipes.items():
            times = [0.0] * 3
            out[k] = pipe.pipeline(0, audio, times, 1, kw["f0_method"], None,
                                   0.0, kw["if_f0"], 3, 0, 0.25, 0.33,
                                   kw["f0_file"])
            assert times[1] > 0
    finally:
        for k, pipe in pipes.items():
            pipe.vc_chunk = inner[k]
    assert out["port"].dtype == np.int16
    assert out["port"].shape == out["jax"].shape
    assert np.abs(out["port"].astype(np.float64)
                  - out["jax"]).max() / 32768 < TOL
    g, w = chunks["port"], chunks["jax"]
    assert len(g) == len(w) == 1 and g[0].shape == w[0].shape
    assert np.abs(g[0] - w[0]).max() < TOL and mcd(g[0], w[0], SR) < 0.1


def test_fused_offline_path_only_for_device_methods(pipelines, monkeypatch):
    """The single-chunk graph takes pm, rmvpe and fcpe with no manual
    curve (or a model without f0); any other method, a manual curve or a
    precomputed track goes through the chunked path, and the graph's f0
    dispatch raises for a method it does not compute, never running pm
    instead."""
    _, port_pipe = pipelines
    calls = []
    full = port_pipe._full

    def spy(*args):
        calls.append(args[-1])
        return full(*args)

    monkeypatch.setattr(port_pipe, "_full", spy)
    audio = voice(SR, seed=7)
    args = (None, 0.0)
    for method, if_f0, f0_file in (("harvest", 1, None), ("dio", 1, None),
                                   ("pm", 1, MANUAL), (track(200), 2, None),
                                   ("pm", 1, None)):
        port_pipe.pipeline(0, audio, [0.0] * 3, 0, method, *args, if_f0, 3,
                           0, 1.0, 0.33, f0_file)
    assert calls == ["pm"]
    x = torch.from_numpy(np.pad(audio, (8000, 8000)))
    for method in ("harvest", "dio", "crepe", "yin"):
        with pytest.raises(ValueError, match="not computed on the device"):
            full(x, 0.0, 0, True, None, 0.0, 0.33, 1.0, 0, method)


# ---------------------------------------------------------------------------
# streaming and serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    return serving_world(101)


def test_harvest_stream_session_runs_host_path_and_matches_jax(world):
    """StreamSession(f0method="harvest", fused=True) runs the host block
    path, as the JAX session does; 5 blocks within 2e-3 of full scale."""
    port, jeng = engine_pair(world)
    kw = dict(f0method="harvest", protect=0.33, **SERVE_GEOMETRY)
    sess = rt.StreamSession(port, fused=True, **kw)
    jsess = jax_rt.StreamSession(jeng, fused=True, **kw)
    assert sess._fused is None and sess._fused_saved is None
    assert jsess._fused is None
    audio = voice(sess.block_frame * 5, seed=8)
    for i in range(5):
        block = audio[i * sess.block_frame: (i + 1) * sess.block_frame]
        got, want = sess.feed(block), jsess.feed(block)
        assert got.shape == want.shape == (sess.block_frame,)
        assert np.abs(got - want).max() < TOL, i
    np.testing.assert_array_equal(port.cache_pitch, jeng.cache_pitch)
    assert (port.cache_pitch[-30:] > 1).any()


def test_fused_stream_graphs_only_for_device_methods(world):
    """A fused session for a host-only method runs the host path; the
    fused graph, and so the serving scheduler, refuses such a method at
    construction (the JAX graph would compute pm for it)."""
    port, _ = engine_pair(world)
    geo = rt.BlockGeometry(**SERVE_GEOMETRY)
    graph_kw = dict(stream_sr=geo.sr, block_frame=geo.block_frame,
                    ctx_frame=2 * geo.zc, total_len=geo.total,
                    skip_head=geo.skip_head, return_length=geo.return_length)
    for method in ("harvest", "dio", "crepe"):
        sess = rt.StreamSession(port, f0method=method, fused=True,
                                **SERVE_GEOMETRY)
        assert sess._fused is None and sess._fused_saved is None
        with pytest.raises(ValueError, match="not computed on the device"):
            rt.FusedStreamGraph(port, f0method=method, **graph_kw)
        with pytest.raises(ValueError, match="not computed on the device"):
            serve.SlotScheduler(port, 2, f0method=method, clock=FakeClock(),
                                **SERVE_GEOMETRY)
    assert rt.FusedStreamGraph(port, f0method="pm", **graph_kw) is not None


def test_extract_f0_harvest_matches_jax(tmp_path):
    """Training's f0 pass with harvest (filter radius 3 in both): the same
    files and the same arrays."""
    exp, jexp = tmp_path / "port", tmp_path / "jax"
    for d in (exp, jexp):
        (d / "1_16k_wavs").mkdir(parents=True)
        for i, n in enumerate((SR, 12000)):
            save_wav(str(d / "1_16k_wavs" / f"{i}.wav"), voice(n, 10 + i), SR)
    assert extract_f0(str(exp), f0_method="harvest", device="cpu") == []
    assert jax_extract_f0(str(jexp), f0_method="harvest") == []
    for sub in ("2a_f0", "2b-f0nsf"):
        for i in range(2):
            got = np.load(exp / sub / f"{i}.wav.npy")
            want = np.load(jexp / sub / f"{i}.wav.npy")
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
