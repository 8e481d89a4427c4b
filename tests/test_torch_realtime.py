"""tpu_rvc_torch's realtime engine against tpu_rvc's on the CPU:
`RealtimeVC.infer`'s block contract and pitch caches, and `StreamSession`
on the host and the fused path, at the small sizes of
tests/test_realtime.py (the block geometry, SOLA merge and phase vocoder
are in tests/test_torch_sola.py).

Both engines are deterministic: tpu_rvc's `RealtimeVC` calls
`Synthesizer.infer` with its defaults and so always draws prior noise
from a JAX key, which torch cannot reproduce, so the JAX engine gets a
subclass of the JAX Synthesizer whose `infer` forces deterministic=True
and noise_scale=0; the port's engine is built with the same two values.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_rvc.f0.rmvpe import RMVPE as JaxRMVPE
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.models.synthesizer import Synthesizer as JaxSynthesizer
from tpu_rvc.pipeline import rt as jax_rt
from tpu_rvc.retrieval.index import FeatureIndex as JaxIndex

from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
from tpu_rvc_torch.f0.rmvpe import RMVPE
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.pipeline import rt
from tpu_rvc_torch.retrieval.index import FeatureIndex

from _torch_parity import (TINY, e2e_pair, hubert_pair, jax_synth_params,
                           reference_state, seeded)

# the sizes of tests/test_realtime.py:14-27
SMALL_HUBERT = dict(output_layer=1, final_proj=False, embed=64, ffn_dim=64,
                    n_heads=2, pos_conv_k=16, pos_conv_groups=2,
                    conv_layers=((32, 10, 5), (32, 4, 4), (32, 4, 4),
                                 (32, 2, 2), (32, 2, 2)))
SMALL_SYNTH = dict(
    spec_channels=129, segment_size=640, inter_channels=32,
    hidden_channels=32, filter_channels=64, n_heads=2, n_layers=1,
    kernel_size=3, p_dropout=0.0, resblock="1",
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
    upsample_rates=(10, 16), upsample_initial_channel=32,
    upsample_kernel_sizes=(20, 32), spk_embed_dim=2, gin_channels=16,
    sr=16000, encoder_dim=64, use_f0=True)
TOL = 2e-3  # of full scale, the offline pipeline's sample-level gate


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes, and
    torch's default pool in each of them oversubscribes the cores (this
    file's small operations ran 5-25x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class DeterministicJaxSynthesizer(JaxSynthesizer):
    def infer(self, *args, **kw):
        kw.update(deterministic=True, noise_scale=0.0)
        return JaxSynthesizer.infer(self, *args, **kw)


def voice(n, seed=0, sr=16000):
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / sr
    ph = 2 * np.pi * np.cumsum(200 + 50 * np.sin(2 * np.pi * 0.8 * tt)) / sr
    x = 0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)
    return (x + 0.005 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    """Both packages' models from one set of weights, and both indexes."""
    seed_net = seeded(Synthesizer, 51, **SMALL_SYNTH)
    # the upsamplers at a trained model's scale, not the initialisation's
    # 0.01: otherwise the audio is the decoder's bias pattern, periodic in
    # the hop whatever the input, every SOLA offset one period apart
    # correlates equally (margins of 1e-7), and which one wins is decided
    # by rounding.  At 30x the margins are 1e-3 and more.
    with torch.no_grad():
        for up in seed_net.dec.ups:
            up.weight.mul_(30.0)
    sd = reference_state(seed_net, 52)
    synth = Synthesizer(**SMALL_SYNTH).eval()
    synth.load_state_dict(synthesizer_state_from_reference(sd))
    hub, jax_hub_vars = hubert_pair(SMALL_HUBERT, 53)
    e2e, jax_e2e, jax_e2e_vars = e2e_pair(TINY, 54)
    jest = JaxRMVPE(variables=jax_e2e_vars)
    jest.model = jax_e2e
    vecs = np.random.default_rng(55).standard_normal((300, 64)).astype(
        np.float32)
    return dict(
        synth=synth, hub=hub, rmvpe=RMVPE(model=e2e, device="cpu"),
        index=FeatureIndex(vecs, (vecs * vecs).sum(1)),
        jax_hub=JaxHubert(**SMALL_HUBERT), jax_hub_vars=jax_hub_vars,
        jax_synth=DeterministicJaxSynthesizer(**SMALL_SYNTH,
                                              weight_norm=True),
        jax_synth_vars=jax_synth_params(sd, SMALL_SYNTH), jax_rmvpe=jest,
        jax_index=JaxIndex(vecs, (vecs * vecs).sum(1)), jax_engines={})


def engines(world, index_rate=0.0, **kw):
    """A fresh port engine, and the JAX engine for this index setting with
    its pitch caches and settings reset (its compiled graphs are kept)."""
    w = world
    port = rt.RealtimeVC(
        hubert=w["hub"], synth=w["synth"], version="v2", if_f0=1,
        index=w["index"] if index_rate else None, index_rate=index_rate,
        noise_scale=0.0, deterministic=True, device="cpu", **kw)
    port.f0_gen._estimators["rmvpe"] = w["rmvpe"]
    if index_rate not in w["jax_engines"]:
        w["jax_engines"][index_rate] = jax_rt.RealtimeVC(
            hubert=w["jax_hub"], hubert_vars=w["jax_hub_vars"],
            synth=w["jax_synth"], synth_vars=w["jax_synth_vars"],
            version="v2", if_f0=1,
            index=w["jax_index"] if index_rate else None,
            index_rate=index_rate)
    jeng = w["jax_engines"][index_rate]
    jeng.f0_gen._estimators["rmvpe"] = w["jax_rmvpe"]
    jeng.cache_pitch[:], jeng.cache_pitchf[:] = 0, 0.0
    jeng.f0_up_key = kw.get("f0_up_key", 0.0)
    jeng.formant_shift = kw.get("formant_shift", 0.0)
    jeng.index_rate = index_rate
    return port, jeng


# ---------------------------------------------------------------------------
# RealtimeVC.infer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f0method,index_rate,formant,protect", [
    ("pm", 0.0, 0.0, 1.0), ("rmvpe", 0.6, 0.0, 0.33), ("pm", 0.6, 2.0, 1.0),
    ("rmvpe", 0.0, -1.5, 0.33)])
def test_realtime_infer_matches_jax(world, f0method, index_rate, formant,
                                    protect):
    """Two consecutive blocks of a 1 s window, 160 ms block, 28 frames
    returned: output length, audio within 2e-3 of full scale, and the
    1024-frame pitch caches (coarse equal, Hz rtol 1e-4) after each."""
    port, jeng = engines(world, index_rate, f0_up_key=3.0,
                         formant_shift=formant)
    audio = voice(16000 + 2560, seed=7)
    for blk in range(2):
        win = audio[blk * 2560: blk * 2560 + 16000]
        got = port.infer(win, 2560, skip_head=64, return_length=28,
                         f0method=f0method, protect=protect)
        want = jeng.infer(win, 2560, skip_head=64, return_length=28,
                          f0method=f0method, protect=protect)
        assert got.dtype == np.float32 and got.shape == want.shape
        if formant == 0:
            assert got.shape == (28 * 160,)
        else:
            assert abs(len(got) - 28 * 160) <= 160
        assert np.isfinite(got).all() and np.abs(got).max() > 1e-3
        assert np.abs(got - want).max() < TOL
        np.testing.assert_array_equal(port.cache_pitch, jeng.cache_pitch)
        np.testing.assert_allclose(port.cache_pitchf, jeng.cache_pitchf,
                                   rtol=1e-4)
        n_new = rt.f0_tail_samples(2560, f0method) // 160 - 4
        assert port.cache_pitchf[-n_new:].min() > 0
        assert (port.cache_pitch[: 1024 - n_new - 16 * blk] == 0).all()


def test_realtime_infer_given_pitch_and_no_f0(world):
    """A (pitch, pitchf) tuple bypasses the estimator and the caches; an
    if_f0 = 0 engine passes no pitch at all (the decoder has none to use,
    so it raises on this f0 model as the JAX engine's would)."""
    port, jeng = engines(world)
    win = voice(16000, seed=8)
    pitch = np.full(100, 120, np.int32)
    pitchf = np.full(100, 220.0, np.float32)
    got = port.infer(win, 2560, 64, 28, f0method=(pitch, pitchf))
    want = jeng.infer(win, 2560, 64, 28, f0method=(pitch, pitchf))
    assert np.abs(got - want).max() < TOL
    assert not port.cache_pitch.any()
    for setter, name in (("set_key", "f0_up_key"),
                         ("set_formant", "formant_shift"),
                         ("set_index_rate", "index_rate")):
        getattr(port, setter)(0.5)
        assert getattr(port, name) == 0.5


# ---------------------------------------------------------------------------
# StreamSession
# ---------------------------------------------------------------------------

SESSION = dict(block_time=0.16, crossfade_time=0.04, extra_time=0.5,
               rms_mix_rate=1.0)


def run_session(sess, audio, n_blocks, events=None):
    outs = []
    for i in range(n_blocks):
        for fn in (events or {}).get(i, ()):
            fn(sess)
        outs.append(sess.feed(
            audio[i * sess.block_frame: (i + 1) * sess.block_frame]))
    return np.concatenate(outs)


@pytest.mark.parametrize("f0method,samplerate,index_rate", [
    ("pm", 32000, 0.6), ("rmvpe", 16000, 0.0)])
def test_stream_session_matches_jax(world, f0method, samplerate, index_rate):
    """6 blocks through the host path and the fused path, each within 2e-3
    of full scale of the JAX session on that path, and fused against host
    within the port.  At 32 kHz the stream is resampled both ways."""
    audio = voice(int(samplerate * 0.16) * 6, seed=9, sr=samplerate)
    kw = dict(samplerate=samplerate, f0method=f0method, protect=0.33,
              **SESSION)
    outs = {}
    for fused in (False, True):
        port, jeng = engines(world, index_rate)
        sess = rt.StreamSession(port, fused=fused, **kw)
        jsess = jax_rt.StreamSession(jeng, fused=fused, **kw)
        assert (sess._fused is not None) == fused
        assert (jsess._fused is not None) == fused
        got = run_session(sess, audio, 6)
        want = run_session(jsess, audio, 6)
        assert got.shape == want.shape == (6 * sess.block_frame,)
        assert np.isfinite(got).all() and np.abs(got).max() > 1e-3
        assert np.abs(got - want).max() < TOL, fused
        outs[fused] = got
        if fused:
            st = sess._fused_state
            np.testing.assert_allclose(
                st["wav16"].numpy(), np.asarray(jsess._fused_state["wav16"]),
                atol=1e-5)
            np.testing.assert_array_equal(
                st["cache_pitch"].numpy(),
                np.asarray(jsess._fused_state["cache_pitch"]))
    assert np.abs(outs[True] - outs[False]).max() < TOL


def test_stream_session_sliders_park_and_restore_fused(world):
    """An RMS-mix slider below 1 parks the fused path and the host path
    takes over from the resampled stream buffer; back at 1 the fused path
    is restored with a fresh state.  Held to the JAX session through the
    same slider moves; a formant shift parks it the same way."""
    audio = voice(2560 * 7, seed=10)
    kw = dict(samplerate=16000, f0method="pm", **SESSION)
    events = {2: [lambda s: s.set_rms_mix_rate(0.5), lambda s: s.set_key(2.0)],
              4: [lambda s: s.set_rms_mix_rate(1.0)]}
    port, jeng = engines(world)
    sess, jsess = rt.StreamSession(port, **kw), jax_rt.StreamSession(jeng, **kw)
    graph, state0 = sess._fused, sess._fused_state
    assert graph is not None
    got = run_session(sess, audio, 2)
    sess.set_rms_mix_rate(0.5)
    assert sess._fused is None and sess._fused_saved is graph
    window = sess._resampled_window().numpy()
    np.testing.assert_array_equal(sess.input_wav_res, window)
    assert np.abs(window[-2 * 2560:]).max() > 0.1   # not a silent context
    sess.set_rms_mix_rate(1.0)
    assert sess._fused is graph and sess._fused_saved is None
    assert sess._fused_state is not state0
    np.testing.assert_array_equal(sess._fused_state["wav16"].numpy(), window)
    assert not sess._fused_state["cache_pitch"].any()

    port, jeng = engines(world)
    sess, jsess = rt.StreamSession(port, **kw), jax_rt.StreamSession(jeng, **kw)
    got = run_session(sess, audio, 7, events)
    want = run_session(jsess, audio, 7, events)
    assert sess._fused is not None and port.f0_up_key == 2.0
    assert np.abs(got - want).max() < TOL

    sess.set_formant(1.0)
    assert sess._fused is None and port.formant_shift == 1.0
    out = sess.feed(audio[: sess.block_frame])
    assert out.shape == (sess.block_frame,) and np.isfinite(out).all()
    sess.set_formant(0.0)
    assert sess._fused is not None
    sess.set_index_rate(0.0)
    assert port.index_rate == 0.0


def test_fused_graph_state_and_fetch(world):
    """The returned state shares no memory with the argument, the argument
    is left as it was, and fetch=False returns the block on the device."""
    port, _ = engines(world)
    fused = rt.FusedStreamGraph(port, stream_sr=16000, block_frame=2560,
                                ctx_frame=320, total_len=16000, skip_head=64,
                                return_length=28, f0method="pm")
    state = fused.init_state()
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == {
        "wav16": ((16000,), torch.float32),
        "cache_pitch": ((1024,), torch.int32),
        "cache_pitchf": ((1024,), torch.float32)}
    seg = voice(2560 + 320, seed=11)
    out, new = fused(state, seg, fetch=False)
    assert isinstance(out, torch.Tensor) and out.shape == (28 * 160,)
    for k in state:
        assert new[k].data_ptr() != state[k].data_ptr()
        assert not state[k].any()
    np.testing.assert_allclose(new["wav16"][-2560 - 160:].numpy(),
                               seg[160:], atol=1e-6)  # 16 kHz: no resample
    out2, _ = fused(new, seg)
    assert isinstance(out2, np.ndarray) and out2.shape == (28 * 160,)


# ---------------------------------------------------------------------------
# what the port refuses, where it runs, what it imports
# ---------------------------------------------------------------------------


def test_no_quiet_fallbacks(world, tmp_path, monkeypatch):
    """Noise reduction is a host-path feature: a session with either flag
    runs there and builds no fused graph, as the JAX session; a missing
    rmvpe.pt raises where the estimator is built (the fused path's
    construction, the host path's first block) instead of switching path
    or estimator; fcpe without its checkpoint raises too and does not
    turn into pm."""
    port = rt.RealtimeVC(hubert=world["hub"], synth=world["synth"],
                         rmvpe_root=str(tmp_path), deterministic=True,
                         noise_scale=0.0, device="cpu")
    for kw in (dict(input_noise_reduce=True), dict(output_noise_reduce=True)):
        sess = rt.StreamSession(port, 16000, f0method="pm", **SESSION, **kw)
        assert sess._fused is None and sess._fused_saved is None
        out = sess.feed(voice(sess.block_frame, seed=12))
        assert out.shape == (sess.block_frame,) and np.isfinite(out).all()
    with pytest.raises(FileNotFoundError):
        rt.StreamSession(port, 16000, f0method="rmvpe", **SESSION)
    sess = rt.StreamSession(port, 16000, f0method="rmvpe", fused=False,
                            **SESSION)
    assert sess._fused is None and sess._fused_saved is None
    with pytest.raises(FileNotFoundError):
        sess.feed(np.zeros(sess.block_frame, np.float32))
    monkeypatch.chdir(tmp_path)   # no assets/fcpe/ here
    for fused in (True, False):
        with pytest.raises(FileNotFoundError, match="fcpe"):
            rt.StreamSession(port, 16000, f0method="fcpe", fused=fused,
                             **SESSION).feed(
                np.zeros(sess.block_frame, np.float32))


def test_realtime_device_rule(world):
    """The new entry points mean CUDA unless told otherwise and raise
    without it; given "cpu" they hold everything on the CPU."""
    from tpu_rvc_torch.f0.gen import Generator
    from tpu_rvc_torch.f0.pm import PM
    port, _ = engines(world)
    assert port.device.type == "cpu" and port.f0_gen.device.type == "cpu"
    assert next(port.synth.parameters()).device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for build in (
            lambda: rt.RealtimeVC(hubert=world["hub"], synth=world["synth"]),
            lambda: RMVPE(model=world["rmvpe"].model), lambda: PM(),
            lambda: Generator()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import tpu_rvc_torch.pipeline.rt, tpu_rvc_torch.f0.gen\n"
        "import tpu_rvc_torch.f0.rmvpe, tpu_rvc_torch.models.rmvpe\n"
        "import tpu_rvc_torch.ckpt.rmvpe_loader, tpu_rvc_torch.ops.stft\n"
        "import tpu_rvc_torch.ops.mel, tpu_rvc_torch.retrieval.index\n"
        "import tpu_rvc_torch.audio.torchgate, tpu_rvc_torch.pipeline.serve\n"
        "import tpu_rvc_torch.pipeline.live, tpu_rvc_torch.apps.serve\n"
        "import tpu_rvc_torch.audio.native_ring\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpu_rvc'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
