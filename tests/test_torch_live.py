"""tpu_rvc_torch's live duplex loop against tpu_rvc's on the CPU: the
40 ms rolling RMS gate (exact), `process_available` on the same blocks
through both packages' sessions (2e-3 of full scale), the ring buffer
binding, the callback's layouts and the persisted settings.

Sizes are those of tests/test_serve.py (16 kHz, 160 ms blocks, pm); inputs
come from numpy seeds and both engines are deterministic.
"""

import threading

import numpy as np
import pytest
import torch

from tpu_rvc.audio import native_ring as jax_ring
from tpu_rvc.pipeline import live as jax_live
from tpu_rvc.pipeline import rt as jax_rt

from tpu_rvc_torch.audio import native_ring
from tpu_rvc_torch.pipeline import live, rt

from _torch_parity import (SERVE_GEOMETRY, engine_pair, serving_world,
                           stream_voice)

TOL = 2e-3
BF = 2560


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes, and
    torch's default pool in each of them oversubscribes the cores (this
    file's small operations ran 5-25x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class EchoSession:
    """A session that returns its block: what LiveLoop needs of one."""

    block_frame, zc = BF, 160

    def __init__(self):
        self.fed, self.calls = [], []

    def feed(self, block):
        self.fed.append(np.array(block))
        return block

    def __getattr__(self, name):
        if name.startswith("set_"):
            return lambda v: self.calls.append((name, v))
        raise AttributeError(name)


def gated_audio(n_blocks, seed):
    """Speech-like audio with quiet stretches that start and end inside
    blocks, so that the rolling history across blocks matters."""
    x = stream_voice(n_blocks * BF, seed=seed)
    env = np.ones_like(x)
    for lo, hi in ((1000, 2200), (2400, 2900), (BF * 2 - 300, BF * 2 + 500),
                   (BF * 3 + 37, BF * 3 + 1700)):
        env[lo:hi] = 0.001
    return (x * env).astype(np.float32)


@pytest.mark.parametrize("threshold_db", [-20.0, -40.0, -90.0])
def test_gate_is_exactly_the_jax_gate(threshold_db):
    """The same blocks through both `_gate`s: bit-identical output and
    history, block after block; -90 dB gates nothing and returns the block
    itself."""
    loop = live.LiveLoop(EchoSession(), threshold_db=threshold_db)
    jloop = jax_live.LiveLoop(EchoSession(), threshold_db=threshold_db)
    audio = gated_audio(5, seed=40)
    muted = 0
    for i in range(5):
        block = audio[i * BF:(i + 1) * BF]
        got, want = loop._gate(block), jloop._gate(block)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(loop._rms_buffer, jloop._rms_buffer)
        muted += int((got == 0).sum())
        if threshold_db == -90.0:
            assert got is block
    if threshold_db == -20.0:
        assert muted >= 1600 and muted % 160 == 0  # whole 10 ms frames
    assert len(loop._rms_buffer) == 4 * 160


@pytest.fixture(scope="module")
def world():
    return serving_world(seed=71)


def test_process_available_matches_jax(world):
    """Both loops over real sessions (fused path, pm), fed by the audio
    callback in device blocks of 1000 samples: the same number of blocks
    processed, the converted audio within 2e-3 of full scale, the gate on,
    a mid-stream key change through the loop's setter."""
    port, jeng = engine_pair(world)
    kw = dict(f0method="pm", **SERVE_GEOMETRY)
    loop = live.LiveLoop(rt.StreamSession(port, **kw), threshold_db=-30.0)
    jloop = jax_live.LiveLoop(jax_rt.StreamSession(jeng, **kw),
                              threshold_db=-30.0)
    audio = gated_audio(4, seed=41)
    outs, jouts = [], []
    for i, at in enumerate(range(0, len(audio) - 999, 1000)):
        for lp, sink in ((loop, outs), (jloop, jouts)):
            out = np.empty((1000, 2), np.float32)
            lp.callback(audio[at: at + 1000, None], out)
            np.testing.assert_array_equal(out[:, 0], out[:, 1])
            sink.append(out[:, 0].copy())
            done = lp.process_available()
            assert done in (0, 1)
        if i == 4:
            loop.set_key(2.0), jloop.set_key(2.0)
    assert loop.blocks_processed == jloop.blocks_processed == 3
    got, want = np.concatenate(outs), np.concatenate(jouts)
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-3
    assert np.abs(got - want).max() < TOL
    assert port.f0_up_key == 2.0
    st, jst = loop.stats(), jloop.stats()
    assert st["blocks_processed"] == 3 and st["in"] == jst["in"]
    assert st["out"] == jst["out"] and st["out"]["underruns"] > 0


def test_live_loop_callback_layouts_setters_and_run():
    sess = EchoSession()
    loop = live.LiveLoop(sess, ring_blocks=4)
    mono_out = np.ones(BF, np.float32)
    loop.callback(np.full(BF, 0.25, np.float32), mono_out)
    assert not mono_out.any()                  # nothing converted yet
    assert loop.process_available() == 1 and loop.process_available() == 0
    stereo_out = np.empty((BF, 2), np.float32)
    loop.callback(np.full((BF, 2), 0.5, np.float32), stereo_out)
    np.testing.assert_array_equal(stereo_out, np.full((BF, 2), 0.25))
    for name in ("set_key", "set_formant", "set_index_rate",
                 "set_rms_mix_rate"):
        getattr(loop, name)(1.5)
    assert sess.calls == [(n, 1.5) for n in (
        "set_key", "set_formant", "set_index_rate", "set_rms_mix_rate")]
    stop = threading.Event()
    worker = threading.Thread(target=loop.run, args=(stop,))
    worker.start()
    try:
        deadline = 1000
        while loop.blocks_processed < 2 and deadline:
            stop.wait(0.01)
            deadline -= 1
    finally:
        stop.set()
        worker.join(timeout=10)
    assert not worker.is_alive() and loop.blocks_processed == 2
    assert loop.stats()["in"]["underruns"] == 0


@pytest.mark.parametrize("force_numpy", [False, True])
def test_ring_buffer_matches_jax_binding(monkeypatch, force_numpy):
    """The port's binding loads the same native library (or, without it,
    the same numpy ring): identical reads, counts and statistics through a
    wrap-around, an overrun and an underrun."""
    if force_numpy:
        monkeypatch.setattr(native_ring, "_LIB", False)
        monkeypatch.setattr(jax_ring, "_LIB", False)
        assert not native_ring.is_native()
    assert native_ring.is_native() == (jax_ring._lib() is not None)
    assert native_ring.LIB_PATH == jax_ring.LIB_PATH
    ring = native_ring.NativeRingBuffer(10)
    jring = jax_ring.NativeRingBuffer(10)
    assert ring.is_native == native_ring.is_native()
    x = np.arange(40, dtype=np.float32)
    for op, n in (("w", 6), ("r", 4), ("w", 7), ("r", 3), ("w", 9), ("r", 12),
                  ("r", 2), ("w", 25), ("r", 10)):
        if op == "w":
            assert ring.write(x[:n]) == jring.write(x[:n])
            x = x[n:] if len(x) > 2 * n else np.arange(40, dtype=np.float32)
        else:
            np.testing.assert_array_equal(ring.read(n), jring.read(n))
        assert ring.readable() == jring.readable()
    assert ring.stats() == jring.stats()
    assert ring.stats()["overruns"] > 0 and ring.stats()["underruns"] > 0


def test_live_config_round_trip_and_device_listing(tmp_path):
    p = str(tmp_path / "inuse" / "config.json")
    cfg = live.LiveConfig(pth_path="m.pth", pitch=7.0, formant=0.5,
                          f0method="pm", use_pv=True, samplerate=40000)
    cfg.save(p)
    assert live.LiveConfig.load(p) == cfg
    assert jax_live.LiveConfig.load(p).__dict__ == cfg.__dict__
    assert live.LiveConfig().__dict__ == jax_live.LiveConfig().__dict__
    with open(p, "w") as f:
        f.write('{"pitch": 3.0, "no_such_field": 1}')
    part = live.LiveConfig.load(p)
    assert part.pitch == 3.0 and part.block_time == 0.25
    for text in ("[1, 2]", "{not json"):
        with open(p, "w") as f:
            f.write(text)
        assert live.LiveConfig.load(p) == live.LiveConfig()
    assert live.LiveConfig.load(str(tmp_path / "none.json")) == \
        live.LiveConfig()
    devs = live.list_audio_devices()
    assert set(devs) == {"hostapis", "input", "output"}
    assert all(isinstance(v, list) for v in devs.values())
