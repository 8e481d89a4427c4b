"""tpu_rvc_torch's multi-stream serving against tpu_rvc's on the CPU: the
complex STFT pair, the spectral-gate denoiser, `StreamSession`'s noise
reduction, `BatchedRealtimeVC`, `FusedStreamGraph(n_streams=2)` with the
`fed` mask, and `SlotScheduler` block for block; then the port alone:
batched against stream-by-stream, pipelined against serial, slot churn, and
the TCP server driven by both packages' clients.

Sizes are those of tests/test_serve.py (16 kHz, 160 ms blocks, 2 slots,
pm).  Inputs come from numpy seeds; both sides are deterministic (see
`_torch_parity.DeterministicJaxSynthesizer`).  TOL is 2e-3 of full scale,
the offline pipeline's sample-level gate.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_rvc.audio.torchgate import TorchGate as JaxTorchGate
from tpu_rvc.audio.torchgate import _amp_to_db as jax_amp_to_db
from tpu_rvc.ops import stft as jax_stft
from tpu_rvc.pipeline import rt as jax_rt
from tpu_rvc.pipeline import serve as jax_serve

from tpu_rvc_torch.apps import serve as app
from tpu_rvc_torch.audio.io import load_wav, save_wav
from tpu_rvc_torch.audio.torchgate import TorchGate
from tpu_rvc_torch.ops.kernels import stage_plain
from tpu_rvc_torch.ops.stft import istft, stft
from tpu_rvc_torch.pipeline import rt, serve

from _torch_inputs import stage_inputs, stage_weights
from _torch_parity import (SERVE_GEOMETRY, FakeClock, engine_pair,
                           scheduler_pair, serving_world, stream_voice)

TOL = 2e-3
BF = 2560  # 160 ms at 16 kHz
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world():
    return serving_world()


def graph_geometry(n_streams):
    geo = rt.BlockGeometry(**SERVE_GEOMETRY)
    return dict(stream_sr=geo.sr, block_frame=geo.block_frame,
                ctx_frame=2 * geo.zc, total_len=geo.total,
                skip_head=geo.skip_head, return_length=geo.return_length,
                f0method="pm", n_streams=n_streams)


@pytest.fixture(scope="module")
def jax_graph2(world):
    """The JAX package's two-stream graph: compiled once for the module,
    used directly and as the JAX scheduler's graph."""
    _, jeng = engine_pair(world)
    return jax_rt.FusedStreamGraph(jeng, **graph_geometry(2))


# ---------------------------------------------------------------------------
# stft / istft and TorchGate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop,win", [(640, 160, 640), (512, 128, 400)])
def test_stft_istft_match_jax_and_round_trip(rng, n_fft, hop, win):
    """Complex STFT with win_length and its inverse against the JAX pair
    (atol 1e-5), and istft(stft(x)) == x.  The inverse is compared and
    inverted away from the first and last frame's edges, where the summed
    squared window is near zero and the division amplifies rounding."""
    x = (0.3 * rng.standard_normal((2, 4000))).astype(np.float32)
    got = stft(torch.from_numpy(x), n_fft, hop, win)
    want = jax_stft.stft(jnp.asarray(x), n_fft, hop, win)
    assert got.shape == want.shape == (2, n_fft // 2 + 1,
                                       1 + (4000 - n_fft) // hop)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    T = n_fft + hop * (got.shape[-1] - 1)
    back = istft(got, n_fft, hop, win).numpy()
    jback = np.asarray(jax_stft.istft(want, n_fft, hop, win))
    assert back.shape == jback.shape == (2, T)
    mid = slice(n_fft, T - n_fft)
    np.testing.assert_allclose(back[:, mid], jback[:, mid], atol=1e-5)
    np.testing.assert_allclose(back[:, mid], x[:, :T][:, mid], atol=1e-5)
    cut = istft(got, n_fft, hop, win, length=3000).numpy()
    np.testing.assert_allclose(
        cut, np.asarray(jax_stft.istft(want, n_fft, hop, win, length=3000)),
        atol=1e-5)


def noisy_tone(rng, n=16000, batch=False):
    t = np.arange(n) / 16000
    x = 0.4 * np.sin(2 * np.pi * 220 * t) * (t > 0.3) \
        + 0.02 * rng.standard_normal(n)
    x = x.astype(np.float32)
    return np.stack([x, x[::-1].copy()]) if batch else x


@pytest.mark.parametrize("nonstationary", [False, True])
@pytest.mark.parametrize("batch,with_xn", [(False, False), (False, True),
                                           (True, False)])
def test_torchgate_matches_jax(rng, nonstationary, batch, with_xn):
    """1-D and 2-D input, with and without a noise clip, both modes: atol
    1e-4 of full scale.  The stationary mask is a hard threshold, and some
    of these 32,000 bins lie within 1e-4 dB of theirs, so the masks are
    compared too, by their disagreement rate: the port's against one made
    from the JAX package's own spectrogram and dB functions, at most one
    bin in 10,000."""
    kw = dict(nonstationary=nonstationary, n_fft=640, prop_decrease=0.9)
    x = noisy_tone(rng, batch=batch)
    xn = (0.02 * rng.standard_normal(32000)).astype(np.float32) \
        if with_xn else None
    port = TorchGate(16000, device="cpu", **kw)
    got = port(x, xn)
    jtg = JaxTorchGate(16000, **kw)
    want = jtg(x, xn)
    assert got.dtype == np.float32 and got.shape == x.shape == want.shape
    assert np.abs(got - want).max() < 1e-4
    if not nonstationary:
        mask, _ = port.signal_mask(
            torch.from_numpy(np.atleast_2d(x)),
            None if xn is None else torch.from_numpy(xn[None]))
        x_db = jax_amp_to_db(jtg._spec(jnp.asarray(np.atleast_2d(x))))
        n_db = x_db if xn is None else jax_amp_to_db(
            jtg._spec(jnp.asarray(xn[None])))
        thresh = jnp.mean(n_db, -1) + jnp.std(n_db, -1, ddof=1) * jtg.n_std
        jmask = np.where(np.asarray(x_db > thresh[..., None]), 1.0, 0.1)
        np.testing.assert_allclose(np.unique(mask.numpy()), [0.1, 1.0],
                                   atol=1e-6)
        assert np.mean(np.abs(mask.numpy() - jmask) > 0.5) <= 1e-4
    # it does gate: the noise-only head loses most of its energy
    head = np.atleast_2d(got)[0, 640:4000]
    assert np.sqrt(np.mean(head ** 2)) < 0.5 * 0.02


def test_torchgate_filter_and_device_rule():
    port = TorchGate(16000, n_fft=640, device="cpu")
    want = JaxTorchGate(16000, n_fft=640).smoothing_filter
    np.testing.assert_array_equal(port.smoothing_filter, want)
    assert TorchGate(16000, freq_mask_smooth_hz=None,
                     time_mask_smooth_ms=None,
                     device="cpu").smoothing_filter is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchGate(16000)


# ---------------------------------------------------------------------------
# engines and sessions against tpu_rvc
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag", ["input_noise_reduce", "output_noise_reduce"])
def test_stream_session_noise_reduce_matches_jax(world, flag):
    """6 blocks through the host path with one denoiser on: within 2e-3 of
    full scale of the JAX session; the fused path is not built."""
    port, jeng = engine_pair(world)
    kw = dict(f0method="pm", **SERVE_GEOMETRY, **{flag: True})
    sess = rt.StreamSession(port, **kw)
    jsess = jax_rt.StreamSession(jeng, **kw)
    assert sess._fused is None and jsess._fused is None
    rng = np.random.default_rng(21)
    audio = stream_voice(6 * BF, seed=20) \
        + (0.02 * rng.standard_normal(6 * BF)).astype(np.float32)
    for i in range(6):
        block = audio[i * BF:(i + 1) * BF]
        got, want = sess.feed(block), jsess.feed(block)
        assert got.shape == want.shape == (BF,) and got.dtype == np.float32
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() < TOL, i
    assert np.abs(got).max() > 1e-3
    if flag == "input_noise_reduce":
        np.testing.assert_allclose(sess.input_wav_denoise,
                                   jsess.input_wav_denoise, atol=1e-4)
        np.testing.assert_allclose(sess.nr_buffer, jsess.nr_buffer, atol=1e-4)
    else:
        np.testing.assert_allclose(sess.output_buffer, jsess.output_buffer,
                                   atol=TOL)


def test_batched_realtime_infer_matches_jax(world):
    """Two streams, two consecutive blocks of a 1 s window, with retrieval
    and protect: audio within 2e-3 of full scale, per-stream pitch caches
    equal (coarse) and within rtol 1e-4 (Hz); then given pitch tracks, one
    for both streams and one each."""
    port, jeng = engine_pair(world, index_rate=0.6, n_streams=2,
                             f0_up_key=2.0)
    audio = np.stack([stream_voice(16000 + BF, seed=22),
                      stream_voice(16000 + BF, seed=23, f0=290.0)])
    for blk in range(2):
        win = audio[:, blk * BF: blk * BF + 16000]
        got = port.infer(win, BF, skip_head=64, return_length=21,
                         f0method="pm", protect=0.33)
        want = jeng.infer(win, BF, skip_head=64, return_length=21,
                          f0method="pm", protect=0.33)
        assert got.dtype == np.float32 and got.shape == want.shape == (
            2, 21 * 160)
        assert np.abs(got - want).max() < TOL
        assert np.abs(got[0] - got[1]).max() > 1e-3  # streams of their own
        np.testing.assert_array_equal(port.cache_pitch, jeng.cache_pitch)
        np.testing.assert_allclose(port.cache_pitchf, jeng.cache_pitchf,
                                   rtol=1e-4)
    assert port.cache_pitch.shape == (2, 1024)
    assert (port.cache_pitch[0] != port.cache_pitch[1]).any()
    caches = port.cache_pitch.copy()
    win = audio[:, :16000]
    one = (np.full(100, 120, np.int32), np.full(100, 220.0, np.float32))
    each = (np.stack([one[0], one[0] + 9]), np.stack([one[1], one[1] * 1.3]))
    for given in (one, each):
        got = port.infer(win, BF, 64, 21, f0method=given, protect=0.33)
        want = jeng.infer(win, BF, 64, 21, f0method=given, protect=0.33)
        assert np.abs(got - want).max() < TOL
    np.testing.assert_array_equal(port.cache_pitch, caches)  # bypassed
    with pytest.raises(ValueError, match="input_wavs must be"):
        port.infer(win[:1], BF, 64, 21)


FED_PATTERN = [[True, True], [True, False], [False, True], [True, True]]


def test_fused_graph_two_streams_with_fed_mask_matches_jax(world, jax_graph2):
    """Four ticks of FusedStreamGraph(n_streams=2) under a `fed` pattern:
    fed rows within 2e-3 of full scale of the JAX graph's, the states
    alike (window atol 1e-5, coarse pitch equal), and on both sides the
    state rows of an unfed stream are bit-identical to the tick before."""
    port, _ = engine_pair(world)
    graph = rt.FusedStreamGraph(port, **graph_geometry(2))
    state, jstate = graph.init_state(), jax_graph2.init_state()
    assert state["wav16"].shape == (2, graph.total_16k)
    assert state["cache_pitch"].shape == (2, 1024)
    n_seg = BF + 320
    audio = np.stack([stream_voice(4 * BF + 320, seed=24),
                      stream_voice(4 * BF + 320, seed=25, f0=310.0)])
    for i, fed in enumerate(FED_PATTERN):
        seg = audio[:, i * BF: i * BF + n_seg]
        before = {k: v.clone() for k, v in state.items()}
        jbefore = {k: np.array(v) for k, v in jstate.items()}
        out, state = graph(state, seg, fed=np.asarray(fed))
        jout, jstate = jax_graph2(jstate, seg, fed=np.asarray(fed))
        assert out.shape == jout.shape == (2, graph.return_length * 160)
        for s in range(2):
            if fed[s]:
                assert np.abs(out[s] - jout[s]).max() < TOL, (i, s)
            for k in state:
                if not fed[s]:
                    assert torch.equal(state[k][s], before[k][s]), (i, s, k)
                    np.testing.assert_array_equal(np.asarray(jstate[k])[s],
                                                  jbefore[k][s])
            if fed[s]:
                assert not torch.equal(state["wav16"][s], before["wav16"][s])
        np.testing.assert_allclose(state["wav16"].numpy(),
                                   np.asarray(jstate["wav16"]), atol=1e-5)
        np.testing.assert_array_equal(state["cache_pitch"].numpy(),
                                      np.asarray(jstate["cache_pitch"]))
    # fed=None feeds every stream
    out_all, _ = graph(state, seg)
    out_true, _ = graph(state, seg, fed=np.asarray([True, True]))
    np.testing.assert_array_equal(out_all, out_true)


def test_slot_scheduler_matches_jax_scheduler(world, jax_graph2):
    """The same submits, in uneven chunks, to both packages' schedulers on
    one hand-advanced clock: a tick that feeds one slot only, one underrun,
    a detach and a re-attach on the freed slot.  Every collected piece has
    the same length and lies within 2e-3 of full scale, and stats() are
    equal after every tick."""
    sched, jsched, clock = scheduler_pair(world, jax_graph=jax_graph2)
    a = stream_voice(8 * BF, seed=26)
    b = stream_voice(8 * BF, seed=27, f0=300.0)
    c = stream_voice(4 * BF, seed=28, f0=150.0)
    pos = {}

    def both(fn):
        return fn(sched), fn(jsched)

    def submit(slot, audio, n):
        at = pos.get(id(audio), 0)
        both(lambda s: s.submit(slot, audio[at: at + n]))
        pos[id(audio)] = at + n

    def tick_and_compare(slots, expect_len):
        assert both(lambda s: s.ready()) == (True, True)
        st, jst = both(lambda s: s.tick())
        assert st == jst
        for slot, n in zip(slots, expect_len):
            got, want = both(lambda s: s.collect(slot))
            assert len(got) == len(want) == n, (slot, len(got), len(want))
            if n:
                assert np.isfinite(got).all()
                assert np.abs(got - want).max() < TOL
        return st

    assert both(lambda s: s.attach()) == (0, 0)
    assert both(lambda s: s.attach()) == (1, 1)
    assert both(lambda s: s.ready()) == (False, False)
    # t = 0: slot 0 has a block (in two chunks), slot 1 not yet
    submit(0, a, 1000), submit(0, a, 3000), submit(1, b, 2000)
    tick_and_compare((0, 1), (BF, 0))
    assert both(lambda s: s.pending(0)) == (4000 - BF, 4000 - BF)
    # t = 0.10: slot 1 completes its block, slot 0 is short and not overdue
    clock.t = 0.10
    submit(1, b, 1500), submit(0, a, 700)
    tick_and_compare((0, 1), (0, BF))
    # t = 0.17: slot 0 is a block_time past its last feed: silence, one
    # underrun, its queued samples stay; slot 1 (fed at 0.10) is not due
    clock.t = 0.17
    st = tick_and_compare((0, 1), (BF, 0))
    assert st["underruns"] == [1, 0] and st["blocks"] == [2, 1]
    assert both(lambda s: s.pending(0)) == (2140, 2140)
    # two more blocks each, submitted at once
    submit(0, a, 2 * BF), submit(1, b, 2 * BF)
    tick_and_compare((0, 1), (BF, BF))
    tick_and_compare((0, 1), (BF, BF))
    # slot 1's client leaves, a new one takes the slot and starts afresh
    both(lambda s: s.detach(1))
    assert both(lambda s: s.attach()) == (1, 1)
    st, jst = both(lambda s: s.stats())
    assert st == jst and st["blocks"][1] == 0
    submit(1, c, 3 * BF), submit(0, a, BF)
    st = tick_and_compare((0, 1), (BF, BF))
    st = tick_and_compare((0, 1), (0, BF))
    assert st["blocks"] == [5, 2] and st["underruns"] == [1, 0]
    assert st["active"] == 2 and st["slots"] == 2 and st["ticks"] == 7
    both(lambda s: s.detach(0)), both(lambda s: s.detach(1))


QUEUE_OPS = {
    "empty": [("pop", 0), ("pop", None), ("pop", 5)],
    "pop_zero_is_a_no_op": [("push", 5), ("push", 4), ("pop", 0),
                            ("pop", -3)],
    "split_a_chunk": [("push", 5), ("push", 4), ("pop", 7), ("pop", None)],
    "whole_chunks": [("push", 3), ("push", 3), ("push", 3), ("pop", 6),
                     ("pop", 3), ("pop", 1)],
    "more_than_queued": [("push", 4), ("pop", 9), ("push", 0), ("pop", None)],
    "clear": [("push", 6), ("clear", None), ("pop", None), ("push", 2),
              ("pop", 1), ("pop", 1)],
}


@pytest.mark.parametrize("case", sorted(QUEUE_OPS))
def test_chunk_queue_edge_cases(case):
    """Every operation gives what the JAX package's queue gives, and the
    lengths stay equal."""
    q, jq = serve._ChunkQueue(), jax_serve._ChunkQueue()
    at = 0
    for op, n in QUEUE_OPS[case]:
        if op == "push":
            pcm = np.arange(at, at + n, dtype=np.float32)
            at += n
            q.push(pcm), jq.push(pcm)
        elif op == "clear":
            q.clear(), jq.clear()
        else:
            got, want = q.pop(n), jq.pop(n)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        assert len(q) == len(jq)


# ---------------------------------------------------------------------------
# the port alone: a batch is its streams, stacked
# ---------------------------------------------------------------------------


def test_stage_plain_batched_equals_stacked(rng):
    """(N, C, T) through the plain stage == each (C, T) through it (1e-5):
    every stream is zero-padded on its own length."""
    ks = (3, 7, 11)
    x, ws, bs = stage_inputs(rng, 16, 90, ks)
    sw = stage_weights(ws, bs, ks)
    xb = torch.from_numpy(np.stack([x.T, 0.5 * x.T[:, ::-1], -x.T]).copy())
    got = stage_plain(xb, sw)
    assert got.shape == (3, 16, 90)
    want = torch.stack([stage_plain(row, sw) for row in xb])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_convert_window_batched_equals_stacked(world):
    port, _ = engine_pair(world, index_rate=0.6)
    rng = np.random.default_rng(29)
    wav = torch.from_numpy(np.stack([stream_voice(16000, seed=30),
                                     stream_voice(16000, seed=31, f0=280.0)]))
    pitch = torch.from_numpy(rng.integers(1, 255, (2, 100)).astype(np.int32))
    pitchf = torch.from_numpy(rng.uniform(80, 400, (2, 100)).astype(
        np.float32)) * (pitch > 40)
    args = (64, 21, 21, 0.33, 1)
    with torch.no_grad():
        got = port.convert_window(wav, pitch, pitchf, *args)
        want = torch.stack([port.convert_window(wav[s], pitch[s], pitchf[s],
                                                *args) for s in range(2)])
    assert got.shape == (2, 21 * 160)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fused_graph_batched_equals_single_streams(world):
    """Two ticks of the two-stream graph == two single-stream graphs fed
    the same segments: audio and every state tensor (1e-5)."""
    port, _ = engine_pair(world, index_rate=0.6)
    both = rt.FusedStreamGraph(port, **graph_geometry(2))
    singles = [rt.FusedStreamGraph(port, **graph_geometry(1))
               for _ in range(2)]
    state = both.init_state()
    states = [g.init_state() for g in singles]
    audio = np.stack([stream_voice(2 * BF + 320, seed=32),
                      stream_voice(2 * BF + 320, seed=33, f0=260.0)])
    for i in range(2):
        seg = audio[:, i * BF: i * BF + BF + 320]
        out, state = both(state, seg)
        for s in range(2):
            want, states[s] = singles[s](states[s], seg[s])
            np.testing.assert_allclose(out[s], want, atol=1e-5)
            for k in state:
                torch.testing.assert_close(state[k][s], states[s][k],
                                           rtol=1e-5, atol=1e-5)
    # one stream keeps the unbatched call: a bool `fed`, a 1-D state
    out, new = singles[0](states[0], seg[0], fed=False)
    assert out.shape == (both.return_length * 160,)
    for k in new:
        assert torch.equal(new[k], states[0][k])
        assert new[k].data_ptr() != states[0][k].data_ptr()


def run_lockstep(sched, audios, n_blocks):
    """Attach one client per audio, submit everything, tick until idle:
    per slot, what was collected after each tick."""
    slots = [sched.attach() for _ in audios]
    for slot, audio in zip(slots, audios):
        sched.submit(slot, audio[: n_blocks * sched.block_frame])
    got = [[] for _ in slots]
    while sched.ready():
        sched.tick()
        for i, slot in enumerate(slots):
            got[i].append(sched.collect(slot))
    sched.flush()
    flushed = [sched.collect(slot) for slot in slots]
    stats = sched.stats()
    for slot in slots:
        sched.detach(slot)
    return got, flushed, stats


def test_one_slot_scheduler_equals_stream_session(world):
    """n_slots = 1 takes the unbatched graph; its stream is the fused
    StreamSession's, sample for sample."""
    port, _ = engine_pair(world)
    sched = serve.SlotScheduler(port, 1, f0method="pm", clock=FakeClock(),
                                **SERVE_GEOMETRY)
    assert sched.state["wav16"].dim() == 1
    audio = stream_voice(4 * BF, seed=34)
    got, _, stats = run_lockstep(sched, [audio], 4)
    assert stats["blocks"] == [4] and stats["underruns"] == [0]
    port2, _ = engine_pair(world)
    sess = rt.StreamSession(port2, f0method="pm", **SERVE_GEOMETRY)
    want = np.concatenate([sess.feed(audio[i * BF:(i + 1) * BF])
                           for i in range(4)])
    np.testing.assert_allclose(np.concatenate(got[0]), want, atol=1e-6)
    # a new client on the slot starts from a zeroed device state
    got2, _, _ = run_lockstep(sched, [audio], 1)
    np.testing.assert_allclose(got2[0][0], want[:BF], atol=1e-6)


def test_pipelined_equals_serial_one_tick_later(world):
    """pipelined=True: the first tick delivers nothing, each later tick the
    block before, flush() the last; the streams are serial mode's, sample
    for sample."""
    audios = [stream_voice(4 * BF, seed=35),
              stream_voice(4 * BF, seed=36, f0=320.0)]
    runs = {}
    for pipelined in (False, True):
        port, _ = engine_pair(world)
        sched = serve.SlotScheduler(port, 2, f0method="pm", clock=FakeClock(),
                                    pipelined=pipelined, **SERVE_GEOMETRY)
        runs[pipelined] = run_lockstep(sched, audios, 4)
        assert runs[pipelined][2]["blocks"] == [4, 4]
        assert runs[pipelined][2]["underruns"] == [0, 0]
    (ser, ser_flush, _), (pip, pip_flush, _) = runs[False], runs[True]
    for s in range(2):
        assert [len(x) for x in ser[s]] == [BF] * 4 and len(ser_flush[s]) == 0
        assert [len(x) for x in pip[s]] == [0] + [BF] * 3
        assert len(pip_flush[s]) == BF
        np.testing.assert_array_equal(
            np.concatenate(pip[s] + [pip_flush[s]]), np.concatenate(ser[s]))
    assert np.abs(np.concatenate(ser[0]) - np.concatenate(ser[1])).max() > 1e-3


@pytest.fixture(scope="module")
def sched(world):
    port, _ = engine_pair(world)
    return serve.SlotScheduler(port, 2, f0method="pm", clock=FakeClock(),
                               **SERVE_GEOMETRY)


@pytest.mark.parametrize("pipelined", [False, True])
def test_reattach_between_consume_and_deliver(world, pipelined):
    """A detach and attach while the block is in flight (serial: during
    the call; pipelined: also between the tick that consumed the input and
    the one that delivers) must not hand the old client's audio to the
    new one: the generation check."""
    port, _ = engine_pair(world)
    sched = serve.SlotScheduler(port, 2, f0method="pm", clock=FakeClock(),
                                pipelined=pipelined, **SERVE_GEOMETRY)
    s = sched.attach()
    sched.submit(s, stream_voice(2 * BF, seed=37))
    graph, took_over = sched.fused, []

    def hijack(state, seg, fed=None, fetch=True):
        out, st = graph(state, seg, fed=fed, fetch=fetch)
        sched.detach(s)
        took_over.append(sched.attach())
        return out, st

    if not pipelined:
        sched.fused = hijack
    sched.tick()
    sched.fused = graph
    if pipelined:  # tick 1 consumed the input; the client changes now
        assert len(sched.collect(s)) == 0
        sched.detach(s)
        took_over.append(sched.attach())
        sched.flush()
    assert took_over == [s]
    assert len(sched.collect(s)) == 0
    assert sched.stats()["blocks"][s] == 0
    # the new client is served from its own first block on
    sched.submit(s, stream_voice(BF, seed=38))
    sched.tick(), sched.flush()
    assert len(sched.collect(s)) == BF and sched.stats()["blocks"][s] == 1


def test_attach_detach_capacity(sched):
    a, b = sched.attach(), sched.attach()
    with pytest.raises(RuntimeError, match="server full"):
        sched.attach()
    sched.detach(a)
    c = sched.attach()
    assert c == a and sched.stats()["blocks"][c] == 0
    assert sched.stats()["active"] == 2
    sched.detach(b), sched.detach(c)
    assert sched.stats()["active"] == 0


def test_scheduler_under_concurrent_clients(world):
    """Five client threads share two slots with one tick thread, thread
    switches forced often: every client that got a slot receives exactly
    the blocks it submitted (2 x BF finite samples, never a previous
    occupant's), the counters add up, and no thread dies or hangs."""
    port, _ = engine_pair(world)
    sched = serve.SlotScheduler(port, 2, f0method="pm", clock=FakeClock(),
                                **SERVE_GEOMETRY)
    stop, errors, served = threading.Event(), [], []

    def ticker():
        while not stop.is_set():
            if sched.ready():
                sched.tick()
            else:
                stop.wait(0.001)

    def client(i):
        try:
            for turn in range(2):
                while True:
                    try:
                        slot = sched.attach()
                        break
                    except RuntimeError:
                        stop.wait(0.002)
                audio = stream_voice(2 * BF, seed=100 + 10 * i + turn)
                got = np.zeros(0, np.float32)
                for part in np.array_split(audio, 7):
                    sched.submit(slot, part)
                    got = np.concatenate([got, sched.collect(slot)])
                while len(got) < 2 * BF and not stop.is_set():
                    stop.wait(0.002)
                    got = np.concatenate([got, sched.collect(slot)])
                blocks = sched.stats()["blocks"][slot]
                sched.detach(slot)
                assert len(got) == 2 * BF and np.isfinite(got).all()
                assert blocks == 2
                served.append(i)
        except BaseException as e:  # reported by the main thread below
            errors.append(e)
            raise

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=ticker)] + [
        threading.Thread(target=client, args=(i,)) for i in range(5)]
    try:
        for t in threads:
            t.start()
        for t in threads[1:]:
            t.join(timeout=120)
    finally:
        stop.set()
        threads[0].join(timeout=30)
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    assert sorted(served) == sorted(list(range(5)) * 2)
    st = sched.stats()
    assert st["active"] == 0 and st["underruns"] == [0, 0]
    assert st["ticks"] >= 10   # 20 blocks through 2 slots


def jax_package_client():
    """apps/serve.py of the JAX package, loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "jax_package_serve_app", os.path.join(REPO, "apps", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("client", ["port", "jax_package"])
def test_tcp_server_answers_both_packages_clients(sched, tmp_path, client):
    """The port's VCServer on an ephemeral port, driven over a real socket
    by the port's `stream_file` and by the JAX package's: the wire protocol
    is the same.  4 blocks in, 4 SOLA-merged blocks out, and a stats reply.
    The scheduler reads a hand-advanced clock, so no underrun can occur."""
    stream_file = (app.stream_file if client == "port"
                   else jax_package_client().stream_file)
    srv = app.VCServer(("127.0.0.1", 0), sched)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        in_path, out_path = str(tmp_path / "in.wav"), str(tmp_path / "o.wav")
        save_wav(in_path, stream_voice(4 * BF, seed=39), 16000)
        stats = stream_file("127.0.0.1", srv.server_address[1], in_path,
                            out_path, timeout=120.0)
        assert max(stats["blocks"]) >= 4
        assert stats["samplerate"] == 16000 and stats["block_frame"] == BF
        assert stats["underruns"] == [0, 0]
        y, sr = load_wav(out_path)
        assert sr == 16000 and len(y) == 4 * BF
        assert np.isfinite(y).all() and np.abs(y[BF:]).max() > 1e-3
    finally:
        srv.shutdown()
        srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive() and not srv._sched_thread.is_alive()


def test_server_full_and_unknown_command_over_the_wire(sched):
    """Raw frames over a socket: a third client of a 2-slot server is told
    "server full", an unknown command gets an error reply, set_key reaches
    the shared engine, stats come back as JSON."""
    srv = app.VCServer(("127.0.0.1", 0), sched)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    socks = []
    try:
        for want_ok in (True, True, False):
            s = socket.create_connection(srv.server_address, timeout=30)
            socks.append(s)
            tag, payload = app.recv_frame(s)
            hello = json.loads(payload)
            assert tag == b"J" and hello["ok"] is want_ok
            if not want_ok:
                assert "server full" in hello["error"]
        app.send_json(socks[0], {"cmd": "nonsense"})
        tag, payload = app.recv_frame(socks[0])
        assert json.loads(payload) == {"ok": False,
                                       "error": "unknown cmd nonsense"}
        app.send_json(socks[0], {"cmd": "set_key", "value": 3})
        app.send_json(socks[0], {"cmd": "stats"})
        tag, payload = app.recv_frame(socks[0])
        assert json.loads(payload)["active"] == 2
        assert sched.engine.f0_up_key == 3.0
        for s in socks[:2]:
            app.send_json(s, {"cmd": "bye"})
    finally:
        for s in socks:
            s.close()
        srv.shutdown()
        srv.server_close()
        sched.engine.set_key(0.0)
        for slot in range(2):
            sched.detach(slot)


def test_serve_app_help_imports_no_jax():
    """`python -m tpu_rvc_torch.apps.serve --help` prints its usage, and
    neither it nor the serving modules pull in jax, flax or tpu_rvc."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['serve', '--help']\n"
        "try:\n"
        "    runpy.run_module('tpu_rvc_torch.apps.serve',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "import tpu_rvc_torch.pipeline.serve, tpu_rvc_torch.pipeline.live\n"
        "import tpu_rvc_torch.audio.torchgate\n"
        "import tpu_rvc_torch.audio.native_ring\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpu_rvc', 'apps'))\n"
        "assert not bad, bad\n"
        "print('no-jax-ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "--slots" in out.stdout and "--device" in out.stdout
    assert "--aot-cache" not in out.stdout
    assert out.stdout.strip().endswith("no-jax-ok")
