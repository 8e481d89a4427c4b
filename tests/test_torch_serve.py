"""tpu_rvc_torch's multi-stream serving against tpu_rvc's on the CPU:
`StreamSession`'s noise reduction, `BatchedRealtimeVC`,
`FusedStreamGraph(n_streams=2)` with the `fed` mask, and `SlotScheduler`
block for block; then the port alone: a batch is its streams, stacked.
(The STFT pair and the denoiser are in tests/test_torch_torchgate.py; the
scheduler loop and the TCP server alone in tests/test_torch_serve_loop.py.)

Sizes are those of tests/test_serve.py (16 kHz, 160 ms blocks, 2 slots,
pm).  Inputs come from numpy seeds; both sides are deterministic (see
`_torch_parity.DeterministicJaxSynthesizer`).  TOL is 2e-3 of full scale,
the offline pipeline's sample-level gate.
"""

import numpy as np
import pytest
import torch

from tpu_rvc.pipeline import rt as jax_rt

from tpu_rvc_torch.ops.kernels import stage_plain
from tpu_rvc_torch.pipeline import rt

from _torch_inputs import stage_inputs, stage_weights
from _torch_parity import (SERVE_GEOMETRY, engine_pair, scheduler_pair,
                           serving_world, stream_voice)

TOL = 2e-3
BF = 2560  # 160 ms at 16 kHz


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes, and
    torch's default pool in each of them oversubscribes the cores (this
    file's small operations ran 5-25x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
