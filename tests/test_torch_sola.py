"""tpu_rvc_torch's streaming loop's host-side pieces against tpu_rvc's on
the CPU: the block geometry, the SOLA merge and the phase vocoder.  (The
engine and `StreamSession` are held in tests/test_torch_realtime.py.)"""

import numpy as np
import pytest

from tpu_rvc.pipeline import rt as jax_rt

from tpu_rvc_torch.pipeline import rt

from test_torch_realtime import voice


# ---------------------------------------------------------------------------
# host-side pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(48000, 0.25, 0.05, 2.5),
                                  (16000, 0.16, 0.04, 0.5),
                                  (44100, 0.1, 0.08, 1.0),
                                  (32000, 0.2, 0.01, 0.3)])
def test_block_geometry_matches_jax(args):
    got, want = rt.BlockGeometry(*args), jax_rt.BlockGeometry(*args)
    for name in ("sr", "zc", "block_frame", "crossfade_frame",
                 "sola_buffer_frame", "sola_search_frame", "extra_frame",
                 "total", "skip_head", "return_length"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_allclose(got.fade_in, want.fade_in, atol=1e-6)
    np.testing.assert_allclose(got.fade_out, want.fade_out, atol=1e-6)
    if args[0] == 48000:  # the defaults' window: 281 frames, 250 + 30
        assert (got.total, got.skip_head, got.return_length) == (134880, 250,
                                                                 30)


@pytest.mark.parametrize("use_pv", [False, True])
@pytest.mark.parametrize("short", [False, True])
def test_sola_merge_matches_jax(use_pv, short):
    rng = np.random.default_rng(3 + use_pv)
    geo = rt.BlockGeometry(16000, 0.16, 0.04, 0.5)
    need = geo.block_frame + geo.sola_buffer_frame + geo.sola_search_frame
    wav = voice(need - (37 if short else 0), seed=4)
    buf = wav[53: 53 + geo.sola_buffer_frame] * 0.9 \
        + 0.01 * rng.standard_normal(geo.sola_buffer_frame).astype(np.float32)
    args = (wav, buf.astype(np.float32), geo.fade_in, geo.fade_out,
            geo.block_frame, geo.sola_buffer_frame, geo.sola_search_frame)
    got, got_buf = rt.sola_merge(*args, use_pv=use_pv)
    want, want_buf = jax_rt.sola_merge(*args, use_pv=use_pv)
    assert got.shape == (geo.block_frame,)
    assert got_buf.shape == (geo.sola_buffer_frame,)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got_buf, want_buf, atol=1e-6)


@pytest.mark.parametrize("n", [64, 641])
def test_phase_vocoder_matches_jax(n):
    fade_in = np.sin(0.5 * np.pi * np.linspace(0, 1, n)) ** 2
    a = voice(n, 5).astype(np.float64)
    b = voice(n + 9, 6)[9:].astype(np.float64)
    got = rt.phase_vocoder(a, b, 1.0 - fade_in, fade_in)
    want = jax_rt.phase_vocoder(a, b, 1.0 - fade_in, fade_in)
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want, atol=1e-6)
