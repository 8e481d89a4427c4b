"""Each driver at a tiny size on the CPU, as a run drives it (the look for
a card skipped): set-up, the traced window, the check against the
reference, the metrics; then the timed path broken underneath, once for
each fault the cell can have, and `correct` must come out false."""

import sys

import numpy as np
import pytest
import torch

from rvcbench import faults, run
from rvcbench.lib import cells
from rvcbench.tests.tiny import tiny_cell, tiny_config, tiny_train

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def offline(tmp_path_factory):
    cell, cfg = tiny_cell("v2-48k.offline"), tiny_config("rvc-v2-48k")
    drv = cells.driver("offline").Driver(cell, cfg, 2 ** 31 + 11, "cpu",
                                         str(tmp_path_factory.mktemp("off")))
    drv.setup()
    return drv


@pytest.fixture(scope="module")
def serve(tmp_path_factory):
    cell, cfg = tiny_cell("v2-40k.serve-n32"), tiny_config("rvc-v2-40k")
    drv = cells.driver("serve").Driver(cell, cfg, 2 ** 31 + 12, "cpu",
                                       str(tmp_path_factory.mktemp("srv")))
    drv.setup()
    return drv


def _rec(drv, seconds=2.5):
    rec = drv.window(seconds, None)
    rec["cell"], rec["cfg"] = drv.cell, drv.cfg
    return rec


@pytest.mark.parametrize("name", ["v2-48k.offline", "v2-40k.serve-n32",
                                  "v2-40k.train-b32"])
def test_a_traced_run_is_correct_and_reads_its_metrics(name, tmp_path):
    if name.endswith("train-b32"):
        cell, cfg = tiny_train(name)
    else:
        cell = tiny_cell(name)
        cfg = tiny_config(cell["config"])
    out = run.run_cell(name, 3 * 2 ** 31, 2.0, True, "cpu", str(tmp_path),
                       cell=cell, cfg=cfg)
    rec = out["rec"]
    assert run.passed(out["checks"]), out["checks"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert rec["flops"] > 0 and rec["spans"]
    for m in cells.metrics_for(name, False):
        assert cells.metric(m["name"]).read(rec) > 0, m["name"]
    layer = {"offline": "decoder_ms_per_audio_s.offline",
             "serve": "f0_ms.serve", "train": "g_step_ms.train"}
    assert cells.metric(layer[cell["entry"]]).read(rec) > 0
    assert rec["trace"]["window_s"] > 0
    # nothing of JAX or of the JAX package, by whole top-level names
    assert run.forbidden_modules() == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_rvc_torchlike", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like.sub", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_rvc.pipeline", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.forbidden_modules() == ["jax", "tpu_rvc"]


def test_offline_sound_window_is_correct(offline):
    checks = offline.check(_rec(offline))
    assert run.passed(checks), checks


@pytest.mark.parametrize("how", faults.FAULTS["offline"])
def test_offline_faults_are_not_correct(offline, how):
    take_out = faults.plant("offline", how)
    try:
        assert not run.passed(offline.check(_rec(offline)))
    finally:
        take_out()


@pytest.mark.parametrize("how", faults.FAULTS["serve"])
def test_serve_faults_are_not_correct(serve, how):
    take_out = faults.plant("serve", how)
    try:
        assert not run.passed(serve.check(_rec(serve, 4.0)))
    finally:
        take_out()


@pytest.mark.parametrize("period", [0, 1, 2])
def test_sola_follow_takes_a_tied_offset_and_no_other(period):
    """Two offsets a pitch period apart score alike to rounding: the
    reference takes the one the stream delivered; the worst offset lies
    outside the tie and is not taken."""
    from rvcbench.ref.stream import (Geometry, sola_at, sola_follow,
                                     sola_scores)

    geo = Geometry(48000, 0.25, 0.05, 2.5)
    t = np.arange(20000) / 48000
    wav = (np.sin(2 * np.pi * 200 * t) + 0.3 * np.sin(2 * np.pi * 400 * t)
           ).astype(np.float32)
    buf = wav[5000: 5000 + geo.sola_buffer_frame].copy()
    sizes = (geo.block_frame, geo.sola_buffer_frame, geo.sola_search_frame)
    _, scores = sola_scores(wav, buf, *sizes)
    best = int(np.argmax(scores))
    tied = [best + k * 240 for k in range(-2, 3)
            if 0 <= best + k * 240 < len(scores)]
    offset = tied[period % len(tied)] if period < 2 else \
        int(np.argmin(scores))
    delivered, _ = sola_at(wav, offset, buf, geo.fade_in, geo.fade_out,
                           geo.block_frame, geo.sola_buffer_frame)
    block, _, short = sola_follow(wav, buf, delivered, geo.fade_in,
                                  geo.fade_out, *sizes, 0.3)
    if period < 2:
        assert short < 1e-4 and np.abs(block - delivered).max() < 1e-5
    else:
        assert short > 1.0 and np.abs(block - delivered).max() > 0.1


def test_serve_sound_window_is_correct(serve):
    rec = _rec(serve, 4.0)
    checks = serve.check(rec)
    assert run.passed(checks), checks
    assert len(rec["tick_ms"]) * serve.n == rec["attempted"]
    assert np.isclose(rec["audio_s"], rec["attempted"] *
                      serve.geo.block_frame / serve.geo.sr)


@pytest.mark.parametrize("how", faults.FAULTS["train"])
def test_training_faults_are_not_correct(tmp_path, how):
    cell, cfg = tiny_train()
    take_out = faults.plant("train", how)
    try:
        drv = cells.driver("train").Driver(cell, cfg, 2 ** 31 + 13, "cpu",
                                           str(tmp_path))
        drv.setup()
        assert not run.passed(drv.check(drv.window(0.1, None)))
    finally:
        take_out()
