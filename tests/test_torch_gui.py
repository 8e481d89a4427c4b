"""tpu_rvc_torch's realtime app against tpu_rvc's apps/gui.py on the CPU:
`run_file` through both apps' `main` on one tiny model file and input
(the weights carried into both packages by their own loaders, both
engines deterministic), the persisted settings round trip, the device
list and the live mode without sounddevice, and the stdin control
thread.  Every test points TPU_RVC_GUI_CONFIG (and the JAX app's
CONFIG_PATH) at a temporary file, so none writes into the repository.
The fake-stream LiveLoop cases are tests/test_torch_live.py's."""

import argparse
import importlib.util
import io
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import tpu_rvc.ckpt.hubert_loader as jax_hubert_loader
import tpu_rvc.models.loader as jax_loader
from tpu_rvc.ckpt.torch_pth import save_pth

import tpu_rvc_torch.ckpt.hubert_loader as hubert_loader
from tpu_rvc_torch.apps import gui
from tpu_rvc_torch.audio.io import load_wav, save_wav
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.pipeline import rt
from tpu_rvc_torch.pipeline.live import LiveConfig

from _torch_parity import (SERVE_HUBERT, SERVE_SYNTH,
                           DeterministicJaxSynthesizer, hubert_pair,
                           reference_state, seeded, stream_voice)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-3   # of full scale: tests/test_torch_realtime.py's StreamSession
SR = 16000
BLOCKS = 8
# SERVE_SYNTH as a small model's config list
CONFIG = [129, 640, 32, 32, 64, 2, 1, 3, 0.0, "1", [3], [[1, 3, 5]],
          [10, 16], 32, [20, 32], 2, 16, 16000]
# 160 ms blocks at 16 kHz with 0.64 s of context (SERVE_GEOMETRY)
GEOMETRY = ["--samplerate", "16000", "--block-time", "0.16",
            "--crossfade-time", "0.04", "--extra-time", "0.64"]


def load_jax_gui():
    spec = importlib.util.spec_from_file_location(
        "jax_apps_gui", os.path.join(REPO, "apps", "gui.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_gui = load_jax_gui()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def config_in_tmp(tmp_path, monkeypatch):
    path = str(tmp_path / "inuse" / "gui.json")
    monkeypatch.setenv("TPU_RVC_GUI_CONFIG", path)
    monkeypatch.setattr(jax_gui, "CONFIG_PATH", str(tmp_path / "jax.json"))
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny model `.pth` in the reference layout (upsamplers at 30x the
    initialisation's scale, so SOLA's offsets do not tie), a 1.4 s voice
    at 16 kHz and the small HuBERT pair."""
    d = tmp_path_factory.mktemp("gui_app")
    net = seeded(Synthesizer, 71, **SERVE_SYNTH)
    with torch.no_grad():
        for up in net.dec.ups:
            up.weight.mul_(30.0)
    sd = reference_state(net, 72)
    save_pth({"weight": {k: w.astype(np.float16) for k, w in sd.items()},
              "config": CONFIG, "sr": "16k", "f0": 1, "version": "v2",
              "info": "tiny"}, str(d / "m.pth"))
    save_wav(str(d / "in.wav"), stream_voice(int(SR * 0.16) * BLOCKS + 500,
                                             seed=73), SR)
    hub, jax_hub_vars = hubert_pair(SERVE_HUBERT, 74)
    from tpu_rvc.models.hubert import Hubert as JaxHubert
    return dict(model=str(d / "m.pth"), wav=str(d / "in.wav"), hub=hub,
                jax_hub=(JaxHubert(**SERVE_HUBERT), jax_hub_vars))


class DeterministicRealtimeVC(rt.RealtimeVC):
    def __init__(self, **kw):
        super().__init__(noise_scale=0.0, deterministic=True, **kw)


@pytest.fixture
def small_apps(files, monkeypatch):
    """Both apps load the small HuBERT for `--hubert small`, and both
    engines are deterministic (no prior or source noise)."""
    monkeypatch.setattr(hubert_loader, "load_hubert_base",
                        lambda path, version="v2", device=None: files["hub"])
    monkeypatch.setattr(jax_hubert_loader, "load_hubert_base",
                        lambda path, version="v2": files["jax_hub"])
    monkeypatch.setattr(rt, "RealtimeVC", DeterministicRealtimeVC)
    inner = jax_loader.load_synthesizer

    def deterministic_jax_synth(path):
        synth, variables, meta = inner(path)
        fields = {f: getattr(synth, f) for f in synth.__dataclass_fields__
                  if f not in ("parent", "name")}
        return DeterministicJaxSynthesizer(**fields), variables, meta

    monkeypatch.setattr(jax_loader, "load_synthesizer",
                        deterministic_jax_synth)


def test_run_file_matches_jax(files, small_apps, tmp_path, capsys,
                              config_in_tmp):
    """`--input/--output` through both apps' main: the written files
    within 2e-3 of full scale, the same length and report line; the port
    persisted the settings the JAX app persisted."""
    argv = ["--model", files["model"], "--hubert", "small", "--input",
            files["wav"], "--f0-method", "pm", "--index-rate", "0",
            "--rms-mix-rate", "1", *GEOMETRY]
    out, jout = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    capsys.readouterr()
    gui.main(argv + ["--output", out, "--device", "cpu"])
    port_lines = capsys.readouterr().out.strip().splitlines()
    jax_gui.main(argv + ["--output", jout])
    jax_lines = capsys.readouterr().out.strip().splitlines()
    got, sr = load_wav(out)
    want, jsr = load_wav(jout)
    err = float(np.abs(got - want).max())
    print(f"run_file: {len(got)} samples, port vs JAX max {err:.2e} of "
          f"full scale; {port_lines[1]!r} | {jax_lines[1]!r}")
    assert sr == jsr == SR
    assert got.shape == want.shape == (BLOCKS * int(SR * 0.16),)
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-2
    assert err < TOL
    assert port_lines[1] == jax_lines[1].replace(jout, out)
    assert port_lines[2].startswith("block latency p50=")
    with open(config_in_tmp) as f:
        port_cfg = json.load(f)
    with open(jax_gui.CONFIG_PATH) as f:
        assert port_cfg == json.load(f)


def _namespace(files, output):
    return argparse.Namespace(
        model=files["model"], index="", hubert="small", rmvpe_root="",
        input=files["wav"], output=output, samplerate=SR, block_time=0.16,
        crossfade_time=0.04, extra_time=0.64, f0_method="pm", f0_up_key=0.0,
        formant=0.0, index_rate=0.0, rms_mix_rate=1.0, protect=0.33,
        use_pv=False, device="cpu")


def test_run_file_matches_its_own_session(files, small_apps, tmp_path):
    """run_file writes what the session it builds gives, block by block."""
    ns = _namespace(files, str(tmp_path / "o.wav"))
    lat = gui.run_file(ns)
    assert lat.shape == (BLOCKS,)
    sess = gui.build_session(ns)
    audio = load_wav(files["wav"])[0]
    bf = sess.block_frame
    direct = np.concatenate([sess.feed(audio[i * bf:(i + 1) * bf])
                             for i in range(BLOCKS)])
    got, _ = load_wav(str(tmp_path / "o.wav"))
    written = (np.clip(direct, -1.0, 1.0) * 32767.0).astype(np.int16)
    np.testing.assert_array_equal(got, written / 32768.0)


def test_settings_round_trip(files, small_apps, tmp_path, config_in_tmp):
    """The first run persists its flags; a second run without them takes
    the persisted ones as its defaults and writes the same file back."""
    gui.main(["--model", files["model"], "--hubert", "small", "--input",
              files["wav"], "--output", str(tmp_path / "a.wav"),
              "--f0-method", "pm", "--f0-up-key", "3", "--formant", "0.5",
              "--index-rate", "0.4", "--threshold", "-45", "--use-pv",
              "--device", "cpu", *GEOMETRY])
    cfg = LiveConfig.load(config_in_tmp)
    assert (cfg.pth_path, cfg.pitch, cfg.formant, cfg.index_rate,
            cfg.threhold, cfg.use_pv, cfg.samplerate, cfg.block_time) == (
        files["model"], 3.0, 0.5, 0.4, -45.0, True, SR, 0.16)
    with open(config_in_tmp) as f:
        first = json.load(f)
    gui.main(["--hubert", "small", "--input", files["wav"], "--output",
              str(tmp_path / "b.wav"), "--device", "cpu"])
    with open(config_in_tmp) as f:
        assert json.load(f) == first
    assert load_wav(str(tmp_path / "b.wav"))[0].shape == (
        BLOCKS * int(SR * 0.16),)
    gui.main(["--no-use-pv", "--list-devices"])   # lists, saves nothing
    assert LiveConfig.load(config_in_tmp).use_pv is True
    assert gui.config_path() == config_in_tmp != gui.CONFIG_PATH


def test_list_devices_without_sounddevice(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    gui.main(["--list-devices"])
    got = capsys.readouterr().out
    jax_gui.main(["--list-devices"])
    assert got == capsys.readouterr().out == "hostapis:\ninput:\noutput:\n"


def test_live_exits_1_without_sounddevice(files, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    with pytest.raises(SystemExit) as e:
        gui.main(["--model", files["model"], "--live", "--device", "cpu"])
    assert e.value.code == 1
    assert "requires the sounddevice package" in capsys.readouterr().out


def test_entry_points_need_a_card_unless_cpu(files, small_apps, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gui.main(["--model", files["model"], "--hubert", "small",
                  "--input", files["wav"], "--output",
                  str(tmp_path / "o.wav")])
    ns = _namespace(files, str(tmp_path / "o.wav"))
    del ns.device
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gui.build_session(ns)
    assert gui.build_session(ns, device="cpu").engine.device == \
        torch.device("cpu")


def test_usage_errors(capsys):
    with pytest.raises(SystemExit) as e:
        gui.main([])
    assert e.value.code == 2 and "need --model" in capsys.readouterr().err


class Target:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("set_"):
            return lambda v: self.calls.append((name, v))
        raise AttributeError(name)


@pytest.mark.parametrize("app", ["port", "jax"])
def test_control_thread_applies_commands(monkeypatch, capsys, app):
    """key/formant/index/rms reach the target, an unknown command is
    reported, quit stops the reader (nothing after it is applied)."""
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "key 3\nformant 1.5\n\nindex 0.4\nrms 0.2\nbogus 1\nquit\nkey 9\n"))
    target, stop = Target(), threading.Event()
    (gui if app == "port" else jax_gui).control_thread(target, stop)
    assert stop.is_set()
    assert target.calls == [("set_key", 3.0), ("set_formant", 1.5),
                            ("set_index_rate", 0.4),
                            ("set_rms_mix_rate", 0.2)]
    out = capsys.readouterr().out
    assert out.startswith("controls: key <n>") and \
        "unknown command bogus" in out


def test_control_thread_returns_on_a_closed_stdin(monkeypatch):
    class Closed:
        def __iter__(self):
            raise ValueError("I/O operation on closed file")

    monkeypatch.setattr(sys, "stdin", Closed())
    stop = threading.Event()
    gui.control_thread(Target(), stop)
    assert not stop.is_set()
