"""tpu_rvc_torch's ONNX and `.pt2` paths against tpu_rvc's on the CPU (the
reader, the writer and the executor op by op are in
tests/test_torch_onnx_exec.py): the synthesizer graphs each package exports
(default, reference layout, speaker mix, no f0) run by both executors and
held against both packages' `infer`/`infer_mix`, ContentVec both ways,
`OnnxRVC` on one pair of graph files, `.pt2` export and load, the
`onnx_infer` app, and `torch.export` of `infer` bit-equal to eager."""

import inspect
import re

import jax
import numpy as np
import pytest
import torch

from tpu_rvc.ckpt.jax2onnx import export_hubert_onnx as jax_export_hubert
from tpu_rvc.ckpt.jax2onnx import export_synthesizer_onnx as jax_export_synth
from tpu_rvc.models import onnx_exec as jax_exec
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.models.synthesizer import Synthesizer as JaxSynthesizer
from tpu_rvc.pipeline.onnx_infer import OnnxRVC as JaxOnnxRVC

from tpu_rvc_torch.apps import onnx_infer as onnx_infer_app
from tpu_rvc_torch.audio.io import load_wav, save_wav
from tpu_rvc_torch.ckpt import onnx_reader
from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
from tpu_rvc_torch.ckpt.export import load_exported, save_exported
from tpu_rvc_torch.ckpt.torch2onnx import (export_hubert_onnx,
                                           export_synthesizer_onnx)
from tpu_rvc_torch.models.onnx_exec import OnnxModule
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.nn import generators
from tpu_rvc_torch.pipeline.onnx_infer import OnnxRVC

from _torch_parity import (SMALL_HUBERT, SMALL_SYNTH, hubert_pair,
                           jax_synth_params, reference_state, seeded)

T = 48
NOF0 = dict(SMALL_SYNTH, use_f0=False)
VARIANTS = ("default", "reference_layout", "spk_mix", "no_f0")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_ops():
    """The op types the JAX executor names in its source."""
    src = inspect.getsource(jax_exec)
    return set(re.findall(r'"([A-Z][a-zA-Z]+)"', src)) - {"NCHW", "OIHW",
                                                          "NCH", "OIH"}


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _both(path, *args):
    """Run one file through both executors -> (port, jax) as float64.  The
    JAX executor runs as one XLA program (`jit`, the op-by-op executor
    compiled whole: one compile instead of one per op)."""
    port = OnnxModule.from_file(path, "cpu")(*args)
    jax = jax_exec.OnnxModule.from_file(path).jit()(*args)
    port = port if isinstance(port, list) else [port]
    jax = jax if isinstance(jax, (list, tuple)) else [jax]
    return ([p.double().numpy() for p in port],
            [np.asarray(j).astype(np.float64) for j in jax])


# ---------------------------------------------------------------------------
# the synthesizer graphs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synths():
    """Both packages' synthesizers, with and without f0, from one set of
    reference-layout weights each."""
    out = {}
    for key, cfg, seed in (("f0", SMALL_SYNTH, 31), ("no_f0", NOF0, 33)):
        sd = reference_state(seeded(Synthesizer, seed, **cfg), seed + 1)
        port = Synthesizer(**cfg).eval()
        port.load_state_dict(synthesizer_state_from_reference(sd))
        out[key] = (port, JaxSynthesizer(**cfg, weight_norm=True),
                    jax_synth_params(sd, cfg))
    return out


def _inputs(variant, seed=3):
    rng = np.random.default_rng(seed)
    phone = rng.standard_normal((1, T, 64)).astype(np.float32)
    pitch = rng.integers(1, 255, (1, T)).astype(np.int64)
    pitchf = rng.uniform(80, 400, (1, T)).astype(np.float32)
    rnd = rng.standard_normal((1, T, 32)).astype(np.float32)
    mix = np.zeros((1, T, 2), np.float32)
    mix[:, :T // 2, 0] = 1.0
    mix[:, T // 2:] = rng.dirichlet((1, 1), T - T // 2)
    return phone, pitch, pitchf, rnd, mix


def _graph_args(variant, phone, pitch, pitchf, rnd, mix):
    lengths = np.asarray([T], np.int64)
    if variant == "no_f0":
        return [phone, lengths, np.asarray([1], np.int64), rnd]
    if variant == "spk_mix":
        return [phone, lengths, pitch, pitchf, mix, rnd]
    return [phone, lengths, pitch, pitchf, np.asarray([1], np.int64),
            rnd.transpose(0, 2, 1) if variant == "reference_layout" else rnd]


def _references(synths, variant, phone, pitch, pitchf, rnd, mix):
    """(port, JAX) audio as (1, samples) float64 for the variant."""
    port, js, jv = synths["no_f0" if variant == "no_f0" else "f0"]
    t = torch.from_numpy
    lengths = torch.tensor([T])
    if variant == "spk_mix":
        got = port.infer_mix(t(phone), lengths, t(mix), t(pitch), t(pitchf),
                             noise=t(rnd))
        want = _jax_infer_mix(js, jv, phone, mix, (pitch, pitchf), rnd)
    else:
        f0 = () if variant == "no_f0" else (t(pitch), t(pitchf))
        got = port.infer(t(phone), lengths, torch.tensor([1]), *f0,
                         noise=t(rnd), noise_scale=1.0, deterministic=True)
        jf0 = () if variant == "no_f0" else (pitch, pitchf)
        want = _jitted(js, "infer", lambda v, ph, f0, r: js.apply(
            v, ph, np.asarray([T]), np.asarray([1]), *f0, noise=r,
            noise_scale=1.0, deterministic=True, method=js.infer))(
            jv, phone, jf0, rnd)
    return (got.double().numpy().reshape(1, -1),
            np.asarray(want, np.float64).reshape(1, -1))


_JITTED = {}


def _jitted(js, method, fn):
    """One compiled JAX function per synthesizer and method, shared by the
    tests that call it at the same shapes."""
    key = (id(js), method)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(fn)
    return _JITTED[key]


def _jax_infer_mix(js, jv, phone, mix, f0, rnd):
    return _jitted(js, "infer_mix", lambda v, ph, m, f0, r: js.apply(
        v, ph, np.asarray([T]), m, *f0, noise=r, method=js.infer_mix))(
        jv, phone, mix, f0, rnd)


def _variant_kw(variant):
    return dict(spk_mix=variant == "spk_mix",
                reference_layout=variant == "reference_layout")


@pytest.mark.parametrize("variant", VARIANTS)
def test_jax_exported_synthesizer_runs_on_port_executor(synths, tmp_path,
                                                        variant):
    _, js, jv = synths["no_f0" if variant == "no_f0" else "f0"]
    path = str(tmp_path / "j.onnx")
    jax_export_synth(js, jv, T=T, path=path, **_variant_kw(variant))
    args = _graph_args(variant, *_inputs(variant))
    (port,), (jax,) = _both(path, *args)
    assert port.shape == jax.shape
    np.testing.assert_allclose(port, jax, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def port_graphs(synths, tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    paths = {}
    for variant in VARIANTS:
        port = synths["no_f0" if variant == "no_f0" else "f0"][0]
        paths[variant] = str(d / f"{variant}.onnx")
        export_synthesizer_onnx(port, T=T, path=paths[variant],
                                **_variant_kw(variant))
    return paths


@pytest.mark.parametrize("variant", VARIANTS)
def test_port_exported_synthesizer(synths, port_graphs, variant):
    """The port's file: the reference I/O contract, only ops of the JAX
    executor's set, both executors within 1e-5 of the port's own
    infer/infer_mix, and within 1e-4 of the JAX package's."""
    path = port_graphs[variant]
    g = onnx_reader.load_onnx(path)
    want_in = (["phone", "phone_lengths", "ds", "rnd"] if variant == "no_f0"
               else ["phone", "phone_lengths", "pitch", "pitchf", "ds",
                     "rnd"])
    assert g.inputs == want_in and g.outputs == ["audio"]
    for n in ("phone_lengths", "pitch"):
        if n in g.input_info:
            assert g.input_info[n][0] == 7, n   # int64
    info = g.input_info
    if variant == "reference_layout":
        assert info["rnd"][1][:2] == (1, 32)
        assert isinstance(info["rnd"][1][2], str)
        assert isinstance(info["phone"][1][1], str)
    else:
        assert info["rnd"][1] == (1, T, 32)
    if variant == "spk_mix":
        assert info["ds"] == (1, (1, T, 2))
    ops = {n.op_type for n in g.nodes}
    assert ops <= _jax_ops(), ops - _jax_ops()
    inputs = _inputs(variant)
    (port,), (jax,) = _both(path, *_graph_args(variant, *inputs))
    if variant == "reference_layout":
        assert port.shape == (1, 1, T * 160)
    port, jax = port.reshape(1, -1), jax.reshape(1, -1)
    ref_port, ref_jax = _references(synths, variant, *inputs)
    np.testing.assert_allclose(port, ref_port, rtol=0, atol=1e-5)
    np.testing.assert_allclose(jax, ref_port, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port, ref_jax, rtol=0, atol=1e-4)
    assert np.abs(ref_port).max() > 1e-3


@pytest.mark.parametrize("key", ["f0", "no_f0"])
def test_infer_mix_matches_jax(synths, key):
    """Per-frame speaker weights against the JAX infer_mix; a one-hot mix
    is `infer` with that speaker."""
    port, js, jv = synths[key]
    phone, pitch, pitchf, rnd, mix = _inputs("spk_mix", seed=8)
    t = torch.from_numpy
    f0 = (t(pitch), t(pitchf)) if key == "f0" else ()
    jf0 = (pitch, pitchf) if key == "f0" else ()
    got = port.infer_mix(t(phone), torch.tensor([T]), t(mix), *f0,
                         noise=t(rnd)).numpy()
    want = np.asarray(_jax_infer_mix(js, jv, phone, mix, jf0, rnd))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    onehot = np.zeros_like(mix)
    onehot[..., 1] = 1.0
    one = port.infer_mix(t(phone), torch.tensor([T]), t(onehot), *f0,
                         noise=t(rnd))
    ref = port.infer(t(phone), torch.tensor([T]), torch.tensor([1]), *f0,
                     noise=t(rnd), noise_scale=1.0, deterministic=True)
    np.testing.assert_allclose(one.numpy(), ref.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# ContentVec and OnnxRVC
# ---------------------------------------------------------------------------

N_WAV = 6400   # 0.4 s at 16 kHz: 19 frames, 38 after the 2x repeat


@pytest.fixture(scope="module")
def hubert_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("vec")
    port, jv = hubert_pair(SMALL_HUBERT, 41)
    paths = {"port": str(d / "port.onnx"), "jax": str(d / "jax.onnx")}
    export_hubert_onnx(port, N_WAV, path=paths["port"])
    jax_export_hubert(JaxHubert(**SMALL_HUBERT), jv, n_samples=N_WAV,
                      path=paths["jax"])
    return port, JaxHubert(**SMALL_HUBERT), jv, paths


def test_hubert_onnx_both_ways(hubert_files):
    port, jh, jv, paths = hubert_files
    wav = (np.random.default_rng(9).standard_normal((1, N_WAV)) * 0.1
           ).astype(np.float32)
    want_port = port(torch.from_numpy(wav)).double().numpy()
    want_jax = np.asarray(jh.apply(jv, wav), np.float64)
    (p,), (j,) = _both(paths["port"], wav)
    np.testing.assert_allclose(p, want_port, rtol=0, atol=1e-5)
    np.testing.assert_allclose(j, want_port, rtol=0, atol=1e-5)
    assert {n.op_type for n in onnx_reader.load_onnx(paths["port"]).nodes
            } <= _jax_ops()
    (p,), (j,) = _both(paths["jax"], wav)
    np.testing.assert_allclose(p, want_jax, rtol=0, atol=1e-5)
    np.testing.assert_allclose(j, want_jax, rtol=0, atol=1e-5)


def _voice(n, seed=0):
    t = np.arange(n) / 16000
    x = 0.4 * np.sin(2 * np.pi * 180 * t) + 0.1 * np.sin(2 * np.pi * 360 * t)
    return (x + 0.01 * np.random.default_rng(seed).standard_normal(n)
            ).astype(np.float32)


def test_onnx_rvc_matches_jax(port_graphs, hubert_files):
    """Both packages' OnnxRVC on the same synthesizer and ContentVec files,
    f0 by dio, rnd from seed 5: within 1 LSB of int16."""
    _, _, _, vec = hubert_files
    wav = _voice(N_WAV)
    port = OnnxRVC(port_graphs["default"], hop_len=160, model_sr=16000,
                   vec_path=vec["port"], device="cpu")
    jax = JaxOnnxRVC(port_graphs["default"], hop_len=160, model_sr=16000,
                     vec_path=vec["port"])
    assert port.t_model == jax.t_model == T
    got = port.infer(wav, 16000, sid=1, f0_method="dio", seed=5)
    want = jax.infer(wav, 16000, sid=1, f0_method="dio", seed=5)
    assert got.dtype == want.dtype == np.int16
    # the reference's trim: 38 true frames times (graph samples + 2 hops)
    # over T frames
    assert got.shape == want.shape == (38 * ((T * 160 + 320) // T),)
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    assert np.abs(got).max() > 100


def test_onnx_infer_app(port_graphs, hubert_files, tmp_path):
    _, _, _, vec = hubert_files
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    save_wav(src, _voice(N_WAV, 1), 16000)
    onnx_infer_app.main(["--model", port_graphs["default"], "--vec",
                         vec["port"], "--input", src, "--output", dst,
                         "--sr", "16000", "--hop", "160", "--sid", "1",
                         "--device", "cpu"])
    out, sr = load_wav(dst)
    assert sr == 16000 and out.shape == (38 * ((T * 160 + 320) // T),)
    assert np.isfinite(out).all() and np.abs(out).max() > 0


# ---------------------------------------------------------------------------
# torch.export and .pt2
# ---------------------------------------------------------------------------

def _infer_args(seed=4):
    phone, pitch, pitchf, rnd, _ = _inputs("default", seed)
    t = torch.from_numpy
    return (t(phone), torch.tensor([T]), torch.tensor([1]), t(pitch),
            t(pitchf), t(rnd))


def test_torch_export_of_infer_is_bit_equal(monkeypatch):
    """torch.export traces the modules' plain path: no stage cache, no
    stage key, and the program gives eager `infer`'s bits."""
    net = seeded(Synthesizer, 51, **SMALL_SYNTH)

    def refuse(blocks):
        raise AssertionError("stage_key called while tracing")

    monkeypatch.setattr(generators, "stage_key", refuse)

    class Infer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, phone, lengths, sid, pitch, pitchf, rnd):
            return self.net.infer(phone, lengths, sid, pitch, pitchf,
                                  noise=rnd, deterministic=True)

    program = torch.export.export(Infer(), _infer_args())
    assert net.dec._stage_cache == {}
    monkeypatch.undo()
    args = _infer_args(seed=6)
    got = program.module()(*args)
    want = net.infer(*args[:5], noise=args[5], deterministic=True)
    assert torch.equal(got, want)


def test_pt2_round_trip(tmp_path):
    net = seeded(Synthesizer, 52, **SMALL_SYNTH)
    path = save_exported(net, str(tmp_path / "m.pt2"), T=T,
                         deterministic=True)
    fn = load_exported(path, "cpu")
    assert fn.meta == {"format": "tpu_rvc_torch.pt2.v1", "device": "cpu",
                       "T": T, "use_f0": True, "noise_scale": 0.66666,
                       "deterministic": True}
    args = _infer_args(seed=7)
    got = fn(*args)
    want = net.infer(*args[:5], noise=args[5], deterministic=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    noisy = load_exported(save_exported(net, str(tmp_path / "n.pt2"), T=T),
                          "cpu")(*args)
    assert noisy.shape == want.shape and torch.isfinite(noisy).all()

    junk = tmp_path / "junk.pt2"
    junk.write_bytes(b"not an export")
    foreign = str(tmp_path / "foreign.pt2")
    torch.export.save(torch.export.export(torch.nn.ReLU(),
                                          (torch.zeros(2),)), foreign)
    for bad in (str(junk), foreign):
        with pytest.raises(ValueError, match="not a tpu_rvc_torch export"):
            load_exported(bad, "cpu")
