"""tpu_rvc_torch's web app against tpu_rvc's on the CPU.

The layout: both packages' `build_app` and `build_infer_only_app` are
built with a recording gradio stub (gradio is not installed; the stub is
a copy of tests/test_webui.py's), and their tabs, ordered controls,
bindings and api_names are compared.  The behaviour tests of
tests/test_webui.py run again on the port's `Api` and layout.  The
endpoints: the port's `Api(device="cpu")` and tpu_rvc's `Api` on the same
files -- `infer_convert` within 1 LSB, equal dicts from the model,
index and separator lookups, the same index rows and the same hash
similarity -- and the port's JSON-over-HTTP server on 127.0.0.1.

Both packages load one small model `.pth` and one small HuBERT pair
(tests/_torch_parity.py), their pipelines made deterministic, as
tests/test_torch_apps_convert.py does."""

import functools
import importlib.util
import json
import os
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import tpu_rvc.ckpt.hubert_loader as jax_hubert_loader
from tpu_rvc.ckpt.torch_pth import save_pth
from tpu_rvc.pipeline.vc import VC as JaxVC

import tpu_rvc_torch.ckpt.hubert_loader as hubert_loader
from tpu_rvc_torch.apps import web, webui
from tpu_rvc_torch.audio.io import load_wav, save_wav
from tpu_rvc_torch.ckpt.hash import wave_hash
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.pipeline.vc import VC
from tpu_rvc_torch.retrieval.index import FeatureIndex

from _torch_parity import (SMALL_HUBERT, SMALL_SYNTH, hubert_pair,
                           reference_state, seeded)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
SMALL_CONFIG = [129, 32, 32, 32, 64, 2, 1, 3, 0.0, "1", [3], [[1, 3, 5]],
                [10, 16], 64, [20, 32], 2, 16, 16000]
LSB = 1   # port against tpu_rvc, int16 samples


def load_jax_app(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_apps_{name}", os.path.join(REPO, "apps", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_web = load_jax_app("web")
jax_webui = load_jax_app("webui")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# recording gradio stub (tests/test_webui.py:21-74)
# ---------------------------------------------------------------------------

class _Binding:
    def __init__(self, event, fn, inputs, outputs, api_name):
        self.event = event
        self.fn = fn
        self.inputs = inputs or []
        self.outputs = outputs or []
        self.api_name = api_name


class _Component:
    def __init__(self, gr, comp_type, *args, **kwargs):
        self._gr = gr
        self.comp_type = comp_type
        self.label = kwargs.get("label") or (args[0] if args else None)
        self.kwargs = kwargs
        gr.components.append(self)

    def _bind(self, event, fn=None, inputs=None, outputs=None, api_name=None,
              **kw):
        b = _Binding(event, fn, inputs, outputs, api_name)
        self._gr.bindings.append(b)
        return b

    def click(self, fn=None, inputs=None, outputs=None, api_name=None, **kw):
        return self._bind("click", fn, inputs, outputs, api_name)

    def change(self, fn=None, inputs=None, outputs=None, api_name=None, **kw):
        return self._bind("change", fn, inputs, outputs, api_name)

    def __enter__(self):
        if self.comp_type == "TabItem":
            self._gr.tabs.append(self.label)
        return self

    def __exit__(self, *a):
        return False


def make_stub_gr():
    gr = types.SimpleNamespace()
    gr.components = []
    gr.bindings = []
    gr.tabs = []
    for name in ("Blocks", "Tabs", "TabItem", "Row", "Column", "Markdown",
                 "Dropdown", "Button", "Slider", "Textbox", "Number",
                 "Audio", "File", "Radio", "Checkbox", "JSON", "Label"):
        setattr(gr, name,
                (lambda n: lambda *a, **k: _Component(gr, n, *a, **k))(name))
    return gr


# the reference's api_names (web.py:720-1536) that the layout must expose
REFERENCE_API_NAMES = {
    "infer_clean", "infer_refresh", "infer_convert", "infer_refresh_batch",
    "infer_convert_batch", "infer_change_voice", "uvr_convert",
    "train_preprocess", "train_extract_f0_feature", "train_start",
    "train_index", "train_start_all", "ckpt_merge", "ckpt_modify",
    "ckpt_show", "ckpt_extract", "export_onnx",
}


def roots(tmp_path):
    return dict(weight_root=str(tmp_path / "weights"),
                index_root=str(tmp_path / "logs"),
                uvr5_root=str(tmp_path / "uvr5"))


@pytest.fixture()
def built(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)   # the layout's handlers write into opt/
    api = web.Api(**roots(tmp_path), device="cpu")
    gr = make_stub_gr()
    app = webui.build_app(gr, api)
    return gr, api, app


def inventory(gr):
    """The controls in build order, each (type, label, other kwargs); the
    Blocks and the heading Markdown name their package and are compared
    by type only."""
    out = []
    for c in gr.components:
        if c.comp_type == "Blocks" or (c.comp_type == "Markdown" and
                                       str(c.label).startswith("## ")):
            out.append((c.comp_type,))
        else:
            out.append((c.comp_type, c.label, repr(sorted(
                (k, v) for k, v in c.kwargs.items() if k != "label"))))
    return out


def wiring(gr):
    """Each binding as (event, api_name, input and output positions)."""
    pos = {id(c): i for i, c in enumerate(gr.components)}
    return [(b.event, b.api_name, [pos[id(c)] for c in b.inputs],
             [pos[id(c)] for c in b.outputs]) for b in gr.bindings]


@pytest.mark.parametrize("builder", ["build_app", "build_infer_only_app"])
def test_layout_matches_jax(tmp_path, builder):
    os.makedirs(tmp_path / "weights")
    (tmp_path / "weights" / "voice.pth").write_bytes(b"x")
    os.makedirs(tmp_path / "logs" / "e")
    (tmp_path / "logs" / "e" / "added_e.tpuidx.npz").write_bytes(b"x")
    os.makedirs(tmp_path / "uvr5")
    (tmp_path / "uvr5" / "HP5.pth").write_bytes(b"x")
    got, want = make_stub_gr(), make_stub_gr()
    getattr(webui, builder)(got, web.Api(**roots(tmp_path), device="cpu"))
    getattr(jax_webui, builder)(want, jax_web.Api(**roots(tmp_path)))
    print(f"{builder}: {len(got.components)} controls, "
          f"{len(got.bindings)} bindings, tabs {got.tabs}")
    assert got.tabs == want.tabs
    assert inventory(got) == inventory(want)
    assert wiring(got) == wiring(want)
    names = {b.api_name for b in got.bindings if b.api_name}
    assert names == {b.api_name for b in want.bindings if b.api_name}
    if builder == "build_app":
        assert REFERENCE_API_NAMES <= names
        assert "FAQ (Frequently Asked Questions)" in got.tabs
    else:
        assert names == {"infer_convert"} and not got.tabs


# ---------------------------------------------------------------------------
# tests/test_webui.py's behaviour tests on the port
# ---------------------------------------------------------------------------

def test_layout_is_endpoint_complete(built):
    gr, _, _ = built
    for b in gr.bindings:
        assert callable(b.fn), b.api_name
        for c in list(b.inputs) + list(b.outputs):
            assert isinstance(c, _Component), (b.api_name, c)


def fake_infer_convert(calls):
    def fn(sid, path, key, method, file_index, index_rate, filter_radius,
           resample_sr, rms_mix_rate, protect, model_name="", output_path="",
           f0_file=None, **kw):
        calls.update(locals())
        return {"info": "ok", "sr": 48000, "output": output_path}
    return fn


def test_infer_convert_binding_maps_args(built, monkeypatch):
    gr, api, _ = built
    calls = {}
    monkeypatch.setattr(api, "infer_convert", fake_infer_convert(calls))
    b = next(x for x in gr.bindings if x.api_name == "infer_convert")
    info, audio = b.fn(3, "in.wav", 12, None, "rmvpe", "", "my.idx", 0.75,
                       3, 0, 0.25, 0.33, "model.pth")
    assert info == "ok" and audio
    assert calls["sid"] == 3 and calls["path"] == "in.wav"
    assert calls["key"] == 12 and calls["method"] == "rmvpe"
    assert calls["file_index"] == "my.idx" and calls["index_rate"] == 0.75
    assert calls["model_name"] == "model.pth"


def test_infer_convert_binding_unwraps_file_objects(built, monkeypatch):
    """gr.File values arrive as tempfile wrappers with a .name under
    gradio 3.x: the index and f0-curve pickers are unwrapped before they
    reach the Api."""
    gr, api, _ = built
    calls = {}
    monkeypatch.setattr(api, "infer_convert", fake_infer_convert(calls))

    class File:
        def __init__(self, name):
            self.name = name

    b = next(x for x in gr.bindings if x.api_name == "infer_convert")
    b.fn(0, "in.wav", 0, File("/tmp/curve.csv"), "rmvpe",
         File("/tmp/my.idx"), "", 0.75, 3, 0, 0.25, 0.33, "model.pth")
    assert calls["file_index"] == "/tmp/my.idx"
    assert calls["f0_file"] == "/tmp/curve.csv"
    calls.clear()

    def fake_batch(sid, src, out, file_index="", **kw):
        calls["file_index"] = file_index
        return {"report": ["ok"]}

    monkeypatch.setattr(api, "infer_convert_batch", fake_batch)
    bb = next(x for x in gr.bindings if x.api_name == "infer_convert_batch")
    bb.fn(0, "/nonexistent_dir", "opt", None, 0, "rmvpe",
          File("/tmp/b.idx"), "", 1.0, 3, 0, 1.0, 0.33, "wav", "m.pth")
    assert calls["file_index"] == "/tmp/b.idx"


def test_ckpt_extract_binding_forwards_author(built, monkeypatch):
    gr, api, _ = built
    calls = {}

    def fake_extract(path, name, sr, if_f0, info, version, author=""):
        calls.update(locals())
        return {"output": "saved"}

    monkeypatch.setattr(api, "ckpt_extract", fake_extract)
    b = next(x for x in gr.bindings if x.api_name == "ckpt_extract")
    assert b.fn("G_1.pth", "small", "someone", "48k", "1", "info",
                "v2") == "saved"
    assert calls["author"] == "someone"


def test_api_ckpt_extract_saves_author(monkeypatch):
    import tpu_rvc_torch.ckpt.small_model as sm
    captured = {}

    def fake_extract_small_model(path, name, sr, if_f0, info, version, hp,
                                 out_path=None, author=""):
        captured["author"] = author
        captured["hp"] = hp
        return "out.pth"

    monkeypatch.setattr(sm, "extract_small_model", fake_extract_small_model)
    out = web.Api(device="cpu").ckpt_extract("G_1.pth", "n", "48k", 1, "i",
                                             "v2", author="author-x")
    assert out == {"output": "out.pth"} and captured["author"] == "author-x"
    assert captured["hp"].data.sampling_rate == 48000


def test_api_infer_convert_parses_f0_file(built, tmp_path, monkeypatch):
    gr, api, _ = built
    seen = {}

    class FakeVC:
        def vc_single(self, sid, path, key, method, index, index_rate,
                      filter_radius, resample_sr, rms_mix_rate, protect,
                      f0_file=None, chunk_parallel=False, **kw):
            seen["f0_file"] = f0_file
            return "ok", (16000, np.zeros(16, np.int16))

    monkeypatch.setattr(api, "_get_vc", lambda name: (FakeVC(), {}))
    curve = tmp_path / "curve.csv"
    curve.write_text("0.0,220.0\n1.0,230.5\n")
    r = api.infer_convert(0, "in.wav", f0_file=str(curve),
                          output_path=str(tmp_path / "o.wav"))
    assert r["info"] == "ok"
    assert seen["f0_file"] == [[0.0, 220.0], [1.0, 230.5]]


def test_stream_endpoint_rejects_unknown_names(built):
    _, api, _ = built
    with pytest.raises(ValueError, match="unknown endpoint"):
        list(api.stream_endpoint("no_such_endpoint"))
    with pytest.raises(ValueError, match="unknown endpoint"):
        list(jax_web.Api().stream_endpoint("no_such_endpoint"))


def test_refresh_and_clean_bindings(built):
    gr, api, _ = built
    os.makedirs(api.weight_root, exist_ok=True)
    with open(os.path.join(api.weight_root, "aaa.pth"), "wb") as f:
        f.write(b"x")
    b = next(x for x in gr.bindings if x.api_name == "infer_refresh")
    names_upd, _ = b.fn()
    assert "aaa.pth" in names_upd["choices"]
    assert names_upd["__type__"] == "update"
    c = next(x for x in gr.bindings if x.api_name == "infer_clean")
    assert c.fn()["__type__"] == "update"
    assert api._vc is None


def test_train_stream_binding_yields_logs(built, monkeypatch):
    gr, api, _ = built

    def fake_train_start(log_fn=None, **kwargs):
        log_fn("epoch 1 done")
        log_fn("epoch 2 done")
        return {"status": "done", "metrics": {"loss": 1.0}}

    monkeypatch.setattr(api, "train_start", fake_train_start)
    b = next(x for x in gr.bindings if x.api_name == "train_start")
    chunks = list(b.fn("exp", "48k", "Yes", 0, 5, 20, 4, "No", "", "",
                       "mesh", "No", "No", "v2", "author"))
    assert chunks, "no streamed output"
    assert "epoch 2 done" in chunks[-1] and "done" in chunks[-1]


def test_stream_endpoint_surfaces_errors(built, monkeypatch):
    _, api, _ = built

    def boom(**kwargs):
        raise RuntimeError("exploded")

    monkeypatch.setattr(api, "train_index", boom)
    out = list(api.stream_endpoint("train_index", exp_dir="x"))
    assert "exploded" in out[-1] and "Traceback" in out[-1]


def test_ckpt_extract_prefill_binding(built, monkeypatch):
    gr, api, _ = built
    monkeypatch.setattr(api, "ckpt_show",
                        lambda p: {"sr": "32k", "f0": 0, "version": "v1"})
    b = next(x for x in gr.bindings
             if x.event == "change" and x.api_name is None
             and len(x.inputs) == 1 and len(x.outputs) == 3)
    assert b.fn("G_5.pth") == ("32k", "0", "v1")


def test_endpoints_match_jax():
    assert web.ENDPOINTS == jax_web.ENDPOINTS and len(web.ENDPOINTS) == 20


def test_uvr_convert_caches_separators(built, tmp_path, monkeypatch):
    """uvr_convert keeps a separator across requests, one per (model,
    agg), at most 4, least recently used out first; on the CPU it is the
    host separator (the card's would be a DeviceSeparator)."""
    _, api, _ = built
    loads = []

    class FakeSep:
        def separate(self, path):
            x = np.zeros((4410, 2), np.float32)
            return x, x, 44100

    def fake_load(model_path, agg=10, device=None, **kw):
        loads.append((model_path, agg, device))
        return FakeSep()

    monkeypatch.setattr("tpu_rvc_torch.pipeline.uvr5.load_separator",
                        fake_load)
    wav = str(tmp_path / "in.wav")
    save_wav(wav, np.zeros(4410, np.float32), 44100)
    kw = dict(ins_root=str(tmp_path / "ins"), vocal_root=str(tmp_path / "voc"))
    for _ in range(2):
        out = api.uvr_convert("HP5.pth", wav, agg=10, **kw)
        assert os.path.exists(out["vocal"]) and os.path.exists(
            out["instrument"])
    assert loads == [("HP5.pth", 10, torch.device("cpu"))]
    assert isinstance(api._uvr[("HP5.pth", 10)], FakeSep)
    for agg in (7, 8, 9, 11):
        api.uvr_convert("HP5.pth", wav, agg=agg, **kw)
    assert len(loads) == 5 and len(api._uvr) == 4
    assert ("HP5.pth", 10) not in api._uvr        # the oldest went first
    api.uvr_convert("HP5.pth", wav, agg=7, **kw)
    assert len(loads) == 5


def test_uvr_convert_mdx_branch(built, tmp_path, monkeypatch):
    """A separator with `_path_audio_` (MDX-Net) writes its own stems."""
    _, api, _ = built
    seen = []

    class FakeMdx:
        def _path_audio_(self, path, vocal_root, ins_root):
            seen.append((path, vocal_root, ins_root))

    monkeypatch.setattr("tpu_rvc_torch.pipeline.uvr5.load_separator",
                        lambda *a, **k: FakeMdx())
    out = api.uvr_convert("onnx_dereverb_By_FoxJoy", "in.wav", "i", "v")
    assert out == {"instrument": "i", "vocal": "v"}
    assert seen == [("in.wav", "v", "i")]


def test_api_needs_a_card_unless_cpu():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        web.Api()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        web.main(["--http-only"])
    assert web.Api(device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# endpoint results against tpu_rvc's Api on the same files
# ---------------------------------------------------------------------------

def voice(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    ph = 2 * np.pi * np.cumsum(180 + 40 * np.sin(2 * np.pi * 0.5 * t)) / SR
    x = (0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)) * (
        0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
    return (x + 0.005 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two small models `.pth` (tpu_rvc's writer, fp16), an index, a 2 s
    voice, a feature dir, a UVR5 root, and the small HuBERT pair."""
    d = tmp_path_factory.mktemp("web_apps")
    os.makedirs(d / "weights")
    for name, seed in (("a.pth", 91), ("b.pth", 92)):
        sd = reference_state(seeded(Synthesizer, seed, **SMALL_SYNTH),
                             seed + 10)
        save_pth({"weight": {k: w.astype(np.float16) for k, w in sd.items()},
                  "config": SMALL_CONFIG, "sr": "40k", "f0": 1,
                  "version": "v2", "info": f"model {name}"},
                 str(d / "weights" / name))
    exp = d / "logs" / "exp"
    os.makedirs(exp / "3_feature768")
    rng = np.random.default_rng(93)
    for i in range(3):
        np.save(str(exp / "3_feature768" / f"{i}.npy"),
                rng.standard_normal((40 + 7 * i, 768)).astype(np.float32))
    vecs = rng.standard_normal((200, 64)).astype(np.float32)
    FeatureIndex(vecs, (vecs * vecs).sum(1)).save(
        str(exp / "added_m.tpuidx.npz"))
    (exp / "trained_m.index").write_bytes(b"x")
    os.makedirs(d / "uvr5" / "onnx_dereverb_By_FoxJoy")
    for name in ("HP5_only_main_vocal.pth", "VR-DeEchoNormal.pth", "x.txt"):
        (d / "uvr5" / name).write_bytes(b"x")
    save_wav(str(d / "voice.wav"), voice(2.0, 1), SR)
    hub, jax_hub_vars = hubert_pair(SMALL_HUBERT, 94)
    from tpu_rvc.models.hubert import Hubert as JaxHubert
    return dict(dir=d, index=str(exp / "added_m.tpuidx.npz"), exp=str(exp),
                wav=str(d / "voice.wav"), hub=hub,
                jax_hub=(JaxHubert(**SMALL_HUBERT), jax_hub_vars),
                roots=dict(weight_root=str(d / "weights"),
                           index_root=str(d / "logs"),
                           uvr5_root=str(d / "uvr5")))


def deterministic(monkeypatch, cls):
    inner = cls.get_vc

    @functools.wraps(inner)
    def get_vc(self, *a, **kw):
        meta = inner(self, *a, **kw)
        self.pipeline.noise_scale, self.pipeline.deterministic = 0.0, True
        return meta
    monkeypatch.setattr(cls, "get_vc", get_vc)


@pytest.fixture(scope="module")
def apis(files):
    """(port Api on the CPU, tpu_rvc Api), both on the small HuBERT and
    deterministic pipelines; kept for the module (the JAX graphs compile
    once)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hubert_loader, "load_hubert_base",
                   lambda path, version="v2", device=None: files["hub"])
        mp.setattr(jax_hubert_loader, "load_hubert_base",
                   lambda path, version="v2": files["jax_hub"])
        deterministic(mp, VC)
        deterministic(mp, JaxVC)
        yield (web.Api(**files["roots"], device="cpu"),
               jax_web.Api(**files["roots"]))


def read_int16(path):
    x, sr = load_wav(path)
    return np.round(x * 32768.0).astype(np.int16), sr


@pytest.mark.parametrize("with_index", [False, True])
def test_infer_convert_matches_jax(files, apis, tmp_path, with_index):
    """The same file through both Apis: the written WAVs within 1 LSB,
    the same rate and the same `info` shape; the port's file is its
    `VC.vc_single`'s output, and `stream_endpoint` (a worker thread) gives
    the same file."""
    api, japi = apis
    kw = dict(f0_method="pm", file_index=files["index"] if with_index
              else "", index_rate=0.75, rms_mix_rate=0.25,
              model_name="a.pth")
    got = api.infer_convert(0, files["wav"], output_path=str(
        tmp_path / "port.wav"), **kw)
    want = japi.infer_convert(0, files["wav"], output_path=str(
        tmp_path / "jax.wav"), **kw)
    a, sr = read_int16(got["output"])
    b, jsr = read_int16(want["output"])
    lsb = int(np.abs(a.astype(int) - b).max())
    print(f"index {with_index}: {a.shape[0]} samples, port vs JAX max "
          f"{lsb} LSB, {(a != b).mean():.2e} of the samples differ")
    assert sr == jsr == got["sr"] == want["sr"] == SR
    assert a.shape == b.shape and np.abs(a).max() > 1000
    assert lsb <= LSB
    assert got["info"].startswith("npy: ") and want["info"].startswith(
        "npy: ")
    index = FeatureIndex.load(files["index"]) if with_index else None
    _, (_, direct) = api._vc.vc_single(0, files["wav"], 0, "pm", index, 0.75,
                                       3, 0, 0.25, 0.33)
    assert np.array_equal(a, direct)
    streamed = list(api.stream_endpoint(
        "infer_convert", poll=0.05, sid=0, input_audio_path=files["wav"],
        output_path=str(tmp_path / "streamed.wav"), **kw))
    assert json.loads(streamed[-1])["output"] == str(tmp_path /
                                                     "streamed.wav")
    assert np.array_equal(read_int16(str(tmp_path / "streamed.wav"))[0], a)


def test_lookups_and_voice_match_jax(files, apis):
    api, japi = apis
    for name in ("lookup_names", "lookup_indices", "lookup_uvr5_names",
                 "change_choices"):
        assert getattr(api, name)() == getattr(japi, name)(), name
    assert api.lookup_names() == ["a.pth", "b.pth"]
    assert api.lookup_indices() == [files["index"]]
    assert api.lookup_uvr5_names() == ["HP5_only_main_vocal",
                                       "VR-DeEchoNormal",
                                       "onnx_dereverb_By_FoxJoy"]
    for model in ("b.pth", "a.pth", ""):
        got, want = api.change_voice(model), japi.change_voice(model)
        assert got == want, model
    assert api.change_voice("b.pth")["info"] == "model b.pth"


def test_ckpt_show_matches_jax(files, apis):
    api, japi = apis
    path = os.path.join(files["roots"]["weight_root"], "a.pth")
    got, want = api.ckpt_show(path), japi.ckpt_show(path)
    assert got == want
    assert set(got) == {"config", "sr", "f0", "version", "info"}


def test_train_index_matches_jax(files, apis, tmp_path):
    api, japi = apis
    got = api.train_index(files["exp"], "v2", "port")
    want = japi.train_index(files["exp"], "v2", "jax")
    assert got["rows"] == want["rows"] == 40 + 47 + 54
    a, b = FeatureIndex.load(got["index"]), FeatureIndex.load(want["index"])
    np.testing.assert_array_equal(a.vectors, b.vectors)
    np.testing.assert_array_equal(a.norms_sq, b.norms_sq)


def test_hash_similarity_matches_jax(apis):
    api, japi = apis
    rng = np.random.default_rng(95)
    base = rng.standard_normal(48000)
    h1 = wave_hash(base.copy())
    h2 = wave_hash(base + 0.3 * rng.standard_normal(48000))
    for a, b in ((h1, h2), (h1, h1)):
        got, want = api.hash_similarity(a, b), japi.hash_similarity(a, b)
        assert got == want and 0.0 < got["similarity"] <= 1.0
    bad = api.hash_similarity(h1, "x")
    assert bad["similarity"] is None and "error" in bad
    assert japi.hash_similarity(h1, "x")["similarity"] is None


# ---------------------------------------------------------------------------
# the JSON-over-HTTP front end on 127.0.0.1
# ---------------------------------------------------------------------------

def call(base, name, payload=None):
    """POST /api/<name> -> (status, decoded body or None)."""
    req = urllib.request.Request(
        f"{base}/api/{name}", data=json.dumps(payload or {}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, (json.loads(body) if body else None)


def test_serve_http_on_loopback(files, monkeypatch):
    """`serve_http` in a thread on an ephemeral port: GET lists ENDPOINTS,
    a good POST is a 200 with its result, a failing call a 500 with the
    traceback, an unknown endpoint a 404."""
    api = web.Api(**files["roots"], device="cpu")
    servers = []
    inner = web.http_server

    def record(*a, **kw):
        servers.append(inner(*a, **kw))
        return servers[-1]

    monkeypatch.setattr(web, "http_server", record)
    thread = threading.Thread(target=web.serve_http,
                              args=(api, "127.0.0.1", 0), daemon=True)
    thread.start()
    try:
        for _ in range(500):
            if servers:
                break
            threading.Event().wait(0.01)
        base = f"http://127.0.0.1:{servers[0].server_address[1]}"
        with urllib.request.urlopen(base + "/", timeout=30) as r:
            assert json.loads(r.read()) == {"endpoints": list(web.ENDPOINTS)}
        code, body = call(base, "lookup_names")
        assert code == 200 and body == {"ok": True,
                                        "result": ["a.pth", "b.pth"]}
        code, body = call(base, "ckpt_show", {
            "path": os.path.join(files["roots"]["weight_root"], "a.pth")})
        assert code == 200 and body["result"]["info"] == "model a.pth"
        code, body = call(base, "ckpt_show", {"path": "/no/such/file.pth"})
        assert code == 500 and body["ok"] is False
        assert "Traceback" in body["error"] and "FileNotFoundError" in \
            body["error"]
        code, body = call(base, "lookup_names", {"unexpected": 1})
        assert code == 500 and "TypeError" in body["error"]
        code, body = call(base, "no_such_endpoint")
        assert code == 404 and body is None
    finally:
        if servers:
            servers[0].shutdown()
            servers[0].server_close()
        thread.join(10)
    assert not thread.is_alive()


# the SMALL_SYNTH model at v2/40k's decoder geometry (its `.pth` config)
SMALL_40K = dict(SMALL_SYNTH, upsample_rates=(10, 10, 2, 2),
                 upsample_kernel_sizes=(16, 16, 4, 4), sr=40000)
SMALL_40K_CONFIG = SMALL_CONFIG[:12] + [[10, 10, 2, 2], 64, [16, 16, 4, 4],
                                        2, 16, 40000]


def test_separated_vocal_into_a_40k_model_matches_jax(files, tmp_path):
    """The web app's chain from separation to conversion: `uvr_convert`
    of a 1 s 44.1 kHz mix with a narrow DeEcho net, then `infer_convert`
    of its vocal with a small v2/40k model, through the port's Api and
    tpu_rvc's: both stems and the converted file within 1 LSB, the
    output at 40 kHz, 400 samples a 10 ms frame; the port's output is its
    own separator's vocal through its `VC.vc_single`."""
    from tpu_rvc_torch.ckpt.uvr5_loader import random_deecho_reference_state
    from tpu_rvc_torch.pipeline import uvr5
    from tpu_rvc_torch.pipeline import vc as vc_module

    net = seeded(Synthesizer, 95, **SMALL_40K)
    with torch.no_grad():
        for up in net.dec.ups:        # as tests/test_torch_presets.py
            up.weight.mul_(30.0)
    sd = reference_state(net, 96)
    os.makedirs(tmp_path / "weights")
    save_pth({"weight": {k: w.astype(np.float16) for k, w in sd.items()},
              "config": SMALL_40K_CONFIG, "sr": "40k", "f0": 1,
              "version": "v2", "info": "40k"},
             str(tmp_path / "weights" / "m40.pth"))
    sep_model = str(tmp_path / "VR-DeEchoNormal_tiny.pth")
    torch.save(random_deecho_reference_state(5, 1344, nout=8, nout_lstm=16),
               sep_model)
    t = np.arange(44100) / 44100
    mix = (0.3 * np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(
        2 * np.pi * 3 * t)) + 0.1 * np.sin(2 * np.pi * 1320 * t)
        + 0.02 * np.random.default_rng(97).standard_normal(t.size))
    save_wav(str(tmp_path / "song.wav"), mix.astype(np.float32), 44100)
    roots = dict(weight_root=str(tmp_path / "weights"),
                 index_root=str(tmp_path), uvr5_root=str(tmp_path))
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hubert_loader, "load_hubert_base",
                   lambda path, version="v2", device=None: files["hub"])
        mp.setattr(jax_hubert_loader, "load_hubert_base",
                   lambda path, version="v2": files["jax_hub"])
        deterministic(mp, VC)
        deterministic(mp, JaxVC)
        for tag, api in (("port", web.Api(**roots, device="cpu")),
                         ("jax", jax_web.Api(**roots))):
            stems = api.uvr_convert(sep_model, str(tmp_path / "song.wav"),
                                    ins_root=str(tmp_path / tag / "ins"),
                                    vocal_root=str(tmp_path / tag / "voc"))
            conv = api.infer_convert(
                0, stems["vocal"], f0_method="pm", rms_mix_rate=0.25,
                model_name="m40.pth",
                output_path=str(tmp_path / tag / "out.wav"))
            outs[tag] = (stems, conv, api)
    for stem in ("instrument", "vocal"):
        a, sr = read_int16(outs["port"][0][stem])
        b, jsr = read_int16(outs["jax"][0][stem])
        assert sr == jsr == 44100 and a.shape == b.shape
        assert int(np.abs(a.astype(int) - b).max()) <= LSB, stem
    a, sr = read_int16(outs["port"][1]["output"])
    b, jsr = read_int16(outs["jax"][1]["output"])
    assert sr == jsr == outs["port"][1]["sr"] == 40000
    api = outs["port"][2]
    L_true = 16000 + 2 * int(16000 * api._vc.x_pad)
    L = vc_module._bucket(L_true)
    frames = min(L_true // 160, L // 160, vc_module._feat_frames(L))
    assert a.shape == b.shape == (frames * 400 - 2 * 40000 * api._vc.x_pad,)
    assert np.abs(a).max() > 1000
    assert int(np.abs(a.astype(int) - b).max()) <= LSB
    _, voc, vsr = uvr5.load_separator(sep_model, device="cpu").separate(
        str(tmp_path / "song.wav"))
    save_wav(str(tmp_path / "voc_lib.wav"), voc, vsr)
    assert np.array_equal(read_int16(outs["port"][0]["vocal"])[0],
                          read_int16(str(tmp_path / "voc_lib.wav"))[0])
    _, (_, direct) = api._vc.vc_single(0, outs["port"][0]["vocal"], 0, "pm",
                                       None, 0.66, 3, 0, 0.25, 0.33)
    assert np.array_equal(a, direct)
