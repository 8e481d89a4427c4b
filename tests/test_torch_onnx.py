"""tpu_rvc_torch's ONNX and `.pt2` paths against tpu_rvc's on the CPU: the
protobuf reader and writer both ways, the executor op family by op family
against the JAX executor, the synthesizer graphs each package exports
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

from tpu_rvc.ckpt import onnx_reader as jax_reader
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
                                           export_module_to_onnx,
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
# the protobuf reader and writer
# ---------------------------------------------------------------------------

def _fixture_model(enc):
    nodes = [enc.encode_node("Conv", ["x", "w"], ["c"], kernel_shape=[3],
                             pads=[1, 1], strides=[1], group=1),
             enc.encode_node("LeakyRelu", ["c"], ["r"], alpha=0.2),
             enc.encode_node("Resize", ["r", "", "sc"], ["y"],
                             mode="nearest")]
    inits = {"w": np.arange(24, dtype=np.float32).reshape(4, 2, 3),
             "sc": np.asarray([1, 1, 2], np.float32),
             "i": np.asarray([[3, -4]], np.int64),
             "b": np.asarray([True, False])}
    return enc.encode_model(nodes, inits, [("x", 1, (1, 2, "time"))],
                            [("y", 1, (1, 4, 16))])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reader_parses_the_other_writer(tmp_path, writer):
    enc, dec = ((jax_reader, onnx_reader) if writer == "jax"
                else (onnx_reader, jax_reader))
    path = _write(tmp_path / "m.onnx", _fixture_model(enc))
    g, ref = dec.load_onnx(path), enc.load_onnx(path)
    assert [(n.op_type, n.inputs, n.outputs) for n in g.nodes] == \
        [(n.op_type, n.inputs, n.outputs) for n in ref.nodes]
    for a, b in zip(g.nodes, ref.nodes):
        assert {k: v.value for k, v in a.attrs.items()} == \
            {k: v.value for k, v in b.attrs.items()}
    assert g.initializers.keys() == ref.initializers.keys()
    for k, v in g.initializers.items():
        np.testing.assert_array_equal(v, ref.initializers[k])
        assert v.dtype == ref.initializers[k].dtype
    assert (g.inputs, g.outputs, g.input_info) == \
        (ref.inputs, ref.outputs, ref.input_info)
    assert g.input_info["x"] == (1, (1, 2, "time"))


# ---------------------------------------------------------------------------
# the executor, op family by op family
# ---------------------------------------------------------------------------

def _case(name, rng):
    """(nodes, initializers, input names, inputs, output names)."""
    e = onnx_reader.encode_node
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    i64 = lambda *v: np.asarray(v, np.int64)  # noqa: E731
    if name == "conv":
        return ([e("Conv", ["x", "w", "b"], ["y1"], kernel_shape=[3],
                   strides=[2], dilations=[2], pads=[1, 2], group=2),
                 e("Conv", ["x2", "w2"], ["y2"], kernel_shape=[3, 3],
                   pads=[1, 0, 1, 2])],
                {"w": f(6, 2, 3), "b": f(6), "w2": f(5, 3, 3, 3)},
                ["x", "x2"], [f(2, 4, 19), f(1, 3, 8, 9)], ["y1", "y2"])
    if name == "conv_transpose":
        return ([e("ConvTranspose", ["x", "w", "b"], ["y1"],
                   kernel_shape=[5], strides=[3], pads=[1, 2],
                   output_padding=[1]),
                 e("ConvTranspose", ["x2", "w2"], ["y2"],
                   kernel_shape=[2, 2], strides=[2, 2])],
                {"w": f(4, 3, 5), "b": f(3), "w2": f(3, 2, 2, 2)},
                ["x", "x2"], [f(2, 4, 7), f(1, 3, 5, 6)], ["y1", "y2"])
    if name == "norms":
        return ([e("BatchNormalization", ["x", "g", "b", "m", "v"], ["bn"],
                   epsilon=1e-5),
                 e("InstanceNormalization", ["bn", "g", "b"], ["inn"]),
                 e("GroupNormalization", ["inn", "g", "b"], ["y"],
                   num_groups=2, epsilon=1e-5)],
                {"g": f(4) + 1, "b": f(4), "m": f(4),
                 "v": np.abs(f(4)) + 0.5},
                ["x"], [f(2, 4, 6, 5)], ["y"])
    if name == "elementwise":
        un = ["Neg", "Exp", "Sin", "Cos", "Abs", "Sign", "Floor", "Ceil",
              "Round", "Erf", "Softplus", "Relu", "Sigmoid", "Tanh"]
        nodes = [e(op, ["x"], [f"u{i}"]) for i, op in enumerate(un)]
        nodes += [e("Sqrt", ["u4"], ["sq"]), e("Reciprocal", ["u1"], ["rc"]),
                  e("Log", ["u1"], ["lg"]),
                  e("LeakyRelu", ["x"], ["lr"], alpha=0.1),
                  e("Elu", ["x"], ["el"], alpha=0.5),
                  e("Clip", ["x", "lo", "hi"], ["cl"]),
                  e("Pow", ["u4", "two"], ["pw"]),
                  e("Max", ["x", "y", "u2"], ["mx"]),
                  e("Min", ["x", "y"], ["mn"]),
                  e("Mod", ["x", "two"], ["md0"]),
                  e("Mod", ["x", "two"], ["md1"], fmod=1),
                  e("Greater", ["x", "y"], ["gt"]),
                  e("LessOrEqual", ["x", "u2"], ["le"]),
                  e("Equal", ["u6", "u7"], ["eq"]),
                  e("Xor", ["gt", "le"], ["xo"]),
                  e("And", ["gt", "eq"], ["an"]), e("Not", ["an"], ["nt"]),
                  e("Or", ["nt", "xo"], ["orr"]),
                  e("Where", ["orr", "x", "y"], ["wh"]),
                  e("Sub", ["wh", "y"], ["sb"]), e("Div", ["sb", "u1"],
                                                   ["dv"])]
        outs = [f"u{i}" for i in range(len(un))] + [
            "sq", "rc", "lg", "lr", "el", "cl", "pw", "mx", "mn", "md0",
            "md1", "dv"]
        return (nodes, {"lo": np.float32(-0.5).reshape(()),
                        "hi": np.float32(0.7).reshape(()),
                        "two": np.asarray([2.0], np.float32)},
                ["x", "y"], [f(3, 7) * 3, f(3, 7)], outs)
    if name == "products":
        return ([e("MatMul", ["a", "b"], ["mm"]),
                 e("Gemm", ["a2", "w", "c"], ["gm"], transB=1, alpha=0.5,
                   beta=2.0),
                 e("Einsum", ["a", "b"], ["es"], equation="bij,bjk->bki")],
                {"w": f(6, 5), "c": f(6)}, ["a", "b", "a2"],
                [f(2, 3, 4), f(2, 4, 5), f(3, 5)], ["mm", "gm", "es"])
    if name == "shape":
        return ([e("Reshape", ["x", "s"], ["rs"]),
                 e("Transpose", ["rs"], ["tr"], perm=[2, 0, 1]),
                 e("Slice", ["x", "st", "en", "ax", "sp"], ["sl"]),
                 e("Slice", ["x", "st2", "en2"], ["sl2"]),
                 e("Pad", ["x", "pads", "pv"], ["pd"], mode="constant"),
                 e("Unsqueeze", ["x", "ax1"], ["us"]),
                 e("Squeeze", ["us", "ax1"], ["sqz"]),
                 e("Expand", ["col", "es"], ["ex"]),
                 e("Tile", ["x", "reps"], ["tl"]),
                 e("Flatten", ["x"], ["fl"], axis=2),
                 e("Split", ["x", "sz"], ["p0", "p1"], axis=2),
                 e("Concat", ["p1", "p0"], ["cc"], axis=2),
                 e("Identity", ["cc"], ["id"])],
                {"s": i64(3, 2, -1), "st": i64(5, 0), "en": i64(-100, 2),
                 "ax": i64(2, 1), "sp": i64(-2, 1), "st2": i64(0, 1),
                 "en2": i64(2, 9), "pads": i64(0, 1, -1, 0, 2, 2),
                 "pv": np.asarray(1.5, np.float32), "ax1": i64(1),
                 "es": i64(2, 3, 4), "reps": i64(1, 2, 1), "sz": i64(2, 3)},
                ["x", "col"], [f(2, 3, 5), f(3, 1)],
                ["tr", "sl", "sl2", "pd", "sqz", "ex", "tl", "fl", "id"])
    if name == "reduce":
        return ([e("ReduceSum", ["x", "ax"], ["rs"], keepdims=0),
                 e("ReduceMean", ["x"], ["rm"], axes=[1]),
                 e("ReduceMax", ["x"], ["rx"], axes=[0, 2], keepdims=0),
                 e("ReduceMin", ["x"], ["rn"], axes=[2]),
                 e("ReduceProd", ["x"], ["rp"], axes=[1], keepdims=0),
                 e("ArgMax", ["x"], ["am"], axis=1, keepdims=0),
                 e("ArgMin", ["x"], ["an"], axis=2),
                 e("Softmax", ["x"], ["sm"], axis=1),
                 e("CumSum", ["x", "c1"], ["cs"]),
                 e("CumSum", ["x", "c2"], ["cr"], reverse=1),
                 e("CumSum", ["x", "c1"], ["ce"], exclusive=1)],
                {"ax": i64(0, 2), "c1": np.asarray(1, np.int64),
                 "c2": np.asarray(2, np.int64)}, ["x"], [f(3, 4, 5)],
                ["rs", "rm", "rx", "rn", "rp", "am", "an", "sm", "cs", "cr",
                 "ce"])
    if name == "index":
        return ([e("Gather", ["x", "gi"], ["g"], axis=1),
                 e("GatherND", ["x", "ni"], ["gn"]),
                 e("ScatterND", ["x", "si", "su"], ["sa"], reduction="add"),
                 e("ScatterND", ["x", "si1", "su1"], ["ss"])],
                {"gi": i64([0, 3], [2, 2]), "ni": i64([[1, 2], [0, 0]]),
                 "si": i64([[0, 1], [0, 1], [2, 3]]), "su": f(3, 5),
                 "si1": i64([[1], [2]]), "su1": f(2, 4, 5)},
                ["x"], [f(3, 4, 5)], ["g", "gn", "sa", "ss"])
    if name == "misc":
        return ([e("Range", ["r0", "r1", "r2"], ["rg"]),
                 e("Cast", ["rg"], ["rgf"], to=1),
                 e("Add", ["x", "rgf"], ["xa"]),
                 e("Shape", ["x"], ["sh"]),
                 e("Cast", ["sh"], ["shf"], to=1),
                 e("Constant", [], ["k"], value=0),
                 e("Cast", ["x"], ["xi"], to=7),
                 e("Cast", ["xi"], ["xf"], to=1)],
                {"r0": np.asarray(2, np.int64), "r1": np.asarray(14, np.int64),
                 "r2": np.asarray(3, np.int64)}, ["x"], [f(2, 4) * 5],
                ["xa", "shf", "xf"])
    if name == "pool":
        return ([e("MaxPool", ["x"], ["mp"], kernel_shape=[2, 2],
                   strides=[2, 2]),
                 e("AveragePool", ["x"], ["ap"], kernel_shape=[3, 2],
                   strides=[1, 2]),
                 e("GlobalAveragePool", ["x"], ["gp"])],
                {}, ["x"], [f(2, 3, 6, 8)], ["mp", "ap", "gp"])
    if name == "resize":
        return ([e("Resize", ["x", "", "sc"], ["rn"], mode="nearest"),
                 e("Resize", ["x", "", "", "sz"], ["rl"], mode="linear")],
                {"sc": np.asarray([1, 1, 2, 3], np.float32),
                 "sz": i64(2, 3, 8, 10)}, ["x"], [f(2, 3, 4, 5)],
                ["rn", "rl"])
    if name == "fixture_conv_bn_relu_convtranspose":   # tests/test_onnx.py
        return ([e("Conv", ["input", "w1", "b1"], ["c1"], kernel_shape=[3, 3],
                   pads=[1, 1, 1, 1], strides=[1, 1]),
                 e("BatchNormalization", ["c1", "g", "beta", "mean", "var"],
                   ["bn"], epsilon=1e-5),
                 e("Relu", ["bn"], ["r"]),
                 e("ConvTranspose", ["r", "w2"], ["output"],
                   kernel_shape=[2, 2], strides=[2, 2], pads=[0, 0, 0, 0])],
                {"w1": f(8, 4, 3, 3), "b1": f(8),
                 "g": rng.uniform(0.5, 2, 8).astype(np.float32),
                 "beta": f(8), "mean": f(8),
                 "var": rng.uniform(0.5, 2, 8).astype(np.float32),
                 "w2": f(8, 4, 2, 2)},
                ["input"], [f(2, 4, 16, 16)], ["output"])
    if name == "fixture_elementwise_and_shape_ops":   # tests/test_onnx.py
        return ([e("Transpose", ["input"], ["t"], perm=[0, 2, 1]),
                 e("Reshape", ["t", "shape"], ["rs"]),
                 e("Sigmoid", ["rs"], ["s"]),
                 e("Mul", ["s", "s"], ["output"])],
                {"shape": i64(2, 12)}, ["input"], [f(2, 3, 4)], ["output"])
    raise KeyError(name)


FAMILIES = ("conv", "conv_transpose", "norms", "elementwise", "products",
            "shape", "reduce", "index", "misc", "pool", "resize",
            "fixture_conv_bn_relu_convtranspose",
            "fixture_elementwise_and_shape_ops")


@pytest.mark.parametrize("family", FAMILIES)
def test_executor_matches_jax(tmp_path, family):
    rng = np.random.default_rng(sum(map(ord, family)))
    nodes, inits, in_names, inputs, outs = _case(family, rng)
    path = _write(tmp_path / "m.onnx", onnx_reader.encode_model(
        nodes, inits, in_names, outs))
    port, jax = _both(path, *inputs)
    assert len(port) == len(jax) == len(outs)
    for name, p, j in zip(outs, port, jax):
        assert p.shape == j.shape, name
        np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-5, err_msg=name)


def test_executor_refuses_unknown_ops(tmp_path):
    path = _write(tmp_path / "m.onnx", onnx_reader.encode_model(
        [onnx_reader.encode_node("Frobnicate", ["x"], ["y"])], {}, ["x"],
        ["y"]))
    with pytest.raises(NotImplementedError, match="Frobnicate"):
        OnnxModule.from_file(path, "cpu")


class _Mixed(torch.nn.Module):
    """Ops the synthesizer and HuBERT do not trace: the norms in eval,
    clamps, the tanh GELU, index_select, pow/round/fmod/remainder, boolean
    logic, reductions, argmax, repeat, scatter with a traced index."""

    def __init__(self):
        super().__init__()
        self.gn = torch.nn.GroupNorm(2, 4)
        self.bn = torch.nn.BatchNorm1d(4).eval()
        self.bn.running_mean.normal_()
        self.bn.running_var.uniform_(0.5, 2)
        self.lin = torch.nn.Linear(6, 5)

    def forward(self, x, idx):
        a = self.bn(self.gn(x))
        b = torch.clamp(a, -0.5, 0.7) + torch.clamp_min(a, 0.1) * \
            torch.clamp_max(a, 0.2)
        c = torch.nn.functional.gelu(self.lin(b), approximate="tanh") + \
            torch.nn.functional.silu(b[..., :5])
        e = c.pow(2).round() + torch.fmod(c, 0.3) + torch.remainder(c, 0.7)
        m = ((c > 0) & (c < 1)) | ~(c == 0.5)
        f = torch.where(m, c, -c) + e
        arg = f.argmax(dim=1)
        sc = torch.zeros(2, 4, 5).scatter(
            2, arg[:, None, :].expand(2, 4, 5) % 5, f)
        return (torch.index_select(c, 2, idx),
                f.amax(dim=1) + f.amin(dim=-1)[..., :1] + f.mean(dim=1), arg,
                f.repeat(1, 2, 1).transpose(1, 2), torch.cumsum(f, 2), sc)


def test_export_mixed_ops(tmp_path):
    """export_module_to_onnx beyond the synthesizer's ops: both executors
    within 1e-5 of eager."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        mod = _Mixed()
        x = torch.randn(2, 4, 6)
    idx = torch.tensor([4, 0, 2])
    names = [f"o{i}" for i in range(6)]
    path = _write(tmp_path / "mixed.onnx", export_module_to_onnx(
        mod, (x, idx), ["x", "idx"], names))
    assert {n.op_type for n in onnx_reader.load_onnx(path).nodes} <= \
        _jax_ops()
    with torch.no_grad():
        want = [w.double().numpy() for w in mod(x, idx)]
    port, jax = _both(path, x.numpy(), idx.numpy())
    for name, w, p, j in zip(names, want, port, jax):
        np.testing.assert_allclose(p, w, rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(j, w, rtol=0, atol=1e-5, err_msg=name)


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
