"""tpu_rvc_torch's ONNX protobuf reader and writer and its executor
against tpu_rvc's on the CPU: each package's reader on the other's
files, the executor op family by op family against the JAX executor, its
refusal of an unknown op, and `export_module_to_onnx` beyond the
synthesizer's ops through both executors.  (The synthesizer and HuBERT
graphs are in tests/test_torch_onnx.py.)"""

import numpy as np
import pytest
import torch

from tpu_rvc.ckpt import onnx_reader as jax_reader

from tpu_rvc_torch.ckpt import onnx_reader
from tpu_rvc_torch.ckpt.torch2onnx import export_module_to_onnx
from tpu_rvc_torch.models.onnx_exec import OnnxModule

from test_torch_onnx import _both, _jax_ops, _write


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
