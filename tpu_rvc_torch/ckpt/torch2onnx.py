"""torch.export -> ONNX converter (the counterpart of
tpu_rvc/ckpt/jax2onnx.py; reference rvc/onnx/exporter.py).

The reference exports its synthesizer with `torch.onnx.export` at opset 17
with the noise as an input, `rnd` (rvc/onnx/exporter.py:6-51).  That
exporter needs the `onnx` package, which is not installed, so this module
does what jax2onnx does with a jaxpr: it walks the core-ATen graph of
`torch.export.export(...).run_decompositions()` and writes an opset-17
model with the dependency-free writer of `ckpt/onnx_reader.py`.

Design, as jax2onnx's:
  1. parameters, buffers and constants are lifted into initializers;
  2. only nodes the outputs depend on are visited (dead code and
     `_assert_tensor_metadata` drop out);
  3. a node whose tensor inputs are all constant (`arange`, `full`, the
     index grids, the weight-norm folds) is evaluated on the CPU and
     becomes an initializer;
  4. every other node becomes ONNX nodes, from the op set that
     `tpu_rvc.models.onnx_exec` runs, so the JAX package's executor runs
     these files and this package's runs the JAX package's.  Shapes are
     static (the export's); dynamic axes are dim_param annotations only.

So `native_layer_norm` becomes ReduceMean/Sub/Mul/Sqrt/Div, `flip` a Slice
with step -1, `gather` GatherND and `scatter_add` ScatterND(add) over full
index grids, `remainder` x - floor(x / y) * y.  A graph traced here holds
the modules' plain PyTorch path, never the CUDA kernels, whose launches
are opaque to `torch.export` (the kernels' dispatch checks
`torch.compiler.is_exporting()`), as the JAX exporter traces XLA, never
the Pallas kernels.
"""

from __future__ import annotations

import operator
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .onnx_reader import ONNX_DTYPE, encode_model, encode_node

aten = torch.ops.aten
_FOLD_LIMIT = 64 * 1024 * 1024  # elements at most in a folded constant


class _Ref:
    """A value of the graph: a CPU tensor if it is a constant, else the
    name of the ONNX tensor that holds it."""
    __slots__ = ("const", "name", "meta")

    def __init__(self, meta, const=None, name=None):
        self.meta, self.const, self.name = meta, const, name

    @property
    def shape(self):
        return tuple(int(d) for d in self.meta.shape)

    @property
    def dtype(self):
        return self.meta.dtype


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        raise NotImplementedError("ONNX export: bfloat16")
    return torch.empty((), dtype=dtype).numpy().dtype


def _elem(dtype: torch.dtype) -> int:
    return ONNX_DTYPE[_np_dtype(dtype)]


class _Builder:
    def __init__(self):
        self.nodes: List[tuple] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self._n = 0
        self._small: Dict[tuple, str] = {}

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def const(self, arr, hint: str = "c") -> str:
        arr = np.ascontiguousarray(arr.numpy() if torch.is_tensor(arr)
                                   else np.asarray(arr))
        if arr.nbytes <= 1 << 16:   # small constants shared by value
            key = (arr.tobytes(), str(arr.dtype), arr.shape)
            if key in self._small:
                return self._small[key]
        name = self.fresh(hint)
        self.initializers[name] = arr
        if arr.nbytes <= 1 << 16:
            self._small[key] = name
        return name

    def i64(self, vals) -> str:
        return self.const(np.asarray(vals, np.int64))

    def node(self, op: str, inputs: List[str], n_out: int = 1,
             outputs: Optional[List[str]] = None, **attrs) -> Any:
        if outputs is None:
            outputs = [self.fresh(op.lower()) for _ in range(n_out)]
        self.nodes.append((op, list(inputs), list(outputs), attrs))
        return outputs[0] if n_out == 1 else outputs

    def read(self, ref: _Ref) -> str:
        if ref.name is None:
            c = ref.const
            if c.numel() > 4096 and bool((c == c.reshape(-1)[0]).all()):
                # a fill (full_like of attention scores, the zero source
                # noise) grows with T: one value, expanded at run time
                ref.name = self.node("Expand", [
                    self.const(c.reshape(-1)[:1].reshape((1,) * c.dim())),
                    self.i64(list(c.shape))])
            else:
                ref.name = self.const(c)
        return ref.name

    def live_nodes(self, outputs: Sequence[str]) -> List[bytes]:
        """The nodes the outputs depend on, encoded, in order."""
        live, kept = set(outputs), []
        for op, ins, outs, attrs in reversed(self.nodes):
            if live.intersection(outs):
                kept.append((op, ins, outs, attrs))
                live.update(i for i in ins if i)
        self.initializers = {k: v for k, v in self.initializers.items()
                             if k in live}
        return [encode_node(op, ins, outs, **attrs)
                for op, ins, outs, attrs in reversed(kept)]


# ---------------------------------------------------------------------------
# emitters: (builder, node, args, kwargs) -> ONNX name(s); tensor arguments
# arrive as _Ref, everything else as it is in the graph
# ---------------------------------------------------------------------------

_UNARY = {aten.exp.default: "Exp", aten.log.default: "Log",
          aten.sin.default: "Sin", aten.cos.default: "Cos",
          aten.sqrt.default: "Sqrt", aten.abs.default: "Abs",
          aten.neg.default: "Neg", aten.sign.default: "Sign",
          aten.floor.default: "Floor", aten.ceil.default: "Ceil",
          aten.tanh.default: "Tanh", aten.sigmoid.default: "Sigmoid",
          aten.erf.default: "Erf", aten.relu.default: "Relu",
          aten.reciprocal.default: "Reciprocal",
          aten.round.default: "Round", aten.logical_not.default: "Not"}
_ARITH = {aten.add.Tensor: "Add", aten.add.Scalar: "Add",
          aten.sub.Tensor: "Sub", aten.sub.Scalar: "Sub",
          aten.mul.Tensor: "Mul", aten.mul.Scalar: "Mul",
          aten.div.Tensor: "Div", aten.div.Scalar: "Div",
          aten.pow.Tensor_Scalar: "Pow", aten.pow.Tensor_Tensor: "Pow",
          aten.maximum.default: "Max", aten.minimum.default: "Min"}
_COMPARE = {aten.eq.Tensor: "Equal", aten.eq.Scalar: "Equal",
            aten.gt.Tensor: "Greater", aten.gt.Scalar: "Greater",
            aten.ge.Tensor: "GreaterOrEqual", aten.ge.Scalar: "GreaterOrEqual",
            aten.lt.Tensor: "Less", aten.lt.Scalar: "Less",
            aten.le.Tensor: "LessOrEqual", aten.le.Scalar: "LessOrEqual"}
_LOGICAL = {aten.logical_and.default: "And", aten.logical_or.default: "Or",
            aten.logical_xor.default: "Xor", aten.bitwise_and.Tensor: "And",
            aten.bitwise_or.Tensor: "Or", aten.bitwise_xor.Tensor: "Xor"}
_IDENTITY = {aten.clone.default, aten.alias.default, aten.detach.default,
             aten.lift_fresh_copy.default, aten.contiguous.default}
_RESHAPE = {aten.view.default, aten.unsqueeze.default, aten.squeeze.dims}
_LIKE = {aten.full_like.default, aten.zeros_like.default,
         aten.ones_like.default}
_SKIP = {aten._assert_tensor_metadata.default, aten._assert_scalar.default,
         aten.sym_constrain_range_for_size.default}


def _out_meta(node):
    return node.meta["val"]


def _operand(b: _Builder, x, dtype: torch.dtype, rank: int) -> str:
    """A tensor or python scalar as an ONNX name of `dtype`; scalars become
    constants of shape (1,) * rank so that both readers keep the rank."""
    if isinstance(x, _Ref):
        if x.dtype == dtype:
            return b.read(x)
        if x.const is not None:
            return b.const(x.const.to(dtype))
        return b.node("Cast", [b.read(x)], to=_elem(dtype))
    return b.const(np.full((1,) * rank, x, _np_dtype(dtype)))


def _arith(b, node, op, x, y, alpha=1):
    out = _out_meta(node)
    rank = out.dim()
    if alpha != 1:
        y = b.node("Mul", [_operand(b, y, out.dtype, rank),
                           _operand(b, alpha, out.dtype, rank)])
        y = _Ref(out, name=y)
    return b.node(op, [_operand(b, x, out.dtype, rank),
                       _operand(b, y, out.dtype, rank)])


def _meta_of(x):
    return x.meta if isinstance(x, _Ref) else x


def _compare(b, node, op, x, y):
    dtype = torch.result_type(_meta_of(x), _meta_of(y))
    rank = _out_meta(node).dim()
    return b.node(op, [_operand(b, x, dtype, rank), _operand(b, y, dtype, rank)])


def _axis(d: int, rank: int) -> int:
    return d % rank if rank else 0


def _index_grids(shape) -> np.ndarray:
    """(*shape, rank) int64 of each element's own coordinates."""
    return np.stack(np.meshgrid(*[np.arange(n) for n in shape],
                                indexing="ij"), -1).astype(np.int64)


def _full_index(b: _Builder, index: _Ref, dim: int) -> str:
    """torch.gather/scatter's index along `dim` -> GatherND/ScatterND's
    full (…, rank) index: the other coordinates are the element's own."""
    shape, rank = index.shape, len(index.shape)
    dim = _axis(dim, rank)
    if index.const is not None:
        grid = _index_grids(shape)
        grid[..., dim] = index.const.numpy()
        return b.const(grid)
    parts = []
    grid = _index_grids(shape)
    for d in range(rank):
        if d == dim:
            idx = _operand(b, index, torch.int64, rank)
            parts.append(b.node("Reshape", [idx, b.i64(shape + (1,))]))
        else:
            parts.append(b.const(grid[..., d:d + 1]))
    return b.node("Concat", parts, axis=rank)


def _layer_norm(b, x: str, axes, eps, w=None, bias=None, dtype=torch.float32):
    mean = b.node("ReduceMean", [x], axes=axes, keepdims=1)
    d = b.node("Sub", [x, mean])
    var = b.node("ReduceMean", [b.node("Mul", [d, d])], axes=axes, keepdims=1)
    std = b.node("Sqrt", [b.node("Add", [var, b.const(
        np.full((1,), eps, _np_dtype(dtype)))])])
    y = b.node("Div", [d, std])
    if w is not None:
        y = b.node("Mul", [y, w])
    if bias is not None:
        y = b.node("Add", [y, bias])
    return y


def _emit(b: _Builder, node, args, kwargs):
    t = node.target
    out = _out_meta(node)
    if t in _UNARY:
        return b.node(_UNARY[t], [b.read(args[0])])
    if t in _ARITH:
        return _arith(b, node, _ARITH[t], args[0], args[1],
                      kwargs.get("alpha", 1))
    if t in _COMPARE:
        return _compare(b, node, _COMPARE[t], args[0], args[1])
    if t == aten.ne.Tensor or t == aten.ne.Scalar:
        return b.node("Not", [_compare(b, node, "Equal", args[0], args[1])])
    if t in _LOGICAL or t == aten.bitwise_not.default:
        if any(isinstance(a, _Ref) and a.dtype != torch.bool for a in args):
            raise NotImplementedError(f"ONNX export: {t} on integers")
        if t == aten.bitwise_not.default:
            return b.node("Not", [b.read(args[0])])
        return b.node(_LOGICAL[t], [b.read(args[0]), b.read(args[1])])
    if t in _IDENTITY:
        return b.read(args[0])
    if t == aten._to_copy.default:
        x = args[0]
        if x.dtype == out.dtype:
            return b.read(x)
        return b.node("Cast", [b.read(x)], to=_elem(out.dtype))
    if t in _RESHAPE:
        x = args[0]
        if x.shape == tuple(out.shape):
            return b.read(x)
        return b.node("Reshape", [b.read(x), b.i64(list(out.shape))])
    if t == aten.expand.default:
        x = args[0]
        if x.shape == tuple(out.shape):
            return b.read(x)
        return b.node("Expand", [b.read(x), b.i64(list(out.shape))])
    if t == aten.permute.default:
        rank = len(args[0].shape)
        return b.node("Transpose", [b.read(args[0])],
                      perm=[_axis(p, rank) for p in args[1]])
    if t == aten.cat.default:
        dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        return b.node("Concat", [b.read(x) for x in args[0]],
                      axis=_axis(dim, out.dim()))
    if t == aten.split_with_sizes.default:
        x, sizes = args[0], [int(s) for s in args[1]]
        dim = _axis(args[2] if len(args) > 2 else 0, len(x.shape))
        return b.node("Split", [b.read(x), b.i64(sizes)], n_out=len(sizes),
                      axis=dim)
    if t == aten.slice.Tensor:
        x = args[0]
        dim = _axis(args[1] if len(args) > 1 else 0, len(x.shape))
        n = x.shape[dim]
        start = args[2] if len(args) > 2 and args[2] is not None else 0
        end = args[3] if len(args) > 3 and args[3] is not None else n
        step = args[4] if len(args) > 4 else 1
        r = range(*slice(start, end, step).indices(n))
        if len(r) == n:
            return b.read(x)
        return b.node("Slice", [b.read(x), b.i64([r.start]),
                                b.i64([r.start + len(r) * step]),
                                b.i64([dim]), b.i64([step])])
    if t == aten.select.int:
        x = args[0]
        dim = _axis(args[1], len(x.shape))
        i = args[2] % x.shape[dim]
        s = b.node("Slice", [b.read(x), b.i64([i]), b.i64([i + 1]),
                             b.i64([dim])])
        return b.node("Reshape", [s, b.i64(list(out.shape))])
    if t == aten.flip.default:
        x = args[0]
        dims = [_axis(d, len(x.shape)) for d in args[1]]
        return b.node("Slice", [
            b.read(x), b.i64([x.shape[d] - 1 for d in dims]),
            b.i64([-(x.shape[d] + 1) for d in dims]), b.i64(dims),
            b.i64([-1] * len(dims))])
    if t == aten.constant_pad_nd.default:
        x, pad = args[0], [int(p) for p in args[1]]
        value = args[2] if len(args) > 2 else 0
        rank = len(x.shape)
        pairs = [(0, 0)] * rank
        for i in range(len(pad) // 2):
            pairs[rank - 1 - i] = (pad[2 * i], pad[2 * i + 1])
        return b.node("Pad", [b.read(x), b.i64([p[0] for p in pairs]
                                              + [p[1] for p in pairs]),
                              b.const(np.asarray(value, _np_dtype(x.dtype)))],
                      mode="constant")
    if t == aten.convolution.default:
        return _emit_conv(b, *args)
    if t == aten.addmm.default:
        bias, x, w = args[:3]
        beta, alpha = kwargs.get("beta", 1), kwargs.get("alpha", 1)
        return b.node("Gemm", [b.read(x), b.read(w), b.read(bias)],
                      alpha=float(alpha), beta=float(beta))
    if t in (aten.mm.default, aten.bmm.default):
        return b.node("MatMul", [b.read(args[0]), b.read(args[1])])
    if t == aten._softmax.default:
        return b.node("Softmax", [b.read(args[0])],
                      axis=_axis(args[1], out.dim()))
    if t == aten.native_layer_norm.default:
        x, shape, w, bias, eps = args
        rank = len(x.shape)
        axes = list(range(rank - len(shape), rank))
        y = _layer_norm(b, b.read(x), axes, float(eps),
                        None if w is None else b.read(w),
                        None if bias is None else b.read(bias), x.dtype)
        return [y, None, None]
    if t == aten.native_group_norm.default:
        x, w, bias, N, C, HxW, group, eps = args
        xs = b.node("Reshape", [b.read(x), b.i64([N, group, -1])])
        y = _layer_norm(b, xs, [2], float(eps), dtype=x.dtype)
        y = b.node("Reshape", [y, b.i64(list(x.shape))])
        cshape = [1, C] + [1] * (len(x.shape) - 2)
        if w is not None:
            y = b.node("Mul", [y, b.node("Reshape", [b.read(w),
                                                     b.i64(cshape)])])
        if bias is not None:
            y = b.node("Add", [y, b.node("Reshape", [b.read(bias),
                                                     b.i64(cshape)])])
        return [y, None, None]
    if t == aten._native_batch_norm_legit_no_training.default:
        x, w, bias, mean, var, _momentum, eps = args
        y = b.node("BatchNormalization", [b.read(r) for r in
                                          (x, w, bias, mean, var)],
                   epsilon=float(eps))
        return [y, None, None]
    if t == aten.embedding.default:
        w, idx = args[:2]
        return b.node("Gather", [b.read(w), _operand(b, idx, torch.int64,
                                                      len(idx.shape))],
                      axis=0)
    if t == aten.index_select.default:
        x, dim, idx = args
        return b.node("Gather", [b.read(x), _operand(
            b, idx, torch.int64, 1)], axis=_axis(dim, len(x.shape)))
    if t == aten.gather.default:
        x, dim, idx = args[:3]
        return b.node("GatherND", [b.read(x), _full_index(b, idx, dim)])
    if t in (aten.scatter_add.default, aten.scatter.src):
        x, dim, idx, src = args[:4]
        if src.shape != idx.shape:
            src = _Ref(src.meta, name=b.node("Slice", [
                b.read(src), b.i64([0] * len(idx.shape)), b.i64(idx.shape),
                b.i64(list(range(len(idx.shape))))]))
        return b.node("ScatterND", [b.read(x), _full_index(b, idx, dim),
                                    b.read(src)],
                      reduction="add" if t == aten.scatter_add.default
                      else "none")
    if t == aten.cumsum.default:
        x, dim = args[:2]
        y = b.node("CumSum", [b.read(x), b.const(np.asarray(
            _axis(dim, len(x.shape)), np.int64))])
        if out.dtype != x.dtype:
            y = b.node("Cast", [y], to=_elem(out.dtype))
        return y
    if t in (aten.sum.dim_IntList, aten.sum.default, aten.mean.dim,
             aten.amax.default, aten.amin.default):
        x = args[0]
        rank = len(x.shape)
        dims = args[1] if len(args) > 1 and args[1] else list(range(rank))
        keep = int(bool(args[2])) if len(args) > 2 else int(
            bool(kwargs.get("keepdim", False)))
        axes = sorted(_axis(d, rank) for d in dims)
        xs = _operand(b, x, out.dtype, rank)
        if t in (aten.sum.dim_IntList, aten.sum.default):
            return b.node("ReduceSum", [xs, b.i64(axes)], keepdims=keep)
        op = {aten.mean.dim: "ReduceMean", aten.amax.default: "ReduceMax",
              aten.amin.default: "ReduceMin"}[t]
        return b.node(op, [xs], axes=axes, keepdims=keep)
    if t in (aten.argmax.default, aten.argmin.default):
        x, dim = args[0], args[1]
        keep = int(bool(args[2])) if len(args) > 2 else 0
        op = "ArgMax" if t == aten.argmax.default else "ArgMin"
        return b.node(op, [b.read(x)], axis=_axis(dim, len(x.shape)),
                      keepdims=keep)
    if t in (aten.remainder.Scalar, aten.remainder.Tensor):
        x, y = args
        if out.dtype.is_floating_point:   # floor mod: x - floor(x / y) * y
            rank = out.dim()
            xn, yn = (_operand(b, v, out.dtype, rank) for v in (x, y))
            q = b.node("Floor", [b.node("Div", [xn, yn])])
            return b.node("Sub", [xn, b.node("Mul", [q, yn])])
        return _arith(b, node, "Mod", x, y)
    if t in (aten.fmod.Scalar, aten.fmod.Tensor):
        rank = out.dim()
        return b.node("Mod", [_operand(b, v, out.dtype, rank)
                              for v in args[:2]], fmod=1)
    if t == aten.where.self:
        c, x, y = args
        rank = out.dim()
        return b.node("Where", [b.read(c), _operand(b, x, out.dtype, rank),
                                _operand(b, y, out.dtype, rank)])
    if t == aten.clamp.default:   # core ATen's clamp_min/clamp_max too
        x, lo = args[:2]
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        rank = out.dim()
        y = _operand(b, x, out.dtype, rank)
        if lo is not None:
            y = b.node("Max", [y, _operand(b, lo, out.dtype, rank)])
        if hi is not None:
            y = b.node("Min", [y, _operand(b, hi, out.dtype, rank)])
        return y
    if t == aten.leaky_relu.default:
        slope = args[1] if len(args) > 1 else 0.01
        return b.node("LeakyRelu", [b.read(args[0])], alpha=float(slope))
    if t == aten.gelu.default:
        x = b.read(args[0])
        approx = kwargs.get("approximate", "none")
        dt = _np_dtype(out.dtype)
        c = lambda v: b.const(np.full((1,) * out.dim(), v, dt))  # noqa
        if approx == "tanh":
            x3 = b.node("Mul", [b.node("Mul", [x, x]), x])
            inner = b.node("Mul", [c(np.sqrt(2 / np.pi)), b.node(
                "Add", [x, b.node("Mul", [c(0.044715), x3])])])
            g = b.node("Add", [c(1.0), b.node("Tanh", [inner])])
        else:
            g = b.node("Add", [c(1.0), b.node("Erf", [b.node(
                "Mul", [x, c(1 / np.sqrt(2))])])])
        return b.node("Mul", [b.node("Mul", [x, c(0.5)]), g])
    if t == aten.repeat.default:
        return b.node("Tile", [b.read(args[0]), b.i64(list(args[1]))])
    raise NotImplementedError(f"ONNX export: op {t}")


def _emit_conv(b: _Builder, x, w, bias, stride, padding, dilation,
               transposed, output_padding, groups):
    spatial = len(w.shape) - 2
    pads = [int(p) for p in padding] * 2
    ins = [b.read(x), b.read(w)] + ([b.read(bias)] if bias is not None
                                    else [])
    kshape = list(w.shape[2:])
    if transposed:
        if groups != 1:
            raise NotImplementedError("ONNX export: grouped ConvTranspose "
                                      "(the JAX executor refuses it)")
        if any(d != 1 for d in dilation):
            raise NotImplementedError("ONNX export: dilated ConvTranspose")
        return b.node("ConvTranspose", ins, kernel_shape=kshape,
                      strides=list(stride), pads=pads,
                      output_padding=[int(p) for p in output_padding],
                      group=1)
    return b.node("Conv", ins, kernel_shape=kshape, strides=list(stride),
                  pads=pads, dilations=list(dilation) or [1] * spatial,
                  group=int(groups))


def _fold(node, args, kwargs):
    """Evaluate a node on constants, on the CPU; None if it is too big."""
    meta = _out_meta(node)
    metas = meta if isinstance(meta, (list, tuple)) else [meta]
    if sum(m.numel() for m in metas if torch.is_tensor(m)) > _FOLD_LIMIT:
        return None
    unwrap = lambda a: (a.const if isinstance(a, _Ref) else  # noqa: E731
                        [unwrap(x) for x in a] if isinstance(a, (list, tuple))
                        else a)
    kw = {k: unwrap(v) for k, v in kwargs.items()}
    if "device" in kw:
        kw["device"] = torch.device("cpu")
    return node.target(*[unwrap(a) for a in args], **kw)


def _is_const(a) -> bool:
    if isinstance(a, _Ref):
        return a.const is not None
    if isinstance(a, (list, tuple)):
        return all(_is_const(x) for x in a)
    return True


def export_program_to_onnx(
    program, input_names: Sequence[str], output_names: Sequence[str],
    dynamic_axes: Optional[Dict[str, Sequence[int]]] = None,
) -> bytes:
    """A decomposed ExportedProgram (`torch.export.export(...)
    .run_decompositions()`) -> serialized ONNX ModelProto (opset 17).
    Its user inputs take `input_names` in order, its outputs
    `output_names`; `dynamic_axes` maps a name to axes annotated with a
    dim_param (cosmetic on the static graph)."""
    graph = program.graph_module.graph
    sig = program.graph_signature
    state = dict(program.state_dict)
    state.update(program.constants)
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    env: Dict[Any, Any] = {}
    user = []
    for node, spec in zip(placeholders, sig.input_specs):
        meta = node.meta["val"]
        if spec.kind.name == "USER_INPUT":
            user.append(node)
            env[node] = _Ref(meta)
        else:
            env[node] = _Ref(meta, const=state[spec.target].detach().to(
                "cpu").clone())
    if len(user) != len(input_names):
        raise ValueError(f"{len(input_names)} input names for {len(user)} "
                         "graph inputs")
    for node, name in zip(user, input_names):
        env[node].name = name

    out_node = next(n for n in graph.nodes if n.op == "output")
    outs = list(out_node.args[0])
    live, stack = set(), list(outs)
    while stack:
        n = stack.pop()
        if isinstance(n, torch.fx.Node) and n not in live:
            live.add(n)
            stack.extend(n.all_input_nodes)

    b = _Builder()

    def value(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(value(x) for x in a)
        return a

    for node in graph.nodes:
        if node.op != "call_function" or node not in live:
            continue
        t = node.target
        args, kwargs = value(node.args), {k: value(v)
                                          for k, v in node.kwargs.items()}
        meta = node.meta.get("val")
        if t is operator.getitem:
            env[node] = args[0][args[1]]
            continue
        if t in _SKIP:
            continue
        if not isinstance(t, torch._ops.OpOverload):
            raise NotImplementedError(f"ONNX export: call {t}")
        if t in _LIKE:
            fill = {aten.zeros_like.default: 0, aten.ones_like.default: 1
                    }.get(t, args[1] if len(args) > 1 else 0)
            env[node] = _Ref(meta, const=torch.full(
                tuple(meta.shape), fill, dtype=meta.dtype))
            continue
        if _is_const([args, list(kwargs.values())]) and \
                not t._schema.is_mutable and not t.name().startswith(("aten::rand", "aten::normal",
                                         "aten::bernoulli")):
            val = _fold(node, args, kwargs)
            if val is not None:
                if isinstance(val, (list, tuple)):
                    env[node] = [_Ref(m, const=v) for m, v in zip(meta, val)]
                else:
                    env[node] = _Ref(meta, const=val)
                continue
        names = _emit(b, node, args, kwargs)
        if isinstance(names, list):
            env[node] = [None if n is None else _Ref(m, name=n)
                         for m, n in zip(meta, names)]
        else:
            env[node] = _Ref(meta, name=names)

    if len(outs) != len(output_names):
        raise ValueError(f"{len(output_names)} output names for {len(outs)} "
                         "graph outputs")
    out_refs = [env[n] for n in outs]
    for ref, name in zip(out_refs, output_names):
        b.node("Identity", [b.read(ref)], outputs=[name])
    dyn = dynamic_axes or {}

    def vinfo(ref: _Ref, name: str):
        shape = list(ref.shape)
        for ax in dyn.get(name, ()):
            shape[ax] = f"{name}_dim{ax}"
        return name, _elem(ref.dtype), tuple(shape)

    nodes = b.live_nodes(list(output_names))
    return encode_model(
        nodes, b.initializers,
        [vinfo(env[n], nm) for n, nm in zip(user, input_names)],
        [vinfo(r, nm) for r, nm in zip(out_refs, output_names)], opset=17,
        producer="tpu_rvc_torch")


def export_module_to_onnx(module: nn.Module, example_inputs: Sequence,
                          input_names: Sequence[str],
                          output_names: Sequence[str],
                          dynamic_axes=None) -> bytes:
    """torch.export `module(*example_inputs)` at the inputs' static shapes,
    decompose to core ATen, and convert."""
    program = torch.export.export(module, tuple(example_inputs))
    return export_program_to_onnx(program.run_decompositions(), input_names,
                                  output_names, dynamic_axes)


# ---------------------------------------------------------------------------
# the synthesizer and ContentVec
# ---------------------------------------------------------------------------

class _SynthGraph(nn.Module):
    """The reference export's forward (rvc/onnx/synthesizer.py): named
    inputs -> audio, the prior noise from `rnd`, the decoder deterministic."""

    def __init__(self, synth, names, spk_mix: bool, reference_layout: bool):
        super().__init__()
        self.synth, self.names = synth, list(names)
        self.spk_mix, self.reference_layout = spk_mix, reference_layout

    def forward(self, *args):
        a = dict(zip(self.names, args))
        rnd = a["rnd"].transpose(1, 2) if self.reference_layout else a["rnd"]
        if self.spk_mix:
            out = self.synth.infer_mix(a["phone"], a["phone_lengths"],
                                       a["ds"], a.get("pitch"),
                                       a.get("pitchf"), noise=rnd)
        else:
            out = self.synth.infer(a["phone"], a["phone_lengths"], a["ds"],
                                   a.get("pitch"), a.get("pitchf"),
                                   noise=rnd, noise_scale=1.0,
                                   deterministic=True)
        return out.transpose(1, 2) if self.reference_layout else out


def synthesizer_example_inputs(synth, T: int, spk_mix: bool = False,
                               reference_layout: bool = False):
    """(names, zero inputs) of the exported synthesizer graph, on the
    synthesizer's device: phone (1, T, D) float, phone_lengths (1,) int64,
    [pitch (1, T) int64, pitchf (1, T) float,] ds (1,) int64 or (1, T, S)
    float with spk_mix, rnd (1, T, C) or, reference_layout, (1, C, T)."""
    dev = synth.emb_g.weight.device
    inter = synth.enc_p.out_channels
    enc_dim = synth.enc_p.emb_phone.in_features
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    ins = {"phone": torch.zeros(1, T, enc_dim, **f32),
           "phone_lengths": torch.full((1,), T, **i64)}
    if synth.use_f0:
        ins["pitch"] = torch.zeros(1, T, **i64)
        ins["pitchf"] = torch.zeros(1, T, **f32)
    ins["ds"] = (torch.zeros(1, T, synth.spk_embed_dim, **f32) if spk_mix
                 else torch.zeros(1, **i64))
    ins["rnd"] = torch.zeros((1, inter, T) if reference_layout
                             else (1, T, inter), **f32)
    return list(ins), list(ins.values())


def export_synthesizer_onnx(synth, T: int = 200, path: Optional[str] = None,
                            spk_mix: bool = False,
                            reference_layout: bool = False) -> bytes:
    """The synthesizer as ONNX with the reference's I/O contract
    (tpu_rvc/ckpt/jax2onnx.py:721; rvc/onnx/exporter.py:24-47): inputs
    phone/phone_lengths/pitch/pitchf/ds/rnd (no pitch inputs without f0)
    -> audio, integer inputs int64, static at T frames.  `rnd` is
    channel-last (1, T, C) by default; reference_layout=True takes it as
    (1, C, T), gives audio (1, 1, samples) and carries the reference
    exporter's dynamic-axis annotations.  spk_mix=True makes `ds` float
    (1, T, n_speakers) per-frame mixing weights (`infer_mix`)."""
    if reference_layout and spk_mix:
        raise ValueError("reference_layout applies to the reference's "
                         "exporter contract; the spk_mix variant has no "
                         "reference layout")
    names, inputs = synthesizer_example_inputs(synth, T, spk_mix,
                                               reference_layout)
    graph = _SynthGraph(synth.eval(), names, spk_mix, reference_layout)
    dyn = None
    if reference_layout:
        dyn = {"phone": [1], "pitchf": [1], "rnd": [2]}
        if synth.use_f0:
            dyn["pitch"] = [1]
    data = export_module_to_onnx(graph, inputs, names, ["audio"], dyn)
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


class _HubertGraph(nn.Module):
    def __init__(self, hubert):
        super().__init__()
        self.hubert = hubert

    def forward(self, wav):
        return self.hubert(wav)


def export_hubert_onnx(hubert, n_samples: int = 16000 * 5,
                       path: Optional[str] = None) -> bytes:
    """HuBERT/ContentVec as ONNX (the role of the reference's
    `vec-{256,768}-layer-{9,12}.onnx`, rvc/onnx/infer.py:28-46): `wav`
    (1, n_samples) float32 at 16 kHz -> channel-last `feats`."""
    dev = next(hubert.parameters()).device
    wav = torch.zeros(1, n_samples, dtype=torch.float32, device=dev)
    data = export_module_to_onnx(_HubertGraph(hubert.eval()), [wav], ["wav"],
                                 ["feats"])
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data
