"""ONNX graph executor on torch ops (port of tpu_rvc/models/onnx_exec.py;
it serves the exported synthesizer and ContentVec graphs,
`pipeline/onnx_infer.py`, and MDX-Net's opaque graphs, without
onnxruntime).

`OnnxModule(graph, device)` runs the JAX executor's op set (Conv and
ConvTranspose with groups and asymmetric pads, the norms, elementwise and
reductions, Gemm/MatMul/Einsum, Gather/GatherND/ScatterND, Resize, CumSum,
Range, Shape and the shape ops) as eager torch ops on one device, CUDA
unless the caller names another.  Everything that can be settled once is
settled when the graph is loaded: attributes are parsed into each node's
closure, initializers move to the device, and the inputs that give a
shape, axes, pads or slice bounds (`_STRUCTURAL`) stay host integers, so a
Reshape or a Slice on the card reads no device value.  A structural input
that the graph computes at run time (a Shape chain) is read back then, as
the JAX executor reads it.  An op outside the set raises
NotImplementedError with its name, as the JAX executor does.  Products run
under `fp32_math()` (no TF32 in cuBLAS or cuDNN).

Where the JAX executor departs from the ONNX specification, this one
follows the specification: Reshape's 0 copies the input's dimension,
integer Div truncates, Clip reads a lone min input, Gelu is exact unless
`approximate="tanh"`, and ConvTranspose takes groups; Pad with another
mode than constant and AveragePool with padding left out of the count
raise where the JAX executor pads with a constant and counts the padding.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rvc_torch.ckpt.onnx_reader import DTYPE, OnnxGraph, OnnxNode, load_onnx
from tpu_rvc_torch.core.device import fp32_math, resolve_device

# inputs that must be host values: op_type -> input positions
_STRUCTURAL = {"Reshape": (1,), "Slice": (1, 2, 3, 4), "Expand": (1,),
               "Tile": (1,), "CumSum": (1,), "Split": (1,), "Pad": (1, 2),
               "Resize": (1, 2, 3), "ReduceSum": (1,), "ReduceMax": (1,),
               "ReduceMin": (1,), "ReduceProd": (1,), "ReduceMean": (1,),
               "Unsqueeze": (1,), "Squeeze": (1,), "Range": (0, 1, 2)}

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.int8): torch.int8,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.bool_): torch.bool}

_UNARY = {"Neg": torch.neg, "Exp": torch.exp, "Log": torch.log,
          "Sin": torch.sin, "Cos": torch.cos, "Sqrt": torch.sqrt,
          "Reciprocal": torch.reciprocal, "Abs": torch.abs,
          "Sign": torch.sign, "Floor": torch.floor, "Ceil": torch.ceil,
          "Round": torch.round, "Erf": torch.erf, "Not": torch.logical_not,
          "Softplus": F.softplus, "Relu": torch.relu,
          "Sigmoid": torch.sigmoid, "Tanh": torch.tanh,
          "Identity": lambda x: x}
_BINARY = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
           "Pow": torch.pow, "Equal": torch.eq, "Greater": torch.gt,
           "GreaterOrEqual": torch.ge, "Less": torch.lt,
           "LessOrEqual": torch.le, "And": torch.logical_and,
           "Or": torch.logical_or, "Xor": torch.logical_xor,
           "MatMul": torch.matmul}
_REDUCE = {"ReduceSum": torch.sum, "ReduceMean": torch.mean,
           "ReduceMax": torch.amax, "ReduceMin": torch.amin}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_INTERP = {1: "linear", 2: "bilinear", 3: "trilinear"}


def _ints(v) -> List[int]:
    return [int(x) for x in np.asarray(v).reshape(-1)]


def _pad_pairs(pads, spatial: int):
    return [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]


def _torch_pad(pairs) -> List[int]:
    """(begin, end) per dim, first dim first -> F.pad's list, last first."""
    out: List[int] = []
    for lo, hi in reversed(pairs):
        out += [lo, hi]
    return out


def _conv(node: OnnxNode, transpose: bool) -> Callable:
    if node.attr("auto_pad", "NOTSET") not in ("NOTSET", "VALID"):
        raise NotImplementedError(f"ONNX {node.op_type} auto_pad "
                                  f"{node.attr('auto_pad')}")
    if node.attr("output_shape") is not None:
        raise NotImplementedError("ONNX ConvTranspose output_shape")
    group = int(node.attr("group", 1))
    attrs = {k: node.attr(k) for k in ("strides", "dilations", "pads",
                                       "output_padding")}

    def run(x, w, b=None):
        spatial = x.dim() - 2
        strides = attrs["strides"] or [1] * spatial
        dil = attrs["dilations"] or [1] * spatial
        pairs = _pad_pairs(attrs["pads"] or [0] * (2 * spatial), spatial)
        w = w.to(x.dtype)
        b = None if b is None else b.to(x.dtype)
        symmetric = all(lo == hi for lo, hi in pairs)
        if not transpose:
            if not symmetric:
                x = F.pad(x, _torch_pad(pairs))
            return _CONV[spatial](x, w, b, strides,
                                  [lo for lo, _ in pairs] if symmetric else 0,
                                  dil, group)
        out_pad = attrs["output_padding"] or [0] * spatial
        if symmetric:
            return _CONV_T[spatial](x, w, b, strides, [lo for lo, _ in pairs],
                                    out_pad, group, dil)
        y = _CONV_T[spatial](x, w, b, strides, 0, out_pad, group, dil)
        idx = (slice(None), slice(None)) + tuple(
            slice(lo, y.shape[2 + i] - hi) for i, (lo, hi) in enumerate(pairs))
        return y[idx]
    return run


def _pool(node: OnnxNode, op: str) -> Callable:
    if node.attr("ceil_mode", 0) or node.attr("auto_pad", "NOTSET") not in (
            "NOTSET", "VALID"):
        raise NotImplementedError(f"ONNX {node.op_type} ceil_mode/auto_pad")
    k = tuple(node.attr("kernel_shape"))
    strides = tuple(node.attr("strides", list(k)))
    dil = tuple(node.attr("dilations", [1] * len(k)))
    pairs = _pad_pairs(node.attr("pads", [0] * (2 * len(k))), len(k))
    padded = any(p != (0, 0) for p in pairs)
    if op == "avg" and padded and not node.attr("count_include_pad", 0):
        raise NotImplementedError("ONNX AveragePool with pads left out of "
                                  "the count")
    fn = {("max", 1): F.max_pool1d, ("max", 2): F.max_pool2d,
          ("max", 3): F.max_pool3d, ("avg", 1): F.avg_pool1d,
          ("avg", 2): F.avg_pool2d, ("avg", 3): F.avg_pool3d}[op, len(k)]

    def run(x):
        if padded:
            x = F.pad(x, _torch_pad(pairs),
                      value=-math.inf if op == "max" else 0.0)
        if op == "max":
            return fn(x, k, strides, 0, dil)
        return fn(x, k, strides)
    return run


def _slice_index(shape, starts, ends, axes, steps):
    """(axis, range of kept indices) per sliced axis, clamped as ONNX
    clamps (python's slice rules are the same)."""
    return [(a % len(shape), range(*slice(s, e, st).indices(shape[a])))
            for s, e, a, st in zip(starts, ends, axes, steps)]


def _slice(x, parts):
    for axis, r in parts:
        if len(r) == 0:
            x = x.narrow(axis, 0, 0)
        elif r.step == 1:
            x = x.narrow(axis, r.start, len(r))
        elif r.step > 0:
            x = x.narrow(axis, r.start, r[-1] - r.start + 1)[
                (slice(None),) * axis + (slice(None, None, r.step),)]
        else:   # flip the covered span, then step through it
            x = x.narrow(axis, r[-1], r[0] - r[-1] + 1).flip(axis)
            if r.step != -1:
                x = x[(slice(None),) * axis + (slice(None, None, -r.step),)]
    return x


def _reshape(x, shape, allowzero: bool):
    if not allowzero:
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


def _scatter_nd(data, idx, upd, reduction):
    if reduction not in (None, "none", "add"):
        raise NotImplementedError(f"ONNX ScatterND reduction {reduction}")
    loc = tuple(idx.long().unbind(-1))
    return data.clone().index_put_(loc, upd.to(data.dtype),
                                   accumulate=reduction == "add")


def _gather(x, idx, axis: int):
    axis %= x.dim()
    idx = idx.long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _cumsum(x, axis: int, exclusive: bool, reverse: bool):
    if reverse:
        x = x.flip(axis)
    y = torch.cumsum(x, axis)
    if exclusive:
        y = y - x
    return y.flip(axis) if reverse else y


def _resize(node: OnnxNode) -> Callable:
    mode = node.attr("mode", "nearest")
    ctm = node.attr("coordinate_transformation_mode", "half_pixel")
    if ctm not in ("half_pixel", "pytorch_half_pixel", "asymmetric",
                   "align_corners"):
        raise NotImplementedError(f"ONNX Resize coordinate mode {ctm}")

    def run(x, roi=None, scales=None, sizes=None):
        if scales is not None and len(scales):
            sizes = [int(round(d * s)) for d, s in zip(x.shape, scales)]
        sizes = [int(s) for s in sizes]
        if list(sizes[:2]) != list(x.shape[:2]):
            raise NotImplementedError("ONNX Resize over batch or channels")
        spatial = x.dim() - 2
        if mode == "nearest":
            m = "nearest" if ctm == "asymmetric" else "nearest-exact"
            return F.interpolate(x, size=sizes[2:], mode=m)
        if mode != "linear":
            raise NotImplementedError(f"ONNX Resize mode {mode}")
        return F.interpolate(x, size=sizes[2:], mode=_INTERP[spatial],
                             align_corners=ctm == "align_corners")
    return run


def _reduce(node: OnnxNode, op: str) -> Callable:
    axes_attr = node.attr("axes")
    keep = bool(node.attr("keepdims", 1))
    noop = bool(node.attr("noop_with_empty_axes", 0))

    def run(x, axes=None):
        axes = axes_attr if axes_attr is not None else (
            None if axes is None else _ints(axes))
        if not axes:
            if noop:
                return x
            axes = list(range(x.dim()))
        dims = sorted(a % x.dim() for a in axes)
        if op == "ReduceProd":
            for d in reversed(dims):
                x = torch.prod(x, d, keepdim=keep)
            return x
        return _REDUCE[op](x, dim=dims, keepdim=keep)
    return run


def _compile(node: OnnxNode) -> Callable:
    """The node's function of its inputs, its attributes parsed now."""
    op = node.op_type
    a = node.attr
    if op == "Conv":
        return _conv(node, False)
    if op == "ConvTranspose":
        return _conv(node, True)
    if op == "BatchNormalization":
        eps = float(a("epsilon", 1e-5))
        return lambda x, g, b, mean, var, *_: F.batch_norm(
            x, mean, var, g, b, False, 0.0, eps)
    if op == "InstanceNormalization":
        eps = float(a("epsilon", 1e-5))
        return lambda x, g, b: F.instance_norm(x, weight=g, bias=b, eps=eps)
    if op == "GroupNormalization":
        eps, ng = float(a("epsilon", 1e-5)), int(a("num_groups"))

        def group_norm(x, g, b):
            C = x.shape[1]
            if g.numel() != C:   # opset 18: a scale per group
                g, b = (t.repeat_interleave(C // ng) for t in (g, b))
            return F.group_norm(x, ng, g, b, eps)
        return group_norm
    if op == "LeakyRelu":
        alpha = float(a("alpha", 0.01))
        return lambda x: F.leaky_relu(x, alpha)
    if op == "Elu":
        alpha = float(a("alpha", 1.0))
        return lambda x: F.elu(x, alpha)
    if op == "Gelu":
        approx = a("approximate", "none")
        return lambda x: F.gelu(x, approximate=approx)
    if op == "Clip":
        lo_attr, hi_attr = a("min"), a("max")

        def clip(x, lo=None, hi=None):
            lo = lo if lo is not None else lo_attr
            hi = hi if hi is not None else hi_attr
            return torch.clamp(x, lo, hi)
        return clip
    if op == "Div":
        def div(x, y):
            if not (x.is_floating_point() or y.is_floating_point()):
                return torch.div(x, y, rounding_mode="trunc")
            return x / y
        return div
    if op in ("Max", "Min"):
        f = torch.maximum if op == "Max" else torch.minimum

        def fold(*xs):
            y = xs[0]
            for x in xs[1:]:
                y = f(y, x)
            return y
        return fold
    if op in _UNARY:
        return _UNARY[op]
    if op in _BINARY:
        return _BINARY[op]
    if op == "Gemm":
        alpha, beta = float(a("alpha", 1.0)), float(a("beta", 1.0))
        ta, tb = bool(a("transA", 0)), bool(a("transB", 0))

        def gemm(x, w, c=None):
            y = (x.t() if ta else x) @ (w.t() if tb else w)
            if alpha != 1.0:
                y = alpha * y
            if c is not None:
                y = y + (c if beta == 1.0 else beta * c)
            return y
        return gemm
    if op == "Concat":
        axis = int(a("axis"))
        return lambda *xs: torch.cat([x for x in xs if x is not None], axis)
    if op == "Reshape":
        allowzero = bool(a("allowzero", 0))
        return lambda x, shape: _reshape(x, _ints(shape), allowzero)
    if op == "Transpose":
        perm = a("perm")
        return lambda x: x.permute(perm if perm is not None
                                   else list(range(x.dim()))[::-1])
    if op == "Unsqueeze":
        axes_attr = a("axes")

        def unsqueeze(x, axes=None):
            axes = axes_attr if axes_attr is not None else _ints(axes)
            rank = x.dim() + len(axes)
            for ax in sorted(ax % rank for ax in axes):
                x = x.unsqueeze(ax)
            return x
        return unsqueeze
    if op == "Squeeze":
        axes_attr = a("axes")

        def squeeze(x, axes=None):
            axes = axes_attr if axes_attr is not None else (
                None if axes is None else _ints(axes))
            if not axes:
                return x.squeeze()
            return x.squeeze(tuple(ax % x.dim() for ax in axes))
        return squeeze
    if op == "Slice":
        def slice_(x, starts, ends, axes=None, steps=None):
            starts, ends = _ints(starts), _ints(ends)
            axes = (_ints(axes) if axes is not None
                    else list(range(len(starts))))
            steps = _ints(steps) if steps is not None else [1] * len(starts)
            return _slice(x, _slice_index(x.shape, starts, ends, axes, steps))
        return slice_
    if op == "Pad":
        if a("mode", "constant") != "constant":
            raise NotImplementedError(f"ONNX Pad mode {a('mode')}")
        pads_attr = a("pads")

        def pad(x, pads=None, value=None, axes=None):
            if axes is not None:
                raise NotImplementedError("ONNX Pad axes input")
            pads = _ints(pads) if pads is not None else list(pads_attr)
            n = x.dim()
            v = 0.0 if value is None else float(np.asarray(value))
            return F.pad(x, _torch_pad([(pads[i], pads[i + n])
                                        for i in range(n)]), value=v)
        return pad
    if op == "MaxPool":
        return _pool(node, "max")
    if op == "AveragePool":
        return _pool(node, "avg")
    if op == "GlobalAveragePool":
        return lambda x: x.mean(dim=tuple(range(2, x.dim())), keepdim=True)
    if op == "Softmax":
        axis = int(a("axis", -1))
        return lambda x: torch.softmax(x, axis)
    if op == "Where":
        return torch.where
    if op == "Cast":
        dt = _TORCH_DTYPE[np.dtype(DTYPE[int(a("to"))])]
        return lambda x: x.to(dt)
    if op == "Expand":
        return lambda x, shape: x.expand(torch.broadcast_shapes(
            tuple(x.shape), tuple(_ints(shape))))
    if op == "Einsum":
        eq = a("equation")
        return lambda *xs: torch.einsum(eq, *xs)
    if op == "CumSum":
        excl, rev = bool(a("exclusive", 0)), bool(a("reverse", 0))
        return lambda x, axis: _cumsum(x, _ints(axis)[0], excl, rev)
    if op == "Mod":
        f = torch.fmod if a("fmod", 0) else torch.remainder
        return f
    if op == "Gather":
        axis = int(a("axis", 0))
        return lambda x, idx: _gather(x, idx, axis)
    if op == "GatherND":
        if int(a("batch_dims", 0)) != 0:
            raise NotImplementedError("ONNX GatherND batch_dims")
        return lambda x, idx: x[tuple(idx.long().unbind(-1))]
    if op == "ScatterND":
        red = a("reduction", "none")
        return lambda data, idx, upd: _scatter_nd(data, idx, upd, red)
    if op == "Split":
        axis, sizes_attr = int(a("axis", 0)), a("split")
        n_out = len(node.outputs)

        def split(x, sizes=None):
            sizes = sizes_attr if sizes_attr is not None else (
                None if sizes is None else _ints(sizes))
            if sizes is None:
                return list(torch.chunk(x, n_out, axis))
            return list(torch.split(x, sizes, axis))
        return split
    if op in ("ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd",
              "ReduceMean"):
        return _reduce(node, op)
    if op in ("ArgMax", "ArgMin"):
        if a("select_last_index", 0):
            raise NotImplementedError(f"ONNX {op} select_last_index")
        axis, keep = int(a("axis", 0)), bool(a("keepdims", 1))
        f = torch.argmax if op == "ArgMax" else torch.argmin
        return lambda x: f(x, axis, keepdim=keep)
    if op == "Flatten":
        ax = int(a("axis", 1))
        return lambda x: x.reshape(int(np.prod(x.shape[:ax])), -1)
    if op == "Tile":
        return lambda x, reps: x.repeat(_ints(reps))
    if op == "Resize":
        return _resize(node)
    if op == "Shape":
        # host integers: a structural consumer reads them without a device
        # round trip, any other gets them uploaded
        start, end = a("start"), a("end")
        return lambda x: np.asarray(x.shape[start:end], np.int64)
    if op == "Range":
        def range_(start, limit, delta):
            start, limit, delta = (np.asarray(v).reshape(())
                                   for v in (start, limit, delta))
            return np.arange(start, limit, delta, dtype=start.dtype)
        return range_
    raise NotImplementedError(f"ONNX op not supported: {op}")


class OnnxModule:
    """An executable ONNX graph on one device: module(*inputs) -> the
    output tensor, or a list of them.  Inputs may be numpy arrays or
    tensors, positionally in the graph's input order or by name."""

    def __init__(self, graph: OnnxGraph, device=None):
        self.graph = graph
        self.device = resolve_device(device)
        structural = set()
        for node in graph.nodes:
            for i in _STRUCTURAL.get(node.op_type, ()):
                if i < len(node.inputs) and node.inputs[i]:
                    structural.add(node.inputs[i])
        self.params: Dict[str, Any] = {}
        for k, v in graph.initializers.items():
            self.params[k] = (np.asarray(v) if k in structural
                              else self._to_device(v))
        self._plan = []
        for node in graph.nodes:
            if node.op_type == "Constant":
                val = _constant_value(node)
                self.params[node.outputs[0]] = (
                    val if node.outputs[0] in structural
                    else self._to_device(val))
                continue
            host = set(_STRUCTURAL.get(node.op_type, ()))
            self._plan.append([_compile(node), node.inputs, node.outputs,
                               host, ()])
        # each value is dropped after the node that reads it last: a
        # full-width decoder keeps gigabytes of intermediates otherwise
        last = {}
        for i, step in enumerate(self._plan):
            for name in step[1]:
                last[name] = i
        for name in graph.outputs:
            last.pop(name, None)
        for i, step in enumerate(self._plan):
            step[4] = tuple({n for n in step[1] if n and last.get(n) == i})

    @classmethod
    def from_file(cls, path: str, device=None) -> "OnnxModule":
        return cls(load_onnx(path), device)

    def _to_device(self, v) -> torch.Tensor:
        if torch.is_tensor(v):
            return v.to(self.device)
        arr = np.ascontiguousarray(v)
        if not arr.flags.writeable:   # a view of the file's bytes
            arr = arr.copy()
        return torch.as_tensor(arr,
                               dtype=_TORCH_DTYPE[arr.dtype],
                               device=self.device)

    @torch.no_grad()
    @fp32_math()
    def __call__(self, *args, **named):
        env: Dict[str, Any] = dict(self.params)
        for name, val in zip(self.graph.inputs, args):
            env[name] = self._to_device(val)
        for name, val in named.items():
            env[name] = self._to_device(val)
        for fn, inputs, outputs, host, done in self._plan:
            ins = []
            for i, name in enumerate(inputs):
                v = env[name] if name else None
                if i in host:
                    if torch.is_tensor(v):   # computed in the graph
                        v = v.cpu().numpy()
                elif isinstance(v, np.ndarray):
                    v = self._to_device(v)
                ins.append(v)
            out = fn(*ins)
            if isinstance(out, (list, tuple)):
                env.update(zip(outputs, out))
            else:
                env[outputs[0]] = out
            for name in done:
                del env[name]
        outs = [env[o] for o in self.graph.outputs]
        outs = [self._to_device(o) if isinstance(o, np.ndarray) else o
                for o in outs]
        return outs[0] if len(outs) == 1 else outs


def _constant_value(node: OnnxNode) -> np.ndarray:
    if node.attr("value") is None:
        raise NotImplementedError(f"ONNX Constant attributes "
                                  f"{list(node.attrs)}")
    return np.asarray(node.attr("value"))
