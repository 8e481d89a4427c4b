"""MDX-Net dereverb/separation (port of tpu_rvc/pipeline/mdxnet.py;
reference infer/modules/uvr5/mdxnet.py).

The Conv-TDF model arrives as an ONNX graph (onnx_dereverb_By_FoxJoy) and
runs on the port's ONNX executor (`models/onnx_exec.py`) on the device,
in place of onnxruntime.  Around it, as the reference:

  - the stereo STFT packed as (B, 4, dim_f, dim_t), real/imag x L/R
    (ConvTDFNetTrim.stft, mdxnet.py:42);
  - the chunked demix with a `margin` of overlap (demix, mdxnet.py:108);
  - the denoise pass 0.5 * (f(x) - f(-x)) (mdxnet.py:166-170);
  - n_fft // 2 trimmed from each window's edges, the rest concatenated.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rvc_torch.audio.io import load_audio, save_wav
from tpu_rvc_torch.core.device import fp32_math, resolve_device
from tpu_rvc_torch.ops.stft import istft as _istft, stft as _stft
from tpu_rvc_torch.utils.timing import span


class ConvTDFSpec:
    """STFT <-> packed-spectrogram transforms (ConvTDFNetTrim's role)."""

    def __init__(self, dim_f: int = 3072, dim_t: int = 9, n_fft: int = 6144,
                 hop: int = 1024):
        self.dim_f = dim_f
        self.dim_t = 2 ** dim_t
        self.n_fft = n_fft
        self.hop = hop
        self.n_bins = n_fft // 2 + 1
        self.chunk_size = hop * (self.dim_t - 1)
        self.trim = n_fft // 2

    def stft(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 2, chunk_size) -> (B, 4, dim_f, dim_t)."""
        B = x.shape[0]
        flat = x.reshape(-1, 1, self.chunk_size)
        pad = self.n_fft // 2
        xp = F.pad(flat, (pad, pad), mode="reflect")[:, 0]
        spec = _stft(xp, self.n_fft, self.hop)  # (B*2, n_bins, dim_t)
        ri = torch.stack([spec.real, spec.imag], dim=1)  # (B*2, 2, F, T)
        return ri.reshape(B, 4, self.n_bins, self.dim_t)[:, :, :self.dim_f]

    def istft(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 4, dim_f, dim_t) -> (B, 2, chunk_size)."""
        B = x.shape[0]
        x = F.pad(x, (0, 0, 0, self.n_bins - self.dim_f))
        ri = x.reshape(B * 2, 2, self.n_bins, self.dim_t)
        y = _istft(torch.complex(ri[:, 0], ri[:, 1]), self.n_fft, self.hop)
        pad = self.n_fft // 2
        return y[:, pad: pad + self.chunk_size].reshape(B, 2,
                                                        self.chunk_size)


class MDXPredictor:
    """The chunked demix (reference Predictor, mdxnet.py:90).
    `model_fn` maps a (B, 4, dim_f, dim_t) tensor on `device` to one of the
    same shape."""

    def __init__(self, model_fn: Callable, spec: ConvTDFSpec,
                 chunks: int = 15, margin: int = 44100,
                 denoise: bool = True, device=None):
        self.model_fn = model_fn
        self.spec = spec
        self.chunks = chunks
        self.margin = margin
        self.denoise = denoise
        self.device = resolve_device(device)

    def _run_window(self, waves: torch.Tensor) -> torch.Tensor:
        spek = self.spec.stft(waves)
        with span("net", self.device):
            if self.denoise:
                pred = (-self.model_fn(-spek) * 0.5
                        + self.model_fn(spek) * 0.5)
            else:
                pred = self.model_fn(spek)
        return self.spec.istft(pred)

    def demix_base(self, mixes: Dict[int, np.ndarray],
                   margin_size: int) -> np.ndarray:
        chunked = []
        keys = list(mixes)
        trim = self.spec.trim
        gen_size = self.spec.chunk_size - 2 * trim
        for mix_key in keys:
            cmix = mixes[mix_key]
            n_sample = cmix.shape[1]
            pad = gen_size - n_sample % gen_size
            mix_p = np.concatenate(
                (np.zeros((2, trim), np.float32), cmix.astype(np.float32),
                 np.zeros((2, pad), np.float32),
                 np.zeros((2, trim), np.float32)), axis=1)
            waves = [mix_p[:, i: i + self.spec.chunk_size]
                     for i in range(0, n_sample + pad, gen_size)]
            batch = torch.from_numpy(np.stack(waves)).to(self.device)
            tar = self._run_window(batch).cpu().numpy()  # (B, 2, chunk)
            tar_signal = tar[:, :, trim:-trim].transpose(1, 0, 2).reshape(
                2, -1)[:, :-pad]
            start = 0 if mix_key == 0 else margin_size
            end = None if mix_key == keys[-1] else -margin_size
            if margin_size == 0:
                end = None
            chunked.append(tar_signal[:, start:end])
        return np.concatenate(chunked, axis=-1)[None]

    @torch.no_grad()
    @fp32_math()
    def demix(self, mix: np.ndarray) -> np.ndarray:
        """(2, T) float -> (1, 2, T) float32, the model's source."""
        samples = mix.shape[-1]
        margin = self.margin
        chunk_size = self.chunks * 44100
        if margin == 0:
            raise ValueError("margin cannot be zero")
        if margin > chunk_size:
            margin = chunk_size
        if self.chunks == 0 or samples < chunk_size:
            chunk_size = samples
        segmented = {}
        counter = -1
        for skip in range(0, samples, chunk_size):
            counter += 1
            s_margin = 0 if counter == 0 else margin
            end = min(skip + chunk_size + margin, samples)
            segmented[skip] = mix[:, skip - s_margin: end].copy()
            if end == samples:
                break
        return self.demix_base(segmented, margin_size=margin)


class MDXNetDereverb:
    """Facade (reference MDXNetDereverb, mdxnet.py:225): `onnx_dir` holds
    `vocals.onnx`; `model_fn` replaces the graph."""

    def __init__(self, onnx_dir: str =
                 "assets/uvr5_weights/onnx_dereverb_By_FoxJoy",
                 chunks: int = 15, model_fn: Optional[Callable] = None,
                 device=None):
        dev = resolve_device(device)
        spec = ConvTDFSpec(dim_f=3072, dim_t=9, n_fft=6144)
        if model_fn is None:
            from tpu_rvc_torch.models.onnx_exec import OnnxModule
            path = os.path.join(onnx_dir, "vocals.onnx")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"MDX model not found at {path}; the "
                    "onnx_dereverb_By_FoxJoy asset is not in the repository")
            model_fn = OnnxModule.from_file(path, device=dev)
        self.pred = MDXPredictor(model_fn, spec, chunks=chunks,
                                 margin=44100, denoise=True, device=dev)

    def _path_audio_(self, input_path: str, vocal_root: str,
                     others_root: str) -> None:
        """Write `vocal_<name>.wav` (the mix less the model's source) and
        `instrument_<name>.wav` (the source) at 44.1 kHz."""
        os.makedirs(vocal_root, exist_ok=True)
        os.makedirs(others_root, exist_ok=True)
        basename = os.path.basename(input_path)
        mono = load_audio(input_path, 44100)   # downmixed
        mix = np.stack([mono, mono])
        opt = self.pred.demix(mix)[0]
        save_wav(os.path.join(vocal_root, f"vocal_{basename}.wav"),
                 (mix - opt).T, 44100)
        save_wav(os.path.join(others_root, f"instrument_{basename}.wav"),
                 opt.T, 44100)


def conv_tdf_onnx(dim_f: int = 3072, dim_t_frames: int = 512, c: int = 32,
                  seed: int = 0) -> bytes:
    """A random-weight Conv-TDF U-net as ONNX bytes, for runs without the
    published `vocals.onnx`: its I/O dims (4, dim_f, dim_t_frames) and its
    op inventory (Conv, BatchNormalization, Relu, the TDF blocks' MatMul and
    Add over the frequency axis, ConvTranspose, Concat, Transpose), with
    `c` channels at the first level."""
    from tpu_rvc_torch.ckpt.onnx_reader import encode_model, encode_node

    rng = np.random.RandomState(seed)
    nodes, inits = [], {}

    def const(arr):
        name = f"w{len(inits)}"
        inits[name] = np.asarray(arr, np.float32)
        return name

    def node(op, inputs, out=None, **attrs):
        out = out or f"v{len(nodes)}"
        nodes.append(encode_node(op, inputs, [out], **attrs))
        return out

    def conv(x, cin, cout, stride=1):
        w = const(rng.randn(cout, cin, 3, 3) * np.sqrt(2.0 / (9 * cin)))
        return node("Conv", [x, w, const(np.zeros(cout))],
                    strides=[stride, stride], pads=[1, 1, 1, 1])

    def bn_relu(x, ch):
        y = node("BatchNormalization",
                 [x, const(rng.uniform(0.5, 1.5, ch)),
                  const(0.1 * rng.randn(ch)), const(0.1 * rng.randn(ch)),
                  const(rng.uniform(0.5, 1.5, ch))], epsilon=1e-5)
        return node("Relu", [y])

    def tdf(x, f):
        """Linear f -> f/16 -> f over the frequency axis, residual."""
        t = node("Transpose", [x], perm=[0, 1, 3, 2])    # (B, C, T, F)
        h = node("MatMul", [t, const(rng.randn(f, f // 16) / np.sqrt(f))])
        h = node("Relu", [node("Add", [h, const(np.zeros(f // 16))])])
        h = node("MatMul", [h, const(rng.randn(f // 16, f)
                                     / np.sqrt(f // 16))])
        h = node("Add", [node("Add", [h, const(np.zeros(f))]), t])
        return node("Transpose", [h], perm=[0, 1, 3, 2])

    e1 = tdf(bn_relu(conv("input", 4, c), c), dim_f)
    d1 = tdf(bn_relu(conv(e1, c, 2 * c, stride=2), 2 * c), dim_f // 2)
    mid = bn_relu(conv(d1, 2 * c, 2 * c), 2 * c)
    up = node("ConvTranspose", [mid, const(rng.randn(2 * c, c, 2, 2)
                                           / np.sqrt(8 * c))],
              strides=[2, 2])
    cat = node("Concat", [bn_relu(up, c), e1], axis=1)
    node("Identity", [conv(cat, 2 * c, 4)], out="output")
    shape = (1, 4, dim_f, dim_t_frames)
    return encode_model(nodes, inits, [("input", 1, shape)],
                        [("output", 1, shape)])
