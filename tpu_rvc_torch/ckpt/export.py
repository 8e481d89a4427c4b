"""Ahead-of-time model export (port of tpu_rvc/ckpt/export.py; reference
rvc/jit/ TorchScript export, C46, and rvc/onnx/ exporter, C47).

The JAX package serializes the jitted inference graph as StableHLO; the
port's counterpart is `torch.export` of `Synthesizer.infer` at a static
frame count, saved as a `.pt2` with `torch.export.save` and a metadata
record that mirrors the JAX payload (format `tpu_rvc_torch.pt2.v1`, the
device it was traced on, T, use_f0).  The graph holds the plain PyTorch
path, as the JAX export holds XLA's: the attention and the resblock stages
trace their modules, not the CUDA kernels (`nn/generators.py`).  The prior
noise is an input, where the JAX export takes a PRNG key.

A program traced on one device carries that device in its constants;
`load_exported` moves it to the device it is asked for
(`torch.export.passes.move_to_device_pass`).

`export_onnx` reads a small model and writes ONNX through
`ckpt/torch2onnx.py`.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import torch
from torch import nn

from tpu_rvc_torch.core.device import fp32_math, resolve_device

FORMAT = "tpu_rvc_torch.pt2.v1"
_META = "tpu_rvc_torch.json"


class _Infer(nn.Module):
    def __init__(self, synth, noise_scale: float, deterministic: bool):
        super().__init__()
        self.synth = synth
        self.noise_scale, self.deterministic = noise_scale, deterministic

    def forward(self, phone, lengths, sid, *rest):
        *f0, noise = rest
        pitch, pitchf = f0 if f0 else (None, None)
        return self.synth.infer(phone, lengths, sid, pitch, pitchf,
                                noise=noise, noise_scale=self.noise_scale,
                                deterministic=self.deterministic)


def export_synthesizer(synth, T: int = 200, noise_scale: float = 0.66666,
                       deterministic: bool = False):
    """torch.export of `synth.infer` on the synthesizer's device at T
    frames: (phone (1, T, D), lengths (1,), sid (1,), [pitch (1, T),
    pitchf (1, T),] noise (1, T, C)) -> audio (1, T * hop, 1).
    deterministic=True zeroes the source's noise, as `infer`'s flag."""
    dev = synth.emb_g.weight.device
    D = synth.enc_p.emb_phone.in_features
    C = synth.enc_p.out_channels
    i64 = dict(dtype=torch.int64, device=dev)
    args = [torch.zeros(1, T, D, device=dev), torch.full((1,), T, **i64),
            torch.zeros(1, **i64)]
    if synth.use_f0:
        args += [torch.ones(1, T, **i64), torch.full((1, T), 100.0,
                                                    device=dev)]
    args.append(torch.zeros(1, T, C, device=dev))
    return torch.export.export(_Infer(synth.eval(), noise_scale,
                                      deterministic), tuple(args))


def save_exported(synth, path: str, T: int = 200,
                  noise_scale: float = 0.66666,
                  deterministic: bool = False) -> str:
    """Export (`export_synthesizer`) and write a `.pt2` with its metadata."""
    program = export_synthesizer(synth, T, noise_scale, deterministic)
    meta = {"format": FORMAT,
            "device": synth.emb_g.weight.device.type, "T": int(T),
            "use_f0": bool(synth.use_f0), "noise_scale": float(noise_scale),
            "deterministic": bool(deterministic)}
    torch.export.save(program, path, extra_files={_META: json.dumps(meta)})
    return path


class LoadedExport:
    """A callable rehydrated from a `.pt2` (no retracing): (phone, lengths,
    sid, [pitch, pitchf,] noise) -> audio, on `device`."""

    def __init__(self, program, meta: Dict[str, Any], device):
        from torch.export.passes import move_to_device_pass

        self.meta = meta
        self.device = device
        self.program = move_to_device_pass(program, device)
        self._fn = self.program.module()

    @torch.no_grad()
    @fp32_math()
    def __call__(self, *args):
        # the traced graph holds no backend flags: TF32 stays off here
        return self._fn(*args)


def load_exported(path: str, device=None) -> LoadedExport:
    """Read a `.pt2` written by `save_exported` onto `device` (CUDA unless
    named).  ValueError for any other file."""
    dev = resolve_device(device)
    extra = {_META: ""}
    try:
        program = torch.export.load(path, extra_files=extra)
        meta = json.loads(extra[_META] or "{}")
    except Exception as e:
        raise ValueError(f"{path}: not a tpu_rvc_torch export ({e})") from e
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a tpu_rvc_torch export")
    return LoadedExport(program, meta, dev)


def export_onnx(model_path: str, out_path: str, T: int = 200,
                spk_mix: bool = False, reference_layout: bool = False,
                device=None) -> str:
    """A small model `.pth` -> ONNX (reference rvc/onnx/exporter.py:6;
    tpu_rvc/ckpt/export.py:96): opset 17, the reference's I/O contract,
    static at T frames (`torch2onnx.export_synthesizer_onnx`).  The
    model is loaded and traced on `device`, CUDA unless named."""
    from tpu_rvc_torch.ckpt.torch2onnx import export_synthesizer_onnx
    from tpu_rvc_torch.models.loader import load_synthesizer

    synth, _meta = load_synthesizer(model_path, device)
    export_synthesizer_onnx(synth, T=T, path=out_path, spk_mix=spk_mix,
                            reference_layout=reference_layout)
    return "Finished"
