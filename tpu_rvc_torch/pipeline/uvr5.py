"""UVR5 vocal/instrument separation (port of tpu_rvc/pipeline/uvr5.py;
reference infer/modules/uvr5/vr.py `AudioPre` with lib_v5/spec_utils.py).

Flow: per band of the model's parameter file (a multirate pyramid) resample
and STFT, combine into one stacked spectrogram, run the net over
normalized sliding windows (TTA adds a second pass shifted by half a
window), apply the mask, then per band lp/hp filters, iSTFT, the mirrored
high-end restore and the upsample-sum.

Two separators compute it.  `UVR5Separator` keeps the band pyramid and
the spectra on the host in numpy, with each STFT and each window of the
net on its device.  `DeviceSeparator` runs the whole flow on the device:
one upload and two int16 fetches a file.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rvc_torch.audio.io import load_audio
from tpu_rvc_torch.core.device import (cudnn_autotune, fp32_math,
                                       resolve_device)
from tpu_rvc_torch.ops.resample import resample_poly
from tpu_rvc_torch.ops.stft import istft, stft
from tpu_rvc_torch.utils.timing import count, span

PARAMS_DIR = Path(__file__).parent.parent / "assets" / "uvr5_params"


class ModelParameters:
    """Band-pyramid parameters (reference model_param_init.py): a path, or
    the name of a file of the port's `assets/uvr5_params/`."""

    def __init__(self, config_path: str = "4band_v2.json"):
        p = Path(config_path)
        if not p.exists():
            p = PARAMS_DIR / config_path

        def int_keys(pairs):
            return {int(k) if isinstance(k, str) and k.isdigit() else k: v
                    for k, v in pairs}
        self.param = json.loads(p.read_text(), object_pairs_hook=int_keys)
        for k in ("mid_side", "mid_side_b", "mid_side_b2", "stereo_w",
                  "stereo_n", "reverse"):
            self.param.setdefault(k, False)


def _stft_stereo(wave: np.ndarray, n_fft: int, hop: int,
                 device: torch.device) -> np.ndarray:
    """(2, T) -> (2, F, frames) complex64, centred frames (librosa.stft
    center=True), computed on `device`."""
    pad = n_fft // 2
    w = np.pad(wave, ((0, 0), (pad, pad)), mode="reflect")
    spec = stft(torch.from_numpy(np.ascontiguousarray(w, np.float32))
                .to(device), n_fft, hop)
    return spec.cpu().numpy()


def _istft_stereo(spec: np.ndarray, hop: int,
                  device: torch.device) -> np.ndarray:
    """(2, F, frames) complex -> (2, T) float32, computed on `device`."""
    n_fft = (spec.shape[1] - 1) * 2
    y = istft(torch.from_numpy(np.asarray(spec, np.complex64)).to(device),
              n_fft, hop).cpu().numpy()
    pad = n_fft // 2
    return y[:, pad:-pad]


def _resample(wave: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    from scipy.signal import resample_poly as scipy_resample_poly
    g = math.gcd(sr_from, sr_to)
    return scipy_resample_poly(wave, sr_to // g, sr_from // g,
                               axis=-1).astype(np.float32)


def fft_lp_filter(spec, start, stop):
    g = 1.0
    spec = spec.copy()
    for b in range(start, stop):
        g -= 1 / (stop - start)
        spec[:, b, :] = g * spec[:, b, :]
    spec[:, stop:, :] *= 0
    return spec


def fft_hp_filter(spec, start, stop):
    g = 1.0
    spec = spec.copy()
    for b in range(start, stop, -1):
        g -= 1 / (start - stop)
        spec[:, b, :] = g * spec[:, b, :]
    spec[:, 0:stop + 1, :] *= 0
    return spec


def _pre_filter_gain(p: dict) -> np.ndarray:
    """The combined spectrogram's pre-filter as a per-bin gain: an lp
    filter for a single band, a dB ramp for several
    (tpu_rvc/pipeline/uvr5.py:120-130)."""
    F_all = p["bins"] + 1
    start, stop = p["pre_filter_start"], p["pre_filter_stop"]
    gain = np.ones(F_all, np.float32)
    if start > 0 and len(p["band"]) == 1:
        return _lp_gain(F_all, start, stop)
    if start > 0:
        gp = 1.0
        for b in range(start + 1, stop):
            gp = gain[b] = 10 ** (-(b - start) * (3.5 - gp) / 20.0)
    return gain


def combine_spectrograms(specs: Dict[int, np.ndarray], mp: ModelParameters
                         ) -> np.ndarray:
    l = min(specs[i].shape[2] for i in specs)
    out = np.zeros((2, mp.param["bins"] + 1, l), np.complex64)
    offset = 0
    bands_n = len(mp.param["band"])
    for d in range(1, bands_n + 1):
        bp = mp.param["band"][d]
        h = bp["crop_stop"] - bp["crop_start"]
        out[:, offset:offset + h, :l] = \
            specs[d][:, bp["crop_start"]:bp["crop_stop"], :l]
        offset += h
    return out * _pre_filter_gain(mp.param)[None, :, None]


def mirroring(mode: str, spec_m: np.ndarray, input_high_end: np.ndarray,
              pre_filter_start: int) -> np.ndarray:
    mirror = np.flip(np.abs(
        spec_m[:, pre_filter_start - 10 - input_high_end.shape[1]:
               pre_filter_start - 10, :]), 1)
    if mode == "mirroring":
        mirror = mirror * np.exp(1.0j * np.angle(input_high_end))
        return np.where(np.abs(input_high_end) <= np.abs(mirror),
                        input_high_end, mirror)
    mi = np.multiply(mirror, input_high_end * 1.7)
    return np.where(np.abs(input_high_end) <= np.abs(mi), input_high_end, mi)


def cmb_spectrogram_to_wave(spec_m: np.ndarray, mp: ModelParameters,
                            device: torch.device,
                            extra_bins_h: Optional[int] = None,
                            extra_bins: Optional[np.ndarray] = None
                            ) -> np.ndarray:
    """The combined spectrogram back to a (T, 2) wave: per band the crop,
    its filters and an iSTFT on `device`, summed up the pyramid."""
    bands_n = len(mp.param["band"])
    offset = 0
    wave = None
    for d in range(1, bands_n + 1):
        bp = mp.param["band"][d]
        spec_s = np.zeros((2, bp["n_fft"] // 2 + 1, spec_m.shape[2]),
                          np.complex64)
        h = bp["crop_stop"] - bp["crop_start"]
        spec_s[:, bp["crop_start"]:bp["crop_stop"]] = \
            spec_m[:, offset:offset + h]
        offset += h
        if d == bands_n:  # highest band
            if extra_bins_h:
                max_bin = bp["n_fft"] // 2
                spec_s[:, max_bin - extra_bins_h:max_bin] = \
                    extra_bins[:, :extra_bins_h]
            if bp.get("hpf_start", 0) > 0:
                spec_s = fft_hp_filter(spec_s, bp["hpf_start"],
                                       bp["hpf_stop"] - 1)
            band_wave = _istft_stereo(spec_s, bp["hl"], device)
            wave = band_wave if bands_n == 1 else wave + band_wave
        else:
            sr_next = mp.param["band"][d + 1]["sr"]
            if d == 1:
                spec_s = fft_lp_filter(spec_s, bp["lpf_start"], bp["lpf_stop"])
                wave = _resample(_istft_stereo(spec_s, bp["hl"], device),
                                 bp["sr"], sr_next)
            else:
                spec_s = fft_hp_filter(spec_s, bp["hpf_start"],
                                       bp["hpf_stop"] - 1)
                spec_s = fft_lp_filter(spec_s, bp["lpf_start"], bp["lpf_stop"])
                band_wave = _istft_stereo(spec_s, bp["hl"], device)
                n = min(band_wave.shape[1], wave.shape[1])
                wave = _resample(wave[:, :n] + band_wave[:, :n],
                                 bp["sr"], sr_next)
    return wave.T  # (T, 2)


def make_padding(width: int, cropsize: int, offset: int):
    left = offset
    roi_size = cropsize - left * 2
    if roi_size == 0:
        roi_size = cropsize
    right = roi_size - (width % roi_size) + left
    return left, right, roi_size


class UVR5Separator:
    """AudioPre's role (reference vr.py:18): load once, separate many.  The
    band pyramid and the spectra stay on the host; each STFT, iSTFT and
    window of the net runs on `device` (default "cuda")."""

    def __init__(self, model: torch.nn.Module, mp: ModelParameters,
                 agg: float = 10.0, tta: bool = False,
                 window_size: int = 512,
                 high_end_process: str = "mirroring",
                 is_reverse: bool = False, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mp = mp
        self.agg = agg
        self.tta = tta
        self.window_size = window_size
        self.high_end_process = high_end_process
        self.is_reverse = is_reverse  # DeEcho models predict the complement

    def _aggressiveness(self) -> Tuple[torch.Tensor, int]:
        """(agg / 100 as a float32 scalar on the device, split bin)."""
        return (torch.tensor(self.agg / 100.0, dtype=torch.float32,
                             device=self.device),
                self.mp.param["band"][1]["crop_stop"])

    def _predict_window(self, window: np.ndarray) -> np.ndarray:
        """(2, F, win) -> the net's (2, F, win - 2 * offset)."""
        x = torch.from_numpy(np.ascontiguousarray(window, np.float32))
        pred = self.model(x[None].to(self.device),
                          self._aggressiveness())[0].cpu().numpy()
        off = self.model.offset
        return pred[:, :, off:-off] if off > 0 else pred

    def _inference(self, spec: np.ndarray) -> Tuple:
        """Sliding-window inference (reference uvr5_pack/utils.py:16)."""
        x_mag = np.abs(spec)
        x_phase = np.angle(spec)
        coef = x_mag.max()
        x_pre = x_mag / max(coef, 1e-8)
        n_frame = x_pre.shape[2]
        pad_l, pad_r, roi = make_padding(n_frame, self.window_size,
                                         self.model.offset)

        def run_pass(pad_l, pad_r, n_window):
            xp = np.pad(x_pre, ((0, 0), (0, 0), (pad_l, pad_r)))
            return np.concatenate(
                [self._predict_window(xp[:, :, i * roi:
                                         i * roi + self.window_size])
                 for i in range(n_window)], axis=2)

        n_window = int(np.ceil(n_frame / roi))
        pred = run_pass(pad_l, pad_r, n_window)[:, :, :n_frame]
        if self.tta:
            pred_tta = run_pass(pad_l + roi // 2, pad_r + roi // 2,
                                n_window + 1)
            pred = (pred + pred_tta[:, :, roi // 2: roi // 2 + n_frame]) * 0.5
        return pred * coef, x_mag, np.exp(1.0j * x_phase)

    @torch.no_grad()
    @fp32_math()
    @cudnn_autotune()
    def separate(self, music_file: str) -> Tuple[np.ndarray, np.ndarray, int]:
        """Returns (instrument (T, 2), vocal (T, 2), sr), float32."""
        p = self.mp.param
        bands_n = len(p["band"])
        x_wave, x_spec = {}, {}
        input_high_end = input_high_end_h = None
        for d in range(bands_n, 0, -1):
            bp = p["band"][d]
            if d == bands_n:
                mono = load_audio(music_file, bp["sr"])  # downmixed
                x_wave[d] = np.stack([mono, mono])
            else:
                x_wave[d] = _resample(x_wave[d + 1], p["band"][d + 1]["sr"],
                                      bp["sr"])
            x_spec[d] = _stft_stereo(x_wave[d], bp["n_fft"], bp["hl"],
                                     self.device)
            if d == bands_n and self.high_end_process != "none":
                input_high_end_h = (bp["n_fft"] // 2 - bp["crop_stop"]) + (
                    p["pre_filter_stop"] - p["pre_filter_start"])
                max_bin = bp["n_fft"] // 2
                input_high_end = x_spec[d][
                    :, max_bin - input_high_end_h: max_bin, :]

        spec_m = combine_spectrograms(x_spec, self.mp)
        pred, x_mag, x_phase = self._inference(spec_m)
        y_spec_m = pred * x_phase        # instruments
        v_spec_m = spec_m - y_spec_m     # vocals

        def to_wave(spec):
            if self.high_end_process.startswith("mirroring"):
                he = mirroring(self.high_end_process, spec, input_high_end,
                               p["pre_filter_start"])
                return cmb_spectrogram_to_wave(spec, self.mp, self.device,
                                               input_high_end_h, he)
            return cmb_spectrogram_to_wave(spec, self.mp, self.device)

        ins = to_wave(y_spec_m)
        voc = to_wave(v_spec_m)
        if self.is_reverse:
            ins, voc = voc, ins
        return ins, voc, p["sr"]


def _lp_gain(n_bins: int, start: int, stop: int) -> np.ndarray:
    """fft_lp_filter as a per-bin gain vector."""
    ones = np.ones((1, n_bins, 1), np.float32)
    return fft_lp_filter(ones, start, stop)[0, :, 0]


def _hp_gain(n_bins: int, start: int, stop: int) -> np.ndarray:
    """fft_hp_filter as a per-bin gain vector."""
    ones = np.ones((1, n_bins, 1), np.float32)
    return fft_hp_filter(ones, start, stop)[0, :, 0]


def _band_gains(p: dict) -> Dict[int, np.ndarray]:
    """Each band's filter on the way back up as one gain vector: the top
    band's hp filter, band 1's lp, the middle bands' hp then lp."""
    bands_n = len(p["band"])
    gains = {}
    for d in range(1, bands_n + 1):
        bp = p["band"][d]
        Fd = bp["n_fft"] // 2 + 1
        gain = np.ones(Fd, np.float32)
        if (d > 1 or bands_n == 1) and bp.get("hpf_start", 0) > 0:
            gain *= _hp_gain(Fd, bp["hpf_start"], bp["hpf_stop"] - 1)
        if d < bands_n:
            gain *= _lp_gain(Fd, bp["lpf_start"], bp["lpf_stop"])
        gains[d] = gain
    return gains


class DeviceSeparator:
    """`UVR5Separator.separate` with the whole flow on the separator's
    device (the counterpart of the JAX package's one-graph separator,
    reference vr.py:51-173 with spec_utils.py): the band resample pyramid,
    the STFTs, the combine and pre-filter, the normalized sliding-window
    net with TTA, the mask, the mirrored high-end restore, the per-band
    gains, the iSTFTs, the upsample-sum and the int16 scaling.  Host I/O
    is one (2, T) float32 upload and two (T, 2) int16 fetches a file.

    The input is zero-padded to a multiple of `bucket_s` seconds, as the
    JAX package pads it for its per-bucket graphs.  The windows go through
    the net `group` at a time: the full-width HP net holds about 0.6 GB of
    activations a 512-frame window, and a 3-minute song has 65 windows."""

    def __init__(self, sep: UVR5Separator, bucket_s: float = 5.0,
                 group: int = 8):
        self.sep = sep
        self.bucket_s = bucket_s
        self.group = group
        p = sep.mp.param
        dev = sep.device
        self._pre = torch.from_numpy(_pre_filter_gain(p)).to(dev)
        self._gains = {d: torch.from_numpy(g).to(dev)
                       for d, g in _band_gains(p).items()}
        self._last_len: Optional[int] = None   # the last call's bucket

    @torch.no_grad()
    @fp32_math()
    @cudnn_autotune()
    def last_graph_flops(self) -> Optional[float]:
        """FLOPs of one `_graph` of the last call's bucket, on zeros
        (`utils/roofline.py`), or None before any call: the MFU numerator
        of a separation."""
        if self._last_len is None:
            return None
        from tpu_rvc_torch.utils.roofline import graph_flops

        return graph_flops(self._graph, torch.zeros(
            (2, self._last_len), device=self.sep.device))

    def _run_net(self, x_pre: torch.Tensor, pad_l: int, pad_r: int,
                 n_win: int, roi: int, aggressiveness) -> torch.Tensor:
        """The net over n_win windows of the padded (2, F, l) input, `group`
        windows a call -> (2, F, n_win * roi), each window's edges cut."""
        sep = self.sep
        win, off = sep.window_size, sep.model.offset
        xp = F.pad(x_pre, (pad_l, pad_r))
        wins = xp.unfold(2, win, roi)[:, :, :n_win].permute(2, 0, 1, 3)
        count("uvr5.windows", n_win)
        outs = []
        for i in range(0, n_win, self.group):
            out = sep.model(wins[i:i + self.group].contiguous(),
                            aggressiveness)
            outs.append(out[:, :, :, off:-off] if off > 0 else out)
        out = torch.cat(outs)                           # (n_win, 2, F, roi)
        return out.permute(1, 2, 0, 3).reshape(*out.shape[1:3], -1)

    def _graph(self, wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        sep = self.sep
        p = sep.mp.param
        dev = sep.device
        bands_n = len(p["band"])
        F_all = p["bins"] + 1
        win, off = sep.window_size, sep.model.offset

        # the band pyramid and its spectra
        w = {bands_n: wav}
        with span("resample", dev):
            for d in range(bands_n - 1, 0, -1):
                w[d] = resample_poly(w[d + 1], p["band"][d + 1]["sr"],
                                     p["band"][d]["sr"])
        specs = {}
        with span("stft", dev):
            for d in range(1, bands_n + 1):
                bp = p["band"][d]
                padw = bp["n_fft"] // 2
                wp = F.pad(w[d][None], (padw, padw), mode="reflect")[0]
                specs[d] = stft(wp, bp["n_fft"], bp["hl"])
        bp_top = p["band"][bands_n]
        he_h = (bp_top["n_fft"] // 2 - bp_top["crop_stop"]) + (
            p["pre_filter_stop"] - p["pre_filter_start"])
        input_high_end = specs[bands_n][
            :, bp_top["n_fft"] // 2 - he_h: bp_top["n_fft"] // 2]

        # combine (static crops) and the pre-filter gains
        l = min(int(s.shape[2]) for s in specs.values())
        spec_m = torch.cat([specs[d][:, p["band"][d]["crop_start"]:
                                     p["band"][d]["crop_stop"], :l]
                            for d in range(1, bands_n + 1)], dim=1)
        if spec_m.shape[1] < F_all:   # rows past the crops stay zero
            spec_m = F.pad(spec_m, (0, 0, 0, F_all - spec_m.shape[1]))
        spec_m = spec_m * self._pre[None, :, None]

        # the normalized sliding-window net
        x_mag = spec_m.abs()
        coef = torch.clamp(x_mag.max(), min=1e-8)
        x_pre = x_mag / coef
        pad_l, pad_r, roi = make_padding(l, win, off)
        n_win = int(np.ceil(l / roi))
        agg = sep._aggressiveness()
        with span("net", dev):
            pred = self._run_net(x_pre, pad_l, pad_r, n_win, roi,
                                 agg)[:, :, :l]
            if sep.tta:
                shift = roi // 2
                pt = self._run_net(x_pre, pad_l + shift, pad_r + shift,
                                   n_win + 1, roi, agg)
                pred = (pred + pt[:, :, shift: shift + l]) * 0.5
        pred = pred * coef

        phase = torch.exp(1j * torch.angle(spec_m))
        y_spec = pred * phase          # instruments
        v_spec = spec_m - y_spec       # vocals
        ins = self._to_wave(y_spec, input_high_end, he_h, l)
        voc = self._to_wave(v_spec, input_high_end, he_h, l)
        if sep.is_reverse:
            ins, voc = voc, ins

        def to16(x):
            return torch.clamp(torch.round(x * 32768.0), -32768,
                               32767).to(torch.int16)
        return to16(ins), to16(voc)

    def _to_wave(self, spec: torch.Tensor, input_high_end: torch.Tensor,
                 he_h: int, l: int) -> torch.Tensor:
        """Mirrored high-end restore, per-band crops and gains, iSTFTs and
        the upsample-sum -> (T, 2) float32."""
        sep = self.sep
        p = sep.mp.param
        dev = sep.device
        bands_n = len(p["band"])
        he = None
        if sep.high_end_process.startswith("mirroring"):
            pfs = p["pre_filter_start"]
            mirror = torch.flip(spec[:, pfs - 10 - he_h: pfs - 10, :l].abs(),
                                [1])
            ihe = input_high_end[:, :, :l]
            if sep.high_end_process == "mirroring":
                m = mirror * torch.exp(1j * torch.angle(ihe))
            else:
                m = mirror * (ihe * 1.7)
            he = torch.where(ihe.abs() <= m.abs(), ihe, m)

        offset_b = 0
        wave = None
        for d in range(1, bands_n + 1):
            bp = p["band"][d]
            Fd = bp["n_fft"] // 2 + 1
            h = bp["crop_stop"] - bp["crop_start"]
            spec_s = torch.zeros((2, Fd, l), dtype=torch.complex64,
                                 device=dev)
            spec_s[:, bp["crop_start"]:bp["crop_stop"]] = \
                spec[:, offset_b: offset_b + h]
            offset_b += h
            if d == bands_n and he is not None:
                max_bin = bp["n_fft"] // 2
                spec_s[:, max_bin - he_h: max_bin] = he
            spec_s = spec_s * self._gains[d][None, :, None]
            padw = bp["n_fft"] // 2
            with span("istft", dev):
                bw = istft(spec_s, bp["n_fft"], bp["hl"])[:, padw:-padw]
            if wave is None:
                wave = bw
            else:
                n = min(int(wave.shape[1]), int(bw.shape[1]))
                wave = wave[:, :n] + bw[:, :n]
            if d < bands_n and bp["sr"] != p["band"][d + 1]["sr"]:
                with span("resample", dev):
                    wave = resample_poly(wave, bp["sr"],
                                         p["band"][d + 1]["sr"])
        return wave.T

    @torch.no_grad()
    @fp32_math()
    @cudnn_autotune()
    def separate(self, music_file: str, fetch: bool = True):
        """Returns (instrument, vocal, sr): (T, 2) int16 numpy if fetch,
        else (instrument, vocal, sr, n) with the device tensors and their
        true length n."""
        p = self.sep.mp.param
        sr = p["band"][len(p["band"])]["sr"]
        with span("call", root=True):
            with span("load"):
                mono = load_audio(music_file, sr)   # downmixed
            T = mono.shape[0]
            bucket = int(self.bucket_s * sr)
            T4 = max(-(-T // bucket), 1) * bucket
            with span("upload"):
                wav = torch.zeros((2, T4), dtype=torch.float32)
                wav[:, :T] = torch.from_numpy(mono)
                wav = wav.to(self.sep.device)
            self._last_len = T4
            ins, voc = self._graph(wav)
            out_sr = p["sr"]
            n_out = min(int(ins.shape[0]), int(T * out_sr / sr))
            if not fetch:
                return ins, voc, out_sr, n_out
            if ins.is_cuda:
                # wait for the card here, so that `fetch` times the copies
                torch.cuda.current_stream(ins.device).synchronize()
            with span("fetch"):
                return (ins[:n_out].cpu().numpy(),
                        voc[:n_out].cpu().numpy(), out_sr)


def load_uvr5_model(model_path: str, param_name: str = "4band_v2.json",
                    agg: float = 10.0, tta: bool = False,
                    device=None) -> UVR5Separator:
    """An HP2/HP3/HP5-style VR checkpoint (reference uvr5/modules.py:17)."""
    from tpu_rvc_torch.ckpt.uvr5_loader import load_cascaded_aspp

    mp = ModelParameters(param_name)
    model = load_cascaded_aspp(model_path, n_fft=mp.param["bins"] * 2,
                               device=device)
    return UVR5Separator(model, mp, agg=agg, tta=tta, device=device)


def load_separator(model_path: str, agg: float = 10.0, tta: bool = False,
                   device=None):
    """Model-name dispatch (reference vr.py:22-39 and uvr5/modules.py:27):
    - onnx_dereverb_By_FoxJoy, or a `vocals.onnx` -> MDXNetDereverb;
    - *DeEcho*/*DeReverb* -> CascadedNetDeEcho with 4band_v3, outputs
      swapped;
    - any other (HP2/HP3/HP5 ...) -> CascadedASPPNet with 4band_v2, HP3's
      outputs swapped."""
    from tpu_rvc_torch.ckpt import uvr5_loader

    name = os.path.basename(model_path)
    if "onnx_dereverb" in model_path or name == "vocals.onnx":
        from tpu_rvc_torch.pipeline.mdxnet import MDXNetDereverb
        onnx_dir = (os.path.dirname(model_path)
                    if model_path.endswith(".onnx") else model_path)
        return MDXNetDereverb(onnx_dir, device=device)
    if "DeEcho" in name or "DeReverb" in name:
        mp = ModelParameters("4band_v3.json")
        model = uvr5_loader.load_deecho(model_path,
                                        n_fft=mp.param["bins"] * 2,
                                        device=device)
        return UVR5Separator(model, mp, agg=agg, tta=tta, is_reverse=True,
                             device=device)
    mp = ModelParameters("4band_v2.json")
    model = uvr5_loader.load_cascaded_aspp(model_path,
                                           n_fft=mp.param["bins"] * 2,
                                           device=device)
    return UVR5Separator(model, mp, agg=agg, tta=tta,
                         is_reverse="HP3" in name, device=device)
