"""A UVR5 VR separation written out again from upstream (RVC-Project/
Retrieval-based-Voice-Conversion-WebUI: infer/modules/uvr5/vr.py
`AudioPre._path_audio_`, infer/lib/uvr5_pack/utils.py `inference`,
lib_v5/dataset.py `make_padding`, lib_v5/spec_utils.py), in the order
upstream applies it, in plain torch, fp32 with TF32 off:

1. the band pyramid: the top band as read, each lower band resampled
   from the one above;
2. each band's STFT, centred frames (reflect-padded by n_fft // 2), the
   periodic Hann window;
3. the top band's high end kept for the restore;
4. `combine_spectrograms`: each band's crop stacked, the pre-filter's dB
   ramp over the last bins;
5. the magnitude over its largest value; `make_padding`, then the
   `window_size`-frame windows `roi` apart through the net, one window
   at a time, `offset` frames cut from each edge; the mask raised by the
   aggressiveness (`agg` / 100, the split at band 1's crop);
6. the phase restored: instruments = mask x |X| x e^(i angle X), vocals
   = X - instruments;
7. `mirroring`: the bins below the pre-filter, flipped, with the input's
   phase, where they are quieter than the input's own high end;
8. `cmb_spectrogram_to_wave`: each band's crop back in its spectrum, the
   lp / hp filters, the iSTFT, the sum up the pyramid;
9. the int16 scaling.

Where the port departs from upstream the reference follows the port,
so that the comparison measures the program's arithmetic:
- mono: the port's `load_audio` averages the channels and the flow runs
  on the mono signal twice (upstream reads the file in stereo);
- the bucket: the port pads the input with zeros to a multiple of
  `bucket_s` seconds, runs the flow on that, and cuts the stems to the
  input's length;
- the resampler: one Kaiser-windowed sinc bank everywhere (the port's
  `ops/resample.py`, this package's `ref/resample.py`), where upstream
  uses librosa's `polyphase` on the way down, `sinc_fastest` and scipy's
  FFT resample on the way up (librosa, libsamplerate and resampy are not
  on the card's machine; equal rates are not resampled in either);
- int16: rounded and clipped, where upstream truncates and wraps
  (`(x * 32768).astype("int16")`);
- the way up in complex64 and float32, the configuration's precision,
  where upstream's `np.ndarray(dtype=complex)` makes it complex128, and
  zeros outside the crops, where upstream leaves that array unset.
"""

from __future__ import annotations

import math
import wave as wavefile
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import precision
from .resample import resample_poly
from .stft import hann_window, stft


def read_mono(path: str) -> Tuple[np.ndarray, int]:
    """A 16-bit PCM WAV as float32 (x / 32768), its channels averaged
    (the port's `load_wav`) -> (samples, rate)."""
    with wavefile.open(path, "rb") as w:
        ch, sr = w.getnchannels(), w.getframerate()
        raw = w.readframes(w.getnframes())
    x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def band_stft(wave: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(2, T) -> (2, n_fft // 2 + 1, 1 + T // hop), librosa.stft with
    center=True and reflect padding."""
    pad = n_fft // 2
    return stft(F.pad(wave[None], (pad, pad), mode="reflect")[0], n_fft, hop)


def band_istft(spec: torch.Tensor, hop: int) -> torch.Tensor:
    """librosa.istft, center=True: the windowed inverse frames added up,
    over the added squared window, n_fft // 2 cut from each end ->
    (2, hop * (frames - 1))."""
    n_fft = 2 * (spec.shape[1] - 1)
    window = hann_window(n_fft, spec.device)
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1) * window
    n = frames.shape[1]
    T = n_fft + hop * (n - 1)

    def add_up(cols):                    # (B, n_fft, frames) -> (B, T)
        return F.fold(cols, (1, T), (1, n_fft), stride=(1, hop))[:, 0, 0]

    y = add_up(frames.transpose(1, 2))
    wsq = add_up((window * window)[None, :, None].expand(1, n_fft, n))
    tiny = torch.finfo(wsq.dtype).tiny
    y = torch.where(wsq > tiny, y / torch.where(wsq > tiny, wsq, 1.0), y)
    return y[:, n_fft // 2: -(n_fft // 2)]


def fft_lp_filter(spec: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    g = 1.0
    for b in range(start, stop):
        g -= 1 / (stop - start)
        spec[:, b, :] = g * spec[:, b, :]
    spec[:, stop:, :] *= 0
    return spec


def fft_hp_filter(spec: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    g = 1.0
    for b in range(start, stop, -1):
        g -= 1 / (start - stop)
        spec[:, b, :] = g * spec[:, b, :]
    spec[:, 0:stop + 1, :] *= 0
    return spec


def make_padding(width: int, cropsize: int, offset: int):
    left = offset
    roi_size = cropsize - left * 2
    if roi_size == 0:
        roi_size = cropsize
    right = roi_size - (width % roi_size) + left
    return left, right, roi_size


class Separator:
    """`AudioPre` with HP5's settings: `params` the band pyramid's
    parameters (4band_v2's, bands keyed "1".."4"), `net` the reference
    `CascadedASPPNet` on `device` in eval mode."""

    def __init__(self, net, params: Dict, device, agg: float = 10.0,
                 window_size: int = 512, high_end_process: str = "mirroring",
                 bucket_s: float = 5.0, tf32: bool = False):
        self.net, self.p = net.eval(), params
        self.band = {int(k): v for k, v in params["band"].items()}
        self.device = torch.device(device)
        self.agg, self.window_size = agg, window_size
        self.high_end_process, self.bucket_s = high_end_process, bucket_s
        self.tf32 = tf32

    def combine_spectrograms(self, specs) -> torch.Tensor:
        p, n = self.p, len(self.band)
        l = min(specs[i].shape[2] for i in specs)
        spec_c = torch.zeros((2, p["bins"] + 1, l), dtype=torch.complex64,
                             device=self.device)
        offset = 0
        for d in range(1, n + 1):
            bp = self.band[d]
            h = bp["crop_stop"] - bp["crop_start"]
            spec_c[:, offset:offset + h, :l] = \
                specs[d][:, bp["crop_start"]:bp["crop_stop"], :l]
            offset += h
        if offset > p["bins"]:
            raise ValueError("Too much bins")
        if p["pre_filter_start"] > 0:
            if n == 1:
                spec_c = fft_lp_filter(spec_c, p["pre_filter_start"],
                                       p["pre_filter_stop"])
            else:
                gp = 1
                for b in range(p["pre_filter_start"] + 1,
                               p["pre_filter_stop"]):
                    g = math.pow(10, -(b - p["pre_filter_start"])
                                 * (3.5 - gp) / 20.0)
                    gp = g
                    spec_c[:, b, :] *= g
        return spec_c

    def inference(self, x_spec: torch.Tensor):
        """The sliding windows through the net, one at a time ->
        (prediction, |X|, e^(i angle X))."""
        x_mag, x_phase = x_spec.abs(), torch.angle(x_spec)
        coef = x_mag.max()
        x_pre = x_mag / coef
        n_frame = x_pre.shape[2]
        pad_l, pad_r, roi = make_padding(n_frame, self.window_size,
                                         self.net.offset)
        n_window = int(np.ceil(n_frame / roi))
        x_pad = F.pad(x_pre, (pad_l, pad_r))
        agg = {"value": float(self.agg / 100),
               "split_bin": self.band[1]["crop_stop"]}
        preds = []
        for i in range(n_window):
            start = i * roi
            window = x_pad[None, :, :, start:start + self.window_size]
            preds.append(self.net.predict(window, agg)[0])
        pred = torch.cat(preds, dim=2)[:, :, :n_frame]
        return pred * coef, x_mag, torch.exp(1.0j * x_phase)

    def mirroring(self, spec_m, input_high_end):
        pfs = self.p["pre_filter_start"]
        mirror = torch.flip(
            spec_m[:, pfs - 10 - input_high_end.shape[1]: pfs - 10, :]
            .abs(), [1])
        mirror = mirror * torch.exp(1.0j * torch.angle(input_high_end))
        return torch.where(input_high_end.abs() <= mirror.abs(),
                           input_high_end, mirror)

    def cmb_spectrogram_to_wave(self, spec_m, extra_bins_h=None,
                                extra_bins=None) -> torch.Tensor:
        n = len(self.band)
        offset, wave = 0, None
        for d in range(1, n + 1):
            bp = self.band[d]
            spec_s = torch.zeros((2, bp["n_fft"] // 2 + 1, spec_m.shape[2]),
                                 dtype=torch.complex64, device=self.device)
            h = bp["crop_stop"] - bp["crop_start"]
            spec_s[:, bp["crop_start"]:bp["crop_stop"], :] = \
                spec_m[:, offset:offset + h, :]
            offset += h
            if d == n:
                if extra_bins_h:
                    max_bin = bp["n_fft"] // 2
                    spec_s[:, max_bin - extra_bins_h:max_bin, :] = \
                        extra_bins[:, :extra_bins_h, :]
                if bp.get("hpf_start", 0) > 0:
                    spec_s = fft_hp_filter(spec_s, bp["hpf_start"],
                                           bp["hpf_stop"] - 1)
                if n == 1:
                    wave = band_istft(spec_s, bp["hl"])
                else:
                    wave = wave + band_istft(spec_s, bp["hl"])
            else:
                sr = self.band[d + 1]["sr"]
                if d == 1:
                    spec_s = fft_lp_filter(spec_s, bp["lpf_start"],
                                           bp["lpf_stop"])
                    wave = resample_poly(band_istft(spec_s, bp["hl"]),
                                         bp["sr"], sr)
                else:
                    spec_s = fft_hp_filter(spec_s, bp["hpf_start"],
                                           bp["hpf_stop"] - 1)
                    spec_s = fft_lp_filter(spec_s, bp["lpf_start"],
                                           bp["lpf_stop"])
                    wave2 = wave + band_istft(spec_s, bp["hl"])
                    wave = resample_poly(wave2, bp["sr"], sr)
        return wave.T

    @torch.no_grad()
    def separate(self, path: str) -> Tuple[np.ndarray, np.ndarray, int]:
        """(instruments, vocals, rate): (T, 2) int16 each."""
        mono, sr = read_mono(path)
        if sr != self.band[len(self.band)]["sr"]:
            raise ValueError(f"{path}: {sr} Hz, not the top band's rate")
        T = mono.shape[0]
        bucket = int(self.bucket_s * sr)
        padded = np.zeros(max(-(-T // bucket), 1) * bucket, np.float32)
        padded[:T] = mono
        with precision(self.tf32):
            ins, voc = self.flow(torch.as_tensor(padded, device=self.device))

        def to16(w):
            return torch.clamp(torch.round(w[:T] * 32768.0), -32768,
                               32767).to(torch.int16).cpu().numpy()

        return to16(ins), to16(voc), self.p["sr"]

    def spectra(self, x: torch.Tensor):
        """Steps 1-4 on the mono signal `x` (T,) at the top band's rate ->
        (the combined spectrogram, the high end's height, the high end)."""
        p, n = self.p, len(self.band)
        x_wave, x_spec = {}, {}
        input_high_end_h = input_high_end = None
        for d in range(n, 0, -1):
            bp = self.band[d]
            if d == n:
                x_wave[d] = torch.stack([x, x])
            else:
                x_wave[d] = resample_poly(x_wave[d + 1],
                                          self.band[d + 1]["sr"], bp["sr"])
            x_spec[d] = band_stft(x_wave[d], bp["n_fft"], bp["hl"])
            if d == n and self.high_end_process != "none":
                input_high_end_h = (bp["n_fft"] // 2 - bp["crop_stop"]) + (
                    p["pre_filter_stop"] - p["pre_filter_start"])
                input_high_end = x_spec[d][
                    :, bp["n_fft"] // 2 - input_high_end_h:bp["n_fft"] // 2,
                    :]
        return (self.combine_spectrograms(x_spec), input_high_end_h,
                input_high_end)

    def flow(self, x: torch.Tensor):
        """Steps 1-8 on the mono signal `x` -> (instruments, vocals), each
        (T', 2) float32."""
        x_spec_m, input_high_end_h, input_high_end = self.spectra(x)
        pred, _, x_phase = self.inference(x_spec_m)
        y_spec_m = pred * x_phase
        v_spec_m = x_spec_m - y_spec_m

        def to_wave(spec):
            if self.high_end_process.startswith("mirroring"):
                return self.cmb_spectrogram_to_wave(
                    spec, input_high_end_h,
                    self.mirroring(spec, input_high_end))
            return self.cmb_spectrogram_to_wave(spec)

        return to_wave(y_spec_m), to_wave(v_spec_m)
