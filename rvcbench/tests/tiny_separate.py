"""The separation cell at a size the CPU runs in seconds: HP5's net at its
published widths over a band pyramid of 64 bins (four bands at 1, 1, 2
and 6 kHz, 50 frames a second), 32-frame windows with a 4-frame offset,
songs of a few seconds at 6 kHz."""

from __future__ import annotations

import copy
import json

from rvcbench.lib import cells

PYRAMID = {
    "bins": 64, "unstable_bins": 2, "reduction_bins": 60,
    "band": {
        "1": {"sr": 1000, "hl": 20, "n_fft": 128, "crop_start": 0,
              "crop_stop": 10, "lpf_start": 5, "lpf_stop": 9,
              "res_type": "polyphase"},
        "2": {"sr": 1000, "hl": 20, "n_fft": 64, "crop_start": 2,
              "crop_stop": 12, "hpf_start": 5, "hpf_stop": 3,
              "lpf_start": 8, "lpf_stop": 11, "res_type": "polyphase"},
        "3": {"sr": 2000, "hl": 40, "n_fft": 128, "crop_start": 8,
              "crop_stop": 24, "hpf_start": 12, "hpf_stop": 8,
              "lpf_start": 18, "lpf_stop": 23, "res_type": "polyphase"},
        "4": {"sr": 6000, "hl": 120, "n_fft": 256, "crop_start": 70,
              "crop_stop": 98, "hpf_start": 76, "hpf_stop": 70,
              "res_type": "kaiser_fast"},
    },
    "sr": 6000, "pre_filter_start": 60, "pre_filter_stop": 64,
}
WINDOW, OFFSET = 32, 4


def tiny_separation(name: str = "uvr5-hp5.separate-songs"):
    """(cell, configuration) with the small pyramid, window and songs."""
    cell = copy.deepcopy(cells.traffic(name))
    cell.update(classes_s=[1.5, 3.0], trims_s=[0.2, 0.7], sr=6000)
    cfg = copy.deepcopy(cells.config(cell["config"]))
    cfg.update(modelparams=copy.deepcopy(PYRAMID), window_size=WINDOW,
               offset=OFFSET, bucket_s=1.0)
    return cell, cfg


def use_tiny_program(monkeypatch, tmp_path) -> None:
    """The port's `load_separator` made to read the small pyramid as its
    4band_v2 and to slide the small window; `DeviceSeparator` to pad to
    1 s buckets."""
    from tpu_rvc_torch.pipeline import uvr5

    (tmp_path / "4band_v2.json").write_text(json.dumps(PYRAMID))
    monkeypatch.setattr(uvr5, "PARAMS_DIR", tmp_path)
    load = uvr5.load_separator

    def small(*a, **kw):
        sep = load(*a, **kw)
        sep.window_size, sep.model.offset = WINDOW, OFFSET
        return sep

    monkeypatch.setattr(uvr5, "load_separator", small)
    init = uvr5.DeviceSeparator.__init__

    def one_second(self, sep, bucket_s=1.0, group=8):
        init(self, sep, bucket_s, group)

    monkeypatch.setattr(uvr5.DeviceSeparator, "__init__", one_second)
