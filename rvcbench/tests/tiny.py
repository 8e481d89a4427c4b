"""Cells and configurations at a size the CPU runs in seconds: every
width cut, the sample rate 16 kHz (hop 160), two slots, short files."""

from __future__ import annotations

import copy

from rvcbench.lib import cells


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(cells.config(name))
    cfg["model"].update(inter_channels=16, hidden_channels=16,
                        filter_channels=32, n_layers=2,
                        upsample_rates=[10, 4, 4],
                        upsample_kernel_sizes=[20, 8, 8],
                        upsample_initial_channel=32, gin_channels=16,
                        spk_embed_dim=4)
    cfg["data"]["sampling_rate"] = 16000
    cfg["hubert"].update(embed_dim=768, ffn_dim=256, heads=2, layers=2,
                         output_layer=2)
    cfg["index_rows"] = 500
    return cfg


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(cells.traffic(name))
    if cell["entry"] == "offline":
        cell.update(classes_s=[1.5, 2.5], files_per_class=1, x_pad=0.5)
    elif cell["entry"] == "serve":
        cell.update(slots=2, samplerate=16000, extra_time=0.5,
                    client_s=[1.0, 1.5], voices=2, warm_ticks=1)
    return cell


def tiny_train(name: str = "v2-40k.train-b32"):
    """The training cell at a CPU's size: 4 rows, two 12 s recordings."""
    cell = copy.deepcopy(cells.traffic(name))
    cell.update(batch_size=4, recordings=2, recording_s=12.0)
    cfg = tiny_config(cell["config"])
    cfg["data"].update(hop_length=160, filter_length=512, win_length=512,
                       n_mel_channels=40)
    cfg["train"]["segment_size"] = 3200
    return cell, cfg
