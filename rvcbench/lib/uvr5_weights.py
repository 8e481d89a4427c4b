"""HP5's weights from the seed, in upstream's checkpoint layout (the
reference `CascadedASPPNet`'s state_dict, as `HP5_only_main_vocal.pth`
stores it: fp32, every BatchNorm with its running statistics and its
`num_batches_tracked`, the auxiliary heads included).

Each kernel is drawn at 1/sqrt(fan-in), each BatchNorm's weight in
(0.5, 1.5) and bias at 0.1.  The running mean and variance are then the
statistics of what reaches each BatchNorm when the first windows of
`SONGS` seeded songs go through the net together (one pass with the
BatchNorms normalising by the batch's own statistics), each variance at
least a hundredth of its layer's median, as a trained model's, which has
seen many songs, holds it: so every BatchNorm of the cascade normalises
what it is given, the activations keep their scale from the first
encoder to the mask, and the mask's sigmoid is not saturated."""

from __future__ import annotations

from typing import Dict

import torch

from rvcbench.ref.precision import precision
from rvcbench.ref.separate import Separator, make_padding
from rvcbench.ref.uvr5 import CascadedASPPNet
from . import songs, weights
from .inputs import subseeds

SONGS = 4


def rule(key: str, shape):
    """(kind, value) of a leaf (`weights.random_state`); the running
    statistics drawn here are replaced by the calibration's."""
    leaf = key.rsplit(".", 1)[-1]
    if len(shape) == 1 and leaf == "weight":
        return "sigmoid", 0.5
    if len(shape) == 1 and leaf == "bias":
        return "normal", 0.1
    return weights.default_rule(key, shape)


def first_window(net, cfg: Dict, seed: int, device) -> torch.Tensor:
    """The net's input for the first window of a seeded song: (1, 2, F,
    window) magnitudes over their largest."""
    mp = cfg["modelparams"]
    sr = mp["sr"]
    top = mp["band"][str(len(mp["band"]))]
    seconds = cfg["window_size"] * top["hl"] / sr + 1.0
    mix = songs.song(seconds, seed, sr, device)
    sep = Separator(net, mp, device)
    x_spec, _, _ = sep.spectra(torch.as_tensor(mix.mean(axis=1),
                                               device=device))
    x_pre = x_spec.abs() / x_spec.abs().max()
    pad_l, _, _ = make_padding(x_pre.shape[2], cfg["window_size"],
                               cfg["offset"])
    padded = torch.nn.functional.pad(x_pre, (pad_l, cfg["window_size"]))
    return padded[None, :, :, :cfg["window_size"]]


@torch.no_grad()
def hp5_state(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The checkpoint's state_dict, on the host."""
    s_w, *s_songs = subseeds(seed, 13 + SONGS)[12:]
    n_fft = cfg["modelparams"]["bins"] * 2
    with torch.device("meta"):
        sd = CascadedASPPNet(n_fft, cfg["offset"]).state_dict()
    shapes = {k: tuple(v.shape) for k, v in sd.items()
              if v.is_floating_point()}
    drawn = weights.random_state(shapes, s_w, device, rule)
    net = CascadedASPPNet(n_fft, cfg["offset"]).to(device)
    net.load_state_dict(drawn, strict=False)
    windows = torch.cat([first_window(net, cfg, s, device) for s in s_songs])
    net.eval()
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None             # the running statistics: one pass's
        m.train()
    with precision(False):
        net(windows)
    for m in bns:
        m.running_var.clamp_(min=1e-2 * float(m.running_var.median()))
        m.momentum = 0.1
        m.eval()
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}
