"""tpu_rvc_torch's HP separator against the benchmark's plain reference
(`rvcbench/ref/uvr5.py`, `rvcbench/ref/separate.py`, written out again
from upstream RVC WebUI) on the CPU, on seeded random weights in
upstream's checkpoint layout (`rvcbench/lib/uvr5_weights.py`: BatchNorms
with running statistics, which the port's loader folds): the net loaded
through `ckpt/uvr5_loader.py`, and `DeviceSeparator.separate` of a
stereo song.  HP5's published widths over a 64-bin band pyramid, so
that a window costs a few GFLOP.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_uvr5_plain.py -q
"""

import json

import numpy as np
import pytest
import torch

from rvcbench.lib import songs
from rvcbench.lib.uvr5_weights import first_window, hp5_state
from rvcbench.ref.separate import Separator
from rvcbench.ref.uvr5 import CascadedASPPNet
from rvcbench.tests.tiny_separate import OFFSET, PYRAMID, WINDOW
from tpu_rvc_torch.ckpt.uvr5_loader import load_cascaded_aspp
from tpu_rvc_torch.pipeline import uvr5

N_FFT = PYRAMID["bins"] * 2
CFG = {"modelparams": PYRAMID, "window_size": WINDOW, "offset": OFFSET}
SEED = 2 ** 31 + 19


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hp5(tmp_path_factory):
    """(checkpoint path, the reference net loaded from it)."""
    path = tmp_path_factory.mktemp("hp5") / "HP5_only_main_vocal.pth"
    torch.save(hp5_state(CFG, SEED, "cpu"), path)
    ref = CascadedASPPNet(N_FFT, OFFSET)
    ref.load_state_dict(torch.load(path, weights_only=True))
    return str(path), ref.eval()


def test_cascaded_aspp_matches_the_plain_reference(hp5):
    """The port's net, its BatchNorms folded at load, against upstream's
    with them unfolded, on a song's first window at agg 10: within 1e-4
    of the output's peak.  Folding and the pooled branch's mean move
    each layer's result by fp32's rounding, some 1e-7, and the random
    cascade magnifies that about tenfold a stage (on this seed 1.4e-6 of
    the peak after the first stage, 5.6e-6 after the second, 4.5e-5
    after the third); a wrong fold moves it by the whole signal."""
    path, ref = hp5
    port = load_cascaded_aspp(path, n_fft=N_FFT, device="cpu")
    x = first_window(ref, CFG, SEED + 1, "cpu")
    with torch.no_grad():
        want = ref(x, {"value": 0.1, "split_bin": 10})
        got = port(x, (torch.tensor(0.1), 10))
    err = float((got - want).abs().max()) / float(want.abs().max())
    print(f"net: {err:.3g} of the peak (limit 1e-4)")
    assert float(want.abs().max()) > 0 and err <= 1e-4


def test_device_separator_matches_the_plain_reference(hp5, tmp_path):
    """`DeviceSeparator.separate` (8 windows a call, the BatchNorms
    folded) against the reference's separation (a window a call,
    unfolded) of a 2.3 s stereo song in 1 s buckets: both int16 stems
    within 1 LSB (the float results differ by the rounding the net test
    reads, some 1e-5 of full scale, which flips a rounding to int16 now
    and then), on at most 1% of the samples."""
    path, ref = hp5
    params = tmp_path / "pyramid.json"
    params.write_text(json.dumps(PYRAMID))
    model = load_cascaded_aspp(path, n_fft=N_FFT, device="cpu")
    model.offset = OFFSET
    sep = uvr5.UVR5Separator(model, uvr5.ModelParameters(str(params)),
                             agg=10, window_size=WINDOW, device="cpu")
    song = str(tmp_path / "song.wav")
    songs.write_wav(song, songs.song(2.3, SEED + 2, PYRAMID["sr"]),
                    PYRAMID["sr"])
    got = uvr5.DeviceSeparator(sep, bucket_s=1.0).separate(song)
    want = Separator(ref, PYRAMID, "cpu", agg=10, window_size=WINDOW,
                     bucket_s=1.0).separate(song)
    assert got[2] == want[2] == PYRAMID["sr"]
    for g, w, what in zip(got[:2], want[:2], ("instruments", "vocals")):
        assert g.dtype == w.dtype == np.int16 and g.shape == w.shape
        lsb = np.abs(g.astype(np.int32) - w)
        print(f"{what}: {int(lsb.max())} LSB (limit 1) on "
              f"{int(np.count_nonzero(lsb))} of {lsb.size} samples")
        assert np.abs(w).max() > 1000
        assert lsb.max() <= 1 and np.count_nonzero(lsb) <= 0.01 * lsb.size
