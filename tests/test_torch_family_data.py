"""tpu_rvc_torch's dataset preparation at the model family's rates and
versions against tpu_rvc's (JAX) on the CPU, on the same seeded inputs:
preprocessing to 40 and 32 kHz, v1 feature extraction (HuBERT's tap
through final_proj into 3_feature256), the filelist of a v1 experiment
with f0 and of an f0-less v2 one (sr tags "32k" and "40k"), the
dataset's spectrograms at 32k's FFT size and hop, the bucket plans at the
presets' segments (12800 and 11520 samples), and a small model exported
at "40k" without f0 read by tpu_rvc."""

import dataclasses
import functools
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_rvc.audio.io import load_wav as jax_load_wav
from tpu_rvc.core import config as jax_config
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.models.loader import load_synthesizer as jax_load_synthesizer
from tpu_rvc.train import data as jax_data
from tpu_rvc.train.extract import extract_features as jax_extract_features
from tpu_rvc.train.preprocess import preprocess_dataset as jax_preprocess

from tpu_rvc_torch.audio.io import save_wav
from tpu_rvc_torch.ckpt.small_model import save_small_model
from tpu_rvc_torch.core import config
from tpu_rvc_torch.models.loader import load_synthesizer
from tpu_rvc_torch.train import data
from tpu_rvc_torch.train.extract import extract_features
from tpu_rvc_torch.train.preprocess import preprocess_dataset
from tpu_rvc_torch.train.step import create_train_state

from _torch_parity import SMALL_HUBERT, hubert_pair

# HuBERT's v1 tap at narrow width: final_proj projects to the v1 width
V1_HUBERT = dict(SMALL_HUBERT, final_proj=True, final_dim=256)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def voice(seconds, seed, sr, gaps=((0.40, 0.46),)):
    """Harmonics on a gliding pitch, breath noise, silent gaps."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(sr * seconds)) / sr
    f0 = 160 + 60 * np.sin(2 * np.pi * 0.3 * tt)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 6))
    x = x + 0.01 * rng.standard_normal(tt.shape)
    for a, b in gaps:
        x[int(len(x) * a):int(len(x) * b)] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("sr", [40000, 32000])
def test_preprocess_to_family_rates_matches_jax(tmp_path, sr):
    """Two raw files, 44.1 and 48 kHz, through both packages' preprocess
    at the model's rate: every 0_gt_wavs file at `sr` and every
    1_16k_wavs file sample for sample."""
    raw = tmp_path / "raw"
    raw.mkdir()
    save_wav(str(raw / "a.wav"), voice(8.0, 1, 44100, ((0.3, 0.45),)),
             44100)
    save_wav(str(raw / "b.wav"), voice(4.0, 2, 48000), 48000)
    preprocess_dataset(str(raw), sr, 2, str(tmp_path / "port"), per=3.7)
    jax_preprocess(str(raw), sr, 2, str(tmp_path / "jax"), per=3.7)
    for sub, rate in (("0_gt_wavs", sr), ("1_16k_wavs", 16000)):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub))
        assert len(names) >= 3
        for n in names:
            got, got_sr = jax_load_wav(str(tmp_path / "port" / sub / n))
            want, want_sr = jax_load_wav(str(tmp_path / "jax" / sub / n))
            assert got_sr == want_sr == rate
            np.testing.assert_array_equal(got, want)


def test_extract_features_v1_matches_jax(tmp_path):
    """`extract_features(..., "v1")` with a narrow HuBERT whose tap goes
    through final_proj: 256-d rows in 3_feature256, as tpu_rvc's."""
    hub, jvars = hubert_pair(V1_HUBERT, 23)
    exp, jexp = tmp_path / "port", tmp_path / "jax"
    for d in (exp, jexp):
        (d / "1_16k_wavs").mkdir(parents=True)
        for i, sec in enumerate((1.3, 2.0)):
            save_wav(str(d / "1_16k_wavs" / f"{i}.wav"),
                     voice(sec, 11 + i, 16000), 16000)
    assert extract_features(str(exp), "v1", hubert=hub, device="cpu") == []
    assert jax_extract_features(str(jexp), "v1",
                                hubert=JaxHubert(**V1_HUBERT),
                                hubert_vars=jvars,
                                dtype=jnp.float32) == []
    assert not (exp / "3_feature768").exists()
    for n in ("0.npy", "1.npy"):
        got, want = (np.load(d / "3_feature256" / n) for d in (exp, jexp))
        assert got.shape == want.shape and got.shape[1] == 256
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def family_experiment(exp, version, if_f0, sr, rng):
    """Five utterances at `sr` with the version's features and, with
    f0, both f0 files; one of 0.2 s is shorter than any preset's
    segment."""
    hop = sr // 100
    dim = 256 if version == "v1" else 768
    subs = ["0_gt_wavs", f"3_feature{dim}"]
    if if_f0:
        subs += ["2a_f0", "2b-f0nsf"]
    for d in subs:
        (exp / d).mkdir(parents=True)
    for name, dur in {"a": 3.5, "b": 2.5, "c": 1.0, "d": 1.0,
                      "short": 0.2}.items():
        S = int(sr * dur)
        save_wav(str(exp / "0_gt_wavs" / f"{name}.wav"),
                 voice(dur, len(name) + S % 7, sr, gaps=()), sr)
        nfeat = (int(16000 * dur) - 400) // 320 + 1
        np.save(exp / f"3_feature{dim}" / f"{name}.npy",
                rng.standard_normal((nfeat, dim)).astype(np.float32))
        if if_f0:
            nf0 = S // hop + 1
            np.save(exp / "2a_f0" / f"{name}.wav.npy",
                    rng.integers(1, 255, nf0).astype(np.int32))
            np.save(exp / "2b-f0nsf" / f"{name}.wav.npy",
                    rng.uniform(100, 300, nf0).astype(np.float32))


# (version, if_f0, sr, the preset whose segment the plans drop short rows by)
FILELISTS = {"v1_f0_32k": ("v1", True, 32000, ("v1", 32000)),
             "v2_40k": ("v2", False, 40000, ("v2", 40000)),
             "v1_f0_48k": ("v1", True, 48000, ("v1", 48000))}


@pytest.mark.parametrize("kind", list(FILELISTS))
def test_family_filelist_dataset_and_plans_match_jax(tmp_path, kind):
    """`write_filelist` (rows and the sr tag's mute rows), `RVCDataset`'s
    spectrograms at the preset's FFT size and hop, and `BucketBatcher`'s
    plans at the preset's segment (rows shorter than it dropped), each
    package on its own copy of one experiment; collated batches equal."""
    version, if_f0, sr, preset = FILELISTS[kind]
    tag = f"{sr // 1000}k"
    family_experiment(tmp_path / "port", version, if_f0, sr,
                      np.random.default_rng(0))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    rows = []
    for pkg, d in ((data, tmp_path / "port"), (jax_data, tmp_path / "jax")):
        path = pkg.write_filelist(str(d), version, if_f0, 0, tag)
        rows.append(open(path).read().replace(str(pkg.MUTE_DIR), "MUTE")
                    .replace(str(d), "EXP"))
    assert rows[0] == rows[1]
    lines = rows[0].strip().split("\n")
    assert len(lines) == 7
    assert sum(f"MUTE/0_gt_wavs/mute{tag}.wav" in ln for ln in lines) == 2
    assert all(len(ln.split("|")) == (5 if if_f0 else 3) for ln in lines)
    feat = "3_feature256" if version == "v1" else "3_feature768"
    assert all(f"/{feat}/" in ln for ln in lines)

    hp, jhp = config.hparams_for(*preset), jax_config.hparams_for(*preset)
    ds = data.RVCDataset(str(tmp_path / "port" / "filelist.txt"), hp,
                         if_f0=if_f0)
    jds = jax_data.RVCDataset(str(tmp_path / "jax" / "filelist.txt"), jhp,
                              if_f0=if_f0)
    for i in range(len(ds)):
        got, want = ds.load(i), jds.load(i)
        assert got["spec"].shape[1] == hp.data.spec_channels
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    seg_frames = hp.train.segment_size // hp.data.hop_length
    ours = data.BucketBatcher(ds, batch_size=2, seed=7,
                              min_frames=seg_frames)
    theirs = jax_data.BucketBatcher(jds, batch_size=2, seed=7,
                                    min_frames=seg_frames)
    for epoch in range(3):
        plans = ours._plans(epoch, 0, 1)
        assert plans == theirs._plans(epoch, 0, 1)
        kept = {i for _, group in plans for i in group}
        assert all(ds.items[i].n_frames >= seg_frames for i in kept)
        assert len(kept) == len(ds) - 1          # the 0.2 s row is dropped
    for got, want in zip(ours.epoch(1), theirs.epoch(1)):
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def test_small_model_at_40k_without_f0_loads_in_jax(tmp_path):
    """A narrow v2/40k f0-less training G exported as a small model at
    "40k" with f0 0: tpu_rvc reads it as such and its `infer` agrees with
    the port's within atol 1e-4 (upsamplers at 30x their initial gain, so
    that the audio depends on the input)."""
    hp = config.hparams_for("v2", 40000)
    hp = dataclasses.replace(hp, model=dataclasses.replace(
        hp.model, inter_channels=16, hidden_channels=16, filter_channels=32,
        n_layers=1, upsample_initial_channel=64, gin_channels=8,
        spk_embed_dim=4))
    state = create_train_state(hp, seed=8, use_f0=False, device="cpu")
    with torch.no_grad():
        for up in state.net_g.dec.ups:
            up.weight_g.mul_(30.0)
    path = save_small_model(state.net_g.state_dict(), "40k", 0, "m40", 3,
                            "v2", hp, out_path=str(tmp_path / "m40.pth"))
    port, meta = load_synthesizer(path, "cpu")
    jmod, jvars, jmeta = jax_load_synthesizer(path)
    for m in (meta, jmeta):
        assert (m["sr"], m["f0"], m["version"]) == ("40k", 0, "v2")
    assert not port.use_f0 and not jmod.use_f0
    rng = np.random.default_rng(4)
    Tn = 30
    phone = rng.standard_normal((1, Tn, 768)).astype(np.float32)
    lens, sid = np.array([Tn], np.int32), np.array([2], np.int32)
    want = np.asarray(jax.jit(functools.partial(
        jmod.apply, method=jmod.infer, deterministic=True))(
            jvars, phone, lens, sid))
    got = port.infer(*(torch.from_numpy(a) for a in (phone, lens, sid)),
                     deterministic=True).numpy()
    assert got.shape == want.shape == (1, Tn * 400, 1)
    assert float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
