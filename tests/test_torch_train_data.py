"""tpu_rvc_torch's dataset preparation and training loop against tpu_rvc's
(JAX) on the CPU: the slicer and preprocess sample for sample, pm f0
extraction, the filelist and the bucket plans row for row, the port's own
mute fixtures, `run_training` on them with `cache_in_hbm`, resume against
a straight run, and the port's checkpoints read by tpu_rvc."""

import dataclasses
import functools
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_rvc.audio.io import load_wav as jax_load_wav
from tpu_rvc.audio.slicer import Slicer as JaxSlicer
from tpu_rvc.ckpt.convert import synthesizer_params_from_state_dict
from tpu_rvc.ckpt.torch_pth import load_pth
from tpu_rvc.core import config as jax_config
from tpu_rvc.models.loader import load_synthesizer as jax_load_synthesizer
from tpu_rvc.train import data as jax_data
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.train.extract import extract_f0 as jax_extract_f0
from tpu_rvc.train.extract import extract_features as jax_extract_features
from tpu_rvc.train.preprocess import preprocess_dataset as jax_preprocess

from tpu_rvc_torch.audio.io import save_wav
from tpu_rvc_torch.audio.slicer import Slicer
from tpu_rvc_torch.core import config
from tpu_rvc_torch.models.loader import load_synthesizer
from tpu_rvc_torch.train import data
from tpu_rvc_torch.train.extract import extract_f0, extract_features
from tpu_rvc_torch.train.loop import (load_native_checkpoint, run_training,
                                      warm_start)
from tpu_rvc_torch.train.preprocess import preprocess_dataset
from tpu_rvc_torch.train.step import create_train_state

from _torch_parity import SMALL_HUBERT, hubert_pair

SR = 48000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine: a GAN
    step with torch's default thread pool in each of them oversubscribes
    the cores (20 times slower with 6 workers on 8 cores), one thread each
    does not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def voice(seconds, seed, sr=SR, gaps=((0.40, 0.46),)):
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


def test_mute_assets_present():
    gt = data.MUTE_DIR / "0_gt_wavs"
    assert {p.name for p in gt.glob("*.wav")} == {
        "mute32k.wav", "mute40k.wav", "mute48k.wav"}
    assert (data.MUTE_DIR / "1_16k_wavs" / "mute.wav").exists()
    for sub in ("2a_f0", "2b-f0nsf"):
        assert (data.MUTE_DIR / sub / "mute.wav.npy").exists()
    for dim in (256, 768):
        assert np.load(data.MUTE_DIR / f"3_feature{dim}" / "mute.npy"
                       ).shape[1] == dim
    assert "tpu_rvc_torch" in str(data.MUTE_DIR)


def test_slicer_matches_jax():
    x = voice(12.0, 0, gaps=((0.2, 0.3), (0.5, 0.52), (0.7, 0.9)))
    args = dict(sr=SR, threshold=-42, min_length=1500, min_interval=400,
                hop_size=15, max_sil_kept=500)
    got, want = Slicer(**args).slice(x), JaxSlicer(**args).slice(x)
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Two raw 48 kHz files through both packages' preprocess, each into an
    experiment dir of its own."""
    root = tmp_path_factory.mktemp("prep")
    raw = root / "raw"
    raw.mkdir()
    save_wav(str(raw / "a.wav"), voice(9.0, 1, gaps=((0.3, 0.45),)), SR)
    save_wav(str(raw / "b.wav"), voice(4.0, 2), SR)
    preprocess_dataset(str(raw), SR, 2, str(root / "port"), per=3.7)
    jax_preprocess(str(raw), SR, 2, str(root / "jax"), per=3.7)
    return root


def test_preprocess_matches_jax(prepared):
    for sub, sr in (("0_gt_wavs", SR), ("1_16k_wavs", 16000)):
        names = sorted(os.listdir(prepared / "jax" / sub))
        assert names == sorted(os.listdir(prepared / "port" / sub))
        assert len(names) >= 3
        for n in names:
            got, got_sr = jax_load_wav(str(prepared / "port" / sub / n))
            want, want_sr = jax_load_wav(str(prepared / "jax" / sub / n))
            assert got_sr == want_sr == sr
            np.testing.assert_array_equal(got, want)


def test_extract_f0_pm_matches_jax(tmp_path):
    """Coarse bins equal on >= 99% of frames, f0 within 1e-3 relative (the
    two FFT libraries round differently; the input has no digital silence,
    where a frame at a gap's edge can flip its voicing between the two and
    the gap interpolation then spreads that over the gap)."""
    exp, jexp = tmp_path / "port", tmp_path / "jax"
    for d in (exp, jexp):
        (d / "1_16k_wavs").mkdir(parents=True)
        for i, sec in enumerate((3.0, 2.0)):
            save_wav(str(d / "1_16k_wavs" / f"{i}.wav"),
                     voice(sec, 4 + i, sr=16000, gaps=()), 16000)
    assert extract_f0(str(exp), f0_method="pm", device="cpu") == []
    assert jax_extract_f0(str(jexp), f0_method="pm") == []
    names = sorted(os.listdir(jexp / "2a_f0"))
    assert names == sorted(os.listdir(exp / "2a_f0")) == ["0.wav.npy",
                                                          "1.wav.npy"]
    for n in names:
        c_got, c_want = (np.load(d / "2a_f0" / n) for d in (exp, jexp))
        f_got, f_want = (np.load(d / "2b-f0nsf" / n) for d in (exp, jexp))
        assert c_got.dtype == c_want.dtype and c_got.shape == c_want.shape
        assert np.mean(c_got == c_want) >= 0.99
        np.testing.assert_allclose(f_got, f_want, rtol=1e-3)


def test_extract_features_matches_jax(tmp_path):
    """HuBERT features of two utterances (each zero-padded to whole seconds
    with its padding mask) from one set of small HuBERT weights."""
    hub, jvars = hubert_pair(SMALL_HUBERT, 21)
    exp, jexp = tmp_path / "port", tmp_path / "jax"
    for d in (exp, jexp):
        (d / "1_16k_wavs").mkdir(parents=True)
        for i, sec in enumerate((1.7, 1.0)):
            save_wav(str(d / "1_16k_wavs" / f"{i}.wav"),
                     voice(sec, 8 + i, sr=16000), 16000)
    assert extract_features(str(exp), "v2", hubert=hub, device="cpu") == []
    assert jax_extract_features(str(jexp), "v2",
                                hubert=JaxHubert(**SMALL_HUBERT),
                                hubert_vars=jvars,
                                dtype=jnp.float32) == []
    for n in ("0.npy", "1.npy"):
        got, want = (np.load(d / "3_feature768" / n) for d in (exp, jexp))
        assert got.shape == want.shape and got.shape[1] == 64
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def fake_experiment(exp, rng):
    """tests/test_dataset_prep.py:100-120: four complete rows and one
    missing its 2b-f0nsf file."""
    hop = 480
    for d in ("0_gt_wavs", "3_feature768", "2a_f0", "2b-f0nsf"):
        (exp / d).mkdir(parents=True)
    for name, dur in {"a": 3.5, "b": 3.5, "c": 1.0, "d": 1.0,
                      "nof0nsf": 2.0}.items():
        S = int(SR * dur)
        save_wav(str(exp / "0_gt_wavs" / f"{name}.wav"),
                 (0.3 * np.sin(2 * np.pi * 220 * np.arange(S) / SR)), SR)
        nfeat = (int(16000 * dur) - 400) // 320 + 1
        np.save(exp / "3_feature768" / f"{name}.npy",
                rng.standard_normal((nfeat, 768)).astype(np.float32))
        nf0 = S // hop + 1
        np.save(exp / "2a_f0" / f"{name}.wav.npy",
                rng.integers(1, 255, nf0).astype(np.int32))
        if name != "nof0nsf":
            np.save(exp / "2b-f0nsf" / f"{name}.wav.npy",
                    rng.uniform(100, 300, nf0).astype(np.float32))


def test_filelist_and_bucket_plans_match_jax(tmp_path):
    """Rows (mute fixtures aside, which each package keeps), plans and
    collated batches of both packages on one experiment; each reads its
    own copy, since both cache spectrograms beside the wavs."""
    fake_experiment(tmp_path / "port", np.random.default_rng(0))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    rows = []
    for pkg, d in ((data, tmp_path / "port"), (jax_data, tmp_path / "jax")):
        path = pkg.write_filelist(str(d), "v2", True, 0, "48k")
        rows.append(open(path).read().replace(str(pkg.MUTE_DIR), "MUTE")
                    .replace(str(d), "EXP"))
    assert rows[0] == rows[1]
    assert len(rows[0].strip().split("\n")) == 6
    hp = config.HParams(version="v2", data=config.DataConfig(
        sampling_rate=SR, filter_length=1024, hop_length=480,
        win_length=1024, n_mel_channels=32))
    jhp = jax_config.HParams(version="v2", data=jax_config.DataConfig(
        sampling_rate=SR, filter_length=1024, hop_length=480,
        win_length=1024, n_mel_channels=32))
    ours = data.BucketBatcher(data.RVCDataset(
        str(tmp_path / "port" / "filelist.txt"), hp), batch_size=2, seed=7)
    theirs = jax_data.BucketBatcher(jax_data.RVCDataset(
        str(tmp_path / "jax" / "filelist.txt"), jhp), batch_size=2, seed=7)
    for epoch in range(3):
        assert ours._plans(epoch, 0, 1) == theirs._plans(epoch, 0, 1)
    for got, want in zip(ours.epoch(1), theirs.epoch(1)):
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def tiny_mute_hp(cfg):
    """tests/test_dataset_prep.py:174-185."""
    return cfg.HParams(
        version="v1",
        train=cfg.TrainConfig(segment_size=4800, batch_size=2,
                              fp16_run=False),
        data=cfg.DataConfig(sampling_rate=SR, filter_length=1024,
                            hop_length=480, win_length=1024,
                            n_mel_channels=32),
        model=cfg.ModelConfig(
            inter_channels=32, hidden_channels=32, filter_channels=64,
            n_heads=2, n_layers=1, kernel_size=3,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
            upsample_rates=(10, 48), upsample_initial_channel=32,
            upsample_kernel_sizes=(20, 96), gin_channels=16,
            spk_embed_dim=4))


HP = tiny_mute_hp(config)


def mute_experiment(exp: Path) -> Path:
    """The mute fixtures as a one-utterance experiment (stem `m`)."""
    for sub, src, dst in (("0_gt_wavs", "mute48k.wav", "m.wav"),
                          ("1_16k_wavs", "mute.wav", "m.wav"),
                          ("2a_f0", "mute.wav.npy", "m.wav.npy"),
                          ("2b-f0nsf", "mute.wav.npy", "m.wav.npy"),
                          ("3_feature256", "mute.npy", "m.npy")):
        (exp / sub).mkdir(parents=True)
        shutil.copy(data.MUTE_DIR / sub / src, exp / sub / dst)
    return exp


def train(exp, epochs, logs=None, save_every_epoch=1, **kw):
    return run_training(str(exp), HP, total_epochs=epochs, if_f0=True,
                        save_every_epoch=save_every_epoch, name="mute_test",
                        log_fn=(logs.append if logs is not None else
                                lambda s: None),
                        tensorboard=False, device="cpu", **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """2 epochs with cache_in_hbm (epoch 2 replays epoch 1's batches).
    A native checkpoint holds the full discriminator and its Adam moments
    (660 MB), so the first is removed once seen."""
    exp = mute_experiment(tmp_path_factory.mktemp("mute") / "exp")
    logs = []
    metrics = train(exp, 2, logs, cache_in_hbm=True)
    written = sorted(os.listdir(exp))
    (exp / "state_1.pt").unlink()
    return exp, metrics, logs, written


def test_run_training_on_mute_fixtures(trained):
    exp, metrics, logs, written = trained
    assert np.isfinite(metrics["loss_gen_all"])
    assert any("cached" in s for s in logs), logs
    for f in ("mute_test.pth", "G_1.pth", "G_2.pth", "state_1.pt",
              "state_2.pt"):
        assert f in written, f
    mod, meta = load_synthesizer(str(exp / "mute_test.pth"), "cpu")
    assert meta["version"] == "v1" and meta["info"] == "2epoch"


def test_resume_equals_straight_run(tmp_path):
    """1 epoch, then a resumed run to 2, against 2 epochs straight: the
    same metrics and parameters within 1e-5 relative."""
    straight = mute_experiment(tmp_path / "straight")
    resumed = mute_experiment(tmp_path / "resumed")
    m_straight = train(straight, 2, save_every_epoch=2)
    train(resumed, 1)
    logs = []
    m_resumed = train(resumed, 2, logs, save_every_epoch=2)
    assert any("resumed from" in s for s in logs), logs
    for k, v in m_straight.items():
        np.testing.assert_allclose(m_resumed[k], v, rtol=1e-5, err_msg=k)
    states = []
    for exp in (straight, resumed):
        st = create_train_state(HP, steps_per_epoch=1, device="cpu")
        assert load_native_checkpoint(str(exp / "state_2.pt"), st) == 2
        states.append(st)
    assert states[0].step == states[1].step > 0
    for net in ("net_g", "net_d"):
        a, b = (getattr(s, net).state_dict() for s in states)
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=1e-5, atol=1e-7)
    for f in (straight / "state_2.pt", resumed / "state_1.pt",
              resumed / "state_2.pt"):
        f.unlink()


def test_native_checkpoint_mismatch_raises(trained):
    """A checkpoint of another width raises on a shape, one of another
    layout (the f0-less generator) on its keys."""
    path = str(trained[0] / "state_2.pt")
    wide = dataclasses.replace(HP, model=dataclasses.replace(
        HP.model, hidden_channels=48))
    with pytest.raises(ValueError, match="shape"):
        load_native_checkpoint(path, create_train_state(wide, device="cpu"))
    with pytest.raises(ValueError, match="keys differ"):
        load_native_checkpoint(path, create_train_state(HP, use_f0=False,
                                                        device="cpu"))


def test_g_pth_and_small_model_load_in_jax(trained):
    """The port's G_2.pth through tpu_rvc's reader and converter (weight
    norm kept, enc_q included); its small model converts in tpu_rvc within
    2e-3 of full scale of the port."""
    exp = trained[0]
    ckpt = load_pth(str(exp / "G_2.pth"))
    assert ckpt["iteration"] == 2
    m = HP.model
    params = synthesizer_params_from_state_dict(
        {k: np.asarray(v, np.float32) for k, v in ckpt["model"].items()},
        n_layers=m.n_layers, n_ups=len(m.upsample_rates),
        num_kernels=len(m.resblock_kernel_sizes), use_f0=True,
        has_enc_q=True, fold_weight_norm=False, strict=True)
    assert "enc_q" in params and "v" in params["dec"]["up_0"]

    port, _ = load_synthesizer(str(exp / "mute_test.pth"), "cpu")
    jmod, jvars, meta = jax_load_synthesizer(str(exp / "mute_test.pth"))
    assert meta["version"] == "v1"
    rng = np.random.default_rng(3)
    Tn = 30
    phone = rng.standard_normal((1, Tn, 256)).astype(np.float32)
    pitch = rng.integers(1, 255, (1, Tn)).astype(np.int32)
    pitchf = rng.uniform(100, 300, (1, Tn)).astype(np.float32)
    lens, sid = np.array([Tn], np.int32), np.array([0], np.int32)
    want = np.asarray(jax.jit(functools.partial(
        jmod.apply, method=jmod.infer, deterministic=True))(
            jvars, phone, lens, sid, pitch, pitchf))
    got = port.infer(*(torch.from_numpy(a) for a in (phone, lens, sid, pitch,
                                                     pitchf)),
                     deterministic=True).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 2e-3


def test_warm_start_partial_and_shape_checked(tmp_path):
    """Pretrained G/D in the reference layout: every tensor whose name and
    shape match loads, the torch>=2.1 weight-norm names included; one of
    another shape stays as it was."""
    state = create_train_state(HP, seed=1, device="cpu")
    src = create_train_state(HP, seed=2, device="cpu")
    g = {k: v.clone() for k, v in src.net_g.state_dict().items()}
    key = "dec.ups.0.weight_g"
    g[key.replace("weight_g", "parametrizations.weight.original0")] = \
        g.pop(key)
    g["emb_g.weight"] = torch.zeros(9, HP.model.gin_channels)
    torch.save({"model": g}, tmp_path / "G.pth")
    torch.save({"model": src.net_d.state_dict()}, tmp_path / "D.pth")
    before = state.net_g.emb_g.weight.detach().clone()
    logs = []
    warm_start(state, str(tmp_path / "G.pth"), str(tmp_path / "D.pth"),
               logs.append)
    n_g = len(state.net_g.state_dict())
    assert logs[0].startswith(f"partial load: {n_g - 1}/{n_g}")
    n_d = len(state.net_d.state_dict())
    assert logs[1].startswith(f"partial load: {n_d}/{n_d}")
    own, ref = state.net_g.state_dict(), src.net_g.state_dict()
    for k in own:
        if k == "emb_g.weight":
            assert torch.equal(own[k], before)
        else:
            assert torch.equal(own[k], ref[k]), k
