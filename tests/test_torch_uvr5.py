"""tpu_rvc_torch's UVR5 separation against tpu_rvc's on the CPU: the two VR
nets, the band pyramid, the host and device separators, `load_separator`
on `.pth` files that torch.save wrote (MDX-Net is in
tests/test_torch_mdxnet.py),
the `separate` app, and the device rule.  The same random weights in the
reference layout go through both packages' loaders; each test prints its
reading beside its limit."""

import os
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_rvc.ckpt.uvr5_loader import (cascaded_aspp_params_from_torch,
                                      deecho_params_from_torch)
from tpu_rvc.models import uvr5 as jax_nets
from tpu_rvc.pipeline import uvr5 as jax_uvr5

from tpu_rvc_torch.audio.io import load_wav, save_wav
from tpu_rvc_torch.ckpt.uvr5_loader import (
    cascaded_aspp_state_from_reference, deecho_state_from_reference,
    random_cascaded_aspp_reference_state, random_deecho_reference_state)
from tpu_rvc_torch.models.uvr5 import CascadedASPPNet, CascadedNetDeEcho
from tpu_rvc_torch.pipeline import mdxnet, uvr5

REPO = Path(__file__).resolve().parent.parent
SR = 44100
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_state(sd):
    return {k: v.numpy() for k, v in sd.items()}


def rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-12))


def make_mix(seconds=1.0, seed=7):
    """Two tones and noise, mono, float32."""
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * 440 * t)
            + 0.2 * np.sin(2 * np.pi * 1320 * t)
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


class World:
    """The random HP weights written as HP5/HP3 `.pth` files, a 1 s mix, and
    each package's separator loaded from them by `load_separator` with a
    32-frame window and an 8-frame offset (the full 512/128 runs a
    0.6 TFLOP window), the results cached for the module's tests."""

    def __init__(self, tmp: Path):
        self.tmp = tmp
        sd = random_cascaded_aspp_reference_state(0, 1344)
        self.paths = {name: str(tmp / f"{name}_random.pth")
                      for name in ("HP5", "HP3")}
        for p in self.paths.values():
            torch.save(sd, p)
        self.mix = str(tmp / "mix.wav")
        save_wav(self.mix, make_mix(), SR)
        self.seps = {}
        self._host = {}

    def pair(self, name, tta):
        """(port separator, JAX separator) for the model `name`."""
        if name not in self.seps:
            port = uvr5.load_separator(self.paths[name], device=CPU)
            port.window_size = 32
            port.model.offset = 8
            ref = jax_uvr5.load_separator(self.paths[name])
            ref.window_size = 32
            ref.model = ref.model.clone(offset=8)
            self.seps[name] = (port, ref)
        port, ref = self.seps[name]
        port.tta = ref.tta = tta
        return port, ref

    def host(self, name, tta):
        """Both packages' `UVR5Separator.separate` of the mix."""
        if (name, tta) not in self._host:
            port, ref = self.pair(name, tta)
            self._host[name, tta] = (port.separate(self.mix),
                                     ref.separate(self.mix))
        return self._host[name, tta]

    def device(self):
        """The port's `DeviceSeparator.separate` of the mix: HP3, TTA on,
        bucket 1 s, 8 windows a call."""
        if not hasattr(self, "_device"):
            port, _ = self.pair("HP3", True)
            self._device = uvr5.DeviceSeparator(port, bucket_s=1.0).separate(
                self.mix)
        return self._device


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("uvr5"))


# ---------------------------------------------------------------------------
# the nets
# ---------------------------------------------------------------------------


def jax_apply(net, params, x):
    """The JAX net, jitted, on NCHW `x` at aggressiveness (0.1, 60) ->
    NCHW numpy."""
    fn = jax.jit(lambda p, x: net.apply({"params": p}, x,
                                        aggressiveness=(0.1, 60)))
    out = fn(params, jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    return np.transpose(np.asarray(out), (0, 3, 1, 2))


def test_cascaded_aspp_matches_jax():
    n_fft, T = 256, 96
    sd = random_cascaded_aspp_reference_state(3, n_fft)
    net = CascadedASPPNet(n_fft).eval()
    net.load_state_dict(cascaded_aspp_state_from_reference(sd))
    x = np.abs(np.random.default_rng(0).standard_normal(
        (1, 2, n_fft // 2 + 1, T))).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x), (0.1, 60)).numpy()
    want = jax_apply(jax_nets.CascadedASPPNet(n_fft=n_fft),
                     cascaded_aspp_params_from_torch(numpy_state(sd)), x)
    err = np.abs(got - want).max()
    print(f"CascadedASPPNet: max abs {err:.3g} (limit 1e-4) at a peak of "
          f"{np.abs(want).max():.3g}")
    assert np.abs(want).max() > 0.5 and err <= 1e-4


def test_deecho_net_matches_jax():
    """F 129 against T 64, so a swap of the (freq, time) dilation pairs
    would show."""
    n_fft, T = 256, 64
    sd = random_deecho_reference_state(4, n_fft, nout=16, nout_lstm=32)
    assert any(".dec1.conv1." in k for k in sd) and "aux_out.weight" in sd
    net = CascadedNetDeEcho(n_fft, nout=16, nout_lstm=32).eval()
    net.load_state_dict(deecho_state_from_reference(sd))
    x = np.abs(np.random.default_rng(3).standard_normal(
        (1, 2, n_fft // 2 + 1, T))).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x), (0.1, 60)).numpy()
    want = jax_apply(jax_nets.CascadedNetDeEcho(n_fft=n_fft, nout=16,
                                                nout_lstm=32),
                     deecho_params_from_torch(numpy_state(sd)), x)
    err = np.abs(got - want).max()
    print(f"CascadedNetDeEcho: max abs {err:.3g} (limit 1e-4) at a peak of "
          f"{np.abs(want).max():.3g}")
    assert np.abs(want).max() > 0.5 and err <= 1e-4


# ---------------------------------------------------------------------------
# the band pyramid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["mirroring", "mirroring2"])
def test_band_pyramid_matches_jax(mode):
    mp = uvr5.ModelParameters("4band_v2.json")
    jmp = jax_uvr5.ModelParameters("4band_v2.json")
    assert mp.param == jmp.param
    t = np.arange(SR) / SR
    wave = np.stack([np.sin(2 * np.pi * 440 * t),
                     0.5 * np.sin(2 * np.pi * 3300 * t)]).astype(np.float32)
    p = mp.param
    bands_n = len(p["band"])
    waves, specs, jspecs = {bands_n: wave}, {}, {}
    for d in range(bands_n, 0, -1):
        bp = p["band"][d]
        if d < bands_n:
            waves[d] = uvr5._resample(waves[d + 1], p["band"][d + 1]["sr"],
                                      bp["sr"])
        specs[d] = uvr5._stft_stereo(waves[d], bp["n_fft"], bp["hl"],
                                     torch.device(CPU))
        jspecs[d] = jax_uvr5._stft_stereo(waves[d], bp["n_fft"], bp["hl"])
        err = rel_l2(specs[d], jspecs[d])
        print(f"band {d} STFT: relative L2 {err:.3g} (limit 1e-5)")
        assert err <= 1e-5
    spec_m = uvr5.combine_spectrograms(specs, mp)
    jspec_m = jax_uvr5.combine_spectrograms(jspecs, jmp)
    err = rel_l2(spec_m, jspec_m)
    print(f"combined: relative L2 {err:.3g} (limit 1e-5)")
    assert spec_m.shape == (2, p["bins"] + 1, spec_m.shape[2]) and err <= 1e-5

    top = p["band"][bands_n]
    he_h = (top["n_fft"] // 2 - top["crop_stop"]) + (
        p["pre_filter_stop"] - p["pre_filter_start"])
    ihe = specs[bands_n][:, top["n_fft"] // 2 - he_h: top["n_fft"] // 2]
    # a masked spectrum, so that the mirror and the input differ
    masked = spec_m * np.linspace(0.2, 1.0, spec_m.shape[1])[None, :, None]
    he = uvr5.mirroring(mode, masked, ihe, p["pre_filter_start"])
    jhe = jax_uvr5.mirroring(mode, masked, ihe, p["pre_filter_start"])
    err = rel_l2(he, jhe)
    print(f"{mode}: relative L2 {err:.3g} (limit 1e-5)")
    assert err <= 1e-5
    for extra in ((), (he_h, he)):
        got = uvr5.cmb_spectrogram_to_wave(masked, mp, torch.device(CPU),
                                           *extra)
        want = jax_uvr5.cmb_spectrogram_to_wave(masked, jmp, *extra)
        err = rel_l2(got, want)
        print(f"waves ({'with' if extra else 'without'} the high end): "
              f"relative L2 {err:.3g} (limit 1e-5)")
        assert got.shape == want.shape and err <= 1e-5


# ---------------------------------------------------------------------------
# the separators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,tta", [("HP5", False), ("HP3", True)])
def test_host_separator_matches_jax(world, name, tta):
    """TTA off on the HP5 name; TTA on and the outputs swapped on HP3's."""
    (ins, voc, sr), (jins, jvoc, jsr) = world.host(name, tta)
    assert sr == jsr == SR and ins.shape == jins.shape
    assert world.pair(name, tta)[0].is_reverse == (name == "HP3")
    for got, want, what in ((ins, jins, "instrument"), (voc, jvoc, "vocal")):
        err = np.abs(got - want).max()
        print(f"{name} tta={tta} {what}: max abs {err:.3g} of full scale "
              f"(limit 1e-4), peak {np.abs(want).max():.3g}")
        assert np.abs(want).max() > 0.05 and err <= 1e-4


def test_device_separator_matches_jax(world):
    """Bucket 1 s, TTA on, outputs swapped: int16 within 2 LSB."""
    ins, voc, sr = world.device()
    _, ref = world.pair("HP3", True)
    jins, jvoc, jsr = jax_uvr5.DeviceSeparator(ref, bucket_s=1.0).separate(
        world.mix)
    assert sr == jsr and ins.dtype == np.int16 and ins.shape == jins.shape
    for got, want, what in ((ins, jins, "instrument"), (voc, jvoc, "vocal")):
        lsb = int(np.abs(got.astype(np.int32) - want).max())
        print(f"device separator {what}: {lsb} LSB (limit 2), "
              f"{int(np.count_nonzero(got != want))} of {got.size} samples "
              "differ")
        assert np.abs(want).max() > 1000 and lsb <= 2


def test_device_separator_matches_host_path(world):
    """The device path resamples with the windowed sinc, the host path with
    scipy: relative L2 < 0.05, the JAX package's own bound."""
    (ins_h, voc_h, _), _ = world.host("HP3", True)
    ins_d, voc_d, _ = world.device()
    n = min(len(ins_h), len(ins_d))
    assert n > 0.9 * SR
    for a, b, what in ((ins_h, ins_d, "instrument"), (voc_h, voc_d, "vocal")):
        err = rel_l2(b[:n] / 32768.0, a[:n])
        print(f"device against host {what}: relative L2 {err:.4f} "
              "(limit 0.05)")
        assert err < 0.05


def test_device_separator_unfetched_in_window_groups(world):
    """`fetch=False` gives the device tensors and the true length; 2
    windows a call (the TTA pass has 7) give the int16 output of 8."""
    ins, voc, sr = world.device()
    port, _ = world.pair("HP3", True)
    i2, v2, sr2, n2 = uvr5.DeviceSeparator(port, bucket_s=1.0,
                                           group=2).separate(world.mix,
                                                             fetch=False)
    assert torch.is_tensor(i2) and i2.dtype == torch.int16 and sr2 == sr
    assert n2 == len(ins) and 0 < n2 <= i2.shape[0]
    np.testing.assert_array_equal(i2[:n2].numpy(), ins)
    np.testing.assert_array_equal(v2[:n2].numpy(), voc)


# ---------------------------------------------------------------------------
# load_separator, the app, the parameter files and the device rule
# ---------------------------------------------------------------------------


def write_tiny_deecho(path, seed=5):
    torch.save(random_deecho_reference_state(seed, 1344, nout=8,
                                             nout_lstm=16), path)


def test_load_separator_dispatch(world, tmp_path):
    hp5 = uvr5.load_separator(world.paths["HP5"], device=CPU)
    assert isinstance(hp5, uvr5.UVR5Separator) and not hp5.is_reverse
    assert isinstance(hp5.model, CascadedASPPNet)
    assert hp5.model.max_bin * 2 == 1344 and hp5.mp.param["bins"] == 672
    assert uvr5.load_separator(world.paths["HP3"], device=CPU).is_reverse

    de = str(tmp_path / "VR-DeEchoDeReverb.pth")
    write_tiny_deecho(de)
    sep = uvr5.load_separator(de, device=CPU)
    jsep = jax_uvr5.load_separator(de)
    assert isinstance(sep.model, CascadedNetDeEcho) and sep.is_reverse
    assert sep.mp.param == jsep.mp.param
    assert sep.mp.param == uvr5.ModelParameters("4band_v3.json").param
    assert sep.mp.param != hp5.mp.param
    assert (sep.model.max_bin * 2, sep.model.out.in_channels) == (
        jsep.model.n_fft, jsep.model.nout) == (1344, 8)
    assert sep.model.stg1_low_band_net[0].lstm_dec2.lstm.hidden_size == 8

    onnx_dir = tmp_path / "onnx_dereverb_By_FoxJoy"
    onnx_dir.mkdir()
    with pytest.raises(FileNotFoundError):
        uvr5.load_separator(str(onnx_dir), device=CPU)
    (onnx_dir / "vocals.onnx").write_bytes(mdxnet.conv_tdf_onnx(c=2))
    for path in (str(onnx_dir), str(onnx_dir / "vocals.onnx")):
        assert isinstance(uvr5.load_separator(path, device=CPU),
                          mdxnet.MDXNetDereverb)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_separate_app(tmp_path, engine):
    """`python -m tpu_rvc_torch.apps.separate --device cpu` writes the JAX
    CLI's file names with the library's output, sample for sample."""
    model = str(tmp_path / "VR-DeEchoNormal_tiny.pth")
    write_tiny_deecho(model)
    src = str(tmp_path / "x.wav")
    save_wav(src, make_mix(0.5, seed=9), SR)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "tpu_rvc_torch.apps.separate", "--model",
         model, "--input", src, "--device", "cpu", "--engine", engine,
         "--vocal-dir", str(tmp_path / "voc"), "--ins-dir",
         str(tmp_path / "ins")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0 and "x.wav -> Success" in out.stdout, \
        out.stdout + out.stderr

    sep = uvr5.load_separator(model, device=CPU)
    runner = sep if engine == "host" else uvr5.DeviceSeparator(sep)
    ins, voc, sr = runner.separate(src)
    for sub, stem, want in (("ins", "instrument", ins), ("voc", "vocal", voc)):
        lib = str(tmp_path / f"{stem}_lib.wav")
        save_wav(lib, want, sr)
        got, got_sr = load_wav(str(tmp_path / sub / f"{stem}_x.wav.wav"))
        ref, _ = load_wav(lib)
        assert got_sr == sr and np.abs(ref).max() > 0
        np.testing.assert_array_equal(got, ref)


def test_params_are_the_port_own_copy(tmp_path):
    """The 23 parameter files are byte-equal to the JAX package's, and the
    package data of pyproject.toml carries them: `ModelParameters` reads
    them from an installed-style copy of the package alone."""
    ours = sorted(uvr5.PARAMS_DIR.glob("*.json"))
    theirs = sorted((REPO / "tpu_rvc" / "assets" / "uvr5_params")
                    .glob("*.json"))
    assert uvr5.PARAMS_DIR.resolve().is_relative_to(REPO / "tpu_rvc_torch")
    assert [p.name for p in ours] == [p.name for p in theirs]
    assert len(ours) == 23
    assert all(a.read_bytes() == b.read_bytes() for a, b in zip(ours, theirs))

    pkg = REPO / "tpu_rvc_torch"
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["tpu_rvc_torch"]
    site = tmp_path / "site"
    for src in [*pkg.rglob("*.py"), *(f for g in globs for f in pkg.glob(g))]:
        dst = site / "tpu_rvc_torch" / src.relative_to(pkg)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, dst)
    code = ("import tpu_rvc_torch.pipeline.uvr5 as u\n"
            "assert u.PARAMS_DIR.is_relative_to(%r)\n"
            "print(u.ModelParameters('4band_v2.json').param['bins'],"
            " len(u.ModelParameters('4band_v3.json').param['band']))\n"
            % str(site))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(site)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["672", "4"]


def test_entry_points_default_to_cuda(world):
    """Without a device argument the separation entry points mean CUDA and
    raise on a machine without it."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        uvr5.load_separator(world.paths["HP5"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        uvr5.UVR5Separator(CascadedASPPNet(256),
                           uvr5.ModelParameters("4band_v2.json"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mdxnet.MDXNetDereverb(str(world.tmp), model_fn=lambda s: s)


def test_cudnn_autotune_restores_the_flag():
    from tpu_rvc_torch.core.device import cudnn_autotune

    saved = torch.backends.cudnn.benchmark
    with cudnn_autotune():
        assert torch.backends.cudnn.benchmark
    assert torch.backends.cudnn.benchmark == saved
