"""tpu_rvc_torch's MDX-Net dereverb against tpu_rvc's on the CPU: the
Conv-TDF spectrogram pair, demix through an ONNX graph on each package's
executor, the Conv-TDF clone at the published dims on both executors,
and `MDXNetDereverb`'s audio path.  (The VR nets and separators are in
tests/test_torch_uvr5.py.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_rvc.models import onnx_exec as jax_exec
from tpu_rvc.pipeline import mdxnet as jax_mdx

from tpu_rvc_torch.audio.io import load_wav, save_wav
from tpu_rvc_torch.models.onnx_exec import OnnxModule
from tpu_rvc_torch.pipeline import mdxnet

from test_torch_uvr5 import CPU, SR, make_mix, rel_l2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# MDX-Net
# ---------------------------------------------------------------------------


def small_spec_pair():
    dims = dict(dim_f=1024, dim_t=6, n_fft=2048, hop=512)
    return mdxnet.ConvTDFSpec(**dims), jax_mdx.ConvTDFSpec(**dims)


def test_conv_tdf_spec_matches_jax():
    spec, jspec = small_spec_pair()
    x = np.random.default_rng(5).standard_normal(
        (2, 2, spec.chunk_size)).astype(np.float32)
    packed = spec.stft(torch.from_numpy(x))
    want = np.asarray(jspec.stft(jnp.asarray(x)))
    err = rel_l2(packed.numpy(), want)
    print(f"ConvTDFSpec.stft: relative L2 {err:.3g} (limit 1e-5)")
    assert packed.shape == (2, 4, 1024, 64) and err <= 1e-5
    back = spec.istft(packed).numpy()
    want = np.asarray(jspec.istft(jnp.asarray(packed.numpy())))
    err = rel_l2(back, want)
    print(f"ConvTDFSpec.istft: relative L2 {err:.3g} (limit 1e-5)")
    assert back.shape == x.shape and err <= 1e-5


def test_mdx_demix_through_onnx_matches_jax(tmp_path):
    """A near-identity conv graph written by the JAX exporter, run by each
    package's executor inside its own demix (tests/test_uvr5.py's graph)."""
    from tpu_rvc.ckpt.jax2onnx import export_fn_to_onnx

    spec, jspec = small_spec_pair()
    w_np = 0.01 * np.random.RandomState(0).randn(4, 4, 3, 3)
    w_np[:, :, 1, 1] += np.eye(4)

    def model(w, x):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), [(1, 1), (1, 1)],
            dimension_numbers=("NCHW", "OIHW", "NCHW"))

    gen = spec.chunk_size - 2 * spec.trim
    n_windows = (SR + gen - SR % gen) // gen
    path = str(tmp_path / "vocals.onnx")
    with open(path, "wb") as f:
        f.write(export_fn_to_onnx(
            model, jnp.asarray(w_np, jnp.float32),
            [jnp.zeros((n_windows, 4, spec.dim_f, spec.dim_t), jnp.float32)],
            ["input"], ["output"]))
    mix = np.stack([np.sin(2 * np.pi * 440 * np.arange(SR) / SR),
                    make_mix()]).astype(np.float32) * 0.5
    got = mdxnet.MDXPredictor(OnnxModule.from_file(path, device=CPU), spec,
                              chunks=1, margin=4410, device=CPU).demix(mix)
    want = jax_mdx.MDXPredictor(jax_exec.OnnxModule.from_file(path), jspec,
                                chunks=1, margin=4410).demix(mix)
    err = np.abs(got - want).max()
    print(f"demix through the ONNX graph: max abs {err:.3g} (limit 1e-5), "
          f"peak {np.abs(want).max():.3g}")
    assert got.shape == (1,) + mix.shape and err <= 1e-5


def test_conv_tdf_clone_on_both_executors(tmp_path):
    """The Conv-TDF clone at the published dims (dim_f 3072, 512 frames)
    with the published op inventory, through both executors."""
    path = str(tmp_path / "vocals.onnx")
    with open(path, "wb") as f:
        f.write(mdxnet.conv_tdf_onnx(c=4))
    mod = OnnxModule.from_file(path, device=CPU)
    ops = {n.op_type for n in mod.graph.nodes}
    assert {"Conv", "ConvTranspose", "BatchNormalization", "Relu", "MatMul",
            "Add", "Concat", "Transpose"} <= ops
    x = np.random.default_rng(6).standard_normal(
        (1, 4, 3072, 512)).astype(np.float32)
    got = mod(x).numpy()
    want = np.asarray(jax_exec.OnnxModule.from_file(path)(jnp.asarray(x)))
    err = np.abs(got - want).max()
    print(f"Conv-TDF clone: max abs {err:.3g} (limit 1e-5), peak "
          f"{np.abs(want).max():.3g}")
    assert got.shape == x.shape and np.abs(want).max() > 0.1 and err <= 1e-5


def test_mdx_dereverb_path_audio_matches_jax(tmp_path):
    """`_path_audio_` on 1 s with the same stand-in model on both sides;
    without `vocals.onnx` the facade raises FileNotFoundError."""
    with pytest.raises(FileNotFoundError):
        mdxnet.MDXNetDereverb(str(tmp_path / "missing"), device=CPU)
    src = str(tmp_path / "song.wav")
    save_wav(src, make_mix(), SR)
    for pkg, kw in ((mdxnet, dict(device=CPU)), (jax_mdx, {})):
        pkg.MDXNetDereverb(model_fn=lambda s: s * 0.5, **kw)._path_audio_(
            src, str(tmp_path / pkg.__name__ / "voc"),
            str(tmp_path / pkg.__name__ / "ins"))
    for kind in ("voc/vocal", "ins/instrument"):
        sub, stem = kind.split("/")
        got, sr = load_wav(str(tmp_path / mdxnet.__name__ / sub /
                               f"{stem}_song.wav.wav"))
        want, _ = load_wav(str(tmp_path / jax_mdx.__name__ / sub /
                               f"{stem}_song.wav.wav"))
        lsb = np.abs(got - want).max() * 32768
        print(f"MDXNetDereverb {stem}: {lsb:.0f} LSB (limit 1)")
        assert sr == SR and got.shape == want.shape and lsb <= 1.0
