"""The tpu_rvc_torch offline conversion against tpu_rvc's, end to end on
the CPU: same weights (one seeded reference-layout state_dict loaded by
both packages), same audio, pm f0 and top-8 retrieval on, deterministic
with noise_scale 0.  The gate is ROADMAP A.10's: int16 outputs of equal
length within MCD 0.1 dB (tpu_rvc.utils.mcd)."""

import numpy as np
import pytest
import torch

from tpu_rvc.ckpt.torch_pth import save_pth
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.models.synthesizer import Synthesizer as JaxSynthesizer
from tpu_rvc.pipeline.vc import VC as JaxVC
from tpu_rvc.pipeline.vc import Pipeline as JaxPipeline
from tpu_rvc.retrieval.index import FeatureIndex as JaxIndex
from tpu_rvc.utils.mcd import mcd

from tpu_rvc_torch.audio.io import save_wav
from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
from tpu_rvc_torch.f0.fcpe import FCPE
from tpu_rvc_torch.models.fcpe import CFNaiveMelPE
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.pipeline.vc import VC, Pipeline
from tpu_rvc_torch.retrieval.index import FeatureIndex
from tpu_rvc_torch.utils import timing

from _torch_parity import (SMALL_HUBERT, SMALL_SYNTH, hubert_pair,
                           jax_synth_params, reference_state, seeded)

SR = 16000
GEOMETRY = dict(x_pad=0.5, x_query=2.0, x_center=5.0, x_max=6.0)
SMALL_CONFIG = [129, 32, 32, 32, 64, 2, 1, 3, 0.0, "1", [3], [[1, 3, 5]],
                [10, 16], 64, [20, 32], 2, 16, 16000]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes, and
    torch's default pool in each of them oversubscribes the cores (this
    file's small operations ran 5-25x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def voice(dur, seed=0):
    """A gliding two-harmonic tone with a little noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(SR * dur)) / SR
    ph = 2 * np.pi * np.cumsum(180 + 40 * np.sin(2 * np.pi * 0.5 * tt)) / SR
    x = 0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)
    return (x + 0.005 * rng.standard_normal(tt.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    sd = reference_state(seeded(Synthesizer, 31, **SMALL_SYNTH), 32)
    port_synth = Synthesizer(**SMALL_SYNTH).eval()
    port_synth.load_state_dict(synthesizer_state_from_reference(sd))
    port_hub, jax_hub_vars = hubert_pair(SMALL_HUBERT, 33)
    vecs = np.random.default_rng(34).standard_normal((200, 64)).astype(
        np.float32)
    return dict(sd=sd, port_synth=port_synth, port_hub=port_hub,
                jax_synth=JaxSynthesizer(**SMALL_SYNTH, weight_norm=True),
                jax_synth_vars=jax_synth_params(sd, SMALL_SYNTH),
                jax_hub=JaxHubert(**SMALL_HUBERT), jax_hub_vars=jax_hub_vars,
                port_index=FeatureIndex(vecs, (vecs * vecs).sum(1)),
                jax_index=JaxIndex(vecs, (vecs * vecs).sum(1)))


@pytest.fixture(scope="module")
def pipelines(models):
    m = models
    jax_pipe = JaxPipeline(
        SR, hubert=m["jax_hub"], hubert_vars=m["jax_hub_vars"],
        synth=m["jax_synth"], synth_vars=m["jax_synth_vars"], version="v2",
        noise_scale=0.0, deterministic=True, **GEOMETRY)
    port_pipe = Pipeline(SR, hubert=m["port_hub"], synth=m["port_synth"],
                         version="v2", noise_scale=0.0, deterministic=True,
                         device="cpu", **GEOMETRY)
    return jax_pipe, port_pipe


def assert_same_conversion(got, want):
    assert got.dtype == np.int16 and want.dtype == np.int16
    assert got.shape == want.shape
    got, want = got.astype(np.float64) / 32768, want.astype(np.float64) / 32768
    assert mcd(got, want, SR) < 0.1
    # and sample-level agreement, far inside what MCD can see
    assert np.abs(got - want).max() < 2e-3


@pytest.mark.parametrize("dur,rms_mix_rate", [(2.0, 0.25), (7.0, 0.5)])
def test_pipeline_matches_jax(models, pipelines, dur, rms_mix_rate):
    """2 s takes the fused single-chunk path, 7 s (over x_max = 6 s) the
    silence-chunked path with its host RMS mix."""
    jax_pipe, port_pipe = pipelines
    audio = voice(dur, seed=int(dur))
    if dur > 6:
        audio[3 * SR: 3 * SR + 800] = 0  # a quiet notch for the splitter
    args = (0, 1, 3, 0, rms_mix_rate, 0.33)
    want = jax_pipe.pipeline(0, audio, [0.0] * 3, 0, "pm",
                             models["jax_index"], 0.75, *args[1:])
    times = [0.0] * 3
    got = port_pipe.pipeline(0, audio, times, 0, "pm", models["port_index"],
                             0.75, *args[1:])
    assert_same_conversion(got, want)
    assert times[2] > 0


def test_vc_get_vc_from_pth_matches_jax(models, tmp_path, monkeypatch):
    """VC.get_vc on a small-model .pth written by tpu_rvc's save_pth (fp16
    weights, weight norm as (g, v)), then vc_single: the same conversion
    as tpu_rvc's VC given the same HuBERT."""
    mp = str(tmp_path / "m.pth")
    save_pth({"weight": {k: w.astype(np.float16)
                         for k, w in models["sd"].items()},
              "config": SMALL_CONFIG, "sr": "40k", "f0": 1, "version": "v2",
              "info": "t"}, mp)
    wav = str(tmp_path / "in.wav")
    save_wav(wav, voice(1.5, seed=3), SR)

    jvc = JaxVC(hubert_path="random", x_pad=0.5)
    jvc.get_vc(mp, hubert=models["jax_hub"],
               hubert_vars=models["jax_hub_vars"])
    vc = VC(hubert_path="random", x_pad=0.5, device="cpu")
    meta = vc.get_vc(mp, hubert=models["port_hub"])
    assert meta["version"] == "v2" and vc.tgt_sr == SR and vc.n_spk == 2
    for v in (jvc, vc):
        v.pipeline.noise_scale, v.pipeline.deterministic = 0.0, True
    kw = dict(f0_method="pm", index_rate=0.75, rms_mix_rate=0.25)
    _, (sr_j, want) = jvc.vc_single(0, wav, index=models["jax_index"], **kw)
    info, (sr, got) = vc.vc_single(0, wav, index=models["port_index"], **kw)
    assert sr == sr_j == SR and info.startswith("npy:")
    assert_same_conversion(got, np.asarray(want))

    # dio and harvest convert on the host path, fcpe with an estimator
    # given; crepe without weights and fcpe without its checkpoint raise
    for method in ("dio", "harvest"):
        info, (sr, out) = vc.vc_single(0, wav, **dict(kw, f0_method=method))
        assert sr == SR and out.dtype == np.int16 and out.shape == got.shape
        assert np.abs(out).max() > 0 and info.startswith("npy:")
    monkeypatch.chdir(tmp_path)   # no assets/fcpe/ here
    with pytest.raises(ValueError, match="CREPE requires weights"):
        vc.vc_single(0, wav, f0_method="crepe")
    with pytest.raises(FileNotFoundError, match="fcpe"):
        vc.vc_single(0, wav, f0_method="fcpe")
    vc.pipeline.f0_gen._estimators["fcpe"] = FCPE(model=CFNaiveMelPE(
        hidden_dims=32, n_layers=1), device="cpu")
    _, (_, out) = vc.vc_single(0, wav, **dict(kw, f0_method="fcpe"))
    assert out.shape == got.shape and np.abs(out).max() > 0
    # rmvpe is ported: its default call needs the checkpoint and says so
    vc.pipeline.f0_gen.rmvpe_root = tmp_path / "no_rmvpe"
    with pytest.raises(FileNotFoundError):
        vc.vc_single(0, wav)
    report = vc.vc_multi(0, [wav], str(tmp_path / "out"), f0_method="pm")
    assert "Success" in report, report


def test_conversion_runs_in_fp32_with_stage_spans(models, pipelines):
    """TF32 is off for cuDNN and cuBLAS inside a conversion and the
    caller's flags come back after it; the stage spans of a CPU pipeline
    read the host clock, and the host's own stages have spans."""
    _, port_pipe = pipelines
    seen = []

    def record(*_):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))

    hooks = [m.register_forward_pre_hook(record)
             for m in (models["port_hub"], models["port_synth"].dec)]
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    timing.enable()
    try:
        port_pipe.pipeline(0, voice(1.0), [0.0] * 3, 0, "pm", None, 0.0, 1,
                           3, 0, 0.25, 0.33)
        stages = timing.read()
    finally:
        timing.disable()
        for h in hooks:
            h.remove()
    assert seen == [(False, False)] * 2
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before
    names = {"split", "upload", "f0", "hubert", "enc_p", "flow", "decoder",
             "fetch"}
    assert set(stages) == names | {"host." + n for n in names}
    assert all(ms > 0 for ms in stages.values())


def test_pipeline_device_rule(models):
    """Models given on the CPU move to the pipeline's device; a pipeline
    asked for CUDA on a machine without it raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Pipeline(SR, hubert=models["port_hub"], synth=models["port_synth"],
                 device="cuda")
