"""tpu_rvc_torch's model-file tools against tpu_rvc's on the CPU: the
base16384 codec and the hash's numpy half bit for bit, the model hash of
one small model through both packages' deterministic pipelines, the
small-model writer's key set with and without a hash, merge / extract /
change_info with bit-equal fp16 weights and each package reading the
other's files, and every `model_tools` subcommand through its `main`."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpu_rvc.ckpt import hash as jax_hash
from tpu_rvc.ckpt import small_model as jax_small
from tpu_rvc.core.config import hparams_for as jax_hparams_for
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.models.loader import load_synthesizer as jax_load_synthesizer
from tpu_rvc.models.synthesizer import Synthesizer as JaxSynthesizer
from tpu_rvc.pipeline.vc import Pipeline as JaxPipeline
from tpu_rvc.utils import base16384 as jax_b16

from tpu_rvc_torch.apps import model_tools
from tpu_rvc_torch.ckpt import hash as port_hash
from tpu_rvc_torch.ckpt import small_model
from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
from tpu_rvc_torch.core.config import hparams_for
from tpu_rvc_torch.models.loader import load_synthesizer
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.pipeline.vc import Pipeline
from tpu_rvc_torch.utils import base16384

from _torch_parity import (SMALL_HUBERT, SMALL_SYNTH, hubert_pair,
                           jax_synth_params, reference_state, seeded)

CONFIG = [SMALL_SYNTH[k] for k in (
    "spec_channels", "segment_size", "inter_channels", "hidden_channels",
    "filter_channels", "n_heads", "n_layers", "kernel_size", "p_dropout",
    "resblock")] + [
    list(SMALL_SYNTH["resblock_kernel_sizes"]),
    [list(d) for d in SMALL_SYNTH["resblock_dilation_sizes"]],
    list(SMALL_SYNTH["upsample_rates"]), SMALL_SYNTH["upsample_initial_channel"],
    list(SMALL_SYNTH["upsample_kernel_sizes"]), SMALL_SYNTH["spk_embed_dim"],
    SMALL_SYNTH["gin_channels"], SMALL_SYNTH["sr"]]


def small_hp(hparams_for_fn):
    """Either package's HParams with SMALL_SYNTH's widths and rates."""
    hp = hparams_for_fn("v2", 40000)
    m = dataclasses.replace(hp.model, **{
        k: SMALL_SYNTH[k] for k in (
            "inter_channels", "hidden_channels", "filter_channels",
            "n_heads", "n_layers", "kernel_size", "p_dropout", "resblock",
            "resblock_kernel_sizes", "resblock_dilation_sizes",
            "upsample_rates", "upsample_initial_channel",
            "upsample_kernel_sizes", "spk_embed_dim", "gin_channels")})
    d = dataclasses.replace(hp.data, sampling_rate=SMALL_SYNTH["sr"],
                            filter_length=2 * (SMALL_SYNTH["spec_channels"]
                                               - 1))
    return dataclasses.replace(hp, model=m, data=d)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# base16384 and the hash's numpy half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(14))
def test_base16384_matches_jax(n):
    """Every remainder length 0-6, twice: the same string, and both
    decoders give the bytes back from either encoder."""
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    s = base16384.encode_to_string(data)
    assert s == jax_b16.encode_to_string(data)
    assert base16384.decode_from_string(s) == data
    assert jax_b16.decode_from_string(s) == data
    assert base16384.decode_from_string(jax_b16.encode_to_string(data)) == data


def _wave(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(48000) / 16000
    return (np.sin(2 * np.pi * (120 + 40 * seed) * t)
            + 0.2 * rng.standard_normal(48000)).astype(np.float64)


@pytest.mark.parametrize("seed", range(3))
def test_wave_hash_similarity_id_match_jax(seed):
    h = port_hash.wave_hash(_wave(seed))
    assert h == jax_hash.wave_hash(_wave(seed))
    assert port_hash.hash_id(h) == jax_hash.hash_id(h)
    other = port_hash.wave_hash(_wave(seed + 1))
    assert port_hash.hash_similarity(h, other) == \
        jax_hash.hash_similarity(h, other)
    assert port_hash.hash_similarity(h, h) == 1.0


# ---------------------------------------------------------------------------
# the model hash
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    sd = reference_state(seeded(Synthesizer, 71, **SMALL_SYNTH), 72)
    hub, jax_hub_vars = hubert_pair(SMALL_HUBERT, 73)
    return sd, hub, jax_hub_vars


def _port_synth(sd):
    net = Synthesizer(**SMALL_SYNTH).eval()
    net.load_state_dict(synthesizer_state_from_reference(sd))
    return net


def _differing_words(h1, h2):
    a = np.frombuffer(base16384.decode_from_string(h1), ">i2")
    b = np.frombuffer(base16384.decode_from_string(h2), ">i2")
    return int((a != b).sum())


# One model's hash through two sound paths agrees to 0.999256-0.999978
# (port against JAX on the CPU 0.999648; card against CPU on the full-width
# model, chip_smoke.py M3); a 1% scale of conv_post reads about 0.9977 and
# another seed's model 0.483-0.488 (511 of 512 words differ).
SAME_MODEL = 0.998


def _deterministic_hash(synth, hub):
    pipe = Pipeline(16000, hubert=hub, synth=synth, version="v2", x_pad=1.0,
                    noise_scale=0.0, deterministic=True, device="cpu")
    return port_hash.model_hash(pipe, 1)


def test_model_hash_matches_jax_deterministic(weights):
    """Both deterministic pipelines (no prior or source noise) hash the
    bundled clip through its precomputed track: similarity >= SAME_MODEL,
    equal strings if rounding makes them so; the port's hash repeats
    exactly.  Another seed's model and a 1% change of one weight both
    read below the gate."""
    sd, hub, jax_hub_vars = weights
    jax_pipe = JaxPipeline(
        16000, hubert=JaxHubert(**SMALL_HUBERT), hubert_vars=jax_hub_vars,
        synth=JaxSynthesizer(**SMALL_SYNTH, weight_norm=True),
        synth_vars=jax_synth_params(sd, SMALL_SYNTH), version="v2",
        x_pad=1.0, noise_scale=0.0, deterministic=True)
    want = jax_hash.model_hash(jax_pipe, 1)
    got = _deterministic_hash(_port_synth(sd), hub)
    assert _deterministic_hash(_port_synth(sd), hub) == got
    sim = port_hash.hash_similarity(got, want)
    n_diff = _differing_words(got, want)
    other = _deterministic_hash(_port_synth(reference_state(
        seeded(Synthesizer, 74, **SMALL_SYNTH), 75)), hub)
    sim_other = port_hash.hash_similarity(got, other)
    nudged = _port_synth(sd)
    with torch.no_grad():
        nudged.dec.conv_post.weight.mul_(1.01)
    sim_nudged = port_hash.hash_similarity(
        got, _deterministic_hash(nudged, hub))
    print(f"model hash port vs JAX: similarity {sim}, {n_diff} of 512 int16 "
          f"words differ; another model {sim_other}, conv_post x 1.01 "
          f"{sim_nudged}")
    assert sim >= SAME_MODEL
    assert sim_other < SAME_MODEL and sim_nudged < SAME_MODEL
    if n_diff == 0:
        assert got == want


def test_model_hash_noise_is_drawn_on_the_cpu(weights):
    """With noise on, the port's hash repeats and asks the pipeline for its
    draws on a CPU generator, whatever the pipeline's device."""
    sd, hub, _ = weights
    pipe = Pipeline(16000, hubert=hub, synth=_port_synth(sd), version="v2",
                    x_pad=1.0, device="cpu")
    seen = []
    inner = pipe._generator

    def spy(seed, device=None):
        seen.append((seed, device))
        return inner(seed, device)

    pipe._generator = spy
    h1 = port_hash.model_hash(pipe, 1)
    assert port_hash.model_hash(pipe, 1) == h1
    assert seen and all(s == (port_hash.NOISE_SEED, torch.device("cpu"))
                        for s in seen)


def _write_small(path, sd, spk=None, author="", info="random"):
    w = {k: torch.from_numpy(v).half() for k, v in sd.items()}
    cfg = list(CONFIG)
    if spk is not None:
        w["emb_g.weight"] = torch.from_numpy(np.random.default_rng(spk).
                                             standard_normal((spk, 16))).half()
        cfg[-3] = spk
    opt = {"weight": w, "config": cfg, "info": info, "sr": "40k", "f0": 1,
           "version": "v2", "name": os.path.basename(path)}
    if author:
        opt["author"] = author
    torch.save(opt, path)
    return path


def test_save_small_model_key_set_matches_jax(weights, tmp_path,
                                              monkeypatch):
    """With a HuBERT the port writes `hash` and `id`; without one `hash` is
    None and there is no `id`: the JAX writer's key set in both cases."""
    sd, hub, _ = weights
    hp, jhp = small_hp(hparams_for), small_hp(jax_hparams_for)
    state = {k: torch.from_numpy(v) for k, v in sd.items()}
    np_state = {k: np.asarray(v) for k, v in sd.items()}

    def keys(path):
        return list(torch.load(path, weights_only=False))

    port_none = small_model.save_small_model(
        state, "40k", 1, "m", 3, "v2", hp, out_path=str(tmp_path / "a.pth"))
    jax_none = jax_small.save_small_model(
        np_state, "40k", 1, "m", 3, "v2", jhp,
        out_path=str(tmp_path / "b.pth"))
    assert keys(port_none) == keys(jax_none)
    assert torch.load(port_none, weights_only=False)["hash"] is None

    port_h = small_model.save_small_model(
        state, "40k", 1, "m", 3, "v2", hp, out_path=str(tmp_path / "c.pth"),
        hubert=hub)
    cpt = torch.load(port_h, weights_only=False)
    assert len(base16384.decode_from_string(cpt["hash"])) == 1024
    assert cpt["id"] == port_hash.hash_id(cpt["hash"])
    monkeypatch.setattr(jax_hash, "model_hash_ckpt", lambda c: cpt["hash"])
    jax_h = jax_small.save_small_model(
        np_state, "40k", 1, "m", 3, "v2", jhp,
        out_path=str(tmp_path / "d.pth"))
    assert keys(port_h) == keys(jax_h)
    assert torch.load(jax_h, weights_only=False)["id"] == cpt["id"]


# ---------------------------------------------------------------------------
# merge, extract, change_info
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_models(weights, tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    sd, _, _ = weights
    sd2 = reference_state(seeded(Synthesizer, 74, **SMALL_SYNTH), 75)
    return (_write_small(str(d / "a.pth"), sd, author="ann"),
            _write_small(str(d / "b.pth"), sd2, author="bo"),
            _write_small(str(d / "c.pth"), sd2, spk=3, author="ann"))


def _same_weights(p1, p2):
    w1 = torch.load(p1, weights_only=False)["weight"]
    w2 = torch.load(p2, weights_only=False)["weight"]
    assert sorted(w1) == sorted(w2)
    for k in w1:
        a, b = torch.as_tensor(w1[k]), torch.as_tensor(w2[k])
        assert a.dtype == b.dtype == torch.float16, k
        assert torch.equal(a, b), k


def _same_meta(p1, p2):
    m1 = {k: v for k, v in torch.load(p1, weights_only=False).items()
          if k not in ("weight", "timestamp")}
    m2 = {k: v for k, v in torch.load(p2, weights_only=False).items()
          if k not in ("weight", "timestamp")}
    assert m1 == m2


def _cross_read(port_path, jax_path):
    """Each package loads the other's file; the port converts the same
    from both."""
    jax_load_synthesizer(port_path)
    a, _ = load_synthesizer(port_path, "cpu")
    b, _ = load_synthesizer(jax_path, "cpu")
    rng = np.random.default_rng(5)
    T = 16
    args = (torch.from_numpy(rng.standard_normal((1, T, 64)).astype(
        np.float32)), torch.tensor([T]), torch.tensor([0]),
        torch.from_numpy(rng.integers(1, 255, (1, T))),
        torch.from_numpy(rng.uniform(100, 300, (1, T)).astype(np.float32)))
    assert torch.equal(a.infer(*args, deterministic=True),
                       b.infer(*args, deterministic=True))


@pytest.mark.parametrize("second,alpha", [("b", 0.3), ("c", 0.5)])
def test_merge_matches_jax(two_models, tmp_path, second, alpha):
    """fp32 sum rounded once to fp16, bit for bit with the JAX merge; the
    author line; with a 3-speaker second model the min-shape emb_g."""
    a, b, c = two_models
    other = b if second == "b" else c
    args = (a, other, alpha, "40k", 1, "merged info", "mm", "v2")
    port = small_model.merge(*args, out_path=str(tmp_path / "p.pth"))
    jax = jax_small.merge(*args, out_path=str(tmp_path / "j.pth"))
    _same_weights(port, jax)
    _same_meta(port, jax)
    cpt = torch.load(port, weights_only=False)
    assert cpt["author"] == ("ann & bo" if second == "b" else "ann")
    assert cpt["weight"]["emb_g.weight"].shape[0] == 2
    _cross_read(port, jax)


def test_merge_refuses_other_architectures(two_models, tmp_path):
    a, b, _ = two_models
    cpt = torch.load(b, weights_only=False)
    cpt["weight"].pop("dec.conv_post.weight")
    bad = str(tmp_path / "bad.pth")
    torch.save(cpt, bad)
    for merge in (small_model.merge, jax_small.merge):
        with pytest.raises(ValueError, match="architectures"):
            merge(a, bad, 0.5, "40k", 1, "", "x", "v2",
                  out_path=str(tmp_path / "x.pth"))


def test_extract_and_change_info_match_jax(weights, tmp_path):
    """A G_*.pth (fp32 "model" dict with enc_q) -> the same fp16 small
    model from both packages; change_info rewrites `info` alone."""
    sd, _, _ = weights
    g = {k: torch.from_numpy(v) for k, v in sd.items()}
    g["enc_q.pre.weight"] = torch.zeros(4, 4, 1)
    g_path = str(tmp_path / "G_7.pth")
    torch.save({"model": g, "iteration": 7, "learning_rate": 1e-4}, g_path)
    hp, jhp = hparams_for("v2", 40000), jax_hparams_for("v2", 40000)
    port = small_model.extract_small_model(
        g_path, "ex", "40k", 1, "", "v2", hp, out_path=str(tmp_path / "p.pth"),
        author="ann")
    jax = jax_small.extract_small_model(
        g_path, "ex", "40k", 1, "", "v2", jhp,
        out_path=str(tmp_path / "j.pth"), author="ann")
    _same_weights(port, jax)
    _same_meta(port, jax)
    assert "enc_q.pre.weight" not in torch.load(port, weights_only=False)[
        "weight"]
    assert torch.load(port, weights_only=False)["info"] == "extracted"

    out_p = small_model.change_info(port, "new words", "", str(tmp_path))
    assert out_p == port
    (tmp_path / "jd").mkdir()
    out_j = jax_small.change_info(jax, "new words", "p.pth",
                                  str(tmp_path / "jd"))
    _same_weights(out_p, out_j)
    _same_meta(out_p, out_j)
    assert torch.load(out_p, weights_only=False)["info"] == "new words"


# ---------------------------------------------------------------------------
# the model_tools app
# ---------------------------------------------------------------------------

def test_model_tools_subcommands(two_models, weights, tmp_path, capsys):
    a, b, _ = two_models
    sd, _, _ = weights
    main = model_tools.main
    main(["info", a])
    out = capsys.readouterr().out
    n = sum(v.size for v in sd.values())
    assert f"{n / 1e6:.1f}M params" in out and "author: ann" in out
    merged = str(tmp_path / "m.pth")
    main(["merge", a, b, "--alpha", "0.25", "--name", "mm", "--output",
          merged])
    ref = jax_small.merge(a, b, 0.25, "40k", 1, "", "mm", "v2",
                          out_path=str(tmp_path / "j.pth"))
    _same_weights(merged, ref)
    g_path = str(tmp_path / "G_1.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               g_path)
    ex = str(tmp_path / "ex.pth")
    main(["extract", g_path, "--sr", "48k", "--output", ex])
    assert torch.load(ex, weights_only=False)["config"][-1] == 48000
    main(["change-info", ex, "--info", "hello", "--name", "ex2.pth",
          "--out-dir", str(tmp_path)])
    assert torch.load(str(tmp_path / "ex2.pth"),
                      weights_only=False)["info"] == "hello"
    stripped = str(tmp_path / "s.pth")
    main(["strip", g_path, stripped])
    s = torch.load(stripped, weights_only=False)
    assert s.keys() == sd.keys() and all(v.dtype == torch.float16
                                         for v in s.values())
    main(["similarity", a, b])
    assert "carries no hash" in capsys.readouterr().out
    hashed = []
    for path, seed in ((a, 0), (b, 1)):
        cpt = torch.load(path, weights_only=False)
        cpt["hash"] = port_hash.wave_hash(_wave(seed))
        hashed.append(str(tmp_path / f"h{seed}.pth"))
        torch.save(cpt, hashed[-1])
    main(["similarity", *hashed])
    want = port_hash.hash_similarity(port_hash.wave_hash(_wave(0)),
                                     port_hash.wave_hash(_wave(1)))
    assert f"similarity: {want}" in capsys.readouterr().out
    onnx = str(tmp_path / "m.onnx")
    main(["export-onnx", merged, onnx, "--frames", "12", "--device", "cpu"])
    assert os.path.getsize(onnx) > 0
