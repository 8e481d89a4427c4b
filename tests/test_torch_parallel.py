"""Conversion across devices in tpu_rvc_torch against tpu_rvc, on the CPU:
replicas, `batch_convert` (B utterances as one batch) and `convert_long`
(one long utterance's chunks as rows), with one set of small weights in
both packages (tests/_torch_parity.py).  The JAX side runs on its 8
virtual devices (tests/conftest.py); the port rehearses 1-4 shards by
naming the CPU more than once, and a replica on "cpu:0", which it takes
for another device than "cpu".  Deterministic pipelines (noise_scale 0)
hold the port to tpu_rvc; noisy ones hold each batched row to the single
conversion with the same seed."""

import numpy as np
import pytest
import torch

from tpu_rvc.core.mesh import make_mesh as jax_make_mesh
from tpu_rvc.f0.rmvpe import RMVPE as JaxRMVPE
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.models.synthesizer import Synthesizer as JaxSynthesizer
from tpu_rvc.parallel import batch_convert as jax_batch_convert
from tpu_rvc.parallel import convert_long as jax_convert_long
from tpu_rvc.pipeline.vc import Pipeline as JaxPipeline
from tpu_rvc.retrieval.index import FeatureIndex as JaxIndex

from tpu_rvc_torch.audio.dsp import highpass_filter
from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
from tpu_rvc_torch.core.mesh import make_mesh, replicas
from tpu_rvc_torch.f0.rmvpe import RMVPE
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.parallel import (batch_convert, convert_long,
                                    make_batch_graph)
from tpu_rvc_torch.parallel import chunks
from tpu_rvc_torch.pipeline.vc import (Pipeline, _bucket, _feat_frames,
                                       silence_chunk_bounds)
from tpu_rvc_torch.retrieval.index import FeatureIndex

from _torch_parity import (SMALL_HUBERT, SMALL_SYNTH, TINY, e2e_pair,
                           hubert_pair, jax_synth_params, reference_state,
                           seeded)

SR = 16000
# small chunk geometry: 11 s -> 2 cuts -> 3 chunks
# (tests/test_parallel_infer.py:69-73)
LONG = dict(x_pad=0.5, x_query=1.0, x_center=4.0, x_max=5.0)
FULL_SCALE = 2e-3    # port against tpu_rvc, of int16 full scale
B = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def long_voice(seconds=11.0):
    """tests/test_parallel_infer.py's amplitude-modulated 220 Hz tone."""
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            * (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t))).astype(np.float32)


def tone(f0, seconds=1.0):
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    sd = reference_state(seeded(Synthesizer, 71, **SMALL_SYNTH), 72)
    synth = Synthesizer(**SMALL_SYNTH).eval()
    synth.load_state_dict(synthesizer_state_from_reference(sd))
    hub, jax_hub_vars = hubert_pair(SMALL_HUBERT, 73)
    vecs = np.random.default_rng(74).standard_normal((200, 64)).astype(
        np.float32)
    e2e, je2e, je2e_vars = e2e_pair(TINY, 75)
    jrmvpe = JaxRMVPE(variables=je2e_vars)
    jrmvpe.model = je2e
    return dict(synth=synth, hub=hub, e2e=e2e,
                index=FeatureIndex(vecs, (vecs * vecs).sum(1)),
                jax_synth=JaxSynthesizer(**SMALL_SYNTH, weight_norm=True),
                jax_synth_vars=jax_synth_params(sd, SMALL_SYNTH),
                jax_hub=JaxHubert(**SMALL_HUBERT), jax_hub_vars=jax_hub_vars,
                jax_rmvpe=jrmvpe,
                jax_index=JaxIndex(vecs, (vecs * vecs).sum(1)))


def port_pipeline(w, deterministic=True, **geometry):
    kw = dict(noise_scale=0.0, deterministic=True) if deterministic else {}
    pipe = Pipeline(SR, hubert=w["hub"], synth=w["synth"], version="v2",
                    device="cpu", **kw, **geometry)
    pipe.f0_gen._estimators["rmvpe"] = RMVPE(model=w["e2e"], device="cpu")
    return pipe


@pytest.fixture(scope="module")
def pipes(world):
    """(JAX, port) deterministic pipelines with the long-file geometry."""
    w = world
    jax_pipe = JaxPipeline(
        SR, hubert=w["jax_hub"], hubert_vars=w["jax_hub_vars"],
        synth=w["jax_synth"], synth_vars=w["jax_synth_vars"], version="v2",
        noise_scale=0.0, deterministic=True, **LONG)
    jax_pipe.f0_gen._estimators["rmvpe"] = w["jax_rmvpe"]
    return jax_pipe, port_pipeline(w, **LONG)


def full_scale_err(got, want):
    assert got.dtype == np.int16 and want.dtype == np.int16
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / 32768)


def lsb_share(got, want, lsb):
    assert got.shape == want.shape
    return float(np.mean(np.abs(got.astype(np.int32) - want) <= lsb))


# ---------------------------------------------------------------------------
# replicas (the mesh itself is held in tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------


def test_replicas_are_made_once(world):
    """A shard on the pipeline's own device reuses it; another device gets
    a replica with copied weights, made once and kept; it converts what
    the pipeline converts."""
    pipe = port_pipeline(world, x_pad=0.5)
    mesh = make_mesh(devices=["cpu", "cpu:0"])
    first = replicas(pipe, mesh)
    again = replicas(pipe, mesh)
    assert first[0] is pipe and first[1] is not pipe
    assert again[1] is first[1]
    rep = first[1]
    assert rep.device == torch.device("cpu", 0)
    assert rep.synth is not pipe.synth and rep.hubert is not pipe.hubert
    assert rep.f0_gen._estimators["rmvpe"].model is not \
        pipe.f0_gen._estimators["rmvpe"].model
    x = torch.as_tensor(np.stack([np.pad(tone(200.0), (8000, 8000),
                                         mode="reflect")]))
    args = (0.0, [0], True, None, 0.0, 0.33, 0.25)
    want = pipe._full_rows(x, *args, [pipe._generator(0)], "rmvpe")
    got = rep._full_rows(x, *args, [rep._generator(0)], "rmvpe")
    print("replica max |diff| (LSB):",
          int((got.int() - want.int()).abs().max()))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# batch_convert
# ---------------------------------------------------------------------------


def padded_batch(pipe):
    rows = [tone(180.0 + 25 * i) for i in range(B)]
    return np.stack([np.pad(r, (pipe.t_pad, pipe.t_pad), mode="reflect")
                     for r in rows])


BATCH_KW = dict(f0_method="pm", index_rate=0.75, rms_mix_rate=0.25,
                protect=0.33)


@pytest.fixture(scope="module")
def jax_batch(world, pipes):
    """tpu_rvc's batch_convert of the B rows on its 8-device mesh."""
    jax_pipe, port_pipe = pipes
    batch = padded_batch(port_pipe)
    out = jax_batch_convert(jax_pipe, batch, np.zeros(B, np.int32),
                            jax_make_mesh(n_data=8), index=world["jax_index"],
                            **BATCH_KW)
    return batch, np.asarray(out)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_batch_convert_matches_jax(world, pipes, jax_batch, n_shards):
    """Port rows on 1 and 4 CPU shards against tpu_rvc's on 8 devices:
    int16 within 1 LSB on more than 99.9% of samples."""
    _, port_pipe = pipes
    batch, want = jax_batch
    got = batch_convert(port_pipe, batch, np.zeros(B, np.int32),
                        make_mesh(devices=["cpu"] * n_shards),
                        index=world["index"], **BATCH_KW)
    share = lsb_share(got, want, 1)
    print(f"{n_shards} shard(s): {got.shape}, within 1 LSB {share:.6f}, "
          f"max {full_scale_err(got, want):.2e} of full scale")
    assert got.shape == want.shape and share > 0.999


def test_batch_convert_rows_draw_their_seed(world):
    """With noise on, row i is the single conversion (`_full`) seeded
    noise_seed + i, as the JAX rows use PRNGKey(noise_seed + i)."""
    pipe = port_pipeline(world, deterministic=False, x_pad=0.5)
    batch = padded_batch(pipe)[:4]
    got = batch_convert(pipe, batch, np.zeros(4, np.int32),
                        make_mesh(devices=["cpu"] * 2), f0_method="rmvpe",
                        noise_seed=11)
    shares = []
    for i in range(4):
        one = pipe._full(torch.as_tensor(batch[i]), 0.0, 0, True, None, 0.0,
                         0.33, 0.25, pipe._generator(11 + i), "rmvpe").numpy()
        shares.append(lsb_share(got[i], one, 1))
    other = pipe._full(torch.as_tensor(batch[1]), 0.0, 0, True, None, 0.0,
                       0.33, 0.25, pipe._generator(11), "rmvpe").numpy()
    print("rows within 1 LSB of their single conversions:", shares,
          "| row 1 against seed 11:", lsb_share(got[1], other, 1))
    assert min(shares) > 0.999
    assert lsb_share(got[1], other, 1) < 0.9   # the seed matters


def test_make_batch_graph_is_batch_convert(world):
    """The JAX package's batch-graph name: batch_convert over the mesh for
    rows of the length it was made for, bit for bit; other rows raise."""
    pipe = port_pipeline(world, x_pad=0.5)
    batch = padded_batch(pipe)[:2]
    mesh = make_mesh(devices=["cpu"] * 2)
    run = make_batch_graph(pipe, batch.shape[1], mesh)
    got = run(batch, [0, 0], f0_method="rmvpe", noise_seed=3)
    want = batch_convert(pipe, batch, [0, 0], mesh, f0_method="rmvpe",
                         noise_seed=3)
    print("make_batch_graph rows equal batch_convert's:",
          np.array_equal(got, want))
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="rows of"):
        run(batch[:, :-160], [0, 0])


def test_batch_convert_refusals(world, tmp_path, monkeypatch):
    """FCPE without its checkpoint raises (the JAX package runs pm there
    without a word), as do a host-only f0 method and a batch that does
    not divide over the data axis."""
    pipe = port_pipeline(world, x_pad=0.5)
    batch = padded_batch(pipe)[:2]
    monkeypatch.chdir(tmp_path)   # no assets/fcpe/ here
    with pytest.raises(FileNotFoundError, match="FCPE"):
        batch_convert(pipe, batch, [0, 0], make_mesh(devices=["cpu"]),
                      f0_method="fcpe")
    with pytest.raises(FileNotFoundError, match="FCPE"):
        convert_long(port_pipeline(world, **LONG), 0, long_voice(), make_mesh(
            devices=["cpu"]), f0_method="fcpe")
    with pytest.raises(ValueError, match="no fused device variant"):
        batch_convert(pipe, batch, [0, 0], make_mesh(devices=["cpu"]),
                      f0_method="dio")
    with pytest.raises(ValueError, match="not divisible"):
        batch_convert(pipe, batch, [0, 0], make_mesh(devices=["cpu"] * 3))
    print("fcpe without weights, dio and 2 rows over 3 shards refused")


# ---------------------------------------------------------------------------
# convert_long
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f0_method,with_index,resample_sr", [
    ("pm", True, 0), ("pm", False, 22050), ("rmvpe", True, 22050),
    ("rmvpe", False, 0), ("dio", False, 0), ("dio", True, 22050)])
def test_convert_long_matches_jax(world, pipes, f0_method, with_index,
                                  resample_sr):
    """The 11 s input in 3 chunks against tpu_rvc's convert_long on 8
    devices (3 chunks and 5 filler rows there, 3 rows on one CPU shard
    here): within 2e-3 of full scale."""
    jax_pipe, port_pipe = pipes
    audio = long_voice()
    assert len(silence_chunk_bounds(audio, port_pipe.t_center,
                                    port_pipe.t_query, port_pipe.t_max)) == 2
    kw = dict(f0_method=f0_method, index_rate=0.75 if with_index else 0.0,
              resample_sr=resample_sr, rms_mix_rate=0.25, protect=0.33)
    want = np.asarray(jax_convert_long(
        jax_pipe, 0, audio.copy(), jax_make_mesh(n_data=8),
        index=world["jax_index"] if with_index else None, **kw))
    got = convert_long(port_pipe, 0, audio.copy(),
                       make_mesh(devices=["cpu"]),
                       index=world["index"] if with_index else None, **kw)
    err = full_scale_err(got, want)
    print(f"convert_long {f0_method} index={with_index} "
          f"resample={resample_sr}: {got.shape}, {err:.2e} of full scale")
    assert err < FULL_SCALE


def common_bucket_samples(pipe, audio):
    """Output sample indices of the chunks whose own bucket is the common
    one: there the sequential path draws the noise the rows draw
    (tests/test_parallel_infer.py:96-110 compares those)."""
    hop = int(np.prod(pipe.synth.upsample_rates))
    bounds = silence_chunk_bounds(highpass_filter(audio), pipe.t_center,
                                  pipe.t_query, pipe.t_max)
    n_pad = len(audio) + 2 * pipe.t_pad
    starts = [0] + [t // 160 * 160 for t in bounds]
    lens = [t + pipe.t_pad2 + 160 - s for s, t in zip(starts, starts[1:])]
    lens.append(n_pad - starts[-1])
    common = _bucket(max(lens))
    p_len_static = min(common // 160, _feat_frames(common))
    idx, pos = [], 0
    for n in lens:
        size = min(n // 160, p_len_static) * hop - 2 * pipe.t_pad_tgt
        if _bucket(n) == common:
            idx.append(np.arange(pos, pos + size))
        pos += size
    return np.concatenate(idx)


def test_convert_long_matches_sequential(world, monkeypatch):
    """With noise on: the chunks whose bucket is the common one agree with
    the port's sequential pipeline within 4 LSB on more than 99.9% of
    samples (tests/test_parallel_infer.py's rule); 3 shards against 1,
    and one row a call against ROWS_PER_CALL, within 1 LSB."""
    pipe = port_pipeline(world, deterministic=False, **LONG)
    audio = long_voice()
    kw = dict(f0_method="pm", rms_mix_rate=1.0, protect=0.33, noise_seed=5)
    par = convert_long(pipe, 0, audio.copy(), make_mesh(devices=["cpu"]),
                       **kw)
    seq = pipe.pipeline(0, audio.copy(), [0.0] * 3, 0, "pm", None, 0.0, 1,
                        3, 0, 1.0, 0.33, noise_seed=5)
    idx = common_bucket_samples(pipe, audio)
    share = lsb_share(par[idx], seq[idx], 4)
    three = convert_long(pipe, 0, audio.copy(),
                         make_mesh(devices=["cpu"] * 3), **kw)
    monkeypatch.setattr(chunks, "ROWS_PER_CALL", 1)
    single_rows = convert_long(pipe, 0, audio.copy(),
                               make_mesh(devices=["cpu"]), **kw)
    print(f"parallel vs sequential: {idx.size} of {par.size} samples in "
          f"the common bucket, within 4 LSB {share:.6f}; 3 shards vs 1: "
          f"{lsb_share(three, par, 1):.6f}; 1 row a call vs 4: "
          f"{lsb_share(single_rows, par, 1):.6f}")
    assert par.shape == seq.shape and idx.size > 0 and share > 0.999
    assert np.abs(par).max() > 0
    assert lsb_share(three, par, 1) > 0.999
    assert lsb_share(single_rows, par, 1) > 0.999


def test_convert_long_short_input_is_sequential(world):
    """Audio that fits one chunk takes the sequential path, the same
    conversion bit for bit."""
    pipe = port_pipeline(world, **LONG)
    audio = long_voice(3.0)
    got = convert_long(pipe, 0, audio, make_mesh(devices=["cpu"] * 2),
                       f0_method="pm", rms_mix_rate=0.25)
    want = pipe.pipeline(0, audio, [0.0] * 3, 0, "pm", None, 0.0, 1, 3, 0,
                         0.25, 0.33)
    print("short input:", got.shape, "equal:", np.array_equal(got, want))
    assert np.array_equal(got, want)
