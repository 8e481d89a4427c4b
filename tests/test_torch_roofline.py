"""tpu_rvc_torch's FLOP and MFU accounting (`utils/roofline.py`, the
kernels' counting context, the graph owners' `last_graph_flops`) and its
`utils/profiling.py`, on the CPU: the kernels' formulas against
`FlopCounterMode` over their plain twins, exactly; `graph_flops` against
the JAX package's at the same shapes; `Synthesizer.infer`'s count against
an analytic count of its products; each graph owner's count against the
sum of its stages' counts; and that a count leaves the next call, the
state and the launch counts as they were."""

import contextlib
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import FlopCounterMode

from tpu_rvc.models.synthesizer import Synthesizer as JaxSynthesizer
from tpu_rvc.utils.roofline import graph_flops as jax_graph_flops

from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
from tpu_rvc_torch.ckpt.uvr5_loader import random_deecho_reference_state
from tpu_rvc_torch.audio.io import save_wav
from tpu_rvc_torch.core import config
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.ops.kernels import (attention_flops, banded_rel_attention,
                                       banded_rel_attention_plain, counting,
                                       fused_resblock, fused_stage,
                                       launch_counts, pack_stage, stage_flops,
                                       stage_plain)
from tpu_rvc_torch.pipeline import rt, uvr5, vc
from tpu_rvc_torch.retrieval.index import FeatureIndex
from tpu_rvc_torch.train.step import create_train_state
from tpu_rvc_torch.utils import profiling, roofline
from tpu_rvc_torch.utils.roofline import (device_peak_tflops, graph_flops,
                                          mfu_fields)

from _torch_parity import (SERVE_GEOMETRY, SMALL_HUBERT, SMALL_SYNTH,
                           hubert_pair, jax_synth_params, reference_state,
                           seeded, serving_world, stream_voice)

# two resblocks a level: the stage kernel (K2); SMALL_SYNTH has one (K3)
K2_SYNTH = dict(SMALL_SYNTH, n_layers=2, resblock_kernel_sizes=(3, 5),
                resblock_dilation_sizes=((1, 3, 5),) * 2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def counted(fn, *args):
    """FlopCounterMode's count of fn(*args), outside the kernels' context."""
    with FlopCounterMode(display=False) as mode:
        fn(*args)
    return mode.get_total_flops()


# ---------------------------------------------------------------------------
# the kernels' formulas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [16, 40])
def test_attention_formula_equals_flop_counter_over_the_twin(T):
    """K1 at (BH 2, T, dk 96): `attention_flops` is exactly what
    FlopCounterMode counts over the plain twin; inside `counting()` the
    wrapper adds it, counts one launch and returns zeros, launching
    nothing."""
    rng = np.random.default_rng(T)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    args = (mk(2, T, 96), mk(2, T, 96), mk(2, T, 96), mk(21, 96),
            mk(21, 96), torch.tensor([T, T - 5], dtype=torch.int32))
    want = attention_flops(2, T, 96, 10)
    assert counted(banded_rel_attention_plain, *args) == want
    before = dict(launch_counts)
    with counting() as count:
        out = banded_rel_attention(*args)
    assert count.flops["banded_rel_attention"] == want
    assert count.launches == {"banded_rel_attention": 1, "fused_stage": 0,
                              "fused_resblock": 0}
    assert torch.equal(out, torch.zeros(2, T, 96))
    assert launch_counts == before


@pytest.mark.parametrize("C,N,ks", [(16, 1, (3, 7, 11)), (16, 8, (3, 7, 11)),
                                    (256, 1, (3, 7, 11)),
                                    (256, 8, (3, 7, 11)), (32, 1, (7,)),
                                    (32, 8, (7,))])
def test_stage_formula_equals_flop_counter_over_the_twin(C, N, ks):
    """K2 (three kernel sizes) at C 16 and 256 and K3 (one), for one
    stream and 8: `stage_flops` is FlopCounterMode's count over
    `stage_plain`; inside `counting()` the wrapper adds it with its 6
    launches a resblock and returns zeros."""
    T = 6
    rng = np.random.default_rng(C + N)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    sw = pack_stage(ks, (1, 3, 5), [[mk(k, C, C) for _ in range(6)]
                                    for k in ks],
                    [[mk(C) for _ in range(6)] for _ in ks])
    x = mk(C, T) if N == 1 else mk(N, C, T)
    want = stage_flops(C, T, ks, N)
    assert counted(stage_plain, x, sw) == want
    name = "fused_stage" if len(ks) > 1 else "fused_resblock"
    before = dict(launch_counts)
    with counting() as count:
        out = (fused_stage if len(ks) > 1 else fused_resblock)(x, sw)
    assert count.flops[name] == want and count.total() == want
    assert count.launches[name] == 6 * len(ks)
    assert torch.equal(out, torch.zeros_like(x))
    assert launch_counts == before


def test_nested_counts_add_up():
    """A count opened inside another adds to it when it closes."""
    x = torch.zeros(2, 16, 96)
    lens = torch.tensor([16, 16], dtype=torch.int32)
    emb = torch.zeros(21, 96)
    with counting() as outer:
        banded_rel_attention(x, x, x, emb, emb, lens)
        with counting() as inner:
            banded_rel_attention(x, x, x, emb, emb, lens)
        assert inner.total() == attention_flops(2, 16, 96)
    assert outer.total() == 2 * attention_flops(2, 16, 96)


# ---------------------------------------------------------------------------
# graph_flops, mfu_fields, device_peak_tflops
# ---------------------------------------------------------------------------


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


@pytest.mark.parametrize("op", ["matmul", "conv1d", "conv_transpose1d"])
def test_graph_flops_matches_the_jax_count(op):
    """The same product in both packages, within the 10% of
    tests/test_aux.py's matmul check (XLA leaves out the padded taps)."""
    dn = ("NCH", "OIH", "NCH")
    if op == "matmul":
        got = graph_flops(torch.matmul, torch.zeros(64, 64),
                          torch.zeros(64, 64))
        want = jax_graph_flops(jax.jit(lambda a, b: a @ b), _sds(64, 64),
                               _sds(64, 64))
    elif op == "conv1d":
        got = graph_flops(functools.partial(torch.nn.functional.conv1d,
                                            padding=2),
                          torch.zeros(2, 8, 100), torch.zeros(16, 8, 5))
        want = jax_graph_flops(jax.jit(
            lambda x, w: jax.lax.conv_general_dilated(
                x, w, (1,), [(2, 2)], dimension_numbers=dn)),
            _sds(2, 8, 100), _sds(16, 8, 5))
    else:
        got = graph_flops(functools.partial(
            torch.nn.functional.conv_transpose1d, stride=4, padding=2),
            torch.zeros(2, 16, 25), torch.zeros(16, 8, 8))
        want = jax_graph_flops(jax.jit(
            lambda x, w: jax.lax.conv_transpose(
                x, w, (4,), [(5, 5)], dimension_numbers=("NCH", "IOH",
                                                         "NCH"))),
            _sds(2, 16, 25), _sds(16, 8, 8))
    print(f"{op}: port {got:.0f}, JAX {want:.0f}, ratio {got / want:.4f}")
    assert want is not None and 0.9 * want <= got <= 1.1 * want


def test_mfu_fields_arithmetic_and_nulls():
    """tests/test_aux.py's checks of the JAX `mfu_fields`, on the port's."""
    flops = 2.0 * 64 ** 3
    out = mfu_fields(flops, 1e-3, peak_tflops=100.0)
    assert out["flops_per_item"] == flops
    assert out["achieved_tflops"] == round(flops / 1e-3 / 1e12, 3)
    assert out["mfu_pct"] == round(100.0 * flops / 1e-3 / 1e12 / 100.0, 2)
    out = mfu_fields(None, 1.0, peak_tflops=100.0, prefix="x_")
    assert out == {"x_flops_per_item": None, "x_achieved_tflops": None,
                   "x_mfu_pct": None}
    out = mfu_fields(1e9, 1.0, peak_tflops=None)
    assert out["achieved_tflops"] == 0.001 and out["mfu_pct"] is None


def test_device_peak_tflops(monkeypatch):
    """None on the CPU and for a card or dtype the table lacks; the H100
    SXM's bf16 and 3xTF32 peaks; TPU_RVC_PEAK_TFLOPS wins."""
    monkeypatch.delenv("TPU_RVC_PEAK_TFLOPS", raising=False)
    assert device_peak_tflops(device="cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    name = ["NVIDIA H100 80GB HBM3"]
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name[0])
    assert device_peak_tflops(torch.bfloat16) == 989.4
    assert device_peak_tflops() == 164.9
    assert device_peak_tflops(torch.int8) is None
    name[0] = "NVIDIA A100-SXM4-80GB"
    assert device_peak_tflops(torch.bfloat16) is None
    monkeypatch.setenv("TPU_RVC_PEAK_TFLOPS", "123.5")
    assert device_peak_tflops() == 123.5
    assert mfu_fields(123.5e12, 1.0)["mfu_pct"] == 100.0


# ---------------------------------------------------------------------------
# Synthesizer.infer against an analytic count and the JAX count
# ---------------------------------------------------------------------------


def infer_flops(c, B, T):
    """The products of `Synthesizer.infer` (B rows of T frames, with f0),
    2 per multiply-add, from the layer shapes: enc_p (the phone
    projection, per layer Q/K/V/O, the banded attention, the FFN's two
    convs, the projection to (m, logs)), four flow couplings (pre, the
    3-layer WN with its conditioning on g, post), the NSF decoder (the
    harmonic merge, conv_pre, its conditioning, per level the upsampler
    counted at its input length, the source's strided conv and the
    resblock stage, then conv_post)."""
    H, F, I = (c["hidden_channels"], c["filter_channels"],
               c["inter_channels"])
    D, G, U = (c["encoder_dim"], c["gin_channels"],
               c["upsample_initial_channel"])
    k, heads, L = c["kernel_size"], c["n_heads"], c["n_layers"]
    rows = B * T

    def mm(n, cin, cout, width=1):
        return 2 * n * cin * cout * width

    enc_p = mm(rows, D, H) + mm(rows, H, 2 * I) + L * (
        4 * mm(rows, H, H) + attention_flops(B * heads, T, H // heads)
        + mm(rows, H, F, k) + mm(rows, F, H, k))
    wn = (mm(B, G, 2 * H * 3) + 3 * mm(rows, H, 2 * H, 5)
          + 2 * mm(rows, H, 2 * H) + mm(rows, H, H))
    flow = 4 * (mm(rows, I // 2, H) + wn + mm(rows, H, I // 2))
    rates = c["upsample_rates"]
    hop = math.prod(rates)
    dec = mm(rows * hop, 1, 1) + mm(rows, I, U, 7) + mm(B, G, U)
    t_in = T
    for i, (r, ku) in enumerate(zip(rates, c["upsample_kernel_sizes"])):
        ch, t_out = U // 2 ** (i + 1), t_in * r
        last = i + 1 == len(rates)
        dec += (mm(B * t_in, 2 * ch, ch, ku)
                + mm(B * t_out, 1, ch, 1 if last else
                     2 * math.prod(rates[i + 1:]))
                + stage_flops(ch, t_out, c["resblock_kernel_sizes"], B))
        t_in = t_out
    return enc_p + flow + dec + mm(rows * hop, ch, 1, 7)


@pytest.mark.parametrize("cfg", [SMALL_SYNTH, K2_SYNTH],
                         ids=["one_resblock", "three_kernel_stage"])
def test_infer_count_is_analytic_and_at_most_the_jax_count(cfg):
    """`graph_flops` of `infer` equals `infer_flops` exactly and is at
    most the JAX package's count of the same `infer` on the same weights
    (XLA also counts the elementwise operations); the ratio is printed."""
    B, T = 2, 24
    sd = reference_state(seeded(Synthesizer, 5, **cfg), 6)
    port = Synthesizer(**cfg).eval()
    port.load_state_dict(synthesizer_state_from_reference(sd))
    rng = np.random.default_rng(8)
    phone = rng.standard_normal((B, T, cfg["encoder_dim"])).astype(
        np.float32)
    pitch = rng.integers(1, 255, (B, T)).astype(np.int32)
    pitchf = rng.uniform(90, 330, (B, T)).astype(np.float32)
    lens, sid = np.asarray([T, T - 5], np.int32), np.asarray([1, 0], np.int32)
    args = (phone, lens, sid, pitch, pitchf)
    got = graph_flops(functools.partial(
        port.infer, noise_scale=0.0, deterministic=True),
        *(torch.from_numpy(a) for a in args))
    assert got == infer_flops(cfg, B, T)
    syn = JaxSynthesizer(**cfg, weight_norm=True)
    want = jax_graph_flops(jax.jit(functools.partial(
        syn.apply, noise_scale=0.0, deterministic=True,
        method=JaxSynthesizer.infer)), jax_synth_params(sd, cfg),
        *(jnp.asarray(a) for a in args))
    print(f"infer: port {got:.0f}, JAX {want:.0f}, ratio {got / want:.4f}")
    assert got <= want


# ---------------------------------------------------------------------------
# the graph owners
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def stages(monkeypatch, *targets):
    """Record every call of each (object, attribute) callable, with clones
    of its tensors, while the block runs; yields the list of calls."""
    calls = []
    def clone(a):
        return a.detach().clone() if torch.is_tensor(a) else a

    with monkeypatch.context() as mp:
        for obj, name in targets:
            fn = getattr(obj, name)

            def record(*a, _fn=fn, **k):
                calls.append((_fn, tree_map(clone, a), tree_map(clone, k)))
                return _fn(*a, **k)
            mp.setattr(obj, name, record)
        yield calls


@torch.no_grad()
def stage_sum(calls):
    """The sum of `graph_flops` over the recorded stages, each alone."""
    return sum(graph_flops(functools.partial(fn, *a, **k))
               for fn, a, k in calls)


@pytest.fixture(scope="module")
def pipe():
    sd = reference_state(seeded(Synthesizer, 31, **SMALL_SYNTH), 32)
    synth = Synthesizer(**SMALL_SYNTH).eval()
    synth.load_state_dict(synthesizer_state_from_reference(sd))
    hub, _ = hubert_pair(SMALL_HUBERT, 33)
    vecs = np.random.default_rng(34).standard_normal((200, 64)).astype(
        np.float32)
    return (vc.Pipeline(16000, hubert=hub, synth=synth, version="v2",
                        device="cpu", x_pad=0.5, x_query=2.0, x_center=5.0,
                        x_max=6.0),
            FeatureIndex(vecs, (vecs * vecs).sum(1)))


def test_pipeline_count_is_the_sum_of_its_stages(pipe, monkeypatch):
    """None before a call; after a 1.7 s conversion (pm, index on), the
    count of the `_full_rows` graph equals the counts of f0, HuBERT, the
    retrieval blend and `infer` called alone at the call's shapes; a count
    leaves the next conversion, the global generator and the launch
    counts as they were."""
    p, index = pipe
    p._last_full_call = None
    assert p.last_graph_flops() is None
    audio = stream_voice(27200, seed=3)
    kw = dict(sid=0, audio=audio, f0_up_key=0, f0_method="pm", index=index,
              index_rate=0.75, if_f0=1, filter_radius=3, resample_sr=0,
              rms_mix_rate=0.25, protect=0.33)
    with stages(monkeypatch, (vc, "device_f0"), (p.hubert, "forward"),
                (vc, "knn_blend"), (p.synth, "infer")) as calls:
        first = p.pipeline(times=[0.0] * 3, **kw)
    assert [c[0].__name__ for c in calls] == ["device_f0", "forward",
                                              "knn_blend", "infer"]
    rng, before = torch.get_rng_state(), dict(launch_counts)
    flops = p.last_graph_flops()
    assert torch.equal(torch.get_rng_state(), rng)
    assert launch_counts == before
    assert flops == stage_sum(calls) > 0
    assert np.array_equal(p.pipeline(times=[0.0] * 3, **kw), first)
    assert p.last_graph_flops() == flops


@pytest.fixture(scope="module")
def engine():
    w = serving_world()
    return rt.RealtimeVC(hubert=w["hub"], synth=w["synth"], version="v2",
                         if_f0=1, index=w["index"], index_rate=0.5,
                         device="cpu")


def stream_graph(engine, n):
    geo = rt.BlockGeometry(**SERVE_GEOMETRY)
    return rt.FusedStreamGraph(
        engine, stream_sr=geo.sr,
        block_frame=geo.block_frame, ctx_frame=2 * geo.zc,
        total_len=geo.total, skip_head=geo.skip_head,
        return_length=geo.return_length, f0method="pm", protect=0.33,
        n_streams=n)


@pytest.mark.parametrize("n", [1, 4])
def test_stream_block_count_is_the_sum_of_its_stages(engine, n, monkeypatch):
    """A block of one stream and a tick of 4 (with a `fed` mask): None
    before a call; the count equals the resampler, f0, HuBERT, the blend
    and `infer` called alone at the block's shapes; a count leaves the
    streams' state, the step counter and the next block as they were (a
    twin graph that was never counted gives the same block)."""
    graph, twin = stream_graph(engine, n), stream_graph(engine, n)
    assert graph.last_graph_flops() is None
    width = graph.block_frame + graph.ctx_frame
    segs = [np.stack([stream_voice(width, seed=10 * b + s)
                      for s in range(n)]) for b in range(3)]
    segs = [s[0] if n == 1 else s for s in segs]
    fed = None if n == 1 else np.array([True, False, True, True])
    state, twin_state = graph.init_state(), twin.init_state()
    with stages(monkeypatch, (rt, "resample_poly"), (rt, "device_f0"),
                (engine.hubert, "forward"), (rt, "knn_blend"),
                (engine.synth, "infer")) as calls:
        _, state = graph(state, segs[0], fed)
    _, twin_state = twin(twin_state, segs[0], fed)
    held = {k: v.clone() for k, v in state.items()}
    step, rng, before = graph._step, torch.get_rng_state(), dict(launch_counts)
    flops = graph.last_graph_flops()
    assert flops == stage_sum(calls) > 0
    assert graph._step == step and launch_counts == before
    assert torch.equal(torch.get_rng_state(), rng)
    assert all(torch.equal(state[k], held[k]) for k in held)
    for seg in segs[1:]:
        out, state = graph(state, seg, fed)
        want, twin_state = twin(twin_state, seg, fed)
        assert np.array_equal(out, want)
    assert all(torch.equal(state[k], twin_state[k]) for k in state)


def test_separation_count_is_the_sum_of_its_stages(tmp_path, monkeypatch):
    """A narrow DeEcho (its LSTM counted by the RNN formula) through
    `DeviceSeparator` on 1 s: None before a call; the count of the last
    bucket's graph equals the resamplers, STFTs, iSTFTs and the net's
    window groups called alone."""
    path = str(tmp_path / "VR-DeEchoNormal_tiny.pth")
    torch.save(random_deecho_reference_state(5, 1344, nout=8, nout_lstm=16),
               path)
    sep = uvr5.load_separator(path, device="cpu")
    sep.window_size = 32
    sep.model.offset = 8
    mix = str(tmp_path / "mix.wav")
    save_wav(mix, stream_voice(44100, seed=4, sr=44100), 44100)
    dev = uvr5.DeviceSeparator(sep, bucket_s=1.0)
    assert dev.last_graph_flops() is None
    with stages(monkeypatch, (uvr5, "resample_poly"), (uvr5, "stft"),
                (uvr5, "istft"), (sep.model, "forward")) as calls:
        ins, _, _ = dev.separate(mix)
    assert sum(c[0] == sep.model.forward for c in calls) >= 1
    lstm = [m for m in sep.model.modules() if isinstance(m, torch.nn.LSTM)]
    assert lstm
    flops = dev.last_graph_flops()
    assert flops == stage_sum(calls) > 0
    assert np.array_equal(dev.separate(mix)[0], ins)


def test_lstm_counted_as_xla_counts_it():
    """The RNN formulas: 2 * 4H * (I + H) a step, row, layer and direction
    for an LSTM (oneDNN's layer op on the CPU), 3H for a GRU."""
    lstm = torch.nn.LSTM(16, 8, num_layers=2, bidirectional=True)
    gru = torch.nn.GRU(16, 8, batch_first=True, bidirectional=True)
    with torch.no_grad():
        assert graph_flops(lstm, torch.zeros(5, 2, 16)) == \
            2 * (2 * 4 * 8 * (16 + 8) * 10) * 2
        assert graph_flops(gru, torch.zeros(2, 5, 16)) == \
            2 * 3 * 8 * (16 + 8) * 10 * 2
    assert torch.ops.aten._cudnn_rnn in roofline.RNN_FLOPS


def test_training_step_count_leaves_the_state(monkeypatch):
    """`TrainState.step_flops` counts one step on a copy: the state's
    weights, optimizer moments and step counter do not move."""
    hp = config.HParams(
        version="v1",
        train=config.TrainConfig(segment_size=1600, batch_size=2,
                                 fp16_run=False),
        data=config.DataConfig(sampling_rate=16000, filter_length=256,
                               hop_length=160, win_length=256,
                               n_mel_channels=32),
        model=config.ModelConfig(
            inter_channels=32, hidden_channels=32, filter_channels=64,
            n_heads=2, n_layers=1, kernel_size=3,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
            upsample_rates=(10, 16), upsample_initial_channel=64,
            upsample_kernel_sizes=(20, 32), gin_channels=16, spk_embed_dim=4))
    state = create_train_state(hp, seed=3, device="cpu")
    state.train_step(batch := train_batch(hp))
    before = {k: v.clone() for k, v in state.net_g.state_dict().items()}
    opt = [t.clone() for s in state.opt_d.state.values() for t in s.values()]
    step = state.step
    flops = state.step_flops(batch)
    assert flops > 0 and state.step == step
    assert all(torch.equal(v, before[k])
               for k, v in state.net_g.state_dict().items())
    assert all(torch.equal(a, b) for a, b in zip(
        opt, [t for s in state.opt_d.state.values() for t in s.values()]))


def train_batch(hp, B=2, T=24):
    rng = np.random.default_rng(5)
    return {
        "phone": rng.standard_normal((B, T, hp.encoder_dim)).astype(
            np.float32),
        "phone_lengths": np.asarray([T, 19], np.int32),
        "pitch": rng.integers(1, 255, (B, T)).astype(np.int32),
        "pitchf": rng.uniform(100, 300, (B, T)).astype(np.float32),
        "spec": rng.standard_normal((B, T, hp.data.spec_channels)).astype(
            np.float32),
        "spec_lengths": np.asarray([T, 19], np.int32),
        "wave": rng.standard_normal(
            (B, T * hp.data.hop_length, 1)).astype(np.float32) * 0.1,
        "sid": np.zeros((B,), np.int32),
    }


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(None):
        torch.ones(4).sum()
    out = tmp_path / "trace"
    with profiling.device_trace(str(out)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(out / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
