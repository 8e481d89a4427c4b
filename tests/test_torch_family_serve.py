"""tpu_rvc_torch's multi-stream serving at the model family's geometries
against tpu_rvc's (JAX) on the CPU: `SlotScheduler` block for block, as
tests/test_torch_serve.py `test_slot_scheduler_matches_jax_scheduler`
holds the 16 kHz model (the same script of uneven submits, an underrun,
a detach and a re-attach, on one hand-advanced clock; every collected
piece of the same length and within 2e-3 of full scale, stats equal
after every tick), in two cases:

  v1_32k   a narrow v1 model with f0 (pm): five decoder levels (C = 16
           at the second), HuBERT's final_proj tap (256-d), 32 kHz
           clients, 2 slots;
  v2_40k   a narrow f0-less v2 model at 40k's decoder geometry served to
           48 kHz clients (the graph resamples 40 to 48 kHz), 2 slots.

Each package's scheduler runs the script on its own: the JAX one in a
spawned process (its graph's trace holds the interpreter lock), from
the same seeded weights.  Also: the plain batched stage at C = 16 and at
T % 4 != 0 equals the stacked single streams."""

import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.pipeline import rt as jax_rt
from tpu_rvc.pipeline import serve as jax_serve

from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.ops.kernels import stage_plain
from tpu_rvc_torch.pipeline import rt, serve

from _torch_inputs import stage_inputs, stage_weights
from _torch_parity import (SERVE_HUBERT, SERVE_SYNTH,
                           DeterministicJaxSynthesizer, FakeClock,
                           hubert_pair, jax_synth_params, reference_state,
                           seeded, stream_voice)

TOL = 2e-3
# (version, use_f0, the model's rate, upsample rates and kernels, clients)
KINDS = {
    "v1_32k": ("v1", True, 32000, (10, 4, 2, 2, 2), (16, 16, 4, 4, 4),
               32000),
    "v2_40k": ("v2", False, 40000, (10, 10, 2, 2), (16, 16, 4, 4), 48000),
}
GEOMETRY = dict(block_time=0.16, crossfade_time=0.04, extra_time=0.64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family_world(kind, seed=71):
    """Both packages' models of the kind from one set of weights: a
    narrow synthesizer with the preset's decoder geometry and its three
    resblocks (the upsamplers 30x their initialisation, as
    `_torch_parity.serving_world` scales them), and HuBERT with the
    version's tap."""
    version, use_f0, sr, ups, kernels, _ = KINDS[kind]
    cfg = dict(SERVE_SYNTH, upsample_rates=ups, upsample_kernel_sizes=kernels,
               upsample_initial_channel=64, resblock_kernel_sizes=(3, 7, 11),
               resblock_dilation_sizes=((1, 3, 5),) * 3, sr=sr,
               encoder_dim=256 if version == "v1" else 64, use_f0=use_f0)
    net = seeded(Synthesizer, seed, **cfg)
    with torch.no_grad():
        for up in net.dec.ups:
            up.weight.mul_(30.0)
    sd = reference_state(net, seed + 1)
    synth = Synthesizer(**cfg).eval()
    synth.load_state_dict(synthesizer_state_from_reference(sd))
    hub_cfg = (dict(SERVE_HUBERT, final_proj=True, final_dim=256)
               if version == "v1" else SERVE_HUBERT)
    hub, jax_hub_vars = hubert_pair(hub_cfg, seed + 2)
    return dict(cfg=cfg, hub_cfg=hub_cfg, synth=synth, hub=hub, sd=sd,
                jax_hub_vars=jax_hub_vars)


def engine_args(kind):
    version, use_f0 = KINDS[kind][:2]
    return dict(version=version, if_f0=int(use_f0))


def scheduler_kw(kind, clock):
    return dict(n_slots=2, f0method="pm", clock=clock,
                samplerate=KINDS[kind][5], **GEOMETRY)


def run_script(sched, clock):
    """The script of test_slot_scheduler_matches_jax_scheduler at the
    scheduler's block of client samples -> [(what, stats, [collected
    pieces])]."""
    bf = sched.block_frame
    a = stream_voice(8 * bf, seed=26, sr=sched.sr)
    b = stream_voice(8 * bf, seed=27, f0=300.0, sr=sched.sr)
    c = stream_voice(4 * bf, seed=28, f0=150.0, sr=sched.sr)
    pos, log = {}, []

    def submit(slot, audio, n):
        at = pos.get(id(audio), 0)
        sched.submit(slot, audio[at: at + n])
        pos[id(audio)] = at + n

    def tick(what):
        assert sched.ready()
        st = sched.tick()
        log.append((what, st, [np.asarray(sched.collect(s), np.float32)
                               for s in (0, 1)]))

    assert (sched.attach(), sched.attach()) == (0, 1)
    assert not sched.ready()
    # t = 0: slot 0 has a block and a half (in two chunks), slot 1 not yet
    submit(0, a, bf // 3), submit(0, a, bf + bf // 2 - bf // 3)
    submit(1, b, 3 * bf // 4)
    tick("slot 0 only")
    log.append(("pending 0", sched.pending(0), []))
    # t = 0.10: slot 1 completes its block, slot 0 is short, not overdue
    clock.t = 0.10
    submit(1, b, bf // 2), submit(0, a, bf // 4)
    tick("slot 1 only")
    # t = 0.17: slot 0 is a block time past its last feed: an underrun
    clock.t = 0.17
    tick("underrun")
    submit(0, a, 2 * bf), submit(1, b, 2 * bf)
    tick("both")
    tick("both again")
    # slot 1's client leaves, a new one takes the slot and starts afresh
    sched.detach(1)
    assert sched.attach() == 1
    log.append(("stats after churn", sched.stats(), []))
    submit(1, c, 3 * bf), submit(0, a, bf)
    tick("after churn")
    tick("slot 1 alone")
    return log


def jax_log(kind):
    """tpu_rvc's scheduler of the kind through the script, in a process
    of its own."""
    torch.set_num_threads(1)
    w = family_world(kind)
    jeng = jax_rt.RealtimeVC(
        hubert=JaxHubert(**w["hub_cfg"]), hubert_vars=w["jax_hub_vars"],
        synth=DeterministicJaxSynthesizer(**w["cfg"], weight_norm=True),
        synth_vars=jax_synth_params(w["sd"], w["cfg"]), index=None,
        index_rate=0.0, **engine_args(kind))
    clock = FakeClock()
    sched = jax_serve.SlotScheduler(jeng, **scheduler_kw(kind, clock))
    return run_script(sched, clock)


@pytest.fixture(scope="module")
def logs(one_torch_thread):
    """Both packages' logs of every kind: the JAX ones start first, each
    in a spawned process, and run while the port's run here."""
    with ProcessPoolExecutor(len(KINDS),
                             mp_context=mp.get_context("spawn")) as pool:
        futures = {k: pool.submit(jax_log, k) for k in KINDS}
        out = {}
        for kind in KINDS:
            w = family_world(kind)
            eng = rt.RealtimeVC(hubert=w["hub"], synth=w["synth"],
                                index=None, index_rate=0.0, noise_scale=0.0,
                                deterministic=True, device="cpu",
                                **engine_args(kind))
            clock = FakeClock()
            sched = serve.SlotScheduler(eng, **scheduler_kw(kind, clock))
            out[kind] = dict(port=run_script(sched, clock),
                             bf=sched.block_frame, sched=sched,
                             jax=futures[kind])
        for kind in KINDS:
            out[kind]["jax"] = out[kind]["jax"].result()
        yield out


@pytest.mark.parametrize("kind", list(KINDS))
def test_family_slot_scheduler_matches_jax_scheduler(logs, kind):
    got_log, want_log = logs[kind]["port"], logs[kind]["jax"]
    bf = logs[kind]["bf"]
    assert bf == int(GEOMETRY["block_time"] * KINDS[kind][5])
    assert [e[0] for e in got_log] == [e[0] for e in want_log]
    for (what, st, pieces), (_, jst, jpieces) in zip(got_log, want_log):
        assert st == jst, what
        for got, want in zip(pieces, jpieces):
            assert len(got) == len(want), (what, len(got), len(want))
            if len(got):
                assert np.isfinite(got).all()
                assert np.abs(got - want).max() < TOL, what
    ticks = {e[0]: e for e in got_log}
    assert [len(p) for p in ticks["slot 0 only"][2]] == [bf, 0]
    assert [len(p) for p in ticks["slot 1 only"][2]] == [0, bf]
    assert ticks["underrun"][1]["underruns"] == [1, 0]
    assert [len(p) for p in ticks["both"][2]] == [bf, bf]
    assert ticks["stats after churn"][1]["blocks"][1] == 0
    assert ticks["slot 1 alone"][1]["underruns"] == [1, 0]
    # the audio is the model's, not silence
    assert max(np.abs(p).max() for p in ticks["both"][2]) > 1e-2


def test_family_scheduler_engines(logs):
    """The engines are the kinds': the v1 one taps 256-d features through
    final_proj and tracks f0, the f0-less one resamples its 40 kHz
    output to the 48 kHz stream and never fills its pitch caches."""
    v1 = logs["v1_32k"]["sched"]
    assert v1.engine.hubert.final_proj is not None
    assert v1.fused.use_f0 and v1.engine.tgt_sr == v1.sr == 32000
    assert len(v1.engine.synth.dec.ups) == 5
    nof0 = logs["v2_40k"]["sched"]
    assert not nof0.fused.use_f0
    assert (nof0.engine.tgt_sr, nof0.sr) == (40000, 48000)
    state = nof0.state
    assert not state["cache_pitch"].any() and not state["cache_pitchf"].any()


@pytest.mark.parametrize("C,T", [(16, 90), (16, 93), (32, 121)])
def test_stage_plain_batched_equals_stacked_family_widths(C, T):
    """(N, C, T) through the plain stage == each (C, T) through it (1e-5)
    at the five-level decoders' C = 16 and at T % 4 != 0."""
    rng = np.random.default_rng(C + T)
    ks = (3, 7, 11)
    x, ws, bs = stage_inputs(rng, C, T, ks)
    sw = stage_weights(ws, bs, ks)
    xb = torch.from_numpy(np.stack([x.T, 0.5 * x.T[:, ::-1], -x.T,
                                    np.roll(x.T, 7, axis=1)]).copy())
    got = stage_plain(xb, sw)
    assert got.shape == (4, C, T)
    want = torch.stack([stage_plain(row, sw) for row in xb])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
