"""tpu_rvc_torch's spans (`utils/timing.py`): nesting, parents and request
ids on each thread's own stack; `read()`'s device-or-host keys beside its
`host.` keys; nothing recorded while disabled; each span's
`tpu_rvc_torch.<name>` mark inside the span's host interval in a
`torch.profiler` trace; and the host spans of the three entry points, a
conversion, a serving tick and a training step, on the CPU.  The last
test runs on a card only: the benchmark's trace reader
(`rvcbench/lib/trace.py`) around a traced conversion counts no mark as
work of the card's.

This file imports no JAX, so on a machine without JAX it runs without the
suite's conftest:

    python -m pytest --noconftest tests/test_torch_timing.py -q
"""

import shutil
import socket
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from tpu_rvc_torch.audio.io import save_wav
from tpu_rvc_torch.core import config
from tpu_rvc_torch.models.hubert import Hubert
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.pipeline import rt, serve
from tpu_rvc_torch.pipeline.vc import VC, Pipeline
from tpu_rvc_torch.train import data
from tpu_rvc_torch.train.step import create_train_state
from tpu_rvc_torch.utils import timing

SR = 16000
HUBERT = dict(output_layer=2, final_proj=False, embed=64, ffn_dim=128,
              n_heads=2, pos_conv_k=16, pos_conv_groups=2,
              conv_layers=((32, 10, 5), (32, 4, 4), (32, 4, 4),
                           (32, 2, 2), (32, 2, 2)))  # 320x downsample
SYNTH = dict(
    spec_channels=129, segment_size=640, inter_channels=32,
    hidden_channels=32, filter_channels=64, n_heads=2, n_layers=1,
    kernel_size=3, p_dropout=0.0, resblock="1",
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
    upsample_rates=(10, 16), upsample_initial_channel=32,
    upsample_kernel_sizes=(20, 32), spk_embed_dim=2, gin_channels=16,
    sr=16000, encoder_dim=64, use_f0=True)
# heads of 32 channels and decoder levels of 32 and 16: widths the card's
# kernels are built for
CARD_SYNTH = dict(SYNTH, hidden_channels=64, filter_channels=128,
                  upsample_initial_channel=64)
GEOMETRY = dict(x_pad=0.5, x_query=2.0, x_center=5.0, x_max=6.0)
OFFLINE = {"call", "load", "split", "upload", "f0", "hubert", "enc_p",
           "flow", "decoder", "fetch"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def timed():
    timing.enable()
    try:
        yield
    finally:
        timing.disable()


def seeded(cls, seed, **kw):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return cls(**kw).eval()


def voice(dur, seed=0, sr=SR):
    rng = np.random.default_rng(seed)
    tt = np.arange(int(sr * dur)) / sr
    ph = 2 * np.pi * np.cumsum(180 + 40 * np.sin(2 * np.pi * 0.5 * tt)) / sr
    x = 0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)
    return (x + 0.005 * rng.standard_normal(tt.shape)).astype(np.float32)


def by_name(recs):
    return {r["name"]: r for r in recs}


def small_vc(device, synth=SYNTH):
    """A VC over small random models, its pipeline set directly."""
    vc = VC(device=device, x_pad=GEOMETRY["x_pad"])
    vc.pipeline = Pipeline(SR, hubert=seeded(Hubert, 33, **HUBERT),
                           synth=seeded(Synthesizer, 31, **synth),
                           version="v2", noise_scale=0.0, deterministic=True,
                           device=device, **GEOMETRY)
    vc.tgt_sr, vc.if_f0 = SR, 1
    return vc


def marks_of(prof, device_type):
    """(name, start ns, end ns) of every `tpu_rvc_torch.` event of the
    trace on `device_type`'s timeline, and whether each is an
    annotation."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(timing.MARK) and \
                e.device_type() == device_type:
            out.append((e.name()[len(timing.MARK):], e.start_ns(),
                        e.start_ns() + e.duration_ns(),
                        e.is_user_annotation()))
    return out


def assert_marks_in_spans(prof, recs, slack_ns=1_000_000):
    """Every span has one host mark of its name, which starts and ends
    within `slack_ns` of the span's own host interval."""
    marks = marks_of(prof, torch.autograd.DeviceType.CPU)
    assert sorted(m[0] for m in marks) == sorted(r["name"] for r in recs)
    for name in {r["name"] for r in recs}:
        spans = sorted((r["t0_ns"], r["t1_ns"]) for r in recs
                       if r["name"] == name)
        got = sorted((s, e) for n, s, e, _ in marks if n == name)
        for (t0, t1), (s, e) in zip(spans, got):
            assert t0 <= s and e <= t1, (name, t0, s, e, t1)
            assert s - t0 <= slack_ns and t1 - e <= slack_ns, name


# ---------------------------------------------------------------------------
# the spans themselves
# ---------------------------------------------------------------------------


def test_nesting_parents_and_request_ids(timed):
    """A child's parent is the innermost open span and it shares that
    span's request id; a root span, and a span with none open, opens a
    new id; a root inside another span keeps the parent but not the id."""
    with timing.span("call", root=True):
        with timing.span("load"):
            pass
        with timing.span("split"):
            with timing.span("upload"):
                pass
    with timing.span("load"):
        with timing.span("tick", root=True):
            pass
    recs = timing.records()
    assert [r["name"] for r in recs] == ["load", "upload", "split", "call",
                                         "tick", "load"]
    first, second = recs[:4], recs[4:]
    n = {r["name"]: r["span"] for r in first}
    assert [r["parent"] for r in first] == [n["call"], n["split"],
                                            n["call"], None]
    assert len({r["request"] for r in first}) == 1
    tick, outer = second
    assert tick["parent"] == outer["span"] and outer["parent"] is None
    assert len({first[0]["request"], tick["request"],
                outer["request"]}) == 3
    for r in recs:
        assert 0 < r["t0_ns"] <= r["t1_ns"] and r["device_ms"] is None
    assert first[3]["t0_ns"] <= first[0]["t0_ns"] and \
        first[0]["t1_ns"] <= first[3]["t1_ns"]


def test_threads_keep_stacks_of_their_own(timed):
    """Two threads open their roots and children in lock step: each
    child's parent is its own thread's root, and each thread has its own
    request id."""
    step = threading.Barrier(2, timeout=30)

    def work():
        with timing.span("tick", root=True):
            step.wait()
            with timing.span("sola"):
                step.wait()
            step.wait()

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    recs = timing.records()
    ticks = {r["span"]: r for r in recs if r["name"] == "tick"}
    solas = [r for r in recs if r["name"] == "sola"]
    assert len(ticks) == 2 and len(solas) == 2
    assert {r["parent"] for r in solas} == set(ticks)
    for r in solas:
        assert r["request"] == ticks[r["parent"]]["request"]
    assert len({r["request"] for r in ticks.values()}) == 2


def test_read_keeps_the_old_keys_and_adds_host_keys(timed):
    """Off a card `<name>` reads the host's clock, the same as
    `host.<name>`; spans of one name add up; no other key appears."""
    for _ in range(3):
        with timing.span("f0", "cpu"):
            with timing.span("split"):
                np.sort(np.random.default_rng(0).standard_normal(20000))
    got = timing.read()
    assert set(got) == {"f0", "split", "host.f0", "host.split"}
    recs = timing.records()
    for name in ("f0", "split"):
        want = sum((r["t1_ns"] - r["t0_ns"]) / 1e6 for r in recs
                   if r["name"] == name)
        assert got[name] == pytest.approx(want)
        assert got["host." + name] == got[name] > 0
    assert got["f0"] >= got["split"]


def test_disabled_spans_record_nothing():
    """Disabled, every span is one shared object that records nothing and
    puts no mark on a profiler's timeline; `read()` is empty."""
    timing.disable()
    assert timing.span("a") is timing.span("b", "cpu", root=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("call", root=True):
            with timing.span("load"):
                torch.ones(8).sum()
    assert marks_of(prof, torch.autograd.DeviceType.CPU) == []
    assert timing.read() == {} and timing.records() == []
    timing.enable()
    assert timing.read() == {} and timing.records() == []
    timing.disable()


def test_marks_lie_in_their_spans_host_interval(timed):
    """Under a CPU `torch.profiler`, each span is a `tpu_rvc_torch.<name>`
    event inside the span's own host interval, within 1 ms at each end:
    the spans and the trace share a clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with timing.span("step", root=True):
                with timing.span("upload"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
                with timing.span("collate"):
                    np.zeros((256, 1024)).sum()
    recs = timing.records()
    assert len(recs) == 6
    assert_marks_in_spans(prof, recs)


# ---------------------------------------------------------------------------
# the entry points' host spans
# ---------------------------------------------------------------------------


def test_offline_call_spans(timed, tmp_path):
    """One `vc_single` on the CPU: the root `call` and its host stages
    (load, split, upload, fetch) beside the model's, one request id."""
    path = str(tmp_path / "in.wav")
    save_wav(path, voice(1.5), SR)
    vc = small_vc("cpu")
    _, (sr, out) = vc.vc_single(0, path, f0_method="pm", index_rate=0.0)
    assert sr == SR and out.dtype == np.int16 and len(out) > 0
    recs = timing.records()
    assert {r["name"] for r in recs} == OFFLINE
    assert len({r["request"] for r in recs}) == 1
    call = by_name(recs)["call"]
    assert call["parent"] is None and recs[-1]["name"] == "call"
    for name in ("load", "split", "upload", "fetch"):
        assert all(r["parent"] == call["span"] for r in recs
                   if r["name"] == name), name
    got = timing.read()
    assert got["host.call"] >= sum(got["host." + n] for n in (
        "load", "split", "upload", "fetch"))


def test_two_slot_tick_spans(timed):
    """A two-slot `SlotScheduler` tick: `tick` at the root over `pop`,
    `upload`, `fetch` and `sola`, each tick its own request id, and the
    tick's host time covers the fetch and the merge."""
    clock = lambda: 0.0  # noqa: E731  (no slot is ever overdue)
    engine = rt.RealtimeVC(hubert=seeded(Hubert, 63, **HUBERT),
                           synth=seeded(Synthesizer, 61, **SYNTH),
                           version="v2", if_f0=1, noise_scale=0.0,
                           deterministic=True, device="cpu")
    sched = serve.SlotScheduler(engine, 2, samplerate=SR, block_time=0.16,
                                crossfade_time=0.04, extra_time=0.64,
                                f0method="pm", clock=clock)
    slots = [sched.attach() for _ in range(2)]
    pcm = voice(0.32)
    for i in range(2):
        for s in slots:
            sched.submit(s, pcm[i * sched.block_frame:
                                (i + 1) * sched.block_frame])
        sched.tick()
        for s in slots:
            assert len(sched.collect(s)) == sched.block_frame
    recs = timing.records()
    assert {r["name"] for r in recs} >= {"tick", "pop", "upload", "fetch",
                                          "sola", "f0"}
    ticks = [r for r in recs if r["name"] == "tick"]
    assert len(ticks) == 2 and all(r["parent"] is None for r in ticks)
    assert ticks[0]["request"] != ticks[1]["request"]
    for r in recs:
        if r["name"] in ("pop", "fetch", "sola"):
            assert r["parent"] in {t["span"] for t in ticks}, r
    got = timing.read()
    assert got["host.tick"] >= got["host.sola"] + got["host.fetch"]
    assert got["host.tick"] >= got["host.pop"] + got["host.upload"]


def tiny_mute_hp():
    return config.HParams(
        version="v1",
        train=config.TrainConfig(segment_size=4800, batch_size=2,
                                 fp16_run=False),
        data=config.DataConfig(sampling_rate=48000, filter_length=1024,
                               hop_length=480, win_length=1024,
                               n_mel_channels=32),
        model=config.ModelConfig(
            inter_channels=32, hidden_channels=32, filter_channels=64,
            n_heads=2, n_layers=1, kernel_size=3,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
            upsample_rates=(10, 48), upsample_initial_channel=32,
            upsample_kernel_sizes=(20, 96), gin_channels=16,
            spk_embed_dim=4))


def mute_filelist(tmp_path):
    """A one-row training set of the repository's `mute` fixtures."""
    files = []
    for sub, src, dst in (("0_gt_wavs", "mute48k.wav", "m.wav"),
                          ("3_feature256", "mute.npy", "m.npy"),
                          ("2a_f0", "mute.wav.npy", "m.wav.npy"),
                          ("2b-f0nsf", "mute.wav.npy", "m.wav.npy")):
        (tmp_path / sub).mkdir()
        shutil.copy(data.MUTE_DIR / sub / src, tmp_path / sub / dst)
        files.append(str(tmp_path / sub / dst))
    filelist = tmp_path / "filelist.txt"
    filelist.write_text("|".join(files + ["0"]) + "\n")
    return str(filelist)


def test_epoch_and_step_spans(timed, tmp_path):
    """A `BucketBatcher` epoch's `load` and `collate` (each a request of
    its own, outside any step), then a tiny `train_step`: `step` at the
    root over `upload` and the step's device spans, on one id."""
    hp = tiny_mute_hp()
    batcher = data.BucketBatcher(
        data.RVCDataset(mute_filelist(tmp_path), hp), 2)
    batch = next(batcher.epoch(0))
    before = timing.records()
    assert [r["name"] for r in before] == ["load", "collate"]
    assert all(r["parent"] is None for r in before)
    assert before[0]["request"] != before[1]["request"]

    state = create_train_state(hp, seed=1, steps_per_epoch=1, device="cpu")
    timing.disable()
    timing.enable()
    out = state.train_step(batch)
    assert bool(torch.isfinite(out["loss_gen_all"]))
    recs = timing.records()
    assert {r["name"] for r in recs} == {"step", "upload", "g_forward",
                                         "d_step", "g_step"}
    step = by_name(recs)["step"]
    assert step["parent"] is None and recs[-1] is step
    assert len({r["request"] for r in recs}) == 1
    assert by_name(recs)["upload"]["parent"] == step["span"]
    got = timing.read()
    assert got["step"] == got["host.step"] >= got["host.g_step"]


def test_data_parallel_step_spans_its_all_reduces(tmp_path):
    """A step in a one-rank gloo group: an `all_reduce` span inside
    `d_step` and one inside `g_step`, each the averaging of that net's
    gradients over the group; the rank's own losses, which one rank's
    mean is, beside the group's."""
    hp = tiny_mute_hp()
    batch = next(data.BucketBatcher(
        data.RVCDataset(mute_filelist(tmp_path), hp), 2).epoch(0))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        state = create_train_state(hp, seed=1, steps_per_epoch=1,
                                   device="cpu", group=dist.group.WORLD)
        timing.enable()
        out = state.train_step(batch)
        recs = timing.records()
    finally:
        timing.disable()
        dist.destroy_process_group()
    spans = {r["span"]: r for r in recs}
    reduces = [r for r in recs if r["name"] == "all_reduce"]
    assert [spans[r["parent"]]["name"] for r in reduces] == ["d_step",
                                                             "g_step"]
    assert all(r["device_ms"] is None and r["t1_ns"] > r["t0_ns"]
               for r in reduces)
    for k in ("loss_disc", "loss_gen_all"):
        assert float(out["rank_" + k]) == float(out[k])


def test_counters_add_up_once_enabled_and_cost_nothing_before():
    """Disabled, `count` records nothing (one check of the module's
    global); enabled, `read()` gives each counter's total under
    `count.<name>` beside the spans' keys, and `enable()` starts them
    again at nought."""
    timing.disable()
    timing.count("uvr5.windows", 7)
    timing.enable()
    try:
        assert timing.read() == {}
        timing.count("uvr5.windows", 3)
        with timing.span("net"):
            timing.count("uvr5.windows", 4)
        timing.count("other")
        got = timing.read()
        assert got["count.uvr5.windows"] == 7 and got["count.other"] == 1
        assert set(got) == {"count.uvr5.windows", "count.other", "net",
                            "host.net"}
        timing.enable()
        assert timing.read() == {}
    finally:
        timing.disable()
    assert timing.read() == {}


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_marks_are_no_work_of_the_card(tmp_path):
    """rvcbench's `Trace` around a traced conversion on a card: the marks'
    device copies are annotations, so no `tpu_rvc_torch.` name enters the
    kernels `device_ops` and `busy_s` are made of; each host mark lies
    within 1 ms of its span's host interval."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the trace of the card's timeline")
    from rvcbench.lib.trace import Trace

    path = str(tmp_path / "in.wav")
    save_wav(path, voice(3.0), SR)
    vc = small_vc("cuda", CARD_SYNTH)
    vc.vc_single(0, path, f0_method="pm", index_rate=0.0)   # warm-up
    timing.enable()
    try:
        with Trace(cuda=True) as tracer:
            vc.vc_single(0, path, f0_method="pm", index_rate=0.0)
        recs = timing.records()
        spans = timing.read()
    finally:
        timing.disable()
    assert {r["name"] for r in recs} == OFFLINE
    assert all(r["device_ms"] is not None for r in recs
               if r["name"] in ("f0", "hubert", "decoder"))
    assert spans["decoder"] > 0 and spans["host.decoder"] > 0
    tr = tracer.read()
    assert tr["busy_s"] > 0
    assert not any(k.startswith(timing.MARK) for k in tr["kernels"])
    assert not any(k.startswith(timing.MARK) for k, _ in tr["device_ops"])
    on_card = marks_of(tracer.prof, torch.autograd.DeviceType.CUDA)
    assert on_card and all(m[3] for m in on_card)
    assert_marks_in_spans(tracer.prof, recs)
