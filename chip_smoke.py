#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (tpu_rvc_torch) once on one card.

    python3 chip_smoke.py    # needs one CUDA card

Phases, one line of output each (any failure exits non-zero):
  1. card and build: the card's name and power limit (nvidia-smi), then
     the nvcc build of every kernel source, all at once, with its seconds;
  2. each kernel against its plain PyTorch twin at the main path's shapes
     (v2/48k, 10 s input in a 16 s bucket), cuDNN and cuBLAS with TF32 off
     as in the port's entry points: max abs / rel error and the median ms
     of both, from CUDA events after a warm-up, beside the kernel's bound
     at the peak it uses (the tensor cores as 3xTF32) and at the fp32 FMA
     units' peak;
  3. end to end through the user's entry points: a random-weight v2/48k
     small model `.pth` in the reference layout, a random 10k x 768 index,
     a synthetic 10 s WAV; VC(hubert_path="random").get_vc(path) and
     vc_single(f0_method="pm", index_rate=0.75), 1 warm-up + 3 timed runs,
     per-stage CUDA-event times and each kernel's launches in one run;
  4. the single-resblock path (the fused_resblock kernel) through the same
     entry points, its launches counted in that run alone;
  5. the same conversion on the card and on the CPU (plain twins) for a
     short input, deterministic, held to a relative L2 error of 1e-3;
then one JSON line of kernels, the card line again, and the result line.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32 = 67e12     # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_TF32 = 495e12    # H100 SXM dense TF32 FLOP/s on the tensor cores
TF32_PER_FP32 = 3     # 3xTF32: tensor-core products per fp32 product
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
W = 10


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def median_ms(fn, iters=5, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(got, want, rtol, atol, what):
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    ok = bool(torch.all(err <= atol + rtol * want.abs()))
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version: max abs {max_abs}, max rel {max_rel}")
    return max_abs, max_rel


def bound(flops, nbytes):
    """The least ms the card could take for `flops` fp32 operations run as
    3xTF32 on the tensor cores and `nbytes` of device memory, which of the
    two binds, and the same with the fp32 FMA units' peak."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops * TF32_PER_FP32 / PEAK_TF32
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(flops / PEAK_FP32, t_bytes) * 1e3)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain twins
# ---------------------------------------------------------------------------


def check_attention(kr, g):
    BH, T, dk = 2, 1598, 96
    dev = torch.device("cuda")
    mk = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    q, k, v = mk(BH, T, dk), mk(BH, T, dk), mk(BH, T, dk)
    ek, ev = mk(2 * W + 1, dk) * dk ** -0.5, mk(2 * W + 1, dk) * dk ** -0.5
    rows = []
    for lens in ([T, T], [T, T - 311]):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, k, v, ek, ev, lengths, W)
        got = kr.banded_rel_attention(*args)
        want = kr.banded_rel_attention_plain(*args)
        torch.cuda.synchronize()
        max_abs, max_rel = compare(got, want, 1e-4, 1e-4,
                                   f"banded_rel_attention lengths={lens}")
        ms = median_ms(lambda: kr.banded_rel_attention(*args), iters=20)
        plain_ms = median_ms(lambda: kr.banded_rel_attention_plain(*args))
        # the work these lengths need: every query row against the keys
        # below its length (Q.K^T, softmax, P.V), plus the two band terms
        keys = T * sum(lens)
        flops = (4 * dk + 5) * keys + 4 * BH * T * (2 * W + 1) * dk
        nbytes = 4 * (4 * BH * T * dk + 2 * (2 * W + 1) * dk) + 4 * BH
        b_ms, b_by, b_fma = bound(flops, nbytes)
        say("kernel", name="banded_rel_attention", shape=[BH, T, dk],
            lengths=lens, max_abs_err=max_abs, max_rel_err=max_rel,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bound_fp32_fma_ms=b_fma)
        rows.append((max_abs, ms, plain_ms, b_ms, b_by, b_fma))
    return {"name": "banded_rel_attention", "route": "cuda",
            "source": "tpu_rvc_torch/csrc/rel_attention.cu",
            "replaces": "tpu_rvc/ops/pallas/rel_attention.py:75",
            "max_abs_err": max(r[0] for r in rows), "ms": rows[-1][1],
            "plain_ms": rows[-1][2], "bound_ms": rows[-1][3],
            "bound_by": rows[-1][4], "bound_fp32_fma_ms": rows[-1][5],
            "math": "3xtf32", "library_ms": None}


def stage_inputs(rs, C, T, ks, g):
    dev = torch.device("cuda")
    x = torch.randn(C, T, generator=g, device=dev) * 0.3
    w = tuple(tuple(torch.randn(k, C, C, generator=g, device=dev)
                    * (1.0 / math.sqrt(k * C)) for _ in range(6)) for k in ks)
    b = tuple(tuple(torch.randn(C, generator=g, device=dev) * 0.1
                    for _ in range(6)) for _ in ks)
    return x, rs.pack_stage(ks, (1, 3, 5), w, b)


def stage_cost(C, T, ks):
    flops = 2 * C * C * T * 6 * sum(ks)
    nbytes = 4 * (2 * C * T + 6 * sum(ks) * C * C + 6 * len(ks) * C)
    return bound(flops, nbytes)


def stage_extra_hbm_ms(C, T, n_rb, n_d=3):
    """HBM time of the activations the per-conv launches move beyond the
    single fused launch's one read of x and one write of the output: per
    (resblock, dilation) pair conv1 reads x_in and writes u, conv2 reads u
    and x_in and writes x_new (the last pair of each resblock writes, or
    reads and writes, the stage output instead)."""
    rows = n_rb * (5 * n_d + 1) - 1 - 2
    return 4 * C * T * rows / PEAK_BYTES * 1e3


def check_stage(rs, g, name, shapes, ks):
    fn = rs.fused_stage if len(ks) > 1 else rs.fused_resblock
    rows = []
    for C, T in shapes:
        x, sw = stage_inputs(rs, C, T, ks, g)
        got = fn(x, sw)
        want = rs.stage_plain(x, sw)
        torch.cuda.synchronize()
        max_abs, max_rel = compare(got, want, 1e-3, 1e-4, f"{name} C={C}")
        ms = median_ms(lambda: fn(x, sw))
        plain_ms = median_ms(lambda: rs.stage_plain(x, sw))
        b_ms, b_by, b_fma = stage_cost(C, T, ks)
        say("kernel", name=name, C=C, T=T, kernel_sizes=list(ks),
            max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bound_fp32_fma_ms=b_fma, launches_per_call=6 * len(ks),
            extra_hbm_ms=stage_extra_hbm_ms(C, T, len(ks)))
        rows.append((max_abs, ms, plain_ms, b_ms, b_by, b_fma))
        del x, sw, got, want
    return rows


def check_kernels():
    from tpu_rvc_torch.ops import kernels as kr
    from tpu_rvc_torch.ops.kernels import resblock as rs

    g = torch.Generator(device="cuda").manual_seed(0)
    entries = [check_attention(kr, g)]
    # the v2/48k decoder stages for a 16 s bucket (1598 frames)
    stages = [(256, 19176), (128, 191760), (64, 383520), (32, 767040)]
    rows = check_stage(rs, g, "fused_stage", stages, (3, 7, 11))
    entries.append({
        "name": "fused_stage", "route": "cuda",
        "source": "tpu_rvc_torch/csrc/resblock.cu",
        "replaces": "tpu_rvc/ops/pallas/resblock.py:163",
        "max_abs_err": max(r[0] for r in rows),
        "ms": sum(r[1] for r in rows), "plain_ms": sum(r[2] for r in rows),
        "bound_ms": sum(r[3] for r in rows), "bound_by": rows[0][4],
        "bound_fp32_fma_ms": sum(r[5] for r in rows), "math": "3xtf32",
        "library_ms": None, "per_stage_ms": [r[1] for r in rows]})
    rows = check_stage(rs, g, "fused_resblock", [(64, 383520)], (7,))
    entries.append({
        "name": "fused_resblock", "route": "cuda",
        "source": "tpu_rvc_torch/csrc/resblock.cu",
        "replaces": "tpu_rvc/ops/pallas/resblock.py:237",
        "max_abs_err": rows[0][0], "ms": rows[0][1], "plain_ms": rows[0][2],
        "bound_ms": rows[0][3], "bound_by": rows[0][4],
        "bound_fp32_fma_ms": rows[0][5], "math": "3xtf32",
        "library_ms": None})
    return entries


# ---------------------------------------------------------------------------
# phases 3-5: conversions through the entry points
# ---------------------------------------------------------------------------


def write_model(path, hp, seed, resblock_kernel_sizes=None):
    """A random-weight small model `.pth` in the reference layout (fp16
    weights, as RVC stores them)."""
    import dataclasses
    from tpu_rvc_torch.models.synthesizer import make_synthesizer

    m = hp.model
    if resblock_kernel_sizes is not None:
        m = dataclasses.replace(
            m, resblock_kernel_sizes=tuple(resblock_kernel_sizes),
            resblock_dilation_sizes=((1, 3, 5),) * len(resblock_kernel_sizes))
        hp = dataclasses.replace(hp, model=m)
    net = make_synthesizer(hp, device="cpu", seed=seed)
    config = [hp.data.spec_channels, hp.train.segment_size, m.inter_channels,
              m.hidden_channels, m.filter_channels, m.n_heads, m.n_layers,
              m.kernel_size, m.p_dropout, m.resblock,
              list(m.resblock_kernel_sizes),
              [list(d) for d in m.resblock_dilation_sizes],
              list(m.upsample_rates), m.upsample_initial_channel,
              list(m.upsample_kernel_sizes), m.spk_embed_dim, m.gin_channels,
              hp.data.sampling_rate]
    torch.save({"weight": {k: v.half() for k, v in net.state_dict().items()},
                "config": config, "f0": 1, "version": hp.version,
                "sr": "48k", "info": "random weights"}, path)


def write_voice(path, seconds, seed):
    """Voiced harmonics on a gliding pitch, breath noise and a silent gap."""
    from tpu_rvc_torch.audio.io import save_wav

    sr = 16000
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = 160 + 60 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 6))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 1.7 * t) ** 2)
    x = x + 0.01 * rng.standard_normal(t.shape)
    gap = slice(int(sr * seconds * 0.4), int(sr * seconds * 0.46))
    x[gap] = 0.0
    save_wav(path, x.astype(np.float32), sr)


def expected_len(n16, x_pad, hop, tgt_sr):
    from tpu_rvc_torch.pipeline.vc import WINDOW, _bucket, _feat_frames

    L_true = n16 + 2 * int(16000 * x_pad)
    L = _bucket(L_true)
    frames = min(L_true // WINDOW, min(L // WINDOW, _feat_frames(L)))
    return frames * hop - 2 * int(tgt_sr * x_pad)


def check_output(audio, n_expected, what):
    audio = np.asarray(audio)
    if audio.dtype != np.int16 or audio.shape != (n_expected,):
        raise AssertionError(f"{what}: got {audio.dtype} {audio.shape}, "
                             f"expected int16 ({n_expected},)")
    if not np.isfinite(audio.astype(np.float32)).all() or \
            np.abs(audio).max() == 0:
        raise AssertionError(f"{what}: output is not finite audio")


def end_to_end(tmp):
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.vc import VC
    from tpu_rvc_torch.retrieval.index import FeatureIndex
    from tpu_rvc_torch.utils import timing

    hp = hparams_for("v2", 48000)
    model = os.path.join(tmp, "v2_48k.pth")
    write_model(model, hp, seed=0)
    wav = os.path.join(tmp, "voice_10s.wav")
    write_voice(wav, 10.0, seed=1)
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((10000, 768)).astype(np.float32)
    index = FeatureIndex(vecs, (vecs * vecs).sum(1))

    vc = VC(hubert_path="random")
    t0 = time.perf_counter()
    vc.get_vc(model)
    load_s = time.perf_counter() - t0
    n_expected = expected_len(160000, vc.x_pad, 480, 48000)
    kw = dict(f0_method="pm", index=index, index_rate=0.75)
    info, (sr, audio) = vc.vc_single(0, wav, **kw)      # warm-up
    check_output(audio, n_expected, "warm-up conversion")
    walls, stages = [], []
    for i in range(3):
        reset_launch_counts()
        timing.enable()
        t0 = time.perf_counter()
        info, (sr, audio) = vc.vc_single(0, wav, **kw)
        walls.append((time.perf_counter() - t0) * 1e3)
        stages.append(timing.read())
        timing.disable()
        counts = dict(launch_counts)
        check_output(audio, n_expected, f"timed conversion {i}")
    if sr != 48000:
        raise AssertionError(f"output rate {sr}")
    n_stage = len(hp.model.upsample_rates)
    n_launch = len(hp.model.resblock_kernel_sizes) * 6
    want = {"banded_rel_attention": hp.model.n_layers,
            "fused_stage": n_stage * n_launch, "fused_resblock": 0}
    if counts != want:
        raise AssertionError(f"launches in one conversion {counts}, "
                             f"expected {want}")
    split = {k: float(np.median([s.get(k, 0.0) for s in stages]))
             for k in stages[-1]}
    say("end_to_end", model="v2/48k random weights", input_s=10.0,
        index_rows=10000, load_s=load_s, wall_ms=walls,
        wall_ms_median=float(np.median(walls)), stage_ms=split,
        output_samples=int(audio.shape[0]), sr=sr, info=info,
        launches=counts, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return counts


def single_resblock_path(tmp):
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.vc import VC

    hp = hparams_for("v2", 48000)
    model = os.path.join(tmp, "v2_48k_rb1.pth")
    write_model(model, hp, seed=3, resblock_kernel_sizes=(7,))
    wav = os.path.join(tmp, "voice_3s.wav")
    write_voice(wav, 3.0, seed=4)
    vc = VC(hubert_path="random")
    vc.get_vc(model)
    reset_launch_counts()
    t0 = time.perf_counter()
    _, (sr, audio) = vc.vc_single(0, wav, f0_method="pm")
    wall = (time.perf_counter() - t0) * 1e3
    counts = dict(launch_counts)
    check_output(audio, expected_len(48000, vc.x_pad, 480, 48000),
                 "single-resblock conversion")
    want = {"banded_rel_attention": hp.model.n_layers, "fused_stage": 0,
            "fused_resblock": 6 * len(hp.model.upsample_rates)}
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")
    say("single_resblock_path", model="v2/48k, one k=7 resblock per stage",
        input_s=3.0, wall_ms=wall, launches=counts)
    return counts


def against_cpu(tmp):
    """The same deterministic conversion on the card and on the CPU."""
    from tpu_rvc_torch.audio.io import load_audio
    from tpu_rvc_torch.models.hubert import hubert_for_version
    from tpu_rvc_torch.models.loader import load_synthesizer
    from tpu_rvc_torch.pipeline.vc import Pipeline

    model = os.path.join(tmp, "v2_48k.pth")
    wav = os.path.join(tmp, "voice_1s.wav")
    write_voice(wav, 1.0, seed=5)
    audio = load_audio(wav, 16000)
    outs = []
    for dev in ("cuda", "cpu"):
        synth, _ = load_synthesizer(model, dev)
        pipe = Pipeline(48000, hubert=hubert_for_version("v2", dev),
                        synth=synth, x_pad=0.5, noise_scale=0.0,
                        deterministic=True, device=dev)
        outs.append(pipe.pipeline(0, audio, [0.0, 0.0, 0.0], 0, "pm", None,
                                  0.0, 1, 3, 0, 0.25, 0.33)
                    .astype(np.float64))
    gpu, cpu = outs
    if gpu.shape != cpu.shape:
        raise AssertionError(f"card {gpu.shape} vs cpu {cpu.shape}")
    rel = float(np.linalg.norm(gpu - cpu) / max(np.linalg.norm(cpu), 1e-9))
    say("against_cpu", input_s=1.0, samples=int(gpu.shape[0]),
        rel_l2_err=rel, max_abs_int16=float(np.abs(gpu - cpu).max()))
    if rel > 1e-3:
        raise AssertionError(f"card vs CPU relative error {rel} > 1e-3")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    from tpu_rvc_torch.core.device import fp32_math
    from tpu_rvc_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.build()
    say("build", seconds=time.perf_counter() - t0,
        ptxas={k: [ln for ln in v.splitlines() if "registers" in ln
                   or "spill" in ln] for k, v in build.ptxas_report.items()})
    with fp32_math():
        entries = check_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        main_counts = end_to_end(tmp)
        rb_counts = single_resblock_path(tmp)
        against_cpu(tmp)
    for e in entries:
        e["launches"] = (rb_counts if e["name"] == "fused_resblock"
                         else main_counts)[e["name"]]
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
