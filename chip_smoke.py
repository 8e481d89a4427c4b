#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (tpu_rvc_torch) once on one card.

    python3 chip_smoke.py    # needs one CUDA card

Phases, one line of output each (any failure exits non-zero):
  1. card and build: the card's name and power limit (nvidia-smi), then
     the nvcc build of every kernel source, all at once, with its seconds;
  2. each kernel against its plain PyTorch twin at the main path's shapes
     (v2/48k, 10 s input in a 16 s bucket; K2 and K3 at each of the four
     decoder levels), cuDNN and cuBLAS with TF32 off
     as in the port's entry points: max abs / rel error and the median ms
     of both, from CUDA events after a warm-up, beside the kernel's bound
     at the peak it uses (the tensor cores as 3xTF32) and at the fp32 FMA
     units' peak; then the rest of the model family: K2 at every decoder
     level of v1/32k, v1/40k (= v2/40k), v1/48k and v2/32k (the five-level
     v1 decoders end at C = 16), K3 at v1/32k's and v1/40k's levels and
     v1/48k's C = 16 level, both at (256, 290) and (16, 2321), whose
     T % 4 != 0 takes the kernel's scalar staging path; and K2 with a
     stream axis of 8 at v1/32k's five streaming levels (C = 16 at
     (8, 16, 9600)), at v2/40k's four and at those two unaligned shapes,
     bit for bit against stream-by-stream launches as in 11;
  3. end to end through the user's entry points: a random-weight v2/48k
     small model `.pth` in the reference layout, a random 10k x 768 index,
     a synthetic 10 s WAV; VC(hubert_path="random").get_vc(path) and
     vc_single(f0_method="pm", index_rate=0.75), 1 warm-up + 3 timed runs,
     per-stage CUDA-event times and each kernel's launches in one run;
  4. the single-resblock path (the fused_resblock kernel) through the same
     entry points, its launches counted in that run alone;
  5. the same conversion on the card and on the CPU (plain twins) for a
     short input, deterministic, held to a relative L2 error of 1e-3, with
     pm and with RMVPE;
  6. each kernel against its plain twin at the shapes one streaming block
     gives it (48 kHz, 0.25 s blocks, 2.5 s of context: a 281-frame
     window, a 30-frame tail), same tolerances, with ms, twin ms, bound;
  7. offline as in 3 with f0_method="rmvpe": a random-weight full-width
     `rmvpe.pt` in the reference layout, VC(rmvpe_root=...);
  8. streaming at full width: RealtimeVC + StreamSession(48000, 0.25,
     0.05, 2.5, "rmvpe", fused=True) with the index, 3 warm-up blocks (one
     of them with PyTorch's sync debug mode set to "error" between the
     upload and the fetch), then 10 blocks: wall ms, per-stage CUDA-event
     ms and launches per block, and from torch.profiler over 4 more
     blocks the device's busy ms a block (its share of the median wall of
     the 10 unprofiled blocks); the same 10 blocks with fused=False; the
     host µs a block spends keying the decoder's stage-weight cache;
  9. streaming on the single-resblock model: 5 blocks;
 10. streaming on the card against the CPU, deterministic, 6 blocks, pm
     and rmvpe (relative L2 < 1e-3), and fused against host path on the
     card (max abs difference < 1e-4 of full scale);
 11. the kernels with a stream axis, as one serving tick of 8 streams
     gives them: K2 at (8, C, T) and K3 at (8, 64, 7200) against the
     batched plain twin and, bit for bit, against the same kernel launched
     stream by stream; K1 at (16, 281, 96); ms beside 8 x the
     single-stream ms and the bound of 8 x the work;
 12. multi-stream serving at full width: SlotScheduler(48000, 0.25, 0.05,
     2.5, "rmvpe") with the index, N clients attached and fed their own
     voices in lockstep, for N = 8, 1 and 4 (3 warm-up + 10 timed ticks
     at N = 8, 5 at N = 1 and 4): serial mode with wall ms, CUDA-event spans, launches a tick
     (6 K1 and 72 K2 for every N), the device's busy share, peak memory,
     underruns (0); then pipelined on the same audio (delivered one tick
     later, the last block by flush(); within 1e-5 of the serial run, as
     two runs of one mode are, see `serving`); a warm-up tick runs under
     the sync debug mode as in 8; on the single-resblock model 3 ticks of
     4 slots (24 K3 launches a tick); then pipelined against serial sample
     for sample, 4 slots, 5 blocks, deterministic engine, cuDNN held to
     its deterministic algorithms;
 13. every stream of a deterministic 8-slot scheduler, 6 blocks, against
     its own StreamSession on the card (1e-4 of full scale, SOLA margins
     printed), and two of them against a scheduler on the CPU (relative L2
     < 1e-3); then a tick that feeds slots 0 and 3 only (the other six
     state rows bit-identical), and a client that leaves slot 2 while a
     new one takes it (its first block is a fresh session's);
 14. noise reduction: StreamSession with both denoisers, 6 blocks on the
     card against the CPU (relative L2 < 1e-3); TorchGate on 1 s of tone
     and noise lowers the noise floor;
 15. the TCP server on 127.0.0.1, an ephemeral port, two `stream_file`
     clients in threads with 1 s wavs (the scheduler reads a clock that
     stands still, so that no wall-clock pause counts as an underrun);
 T1. training data: 16 synthetic 4 s voices at 48 kHz through
     `apps/train.py`'s preprocess, extract (RMVPE from the random-weight
     `rmvpe.pt`, HuBERT-base from a seed, on the card) and index, then the
     filelist (16 rows and 2 mute rows);
 T2. GAN training at v2/48k full width (batch 4, segment 17280, bf16 as
     the preset says): `run_training` for 1 epoch with a checkpoint,
     then resumed for a 2nd; no K1/K2/K3 launch; on the state of epoch 2 a
     gradient in enc_p's attention and every resblock, then 3 warm-up + 8
     steps timed one by one on the host clock after a synchronize (median,
     p90, max, samples a second), CUDA-event spans `g_forward`, `d_step`,
     `g_step`, the host's batch time, peak memory, the device's busy share
     and top kernels over 3 more steps (torch.profiler); the last of them
     under the deterministic option (`TrainState.deterministic`) in bf16
     twice from one state, the first searching cuDNN's algorithms: both
     bit for bit equal, finite (the first step's seconds, the second's ms,
     reserved memory); the live G's
     `infer` (its stage cache filled before the optimizer moved its
     weights in place) against its `G_*.pth` reloaded (1e-5 of full
     scale);
 T3. one pinned fp32 step (TF32 off) at full width, batch 2 in a 200-frame
     bucket, on the card against the CPU: loss terms within 1e-3
     relative, grad norms within 1e-2;
 T5. data-parallel and sharded training at full width, each in child
     processes (`tools/dist_steps.py`; this process joins no group; all
     start at once and wait at a gate for their timed part): (a)
     `apps/train.py train --coordinator 127.0.0.1:<port> --num-processes 1
     --process-id 0` on a copy of T1's data, one epoch, batch 4, bf16 (an
     NCCL group of one; its checkpoints and small model written), then in
     the same process 3 warm-up and 12 steps in the group and 12 without
     it, timed in turns of 6 (group, none, none, group): the difference is
     the all-reduce path of 436 MB of gradients; (b) two ranks on the one
     card over gloo with CUDA tensors, fp32, rows of lengths (200, 163,
     200, 110) split 2 a rank, 3 pinned then 2 unpinned steps against two
     one-process runs on all 4 rows here: loss terms and grad norms within
     1e-4 relative at steps 1-2, and at the unpinned steps 4-5 within 1e-3
     beyond twice what the second run moves; the ranks' parameters
     bit-identical after 1, 3 and 5 steps; after 1 every element within 2
     lr and under 0.1% beyond 1e-6, after 5 within 2 lr a step; ms a
     global step and peak memory a rank, at the default setting; the two
     one-process runs, after the CLI's epoch and under the deterministic
     step (`TrainState.deterministic`, off by default), under 0.1% of the
     elements beyond 1e-6 apart after 1 and 5 steps, that step's median
     ms against the default setting's in turns on one state (reported,
     not bounded), the peak reserved memory of its first runs (cuDNN's
     search included) and of each setting's warm-up; (c) the same on a (1, 2) FSDP2 mesh
     (`shard_train_state`: both ranks on all 4 rows, the parameters
     sharded), `assert_state_sharded` >= 0.5 before and after; no
     K1/K2/K3 launch in any process;
 T4. the small model T2 wrote through `VC.get_vc` and a 10 s `vc_single`
     with RMVPE (6 K1 and 72 K2 launches), and the same conversion,
     deterministic, on the card against the CPU (relative L2 < 1e-3);
 T6. the family in training, T1's 16 voices prepared at each kind's
     rate, full width, batch 4, bf16 as the presets say, 2 epochs with a
     checkpoint each: v2/40k with f0 (RMVPE) through the web app's
     `Api.train_start_all`, v1/32k with f0 (pm) through `run_training`,
     v1/48k and v2/32k without f0 through `apps/train.py`; each step of
     the run timed to a synchronize (the first of each bucket shape
     reported) and its peak reserved memory; on the last epoch's state
     its G against that epoch's G_*.pth (1e-5), 3 warm-up + 8 steps
     timed as in T2 (spans, peak memory), finite losses, no K1/K2/K3 launch; the small model through a
     10 s `vc_single` (6 K1, 18 K2 a level) and 1 s card against CPU
     (relative L2 < 1e-3); at v1/32k also T3's pinned fp32 step against
     the CPU;
 F1. FCPE offline: a random-weight torchfcpe bundled checkpoint at the
     bundled width (hidden 512, 6 layers, kernel 31, 360 bins), found by
     the estimator's default lookup from a temporary working directory;
     vc_single(f0_method="fcpe") as in 3 (launches equal to pm's), and
     1 s on the card against the CPU (relative L2 < 1e-3);
 F2. FCPE streaming: phase 8's fused session with "fcpe" (10 timed
     blocks, one warm-up block under the sync debug mode, the profiler's
     busy ms), and phase 10 with "fcpe" (card against CPU, fused against
     host path);
 F3. FCPE serving: phase 12 serial with "fcpe", N = 8, 3 + 10 ticks, and
     two of the streams against their own sessions (1e-4 of full scale);
 F4. the host estimators and tracks: the 10 s voice with crepe (random
     CREPE full weights in torchcrepe's layout), dio, harvest
     (filter_radius 3), pm with a manual f0 curve, and the pm track of the
     same input precomputed (if_f0 = 2), one warm-up and one timed run
     each, f0 ms and wall ms, 6 K1 and 72 K2 launches each; crepe and
     harvest on 1 s, card against CPU; the FCPE track (offline, streaming
     and 8-stream shapes) and the CREPE salience (1601 frames) alone:
     CUDA-event ms, busy ms, kernel launches, work; SlotScheduler refuses
     harvest; each F phase prints its seconds;
 M1. ONNX: the v2/48k model exported at T = 1024 and HuBERT-base (seed 0)
     at 160000 samples, on the card (seconds, nodes, MB); OnnxRVC on the
     card converts the 10 s voice with pm, 1 warm-up + 3 timed: wall ms,
     each graph's CUDA-event ms, busy ms and operations, peak memory, no
     kernel launch; the graph against Synthesizer.infer on the card with
     the same rnd (relative L2 < 1e-4); the synthesizer at T = 200 and
     ContentVec traced on the card and on the CPU, run on the card
     (relative L2 < 1e-4); VC's 10 s pm conversion of the same model;
 M2. `.pt2`: infer at T = 1024 traced and saved on the CPU, loaded onto
     the card, against infer there (relative L2 < 1e-4); load seconds
     beside load_synthesizer's, run ms; the noisy variant runs finite;
 M3. the checkpoint tools: merge two random v2/48k models (alpha 0.3),
     vc_single 10 s with the merged one (6 K1, 72 K2, recorded in the
     kernels line), change_info, extract a small model from T2's G_*.pth
     and its model hash on the card and on the CPU (equal, or similarity
     >= 0.998), another model's hash below that, ids and seconds; each M
     phase prints its seconds;
 U1. UVR5 at full width: an HP5-style CascadedASPPNet (n_fft 1344,
     4band_v2, window 512, offset 128, agg 10) from a random-weight `.pth`
     in the reference layout, load_separator -> DeviceSeparator on a 30 s
     44.1 kHz mix (the voice, two tones, noise), TTA off and on, 1 warm-up
     + 3 timed: wall ms, CUDA-event spans (resample, stft, net, istft),
     the profiler's busy ms and share, windows and the window group,
     the graph's FLOPs (`last_graph_flops`) and TFLOP/s beside the fp32
     peak, peak memory, no K1/K2/K3 launch; the host path (UVR5Separator, 1 warm-up
     + 1 timed) and device
     against host (relative L2 < 0.05); a 3-minute mix's peak memory; 3 s
     on the card against the CPU (int16 within 2 LSB); the HP3 name swaps
     the stems;
 U2. the same for CascadedNetDeEcho (nout 32, nout_lstm 128, 4band_v3,
     offset 64) from `VR-DeEchoNormal_random.pth`, TTA off, its stems
     swapped;
 U3. MDX-Net: a Conv-TDF graph at the published dims (dim_f 3072, 512
     frames, n_fft 6144) written as `vocals.onnx` by the port's encoder;
     load_separator -> MDXNetDereverb on the port's ONNX executor;
     `_path_audio_` on 10 s writes both stems; demix wall ms, the graph's
     CUDA-event ms, busy ms, operations; 3 s card against CPU (relative
     L2 < 1e-4);
 U4. `python -m tpu_rvc_torch.apps.separate` in its own process on U1's
     model and a 5 s mix: both WAVs hold DeviceSeparator's output within
     2 LSB (the app reports a failure and goes on, so this check is what
     catches one); each U phase prints its seconds;
 D1. a long file across devices: a 3-minute voice (3 silence-split
     chunks in one bucket) through VC.vc_single(chunk_parallel=True) on
     make_mesh() over the visible cards, pm and rmvpe with the index, 1
     warm-up + 1 timed: wall ms, CUDA-event spans, the profiler's busy ms
     and share, peak memory, launches (6 K1 / 72 K2 a call of at most
     ROWS_PER_CALL rows), beside the sequential path's wall and launches
     on the same file; deterministic: the chunks whose own bucket is the
     common one against the sequential path (4 LSB on > 99.9% of
     samples), a mesh that names the card twice against one shard (1
     LSB), 12 s in 3 chunks of a small geometry on the card against the
     CPU (relative L2 < 1e-3); the peak memory of a 10-minute file; a
     short chunk-parallel conversion on the one-resblock model (K3);
 D2. B utterances as one batch: batch_convert of 8 x 10 s voices in a
     16 s bucket, pm and the index, one call: wall, spans, busy share,
     peak memory, launches (6 K1 / 72 K2), beside one vc_single;
     deterministic: every row against its single conversion (1 LSB on
     > 99.9% of samples); the one-resblock model on 2 rows (K3);
 D3. `python -m tpu_rvc_torch.apps.convert --chunk-parallel` in a
     process of its own on D1's file (within 2 LSB of vc_single's
     output), `apps.convert_batch` on a folder of 3 voices (3 "Success"
     lines in order, 3 files), `apps.assets gen` then `check` on a
     temporary root (exit 0, then 1 after a byte changes); then the
     kernels against their batched plain twins at D1's and D2's shapes
     (K1 also over a one-frame filler row, K2 and K3 at every decoder
     level); each D phase prints its seconds;
 W1. the web app: `apps/web.py` `Api(device="cuda")` behind its
     JSON-over-HTTP server on 127.0.0.1 (an ephemeral port, a thread):
     POST /api/infer_convert of the 10 s voice with pm and the index
     saved as a file, 1 warm-up + 2 timed (within 1 LSB of the same
     `VC.vc_single` called here, 6 K1 and 72 K2 launches, the request's
     wall beside the direct call's), the same through `stream_endpoint`'s
     worker thread, change_voice, ckpt_show, hash_similarity and a 404;
     uvr_convert twice on U1's HP5-style net and the 3 s mix (one load, a
     DeviceSeparator, no launch); stream_endpoint("train_index") on T1's
     features;
 W2. the realtime app: `apps/gui.py` `main` with --input/--output, 48 kHz,
     0.25 s blocks, pm, 8 blocks, its other settings the persisted
     defaults (the settings file in the temporary directory), engines
     deterministic; its file bit for bit against the session
     `build_session` gives fed here block by block, and a second
     `run_file` likewise; 6 K1 and 72 K2 launches a block; block p50,
     p90 and the first block's ms;
 W3. MCD on the card: the port's `utils/mcd.py` on the card against the
     CPU (within 1e-3 dB) over phase 5's float outputs before the RMS mix
     and int16, and the card-vs-CPU MCD itself under 0.1 dB with a -50
     dBFS energy floor, pm and rmvpe;
 P1. the rest of the model family offline: each of the 12 kinds {v1, v2}
     x {32k, 40k, 48k} x {f0, no f0} at full width, random weights from a
     seed (`write_model` with the preset's hparams), through one VC a
     version (v1: HuBERT's layer 9 and final_proj, 256-d; v2: layer 12)
     and a 10 s vc_single, pm (RMVPE for v1/40k), a random 10k-row index
     of the version's width for v1/32k and v2/40k: the length at the
     preset's hop and rate, finite int16, 6 K1 and 18 K2 a decoder level,
     median wall of 3 after 1 warm-up, peak memory; 1 s on the card
     against the CPU (relative L2 < 1e-3 on the float output);
 P2. the family streaming: StreamSession at the model's own rate, 0.25 s
     blocks, fused, with the index: v2/40k with RMVPE at 40 kHz and v1/32k
     (five levels, C = 16) with pm at 32 kHz, 3 warm-up and 10 timed
     blocks (p50, p90, max, blocks over 250 ms: 0, launches each block),
     then 8 deterministic blocks on the card against the CPU (relative L2
     < 1e-3) and the fused against the host path (1e-4 of full scale);
     each P phase prints its seconds;
 P3. the family serving: SlotScheduler over random-weight models with the
     index, 0.25 s blocks, 3 warm-up and 10 timed ticks as in 12: v2/40k
     (RMVPE) to 48 kHz clients, N = 1, 4, 8, serial and pipelined; v1/32k
     (pm, 90 K2 a tick) to 32 kHz clients, N = 8; v2/32k without f0 to
     48 kHz clients, N = 4; launches each tick, p50/p90/max, busy share,
     peak memory, 0 underruns; then as in 13 each stream against its own
     StreamSession (1e-4 of full scale) and two against a CPU scheduler;
 P4. the separated vocal into a 40 kHz model: the web app's
     `Api.uvr_convert` of the 30 s song with U1's HP5-style net, then
     `Api.infer_convert` of the vocal with P1's v2/40k model (pm), each
     within 1 LSB of `DeviceSeparator.separate` and `VC.vc_single` called
     directly, the output's length at 40 kHz, 6 K1 and 72 K2, the wall ms
     of each half;
 R1. FLOPs a call, TFLOP/s and MFU (`utils/roofline.py`) of the 10 s
     conversion with pm and with RMVPE (phases 3 and 7), the 48 kHz block
     (8), the N = 8 tick (12), the v2/48k bf16 step (T2, counted on a copy
     of the state) and the 30 s HP5 separation (U1), each counted at the
     end of its phase on that phase's objects and printed there with the
     phase's median wall, `device_peak_tflops` of its type and the card's
     name and power limit; each count must launch nothing, walk the
     launches the phase read and give the kernels the FLOPs of their
     formulas at the path's shapes; phase 5 counts each 1 s conversion
     on the card and on the CPU, which must be equal; a closing R1 line;
then one JSON line of kernels, the card line again, and the result line.
Each phase line carries `t_s`, the seconds since the script started.
"""

import contextlib
import functools
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32 = 67e12     # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_TF32 = 495e12    # H100 SXM dense TF32 FLOP/s on the tensor cores
TF32_PER_FP32 = 3     # 3xTF32: tensor-core products per fp32 product
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
W = 10


T0 = time.perf_counter()


def say(phase, **fields):
    """One phase line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


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
# R1: FLOPs a call, TFLOP/s and MFU of the main paths (utils/roofline.py),
# counted at the end of the phase that built each path's objects
# ---------------------------------------------------------------------------

R1_ROWS = []    # one row a counted path
R1_CPU = {}     # f0 method -> {"cuda": FLOPs, "cpu": FLOPs} (against_cpu)


def kernel_flops(attn=None, stages=(), ks=(3, 7, 11), N=1, layers=6):
    """The kernels' formulas summed over one call's launches: `layers` K1
    at `attn` (BH, T, dk) and one K2 stage (its 18 launches) at each
    (C, T) of `stages`, for N streams."""
    from tpu_rvc_torch.ops.kernels import attention_flops, stage_flops

    return {"banded_rel_attention": (layers * attention_flops(*attn)
                                     if attn else 0),
            "fused_stage": sum(stage_flops(C, T, ks, N) for C, T in stages),
            "fused_resblock": 0}


def count_path(path, count, wall_ms, dtype, launches, kernels):
    """R1 for one path: `count()` (a `last_graph_flops` or `step_flops`)
    inside the kernels' counting context.  It fails unless the count is a
    positive number, `launch_counts` does not move, the count walks the
    launches the phase read (`launches`) and the kernels' share of it is
    their formulas at the path's shapes (`kernels`).  Prints FLOPs a
    call, the phase's median wall, TFLOP/s and MFU against
    `device_peak_tflops(dtype)`, and the card's name and power limit."""
    from tpu_rvc_torch.ops.kernels import counting, launch_counts
    from tpu_rvc_torch.utils.roofline import device_peak_tflops, mfu_fields

    before = dict(launch_counts)
    t0 = time.perf_counter()
    with counting() as kc:
        flops = count()
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    if dict(launch_counts) != before:
        raise AssertionError(f"R1 {path}: the count launched kernels: "
                             f"{before} -> {dict(launch_counts)}")
    if not (isinstance(flops, float) and flops > 0):
        raise AssertionError(f"R1 {path}: count {flops!r}")
    if kc.launches != launches:
        raise AssertionError(f"R1 {path}: the count walked {kc.launches}, "
                             f"the phase launched {launches}")
    if kc.flops != kernels:
        raise AssertionError(f"R1 {path}: kernel FLOPs {kc.flops}, their "
                             f"formulas at the path's shapes {kernels}")
    peak = device_peak_tflops(dtype)
    if peak is None:
        raise AssertionError(f"R1 {path}: no {dtype} peak for "
                             f"{torch.cuda.get_device_name(0)}")
    row = dict(path=path, wall_ms_median=wall_ms,
               **mfu_fields(flops, wall_ms / 1e3, peak), dtype=str(dtype),
               peak_tflops=peak, kernel_flops=kc.flops,
               kernel_share=kc.total() / flops, count_s=count_s,
               card=card_line())
    say("R1", **row)
    R1_ROWS.append(row)


def roofline_summary():
    """R1's closing line: the five paths counted, the card's count of the
    offline conversion equal to the CPU's, the seconds the counts took."""
    want = {"offline_10s_pm", "offline_10s_rmvpe", "streaming_block_48k",
            "serving_tick_n8", "train_step_v2_48k_bf16", "uvr5_hp5_30s"}
    got = {r["path"] for r in R1_ROWS}
    if got != want:
        raise AssertionError(f"R1 counted {sorted(got)}, not {sorted(want)}")
    for method in ("pm", "rmvpe"):
        pair = R1_CPU.get(method, {})
        if len(pair) != 2 or pair["cuda"] != pair["cpu"]:
            raise AssertionError(f"R1 offline {method}: card and CPU counts "
                                 f"{pair}")
    say("R1", summary=True, paths=sorted(got), card_vs_cpu_flops=R1_CPU,
        card_equals_cpu=True, no_launch_while_counting=True,
        count_s=sum(r["count_s"] for r in R1_ROWS), card=card_line())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain twins
# ---------------------------------------------------------------------------


def check_attention(kr, g, T, lengths, phase="kernel"):
    """K1 at (BH, T, 96) for each of `lengths` (BH of them each); rows of
    (max abs err, ms, plain ms, bound ms, bound by, FMA bound ms)."""
    BH, dk = len(lengths[0]), 96
    dev = torch.device("cuda")
    mk = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    q, k, v = mk(BH, T, dk), mk(BH, T, dk), mk(BH, T, dk)
    ek, ev = mk(2 * W + 1, dk) * dk ** -0.5, mk(2 * W + 1, dk) * dk ** -0.5
    rows = []
    for lens in lengths:
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
        # below its length (Q.K^T, softmax, P.V), plus the two band terms;
        # `attention_flops`, the count R1 adds up, takes every key, as the
        # plain twin computes them, and reads no length (it would wait)
        keys = T * sum(lens)
        flops = (4 * dk + 5) * keys + 4 * BH * T * (2 * W + 1) * dk
        nbytes = 4 * (4 * BH * T * dk + 2 * (2 * W + 1) * dk) + 4 * BH
        b_ms, b_by, b_fma = bound(flops, nbytes)
        say(phase, name="banded_rel_attention", shape=[BH, T, dk],
            lengths=lens, max_abs_err=max_abs, max_rel_err=max_rel,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bound_fp32_fma_ms=b_fma)
        rows.append((max_abs, ms, plain_ms, b_ms, b_by, b_fma))
    return rows


def stage_inputs(rs, C, T, ks, g, N=1):
    """x (C, T), or (N, C, T) streams of similar audio: a common part
    plus a tenth of their own, so that a row taken from the neighbouring
    stream would be a small error."""
    dev = torch.device("cuda")
    x = torch.randn(C, T, generator=g, device=dev) * 0.3
    if N > 1:
        x = x + torch.randn(N, C, T, generator=g, device=dev) * 0.03
    w = tuple(tuple(torch.randn(k, C, C, generator=g, device=dev)
                    * (1.0 / math.sqrt(k * C)) for _ in range(6)) for k in ks)
    b = tuple(tuple(torch.randn(C, generator=g, device=dev) * 0.1
                    for _ in range(6)) for _ in ks)
    return x, rs.pack_stage(ks, (1, 3, 5), w, b)


def stage_cost(C, T, ks, N=1):
    """N streams: N x the operations and the activations, the weights
    read once."""
    from tpu_rvc_torch.ops.kernels import stage_flops

    flops = stage_flops(C, T, ks, N)
    nbytes = 4 * (2 * C * T * N + 6 * sum(ks) * C * C + 6 * len(ks) * C)
    return bound(flops, nbytes)


def stage_extra_hbm_ms(C, T, n_rb, n_d=3):
    """HBM time of the activations the per-conv launches move beyond the
    single fused launch's one read of x and one write of the output: per
    (resblock, dilation) pair conv1 reads x_in and writes u, conv2 reads u
    and x_in and writes x_new (the last pair of each resblock writes, or
    reads and writes, the stage output instead)."""
    rows = n_rb * (5 * n_d + 1) - 1 - 2
    return 4 * C * T * rows / PEAK_BYTES * 1e3


def check_stage(rs, g, name, shapes, ks, phase="kernel", N=1,
                by_stream=True, **tags):
    """K2 (or K3 with one kernel size) at each (C, T) of `shapes`, for N
    streams at once when N > 1: then the batched launch must also equal
    the same kernel launched stream by stream, bit for bit (unless
    `by_stream` is False: phase 11 holds that property)."""
    fn = rs.fused_stage if len(ks) > 1 else rs.fused_resblock
    rows = []
    for C, T in shapes:
        x, sw = stage_inputs(rs, C, T, ks, g, N)
        got = fn(x, sw)
        want = rs.stage_plain(x, sw)
        torch.cuda.synchronize()
        max_abs, max_rel = compare(got, want, 1e-3, 1e-4, f"{name} C={C}")
        extra = {}
        if N > 1 and by_stream:
            each = torch.stack([fn(x[n], sw) for n in range(N)])
            if not torch.equal(got, each):
                raise AssertionError(
                    f"{name} C={C} T={T}: the launch over {N} streams "
                    "differs from the stream-by-stream launches by "
                    f"{float((got - each).abs().max())}")
            extra = dict(streams=N, equals_stream_by_stream_bitwise=True,
                         stream_by_stream_ms=median_ms(lambda: [
                             fn(x[n], sw) for n in range(N)], iters=20))
        iters = 5 if T > 100000 else 20
        ms = median_ms(lambda: fn(x, sw), iters=iters)
        plain_ms = median_ms(lambda: rs.stage_plain(x, sw), iters=iters)
        b_ms, b_by, b_fma = stage_cost(C, T, ks, N)
        say(phase, name=name, **tags, C=C, T=T, kernel_sizes=list(ks),
            max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bound_fp32_fma_ms=b_fma, launches_per_call=6 * len(ks),
            extra_hbm_ms=stage_extra_hbm_ms(C, T * N, len(ks)), **extra)
        rows.append((max_abs, ms, plain_ms, b_ms, b_by, b_fma))
        del x, sw, got, want
    return rows


# the v2/48k decoder stages for a 16 s bucket (1598 frames)
OFFLINE_STAGES = [(256, 19176), (128, 191760), (64, 383520), (32, 767040)]
# one streaming block at 48 kHz, 0.25 s blocks, 0.05 s crossfade, 2.5 s of
# context: enc_p sees the 281-frame window, the decoder the 30-frame tail
STREAM_T = 281
STREAM_FRAMES = 30    # the decoded tail of a 0.25 s block, at any rate
STREAM_STAGES = [(256, 360), (128, 3600), (64, 7200), (32, 14400)]
BATCH_N = 8   # streams of one serving tick


def kernel_entry(name, line, rows, stream_rows, batch_rows, **extra):
    """A line of the `kernels` object: offline numbers from `rows` (the
    stages of a call summed; for K1 the last length set), streaming ones
    from `stream_rows`, those of a serving tick of BATCH_N streams from
    `batch_rows` (for K1 the equal lengths)."""
    total = lambda rs, i: sum(r[i] for r in rs)  # noqa: E731
    if name == "banded_rel_attention":
        rows, batch_rows = rows[-1:], batch_rows[:1]
    return {"name": name, "route": "cuda",
            "source": "tpu_rvc_torch/csrc/" + ("rel_attention.cu" if name ==
                                               "banded_rel_attention"
                                               else "resblock.cu"),
            "replaces": line,
            "max_abs_err": max(r[0] for r in rows + stream_rows
                               + batch_rows),
            "ms": total(rows, 1), "plain_ms": total(rows, 2),
            "bound_ms": total(rows, 3), "bound_by": rows[0][4],
            "bound_fp32_fma_ms": total(rows, 5), "math": "3xtf32",
            "library_ms": None, "stream_ms": total(stream_rows, 1),
            "stream_plain_ms": total(stream_rows, 2),
            "stream_bound_ms": total(stream_rows, 3),
            "stream_bound_by": stream_rows[0][4], "batch_n": BATCH_N,
            "batch_ms": total(batch_rows, 1),
            "batch_plain_ms": total(batch_rows, 2),
            "batch_bound_ms": total(batch_rows, 3),
            "batch_bound_by": batch_rows[0][4],
            "batch_single_stream_x_n_ms": BATCH_N * total(stream_rows, 1),
            **extra}


def check_kernels():
    """Phases 2, 6 and 11: every kernel against its plain twin at the
    offline shapes, at the streaming shapes and at those of a serving tick
    of BATCH_N streams -> the entries of the `kernels` line."""
    from tpu_rvc_torch.ops import kernels as kr
    from tpu_rvc_torch.ops.kernels import resblock as rs

    g = torch.Generator(device="cuda").manual_seed(0)
    ks = (3, 7, 11)
    stages = OFFLINE_STAGES
    k1 = check_attention(kr, g, 1598, ([1598, 1598], [1598, 1287]))
    k2 = check_stage(rs, g, "fused_stage", stages, ks)
    k3 = check_stage(rs, g, "fused_resblock", stages, (7,))
    s1 = check_attention(kr, g, STREAM_T, ([STREAM_T, STREAM_T],),
                         "kernel_stream")
    s2 = check_stage(rs, g, "fused_stage", STREAM_STAGES, ks, "kernel_stream")
    s3 = check_stage(rs, g, "fused_resblock", [(64, 7200)], (7,),
                     "kernel_stream")
    # 2 heads a stream: equal lengths (a serving tick), then unequal ones
    # (an offline batch of utterances)
    b1 = check_attention(kr, g, STREAM_T, (
        [STREAM_T] * (2 * BATCH_N), [281, 281, 250, 250, 17, 17, 1, 1] * 2),
        "kernel_batch")
    b2 = check_stage(rs, g, "fused_stage", STREAM_STAGES, ks, "kernel_batch",
                     N=BATCH_N)
    b3 = check_stage(rs, g, "fused_resblock", [(64, 7200)], (7,),
                     "kernel_batch", N=BATCH_N)
    family = check_family_kernels(rs, g)
    family["fused_stage"]["family_batch"] = check_family_batch_kernels(rs, g)
    return [
        kernel_entry("banded_rel_attention",
                     "tpu_rvc/ops/pallas/rel_attention.py:75", k1, s1, b1),
        kernel_entry("fused_stage", "tpu_rvc/ops/pallas/resblock.py:163",
                     k2, s2, b2, per_stage_ms=[r[1] for r in k2],
                     stream_per_stage_ms=[r[1] for r in s2],
                     batch_per_stage_ms=[r[1] for r in b2],
                     **family["fused_stage"]),
        kernel_entry("fused_resblock", "tpu_rvc/ops/pallas/resblock.py:237",
                     k3, s3, b3, **family["fused_resblock"])]


def preset_levels(version, sr, frames=1598):
    """The decoder levels (C, T) of a preset's model for a bucket of
    `frames` frames (16 s: 1598): C halves and T grows by the level's
    upsample rate, level by level."""
    from tpu_rvc_torch.core.config import hparams_for

    m = hparams_for(version, sr).model
    levels, T = [], frames
    for i, u in enumerate(m.upsample_rates):
        T *= u
        levels.append((m.upsample_initial_channel >> (i + 1), T))
    return levels


# the decoders other than v2/48k's (v2/40k's is v1/40k's); v1/32k and v1/48k
# have a fifth level at C = 16, the build no other phase launches
FAMILY_DECODERS = [("v1", 32000), ("v1", 40000), ("v1", 48000),
                   ("v2", 32000)]
# T % 4 != 0 takes the kernel's scalar staging and epilogue paths: a
# streaming block's first level at an odd frame count, and a C = 16 level
UNALIGNED = [(256, 290), (16, 2321)]


def check_family_kernels(rs, g):
    """Phase 2's rows for the rest of the model family: K2 at every
    decoder level of each of FAMILY_DECODERS (16 s bucket), K3 at v1/32k's
    and v1/40k's levels and v1/48k's C = 16 level, both at the UNALIGNED
    shapes -> per kernel, the extra keys of the `kernels` line."""
    ks = (3, 7, 11)
    total = lambda rows, i: sum(r[i] for r in rows)  # noqa: E731

    def summary(rows, shapes):
        return {"levels": [list(s) for s in shapes],
                "ms": total(rows, 1), "plain_ms": total(rows, 2),
                "bound_ms": total(rows, 3), "bound_by": rows[0][4],
                "per_level_ms": [r[1] for r in rows],
                "per_level_bound_ms": [r[3] for r in rows],
                "max_abs_err": max(r[0] for r in rows)}

    out = {}
    k3_shapes = {"v1/32k": preset_levels("v1", 32000),
                 "v1/40k": preset_levels("v1", 40000),
                 "v1/48k C=16": preset_levels("v1", 48000)[-1:]}
    for name, kernel_sizes, presets in (
            ("fused_stage", ks, {f"{v}/{sr // 1000}k": preset_levels(v, sr)
                                 for v, sr in FAMILY_DECODERS}),
            ("fused_resblock", (7,), k3_shapes)):
        fam = {}
        for key, shapes in presets.items():
            rows = check_stage(rs, g, name, shapes, kernel_sizes,
                               "kernel_family", preset=key)
            fam[key] = summary(rows, shapes)
        rows = check_stage(rs, g, name, UNALIGNED, kernel_sizes,
                           "kernel_unaligned")
        out[name] = {"family": fam,
                     "unaligned": [dict(C=C, T=T, max_abs_err=r[0], ms=r[1],
                                        plain_ms=r[2], bound_ms=r[3],
                                        bound_by=r[4])
                                   for (C, T), r in zip(UNALIGNED, rows)]}
    return out


# the serving ticks of other kinds (P3): the stream axis's levels for a
# 30-frame block tail at five levels down to C = 16 (v1/32k) and at 40k's
# four (v2/40k); and the UNALIGNED shapes with a stream axis
FAMILY_STREAM_DECODERS = [("v1", 32000), ("v2", 40000)]


def check_family_batch_kernels(rs, g):
    """Phase 2's stream-axis rows for the rest of the family: K2 at
    (BATCH_N, C, T) for each streaming level of FAMILY_STREAM_DECODERS and
    at the UNALIGNED shapes, against the plain twin and, bit for bit,
    against stream-by-stream launches -> the `family_batch` keys."""
    ks = (3, 7, 11)
    cases = {f"{v}/{sr // 1000}k": preset_levels(v, sr, STREAM_FRAMES)
             for v, sr in FAMILY_STREAM_DECODERS}
    cases["unaligned"] = UNALIGNED
    out = {"streams": BATCH_N}
    for key, shapes in cases.items():
        rows = check_stage(rs, g, "fused_stage", shapes, ks,
                           "kernel_family_batch", N=BATCH_N, preset=key)
        out[key] = [dict(C=C, T=T, max_abs_err=r[0], ms=r[1], plain_ms=r[2],
                         bound_ms=r[3], bound_by=r[4])
                    for (C, T), r in zip(shapes, rows)]
    return out


# ---------------------------------------------------------------------------
# phases 3-5 and 7: conversions through the entry points
# ---------------------------------------------------------------------------


def write_model(path, hp, seed, resblock_kernel_sizes=None, ups_gain=5.0,
                use_f0=True):
    """A random-weight small model `.pth` in the reference layout (fp16
    weights, as RVC stores them).  `ups_gain` scales the upsamplers'
    weights from their initialisation's std of 0.01 towards a trained
    model's: at 0.01 the audio is the decoder's bias pattern, periodic in
    the last hop whatever the input, so every SOLA offset one period apart
    correlates equally (margins of 1e-7 between the best two), rounding
    picks one, and two runs of a stream cannot be compared sample by
    sample.  At 5x the margins are near 1e-2 and the peak near 0.3."""
    import dataclasses
    from tpu_rvc_torch.models.synthesizer import make_synthesizer

    m = hp.model
    if resblock_kernel_sizes is not None:
        m = dataclasses.replace(
            m, resblock_kernel_sizes=tuple(resblock_kernel_sizes),
            resblock_dilation_sizes=((1, 3, 5),) * len(resblock_kernel_sizes))
        hp = dataclasses.replace(hp, model=m)
    net = make_synthesizer(hp, use_f0=use_f0, device="cpu", seed=seed)
    with torch.no_grad():
        for up in net.dec.ups:
            up.weight.mul_(ups_gain)
    config = [hp.data.spec_channels, hp.train.segment_size, m.inter_channels,
              m.hidden_channels, m.filter_channels, m.n_heads, m.n_layers,
              m.kernel_size, m.p_dropout, m.resblock,
              list(m.resblock_kernel_sizes),
              [list(d) for d in m.resblock_dilation_sizes],
              list(m.upsample_rates), m.upsample_initial_channel,
              list(m.upsample_kernel_sizes), m.spk_embed_dim, m.gin_channels,
              hp.data.sampling_rate]
    torch.save({"weight": {k: v.half() for k, v in net.state_dict().items()},
                "config": config, "f0": int(use_f0), "version": hp.version,
                "sr": f"{hp.data.sampling_rate // 1000}k",
                "info": "random weights"}, path)


def voice(seconds, seed, sr=16000):
    """Voiced harmonics on a gliding pitch, breath noise and a silent gap."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = 160 + 60 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 6))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 1.7 * t) ** 2)
    x = x + 0.01 * rng.standard_normal(t.shape)
    gap = slice(int(sr * seconds * 0.4), int(sr * seconds * 0.46))
    x[gap] = 0.0
    return x.astype(np.float32)


def write_voice(path, seconds, seed):
    from tpu_rvc_torch.audio.io import save_wav

    save_wav(path, voice(seconds, seed), 16000)


def write_rmvpe(tmp, seed):
    """A random-weight full-width `rmvpe.pt` (E2E(4, 1, (2, 2))) in the
    reference key layout, BatchNorm statistics drawn -> its directory."""
    from tpu_rvc_torch.ckpt.rmvpe_loader import random_rmvpe_reference_state

    torch.save(random_rmvpe_reference_state(seed),
               os.path.join(tmp, "rmvpe.pt"))
    return tmp


def expected_len(n16, x_pad, hop, tgt_sr):
    from tpu_rvc_torch.pipeline.vc import WINDOW, _bucket, _feat_frames

    L_true = n16 + 2 * int(16000 * x_pad)
    L = _bucket(L_true)
    frames = min(L_true // WINDOW, min(L // WINDOW, _feat_frames(L)))
    return frames * hop - 2 * int(tgt_sr * x_pad)


def want_launches(hp, calls=1, n_rb=None):
    """K1 and K2 (or K3 on a one-resblock model) launches of `calls`
    device calls of `Synthesizer.infer`: 6 K1 and 18 K2 a decoder level
    each (72 at four levels, 90 at five)."""
    n_rb = len(hp.model.resblock_kernel_sizes) if n_rb is None else n_rb
    stage = 6 * n_rb * len(hp.model.upsample_rates) * calls
    return {"banded_rel_attention": hp.model.n_layers * calls,
            "fused_stage": stage if n_rb > 1 else 0,
            "fused_resblock": stage if n_rb == 1 else 0}


def v2_48k_launches():
    """The launches of one call of the v2/48k models of phases 3-W3."""
    from tpu_rvc_torch.core.config import hparams_for

    return want_launches(hparams_for("v2", 48000))


def check_output(audio, n_expected, what):
    audio = np.asarray(audio)
    if audio.dtype != np.int16 or audio.shape != (n_expected,):
        raise AssertionError(f"{what}: got {audio.dtype} {audio.shape}, "
                             f"expected int16 ({n_expected},)")
    if not np.isfinite(audio.astype(np.float32)).all() or \
            np.abs(audio).max() == 0:
        raise AssertionError(f"{what}: output is not finite audio")


def end_to_end(tmp, f0_method, phase, count=False):
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.vc import VC
    from tpu_rvc_torch.utils import timing

    hp = hparams_for("v2", 48000)
    model = os.path.join(tmp, "v2_48k.pth")
    wav = os.path.join(tmp, "voice_10s.wav")
    if not os.path.exists(model):
        write_model(model, hp, seed=0)
        write_voice(wav, 10.0, seed=1)
    index = random_index()

    vc = VC(rmvpe_root=tmp, hubert_path="random")
    t0 = time.perf_counter()
    vc.get_vc(model)
    load_s = time.perf_counter() - t0
    n_expected = expected_len(160000, vc.x_pad, 480, 48000)
    kw = dict(f0_method=f0_method, index=index, index_rate=0.75)
    torch.cuda.reset_peak_memory_stats()
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
    if count:   # R1: the 1598-frame window, the four 16 s decoder levels
        count_path(f"offline_10s_{f0_method}", vc.pipeline.last_graph_flops,
                   float(np.median(walls)), torch.float32, counts,
                   kernel_flops((2, 1598, 96), OFFLINE_STAGES))
    say(phase, model="v2/48k random weights", f0_method=f0_method,
        input_s=10.0, index_rows=10000, load_s=load_s, wall_ms=walls,
        wall_ms_median=float(np.median(walls)), stage_ms=split,
        output_samples=int(audio.shape[0]), sr=sr, info=info,
        launches=counts, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return counts


def random_index(dim=768):
    from tpu_rvc_torch.retrieval.index import FeatureIndex

    vecs = np.random.default_rng(2).standard_normal((10000, dim)).astype(
        np.float32)
    return FeatureIndex(vecs, (vecs * vecs).sum(1))


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


def against_cpu(tmp, methods=("pm", "rmvpe"), phase="against_cpu",
                estimators=None, count=False):
    """The same deterministic conversion on the card and on the CPU, for
    each f0 method; `estimators(device)` gives estimators to put in the
    pipeline's generator (CREPE has no default file).  Returns, by
    method, the (card, CPU) float outputs before the RMS mix and int16,
    trimmed as the int16 output is.  With `count`, R1's check: each
    conversion's `last_graph_flops` on the card and on the CPU, which
    must be equal."""
    from tpu_rvc_torch.ops.kernels import launch_counts
    from tpu_rvc_torch.audio.io import load_audio
    from tpu_rvc_torch.models.hubert import hubert_for_version
    from tpu_rvc_torch.models.loader import load_synthesizer
    from tpu_rvc_torch.pipeline.vc import Pipeline

    model = os.path.join(tmp, "v2_48k.pth")
    wav = os.path.join(tmp, "voice_1s.wav")
    write_voice(wav, 1.0, seed=5)
    audio = load_audio(wav, 16000)
    outs = {m: [] for m in methods}
    floats = {m: [] for m in methods}
    for dev in ("cuda", "cpu"):
        synth, _ = load_synthesizer(model, dev)
        pipe = Pipeline(48000, hubert=hubert_for_version("v2", dev),
                        synth=synth, x_pad=0.5, rmvpe_root=tmp,
                        noise_scale=0.0, deterministic=True, device=dev)
        if estimators is not None:
            pipe.f0_gen._estimators.update(estimators(dev))
        rows = []
        convert_rows = pipe._convert_rows

        def spy(*args, **kw):   # the synthesizer's float rows
            out = convert_rows(*args, **kw)
            rows.append(out[0].double().cpu().numpy())
            return out

        pipe._convert_rows = spy
        for method in outs:
            outs[method].append(pipe.pipeline(
                0, audio, [0.0, 0.0, 0.0], 0, method, None, 0.0, 1, 3, 0,
                0.25, 0.33).astype(np.float64))
            n = outs[method][-1].shape[0]
            floats[method].append(
                rows[-1][pipe.t_pad_tgt: pipe.t_pad_tgt + n])
            if count:   # after the spy's row is read: the count adds one
                before = dict(launch_counts)
                R1_CPU.setdefault(method, {})[dev] = pipe.last_graph_flops()
                if dict(launch_counts) != before:
                    raise AssertionError(f"R1 {method} on {dev}: the count "
                                         "launched kernels")
    for method, (gpu, cpu) in outs.items():
        rel = rel_l2(gpu, cpu, f"offline {method}")
        say(phase, f0_method=method, input_s=1.0,
            samples=int(gpu.shape[0]), rel_l2_err=rel,
            max_abs_int16=float(np.abs(gpu - cpu).max()),
            flops_card_cpu=R1_CPU.get(method) if count else None)
    return floats


def rel_l2(gpu, cpu, what, limit=1e-3):
    if gpu.shape != cpu.shape:
        raise AssertionError(f"{what}: card {gpu.shape} vs cpu {cpu.shape}")
    rel = float(np.linalg.norm(gpu - cpu) / max(np.linalg.norm(cpu), 1e-9))
    if not rel <= limit:
        raise AssertionError(f"{what}: card vs CPU relative error {rel} > "
                             f"{limit}")
    return rel


# ---------------------------------------------------------------------------
# phases 8-10: streaming through RealtimeVC and StreamSession
# ---------------------------------------------------------------------------

STREAM = dict(samplerate=48000, block_time=0.25, crossfade_time=0.05,
              extra_time=2.5)


def stream_engine(model, tmp, dev, index=None, version="v2", **kw):
    from tpu_rvc_torch.models.hubert import hubert_for_version
    from tpu_rvc_torch.models.loader import load_synthesizer
    from tpu_rvc_torch.pipeline.rt import RealtimeVC

    synth, _ = load_synthesizer(model, dev)
    return RealtimeVC(hubert=hubert_for_version(version, dev), synth=synth,
                      version=version, index=index,
                      index_rate=0.75 if index is not None else 0.0,
                      rmvpe_root=tmp, device=dev, **kw)


def forbid_host_waits(graph):
    """Make the next call of the fused graph's device side raise if
    anything in it synchronises the host with the card (PyTorch's sync
    debug mode); the upload before it and the fetch after it are outside."""
    inner = graph._block

    def guarded(*args):
        graph._block = inner
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    graph._block = guarded


def watch_sola(sess, margins):
    """Record, per block, how far the best SOLA offset's normalised
    correlation lies above the second best's, relative to it: outputs of
    two runs can only be compared sample by sample where that margin is
    far above their rounding differences."""
    merge = sess._merge_block

    def watched(infer_wav):
        n = sess.sola_buffer_frame + sess.sola_search_frame
        head = infer_wav[:n]
        nom = np.correlate(head, sess.sola_buffer, mode="valid")
        den = np.sqrt(np.convolve(head ** 2, np.ones(sess.sola_buffer_frame),
                                  mode="valid") + 1e-8)
        r = np.sort(nom / den)
        if sess.sola_buffer.any():  # not the first block's silence
            margins.append(float((r[-1] - r[-2]) / max(abs(r[-1]), 1e-12)))
        return merge(infer_wav)

    sess._merge_block = watched


def feed_blocks(sess, audio, first, n, each=None):
    outs = []
    for i in range(first, first + n):
        block = audio[i * sess.block_frame: (i + 1) * sess.block_frame]
        t0 = time.perf_counter()
        out = sess.feed(block)
        wall = (time.perf_counter() - t0) * 1e3
        if out.shape != (sess.block_frame,) or out.dtype != np.float32 or \
                not np.isfinite(out).all() or np.abs(out).max() == 0:
            raise AssertionError(f"block {i}: {out.dtype} {out.shape} is "
                                 "not a block of finite, non-zero audio")
        outs.append(out)
        if each is not None:
            each(i, wall)
    return np.concatenate(outs)


def device_busy_ms(fn):
    """Device time of the kernels and copies `fn` runs, by torch.profiler:
    (total ms, [(name, ms, calls)] largest first), or (None, []) where the
    profiler saw no device activity.  Only events of the device
    count: a host-side operator's row repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # a record_function range (the optimizers' `Optimizer.step#...`)
        # shows on the device timeline too, spanning kernels counted below
        if e.device_type != DeviceType.CUDA or "#" in e.key or \
                getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return (total if total > 0 else None), rows


def stage_key_us(dec, reps=200):
    """Host µs a block spends keying the decoder's stage-weight cache (every
    stage, as `_resblock_stage` does once a stage a block)."""
    from tpu_rvc_torch.nn.generators import stage_key

    k = dec.num_kernels
    stages = [dec.resblocks[i * k:(i + 1) * k] for i in range(len(dec.ups))]
    t0 = time.perf_counter()
    for _ in range(reps):
        for blocks in stages:
            stage_key(blocks)
    return (time.perf_counter() - t0) / reps * 1e6


def export_check_us(sess, audio, first, reps=100000):
    """Host µs one block spends on what keeps `torch.export` off the
    kernels and the hash's noise off the card's generator: the port's calls
    of `torch.compiler.is_exporting()` (each attention layer, each decoder
    stage) and of the noise draws' wrapper (`core/device.py` `_draw`, a
    device move on top of the draw).  Counts one block's calls, then times
    each call alone -> (checks, draws, µs a check, µs a wrapper, total)."""
    from tpu_rvc_torch.core import device as device_mod

    real_check, real_draw = torch.compiler.is_exporting, device_mod._draw
    n = {"check": 0, "draw": 0}

    def counted_check():
        if sys._getframe(1).f_globals["__name__"].startswith("tpu_rvc_torch"):
            n["check"] += 1
        return real_check()

    def counted_draw(*args):
        n["draw"] += 1
        return real_draw(*args)

    torch.compiler.is_exporting, device_mod._draw = counted_check, counted_draw
    try:
        feed_blocks(sess, audio, first, 1)
    finally:
        torch.compiler.is_exporting, device_mod._draw = real_check, real_draw
    t0 = time.perf_counter()
    for _ in range(reps):
        real_check()
    check_us = (time.perf_counter() - t0) / reps * 1e6
    like = torch.zeros(1, device="cuda")
    fn = lambda shape, **kw: like  # noqa: E731  the draw itself left out
    wrapped = lambda: real_draw(fn, (1,), None, like)  # noqa: E731  as
    t0 = time.perf_counter()                           # draw_normal does
    for _ in range(reps):
        wrapped()
    wrap_us = (time.perf_counter() - t0) / reps * 1e6
    t0 = time.perf_counter()
    for _ in range(reps):
        fn((1,), generator=None, device=like.device, dtype=like.dtype)
    wrap_us -= (time.perf_counter() - t0) / reps * 1e6
    return (n["check"], n["draw"], check_us, wrap_us,
            n["check"] * check_us + n["draw"] * wrap_us)


def streaming(tmp, n_warm=3, n_timed=10, n_profiled=4, f0method="rmvpe",
              paths=(True, False), phase="streaming", count=False):
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.rt import StreamSession
    from tpu_rvc_torch.utils import timing

    model = os.path.join(tmp, "v2_48k.pth")
    index = random_index()
    n_all = n_warm + n_timed + n_profiled
    audio = voice(n_all * 0.25, seed=6, sr=48000)
    want = v2_48k_launches()
    for fused in paths:
        sess = StreamSession(stream_engine(model, tmp, "cuda", index),
                             f0method=f0method, fused=fused, **STREAM)
        if (sess._fused is not None) != fused:
            raise AssertionError(f"fused={fused} session took the other path")
        geo = sess.geometry
        if (geo.total, geo.skip_head, geo.return_length) != (134880, 250, 30):
            raise AssertionError("block geometry changed")
        feed_blocks(sess, audio, 0, 1)
        if fused:
            forbid_host_waits(sess._fused)
        feed_blocks(sess, audio, 1, n_warm - 1)
        walls, spans, margins = [], [], []
        watch_sola(sess, margins)

        def each(i, wall):
            walls.append(wall)
            spans.append(timing.read())
            counts = dict(launch_counts)
            if counts != want:
                raise AssertionError(f"block {i}: launches {counts}, "
                                     f"expected {want}")
            reset_launch_counts()
            timing.enable()

        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        timing.enable()
        feed_blocks(sess, audio, n_warm, n_timed, each)
        timing.disable()
        split = {k: float(np.median([s.get(k, 0.0) for s in spans]))
                 for k in spans[-1]}
        busy, top = None, []
        if fused:  # the profiler's own start-up costs seconds: once
            busy, top = device_busy_ms(lambda: feed_blocks(
                sess, audio, n_warm + n_timed, n_profiled))
        wall = float(np.median(walls))
        if fused and count:   # R1: a 281-frame window, a 30-frame tail
            count_path("streaming_block_48k", sess._fused.last_graph_flops,
                       wall, torch.float32, want,
                       kernel_flops((2, STREAM_T, 96), STREAM_STAGES))
        checks, draws, check_us, wrap_us, added_us = export_check_us(
            sess, audio, n_warm + n_timed + n_profiled - 1)
        say(phase, path="fused" if fused else "host",
            stage_key_us_per_block=stage_key_us(sess.engine.synth.dec),
            export_checks_per_block=checks, noise_draws_per_block=draws,
            us_per_export_check=check_us, us_per_draw_wrapper=wrap_us,
            export_check_us_per_block=added_us,
            model="v2/48k random weights", f0method=f0method,
            index_rows=10000, block_s=0.25, window_frames=geo.total // geo.zc,
            blocks=n_timed, wall_ms_median=wall,
            wall_ms_max=float(np.max(walls)),
            wall_ms_p90=float(np.percentile(walls, 90)), stage_ms=split,
            stage_ms_sum=float(sum(split.values())),
            launches_per_block=want,
            no_host_wait_between_upload_and_fetch=True if fused else None,
            profiled_blocks=n_profiled if fused else 0,
            device_busy_ms_per_block=(busy / n_profiled if busy else None),
            device_busy_share_of_wall=(busy / n_profiled / wall if busy
                                       else None),
            top_kernels_ms_per_block=[
                [name[:60], ms / n_profiled, calls / n_profiled]
                for name, ms, calls in top[:8]],
            sola_margin_min=float(np.min(margins)),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return want


def streaming_single_resblock(tmp, n_blocks=5):
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.rt import StreamSession

    sess = StreamSession(
        stream_engine(os.path.join(tmp, "v2_48k_rb1.pth"), tmp, "cuda"),
        f0method="pm", **STREAM)
    audio = voice(n_blocks * 0.25, seed=7, sr=48000)
    want = {"banded_rel_attention": 6, "fused_stage": 0, "fused_resblock": 24}
    walls = []

    def each(i, wall):
        walls.append(wall)
        counts = dict(launch_counts)
        if counts != want:
            raise AssertionError(f"block {i}: launches {counts}, expected "
                                 f"{want}")
        reset_launch_counts()

    reset_launch_counts()
    feed_blocks(sess, audio, 0, n_blocks, each)
    say("streaming_single_resblock", blocks=n_blocks, f0method="pm",
        wall_ms=walls, launches_per_block=want)
    return want


def streaming_against_cpu(tmp, n_blocks=8, methods=("pm", "rmvpe"),
                          phase="streaming_against_cpu"):
    """The same deterministic stream on the card and on the CPU, fused
    path, pm and rmvpe; and on the card the fused path against the host
    path.  The rmvpe weights are random but not saturated, so its argmax
    has no exact ties; a near-tie may still move a frame by one 20-cent
    bin between card and CPU, which the 1e-3 covers or does not."""
    from tpu_rvc_torch.pipeline.rt import StreamSession

    model = os.path.join(tmp, "v2_48k.pth")
    audio = voice(n_blocks * 0.25, seed=8, sr=48000)
    for method in methods:
        outs, margins = {}, []
        for dev, fused in (("cuda", True), ("cuda", False), ("cpu", True)):
            eng = stream_engine(model, tmp, dev, noise_scale=0.0,
                                deterministic=True)
            sess = StreamSession(eng, f0method=method, protect=0.33,
                                 fused=fused, **STREAM)
            watch_sola(sess, margins)
            outs[dev, fused] = feed_blocks(sess, audio, 0, n_blocks
                                           ).astype(np.float64)
        rel = rel_l2(outs["cuda", True], outs["cpu", True],
                     f"streaming {method}")
        host = float(np.abs(outs["cuda", True] - outs["cuda", False]).max())
        say(phase, f0method=method, blocks=n_blocks,
            samples=int(outs["cpu", True].shape[0]), rel_l2_err=rel,
            max_abs_err=float(np.abs(outs["cuda", True]
                                     - outs["cpu", True]).max()),
            fused_vs_host_max_abs=host, sola_margin_min=float(min(margins)))
        if not host <= 1e-4:
            raise AssertionError(f"streaming {method}: fused path differs "
                                 f"from host path by {host} > 1e-4")


# ---------------------------------------------------------------------------
# phases 12-15: multi-stream serving through SlotScheduler and the TCP server
# ---------------------------------------------------------------------------


def still_clock():
    """A clock that stands still: no slot ever counts as overdue, so a
    phase that pauses between ticks (to run its reference) sees no
    underrun of the wall clock's making."""
    return 0.0


def client_voices(n, seconds, first_seed, sr=48000):
    return [voice(seconds, seed=first_seed + i, sr=sr) for i in range(n)]


def check_blocks(outs, bf, what):
    for s, out in enumerate(outs):
        if out.shape != (bf,) or out.dtype != np.float32 or \
                not np.isfinite(out).all() or np.abs(out).max() == 0:
            raise AssertionError(f"{what}, slot {s}: {out.dtype} {out.shape} "
                                 "is not a block of finite, non-zero audio")


def lockstep_tick(sched, slots, audios, i, each=None):
    """Submit block i of every client, one tick, collect: [(slot's audio)]
    and the tick's wall ms."""
    bf = sched.block_frame
    for slot, audio in zip(slots, audios):
        sched.submit(slot, audio[i * bf: (i + 1) * bf])
    t0 = time.perf_counter()
    sched.tick()
    wall = (time.perf_counter() - t0) * 1e3
    outs = [sched.collect(slot) for slot in slots]
    if each is not None:
        each(i, wall)
    return outs


def serving(tmp, n_slots, n_warm, n_timed, n_profiled=4, f0method="rmvpe",
            modes=(False, True), phase="serving", kind=("v2", 48000, True),
            samplerate=48000, count=False):
    """Phase 12 for one N (P3 for another `kind` (version, sr, use_f0) of
    model, the index of its phone width, clients at `samplerate`):
    serial, then pipelined, on the same audio.  Returns the launches of
    the last timed tick, as read."""
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.serve import SlotScheduler
    from tpu_rvc_torch.utils import timing

    version, sr, use_f0 = kind
    hp = hparams_for(version, sr)
    model = family_model(tmp, version, sr, use_f0)   # v2/48k: phase 3's
    engine = stream_engine(model, tmp, "cuda",
                           random_index(hp.encoder_dim), version)
    n_all = n_warm + n_timed + n_profiled
    audios = client_voices(n_slots, n_all * 0.25, 20, samplerate)
    want = want_launches(hp)
    streams, tick_counts = {}, {}
    for pipelined in modes:
        sched = SlotScheduler(engine, n_slots, f0method=f0method,
                              pipelined=pipelined,
                              **dict(STREAM, samplerate=samplerate))
        bf = sched.block_frame
        slots = [sched.attach() for _ in range(n_slots)]
        got = [[] for _ in slots]

        def keep(outs, i):
            # serial: tick i delivers block i; pipelined: block i - 1
            expect = bf if (not pipelined or i > 0) else 0
            for s, out in enumerate(outs):
                if len(out) != expect:
                    raise AssertionError(
                        f"N={n_slots} pipelined={pipelined} tick {i} slot "
                        f"{s}: {len(out)} samples, expected {expect}")
                got[s].append(out)
            if expect:
                check_blocks(outs, bf, f"N={n_slots} tick {i}")

        keep(lockstep_tick(sched, slots, audios, 0), 0)
        forbid_host_waits(sched.fused)   # tick 1: the constants are up
        for i in range(1, n_warm):
            keep(lockstep_tick(sched, slots, audios, i), i)
        walls, spans = [], []

        def each(i, wall):
            walls.append(wall)
            counts = dict(launch_counts)
            if counts != want:
                raise AssertionError(f"N={n_slots} tick {i}: launches "
                                     f"{counts}, expected {want}")
            tick_counts.update(counts)
            reset_launch_counts()
            if not pipelined:   # reading the spans waits for the device
                spans.append(timing.read())
                timing.enable()

        torch.cuda.synchronize()
        gc.collect()   # what earlier phases left is not this phase's peak
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        if not pipelined:
            timing.enable()
        t_all = time.perf_counter()
        for i in range(n_warm, n_warm + n_timed):
            keep(lockstep_tick(sched, slots, audios, i, each), i)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t_all) * 1e3
        timing.disable()
        busy, top = None, []
        if not pipelined:   # the profiler's own start-up costs seconds
            first = n_warm + n_timed
            busy, top = device_busy_ms(lambda: [
                keep(lockstep_tick(sched, slots, audios, i), i)
                for i in range(first, first + n_profiled)])
        sched.flush()
        for s, slot in enumerate(slots):
            got[s].append(sched.collect(slot))
        stats = sched.stats()
        n_ticks = n_all if not pipelined else n_warm + n_timed
        if stats["underruns"] != [0] * n_slots or \
                stats["blocks"] != [n_ticks] * n_slots:
            raise AssertionError(f"N={n_slots} pipelined={pipelined}: "
                                 f"stats {stats}")
        streams[pipelined] = [np.concatenate(g)[: (n_warm + n_timed) * bf]
                              for g in got]
        split = ({k: float(np.median([sp.get(k, 0.0) for sp in spans]))
                  for k in spans[-1]} if spans else None)
        wall = float(np.median(walls))
        if count and not pipelined:   # R1: K1 over 2N heads, K2 over N
            count_path(f"serving_tick_n{n_slots}",
                       sched.fused.last_graph_flops, wall, torch.float32,
                       want, kernel_flops((2 * n_slots, STREAM_T, 96),
                                          STREAM_STAGES, N=n_slots))
        say(phase, mode="pipelined" if pipelined else "serial",
            slots=n_slots, model=f"{kind_name(*kind)} random weights",
            f0method=f0method if use_f0 else None, samplerate=samplerate,
            levels=len(hp.model.upsample_rates),
            index_rows=10000, block_s=0.25, ticks=n_timed,
            tick_wall_ms_median=wall,
            tick_wall_ms_p90=float(np.percentile(walls, 90)),
            tick_wall_ms_max=float(np.max(walls)),
            run_ms_per_tick=run_ms / n_timed,
            ms_per_stream_block=run_ms / n_timed / n_slots,
            stage_ms=split,
            stage_ms_sum=float(sum(split.values())) if split else None,
            launches_per_tick=dict(tick_counts),
            no_host_wait_between_upload_and_fetch=True,
            profiled_ticks=n_profiled if busy else 0,
            device_busy_ms_per_tick=(busy / n_profiled if busy else None),
            device_busy_share_of_wall=(busy / n_profiled / wall if busy
                                       else None),
            top_kernels_ms_per_tick=[
                [name[:60], ms / n_profiled, calls / n_profiled]
                for name, ms, calls in top[:8]],
            underruns=stats["underruns"],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if len(modes) < 2:
        return tick_counts
    # the two timed runs drew the same noise (the generator is seeded with
    # the graph's step), so they differ only by what differs between any
    # two runs on the card: cuDNN's default algorithm for the decoder's
    # transposed convolutions adds with atomics.  `pipelined_exact` holds
    # the two modes sample for sample under cuDNN's deterministic ones.
    diff = max(float(np.abs(streams[True][s] - streams[False][s]).max())
               for s in range(n_slots))
    if not diff <= 1e-5:
        raise AssertionError(f"N={n_slots}: the pipelined streams differ "
                             f"from the serial ones by {diff} > 1e-5")
    say("pipelined_against_serial_timed_runs", slots=n_slots,
        model=kind_name(*kind),
        samples_per_slot=int(streams[True][0].shape[0]), max_abs_diff=diff,
        limit=1e-5, delivered="one tick later, the last block by flush()")
    return tick_counts


def pipelined_exact(tmp, n_slots=4, n_blocks=5):
    """Pipelined against serial, sample for sample: the same deterministic
    engine, cuDNN held to its deterministic algorithms for both runs."""
    from tpu_rvc_torch.pipeline.serve import SlotScheduler

    engine = stream_engine(os.path.join(tmp, "v2_48k.pth"), tmp, "cuda",
                           noise_scale=0.0, deterministic=True)
    audios = client_voices(n_slots, n_blocks * 0.25, 60)
    pieces = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for pipelined in (False, True):
            sched = SlotScheduler(engine, n_slots, f0method="rmvpe",
                                  clock=still_clock, pipelined=pipelined,
                                  **STREAM)
            slots = [sched.attach() for _ in range(n_slots)]
            got = [[] for _ in slots]
            for i in range(n_blocks):
                for s, out in enumerate(lockstep_tick(sched, slots, audios,
                                                      i)):
                    got[s].append(out)
            sched.flush()
            for s, slot in enumerate(slots):
                got[s].append(sched.collect(slot))
            pieces[pipelined] = got
    finally:
        torch.backends.cudnn.deterministic = saved
    bf = sched.block_frame
    for s in range(n_slots):
        ser, pip = pieces[False][s], pieces[True][s]
        if [len(x) for x in ser] != [bf] * n_blocks + [0] or \
                [len(x) for x in pip] != [0] + [bf] * n_blocks:
            raise AssertionError(f"slot {s}: delivered "
                                 f"{[len(x) for x in ser]} serial, "
                                 f"{[len(x) for x in pip]} pipelined")
        ser, pip = np.concatenate(ser), np.concatenate(pip)
        if not np.array_equal(pip, ser):
            raise AssertionError(f"slot {s}: the pipelined stream differs "
                                 "from the serial one by "
                                 f"{np.abs(pip - ser).max()}")
    say("pipelined_exact", slots=n_slots, blocks=n_blocks,
        sample_exact=True, cudnn_deterministic=True,
        delivered="one tick later, the last block by flush()")


def serving_single_resblock(tmp, n_slots=4, n_ticks=3):
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.serve import SlotScheduler

    sched = SlotScheduler(
        stream_engine(os.path.join(tmp, "v2_48k_rb1.pth"), tmp, "cuda"),
        n_slots, f0method="pm", **STREAM)
    audios = client_voices(n_slots, n_ticks * 0.25, 40)
    slots = [sched.attach() for _ in range(n_slots)]
    want = {"banded_rel_attention": 6, "fused_stage": 0, "fused_resblock": 24}
    walls = []

    def each(i, wall):
        walls.append(wall)
        counts = dict(launch_counts)
        if counts != want:
            raise AssertionError(f"tick {i}: launches {counts}, expected "
                                 f"{want}")
        reset_launch_counts()

    reset_launch_counts()
    for i in range(n_ticks):
        check_blocks(lockstep_tick(sched, slots, audios, i, each),
                     sched.block_frame, f"single-resblock tick {i}")
    say("serving_single_resblock", slots=n_slots, ticks=n_ticks,
        f0method="pm", tick_wall_ms=walls, launches_per_tick=want)
    return want


def streams_against_sessions(tmp, n_slots=8, n_blocks=8, n_cpu=2,
                             f0method="rmvpe", n_own=None,
                             fed_and_churn=True,
                             phase="streams_against_sessions",
                             kind=("v2", 48000, True), samplerate=48000):
    """Phase 13 (F3 with fcpe: the first `n_own` streams, no CPU
    scheduler, no fed/churn ticks; P3 with another `kind` of model and
    clients at `samplerate`, as `serving`).  Deterministic engines; the
    scheduler reads a clock that stands still, since the reference
    sessions run between its ticks."""
    from tpu_rvc_torch.pipeline.rt import StreamSession
    from tpu_rvc_torch.pipeline.serve import SlotScheduler

    version, sr, use_f0 = kind
    model = family_model(tmp, version, sr, use_f0)   # v2/48k: phase 3's
    det = dict(noise_scale=0.0, deterministic=True, version=version)
    kw = dict(f0method=f0method, protect=0.33,
              **dict(STREAM, samplerate=samplerate))
    audios = client_voices(n_slots, (n_blocks + 2) * 0.25, 50, samplerate)
    sched = SlotScheduler(stream_engine(model, tmp, "cuda", **det), n_slots,
                          clock=still_clock, **kw)
    bf = sched.block_frame
    slots = [sched.attach() for _ in range(n_slots)]
    got = [[] for _ in slots]
    for i in range(n_blocks):
        outs = lockstep_tick(sched, slots, audios, i)
        check_blocks(outs, bf, f"tick {i}")
        for s, out in enumerate(outs):
            got[s].append(out)
    got = [np.concatenate(g).astype(np.float64) for g in got]

    # each stream against a StreamSession of its own, fused path
    engine = stream_engine(model, tmp, "cuda", **det)
    worst, margins = 0.0, []
    for s in range(n_slots if n_own is None else n_own):
        sess = StreamSession(engine, fused=True, **kw)
        watch_sola(sess, margins)
        own = feed_blocks(sess, audios[s], 0, n_blocks).astype(np.float64)
        diff = float(np.abs(got[s] - own).max())
        worst = max(worst, diff)
        if not diff <= 1e-4:
            raise AssertionError(f"slot {s} of the {n_slots}-slot scheduler "
                                 f"differs from its own session by {diff} > "
                                 "1e-4 of full scale")
    # the first streams against a scheduler on the CPU
    rels = []
    if n_cpu:
        cpu = SlotScheduler(stream_engine(model, tmp, "cpu", **det), n_cpu,
                            clock=still_clock, **kw)
        cpu_slots = [cpu.attach() for _ in range(n_cpu)]
        cpu_got = [[] for _ in cpu_slots]
        for i in range(n_blocks):
            for s, out in enumerate(lockstep_tick(cpu, cpu_slots, audios,
                                                  i)):
                cpu_got[s].append(out)
        rels = [rel_l2(got[s], np.concatenate(cpu_got[s]).astype(np.float64),
                       f"scheduler slot {s}") for s in range(n_cpu)]
    say(phase, slots=n_slots, blocks=n_blocks, model=kind_name(*kind),
        samplerate=samplerate, f0method=f0method if use_f0 else None,
        own_sessions=n_slots if n_own is None else n_own,
        max_abs_vs_own_session=worst, limit=1e-4,
        sola_margin_min=float(min(margins)), cpu_slots=n_cpu,
        rel_l2_vs_cpu_scheduler=rels)
    if not fed_and_churn:
        return

    # `fed`: a tick that feeds slots 0 and 3 only
    before = {k: v.clone() for k, v in sched.state.items()}
    for slot in (0, 3):
        sched.submit(slot, audios[slot][n_blocks * bf: (n_blocks + 1) * bf])
    sched.tick()
    lens = [len(sched.collect(slot)) for slot in slots]
    if lens != [bf if s in (0, 3) else 0 for s in range(n_slots)]:
        raise AssertionError(f"partial tick delivered {lens}")
    for k, v in sched.state.items():
        for s in range(n_slots):
            kept = torch.equal(v[s], before[k][s])
            if s not in (0, 3) and not kept:
                raise AssertionError(f"partial tick: state {k}[{s}] of an "
                                     "unfed stream changed")
            if s in (0, 3) and k == "wav16" and kept:
                raise AssertionError(f"partial tick: state {k}[{s}] of a "
                                     "fed stream did not move")
    # churn: slot 2's client leaves, a new one takes the slot
    sched.detach(2)
    new = sched.attach()
    if new != 2:
        raise AssertionError(f"the freed slot is 2, attach gave {new}")
    newcomer = voice(0.25, seed=70, sr=samplerate)[:bf]
    sched.submit(new, newcomer)
    sched.tick()
    first = sched.collect(new)
    fresh = StreamSession(engine, fused=True, **kw).feed(newcomer)
    churn = float(np.abs(first.astype(np.float64) - fresh).max())
    if first.shape != (bf,) or not churn <= 1e-4:
        raise AssertionError(f"a new client's first block differs from a "
                             f"fresh session's by {churn}")
    if sched.stats()["underruns"] != [0] * n_slots:
        raise AssertionError(f"underruns {sched.stats()}")
    say("fed_and_churn", fed_slots=[0, 3],
        unfed_state_rows_bit_identical=True, reattached_slot=new,
        first_block_vs_fresh_session_max_abs=churn)


def noise_reduction(tmp, n_blocks=6):
    """Phase 14: the host path with both denoisers, card against CPU; and
    the denoiser alone on the card."""
    from tpu_rvc_torch.audio.torchgate import TorchGate
    from tpu_rvc_torch.pipeline.rt import StreamSession

    model = os.path.join(tmp, "v2_48k.pth")
    rng = np.random.default_rng(80)
    audio = voice(n_blocks * 0.25, seed=81, sr=48000)
    audio = audio + (0.01 * rng.standard_normal(audio.shape)).astype(
        np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        sess = StreamSession(
            stream_engine(model, tmp, dev, noise_scale=0.0,
                          deterministic=True),
            f0method="rmvpe", protect=0.33, input_noise_reduce=True,
            output_noise_reduce=True, **STREAM)
        if sess._fused is not None:
            raise AssertionError("noise reduction runs on the host path")
        outs[dev] = feed_blocks(sess, audio, 0, n_blocks).astype(np.float64)
    rel = rel_l2(outs["cuda"], outs["cpu"], "noise-reduced stream")
    t = np.arange(48000) / 48000
    x = (0.4 * np.sin(2 * np.pi * 220 * t) * (t > 0.3)
         + 0.02 * rng.standard_normal(48000)).astype(np.float32)
    head = slice(1920, 12000)            # noise only: the noise profile
    y = TorchGate(48000, n_fft=1920, prop_decrease=0.9)(x, x[:12000])
    rms = lambda a: float(np.sqrt(np.mean(a ** 2)))  # noqa: E731
    floor_in, floor_out = rms(x[head]), rms(y[head])
    tone_in, tone_out = rms(x[24000:]), rms(y[24000:])
    if y.shape != x.shape or not np.isfinite(y).all() or \
            not floor_out < 0.25 * floor_in or not tone_out > 0.5 * tone_in:
        raise AssertionError(f"TorchGate: noise floor {floor_in} -> "
                             f"{floor_out}, tone rms {tone_in} -> {tone_out}")
    say("noise_reduction", blocks=n_blocks, f0method="rmvpe",
        rel_l2_err=rel, max_abs_err=float(np.abs(outs["cuda"]
                                                 - outs["cpu"]).max()),
        torchgate_noise_floor_rms=[floor_in, floor_out],
        torchgate_tone_rms=[tone_in, tone_out])


def tcp_loopback(tmp, n_clients=2):
    """Phase 15.  The scheduler's clock stands still: the clients stream
    faster than realtime and then wait for their audio, and the pauses of
    two threads and a socket must not count as underruns."""
    from tpu_rvc_torch.apps.serve import VCServer, stream_file
    from tpu_rvc_torch.audio.io import load_wav
    from tpu_rvc_torch.pipeline.serve import SlotScheduler

    model = os.path.join(tmp, "v2_48k.pth")
    sched = SlotScheduler(stream_engine(model, tmp, "cuda", random_index()),
                          n_clients, f0method="rmvpe", clock=still_clock,
                          **STREAM)
    srv = VCServer(("127.0.0.1", 0), sched)
    port = srv.server_address[1]
    serve_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    serve_thread.start()
    results = {}

    def client(i):
        try:
            wav_in = os.path.join(tmp, f"client{i}_in.wav")
            wav_out = os.path.join(tmp, f"client{i}_out.wav")
            write_voice(wav_in, 1.0, seed=90 + i)
            stats = stream_file("127.0.0.1", port, wav_in, wav_out,
                                timeout=120.0)
            results[i] = (stats, load_wav(wav_out))
        except Exception as e:  # handed to the main thread, which raises
            results[i] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    finally:
        srv.shutdown()
        srv.server_close()
        serve_thread.join(timeout=30)
    wall = time.perf_counter() - t0
    if serve_thread.is_alive() or any(t.is_alive() for t in threads):
        raise AssertionError("a server or client thread did not end")
    n_blocks = sched.sr // sched.block_frame   # the wavs are 1 s long
    deadline = time.perf_counter() + 10   # the handlers detach on "bye"
    while sched.stats()["active"] and time.perf_counter() < deadline:
        time.sleep(0.01)
    for i in range(n_clients):
        if isinstance(results.get(i), Exception) or i not in results:
            raise AssertionError(f"client {i}: {results.get(i)!r}")
        stats, (y, sr) = results[i]
        if sr != sched.sr or y.shape != (n_blocks * sched.block_frame,) or \
                not np.isfinite(y).all() or np.abs(y).max() == 0:
            raise AssertionError(f"client {i}: {sr} Hz, {y.shape}")
        if stats["underruns"] != [0] * n_clients:
            raise AssertionError(f"client {i}: stats {stats}")
    final = sched.stats()
    if final["blocks"] != [n_blocks] * n_clients or \
            final["underruns"] != [0] * n_clients or final["active"] != 0:
        raise AssertionError(f"server stats at the end: {final}")
    say("tcp_loopback", clients=n_clients, host="127.0.0.1",
        samples_per_client=n_blocks * sched.block_frame,
        blocks=final["blocks"], underruns=final["underruns"],
        ticks=final["ticks"], wall_s=wall, clock="stands still")


# ---------------------------------------------------------------------------
# phases T1-T4: GAN training at full width
# ---------------------------------------------------------------------------

TRAIN_FILES, TRAIN_SECONDS = 16, 4.0


def no_launches(what):
    from tpu_rvc_torch.ops.kernels import launch_counts

    if any(launch_counts.values()):
        raise AssertionError(f"{what} launched kernels {dict(launch_counts)}"
                             "; training runs no kernel")


def train_prepare(tmp):
    """T1: 16 synthetic 4 s voices at 48 kHz -> preprocess -> extract (RMVPE
    from `write_rmvpe`, HuBERT-base from a seed, on the card) -> index ->
    filelist, through `apps/train.py`'s `main`."""
    from tpu_rvc_torch.apps.train import main as train_main
    from tpu_rvc_torch.audio.io import save_wav
    from tpu_rvc_torch.train.data import write_filelist

    raw, exp = os.path.join(tmp, "train_raw"), os.path.join(tmp, "train_exp")
    os.makedirs(raw)
    for i in range(TRAIN_FILES):
        save_wav(os.path.join(raw, f"v{i:02d}.wav"),
                 voice(TRAIN_SECONDS, 100 + i, sr=48000), 48000)
    secs = {}
    for cmd, args in (
            ("preprocess", ["--input-dir", raw, "--sr", "48000",
                            "--workers", "4"]),
            ("extract", ["--version", "v2", "--f0-method", "rmvpe",
                         "--rmvpe-root", tmp, "--hubert", "random"]),
            ("index", ["--version", "v2", "--name", "smoke"])):
        t0 = time.perf_counter()
        train_main([cmd, "--exp-dir", exp] + args)
        secs[cmd] = time.perf_counter() - t0
    counts = {d: len(os.listdir(os.path.join(exp, d))) for d in (
        "0_gt_wavs", "1_16k_wavs", "2a_f0", "2b-f0nsf", "3_feature768")}
    if set(counts.values()) != {TRAIN_FILES}:
        raise AssertionError(f"prepared files {counts}")
    feat_dir = os.path.join(exp, "3_feature768")
    feats = np.load(os.path.join(feat_dir, sorted(os.listdir(feat_dir))[0]))
    if feats.shape[1] != 768 or not np.isfinite(feats).all():
        raise AssertionError(f"features {feats.shape}")
    rows = open(write_filelist(exp, "v2", True, 0, "48k")).read().split()
    if len(rows) != TRAIN_FILES + 2:
        raise AssertionError(f"{len(rows)} filelist rows")
    say("train_prepare", files=TRAIN_FILES, seconds_each=TRAIN_SECONDS,
        prepared=counts, feature_frames=int(feats.shape[0]),
        filelist_rows=len(rows), seconds=secs,
        index=os.path.exists(os.path.join(exp, "added_smoke.tpuidx.npz")))
    return exp


def grads_reach_every_layer(state, batch):
    """On the card: a training forward under the step's precision gives
    enc_p's attention and every resblock a nonzero gradient."""
    from tpu_rvc_torch.train.step import batch_to_device

    net, b = state.net_g, batch_to_device(batch, "cuda")
    with state._autocast():
        o, *_, (_, _, m_p, _, _, _) = net(
            b["phone"], b["phone_lengths"], b["spec"], b["spec_lengths"],
            b["sid"], b["pitch"], b["pitchf"])
    params = [p for layer in net.enc_p.encoder.attn_layers
              for p in (layer.conv_q.weight, layer.emb_rel_k)]
    params += [c.weight_v for rb in net.dec.resblocks
               for c in list(rb.convs1) + list(rb.convs2)]
    loss = o.float().square().mean() + m_p.float().square().mean()
    grads = torch.autograd.grad(loss, params)
    zero = sum(int(float(g.abs().max()) == 0) for g in grads)
    if zero:
        raise AssertionError(f"{zero} of {len(grads)} attention/resblock "
                             "tensors got no gradient")
    return len(grads)


def infer_args(T=200, seed=12, dim=768, use_f0=True):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    args = (torch.from_numpy(rng.standard_normal((1, T, dim)).astype(
        np.float32)).to(dev), torch.tensor([T], device=dev),
        torch.tensor([0], device=dev))
    if not use_f0:
        return args
    return args + (torch.from_numpy(rng.integers(1, 255, (1, T))).to(dev),
                   torch.from_numpy(rng.uniform(100, 300, (1, T)).astype(
                       np.float32)).to(dev))


def endless(batcher):
    e = 0
    while True:
        yield from batcher.epoch(e)
        e += 1


def trained_state(exp, hp, use_f0, epochs, what):
    """The state of the last of `epochs` epochs that training wrote to
    `exp`, from its latest checkpoint -> (state, its batcher, rows, steps
    an epoch)."""
    from tpu_rvc_torch.train.data import BucketBatcher, RVCDataset
    from tpu_rvc_torch.train.loop import (latest_checkpoint,
                                          load_native_checkpoint)
    from tpu_rvc_torch.train.step import create_train_state

    t = hp.train
    ds = RVCDataset(os.path.join(exp, "filelist.txt"), hp, if_f0=use_f0)
    batcher = BucketBatcher(ds, t.batch_size, seed=t.seed)
    spe = max(len(ds) // t.batch_size, 1)
    state = create_train_state(hp, steps_per_epoch=spe, use_f0=use_f0)
    epoch = load_native_checkpoint(latest_checkpoint(exp), state)
    if epoch != epochs:
        raise AssertionError(f"{what}: latest checkpoint of epoch {epoch}")
    return state, batcher, len(ds), spe


def g_against_pth(hp, use_f0, live, args, path, what):
    """`live` (the live G's deterministic infer of `args`) against the
    G_*.pth at `path`, reloaded into a fresh synthesizer -> max abs."""
    from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
    from tpu_rvc_torch.models.synthesizer import make_synthesizer

    fresh = make_synthesizer(hp, use_f0=use_f0, device="cuda", seed=1)
    fresh.load_state_dict(synthesizer_state_from_reference(torch.load(
        path, map_location="cpu", weights_only=True)["model"]))
    err = float((live - fresh.infer(*args, deterministic=True)).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"{what}: live G against "
                             f"{os.path.basename(path)}: {err}")
    return err


def timed_steps(state, it, n_warm, n_timed, what):
    """n_warm + n_timed steps on the batches of `it`, each timed to a
    synchronize with its spans, the allocator's cache emptied before the
    timed ones; finite losses, no kernel launched -> figures."""
    from tpu_rvc_torch.ops.kernels import reset_launch_counts
    from tpu_rvc_torch.utils import timing

    reset_launch_counts()
    walls, host_ms, spans = [], [], []
    for i in range(n_warm + n_timed):
        t0 = time.perf_counter()
        batch = next(it)
        t1 = time.perf_counter()
        if i == n_warm:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        timing.enable()
        m = state.train_step(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        spans.append(timing.read())
        timing.disable()
        if i >= n_warm:
            host_ms.append((t1 - t0) * 1e3)
            walls.append((t2 - t1) * 1e3)
    no_launches(f"{what}: the timed steps")
    losses = {k: float(v) for k, v in m.items() if v.dim() == 0}
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{what}: losses not finite: {losses}")
    return dict(
        step_ms=walls, step_ms_median=float(np.median(walls)),
        step_ms_p90=float(np.percentile(walls, 90)),
        step_ms_max=float(np.max(walls)), steps_timed=n_timed,
        warmup_steps=n_warm,
        span_ms={k: float(np.median([s[k] for s in spans[n_warm:]]))
                 for k in spans[-1]},
        host_batch_ms_median=float(np.median(host_ms)),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        step_peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
        final_losses=losses)


def deterministic_replay(state, batch):
    """The step under `TrainState.deterministic` at the state's precision,
    twice from one state on one batch: the first searches cuDNN's
    algorithms for the shape, the second takes them; both give the same
    losses and parameters bit for bit, finite -> figures."""
    import copy
    from tpu_rvc_torch.tools.dist_steps import full_params

    saved = copy.deepcopy({"g": state.net_g.state_dict(),
                           "d": state.net_d.state_dict(),
                           "opt_g": state.opt_g.state_dict(),
                           "opt_d": state.opt_d.state_dict()})
    step = state.step
    state.deterministic = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for k in range(2):
        if k:
            state.net_g.load_state_dict(saved["g"])
            state.net_d.load_state_dict(saved["d"])
            state.opt_g.load_state_dict(saved["opt_g"])
            state.opt_d.load_state_dict(saved["opt_d"])
            state.step = step
        t0 = time.perf_counter()
        m = state.train_step(batch)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0,
                     {k: float(v) for k, v in m.items() if v.dim() == 0},
                     full_params(state)))
        if not k:
            reserved_gb = torch.cuda.memory_reserved() / 1e9
    state.deterministic = False
    (first_s, losses, params), (second_s, losses2, params2) = runs
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"deterministic step: losses {losses}")
    differ = [k for k in params if not torch.equal(params[k], params2[k])]
    if losses2 != losses or differ:
        raise AssertionError(f"deterministic step replayed: losses {losses} "
                             f"then {losses2}; {len(differ)} tensors differ")
    return dict(first_step_s=first_s, second_step_ms=second_s * 1e3,
                peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
                reserved_after_first_gb=reserved_gb,
                replay_bit_equal=True, batch_shape=list(batch["spec"].shape))


def train_full_width(tmp, exp, epochs=2, n_warm=3, n_timed=8, n_profiled=3):
    """T2: v2/48k at full width, batch 4, segment 17280, bf16 as the preset
    says: epochs - 1 epochs through `run_training` (a checkpoint each),
    then a resumed run to the last; then steps timed one by one on the
    state of the last epoch, one step under the deterministic option
    replayed bit for bit, and the live G against the G_*.pth it
    writes."""
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.train.loop import export_reference_g_pth, run_training

    hp = hparams_for("v2", 48000)
    t = hp.train
    if (t.batch_size, t.segment_size, t.fp16_run) != (4, 17280, True):
        raise AssertionError(f"v2/48k preset changed: {t}")
    logs = []

    def log(line):
        logs.append(line)
        print(line, flush=True)

    reset_launch_counts()
    t0 = time.perf_counter()
    run_training(exp, hp, total_epochs=epochs - 1, save_every_epoch=1,
                 name="trained", log_fn=log, tensorboard=False)
    straight_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = run_training(exp, hp, total_epochs=epochs, save_every_epoch=1,
                           name="trained", log_fn=log, tensorboard=False)
    resume_s = time.perf_counter() - t0
    run_counts = dict(launch_counts)
    no_launches("run_training")
    if not any("resumed from" in ln and f"state_{epochs - 1}.pt" in ln
               for ln in logs):
        raise AssertionError(f"epoch {epochs} did not resume from "
                             f"state_{epochs - 1}.pt")
    for f in ["trained.pth"] + [f"{k}_{e}.{x}" for e in range(1, epochs + 1)
                                for k, x in (("state", "pt"), ("G", "pth"))]:
        if not os.path.exists(os.path.join(exp, f)):
            raise AssertionError(f"{f} was not written")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"losses not finite: {metrics}")

    state, batcher, _, spe = trained_state(exp, hp, True, epochs, "T2")
    n_grads = grads_reach_every_layer(state, next(batcher.epoch(0)))
    args = infer_args()
    state.net_g.infer(*args, deterministic=True)  # fills the stage cache
    it = endless(batcher)
    steps = timed_steps(state, it, n_warm, n_timed, "T2")
    wall = steps["step_ms_median"]
    three = [next(it) for _ in range(n_profiled)]
    busy, top = device_busy_ms(lambda: [state.train_step(b) for b in three])
    step = state.step   # R1: one step counted on a copy of the state
    count_path("train_step_v2_48k_bf16",
               functools.partial(state.step_flops, three[-1]), wall,
               torch.bfloat16, dict.fromkeys(launch_counts, 0),
               kernel_flops())
    if state.step != step:
        raise AssertionError("R1: counting a step advanced the state")
    replay = deterministic_replay(state, three[-1])
    train_counts = {k: run_counts[k] + v for k, v in launch_counts.items()}
    no_launches("the timed training steps")

    # the live G, its cache filled before the optimizer moved its weights
    # in place, against the G_*.pth it writes, reloaded
    reset_launch_counts()
    live = state.net_g.infer(*args, deterministic=True)
    live_launches = dict(launch_counts)
    path = os.path.join(tmp, "G_live.pth")
    export_reference_g_pth(path, state.net_g, 5, state.lr())
    err = g_against_pth(hp, True, live, args, path, "T2")
    say("train", model="v2/48k random init", batch=t.batch_size,
        segment=t.segment_size, precision="bf16 autocast, fp32 params",
        epochs=epochs, steps_per_epoch=spe,
        run_training_straight_s=straight_s, resume_last_epoch_s=resume_s,
        final_metrics=metrics, **steps,
        samples_per_s=t.batch_size * t.segment_size / (wall / 1e3),
        device_busy_ms_per_step=(busy / n_profiled if busy else None),
        device_busy_share=(busy / n_profiled / wall if busy else None),
        device_ops_per_step=sum(c for _, _, c in top) / n_profiled,
        top_kernels_ms_per_step=[[name[:60], ms / n_profiled,
                                  calls / n_profiled]
                                 for name, ms, calls in top[:10]],
        deterministic_step=replay,
        kernel_launches_in_training=train_counts,
        grads_nonzero=n_grads, live_vs_reloaded_max_abs=err,
        live_infer_launches=live_launches)
    return os.path.join(exp, "trained.pth"), train_counts


def train_against_cpu(exp, version="v2", sr=48000,
                      phase="train_against_cpu"):
    """T3 (and T6's at v1/32k): one pinned fp32 step (TF32 off) at full
    width, batch 2 in a 200-frame bucket, on the card and on the CPU from
    the same weights."""
    import dataclasses
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.train.data import BucketBatcher, RVCDataset
    from tpu_rvc_torch.train.step import create_train_state

    hp = hparams_for(version, sr)
    hp = dataclasses.replace(hp, train=dataclasses.replace(
        hp.train, fp16_run=False))
    ds = RVCDataset(os.path.join(exp, "filelist.txt"), hp)
    batch = BucketBatcher(ds, 2)._collate([ds.load(0), ds.load(1)], 200)
    rng = np.random.default_rng(13)
    batch["pin_ids_slice"] = np.array([10, 150], np.int32)
    batch["pin_noise_eps"] = rng.standard_normal(
        (2, 200, hp.model.inter_channels)).astype(np.float32)
    got = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(hp, seed=7, device=dev)
        t0 = time.perf_counter()
        m = state.train_step(batch)
        got[dev] = {k: float(v) for k, v in m.items() if v.dim() == 0}
        got[dev + "_s"] = time.perf_counter() - t0
    rel = {k: abs(got["cuda"][k] - v) / max(abs(v), 1e-12)
           for k, v in got["cpu"].items()}
    bad = {k: r for k, r in rel.items()
           if r > (1e-2 if k.startswith("grad_norm") else 1e-3)}
    if bad:
        raise AssertionError(f"card against CPU step: {bad}; card "
                             f"{got['cuda']}, cpu {got['cpu']}")
    say(phase, model=f"{version}/{sr // 1000}k", precision="fp32, TF32 off",
        batch=2,
        bucket=200, rel_err=rel, card=got["cuda"],
        card_step_s=got["cuda_s"], cpu_step_s=got["cpu_s"])


def rel_err(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def dp_steps_check(got, want, what, limit):
    """Every loss term and both grad norms of `got` within `limit` (a
    number, or one a term) relative of `want`'s."""
    worst = {k: rel_err(got[k], w) for k, w in want.items()}
    bad = {k: e for k, e in worst.items()
           if e > (limit[k] if isinstance(limit, dict) else limit)}
    if bad:
        raise AssertionError(f"{what}: {bad}; got {got}, want {want}")
    return max(worst.values())


def deterministic_step_cost(state, batch, n_warm=3, n_turn=4, turns=3):
    """The step under `TrainState.deterministic` against the default
    setting, on one state: n_warm steps each, then turns of n_turn steps
    (deterministic, default, default, deterministic, ...) -> medians,
    their ratio, and each setting's peak reserved memory over its
    warm-up, the cache emptied before."""
    from tpu_rvc_torch.tools.dist_steps import run_steps

    ms = {True: [], False: []}
    reserved = {}
    for det in (True, False):
        state.deterministic = det
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run_steps(state, [batch] * n_warm)
        reserved[det] = torch.cuda.max_memory_reserved() / 1e9
    for i in range(2 * turns):
        det = i % 4 in (0, 3)
        state.deterministic = det
        ms[det] += run_steps(state, [batch] * n_turn)[1]
    state.deterministic = True
    med = {k: float(np.median(v)) for k, v in ms.items()}
    return {"ms_deterministic": ms[True], "ms_default": ms[False],
            "median_ms_deterministic": med[True],
            "median_ms_default": med[False],
            "ratio": med[True] / med[False],
            "warm_reserved_gb_deterministic": reserved[True],
            "warm_reserved_gb_default": reserved[False]}


def data_parallel_training(tmp, exp):
    """T5: data-parallel and sharded training at full width (v2/48k), in
    child processes (this one joins no group): (a) the train CLI in an
    NCCL group of one, then steps timed with and without the group; (b)
    two ranks on the one card over gloo, replicated, against this
    process's one-process step; (c) the same on a (1, 2) FSDP mesh."""
    import dataclasses
    import shutil
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.tools.dist_steps import (Ranks, wait_for, free_port,
                                                full_params, make_batch,
                                                param_gap, run_steps)
    from tpu_rvc_torch.train.step import create_train_state

    t_start = time.perf_counter()
    hp = hparams_for("v2", 48000)
    cli_exp = os.path.join(tmp, "dp_exp")
    for d in ("0_gt_wavs", "1_16k_wavs", "2a_f0", "2b-f0nsf",
              "3_feature768"):
        shutil.copytree(os.path.join(exp, d), os.path.join(cli_exp, d))
    argv = ["train", "--exp-dir", cli_exp, "--epochs", "1", "--batch-size",
            "4", "--save-every", "1", "--name", "dp1", "--coordinator",
            f"127.0.0.1:{free_port()}", "--num-processes", "1",
            "--process-id", "0"]
    # (b) and (c): fp32, pinned then unpinned, 4 rows of unequal lengths
    hp32 = dataclasses.replace(hp, train=dataclasses.replace(
        hp.train, fp16_run=False))
    lr = hp32.train.learning_rate
    lengths = (200, 163, 200, 110)
    batches = ([make_batch(hp32, lengths, 21, 200, pins=(10, 120, 150, 60))]
               * 3 + [make_batch(hp32, lengths, 22, 200)] * 2)
    ref_path = os.path.join(tmp, "dp_reference.pt")
    # every child starts now and waits at its gate for the timed part, so
    # their start-up overlaps the CLI's epoch and the reference runs here
    gates = [os.path.join(tmp, f"dp_go_{x}") for x in "ab"]
    a_ranks = Ranks({"case": "cli_timing", "hp": hp, "device": "cuda",
                     "argv": argv, "exp": cli_exp, "n_warm": 3,
                     "n_timed": 6, "threads": 4, "gate": gates[0],
                     "out": os.path.join(tmp, "dp_a")}, 1)
    bc_ranks = Ranks({"case": "steps", "hp": hp32, "seed": 7,
                      "device": "cuda", "backend": "gloo", "timeout_s": 120,
                      "threads": 4, "layouts": ["replicated", (1, 2)],
                      "batches": batches, "snapshots": [1, 3, 5],
                      "keep": [1, 5], "reference": ref_path,
                      "gate": gates[1], "out": os.path.join(tmp, "dp_bc")},
                     2)
    try:
        reset_launch_counts()
        # the CLI's epoch first: the one-process runs take the
        # deterministic step, whose cuDNN search keeps its workspaces
        # (`search_reserved_gb`), and two processes searching at once on
        # one NVIDIA H100 80GB HBM3 (700 W) ran one out of memory, 79 GB
        # in use
        wait_for(os.path.join(cli_exp, "dp1.pth"), 300)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(2):   # two one-process runs: the step's own spread
            state = create_train_state(hp32, seed=7)
            state.deterministic = True
            n_params = sum(p.numel() for net in (state.net_g, state.net_d)
                           for p in net.parameters())
            runs.append(run_steps(state, batches, (1, 5), full_params))
        search_reserved_gb = torch.cuda.max_memory_reserved() / 1e9
        one, _, one_params = runs[0]
        spread = {n: param_gap(runs[1][2][n], one_params[n])
                  for n in (1, 5)}
        # tests/test_torch_train.py's criterion, after one and five steps
        if not all(spread[n]["beyond_1e6"] < 1e-3 for n in (1, 5)):
            raise AssertionError(f"two one-process runs differ: {spread}")
        det_ms = deterministic_step_cost(state, batches[-1], turns=2)
        del state
        torch.cuda.empty_cache()
        # the unpinned steps: 1e-3 beyond twice what a second run moves
        unpinned_limit = {i: {k: 1e-3 + 2 * rel_err(runs[1][0][i][k], v)
                              for k, v in one[i].items()} for i in (3, 4)}
        one_launches = dict(launch_counts)
        torch.save(one_params, ref_path)
        del runs, one_params
        open(gates[0], "w").close()
        a = a_ranks.wait(300)[0]
        a_s = time.perf_counter() - t_start
        open(gates[1], "w").close()
        t0 = time.perf_counter()
        res = bc_ranks.wait(400)
        bc_s = time.perf_counter() - t0
    finally:
        a_ranks.stop()
        bc_ranks.stop()
    for f in ("state_1.pt", "G_1.pth", "dp1.pth"):
        if not os.path.exists(os.path.join(cli_exp, f)):
            raise AssertionError(f"the CLI in a group wrote no {f}")
    if not a["finite"]:
        raise AssertionError("steps in a group of one: losses not finite")
    group_ms = float(np.median(a["ms"]["group"]))
    none_ms = float(np.median(a["ms"]["none"]))
    out = {}
    for li, name in enumerate(("replicated", "fsdp_1x2")):
        worst = {"pinned": 0.0, "unpinned": 0.0}
        for r, rank in enumerate(res):
            lay = rank["layouts"][li]
            for i, kind, limit in ((0, "pinned", 1e-4), (1, "pinned", 1e-4),
                                   (3, "unpinned", unpinned_limit[3]),
                                   (4, "unpinned", unpinned_limit[4])):
                worst[kind] = max(worst[kind], dp_steps_check(
                    lay["metrics"][i], one[i],
                    f"{name} rank {r} step {i + 1}", limit))
            for n in (1, 3, 5):
                if not lay["snapshots"][n]["same_as_rank0"]:
                    raise AssertionError(f"{name}: rank {r}'s parameters "
                                         f"differ from rank 0's after {n}")
            if name == "fsdp_1x2" and not min(lay["sharded_frac"]) >= 0.5:
                raise AssertionError(f"sharded {lay['sharded_frac']}")
        gap = {n: res[0]["layouts"][li]["snapshots"][n]["gap"]
               for n in (1, 5)}
        # after one step tests/test_torch_train.py's criterion; after five
        # only its 2 lr a step: the ranks sum their rows' gradients in
        # another order than one process does, and the GAN and Adam's
        # normalised steps amplify that rounding (two one-process runs,
        # which sum in one order, are held to the criterion above)
        if not (gap[1]["max_abs"] <= 2 * lr * 1.01
                and gap[1]["beyond_1e6"] < 1e-3
                and gap[5]["max_abs"] <= 10 * lr * 1.01):
            raise AssertionError(f"{name}: parameters against one process "
                                 f"{gap}, two one-process runs {spread}")
        lay0 = res[0]["layouts"][li]
        out[name] = dict(
            max_rel_err_pinned_steps_1_2=worst["pinned"],
            max_rel_err_unpinned_steps_4_5=worst["unpinned"],
            params_gap_after_1=gap[1], params_gap_after_5=gap[5],
            bit_identical_ranks_after_1_3_5=True,
            ms_per_global_step_median=[float(np.median(r["layouts"][li]
                                                       ["ms"][1:]))
                                       for r in res],
            ms_first_step=[r["layouts"][li]["ms"][0] for r in res],
            peak_mem_gb_per_rank=[r["layouts"][li]["peak_gb"]
                                  for r in res],
            sharded_frac=lay0["sharded_frac"] or None)
    counts = {k: one_launches[k] + a["launches"][k]
              + sum(r["launches"][k] for r in res) for k in one_launches}
    if any(counts.values()):
        raise AssertionError(f"data-parallel training launched {counts}")
    say("train_data_parallel", model="v2/48k random init",
        params=n_params, allreduce_mb=n_params * 4 / 1e6,
        cli=dict(argv=" ".join(argv[:1] + argv[3:]), seconds=a["cli_s"],
                 group="NCCL, 1 process", precision="bf16 autocast"),
        step_ms_group_of_one=group_ms, step_ms_no_group=none_ms,
        allreduce_cost_ms=group_ms - none_ms,
        step_ms_group_all=a["ms"]["group"], step_ms_none_all=a["ms"]["none"],
        peak_mem_gb_group_and_none=a["peak_gb"], a_done_s=a_s,
        two_ranks_one_card=dict(backend="gloo, CUDA tensors",
                                precision="fp32, TF32 off", rows_a_rank=2,
                                lengths=list(lengths), **out["replicated"]),
        fsdp_one_card=dict(mesh="(1, 2)", backend="gloo, CUDA tensors",
                           **out["fsdp_1x2"]),
        one_process_spread=spread,
        deterministic_step=dict(det_ms,
                                search_reserved_gb=search_reserved_gb),
        one_process_spread_unpinned_rel={
            i + 1: (max(v.values()) - 1e-3) / 2
            for i, v in unpinned_limit.items()},
        bc_steps_seconds=bc_s,
        kernel_launches=counts, seconds=time.perf_counter() - t_start)
    return counts


def trained_model_converts(tmp, model):
    """T4: the small model T2 wrote through VC.get_vc -> a 10 s vc_single
    on the card (6 K1, 72 K2), and the same conversion, deterministic, on
    the card against the CPU."""
    from tpu_rvc_torch.audio.io import load_audio
    from tpu_rvc_torch.models.hubert import hubert_for_version
    from tpu_rvc_torch.models.loader import load_synthesizer
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.vc import VC, Pipeline

    wav = os.path.join(tmp, "voice_10s.wav")
    vc = VC(rmvpe_root=tmp, hubert_path="random")
    vc.get_vc(model)
    vc.vc_single(0, wav, f0_method="rmvpe")                  # warm-up
    reset_launch_counts()
    t0 = time.perf_counter()
    info, (sr, audio) = vc.vc_single(0, wav, f0_method="rmvpe")
    wall = (time.perf_counter() - t0) * 1e3
    counts = dict(launch_counts)
    check_output(audio, expected_len(160000, vc.x_pad, 480, 48000),
                 "trained model's conversion")
    want = v2_48k_launches()
    if counts != want:
        raise AssertionError(f"trained model launches {counts}, want {want}")
    x = load_audio(wav, 16000)
    outs = []
    for dev in ("cuda", "cpu"):
        synth, _ = load_synthesizer(model, dev)
        pipe = Pipeline(48000, hubert=hubert_for_version("v2", dev),
                        synth=synth, x_pad=0.5, rmvpe_root=tmp,
                        noise_scale=0.0, deterministic=True, device=dev)
        outs.append(pipe.pipeline(0, x, [0.0, 0.0, 0.0], 0, "rmvpe", None,
                                  0.0, 1, 3, 0, 0.25, 0.33).astype(np.float64))
    rel = rel_l2(outs[0], outs[1], "trained model, card against CPU")
    say("trained_model_converts", model="the small model of 4 epochs",
        input_s=10.0, f0_method="rmvpe", wall_ms=wall, launches=counts,
        card_vs_cpu_rel_l2=rel, samples=int(outs[0].shape[0]))
    return counts


# ---------------------------------------------------------------------------
# phases F1-F4: the f0 estimators beyond pm and RMVPE
# ---------------------------------------------------------------------------


def write_fcpe(tmp, seed):
    """A random-weight torchfcpe bundled checkpoint at the bundled model's
    width (hidden 512, 6 layers, kernel 31, 360 bins), output projection
    weight-normed, at `assets/fcpe/fcpe.pt` under tmp: the estimator's
    default lookup finds it with tmp as the working directory."""
    from tpu_rvc_torch.ckpt.fcpe_loader import random_fcpe_reference_state

    os.makedirs(os.path.join(tmp, "assets", "fcpe"), exist_ok=True)
    torch.save(random_fcpe_reference_state(seed),
               os.path.join(tmp, "assets", "fcpe", "fcpe.pt"))


def f0_phase_seconds(name, t0):
    say("f0_phase_seconds", f0_phase=name, seconds=time.perf_counter() - t0)


def fcpe_phases(tmp, main_counts):
    """F1-F3, from tmp as the working directory.  Returns the launches of
    one offline conversion, one streaming block and one 8-slot tick."""
    write_fcpe(tmp, seed=10)
    t0 = time.perf_counter()
    offline = end_to_end(tmp, "fcpe", "fcpe_offline")
    if offline != main_counts:
        raise AssertionError(f"launches with fcpe {offline}, with pm "
                             f"{main_counts}")
    against_cpu(tmp, ("fcpe",), "fcpe_against_cpu")
    f0_phase_seconds("F1", t0)
    t0 = time.perf_counter()
    stream = streaming(tmp, f0method="fcpe", paths=(True,),
                       phase="fcpe_streaming")
    streaming_against_cpu(tmp, methods=("fcpe",),
                          phase="fcpe_streaming_against_cpu")
    f0_phase_seconds("F2", t0)
    t0 = time.perf_counter()
    tick = serving(tmp, BATCH_N, n_warm=3, n_timed=10, f0method="fcpe",
                   modes=(False,), phase="fcpe_serving")
    streams_against_sessions(tmp, BATCH_N, n_cpu=0, f0method="fcpe", n_own=2,
                             fed_and_churn=False,
                             phase="fcpe_streams_against_sessions")
    f0_phase_seconds("F3", t0)
    return offline, stream, tick


def f0_network_profiles(tmp, crepe_path):
    """F4's detail: the FCPE track alone (`fcpe_f0_device`) at the offline
    (one 16 s bucket), streaming (one 4800-sample tail) and 8-stream tail
    shapes, and CREPE's salience for the 10 s input's 1601 frames: median
    ms of CUDA events, the device's busy ms and kernel launches from
    torch.profiler, the top kernels, and the work counted from the
    shapes (fp32 operations)."""
    from tpu_rvc_torch.f0.crepe import CRePE
    from tpu_rvc_torch.f0.device import fcpe_f0_device
    from tpu_rvc_torch.f0.fcpe import FCPE
    from tpu_rvc_torch.models.crepe import FILTERS, WIDTHS, crepe_salience
    from tpu_rvc_torch.core.device import fp32_math

    fcpe = FCPE(model_path=os.path.join(tmp, "assets", "fcpe", "fcpe.pt")
                ).model
    hid = fcpe.norm.normalized_shape[0]
    n_in = fcpe.input_stem[0].in_channels
    k = fcpe.net.encoder_layers[0].conformer.net[4].conv.kernel_size[0]
    per_frame = 2 * (3 * n_in * hid + 3 * hid * hid + hid * fcpe.out_dims
                     + len(fcpe.net.encoder_layers)
                     * (hid * 4 * hid + k * 2 * hid + 2 * hid * hid))
    rows = []
    with torch.no_grad(), fp32_math():
        for name, n, T in (("offline", 1, 256000), ("stream", 1, 4800),
                           ("tick", BATCH_N, 4800)):
            wav = torch.randn(n, T, device="cuda") * 0.1
            run = lambda: fcpe_f0_device(wav, T // 160, 0.0, fcpe)  # noqa
            ms = median_ms(run, iters=10, warmup=2)
            busy, top = device_busy_ms(run)
            rows.append(dict(
                shape=[n, T], ms=ms, device_busy_ms=busy,
                kernels=int(sum(c for _, _, c in top)),
                gflop=per_frame * n * (T // 160 + 1) / 1e9,
                top=[[nm[:50], t, c] for nm, t, c in top[:4]]))
        say("fcpe_track_profile", model="hidden 512, 6 layers, kernel 31",
            gflop_per_frame=per_frame / 1e9, rows=dict(zip(
                ("offline", "stream", "tick"), rows)))
        crepe = CRePE(model_path=crepe_path).model
        wav = torch.randn(256000, device="cuda") * 0.1
        run = lambda: crepe_salience(crepe, wav)  # noqa: E731
        ms = median_ms(run, iters=3, warmup=1)
        busy, top = device_busy_ms(run)
    n_frames = 256000 // 160 + 1
    flop, L, c_in = 2 * FILTERS[-1] * 4 * 360, 1024, 1
    for i, (f, w) in enumerate(zip(FILTERS, WIDTHS)):
        L_out = L // 4 if i == 0 else L
        flop += 2 * w * c_in * f * L_out
        L, c_in = L_out // 2, f
    say("crepe_salience_profile", frames=n_frames, ms=ms,
        device_busy_ms=busy, gflop_per_frame=flop / 1e9,
        tflop_per_s=flop * n_frames / (busy * 1e-3) / 1e12 if busy else None,
        top=[[nm[:50], t, c] for nm, t, c in top[:6]])


def host_f0_conversions(tmp):
    """F4: the 10 s voice through VC.vc_single with crepe (random CREPE
    full weights in torchcrepe's layout, given to the pipeline's
    generator), dio, harvest (filter_radius 3) and pm with a manual
    curve, and through the pipeline with the pm track of the same input
    precomputed (if_f0 = 2, as the model hash feeds it): one warm-up and
    one timed run each, f0 ms (`times[1]`), wall ms, 6 K1 and 72 K2
    launches; crepe and harvest on 1 s, card against CPU; the FCPE track
    and the CREPE salience profiled alone; the serving scheduler refuses
    harvest."""
    from tpu_rvc_torch.audio.dsp import highpass_filter
    from tpu_rvc_torch.audio.io import load_audio
    from tpu_rvc_torch.ckpt.crepe_loader import random_crepe_reference_state
    from tpu_rvc_torch.f0.crepe import CRePE
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.serve import SlotScheduler
    from tpu_rvc_torch.pipeline.vc import VC

    t0 = time.perf_counter()
    crepe_path = os.path.join(tmp, "crepe_full.pth")
    torch.save(random_crepe_reference_state(11), crepe_path)
    wav = os.path.join(tmp, "voice_10s.wav")
    vc = VC(rmvpe_root=tmp, hubert_path="random")
    vc.get_vc(os.path.join(tmp, "v2_48k.pth"))
    pipe = vc.pipeline
    pipe.f0_gen._estimators["crepe"] = CRePE(model_path=crepe_path)
    n_expected = expected_len(160000, vc.x_pad, 480, 48000)
    want = v2_48k_launches()
    seen_times = []
    inner = pipe.pipeline

    def pipeline(*args, **kw):   # keeps the times of the last conversion
        out = inner(*args, **kw)
        seen_times.append(list(args[2]))
        return out

    pipe.pipeline = pipeline
    t = np.arange(0.0, 10.0, 0.05)
    manual = np.stack([t, 150 + 50 * np.sin(2 * np.pi * 0.2 * t)], 1)
    # the input as vc_single hands it to the pipeline, and its pm track
    # over the padded signal, as the pipeline's own host path computes it
    x = load_audio(wav, 16000)
    x = x / max(np.abs(x).max() / 0.95, 1.0)
    x_pad = np.pad(highpass_filter(x), (pipe.t_pad, pipe.t_pad),
                   mode="reflect")
    track = pipe.f0_gen.calculate(x_pad, x_pad.shape[0] // 160, 0, "pm")
    cases = {
        "crepe": lambda: vc.vc_single(0, wav, f0_method="crepe")[1][1],
        "dio": lambda: vc.vc_single(0, wav, f0_method="dio")[1][1],
        "harvest": lambda: vc.vc_single(0, wav, f0_method="harvest",
                                        filter_radius=3)[1][1],
        "pm_manual_curve": lambda: vc.vc_single(0, wav, f0_method="pm",
                                                f0_file=manual)[1][1],
        "precomputed_pm_track": lambda: pipe.pipeline(
            0, x, [0.0, 0.0, 0.0], 0, track, None, 0.0, 2, 3, 0, 0.25,
            0.33),
    }
    rows = {}
    for name, run in cases.items():
        check_output(run(), n_expected, f"{name} warm-up")
        reset_launch_counts()
        t1 = time.perf_counter()
        audio = run()
        wall = (time.perf_counter() - t1) * 1e3
        counts = dict(launch_counts)
        check_output(audio, n_expected, name)
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, expected "
                                 f"{want}")
        rows[name] = dict(f0_ms=seen_times[-1][1] * 1e3, wall_ms=wall,
                          launches=counts)
    say("host_f0_conversions", input_s=10.0, model="v2/48k random weights",
        crepe="full, random weights", cases=rows)
    against_cpu(tmp, ("crepe", "harvest"), "host_f0_against_cpu",
                estimators=lambda dev: {"crepe": CRePE(model_path=crepe_path,
                                                       device=dev)})
    f0_network_profiles(tmp, crepe_path)
    engine = stream_engine(os.path.join(tmp, "v2_48k.pth"), tmp, "cuda")
    try:
        SlotScheduler(engine, 2, f0method="harvest", **STREAM)
    except ValueError as e:
        say("serving_refuses_host_f0", f0method="harvest", error=str(e))
    else:
        raise AssertionError("SlotScheduler took f0method='harvest'")
    f0_phase_seconds("F4", t0)
    return want


# ---------------------------------------------------------------------------
# phases M1-M3: ONNX, .pt2 and the checkpoint tools at full width
# ---------------------------------------------------------------------------

ONNX_T = 1024          # frames of the exported graph: 10 s is 998
VEC_SAMPLES = 160000   # 10 s at 16 kHz
# an exported graph against infer, or traced on the card against the CPU:
# sound runs read 0.0-4.6e-6 relative L2, the .pt2 with cuDNN in TF32
# read 6.8e-4
EXPORT_REL = 1e-4
# one model's hash on the card against the CPU read 0.999256-0.999978; a
# 1% change of one weight about 0.9977, another model under 0.5
SAME_MODEL = 0.998


def phase_seconds(name, t0):
    say("phase_seconds", phase_name=name, seconds=time.perf_counter() - t0)


def onnx_graph_args(T, seed, dev):
    """(phone, lengths, pitch, pitchf, ds, rnd) for a v2/48k graph at T."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(rng.standard_normal((1, T, 768)).astype(np.float32)),
            torch.tensor([T], device=dev),
            t(rng.integers(1, 255, (1, T)).astype(np.int64)),
            t(rng.uniform(80, 400, (1, T)).astype(np.float32)),
            torch.tensor([0], device=dev),
            t(rng.standard_normal((1, T, 192)).astype(np.float32)))


def export_pair(tmp, model, hubert, T, n_samples, dev, tag):
    """The synthesizer at T and ContentVec at n_samples as ONNX, traced on
    `dev` -> (synth path, vec path, {what: seconds, nodes, MB})."""
    from tpu_rvc_torch.ckpt.export import export_onnx
    from tpu_rvc_torch.ckpt.onnx_reader import load_onnx
    from tpu_rvc_torch.ckpt.torch2onnx import export_hubert_onnx

    paths = (os.path.join(tmp, f"synth_{tag}.onnx"),
             os.path.join(tmp, f"vec_{tag}.onnx"))
    stats = {}
    for name, path, run in (
            ("synth", paths[0], lambda: export_onnx(model, paths[0], T=T,
                                                    device=dev)),
            ("vec", paths[1], lambda: export_hubert_onnx(
                hubert, n_samples, path=paths[1]))):
        t0 = time.perf_counter()
        run()
        secs = time.perf_counter() - t0
        stats[name] = dict(seconds=secs,
                           nodes=len(load_onnx(path).nodes),
                           mb=os.path.getsize(path) / 1e6)
    return paths, stats


def onnx_conversion(tmp):
    """M1: the v2/48k model and HuBERT-base (768 x 12, seed 0) exported to
    ONNX on the card (T = 1024, 160000 samples); OnnxRVC on the card
    converts the 10 s voice with pm (1 warm-up, 3 timed): wall ms, each
    graph's CUDA-event ms, busy ms and operations (torch.profiler), peak
    memory, 0 kernel launches; the graph's forward against
    Synthesizer.infer on the card with the same rnd (kernels on); the
    synthesizer at T = 200 and ContentVec traced on the card and on the
    CPU; VC's 10 s conversion of the same model, voice and f0 method."""
    from tpu_rvc_torch.audio.io import load_audio
    from tpu_rvc_torch.ckpt.export import export_onnx
    from tpu_rvc_torch.ckpt.torch2onnx import export_hubert_onnx
    from tpu_rvc_torch.models.hubert import hubert_for_version
    from tpu_rvc_torch.models.loader import load_synthesizer
    from tpu_rvc_torch.models.onnx_exec import OnnxModule
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.onnx_infer import OnnxRVC
    from tpu_rvc_torch.pipeline.vc import VC

    t0 = time.perf_counter()
    model = os.path.join(tmp, "v2_48k.pth")
    wav_path = os.path.join(tmp, "voice_10s.wav")
    hubert = hubert_for_version("v2", "cuda")
    (synth_path, vec_path), exports = export_pair(
        tmp, model, hubert, ONNX_T, VEC_SAMPLES, "cuda", "m1")
    rvc = OnnxRVC(synth_path, hop_len=480, model_sr=48000, vec_path=vec_path,
                  device="cuda")
    wav = load_audio(wav_path, 48000)
    run = lambda: rvc.infer(wav, 48000, f0_method="pm")  # noqa: E731
    out = run()                                            # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        reset_launch_counts()
        t1 = time.perf_counter()
        out = run()
        walls.append((time.perf_counter() - t1) * 1e3)
        onnx_counts = dict(launch_counts)
        if any(onnx_counts.values()):
            raise AssertionError(f"ONNX conversion launched kernels "
                                 f"{onnx_counts}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_want = int(round(len(wav) / 48000 * 48000))
    if out.dtype != np.int16 or not 0 < len(out) <= n_want or \
            np.abs(out).max() == 0:
        raise AssertionError(f"ONNX conversion gave {out.dtype} "
                             f"{out.shape}")
    wav16 = torch.from_numpy(load_audio(wav_path, 16000)[None]).cuda()
    args = onnx_graph_args(ONNX_T, 13, "cuda")
    vec_ms = median_ms(lambda: rvc.vec.model(wav16), iters=3)
    synth_ms = median_ms(lambda: rvc.model(*args), iters=3)
    busy, top = device_busy_ms(run)
    # the graph against infer with the kernels, same rnd
    synth, _ = load_synthesizer(model, "cuda")
    reset_launch_counts()
    want = synth.infer(*args[:2], args[4], *args[2:4], noise=args[5],
                       noise_scale=1.0, deterministic=True)
    infer_counts = dict(launch_counts)
    got = rvc.model(*args)
    rel = rel_l2(got.double().cpu().numpy().ravel(),
                 want.double().cpu().numpy().ravel(),
                 "ONNX graph against infer on the card", limit=EXPORT_REL)
    # the synthesizer at T = 200 and ContentVec traced on the card and on
    # the CPU, each run on the card (ContentVec's card export is the one
    # above: an export costs the same at any length)
    short = onnx_graph_args(200, 14, "cuda")
    pair, pair_s = {}, {}
    for dev in ("cuda", "cpu"):
        path = os.path.join(tmp, f"synth_t200_{dev}.onnx")
        t1 = time.perf_counter()
        export_onnx(model, path, T=200, device=dev)
        pair_s[f"synth_{dev}"] = time.perf_counter() - t1
        pair[dev] = OnnxModule.from_file(path, "cuda")(*short)
    vec_cpu = os.path.join(tmp, "vec_cpu.onnx")
    t1 = time.perf_counter()
    export_hubert_onnx(hubert_for_version("v2", "cpu"), VEC_SAMPLES,
                       path=vec_cpu)
    pair_s["vec_cpu"] = time.perf_counter() - t1
    vec_feats = (rvc.vec.model(wav16),
                 OnnxModule.from_file(vec_cpu, "cuda")(wav16))
    as_np = lambda x: x.double().cpu().numpy().ravel()  # noqa: E731
    rel_pair = {
        "synth_t200": rel_l2(as_np(pair["cuda"]), as_np(pair["cpu"]),
                             "T=200 synth graph traced on card vs CPU",
                             limit=EXPORT_REL),
        "vec": rel_l2(as_np(vec_feats[0]), as_np(vec_feats[1]),
                      "ContentVec graph traced on card vs CPU",
                      limit=EXPORT_REL)}
    # VC's own conversion of the same model, voice and f0 method
    vc = VC(hubert_path="random")
    vc.get_vc(model)
    vc.vc_single(0, wav_path, f0_method="pm")
    vc_walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        vc.vc_single(0, wav_path, f0_method="pm")
        vc_walls.append((time.perf_counter() - t1) * 1e3)
    say("onnx_conversion", model="v2/48k random weights",
        hubert="HuBERT-base 768 x 12, seed 0", graph_T=ONNX_T,
        vec_samples=VEC_SAMPLES, exports=exports, input_s=10.0,
        f0_method="pm", wall_ms=walls, wall_ms_median=float(np.median(walls)),
        vec_graph_ms=vec_ms, synth_graph_ms=synth_ms,
        device_busy_ms=busy, device_ops=int(sum(c for _, _, c in top)),
        top_kernels=[[nm[:50], ms, c] for nm, ms, c in top[:6]],
        peak_mem_gb=peak_gb, output_samples=int(out.shape[0]),
        launches=onnx_counts, graph_vs_infer_rel_l2=rel,
        infer_launches=infer_counts,
        traced_card_vs_cpu_rel_l2=rel_pair, traced_pair_export_s=pair_s,
        vc_wall_ms=vc_walls, vc_wall_ms_median=float(np.median(vc_walls)))
    phase_seconds("M1", t0)


def pt2_on_card(tmp):
    """M2: `.pt2` of infer at T = 1024 traced and saved on the CPU, loaded
    onto the card and run against infer there (kernels on); its load
    seconds beside load_synthesizer's; the noisy variant runs finite."""
    from tpu_rvc_torch.ckpt.export import load_exported, save_exported
    from tpu_rvc_torch.models.loader import load_synthesizer

    t0 = time.perf_counter()
    model = os.path.join(tmp, "v2_48k.pth")
    cpu_synth, _ = load_synthesizer(model, "cpu")
    paths, export_s = {}, {}
    for det in (True, False):
        paths[det] = os.path.join(tmp, f"v2_48k_{int(det)}.pt2")
        t1 = time.perf_counter()
        save_exported(cpu_synth, paths[det], T=ONNX_T, deterministic=det)
        export_s[det] = time.perf_counter() - t1
    t1 = time.perf_counter()
    fn = load_exported(paths[True], "cuda")
    load_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    synth, _ = load_synthesizer(model, "cuda")
    torch.cuda.synchronize()
    synth_load_s = time.perf_counter() - t1
    phone, lengths, pitch, pitchf, sid, rnd = onnx_graph_args(ONNX_T, 15,
                                                              "cuda")
    args = (phone, lengths, sid, pitch, pitchf, rnd)
    got = fn(*args)
    want = synth.infer(*args[:5], noise=rnd, deterministic=True)
    rel = rel_l2(got.double().cpu().numpy().ravel(),
                 want.double().cpu().numpy().ravel(),
                 ".pt2 against infer on the card", limit=EXPORT_REL)
    noisy = load_exported(paths[False], "cuda")(*args)
    if noisy.shape != want.shape or not torch.isfinite(noisy).all():
        raise AssertionError(".pt2 with noise: not finite audio")
    ms = median_ms(lambda: fn(*args), iters=3)
    infer_ms = median_ms(lambda: synth.infer(*args[:5], noise=rnd,
                                             deterministic=True), iters=3)
    say("pt2_on_card", graph_T=ONNX_T, traced_on="cpu",
        export_s={"deterministic": export_s[True], "noisy": export_s[False]},
        pt2_mb=os.path.getsize(paths[True]) / 1e6, load_exported_s=load_s,
        load_synthesizer_s=synth_load_s, run_ms=ms, infer_ms=infer_ms,
        rel_l2_vs_infer=rel, meta=fn.meta)
    phase_seconds("M2", t0)


def checkpoint_tools(tmp, g_path):
    """M3: merge two random v2/48k models (alpha 0.3) and convert 10 s with
    the merged one (6 K1, 72 K2); change_info on it; extract a small model
    from the training run's G_*.pth and hash it on the card and on the CPU
    (equal, or similarity >= SAME_MODEL), and another model on the card
    (below it).  Returns the conversion's launches."""
    from tpu_rvc_torch.ckpt.hash import hash_id, hash_similarity, model_hash
    from tpu_rvc_torch.ckpt.small_model import (change_info,
                                                extract_small_model, merge)
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.models.hubert import hubert_for_version
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.vc import VC
    from tpu_rvc_torch.utils.base16384 import decode_from_string

    t0 = time.perf_counter()
    hp = hparams_for("v2", 48000)
    wav = os.path.join(tmp, "voice_10s.wav")
    other = os.path.join(tmp, "v2_48k_b.pth")
    write_model(other, hp, seed=21)
    merged = os.path.join(tmp, "merged.pth")
    t1 = time.perf_counter()
    merge(os.path.join(tmp, "v2_48k.pth"), other, 0.3, "48k", 1, "merged",
          "merged", "v2", out_path=merged)
    merge_s = time.perf_counter() - t1
    vc = VC(hubert_path="random")
    vc.get_vc(merged)
    vc.vc_single(0, wav, f0_method="pm")                     # warm-up
    reset_launch_counts()
    t1 = time.perf_counter()
    _, (sr, audio) = vc.vc_single(0, wav, f0_method="pm")
    wall = (time.perf_counter() - t1) * 1e3
    counts = dict(launch_counts)
    check_output(audio, expected_len(160000, vc.x_pad, 480, 48000),
                 "merged model's conversion")
    want = v2_48k_launches()
    if counts != want:
        raise AssertionError(f"merged model launches {counts}, want {want}")
    renamed = change_info(merged, "changed info", "merged_info.pth", tmp)
    if torch.load(renamed, weights_only=False)["info"] != "changed info":
        raise AssertionError("change_info did not write the info")
    extracted = extract_small_model(g_path, "extracted", "48k", 1, "", "v2",
                                    hp, out_path=os.path.join(
                                        tmp, "extracted.pth"))
    hashes = {}
    for dev in ("cuda", "cpu"):
        t1 = time.perf_counter()
        hvc = VC(x_pad=1.0, device=dev)
        meta = hvc.get_vc(extracted, hubert=hubert_for_version("v2", dev))
        h = model_hash(hvc.pipeline, int(meta.get("f0", 1)))
        hashes[dev] = (h, hash_id(h), time.perf_counter() - t1)
    sim = hash_similarity(hashes["cuda"][0], hashes["cpu"][0])
    if hashes["cuda"][0] != hashes["cpu"][0] and sim < SAME_MODEL:
        raise AssertionError(f"model hash card vs CPU: similarity {sim}")
    # another model must not pass for the extracted one
    hvc = VC(x_pad=1.0)
    hvc.get_vc(other, hubert=hubert_for_version("v2", "cuda"))
    sim_other = hash_similarity(hashes["cuda"][0],
                                model_hash(hvc.pipeline, 1))
    if sim_other >= SAME_MODEL:
        raise AssertionError(f"another model's hash reads {sim_other}")
    a, b = (np.frombuffer(decode_from_string(hashes[d][0]), ">i2")
            for d in ("cuda", "cpu"))
    say("checkpoint_tools", merge_alpha=0.3, merge_s=merge_s,
        merged_wall_ms=wall, merged_launches=counts, sr=sr,
        extracted_from=os.path.basename(g_path),
        hash_card_id=hashes["cuda"][1], hash_cpu_id=hashes["cpu"][1],
        hash_equal=hashes["cuda"][0] == hashes["cpu"][0],
        hash_similarity=sim, hash_words_differing=int((a != b).sum()),
        hash_similarity_other_model=sim_other, hash_gate=SAME_MODEL,
        hash_card_s=hashes["cuda"][2], hash_cpu_s=hashes["cpu"][2])
    phase_seconds("M3", t0)
    return counts


# ---------------------------------------------------------------------------
# phases U1-U4: UVR5 separation at full width
# ---------------------------------------------------------------------------

SEP_SR = 44100
SONG_S, LONG_S, SHORT_S = 30.0, 180.0, 3.0
SEP_GROUP = 8          # windows a call of the net
# the device path resamples the band pyramid with the windowed sinc, the
# host path with scipy: the JAX package's own bound between the two
DEVICE_VS_HOST = 0.05
# the separators' output is int16: card against CPU, and the port against
# the JAX package on the CPU (tests/test_torch_uvr5.py), within 2 LSB
CARD_VS_CPU_LSB = 2
MDX_C = 32             # the Conv-TDF clone's channels at its first level
MDX_CARD_VS_CPU = 1e-4


def song(seconds, seed):
    """A 44.1 kHz mix: `voice` with two tones and noise under it."""
    t = np.arange(int(SEP_SR * seconds)) / SEP_SR
    rng = np.random.default_rng(seed)
    x = (voice(seconds, seed, SEP_SR) + 0.15 * np.sin(2 * np.pi * 220 * t)
         + 0.1 * np.sin(2 * np.pi * 2637 * t)
         + 0.02 * rng.standard_normal(t.size))
    return (0.7 * x / np.abs(x).max()).astype(np.float32)


def write_song(tmp, seconds, seed=31):
    from tpu_rvc_torch.audio.io import save_wav

    path = os.path.join(tmp, f"song_{seconds:g}s.wav")
    if not os.path.exists(path):
        save_wav(path, song(seconds, seed), SEP_SR)
    return path


def check_stems(ins, voc, seconds, what):
    n = int(seconds * SEP_SR)
    for x in (ins, voc):
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] != 2 or not n - 2048 <= x.shape[0] <= n:
            raise AssertionError(f"{what}: stems of shape {x.shape} for "
                                 f"{n} samples")
        if not np.isfinite(x.astype(np.float32)).all() or \
                np.abs(x).max() == 0:
            raise AssertionError(f"{what}: stems are not finite audio")


def read_stereo_wav(path):
    """A 16-bit WAV's samples as they are, (T, channels) int16, and its
    rate (`load_wav` averages the channels)."""
    import wave

    with wave.open(path, "rb") as w:
        data = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        return data.reshape(-1, w.getnchannels()), w.getframerate()


def int16_lsb(a, b, what, limit=CARD_VS_CPU_LSB):
    if a.shape != b.shape:
        raise AssertionError(f"{what}: {a.shape} vs {b.shape}")
    lsb = int(np.abs(a.astype(np.int32) - b).max())
    if lsb > limit:
        raise AssertionError(f"{what}: {lsb} LSB apart, limit {limit}")
    return lsb


def no_kernel_launches(what):
    from tpu_rvc_torch.ops.kernels import launch_counts

    if any(launch_counts.values()):
        raise AssertionError(f"{what} launched kernels "
                             f"{dict(launch_counts)}; separation has none")
    return dict(launch_counts)


def separation_figures(dev_sep, path, seconds, n_timed=3):
    """`DeviceSeparator.separate(path)`: 1 warm-up and n_timed runs on the
    host clock to the int16 fetch, with CUDA-event spans, launches, peak
    memory, windows and calls of the net; then the profiler's busy ms
    over one more run and the graph's FLOPs (`last_graph_flops`, the
    LSTM counted as XLA counts it)."""
    from tpu_rvc_torch.ops.kernels import reset_launch_counts
    from tpu_rvc_torch.utils import timing

    calls = []
    hook = dev_sep.sep.model.register_forward_pre_hook(
        lambda m, args: calls.append(int(args[0].shape[0])))
    out = dev_sep.separate(path)                          # warm-up
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls, spans = [], []
    for _ in range(n_timed):
        calls.clear()
        reset_launch_counts()
        timing.enable()
        t0 = time.perf_counter()
        out = dev_sep.separate(path)
        walls.append((time.perf_counter() - t0) * 1e3)
        spans.append(timing.read())
        timing.disable()
        counts = no_kernel_launches("a separation")
        check_stems(out[0], out[1], seconds, "device separation")
    hook.remove()
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy, top = device_busy_ms(lambda: dev_sep.separate(path))
    flops = dev_sep.last_graph_flops()
    span_ms = {k: float(np.median([s.get(k, 0.0) for s in spans]))
               for k in spans[-1]}
    wall = float(np.median(walls))
    return out, counts, dict(
        input_s=seconds, tta=dev_sep.sep.tta, wall_ms=walls,
        wall_ms_median=wall, span_ms=span_ms, device_busy_ms=busy,
        busy_share=None if busy is None else busy / wall,
        device_ops=int(sum(c for _, _, c in top)),
        top_kernels=[[nm[:50], ms, c] for nm, ms, c in top[:5]],
        windows=sum(calls), net_calls=len(calls), window_group=dev_sep.group,
        flops=flops, tflops_per_s_net=flops / span_ms["net"] / 1e9,
        tflops_per_s_wall=flops / wall / 1e9,
        peak_fp32_tflops=PEAK_FP32 / 1e12, peak_mem_gb=peak,
        launches=counts)


def host_figures(sep, path, seconds, n_timed=3):
    """`UVR5Separator.separate(path)`, the host path: 1 warm-up and
    n_timed runs -> (ins, voc, wall ms)."""
    from tpu_rvc_torch.ops.kernels import reset_launch_counts

    sep.separate(path)
    walls = []
    for _ in range(n_timed):
        reset_launch_counts()
        t0 = time.perf_counter()
        ins, voc, _ = sep.separate(path)
        walls.append((time.perf_counter() - t0) * 1e3)
        no_kernel_launches("a host-path separation")
    check_stems(ins, voc, seconds, "host separation")
    return ins, voc, walls


def device_vs_host(dev_out, host_out, what):
    rels = {}
    for i, stem in enumerate(("instrument", "vocal")):
        d, h = dev_out[i], host_out[i]
        n = min(len(d), len(h))
        rels[stem] = rel_l2(d[:n].astype(np.float64) / 32768.0,
                            h[:n].astype(np.float64),
                            f"{what} {stem}: device against host path",
                            limit=DEVICE_VS_HOST)
    return rels


def card_vs_cpu(path_model, path, make_dev, what):
    """The device path on the card and on the CPU for the SHORT_S input:
    int16 within CARD_VS_CPU_LSB, and the relative L2 beside it."""
    from tpu_rvc_torch.pipeline.uvr5 import load_separator

    outs = {d: make_dev(load_separator(path_model, device=d)).separate(path)
            for d in ("cuda", "cpu")}
    figures = {}
    for i, stem in enumerate(("instrument", "vocal")):
        a, b = (outs[d][i].astype(np.float64) for d in ("cuda", "cpu"))
        figures[stem] = dict(
            lsb=int16_lsb(outs["cuda"][i], outs["cpu"][i],
                          f"{what} {stem} card vs CPU"),
            rel_l2=float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    return figures


def hp_separation(tmp):
    """U1: an HP5-style CascadedASPPNet at full width from a random-weight
    `.pth` in the reference layout (n_fft 1344, 4band_v2, window 512,
    offset 128, agg 10): load_separator -> DeviceSeparator on the 30 s
    song, TTA off and on; the host path and device against host; a
    3-minute song's peak memory; 3 s card against CPU; the HP3 name swaps
    the stems.  Returns the launches."""
    from tpu_rvc_torch.ckpt.uvr5_loader import (
        random_cascaded_aspp_reference_state)
    from tpu_rvc_torch.pipeline.uvr5 import DeviceSeparator, load_separator

    t0 = time.perf_counter()
    sd = random_cascaded_aspp_reference_state(41, 1344)
    paths = {n: os.path.join(tmp, f"{n}_random.pth") for n in ("HP5", "HP3")}
    for p in paths.values():
        torch.save(sd, p)
    song30, song180, song3 = (write_song(tmp, s)
                              for s in (SONG_S, LONG_S, SHORT_S))
    sep = load_separator(paths["HP5"])
    if sep.is_reverse or sep.model.max_bin != 672:
        raise AssertionError("HP5 name: not the 4band_v2 HP net")
    dev = DeviceSeparator(sep, group=SEP_GROUP)
    figures = {}
    for tta in (False, True):
        sep.tta = tta
        out, counts, figures[f"tta_{int(tta)}"] = separation_figures(
            dev, song30, SONG_S)
        if not tta:
            dev_out = out
            count_path("uvr5_hp5_30s", dev.last_graph_flops,
                       figures["tta_0"]["wall_ms_median"], torch.float32,
                       counts, kernel_flops())
    sep.tta = False
    ins, voc, host_walls = host_figures(sep, song30, SONG_S, n_timed=1)
    rels = device_vs_host(dev_out, (ins, voc), "HP5")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    long_out = dev.separate(song180)
    long_s = time.perf_counter() - t1
    check_stems(*long_out[:2], LONG_S, "3-minute separation")
    long_peak = torch.cuda.max_memory_allocated() / 1e9
    cpu = card_vs_cpu(paths["HP5"], song3,
                      lambda s: DeviceSeparator(s, group=SEP_GROUP), "HP5")
    hp3 = DeviceSeparator(load_separator(paths["HP3"]), group=SEP_GROUP)
    short = dev.separate(song3)
    swapped = hp3.separate(song3)
    if not hp3.sep.is_reverse:
        raise AssertionError("HP3 name: outputs not swapped")
    swap_lsb = max(int16_lsb(swapped[0], short[1], "HP3 instrument", 0),
                   int16_lsb(swapped[1], short[0], "HP3 vocal", 0))
    say("uvr5_hp", model="CascadedASPPNet random weights (HP5 layout)",
        params="4band_v2", n_fft=1344, window=512, offset=128, agg=10,
        **figures, host_wall_ms=host_walls,
        host_wall_ms_median=float(np.median(host_walls)),
        device_vs_host_rel_l2=rels, long_input_s=LONG_S, long_wall_s=long_s,
        long_peak_mem_gb=long_peak, card_vs_cpu_3s=cpu,
        card_vs_cpu_gate=f"int16 within {CARD_VS_CPU_LSB} LSB",
        hp3_swap_lsb=swap_lsb)
    phase_seconds("U1", t0)
    return counts


def deecho_separation(tmp):
    """U2: CascadedNetDeEcho at full width (nout 32, nout_lstm 128,
    4band_v3, window 512, offset 64) from a random-weight
    `VR-DeEchoNormal_random.pth`: the figures of U1 with TTA off, the
    stems swapped, 3 s card against CPU.  Returns the launches."""
    from tpu_rvc_torch.ckpt.uvr5_loader import random_deecho_reference_state
    from tpu_rvc_torch.models.uvr5 import CascadedNetDeEcho
    from tpu_rvc_torch.pipeline.uvr5 import (DeviceSeparator, UVR5Separator,
                                             load_separator)

    t0 = time.perf_counter()
    path = os.path.join(tmp, "VR-DeEchoNormal_random.pth")
    torch.save(random_deecho_reference_state(42, 1344, 32, 128), path)
    song30, song3 = write_song(tmp, SONG_S), write_song(tmp, SHORT_S)
    sep = load_separator(path)
    if not (isinstance(sep.model, CascadedNetDeEcho) and sep.is_reverse
            and sep.model.out.in_channels == 32):
        raise AssertionError("DeEcho name: not the reversed DeEcho net")
    dev = DeviceSeparator(sep, group=SEP_GROUP)
    dev_out, counts, figures = separation_figures(dev, song30, SONG_S)
    ins, voc, host_walls = host_figures(sep, song30, SONG_S, n_timed=1)
    rels = device_vs_host(dev_out, (ins, voc), "DeEcho")
    cpu = card_vs_cpu(path, song3,
                      lambda s: DeviceSeparator(s, group=SEP_GROUP), "DeEcho")
    plain = DeviceSeparator(UVR5Separator(sep.model, sep.mp,
                                          window_size=sep.window_size),
                            group=SEP_GROUP).separate(song3)
    short = dev.separate(song3)
    swap_lsb = max(int16_lsb(short[0], plain[1], "DeEcho instrument", 0),
                   int16_lsb(short[1], plain[0], "DeEcho vocal", 0))
    say("uvr5_deecho", model="CascadedNetDeEcho random weights",
        params="4band_v3", n_fft=1344, nout=32, nout_lstm=128, window=512,
        offset=64, agg=10, **figures, host_wall_ms=host_walls,
        host_wall_ms_median=float(np.median(host_walls)),
        device_vs_host_rel_l2=rels, card_vs_cpu_3s=cpu,
        card_vs_cpu_gate=f"int16 within {CARD_VS_CPU_LSB} LSB",
        swap_lsb=swap_lsb)
    phase_seconds("U2", t0)
    return counts


def mdx_separation(tmp):
    """U3: MDX-Net on the port's ONNX executor: the Conv-TDF clone at the
    published dims (dim_f 3072, 512 frames, n_fft 6144; MDX_C channels)
    written as `vocals.onnx`; load_separator -> MDXNetDereverb;
    `_path_audio_` on 10 s writes both stems; the demix's wall ms, the
    graph's CUDA-event ms, busy ms and operations; 3 s card against CPU.
    Returns the launches."""
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_rvc_torch.audio.io import load_wav
    from tpu_rvc_torch.ops.kernels import reset_launch_counts
    from tpu_rvc_torch.pipeline.mdxnet import MDXNetDereverb, conv_tdf_onnx
    from tpu_rvc_torch.pipeline.uvr5 import load_separator
    from tpu_rvc_torch.utils import timing

    t0 = time.perf_counter()
    onnx_dir = os.path.join(tmp, "onnx_dereverb_By_FoxJoy")
    os.makedirs(onnx_dir, exist_ok=True)
    with open(os.path.join(onnx_dir, "vocals.onnx"), "wb") as f:
        f.write(conv_tdf_onnx(c=MDX_C, seed=43))
    mdx = load_separator(onnx_dir)
    if not isinstance(mdx, MDXNetDereverb):
        raise AssertionError("onnx_dereverb name: not MDX-Net")
    song10, song3 = write_song(tmp, 10.0), write_song(tmp, SHORT_S)
    out_dir = os.path.join(tmp, "mdx_out")
    reset_launch_counts()
    mdx._path_audio_(song10, os.path.join(out_dir, "voc"),
                     os.path.join(out_dir, "ins"))
    counts = no_kernel_launches("MDX-Net")
    for sub, stem in (("voc", "vocal"), ("ins", "instrument")):
        x, sr = load_wav(os.path.join(out_dir, sub,
                                      f"{stem}_song_10s.wav.wav"))
        if sr != SEP_SR or len(x) != int(10.0 * SEP_SR) or \
                not np.isfinite(x).all() or np.abs(x).max() == 0:
            raise AssertionError(f"MDX-Net {stem}: {sr} Hz, {x.shape}")
    mix = np.stack([song(10.0, 31)] * 2)
    mdx.pred.demix(mix)                                  # warm-up
    walls, graph = [], []
    for _ in range(3):
        reset_launch_counts()
        timing.enable()
        t1 = time.perf_counter()
        opt = mdx.pred.demix(mix)
        walls.append((time.perf_counter() - t1) * 1e3)
        graph.append(timing.read()["net"])
        timing.disable()
        no_kernel_launches("MDX-Net")
    busy, top = device_busy_ms(lambda: mdx.pred.demix(mix))
    with FlopCounterMode(display=False) as fc:
        mdx.pred.demix(mix)
    mix3 = np.stack([song(SHORT_S, 31)] * 2)
    got = mdx.pred.demix(mix3)
    want = MDXNetDereverb(onnx_dir, device="cpu").pred.demix(mix3)
    rel = rel_l2(got.astype(np.float64), want.astype(np.float64),
                 "MDX-Net demix card vs CPU", limit=MDX_CARD_VS_CPU)
    say("uvr5_mdx", model=f"Conv-TDF clone, random weights, c={MDX_C}",
        dim_f=3072, dim_t=512, n_fft=6144, input_s=10.0,
        output_peak=float(np.abs(opt).max()), demix_wall_ms=walls,
        demix_wall_ms_median=float(np.median(walls)), graph_ms=graph,
        graph_ms_median=float(np.median(graph)), device_busy_ms=busy,
        device_ops=int(sum(c for _, _, c in top)),
        top_kernels=[[nm[:50], ms, c] for nm, ms, c in top[:5]],
        flops=fc.get_total_flops(), card_vs_cpu_3s_rel_l2=rel,
        launches=counts)
    phase_seconds("U3", t0)
    return counts


def separate_app(tmp):
    """U4: `python -m tpu_rvc_torch.apps.separate` in a process of its own
    on U1's model and a 5 s song: both files exist and hold
    DeviceSeparator.separate's output within CARD_VS_CPU_LSB.  The app
    prints a failure and goes on, so only these checks catch one.  Returns
    the launches of the in-process separation."""
    from tpu_rvc_torch.ops.kernels import reset_launch_counts
    from tpu_rvc_torch.pipeline.uvr5 import DeviceSeparator, load_separator

    t0 = time.perf_counter()
    model = os.path.join(tmp, "HP5_random.pth")
    song5 = write_song(tmp, 5.0)
    out_dir = os.path.join(tmp, "app_out")
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_rvc_torch.apps.separate", "--model",
         model, "--input", song5, "--vocal-dir",
         os.path.join(out_dir, "voc"), "--ins-dir",
         os.path.join(out_dir, "ins")], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    app_s = time.perf_counter() - t1
    reset_launch_counts()
    ins, voc, sr = DeviceSeparator(load_separator(model),
                                   group=SEP_GROUP).separate(song5)
    counts = no_kernel_launches("the app's separation")
    name = os.path.basename(song5)
    diffs = {}
    for sub, stem, want in (("ins", "instrument", ins),
                            ("voc", "vocal", voc)):
        path = os.path.join(out_dir, sub, f"{stem}_{name}.wav")
        if not os.path.exists(path):
            raise AssertionError(f"separate app wrote no {path}: "
                                 f"{proc.stdout[-2000:]} "
                                 f"{proc.stderr[-2000:]}")
        got, got_sr = read_stereo_wav(path)
        if got_sr != sr:
            raise AssertionError(f"separate app wrote {got_sr} Hz")
        # cuDNN times its algorithms in each process (cudnn_autotune), so
        # the app's process may take others: the last bits may differ
        diffs[stem] = int16_lsb(got, want, f"separate app {stem}")
    say("uvr5_app", command="python -m tpu_rvc_torch.apps.separate",
        input_s=5.0, app_s=app_s, returncode=proc.returncode,
        stdout=proc.stdout.strip()[-200:], lsb_vs_library=diffs)
    phase_seconds("U4", t0)
    return counts


def separation_phases(tmp):
    """U1-U4 -> the launches of each (all 0)."""
    return [hp_separation(tmp), deecho_separation(tmp), mdx_separation(tmp),
            separate_app(tmp)]


# ---------------------------------------------------------------------------
# D1-D3: conversion across devices (parallel/chunks.py, parallel/batch.py)
# and the convert, convert_batch and assets apps
# ---------------------------------------------------------------------------

LONG_S = 180.0        # D1: 3 chunks at x_center 60 / x_max 65
LONG_PEAK_S = 600.0   # D1: the 10-minute file whose peak memory is read
SMALL_GEOMETRY = dict(x_pad=0.5, x_query=1.0, x_center=4.0, x_max=5.0)
BATCH_ROWS = 8        # D2: 8 x 10 s in a 16 s bucket
SAME_LSB = 4          # chunk-parallel vs sequential, common-bucket chunks
SHARD_LSB = 1         # two logical shards vs one; batch rows vs single
APP_LSB = 2           # the app's file vs the library (cuDNN per process)


def chunk_table(pipe, audio16):
    """convert_long's chunk table for `audio16`: (true lengths, common
    bucket, frames of the bucket, output sample indices of the chunks
    whose own bucket is the common one)."""
    from tpu_rvc_torch.audio.dsp import highpass_filter
    from tpu_rvc_torch.pipeline.vc import (WINDOW, _bucket, _feat_frames,
                                           chunk_spans, silence_chunk_bounds)

    bounds = silence_chunk_bounds(highpass_filter(audio16), pipe.t_center,
                                  pipe.t_query, pipe.t_max)
    lens = [n for _, n, _ in chunk_spans(len(audio16) + 2 * pipe.t_pad,
                                         bounds, pipe.t_pad2)]
    bucket = _bucket(max(lens))
    frames = min(bucket // WINDOW, _feat_frames(bucket))
    idx, pos = [], 0
    for n in lens:
        size = min(n // WINDOW, frames) * pipe.synth.hop - 2 * pipe.t_pad_tgt
        if _bucket(n) == bucket:
            idx.append(np.arange(pos, pos + size))
        pos += size
    return lens, bucket, frames, np.concatenate(idx)


def lsb_check(got, want, lsb, what, share=0.999):
    """int16 outputs of one shape, within `lsb` on more than `share` of
    the samples -> (share within, max difference)."""
    if got.shape != want.shape or got.dtype != np.int16:
        raise AssertionError(f"{what}: {got.dtype} {got.shape} against "
                             f"{want.dtype} {want.shape}")
    d = np.abs(got.astype(np.int32) - want)
    within = float(np.mean(d <= lsb))
    if not within > share:
        raise AssertionError(f"{what}: only {within} of samples within "
                             f"{lsb} LSB (max {int(d.max())})")
    return within, int(d.max())


def device_pipeline(model, dev, deterministic=True, rmvpe_root=None,
                    **geometry):
    from tpu_rvc_torch.models.hubert import hubert_for_version
    from tpu_rvc_torch.models.loader import load_synthesizer
    from tpu_rvc_torch.pipeline.vc import Pipeline

    synth, _ = load_synthesizer(model, dev)
    kw = dict(noise_scale=0.0, deterministic=True) if deterministic else {}
    return Pipeline(48000, hubert=hubert_for_version("v2", dev), synth=synth,
                    rmvpe_root=rmvpe_root or "assets/rmvpe", device=dev,
                    **kw, **geometry)


def timed_runs(fn, n_timed=3):
    """1 warm-up, then n_timed runs on the host clock with their spans and
    launches -> (walls, median spans, launches of the last run, output)."""
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.utils import timing

    fn()
    walls, spans = [], []
    for _ in range(n_timed):
        timing.enable()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = dict(launch_counts)
        spans.append(timing.read())
        timing.disable()
    split = {k: float(np.median([s.get(k, 0.0) for s in spans]))
             for k in spans[-1]}
    return walls, split, counts, out


def long_file(tmp, index):
    """D1: convert_long on the card through `VC.vc_single(chunk_parallel=
    True)` -> (launches of one conversion with pm, kernel shapes)."""
    from tpu_rvc_torch.audio.io import load_audio
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.core.mesh import make_mesh
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.parallel import convert_long
    from tpu_rvc_torch.parallel.chunks import ROWS_PER_CALL
    from tpu_rvc_torch.pipeline.vc import VC

    t0 = time.perf_counter()
    hp = hparams_for("v2", 48000)
    model = os.path.join(tmp, "v2_48k.pth")
    wav = os.path.join(tmp, "voice_3min.wav")
    write_voice(wav, LONG_S, seed=41)
    audio16 = load_audio(wav, 16000)
    vc = VC(rmvpe_root=tmp, hubert_path="random")
    vc.get_vc(model)
    lens, bucket, frames, same = chunk_table(vc.pipeline, audio16)
    calls = -(-len(lens) // ROWS_PER_CALL)
    n_out = sum(min(n // 160, frames) * 480 - 2 * vc.pipeline.t_pad_tgt
                for n in lens)
    figures, main_counts = {}, None
    for method in ("pm", "rmvpe"):
        kw = dict(f0_method=method, index=index, index_rate=0.75)
        run = lambda: vc.vc_single(0, wav, chunk_parallel=True,  # noqa
                                   **kw)[1][1]
        torch.cuda.reset_peak_memory_stats()
        walls, spans, counts, out = timed_runs(run, 1)
        check_output(out, n_out, f"chunk-parallel {method}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        if counts != want_launches(hp, calls):
            raise AssertionError(f"convert_long {method} launched {counts}, "
                                 f"expected {want_launches(hp, calls)}")
        busy, top = device_busy_ms(run)
        seq = lambda: vc.vc_single(0, wav, **kw)[1][1]  # noqa: E731
        seq_walls, seq_spans, seq_counts, seq_out = timed_runs(seq, 1)
        check_output(seq_out, n_out, f"sequential {method}")
        figures[method] = dict(
            wall_ms=walls, wall_ms_median=float(np.median(walls)),
            span_ms=spans, device_busy_ms=busy,
            busy_share=None if busy is None else busy / float(
                np.median(walls)),
            top_kernels=[[nm[:50], ms, c] for nm, ms, c in top[:5]],
            peak_mem_gb=peak, launches=counts,
            sequential_wall_ms=seq_walls[0], sequential_span_ms=seq_spans,
            sequential_launches=seq_counts)
        main_counts = main_counts or counts
    say("long_file", input_s=LONG_S, chunks=len(lens), chunk_samples=lens,
        bucket_s=bucket / 16000, frames=frames, rows_per_call=ROWS_PER_CALL,
        calls=calls, mesh="make_mesh() over the visible cards",
        cards=torch.cuda.device_count(), **figures)

    # deterministic engines
    det = device_pipeline(model, "cuda")
    par = convert_long(det, 0, audio16, make_mesh(), f0_method="pm",
                       index=index, index_rate=0.75, rms_mix_rate=0.25)
    seq = det.pipeline(0, audio16, [0.0] * 3, 0, "pm", index, 0.75, 1, 3, 0,
                       0.25, 0.33)
    same_share, same_max = lsb_check(par[same], seq[same], SAME_LSB,
                                     "chunk-parallel vs sequential")
    reset_launch_counts()
    twice = convert_long(det, 0, audio16, make_mesh(devices=["cuda:0"] * 2),
                         f0_method="pm", index=index, index_rate=0.75,
                         rms_mix_rate=0.25)
    twice_counts = dict(launch_counts)
    shard_share, shard_max = lsb_check(twice, par, SHARD_LSB,
                                       "two logical shards vs one")
    # 12 s in 3 chunks of the small geometry: the card against the CPU
    short = voice(12.0, seed=42)
    outs = [convert_long(device_pipeline(model, dev, **SMALL_GEOMETRY), 0,
                         short, make_mesh(devices=[dev]), f0_method="pm",
                         rms_mix_rate=0.25).astype(np.float64)
            for dev in ("cuda", "cpu")]
    rel = rel_l2(outs[0], outs[1], "chunk-parallel 12 s")
    say("long_file_checks", same_bucket_samples=int(same.size),
        samples=int(par.size), same_within_lsb=same_share,
        same_max_lsb=same_max, lsb_limit=SAME_LSB,
        two_shards_within_lsb=shard_share, two_shards_max_lsb=shard_max,
        two_shards_launches=twice_counts, card_vs_cpu_12s_rel_l2=rel)

    # the peak of a 10-minute file, ROWS_PER_CALL rows a call
    audio_peak = np.resize(audio16, int(LONG_PEAK_S * 16000))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t1 = time.perf_counter()
    out_peak = convert_long(vc.pipeline, 0, audio_peak, make_mesh(),
                            f0_method="pm", index=index, index_rate=0.75,
                            rms_mix_rate=0.25)
    wall_peak = time.perf_counter() - t1
    # one chunk a t_center step (silence_chunk_bounds), without its scan
    n_peak = (audio_peak.size - 1) // vc.pipeline.t_center + 1
    calls_peak = -(-n_peak // ROWS_PER_CALL)
    if dict(launch_counts) != want_launches(hp, calls_peak) or \
            not np.abs(out_peak).max() > 0:
        raise AssertionError(f"10-minute file: launches "
                             f"{dict(launch_counts)}, peak {out_peak.max()}")
    say("long_file_peak", input_s=LONG_PEAK_S, chunks=n_peak,
        calls=calls_peak, rows_per_call=ROWS_PER_CALL, wall_s=wall_peak,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        output_samples=int(out_peak.size))

    # the one-resblock model: K3 on a short chunk-parallel conversion
    rb = device_pipeline(os.path.join(tmp, "v2_48k_rb1.pth"), "cuda",
                         deterministic=False, **SMALL_GEOMETRY)
    rb_lens, _, rb_frames, _ = chunk_table(rb, short)
    reset_launch_counts()
    out_rb = convert_long(rb, 0, short, make_mesh(), f0_method="pm")
    rb_counts = dict(launch_counts)
    rb_calls = -(-len(rb_lens) // ROWS_PER_CALL)
    if rb_counts != want_launches(hp, rb_calls, n_rb=1) or \
            not np.abs(out_rb).max() > 0:
        raise AssertionError(f"one-resblock convert_long: {rb_counts}")
    say("long_file_single_resblock", input_s=12.0, chunks=len(rb_lens),
        frames=rb_frames, launches=rb_counts)
    phase_seconds("D1", t0)
    shapes = dict(frames=frames, lengths=[min(n // 160, frames)
                                          for n in lens],
                  rb_frames=rb_frames, rb_rows=len(rb_lens))
    return main_counts, rb_counts, shapes


def batched_utterances(tmp, index):
    """D2: batch_convert of 8 x 10 s voices in one 16 s bucket -> the
    launches of one dispatch."""
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.core.mesh import make_mesh
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.parallel import batch_convert
    from tpu_rvc_torch.pipeline.vc import VC, _bucket, _feat_frames

    t0 = time.perf_counter()
    hp = hparams_for("v2", 48000)
    model = os.path.join(tmp, "v2_48k.pth")
    vc = VC(rmvpe_root=tmp, hubert_path="random")
    vc.get_vc(model)
    pad = vc.pipeline.t_pad
    rows = np.stack([np.pad(voice(10.0, seed=50 + i), (pad, pad),
                            mode="reflect") for i in range(BATCH_ROWS)])
    mesh = make_mesh()
    kw = dict(f0_method="pm", index=index, index_rate=0.75)
    run = lambda: batch_convert(vc.pipeline, rows,  # noqa: E731
                                np.zeros(BATCH_ROWS, np.int64), mesh, **kw)
    torch.cuda.reset_peak_memory_stats()
    walls, spans, counts, out = timed_runs(run)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_out = expected_len(160000, vc.x_pad, 480, 48000)
    for i in range(BATCH_ROWS):
        check_output(out[i], n_out, f"batch row {i}")
    if counts != want_launches(hp, 1):
        raise AssertionError(f"batch_convert launched {counts}, expected "
                             f"{want_launches(hp, 1)}")
    busy, top = device_busy_ms(run)
    wav10 = os.path.join(tmp, "voice_10s.wav")
    single = lambda: vc.vc_single(0, wav10, **kw)  # noqa: E731
    single_walls = timed_runs(single)[0]
    # deterministic: each row against its single conversion
    det = device_pipeline(model, "cuda")
    got = batch_convert(det, rows, np.zeros(BATCH_ROWS, np.int64), mesh, **kw)
    arrays = det._index_arrays(index, 0.75)
    shares = []
    for i in range(BATCH_ROWS):
        one = det._full(torch.as_tensor(rows[i], device="cuda"), 0.0, 0,
                        True, arrays, 0.75, 0.33, 0.25, det._generator(i),
                        "pm").cpu().numpy()
        shares.append(lsb_check(got[i], one, SHARD_LSB, f"batch row {i}"))
    say("batched_utterances", rows=BATCH_ROWS, input_s=10.0, bucket_s=16.0,
        wall_ms=walls, wall_ms_median=float(np.median(walls)),
        wall_ms_per_utterance=float(np.median(walls)) / BATCH_ROWS,
        single_vc_single_wall_ms_median=float(np.median(single_walls)),
        span_ms=spans, device_busy_ms=busy,
        busy_share=None if busy is None else busy / float(np.median(walls)),
        top_kernels=[[nm[:50], ms, c] for nm, ms, c in top[:5]],
        peak_mem_gb=peak, launches=counts,
        rows_within_lsb=[s for s, _ in shares],
        rows_max_lsb=[m for _, m in shares])
    # the one-resblock model: K3 over 2 rows of 3 s
    rb = device_pipeline(os.path.join(tmp, "v2_48k_rb1.pth"), "cuda",
                         deterministic=False)
    rb_rows = np.stack([np.pad(voice(3.0, seed=60 + i), (pad, pad),
                               mode="reflect") for i in range(2)])
    rb_bucket = _bucket(rb_rows.shape[1])
    rb_frames = min(rb_bucket // 160, _feat_frames(rb_bucket))
    reset_launch_counts()
    rb_out = batch_convert(rb, rb_rows, [0, 0], mesh, f0_method="pm")
    rb_counts = dict(launch_counts)
    if rb_counts != want_launches(hp, 1, n_rb=1) or \
            not np.abs(rb_out).max() > 0:
        raise AssertionError(f"one-resblock batch_convert: {rb_counts}")
    say("batched_utterances_single_resblock", rows=2, input_s=3.0,
        launches=rb_counts)
    phase_seconds("D2", t0)
    return counts, rb_counts, rb_frames


def app(module, *args, timeout=600):
    """`python -m <module> args` in a process of its own, from the repo."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=REPO))
    return proc, time.perf_counter() - t0


def conversion_apps(tmp, index):
    """D3: the convert, convert_batch and assets apps in processes of their
    own."""
    from tpu_rvc_torch.audio.io import load_wav, save_wav
    from tpu_rvc_torch.pipeline.vc import VC

    t0 = time.perf_counter()
    model = os.path.join(tmp, "v2_48k.pth")
    wav = os.path.join(tmp, "voice_3min.wav")
    index_path = os.path.join(tmp, "random_index.npz")
    index.save(index_path)
    out = os.path.join(tmp, "app_convert.wav")
    proc, convert_s = app(
        "tpu_rvc_torch.apps.convert", "--input", wav, "--output", out,
        "--model", model, "--index", index_path, "--hubert", "random",
        "--rmvpe-root", tmp, "--f0-method", "pm", "--index-rate", "0.75",
        "--rms-mix-rate", "0.25", "--chunk-parallel")
    if proc.returncode != 0 or not os.path.exists(out):
        raise AssertionError(f"convert app failed: {proc.stdout[-2000:]} "
                             f"{proc.stderr[-2000:]}")
    vc = VC(rmvpe_root=tmp, hubert_path="random")
    vc.get_vc(model)
    _, (sr, lib) = vc.vc_single(0, wav, f0_method="pm", index=index,
                                index_rate=0.75, rms_mix_rate=0.25,
                                chunk_parallel=True)
    got, got_sr = load_wav(out)
    got = np.round(got * 32768.0).astype(np.int16)
    if got_sr != sr:
        raise AssertionError(f"convert app wrote {got_sr} Hz")
    app_share, app_max = lsb_check(got, lib, APP_LSB, "convert app vs "
                                   "vc_single", share=1.0 - 1e-9)

    src = os.path.join(tmp, "batch_in")
    dst = os.path.join(tmp, "batch_out")
    os.makedirs(src, exist_ok=True)
    for i, seconds in enumerate((2.0, 3.0, 4.0)):
        save_wav(os.path.join(src, f"v{i}.wav"), voice(seconds, 70 + i),
                 16000)
    proc_b, batch_s = app(
        "tpu_rvc_torch.apps.convert_batch", "--input-dir", src,
        "--output-dir", dst, "--model", model, "--hubert", "random",
        "--rmvpe-root", tmp, "--f0-method", "pm")
    lines = [ln for ln in proc_b.stdout.splitlines() if " -> " in ln]
    names = [ln.split(" -> ")[0] for ln in lines]
    if proc_b.returncode != 0 or names != [f"v{i}.wav" for i in range(3)] \
            or not all(" -> Success (" in ln for ln in lines) or \
            sorted(os.listdir(dst)) != [f"v{i}.wav.wav" for i in range(3)]:
        raise AssertionError(f"convert_batch app: {proc_b.stdout[-2000:]} "
                             f"{proc_b.stderr[-2000:]}")

    root = os.path.join(tmp, "asset_root")
    os.makedirs(os.path.join(root, "assets"), exist_ok=True)
    files = []
    for name, data in (("a.bin", b"alpha" * 100), ("b.pth", bytes(4096))):
        files.append(os.path.join(root, "assets", name))
        with open(files[-1], "wb") as f:
            f.write(data)
    env = os.path.join(root, "sha256.env")
    gen, _ = app("tpu_rvc_torch.apps.assets", "gen", "--out", env, *files)
    good, _ = app("tpu_rvc_torch.apps.assets", "check", "--root", root)
    with open(files[1], "r+b") as f:
        f.write(b"\x01")
    bad, _ = app("tpu_rvc_torch.apps.assets", "check", "--root", root)
    if (gen.returncode, good.returncode, bad.returncode) != (0, 0, 1):
        raise AssertionError(f"assets app: gen {gen.returncode}, check "
                             f"{good.returncode} then {bad.returncode}: "
                             f"{gen.stderr[-1000:]} {good.stderr[-1000:]}")
    say("conversion_apps", convert_s=convert_s,
        convert_stdout=proc.stdout.strip().splitlines()[-2:],
        convert_within_lsb=app_share, convert_max_lsb=app_max,
        lsb_limit=APP_LSB, convert_batch_s=batch_s, convert_batch_lines=lines,
        assets_exit_codes=[gen.returncode, good.returncode, bad.returncode])
    phase_seconds("D3", t0)


def batched_offline_kernels(shapes):
    """Each kernel against its batched plain twin at D1's and D2's shapes:
    K1 over D1's rows (and over the last row with a one-frame filler row
    of a second logical shard), K2 at D1's (n, C, T) and D2's (8, C, T),
    K3 at the one-resblock model's chunk-parallel and batched shapes."""
    from tpu_rvc_torch.ops import kernels as kr
    from tpu_rvc_torch.ops.kernels import resblock as rs

    g = torch.Generator(device="cuda").manual_seed(1)
    ks = (3, 7, 11)
    F, lens = shapes["frames"], shapes["lengths"]
    n = len(lens)
    level = lambda frames: [(256, frames * 12), (128, frames * 120),  # noqa
                            (64, frames * 240), (32, frames * 480)]
    long1 = check_attention(kr, g, F, ([x for x in lens for _ in (0, 1)],),
                            "kernel_long")
    filler = check_attention(kr, g, F, ([lens[-1]] * 2 + [1, 1],),
                             "kernel_long_filler")
    long2 = check_stage(rs, g, "fused_stage", level(F), ks, "kernel_long",
                        N=n, by_stream=False)
    long3 = check_stage(rs, g, "fused_resblock", level(shapes["rb_frames"]),
                        (7,), "kernel_long", N=shapes["rb_rows"],
                        by_stream=False)
    b1 = check_attention(kr, g, 1598, ([1598] * (2 * BATCH_ROWS),),
                         "kernel_batch_offline")
    b2 = check_stage(rs, g, "fused_stage", level(1598), ks,
                     "kernel_batch_offline", N=BATCH_ROWS, by_stream=False)
    b3 = check_stage(rs, g, "fused_resblock",
                     level(shapes["rb_batch_frames"]), (7,),
                     "kernel_batch_offline", N=2, by_stream=False)
    total = lambda rows, i: sum(r[i] for r in rows)  # noqa: E731

    def rows_entry(prefix, rows, shape, worst):
        return {f"{prefix}_shape": shape, f"{prefix}_ms": total(rows, 1),
                f"{prefix}_plain_ms": total(rows, 2),
                f"{prefix}_bound_ms": total(rows, 3),
                f"{prefix}_bound_by": rows[0][4],
                f"{prefix}_max_abs_err": max(r[0] for r in rows + worst)}

    return {
        "banded_rel_attention": {
            **rows_entry("long", long1, [2 * n, F, 96], filler),
            **rows_entry("batch_offline", b1, [2 * BATCH_ROWS, 1598, 96],
                         [])},
        "fused_stage": {
            **rows_entry("long", long2, [n, "C", f"{F} x hop"], []),
            **rows_entry("batch_offline", b2,
                         [BATCH_ROWS, "C", "1598 x hop"], [])},
        "fused_resblock": {
            **rows_entry("long", long3, [shapes["rb_rows"], "C",
                                         f"{shapes['rb_frames']} x hop"],
                         []),
            **rows_entry("batch_offline", b3, [
                2, "C", f"{shapes['rb_batch_frames']} x hop"], [])}}


def across_devices(tmp):
    """D1-D3 and the batched offline kernel rows -> (per kernel name: the
    extra keys of the `kernels` line)."""
    from tpu_rvc_torch.core.device import fp32_math

    index = random_index()
    long_counts, long_rb_counts, shapes = long_file(tmp, index)
    batch_counts, batch_rb_counts, shapes["rb_batch_frames"] = \
        batched_utterances(tmp, index)
    conversion_apps(tmp, index)
    with fp32_math():
        extra = batched_offline_kernels(shapes)
    for name, e in extra.items():
        rb = name == "fused_resblock"
        e["long_launches"] = (long_rb_counts if rb else long_counts)[name]
        e["batch_offline_launches"] = (batch_rb_counts if rb
                                       else batch_counts)[name]
    return extra


# ---------------------------------------------------------------------------
# W1-W3: the web app, the realtime app and MCD on the card
# ---------------------------------------------------------------------------

MCD_CARD_VS_CPU_DB = 1e-3   # the port's MCD on the card against the CPU
MCD_LIMIT_DB = 0.1          # card against CPU conversion, float output
MCD_FLOOR = 10 ** (-50 / 20)  # -50 dBFS: benchmarks/mcd_oracle.py's gate
GUI_BLOCKS = 8


def post(base, name, payload):
    """POST /api/<name> -> (status, decoded body or None, wall ms)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"{base}/api/{name}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        code, body = e.code, (json.loads(raw) if raw else None)
    return code, body, (time.perf_counter() - t0) * 1e3


def web_app(tmp, exp):
    """W1: `Api(device="cuda")` behind the app's JSON-over-HTTP server
    (`http_server`, what `serve_http` serves) on 127.0.0.1, an ephemeral
    port, in a thread: infer_convert with pm and the index (within 1 LSB
    of `VC.vc_single` here, 6 K1 and 72 K2 launches), the same through
    `stream_endpoint`'s worker thread, change_voice, ckpt_show,
    hash_similarity, a 404; uvr_convert twice on U1's HP5-style net (one
    load, no launch); stream_endpoint("train_index") on T1's features."""
    import shutil
    from tpu_rvc_torch.apps import web
    from tpu_rvc_torch.ckpt.hash import wave_hash
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline import uvr5
    from tpu_rvc_torch.retrieval.index import FeatureIndex

    t_start = time.perf_counter()
    root = os.path.join(tmp, "web")
    for d in ("weights", "logs", "uvr5", "opt"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    shutil.copy(os.path.join(tmp, "v2_48k.pth"),
                os.path.join(root, "weights", "v2_48k.pth"))
    index = random_index()
    index_path = os.path.join(root, "logs", "added_web.tpuidx.npz")
    index.save(index_path)
    wav = os.path.join(tmp, "voice_10s.wav")
    api = web.Api(weight_root=os.path.join(root, "weights"),
                  index_root=os.path.join(root, "logs"),
                  hubert_path="random", rmvpe_root=tmp,
                  uvr5_root=os.path.join(root, "uvr5"), device="cuda")
    srv = web.http_server(api, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        kw = dict(sid=0, input_audio_path=wav, f0_method="pm",
                  file_index=index_path, index_rate=0.75,
                  model_name="v2_48k.pth")
        out = os.path.join(root, "opt", "infer.wav")
        walls = []
        for i in range(3):   # a warm-up (the model loads), then 2 timed
            reset_launch_counts()
            code, body, ms = post(base, "infer_convert",
                                  dict(kw, output_path=out))
            if code != 200:
                raise AssertionError(f"infer_convert over HTTP: {code} "
                                     f"{body}")
            walls.append(ms)
            counts = dict(launch_counts)
        want = v2_48k_launches()
        if counts != want:
            raise AssertionError(f"launches of an HTTP infer_convert "
                                 f"{counts}, expected {want}")
        got, sr = read_stereo_wav(out)
        got = got[:, 0]
        direct_walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            _, (dsr, direct) = api._vc.vc_single(0, wav, 0, "pm", index, 0.75,
                                                 3, 0, 1.0, 0.33)
            direct_walls.append((time.perf_counter() - t0) * 1e3)
        check_output(direct, expected_len(160000, api._vc.x_pad, 480, 48000),
                     "W1 direct vc_single")
        lsb = int(np.abs(got.astype(np.int64) - direct).max()) \
            if got.shape == direct.shape else None
        if sr != dsr or lsb is None or lsb > 1:
            raise AssertionError(f"HTTP infer_convert against vc_single: "
                                 f"sr {sr}/{dsr}, {got.shape} vs "
                                 f"{direct.shape}, {lsb} LSB")
        # what a request does beside the conversion: the JAX app's Api
        # reloads the voice model and the index file on every request
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api._get_vc("v2_48k.pth")
        torch.cuda.synchronize()
        reload_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        FeatureIndex.load(index_path)
        index_load_ms = (time.perf_counter() - t0) * 1e3
        streamed_out = os.path.join(root, "opt", "streamed.wav")
        reset_launch_counts()
        lines = list(api.stream_endpoint("infer_convert", poll=0.05,
                                         output_path=streamed_out, **kw))
        stream_counts = dict(launch_counts)
        streamed = read_stereo_wav(streamed_out)[0][:, 0]
        stream_lsb = int(np.abs(streamed.astype(np.int64) - direct).max())
        if json.loads(lines[-1])["output"] != streamed_out or \
                stream_lsb > 1 or stream_counts != want:
            raise AssertionError(f"stream_endpoint infer_convert: "
                                 f"{lines[-1][:200]}, {stream_lsb} LSB, "
                                 f"{stream_counts}")
        code, voice_meta, _ = post(base, "change_voice",
                                   {"model_name": "v2_48k.pth"})
        if code != 200 or voice_meta["result"] != {
                "n_spk": api._vc.n_spk, "if_f0": 1, "sr": 48000,
                "info": "random weights", "version": "v2"}:
            raise AssertionError(f"change_voice over HTTP: {voice_meta}")
        code, shown, _ = post(base, "ckpt_show", {"path": os.path.join(
            root, "weights", "v2_48k.pth")})
        if code != 200 or set(shown["result"]) != {
                "config", "f0", "version", "sr", "info"}:
            raise AssertionError(f"ckpt_show over HTTP: {code} {shown}")
        h = wave_hash(np.random.default_rng(5).standard_normal(48000))
        code, sim, _ = post(base, "hash_similarity", {"id_a": h, "id_b": h})
        if code != 200 or not sim["result"]["similarity"] >= 0.999999:
            raise AssertionError(f"hash_similarity over HTTP: {sim}")
        code, missing, _ = post(base, "no_such_endpoint", {})
        if code != 404:
            raise AssertionError(f"an unknown endpoint gave {code}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    # uvr_convert: the separator is loaded once and kept
    hp5 = os.path.join(tmp, "HP5_random.pth")
    song = write_song(tmp, SHORT_S)
    loads = []
    inner = uvr5.load_separator

    def counted(*a, **k):
        loads.append(a[0])
        return inner(*a, **k)

    uvr5.load_separator = counted
    try:
        reset_launch_counts()
        uvr_walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            r = api.uvr_convert(hp5, song,
                                ins_root=os.path.join(root, "ins"),
                                vocal_root=os.path.join(root, "voc"))
            uvr_walls.append((time.perf_counter() - t0) * 1e3)
        uvr_counts = dict(launch_counts)
    finally:
        uvr5.load_separator = inner
    sep = api._uvr[(hp5, 10)]
    if loads != [hp5] or not isinstance(sep, uvr5.DeviceSeparator) or \
            any(uvr_counts.values()):
        raise AssertionError(f"uvr_convert: loads {loads}, separator "
                             f"{type(sep).__name__}, launches {uvr_counts}")
    ins, _ = read_stereo_wav(r["instrument"])
    voc, _ = read_stereo_wav(r["vocal"])
    check_stems(ins, voc, SHORT_S, "W1 uvr_convert")
    lines = list(api.stream_endpoint("train_index", poll=0.05, exp_dir=exp,
                                     version="v2", name="web"))
    rows = json.loads(lines[-1])["rows"]
    if not os.path.exists(os.path.join(exp, "added_web.tpuidx.npz")):
        raise AssertionError(f"train_index wrote no index: {lines[-1]}")
    say("web_app", model="v2/48k random weights", input_s=10.0,
        index_rows=10000, http_infer_ms=walls[1:],
        http_infer_first_ms=walls[0], direct_vc_single_ms=direct_walls,
        model_reload_ms=reload_ms, index_load_ms=index_load_ms,
        http_vs_direct_max_lsb=lsb, stream_endpoint_max_lsb=stream_lsb,
        launches=counts, stream_endpoint_launches=stream_counts,
        uvr_convert_ms=uvr_walls, uvr_loads=len(loads),
        uvr_launches=uvr_counts, uvr_input_s=SHORT_S,
        train_index_rows=rows, seconds=time.perf_counter() - t_start)
    return counts


class _DeterministicEngine:
    """Makes `RealtimeVC` deterministic (no prior or source noise) while
    in effect, for the app's session and the direct one alike."""

    def __enter__(self):
        from tpu_rvc_torch.pipeline import rt

        self.rt, self.inner = rt, rt.RealtimeVC

        class Engine(self.inner):
            def __init__(self, **kw):
                super().__init__(noise_scale=0.0, deterministic=True, **kw)

        rt.RealtimeVC = Engine

    def __exit__(self, *exc):
        self.rt.RealtimeVC = self.inner


def gui_file(tmp):
    """W2: `python -m tpu_rvc_torch.apps.gui --input ... --output ...` as
    `main(argv)` here: 48 kHz, 0.25 s blocks, pm, GUI_BLOCKS blocks, the
    app's defaults otherwise, the settings file in `tmp`; its file against
    the same session fed here block by block (bit for bit, deterministic
    engine); 6 K1 and 72 K2 launches a block; block p50 and p90."""
    import argparse
    import io
    from tpu_rvc_torch.apps import gui
    from tpu_rvc_torch.audio.io import load_wav, save_wav
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts

    t_start = time.perf_counter()
    model = os.path.join(tmp, "v2_48k.pth")
    wav = os.path.join(tmp, "gui_in.wav")
    save_wav(wav, voice(GUI_BLOCKS * 0.25 + 0.1, 21, sr=48000), 48000)
    out = os.path.join(tmp, "gui_out.wav")
    argv = ["--model", model, "--hubert", "random", "--rmvpe-root", tmp,
            "--input", wav, "--output", out, "--samplerate", "48000",
            "--block-time", "0.25", "--f0-method", "pm"]
    printed = io.StringIO()
    saved_env = os.environ.get("TPU_RVC_GUI_CONFIG")
    os.environ["TPU_RVC_GUI_CONFIG"] = os.path.join(tmp, "gui.json")
    try:
        with _DeterministicEngine():
            reset_launch_counts()
            with contextlib.redirect_stdout(printed):
                gui.main(argv)
            counts = dict(launch_counts)
            with open(os.environ["TPU_RVC_GUI_CONFIG"]) as f:
                cfg = json.load(f)
            args = argparse.Namespace(
                model=model, index="", hubert="random", rmvpe_root=tmp,
                samplerate=48000, block_time=0.25,
                crossfade_time=cfg["crossfade_length"],
                extra_time=cfg["extra_time"], f0_method="pm",
                f0_up_key=cfg["pitch"], formant=cfg["formant"],
                index_rate=cfg["index_rate"],
                rms_mix_rate=cfg["rms_mix_rate"], protect=0.33,
                use_pv=cfg["use_pv"], device="cuda")
            sess = gui.build_session(args)
            audio = load_wav(wav)[0]
            bf = sess.block_frame
            direct = [sess.feed(audio[i * bf:(i + 1) * bf])
                      for i in range(GUI_BLOCKS)]
            # run_file again for its block times, unrounded
            with contextlib.redirect_stdout(printed):
                lat = gui.run_file(argparse.Namespace(
                    **vars(args), input=wav, output=out + ".2.wav"))
    finally:
        if saved_env is None:
            os.environ.pop("TPU_RVC_GUI_CONFIG")
        else:
            os.environ["TPU_RVC_GUI_CONFIG"] = saved_env
    check_blocks(direct, bf, "W2 gui run_file")
    written = (np.clip(np.concatenate(direct), -1.0, 1.0)
               * 32767.0).astype(np.int16)
    for path in (out, out + ".2.wav"):
        got, sr = read_stereo_wav(path)
        got = got[:, 0]
        if sr != 48000 or not np.array_equal(got, written):
            raise AssertionError(
                f"gui run_file against its session: sr {sr}, {got.shape} "
                f"vs {written.shape}, max "
                f"{np.abs(got.astype(int) - written).max()}")
    per_block = {k: v / GUI_BLOCKS for k, v in counts.items()}
    want = v2_48k_launches()
    if per_block != want:
        raise AssertionError(f"gui launches a block {per_block}")
    lines = [ln for ln in printed.getvalue().splitlines()
             if ln.startswith("block latency")]
    lat_ms = np.asarray(lat[1:])
    say("gui_file", model="v2/48k random weights", samplerate=48000,
        block_s=0.25, blocks=GUI_BLOCKS, f0_method="pm",
        fused=sess._fused is not None, rms_mix_rate=cfg["rms_mix_rate"],
        app_line=lines[0] if lines else None,
        block_ms_p50=float(np.percentile(lat_ms, 50)),
        block_ms_p90=float(np.percentile(lat_ms, 90)),
        first_block_ms=float(lat[0]), launches_per_block=per_block,
        bit_equal_to_session=True, seconds=time.perf_counter() - t_start)
    return {k: int(v) for k, v in per_block.items()}


def mcd_card(floats):
    """W3: the port's MCD on the card against on the CPU over the float
    outputs (before int16) of phase 5's card-vs-CPU conversions, and the
    card-vs-CPU MCD itself, with a -50 dBFS energy floor."""
    from tpu_rvc_torch.utils.mcd import mcd

    rows = {}
    for method, (gpu, cpu) in floats.items():
        on_card = mcd(gpu, cpu, 48000, energy_floor=MCD_FLOOR, device="cuda")
        on_cpu = mcd(gpu, cpu, 48000, energy_floor=MCD_FLOOR, device="cpu")
        ungated = mcd(gpu, cpu, 48000, device="cuda")
        if not (abs(on_card - on_cpu) <= MCD_CARD_VS_CPU_DB
                and on_card < MCD_LIMIT_DB):
            raise AssertionError(f"MCD {method}: card {on_card} dB, CPU "
                                 f"{on_cpu} dB")
        rows[method] = dict(mcd_db_card=on_card, mcd_db_cpu=on_cpu,
                            card_vs_cpu_db=abs(on_card - on_cpu),
                            mcd_db_ungated=ungated, samples=len(gpu))
    say("mcd_card", energy_floor=MCD_FLOOR, limit_db=MCD_LIMIT_DB, **rows)


# ---------------------------------------------------------------------------
# P1-P2: the rest of the model family, offline and streaming
# ---------------------------------------------------------------------------

FAMILY_KINDS = [(v, sr, f0) for v in ("v1", "v2")
                for sr in (32000, 40000, 48000) for f0 in (True, False)]
# the kind of each version that converts with the index (10k rows of its
# phone width): the upstream WebUI's default v2/40k, and v1/32k
INDEXED = {("v1", 32000, True), ("v2", 40000, True)}


def kind_name(version, sr, use_f0):
    return f"{version}/{sr // 1000}k{'' if use_f0 else ' no f0'}"


def family_model(tmp, version, sr, use_f0):
    """The kind's random-weight full-width `.pth` (written once)."""
    from tpu_rvc_torch.core.config import hparams_for

    path = os.path.join(tmp, f"{version}_{sr // 1000}k"
                             f"{'' if use_f0 else '_nof0'}.pth")
    if not os.path.exists(path):
        write_model(path, hparams_for(version, sr),
                    seed=100 + sr // 1000 + 7 * (version == "v1")
                    + 3 * use_f0, use_f0=use_f0)
    return path


def family_against_cpu(path, version, method, use_f0, hubs, tmp):
    """A deterministic 1 s conversion of the kind on the card and on the
    CPU (x_pad 0.5, no index): relative L2 of the float output before the
    RMS mix and int16, as `against_cpu` reads it."""
    from tpu_rvc_torch.audio.io import load_audio
    from tpu_rvc_torch.models.loader import load_synthesizer
    from tpu_rvc_torch.pipeline.vc import Pipeline

    audio = load_audio(os.path.join(tmp, "voice_1s.wav"), 16000)
    floats = []
    for dev in ("cuda", "cpu"):
        synth, _ = load_synthesizer(path, dev)
        pipe = Pipeline(synth.sr, hubert=hubs[dev], synth=synth,
                        version=version, x_pad=0.5, rmvpe_root=tmp,
                        noise_scale=0.0, deterministic=True, device=dev)
        rows = []
        convert_rows = pipe._convert_rows

        def spy(*args, **kw):   # the synthesizer's float rows
            out = convert_rows(*args, **kw)
            rows.append(out[0].double().cpu().numpy())
            return out

        pipe._convert_rows = spy
        n = pipe.pipeline(0, audio, [0.0, 0.0, 0.0], 0, method, None, 0.0,
                          int(use_f0), 3, 0, 0.25, 0.33).shape[0]
        floats.append(rows[-1][pipe.t_pad_tgt: pipe.t_pad_tgt + n])
    return rel_l2(floats[0], floats[1], f"{version} {method} card vs CPU")


def family_offline(tmp):
    """P1: every kind of {v1, v2} x {32k, 40k, 48k} x {f0, no f0} at full
    width through `VC.get_vc` + a 10 s `vc_single` (one VC a version, so
    each version's HuBERT tap: v1 layer 9 + final_proj, v2 layer 12): pm
    (RMVPE for v1/40k), the index for the INDEXED kinds; length, finite
    int16, 6 K1 and 18 K2 a level, the median wall of 3 after 1 warm-up,
    peak memory; 1 s card against CPU -> launches by kind."""
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.models.hubert import hubert_for_version
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.vc import VC

    t_start = time.perf_counter()
    wav = os.path.join(tmp, "voice_10s.wav")
    launches = {}
    for version in ("v1", "v2"):
        vc = VC(rmvpe_root=tmp, hubert_path="random")
        dim = 256 if version == "v1" else 768
        index = random_index(dim)
        hubs = None
        for v, sr, use_f0 in FAMILY_KINDS:
            if v != version:
                continue
            t0 = time.perf_counter()
            hp = hparams_for(version, sr)
            path = family_model(tmp, version, sr, use_f0)
            vc.get_vc(path)
            if hubs is None:   # the tap one VC keeps, and its CPU twin
                hubs = {"cuda": vc._hubert,
                        "cpu": hubert_for_version(version, "cpu")}
            method = "rmvpe" if (version, sr) == ("v1", 40000) else "pm"
            indexed = (version, sr, use_f0) in INDEXED
            kw = dict(f0_method=method, index=index if indexed else None,
                      index_rate=0.75 if indexed else 0.0)
            n_expected = expected_len(160000, vc.x_pad, hp.data.hop_length,
                                      sr)
            what = kind_name(version, sr, use_f0)
            torch.cuda.reset_peak_memory_stats()
            _, (sr_out, audio) = vc.vc_single(0, wav, **kw)   # warm-up
            check_output(audio, n_expected, f"{what} warm-up")
            walls = []
            for i in range(3):
                reset_launch_counts()
                t1 = time.perf_counter()
                _, (sr_out, audio) = vc.vc_single(0, wav, **kw)
                walls.append((time.perf_counter() - t1) * 1e3)
                counts = dict(launch_counts)
                check_output(audio, n_expected, f"{what} run {i}")
            want = want_launches(hp)
            if sr_out != sr or counts != want or \
                    vc.pipeline.synth.enc_p.emb_phone.in_features != dim:
                raise AssertionError(f"{what}: rate {sr_out}, launches "
                                     f"{counts}, expected {want}")
            peak = torch.cuda.max_memory_allocated() / 1e9
            rel = family_against_cpu(path, version, method, use_f0, hubs,
                                     tmp)
            launches[what] = counts
            say("family_offline", kind=what, f0_method=method if use_f0
                else None, index_rows=10000 if indexed else 0,
                phone_dim=dim, levels=len(hp.model.upsample_rates),
                input_s=10.0, output_samples=int(audio.shape[0]), sr=sr,
                wall_ms=walls, wall_ms_median=float(np.median(walls)),
                launches=counts, peak_mem_gb=peak,
                card_vs_cpu_rel_l2=rel,
                seconds=time.perf_counter() - t0)
        del vc, hubs
        gc.collect()
        torch.cuda.empty_cache()
    phase_seconds("P1", t_start)
    return launches


# the two streaming kinds: v2/40k at 40 kHz with RMVPE, v1/32k (five
# levels, C = 16) at 32 kHz with pm
FAMILY_STREAMS = [("v2", 40000, "rmvpe"), ("v1", 32000, "pm")]


def family_streaming(tmp, n_warm=3, n_timed=10, n_cpu=8):
    """P2: StreamSession at the model's own rate, 0.25 s blocks, fused,
    with the index: block p50/p90/max of n_timed after n_warm, blocks
    over 250 ms (underruns, 0), launches each block; then deterministic,
    n_cpu blocks on the card against the CPU (relative L2 < 1e-3) and
    fused against the host path on the card (1e-4 of full scale)."""
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.rt import StreamSession

    t_start = time.perf_counter()
    launches = {}
    for version, sr, method in FAMILY_STREAMS:
        hp = hparams_for(version, sr)
        path = family_model(tmp, version, sr, True)
        geo = dict(STREAM, samplerate=sr)
        want = want_launches(hp)
        audio = voice((n_warm + n_timed) * 0.25, seed=6, sr=sr)
        index = random_index(256 if version == "v1" else 768)
        sess = StreamSession(stream_engine(path, tmp, "cuda", index,
                                           version), f0method=method,
                             fused=True, **geo)
        feed_blocks(sess, audio, 0, n_warm)
        walls, read = [], []

        def each(i, wall):
            walls.append(wall)
            read.append(dict(launch_counts))
            if read[-1] != want:
                raise AssertionError(f"{version}/{sr} block {i}: launches "
                                     f"{read[-1]}, want {want}")
            reset_launch_counts()

        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        feed_blocks(sess, audio, n_warm, n_timed, each)
        underruns = sum(w > 250.0 for w in walls)
        if underruns:
            raise AssertionError(f"{version}/{sr}: {underruns} blocks over "
                                 f"250 ms: {walls}")
        # deterministic: card against CPU, fused against host path
        audio = voice(n_cpu * 0.25, seed=8, sr=sr)
        outs, margins = {}, []
        for dev, fused in (("cuda", True), ("cuda", False), ("cpu", True)):
            eng = stream_engine(path, tmp, dev, version=version,
                                noise_scale=0.0, deterministic=True)
            s = StreamSession(eng, f0method=method, protect=0.33,
                              fused=fused, **geo)
            watch_sola(s, margins)
            outs[dev, fused] = feed_blocks(s, audio, 0, n_cpu).astype(
                np.float64)
        rel = rel_l2(outs["cuda", True], outs["cpu", True],
                     f"streaming {version}/{sr}")
        host = float(np.abs(outs["cuda", True] - outs["cuda", False]).max())
        if not host <= 1e-4:
            raise AssertionError(f"streaming {version}/{sr}: fused path "
                                 f"differs from host path by {host}")
        what = f"{version}/{sr // 1000}k"
        launches[what] = read[-1]
        say("family_streaming", kind=what, samplerate=sr, f0method=method,
            levels=len(hp.model.upsample_rates), block_s=0.25,
            blocks=n_timed, wall_ms=walls,
            wall_ms_median=float(np.median(walls)),
            wall_ms_p90=float(np.percentile(walls, 90)),
            wall_ms_max=float(np.max(walls)), underruns=underruns,
            launches_per_block=read[-1], window_frames=sess.geometry.total
            // sess.geometry.zc,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            card_vs_cpu_rel_l2=rel, cpu_blocks=n_cpu,
            fused_vs_host_max_abs=host, sola_margin_min=float(min(margins)))
    phase_seconds("P2", t_start)
    return launches


# ---------------------------------------------------------------------------
# phases T6, P3 and P4: the model family in training and serving
# ---------------------------------------------------------------------------

# (version, sr, use_f0, f0 method, the entry point that trains it): v2/40k,
# the upstream WebUI's default, through its one-click path
FAMILY_TRAIN = [("v2", 40000, True, "rmvpe", "train_start_all"),
                ("v1", 32000, True, "pm", "run_training"),
                ("v1", 48000, False, None, "apps.train"),
                ("v2", 32000, False, None, "apps.train")]
FAMILY_EPOCHS = 2


@contextlib.contextmanager
def step_clock(record):
    """Time every `TrainState.train_step` to a synchronize: (the batch's
    spec shape, seconds) appended to `record`."""
    from tpu_rvc_torch.train.step import TrainState

    inner = TrainState.train_step

    def timed(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(self, batch)
        torch.cuda.synchronize()
        record.append((tuple(batch["spec"].shape),
                       time.perf_counter() - t0))
        return out

    TrainState.train_step = timed
    try:
        yield
    finally:
        TrainState.train_step = inner


def family_train_kind(tmp, version, sr, use_f0, method, entry, n_warm=3,
                      n_timed=8):
    """T6 for one kind: T1's 16 voices prepared at the kind's rate and
    trained FAMILY_EPOCHS epochs (a checkpoint each) through `entry`;
    then the last epoch's state: its G against the G_*.pth of that epoch,
    n_warm + n_timed steps timed one by one, no kernel launched; the small
    model through `VC.vc_single` (10 s, 6 K1 and 18 K2 a level) and 1 s
    on the card against the CPU -> the conversion's launches."""
    import shutil
    from tpu_rvc_torch.apps.train import main as train_main
    from tpu_rvc_torch.apps.web import Api
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.models.hubert import hubert_for_version
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.vc import VC
    from tpu_rvc_torch.train.loop import run_training

    t_kind = time.perf_counter()
    hp = hparams_for(version, sr)
    t, dim = hp.train, hp.encoder_dim
    if (t.batch_size, t.fp16_run) != (4, True):
        raise AssertionError(f"{version}/{sr} preset changed: {t}")
    what = kind_name(version, sr, use_f0)
    tag = f"{version}_{sr // 1000}k{'' if use_f0 else '_nof0'}"
    raw = os.path.join(tmp, "train_raw")      # T1's voices at 48 kHz
    exp = os.path.join(tmp, f"family_{tag}")
    logs, record = [], []

    def log(line):
        logs.append(line)
        print(line, flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with step_clock(record):
        if entry == "train_start_all":
            Api(hubert_path="random", rmvpe_root=tmp).train_start_all(
                exp, raw, version, sr, if_f0=int(use_f0), f0_method=method,
                n_p=4, epochs=FAMILY_EPOCHS, batch_size=t.batch_size,
                save_every=1, name=tag, log_fn=log)
        else:
            f0 = ["--if-f0", str(int(use_f0))] + (
                ["--f0-method", method] if use_f0 else [])
            for cmd, args in (
                    ("preprocess", ["--input-dir", raw, "--sr", str(sr),
                                    "--workers", "4"]),
                    ("extract", ["--version", version, "--hubert", "random",
                                 "--rmvpe-root", tmp] + f0),
                    ("index", ["--version", version, "--name", tag])):
                train_main([cmd, "--exp-dir", exp] + args)
            if entry == "run_training":
                run_training(exp, hp, total_epochs=FAMILY_EPOCHS,
                             if_f0=use_f0, save_every_epoch=1, name=tag,
                             log_fn=log, tensorboard=False)
            else:
                train_main(["train", "--exp-dir", exp, "--version", version,
                            "--sr", str(sr), "--if-f0", str(int(use_f0)),
                            "--epochs", str(FAMILY_EPOCHS),
                            "--save-every", "1", "--name", tag])
    train_s = time.perf_counter() - t0
    train_reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    no_launches(f"{what}: preparing and training")
    for f in [f"{tag}.pth", f"added_{tag}.tpuidx.npz"] + [
            f"{k}_{e}.{x}" for e in range(1, FAMILY_EPOCHS + 1)
            for k, x in (("state", "pt"), ("G", "pth"))]:
        if not os.path.exists(os.path.join(exp, f)):
            raise AssertionError(f"{what}: {f} was not written")
    feat_dir = os.path.join(exp, f"3_feature{dim}")
    feats = np.load(os.path.join(feat_dir, sorted(os.listdir(feat_dir))[0]))
    if feats.shape[1] != dim or not np.isfinite(feats).all() or \
            os.path.isdir(os.path.join(exp, "2a_f0")) != use_f0:
        raise AssertionError(f"{what}: features {feats.shape}, f0 dir "
                             f"{os.path.isdir(os.path.join(exp, '2a_f0'))}")
    first_step_s = {}
    for shape, sec in record:
        first_step_s.setdefault("x".join(map(str, shape)), sec)

    # the last epoch's state: its G against that epoch's G_*.pth, then
    # steps timed one by one on it
    state, batcher, rows, spe = trained_state(exp, hp, use_f0,
                                              FAMILY_EPOCHS, what)
    args = infer_args(dim=dim, use_f0=use_f0)
    live = state.net_g.infer(*args, deterministic=True)
    g_err = g_against_pth(hp, use_f0, live, args, os.path.join(
        exp, f"G_{FAMILY_EPOCHS}.pth"), what)
    steps = timed_steps(state, endless(batcher), n_warm, n_timed, what)
    del state, live
    gc.collect()
    torch.cuda.empty_cache()

    # the small model converts through the kernels
    model = os.path.join(exp, f"{tag}.pth")
    convert = method or "pm"
    wav = os.path.join(tmp, "voice_10s.wav")
    vc = VC(rmvpe_root=tmp, hubert_path="random")
    vc.get_vc(model)
    vc.vc_single(0, wav, f0_method=convert)                 # warm-up
    reset_launch_counts()
    t1 = time.perf_counter()
    _, (sr_out, audio) = vc.vc_single(0, wav, f0_method=convert)
    conv_ms = (time.perf_counter() - t1) * 1e3
    counts = dict(launch_counts)
    check_output(audio, expected_len(160000, vc.x_pad, hp.data.hop_length,
                                     sr), f"{what}: the trained model")
    want = want_launches(hp)
    if sr_out != sr or counts != want:
        raise AssertionError(f"{what}: trained model at {sr_out} Hz, "
                             f"launches {counts}, want {want}")
    rel = family_against_cpu(model, version, convert, use_f0,
                             {"cuda": vc._hubert,
                              "cpu": hubert_for_version(version, "cpu")},
                             tmp)
    del vc
    if (version, sr) == ("v1", 32000):
        train_against_cpu(exp, version, sr, phase="family_train_against_cpu")
    shutil.rmtree(exp)
    say("family_train", kind=what, entry=entry, f0_method=method,
        batch=t.batch_size, segment=t.segment_size,
        precision="bf16 autocast, fp32 params", epochs=FAMILY_EPOCHS,
        rows=rows, steps_per_epoch=spe, prepare_and_train_s=train_s,
        steps_in_training=len(record), first_step_s_by_bucket=first_step_s,
        train_peak_reserved_gb=train_reserved_gb, **steps,
        live_g_vs_g_pth_max_abs=g_err, conversion_wall_ms=conv_ms,
        launches=counts, card_vs_cpu_rel_l2=rel,
        seconds=time.perf_counter() - t_kind)
    return counts


def family_training(tmp):
    """T6: the kinds of FAMILY_TRAIN -> the launches of each trained
    model's conversion."""
    t_start = time.perf_counter()
    launches = {kind_name(v, sr, f0): family_train_kind(tmp, v, sr, f0, m, e)
                for v, sr, f0, m, e in FAMILY_TRAIN}
    phase_seconds("T6", t_start)
    return launches


# (kind, f0 method, client rate, slot counts, modes, slots checked
# against their own sessions)
FAMILY_SERVE = [(("v2", 40000, True), "rmvpe", 48000, (1, 4, 8),
                 (False, True), 4),
                (("v1", 32000, True), "pm", 32000, (8,), (False,), 8),
                (("v2", 32000, False), "pm", 48000, (4,), (False,), 4)]


def family_serving(tmp):
    """P3: `SlotScheduler` over random-weight models of other kinds, the
    index of the version's width, 0.25 s blocks (`serving`: 3 warm-up and
    10 timed ticks, launches each tick, busy share, peak memory, no
    underrun), then each stream against its own `StreamSession` on the
    card and two against a scheduler on the CPU
    (`streams_against_sessions`) -> the launches of a tick by kind."""
    t_start = time.perf_counter()
    launches = {}
    for kind, method, rate, slot_counts, modes, n_own in FAMILY_SERVE:
        for n in slot_counts:
            got = serving(tmp, n, n_warm=3, n_timed=10, f0method=method,
                          modes=modes, phase="family_serving", kind=kind,
                          samplerate=rate)
        streams_against_sessions(tmp, n_own, n_blocks=6, n_cpu=2,
                                 f0method=method, fed_and_churn=False,
                                 phase="family_streams_against_sessions",
                                 kind=kind, samplerate=rate)
        launches[kind_name(*kind)] = got
    phase_seconds("P3", t_start)
    return launches


def separated_vocal_into_40k(tmp):
    """P4: the web app's chain from separation to conversion: the port's
    `Api.uvr_convert` of the 30 s 44.1 kHz song with U1's HP5-style net,
    then `Api.infer_convert` of its vocal with P1's v2/40k model (pm),
    against `DeviceSeparator.separate` and `VC.vc_single` called here
    (1 LSB each), the output's length at 40 kHz, 6 K1 and 72 K2 ->
    the conversion's launches."""
    import shutil
    from tpu_rvc_torch.apps.web import Api
    from tpu_rvc_torch.audio.io import load_audio, save_wav
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.ops.kernels import launch_counts, reset_launch_counts
    from tpu_rvc_torch.pipeline.uvr5 import DeviceSeparator, load_separator
    from tpu_rvc_torch.pipeline.vc import VC

    t_start = time.perf_counter()
    hp = hparams_for("v2", 40000)
    weights = os.path.join(tmp, "p4_weights")
    os.makedirs(weights, exist_ok=True)
    model = family_model(tmp, "v2", 40000, True)
    shutil.copy(model, os.path.join(weights, "v2_40k.pth"))
    sep_model = os.path.join(tmp, "HP5_random.pth")
    song30 = write_song(tmp, SONG_S)
    out = os.path.join(tmp, "p4")
    api = Api(weight_root=weights, hubert_path="random", rmvpe_root=tmp)
    t0 = time.perf_counter()
    stems = api.uvr_convert(sep_model, song30, ins_root=out,
                            vocal_root=out)
    sep_ms = (time.perf_counter() - t0) * 1e3
    reset_launch_counts()
    t0 = time.perf_counter()
    conv = api.infer_convert(0, stems["vocal"], f0_method="pm",
                             model_name="v2_40k.pth",
                             output_path=os.path.join(out, "converted.wav"))
    conv_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(launch_counts)
    want = want_launches(hp)
    if counts != want or conv["sr"] != 40000:
        raise AssertionError(f"P4: launches {counts}, want {want}; rate "
                             f"{conv['sr']}")

    # the same through the library, called here
    _, voc, voc_sr = DeviceSeparator(load_separator(sep_model)).separate(
        song30)
    direct_vocal = os.path.join(tmp, "p4_vocal_direct.wav")
    save_wav(direct_vocal, voc, voc_sr)
    vocal_lsb = int16_lsb(read_stereo_wav(stems["vocal"])[0],
                          read_stereo_wav(direct_vocal)[0], "P4 vocal", 1)
    vc = VC(rmvpe_root=tmp, hubert_path="random")
    vc.get_vc(model)
    _, (_, direct) = vc.vc_single(0, direct_vocal, 0, "pm", None, 0.66, 3,
                                  0, 1.0, 0.33)
    got = read_stereo_wav(conv["output"])[0][:, 0]
    n16 = load_audio(stems["vocal"], 16000).shape[0]
    check_output(got, expected_len(n16, vc.x_pad, hp.data.hop_length,
                                   40000), "P4 conversion")
    conv_lsb = int16_lsb(got, direct, "P4 conversion", 1)
    say("separated_vocal_into_40k", song_s=SONG_S, separator="HP5-style",
        model="v2/40k random weights", f0_method="pm",
        uvr_convert_ms=sep_ms, infer_convert_ms=conv_ms, vocal_sr=voc_sr,
        vocal_vs_direct_lsb=vocal_lsb, output_samples=int(got.shape[0]),
        sr=conv["sr"], conversion_vs_direct_lsb=conv_lsb, launches=counts)
    phase_seconds("P4", t_start)
    return counts


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
        write_rmvpe(tmp, seed=9)
        main_counts = end_to_end(tmp, "pm", "end_to_end", count=True)
        rb_counts = single_resblock_path(tmp)
        against_cpu_floats = against_cpu(tmp, count=True)
        rmvpe_counts = end_to_end(tmp, "rmvpe", "end_to_end_rmvpe",
                                  count=True)
        if rmvpe_counts != main_counts:
            raise AssertionError(f"launches with rmvpe {rmvpe_counts}")
        stream_counts = streaming(tmp, count=True)
        stream_rb_counts = streaming_single_resblock(tmp)
        streaming_against_cpu(tmp, n_blocks=6)
        serve_counts = serving(tmp, BATCH_N, n_warm=3, n_timed=10,
                               count=True)
        for n in (1, 4):
            if serving(tmp, n, n_warm=3, n_timed=5) != serve_counts:
                raise AssertionError(f"launches a tick differ at N={n}")
        serve_rb_counts = serving_single_resblock(tmp)
        pipelined_exact(tmp)
        streams_against_sessions(tmp, n_blocks=6)
        noise_reduction(tmp)
        tcp_loopback(tmp)
        exp = train_prepare(tmp)
        model, train_counts = train_full_width(tmp, exp)
        train_against_cpu(exp)
        dp_counts = data_parallel_training(tmp, exp)
        trained_counts = trained_model_converts(tmp, model)
        family_train_counts = family_training(tmp)
        with contextlib.chdir(tmp):   # FCPE finds assets/fcpe/fcpe.pt here
            fcpe_counts = fcpe_phases(tmp, main_counts)
        host_f0_counts = host_f0_conversions(tmp)
        onnx_conversion(tmp)
        pt2_on_card(tmp)
        g_path = max((os.path.join(exp, f) for f in os.listdir(exp)
                      if f.startswith("G_") and f.endswith(".pth")),
                     key=os.path.getmtime)
        tools_counts = checkpoint_tools(tmp, g_path)
        uvr5_counts = separation_phases(tmp)
        device_rows = across_devices(tmp)
        web_counts = web_app(tmp, exp)
        gui_counts = gui_file(tmp)
        mcd_card(against_cpu_floats)
        family_counts = family_offline(tmp)
        family_stream_counts = family_streaming(tmp)
        family_serve_counts = family_serving(tmp)
        uvr_40k_counts = separated_vocal_into_40k(tmp)
    roofline_summary()
    for e in entries:
        rb = e["name"] == "fused_resblock"
        e["launches"] = (rb_counts if rb else main_counts)[e["name"]]
        e["stream_launches"] = (stream_rb_counts if rb
                                else stream_counts)[e["name"]]
        e["batch_launches"] = (serve_rb_counts if rb
                               else serve_counts)[e["name"]]
        e["train_launches"] = train_counts[e["name"]]
        e["dp_train_launches"] = dp_counts[e["name"]]
        e["trained_model_launches"] = trained_counts[e["name"]]
        (e["fcpe_launches"], e["fcpe_stream_launches"],
         e["fcpe_batch_launches"]) = (c[e["name"]] for c in fcpe_counts)
        e["host_f0_launches"] = host_f0_counts[e["name"]]
        e["merged_model_launches"] = tools_counts[e["name"]]
        e["uvr5_launches"] = sum(c[e["name"]] for c in uvr5_counts)
        e.update(device_rows[e["name"]])
        e["web_launches"] = web_counts[e["name"]]
        e["gui_launches"] = gui_counts[e["name"]]
        e["family_launches"] = {k: c[e["name"]]
                                for k, c in family_counts.items()}
        e["family_stream_launches"] = {
            k: c[e["name"]] for k, c in family_stream_counts.items()}
        e["family_trained_model_launches"] = {
            k: c[e["name"]] for k, c in family_train_counts.items()}
        e["family_tick_launches"] = {
            k: c[e["name"]] for k, c in family_serve_counts.items()}
        e["uvr_into_40k_launches"] = uvr_40k_counts[e["name"]]
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
