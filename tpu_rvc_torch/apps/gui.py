"""The realtime voice changer app (port of apps/gui.py; reference gui.py
role).

Modes:
  --input/--output FILE : stream a file through the realtime engine block
                          by block (the live path's DSP: rolling windows,
                          SOLA, crossfade) and write the result; also the
                          reproducible latency harness (prints the block
                          p50 and p90).
  --live                : duplex audio devices through sounddevice when it
                          is installed, the device callback coupled to the
                          model loop by `LiveLoop`'s ring buffers.
  --list-devices        : list the audio devices (reference gui.py:252-294).

    python -m tpu_rvc_torch.apps.gui --model m.pth --input in.wav \\
        --output out.wav [--hubert random] [--device cpu]

Settings persist across sessions in a JSON file (reference
gui.py:176-247,650-651 configs/inuse/config.json): `TPU_RVC_GUI_CONFIG`,
else configs/inuse/gui.json at the root of the checkout, in the JAX app's
`LiveConfig` format.  They are the flags' defaults and are saved on every
run.  In live and file modes a control thread reads commands from stdin
and applies them mid-stream, the role of the reference GUI's sliders
(gui.py:518-592):

    key <semitones> | formant <shift> | index <rate> | rms <rate> | quit

The engine runs on `--device`, the card unless another is named.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np

# anchored at the checkout's root, not the working directory, so that the
# persisted settings round-trip wherever the app starts
CONFIG_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "..", "configs", "inuse", "gui.json")


def config_path() -> str:
    """The settings file: `TPU_RVC_GUI_CONFIG` when set, else CONFIG_PATH."""
    return os.environ.get("TPU_RVC_GUI_CONFIG", CONFIG_PATH)


def build_session(args, device=None):
    """A `StreamSession` over a `RealtimeVC` on `device` (default
    `args.device`, else the card) from the app's arguments."""
    from tpu_rvc_torch.core.device import resolve_device
    from tpu_rvc_torch.models.loader import load_synthesizer
    from tpu_rvc_torch.pipeline.rt import RealtimeVC, StreamSession
    from tpu_rvc_torch.retrieval.index import FeatureIndex

    device = resolve_device(device if device is not None
                            else getattr(args, "device", None))
    synth, meta = load_synthesizer(args.model, device)
    version = meta.get("version", "v2")
    if args.hubert == "random":
        from tpu_rvc_torch.models.hubert import hubert_for_version
        hub = hubert_for_version(version, device)
    else:
        from tpu_rvc_torch.ckpt.hubert_loader import load_hubert_base
        hub = load_hubert_base(args.hubert, version, device)
    index = FeatureIndex.load(args.index) if args.index else None
    engine = RealtimeVC(
        hubert=hub, synth=synth, version=version,
        if_f0=int(meta.get("f0", 1)), index=index,
        index_rate=args.index_rate, f0_up_key=args.f0_up_key,
        formant_shift=args.formant, rmvpe_root=args.rmvpe_root,
        device=device)
    return StreamSession(
        engine, samplerate=args.samplerate, block_time=args.block_time,
        crossfade_time=args.crossfade_time, extra_time=args.extra_time,
        f0method=args.f0_method, rms_mix_rate=args.rms_mix_rate,
        protect=args.protect, use_phase_vocoder=args.use_pv)


def control_thread(target, stop_event):
    """Read live-control commands from stdin and apply them to `target`
    mid-stream (the reference GUI's slider events, gui.py:518-592)."""
    print("controls: key <n> | formant <f> | index <r> | rms <r> | quit")
    try:
        for line in sys.stdin:
            parts = line.split()
            if not parts:
                continue
            cmd, val = parts[0], (float(parts[1]) if len(parts) > 1 else 0.0)
            if cmd == "key":
                target.set_key(val)
            elif cmd == "formant":
                target.set_formant(val)
            elif cmd == "index":
                target.set_index_rate(val)
            elif cmd == "rms":
                target.set_rms_mix_rate(val)
            elif cmd in ("quit", "exit", "stop"):
                stop_event.set()
                return
            else:
                print(f"unknown command {cmd}")
    except (OSError, ValueError):  # a captured or closed stdin
        return


def run_file(args):
    """Stream `args.input` through the session block by block into
    `args.output`; returns the block latencies in ms (the first block,
    which also builds the graphs, is left out of the p50 and p90)."""
    from tpu_rvc_torch.audio.io import load_audio, save_wav

    sess = build_session(args)
    audio = load_audio(args.input, args.samplerate)
    bf = sess.block_frame
    n_blocks = len(audio) // bf
    # the stdin control surface of live mode: a daemon reader applies
    # key/formant/index/rms mid-stream; 'quit' stops after the block
    stop = threading.Event()
    threading.Thread(target=control_thread, args=(sess, stop),
                     daemon=True).start()
    outs, lat = [], []
    for i in range(n_blocks):
        if stop.is_set():
            n_blocks = i
            break
        t0 = time.perf_counter()
        outs.append(sess.feed(audio[i * bf:(i + 1) * bf]))
        lat.append(time.perf_counter() - t0)
    out = np.concatenate(outs) if outs else np.zeros(0, np.float32)
    save_wav(args.output, out, args.samplerate)
    lat_ms = np.asarray(lat[1:]) * 1000
    budget = args.block_time * 1000
    print(f"wrote {args.output}: {len(out) / args.samplerate:.2f}s, "
          f"{n_blocks} blocks")
    if len(lat_ms):
        print(f"block latency p50={np.percentile(lat_ms, 50):.1f}ms "
              f"p90={np.percentile(lat_ms, 90):.1f}ms "
              f"(budget {budget:.0f}ms, realtime: "
              f"{'YES' if np.percentile(lat_ms, 50) < budget else 'NO'})")
    return np.asarray(lat) * 1000


def run_live(args):  # pragma: no cover - needs audio hardware
    try:
        import sounddevice as sd
    except ImportError:
        print("live mode requires the sounddevice package (PortAudio); "
              "use --input/--output for file streaming")
        sys.exit(1)
    from tpu_rvc_torch.pipeline.live import LiveLoop

    sess = build_session(args)
    loop = LiveLoop(sess, threshold_db=args.threshold)
    stop = threading.Event()
    threading.Thread(target=control_thread, args=(loop, stop),
                     daemon=True).start()
    kw = {}
    if args.input_device:
        kw["device"] = (args.input_device, args.output_device
                        or args.input_device)
    with sd.Stream(samplerate=args.samplerate, blocksize=loop.block_frame,
                   channels=1, callback=loop.callback, **kw):
        delay = args.block_time + args.crossfade_time + 0.01
        print(f"live voice changer running; algorithmic delay ~{delay:.2f}s")
        try:
            loop.run(stop)
        except KeyboardInterrupt:
            pass
    print("stats:", loop.stats())


def main(argv=None):
    from tpu_rvc_torch.pipeline.live import LiveConfig, list_audio_devices

    path = config_path()
    cfg = LiveConfig.load(path)
    p = argparse.ArgumentParser(prog="python -m tpu_rvc_torch.apps.gui",
                                description="tpu_rvc_torch realtime voice "
                                            "changer")
    p.add_argument("--model", default=cfg.pth_path)
    p.add_argument("--index", default=cfg.index_path)
    p.add_argument("--hubert", default="assets/hubert/hubert_base.pt",
                   help="fairseq hubert_base.pt, or 'random' for HuBERT-base "
                        "drawn from a seed")
    p.add_argument("--rmvpe-root", default="assets/rmvpe")
    p.add_argument("--input", help="input file (file mode)")
    p.add_argument("--output", default="rt_out.wav")
    p.add_argument("--live", action="store_true")
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--input-device", default=cfg.sg_input_device)
    p.add_argument("--output-device", default=cfg.sg_output_device)
    p.add_argument("--samplerate", type=int, default=cfg.samplerate)
    p.add_argument("--block-time", type=float, default=cfg.block_time)
    p.add_argument("--crossfade-time", type=float,
                   default=cfg.crossfade_length)
    p.add_argument("--extra-time", type=float, default=cfg.extra_time)
    p.add_argument("--threshold", type=float, default=cfg.threhold,
                   help="input dB gate")
    p.add_argument("--f0-method", default=cfg.f0method)
    p.add_argument("--f0-up-key", type=float, default=cfg.pitch)
    p.add_argument("--formant", type=float, default=cfg.formant)
    p.add_argument("--index-rate", type=float, default=cfg.index_rate)
    p.add_argument("--rms-mix-rate", type=float, default=cfg.rms_mix_rate)
    p.add_argument("--protect", type=float, default=0.33)
    p.add_argument("--use-pv", action=argparse.BooleanOptionalAction,
                   default=cfg.use_pv,
                   help="phase vocoder crossfade instead of linear "
                        "(--no-use-pv turns a persisted setting off)")
    p.add_argument("--no-save-config", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    if args.list_devices:
        devs = list_audio_devices()
        for kind in ("hostapis", "input", "output"):
            print(f"{kind}:")
            for n in devs[kind]:
                print(f"  {n}")
        return

    if not args.no_save_config:
        # persist the effective settings (reference gui.py:650-651)
        cfg = LiveConfig(
            pth_path=args.model or "", index_path=args.index or "",
            sg_input_device=args.input_device or "",
            sg_output_device=args.output_device or "",
            threhold=args.threshold, pitch=args.f0_up_key,
            formant=args.formant, index_rate=args.index_rate,
            rms_mix_rate=args.rms_mix_rate, block_time=args.block_time,
            crossfade_length=args.crossfade_time, extra_time=args.extra_time,
            f0method=args.f0_method, use_pv=args.use_pv,
            samplerate=args.samplerate)
        cfg.save(path)

    if not args.model:
        p.error("need --model (or a persisted pth_path in the config)")
    if args.live:
        run_live(args)
    elif args.input:
        run_file(args)
    else:
        p.error("need --input FILE, --live, or --list-devices")


if __name__ == "__main__":
    main()
