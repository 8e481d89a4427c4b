"""Vocal/instrument separation (port of apps/cli/separate.py; reference
infer/modules/uvr5/modules.py `uvr` without the web UI).

    python -m tpu_rvc_torch.apps.separate --model HP5.pth --input song.wav \\
        --vocal-dir opt/voc --ins-dir opt/ins --agg 10

Writes `vocal_<name>.wav` and `instrument_<name>.wav` for each input and
prints one line a file, its failure included, then goes on to the next
file.  Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import traceback


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_rvc_torch.apps.separate")
    p.add_argument("--model", required=True,
                   help=".pth VR checkpoint (HP2/HP3/HP5/DeEcho/DeReverb) "
                        "or onnx_dereverb_By_FoxJoy directory")
    p.add_argument("--input", action="append", default=[],
                   help="input audio file (repeatable)")
    p.add_argument("--input-dir", default="",
                   help="directory of input files (reference inp_root)")
    p.add_argument("--vocal-dir", default="opt_vocal")
    p.add_argument("--ins-dir", default="opt_ins")
    p.add_argument("--agg", type=float, default=10.0,
                   help="vocal aggressiveness 0..20")
    p.add_argument("--tta", action="store_true")
    p.add_argument("--engine", choices=["auto", "device", "host"],
                   default="auto",
                   help="'device': the whole separation on the device; "
                        "'host': band pyramid on the host, each window on "
                        "the device; auto: 'device' on a CUDA device, "
                        "'host' otherwise")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    paths = list(args.input)
    if args.input_dir:
        paths += [os.path.join(args.input_dir, n)
                  for n in sorted(os.listdir(args.input_dir))]
    if not paths:
        p.error("give --input and/or --input-dir")

    import torch

    from tpu_rvc_torch.audio.io import save_wav
    from tpu_rvc_torch.pipeline.uvr5 import DeviceSeparator, load_separator

    sep = load_separator(args.model, agg=args.agg, tta=args.tta,
                         device=args.device)
    runner = sep
    if not hasattr(sep, "_path_audio_"):
        use_device = (args.engine == "device" or args.engine == "auto"
                      and torch.device(args.device).type == "cuda")
        if use_device:
            runner = DeviceSeparator(sep)
    os.makedirs(args.vocal_dir, exist_ok=True)
    os.makedirs(args.ins_dir, exist_ok=True)
    for path in paths:
        name = os.path.basename(path)
        try:
            if hasattr(sep, "_path_audio_"):  # MDXNetDereverb
                sep._path_audio_(path, args.vocal_dir, args.ins_dir)
            else:
                ins, voc, sr = runner.separate(path)
                save_wav(os.path.join(args.ins_dir,
                                      f"instrument_{name}.wav"), ins, sr)
                save_wav(os.path.join(args.vocal_dir, f"vocal_{name}.wav"),
                         voc, sr)
            print(f"{name} -> Success")
        except Exception as e:  # a batch goes on (reference yields infos)
            traceback.print_exc()
            print(f"{name} -> {type(e).__name__}: {e}")


if __name__ == "__main__":
    main()
