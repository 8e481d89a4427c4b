"""Convert audio through exported ONNX graphs (port of
apps/cli/onnx_infer.py; reference tools/cmd/onnx and rvc/onnx/infer.py):
a synthesizer `.onnx` (`model_tools export-onnx`) and a ContentVec `.onnx`
(`tpu_rvc_torch.ckpt.torch2onnx.export_hubert_onnx`).

    python -m tpu_rvc_torch.apps.onnx_infer --model m.onnx --vec v.onnx \\
        --input in.wav --output out.wav --sr 48000 --hop 480

The graphs run on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_rvc_torch.apps.onnx_infer")
    p.add_argument("--model", required=True, help="synthesizer .onnx")
    p.add_argument("--vec", default="", help="ContentVec/HuBERT .onnx")
    p.add_argument("--input", required=True)
    p.add_argument("--output", default="onnx_out.wav")
    p.add_argument("--sid", type=int, default=0)
    p.add_argument("--f0-method", default="dio")
    p.add_argument("--f0-up-key", type=int, default=0)
    p.add_argument("--hop", type=int, default=512)
    p.add_argument("--sr", type=int, default=40000,
                   help="model output sample rate")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from tpu_rvc_torch.audio.io import load_audio, save_wav
    from tpu_rvc_torch.pipeline.onnx_infer import OnnxRVC

    wav = load_audio(args.input, args.sr)
    rvc = OnnxRVC(args.model, hop_len=args.hop, model_sr=args.sr,
                  vec_path=args.vec or None, device=args.device)
    out = rvc.infer(wav, args.sr, sid=args.sid, f0_method=args.f0_method,
                    f0_up_key=args.f0_up_key)
    save_wav(args.output, out, args.sr)
    print(f"wrote {args.output} ({len(out) / args.sr:.2f}s)")


if __name__ == "__main__":
    main()
