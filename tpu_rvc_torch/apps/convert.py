"""Single-file conversion (port of apps/cli/convert.py; reference
tools/cmd/infer_cli.py:20-62).

    python -m tpu_rvc_torch.apps.convert --input in.wav --output out.wav \\
        --model assets/weights/voice.pth --index voice.tpuidx.npz \\
        --f0-up-key 0 --f0-method rmvpe --index-rate 0.75 [--chunk-parallel]

Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_rvc_torch.apps.convert",
                                description="tpu_rvc_torch voice conversion")
    p.add_argument("--input", required=True, help="input audio file")
    p.add_argument("--output", required=True, help="output wav path")
    p.add_argument("--model", required=True, help="RVC small model .pth")
    p.add_argument("--index", default="", help="feature index (.npz or .npy)")
    p.add_argument("--hubert", default="assets/hubert/hubert_base.pt",
                   help="fairseq hubert_base.pt, or 'random' for HuBERT-base "
                        "drawn from a seed")
    p.add_argument("--rmvpe-root", default="assets/rmvpe")
    p.add_argument("--sid", type=int, default=0, help="speaker id")
    p.add_argument("--f0-up-key", type=int, default=0,
                   help="transpose in semitones")
    p.add_argument("--f0-method", default="rmvpe",
                   choices=["pm", "dio", "harvest", "crepe", "rmvpe", "fcpe"])
    p.add_argument("--f0-file", default="", help="manual f0 curve file")
    p.add_argument("--index-rate", type=float, default=0.66)
    p.add_argument("--filter-radius", type=int, default=3)
    p.add_argument("--resample-sr", type=int, default=0)
    p.add_argument("--rms-mix-rate", type=float, default=1.0)
    p.add_argument("--protect", type=float, default=0.33)
    p.add_argument("--fp32", action="store_true",
                   help="accepted for the JAX CLI's sake: inference here is "
                        "fp32 whatever is asked")
    p.add_argument("--chunk-parallel", action="store_true",
                   help="convert a long file's chunks as rows of one batch "
                        "over every visible card")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    import numpy as np

    from tpu_rvc_torch.audio.io import save_wav
    from tpu_rvc_torch.pipeline.vc import VC
    from tpu_rvc_torch.retrieval.index import FeatureIndex

    vc = VC(rmvpe_root=args.rmvpe_root, hubert_path=args.hubert,
            device=args.device)
    vc.get_vc(args.model)
    print(f"loaded {args.model}: sr={vc.tgt_sr}, version={vc.version}, "
          f"f0={vc.if_f0}, speakers={vc.n_spk}")
    index = None
    if args.index and os.path.exists(args.index):
        index = FeatureIndex.load(args.index)
        print(f"index: {index.vectors.shape[0]} x {index.dim}")

    f0_file = None
    if args.f0_file and os.path.exists(args.f0_file):
        with open(args.f0_file) as f:
            rows = [line.split(",") for line in f.read().strip().split("\n")]
        f0_file = np.asarray([[float(x) for x in r] for r in rows],
                             np.float32)

    info, (sr, audio) = vc.vc_single(
        args.sid, args.input, args.f0_up_key, args.f0_method, index,
        args.index_rate, args.filter_radius, args.resample_sr,
        args.rms_mix_rate, args.protect, f0_file,
        chunk_parallel=args.chunk_parallel)
    save_wav(args.output, audio, sr)
    print(f"{info}\nwrote {args.output} ({len(audio) / sr:.2f}s @ {sr} Hz)")


if __name__ == "__main__":
    main()
