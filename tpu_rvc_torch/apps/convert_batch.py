"""Folder conversion (port of apps/cli/convert_batch.py; reference
tools/cmd/infer_batch_rvc.py).

    python -m tpu_rvc_torch.apps.convert_batch --input-dir in/ \\
        --output-dir out/ --model voice.pth [--index voice.tpuidx.npz]

Converts every file of the input folder, in name order, into
`<output-dir>/<name>.wav` and prints one line a file, a failure included.
Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m tpu_rvc_torch.apps.convert_batch",
        description="tpu_rvc_torch batch conversion")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--index", default="")
    p.add_argument("--hubert", default="assets/hubert/hubert_base.pt")
    p.add_argument("--rmvpe-root", default="assets/rmvpe")
    p.add_argument("--sid", type=int, default=0)
    p.add_argument("--f0-up-key", type=int, default=0)
    p.add_argument("--f0-method", default="rmvpe")
    p.add_argument("--index-rate", type=float, default=0.66)
    p.add_argument("--filter-radius", type=int, default=3)
    p.add_argument("--resample-sr", type=int, default=0)
    p.add_argument("--rms-mix-rate", type=float, default=1.0)
    p.add_argument("--protect", type=float, default=0.33)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from tpu_rvc_torch.pipeline.vc import VC
    from tpu_rvc_torch.retrieval.index import FeatureIndex

    vc = VC(rmvpe_root=args.rmvpe_root, hubert_path=args.hubert,
            device=args.device)
    vc.get_vc(args.model)
    index = FeatureIndex.load(args.index) if args.index else None
    paths = [os.path.join(args.input_dir, n)
             for n in sorted(os.listdir(args.input_dir))]
    report = vc.vc_multi(
        args.sid, paths, args.output_dir, f0_up_key=args.f0_up_key,
        f0_method=args.f0_method, index=index, index_rate=args.index_rate,
        filter_radius=args.filter_radius, resample_sr=args.resample_sr,
        rms_mix_rate=args.rms_mix_rate, protect=args.protect)
    print(report)


if __name__ == "__main__":
    main()
