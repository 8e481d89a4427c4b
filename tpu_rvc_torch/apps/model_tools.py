"""Model management CLI (port of apps/cli/model_tools.py; reference WebUI
ckpt tab, web.py:1405-1536, and tools/cmd/calc_rvc_model_similarity.py).

    python -m tpu_rvc_torch.apps.model_tools info m.pth
    python -m tpu_rvc_torch.apps.model_tools merge a.pth b.pth --alpha 0.3
    python -m tpu_rvc_torch.apps.model_tools extract G_20.pth --sr 48k
    python -m tpu_rvc_torch.apps.model_tools change-info m.pth --info text
    python -m tpu_rvc_torch.apps.model_tools strip G_20.pth out.pth
    python -m tpu_rvc_torch.apps.model_tools similarity a.pth b.pth
    python -m tpu_rvc_torch.apps.model_tools export-onnx m.pth m.onnx

The subcommands and flags are the JAX tool's; export-onnx adds `--device`
(the model is traced on the card unless `--device cpu` is given).
"""

from __future__ import annotations

import argparse

import torch


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def cmd_info(args):
    cpt = _load(args.model)
    for k in ("name", "info", "sr", "f0", "version", "author", "timestamp",
              "id"):
        if k in cpt:
            print(f"{k}: {cpt[k]}")
    if "config" in cpt:
        print("config:", cpt["config"])
    if "weight" in cpt:
        n = sum(v.numel() for v in cpt["weight"].values())
        print(f"weights: {len(cpt['weight'])} tensors, {n / 1e6:.1f}M params")


def cmd_merge(args):
    from tpu_rvc_torch.ckpt.small_model import merge
    out = merge(args.a, args.b, args.alpha, args.sr, args.f0, args.info,
                args.name, args.version, out_path=args.output)
    print("merged ->", out)


def cmd_extract(args):
    from tpu_rvc_torch.ckpt.small_model import extract_small_model
    from tpu_rvc_torch.core.config import hparams_for
    hp = hparams_for(args.version, {"32k": 32000, "40k": 40000,
                                    "48k": 48000}[args.sr])
    out = extract_small_model(args.ckpt, args.name, args.sr, args.f0,
                              args.info, args.version, hp,
                              out_path=args.output)
    print("extracted ->", out)


def cmd_change_info(args):
    from tpu_rvc_torch.ckpt.small_model import change_info
    out = change_info(args.model, args.info, args.name, out_dir=args.out_dir)
    print("updated ->", out)


def cmd_export_onnx(args):
    from tpu_rvc_torch.ckpt.export import export_onnx
    export_onnx(args.model, args.output, T=args.frames, spk_mix=args.spk_mix,
                reference_layout=args.reference_layout, device=args.device)
    print("exported ->", args.output)


def cmd_strip(args):
    """A training checkpoint -> fp16 weights only (the role of the
    reference's legacy tools/cmd/trans_weights.py)."""
    cpt = _load(args.ckpt)
    sd = cpt.get("model", cpt.get("weight", cpt))
    half = {k: torch.as_tensor(v).half() for k, v in sd.items()}
    torch.save(half, args.output)
    print(f"stripped {len(half)} tensors ->", args.output)


def cmd_similarity(args):
    from tpu_rvc_torch.ckpt.hash import hash_similarity
    h1, h2 = _load(args.a).get("hash"), _load(args.b).get("hash")
    if not h1 or not h2:
        print("one of the models carries no hash; run hashing first")
        return
    print(f"similarity: {hash_similarity(h1, h2)}")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m tpu_rvc_torch.apps.model_tools",
        description="tpu_rvc_torch model tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    si = sub.add_parser("info")
    si.add_argument("model")
    si.set_defaults(fn=cmd_info)

    sm = sub.add_parser("merge")
    sm.add_argument("a")
    sm.add_argument("b")
    sm.add_argument("--alpha", type=float, default=0.5)
    sm.add_argument("--sr", default="40k")
    sm.add_argument("--f0", type=int, default=1)
    sm.add_argument("--info", default="")
    sm.add_argument("--name", default="merged")
    sm.add_argument("--version", default="v2")
    sm.add_argument("--output", default=None)
    sm.set_defaults(fn=cmd_merge)

    se = sub.add_parser("extract")
    se.add_argument("ckpt")
    se.add_argument("--name", default="extracted")
    se.add_argument("--sr", default="40k")
    se.add_argument("--f0", type=int, default=1)
    se.add_argument("--info", default="")
    se.add_argument("--version", default="v2")
    se.add_argument("--output", default=None)
    se.set_defaults(fn=cmd_extract)

    sc = sub.add_parser("change-info")
    sc.add_argument("model")
    sc.add_argument("--info", default="")
    sc.add_argument("--name", default="")
    sc.add_argument("--out-dir", default=".")
    sc.set_defaults(fn=cmd_change_info)

    st = sub.add_parser("strip", help="training ckpt -> fp16 weights-only "
                        ".pth (legacy tools/cmd/trans_weights.py role)")
    st.add_argument("ckpt")
    st.add_argument("output")
    st.set_defaults(fn=cmd_strip)

    ss = sub.add_parser("similarity")
    ss.add_argument("a")
    ss.add_argument("b")
    ss.set_defaults(fn=cmd_similarity)

    so = sub.add_parser("export-onnx", help="export a small model to ONNX "
                        "(reference web.py:1519 export_onnx)")
    so.add_argument("model")
    so.add_argument("output")
    so.add_argument("--frames", type=int, default=200,
                    help="static frame count of the exported graph")
    so.add_argument("--spk-mix", action="store_true",
                    help="speaker-mix variant: ds becomes per-frame float "
                         "mixing weights (reference spkmixmap, "
                         "rvc/onnx/synthesizer.py:60)")
    so.add_argument("--reference-layout", action="store_true",
                    help="the torch exporter's layouts (rnd (1, 192, T), "
                         "audio (1, 1, samples)) and dynamic-axis "
                         "annotations (rvc/onnx/exporter.py:6-51)")
    so.add_argument("--device", default="cuda",
                    help="torch device to trace on (default: cuda)")
    so.set_defaults(fn=cmd_export_onnx)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
