"""Training CLI: preprocess -> extract -> index -> train (port of
apps/cli/train.py; reference infer/modules/train/{preprocess,
extract_f0_print,extract_feature_print,train}.py).

    python -m tpu_rvc_torch.apps.train preprocess --input-dir raw --exp-dir e
    python -m tpu_rvc_torch.apps.train extract --exp-dir e --hubert random
    python -m tpu_rvc_torch.apps.train index --exp-dir e
    python -m tpu_rvc_torch.apps.train train --exp-dir e --epochs 20

Every step that computes runs on the card unless `--device cpu` is given.
Data-parallel training, one process a card (`parallel/multihost.py`):

    torchrun --nproc-per-node N -m tpu_rvc_torch.apps.train train \
        --multihost --exp-dir e ...

or in every process `train --coordinator <host0>:<port> --num-processes N
--process-id $i ...`.  The processes join over NCCL (gloo with `--device
cpu`) before the first use of the card, each on its own card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def cmd_preprocess(args):
    from tpu_rvc_torch.train.preprocess import preprocess_dataset
    preprocess_dataset(args.input_dir, args.sr, args.workers, args.exp_dir,
                       per=args.per)
    print("preprocess done:", args.exp_dir)


def cmd_extract(args):
    from tpu_rvc_torch.train.extract import extract_f0, extract_features
    if args.if_f0:
        for line in extract_f0(args.exp_dir, f0_method=args.f0_method,
                               rmvpe_root=args.rmvpe_root,
                               device=args.device):
            print(line)
    if args.hubert == "none":  # an f0-only pass
        print("extract done (features skipped: --hubert none)")
        return
    for line in extract_features(args.exp_dir, version=args.version,
                                 hubert_path=args.hubert,
                                 device=args.device):
        print(line)
    print("extract done")


def cmd_index(args):
    import numpy as np
    from tpu_rvc_torch.retrieval.index import build_index
    feat_dir = os.path.join(args.exp_dir, "3_feature256"
                            if args.version == "v1" else "3_feature768")
    feats = np.concatenate([np.load(os.path.join(feat_dir, n))
                            for n in sorted(os.listdir(feat_dir))], axis=0)
    idx = build_index(feats, args.version, device=args.device)
    out = os.path.join(args.exp_dir, f"added_{args.name}.tpuidx.npz")
    idx.save(out, write_big_npy=args.big_npy)
    print(f"index: {idx.vectors.shape} -> {out}")


def cmd_train(args):
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.parallel import multihost
    from tpu_rvc_torch.train.loop import run_training
    device = args.device
    if (args.multihost or args.coordinator or args.num_processes is not None
            or args.process_id is not None):
        if not (args.multihost or args.coordinator):
            # training alone while the others wait would write
            # conflicting checkpoints
            raise SystemExit(
                "--num-processes/--process-id require --coordinator "
                "ip:port (or --multihost for torchrun's environment)")
        device = multihost.initialize(
            coordinator_address=args.coordinator or None,
            num_processes=args.num_processes, process_id=args.process_id,
            device=args.device)
    hp = hparams_for(args.version, args.sr)
    hp = dataclasses.replace(
        hp, train=dataclasses.replace(hp.train, batch_size=args.batch_size))
    try:
        metrics = run_training(
            args.exp_dir, hp, total_epochs=args.epochs,
            if_f0=bool(args.if_f0), save_every_epoch=args.save_every,
            pretrain_g=args.pretrain_g, pretrain_d=args.pretrain_d,
            name=args.name, author=args.author,
            cache_in_hbm=args.cache_in_hbm, log_fn=print, device=device)
    finally:
        multihost.shutdown()
    print("final:", metrics)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_rvc_torch.apps.train",
                                description="tpu_rvc_torch training")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")

    sp = sub.add_parser("preprocess")
    sp.add_argument("--input-dir", required=True)
    sp.add_argument("--exp-dir", required=True)
    sp.add_argument("--sr", type=int, default=48000)
    sp.add_argument("--workers", type=int, default=8)
    sp.add_argument("--per", type=float, default=3.7)
    sp.set_defaults(fn=cmd_preprocess)

    se = sub.add_parser("extract")
    se.add_argument("--exp-dir", required=True)
    se.add_argument("--version", default="v2")
    se.add_argument("--if-f0", type=int, default=1)
    se.add_argument("--f0-method", default="rmvpe")
    se.add_argument("--hubert", default="assets/hubert/hubert_base.pt",
                    help="fairseq HuBERT-base, 'random' (drawn from seed "
                         "0) or 'none' (f0 only)")
    se.add_argument("--rmvpe-root", default="assets/rmvpe")
    device_arg(se)
    se.set_defaults(fn=cmd_extract)

    si = sub.add_parser("index")
    si.add_argument("--exp-dir", required=True)
    si.add_argument("--version", default="v2")
    si.add_argument("--name", default="index")
    si.add_argument("--big-npy", action="store_true")
    device_arg(si)
    si.set_defaults(fn=cmd_index)

    st = sub.add_parser("train")
    st.add_argument("--exp-dir", required=True)
    st.add_argument("--version", default="v2")
    st.add_argument("--sr", type=int, default=48000)
    st.add_argument("--if-f0", type=int, default=1)
    st.add_argument("--epochs", type=int, default=20)
    st.add_argument("--batch-size", type=int, default=4)
    st.add_argument("--save-every", type=int, default=5)
    st.add_argument("--pretrain-g", default="")
    st.add_argument("--pretrain-d", default="")
    st.add_argument("--name", default="model")
    st.add_argument("--author", default="")
    st.add_argument("--cache-in-hbm", action="store_true",
                    help="keep all batches on the device after epoch 1 "
                         "(reference if_cache_data_in_gpu)")
    st.add_argument("--multihost", action="store_true",
                    help="join a data-parallel job from torchrun's "
                         "environment (RANK, WORLD_SIZE, MASTER_ADDR)")
    st.add_argument("--coordinator", default="",
                    help="host0 ip:port of an explicit data-parallel job "
                         "(reference MASTER_ADDR role)")
    st.add_argument("--num-processes", type=int, default=None)
    st.add_argument("--process-id", type=int, default=None)
    device_arg(st)
    st.set_defaults(fn=cmd_train)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
