#!/usr/bin/env python3
"""The host-bound timed phases of one checkout's `chip_smoke.py`, alone,
for A/B runs of two checkouts on one card.

    python3 tpu_rvc_torch/tools/phase_ab.py <checkout> [phase ...]

Imports `chip_smoke` and `tpu_rvc_torch` from <checkout> (a `git archive`
of any commit that has the FCPE phases), builds its kernels and runs the
phases named (all by default), each printing chip_smoke's own JSON line:
`offline` the 10 s conversion with pm and with RMVPE, `streaming` the
block on both paths, `serving` the tick at 8, 1 and 4 slots, `train` the
training step, `fcpe` the offline conversion and 8-slot tick with FCPE.
Run two checkouts in fresh processes in the order a b b a a b b a and
compare only within one call: the card's host is shared, and its speed
drifts over minutes.
"""

import contextlib
import os
import sys
import tempfile


PHASES = ("offline", "streaming", "serving", "train", "fcpe")


def main(argv):
    if not argv or not set(argv[1:]) <= set(PHASES):
        print(__doc__, file=sys.stderr)
        return 2
    phases = argv[1:] or PHASES
    sys.path.insert(0, os.path.abspath(argv[0]))
    import torch

    if not torch.cuda.is_available():
        print("phase_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_rvc_torch.ops.kernels import build

    print(cs.card_line())
    build.build()
    with tempfile.TemporaryDirectory() as tmp:
        cs.write_rmvpe(tmp, seed=9)
        cs.end_to_end(tmp, "pm", "end_to_end")   # writes the model and voice
        if "offline" in phases:
            cs.end_to_end(tmp, "rmvpe", "end_to_end_rmvpe")
        if "streaming" in phases:
            cs.streaming(tmp)
        if "serving" in phases:
            cs.serving(tmp, cs.BATCH_N, n_warm=3, n_timed=20)
            for n in (1, 4):
                cs.serving(tmp, n, n_warm=3, n_timed=10)
        if "train" in phases:
            cs.train_full_width(tmp, cs.train_prepare(tmp))
        if "fcpe" in phases:
            with contextlib.chdir(tmp):   # FCPE finds assets/fcpe/fcpe.pt
                cs.write_fcpe(tmp, seed=10)
                cs.end_to_end(tmp, "fcpe", "fcpe_offline")
                cs.serving(tmp, cs.BATCH_N, n_warm=3, n_timed=10,
                           f0method="fcpe", modes=(False,),
                           phase="fcpe_serving")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
