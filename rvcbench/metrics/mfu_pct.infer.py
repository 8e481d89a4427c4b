"""mfu_pct.infer: the products of every call finished in the window, as
the yardstick counts them over the plain reference at each call's shapes
(`rvcbench/ref/count.py`), over the window's seconds and the card's
published dense TF32 peak, in %.  The path computes in fp32 (TF32 off)
and its kernels in 3xTF32: a third of that peak is the most a change that
keeps fp32 accuracy can reach on the tensor cores."""

from rvcbench.lib.peaks import peak


def read(rec):
    if rec.get("flops") is None or rec["cell"]["entry"] == "train":
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / peak("tf32_flops")
