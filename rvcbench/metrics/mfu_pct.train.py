"""mfu_pct.train: the products of every training step of the window, as
the yardstick counts them over the reference step at each batch's shape
(`rvcbench/ref/count.py`), over the window's seconds and the card's
published dense bf16 peak, in %."""

from rvcbench.lib.peaks import peak


def read(rec):
    if rec.get("flops") is None or rec["cell"]["entry"] != "train":
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / peak("bf16_flops")
