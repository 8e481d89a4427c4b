"""mfu_pct.train-dp4: the products of every global step of the window
(the four ranks' rows together), as the yardstick counts them over the
reference step at each global batch's shape (`rvcbench/ref/count.py`),
over the window's seconds and four cards' published dense bf16 peak,
in %."""

from rvcbench.lib.peaks import peak


def read(rec):
    if rec.get("flops") is None or rec["cell"]["entry"] != "train_dp":
        return None
    cards = int(rec["cell"]["chips"])
    return 100.0 * rec["flops"] / rec["window_s"] / (cards *
                                                      peak("bf16_flops"))
