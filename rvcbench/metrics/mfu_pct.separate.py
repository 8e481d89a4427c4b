"""mfu_pct.separate: the products of every separation finished in the
window, as the yardstick counts them over the plain reference at each
file's bucket (`rvcbench/drivers/separate.py` `separation_flops`: the
net's windows and the resample pyramid's convolutions), over the
window's seconds and the card's published fp32 peak (the path computes
in fp32 with TF32 off), in %."""

from rvcbench.lib.peaks import peak


def read(rec):
    if rec.get("flops") is None or rec["cell"]["entry"] != "separate":
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / peak("fp32_flops")
