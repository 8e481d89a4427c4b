"""idle_pct.separate: the share of the traced window of separations in
which no operation ran on the card (the union of kernel, copy and set
intervals), in %."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or rec["cell"]["entry"] != "separate":
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
