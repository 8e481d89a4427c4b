"""idle_pct.train-dp4: the share of rank 0's traced window of
data-parallel steps in which no operation ran on its card (the union of
kernel, copy and set intervals, NCCL's kernels among them), in %."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or rec["cell"]["entry"] != "train_dp":
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
