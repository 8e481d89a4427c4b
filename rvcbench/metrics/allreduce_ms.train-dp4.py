"""allreduce_ms.train-dp4: rank 0's `all_reduce` spans (`train/step.py`
`TrainState._update`: the averaging of D's and then G's gradients over
the group in flat buffers, CUDA events on the stream), summed over the
window, per step."""


def read(rec):
    ms = rec.get("spans", {}).get("all_reduce")
    if ms is None or not rec.get("steps"):
        return None
    return ms / rec["steps"]
