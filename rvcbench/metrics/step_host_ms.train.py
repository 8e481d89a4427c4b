"""step_host_ms.train: the host's time in `TrainState.train_step`, the
program's `step` span (`train/step.py`, host clock: the upload and the
queueing of the step's work, and any wait for the card inside it),
summed over the window, per step."""


def read(rec):
    ms = rec.get("spans", {}).get("host.step")
    if ms is None or not rec.get("steps"):
        return None
    return ms / rec["steps"]
