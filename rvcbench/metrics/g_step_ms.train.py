"""g_step_ms.train: the program's `g_step` span (`train/step.py`: the
generator's losses, backward and AdamW update, CUDA events on the
stream), summed over the window, per step."""


def read(rec):
    ms = rec.get("spans", {}).get("g_step")
    if ms is None or not rec.get("steps"):
        return None
    return ms / rec["steps"]
