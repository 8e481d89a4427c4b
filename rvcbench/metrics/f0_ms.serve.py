"""f0_ms.serve: the program's `f0` span (RMVPE and its decode on the
device, `pipeline/rt.py`), summed over the window, per tick."""


def read(rec):
    ms = rec.get("spans", {}).get("f0")
    if ms is None or not rec.get("tick_ms"):
        return None
    return ms / len(rec["tick_ms"])
