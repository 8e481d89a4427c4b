"""step_ms: the window's milliseconds over the training steps completed
in it, the wait for each next batch included."""


from rvcbench.lib.stats import rate


def read(rec):
    if not rec.get("steps"):
        return None
    return 1e3 / rate(rec["steps"], rec["window_s"])
