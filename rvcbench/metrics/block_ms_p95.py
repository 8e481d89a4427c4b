"""block_ms_p95: the 95th percentile, over every tick of the window, of
the milliseconds from a tick's start (every slot's block queued) to the
last slot's block collected on the host."""

from rvcbench.lib.stats import percentile


def read(rec):
    if not rec.get("tick_ms"):
        return None
    return percentile(rec["tick_ms"], 95)
