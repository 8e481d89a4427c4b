"""tick_host_ms.serve: the host's own time in a serving tick, the
program's `tick` span less its `fetch` spans (`pipeline/serve.py`, host
clock: the wait for the card and the copy out), summed over the window,
per tick."""


def read(rec):
    spans = rec.get("spans", {})
    if "host.tick" not in spans or "host.fetch" not in spans \
            or not rec.get("tick_ms"):
        return None
    return (spans["host.tick"] - spans["host.fetch"]) / len(rec["tick_ms"])
