"""sola_ms.serve: the program's `sola` span (`pipeline/serve.py`
`_deliver`, host clock: every slot's SOLA merge and output push), summed
over the window, per tick."""


def read(rec):
    ms = rec.get("spans", {}).get("host.sola")
    if ms is None or not rec.get("tick_ms"):
        return None
    return ms / len(rec["tick_ms"])
