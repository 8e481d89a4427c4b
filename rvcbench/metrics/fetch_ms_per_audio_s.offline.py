"""fetch_ms_per_audio_s.offline: the program's `fetch` span
(`pipeline/vc.py`, host clock: the wait for the card, then the copy of
the result to the host), summed over the window, over the seconds of
audio converted."""


def read(rec):
    ms = rec.get("spans", {}).get("host.fetch")
    if ms is None or not rec.get("audio_s"):
        return None
    return ms / rec["audio_s"]
