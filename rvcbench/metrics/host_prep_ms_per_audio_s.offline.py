"""host_prep_ms_per_audio_s.offline: the host's preparation of each file,
the program's `load` (decode, resample to 16 kHz, peak normalise), `split`
(high-pass, silence scan, reflect pads) and `upload` spans
(`pipeline/vc.py`, host clock), summed over the window, over the seconds
of audio converted."""

KEYS = ("host.load", "host.split", "host.upload")


def read(rec):
    spans = rec.get("spans", {})
    if not rec.get("audio_s") or any(k not in spans for k in KEYS):
        return None
    return sum(spans[k] for k in KEYS) / rec["audio_s"]
