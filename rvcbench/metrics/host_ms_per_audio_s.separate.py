"""host_ms_per_audio_s.separate: the host's I/O of each file, the
program's `load` (decode and downmix), `upload` (the zero-padded (2, T)
copy to the card) and `fetch` (the two int16 stems' copies, after the
card has finished) spans (`pipeline/uvr5.py` `DeviceSeparator.separate`,
host clock), summed over the window, over the seconds of input
separated."""

KEYS = ("host.load", "host.upload", "host.fetch")


def read(rec):
    spans = rec.get("spans", {})
    if not rec.get("audio_s") or any(k not in spans for k in KEYS):
        return None
    return sum(spans[k] for k in KEYS) / rec["audio_s"]
