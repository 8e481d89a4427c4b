"""spec_ms_per_audio_s.separate: the program's `resample`, `stft` and
`istft` spans (the band pyramid both ways and its spectra,
`pipeline/uvr5.py` `DeviceSeparator`, CUDA events on the stream),
summed over the window, over the seconds of input separated."""

KEYS = ("resample", "stft", "istft")


def read(rec):
    spans = rec.get("spans", {})
    if not rec.get("audio_s") or any(k not in spans for k in KEYS):
        return None
    return sum(spans[k] for k in KEYS) / rec["audio_s"]
