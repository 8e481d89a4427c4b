"""decoder_ms_per_audio_s.offline: the program's `decoder` span
(`models/synthesizer.py`, CUDA events on the stream), summed over the
window, over the seconds of audio converted."""


def read(rec):
    ms = rec.get("spans", {}).get("decoder")
    if ms is None or not rec.get("audio_s"):
        return None
    return ms / rec["audio_s"]
