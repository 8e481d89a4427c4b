"""net_ms_per_audio_s.separate: the program's `net` span (the sliding
windows through HP5's CascadedASPPNet, `pipeline/uvr5.py`
`DeviceSeparator`, CUDA events on the stream), summed over the window,
over the seconds of input separated."""


def read(rec):
    ms = rec.get("spans", {}).get("net")
    if ms is None or not rec.get("audio_s"):
        return None
    return ms / rec["audio_s"]
