"""net_windows.separate: the windows the sliding inference sends through
the net (the program's counter `uvr5.windows`, `pipeline/uvr5.py`
`DeviceSeparator._run_net`, TTA passes included), over the window, per
second of input separated: a check on the windowing, whose least is the
frames a second over the window's stride."""


def read(rec):
    n = rec.get("spans", {}).get("count.uvr5.windows")
    if n is None or not rec.get("audio_s"):
        return None
    return n / rec["audio_s"]
