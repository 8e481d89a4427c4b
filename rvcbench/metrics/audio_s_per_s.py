"""audio_s_per_s: seconds of converted audio delivered to the host over
the whole window, divided by the window's seconds."""


from rvcbench.lib.stats import rate


def read(rec):
    if "audio_s" not in rec:
        return None
    return rate(rec["audio_s"], rec["window_s"])
