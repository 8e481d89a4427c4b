"""collate_ms.train: the host's making of each batch, the program's `load`
(the batch's `RVCDataset.load` calls) and `collate` spans
(`train/data.py` `BucketBatcher`, host clock), summed over the window,
per step."""

KEYS = ("host.load", "host.collate")


def read(rec):
    spans = rec.get("spans", {})
    if not rec.get("steps") or any(k not in spans for k in KEYS):
        return None
    return sum(spans[k] for k in KEYS) / rec["steps"]
