"""batch_wait_ms.train: host milliseconds a step spends fetching its next
batch from the port's `BucketBatcher` (`train/data.py`), taken by the
benchmark around the fetch, averaged over the window's steps."""


def read(rec):
    waits = rec.get("batch_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
