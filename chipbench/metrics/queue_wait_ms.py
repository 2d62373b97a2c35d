"""Median, over the window's requests, of the time from when a request was
due to the start of its batch, in ms (the harness's due times, the
engine's per-batch records)."""
import statistics


def read(run):
    waits = run.rec.get("queue_wait_s")
    if not waits:
        return None
    return statistics.median(waits) * 1e3
