"""Median, over the window's requests, of the time from when a request was
due to when its result was handed back, in ms: a steadier statistic beside
the tail."""
import statistics


def read(run):
    lat = run.rec.get("latency_s")
    if not lat:
        return None
    return statistics.median(lat) * 1e3
