"""How late the open loop's generator submitted its requests: the 95th
percentile, over the window's requests, of submit time minus due time, in
ms (the single-threaded server submits only between its drains)."""


def read(run):
    late = run.rec.get("late_s")
    if not late:
        return None
    s = sorted(late)
    return s[max(0, -(-len(s) * 95 // 100) - 1)] * 1e3
