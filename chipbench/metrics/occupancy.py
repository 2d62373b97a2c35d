"""Real rows over padded rows of every batch the engine ran in the window,
in %."""


def read(run):
    if not run.rec.get("padded_rows"):
        return None
    return 100.0 * run.rec["real_rows"] / run.rec["padded_rows"]
