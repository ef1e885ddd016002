"""Lattice-site updates a second over the whole window, in billions: steps
times sites, over the window's device time from its first event to the
synchronize that ends it."""


def read(rec):
    if not rec["steps"] or rec["window_ms"] <= 0:
        return None
    return rec["steps"] * rec["points"] / (rec["window_ms"] * 1e-3) / 1e9
