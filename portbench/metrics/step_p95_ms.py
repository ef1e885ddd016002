"""The 95th percentile (nearest rank) of all the window's step times: the
device interval between consecutive per-step events."""
import math


def read(rec):
    s = sorted(rec["step_ms"])
    if not s:
        return None
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]
