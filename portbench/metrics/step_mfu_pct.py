"""The whole step's share of the chip's peak: the step's bound (``bounds``:
compulsory bytes at the HBM rate against its operations at the peak) over
the mean step time of the traced window."""


def read(rec):
    if not rec["steps"] or rec["window_ms"] <= 0:
        return None
    return 100.0 * rec["bound_ms"] / (rec["window_ms"] / rec["steps"])
