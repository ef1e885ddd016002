"""The share of the traced window in which no device op runs: the window's
device time less the union of the ops' intervals."""


def read(rec):
    if not rec.get("device_ops") or rec["window_ms"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_ms"] / rec["window_ms"])
