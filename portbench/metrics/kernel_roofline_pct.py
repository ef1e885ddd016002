"""The step's bound over the device ms a step in the program's own kernels
(every device op that PyTorch did not launch)."""


def read(rec):
    ops = rec.get("device_ops")
    if not ops or not rec["steps"]:
        return None
    ms = sum(o["dur"] for o in ops if o["origin"] == "program") * 1e-3 / rec["steps"]
    return 100.0 * rec["bound_ms"] / ms if ms > 0 else None
