"""Device ms a step in PyTorch's own kernels, copies and fills: the entry
point's pads and, for the LBM, the phase sum."""


def read(rec):
    ops = rec.get("device_ops")
    if not ops or not rec["steps"]:
        return None
    return sum(o["dur"] for o in ops if o["origin"] == "torch") * 1e-3 / rec["steps"]
