"""How near the window's launch comes to the fastest of the cell's
candidate space: the least device ms a call in the program's kernels over
every candidate timed on the same fields (the window's own time included,
so a pick outside the space is measured too), over the window's device ms
a step in the program's kernels."""


def read(rec):
    ops, cands = rec.get("device_ops"), rec.get("candidates")
    if not ops or not cands or not rec["steps"]:
        return None
    mine = sum(o["dur"] for o in ops if o["origin"] == "program") * 1e-3 / rec["steps"]
    if mine <= 0:
        return None
    best = min([c["kernel_ms"] for c in cands if c["kernel_ms"]] + [mine])
    return 100.0 * best / mine
