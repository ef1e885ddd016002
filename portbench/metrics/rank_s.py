"""Host seconds of the cold ranking in set-up: the program's own top-level
``engine.*`` spans, those with no ``engine.*`` span among their ancestors
(tasks run under a pool's span are inside the sweep that started it)."""


def read(rec):
    spans = list(rec.get("spans") or ())
    by_id = {s.span_id: s for s in spans}

    def inside_engine(s):
        p = by_id.get(s.parent_id)
        while p is not None:
            if p.name.startswith("engine."):
                return True
            p = by_id.get(p.parent_id)
        return False

    top = [s for s in spans if s.name.startswith("engine.") and not inside_engine(s)]
    if not top:
        return None
    return sum(s.dur_us for s in top) * 1e-6
