"""HLO-text analysis: collective traffic extraction (a copy of
``repro.core.hlo``), and the same accounting of the collectives a torch
program issues.

``collective_bytes`` parses optimized HLO text and sums the operand sizes
of every collective op, scaled by the ring-algorithm wire factor for its
participant group size, exactly as the reference does.
``collective_bytes_of`` builds the same dict from the collectives that
``core.cost.count_cost`` records at dispatch (``_c10d_functional``'s ops),
with the same payload rules; the group size comes from the process group.
"""
from __future__ import annotations

import math
import re
from collections import defaultdict

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "ragged-all-to-all", "collective-broadcast",
)

_TYPE_RE = re.compile(r"\b([a-z0-9]+)\[([\d,]*)\]")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _type_bytes(type_str: str) -> int:
    m = _TYPE_RE.match(type_str.strip())
    if not m:
        return 0
    dt, dims = m.group(1), m.group(2)
    eb = DTYPE_BYTES.get(dt)
    if eb is None:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            if d:
                n *= int(d)
    return n * eb


def _operand_types(line: str, op_kind: str) -> list[str]:
    """Type strings of the operands inside op(...)."""
    i = line.find(op_kind + "(")
    if i < 0:
        i = line.find(op_kind + "-start(")
        if i < 0:
            return []
        i += len(op_kind) + 7
    else:
        i += len(op_kind) + 1
    depth = 1
    j = i
    while j < len(line) and depth > 0:
        if line[j] == "(":
            depth += 1
        elif line[j] == ")":
            depth -= 1
        j += 1
    inner = line[i : j - 1]
    return _TYPE_RE.findall(inner) and [
        m.group(0) for m in _TYPE_RE.finditer(inner)
    ] or []


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_BRACE_RE.search(line)
    if m:
        members = [x for x in m.group(1).split(",") if x.strip() != ""]
        return max(1, len(members))
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return max(1, int(m.group(2)))
    return default


def wire_factor(kind: str, g: int) -> float:
    """Per-device wire bytes per payload byte under ring algorithms."""
    if kind in ("collective-permute", "collective-broadcast"):
        return 1.0  # point-to-point: full payload crosses a link
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind in ("all-gather", "reduce-scatter", "all-to-all", "ragged-all-to-all"):
        return (g - 1) / g
    if kind == "collective-permute":
        return 1.0
    if kind == "collective-broadcast":
        return 1.0
    return 1.0


def collective_bytes(hlo_text: str, default_group: int = 1) -> dict:
    """Sum payload and wire bytes of every collective in the HLO text.

    Returns {kind: {"count", "payload_bytes", "wire_bytes"}} plus a "total"
    entry.  Payload = operand sizes (result for all-gather, which better
    reflects the moved volume).  Done-ops of async pairs are skipped.
    """
    out: dict = defaultdict(lambda: {"count": 0, "payload_bytes": 0, "wire_bytes": 0.0})
    for raw in hlo_text.splitlines():
        line = raw.strip()
        if "-done" in line:
            continue
        for kind in COLLECTIVE_KINDS:
            token = " " + kind
            if (token + "(" in line) or (token + "-start(" in line):
                # result type: first type on the lhs after '='
                eq = line.find("=")
                res_types = _TYPE_RE.findall(line[eq + 1 : eq + 80]) if eq >= 0 else []
                res_m = _TYPE_RE.search(line[eq + 1 :]) if eq >= 0 else None
                res_bytes = _type_bytes(res_m.group(0)) if res_m else 0
                op_types = _operand_types(line, kind)
                opnd_bytes = sum(_type_bytes(t) for t in op_types)
                if kind == "all-gather":
                    payload = max(res_bytes, opnd_bytes)
                elif kind == "reduce-scatter":
                    payload = opnd_bytes
                else:
                    payload = opnd_bytes or res_bytes
                g = _group_size(line, default_group)
                out[kind]["count"] += 1
                out[kind]["payload_bytes"] += payload
                out[kind]["wire_bytes"] += payload * wire_factor(kind, g)
                break
    total_payload = sum(v["payload_bytes"] for v in out.values())
    total_wire = sum(v["wire_bytes"] for v in out.values())
    result = dict(out)
    result["total"] = {
        "count": sum(v["count"] for v in out.values()),
        "payload_bytes": total_payload,
        "wire_bytes": total_wire,
    }
    return result


# torch's functional collectives (``torch.distributed._functional_collectives``,
# the ops DTensor issues) by the HLO kind they count as
TORCH_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def collective_bytes_of(records) -> dict:
    """``collective_bytes``' dict from recorded collectives.

    ``records``: ``(op, operand_bytes, result_bytes, group_size)`` tuples,
    ``op`` a name of ``TORCH_COLLECTIVES`` (``core.cost.count_cost`` records
    them).  Payload as ``collective_bytes`` takes it: the result for an
    all-gather (the larger of operand and result), the operand for a
    reduce-scatter, else the operand (the result where the operand has no
    bytes); wire bytes by ``wire_factor`` at the group's size.
    """
    out: dict = defaultdict(lambda: {"count": 0, "payload_bytes": 0, "wire_bytes": 0.0})
    for op, opnd_bytes, res_bytes, g in records:
        kind = TORCH_COLLECTIVES[op]
        if kind == "all-gather":
            payload = max(res_bytes, opnd_bytes)
        elif kind == "reduce-scatter":
            payload = opnd_bytes
        else:
            payload = opnd_bytes or res_bytes
        out[kind]["count"] += 1
        out[kind]["payload_bytes"] += payload
        out[kind]["wire_bytes"] += payload * wire_factor(kind, g)
    result = dict(out)
    result["total"] = {
        "count": sum(v["count"] for v in out.values()),
        "payload_bytes": sum(v["payload_bytes"] for v in out.values()),
        "wire_bytes": sum(v["wire_bytes"] for v in out.values()),
    }
    return result
