"""Versioned wire codec for the pricing API (DESIGN.md §12).

One JSON-safe serialization for everything that leaves the process:
``PriceResult.to_json_dict``, request digests and the engine's checkpoint
keys.  The encoding is a tagged tree over a **whitelist** of the port's
dataclasses — never pickle, so a reader only ever materializes types this
module registered:

    scalars                     -> themselves (numpy scalars -> .item())
    tuple / list                -> {"$": "tuple" | "list", "v": [...]}
    dict (any hashable keys)    -> {"$": "dict", "v": [[k, v], ...]}
    registered dataclass        -> {"$": "<ClassName>", "f": {field: ...}}

Python's ``json`` round-trips floats exactly (shortest-repr), tuples are
restored as tuples, and dataclasses rebuild through their constructors —
so ``decode(encode(x)) == x`` for every value the engine produces, and the
restored objects hash/compare identically (frozen specs keep working as
cache keys).  ``SCHEMA_VERSION`` rides in every envelope; a payload from a
newer schema is rejected, not guessed at.

``request_digest`` — sha256 over the canonical encoding — is the identity
of a request.

A copy of ``repro.serve.schema``'s codec, with the same tags (class names,
never module paths) and ``SCHEMA_VERSION``.  It registers the types the
port has; the reference's traced-spec payload (``TracedSpecPayload``)
joins with the slice that ports the frontend.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

from repro_torch.api import PlanRef, PriceRequest, PriceResult
from repro_torch.core.access import Access, Field, KernelSpec, LaunchConfig
from repro_torch.core.capacity import CapacityModel, HitRateFit
from repro_torch.core.engine import (
    EvalResult,
    ExplorationReport,
    PrunedConfig,
    RejectedSpec,
    SkippedConfig,
    Workload,
)
from repro_torch.core.machines import (
    GPUGeometry,
    GPUMachine,
    TPUGeometry,
    TPUMachine,
)
from repro_torch.core.perfmodel import GPUEstimate, VolumeBreakdown
from repro_torch.core.roofline import RooflineReport
from repro_torch.core.tpu_adapt import (
    MatmulShape,
    OperandSpec,
    PallasEstimate,
    PallasKernelSpec,
)
from repro_torch.suite.report import ModelReport, SuiteReport, WorkloadPricing

SCHEMA_VERSION = 1

# the whitelist: everything a PriceRequest/PriceResult tree can contain
_CLASSES = (
    PriceRequest, PriceResult, PlanRef,
    Workload, ExplorationReport, EvalResult, SkippedConfig, PrunedConfig,
    RejectedSpec,
    KernelSpec, Field, Access, LaunchConfig,
    GPUMachine, TPUMachine, GPUGeometry, TPUGeometry,
    CapacityModel, HitRateFit,
    GPUEstimate, VolumeBreakdown,
    PallasKernelSpec, OperandSpec, MatmulShape, PallasEstimate,
    SuiteReport, ModelReport, WorkloadPricing, RooflineReport,
)
_BY_NAME = {cls.__name__: cls for cls in _CLASSES}
_BY_CLASS = {cls: cls.__name__ for cls in _CLASSES}
_RESERVED = {"tuple", "list", "dict"}
assert not _RESERVED & set(_BY_NAME), "class name collides with a container tag"


def encode(obj):
    """Lower ``obj`` to the tagged JSON-safe tree.

    Raises ``TypeError`` for anything outside the whitelist — by design:
    a request that cannot be encoded cannot be deduped or served.
    """
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    cls = type(obj)
    if cls.__module__.startswith("numpy") and hasattr(obj, "item"):
        return encode(obj.item())
    name = _BY_CLASS.get(cls)
    if name is not None:
        return {"$": name,
                "f": {f.name: encode(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)}}
    if isinstance(obj, tuple):
        return {"$": "tuple", "v": [encode(x) for x in obj]}
    if isinstance(obj, list):
        return {"$": "list", "v": [encode(x) for x in obj]}
    if isinstance(obj, dict):
        return {"$": "dict",
                "v": [[encode(k), encode(v)] for k, v in obj.items()]}
    raise TypeError(
        f"{cls.__module__}.{cls.__qualname__} is not wire-encodable "
        f"(register it in repro_torch.serve.schema, or keep it out of the "
        f"request/result tree)")


def decode(node):
    """Rebuild the value tree ``encode`` produced."""
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if isinstance(node, list):      # only inside a tagged container
        return [decode(x) for x in node]
    if not isinstance(node, dict):
        raise TypeError(f"malformed wire node of type {type(node).__name__}")
    tag = node.get("$")
    if tag == "tuple":
        return tuple(decode(x) for x in node["v"])
    if tag == "list":
        return [decode(x) for x in node["v"]]
    if tag == "dict":
        return {_hashable(decode(k)): decode(v) for k, v in node["v"]}
    cls = _BY_NAME.get(tag)
    if cls is None:
        raise TypeError(f"unknown wire tag {tag!r} (schema skew? this side "
                        f"speaks version {SCHEMA_VERSION})")
    return cls(**{k: decode(v) for k, v in node["f"].items()})


def _hashable(key):
    # dict keys decoded from pair lists may be lists only via the bare-list
    # branch, which tagged encoding never emits for keys; guard anyway
    return tuple(key) if isinstance(key, list) else key


def dumps(obj, **kw) -> str:
    """Versioned envelope -> compact JSON text."""
    return json.dumps({"schema_version": SCHEMA_VERSION, "body": encode(obj)},
                      separators=(",", ":"), **kw)


def loads(text: str):
    env = json.loads(text)
    if not isinstance(env, dict) or "body" not in env:
        raise ValueError("not a repro_torch wire envelope")
    version = env.get("schema_version")
    if version != SCHEMA_VERSION:
        raise ValueError(f"wire schema version {version} != "
                         f"{SCHEMA_VERSION} (upgrade the older side)")
    return decode(env["body"])


def request_digest(request) -> str:
    """Structural identity of a request: sha256 of its canonical encoding.

    Two requests with equal digests ask for bitwise-identical work.
    """
    text = json.dumps(encode(request), separators=(",", ":"), sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()


__all__ = ["SCHEMA_VERSION", "encode", "decode", "dumps", "loads",
           "request_digest"]
