"""The pricing API's wire codec (``serve.schema``).

The port of ``repro.serve`` starts with its codec: ``PriceRequest`` and
``PriceResult`` round-trip through it exactly.  The daemon, scheduler and
client join with a later slice.
"""
from .schema import (
    SCHEMA_VERSION,
    decode,
    dumps,
    encode,
    loads,
    request_digest,
)

__all__ = ["SCHEMA_VERSION", "encode", "decode", "dumps", "loads",
           "request_digest"]
