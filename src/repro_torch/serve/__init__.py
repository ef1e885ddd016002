"""Pricing-as-a-service: daemon, scheduler, client, wire schema.

One long-lived process (``python -m repro_torch.serve``) holds the warm
``InvariantCache`` and memoized stream tables; every code-generation run on
the machine prices against it through ``repro_torch.serve.client.PriceClient``
using the same ``PriceRequest``/``PriceResult`` schema as the in-process
``repro_torch.api.price``.  DESIGN.md §12 documents the architecture, wire
protocol, and the cache versioning/eviction contract.

A copy of ``repro.serve``: the wire protocol, the codec's bytes and the memo
journal are the reference's, so either package's client talks to either
package's daemon.
"""
from .client import PriceClient, ServeError
from .daemon import PricingDaemon, serve
from .scheduler import DeadlineExceeded, QueueFullError, Scheduler
from .schema import SCHEMA_VERSION, request_digest

__all__ = ["PriceClient", "ServeError", "PricingDaemon", "serve",
           "Scheduler", "QueueFullError", "DeadlineExceeded",
           "SCHEMA_VERSION", "request_digest"]
