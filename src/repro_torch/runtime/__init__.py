"""The fault-tolerance runtime (a port of ``repro.runtime``)."""
