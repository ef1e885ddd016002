"""The synthetic token pipeline (a port of ``repro.data``)."""
