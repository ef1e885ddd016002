"""Launchers of the port (``repro.launch``): the serving loop (``serve``)."""
