"""The optimiser (a port of ``repro.optim``): AdamW."""
