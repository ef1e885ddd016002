"""Models of the port (``repro.models``): the unified LM (``lm``)."""
