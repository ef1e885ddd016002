"""One reader a metric (``<metric>.py``): ``read(rec)`` returns the metric
from a run's records, or None where the run has nothing it reads.

``rec`` holds ``setup_s``; ``steps``, ``step_ms`` (each step's device ms,
from CUDA events) and ``window_ms`` of the window; ``points`` (sites a step
updates) and ``bound_ms`` (the step's least device time, ``bounds``);
in a traced run ``device_ops`` (``trace.classify``), ``busy_ms`` and
``spans`` (the program's host spans during set-up); and ``candidates``
where the cell times a candidate space.
"""
