"""One driver a family of configurations (``<family>.py``).

A driver makes a cell's fields on the device from the seed, calls the
program's entry point for one step, and calls the frozen reference for
one step.  Its interface:

* ``OUTPUTS``: the names of the fields a step carries, in order;
* ``init(config, seed, device)`` -> ``(fields, operands)``: the initial
  fields (a tuple of tensors) and what every step takes besides them;
* ``program_step(fields, operands, config, entry)``: one call of the
  program's entry point, ``entry`` its pinned config or None (ranked);
* ``reference_step(fields, operands, config, dtype=None)``: the same step
  by the plain reference, computed in ``dtype`` (the fields' own by
  default);
* ``points(config)``: lattice sites a step updates;
* ``bound_ms(config)``: the least device time of a step (``bounds``).
"""
