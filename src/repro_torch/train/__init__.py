"""Training and serving steps of the port (``repro.train``): the activation
sharding hooks (``sharding``) and the prefill and decode steps (``step``).
The training step, its loss and the parameter shardings are not ported yet."""
