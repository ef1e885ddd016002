"""Training and serving steps of the port (``repro.train``): the sharding
rules (``sharding``) and the train, prefill and decode steps (``step``)."""
