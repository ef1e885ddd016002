"""Launchers of the port (``repro.launch``): the serving loop (``serve``),
the trainer (``train``), the mesh (``mesh``), and the dry run (``dryrun``,
over ``calibrate``'s per-block accounting)."""
