"""Sharded checkpoints with manifests, async writes and auto-resume (a port
of ``repro.checkpoint``), in the reference's on-disk format."""
