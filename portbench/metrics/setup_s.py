"""Seconds from the process's start (before ``import torch``) to the
window's start: imports, fields on the device, the build or its cache,
the cold ranking of a ranked cell, warm-up."""


def read(rec):
    return rec["setup_s"]
