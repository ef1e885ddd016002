"""Architecture configs of the port (copies of ``repro.configs``); one
module per ported architecture."""
from .base import SHAPES, ArchConfig, ShapeSpec, valid_cells

__all__ = ["SHAPES", "ArchConfig", "ShapeSpec", "valid_cells"]
