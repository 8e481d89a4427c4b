"""Conversion across devices: B utterances as one batch (`batch`) and one
long utterance's chunks as rows (`chunks`), over a `core/mesh.py` Mesh."""

from .batch import batch_convert, make_batch_graph
from .chunks import convert_long

__all__ = ["batch_convert", "make_batch_graph", "convert_long"]
