"""Host-side core: temporal structures, file formats, small algorithms."""

from . import formats
from .assignment import associate_by_overlap, hungarian
from .graph import Graph, UnionFind, connected_components_from_edges
from .segment import (
    Annotation,
    Segment,
    Timeline,
    dump,
    dumps,
    load,
    loads,
    string_generator,
)

__all__ = [
    "Annotation",
    "Segment",
    "Timeline",
    "dump",
    "dumps",
    "load",
    "loads",
    "string_generator",
    "associate_by_overlap",
    "hungarian",
    "formats",
    "Graph",
    "UnionFind",
    "connected_components_from_edges",
]
