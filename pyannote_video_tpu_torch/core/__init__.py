"""Host-side core: temporal structures, file formats, small algorithms."""

from . import formats
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
    "formats",
    "Graph",
    "UnionFind",
    "connected_components_from_edges",
]
