"""Host-side core: temporal structures and their JSON files."""

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
]
