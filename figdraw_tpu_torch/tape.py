"""The flattened frame (figdraw_tpu/tape.py:71-212 without TapeBackend, the
Python walk): pass items plus the packed upload buffer the native walk
exports straight into."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np

FRAME_TARGET = -1


@dataclass
class DrawItem:
    """A contiguous run of quads drawn to one target with one mask read."""

    target: int  # FRAME_TARGET or mask-texture index being written
    start: int
    end: int


@dataclass
class BlurItem:
    """Backdrop capture + separable gaussian blur event."""

    radius: float


@dataclass
class ClearMaskItem:
    """Clear mask texture `index` to zero before writing (beginMask)."""

    index: int


TapeItem = Union[DrawItem, BlurItem, ClearMaskItem]


class Tape:
    """Quad records in the PACKED wire layout (ops/layout.py) + ordered pass
    items. The native walk writes the rows straight into `combo`, a pooled
    ping-pong buffer: its contents are valid until the second next flatten
    on the same renderer."""

    __slots__ = (
        "count",
        "items",
        "mask_count",
        "frame_size",
        "clear_color",
        "combo",
        "combo_quads",
        "structure_cache",
        "tile_density",
        "root_spans",
    )

    def __init__(self):
        self.count = 0
        self.items: List[TapeItem] = []
        self.mask_count = 0
        self.frame_size: Tuple[float, float] = (0.0, 0.0)
        self.clear_color: Optional[Tuple[float, float, float, float]] = None
        # (bucket + meta rows, PACKED_WIDTH) f32 upload buffer and the padded
        # quad-row count it was sized for
        self.combo: Optional[np.ndarray] = None
        self.combo_quads = 0
        # (structure, draw bounds, blur radii, any_atlas, any_backdrop) from
        # the C++ item flag bits, and the fd_density tile summary
        self.structure_cache = None
        self.tile_density = None
        # (lvl, root_node_idx) -> (qs, qe), each root's rows, when the walk
        # recorded them (native.flatten_renders_array(record_spans=True))
        self.root_spans = None

    def fields_modes(self):
        """Logical ((combo_quads, 68) f32 fields, (combo_quads, 2) i32
        modes), unpacked on the host (bit-identical to the pre-pack rows)."""
        from .ops.layout import unpack_fields_np

        return unpack_fields_np(self.combo[: self.combo_quads])
