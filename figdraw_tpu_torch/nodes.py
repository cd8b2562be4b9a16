"""Fig nodes, RenderList, Renders and DrawableOp (figdraw_tpu/nodes.py,
copied): the flat index-linked tree (children stored after their parent,
linked by `parent` index and `child_count`), O(1) add_root/add_child, O(n)
insert_* with index remapping, and the Renders layer table keyed by
ZLevel.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from .basics import (
    BackdropBlurStyle,
    CornerRadii,
    FigFlags,
    FigKind,
    ImageStyle,
    MsdfImageStyle,
    RenderShadow,
    RenderStroke,
    TransformStyle,
    ZERO_CORNERS,
    ZLevel,
)
from .fill import Fill
from .geometry import Rect, Vec2, vec2

FigIdx = int  # distinct int16 in the reference (fignodes.nim:51)
NIL_IDX: FigIdx = -1
MAX_NODES = 32767  # int16 cap (fignodes.nim:113-119)

DEFAULT_DRAWABLE_BEZIER_STEPS = 48
DEFAULT_DRAWABLE_ARC_STEPS = 48


class DrawableKind(enum.IntEnum):
    dkLine = 0
    dkCircle = 1
    dkRectangle = 2
    dkBezier = 3
    dkArc = 4
    dkEllipse = 5


@dataclass(frozen=True, slots=True)
class DrawableOp:
    """Variant drawable op (fignodes.nim:21-42)."""

    kind: DrawableKind = DrawableKind.dkLine
    # dkLine
    a: Vec2 = field(default_factory=Vec2)
    b: Vec2 = field(default_factory=Vec2)
    # dkCircle
    center: Vec2 = field(default_factory=Vec2)
    radius: float = 0.0
    # dkRectangle
    box: Rect = field(default_factory=Rect)
    corners: CornerRadii = ZERO_CORNERS
    # dkBezier
    controls: Tuple[Vec2, ...] = ()
    steps: int = 0
    # dkArc
    arc_center: Vec2 = field(default_factory=Vec2)
    arc_radius: float = 0.0
    start_angle: float = 0.0
    sweep_angle: float = 0.0
    arc_steps: int = 0
    # dkEllipse
    ellipse_center: Vec2 = field(default_factory=Vec2)
    ellipse_radii: Vec2 = field(default_factory=Vec2)


def drawable_line(a, b=None, x2=None, y2=None) -> DrawableOp:
    if b is None or x2 is not None:
        a, b = vec2(a, b), vec2(x2, y2)
    return DrawableOp(kind=DrawableKind.dkLine, a=a, b=b)


def drawable_circle(center, radius: float = 0.0, r2: Optional[float] = None) -> DrawableOp:
    if r2 is not None:
        center, radius = vec2(center, radius), r2
    return DrawableOp(kind=DrawableKind.dkCircle, center=center, radius=float(radius))


def drawable_ellipse(center, radii=None, rx=None, ry=None) -> DrawableOp:
    if radii is None or rx is not None:
        center, radii = vec2(center, radii), vec2(rx, ry)
    return DrawableOp(
        kind=DrawableKind.dkEllipse, ellipse_center=center, ellipse_radii=radii
    )


def drawable_rect(box: Rect, corners: CornerRadii = ZERO_CORNERS) -> DrawableOp:
    return DrawableOp(kind=DrawableKind.dkRectangle, box=box, corners=tuple(corners))


def drawable_bezier(controls: Sequence[Vec2], steps: int = 0) -> DrawableOp:
    """steps = 0 inherits nkDrawable.draw_steps or uses adaptive spans."""
    return DrawableOp(
        kind=DrawableKind.dkBezier, controls=tuple(controls), steps=int(steps)
    )


def drawable_arc(
    center: Vec2,
    radius: float,
    start_angle: float,
    sweep_angle: float,
    steps: int = 0,
) -> DrawableOp:
    return DrawableOp(
        kind=DrawableKind.dkArc,
        arc_center=center,
        arc_radius=float(radius),
        start_angle=float(start_angle),
        sweep_angle=float(sweep_angle),
        arc_steps=int(steps),
    )


@dataclass(slots=True)
class Fig:
    """Scene node (fignodes.nim:54-92). Python keeps all payload fields on one
    object; `kind` selects which are meaningful, like the Nim case object."""

    kind: FigKind = FigKind.nkFrame
    zlevel: ZLevel = 0
    parent: FigIdx = NIL_IDX
    flags: FigFlags = FigFlags(0)
    child_count: int = 0

    screen_box: Rect = field(default_factory=Rect)

    rotation: float = 0.0
    fill: Fill = field(default_factory=Fill)
    corners: CornerRadii = ZERO_CORNERS
    corner_radii_y: CornerRadii = ZERO_CORNERS

    # nkRectangle
    shadows: Tuple[RenderShadow, ...] = ()
    stroke: RenderStroke = field(default_factory=RenderStroke)
    # nkText
    text_layout: object = None
    selection_range: Tuple[int, int] = (0, -1)
    # nkDrawable
    draw_stroke: RenderStroke = field(default_factory=RenderStroke)
    draw_steps: int = 0
    draw_aa: float = 0.0
    draw_ops: Tuple[DrawableOp, ...] = ()
    # nkImage / nkMsdfImage / nkMtsdfImage
    image: ImageStyle = field(default_factory=ImageStyle)
    msdf_image: MsdfImageStyle = field(default_factory=MsdfImageStyle)
    mtsdf_image: MsdfImageStyle = field(default_factory=MsdfImageStyle)
    # nkBackdropBlur
    backdrop_blur: BackdropBlurStyle = field(default_factory=BackdropBlurStyle)
    # nkTransform
    transform: TransformStyle = field(default_factory=TransformStyle)

    def __post_init__(self):
        if not isinstance(self.flags, FigFlags):
            self.flags = FigFlags(self.flags)
        if isinstance(self.fill, (tuple,)) or self.fill.__class__.__name__ == "ColorRGBA":
            from .fill import fill as _mkfill

            self.fill = _mkfill(self.fill)
        self.corners = tuple(self.corners)
        self.corner_radii_y = tuple(self.corner_radii_y)
        self.shadows = tuple(self.shadows)
        self.draw_ops = tuple(self.draw_ops)

    def copy(self) -> "Fig":
        # value-type copy semantics like Nim's Fig, but without
        # dataclasses.replace (which rebuilds kwargs and re-runs
        # __post_init__ — ~3x slower; this copy is the hottest call in
        # per-frame object-scene builds). Fields are already normalized.
        new = object.__new__(Fig)
        for name in _FIG_SLOTS:
            setattr(new, name, getattr(self, name))
        return new


_FIG_SLOTS = Fig.__slots__


@dataclass(slots=True)
class RenderList:
    """Flat node list + root indexes (fignodes.nim:44-46)."""

    nodes: List[Fig] = field(default_factory=list)
    root_ids: List[FigIdx] = field(default_factory=list)

    # -- invariants helpers ---------------------------------------------------

    def _valid_idx(self, idx: FigIdx) -> bool:
        return 0 <= idx < len(self.nodes)

    def _check_capacity(self, add_count: int) -> None:
        assert add_count >= 0
        assert len(self.nodes) + add_count <= MAX_NODES

    def _recompute_child_counts(self) -> None:
        for node in self.nodes:
            node.child_count = 0
        for node in self.nodes:
            p = node.parent
            if p >= 0:
                assert p < len(self.nodes)
                self.nodes[p].child_count += 1

    def _shift_indexes(self, insert_idx: int, count: int) -> None:
        if count == 0:
            return
        for node in self.nodes:
            if node.parent >= insert_idx:
                node.parent += count
        self.root_ids = [
            r + count if r >= insert_idx else r for r in self.root_ids
        ]

    def _insert_nodes(self, insert_idx: int, nodes: Sequence[Fig]) -> None:
        if not nodes:
            return
        assert 0 <= insert_idx <= len(self.nodes)
        self._check_capacity(len(nodes))
        self.nodes[insert_idx:insert_idx] = list(nodes)

    def child_index(self, current: FigIdx) -> Iterator[FigIdx]:
        """Forward-scan child iteration (fignodes.nim:165-177)."""
        child_cnt = self.nodes[current].child_count
        idx = current + 1
        cnt = 0
        while cnt < child_cnt and idx < len(self.nodes):
            if self.nodes[idx].parent == current:
                cnt += 1
                yield idx
            idx += 1

    def _child_insert_index(self, parent_idx: FigIdx, child_pos: int) -> int:
        assert self._valid_idx(parent_idx)
        child_count = self.nodes[parent_idx].child_count
        assert child_pos <= child_count
        if child_pos == child_count:
            return len(self.nodes)
        for pos, child_idx in enumerate(self.child_index(parent_idx)):
            if pos == child_pos:
                return child_idx
        raise AssertionError("unreachable child position")

    def _root_insert_index(self, root_pos: int) -> int:
        assert root_pos <= len(self.root_ids)
        if root_pos == len(self.root_ids):
            return len(self.nodes)
        return self.root_ids[root_pos]

    def _validate_root_ids(self) -> None:
        for r in self.root_ids:
            assert self._valid_idx(r)
            assert self.nodes[r].parent < 0
        roots = set(self.root_ids)
        for idx, node in enumerate(self.nodes):
            if node.parent < 0:
                assert idx in roots

    def _remapped_nodes(self, insert_idx: int, parent_idx: FigIdx) -> List[Fig]:
        """Copy nodes, re-parenting roots to parent_idx and offsetting internal
        parents by insert_idx (fignodes.nim:216-226)."""
        self._validate_root_ids()
        out: List[Fig] = []
        for node in self.nodes:
            new_node = node.copy()
            if node.parent < 0:
                new_node.parent = parent_idx
            else:
                assert node.parent < len(self.nodes)
                new_node.parent = insert_idx + node.parent
            out.append(new_node)
        return out

    # -- public API -----------------------------------------------------------

    def clear(self) -> None:
        self.nodes.clear()
        self.root_ids.clear()

    def __len__(self) -> int:
        return len(self.nodes)

    def add_root(self, root: Fig) -> FigIdx:
        """O(1) append of a new root (fignodes.nim:316-330)."""
        return self._add_root_owned(root.copy())

    def _add_root_owned(self, node: Fig) -> FigIdx:
        """add_root for a node the caller owns (already copied) — the
        Renders-level overloads copy once, not twice."""
        new_idx = len(self.nodes)
        assert new_idx <= MAX_NODES
        node.parent = NIL_IDX
        self.nodes.append(node)
        self.root_ids.append(new_idx)
        return new_idx

    def insert_root(self, root: Fig, root_pos: int) -> FigIdx:
        """O(n) positional root insert with index remapping
        (fignodes.nim:332-350)."""
        insert_idx = self._root_insert_index(root_pos)
        self._shift_indexes(insert_idx, 1)
        node = root.copy()
        node.parent = NIL_IDX
        self._insert_nodes(insert_idx, [node])
        self.root_ids.insert(root_pos, insert_idx)
        self._recompute_child_counts()
        return insert_idx

    def add_child(self, parent_idx: FigIdx, child: Fig) -> FigIdx:
        """O(1) append of a child (fignodes.nim:352-374)."""
        return self._add_child_owned(parent_idx, child.copy())

    def _add_child_owned(self, parent_idx: FigIdx, node: Fig) -> FigIdx:
        assert self._valid_idx(parent_idx)
        new_idx = len(self.nodes)
        assert new_idx <= MAX_NODES
        self.nodes[parent_idx].child_count += 1
        node.parent = parent_idx
        self.nodes.append(node)
        return new_idx

    def insert_child(self, parent_idx: FigIdx, child: Fig, child_pos: int) -> FigIdx:
        """O(n) positional child insert (fignodes.nim:376-400)."""
        insert_idx = self._child_insert_index(parent_idx, child_pos)
        self._shift_indexes(insert_idx, 1)
        shifted_parent = parent_idx + 1 if parent_idx >= insert_idx else parent_idx
        node = child.copy()
        node.parent = shifted_parent
        self._insert_nodes(insert_idx, [node])
        self._recompute_child_counts()
        return insert_idx

    def insert_children(
        self, parent_idx: FigIdx, children: "RenderList", child_pos: int
    ) -> List[FigIdx]:
        """Splice a whole RenderList under parent_idx (fignodes.nim:402-434)."""
        assert self._valid_idx(parent_idx)
        if not children.nodes:
            return []
        insert_idx = self._child_insert_index(parent_idx, child_pos)
        self._shift_indexes(insert_idx, len(children.nodes))
        shifted_parent = (
            parent_idx + len(children.nodes)
            if parent_idx >= insert_idx
            else parent_idx
        )
        nodes = children._remapped_nodes(insert_idx, shifted_parent)
        self._insert_nodes(insert_idx, nodes)
        out: List[FigIdx] = []
        for root_idx in children.root_ids:
            assert 0 <= root_idx < len(children.nodes)
            out.append(insert_idx + root_idx)
        self._recompute_child_counts()
        return out

    def add_children(self, parent_idx: FigIdx, children: "RenderList") -> List[FigIdx]:
        return self.insert_children(
            parent_idx, children, self.nodes[parent_idx].child_count
        )


class Renders:
    """ZLevel → RenderList layer table with insertion-order iteration
    (fignodes.nim:48-49, 448-553)."""

    __slots__ = ("layers",)

    def __init__(self) -> None:
        self.layers: Dict[ZLevel, RenderList] = {}

    def __getitem__(self, lvl: ZLevel) -> RenderList:
        if lvl not in self.layers:
            self.layers[lvl] = RenderList()
        return self.layers[lvl]

    def __contains__(self, lvl: ZLevel) -> bool:
        return lvl in self.layers

    def pairs(self):
        return self.layers.items()

    def sorted_pairs(self):
        """Layers in ascending ZLevel draw order.

        Note the reference iterates its OrderedTable in *insertion* order
        (figrender.nim:1951); callers there insert in ZLevel order. We sort to
        make draw order deterministic regardless of insertion order, matching
        the renderer's documented "ZLevel-ordered layers" contract.
        """
        return sorted(self.layers.items(), key=lambda kv: kv[0])

    def set_layer(self, lvl: ZLevel, lst: RenderList) -> None:
        self.layers[lvl] = lst

    def clear(self) -> None:
        self.layers.clear()

    def len(self, lvl: ZLevel) -> int:
        if lvl in self.layers:
            return len(self.layers[lvl].nodes)
        return 0

    def add_root(self, lvl_or_root, root: Optional[Fig] = None) -> FigIdx:
        if root is None:
            node_in = lvl_or_root
            lvl = node_in.zlevel
        else:
            lvl = lvl_or_root
            node_in = root
        node = node_in.copy()
        node.zlevel = lvl
        return self[lvl]._add_root_owned(node)

    def insert_root(self, *args) -> FigIdx:
        if len(args) == 3:
            lvl, root, root_pos = args
        else:
            root, root_pos = args
            lvl = root.zlevel
        node = root.copy()
        node.zlevel = lvl
        return self[lvl].insert_root(node, root_pos)

    def add_child(self, lvl: ZLevel, parent_idx: FigIdx, child: Fig) -> FigIdx:
        node = child.copy()
        node.zlevel = lvl
        return self[lvl]._add_child_owned(parent_idx, node)

    def insert_child(
        self, lvl: ZLevel, parent_idx: FigIdx, child: Fig, child_pos: int
    ) -> FigIdx:
        node = child.copy()
        node.zlevel = lvl
        return self[lvl].insert_child(parent_idx, node, child_pos)

    def insert_children(
        self, lvl: ZLevel, parent_idx: FigIdx, children: RenderList, child_pos: int
    ) -> List[FigIdx]:
        nodes = children._remapped_nodes(0, NIL_IDX)
        for n in nodes:
            n.zlevel = lvl
        child_list = RenderList(nodes=nodes, root_ids=list(children.root_ids))
        child_list._recompute_child_counts()
        return self[lvl].insert_children(parent_idx, child_list, child_pos)

    def add_children(
        self, lvl: ZLevel, parent_idx: FigIdx, children: RenderList
    ) -> List[FigIdx]:
        return self.insert_children(
            lvl, parent_idx, children, self[lvl].nodes[parent_idx].child_count
        )


def new_renders() -> Renders:
    return Renders()
