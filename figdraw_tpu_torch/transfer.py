"""Generic user-tree to Renders conversion, plus a debug tree view
(figdraw_tpu/transfer.py, copied): `copy_into` walks any duck-typed node
tree (objects exposing kind/screen_box/flags/zlevel/children/fill/...),
converts each node to a Fig and splits children into new roots whenever
the zlevel changes; `to_tree` builds a plain id-tree for structural
assertions in tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .basics import FigFlags, FigKind, corner_to_u16
from .colors import Color, ColorRGBA
from .fill import Fill, fill as make_fill
from .nodes import Fig, FigIdx, NIL_IDX, RenderList, Renders, ZLevel, drawable_rect
from .geometry import rect


@dataclass
class RenderTree:
    """Plain structural tree for test assertions (transfer.nim:4-6)."""

    id: int = 0
    children: List["RenderTree"] = field(default_factory=list)

    def __getitem__(self, idx: int) -> "RenderTree":
        if not self.children:
            return RenderTree()
        return self.children[idx]

    def __eq__(self, other) -> bool:
        if other is None:
            return False
        return self.id == other.id and self.children == other.children


def to_tree(list_or_nodes, idx: Optional[FigIdx] = None) -> RenderTree:
    """transfer.nim:33-42."""
    if idx is None and isinstance(list_or_nodes, RenderList):
        root = RenderTree()
        for root_idx in list_or_nodes.root_ids:
            root.children.append(to_tree(list_or_nodes, root_idx))
        return root
    lst = list_or_nodes
    tree = RenderTree(id=idx)
    for ci in lst.child_index(idx):
        tree.children.append(to_tree(lst, ci))
    return tree


def _as_fill(v) -> Fill:
    if isinstance(v, Fill):
        return v
    if isinstance(v, (ColorRGBA, Color)):
        return make_fill(v)
    return Fill()


def to_render_fig(current) -> Fig:
    """Duck-typed node → Fig (transfer.nim:44-163). Attributes are read with
    getattr fallbacks, the Python equivalent of the reference's compiles()
    dispatch."""
    node = Fig(kind=FigKind(current.kind))
    node.screen_box = current.screen_box
    node.flags = FigFlags(getattr(current, "flags", 0))
    node.zlevel = getattr(current, "zlevel", 0)
    node.rotation = getattr(current, "rotation", 0.0)
    node.fill = _as_fill(getattr(current, "fill", None))
    corners = getattr(current, "corners", None)
    if corners is not None:
        node.corners = tuple(corner_to_u16(c) for c in corners)
    corners_y = getattr(current, "corner_radii_y", None)
    if corners_y is not None:
        node.corner_radii_y = tuple(corner_to_u16(c) for c in corners_y)

    kind = node.kind
    if kind == FigKind.nkRectangle:
        stroke = getattr(current, "stroke", None)
        if stroke is not None:
            from .basics import RenderStroke

            stroke_fill = _as_fill(
                getattr(stroke, "fill", getattr(stroke, "color", None))
            )
            node.stroke = RenderStroke(
                weight=getattr(stroke, "weight", 0.0), fill=stroke_fill
            )
        shadows = getattr(current, "shadows", ())
        out_shadows = []
        from .basics import RenderShadow, ShadowStyle

        for orig in shadows:
            out_shadows.append(
                RenderShadow(
                    style=getattr(orig, "style", ShadowStyle.NoShadow),
                    blur=getattr(orig, "blur", 0.0),
                    x=getattr(orig, "x", 0.0),
                    y=getattr(orig, "y", 0.0),
                    spread=getattr(orig, "spread", 0.0),
                    fill=_as_fill(
                        getattr(orig, "fill", getattr(orig, "color", None))
                    ),
                )
            )
        node.shadows = tuple(out_shadows)
    elif kind == FigKind.nkImage:
        image = getattr(current, "image", None)
        if image is not None:
            from .basics import ImageStyle

            node.image = ImageStyle(
                id=getattr(image, "id", 0),
                fill=_as_fill(getattr(image, "fill", getattr(image, "color", None))),
            )
    elif kind == FigKind.nkMsdfImage:
        if getattr(current, "msdf_image", None) is not None:
            node.msdf_image = current.msdf_image
    elif kind == FigKind.nkMtsdfImage:
        if getattr(current, "mtsdf_image", None) is not None:
            node.mtsdf_image = current.mtsdf_image
    elif kind == FigKind.nkBackdropBlur:
        from .basics import BackdropBlurStyle

        bb = getattr(current, "backdrop_blur", None)
        if bb is not None:
            node.backdrop_blur = bb
        else:
            node.backdrop_blur = BackdropBlurStyle(blur=getattr(current, "blur", 0.0))
    elif kind == FigKind.nkTransform:
        from .basics import TransformStyle

        tr = getattr(current, "transform", None)
        if tr is not None:
            node.transform = tr
        else:
            node.transform = TransformStyle(
                translation=getattr(current, "translation", None),
                matrix=getattr(current, "matrix", None),
            )
    elif kind == FigKind.nkText:
        node.text_layout = getattr(current, "text_layout", None)
        node.selection_range = getattr(current, "selection_range", (0, -1))
    elif kind == FigKind.nkDrawable:
        from .basics import RenderStroke

        node.draw_stroke = getattr(
            current, "draw_stroke", getattr(current, "stroke", RenderStroke())
        )
        node.draw_steps = getattr(current, "draw_steps", 0)
        node.draw_aa = getattr(current, "draw_aa", 0.0)
        ops = getattr(current, "draw_ops", None)
        if ops is not None:
            node.draw_ops = tuple(ops)
        else:
            points = getattr(current, "points", None)
            if points is not None:
                node.draw_ops = tuple(
                    drawable_rect(
                        rect(p.x, p.y, node.screen_box.w, node.screen_box.h)
                    )
                    for p in points
                )
    return node


def _convert(renders: Renders, current, parent_idx: FigIdx, parent_zlevel: ZLevel) -> None:
    """transfer.nim:165-189: children whose zlevel differs from their parent
    become new roots of their own layer."""
    node = to_render_fig(current)
    zlvl = getattr(current, "zlevel", 0)

    layer = renders[zlvl]
    if parent_idx < 0 or parent_zlevel != zlvl:
        current_idx = layer.add_root(node)
    else:
        current_idx = layer.add_child(parent_idx, node)

    for child in getattr(current, "children", ()):
        if FigFlags.NfInactive in FigFlags(getattr(child, "flags", 0)):
            continue
        child_parent = current_idx if getattr(child, "zlevel", 0) == zlvl else NIL_IDX
        _convert(renders, child, child_parent, zlvl)


def copy_into(root) -> Renders:
    """transfer.nim:191-199: convert a whole user tree, layers sorted by
    ZLevel."""
    renders = Renders()
    _convert(renders, root, NIL_IDX, getattr(root, "zlevel", 0))
    renders.layers = dict(sorted(renders.layers.items(), key=lambda kv: kv[0]))
    return renders
