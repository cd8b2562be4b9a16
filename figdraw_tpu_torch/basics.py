"""Scene-graph enums (figdraw_tpu/basics.py, trimmed to the codes the
array-form scene writes into FIG_DTYPE rows)."""

from __future__ import annotations

import enum


class FigKind(enum.IntEnum):
    nkFrame = 0
    nkText = 1
    nkRectangle = 2
    nkDrawable = 3
    nkScrollBar = 4
    nkImage = 5
    nkMsdfImage = 6
    nkMtsdfImage = 7
    nkBackdropBlur = 8
    nkTransform = 9


class FigFlags(enum.IntFlag):
    NfClipContent = 1 << 0
    NfDisableRender = 1 << 1
    NfRootWindow = 1 << 2
    NfInactive = 1 << 3
    NfSelectText = 1 << 4
    NfInvertY = 1 << 5
    NfRectMaskContent = 1 << 6
    NfEllipticalCorners = 1 << 7


class ShadowStyle(enum.IntEnum):
    NoShadow = 0
    DropShadow = 1
    InnerShadow = 2


class StrokeCap(enum.IntEnum):
    scAuto = 0
    scRound = 1
    scButt = 2
    scSquare = 3


class DrawableKind(enum.IntEnum):
    """OP_DTYPE `kind` codes (figdraw_tpu/nodes.py DrawableKind)."""

    dkLine = 0
    dkCircle = 1
    dkRectangle = 2
    dkBezier = 3
    dkArc = 4
    dkEllipse = 5
