"""Fill enums (figdraw_tpu/fill.py, trimmed to what the array-form scene
uses: the FILL_DTYPE `kind` and `axis` codes)."""

from __future__ import annotations

import enum


class FillGradientAxis(enum.IntEnum):
    fgaX = 0
    fgaY = 1
    fgaDiagTLBR = 2
    fgaDiagBLTR = 3


class FillKind(enum.IntEnum):
    flColor = 0
    flLinear2 = 1
    flLinear3 = 2
