"""Texture atlas: host-side skyline packer and one RGBA array
(figdraw_tpu/atlas.py, copied: the port may not import the JAX package).

A square RGBA texture packed by a column-height ("skyline") allocator with
a per-entry margin, growing by doubling and repacking on overflow. Entries
map image keys to normalized UV rects. The packed pixels live in one NumPy
array; the renderer uploads it (or its dirty rects) to the device, where
the tile kernels sample it. Packing is identical to the JAX package's: the
same calls give the same `entries` and byte-identical `data`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, Optional, Tuple

import numpy as np


@dataclass
class AtlasEntryMeta:
    kind: str = "image"  # "image" | "glyph" | "generated"
    image_id: int = 0
    font_id: int = 0
    typeface_id: int = 0


class Atlas:
    def __init__(self, size: int = 512, margin: int = 4):
        self.size = int(size)
        self.margin = int(margin)
        self.data = np.zeros((self.size, self.size, 4), dtype=np.float32)
        self.heights = np.zeros(self.size, dtype=np.int32)
        # key -> (x, y, w, h) normalized uv rect
        self.entries: Dict[Hashable, Tuple[float, float, float, float]] = {}
        self.meta: Dict[Hashable, AtlasEntryMeta] = {}
        self._images: Dict[Hashable, np.ndarray] = {}  # retained for repack
        self.generation = 1
        self.entries_version = 0  # bumped on any entry add/move/remove
        self.rebuild_count = 0
        self.dirty = True
        self.full_dirty = True  # whole-array upload needed (resize/first use)
        self.dirty_rects = []  # (x, y, w, h) px regions changed since upload

    # --- packing (glcontext.nim:541-579) -------------------------------------

    def _find_empty_rect(self, w: int, h: int) -> Optional[Tuple[int, int]]:
        """Lowest-skyline placement for a (w+2·margin, h+2·margin) block;
        the returned spot is the block corner — the entry itself is inset by
        margin on every side (findEmptyRect, glcontext.nim:541-579), so no
        entry ever touches the atlas border. That transparent surround is
        load-bearing: GL-parity bilinear sampling at image edges blends the
        margin in (the golden's ~15% background bleed on border rows); an
        entry at the border would clamp-to-edge instead."""
        bw = w + 2 * self.margin
        bh = h + 2 * self.margin
        if bw > self.size or bh > self.size:
            return None
        best_x = -1
        best_y = self.size + 1
        x = 0
        heights = self.heights
        while x + bw <= self.size:
            y = int(heights[x : x + bw].max())
            if y + bh <= self.size and y < best_y:
                best_y = y
                best_x = x
            x += 1
        if best_x < 0:
            return None
        return best_x, best_y

    def _place(self, key: Hashable, img: np.ndarray) -> bool:
        h, w = img.shape[0], img.shape[1]
        spot = self._find_empty_rect(w, h)
        if spot is None:
            return False
        bx, by = spot
        x, y = bx + self.margin, by + self.margin
        self.data[y : y + h, x : x + w] = img
        self.heights[bx : bx + w + 2 * self.margin] = np.maximum(
            self.heights[bx : bx + w + 2 * self.margin], by + h + 2 * self.margin
        )
        s = float(self.size)
        self.entries[key] = (x / s, y / s, w / s, h / s)
        self.dirty = True
        self.dirty_rects.append((x, y, w, h))
        self.entries_version += 1
        return True

    def _rebuild(self, new_size: int, grow: bool = False) -> None:
        """Repack every retained image into a new (new_size, new_size)
        array. grow (the growth of put_image): where they do not all fit,
        double again and repack, since a new image may be more than twice
        the old edge (figdraw_tpu's copy fails its assert there); else a
        misfit raises."""
        while True:
            self.size = new_size
            self.data = np.zeros((self.size, self.size, 4), dtype=np.float32)
            self.heights = np.zeros(self.size, dtype=np.int32)
            self.entries.clear()
            # a rebuild that re-places nothing (clear with no retained images)
            # must still invalidate every entries_version-keyed cache — the
            # packed-atlas tables and the renderer's ensured-glyph stamps
            self.entries_version += 1
            self.rebuild_count += 1
            self.generation += 1
            self.dirty = True
            self.full_dirty = True
            self.dirty_rects.clear()
            # a raise, not an assert: the placement must run under -O too
            if all(self._place(key, img) for key, img in self._images.items()):
                return
            if not grow:
                raise RuntimeError("atlas rebuild overflow")
            new_size *= 2

    @staticmethod
    def _normalize(img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32, copy=False)
        if img.ndim == 2:
            img = np.stack([img] * 4, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.ones(img.shape[:-1] + (1,), np.float32)], axis=-1
            )
        return img

    # --- public API ------------------------------------------------------------

    def put_image(
        self,
        key: Hashable,
        img,
        meta: Optional[AtlasEntryMeta] = None,
        mipmapped: bool = False,
        mips=None,
    ) -> None:
        img = self._normalize(img)
        if key in self.entries:
            self.remove(key)
        self._images[key] = img
        while not self._place(key, img):
            self._rebuild(self.size * 2, grow=True)
        if meta is not None:
            self.meta[key] = meta
        if mips is not None:
            # precomputed chain from a .flippy container (utils/flippy.py)
            for level, mip in enumerate(mips, start=1):
                if min(mip.shape[0], mip.shape[1]) < 8:
                    break
                mip = self._normalize(mip)
                mip_key = (key, level)
                self._images[mip_key] = mip
                while not self._place(mip_key, mip):
                    self._rebuild(self.size * 2, grow=True)
                if meta is not None:
                    self.meta[mip_key] = meta
        elif mipmapped:
            # flippy-style mip chain (common/formatflippy.nim:101-112): each
            # level is a 2x box-filtered half, packed under (key, level) so the
            # flattener can pick the level matching the draw scale.
            level = 1
            current = img
            while min(current.shape[0], current.shape[1]) >= 8:
                h2, w2 = current.shape[0] // 2, current.shape[1] // 2
                current = (
                    current[: h2 * 2 : 2, : w2 * 2 : 2]
                    + current[1 : h2 * 2 : 2, : w2 * 2 : 2]
                    + current[: h2 * 2 : 2, 1 : w2 * 2 : 2]
                    + current[1 : h2 * 2 : 2, 1 : w2 * 2 : 2]
                ) * 0.25
                mip_key = (key, level)
                self._images[mip_key] = current
                while not self._place(mip_key, current):
                    self._rebuild(self.size * 2, grow=True)
                if meta is not None:
                    self.meta[mip_key] = meta
                level += 1

    def update_image(self, key: Hashable, img) -> None:
        """In-place pixel replace when dimensions match
        (figbackend.nim:369-389)."""
        img = self._normalize(img)
        r = self.entries.get(key)
        if r is None:
            self.put_image(key, img)
            return
        x = round(r[0] * self.size)
        y = round(r[1] * self.size)
        h, w = img.shape[0], img.shape[1]
        if round(r[2] * self.size) != w or round(r[3] * self.size) != h:
            self.put_image(key, img)
            return
        self.data[y : y + h, x : x + w] = img
        self._images[key] = img
        self.dirty = True
        self.dirty_rects.append((x, y, w, h))

    def remove(self, key: Hashable) -> None:
        if key in self.entries:
            self.entries_version += 1
        self.entries.pop(key, None)
        self.meta.pop(key, None)
        self._images.pop(key, None)
        # pixels stay until next rebuild; skyline space is not reclaimed,
        # matching the reference packer.

    def clear(self) -> None:
        self._images.clear()
        self.meta.clear()
        self._rebuild(self.size)

    def reset(self, minimum_size: int = 0) -> None:
        size = self.size
        while size < minimum_size:
            size *= 2
        self._rebuild(size)

    def __contains__(self, key: Hashable) -> bool:
        return key in self.entries

    def packed_area(self) -> int:
        return int(self.heights.max()) * self.size if self.size else 0

    def used_area(self) -> int:
        total = 0
        for (_x, _y, w, h) in self.entries.values():
            total += round(w * self.size) * round(h * self.size)
        return total
