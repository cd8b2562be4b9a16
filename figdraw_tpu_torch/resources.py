"""The image message bus: thread-safe publication of images, glyphs and
font lifetimes to renderers (figdraw_tpu/resources.py).

Any thread publishes put / replace / clear messages for images and glyphs,
glyph clears per font or typeface, and the retain / release messages of
the RAII `ImageRef` and `FontRef` handles (the final release evicts); each
renderer drains its subscription at the top of `render_frame` and applies
them to its atlas. Publishing fans a copy to every subscriber's bounded
ring inbox (the oldest is dropped on overflow); a replay table keeps the
latest put or replace per id, so a new subscriber sees all live images;
per-id and cache generations let the consumer drop stale messages.

Not ported yet (ROADMAP.md, port item 'Overlays and the image surface'):
`load_image` and its .flippy mip cache, which decode through PIL.
"""

from __future__ import annotations

import enum
import itertools
import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

ImageId = int
FontId = int
TypefaceId = int
OwnerToken = int

_id_counter = itertools.count(1)


def next_owner_token() -> OwnerToken:
    return next(_id_counter)


class ImageMsgKind(enum.Enum):
    PutImage = "put-image"
    PutGlyph = "put-glyph"
    ReplaceImage = "replace-image"
    ClearImage = "clear-image"
    ClearImages = "clear-images"
    ClearImageCache = "clear-image-cache"
    ClearFontGlyphs = "clear-font-glyphs"
    ClearTypefaceGlyphs = "clear-typeface-glyphs"
    RetainImage = "retain-image"
    ReleaseImage = "release-image"
    RetainFont = "retain-font"
    ReleaseFont = "release-font"


@dataclass(frozen=True)
class ImageMsg:
    kind: ImageMsgKind
    id: ImageId = 0
    ids: tuple = ()
    image: Optional[np.ndarray] = None  # (h, w, 4) uint8 or float32
    generation: int = 0
    cache_generation: int = 0
    font_id: FontId = 0
    typeface_id: TypefaceId = 0
    owner_token: OwnerToken = 0
    final_release: bool = False
    mipmapped: bool = False


class ImageMessageSubscription:
    """Bounded ring inbox; a push past capacity drops the oldest message."""

    def __init__(self, capacity: int = 512):
        self._inbox: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def _push(self, msg: ImageMsg) -> None:
        with self._lock:
            self._inbox.append(msg)

    def drain(self) -> List[ImageMsg]:
        with self._lock:
            out = list(self._inbox)
            self._inbox.clear()
        return out


class ImageMessageBus:
    """Publish/subscribe hub with replay."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: List[ImageMessageSubscription] = []
        self._replay: Dict[ImageId, ImageMsg] = {}
        self._generations: Dict[ImageId, int] = {}
        self._cache_generation = 1

    def message_current(self, msg: ImageMsg) -> bool:
        """Staleness check applied by the consumer: a put or replace is
        current while no later put, replace or clear of its id (or of the
        whole cache) was published."""
        with self._lock:
            if msg.cache_generation != self._cache_generation:
                return False
            return msg.generation == self._generations.get(msg.id, 0)

    def subscribe(self) -> ImageMessageSubscription:
        """A new subscription; replays the live images into it."""
        sub = ImageMessageSubscription()
        with self._lock:
            self._subs.append(sub)
            for msg in self._replay.values():
                sub._push(msg)
        return sub

    def replay_to(self, sub: ImageMessageSubscription) -> None:
        """Send the live images to a subscription again, after its renderer
        rebuilt its atlas (imgutils.nim:206-215)."""
        with self._lock:
            for msg in self._replay.values():
                sub._push(msg)

    def publish(self, msg: ImageMsg) -> ImageMsg:
        """Stamp a put or replace with its generations, update the replay
        table, and push the message to every subscriber. Returns the
        message as pushed."""
        with self._lock:
            if msg.kind in (ImageMsgKind.PutImage, ImageMsgKind.ReplaceImage):
                gen = self._generations.get(msg.id, 0) + 1
                self._generations[msg.id] = gen
                msg = ImageMsg(kind=msg.kind, id=msg.id, image=msg.image,
                               generation=gen,
                               cache_generation=self._cache_generation,
                               mipmapped=msg.mipmapped)
                self._replay[msg.id] = msg
            elif msg.kind == ImageMsgKind.ClearImage:
                self._replay.pop(msg.id, None)
                self._generations.pop(msg.id, None)
            elif msg.kind == ImageMsgKind.ClearImages:
                for i in msg.ids:
                    self._replay.pop(i, None)
                    self._generations.pop(i, None)
            elif msg.kind == ImageMsgKind.ClearImageCache:
                self._replay.clear()
                self._generations.clear()
                self._cache_generation += 1
            for sub in self._subs:
                sub._push(msg)
        return msg


# the process-wide bus renderers subscribe to when given none
default_bus = ImageMessageBus()


def put_image(image_id: ImageId, image: np.ndarray,
              bus: Optional[ImageMessageBus] = None,
              mipmapped: bool = False) -> ImageId:
    """Publish an image under an explicit id. mipmapped: the renderer packs
    a box-filtered mip chain beside it, so minified draws blend two levels."""
    (bus or default_bus).publish(ImageMsg(kind=ImageMsgKind.PutImage,
                                          id=image_id, image=image,
                                          mipmapped=mipmapped))
    return image_id


def replace_image(image_id: ImageId, image: np.ndarray,
                  bus: Optional[ImageMessageBus] = None) -> None:
    """In-place replace (video or canvas streams): same size updates the
    atlas entry's pixels, another size repacks it."""
    (bus or default_bus).publish(ImageMsg(kind=ImageMsgKind.ReplaceImage,
                                          id=image_id, image=image))


def clear_image(image_id: ImageId, bus: Optional[ImageMessageBus] = None) -> None:
    (bus or default_bus).publish(ImageMsg(kind=ImageMsgKind.ClearImage,
                                          id=image_id))


def clear_images(ids, bus: Optional[ImageMessageBus] = None) -> None:
    (bus or default_bus).publish(ImageMsg(kind=ImageMsgKind.ClearImages,
                                          ids=tuple(ids)))


def clear_image_cache(bus: Optional[ImageMessageBus] = None) -> None:
    (bus or default_bus).publish(ImageMsg(kind=ImageMsgKind.ClearImageCache))


def clear_font_glyphs(font_id: FontId, bus: Optional[ImageMessageBus] = None) -> None:
    (bus or default_bus).publish(
        ImageMsg(kind=ImageMsgKind.ClearFontGlyphs, font_id=font_id))


def clear_typeface_glyphs(typeface_id: TypefaceId,
                          bus: Optional[ImageMessageBus] = None) -> None:
    (bus or default_bus).publish(
        ImageMsg(kind=ImageMsgKind.ClearTypefaceGlyphs, typeface_id=typeface_id))


class _OwnedRef:
    """An RAII handle: publishes its retain message on creation and its
    release on close (or del); the release of the last live handle of an
    id carries final_release, which evicts (imgutils.nim:61-68, 217-325;
    typefaces.nim:36-70)."""

    _retain = _release = None
    _refcounts: Dict[int, int]
    _rc_lock: threading.Lock

    def __init__(self, ref_id: int, bus: Optional[ImageMessageBus] = None):
        self.id = ref_id
        self._bus = bus or default_bus
        self._token = next_owner_token()
        self._closed = False
        cls = type(self)
        with cls._rc_lock:
            cls._refcounts[ref_id] = cls._refcounts.get(ref_id, 0) + 1
        self._bus.publish(self._message(self._retain, False))

    def _message(self, kind, final: bool) -> ImageMsg:
        raise NotImplementedError

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        cls = type(self)
        with cls._rc_lock:
            rc = cls._refcounts.get(self.id, 1) - 1
            final = rc <= 0
            if final:
                cls._refcounts.pop(self.id, None)
            else:
                cls._refcounts[self.id] = rc
        self._bus.publish(self._message(self._release, final))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if not getattr(self, "_closed", True):
            self.close()


class ImageRef(_OwnedRef):
    """RAII image handle (resources.ImageRef)."""

    _retain, _release = ImageMsgKind.RetainImage, ImageMsgKind.ReleaseImage
    _refcounts: Dict[ImageId, int] = {}
    _rc_lock = threading.Lock()

    def _message(self, kind, final: bool) -> ImageMsg:
        return ImageMsg(kind=kind, id=self.id, owner_token=self._token,
                        final_release=final)


class FontRef(_OwnedRef):
    """RAII font handle (resources.FontRef): its final release clears the
    font's glyphs from every renderer's atlas."""

    _retain, _release = ImageMsgKind.RetainFont, ImageMsgKind.ReleaseFont
    _refcounts: Dict[FontId, int] = {}
    _rc_lock = threading.Lock()

    def _message(self, kind, final: bool) -> ImageMsg:
        return ImageMsg(kind=kind, font_id=self.id, owner_token=self._token,
                        final_release=final)
