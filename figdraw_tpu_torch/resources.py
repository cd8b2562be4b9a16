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

`load_image` reads an image file through the .flippy sidecar cache
(utils/flippy.py) and the port's own decoders (utils/imagefile.py: PNG,
JPEG, GIF, BMP, ICO, QOI, TIFF and WebP; another format raises
NotImplementedError)
and publishes it with its mip chain.
A host cache keeps each published image (and a loaded image's chain) by
id, as figdraw_tpu's does: put, replace and the clears keep it current,
and a later load_image of the same path publishes the cached pixels
without reading the file again.
"""

from __future__ import annotations

import enum
import itertools
import threading
import zlib
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


def image_id_from_path(path: str) -> ImageId:
    """Stable id for a file path: the crc32 of the path (never 0)."""
    return zlib.crc32(path.encode("utf-8")) or 1


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
    mips: Optional[tuple] = None  # a precomputed chain (.flippy), levels 1..n


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
                               mipmapped=msg.mipmapped, mips=msg.mips)
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

# the host image cache: id -> the published pixels, and a loaded image's
# mip chain (levels 1..n)
_image_cache: Dict[ImageId, np.ndarray] = {}
_mip_cache: Dict[ImageId, tuple] = {}
_image_cache_lock = threading.Lock()


def load_image(path: str, bus: Optional[ImageMessageBus] = None,
               mipmapped: bool = True, flippy_cache: bool = True) -> "ImageRef":
    """Load an image file and publish it to renderers (imgutils.nim:553-557);
    returns the ImageRef that owns it, under image_id_from_path(path).

    A mipmapped load goes through the .flippy sidecar cache, as the
    reference's pipeline does: alpha-bled, the full mip chain,
    Snappy-compressed, regenerated when the source file is newer
    (utils.flippy.read_image_cached); the message carries the chain as
    `mips`. flippy_cache=False (or mipmapped=False) decodes the file's
    pixels alone. A second load of a cached id reads no file. PNG, JPEG,
    GIF, BMP, ICO, QOI, TIFF and WebP decode (utils.imagefile); AVIF and
    PIL's other formats raise NotImplementedError; without g++ the decoders
    and the flippy cache raise."""
    image_id = image_id_from_path(path)
    with _image_cache_lock:
        cached = _image_cache.get(image_id)
        mips = _mip_cache.get(image_id)
    if cached is None:
        if mipmapped and flippy_cache:
            from .utils.flippy import read_image_cached

            flippy = read_image_cached(path)
            cached = flippy.mipmaps[0]
            mips = tuple(flippy.mipmaps[1:])
        else:
            from .utils.imagefile import read_image

            cached, mips = read_image(path), None
        with _image_cache_lock:
            _image_cache[image_id] = cached
            if mips is not None:
                _mip_cache[image_id] = mips
    b = bus or default_bus
    b.publish(ImageMsg(kind=ImageMsgKind.PutImage, id=image_id, image=cached,
                       mipmapped=mipmapped, mips=mips))
    return ImageRef(image_id, bus=b)


def _cache(image_id: ImageId, image) -> None:
    with _image_cache_lock:
        _image_cache[image_id] = image
        _mip_cache.pop(image_id, None)


def _evict(ids) -> None:
    with _image_cache_lock:
        for i in ids:
            _image_cache.pop(i, None)
            _mip_cache.pop(i, None)


def put_image(image_id: ImageId, image: np.ndarray,
              bus: Optional[ImageMessageBus] = None,
              mipmapped: bool = False) -> ImageId:
    """Publish an image under an explicit id. mipmapped: the renderer packs
    a box-filtered mip chain beside it, so minified draws blend two levels."""
    _cache(image_id, image)
    (bus or default_bus).publish(ImageMsg(kind=ImageMsgKind.PutImage,
                                          id=image_id, image=image,
                                          mipmapped=mipmapped))
    return image_id


def replace_image(image_id: ImageId, image: np.ndarray,
                  bus: Optional[ImageMessageBus] = None) -> None:
    """In-place replace (video or canvas streams): same size updates the
    atlas entry's pixels, another size repacks it."""
    _cache(image_id, image)
    (bus or default_bus).publish(ImageMsg(kind=ImageMsgKind.ReplaceImage,
                                          id=image_id, image=image))


def clear_image(image_id: ImageId, bus: Optional[ImageMessageBus] = None) -> None:
    (bus or default_bus).publish(ImageMsg(kind=ImageMsgKind.ClearImage,
                                          id=image_id))
    _evict((image_id,))


def clear_images(ids, bus: Optional[ImageMessageBus] = None) -> None:
    ids = tuple(ids)
    (bus or default_bus).publish(ImageMsg(kind=ImageMsgKind.ClearImages, ids=ids))
    _evict(ids)


def clear_image_cache(bus: Optional[ImageMessageBus] = None) -> None:
    (bus or default_bus).publish(ImageMsg(kind=ImageMsgKind.ClearImageCache))
    with _image_cache_lock:
        _image_cache.clear()
        _mip_cache.clear()


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
        if final:
            self._final_release()

    def _final_release(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if not getattr(self, "_closed", True):
            self.close()


class ImageRef(_OwnedRef):
    """RAII image handle (resources.ImageRef): its final release evicts the
    image from every renderer's atlas and from the host cache."""

    _retain, _release = ImageMsgKind.RetainImage, ImageMsgKind.ReleaseImage
    _refcounts: Dict[ImageId, int] = {}
    _rc_lock = threading.Lock()

    def _message(self, kind, final: bool) -> ImageMsg:
        return ImageMsg(kind=kind, id=self.id, owner_token=self._token,
                        final_release=final)

    def _final_release(self) -> None:
        _evict((self.id,))  # the host cache drops the image with its last owner


class FontRef(_OwnedRef):
    """RAII font handle (resources.FontRef): its final release clears the
    font's glyphs from every renderer's atlas."""

    _retain, _release = ImageMsgKind.RetainFont, ImageMsgKind.ReleaseFont
    _refcounts: Dict[FontId, int] = {}
    _rc_lock = threading.Lock()

    def _message(self, kind, final: bool) -> ImageMsg:
        return ImageMsg(kind=kind, font_id=self.id, owner_token=self._token,
                        final_release=final)
