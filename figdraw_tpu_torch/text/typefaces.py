"""Typeface registry and font model (figdraw_tpu/text/typefaces.py, copied
with its faces read by the port's own OpenType reader, text/otf.py, in place
of fontTools).

Typefaces get a collision-salted content-hash TypefaceId, and fonts
(typeface, raster-relevant settings and UI scale) hash to a FontId.
Resolution order: explicit path, then the data dir, then the system font
dirs. bundled_font_path() names the font the repo carries
(figdraw_tpu_torch/fonts/DejaVuSans.ttf); it is a path, not a default, so
loading a file that does not exist still raises.
"""

from __future__ import annotations

import enum
import hashlib
import os
import sys
import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from ..config import fig_data_dir, set_fig_data_dir  # noqa: F401 - re-exported
from .otf import VARIATIONS_NOT_PORTED, OTFont, collection_size

TypefaceId = int
FontId = int
FontGlyphId = int

_SYSTEM_FONT_DIRS = [
    "/usr/share/fonts",
    "/usr/local/share/fonts",
    os.path.expanduser("~/.fonts"),
]

_FONTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "fonts")


def bundled_font_path(name: str = "DejaVuSans.ttf") -> str:
    """The path of a font the package carries (fonts/README.md names its
    source and sha256)."""
    return os.path.join(_FONTS_DIR, name)


@dataclass(frozen=True)
class FontFeature:
    tag: str
    value: int = 1


@dataclass(frozen=True)
class FontVariation:
    tag: str
    value: float


class FontCase:
    Normal = 0
    Upper = 1
    Lower = 2
    Title = 3


@dataclass(frozen=True)
class FigFont:
    """fonttypes.nim:62-75."""

    typeface_id: TypefaceId = 0
    size: float = 12.0
    line_height: float = 0.0  # 0 → default from metrics
    font_case: int = FontCase.Normal
    underline: bool = False
    strikethrough: bool = False
    no_kerning_adjustments: bool = False
    fallback_typeface_ids: Tuple[TypefaceId, ...] = ()
    language: str = ""
    features: Tuple[FontFeature, ...] = ()
    variations: Tuple[FontVariation, ...] = ()

    def with_size(self, size: float) -> "FigFont":
        return replace(self, size=size)


class Typeface:
    """A loaded font file: metrics, cmap, advances, kerning, outlines."""

    def __init__(self, path: str, data: bytes, typeface_id: TypefaceId, face_index: int = 0):
        self.path = path
        self.id = typeface_id
        self.face_index = face_index
        self._tt = OTFont(data, face_index)
        self.units_per_em = self._tt.units_per_em
        self.ascent = self._tt.ascent
        self.descent = self._tt.descent  # negative
        self.line_gap = self._tt.line_gap
        self.cmap = self._tt.getBestCmap() or {}
        self._glyph_order = self._tt.glyph_order
        self._name_to_gid = self._tt._name_to_gid
        self._kern = self._tt.kern_pairs()
        self.family_name = self._tt.debug_name(1) or os.path.basename(path)
        self.subfamily_name = self._tt.debug_name(2) or ""

    # --- glyph-level API -----------------------------------------------------

    def glyph_id(self, codepoint: int) -> FontGlyphId:
        name = self.cmap.get(codepoint)
        if name is None:
            return 0
        return self._name_to_gid.get(name, 0)

    def has_codepoint(self, codepoint: int) -> bool:
        return codepoint in self.cmap

    def glyph_name(self, gid: FontGlyphId) -> str:
        if 0 <= gid < len(self._glyph_order):
            return self._glyph_order[gid]
        return ".notdef"

    def advance(self, gid: FontGlyphId) -> float:
        """Advance width in font units."""
        return self._tt.advance(gid)

    def kerning(self, left_gid: FontGlyphId, right_gid: FontGlyphId) -> float:
        if not self._kern:
            return 0.0
        return self._kern.get(
            (self.glyph_name(left_gid), self.glyph_name(right_gid)), 0.0
        )

    def is_variable(self) -> bool:
        return "fvar" in self._tt

    def _check_location(self, variations) -> None:
        """A variable face draws only its default instance: a location away
        from it raises NotImplementedError (otf.VARIATIONS_NOT_PORTED)."""
        if variations and self.is_variable():
            location = {v.tag: float(v.value) for v in variations}
            if not self._tt.is_default_location(location):
                raise NotImplementedError(VARIATIONS_NOT_PORTED)

    def var_advance(self, gid: FontGlyphId, variations) -> float:
        """Advance width at a variation location, font units: the default
        instance's (a location away from it raises)."""
        self._check_location(variations)
        return self.advance(gid)

    def glyph_path(self, gid: FontGlyphId, variations=()):
        """Glyph outline as fontTools' DecomposingRecordingPen value list
        (font units), from the default instance (a location away from it
        raises)."""
        self._check_location(variations)
        return self._tt.glyph_path(gid)

    # --- scaled metrics ---------------------------------------------------------

    def scale_for(self, size: float) -> float:
        return size / self.units_per_em

    def default_line_height(self, size: float) -> float:
        s = self.scale_for(size)
        return (self.ascent - self.descent + self.line_gap) * s


# --- registry ----------------------------------------------------------------------

_registry_lock = threading.Lock()
_typefaces: Dict[TypefaceId, Typeface] = {}
_path_ids: Dict[str, TypefaceId] = {}
_id_digests: Dict[TypefaceId, bytes] = {}
_fonts: Dict[FontId, Tuple[FigFont, float]] = {}  # font id → (font, ui_scale)


def _resolve_path(name: str) -> Optional[str]:
    if os.path.isabs(name) and os.path.exists(name):
        return name
    candidates = [os.path.join(fig_data_dir(), name), name]
    for cand in candidates:
        if os.path.exists(cand):
            return cand
    # system font search by filename or family substring
    target = name.lower()
    for root in _SYSTEM_FONT_DIRS:
        if not os.path.isdir(root):
            continue
        for dirpath, _dirs, files in os.walk(root):
            for fn in files:
                if not fn.lower().endswith((".ttf", ".otf", ".ttc", ".otc")):
                    continue
                if fn.lower() == target or os.path.splitext(fn)[0].lower() == target:
                    return os.path.join(dirpath, fn)
    for root in _SYSTEM_FONT_DIRS:
        if not os.path.isdir(root):
            continue
        for dirpath, _dirs, files in os.walk(root):
            for fn in files:
                if fn.lower().endswith((".ttf", ".otf")) and target.replace(" ", "") in fn.lower().replace(" ", ""):
                    return os.path.join(dirpath, fn)
    return None


def _collection_face_index(path: str, face_name: str) -> int:
    """Face selection by name within a .ttc/.otc (typefaces.nim:141-181):
    exact family or full-name match first, then substring."""
    target = face_name.strip().lower()
    with open(path, "rb") as f:
        data = f.read()
    names = []
    for i in range(collection_size(data)):
        face = OTFont(data, i)
        family = (face.debug_name(1) or "").strip()
        full = (face.debug_name(4) or "").strip()
        names.append((i, family, full))
    for i, family, full in names:
        if family.lower() == target or full.lower() == target:
            return i
    for i, family, full in names:
        if target in family.lower() or target in full.lower():
            return i
    raise KeyError(
        f"face {face_name!r} not found in {path}; has "
        f"{[full or fam for _i, fam, full in names]}"
    )


def load_typeface(name: str, face_name: Optional[str] = None) -> TypefaceId:
    """Resolve + load + register; id is a salted content hash
    (typefaces.nim:186-200, 223-298). `face_name` selects a face inside a
    .ttc/.otc collection."""
    path = _resolve_path(name)
    if path is None:
        raise FileNotFoundError(f"typeface not found: {name}")
    face_index = 0
    if path.lower().endswith((".ttc", ".otc")):
        face_index = _collection_face_index(path, face_name) if face_name else 0
    cache_key = f"{path}#{face_index}"
    with _registry_lock:
        cached = _path_ids.get(cache_key)
        if cached is not None:
            return cached
    with open(path, "rb") as f:
        data = f.read()
    digest = hashlib.sha256(data + face_index.to_bytes(2, "little")).digest()
    typeface_id = int.from_bytes(digest[:8], "little") & 0x7FFFFFFFFFFFFFFF
    with _registry_lock:
        # identity is the CONTENT digest: identical bytes loaded through
        # different paths/aliases reuse the same id; only true digest
        # collisions salt (typefaces.nim:186-200)
        salt = 0
        while typeface_id in _typefaces and (
            _id_digests.get(typeface_id) != digest
        ):
            salt += 1
            typeface_id = (typeface_id + 0x9E3779B9 + salt) & 0x7FFFFFFFFFFFFFFF
        if typeface_id not in _typefaces:
            _typefaces[typeface_id] = Typeface(path, data, typeface_id, face_index)
            _id_digests[typeface_id] = digest
        _path_ids[cache_key] = typeface_id
    return typeface_id


def get_typeface(typeface_id: TypefaceId) -> Typeface:
    with _registry_lock:
        tf = _typefaces.get(typeface_id)
    if tf is None:
        raise KeyError(f"unknown typeface id {typeface_id}")
    return tf


def register_font(font: FigFont, ui_scale: float = 1.0) -> FontId:
    """FontId = hash of raster-relevant fields + ui scale
    (typefaces.nim:358-390)."""
    key = (
        font.typeface_id,
        round(font.size * 64),
        round(ui_scale * 64),
        font.font_case,
        tuple(font.variations),
    )
    font_id = hash(key) & 0x7FFFFFFFFFFFFFFF
    with _registry_lock:
        _fonts[font_id] = (font, ui_scale)
    return font_id


def get_fig_font(font_id: FontId) -> FigFont:
    with _registry_lock:
        entry = _fonts.get(font_id)
    if entry is None:
        raise KeyError(f"unknown font id {font_id}")
    return entry[0]


def find_system_font_file(family: str) -> Optional[str]:
    """extras/systemfonts.nim:55-137 equivalent (single-name form)."""
    return _resolve_path(family)


def default_font_paths() -> List[str]:
    out = []
    for root in _SYSTEM_FONT_DIRS:
        if os.path.isdir(root):
            out.append(root)
    return out


# --- dynamic font fallback (common/fontfallbacks.nim) ------------------------------


@dataclass
class FontFallbackRequest:
    """Codepoints the current typefaces don't cover; a resolver may return
    additional typeface ids to retry (fontfallbacks.nim:4-15)."""

    primary_typeface_id: TypefaceId
    existing_typeface_ids: Tuple[TypefaceId, ...]
    language: str
    script: str
    codepoints: Tuple[int, ...]


_fallback_local = threading.local()


def set_font_fallback_resolver(resolver) -> None:
    """Installs a per-thread resolver called by typeset() when neither the
    font nor its static fallback_typeface_ids cover a codepoint
    (fontfallbacks.nim:17-25 setFontFallbackResolver). `resolver` takes a
    FontFallbackRequest and returns an iterable of TypefaceIds (typefaces
    it loads itself via load_typeface); None uninstalls."""
    _fallback_local.resolver = resolver


def font_fallback_resolver():
    """The resolver installed on the current thread, or None."""
    return getattr(_fallback_local, "resolver", None)


def script_of_codepoint(cp: int) -> str:
    """Four-letter script tag for a codepoint, a hint the fallback resolver
    requests carry. The JAX package reads it from fontTools' Unicode data;
    the port carries none, so it is "" (the contract's value where that
    data is absent)."""
    return ""


# --- system font discovery (extras/systemfonts.nim) --------------------------------


class SystemFontRole(enum.IntEnum):
    """systemfonts.nim:11-13 SystemFontRole (sfrSans/sfrMono)."""

    Sans = 0
    Mono = 1


def detect_display_server() -> str:
    """systemfonts.nim:25-32 detectDisplayServer — "wayland" | "x11" |
    "unknown" (posix only; a TPU host is usually headless → unknown)."""
    if sys.platform.startswith(("linux", "freebsd")):
        if os.environ.get("WAYLAND_DISPLAY"):
            return "wayland"
        if os.environ.get("DISPLAY"):
            return "x11"
    return "unknown"


def system_default_font_names(role: SystemFontRole = SystemFontRole.Sans) -> List[str]:
    """Platform-default family candidates per role
    (systemfonts.nim:55-76 systemDefaultFontNames)."""
    if sys.platform == "win32":
        return (["Cascadia Mono", "Consolas", "Courier New"]
                if role == SystemFontRole.Mono
                else ["Segoe UI", "Arial", "Tahoma", "Verdana"])
    if sys.platform == "darwin":
        return (["Menlo", "SF Mono", "Monaco"]
                if role == SystemFontRole.Mono
                else ["Helvetica", "Arial", "SFNS"])
    if os.name == "posix":
        return (["Noto Sans Mono", "DejaVu Sans Mono", "Liberation Mono",
                 "Ubuntu Mono"]
                if role == SystemFontRole.Mono
                else ["Noto Sans", "DejaVu Sans", "Liberation Sans", "Ubuntu"])
    return []


def system_font_dirs(display_server: Optional[str] = None) -> List[str]:
    """Existing platform font directories, XDG-aware on posix
    (systemfonts.nim:78-110 systemFontDirs)."""
    if display_server is None:
        display_server = detect_display_server()
    dirs: List[str] = []

    def add(path: str) -> None:
        if path:
            p = os.path.expanduser(path)
            if os.path.isdir(p) and _norm_path_key(p) not in {
                _norm_path_key(d) for d in dirs
            }:
                dirs.append(p)

    if sys.platform == "darwin":
        add("/System/Library/Fonts")
        add("/Library/Fonts")
        add("~/Library/Fonts")
    elif os.name == "posix":
        home = os.path.expanduser("~")
        xdg_data_home = os.environ.get(
            "XDG_DATA_HOME", os.path.join(home, ".local", "share")
        )
        add(os.path.join(xdg_data_home, "fonts"))
        for base in os.environ.get(
            "XDG_DATA_DIRS", "/usr/local/share:/usr/share"
        ).split(os.pathsep):
            if base:
                add(os.path.join(base, "fonts"))
        add("/usr/share/fonts")
        add("/usr/local/share/fonts")
        # Wayland desktops use the XDG dirs; X11/headless also scan ~/.fonts
        if display_server != "wayland":
            add(os.path.join(home, ".fonts"))
    return dirs


def system_font_files(display_server: Optional[str] = None) -> List[str]:
    """Font files under the platform font dirs, deduped case-insensitively
    (systemfonts.nim:112-129 systemFontFiles)."""
    exts = tuple(supported_font_file_extensions())
    seen = set()
    out: List[str] = []
    for root in system_font_dirs(display_server):
        for dirpath, _dirs, files in os.walk(root, onerror=lambda e: None):
            for fn in files:
                if fn.lower().endswith(exts):
                    path = os.path.join(dirpath, fn)
                    key = _norm_path_key(path)
                    if key not in seen:
                        seen.add(key)
                        out.append(path)
    return out


def _norm_name(name: str) -> str:
    """systemfonts.nim:15-20 normalizeName: lowercase [a-z0-9] only."""
    return "".join(ch for ch in name.lower() if ch.isascii() and ch.isalnum())


def _norm_path_key(path: str) -> str:
    return path.lower().replace("\\", "/")


def find_system_font_file_from(names, display_server: Optional[str] = None) -> str:
    """Preferred system font path matching one of the candidate names; exact
    normalized file/stem matches beat loose partial matches, so "Times New
    Roman" is not captured by Times.ttc first
    (systemfonts.nim:131-160 findSystemFontFile)."""
    names = list(names)
    if not names:
        return ""
    files = system_font_files(display_server)
    stems = [(f, _norm_name(os.path.splitext(os.path.basename(f))[0]))
             for f in files]
    for name in names:
        want = _norm_name(name)
        if not want:
            continue
        for path, stem in stems:
            if stem == want:
                return path
        for path, stem in stems:
            if want in stem:
                return path
    return ""


def apply_font_case(text: str, font_case: int) -> str:
    if font_case == FontCase.Upper:
        return text.upper()
    if font_case == FontCase.Lower:
        return text.lower()
    if font_case == FontCase.Title:
        return text.title()
    return text


# --- backend information (fonttypes.nim textBackend/textBackendFeatures) ---------


def text_backend() -> str:
    """The compiled text backend name. The reference builds one of pixie /
    harfbuzzy / hybrid (fonttypes.nim:131-143); the JAX package reports its
    fontTools stack as "fonttools"; the port's stack (its own OpenType
    reader, the OpenType mini-shaper, the scanline rasterizer) reports
    "otf"."""
    return "otf"


def text_backend_features() -> list:
    """Capability list in the reference's vocabulary (ttext_backend_info.nim):
    what a harfbuzzy-class backend advertises, minus what this one lacks."""
    return [
        "opentype-shaping",
        "outline-rasterization",
        "bidirectional-text",
        "font-fallback",
        "opentype-features",
        "font-variations",
        "mark-attachment",
        "mark-filtering-sets",
        "arabic-joining",
        "indic-shaping",
    ]


def supported_font_file_extensions() -> list:
    return [".ttf", ".otf", ".ttc", ".otc"]
