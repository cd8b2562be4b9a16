"""Typeface metadata inspection (figdraw_tpu/text/typeface_info.py, copied
onto the port's OpenType reader, text/otf.py): family and localized names,
codepoint coverage ranges with supports_codepoint, variable-font axes and
OpenType layout scripts and languages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .typefaces import TypefaceId, get_typeface

# BCP-47 tags of name-record language ids (fontTools' registry, which the
# JAX package reads): Windows LCIDs and Macintosh language codes
WINDOWS_LANGUAGES = {
    0x436: "af", 0x41c: "sq", 0x484: "gsw", 0x45e: "am", 0x1401: "ar-DZ",
    0x3c01: "ar-BH", 0xc01: "ar", 0x801: "ar-IQ", 0x2c01: "ar-JO", 0x3401:
    "ar-KW", 0x3001: "ar-LB", 0x1001: "ar-LY", 0x1801: "ary", 0x2001:
    "ar-OM", 0x4001: "ar-QA", 0x401: "ar-SA", 0x2801: "ar-SY", 0x1c01:
    "aeb", 0x3801: "ar-AE", 0x2401: "ar-YE", 0x42b: "hy", 0x44d: "as",
    0x82c: "az-Cyrl", 0x42c: "az", 0x46d: "ba", 0x42d: "eu", 0x423: "be",
    0x845: "bn", 0x445: "bn-IN", 0x201a: "bs-Cyrl", 0x141a: "bs", 0x47e:
    "br", 0x402: "bg", 0x403: "ca", 0xc04: "zh-HK", 0x1404: "zh-MO", 0x804:
    "zh", 0x1004: "zh-SG", 0x404: "zh-TW", 0x483: "co", 0x41a: "hr", 0x101a:
    "hr-BA", 0x405: "cs", 0x406: "da", 0x48c: "prs", 0x465: "dv", 0x813:
    "nl-BE", 0x413: "nl", 0xc09: "en-AU", 0x2809: "en-BZ", 0x1009: "en-CA",
    0x2409: "en-029", 0x4009: "en-IN", 0x1809: "en-IE", 0x2009: "en-JM",
    0x4409: "en-MY", 0x1409: "en-NZ", 0x3409: "en-PH", 0x4809: "en-SG",
    0x1c09: "en-ZA", 0x2c09: "en-TT", 0x809: "en-GB", 0x409: "en", 0x3009:
    "en-ZW", 0x425: "et", 0x438: "fo", 0x464: "fil", 0x40b: "fi", 0x80c:
    "fr-BE", 0xc0c: "fr-CA", 0x40c: "fr", 0x140c: "fr-LU", 0x180c: "fr-MC",
    0x100c: "fr-CH", 0x462: "fy", 0x456: "gl", 0x437: "ka", 0xc07: "de-AT",
    0x407: "de", 0x1407: "de-LI", 0x1007: "de-LU", 0x807: "de-CH", 0x408:
    "el", 0x46f: "kl", 0x447: "gu", 0x468: "ha", 0x40d: "he", 0x439: "hi",
    0x40e: "hu", 0x40f: "is", 0x470: "ig", 0x421: "id", 0x45d: "iu", 0x85d:
    "iu-Latn", 0x83c: "ga", 0x434: "xh", 0x435: "zu", 0x410: "it", 0x810:
    "it-CH", 0x411: "ja", 0x44b: "kn", 0x43f: "kk", 0x453: "km", 0x486:
    "quc", 0x487: "rw", 0x441: "sw", 0x457: "kok", 0x412: "ko", 0x440: "ky",
    0x454: "lo", 0x426: "lv", 0x427: "lt", 0x82e: "dsb", 0x46e: "lb", 0x42f:
    "mk", 0x83e: "ms-BN", 0x43e: "ms", 0x44c: "ml", 0x43a: "mt", 0x481:
    "mi", 0x47a: "arn", 0x44e: "mr", 0x47c: "moh", 0x450: "mn", 0x850:
    "mn-CN", 0x461: "ne", 0x414: "nb", 0x814: "nn", 0x482: "oc", 0x448:
    "or", 0x463: "ps", 0x415: "pl", 0x416: "pt", 0x816: "pt-PT", 0x446:
    "pa", 0x46b: "qu-BO", 0x86b: "qu-EC", 0xc6b: "qu", 0x418: "ro", 0x417:
    "rm", 0x419: "ru", 0x243b: "smn", 0x103b: "smj-NO", 0x143b: "smj",
    0xc3b: "se-FI", 0x43b: "se", 0x83b: "se-SE", 0x203b: "sms", 0x183b:
    "sma-NO", 0x1c3b: "sms", 0x44f: "sa", 0x1c1a: "sr-Cyrl-BA", 0xc1a: "sr",
    0x181a: "sr-Latn-BA", 0x81a: "sr-Latn", 0x46c: "nso", 0x432: "tn",
    0x45b: "si", 0x41b: "sk", 0x424: "sl", 0x2c0a: "es-AR", 0x400a: "es-BO",
    0x340a: "es-CL", 0x240a: "es-CO", 0x140a: "es-CR", 0x1c0a: "es-DO",
    0x300a: "es-EC", 0x440a: "es-SV", 0x100a: "es-GT", 0x480a: "es-HN",
    0x80a: "es-MX", 0x4c0a: "es-NI", 0x180a: "es-PA", 0x3c0a: "es-PY",
    0x280a: "es-PE", 0x500a: "es-PR", 0xc0a: "es", 0x40a: "es", 0x540a:
    "es-US", 0x380a: "es-UY", 0x200a: "es-VE", 0x81d: "sv-FI", 0x41d: "sv",
    0x45a: "syr", 0x428: "tg", 0x85f: "tzm", 0x449: "ta", 0x444: "tt",
    0x44a: "te", 0x41e: "th", 0x451: "bo", 0x41f: "tr", 0x442: "tk", 0x480:
    "ug", 0x422: "uk", 0x42e: "hsb", 0x420: "ur", 0x843: "uz-Cyrl", 0x443:
    "uz", 0x42a: "vi", 0x452: "cy", 0x488: "wo", 0x485: "sah", 0x478: "ii",
    0x46a: "yo"
}
MAC_LANGUAGES = {
    0: "en", 1: "fr", 2: "de", 3: "it", 4: "nl", 5: "sv", 6: "es", 7: "da",
    8: "pt", 9: "no", 10: "he", 11: "ja", 12: "ar", 13: "fi", 14: "el", 15:
    "is", 16: "mt", 17: "tr", 18: "hr", 19: "zh-Hant", 20: "ur", 21: "hi",
    22: "th", 23: "ko", 24: "lt", 25: "pl", 26: "hu", 27: "es", 28: "lv",
    29: "se", 30: "fo", 31: "fa", 32: "ru", 33: "zh", 34: "nl-BE", 35: "ga",
    36: "sq", 37: "ro", 38: "cz", 39: "sk", 40: "sl", 41: "yi", 42: "sr",
    43: "mk", 44: "bg", 45: "uk", 46: "be", 47: "uz", 48: "kk", 49:
    "az-Cyrl", 50: "az-Arab", 51: "hy", 52: "ka", 53: "mo", 54: "ky", 55:
    "tg", 56: "tk", 57: "mn-CN", 58: "mn", 59: "ps", 60: "ks", 61: "ku", 62:
    "sd", 63: "bo", 64: "ne", 65: "sa", 66: "mr", 67: "bn", 68: "as", 69:
    "gu", 70: "pa", 71: "or", 72: "ml", 73: "kn", 74: "ta", 75: "te", 76:
    "si", 77: "my", 78: "km", 79: "lo", 80: "vi", 81: "id", 82: "tl", 83:
    "ms", 84: "ms-Arab", 85: "am", 86: "ti", 87: "om", 88: "so", 89: "sw",
    90: "rw", 91: "rn", 92: "ny", 93: "mg", 94: "eo", 128: "cy", 129: "eu",
    130: "ca", 131: "la", 132: "qu", 133: "gn", 134: "ay", 135: "tt", 136:
    "ug", 137: "dz", 138: "jv", 139: "su", 140: "gl", 141: "af", 142: "br",
    143: "iu", 144: "gd", 145: "gv", 146: "ga", 147: "to", 148:
    "el-polyton", 149: "kl", 150: "az", 151: "nn"
}


@dataclass
class VariationAxis:
    tag: str
    min_value: float
    default_value: float
    max_value: float
    name: str = ""


@dataclass
class TypefaceInfo:
    family: str = ""
    subfamily: str = ""
    full_name: str = ""
    postscript_name: str = ""
    localized_names: Dict[str, str] = field(default_factory=dict)
    coverage_ranges: List[Tuple[int, int]] = field(default_factory=list)
    glyph_count: int = 0
    units_per_em: int = 0
    variation_axes: List[VariationAxis] = field(default_factory=list)
    layout_scripts: List[str] = field(default_factory=list)
    layout_languages: List[str] = field(default_factory=list)

    def supports_codepoint(self, cp: int) -> bool:
        """Binary search over coverage ranges (typefaceinfos.nim:57-63)."""
        lo, hi = 0, len(self.coverage_ranges) - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            start, end = self.coverage_ranges[mid]
            if cp < start:
                hi = mid - 1
            elif cp > end:
                lo = mid + 1
            else:
                return True
        return False


def _coverage_ranges(codepoints) -> List[Tuple[int, int]]:
    cps = sorted(codepoints)
    ranges: List[Tuple[int, int]] = []
    for cp in cps:
        if ranges and cp == ranges[-1][1] + 1:
            ranges[-1] = (ranges[-1][0], cp)
        else:
            ranges.append((cp, cp))
    return ranges


def get_typeface_info(typeface_id: TypefaceId) -> TypefaceInfo:
    tf = get_typeface(typeface_id)
    tt = tf._tt
    info = TypefaceInfo(
        family=tf.family_name,
        subfamily=tf.subfamily_name,
        units_per_em=tf.units_per_em,
        glyph_count=len(tf._glyph_order),
        coverage_ranges=_coverage_ranges(tf.cmap.keys()),
    )
    info.full_name = tt.debug_name(4) or ""
    info.postscript_name = tt.debug_name(6) or ""
    # BCP-47 language tags for localized family names (typefaceinfos.nim
    # localizedNames): unknown ids keep the numeric key
    for rec in tt.name_records():
        if rec.nameID == 1:
            try:
                if rec.platformID == 3:
                    tag = WINDOWS_LANGUAGES.get(rec.langID, str(rec.langID))
                elif rec.platformID == 1:
                    tag = MAC_LANGUAGES.get(rec.langID, str(rec.langID))
                else:
                    tag = str(rec.langID)
                info.localized_names[tag] = rec.toUnicode()
            except UnicodeDecodeError:
                pass
    for axis in tt.fvar_axes():
        info.variation_axes.append(
            VariationAxis(
                tag=axis.axisTag,
                min_value=axis.minValue,
                default_value=axis.defaultValue,
                max_value=axis.maxValue,
            )
        )
    for table_tag in ("GSUB", "GPOS"):
        found = tt.get(table_tag)
        if found is None or found.table.ScriptList is None:
            continue
        for rec in found.table.ScriptList.ScriptRecord:
            if rec.ScriptTag not in info.layout_scripts:
                info.layout_scripts.append(rec.ScriptTag)
            for lrec in rec.Script.LangSysRecord:
                if lrec.LangSysTag not in info.layout_languages:
                    info.layout_languages.append(lrec.LangSysTag)
    return info
