"""The text host pipeline (figdraw_tpu/text, ported): the port's OpenType
reader, typefaces, shaping, typesetting, the glyph raster and glyph drawing."""
