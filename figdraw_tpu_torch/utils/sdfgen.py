"""Signed-distance-field generation from coverage rasters
(figdraw_tpu/utils/sdfgen.py, copied: the port may not import the JAX
package; the numpy operations run in the same order, so the float32 output
is bit-equal to figdraw_tpu's).

The reference consumes externally generated MSDF/MTSDF assets (msdf_star
example; nkMsdfImage nodes). This utility generates single-channel SDFs from
any coverage raster (glyph rasters, icons) so scalable SDF rendering works
without external tooling: with r=g=b=sd the shader's median(r,g,b) is the
SDF itself, and the alpha channel doubles as the MTSDF plane.

Distance transform: Felzenszwalb & Huttenlocher's exact two-pass 1D EDT
(squared parabolas), numpy-only.
"""

from __future__ import annotations

import numpy as np

INF = 1e18


def _edt_1d(f: np.ndarray) -> np.ndarray:
    """Exact 1D squared-distance transform of a sampled function f."""
    n = f.shape[-1]
    d = np.empty_like(f)
    v = np.zeros(n, dtype=np.int64)
    z = np.empty(n + 1, dtype=np.float64)

    for row in range(f.shape[0]):
        fr = f[row]
        k = 0
        v[0] = 0
        z[0] = -INF
        z[1] = INF
        for q in range(1, n):
            while True:
                p = v[k]
                s = ((fr[q] + q * q) - (fr[p] + p * p)) / (2.0 * q - 2.0 * p)
                if s <= z[k]:
                    k -= 1
                else:
                    break
            k += 1
            v[k] = q
            z[k] = s
            z[k + 1] = INF
        k = 0
        for q in range(n):
            while z[k + 1] < q:
                k += 1
            p = v[k]
            d[row, q] = (q - p) * (q - p) + fr[p]
    return d


def distance_transform(mask: np.ndarray) -> np.ndarray:
    """Euclidean distance (px) from every pixel to the nearest True pixel."""
    f = np.where(mask, 0.0, INF).astype(np.float64)
    d = _edt_1d(f)  # along rows
    d = _edt_1d(np.ascontiguousarray(d.T)).T  # along cols
    return np.sqrt(d)


def sdf_from_coverage(coverage: np.ndarray, px_range: float = 4.0,
                      pad: int = 0) -> np.ndarray:
    """Coverage (h, w) in [0, 1] → (h+2p, w+2p, 4) SDF image for
    nkMsdfImage/nkMtsdfImage (sd encoded as sd/px_range + 0.5, clipped).

    Sub-pixel accuracy at the contour comes from offsetting the integer EDT
    by the boundary pixels' coverage-implied distance.
    """
    if pad:
        coverage = np.pad(coverage, pad)
    inside = coverage >= 0.5
    d_out = distance_transform(inside)  # distance to the shape, outside
    d_in = distance_transform(~inside)  # distance to the exterior, inside
    sd = np.where(inside, d_in - 0.5, -(d_out - 0.5))
    # refine the anti-aliased contour ring with the coverage (linear edge
    # model: coverage c ≈ sd + 0.5 for |sd| < 0.5)
    boundary = (coverage > 0.01) & (coverage < 0.99)
    sd = np.where(boundary, coverage - 0.5, sd)
    enc = np.clip(sd / px_range + 0.5, 0.0, 1.0).astype(np.float32)
    out = np.stack([enc, enc, enc, enc], axis=-1)
    return out


def glyph_sdf(typeface, glyph_id: int, size: float, px_range: float = 4.0):
    """Rasterize a glyph (the port's text.raster.rasterize_glyph) and
    convert it to an SDF image; returns (sdf image, image_offset) like
    rasterize_glyph, or None for a glyph with no outline."""
    from ..text.raster import rasterize_glyph

    result = rasterize_glyph(typeface, glyph_id, size)
    if result is None:
        return None
    img, (ox, oy) = result
    pad = int(np.ceil(px_range))
    sdf = sdf_from_coverage(img[..., 3], px_range=px_range, pad=pad)
    return sdf, (ox - pad, oy - pad)
