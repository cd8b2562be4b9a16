"""Packed quad-record layout shared by the host tape packer and TPU kernels.

The reference streams per-vertex attribute arrays to the GPU
(the reference renderer's glcontext.nim:76-94). On TPU we flatten
each emitted quad to one fixed-width f32 record (plus an i32 lane for the
packed sdf mode and mask index), so a whole pass is two dense HBM arrays:

    fields: (N, QF_WIDTH) float32
    modes:  (N, 2)        int32   [packed_sdf_mode, mask_read_index]

Quad geometry is stored as the inverse affine map from screen space to the
quad's (u, v) parameter square — the TPU-native equivalent of the GL
rasterizer interpolating per-vertex uv over two triangles. For the
parallelograms figdraw emits this is exact.
"""

# --- f32 field offsets -------------------------------------------------------

# Inverse affine: [u, v]^T = INV * (p - origin)
QF_INV_A = 0  # du/dx
QF_INV_B = 1  # du/dy
QF_INV_C = 2  # dv/dx
QF_INV_D = 3  # dv/dy
QF_ORG_X = 4  # screen-space position of the uv=(0,0) corner (TL vertex)
QF_ORG_Y = 5

# Screen-space AABB for binning
QF_BBOX_X0 = 6
QF_BBOX_Y0 = 7
QF_BBOX_X1 = 8
QF_BBOX_Y1 = 9

# Texture-uv affine: tex_uv = UV3 + u * DU + v * DV  (identity for SDF quads)
QF_UV3_X = 10
QF_UV3_Y = 11
QF_UVDU_X = 12
QF_UVDU_Y = 13
QF_UVDV_X = 14
QF_UVDV_Y = 15

# Per-vertex colors, normalized RGBA, vertex order 0=BL 1=BR 2=TR 3=TL
# (matches gradientColors order, figbackend.nim:161-183)
QF_COLOR0 = 16  # .. 19
QF_COLOR1 = 20  # .. 23
QF_COLOR2 = 24  # .. 27
QF_COLOR3 = 28  # .. 31

# linear3 fill extra colors
QF_MID_COLOR = 32  # .. 35
QF_STOP_COLOR = 36  # .. 39

# sdfParams / sdfRadii / sdfFactors exactly as the GL vertex streams
QF_PARAMS = 40  # .. 43
QF_RADII = 44  # .. 47
QF_FACTORS = 48  # .. 49

QF_AA = 50  # per-quad AA factor (GL: uniform changed via flush)
QF_SUBPIXEL_SHIFT = 51

# Rect-mask fast path (glcontext.nim:831-850): params(cx,cy,hx,hy),
# packed radii, inverse-transform rows matX/matY. params.z < 0 → disabled.
QF_RECT_PARAMS = 52  # .. 55
QF_RECT_RADII = 56  # .. 59
QF_RECT_MATX = 60  # .. 63
QF_RECT_MATY = 64  # .. 67

QF_WIDTH = 68  # pad target; keep a multiple of 4

# --- i32 lanes ----------------------------------------------------------------

QI_MODE = 0  # packed: sdf_mode + 128*elliptical + 256*fill_mode
QI_MASK = 1  # mask texture read index (0 = no mask / all-white)
QI_WIDTH = 2

# --- packed upload (wire) layout ----------------------------------------------
# Every tape color is u8-quantized (the walks write c/255.0f), so the 24
# color columns [16, 40) ride the wire as 6 little-endian u8x4 words and
# re-expand bit-identically (k/255.0f is the same IEEE op). 70 -> 52
# columns = 26% less tunnel time, the bottleneck at dense-scene scale.
#   [0:16)  logical cols 0..15    [16:22) 6 color words
#   [22:50) logical cols 40..67   [50:52) mode lanes (bitcast)
PACKED_WIDTH = 52  # incl. the 2 mode lanes
PACKED_MODES = 50  # column of the first mode lane


def pack_fields_np(fields, modes, out=None):
    """numpy packer (the C++ twin is fd_export_combo_packed): (n, 68) f32 +
    (n, 2) i32 -> (n, 52) f32 packed rows."""
    import numpy as np

    n = fields.shape[0]
    if out is None:
        out = np.empty((n, PACKED_WIDTH), np.float32)
    out[:, :16] = fields[:, :16]
    k = np.rint(fields[:, 16:40] * 255.0).astype(np.uint32)
    np.clip(k, 0, 255, out=k)
    words = (
        k[:, 0::4] | (k[:, 1::4] << 8) | (k[:, 2::4] << 16) | (k[:, 3::4] << 24)
    )
    out[:, 16:22] = words.view(np.float32)
    out[:, 22:50] = fields[:, 40:68]
    out[:, 50:52] = modes.view(np.float32)
    return out


def unpack_fields_np(packed):
    """Inverse of pack_fields_np: (n, >=52) packed rows -> ((n, 68) f32
    fields, (n, 2) i32 modes), bit-identical to the pre-pack tape."""
    import numpy as np

    n = packed.shape[0]
    fields = np.empty((n, QF_WIDTH), np.float32)
    fields[:, :16] = packed[:, :16]
    words = packed[:, 16:22].view(np.uint32)
    for b in range(4):
        fields[:, 16 + b : 40 + b : 4] = (
            ((words >> (8 * b)) & 0xFF).astype(np.float32) / 255.0
        )
    fields[:, 40:68] = packed[:, 22:50]
    modes = packed[:, 50:52].view(np.int32).copy()
    return fields, modes
