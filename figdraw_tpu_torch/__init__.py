"""figdraw_tpu_torch — the PyTorch/CUDA port of figdraw_tpu.

`FigRenderer.render_frame` on scenes of SDF shapes, clip masks, images and
text:
array-form scenes (`RendersArray`) through the native walk, and tree-form
scenes (`Fig` nodes in a `Renders` or a `RenderFragments`) through the
Python walk, at the global UI scale and the renderer's pixel scale; the
frame executor, the rolled executor and the megakernel; device-resident
scenes (`snapshot_scene`, `render_view`, `render_views`, `update_scene`).
Text typesets on the host (text/: the port's own OpenType reader, shaping,
bidi, typesetting and the glyph raster) and draws from the atlas.
The tile rasterizer (and its atlas sampler), the megakernel, the binning,
the row transform of a resident scene and the backdrop blur are
hand-written CUDA kernels for Hopper (csrc/). figdraw_tpu, the JAX package
beside it, is the reference it is tested against; this package imports
torch and numpy only.

The names below are figdraw_tpu's umbrella exports that the port has, so an
example's `from figdraw_tpu import ...` line works with the package name
replaced. `load_image` is not ported yet.
"""

from .basics import (  # noqa: F401
    BackdropBlurStyle,
    CornerRadii2D,
    DirectionCorners,
    DropShadow,
    FigFlags,
    FigKind,
    ImageStyle,
    InnerShadow,
    MsdfImageStyle,
    NfClipContent,
    NfDisableRender,
    NfEllipticalCorners,
    NfInactive,
    NfInvertY,
    NfRectMaskContent,
    NfRootWindow,
    NfSelectText,
    NoShadow,
    RenderShadow,
    RenderStroke,
    SHADOW_COUNT,
    ShadowStyle,
    StrokeCap,
    StrokeJoin,
    TransformStyle,
    ZLevel,
    descaled,
    fig_ui_scale,
    image_style,
    init_corner_radii_2d,
    scaled,
    set_fig_ui_scale,
    to_corner_radii,
)
from .colors import (  # noqa: F401
    BLACK_COLOR,
    BLUE_COLOR,
    CLEAR_COLOR,
    Color,
    ColorRGBA,
    WHITE_COLOR,
    as_color,
    color,
    rgba,
)
from .fill import (  # noqa: F401
    Fill,
    FillGradientAxis,
    FillKind,
    center_color,
    fill,
    fill_alpha_max,
    linear,
    sample_color,
)

fgaX = FillGradientAxis.fgaX
fgaY = FillGradientAxis.fgaY
fgaDiagTLBR = FillGradientAxis.fgaDiagTLBR
fgaDiagBLTR = FillGradientAxis.fgaDiagBLTR

from .geometry import Mat3, Rect, Vec2, rect, root_affine, vec2  # noqa: F401,E402
from .nodes import (  # noqa: F401,E402
    DrawableKind,
    DrawableOp,
    Fig,
    FigIdx,
    RenderList,
    Renders,
    drawable_arc,
    drawable_bezier,
    drawable_circle,
    drawable_ellipse,
    drawable_line,
    drawable_rect,
    new_renders,
)
from .backend import (  # noqa: F401,E402
    BackendContext,
    BackendFill,
    SdfMode,
    gradient_colors,
    to_backend_fill,
)
from .fragments import (  # noqa: F401,E402
    RenderCursor,
    RenderFragment,
    RenderFragments,
    new_render_fragments,
)
from .nodesarray import (  # noqa: F401,E402
    RenderListArray,
    RendersArray,
    from_renders,
    to_renders,
)
from .renderer import FigRenderer, new_fig_renderer  # noqa: F401,E402
from .scene import DeviceScene  # noqa: F401,E402
from .borders import (  # noqa: F401,E402
    fig_dashed_rounded_rect_border,
    fig_dotted_rounded_rect_border,
    fig_rounded_rect_border,
)
from .extras import fig_circle, fig_circle_xy, fig_line, fig_line_xy  # noqa: F401,E402
from .transfer import copy_into, to_tree  # noqa: F401,E402
from .resources import (  # noqa: F401,E402
    FontRef,
    ImageMessageBus,
    ImageRef,
    clear_font_glyphs,
    clear_image,
    clear_image_cache,
    clear_images,
    clear_typeface_glyphs,
    put_image,
    replace_image,
)
from .debugtools import (  # noqa: F401,E402
    FigLocation,
    FigVisibility,
    color_at,
    collect_debug_figs,
    fig_visibility,
    hits_at_point,
    top_fig_at_point,
)
from .text.typefaces import (  # noqa: F401,E402
    FigFont,
    FontFeature,
    FontVariation,
    load_typeface,
    register_font,
    supported_font_file_extensions,
    text_backend,
    text_backend_features,
)
from .text.layout import (  # noqa: F401,E402
    HAlign,
    VAlign,
    typeset,
    typeset_cached,
    typeset_for_measurement,
)
from .scenes import make_render_tree, make_render_tree_array  # noqa: F401,E402
from .config import apply_startup_env as _apply_startup_env  # noqa: E402

_apply_startup_env()
