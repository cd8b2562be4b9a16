"""figdraw_tpu_torch — the PyTorch/CUDA port of figdraw_tpu.

`FigRenderer.render_frame` on array-form scenes of SDF shapes, clip masks
and images, through the frame executor, the rolled executor and the
megakernel, with the tile rasterizer (and its atlas sampler) and the
megakernel as hand-written CUDA kernels for Hopper (csrc/). figdraw_tpu, the
JAX package beside it, is the reference it is tested against; this package
imports torch and numpy only.
"""

from .basics import FigFlags, FigKind, ShadowStyle, StrokeCap  # noqa: F401
from .colors import Color, ColorRGBA, as_color, rgba  # noqa: F401
from .fill import FillGradientAxis, FillKind  # noqa: F401
from .geometry import Rect, Vec2, rect, vec2  # noqa: F401
from .nodesarray import RenderListArray, RendersArray  # noqa: F401
from .renderer import FigRenderer  # noqa: F401
from .scenes import make_render_tree_array  # noqa: F401
