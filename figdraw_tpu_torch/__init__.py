"""figdraw_tpu_torch — the PyTorch/CUDA port of figdraw_tpu.

`FigRenderer.render_frame` on array-form scenes of SDF shapes, clip masks
and images, through the frame executor, the rolled executor and the
megakernel, and device-resident scenes (`snapshot_scene`, `render_view`,
`render_views`, `update_scene`), with the tile rasterizer (and its atlas
sampler), the megakernel, the row transform of a resident scene and the
backdrop blur as hand-written CUDA kernels for Hopper (csrc/). figdraw_tpu, the
JAX package beside it, is the reference it is tested against; this package
imports torch and numpy only.
"""

from .basics import FigFlags, FigKind, ShadowStyle, StrokeCap  # noqa: F401
from .colors import Color, ColorRGBA, as_color, rgba  # noqa: F401
from .fill import Fill, FillGradientAxis, FillKind, fill, linear  # noqa: F401
from .geometry import Rect, Vec2, rect, vec2  # noqa: F401
from .nodesarray import RenderListArray, RendersArray  # noqa: F401
from .renderer import FigRenderer  # noqa: F401
from .scene import DeviceScene  # noqa: F401
from .scenes import make_render_tree_array  # noqa: F401
