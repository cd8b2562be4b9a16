"""Runtime configuration from environment variables (figdraw_tpu/config.py,
the part the port uses):

  FIGDRAW_UI_SCALE / HDI   the global UI scale (basics.set_fig_ui_scale)
  FIGDRAW_DATA_DIR         the asset root (fig_data_dir), where the text
                           host pipeline will look for fonts

The JAX package's rasterizer switches (FIGDRAW_BACKEND, FIGDRAW_FORCE_XLA)
have no counterpart: the port has no fallback chain. Its text switches come
with the text host pipeline, and FIGDRAW_ATLAS11 is a TPU experiment the
port does not carry.
"""

from __future__ import annotations

import os

_data_dir = os.path.join(os.getcwd(), "data")


def fig_data_dir() -> str:
    return _data_dir


def set_fig_data_dir(path: str) -> None:
    global _data_dir
    _data_dir = path


def apply_startup_env() -> None:
    """Reads FIGDRAW_DATA_DIR and FIGDRAW_UI_SCALE (or HDI) once, at import
    of the package; a scale that does not parse as a float is ignored."""
    data_dir = os.environ.get("FIGDRAW_DATA_DIR")
    if data_dir:
        set_fig_data_dir(data_dir)
    scale = os.environ.get("FIGDRAW_UI_SCALE") or os.environ.get("HDI")
    if scale:
        try:
            from .basics import set_fig_ui_scale

            set_fig_ui_scale(float(scale))
        except ValueError:
            pass
