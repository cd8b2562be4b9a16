"""Host utilities of the port (figdraw_tpu/utils, copied or written anew):
the PNG decoder (png.py), the .flippy mip container and Snappy codec
(flippy.py), SDF generation from coverage (sdfgen.py), the perf spans and
logging helpers (perf.py), and the g++ build of the port's host libraries
(gxx.py)."""
