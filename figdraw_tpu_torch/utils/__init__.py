"""Host utilities of the port (figdraw_tpu/utils, copied or written anew):
the image decoders (imagefile.py picks one by a file's leading bytes:
png.py, jpeg.py, gif.py, bmp.py, ico.py, qoi.py; image_lib.py binds their
C++ helper), the .flippy mip container and Snappy codec
(flippy.py), SDF generation from coverage (sdfgen.py), the perf spans and
logging helpers (perf.py), and the g++ build of the port's host libraries
(gxx.py)."""
