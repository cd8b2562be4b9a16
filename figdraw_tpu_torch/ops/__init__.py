"""Device ops of the port: decode helpers, binning, blur, the SDF evaluator
and the tile rasterizer."""
