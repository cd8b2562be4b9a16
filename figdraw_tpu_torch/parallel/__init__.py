"""Rendering across several devices (figdraw_tpu/parallel): parallel/sharding.py."""
