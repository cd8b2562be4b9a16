"""figdraw_tpu_torch's Unicode script table (text/scripts.py) against the
fontTools it was taken from, and the port's script_of_codepoint against
figdraw_tpu's (which asks fontTools.unicodedata) on every codepoint of the
BMP and a seeded sample of the other planes."""

import numpy as np
import pytest
from fontTools import unicodedata as ftu
from fontTools.unicodedata import Scripts as ft_scripts

from figdraw_tpu.text import typefaces as jax_tf
from figdraw_tpu_torch.text import scripts
from figdraw_tpu_torch.text import typefaces as port_tf


def test_the_table_equals_fonttools():
    assert list(scripts.RANGES) == list(ft_scripts.RANGES)
    assert list(scripts.VALUES) == list(ft_scripts.VALUES)
    assert len(scripts.RANGES) == len(scripts.VALUES)
    assert scripts.RANGES[0] == 0 and list(scripts.RANGES) == sorted(set(scripts.RANGES))


@pytest.mark.parametrize("block", range(16))
def test_every_bmp_codepoint_equals_the_reference(block):
    """4096 codepoints a case, surrogates and private use included."""
    cps = range(block * 4096, (block + 1) * 4096)
    got = [port_tf.script_of_codepoint(cp) for cp in cps]
    want = [jax_tf.script_of_codepoint(cp) for cp in cps]
    assert got == want
    assert got == [ftu.script(chr(cp)) for cp in cps]


@pytest.mark.parametrize("plane", range(1, 17))
def test_a_sample_of_each_other_plane_equals_the_reference(plane):
    """Every range start and the codepoint before it in the plane, plus 2000
    seeded codepoints of it."""
    lo, hi = plane << 16, (plane + 1) << 16
    starts = [r for r in scripts.RANGES if lo <= r < hi]
    rng = np.random.default_rng(plane)
    cps = sorted({*starts, *(s - 1 for s in starts if s > lo), lo, hi - 1,
                  *rng.integers(lo, hi, 2000).tolist()})
    assert [port_tf.script_of_codepoint(cp) for cp in cps] == [
        jax_tf.script_of_codepoint(cp) for cp in cps]


def test_known_tags_and_what_is_no_codepoint():
    for ch, tag in (("a", "Latn"), (",", "Zyyy"), ("क", "Deva"), ("́", "Zinh"),
                    ("あ", "Hira"), ("\U00013000", "Egyp"), ("\U0010FFFF", "Zzzz")):
        assert port_tf.script_of_codepoint(ord(ch)) == tag
    for cp in (-1, 0x110000):
        assert port_tf.script_of_codepoint(cp) == jax_tf.script_of_codepoint(cp) == ""
