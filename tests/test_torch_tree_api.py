"""The tree-form scene API of figdraw_tpu_torch against figdraw_tpu's own
tests of it: test_nodes.py (RenderList and Renders index remapping),
test_fragments.py (RenderFragments, the walk over fragments),
test_transform.py (the Python walk on a recording backend: 18 cases of
corner propagation, transform composition, bezier and arc decomposition,
caps, joins and the AA override), test_transfer_debug.py (copy_into,
to_tree, visibility, hit testing, color_at) and the border-op cases of
test_misc.py.

Each JAX test is run a second time as the port's twin: its source, with
its `figdraw_tpu` imports pointed at `figdraw_tpu_torch`, is compiled into
a module of its own, so the twin builds its scene with the port's API from
the same numbers and makes the same assertions. The JAX package's run of
the same test is its own file's.
"""

import pytest

from torch_twin import port_twin, test_names as _test_names

# test_misc.py's border cases are its first four; test_border_figs_render
# renders through figdraw_tpu's FigRenderer and is twinned, against the JAX
# frame, in test_torch_tree_walk.py
CASES = [
    (mod, fn)
    for mod, skip in (("test_nodes", ()), ("test_fragments", ()),
                      ("test_transform", ()), ("test_transfer_debug", ()))
    for fn in _test_names(mod, skip)
] + [("test_misc", fn) for fn in ("test_solid_border_ops",
                                  "test_dashed_border_ops_cover_path",
                                  "test_dotted_border_ops")]


def test_the_twins_cover_every_case():
    """18 cases pin the Python walk in test_transform.py; none of the
    twinned files' tests is left out."""
    by_mod = {}
    for mod, fn in CASES:
        by_mod.setdefault(mod, []).append(fn)
    assert len(by_mod["test_transform"]) == 18
    for mod in ("test_nodes", "test_fragments", "test_transform",
                "test_transfer_debug"):
        assert by_mod[mod] == _test_names(mod)


@pytest.mark.parametrize("mod,fn", CASES, ids=[f"{m}::{f}" for m, f in CASES])
def test_port_twin(mod, fn):
    twin = port_twin(mod)
    # the twin really runs on the port: nothing it names comes from the
    # JAX package
    assert twin.new_renders.__module__ == "figdraw_tpu_torch.nodes"
    assert not [k for k, v in vars(twin).items()
                if getattr(v, "__module__", "").split(".")[0] == "figdraw_tpu"]
    getattr(twin, fn)()
