"""Device-resident scenes: the state `FigRenderer.snapshot_scene` parks on
the device and the host half of viewing, animating and patching it
(figdraw_tpu/renderer.py `DeviceScene` and its helpers, :74-507; single
device, packed layout).

A snapshot flattens a scene once and keeps its packed upload on the device.
A view then costs a camera upload, one row transform (ops/rows.py) into the
scene's scratch buffer and the executor: no walk, no plan, no tape upload.
The resident rows hold the snapshot's base geometry; cameras and per-root
affines are absolute and applied to a copy, so only `update_scene`'s patch
ever writes them (`index_copy_` in place, on 32-bit words).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import native
from .basics import fig_ui_scale
from .colors import Color
from .geometry import Mat3, vec2
from .nodesarray import RendersArray
from .ops.layout import PACKED_MODES, PACKED_WIDTH, QI_MASK
from .ops.rows import DAMAGE_RECTS, EMPTY_BBOX
from .plan import ROLLED_THRESHOLD, ExecPlan, build_rolled_items, from_jax_plan
from .tape import DrawItem


class DeviceScene:
    """A flattened scene resident in device memory (FigRenderer.
    snapshot_scene): render_view draws it under any camera without walking
    the scene again, and update_scene patches edited roots' rows in place.

    kind: "mega", "rolled" or "unrolled", the executor of plan. combo_dev:
    the resident packed rows, n_quads quad rows and then the meta tail;
    scratch: the transformed copy the executor reads. spans: (lvl,
    root_node_idx) -> (qs, qe) for the roots update_scene may patch, or None;
    anim_spans: the same for every root (a root that writes a mask plane
    animates, but never patches), or None when rows do not map 1:1 onto the
    tape (a mega layout with clear sentinels). pending_patch: (rows, idx) of
    an update not yet on the device; pending_damage: scene-space rects the
    edits since the last rendered frame could touch; last_cam and
    last_view_frame: that frame and its camera, the sources of a
    damage-clipped frame."""

    __slots__ = ("kind", "plan", "combo_dev", "scratch", "n_quads", "n_pad",
                 "spans", "atlas_generation", "snap_args", "pending_patch",
                 "pending_damage", "last_cam", "last_view_frame",
                 "anim_spans", "anim_order", "anim_slot", "anim_ridx_dev",
                 "anim_template")

    def __init__(self, kind: str, plan: ExecPlan, combo_dev: torch.Tensor,
                 n_quads: int, n_pad: int):
        self.kind = kind
        self.plan = plan
        self.combo_dev = combo_dev
        self.scratch = torch.empty_like(combo_dev)
        self.n_quads = n_quads
        self.n_pad = n_pad
        self.spans = None
        self.atlas_generation = 0
        self.snap_args = None
        self.pending_patch = None
        self.pending_damage = None
        self.last_cam = None
        self.last_view_frame = None
        self.anim_spans = None
        self.anim_order = None
        self.anim_slot = None
        self.anim_ridx_dev = None
        self.anim_template = None

    def animation_order(self):
        """The (zlevel, root_node_idx) keys in table-slot order for
        render_view's bulk (R, 6) root_transforms array; None when the
        snapshot has no per-root row mapping (snapshot with animate=True to
        get one)."""
        return anim_state(self)


def plan_kind(plan: ExecPlan) -> str:
    """The executor a plan runs on, as DeviceScene.kind names it."""
    if plan.mega_combo is not None:
        return "mega"
    return "rolled" if plan.rolled_items is not None else "unrolled"


def patch_staging(rows: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """One upload for a retained patch: (n, 53) 32-bit words, the packed rows
    with each row's target index bitcast into a last column
    (renderer._patch_staging without its bucket padding, a compile-cost
    device)."""
    packed = np.empty((idx.size, PACKED_WIDTH + 1), np.float32)
    packed[:, :PACKED_WIDTH] = rows
    packed[:, PACKED_WIDTH] = idx.astype(np.int32).view(np.float32)
    return packed


def damage_rects(rects) -> np.ndarray:
    """The (DAMAGE_RECTS, 4) f32 rect array of a damage-clipped frame;
    unused slots inverted (no pixels, no quads)."""
    out = np.full((DAMAGE_RECTS, 4), EMPTY_BBOX, np.float32)
    for i, r in enumerate(rects):
        out[i] = r
    return out


def merge_damage(rects, rect):
    """Append a damage rect; past DAMAGE_RECTS, merge the pair whose union
    grows the covered area least, until they fit."""
    rects = [] if rects is None else list(rects)
    rects.append(rect)
    while len(rects) > DAMAGE_RECTS:
        best = None
        for i in range(len(rects)):
            for j in range(i + 1, len(rects)):
                a, b = rects[i], rects[j]
                u = (min(a[0], b[0]), min(a[1], b[1]),
                     max(a[2], b[2]), max(a[3], b[3]))
                grow = ((u[2] - u[0]) * (u[3] - u[1])
                        - (a[2] - a[0]) * (a[3] - a[1])
                        - (b[2] - b[0]) * (b[3] - b[1]))
                if best is None or grow < best[0]:
                    best = (grow, i, j, u)
        _, i, j, u = best
        rects[i] = u
        del rects[j]
    return rects


def patchable_spans(tape):
    """tape.root_spans without the roots that write or read a mask plane: a
    patch replaces rows and keeps the snapshot's pass structure, so a change
    of clip structure inside a span must re-snapshot."""
    spans = tape.root_spans
    if not spans or not tape.mask_count:
        return spans
    bad = np.zeros(tape.count, bool)
    for item in tape.items:
        if isinstance(item, DrawItem) and item.target >= 0:
            bad[item.start : item.end] = True
    lanes = tape.combo[: tape.count, PACKED_MODES:].view(np.int32)
    bad |= lanes[:, QI_MASK] != 0
    return {key: (qs, qe) for key, (qs, qe) in spans.items()
            if not bad[qs:qe].any()}


def anim_state(scene: DeviceScene):
    """Build a scene's animation-table state at first use: the sorted root
    keys (the table's slot order), key -> slot, the per-quad slot index on
    the device (-1 for rows in no span) and the identity table. Returns the
    order, or None when the snapshot has no row mapping."""
    if scene.anim_spans is None:
        return None
    if scene.anim_order is None:
        scene.anim_order = sorted(scene.anim_spans)
        scene.anim_slot = {k: i for i, k in enumerate(scene.anim_order)}
        tmpl = np.zeros((len(scene.anim_order) + 1, 6), np.float32)
        tmpl[:, 0] = 1.0
        tmpl[:, 3] = 1.0
        scene.anim_template = tmpl
    if scene.anim_ridx_dev is None:
        ridx = np.full(scene.n_quads, -1, np.int32)
        for i, key in enumerate(scene.anim_order):
            qs, qe = scene.anim_spans[key]
            ridx[qs:qe] = i
        scene.anim_ridx_dev = torch.from_numpy(ridx).to(scene.combo_dev.device)
    return scene.anim_order


def affine6(tr) -> np.ndarray:
    """One transform as the table row (m00, m01, m10, m11, tx, ty) of p' =
    M p + t: a geometry.Mat3 (its translation is t), a (6,) row in that
    order (geometry.root_affine gives one) or a 2x3 [[a, b, tx], [c, d,
    ty]]."""
    if isinstance(tr, Mat3):
        return np.asarray((tr.a, tr.b, tr.c, tr.d, tr.tx, tr.ty), np.float32)
    arr = np.asarray(tr, np.float32)
    if arr.shape == (2, 3):
        return np.asarray((arr[0, 0], arr[0, 1], arr[1, 0], arr[1, 1],
                           arr[0, 2], arr[1, 2]), np.float32)
    if arr.shape == (6,):
        return arr
    raise ValueError("root transform must be a Mat3, a (6,) row "
                     "(m00, m01, m10, m11, tx, ty) or a 2x3 affine")


def root_key(key):
    """(lvl, root_node_idx) from a key or a bare layer-0 node index."""
    if isinstance(key, (int, np.integer)):
        return (0, int(key))
    return (int(key[0]), int(key[1]))


def anim_table(scene: DeviceScene, root_transforms) -> np.ndarray:
    """The (R + 1, 6) f32 table for ops.rows.animate_rows. root_transforms:
    {root key: transform} (affine6's forms; a bare int is a layer-0 root),
    or a bulk (R, 6) array in scene.anim_order's slot order."""
    order = anim_state(scene)
    if order is None:
        if scene.kind == "mega":
            raise ValueError(
                "scene is not animatable: a megakernel snapshot with clip "
                "masks interleaves clear sentinel rows, so tape rows do not "
                "map 1:1 onto its rows. Snapshot with animate=True for a "
                "layout that does.")
        raise ValueError("scene is not animatable: the snapshot recorded no "
                         "per-root row spans (an empty scene has no roots)")
    n = len(order)
    if not isinstance(root_transforms, dict):
        arr = np.asarray(root_transforms, np.float32)
        if arr.shape != (n, 6):
            raise ValueError(
                f"bulk animation table must be ({n}, 6) f32 rows "
                "(m00, m01, m10, m11, tx, ty) in scene.anim_order slot order")
        table = np.empty((n + 1, 6), np.float32)
        table[:n] = arr
        table[n] = scene.anim_template[n]
        return table
    table = scene.anim_template.copy()
    for key, tr in root_transforms.items():
        k = root_key(key)
        slot = scene.anim_slot.get(k)
        if slot is None:
            raise KeyError(f"root {k} has no recorded span in this snapshot "
                           "(keys are (zlevel, root_node_idx) or bare layer-0 "
                           "ints; see scene.anim_order)")
        table[slot] = affine6(tr)
    return table


def patch_device_scene(renderer, scene: DeviceScene, renders, dirty) -> bool:
    """update_scene's patch (renderer._patch_device_scene): walk the dirty
    roots again in the scratch context, add their damage rects, patch the
    plan's host rows and leave the rows as scene.pending_patch for the next
    render to upload (updates made back to back merge on the host, the
    newest row per index winning: index_copy_ with duplicate indices is
    unspecified). False: the caller must re-snapshot (no dirty list, no
    spans, a root without a span or one that outgrew it, an atlas rebuilt
    since the snapshot, or a walk native.walk_roots_packed cannot patch)."""
    if (dirty is None or scene.spans is None or scene.snap_args is None
            or not isinstance(renders, RendersArray)):
        return False
    dirty = [root_key(d) for d in dirty]
    if not dirty:
        return True
    old_spans = []
    for key in dirty:
        span = scene.spans.get(key)
        if span is None:
            return False
        old_spans.append(span)
    # glyphs first: new ones can grow the atlas, and rows packed against an
    # older generation take a new snapshot
    renderer._ensure_packed_glyphs(renders)
    if scene.atlas_generation != renderer.atlas.generation:
        return False
    out = native.walk_roots_packed(
        renders, dirty, fig_ui_scale(), renderer.pixel_scale, renderer.aa_factor,
        atlas=renderer._walk_atlas(), text=renderer._walk_text(),
        # the megakernel's rows carry their target in the mode lane, which a
        # scratch walk's rows lack; the other layouts read the atlas through
        # their items, so patched rows may sample it
        allow_atlas=scene.kind != "mega")
    if out is None:
        return False
    rows, new_spans = out
    total = 0
    for (os_, oe), (ns, ne) in zip(old_spans, new_spans):
        if ne - ns > oe - os_:
            return False  # grew beyond the span and its reserve
        total += oe - os_
    if total == 0:
        return True  # the dirty roots emit no quads
    idx = np.concatenate([np.arange(s, e, dtype=np.int32) for s, e in old_spans])
    if total != rows.shape[0]:
        # subtrees that shrank: inert rows (exact blending identities, never
        # binned) fill the tail of each span
        filled = np.empty((total, rows.shape[1]), np.float32)
        off = 0
        for (os_, oe), (ns, ne) in zip(old_spans, new_spans):
            m = ne - ns
            filled[off : off + m] = rows[ns:ne]
            filled[off + m : off + (oe - os_)] = native.inert_quad_rows(
                (oe - os_) - m)
            off += oe - os_
        rows = filled
    # one scene-space damage rect a dirty root: the union of its old and new
    # rows' bboxes, every pixel its quads could touch before or after
    plan = scene.plan
    obb = plan.combo[idx][:, 6:10]
    off = 0
    for os_, oe in old_spans:
        m = oe - os_
        bbs = np.concatenate([obb[off : off + m], rows[off : off + m, 6:10]])
        valid = bbs[:, 2] >= bbs[:, 0]
        if valid.any():
            v = bbs[valid]
            scene.pending_damage = merge_damage(
                scene.pending_damage,
                (float(v[:, 0].min()), float(v[:, 1].min()),
                 float(v[:, 2].max()), float(v[:, 3].max())))
        off += m
    # the host rows stay what a re-plan would see
    plan.combo[idx] = rows
    if plan.mega_combo is not None:
        plan.mega_combo[idx] = rows
    if scene.pending_patch is not None:
        old_rows, old_idx = scene.pending_patch
        keep = ~np.isin(old_idx, idx)
        rows = np.concatenate([old_rows[keep], rows])
        idx = np.concatenate([old_idx[keep], idx])
    scene.pending_patch = (rows, idx)
    return True


def from_jax_scene(jax_scene, device) -> DeviceScene:
    """The port's DeviceScene from a figdraw_tpu.renderer.DeviceScene, read
    through its numpy-convertible fields only, so one snapshot can be viewed,
    animated and patched by both packages. device: where the resident rows
    go, the device of the FigRenderer that will view the scene (it refuses a
    scene on another). The scene keeps the JAX package's
    executor: its resident rows, kind, spans and snapshot arguments. A patch
    still pending on the JAX side is not carried."""
    plan = from_jax_plan(jax_scene.plan)
    kind = jax_scene.kind
    if kind != "mega" and plan.mega_combo is not None:
        # planned for the megakernel but snapshot without it
        rolled = len(plan.structure) > ROLLED_THRESHOLD
        items, radii = (build_rolled_items(plan.structure, plan.bounds, plan.radii)
                        if rolled else (None, None))
        plan = dataclasses.replace(plan, mega_combo=None, mega_atlas=False,
                                   rolled_items=items, rolled_radii=radii)
    if plan_kind(plan) != kind:
        raise ValueError(f"a {kind} scene with a {plan_kind(plan)} plan")
    combo = np.array(jax_scene.combo_dev, np.float32)
    plan.combo = np.array(plan.combo, np.float32)
    scene = DeviceScene(kind, plan, torch.from_numpy(combo).to(device),
                        int(jax_scene.n_quads), int(jax_scene.n_pad))
    if jax_scene.spans is not None:
        scene.spans = {root_key(k): (int(s), int(e))
                       for k, (s, e) in jax_scene.spans.items()}
    if jax_scene.anim_spans is not None:
        scene.anim_spans = {root_key(k): (int(s), int(e))
                            for k, (s, e) in jax_scene.anim_spans.items()}
    scene.atlas_generation = int(jax_scene.atlas_generation)
    if jax_scene.snap_args is not None:
        size, clear_main, cc, reserve, animate = jax_scene.snap_args
        scene.snap_args = (vec2(size.x, size.y), bool(clear_main),
                           Color(cc.r, cc.g, cc.b, cc.a), reserve, bool(animate))
    return scene
