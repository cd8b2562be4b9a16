"""Backdrop blur: the separable gaussian over the channel-planar frame
(figdraw_tpu/ops/blur.py:21-65), which the JAX package leaves to XLA.

Radius clamped to 64, sigma = radius/2, tap step = max(radius/8, 1) px, 8
taps each side, linearly interpolated, clamp-to-edge, horizontal then
vertical. The radius stays a float32 tensor, so the weights are computed in
float32 as in the reference (never in Python doubles), and no value leaves
the device.

`backdrop_blur_planar` runs csrc/blur.cu, a hand-written kernel for Hopper
(sm_90a), one launch a pass (`blur_pass`), on CUDA tensors (or raises); CPU
tensors take `backdrop_blur_planar_plain`, the plain torch version, which
the CPU tests and the on-card comparison use.

`banded_blur_planar` is the same blur on a frame split into row bands over
several devices (figdraw_tpu/parallel/sharding.py `_banded_blur_planar`,
:165-190, the ppermute halo exchange): the horizontal pass runs on each
band; each band then takes BLUR_HALO rows from each neighbour (its own edge
row repeated at the frame's top and bottom), and the vertical pass runs on
the extended band, which is cropped back. Where the halo is not shorter
than a band, every band is gathered onto each device instead, blurred
there once and sliced back. `banded_blur_planar_plain` does exactly that
on `_blur_axis` and is the reference.

On CUDA bands it is X6 (`banded_blur_kernels`): two launches a device,
whatever its number of bands. `band_table` lays out each device's scratch
(its bands' horizontal pass, then the rows copied from bands on other
devices) and each band's line in the plain version's coordinates; the
horizontal kernel reads the bands in place into the scratch and the
vertical kernel reads each line's rows from the scratch in place and
writes the bands' outputs (the caller's views with `out=`). Only the rows
of neighbours on another device are copied, one copy a neighbour edge (a
band a device on the gather path). `banded_blur_table_plain` runs the same
table through the plain passes (`banded_horizontal_plain`,
`banded_vertical_plain`), so the table is tested without a card.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from functools import cached_property, lru_cache

import torch

from . import nvcc

TAP_RADIUS = 8

# kernel launches since the count was last reset (two a blur: one a pass)
LAUNCHES = 0
# of those, the passes the banded blur launched (two a device a blur, one
# a pass over up to MAX_BANDS of its bands)
BAND_LAUNCHES = 0
# bands one launch of the banded passes takes (csrc/blur.cu MAX_BANDS: the
# table travels in the kernel's parameters)
MAX_BANDS = 32
# rows a band takes from each neighbour: the radius clamp 64 (blur.frag:12)
# and 1 for the linear tap's second texel (sharding.py:151)
BLUR_HALO = 65

_SOURCES = ("blur.cu",)

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""  # nvcc's output of the build this process loaded (ptxas -v)


def load() -> ctypes.CDLL:
    """The kernel library, built and bound at first use."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is None:
            path, BUILD_LOG = nvcc.build("figdraw_blur", _SOURCES)
            lib = ctypes.CDLL(path)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.figdraw_blur_pass.argtypes = [vp] * 3 + [i] * 4 + [vp]
            lib.figdraw_blur_pass.restype = i
            ll = ctypes.c_longlong
            lib.figdraw_blur_bands_h.argtypes = [vp, ll] + [i] * 4 + [vp] * 5
            lib.figdraw_blur_bands_h.restype = i
            lib.figdraw_blur_bands_v.argtypes = [vp, ll] + [i] * 4 + [vp] * 5
            lib.figdraw_blur_bands_v.restype = i
            _lib = lib
        return _lib


def _blur_axis(img: torch.Tensor, radius: torch.Tensor, axis: int) -> torch.Tensor:
    """One separable pass along `axis` of img."""
    r = torch.clamp(radius, 0.0, 64.0)
    sigma = torch.clamp(0.5 * r, min=0.5)
    step_px = torch.clamp(r / TAP_RADIUS, min=1.0)
    n = img.shape[axis]

    coords = torch.arange(n, dtype=torch.float32, device=img.device)
    fr_shape = [1] * img.ndim
    fr_shape[axis] = n
    acc = torch.zeros_like(img)
    weight_sum = torch.zeros((), dtype=img.dtype, device=img.device)
    for i in range(-TAP_RADIUS, TAP_RADIUS + 1):
        x = i * step_px
        w = torch.exp(-0.5 * (x * x) / (sigma * sigma))
        pos = coords + x
        p0 = torch.floor(pos)
        frac = pos - p0
        i0 = torch.clamp(p0.to(torch.int64), 0, n - 1)
        i1 = torch.clamp(i0 + 1, 0, n - 1)
        s0 = img.index_select(axis, i0)
        s1 = img.index_select(axis, i1)
        fr = frac.reshape(fr_shape)
        acc = acc + (s0 * (1.0 - fr) + s1 * fr) * w
        weight_sum = weight_sum + w

    out = acc / torch.clamp(weight_sum, min=1e-5)
    return torch.where(r <= 0.5, img, out)


def backdrop_blur_planar_plain(frame_planes: torch.Tensor, radius) -> torch.Tensor:
    """The plain torch version of backdrop_blur_planar (same arguments, any
    device): horizontal then vertical pass (runBackdropSeparableBlur's
    order)."""
    radius = torch.as_tensor(radius, dtype=torch.float32, device=frame_planes.device)
    out = _blur_axis(frame_planes, radius, axis=2)
    out = _blur_axis(out, radius, axis=1)
    return out


def blur_pass(planes: torch.Tensor, radius, vertical: bool) -> torch.Tensor:
    """One separable pass of X1's kernel over channel-planar (C, H, W) f32
    planes on the card, into new planes (along W, or along H when
    vertical); the input is not written. radius: a 0-d (or one-element)
    float32 tensor on the planes' device, which the kernel reads there, or a
    float. A tensor that is not on a CUDA device raises ValueError;
    blur_axis_plain is the pass's plain version."""
    if planes.device.type != "cuda":
        raise ValueError(f"no blur kernel for {planes.device}")
    dev = planes.device
    if planes.dtype != torch.float32 or planes.dim() != 3 or not planes.is_contiguous():
        raise ValueError("planes must be contiguous (C, H, W) float32, got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    if radius.numel() != 1:
        raise ValueError(f"radius must hold one value, got {tuple(radius.shape)}")
    c, ph, pw = planes.shape
    if c * ph > 1 << 30:
        raise ValueError(f"{c} x {ph} rows are more than one launch takes")
    out = torch.empty_like(planes)
    lib = load()
    # the planes' device is the current one for the launch
    with torch.cuda.device(dev):
        rc = lib.figdraw_blur_pass(planes.data_ptr(), out.data_ptr(), radius.data_ptr(),
                                   c, ph, pw, int(bool(vertical)),
                                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"blur launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def blur_axis_plain(planes: torch.Tensor, radius, vertical: bool) -> torch.Tensor:
    """The plain torch version of blur_pass (any device)."""
    radius = torch.as_tensor(radius, dtype=torch.float32, device=planes.device)
    return _blur_axis(planes, radius, axis=1 if vertical else 2)


def backdrop_blur_planar(frame_planes: torch.Tensor, radius) -> torch.Tensor:
    """Blur a channel-planar (C, H, W) f32 frame into new planes; the input
    is not written. radius: a 0-d (or one-element) float32 tensor on the
    planes' device, which the kernel reads there, or a float."""
    if frame_planes.device.type == "cpu":
        return backdrop_blur_planar_plain(frame_planes, radius)
    return blur_pass(blur_pass(frame_planes, radius, False), radius, True)


def _edge_rows(band: torch.Tensor, row: int, halo: int) -> torch.Tensor:
    """Row `row` of a (C, H, W) band repeated halo times."""
    return band[:, row : row + 1 if row >= 0 else None].expand(-1, halo, -1)


def _banded(bands, radii, halo: int, pass_fn):
    """The banded blur over one pass function pass_fn(planes, radius,
    vertical)."""
    n = len(bands)
    local = [pass_fn(b, r, False) for b, r in zip(bands, radii)]
    if n == 1:
        return [pass_fn(local[0], radii[0], True)]
    band_h = local[0].shape[1]
    if halo >= band_h:
        # bands no taller than the blur's reach: every band gathered onto
        # each device, blurred there once, and each band's rows taken back
        whole = {}
        out = []
        for i, b in enumerate(local):
            dev = b.device
            if dev not in whole:
                gathered = torch.cat([x.to(dev) for x in local], dim=1)
                whole[dev] = pass_fn(gathered, radii[i], True)
            out.append(whole[dev][:, i * band_h : (i + 1) * band_h].contiguous())
        return out
    out = []
    for i, b in enumerate(local):
        dev = b.device
        top = (_edge_rows(b, 0, halo) if i == 0
               else local[i - 1][:, -halo:].to(dev))
        bot = (_edge_rows(b, -1, halo) if i == n - 1
               else local[i + 1][:, :halo].to(dev))
        extended = torch.cat([top, b, bot], dim=1)
        out.append(pass_fn(extended, radii[i], True)[:, halo:-halo].contiguous())
    return out


def _check_bands(bands, out):
    """(C, pband, pw) of bands of one shape (and of the out views, if any)."""
    types = {b.device.type for b in bands}
    if len(types) != 1:
        raise ValueError(f"bands on devices of several types: {sorted(types)}")
    if len({tuple(b.shape) for b in bands}) != 1:
        raise ValueError("every band must have the same shape")
    if out is not None and (len(out) != len(bands)
                            or any(o.shape != bands[0].shape for o in out)):
        raise ValueError("out must hold one view of each band's shape")
    return tuple(bands[0].shape)


def banded_blur_planar(bands, radii, halo: int = BLUR_HALO, out=None) -> list:
    """The backdrop blur of a frame split into row bands: bands, a list of
    (C, h, W) f32 planes (band i the frame's rows [i h, (i+1) h), each on
    its own device, one device for several bands allowed; rows W apart,
    any channel stride); radii, a list of each band's radius (a one-element
    f32 tensor on its device, or a float). Returns the blurred bands: new
    planes on the bands' devices, or out, a list of (C, h, W) views on them
    that the blur writes. The inputs are not written (out may alias them).
    The frame's edge rows repeat at its top and bottom (clamp-to-edge on the
    n h rows). CUDA bands run X6 (banded_blur_kernels, the bands' devices as
    the groups), CPU bands the plain version; a mix raises ValueError."""
    _check_bands(bands, out)
    if bands[0].device.type == "cpu":
        got = banded_blur_planar_plain(bands, radii, halo)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return list(out)
    return banded_blur_kernels(bands, radii, [b.device for b in bands], halo, out)


@dataclass(frozen=True)
class Segment:
    """Line rows [lo, hi) of a band's line: scratch rows base + (t - lo) *
    step (step 0 repeats one row)."""

    lo: int
    hi: int
    base: int
    step: int


@dataclass(frozen=True)
class Line:
    """The vertical pass of band `band`: its output row j is row origin + j
    of a line of n rows (the taps clamp to [0, n)), read through three
    segments of its group's scratch; `radius`: the band whose radius the
    pass takes (the group's first on the gather path, as the plain
    version's)."""

    band: int
    origin: int
    n: int
    segments: tuple
    radius: int

    @cached_property
    def geo(self) -> tuple:
        """The kernel's 11 ints for the line (csrc/blur.cu BandLine):
        origin, n, then each segment's lo, base and step."""
        s = self.segments
        return ((self.origin, self.n) + tuple(x.lo for x in s) + tuple(x.base for x in s)
                + tuple(x.step for x in s))


@dataclass(frozen=True)
class Copy:
    """Scratch rows [src_row, src_row + rows) of group `src` copied into
    rows [dst_row, dst_row + rows) of this group's before the vertical
    pass."""

    src: int
    src_row: int
    dst_row: int
    rows: int


@dataclass(frozen=True)
class Group:
    """One device's part of a banded blur: its bands (global indices, in
    order), each band's slot (its horizontal pass at scratch rows [slot,
    slot + pband)), the scratch's rows, the copies from other groups and
    one line a band."""

    key: object
    bands: tuple
    slots: tuple
    rows: int
    copies: tuple
    lines: tuple


def band_table(keys, pband: int, halo: int = BLUR_HALO) -> tuple:
    """The groups of a banded blur of len(keys) bands of pband rows, band i
    on the device (or stand-in key) keys[i], in the order the keys first
    appear. Swap path (halo < pband, more than one band): a group's scratch
    holds its bands in order, then `halo` rows for each neighbour edge whose
    neighbour lies in another group; a band's line is the extended band of
    pband + 2 halo rows (output row j at halo + j): above it the previous
    band's last halo rows, below it the next band's first, each read in
    place where that band shares the group, from the copied rows where it
    does not, and the band's own row 0 (pband - 1) repeated at the frame's
    top (bottom). Gather path (halo >= pband, or one band): a group's
    scratch holds every band at row i pband, those of other groups copied
    there one band a copy; a band's line is the frame's n pband rows,
    output row j at i pband + j."""
    return _band_table(tuple(keys), pband, halo)


@lru_cache(maxsize=64)
def _band_table(keys: tuple, pband: int, halo: int) -> tuple:
    """band_table, made once for each keys, pband and halo."""
    n = len(keys)
    order = []
    for k in keys:
        if k not in order:
            order.append(k)
    group_of = [order.index(k) for k in keys]
    members = [tuple(i for i in range(n) if group_of[i] == g) for g in range(len(order))]
    gather = n == 1 or halo >= pband
    if gather:
        slot_of = [i * pband for i in range(n)]
    else:
        slot_of = [members[group_of[i]].index(i) * pband for i in range(n)]
    groups = []
    for g, own in enumerate(members):
        copies, lines = [], []
        if gather:
            rows = n * pband
            copies = [Copy(group_of[j], slot_of[j], j * pband, pband)
                      for j in range(n) if group_of[j] != g]
            whole = (Segment(0, rows, 0, 1), Segment(rows, rows, 0, 1),
                     Segment(rows, rows, 0, 1))
            lines = [Line(i, i * pband, rows, whole, own[0]) for i in own]
        else:
            rows = len(own) * pband

            def edge(j, first):
                """(base, step) of the halo rows of neighbour j: in place,
                or copied into the next free rows of the scratch."""
                nonlocal rows
                src = slot_of[j] + (pband - halo if first else 0)
                if group_of[j] == g:
                    return src, 1
                copies.append(Copy(group_of[j], src, rows, halo))
                rows += halo
                return rows - halo, 1

            for i in own:
                top = edge(i - 1, True) if i > 0 else (slot_of[i], 0)
                bot = (edge(i + 1, False) if i < n - 1
                       else (slot_of[i] + pband - 1, 0))
                ext = pband + 2 * halo
                lines.append(Line(i, halo, ext, (
                    Segment(0, halo, *top),
                    Segment(halo, halo + pband, slot_of[i], 1),
                    Segment(halo + pband, ext, *bot)), i))
        groups.append(Group(order[g], own, tuple(slot_of[i] for i in own), rows,
                            tuple(copies), tuple(lines)))
    return tuple(groups)


def line_rows(line: Line) -> list:
    """The scratch row of each of the line's n rows."""
    return [s.base + (t - s.lo) * s.step for s in line.segments
            for t in range(s.lo, s.hi)]


def copy_bytes(groups, planes: int, pw: int) -> int:
    """Bytes the groups' copies move (f32 rows of `planes` planes)."""
    return sum(c.rows for g in groups for c in g.copies) * planes * pw * 4


_pool_lock = threading.Lock()
_pool = {}  # (device, stream, thread, group, shape) -> a scratch kept for the next call
POOL_SIZE = 16


def _scratch(device: torch.device, group: int, shape) -> torch.Tensor:
    """Group `group`'s scratch of a banded blur on device: on a card one
    kept for each (device, current stream, calling thread, group, shape),
    so that a frame allocates none (one thread's calls on one stream run in
    order); on the CPU a new one."""
    if device.type != "cuda":
        return torch.empty(shape, dtype=torch.float32, device=device)
    key = (device, torch.cuda.current_stream(device).cuda_stream, threading.get_ident(),
           group, tuple(shape))
    with _pool_lock:
        got = _pool.get(key)
        if got is None:
            if len(_pool) >= POOL_SIZE:
                _pool.clear()
            got = _pool[key] = torch.empty(shape, dtype=torch.float32, device=device)
        return got


def _tabled(bands, radii, keys, halo, out, horizontal, vertical) -> list:
    """The banded blur through band_table(keys): horizontal(bands, radii,
    group, scratch) for each group, then the copies, then vertical(scratch,
    group, radii, outs) for each group."""
    c, pband, pw = _check_bands(bands, out)
    if len(keys) != len(bands) or len(radii) != len(bands):
        raise ValueError(f"{len(bands)} bands, {len(radii)} radii, {len(keys)} keys")
    groups = band_table(keys, pband, halo)
    radii = [torch.as_tensor(r, dtype=torch.float32, device=b.device)
             for b, r in zip(bands, radii)]
    outs = (list(out) if out is not None else
            [torch.empty((c, pband, pw), dtype=torch.float32, device=b.device)
             for b in bands])
    scratch = []
    for g, group in enumerate(groups):
        dev = bands[group.bands[0]].device
        if any(bands[i].device != dev for i in group.bands):
            raise ValueError(f"the bands of group {group.key!r} lie on several devices")
        scratch.append(_scratch(dev, g, (c, group.rows, pw)))
    for group, s in zip(groups, scratch):
        horizontal(bands, radii, group, s)
    for group, s in zip(groups, scratch):
        for cp in group.copies:
            s[:, cp.dst_row : cp.dst_row + cp.rows].copy_(
                scratch[cp.src][:, cp.src_row : cp.src_row + cp.rows])
    for group, s in zip(groups, scratch):
        vertical(s, group, radii, outs)
    return outs


def banded_horizontal_plain(bands, radii, group: Group, scratch: torch.Tensor) -> None:
    """The plain version of the banded horizontal pass: each band of the
    group blurred along W into its slot of the scratch."""
    pband = bands[0].shape[1]
    for i, slot in zip(group.bands, group.slots):
        scratch[:, slot : slot + pband] = blur_axis_plain(bands[i], radii[i], False)


def banded_vertical_plain(scratch: torch.Tensor, group: Group, radii, outs) -> None:
    """The plain version of the banded vertical pass: each line of the group
    resolved to its scratch rows, blurred along them with `_blur_axis` in
    the line's coordinates, and its rows [origin, origin + pband) written to
    outs[band]."""
    for line in group.lines:
        rows = torch.tensor(line_rows(line), dtype=torch.int64, device=scratch.device)
        pband = outs[line.band].shape[1]
        blurred = _blur_axis(scratch.index_select(1, rows), radii[line.radius], axis=1)
        outs[line.band].copy_(blurred[:, line.origin : line.origin + pband])


def banded_blur_table_plain(bands, radii, keys=None, halo: int = BLUR_HALO,
                            out=None) -> list:
    """banded_blur_kernels' route with the plain passes (any devices; keys:
    the groups, the bands' devices by default)."""
    keys = [b.device for b in bands] if keys is None else keys
    return _tabled(bands, radii, keys, halo, out, banded_horizontal_plain,
                   banded_vertical_plain)


def _chunks(seq):
    return [seq[k : k + MAX_BANDS] for k in range(0, len(seq), MAX_BANDS)]


def _rows_of(t: torch.Tensor, c: int, pband: int, pw: int, what: str):
    if (t.device.type != "cuda" or t.dtype != torch.float32
            or tuple(t.shape) != (c, pband, pw) or t.stride(2) != 1 or t.stride(1) != pw):
        raise ValueError(f"{what} must be (C, pband, pw) float32 on a card with rows pw "
                         f"apart, got {t.dtype} {tuple(t.shape)} {t.stride()} on {t.device}")


def _launch(fn, scratch: torch.Tensor, c: int, pband: int, pw: int, entries) -> None:
    """One launch of fn (figdraw_blur_bands_h / _v) over up to MAX_BANDS
    entries, each (pointer, channel stride, radius pointer, ints)."""
    m = len(entries)
    ll = ctypes.c_longlong * m
    ints = [v for e in entries for v in e[3]]
    dev = scratch.device
    with torch.cuda.device(dev):
        rc = fn(scratch.data_ptr(), scratch.stride(0), c, pband, pw, m,
                ll(*(e[0] for e in entries)), ll(*(e[1] for e in entries)),
                ll(*(e[2] for e in entries)), (ctypes.c_int * len(ints))(*ints),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"banded blur launch failed: cudaError {rc}")
    global LAUNCHES, BAND_LAUNCHES
    LAUNCHES += 1
    BAND_LAUNCHES += 1


def _rows_pass(bands, radii, group: Group, scratch: torch.Tensor) -> None:
    """The horizontal kernel over the group's bands (a launch a MAX_BANDS)."""
    c, pband, pw = bands[0].shape
    for i in group.bands:
        _rows_of(bands[i], c, pband, pw, f"band {i}")
    entries = [(bands[i].data_ptr(), bands[i].stride(0), radii[i].data_ptr(), (slot,))
               for i, slot in zip(group.bands, group.slots)]
    for part in _chunks(entries):
        _launch(load().figdraw_blur_bands_h, scratch, c, pband, pw, part)


def _lines_pass(scratch: torch.Tensor, group: Group, radii, outs) -> None:
    """The vertical kernel over the group's lines (a launch a MAX_BANDS)."""
    c, pband, pw = outs[group.bands[0]].shape
    entries = []
    for line in group.lines:
        o = outs[line.band]
        _rows_of(o, c, pband, pw, f"out {line.band}")
        if o.device != scratch.device:
            raise ValueError(f"out {line.band} lies on {o.device}, its band on "
                             f"{scratch.device}")
        entries.append((o.data_ptr(), o.stride(0), radii[line.radius].data_ptr(), line.geo))
    for part in _chunks(entries):
        _launch(load().figdraw_blur_bands_v, scratch, c, pband, pw, part)


def banded_blur_kernels(bands, radii, keys, halo: int = BLUR_HALO, out=None) -> list:
    """X6 on CUDA bands, grouped by keys (band i in group keys[i]; every
    band of a group on one device): per group one horizontal and one
    vertical launch (a launch a MAX_BANDS bands), the copies of
    band_table between them. banded_blur_planar passes the bands' devices;
    other keys split one device's bands into groups that exchange their
    halo rows by copies, as bands on several devices do. Raises ValueError
    for bands that are not on a card."""
    if any(b.device.type != "cuda" for b in bands):
        raise ValueError("banded_blur_kernels takes bands on a card")
    return _tabled(bands, radii, keys, halo, out, _rows_pass, _lines_pass)


def banded_blur_planar_plain(bands, radii, halo: int = BLUR_HALO) -> list:
    """The plain torch version of banded_blur_planar (any devices)."""
    return _banded(bands, radii, halo, blur_axis_plain)
