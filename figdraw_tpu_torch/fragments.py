"""RenderFragments: fragment-backed render trees (figdraw_tpu/fragments.py,
copied): a base `Renders` whose physical node indexes never change when
fragment subtrees are inserted or replaced. Logical traversal goes through
child-entry tables that interleave plain node references with fragment
references; `update_fragment` swaps a fragment's list in place, fixing
nested references. render_frame draws one through the Python walk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

from .nodes import Fig, FigIdx, RenderList, Renders, ZLevel, new_renders


@dataclass
class _NodeChild:
    node: FigIdx


@dataclass
class _FragmentChild:
    fragment: "RenderFragment"
    root: FigIdx


class _RenderEntries:
    __slots__ = ("child_entries", "root_entries", "ready")

    def __init__(self) -> None:
        self.child_entries: Dict[int, List] = {}
        self.root_entries: List = []
        self.ready = False

    def reset(self) -> None:
        self.child_entries.clear()
        self.root_entries.clear()
        self.ready = False

    def rebuild(self, lst: RenderList) -> None:
        self.child_entries.clear()
        self.root_entries.clear()
        for idx, node in enumerate(lst.nodes):
            child = _NodeChild(idx)
            if node.parent < 0:
                self.root_entries.append(child)
            else:
                assert node.parent < len(lst.nodes)
                self.child_entries.setdefault(node.parent, []).append(child)
        self.ready = True

    def ensure(self, lst: RenderList) -> None:
        if not self.ready:
            self.rebuild(lst)

    def shift_indexes(self, insert_idx: int, count: int) -> None:
        """renderfragments.nim:99-120."""
        if not self.ready or count == 0:
            return
        remapped: Dict[int, List] = {}
        for parent_idx, entries in self.child_entries.items():
            for entry in entries:
                if isinstance(entry, _NodeChild) and entry.node >= insert_idx:
                    entry.node += count
            new_parent = parent_idx + count if parent_idx >= insert_idx else parent_idx
            remapped[new_parent] = entries
        self.child_entries = remapped
        for entry in self.root_entries:
            if isinstance(entry, _NodeChild) and entry.node >= insert_idx:
                entry.node += count


class RenderFragment:
    """An independently replaceable render subtree."""

    __slots__ = ("list", "entries")

    def __init__(self, lst: RenderList, entries: _RenderEntries):
        self.list = lst
        self.entries = entries


@dataclass(frozen=True)
class RenderCursor:
    """Identifies a Fig in a base layer or an inserted fragment."""

    zlevel: ZLevel
    index: FigIdx
    fragment: Optional[RenderFragment] = None


def _effective_child_count(lst: RenderList, entries: _RenderEntries, parent_idx: FigIdx) -> int:
    entries.ensure(lst)
    return len(entries.child_entries.get(parent_idx, []))


def _insert_fragment(
    lst: RenderList,
    entries: _RenderEntries,
    parent_idx: FigIdx,
    children: RenderList,
    child_pos: int,
) -> Optional[RenderFragment]:
    """renderfragments.nim:154-176."""
    entries.ensure(lst)
    assert lst._valid_idx(parent_idx)
    assert child_pos <= _effective_child_count(lst, entries, parent_idx)
    children._validate_root_ids()
    frag_entries = _RenderEntries()
    frag_entries.rebuild(children)
    if not frag_entries.root_entries:
        return None
    fragment = RenderFragment(children, frag_entries)
    siblings = entries.child_entries.setdefault(parent_idx, [])
    for offset, root in enumerate(frag_entries.root_entries):
        assert isinstance(root, _NodeChild)
        siblings.insert(child_pos + offset, _FragmentChild(fragment, root.node))
    return fragment


def _append_children(
    lst: RenderList, entries: _RenderEntries, parent_idx: FigIdx, children: RenderList
) -> List[FigIdx]:
    """renderfragments.nim:178-218: append to the physical list, updating
    logical entries so earlier fragment positions are preserved."""
    entries.ensure(lst)
    assert lst._valid_idx(parent_idx)
    children._validate_root_ids()
    if not children.nodes:
        return []
    base = len(lst.nodes)
    for node in children.nodes:
        new_node = node.copy()
        if node.parent < 0:
            new_node.parent = parent_idx
        else:
            assert node.parent < len(children.nodes)
            new_node.parent = base + node.parent
        lst.nodes.append(new_node)

    out: List[FigIdx] = []
    siblings = entries.child_entries.setdefault(parent_idx, [])
    for root in children.root_ids:
        appended = base + root
        siblings.append(_NodeChild(appended))
        lst.nodes[parent_idx].child_count += 1
        out.append(appended)

    for source_parent, node in enumerate(children.nodes):
        if node.child_count > 0:
            dest_parent = base + source_parent
            dest_entries = [
                _NodeChild(base + child_idx)
                for child_idx in children.child_index(source_parent)
            ]
            entries.child_entries[dest_parent] = dest_entries
    return out


def _insert_child_into(
    lst: RenderList, entries: _RenderEntries, parent_idx: FigIdx, child: Fig, child_pos: int
) -> FigIdx:
    """renderfragments.nim:370-396."""
    entries.ensure(lst)
    assert child_pos <= _effective_child_count(lst, entries, parent_idx)
    physical_count = lst.nodes[parent_idx].child_count
    if child_pos <= physical_count:
        insert_idx = lst._child_insert_index(parent_idx, child_pos)
    else:
        insert_idx = len(lst.nodes)
    entries.shift_indexes(insert_idx, 1)
    result = lst.insert_child(parent_idx, child, min(child_pos, physical_count))
    shifted_parent = parent_idx + 1 if parent_idx >= insert_idx else parent_idx
    entries.child_entries.setdefault(shifted_parent, []).insert(
        child_pos, _NodeChild(result)
    )
    return result


class RenderFragments:
    """A render tree whose base Renders stays physically unchanged when
    fragment subtrees are inserted or replaced (renderfragments.nim:27-31)."""

    def __init__(self, renders: Optional[Renders] = None):
        self.base = renders if renders is not None else new_renders()
        self.layer_entries: Dict[ZLevel, _RenderEntries] = {}

    # --- layer state ------------------------------------------------------------

    def _layer_state(self, lvl: ZLevel) -> _RenderEntries:
        lst = self.base[lvl]
        entries = self.layer_entries.setdefault(lvl, _RenderEntries())
        entries.ensure(lst)
        return entries

    def clear(self) -> None:
        self.base.clear()
        self.layer_entries.clear()

    def len(self, lvl: ZLevel) -> int:
        return self.base.len(lvl)

    def __contains__(self, lvl: ZLevel) -> bool:
        return lvl in self.base

    def pairs(self):
        return self.base.pairs()

    def zlevels(self):
        return [lvl for lvl, _ in sorted(self.base.pairs(), key=lambda kv: kv[0])]

    def __getitem__(self, key):
        if isinstance(key, RenderCursor):
            return self.node_at(key)
        self._layer_state(key)
        return self.base.layers[key]

    def set_layer(self, lvl: ZLevel, lst: RenderList) -> None:
        self.base.set_layer(lvl, lst)
        self.layer_entries.setdefault(lvl, _RenderEntries()).reset()

    def node_at(self, cursor: RenderCursor) -> Fig:
        if cursor.fragment is None:
            return self.base.layers[cursor.zlevel].nodes[cursor.index]
        return cursor.fragment.list.nodes[cursor.index]

    def effective_child_count(self, parent) -> int:
        if isinstance(parent, RenderCursor):
            if parent.fragment is None:
                return self.effective_child_count((parent.zlevel, parent.index))
            return _effective_child_count(
                parent.fragment.list, parent.fragment.entries, parent.index
            )
        lvl, parent_idx = parent
        entries = self._layer_state(lvl)
        return _effective_child_count(self.base.layers[lvl], entries, parent_idx)

    # --- traversal -----------------------------------------------------------------

    def roots(self, lvl: ZLevel) -> Iterator[RenderCursor]:
        entries = self._layer_state(lvl)
        for entry in list(entries.root_entries):
            if isinstance(entry, _NodeChild):
                yield RenderCursor(lvl, entry.node)
            else:
                yield RenderCursor(lvl, entry.root, entry.fragment)

    def children(self, parent: RenderCursor) -> Iterator[RenderCursor]:
        if parent.fragment is None:
            entries = self._layer_state(parent.zlevel)
            source = entries.child_entries.get(parent.index, [])
            for entry in list(source):
                if isinstance(entry, _NodeChild):
                    yield RenderCursor(parent.zlevel, entry.node)
                else:
                    yield RenderCursor(parent.zlevel, entry.root, entry.fragment)
        else:
            parent.fragment.entries.ensure(parent.fragment.list)
            source = parent.fragment.entries.child_entries.get(parent.index, [])
            for entry in list(source):
                if isinstance(entry, _NodeChild):
                    yield RenderCursor(parent.zlevel, entry.node, parent.fragment)
                else:
                    yield RenderCursor(parent.zlevel, entry.root, entry.fragment)

    # --- mutation ---------------------------------------------------------------------

    def add_root(self, lvl_or_root, root: Optional[Fig] = None) -> FigIdx:
        if root is None:
            root = lvl_or_root
            lvl = root.zlevel
        else:
            lvl = lvl_or_root
        node = root.copy()
        node.zlevel = lvl
        self._layer_state(lvl)
        idx = self.base.layers[lvl].add_root(node)
        self.layer_entries[lvl].root_entries.append(_NodeChild(idx))
        return idx

    def insert_root(self, *args) -> FigIdx:
        if len(args) == 3:
            lvl, root, root_pos = args
        else:
            root, root_pos = args
            lvl = root.zlevel
        self._layer_state(lvl)
        lst = self.base.layers[lvl]
        insert_idx = lst._root_insert_index(root_pos)
        self.layer_entries[lvl].shift_indexes(insert_idx, 1)
        node = root.copy()
        node.zlevel = lvl
        result = lst.insert_root(node, root_pos)
        self.layer_entries[lvl].root_entries.insert(root_pos, _NodeChild(result))
        return result

    def add_child(self, parent, child: Fig):
        if isinstance(parent, RenderCursor):
            node = child.copy()
            node.zlevel = parent.zlevel
            if parent.fragment is None:
                idx = self.add_child((parent.zlevel, parent.index), node)
                return RenderCursor(parent.zlevel, idx)
            parent.fragment.entries.ensure(parent.fragment.list)
            idx = parent.fragment.list.add_child(parent.index, node)
            parent.fragment.entries.child_entries.setdefault(parent.index, []).append(
                _NodeChild(idx)
            )
            return RenderCursor(parent.zlevel, idx, parent.fragment)
        lvl, parent_idx = parent
        node = child.copy()
        node.zlevel = lvl
        self._layer_state(lvl)
        idx = self.base.layers[lvl].add_child(parent_idx, node)
        self.layer_entries[lvl].child_entries.setdefault(parent_idx, []).append(
            _NodeChild(idx)
        )
        return idx

    def insert_child(self, parent, child: Fig, child_pos: int):
        if isinstance(parent, RenderCursor):
            node = child.copy()
            node.zlevel = parent.zlevel
            if parent.fragment is None:
                idx = self.insert_child((parent.zlevel, parent.index), node, child_pos)
                return RenderCursor(parent.zlevel, idx)
            idx = _insert_child_into(
                parent.fragment.list, parent.fragment.entries, parent.index, node, child_pos
            )
            return RenderCursor(parent.zlevel, idx, parent.fragment)
        lvl, parent_idx = parent
        node = child.copy()
        node.zlevel = lvl
        entries = self._layer_state(lvl)
        return _insert_child_into(self.base.layers[lvl], entries, parent_idx, node, child_pos)

    def insert_children(self, parent, children: RenderList, child_pos: int) -> List[RenderCursor]:
        if isinstance(parent, RenderCursor) and parent.fragment is not None:
            for n in children.nodes:
                n.zlevel = parent.zlevel
            fragment = _insert_fragment(
                parent.fragment.list, parent.fragment.entries, parent.index, children, child_pos
            )
            if fragment is None:
                return []
            return [
                RenderCursor(parent.zlevel, r.node, fragment)
                for r in fragment.entries.root_entries
            ]
        if isinstance(parent, RenderCursor):
            lvl, parent_idx = parent.zlevel, parent.index
        else:
            lvl, parent_idx = parent
        for n in children.nodes:
            n.zlevel = lvl
        entries = self._layer_state(lvl)
        fragment = _insert_fragment(
            self.base.layers[lvl], entries, parent_idx, children, child_pos
        )
        if fragment is None:
            return []
        return [
            RenderCursor(lvl, r.node, fragment) for r in fragment.entries.root_entries
        ]

    def add_children(self, parent, children: RenderList):
        if isinstance(parent, RenderCursor):
            for n in children.nodes:
                n.zlevel = parent.zlevel
            if parent.fragment is None:
                out = self.add_children((parent.zlevel, parent.index), children)
                return [RenderCursor(parent.zlevel, idx) for idx in out]
            out = _append_children(
                parent.fragment.list, parent.fragment.entries, parent.index, children
            )
            return [RenderCursor(parent.zlevel, idx, parent.fragment) for idx in out]
        lvl, parent_idx = parent
        for n in children.nodes:
            n.zlevel = lvl
        entries = self._layer_state(lvl)
        return _append_children(self.base.layers[lvl], entries, parent_idx, children)

    # --- fragment replacement (renderfragments.nim:487-544) -------------------------

    def update_fragment(self, cursor: RenderCursor, updated: RenderList) -> List[RenderCursor]:
        """Replaces the fragment identified by cursor, preserving its identity
        and position in the surrounding tree."""
        assert cursor.fragment is not None
        for n in updated.nodes:
            n.zlevel = cursor.zlevel
        updated._validate_root_ids()
        updated_entries = _RenderEntries()
        updated_entries.rebuild(updated)
        replacement_roots = [r.node for r in updated_entries.root_entries]

        def replace_in_children(children: List) -> None:
            out = []
            replaced = False
            for entry in children:
                if isinstance(entry, _FragmentChild) and entry.fragment is cursor.fragment:
                    if not replaced:
                        for root in replacement_roots:
                            out.append(_FragmentChild(cursor.fragment, root))
                        replaced = True
                else:
                    out.append(entry)
            children[:] = out

        visited = set()

        def update_nested(entries: _RenderEntries) -> None:
            if id(entries) in visited:
                return
            visited.add(id(entries))
            for children in entries.child_entries.values():
                replace_in_children(children)
            for children in entries.child_entries.values():
                for entry in children:
                    if (
                        isinstance(entry, _FragmentChild)
                        and entry.fragment is not cursor.fragment
                    ):
                        update_nested(entry.fragment.entries)

        for entries in self.layer_entries.values():
            update_nested(entries)

        cursor.fragment.list = updated
        cursor.fragment.entries = updated_entries
        return [
            RenderCursor(cursor.zlevel, root, cursor.fragment)
            for root in replacement_roots
        ]


def new_render_fragments(renders: Optional[Renders] = None) -> RenderFragments:
    return RenderFragments(renders)
