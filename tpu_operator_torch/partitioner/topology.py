"""GPU groups placed over the node's link topology (counterpart of
tpu_operator/partitioner/topology.py).

The reference validates a partition group as an axis-aligned box on the
host's ICI grid. A GPU node has no such grid: its nearness is a link
hierarchy, which NVML reports for every pair of GPUs (``nvml.Session.links``):
NVLink (or one board), one PCIe switch, one host bridge, one NUMA node, or
across sockets. The contract stays the reference's; only the geometry
changes:

- a group is a set of GPU positions (PCI bus-id order, the device plugin's
  unit order) whose worst pair is no looser than the group's class;
- a group's ``topology`` string is derived from the placed set, never
  copied from config: the class of its worst pair, or ``single`` for one
  GPU;
- a layout entry's declared ``topology`` is an upper bound on that class;
  the entries that declare none take the tightest class at which the whole
  layout tiles (the reference's "canonical" shapes). A TPU grid string
  such as ``2x2`` is refused;
- the tiler is the reference's exact backtracking search, with candidate
  sets tried in lexical order (its row-major anchors), so the output is
  deterministic; ``blocked`` GPUs count as occupied and ``count: "all"``
  scales down to the healthy GPUs left;
- a pair NVML cannot answer is never guessed: its entry holds the reason
  instead of a class, and reading it raises :class:`UnknownLink`, so a
  layout that needs the pair fails while one-GPU groups, which read no
  pair, still place.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from ..nvml import LINK_CLASSES

#: the derived topology of a one-GPU group
SINGLE = "single"

#: a link class's rank: 0 for NVLink, growing with each level crossed
RANK: Dict[str, int] = {c: i for i, c in enumerate(LINK_CLASSES)}

#: a pairwise matrix of link classes, as ``nvml.Session.links`` gives it
Links = Sequence[Sequence[Optional[str]]]


class TopologyError(ValueError):
    pass


class UnknownLink(TopologyError):
    """A pair of GPUs whose link class is not known (NVML could not
    answer): a failure of the node, never a placement to defer."""


def _link(links: Links, a: int, b: int) -> str:
    cls = links[a][b]
    if cls not in RANK:
        raise UnknownLink(f"GPUs {a} and {b}: link {cls!r} is not one of {list(LINK_CLASSES)}")
    return cls


def link_cost(gpus: Sequence[int], links: Optional[Links]) -> int:
    """The sum over pairs of ``gpus`` of their link class's rank: lower is
    nearer. The tiler's and the device plugin's one measure; without a
    matrix every set costs 0, so a caller's tie-break (lexical) decides."""
    if links is None:
        return 0
    return sum(RANK[_link(links, a, b)] for a, b in itertools.combinations(gpus, 2))


def group_class(gpus: Sequence[int], links: Links) -> str:
    """The derived topology of a group: its worst pair's class, or
    :data:`SINGLE` for one GPU."""
    if len(gpus) < 2:
        return SINGLE
    return max((_link(links, a, b) for a, b in itertools.combinations(gpus, 2)),
               key=RANK.__getitem__)


def check_links(links: Links, total: int) -> None:
    """``links`` is a symmetric ``total`` x ``total`` matrix; raises
    TopologyError otherwise. Its entries are checked where they are read
    (:class:`UnknownLink`)."""
    if len(links) != total or any(len(row) != total for row in links):
        raise TopologyError(f"the link matrix is not {total} x {total} (the node's GPUs)")
    for a, b in itertools.combinations(range(total), 2):
        if links[a][b] != links[b][a]:
            raise TopologyError(f"GPUs {a} and {b}: link {links[a][b]!r} one way, "
                                f"{links[b][a]!r} the other")


def _bound(declared, chips: int) -> Optional[str]:
    """A declared topology as a class bound (None: undeclared)."""
    if declared is None:
        return None
    if declared == SINGLE and chips == 1:
        return LINK_CLASSES[0]
    if declared not in RANK:
        raise TopologyError(
            f"topology {declared!r} is not a GPU link class; declare one of "
            f"{list(LINK_CLASSES)}" + (f" or {SINGLE!r}" if chips == 1 else "")
            + " (an upper bound on the group's worst link), or none")
    return declared


def _candidates(chips: int, bound: str, links: Links, free: Sequence[int]
                ) -> Iterator[Tuple[int, ...]]:
    """The sets of ``chips`` free GPUs whose worst link is no looser than
    ``bound``, in lexical order."""
    limit = RANK[bound]
    for combo in itertools.combinations(free, chips):
        if all(RANK[_link(links, a, b)] <= limit for a, b in itertools.combinations(combo, 2)):
            yield combo


def _tile(shapes: List[Tuple[int, str]], links: Links, occupied: Set[int],
          total: int) -> Optional[List[Tuple[int, ...]]]:
    """Backtracking tiler: the first full placement, each group's
    candidates tried in lexical order. Greedy first-fit alone would refuse
    layouts that tile."""
    if not shapes:
        return []
    chips, bound = shapes[0]
    free = [g for g in range(total) if g not in occupied]
    for combo in _candidates(chips, bound, links, free):
        occupied.update(combo)
        rest = _tile(shapes[1:], links, occupied, total)
        occupied.difference_update(combo)
        if rest is not None:
            return [combo] + rest
    return None


def _blocked_set(blocked, total: int) -> Set[int]:
    out = set()
    for chip in blocked or []:
        if not 0 <= int(chip) < total:
            raise TopologyError(f"blocked GPU {chip} outside this node's 0..{total - 1}")
        out.add(int(chip))
    return out


def tile_partition(links: Links, layout: List[dict],
                   blocked: Optional[Sequence[int]] = None) -> List[dict]:
    """Expand a named layout into GPU groups whose every pair is linked no
    looser than the group's class, with each group's ``topology`` derived
    from the placed set.

    ``blocked`` GPUs (health-gated by a failed workload barrier) are
    occupied before placement: every group is made of healthy GPUs only,
    the health-aware re-tile; ``count: "all"`` entries scale down to the
    healthy GPUs left.

    Raises TopologyError for impossible splits: a malformed entry, a
    declared topology that is not a link class, more GPUs asked for than
    the node has free, groups that cannot be placed within their class, or
    a blocked GPU outside the node."""
    total = len(links)
    check_links(links, total)
    occupied = _blocked_set(blocked, total)
    available = total - len(occupied)
    entries: List[Tuple[int, Optional[str]]] = []
    used = 0
    for entry in layout or []:
        if not isinstance(entry, dict):
            raise TopologyError(f"layout entries must be mappings, got {entry!r}")
        try:
            chips = int(entry.get("chips", 1))
        except (TypeError, ValueError):
            raise TopologyError(f"entry {entry!r}: chips must be an integer") from None
        if chips <= 0:
            raise TopologyError(f"invalid chips count {chips}")
        bound = _bound(entry.get("topology"), chips)
        count = entry.get("count", 1)
        # clamp: an "all" entry after an overflowing fixed-count one must
        # not decrement `used` and mask the explicit overflow diagnostic
        if count == "all":
            n = max((available - used) // chips, 0)
        else:
            try:
                n = int(count)
            except (TypeError, ValueError):
                raise TopologyError(
                    f"entry {entry!r}: count must be an integer or 'all'") from None
        entries.extend([(chips, bound)] * n)
        used += chips * n
    if used > available:
        raise TopologyError(
            f"layout requests {used} GPU(s) but the node has {available} available"
            + (f" ({total} total, {total - available} health-gated)"
               if available != total else ""))
    # undeclared entries: the tightest class at which the whole layout tiles
    undeclared = [LINK_CLASSES[-1]] if all(b is not None for _, b in entries) \
        else LINK_CLASSES
    for cls in undeclared:
        shapes = [(chips, bound or cls) for chips, bound in entries]
        placed = _tile(shapes, links, set(occupied), total)
        if placed is not None:
            return [{"topology": group_class(combo, links), "chips": list(combo)}
                    for combo in placed]
    raise TopologyError(
        f"cannot place {[f'{c} GPU(s) within {b or cls}' for c, b in entries]} on the "
        f"node's {total} GPU(s)"
        + (f" with GPU(s) {sorted(occupied)} health-gated" if occupied else ""))


def retile_incremental(links: Links, blocked: Sequence[int],
                       previous_groups: List[dict]) -> Tuple[List[dict], List[dict]]:
    """Incremental re-tile (Tenplex, arXiv 2312.05181): keep each previous
    group that holds no blocked GPU exactly as it was (same GPUs, same
    topology string, so the device plugin's units and the tenants on them
    stay valid) and re-place only the hit groups, each within its own
    class, on the healthy GPUs left.

    Returns ``(groups, dropped)``: the surviving layout in the original
    group order (re-placed groups keep their position) and the hit groups
    that could not be placed anywhere. Never raises for a placement
    failure. Raises TopologyError only for input errors (a bad matrix or
    GPU id, a malformed previous group); callers fall back to the full
    tiler on those."""
    total = len(links)
    check_links(links, total)
    blocked_set = _blocked_set(blocked, total)
    occupied = set(blocked_set)
    kept: List[Tuple[int, dict]] = []
    affected: List[Tuple[int, int, str]] = []
    for idx, group in enumerate(previous_groups or []):
        if not isinstance(group, dict) or "chips" not in group:
            raise TopologyError(f"malformed previous group {group!r}")
        try:
            chips = [int(c) for c in group["chips"]]
        except (TypeError, ValueError) as e:
            raise TopologyError(
                f"malformed previous group chips {group.get('chips')!r}: {e}") from e
        if not chips or any(not 0 <= c < total for c in chips):
            raise TopologyError(f"previous group GPUs {chips} outside the node")
        bound = _bound(group.get("topology", SINGLE), len(chips))
        if blocked_set & set(chips):
            affected.append((idx, len(chips), bound))
        else:
            kept.append((idx, group))
            # healthy groups keep their GPUs; nothing may re-place onto them
            occupied.update(chips)
    replaced: Dict[int, dict] = {}
    dropped: List[dict] = []
    for idx, chips, bound in affected:
        free = [g for g in range(total) if g not in occupied]
        combo = next(_candidates(chips, bound, links, free), None)
        if combo is None:
            dropped.append(previous_groups[idx])
            continue
        occupied.update(combo)
        replaced[idx] = {"topology": group_class(combo, links), "chips": list(combo)}
    survivors = dict(kept)
    survivors.update(replaced)
    return [survivors[idx] for idx in sorted(survivors)], dropped
