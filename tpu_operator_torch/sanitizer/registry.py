"""Shared-state access tracker: the opsan proxy registry (copy of
tpu_operator/sanitizer/registry.py).

Each reconciler registers its mutable shared structures —
``self._store = register_shared("Informer[Node]._store", {})`` — and
gets back either the object untouched (opsan off: zero overhead, zero
behavior change) or a tracked subclass of the same built-in type whose
read/write operations report to the lockset algorithm. Per-structure
granularity is deliberate: every registered structure in this codebase
is guarded by exactly one lock as a whole (the lock-discipline rule), so
one lockset per structure is the discipline being proved, and per-key
state would only dilute the evidence.

A structure that is *replaced wholesale* (the WriteBatcher's pending-map
swap at flush, an informer relist) re-registers the replacement under
the same name; the runtime uniquifies (``name#1``, ``name#2``, …) so two
generations alive at once — old map draining on the flush thread, new
map filling under the lock — are tracked independently instead of
cross-contaminating each other's locksets.

``gpuop-lint``'s ``untracked-shared-state`` rule closes the loop
statically: a mutable container in a reconcile dir reachable from two thread
entrypoints must be lock-guarded or pass through here.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List

from .core import caller_site, opsan_enabled, runtime

_names_mu = threading.Lock()
_names: List[str] = []


def registered_names() -> List[str]:
    """Every name registered this process (report / debug surface)."""
    with _names_mu:
        return sorted(_names)


class TrackedDict(dict):
    """dict with every read/write reported to the lockset algorithm."""

    # dict has no __dict__ by default; the slot keeps the proxy as lean
    # as the structure it wraps
    __slots__ = ("_opsan_name",)

    def _access(self, write: bool) -> None:
        runtime().access(self._opsan_name, write, caller_site())

    def __getitem__(self, key):
        self._access(False)
        return dict.__getitem__(self, key)

    def __contains__(self, key):
        self._access(False)
        return dict.__contains__(self, key)

    def __iter__(self):
        self._access(False)
        return dict.__iter__(self)

    def __len__(self):
        self._access(False)
        return dict.__len__(self)

    def get(self, key, default=None):
        self._access(False)
        return dict.get(self, key, default)

    def keys(self):
        self._access(False)
        return dict.keys(self)

    def values(self):
        self._access(False)
        return dict.values(self)

    def items(self):
        self._access(False)
        return dict.items(self)

    def __setitem__(self, key, value):
        self._access(True)
        dict.__setitem__(self, key, value)

    def __delitem__(self, key):
        self._access(True)
        dict.__delitem__(self, key)

    def pop(self, *args):
        self._access(True)
        return dict.pop(self, *args)

    def popitem(self):
        self._access(True)
        return dict.popitem(self)

    def setdefault(self, key, default=None):
        self._access(True)
        return dict.setdefault(self, key, default)

    def update(self, *args, **kwargs):
        self._access(True)
        dict.update(self, *args, **kwargs)

    def clear(self):
        self._access(True)
        dict.clear(self)


class TrackedList(list):
    __slots__ = ("_opsan_name",)

    def _access(self, write: bool) -> None:
        runtime().access(self._opsan_name, write, caller_site())

    def __getitem__(self, idx):
        self._access(False)
        return list.__getitem__(self, idx)

    def __iter__(self):
        self._access(False)
        return list.__iter__(self)

    def __len__(self):
        self._access(False)
        return list.__len__(self)

    def __contains__(self, item):
        self._access(False)
        return list.__contains__(self, item)

    def __setitem__(self, idx, value):
        self._access(True)
        list.__setitem__(self, idx, value)

    def __delitem__(self, idx):
        self._access(True)
        list.__delitem__(self, idx)

    def append(self, item):
        self._access(True)
        list.append(self, item)

    def extend(self, items):
        self._access(True)
        list.extend(self, items)

    def insert(self, idx, item):
        self._access(True)
        list.insert(self, idx, item)

    def remove(self, item):
        self._access(True)
        list.remove(self, item)

    def pop(self, *args):
        self._access(True)
        return list.pop(self, *args)

    def clear(self):
        self._access(True)
        list.clear(self)

    def sort(self, **kwargs):
        self._access(True)
        list.sort(self, **kwargs)


class TrackedSet(set):
    __slots__ = ("_opsan_name",)

    def _access(self, write: bool) -> None:
        runtime().access(self._opsan_name, write, caller_site())

    def __contains__(self, item):
        self._access(False)
        return set.__contains__(self, item)

    def __iter__(self):
        self._access(False)
        return set.__iter__(self)

    def __len__(self):
        self._access(False)
        return set.__len__(self)

    def add(self, item):
        self._access(True)
        set.add(self, item)

    def discard(self, item):
        self._access(True)
        set.discard(self, item)

    def remove(self, item):
        self._access(True)
        set.remove(self, item)

    def pop(self):
        self._access(True)
        return set.pop(self)

    def clear(self):
        self._access(True)
        set.clear(self)

    def update(self, *others):
        self._access(True)
        set.update(self, *others)


class TrackedDeque(deque):
    # deque disallows __slots__ additions with content; no __slots__ here,
    # the name rides the instance dict
    def _access(self, write: bool) -> None:
        runtime().access(self._opsan_name, write, caller_site())

    def __getitem__(self, idx):
        self._access(False)
        return deque.__getitem__(self, idx)

    def __iter__(self):
        self._access(False)
        return deque.__iter__(self)

    def __len__(self):
        self._access(False)
        return deque.__len__(self)

    def append(self, item):
        self._access(True)
        deque.append(self, item)

    def appendleft(self, item):
        self._access(True)
        deque.appendleft(self, item)

    def extend(self, items):
        self._access(True)
        deque.extend(self, items)

    def pop(self):
        self._access(True)
        return deque.pop(self)

    def popleft(self):
        self._access(True)
        return deque.popleft(self)

    def clear(self):
        self._access(True)
        deque.clear(self)


_WRAPPERS: Dict[type, type] = {
    dict: TrackedDict,
    list: TrackedList,
    set: TrackedSet,
    deque: TrackedDeque,
}


def register_shared(name: str, obj):
    """Register a mutable shared structure with the sanitizer.

    Opsan off: returns ``obj`` untouched. Opsan on: returns a tracked
    proxy of the same built-in type seeded with ``obj``'s contents; the
    original is discarded. Unknown types return untouched (the registry
    is additive — registering can never break a type contract)."""
    if not opsan_enabled():
        return obj
    wrapper = _WRAPPERS.get(type(obj))
    if wrapper is None:
        # already-tracked object re-registered, or an unwrappable type
        return obj
    unique = runtime().unique_var_name(name)
    if wrapper is TrackedDeque:
        tracked = TrackedDeque(obj, obj.maxlen)
    else:
        tracked = wrapper(obj)
    tracked._opsan_name = unique
    with _names_mu:
        _names.append(unique)
    return tracked
