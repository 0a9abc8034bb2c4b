"""Pure-python oracles for the skiplist (a copy of ``repro.core.oracle``).

The port keeps its own copy: it imports nothing of ``repro``.  Two
oracles:

* ``DictOracle`` — semantic oracle (sorted-dict behaviour).  Any skiplist
  variant must agree with it on found/vals after an arbitrary op sequence.
* ``PySkipList`` — a faithful python port of Pugh's skiplist WITH foresight
  bookkeeping, used to cross-check structural invariants (towers, fused
  records) and to count node accesses the way the paper's analysis does.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

KEY_MIN = -(2**31)
KEY_MAX = 2**31 - 1


class DictOracle:
    def __init__(self):
        self.d: Dict[int, int] = {}

    def insert(self, k: int, v: int) -> bool:
        if k in self.d:
            self.d[k] = v          # upsert semantics (matches skiplist.insert)
            return False
        self.d[k] = v
        return True

    def delete(self, k: int) -> bool:
        return self.d.pop(k, None) is not None

    def search(self, k: int) -> Tuple[bool, Optional[int]]:
        return (k in self.d, self.d.get(k))

    def sorted_keys(self) -> List[int]:
        return sorted(self.d)


class _Node:
    __slots__ = ("key", "val", "nxt", "fkey")

    def __init__(self, key: int, val: int, height: int):
        self.key = key
        self.val = val
        self.nxt: List[Optional["_Node"]] = [None] * height
        self.fkey: List[int] = [KEY_MAX] * height


class PySkipList:
    """Pugh's skiplist + foresight, with the paper's access accounting."""

    def __init__(self, levels: int = 20, seed: int = 0):
        self.levels = levels
        self.head = _Node(KEY_MIN, 0, levels)
        self.rng = random.Random(seed)
        self.n = 0
        self.accesses = 0          # distinct node visits (paper's counter)

    def _height(self) -> int:
        h = 1
        while h < self.levels and self.rng.random() < 0.5:
            h += 1
        return h

    def _preds(self, k: int) -> List[_Node]:
        preds = [self.head] * self.levels
        x = self.head
        for i in range(self.levels - 1, -1, -1):
            while x.nxt[i] is not None and x.nxt[i].key < k:
                x = x.nxt[i]
            preds[i] = x
        return preds

    def search(self, k: int, foresight: bool = True) -> Tuple[bool, Optional[int]]:
        """Search counting *new node accesses* (paper §3 analysis)."""
        visited = set()
        x = self.head
        visited.add(id(x))
        for i in range(self.levels - 1, -1, -1):
            while True:
                nk = x.fkey[i] if foresight else (
                    x.nxt[i].key if x.nxt[i] else KEY_MAX)
                if not foresight and x.nxt[i] is not None:
                    visited.add(id(x.nxt[i]))   # base must touch the pointee
                if nk < k:
                    x = x.nxt[i]
                    visited.add(id(x))
                else:
                    break
        cand = x.nxt[0]
        if cand is not None:
            visited.add(id(cand))
        self.accesses += len(visited)
        if cand is not None and cand.key == k:
            return True, cand.val
        return False, None

    def insert(self, k: int, v: int) -> bool:
        preds = self._preds(k)
        cand = preds[0].nxt[0]
        if cand is not None and cand.key == k:
            cand.val = v
            return False
        h = self._height()
        node = _Node(k, v, h)
        for i in range(h):
            p = preds[i]
            node.nxt[i] = p.nxt[i]
            node.fkey[i] = p.fkey[i]
            p.nxt[i] = node            # pair written together:
            p.fkey[i] = k              # the MOVDQA-analogue
        self.n += 1
        return True

    def delete(self, k: int) -> bool:
        preds = self._preds(k)
        cand = preds[0].nxt[0]
        if cand is None or cand.key != k:
            return False
        for i in range(len(cand.nxt)):
            p = preds[i]
            p.nxt[i] = cand.nxt[i]
            p.fkey[i] = cand.fkey[i]
        self.n -= 1
        return True

    def sorted_keys(self) -> List[int]:
        out = []
        x = self.head.nxt[0]
        while x is not None:
            out.append(x.key)
            x = x.nxt[0]
        return out

    def check_foresight_invariant(self) -> bool:
        x = self.head
        nodes = [self.head]
        while x.nxt[0] is not None:
            x = x.nxt[0]
            nodes.append(x)
        for nd in nodes:
            for i in range(len(nd.nxt)):
                actual = nd.nxt[i].key if nd.nxt[i] is not None else KEY_MAX
                if nd.fkey[i] != actual:
                    return False
        return True
