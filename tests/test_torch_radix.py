"""The port's radix prefix cache against the JAX package's.

``sentio_tpu_torch/runtime/radix.py`` is the port's own copy of
``sentio_tpu/runtime/radix.py`` (host code; the port imports nothing of
the JAX package). Both trees, each over its own page allocator, are driven
by the same seeded random sequence of ``match``, ``insert`` (with the
engine's lock / alloc / donate protocol), ``lock``, ``unlock``, ``evict``
and ``peek_prefix`` calls over token sequences that share heads and split
edges. Every return value, ``stats()``, the node and page counts and the
allocators' free lists must be identical after every call."""

import numpy as np
import pytest

from sentio_tpu.runtime.paged import PageAllocator as JaxAllocator
from sentio_tpu.runtime.radix import RadixPrefixCache as JaxRadix
from sentio_tpu_torch.runtime.paged import PageAllocator
from sentio_tpu_torch.runtime.radix import RadixPrefixCache

PAGE = 4
NUM_PAGES = 40


def _sig(node):
    """A node by value: its edge tokens and pages, up to the root."""
    out = []
    while node is not None and node.parent is not None:
        out.append((tuple(node.tokens), tuple(node.pages), node.refcount))
        node = node.parent
    return tuple(out)


class _Pair:
    """The two trees side by side; each call runs on both and the results
    are compared."""

    def __init__(self):
        self.alloc = (JaxAllocator(NUM_PAGES), PageAllocator(NUM_PAGES))
        self.trees = (JaxRadix(PAGE, self.alloc[0]), RadixPrefixCache(PAGE, self.alloc[1]))
        self.pins = []  # (jax node, port node) pairs a "slot" holds

    def check(self):
        a, b = self.trees
        assert a.stats() == b.stats()
        assert (a.pages_held, a.node_count, a.empty) == (b.pages_held, b.node_count, b.empty)
        assert self.alloc[0]._free == self.alloc[1]._free

    def match(self, seq):
        (ma, pa, na), (mb, pb, nb) = (t.match(seq) for t in self.trees)
        assert (ma, pa, _sig(na)) == (mb, pb, _sig(nb))
        return na, nb, ma

    def admit(self, seq):
        """What the engine does for a prompt: match, pin, allocate the
        unmatched full pages (evicting when short), insert, move the pin to
        the deepest node, give back what was not donated."""
        full = (len(seq) // PAGE) * PAGE
        na, nb, matched = self.match(seq[:full])
        need = (full - matched) // PAGE
        for tree in self.trees:
            tree.lock(na if tree is self.trees[0] else nb)
        if need > self.alloc[1].free_pages:
            freed = [t.evict(need - self.alloc[i].free_pages)
                     for i, t in enumerate(self.trees)]
            assert freed[0] == freed[1]
        if need > self.alloc[1].free_pages:
            for tree, node in zip(self.trees, (na, nb)):
                tree.unlock(node)
            return
        pages = [a.alloc(need) for a in self.alloc]
        assert pages[0] == pages[1]
        (ja, da), (jb, db) = (t.insert(list(seq[:full]), matched, p)
                              for t, p in zip(self.trees, pages))
        assert (_sig(ja), da) == (_sig(jb), db)
        for tree, old, new in zip(self.trees, (na, nb), (ja, jb)):
            if new is not None and new is not old:
                tree.lock(new)
                tree.unlock(old)
        for alloc, p, d in zip(self.alloc, pages, (da, db)):
            alloc.free([x for x in p if x not in set(d)])
        self.pins.append((ja if ja is not None else na, jb if jb is not None else nb))
        # an insert that diverges inside an edge leaves two leaves with one
        # last touch, and eviction breaks such a tie by object address in
        # both trees; touching the new path orders them
        self.match(seq[:full])


def _sequence(rng, stems):
    """A token sequence: one of a few stems, cut at a random point, then a
    random tail, so heads are shared and edges split inside and at pages."""
    stem = stems[rng.integers(len(stems))]
    cut = int(rng.integers(0, len(stem) + 1))
    tail = rng.integers(0, 3, int(rng.integers(0, 4 * PAGE))).tolist()
    return stem[:cut] + tail


@pytest.mark.parametrize("seed", range(8))
def test_random_operations_agree(seed):
    rng = np.random.default_rng(seed)
    stems = [rng.integers(0, 3, int(rng.integers(2, 7)) * PAGE).tolist() for _ in range(4)]
    pair = _Pair()
    for _ in range(300):
        op = rng.choice(["admit", "admit", "match", "peek", "unlock", "evict", "lock"])
        seq = _sequence(rng, stems)
        if op == "admit":
            pair.admit(seq)
        elif op == "match":
            pair.match(seq)
        elif op == "peek":
            assert pair.trees[0].peek_prefix(seq) == pair.trees[1].peek_prefix(seq)
        elif op == "unlock" and pair.pins:
            na, nb = pair.pins.pop(int(rng.integers(len(pair.pins))))
            pair.trees[0].unlock(na)
            pair.trees[1].unlock(nb)
        elif op == "lock":
            na, nb, _matched = pair.match(seq)
            pair.trees[0].lock(na)
            pair.trees[1].lock(nb)
            pair.pins.append((na, nb))
        elif op == "evict":
            n = int(rng.integers(1, 8))
            assert pair.trees[0].evict(n) == pair.trees[1].evict(n)
        pair.check()
    for na, nb in pair.pins:
        pair.trees[0].unlock(na)
        pair.trees[1].unlock(nb)
    assert pair.trees[0].evict(NUM_PAGES) == pair.trees[1].evict(NUM_PAGES)
    pair.check()
    assert pair.trees[1].empty and pair.alloc[1].free_pages == NUM_PAGES - 1


def test_split_keeps_pins_and_clear_returns_every_page():
    """An insert that diverges inside a pinned edge splits it; the upper
    half inherits the pin, so eviction leaves both halves; clear() gives
    every page back."""
    pair = _Pair()
    pair.admit(list(range(3 * PAGE)))
    pair.admit(list(range(PAGE)) + [9] * (2 * PAGE))
    pair.check()
    for tree in pair.trees:
        assert tree.node_count == 3 and tree.evict(100) == 0
    for tree in pair.trees:
        tree.clear()
    pair.check()
    assert pair.alloc[1].free_pages == NUM_PAGES - 1
