"""Radix prefix cache over the paged pool — the port's own copy of
``sentio_tpu/runtime/radix.py`` (host code only; the port imports nothing
of the JAX package).

A token-id radix tree whose edges own runs of **full KV pages**
(RadixAttention-style sharing layered on the page pool). Admission does a
longest-prefix match, reuses the matched pages read-only, and prefills
only the unmatched suffix; every admitted prompt's full-page span is
inserted back, so the tree learns the shared heads (the chat template,
the generate prompt that the verify prompt embeds) with no registration.

* **page granularity** — edges hold whole pages and nodes split only at
  page boundaries; children are keyed by their edge's first page of tokens
  (a tuple), since two siblings may agree on a first token and diverge
  later in the page.
* **refcount pinning** — a live slot locks the node chain its page table
  references; eviction touches only refcount-0 leaves, so a shared page is
  never freed (and rewritten) while a sequence still attends to it.
* **LRU under pressure** — the engine evicts unpinned leaves oldest touch
  first (a touch is a match walking through the node), cascading upward as
  parents become leaves.

Single-threaded, like the engine that owns it. The tree tracks integer
page ids and never touches the device; the engine orders the KV writes by
its dispatch sequence.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Optional, Sequence

__all__ = ["RadixNode", "RadixPrefixCache"]


class RadixNode:
    """One edge of the tree: ``tokens`` (length a multiple of page_size)
    backed by ``pages`` (one id per page_size tokens)."""

    __slots__ = ("tokens", "pages", "children", "parent", "refcount",
                 "last_used")

    def __init__(self, tokens: list[int], pages: list[int],
                 parent: Optional["RadixNode"]) -> None:
        self.tokens = tokens
        self.pages = pages
        self.children: dict[tuple, "RadixNode"] = {}
        self.parent = parent
        self.refcount = 0
        self.last_used = 0

    def __repr__(self) -> str:  # debugging aid only
        return (f"RadixNode(tokens={len(self.tokens)}, pages={self.pages}, "
                f"rc={self.refcount}, children={len(self.children)})")


class RadixPrefixCache:
    """Token-id radix tree over page-aligned KV page runs.

    The cache OWNS the pages held by its nodes: the engine transfers
    ownership on :meth:`insert` (donated pages are no longer freed at slot
    retirement) and gets them back via :meth:`evict`, which returns freed
    ids to the allocator.
    """

    def __init__(self, page_size: int, allocator) -> None:
        self.page_size = page_size
        self.allocator = allocator
        self.root = RadixNode([], [], None)  # guarded-by: engine-thread
        self.pages_held = 0  # guarded-by: engine-thread
        self.node_count = 0  # guarded-by: engine-thread
        self.evicted_pages = 0  # guarded-by: engine-thread
        self._clock = itertools.count(1)

    # ------------------------------------------------------------------ reads

    @property
    def empty(self) -> bool:
        return not self.root.children

    def match(self, tokens: Sequence[int]) -> tuple[int, list[int], Optional[RadixNode]]:
        """Longest page-aligned prefix of ``tokens`` present in the tree →
        ``(n_matched, pages, deepest_node)``. Only whole pages match; a
        partial match inside an edge returns that edge's node (pinning it
        protects the matched page prefix). Touches the walked path for LRU.
        """
        page = self.page_size
        now = next(self._clock)
        node = self.root
        pages: list[int] = []
        pos = 0
        while pos + page <= len(tokens):
            key = tuple(tokens[pos : pos + page])
            child = node.children.get(key)
            if child is None:
                break
            # count full pages of the edge matching from ``pos``
            j = 1  # first page matched via the key
            edge_pages = len(child.pages)
            while j < edge_pages:
                lo = pos + j * page
                if lo + page > len(tokens) or \
                        child.tokens[j * page : (j + 1) * page] != list(tokens[lo : lo + page]):
                    break
                j += 1
            pages.extend(child.pages[:j])
            pos += j * page
            child.last_used = now
            if j < edge_pages:
                return pos, pages, child
            node = child
        # touch ancestors so a deep hit refreshes its whole path
        walk = node
        while walk is not None:
            walk.last_used = now
            walk = walk.parent
        return pos, pages, (node if node is not self.root else None)

    def peek_prefix(self, tokens: Sequence[int]) -> int:
        """Length (in tokens) of the longest page-aligned prefix of
        ``tokens`` this tree holds, WITHOUT taking refcounts or touching
        LRU clocks — a read-only probe of how much of a prompt's KV this
        tree could serve.

        Unlike every other method, this one may be called from a thread
        other than the one that steps the engine: it only reads (dict ``.get``, list
        slices — each GIL-atomic), never mutates, and its result is an
        advisory hint, not a correctness input."""
        page = self.page_size
        node = self.root
        pos = 0
        while pos + page <= len(tokens):
            child = node.children.get(tuple(tokens[pos : pos + page]))
            if child is None:
                break
            j = 1
            edge_pages = len(child.pages)
            while j < edge_pages:
                lo = pos + j * page
                if lo + page > len(tokens) or \
                        child.tokens[j * page : (j + 1) * page] != list(tokens[lo : lo + page]):
                    break
                j += 1
            pos += j * page
            if j < edge_pages:
                break
            node = child
        return pos

    # ----------------------------------------------------------------- writes

    def insert(self, tokens: Sequence[int], start: int, pages: Sequence[int],
               ) -> tuple[Optional[RadixNode], list[int]]:
        """Insert ``tokens`` (page-aligned length) whose span ``[start:)``
        is backed by ``pages`` (the inserting slot's own, freshly prefilled
        pages; ``start`` is page-aligned — the span the slot matched at
        admission). Returns ``(deepest_node, donated)`` where ``donated``
        are the pages whose ownership moved to the tree; pages covering
        spans some earlier insert already cached stay with the caller.
        """
        page = self.page_size
        assert len(tokens) % page == 0 and start % page == 0
        now = next(self._clock)
        node = self.root
        pos = 0
        donated: list[int] = []
        while pos < len(tokens):
            key = tuple(tokens[pos : pos + page])
            child = node.children.get(key)
            if child is None:
                if pos < start:
                    # the matched span must still be present: admission
                    # pinned it, and pins block eviction
                    raise RuntimeError(
                        f"radix insert: matched span [{pos}:{start}) vanished"
                    )
                new_pages = list(pages[(pos - start) // page :])
                tail = RadixNode(list(tokens[pos:]), new_pages, node)
                tail.last_used = now
                node.children[key] = tail
                donated.extend(new_pages)
                self.pages_held += len(new_pages)
                self.node_count += 1
                node = tail
                pos = len(tokens)
                break
            # walk the edge page by page
            j = 1
            edge_pages = len(child.pages)
            while j < edge_pages:
                lo = pos + j * page
                if lo + page > len(tokens) or \
                        child.tokens[j * page : (j + 1) * page] != list(tokens[lo : lo + page]):
                    break
                j += 1
            child.last_used = now
            if j < edge_pages:
                split = self._split(child, j)
                pos += j * page
                if pos >= len(tokens):
                    node = split
                    break
                node = split
                continue  # diverged mid-edge: next loop attaches the tail
            node = child
            pos += edge_pages * page
        return (node if node is not self.root else None), donated

    def _split(self, node: RadixNode, j: int) -> RadixNode:
        """Split ``node``'s edge after ``j`` pages; returns the new upper
        node (which keeps the parent link, refcount, and children key)."""
        page = self.page_size
        upper = RadixNode(node.tokens[: j * page], node.pages[:j], node.parent)
        upper.last_used = node.last_used
        # a pin on the lower node pins its whole chain; the upper node
        # inherits the count so chain pins stay consistent after the split
        upper.refcount = node.refcount
        key = tuple(node.tokens[:page])
        node.parent.children[key] = upper
        node.tokens = node.tokens[j * page :]
        node.pages = node.pages[j:]
        node.parent = upper
        upper.children[tuple(node.tokens[:page])] = node
        self.node_count += 1
        return upper

    # ------------------------------------------------------------- pin/unpin

    def lock(self, node: Optional[RadixNode]) -> None:
        """Pin ``node`` and every ancestor (a slot's page table references
        the whole chain down to its match point)."""
        while node is not None and node is not self.root:
            node.refcount += 1
            node = node.parent

    def unlock(self, node: Optional[RadixNode]) -> None:
        while node is not None and node is not self.root:
            node.refcount -= 1
            assert node.refcount >= 0, "radix refcount underflow"
            node = node.parent

    # -------------------------------------------------------------- eviction

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages from unpinned leaves, LRU first,
        cascading to parents as they become leaves. Returns pages freed
        (returned to the allocator). One tree traversal total: candidates
        collect into a ``last_used`` min-heap and parents push as their
        last child evicts — not a fresh full-tree scan per victim, which
        would cost O(nodes x victims) on the admission path exactly when
        the pool is most contended."""
        heap: list[tuple[int, int, RadixNode]] = []
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif node.refcount == 0:
                heap.append((node.last_used, id(node), node))
        heapq.heapify(heap)
        freed = 0
        while freed < n_pages and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            self.allocator.free(victim.pages)
            freed += len(victim.pages)
            self.pages_held -= len(victim.pages)
            self.evicted_pages += len(victim.pages)
            self.node_count -= 1
            del parent.children[tuple(victim.tokens[: self.page_size])]
            if parent is not self.root and not parent.children \
                    and parent.refcount == 0:
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        return freed

    def clear(self) -> None:
        """Drop every node, returning all held pages to the allocator.
        Callers must ensure no live page table references the tree."""
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.allocator.free(node.pages)
        self.root = RadixNode([], [], None)
        self.pages_held = 0
        self.node_count = 0

    # ------------------------------------------------------------------ stats

    def stats(self) -> dict:
        return {
            "pages": self.pages_held,
            "nodes": self.node_count,
            "evicted_pages": self.evicted_pages,
        }
