"""Host-side page bookkeeping for the paged KV caches.

Carried over from ``repro/models/paging.py`` with its logic unchanged, so
one scripted sequence gives identical pages, refcounts and matches in both
packages.  Pure Python, so the pure-sim scheduler can model page pressure
without touching a device.  Two classes:

* :class:`PagePool` — the allocator behind ``init_paged_cache`` caches,
  now **refcounted**: ``alloc`` hands out pages at refcount 1, ``incref``
  lets a second request map the same page (prefix sharing), and ``free``
  decrements — a page returns to the free list only when its last
  reference drops.  ``reserve``/``unreserve`` close the admission/alloc
  race: the scheduler admits against ``available`` long before the
  chunked prefill lands and allocates, so admission *reserves* its page
  budget up front and the later ``alloc(..., reserved=True)`` consumes
  the reservation instead of re-contending for the free list.

* :class:`PrefixIndex` — a radix-style longest-prefix match over
  page-granularity token hashes.  A request's prompt is split into
  ``page_size``-token full pages; each full page is keyed by the hash
  chain ``key_i = H(key_{i-1}, tokens_page_i)``, so two prompts sharing
  a prefix share chain keys and therefore page ids.  The index holds its
  *own* pool reference on every registered page (cached prefixes survive
  their donor), and under pool pressure the allocator reclaims
  index-only pages in LRU order.  The donor's partial tail page (the
  page its prompt ends inside) is registered by content but never
  zero-copy shared: the donor writes into it on its first decode step,
  so a consumer **copies** the tail content into a private page before
  writing — the copy-on-write rule.

Sharing soundness: a page is registered only if its *content* is a pure
function of the prompt prefix and its donor will never write it again.
Full-attention prompt pages qualify (post-RoPE K/V at absolute
positions; decode writes land at ``pos >= prompt_len``, strictly after
the prefix pages).  Sliding-window ring pages do not — the ring rewraps
into them during decode — so models with SWA/local/recurrent layers
disable sharing entirely (``prefix_sharing_supported`` in
``models/decode.py``; the same restriction vLLM applies to sliding
windows).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple


class PagePool:
    """Refcounted host-side page allocator for paged KV caches.

    Page ids index rows of every layer's pool array.  The scheduler
    reserves a request's page budget at admission (``pages_needed`` for
    prompt + max_new_tokens minus any shared prefix pages), the insert
    path allocates against the reservation, and ``free`` releases one
    reference per page — shared pages survive until every mapper and the
    prefix index have let go.
    """

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self._free = deque(range(self.num_pages))
        self._ref = [0] * self.num_pages
        self._reserved = 0

    @property
    def available(self) -> int:
        """Pages grantable to a new admission (free minus reserved)."""
        return len(self._free) - self._reserved

    @property
    def reserved(self) -> int:
        return self._reserved

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def reserve(self, n: int) -> bool:
        """Earmark ``n`` pages for a future ``alloc(..., reserved=True)``.
        Fails (False) rather than over-subscribing."""
        if n > self.available:
            return False
        self._reserved += n
        return True

    def unreserve(self, n: int) -> None:
        """Return an unused reservation (e.g. mid-prefill eviction)."""
        if n > self._reserved:
            raise ValueError(
                f"unreserve({n}) exceeds outstanding reservation "
                f"{self._reserved}")
        self._reserved -= n

    def alloc(self, n: int, reserved: bool = False) -> Optional[List[int]]:
        """``n`` page ids at refcount 1, or None when the pool cannot
        satisfy the request (the caller queues the admission instead of
        over-subscribing).  ``reserved=True`` consumes a prior
        :meth:`reserve` of the same size instead of drawing down
        ``available``."""
        if reserved:
            if n > self._reserved:
                raise ValueError(
                    f"alloc(reserved=True) of {n} pages without reservation "
                    f"(outstanding {self._reserved})")
            if n > len(self._free):
                return None         # reservation outlived the free list: bug
            self._reserved -= n
        elif n > self.available:
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        """Add one reference per page (prefix sharing / index retention)."""
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page {p} outside pool")
            if self._ref[p] == 0:
                raise ValueError(f"incref of free page {p}")
            self._ref[p] += 1

    def free(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; a page rejoins the free list only
        at refcount zero.  Freeing a free page is a double free.  Returns
        the pages that actually hit zero (now recyclable) so the caller
        can invalidate any content index entries over them."""
        released: List[int] = []
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page {p} outside pool")
            if self._ref[p] == 0:
                raise ValueError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                released.append(p)
        return released

    def conserved(self) -> bool:
        """Audit: every page is either free or referenced, never both."""
        free = set(self._free)
        if len(free) != len(self._free):
            return False
        for p in range(self.num_pages):
            if (self._ref[p] == 0) != (p in free):
                return False
        return 0 <= self._reserved <= len(self._free)


def page_keys(tokens: Sequence, page_size: int) -> List[int]:
    """Hash-chain keys of the full ``page_size``-token pages of ``tokens``.

    ``key_i`` commits to every token in pages 0..i, so equal keys mean
    equal prefixes (up to hash collision) and a dict over keys is a radix
    tree with O(1) node lookup.  Tokens only need to be hashable — real
    runners pass Python ints (``tuple(int(t) ...)``: a tensor element
    hashes by identity, so it would never match), the sim runner passes
    synthetic tuples.
    """
    keys, parent = [], 0
    for i in range(len(tokens) // page_size):
        page = tuple(tokens[i * page_size:(i + 1) * page_size])
        parent = hash((parent, page))
        keys.append(parent)
    return keys


@dataclasses.dataclass
class PrefixMatch:
    """Result of a longest-prefix lookup.

    ``pages`` are the zero-copy-shareable full pages (caller increfs);
    ``tail_page``/``tail_tokens`` describe a copy-on-write hit: the
    donor's partial tail page whose first ``tail_tokens`` slots hold the
    continuation of the matched prefix — the consumer must *copy* its
    content into a private page before writing (the donor writes into its
    own copy on its first decode step).  ``tokens`` is the total prompt
    tokens the match covers (full pages + tail).
    """
    n_pages: int
    pages: List[int]
    tail_page: Optional[int] = None
    tail_tokens: int = 0
    tokens: int = 0


class _Entry:
    __slots__ = ("key", "parent", "page", "children", "stamp")

    def __init__(self, key, parent, page, stamp):
        self.key = key
        self.parent = parent            # parent chain key (0 = root)
        self.page = page                # pool page id this entry retains
        self.children: Set[int] = set()
        self.stamp = stamp              # LRU clock (monotonic counter)


class PrefixIndex:
    """Longest-prefix page cache over full-page hash chains.

    The index owns one pool reference per registered page, so cached
    prefixes outlive their donors; :meth:`reclaim` releases LRU
    leaf-first entries back to the pool under memory pressure.  Partial
    tail pages are tracked separately (content, not mapping): they are
    CoW sources only, and the donor invalidates its tail entry the
    moment it first writes into the page (``invalidate_tail``).
    """

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._entries: Dict[int, _Entry] = {}
        self._tails: Dict[int, Tuple[int, tuple]] = {}  # parent -> (page, toks)
        self._tail_owner: Dict[int, int] = {}           # page -> parent key
        self._clock = 0
        # counters surfaced as serve metrics
        self.lookups = 0
        self.hits = 0
        self.tokens_served = 0
        self.pages_shared = 0
        self.cow_copies = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @property
    def n_pages(self) -> int:
        return len(self._entries)

    def held_pages(self) -> List[int]:
        return [e.page for e in self._entries.values()]

    # -- lookup -------------------------------------------------------------

    def match(self, tokens: Sequence, limit: Optional[int] = None
              ) -> PrefixMatch:
        """Longest registered prefix of ``tokens`` (full pages, plus a CoW
        tail if the donor's partial tail continues the match).  ``limit``
        caps matched tokens (callers clamp to ``prompt_len - 1`` so at
        least one token remains to prefill and produce logits)."""
        self.lookups += 1
        pg = self.page_size
        pages: List[int] = []
        parent = 0
        for key in page_keys(tokens, pg):
            e = self._entries.get(key)
            if e is None:
                break
            e.stamp = self._tick()
            pages.append(e.page)
            parent = key
        matched = len(pages) * pg
        tail_page, tail_tokens = None, 0
        tail = self._tails.get(parent)
        if tail is not None:
            page, toks = tail
            cont = tuple(tokens[matched:matched + len(toks)])
            if cont == toks:
                tail_page, tail_tokens = page, len(toks)
        m = PrefixMatch(n_pages=len(pages), pages=pages,
                        tail_page=tail_page, tail_tokens=tail_tokens)
        total = matched + tail_tokens
        if limit is not None and total > limit:
            # trim whole pages (and the tail) until within the cap
            total = min(total, max(0, limit))
            if total < matched:
                m.pages = m.pages[:total // pg]
                m.n_pages = len(m.pages)
                m.tail_page, m.tail_tokens = None, 0
                total = m.n_pages * pg
            else:
                m.tail_tokens = total - matched
                if m.tail_tokens == 0:
                    m.tail_page = None
        m.tokens = total
        if total > 0:
            self.hits += 1
            self.tokens_served += total
            self.pages_shared += m.n_pages
            if m.tail_page is not None:
                self.cow_copies += 1
        return m

    # -- registration -------------------------------------------------------

    def insert(self, tokens: Sequence, pages: Sequence[int],
               pool: PagePool) -> int:
        """Register a finished prefill's prompt pages.  ``pages`` is the
        request's page list (full prompt pages first); each *new* chain
        entry increfs its page so the cached prefix survives the donor.
        The partial tail page (if the prompt ends mid-page) is registered
        as a CoW source.  Returns the number of newly retained pages."""
        pg = self.page_size
        new, parent = 0, 0
        for i, key in enumerate(page_keys(tokens, pg)):
            e = self._entries.get(key)
            if e is None:
                e = _Entry(key, parent, int(pages[i]), self._tick())
                self._entries[key] = e
                if parent in self._entries:
                    self._entries[parent].children.add(key)
                pool.incref([e.page])
                new += 1
            else:
                e.stamp = self._tick()
            parent = key
        n_full = len(tokens) // pg
        rem = len(tokens) - n_full * pg
        if rem and n_full < len(pages) and parent not in self._tails:
            # tail registered by content only — no pool reference: the CoW
            # consumer copies synchronously at admission, and the donor
            # invalidates on its first write
            page = int(pages[n_full])
            self._tails[parent] = (page, tuple(tokens[n_full * pg:]))
            self._tail_owner[page] = parent
        return new

    def invalidate_tail(self, page: int) -> None:
        """The donor is about to write into ``page``: its content no longer
        equals the registered prefix continuation."""
        parent = self._tail_owner.pop(page, None)
        if parent is not None:
            self._tails.pop(parent, None)

    # -- reclamation --------------------------------------------------------

    def reclaimable(self, pool: PagePool) -> int:
        """Pages the index could hand back: held only by the index (no live
        request maps them) and safe to drop leaf-first."""
        return sum(1 for e in self._entries.values()
                   if pool.refcount(e.page) == 1)

    def reclaim(self, n: int, pool: PagePool) -> int:
        """Release up to ``n`` index-held pages back to the pool, LRU
        leaf-first (an inner node outlives its children so a future match
        still walks a contiguous prefix).  Returns pages released."""
        released = 0
        while released < n:
            victims = [e for e in self._entries.values()
                       if not e.children and pool.refcount(e.page) == 1]
            if not victims:
                break
            e = min(victims, key=lambda v: v.stamp)
            self._drop(e, pool)
            released += 1
        return released

    def _drop(self, e: _Entry, pool: PagePool) -> None:
        del self._entries[e.key]
        parent = self._entries.get(e.parent)
        if parent is not None:
            parent.children.discard(e.key)
        tail = self._tails.pop(e.key, None)
        if tail is not None:
            self._tail_owner.pop(tail[0], None)
        pool.free([e.page])

    def drop_all(self, pool: PagePool) -> int:
        """Release every index reference (shutdown / tests)."""
        n = 0
        for e in list(self._entries.values()):
            del self._entries[e.key]
            pool.free([e.page])
            n += 1
        self._tails.clear()
        self._tail_owner.clear()
        return n

    def stats(self) -> Dict[str, int]:
        return {"lookups": self.lookups, "hits": self.hits,
                "tokens_served": self.tokens_served,
                "pages_shared": self.pages_shared,
                "cow_copies": self.cow_copies,
                "resident_pages": len(self._entries)}
