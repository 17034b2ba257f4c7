"""Block-granular prefix KV page cache — prefill shared prompt stems ONCE
(the port of ``dtf_tpu.serve.pages``).

Shared prompt stems (system prompts, few-shot headers) are redundant work:
every request re-runs the same prefill over the same leading tokens. The
engine keeps a device **page pool** — fixed-size windows of KV (every
batch-led cache leaf, int8 scales included, one page id spanning ALL
layers) — and the host-side :class:`PrefixIndex` maps whole prefixes to
chains of pages.

- A page covers positions ``[i*page_size, (i+1)*page_size)`` of a request
  that started at position 0: positions are absolute, so roped K/V is
  reusable bit for bit by any request whose prefix TOKENS match exactly.
- The key is the hash of the **entire prefix** through the page (K/V at
  position t depends on every token <= t); a lookup checks the stored
  token tuple exactly, so a hash collision never serves wrong KV.
- Entries form parent chains (the page for prefix length ``2p`` holds a
  ref on the page for ``p``) and admitted requests pin the chain they
  load: LRU eviction only takes an unpinned, childless entry.
- Pages are COPIED into a slot's own cache on admission (one gather for
  the whole chain) and out of a slot after a prefill; decode never
  touches the pool.
- **Save admission**: a page is copied out only once its prefix has been
  seen ``save_after`` times (default 2), so a request's unique tail costs
  no save and takes no pool page.

The device half (the pool and the two page steps) lives in ``engine.py``;
:func:`pool_abstract` builds the pool's shapes from the engine's cache so
the two cannot disagree. Pure Python and torch: nothing here imports the
JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional, Sequence

import torch

from dtf_tpu_torch.models import gpt


def pool_abstract(cache: list, n_pages: int, page_size: int) -> list:
    """The page pool's layout from the engine's slot cache, as ``meta``
    tensors (shapes and dtypes, no memory): every batch-led ``[S, H, L,
    D]`` leaf of a layer becomes ``[P, H, page, D]`` under the same name
    (an int8 cache brings its scales); ``cache_index`` is dropped — a
    page's positions are host bookkeeping."""
    pool = []
    for layer in cache:
        pages = {}
        for name, x in layer.items():
            if gpt.batch_led_cache_key(name) and x is not None:
                pages[name] = torch.empty(
                    (n_pages, x.shape[1], page_size, x.shape[3]),
                    dtype=x.dtype, device="meta")
        pool.append(pages)
    return pool


class PageStore:
    """Mountable prefix-page state: ONE device pool and ONE host
    :class:`PrefixIndex` that several engines may share
    (``DecodeEngine(shared_pages=engine.page_store)``). The page steps
    write the pool in place and the pump loop is single-threaded, so a
    plain holder is the whole mechanism. Over a mesh (``mesh``) the pool
    holds this rank's heads of every page, whole on each data line; the
    engines that mount it share its owner's call ``plane``, and only the
    leader's index is consulted (a hand-off is a page save on one
    replica and a load on another of the same ranks)."""

    def __init__(self, pool: list, index: "PrefixIndex", *, mesh=None,
                 plane=None):
        self.pool = pool
        self.index = index
        self.mesh = mesh
        self.plane = plane


def check_pool_compatible(pool: list, pool_abs: list) -> None:
    """A shared pool must be what the mounting engine would have allocated
    (same layers, leaves, shapes and dtypes): a mismatch would gather
    wrong-shaped KV into a live slot."""
    if len(pool) != len(pool_abs):
        raise ValueError(f"shared page pool has {len(pool)} layers, engine "
                         f"expects {len(pool_abs)}")
    for i, (got, want) in enumerate(zip(pool, pool_abs)):
        if sorted(got) != sorted(want):
            raise ValueError(
                f"shared page pool layer {i} holds {sorted(got)}, engine "
                f"expects {sorted(want)} — different cache layout (kv "
                "dtype?)")
        for name, w in want.items():
            g = got[name]
            if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
                raise ValueError(
                    f"shared page pool leaf layer {i} {name} is "
                    f"{tuple(g.shape)}/{g.dtype}, engine expects "
                    f"{tuple(w.shape)}/{w.dtype} — the engines mounting "
                    "one store must be built identically")


@dataclasses.dataclass
class _Entry:
    """One cached page: ``tokens`` is the WHOLE prefix through this page
    (exact-match check), ``refs`` counts children and live pins, ``epoch``
    the param version whose weights produced the KV — a lookup matches
    only entries of the asking engine's version."""

    page_id: int
    tokens: tuple
    parent: Optional["_Entry"]
    refs: int = 0
    last_use: int = 0
    epoch: int = 0


@dataclasses.dataclass(frozen=True)
class PrefixHandle:
    """A pinned chain of pages covering ``n_tokens`` leading prompt
    tokens, root to leaf; hold it for the request's lifetime and release
    it exactly once (the deepest entry carries the pin)."""

    entries: tuple
    n_tokens: int


class PrefixIndex:
    """Host index over the page pool: token-hash keyed, exact-checked,
    refcounted, LRU-evicting. Pure bookkeeping — never touches a device
    value (the engine runs the copies). ``hash_fn`` is injectable so tests
    can force collisions."""

    def __init__(self, n_pages: int, page_size: int, *,
                 save_after: int = 2,
                 hash_fn: Callable[[tuple], int] = hash):
        if n_pages < 1:
            raise ValueError(f"n_pages={n_pages} must be >= 1")
        if page_size < 1:
            raise ValueError(f"page_size={page_size} must be >= 1")
        if save_after < 1:
            raise ValueError(f"save_after={save_after} must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self.save_after = save_after
        self._hash = hash_fn
        self._by_hash: dict[int, list[_Entry]] = {}
        self._free = list(range(n_pages))
        self._clock = 0
        #: sightings of not-yet-cached prefixes (the save-admission
        #: filter), bounded so a stream of unique prompts cannot grow it
        self._seen: "collections.OrderedDict[tuple, int]" = (
            collections.OrderedDict())
        self._seen_cap = 16 * n_pages
        # token-level hit/miss totals live on the engine's counters (one
        # writer)
        self.stats = {"hits": 0, "misses": 0, "evictions": 0}

    # ------------------------------------------------------------- lookup

    def _find(self, tokens: tuple, epoch: int = 0) -> Optional[_Entry]:
        for e in self._by_hash.get(self._hash(tokens), ()):
            if e.tokens == tokens and e.epoch == epoch:
                return e
        return None

    def longest(self, prompt: Sequence[int],
                cap: Optional[int] = None, *,
                epoch: int = 0) -> tuple[int, Optional[_Entry]]:
        """Longest registered chain covering a prefix of ``prompt`` at
        ``epoch``: ``(n_pages, deepest entry)``. ``cap`` bounds the page
        count (admission caps at ``(len-1)//page`` so at least one prompt
        token runs live: the first token needs the last position's
        logits)."""
        p = self.page_size
        top = len(prompt) // p if cap is None else cap
        for k in range(top, 0, -1):
            e = self._find(tuple(prompt[:k * p]), epoch)
            if e is not None:
                return k, e
        return 0, None

    def acquire(self, prompt: Sequence[int], *,
                epoch: int = 0) -> Optional[PrefixHandle]:
        """Pin the longest reusable chain for ``prompt`` at ``epoch`` (the
        admission lookup). None on a miss; on a hit the DEEPEST entry
        takes one pin (child refs hold its ancestors)."""
        cap = max(0, (len(prompt) - 1) // self.page_size)
        k, e = self.longest(prompt, cap=cap, epoch=epoch)
        if e is None:
            self.stats["misses"] += 1
            return None
        chain: list[_Entry] = []
        node: Optional[_Entry] = e
        while node is not None:
            chain.append(node)
            node = node.parent
        chain.reverse()
        if len(chain) != k:
            raise RuntimeError(f"page chain of {len(chain)} entries for a "
                               f"{k}-page prefix: the index is corrupt")
        self._clock += 1
        for n in chain:
            n.last_use = self._clock
        e.refs += 1
        self.stats["hits"] += 1
        return PrefixHandle(entries=tuple(chain),
                            n_tokens=k * self.page_size)

    def release(self, handle: PrefixHandle) -> None:
        leaf = handle.entries[-1]
        if leaf.refs < 1:
            raise RuntimeError("prefix handle released twice")
        leaf.refs -= 1

    # ------------------------------------------------------------ reserve

    def save_eligible(self, prompt: Sequence[int], have: int,
                      full: int, *, epoch: int = 0) -> int:
        """The save-admission filter: count a sighting of every not yet
        cached full-page prefix of ``prompt`` (pages ``have`` to ``full``)
        and return how many CONTIGUOUS pages from ``have`` have now been
        seen ``save_after`` times. The first unpopular page stops the
        chain; deeper pages only record their sighting."""
        p = self.page_size
        eligible, counting = 0, True
        for i in range(have, full):
            prefix = (epoch, tuple(prompt[:(i + 1) * p]))
            c = self._seen.pop(prefix, 0) + 1
            self._seen[prefix] = c               # re-insert = LRU refresh
            while len(self._seen) > self._seen_cap:
                self._seen.popitem(last=False)
            if counting and c >= self.save_after:
                eligible += 1
            else:
                counting = False
        return eligible

    def reserve(self, prefix: tuple, parent: Optional[_Entry], *,
                epoch: int = 0) -> Optional[_Entry]:
        """Allocate a page for ``prefix`` at ``epoch`` and register it —
        from the free list, else by evicting the LRU unpinned childless
        entry. None when every page is pinned or parented (the save is
        skipped, never blocked). ``parent`` is the entry of ``prefix``
        less one page (None for the first page), of the same epoch."""
        if len(prefix) != (0 if parent is None
                           else len(parent.tokens)) + self.page_size:
            raise ValueError(
                f"prefix of {len(prefix)} tokens does not extend parent "
                f"({0 if parent is None else len(parent.tokens)}) by one "
                f"{self.page_size}-token page")
        if parent is not None and parent.epoch != epoch:
            raise ValueError(
                f"parent epoch {parent.epoch} != {epoch}: a page chain "
                "cannot mix KV from two param versions")
        if self._find(prefix, epoch) is not None:
            raise ValueError("prefix already registered; look it up "
                             "instead of reserving a duplicate page")
        if not self._free:
            # ``parent`` may be a childless leaf (refs 0) that this save
            # is extending: evicting it would hand its page id to the new
            # child and leave a chain whose parent page holds other KV
            victim = min(
                (e for es in self._by_hash.values() for e in es
                 if e.refs == 0 and e is not parent),
                key=lambda e: e.last_use, default=None)
            if victim is None:
                return None
            self._evict(victim)
        pid = self._free.pop()
        self._clock += 1
        e = _Entry(pid, prefix, parent, refs=0, last_use=self._clock,
                   epoch=epoch)
        if parent is not None:
            parent.refs += 1
        self._by_hash.setdefault(self._hash(prefix), []).append(e)
        self._seen.pop((epoch, prefix), None)   # cached now: sightings done
        return e

    def invalidate_stale(self, epoch: int) -> int:
        """Free every unpinned entry whose ``epoch`` differs from the
        current one, leaf first until nothing changes (evicting a child
        unparents its ancestor). Lookups already ignore other epochs;
        this reclaims their pages. Returns the number freed."""
        freed = 0
        while True:
            stale = [e for es in self._by_hash.values() for e in es
                     if e.epoch != epoch and e.refs == 0]
            if not stale:
                return freed
            for e in stale:
                self._evict(e)
                freed += 1

    def _evict(self, e: _Entry) -> None:
        es = self._by_hash[self._hash(e.tokens)]
        es.remove(e)
        if not es:
            del self._by_hash[self._hash(e.tokens)]
        if e.parent is not None:
            e.parent.refs -= 1
        self._free.append(e.page_id)
        self.stats["evictions"] += 1

    # ------------------------------------------------------------- report

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_entries(self) -> int:
        return sum(len(v) for v in self._by_hash.values())

    def pinned(self) -> int:
        """Live pins over all entries (children excluded): 0 once every
        admitted request has released its handle."""
        entries = [e for es in self._by_hash.values() for e in es]
        kids = collections.Counter(id(e.parent) for e in entries
                                   if e.parent is not None)
        return sum(e.refs - kids[id(e)] for e in entries)
