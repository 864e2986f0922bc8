"""Tiered radix-tree prefix cache and host-RAM block store: copy of
``paddle_tpu/inference/prefixcache.py`` (``_HostEntry`` :59, ``HostTier``
:96, ``_common_len`` :289, ``RadixNode`` :299, ``RadixPrefixCache``
:317), plus the conversion between arena rows and host parcels.

- **Token-level radix tree** (``RadixPrefixCache``): nodes own runs of
  token ids and the KV blocks whose spans those runs cover; lookup is
  longest-prefix match over tokens, KV mapping stays full-block (the
  partial tail recomputes; shared blocks stay immutable).
- **Host-RAM tier** (``HostTier``): a cached block the pool reclaims has
  its exact at-rest bytes (float K/V, or int8 codes + f32 scale planes)
  gathered out of the arenas and demoted to host RAM instead of dropped;
  a later hit re-scatters them into fresh blocks, byte-identical to
  never having evicted.  The same store parks preemption swap-outs under
  reason ``"preempt"`` (pinned, never evicted); cache parcels evict
  LRU-first under the tier's capacity bound.

Block attachment rule: block ``i`` (tokens ``[i*L, (i+1)*L)``) attaches
to the node holding its LAST token; a usable match maps the contiguous
block prefix from position 0, and a hole (a block dropped because the
host tier was full) ends the mapped span but not the token match.

**Host parcels hold exact bytes.**  A parcel's ``rows`` are numpy stacks,
one per flat arena, holding the arena's at-rest bytes unchanged.  numpy
has no bfloat16, so a bf16 arena's rows are kept as the ``uint16`` view
of their bits (``tensor.view(torch.int16)``, then ``.numpy()`` viewed as
``uint16``: ``host_rows``), never as a float32 round trip, and the
parcel carries the dtype its bits decode to (``_HostEntry.dtypes``, one
torch dtype name per stack).  The scatter turns the bits back with
``torch.from_numpy(...).view(arena.dtype)`` (``device_rows``) and
raises on a stack whose dtype or row shape is not its arena's.  A JAX
replica's parcel (numpy rows of the arena's own dtype, bfloat16 from
``ml_dtypes``) holds the same bytes, so parcels move byte-exact between
a JAX replica and a torch replica.

The tree and the tier are host state: the tree holds block ids and tier
keys, never device buffers.  The ``ServingEngine`` owns the device half
(gather on demote, scatter on promote).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_REASONS = ("preempt", "cache")

# torch dtypes numpy lacks: a parcel keeps their bits in the unsigned
# integer of their width; (torch signed view, numpy signed, numpy unsigned)
_BIT_VIEWS = {torch.bfloat16: (torch.int16, np.int16, np.uint16)}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def row_bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor whose bytes a parcel keeps: ``t`` itself, or for a
    dtype numpy lacks (bfloat16) its signed-integer view of the same
    width.  A view: no copy, no sync."""
    view = _BIT_VIEWS.get(t.dtype)
    return t if view is None else t.view(view[0])


def bits_array(t: torch.Tensor) -> np.ndarray:
    """A host ``row_bits`` tensor as a numpy array that OWNS its bytes
    (a copy, never a view of ``t``, which may be a staging buffer that
    is reused); int16 bits come out as the ``uint16`` view."""
    a = np.array(t.numpy(), copy=True)
    return a.view(np.uint16) if a.dtype == np.int16 else a


def host_rows(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """One arena row stack to the host at its exact bytes: ``(numpy
    stack, name of the dtype its bits decode to)``.  A bfloat16 stack
    travels as the ``uint16`` view of its bits.  Synchronous
    (``.cpu()``)."""
    return bits_array(row_bits(t.detach()).cpu()), _dtype_name(t.dtype)


def device_rows(rows: np.ndarray, dtype_name: str,
                arena: torch.Tensor) -> torch.Tensor:
    """A host row stack back on ``arena``'s device as ``arena``'s dtype,
    bit for bit.  Raises when the stack's dtype or row shape is not the
    arena's: a parcel is never cast."""
    return parcel_tensor(rows, dtype_name, arena).to(arena.device)


def parcel_tensor(rows: np.ndarray, dtype_name: str,
                  arena: torch.Tensor) -> torch.Tensor:
    """``device_rows``' host half: the stack as a CPU tensor of
    ``arena``'s dtype over the same bytes, validated the same way."""
    want = _dtype_name(arena.dtype)
    if dtype_name != want:
        raise ValueError(
            f"host parcel rows decode to {dtype_name} but the arena holds "
            f"{want}")
    if tuple(rows.shape[1:]) != tuple(arena.shape[1:]):
        raise ValueError(
            f"host parcel row shape {tuple(rows.shape[1:])} != arena row "
            f"shape {tuple(arena.shape[1:])}")
    rows = np.ascontiguousarray(rows)
    if not rows.flags.writeable:
        rows = rows.copy()           # torch takes no read-only buffer
    view = _BIT_VIEWS.get(arena.dtype)
    if view is None:
        t = torch.from_numpy(rows)
        if t.dtype != arena.dtype:
            raise ValueError(f"host parcel rows are {rows.dtype} but the "
                             f"arena holds {want}")
    else:
        # the uint16 bits of host_rows, or a JAX replica's ml_dtypes
        # bfloat16: the same two bytes either way
        if rows.dtype.itemsize != arena.element_size():
            raise ValueError(f"host parcel rows of {rows.dtype} cannot "
                             f"hold {want} bits")
        t = torch.from_numpy(rows.view(view[1])).view(arena.dtype)
    return t


class _HostEntry:
    """One host-RAM parcel: ``rows`` holds one ``[n_blocks, ...]``
    numpy stack per flat arena at the arena's exact at-rest bytes, and
    ``dtypes`` the name of the torch dtype each stack's bits decode to
    (``None``: each stack's own numpy dtype; see the module docstring).
    ``pins`` counts queued requests whose matched span references this
    entry (pinned cache entries survive capacity eviction; preempt
    entries are implicitly pinned by their swap record).

    ``rows`` may be constructed LAZY — a zero-arg callable producing
    the stack list — for an engine that overlaps its demotion gathers
    with later work; consumers read ``entry.rows`` either way and
    ``resolved`` tells whether the bytes are host-resident yet."""

    __slots__ = ("key", "_rows", "n_blocks", "reason", "pins", "dtypes")

    def __init__(self, key: int, rows, n_blocks: int,
                 reason: str, dtypes: Optional[Tuple[str, ...]] = None):
        self.key = key
        self._rows = rows
        self.n_blocks = int(n_blocks)
        self.reason = reason
        self.pins = 0
        self.dtypes = None if dtypes is None else tuple(dtypes)

    @property
    def resolved(self) -> bool:
        return not callable(self._rows)

    @property
    def rows(self) -> List[np.ndarray]:
        if callable(self._rows):
            self._rows = self._rows()
        return self._rows


class HostTier:
    """Host-RAM block store shared by preemption swap-outs and prefix-
    cache demotions.

    ``cache_capacity_blocks`` bounds the CACHE-reason footprint only
    (``None`` = unbounded, ``0`` = cache demotions always refused):
    preempt parcels are correctness-bearing — a swapped request cannot
    resume without its bytes — so they are always accepted and never
    evicted; cache parcels are an optimization and evict LRU-first
    when a put needs room.  ``evict_cb(key)`` fires AFTER a capacity
    eviction removed an entry so the radix tree can drop the stale
    host location (never on ``drop()``, which the owner calls when it
    already knows)."""

    def __init__(self, cache_capacity_blocks: Optional[int] = None,
                 evict_cb=None):
        if cache_capacity_blocks is not None and cache_capacity_blocks < 0:
            raise ValueError(
                f"cache_capacity_blocks must be >= 0 or None, got "
                f"{cache_capacity_blocks}")
        self.cache_capacity = cache_capacity_blocks
        self.evict_cb = evict_cb
        self._entries: "OrderedDict[int, _HostEntry]" = OrderedDict()
        self._next_key = 0
        # running per-reason block totals: blocks() is on the engine's
        # gauge-update path (every demote/promote/preempt/resume) and
        # put()'s capacity loop, so it must not re-scan all entries
        self._blocks = {"preempt": 0, "cache": 0}

    # -- accounting --
    def blocks(self, reason: Optional[str] = None) -> int:
        if reason is None:
            return self._blocks["preempt"] + self._blocks["cache"]
        return self._blocks[reason]

    def keys(self, reason: Optional[str] = None) -> List[int]:
        return [k for k, e in self._entries.items()
                if reason is None or e.reason == reason]

    def entry(self, key: int) -> Optional[_HostEntry]:
        return self._entries.get(key)

    def _evictable(self) -> int:
        return sum(e.n_blocks for e in self._entries.values()
                   if e.reason == "cache" and e.pins == 0)

    def would_accept(self, n_blocks: int) -> bool:
        """Whether a cache-reason ``put`` of ``n_blocks`` could
        succeed right now — lets the engine skip the device gather
        when demotion would be refused anyway."""
        if self.cache_capacity is None:
            return True
        if n_blocks > self.cache_capacity:
            return False
        free = self.cache_capacity - self.blocks("cache")
        return free + self._evictable() >= n_blocks

    # -- mutation --
    def put(self, rows, n_blocks: int, reason: str,
            dtypes: Optional[Tuple[str, ...]] = None) -> Optional[int]:
        """Store a parcel; returns its key, or ``None`` when a CACHE
        put cannot fit (preempt puts always fit — the capacity bound
        is a cache budget, not a correctness limit).  A cache put
        evicts unpinned cache entries LRU-first to make room.
        ``rows`` is the stack list, or a zero-arg callable producing
        it (a LAZY parcel — see ``_HostEntry``); ``dtypes`` names what
        each stack's bits decode to."""
        if reason not in _REASONS:
            raise ValueError(f"unknown host-tier reason {reason!r}")
        if reason == "cache" and self.cache_capacity is not None:
            # the precheck is the ONE refusal authority: refuse BEFORE
            # any eviction, so parcels are never sacrificed for a put
            # that then fails.  Everything is single-threaded, so the
            # loop below cannot run out — if it ever does, an
            # invariant broke and the loud raise beats silent loss.
            need = self.blocks("cache") + n_blocks - self.cache_capacity
            if need > self._evictable():
                return None
            while need > 0:
                if not self.evict_one():
                    raise RuntimeError(
                        "host tier eviction underflow: the capacity "
                        "precheck promised evictable parcels")
                need = (self.blocks("cache") + n_blocks
                        - self.cache_capacity)
        key = self._next_key
        self._next_key += 1
        self._entries[key] = _HostEntry(key, rows, n_blocks, reason,
                                        dtypes)
        self._blocks[reason] += int(n_blocks)
        return key

    def evict_one(self) -> bool:
        """Evict the least-recently-used UNPINNED cache entry (fires
        ``evict_cb``); False when none is evictable.  Also the fault-
        injection hook for forced tier evictions."""
        victim = next((e for e in self._entries.values()
                       if e.reason == "cache" and e.pins == 0), None)
        if victim is None:
            return False
        del self._entries[victim.key]
        self._blocks[victim.reason] -= victim.n_blocks
        if self.evict_cb is not None:
            self.evict_cb(victim.key)
        return True

    def drop(self, key: int) -> bool:
        """Remove a parcel the owner is done with (resume completed,
        promotion consumed it, swapped request cancelled).  No
        ``evict_cb`` — the caller already knows."""
        e = self._entries.pop(key, None)
        if e is None:
            return False
        self._blocks[e.reason] -= e.n_blocks
        return True

    def transfer(self, key: int, dest: "HostTier") -> Optional[int]:
        """Move one parcel's EXACT at-rest bytes into another tier —
        the cross-replica KV handoff the router's failover migration
        rides: a failed replica's host-RAM swap parcels survive its
        device fault, and handing the resolved byte stacks to a
        healthy replica's tier is all "migration" is (the destination
        engine's swap-in scatter does the rest, the same program its
        own resumes use).  The parcel keeps its ``reason`` and
        ``dtypes``; a still-lazy parcel resolves here (its bytes must
        exist somewhere before the source can forget them).  Pins do
        NOT travel — they belong to the source's queued requests,
        which the failover is recovering separately.  Returns the
        DESTINATION key, or ``None`` when the destination refused a
        cache-reason put (preempt parcels always fit); the source
        entry is dropped only after the destination accepted."""
        e = self._entries.get(key)
        if e is None:
            return None
        rows = [np.ascontiguousarray(r) for r in e.rows]
        new_key = dest.put(rows, e.n_blocks, e.reason, e.dtypes)
        if new_key is None:
            return None
        self.drop(key)
        return new_key

    def touch(self, key: int):
        if key in self._entries:
            self._entries.move_to_end(key)

    def pin(self, key: int):
        self._entries[key].pins += 1

    def unpin(self, key: int):
        """Tolerates unknown keys: a pinned cache entry can be
        legitimately consumed out from under its pin (another sharer
        promoted it to HBM, or a recompute superseded it) — the pin
        holder finds the better copy at its own re-probe."""
        e = self._entries.get(key)
        if e is not None and e.pins > 0:
            e.pins -= 1

    def audit(self) -> List[str]:
        errs = []
        for k, e in self._entries.items():
            if e.key != k:
                errs.append(f"host tier: entry {k} carries key {e.key}")
            if e.reason not in _REASONS:
                errs.append(f"host tier: entry {k} reason {e.reason!r}")
            if e.pins < 0:
                errs.append(f"host tier: entry {k} pins {e.pins} < 0")
            if e.n_blocks < 1:
                errs.append(f"host tier: entry {k} holds {e.n_blocks} "
                            f"blocks")
            # shape validation only for host-resident bytes: a still-
            # lazy parcel's stacks live on device until the engine's
            # next harvest point, and forcing them here would turn
            # every audit into a pipeline sync (the consuming scatter
            # still fails loudly on a mismatched shape)
            if e.resolved:
                if e.dtypes is not None and len(e.dtypes) != len(e.rows):
                    errs.append(
                        f"host tier: entry {k} names {len(e.dtypes)} "
                        f"dtypes for {len(e.rows)} row stacks")
                for r in e.rows:
                    if r.shape[0] != e.n_blocks:
                        errs.append(
                            f"host tier: entry {k} row stack {r.shape} "
                            f"!= n_blocks {e.n_blocks}")
        if self.cache_capacity is not None and \
                self.blocks("cache") > self.cache_capacity:
            errs.append(
                f"host tier: cache footprint {self.blocks('cache')} "
                f"exceeds capacity {self.cache_capacity}")
        for reason in _REASONS:
            true_total = sum(e.n_blocks for e in self._entries.values()
                             if e.reason == reason)
            if true_total != self._blocks[reason]:
                errs.append(
                    f"host tier: running {reason} total "
                    f"{self._blocks[reason]} != entry sum {true_total}")
        return errs


def _common_len(a: np.ndarray, b: np.ndarray) -> int:
    m = min(a.size, b.size)
    if m == 0:
        return 0
    eq = np.equal(a[:m], b[:m])
    if eq.all():
        return m
    return int(np.argmin(eq))


class RadixNode:
    """One path-compressed tree node: a run of token ids at absolute
    offset ``start``, the child map keyed by each child run's first
    token, and the blocks whose LAST token falls inside this run
    (``blocks[i]`` is ``("hbm", block_id)`` or ``("host", tier_key)``,
    keyed by the ABSOLUTE block index ``i`` along the path)."""

    __slots__ = ("tokens", "start", "parent", "children", "blocks")

    def __init__(self, tokens: np.ndarray, start: int,
                 parent: Optional["RadixNode"]):
        self.tokens = tokens
        self.start = int(start)
        self.parent = parent
        self.children: Dict[int, "RadixNode"] = {}
        self.blocks: Dict[int, Tuple[str, int]] = {}


class RadixPrefixCache:
    """Token-level radix tree over block spans — the engine's prefix
    index in ``prefix_cache_mode="radix"``.

    The tree REFERENCES blocks, it never owns refcounts: an HBM block
    the tree holds is marked ``tree_hold`` in the ``BlockPool`` so an
    unpin parks it reclaimable-but-mapped (the radix analogue of the
    digest LRU), and the pool's reclaim callback routes through the
    engine's demote path back into :meth:`demote`.  Host locations are
    ``HostTier`` keys.  All methods are host-side and synchronous with
    the scheduler; the tree is per-engine and an engine has exactly
    one at-rest cache dtype, so bf16 and int8 bytes can never alias
    through it (the digest cache salts its digests for the same
    reason)."""

    def __init__(self, block_len: int, pool, tier: HostTier):
        self.block_len = int(block_len)
        self.pool = pool
        self.tier = tier
        self.root = RadixNode(np.zeros((0,), np.int32), 0, None)
        self._hbm: Dict[int, Tuple[RadixNode, int]] = {}
        self._host: Dict[int, Tuple[RadixNode, int]] = {}

    # -- lookup --
    def match(self, ids) -> Tuple[int, List[Tuple[str, int]]]:
        """Longest-prefix match: returns ``(matched_tokens, span)``
        where ``matched_tokens`` is the token-granular match length
        (NOT rounded to block multiples) and ``span`` the contiguous
        block locations from position 0 that the match fully covers —
        ``("hbm", block)`` entries map directly, ``("host", key)``
        entries need a swap-in.  The span ends at the first hole or
        the first block the match only partially covers."""
        ids = np.asarray(ids).reshape(-1).astype(np.int32)
        node, consumed = self.root, 0
        path: List[Tuple[RadixNode, int]] = []
        while consumed < ids.size:
            child = node.children.get(int(ids[consumed]))
            if child is None:
                break
            k = _common_len(child.tokens, ids[consumed:])
            path.append((child, k))
            consumed += k
            if k < child.tokens.size:
                break
            node = child
        L = self.block_len
        span: List[Tuple[str, int]] = []
        expect = 0
        for nd, _k in path:
            broken = False
            for bi in sorted(nd.blocks):
                if bi != expect or (bi + 1) * L > consumed:
                    broken = True
                    break
                span.append(nd.blocks[bi])
                expect += 1
            if broken:
                break
        return consumed, span

    def touch_span(self, span):
        """LRU-refresh every location a match is about to use."""
        for kind, ref in span:
            if kind == "hbm":
                self.pool.tree_touch(ref)
            else:
                self.tier.touch(ref)

    # -- registration --
    def insert(self, ids, block_ids, n_blocks: int, start_block: int = 0):
        """Register a prefilled prompt's tokens ``ids[:n_blocks*L]``
        and offer its computed blocks for positions ``[start_block,
        n_blocks)``.  First writer wins on an occupied HBM position
        (the duplicate stays private to its request, exactly the
        digest-map rule); a HOST twin is superseded by the freshly
        computed HBM copy unless a queued request still pins its
        bytes."""
        L = self.block_len
        n_tok = n_blocks * L
        if n_tok == 0:
            return
        ids = np.asarray(ids).reshape(-1).astype(np.int32)[:n_tok]
        node, consumed = self.root, 0
        path: List[RadixNode] = []
        while consumed < n_tok:
            child = node.children.get(int(ids[consumed]))
            if child is None:
                child = RadixNode(np.array(ids[consumed:], np.int32),
                                  consumed, node)
                node.children[int(ids[consumed])] = child
                path.append(child)
                consumed = n_tok
                break
            k = _common_len(child.tokens, ids[consumed:])
            if k < child.tokens.size:
                self._split(child, k)
            path.append(child)
            consumed += k
            node = child
        pi = 0
        for bi in range(start_block, n_blocks):
            last = (bi + 1) * L - 1
            while not (path[pi].start <= last
                       < path[pi].start + path[pi].tokens.size):
                pi += 1
            nd = path[pi]
            cur = nd.blocks.get(bi)
            if cur is None:
                self._set_hbm(nd, bi, int(block_ids[bi]))
            elif cur[0] == "host":
                ent = self.tier.entry(cur[1])
                if ent is not None and ent.pins == 0:
                    self.tier.drop(cur[1])
                    del self._host[cur[1]]
                    self._set_hbm(nd, bi, int(block_ids[bi]))

    def _set_hbm(self, nd: RadixNode, bi: int, block: int):
        nd.blocks[bi] = ("hbm", block)
        self._hbm[block] = (nd, bi)
        self.pool.tree_hold(block)

    def _split(self, node: RadixNode, k: int):
        """Split ``node``'s run at relative offset ``k``: the node
        keeps ``tokens[:k]``, a new tail child takes the rest along
        with the children and the blocks whose last token moved."""
        L = self.block_len
        tail = RadixNode(node.tokens[k:].copy(), node.start + k, node)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        cut = node.start + k
        moved = {bi: loc for bi, loc in node.blocks.items()
                 if (bi + 1) * L - 1 >= cut}
        tail.blocks = moved
        node.blocks = {bi: loc for bi, loc in node.blocks.items()
                       if bi not in moved}
        for bi, loc in moved.items():
            if loc[0] == "hbm":
                self._hbm[loc[1]] = (tail, bi)
            else:
                self._host[loc[1]] = (tail, bi)
        node.tokens = node.tokens[:k].copy()
        node.children = {int(tail.tokens[0]): tail}

    # -- tier transitions --
    def demote(self, block: int, rows,
               dtypes: Optional[Tuple[str, ...]] = None) -> Optional[int]:
        """Pool reclaimed a tree-held HBM block: park its gathered
        at-rest bytes (or a lazy thunk producing them) in the host tier
        and relabel the position host-resident.  When the tier refuses
        (capacity), the position becomes a hole (the digest cache's
        forget semantics) and blockless leaves prune.  Returns the tier
        key, or None when dropped."""
        nd, bi = self._hbm.pop(block)
        key = self.tier.put(rows, 1, "cache", dtypes)
        if key is None:
            del nd.blocks[bi]
            self._prune(nd)
            return None
        nd.blocks[bi] = ("host", key)
        self._host[key] = (nd, bi)
        return key

    def drop_hbm(self, block: int):
        """Reclaim without demotion (host tier full/disabled): the
        position becomes a hole."""
        nd, bi = self._hbm.pop(block)
        del nd.blocks[bi]
        self._prune(nd)

    def promote(self, key: int, block: int):
        """A host-resident span was swapped back into freshly
        allocated HBM ``block``: consume the tier entry and relabel.
        The block is request-owned (refcount 1) AND tree-held, exactly
        like a freshly registered prefill block."""
        nd, bi = self._host.pop(key)
        self.tier.drop(key)
        nd.blocks[bi] = ("hbm", int(block))
        self._hbm[int(block)] = (nd, bi)
        self.pool.tree_hold(int(block))

    def drop_host(self, key: int):
        """The tier evicted (or the engine invalidated) a host parcel:
        the position becomes a hole.  Idempotent — the tier's evict
        callback may race a promotion that already consumed the key."""
        loc = self._host.pop(key, None)
        if loc is None:
            return
        nd, bi = loc
        del nd.blocks[bi]
        self._prune(nd)

    def _prune(self, node: RadixNode):
        while (node.parent is not None and not node.blocks
               and not node.children):
            del node.parent.children[int(node.tokens[0])]
            node = node.parent

    # -- accounting / audit --
    def n_hbm(self) -> int:
        return len(self._hbm)

    def n_host(self) -> int:
        return len(self._host)

    def root_stats(self) -> dict:
        """Tree-size summary for a scheduler above the engine:
        cached block counts by tier plus the root fanout (how many
        distinct first tokens the tree indexes).  O(1) — reverse maps
        and the root child dict are already maintained."""
        return {"hbm_blocks": len(self._hbm),
                "host_blocks": len(self._host),
                "root_children": len(self.root.children)}

    def audit(self, pool) -> List[str]:
        """Structural invariants ``BlockPool.check()`` folds in for
        radix-mode engines: the radix-node <-> block-span bijection
        (every placed block appears in exactly one node position and
        exactly one reverse map, inside its node's token span), the
        tree-referenced set matching the pool's, and host locations
        matching live cache-reason tier entries exactly — so a
        host-tier parcel can never alias a live HBM block and no
        parcel leaks without a tree position."""
        errs: List[str] = []
        L = self.block_len
        if set(self._hbm) != pool._tree_ref:
            errs.append(
                f"radix: HBM block set {sorted(self._hbm)} != pool "
                f"tree-referenced set {sorted(pool._tree_ref)}")
        n_seen = 0
        stack = [self.root]
        while stack:
            nd = stack.pop()
            if nd is not self.root and nd.tokens.size == 0:
                errs.append("radix: empty token run on non-root node")
            for t, c in nd.children.items():
                if c.parent is not nd:
                    errs.append(f"radix: child at {t} has wrong parent")
                if c.tokens.size and int(c.tokens[0]) != t:
                    errs.append(
                        f"radix: child keyed {t} starts with "
                        f"{int(c.tokens[0])}")
                if c.start != nd.start + nd.tokens.size:
                    errs.append(
                        f"radix: child start {c.start} != parent end "
                        f"{nd.start + nd.tokens.size}")
                stack.append(c)
            for bi, (kind, ref) in nd.blocks.items():
                n_seen += 1
                last = (bi + 1) * L - 1
                if not (nd.start <= last < nd.start + nd.tokens.size):
                    errs.append(
                        f"radix: block {bi} (last token {last}) "
                        f"attached outside node span [{nd.start}, "
                        f"{nd.start + nd.tokens.size})")
                if kind == "hbm":
                    if self._hbm.get(ref) != (nd, bi):
                        errs.append(
                            f"radix: HBM block {ref} reverse-map "
                            f"mismatch at position {bi}")
                    if not (0 <= ref < pool.num_blocks):
                        errs.append(
                            f"radix: HBM block {ref} out of pool range")
                elif kind == "host":
                    if self._host.get(ref) != (nd, bi):
                        errs.append(
                            f"radix: host key {ref} reverse-map "
                            f"mismatch at position {bi}")
                    ent = self.tier.entry(ref)
                    if ent is None:
                        errs.append(
                            f"radix: host key {ref} has no tier entry")
                    elif ent.reason != "cache" or ent.n_blocks != 1:
                        errs.append(
                            f"radix: host key {ref} entry is "
                            f"{ent.reason}/{ent.n_blocks} blocks, "
                            f"expected cache/1")
                else:
                    errs.append(f"radix: unknown location kind {kind!r}")
        if n_seen != len(self._hbm) + len(self._host):
            errs.append(
                f"radix: {n_seen} placed blocks != {len(self._hbm)} "
                f"HBM + {len(self._host)} host reverse entries")
        tier_keys = set(self.tier.keys("cache"))
        if tier_keys != set(self._host):
            errs.append(
                f"radix: tier cache keys {sorted(tier_keys)} != tree "
                f"host locations {sorted(self._host)}")
        return errs
