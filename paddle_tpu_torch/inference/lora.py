"""Multi-tenant batched LoRA serving: the paged adapter-weight store.  A
copy of ``paddle_tpu/inference/lora.py`` with torch arenas.

K fine-tuned LoRA variants of one base model decode in a single
continuous batch (S-LoRA, Sheng et al., 2023; Punica, Chen et al.,
2023).  The per-dispatch math lives in ``models/lora.py`` (gathered
einsums over stacked adapter arenas); this module owns the MEMORY system
those arenas need, the adapter-weight twin of the KV block pool's arena,
free list and host tier:

- **Stacked device arenas.**  One ``[slots + 1, L, d_in, r_max]`` A arena
  and one ``[slots + 1, L, r_max, d_out]`` B arena per target projection,
  at the engine's compute dtype, on the engine's device, allocated ONCE
  at construction and never reallocated: a swap-in writes its slot's row
  in place (``copy_``), so a captured decode graph, which baked in the
  arenas' addresses, reads the swapped-in weights.  The LAST row is the
  NULL adapter, all zeros and never written: base-model rows gather it
  and their delta is an exact ``+ 0.0``.  Ranks below ``r_max`` zero-pad.
- **Free list, pins and LRU.**  ``acquire()`` pins an adapter resident for
  a request's admitted life (refcounted; released at retirement and
  preemption); unpinned residents park in an LRU, still mapped, and are
  DEMOTED (their slot reclaimed) only when an acquire needs a slot and
  the free list is dry.  All slots pinned: ``acquire`` returns ``None``
  and admission waits, as under KV-block exhaustion.
- **Host tier.**  Registration keeps every adapter's at-rest bytes (the
  rows zero-padded to ``r_max`` at the arena dtype; a bf16 row as the
  ``uint16`` view of its bits, the host parcels' rule of
  ``inference/prefixcache.py``) in host RAM, pinned when the arenas live
  on the card.  Adapter weights are immutable, so demotion only frees
  the slot, and a later ``acquire`` uploads the SAME bytes:
  byte-identical to never having demoted (``arena_row`` reads a slot
  back).  ``serving.lora.*`` instruments report residency and swap
  traffic, with the reference's names, help text and kinds.

``ServingEngine(adapter_store=)`` drives the store: ``submit(adapter=)``
names the variant, admission acquires its slot, every dispatch whose
riding mix has at least one adapter row passes ``arena_planes()`` and
per-row slot ids to the gathered products, and retirement releases the
pin.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_dtype
from ..models.lora import LORA_TARGETS, attn_lora_dims
from ..observability import metrics as obs_metrics
from .prefixcache import bits_array, row_bits


@dataclass
class LoraAdapter:
    """One named low-rank adapter: ``weights[target] = (A, B)`` with ``A
    [L, d_in, r]`` and ``B [L, r, d_out]`` numpy arrays (the ``alpha / r``
    scaling FOLDED INTO B, so the serving delta is ``(x A) B`` and merging
    is ``W + A B``).  Targets may be any subset of :data:`LORA_TARGETS`;
    absent targets apply no delta."""

    name: str
    rank: int
    weights: Dict[str, Tuple[np.ndarray, np.ndarray]] = \
        field(default_factory=dict)

    @classmethod
    def random(cls, config, name: str, rank: int, seed: int = 0,
               scale: float = 0.1,
               targets: Tuple[str, ...] = LORA_TARGETS) -> "LoraAdapter":
        """A synthetic adapter for tests and benches: N(0, scale) A and B
        over ``targets`` for every layer of ``config``, drawn from
        ``numpy.random.default_rng(seed)`` in the reference's order (the
        same seed gives the same arrays in both packages)."""
        dims = attn_lora_dims(config)
        rng = np.random.default_rng(seed)
        n_layers = int(config.num_hidden_layers)
        weights = {}
        for t in targets:
            d_in, d_out = dims[t]
            weights[t] = (
                rng.normal(0.0, scale,
                           (n_layers, d_in, rank)).astype(np.float32),
                rng.normal(0.0, scale,
                           (n_layers, rank, d_out)).astype(np.float32))
        return cls(name=name, rank=int(rank), weights=weights)


class _AdapterState:
    """Host-side record of one registered adapter: the at-rest parcel
    (``staged[target] = (A, B)``, zero-padded to ``r_max`` at the arena
    dtype, pinned when the arenas live on the card: the exact bytes every
    swap-in uploads), the resident slot (``None`` = host-only) and the pin
    count."""

    __slots__ = ("name", "rank", "staged", "nbytes", "slot", "pins")

    def __init__(self, name: str, rank: int, staged, nbytes: int):
        self.name = name
        self.rank = rank
        self.staged = staged
        self.nbytes = nbytes
        self.slot: Optional[int] = None
        self.pins = 0

    @property
    def rows(self):
        """The parcel as host bits, ``{target: (A_bits, B_bits)}`` (a bf16
        row as its ``uint16`` view): what ``arena_row`` reads back from a
        slot this adapter occupies."""
        return {t: tuple(bits_array(row_bits(x)) for x in ab)
                for t, ab in self.staged.items()}


class AdapterStore:
    """Paged adapter-weight arena for one model family (see the module
    docstring).  ``slots`` bounds the resident adapter count, ``max_rank``
    the arena rank width; ``dtype`` must equal the serving engine's
    compute dtype and ``device`` its device (the CUDA card unless
    ``"cpu"`` is asked for).  Pass a private ``registry`` for isolated
    instrument assertions."""

    def __init__(self, model, *, slots: int, max_rank: int,
                 dtype: str = "bfloat16", registry=None,
                 device: DeviceLike = None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_rank < 1:
            raise ValueError(f"max_rank must be >= 1, got {max_rank}")
        if not hasattr(model, "attn_projections"):
            raise ValueError(
                f"{type(model).__name__} has no attn_projections() — "
                f"the model family does not expose the LoRA hook "
                f"surface (models/lora.py)")
        cfg = model.config
        if getattr(cfg, "tensor_parallel", False):
            raise ValueError(
                "AdapterStore does not support tensor-parallel models "
                "yet — the stacked arenas hold full-width projections")
        self.slots = int(slots)
        self.max_rank = int(max_rank)
        self.dtype = to_dtype(dtype)
        self.device = resolve_device(device)
        self.n_layers = int(cfg.num_hidden_layers)
        self.dims = attn_lora_dims(cfg)
        # the null adapter is the LAST row (the trash-row convention):
        # all-zero, never written, gathered by base-model rows
        self.null_slot = self.slots
        fac = dict(dtype=self.dtype, device=self.device)
        self._a = {t: torch.zeros(
            (self.slots + 1, self.n_layers, d_in, self.max_rank), **fac)
            for t, (d_in, _) in self.dims.items()}
        self._b = {t: torch.zeros(
            (self.slots + 1, self.n_layers, self.max_rank, d_out), **fac)
            for t, (_, d_out) in self.dims.items()}
        self._adapters: Dict[str, _AdapterState] = {}
        self._free: List[int] = list(range(self.slots - 1, -1, -1))
        self._lru: "OrderedDict[str, bool]" = OrderedDict()
        self._occupant: Dict[int, str] = {}   # slot -> adapter name
        r = registry if registry is not None else obs_metrics.get_registry()
        self.registry = r
        self._g_hbm = r.gauge(
            "serving.lora.hbm_adapters",
            "LoRA adapters currently resident in the HBM adapter "
            "arenas (hwm = peak residency); the arena capacity is the "
            "AdapterStore's slots")
        self._g_host = r.gauge(
            "serving.lora.host_adapters",
            "registered LoRA adapters currently resident ONLY in host "
            "RAM (demoted or never yet acquired) — an acquire swaps "
            "their at-rest bytes back into a free arena slot")
        self._c_swaps = r.counter(
            "serving.lora.swap_ins",
            "adapter swap-ins: host-RAM parcels uploaded into an HBM "
            "arena slot at exact at-rest bytes (first admission and "
            "every re-admission after a demotion)")
        self._c_swap_bytes = r.counter(
            "serving.lora.swap_in_bytes",
            "at-rest adapter bytes (zero-padded stacked A/B planes, "
            "all targets x layers) uploaded by adapter swap-ins")
        self._c_gathers = r.counter(
            "serving.lora.gathers",
            "compiled serving dispatches (decode block / prefill "
            "chunk / spec verify) that ran the gathered "
            "adapter-einsum path because >= 1 riding row selected an "
            "adapter — against serving.block_dispatches this is the "
            "LoRA-vs-base dispatch route split")
        self._update_gauges()

    # -- accounting --
    def _update_gauges(self):
        resident = sum(1 for a in self._adapters.values()
                       if a.slot is not None)
        self._g_hbm.set(resident)
        self._g_host.set(len(self._adapters) - resident)

    def count_gather(self):
        """One dispatch ran the gathered-product path (engine hook)."""
        self._c_gathers.inc()

    def resident(self, name: str) -> bool:
        a = self._adapters.get(name)
        return a is not None and a.slot is not None

    def names(self) -> List[str]:
        return sorted(self._adapters)

    def hbm_resident(self) -> List[str]:
        """Adapter names resident in the device arenas, sorted: the
        adapter-affinity signal ``ServingEngine.load_report()`` gives the
        router (a request routed here decodes without a swap-in)."""
        return sorted(n for n, a in self._adapters.items()
                      if a.slot is not None)

    def state(self, name: str) -> Optional[_AdapterState]:
        return self._adapters.get(name)

    # -- registration --
    def register(self, adapter: LoraAdapter):
        """Validate and keep ``adapter``'s at-rest bytes host-side
        (zero-padded to ``max_rank`` at the arena dtype: the EXACT parcel
        every later swap-in uploads).  Registration never writes the
        arenas; the first ``acquire`` does."""
        if adapter.name in self._adapters:
            raise ValueError(
                f"adapter {adapter.name!r} is already registered")
        if not 1 <= adapter.rank <= self.max_rank:
            raise ValueError(
                f"adapter {adapter.name!r} rank {adapter.rank} outside "
                f"[1, max_rank={self.max_rank}]")
        if not adapter.weights:
            raise ValueError(
                f"adapter {adapter.name!r} has no target weights")
        for t in adapter.weights:
            if t not in self.dims:
                raise ValueError(
                    f"adapter {adapter.name!r} targets unknown "
                    f"projection {t!r} — known: {sorted(self.dims)}")
        padded = {}
        # the parcel covers EVERY target, absent ones as zeros: an upload
        # must overwrite the slot's whole row set, or a previous
        # occupant's rows for a target this adapter does not carry would
        # stay live (the gather reads all targets)
        for t in self.dims:
            d_in, d_out = self.dims[t]
            a_pad = torch.zeros((self.n_layers, d_in, self.max_rank),
                                dtype=self.dtype)
            b_pad = torch.zeros((self.n_layers, self.max_rank, d_out),
                                dtype=self.dtype)
            if t in adapter.weights:
                a, b = (np.asarray(w) for w in adapter.weights[t])
                if a.shape != (self.n_layers, d_in, adapter.rank) or \
                        b.shape != (self.n_layers, adapter.rank, d_out):
                    raise ValueError(
                        f"adapter {adapter.name!r} target {t!r}: A/B "
                        f"shapes {list(a.shape)}/{list(b.shape)} do not "
                        f"match [L={self.n_layers}, d_in={d_in}, "
                        f"r={adapter.rank}] / [L, r, d_out={d_out}]")
                # a private copy, cast once to the arena dtype
                a_pad[:, :, :adapter.rank] = torch.from_numpy(
                    np.array(a, np.float32))
                b_pad[:, :adapter.rank, :] = torch.from_numpy(
                    np.array(b, np.float32))
            padded[t] = (a_pad, b_pad)
        pin = self.device.type == "cuda"
        staged = {t: tuple(x.pin_memory() if pin else x for x in ab)
                  for t, ab in padded.items()}
        nbytes = sum(x.numel() * x.element_size()
                     for ab in padded.values() for x in ab)
        self._adapters[adapter.name] = _AdapterState(
            adapter.name, adapter.rank, staged, nbytes)
        self._update_gauges()

    # -- residency --
    def acquire(self, name: str) -> Optional[int]:
        """Pin ``name`` resident and return its slot (the gather index its
        request rows carry), uploading its at-rest bytes first when it is
        host-only, and reclaiming the LRU unpinned resident's slot when
        the free list is dry.  ``None`` = every slot is pinned (admission
        waits).  Raises ``KeyError`` for an unregistered name."""
        a = self._adapters.get(name)
        if a is None:
            raise KeyError(f"adapter {name!r} is not registered")
        if a.slot is not None:
            if a.pins == 0:
                self._lru.pop(name, None)
            a.pins += 1
            return a.slot
        if self._free:
            slot = self._free.pop()
        elif self._lru:
            victim, _ = self._lru.popitem(last=False)
            slot = self._demote(self._adapters[victim])
        else:
            return None
        self._upload(a, slot)
        a.pins = 1
        return a.slot

    def release(self, name: str):
        """Drop one pin; at zero the adapter STAYS resident, parked in the
        LRU (reclaimable, still mapped)."""
        a = self._adapters.get(name)
        if a is None or a.pins <= 0:
            raise RuntimeError(
                f"adapter {name!r} released below pin count 0")
        a.pins -= 1
        if a.pins == 0:
            self._lru[name] = True

    def _demote(self, a: _AdapterState) -> int:
        """Free a resident unpinned adapter's slot.  The registration
        parcel already holds the exact bytes, so demotion is bookkeeping
        only; the arena rows stay stale but unreachable until the next
        upload overwrites them."""
        slot = a.slot
        a.slot = None
        self._occupant.pop(slot, None)
        self._update_gauges()
        return slot

    def _upload(self, a: _AdapterState, slot: int):
        """Swap ``a``'s at-rest parcel into arena row ``slot``: one
        in-place ``copy_`` per target and plane (from pinned memory on
        the card, without blocking the host: the parcel is immutable)."""
        with torch.no_grad():
            for t, (a_st, b_st) in a.staged.items():
                self._a[t][slot].copy_(a_st, non_blocking=True)
                self._b[t][slot].copy_(b_st, non_blocking=True)
        a.slot = slot
        self._occupant[slot] = a.name
        self._c_swaps.inc()
        self._c_swap_bytes.inc(a.nbytes)
        self._update_gauges()

    # -- dispatch surface --
    def slot_of(self, name: str) -> int:
        """The resident slot of an ACQUIRED adapter (admission pinned it,
        so host-only here means a pin was dropped early)."""
        a = self._adapters.get(name)
        if a is None or a.slot is None:
            raise RuntimeError(
                f"adapter {name!r} is not HBM-resident — dispatch "
                f"planes may only name acquired (pinned) adapters")
        return a.slot

    def arena_planes(self) -> dict:
        """The stacked arena halves of a dispatch's ``lora`` planes (the
        engine adds the per-row ``ids``): ``{"a": {target: arena}, "b":
        {target: arena}}``, the store's own tensors."""
        return {"a": dict(self._a), "b": dict(self._b)}

    def arena_row(self, target: str, slot: int):
        """One target's (A, B) arena rows read back as host bits (a bf16
        row as the ``uint16`` view): the byte-identical swap-in check."""
        return tuple(bits_array(row_bits(arena[slot]).cpu())
                     for arena in (self._a[target], self._b[target]))

    # -- audit --
    def check(self) -> bool:
        """Invariant audit: slot bookkeeping is a bijection, pins imply
        residency, every refcount-0 resident sits in the LRU, the free
        list holds exactly the unoccupied slots.  Raises listing all
        violations."""
        errs = []
        for name, a in self._adapters.items():
            if a.pins < 0:
                errs.append(f"adapter {name}: negative pins {a.pins}")
            if a.pins > 0 and a.slot is None:
                errs.append(f"adapter {name}: pinned but not resident")
            if a.slot is not None and \
                    self._occupant.get(a.slot) != name:
                errs.append(
                    f"adapter {name}: slot {a.slot} occupant says "
                    f"{self._occupant.get(a.slot)!r}")
            if a.slot is not None and a.pins == 0 and \
                    name not in self._lru:
                errs.append(
                    f"adapter {name}: resident at pins 0 but not in "
                    f"the LRU — unreclaimable")
            if name in self._lru and (a.slot is None or a.pins > 0):
                errs.append(f"adapter {name}: in the LRU but "
                            f"{'host-only' if a.slot is None else 'pinned'}")
        for slot, name in self._occupant.items():
            if not 0 <= slot < self.slots:
                errs.append(f"occupant map holds non-arena slot {slot}")
            if self._adapters.get(name) is None or \
                    self._adapters[name].slot != slot:
                errs.append(f"slot {slot}: occupant {name!r} does not "
                            f"claim it back")
        want_free = set(range(self.slots)) - set(self._occupant)
        if set(self._free) != want_free:
            errs.append(f"free list {sorted(self._free)} != unoccupied "
                        f"slots {sorted(want_free)}")
        if len(set(self._free)) != len(self._free):
            errs.append(f"free list holds duplicates: {self._free}")
        if errs:
            raise RuntimeError(
                "AdapterStore.check failed:\n  " + "\n  ".join(errs))
        return True
