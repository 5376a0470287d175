"""Slot-based bucketed KV-cache manager for the LM serving tier (the
counterpart of the reference's ``runtime/kvcache.py``, over torch state
trees).

A decoding LM's working state is its KV cache; serving many sequences
concurrently means owning that memory explicitly instead of allocating a
fresh cache per request.  :class:`KVCacheManager` preallocates one decode
state per *length bucket* — a cache pytree whose attention pools are
``(layers, slots, bucket_len, kv_heads, d_head)`` — and hands out / reclaims
individual **slots** (lanes of the batch dimension):

* **Bucketing bounds recompiles.** Every sequence whose total length
  (prompt + generation budget) fits bucket ``S`` decodes through the same
  ``(bucket_len, slots)``-shaped executable, so a warmed engine serves any
  arrival pattern with zero recompiles (asserted by the engine's
  compile-cache counters).
* **Slot reuse is free of cross-talk.** ``models.transformer.decode_step``
  masks attention past each lane's ``kv_len``, so stale KV data left by a
  previous occupant of a slot never contributes: reclaiming a slot resets
  its position index to 0.  A cache leaf with no position axis (rwkv's
  recurrent state ``s``, ``tm_prev``, ``cm_prev``; hymba's SSM ``h`` and
  ``conv``) has nothing to mask, so its rows of the slot are zeroed as
  well: every leaf but the KV pools of :data:`POSITION_LEAVES`.  (The
  reference resets only the index, and a reused rwkv or hymba slot starts
  from its previous sequence's state.)
* **int8 KV quantization** (``kv_quant="int8"``) stores the pools as int8
  codes with per-(position, head) f32 scale planes — 4x smaller cache —
  quantize-on-write / dequant inside the attention pattern, handled by
  ``attention_decode``.

The manager is pure bookkeeping + memory ownership; the decode loop lives in
:mod:`repro_torch.runtime.lm_server`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch


# the cache leaves with a position axis (L, B, Smax, ...): the attention KV
# pools and their int8 scale planes, masked past each lane's kv_len; every
# other cache leaf is recurrent state, zeroed when its slot is handed out
POSITION_LEAVES = frozenset({"k", "v", "k_scale", "v_scale"})


class SequenceTooLong(ValueError):
    """The request's total length (prompt + max_new_tokens) exceeds the
    largest configured bucket; no amount of waiting will fit it."""


def length_buckets(max_len: int, min_len: int = 32) -> tuple[int, ...]:
    """Power-of-two total-length buckets ``min_len, 2*min_len, ..`` up to and
    including ``max_len`` — the default bucket ladder when none is given."""
    out, b = [], min_len
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(sorted(set(out)))


@dataclass
class _Pool:
    """One bucket's preallocated decode state + slot free-list."""

    bucket_len: int
    slots: int
    state: Any  # decode-state pytree; leading batch dim == slots
    free: list[int] = field(default_factory=list)
    occupant: dict[int, int] = field(default_factory=dict)  # slot -> uid
    allocs: int = 0
    reuses: int = 0

    def __post_init__(self):
        self.free = list(range(self.slots))
        self._ever_used: set[int] = set()

    @property
    def used(self) -> int:
        return self.slots - len(self.free)

    def alloc(self, uid: int) -> int:
        slot = self.free.pop(0)
        if slot in self._ever_used:
            self.reuses += 1
        self._ever_used.add(slot)
        self.occupant[slot] = uid
        self.allocs += 1
        return slot

    def release(self, slot: int) -> None:
        if slot in self.occupant:
            del self.occupant[slot]
            self.free.append(slot)
            self.free.sort()  # deterministic reuse order


class KVCacheManager:
    """Owns the preallocated per-bucket decode states and the slot ledger.

    ``state_builder(batch, max_len)`` builds a fresh decode-state tree
    (normally ``init_decode_state`` of the engine's params and config); the
    manager calls it lazily once per bucket, so unused buckets cost nothing
    until first touched.
    """

    def __init__(self, state_builder: Callable[[int, int], Any], *,
                 bucket_lens: tuple[int, ...], slots: int,
                 kv_quant: str | None = None):
        if not bucket_lens:
            raise ValueError("need at least one length bucket")
        self.state_builder = state_builder
        self.bucket_lens = tuple(sorted(set(int(b) for b in bucket_lens)))
        self.slots = int(slots)
        self.kv_quant = kv_quant
        self.pools: dict[int, _Pool] = {}

    # -- pool lifecycle ------------------------------------------------------

    def _pool(self, bucket_len: int) -> _Pool:
        pool = self.pools.get(bucket_len)
        if pool is None:
            state = self.state_builder(self.slots, bucket_len)
            pool = _Pool(bucket_len=bucket_len, slots=self.slots, state=state)
            self.pools[bucket_len] = pool
        return pool

    def bucket_for(self, total_len: int) -> int:
        """Smallest bucket whose length fits ``total_len`` (prompt +
        generation budget); raises :class:`SequenceTooLong` if none does."""
        for b in self.bucket_lens:
            if b >= total_len:
                return b
        raise SequenceTooLong(
            f"sequence needs {total_len} positions; largest bucket is "
            f"{self.bucket_lens[-1]}"
        )

    # -- slot hand-out / reclaim --------------------------------------------

    def alloc(self, uid: int, total_len: int) -> tuple[int, int] | None:
        """Claim a slot for ``uid``: returns ``(bucket_len, slot)``, or
        ``None`` when every eligible bucket is full (the caller keeps the
        request queued).  Spills to a larger bucket when the tight one is
        full — a larger executable beats waiting."""
        first = self.bucket_for(total_len)
        for b in self.bucket_lens:
            if b < first:
                continue
            pool = self._pool(b)
            if pool.free:
                slot = pool.alloc(uid)
                # reclaimed slot -> fresh sequence: position index back to 0
                # (stale KV past kv_len is masked, so the KV pools need no
                # zeroing) and the slot's recurrent state rows to 0 (no
                # position axis to mask them); new tensors, so a state an
                # engine still holds is untouched
                pool.state = _fresh_slot(pool.state, slot)
                return b, slot
        return None

    def release(self, bucket_len: int, slot: int) -> None:
        """Return a slot to its bucket's free list (eviction or completion)."""
        self.pools[bucket_len].release(slot)

    # -- observability -------------------------------------------------------

    @property
    def slots_total(self) -> int:
        # capacity counts the full ladder, not just lazily-built pools
        return self.slots * len(self.bucket_lens)

    @property
    def slots_used(self) -> int:
        return sum(p.used for p in self.pools.values())

    def occupancy(self) -> float:
        total = self.slots_total
        return self.slots_used / total if total else 0.0

    def cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for p in self.pools.values()
                   for t in _tensors(p.state))

    def slot_reuses(self) -> int:
        return sum(p.reuses for p in self.pools.values())

    def metrics(self) -> dict:
        return {
            "kv_slots_used": self.slots_used,
            "kv_slots_total": self.slots_total,
            "kv_slot_occupancy": self.occupancy(),
            "kv_slot_reuses": self.slot_reuses(),
            "kv_cache_bytes": self.cache_bytes(),
            "kv_buckets_live": len(self.pools),
            "kv_quant": self.kv_quant or "none",
        }


def _fresh_slot(state: dict, slot: int) -> dict:
    """``state`` with lane ``slot``'s position index and recurrent cache
    rows zeroed, in new tensors."""
    lane = torch.tensor([slot], device=state["index"].device)
    out = dict(state, index=state["index"].index_fill(0, lane, 0))
    cache = state.get("cache")
    if cache is not None:
        out["cache"] = {name: t if name in POSITION_LEAVES
                        else t.index_fill(1, lane, 0)
                        for name, t in cache.items()}
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
