"""Paged-KV serving engine with continuous batching and Nezha-style cache GC.

The KV pool is the serving-side ValueLog: blocks are written once at their
allocation site; the per-sequence block table is the lightweight
key->offset index.  Slot reuse scrambles the physical layout over time
(fragmentation) exactly like Nezha's arrival-order ValueLog; `compact()` is
the GC: it re-packs each live sequence's blocks into logical order
(kernels/kv_compaction) so decode streams sequential reads again.
Compaction is out of place: the old pool stays valid until the swap.

Scheduler: admit-on-free-slot continuous batching; one engine `step()` =
(admit+prefill new requests) + (one lockstep decode token for every slot,
ragged positions via the per-slot `pos` vector).  On CUDA, prefill runs the
flash-attention kernel, decode the paged-attention kernel and `compact()`
the compaction kernel.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.kv_compaction.ops import compact_kv_pool
from repro_torch.models import forward, init_cache, init_params
from repro_torch.utils import tree_map, tree_paths


def require_token_input(cfg: ModelConfig):
    """Raise ValueError for a config whose input is not tokens: the engine
    admits token prompts only.  The JAX package's engine cannot admit such
    a config either: its prefill feeds int tokens where the model takes
    (B, S, d) embeds."""
    if cfg.input_kind != "tokens":
        raise ValueError(
            f"{cfg.name} takes input_kind={cfg.input_kind!r}: the serving "
            "engine admits token prompts only (the JAX package's engine "
            "cannot admit it either)")


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = field(default_factory=list)
    slot: int = -1
    done: bool = False
    submitted: float = 0.0
    finished: float = 0.0


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params=None, *, max_slots: int = 4,
                 max_seq: int = 256, seed: int = 0,
                 scramble_blocks: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.scramble = scramble_blocks
        self.rng = np.random.default_rng(seed)
        self.params = (tree_map(lambda t: t.to(self.device), params)
                       if params is not None
                       else init_params(cfg, seed, self.device))
        self.caches = init_cache(cfg, max_slots, max_seq, "paged",
                                 device=self.device)
        self.pos = np.zeros(max_slots, np.int64)
        self.active: Dict[int, Request] = {}
        self.queue: "collections.deque[Request]" = collections.deque()
        self.free_slots = list(range(max_slots))
        self.finished: List[Request] = []
        self.decode_steps = 0
        self.compactions = 0
        self._rid = 0

    # ------------------------------------------------------------- client
    def submit(self, prompt: List[int], max_new: int = 16) -> Request:
        require_token_input(self.cfg)
        if not prompt or len(prompt) + max_new > self.max_seq:
            raise ValueError(f"prompt of {len(prompt)} tokens + {max_new} new "
                             f"must be 1..{self.max_seq} tokens")
        self._rid += 1
        req = Request(self._rid, list(prompt), max_new, submitted=time.time())
        self.queue.append(req)
        return req

    # ---------------------------------------------------------- scheduler
    def _slot_cache(self, slot: int):
        """Views of one slot's cache; writes through them land in the pool."""
        return tree_map(lambda a: a[:, slot:slot + 1], self.caches)

    @torch.no_grad()
    def _admit(self):
        while self.queue and self.free_slots:
            req = self.queue.popleft()
            slot = self.free_slots.pop()
            req.slot = slot
            plen = len(req.prompt)
            # fragmented allocation: reused slots get scrambled block order
            sub = self._slot_cache(slot)
            self._fresh_slot_tables(sub)
            toks = np.zeros((1, self.max_seq), np.int64)
            toks[0, :plen] = req.prompt
            logits, _ = forward(self.params, torch.from_numpy(toks).to(
                self.device), self.cfg, mode="prefill", caches=sub)
            req.out.append(int(torch.argmax(logits[0, plen - 1])))
            self.pos[slot] = plen
            self.active[slot] = req

    def _fresh_slot_tables(self, sub):
        """Zero the slot's pools and give each of its tables a fresh
        permutation, drawn leaf by leaf in the JAX engine's (sorted-key)
        order and shared by all repeats, so both engines scramble alike."""
        for name, leaf in tree_paths(sub):
            if name.endswith("table"):
                nblk = leaf.shape[-1]
                perm = (self.rng.permutation(nblk) if self.scramble
                        else np.arange(nblk)).astype(np.int32)
                leaf.copy_(torch.from_numpy(perm).expand(leaf.shape))
            else:
                leaf.zero_()

    @torch.no_grad()
    def step(self) -> int:
        """One engine iteration; returns number of tokens produced."""
        self._admit()
        if not self.active:
            return 0
        tokens = np.zeros((self.max_slots, 1), np.int64)
        for slot, req in self.active.items():
            tokens[slot, 0] = req.out[-1]
        pos = torch.from_numpy(np.maximum(self.pos, 0)).to(self.device)
        logits, self.caches = forward(
            self.params, torch.from_numpy(tokens).to(self.device), self.cfg,
            mode="decode", caches=self.caches, pos=pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        produced = 0
        for slot in list(self.active):
            req = self.active[slot]
            self.pos[slot] += 1
            req.out.append(int(nxt[slot]))
            produced += 1
            if len(req.out) - 1 >= req.max_new:
                req.done = True
                req.finished = time.time()
                self.finished.append(req)
                del self.active[slot]
                self.free_slots.append(slot)
        self.decode_steps += 1
        return produced

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        total = 0
        for _ in range(max_steps):
            n = self.step()
            total += n
            if not self.active and not self.queue:
                return total
        raise TimeoutError("serving engine did not drain")

    # ------------------------------------------------------------- the GC
    def fragmentation(self) -> float:
        """Fraction of non-identity block-table entries (scatter level)."""
        total = ident = 0
        for name, t in tree_paths(self.caches):
            if "table" not in name:
                continue
            t = t.cpu().numpy()
            ident += (t == np.arange(t.shape[-1])).sum()
            total += t.size
        return 1.0 - ident / max(total, 1)

    @torch.no_grad()
    def compact(self):
        """Nezha GC for the KV pool: gather every slot's blocks into logical
        order and reset tables to identity.  The new pools are new tensors;
        the old ones stay valid until the per-group swap."""
        groups = []
        for group in self.caches["layers"]:
            pk, pv, tb = group["pool_k"], group["pool_v"], group["table"]
            shp = pk.shape                     # (reps, B, nblk, bs, nkv, hd)
            flat = (-1,) + shp[2:4] + (shp[4] * shp[5],)
            flat_t = tb.reshape(-1, tb.shape[-1])
            new_k, ident = compact_kv_pool(pk.reshape(flat), flat_t)
            new_v, _ = compact_kv_pool(pv.reshape(flat), flat_t)
            groups.append(dict(group, pool_k=new_k.reshape(shp),
                               pool_v=new_v.reshape(shp),
                               table=ident.reshape(tb.shape)))
        self.caches = dict(self.caches, layers=tuple(groups))
        self.compactions += 1
