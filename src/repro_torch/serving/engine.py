"""Replica inference engine: continuous batching over the model stack (the
port's ``repro.serving.engine``).

One ``ReplicaEngine`` is one model replica on one card.  Fixed slot layout:
the cache is (L, slots, ...) (the KV cache (L, slots, Smax, KV, hd), with
hymba's SSD heads also their state (L, slots, H, N, hd); MLA's latent (L,
slots, Smax, lora + r); or RWKV6's recurrent state and token shifts); a
request occupies one slot from admission to completion, ``admit``
prefills its prompt into that slot (``flash_attention``, and hymba's SSD
heads through ``rwkv6_chunked``'s post-update variant, or RWKV6's
``rwkv6_chunked``, in every layer), and every ``step`` decodes one token
for all slots (``decode_attention`` in every layer, beside the SSD's decode
step, or RWKV6's decode step; idle slots run masked, the standard
continuous-batching schedule).  Greedy decoding.

A prefill starts its slot afresh: RWKV6's layers overwrite the slot's state
and shifts, and hymba's SSD heads its SSM state, from a zero start
(``models.transformer._rwkv_layer``, ``_ssm_branch``), where the
reference's engine continues the previous occupant's state (ROADMAP Queue
3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import Runtime, forward, init_cache


@dataclasses.dataclass
class Sequence:
    rid: int
    tokens: List[int]
    prompt_len: int
    max_new: int
    done: bool = False


class ReplicaEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 8,
                 max_len: int = 512, rt: Optional[Runtime] = None,
                 eos_id: int = 1, device=None):
        self.cfg = cfg
        self.params = params
        self.rt = rt or Runtime()
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        # the card the parameters live on, unless the caller names one
        self.device = torch.device(device) if device is not None else \
            params["embed"].device
        self.cache = init_cache(cfg, slots, max_len, device=self.device)
        self.seqs: Dict[int, Sequence] = {}
        self.slot_of: Dict[int, int] = {}
        self.free = list(range(slots))
        self.pos = np.zeros(slots, np.int32)

    # ------------------------------------------------------------ model calls
    def _prefill(self, tokens: torch.Tensor, slot: int) -> torch.Tensor:
        """Single-sequence prefill written into one slot of the cache (a
        view: the layers write it in place); the last position's logits."""
        sub = {k: c[:, slot:slot + 1] for k, c in self.cache.items()}
        logits, _, _ = forward(self.params, self.cfg, self.rt, tokens,
                               mode="prefill", cache=sub, cache_pos=0)
        return logits[:, -1]

    def _decode(self, tokens: torch.Tensor,
                lens: torch.Tensor) -> torch.Tensor:
        """One token for every slot at its own depth ``lens``."""
        logits, _, _ = forward(self.params, self.cfg, self.rt, tokens,
                               mode="decode", cache=self.cache,
                               cache_pos=lens)
        return logits[:, 0]

    # ------------------------------------------------------------------- api
    @property
    def n_active(self) -> int:
        return len(self.seqs)

    def can_admit(self) -> bool:
        return bool(self.free)

    def admit(self, rid: int, prompt: List[int], max_new: int) -> None:
        slot = self.free.pop(0)
        self.slot_of[rid] = slot
        self.seqs[rid] = Sequence(rid, list(prompt), len(prompt), max_new)
        toks = torch.tensor([list(prompt)], dtype=torch.int64,
                            device=self.device)
        logits = self._prefill(toks, slot)
        self.pos[slot] = len(prompt)
        self.seqs[rid].tokens.append(int(torch.argmax(logits[0])))

    def step(self) -> List[int]:
        """Decode one token for every active sequence; returns finished
        rids."""
        if not self.seqs:
            return []
        tokens = np.zeros((self.slots, 1), np.int64)
        for rid, seq in self.seqs.items():
            tokens[self.slot_of[rid], 0] = seq.tokens[-1]
        logits = self._decode(torch.from_numpy(tokens).to(self.device),
                              torch.from_numpy(self.pos).to(self.device))
        out = torch.argmax(logits, -1).cpu().numpy()
        finished = []
        for rid, seq in list(self.seqs.items()):
            s = self.slot_of[rid]
            seq.tokens.append(int(out[s]))
            self.pos[s] += 1
            new = len(seq.tokens) - seq.prompt_len
            if new >= seq.max_new or int(out[s]) == self.eos_id or \
                    self.pos[s] >= self.max_len - 1:
                seq.done = True
                finished.append(rid)
                self.free.append(s)
                del self.seqs[rid]
                del self.slot_of[rid]
        return finished
