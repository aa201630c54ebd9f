"""Continuous-batching decode engine (``torchmx_tpu/models/serve.py``).

A slot-based serving loop around one fixed-shape decode step: requests join
and leave a pool of ``max_batch`` slots at any time, and every slot decodes
at its own sequence position (per-row ``cache_position``: the KV caches
store per row, the attention kernels mask per row).

Usage::

    engine = DecodeEngine(model, max_batch=8, max_len=2048,
                          kv_cache_config=MXConfig("int8"), eos_token_id=eos)
    slot = engine.add(prompt_ids)             # prefill into a free slot
    while engine.is_active(slot):
        tokens = engine.step()                # {slot: next token id}
    print(engine.finished_reason[slot])       # "eos" | "cache_full" | "stop"

Where this differs from the reference, which jits its steps:

* No ``jit``, no buffer donation, no state snapshot: the engine holds the
  module and calls it under ``torch.inference_mode()``; the caches are
  updated in place.
* The decode step keeps its shapes fixed at ``max_batch``, inactive slots
  included, as the reference does: every kernel sees one shape, which is also
  what a CUDA-graph replay of the step needs.  INVARIANT: an inactive slot
  decodes at its stale position and writes garbage K/V into its own rows, so
  an inactive slot's cache is garbage until ``add()`` replaces all of it.
* An admission prefills a single-slot cache of its own and is then copied
  into its slot.  Prefilling straight into the engine's caches would be
  wrong: while a chunked admission is pending, every decode step writes the
  (still inactive) slot's K/V at its stale position 0, over the chunk
  already written.
* There are no prefill buckets.  The reference pads a prompt to a bucket
  width only to bound recompiles; nothing compiles here, so a prompt is
  admitted at its true length (and the remainder after a cached prefix
  always fits: its window never has to shift down to stay inside the
  cache).  Chunked admission keeps its fixed chunk width and zero padding.
* One host round trip per ``step()`` is inherent: the host needs the tokens
  for EOS and stop sequences.  A step uploads the slots' positions and
  pending tokens in one copy and downloads the new tokens (and log
  probabilities) in one copy; nothing else synchronises, except that the
  step which lands a chunked admission's last chunk also reads that
  request's first token.
* Left for later and raising ``NotImplementedError``: ``speculative_draft_len``
  (needs ``models/speculate.py``), ``ring`` (needs sliding windows), ``mesh``
  (needs ``parallel/``), and a bf16 KV cache for the Llama family
  (``kv_cache_config=None``; DeepSeek-V3 takes it: its bf16 latent cache).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.backend import DeviceLike, resolve_device
from .sampling import sample_logits

SlotCaches = list  # per-layer caches with ``buffers`` and ``clone`` (the slot is dim 0 of every buffer)


class DecodeEngine:
    """Static-slot continuous batching around a causal LM of this package.

    Args:
        model: a causal LM of this package (``LlamaForCausalLM``,
            ``MistralForCausalLM``, ``MixtralForCausalLM`` or
            ``DeepseekV3ForCausalLM``; quantized or not): the engine uses its
            ``model``, ``logits`` and ``init_cache``.
        max_batch: number of request slots (the decode batch size).
        max_len: per-slot KV-cache capacity in tokens, rounded up to a
            multiple of 128 (the attention kernels' tile multiple).
        kv_cache_config: the ``MXConfig`` of the MX KV (or latent) cache; None
            for the model's bf16 cache where it has one (DeepSeek-V3's
            ``MLACache``).  Its storage layout is
            ``env_variables.TORCHMX_KV_LAYOUT`` at the time the engine is
            built, as in the reference.
        eos_token_id: token id(s) that release a slot when *generated* (the
            EOS token itself is not emitted).
        prefill_chunk: chunked admissions: ``add()`` only queues the prompt,
            and each ``step()`` advances one chunk of the oldest pending
            admission before decoding, so a long prompt stalls the active
            slots by one chunk at most.  Must divide ``max_len``.
        temperature: 0.0 decodes greedily; above 0 samples through the
            ``top_k`` / ``top_p`` / ``min_p`` filters from a generator seeded
            with ``seed`` on the model's device.
        stop_sequences: token sequences; a slot releases (reason ``"stop"``)
            when its emitted stream ends with one (the matching tokens are
            emitted: incremental emission cannot retract).
        return_logprobs: record the log-probability of every emitted token
            in ``logprobs[slot]``.
        device: where the engine runs: ``cuda`` by default (raising when
            there is none), ``"cpu"`` for the plain PyTorch path.  The model
            must lie there.
    """

    def __init__(
        self,
        model,
        max_batch: int,
        max_len: int,
        *,
        kv_cache_config=None,
        prefill_chunk: Optional[int] = None,
        eos_token_id=None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        seed: int = 0,
        stop_sequences: Optional[Sequence[Sequence[int]]] = None,
        return_logprobs: bool = False,
        device: DeviceLike = None,
        mesh=None,
        speculative_draft_len: Optional[int] = None,
        ring: bool = False,
    ):
        for name, asked in (("speculative_draft_len", speculative_draft_len is not None),
                            ("ring", ring), ("mesh", mesh is not None)):
            if asked:
                raise NotImplementedError(f"{name} is not ported yet")
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the engine runs on {self.device} but the model lies on {model.device}")
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len = (max_len + 127) // 128 * 128
        if prefill_chunk is not None and max_len % prefill_chunk != 0:
            # A final padded chunk whose window crossed max_len would have its
            # start clamped, moving pad K/V over valid earlier positions.
            raise ValueError(f"prefill_chunk {prefill_chunk} must divide max_len {max_len}")
        self.prefill_chunk = prefill_chunk
        if eos_token_id is None:
            eos_ids = ()
        elif isinstance(eos_token_id, int):
            eos_ids = (eos_token_id,)
        else:
            eos_ids = tuple(int(t) for t in eos_token_id)
        self.eos_token_ids = frozenset(eos_ids)
        self.stop_sequences = tuple(tuple(int(t) for t in seq) for seq in (stop_sequences or ()))
        if not all(self.stop_sequences):
            raise ValueError("stop sequences must be non-empty")
        self._max_stop = max((len(s) for s in self.stop_sequences), default=0)
        self._tail: List[list] = [[] for _ in range(max_batch)]
        #: per-slot log-probabilities of every emitted token (opt-in), aligned
        #: with the step() streams, cleared by add() and release().
        self.return_logprobs = bool(return_logprobs)
        self.logprobs: Dict[int, List[float]] = {}
        self.temperature, self.top_k = float(temperature), int(top_k)
        self.top_p, self.min_p = float(top_p), float(min_p)
        self._generator = None
        if self.temperature != 0.0:
            self._generator = torch.Generator(model.device).manual_seed(seed)
        self._kv_cache_config = kv_cache_config
        self._caches = model.init_cache(max_batch, max_len, kv_cache_config)
        # Per-slot host state: row 0 the next write position, row 1 the token
        # computed last step and not yet emitted.  One buffer, one upload per
        # step (pinned on the card, so the copy needs no staging).
        self._state = torch.zeros((2, max_batch), dtype=torch.int32,
                                  pin_memory=self.device.type == "cuda")
        self.pos, self._next_token = self._state.numpy()
        self._next_lp = np.zeros((max_batch,), np.float32)
        self.active = np.zeros((max_batch,), bool)
        #: why a slot released itself: "eos", "cache_full" or "stop"; cleared by add().
        self.finished_reason: Dict[int, str] = {}
        # Chunked admissions in flight: slot -> {"ids", "done", "caches"}.
        self._pending: Dict[int, dict] = {}
        # The slot's cache is full but its last computed token is not emitted
        # yet: one more step() emits it, then the slot is released.
        self._draining = np.zeros((max_batch,), bool)
        # Registered prompt prefixes: handle -> {"ids": tuple, "caches":
        # single-slot caches with positions [0, len(ids)) filled}.
        self._prefixes: Dict[int, dict] = {}
        self._prefix_next_handle = 0
        #: prompt tokens whose prefill was skipped through prefix-cache hits.
        self.prefix_hit_tokens = 0

    # -- the model ---------------------------------------------------------------

    def _pick(self, logits: torch.Tensor):
        """(token ids (b,), their log-probabilities (b,) fp32 or None)."""
        tok = sample_logits(logits, self._generator, self.temperature, top_k=self.top_k,
                            top_p=self.top_p, min_p=self.min_p)
        if not self.return_logprobs:
            return tok, None
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1).gather(-1, tok[:, None])[:, 0]
        return tok, lp

    def _new_slot_caches(self) -> SlotCaches:
        return self.model.init_cache(1, self.max_len, self._kv_cache_config)

    def _copy_slot_caches(self, caches: SlotCaches) -> SlotCaches:
        return [c.clone() for c in caches]

    @torch.inference_mode()
    def _prefill(self, caches: SlotCaches, ids: np.ndarray, start: int, last_idx: Optional[int]):
        """Run ``ids`` (one row) at positions ``[start, start + len(ids))``
        over single-slot caches; with ``last_idx`` pick the token after
        ``ids[last_idx]`` and return (token, log-probability or None) as
        Python numbers."""
        ids_t = torch.from_numpy(np.asarray(ids, np.int64))[None].to(self.device)
        hidden = self.model.model(ids_t, caches=caches, cache_position=start)
        if last_idx is None:
            return None
        tok, lp = self._pick(self.model.logits(hidden[:, last_idx:last_idx + 1])[:, 0])
        return int(tok[0]), (None if lp is None else float(lp[0]))

    def _install(self, slot: int, caches: SlotCaches, n: int, token: int, lp: Optional[float]) -> None:
        """Copy an admission's single-slot caches into ``slot`` and start it
        decoding after its ``n`` prompt tokens, ``token`` pending."""
        for big, small in zip(self._caches, caches):
            for dst, src in zip(big.buffers, small.buffers):  # the slot is dim 0 in either layout
                dst[slot].copy_(src[0])
        self._next_token[slot] = token
        self._next_lp[slot] = 0.0 if lp is None else lp
        self.pos[slot] = n
        self.active[slot] = True
        self.finished_reason.pop(slot, None)
        self._tail[slot] = []
        self.logprobs.pop(slot, None)
        if token in self.eos_token_ids:
            self._evict(slot, "eos")  # the first continuation is EOS: nothing to emit

    # -- request lifecycle -----------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i in range(self.max_batch) if not self.active[i]]

    def is_active(self, slot: int) -> bool:
        return bool(self.active[slot])

    def cache_prefix(self, prefix_ids: Sequence[int]) -> int:
        """Compute and keep the KV cache of a shared prompt prefix.  A later
        ``add()`` whose prompt strictly extends a registered prefix copies its
        K/V rows instead of recomputing them (the longest match wins) and
        prefills only the remainder.  Each stored prefix costs one single-slot
        cache; ``drop_prefix()`` frees it.  Returns a handle."""
        ids_t = tuple(int(t) for t in prefix_ids)
        if not 1 <= len(ids_t) < self.max_len:
            raise ValueError(f"prefix length {len(ids_t)} must be in [1, max_len={self.max_len})")
        caches = self._new_slot_caches()
        self._prefill(caches, np.asarray(ids_t), 0, None)
        handle = self._prefix_next_handle
        self._prefix_next_handle += 1
        self._prefixes[handle] = {"ids": ids_t, "caches": caches}
        return handle

    def drop_prefix(self, handle: int) -> None:
        """Free a prefix registered by :meth:`cache_prefix`."""
        del self._prefixes[handle]

    def _match_prefix(self, prompt: Sequence[int]):
        """(length, caches) of the longest registered prefix the prompt
        strictly extends (the remainder must be non-empty, so that admission
        always computes fresh last-token logits), or (0, None)."""
        pt = tuple(int(t) for t in prompt)
        best, best_p = None, 0
        for entry in self._prefixes.values():
            p = len(entry["ids"])
            if p > best_p and len(pt) > p and pt[:p] == entry["ids"]:
                best, best_p = entry, p
        return best_p, (best["caches"] if best else None)

    def add(self, prompt_ids: Sequence[int]) -> int:
        """Admit ``prompt_ids`` into a free slot and return the slot id.
        Without ``prefill_chunk`` the whole prompt prefills here; with it the
        prompt is queued and ``step()`` advances one chunk per call, the slot
        emitting once its last chunk has landed.  A prompt extending a
        registered prefix skips the prefix's prefill in both modes."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slots; release() one first")
        slot = free[0]
        ids = np.asarray(list(prompt_ids), np.int64)
        n = len(ids)
        if not 1 <= n <= self.max_len:
            raise ValueError(f"prompt length {n} must be in [1, max_len={self.max_len}]")
        match_p, match_caches = self._match_prefix(ids)
        if self.prefill_chunk is not None:
            # Chunk windows start at chunk multiples: round the reused length
            # down; the overlap recomputes to the same bytes.
            match_p = (match_p // self.prefill_chunk) * self.prefill_chunk
        caches = self._copy_slot_caches(match_caches) if match_p else self._new_slot_caches()
        self.prefix_hit_tokens += match_p
        if self.prefill_chunk is not None:
            self._pending[slot] = {"ids": ids, "done": match_p, "caches": caches}
            self.active[slot] = True  # reserved; emits after the last chunk
            self.finished_reason.pop(slot, None)
            return slot
        token, lp = self._prefill(caches, ids[match_p:], match_p, n - match_p - 1)
        self._install(slot, caches, n, token, lp)
        return slot

    def _advance_pending_chunk(self) -> None:
        """Run one chunk of the oldest pending admission."""
        slot = next(iter(self._pending))
        p = self._pending[slot]
        chunk, n, done = self.prefill_chunk, len(p["ids"]), p["done"]
        take = min(chunk, n - done)
        ids = np.zeros((chunk,), np.int64)  # the last chunk is zero-padded to the chunk width
        ids[:take] = p["ids"][done:done + take]
        p["done"] = done + take
        picked = self._prefill(p["caches"], ids, done, take - 1 if p["done"] >= n else None)
        if picked is not None:
            del self._pending[slot]
            self._install(slot, p["caches"], n, *picked)

    @torch.inference_mode()
    def step(self) -> Dict[int, int]:
        """Decode one token for every active slot and return ``{slot: emitted
        token id}``.  A slot releases itself, and stops appearing in the
        result, when it generates an EOS token (``finished_reason[slot] ==
        "eos"``; the EOS is not emitted), when its cache fills
        (``"cache_full"``) or when its stream ends with a stop sequence
        (``"stop"``)."""
        if self._pending:
            self._advance_pending_chunk()
        decoding = [i for i in range(self.max_batch) if self.active[i] and i not in self._pending]
        if not decoding:
            return {}
        state = self._state.to(self.device, non_blocking=True)
        logits = self.model(state[1].long()[:, None], caches=self._caches, cache_position=state[0])[:, -1]
        nxt, lps = self._pick(logits)
        if lps is None:
            nxt = nxt.cpu().numpy()
        else:  # one download: token ids are exact in float64
            nxt, lps = torch.stack([nxt.to(torch.float64), lps.to(torch.float64)]).cpu().numpy()
        out: Dict[int, int] = {}
        for i in decoding:
            out[i] = int(self._next_token[i])
            if self.return_logprobs:
                self.logprobs.setdefault(i, []).append(float(self._next_lp[i]))
            if self._draining[i]:
                # The last token, computed a step ago, needed no cache write.
                # This step's output for the slot came from a clamped K/V
                # write and is dropped.
                self._evict(i, "cache_full")
                continue
            self._next_token[i] = int(nxt[i])
            if self.return_logprobs:
                self._next_lp[i] = float(lps[i])
            self.pos[i] += 1
            if int(nxt[i]) in self.eos_token_ids:
                self._evict(i, "eos")
            elif self.pos[i] >= self.max_len:
                # The cache is full, but nxt is a valid last token (its K/V
                # row was just written): emit it next step, then release.
                self._draining[i] = True
        self._apply_stops(out)
        return out

    def _apply_stops(self, out: Dict[int, int]) -> None:
        """Release the slots whose emitted stream now ends with a stop sequence."""
        if not self.stop_sequences:
            return
        for slot, tok in out.items():
            tail = self._tail[slot]
            tail.append(int(tok))
            del tail[:-self._max_stop]
            if self.active[slot] and any(tuple(tail[-len(seq):]) == seq for seq in self.stop_sequences):
                self._evict(slot, "stop")

    def _deactivate(self, slot: int) -> None:
        self.active[slot] = False
        self.pos[slot] = 0
        self._draining[slot] = False
        self._pending.pop(slot, None)

    def _evict(self, slot: int, reason: str) -> None:
        self._deactivate(slot)
        self.finished_reason[slot] = reason

    def release(self, slot: int) -> None:
        self._deactivate(slot)
        self.finished_reason.pop(slot, None)
        self.logprobs.pop(slot, None)
