"""``DecodeEngine`` — per-slot continuous batching over the GPT decode model
(the port of ``dtf_tpu.serve.engine``).

Offline ``generate`` runs one fixed batch start to finish: a single long
request holds the whole batch while finished rows idle. This engine makes
the batch dimension a SLOT pool: every row of the KV cache is an
independent request at its own position (``GPTConfig.slot_decode`` — the
``cache_index`` is a [n_slots] tensor), so requests stream in and out of
rows while the shapes never change.

Exactly two step functions exist, built once at construction
(``trace_counts`` stays ``{"prefill": 1, "decode": 1}``):

- ``prefill_into_slot`` — one ``prefill_chunk``-wide, right-padded prompt
  chunk into one slot. The slot's rows are gathered into a batch-1 plain
  cache (a 0-d ``cache_index``), run through the chunked-prefill path
  that offline ``generate(prefill_chunk=...)`` uses (``prefill_len``
  masks the pad: its K/V never lands, the index advances by the valid
  count) and scattered back. On the last chunk it samples the request's
  first token and marks the slot active.
- ``decode_all`` — one masked token step over all slots, each slot with
  its own temperature / top-k / top-p / eos through
  :func:`dtf_tpu_torch.models.gpt.sample_tokens`, whose stream a request
  owns (its seed and its draw count), so the engine's tokens equal batch-1
  ``generate``'s, greedy and sampled alike. Inactive slots (empty, or
  between prefill chunks) write nothing and keep their token, sampler
  state and ``done`` bit for bit.

The state lives on the engine's device and both steps write it IN PLACE.
Every operand of a step is a device tensor of a shape fixed at
construction (a prefill chunk's scalars and token ids arrive through one
host-to-device copy into a fixed buffer), and a step makes no
device-to-host sync: the host reads back only ``(tokens, done)`` after a
decode step and the first token after a last chunk — what a CUDA graph
of a step needs (none is captured yet). The engine is dense, like the
reference: its prefill is the chunked-prefill einsum and its decode the
grouped decode einsum, so it launches none of the hand kernels.

Not yet ported: speculative decoding (``draft_cfg``/``spec_k``), the
prefix page pool (``prefix_pages``/``kv_page_size``/``shared_pages``),
sharded serving (``mesh``), weight hot-swap (``swap_params``) and trace
annotations (``annotate_traces``); each raises when asked for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from dtf_tpu_torch.core.device import resolve_device
from dtf_tpu_torch.models import gpt

#: per-slot state next to the cache (leading dim n_slots): name, dtype,
#: initial value. One registry so the state allocation and the steps cannot
#: desynchronize.
_SLOT_ARRAYS = (
    ("tok", torch.long, 0),        # last emitted token (next decode input)
    ("temp", torch.float32, 0.0),  # 0 = greedy, else sampling temperature
    ("top_k", torch.long, 0),      # 0 = off
    ("top_p", torch.float32, 1.0),  # 1.0 = off
    ("eos", torch.long, -1),       # -1 = no stop token
    ("pad", torch.long, 0),        # token emitted after eos (offline rule)
    ("done", torch.bool, False),   # has emitted eos
    ("active", torch.bool, False),  # fully prefilled; a False row rides
                                    # decode_all untouched: no cache write,
                                    # no index advance, no draw
    ("key", torch.long, 0),        # sampler key of the request's seed
    ("draws", torch.long, 0),      # tokens the request has drawn
)

#: the prefill step's int64 operand row: these scalars, then the chunk
_PREFILL_INTS = ("slot", "start", "n_valid", "reset", "is_last", "top_k",
                 "eos", "pad", "seed")
#: and its float32 operand row
_PREFILL_FLOATS = ("temp", "top_p")


def _row_cache(cache: list, slot: torch.Tensor) -> list:
    """One slot's rows as a batch-1 plain cache (a 0-d ``cache_index``)
    for the chunked-prefill path. Keys are classified by
    :func:`gpt.batch_led_cache_key`: an unknown key fails loudly instead
    of riding the slot unsliced."""
    rows = []
    for layer in cache:
        row = {}
        for name, x in layer.items():
            if gpt.batch_led_cache_key(name):
                row[name] = None if x is None else x.index_select(0, slot)
            else:
                row[name] = x.index_select(0, slot)[0]
        rows.append(row)
    return rows


def _write_row_cache(cache: list, rows: list, slot: torch.Tensor) -> None:
    """Scatter a batch-1 plain cache back into slot ``slot``, in place."""
    for layer, row in zip(cache, rows):
        for name, x in layer.items():
            if x is None:
                continue
            r = row[name]
            x.index_copy_(0, slot, r if gpt.batch_led_cache_key(name)
                          else r.reshape(1))


def _build_prefill_fn(model: gpt.GPT):
    """prefill_into_slot: one fixed-width chunk into one slot; on the last
    chunk, sample the request's first token (draw 0 of its stream).
    ``start`` is where a fresh request's index lands (``reset`` on its
    first chunk); stale slot contents past it need no clearing — validity
    derives from the index."""
    def prefill_fn(state: dict, ints: torch.Tensor,
                   floats: torch.Tensor) -> torch.Tensor:
        op = {name: ints[i] for i, name in enumerate(_PREFILL_INTS)}
        op.update((name, floats[i]) for i, name in enumerate(_PREFILL_FLOATS))
        one = {name: x.reshape(1) for name, x in op.items()}
        slot = one["slot"]
        chunk = ints[len(_PREFILL_INTS):]
        reset, is_last = op["reset"].bool(), op["is_last"].bool()
        rows = _row_cache(state["cache"], slot)
        for row in rows:
            row["cache_index"] = torch.where(reset, op["start"],
                                             row["cache_index"])
        logits = model(chunk[None, :], rows, chunked_prefill=True,
                       prefill_len=op["n_valid"])
        _write_row_cache(state["cache"], rows, slot)

        last = logits[0].index_select(0, one["n_valid"] - 1)      # [1, V]
        key = gpt.sampler_key(one["seed"], torch.zeros_like(slot))
        tok = gpt.sample_tokens(last, temperature=one["temp"],
                                top_k=one["top_k"], top_p=one["top_p"],
                                key=key, draw=torch.zeros_like(slot))
        done = is_last & (one["eos"] >= 0) & (tok == one["eos"])
        # the sampling rows are (re)stamped on every chunk of the request
        # — idempotent, and the slot is fully reinitialized by its first
        # chunk whoever held it before
        new = {"tok": torch.where(is_last, tok,
                                  state["tok"].index_select(0, slot)),
               "temp": one["temp"], "top_k": one["top_k"],
               "top_p": one["top_p"], "eos": one["eos"], "pad": one["pad"],
               "done": done, "active": one["is_last"].bool(), "key": key,
               "draws": one["is_last"]}
        for name, value in new.items():
            state[name].index_copy_(0, slot, value)
        return torch.cat([tok, done.long()])

    return prefill_fn


def _build_decode_fn(model: gpt.GPT):
    """decode_all: one masked token step across all slots."""
    def decode_fn(state: dict) -> torch.Tensor:
        active = state["active"]
        logits = model(state["tok"][:, None], state["cache"],
                       decode_active=active)[:, 0]               # [S, V]
        nxt = gpt.sample_tokens(logits, temperature=state["temp"],
                                top_k=state["top_k"], top_p=state["top_p"],
                                key=state["key"], draw=state["draws"])
        # the offline eos rule per slot: a done row keeps stepping but
        # emits pad; done flips AFTER the eos token itself is kept
        nxt = torch.where(state["done"], state["pad"], nxt)
        done = state["done"] | ((state["eos"] >= 0) & (nxt == state["eos"]))
        # inactive rows are spectators: token, draws and done unchanged
        state["draws"].add_(active.long())
        state["tok"].copy_(torch.where(active, nxt, state["tok"]))
        state["done"].copy_(torch.where(active, done, state["done"]))
        return torch.stack([nxt, done.long()])

    return decode_fn


class DecodeEngine:
    """Slot-pooled online decode over a GPT's parameters.

    ``cfg`` is the TRAINED architecture (the decode fields are set here);
    ``params`` its state dict (``convert.params_from_flax`` of a flax
    tree, or ``Checkpointer.restore_params``). ``max_len`` sizes each
    slot's KV cache (prompt + generated tokens of a request must fit),
    ``n_slots`` the pool of concurrent requests, ``prefill_chunk`` the
    fixed width of the prefill step (>= 2: a 1-token call is a decode
    step). ``device``: ``cuda`` unless asked for the CPU; without a GPU
    asking for ``cuda`` raises.
    """

    def __init__(self, cfg: gpt.GPTConfig, params, *, n_slots: int,
                 max_len: int, prefill_chunk: int = 16, device="cuda",
                 mesh=None, kv_page_size: int = 0, prefix_pages: int = 0,
                 draft_cfg: Optional[gpt.GPTConfig] = None,
                 draft_params=None, spec_k: int = 0, shared_pages=None):
        if n_slots < 1:
            raise ValueError(f"n_slots={n_slots} must be >= 1")
        if max_len < 2:
            raise ValueError(f"max_len={max_len} must be >= 2 "
                             "(prompt + at least one generated token)")
        if prefill_chunk < 2:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be >= 2: a 1-token "
                "apply routes to the single-token decode branch, not the "
                "chunked-prefill path")
        unported = {"prefix_pages / kv_page_size / shared_pages (the "
                    "prefix page pool)": prefix_pages or kv_page_size
                    or shared_pages is not None,
                    "draft_cfg / draft_params / spec_k (speculative "
                    "decoding)": draft_cfg is not None
                    or draft_params is not None or spec_k,
                    "mesh (sharded serving)": mesh is not None}
        for what, asked in unported.items():
            if asked:
                raise NotImplementedError(f"{what} is not yet ported")
        base = dataclasses.replace(cfg, decode_len=max_len,
                                   slot_decode=False, chunked_prefill=False)
        # the chunk may not be wider than ANY layer's cache: the rolling-
        # buffer write keeps only the last cache_len CHUNK positions, and
        # right-padding sits at the chunk's end — a wider chunk would push
        # valid prompt tokens out of the write window
        min_cache = min(
            (min(max_len, w) if (w := base.layer_window(i)) else max_len)
            for i in range(base.layers))
        if prefill_chunk > min_cache:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} exceeds the smallest "
                f"per-layer cache length {min_cache} (max_len={max_len}, "
                f"attn_window={base.attn_window}); a right-padded chunk "
                "wider than the cache drops valid prompt K/V")
        self.cfg = base
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.spec_k = 0
        self.device = resolve_device(device)
        #: host-side call counters (plain ints, no device readback); the
        #: page, prefix and swap counters stay 0 until those are ported
        self.counters = {"prefill_chunks": 0, "decode_steps": 0,
                         "pages_loaded": 0, "pages_saved": 0,
                         "prefix_hit_tokens": 0, "prefix_miss_tokens": 0,
                         "probe_decodes": 0, "param_swaps": 0}
        #: the version of the weights served: 0, as constructed (the
        #: scheduler stamps it into every completed record)
        self.param_version = 0

        with torch.no_grad():
            model = gpt.GPT(dataclasses.replace(base, slot_decode=True),
                            device=self.device)
            model.load_state_dict(params)
        self._model = model.eval()
        state = {"cache": model.init_cache(n_slots)}
        for name, dtype, init in _SLOT_ARRAYS:
            state[name] = torch.full((n_slots,), init, dtype=dtype,
                                     device=self.device)
        self._state = state
        # the prefill step's operand buffers: the host fills them with one
        # copy a chunk, the step reads only these
        self._ints = torch.zeros(len(_PREFILL_INTS) + prefill_chunk,
                                 dtype=torch.long, device=self.device)
        self._floats = torch.zeros(len(_PREFILL_FLOATS), dtype=torch.float32,
                                   device=self.device)
        #: builds of each step function — the recompile fence of the
        #: reference, pinned at one each: the shapes never change
        self.trace_counts = {"prefill": 0, "decode": 0}
        self._prefill_fn = _build_prefill_fn(self._model)
        self.trace_counts["prefill"] += 1
        self._decode_fn = _build_decode_fn(self._model)
        self.trace_counts["decode"] += 1

    # ------------------------------------------------------------- host API

    @property
    def annotate_traces(self) -> bool:
        """Request trace annotations on the step calls: not yet ported."""
        return False

    @annotate_traces.setter
    def annotate_traces(self, on: bool) -> None:
        if on:
            raise NotImplementedError(
                "annotate_traces (request ids on the step calls) is not "
                "yet ported")

    def swap_params(self, params, *, draft_params=None, version=None):
        raise NotImplementedError("swap_params (weight hot-swap) is not "
                                  "yet ported")

    @property
    def state(self) -> dict:
        """The engine's device state (the slot cache and the per-slot
        rows), for inspection; the steps write it in place."""
        return self._state

    def n_chunks(self, prompt_len: int) -> int:
        return math.ceil(prompt_len / self.prefill_chunk)

    def _stage(self, dst: torch.Tensor, values) -> None:
        """Copy host values into a fixed device buffer without a host
        sync: through a pinned buffer on CUDA (the caching host allocator
        holds it until the copy has run)."""
        src = torch.tensor(values, dtype=dst.dtype,
                           pin_memory=dst.is_cuda)
        dst.copy_(src, non_blocking=True)

    def prefill_into_slot(self, slot: int, prompt: Sequence[int],
                          chunk_i: int, *, start: int = 0,
                          temperature: float = 0.0, top_k: int = 0,
                          top_p: float = 1.0, eos_id: Optional[int] = None,
                          pad_id: int = 0, seed: int = 0) -> torch.Tensor:
        """Run prompt chunk ``chunk_i`` into ``slot`` and return the step's
        device output ``[token, done]`` (meaningful on the last chunk) —
        no device-to-host sync. :meth:`prefill_chunk_into` is the host
        API around it."""
        prompt = [int(t) for t in prompt]
        if not 1 <= len(prompt) <= self.max_len - 1:
            raise ValueError(
                f"prompt length {len(prompt)} must be in [1, "
                f"{self.max_len - 1}] (max_len={self.max_len} covers "
                "prompt + generated tokens)")
        if start:
            raise NotImplementedError(
                f"start={start}: prefix pages loaded into a slot (the "
                "prefix page pool) are not yet ported")
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        c = self.prefill_chunk
        n = self.n_chunks(len(prompt))
        if not 0 <= chunk_i < n:
            raise ValueError(f"chunk {chunk_i} out of range [0, {n})")
        seg = prompt[chunk_i * c:(chunk_i + 1) * c]
        ints = [slot, start, len(seg), int(chunk_i == 0),
                int(chunk_i == n - 1), top_k,
                -1 if eos_id is None else eos_id, pad_id, seed]
        self._stage(self._ints, ints + seg + [0] * (c - len(seg)))
        self._stage(self._floats, [temperature, top_p])
        with torch.no_grad():
            out = self._prefill_fn(self._state, self._ints, self._floats)
        self.counters["prefill_chunks"] += 1
        return out

    def prefill_chunk_into(self, slot: int, prompt: Sequence[int],
                           chunk_i: int, *, start: int = 0,
                           temperature: float = 0.0, top_k: int = 0,
                           top_p: float = 1.0, eos_id: Optional[int] = None,
                           pad_id: int = 0, seed: int = 0
                           ) -> Optional[tuple[int, bool]]:
        """Run prompt chunk ``chunk_i`` of a request into ``slot`` — the
        scheduler's prefill/decode interleave granularity (decode_all may
        run between chunks; the slot stays a masked spectator until its
        last chunk lands). Returns ``(first_token, done)`` on the last
        chunk (the one readback), None before."""
        out = self.prefill_into_slot(
            slot, prompt, chunk_i, start=start, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_id=eos_id, pad_id=pad_id,
            seed=seed)
        if chunk_i != self.n_chunks(len(prompt)) - 1:
            return None
        tok, done = out.tolist()
        return int(tok), bool(done)

    def prefill(self, slot: int, prompt: Sequence[int], *, start: int = 0,
                **sampling) -> tuple[int, bool]:
        """Admit a request into ``slot``: stream its whole prompt through
        the chunk step and sample the first token. Returns
        ``(first_token, done)``."""
        n = self.n_chunks(len(prompt) - start)
        if n == 0:
            raise ValueError(
                f"prompt length 0 must be in [1, {self.max_len - 1}]")
        out = None
        for i in range(n):
            out = self.prefill_chunk_into(slot, prompt, i, start=start,
                                          **sampling)
        return out

    def decode_all(self) -> torch.Tensor:
        """One masked token step across all slots; returns the device
        output [2, n_slots] (tokens, done) — no device-to-host sync."""
        with torch.no_grad():
            out = self._decode_fn(self._state)
        self.counters["decode_steps"] += 1
        return out

    def decode(self):
        """One masked token step across all slots: ``(tokens [n_slots],
        done [n_slots])`` as host arrays — the one device-to-host sync a
        generated token (eos and delivery decisions live on the host)."""
        out = self.decode_all().cpu().numpy()
        return out[0], out[1].astype(bool)

    def probe(self) -> None:
        """One decode step with the outputs discarded (the router's health
        probe). Stale slots advance like any other masked step, which is
        safe: an admitted request fully reinitializes its slot."""
        self.decode()
        self.counters["probe_decodes"] += 1

    def cache_bytes(self) -> int:
        """Resident KV footprint: the slot cache, all layers."""
        return sum(x.numel() * x.element_size()
                   for layer in self._state["cache"]
                   for x in layer.values() if x is not None)
