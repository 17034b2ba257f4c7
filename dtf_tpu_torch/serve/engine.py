"""``DecodeEngine`` — per-slot continuous batching over the GPT decode model
(the port of ``dtf_tpu.serve.engine``).

Offline ``generate`` runs one fixed batch start to finish: a single long
request holds the whole batch while finished rows idle. This engine makes
the batch dimension a SLOT pool: every row of the KV cache is an
independent request at its own position (``GPTConfig.slot_decode`` — the
``cache_index`` is a [n_slots] tensor), so requests stream in and out of
rows while the shapes never change.

Without a draft model exactly two step functions exist, built once at
construction (``trace_counts`` stays ``{"prefill": 1, "decode": 1}``):

- ``prefill_into_slot`` — one ``prefill_chunk``-wide, right-padded prompt
  chunk into one slot. The slot's rows are gathered into a batch-1 plain
  cache (a 0-d ``cache_index``), run through the chunked-prefill path
  that offline ``generate(prefill_chunk=...)`` uses (``prefill_len``
  masks the pad: its K/V never lands, the index advances by the valid
  count) and scattered back. On the last chunk it samples the request's
  first token and marks the slot active. ``start`` > 0 continues prefix
  pages already loaded into the slot.
- ``decode_all`` — one masked token step over all slots, each slot with
  its own temperature / top-k / top-p / eos through
  :func:`dtf_tpu_torch.models.gpt.sample_tokens`, whose stream a request
  owns (its seed and its draw count), so the engine's tokens equal batch-1
  ``generate``'s, greedy and sampled alike. Inactive slots (empty, or
  between prefill chunks) write nothing and keep their token, sampler
  state and ``done`` bit for bit.

**Speculative decoding** (``draft_cfg``/``draft_params``, ``spec_k`` =
k > 0): FOUR step functions, never more (``trace_counts`` {prefill,
decode, draft_prefill, draft}). The draft keeps its own slot state and
cache; ``draft_prefill`` (the prefill step of the draft model) rides
along each target chunk, and the decode step becomes a tick of two: the
draft step proposes k greedy tokens a slot (k + 1 single-token steps,
after rolling the draft's index to the verifier's accepted boundary),
and the VERIFY step (still counted as ``decode``) scores the pending
token and the k proposals in one masked (k+1)-token pass of the target,
samples its OWN token at each position j with draw ``draws + j`` (eos →
pad freezing per position), accepts the longest prefix of proposals
that matches, and advances ``draws``, ``tok``, ``done`` and the index by
``n_emit`` = 1 + matches. A speculative engine's streams are therefore
the plain engine's, greedy and sampled alike; proposals only decide how
many positions a tick keeps. A draft that raises falls back to null
proposals for that tick (``draft_fallbacks``): the verify step is right
for any proposals. The draft's sync operands (the pending token, the
accepted index) are the target's own device state: no host mirror.

**Prefix pages** (``prefix_pages`` > 0, ``kv_page_size``): a device page
pool (:mod:`dtf_tpu_torch.serve.pages`) and two more step functions with
their own ``page_trace_counts`` {save: 1, load: 1}: ``page_load``
gathers a pinned chain into a slot's leading positions (and deactivates
the slot), ``page_save`` scatters a slot's new full prompt pages out.
Under self-speculation (the draft is the target's architecture) a load
lands in the draft's cache too and the draft's prefill covers only the
tail.

The state lives on the engine's device and every step writes it IN
PLACE. Every operand of a step is a device tensor of a shape fixed at
construction (host values arrive through one host-to-device copy into a
fixed buffer), and a step makes no device-to-host sync: the host reads
back only the decode output and the first token after a last chunk —
what a CUDA graph of a step needs (none is captured yet). The engine is
dense, like the reference: its prefill is the chunked-prefill einsum and
its decode the grouped decode einsum, so it launches none of the hand
kernels.

**Weight hot-swap** (:meth:`DecodeEngine.swap_params`): a drained engine
takes new weights of the same architecture by rebinding its module's
parameters, with no step function built again; the version bump keys
new prefix pages apart from the old weights'. Over a mesh the swap is a
call of the plane that names a shard set every rank staged (each rank
rebinds its own shards: no parameter tensor crosses the group).

**Trace annotations** (``annotate_traces``): with it set, each prefill
chunk and decode step runs under a ``torch.profiler.record_function``
range named ``dtf.serve.prefill_chunk#slot=…,chunk=…,trace_id=…#`` or
``dtf.serve.decode#trace_ids=…#`` (the scheduler passes the ids), so a
profiler trace names the requests a step served. A host-side range only:
no sync, no extra launch.

**Sharded serving** (``mesh``, the reference's ``DecodeEngine(mesh=)``):
the engine of each rank holds its data line's ``n_slots / data`` slots
and, over the model group, its heads of the model (``GPT(mesh=)``, the
parameters this rank's blocks: :func:`dtf_tpu_torch.models.gpt.tp_shard`)
and of the KV cache, as the reference's cache is ``P('data', 'model')``;
the page pool holds the rank's heads of every page, whole on every data
line. Slot ``s`` lives on data line ``s // (n_slots / data)``. Every
device call goes through the call plane (:mod:`dtf_tpu_torch.serve.plane`):
rank 0's engine leads — the scheduler, the client and the prefix index
live there only — and every other rank's engine follows
(:meth:`DecodeEngine.follow`). A data line runs only the calls on its own
slots; a prefill's first token comes to every line in one broadcast
over the data group, a decode step's tokens in one all-gather, a saved
page in one broadcast; the sampled rows' logits are gathered whole over
the model group (:meth:`dtf_tpu_torch.models.gpt.GPT.vocab_rows`). Over
a mesh a failing draft step raises (its model group may have failed on
some ranks only, so no rank may fall back alone); a fault verb that
poisons the draft acts on the leader before the decode call
(:meth:`DecodeEngine.draft_guard`), and every rank then verifies null
proposals. A fleet of sharded engines (``weights_from`` /
``shared_pages`` with the same mesh and config) shares one plane, the
rank's shard tensors (by identity) and its page store.

Not yet ported: the tuner's ``spec_k = 0`` with a draft; it raises when
asked for.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
from typing import Optional, Sequence

import torch

from dtf_tpu_torch.core import comms
from dtf_tpu_torch.core.device import resolve_device
from dtf_tpu_torch.models import gpt
from dtf_tpu_torch.serve import pages as pages_lib
from dtf_tpu_torch.serve.plane import CallPlane

log = logging.getLogger("dtf_tpu_torch")

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
#: the page steps' int64 operand row: these scalars, then the page ids
#: (load: ``a`` = pages to load; save: the window [a, b) of new pages)
_PAGE_INTS = ("slot", "a", "b")


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
    first chunk): 0, or the tokens its loaded prefix pages cover; stale
    slot contents past it need no clearing — validity derives from the
    index."""
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

        last = model.vocab_rows(
            logits[0].index_select(0, one["n_valid"] - 1))        # [1, V]
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
        logits = model.vocab_rows(model(state["tok"][:, None],
                                        state["cache"],
                                        decode_active=active)[:, 0])  # [S, V]
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


def _build_draft_fn(model: gpt.GPT, k: int):
    """draft_all: k GREEDY proposals a slot — k + 1 single-token
    ``slot_decode`` steps of the draft model on its own cache. Greedy on
    purpose: the verifier prefix-matches them against its own samples, so
    they need no sampler. ``sync_index`` (the verifier's accepted
    boundary) first rolls every active row of the draft cache back, so
    last tick's rejected proposals are forgotten by index assignment,
    never by clearing. The LAST step ingests the k-th proposal (its
    output unused): on a clean sweep the verifier advances k + 1
    positions, and without it the draft cache would keep a never-written
    hole at idx + k behind its rolled-forward index."""
    def draft_fn(state: dict, tok: torch.Tensor,
                 sync_index: torch.Tensor) -> torch.Tensor:
        active = state["active"]
        gpt.cache_rollback(state["cache"], sync_index, active)
        cur, props = tok, []
        for _ in range(k + 1):
            logits = model.vocab_rows(model(cur[:, None], state["cache"],
                                            decode_active=active)[:, 0])
            cur = torch.argmax(logits, dim=-1)
            props.append(cur)
        return torch.stack(props[:k], dim=1)                   # [S, k]

    return draft_fn


def _build_verify_fn(model: gpt.GPT, k: int):
    """decode/verify: ONE (k+1)-token masked step across all slots, the
    speculative replacement of :func:`_build_decode_fn`. Inputs a row:
    the pending token and the k proposals. Position j's token is sampled
    with the row's stream at draw ``draws + j`` — what the j-th of n
    sequential decode steps would draw — and frozen to pad after eos as
    they would. Acceptance is a per-row prefix match of the proposals
    against those tokens: ``n_emit`` = 1 + the matching prefix (position
    j + 1's logits are only right when inputs 1..j were the emitted
    stream, which the prefix rule ensures; the + 1 is the verifier's own
    token: the correction on a mismatch, the bonus on a clean sweep).
    ``draws``, ``tok``, ``done`` and the cache index then stand where
    ``n_emit`` plain steps would have left them. Inactive rows emit 0 and
    keep everything. Returns [S, 2(k+1) + 1]: the k + 1 tokens, their
    done bits and ``n_emit``."""
    def verify_fn(state: dict, proposals: torch.Tensor) -> torch.Tensor:
        active = state["active"]
        n = active.shape[0]
        idx0 = gpt.cache_index_of(state["cache"]).clone()        # [S]
        inputs = torch.cat([state["tok"][:, None], proposals], dim=1)
        logits = model.vocab_rows(model(inputs, state["cache"],
                                        decode_active=active))

        def rows(x):                    # [S] -> [S * (k+1)], row-major
            return x[:, None].expand(n, k + 1).reshape(-1)

        draws = state["draws"][:, None] + torch.arange(k + 1,
                                                       device=active.device)
        sampled = gpt.sample_tokens(
            logits.reshape(n * (k + 1), -1), temperature=rows(state["temp"]),
            top_k=rows(state["top_k"]), top_p=rows(state["top_p"]),
            key=rows(state["key"]), draw=draws.reshape(-1)).view(n, k + 1)
        done = state["done"]
        toks, dones = [], []
        for j in range(k + 1):
            tkn = torch.where(done, state["pad"], sampled[:, j])
            done = done | ((state["eos"] >= 0) & (tkn == state["eos"]))
            toks.append(tkn)
            dones.append(done)
        toks, dones = torch.stack(toks, dim=1), torch.stack(dones, dim=1)
        match = torch.cumprod((toks[:, :k] == proposals).long(), dim=1)
        n_emit = torch.where(active, 1 + match.sum(dim=1),
                             torch.zeros_like(idx0))
        last = (n_emit.clamp_min(1) - 1)[:, None]
        gpt.cache_rollback(state["cache"], idx0 + n_emit, active)
        state["draws"].add_(n_emit)
        state["tok"].copy_(torch.where(active, toks.gather(1, last)[:, 0],
                                       state["tok"]))
        state["done"].copy_(torch.where(active, dones.gather(1, last)[:, 0],
                                        state["done"]))
        return torch.cat([toks, dones.long(), n_emit[:, None]], dim=1)

    return verify_fn


def _build_page_save_fn(n_pages: int):
    """page_save: one slot's NEW prompt pages — page j in [a, b) — to pool
    entries ``ids[j]``, in one step; pages outside the window are pointed
    at the id ``n_pages``, which :func:`gpt.cache_save_pages` drops."""
    def save_fn(state: dict, pool: list, ints: torch.Tensor) -> None:
        slot, lo, hi = ints[0:1], ints[1], ints[2]
        ids = ints[len(_PAGE_INTS):]
        j = torch.arange(ids.shape[0], device=ids.device)
        ids = torch.where((j >= lo) & (j < hi), ids,
                          torch.full_like(ids, n_pages))
        gpt.cache_save_pages(state["cache"], pool, slot, ids)

    return save_fn


def _build_page_load_fn():
    """page_load: a pinned chain (``ids[:a]``) into the leading positions
    of one slot — and DEACTIVATE the slot: a just-admitted slot still
    holds its previous occupant's ``active`` row, and a decode step before
    its first live chunk would write that request's K/V over the pages
    just landed."""
    def load_fn(state: dict, pool: list, ints: torch.Tensor) -> None:
        slot, n_valid = ints[0:1], ints[1]
        gpt.cache_load_pages(state["cache"], pool, slot,
                             ints[len(_PAGE_INTS):], n_valid)
        state["active"].index_fill_(0, slot, False)
        state["done"].index_fill_(0, slot, False)

    return load_fn


def _new_state(model: gpt.GPT, n_slots: int) -> dict:
    """A slot pool's device state: the model's cache at n_slots rows and
    the per-slot arrays of ``_SLOT_ARRAYS`` at their initial values."""
    state = {"cache": model.init_cache(n_slots)}
    for name, dtype, init in _SLOT_ARRAYS:
        state[name] = torch.full((n_slots,), init, dtype=dtype,
                                 device=model.device)
    return state


def _source_ids(params: dict) -> dict:
    """The identity of each input tensor of a state dict (``id``): what
    :func:`_load_model` compares to find the tensors two loads share."""
    return {n: id(x) for n, x in params.items()}


def _load_model(cfg: gpt.GPTConfig, params: dict, device,
                share=None, mesh=None) -> gpt.GPT:
    """``cfg``'s model on ``device`` with ``params``. ``share`` (a target
    model and the :func:`_source_ids` of the state dict it was loaded
    from): every tensor of ``params`` that IS one of the target's input
    tensors becomes the target model's own parameter, not a copy — a
    self-draft or an early-exit draft (:func:`gpt.draft_truncate`), or a
    router's further replica, costs no second set of weights. ``mesh``:
    the model over its model group, ``params`` this rank's blocks."""
    with torch.no_grad():
        model = gpt.GPT(cfg, device=device, mesh=mesh)
        model.load_state_dict(params)
        if share is not None:
            target, target_ids = share
            own = dict(target.named_parameters())
            same = {n: own[n] for n, x in params.items()
                    if n in own and target_ids.get(n) == id(x)}
            if same:
                model.load_state_dict(same, strict=False, assign=True)
    return model.eval()


def place_params(params: dict, device, memo: Optional[dict] = None
                 ) -> dict:
    """``params`` as parameters on ``device``: a parameter already there
    is taken as it is; any other tensor is moved there (no copy when it
    is there already) and wrapped. A tensor given under two names (or
    twice through one ``memo``) becomes ONE parameter, so an early-exit
    draft placed with its target shares the target's tensors."""
    memo = {} if memo is None else memo
    device = torch.device(device)
    out = {}
    for n, x in params.items():
        got = memo.get(id(x))
        if got is None:
            if isinstance(x, torch.nn.Parameter) and x.device == device:
                got = x
            else:
                got = torch.nn.Parameter(x.detach().to(device),
                                         requires_grad=False)
            memo[id(x)] = got
        out[n] = got
    return out


def _check_and_place(new: dict, served: dict, what: str, device,
                     memo: dict) -> dict:
    """Validate ``new`` against the served tensors (the same names, shapes
    and dtypes: anything else is a new engine, not a swap), then
    :func:`place_params`."""
    if set(new) != set(served):
        diff = sorted(set(new) ^ set(served))
        raise ValueError(
            f"swap_params: new {what} tree structure differs from the "
            f"served tree ({diff[:4]}) — hot-swap needs the SAME "
            "architecture (a different config is a new engine, not a swap)")
    for n, o in served.items():
        x = new[n]
        if tuple(x.shape) != tuple(o.shape) or x.dtype != o.dtype:
            raise ValueError(
                f"swap_params: {what} leaf {n!r} is {tuple(x.shape)}/"
                f"{x.dtype}, the served engine expects "
                f"{tuple(o.shape)}/{o.dtype}")
    return place_params({n: new[n] for n in served}, device, memo)


def _rebind(model: torch.nn.Module, params: dict) -> None:
    """Make each ``params[name]`` the module's own parameter ``name``."""
    for name, p in params.items():
        path, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(path), leaf, p)


def _same_mesh(a, b) -> bool:
    """Two engines on the same mesh: both unsharded, or the same axes and
    this rank's same place on them."""
    if a is None or b is None:
        return a is b
    return all(getattr(a, f) == getattr(b, f) for f in (
        "data_size", "model_size", "data_index", "model_index"))


def _shard_placed(params: dict, draft: Optional[dict], mesh
                  ) -> tuple[dict, Optional[dict]]:
    """This rank's shards of whole ``params`` and ``draft``
    (:func:`gpt.tp_shard`), a tensor the two share sharded once, so the
    draft's shards stay the target's tensors."""
    shards = gpt.tp_shard(params, mesh)
    by_source = {id(x): shards[n] for n, x in params.items()}
    if draft is not None:
        rest = gpt.tp_shard({n: x for n, x in draft.items()
                             if id(x) not in by_source}, mesh)
        draft = {n: by_source.get(id(x), rest.get(n))
                 for n, x in draft.items()}
    return shards, draft


class DecodeEngine:
    """Slot-pooled online decode over a GPT's parameters.

    ``cfg`` is the TRAINED architecture (the decode fields are set here);
    ``params`` its state dict (``convert.params_from_flax`` of a flax
    tree, or ``Checkpointer.restore_params``). ``max_len`` sizes each
    slot's KV cache (prompt + generated tokens of a request must fit),
    ``n_slots`` the pool of concurrent requests, ``prefill_chunk`` the
    fixed width of the prefill step (>= 2: a 1-token call is a decode
    step). ``prefix_pages`` / ``kv_page_size`` / ``page_save_after``
    size the prefix page pool (``shared_pages``: another engine's
    ``page_store`` to mount instead); ``draft_cfg`` / ``draft_params`` /
    ``spec_k`` turn on speculative decoding. ``weights_from``: another
    engine built from the same ``params`` tensors — this engine's model
    takes that engine's parameters instead of a copy (a router's
    replicas: N KV caches, one set of weights). ``device``: ``cuda``
    unless asked for the CPU; without a GPU asking for ``cuda`` raises.
    ``mesh``: sharded serving (module docstring) — ``params`` and
    ``draft_params`` are this rank's blocks, and every rank builds its
    engine; rank 0's leads (:meth:`leading`), the others
    :meth:`follow`. Over a mesh ``weights_from`` and ``shared_pages``
    must come from an engine of the same mesh (and config), and the new
    engine joins its call plane: a fleet is one plane a rank.
    """

    def __init__(self, cfg: gpt.GPTConfig, params, *, n_slots: int,
                 max_len: int, prefill_chunk: int = 16, device="cuda",
                 mesh=None, kv_page_size: int = 0, prefix_pages: int = 0,
                 page_save_after: int = 2,
                 draft_cfg: Optional[gpt.GPTConfig] = None,
                 draft_params=None, spec_k: int = 0, shared_pages=None,
                 weights_from: Optional["DecodeEngine"] = None):
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
        if prefix_pages:
            if kv_page_size < 1:
                raise ValueError(
                    f"prefix_pages={prefix_pages} needs kv_page_size >= 1 "
                    f"(got {kv_page_size})")
            if max_len % kv_page_size:
                raise ValueError(
                    f"kv_page_size={kv_page_size} does not divide the "
                    f"cache length max_len={max_len}: a page window "
                    "crossing the cache end cannot be copied fixed-shape")
            if cfg.attn_window:
                raise ValueError(
                    f"the prefix page cache needs the plain slot=position "
                    f"cache layout; attn_window={cfg.attn_window} rolls "
                    "the buffer so page windows alias arbitrary positions")
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
        if spec_k < 0:
            raise ValueError(f"spec_k={spec_k} must be >= 0")
        if spec_k and draft_cfg is None:
            raise ValueError(
                f"spec_k={spec_k} needs a draft model: pass draft_cfg + "
                "draft_params (speculation verifies a second model's "
                "proposals — there is nothing to verify without one)")
        dbase = None
        if draft_cfg is not None:
            if draft_params is None:
                raise ValueError("draft_cfg without draft_params")
            if base.attn_window or draft_cfg.attn_window:
                raise ValueError(
                    "speculative decoding needs the full windowless cache "
                    "layout on BOTH models (rolled buffers cannot roll a "
                    f"rejected tail back); got attn_window="
                    f"{base.attn_window}/{draft_cfg.attn_window}")
            if draft_cfg.vocab_size != base.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{base.vocab_size}: a draft must propose in the "
                    "verifier's token space")
            if spec_k == 0:
                raise NotImplementedError(
                    "spec_k=0 with a draft (the kernel tuner picks the "
                    "draft width) is not yet ported (tune/); pass spec_k "
                    ">= 1")
            if spec_k + 1 >= max_len:
                raise ValueError(
                    f"spec_k={spec_k} leaves no room in the "
                    f"max_len={max_len} cache for a verify window")
            dbase = dataclasses.replace(draft_cfg, decode_len=max_len,
                                        slot_decode=False,
                                        chunked_prefill=False)
        if shared_pages is not None and not prefix_pages:
            raise ValueError(
                "shared_pages needs prefix_pages > 0 on the mounting "
                "engine too (the pool shapes come from its own config)")
        if mesh is not None and n_slots % mesh.data_size:
            raise ValueError(
                f"n_slots={n_slots} not divisible by the data axis "
                f"({mesh.data_size}) — slots shard over 'data'")
        for other, what in ((weights_from, "weights_from="),
                            (shared_pages, "shared_pages=")):
            if other is not None and not _same_mesh(
                    getattr(other, "mesh", None), mesh):
                raise ValueError(
                    f"{what} belongs to an engine of another mesh: a fleet "
                    "shares one mesh (and, over it, one call plane)")
        self.cfg = base
        self.mesh = mesh
        #: the slots this rank's data line holds (all without a mesh)
        self._slots_here = n_slots // (mesh.data_size if mesh else 1)
        #: over a mesh, the fleet's one call plane on this rank: the one
        #: of the engine whose weights or pages this one shares, else new
        self._plane = None
        if mesh is not None:
            joined = [o.plane if o is shared_pages else o._plane
                      for o in (weights_from, shared_pages) if o is not None]
            if any(p is not joined[0] for p in joined):
                raise ValueError("weights_from= and shared_pages= sit on two "
                                 "call planes: a fleet has one")
            self._plane = (joined[0] if joined
                           else CallPlane(torch.distributed.get_rank()))
            #: this engine's index on the plane (the same on every rank)
            self._index = self._plane.join(self)
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.page_size = kv_page_size if prefix_pages else 0
        self.n_pages = prefix_pages
        self.spec_k = spec_k if dbase is not None else 0
        self.draft_cfg = dbase
        self.device = resolve_device(device)
        #: host-side call counters (plain ints, no device readback)
        self.counters = {"prefill_chunks": 0, "decode_steps": 0,
                         "pages_loaded": 0, "pages_saved": 0,
                         "prefix_hit_tokens": 0, "prefix_miss_tokens": 0,
                         "probe_decodes": 0, "param_swaps": 0}
        #: the version of the weights served: 0 as constructed,
        #: :meth:`set_param_version` or a swap moves it (the scheduler
        #: stamps it into every completed record; prefix pages are keyed
        #: by it)
        self.param_version = 0
        #: request trace ids on the step calls (module docstring); the
        #: scheduler passes them only when this is set
        self.annotate_traces = False

        if weights_from is not None and weights_from.cfg != base:
            raise ValueError("weights_from= is an engine of another "
                             "architecture")
        self._source = _source_ids(params)
        self._model = _load_model(
            dataclasses.replace(base, slot_decode=True), params, self.device,
            share=None if weights_from is None
            else (weights_from._model, weights_from._source), mesh=mesh)
        if mesh is not None:
            gpt.check_decode_mesh(self._model, mesh)
        self._state = _new_state(self._model, self._slots_here)
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
        if self.spec_k:
            self._decode_fn = _build_verify_fn(self._model, self.spec_k)
        else:
            self._decode_fn = _build_decode_fn(self._model)
        self.trace_counts["decode"] += 1

        if self.spec_k:
            self.counters.update({"draft_steps": 0,
                                  "draft_prefill_chunks": 0,
                                  "draft_fallbacks": 0,
                                  "spec_proposed": 0, "spec_accepted": 0})
            self._draft_model = _load_model(
                dataclasses.replace(dbase, slot_decode=True), draft_params,
                self.device, share=(self._model, self._source), mesh=mesh)
            self._draft_state = _new_state(self._draft_model,
                                           self._slots_here)
            self.trace_counts.update({"draft_prefill": 0, "draft": 0})
            self._draft_prefill_fn = _build_prefill_fn(self._draft_model)
            self.trace_counts["draft_prefill"] += 1
            self._draft_fn = _build_draft_fn(self._draft_model, self.spec_k)
            self.trace_counts["draft"] += 1
            #: the proposals of a tick whose draft step raised
            self._null_props = torch.zeros(self._slots_here, self.spec_k,
                                           dtype=torch.long,
                                           device=self.device)
            #: host bookkeeping of each slot's draft prefill: chunks run,
            #: the position it starts at, and a page load's staged start
            self._draft_chunks = [0] * n_slots
            self._draft_start = [0] * n_slots
            self._draft_pending = [0] * n_slots
            #: SELF-speculation (the draft is the target's architecture):
            #: the draft cache has the target's layout, so a prefix-page
            #: load lands there too and the draft prefills only the tail
            self._draft_self = dbase == base
            if self._draft_self:
                self.counters["draft_pages_loaded"] = 0

        self._page_store = None
        self._owns_pages = False
        self.page_trace_counts = {}
        if prefix_pages:
            pool_abs = pages_lib.pool_abstract(self._state["cache"],
                                               prefix_pages, kv_page_size)
            if shared_pages is not None:
                pages_lib.check_pool_compatible(shared_pages.pool, pool_abs)
                if (shared_pages.index.n_pages != prefix_pages
                        or shared_pages.index.page_size != kv_page_size):
                    raise ValueError(
                        f"shared page store is {shared_pages.index.n_pages}"
                        f"x{shared_pages.index.page_size}-token pages; "
                        f"this engine asked for {prefix_pages}"
                        f"x{kv_page_size}")
                self._page_store = shared_pages
            else:
                pool = [{n: torch.zeros(x.shape, dtype=x.dtype,
                                        device=self.device)
                         for n, x in layer.items()} for layer in pool_abs]
                self._page_store = pages_lib.PageStore(
                    pool, pages_lib.PrefixIndex(prefix_pages, kv_page_size,
                                                save_after=page_save_after),
                    mesh=mesh, plane=self._plane)
                self._owns_pages = True
            self._page_ints = torch.zeros(
                len(_PAGE_INTS) + max_len // kv_page_size, dtype=torch.long,
                device=self.device)
            self.page_trace_counts = {"save": 0, "load": 0}
            self._page_save_fn = _build_page_save_fn(prefix_pages)
            self.page_trace_counts["save"] += 1
            self._page_load_fn = _build_page_load_fn()
            self.page_trace_counts["load"] += 1

    # ------------------------------------------------------------- host API

    def _annotation(self, name: str, **ids):
        """A ``torch.profiler.record_function`` range carrying the request
        trace ids (``annotate_traces``), named as the JAX engine's
        annotation renders (``name#k=v,…#``); a null context otherwise.
        Host side only: it reads no device value."""
        if not self.annotate_traces:
            return contextlib.nullcontext()
        args = ",".join(f"{k}={v}" for k, v in ids.items())
        return torch.profiler.record_function(f"{name}#{args}#")

    # -------------------------------------------------- weight hot-swap

    @property
    def params(self) -> dict:
        """The served parameters, ``{state_dict name: tensor}``: the model
        module's own tensors (a fleet's replicas hold the same ones)."""
        return dict(self._model.named_parameters())

    @property
    def draft_params(self) -> Optional[dict]:
        """The draft model's parameters (None without a draft); a
        self-draft's or an early-exit draft's are the target's tensors."""
        if not self.spec_k:
            return None
        return dict(self._draft_model.named_parameters())

    def place(self, params: dict, draft_params: Optional[dict] = None
              ) -> tuple[dict, Optional[dict]]:
        """``(params, draft_params)`` placed on this engine's device once
        (:func:`place_params`, one memo: a draft's tensors shared with
        ``params`` stay shared) — what a router hands every replica of a
        swap, so the fleet holds one set of each version. Over a mesh
        ``params`` and ``draft_params`` are WHOLE (host) tensors and come
        back as this rank's shards (:func:`gpt.tp_shard`); a draft cut
        from ``params`` keeps sharing its shards."""
        if self.mesh is not None:
            params, draft_params = _shard_placed(params, draft_params,
                                                 self.mesh)
        memo: dict = {}
        placed = place_params(params, self.device, memo)
        return placed, (None if draft_params is None
                        else place_params(draft_params, self.device, memo))

    def set_param_version(self, version: int) -> None:
        """Stamp the version of the weights this engine was BUILT with
        (serving a published version from the start): no swap, no
        counter. Call it before traffic, so records and page epochs carry
        the real version."""
        self.param_version = int(version)

    def swap_params(self, params: dict, *, draft_params=None,
                    version: Optional[int] = None) -> int:
        """Hot-swap the served weights: no step function is built again
        (``trace_counts`` stays pinned).

        ``params`` (``{state_dict name: tensor}``) must be drop-in for the
        served ones: the same names, shapes and dtypes, or ``ValueError``
        names the first offence. Tensors on another device are copied to
        the engine's (:func:`place_params`); tensors already there are
        taken as they are, not copied — the caller hands them over and
        must not write them afterwards.

        **The swap REBINDS, it does not copy.** The model module's
        parameters are replaced by the new tensor objects. A fleet's
        replicas share one set of tensors (``weights_from``), so a
        ``copy_`` into them would flip every replica at once, with no
        canary, no rollback, and mixed versions mid-stream on replicas
        that have not drained; rebinding one replica's module leaves the
        others on their set. The step closures hold the module, not its
        tensors, so they stay valid. The router places one set per
        version and hands the same set to every replica it swaps: after a
        roll the fleet again holds one set, during it at most two. A
        CUDA graph of a step would capture the tensors' addresses: after
        a swap it has to be captured again.

        Caller contract (the router's rolling swap keeps it): the engine
        is drained, no request queued, admitting or running; a stale slot
        needs no cleanup (an admitted request fully resets its slot), and
        the bump of the version makes every prefix page of the old
        weights unreachable from this engine.

        With a draft, target, draft and version swap as one transaction:
        ``draft_params`` swaps the draft explicitly (tensors it shares by
        identity with ``params`` stay shared); otherwise a self-draft, or
        an early-exit draft (:func:`gpt.draft_truncate`), takes the new
        target tensors it shared before, and a distinct draft keeps its
        old weights (logged: acceptance may move, the streams cannot,
        since the verifier samples every delivered token).

        ``version`` stamps :attr:`param_version` (default: the previous
        + 1). Returns the new version.

        Over a mesh (the leader): ``params`` and ``draft_params`` are this
        rank's shard sets as staged on every rank
        (:class:`~dtf_tpu_torch.serve.plane.ShardSets`, what
        ``Router.start_swap`` stages); the call names them by key and
        every rank rebinds its own shards of them, and the version moves
        on every rank together."""
        version = (self.param_version + 1 if version is None
                   else int(version))
        if self.mesh is None:
            return self._swap_here(params, draft_params, version)
        # checked here first: a tree that is not drop-in raises before the
        # call is announced
        self._placed_for_swap(params, draft_params)
        sets = self._plane.sets
        return self._call("swap", sets.key_of(params),
                          None if draft_params is None
                          else sets.key_of(draft_params), version)

    def _op_swap(self, key, draft_key, version: int) -> int:
        sets = self._plane.sets
        return self._swap_here(
            sets.get(key), None if draft_key is None else sets.get(draft_key),
            version)

    def _placed_for_swap(self, params: dict, draft_params
                         ) -> tuple[dict, Optional[dict]]:
        """The swap's target and draft sets, checked against the served
        ones and placed (:func:`_check_and_place`)."""
        memo: dict = {}
        served = self.params
        placed = _check_and_place(params, served, "params", self.device,
                                  memo)
        placed_draft = None
        if self.spec_k:
            dserved = self.draft_params
            if draft_params is not None:
                placed_draft = _check_and_place(draft_params, dserved,
                                                "draft_params", self.device,
                                                memo)
            else:
                shared = [n for n, p in dserved.items()
                          if served.get(n) is p]
                if shared:
                    placed_draft = {**dserved,
                                    **{n: placed[n] for n in shared}}
                if len(shared) < len(dserved):
                    log.info(
                        "swap_params: the draft keeps its previous weights "
                        "for %d of %d tensors (no draft_params passed) — "
                        "acceptance may move, the streams cannot",
                        len(dserved) - len(shared), len(dserved))
        return placed, placed_draft

    def _swap_here(self, params: dict, draft_params, version: int) -> int:
        placed, placed_draft = self._placed_for_swap(params, draft_params)
        # THE transaction: target, draft and version flip together,
        # between step calls (the pump is single-threaded)
        _rebind(self._model, placed)
        if placed_draft is not None:
            _rebind(self._draft_model, placed_draft)
        self.param_version = version
        self.counters["param_swaps"] += 1
        return self.param_version

    @property
    def state(self) -> dict:
        """The engine's device state (the slot cache and the per-slot
        rows; over a mesh this line's slots and this rank's heads), for
        inspection; the steps write it in place."""
        return self._state

    @property
    def draft_state(self) -> Optional[dict]:
        """The draft model's slot state (None without a draft)."""
        return self._draft_state if self.spec_k else None

    @property
    def page_store(self) -> Optional[pages_lib.PageStore]:
        """The engine's mountable prefix-page state (None with the pool
        off): pass it as ``shared_pages=`` to further engines to share one
        pool and index."""
        return self._page_store

    @property
    def _prefix(self) -> Optional[pages_lib.PrefixIndex]:
        return None if self._page_store is None else self._page_store.index

    # ------------------------------------------------------ the call plane

    @property
    def is_leader(self) -> bool:
        """True where this engine makes the calls: always without a mesh,
        on the world's rank 0 with one."""
        return self._plane is None or self._plane.is_leader

    def leading(self):
        """The leader's serving body (a context manager): on leaving it
        the followers are stopped, ``ok`` unless it raised
        (:meth:`CallPlane.leading`); a null context without a mesh."""
        if self._plane is None:
            return contextlib.nullcontext(self)
        return self._plane.leading()

    @property
    def plane(self):
        """The fleet's call plane on this rank (None without a mesh)."""
        return self._plane

    def follow(self) -> bool:
        """A follower rank of a sharded engine: run the leader's calls on
        this rank's engines of the plane until its stop; returns whether
        it stopped cleanly."""
        if self._plane is None:
            raise RuntimeError("follow() is for the ranks of a sharded "
                               "engine (mesh=)")
        return self._plane.follow()

    def _run_op(self, op: str, args: tuple):
        return getattr(self, f"_op_{op}")(*args)

    def _call(self, op: str, *args):
        """Device call ``op``: here without a mesh; over one, announced to
        every rank first (the leader only), addressed to this engine's
        index on the plane."""
        if self._plane is None:
            return self._run_op(op, args)
        return self._plane.call(self._index, self._run_op, op, args)

    @property
    def _data_split(self) -> bool:
        return self.mesh is not None and self.mesh.data_size > 1

    def _line_of(self, slot: int) -> int:
        """The data line that holds ``slot``."""
        return slot // self._slots_here

    def _owns(self, slot: int) -> bool:
        return self.mesh is None or self._line_of(slot) == \
            self.mesh.data_index

    def _gather_slots(self, out: torch.Tensor, dim: int) -> torch.Tensor:
        """A step's per-slot output, this line's slots along ``dim`` →
        every slot's (one all-gather over the data group)."""
        if not self._data_split:
            return out
        whole = comms.gather_rows(out.movedim(dim, 0), self.mesh.data_group)
        return whole.movedim(0, dim)

    def n_chunks(self, prompt_len: int) -> int:
        return math.ceil(prompt_len / self.prefill_chunk)

    def _stage(self, dst: torch.Tensor, values) -> None:
        """Copy host values into a fixed device buffer without a host
        sync: through a pinned buffer on CUDA (the caching host allocator
        holds it until the copy has run)."""
        src = torch.tensor(values, dtype=dst.dtype,
                           pin_memory=dst.is_cuda)
        dst.copy_(src, non_blocking=True)

    def _run_prefill(self, fn, state: dict, slot: int, tail: list,
                     chunk_i: int, start: int, is_last: bool,
                     sampling: tuple) -> Optional[torch.Tensor]:
        """One chunk of ``tail`` (the prompt past ``start``) through the
        prefill step ``fn`` on ``state``; None on a data line that does
        not hold ``slot``."""
        if not self._owns(slot):
            return None
        c = self.prefill_chunk
        seg = tail[chunk_i * c:(chunk_i + 1) * c]
        temperature, top_k, top_p, eos_id, pad_id, seed = sampling
        ints = [slot % self._slots_here, start, len(seg), int(chunk_i == 0),
                int(is_last), top_k, -1 if eos_id is None else eos_id,
                pad_id, seed]
        self._stage(self._ints, ints + seg + [0] * (c - len(seg)))
        self._stage(self._floats, [temperature, top_p])
        with torch.no_grad():
            return fn(state, self._ints, self._floats)

    def prefill_into_slot(self, slot: int, prompt: Sequence[int],
                          chunk_i: int, *, start: int = 0,
                          temperature: float = 0.0, top_k: int = 0,
                          top_p: float = 1.0, eos_id: Optional[int] = None,
                          pad_id: int = 0, seed: int = 0) -> torch.Tensor:
        """Run chunk ``chunk_i`` of ``prompt[start:]`` into ``slot`` (the
        first ``start`` tokens are in the slot's cache already: loaded
        prefix pages) and return the step's device output ``[token,
        done]`` (meaningful on the last chunk) — no device-to-host sync.
        With a draft, the draft's prefill rides along: one draft chunk
        with each target chunk, the rest with the last one, so both
        models' slots turn active in the same call.
        :meth:`prefill_chunk_into` is the host API around it."""
        prompt = [int(t) for t in prompt]
        if not 1 <= len(prompt) <= self.max_len - 1:
            raise ValueError(
                f"prompt length {len(prompt)} must be in [1, "
                f"{self.max_len - 1}] (max_len={self.max_len} covers "
                "prompt + generated tokens)")
        if not 0 <= start < len(prompt):
            raise ValueError(
                f"start={start} must be in [0, {len(prompt)}) — at least "
                "one prompt token must prefill live (the request's first "
                "sampled token comes from the last position's logits)")
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        n = self.n_chunks(len(prompt) - start)
        if not 0 <= chunk_i < n:
            raise ValueError(f"chunk {chunk_i} out of range [0, {n})")
        return self._call("prefill", slot, prompt, chunk_i, start,
                          (temperature, top_k, top_p, eos_id, pad_id, seed))

    def _op_prefill(self, slot: int, prompt: list, chunk_i: int, start: int,
                    sampling: tuple) -> torch.Tensor:
        last = chunk_i == self.n_chunks(len(prompt) - start) - 1
        out = self._run_prefill(self._prefill_fn, self._state, slot,
                                prompt[start:], chunk_i, start, last,
                                sampling)
        self.counters["prefill_chunks"] += 1
        if self.spec_k:
            if chunk_i == 0:
                self._draft_chunks[slot] = 0
                # a page load just before this admission shortcuts the
                # draft too (self-speculation; load_prefix staged it)
                self._draft_start[slot] = self._draft_pending[slot]
                self._draft_pending[slot] = 0
            dstart = self._draft_start[slot]
            n_d = self.n_chunks(len(prompt) - dstart)
            todo = n_d if last else min(n_d, self._draft_chunks[slot] + 1)
            while self._draft_chunks[slot] < todo:
                self._draft_prefill_chunk(slot, prompt, dstart, n_d)
        if self._data_split:
            # the first token, from the slot's line to every line
            if out is None:
                out = torch.zeros(2, dtype=torch.long, device=self.device)
            comms.broadcast_from(out, self.mesh.data_group,
                                 self._line_of(slot))
        return out

    def _draft_prefill_chunk(self, slot: int, prompt: list, start: int,
                             n_d: int) -> None:
        """The next chunk of the DRAFT's prefill of ``prompt[start:]``
        into ``slot``, greedy (the sampled first token is discarded: the
        request's stream belongs to the verifier alone)."""
        i = self._draft_chunks[slot]
        self._run_prefill(self._draft_prefill_fn, self._draft_state, slot,
                          prompt[start:], i, start, i == n_d - 1,
                          (0.0, 0, 1.0, None, 0, 0))
        self.counters["draft_prefill_chunks"] += 1
        self._draft_chunks[slot] = i + 1

    def prefill_chunk_into(self, slot: int, prompt: Sequence[int],
                           chunk_i: int, *, start: int = 0,
                           temperature: float = 0.0, top_k: int = 0,
                           top_p: float = 1.0, eos_id: Optional[int] = None,
                           pad_id: int = 0, seed: int = 0,
                           trace_id: Optional[int] = None
                           ) -> Optional[tuple[int, bool]]:
        """Run prompt chunk ``chunk_i`` of a request into ``slot`` — the
        scheduler's prefill/decode interleave granularity (decode_all may
        run between chunks; the slot stays a masked spectator until its
        last chunk lands). Chunks cover ``prompt[start:]``. Returns
        ``(first_token, done)`` on the last chunk (the one readback), None
        before. ``trace_id`` names the request in the annotation."""
        with self._annotation("dtf.serve.prefill_chunk", slot=slot,
                              chunk=chunk_i,
                              trace_id=-1 if trace_id is None else trace_id):
            out = self.prefill_into_slot(
                slot, prompt, chunk_i, start=start, temperature=temperature,
                top_k=top_k, top_p=top_p, eos_id=eos_id, pad_id=pad_id,
                seed=seed)
            if chunk_i != self.n_chunks(len(prompt) - start) - 1:
                return None
            tok, done = out.tolist()
        return int(tok), bool(done)

    def prefill(self, slot: int, prompt: Sequence[int], *, start: int = 0,
                **sampling) -> tuple[int, bool]:
        """Admit a request into ``slot``: stream its whole prompt (less
        ``start`` page-loaded tokens) through the chunk step and sample
        the first token. Returns ``(first_token, done)``."""
        n = self.n_chunks(len(prompt) - start)
        if n <= 0:
            raise ValueError(
                f"prompt length {len(prompt)} must be in [1, "
                f"{self.max_len - 1}] with start={start} below it")
        out = None
        for i in range(n):
            out = self.prefill_chunk_into(slot, prompt, i, start=start,
                                          **sampling)
        return out

    def draft_propose(self) -> torch.Tensor:
        """One draft step: k greedy proposals a slot [S, k] off the draft
        model's cache, rolled first to the verifier's accepted boundary
        (the target's index, read on the device). Split out of
        :meth:`decode_all` so a caller can wrap it: a failing draft falls
        back to null proposals, it does not fail requests."""
        return self._call("draft")

    def _draft_here(self) -> torch.Tensor:
        """The draft step on this line's slots: [slots here, k]."""
        with torch.no_grad():
            props = self._draft_fn(self._draft_state, self._state["tok"],
                                   gpt.cache_index_of(self._state["cache"]))
        self.counters["draft_steps"] += 1
        return props

    def _op_draft(self) -> torch.Tensor:
        return self._gather_slots(self._draft_here(), 0)

    def draft_guard(self) -> None:
        """Over a mesh, what the leader runs before a speculative decode
        call is announced: a no-op that a fault verb may make raise
        (``poison_draft``), and then every rank verifies null proposals
        that step — the fallback of :meth:`draft_propose`, decided where
        every rank learns it."""

    def decode_all(self) -> torch.Tensor:
        """One masked step across all slots; returns its device output —
        no device-to-host sync. Without a draft: [2, n_slots] (tokens,
        done). With ``spec_k`` = k: the draft step, then the verify step:
        [n_slots, 2(k+1) + 1] (k + 1 tokens, their done bits, n_emit)."""
        if not (self.spec_k and self.mesh is not None):
            return self._call("decode")
        try:
            self.draft_guard()
            null = False
        except Exception as e:  # noqa: BLE001 — as draft_propose's
            # fallback, decided on the leader before the call
            log.warning("draft step failed (%r); null proposals this "
                        "tick", e, exc_info=True)
            self.counters["draft_fallbacks"] += 1
            null = True
        return self._call("decode", null)

    def _op_decode(self, null: bool = False) -> torch.Tensor:
        if not self.spec_k:
            with torch.no_grad():
                out = self._decode_fn(self._state)
            self.counters["decode_steps"] += 1
            return self._gather_slots(out, 1)
        if self.mesh is not None:
            # over a mesh a draft failure raises: its model group may have
            # failed on some ranks only, and no rank may fall back alone
            props = self._null_props if null else self._draft_here()
            return self._gather_slots(self._verify_here(props), 0)
        try:
            props = self.draft_propose()
        except Exception as e:  # noqa: BLE001 — the verify step is
            # right for any proposals (at worst it emits one token,
            # plain decode): a draft failure must not fail requests
            log.warning("draft step failed (%r); null proposals this "
                        "tick", e, exc_info=True)
            self.counters["draft_fallbacks"] += 1
            props = self._null_props
        return self._verify_here(props)

    def verify_all(self, proposals: torch.Tensor) -> torch.Tensor:
        """The verify step alone (``spec_k`` > 0) on device proposals [S,
        k]: [n_slots, 2(k+1) + 1] — k + 1 tokens, their done bits, n_emit;
        no device-to-host sync without a mesh (over one the proposals
        travel with the call, as host values)."""
        if self.mesh is not None:
            proposals = proposals.tolist()
        return self._call("verify", proposals)

    def _op_verify(self, proposals) -> torch.Tensor:
        if self.mesh is not None:
            lo = self.mesh.data_index * self._slots_here
            proposals = torch.tensor(
                proposals[lo:lo + self._slots_here], dtype=torch.long,
                device=self.device)
        return self._gather_slots(self._verify_here(proposals), 0)

    def _verify_here(self, proposals: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            out = self._decode_fn(self._state, proposals)
        self.counters["decode_steps"] += 1
        return out

    def decode(self, *, trace_ids: Optional[Sequence[int]] = None):
        """One masked step across all slots as host arrays — the one
        device-to-host sync a tick (eos and delivery decisions live on
        the host). Without a draft: ``(tokens [n_slots], done
        [n_slots])``. With ``spec_k`` = k: ``(tokens [n_slots, k+1], done
        [n_slots, k+1], n_emit [n_slots])``; the scheduler delivers
        ``tokens[s, :n_emit[s]]``. ``trace_ids`` names the requests the
        step serves in the annotation."""
        with self._annotation(
                "dtf.serve.decode",
                trace_ids="" if trace_ids is None
                else ",".join(map(str, trace_ids))):
            out = self.decode_all().cpu().numpy()
        if not self.spec_k:
            return out[0], out[1].astype(bool)
        k1 = self.spec_k + 1
        toks, dones, n_emit = out[:, :k1], out[:, k1:2 * k1], out[:, -1]
        live = n_emit > 0
        self.counters["spec_proposed"] += int(self.spec_k * live.sum())
        self.counters["spec_accepted"] += int((n_emit[live] - 1).sum())
        return toks, dones.astype(bool), n_emit

    def probe(self) -> None:
        """One decode step with the outputs discarded (the router's health
        probe). Stale slots advance like any other masked step, which is
        safe: an admitted request fully reinitializes its slot."""
        self.decode()
        self.counters["probe_decodes"] += 1

    # ----------------------------------------------------- prefix page API

    def prefix_match(self, prompt: Sequence[int]):
        """The admission lookup: the longest cached page chain matching a
        prefix of ``prompt`` at this engine's param version, PINNED until
        :meth:`release_prefix`. None on a miss or with the pool off."""
        if self._prefix is None:
            return None
        prompt = tuple(int(t) for t in prompt)
        h = self._prefix.acquire(prompt, epoch=self.param_version)
        if h is None:
            self.counters["prefix_miss_tokens"] += len(prompt)
        else:
            self.counters["prefix_hit_tokens"] += h.n_tokens
            self.counters["prefix_miss_tokens"] += len(prompt) - h.n_tokens
        return h

    def _run_page(self, fn, state: dict, slot: int, a: int, b: int,
                  ids: Sequence[int]) -> None:
        """One page step on ``slot``'s line (nothing elsewhere); the slot
        staged as this line's."""
        if not self._owns(slot):
            return
        m = self.max_len // self.page_size
        self._stage(self._page_ints, [slot % self._slots_here, a, b]
                    + list(ids) + [0] * (m - len(ids)))
        with torch.no_grad():
            fn(state, self._page_store.pool, self._page_ints)

    def load_prefix(self, slot: int, handle) -> None:
        """Gather a pinned chain's pages into ``slot``'s leading positions
        — one page-load step for the whole chain, in place of
        ``n_tokens / prefill_chunk`` prefill chunks."""
        self._call("page_load", slot, [e.page_id for e in handle.entries],
                   handle.n_tokens)

    def _op_page_load(self, slot: int, ids: list, n_tokens: int) -> None:
        self._run_page(self._page_load_fn, self._state, slot, len(ids), 0,
                       ids)
        self.counters["pages_loaded"] += len(ids)
        if self.spec_k and self._draft_self:
            # self-speculation: the draft's cache has the target's layout,
            # so the same step lands the chain there and the draft's
            # prefill covers only the uncached tail, as the target's
            self._run_page(self._page_load_fn, self._draft_state, slot,
                           len(ids), 0, ids)
            self._draft_pending[slot] = n_tokens
            self.counters["draft_pages_loaded"] += len(ids)

    def save_prefix_pages(self, slot: int, prompt: Sequence[int]) -> None:
        """After a request's LAST prefill chunk: register every full page
        of its prompt that is not yet in the pool and has passed the
        save-admission filter, and copy them out of the slot — one step
        however many pages are new. Stops quietly when the pool is all
        pinned or parented: saving never blocks."""
        if self._prefix is None:
            return
        prompt = tuple(int(t) for t in prompt)
        epoch = self.param_version
        full = len(prompt) // self.page_size
        have, parent = self._prefix.longest(prompt, cap=full, epoch=epoch)
        full = have + self._prefix.save_eligible(prompt, have, full,
                                                 epoch=epoch)
        ids = []
        for i in range(have, full):
            ent = self._prefix.reserve(prompt[:(i + 1) * self.page_size],
                                       parent, epoch=epoch)
            if ent is None:
                break
            ids.append(ent.page_id)
            parent = ent
        if not ids:
            return
        self._call("page_save", slot, have, ids)

    def _op_page_save(self, slot: int, have: int, ids: list) -> None:
        self._run_page(self._page_save_fn, self._state, slot, have,
                       have + len(ids), [0] * have + ids)
        if self._data_split:
            self._share_pages(ids, self._line_of(slot))
        self.counters["pages_saved"] += len(ids)

    def _share_pages(self, ids: list, line: int) -> None:
        """Pool pages ``ids`` of data line ``line`` onto every line's pool
        (one broadcast over the data group, every leaf's bytes in one
        buffer): the pool is whole on each line, as the one index on the
        leader assumes."""
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        leaves = [x for layer in self._page_store.pool
                  for x in layer.values()]
        parts = [x.index_select(0, idx).contiguous().view(torch.uint8)
                 .reshape(-1) for x in leaves]
        flat = comms.broadcast_from(torch.cat(parts), self.mesh.data_group,
                                    line)
        for x, piece in zip(leaves, flat.split([p.numel() for p in parts])):
            x.index_copy_(0, idx, piece.view(x.dtype).reshape(
                (len(ids),) + tuple(x.shape[1:])))

    def release_prefix(self, handle) -> None:
        """Unpin an admission chain (exactly once, on slot evict)."""
        if handle is not None:
            self._prefix.release(handle)

    def warm_page_programs(self) -> None:
        """Run both page steps once with no-op operands (a 0-page load into
        slot 0, an empty save window), so their first-call costs land
        outside a timed window; call it before traffic. No cache row or
        pool page changes (the load deactivates slot 0, as every load
        does its slot). No-op with the pool off."""
        if self._prefix is None:
            return
        self._call("page_warm")

    def _op_page_warm(self) -> None:
        # every line warms its own first slot
        first = (self.mesh.data_index * self._slots_here
                 if self.mesh is not None else 0)
        self._run_page(self._page_load_fn, self._state, first, 0, 0, [])
        self._run_page(self._page_save_fn, self._state, first, 0, 0, [])

    def prefix_stats(self) -> dict:
        """The page pool's aggregates (an empty dict with the pool off);
        ``pinned`` drains to 0 once every admitted request released its
        chain."""
        if self._prefix is None:
            return {}
        return {**self._prefix.stats,
                "pages": self.n_pages - self._prefix.n_free,
                "pages_free": self._prefix.n_free,
                "pinned": self._prefix.pinned()}

    def cache_bytes(self) -> int:
        """Resident KV footprint: the slot cache, the page pool when this
        engine owns it (a mounted pool counts on its owner only) and the
        draft's slot cache, all layers."""
        layers = list(self._state["cache"])
        if self._owns_pages:
            layers += self._page_store.pool
        if self.spec_k:
            layers += self._draft_state["cache"]
        return sum(x.numel() * x.element_size() for layer in layers
                   for x in layer.values() if x is not None)
