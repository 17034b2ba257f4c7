"""GPT online serving: continuous-batching decode (the port of
``scripts/serve_gpt.py``).

    # explicit requests (semicolon-separated prompts)
    python -m dtf_tpu_torch.serve_gpt --logdir=/tmp/run \\
        --requests="12,7,99;5,6,7,8" --n_new=32 --emit_tokens

    # seeded Poisson load (benching)
    python -m dtf_tpu_torch.serve_gpt --logdir=/tmp/run \\
        --poisson_rate=4 --n_requests=32 --max_len=256

    # speculative decoding with an early-exit draft, and prefix pages
    python -m dtf_tpu_torch.serve_gpt --logdir=/tmp/run --spec_k=4 \\
        --draft_layers=3 --prefix_pages=256 --kv_page_size=16 \\
        --requests=@/tmp/requests.txt

    # a fleet of two replicas, replica 0 wedged from its 5th decode on
    DTF_FAULT_INJECT=wedge_replica@5:replica=0 DTF_FAULT_WEDGE_S=2 \\
    python -m dtf_tpu_torch.serve_gpt --logdir=/tmp/run --replicas=2 \\
        --health_slow_s=1 --health_wedge_s=1.5 --poisson_rate=4

The online half of the GPT loop (``generate_gpt`` is the offline half):
parameters come from the newest checkpoint that ``train_gpt`` wrote under
``--logdir`` (its ``model_config.json`` manifest sets the architecture;
hand-given flags that contradict it raise), from ``--params_npz`` (a
flax-style tree) or from ``--init_seed``. Builds a
:class:`dtf_tpu_torch.serve.DecodeEngine` (``--n_slots`` concurrent
requests, ``--max_len`` a slot) and pumps a FIFO scheduler with
prefill/decode interleave — or, with ``--replicas`` N > 1, a
:class:`dtf_tpu_torch.serve.Router` over N engines sharing one set of
weights, with replica health (``--health``, ``--health_slow_s``,
``--health_wedge_s``, ``--health_probation_s``: quarantine, requeue,
probation) and, with ``--prefill_replicas`` P, prefill/decode
disaggregation over a shared prefix page store. ``DTF_FAULT_INJECT``'s
serve verbs (``wedge_replica``, ``slow_decode``, ``poison_request``,
``poison_draft``) are armed on the scheduler or router. ``--spec_k`` with a draft (``--draft_ckpt``:
another train_gpt logdir, or ``--draft_layers``: the served model's first
layers) decodes speculatively; ``--prefix_pages`` / ``--kv_page_size``
keep a prefix page pool. Prints ONE JSON line of serving metrics:
tokens/s, TTFT and per-token latency p50/p99, occupancy, queue depth,
the speculative counters and accept rate, the page pool's aggregates;
for a fleet the router's keys (``router_*``, the ``replica{i}_*`` panel,
the control-plane tick profile ``cp_*``).
``--emit_tokens`` first prints one ``rid:tok,tok,...`` row a request.
Runs on ``cuda`` unless ``--device=cpu`` (or ``--backend=cpu``).

``--publish_dir`` serves the weights ``train_gpt --publish_dir``
published (the newest servable version, or ``--publish_version``
exactly), and with ``--swap_poll_ticks`` N and ``--replicas`` >= 2 polls
the publish dir every N ticks and rolls each new version across the
fleet (``--canary_ticks``; the ``corrupt_publish`` and ``wedge_in_swap``
serve verbs); the line reports ``served_version``, ``final_version`` and
the router's swap keys.

The run-record plane (host side only: no device readback, no token
changed): ``--event_log_dir`` writes the fleet's event log
(:mod:`dtf_tpu_torch.telemetry.events`: ``serve_start``, health
transitions, requeue drains, the swap's start, canary, commit and
rollback, sink rotations, ``cp_profile``, the closing ``serve_summary``);
``--log_sink_dir`` records every done request
(:mod:`dtf_tpu_torch.serve.logsink`, mounted on the event log);
``--trace_out`` writes a Perfetto-loadable chrome trace of every
request's queue wait, engine calls and lifecycle, and annotates the
engines' step calls with the trace ids; ``--telemetry`` adds the
engine-call spans (``serve_*_p50_s``/``_p99_s``) and, with ``--logdir``,
``<logdir>/telemetry/TELEMETRY.json`` and its postmortem file. The line
then carries ``event_log``, ``log_sink``, ``trace_out`` /
``trace_events`` and ``trace_counts``; the JAX launcher's
``compile_events`` and ``monitoring_available`` are absent (no XLA
compile to count).

Sharded serving (``--mesh_model`` / ``--mesh_data``, one process per
device as ``train_gpt`` runs: ``--worker_hosts`` and ``--task_index``, or
a process group the caller made): every rank loads the whole parameters
(a checkpoint, a published version or ``--init_seed``) and keeps its
blocks (:func:`dtf_tpu_torch.models.gpt.tp_shard`; an early-exit draft
is cut from them, a ``--draft_ckpt`` draft sharded alike), then builds
its :class:`~dtf_tpu_torch.serve.DecodeEngine` (``mesh=``: its heads,
its data line's ``--n_slots / data`` slots). Rank 0 leads: the
scheduler, the client, the event log, the sink and the telemetry run
there only, and it prints the rows and the JSON line; every other rank
runs its engine's calls (:mod:`dtf_tpu_torch.serve.plane`) and exits 0
after the leader's clean stop (non-zero after a failed one).

    T="--backend=cpu --worker_hosts=localhost:2229,localhost:2230"
    python -m dtf_tpu_torch.serve_gpt $T --task_index=1 --mesh_model=2 \
        --size=tiny --init_seed=0 --requests="12,7,99;5,6,7,8" &
    python -m dtf_tpu_torch.serve_gpt $T --task_index=0 --mesh_model=2 \
        --size=tiny --init_seed=0 --requests="12,7,99;5,6,7,8" --emit_tokens

With ``--replicas`` N over a mesh every rank builds the same
:meth:`~dtf_tpu_torch.serve.Router.build` fleet (N replicas on one call
plane and one set of the rank's shard tensors); rank 0's router leads —
health, ``--prefill_replicas``, ``--spec_k`` and ``DTF_FAULT_INJECT``'s
serve verbs there — and with ``--swap_poll_ticks`` only rank 0 polls the
publish dir: each rank loads a new version the leader verified from the
dir itself and the fleet rolls over the mesh. The other ranks follow
until the leader's stop.

    T="--backend=cpu --worker_hosts=localhost:2231,localhost:2232"
    F="--mesh_model=2 --replicas=2 --publish_dir=/tmp/p/pub \
       --publish_version=1 --swap_poll_ticks=2 --canary_ticks=2"
    python -m dtf_tpu_torch.serve_gpt $T $F --task_index=1 \
        --requests="12,7,99;5,6,7,8;3" &
    python -m dtf_tpu_torch.serve_gpt $T $F --task_index=0 \
        --requests="12,7,99;5,6,7,8;3" --emit_tokens

Not yet ported, and raising when asked for: ``--draft_precision``,
``--spec_k=0`` with a draft (the kernel tuner's width) and the
draft-only swap (``--draft_publish_dir``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    from dtf_tpu_torch.cli import flags as dflags

    p = argparse.ArgumentParser(
        prog="python -m dtf_tpu_torch.serve_gpt",
        description="GPT continuous-batching serving on the H100 port.")
    dflags.define_cluster_flags(p)
    dflags.define_mesh_flags(p)
    p.add_argument("--logdir", default="",
                   help="training logdir: its ckpt/model_config.json "
                        "manifest sets the architecture, and its newest "
                        "checkpoint gives the parameters unless "
                        "--params_npz/--init_seed is passed")
    p.add_argument("--size", default="small",
                   help="small | medium | draft | tiny (manifest wins)")
    p.add_argument("--kv_heads", type=int, default=0,
                   help="grouped-query heads (manifest wins)")
    p.add_argument("--attn_window", type=int, default=0,
                   help="sliding window (manifest wins)")
    p.add_argument("--attn_global_every", type=int, default=0,
                   help="global-layer cadence (manifest wins)")
    p.add_argument("--kv_cache_dtype", default="",
                   help="'' or 'int8' (serving-side choice; halves the "
                        "cache bytes)")
    p.add_argument("--n_slots", type=int, default=8,
                   help="concurrent request slots (the KV cache batch)")
    p.add_argument("--max_len", type=int, default=256,
                   help="per-slot token budget (prompt + generated)")
    p.add_argument("--prefill_chunk", type=int, default=16,
                   help="fixed width of the prefill step (>= 2); long "
                        "prompts stream through it")
    p.add_argument("--prefill_chunks_per_tick", type=int, default=4,
                   help="at most this many prompt chunks between decode "
                        "steps (0 = admit greedily)")
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas behind a router: one set of "
                        "weights, a KV cache each, least-occupancy "
                        "admission")
    p.add_argument("--prefill_replicas", type=int, default=0,
                   help="prefill/decode disaggregation: the first N "
                        "replicas only prefill, handing the KV to decode "
                        "replicas through one shared page store (needs "
                        "--prefix_pages)")
    dflags.add_bool(p, "health", True, "with --replicas > 1: the replica "
                    "health watchdog (quarantine, requeue, probation)")
    p.add_argument("--health_slow_s", type=float, default=0.0,
                   help="health: the least slow-tick bar in seconds (0 = "
                        "the library's default)")
    p.add_argument("--health_wedge_s", type=float, default=0.0,
                   help="health: one tick this slow quarantines at once "
                        "(0 = the library's default)")
    p.add_argument("--health_probation_s", type=float, default=0.0,
                   help="health: quarantine to probation delay in seconds "
                        "(0 = the library's default)")
    p.add_argument("--spec_k", type=int, default=0,
                   help="speculative decoding: draft proposals a tick (needs "
                        "--draft_ckpt or --draft_layers)")
    p.add_argument("--draft_ckpt", default="",
                   help="the draft's train_gpt logdir (its ckpt/ manifest "
                        "and checkpoint; size 'draft' unless the manifest "
                        "says otherwise)")
    p.add_argument("--draft_layers", type=int, default=0,
                   help="early-exit draft: the served model's first N "
                        "layers")
    p.add_argument("--draft_precision", default="",
                   help="the draft's matmul precision; not yet ported")
    p.add_argument("--kv_page_size", type=int, default=0,
                   help="prefix page width in tokens (with --prefix_pages)")
    p.add_argument("--prefix_pages", type=int, default=0,
                   help="pages of the prefix KV page pool (0 = off)")
    p.add_argument("--ttft_slo", type=float, default=0.0,
                   help="TTFT objective in seconds (0 = untracked): the "
                        "JSON line reports the compliance fraction")
    p.add_argument("--max_queue", type=int, default=0,
                   help="bounded queue: a submit against a full queue is "
                        "SHED with a retry_after_s hint (0 = unbounded)")
    p.add_argument("--ttft_deadline", type=float, default=0.0,
                   help="per-request TTFT deadline in seconds (0 = none)")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="per-request TOTAL deadline in seconds (0 = none)")
    p.add_argument("--publish_dir", default="",
                   help="serve PUBLISHED weights (train_gpt --publish_dir): "
                        "the newest servable version, or "
                        "--publish_version; the JSON line reports the "
                        "version served")
    p.add_argument("--publish_version", type=int, default=0,
                   help="with --publish_dir: serve exactly this version, "
                        "with no fallback past corruption; 0 = the newest "
                        "servable (the guarded walk warns past a corrupt "
                        "newest)")
    p.add_argument("--swap_poll_ticks", type=int, default=0,
                   help="with --publish_dir and --replicas >= 2: poll the "
                        "publish dir every N ticks and ROLL new versions "
                        "across the fleet (drain a replica, swap, probe, "
                        "readmit; the first is a health-gated canary); 0 = "
                        "serve the start version only")
    p.add_argument("--canary_ticks", type=int, default=8,
                   help="rolling swap: ticks the first swapped replica "
                        "serves alone before the rest follow; a health or "
                        "SLO breach inside the window rolls back")
    p.add_argument("--requests", default="",
                   help="semicolon-separated comma-lists of token ids, a "
                        "row optionally ending in /N (its own --n_new), or "
                        "@FILE holding such rows; empty = Poisson load")
    p.add_argument("--n_new", type=int, default=32,
                   help="max new tokens per explicit request")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy, else sampling")
    p.add_argument("--top_k", type=int, default=0, help="0 = off")
    p.add_argument("--top_p", type=float, default=1.0, help="1.0 = off")
    p.add_argument("--eos_id", type=int, default=-1,
                   help="stop token (-1 = none)")
    p.add_argument("--pad_id", type=int, default=0, help="pad after eos")
    p.add_argument("--seed", type=int, default=0,
                   help="sampling / load-gen seed (request i: seed + i)")
    p.add_argument("--poisson_rate", type=float, default=2.0,
                   help="requests per second of the open-loop load")
    p.add_argument("--n_requests", type=int, default=16)
    p.add_argument("--prompt_min", type=int, default=4)
    p.add_argument("--prompt_max", type=int, default=64)
    p.add_argument("--new_min", type=int, default=8)
    p.add_argument("--new_max", type=int, default=64)
    dflags.add_bool(p, "emit_tokens", False, "print rid:tok,... per request")
    dflags.add_bool(p, "telemetry", False, "engine-call phase spans "
                    "(serve_prefill_chunk / serve_decode p50/p99 in the "
                    "JSON line); with --logdir, TELEMETRY.json and the "
                    "postmortem under <logdir>/telemetry")
    p.add_argument("--stats_every", type=int, default=0,
                   help="every N ticks, one JSON stats snapshot line to "
                        "stderr (0 = off)")
    p.add_argument("--ttft_slo_frac", type=float, default=0.0,
                   help="with --stats_every and --ttft_slo: WARN when the "
                        "SLO-ok fraction drops below this floor; with "
                        "--swap_poll_ticks, also the canary's rollback "
                        "floor")
    p.add_argument("--trace_out", default="",
                   help="write a Perfetto-loadable chrome trace of every "
                        "request (queue wait, prefill chunks, decode steps, "
                        "tagged with trace ids) to this path")
    p.add_argument("--log_sink_dir", default="",
                   help="record every done request (prompt, tokens, "
                        "version, replica, TTFT, latency) into CRC-framed "
                        "rotated shards under this directory")
    p.add_argument("--event_log_dir", default="",
                   help="the fleet's event log (health, requeues, swaps, "
                        "sink rotations, the tick profile) under this "
                        "directory")
    p.add_argument("--draft_publish_dir", default="",
                   help="distilled-draft swaps; not yet ported")
    # the port's own
    p.add_argument("--device", default=None, help="cuda (default) | cpu")
    p.add_argument("--params_npz", default="",
                   help="flax-style parameter tree saved by "
                        "dtf_tpu_torch.convert.save_npz")
    p.add_argument("--init_seed", type=int, default=None,
                   help="seeded GPT-2-style random parameters")
    return p


#: flags of features not yet ported: (dest, what), raising when given a
#: value other than their default
_UNPORTED = (("draft_precision", "--draft_precision (a low-precision "
                                 "draft)"),
             ("draft_publish_dir", "--draft_publish_dir (draft swaps)"))


def run(argv=None):
    """Serve as the command line says, in process. Returns ``(out, rows,
    engine)``: the JSON line's dict, the ``--emit_tokens`` rows (none
    without the flag) and the engine — the router with ``--replicas`` >
    1 — for a caller that measures it further. On a follower rank of a
    mesh ``out`` is None: the rank ran the leader's calls until its stop
    (a failed stop raises)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    # the leader's serving body: its followers stop when it ends
    with contextlib.ExitStack() as leading:
        return _run(argv, leading)


def _run(argv, leading: contextlib.ExitStack):
    parser = build_parser()
    args = parser.parse_args(argv)
    defaults = build_parser().parse_args([])
    for dest, what in _UNPORTED:
        if getattr(args, dest) != getattr(defaults, dest):
            raise NotImplementedError(f"{what} is not yet ported")
    if args.draft_ckpt and args.draft_layers:
        parser.error("--draft_ckpt and --draft_layers are two ways to get "
                     "ONE draft model; pass exactly one")
    if args.spec_k and not (args.draft_ckpt or args.draft_layers):
        parser.error(f"--spec_k={args.spec_k} needs a draft model: pass "
                     "--draft_ckpt or --draft_layers")
    if (args.draft_ckpt or args.draft_layers) and not args.spec_k:
        raise NotImplementedError(
            "--spec_k=0 with a draft (the kernel tuner picks the draft "
            "width) is not yet ported (tune/); pass --spec_k >= 1")
    if args.kv_page_size and not args.prefix_pages:
        parser.error(f"--kv_page_size={args.kv_page_size} has no effect "
                     "without --prefix_pages > 0 (the prefix page cache "
                     "stays off); set both or neither")
    if args.replicas < 1:
        parser.error(f"--replicas={args.replicas} must be >= 1")
    if args.publish_version and not args.publish_dir:
        parser.error("--publish_version needs --publish_dir (it names a "
                     "PUBLISHED version, not a checkpoint step)")
    if args.swap_poll_ticks:
        if not args.publish_dir:
            parser.error("--swap_poll_ticks needs --publish_dir (there is "
                         "nothing to poll for new versions without a "
                         "publish dir)")
        if args.replicas < 2:
            parser.error("--swap_poll_ticks needs --replicas >= 2: a "
                         "rolling swap drains one replica while the others "
                         "serve (a single engine cannot swap with zero "
                         "downtime)")
    if args.publish_dir and (args.params_npz or args.init_seed is not None):
        parser.error("--publish_dir gives the parameters; drop "
                     "--params_npz / --init_seed")
    if args.prefill_replicas:
        if not 0 < args.prefill_replicas < args.replicas:
            parser.error(
                f"--prefill_replicas={args.prefill_replicas} must leave at "
                f"least one decode replica (--replicas={args.replicas})")
        if not args.prefix_pages:
            parser.error("--prefill_replicas needs --prefix_pages > 0: the "
                         "page pool is the prefill→decode KV transport")

    import torch

    from dtf_tpu_torch.checkpoint import Checkpointer, load_model_config
    from dtf_tpu_torch.cli.flags import present_flags, resolve_decode_config
    from dtf_tpu_torch.cli.launch import setup
    from dtf_tpu_torch.convert import init_params, load_npz, params_from_flax
    from dtf_tpu_torch.metrics import MetricWriter
    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.fault.inject import ServeFaultPlan
    from dtf_tpu_torch.publish import PublishWatcher, load_published
    from dtf_tpu_torch.serve import (DecodeEngine, HealthConfig, Heartbeat,
                                     PoissonLoadGen, Request, Router,
                                     Scheduler, SwapConfig,
                                     install_serve_fault, replay)
    from dtf_tpu_torch.serve.logsink import LogSink
    from dtf_tpu_torch.telemetry.events import EventLog
    from dtf_tpu_torch.telemetry.profile import export_chrome_trace
    from dtf_tpu_torch.telemetry.run import Telemetry, merge_artifact
    from dtf_tpu_torch.telemetry.trace import TraceCollector

    device, info, mesh = setup(args)
    if mesh is not None and args.n_slots % mesh.data_size:
        parser.error(f"--n_slots={args.n_slots} not divisible by the data "
                     f"axis ({mesh.data_size}) — slots shard over 'data'")
    ckpt_dir = os.path.join(args.logdir, "ckpt") if args.logdir else ""
    # train_gpt writes the architecture manifest next to the publish
    # manifest too; the logdir's stays the fallback
    manifest = ((load_model_config(args.publish_dir)
                 if args.publish_dir else None)
                or (load_model_config(ckpt_dir) if ckpt_dir else None))
    try:
        decode_cfg = resolve_decode_config(
            args, manifest, present_flags(build_parser(), argv))
        base = gpt.GPTConfig.by_name(decode_cfg["size"])
    except ValueError as e:
        parser.error(str(e))
    except KeyError as e:
        parser.error(f"--size: {e.args[0]}")
    cfg = dataclasses.replace(
        base, kv_heads=decode_cfg["kv_heads"] or None,
        attn_window=decode_cfg["attn_window"],
        attn_global_every=decode_cfg["attn_global_every"],
        kv_cache_dtype=decode_cfg["kv_cache_dtype"])

    step = None
    served_version = 0
    if args.publish_dir:
        try:
            served_version, step, params = load_published(
                args.publish_dir, args.publish_version or None)
        except (FileNotFoundError, ValueError, RuntimeError) as e:
            parser.error(str(e))
        print(f"serving published version {served_version} (train step "
              f"{step}) from {args.publish_dir}", file=sys.stderr)
    elif args.params_npz:
        params = params_from_flax(load_npz(args.params_npz))
    elif args.init_seed is not None:
        params = params_from_flax(init_params(cfg, args.init_seed))
    elif ckpt_dir:
        ckpt = Checkpointer(ckpt_dir)
        if ckpt.latest_step() is None:
            parser.error(f"no checkpoint under {ckpt_dir}")
        params = ckpt.restore_params()
        step = ckpt.last_restored_step
        print(f"restored params of step {step} from {ckpt_dir}",
              file=sys.stderr)
    else:
        parser.error("no parameters: pass --params_npz, --init_seed or the "
                     "--logdir of a training run")
    # over a mesh each rank keeps its blocks, before the early-exit draft
    # is cut from them (so it shares them)
    params = gpt.tp_shard(params, mesh)
    # the speculative draft: its own checkpoint and manifest, or the
    # served model's first layers; the verifier samples every delivered
    # token, so the draft moves throughput, never the streams
    draft_cfg = draft_params = None
    if args.draft_ckpt:
        dckpt_dir = os.path.join(args.draft_ckpt, "ckpt")
        dmanifest = load_model_config(dckpt_dir)
        if dmanifest is None:
            parser.error(f"--draft_ckpt={args.draft_ckpt} has no "
                         "model_config.json manifest; the draft "
                         "architecture cannot be guessed")
        try:
            dbase = gpt.GPTConfig.by_name(dmanifest.get("size", "draft"))
        except KeyError as e:
            parser.error(f"draft manifest size: {e.args[0]}")
        draft_cfg = dataclasses.replace(
            dbase, layers=int(dmanifest.get("layers", dbase.layers)),
            kv_heads=dmanifest.get("kv_heads") or None,
            attn_window=int(dmanifest.get("attn_window", 0) or 0),
            attn_global_every=int(
                dmanifest.get("attn_global_every", 0) or 0),
            kv_cache_dtype=decode_cfg["kv_cache_dtype"])
        dck = Checkpointer(dckpt_dir)
        if dck.latest_step() is None:
            parser.error(f"no checkpoint under {dckpt_dir}")
        draft_params = gpt.tp_shard(dck.restore_params(), mesh)
        print(f"restored draft params of step {dck.last_restored_step} "
              f"from {dckpt_dir}", file=sys.stderr)
    elif args.draft_layers:
        try:
            draft_cfg, draft_params = gpt.draft_truncate(cfg, params,
                                                         args.draft_layers)
        except ValueError as e:
            parser.error(str(e))
    engine_kw = dict(n_slots=args.n_slots, max_len=args.max_len,
                     prefill_chunk=args.prefill_chunk, device=device,
                     kv_page_size=args.kv_page_size,
                     prefix_pages=args.prefix_pages, draft_cfg=draft_cfg,
                     draft_params=draft_params, spec_k=args.spec_k,
                     mesh=mesh)
    # the record plane, the scheduler and the client: the leader's only
    tel = None
    if info.is_chief and (args.telemetry or args.trace_out):
        # serving is host-driven: spans and the postmortem, no watchdog
        tel = Telemetry(watchdog=False,
                        out_dir=(os.path.join(args.logdir, "telemetry")
                                 if args.logdir else None))
        if args.trace_out:
            tel.tracer = TraceCollector()
    # the event log first, so the sink's recovery at mount is on it
    events = (EventLog(args.event_log_dir)
              if args.event_log_dir and info.is_chief else None)
    sink = (LogSink(args.log_sink_dir, events=events)
            if args.log_sink_dir and info.is_chief else None)
    sched_kw = dict(prefill_chunks_per_tick=args.prefill_chunks_per_tick,
                    ttft_slo_s=args.ttft_slo, max_queue=args.max_queue,
                    telemetry=tel, log_sink=sink)
    try:
        if args.replicas > 1:
            health = False
            if args.health:
                health = HealthConfig(**{
                    name: value for name, value in (
                        ("min_slow_s", args.health_slow_s),
                        ("wedge_s", args.health_wedge_s),
                        ("probation_delay_s", args.health_probation_s))
                    if value > 0})
            # one constructor for the fleet: Router.build shares the
            # weights and owns the role rules (one page store, eager
            # saves, no draft on a prefill replica)
            sched = served = Router.build(
                cfg, params, n_replicas=args.replicas,
                prefill_replicas=args.prefill_replicas,
                writer=MetricWriter(echo=False), health=health,
                events=events, **engine_kw, **sched_kw)
            engines = sched.engines
        else:
            engines = [DecodeEngine(cfg, params, **engine_kw)]
            served = engines[0]
    except ValueError as e:     # the engine's and health's option checks
        parser.error(str(e))
    del params, draft_params, engine_kw
    if not served.is_leader:
        # a follower rank of a mesh: the version it was built with, then
        # the leader's calls until its stop
        if args.replicas > 1:
            served.stamp_version(served_version)
        else:
            served.set_param_version(served_version)
        if not served.follow():
            raise RuntimeError("the leader rank stopped after a failure")
        return None, [], served
    leading.enter_context(served.leading())
    if args.replicas == 1:
        sched = Scheduler(engines[0], MetricWriter(echo=False), log_every=0,
                          **sched_kw)
        # the crash_in_event_rotate verb reads the pump's event log
        sched.events = events
    if events is not None:
        events.emit("serve_start", replicas=args.replicas,
                    version=served_version,
                    step=None if step is None else int(step),
                    spec_k=engines[-1].spec_k,
                    prefill_replicas=args.prefill_replicas)
    if served_version:
        # the published version the fleet was BUILT with: records, page
        # epochs and the skew tripwire carry it
        if args.replicas > 1:
            sched.stamp_version(served_version)
        else:
            engines[0].set_param_version(served_version)
    if tel is not None:
        if args.trace_out:
            for e in engines:
                e.annotate_traces = True
        tel.start()
    # the swap poller: every --swap_poll_ticks ticks a NEW published
    # version (digest-verified; a corrupt one skipped with a warning)
    # starts a rolling swap; the serve loop never pauses
    watcher = swap_tick = None
    if args.swap_poll_ticks:
        watcher = PublishWatcher(args.publish_dir,
                                 applied_version=served_version)
        # with a TTFT objective, --ttft_slo_frac is also the canary's
        # rollback floor; health verdicts gate regardless
        try:
            swap_cfg = SwapConfig(
                canary_ticks=args.canary_ticks,
                slo_floor=args.ttft_slo_frac if args.ttft_slo > 0 else 0.0)
        except ValueError as e:
            parser.error(str(e))
        draft_factory = None
        if args.draft_layers:
            # picklable: over a mesh it travels to every rank with the
            # version's staging call
            draft_factory = functools.partial(gpt.early_exit_draft, cfg,
                                              args.draft_layers)
        ticks = [0]

        def swap_tick():
            ticks[0] += 1
            if ticks[0] % args.swap_poll_ticks == 0:
                sched.maybe_swap_published(watcher, config=swap_cfg,
                                           draft_factory=draft_factory)

    fault_plan = ServeFaultPlan.from_env()
    if fault_plan is not None:
        install_serve_fault(fault_plan, sched, watcher=watcher)
    heartbeat = None
    if args.stats_every:
        heartbeat = Heartbeat(sched, every_ticks=args.stats_every,
                              slo_floor=args.ttft_slo_frac,
                              flight=tel.flight if tel is not None else None,
                              events=events)
    hooks = [h for h in (heartbeat.maybe_emit if heartbeat is not None
                         else None, swap_tick) if h is not None]
    on_tick = (None if not hooks else hooks[0] if len(hooks) == 1
               else (lambda: [h() for h in hooks]))

    eos = args.eos_id if args.eos_id >= 0 else None
    t0 = time.perf_counter()
    if args.requests:
        n = 0
        text = args.requests
        if text.startswith("@"):
            with open(text[1:]) as f:
                text = f.read()
        lines = (r.strip() for r in text.replace("\n", ";").split(";"))
        for i, row in enumerate(r for r in lines if r):
            row, _, budget = row.partition("/")
            try:
                prompt = [int(t) for t in row.split(",") if t.strip()]
                n_new = int(budget) if budget else args.n_new
            except ValueError:
                parser.error(f"request {i}: not a comma-list of token ids "
                             f"with an optional /N: {row[:40]!r}")
            if not prompt or not all(
                    0 <= t < cfg.vocab_size for t in prompt):
                parser.error(f"request {i}: token ids must be in "
                             f"[0, {cfg.vocab_size})")
            try:
                sched.submit(Request(
                    prompt=prompt, max_new=n_new,
                    temperature=args.temperature, top_k=args.top_k,
                    top_p=args.top_p, eos_id=eos, pad_id=args.pad_id,
                    seed=args.seed + i, ttft_deadline_s=args.ttft_deadline,
                    deadline_s=args.deadline))
            except ValueError as e:   # over-long prompt / bad n_new
                parser.error(f"request {i}: {e}")
            n += 1
        sched.run_until_idle(on_tick=on_tick)
    else:
        prompt_cap = min(args.prompt_max, args.max_len - args.new_min)
        if prompt_cap < args.prompt_min:
            parser.error(
                f"--max_len={args.max_len} leaves no room for prompts in "
                f"[{args.prompt_min}, ..] plus --new_min={args.new_min}; "
                "raise --max_len or lower --prompt_min/--new_min")
        try:
            gen = PoissonLoadGen(
                rate=args.poisson_rate, n_requests=args.n_requests,
                vocab_size=cfg.vocab_size, prompt_min=args.prompt_min,
                prompt_max=prompt_cap, new_min=args.new_min,
                new_max=args.new_max, temperature=args.temperature,
                top_k=args.top_k, top_p=args.top_p, eos_id=eos,
                seed=args.seed)
        except ValueError as e:  # rate / prompt / new bound flag errors
            parser.error(str(e))
        arrivals = gen.arrivals()
        if args.ttft_deadline > 0 or args.deadline > 0:
            arrivals = ((t, dataclasses.replace(
                req, ttft_deadline_s=args.ttft_deadline,
                deadline_s=args.deadline)) for t, req in arrivals)
        replay(sched, arrivals, on_tick=on_tick)
        n = args.n_requests
    if args.swap_poll_ticks and sched.swap_in_progress:
        # a swap that started near the end converges before the line
        # (ticks with no traffic still advance it)
        sched.finish_swap()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine = engines[-1]                # a decode replica

    rids = range(n)                      # submit order = id order
    polls = [sched.poll(r) for r in rids]
    rows = ([f"{rid}:" + ",".join(str(t) for t in p["tokens"])
             for rid, p in zip(rids, polls)] if args.emit_tokens else [])
    statuses: dict = {}
    for p in polls:
        statuses[p["status"]] = statuses.get(p["status"], 0) + 1
    n_tokens = sum(len(p["tokens"]) for p in polls)
    out = {"mode": "requests" if args.requests else "poisson",
           "backend": device.type,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "step": step, "served_version": served_version,
           "final_version": int(sched.version if args.replicas > 1
                                else engine.param_version),
           "replicas": args.replicas,
           "prefill_replicas": args.prefill_replicas,
           "spec_k": engine.spec_k,
           "draft": ("ckpt" if args.draft_ckpt
                     else f"layers:{args.draft_layers}"
                     if args.draft_layers else ""),
           "draft_precision": args.draft_precision,
           "request_statuses": statuses,
           "fault_inject": (os.environ.get("DTF_FAULT_INJECT", "")
                            if fault_plan is not None else ""),
           "n_slots": args.n_slots,
           "max_len": args.max_len, "prefill_chunk": args.prefill_chunk,
           "kv_page_size": engine.page_size,
           "prefix_pages": engine.n_pages,
           "requests": n, "generated_tokens": n_tokens,
           "wall_s": round(wall, 4),
           "tokens_per_sec": round(n_tokens / max(wall, 1e-9), 1),
           "cache_mib": round(sum(e.cache_bytes() for e in engines)
                              / 2 ** 20, 2)}
    out.update({k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in sched.stats().items()})
    acc = sched.accept_by_version()
    if acc:
        out["accept_by_version"] = {str(v): [p, a]
                                    for v, (p, a) in acc.items()}
    if sink is not None:
        # commits the open shard; a torn one is the next sink's to adopt
        sink.close()
        out["log_sink_dir"] = args.log_sink_dir
        out["log_sink"] = sink.stats()
    if events is not None:
        # the run's closing record, then the open shard commits
        events.emit("serve_summary", requests=n, generated_tokens=n_tokens,
                    statuses=statuses, final_version=out["final_version"],
                    accept_by_version=out.get("accept_by_version", {}))
        events.close()
        out["event_log_dir"] = args.event_log_dir
        out["event_log"] = events.stats()
    if heartbeat is not None:
        out.update(heartbeat.stats())
    if tel is not None:
        if args.trace_out:
            export_chrome_trace(args.trace_out,
                                request_events=tel.tracer.events,
                                meta={"source": "serve_gpt",
                                      "replicas": args.replicas})
            out["trace_out"] = args.trace_out
            out["trace_events"] = len(tel.tracer.events)
        tel.stop()
        out["trace_counts"] = [
            {**e.trace_counts,
             **{f"page_{k}": v for k, v in e.page_trace_counts.items()}}
            for e in engines]
        if args.logdir:
            extra = {"source": "serve_gpt", "served_version": served_version,
                     "final_version": out["final_version"]}
            if "accept_by_version" in out:
                extra["accept_by_version"] = out["accept_by_version"]
            if sink is not None:
                extra["log_sink"] = sink.stats()
            merge_artifact(os.path.join(args.logdir, "telemetry",
                                        "TELEMETRY.json"), tel.report(extra))
    return out, rows, served


def main(argv=None) -> int:
    from dtf_tpu_torch.cli.launch import own_process_group

    with own_process_group():
        out, rows, _ = run(argv)
    if out is None:                     # a follower rank of a mesh
        return 0
    for row in rows:
        print(row)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
