"""The launchers' flag surface (the port's copy of ``dtf_tpu.cli.flags``),
over ``argparse``: the cluster, mesh and training flags with the JAX
package's names and defaults, the decode-config merge of the serving
launcher, the loss-side L2 of the ResNet recipe, and the LM-loss and
grad-shard resolution of the trainer."""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import NamedTuple, Optional

import torch

log = logging.getLogger("dtf_tpu_torch")

#: decode-config fields the checkpoint manifest is authoritative for: a
#: hand-matched mismatch on any of these silently garbles decode.
DECODE_MANIFEST_FIELDS = ("size", "kv_heads", "attn_window",
                          "attn_global_every")


def resolve_decode_config(args, manifest, present=frozenset()) -> dict:
    """Merge the checkpoint's ``model_config.json`` manifest into the flags.

    ``present`` names the flags given on the command line. Manifest
    present: its architecture fields WIN — a given flag that contradicts
    it raises, a matching or unset flag follows it. No manifest: the flags
    pass through. ``kv_cache_dtype`` is a serving-side choice: the flag
    wins when given, the manifest only supplies a default. Raises
    ValueError — the launcher turns it into a usage error.
    """
    out = {f: getattr(args, f) for f in DECODE_MANIFEST_FIELDS}
    out["kv_cache_dtype"] = getattr(args, "kv_cache_dtype", "")
    if manifest is not None:
        if int(manifest.get("moe_every", 0) or 0):
            raise ValueError(
                f"checkpoint was trained with moe_every="
                f"{manifest['moe_every']}; the decode stack has no MoE "
                "path — serving a Switch-MoE checkpoint would silently "
                "drop the expert weights")
        for f in DECODE_MANIFEST_FIELDS:
            if f not in manifest:
                continue
            if f in present and getattr(args, f) != manifest[f]:
                raise ValueError(
                    f"--{f}={getattr(args, f)!r} contradicts the "
                    f"checkpoint manifest ({manifest[f]!r}); drop the "
                    "flag — the manifest written by the training launcher "
                    "is authoritative")
            out[f] = manifest[f]
        if "kv_cache_dtype" not in present and "kv_cache_dtype" in manifest:
            out["kv_cache_dtype"] = manifest["kv_cache_dtype"]
    _validate_kv_cache_dtype(out["kv_cache_dtype"], manifest)
    return out


def _validate_kv_cache_dtype(dtype: str, manifest) -> None:
    if dtype not in ("", "int8"):
        raise ValueError(
            f"kv_cache_dtype={dtype!r} must be '' (store at model dtype) "
            "or 'int8'")
    if dtype == "int8" and manifest is not None:
        d_model = int(manifest.get("d_model", 0) or 0)
        heads = int(manifest.get("heads", 0) or 0)
        if d_model and heads and (d_model // heads) % 2:
            raise ValueError(
                f"kv_cache_dtype=int8 needs an even head dim (rope pairs "
                f"lanes); manifest says d_model={d_model} / heads={heads} "
                f"-> d_head={d_model // heads}")


# -- the training launchers' flag surface (dtf_tpu.cli.flags, argparse) ----

def present_flags(parser: argparse.ArgumentParser, argv) -> frozenset:
    """The dests of the flags given on the command line: ``parser`` (a
    fresh one — its defaults are suppressed here) parses again, so only
    given flags appear."""
    for act in parser._actions:
        act.default = argparse.SUPPRESS
    return frozenset(vars(parser.parse_args(argv)))


def parse_bool(s: str) -> bool:
    if s.lower() in ("1", "true", "yes"):
        return True
    if s.lower() in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def add_bool(p: argparse.ArgumentParser, name: str, default: bool,
             help: str = "") -> None:
    """absl's boolean flag: ``--name``, ``--name=false`` and ``--noname``."""
    p.add_argument(f"--{name}", type=parse_bool, nargs="?", const=True,
                   default=default, help=help)
    p.add_argument(f"--no{name}", dest=name, action="store_false",
                   help=argparse.SUPPRESS)


def define_cluster_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--ps_hosts", default="",
                   help="comma-separated ps host:port list (accepted for "
                        "compatibility; a ps role exits 0)")
    p.add_argument("--worker_hosts", default="",
                   help="comma-separated worker host:port list: one process "
                        "per device, the first one's address the "
                        "rendezvous")
    p.add_argument("--job_name", default="worker", help="'ps' or 'worker'")
    p.add_argument("--task_index", type=int, default=0)
    add_bool(p, "issync", True, "sync gradient aggregation; issync=false "
             "warns and proceeds synchronously")
    p.add_argument("--backend", default="gpu", choices=("gpu", "cpu"),
                   help="gpu (default; NCCL between processes) | cpu "
                        "(--device=cpu; gloo between processes)")
    p.add_argument("--devices_per_host", type=int, default=0)


def define_mesh_flags(p: argparse.ArgumentParser) -> None:
    for axis, default in (("data", -1), ("seq", 1), ("model", 1),
                          ("pipe", 1), ("expert", 1)):
        p.add_argument(f"--mesh_{axis}", type=int, default=default,
                       help="mesh axis size over the processes (data -1: "
                            "the rest); seq, pipe and expert > 1 are not "
                            "yet ported")


def define_train_flags(p: argparse.ArgumentParser, batch_size=64,
                       learning_rate=0.01, train_steps=1000,
                       lr_schedule="constant") -> None:
    p.add_argument("--data_dir", default="",
                   help="dataset directory (empty: synthetic)")
    p.add_argument("--logdir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "dtf_tpu_logs"),
                   help="checkpoint/summary dir")
    p.add_argument("--batch_size", type=int, default=batch_size,
                   help="GLOBAL batch size")
    p.add_argument("--learning_rate", type=float, default=learning_rate)
    p.add_argument("--train_steps", type=int, default=train_steps,
                   help="stop at this global step")
    p.add_argument("--checkpoint_every", type=int, default=200)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="gradient-accumulation microbatches")
    add_bool(p, "grad_shard", False, "ZeRO-1 sharded accumulator; falls "
             "back with a warning without accumulation, a data axis > 1 "
             "or ZeRO-1")
    p.add_argument("--clip_grad_norm", type=float, default=0.0,
                   help="clip gradients to this global norm (0 = off)")
    p.add_argument("--lr_schedule", default=lr_schedule,
                   help="constant | linear | cosine")
    p.add_argument("--warmup_steps", type=int, default=-1,
                   help="linear warmup steps; -1 = auto")
    p.add_argument("--lr_min_ratio", type=float, default=0.0)
    p.add_argument("--optimizer", default="",
                   help="sgd | momentum | adam | adamw | lamb | "
                        "adafactor; empty = the recipe's")
    p.add_argument("--weight_decay", type=float, default=-1.0,
                   help="weight decay for adamw / lamb, adafactor's "
                        "weight_decay_rate (-1 = default)")
    p.add_argument("--seed", type=int, default=0, help="init, data and "
                   "dropout seed")
    p.add_argument("--prefetch_depth", type=int, default=2,
                   help="device batches: the step's own plus depth-1 "
                        "copied ahead (1 = off)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="profiler window; not yet ported (must be 0)")
    p.add_argument("--profile_start", type=int, default=10)
    add_bool(p, "profile_on_demand", True, "live profile triggers; not yet "
             "ported: accepted and inert")
    add_bool(p, "telemetry", False, "run-wide observability; not yet ported")
    p.add_argument("--telemetry_keep_steps", type=int, default=64)
    p.add_argument("--telemetry_min_stall_s", type=float, default=60.0)
    p.add_argument("--telemetry_stall_factor", type=float, default=10.0)


#: optimizer families that apply weight decay themselves (decoupled decay):
#: a launcher whose recipe regularizes with a loss-side L2 drops the L2
#: when one of these is selected, and routes the decay to it instead
DECOUPLED_DECAY_OPTIMIZERS = ("adamw", "lamb", "adafactor")


def resolve_loss_l2(args, recipe_l2: float) -> float:
    """The loss-side L2 coefficient of a launcher with an L2 recipe:
    ``--weight_decay`` when set, else ``recipe_l2``. A decoupled-decay
    ``--optimizer`` takes the decay itself, so the loss-side L2 is 0; an
    unset ``--weight_decay`` then inherits ``recipe_l2`` (with a warning),
    so the recipe's regularization survives the swap. Resolve before
    ``optim.make_optimizer``, which reads the promoted value."""
    name = (getattr(args, "optimizer", "") or "").lower()
    if name not in DECOUPLED_DECAY_OPTIMIZERS:
        return args.weight_decay if args.weight_decay >= 0 else recipe_l2
    if args.weight_decay < 0:
        args.weight_decay = recipe_l2
        log.warning(
            "--optimizer=%s drops the recipe's loss-side L2; defaulting "
            "--weight_decay to the recipe's %g (decoupled decay). Pass "
            "--weight_decay explicitly to override.", name, recipe_l2)
    return 0.0


#: monolithic [B,T,V] f32 logits plus their cotangent must fit inside this
#: fraction of the device's memory (the JAX package's budget rule)
LOGITS_HBM_FRACTION = 0.25
#: the token-chunk width the loss takes when the logits do not fit (the
#: JAX package's default bounded-memory shape: one full-vocab product per
#: block)
AUTO_LOSS_CHUNK_TOKENS = 4096


class LmLossPath(NamedTuple):
    """The resolved LM loss path (``resolve_lm_loss``): the vocab-chunk
    width, the token-chunk width, the fused kernels, and why."""

    chunk_vocab: int
    chunk_tokens: int
    pallas: bool = False
    source: str = "heuristic"


def resolve_lm_loss(args, *, batch: int, seq_len: int, vocab_size: int,
                    device="cuda", hbm_bytes: Optional[float] = None,
                    model_axis: int = 1) -> LmLossPath:
    """Pick the LM loss path from the memory estimate, the JAX package's
    policy.

    Explicit flags (``--loss_chunk_vocab``, ``--loss_chunk_tokens``,
    ``--loss_pallas``) always win, with a warning when they force a fused
    path on a config whose monolithic logits fit, and when
    ``--loss_chunk_vocab`` is forced where the logits do not fit (the
    default bounded-memory path is the token-chunked one). Otherwise the
    monolithic path when the f32 logits plus their cotangent
    (2·B·T·V·4 bytes) fit inside ``LOGITS_HBM_FRACTION`` of the device
    memory, and the token-chunked loss at ``AUTO_LOSS_CHUNK_TOKENS`` when
    they do not. The port has no tuning cache, so no measured winner ever
    overrides this.

    ``hbm_bytes``: the budget's memory; by default the card's
    (``torch.cuda.get_device_properties(device).total_memory``). On the
    CPU, with no ``hbm_bytes``, there is no budget: the logits fit.
    ``model_axis`` > 1 (tensor parallelism): with no explicit flag, the
    monolithic path, the only one a vocab-sharded head takes (the
    launcher refuses the explicit flags there)."""
    lchunk = getattr(args, "loss_chunk_vocab", 0)
    tchunk = getattr(args, "loss_chunk_tokens", 0)
    lpallas = bool(getattr(args, "loss_pallas", False))
    est = 2 * batch * seq_len * vocab_size * 4
    if hbm_bytes is None and torch.device(device).type == "cuda":
        hbm_bytes = torch.cuda.get_device_properties(
            torch.device(device)).total_memory
    fits = hbm_bytes is None or est <= LOGITS_HBM_FRACTION * hbm_bytes
    budget = ("no budget (cpu)" if hbm_bytes is None else
              f"est {est / 1e9:.2f} GB of {hbm_bytes / 1e9:.0f} GB")
    if lchunk or tchunk or lpallas:
        which = ("--loss_chunk_vocab" if lchunk else
                 "--loss_chunk_tokens" if tchunk else "--loss_pallas")
        if fits and hbm_bytes is not None:
            log.warning(
                "%s forces a fused LM loss but the monolithic [B,T,V] "
                "logits fit (%s): drop the flag to let the memory "
                "estimate pick", which, budget)
        elif lchunk and not fits:
            log.warning(
                "--loss_chunk_vocab forces the vocab-chunked loss, whose "
                "online-logsumexp scan re-reads every token per chunk; the "
                "default bounded-memory path is the token-chunked loss — "
                "drop the flag to follow it")
        return LmLossPath(lchunk, tchunk, lpallas, source="explicit")
    if model_axis > 1:
        return LmLossPath(0, 0, source="tp mesh: monolithic only")
    if fits:
        return LmLossPath(0, 0, source=f"monolithic logits fit ({budget})")
    log.warning(
        "monolithic [B,T,V] logits estimated at %.2f GB (> %d%% of %.0f GB "
        "of device memory): auto-selecting the token-chunked fused loss "
        "(chunk=%d); pass --loss_chunk_tokens/--loss_chunk_vocab/"
        "--loss_pallas to override", est / 1e9,
        int(LOGITS_HBM_FRACTION * 100), hbm_bytes / 1e9,
        AUTO_LOSS_CHUNK_TOKENS)
    return LmLossPath(0, AUTO_LOSS_CHUNK_TOKENS,
                      source="HBM heuristic (no banked winner)")


def resolve_grad_shard(args, data_axis: int, *, blockers=()) -> bool:
    """``--grad_shard`` viability: it needs real accumulation and a data
    axis > 1. Returns the effective setting, warning on fallback."""
    if not getattr(args, "grad_shard", False):
        return False
    reasons = list(blockers)
    if getattr(args, "grad_accum", 1) <= 1:
        reasons.append("--grad_accum<=1 (no accumulator to shard)")
    if data_axis <= 1:
        reasons.append("data axis is 1 (nothing to reduce-scatter over)")
    if reasons:
        log.warning("--grad_shard falls back to the replicated accumulator: "
                    "%s", "; ".join(reasons))
        return False
    return True
