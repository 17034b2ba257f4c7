"""GPT inference with the KV cache (the port of ``scripts/generate_gpt.py``).

    python -m dtf_tpu_torch.generate_gpt --size=small --init_seed=0 \\
        --prompt=12,7,99 --n_new=16 --temperature=0.8 --top_p=0.9

Builds the decode-mode model (``decode_len`` = prompt + new tokens), loads
its parameters from ``--params_npz`` (a flax-style tree, see
:mod:`dtf_tpu_torch.convert`), makes seeded GPT-2-style ones with
``--init_seed``, or restores the newest checkpoint that
``python -m dtf_tpu_torch.train_gpt`` wrote under ``--logdir`` (its
``model_config.json`` manifest sets the architecture), and runs
:func:`dtf_tpu_torch.models.gpt.generate` — greedy or
temperature/top-k/nucleus sampling — or, with ``--num_beams`` > 1,
:func:`dtf_tpu_torch.models.gpt.generate_beam` (``--length_penalty``).
Prints one token-id row per batch element. Runs on ``cuda`` unless
``--device=cpu`` (or ``--backend=cpu``). The flag names are the JAX
launcher's; restoring an Orbax checkpoint of the JAX package is not
ported yet.

Sharded decode (``--mesh_model`` / ``--mesh_data``, one process per
device as ``train_gpt`` runs: ``--worker_hosts`` and ``--task_index``, or
a process group the caller made): every rank loads the whole parameters
and keeps its blocks (:func:`dtf_tpu_torch.models.gpt.tp_shard`), then
``generate(mesh=)`` decodes its data line's rows at its heads; rank 0
prints the rows. ``--num_beams`` > 1 with a mesh is a usage error, as in
the JAX launcher.

    T="--backend=cpu --worker_hosts=localhost:2227,localhost:2228"
    python -m dtf_tpu_torch.generate_gpt $T --task_index=1 --mesh_model=2 \
        --size=tiny --init_seed=0 &
    python -m dtf_tpu_torch.generate_gpt $T --task_index=0 --mesh_model=2 \
        --size=tiny --init_seed=0
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    from dtf_tpu_torch.cli import flags as dflags

    p = argparse.ArgumentParser(
        prog="python -m dtf_tpu_torch.generate_gpt",
        description="GPT decode with the KV cache on the H100 port.")
    # cluster and mesh flags: one process, or one a device of the mesh
    dflags.define_cluster_flags(p)
    dflags.define_mesh_flags(p)
    p.add_argument("--logdir", default="",
                   help="training logdir: its ckpt/model_config.json "
                        "manifest, when present, sets the architecture, "
                        "and its newest checkpoint gives the parameters "
                        "unless --params_npz/--init_seed is passed")
    p.add_argument("--size", default="small",
                   help="small | medium | draft | tiny (manifest wins)")
    p.add_argument("--kv_heads", type=int, default=0,
                   help="grouped-query attention heads (0 = plain MHA)")
    p.add_argument("--attn_window", type=int, default=0,
                   help="sliding-window size (0 = full causal)")
    p.add_argument("--attn_global_every", type=int, default=0,
                   help="global-attention layer cadence")
    p.add_argument("--prompt", default="",
                   help="comma-separated token ids; empty = 1,2,3,4")
    p.add_argument("--batch", type=int, default=1,
                   help="decode batch size (the prompt is broadcast)")
    p.add_argument("--n_new", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy, else sampling")
    p.add_argument("--num_beams", type=int, default=0,
                   help="beam-search width (0/1 = off); deterministic, "
                        "excludes the sampling flags")
    p.add_argument("--length_penalty", type=float, default=0.0,
                   help="beam rescoring alpha: score / len**alpha (0 = the "
                        "sum of log-probs)")
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0,
                   help="sampling seed (row r of the batch draws stream "
                        "(seed, r))")
    p.add_argument("--eos_id", type=int, default=-1,
                   help="stop token (-1 = none); later tokens are --pad_id")
    p.add_argument("--pad_id", type=int, default=0)
    p.add_argument("--kv_cache_dtype", default="",
                   help="'' = cache at compute dtype; 'int8' = quantized")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="prefill in chunks of this many tokens (0 = one "
                        "shot, through the flash kernel on cuda)")
    # the port's own
    p.add_argument("--device", default=None,
                   help="cuda (default) | cpu")
    p.add_argument("--params_npz", default="",
                   help="flax-style parameter tree saved by "
                        "dtf_tpu_torch.convert.save_npz")
    p.add_argument("--init_seed", type=int, default=None,
                   help="seeded GPT-2-style random parameters")
    return p


def _present(argv) -> frozenset:
    """The dests of the flags given on the command line."""
    from dtf_tpu_torch.cli.flags import present_flags

    return present_flags(build_parser(), argv)


def main(argv=None) -> int:
    from dtf_tpu_torch.cli.launch import own_process_group

    with own_process_group():
        return _run(sys.argv[1:] if argv is None else list(argv))


def _run(argv) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    import torch

    from dtf_tpu_torch.checkpoint import Checkpointer, load_model_config
    from dtf_tpu_torch.cli.flags import resolve_decode_config
    from dtf_tpu_torch.cli.launch import setup
    from dtf_tpu_torch.convert import init_params, load_npz, params_from_flax
    from dtf_tpu_torch.models import gpt

    if args.num_beams > 1 and (args.temperature > 0.0 or args.top_k
                               or args.top_p < 1.0):
        parser.error("--num_beams is a deterministic search; it excludes "
                     "--temperature/--top_k/--top_p")
    if args.temperature == 0.0 and (args.top_k or args.top_p < 1.0):
        parser.error("--top_k/--top_p have no effect at --temperature=0 "
                     "(greedy); set a positive temperature to sample")
    if args.num_beams > 1 and (args.mesh_model > 1 or args.mesh_data > 1):
        parser.error("--num_beams does not compose with a sharded decode "
                     "mesh; shard the batch outside instead")
    device, info, mesh = setup(args)

    manifest = (load_model_config(os.path.join(args.logdir, "ckpt"))
                if args.logdir else None)
    try:
        decode_cfg = resolve_decode_config(args, manifest, _present(argv))
        base = gpt.GPTConfig.by_name(decode_cfg["size"])
    except ValueError as e:
        parser.error(str(e))
    except KeyError as e:
        parser.error(f"--size: {e.args[0]}")
    prompt_ids = ([int(t) for t in args.prompt.split(",") if t.strip()]
                  or [1, 2, 3, 4])
    if max(prompt_ids) >= base.vocab_size or min(prompt_ids) < 0:
        parser.error(f"prompt ids must be in [0, {base.vocab_size})")
    cfg = dataclasses.replace(
        base, kv_heads=decode_cfg["kv_heads"] or None,
        attn_window=decode_cfg["attn_window"],
        attn_global_every=decode_cfg["attn_global_every"],
        kv_cache_dtype=decode_cfg["kv_cache_dtype"],
        decode_len=len(prompt_ids) + args.n_new)

    if args.params_npz:
        state_dict = params_from_flax(load_npz(args.params_npz))
    elif args.init_seed is not None:
        state_dict = params_from_flax(init_params(cfg, args.init_seed))
    elif args.logdir:
        ckpt = Checkpointer(os.path.join(args.logdir, "ckpt"))
        if ckpt.latest_step() is None:
            parser.error(f"no checkpoint under {args.logdir}/ckpt")
        state_dict = ckpt.restore_params()
        print(f"restored checkpoint step {ckpt.last_restored_step} from "
              f"{args.logdir}/ckpt", file=sys.stderr)
    else:
        parser.error("no parameters: pass --params_npz, --init_seed or the "
                     "--logdir of a training run")
    model = gpt.GPT(cfg, device=device, mesh=mesh)
    model.load_state_dict(gpt.tp_shard(state_dict, mesh))
    model.eval()

    prompt = torch.tensor(prompt_ids, dtype=torch.long).expand(
        args.batch, len(prompt_ids))
    eos = args.eos_id if args.eos_id >= 0 else None
    if args.num_beams > 1:
        out = gpt.generate_beam(
            model, prompt, args.n_new, num_beams=args.num_beams,
            eos_id=eos, pad_id=args.pad_id,
            length_penalty=args.length_penalty,
            prefill_chunk=args.prefill_chunk)
    else:
        out = gpt.generate(model, prompt, args.n_new, seed=args.seed,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, eos_id=eos, pad_id=args.pad_id,
                           prefill_chunk=args.prefill_chunk, mesh=mesh)
    if info.is_chief:
        for row in out.cpu().tolist():
            print(",".join(str(int(t)) for t in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
