"""One rank of the port's 2-rank gloo checks (``tests/test_torch_multirank.py``).

    python tests/_torch_multirank_worker.py RANK WORLD STORE_FILE OUT_DIR

Imports torch, numpy and the port only (the parent holds the JAX side).
Each rank joins a gloo group through ``file://STORE_FILE`` and writes
``OUT_DIR/rank{RANK}.pt``; the parent compares. The cases and their
inputs are built here, from seeds, for the parent and the ranks alike.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dtf_tpu_torch import convert, optim  # noqa: E402
from dtf_tpu_torch.core import train as ttr  # noqa: E402
from dtf_tpu_torch.core.sharding import make_layout  # noqa: E402
from dtf_tpu_torch.data.synthetic import SyntheticData  # noqa: E402
from dtf_tpu_torch.models import gpt as tgpt  # noqa: E402
from dtf_tpu_torch.models import mnist as tmnist  # noqa: E402

STEPS = 3
GPT_SEQ, GPT_BATCH = 16, 4
MNIST_BATCH = 8
#: ignored labels a step on each rank's rows: rank 0 holds rows 0-1 of
#: the global batch, rank 1 rows 2-3 (unequal counts, so a mean of the
#: ranks' means would differ from the global mean)
IGNORED = ((0, 11), (2, 3))

#: name → (model, grad_accum, grad_shard, zero1, dropout)
CASES = {
    "gpt": ("gpt", 1, False, True, 0.0),
    "gpt_nozero1": ("gpt", 1, False, False, 0.0),
    "gpt_accum2_grad_shard": ("gpt", 2, True, True, 0.0),
    "gpt_dropout": ("gpt", 1, False, True, 0.1),
    # (g) each microbatch the global batch's rows: the dropout masks
    "gpt_accum2_dropout": ("gpt", 2, False, True, 0.1),
    "mlp": ("mlp", 1, False, True, 0.0),
    "mlp_nozero1": ("mlp", 1, False, False, 0.0),
    "mlp_accum2_grad_shard": ("mlp", 2, True, True, 0.0),
}


class Args:
    """The launcher's optimizer flags for GPT (cosine with warmup)."""
    learning_rate, lr_schedule, warmup_steps = 1e-2, "cosine", -1
    lr_min_ratio, train_steps, clip_grad_norm = 0.1, 10, 1.0


def gpt_batches():
    data = SyntheticData("gpt", GPT_BATCH, seed=3, seq_len=GPT_SEQ,
                         vocab_size=128)
    out = []
    for i in range(STEPS):
        b = data.batch(i)
        for row, n in IGNORED:
            b["labels"][row, :n] = -100
        out.append(b)
    return out


def mnist_batches():
    data = SyntheticData("mnist", MNIST_BATCH, seed=5)
    return [data.batch(i) for i in range(STEPS)]


def gpt_tree(dropout=0.0):
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32, dropout=dropout)
    return cfg, convert.init_params_flax(cfg, seed=1)


def mlp_tree():
    return convert.init_params_mnist(tmnist.MLP(device="cpu"), seed=2)


def port_run(name, mesh=None):
    """STEPS steps of case ``name`` on this rank's rows (all of them
    without a mesh): (losses, grad_norms, whole params, opt_state)."""
    kind, accum, grad_shard, zero1, dropout = CASES[name]
    if kind == "gpt":
        cfg, tree = gpt_tree(dropout)
        model = tgpt.GPT(cfg, device="cpu")
        loss_fn = tgpt.make_loss(model, mesh=mesh)
        tx = optim.wrap_optimizer(optim.adamw(
            optim.make_lr_schedule(Args), weight_decay=0.1), Args)
        batches = gpt_batches()
    else:
        model, tree = tmnist.MLP(device="cpu"), mlp_tree()
        loss_fn = tmnist.make_loss(model)
        tx = optim.sgd(0.1)
        batches = mnist_batches()
    model.load_state_dict(convert.params_from_flax(tree))
    params = dict(model.named_parameters())
    layout = (make_layout(params, mesh, zero1=zero1) if mesh is not None
              else None)
    state = ttr.create_train_state(model, tx, 7, mesh=mesh, layout=layout)
    step = ttr.make_train_step(loss_fn, tx, grad_accum=accum, mesh=mesh,
                               grad_shard=grad_shard)
    losses, norms = [], []
    for b in batches:
        if mesh is not None:
            lo, hi = mesh.host_view.batch_rows(len(next(iter(b.values()))))
            b = {k: v[lo:hi] for k, v in b.items()}
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    whole = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return {"losses": losses, "norms": norms, "params": whole,
            "opt_state": state.opt_state,
            "zero1_dims": dict(layout.zero1_dims) if layout else {}}


def lookup_inputs():
    """A table [R, D], ids with duplicates and ids in both halves, and a
    cotangent for the rows."""
    rng = np.random.default_rng(11)
    table = rng.standard_normal((40, 6)).astype(np.float32)
    ids = rng.integers(0, 40, (5, 7)).astype(np.int32)
    ids[0, :3] = 21                                # duplicates
    ids[1, 0], ids[1, 1] = 0, 39
    cot = rng.standard_normal((5, 7, 6)).astype(np.float32)
    return table, ids, cot


#: the tiny Wide&Deep of check (b): 3 features of 8 buckets (24 table
#: rows, 12 a rank), 4-wide deep embeddings
WD_SPARSE, WD_BUCKETS, WD_EMBED = 3, 8, 4
WD_DTYPES = (torch.float32, torch.bfloat16)


def widedeep_model(dtype, mesh=None):
    from dtf_tpu_torch.models.widedeep import WideDeep

    return WideDeep(num_sparse=WD_SPARSE, hash_buckets=WD_BUCKETS,
                    embed_dim=WD_EMBED, mlp=(8,), dtype=dtype, device="cpu",
                    mesh=mesh)


def widedeep_inputs():
    """The tiny Wide&Deep's whole tables (wide [24, 1], deep [24, 4], the
    trainer's init), bucket ids [6, 3] with a repeated row, and a
    cotangent for each table's rows."""
    tree = convert.init_params_widedeep(widedeep_model(torch.float32), 13)
    rng = np.random.default_rng(14)
    sparse = rng.integers(0, WD_BUCKETS, (6, WD_SPARSE)).astype(np.int32)
    sparse[1] = sparse[0]                          # every id twice
    sparse[2, 0] = sparse[0, 0]                    # one id 3 times
    cots = [rng.standard_normal((6, WD_SPARSE, w)).astype(np.float32)
            for w in (1, WD_EMBED)]
    return ([tree["embed_tables_wide"]["embedding"],
             tree["embed_tables_deep"]["embedding"]], sparse, cots)


def widedeep_lookup_run(mesh, rank, world):
    """The tiny Wide&Deep's two tables row-sharded over the model axis,
    per dtype: the grouped lookup the model's forward takes
    (``lookup_tables``) and, independent of it, the per-table composite
    it replaces (each shard cast, ``masked_lookup`` with the
    plain-contract ``gather_rows``, the sum over the shards) — outputs
    and this rank's table gradients of both."""
    from dtf_tpu_torch.ops.embed_gather import gather_rows
    from dtf_tpu_torch.parallel.embedding import _SumOverShards, \
        lookup_tables, masked_lookup

    tables, sparse, cots = widedeep_inputs()
    rows = tables[0].shape[0] // world
    got = {}
    for dtype in WD_DTYPES:
        model = widedeep_model(dtype, mesh)
        embeds = (model.embed_tables_wide, model.embed_tables_deep)
        with torch.no_grad():
            for e, t in zip(embeds, tables):
                e.weight.copy_(torch.from_numpy(
                    t[rank * rows:(rank + 1) * rows]))
        flat = model.flat_ids(torch.from_numpy(sparse))
        weights = [e.weight for e in embeds]
        runs = {}
        for name, fn in (
                ("grouped", lambda: lookup_tables(embeds, flat)),
                ("per_table", lambda: [_SumOverShards.apply(masked_lookup(
                    e.weight.to(e.dtype), flat, rank, gather_fn=gather_rows),
                    mesh.model_group) for e in embeds])):
            outs = fn()
            loss = sum((o.float() * torch.from_numpy(c)).sum()
                       for o, c in zip(outs, cots))
            grads = torch.autograd.grad(loss, weights)
            runs[name] = ([o.detach() for o in outs], list(grads))
        got[str(dtype)] = runs
    return got


#: the tiny ResNets of the CPU tests and check (f): stage sizes (1, 1),
#: 4 filters, 5 classes, batch 4 (2 rows a rank)
RN_STAGES, RN_FILTERS, RN_CLASSES, RN_BATCH = (1, 1), 4, 5, 4


def resnet_tiny(stem, block, group=None):
    from dtf_tpu_torch.models import resnet

    return resnet.ResNet(RN_STAGES, getattr(resnet, block), RN_CLASSES,
                         num_filters=RN_FILTERS, stem=stem,
                         dtype=torch.float32, device="cpu", group=group)


def resnet_vars(model, seed):
    """The trainer's init with every BatchNorm scale, bias and running
    statistic drawn away from its constant (no dead branch)."""
    tree = convert.init_params_resnet(model, seed)
    rng = np.random.default_rng(seed + 100)

    def draw(path, v):
        leaf = path[-1]
        if leaf == "scale":
            return (1.0 + 0.3 * rng.standard_normal(v.shape)).astype(v.dtype)
        if leaf in ("bias", "mean") and path[0] != "head":
            return (0.2 * rng.standard_normal(v.shape)).astype(v.dtype)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        return v

    return {col: convert._unflatten((p, draw(p, v)) for p, v in
                                    convert._flatten(tree[col]))
            for col in tree}


def load_resnet(model, tree):
    model.load_state_dict({**convert.params_from_flax(tree["params"]),
                           **convert.stats_from_flax(tree["batch_stats"])})


#: check (f): the tiny ResNets with synchronised BatchNorm over the data
#: axis, 16×16 images, the launcher's recipe with a loss-side L2
RN_CASES = (("cifar", "BasicBlock"), ("imagenet", "BottleneckBlock"))
RN_SIZE, RN_L2 = 16, 1e-2


def resnet_batches():
    rng = np.random.default_rng(21)
    return [{"image": rng.standard_normal(
                (RN_BATCH, RN_SIZE, RN_SIZE, 3)).astype(np.float32),
             "label": rng.integers(0, RN_CLASSES, (RN_BATCH,)).astype(
                 np.int32)} for _ in range(STEPS)]


def resnet_run(stem, block, mesh=None, accum=1):
    """On this rank's rows (all of them without a mesh), BatchNorm over
    the data group: the loss, the running statistics and the gradients
    (averaged over the data group, as the step does) of one forward at
    the initial variables; then STEPS train steps (nesterov SGD, ZeRO-1
    over a mesh, ``accum`` microbatches): losses, grad_norms, whole
    parameters and buffers."""
    from dtf_tpu_torch.core import comms
    from dtf_tpu_torch.models import resnet

    group = mesh.data_group if mesh is not None else None
    model = resnet_tiny(stem, block, group=group)
    tree = resnet_vars(model, 5)
    batches = resnet_batches()
    if mesh is not None:
        lo, hi = mesh.host_view.batch_rows(RN_BATCH)
        batches = [{k: v[lo:hi] for k, v in b.items()} for b in batches]
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in batches]
    load_resnet(model, tree)
    params = dict(model.named_parameters())
    loss_fn = resnet.make_loss(model, weight_decay=RN_L2)
    loss, _ = loss_fn(params, batches[0], 0)
    grads = torch.autograd.grad(loss, list(params.values()))
    if mesh is not None:
        loss = comms.pmean(loss.detach(), group)
        grads = [comms.pmean(g, group) for g in grads]
    first = {"loss": float(loss.detach()), "grads": dict(zip(params, grads)),
             "stats": {n: b.clone() for n, b in model.named_buffers()}}

    load_resnet(model, tree)
    layout = (make_layout(params, mesh, zero1=True) if mesh is not None
              else None)
    tx = optim.sgd(0.1, momentum=0.9, nesterov=True)
    state = ttr.create_train_state(model, tx, 0, mesh=mesh, layout=layout)
    step = ttr.make_train_step(loss_fn, tx, grad_accum=accum, mesh=mesh,
                               model=model)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"first": first, "losses": losses, "norms": norms,
            "params": {n: p.detach().clone()
                       for n, p in state.params.items()},
            "extra": {n: t.clone() for n, t in state.extra.items()},
            "zero1_dims": dict(layout.zero1_dims) if layout else {}}


#: check (i): BERT (BASELINE config 4 in small: ZeRO-1, --grad_accum 2),
#: wide enough that adafactor factors (hidden 128, vocab 256: the
#: 256 × 128 table, 128 × 128, 256 × 128 and 128 × 256 kernels; the
#: 32 × 128 position table does not), dropout 0, f32, 4 rows of 16 tokens
#: (1 a rank a microbatch), one row's tail padded; each optimizer from
#: the launcher's flags
BERT_KW = dict(vocab_size=256, hidden=128, layers=2, heads=4,
               intermediate=256, max_positions=32, dropout=0.0)
BERT_BATCH, BERT_SEQ, BERT_ACCUM = 4, 16, 2
BERT_OPTIMIZERS = ("adamw", "lamb", "adafactor")


def bert_args(optimizer):
    return argparse.Namespace(
        learning_rate=1e-2, lr_schedule="cosine", warmup_steps=-1,
        lr_min_ratio=0.1, train_steps=10, optimizer=optimizer,
        weight_decay=0.01, clip_grad_norm=0.0)


def bert_tree():
    from dtf_tpu_torch.models import bert

    return convert.init_params_bert(bert.BertMLM(bert.BertConfig(
        dtype=torch.float32, **BERT_KW), device="cpu"), 8)


def bert_batches():
    data = SyntheticData("bert", BERT_BATCH, seed=9, seq_len=BERT_SEQ,
                         vocab_size=BERT_KW["vocab_size"])
    out = []
    for i in range(STEPS):
        b = data.batch(i)
        b["attention_mask"][1, 11:] = 0
        out.append(b)
    return out


def _flat_tensors(tree, prefix=""):
    if torch.is_tensor(tree):
        return {prefix: tree}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree)
             if isinstance(tree, (list, tuple)) else ())
    out = {}
    for k, v in items:
        out.update(_flat_tensors(v, f"{prefix}/{k}"))
    return out


def bert_run(optimizer, mesh=None, ckpt_dir=None):
    """STEPS steps of the tiny BERT with ``optimizer``, ZeRO-1 over a
    mesh, on this rank's rows: losses, grad_norms, whole parameters,
    the ZeRO-1 dims and the optimizer state. ``ckpt_dir``: the state is
    then saved there and restored into a fresh one, whose optimizer
    state must equal this rank's bit for bit (``restored_equal``)."""
    from dtf_tpu_torch.models import bert

    model = bert.BertMLM(bert.BertConfig(dtype=torch.float32, **BERT_KW),
                         device="cpu")
    model.load_state_dict(convert.params_from_flax(bert_tree()))
    tx = optim.make_optimizer(bert_args(optimizer), recipe=None)
    layout = (make_layout(dict(model.named_parameters()), mesh, zero1=True)
              if mesh is not None else None)
    state = ttr.create_train_state(model, tx, 7, mesh=mesh, layout=layout)
    step = ttr.make_train_step(bert.make_loss(model, mesh=mesh), tx,
                               grad_accum=BERT_ACCUM, mesh=mesh)
    losses, norms = [], []
    for b in bert_batches():
        if mesh is not None:
            lo, hi = mesh.host_view.batch_rows(BERT_BATCH)
            b = {k: v[lo:hi] for k, v in b.items()}
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out = {"losses": losses, "norms": norms,
           "params": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
           "zero1_dims": dict(layout.zero1_dims) if layout else {},
           "opt_state": state.opt_state}
    if ckpt_dir is not None:
        from dtf_tpu_torch.checkpoint import Checkpointer

        ckpt = Checkpointer(ckpt_dir, mesh=mesh)
        ckpt.save(STEPS, state, force=True)
        fresh = ttr.create_train_state(model, tx, 7, mesh=mesh, layout=layout)
        back = _flat_tensors(ckpt.restore(fresh, STEPS).opt_state)
        mine = _flat_tensors(state.opt_state)
        out["restored_equal"] = set(back) == set(mine) and all(
            torch.equal(back[k], v) for k, v in mine.items())
    return out


#: check (e): the tiny Wide&Deep trained with its tables over the model
#: axis and global-norm clipping on (the clip far below the norm, so
#: every step clips)
WD_TRAIN_BATCH, WD_LR, WD_CLIP = 8, 1e-2, 0.05


class WdArgs:
    clip_grad_norm = WD_CLIP


def widedeep_tree():
    return convert.init_params_widedeep(widedeep_model(torch.float32), 13)


def widedeep_batches():
    data = SyntheticData("widedeep", WD_TRAIN_BATCH, seed=6,
                         hash_buckets=WD_BUCKETS, num_sparse=WD_SPARSE)
    return [data.batch(i) for i in range(STEPS)]


def widedeep_train_run(mesh=None):
    """STEPS Adam steps of the tiny f32 Wide&Deep, clipped at WD_CLIP,
    every rank on the whole batch (the data axis is 1): losses,
    grad_norms and the whole parameters (the tables gathered)."""
    from dtf_tpu_torch.models import widedeep

    model = widedeep_model(torch.float32, mesh)
    full = convert.params_from_flax(widedeep_tree())
    layout = (make_layout(dict(model.named_parameters()), mesh,
                          widedeep.rules, zero1=True)
              if mesh is not None else None)
    model.load_state_dict(full if layout is None else {
        n: layout.shard_param(n, t, mesh) for n, t in full.items()})
    tx = optim.wrap_optimizer(optim.adam(WD_LR), WdArgs)
    state = ttr.create_train_state(model, tx, 7, mesh=mesh, layout=layout)
    step = ttr.make_train_step(widedeep.make_loss(model), tx, mesh=mesh)
    losses, norms = [], []
    for b in widedeep_batches():
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    whole = {n: (layout.gather_param(n, p.detach(), mesh) if layout
                 else p.detach().clone()) for n, p in state.params.items()}
    return {"losses": losses, "norms": norms, "params": whole,
            "model_dims": dict(layout.model_dims) if layout else {}}


def ce_inputs():
    """x [N, D], W [V, D], labels with ignored positions unequal per
    rank half."""
    rng = np.random.default_rng(12)
    n, d, v = 24, 16, 40
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, (n,)).astype(np.int64)
    labels[:7] = -100
    labels[n // 2:n // 2 + 2] = -100
    return x, w, labels


def comms_input(rank):
    """Rank ``rank``'s [3, 4, 2] operand of the collectives' check."""
    return torch.arange(24, dtype=torch.float32).reshape(3, 4, 2) \
        * (rank + 1)


def dropout_inputs():
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32, dropout=0.5)
    ids = gpt_batches()[0]["input_ids"]
    return cfg, convert.init_params_flax(cfg, seed=4), ids


def dropout_run(cfg, tree, ids, key):
    model = tgpt.GPT(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree))
    with torch.no_grad():
        return model(torch.from_numpy(ids), dropout_seed=key)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("store")
    p.add_argument("out")
    a = p.parse_args()
    torch.set_num_threads(1)
    import torch.distributed as dist

    from dtf_tpu_torch.core.mesh import MeshConfig, make_mesh
    from dtf_tpu_torch.ops.fused_ce import fused_lm_cross_entropy
    from dtf_tpu_torch.parallel.embedding import masked_lookup_sharded

    dist.init_process_group("gloo", init_method=f"file://{a.store}",
                            world_size=a.world, rank=a.rank)
    cpu = torch.device("cpu")
    out = {}
    # (a) the train steps over the data axis
    data_mesh = make_mesh(MeshConfig(data=a.world), cpu)
    out["train"] = {name: port_run(name, data_mesh) for name in CASES}

    # (b) the row-sharded lookup over the model axis
    model_mesh = make_mesh(MeshConfig(model=a.world), cpu)
    table, ids, cot = lookup_inputs()
    rows = table.shape[0] // a.world
    shard = torch.from_numpy(table[a.rank * rows:(a.rank + 1) * rows]
                             ).requires_grad_()
    got = {}
    for kernel in (False, True):
        y = masked_lookup_sharded(shard, torch.from_numpy(ids),
                                  model_mesh.model_group, use_kernel=kernel)
        (g,) = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), shard)
        got[kernel] = (y.detach(), g)
    out["lookup"] = got
    out["widedeep_lookup"] = widedeep_lookup_run(model_mesh, a.rank, a.world)

    # (c) the token-sharded fused CE over the data axis
    x, w, labels = ce_inputs()
    lo, hi = data_mesh.host_view.batch_rows(len(x))
    xt = torch.from_numpy(x[lo:hi]).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    mean, n = fused_lm_cross_entropy(xt, wt, torch.from_numpy(labels[lo:hi]),
                                     ignore_index=-100, mesh=data_mesh)
    dx, dw = torch.autograd.grad(mean, (xt, wt))
    dist.all_reduce(dw)
    out["ce"] = {"mean": mean.detach(), "n": n, "dx": dx, "dw": dw}

    # (e) the row-sharded tables' train step with clipping on
    out["widedeep_train"] = widedeep_train_run(model_mesh)

    # (f) ResNet, its BatchNorm synchronised over the data axis
    out["resnet"] = {f"{stem}-{block}": resnet_run(stem, block, data_mesh)
                     for stem, block in RN_CASES}
    # (h) each microbatch the global batch's rows: BatchNorm's statistics
    out["resnet_accum2"] = {f"{stem}-{block}": resnet_run(
        stem, block, data_mesh, accum=2) for stem, block in RN_CASES}
    # (i) BERT under ZeRO-1 and grad_accum 2, three optimizers
    out["bert"] = {name: bert_run(
        name, data_mesh, ckpt_dir=os.path.join(os.path.dirname(a.store),
                                               f"ckpt_{name}"))
        for name in BERT_OPTIMIZERS}

    # the collectives over a group, on a dim other than the first
    from dtf_tpu_torch.core import comms

    x = comms_input(a.rank)
    out["comms"] = {
        "psum": comms.psum(x, data_mesh.data_group),
        "pmean": comms.pmean(x, data_mesh.data_group),
        "psum_scatter": comms.psum_scatter(x, data_mesh.data_group,
                                           scatter_dimension=1),
        "all_gather": comms.all_gather(x, data_mesh.data_group,
                                       gather_dimension=1)}

    # (d) the dropout masks: this rank's rows of the global masks
    cfg, tree, ids = dropout_inputs()
    lo, hi = data_mesh.host_view.batch_rows(len(ids))
    out["dropout"] = dropout_run(cfg, tree, ids[lo:hi],
                                 tgpt.DropoutKey(5, a.rank, a.world))
    torch.save(out, os.path.join(a.out, f"rank{a.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
