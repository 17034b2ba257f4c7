"""Carry weights between the JAX package's flax param tree and the port.

The flax tree is nested dicts of arrays (``token_embed/embedding``,
``layer_{i}/attention/{query,key,value,attn_out}/{kernel,bias}``,
``layer_{i}/{ln1,ln2}/{scale,bias}``, ``layer_{i}/{mlp_in,mlp_out}/...``,
``ln_f/...``, ``lm_head/kernel``). The port names its modules the same, so
a flax path ``a/b/leaf`` is the ``state_dict`` key ``a.b.<param>``:
``kernel`` → ``weight`` transposed (flax kernels are [in, out], torch
weights [out, in]; a flax convolution's [kh, kw, in, out] is torch's
[out, in, kh, kw]); ``embedding`` and ``scale`` (LayerNorm's, BatchNorm's)
→ ``weight``; ``bias`` → ``bias``. Both directions copy values exactly.
BatchNorm's running statistics (flax's ``batch_stats`` collection,
``.../mean`` and ``.../var``) are the module's buffers of those names:
:func:`stats_from_flax`, :func:`stats_to_flax`.

:func:`shard_params` takes a rank's blocks of a whole tree for a
tensor-parallel model.

``.npz`` files hold the flax tree with flat ``/``-joined keys, so either
package can read them. :func:`init_params` makes a seeded GPT-2-style
tree in numpy, for handing the same weights to both packages (serving);
:func:`init_params_flax` one with the JAX package's training init
distributions (the trainer's); :func:`init_params_widedeep` the same for
Wide&Deep (``embed_tables_{wide,deep}/embedding``, ``wide_dense``,
``mlp_{i}``, ``deep_out``); :func:`init_params_mnist` for the MNIST
models (``hidden_{i}``, ``logits``); :func:`init_params_resnet` the
ResNets' variables (``params`` and ``batch_stats``); :func:`init_params_bert`
BERT's tree (the tied ``token_embed/embedding`` once, ``pos_embed``,
``seg_embed``, ``layer_{i}/{attention,ln_attn,mlp_in,mlp_out,ln_mlp}``,
``mlm_dense``, ``ln_mlm`` and the top-level leaf ``mlm_bias``, which is the
model's own parameter of that name).
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def _unflatten(items) -> dict:
    tree: dict = {}
    for path, val in items:
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = val
    return tree


def params_from_flax(tree) -> "OrderedDict[str, torch.Tensor]":
    """The flax param tree (optionally wrapped as ``{"params": ...}``) as
    the port's ``state_dict`` of f32 CPU tensors."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = OrderedDict()
    for path, val in _flatten(tree):
        arr = np.asarray(val)
        *mods, leaf = path
        if leaf == "kernel":
            if arr.ndim not in _KERNEL_FROM_FLAX:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D kernel "
                                 f"(or a 4-D convolution's), got shape "
                                 f"{arr.shape}")
            name, arr = "weight", arr.transpose(_KERNEL_FROM_FLAX[arr.ndim])
        elif leaf in ("embedding", "scale"):
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        elif not mods:
            name = leaf            # a leaf of the model itself: mlm_bias
        else:
            raise KeyError(f"unknown flax param leaf {'/'.join(path)}")
        out[".".join(mods + [name])] = torch.from_numpy(
            np.array(arr, copy=True, order="C"))
    return out


def _is_embedding(module: str) -> bool:
    """A module whose 2-D ``weight`` is a flax ``embedding``, not a
    transposed ``kernel``: GPT's and BERT's ``token_embed``, BERT's
    ``pos_embed`` and ``seg_embed``, and Wide&Deep's ``embed_tables_*``
    (``RowShardedEmbed``)."""
    return (module in ("token_embed", "pos_embed", "seg_embed")
            or module.startswith("embed_tables"))


#: flax kernel [in, out] / [kh, kw, in, out] → torch weight: the flax
#: dims in torch's order ([out, in] / [out, in, kh, kw])
_KERNEL_FROM_FLAX = {2: (1, 0), 4: (3, 2, 0, 1)}
#: torch weight → flax kernel: the torch dims in flax's order
_KERNEL_TO_FLAX = {2: (1, 0), 4: (2, 3, 1, 0)}


def is_kernel(name: str, ndim: int) -> bool:
    """Whether the ``state_dict`` entry ``name`` is a flax ``kernel``,
    stored transposed: a 2-D ``weight`` that is not an embedding, or a
    4-D (convolution) ``weight``."""
    *mods, leaf = name.split(".")
    return bool(mods) and leaf == "weight" and (ndim == 4 or (
        ndim == 2 and not _is_embedding(mods[-1])))


def flax_dims(name: str, ndim: int) -> tuple:
    """The dims of the port's tensor ``name`` in the order of its flax
    leaf: a kernel's transposition (:func:`is_kernel`), else as they
    are."""
    if is_kernel(name, ndim):
        return _KERNEL_TO_FLAX[ndim]
    return tuple(range(ndim))


def shard_params(state_dict, layout, mesh) -> "OrderedDict[str, torch.Tensor]":
    """This rank's blocks of a whole ``state_dict`` (a converted flax tree,
    a checkpoint's parameters) over ``mesh``'s model axis: each tensor
    through ``layout.shard_param``
    (:class:`dtf_tpu_torch.core.sharding.Layout`), contiguous, for
    ``load_state_dict`` of a tensor-parallel model."""
    return OrderedDict((n, layout.shard_param(n, t, mesh).contiguous())
                       for n, t in state_dict.items())


def params_to_flax(state_dict) -> dict:
    """The inverse of :func:`params_from_flax`: nested dicts of numpy."""
    items = []
    for key, val in state_dict.items():
        arr = val.detach().cpu().numpy()
        *mods, name = key.split(".")
        if not mods:
            leaf = name                          # BERT's mlm_bias
        elif name == "bias":
            leaf = "bias"
        elif name != "weight":
            raise KeyError(f"unknown state_dict entry {key}")
        elif arr.ndim == 1:
            leaf = "scale"                      # a LayerNorm
        elif is_kernel(key, arr.ndim):
            leaf, arr = "kernel", arr.transpose(_KERNEL_TO_FLAX[arr.ndim])
        else:
            leaf = "embedding"
        items.append((tuple(mods) + (leaf,), np.ascontiguousarray(arr)))
    return _unflatten(items)


def stats_from_flax(tree) -> "OrderedDict[str, torch.Tensor]":
    """flax's ``batch_stats`` tree (optionally wrapped as
    ``{"batch_stats": ...}``) as the port's buffers, ``a.b.mean`` and
    ``a.b.var``, f32 CPU tensors."""
    if set(tree) == {"batch_stats"}:
        tree = tree["batch_stats"]
    out = OrderedDict()
    for path, val in _flatten(tree):
        if path[-1] not in ("mean", "var"):
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        out[".".join(path)] = torch.from_numpy(
            np.array(np.asarray(val), copy=True, order="C"))
    return out


def stats_to_flax(buffers) -> dict:
    """The inverse of :func:`stats_from_flax`: nested dicts of numpy."""
    return _unflatten((tuple(k.split(".")),
                       np.ascontiguousarray(v.detach().cpu().numpy()))
                      for k, v in buffers.items())


def save_npz(path: str, tree: dict) -> None:
    """Write a flax-style tree as one ``.npz`` with ``/``-joined keys."""
    flat = {"/".join(p): np.asarray(v) for p, v in _flatten(tree)}
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_npz(path: str) -> dict:
    """Read :func:`save_npz`'s file back into a nested tree."""
    with np.load(path) as z:
        return _unflatten((tuple(k.split("/")), z[k]) for k in z.files)


def init_params(cfg, seed: int) -> dict:
    """A seeded GPT-2-style flax tree in numpy f32: N(0, 0.02) embedding,
    projections and head; the two residual projections (attn_out,
    mlp_out) at 0.02/sqrt(2·layers); zero biases; LayerNorm scale 1."""
    rng = np.random.default_rng(seed)
    d, dh = cfg.d_model, cfg.d_model // cfg.heads
    std, res_std = 0.02, 0.02 / math.sqrt(2 * cfg.layers)

    def normal(shape, s):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(s)

    def dense(d_in, d_out, s):
        return {"kernel": normal((d_in, d_out), s),
                "bias": np.zeros((d_out,), np.float32)}

    def norm():
        return {"scale": np.ones((d,), np.float32),
                "bias": np.zeros((d,), np.float32)}

    tree = {"token_embed": {"embedding": normal((cfg.vocab_size, d), std)}}
    for i in range(cfg.layers):
        tree[f"layer_{i}"] = {
            "ln1": norm(),
            "attention": {
                "query": dense(d, cfg.heads * dh, std),
                "key": dense(d, cfg.kv_heads_resolved * dh, std),
                "value": dense(d, cfg.kv_heads_resolved * dh, std),
                "attn_out": dense(cfg.heads * dh, d, res_std)},
            "ln2": norm(),
            "mlp_in": dense(d, cfg.d_ff, std),
            "mlp_out": dense(cfg.d_ff, d, res_std)}
    tree["ln_f"] = norm()
    tree["lm_head"] = {"kernel": normal((d, cfg.vocab_size), std)}
    return tree


#: flax's lecun_normal: a standard normal truncated to [-2, 2], rescaled by
#: this constant (its std) so the kernel's std is exactly 1/sqrt(fan_in)
_TRUNC_NORMAL_STD = 0.87962566103423978


def _lecun_normal(rng, d_in: int, d_out: int) -> np.ndarray:
    """flax's lecun_normal [d_in, d_out] kernel, drawn with numpy."""
    x = rng.standard_normal((d_in, d_out), dtype=np.float32)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(x) > 2.0
    return x * np.float32(1.0 / (math.sqrt(d_in) * _TRUNC_NORMAL_STD))


def init_params_flax(cfg, seed: int) -> dict:
    """A seeded flax tree in numpy f32 with the JAX package's TRAINING
    init distributions (``gpt.make_init``): the ``nn.Embed`` table normal
    at std 1/sqrt(d_model); every ``TpDense`` kernel and ``lm_head``
    lecun-normal — truncated at ±2σ and rescaled to std 1/sqrt(fan_in), so
    |w| <= 2.27/sqrt(fan_in); zero biases; LayerNorm scale 1, bias 0. The
    draws are numpy's, not flax's PRNG bits: the distributions match."""
    rng = np.random.default_rng(seed)
    d, dh = cfg.d_model, cfg.d_model // cfg.heads

    def dense(d_in, d_out):
        return {"kernel": _lecun_normal(rng, d_in, d_out),
                "bias": np.zeros((d_out,), np.float32)}

    def norm():
        return {"scale": np.ones((d,), np.float32),
                "bias": np.zeros((d,), np.float32)}

    embed = rng.standard_normal((cfg.vocab_size, d), dtype=np.float32)
    tree = {"token_embed": {"embedding": embed * np.float32(d ** -0.5)}}
    for i in range(cfg.layers):
        tree[f"layer_{i}"] = {
            "ln1": norm(),
            "attention": {
                "query": dense(d, cfg.heads * dh),
                "key": dense(d, cfg.kv_heads_resolved * dh),
                "value": dense(d, cfg.kv_heads_resolved * dh),
                "attn_out": dense(cfg.heads * dh, d)},
            "ln2": norm(),
            "mlp_in": dense(d, cfg.d_ff),
            "mlp_out": dense(cfg.d_ff, d)}
    tree["ln_f"] = norm()
    tree["lm_head"] = {"kernel": _lecun_normal(rng, d, cfg.vocab_size)}
    return tree


def init_params_widedeep(model, seed: int) -> dict:
    """A seeded flax tree in numpy f32 for a
    :class:`~dtf_tpu_torch.models.widedeep.WideDeep` with the JAX
    package's init distributions (``widedeep.make_init``): each table
    ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)`` — for a
    [R, E] table an untruncated normal with std 1/sqrt(E) (1.0 for the
    wide table, 0.25 for a 16-wide deep one); every ``Dense`` kernel
    lecun-normal; zero biases. numpy's draws, not flax's PRNG bits: the
    distributions match."""
    rng = np.random.default_rng(seed)
    rows = model.num_sparse * model.hash_buckets

    def table(width):
        x = rng.standard_normal((rows, width), dtype=np.float32)
        return {"embedding": x * np.float32(width ** -0.5)}

    def dense(d_in, d_out):
        return {"kernel": _lecun_normal(rng, d_in, d_out),
                "bias": np.zeros((d_out,), np.float32)}

    tree = {"embed_tables_wide": table(1),
            "wide_dense": dense(model.wide_dense.weight.shape[1], 1),
            "embed_tables_deep": table(model.embed_dim)}
    width = model.num_sparse * model.embed_dim + \
        model.wide_dense.weight.shape[1]
    for i, h in enumerate(model.mlp):
        tree[f"mlp_{i}"] = dense(width, h)
        width = h
    tree["deep_out"] = dense(width, 1)
    return tree


def init_params_mnist(model, seed: int) -> dict:
    """A seeded flax tree in numpy f32 for a
    :class:`~dtf_tpu_torch.models.mnist.SoftmaxRegression` or ``MLP``
    with the JAX package's init (``mnist.make_init``: flax ``Dense``'s
    lecun-normal kernels, zero biases); numpy's draws."""
    rng = np.random.default_rng(seed)
    tree, width = {}, model.input_dim
    for i, h in enumerate(model.hidden):
        tree[f"hidden_{i}"] = {"kernel": _lecun_normal(rng, width, h),
                               "bias": np.zeros((h,), np.float32)}
        width = h
    tree["logits"] = {"kernel": _lecun_normal(rng, width, model.num_classes),
                      "bias": np.zeros((model.num_classes,), np.float32)}
    return tree


def init_params_resnet(model, seed: int) -> dict:
    """Seeded flax variables ``{"params": ..., "batch_stats": ...}`` in
    numpy f32 for a :class:`~dtf_tpu_torch.models.resnet.ResNet` with the
    JAX package's init (``resnet.make_init``): every convolution kernel
    [kh, kw, in, out] lecun-normal over fan-in kh·kw·in, the head's kernel
    lecun-normal; BatchNorm scale 1 — 0 on each block's last BatchNorm
    (``scale_init=zeros``) — and bias 0; running mean 0 and variance 1;
    head bias 0. numpy's draws, in the modules' order: the distributions
    match, not flax's PRNG bits."""
    from dtf_tpu_torch.models.resnet import BatchNorm, Conv

    rng = np.random.default_rng(seed)
    params, stats = [], []
    for name, mod in model.named_modules():
        path = tuple(name.split("."))
        if isinstance(mod, Conv):
            o, i, kh, kw = mod.weight.shape
            k = _lecun_normal(rng, kh * kw * i, o).reshape(kh, kw, i, o)
            params.append((path + ("kernel",), k))
        elif isinstance(mod, BatchNorm):
            c = mod.weight.shape[0]
            scale = np.full((c,), 0.0 if mod.zero_init else 1.0, np.float32)
            params += [(path + ("scale",), scale),
                       (path + ("bias",), np.zeros((c,), np.float32))]
            stats += [(path + ("mean",), np.zeros((c,), np.float32)),
                      (path + ("var",), np.ones((c,), np.float32))]
    d_out, d_in = model.head.weight.shape
    params += [(("head", "kernel"), _lecun_normal(rng, d_in, d_out)),
               (("head", "bias"), np.zeros((d_out,), np.float32))]
    return {"params": _unflatten(params), "batch_stats": _unflatten(stats)}


def init_params_bert(model, seed: int) -> dict:
    """A seeded flax tree in numpy f32 for a
    :class:`~dtf_tpu_torch.models.bert.BertMLM` with the JAX package's
    init (``bert.make_init``): the three ``nn.Embed`` tables normal at std
    1/sqrt(hidden) (flax's ``variance_scaling(1, fan_in, normal,
    out_axis=0)``), every ``Dense`` kernel lecun-normal, zero biases,
    LayerNorm scale 1 and bias 0, ``mlm_bias`` 0. numpy's draws, not
    flax's PRNG bits: the distributions match."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    h = cfg.hidden

    def embed(rows):
        x = rng.standard_normal((rows, h), dtype=np.float32)
        return {"embedding": x * np.float32(h ** -0.5)}

    def dense(d_in, d_out):
        return {"kernel": _lecun_normal(rng, d_in, d_out),
                "bias": np.zeros((d_out,), np.float32)}

    def norm():
        return {"scale": np.ones((h,), np.float32),
                "bias": np.zeros((h,), np.float32)}

    tree = {"token_embed": embed(cfg.vocab_size),
            "pos_embed": embed(cfg.max_positions),
            "seg_embed": embed(cfg.type_vocab), "ln_embed": norm()}
    for i in range(cfg.layers):
        tree[f"layer_{i}"] = {
            "attention": {n: dense(h, h) for n in
                          ("query", "key", "value", "attn_out")},
            "ln_attn": norm(), "mlp_in": dense(h, cfg.intermediate),
            "mlp_out": dense(cfg.intermediate, h), "ln_mlp": norm()}
    tree["mlm_dense"] = dense(h, h)
    tree["ln_mlm"] = norm()
    tree["mlm_bias"] = np.zeros((cfg.vocab_size,), np.float32)
    return tree
