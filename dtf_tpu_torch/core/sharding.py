"""Where each parameter's elements live on the mesh (counterpart of
``dtf_tpu.core.sharding``): the placement rules, and ZeRO-1's rule for
the optimizer state.

A rule is ``(regex over the state_dict name, spec)``, the spec naming a
mesh axis (or None) per dim of the port's own layout; the first rule
whose regex is found in the name places the parameter, and a parameter
no rule matches is replicated. A dim placed on ``model`` is row-sharded:
the rank's tensor holds its block of that dim
(:func:`dtf_tpu_torch.parallel.embedding.embedding_rules`).

ZeRO-1 (``_zero1_leaf_spec``): each parameter-shaped optimizer leaf, and
the gradient and update that feed it, is sharded over ``data`` on the
first free dim that the data size divides; a leaf with none stays
replicated. The dim is counted on the flax layout, where a kernel is
[in, out] (a convolution's [kh, kw, in, out]), and mapped onto the port's
transposed weight (:func:`dtf_tpu_torch.convert.flax_dims`), so a rank
holds the same elements as its JAX counterpart.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import torch

from dtf_tpu_torch.convert import flax_dims
from dtf_tpu_torch.core.comms import all_gather

Rule = tuple[str, tuple]


def param_specs(params: dict, rules: Sequence[Rule] = ()) -> dict:
    """{name: spec} over the port's layout; () for a replicated one."""
    out = {}
    for name, p in params.items():
        spec = next((s for pat, s in rules if re.search(pat, name)), ())
        if len(spec) > p.ndim:
            raise ValueError(f"rule spec {spec} has more dims than {name} "
                             f"{tuple(p.shape)}")
        out[name] = tuple(spec)
    return out


def zero1_leaf_dim(param_spec: tuple, shape: tuple, data_size: int,
                   axis: str = "data") -> Optional[int]:
    """The dim of ``shape`` ZeRO-1 shards over ``axis``: the first that
    ``param_spec`` leaves free and ``data_size`` divides; None when the
    data size is 1, the param is placed on ``axis`` already, or no dim
    divides. ``dtf_tpu.core.sharding._zero1_leaf_spec`` for a leaf that
    mirrors its param."""
    spec = list(param_spec) + [None] * (len(shape) - len(param_spec))
    if data_size <= 1 or axis in spec:
        return None
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and dim % data_size == 0 and dim >= data_size:
            return i
    return None


@dataclasses.dataclass(frozen=True)
class Layout:
    """Which dim of each parameter is split over which axis.
    ``model_dims``: the parameter's tensor is this rank's block of that
    dim over the model axis. ``zero1_dims``: its optimizer leaves,
    gradient and update are this rank's block of that dim (of the
    model-sharded tensor) over the data axis."""

    model_dims: dict
    zero1_dims: dict

    @staticmethod
    def _block(t: torch.Tensor, dim: int, index: int, count: int):
        n = t.shape[dim] // count
        return t.narrow(dim, index * n, n)

    def shard_param(self, name: str, full: torch.Tensor, mesh) -> torch.Tensor:
        """This rank's part of a whole parameter (a view)."""
        dim = self.model_dims.get(name)
        if dim is None:
            return full
        return self._block(full, dim, mesh.model_index, mesh.model_size)

    def shard_leaf(self, name: str, local: torch.Tensor, mesh) -> torch.Tensor:
        """This rank's ZeRO-1 block of a parameter-shaped tensor (a view)."""
        dim = self.zero1_dims.get(name)
        if dim is None:
            return local
        return self._block(local, dim, mesh.data_index, mesh.data_size)

    def gather_param(self, name: str, local: torch.Tensor, mesh):
        """The whole parameter from every model rank's block."""
        dim = self.model_dims.get(name)
        if dim is None:
            return local
        return all_gather(local, mesh.model_group, gather_dimension=dim)

    def gather_leaf(self, name: str, shard: torch.Tensor, mesh):
        """The rank's (model-sharded) tensor from every data rank's
        ZeRO-1 block."""
        dim = self.zero1_dims.get(name)
        if dim is None:
            return shard
        return all_gather(shard, mesh.data_group, gather_dimension=dim)


def make_layout(params: dict, mesh, rules: Sequence[Rule] = (), *,
                zero1: bool = False) -> Layout:
    """The layout of ``params`` (this rank's tensors) on ``mesh``: the
    rules' model dims, and with ``zero1`` the ZeRO-1 dims, counted on the
    whole parameter's flax layout."""
    specs = param_specs(params, rules)
    model_dims, zero1_dims = {}, {}
    for name, p in params.items():
        spec = specs[name]
        bad = [a for a in spec if a not in (None, "model")]
        if bad:
            raise NotImplementedError(f"{name}: placement on {bad} is not "
                                      "yet ported (data and model only)")
        shape = list(p.shape)
        if "model" in spec:
            dim = spec.index("model")
            model_dims[name] = dim
            shape[dim] *= mesh.model_size
        if not zero1:
            continue
        full_spec = list(spec) + [None] * (p.ndim - len(spec))
        order = flax_dims(name, p.ndim)  # e.g. flax [in, out] of [out, in]
        dim = zero1_leaf_dim(tuple(full_spec[d] for d in order),
                             tuple(shape[d] for d in order), mesh.data_size)
        if dim is not None:
            zero1_dims[name] = order[dim]
    return Layout(model_dims=model_dims, zero1_dims=zero1_dims)
