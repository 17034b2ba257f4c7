"""dtf_tpu_torch — the PyTorch / CUDA port of ``dtf_tpu`` for NVIDIA Hopper.

A package of its own beside ``dtf_tpu`` (the JAX reference, unchanged).
It imports torch, numpy and the standard library only — never jax, flax
or anything of ``dtf_tpu``. The module layout mirrors the JAX package:

- ``ops/attention.py``: ``dense_attention`` (the plain reference);
- ``ops/flash_attention.py`` + ``ops/csrc/flash_fwd.cu``: the flash
  forward, a hand-written Hopper kernel built by ``ops/_build.py``;
- ``core/comms.py``: ``tp_dense`` / ``TpDense`` (unsharded);
- ``models/gpt.py``: ``GPTConfig``, ``GPT``, the KV cache, ``generate``;
- ``convert.py``: the flax param tree <-> the port's ``state_dict``;
- ``checkpoint.py``, ``cli/flags.py``: the model-config manifest merge;
- ``generate_gpt.py``: ``python -m dtf_tpu_torch.generate_gpt``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
