"""dtf_tpu_torch — the PyTorch / CUDA port of ``dtf_tpu`` for NVIDIA Hopper.

A package of its own beside ``dtf_tpu`` (the JAX reference, unchanged).
It imports torch, numpy and the standard library only — never jax, flax
or anything of ``dtf_tpu``. The module layout mirrors the JAX package:

- ``ops/attention.py``: ``dense_attention`` (the plain reference);
- ``ops/flash_attention.py`` + ``ops/csrc/flash_fwd.cu``,
  ``ops/csrc/flash_bwd.cu``: the flash forward and backward, hand-written
  Hopper kernels built by ``ops/_build.py``, differentiable;
- ``ops/losses.py``: the softmax cross-entropy;
- ``core/comms.py``: ``tp_dense`` / ``TpDense`` (unsharded);
- ``core/train.py``: ``TrainState``, ``make_train_step``,
  ``make_eval_step``; ``core/dist.py``: the cluster-flag collapse;
- ``optim.py``: optax-semantics optimizers and LR schedules;
- ``models/gpt.py``: ``GPTConfig``, ``GPT``, the KV cache, ``generate``,
  ``make_loss``, ``make_eval``;
- ``data/``: the synthetic and token-file loaders;
- ``loop.py``, ``hooks.py``, ``metrics.py``, ``checkpoint.py``: the
  training loop, its hooks, the metric writer, checkpoints and the
  model-config manifest;
- ``convert.py``: the flax param tree <-> the port's ``state_dict``;
- ``cli/``: the launchers' flags and setup;
- ``train_gpt.py``, ``generate_gpt.py``: ``python -m dtf_tpu_torch.<name>``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
