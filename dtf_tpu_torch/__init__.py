"""dtf_tpu_torch — the PyTorch / CUDA port of ``dtf_tpu`` for NVIDIA Hopper.

A package of its own beside ``dtf_tpu`` (the JAX reference, unchanged).
It imports torch, numpy and the standard library only — never jax, flax
or anything of ``dtf_tpu``. The module layout mirrors the JAX package:

- ``ops/attention.py``: ``dense_attention`` (the plain reference);
- ``ops/flash_attention.py`` + ``ops/csrc/flash_fwd.cu``,
  ``ops/csrc/flash_bwd.cu``: the flash forward and backward, hand-written
  Hopper kernels built by ``ops/_build.py``, differentiable;
- ``ops/losses.py``: the softmax cross-entropy and the chunked LM losses;
  ``ops/fused_ce.py`` + ``ops/csrc/fused_ce.cu``: the fused LM head +
  cross-entropy kernels;
- ``ops/embed_gather.py`` + ``ops/csrc/embed_gather.cu``: the
  embedding-row gather, a hand-written Hopper kernel, differentiable;
- ``parallel/embedding.py``: the row-sharded embedding table
  (``RowShardedEmbed``) and the masked lookup
  (``masked_lookup_sharded``, one device);
- ``core/comms.py``: ``tp_dense`` / ``TpDense`` (unsharded);
- ``core/train.py``: ``TrainState``, ``make_train_step``,
  ``make_eval_step``; ``core/dist.py``: the cluster-flag collapse;
- ``optim.py``: optax-semantics optimizers and LR schedules;
- ``models/gpt.py``: ``GPTConfig``, ``GPT``, the KV cache, ``generate``,
  ``make_loss``, ``make_eval``; ``models/widedeep.py``: ``WideDeep``,
  ``make_loss``, ``make_eval``;
- ``data/``: the synthetic (``gpt``, ``widedeep``), token-file and
  Criteo loaders;
- ``loop.py``, ``hooks.py``, ``metrics.py``, ``checkpoint.py``: the
  training loop, its hooks, the metric writer, checkpoints and the
  model-config manifest;
- ``convert.py``: the flax param tree <-> the port's ``state_dict``;
- ``cli/``: the launchers' flags and setup;
- ``train_gpt.py``, ``generate_gpt.py``, ``train_widedeep.py``:
  ``python -m dtf_tpu_torch.<name>``; ``profile_train.py``,
  ``profile_generate.py``, ``profile_widedeep.py``: their profilers on
  the GPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
