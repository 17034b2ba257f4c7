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
  embedding-row gather and the masked lookup of a row shard (up to two
  tables a launch, the bf16 cast folded in), a hand-written Hopper
  kernel, differentiable;
- ``parallel/embedding.py``: the row-sharded embedding table
  (``RowShardedEmbed``), the masked lookup over a process group
  (``masked_lookup_sharded``; ``masked_lookup_grouped`` and
  ``lookup_tables`` for the tables of one group in one launch) and
  ``embedding_rules``;
- ``core/dist.py``: the cluster-flag collapse and the process group
  (NCCL / gloo); ``core/mesh.py``: ``MeshConfig``, ``HostView`` and the
  data and model axes' groups; ``core/comms.py``: the collectives over a
  group, Megatron's TP operators and ``tp_dense`` / ``TpDense``;
  ``ops/collective_matmul.py``: the ``--tp_overlap`` rings;
  ``core/sharding.py``: the placement rules and ZeRO-1's;
- ``core/train.py``: ``TrainState``, ``make_train_step`` (data
  parallelism, ZeRO-1, microbatches of the global batch),
  ``make_eval_step``;
- ``optim.py``: optax-semantics optimizers (sgd, momentum, adam, adamw,
  lamb, adafactor) and LR schedules;
- ``models/gpt.py``: ``GPTConfig``, ``GPT``, the KV cache (a position
  a row under ``slot_decode``), ``generate`` and its per-row sampler,
  ``make_loss``, ``make_eval``; ``models/bert.py``: ``BertConfig``,
  ``BertMLM``, ``make_loss``, ``make_eval``; ``models/resnet.py``:
  ``ResNet``, ``make_loss``, ``make_eval``; ``models/widedeep.py``:
  ``WideDeep``, ``make_loss``, ``make_eval``; ``models/mnist.py``:
  ``SoftmaxRegression``, ``MLP``, ``make_loss``, ``make_eval``;
- ``data/``: the synthetic (every kind of the JAX package's), MNIST
  IDX, image, token-file (causal and masked LM) and Criteo loaders;
- ``loop.py``, ``hooks.py``, ``metrics.py``, ``checkpoint.py``: the
  training loop, its hooks, the metric writer, checkpoints and the
  model-config manifest;
- ``serve/``: online serving — ``DecodeEngine`` (slot-pooled
  continuous batching), ``Scheduler``, ``ServeClient``, ``replay``,
  ``PoissonLoadGen``, ``Heartbeat``;
- ``convert.py``: the flax param tree <-> the port's ``state_dict``;
- ``cli/``: the launchers' flags and setup;
- ``train_gpt.py``, ``generate_gpt.py``, ``serve_gpt.py``,
  ``train_widedeep.py``,
  ``train_resnet.py``, ``train_bert.py``, ``distributed.py`` (MNIST, the
  reference's launcher): ``python -m dtf_tpu_torch.<name>``;
  ``profile_*.py``: their profilers on the GPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
