#!/usr/bin/env python3
"""Chip smoke test of the H100 port (``dtf_tpu_torch``): the quickest proof
that the port builds and runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device — a CUDA device must exist; prints the card's name and power
   limit as ``nvidia-smi`` gives them.
2. build — compiles every kernel of the port from ``dtf_tpu_torch/ops/csrc``
   with ``nvcc`` for sm_90a (one nvcc per source, all started together);
   prints ptxas's registers and spills, and checks with ``cuobjdump
   -sass`` that the forward and both backward kernels (D 64 and 128, 6
   in all) run wgmma (HGMMA) on TMA loads (UTMALDG) and no mma.sync
   (HMMA), and that the fused CE kernels B5 (one instance for every
   width), B6 and B7 (D 384, 768 and 1024; 7 in all) run wgmma on TMA
   loads with no spill.
3. kernels — the flash-attention forward kernel (B1, and B4 through
   ``block_h``) against its plain PyTorch version on the card, bf16, at
   GPT-2 shapes and the tile edges (T 5, 65, 129, ragged T, t_q 1 against
   t_k 1024, D 128 ragged with a window and a ``kv_mask`` row, B·H 65,552
   past the old grid limit); two launches at the training shape bitwise
   equal; times the kernel, the plain version, PyTorch's
   ``scaled_dot_product_attention`` (a yardstick only — the port never
   calls it) and the bound.
4. generate — GPT-2 small at full width, seeded random weights, batch 4,
   prompt 1024, 64 new greedy tokens through ``models.gpt.generate``; the
   flash launch count must be exactly one per layer; prefill logits and
   greedy tokens are held against the same model on the dense path, and
   then, teacher-forced on the dense model's 64 tokens, the logits of
   every step and row (256). Then the ``python -m
   dtf_tpu_torch.generate_gpt`` entry, in process.
5. generate-variants — GPT-2 small widths at 4 layers with GQA
   (kv_heads 4), a 256 window with every 2nd layer global, an int8 KV
   cache and ``flash_block_h=2`` (B4); one greedy run, one seeded sampled
   run (temperature 0.8, top_p 0.9) twice.
6. generate_beam — beam search (``models.gpt.generate_beam``) on GPT-2
   small at full width and depth, JAX-init weights, bf16: batch 2, prompt
   1024, 4 beams, 64 new tokens (decode_len 1088). Exactly 12 B1 launches
   a call (the prompt prefilled once at batch 2, not 8); one beam equals
   greedy ``generate`` token for token; against the dense path of the
   same weights, each returned sequence's teacher-forced log-prob lies
   within ``BEAM_SCORE_STEP_TOL`` x max|logit| x 64 of the flash run's
   best score, and the two runs' sequences are equal up to the first
   step whose k-th against (k+1)-th candidate margin is under that
   tolerance at the step; the GQA + int8-KV variant (4 layers) runs,
   deterministic, its one beam greedy. Prints the prefill ms, the ms and
   device ops of a beam step, the cache reorder's ms beside its bytes
   bound, and B1 at [2, 12, 1024, 64] against its plain version, its
   bound and SDPA.
7. serve_engine — the serving engine (``dtf_tpu_torch.serve``) at GPT-2
   small's full width and depth, JAX-init weights, bf16, 8 slots of 1024
   positions, prefill chunks of 128: twelve requests (prompts 17 to 880
   tokens, ragged chunk counts; greedy, seeded sampled with top-k/top-p,
   one stopped by an eos) under churn through the scheduler. Each greedy
   request's tokens equal batch-1 ``generate``'s (same chunk width) up to
   its first top-2 margin under ``LOGITS_REL_TOL`` of the largest logit;
   teacher-forced on ``generate``'s tokens, the logits of every slot and
   step lie within that tolerance; a sampled and a greedy request alone
   and under churn in the same slot give bit-equal tokens; both steps,
   minus their one readback, run under
   ``torch.cuda.set_sync_debug_mode("error")``; ``trace_counts`` stays
   {prefill: 1, decode: 1}; the sampler draws the same tokens on the CPU
   and the card; no hand kernel launches.
8. serve_bench — ``python -m dtf_tpu_torch.serve_gpt --logdir`` in process
   on the train phase's checkpoint (so it runs right after train, as do
   serve_spec and serve_pages; without train, 2 steps of ``train_gpt``
   make the checkpoint they serve): Poisson mode, 16 slots, max_len
   1024, chunk 128, 16 requests, prompts 128–768, 32–128 new tokens, at
   1000 requests/s (the slots full) and at 2/s: tokens/s, TTFT and
   per-token p50/p99, occupancy, KV-cache MiB, peak GB; then the decode
   step with every slot active (``profile_serve.measure_decode``): wall
   ms, device-busy ms and launches a step, idle share; beside it offline
   ``generate``'s decode ms/token at 16 rows of 512.
9. serve_spec — speculative decoding (``spec_k`` 4) on the train phase's
   checkpoint at full width and depth, 16 slots of 1024, chunk 128, with
   a self-draft and with the early-exit draft of 3 layers: serve_engine's
   twelve requests (greedy and sampled) equal a batch-1 reference stream
   (the same sampler, draw by draw) up to their first top-2 margin under
   ``LOGITS_REL_TOL`` of the largest logit (for a sampled token, of the
   Gumbel scores times the temperature); teacher-forced, the verify
   step's logits of every slot and position lie within that tolerance
   of sequential decode's; the self-draft's greedy rows accept at least
   ``SPEC_SELF_ACCEPT_MIN`` of the proposals; the draft and verify steps
   (and a prefill with its draft chunk) run under
   ``torch.cuda.set_sync_debug_mode("error")``; four step functions;
   no hand kernel. Then the first ``SPEC_TRAFFIC_REQUESTS`` (8) of
   serve_bench's requests, at most 64 new tokens, at 2 requests/s through
   ``serve_gpt --spec_k 4`` with each draft (``--draft_ckpt`` of the
   checkpoint itself, ``--draft_layers 3``) beside serve_bench's own
   ``--spec_k 0`` run of all 16: tokens/s, TTFT and per-token p50/p99, accept
   rate, tokens a tick; and ``measure_decode`` of each engine: the tick,
   the draft step and the verify step (wall, busy, launches, idle); KV
   MiB of the target, the draft and the pool.
10. serve_pages — the prefix page pool: a ``--requests`` file made from a
   seed (16 requests sharing a 512-token stem, tails of 32–256 tokens,
   32–128 new) through ``serve_gpt`` with ``--prefix_pages 256
   --kv_page_size 16`` and with the pool off: TTFT p50/p99, prefill
   chunks, hit and miss tokens, pages saved and loaded, ``pinned`` back
   at 0; greedy streams equal the pool-off run's (a difference only
   where the pool-off stream's top-2 margin is under tolerance); a
   slot's first 512 positions after a load equal, bit for bit, the pool
   pages and a fresh prefill's; both page steps sync-free; no hand
   kernel.
11. serve_fleet — the serving fleet (``serve.Router``) on the train
   phase's checkpoint, 2 replicas of 16 slots of 1024, chunk 128: (a)
   serve_engine's twelve requests (greedy, sampled, a stop token) through
   the router bit-equal to one engine's, the replicas' weights one set
   of tensors (``data_ptr``); (b) ``serve_gpt --replicas 2`` at
   serve_bench's 2 requests/s traffic (at most 64 new tokens a request):
   tokens/s, TTFT and per-token
   p50/p99, per-replica occupancy, the router tick's ms and ``cp_*``
   split; (c) the same with ``DTF_FAULT_INJECT=wedge_replica@50:
   replica=0`` and the health bars under the wedge: replica 0
   quarantined, its requests requeued, all complete, every stream
   equal to (b)'s; (d) ``--prefill_replicas 1 --prefix_pages 256
   --kv_page_size 16`` on serve_pages' 16 requests: handoffs, pages
   loaded, pins 0, streams equal to the one engine's pool-off run but at
   near-ties, TTFT beside the one engine with pages. No hand kernel.
12. publish_swap — train → publish → rolling swap, GPT-2 small at full
   width: (a) ``train_gpt --attn_impl flash`` (batch 4 x 1024, 4 steps,
   the trainer's init from ``--seed 0``) with ``--publish_dir
   --publish_every 2``: versions 1 and 2 in the manifest, each digest
   verified, exactly 12 B1 a step and an eval batch and 12 B2 and B3 a
   step; (b) ``serve_gpt --replicas 2 --publish_dir --publish_version 1
   --swap_poll_ticks 4 --canary_ticks 8`` (16 slots of 1024 a replica,
   chunk 128) on 16 greedy requests of serve_engine's shapes: one swap to
   version 2 and no rollback, all 16 done, every record stamped 1 or 2,
   the streams stamped 2 bit-equal to a fresh ``--publish_version 2``
   fleet's, ``trace_counts`` {prefill: 1, decode: 1} on each replica, the
   replicas on one set of tensors (``data_ptr``) equal to version 2's,
   the roll's ``max_memory_allocated`` within one set of parameters (and
   ``SWAP_PEAK_SLACK_BYTES``) of the fresh fleet's, no hand kernel in
   serving. The run-record plane rides the same path: the trainer's
   ``--event_log_dir`` (read back with the port's ``read_events``: one
   ``ckpt_save`` a checkpoint step, ``publish_version`` 1 and 2 each
   emitted with the manifest already naming it, ``seq`` strictly
   increasing, ``train_end``), and the rolling fleet's ``--event_log_dir
   --log_sink_dir --trace_out`` (one ``swap_start`` and one
   ``swap_commit`` for version 2, no rollback, ``serve_summary`` of 16
   requests; 16 CRC-valid sink records, each with its request's emitted
   tokens, version stamp and replica; the trace loads as JSON with one
   ``request`` slice a request, its queue waits and engine slices tagged
   with live trace ids). The same roll with the plane off serves the same
   rows, record stamps and ticks: the plane changes no token. Prints the
   swap's drain, swap, probe, canary window and whole roll on the
   router's clock, a version's load ms (digest and read) and its copy to
   the card, the plane's counts and the router tick ms with the plane on
   and off, and the phase's seconds.
13. kernels_bwd — the flash backward kernels (B2 dQ, B3 dK/dV) against
   the plain backward on the card, bf16, dO as a transposed view: the
   training shape, ragged T, a window, a fully masked ``kv_mask`` row
   (gradient exactly 0), t_q != t_k, D 128, T 5, T 65 and 129 (one row
   past a tile), t_q 1 against t_k 1024, D 128 ragged with a window,
   B·H 65,552 at T 2; then two launches of each kernel at the training
   shape, bitwise equal.
14. kernel_times_bwd — B2, B3 and B1 at the training shape
   [8, 12, 1024, 64]: kernel, plain version, the library yardstick
   (SDPA's backward) and the bound.
15. train_grads — GPT-2 small at full width, the trainer's init, one
   8 x 1024 batch: loss and every gradient on the flash path against the
   dense path; exactly 12 B1/B2/B3 launches per step (24 B1 under remat).
16. train — ``train_gpt``'s main path in process: b8 s1024, AdamW, 30
   steps, with the launch counts of that run; a relaunch that resumes
   from the checkpoint; ``generate_gpt --logdir`` on it; 30 steps on one
   fixed batch, whose loss must fall by ``FIXED_BATCH_LOSS_DROP``.
   Prints step ms, tokens/s, analytic MFU and peak memory.
17. kernels_ce — the fused LM head + CE kernels (the split pass, B5 and
    the merge of its vocab parts, B6 dX, B7 dW) against their plain
    versions on the card, f32, TF32 off: the training shape with ignored
    labels, the same with larger logits (W std 0.2), ragged N and V
    (50257) with out-of-range labels, an all-ignored batch (dX, dW
    exactly 0), N 5, bf16 x, D 1024, D 384; the split exactly, B5's parts
    and the merge each against their own plain version, two B5 launches
    bitwise equal in every case; then two launches of B5, B6 and B7 at
    the training shape, bitwise equal.
18. kernel_times_ce — B5, the merge, the split pass, B6, B7 at N 8192, D
    768, V 50304: kernel, plain version, the monolithic composite they
    replace (cuBLAS f32 head GEMM + logsumexp/gather, and its backward; a
    yardstick only) and the bound (3xTF32 on the tensor cores); B5's CTAs
    and B6's and B7's clusters against what the card holds at once.
19. train_grads_ce — GPT-2 small, one 8 x 1024 batch: the fused loss and
    the token- and vocab-chunked losses against the monolithic loss (loss,
    the head's gradient, every other gradient); exactly 1/1/1/1/1
    split/B5/merge/B6/B7 launches per step on the fused path, none on the
    chunked ones.
20. train_ce — ``train_gpt --loss_pallas`` in process, b8 s1024, 30
    steps: the split pass, B5 and the merge 34 each (one per step and per
    final-eval batch), B6 30, B7 30 launches; the first 5 losses against
    the ``train`` run's. Prints step ms, tokens/s, analytic MFU and peak
    memory beside ``train``'s.
21. kernels_embed — the embedding-row gather (B8) against its plain
    version on the card, exactly (a gather copies): Wide&Deep's deep
    table [2,600,000, 16] in f32 and bf16 and its wide table [2,600,000,
    1] with synthetic batch 0's 512 x 26 ids, rank-2 ids, 4,096 copies of
    one id, ids 0 and R-1, D 3 and 17 in bf16, D 768, a strided table,
    empty ids, and out-of-range ids (NaN rows); then the gather's
    backward with duplicate ids against ``index_add_`` in f64. Then the
    masked form (one launch for one or two tables of a row shard, rows
    outside it exactly 0, f32 rounded to bf16 as it is stored), exactly
    equal to ``masked_gather_rows_reference``: the path's pair (wide f32,
    deep f32 -> bf16) on shard 1 and 0 of 2, one table with and without
    the cast, a bf16 table, D 3 bf16 with D 17 cast, D 768 cast with a
    1-wide f32 table, strided tables, ids outside the table, empty ids.
22. kernel_times_embed — B8 at the deep table with 512 x 26 ids (the
    launcher's batch) and 8,192 x 26 (``scripts/bench_lm.py``'s), f32 and
    bf16, and at the wide table: kernel, plain version, the library
    yardstick (``torch.nn.functional.embedding``) and the bound, each
    call on fresh ids so rows arrive cold, as on the path. Then the
    path's lookup (one rank of ``--mesh_model 2``: shard 1 of 2, 1.3M
    rows a table, 512 x 26 ids, no collective): today's composite (the
    deep shard's cast and 8 ops a table) against the fused launch,
    forward and backward,
    device ms and device ops, the bound, and the outputs and gradients
    of both bit for bit.
23. widedeep_lookup — Wide&Deep at full width (hash_buckets 100,000,
    embed_dim 16, mlp 256/128/64, bf16), the trainer's init, 4 synthetic
    batches of 512: the model's two lookups again through
    ``masked_lookup_grouped`` (the row-sharded forward's lookup) on its
    own tables, equal to the model's embeddings exactly; exactly 1 B8
    launch per batch, none in the backward; the tables' gradients equal
    today's per-table composite bit for bit (deterministic index_add_),
    and the ``index_select`` path's within 1e-6 (the deep table's at f32
    rows).
24. train_widedeep — ``train_widedeep`` in process at its defaults
    (batch 512, Adam 1e-3, 300 steps, the final 4-batch eval), then a
    relaunch that resumes to step 310: the loss falls, ``eval_accuracy``
    > 0.55, and no B8 launch (the launcher looks its tables up as the
    JAX one does, with ``take``). Prints step ms, examples/s and peak
    memory.
25. resnet_batchnorm — train-mode BatchNorm as the model runs it on
    the card (PyTorch's fused batch-norm kernels) against the port's
    plain f32 ops (what the CPU tests hold against flax) on the same
    bf16 channels-last inputs at ResNet-50's stem, first-stage and
    last-stage shapes at b256: y, mean, variance, dx, dscale, dbias
    within ``BN_BF16_TOL`` / ``BN_F32_TOL``; the device ms of both.
26. train_resnet — ``train_resnet`` in process: ``--config=imagenet``
    (ResNet-50 v1.5 at full width, 25,557,032 parameters, batch 256, the
    synthetic ImageNet stream) for 10 steps — finite losses, every
    BatchNorm running statistic moved, every tensor on the card — and a
    relaunch that resumes to 12; ``--config=cifar`` (ResNet-20, batch
    256, 20 steps); then 30 steps of bench.py's recipe on one fixed batch
    of 128, whose loss must fall by ``RN_FIXED_LOSS_DROP``. No hand
    kernel launches on this path (cuDNN convolutions, as the JAX
    package's are XLA's).
27. resnet_bench — ``profile_resnet``'s measurement at bench.py's batch
    128 and the launcher's 256 (one fixed batch on the card, SGD 0.1
    momentum 0.9, 3 warm-up and 10 timed steps): step ms, images/s,
    analytic MFU, peak memory, device busy and idle share, launches and
    device ms by family (convolutions, BatchNorm, the rest).
28. bert_kernels — B1, B2 and B3 at BERT's shapes (bf16, 12 heads of
    64, non-causal, a key-padding mask with rows of no padding, some, all
    but one key and every key padded; batch 16 and 64, T 128 and 512)
    against their plain versions at the kernels / kernels_bwd
    tolerances, a fully padded row's output and gradients exactly 0; at
    the path's [64, 12, 128, 64] and at [16, 12, 512, 64]: each kernel's
    time, plain version, bound and SDPA with the same boolean mask (the
    backend PyTorch's dispatch took, named).
29. train_bert — ``train_bert`` in process: BERT-base at full width
    (109,514,298 parameters), seq 128, batch 64, ``--grad_accum 4``, 10
    steps — finite losses, every tensor on the card, B1, B2 and B3 each
    12 × 4 a step (B1 12 more an eval batch) — and a relaunch that
    resumes to 12; ``--mlm_gather 20``, ``--loss_chunk_vocab 8192``,
    ``--optimizer lamb`` and ``--optimizer adafactor`` 3 steps each, finite;
    30 AdamW steps on one fixed batch lower the loss by
    ``BERT_FIXED_LOSS_DROP``; ``--mlm_gather 128`` gives the full path's
    loss within ``BERT_GATHER_REL_TOL``.
30. bert_bench — ``profile_bert``'s measurement (one fixed batch on the
    card, AdamW, 3 warm-up, 10 timed and 5 profiled steps) at
    ``grad_accum`` 1 and 4 with full logits, and 1 with ``--mlm_gather
    20`` and with ``--loss_chunk_vocab 8192``: step ms, tokens/s,
    analytic MFU, peak memory, flash launches a step, the head's ms and
    share, device busy and idle share, launches and device ms by family.
31. dist_nccl — a process group of ONE over NCCL, made by this script,
    with the entry points run inside it: ``python -m
    dtf_tpu_torch.distributed`` (MNIST softmax, 200 steps; its loss and
    held-out accuracy), and ``train_gpt --loss_pallas --mesh_data 1``
    (GPT-2 small, b8 s1024, 5 steps, ZeRO-1 on: every collective of the
    data-parallel step runs) against the same run with no group: losses
    within ``DIST_LOSS_REL_TOL``, exact fused CE and flash launch counts,
    the step ms of both; and ``train_resnet --config=cifar --mesh_data
    1`` (ResNet-20, batch 256, 5 steps, every BatchNorm synchronised over
    the group) against the same run with no group: losses within
    ``DIST_LOSS_REL_TOL``, running statistics within ``DIST_RN_STAT_TOL``,
    the step ms of both; and ``train_bert --mesh_data 1`` (BERT-base,
    batch 8, ``--grad_accum 2``, ZeRO-1, 4 steps) against the same run
    with no group: losses within ``DIST_LOSS_REL_TOL``, exact flash
    launch counts.
32. dist_two_ranks_one_card — two processes on cuda:0 over gloo (the
    group made by this script's ``--dist-child`` ranks; the kernels
    built before the spawn; each rank's output in a file, the wait
    bounded by ``DIST_CHILD_TIMEOUT_S``): ``train_widedeep --mesh_model
    2`` (2.6M-row tables split over the ranks, batch 512, 20 steps;
    exactly 1 B8 launch a step a rank, both tables in it; losses against
    the 1-rank ``index_select`` run within ``DIST_WD_LOSS_REL_TOL``), then
    ``train_gpt --loss_pallas --mesh_data 2`` (4 rows a rank, ZeRO-1,
    5 steps; one B5/B6/B7 a step a rank; losses against one rank on the
    same global batch within ``DIST_LOSS_REL_TOL``), then ``train_resnet
    --config=cifar --mesh_data 2`` (128 rows a rank, BatchNorm over both
    ranks, 5 steps; losses within ``DIST_LOSS_REL_TOL`` and running
    statistics within ``DIST_RN_STAT_TOL`` of one rank on the same global
    batch), then ``train_bert --mesh_data 2 --grad_accum 2`` (BERT-base,
    dropout on, ZeRO-1, 4 rows a rank, 4 steps; losses within
    ``DIST_LOSS_REL_TOL`` of one rank on the same global batch, which
    holds only with each microbatch cut from the global batch) and the
    row exchange's time on each rank (a ResNet-50 b256 batch and BERT's
    b64 batch). Its times go through the host (gloo): a check that it
    runs, not a speed.
33. gpt_tp_two_ranks — Megatron tensor parallelism: B1 forward and B2/B3
    backward at a rank's shape [4, 6, 1024, 64] against their plain
    versions (the kernels / kernels_bwd gates) with their times, plain
    versions, SDPA and bounds; then two processes on cuda:0 over gloo
    (``--tp-child``, the kernels built before the spawn, outputs in
    files, the wait bounded by ``TP_CHILD_TIMEOUT_S``) run ``train_gpt
    --size small --mesh_model 2`` (b4 × 1024, 4 steps, 6 heads a rank,
    publishing every 2 steps: versions 1 and 2), then the same with
    ``--tp_overlap``, against
    one rank with no model axis on the same global batch and seed:
    the step-4 checkpoints whole, with the one-rank run's names and
    shapes, and each leaf's change from the init within
    ``TP_PARAM_DELTA_TOL`` of the one-rank run's (the worst leaf but
    ``TP_PARAM_UNGATED``'s);
    losses within ``DIST_LOSS_REL_TOL``, exact B1/B2/B3 launches a rank,
    the exact counted collectives a rank (``_tp_collectives_want``), the
    published version whole and loading into a one-process model; and of
    each run, each rank's step ms, the host ms inside the counted
    collectives against the summed step ms, and its peak memory. Then the
    same two ranks serve the plain run's version 1 (sharded decode):
    ``generate(mesh=)`` at b4 × 1024 + 64 greedy tokens (exactly 12 B1
    launches a call a rank, each at [4, 6, 1024, 64]; the call's and a
    decode step's counted collectives exact; the last prompt position's
    logits within δ of one rank's on the same weights, the greedy tokens
    equal up to the first top-2 margin under δ; a step's wall, busy ms,
    launches and host ms inside the collectives), then ``serve_gpt
    --mesh_model 2`` (8 slots of 1024, 8 replayed greedy requests of
    128–512 prompt and 32–64 new tokens: every stream equal to one
    rank's engine up to a near-tie, each rank's KV cache exactly half of
    one rank's, tokens/s, TTFT p50, peak memory; then every slot full at
    512 positions, a round of 10 decode steps timed on both ranks, its
    counted collectives exact, and 5 profiled). Then the sharded FLEET on
    the same ranks: ``serve_gpt --mesh_model 2 --replicas 2`` on version
    1 of the plain run's publish dir (versions 1 and 2, ``--publish_every
    2``), polling it every ``TP_FLEET_POLL`` ticks, rolls to version 2
    while serving ``TP_FLEET_REQUESTS`` replayed greedy requests (the
    canary alone ``TP_FLEET_CANARY`` ticks); a fresh fleet on each
    version; the roll again with ``wedge_in_swap@0:replica=1``. Each
    stream equal to one rank's engine on the version it is stamped with
    up to a near-tie and to the fresh fleet's on it exactly, a request
    spanning the roll on one version, one swap and
    both replicas on version 2 on each rank from one set (``data_ptr``),
    each rank's KV caches half of one rank's, the roll's staging, swaps
    and commit each one announcing broadcast (``broadcast_object``) and
    no other collective, each replica probed once, no hand kernel, the
    roll's peak within one shard set (and ``SWAP_PEAK_SLACK_BYTES``) of
    the fresh fleet's on 2; the wedged roll rolled back on both ranks,
    both replicas on the version-1 tensors by identity and its streams
    the fresh fleet's on 1. The roll's seconds, the swap call's ms
    on each rank and the sub-phase's seconds are printed. Through gloo:
    it runs, not a speed.

Then one JSON line listing every kernel (launches on its main path, error
against the plain version, times, bound; the 8 ported TPU kernels, the
split pass and the merge of B5's parts; B5-B7's, the split's and the
merge's launches from rank 0 of the 2-rank GPT run, B8's from rank 0 of
the 2-rank Wide&Deep run; B1-B3 also by path, ``train``,
``publish_swap`` and rank 0 of ``gpt_tp_two_ranks``, and B1 on rank 0's
``generate(mesh=)``, ``gpt_tp_serve``), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
``--phases a,b`` runs a subset (without the kernels line). Exits
non-zero without printing a result when no GPU is present or when the
port's package is not beside this file.
"""

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and dense
#: bf16 tensor-core FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
#: dense TF32 tensor-core FLOP/s: an f32-accurate product on the tensor
#: cores is 3xTF32 (three TF32 products per f32 one), the floor of B5–B7
PEAK_TF32_FLOPS = 494.7e12

#: kernel vs plain version, bf16 inputs. out: both cast p to bf16 before
#: P·V, but relative to a different max (the kernel's running max, the
#: plain version's row max), and round the output to bf16 — a few bf16
#: ulps (2^-8 relative) at |out| <= ~4. lse: f32 in both, only the
#: summation order and the online rescaling differ.
OUT_ATOL = 3e-2
LSE_ATOL = 1e-3
#: prefill logits, flash vs dense path of the same bf16 model: the
#: attention outputs differ by bf16 roundings (above), which 12 bf16
#: layers carry into the f32 head. Stated against the logits' scale.
LOGITS_REL_TOL = 2e-2

#: backward kernels vs plain backward, bf16 inputs: both cast P and dS to
#: bf16 before their products and sum in f32, but S comes from products
#: summed in another order, so a P or dS element now and then rounds to
#: the neighbouring bf16 value (2^-8 relative), and dq/dk/dv are rounded
#: to bf16 (2^-9) at the end. Stated as ||kernel - plain|| / ||plain||
#: per gradient, and max |kernel - plain| against max |plain|.
GRAD_REL_TOL = 1e-2
GRAD_MAX_ABS_TOL = 2e-2

#: GPT-2 small at full width, one batch, flash path vs dense path of the
#: same bf16 model: the two attention paths round P to bf16 relative to
#: different maxima and sum in other orders, and 12 bf16 layers carry
#: that into the loss and every gradient. Loss: relative. Gradients:
#: ||flash - dense|| / ||dense|| per parameter, the denominator floored
#: at GRAD_NORM_FLOOR x the whole gradient's norm (a key-projection bias
#: has an analytic gradient of 0 — softmax ignores a per-row shift — so
#: its own norm is rounding noise).
TRAIN_LOSS_REL_TOL = 1e-3
TRAIN_GRAD_REL_TOL = 5e-2
GRAD_NORM_FLOOR = 1e-3
#: stated before the first measuring run: over 30 AdamW steps (the
#: launcher's recipe, lr 3e-4, 4 warmup steps) on ONE fixed batch, the
#: last loss is at least this far below the first
FIXED_BATCH_LOSS_DROP = 1.0
TRAIN_STEPS = 30

#: B5–B7 against their plain versions on the card, f32 operands, TF32 off
#: on both sides: the kernels form each logit from 3xTF32 products (~2^-21
#: relative each) summed on the tensor cores (whose f32 sums truncate),
#: cuBLAS in IEEE f32 in its own order — a few f32 ulps per logit, far
#: below these. lse and tgt (|.| ~ 11): max abs. dX and dW:
#: ||kernel - plain|| / ||plain||. A bf16 x is promoted to f32 before
#: the kernels and its dX rounded to bf16 at the end, so the bf16 dX
#: carries a bf16 rounding of its own (2^-8 relative) where the two f32
#: values straddle a rounding boundary: CE_BF16_DX_REL_TOL.
CE_STAT_ATOL = 1e-4
#: the merge of B5's parts against its plain version on the same parts:
#: the same sums in the same order, expf / logf on the card against
#: PyTorch's (each within 2 ulp) — a few ulps of |lse| < 32 (2^-18 each)
CE_MERGE_ATOL = 1e-5
CE_GRAD_REL_TOL = 1e-4
CE_BF16_DX_REL_TOL = 4e-3
#: GPT-2 small, one batch, the fused (and each chunked) loss against the
#: monolithic loss of the same model: the head math is f32 in both, so the
#: loss and the head's gradient agree to f32 summation order. The trunk's
#: gradients pass through 12 bf16 layers, where an f32-ulp change in dX
#: flips bf16 roundings and the softmax backward at random init (dP − Δ,
#: a small difference of large terms) amplifies them: the query/key
#: weights are the noisiest, as in train_grads. A first run at 1e-2 saw
#: 1.09e-2 on layer_0's query weight for the fused loss, so the trunk is
#: held to train_grads' bound for bf16 trunk noise, TRAIN_GRAD_REL_TOL
#: (floored as GRAD_NORM_FLOOR floors), and the chunked losses — cuBLAS
#: f32 in another order, the same class of perturbation — are printed
#: beside it as the noise floor.
CE_LOSS_REL_TOL = 1e-5
CE_HEAD_GRAD_REL_TOL = 1e-4
CE_TRUNK_GRAD_REL_TOL = TRAIN_GRAD_REL_TOL
#: train_ce against train: the same init and data, so the first steps'
#: losses differ only by the head's summation order, carried by AdamW
CE_TRAIN_LOSS_REL_TOL = 1e-3
CE_TRAIN_COMPARED_STEPS = 5
#: GPT-2 small's head: d_model 768, padded vocab 50304, real vocab 50257
D_MODEL, VOCAB, VOCAB_REAL = 768, 50304, 50257

#: the serving slice's shapes: GPT-2 small, batch 4, prompt 1024, 64 new
BATCH, PROMPT, N_NEW, HEADS, D_HEAD = 4, 1024, 64, 12, 64
#: the training slice's shape: GPT-2 small, batch 8, seq 1024
TRAIN_BATCH, TRAIN_SEQ = 8, 1024

#: Wide&Deep at the launcher's defaults: 26 categorical features of
#: 100,000 buckets each (2.6M table rows), 16-wide deep embeddings,
#: batch 512, 300 steps; scripts/bench_lm.py's batch 8192
WD_SPARSE, WD_BUCKETS, WD_EMBED, WD_BATCH = 26, 100_000, 16, 512
WD_ROWS = WD_SPARSE * WD_BUCKETS
WD_BENCH_BATCH = 8192
WD_STEPS, WD_RESUME_STEPS = 300, 310
#: test_widedeep_learns' bar for the held-out accuracy
WD_EVAL_ACCURACY_MIN = 0.55
#: B8's backward (an f32 index_add_ of the cotangent) against index_add_
#: in f64, and the kernel path's table gradients against the
#: index_select path's (f32 scatter-adds of the same cotangents, duplicate
#: ids summed in another order): f32 rounding of sums of a few terms
EMBED_GRAD_REL_TOL = 1e-6


#: when the script started (main sets it): every phase line carries its
#: seconds since then
T_START = []


def emit(obj):
    if T_START:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START[0]}
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def phase_device(torch):
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit({"phase": "device", **dev, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return dev, smi


def phase_build():
    from dtf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build(_build.KERNELS, ptxas_verbose=True)
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "spill"))
                    or ("ptxas" in ln and "arning" in ln)]
             for name, log in logs.items()}
    for name in _build.KERNELS:
        _build.load(name)
    sass = sass_counts(_build, FLASH_SASS_KERNELS, 6)
    ce_sass = sass_counts(_build, CE_SASS_KERNELS, 7)
    ce_regs = res_usage(_build, CE_SASS_KERNELS)
    emit({"phase": "build", "seconds": secs, "sources": list(_build.KERNELS),
          "ptxas": ptxas, "flash_sass": sass, "fused_ce_sass": ce_sass,
          "fused_ce_ptxas": ce_regs})
    for kernel, counts in sass.items():
        require(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
                and counts["HMMA"] == 0,
                f"{kernel}: expected wgmma (HGMMA) and TMA loads (UTMALDG) "
                f"and no mma.sync (HMMA), got {counts}")
    for kernel, counts in ce_sass.items():
        require(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
                f"{kernel}: expected wgmma (HGMMA) and TMA loads (UTMALDG), "
                f"got {counts}")
    # a spill needs a stack frame: none in B5/B6/B7
    require(len(ce_regs) == 7 and all(
        r["stack"] == 0 and r["local"] == 0 for r in ce_regs.values()),
        f"B5/B6/B7 registers and stack (spills): {ce_regs}")


#: the wgmma kernels whose SASS the build phase reads, by library
FLASH_SASS_KERNELS = {"flash_fwd": ("flash_fwd_kernel",),
                      "flash_bwd": ("flash_bwd_dq_kernel",
                                    "flash_bwd_dkv_kernel")}
CE_SASS_KERNELS = {"fused_ce": ("fused_ce_fwd_kernel", "fused_ce_dx_kernel",
                                 "fused_ce_dw_kernel")}


def _instance(name, kernels):
    """``kernel<D>`` for a mangled name of one of ``kernels`` (its first
    template argument), else None."""
    import re

    kernel = next((k for k in kernels if k in name), None)
    if kernel is None:
        return None
    arg = re.search(r"ILi(\d+)E", name)
    return f"{kernel}<{arg.group(1)}>" if arg else kernel


def sass_counts(_build, libs, expected):
    """Per kernel instance (``kernel<D>``), its count of wgmma (HGMMA),
    TMA load (UTMALDG) and mma.sync (HMMA) instructions, from ``cuobjdump
    -sass`` of the built libraries (beside nvcc); ``expected`` instances."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    counts = {}
    for lib, kernels in libs.items():
        text = subprocess.run([cuobjdump, "-sass", _build.library_path(lib)],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        kernel = None
        for line in text.splitlines():
            if "Function :" in line:
                kernel = _instance(line.split("Function :")[1].strip(),
                                   kernels)
                if kernel is not None:
                    counts[kernel] = {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0}
                continue
            if kernel is not None:
                for op in ("HGMMA", "UTMALDG", "HMMA"):
                    counts[kernel][op] += f" {op}." in line
    require(len(counts) == expected, f"kernels in the SASS: {counts}")
    return counts


def res_usage(_build, libs):
    """Registers, stack and local bytes per kernel instance, from
    ``cuobjdump -res-usage`` of the built libraries: it reads what was
    built, also when this run found the libraries built already and
    ptxas did not run."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    out = {}
    for lib, kernels in libs.items():
        text = subprocess.run(
            [cuobjdump, "-res-usage", _build.library_path(lib)],
            capture_output=True, text=True, timeout=120, check=True).stdout
        kernel = None
        for line in text.splitlines():
            if "Function" in line:
                kernel = _instance(line.split("Function", 1)[1], kernels)
            elif kernel is not None and "REG:" in line:
                f = dict(t.split(":", 1) for t in line.split() if ":" in t)
                out[kernel] = {"registers": int(f["REG"]),
                               "stack": int(f.get("STACK", -1)),
                               "local": int(f.get("LOCAL", 0))}
                kernel = None
    return out


def graph_ms(torch, calls):
    """Mean device milliseconds of one call of ``calls`` (a list of
    callables): the list captured in one CUDA graph, in order, replayed 3
    times between CUDA events — the Python around each launch is not in
    the measurement."""
    calls[0]()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * len(calls))


def time_ms(torch, fn, iters):
    """Mean device milliseconds of one fn() call, ``iters`` calls to a
    graph (:func:`graph_ms`). Inputs stay in L2 between calls."""
    return graph_ms(torch, [fn] * iters)


def live_pairs(t_q, t_k, causal, window):
    """(query, key) pairs that survive the causal / window mask: the work
    the kernels' live-block loops must do, per batch·head."""
    seen = 0
    for qp in range(t_q):
        hi = min(qp + 1, t_k) if causal else t_k
        lo = max(0, qp - window + 1) if (causal and window) else 0
        seen += max(0, hi - lo)
    return seen


def bound_ms(nbytes, flops):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the bf16 matmul FLOPs over the tensor-core peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_bound_ms(b, h, t_q, t_k, d, causal, window):
    """B1: q, k, v read once, out and lse written once; QK^T and PV on
    the live pairs (2 FLOPs per multiply-add)."""
    nbytes = 2 * (2 * b * h * t_q * d + 2 * b * h * t_k * d) + 4 * b * h * t_q
    flops = 2 * 2 * b * h * d * live_pairs(t_q, t_k, causal, window)
    return bound_ms(nbytes, flops)


def attention_bwd_bounds_ms(b, h, t_q, t_k, d, causal, window):
    """B2 and B3: q, k, v, dO (bf16) and lse, delta (f32) read once each.
    B2 writes dq and does three products on the live pairs (S, dP, dQ);
    B3 writes dk and dv and does four (S, dP, dV, dK)."""
    reads = 2 * (2 * b * h * t_q * d + 2 * b * h * t_k * d) \
        + 2 * 4 * b * h * t_q
    pairs = b * h * live_pairs(t_q, t_k, causal, window)
    dq = bound_ms(reads + 2 * b * h * t_q * d, 3 * 2 * d * pairs)
    dkv = bound_ms(reads + 2 * 2 * b * h * t_k * d, 4 * 2 * d * pairs)
    return dq, dkv


def phase_kernels(torch):
    from dtf_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, h, t_q, t_k, d):
        return [torch.randn(b, h, t, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
                for t in (t_q, t_k, t_k)]

    def mask_bias(b, t_k):
        m = torch.ones(b, t_k, dtype=torch.bool, device="cuda")
        m[0, t_k - 100:] = False             # a masked tail
        m[b - 1, :] = False                  # every key of a row masked
        return fa._mask_bias(m, b, t_k)

    cases = [
        ("causal_T1024", (BATCH, HEADS, 1024, 1024, D_HEAD), True, 0, False, 1),
        ("causal_T1000_ragged", (BATCH, HEADS, 1000, 1000, D_HEAD), True, 0,
         False, 1),
        ("causal_window256", (BATCH, HEADS, 1024, 1024, D_HEAD), True, 256,
         False, 1),
        ("kv_mask_dead_row", (BATCH, HEADS, 1024, 1024, D_HEAD), False, 0,
         True, 1),
        ("tq512_tk1024", (BATCH, HEADS, 512, 1024, D_HEAD), False, 0, False,
         1),
        ("causal_tq1024_tk600", (BATCH, HEADS, 1024, 600, D_HEAD), True, 0,
         False, 1),
        ("block_h2_causal_T1024", (BATCH, HEADS, 1024, 1024, D_HEAD), True, 0,
         False, 2),
        ("d128_causal_T1024", (2, 8, 1024, 1024, 128), True, 0, False, 1),
        ("tiny_T5_causal", (1, 2, 5, 5, D_HEAD), True, 0, False, 1),
        ("T65_window1", (2, 3, 65, 65, D_HEAD), True, 1, False, 1),
        ("kv_mask_causal_window128", (BATCH, HEADS, 1024, 1024, D_HEAD),
         True, 128, True, 1),
        ("d128_block_h2_T300", (2, 4, 300, 300, 128), True, 0, False, 2),
        # the tile edges: one row past a 128-row span, a single query
        # against 1024 keys, D 128 ragged with a window and a dead
        # kv_mask row; B·H 65,552 (grid x) at a single row
        ("causal_T129", (BATCH, HEADS, 129, 129, D_HEAD), True, 0, False, 1),
        ("tq1_tk1024", (BATCH, HEADS, 1, 1024, D_HEAD), False, 0, False, 1),
        ("d128_kv_mask_T1000_window200", (2, 8, 1000, 1000, 128), True, 200,
         True, 1),
        ("bh65552_T1", (4097, 16, 1, 1, D_HEAD), False, 0, False, 1),
    ]
    err = {"flash_fwd": 0.0, "flash_fwd_hfold": 0.0}
    rows = []
    fa.reset_launch_counts()
    for name, (b, h, t_q, t_k, d), causal, window, masked, block_h in cases:
        q, k, v = qkv(b, h, t_q, t_k, d)
        bias = mask_bias(b, t_k) if masked else None
        scale = d ** -0.5
        out, lse = fa.flash_attention_cuda(
            q, k, v, bias, sm_scale=scale, causal=causal, window=window,
            block_h=block_h)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(
            q, k, v, bias, sm_scale=scale, causal=causal, window=window)
        require(out.shape == ref_out.shape and out.dtype == torch.bfloat16,
                f"{name}: out {tuple(out.shape)} {out.dtype}")
        require(torch.isfinite(out).all().item(), f"{name}: non-finite out")
        d_out = (out.float() - ref_out.float()).abs().max().item()
        dead = torch.isneginf(ref_lse)
        require(torch.equal(torch.isneginf(lse), dead),
                f"{name}: -inf lse rows differ")
        d_lse = ((lse - ref_lse).abs()[~dead].max().item()
                 if (~dead).any() else 0.0)
        if masked:
            rows_dead = out.view(b, h, t_q, d)[b - 1]
            require(torch.count_nonzero(rows_dead).item() == 0,
                    f"{name}: fully masked row is not 0")
        if block_h > 1:
            base, base_lse = fa.flash_attention_cuda(
                q, k, v, bias, sm_scale=scale, causal=causal, window=window)
            require(torch.equal(out, base) and torch.equal(lse, base_lse),
                    f"{name}: block_h={block_h} differs from block_h=1")
        ok = d_out <= OUT_ATOL and d_lse <= LSE_ATOL
        kname = "flash_fwd" if block_h == 1 else "flash_fwd_hfold"
        err[kname] = max(err[kname], d_out)
        rows.append({"case": name, "max_abs_err_out": d_out,
                     "max_abs_err_lse": d_lse, "ok": ok})
        require(ok, f"{name}: kernel disagrees with the plain version "
                    f"(out {d_out} > {OUT_ATOL} or lse {d_lse} > {LSE_ATOL})")

    # No atomics, one write per element: two launches on the training
    # shape give the same bits.
    q, k, v = qkv(TRAIN_BATCH, HEADS, TRAIN_SEQ, TRAIN_SEQ, D_HEAD)
    runs = [fa.flash_attention_cuda(q, k, v, sm_scale=D_HEAD ** -0.5,
                                    causal=True) for _ in range(2)]
    torch.cuda.synchronize()
    require(torch.equal(runs[0][0], runs[1][0])
            and torch.equal(runs[0][1], runs[1][1]),
            "flash_fwd: two launches differ")
    emit({"phase": "kernels", "out_atol": OUT_ATOL, "lse_atol": LSE_ATOL,
          "cases": rows, "bitwise_repeat": True})

    # times at the main path's shape: [4, 12, 1024, 64] bf16 causal
    q, k, v = qkv(BATCH, HEADS, PROMPT, PROMPT, D_HEAD)
    scale = D_HEAD ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound, bound_by = attention_bound_ms(BATCH, HEADS, PROMPT, PROMPT,
                                         D_HEAD, True, 0)
    timing = {}
    for kname, block_h in (("flash_fwd", 1), ("flash_fwd_hfold", 2)):
        timing[kname] = time_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, sm_scale=scale, causal=True, block_h=block_h), 20)
    plain = time_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, sm_scale=scale, causal=True), 5)
    library = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True), 20)
    emit({"phase": "kernel_times", "shape": [BATCH, HEADS, PROMPT, D_HEAD],
          "causal": True, "kernel_ms": timing["flash_fwd"],
          "kernel_hfold_ms": timing["flash_fwd_hfold"], "plain_ms": plain,
          "library_ms": library, "bound_us": bound * 1e3,
          "bound_by": bound_by})
    fa.reset_launch_counts()
    return err, {**timing, "plain_ms": plain, "library_ms": library,
                 "bound_ms": bound, "bound_by": bound_by}


def phase_kernels_bwd(torch):
    """B2/B3 against the plain backward on the card, bf16, at the
    training shape and the edge cases; dO is a transposed view (the
    layout autograd hands over). Returns each kernel's largest max-abs
    error."""
    from dtf_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(10)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    cases = [
        ("causal_T1024", (TRAIN_BATCH, HEADS, 1024, 1024, D_HEAD), True, 0,
         False),
        ("causal_T1000_ragged", (BATCH, HEADS, 1000, 1000, D_HEAD), True, 0,
         False),
        ("causal_window256", (BATCH, HEADS, 1024, 1024, D_HEAD), True, 256,
         False),
        ("kv_mask_dead_row", (BATCH, HEADS, 1024, 1024, D_HEAD), False, 0,
         True),
        ("tq512_tk1024", (BATCH, HEADS, 512, 1024, D_HEAD), False, 0, False),
        ("causal_tq1024_tk600", (BATCH, HEADS, 1024, 600, D_HEAD), True, 0,
         False),
        ("d128_causal_T1024", (2, 8, 1024, 1024, 128), True, 0, False),
        ("tiny_T5_causal", (1, 2, 5, 5, D_HEAD), True, 0, False),
        ("kv_mask_causal_window128", (BATCH, HEADS, 1000, 1000, D_HEAD),
         True, 128, True),
        # one row past a 64- and a 128-row block; a single query against
        # a long key range; D 128 with a ragged T and a window
        ("causal_T65", (BATCH, HEADS, 65, 65, D_HEAD), True, 0, False),
        ("causal_T129", (BATCH, HEADS, 129, 129, D_HEAD), True, 0, False),
        ("tq1_tk1024", (BATCH, HEADS, 1, 1024, D_HEAD), False, 0, False),
        ("d128_causal_T1000_window200", (2, 8, 1000, 1000, 128), True, 200,
         False),
        # B·H 65,552 in grid x; T 2, since at T 1 dQ and dK are 0 up to
        # rounding (P = 1, dP = Delta) and no relative error is defined
        ("bh65552_T2", (4097, 16, 2, 2, D_HEAD), False, 0, False),
    ]
    rows, worst = [], {"flash_dq": 0.0, "flash_dkv": 0.0}
    for name, (b, h, t_q, t_k, d), causal, window, masked in cases:
        q, k, v = randn(b, h, t_q, d), randn(b, h, t_k, d), randn(b, h, t_k, d)
        do = randn(b, t_q, h, d).transpose(1, 2)        # autograd's layout
        bias = None
        if masked:
            m = torch.ones(b, t_k, dtype=torch.bool, device="cuda")
            m[0, t_k - 100:] = False
            m[b - 1, :] = False                  # every key of a row masked
            bias = fa._mask_bias(m, b, t_k)
        opts = dict(sm_scale=d ** -0.5, causal=causal, window=window)
        out, lse = fa.flash_attention_cuda(q, k, v, bias, **opts)
        got = fa.flash_attention_bwd_cuda(q, k, v, bias, out, lse, do, **opts)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, bias, out, lse, do,
                                                **opts)
        row = {"case": name}
        for gname, x, y in zip(("dq", "dk", "dv"), got, want):
            require(x.shape == y.shape and x.dtype == torch.bfloat16,
                    f"{name}: {gname} {tuple(x.shape)} {x.dtype}")
            require(torch.isfinite(x).all().item(), f"{name}: non-finite "
                                                    f"{gname}")
            diff = (x.float() - y.float())
            scale = y.float().abs().max().item()
            rel = (diff.norm() / y.float().norm().clamp_min(1e-30)).item()
            mab = diff.abs().max().item()
            row[f"{gname}_rel"], row[f"{gname}_max_abs"] = rel, mab
            if masked:
                require(torch.count_nonzero(x[b - 1]).item() == 0,
                        f"{name}: {gname} of the fully masked row is not 0")
            require(rel <= GRAD_REL_TOL and mab <= GRAD_MAX_ABS_TOL * scale,
                    f"{name}: {gname} disagrees with the plain backward "
                    f"(rel {rel} > {GRAD_REL_TOL} or max-abs {mab} > "
                    f"{GRAD_MAX_ABS_TOL} x {scale})")
            kname = "flash_dq" if gname == "dq" else "flash_dkv"
            worst[kname] = max(worst[kname], mab)
        rows.append(row)

    # No atomics, one write per element: two launches of each kernel on
    # the training shape give the same bits.
    shape = (TRAIN_BATCH, HEADS, TRAIN_SEQ, D_HEAD)
    q, k, v = randn(*shape), randn(*shape), randn(*shape)
    do = randn(TRAIN_BATCH, TRAIN_SEQ, HEADS, D_HEAD).transpose(1, 2)
    opts = dict(sm_scale=D_HEAD ** -0.5, causal=True)
    out, lse = fa.flash_attention_cuda(q, k, v, **opts)
    delta = (do.float() * out.reshape(shape).float()).sum(dim=-1)
    dq = [fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, **opts)
          for _ in range(2)]
    dkv = [fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **opts)
           for _ in range(2)]
    torch.cuda.synchronize()
    require(torch.equal(dq[0], dq[1]), "flash_dq: two launches differ")
    require(torch.equal(dkv[0][0], dkv[1][0])
            and torch.equal(dkv[0][1], dkv[1][1]),
            "flash_dkv: two launches differ")
    emit({"phase": "kernels_bwd", "rel_tol": GRAD_REL_TOL,
          "max_abs_tol_of_max": GRAD_MAX_ABS_TOL, "cases": rows,
          "bitwise_repeat": True})
    fa.reset_launch_counts()
    return worst


def phase_kernel_times_bwd(torch):
    """B2, B3 and B1 at the training shape ([8, 12, 1024, 64] bf16
    causal): kernel, plain version, library call and bound."""
    from dtf_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(11)
    shape = (TRAIN_BATCH, HEADS, TRAIN_SEQ, D_HEAD)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    do = torch.randn(TRAIN_BATCH, TRAIN_SEQ, HEADS, D_HEAD, generator=gen,
                     device="cuda", dtype=torch.bfloat16).transpose(1, 2)
    opts = dict(sm_scale=D_HEAD ** -0.5, causal=True)
    out, lse = fa.flash_attention_cuda(q, k, v, **opts)
    delta = (do.float() * out.reshape(shape).float()).sum(dim=-1)
    b1_bound, b1_by = attention_bound_ms(*shape[:3], TRAIN_SEQ, D_HEAD, True,
                                         0)
    (dq_bound, dq_by), (dkv_bound, dkv_by) = attention_bwd_bounds_ms(
        *shape[:3], TRAIN_SEQ, D_HEAD, True, 0)
    res = {
        "flash_dq": time_ms(torch, lambda: fa.flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, **opts), 20),
        "flash_dkv": time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, **opts), 20),
        "flash_fwd": time_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, **opts), 20),
    }
    plain_bwd = time_ms(torch, lambda: fa.flash_attention_bwd_reference(
        q, k, v, None, out, lse, do, **opts), 3)
    plain_fwd = time_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, **opts), 3)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lib_fwd = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True), 20)
    lib_fwd_bwd = time_ms(torch, lambda: torch.autograd.grad(
        sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), do), 20)
    fa.reset_launch_counts()
    timing = {
        "flash_dq": dict(ms=res["flash_dq"], plain_ms=plain_bwd,
                         bound_ms=dq_bound, bound_by=dq_by,
                         library_ms=lib_fwd_bwd - lib_fwd),
        "flash_dkv": dict(ms=res["flash_dkv"], plain_ms=plain_bwd,
                          bound_ms=dkv_bound, bound_by=dkv_by,
                          library_ms=lib_fwd_bwd - lib_fwd),
        "flash_fwd_train": dict(ms=res["flash_fwd"], plain_ms=plain_fwd,
                                bound_ms=b1_bound, bound_by=b1_by,
                                library_ms=lib_fwd),
    }
    emit({"phase": "kernel_times_bwd", "shape": list(shape), "causal": True,
          **{name: {"kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
                    "library_ms": t["library_ms"],
                    "bound_us": t["bound_ms"] * 1e3,
                    "bound_by": t["bound_by"]} for name, t in timing.items()},
          "library": "scaled_dot_product_attention(is_causal=True): "
                     "backward = (forward + backward) - forward, for B2 and "
                     "B3 together"})
    return timing


def build_model(torch, cfg, seed=0):
    from dtf_tpu_torch.convert import init_params, params_from_flax
    from dtf_tpu_torch.models.gpt import GPT

    model = GPT(cfg, device="cuda")
    model.load_state_dict(params_from_flax(init_params(cfg, seed)))
    return model.eval()


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_flash_vs_dense(torch, cfg, flash_model, prompt, tag):
    """Prefill logits of the flash path against the dense path of the
    same weights; returns the dense model for further checks."""
    import dataclasses

    from dtf_tpu_torch.models.gpt import GPT

    dense = GPT(dataclasses.replace(cfg, attn_impl="dense"), device="cuda")
    dense.load_state_dict(flash_model.state_dict())
    dense.eval()
    with torch.no_grad():
        lf = flash_model(prompt, flash_model.init_cache(prompt.shape[0]))
        ld = dense(prompt, dense.init_cache(prompt.shape[0]))
    require(torch.isfinite(lf).all().item(), f"{tag}: non-finite logits")
    scale = ld.abs().max().item()
    diff = (lf - ld).abs().max().item()
    emit({"phase": f"{tag}_prefill_logits", "max_abs_diff": diff,
          "max_abs_logit": scale, "rel_tol": LOGITS_REL_TOL})
    require(diff <= LOGITS_REL_TOL * scale,
            f"{tag}: flash vs dense prefill logits differ by {diff} "
            f"(> {LOGITS_REL_TOL} x {scale})")
    return dense


def phase_generate(torch):
    import dataclasses

    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_small(),
                              decode_len=PROMPT + N_NEW)
    model = build_model(torch, cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, 50257, (BATCH, PROMPT), generator=gen,
                           device="cuda")
    gpt.generate(model, prompt[:, :128], 2)            # warm-up, not read

    fa.reset_launch_counts()
    out, total_s = timed(torch, lambda: gpt.generate(model, prompt, N_NEW))
    launches = dict(fa.launch_counts)
    require(launches == {"flash_fwd": cfg.layers, "flash_fwd_hfold": 0,
                         "flash_dq": 0, "flash_dkv": 0},
            f"flash launches per generate call {launches} != "
            f"{cfg.layers} (one per layer)")
    require(tuple(out.shape) == (BATCH, PROMPT + N_NEW), f"shape {out.shape}")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            "token out of range")
    require(torch.equal(out[:, :PROMPT], prompt), "prompt not echoed")
    _, prefill_s = timed(torch, lambda: gpt.generate(model, prompt, 1))
    decode_s = (total_s - prefill_s) / (N_NEW - 1)

    # the dense path of the same model: logits, then greedy tokens up to
    # the first step whose top-2 margin is inside the logits tolerance
    dense = check_flash_vs_dense(torch, cfg, model, prompt, "generate")
    out_d = gpt.generate(dense, prompt, N_NEW)
    with torch.no_grad():
        logits = dense(out_d[:, :-1], dense.init_cache(BATCH))
    top2 = logits[:, PROMPT - 1:].topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]                       # [B, N_NEW]
    tol = LOGITS_REL_TOL * logits.abs().max().item()
    compared = 0
    for row in range(BATCH):
        close = (margin[row] < tol).nonzero()
        upto = int(close[0]) if len(close) else N_NEW
        require(torch.equal(out[row, PROMPT:PROMPT + upto],
                            out_d[row, PROMPT:PROMPT + upto]),
                f"row {row}: flash and dense greedy tokens differ before "
                f"step {upto} (the first top-2 margin under {tol})")
        compared += upto

    # teacher-forced: both models decode the dense model's greedy tokens,
    # and every step's logits, in every row, are held against the dense
    # model's (LOGITS_REL_TOL of the largest dense logit of the stream)
    with torch.no_grad():
        cache_f, cache_d = model.init_cache(BATCH), dense.init_cache(BATCH)
        tok, diffs, scale = prompt, [], 0.0
        for i in range(N_NEW):
            lf = model(tok, cache_f)[:, -1]
            ld = dense(tok, cache_d)[:, -1]
            require(torch.isfinite(lf).all().item(),
                    f"teacher-forced step {i}: non-finite logits")
            diffs.append((lf - ld).abs().amax(dim=-1))        # [BATCH]
            scale = max(scale, ld.abs().max().item())
            tok = out_d[:, PROMPT + i:PROMPT + i + 1]
    diffs = torch.stack(diffs)                                # [N_NEW, BATCH]
    tf_tol = LOGITS_REL_TOL * scale
    tf_compared = diffs.numel()
    tf_worst = diffs.max().item()
    require(tf_worst <= tf_tol,
            f"teacher-forced logits: flash vs dense differ by {tf_worst} "
            f"(> {LOGITS_REL_TOL} x {scale}) over {tf_compared} steps; "
            f"worst (step, row) "
            f"{divmod(int(diffs.argmax()), BATCH)}")
    emit({"phase": "generate", "model": "gpt2-small", "batch": BATCH,
          "prompt": PROMPT, "n_new": N_NEW, "flash_launches": launches,
          "prefill_ms": prefill_s * 1e3,
          "prefill_tokens_per_s": BATCH * PROMPT / prefill_s,
          "decode_ms_per_token": decode_s * 1e3,
          "decode_tokens_per_s": BATCH / decode_s,
          "generate_ms": total_s * 1e3,
          "tokens_compared_with_dense": compared,
          "tokens_generated": BATCH * N_NEW,
          "teacher_forced": {"steps_compared": tf_compared,
                             "max_abs_diff": tf_worst,
                             "max_abs_logit": scale,
                             "rel_tol": LOGITS_REL_TOL}})
    del dense, logits

    from dtf_tpu_torch import generate_gpt

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = generate_gpt.main(["--size=small", "--init_seed=0", "--batch=2",
                                "--prompt=464,2068,7586,21831", "--n_new=8"])
    rows = [r for r in buf.getvalue().splitlines() if r.strip()]
    require(rc == 0 and len(rows) == 2 and rows[0] == rows[1]
            and len(rows[0].split(",")) == 12,
            f"generate_gpt entry printed {rows}")
    emit({"phase": "generate_gpt_cli", "rows": rows})
    return launches


def phase_variants(torch):
    import dataclasses

    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(
        gpt.GPTConfig.gpt2_small(), layers=4, kv_heads=4, attn_window=256,
        attn_global_every=2, kv_cache_dtype="int8", flash_block_h=2,
        decode_len=PROMPT + 32)
    model = build_model(torch, cfg, seed=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, 50257, (BATCH, PROMPT), generator=gen,
                           device="cuda")
    check_flash_vs_dense(torch, cfg, model, prompt, "variants")

    fa.reset_launch_counts()
    greedy = gpt.generate(model, prompt, 32)
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    require(launches == {"flash_fwd": 0, "flash_fwd_hfold": cfg.layers,
                         "flash_dq": 0, "flash_dkv": 0},
            f"variant launches {launches}")

    def sampled(seed):
        return gpt.generate(model, prompt, 32, seed=seed, temperature=0.8,
                            top_p=0.9)

    a, b = sampled(7), sampled(7)
    for name, toks in (("greedy", greedy), ("sampled", a)):
        require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                f"{name}: token out of range")
        require(tuple(toks.shape) == (BATCH, PROMPT + 32), f"{name} shape")
    require(torch.equal(a, b), "sampled run does not repeat for one seed")
    emit({"phase": "generate_variants", "layers": cfg.layers,
          "kv_heads": 4, "attn_window": 256, "attn_global_every": 2,
          "kv_cache_dtype": "int8", "flash_block_h": 2,
          "flash_launches": launches, "sampled_repeats": True,
          "sampled_differs_from_greedy": not torch.equal(a, greedy)})
    return launches

#: generate_beam: GPT-2 small (JAX init), batch 2, prompt 1024, 4 beams,
#: 64 new tokens (decode_len 1088)
BEAM_BATCH, BEAM_K = 2, 4
#: flash against dense: every logit of a step moves by at most
#: delta = LOGITS_REL_TOL x max|logit| (the generate phase's gate), so a
#: log-prob (the token's logit less the logsumexp, each 1-Lipschitz in
#: the max norm) moves by at most 2 delta, and a sum of s of them by
#: 2 s delta. The flash run's best score is held against the dense
#: model's teacher-forced log-prob of that sequence within
#: BEAM_SCORE_STEP_TOL x max|logit| x N_NEW, and the two runs' sequences
#: must be equal up to the first step s whose k-th against (k+1)-th
#: candidate margin (in either run) is under BEAM_SCORE_STEP_TOL x
#: max|logit| x (s + 1).
BEAM_SCORE_STEP_TOL = 2 * LOGITS_REL_TOL


def phase_generate_beam(torch, smi):
    """Beam search (``models.gpt.generate_beam``) at GPT-2 small's full
    width and depth: the prompt prefilled ONCE at batch B through B1 (12
    launches a call), one beam equal to greedy ``generate``, the flash
    run against the dense path of the same weights (scores and
    sequences, ``BEAM_SCORE_STEP_TOL``), the int8-KV + GQA variant; B1 at
    the path's shape against its plain version, its bound and SDPA; the
    prefill, a beam step, its device ops and the cache reorder."""
    import dataclasses

    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_small(),
                              decode_len=PROMPT + N_NEW)
    model = build_model(torch, cfg)
    gen = torch.Generator(device="cuda").manual_seed(11)
    prompt = torch.randint(0, VOCAB_REAL, (BEAM_BATCH, PROMPT),
                           generator=gen, device="cuda")
    gpt.generate_beam(model, prompt[:, :128], 2, num_beams=BEAM_K)

    def beam(m, n_new=N_NEW, k=BEAM_K, **kw):
        return gpt.generate_beam(m, prompt, n_new, num_beams=k, **kw)

    # (a) one prefill at batch B: exactly one B1 launch a layer a call
    fa.reset_launch_counts()
    (out, best, margins), total_s = timed(
        torch, lambda: beam(model, return_scores=True))
    launches = dict(fa.launch_counts)
    require(launches == {"flash_fwd": cfg.layers, "flash_fwd_hfold": 0,
                         "flash_dq": 0, "flash_dkv": 0},
            f"flash launches per generate_beam call {launches} != "
            f"{cfg.layers} (the prefill once at batch {BEAM_BATCH})")
    require(tuple(out.shape) == (BEAM_BATCH, PROMPT + N_NEW)
            and out.dtype == torch.int64, f"out {out.shape} {out.dtype}")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            "token out of range")
    require(torch.equal(out[:, :PROMPT], prompt), "prompt not echoed")
    require(torch.isfinite(best).all().item(), f"scores {best}")
    _, one_s = timed(torch, lambda: beam(model, 1))
    with torch.no_grad():
        _, prefill_s = timed(torch, lambda: gpt._prefill(
            model, model.init_cache(BEAM_BATCH), prompt, 0))
    step_ms = (total_s - one_s) * 1e3 / (N_NEW - 1)
    ops_step = (device_ops(torch, lambda: beam(model, 5))
                - device_ops(torch, lambda: beam(model, 1))) / 4

    # (b) one beam is greedy decode, token for token
    greedy = gpt.generate(model, prompt, N_NEW)
    require(torch.equal(beam(model, k=1), greedy),
            "num_beams=1 differs from greedy generate")

    # (c) the dense path of the same weights
    dense = check_flash_vs_dense(torch, cfg, model, prompt, "generate_beam")
    out_d, best_d, margins_d = beam(dense, return_scores=True)
    with torch.no_grad():
        logits = dense(out[:, :-1], dense.init_cache(BEAM_BATCH))
        scale = logits.abs().max().item()
        lp = torch.log_softmax(logits[:, PROMPT - 1:], dim=-1).gather(
            -1, out[:, PROMPT:, None])[..., 0].sum(-1)
    del logits
    delta = BEAM_SCORE_STEP_TOL * scale
    score_tol = delta * N_NEW
    score_diff = (lp - best).abs().max().item()
    require(score_diff <= score_tol,
            f"flash best scores {best.tolist()} against the dense model's "
            f"teacher-forced log-probs {lp.tolist()}: {score_diff} > "
            f"{score_tol}")
    compared = []
    steps = torch.arange(1, N_NEW + 1, device="cuda")[:, None]
    close = torch.minimum(margins, margins_d) < delta * steps    # [S, B]
    for row in range(BEAM_BATCH):
        hit = close[:, row].nonzero()
        upto = int(hit[0]) if len(hit) else N_NEW
        require(torch.equal(out[row, PROMPT:PROMPT + upto],
                            out_d[row, PROMPT:PROMPT + upto]),
                f"row {row}: flash and dense beams differ before step "
                f"{upto} (the first candidate margin under tolerance)")
        compared.append(upto)
    del dense

    # (d) GQA + the int8 cache: the scale leaves ride the reorder
    vcfg = dataclasses.replace(cfg, layers=4, kv_heads=4,
                               kv_cache_dtype="int8")
    vmodel = build_model(torch, vcfg)
    fa.reset_launch_counts()
    out_v = beam(vmodel)
    v_launches = fa.launch_counts["flash_fwd"]
    require(v_launches == vcfg.layers, f"variant: {v_launches} B1 launches")
    require(torch.equal(out_v[:, :PROMPT], prompt)
            and bool(((out_v >= 0) & (out_v < cfg.vocab_size)).all()),
            "variant: bad tokens")
    require(torch.equal(beam(vmodel), out_v), "variant: not deterministic")
    require(torch.equal(beam(vmodel, k=1), gpt.generate(vmodel, prompt,
                                                        N_NEW)),
            "variant: num_beams=1 differs from greedy")
    del vmodel

    # the cache reorder alone: every batch-led leaf gathered by parent
    big = model.init_cache(BEAM_BATCH * BEAM_K)
    rows = (torch.arange(BEAM_BATCH, device="cuda")[:, None] * BEAM_K
            + torch.tensor([[1, 0, 3, 3], [2, 2, 0, 1]],
                           device="cuda")).reshape(-1)
    reorder_ms = time_ms(torch, lambda: gpt._map_batch_led(
        big, lambda x: x.copy_(x.index_select(0, rows)),
        BEAM_BATCH * BEAM_K), 10)
    reorder_bytes = 2 * sum(x.numel() * x.element_size() for layer in big
                            for name, x in layer.items()
                            if name != "cache_index" and x is not None)
    del big, model

    # B1 at the path's shape: kernel against its plain version, times
    q, k, v = (torch.randn(BEAM_BATCH, HEADS, PROMPT, D_HEAD, generator=gen,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    sm = D_HEAD ** -0.5
    got_o, got_lse = fa.flash_attention_cuda(q, k, v, sm_scale=sm,
                                             causal=True)
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v, sm_scale=sm,
                                                  causal=True)
    err_o = (got_o.float() - ref_o.float()).abs().max().item()
    err_lse = (got_lse - ref_lse).abs().max().item()
    require(err_o <= OUT_ATOL and err_lse <= LSE_ATOL,
            f"B1 at the beam path's shape: out {err_o}, lse {err_lse}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound, bound_by = attention_bound_ms(BEAM_BATCH, HEADS, PROMPT, PROMPT,
                                         D_HEAD, True, 0)
    b1 = {"shape": [BEAM_BATCH, HEADS, PROMPT, D_HEAD], "causal": True,
          "max_abs_err_out": err_o, "max_abs_err_lse": err_lse,
          "kernel_ms": time_ms(torch, lambda: fa.flash_attention_cuda(
              q, k, v, sm_scale=sm, causal=True), 20),
          "plain_ms": time_ms(torch, lambda: fa.flash_attention_reference(
              q, k, v, sm_scale=sm, causal=True), 5),
          "library_ms": time_ms(torch, lambda: sdpa(q, k, v, is_causal=True),
                                20),
          "bound_ms": bound, "bound_by": bound_by,
          "launches_per_call": launches["flash_fwd"]}
    fa.reset_launch_counts()
    emit({"phase": "generate_beam", "model": "gpt2-small", "nvidia_smi": smi,
          "batch": BEAM_BATCH, "num_beams": BEAM_K, "prompt": PROMPT,
          "n_new": N_NEW, "decode_len": cfg.decode_len,
          "flash_launches": launches, "generate_beam_ms": total_s * 1e3,
          "prefill_ms": prefill_s * 1e3, "beam_step_ms": step_ms,
          "device_ops_per_step": ops_step,
          "reorder_ms": reorder_ms,
          "reorder_bytes_bound_ms": reorder_bytes / PEAK_BYTES_PER_S * 1e3,
          "beam1_equals_greedy": True,
          "flash_vs_dense": {"max_abs_logit": scale, "delta": delta,
                             "score_tol": score_tol,
                             "score_max_abs_diff": score_diff,
                             "best_scores": best.tolist(),
                             "dense_best_scores": best_d.tolist(),
                             "teacher_forced_log_probs": lp.tolist(),
                             "tokens_compared": compared,
                             "first_margins": margins[:4].tolist()},
          "variant_gqa_int8": {"layers": vcfg.layers, "kv_heads": 4,
                               "flash_launches": v_launches},
          "b1": b1})
    torch.cuda.empty_cache()
    return b1


#: the serving engine's shape on the card: GPT-2 small, 8 slots of 1024
#: positions, prefill chunks of 128; twelve requests of ragged chunk
#: counts (prompt, max_new, sampling), greedy ones held against generate
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_CHUNK = 8, 1024, 128
SERVE_SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.9}
SERVE_REQUESTS = (
    (17, 64, {}), (880, 40, {}), (129, 48, SERVE_SAMPLED),
    (256, 32, {}), (300, 64, SERVE_SAMPLED), (511, 24, {}),
    (640, 56, {"temperature": 1.0}), (128, 64, {}), (700, 8, {}),
    (45, 40, {"eos": 2}), (390, 16, SERVE_SAMPLED), (233, 64, {}))
#: serve_bench: serve_gpt's Poisson mode on the train phase's checkpoint
#: at a rate that keeps the 16 slots full and at 2 requests a second;
#: SERVE_BENCH_REQUESTS requests a run (serve_spec and serve_fleet run the
#: same traffic; 16 keeps the whole script inside its time limit on a
#: slow host: 32 took 1,157.6 s with publish_swap on one card), each of
#: 32-128 new tokens (256 took the script to 1,139.9 s on a slow host
#: once the TP ranks served too)
SERVE_BENCH_REQUESTS = 16
SERVE_BENCH_FLAGS = ("--n_slots=16", "--max_len=1024", "--prefill_chunk=128",
                     f"--n_requests={SERVE_BENCH_REQUESTS}",
                     "--prompt_min=128",
                     "--prompt_max=768", "--new_min=32", "--new_max=128",
                     "--seed=0")
SERVE_BENCH_RATES = (1000.0, 2.0)
#: the decode-step profile: every slot active at this prompt length
SERVE_PROFILE_PROMPT = 512


def _reference_stream(torch, model, prompt, n_new, chunk):
    """Batch-1 greedy decode on the offline path (``generate``'s chunked
    prefill of the same width, then its decode steps): the tokens and
    every step's logits [n_new, V]."""
    from dtf_tpu_torch.models import gpt

    with torch.no_grad():
        cache = model.init_cache(1)
        logits = gpt._prefill(model, cache, prompt[None], chunk)[:, -1]
        rows = []
        for i in range(n_new):
            rows.append(logits[0])
            if i + 1 < n_new:
                logits = model(logits.argmax(-1)[:, None], cache)[:, 0]
    rows = torch.stack(rows)
    return rows.argmax(-1).tolist(), rows


def _slot_stream(engine, slot, prompt, n_new, sampling, churn, rng):
    """A request's tokens in ``slot`` of ``engine``: alone (every other
    slot inactive) or under churn (the other slots busy, one mid-prefill,
    and a slot re-admitted every 5 steps)."""
    engine.state["active"].zero_()
    others = [s for s in range(engine.n_slots) if s != slot]
    vocab = engine.cfg.vocab_size

    def admit(s, n, seed):
        engine.prefill(s, rng.integers(0, vocab, n).tolist(), seed=seed,
                       **SERVE_SAMPLED)

    if churn:
        for i, s in enumerate(others[:-1]):
            admit(s, 100 + 37 * i, seed=i)
        engine.prefill_chunk_into(
            others[-1], rng.integers(0, vocab, 600).tolist(), 0)
    tok, _ = engine.prefill(slot, prompt, **sampling)
    toks = [tok]
    for i in range(1, n_new):
        if churn and i % 5 == 0:
            admit(others[i // 5 % len(others)], 20 + 37 * i % 500, seed=i)
        got, _ = engine.decode()
        toks.append(int(got[slot]))
    return toks


def _sampler_cpu_vs_cuda(torch):
    """The sampler's noise and tokens on the same logits, CPU against
    CUDA: the hash bits are integer arithmetic (equal), -log(-log(u)) is
    f64 on both."""
    from dtf_tpu_torch.models import gpt

    n, v = 8, VOCAB
    gen = torch.Generator().manual_seed(12)
    logits = torch.randn(n, v, generator=gen) * 4
    kw = {"temperature": torch.tensor([0.8, 1.0] * 4),
          "top_k": torch.tensor([50, 0] * 4),
          "top_p": torch.tensor([0.9, 1.0] * 4),
          "key": gpt.sampler_key(torch.arange(n) * 1000 + 7,
                                 torch.zeros(n, dtype=torch.long)),
          "draw": torch.arange(n) * 3}
    noise = gpt.gumbel_noise(kw["key"], kw["draw"], v)
    noise_cuda = gpt.gumbel_noise(kw["key"].cuda(), kw["draw"].cuda(), v)
    toks = gpt.sample_tokens(logits, **kw)
    toks_cuda = gpt.sample_tokens(
        logits.cuda(), **{k: t.cuda() for k, t in kw.items()})
    out = {"noise_max_abs_diff": (noise - noise_cuda.cpu()).abs().max()
           .item(), "tokens_equal": torch.equal(toks, toks_cuda.cpu())}
    require(out["tokens_equal"], f"sampler tokens differ CPU vs CUDA: {out}")
    return out


def phase_serve_engine(torch, smi):
    """The serving engine at GPT-2 small's full width and depth (JAX-init
    weights, bf16) on the card: twelve requests under churn through the
    scheduler; greedy tokens and teacher-forced logits against batch-1
    ``generate`` of the same chunk width; a request alone and under churn
    in the same slot bit for bit; both steps sync-free; no hand kernel."""
    import dataclasses

    import numpy as np

    from dtf_tpu_torch.convert import init_params_flax, params_from_flax
    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.serve import DecodeEngine, ServeClient

    cfg = gpt.GPTConfig.gpt2_small()
    params = params_from_flax(init_params_flax(cfg, 4))
    engine = DecodeEngine(cfg, params, n_slots=SERVE_SLOTS,
                          max_len=SERVE_MAX_LEN, prefill_chunk=SERVE_CHUNK)
    ref_model = gpt.GPT(dataclasses.replace(cfg, decode_len=SERVE_MAX_LEN,
                                            attn_impl="dense"),
                        device="cuda")
    ref_model.load_state_dict(params)
    ref_model.eval()
    del params
    rng = np.random.default_rng(5)
    reqs, refs = [], {}
    for i, (t_p, n_new, kw) in enumerate(SERVE_REQUESTS):
        prompt = rng.integers(0, VOCAB_REAL, t_p).tolist()
        req = {"prompt": prompt, "max_new": n_new, "seed": 40 + i,
               **{k: v for k, v in kw.items() if k != "eos"}}
        if "temperature" not in kw:
            refs[i] = _reference_stream(
                torch, ref_model, torch.tensor(prompt, device="cuda"),
                n_new, SERVE_CHUNK)
            if "eos" in kw:
                req["eos_id"] = refs[i][0][kw["eos"]]
        reqs.append(req)

    def serve():
        client = ServeClient(engine)
        rids = [client.submit(**r) for r in reqs]
        client.drain()
        return [client.result(rid) for rid in rids], client.stats()

    (got, stats), wall = _no_hand_kernels(torch, serve)
    require(engine.trace_counts == {"prefill": 1, "decode": 1},
            f"trace_counts {engine.trace_counts}")
    scale = max(r[1].abs().max().item() for r in refs.values())
    tol = LOGITS_REL_TOL * scale
    compared = 0
    for i, (toks, rows) in refs.items():
        top2 = rows.topk(2, dim=-1).values
        close = ((top2[:, 0] - top2[:, 1]) < tol).nonzero()
        upto = int(close[0]) if len(close) else len(toks)
        if "eos_id" in reqs[i]:
            stop = toks.index(reqs[i]["eos_id"]) + 1
            require(len(got[i]) == stop and got[i] == toks[:stop],
                    f"request {i}: eos stop {got[i]} vs {toks[:stop]}")
            upto = min(upto, stop)
        require(got[i][:upto] == toks[:upto],
                f"request {i}: engine and generate greedy tokens differ "
                f"before step {upto} (the first top-2 margin under {tol})")
        compared += upto
    for i, r in enumerate(reqs):
        require(len(got[i]) == r["max_new"] or "eos_id" in r,
                f"request {i}: {len(got[i])} tokens of {r['max_new']}")
        require(all(0 <= t < cfg.vocab_size for t in got[i]),
                f"request {i}: token out of range")

    # teacher-forced: the greedy requests in slots 0.., every active slot
    # fed its reference token each step; each slot's logits against its
    # batch-1 reference of the same step
    greedy = sorted(refs)[:SERVE_SLOTS]
    st = engine.state
    st["active"].zero_()
    for s, i in enumerate(greedy):
        engine.prefill(s, reqs[i]["prompt"])
    worst, steps = 0.0, 0
    with torch.no_grad():
        for j in range(1, max(len(refs[i][0]) for i in greedy)):
            live = [s for s, i in enumerate(greedy) if j < len(refs[i][0])]
            st["active"].zero_()
            for s in live:
                st["active"][s] = True
                st["tok"][s] = refs[greedy[s]][0][j - 1]
            logits = engine._model(st["tok"][:, None], st["cache"],
                                   decode_active=st["active"])[:, 0]
            for s in live:
                d = (logits[s] - refs[greedy[s]][1][j]).abs().max().item()
                require(math.isfinite(d), f"slot {s} step {j}: non-finite")
                worst = max(worst, d)
                steps += 1
    require(worst <= tol, f"teacher-forced engine logits differ from "
                          f"generate by {worst} (> {LOGITS_REL_TOL} x "
                          f"{scale}) over {steps} slot-steps")

    # a request alone and under churn, in the same slot: bit-equal tokens
    bitwise = {}
    for i in (4, 7):                               # sampled, greedy
        r = reqs[i]
        sampling = {k: r[k] for k in ("temperature", "top_k", "top_p",
                                      "seed") if k in r}
        alone, churned = (_slot_stream(engine, 3, r["prompt"],
                                       r["max_new"], sampling, churn,
                                       np.random.default_rng(6))
                          for churn in (False, True))
        require(alone == churned, f"request {i}: alone {alone} != under "
                                  f"churn {churned}")
        bitwise[i] = len(alone)

    # both steps, minus their one readback, make no device-to-host sync
    prompt = reqs[1]["prompt"][:SERVE_CHUNK + 5]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c in range(2):
            engine.prefill_into_slot(0, prompt, c, seed=3, **SERVE_SAMPLED)
        for _ in range(3):
            engine.decode_all()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sampler = _sampler_cpu_vs_cuda(torch)
    emit({"phase": "serve_engine", "model": "gpt2-small", "nvidia_smi": smi,
          "n_slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
          "prefill_chunk": SERVE_CHUNK, "requests": len(reqs),
          "tokens_generated": sum(map(len, got)),
          "greedy_tokens_compared_with_generate": compared,
          "teacher_forced": {"slot_steps": steps, "max_abs_diff": worst,
                             "max_abs_logit": scale,
                             "rel_tol": LOGITS_REL_TOL},
          "alone_vs_churn_bitwise_tokens": bitwise,
          "sync_free": ["prefill_into_slot", "decode_all"],
          "sampler_cpu_vs_cuda": sampler,
          "trace_counts": engine.trace_counts, "hand_kernel_launches": 0,
          "serve_wall_s": wall, "ticks": stats["serve_ticks"],
          "cache_mib": engine.cache_bytes() / 2 ** 20})
    del engine, ref_model
    torch.cuda.empty_cache()


def _serve_logdir():
    """A train_gpt logdir of GPT-2 small (2 steps) for the serving phases
    when the train phase did not run; the caller removes it."""
    import gc
    import tempfile

    from dtf_tpu_torch import train_gpt

    logdir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    with contextlib.redirect_stdout(io.StringIO()):
        train_gpt.run(["--size=small", f"--batch_size={TRAIN_BATCH}",
                       f"--seq_len={TRAIN_SEQ}", "--train_steps=2",
                       f"--logdir={logdir}"])
    gc.collect()
    return logdir


def _serve_run(torch, out, wall):
    """One serve_gpt run's numbers as the serving phases print them."""
    keys = ("serve_ttft_p50_s", "serve_ttft_p99_s", "serve_tok_latency_p50_s",
            "serve_tok_latency_p99_s", "serve_occupancy_mean",
            "serve_queue_peak", "serve_decode_steps", "serve_prefill_chunks",
            "cache_mib")
    return {"step": out["step"], "wall_s": out["wall_s"],
            "generated_tokens": out["generated_tokens"],
            "tokens_per_sec": out["tokens_per_sec"],
            **{k: out[k] for k in keys},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "in_process_wall_s": wall}


def phase_serve_bench(torch, smi, logdir):
    """``python -m dtf_tpu_torch.serve_gpt --logdir`` in process on a
    train_gpt checkpoint, Poisson mode at SERVE_BENCH_RATES; then the
    engine's decode step with every slot active (wall, device-busy,
    launches, idle share) beside offline generate's decode step at the
    same rows and context. Returns the last rate's run (serve_spec's
    ``--spec_k 0`` side)."""
    import gc

    from dtf_tpu_torch import serve_gpt
    from dtf_tpu_torch.profile_serve import measure_decode

    runs = []
    engine = None
    for rate in SERVE_BENCH_RATES:
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (out, _, engine), wall = _no_hand_kernels(torch, lambda: serve_gpt.run(
            [f"--logdir={logdir}", f"--poisson_rate={rate}",
             *SERVE_BENCH_FLAGS]))
        require(out["request_statuses"] == {"done": SERVE_BENCH_REQUESTS},
                f"rate {rate}: statuses {out['request_statuses']}")
        runs.append({"poisson_rate": rate, **_serve_run(torch, out, wall)})
    step = measure_decode(engine, prompt_len=SERVE_PROFILE_PROMPT)
    require(step["launches_per_step"] > 0, f"profile saw no kernel: {step}")

    # offline generate's decode step at the same rows and context
    import dataclasses

    from dtf_tpu_torch.models import gpt

    n_new = 33
    model = gpt.GPT(dataclasses.replace(
        engine.cfg, decode_len=SERVE_PROFILE_PROMPT + n_new), device="cuda")
    model.load_state_dict(engine._model.state_dict())
    model.eval()
    del engine
    gen = torch.Generator(device="cuda").manual_seed(8)
    prompt = torch.randint(0, VOCAB_REAL, (16, SERVE_PROFILE_PROMPT),
                           generator=gen, device="cuda")
    gpt.generate(model, prompt, 2)                      # warm-up
    _, full_s = timed(torch, lambda: gpt.generate(model, prompt, n_new))
    _, one_s = timed(torch, lambda: gpt.generate(model, prompt, 1))
    emit({"phase": "serve_bench", "model": "gpt2-small", "nvidia_smi": smi,
          "flags": list(SERVE_BENCH_FLAGS), "runs": runs,
          "decode_step": step,
          "generate_decode_ms_per_token": (full_s - one_s) * 1e3
          / (n_new - 1), "generate_rows": 16,
          "generate_prompt": SERVE_PROFILE_PROMPT})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return runs[-1]


#: serve_spec: k proposals a tick, the early-exit draft's depth, and the
#: share of its proposals the self-draft must get accepted on greedy rows
#: (the draft is the verifier's model: a proposal is rejected only where
#: the single-token step and the (k+1)-token verify pass round a near-tie
#: apart in bf16)
SPEC_K, SPEC_DRAFT_LAYERS = 4, 3
SPEC_SELF_ACCEPT_MIN = 0.9
#: measure_decode's timed and profiled calls of a spec engine's tick, draft
#: step and verify step (the profiler's post-processing of a 7,500-launch
#: tick is what costs)
SPEC_PROFILE_STEPS, SPEC_PROFILED = 5, 1
#: the spec engines' 2 requests/s traffic: the first SPEC_TRAFFIC_REQUESTS
#: of serve_bench's requests (the load generator draws them in order),
#: each of at most SERVE_TRAFFIC_NEW_MAX new tokens (16 requests of up to
#: 128, and 2 profiled ticks, before the sharded fleet ran too)
SPEC_TRAFFIC_REQUESTS = 8
#: the spec engines' and serve_fleet's traffic: new tokens at most
SERVE_TRAFFIC_NEW_MAX = 64
#: serve_pages: 16 requests on one stem of 512 tokens (32 pages of 16),
#: unique tails of 32–256 tokens, 32–128 new; a 256-page pool (64
#: requests before the TP ranks served, 32 before their fleet did)
PAGES_REQUESTS, PAGES_STEM = 16, 512
PAGES_TAIL, PAGES_NEW = (32, 256), (32, 128)
PAGES_FLAGS = ("--prefix_pages=256", "--kv_page_size=16")
PAGES_SERVE_FLAGS = ("--n_slots=16", "--max_len=1024", "--prefill_chunk=128",
                     "--emit_tokens")


def _stream_with_margins(torch, model, prompt, n_new, chunk, sampling=None,
                         seed=0):
    """A batch-1 request on the offline path (``generate``'s chunked
    prefill of the same width, then single-token decode steps), greedy or
    drawn with the engine's sampler at draw i for token i: its tokens,
    every step's logits [n_new, V], and every step's margin in logit
    units — the top-2 gap of the logits (greedy), or of the Gumbel scores
    times the temperature (sampled)."""
    from dtf_tpu_torch.models import gpt

    dev = prompt.device
    one = {}
    if sampling:
        one = {"temperature": torch.tensor([sampling["temperature"]],
                                           device=dev),
               "top_k": torch.tensor([sampling.get("top_k", 0)], device=dev),
               "top_p": torch.tensor([sampling.get("top_p", 1.0)],
                                     device=dev),
               "key": gpt.sampler_key(torch.tensor([seed], device=dev),
                                      torch.zeros(1, dtype=torch.long,
                                                  device=dev))}
    toks, rows, margins = [], [], []
    with torch.no_grad():
        cache = model.init_cache(1)
        logits = gpt._prefill(model, cache, prompt[None], chunk)[:, -1]
        for i in range(n_new):
            rows.append(logits[0])
            if sampling:
                draw = torch.tensor([i], device=dev)
                t = one["temperature"]
                score = gpt.filter_logits_dynamic(
                    logits / t[:, None], top_k=one["top_k"],
                    top_p=one["top_p"]).double() + gpt.gumbel_noise(
                        one["key"], draw, logits.shape[-1])
                top2 = score.topk(2, dim=-1).values[0] * t.double()
                tok = torch.argmax(score, dim=-1)
            else:
                top2 = logits.topk(2, dim=-1).values[0]
                tok = torch.argmax(logits, dim=-1)
            margins.append(float(top2[0] - top2[1]))
            toks.append(int(tok))
            if i + 1 < n_new:
                logits = model(tok[:, None], cache)[:, 0]
    return toks, torch.stack(rows), margins


def _upto_margin(margins, tol):
    """Tokens before the first step whose margin is under ``tol``."""
    return next((i for i, m in enumerate(margins) if m < tol), len(margins))


def _kv_mib(layers):
    """MiB of the K/V leaves (and int8 scales) of cache or pool layers;
    the position counters are not KV."""
    from dtf_tpu_torch.models.gpt import batch_led_cache_key

    return sum(x.numel() * x.element_size() for layer in layers
               for name, x in layer.items()
               if x is not None and batch_led_cache_key(name)) / 2 ** 20


def _engine_kv(engine):
    """KV MiB of the target's slot cache, the draft's and the page pool."""
    return {"target": _kv_mib(engine.state["cache"]),
            "draft": (_kv_mib(engine.draft_state["cache"])
                      if engine.spec_k else 0.0),
            "pool": (_kv_mib(engine.page_store.pool)
                     if engine.page_store is not None else 0.0)}


def _sync_free(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def phase_serve_spec(torch, smi, logdir, plain_run):
    """Speculative decoding on the train phase's GPT-2 small checkpoint at
    full width and depth (bf16), with each draft: serve_gpt's 2
    requests/s traffic beside ``--spec_k 0`` (serve_bench's run of the
    same traffic, ``plain_run``, or one made here) and the engine's tick,
    draft step and verify step measured; then, on the same engine, the
    twelve requests against batch-1 reference streams, the verify step
    teacher-forced (self-draft) and the steps sync-free."""
    import dataclasses
    import gc

    import numpy as np

    from dtf_tpu_torch import serve_gpt
    from dtf_tpu_torch.checkpoint import Checkpointer, load_model_config
    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.profile_serve import measure_decode
    from dtf_tpu_torch.serve import ServeClient

    seconds = {}
    t0 = time.perf_counter()
    ckpt = os.path.join(logdir, "ckpt")
    size = load_model_config(ckpt)["size"]
    cfg = gpt.GPTConfig.by_name(size)
    ref_model = gpt.GPT(dataclasses.replace(cfg, decode_len=SERVE_MAX_LEN,
                                            attn_impl="dense"),
                        device="cuda")
    ref_model.load_state_dict(Checkpointer(ckpt).restore_params())
    ref_model.eval()
    rng = np.random.default_rng(5)
    reqs, refs = [], []
    for i, (t_p, n_new, kw) in enumerate(SERVE_REQUESTS):
        prompt = rng.integers(0, VOCAB_REAL, t_p).tolist()
        sampling = {k: v for k, v in kw.items() if k != "eos"}
        req = {"prompt": prompt, "max_new": n_new, "seed": 40 + i,
               **sampling}
        refs.append(_stream_with_margins(
            torch, ref_model, torch.tensor(prompt, device="cuda"), n_new,
            SERVE_CHUNK, sampling, seed=40 + i))
        if "eos" in kw:
            req["eos_id"] = refs[-1][0][kw["eos"]]
        reqs.append(req)
    del ref_model
    scale = max(r[1].abs().max().item() for r in refs)
    tol = LOGITS_REL_TOL * scale
    seconds["references"] = time.perf_counter() - t0

    flags = [f"--logdir={logdir}", "--poisson_rate=2", *SERVE_BENCH_FLAGS,
             f"--n_requests={SPEC_TRAFFIC_REQUESTS}",
             f"--new_max={SERVE_TRAFFIC_NEW_MAX}"]
    runs, checks, streams = {}, {}, None
    if plain_run is None:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        (out, _, engine), wall = _no_hand_kernels(
            torch, lambda: serve_gpt.run(flags))
        plain_run = _serve_run(torch, out, wall)
        del engine
        seconds["spec_k 0"] = time.perf_counter() - t0
    runs["spec_k 0"] = plain_run
    for name, draft_flag in (("self", f"--draft_ckpt={logdir}"),
                             (f"layers:{SPEC_DRAFT_LAYERS}",
                              f"--draft_layers={SPEC_DRAFT_LAYERS}")):
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # serve_bench's traffic at 2 requests/s through a spec engine
        (out, _, engine), wall = _no_hand_kernels(torch, lambda: serve_gpt.run(
            flags + [f"--spec_k={SPEC_K}", draft_flag]))
        require(out["request_statuses"] == {"done": SPEC_TRAFFIC_REQUESTS},
                f"{name}: statuses {out['request_statuses']}")
        require(engine.trace_counts == {"prefill": 1, "decode": 1,
                                        "draft_prefill": 1, "draft": 1},
                f"{name}: trace_counts {engine.trace_counts}")
        run = _serve_run(torch, out, wall)
        run.update({
            "accept_rate": out["serve_spec_accept_rate"],
            "draft_fallbacks": out["serve_draft_fallbacks"],
            "tokens_per_tick": (out["generated_tokens"] - out["requests"])
            / out["serve_decode_steps"],
            "tokens_per_slot_tick": 1 + SPEC_K
            * out["serve_spec_accept_rate"],
            "kv_mib": _engine_kv(engine)})
        run["decode_step"], _ = _no_hand_kernels(torch, lambda: measure_decode(
            engine, prompt_len=SERVE_PROFILE_PROMPT, steps=SPEC_PROFILE_STEPS,
            profiled=SPEC_PROFILED))
        runs[f"spec_k {SPEC_K} {name}"] = run
        seconds[f"traffic {name}"] = time.perf_counter() - t0

        # the twelve requests on the same engine: each stream equals its
        # reference up to the first margin under the tolerance
        t0 = time.perf_counter()

        def serve():
            client = ServeClient(engine)
            rids = [client.submit(**r) for r in reqs]
            client.drain()
            return ([client.result(rid) for rid in rids],
                    [client.scheduler._recs[rid] for rid in rids])

        (got, recs), wall = _no_hand_kernels(torch, serve)
        compared = 0
        for i, (toks, _, margins) in enumerate(refs):
            upto = _upto_margin(margins, tol)
            if "eos_id" in reqs[i]:
                stop = toks.index(reqs[i]["eos_id"]) + 1
                require(got[i] == toks[:stop], f"{name} request {i}: eos "
                        f"stop {got[i]} vs {toks[:stop]}")
                upto = min(upto, stop)
            else:
                require(len(got[i]) == reqs[i]["max_new"],
                        f"{name} request {i}: {len(got[i])} tokens")
            require(got[i][:upto] == toks[:upto],
                    f"{name} request {i}: spec and reference tokens differ "
                    f"before step {upto} (the first margin under {tol})")
            compared += upto
        if streams is None:
            streams = got
        else:                 # one verifier: the drafts move no token
            checks["streams_equal_across_drafts"] = sum(
                a == b for a, b in zip(streams, got))
        greedy = [r for r, q in zip(recs, reqs) if "temperature" not in q]
        prop = sum(r.proposed for r in greedy)
        acc = sum(r.accepted for r in greedy)
        checks[name] = {"tokens_compared": compared,
                        "greedy_proposed": prop, "greedy_accepted": acc,
                        "greedy_accept_rate": acc / prop,
                        "accept_rate": sum(r.accepted for r in recs)
                        / sum(r.proposed for r in recs),
                        "draft_fallbacks": engine.counters["draft_fallbacks"],
                        "serve_wall_s": wall}
        if name == "self":
            require(acc / prop >= SPEC_SELF_ACCEPT_MIN,
                    f"self-draft greedy acceptance {acc}/{prop} under "
                    f"{SPEC_SELF_ACCEPT_MIN}: the draft and the verifier "
                    "disagree on the same model")
            checks[name]["teacher_forced"] = _verify_teacher_forced(
                torch, engine, reqs, refs, tol)
        prompt = reqs[1]["prompt"][:SERVE_CHUNK + 5]

        def steps():
            for c in range(2):
                engine.prefill_into_slot(0, prompt, c, seed=3,
                                         **SERVE_SAMPLED)
            for _ in range(2):
                engine.decode_all()
            engine.verify_all(engine.draft_propose())

        _sync_free(torch, steps)
        seconds[f"checks {name}"] = time.perf_counter() - t0
        del engine
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_spec", "model": f"gpt2-{size}", "nvidia_smi": smi,
          "spec_k": SPEC_K, "requests": len(reqs),
          "rel_tol": LOGITS_REL_TOL, "max_abs_logit": scale,
          "checks": checks, "sync_free": ["prefill_into_slot (with its "
                                          "draft chunk)", "draft_propose",
                                          "verify_all"],
          "hand_kernel_launches": 0, "traffic": flags[1:],
          "note_traffic": "the spec runs serve the first "
                          f"{SPEC_TRAFFIC_REQUESTS} of serve_bench's "
                          f"requests, at most {SERVE_TRAFFIC_NEW_MAX} new "
                          "tokens each; its plain run serves all of them",
          "runs": runs, "seconds": seconds})


def _verify_teacher_forced(torch, engine, reqs, refs, tol):
    """The greedy requests' reference tokens fed through the model's slot
    VERIFY step, k + 1 a call, each row at its own position: every
    position's logits against sequential decode's (the reference rows)."""
    greedy = [i for i, r in enumerate(reqs) if "temperature" not in r]
    st, k = engine.state, engine.spec_k
    st["active"].zero_()
    for s, i in enumerate(greedy):
        engine.prefill(s, reqs[i]["prompt"])
    worst, compared, j = 0.0, 0, 1
    with torch.no_grad():
        while True:
            live = [s for s, i in enumerate(greedy) if j < len(refs[i][0])]
            if not live:
                break
            inputs = torch.zeros(engine.n_slots, k + 1, dtype=torch.long)
            st["active"].zero_()
            for s in live:
                seq = refs[greedy[s]][0][j - 1:j + k]
                inputs[s, :len(seq)] = torch.tensor(seq)
                st["active"][s] = True
            logits = engine._model(inputs.cuda(), st["cache"],
                                   decode_active=st["active"])
            for s in live:
                toks, rows, _ = refs[greedy[s]]
                n = min(k + 1, len(toks) - j)
                d = (logits[s, :n] - rows[j:j + n]).abs().max().item()
                require(math.isfinite(d), f"slot {s} at {j}: non-finite")
                worst = max(worst, d)
                compared += n
            j += k + 1
    require(worst <= tol, f"teacher-forced verify logits differ from "
                          f"sequential decode by {worst} (> {tol}) over "
                          f"{compared} positions")
    return {"positions": compared, "max_abs_diff": worst, "tol": tol}


def _pages_requests(path):
    """PAGES_REQUESTS rows made from a seed: one stem of PAGES_STEM
    tokens, each request its own tail and budget (``toks/N``); written to
    ``path``. Returns the prompts and budgets."""
    import numpy as np

    rng = np.random.default_rng(21)
    stem = rng.integers(0, VOCAB_REAL, PAGES_STEM).tolist()
    reqs = []
    for _ in range(PAGES_REQUESTS):
        tail = rng.integers(0, VOCAB_REAL, int(rng.integers(
            PAGES_TAIL[0], PAGES_TAIL[1] + 1))).tolist()
        reqs.append((stem + tail, int(rng.integers(PAGES_NEW[0],
                                                   PAGES_NEW[1] + 1))))
    with open(path, "w") as f:
        f.write("\n".join(",".join(map(str, p)) + f"/{n}" for p, n in reqs))
    return reqs


def _differ_at_near_ties(torch, engine, reqs, rows_a, rows_b, what):
    """Greedy ``rid:tok,...`` rows of two runs of ``reqs`` (prompt,
    budget) on ``engine``'s weights: where a pair differs, the first
    differing token must sit on a near-tie — the top-2 margin of the
    dense model's logits after the common prefix under
    ``LOGITS_REL_TOL`` of the largest. Returns the differences."""
    import dataclasses

    from dtf_tpu_torch.models import gpt

    ref_model = gpt.GPT(dataclasses.replace(engine.cfg, attn_impl="dense"),
                        device="cuda")
    ref_model.load_state_dict(engine._model.state_dict())
    ref_model.eval()
    differ = []
    for i, (a, b) in enumerate(zip(rows_a, rows_b)):
        if a == b:
            continue
        ta = [int(t) for t in a.split(":")[1].split(",")]
        tb = [int(t) for t in b.split(":")[1].split(",")]
        p = next(j for j, (x, y) in enumerate(zip(ta, tb)) if x != y)
        with torch.no_grad():
            cache = ref_model.init_cache(1)
            seq = torch.tensor(reqs[i][0] + ta[:p], device="cuda")
            logits = gpt._prefill(ref_model, cache, seq[None],
                                  SERVE_CHUNK)[0, -1]
        top2 = logits.topk(2).values
        scale = logits.abs().max().item()
        margin = (top2[0] - top2[1]).item()
        require(margin < LOGITS_REL_TOL * scale,
                f"request {i}: {what} differ at token {p} where the "
                f"margin {margin} is over {LOGITS_REL_TOL} x {scale}")
        differ.append({"request": i, "token": p, "margin": margin})
    require(len(rows_a) == len(rows_b), f"{what}: row counts differ")
    return differ


def phase_serve_pages(torch, smi, logdir):
    """The prefix page pool on the train phase's checkpoint: a seeded
    requests file on one 512-token stem through serve_gpt with the pool
    on and off; streams, counters, the drained pins; then a load's bitwise
    check and both page steps sync-free. Returns both runs' rows and
    numbers, and the requests (serve_fleet's single-engine side)."""
    import gc

    from dtf_tpu_torch import serve_gpt

    path = os.path.join(logdir, "pages_requests.txt")
    reqs = _pages_requests(path)
    flags = [f"--logdir={logdir}", f"--requests=@{path}", *PAGES_SERVE_FLAGS]
    runs, rows = {}, {}
    engine = None
    for name, extra in (("pages_off", ()), ("pages_on", PAGES_FLAGS)):
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (out, rows[name], engine), wall = _no_hand_kernels(
            torch, lambda: serve_gpt.run(flags + list(extra)))
        require(out["request_statuses"] == {"done": PAGES_REQUESTS},
                f"{name}: statuses {out['request_statuses']}")
        runs[name] = {**_serve_run(torch, out, wall),
                      "kv_mib": _engine_kv(engine),
                      **{k: out.get(k, 0.0) for k in (
                          "serve_prefix_hit_tokens",
                          "serve_prefix_miss_tokens", "serve_pages_saved",
                          "serve_pages_loaded", "serve_prefix_hits",
                          "serve_prefix_misses", "serve_prefix_pinned",
                          "serve_prefix_pages")}}
    on = runs["pages_on"]
    saved0 = engine.counters["pages_saved"]
    require(on["serve_prefix_pinned"] == 0.0, f"pins left: {on}")
    require(on["serve_pages_loaded"] >= (PAGES_REQUESTS - 2)
            * PAGES_STEM // 16, f"too few pages loaded: {on}")

    # greedy streams: pool on == pool off, but where the pool-off stream
    # sits on a near-tie (teacher-forced margin under the tolerance)
    differ = _differ_at_near_ties(torch, engine, reqs, rows["pages_off"],
                                  rows["pages_on"], "pool on and off")

    # a load is a bitwise copy of the pool and of a fresh prefill; a
    # prompt seen twice saves its two new pages
    store = engine.page_store
    engine.state["active"].zero_()
    stem = reqs[0][0][:PAGES_STEM]
    fresh_prompt = stem + list(range(60, 100))
    engine.prefill(0, fresh_prompt)
    _sync_free(torch, lambda: [engine.save_prefix_pages(0, fresh_prompt)
                               for _ in range(2)])
    require(engine.counters["pages_saved"] == saved0 + 2,
            f"{engine.counters['pages_saved'] - saved0} pages saved of 2")
    handle = engine.prefix_match(stem + [10, 11])
    require(handle is not None and handle.n_tokens == PAGES_STEM,
            f"no full-stem hit: {handle}")
    _sync_free(torch, lambda: engine.load_prefix(1, handle))
    ids = torch.tensor([e.page_id for e in handle.entries], device="cuda")
    bitwise = True
    for layer, pages in zip(engine.state["cache"], store.pool):
        for name, x in layer.items():
            if x is None or name == "cache_index":
                continue
            got = x[1, :, :PAGES_STEM]
            fresh = x[0, :, :PAGES_STEM]
            pooled = pages[name].index_select(0, ids).transpose(0, 1)
            bitwise &= bool(torch.equal(got, fresh)) and bool(torch.equal(
                got, pooled.reshape(got.shape)))
    require(bitwise, "a loaded slot differs from the pool pages or from a "
                     "fresh prefill of the same stem")
    engine.release_prefix(handle)
    require(engine.prefix_stats()["pinned"] == 0, "pins left after the "
                                                  "checks")
    emit({"phase": "serve_pages", "model": "gpt2-small", "nvidia_smi": smi,
          "requests": PAGES_REQUESTS, "stem": PAGES_STEM,
          "tail": list(PAGES_TAIL), "new": list(PAGES_NEW),
          "flags": list(PAGES_SERVE_FLAGS) + list(PAGES_FLAGS),
          "runs": runs, "streams_equal": PAGES_REQUESTS - len(differ),
          "streams_differ_at_near_ties": differ,
          "load_bitwise": bitwise, "sync_free": ["load_prefix",
                                                  "save_prefix_pages"],
          "page_trace_counts": engine.page_trace_counts,
          "hand_kernel_launches": 0})
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"rows": rows, "runs": runs, "reqs": reqs}


#: serve_fleet: 2 replicas of serve_bench's engine shape; the wedge plan
#: of run (c): replica 0's decode calls from the FLEET_WEDGE_AT-th on
#: sleep FLEET_WEDGE_S, past the watchdog's bars (the slow bar's adaptive
#: part is 20 x p99 of the healthy ticks: a tick of 4 prefill chunks and
#: a decode is ~0.25 s on one H100, so ~5 s), so the first wedged tick
#: quarantines it; its probation is put off past the run. The 50th decode
#: falls while the requests still arrive, so some are in flight there
FLEET_REPLICAS = 2
FLEET_WEDGE_AT, FLEET_WEDGE_S, FLEET_HEALTH_S = 50, 12.0, 8.0
FLEET_FLAGS = (f"--replicas={FLEET_REPLICAS}", "--emit_tokens")


def _fleet_requests(path, reqs):
    """serve_engine's twelve requests written as a ``--requests`` file
    (prompt and budget; the sampling is set per run)."""
    with open(path, "w") as f:
        f.write("\n".join(",".join(map(str, r["prompt"]))
                          + f"/{r['max_new']}" for r in reqs))


def _tok_lat(router):
    from dtf_tpu_torch.metrics import quantile

    lats = [t for s in router.schedulers for t in s._tok_lats]
    return {"tok_latency_p50_s": quantile(lats, 0.5),
            "tok_latency_p99_s": quantile(lats, 0.99)}


def _fleet_run(out, wall, router):
    """One fleet serve_gpt run's numbers."""
    keys = ("router_ttft_p50_s", "router_ttft_p99_s", "router_ticks",
            "router_requeued", "router_quarantines",
            "router_prefill_chunks", "router_decode_steps", "cache_mib",
            *(f"replica{i}_{k}" for i in range(FLEET_REPLICAS)
              for k in ("serve_occupancy_mean", "serve_completed",
                        "serve_requeued_in", "health")),
            *(f"{name}_{stat}" for name in ("cp_pick", "cp_engine_tick",
                                            "cp_health_sweep", "cp_page_ops",
                                            "cp_bookkeeping")
              for stat in ("total_s", "mean_s", "p99_s")))
    return {"wall_s": out["wall_s"], "in_process_wall_s": wall,
            "generated_tokens": out["generated_tokens"],
            "tokens_per_sec": out["tokens_per_sec"],
            "router_tick_ms_mean": out["wall_s"] * 1e3 / out["router_ticks"],
            **_tok_lat(router), **{k: out.get(k) for k in keys}}


def phase_serve_fleet(torch, smi, logdir, pages):
    """The serving fleet on the train phase's checkpoint, GPT-2 small at
    full width, 2 replicas of 16 slots of 1024, chunk 128, through
    ``serve_gpt --replicas 2``: (a) serve_engine's twelve requests
    (greedy and sampled, a stop token) bit-equal to one engine's; (b)
    serve_bench's 2 requests/s traffic; (c) the same traffic with replica
    0 wedged: it is
    quarantined, its requests requeued, every stream equal to (b)'s; (d)
    ``--prefill_replicas 1`` on serve_pages' 16 requests, streams equal
    to the one engine's pool-off run but at near-ties, TTFT beside the
    one engine with pages. One set of weights; no hand kernel launches."""
    import gc

    import numpy as np

    from dtf_tpu_torch import serve_gpt
    from dtf_tpu_torch.checkpoint import Checkpointer, load_model_config
    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.serve import (DecodeEngine, Request, Router,
                                     Scheduler)

    seconds = {}
    ckpt = os.path.join(logdir, "ckpt")
    cfg = gpt.GPTConfig.by_name(load_model_config(ckpt)["size"])
    params = Checkpointer(ckpt).restore_params()

    # (a) the twelve requests: a fleet of two against one engine
    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    reqs = []
    for i, (t_p, n_new, kw) in enumerate(SERVE_REQUESTS):
        reqs.append({"prompt": rng.integers(0, VOCAB_REAL, t_p).tolist(),
                     "max_new": n_new, "seed": 40 + i,
                     **{k: v for k, v in kw.items() if k != "eos"},
                     **({"eos_id": 2} if "eos" in kw else {})})
    shape = dict(n_slots=16, max_len=SERVE_MAX_LEN,
                 prefill_chunk=SERVE_CHUNK)

    def streams(pump):
        rids = [pump.submit(Request(**r)) for r in reqs]
        pump.run_until_idle()
        return [pump.poll(rid)["tokens"] for rid in rids]

    one = DecodeEngine(cfg, params, **shape)
    single, _ = _no_hand_kernels(torch, lambda: streams(Scheduler(one)))
    del one
    router = Router.build(cfg, params, n_replicas=FLEET_REPLICAS, **shape)
    del params
    fleet, _ = _no_hand_kernels(torch, lambda: streams(router))
    require(fleet == single, "the fleet's streams differ from one engine's: "
            + str([i for i, (a, b) in enumerate(zip(fleet, single))
                   if a != b]))
    placed = sorted({router.replica_of(r) for r in range(len(reqs))})
    require(placed == list(range(FLEET_REPLICAS)),
            f"the twelve requests all went to replicas {placed}")
    models = [s.engine._model for s in router.schedulers]
    shared = all(p.data_ptr() == q.data_ptr() for m in models[1:]
                 for p, q in zip(models[0].parameters(), m.parameters()))
    require(shared, "the replicas do not share their weight tensors")
    require(router.trace_counts() == [{"prefill": 1, "decode": 1}]
            * FLEET_REPLICAS, f"trace_counts {router.trace_counts()}")
    del router, models
    gc.collect()
    torch.cuda.empty_cache()
    seconds["identity"] = time.perf_counter() - t0

    # (b) serve_bench's 2 requests/s traffic; (c) the same with a wedge
    runs, rows, fleets = {}, {}, {}
    flags = [f"--logdir={logdir}", "--poisson_rate=2", *SERVE_BENCH_FLAGS,
             f"--new_max={SERVE_TRAFFIC_NEW_MAX}", *FLEET_FLAGS]
    wedge = {"DTF_FAULT_INJECT": f"wedge_replica@{FLEET_WEDGE_AT}:replica=0",
             "DTF_FAULT_WEDGE_S": str(FLEET_WEDGE_S)}
    for name, env, extra in (
            ("traffic", {}, ()),
            ("quarantine", wedge, (f"--health_slow_s={FLEET_HEALTH_S}",
                                   f"--health_wedge_s={FLEET_HEALTH_S}",
                                   "--health_probation_s=3600"))):
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        os.environ.update(env)
        try:
            (out, rows[name], fleets[name]), wall = _no_hand_kernels(
                torch, lambda: serve_gpt.run(flags + list(extra)))
        finally:
            for key in env:
                os.environ.pop(key)
        require(out["request_statuses"] == {"done": SERVE_BENCH_REQUESTS},
                f"{name}: statuses {out['request_statuses']}")
        runs[name] = {**_fleet_run(out, wall, fleets[name]),
                      "fault_inject": out["fault_inject"]}
        seconds[name] = time.perf_counter() - t0
    q = fleets["quarantine"]
    requeued = sorted(rid for rid in range(SERVE_BENCH_REQUESTS)
                      if q.schedulers[
        q.replica_of(rid)]._recs[q._where[rid][1]].requeued)
    require(runs["quarantine"]["router_quarantines"] == 1.0
            and runs["quarantine"]["replica0_health"] == "quarantined",
            f"the wedge did not quarantine replica 0: {runs['quarantine']}")
    require(runs["quarantine"]["replica1_serve_requeued_in"] > 0
            and requeued, "no request was requeued")
    differ = [i for i, (a, b) in enumerate(zip(rows["traffic"],
                                               rows["quarantine"]))
              if a != b]
    require(not differ, f"streams differ from the fault-free run's: {differ} "
                        f"(requeued {requeued})")
    del fleets, q

    # (d) disaggregation on serve_pages' requests against one engine
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    path = os.path.join(logdir, "fleet_pages_requests.txt")
    preqs = _pages_requests(path)
    base = [f"--logdir={logdir}", f"--requests=@{path}", *PAGES_SERVE_FLAGS]
    if pages is None:
        pages = {"rows": {}, "runs": {}}
        for name, extra in (("pages_off", ()), ("pages_on", PAGES_FLAGS)):
            (out, pages["rows"][name], engine), wall = _no_hand_kernels(
                torch, lambda: serve_gpt.run(base + list(extra)))
            pages["runs"][name] = _serve_run(torch, out, wall)
    (out, rows["disagg"], disagg), wall = _no_hand_kernels(
        torch, lambda: serve_gpt.run(
            base + list(PAGES_FLAGS) + [f"--replicas={FLEET_REPLICAS}",
                                        "--prefill_replicas=1"]))
    require(out["request_statuses"] == {"done": PAGES_REQUESTS},
            f"disagg: statuses {out['request_statuses']}")
    require(out["router_handoffs"] > 0 and out["router_pages_loaded"] > 0,
            f"no handoff carried pages: {out}")
    require(all(s.engine.prefix_stats()["pinned"] == 0
                for s in disagg.schedulers), "pins left")
    differ_d = _differ_at_near_ties(
        torch, disagg.schedulers[1].engine, preqs,
        pages["rows"]["pages_off"], rows["disagg"], "disagg and pool off")
    runs["disagg"] = {**_fleet_run(out, wall, disagg),
                      "router_handoffs": out["router_handoffs"],
                      "router_pages_loaded": out["router_pages_loaded"],
                      "router_pages_saved": out["router_pages_saved"],
                      "streams_equal": PAGES_REQUESTS - len(differ_d),
                      "streams_differ_at_near_ties": differ_d,
                      "one_engine_pages_on": {
                          k: pages["runs"]["pages_on"][k] for k in (
                              "serve_ttft_p50_s", "serve_ttft_p99_s",
                              "tokens_per_sec", "wall_s")}}
    del disagg
    gc.collect()
    torch.cuda.empty_cache()
    seconds["disagg"] = time.perf_counter() - t0
    emit({"phase": "serve_fleet", "model": "gpt2-small", "nvidia_smi": smi,
          "replicas": FLEET_REPLICAS, "flags": list(SERVE_BENCH_FLAGS),
          "identity": {"requests": len(reqs), "bit_equal": True,
                       "replicas_used": placed, "weights_shared": True,
                       "tokens": sum(map(len, fleet))},
          "runs": runs, "requeued": requeued,
          "wedge": {"at_decode": FLEET_WEDGE_AT, "sleep_s": FLEET_WEDGE_S,
                    "health_slow_and_wedge_s": FLEET_HEALTH_S},
          "hand_kernel_launches": 0, "seconds": seconds})


#: publish_swap: train_gpt publishes every SWAP_PUBLISH_EVERY of
#: SWAP_TRAIN_STEPS steps at batch SWAP_BATCH (versions 1 and 2); a fleet
#: of FLEET_REPLICAS starts on version 1 and rolls to 2 while serving
#: SWAP_REQUESTS greedy requests of serve_engine's shapes, polling every
#: SWAP_POLL_TICKS ticks, the canary alone for SWAP_CANARY_TICKS
SWAP_TRAIN_STEPS, SWAP_PUBLISH_EVERY, SWAP_BATCH = 4, 2, 4
SWAP_REQUESTS, SWAP_POLL_TICKS, SWAP_CANARY_TICKS = 16, 4, 8
#: the roll's peak memory may exceed a fresh fleet's on the new version by
#: one set of parameters (the new set placed while the old one serves)
#: and this much for allocations that differ with the requeues
SWAP_PEAK_SLACK_BYTES = 64 * 2 ** 20


def phase_publish_swap(torch, smi):
    """Train → publish → poll → rolling swap on GPT-2 small at full width:
    (a) ``train_gpt`` (``--attn_impl flash``, batch 4 x 1024, 4 steps)
    with ``--publish_dir --publish_every 2``: versions 1 and 2 in the
    manifest, each digest verified, B1-B3 launches counted; (b)
    ``serve_gpt --replicas 2 --publish_dir --publish_version 1
    --swap_poll_ticks 4 --canary_ticks 8`` on 16 greedy requests: one
    swap to version 2, no rollback, all done, every record stamped 1 or
    2, the streams stamped 2 bit-equal to a fresh ``--publish_version 2``
    fleet's, ``trace_counts`` pinned, the replicas on one set of tensors
    (version 2's), the roll's peak memory within one set of parameters of
    the fresh fleet's, and no hand kernel in serving. The run-record
    plane: the trainer's event log, the rolling fleet's event log, sink
    and trace checked against what ran (:func:`_check_plane`), and a roll
    with the plane off serving the same rows, stamps and ticks. Prints the
    swap's steps on the router's clock, a version's load ms, the plane's
    counts, the tick ms with the plane on and off and the phase's
    seconds."""
    import gc
    import tempfile

    import numpy as np

    from dtf_tpu_torch import serve_gpt, train_gpt
    from dtf_tpu_torch.checkpoint import Checkpointer
    from dtf_tpu_torch.data.stream.servelog import decode_record, \
        read_manifest as read_sink_manifest
    from dtf_tpu_torch.publish import dir_digest, load_published, \
        read_manifest
    from dtf_tpu_torch.telemetry.events import EventLog, read_events

    t_phase = time.perf_counter()
    seconds = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_swap_")
    pub = os.path.join(root, "publish")

    # (a) the trainer publishes, with its event log; each emit notes the
    # version the publish manifest names at that moment
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    train_events = os.path.join(root, "train_events")
    manifest_at_emit = []
    emit_event = EventLog.emit

    def noting_emit(self, kind, /, **fields):
        if kind == "publish_version":
            manifest_at_emit.append(read_manifest(pub)["version"])
        return emit_event(self, kind, **fields)

    EventLog.emit = noting_emit
    try:
        (state, _), fused, flash, embed, train_wall = _counted(
            torch, lambda: train_gpt.run([
                "--size=small", f"--batch_size={SWAP_BATCH}",
                f"--seq_len={TRAIN_SEQ}", "--attn_impl=flash", "--seed=0",
                f"--train_steps={SWAP_TRAIN_STEPS}", "--log_every=1",
                "--checkpoint_every=1000", f"--logdir={root}/run",
                f"--publish_dir={pub}",
                f"--publish_every={SWAP_PUBLISH_EVERY}",
                f"--event_log_dir={train_events}"]))
    finally:
        EventLog.emit = emit_event
    want = {"flash_fwd": 12 * (SWAP_TRAIN_STEPS + EVAL_BATCHES),
            "flash_fwd_hfold": 0, "flash_dq": 12 * SWAP_TRAIN_STEPS,
            "flash_dkv": 12 * SWAP_TRAIN_STEPS}
    require(state.step == SWAP_TRAIN_STEPS, f"trained to {state.step}")
    require(flash == want, f"train launches {flash} != {want}")
    require(not any(fused.values()) and not embed,
            f"other hand kernels launched: {fused}, B8 {embed}")
    del state
    m = read_manifest(pub)
    versions = sorted(int(v) for v in m["history"])
    require(m["version"] == 2 and versions == [1, 2]
            and [m["history"][str(v)]["step"] for v in versions] == [2, 4],
            f"manifest {m}")
    for v in versions:
        require(dir_digest(os.path.join(pub, str(v)))
                == m["history"][str(v)]["digest"],
                f"version {v} fails its digest")
    tev = read_events(train_events, include_orphans=False)
    seqs = [e["seq"] for e in tev]
    require(all(b > a for a, b in zip(seqs, seqs[1:])),
            f"train event seq not strictly increasing: {seqs}")
    pubs = [e for e in tev if e["event"] == "publish_version"]
    require([(e["version"], e["step"]) for e in pubs] == [(1, 2), (2, 4)]
            and [e["digest"] for e in pubs]
            == [m["history"][str(v)]["digest"] for v in versions],
            f"publish_version events {pubs}")
    require(manifest_at_emit == [1, 2],
            f"publish_version emitted before its commit: {manifest_at_emit}")
    saves = [e["step"] for e in tev if e["event"] == "ckpt_save"]
    ckpt_steps = Checkpointer(os.path.join(root, "run", "ckpt")).all_steps()
    require(saves == ckpt_steps, f"ckpt_save {saves} != steps {ckpt_steps}")
    require(tev[-1]["event"] == "train_end"
            and tev[-1]["step"] == SWAP_TRAIN_STEPS, f"last {tev[-1]}")
    train_kinds = {}
    for e in tev:
        train_kinds[e["event"]] = train_kinds.get(e["event"], 0) + 1
    seconds["train_publish"] = time.perf_counter() - t0

    # a version's load: digest + read on the host, then onto the card
    t0 = time.perf_counter()
    _, _, v2 = load_published(pub, version=2)
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    v2_card = {n: x.cuda() for n, x in v2.items()}
    torch.cuda.synchronize()
    place_ms = (time.perf_counter() - t0) * 1e3
    param_bytes = sum(x.numel() * x.element_size() for x in v2.values())
    del v2

    # (b) the fleet rolls from 1 to 2 while serving, then a fresh fleet
    rng = np.random.default_rng(7)
    path = os.path.join(root, "requests.txt")
    with open(path, "w") as f:
        for i in range(SWAP_REQUESTS):
            t_p, n_new, _ = SERVE_REQUESTS[i % len(SERVE_REQUESTS)]
            f.write(",".join(map(str, rng.integers(0, VOCAB_REAL, t_p)))
                    + f"/{n_new}\n")
    base = [f"--publish_dir={pub}", f"--replicas={FLEET_REPLICAS}",
            "--n_slots=16", f"--max_len={SERVE_MAX_LEN}",
            f"--prefill_chunk={SERVE_CHUNK}", f"--requests=@{path}",
            "--emit_tokens"]
    roll = ["--publish_version=1", f"--swap_poll_ticks={SWAP_POLL_TICKS}",
            f"--canary_ticks={SWAP_CANARY_TICKS}"]
    plane_dir = os.path.join(root, "plane")
    plane = [f"--event_log_dir={plane_dir}/events",
             f"--log_sink_dir={plane_dir}/sink",
             f"--trace_out={plane_dir}/trace/trace.json"]
    runs, rows, peaks, stamps_of, outs = {}, {}, {}, {}, {}
    t_serve = time.perf_counter()
    # the plane-off roll first: the first serving run after the trainer
    # pays the allocator's growth, which must not count against the plane
    for name, extra in (("swap_plane_off", roll), ("swap", roll + plane),
                        ("fresh_v2", ["--publish_version=2"])):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (out, rows[name], router), wall = _no_hand_kernels(
            torch, lambda: serve_gpt.run(base + extra))
        peaks[name] = torch.cuda.max_memory_allocated()
        require(out["request_statuses"] == {"done": SWAP_REQUESTS},
                f"{name}: statuses {out['request_statuses']}")
        require(router.trace_counts() == [{"prefill": 1, "decode": 1}]
                * FLEET_REPLICAS, f"{name}: {router.trace_counts()}")
        stamps = [router.poll(r)["version"] for r in range(SWAP_REQUESTS)]
        stamps_of[name], outs[name] = stamps, out
        runs[name] = {k: out.get(k) for k in (
            "served_version", "final_version", "router_swaps",
            "router_swap_rollbacks", "router_requeued", "router_ticks",
            "router_param_swaps", "router_probe_decodes", "wall_s",
            "tokens_per_sec", "generated_tokens", "serve_swap_p50_s",
            "serve_swap_p99_s", "router_events", "router_log_sink_records",
            "trace_events")}
        runs[name].update({"in_process_wall_s": wall, "stamps": stamps,
                           "peak_bytes": peaks[name],
                           "tick_ms": out["wall_s"] * 1e3
                           / out["router_ticks"],
                           "cp_ms_per_tick": 1e3 * sum(
                               out[f"{k}_total_s"] for k in (
                                   "cp_pick", "cp_engine_tick",
                                   "cp_health_sweep", "cp_page_ops",
                                   "cp_bookkeeping"))
                           / out["router_ticks"]})
        if name == "swap":
            plane_line = _check_plane(
                plane_dir, out, rows[name], stamps,
                [router.replica_of(r) for r in range(SWAP_REQUESTS)],
                read_events, read_sink_manifest, decode_record)
            require(out["served_version"] == 1 and out["final_version"] == 2
                    and out["router_swaps"] == 1.0
                    and out["router_swap_rollbacks"] == 0.0,
                    f"swap: {runs[name]}")
            require(set(stamps) <= {1, 2} and 2 in stamps,
                    f"swap: record stamps {stamps}")
            models = [s.engine._model for s in router.schedulers]
            shared = all(p.data_ptr() == q.data_ptr() for mdl in models[1:]
                         for p, q in zip(models[0].parameters(),
                                         mdl.parameters()))
            require(shared, "after the roll the replicas hold two sets")
            own = dict(models[0].named_parameters())
            require(all(torch.equal(own[n], x) for n, x in v2_card.items()),
                    "the replicas do not serve version 2's weights")
            runs[name]["swap_profile"] = router.swap_profile()
            swap_stamps = stamps
            del models, own
        del router
    del v2_card
    gc.collect()
    torch.cuda.empty_cache()
    after = [r for r, v in enumerate(swap_stamps) if v == 2]
    differ = [r for r in after if rows["swap"][r] != rows["fresh_v2"][r]]
    require(not differ, f"streams on version 2 differ from a fresh "
                        f"version-2 fleet's: {differ}")
    # the plane changes no token, no stamp and no tick of the roll
    require(rows["swap"] == rows["swap_plane_off"]
            and stamps_of["swap"] == stamps_of["swap_plane_off"]
            and outs["swap"]["router_ticks"]
            == outs["swap_plane_off"]["router_ticks"],
            "the roll with the plane on differs from the roll with it off")
    extra_peak = peaks["swap"] - peaks["fresh_v2"]
    require(extra_peak <= param_bytes + SWAP_PEAK_SLACK_BYTES,
            f"the roll's peak is {extra_peak} bytes over a fresh fleet's, "
            f"past one set of parameters ({param_bytes})")
    shutil.rmtree(root, ignore_errors=True)
    seconds["serve"] = time.perf_counter() - t_serve
    seconds["phase"] = time.perf_counter() - t_phase
    prof = runs["swap"]["swap_profile"]
    emit({"phase": "publish_swap", "model": "gpt2-small", "nvidia_smi": smi,
          "train": {"batch": SWAP_BATCH, "seq": TRAIN_SEQ,
                    "steps": SWAP_TRAIN_STEPS,
                    "publish_every": SWAP_PUBLISH_EVERY,
                    "flash_launches": flash, "wall_s": train_wall,
                    "versions": versions},
          "version_load_ms": load_ms, "version_to_card_ms": place_ms,
          "param_bytes": param_bytes,
          "swap_ms": {k: {"mean": prof[k]["mean_s"] * 1e3,
                          "p99": prof[k]["p99_s"] * 1e3,
                          "count": prof[k]["count"]}
                      for k in prof},
          "peak_extra_bytes": extra_peak, "runs": runs,
          "streams_after_swap_equal": len(after),
          "plane": {"train_events": train_kinds, **plane_line,
                    "tick_ms_plane_on": runs["swap"]["tick_ms"],
                    "tick_ms_plane_off": runs["swap_plane_off"]["tick_ms"],
                    "cp_ms_per_tick_plane_on":
                        runs["swap"]["cp_ms_per_tick"],
                    "cp_ms_per_tick_plane_off":
                        runs["swap_plane_off"]["cp_ms_per_tick"]},
          "hand_kernel_launches_serving": 0, "seconds": seconds})
    return {"launches": flash}


def _check_plane(plane_dir, out, rows, stamps, replicas, read_events,
                 read_sink_manifest, decode_record):
    """The rolling fleet's run-record plane against what the run served:
    the event log's swap story, one CRC-valid sink record a request (its
    emitted row, version stamp and replica), and a loadable trace with one
    lifecycle slice a request and every engine slice on a live trace id.
    Returns the counts to print."""
    events = read_events(os.path.join(plane_dir, "events"))
    kinds = {}
    for e in events:
        kinds[e["event"]] = kinds.get(e["event"], 0) + 1
    swaps = [(e["event"], e["version"]) for e in events
             if e["event"] in ("swap_start", "swap_commit", "swap_rollback")]
    require(swaps == [("swap_start", 2), ("swap_commit", 2)],
            f"swap events {swaps}")
    require(events[-1]["event"] == "serve_summary"
            and events[-1]["requests"] == SWAP_REQUESTS,
            f"last event {events[-1]}")
    require(out["event_log"]["events"] == len(events)
            and out["event_log"]["io_errors"] == 0, f"{out['event_log']}")
    sink_dir = os.path.join(plane_dir, "sink")
    manifest = read_sink_manifest(sink_dir)
    recs, sink_bytes = [], 0
    for shard in manifest["shards"]:
        path = os.path.join(sink_dir, shard["name"])
        sink_bytes += os.path.getsize(path)
        with open(path) as f:
            recs += [decode_record(ln) for ln in f.read().splitlines()]
    require(len(recs) == SWAP_REQUESTS == manifest["records"]
            and all(r is not None for r in recs),
            f"sink: {len(recs)} records, manifest {manifest['records']}, "
            f"{sum(r is None for r in recs)} failing their CRC")
    for r in recs:
        rid = r["rid"]
        require(rows[rid] == f"{rid}:" + ",".join(map(str, r["tokens"]))
                and r["version"] == stamps[rid]
                and r["replica"] == replicas[rid] and r["status"] == "done",
                f"sink record of request {rid} differs from what it served")
    require(sorted(r["rid"] for r in recs) == list(range(SWAP_REQUESTS)),
            "sink records are not one a request")
    with open(os.path.join(plane_dir, "trace", "trace.json")) as f:
        trace = json.load(f)["traceEvents"]
    require(len(trace) == out["trace_events"],
            f"trace {len(trace)} events, line {out['trace_events']}")
    rids = set(range(SWAP_REQUESTS))
    lifecycles = [e["tid"] for e in trace if e["name"] == "request"]
    waits = [e["tid"] for e in trace if e["name"] == "queue_wait"]
    require(sorted(lifecycles) == sorted(rids),
            f"request slices {sorted(lifecycles)}")
    # one queue wait an admission: a request the drain requeued after its
    # admission waits again on the survivor
    require(set(waits) == rids
            and len(waits) <= SWAP_REQUESTS + out["router_requeued"],
            f"{len(waits)} queue_wait slices")
    engine = [e for e in trace if e["cat"] == "engine"]
    live = all((set(e["args"]["trace_ids"]) <= rids and e["tid"] == "engine")
               if e["name"] == "serve_decode" else e["tid"] in rids
               for e in engine)
    require(engine and live, "an engine slice on no live trace id")
    return {"events": kinds, "sink_records": len(recs),
            "sink_bytes": sink_bytes, "sink_shards": len(manifest["shards"]),
            "trace_events": len(trace), "queue_wait_slices": len(waits),
            "engine_slices": len(engine)}


def _train_batch(torch, cfg, step=0):
    from dtf_tpu_torch.data.synthetic import SyntheticData

    b = SyntheticData("gpt", TRAIN_BATCH, seed=0, seq_len=TRAIN_SEQ,
                      vocab_size=cfg.vocab_size).batch(step)
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def phase_train_grads(torch):
    """GPT-2 small at full width, the trainer's init, one 8 x 1024 batch:
    loss and every gradient on the flash path against the dense path, and
    the kernels' launches per step (with and without remat)."""
    import dataclasses

    from dtf_tpu_torch.convert import init_params_flax, params_from_flax
    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.ops import flash_attention as fa

    base = gpt.GPTConfig.gpt2_small()
    state_dict = params_from_flax(init_params_flax(base, 0))
    batch = _train_batch(torch, base)
    rows = []
    for remat in (False, True):
        got = {}
        for impl in ("flash", "dense"):
            model = gpt.GPT(dataclasses.replace(base, attn_impl=impl,
                                                remat=remat), device="cuda")
            model.load_state_dict(state_dict)
            params = dict(model.named_parameters())
            fa.reset_launch_counts()
            loss, _ = gpt.make_loss(model)(params, batch, 0)
            grads = torch.autograd.grad(loss, list(params.values()))
            torch.cuda.synchronize()
            got[impl] = (loss.item(), dict(zip(params, grads)),
                         dict(fa.launch_counts))
            del model, params
        (lf, gf, launches), (ld, gd, dense_launches) = got["flash"], \
            got["dense"]
        want = {"flash_fwd": base.layers * (2 if remat else 1),
                "flash_fwd_hfold": 0, "flash_dq": base.layers,
                "flash_dkv": base.layers}
        require(launches == want, f"remat={remat}: flash launches per step "
                                  f"{launches} != {want}")
        require(not any(dense_launches.values()),
                f"dense path launched {dense_launches}")
        require(all(torch.isfinite(g).all().item() for g in gf.values()),
                f"remat={remat}: non-finite gradient")
        loss_rel = abs(lf - ld) / abs(ld)
        total = torch.sqrt(sum((g.float() ** 2).sum() for g in gd.values()))
        worst, worst_name = 0.0, ""
        for name, g in gd.items():
            denom = torch.maximum(g.float().norm(), GRAD_NORM_FLOOR * total)
            rel = ((gf[name].float() - g.float()).norm() / denom).item()
            if rel > worst:
                worst, worst_name = rel, name
        rows.append({"remat": remat, "loss_flash": lf, "loss_dense": ld,
                     "loss_rel": loss_rel, "worst_grad_rel": worst,
                     "worst_grad_param": worst_name, "launches": launches})
        require(loss_rel <= TRAIN_LOSS_REL_TOL,
                f"remat={remat}: flash loss {lf} vs dense {ld}")
        require(worst <= TRAIN_GRAD_REL_TOL,
                f"remat={remat}: gradient of {worst_name} differs by "
                f"{worst} > {TRAIN_GRAD_REL_TOL}")
        del got, gf, gd
    emit({"phase": "train_grads", "model": "gpt2-small", "batch":
          TRAIN_BATCH, "seq": TRAIN_SEQ, "loss_rel_tol": TRAIN_LOSS_REL_TOL,
          "grad_rel_tol": TRAIN_GRAD_REL_TOL, "runs": rows})
    fa.reset_launch_counts()


def phase_train(torch, smi):
    """``train_gpt``'s main path in process: GPT-2 small, b8 s1024,
    AdamW, 30 steps, then a relaunch that resumes from the checkpoint,
    ``generate_gpt --logdir`` on it, and 30 steps on one fixed batch.
    Returns the flash launches of the 30-step run, its losses, its median
    step ms, its peak memory and its logdir (which serve_bench serves;
    main removes it)."""
    import gc
    import statistics
    import tempfile

    from dtf_tpu_torch import generate_gpt, optim, train_gpt
    from dtf_tpu_torch.convert import init_params_flax, params_from_flax
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.ops import flash_attention as fa

    logdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    flags = ["--size=small", f"--batch_size={TRAIN_BATCH}",
             f"--seq_len={TRAIN_SEQ}", "--log_every=1",
             "--checkpoint_every=1000", f"--logdir={logdir}"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    state, writer = train_gpt.run(flags + [f"--train_steps={TRAIN_STEPS}"])
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    train_rows = [(s, m) for s, m in writer.history if "loss" in m]
    losses = [m["loss"] for _, m in train_rows]
    require(state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS,
            f"trained {state.step} steps, logged {len(losses)}")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    # 12 per layer per step, plus the final eval's 4 forward batches
    want = {"flash_fwd": 12 * (TRAIN_STEPS + 4), "flash_fwd_hfold": 0,
            "flash_dq": 12 * TRAIN_STEPS, "flash_dkv": 12 * TRAIN_STEPS}
    require(launches == want, f"train launches {launches} != {want}")
    steady = [m for s, m in train_rows if s > 3]
    step_ms = statistics.median(1e3 / m["steps_per_sec"] for m in steady)
    mfu = statistics.median(m["mfu"] for m in steady)
    del state, writer
    gc.collect()

    # the relaunch resumes at the saved step
    from dtf_tpu_torch.checkpoint import Checkpointer

    require(Checkpointer(os.path.join(logdir, "ckpt")).latest_step()
            == TRAIN_STEPS, "no checkpoint at the last step")
    state2, writer2 = train_gpt.run(flags + [
        f"--train_steps={TRAIN_STEPS + 2}"])
    resumed = [s for s, m in writer2.history if "loss" in m]
    require(state2.step == TRAIN_STEPS + 2
            and resumed == [TRAIN_STEPS + 1, TRAIN_STEPS + 2],
            f"relaunch ran steps {resumed} to {state2.step}")
    del state2, writer2
    gc.collect()

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = generate_gpt.main([f"--logdir={logdir}", "--batch=2",
                                "--prompt=464,2068,7586,21831", "--n_new=8"])
    rows = [r for r in buf.getvalue().splitlines() if r.strip()]
    require(rc == 0 and len(rows) == 2 and len(rows[0].split(",")) == 12,
            f"generate_gpt --logdir printed {rows}")

    # one fixed batch, the launcher's optimizer recipe, 30 steps
    args = train_gpt.build_parser().parse_args(
        flags + [f"--train_steps={TRAIN_STEPS}"])
    cfg = gpt.GPTConfig.gpt2_small()
    model = gpt.GPT(cfg, device="cuda")
    model.load_state_dict(params_from_flax(init_params_flax(cfg, 0)))
    tx = optim.make_optimizer(args, lambda s: optim.adamw(
        s, weight_decay=0.1), recipe_uses_wd=True)
    st = tr.create_train_state(model, tx, 0)
    step = tr.make_train_step(gpt.make_loss(model), tx)
    batch = _train_batch(torch, cfg)
    fixed = []
    for _ in range(TRAIN_STEPS):
        st, metrics = step(st, batch)
        fixed.append(metrics["loss"].item())
    require(all(math.isfinite(x) for x in fixed), f"fixed-batch {fixed}")
    require(fixed[-1] <= fixed[0] - FIXED_BATCH_LOSS_DROP,
            f"fixed-batch loss fell from {fixed[0]} to {fixed[-1]}, less "
            f"than {FIXED_BATCH_LOSS_DROP}")
    del model, st
    gc.collect()
    torch.cuda.empty_cache()

    emit({"phase": "train", "model": "gpt2-small", "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "nvidia_smi": smi,
          "losses": losses, "step_ms_median_after_3": step_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
          "mfu_analytic_vs_989tf": mfu, "max_memory_allocated": peak,
          "flash_launches": launches, "resumed_steps": resumed,
          "generated_rows": rows, "fixed_batch_losses": fixed,
          "fixed_batch_drop_min": FIXED_BATCH_LOSS_DROP})
    fa.reset_launch_counts()
    return {"launches": launches, "losses": losses, "step_ms": step_ms,
            "peak": peak, "logdir": logdir}


def ce_bounds_ms(n, d, v):
    """B5, the merge, the split pass, B6, B7: x [n, d] and W [v, d] f32,
    labels int32 and the f32 statistics read once; B5 writes lse and tgt,
    B6 dX, B7 dW. B5 does one n·d·v product, B6 and B7 two each (the
    recompute and their own), each at 3xTF32: three TF32 products per f32
    one. B5, B6 and B7 are bounded as the function they compute, from x
    and W: the split's copies and B5's parts are the design's, not the
    function's. The merge reads the parts' (m, l, tgt) and writes lse and
    tgt, bytes only."""
    from dtf_tpu_torch.ops.fused_ce import FWD_PART_ROWS

    reads = 4 * (n * d + v * d) + 4 * n
    prod = 2 * n * d * v

    def bound(nbytes, flops):
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = 3 * flops / PEAK_TF32_FLOPS
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    # the split pass: x and W read once, four f32 copies of each written
    # (the transposed ones padded to 8 rows), no products
    rp = lambda r: -(-r // 8) * 8
    split_bytes = 4 * (n * d + v * d) + 8 * (n + v) * d + 8 * (rp(n)
                                                               + rp(v)) * d
    nparts = -(-v // FWD_PART_ROWS)
    return {"fused_ce_fwd": bound(reads + 8 * n, prod),
            "fused_ce_merge": bound(12 * nparts * n + 8 * n, 0),
            "fused_ce_split": bound(split_bytes, 0),
            "fused_ce_dx": bound(reads + 8 * n + 4 * n * d, 2 * prod),
            "fused_ce_dw": bound(reads + 8 * n + 4 * v * d, 2 * prod)}


def _ce_inputs(torch, gen, n, d, v, x_dtype=None, w_std=0.05):
    """x ~ N(0, 1) (post-LayerNorm scale), W ~ N(0, w_std²) — logits of
    std ~1.4 at 0.05, ~5.5 at 0.2 — and labels in [0, VOCAB_REAL)."""
    x = torch.randn(n, d, generator=gen, device="cuda")
    w = torch.randn(v, d, generator=gen, device="cuda") * w_std
    labels = torch.randint(0, min(v, VOCAB_REAL), (n,), generator=gen,
                           device="cuda")
    return x.to(x_dtype or torch.float32), w, labels


def _rel(torch, got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def _parts_err(got, want):
    """Largest gap between B5's parts and their plain version, ws [parts,
    3, N]: each part's max m and target logit, and its own logsumexp
    m + log l (l >= 1: every part has a live column)."""
    return max((got[:, 0] - want[:, 0]).abs().max().item(),
               (got[:, 2] - want[:, 2]).abs().max().item(),
               ((got[:, 0] + got[:, 1].log())
                - (want[:, 0] + want[:, 1].log())).abs().max().item())


def phase_kernels_ce(torch):
    """The split pass, B5 and its merge, B6 and B7 against
    fused_ce_*_reference on the card: the training shape with ignored
    labels, the same with larger logits, ragged N and V with out-of-range
    labels, an all-ignored batch, N 5, bf16 x, and the other compiled head
    widths (1024, 384); then two launches of B5, B6 and B7 at the training
    shape, bitwise equal. Returns each kernel's largest max-abs error."""
    from dtf_tpu_torch.ops import fused_ce as fc

    gen = torch.Generator(device="cuda").manual_seed(20)
    cases = [
        ("train_N8192", 8192, D_MODEL, VOCAB, "some_ignored", None, 0.05),
        ("train_N8192_w0.2", 8192, D_MODEL, VOCAB, "some_ignored", None,
         0.2),
        ("ragged_N1000_V50257", 1000, D_MODEL, VOCAB_REAL, "out_of_range",
         None, 0.05),
        ("all_ignored", 300, D_MODEL, VOCAB, "all_ignored", None, 0.05),
        ("N5", 5, D_MODEL, VOCAB, "", None, 0.05),
        ("bf16_x_N1024", 1024, D_MODEL, VOCAB, "some_ignored",
         torch.bfloat16, 0.05),
        ("d1024_N700_V5003", 700, 1024, 5003, "out_of_range", None, 0.05),
        ("d384_N700_V5003", 700, 384, 5003, "out_of_range", None, 0.05),
    ]
    rows, worst = [], {"fused_ce_fwd": 0.0, "fused_ce_merge": 0.0,
                       "fused_ce_split": 0.0, "fused_ce_dx": 0.0,
                       "fused_ce_dw": 0.0}
    fc.reset_launch_counts()
    for name, n, d, v, labelling, x_dtype, w_std in cases:
        x, w, labels = _ce_inputs(torch, gen, n, d, v, x_dtype, w_std)
        if labelling == "some_ignored":
            labels[::7] = -100
        elif labelling == "out_of_range":
            labels[0], labels[1], labels[2] = v, v + 40, 10 ** 6
            labels[3] = -100
        elif labelling == "all_ignored":
            labels[:] = -100
        valid = (labels != -100).float()
        dce = valid / valid.sum().clamp_min(1.0)       # g_mean = 1
        split = fc.fused_ce_split_cuda(x, w)
        # B5 and the merge, each held on its own, then the entry point
        # (B5 again): the same bits
        ws = fc.fused_ce_fwd_parts_cuda(x, w, labels, split)
        lse, tgt = fc.fused_ce_merge_cuda(ws)
        lse2, tgt2 = fc.fused_ce_fwd_cuda(x, w, labels, split)
        dx = fc.fused_ce_dx_cuda(x, w, labels, lse, dce, split)
        dw = fc.fused_ce_dw_cuda(x, w, labels, lse, dce, split)
        torch.cuda.synchronize()
        want_lse, want_tgt = fc.fused_ce_fwd_reference(x, w, labels)
        want_ws = fc.fused_ce_parts_reference(x.float(), w, labels)
        merge_lse, merge_tgt = fc.fused_ce_merge_reference(ws)
        # the split is exact: the same roundings, bit for bit
        split_err = max(
            (got - want).abs().max().item() if got.numel() else 0.0
            for part, src in ((split.x, x), (split.w, w))
            for got, want in zip(part, fc.fused_ce_split_reference(src)))
        want_dx, want_dw = fc.fused_ce_bwd_reference(x, w, labels, lse, dce)
        row = {"case": name, "n": n, "d": d, "v": v, "w_std": w_std,
               "split_max_abs": split_err,
               "lse_max_abs": (lse - want_lse).abs().max().item(),
               "tgt_max_abs": (tgt - want_tgt).abs().max().item(),
               "parts_max_abs": _parts_err(ws, want_ws),
               "merge_max_abs": max(
                   (lse - merge_lse).abs().max().item(),
                   (tgt - merge_tgt).abs().max().item()),
               "fwd_bitwise_repeat": bool(torch.equal(lse, lse2)
                                          and torch.equal(tgt, tgt2)),
               "dx_max_abs": (dx.float() - want_dx.float()).abs().max()
               .item(),
               "dw_max_abs": (dw - want_dw).abs().max().item()}
        finite = all(torch.isfinite(t.float()).all().item()
                     for t in (lse, tgt, dx, dw))
        shapes = (tuple(dx.shape) == (n, d) and dx.dtype == x.dtype
                  and tuple(dw.shape) == (v, d) and dw.dtype == torch.float32
                  and tuple(ws.shape) == tuple(want_ws.shape))
        if labelling == "all_ignored":
            row["dx_nonzero"] = torch.count_nonzero(dx).item()
            row["dw_nonzero"] = torch.count_nonzero(dw).item()
            ok = row["dx_nonzero"] == 0 and row["dw_nonzero"] == 0
        else:
            row["dx_rel"] = _rel(torch, dx, want_dx)
            row["dw_rel"] = _rel(torch, dw, want_dw)
            dx_tol = CE_BF16_DX_REL_TOL if x_dtype else CE_GRAD_REL_TOL
            ok = row["dx_rel"] <= dx_tol and row["dw_rel"] <= CE_GRAD_REL_TOL
        ok = (ok and finite and shapes and row["lse_max_abs"] <= CE_STAT_ATOL
              and row["tgt_max_abs"] <= CE_STAT_ATOL
              and row["parts_max_abs"] <= CE_STAT_ATOL
              and row["merge_max_abs"] <= CE_MERGE_ATOL
              and row["fwd_bitwise_repeat"] and split_err == 0.0)
        row["ok"] = ok
        emit({"phase": "kernels_ce_case", **row})
        require(ok, f"{name}: a fused CE kernel disagrees with its plain "
                    f"version: {row}")
        worst["fused_ce_fwd"] = max(worst["fused_ce_fwd"],
                                    row["lse_max_abs"], row["tgt_max_abs"])
        worst["fused_ce_merge"] = max(worst["fused_ce_merge"],
                                      row["merge_max_abs"])
        worst["fused_ce_split"] = max(worst["fused_ce_split"], split_err)
        worst["fused_ce_dx"] = max(worst["fused_ce_dx"], row["dx_max_abs"])
        worst["fused_ce_dw"] = max(worst["fused_ce_dw"], row["dw_max_abs"])
        rows.append(row)
        del x, w, dx, dw, want_dx, want_dw, split, ws, want_ws
    want = {k: len(cases) for k in fc.launch_counts}
    want["fused_ce_fwd"] = want["fused_ce_merge"] = 2 * len(cases)
    require(fc.launch_counts == want,
            f"kernels_ce launches {fc.launch_counts} != {want}")
    # no atomics and a fixed summation order: two launches, the same bits
    x, w, labels = _ce_inputs(torch, gen, 8192, D_MODEL, VOCAB)
    labels[::7] = -100
    valid = (labels != -100).float()
    dce = valid / valid.sum()
    split = fc.fused_ce_split_cuda(x, w)
    lse, _ = fc.fused_ce_fwd_cuda(x, w, labels, split)
    repeat = {"fused_ce_fwd": torch.equal(
        fc.fused_ce_fwd_parts_cuda(x, w, labels, split),
        fc.fused_ce_fwd_parts_cuda(x, w, labels, split))}
    repeat.update({name: torch.equal(fn(x, w, labels, lse, dce, split),
                                     fn(x, w, labels, lse, dce, split))
                   for name, fn in (("fused_ce_dx", fc.fused_ce_dx_cuda),
                                    ("fused_ce_dw", fc.fused_ce_dw_cuda))})
    del x, w, split
    emit({"phase": "kernels_ce", "stat_atol": CE_STAT_ATOL,
          "merge_atol": CE_MERGE_ATOL, "grad_rel_tol": CE_GRAD_REL_TOL,
          "bf16_dx_rel_tol": CE_BF16_DX_REL_TOL, "max_abs": worst,
          "bitwise_repeat": repeat})
    require(all(repeat.values()), f"B5/B6/B7 launches differ: {repeat}")
    fc.reset_launch_counts()
    return worst


def phase_kernel_times_ce(torch):
    """B5, the merge, the split pass, B6 and B7 at the training shape (N
    8192, D 768, V 50304, f32): kernel, plain version, the monolithic
    composite the fused path replaces (a yardstick only: the cuBLAS f32
    head GEMM + logsumexp/gather forward, and its autograd backward for B6
    + B7) and the bound."""
    from dtf_tpu_torch.ops import fused_ce as fc
    from dtf_tpu_torch.ops.losses import softmax_cross_entropy

    gen = torch.Generator(device="cuda").manual_seed(21)
    n = TRAIN_BATCH * TRAIN_SEQ
    x, w, labels = _ce_inputs(torch, gen, n, D_MODEL, VOCAB)
    labels[::97] = -100
    valid = (labels != -100).float()
    dce = valid / valid.sum()
    lab32 = labels.to(torch.int32)
    split = fc.fused_ce_split_cuda(x, w)
    ws = fc.fused_ce_fwd_parts_cuda(x, w, lab32, split)
    lse, _ = fc.fused_ce_merge_cuda(ws)
    res = {
        "fused_ce_fwd": time_ms(torch, lambda: fc.fused_ce_fwd_parts_cuda(
            x, w, lab32, split), 5),
        "fused_ce_merge": time_ms(torch, lambda: fc.fused_ce_merge_cuda(ws),
                                  20),
        "fused_ce_split": time_ms(torch, lambda: fc.fused_ce_split_cuda(
            x, w), 3),
        "fused_ce_dx": time_ms(torch, lambda: fc.fused_ce_dx_cuda(
            x, w, lab32, lse, dce, split), 3),
        "fused_ce_dw": time_ms(torch, lambda: fc.fused_ce_dw_cuda(
            x, w, lab32, lse, dce, split), 3),
    }
    del split
    plain = {
        "fused_ce_fwd": time_ms(torch, lambda: fc.fused_ce_fwd_reference(
            x, w, labels), 3),
        "fused_ce_merge": time_ms(
            torch, lambda: fc.fused_ce_merge_reference(ws), 5),
        "fused_ce_split": time_ms(
            torch, lambda: (fc.fused_ce_split_reference(x),
                            fc.fused_ce_split_reference(w)), 2)}
    plain_bwd = time_ms(torch, lambda: fc.fused_ce_bwd_reference(
        x, w, labels, lse, dce), 2)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    lib_fwd = time_ms(torch, lambda: softmax_cross_entropy(
        x @ w.t(), labels, ignore_index=-100), 3)
    lib_fwd_bwd = time_ms(torch, lambda: torch.autograd.grad(
        softmax_cross_entropy(xg @ wg.t(), labels, ignore_index=-100)[0],
        (xg, wg)), 2)
    fc.reset_launch_counts()
    bounds = ce_bounds_ms(n, D_MODEL, VOCAB)
    library = {"fused_ce_fwd": lib_fwd, "fused_ce_merge": None,
               "fused_ce_split": None}
    timing = {name: dict(
        ms=res[name], plain_ms=plain.get(name, plain_bwd),
        bound_ms=bounds[name][0], bound_by=bounds[name][1],
        library_ms=library.get(name, lib_fwd_bwd - lib_fwd))
        for name in res}
    # waves: B5 has ceil(N / 128) x parts CTAs of one an SM, B6
    # ceil(N / 128) clusters, B7 ceil(V / 128), against what the card
    # holds at once
    waves = {name: {"clusters": -(-rows // 128),
                    "max_active_clusters": fc.max_active_clusters(which,
                                                                  D_MODEL)}
             for name, which, rows in (("fused_ce_dx", 1, n),
                                       ("fused_ce_dw", 2, VOCAB))}
    waves["fused_ce_fwd"] = {
        "ctas": -(-n // 128) * ws.shape[0], "parts": ws.shape[0],
        "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    del ws
    emit({"phase": "kernel_times_ce", "n": n, "d": D_MODEL, "v": VOCAB,
          "waves": waves,
          **{name: {"kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
                    "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"]} for name, t in timing.items()},
          "plain": "fused_ce_fwd_reference (the forward: B5 and the merge); "
                   "fused_ce_merge_reference; fused_ce_split_reference of "
                   "x and of w; fused_ce_bwd_reference computes B6 and B7 "
                   "together",
          "library": "monolithic composite: softmax_cross_entropy(x @ w.T) "
                     "forward (cuBLAS f32 GEMM + logsumexp/gather); its "
                     "autograd backward = (forward + backward) - forward, "
                     "for B6 and B7 together"})
    return timing


def phase_train_grads_ce(torch):
    """GPT-2 small at full width, the trainer's init, one 8 x 1024 batch,
    flash attention: the loss and every gradient of the fused loss (and of
    each chunked loss) against the monolithic loss of the same model; the
    kernels' launches per step."""
    from dtf_tpu_torch.convert import init_params_flax, params_from_flax
    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import fused_ce as fc

    cfg = gpt.GPTConfig.gpt2_small()
    model = gpt.GPT(cfg, device="cuda")
    model.load_state_dict(params_from_flax(init_params_flax(cfg, 0)))
    params = dict(model.named_parameters())
    batch = _train_batch(torch, cfg)
    flash_want = {"flash_fwd": cfg.layers, "flash_fwd_hfold": 0,
                  "flash_dq": cfg.layers, "flash_dkv": cfg.layers}

    def run(**opts):
        fa.reset_launch_counts()
        fc.reset_launch_counts()
        loss, _ = gpt.make_loss(model, **opts)(params, batch, 0)
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        return (loss.item(), dict(zip(params, grads)),
                dict(fa.launch_counts), dict(fc.launch_counts))

    l0, g0, flash0, fused0 = run()
    require(flash0 == flash_want and not any(fused0.values()),
            f"monolithic launches {flash0} {fused0}")
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in g0.values()))
    rows = []
    for name, opts, fused_want in (
            ("loss_pallas", {"loss_pallas": True},
             {"fused_ce_fwd": 1, "fused_ce_merge": 1, "fused_ce_split": 1,
              "fused_ce_dx": 1, "fused_ce_dw": 1}),
            ("loss_chunk_tokens_4096", {"loss_chunk_tokens": 4096}, None),
            ("loss_chunk_8192", {"loss_chunk": 8192}, None)):
        loss, grads, flash, fused = run(**opts)
        fused_want = fused_want or {k: 0 for k in fused}
        require(flash == flash_want and fused == fused_want,
                f"{name}: launches per step {flash} {fused} != "
                f"{flash_want} {fused_want}")
        require(all(torch.isfinite(g).all().item() for g in grads.values()),
                f"{name}: non-finite gradient")
        head = _rel(torch, grads["lm_head.weight"], g0["lm_head.weight"])
        worst, worst_name = 0.0, ""
        for pname, g in g0.items():
            if pname == "lm_head.weight":
                continue
            denom = torch.maximum(g.float().norm(), GRAD_NORM_FLOOR * total)
            rel = ((grads[pname].float() - g.float()).norm() / denom).item()
            if rel > worst:
                worst, worst_name = rel, pname
        row = {"loss": name, "loss_value": loss, "loss_monolithic": l0,
               "loss_rel": abs(loss - l0) / abs(l0), "head_grad_rel": head,
               "worst_trunk_grad_rel": worst,
               "worst_trunk_grad_param": worst_name,
               "flash_launches": flash, "fused_launches": fused}
        rows.append(row)
        del grads
    emit({"phase": "train_grads_ce", "model": "gpt2-small",
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "loss_rel_tol": CE_LOSS_REL_TOL,
          "head_grad_rel_tol": CE_HEAD_GRAD_REL_TOL,
          "trunk_grad_rel_tol": CE_TRUNK_GRAD_REL_TOL, "runs": rows})
    for row in rows:
        require(row["loss_rel"] <= CE_LOSS_REL_TOL and
                row["head_grad_rel"] <= CE_HEAD_GRAD_REL_TOL and
                row["worst_trunk_grad_rel"] <= CE_TRUNK_GRAD_REL_TOL,
                f"{row['loss']} disagrees with the monolithic loss: {row}")
    del model, params, g0
    fa.reset_launch_counts()
    fc.reset_launch_counts()


def phase_train_ce(torch, smi, mono):
    """``train_gpt --loss_pallas`` in process: GPT-2 small, b8 s1024,
    AdamW, 30 steps. Exactly one split/B5/merge/B6/B7 launch per step
    (plus the split, B5 and the merge once per final-eval batch); the
    first steps' losses against the monolithic
    ``train`` run's (``mono``, None when that phase did not run). Returns
    the fused kernels' launches."""
    import gc
    import statistics
    import tempfile

    from dtf_tpu_torch import train_gpt
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import fused_ce as fc

    logdir = tempfile.mkdtemp(prefix="chip_smoke_train_ce_")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    fc.reset_launch_counts()
    state, writer = train_gpt.run([
        "--size=small", f"--batch_size={TRAIN_BATCH}",
        f"--seq_len={TRAIN_SEQ}", "--log_every=1", "--checkpoint_every=1000",
        f"--logdir={logdir}", f"--train_steps={TRAIN_STEPS}",
        "--loss_pallas"])
    torch.cuda.synchronize()
    launches, flash = dict(fc.launch_counts), dict(fa.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    rows = [(s, m) for s, m in writer.history if "loss" in m]
    losses = [m["loss"] for _, m in rows]
    require(state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS,
            f"trained {state.step} steps, logged {len(losses)}")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    # one per step, plus the final eval's 4 forward batches for the
    # forward's split pass, B5 and the merge
    want = {"fused_ce_fwd": TRAIN_STEPS + 4,
            "fused_ce_merge": TRAIN_STEPS + 4,
            "fused_ce_split": TRAIN_STEPS + 4,
            "fused_ce_dx": TRAIN_STEPS, "fused_ce_dw": TRAIN_STEPS}
    require(launches == want, f"train_ce launches {launches} != {want}")
    flash_want = {"flash_fwd": 12 * (TRAIN_STEPS + 4), "flash_fwd_hfold": 0,
                  "flash_dq": 12 * TRAIN_STEPS, "flash_dkv": 12 * TRAIN_STEPS}
    require(flash == flash_want, f"train_ce flash launches {flash}")
    rel = None
    if mono is not None:
        k = CE_TRAIN_COMPARED_STEPS
        rel = [abs(a - b) / abs(b) for a, b in zip(losses[:k],
                                                   mono["losses"][:k])]
        require(max(rel) <= CE_TRAIN_LOSS_REL_TOL,
                f"train_ce losses {losses[:k]} vs monolithic "
                f"{mono['losses'][:k]}")
    steady = [m for s, m in rows if s > 3]
    step_ms = statistics.median(1e3 / m["steps_per_sec"] for m in steady)
    mfu = statistics.median(m["mfu"] for m in steady)
    del state, writer
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(logdir, ignore_errors=True)
    emit({"phase": "train_ce", "model": "gpt2-small", "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "loss": "--loss_pallas",
          "nvidia_smi": smi, "losses": losses,
          "loss_rel_vs_monolithic": rel,
          "loss_rel_tol": CE_TRAIN_LOSS_REL_TOL,
          "step_ms_median_after_3": step_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
          "mfu_analytic_vs_989tf": mfu, "max_memory_allocated": peak,
          "monolithic_step_ms_median_after_3":
              mono["step_ms"] if mono else None,
          "monolithic_max_memory_allocated": mono["peak"] if mono else None,
          "fused_launches": launches, "flash_launches": flash})
    fc.reset_launch_counts()
    fa.reset_launch_counts()
    return launches


def _wd_flat_ids(torch, batch, step, device="cuda"):
    """Wide&Deep's table rows for synthetic batch ``step``: the bucket ids
    plus each feature's offset, int32 [batch, 26]."""
    from dtf_tpu_torch.data.synthetic import SyntheticData

    b = SyntheticData("widedeep", batch, seed=0,
                      hash_buckets=WD_BUCKETS).batch(step)
    offsets = torch.arange(WD_SPARSE, dtype=torch.int32) * WD_BUCKETS
    return (torch.from_numpy(b["sparse"]) + offsets).to(device)


def phase_kernels_embed(torch):
    """B8 against gather_rows_reference on the card. A gather copies, so
    every row must be equal exactly; an id outside [0, R) gives a NaN row
    in both. Then the backward with duplicate ids against index_add_ in
    f64. Returns the largest max-abs error (0)."""
    from dtf_tpu_torch.ops import embed_gather as eg

    gen = torch.Generator(device="cuda").manual_seed(30)

    def table(rows, d, dtype=torch.float32):
        return torch.randn(rows, d, generator=gen, device="cuda").to(dtype)

    def ids(rows, shape):
        return torch.randint(0, rows, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    deep, wide = table(WD_ROWS, WD_EMBED), table(WD_ROWS, 1)
    flat = _wd_flat_ids(torch, WD_BATCH, 0)
    i32 = dict(dtype=torch.int32, device="cuda")
    cases = [
        ("deep_f32_batch0", deep, flat.reshape(-1)),
        ("deep_bf16_batch0", deep.to(torch.bfloat16), flat.reshape(-1)),
        ("wide_f32_batch0", wide, flat.reshape(-1)),
        ("rank2_ids", deep, flat),
        ("one_id_4096_copies", deep, torch.full((4096,), 123457, **i32)),
        ("ids_0_and_last", deep, torch.tensor([0, WD_ROWS - 1, 0, 7,
                                               WD_ROWS - 1], **i32)),
        ("d3_bf16", table(5000, 3, torch.bfloat16), ids(5000, (999,))),
        ("d17_bf16", table(5000, 17, torch.bfloat16), ids(5000, (999,))),
        ("d768_f32", table(20000, 768), ids(20000, (2048,))),
        ("strided_rows_f32", table(3000, 24)[:, 4:20], ids(3000, (777,))),
        ("empty_ids", deep, flat.reshape(-1)[:0]),
        ("out_of_range", table(1000, 16), torch.tensor(
            [-1, 0, 1000, 2 ** 31 - 1, 5, -2 ** 31, 999], **i32)),
    ]
    eg.reset_launch_counts()
    rows, worst = [], 0.0
    for name, t, i in cases:
        got = eg.gather_rows_cuda(t, i)
        torch.cuda.synchronize()
        want = eg.gather_rows_reference(t, i)
        require(got.shape == want.shape and got.dtype == t.dtype,
                f"{name}: out {tuple(got.shape)} {got.dtype}")
        nan = torch.isnan(want)
        require(torch.equal(torch.isnan(got), nan),
                f"{name}: NaN rows differ from the plain version's")
        err = ((got[~nan].float() - want[~nan].float()).abs().max().item()
               if (~nan).any() else 0.0)
        rows.append({"case": name, "table": list(t.shape),
                     "dtype": str(t.dtype).replace("torch.", ""),
                     "ids": list(i.shape),
                     "nan_rows": int(nan.any(dim=-1).sum().item())
                     if got.numel() else 0,
                     "max_abs_err": err})
        require(err == 0.0, f"{name}: kernel differs from the plain version "
                            f"by {err}")
        if name == "out_of_range":
            require(rows[-1]["nan_rows"] == 4, f"{name}: {rows[-1]}")
        worst = max(worst, err)
    launched = eg.launch_counts["embed_gather"]
    require(launched == len(cases) - 1,
            f"kernels_embed launches {launched} != {len(cases) - 1} (none "
            "for the empty ids)")

    # the masked form: one launch for one or two tables of a row shard,
    # rows outside the shard exactly 0, f32 rows rounded to bf16 as they
    # are stored (a copy and a round to nearest even: exact)
    f32, bf16 = torch.float32, torch.bfloat16
    half = WD_ROWS // 2
    wide_s, deep_s = wide[half:], deep[half:]          # shard 1 of 2
    strided = table(3000, 24)
    outside = torch.tensor([-1, 0, 1499, 1500, 2999, 3000, 2 ** 31 - 1,
                            -2 ** 31, 2000], **i32)
    masked = [
        # (name, tables, ids, shard, out dtypes)
        ("path_shard1of2", (wide_s, deep_s), flat, 1, (f32, bf16)),
        ("path_shard0of2", (wide[:half], deep[:half]), flat, 0,
         (f32, bf16)),
        ("one_table_f32", (deep_s,), flat.reshape(-1), 1, (f32,)),
        ("one_table_cast", (deep_s,), flat.reshape(-1), 1, (bf16,)),
        ("bf16_table", (deep_s.to(bf16),), flat.reshape(-1), 1, (bf16,)),
        ("d3_bf16_d17_cast", (table(2500, 3, bf16), table(2500, 17)),
         ids(5000, (999,)), 1, (bf16, bf16)),
        ("d768_cast_wide_f32", (table(10000, 768), table(10000, 1)),
         ids(20000, (2048,)), 1, (bf16, f32)),
        ("strided_rows", (strided[1500:, 4:20], strided[1500:, :3]),
         ids(3000, (777,)), 1, (bf16, f32)),
        ("ids_outside_the_table", (strided[1500:, 4:20],), outside, 1,
         (f32,)),
        ("empty_ids", (wide_s, deep_s), flat.reshape(-1)[:0], 1,
         (f32, bf16)),
    ]
    eg.reset_launch_counts()
    for name, tabs, i, shard, dtypes in masked:
        got = eg.masked_gather_rows_cuda(tabs, i, shard, dtypes)
        torch.cuda.synchronize()
        want = eg.masked_gather_rows_reference(tabs, i, shard, dtypes)
        n_local = tabs[0].shape[0]
        in_shard = ((i >= shard * n_local) & (i < (shard + 1) * n_local))
        err = 0.0
        for g, w in zip(got, want):
            require(g.shape == w.shape and g.dtype == w.dtype,
                    f"{name}: out {tuple(g.shape)} {g.dtype}")
            if g.numel():
                err = max(err, (g.float() - w.float()).abs().max().item())
            require(torch.equal(g, w), f"{name}: the kernel differs from "
                                       f"the plain version by {err}")
            require(not g[~in_shard].any(), f"{name}: a row outside the "
                                            "shard is not 0")
        rows.append({"case": name, "tables": [list(t.shape) for t in tabs],
                     "dtypes": [str(t.dtype).replace("torch.", "")
                                for t in tabs],
                     "out_dtypes": [str(d).replace("torch.", "")
                                    for d in dtypes],
                     "shard": shard, "ids": list(i.shape),
                     "ids_in_shard": int(in_shard.sum().item()),
                     "max_abs_err": err})
        worst = max(worst, err)
    launched = eg.launch_counts["embed_gather"]
    require(launched == len(masked) - 1,
            f"kernels_embed masked launches {launched} != "
            f"{len(masked) - 1} (one a case, none for the empty ids)")

    # _Gather's backward: duplicate ids (batch 0 and 4,096 copies of one)
    t = deep.clone().requires_grad_()
    dup = torch.cat([flat.reshape(-1), torch.full((4096,), 123457, **i32)])
    ct = torch.randn(dup.shape[0], WD_EMBED, generator=gen, device="cuda")
    (g,) = torch.autograd.grad((eg.gather_rows(t, dup) * ct).sum(), t)
    want = torch.zeros(WD_ROWS, WD_EMBED, dtype=torch.float64,
                       device="cuda").index_add_(0, dup.long(), ct.double())
    grad_rel = _rel(torch, g, want)
    require(grad_rel <= EMBED_GRAD_REL_TOL,
            f"gather backward differs from index_add_ in f64 by {grad_rel}")
    emit({"phase": "kernels_embed", "cases": rows, "max_abs_err": worst,
          "grad_rel_vs_f64": grad_rel, "grad_rel_tol": EMBED_GRAD_REL_TOL})
    eg.reset_launch_counts()
    return worst


def embed_bound_ms(n_ids, d, elt):
    """B8: the ids read once, each gathered row read once and written
    once; no arithmetic."""
    return bound_ms(4 * n_ids + 2 * n_ids * d * elt, 0)


def phase_kernel_times_embed(torch):
    """B8 at Wide&Deep's tables: the deep table with the launcher's batch
    (512 x 26 ids) and bench_lm's (8,192 x 26), f32 and bf16, and the wide
    table at the launcher's batch. Kernel, plain version, library
    yardstick (F.embedding) and bound. Each call of a graph
    (:func:`graph_ms`) gathers the ids of its own synthetic batch, and the
    calls together touch more than the 50 MB L2, so a call's rows are
    evicted by the time it comes round again: rows arrive cold, as on the
    path."""
    from dtf_tpu_torch.ops import embed_gather as eg

    gen = torch.Generator(device="cuda").manual_seed(32)
    deep = torch.randn(WD_ROWS, WD_EMBED, generator=gen, device="cuda")
    tables = {"deep_f32": deep, "deep_bf16": deep.to(torch.bfloat16),
              "wide_f32": torch.randn(WD_ROWS, 1, generator=gen,
                                      device="cuda")}
    # id sets per batch size: their rows, read and written, exceed the L2
    id_sets = {WD_BATCH: [_wd_flat_ids(torch, WD_BATCH, s).reshape(-1)
                          for s in range(128)],
               WD_BENCH_BATCH: [_wd_flat_ids(torch, WD_BENCH_BATCH,
                                             s).reshape(-1)
                                for s in range(8)]}
    emb = torch.nn.functional.embedding
    res = {}
    for name, batch in (("deep_f32", WD_BATCH), ("deep_bf16", WD_BATCH),
                        ("wide_f32", WD_BATCH),
                        ("deep_f32", WD_BENCH_BATCH),
                        ("deep_bf16", WD_BENCH_BATCH)):
        t, sets = tables[name], id_sets[batch]
        n = sets[0].numel()
        bound, bound_by = embed_bound_ms(n, t.shape[1], t.element_size())
        res[f"{name}_b{batch}"] = dict(
            ids=n, ms=graph_ms(torch, [
                (lambda i=i: eg.gather_rows_cuda(t, i)) for i in sets]),
            plain_ms=graph_ms(torch, [
                (lambda i=i: eg.gather_rows_reference(t, i)) for i in sets]),
            library_ms=graph_ms(torch, [
                (lambda i=i: emb(i, t)) for i in sets]),
            bound_ms=bound, bound_by=bound_by)
    res["path"] = _embed_path_times(torch, gen)
    eg.reset_launch_counts()
    emit({"phase": "kernel_times_embed", "table_rows": WD_ROWS, **res,
          "library": "torch.nn.functional.embedding (a yardstick only)"})
    return res


def embed_path_bound_ms(ids, shard, tables, out_dtypes):
    """The masked lookup of a shard: the ids read once, each table's
    in-shard rows (counted on these ids) read once in its stored type,
    every row written once in its out type; no arithmetic."""
    n_local = tables[0].shape[0]
    inside = int(((ids >= shard * n_local)
                  & (ids < (shard + 1) * n_local)).sum().item())
    n = ids.numel()
    nbytes = 4 * n + sum(t.shape[1] * (inside * t.element_size()
                                       + n * d.itemsize)
                         for t, d in zip(tables, out_dtypes))
    return bound_ms(nbytes, 0) + (inside,)


def device_ops(torch, fn):
    """Kernels, copies and fills that one ``fn()`` puts on the card, from
    ``torch.profiler`` (after one call unprofiled)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation)


def _embed_path_times(torch, gen):
    """The lookup of one rank of ``train_widedeep --mesh_model 2`` (shard
    1 of 2: 1.3M rows of each table, f32 parameters; the deep rows at
    bf16), 512 x 26 ids, no collective: today's composite (the deep
    shard cast, then per table the shift, the range test, the clip,
    the plain-contract B8 and the where) against the one fused launch.
    Forward: each call
    computes its own synthetic batch's ids (bucket ids + the features'
    offsets, as the model's ``flat_ids``) and looks them up, 128 batches
    a graph, rows cold; the ids' computation alone is timed to take it
    out. Backward: forward + backward of 16 batches a graph (each call's
    f32 zero tables evict the L2) less the forward. Device ops from the
    profiler. The tables' gradients of the two paths are compared under
    ``torch.use_deterministic_algorithms`` (index_add_'s sums in a fixed
    order): bit for bit."""
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.ops import embed_gather as eg
    from dtf_tpu_torch.parallel import embedding as pe

    f32, bf16 = torch.float32, torch.bfloat16
    dtypes = (f32, bf16)
    half = WD_ROWS // 2
    weights = (torch.randn(half, 1, generator=gen, device="cuda"),
               torch.randn(half, WD_EMBED, generator=gen, device="cuda"))
    data = SyntheticData("widedeep", WD_BATCH, seed=0,
                         hash_buckets=WD_BUCKETS)
    sparse = [torch.from_numpy(data.batch(s)["sparse"]).to(torch.int32)
              .cuda() for s in range(128)]
    offsets = torch.arange(WD_SPARSE, dtype=torch.int32,
                           device="cuda") * WD_BUCKETS

    def composite(sp, ws=weights):
        flat = sp + offsets
        return [pe.masked_lookup(w.to(d), flat, 1, gather_fn=eg.gather_rows)
                for w, d in zip(ws, dtypes)]

    def fused(sp, ws=weights):
        return eg.masked_gather_rows_cuda(ws, sp + offsets, 1, dtypes)

    def plain(sp, ws=weights):
        return eg.masked_gather_rows_reference(ws, sp + offsets, 1, dtypes)

    def graph(fn, sets=sparse):
        return graph_ms(torch, [(lambda sp=sp: fn(sp)) for sp in sets])

    ids_ms = graph(lambda sp: sp + offsets)
    fwd = {
        "composite": graph(composite),
        "fused": graph(fused),
        "plain": graph(plain),
    }
    bound, bound_by, inside = embed_path_bound_ms(sparse[0] + offsets, 1,
                                                  weights, dtypes)
    ops = {"composite": device_ops(torch, lambda: composite(sparse[0])),
           "fused": device_ops(torch, lambda: fused(sparse[0])),
           "ids": device_ops(torch, lambda: sparse[0] + offsets)}

    # backward: the path's autograd (masked_lookup_grouped's at rank 1,
    # without its all-reduces) against today's (the cast's and
    # masked_lookup's)
    params = tuple(w.clone().requires_grad_() for w in weights)
    cts = (torch.randn(WD_BATCH, WD_SPARSE, 1, generator=gen,
                       device="cuda"),
           torch.randn(WD_BATCH, WD_SPARSE, WD_EMBED, generator=gen,
                       device="cuda").to(bf16))

    def step(kind, sp):
        if kind == "composite":
            outs = composite(sp, params)
        else:
            outs = eg.masked_gather_rows(params, sp + offsets, 1, dtypes)
        return torch.autograd.grad(outs, params, cts)

    bwd = {}
    for kind in ("composite", "fused"):
        fb = graph(lambda sp, kind=kind: step(kind, sp), sparse[:16])
        bwd[kind] = {"fwd_bwd_ms": fb, "ms": fb - fwd[kind],
                     "ops": device_ops(torch, lambda: step(kind, sparse[0]))
                     - ops[kind]}
    torch.use_deterministic_algorithms(True)
    try:
        grads = {k: step(k, sparse[0]) for k in ("composite", "fused")}
        outs = {"composite": [o.detach() for o in composite(sparse[0])],
                "fused": list(fused(sparse[0]))}
    finally:
        torch.use_deterministic_algorithms(False)
    grads_equal = all(torch.equal(a, b) and a.dtype == b.dtype
                      for a, b in zip(grads["composite"], grads["fused"]))
    outs_equal = all(torch.equal(a, b) and a.dtype == b.dtype
                     for a, b in zip(outs["composite"], outs["fused"]))
    require(grads_equal and outs_equal, "the fused path's outputs "
            f"({outs_equal}) or gradients ({grads_equal}) differ from "
            "today's composite")
    return {
        "shard": "1 of 2", "table_rows": half, "ids": sparse[0].numel(),
        "ids_in_shard": inside, "tables": ["wide [1.3M, 1] f32 -> f32",
                                           "deep [1.3M, 16] f32 -> bf16"],
        "ids_ms": ids_ms,
        "fwd_with_ids_ms": fwd,
        "fwd_ms": {k: v - ids_ms for k, v in fwd.items()},
        "fwd_device_ops": {"composite": ops["composite"] - ops["ids"],
                           "fused": ops["fused"] - ops["ids"]},
        "bwd": bwd, "bound_ms": bound, "bound_by": bound_by,
        "outputs_equal": outs_equal, "grads_equal_deterministic":
            grads_equal,
        # the kernels line's B8: the path's lookup as the path launches it
        # (no one PyTorch call computes the masked lookup of two tables)
        "line": {"ms": fwd["fused"] - ids_ms,
                 "plain_ms": fwd["plain"] - ids_ms,
                 "bound_ms": bound, "bound_by": bound_by,
                 "library_ms": None}}


def phase_widedeep_lookup(torch):
    """Wide&Deep at full width, the trainer's init, 4 synthetic batches of
    512: the model's two lookups again through masked_lookup_grouped (the
    lookup its forward takes when the tables are row-sharded; here one
    shard holds the whole tables) on its own f32 tables and flat ids —
    the deep rows at bf16, the wide ones at f32 — equal to the model's
    embeddings exactly, with ONE B8 launch per batch and none in the
    backward; the tables' gradients from a seeded cotangent equal
    today's per-table composite (the deep table cast, masked_lookup with
    the plain-contract gather) bit for bit, index_add_'s sums in a fixed
    order (``torch.use_deterministic_algorithms``), and the
    index_select path's within 1e-6 (the deep table's at f32 rows)."""
    from dtf_tpu_torch.convert import init_params_widedeep, params_from_flax
    from dtf_tpu_torch.models import widedeep
    from dtf_tpu_torch.ops import embed_gather as eg
    from dtf_tpu_torch.parallel import embedding as pe

    model = widedeep.WideDeep(hash_buckets=WD_BUCKETS, embed_dim=WD_EMBED,
                              device="cuda")
    model.load_state_dict(params_from_flax(init_params_widedeep(model, 0)))
    wide_w = model.embed_tables_wide.weight
    deep_w = model.embed_tables_deep.weight
    weights, dtypes = (wide_w, deep_w), (torch.float32, model.dtype)
    gen = torch.Generator(device="cuda").manual_seed(33)
    launches, rows = 0, []
    for step in range(4):
        flat = _wd_flat_ids(torch, WD_BATCH, step)
        with torch.no_grad():
            want_deep = model.embed_tables_deep(flat)
        want_wide = model.embed_tables_wide(flat)
        ct_w = torch.randn(want_wide.shape, generator=gen, device="cuda")
        ct_d = torch.randn(flat.shape + (WD_EMBED,), generator=gen,
                           device="cuda")
        # the main path: the model's two lookups in one B8 launch, counted
        eg.reset_launch_counts()
        wide, deep = pe.masked_lookup_grouped(weights, flat, None, dtypes)
        fwd = eg.launch_counts["embed_gather"]
        (g_wide, g_deep) = torch.autograd.grad(
            (wide * ct_w).sum() + (deep.float() * ct_d).sum(), weights)
        torch.cuda.synchronize()
        bwd = eg.launch_counts["embed_gather"] - fwd
        launches += fwd + bwd
        require(fwd == 1 and bwd == 0,
                f"batch {step}: B8 launches {fwd} forward, {bwd} backward")
        require(deep.dtype == torch.bfloat16 and torch.equal(deep, want_deep),
                f"batch {step}: deep lookup differs from the model's")
        require(torch.equal(wide, want_wide),
                f"batch {step}: wide lookup differs from the model's")
        # the comparisons, not counted
        torch.use_deterministic_algorithms(True)
        try:
            fixed = torch.autograd.grad(
                sum((o.float() * c).sum() for o, c in zip(
                    pe.masked_lookup_grouped(weights, flat, None, dtypes),
                    (ct_w, ct_d))), weights)
            today = torch.autograd.grad(
                sum((pe.masked_lookup(w.to(d), flat, 0,
                                      gather_fn=eg.gather_rows).float()
                     * c).sum()
                    for w, d, c in zip(weights, dtypes, (ct_w, ct_d))),
                weights)
        finally:
            torch.use_deterministic_algorithms(False)
        (want_g_wide,) = torch.autograd.grad((want_wide * ct_w).sum(),
                                             wide_w)
        (g_deep32,) = torch.autograd.grad((pe.masked_lookup_sharded(
            deep_w, flat, use_kernel=True) * ct_d).sum(), deep_w)
        (want_g_deep,) = torch.autograd.grad((pe.masked_lookup_sharded(
            deep_w, flat) * ct_d).sum(), deep_w)
        row = {"batch": step, "launches_fwd": fwd, "launches_bwd": bwd,
               "grads_equal_today_deterministic": all(
                   torch.equal(a, b) for a, b in zip(fixed, today)),
               "wide_grad_rel": _rel(torch, g_wide, want_g_wide),
               "deep_f32_grad_rel": _rel(torch, g_deep32, want_g_deep),
               "unique_ids": int(torch.unique(flat).numel()),
               "ids": flat.numel()}
        rows.append(row)
        require(row["grads_equal_today_deterministic"],
                f"batch {step}: table gradients differ from today's "
                "composite")
        require(row["wide_grad_rel"] <= EMBED_GRAD_REL_TOL and
                row["deep_f32_grad_rel"] <= EMBED_GRAD_REL_TOL,
                f"batch {step}: table gradients differ: {row}")
    emit({"phase": "widedeep_lookup", "hash_buckets": WD_BUCKETS,
          "embed_dim": WD_EMBED, "batch": WD_BATCH,
          "n_params": sum(p.numel() for p in model.parameters()),
          "grad_rel_tol": EMBED_GRAD_REL_TOL, "embed_gather_launches":
          launches, "batches": rows})
    del model
    eg.reset_launch_counts()


def phase_train_widedeep(torch, smi):
    """``train_widedeep`` in process at its defaults (batch 512, Adam
    1e-3, 300 steps, the final held-out eval), then a relaunch into the
    same logdir that resumes to step 310. Returns the B8 launches of the
    300-step run (0: the launcher looks up with take, as the JAX one
    does)."""
    import gc
    import statistics
    import tempfile

    from dtf_tpu_torch import train_widedeep
    from dtf_tpu_torch.ops import embed_gather as eg

    logdir = tempfile.mkdtemp(prefix="chip_smoke_widedeep_")
    flags = ["--log_every=1", f"--logdir={logdir}"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eg.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):   # 300 metric lines
        state, writer = train_widedeep.run(flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = eg.launch_counts["embed_gather"]
    peak = torch.cuda.max_memory_allocated()
    rows = [(s, m) for s, m in writer.history if "loss" in m]
    losses = [m["loss"] for _, m in rows]
    evals = [m for _, m in writer.history if "eval_accuracy" in m]
    require(state.step == WD_STEPS and len(losses) == WD_STEPS,
            f"trained {state.step} steps, logged {len(losses)}")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    require(last < first, f"mean loss of the last 20 steps {last} is not "
                          f"below the first 20's {first}")
    require(len(evals) == 1
            and evals[0]["eval_accuracy"] > WD_EVAL_ACCURACY_MIN,
            f"held-out eval {evals}")
    require(launches == 0, f"train_widedeep launched B8 {launches} times")
    steady = [m for s, m in rows if s > 10]
    step_ms = statistics.median(1e3 / m["steps_per_sec"] for m in steady)
    examples = statistics.median(m["examples_per_sec"] for m in steady)
    del state, writer
    gc.collect()

    with contextlib.redirect_stdout(io.StringIO()):
        state2, writer2 = train_widedeep.run(
            flags + [f"--train_steps={WD_RESUME_STEPS}"])
    resumed = [s for s, m in writer2.history if "loss" in m]
    require(state2.step == WD_RESUME_STEPS and
            resumed == list(range(WD_STEPS + 1, WD_RESUME_STEPS + 1)),
            f"relaunch ran steps {resumed} to {state2.step}")
    del state2, writer2
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(logdir, ignore_errors=True)
    emit({"phase": "train_widedeep", "hash_buckets": WD_BUCKETS,
          "embed_dim": WD_EMBED, "batch": WD_BATCH, "steps": WD_STEPS,
          "nvidia_smi": smi, "loss_first20_mean": first,
          "loss_last20_mean": last, "losses_every_25": losses[::25],
          "eval": evals[0], "step_ms_median_after_10": step_ms,
          "examples_per_s_median": examples, "run_wall_s": wall,
          "max_memory_allocated": peak, "embed_gather_launches": launches,
          "resumed_steps": resumed})
    return launches


#: the ResNet slice (BASELINE configs 2-3): train_resnet --config=imagenet
#: (ResNet-50 v1.5, 224x224x3, 1000 classes) at the launcher's batch 256,
#: 10 steps and a relaunch that resumes to 12; --config=cifar (ResNet-20)
#: at 256, 20 steps
RN_BATCH, RN_STEPS, RN_RESUME_STEPS, RN_CIFAR_STEPS = 256, 10, 12, 20
#: stated before the first run: 30 steps of bench.py's recipe (SGD 0.1,
#: momentum 0.9) on ONE fixed batch of 128 ImageNet-shaped images with
#: random labels (first loss ~ln 1000 = 6.9) bring the last loss at least
#: this far below the first
RN_FIXED_STEPS, RN_FIXED_BATCH, RN_FIXED_LOSS_DROP = 30, 128, 1.0
#: BatchNorm on the card (PyTorch's fused kernels) against the port's
#: plain f32 ops on the same bf16 inputs, at ResNet-50's layers at b256:
#: y and dx are bf16 on both sides, rounded from f32 values that differ
#: by the statistics' f32 rounding, so an element may land one bf16 step
#: (2^-7 of its magnitude) away — stated against each tensor's largest
#: |value|; the f32 statistics and the dscale / dbias sums (over up to
#: 3.2M elements, Welford's and tree sums' orders): 1e-4 of the largest
BN_BF16_TOL, BN_F32_TOL = 2.0 ** -7, 1e-4
#: [N, C, H, W] of ResNet-50's stem, first stage and last stage BatchNorms
BN_SHAPES = ((256, 64, 112, 112), (256, 256, 56, 56), (256, 2048, 7, 7))
#: profile_resnet's batches (bench.py's 128 and the launcher's 256) and
#: its timed steps
RN_BENCH_BATCHES, RN_BENCH_STEPS = (128, 256), 10
#: ResNet-20 at batch 256 in a group of one (against no group) and over 2
#: ranks (against one rank on the same global batch), 5 steps: the losses
#: within DIST_LOSS_REL_TOL, and every BatchNorm running statistic within
#: this share of its buffer's largest |value|: the statistics are of bf16
#: activations (2^-8 relative each), whose sums over 128 rows a rank and
#: 256 in one process, and the convolutions' at 128 and 256 images, round
#: in other orders
DIST_RN_STEPS, DIST_RN_STAT_TOL = 5, 1e-2

#: the multi-process slice: GPT-2 small with the fused loss, b8 s1024 in
#: all (4 rows a rank at 2 ranks), 5 steps; Wide&Deep at the launcher's
#: defaults with its tables over 2 ranks, 20 steps
DIST_GPT_STEPS, DIST_WD_STEPS = 5, 20
#: the batches of the launchers' final held-out eval
EVAL_BATCHES = 4
#: a run under a process group against the same run without one (a world
#: of 1), or against one rank on the same global batch (2 ranks): the same
#: math, but the gradient is Σw·g/Σw over ranks (not bitwise g), and the
#: reductions and cuBLAS's products at another batch sum in other orders;
#: AdamW carries that through bf16 layers, as in train_ce against train
DIST_LOSS_REL_TOL = 1e-3
#: Wide&Deep's tables over 2 ranks (B8's backward scatter-adds duplicate
#: ids in f32) against index_select (take's backward: a bf16 scatter-add):
#: Queue C's bf16 tolerance, 2^-6, relative, on every loss
DIST_WD_LOSS_REL_TOL = 2.0 ** -6
#: the bound on the wait for the two ranks of dist_two_ranks_one_card
DIST_CHILD_TIMEOUT_S = 480


def _rn_flags(logdir, *extra, config="imagenet", steps=RN_STEPS):
    return [f"--config={config}", f"--batch_size={RN_BATCH}",
            f"--train_steps={steps}", "--log_every=1",
            f"--checkpoint_every={RN_STEPS}", f"--logdir={logdir}", *extra]


def _no_hand_kernels(torch, fn):
    """``fn()`` counted: the ResNet path launches none of the port's hand
    kernels (its convolutions are cuDNN's, as the JAX package's are XLA's
    with no Pallas kernel). Returns (result, wall seconds)."""
    out, fused, flash, embed, wall = _counted(torch, fn)
    launches = {**fused, **flash, "embed_gather": embed}
    require(not any(launches.values()), f"hand kernels launched: {launches}")
    return out, wall


def _on_card(state):
    bad = [n for n, t in {**state.params, **state.extra}.items()
           if not t.is_cuda]
    require(not bad, f"tensors off the card: {bad[:5]}")


def phase_resnet_batchnorm(torch, smi):
    """Train-mode BatchNorm's fused CUDA path (``_fused_forward`` /
    ``_fused_backward``, what the model runs on the card) against its
    plain f32 ops (``_plain_forward`` / ``_plain_backward``, what the CPU
    tests hold against flax) on the same bf16 channels-last inputs at
    ResNet-50's shapes: y, the batch mean and variance, dx, dscale and
    dbias; and the device ms of each, forward plus backward."""
    from dtf_tpu_torch.models import resnet

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for shape in BN_SHAPES:
        def rand(*size, scale=1.0, shift=0.0):
            return torch.randn(size, device="cuda", generator=gen) \
                * scale + shift

        x = rand(*shape, scale=2.0, shift=0.5).to(torch.bfloat16) \
            .contiguous(memory_format=torch.channels_last)
        gy = rand(*shape).to(torch.bfloat16) \
            .contiguous(memory_format=torch.channels_last)
        c = shape[1]
        scale, bias = rand(c, scale=0.3, shift=1.0), rand(c, scale=0.2)
        out, ms = {}, {}
        for name, fwd, bwd in (
                ("plain", resnet._plain_forward, resnet._plain_backward),
                ("fused", resnet._fused_forward, resnet._fused_backward)):
            def run():
                y, mean, var, saved = fwd(x, scale, bias, resnet.EPSILON,
                                          None)
                return (y, mean, var) + tuple(bwd(gy, saved, None))
            out[name] = run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):      # ms a call: launches are not the cost
                run()
            stop.record()
            torch.cuda.synchronize()
            ms[name] = start.elapsed_time(stop) / 5
        errs = {}
        for i, what in enumerate(("y", "mean", "var", "dx", "dscale",
                                  "dbias")):
            a, b = out["fused"][i].float(), out["plain"][i].float()
            errs[what] = float((a - b).abs().max() / b.abs().max())
            tol = BN_BF16_TOL if what in ("y", "dx") else BN_F32_TOL
            require(errs[what] <= tol, f"BatchNorm {shape} {what}: fused "
                    f"vs plain {errs[what]} > {tol}")
            require(out["fused"][i].dtype == out["plain"][i].dtype,
                    f"BatchNorm {shape} {what} dtypes")
        cases.append({"shape": list(shape), "rel_err": errs,
                      "fused_ms": ms["fused"], "plain_ms": ms["plain"]})
        del x, gy, out
    torch.cuda.empty_cache()
    emit({"phase": "resnet_batchnorm", "nvidia_smi": smi,
          "tol_bf16": BN_BF16_TOL, "tol_f32": BN_F32_TOL, "cases": cases})


def phase_train_resnet(torch, smi):
    """``train_resnet`` in process: ``--config=imagenet`` (ResNet-50 at
    full width, batch 256) for RN_STEPS steps — finite losses, every
    BatchNorm statistic moved from its init, everything on the card —,
    a relaunch that resumes to RN_RESUME_STEPS, then ``--config=cifar``
    (ResNet-20, batch 256); RN_FIXED_STEPS steps of bench.py's recipe on
    one fixed batch must lower the loss by RN_FIXED_LOSS_DROP. No hand
    kernel launches on this path."""
    import gc
    import tempfile

    from dtf_tpu_torch import optim, train_resnet
    from dtf_tpu_torch.convert import (init_params_resnet, params_from_flax,
                                       stats_from_flax)
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.models import resnet

    logdir = tempfile.mkdtemp(prefix="chip_smoke_resnet_")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (state, writer), wall = _no_hand_kernels(torch, lambda: train_resnet.run(
        _rn_flags(f"{logdir}/in")))
    peak = torch.cuda.max_memory_allocated()
    losses, step_ms = _history(writer)
    evals = [m for _, m in writer.history if "eval_accuracy" in m]
    require(state.step == RN_STEPS and len(losses) == RN_STEPS
            and all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(len(evals) == 1 and math.isfinite(evals[0]["eval_loss"]),
            f"held-out eval {evals}")
    _on_card(state)
    require(len(state.extra) == 106, f"{len(state.extra)} buffers")
    still = [n for n, t in state.extra.items() if torch.equal(
        t, torch.full_like(t, 0.0 if n.endswith(".mean") else 1.0))]
    require(not still, f"BatchNorm statistics at their init: {still[:5]}")
    n_params = sum(p.numel() for p in state.params.values())
    require(n_params == 25_557_032, f"{n_params} parameters")
    del state, writer
    gc.collect()
    (state, writer), _ = _no_hand_kernels(torch, lambda: train_resnet.run(
        _rn_flags(f"{logdir}/in", steps=RN_RESUME_STEPS)))
    resumed = [s for s, m in writer.history if "loss" in m]
    require(state.step == RN_RESUME_STEPS and resumed == list(
        range(RN_STEPS + 1, RN_RESUME_STEPS + 1)),
        f"relaunch ran steps {resumed} to {state.step}")
    del state, writer
    gc.collect()
    torch.cuda.empty_cache()

    (state, writer), cifar_wall = _no_hand_kernels(
        torch, lambda: train_resnet.run(_rn_flags(
            f"{logdir}/cifar", config="cifar", steps=RN_CIFAR_STEPS)))
    cifar_losses, cifar_ms = _history(writer)
    require(len(cifar_losses) == RN_CIFAR_STEPS
            and all(math.isfinite(x) for x in cifar_losses),
            f"ResNet-20 losses {cifar_losses}")
    _on_card(state)
    del state, writer
    gc.collect()
    torch.cuda.empty_cache()

    # one fixed batch, bench.py's recipe
    model = resnet.resnet50(device="cuda")
    variables = init_params_resnet(model, 0)
    model.load_state_dict({**params_from_flax(variables["params"]),
                           **stats_from_flax(variables["batch_stats"])})
    tx = optim.sgd(0.1, momentum=0.9)
    state = tr.create_train_state(model, tx, 0)
    step = tr.make_train_step(resnet.make_loss(model), tx, model=model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"image": torch.rand((RN_FIXED_BATCH, 224, 224, 3),
                                 device="cuda", generator=gen),
             "label": torch.randint(0, 1000, (RN_FIXED_BATCH,),
                                    device="cuda", generator=gen,
                                    dtype=torch.int32)}
    fixed = []
    for _ in range(RN_FIXED_STEPS):
        state, m = step(state, batch)
        fixed.append(m["loss"].item())
    require(all(math.isfinite(x) for x in fixed), f"fixed-batch {fixed}")
    require(fixed[-1] <= fixed[0] - RN_FIXED_LOSS_DROP,
            f"fixed-batch loss fell from {fixed[0]} to {fixed[-1]}, less "
            f"than {RN_FIXED_LOSS_DROP}")
    del model, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(logdir, ignore_errors=True)
    emit({"phase": "train_resnet", "nvidia_smi": smi,
          "imagenet": {"model": "resnet50", "batch": RN_BATCH,
                       "steps": RN_STEPS, "params": n_params,
                       "losses": losses, "eval": evals[0],
                       "step_ms_median_after_1": step_ms,
                       "examples_per_s": RN_BATCH * 1e3 / step_ms,
                       "run_wall_s": wall, "max_memory_allocated": peak,
                       "resumed_steps": resumed},
          "cifar": {"model": "resnet20", "batch": RN_BATCH,
                    "steps": RN_CIFAR_STEPS, "losses": cifar_losses,
                    "step_ms_median_after_1": cifar_ms,
                    "run_wall_s": cifar_wall},
          "fixed_batch": {"batch": RN_FIXED_BATCH, "losses": fixed,
                          "drop_min": RN_FIXED_LOSS_DROP},
          "hand_kernel_launches": 0})


def phase_resnet_bench(torch, smi):
    """``profile_resnet``'s measurement (bench.py's recipe: ResNet-50, one
    fixed batch on the card, SGD 0.1 momentum 0.9, 3 warm-up and 10 timed
    steps) at batch 128 and 256: step ms, images/s, analytic MFU, peak
    memory, device busy and idle share, launches and device ms by
    family."""
    import gc

    from dtf_tpu_torch.profile_resnet import measure

    for batch in RN_BENCH_BATCHES:
        with contextlib.redirect_stdout(io.StringIO()):   # the top kernels
            out = measure(batch, RN_BENCH_STEPS, None)
        require(math.isfinite(out["loss_last"]) and out["images_per_s"] > 0,
                f"resnet_bench b{batch}: {out}")
        emit({"phase": "resnet_bench", "nvidia_smi": smi, **out})
        gc.collect()
        torch.cuda.empty_cache()


#: the BERT slice (BASELINE config 4): BERT-base at the launcher's seq 128
#: and global batch 64, --grad_accum 4 (16 rows a microbatch), 10 steps
#: and a relaunch that resumes to 12; 12 encoder layers (one B1, B2 and
#: B3 each a layer and microbatch)
BERT_SEQ, BERT_BATCH, BERT_ACCUM, BERT_LAYERS = 128, 64, 4, 12
BERT_STEPS, BERT_RESUME_STEPS = 10, 12
#: BERT-base's parameters (flax's count, ``tests/test_torch_bert.py``)
BERT_BASE_PARAMS = 109_514_298
#: steps of each other loss path / optimizer through the entry point
BERT_VARIANT_STEPS = 3
#: stated before the first run: 30 AdamW steps (lr 5e-4 constant, weight
#: decay 0.01, dropout 0.1, --grad_accum 4) on ONE fixed synthetic batch
#: of 64 × 128 (first loss ~ ln 30522 + 0.5 ≈ 10.8) bring the last loss
#: at least this far below the first
BERT_FIXED_STEPS, BERT_FIXED_LR, BERT_FIXED_LOSS_DROP = 30, 5e-4, 1.0
#: --mlm_gather 128 keeps every masked position of a 128-token row: the
#: same trunk (same inputs, masks and kernels), the head's f32 products
#: at another shape and the CE mean in another order
BERT_GATHER_REL_TOL = 1e-4
#: B1-B3 at BERT's shapes: (batch, T), 12 heads of 64, non-causal, a
#: key-padding mask; the path's shape is (64, 128) and (16, 512) the
#: longest sequence BERT-base takes at a microbatch of 16
BERT_KERNEL_SHAPES = ((16, 128), (64, 128), (16, 512), (64, 512))
#: profile_bert's configurations: (grad_accum, loss_chunk_vocab,
#: mlm_gather), full logits at 1 and 4, the gather and the vocab-chunked
#: loss at 1; timed steps and profiled steps each
BERT_BENCH = ((1, 0, 0), (4, 0, 0), (1, 0, 20), (1, 8192, 0))
BERT_BENCH_STEPS, BERT_BENCH_PROFILED = 10, 5
#: dist_nccl and dist_two_ranks_one_card: BERT-base at a global batch of
#: 8 (4 rows a rank at 2 ranks), --grad_accum 2, ZeRO-1, dropout 0.1, 4
#: steps
DIST_BERT_BATCH, DIST_BERT_ACCUM, DIST_BERT_STEPS = 8, 2, 4


def _bert_flags(logdir, *extra, steps=BERT_STEPS, batch=BERT_BATCH,
                accum=BERT_ACCUM):
    return [f"--batch_size={batch}", f"--seq_len={BERT_SEQ}",
            f"--grad_accum={accum}", f"--train_steps={steps}",
            "--log_every=1", f"--checkpoint_every={BERT_STEPS}",
            f"--logdir={logdir}", *extra]


def _bert_want(steps, accum=BERT_ACCUM, eval_batches=EVAL_BATCHES):
    """B1, B2, B3: one each a layer and microbatch, plus the final eval's
    forwards (one a layer and batch)."""
    fwd = BERT_LAYERS * (steps * accum + eval_batches)
    return {"flash_fwd": fwd, "flash_fwd_hfold": 0,
            "flash_dq": BERT_LAYERS * steps * accum,
            "flash_dkv": BERT_LAYERS * steps * accum}


def _bert_mask(torch, b, t, gen):
    """A key-padding mask [b, t]: row 0 no padding, row 1 some, row 2 all
    but one key padded, row 3 every key padded, the rest random
    lengths."""
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    lengths[:4] = torch.tensor([t, t // 2 + 3, 1, 0], device="cuda")
    return torch.arange(t, device="cuda")[None, :] < lengths[:, None]


def _sdpa_backend(torch, q, k, v, mask):
    """The name of the backend PyTorch's dispatch picks for
    ``scaled_dot_product_attention`` with this boolean mask."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, mask, 0.0, False)).name
    except (AttributeError, RuntimeError, TypeError, ValueError):
        return "unknown"


def phase_bert_kernels(torch, smi):
    """B1, B2 and B3 at BERT's shapes (bf16, 12 heads of 64, non-causal,
    a key-padding mask: rows with no padding, some, all but one key, every
    key) against their plain versions at the kernels / kernels_bwd
    tolerances; a fully padded row's output and gradients exactly 0. Then
    at the path's shape [64, 12, 128, 64] and at [16, 12, 512, 64], with
    the path's mask (no padding: the synthetic stream pads nothing): each
    kernel's time, plain version, bound, and SDPA with the same boolean
    mask (the backend it took named). Returns the rows."""
    from dtf_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(12)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    cases = []
    for b, t in BERT_KERNEL_SHAPES:
        q, k, v = (randn(b, HEADS, t, D_HEAD) for _ in range(3))
        do = randn(b, t, HEADS, D_HEAD).transpose(1, 2)   # autograd's layout
        mask = _bert_mask(torch, b, t, gen)
        bias = fa._mask_bias(mask, b, t)
        opts = dict(sm_scale=D_HEAD ** -0.5, causal=False, window=0)
        out, lse = fa.flash_attention_cuda(q, k, v, bias, **opts)
        got = fa.flash_attention_bwd_cuda(q, k, v, bias, out, lse, do, **opts)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, bias, **opts)
        want = fa.flash_attention_bwd_reference(q, k, v, bias, out, lse, do,
                                                **opts)
        name = f"b{b}_T{t}"
        d_out = (out.float() - ref_out.float()).abs().max().item()
        dead = torch.isneginf(ref_lse)
        require(torch.equal(torch.isneginf(lse), dead),
                f"{name}: -inf lse rows differ")
        d_lse = (lse - ref_lse).abs()[~dead].max().item()
        require(d_out <= OUT_ATOL and d_lse <= LSE_ATOL,
                f"{name}: B1 disagrees (out {d_out}, lse {d_lse})")
        require(torch.count_nonzero(out.view(b, HEADS, t, D_HEAD)[3])
                .item() == 0, f"{name}: the fully padded row is not 0")
        row = {"case": name, "out_max_abs": d_out, "lse_max_abs": d_lse}
        for gname, x, y in zip(("dq", "dk", "dv"), got, want):
            diff = x.float() - y.float()
            rel = (diff.norm() / y.float().norm().clamp_min(1e-30)).item()
            mab = diff.abs().max().item()
            scale = y.float().abs().max().item()
            row[f"{gname}_rel"], row[f"{gname}_max_abs"] = rel, mab
            require(torch.isfinite(x).all().item()
                    and rel <= GRAD_REL_TOL
                    and mab <= GRAD_MAX_ABS_TOL * scale,
                    f"{name}: {gname} disagrees (rel {rel}, max-abs {mab} "
                    f"of {scale})")
            require(torch.count_nonzero(x[3]).item() == 0,
                    f"{name}: {gname} of the fully padded row is not 0")
        cases.append(row)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = []
    for b, t in BERT_KERNEL_SHAPES[1:3]:
        q, k, v = (randn(b, HEADS, t, D_HEAD) for _ in range(3))
        do = randn(b, t, HEADS, D_HEAD).transpose(1, 2)
        mask = torch.ones(b, t, dtype=torch.bool, device="cuda")
        bias = fa._mask_bias(mask, b, t)
        opts = dict(sm_scale=D_HEAD ** -0.5, causal=False)
        out, lse = fa.flash_attention_cuda(q, k, v, bias, **opts)
        delta = (do.float() * out.reshape(b, HEADS, t, D_HEAD).float()
                 ).sum(dim=-1)
        fwd_bound = attention_bound_ms(b, HEADS, t, t, D_HEAD, False, 0)
        dq_bound, dkv_bound = attention_bwd_bounds_ms(b, HEADS, t, t, D_HEAD,
                                                      False, 0)
        sdpa_mask = mask[:, None, None, :]
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
        lib_fwd = time_ms(torch, lambda: sdpa(q, k, v, attn_mask=sdpa_mask),
                          20)
        lib_fwd_bwd = time_ms(torch, lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, attn_mask=sdpa_mask), (qg, kg, vg), do), 20)
        plain_bwd = time_ms(torch, lambda: fa.flash_attention_bwd_reference(
            q, k, v, bias, out, lse, do, **opts), 3)
        times.append({
            "shape": [b, HEADS, t, D_HEAD], "causal": False,
            "kv_mask": "all keys valid (the path's data)",
            "sdpa_backend": _sdpa_backend(torch, q, k, v, sdpa_mask),
            "flash_fwd": {
                "ms": time_ms(torch, lambda: fa.flash_attention_cuda(
                    q, k, v, bias, **opts), 20),
                "plain_ms": time_ms(
                    torch, lambda: fa.flash_attention_reference(
                        q, k, v, bias, **opts), 3),
                "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                "library_ms": lib_fwd},
            "flash_dq": {
                "ms": time_ms(torch, lambda: fa.flash_bwd_dq_cuda(
                    q, k, v, do, lse, delta, bias, **opts), 20),
                "plain_ms": plain_bwd, "bound_ms": dq_bound[0],
                "bound_by": dq_bound[1],
                "library_ms": lib_fwd_bwd - lib_fwd},
            "flash_dkv": {
                "ms": time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(
                    q, k, v, do, lse, delta, bias, **opts), 20),
                "plain_ms": plain_bwd, "bound_ms": dkv_bound[0],
                "bound_by": dkv_bound[1],
                "library_ms": lib_fwd_bwd - lib_fwd}})
    fa.reset_launch_counts()
    emit({"phase": "bert_kernels", "nvidia_smi": smi, "out_atol": OUT_ATOL,
          "lse_atol": LSE_ATOL, "grad_rel_tol": GRAD_REL_TOL,
          "grad_max_abs_tol_of_max": GRAD_MAX_ABS_TOL, "cases": cases,
          "times": times,
          "library": "scaled_dot_product_attention(attn_mask=the boolean "
                     "key mask); B2 and B3's library_ms is SDPA's backward "
                     "((forward + backward) - forward) for both"})
    return times


def _bert_fixed_batch(torch):
    """BERT_FIXED_STEPS AdamW steps (BERT_FIXED_LR constant, weight decay
    0.01, --grad_accum 4) of BERT-base on one fixed synthetic batch: the
    losses. Then the full path's loss against --mlm_gather 128 on the
    same weights, batch and seed."""
    from dtf_tpu_torch import optim
    from dtf_tpu_torch.convert import init_params_bert, params_from_flax
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    model = bert.BertMLM(cfg, device="cuda")
    model.load_state_dict(params_from_flax(init_params_bert(model, 0)))
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticData(
        "bert", BERT_BATCH, seed=0, seq_len=BERT_SEQ,
        vocab_size=cfg.vocab_size).batch(0).items()}
    params = dict(model.named_parameters())
    mb = {k: v[:BERT_BATCH // BERT_ACCUM] for k, v in batch.items()}
    with torch.no_grad():
        full, _ = bert.make_loss(model)(params, mb, 5)
        gathered, aux = bert.make_loss(model, mlm_gather=BERT_SEQ)(
            params, mb, 5)
    full, gathered = full.item(), gathered.item()
    tx = optim.adamw(BERT_FIXED_LR, weight_decay=0.01)
    state = tr.create_train_state(model, tx, 0)
    step = tr.make_train_step(bert.make_loss(model), tx,
                              grad_accum=BERT_ACCUM)
    fixed = []
    for _ in range(BERT_FIXED_STEPS):
        state, m = step(state, batch)
        fixed.append(m["loss"].item())
    del model, state, batch, params, mb
    return fixed, full, gathered, float(aux.weight)


def phase_train_bert(torch, smi):
    """``train_bert`` in process: BERT-base at full width, seq 128, batch
    64, --grad_accum 4, BERT_STEPS steps — finite losses, every tensor on
    the card, B1, B2 and B3 each 12 × 4 a step (and B1 12 an eval batch)
    — and a relaunch that resumes to BERT_RESUME_STEPS; --mlm_gather 20,
    --loss_chunk_vocab 8192, --optimizer lamb and --optimizer adafactor a
    few steps each at full width, finite; BERT_FIXED_STEPS steps on one
    fixed batch lower the loss by BERT_FIXED_LOSS_DROP; --mlm_gather 128
    gives the full path's loss within BERT_GATHER_REL_TOL. Returns the
    main run's launches."""
    import gc
    import tempfile

    from dtf_tpu_torch import train_bert

    logdir = tempfile.mkdtemp(prefix="chip_smoke_bert_")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (state, writer), fused, flash, embed, wall = _counted(
        torch, lambda: train_bert.run(_bert_flags(f"{logdir}/main")))
    peak = torch.cuda.max_memory_allocated()
    losses, step_ms = _history(writer)
    evals = [m for _, m in writer.history if "eval_mlm_loss" in m]
    require(state.step == BERT_STEPS and len(losses) == BERT_STEPS
            and all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(len(evals) == 1 and math.isfinite(evals[0]["eval_mlm_loss"]),
            f"held-out eval {evals}")
    _on_card(state)
    want = _bert_want(BERT_STEPS)
    require(flash == want, f"flash launches {flash}, want {want}")
    require(not any(fused.values()) and embed == 0,
            f"other hand kernels launched: {fused}, B8 {embed}")
    n_params = sum(p.numel() for p in state.params.values())
    require(n_params == BERT_BASE_PARAMS, f"{n_params} parameters")
    del state, writer
    gc.collect()
    (state, writer), _, flash_resume, _, _ = _counted(
        torch, lambda: train_bert.run(_bert_flags(
            f"{logdir}/main", steps=BERT_RESUME_STEPS)))
    resumed = [s for s, m in writer.history if "loss" in m]
    require(state.step == BERT_RESUME_STEPS and resumed == list(
        range(BERT_STEPS + 1, BERT_RESUME_STEPS + 1)),
        f"relaunch ran steps {resumed} to {state.step}")
    require(flash_resume == _bert_want(BERT_RESUME_STEPS - BERT_STEPS),
            f"resumed launches {flash_resume}")
    del state, writer
    gc.collect()
    torch.cuda.empty_cache()

    variants = {}
    for name, extra in (("mlm_gather_20", ["--mlm_gather=20"]),
                        ("loss_chunk_vocab_8192", ["--loss_chunk_vocab=8192"]),
                        ("lamb", ["--optimizer=lamb"]),
                        ("adafactor", ["--optimizer=adafactor"])):
        (state, writer), _, flash_v, _, wall_v = _counted(
            torch, lambda: train_bert.run(_bert_flags(
                f"{logdir}/{name}", *extra, steps=BERT_VARIANT_STEPS)))
        v_losses, v_ms = _history(writer)
        require(len(v_losses) == BERT_VARIANT_STEPS
                and all(math.isfinite(x) for x in v_losses)
                and flash_v == _bert_want(BERT_VARIANT_STEPS),
                f"{name}: losses {v_losses}, launches {flash_v}")
        _on_card(state)
        variants[name] = {"losses": v_losses, "step_ms_median_after_1": v_ms,
                          "run_wall_s": wall_v}
        del state, writer
        gc.collect()
        torch.cuda.empty_cache()

    fixed, full, gathered, positions = _bert_fixed_batch(torch)
    gc.collect()
    torch.cuda.empty_cache()
    require(all(math.isfinite(x) for x in fixed), f"fixed-batch {fixed}")
    require(fixed[-1] <= fixed[0] - BERT_FIXED_LOSS_DROP,
            f"fixed-batch loss fell from {fixed[0]} to {fixed[-1]}, less "
            f"than {BERT_FIXED_LOSS_DROP}")
    gather_rel = abs(gathered - full) / abs(full)
    require(gather_rel <= BERT_GATHER_REL_TOL,
            f"--mlm_gather {BERT_SEQ} loss {gathered} vs full {full}")
    shutil.rmtree(logdir, ignore_errors=True)
    emit({"phase": "train_bert", "nvidia_smi": smi, "model": "bert-base",
          "params": n_params, "batch": BERT_BATCH, "seq": BERT_SEQ,
          "grad_accum": BERT_ACCUM, "steps": BERT_STEPS, "losses": losses,
          "eval": evals[0], "step_ms_median_after_1": step_ms,
          "tokens_per_s": BERT_BATCH * BERT_SEQ * 1e3 / step_ms,
          "run_wall_s": wall, "max_memory_allocated": peak,
          "flash_launches": flash, "resumed_steps": resumed,
          "variants": variants,
          "fixed_batch": {"steps": BERT_FIXED_STEPS, "lr": BERT_FIXED_LR,
                          "losses": fixed, "drop_min": BERT_FIXED_LOSS_DROP},
          "mlm_gather_full_row": {"budget": BERT_SEQ, "loss_full": full,
                                  "loss_gathered": gathered,
                                  "masked_positions": positions,
                                  "rel": gather_rel,
                                  "rel_tol": BERT_GATHER_REL_TOL}})
    return flash


def phase_bert_bench(torch, smi):
    """``profile_bert``'s measurement (BERT-base, seq 128, batch 64, one
    fixed batch on the card, AdamW, 3 warm-up, 10 timed and 5 profiled
    steps) at each BERT_BENCH configuration: step ms, tokens/s, analytic
    MFU, peak memory, flash launches a step, the head's ms and share,
    device busy and idle share, launches and device ms by family."""
    import gc

    from dtf_tpu_torch.profile_bert import measure

    for accum, chunk, gather in BERT_BENCH:
        with contextlib.redirect_stdout(io.StringIO()):   # the top kernels
            out = measure(grad_accum=accum, steps=BERT_BENCH_STEPS,
                          loss_chunk=chunk, mlm_gather=gather,
                          profile_steps=BERT_BENCH_PROFILED)
        want = {k: v / BERT_STEPS for k, v in _bert_want(
            BERT_STEPS, accum=accum, eval_batches=0).items()}
        require(math.isfinite(out["loss_last"]) and out["tokens_per_s"] > 0
                and out["flash_launches_per_step"] == want,
                f"bert_bench {accum}/{chunk}/{gather}: {out}")
        emit({"phase": "bert_bench", "nvidia_smi": smi, **out})
        gc.collect()
        torch.cuda.empty_cache()


def _bert_global_batch_losses(torch):
    """One rank on the 2 ranks' global batch: train_bert's recipe through
    the library (--grad_accum 2, dropout on), each step's batch the rows
    of synthetic host 0 then host 1 of 2 (what the ranks read)."""
    import gc

    import numpy as np

    from dtf_tpu_torch import optim, train_bert
    from dtf_tpu_torch.convert import init_params_bert, params_from_flax
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.models import bert

    args = train_bert.build_parser().parse_args(_bert_dist_flags("unused"))
    cfg = bert.BertConfig.base()
    model = bert.BertMLM(cfg, device="cuda")
    model.load_state_dict(params_from_flax(init_params_bert(model,
                                                            args.seed)))
    tx = optim.make_optimizer(args, lambda s: optim.adamw(
        s, weight_decay=0.01), recipe_uses_wd=True)
    state = tr.create_train_state(model, tx, args.seed)
    step = tr.make_train_step(bert.make_loss(model), tx,
                              grad_accum=DIST_BERT_ACCUM)
    hosts = [SyntheticData("bert", DIST_BERT_BATCH, seed=args.seed,
                           seq_len=BERT_SEQ, vocab_size=cfg.vocab_size,
                           host_index=k, host_count=2) for k in range(2)]
    losses = []
    for i in range(DIST_BERT_STEPS):
        parts = [h.batch(i) for h in hosts]
        batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
                 .cuda() for k in parts[0]}
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def _bert_dist_flags(logdir, *extra):
    return _bert_flags(logdir, *extra, steps=DIST_BERT_STEPS,
                       batch=DIST_BERT_BATCH, accum=DIST_BERT_ACCUM)


def _rn_dist_flags(logdir, *extra):
    return _rn_flags(logdir, *extra, config="cifar", steps=DIST_RN_STEPS)


def _rn_stats_rel(torch, got, want):
    """max over buffers of max|got - want| / max|want|."""
    return max(float((torch.as_tensor(got[k]) - torch.as_tensor(v)).abs()
                     .max() / torch.as_tensor(v).abs().max().clamp_min(1e-30))
               for k, v in want.items())


def _rn_global_batch_run(torch):
    """ResNet-20 on one rank over the 2 ranks' global batch: train_resnet's
    recipe through the library, each step's batch the rows of synthetic
    host 0 then host 1 of 2 (what the ranks read)."""
    import gc

    import numpy as np

    from dtf_tpu_torch import optim, train_resnet
    from dtf_tpu_torch.cli import flags as dflags
    from dtf_tpu_torch.convert import (init_params_resnet, params_from_flax,
                                       stats_from_flax)
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.models import resnet

    args = train_resnet.build_parser().parse_args(_rn_dist_flags("unused"))
    model, kind = train_resnet.build_model("cifar", "cuda")
    variables = init_params_resnet(model, args.seed)
    model.load_state_dict({**params_from_flax(variables["params"]),
                           **stats_from_flax(variables["batch_stats"])})
    l2 = dflags.resolve_loss_l2(args, recipe_l2=train_resnet.RECIPE_L2)
    tx = optim.make_optimizer(args, lambda s: optim.sgd(
        s, momentum=0.9, nesterov=True), recipe_uses_wd=True)
    state = tr.create_train_state(model, tx, args.seed)
    step = tr.make_train_step(resnet.make_loss(model, weight_decay=l2), tx,
                              model=model)
    hosts = [SyntheticData(kind, RN_BATCH, seed=args.seed, host_index=k,
                           host_count=2) for k in range(2)]
    losses = []
    for i in range(DIST_RN_STEPS):
        parts = [h.batch(i) for h in hosts]
        batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
                 .cuda() for k in parts[0]}
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    stats = {n: t.tolist() for n, t in state.extra.items()}
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return losses, stats


def _counted(torch, fn):
    """``fn()`` with every launch count set to 0 just before it and read
    just after, its stdout dropped: (result, fused CE counts, flash counts,
    B8 launches, wall seconds)."""
    from dtf_tpu_torch.ops import embed_gather as eg
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import fused_ce as fc

    for mod in (fa, fc, eg):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = fn()
    torch.cuda.synchronize()
    return (out, dict(fc.launch_counts), dict(fa.launch_counts),
            eg.launch_counts["embed_gather"], time.perf_counter() - t0)


def _history(writer):
    """The run's losses and its median step ms after step 1 (from the
    LoggingHook's steps_per_sec at --log_every=1)."""
    import statistics

    rows = [(s, m) for s, m in writer.history if "loss" in m]
    return ([m["loss"] for _, m in rows],
            statistics.median(1e3 / m["steps_per_sec"]
                              for s, m in rows if s > 1))


def _gpt_dist_flags(logdir, *extra):
    return ["--size=small", f"--batch_size={TRAIN_BATCH}",
            f"--seq_len={TRAIN_SEQ}", "--log_every=1",
            "--checkpoint_every=1000", f"--logdir={logdir}",
            f"--train_steps={DIST_GPT_STEPS}", "--loss_pallas", *extra]


def _gpt_dist_want(steps=DIST_GPT_STEPS):
    """One fused CE and 12 flash launches of each kind a step, plus the
    final eval's forwards."""
    fwd = steps + EVAL_BATCHES
    return ({"fused_ce_fwd": fwd, "fused_ce_merge": fwd,
             "fused_ce_split": fwd, "fused_ce_dx": steps,
             "fused_ce_dw": steps},
            {"flash_fwd": 12 * fwd, "flash_fwd_hfold": 0,
             "flash_dq": 12 * steps, "flash_dkv": 12 * steps})


def _rel_losses(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def phase_dist_nccl(torch, smi):
    """A process group of ONE over NCCL, made here, with the entry points
    run inside it: ``python -m dtf_tpu_torch.distributed`` (MNIST softmax,
    200 steps; loss and held-out accuracy) and ``train_gpt --loss_pallas
    --mesh_data 1`` with ZeRO-1 on (every collective of the step runs),
    against the same ``train_gpt`` run with no group: losses within
    DIST_LOSS_REL_TOL, exact launch counts, step ms of both."""
    import gc
    import tempfile

    import torch.distributed as dist

    from dtf_tpu_torch import distributed as mnist_launcher
    from dtf_tpu_torch import train_bert, train_gpt, train_resnet
    from dtf_tpu_torch.core.dist import free_port

    logdir = tempfile.mkdtemp(prefix="chip_smoke_dist_nccl_")
    (state, writer), rn_ref_wall = _no_hand_kernels(
        torch, lambda: train_resnet.run(_rn_dist_flags(f"{logdir}/rn_ref")))
    rn_ref_losses, rn_ref_ms = _history(writer)
    rn_ref_stats = {n: t.tolist() for n, t in state.extra.items()}
    del state, writer
    gc.collect()
    (state, writer), _, bert_flash_ref, _, bert_ref_wall = _counted(
        torch, lambda: train_bert.run(_bert_dist_flags(f"{logdir}/bert_ref")))
    bert_ref_losses, bert_ref_ms = _history(writer)
    del state, writer
    gc.collect()
    want_fused, want_flash = _gpt_dist_want()
    (state, writer), fused, flash, _, wall_ref = _counted(
        torch, lambda: train_gpt.run(_gpt_dist_flags(f"{logdir}/ref")))
    require(state.layout is None, "the run with no group has a layout")
    ref_losses, ref_ms = _history(writer)
    require(fused == want_fused and flash == want_flash,
            f"no-group launches {fused} {flash}")
    del state, writer
    gc.collect()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        require(dist.get_backend() == "nccl", dist.get_backend())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mnist_launcher.main(["--train_steps=200", "--log_every=50",
                                      f"--logdir={logdir}/mnist"])
        lines = buf.getvalue().strip().splitlines()
        mnist_loss = [float(ln.split("loss=")[1].split(",")[0])
                      for ln in lines if ln.startswith("[200]")
                      and " loss=" in ln]
        require(rc == 0 and lines[-1].startswith(
            "done: step=200 eval_accuracy=") and len(mnist_loss) == 1
            and math.isfinite(mnist_loss[0]), f"distributed printed {lines}")
        mnist_acc = float(lines[-1].split("eval_accuracy=")[1])
        require(dist.is_initialized(), "the launcher left the caller's "
                                       "group destroyed")
        (state, writer), rn_wall = _no_hand_kernels(
            torch, lambda: train_resnet.run(_rn_dist_flags(
                f"{logdir}/rn_nccl", "--mesh_data=1")))
        require(state.layout is not None, "ResNet-20 in the group has no "
                                          "layout (no mesh)")
        rn_losses, rn_ms = _history(writer)
        rn_stats = {n: t.tolist() for n, t in state.extra.items()}
        del state, writer
        gc.collect()
        (state, writer), fused, flash, _, wall = _counted(
            torch, lambda: train_gpt.run(_gpt_dist_flags(
                f"{logdir}/nccl", "--mesh_data=1")))
        require(state.layout is not None, "the run inside the group has "
                                          "no layout (no mesh)")
        losses, step_ms = _history(writer)
        rel = _rel_losses(losses, ref_losses)
        require(len(losses) == DIST_GPT_STEPS
                and max(rel) <= DIST_LOSS_REL_TOL,
                f"losses in the group {losses} vs without {ref_losses}")
        require(fused == want_fused and flash == want_flash,
                f"launches in the group {fused} {flash}")
        del state, writer
        gc.collect()
        (state, writer), _, bert_flash, _, bert_wall = _counted(
            torch, lambda: train_bert.run(_bert_dist_flags(
                f"{logdir}/bert_nccl", "--mesh_data=1")))
        require(state.layout is not None, "BERT in the group has no layout")
        bert_losses, bert_ms = _history(writer)
        del state, writer
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(logdir, ignore_errors=True)
    bert_rel = _rel_losses(bert_losses, bert_ref_losses)
    bert_want = _bert_want(DIST_BERT_STEPS, accum=DIST_BERT_ACCUM)
    require(len(bert_losses) == DIST_BERT_STEPS
            and max(bert_rel) <= DIST_LOSS_REL_TOL
            and bert_flash == bert_flash_ref == bert_want,
            f"BERT in the group {bert_losses} vs without {bert_ref_losses}"
            f", launches {bert_flash} {bert_flash_ref}")
    rn_rel = _rel_losses(rn_losses, rn_ref_losses)
    rn_stat_rel = _rn_stats_rel(torch, rn_stats, rn_ref_stats)
    require(len(rn_losses) == DIST_RN_STEPS
            and max(rn_rel) <= DIST_LOSS_REL_TOL
            and rn_stat_rel <= DIST_RN_STAT_TOL,
            f"ResNet-20 in the group {rn_losses} vs without {rn_ref_losses}"
            f", statistics {rn_stat_rel}")
    emit({"phase": "dist_nccl", "world_size": 1, "backend": "nccl",
          "nvidia_smi": smi, "mnist": {"model": "softmax", "steps": 200,
                                       "loss_at_200": mnist_loss[0],
                                       "eval_accuracy": mnist_acc},
          "gpt": {"model": "gpt2-small", "batch": TRAIN_BATCH,
                  "seq": TRAIN_SEQ, "steps": DIST_GPT_STEPS,
                  "loss": "--loss_pallas", "zero1": True,
                  "losses_in_group": losses, "losses_no_group": ref_losses,
                  "loss_rel": rel, "loss_rel_tol": DIST_LOSS_REL_TOL,
                  "step_ms_median_after_1_in_group": step_ms,
                  "step_ms_median_after_1_no_group": ref_ms,
                  "run_wall_s_in_group": wall, "run_wall_s_no_group":
                      wall_ref, "fused_launches": fused,
                  "flash_launches": flash},
          "bert": {"model": "bert-base", "batch": DIST_BERT_BATCH,
                   "seq": BERT_SEQ, "grad_accum": DIST_BERT_ACCUM,
                   "steps": DIST_BERT_STEPS, "zero1": True,
                   "losses_in_group": bert_losses,
                   "losses_no_group": bert_ref_losses, "loss_rel": bert_rel,
                   "loss_rel_tol": DIST_LOSS_REL_TOL,
                   "step_ms_median_after_1_in_group": bert_ms,
                   "step_ms_median_after_1_no_group": bert_ref_ms,
                   "run_wall_s_in_group": bert_wall,
                   "run_wall_s_no_group": bert_ref_wall,
                   "flash_launches": bert_flash},
          "resnet20": {"batch": RN_BATCH, "steps": DIST_RN_STEPS,
                       "zero1": True, "batchnorm": "synchronised over the "
                       "data group (2 NCCL all-reduces a layer)",
                       "losses_in_group": rn_losses,
                       "losses_no_group": rn_ref_losses, "loss_rel": rn_rel,
                       "stats_rel": rn_stat_rel,
                       "stats_rel_tol": DIST_RN_STAT_TOL,
                       "step_ms_median_after_1_in_group": rn_ms,
                       "step_ms_median_after_1_no_group": rn_ref_ms,
                       "run_wall_s_in_group": rn_wall,
                       "run_wall_s_no_group": rn_ref_wall}})


def _gpt_global_batch_losses(torch):
    """One rank on the 2 ranks' global batch: train_gpt's recipe through
    the library, each step's batch the rows of synthetic host 0 then host
    1 of 2 (what the ranks read), the fused loss."""
    import dataclasses
    import gc

    import numpy as np

    from dtf_tpu_torch import optim, train_gpt
    from dtf_tpu_torch.convert import init_params_flax, params_from_flax
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.models import gpt

    args = train_gpt.build_parser().parse_args(_gpt_dist_flags("unused"))
    cfg = dataclasses.replace(gpt.GPTConfig.by_name(args.size),
                              remat=args.remat, attn_impl=args.attn_impl)
    model = gpt.GPT(cfg, device="cuda")
    model.load_state_dict(params_from_flax(init_params_flax(cfg,
                                                            args.seed)))
    tx = optim.make_optimizer(args, lambda s: optim.adamw(
        s, weight_decay=0.1), recipe_uses_wd=True)
    state = tr.create_train_state(model, tx, args.seed)
    step = tr.make_train_step(gpt.make_loss(model, loss_pallas=True), tx)
    hosts = [SyntheticData("gpt", TRAIN_BATCH, seed=args.seed,
                           seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size,
                           host_index=k, host_count=2) for k in range(2)]
    losses = []
    for i in range(DIST_GPT_STEPS):
        parts = [h.batch(i) for h in hosts]
        batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
                 .cuda() for k in parts[0]}
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return losses


#: the row exchange before the microbatches (--grad_accum 2 over 2
#: ranks): a ResNet-50 b256 batch (154 MB of f32 images, 128 rows a rank,
#: half of them sent) and BERT's b64 × 128 batch; timed repeats each
EXCHANGE_REPEATS = 5


def _exchange_ms(torch, world):
    """The device-to-device time of ``core.train``'s row exchange on this
    rank (host clock around synchronised calls; over gloo it goes through
    host memory): the median of EXCHANGE_REPEATS calls for each batch."""
    import statistics

    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.core.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(data=world), torch.device("cuda", 0))
    gen = torch.Generator(device="cuda").manual_seed(mesh.data_index)
    batches = {
        "resnet50_b256": {
            "image": torch.rand((256 // world, 224, 224, 3), device="cuda",
                                generator=gen),
            "label": torch.zeros(256 // world, dtype=torch.int32,
                                 device="cuda")},
        "bert_b64": {k: torch.zeros((BERT_BATCH // world, BERT_SEQ),
                                    dtype=torch.int32, device="cuda")
                     for k in ("input_ids", "segment_ids", "attention_mask",
                               "mlm_labels")}}
    out = {}
    for name, batch in batches.items():
        times = []
        for _ in range(EXCHANGE_REPEATS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr._exchange_rows(batch, 2, mesh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"bytes_a_rank": sum(v.numel() * v.element_size()
                                         for v in batch.values()),
                     "ms_median": statistics.median(times[1:]),
                     "ms_first": times[0]}
    return out


def dist_child(rank, world, store, logdir):
    """One rank of dist_two_ranks_one_card: joins the gloo group through
    ``file://store`` on cuda:0, runs ``train_widedeep --mesh_model 2`` and
    ``train_gpt --loss_pallas --mesh_data 2`` inside it, each counted, and
    writes ``logdir/rank{rank}.json``."""
    import gc

    import torch
    import torch.distributed as dist

    from dtf_tpu_torch import train_bert, train_gpt, train_resnet, \
        train_widedeep

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    out = {"rank": rank, "backend": dist.get_backend()}
    (state, writer), _, _, embed, wall = _counted(torch, lambda: (
        train_widedeep.run([f"--train_steps={DIST_WD_STEPS}",
                            "--log_every=1", "--checkpoint_every=1000",
                            "--mesh_model=2", f"--logdir={logdir}/wd"])))
    losses, step_ms = _history(writer)
    out["widedeep"] = {
        "losses": losses, "step_ms_median_after_1": step_ms,
        "run_wall_s": wall, "embed_gather_launches": embed,
        "table_rows": state.params["embed_tables_deep.weight"].shape[0],
        "eval_accuracy": [m["eval_accuracy"] for _, m in writer.history
                          if "eval_accuracy" in m]}
    del state, writer
    gc.collect()
    torch.cuda.empty_cache()
    (state, writer), fused, flash, _, wall = _counted(torch, lambda: (
        train_gpt.run(_gpt_dist_flags(f"{logdir}/gpt", "--mesh_data=2"))))
    losses, step_ms = _history(writer)
    mu = state.opt_state[0]["mu"]
    out["gpt"] = {
        "losses": losses, "step_ms_median_after_1": step_ms,
        "run_wall_s": wall, "fused_launches": fused, "flash_launches": flash,
        "zero1_leaves": len(state.layout.zero1_dims),
        "adam_mu_elements": sum(t.numel() for t in mu.values()),
        "param_elements": sum(p.numel() for p in state.params.values())}
    del state, writer
    gc.collect()
    torch.cuda.empty_cache()
    (state, writer), _, _, _, wall = _counted(torch, lambda: (
        train_resnet.run(_rn_dist_flags(f"{logdir}/rn", "--mesh_data=2"))))
    losses, step_ms = _history(writer)
    out["resnet20"] = {
        "losses": losses, "step_ms_median_after_1": step_ms,
        "run_wall_s": wall,
        "stats": {n: t.tolist() for n, t in state.extra.items()}}
    del state, writer
    gc.collect()
    torch.cuda.empty_cache()
    (state, writer), _, flash, _, wall = _counted(torch, lambda: (
        train_bert.run(_bert_dist_flags(f"{logdir}/bert", "--mesh_data=2"))))
    losses, step_ms = _history(writer)
    out["bert"] = {"losses": losses, "step_ms_median_after_1": step_ms,
                   "run_wall_s": wall, "flash_launches": flash,
                   "zero1_leaves": len(state.layout.zero1_dims)}
    del state, writer
    gc.collect()
    torch.cuda.empty_cache()
    out["row_exchange"] = _exchange_ms(torch, world)
    with open(os.path.join(logdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_dist_two_ranks_one_card(torch, smi):
    """Two processes on cuda:0 over gloo, the group made by this script
    (``dist_child``), the kernels built before the spawn:
    ``train_widedeep --mesh_model 2`` (the tables' rows split over the
    ranks; exactly 1 B8 launch a step a rank, the losses against the
    1-rank index_select run within DIST_WD_LOSS_REL_TOL) and ``train_gpt
    --loss_pallas --mesh_data 2`` (4 rows a rank, ZeRO-1; one B5/B6/B7 a
    step a rank, the losses against one rank on the same global batch
    within DIST_LOSS_REL_TOL). Every collective crosses the host through
    gloo: the times say that it runs, not how fast. Returns rank 0's B8
    and fused CE launches."""
    import gc
    import tempfile

    from dtf_tpu_torch import train_widedeep
    from dtf_tpu_torch.ops import _build

    _build.build(_build.KERNELS)
    logdir = tempfile.mkdtemp(prefix="chip_smoke_dist_2r_")
    (state, writer), _, _, embed_ref, _ = _counted(torch, lambda: (
        train_widedeep.run([f"--train_steps={DIST_WD_STEPS}",
                            "--log_every=1", "--checkpoint_every=1000",
                            f"--logdir={logdir}/wd_ref"])))
    wd_ref, _ = _history(writer)
    require(embed_ref == 0, f"the 1-rank Wide&Deep run launched B8 "
                            f"{embed_ref} times")
    del state, writer
    gc.collect()
    gpt_ref = _gpt_global_batch_losses(torch)
    rn_ref, rn_ref_stats = _rn_global_batch_run(torch)
    bert_ref = _bert_global_batch_losses(torch)
    torch.cuda.empty_cache()
    _run_children("--dist-child", 2, os.path.join(logdir, "store"), logdir,
                  DIST_CHILD_TIMEOUT_S, "rank")
    ranks = []
    for r in range(2):
        with open(os.path.join(logdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    want_fused, want_flash = _gpt_dist_want()
    want_embed = DIST_WD_STEPS + EVAL_BATCHES
    for got in ranks:
        wd, g = got["widedeep"], got["gpt"]
        require(got["backend"] == "gloo", got["backend"])
        require(wd["table_rows"] * 2 == WD_ROWS, f"rank {got['rank']} "
                f"holds {wd['table_rows']} of {WD_ROWS} table rows")
        require(wd["embed_gather_launches"] == want_embed,
                f"rank {got['rank']}: B8 launched "
                f"{wd['embed_gather_launches']} times, want {want_embed} "
                f"(1 a step and 1 an eval batch: both tables in one)")
        require(g["fused_launches"] == want_fused
                and g["flash_launches"] == want_flash,
                f"rank {got['rank']} GPT launches {g['fused_launches']} "
                f"{g['flash_launches']}")
        # ZeRO-1: adam's first moment holds about half of the parameters
        require(g["adam_mu_elements"] < 0.51 * g["param_elements"],
                f"rank {got['rank']}: ZeRO-1 holds {g['adam_mu_elements']} "
                f"of {g['param_elements']} moment elements")
    wd_losses, gpt_losses = (ranks[0]["widedeep"]["losses"],
                             ranks[0]["gpt"]["losses"])
    wd_rel, gpt_rel = (_rel_losses(wd_losses, wd_ref),
                       _rel_losses(gpt_losses, gpt_ref))
    require(len(wd_losses) == DIST_WD_STEPS
            and max(wd_rel) <= DIST_WD_LOSS_REL_TOL,
            f"Wide&Deep over 2 ranks {wd_losses} vs 1 rank {wd_ref}")
    require(len(gpt_losses) == DIST_GPT_STEPS
            and max(gpt_rel) <= DIST_LOSS_REL_TOL,
            f"GPT over 2 ranks {gpt_losses} vs one rank {gpt_ref}")
    rn_losses = ranks[0]["resnet20"]["losses"]
    rn_rel = _rel_losses(rn_losses, rn_ref)
    rn_stat_rel = [_rn_stats_rel(torch, g["resnet20"]["stats"], rn_ref_stats)
                   for g in ranks]
    require(len(rn_losses) == DIST_RN_STEPS and max(rn_rel) <=
            DIST_LOSS_REL_TOL and max(rn_stat_rel) <= DIST_RN_STAT_TOL,
            f"ResNet-20 over 2 ranks {rn_losses} vs one rank {rn_ref}, "
            f"statistics {rn_stat_rel}")
    bert_losses = ranks[0]["bert"]["losses"]
    bert_rel = _rel_losses(bert_losses, bert_ref)
    bert_want = _bert_want(DIST_BERT_STEPS, accum=DIST_BERT_ACCUM)
    require(len(bert_losses) == DIST_BERT_STEPS
            and max(bert_rel) <= DIST_LOSS_REL_TOL
            and all(g["bert"]["flash_launches"] == bert_want
                    for g in ranks),
            f"BERT over 2 ranks {bert_losses} vs one rank {bert_ref}, "
            f"launches {[g['bert']['flash_launches'] for g in ranks]}")
    shutil.rmtree(logdir, ignore_errors=True)
    emit({"phase": "dist_two_ranks_one_card", "world_size": 2,
          "backend": "gloo", "device": "cuda:0 (both ranks)",
          "nvidia_smi": smi, "zero1": True,
          "note": "collectives cross the host through gloo: the times "
                  "show that it runs, not a speed",
          "widedeep": {"mesh_model": 2, "steps": DIST_WD_STEPS,
                       "batch": WD_BATCH, "losses_2_ranks": wd_losses,
                       "losses_1_rank_index_select": wd_ref,
                       "loss_rel": wd_rel,
                       "loss_rel_tol": DIST_WD_LOSS_REL_TOL,
                       "ranks": [g["widedeep"] for g in ranks]},
          "gpt": {"mesh_data": 2, "steps": DIST_GPT_STEPS,
                  "rows_a_rank": TRAIN_BATCH // 2, "seq": TRAIN_SEQ,
                  "losses_2_ranks": gpt_losses,
                  "losses_1_rank_global_batch": gpt_ref,
                  "loss_rel": gpt_rel, "loss_rel_tol": DIST_LOSS_REL_TOL,
                  "ranks": [g["gpt"] for g in ranks]},
          "resnet20": {"mesh_data": 2, "steps": DIST_RN_STEPS,
                       "rows_a_rank": RN_BATCH // 2,
                       "batchnorm": "synchronised over the 2 ranks",
                       "losses_2_ranks": rn_losses,
                       "losses_1_rank_global_batch": rn_ref,
                       "loss_rel": rn_rel, "stats_rel": rn_stat_rel,
                       "stats_rel_tol": DIST_RN_STAT_TOL,
                       "ranks": [{k: v for k, v in g["resnet20"].items()
                                  if k != "stats"} for g in ranks]},
          "bert": {"mesh_data": 2, "steps": DIST_BERT_STEPS,
                   "rows_a_rank": DIST_BERT_BATCH // 2,
                   "grad_accum": DIST_BERT_ACCUM, "dropout": 0.1,
                   "zero1": True, "losses_2_ranks": bert_losses,
                   "losses_1_rank_global_batch": bert_ref,
                   "loss_rel": bert_rel, "loss_rel_tol": DIST_LOSS_REL_TOL,
                   "ranks": [g["bert"] for g in ranks]},
          "row_exchange": [g["row_exchange"] for g in ranks]})
    return {"embed_gather": ranks[0]["widedeep"]["embed_gather_launches"],
            "fused": ranks[0]["gpt"]["fused_launches"]}


#: gpt_tp_two_ranks: GPT-2 small over a model axis of 2 on one card,
#: b4 x 1024, 4 steps; the plain run publishes every TP_PUBLISH_EVERY
TP_RANKS, TP_BATCH, TP_STEPS, TP_PUBLISH_EVERY = 2, 4, 4, 2
TP_CHILD_TIMEOUT_S = 420
#: a TP run's step-4 parameters against the one-rank run's, leaf by leaf:
#: |p_tp - p_1| / |p_1 - p_init| over the whole leaf (each leaf's change
#: from the init, the runs' difference relative to it), the worst leaf
#: against this limit, set between readings on the card (PERF.md §6):
#: the sound runs' worst leaf 0.120 / 0.121 (the token table, plain /
#: overlap); with one planted fault in the TP backward 1.34 (the q/k/v
#: input's cotangent not summed) and 0.868 (the SP leaves' gradients not
#: summed)
TP_PARAM_DELTA_TOL = 0.3
#: leaves left out of that limit (reported): the attention key bias's
#: gradient is zero in exact arithmetic (it shifts every logit of a query
#: row alike, which the softmax ignores), so AdamW's update of it is its
#: rounding, scaled up, in either run
TP_PARAM_UNGATED = (".attention.key.bias",)


def _tp_flags(logdir, *extra):
    return ["--size=small", f"--batch_size={TP_BATCH}",
            f"--seq_len={TRAIN_SEQ}", "--log_every=1",
            "--checkpoint_every=1000", f"--logdir={logdir}",
            f"--train_steps={TP_STEPS}", "--seed=0", *extra]


def _tp_collectives_want(layers, overlap, steps=TP_STEPS,
                         evals=EVAL_BATCHES):
    """The model-group collectives a rank issues in a ``train_gpt
    --mesh_model 2`` run (``comms.collective_counts``), from the code.
    Plain TP, a step: 2 all-reduces a layer forward (attn_out's and
    mlp_out's sums), 2 backward (the cotangents of the q/k/v input and
    of mlp_in's), the embedding's sum, the head input's cotangent, the
    CE's max and its sums: 4L + 4; an eval batch, forward only: 2L + 3.
    ``--tp_overlap``, a step: 6 rings a layer forward (q, k, v, mlp_in
    gather, attn_out and mlp_out scatter), each mirrored by 2 in the
    backward (dx and dW), one exchange a ring at 2 ranks: 18L; the
    all-reduces of the embedding's sum, the CE's 2 and the SP leaves'
    gradients: 4; the all-gathers of the head's input and of the token
    split's cotangent: 2; the head gather's reduce-scatter: 1. An eval
    batch: 6L exchanges, 3 all-reduces, 1 all-gather. Both layouts add
    one ``psum`` over the data group (of one rank here) a step (the loss
    statistics) and one an eval batch (the metrics' mean)."""
    if not overlap:
        return {"all_reduce": steps * (4 * layers + 5)
                + evals * (2 * layers + 4),
                "all_gather": 0, "reduce_scatter": 0, "ring_exchange": 0,
                "broadcast": 0}
    return {"all_reduce": 5 * steps + 4 * evals,
            "all_gather": 2 * steps + evals, "reduce_scatter": steps,
            "ring_exchange": 18 * layers * steps + 6 * layers * evals,
            "broadcast": 0}


def _tp_kernels(torch):
    """B1 forward and B2/B3 backward at one rank's attention of GPT-2
    small over 2 model ranks, [4, 6, 1024, 64] bf16 causal: against
    their plain versions at the kernels / kernels_bwd gates, then each
    kernel's time, its plain version's, SDPA's and the bound."""
    from dtf_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(13)
    shape = (TP_BATCH, HEADS // TP_RANKS, TRAIN_SEQ, D_HEAD)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    do = torch.randn(shape[0], shape[2], shape[1], D_HEAD, generator=gen,
                     device="cuda", dtype=torch.bfloat16).transpose(1, 2)
    opts = dict(sm_scale=D_HEAD ** -0.5, causal=True, window=0)
    out, lse = fa.flash_attention_cuda(q, k, v, **opts)
    got = fa.flash_attention_bwd_cuda(q, k, v, None, out, lse, do, **opts)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **opts)
    want = fa.flash_attention_bwd_reference(q, k, v, None, out, lse, do,
                                            **opts)
    err = {"flash_fwd": (out.float() - ref_out.float()).abs().max().item()}
    d_lse = (lse - ref_lse).abs().max().item()
    require(torch.isfinite(out).all().item() and err["flash_fwd"] <= OUT_ATOL
            and d_lse <= LSE_ATOL, f"B1 at {list(shape)} disagrees (out "
            f"{err['flash_fwd']}, lse {d_lse})")
    rel = {}
    for gname, x, y in zip(("dq", "dk", "dv"), got, want):
        diff = x.float() - y.float()
        rel[gname] = (diff.norm() / y.float().norm().clamp_min(1e-30)).item()
        mab = diff.abs().max().item()
        require(torch.isfinite(x).all().item() and rel[gname] <= GRAD_REL_TOL
                and mab <= GRAD_MAX_ABS_TOL * y.float().abs().max().item(),
                f"{gname} at {list(shape)} disagrees (rel {rel[gname]}, "
                f"max-abs {mab})")
        kname = "flash_dq" if gname == "dq" else "flash_dkv"
        err[kname] = max(err.get(kname, 0.0), mab)
    delta = (do.float() * out.reshape(shape).float()).sum(dim=-1)
    fwd_bound = attention_bound_ms(*shape[:3], TRAIN_SEQ, D_HEAD, True, 0)
    dq_bound, dkv_bound = attention_bwd_bounds_ms(*shape[:3], TRAIN_SEQ,
                                                  D_HEAD, True, 0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lib_fwd = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True), 20)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), do), 20) - lib_fwd
    plain_bwd = time_ms(torch, lambda: fa.flash_attention_bwd_reference(
        q, k, v, None, out, lse, do, **opts), 3)
    times = {
        "flash_fwd": dict(
            ms=time_ms(torch, lambda: fa.flash_attention_cuda(
                q, k, v, **opts), 20),
            plain_ms=time_ms(torch, lambda: fa.flash_attention_reference(
                q, k, v, **opts), 3),
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
            library_ms=lib_fwd),
        "flash_dq": dict(
            ms=time_ms(torch, lambda: fa.flash_bwd_dq_cuda(
                q, k, v, do, lse, delta, **opts), 20),
            plain_ms=plain_bwd, bound_ms=dq_bound[0], bound_by=dq_bound[1],
            library_ms=lib_bwd),
        "flash_dkv": dict(
            ms=time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(
                q, k, v, do, lse, delta, **opts), 20),
            plain_ms=plain_bwd, bound_ms=dkv_bound[0],
            bound_by=dkv_bound[1], library_ms=lib_bwd)}
    fa.reset_launch_counts()
    return {"shape": list(shape), "lse_max_abs": d_lse, "grad_rel": rel,
            "max_abs_err": err, "times": times}


#: the TP ranks' sharded serving (gpt_tp_two_ranks, after training): the
#: plain run's version 1 through ``generate(mesh=)`` at b4 x 1024 + 64
#: greedy tokens, then ``serve_gpt --mesh_model 2``: 8 slots of 1024,
#: chunk 128, 8 replayed greedy requests; a decode step of each timed
#: TP_STEP_TIMED times and profiled TP_STEP_PROFILED more
TP_GEN_NEW = 64
TP_SERVE_SLOTS, TP_SERVE_REQUESTS = 8, 8
TP_SERVE_PROMPT, TP_SERVE_NEW, TP_SERVE_FILL = (128, 512), (32, 64), 512
TP_STEP_TIMED, TP_STEP_PROFILED = 10, 5


def _tp_prompt(torch):
    gen = torch.Generator(device="cuda").manual_seed(17)
    return torch.randint(0, VOCAB_REAL, (TP_BATCH, TRAIN_SEQ), generator=gen,
                         device="cuda")


def _tp_serve_requests():
    """The replayed requests: (prompt, budget) from a seed."""
    import numpy as np

    rng = np.random.default_rng(23)
    return [(rng.integers(0, VOCAB_REAL, int(rng.integers(
        TP_SERVE_PROMPT[0], TP_SERVE_PROMPT[1] + 1))).tolist(),
        int(rng.integers(TP_SERVE_NEW[0], TP_SERVE_NEW[1] + 1)))
        for _ in range(TP_SERVE_REQUESTS)]


def _tp_serve_flags(logdir, *extra):
    text = ";".join(",".join(map(str, p)) + f"/{n}"
                    for p, n in _tp_serve_requests())
    return [f"--publish_dir={logdir}/pub", "--publish_version=1",
            f"--n_slots={TP_SERVE_SLOTS}", f"--max_len={SERVE_MAX_LEN}",
            f"--prefill_chunk={SERVE_CHUNK}", f"--requests={text}",
            "--emit_tokens", *extra]


def _tp_step_collectives_want(layers, announced):
    """One decode step's counted collectives on a rank at model 2, from
    the code: the embedding's and each layer's two row-parallel sums
    (2L + 1 all-reduces), the vocab gather of the sampled rows, and an
    engine step's announcing broadcast."""
    return {"all_reduce": 2 * layers + 1, "all_gather": 1,
            "reduce_scatter": 0, "ring_exchange": 0,
            "broadcast": int(announced)}


def _prof_busy(torch, prof, calls):
    """(device-busy ms, kernel launches) a call of a profiled window."""
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    return device_us / 1e3 / calls, launches / calls


def _tp_generate_child(torch, rank, logdir, mesh):
    """``generate(mesh=)`` on this rank: the call's B1 launches and their
    shapes, its collectives, a decode step timed and profiled; its tokens
    and the last prompt position's whole logits to
    ``logdir/tp_gen{rank}.pt``."""
    import dataclasses
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from dtf_tpu_torch import publish
    from dtf_tpu_torch.core import comms
    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    _, _, whole = publish.load_published(os.path.join(logdir, "pub"), 1)
    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_small(),
                              decode_len=TRAIN_SEQ + TP_GEN_NEW)
    model = gpt.GPT(cfg, device="cuda", mesh=mesh)
    model.load_state_dict(gpt.tp_shard(whole, mesh))
    model.eval()
    del whole
    prompt = _tp_prompt(torch)
    shapes, real = [], gpt.flash_attention

    def recording(q, k, v, **kw):
        shapes.append(list(q.shape))
        return real(q, k, v, **kw)

    gpt.flash_attention = recording
    try:
        fa.reset_launch_counts()
        comms.reset_collective_counts()
        toks, gen_s = timed(torch, lambda: gpt.generate(
            model, prompt, TP_GEN_NEW, mesh=mesh))
    finally:
        gpt.flash_attention = real
    out = {"flash_launches": dict(fa.launch_counts), "b1_shapes": shapes,
           "generate_ms": gen_s * 1e3,
           "collectives": dict(comms.collective_counts),
           "collective_ms": 1e3 * sum(comms.collective_seconds.values())}
    with torch.no_grad():
        cache = model.init_cache(TP_BATCH)
        last = model.vocab_rows(model(prompt, cache)[:, -1])
        box = [last.argmax(-1)]

        def step():
            box[0] = model.vocab_rows(
                model(box[0][:, None], cache)[:, 0]).argmax(-1)
            torch.cuda.synchronize()

        step()                                            # warm-up
        comms.reset_collective_counts()
        walls = []
        for _ in range(TP_STEP_TIMED):
            t = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t) * 1e3)
        counts = dict(comms.collective_counts)
        coll_ms = 1e3 * sum(comms.collective_seconds.values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TP_STEP_PROFILED):
                step()
        busy, launches = _prof_busy(torch, prof, TP_STEP_PROFILED)
    out["step"] = {"wall_ms_median": statistics.median(walls),
                   "wall_ms_min": min(walls), "busy_ms": busy,
                   "launches": launches,
                   "collectives": {k: v / TP_STEP_TIMED
                                   for k, v in counts.items()},
                   "collective_ms": coll_ms / TP_STEP_TIMED}
    torch.save({"tokens": toks.cpu(), "last_logits": last.float().cpu()},
               os.path.join(logdir, f"tp_gen{rank}.pt"))
    out["seconds"] = time.perf_counter() - t0
    return out


def _tp_serve_child(torch, rank, logdir):
    """``serve_gpt --mesh_model 2`` on this rank (rank 0 leads), then a
    decode step of the same engines with every slot full at
    TP_SERVE_FILL positions: timed (a round of TP_STEP_TIMED steps),
    then profiled (TP_STEP_PROFILED more); the follower times each call
    it runs."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from dtf_tpu_torch import serve_gpt
    from dtf_tpu_torch.core import comms

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(io.StringIO()):
        line, rows, engine = serve_gpt.run(_tp_serve_flags(
            logdir, "--mesh_model=2"))
    out = {"leader": engine.is_leader, "rows": rows,
           "serve_wall_s": time.perf_counter() - t0,
           "kv_mib": _engine_kv(engine),
           "line": None if line is None else {
               k: line[k] for k in ("tokens_per_sec", "serve_ttft_p50_s",
                                    "generated_tokens", "request_statuses",
                                    "wall_s", "cache_mib")}}
    fill = list(range(1, TP_SERVE_FILL + 1))
    announced = []
    if engine.is_leader:
        with engine.leading():
            for slot in range(engine.n_slots):
                engine.prefill(slot, fill)
        torch.cuda.synchronize()
        comms.reset_collective_counts()
        walls = []
        with engine.leading():
            for _ in range(TP_STEP_TIMED):
                t = time.perf_counter()
                engine.decode()
                walls.append((time.perf_counter() - t) * 1e3)
        counts = dict(comms.collective_counts)
        coll_s = sum(comms.collective_seconds.values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with engine.leading():
                for _ in range(TP_STEP_PROFILED):
                    engine.decode()
            torch.cuda.synchronize()
    else:
        require(engine.follow(), "the leader's prefill round failed")
        run, walls = engine._run_op, []

        def timed_op(op, args):
            announced.append(op)
            t = time.perf_counter()
            result = run(op, args)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            return result

        engine._run_op = timed_op
        comms.reset_collective_counts()
        require(engine.follow(), "the leader's timed round failed")
        engine._run_op = run
        counts = dict(comms.collective_counts)
        coll_s = sum(comms.collective_seconds.values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            require(engine.follow(), "the leader's profiled round failed")
            torch.cuda.synchronize()
    busy, launches = _prof_busy(torch, prof, TP_STEP_PROFILED)
    out["step"] = {"wall_ms_median": statistics.median(walls),
                   "wall_ms_min": min(walls), "busy_ms": busy,
                   "launches": launches, "round_collectives": counts,
                   "collective_ms": coll_s * 1e3 / TP_STEP_TIMED,
                   "ops": sorted(set(announced))}
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    out["seconds"] = time.perf_counter() - t0
    del engine
    return out


#: the sharded fleet (gpt_tp_two_ranks, after sharded serving): 2
#: replicas on the 2 ranks serve TP_FLEET_REQUESTS replayed greedy
#: requests of TP_FLEET_PROMPT prompt and TP_FLEET_NEW new tokens while
#: rolling from version 1 to 2 (the publish dir polled every
#: TP_FLEET_POLL ticks, the canary alone for TP_FLEET_CANARY); health bars
#: no gloo tick reaches, so only the planted fault rolls back
TP_FLEET_REQUESTS, TP_FLEET_PROMPT, TP_FLEET_NEW = 6, (32, 128), (8, 12)
TP_FLEET_POLL, TP_FLEET_CANARY = 2, 2
TP_FLEET_FLAGS = ("--replicas=2", f"--swap_poll_ticks={TP_FLEET_POLL}",
                  f"--canary_ticks={TP_FLEET_CANARY}", "--health_slow_s=30",
                  "--health_wedge_s=60")
TP_FLEET_WEDGE = "wedge_in_swap@0:replica=1"


def _tp_fleet_requests():
    """The fleet's replayed requests: (prompt, budget) from a seed."""
    import numpy as np

    rng = np.random.default_rng(29)
    return [(rng.integers(0, VOCAB_REAL, int(rng.integers(
        TP_FLEET_PROMPT[0], TP_FLEET_PROMPT[1] + 1))).tolist(),
        int(rng.integers(TP_FLEET_NEW[0], TP_FLEET_NEW[1] + 1)))
        for _ in range(TP_FLEET_REQUESTS)]


def _tp_fleet_flags(logdir, version, *extra):
    """serve_gpt on ``version`` of the plain run's publish dir (one engine
    unless ``extra`` makes it a fleet)."""
    text = ";".join(",".join(map(str, p)) + f"/{n}"
                    for p, n in _tp_fleet_requests())
    return [f"--publish_dir={logdir}/pub", f"--publish_version={version}",
            f"--n_slots={TP_SERVE_SLOTS}", f"--max_len={SERVE_MAX_LEN}",
            f"--prefill_chunk={SERVE_CHUNK}", f"--requests={text}",
            "--emit_tokens", *extra]


def _tp_fleet_child(torch, logdir):
    """The sharded fleet on this rank (rank 0 leads): the roll from
    version 1 to 2 under traffic, a fresh fleet on each version, and the
    roll with ``TP_FLEET_WEDGE``. Of each run: its rows, peak memory, the
    replicas' versions, whether they hold one set (``data_ptr``), each
    replica's KV, one shard set's bytes, the plane's calls by op (count,
    ms on this rank, counted collectives), whether each replica serves
    the tensors it held when the version was staged (identity), and on
    the leader the line's swap keys, each request's version stamp and
    the swap steps' ms."""
    import gc

    from dtf_tpu_torch import serve_gpt
    from dtf_tpu_torch.serve.router import Router

    t0 = time.perf_counter()
    staged_with = []
    stage = Router._stage_here

    def noting(self, version, params, draft):
        staged_with.append([{n: id(p) for n, p in e.params.items()}
                            for e in self.engines])
        return stage(self, version, params, draft)

    Router._stage_here = noting
    runs = {}
    try:
        for name, version, extra, fault in (
                ("roll", 1, TP_FLEET_FLAGS, None),
                ("fresh_v1", 1, ("--replicas=2",), None),
                ("fresh_v2", 2, ("--replicas=2",), None),
                ("wedge", 1, TP_FLEET_FLAGS, TP_FLEET_WEDGE)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            staged_with.clear()
            if fault:
                os.environ["DTF_FAULT_INJECT"] = fault
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    (line, rows, router), wall = _no_hand_kernels(
                        torch, lambda: serve_gpt.run(_tp_fleet_flags(
                            logdir, version, "--mesh_model=2", *extra)))
            finally:
                os.environ.pop("DTF_FAULT_INJECT", None)
            engines = router.engines
            models = [e._model for e in engines]
            run = {"leader": router.is_leader, "rows": rows,
                   "wall_s": wall,
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "versions": [e.param_version for e in engines],
                   "one_set": all(
                       p.data_ptr() == q.data_ptr() for m in models[1:]
                       for p, q in zip(models[0].parameters(),
                                       m.parameters())),
                   "kv_mib": [_engine_kv(e)["target"] for e in engines],
                   "shard_set_bytes": sum(p.numel() * p.element_size()
                                          for p in models[0].parameters()),
                   "staged_sets": len(engines[0].plane.sets),
                   "ops": {op: {"calls": st["calls"],
                                "ms": st["seconds"] * 1e3,
                                "collectives": st["collectives"]}
                           for op, st in engines[0].plane.op_stats.items()},
                   "staged_tensors_kept": bool(staged_with) and [
                       {n: id(p) for n, p in e.params.items()}
                       for e in engines] == staged_with[0]}
            if router.is_leader:
                run["line"] = {k: line.get(k) for k in (
                    "served_version", "final_version", "replicas",
                    "request_statuses", "router_swaps",
                    "router_swap_rollbacks", "router_requeued",
                    "router_probe_decodes", "router_ticks",
                    "tokens_per_sec", "wall_s", "fault_inject")}
                run["stamps"] = [router.poll(i)["version"]
                                 for i in range(TP_FLEET_REQUESTS)]
                run["swap_ms"] = {k: {"total": v["total_s"] * 1e3,
                                      "count": v["count"]}
                                  for k, v in router.swap_profile().items()}
            runs[name] = run
            del router, engines, models
    finally:
        Router._stage_here = stage
    return {"runs": runs, "seconds": time.perf_counter() - t0}


def tp_child(rank, world, store, logdir):
    """One rank of gpt_tp_two_ranks: joins the gloo group through
    ``file://store`` on cuda:0, runs ``train_gpt --mesh_model 2`` and
    then with ``--tp_overlap`` inside it, each counted, with its step ms,
    the host ms inside the counted collectives (``comms.collective_
    seconds``) and its peak memory, and writes
    ``logdir/tp_rank{rank}.json``."""
    import gc
    import statistics

    import torch
    import torch.distributed as dist

    from dtf_tpu_torch import train_gpt
    from dtf_tpu_torch.core import comms
    from dtf_tpu_torch.metrics import MetricWriter

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    # the host ms inside the collectives so far, read where the
    # LoggingHook writes a step's line (where it reads the step's time)
    at_log = []
    write = MetricWriter.write_scalars

    def write_and_read(self, step, scalars):
        if "steps_per_sec" in scalars:
            at_log.append({k: v * 1e3
                           for k, v in comms.collective_seconds.items()})
        write(self, step, scalars)

    MetricWriter.write_scalars = write_and_read
    out = {"rank": rank, "backend": dist.get_backend()}
    for name, extra in (("plain", [f"--publish_dir={logdir}/pub",
                                   f"--publish_every={TP_PUBLISH_EVERY}"]),
                        ("overlap", ["--tp_overlap"])):
        comms.reset_collective_counts()
        torch.cuda.reset_peak_memory_stats()
        at_log.clear()
        (state, writer), _, flash, _, wall = _counted(torch, lambda: (
            train_gpt.run(_tp_flags(f"{logdir}/{name}", "--mesh_model=2",
                                    *extra))))
        losses, step_ms = _history(writer)
        steps_ms = [1e3 / m["steps_per_sec"] for _, m in writer.history
                    if "steps_per_sec" in m]
        totals = [0.0] + [sum(c.values()) for c in at_log]
        coll_ms = [b - a for a, b in zip(totals, totals[1:])]
        share = [c / w for c, w in zip(coll_ms, steps_ms)]
        out[name] = {
            "losses": losses, "step_ms_median_after_1": step_ms,
            "step_ms": steps_ms, "run_wall_s": wall, "flash_launches": flash,
            "collectives": dict(comms.collective_counts),
            "collective_ms": coll_ms,
            "collective_share_median_after_1": statistics.median(share[1:]),
            # the steps' (to the last step's line), then the final eval's
            "collective_ms_by_kind_steps": at_log[-1],
            "collective_ms_by_kind_eval": {
                k: v * 1e3 - at_log[-1][k]
                for k, v in comms.collective_seconds.items()},
            "run_peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
            "heads_a_rank": state.params[
                "layer_0.attention.query.weight"].shape[0] // D_HEAD,
            "param_elements_a_rank": sum(p.numel()
                                         for p in state.params.values())}
        del state, writer
        gc.collect()
        torch.cuda.empty_cache()
    # the same two ranks serve the plain run's version 1
    from dtf_tpu_torch.core.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(model=world), torch.device("cuda", 0))
    out["generate"] = _tp_generate_child(torch, rank, logdir, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = _tp_serve_child(torch, rank, logdir)
    gc.collect()
    torch.cuda.empty_cache()
    out["fleet"] = _tp_fleet_child(torch, logdir)
    with open(os.path.join(logdir, f"tp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _run_children(flag, world, store, logdir, timeout_s, log_prefix):
    """``world`` processes of this script with ``flag`` (a rank each),
    outputs in files (a full pipe would stall a rank inside a
    collective), waited on within ``timeout_s`` in all; on expiry or a
    failure all are killed and the phase fails with their tails."""
    logs = [open(os.path.join(logdir, f"{log_prefix}{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r),
         str(world), store, logdir], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                failed = f"rank {r} did not finish in {timeout_s} s"
                break
            if p.returncode:
                failed = f"rank {r} exited {p.returncode}"
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if failed:
        tails = []
        for r in range(world):
            with open(os.path.join(logdir, f"{log_prefix}{r}.log")) as f:
                tails.append(f"rank {r}:\n" + f.read()[-4000:])
        require(False, f"{failed}; output of the ranks:\n" +
                "\n----\n".join(tails))


def _load_params(torch, path):
    return torch.load(path, map_location="cuda", weights_only=True)


def _param_delta_rel(got, ref, init):
    """Leaf → |got - ref| / |ref - init| (whole leaves, f32)."""
    out = {}
    for n, r in ref.items():
        moved = (r.float() - init[n].float()).norm().item()
        diff = (got[n].float() - r.float()).norm().item()
        out[n] = diff / moved if moved else (0.0 if not diff else math.inf)
    return out


def _tp_serve_check(torch, logdir, ranks, layers):
    """The ranks' sharded decode and serving against one rank on the same
    weights (docstring item 33): ``generate(mesh=)``'s B1 launches and
    shapes, collectives, last prompt logits and greedy tokens; the
    engine's streams, KV cache and a decode step's collectives."""
    import dataclasses
    import gc

    from dtf_tpu_torch import publish, serve_gpt
    from dtf_tpu_torch.models import gpt

    t0 = time.perf_counter()
    shape = [TP_BATCH, HEADS // TP_RANKS, TRAIN_SEQ, D_HEAD]
    want_call = {"all_reduce": TP_GEN_NEW * (2 * layers + 1),
                 "all_gather": TP_GEN_NEW, "reduce_scatter": 0,
                 "ring_exchange": 0, "broadcast": 0}
    want_round = {k: v * TP_STEP_TIMED for k, v in
                    _tp_step_collectives_want(layers, True).items()}
    want_round["broadcast"] += 1                  # the round's stop
    for got in ranks:
        g, r = got["generate"], got["rank"]
        require(g["flash_launches"] == {"flash_fwd": layers,
                                        "flash_fwd_hfold": 0, "flash_dq": 0,
                                        "flash_dkv": 0},
                f"rank {r}: generate(mesh=) flash launches "
                f"{g['flash_launches']}, want {layers} B1")
        require(g["b1_shapes"] == [shape] * layers,
                f"rank {r}: B1 at {g['b1_shapes']}, want {shape}")
        require(g["collectives"] == want_call,
                f"rank {r}: generate(mesh=) collectives {g['collectives']}"
                f", want {want_call}")
        require(g["step"]["collectives"] == _tp_step_collectives_want(
            layers, False), f"rank {r}: a decode step's collectives "
            f"{g['step']['collectives']}")
        s = got["serve"]["step"]
        require(s["round_collectives"] == want_round,
                f"rank {r}: an engine round of {TP_STEP_TIMED} decode "
                f"steps counted {s['round_collectives']}, want "
                f"{want_round}")
    require(ranks[1]["serve"]["step"]["ops"] == ["decode"],
            f"the follower ran {ranks[1]['serve']['step']['ops']}")
    gens = [torch.load(os.path.join(logdir, f"tp_gen{r}.pt"))
            for r in range(TP_RANKS)]
    require(all(torch.equal(gens[0][k], g[k]) for g in gens[1:]
                for k in gens[0]), "the ranks' generate outputs differ")
    # one rank, no mesh, on the same version
    _, _, whole = publish.load_published(os.path.join(logdir, "pub"), 1)
    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_small(),
                              decode_len=TRAIN_SEQ + TP_GEN_NEW)
    model = gpt.GPT(cfg, device="cuda")
    model.load_state_dict(whole)
    model.eval()
    del whole
    prompt = _tp_prompt(torch)
    with torch.no_grad():
        ref_last = model(prompt, model.init_cache(TP_BATCH))[:, -1].cpu()
        ref = gpt.generate(model, prompt, TP_GEN_NEW)
        logits = model(ref[:, :-1], model.init_cache(TP_BATCH))[
            :, TRAIN_SEQ - 1:]
    scale = ref_last.abs().max().item()
    last_diff = (gens[0]["last_logits"] - ref_last).abs().max().item()
    require(last_diff <= LOGITS_REL_TOL * scale,
            f"generate(mesh=)'s last prompt logits differ from one rank's "
            f"by {last_diff} (> {LOGITS_REL_TOL} x {scale})")
    top2 = logits.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu()          # [B, TP_GEN_NEW]
    tol = LOGITS_REL_TOL * logits.abs().max().item()
    ref, compared = ref.cpu(), 0
    for row in range(TP_BATCH):
        close = (margin[row] < tol).nonzero()
        upto = int(close[0]) if len(close) else TP_GEN_NEW
        require(torch.equal(gens[0]["tokens"][row, :TRAIN_SEQ + upto],
                            ref[row, :TRAIN_SEQ + upto]),
                f"row {row}: generate(mesh=)'s greedy tokens differ from "
                f"one rank's before step {upto} (the first top-2 margin "
                f"under {tol})")
        compared += upto
    del model, logits, top2
    gc.collect()
    torch.cuda.empty_cache()
    # the engine: one rank's serve_gpt on the same version and requests
    with contextlib.redirect_stdout(io.StringIO()):
        line, rows, engine = serve_gpt.run(_tp_serve_flags(logdir))
    lead = ranks[0]["serve"]
    require(lead["leader"] and not ranks[1]["serve"]["leader"],
            "rank 0 must lead the sharded engine")
    require(lead["line"]["request_statuses"] == {"done": TP_SERVE_REQUESTS}
            and ranks[1]["serve"]["rows"] == [],
            f"serve_gpt --mesh_model 2: {lead['line']}")
    differ = _differ_at_near_ties(torch, engine, _tp_serve_requests(),
                                  lead["rows"], rows,
                                  "the sharded engine and one rank's")
    one_kv = _engine_kv(engine)["target"]
    for got in ranks:
        require(got["serve"]["kv_mib"]["target"] * TP_RANKS == one_kv,
                f"rank {got['rank']}: KV cache "
                f"{got['serve']['kv_mib']['target']} MiB, one rank's "
                f"{one_kv}")
    one_rank = {k: line[k] for k in ("tokens_per_sec", "serve_ttft_p50_s",
                                     "generated_tokens", "wall_s")}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"generate": {"b1_shape": shape, "collectives_want": want_call,
                         "last_logits_max_abs_diff": last_diff,
                         "max_abs_logit": scale,
                         "tokens_compared": compared,
                         "tokens_generated": TP_BATCH * TP_GEN_NEW},
            "serve": {"requests": TP_SERVE_REQUESTS, "differ": differ,
                      "kv_mib_one_rank": one_kv,
                      "step_round_collectives_want": want_round,
                      "one_rank": one_rank},
            "check_seconds": time.perf_counter() - t0}


def _tp_fleet_check(torch, logdir, ranks):
    """The ranks' sharded fleet (docstring item 33) against one rank's
    engine on each version: streams by their version stamps (near-ties
    allowed), the roll's and the rollback's story on each rank, the
    plane's fleet calls exact, KV, peak memory; returns what to print."""
    import gc

    from dtf_tpu_torch import serve_gpt

    t0 = time.perf_counter()
    reqs = _tp_fleet_requests()
    runs = [got["fleet"]["runs"] for got in ranks]
    lead = runs[0]
    require(all(r[name]["leader"] is (i == 0) for i, r in enumerate(runs)
                for name in r), "rank 0 must lead the sharded fleet")
    done = {"done": TP_FLEET_REQUESTS}
    roll, fresh, wedge = (lead[n]["line"] for n in ("roll", "fresh_v2",
                                                    "wedge"))
    require(lead["fresh_v1"]["line"]["request_statuses"] == done,
            f"the fresh fleet on 1: {lead['fresh_v1']['line']}")
    require(roll["request_statuses"] == done and roll["served_version"] == 1
            and roll["final_version"] == 2 and roll["router_swaps"] == 1.0
            and roll["router_swap_rollbacks"] == 0.0
            and roll["router_probe_decodes"] == 2.0
            and roll["router_requeued"] >= 1.0, f"the roll: {roll}")
    require(fresh["request_statuses"] == done
            and fresh["final_version"] == 2, f"the fresh fleet: {fresh}")
    require(wedge["request_statuses"] == done
            and wedge["final_version"] == 1
            and wedge["router_swap_rollbacks"] == 1.0
            and wedge["router_swaps"] == 0.0
            and wedge["fault_inject"] == TP_FLEET_WEDGE,
            f"the wedged roll: {wedge}")
    stamps = lead["roll"]["stamps"]
    require(set(stamps) <= {1, 2} and lead["wedge"]["stamps"]
            == [1] * TP_FLEET_REQUESTS and lead["fresh_v2"]["stamps"]
            == [2] * TP_FLEET_REQUESTS and lead["fresh_v1"]["stamps"]
            == [1] * TP_FLEET_REQUESTS, f"version stamps: roll {stamps}, "
            f"wedged {lead['wedge']['stamps']}")
    # the fleet's calls over the plane: the staging, each swap and the
    # end of the roll one announcing broadcast each, and nothing else
    # (no tensor collective carries parameters); each swap's ms
    one = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
           "ring_exchange": 0, "broadcast": 1}
    want_ops = {"roll": {"stage": 1, "swap": 2, "commit": 1},
                "wedge": {"stage": 1, "swap": 2, "rollback": 1},
                "fresh_v1": {}, "fresh_v2": {}}
    swap_ms = []
    for r, got in enumerate(runs):
        for name, want in want_ops.items():
            ops = got[name]["ops"]
            fleet_ops = {op: st for op, st in ops.items()
                         if op in ("stage", "swap", "commit", "rollback")}
            require({op: st["calls"] for op, st in fleet_ops.items()}
                    == want and all(st["collectives"] == {
                        k: v * st["calls"] for k, v in one.items()}
                        for st in fleet_ops.values()),
                    f"rank {r} {name}: the fleet's calls {fleet_ops}")
            require(got[name]["staged_sets"] == 0,
                    f"rank {r} {name}: staged sets left")
        require(got["roll"]["versions"] == [2, 2] and got["roll"]["one_set"]
                and got["fresh_v2"]["one_set"],
                f"rank {r}: after the roll {got['roll']['versions']}")
        require(got["wedge"]["versions"] == [1, 1]
                and got["wedge"]["one_set"]
                and got["wedge"]["staged_tensors_kept"],
                f"rank {r}: the rollback left {got['wedge']['versions']} "
                "or other tensors than version 1's")
        extra = got["roll"]["peak_bytes"] - got["fresh_v2"]["peak_bytes"]
        require(extra <= got["roll"]["shard_set_bytes"]
                + SWAP_PEAK_SLACK_BYTES,
                f"rank {r}: the roll's peak is {extra} bytes over a fresh "
                f"fleet's, past one shard set "
                f"({got['roll']['shard_set_bytes']})")
        swap_ms.append(got["roll"]["ops"]["swap"]["ms"]
                       / got["roll"]["ops"]["swap"]["calls"])
    # one rank's engine on each version: the streams by their stamps
    rows_of, one_kv, differ = {}, None, {}
    for version in (1, 2):
        gc.collect()
        torch.cuda.empty_cache()
        with contextlib.redirect_stdout(io.StringIO()):
            _, rows_of[version], engine = serve_gpt.run(
                _tp_fleet_flags(logdir, version))
        one_kv = _engine_kv(engine)["target"]
        for name, marks in ((n, lead[n]["stamps"]) for n in lead):
            idx = [i for i, v in enumerate(marks) if v == version]
            differ[f"{name} v{version}"] = _differ_at_near_ties(
                torch, engine, [reqs[i] for i in idx],
                [lead[name]["rows"][i] for i in idx],
                [rows_of[version][i] for i in idx],
                f"the sharded fleet's ({name}) and one rank's on version "
                f"{version}")
        del engine
    for r, got in enumerate(runs):
        require(all(kv * TP_RANKS == one_kv for kv in got["roll"]["kv_mib"]),
                f"rank {r}: KV {got['roll']['kv_mib']} MiB a replica, one "
                f"rank's {one_kv}")
    # the rolled-back fleet serves the fault-free fleet's version-1
    # streams, and the roll each stream of the fresh fleet on its version
    require(lead["wedge"]["rows"] == lead["fresh_v1"]["rows"],
            "the rolled-back fleet's streams differ from the fault-free "
            "fleet's on version 1")
    require(all(row == lead[f"fresh_v{v}"]["rows"][i] for i, (row, v) in
                enumerate(zip(lead["roll"]["rows"], stamps))),
            "a stream of the roll differs from the fresh fleet's on its "
            "version")
    gc.collect()
    torch.cuda.empty_cache()
    child_s = max(got["fleet"]["seconds"] for got in ranks)
    check_s = time.perf_counter() - t0
    return {"requests": TP_FLEET_REQUESTS, "stamps": stamps,
            "differ": differ, "kv_mib_one_rank": one_kv,
            "lines": {n: lead[n]["line"] for n in lead},
            "roll_s": lead["roll"]["swap_ms"]["swap_roll"]["total"] / 1e3,
            "swap_ms_by_rank": swap_ms,
            "swap_steps_ms": lead["roll"]["swap_ms"],
            "ops_by_rank": [{n: got[n]["ops"] for n in got} for got in runs],
            "peak_mib_by_rank": [{n: got[n]["peak_bytes"] / 2 ** 20
                                  for n in got} for got in runs],
            "shard_set_mib": runs[0]["roll"]["shard_set_bytes"] / 2 ** 20,
            "wall_s_by_rank": [{n: got[n]["wall_s"] for n in got}
                               for got in runs],
            "seconds": {"ranks": child_s, "check": check_s,
                        "sub_phase": child_s + check_s}}


def phase_gpt_tp_two_ranks(torch, smi):
    """Megatron TP of GPT-2 small over 2 ranks on cuda:0 (docstring item
    33). Returns rank 0's flash launches of the plain TP run."""
    import gc
    import statistics
    import tempfile

    from dtf_tpu_torch import publish, train_gpt
    from dtf_tpu_torch.convert import init_params_flax, params_from_flax
    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    kernels = _tp_kernels(torch)
    logdir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    (state, writer), _, ref_flash, _, ref_wall = _counted(torch, lambda: (
        train_gpt.run(_tp_flags(f"{logdir}/ref"))))
    ref_losses, ref_step_ms = _history(writer)
    layers = gpt.GPTConfig.by_name("small").layers
    del state, writer
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = f"ckpt/{TP_STEPS}/params.pt"
    _run_children("--tp-child", TP_RANKS, os.path.join(logdir, "store"),
                  logdir, TP_CHILD_TIMEOUT_S, "tp_rank")
    ranks = []
    for r in range(TP_RANKS):
        with open(os.path.join(logdir, f"tp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    # the TP runs' whole step-4 parameters against the one-rank run's,
    # each leaf's change from the init (the runs' own, from the seed)
    init = {n: t.cuda() for n, t in params_from_flax(init_params_flax(
        gpt.GPTConfig.by_name("small"), 0)).items()}
    ref_params = _load_params(torch, os.path.join(logdir, "ref", ckpt))
    ref_shapes = {n: list(t.shape) for n, t in ref_params.items()}
    param_rel = {}
    for name in ("plain", "overlap"):
        got = _load_params(torch, os.path.join(logdir, name, ckpt))
        require({n: list(t.shape) for n, t in got.items()} == ref_shapes,
                f"{name}: the checkpoint's names or shapes differ from the "
                "one-rank run's")
        rel = _param_delta_rel(got, ref_params, init)
        gated = {n: v for n, v in rel.items()
                 if not n.endswith(TP_PARAM_UNGATED)}
        worst = max(gated, key=gated.get)
        param_rel[name] = {
            "worst_leaf": worst, "worst": rel[worst],
            "median": statistics.median(rel.values()),
            "ungated_max": max(v for n, v in rel.items() if n not in gated)}
        del got
    require(all(v["worst"] <= TP_PARAM_DELTA_TOL
                for v in param_rel.values()),
        f"the TP runs' step-{TP_STEPS} parameters are off the one-rank "
        f"run's: {param_rel}, limit {TP_PARAM_DELTA_TOL}")
    del init, ref_params
    evals = EVAL_BATCHES
    want_flash = {"flash_fwd": 12 * (TP_STEPS + evals), "flash_fwd_hfold": 0,
                  "flash_dq": 12 * TP_STEPS, "flash_dkv": 12 * TP_STEPS}
    require(ref_flash == want_flash, f"one rank: flash launches {ref_flash}")
    rel = {}
    for name in ("plain", "overlap"):
        want_coll = _tp_collectives_want(layers, name == "overlap")
        for got in ranks:
            g = got[name]
            require(got["backend"] == "gloo", got["backend"])
            require(g["heads_a_rank"] == HEADS // TP_RANKS,
                    f"rank {got['rank']} {name}: {g['heads_a_rank']} heads")
            require(g["flash_launches"] == want_flash,
                    f"rank {got['rank']} {name}: flash launches "
                    f"{g['flash_launches']}, want {want_flash}")
            require(g["collectives"] == want_coll,
                    f"rank {got['rank']} {name}: counted collectives "
                    f"{g['collectives']}, want {want_coll}")
            require(g["losses"] == ranks[0][name]["losses"],
                    f"{name}: the ranks' losses differ")
        losses = ranks[0][name]["losses"]
        rel[name] = _rel_losses(losses, ref_losses)
        require(len(losses) == TP_STEPS and max(rel[name]) <=
                DIST_LOSS_REL_TOL, f"GPT TP {name} over 2 ranks {losses} vs "
                                   f"one rank {ref_losses}")
    # the versions the TP run published (steps 2 and 4) are whole and
    # load into a one-process model
    for version in (1, 2):
        _, pub_step, params = publish.load_published(
            os.path.join(logdir, "pub"), version)
        require(pub_step == version * TP_PUBLISH_EVERY
                and {n: list(t.shape) for n, t in params.items()}
                == ref_shapes, f"the TP run's published version {version} "
                f"(step {pub_step}) is not whole")
        model = gpt.GPT(gpt.GPTConfig.by_name("small"), device="cuda")
        model.load_state_dict(params)
        del model, params
    serving = _tp_serve_check(torch, logdir, ranks, layers)
    fleet = _tp_fleet_check(torch, logdir, ranks)
    shutil.rmtree(logdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    emit({"phase": "gpt_tp_two_ranks", "world_size": TP_RANKS,
          "backend": "gloo", "device": "cuda:0 (both ranks)",
          "nvidia_smi": smi, "mesh_model": TP_RANKS, "batch": TP_BATCH,
          "seq": TRAIN_SEQ, "steps": TP_STEPS,
          "heads_a_rank": HEADS // TP_RANKS,
          "note": "collectives cross the host through gloo: the times "
                  "show that it runs, not a speed",
          "kernels": kernels, "losses_1_rank": ref_losses,
          "step_ms_1_rank_median_after_1": ref_step_ms,
          "run_wall_s_1_rank": ref_wall, "loss_rel": rel,
          "loss_rel_tol": DIST_LOSS_REL_TOL, "param_delta_rel": param_rel,
          "param_delta_rel_tol": TP_PARAM_DELTA_TOL,
          "collectives_want": {n: _tp_collectives_want(layers,
                                                       n == "overlap")
                               for n in ("plain", "overlap")},
          "serving": serving, "fleet": fleet,
          "note_serving": "generate(mesh=) and serve_gpt --mesh_model 2 on "
                          "the plain run's version 1, then the 2-replica "
                          "fleet rolling 1 -> 2; through gloo on one card: "
                          "it runs, not a speed",
          "ranks": ranks, "seconds": seconds})
    return {"flash_launches": ranks[0]["plain"]["flash_launches"],
            "serve_flash_launches": ranks[0]["generate"]["flash_launches"]}


#: every phase, in the order a full run takes them — but serve_bench,
#: serve_spec, serve_pages and serve_fleet, which serve the train phase's
#: checkpoint, run right after train
PHASES = ("device", "build", "kernels", "generate", "generate_variants",
          "generate_beam", "serve_engine", "serve_bench", "serve_spec",
          "serve_pages", "serve_fleet", "publish_swap",
          "kernels_bwd", "kernel_times_bwd",
          "train_grads", "train",
          "kernels_ce", "kernel_times_ce", "train_grads_ce", "train_ce",
          "kernels_embed", "kernel_times_embed", "widedeep_lookup",
          "train_widedeep", "resnet_batchnorm", "train_resnet",
          "resnet_bench", "bert_kernels", "train_bert", "bert_bench",
          "dist_nccl", "dist_two_ranks_one_card", "gpt_tp_two_ranks")


def kernels_line(err, timing, fwd_launches, variant_launches, err_bwd,
                 timing_bwd, train_launches, err_ce, timing_ce,
                 train_ce_launches, err_embed, timing_embed,
                 embed_launches, swap_launches, tp_launches,
                 tp_serve_launches):
    """The one JSON line listing every ported kernel: its launches on its
    main path, its error against the plain version, its times and bound.
    B1-B3 also give their launches on each path that runs them
    (``launches_by_path``: ``train``, ``publish_swap``'s trainer, rank 0
    of ``gpt_tp_two_ranks``' plain TP run, and for B1 rank 0's
    ``generate(mesh=)`` call there, ``gpt_tp_serve``)."""
    fwd_common = {"route": "cuda",
                  "source": "dtf_tpu_torch/ops/csrc/flash_fwd.cu",
                  "plain_ms": timing["plain_ms"],
                  "bound_ms": timing["bound_ms"],
                  "bound_by": timing["bound_by"],
                  "library_ms": timing["library_ms"]}
    bwd_src = {"route": "cuda",
               "source": "dtf_tpu_torch/ops/csrc/flash_bwd.cu"}
    return {"kernels": [
        {"name": "flash_fwd", **fwd_common,
         "replaces": "dtf_tpu/ops/flash_attention.py:164",
         "launches": fwd_launches, "max_abs_err": err["flash_fwd"],
         "ms": timing["flash_fwd"],
         "launches_by_path": {"train": fwd_launches,
                              "publish_swap": swap_launches["flash_fwd"],
                              "gpt_tp_two_ranks": tp_launches["flash_fwd"],
                              "gpt_tp_serve": tp_serve_launches["flash_fwd"]}},
        {"name": "flash_fwd_hfold", **fwd_common,
         "replaces": "dtf_tpu/ops/flash_attention.py:222",
         "launches": variant_launches["flash_fwd_hfold"],
         "max_abs_err": err["flash_fwd_hfold"],
         "ms": timing["flash_fwd_hfold"]},
        {"name": "flash_dq", **bwd_src,
         "replaces": "dtf_tpu/ops/flash_attention.py:363",
         "launches": train_launches["flash_dq"],
         "max_abs_err": err_bwd["flash_dq"], **timing_bwd["flash_dq"],
         "launches_by_path": {"train": train_launches["flash_dq"],
                              "publish_swap": swap_launches["flash_dq"],
                              "gpt_tp_two_ranks": tp_launches["flash_dq"]}},
        {"name": "flash_dkv", **bwd_src,
         "replaces": "dtf_tpu/ops/flash_attention.py:405",
         "launches": train_launches["flash_dkv"],
         "max_abs_err": err_bwd["flash_dkv"], **timing_bwd["flash_dkv"],
         "launches_by_path": {"train": train_launches["flash_dkv"],
                              "publish_swap": swap_launches["flash_dkv"],
                              "gpt_tp_two_ranks": tp_launches["flash_dkv"]}},
        *({"name": name, "route": "cuda",
           "source": "dtf_tpu_torch/ops/csrc/fused_ce.cu",
           "replaces": f"dtf_tpu/ops/fused_ce.py:{line}",
           "launches": train_ce_launches[name], "max_abs_err": err_ce[name],
           **timing_ce[name]}
          for name, line in (("fused_ce_fwd", 59), ("fused_ce_dx", 115),
                             ("fused_ce_dw", 134))),
        # the split pass: no TPU kernel of its own, it prepares the
        # operands of B5, B6 and B7 (for _run_bwd's two pallas_calls and
        # _run_fwd's)
        {"name": "fused_ce_split", "route": "cuda",
         "source": "dtf_tpu_torch/ops/csrc/fused_ce.cu",
         "replaces": "dtf_tpu/ops/fused_ce.py:193",
         "launches": train_ce_launches["fused_ce_split"],
         "max_abs_err": err_ce["fused_ce_split"],
         **timing_ce["fused_ce_split"]},
        # the merge of B5's vocab parts: the _finalize of _fwd_kernel,
        # which the TPU's sequential vocab axis reaches once
        {"name": "fused_ce_merge", "route": "cuda",
         "source": "dtf_tpu_torch/ops/csrc/fused_ce.cu",
         "replaces": "dtf_tpu/ops/fused_ce.py:92",
         "launches": train_ce_launches["fused_ce_merge"],
         "max_abs_err": err_ce["fused_ce_merge"],
         **timing_ce["fused_ce_merge"]},
        {"name": "embed_gather", "route": "cuda",
         "source": "dtf_tpu_torch/ops/csrc/embed_gather.cu",
         "replaces": "dtf_tpu/ops/embed_gather.py:37",
         "launches": embed_launches, "max_abs_err": err_embed,
         **{k: timing_embed[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}},
    ]}


def main(argv=None):
    import argparse

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--dist-child"]:        # a rank of dist_two_ranks_...
        sys.path.insert(0, ROOT)
        return dist_child(int(argv[1]), int(argv[2]), argv[3], argv[4])
    if argv[:1] == ["--tp-child"]:          # a rank of gpt_tp_two_ranks
        sys.path.insert(0, ROOT)
        return tp_child(int(argv[1]), int(argv[2]), argv[3], argv[4])
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma-separated subset of the phases to run (default: all; "
             "the kernels line is printed only when all run)")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}; pick from {PHASES}")
    if not os.path.isdir(os.path.join(ROOT, "dtf_tpu_torch")):
        print("chip_smoke: the dtf_tpu_torch package is not beside this "
              "file", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    # f32 references in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    T_START.append(t_start)
    device, smi = phase_device(torch)
    got = {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        got["kernels"] = phase_kernels(torch)
    if "generate" in phases:
        got["generate"] = phase_generate(torch)
    if "generate_variants" in phases:
        got["generate_variants"] = phase_variants(torch)
    if "generate_beam" in phases:
        phase_generate_beam(torch, smi)
    if "serve_engine" in phases:
        phase_serve_engine(torch, smi)
    if "kernels_bwd" in phases:
        got["kernels_bwd"] = phase_kernels_bwd(torch)
    if "kernel_times_bwd" in phases:
        got["kernel_times_bwd"] = phase_kernel_times_bwd(torch)
    if "train_grads" in phases:
        phase_train_grads(torch)
    if "train" in phases:
        got["train"] = phase_train(torch, smi)
    serving = [p for p in ("serve_bench", "serve_spec", "serve_pages",
                           "serve_fleet") if p in phases]
    if serving:
        logdir = (got["train"]["logdir"] if "train" in got
                  else _serve_logdir())
        plain_run = None
        if "serve_bench" in phases:
            plain_run = phase_serve_bench(torch, smi, logdir)
        if "serve_spec" in phases:
            phase_serve_spec(torch, smi, logdir, plain_run)
        pages = None
        if "serve_pages" in phases:
            pages = phase_serve_pages(torch, smi, logdir)
        if "serve_fleet" in phases:
            phase_serve_fleet(torch, smi, logdir, pages)
        if "train" not in got:
            shutil.rmtree(logdir, ignore_errors=True)
    if "publish_swap" in phases:
        got["publish_swap"] = phase_publish_swap(torch, smi)
    if "train" in phases:
        shutil.rmtree(got["train"]["logdir"], ignore_errors=True)
    if "kernels_ce" in phases:
        got["kernels_ce"] = phase_kernels_ce(torch)
    if "kernel_times_ce" in phases:
        got["kernel_times_ce"] = phase_kernel_times_ce(torch)
    if "train_grads_ce" in phases:
        phase_train_grads_ce(torch)
    if "train_ce" in phases:
        got["train_ce"] = phase_train_ce(torch, smi, got.get("train"))
    if "kernels_embed" in phases:
        got["kernels_embed"] = phase_kernels_embed(torch)
    if "kernel_times_embed" in phases:
        got["kernel_times_embed"] = phase_kernel_times_embed(torch)
    if "widedeep_lookup" in phases:
        phase_widedeep_lookup(torch)
    if "train_widedeep" in phases:
        phase_train_widedeep(torch, smi)
    if "resnet_batchnorm" in phases:
        phase_resnet_batchnorm(torch, smi)
    if "train_resnet" in phases:
        phase_train_resnet(torch, smi)
    if "resnet_bench" in phases:
        phase_resnet_bench(torch, smi)
    if "bert_kernels" in phases:
        phase_bert_kernels(torch, smi)
    if "train_bert" in phases:
        phase_train_bert(torch, smi)
    if "bert_bench" in phases:
        phase_bert_bench(torch, smi)
    if "dist_nccl" in phases:
        phase_dist_nccl(torch, smi)
    if "dist_two_ranks_one_card" in phases:
        got["dist_two_ranks_one_card"] = phase_dist_two_ranks_one_card(
            torch, smi)
    if "gpt_tp_two_ranks" in phases:
        got["gpt_tp_two_ranks"] = phase_gpt_tp_two_ranks(torch, smi)
    if all(p in phases for p in PHASES):
        # launches: each kernel's count on its slice's main path (the
        # train run for B1-B3; B5-B7, the merge and the split pass under
        # data parallelism, and B8 with the tables over 2 ranks: rank 0 of
        # dist_two_ranks_one_card), B4's on the variants path, the only
        # one it is on; B8's times at the main path's lookup: one rank of
        # --mesh_model 2, both tables of a 1.3M-row shard, 512 x 26 ids
        train = got["train"]["launches"]
        two = got["dist_two_ranks_one_card"]
        emit({**kernels_line(got["kernels"][0], got["kernels"][1],
                             train["flash_fwd"], got["generate_variants"],
                             got["kernels_bwd"], got["kernel_times_bwd"],
                             train, got["kernels_ce"],
                             got["kernel_times_ce"], two["fused"],
                             got["kernels_embed"],
                             got["kernel_times_embed"]["path"]["line"],
                             two["embed_gather"],
                             got["publish_swap"]["launches"],
                             got["gpt_tp_two_ranks"]["flash_launches"],
                             got["gpt_tp_two_ranks"][
                                 "serve_flash_launches"]),
              "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
