#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``analytics_zoo_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (one
``nvcc`` per source, all at once), then runs sixteen phases, each printing one
JSON line:

1. ``kernel``: ``flash_attention_fwd``'s kernels (bf16 on the tensor
   cores: ``wgmma`` fed by TMA for heads 33-64, ``mma.sync`` for the
   others up to 256; f32 on ``wgmma`` in 3xTF32 for heads up to 64,
   scalar up to 256, and the f32 source's wide kernel for head dims above
   256 in both dtypes) and ``flash_attention_bwd``'s kernel
   (f32 and bf16:
   ``wgmma`` fed by TMA for bf16 heads 33-64, ``mma.sync`` up to 32, and
   ``wgmma`` in 3xTF32 for f32 heads up to 64)
   against their plain PyTorch versions on the card: f32/bf16,
   causal/not, ragged T, Tq != Tk, head dims from 1 to 2048, BH 70000, and
   every shape the BERT-base serving and training paths give them; two
   backward calls on one input must give the same bits, in both dtypes;
   then
   their times at those shapes (forward: bf16 at BH 12, 48, 192, 768 and
   the training shape, BH 384, and causal at BH 768, f32 at BH 192 and
   96;
   backward: both dtypes at the training shape, BH 384; the
   wide kernels at D 320 and 1024) beside the bound, the plain version's
   time and PyTorch's ``F.scaled_dot_product_attention`` (forward, and its
   backward alone: a yardstick only, the port never calls it), each as
   CUDA-event time per call (``ms``) and as the card's kernel time from
   ``torch.profiler`` (``device_ms``).  An f32 row's bound is its FLOP in
   3xTF32 on the tensor cores (``bound_ms``) and at the f32 FMAs' rate
   (``fma_bound_ms``).
2. ``fused_bn``: the fused batch-norm kernels (``csrc/fused_bn.cu``, one
   persistent cooperative launch a direction, f32 and bf16, forward and
   backward with non-zero mean/var cotangents)
   against their plain versions at every distinct shape of ResNet-50's 53
   batch norms at batch 128, at C 3, 6, 7, 1000 and 8, with ragged rows, a
   channel whose mean is 1e3 times its std, and a misaligned view; the
   same input twice gives identical bits; then their times at the stem's
   shape, the one 11 of the 53 norms see (25,088 x 256) and the last
   stage's beside the bound, the plain version and
   ``F.batch_norm(training=True)`` on the same channels_last map; and the
   f32 kernels' device time at the foreign phase's 10 other maps beside
   ``F.batch_norm`` over the same ``[rows, C]`` map and the bound
   (``foreign_f32_timings``).
3. ``bert_serve``: BERT-base (``BERTClassifier``, width 768, 12 layers, 12
   heads, seq 512, ``use_flash=True``) with random weights made from a seed
   in the JAX tree layout, served through ``InferenceModel`` in bf16:
   ``warm`` then ``predict``.  The bf16 kernel's launch count over that run
   must be 12 per forward, all of the ``wgmma`` design (and the f32
   kernel's 0), and the logits must
   match the same model served in f32 with the plain attention; the model
   served in f32 with flash must launch the f32 kernel 12 times per
   forward (its ``wgmma_tf32`` design) and match too; one profiled call of
   its largest bucket gives the card's busy time and the flash share.
   ``InferenceModel`` serves from one CUDA graph per batch bucket (the
   flash launches counted from the replays); the same model served
   eagerly gives the graphs' logits (equal bits expected; at worst within
   ``TOL_SERVE_BF16``) and its p50 per bucket beside theirs.
3b. ``int8_serve``: the same BERT-base served in int8 from the graphs,
   weight-only and calibrated on 16 seeded sequences (``warm``, then
   ``predict`` at batches 1, 3, 16, 64, 70): 12 bf16 flash launches a
   forward (all ``wgmma``) and, calibrated, 25 int8 products
   (``torch._int_mm``) a forward; logits against the f32 dense model; p50
   per bucket; the parameters' bytes on the card in f32, bf16 and int8;
   ``_int_mm`` at every calibrated shape bit for bit against a float64
   product, timed beside its bound and the weight-only and bf16 GEMMs;
   ResNet-50 (``norm="batch"``, 7x7 stem) calibrated at batch 16, 224 x
   224: each of its 53 int8 convs bit for bit against float64, the
   logits against its bf16 serving.
3c. ``cluster_serve``: the same bf16 BERT-base from CUDA graphs (warmed
   before the port opens) behind the port's ``ClusterServing``
   (``batch_size=64``, two inference workers): 1, 16 and 64 closed-loop
   TCP clients under the window and the continuous scheduler, at least
   256 requests a level (p50, p99, requests/s, tokens/s, mean batch,
   queue depth); every reply against direct ``predict``, the server's
   books (requests = replies + errors + pending, no error), the C++
   queue, and 12 flash launches per device batch and preparation forward;
   one profiled c = 64 window; the workers waiting on their own replay's
   event and on the whole stream, in turns; the eager model served cold
   (the kernel's first launch on a worker thread); a hot swap to another
   version under 16 clients (no failure, replies flip, the new model
   captures nothing after its warm, peak memory); and the HTTP frontend
   over two replicas under 16 clients while one is killed and restarted
   and the other drained and restarted (no failure).
4. ``bert_train``: BERT-base ``BERTSQuAD`` fine-tuned through
   ``Estimator.from_keras(loss=squad_span_loss, optimizer="adamw",
   learning_rate=1e-4)`` from the same kind of random weights.  (a) f32,
   dropout 0, batch 8: every parameter's gradient with flash attention (f32
   forward and backward kernels) against the dense attention, and the
   per-step losses of a 3-step ``fit`` (3 distinct batches) likewise.
   (b) bf16, dropout 0.1, global batch 32, 64 fixed examples, 10 epochs
   (20 steps): the loss must fall, every step must launch the bf16 forward
   and the backward 12 times each (both on their ``wgmma`` design) and no
   f32 kernel ((a)'s fit the f32 ones: the forward and the backward on
   their ``wgmma_tf32`` designs; one more (a) step is profiled), and a
   second fit with
   the same seed must repeat the loss history; step time, tokens/s, model
   TFLOP/s and one profiled step's idle share; then ``evaluate`` and
   ``predict`` on the card.  (a)-(c) run eagerly (``cuda_graphs=False``).
   (d) the (b) fit from CUDA graphs (the Estimator's default on the card:
   one captured step a batch key, replayed) through ``fit(prefetch=2)``:
   its step losses against (b)'s (equal bits expected, at worst within
   ``TOL_TRAIN_LOSS``), 12 + 12 flash launches a step counted from the
   replays, one capture; a window of 20 steps beside the eager step's,
   tokens/s, model TFLOP/s, a profiled fit's card busy and idle share,
   peak memory; and a step that reads a value back to the host must fail
   its capture and raise, in a process of its own.
5. ``resnet_train``: bench.py's ResNet-50 recipe (space-to-depth stem,
   uint8 224 x 224 images normalised on the card, sgd at 0.1) through the
   ``Estimator`` from random weights in the JAX tree layout.  (a) f32,
   batch 8: the gradients of the model with the fused kernels and of the
   one with the plain batch norm, each against a float64 model, and the
   running statistics and the losses of a 3-step ``fit`` against each
   other.  (b) ``norm="batch"``, bf16, global batch 128, 20 steps over 256
   seeded images: the loss must fall, every step must launch each of the
   two batch-norm kernels (forward, backward) 53 times and no f32 one,
   and two deterministic fits with the same seed must give identical
   step losses; images/s,
   model TFLOP/s and one profiled step's idle share and batch norm's share
   of the card's time; then ``evaluate`` and ``predict`` (the eval batch
   norm).  (c) ``norm="nf"`` (no batch norm, no launch): images/s and idle
   share.  (d) bench.py's ``bench_resnet50`` from CUDA graphs, both
   norms: ``_multi_step(b0, 5)``'s losses against the eager step's under
   cuDNN's deterministic algorithms; the eager window of 20 steps, then
   the captured ``_multi_step(b0, 20)`` after a warm call, three times,
   53 launches of each batch-norm kernel a step (``norm="batch"``) from
   the replays, one capture, a profiled window, peak memory; the streaming
   phase (worker processes forked after the CUDA context, bench.py's
   seeded pool with random flips, ``_multi_step_data`` over 4 chunks of 5
   after one, then 8 chunks on a fresh feed) beside the resident step; a
   probe that the forked workers
   are marked as such and never touch the card.
6. ``fused_xent``: the fused softmax cross-entropy kernels
   (``csrc/fused_xent.cu``: forward, and the dl, dh and dW backward passes;
   bf16 on the tensor cores, both directions on ``wgmma``; f32's forward
   and logits on scalar FMAs, its dh and dW on ``wgmma`` in 3xTF32) against
   their plain versions (loss, lse, dh, dW, db) at the
   recipe's head shape (2,048 tokens, D 768, V 30,522, chunk 512; W f32,
   and bf16 too) and ragged N, D and V, with labels at
   0 and V-1, a row of equal logits and logits scaled 1e2; the same input
   twice gives identical bits; then their times at the recipe's shape
   beside the bound, the plain version and ``F.cross_entropy`` over the
   materialised logits (and its ``autograd.grad``).
7. ``bert_mlm_train``: bench.py's BERT vocab-head recipe (``bench_bert``'s
   encoder: width 768, 12 heads, 12 post-LN layers with
   ``remat_attention=True``, a 30,522-wide head, per-token sparse
   cross-entropy, ``adamw`` at 1e-4, global batch 32 as ``grad_accum=8`` x
   4 x 512 tokens) through ``Estimator.fit`` from random weights in the JAX
   tree layout.  (a) f32, 2 layers at full width: the plain head's and
   the fused head's gradients, and the losses of a 3-step ``grad_accum=2``
   fit, against each other.  (b) bf16 with the plain head and (c) with the
   head through ``fused_softmax_xent`` (a loss callable), 10 steps a fit,
   two fits each in turns (plain, fused, fused, plain): every fit's loss
   must fall, every (c) fit must launch the forward and each backward pass
   8 times a step (both directions on ``wgmma``; (a)'s fused fit 6 times
   in all, the forward on scalar FMAs, the backward on ``wgmma_tf32``) and
   (b) none; step time, tokens/s, model
   TFLOP/s, one
   profiled step's idle share and the head's and loss's share of the card's
   time.  (a)-(c) run eagerly.  (d) the fused recipe from CUDA graphs,
   bench.py's phases: the eager window of 5 steps on the seeded batch
   (its losses) and a warm one (its time), then ``_multi_step(batch, 20)`` once (its first 5 losses against the
   eager ones) and three times timed, 8 launches of each ``fused_xent``
   pass a step from the replays, one capture, a profiled window, peak
   memory; the streaming phase (8 worker threads, ``_multi_step_data``
   over 3 chunks of 10 after one) beside the resident step.
8. ``ncf_train``: bench.py's ``bench_ncf`` uncut (200,000 string events
   encoded and negatively sampled by ``friesian.FeatureTable``,
   ``NeuralCF(2001, 1501)``, adam 1e-3, batch 2,048): one epoch eagerly,
   three from CUDA graphs from one seeded init; the first captured
   epoch's step losses against the eager ones, one capture, step ms and
   examples/s of a warm epoch each way, a profiled epoch's card busy and
   idle share, peak memory, the feature pipeline's seconds; the captured
   loss must fall.  No kernel of ``csrc/`` lies on this path.
9. ``recsys``: bench.py's ``bench_recsys`` uncut (60,000 events, 5,000
   users, 2,000 items): a ShardedEmbedding ``NeuralCF`` one epoch on the
   sparse path under ``embedding_row_rules()`` from CUDA graphs (its first
   step allocates nothing of a table's size, no table gets ``.grad``),
   then its tail in ``InferenceModel`` behind ``CachedEmbeddingModel`` and
   ``ClusterServing`` with the fitted ``FeaturePipeline``, 4 closed-loop
   clients for 2.5 s over a zipf(1.5) trace of 20 candidates: requests/s,
   p99, the cache hit rate and the gather-bytes ratio; every reply equal
   to the eager adapter's ranking of its row.  The rows gathered must be
   exactly the unique ids of the batches the server formed, and the trace
   replayed in the server's full batches of 8 must save 4x or more
   (bench.py's bar) on a batching the host's pace cannot change.
10. ``state_plane``: checkpoints, triggers, async and delta generations,
   preemption and resume, and the saved-model loaders.  (a) bench.py's
   ``bench_checkpoint`` uncut (a ShardedEmbedding ``NeuralCF(20000,
   10000)`` with 64-wide tables, 4,096 seeded rows at batch 128, adam
   1e-2, a ``SeveralIteration(2)`` trigger): no checkpoint, sync saves
   and ``checkpoint_async=True``, each a warm and a timed epoch from CUDA
   graphs, the step timed at the ``_train_step`` call boundary (p50,
   p99, the p99 ratios, bench.py's ``clean`` flag, reported); the async
   run's generations (full and delta bytes), ``verify()``, a fresh
   estimator's restore ms and its state against the live one bit for
   bit.  (b) the ResNet-50 of resnet_train (b) (``norm="batch"``, bf16,
   sgd 0.1, batch 128, 512 seeded images) from CUDA graphs under cuDNN's
   deterministic algorithms: 2 epochs straight; 1 epoch saved at its end
   (sync, and async), then a fresh estimator's ``auto_resume`` to 2: its
   step losses, weights and running statistics equal the straight run's
   bit for bit, 53 launches of each batch-norm kernel a resumed step; a
   load into the straight run's captured estimator, then one more epoch,
   gives the same losses; a SIGTERM from a timer thread mid-fit under
   ``preemption_checkpoint=True`` (``Preempted.step`` is the saved step,
   the restored state the live one); save, snapshot stall, restore ms
   and bytes.  (c) BERT-base ``BERTSQuAD`` (bf16, dropout 0.1, adamw on
   warmup_cosine, batch 32, 64 examples) through ``fit(prefetch=2)``
   from CUDA graphs: 10 epochs straight; 5 with the async manager saving
   at each epoch's end, then a fresh estimator's ``auto_resume`` to 10:
   the 10 step losses and the weights equal the straight run's last 10
   bit for bit (the dropout masks from the restored generator), 12 + 12
   flash launches a resumed step; the snapshot's stall beside the step;
   ``save_model`` served by ``InferenceModel.load_zoo_model`` equal to
   ``load_estimator``'s logits at buckets 1 and 16; and a ``python -m
   analytics_zoo_tpu_torch.serving.server --model-dir`` child on the card
   answering 16 requests through the port's client, against direct
   ``predict`` (equal bits expected, at worst ``TOL_SERVE_BF16``).
11. ``autots``: forecasting and AutoML.  (a) Every trunk on the card
   against itself on the CPU (one numpy draw of weights, dropout 0, f32
   with TF32 off, as in the whole script): the LSTM, Seq2Seq (LSTM, GRU),
   TCN and MTNet forecasters' trunks at bench.py's shapes (batch 32,
   lookback 24, horizon 4, one feature, width 32), ``SessionRecommender``,
   ``Seq2seq`` with attention and ``Bidirectional(LSTM)`` in each merge
   mode: outputs and gradients within ``TOL_TRUNK``.  Then, with every
   kernel count set to 0 (no kernel of the port lies on this path, so
   they must stay 0): (b) bench.py's ``bench_autots`` uncut (2,000 hourly
   points, ``AutoTSEstimator(model=["lstm", "tcn"], past_seq_len=24,
   future_seq_len=4).fit(epochs=1, n_sampling=8, max_concurrent=2)``):
   trials/hour, search seconds, each trial's status, model and metric,
   ``best_config``, one capture per trial estimator, the card's allocated
   bytes before and after, and the pipeline's predictions finite; (c) an
   LSTM and a TCN forecaster, one ``fit`` epoch eagerly and one from CUDA
   graphs (cuDNN's deterministic algorithms): their step losses bit for
   bit; ms a step, the card's kernels a step and a profiled epoch's idle
   share; (d) the pipeline saved and
   loaded predicting equal bits, the Seq2Seq, MTNet and two-layer LSTM
   forecasters each an epoch from CUDA graphs, a ``TCMFForecaster`` on a
   50 x 500 panel, ``SessionRecommender``'s top-5 rows equal to a softmax
   of its ``predict``, ``Seq2seq.infer`` beside the CPU's ids; the bytes
   still allocated once it all is dropped (cuBLAS's workspaces cleared)
   at most ``AUTOTS_FREED_SLACK`` above the bytes before the search.
12. ``readers``: the input readers and the models they feed, from
   seeded files in a temp dir (a line naming any part whose package,
   PIL or pyarrow, is missing comes first; without PIL the kernel path
   runs over bench.py's raw uint8 files).  The kernel path: 3,000 JPEGs
   of 256 x 256 over 100 class directories through ``ImageSet.read`` ->
   ``ImageResize(256, 256)``, ``ImageRandomCrop(224, 224)``,
   ``ImageRandomFlip()`` -> ``to_feed(128, workers="process",
   readahead=8)`` into resnet_train's ResNet-50 (bf16, sgd 0.1) through
   ``fit(prefetch=2)`` from CUDA graphs: a capturing epoch, then two
   timed with every count set to 0 (53 launches of each batch-norm
   kernel a step from the replays, no other kernel, one capture),
   images/s and ms a step beside the same estimator's resident
   ``_multi_step`` window, the feed's io-wait, decode and h2d p50s; the
   captured fit against the eager fit over 4 batches of the same images
   and seed (one decoder) under cuDNN's deterministic algorithms, equal
   bits.  bench.py's ``bench_input_pipeline`` uncut on the port (both
   backends, stage p50s, the capping stage) and a forked decoder's first
   and second pass over one fresh shared-memory slot.  A news20-shaped
   CSV (4,096 documents of 100-1,000 Zipf-drawn words) through
   ``TextSet.read_csv`` -> tokenize -> normalize -> ``word2idx(20000)``
   -> ``shape_sequence(500)`` into ``TextClassifier`` (20 classes, tokens
   200, width 256) with the cnn, lstm and gru encoders, and WikiQA-shaped
   ids into ``KNRM`` (10 + 40, embed 300, 21 kernels; on the card against
   the CPU first): each fitted captured and eager from one init (equal
   bits), ms a step each way, and the captured fit over every row.
   ``ObjectDetector.predict_image_set`` at 300 (ResNet-18, 21 classes)
   over decoded JPEGs: raw outputs within ``TOL_SSD`` of the CPU's at the
   same weights and the same detections.  ``NNImageReader`` ->
   ``NNClassifier`` (its transform column is ``Estimator.predict``'s
   argmax), ``AnomalyDetector`` over ``unroll``ed series, the readers'
   frames and rows against pandas, and the iterator and torch feeds into
   ``fit``, ``evaluate`` (the masked tail exact) and ``predict``.
13. ``foreign``: foreign models and transfer learning, f32 (TF32 off).
   (a) A torchvision-style ResNet-50 (``TvResNet``: Bottleneck [3, 4, 6,
   3], 7x7 stem, max pool, 1,000 classes, 25,557,032 parameters; the
   card machine has no torchvision) with a seeded init and non-trivial
   running statistics goes through ``Net.load_torch`` (torch.fx) into a
   ``ForeignGraphNet``; on the card its eval forward at batch 32 of 224 x
   224 against the torch module's own, within ``FOREIGN_FWD_TOL`` of the
   largest logit.  (b) ``Estimator.from_torch`` of the same module, sgd
   0.1, batch 32 of seeded images, from CUDA graphs: 3 captured steps
   against 3 eager ones (equal bits, cuDNN deterministic), then a timed
   window of 10 replays with every count set to 0 (53 f32 ``bn_train``
   launches a step each way) and a profiled window (idle share).  (c)
   ``GraphNet`` at the last stage's output node under a new global
   pool and ``Dense(2048, 10)`` with ``frozen=["base"]``: 4 captured
   steps, the backbone equal bit for bit after them, the head moved, 53
   forward launches a step and no backward one.  (d) ``GANEstimator`` on
   DCGAN (``dcgan``: z 100, 64 x 64 x 3, ngf = ndf = 64; 3,576,704 and
   2,765,568 parameters), batch 128, adam 2e-4 (beta1 0.5), seeded
   images in [-1, 1]: ``fit`` over 4 batches; 3 D/G pairs from CUDA
   graphs against eager (equal bits); timed and profiled D and G windows
   (6 and 4 launches a step each way); ``generate(64)`` finite in [-1,
   1].
14. ``train_knobs``: the Estimator's single-device knobs.  (a) bench.py's
   MLM recipe (BERT-base, the 30,522 head through ``fused_softmax_xent``,
   ``grad_accum=8`` x 4 x 512, bf16, dropout 0) with flash attention in
   every block, under ``optimizer="lamb"`` and ``nan_policy="skip_step"``:
   a 4-step fit eagerly, then from CUDA graphs (step losses against the
   eager ones, bad_steps 0, one capture), then windows of 10 replays with
   the guard and with no policy, in turns (the guard's ms a step); the
   flash (bf16) and cross-entropy (bf16) launches of the captured runs.
   (b) resnet_train's ResNet-50 (``norm="batch"``, bf16, batch 128 x 224,
   float images) under ``optimizer="lars"`` and ``skip_step`` from CUDA
   graphs, cuDNN deterministic, with ``step.nan`` armed once at step 2 of
   4: bad_steps 1, one capture, and parameters, running statistics and
   LARS state equal, bit for bit, a run with no policy on the same batches
   without the poisoned one; windows of 10 replays of both in turns (the
   guard's ms a step); 53 launches of each batch-norm kernel a step.  (c) the
   six bf16 kernel entries of this path (flash forward and backward,
   batch norm forward and backward, cross-entropy forward and backward)
   on an input with one NaN against their plain versions: the same
   non-finite positions in every output.  (d) (b)'s model under
   ``nan_policy="rollback"`` with an every-epoch checkpoint: right after
   the rollback the state equals a fresh load of the checkpoint bit for
   bit, the fit ends finite; under ``"raise"``, ``NonFiniteLossError``
   and a flight record in ``model_dir``.  (e) ``profile=`` (a trace
   window over steps [2, 4), flops_per_sample, the bf16 peak) and
   ``log_dir``: the Chrome trace holds 53 of each batch-norm kernel a
   replayed step, ``train.compiles`` 1, ``train.mfu`` set, every summary
   tag written.
15. ``scaleout``: the Estimator over several processes, in children that
   the port's gang launcher (``core/launcher.launch``) starts from this
   script (``--scaleout-child``).  One child, a world of 1 over NCCL
   (``init_orca_context("multihost")``): (a) bert_train's BERT-base SQuAD
   (bf16, flash, batch 32) under ``sharding`` dp, fsdp, tp and 2d against
   the same Estimator made before the context: the captured fit's step
   losses (equal bits expected), 12 + 12 flash launches a step, ms a step
   of a window of replays; (b) resnet_train's ResNet-50 (bf16, batch 128)
   under ``grad_compression`` None, none, bf16 and int8: captured fits,
   53 launches of each batch-norm direction a step, none's losses equal
   None's, ``train.grad_bytes`` 4x smaller in int8, the residuals finite
   and nonzero; (c) the split batch-norm entries at an explicit one-rank
   group at every ResNet-50 map (batch 128), bf16 and f32, against the
   plain split version and the one-launch kernel, then their times (CUDA
   events; with and without the group's collectives) beside the bytes
   bound and ``nn.SyncBatchNorm``; and (d)'s one-process reference.  Then
   (d): 2 ranks on the one card (gloo over CUDA tensors) under the
   supervisor, ResNet-50 bf16 dp at a global batch of 128 (64 a rank,
   eager), batch norm across the ranks through the split entries, a
   checkpoint every epoch; rank 1 dies before its 4th step, the gang is
   restarted and resumes; the 5 step losses against the one-process run
   on the whole batch, the split entries' launches in each rank, the
   supervisor's events and its gang metrics.
16. ``devices``: the card as ``nvidia-smi`` reports it.

Each phase's seconds follow it on a line of their own (the full run).
Then the script's seconds, a ``kernels`` line (one entry per kernel and
path; ``launches_scaleout`` the scaleout phase's, and one entry a
direction and dtype for the split batch norm) and, last,
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no last line; it also exits non-zero when there is no
CUDA card.  ``--only kernel,fused_bn,...`` runs the named phases alone and
prints neither of the last two lines.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense tf32 tensor-core rate
# tf32 products per f32 product at about f32's accuracy (3xTF32: big and
# small parts of each operand, the small x small term dropped)
TF32_PASSES = 3
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
BERT_BASE = dict(vocab_size=30522, hidden_size=768, n_layers=12, n_heads=12,
                 intermediate_mult=4, max_position=512, dropout=0.0)
SEQ = 512
BF16_KERNEL = "flash_attention_fwd"      # csrc/<name>.cu
F32_KERNEL = "flash_attention_fwd_f32"
BWD_KERNEL = "flash_attention_bwd"
BN_KERNEL = "fused_bn"
BUCKETS = (1, 4, 16, 64)  # InferenceModel's default batch buckets
TIMED_SHAPE = dict(b=16, h=12, t=SEQ, d=64)  # the bucket-16 BERT-base call
TRAIN_SHAPE = dict(b=32, h=12, t=SEQ, d=64)  # a global-batch-32 train step
# head dims the JAX kernel takes that are not BERT's (it pads any D)
HEAD_DIMS = (1, 5, 8, 24, 48, 80, 96, 112, 256)
# above the tensor-core kernel's 256: the wide kernels, to 2048 (they take
# any D); the timed ones are 320 and 1024
WIDE_HEAD_DIMS = (320, 1024, 1536, 2048)
WIDE_TIMED_DIMS = (320, 1024)
WIDE_TIMED_SHAPE = dict(b=2, h=12, t=SEQ)
# the bert_train recipe (bench.py's BERT-base SQuAD: seq 512, global batch
# 32, adamw at 1e-4)
TRAIN_LR = 1e-4
TRAIN_BATCH = 32
TRAIN_EXAMPLES = 64
TRAIN_EPOCHS = 10
CHECK_BATCH = 8   # the f32 flash-vs-dense check
CHECK_STEPS = 3
LATENCY_CALLS = 50  # host-timed predict calls per bucket
# f32: same arithmetic in another summation order; bf16 out: one rounding
# of each output to bf16 on both sides, and in the kernel P rounded to bf16
# before P @ V (relative error 2^-9 per weight, averaging out over the
# keys), so a few bf16 ulps of max |out|
TOL_F32 = 2e-5
TOL_LSE = 5e-5
TOL_BF16_REL = 2e-2
# BERT logits, relative to max(1, max |ref|): f32 flash vs f32 dense differ
# only in summation order; bf16 vs f32 carries bf16 rounding through 12
# layers (about 1-2% on a 12-layer width-256 model on the CPU)
TOL_SERVE_F32 = 1e-4
TOL_SERVE_BF16 = 5e-2
# backward, dq/dk/dv each: f32 the same math in another summation order,
# relative to max(1, max |ref|); bf16 relative to max |ref|: both sides
# round their f32 result to bf16 once, so a sound pair already differs by
# one bf16 ulp, up to 2^-7 (0.78%) of max |ref|, wherever the two f32 sums
# straddle a rounding boundary; the tensor-core path also rounds P and dS
# to bf16 before their products (2^-9 per term, averaging out over the
# sums), which can make that two ulps.  2%, the forward's limit, leaves
# room for those two; a fault (a tile missed, a wrong mask or scale) moves
# a gradient by far more
TOL_BWD_F32 = 1e-4
TOL_BWD_BF16 = 2e-2
# bert_train (a), f32 flash vs f32 dense on the card: each parameter's
# gradient relative to that tensor's max |grad|, and the losses of 3
# steps relative to max(1, |dense loss|) (Adam's first step moves every
# weight by the learning rate, so a loss can come near 0; the steps take
# distinct batches, since one repeated batch is learned by heart in one
# step); the few tensors whose gradient is zero in
# exact arithmetic (the span softmax is invariant to a shift shared by
# every position: span_head.bias and the last block's ffn2.bias) are held
# to GRAD_NOISE of the largest gradient instead
TOL_TRAIN_GRAD = 1e-3
TOL_TRAIN_LOSS = 1e-4
GRAD_NOISE = 1e-5
# bert_train (b): the last epoch's mean loss at most this share of the
# first epoch's
LOSS_FALL = 0.9
# the resnet_train recipe (bench.py's ResNet-50: bf16, space-to-depth stem,
# global batch 128 of 224 x 224 uint8 images normalised on the card as
# (x - 127) / 64, sgd at lr 0.1, sparse categorical cross-entropy)
RESNET = dict(depth=50, class_num=1000, width=64, stem="space_to_depth")
IMAGE = 224
RESNET_BATCH = 128
RESNET_POOL = 256       # seeded uint8 images; 2 steps an epoch
RESNET_EPOCHS = 10      # 20 steps
RESNET_LR = 0.1
RESNET_BN = 53          # batch norms of ResNet-50
RESNET_CHECK_BATCH = 8  # resnet_train (a), f32
RESNET_CHECK_LR = 1e-5
# resnet_train (a): the fused f32 model's worst gradient error against
# float64 (of each tensor's max) at most this times the plain f32 model's,
# plus TOL_TRAIN_GRAD (two summation orders of one f32 model, emulated on
# the CPU: 0.163 vs 0.159 and 0.144 vs 0.144)
RESNET_NOISE_FACTOR = 2.0
# fused batch norm, kernel vs plain version on the same inputs.  f32: y and
# dx within 1e-4 of max(1, max |ref|): the per-channel sums differ in order,
# and a mean of 1e3 (the badly centred channel) has an f32 ulp of 6.1e-5,
# which moves x - mean by that much over a unit std; bf16: 2% of max |ref|
# (a mean that lands on the other side of a bf16 rounding step moves one
# rounding of (x - T(mean)) * T(inv), up to an ulp of a value a few times
# |y|); mean, var, dgamma, dbeta (f32 sums over up to 1.6M rows) within 1e-4
# of max(1, max |ref|)
TOL_BN_F32 = 1e-4
TOL_BN_BF16_REL = 2e-2
TOL_BN_STATS = 1e-4
BN_EDGE = [(1001, 3), (333, 6), (4097, 7), (777, 1000), (1, 8)]
XENT_KERNEL = "fused_xent"
# int8_serve: InferenceModel's int8 paths at BERT-base, weight-only and
# calibrated on INT8_CALIB seeded sequences, against the f32 dense model;
# ResNet-50 (norm="batch", its 7x7 stem conv) calibrated on
# RESNET_SERVE_BATCH seeded images, against its bf16 serving
INT8_CALIB = 16
RESNET_SERVE_BATCH = 16
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
# int8 logits vs f32 dense, of max(1, max |ref|): a 12-layer width-256
# BERT on the CPU gave 1.8e-2 (weight-only) and 2.1e-2 (calibrated), its
# bf16 serving 1.2e-2 (dev/torch_int8_cpu_error.py)
TOL_INT8_SERVE = 0.1
# ResNet-50 calibrated int8 vs its bf16 serving, of max(1, max |ref|):
# width 16 at 64 x 64 on the CPU gave 3.2e-2 (random-weight logits reach
# 8e2; the same script); the share of images whose top-1 class agrees is
# reported beside
TOL_INT8_RESNET = 0.15
# bench.py's BERT vocab-head recipe (bench_bert): a BERT-base-width post-LN
# encoder (token embedding plus a learned pos, 12 TransformerLayers with
# remat_attention=True, dense attention) under a Dense(30522) vocab head,
# per-token sparse cross-entropy, adamw at 1e-4, global batch 32 as
# grad_accum=8 micro-batches of 4 x 512 tokens
MLM = dict(vocab=30522, d_model=768, heads=12, layers=12)
MLM_MICRO = 4
MLM_ACCUM = 8
MLM_BATCH = MLM_MICRO * MLM_ACCUM
MLM_STEPS = 10           # 10 epochs over one seeded global batch
MLM_CHUNK = 512          # fused_softmax_xent's chunk: one sequence
MLM_CHECK_LAYERS = 2     # bert_mlm_train (a), f32 at full width
MLM_CHECK_ACCUM = 2      # ... global batch 8 = 2 x 4
# fused_xent kernel vs plain version on the same inputs: loss and lse 1e-5
# relative (f32 sums in another order); f32 gradients 1e-5 of each tensor's
# max; bf16: dh (rounded to bf16 once on each side) 2 bf16 ulps of its max,
# dW and db (f32 sums of bf16-rounded terms over 2048 tokens) 1e-3 of their
# max, 2 ulps where dW comes back in bf16
TOL_XENT_LOSS = 1e-5
TOL_XENT_F32 = 1e-5
TOL_XENT_BF16_DH = 2.0 ** -7
TOL_XENT_BF16_SUM = 1e-3
# ragged (N, D, V, chunk) cases beside the recipe's (2048, 768, 30522, 512)
XENT_EDGE = [(300, 40, 777, 100), (129, 13, 30, 43), (256, 64, 1000, 128),
             (512, 768, 4099, 256)]
# the (d) variants: bench.py's training phases from CUDA graphs (one
# captured step a batch key, replayed K times by Estimator._multi_step and
# _multi_step_data).  bench_bert: `steps, repeats = 50, 3` after one warm
# call, streaming `chunk_steps, n_chunks = 10, 3` from 8 worker threads
# with 4 batches of prefetch; bench_resnet50: 20 x 3, streaming 5 x 4 from
# max(4, min(16, cores)) worker processes with 4 of prefetch
MLM_RESIDENT = (20, 3)
MLM_STREAM = (10, 3)
MLM_STREAM_WORKERS = 8
RESNET_RESIDENT = (20, 3)
RESNET_STREAM = (5, 4)
STREAM_PREFETCH = 4
# steps of the eager step the captured one must repeat bit for bit (an
# eager MLM step takes 0.5-0.9 s; a ResNet step under cuDNN's
# deterministic algorithms, which the comparison needs, is slower too)
MLM_CMP_STEPS = 5
RESNET_CMP_STEPS = 5
# bench.py's acceptance for a streaming phase: within 15% of resident
STREAM_WITHIN = 0.15


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Spin kernels, then idle time, at both ends of every profiler window;
# the spin kernels' events are left out.  Late in a long run on the H100
# the profiler lost a window's first kernels (of a window of one
# fused_xent call it kept the last of 3 kernels or none, of ten calls 28
# of 30, also with 50 ms idle at either end); the same calls in a fresh
# process lost none.  What it loses is then the padding's.
_PAD_LAUNCHES = 64
_PAD_KERNEL = "spin_kernel"
_PAD_IDLE_S = 0.02


def _pad() -> None:
    for _ in range(_PAD_LAUNCHES):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(_PAD_IDLE_S)


def _profiled(fn, calls: int) -> dict:
    """The card's events of ``calls`` calls of ``fn`` under
    ``torch.profiler``, by kernel: {name: (count, device us)}."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _pad()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        _pad()
    return {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _PAD_KERNEL not in e.key}


def device_windows(fn, iters: int = 20, runs: int = 3) -> list:
    """``runs`` profiler windows of ``iters`` calls of ``fn`` each, as
    {kernel: (count, device us)}, each window whole: it recorded, of every
    kernel, ``iters`` times what one call launches (the most that any of
    three windows of one call recorded) and nothing else.  A window that
    lost events is run again, up to ``3 * runs`` windows in all, and too
    few whole ones raise."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call: dict = {}
    for _ in range(3):
        for name, (count, _) in _profiled(fn, 1).items():
            per_call[name] = max(per_call.get(name, 0), count)
    if not per_call:
        raise RuntimeError("device_windows: the profiler recorded no event "
                           "of a call")
    want = {name: count * iters for name, count in per_call.items()}
    windows, short = [], []
    for _ in range(3 * runs):
        window = _profiled(fn, iters)
        got = {name: count for name, (count, _) in window.items()}
        if got == want:
            windows.append(window)
            if len(windows) == runs:
                return windows
        else:
            short.append({n: (got.get(n, 0), want.get(n, 0))
                          for n in set(got) | set(want)
                          if got.get(n, 0) != want.get(n, 0)})
    raise RuntimeError(f"device_windows: {len(windows)} of {3 * runs} "
                       f"windows recorded {iters} calls' events whole; "
                       f"(recorded, expected) by kernel: {short}")


def device_ms(fn, iters: int = 20, runs: int = 3) -> float:
    """The card's kernel time per call of ``fn``: the device-side events of
    ``iters`` calls under ``torch.profiler``, summed and divided by
    ``iters``; the median of ``runs`` whole windows (``device_windows``).
    Unlike ``cuda_ms`` it leaves out the gaps where the card waits for the
    host to launch, which decide ``cuda_ms`` for a kernel shorter than its
    launch."""
    times = sorted(sum(us for _, us in window.values()) / 1e3 / iters
                   for window in device_windows(fn, iters, runs))
    return times[len(times) // 2]


def bound(flops: float, nbytes: float, itemsize: int,
          fma: bool = False) -> tuple:
    """(ms, "bytes"|"operations"): the larger of the operations at the
    dtype's peak rate and the bytes at the memory rate.  f32 operations at
    f32's accuracy take the tensor cores' 3xTF32 (TF32_PASSES x FLOP at
    495 TFLOP/s); ``fma`` takes the f32 FMAs' 67 TFLOP/s instead (the
    bound before the f32 designs used the tensor cores, kept beside it)."""
    if itemsize == 2:
        peak = PEAK_BF16_FLOPS
    else:
        peak = PEAK_F32_FLOPS if fma else PEAK_TF32_FLOPS / TF32_PASSES
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bwd_bound(bh: int, t: int, d: int, itemsize: int,
              fma: bool = False) -> tuple:
    """The backward's least time (not causal): 10 * BH * T^2 * D FLOP (the
    FA2 backward's five products), q, k, v, out, dout read once and dq,
    dk, dv written once."""
    return bound(10.0 * bh * t * t * d, 8.0 * bh * t * d * itemsize,
                 itemsize, fma)


def attention_bound(bh: int, tq: int, tk: int, d: int, itemsize: int,
                    causal: bool, fma: bool = False) -> tuple:
    """(ms, "bytes"|"operations"): the least time for the forward's work:
    q, k, v read once, out and lse written once; 4*tq*tk*d FLOP per head
    (the causal half when masked), at the dtype's peak rate."""
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    flops = 4.0 * bh * pairs * d
    nbytes = (2 * bh * tq * d + 2 * bh * tk * d) * itemsize + bh * tq * 4
    return bound(flops, nbytes, itemsize, fma)


def phase_kernel(fa) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"f32_out": 0.0, "lse": 0.0, "bf16_out_rel": 0.0,
             "bwd_f32_rel": 0.0, "bwd_bf16_rel": 0.0}
    # each bf16 backward check: [bh, tq, tk, d, causal, the worst of dq,
    # dk, dv relative to max |ref|]
    bwd_bf16_rel = []

    def qkv(bh, tq, tk, d, dtype):
        def r(t):
            return torch.randn(bh, t, d, device="cuda", generator=gen
                               ).to(dtype)
        return r(tq), r(tk), r(tk)

    def check(bh, tq, tk, d, dtype, causal):
        """The kernel vs its plain version on fresh inputs: out and lse
        both held to the tolerances; returns (q, k, v, out abs err)."""
        q, k, v = qkv(bh, tq, tk, d, dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        ref, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal)
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != dtype:
            raise AssertionError(f"kernel gave {tuple(out.shape)} "
                                 f"{out.dtype} at bh={bh} tq={tq} d={d}")
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if dtype == torch.float32:
            worst["f32_out"] = max(worst["f32_out"], err)
            ok = err <= TOL_F32
        else:
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            worst["bf16_out_rel"] = max(worst["bf16_out_rel"], rel)
            ok = rel <= TOL_BF16_REL
        worst["lse"] = max(worst["lse"], lse_err)
        if not ok or lse_err > TOL_LSE or not torch.isfinite(out).all():
            raise AssertionError(
                f"kernel disagrees with its plain version at bh={bh} "
                f"tq={tq} tk={tk} d={d} {dtype} causal={causal}: out err "
                f"{err}, lse err {lse_err}")
        return q, k, v, err

    dtypes = (torch.float32, torch.bfloat16)
    cases = [(3, tq, tq, d, dt, c)
             for tq in (1, 100, 512, 1000) for d in (16, 64, 128)
             for dt in dtypes for c in (False, True)]
    cases += [(3, 100, 300, 64, torch.float32, c) for c in (False, True)]
    cases += [(3, 300, 100, 64, torch.bfloat16, c) for c in (False, True)]
    # every head dim the JAX kernel takes up to 256 (odd widths, ragged T,
    # Tq != Tk), and BH past the old grid-y limit of 65535
    cases += [(2, 77, 130, d, dt, c) for d in HEAD_DIMS for dt in dtypes
              for c in (False, True)]
    cases += [(2, 300, 300, 256, dt, True) for dt in dtypes]
    # head dims above 256: the f32 source's wide kernel, both dtypes
    cases += [(2, 77, 130, d, dt, c) for d in WIDE_HEAD_DIMS for dt in dtypes
              for c in (False, True)]
    cases += [(70000, 8, 8, d, dt, c) for d in (16, 64) for dt in dtypes
              for c in (False, True)]
    # grids large enough for the bf16 kernel's 128-row tiles (d <= 64)
    cases += [(96, tq, tk, d, torch.bfloat16, c)
              for tq, tk in ((1000, 700), (700, 1000)) for d in (24, 40, 64)
              for c in (False, True)]
    # the shapes the main path gives it: BH = 12 heads x each batch bucket
    b, h, t, d = (TIMED_SHAPE[x] for x in "bhtd")
    cases += [(h * n, t, t, d, dt, False) for n in BUCKETS for dt in dtypes]
    # and the shape every training step gives it (both bert_train runs'
    # dtypes), and bert_train (a)'s f32 one at batch CHECK_BATCH
    tb, th, tt, td = (TRAIN_SHAPE[x] for x in "bhtd")
    cases += [(tb * th, tt, tt, td, dt, False) for dt in dtypes]
    cases += [(CHECK_BATCH * th, tt, tt, td, torch.float32, c)
              for c in (False, True)]
    # the bf16 wgmma design (heads 33-64): the largest bucket and the
    # training shape under `causal`, the widths the TMA box zero-fills (36
    # padded to 40 first) with ragged Tq != Tk, and one query row against
    # many keys
    cases += [(bh, t, t, d, torch.bfloat16, True) for bh in (h * 64, tb * th)]
    cases += [(3, tq, tk, dd, torch.bfloat16, c) for dd in (36, 40, 48, 56)
              for tq, tk in ((77, 130), (130, 77)) for c in (False, True)]
    cases += [(3, 1, 300, 64, torch.bfloat16, c) for c in (False, True)]
    for case in cases:
        check(*case)

    def check_bwd(bh, tq, tk, d, dtype, causal):
        """The backward kernel vs its plain version on fresh inputs (the
        forward kernel's out and lse for both): dq, dk, dv each held to
        the tolerance; returns the inputs and the worst abs error."""
        q, k, v = qkv(bh, tq, tk, d, dtype)
        g = torch.randn(bh, tq, d, device="cuda", generator=gen).to(dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal)
        ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, causal)
        torch.cuda.synchronize()
        err_abs = case_rel = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            if a.shape != b.shape or a.dtype != dtype \
                    or not torch.isfinite(a).all():
                raise AssertionError(f"backward gave {name} "
                                     f"{tuple(a.shape)} {a.dtype} at bh={bh}"
                                     f" tq={tq} tk={tk} d={d}")
            err = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            if dtype == torch.float32:
                rel, tol, key = err / max(1.0, top), TOL_BWD_F32, \
                    "bwd_f32_rel"
            else:
                rel, tol, key = err / max(top, 1e-30), TOL_BWD_BF16, \
                    "bwd_bf16_rel"
            worst[key] = max(worst[key], rel)
            case_rel = max(case_rel, rel)
            err_abs = max(err_abs, err)
            if rel > tol:
                raise AssertionError(
                    f"backward kernel disagrees with its plain version at "
                    f"bh={bh} tq={tq} tk={tk} d={d} {dtype} causal={causal}"
                    f": {name} err {err} of {top}")
        if dtype == torch.bfloat16:
            bwd_bf16_rel.append([bh, tq, tk, d, causal, case_rel])
        return q, k, v, out, g, err_abs

    bwd_cases = [(3, tq, tq, d, dt, c) for tq in (100, 512)
                 for d in (16, 64, 128) for dt in dtypes for c in (False, True)]
    bwd_cases += [(3, tq, tk, 64, dt, c) for tq, tk in ((100, 300), (300, 100))
                  for dt in dtypes for c in (False, True)]
    bwd_cases += [(2, 77, 130, d, dt, c) for d in HEAD_DIMS + WIDE_HEAD_DIMS
                  for dt in dtypes for c in (False, True)]
    bwd_cases += [(tb * th, tt, tt, td, dt, False) for dt in dtypes]
    # the wgmma design's other widths (the TMA box zero-fills columns d-63;
    # 36 is padded to 40 first), ragged Tq != Tk under `causal`, and the
    # training shape under `causal`
    bwd_cases += [(3, tq, tk, d, torch.bfloat16, c) for d in (36, 40, 56)
                  for tq, tk in ((77, 130), (130, 77)) for c in (False, True)]
    bwd_cases += [(tb * th, tt, tt, td, torch.bfloat16, True)]
    for case in bwd_cases:
        check_bwd(*case)
    # no atomics: the backward twice on one input at the training shape
    # gives the same bits, in both dtypes
    for dtype in dtypes:
        q, k, v = qkv(tb * th, tt, tt, td, dtype)
        g = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, False)
        first, second = (fa.flash_attention_bwd(q, k, v, out, lse, g, False)
                         for _ in range(2))
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"{dtype} backward: two calls on one input "
                                 f"differ")
        del q, k, v, g, out, lse, first, second

    # times at every serving shape and the training shape (bf16), the
    # largest bucket under `causal`, and in f32 the timed shape (BH 192,
    # bert_serve f32's bucket 16) and bert_train (a)'s BH 96 (both on the
    # wgmma_tf32 design), with the 3xTF32 bound and the f32 FMAs' beside;
    # each shape checked again on the inputs it is timed on.  ms, plain_ms
    # and library_ms are CUDA-event times per call, host launch included
    # (cuda_ms); the *device_ms keys are the card's kernel time per call
    # alone (device_ms), which differ where a call is shorter than its
    # launch
    timings = []
    for bh, dtype, causal in [(h * n, torch.bfloat16, False)
                              for n in BUCKETS] + [
            (tb * th, torch.bfloat16, False), (h * 64, torch.bfloat16, True),
            (b * h, torch.float32, False),
            (CHECK_BATCH * h, torch.float32, False)]:
        q, k, v, err = check(bh, t, t, d, dtype, causal)
        q4, k4, v4 = (x.view(bh // h, h, t, d) for x in (q, k, v))

        def kernel():
            return fa.flash_attention_fwd(q, k, v, causal)

        def plain():
            return fa.flash_attention_fwd_reference(q, k, v, causal)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal)

        ms, plain_ms, library_ms = (cuda_ms(f)
                                    for f in (kernel, plain, library))
        dev_ms, plain_dev_ms, library_dev_ms = (
            device_ms(f) for f in (kernel, plain, library))
        bound_ms, bound_by = attention_bound(bh, t, t, d, q.element_size(),
                                             causal)
        fma_ms = attention_bound(bh, t, t, d, 4, causal, fma=True)[0] \
            if dtype == torch.float32 else None
        pairs = t * (t + 1) / 2 if causal else t * t
        timings.append({
            "kernel": fa.fwd_kernel(dtype, d)[0],
            "design": fa.fwd_design(dtype, d), "bh": bh, "t": t, "d": d,
            "dtype": str(dtype).replace("torch.", ""), "causal": causal,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "device_ms": dev_ms,
            "plain_device_ms": plain_dev_ms,
            "library_device_ms": library_dev_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "fma_bound_ms": fma_ms,
            "device_share_of_bound": bound_ms / dev_ms,
            "device_tflop_per_s": 4.0 * bh * pairs * d / dev_ms / 1e9})

    # the backward at the training shape, both dtypes, checked again on the
    # inputs it is timed on; the yardstick is SDPA's backward alone
    bwd_timings = []
    for dtype in dtypes:
        bh = tb * th
        q, k, v, out, g, err = check_bwd(bh, tt, tt, td, dtype, False)
        lse = fa.flash_attention_fwd(q, k, v, False)[1]
        q4, k4, v4 = (x.view(tb, th, tt, td).detach().requires_grad_()
                      for x in (q, k, v))
        out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
        g4 = g.view(tb, th, tt, td)

        def kernel():
            return fa.flash_attention_bwd(q, k, v, out, lse, g, False)

        def plain():
            return fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                    False)

        def library():
            return torch.autograd.grad(out4, (q4, k4, v4), g4,
                                       retain_graph=True)

        ms, plain_ms, library_ms = (cuda_ms(f, iters=10)
                                    for f in (kernel, plain, library))
        dev_ms, plain_dev_ms, library_dev_ms = (
            device_ms(f, iters=10) for f in (kernel, plain, library))
        bound_ms, bound_by = bwd_bound(bh, tt, td, q.element_size())
        fma_ms = bwd_bound(bh, tt, td, 4, fma=True)[0] \
            if dtype == torch.float32 else None
        bwd_timings.append({
            "kernel": BWD_KERNEL, "design": fa.bwd_design(dtype, td),
            "bh": bh, "t": tt, "d": td,
            "dtype": str(dtype).replace("torch.", ""), "causal": False,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "device_ms": dev_ms,
            "plain_device_ms": plain_dev_ms,
            "library_device_ms": library_dev_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "fma_bound_ms": fma_ms,
            "device_share_of_bound": bound_ms / dev_ms,
            "device_tflop_per_s": 10.0 * bh * tt * tt * td / dev_ms / 1e9})
        del q4, k4, v4, out4
    # the bf16 designs no main path takes at the training shape's BH 384 x
    # T 512: the forward's and the backward's mma.sync at D 32, the
    # forward's mma.sync and the backward's scalar kernel at D 128; each
    # checked on the inputs it is timed on, beside its bound, its plain
    # version and SDPA's (forward, or its backward alone)
    other_timings = []
    for od in (32, 128):
        bh = tb * th
        q, k, v, out, g, err = check_bwd(bh, tt, tt, od, torch.bfloat16,
                                         False)
        fwd_err = check(bh, tt, tt, od, torch.bfloat16, False)[3]
        lse = fa.flash_attention_fwd(q, k, v, False)[1]
        q4, k4, v4 = (x.view(tb, th, tt, od).detach().requires_grad_()
                      for x in (q, k, v))
        out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
        g4 = g.view(tb, th, tt, od)
        for direction, kernel, plain, library, bnd, e in (
                ("fwd", lambda: fa.flash_attention_fwd(q, k, v, False),
                 lambda: fa.flash_attention_fwd_reference(q, k, v, False),
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     q4.detach(), k4.detach(), v4.detach()),
                 attention_bound(bh, tt, tt, od, 2, False), fwd_err),
                ("bwd",
                 lambda: fa.flash_attention_bwd(q, k, v, out, lse, g, False),
                 lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse,
                                                          g, False),
                 lambda: torch.autograd.grad(out4, (q4, k4, v4), g4,
                                             retain_graph=True),
                 bwd_bound(bh, tt, od, 2), err)):
            other_timings.append({
                "kernel": fa.fwd_kernel(torch.bfloat16, od)[0]
                if direction == "fwd" else BWD_KERNEL,
                "direction": direction,
                "design": fa.fwd_design(torch.bfloat16, od)
                if direction == "fwd" else fa.bwd_design(torch.bfloat16, od),
                "bh": bh, "t": tt, "d": od, "dtype": "bfloat16",
                "max_abs_err": e, "ms": cuda_ms(kernel, iters=10),
                "plain_ms": cuda_ms(plain, iters=5),
                "library_ms": cuda_ms(library, iters=10),
                "device_ms": device_ms(kernel, iters=10),
                "plain_device_ms": device_ms(plain, iters=5),
                "library_device_ms": device_ms(library, iters=10),
                "bound_ms": bnd[0], "bound_by": bnd[1]})
        del q4, k4, v4, out4
    # the f32 forward's scalar design (heads 65-256; no main path has them)
    # at BH 384 x T 512, D 128, checked on the inputs it is timed on,
    # beside its 3xTF32 and FMA bounds, its plain version and SDPA
    bh, od = tb * th, 128
    q, k, v, err = check(bh, tt, tt, od, torch.float32, False)
    q4, k4, v4 = (x.view(tb, th, tt, od) for x in (q, k, v))
    bnd = attention_bound(bh, tt, tt, od, 4, False)
    kernel, plain, library = (
        lambda: fa.flash_attention_fwd(q, k, v, False),
        lambda: fa.flash_attention_fwd_reference(q, k, v, False),
        lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4))
    other_timings.append({
        "kernel": fa.fwd_kernel(torch.float32, od)[0], "direction": "fwd",
        "design": fa.fwd_design(torch.float32, od), "bh": bh, "t": tt,
        "d": od, "dtype": "float32", "max_abs_err": err,
        "ms": cuda_ms(kernel, iters=10), "plain_ms": cuda_ms(plain, iters=5),
        "library_ms": cuda_ms(library, iters=10),
        "device_ms": device_ms(kernel, iters=10),
        "plain_device_ms": device_ms(plain, iters=5),
        "library_device_ms": device_ms(library, iters=10),
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "fma_bound_ms": attention_bound(bh, tt, tt, od, 4, False,
                                        fma=True)[0]})
    del q, k, v, q4, k4, v4
    # the wide kernels (head dims above 256) at D 320 and 1024, both
    # directions and dtypes; SDPA's yardstick is whichever of its
    # memory-efficient and math backends takes the head dim
    wide_timings = []
    wb, wh, wt = (WIDE_TIMED_SHAPE[x] for x in "bht")
    for d in WIDE_TIMED_DIMS:
        for dtype in dtypes:
            bh = wb * wh
            q, k, v, out, g, err = check_bwd(bh, wt, wt, d, dtype, False)
            lse = fa.flash_attention_fwd(q, k, v, False)[1]
            q4, k4, v4 = (x.view(wb, wh, wt, d).detach().requires_grad_()
                          for x in (q, k, v))
            backend, sdpa_out = sdpa_any_head_dim(q4, k4, v4)
            g4 = g.view(wb, wh, wt, d)
            fwd_err = (fa.flash_attention_fwd(q, k, v, False)[0].float()
                       - fa.flash_attention_fwd_reference(q, k, v)[0].float()
                       ).abs().max().item()
            for direction, kernel, plain, library, bnd, fma_bnd in (
                    ("fwd",
                     lambda: fa.flash_attention_fwd(q, k, v, False),
                     lambda: fa.flash_attention_fwd_reference(q, k, v),
                     lambda: sdpa_any_head_dim(q4.detach(), k4.detach(),
                                               v4.detach(), backend),
                     attention_bound(bh, wt, wt, d, q.element_size(),
                                     False),
                     attention_bound(bh, wt, wt, d, 4, False, fma=True)),
                    ("bwd",
                     lambda: fa.flash_attention_bwd(q, k, v, out, lse, g,
                                                    False),
                     lambda: fa.flash_attention_bwd_reference(
                         q, k, v, out, lse, g, False),
                     lambda: torch.autograd.grad(sdpa_out, (q4, k4, v4), g4,
                                                 retain_graph=True),
                     bwd_bound(bh, wt, d, q.element_size()),
                     bwd_bound(bh, wt, d, 4, fma=True))):
                ms, plain_ms, library_ms = (cuda_ms(f, iters=5)
                                            for f in (kernel, plain, library))
                dev_ms, plain_dev_ms, library_dev_ms = (
                    device_ms(f, iters=5) for f in (kernel, plain, library))
                wide_timings.append({
                    "kernel": fa.fwd_kernel(dtype, d)[0] if direction == "fwd"
                    else BWD_KERNEL, "direction": direction, "bh": bh,
                    "t": wt, "d": d, "dtype": str(dtype).replace("torch.", ""),
                    "max_abs_err": fwd_err if direction == "fwd" else err,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "library": f"scaled_dot_product_attention ({backend})",
                    "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
                    "library_device_ms": library_dev_ms,
                    "bound_ms": bnd[0], "bound_by": bnd[1],
                    "fma_bound_ms": fma_bnd[0] if dtype == torch.float32
                    else None})
            del q4, k4, v4, sdpa_out
    res = {"phase": "kernel", "cases": len(cases),
           "bwd_cases": len(bwd_cases), "worst": worst,
           "tolerances": {"f32_out_abs": TOL_F32, "lse_abs": TOL_LSE,
                          "bf16_out_rel_to_max": TOL_BF16_REL,
                          "bwd_f32_rel_to_max1": TOL_BWD_F32,
                          "bwd_bf16_rel_to_max": TOL_BWD_BF16},
           "timed_shape": dict(TIMED_SHAPE, causal=False),
           "bwd_bf16_rel_by_case": bwd_bf16_rel,
           "timings": timings, "bwd_timings": bwd_timings,
           "other_design_timings": other_timings,
           "wide_timings": wide_timings}
    emit(res)
    return res


def sdpa_any_head_dim(q4, k4, v4, backend=None):
    """``F.scaled_dot_product_attention`` over ``[B, H, T, D]`` on its
    memory-efficient backend, or its math backend where that one refuses
    the head dim; returns (backend name, output), or the output alone when
    ``backend`` is given."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    names = {"efficient": SDPBackend.EFFICIENT_ATTENTION,
             "math": SDPBackend.MATH}
    for name in ([backend] if backend else list(names)):
        try:
            with sdpa_kernel([names[name]]):
                out = torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4)
        except RuntimeError:
            if backend:
                raise
            continue
        return out if backend else (name, out)
    raise RuntimeError("no SDPA backend takes this head dim")


def random_bert_variables(model: torch.nn.Module, seed: int) -> dict:
    """Random weights made with numpy, laid out as the JAX package's
    ``{"params", "state"}`` tree, drawn from the JAX initializers'
    distributions (glorot-uniform kernels, normal(0.05) embeddings, unit
    LayerNorm gains, zero biases)."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    for key, p in model.state_dict().items():
        *path, leaf = key.split(".")
        shape = tuple(p.shape)
        if leaf in ("kernel", "wq", "wk", "wv", "wo"):
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            arr = rng.uniform(-lim, lim, shape)
        elif leaf in ("embeddings", "pos_embed", "pos"):
            arr = rng.normal(0.0, 0.05, shape)
        elif leaf == "gamma":
            arr = np.ones(shape)
        else:
            arr = np.zeros(shape)
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": params, "state": {}}


def bert_flops_per_token() -> float:
    """Forward FLOP per token of the BERT encoder at SEQ: the dense
    projections (4 h^2 attention + 8 h^2 FFN per layer, 2 FLOP per MAC) and
    the two attention products (4 * SEQ * h per layer)."""
    h, n = BERT_BASE["hidden_size"], BERT_BASE["n_layers"]
    mult = BERT_BASE["intermediate_mult"]
    return n * (2.0 * (4 + 2 * mult) * h * h + 4.0 * SEQ * h)


def profile_call(fn, shares: dict) -> dict:
    """One call of ``fn`` (synchronised) under ``torch.profiler``: the
    host's wall time, the card's kernel time (busy) and idle share, the
    share of the kernel time taken by the kernels whose names contain any
    of ``shares[name]`` (as ``<name>_share_of_busy``), and the kernels that
    take the most."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in events
               if e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms in kernels)
    copies = sum(e.count for e in events
                 if e.key.lower().startswith(("memcpy", "memset")))
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
           "device_ops": {"kernels": sum(e.count for e in events) - copies,
                          "copies_and_memsets": copies}}
    for name, keys in shares.items():
        ms = sum(t for k, t in kernels if any(n in k for n in keys))
        res[f"{name}_share_of_busy"] = ms / busy_ms if busy_ms else None
    top = sorted(kernels, key=lambda kv: -kv[1])[:8]
    res["top"] = [[k[:90], ms] for k, ms in top]
    return res


def reset_counts(fa) -> None:
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    for name in fa.KERNEL_LAUNCHES:
        fa.KERNEL_LAUNCHES[name] = 0
    for counts in (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_designs(counts: dict, what: str, design: str, runs: int) -> dict:
    """Launches by design since ``reset_counts`` (``counts``: the
    forward's or the backward's): all of them ``design``'s, once per
    encoder layer of each of ``runs``."""
    want = dict.fromkeys(counts, 0)
    want[design] = BERT_BASE["n_layers"] * runs
    if counts != want:
        raise AssertionError(f"{what}: launches by design {counts}; want "
                             f"{want}")
    return dict(counts)


def read_fwd_designs(fa, what: str, design: str, runs: int) -> dict:
    return read_designs(fa.FWD_LAUNCHES, f"{what} forward", design, runs)


def read_bwd_designs(fa, what: str, design: str, runs: int) -> dict:
    return read_designs(fa.BWD_LAUNCHES, f"{what} backward", design, runs)


def read_counts(fa, what: str, **runs: int) -> dict:
    """The launch counts since ``reset_counts``: each kernel named in
    ``runs`` (by source) once per encoder layer of each of its runs, no
    other kernel at all."""
    counts = dict(fa.KERNEL_LAUNCHES)
    want = {name: BERT_BASE["n_layers"] * runs.get(name, 0)
            for name in counts}
    fwd = want[BF16_KERNEL] + want[F32_KERNEL]
    if counts != want or fa.flash_attention_fwd.launches != fwd \
            or fa.flash_attention_bwd.launches != want[BWD_KERNEL]:
        raise AssertionError(f"{what}: kernel launches {counts}; want {want}"
                             f" ({BERT_BASE['n_layers']} layers)")
    return counts


def served_latency(im, x, seq: int = 0) -> dict:
    """Host-clock ``predict`` latency of ``im`` on ``x`` (LATENCY_CALLS
    calls, each ending in the device -> host copy): p50, p90, min, rows/s
    and, for BERT-base rows of ``seq`` tokens, tokens/s and model TFLOP/s
    at the p50."""
    times = []
    for _ in range(LATENCY_CALLS):
        t0 = time.perf_counter()
        im.predict(x)
        times.append((time.perf_counter() - t0) * 1e3)
    p50, b = float(np.median(times)), len(x)
    res = {"p50_ms": p50, "min_ms": min(times), "calls": LATENCY_CALLS,
           "p90_ms": float(np.percentile(times, 90)),
           "rows_per_s": b / (p50 / 1e3)}
    if seq:
        res["tokens_per_s"] = b * seq / (p50 / 1e3)
        res["model_tflop_per_s"] = b * seq * bert_flops_per_token() / p50 / 1e9
    return res


def phase_bert_serve(fa) -> dict:
    from analytics_zoo_tpu_torch.models import BERTClassifier
    from analytics_zoo_tpu_torch.serving import InferenceModel

    def served(use_flash, dtype=None, cuda_graphs=True):
        model = BERTClassifier(2, use_flash=use_flash, **BERT_BASE)
        return InferenceModel(device="cuda", cuda_graphs=cuda_graphs).load(
            model, variables, dtype=dtype)

    t0 = time.perf_counter()
    variables = random_bert_variables(
        BERTClassifier(2, use_flash=True, **BERT_BASE), SEED)
    im = served(True, torch.bfloat16)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 1)
    batches = {n: rng.integers(0, BERT_BASE["vocab_size"], (n, SEQ)
                               ).astype(np.int32) for n in (1, 3, 16, 64, 70)}
    top = im.batch_buckets[-1]

    # the main path: warm, then predict (padding, trimming, the largest
    # bucket and chunking beyond it); the kernels' counts read right after
    reset_counts(fa)
    t0 = time.perf_counter()
    im.warm([(SEQ,)], dtype=np.int32)
    warm_s = time.perf_counter() - t0
    outs = {n: im.predict(x) for n, x in batches.items()}
    forwards = im.compile_count + sum(-(-n // top) for n in batches)
    launches = read_counts(fa, "bert_serve bf16",
                           **{BF16_KERNEL: forwards})
    fwd_designs = read_fwd_designs(fa, "bert_serve bf16", "wgmma", forwards)

    # the same model served eagerly (no CUDA graphs): its logits against
    # the graphs' (the same kernels on the same inputs: equal bits
    # expected) and its latency beside theirs, in turns
    eager = served(True, torch.bfloat16, cuda_graphs=False)
    eager.warm([(SEQ,)], dtype=np.int32)
    eager_outs = {n: eager.predict(x) for n, x in batches.items()}
    graph_vs_eager = max(
        float(np.abs(outs[n] - y).max()) / max(1.0, float(np.abs(y).max()))
        for n, y in eager_outs.items())
    if graph_vs_eager > TOL_SERVE_BF16:
        raise AssertionError(f"bert_serve: graph and eager logits differ by "
                             f"{graph_vs_eager} > {TOL_SERVE_BF16}")
    latency = {}
    for b in im.batch_buckets:
        latency[str(b)] = served_latency(im, batches[64][:b], SEQ)
        latency[str(b)]["eager_p50_ms"] = served_latency(
            eager, batches[64][:b], SEQ)["p50_ms"]
    breakdown = {str(b): profile_call(
        lambda: im.predict(batches[64][:b]), {"flash": ("flash_fwd_",)})
        for b in (1, 64)}
    eager_breakdown = {str(b): profile_call(
        lambda: eager.predict(batches[64][:b]), {"flash": ("flash_fwd_",)})
        for b in (1, 64)}
    del im, eager

    errors = {}
    ref_im = served(False)
    refs = {n: ref_im.predict(x) for n, x in batches.items()}
    del ref_im
    # the f32 flash path, its kernel counted over this run alone
    f32_im = served(True)
    reset_counts(fa)
    f32_outs = {n: f32_im.predict(x) for n, x in batches.items()}
    # each key's first predict runs one eager forward before its capture
    f32_forwards = sum(-(-n // f32_im.batch_buckets[-1]) for n in batches) \
        + f32_im.compile_count
    f32_launches = read_counts(fa, "bert_serve f32",
                               **{F32_KERNEL: f32_forwards})
    f32_fwd_designs = read_fwd_designs(fa, "bert_serve f32", "wgmma_tf32",
                                       f32_forwards)
    f32_breakdown = profile_call(lambda: f32_im.predict(batches[64]), {
        "flash": ("flash_fwd_", "split_tf32")})
    del f32_im
    for name, got, tol in (("bf16_flash_vs_f32_dense", outs, TOL_SERVE_BF16),
                           ("f32_flash_vs_f32_dense", f32_outs,
                            TOL_SERVE_F32)):
        worst = 0.0
        for n, ref in refs.items():
            y = got[n]
            if y.shape != (n, 2) or not np.isfinite(y).all():
                raise AssertionError(f"{name}: batch {n} gave shape "
                                     f"{y.shape} or non-finite logits")
            scale = max(1.0, float(np.abs(ref).max()))
            worst = max(worst, float(np.abs(y - ref).max()) / scale)
        if worst > tol:
            raise AssertionError(f"{name}: logits differ by {worst} of "
                                 f"max(1, |ref|) > {tol}")
        errors[name] = {"max_err_rel_to_max": worst, "tol": tol}
    res = {"phase": "bert_serve", "config": BERT_BASE, "seq": SEQ,
           "dtype": "bfloat16", "batches": sorted(batches),
           "forwards": forwards, "flash_launches": launches,
           "fwd_launches_by_design": fwd_designs,
           "f32_forwards": f32_forwards, "f32_flash_launches": f32_launches,
           "f32_fwd_launches_by_design": f32_fwd_designs,
           "f32_breakdown_64": f32_breakdown, "setup_s": setup_s,
           "warm_s": warm_s, "cuda_graphs": True, "latency": latency,
           "breakdown": breakdown, "eager_breakdown": eager_breakdown,
           "graph_vs_eager_max_err_rel_to_max": graph_vs_eager,
           "errors": errors}
    emit(res)
    return res


# ClusterServing over the port (cluster_serve): BERT-base bf16 from CUDA
# graphs behind the port's server, its scheduler, registry, router and
# HTTP frontend
CS_BATCH = 64            # ClusterServing(batch_size=)
CS_WORKERS = 2           # ClusterServing(inference_workers=)
CS_LEVELS = (1, 16, 64)  # closed-loop TCP clients
CS_MIN_REQUESTS = 256    # per level (and 8 a client at least)
CS_POOL = 512            # distinct seeded rows the requests cycle through
CS_LOAD_CLIENTS = 16     # during the hot swap and the replica kill
CS_PHASE_REPLIES = 64    # replies each stage of those runs waits for


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def stream_wide_call(self, xp):
    """``_Graph.__call__`` with the wait it had before the per-replay
    event: the caller waits for the whole serving stream (every replay any
    thread queued there), not for its own replay's event.  Timed beside
    the event wait."""
    from analytics_zoo_tpu_torch.ops import _launches
    with self.lock:
        self.staging.numpy()[...] = xp
        with torch.cuda.stream(self.stream):
            self.static_in.copy_(self.staging, non_blocking=True)
            self.graph.replay()
            self.host_out.copy_(self.static_out, non_blocking=True)
        self.stream.synchronize()
        _launches.replay(self.launches)
        return self.host_out.numpy().copy()


def cluster_level(srv, pool, clients: int, requests: int) -> dict:
    """``clients`` closed-loop clients, each over its own
    ``InputQueue``/``OutputQueue`` on loopback, send one row each and wait
    for its reply, ``requests`` in all (request k sends pool row k);
    connections are made before the clock starts.  Returns the per-request
    latencies (ms), the wall time and the (row, reply) pairs."""
    from analytics_zoo_tpu_torch.serving import InputQueue, OutputQueue
    per = -(-requests // clients)
    barrier = threading.Barrier(clients + 1)
    results, errors = [[] for _ in range(clients)], []

    def run(c):
        iq = InputQueue(srv.host, srv.port)
        oq = OutputQueue(input_queue=iq)
        try:
            barrier.wait()
            for j in range(per):
                row = (c * per + j) % len(pool)
                t0 = time.perf_counter()
                out = oq.query(iq.enqueue(f"c{c}", t=pool[row]),
                               timeout=120.0)
                ms = (time.perf_counter() - t0) * 1e3
                if out is None:
                    errors.append(f"client {c}: timeout")
                    return
                results[c].append((row, out, ms))
        except Exception as e:  # noqa: BLE001 - recorded, raised below
            errors.append(f"client {c}: {type(e).__name__}: {e}")
        finally:
            iq.close()

    threads = [threading.Thread(target=run, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"cluster_serve: {clients} clients: "
                             f"{errors[:3] or 'a client hung'}")
    done = [r for rs in results for r in rs]
    return {"latency_ms": [r[2] for r in done], "wall_s": wall,
            "replies": [(r[0], r[1]) for r in done]}


def _level_in_a_process(host, port, pool, clients, requests, out) -> None:
    """``cluster_level`` from a process of its own (spawned): the clients
    then share no interpreter lock with the server."""
    from types import SimpleNamespace
    run = cluster_level(SimpleNamespace(host=host, port=port), pool,
                        clients, requests)
    out.put(run)


def cluster_level_in_a_process(srv, pool, clients: int,
                               requests: int) -> dict:
    """``cluster_level`` with the clients in a spawned process."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_level_in_a_process,
                       args=(srv.host, srv.port, pool, clients, requests,
                             out))
    proc.start()
    try:
        run = out.get(timeout=600)
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
    return run


def stage_p50s(srv) -> dict:
    """The server's own p50 of each pipeline stage (ms): queue wait,
    assembly, the model call, the reply write."""
    from analytics_zoo_tpu_torch.core.metrics import quantile_from_snapshot
    snap = srv._metrics.snapshot()
    return {stage: quantile_from_snapshot(snap[f"server.{stage}_ms"], 0.5)
            for stage in ("queue_wait", "assembly", "inference", "reply")}


def latency_summary(lat_ms, wall_s) -> dict:
    n = len(lat_ms)
    return {"requests": n, "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "requests_per_s": n / wall_s,
            "tokens_per_s": n * SEQ / wall_s, "wall_s": wall_s}


def check_served(st: dict, what: str, requests: int) -> None:
    """The server's books: every request answered, none failed."""
    if st["requests"] != st["replies"] + st["errors"] + st["pending"] \
            or st["errors"] or st["pending"] or st["requests"] != requests:
        raise AssertionError(f"{what}: stats {st}; want {requests} "
                             "requests, all replied")


def check_replies(replies, refs: dict, what: str) -> dict:
    """Each reply against its row's logits from each reference (direct
    ``predict``): it must match exactly one, within TOL_SERVE_BF16 of
    max(1, |ref|) (a served row's batch differs from the reference's).
    Returns how many matched each and the worst error."""
    hits = dict.fromkeys(refs, 0)
    worst = 0.0
    for row, out in replies:
        errs = {name: float(np.abs(out - ref[row]).max())
                / max(1.0, float(np.abs(ref[row]).max()))
                for name, ref in refs.items()}
        match = [name for name, e in errs.items() if e <= TOL_SERVE_BF16]
        if out.shape != (2,) or not np.isfinite(out).all() \
                or len(match) != 1:
            raise AssertionError(f"{what}: row {row} gave {out}, errors "
                                 f"{errs} (tolerance {TOL_SERVE_BF16})")
        hits[match[0]] += 1
        worst = max(worst, errs[match[0]])
    return {"matched": hits, "max_err_rel_to_max": worst,
            "tol": TOL_SERVE_BF16}


def phase_cluster_serve(fa) -> dict:
    import urllib.request
    from analytics_zoo_tpu_torch.core.metrics import MetricsRegistry
    from analytics_zoo_tpu_torch.models import BERTClassifier
    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 HTTPFrontend,
                                                 InferenceModel,
                                                 ReplicaSet, RetryPolicy)
    from analytics_zoo_tpu_torch.serving import inference_model as im_lib

    card = nvidia_smi()

    def served(variables, cuda_graphs=True):
        return InferenceModel(device="cuda", cuda_graphs=cuda_graphs).load(
            BERTClassifier(2, use_flash=True, **BERT_BASE), variables,
            dtype=torch.bfloat16)

    def server(model, scheduler="window", port=0):
        return ClusterServing(model, port=port, batch_size=CS_BATCH,
                              inference_workers=CS_WORKERS,
                              scheduler=scheduler,
                              metrics=MetricsRegistry()).start()

    def refs_of(model):
        return np.concatenate([model.predict(pool[i:i + CS_BATCH])
                               for i in range(0, CS_POOL, CS_BATCH)])

    t0 = time.perf_counter()
    variables = random_bert_variables(
        BERTClassifier(2, use_flash=True, **BERT_BASE), SEED)
    pool = np.random.default_rng(SEED + 2).integers(
        0, BERT_BASE["vocab_size"], (CS_POOL, SEQ)).astype(np.int32)
    setup_s = time.perf_counter() - t0

    # the main path: the model warmed (every bucket's graph captured)
    # before the port opens, then each level under each scheduler, each
    # on a fresh server over the same model; the counts read right after
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    im = served(variables)
    im.warm([(SEQ,)], dtype=np.int32)
    levels, replies, batches, native = {}, [], 0, set()
    for scheduler in ("window", "continuous"):
        for c in CS_LEVELS:
            n = max(CS_MIN_REQUESTS, 8 * c)
            srv = server(im, scheduler)
            try:
                native.add(srv._queue.is_native)
                run = cluster_level(srv, pool, c, n)
            finally:
                srv.stop()
            st = srv.stats()
            stages = stage_p50s(srv)
            check_served(st, f"cluster_serve {scheduler} c={c}", n)
            batches += st["batches"]
            replies += run["replies"]
            levels[f"{scheduler}_c{c}"] = dict(
                latency_summary(run["latency_ms"], run["wall_s"]),
                clients=c, batches=st["batches"],
                mean_batch_size=st["mean_batch_size"],
                queue_depth_max=st["queue_depth_max"],
                server_stage_p50_ms=stages)
    forwards = im.compile_count + batches
    launches = read_counts(fa, "cluster_serve", **{BF16_KERNEL: forwards})
    fwd_designs = read_fwd_designs(fa, "cluster_serve", "wgmma", forwards)
    peak_main = torch.cuda.max_memory_allocated()
    if native != {True}:
        raise AssertionError("cluster_serve: the server's queue is not the "
                             "C++ one (NativeQueue.is_native)")
    compiled = im.compile_count
    ref = refs_of(im)
    if im.compile_count != compiled:
        raise AssertionError("cluster_serve: a reference predict captured")
    agree = check_replies(replies, {"direct": ref}, "cluster_serve")

    # one profiled window of the c = 64 level: the card's busy time
    srv = server(im)
    try:
        busy = profile_call(
            lambda: cluster_level(srv, pool, CS_LEVELS[-1], CS_MIN_REQUESTS),
            {"flash": ("flash_fwd_",)})
    finally:
        srv.stop()

    # the c = 64 level with the clients in a process of their own: how
    # much of the time the clients' threads took from the server's
    c = CS_LEVELS[-1]
    srv = server(im)
    try:
        run = cluster_level_in_a_process(srv, pool, c, max(
            CS_MIN_REQUESTS, 8 * c))
    finally:
        srv.stop()
    st = srv.stats()
    check_served(st, "cluster_serve clients in a process", len(
        run["replies"]))
    check_replies(run["replies"], {"direct": ref}, "clients in a process")
    levels[f"window_c{c}_clients_in_a_process"] = dict(
        latency_summary(run["latency_ms"], run["wall_s"]), clients=c,
        batches=st["batches"], mean_batch_size=st["mean_batch_size"],
        queue_depth_max=st["queue_depth_max"],
        server_stage_p50_ms=stage_p50s(srv))

    # two workers, waiting on their own replay's event and on the whole
    # serving stream (the wait before the event), in turns at c = 64
    waits = {"event": [], "stream": []}
    event_call = im_lib._Graph.__call__
    for mode in ("event", "stream", "stream", "event"):
        im_lib._Graph.__call__ = stream_wide_call if mode == "stream" \
            else event_call
        srv = server(im)
        try:
            run = cluster_level(srv, pool, CS_LEVELS[-1], CS_MIN_REQUESTS)
        finally:
            srv.stop()
            im_lib._Graph.__call__ = event_call
        check_replies(run["replies"], {"direct": ref}, f"{mode} wait")
        waits[mode].append(float(np.percentile(run["latency_ms"], 50)))

    # the eager yardstick through the server, unwarmed: the flash kernel's
    # first launch (its TMA encoding) happens on a worker thread
    eager = served(variables, cuda_graphs=False)
    reset_counts(fa)
    srv = server(eager)
    try:
        run = cluster_level(srv, pool, CS_LOAD_CLIENTS, CS_MIN_REQUESTS)
    finally:
        srv.stop()
    st = srv.stats()
    check_served(st, "cluster_serve eager", CS_MIN_REQUESTS)
    eager_forwards = eager.compile_count + st["batches"]
    eager_launches = read_counts(fa, "cluster_serve eager",
                                 **{BF16_KERNEL: eager_forwards})
    eager_res = dict(latency_summary(run["latency_ms"], run["wall_s"]),
                     mean_batch_size=st["mean_batch_size"],
                     forwards=eager_forwards, flash_launches=eager_launches,
                     vs_graphs=check_replies(run["replies"],
                                             {"direct": ref}, "eager"))
    del eager, srv
    torch.cuda.empty_cache()

    # hot swap under load: update_model to another version (other seed)
    # while 16 clients run; the incoming model captures its graphs on this
    # thread (warm_from) while the old one's replay on the workers
    new_vars = random_bert_variables(
        BERTClassifier(2, use_flash=True, **BERT_BASE), SEED + 1)
    swap_replies, failures = [], []
    stop = threading.Event()

    def load(srv_ref, c):
        from analytics_zoo_tpu_torch.serving import InputQueue, OutputQueue
        iq = InputQueue(srv_ref.host, srv_ref.port)
        oq = OutputQueue(input_queue=iq)
        k = c
        try:
            while not stop.is_set():
                row = k % CS_POOL
                out = oq.query(iq.enqueue(f"c{c}", t=pool[row]), 120.0)
                if out is None:
                    failures.append("timeout")
                else:
                    swap_replies.append((row, out))
                k += CS_LOAD_CLIENTS
        except Exception as e:  # noqa: BLE001 - recorded, raised below
            failures.append(f"{type(e).__name__}: {e}")
        finally:
            iq.close()

    def wait_replies(got, n, what, timeout=120.0):
        deadline = time.monotonic() + timeout
        while len(got) < n and not failures:
            if time.monotonic() > deadline:
                raise AssertionError(f"cluster_serve: {what}: {len(got)} "
                                     f"of {n} replies")
            time.sleep(0.01)

    reset_counts(fa)
    srv = server(im)
    threads = [threading.Thread(target=load, args=(srv, c))
               for c in range(CS_LOAD_CLIENTS)]
    for t in threads:
        t.start()
    try:
        wait_replies(swap_replies, CS_PHASE_REPLIES, "before the swap")
        torch.cuda.reset_peak_memory_stats()
        new = served(new_vars)
        t0 = time.perf_counter()
        srv.update_model(new)  # warm_from, the flip, old version unloaded
        swap_s = time.perf_counter() - t0
        after_warm = new.compile_count
        n_swap = len(swap_replies)
        wait_replies(swap_replies, n_swap + 4 * CS_PHASE_REPLIES,
                     "after the swap")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        srv.stop()
    peak_swap = torch.cuda.max_memory_allocated()
    if failures or any(t.is_alive() for t in threads):
        raise AssertionError(f"cluster_serve swap: {failures[:3]}")
    st = srv.stats()
    check_served(st, "cluster_serve swap", st["requests"])
    swap_forwards = new.compile_count + st["batches"]
    swap_launches = read_counts(fa, "cluster_serve swap",
                                **{BF16_KERNEL: swap_forwards})
    if new.compile_count != after_warm or after_warm != len(im._compiled):
        raise AssertionError(
            f"cluster_serve swap: the new model prepared {new.compile_count}"
            f" keys, {after_warm} by warm_from; want {len(im._compiled)}")
    ref_new = refs_of(new)
    swap_agree = check_replies(swap_replies, {"old": ref, "new": ref_new},
                               "cluster_serve swap")
    tail = check_replies(swap_replies[-CS_PHASE_REPLIES:],
                         {"old": ref, "new": ref_new}, "swap tail")
    if swap_agree["matched"]["new"] == 0 or tail["matched"]["old"]:
        raise AssertionError(f"cluster_serve swap: replies never flipped "
                             f"({swap_agree['matched']}, last "
                             f"{CS_PHASE_REPLIES}: {tail['matched']})")
    swap = {"update_model_s": swap_s, "compile_count_new": new.compile_count,
            "replies": len(swap_replies), "failures": 0,
            "batches": st["batches"], "forwards": swap_forwards,
            "flash_launches": swap_launches, "agree": swap_agree,
            "peak_memory_bytes": peak_swap}
    del new
    torch.cuda.empty_cache()

    # the router and the HTTP frontend over two in-process replicas, each
    # with its own model; 16 HTTP clients; kill replica 0, restart it on
    # its port, then drain replica 1 and restart it
    reset_counts(fa)
    models = [im, served(variables)]
    models[1].warm([(SEQ,)], dtype=np.int32)
    servers = [server(m) for m in models]
    every = list(servers)
    ports = [s.port for s in servers]
    names = [f"{s.host}:{s.port}" for s in servers]
    rs = ReplicaSet([(s.host, s.port) for s in servers],
                    retry=RetryPolicy(max_attempts=4, base_delay=0.02,
                                      max_delay=0.1, seed=SEED),
                    health_interval=0.1, health_timeout=1.0,
                    breaker_threshold=3, breaker_reset_s=0.2)
    fe = HTTPFrontend(router=rs).start()
    http_replies, http_ms, failures[:] = [], [], []
    stop.clear()

    def http_load(c):
        k = c
        while not stop.is_set():
            row = k % CS_POOL
            body = json.dumps({"instances": pool[row].tolist(),
                               "dtype": "int32"}).encode()
            req = urllib.request.Request(
                f"http://{fe.host}:{fe.port}/predict", data=body,
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    out = np.asarray(json.load(r)["predictions"],
                                     np.float32)
            except Exception as e:  # noqa: BLE001 - recorded, raised below
                failures.append(f"{type(e).__name__}: {e}")
                continue
            http_ms.append((time.perf_counter() - t0) * 1e3)
            http_replies.append((row, out))
            k += CS_LOAD_CLIENTS

    def restart(i):
        deadline = time.monotonic() + 30
        while True:
            try:
                return server(models[i], port=ports[i])
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

    def wait_state(i, available, what):
        deadline = time.monotonic() + 60
        while True:
            rep = rs.healthz()["replicas"][names[i]]
            if rep["available"] == available and (
                    not available or rep["breaker"] == "closed"):
                return
            if time.monotonic() > deadline:
                raise AssertionError(f"cluster_serve router: {what}: {rep}")
            time.sleep(0.02)

    threads = [threading.Thread(target=http_load, args=(c,))
               for c in range(CS_LOAD_CLIENTS)]
    for t in threads:
        t.start()
    try:
        wait_replies(http_replies, CS_PHASE_REPLIES, "steady")
        servers[0].kill()
        wait_state(0, False, "killed replica still available")
        wait_replies(http_replies, len(http_replies) + CS_PHASE_REPLIES,
                     "one replica")
        servers[0] = restart(0)
        every.append(servers[0])
        wait_state(0, True, "replica 0 never re-admitted")
        if not servers[1].drain(timeout=60.0):
            raise AssertionError("cluster_serve router: drain never "
                                 "settled")
        servers[1].stop()
        servers[1] = restart(1)
        every.append(servers[1])
        wait_state(1, True, "replica 1 never returned")
        wait_replies(http_replies, len(http_replies) + CS_PHASE_REPLIES,
                     "after the restarts")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        fe.stop()
        for s in servers:
            s.stop()
    if failures or any(t.is_alive() for t in threads):
        raise AssertionError(f"cluster_serve router: {failures[:3]}")
    router_batches = sum(s.stats()["batches"] for s in every)
    router_forwards = models[1].compile_count + router_batches
    router_launches = read_counts(fa, "cluster_serve router",
                                  **{BF16_KERNEL: router_forwards})
    router = {"clients": CS_LOAD_CLIENTS, "requests": len(http_ms),
              "p50_ms": float(np.percentile(http_ms, 50)),
              "p99_ms": float(np.percentile(http_ms, 99)), "failures": 0,
              "replies_by_server": [s.stats()["replies"] for s in every],
              "forwards": router_forwards,
              "flash_launches": router_launches,
              "agree": check_replies(http_replies, {"direct": ref},
                                     "router")}

    res = {"phase": "cluster_serve", "card": card, "config": BERT_BASE,
           "seq": SEQ, "dtype": "bfloat16", "batch_size": CS_BATCH,
           "inference_workers": CS_WORKERS, "buckets": im.batch_buckets,
           "setup_s": setup_s, "levels": levels, "forwards": forwards,
           "compile_count": im.compile_count, "flash_launches": launches,
           "fwd_launches_by_design": fwd_designs, "native_queue": True,
           "agree": agree, "profiled_c64": busy,
           "p50_ms_c64_by_wait": waits, "eager_c16": eager_res,
           "swap": swap, "router": router,
           "peak_memory_bytes_main_path": peak_main}
    emit(res)
    return res


INT8_DEVICE_BUCKETS = (16, 64)  # int8_gemm_timings' device_ms buckets


def int8_gemm_shapes() -> list:
    """(layer, M, K, N, launches per forward) of the int8 products of a
    calibrated BERT-base forward at each bucket: ffn1 and ffn2 in each of
    the 12 layers over bucket x SEQ rows, the pooler over the bucket's CLS
    rows.  The head (768 x 2: 1,536 elements, under the 4,096 of
    ``_Q_MIN_SIZE``) keeps a bf16 kernel and so runs no int8 product (0 a
    forward); its shape is timed all the same, as the N = 2 padding case.
    The attention projections stay weight-only."""
    h = BERT_BASE["hidden_size"]
    ffn, n = h * BERT_BASE["intermediate_mult"], BERT_BASE["n_layers"]
    shapes = []
    for b in BUCKETS:
        shapes += [("ffn1", b * SEQ, h, ffn, n), ("ffn2", b * SEQ, ffn, h, n),
                   ("pooler", b, h, h, 1), ("head", b, h, 2, 0)]
    return shapes


def int8_gemm_timings(quant) -> list:
    """``quant.int_mm`` (``torch._int_mm``, zero-padded where the card
    wants it) at every calibrated BERT-base shape: bit for bit against a
    float64 product on the card, its time (events; device) beside its
    bound (int8's dense peak, the bytes at 3.35e12), and beside it the
    whole int8 Dense (quantize, product, rescale), the weight-only form
    (bf16 dequantization, then a bf16 GEMM: the W8A16 yardstick) and a
    bf16 GEMM alone."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    for layer, m, k, n, per_fwd in int8_gemm_shapes():
        a = torch.randint(-127, 128, (m, k), device="cuda", generator=gen,
                          dtype=torch.int8)
        # K-major, as a Dense's Int8Weight keeps it
        w = torch.randint(-127, 128, (n, k), device="cuda", generator=gen,
                          dtype=torch.int8).t()
        if not torch.equal(quant.int_mm(a, w).double(),
                           a.double() @ w.double()):
            raise AssertionError(f"int_mm {layer} {m}x{k}x{n} is not the "
                                 f"exact product")
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        scale = torch.rand(1, n, device="cuda", generator=gen) * 1e-2
        wb = (w.to(torch.bfloat16) * scale.to(torch.bfloat16))
        ctx = quant.QuantApply({"x": 4.0})
        fns = {"int_mm": lambda: quant.int_mm(a, w),
               "int8_dense": lambda: quant.dense_quantized(
                   ctx, "x", x, w, scale, torch.bfloat16),
               "weight_only": lambda: x @ (w.to(torch.bfloat16)
                                           * scale.to(torch.bfloat16)),
               "bf16_gemm": lambda: x @ wb}
        t_ops = 2.0 * m * k * n / PEAK_INT8_OPS
        t_bytes = (m * k + k * n + 4 * m * n) / PEAK_BYTES
        row = {"layer": layer, "m": m, "k": k, "n": n,
               "launches_per_forward": per_fwd, "exact": True,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        for name, fn in fns.items():
            row[f"{name}_ms"] = cuda_ms(fn)
            # the profiler's windows at the two largest buckets only
            row[f"{name}_device_ms"] = (device_ms(fn) if m >= min(
                INT8_DEVICE_BUCKETS) * SEQ or layer == "pooler" and
                m >= min(INT8_DEVICE_BUCKETS) else None)
        rows.append(row)
        del a, w, x, wb
    return rows


def phase_int8_serve(fa) -> dict:
    """BERT-base served in int8 through ``InferenceModel`` from CUDA graphs
    (weight-only, then calibrated on INT8_CALIB seeded sequences): warm,
    predict at batches 1, 3, 16, 64 and 70; the bf16 flash forward's 12
    launches a forward (all ``wgmma``) and, calibrated, 25 int8 products a
    forward (``int8_gemm_shapes``), each counted from the graphs' replays; logits against the f32
    dense model; p50 per bucket; the parameters' bytes on the card.  Then
    ``int_mm`` at every calibrated shape, and ResNet-50 (``norm="batch"``)
    calibrated at batch 16, 224 x 224: every int8 conv bit for bit against
    float64, logits against its bf16 serving."""
    from analytics_zoo_tpu_torch.models import BERTClassifier, ResNet
    from analytics_zoo_tpu_torch.nn import quant
    from analytics_zoo_tpu_torch.nn.layers import Conv2D, conv2d_nhwc
    from analytics_zoo_tpu_torch.serving import InferenceModel

    def served(dtype=None, use_flash=True, calibrate=None):
        model = BERTClassifier(2, use_flash=use_flash, **BERT_BASE)
        return InferenceModel(device="cuda").load(model, variables,
                                                  dtype=dtype,
                                                  calibrate=calibrate)

    variables = random_bert_variables(
        BERTClassifier(2, use_flash=True, **BERT_BASE), SEED)
    rng = np.random.default_rng(SEED + 1)
    vocab = BERT_BASE["vocab_size"]
    batches = {n: rng.integers(0, vocab, (n, SEQ)).astype(np.int32)
               for n in (1, 3, 16, 64, 70)}
    calib = np.random.default_rng(SEED + 2).integers(
        0, vocab, (INT8_CALIB, SEQ)).astype(np.int32)
    ref_im = served(use_flash=False)
    refs = {n: ref_im.predict(x) for n, x in batches.items()}
    param_bytes = {"float32": ref_im.parameter_bytes()}
    del ref_im
    bf16_im = served(torch.bfloat16)
    param_bytes["bfloat16"] = bf16_im.parameter_bytes()
    del bf16_im
    bert = {}
    for mode, cal in (("weight_only", None), ("calibrated", calib)):
        t0 = time.perf_counter()
        im = served("int8", calibrate=cal)
        load_s = time.perf_counter() - t0
        top = im.batch_buckets[-1]
        # the main path: warm (an eager forward and a capture per bucket),
        # then predict from the graphs; the counts read right after
        reset_counts(fa)
        mm0 = quant.int_mm.launches
        t0 = time.perf_counter()
        im.warm([(SEQ,)], dtype=np.int32)
        warm_s = time.perf_counter() - t0
        outs = {n: im.predict(x) for n, x in batches.items()}
        forwards = im.compile_count + sum(-(-n // top) for n in batches)
        what = f"int8_serve {mode}"
        launches = read_counts(fa, what, **{BF16_KERNEL: forwards})
        designs = read_fwd_designs(fa, what, "wgmma", forwards)
        mm = quant.int_mm.launches - mm0
        per_fwd = sum(x[4] for x in int8_gemm_shapes()
                      if x[1] in (top, top * SEQ))
        want_mm = forwards * per_fwd if cal is not None else 0
        if mm != want_mm:
            raise AssertionError(f"{what}: {mm} int8 products; want "
                                 f"{want_mm} ({per_fwd} a forward)")
        worst = 0.0
        for n, ref in refs.items():
            y = outs[n]
            if y.shape != (n, 2) or not np.isfinite(y).all():
                raise AssertionError(f"{what}: batch {n} gave {y.shape} or "
                                     f"non-finite logits")
            worst = max(worst, float(np.abs(y - ref).max())
                        / max(1.0, float(np.abs(ref).max())))
        if worst > TOL_INT8_SERVE:
            raise AssertionError(f"{what}: logits differ from f32 dense by "
                                 f"{worst} of max(1, |ref|) > "
                                 f"{TOL_INT8_SERVE}")
        param_bytes[f"int8_{mode}"] = im.parameter_bytes()
        bert[mode] = {
            "load_s": load_s, "warm_s": warm_s, "forwards": forwards,
            "flash_launches": launches, "fwd_launches_by_design": designs,
            "int_mm_launches": mm, "int_mm_per_forward":
                per_fwd if cal is not None else 0,
            "calibrated_layers": len(im._quant_ctx.amax)
            if im._quant_ctx else 0,
            "max_err_rel_to_max_vs_f32_dense": worst,
            "latency": {str(b): served_latency(im, batches[64][:b], SEQ)
                        for b in im.batch_buckets},
            "breakdown_64": profile_call(
                lambda: im.predict(batches[64]), {"flash": ("flash_fwd_",),
                                                  "int8": ("s8", "imma",
                                                           "igemm")})}
        del im
        torch.cuda.empty_cache()
    gemms = int8_gemm_timings(quant)

    # ResNet-50, norm="batch", calibrated int8 against its bf16 serving
    def resnet():
        return ResNet(depth=50, class_num=1000, norm="batch")

    rvars = random_resnet_variables(resnet(), SEED)
    irng = np.random.default_rng(SEED + 3)
    shape = (RESNET_SERVE_BATCH, IMAGE, IMAGE, 3)
    images = irng.normal(size=shape).astype(np.float32)
    calib_images = irng.normal(size=shape).astype(np.float32)
    buckets = (RESNET_SERVE_BATCH,)
    ref_im = InferenceModel(batch_buckets=buckets, device="cuda").load(
        resnet(), rvars, dtype=torch.bfloat16)
    ref = ref_im.predict(images)
    resnet_res = {"bf16_latency": served_latency(ref_im, images),
                  "param_bytes": {"bfloat16": ref_im.parameter_bytes()}}
    del ref_im
    im = InferenceModel(batch_buckets=buckets, device="cuda").load(
        resnet(), rvars, dtype="int8", calibrate=calib_images)
    convs = [m for m in im._model.modules()
             if isinstance(m, Conv2D) and m._act_quant]
    mm0 = quant.int_mm.launches
    n_warm = im.warm([shape[1:]])
    out = im.predict(images)
    mm = quant.int_mm.launches - mm0
    if mm != (n_warm + 1) * (len(convs) + 1):
        raise AssertionError(f"int8_serve resnet: {mm} int8 products; want "
                             f"{(n_warm + 1) * (len(convs) + 1)}")
    err = float(np.abs(out - ref).max()) / max(1.0, float(np.abs(ref).max()))
    agree = float(np.mean(out.argmax(1) == ref.argmax(1)))
    if out.shape != (RESNET_SERVE_BATCH, 1000) or not np.isfinite(out).all() \
            or err > TOL_INT8_RESNET:
        raise AssertionError(f"int8_serve resnet: logits {out.shape} differ "
                             f"from bf16 by {err} of max(1, |ref|) (> "
                             f"{TOL_INT8_RESNET}?) or are not finite")
    # every int8 conv on its own input of one eager forward, against a
    # float64 conv of the same int8 values on the card
    exact = []

    def check(layer, args):
        key = im._paths[id(layer)]
        s_in, xq = quant._quantize_activation(im._quant_ctx, key, args[0])
        w = layer._modules["kernel"].q
        y = quant.conv_int8(xq, w, layer.strides, layer.padding,
                            layer.dilation, layer.groups)
        want = conv2d_nhwc(xq.double(), w.double(), layer.strides,
                           layer.padding, layer.dilation, layer.groups)
        exact.append(bool(torch.equal(y.double(), want)))

    hooks = [c.register_forward_pre_hook(check) for c in convs]
    im._forward(torch.from_numpy(images).cuda())
    for h in hooks:
        h.remove()
    if len(exact) != len(convs) or not all(exact):
        raise AssertionError(f"int8_serve resnet: {exact.count(False)} of "
                             f"{len(convs)} int8 convs differ from float64")
    resnet_res.update({
        "batch": RESNET_SERVE_BATCH, "image": IMAGE, "stem": "conv",
        "int8_convs": len(convs), "convs_exact_vs_float64": len(exact),
        "int_mm_launches": mm, "calibrated_layers": len(im._quant_ctx.amax),
        "max_err_rel_to_max_vs_bf16": err, "top1_agree_vs_bf16": agree,
        "int8_latency": served_latency(im, images)})
    resnet_res["param_bytes"]["int8_calibrated"] = im.parameter_bytes()
    del im
    res = {"phase": "int8_serve", "config": BERT_BASE, "seq": SEQ,
           "batches": sorted(batches), "calibration_rows": INT8_CALIB,
           "tol_vs_f32_dense": TOL_INT8_SERVE, "bert": bert,
           "param_bytes": param_bytes, "int_mm_timings": gemms,
           "resnet50": resnet_res,
           "tol_resnet_vs_bf16": TOL_INT8_RESNET}
    emit(res)
    return res


def window_ms(fn, steps: int) -> tuple:
    """(ms a step, losses): ``fn()`` enqueues ``steps`` train steps and
    returns their losses on the card; the window synchronises only at its
    ends (the last loss read back)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = fn()
    float(losses[-1])
    return (time.perf_counter() - t0) * 1e3 / steps, losses


def losses_against_eager(got, want, what: str) -> dict:
    """A captured run's step losses against the eager step's on the same
    inputs: equal bits expected (the same kernels, inputs and generator
    offsets); a difference is reported and held to TOL_TRAIN_LOSS of
    max(1, |loss|), bert_train (a)'s bound."""
    got, want = [float(v) for v in got], [float(v) for v in want]
    if len(got) != len(want) or not all(map(math.isfinite, got)):
        raise AssertionError(f"{what}: captured losses {got}, eager {want}")
    worst = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(got, want))
    if worst > TOL_TRAIN_LOSS:
        raise AssertionError(f"{what}: captured step losses {got} differ "
                             f"from the eager step's {want} by {worst} of "
                             f"max(1, |loss|)")
    return {"steps": len(got), "bitwise_equal": got == want,
            "worst_rel": worst, "tol": TOL_TRAIN_LOSS, "captured": got,
            "eager": want}


def captures(est, what: str) -> dict:
    """``est``'s captures: one per batch key."""
    keys = len(est._graphs)
    if est.capture_count != keys:
        raise AssertionError(f"{what}: {est.capture_count} captures for "
                             f"{keys} batch keys")
    return {"capture_count": est.capture_count, "keys": keys}


def profiled_window(fn, steps: int, shares: dict) -> dict:
    """``profile_call`` over a window of ``steps`` steps, with the card's
    busy time a step."""
    res = profile_call(fn, shares)
    res["device_busy_ms_per_step"] = (res["device_busy_ms"] / steps
                                      if res["device_busy_ms"] else None)
    return res


def idle_of(profiled: dict, step_ms: float) -> None:
    """The card's idle share of an unprofiled window's step: 1 - busy a
    step / step ms (None where the profiler saw no kernel)."""
    busy = profiled["device_busy_ms_per_step"]
    profiled["idle_share_of_window_step"] = \
        None if busy is None else 1.0 - busy / step_ms


def stream_chunks(est, feed, chunk_steps: int, n_chunks: int) -> dict:
    """bench.py's ``_stream_train`` on the port: ``chunk_steps`` host
    batches of the feed stacked into one chunk, one copy to the card a
    leaf and ``chunk_steps`` replays (``_multi_step_data``); one chunk to
    warm, then ``n_chunks`` timed with a synchronisation at the end only.
    The feed's decode workers are joined before it returns."""
    it = feed.epoch(est.device, 0, place=False)

    def next_chunk():
        host = [next(it) for _ in range(chunk_steps)]
        chunk = {k: np.stack([h[k] for h in host]) for k in host[0]}
        for h in host:  # a process backend's slots go back to its pool
            getattr(h, "release", lambda: None)()
        return chunk

    prep, dispatch = [], []  # host ms a chunk: the feed, the call
    try:
        float(est._multi_step_data(next_chunk())[-1])
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            t1 = time.perf_counter()
            chunk = next_chunk()
            t2 = time.perf_counter()
            losses = est._multi_step_data(chunk)
            prep.append((t2 - t1) * 1e3)
            dispatch.append((time.perf_counter() - t2) * 1e3)
        float(losses[-1])
        dt = time.perf_counter() - t0
    finally:
        it.close()
    steps = chunk_steps * n_chunks
    return {"chunk_steps": chunk_steps, "chunks": n_chunks, "steps": steps,
            "step_ms": dt * 1e3 / steps, "host_feed_ms_per_chunk": prep,
            "host_call_ms_per_chunk": dispatch, "backend": feed.workers,
            "workers": feed.num_workers,
            "prefetch_batches": feed.prefetch_batches,
            "last_losses": [float(v) for v in losses]}


def fork_probe() -> dict:
    """A forked decode worker of the streaming feed, after this process
    made its CUDA context: torch marks the child as forked from a CUDA
    process (a CUDA call there would raise), and the child ran the loader
    on numpy only."""
    from analytics_zoo_tpu_torch.data import StreamingDataFeed

    def load(i, rng=None):
        time.sleep(0.01)  # so that both workers take batches
        return {"bad_fork": np.int32(torch.cuda._is_in_bad_fork()),
                "pid": np.int64(os.getpid())}

    feed = StreamingDataFeed(8, load, batch_size=2, shuffle=False,
                             num_workers=2, workers="process")
    rows = []
    for b in feed.epoch(torch.device("cuda"), 0, place=False):
        rows.append({k: np.asarray(v).copy() for k, v in b.items()})
        b.release()
    pids = {int(p) for r in rows for p in r["pid"]}
    flags = {int(f) for r in rows for f in r["bad_fork"]}
    if os.getpid() in pids or flags != {1}:
        raise AssertionError(f"fork probe: worker pids {pids} (parent "
                             f"{os.getpid()}), bad-fork flags {flags}")
    return {"worker_pids": len(pids), "children_marked_bad_fork": True,
            "parent_has_cuda_context": torch.cuda.is_initialized()}


def failed_capture_check() -> dict:
    """In a process of its own (a failed capture may leave the context in
    no state to go on): a step that reads a value back to the host cannot
    be captured, and the Estimator raises, naming the call; it does not
    fall back to eager."""
    code = (
        "import numpy as np, torch\n"
        "from analytics_zoo_tpu_torch import nn as tnn\n"
        "from analytics_zoo_tpu_torch.orca.learn import Estimator\n"
        "class HostRead(torch.nn.Module):\n"
        "    def __init__(self):\n"
        "        super().__init__(); self.dense = tnn.Dense(2, 2)\n"
        "    def forward(self, x):\n"
        "        return self.dense(x) * float(x.abs().max())\n"
        "est = Estimator.from_keras(HostRead(), loss='mse', optimizer='sgd',"
        " learning_rate=0.1)\n"
        "x = np.ones((4, 2), np.float32)\n"
        "try:\n"
        "    est.fit((x, x), epochs=1, batch_size=4, verbose=False)\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', str(e).splitlines()[0][:400])\n"
        "else:\n"
        "    print('RAN', est.capture_count)\n")
    import tempfile
    # from a file, so that the traceback the error names has its source
    with tempfile.NamedTemporaryFile("w", suffix=".py") as f:
        f.write(code)
        f.flush()
        out = subprocess.run([sys.executable, f.name], capture_output=True,
                             text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=os.path.dirname(
                                 os.path.abspath(__file__))))
    line = next((ln for ln in out.stdout.splitlines()
                 if ln.startswith(("RAISED", "RAN"))), "")
    if not (line.startswith("RAISED") and "capture of the train step" in line
            and "float(" in line):
        raise AssertionError(f"a capture with a host read: {line!r} "
                             f"{out.stderr[-2000:]}")
    return {"raised": True, "message": line[len("RAISED "):]}


def squad_examples(rng: np.random.Generator, n: int) -> tuple:
    """n SQuAD-shaped examples at SEQ: random token ids and a random answer
    span (start < end) each, labels int [n, 2].  Nothing in the input marks
    the span, so the model can only learn the examples by heart: the loss
    falls over epochs, not in one step."""
    ids = rng.integers(0, BERT_BASE["vocab_size"], (n, SEQ)).astype(np.int32)
    start = rng.integers(0, SEQ - 64, n)
    end = start + rng.integers(1, 64, n)
    return ids, np.stack([start, end], axis=1).astype(np.int32)


def record_steps(est) -> tuple:
    """Make ``est``'s train step synchronise before and after itself and
    record its loss and its time; returns the (losses, ms) lists it
    fills."""
    losses, times = [], []
    inner = est._train_step

    def step(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = inner(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        return loss

    est._train_step = step
    return losses, times


def phase_bert_train(fa) -> dict:
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.data import as_feed
    from analytics_zoo_tpu_torch.models import BERTSQuAD, squad_span_loss
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    t0 = time.perf_counter()
    state = from_jax_variables(random_bert_variables(
        BERTSQuAD(use_flash=True, **BERT_BASE), SEED))
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 2)

    def model(use_flash, **kw):
        m = BERTSQuAD(use_flash=use_flash, **dict(BERT_BASE, **kw))
        m.load_state_dict(state, strict=True)
        return m.cuda()

    # (a) f32, dropout 0: flash (f32 forward + backward kernels) vs dense
    x8, y8 = squad_examples(rng, CHECK_BATCH)
    xt, yt = torch.from_numpy(x8).cuda(), torch.from_numpy(y8).cuda()
    grads = {}
    for use_flash in (True, False):
        m = model(use_flash).train()
        names = [n for n, _ in m.named_parameters()]
        loss = squad_span_loss(m(xt), yt)
        grads[use_flash] = dict(zip(names, torch.autograd.grad(
            loss, list(m.parameters()))))
        del m, loss
    g_max = max(g.abs().max().item() for g in grads[False].values())
    worst_rel, shift_invariant = 0.0, []
    for name, ref in grads[False].items():
        err = (grads[True][name] - ref).abs().max().item()
        top = ref.abs().max().item()
        if top < GRAD_NOISE * g_max:  # zero in exact arithmetic
            shift_invariant.append(name)
            if err > GRAD_NOISE * g_max:
                raise AssertionError(f"bert_train f32: {name}'s gradient "
                                     f"differs by {err} > {GRAD_NOISE} of "
                                     f"the largest, {g_max}")
            continue
        worst_rel = max(worst_rel, err / top)
        if err > TOL_TRAIN_GRAD * top:
            raise AssertionError(f"bert_train f32: {name}'s gradient differs "
                                 f"by {err} of max {top} (flash vs dense)")
    want_noise = sorted(["span_head.bias", f"bert.layer_"
                         f"{BERT_BASE['n_layers'] - 1}.ffn2.bias"])
    if sorted(shift_invariant) != want_noise:
        raise AssertionError(f"bert_train f32: gradients at noise level in "
                             f"{shift_invariant}, want {want_noise}")
    del grads
    # 3 steps, each on a batch the model has not seen (one repeated batch
    # is learned by heart in a single step)
    x3, y3 = squad_examples(rng, CHECK_BATCH * CHECK_STEPS)
    hist = {}
    for use_flash in (True, False):
        est = Estimator.from_keras(model(use_flash), loss=squad_span_loss,
                                   optimizer="adamw", learning_rate=TRAIN_LR,
                                   seed=SEED, cuda_graphs=False)
        inner = est._train_step
        hist[use_flash], _ = record_steps(est)
        reset_counts(fa)
        est.fit((x3, y3), epochs=1, batch_size=CHECK_BATCH, verbose=False)
        if use_flash:
            f32_launches = read_counts(fa, "bert_train f32", **{
                F32_KERNEL: CHECK_STEPS, BWD_KERNEL: CHECK_STEPS})
            f32_fwd_designs = read_fwd_designs(fa, "bert_train f32",
                                               "wgmma_tf32", CHECK_STEPS)
            f32_bwd_designs = read_bwd_designs(fa, "bert_train f32",
                                               "wgmma_tf32", CHECK_STEPS)
            # one more step, profiled: the card's busy time and the flash
            # kernels' share (both directions' split passes included)
            batch = next(as_feed((x3, y3), CHECK_BATCH, seed=SEED).epoch(
                est.device, 0))
            f32_profiled = profile_call(lambda: inner(batch), {
                "flash_fwd": ("flash_fwd_",),
                "flash_bwd": ("bwd_dkdv", "bwd_dq", "bwd_delta"),
                "flash_split": ("split_tf32",)})
        del est, inner
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(hist[True], hist[False]))
    if loss_err > TOL_TRAIN_LOSS or not all(map(math.isfinite, hist[True])):
        raise AssertionError(f"bert_train f32: loss history {hist[True]} "
                             f"(flash) vs {hist[False]} (dense)")
    f32_check = {"batch": CHECK_BATCH, "steps": CHECK_STEPS,
                 "grad_worst_rel_to_tensor_max":
                 worst_rel, "grad_tol": TOL_TRAIN_GRAD,
                 "shift_invariant_grads": shift_invariant,
                 "largest_grad": g_max, "loss_flash": hist[True],
                 "loss_dense": hist[False], "loss_worst_rel": loss_err,
                 "loss_tol": TOL_TRAIN_LOSS, "launches": f32_launches,
                 "fwd_launches_by_design": f32_fwd_designs,
                 "bwd_launches_by_design": f32_bwd_designs,
                 "profiled_step": f32_profiled}

    # (b) the bf16 run: dropout 0.1, global batch 32, 20 steps
    x, y = squad_examples(rng, TRAIN_EXAMPLES)
    est = Estimator.from_keras(model(True, dropout=0.1, dtype=torch.bfloat16),
                               loss=squad_span_loss, optimizer="adamw",
                               learning_rate=TRAIN_LR, seed=SEED,
                               cuda_graphs=False)
    inner = est._train_step
    step_losses, step_ms = record_steps(est)
    steps = TRAIN_EPOCHS * (TRAIN_EXAMPLES // TRAIN_BATCH)
    reset_counts(fa)
    t0 = time.perf_counter()
    losses = est.fit((x, y), epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
                     verbose=False)["loss"]
    fit_s = time.perf_counter() - t0
    launches = read_counts(fa, "bert_train bf16",
                           **{BF16_KERNEL: steps, BWD_KERNEL: steps})
    fwd_designs = read_fwd_designs(fa, "bert_train bf16", "wgmma", steps)
    bwd_designs = read_bwd_designs(fa, "bert_train bf16", "wgmma", steps)
    if not all(map(math.isfinite, losses)) \
            or losses[-1] > LOSS_FALL * losses[0]:
        raise AssertionError(f"bert_train bf16: loss {losses} did not fall "
                             f"to {LOSS_FALL} of its first epoch")
    last = step_ms[-10:]
    p50 = float(np.median(last))
    tokens_per_s = TRAIN_BATCH * SEQ / (p50 / 1e3)
    batch = next(as_feed((x, y), TRAIN_BATCH, seed=SEED).epoch(
        est.device, 0))
    profiled = profile_call(lambda: inner(batch), {
        "flash_fwd": ("flash_fwd_",),
        "flash_bwd": ("bwd_dkdv", "bwd_dq", "bwd_delta")})

    x_eval, y_eval = squad_examples(rng, 6)
    x_eval, y_eval = np.concatenate([x, x_eval]), np.concatenate([y, y_eval])
    evaluated = est.evaluate((x_eval, y_eval), batch_size=TRAIN_BATCH)
    pred = est.predict(x_eval, batch_size=TRAIN_BATCH)
    if pred.shape != (len(x_eval), SEQ, 2) or not np.isfinite(pred).all() \
            or not math.isfinite(evaluated["loss"]):
        raise AssertionError(f"bert_train: predict gave {pred.shape}, "
                             f"evaluate {evaluated}")
    hits = float(np.mean(pred.argmax(axis=1) == y_eval))
    del est

    # one seed, one loss history: the same fit again from the same weights
    again = Estimator.from_keras(
        model(True, dropout=0.1, dtype=torch.bfloat16), loss=squad_span_loss,
        optimizer="adamw", learning_rate=TRAIN_LR, seed=SEED,
        cuda_graphs=False)
    repeat_losses, _ = record_steps(again)
    again.fit((x, y), epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
              verbose=False)
    del again
    if repeat_losses != step_losses:
        raise AssertionError(f"bert_train bf16: a second fit with seed "
                             f"{SEED} gave step losses {repeat_losses}, the "
                             f"first {step_losses}")
    captured = bert_train_captured(fa, model, x, y, step_losses, steps, rng)
    res = {"phase": "bert_train", "config": dict(BERT_BASE, dropout=0.1),
           "seq": SEQ, "dtype": "bfloat16", "optimizer": "adamw",
           "learning_rate": TRAIN_LR, "global_batch": TRAIN_BATCH,
           "examples": TRAIN_EXAMPLES, "epochs": TRAIN_EPOCHS, "steps": steps,
           "setup_s": setup_s, "fit_s": fit_s, "loss": losses,
           "step_losses": step_losses,
           "loss_fall_limit": LOSS_FALL, "launches": launches,
           "fwd_launches_by_design": fwd_designs,
           "bwd_launches_by_design": bwd_designs,
           "step_ms_last10": last, "step_ms_p50": p50,
           "tokens_per_s": tokens_per_s,
           "model_tflop_per_s": tokens_per_s * 3 * bert_flops_per_token()
           / 1e12,
           "flop_convention": "3 x forward FLOP of bert_flops_per_token "
                              "(encoder GEMMs + attention products; "
                              "embeddings, span head, LayerNorm, softmax "
                              "and optimizer not counted)",
           "profiled_step": profiled,
           "evaluate": evaluated, "predict_rows": int(pred.shape[0]),
           "span_hit_rate": hits, "repeat_fit_identical": True,
           "f32_check": f32_check, "captured": captured}
    emit(res)
    return res


def bert_train_captured(fa, model, x, y, eager_losses, steps, rng) -> dict:
    """bert_train (d): the (b) fine-tune from CUDA graphs through
    ``fit(prefetch=2)``: the eager (b) fit's step losses (dropout 0.1, its
    masks from the generator registered with the graph), 12 + 12 flash
    launches a step counted from the replays, one capture; then a window
    of 20 steps (one epoch of 640 fresh examples, synchronised at its
    ends) beside the eager step's same window, a profiled fit, peak
    memory, and a capture that must fail, in a process of its own."""
    from analytics_zoo_tpu_torch.models import squad_span_loss
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    def make(graphs):
        return Estimator.from_keras(
            model(True, dropout=0.1, dtype=torch.bfloat16),
            loss=squad_span_loss, optimizer="adamw", learning_rate=TRAIN_LR,
            seed=SEED, cuda_graphs=graphs)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    est = make(True)
    got, inner = [], est._train_step

    def keep(batch):  # each step's loss, read after the fit
        loss = inner(batch)
        got.append(loss)
        return loss

    est._train_step = keep
    reset_counts(fa)
    est.fit((x, y), epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
            verbose=False, prefetch=2)
    launches = read_counts(fa, "bert_train (d)",
                           **{BF16_KERNEL: steps, BWD_KERNEL: steps})
    fwd_designs = read_fwd_designs(fa, "bert_train (d)", "wgmma", steps)
    bwd_designs = read_bwd_designs(fa, "bert_train (d)", "wgmma", steps)
    against = losses_against_eager(got, eager_losses, "bert_train (d)")
    est._train_step = inner
    window = 20
    xw, yw = squad_examples(rng, TRAIN_BATCH * window)
    ms = {}
    for graphs in (True, False):
        run = est if graphs else make(False)
        if not graphs:  # warm: the optimizer's state, cuBLAS's workspace
            run.fit((x, y), epochs=1, batch_size=TRAIN_BATCH, verbose=False,
                    prefetch=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.fit((xw, yw), epochs=1, batch_size=TRAIN_BATCH, verbose=False,
                prefetch=2)  # the epoch's loss read back: synchronised
        ms[graphs] = (time.perf_counter() - t0) * 1e3 / window
        if not graphs:
            del run
    profiled = profiled_window(
        lambda: est.fit((x, y), epochs=1, batch_size=TRAIN_BATCH,
                        verbose=False, prefetch=2),
        TRAIN_EXAMPLES // TRAIN_BATCH,
        {"flash_fwd": ("flash_fwd_",),
         "flash_bwd": ("bwd_dkdv", "bwd_dq", "bwd_delta")})
    idle_of(profiled, ms[True])
    caps = captures(est, "bert_train (d)")
    peak = torch.cuda.max_memory_allocated()
    del est
    torch.cuda.empty_cache()
    tokens_per_s = TRAIN_BATCH * SEQ / (ms[True] / 1e3)
    return {"path": "fit(prefetch=2) from CUDA graphs", "steps": steps,
            "losses_against_eager": against, "launches": launches,
            "fwd_launches_by_design": fwd_designs,
            "bwd_launches_by_design": bwd_designs,
            "window_steps": window, "step_ms": ms[True],
            "eager_step_ms": ms[False], "tokens_per_s": tokens_per_s,
            "model_tflop_per_s": tokens_per_s * 3 * bert_flops_per_token()
            / 1e12, "profiled": profiled, "peak_memory_bytes": peak,
            "failed_capture": failed_capture_check(), **caps}


class TrainNet(torch.nn.Module):
    """bench.py's ResNet-50 training net: uint8 NHWC images, normalised on
    the card to ``(x - 127) / 64`` in the model's dtype (or in
    ``input_dtype``: float64 for the numerical reference), into
    ``resnet``."""

    def __init__(self, input_dtype=None, **kw):
        super().__init__()
        from analytics_zoo_tpu_torch.models import ResNet
        self.resnet = ResNet(**dict(RESNET, **kw))
        self.input_dtype = input_dtype or self.resnet.dtype

    def forward(self, x):
        return self.resnet((x.to(self.input_dtype) - 127.0) * (1.0 / 64.0))


def bn_textbook(x, gamma, beta, eps):
    """Training batch norm as the textbook writes it, differentiated by
    autograd, in x's dtype: the float64 reference of resnet_train (a)."""
    red = tuple(range(x.dim() - 1))
    mean, var = x.mean(red), x.var(red, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta, mean, var


def random_resnet_variables(model: torch.nn.Module, seed: int) -> dict:
    """Random weights made with numpy in the JAX tree layout, drawn from
    the JAX initializers' distributions: he-normal conv kernels (HWIO),
    glorot-uniform head, unit gains, zero biases and shifts, running mean 0
    and variance 1, SkipInit gains 0."""
    from analytics_zoo_tpu_torch.convert import buffer_names, to_jax_variables
    rng = np.random.default_rng(seed)

    def draw(leaf, shape):
        if leaf == "kernel" and len(shape) == 4:
            fan_in = shape[0] * shape[1] * shape[2]
            return rng.normal(0.0, math.sqrt(2.0 / fan_in), shape)
        if leaf == "kernel":
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            return rng.uniform(-lim, lim, shape)
        if leaf in ("gamma", "ws_gain", "var"):
            return np.ones(shape)
        return np.zeros(shape)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else draw(k, v.shape).astype(np.float32)
                for k, v in node.items()}

    return walk(to_jax_variables(model.state_dict(), buffer_names(model)))


def model_flops_per_image(model: torch.nn.Module, x: torch.Tensor) -> float:
    """Forward FLOP per image of the convs and dense layers, from the
    shapes one forward gives them: 2 x output elements x fan in (a conv
    kernel OIHW, the space-to-depth stem counted as the 7x7 conv it
    computes)."""
    from analytics_zoo_tpu_torch.nn import Dense
    total = [0.0]

    def hook(m, _inp, out):
        k = m.kernel
        fan_in = k.shape[0] if isinstance(m, Dense) else k[0].numel()
        total[0] += 2.0 * out.numel() * fan_in

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(getattr(m, "kernel", None), torch.nn.Parameter)]
    try:
        with torch.no_grad():
            model.eval()(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0] / x.shape[0]


def resnet_bn_maps(batch: int, device: str = "cuda") -> dict:
    """Every distinct (rows, C) the 53 batch norms of ResNet-50 see at
    ``batch`` 224 x 224 images, in the order of the forward, with how many
    norms see it (one image through the model on ``device``)."""
    from analytics_zoo_tpu_torch.nn import BatchNormalization
    model = TrainNet().to(device)
    maps: dict = {}

    def hook(_m, inp, _out):
        *lead, c = inp[0].shape
        key = (batch * math.prod(lead[1:]), c)
        maps[key] = maps.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, BatchNormalization)]
    with torch.no_grad():
        model.eval()(torch.zeros(1, IMAGE, IMAGE, 3, dtype=torch.uint8,
                                 device=device))
    for h in hooks:
        h.remove()
    if sum(maps.values()) != RESNET_BN:
        raise AssertionError(f"ResNet-50 ran {sum(maps.values())} batch "
                             f"norms")
    return maps


def bn_inputs(gen, rows, c, dtype, offset=0):
    """x (channel 0 centred at 1e3 times its std), gamma, beta, dy and
    non-zero dmean, dvar on the card; ``offset`` elements into a buffer
    (an unaligned view) when given."""
    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x = 2.0 + r(rows, c)
    x[:, 0] += 1e3 - 2.0
    if offset:
        buf = torch.empty(rows * c + offset, device="cuda", dtype=dtype)
        buf[offset:] = x.reshape(-1).to(dtype)
        x = buf[offset:].view(rows, c)
    else:
        x = x.to(dtype)
    return x, 1.0 + 0.1 * r(c), 0.1 * r(c), r(rows, c).to(dtype), r(c), r(c)


def bn_bound(rows: int, c: int, itemsize: int, direction: str) -> tuple:
    """(ms, "bytes"): forward reads x and writes y (2 maps), backward reads
    dy and x and writes dx (3 maps), the [C] vectors beside them."""
    maps = 2 if direction == "fwd" else 3
    vectors = 5 if direction == "fwd" else 8
    return (maps * rows * c * itemsize + vectors * c * 4) / PEAK_BYTES \
        * 1e3, "bytes"


def phase_fused_bn(bn) -> dict:
    """The fused batch-norm kernels against their plain versions at every
    ResNet-50 shape (batch 128) and the edge cases, forward (y, mean, var)
    and backward (dx, dgamma, dbeta, with non-zero dmean/dvar), both
    dtypes, and in f32 at every shape of the foreign phase (the converted
    torch ResNet-50 at batch 32, DCGAN's G and D at batch 128); bit-for-bit
    repeats; then times at the stem's shape, the one the most norms see
    and the last stage's."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {"f32": 0.0, "bf16_rel": 0.0, "stats": 0.0}
    eps = 1e-3

    def check(x, g, b, dy, dm, dv):
        y, m, v = bn.bn_train_fwd(x, g, b, eps)
        dx, dg, db = bn.bn_train_bwd(x, g, m, v, dy, dm, dv, eps)
        ry, rm, rv = bn.bn_train_fwd_reference(x, g, b, eps)
        rdx, rdg, rdb = bn.bn_train_bwd_reference(x, g, m, v, dy, dm, dv,
                                                  eps)
        torch.cuda.synchronize()
        err = 0.0
        for name, a, ref in (("y", y, ry), ("dx", dx, rdx), ("mean", m, rm),
                             ("var", v, rv), ("dgamma", dg, rdg),
                             ("dbeta", db, rdb)):
            if a.shape != ref.shape or a.dtype != ref.dtype \
                    or not torch.isfinite(a).all():
                raise AssertionError(f"fused_bn {name}: {tuple(a.shape)} "
                                     f"{a.dtype} at {tuple(x.shape)}")
            e = (a.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            if name in ("y", "dx") and x.dtype == torch.bfloat16:
                rel, tol, key = e / max(top, 1e-30), TOL_BN_BF16_REL, \
                    "bf16_rel"
            elif name in ("y", "dx"):
                rel, tol, key = e / max(1.0, top), TOL_BN_F32, "f32"
            else:
                rel, tol, key = e / max(1.0, top), TOL_BN_STATS, "stats"
            worst[key] = max(worst[key], rel)
            if name in ("y", "dx"):
                err = max(err, e)
            if rel > tol:
                raise AssertionError(
                    f"fused_bn kernel disagrees with its plain version at "
                    f"{tuple(x.shape)} {x.dtype}: {name} err {e} of {top}")
        return (y, m, v, dx, dg, db), err

    counts = resnet_bn_maps(RESNET_BATCH)
    shapes = list(counts)
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(rows, c, dt, 0) for rows, c in shapes + BN_EDGE
             for dt in dtypes]
    cases += [(3001, 64, dt, 1) for dt in dtypes]  # unaligned: scalar path
    foreign = foreign_bn_maps()
    if sum(foreign.values()) != RESNET_BN + 3 + 4:
        raise AssertionError(f"foreign phase: {sum(foreign.values())} "
                             f"batch norms")
    foreign_shapes = [k for k in foreign if k not in counts]
    cases += [(rows, c, torch.float32, 0) for rows, c in foreign_shapes]
    for rows, c, dt, offset in cases:
        check(*bn_inputs(gen, rows, c, dt, offset))
    # no atomics: one input, identical bits
    for rows, c in (shapes[0], shapes[-1]):
        inputs = bn_inputs(gen, rows, c, torch.bfloat16)
        first, _ = check(*inputs)
        again, _ = check(*inputs)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"fused_bn: two runs at {(rows, c)} differ")

    timings = []
    last_stage = max((s for s in shapes if s[0] == shapes[-1][0]),
                     key=lambda s: s[1])
    most_norms = max(counts, key=counts.get)  # 25,088 x 256: 11 of 53
    for label, (rows, c) in (("stem", shapes[0]), ("most_norms", most_norms),
                             ("stage3", last_stage)):
        for dt in dtypes:
            x, g, b, dy, dm, dv = bn_inputs(gen, rows, c, dt)
            _, err = check(x, g, b, dy, dm, dv)
            y, m, v = bn.bn_train_fwd(x, g, b, eps)
            # F.batch_norm's yardstick on the same map as a channels_last
            # NCHW tensor (training mode, its own statistics)
            hw = rows // RESNET_BATCH
            side = int(math.isqrt(hw))
            x4 = x.view(RESNET_BATCH, side, side, c).permute(0, 3, 1, 2)
            lib_in = x4.detach().requires_grad_()
            lib_w, lib_b = (t.detach().requires_grad_() for t in (g, b))
            run_m, run_v = torch.zeros(c, device="cuda"), \
                torch.ones(c, device="cuda")

            def lib_fwd():
                return torch.nn.functional.batch_norm(
                    lib_in, run_m, run_v, lib_w, lib_b, training=True,
                    momentum=0.01, eps=eps)

            lib_out = lib_fwd()
            dy4 = dy.view(RESNET_BATCH, side, side, c).permute(0, 3, 1, 2)
            for direction, kernel, plain, library in (
                    ("fwd", lambda: bn.bn_train_fwd(x, g, b, eps),
                     lambda: bn.bn_train_fwd_reference(x, g, b, eps),
                     lambda: torch.nn.functional.batch_norm(
                         x4, run_m, run_v, g, b, training=True,
                         momentum=0.01, eps=eps)),
                    ("bwd",
                     lambda: bn.bn_train_bwd(x, g, m, v, dy, dm, dv, eps),
                     lambda: bn.bn_train_bwd_reference(x, g, m, v, dy, dm,
                                                       dv, eps),
                     lambda: torch.autograd.grad(
                         lib_out, (lib_in, lib_w, lib_b), dy4,
                         retain_graph=True))):
                ms, plain_ms, library_ms = (cuda_ms(f, iters=10)
                                            for f in (kernel, plain, library))
                dev_ms, plain_dev_ms, library_dev_ms = (
                    device_ms(f, iters=10) for f in (kernel, plain, library))
                bound_ms, bound_by = bn_bound(rows, c, x.element_size(),
                                              direction)
                timings.append({
                    "kernel": BN_KERNEL, "direction": direction,
                    "shape": label, "rows": rows, "c": c,
                    "dtype": str(dt).replace("torch.", ""),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "device_ms": dev_ms,
                    "plain_device_ms": plain_dev_ms,
                    "library_device_ms": library_dev_ms,
                    "library": "F.batch_norm(training=True), channels_last",
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "device_share_of_bound": bound_ms / dev_ms})
            del lib_in, lib_out, x, dy, x4, dy4, y
    # the foreign path's f32 maps: device time of each direction against
    # F.batch_norm over the same [rows, C] map (training mode) and its
    # autograd.grad, beside the bound
    foreign_timings = []
    for rows, c in foreign_shapes:
        x, g, b, dy, dm, dv = bn_inputs(gen, rows, c, torch.float32)
        m, v = bn.bn_train_fwd(x, g, b, eps)[1:]
        lib_in = x.detach().requires_grad_()
        lib_w, lib_b = (t.detach().requires_grad_() for t in (g, b))
        run_m, run_v = torch.zeros(c, device="cuda"), \
            torch.ones(c, device="cuda")
        lib_out = torch.nn.functional.batch_norm(
            lib_in, run_m, run_v, lib_w, lib_b, training=True,
            momentum=0.01, eps=eps)
        row = {"rows": rows, "c": c, "norms": foreign[(rows, c)]}
        for direction, kernel, library in (
                ("fwd", lambda: bn.bn_train_fwd(x, g, b, eps),
                 lambda: torch.nn.functional.batch_norm(
                     x, run_m, run_v, g, b, training=True, momentum=0.01,
                     eps=eps)),
                ("bwd", lambda: bn.bn_train_bwd(x, g, m, v, dy, dm, dv, eps),
                 lambda: torch.autograd.grad(
                     lib_out, (lib_in, lib_w, lib_b), dy,
                     retain_graph=True))):
            bound_ms, bound_by = bn_bound(rows, c, 4, direction)
            row[direction] = {
                "device_ms": device_ms(kernel, iters=10),
                "library_device_ms": device_ms(library, iters=10),
                "bound_ms": bound_ms, "bound_by": bound_by}
        foreign_timings.append(row)
        del x, dy, lib_in, lib_out
    res = {"phase": "fused_bn", "cases": len(cases),
           "resnet50_shapes_batch128": shapes,
           "resnet50_norms_by_shape": [[*k, n] for k, n in counts.items()],
           "foreign_f32_norms_by_shape": [[*k, n]
                                          for k, n in foreign.items()],
           "foreign_f32_shapes_checked": foreign_shapes,
           "foreign_f32_timings": foreign_timings,
           "card": nvidia_smi(),
           "edge_shapes": BN_EDGE,
           "worst": worst,
           "tolerances": {"f32_rel_to_max1": TOL_BN_F32,
                          "bf16_rel_to_max": TOL_BN_BF16_REL,
                          "stats_rel_to_max1": TOL_BN_STATS},
           "repeat_bitwise_identical": True, "timings": timings}
    emit(res)
    return res


def read_bn_counts(bn, what: str, **per_pass: int) -> dict:
    """The fused batch-norm launch counts since ``reset_launches``: each
    pass of the dtypes named in ``per_pass`` (``bf16=20`` means 20 steps)
    ``RESNET_BN`` times a step, no other."""
    counts = dict(bn.KERNEL_LAUNCHES)
    want = {name: RESNET_BN * per_pass.get(name.rsplit("_", 1)[1], 0)
            for name in counts}
    if counts != want:
        raise AssertionError(f"{what}: fused_bn launches {counts}; want "
                             f"{want}")
    return counts


def phase_resnet_train(bn) -> dict:
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.data import as_feed
    from analytics_zoo_tpu_torch.nn import BatchNormalization
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    t0 = time.perf_counter()
    variables = {norm: random_resnet_variables(TrainNet(norm=norm), SEED)
                 for norm in ("batch", "nf")}
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 4)

    def model(norm="batch", plain=False, **kw):
        m = TrainNet(norm=norm, **kw)
        m.load_state_dict(from_jax_variables(variables[norm]), strict=True)
        if plain:  # the yardstick: the plain batch norm on the card
            for layer in m.modules():
                if isinstance(layer, BatchNormalization):
                    layer.train_fn = bn.bn_train_plain
        return m.cuda()

    def images(n):
        return (rng.integers(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8),
                rng.integers(0, RESNET["class_num"], n).astype(np.int32))

    loss_name = "sparse_categorical_crossentropy"

    def estimator(m, graphs=False):
        return Estimator.from_keras(m, loss=loss_name, optimizer="sgd",
                                    learning_rate=RESNET_LR, seed=SEED,
                                    cuda_graphs=graphs)

    # (a) f32, batch 8: the fused kernels and the plain batch norm, each in
    # an f32 model on the card, against a float64 model (textbook batch
    # norm through autograd).  This model's f32 gradients at a random init
    # carry percents of rounding noise however they are summed (train-mode
    # batch norm's backward subtracts per-channel projections that nearly
    # cancel; f32 vs f64 on the CPU: 2% at the stem, 15% in stage 3), so
    # the fused model is held to the plain one's distance from float64,
    # not to the plain f32 model itself
    xa, ya = images(RESNET_CHECK_BATCH)
    xt, yt = torch.from_numpy(xa).cuda(), torch.from_numpy(ya).cuda()
    grads, buffers, losses0 = {}, {}, {}
    for kind in ("fused", "plain", "f64"):
        if kind == "f64":
            m = model(dtype="float32", input_dtype=torch.float64).double()
            for layer in m.modules():
                if isinstance(layer, BatchNormalization):
                    layer.train_fn = bn_textbook
        else:
            m = model(plain=kind == "plain", dtype="float32")
        bn.reset_launches()
        out = m.train()(xt).double()
        loss = (torch.logsumexp(out, dim=-1)
                - out.gather(1, yt.long()[:, None])[:, 0]).mean()
        names = [n for n, _ in m.named_parameters()]
        grads[kind] = dict(zip(names, torch.autograd.grad(
            loss, list(m.parameters()))))
        read_bn_counts(bn, f"resnet_train {kind} gradients",
                       **({"f32": 1} if kind == "fused" else {}))
        buffers[kind] = {k: b.clone() for k, b in m.named_buffers()}
        losses0[kind] = float(loss.detach())
        del m, loss, out
    noise = {}
    for kind in ("fused", "plain"):
        noise[kind] = max(
            (grads[kind][n].double() - g).abs().max().item()
            / max(g.abs().max().item(), 1e-30)
            for n, g in grads["f64"].items())
    if noise["fused"] > RESNET_NOISE_FACTOR * noise["plain"] + TOL_TRAIN_GRAD:
        raise AssertionError(
            f"resnet_train f32: the fused model's gradients lie {noise} of "
            f"each tensor's max from float64, the plain model's "
            f"{noise['plain']}")
    worst_buf = 0.0
    for name, ref in buffers["plain"].items():
        err = (buffers["fused"][name] - ref).abs().max().item()
        top = ref.abs().max().item()
        worst_buf = max(worst_buf, err / top)
        if err > TOL_TRAIN_GRAD * top:
            raise AssertionError(f"resnet_train f32: running statistic "
                                 f"{name} differs by {err} of max {top}")
    del grads, buffers
    # 3 steps over 3 distinct batches at a small learning rate: at 0.1 the
    # second step's loss is chaotic in the gradients' rounding noise, and
    # at 1e-4 that noise still moved it by 7.7e-5 on an H100
    x3, y3 = images(RESNET_CHECK_BATCH * CHECK_STEPS)
    hist = {}
    for plain in (False, True):
        est = Estimator.from_keras(model(plain=plain, dtype="float32"),
                                   loss=loss_name, optimizer="sgd",
                                   learning_rate=RESNET_CHECK_LR, seed=SEED,
                                   cuda_graphs=False)
        hist[plain], _ = record_steps(est)
        bn.reset_launches()
        est.fit((x3, y3), epochs=1, batch_size=RESNET_CHECK_BATCH,
                verbose=False)
        counts = read_bn_counts(bn, "resnet_train f32 fit",
                                **({} if plain else {"f32": CHECK_STEPS}))
        if not plain:
            f32_launches = counts
        del est
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(hist[False], hist[True]))
    if loss_err > TOL_TRAIN_LOSS or not all(map(math.isfinite, hist[False])):
        raise AssertionError(f"resnet_train f32: loss history {hist[False]}"
                             f" (fused) vs {hist[True]} (plain)")
    f32_check = {"batch": RESNET_CHECK_BATCH, "steps": CHECK_STEPS,
                 "grad_worst_rel_to_tensor_max_vs_f64": noise,
                 "grad_noise_factor": RESNET_NOISE_FACTOR,
                 "grad_tol": TOL_TRAIN_GRAD, "first_loss": losses0,
                 "running_stats_worst_rel_to_tensor_max": worst_buf,
                 "fit_learning_rate": RESNET_CHECK_LR,
                 "loss_fused": hist[False], "loss_plain": hist[True],
                 "loss_worst_rel": loss_err, "loss_tol": TOL_TRAIN_LOSS,
                 "launches": f32_launches}

    # (b) bench.py's recipe, norm="batch", bf16: 20 steps of batch 128
    x, y = images(RESNET_POOL)
    steps = RESNET_EPOCHS * (RESNET_POOL // RESNET_BATCH)
    runs = {}
    for norm in ("batch", "nf"):
        est = estimator(model(norm, dtype="bfloat16"))
        inner = est._train_step
        step_losses, step_ms = record_steps(est)
        bn.reset_launches()
        t0 = time.perf_counter()
        losses = est.fit((x, y), epochs=RESNET_EPOCHS,
                         batch_size=RESNET_BATCH, verbose=False)["loss"]
        fit_s = time.perf_counter() - t0
        launches = read_bn_counts(bn, f"resnet_train {norm}",
                                  **({"bf16": steps} if norm == "batch"
                                     else {}))
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"resnet_train {norm}: loss {losses}")
        if norm == "batch" and losses[-1] > LOSS_FALL * losses[0]:
            raise AssertionError(f"resnet_train batch: loss {losses} did "
                                 f"not fall to {LOSS_FALL} of its first "
                                 f"epoch")
        p50 = float(np.median(step_ms[-10:]))
        batch = next(as_feed((x, y), RESNET_BATCH, seed=SEED).epoch(
            est.device, 0))
        flops = model_flops_per_image(est.model, batch["x"][:1])
        profiled = profile_call(lambda: inner(batch), {
            "batch_norm": ("bn_fwd_kernel", "bn_bwd_kernel")})
        # the profiler slows the host, so beside its own idle share the
        # card's busy time is also set against the unprofiled step p50
        profiled["idle_share_of_p50_step"] = 1.0 - \
            profiled["device_busy_ms"] / p50
        runs[norm] = {
            "loss": losses, "step_losses": step_losses, "fit_s": fit_s,
            "launches": launches, "step_ms_last10": step_ms[-10:],
            "step_ms_p50": p50, "images_per_s": RESNET_BATCH / (p50 / 1e3),
            "forward_gflop_per_image": flops / 1e9,
            "model_tflop_per_s": 3 * flops * RESNET_BATCH / p50 / 1e9,
            "profiled_step": profiled}
        if norm == "batch":
            x_eval, y_eval = images(5)
            x_eval = np.concatenate([x, x_eval])
            y_eval = np.concatenate([y, y_eval])
            evaluated = est.evaluate((x_eval, y_eval),
                                     batch_size=RESNET_BATCH)
            pred = est.predict(x_eval, batch_size=RESNET_BATCH)
            if pred.shape != (len(x_eval), RESNET["class_num"]) \
                    or not np.isfinite(pred).all() \
                    or not math.isfinite(evaluated["loss"]):
                raise AssertionError(f"resnet_train: predict gave "
                                     f"{pred.shape}, evaluate {evaluated}")
            runs[norm]["evaluate"] = evaluated
            runs[norm]["predict_rows"] = int(pred.shape[0])
        del est, inner
        torch.cuda.empty_cache()
        if norm == "batch":
            # one seed, one loss history: two more fits from the same
            # weights with cuDNN's deterministic algorithms (its default
            # weight-gradient algorithms may add in another order from run
            # to run; the batch-norm kernels use no atomics) must give
            # identical step losses; the default fit's distance from them
            # is reported
            torch.backends.cudnn.deterministic = True
            repeats = []
            for _ in range(2):
                again = estimator(model(norm, dtype="bfloat16"))
                repeats.append(record_steps(again)[0])
                again.fit((x, y), epochs=RESNET_EPOCHS,
                          batch_size=RESNET_BATCH, verbose=False)
                del again
                torch.cuda.empty_cache()
            torch.backends.cudnn.deterministic = False
            if repeats[0] != repeats[1]:
                raise AssertionError(
                    f"resnet_train: two deterministic fits with seed {SEED} "
                    f"gave step losses {repeats[0]} and {repeats[1]}")
            runs[norm]["repeat_identical"] = True
            runs[norm]["default_vs_deterministic_worst_rel"] = max(
                abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(step_losses, repeats[0]))
    captured = resnet_captured(bn, model, estimator, x, y, runs)
    res = {"phase": "resnet_train", "config": RESNET, "image": IMAGE,
           "dtype": "bfloat16", "optimizer": "sgd",
           "learning_rate": RESNET_LR, "global_batch": RESNET_BATCH,
           "pool": RESNET_POOL, "epochs": RESNET_EPOCHS, "steps": steps,
           "setup_s": setup_s, "loss_fall_limit": LOSS_FALL,
           "flop_convention": "3 x forward FLOP of the convs and the dense "
                              "head from their shapes (2 x outputs x fan "
                              "in; the space-to-depth stem as its 7x7 "
                              "conv); batch norm, relu, pooling, loss and "
                              "optimizer not counted",
           "batch": runs["batch"], "nf": runs["nf"], "f32_check": f32_check,
           "captured": captured}
    emit(res)
    return res


def resnet_captured(bn, model, estimator, pool, labels, runs) -> dict:
    """resnet_train (d): bench.py's ``bench_resnet50`` from CUDA graphs,
    both norms.  The step losses of ``_multi_step(b0, 5)`` against the
    eager step's under cuDNN's deterministic algorithms (its default
    weight-gradient algorithms may sum in another order from run to run);
    then, with the default algorithms, the eager window of 20 steps and
    the captured one after a warm call, three times (bench.py's 20 x 3),
    53 launches of each batch-norm kernel a step counted from the
    replays, a profiled window, peak memory; and the streaming phase:
    worker processes (forked after this process made its CUDA context)
    decode the seeded pool with random flips into shared-memory slots,
    ``_multi_step_data`` over 4 chunks of 5, then over 8 on a fresh
    feed."""
    from analytics_zoo_tpu_torch.data import StreamingDataFeed, as_feed

    b0 = next(as_feed((pool[:RESNET_BATCH], labels[:RESNET_BATCH]),
                      RESNET_BATCH, shuffle=False).epoch(
                          torch.device("cuda"), 0))
    steps, repeats = RESNET_RESIDENT
    chunk_steps, n_chunks = RESNET_STREAM
    n_workers = max(4, min(16, os.cpu_count() or 8))

    def load_sample(i, rng=None):  # bench_resnet50's loader
        r = rng if rng is not None else np.random.default_rng(i)
        j = int(r.integers(0, len(pool)))
        img = pool[j]
        if r.integers(0, 2):
            img = img[:, ::-1]  # horizontal flip
        return {"x": np.ascontiguousarray(img), "y": np.int32(labels[j])}

    out = {"fork": fork_probe()}
    for norm in ("batch", "nf"):
        per_step = {"bf16": 1} if norm == "batch" else {}
        torch.backends.cudnn.deterministic = True
        cmp = {}
        for graphs in (False, True):
            e = estimator(model(norm, dtype="bfloat16"), graphs)
            cmp[graphs] = e._multi_step(b0, RESNET_CMP_STEPS).tolist()
            del e
            torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False
        against = losses_against_eager(cmp[True], cmp[False],
                                       f"resnet_train (d) {norm}")
        e = estimator(model(norm, dtype="bfloat16"))
        float(e._multi_step(b0, 1)[-1])  # warm: state, cuDNN's plans
        eager_ms, _ = window_ms(lambda: e._multi_step(b0, steps), steps)
        del e
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        est = estimator(model(norm, dtype="bfloat16"), True)
        warm_ms, _ = window_ms(lambda: est._multi_step(b0, steps), steps)
        bn.reset_launches()
        windows = [window_ms(lambda: est._multi_step(b0, steps), steps)[0]
                   for _ in range(repeats)]
        launches = read_bn_counts(
            bn, f"resnet_train (d) {norm}",
            **{k: v * steps * repeats for k, v in per_step.items()})
        profiled = profiled_window(
            lambda: est._multi_step(b0, 5), 5,
            {"batch_norm": ("bn_fwd_kernel", "bn_bwd_kernel")})
        peak = torch.cuda.max_memory_allocated()
        bn.reset_launches()
        feed = StreamingDataFeed(
            num_samples=(n_chunks + 2) * chunk_steps * RESNET_BATCH,
            load_sample=load_sample, batch_size=RESNET_BATCH, shuffle=False,
            num_workers=n_workers, prefetch_batches=STREAM_PREFETCH,
            workers="process")
        stream = stream_chunks(est, feed, chunk_steps, n_chunks)
        stream["launches"] = read_bn_counts(
            bn, f"resnet_train (d) {norm} streaming",
            **{k: v * chunk_steps * (n_chunks + 1)
               for k, v in per_step.items()})
        # twice the chunks on a fresh feed: do the chunks after the
        # decoders' first pass keep the card's pace?
        long = stream_chunks(est, StreamingDataFeed(
            num_samples=(2 * n_chunks + 2) * chunk_steps * RESNET_BATCH,
            load_sample=load_sample, batch_size=RESNET_BATCH, shuffle=False,
            num_workers=n_workers, prefetch_batches=STREAM_PREFETCH,
            workers="process"), chunk_steps, 2 * n_chunks)
        stream["long_window"] = {
            k: long[k] for k in ("chunks", "step_ms", "host_feed_ms_per_chunk",
                                 "host_call_ms_per_chunk")}
        caps = captures(est, f"resnet_train (d) {norm}")
        del est
        torch.cuda.empty_cache()
        ms = float(np.median(windows))
        idle_of(profiled, ms)
        flops = runs[norm]["forward_gflop_per_image"] * 1e9
        stream["vs_resident"] = stream["step_ms"] / ms
        stream["long_window"]["vs_resident"] = \
            stream["long_window"]["step_ms"] / ms
        stream["within_bench_acceptance"] = \
            stream["step_ms"] <= (1 + STREAM_WITHIN) * ms
        out[norm] = {
            "losses_against_eager": against, "warm_window_step_ms": warm_ms,
            "window_step_ms": windows, "step_ms": ms,
            "eager_step_ms": eager_ms,
            "eager_step_ms_p50_b": runs[norm]["step_ms_p50"],
            "images_per_s": RESNET_BATCH / (ms / 1e3),
            "model_tflop_per_s": 3 * flops * RESNET_BATCH / ms / 1e9,
            "launches": launches, "profiled": profiled,
            "peak_memory_bytes": peak, "streaming": stream, **caps}
    return out


def xent_inputs(gen, n, d, v, dtype, w_dtype=torch.float32, scale=1.0,
                flat_row=False):
    """h (scaled by ``scale``), w, bias and labels on the card, labels 0
    and V-1 at the first and last tokens; with ``flat_row`` token 1's
    logits are all equal (h row 0, zero bias)."""
    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    h = r(n, d) * scale
    bias = r(v) * 0.1
    if flat_row:
        h[1] = 0.0
        bias.zero_()
    labels = torch.randint(0, v, (n,), device="cuda", generator=gen)
    labels[0], labels[-1] = 0, v - 1
    return h.to(dtype), (r(d, v) * 0.05).to(w_dtype), bias, labels


def xent_bound(n, d, v, h_size, w_size, direction, fma=False) -> tuple:
    """(ms, "bytes"|"operations") of the head's loss: 2NDV FLOP forward,
    6NDV backward (the logits recomputed, then dh and dW), at the
    activation dtype's peak; h, w, bias, labels read once and lse/loss
    (forward) or dh, dW, db (backward) written once."""
    flops = (2.0 if direction == "fwd" else 6.0) * n * d * v
    nbytes = n * d * h_size + d * v * w_size + 4 * v + 8 * n + 4 * n
    if direction == "bwd":
        nbytes += n * d * h_size + d * v * w_size + 4 * v
    return bound(flops, nbytes, h_size, fma)


def phase_fused_xent(fx) -> dict:
    """The fused softmax cross-entropy kernels against their plain versions
    (loss, lse, dh, dW, db) at the recipe's head shape and ragged ones,
    f32 and bf16, labels at 0 and V-1, a row of equal logits, logits of
    1e2 x the scale; identical bits on repeat; then times at the recipe's
    shape beside the bound, the plain version and the library's
    ``F.cross_entropy`` over materialised logits."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    worst = {"loss": 0.0, "f32": 0.0, "bf16_dh": 0.0, "bf16_sums": 0.0}
    d, v = MLM["d_model"], MLM["vocab"]
    n = MLM_MICRO * SEQ

    def check(h, w, bias, labels, chunk):
        g = torch.tensor(1.0, device="cuda")
        loss, lse = fx.fused_xent_fwd(h, w, bias, labels, chunk)
        got = (loss, lse) + fx.fused_xent_bwd(h, w, bias, labels, lse, g,
                                              chunk)
        rloss, rlse = fx.fused_xent_reference(h, w, bias, labels, chunk)
        ref = (rloss, rlse) + fx.fused_xent_bwd_reference(
            h, w, bias, labels, rlse, g, chunk)
        torch.cuda.synchronize()
        err = 0.0
        for name, a, b in zip(("loss", "lse", "dh", "dw", "db"), got, ref):
            if a.shape != b.shape or a.dtype != b.dtype \
                    or not torch.isfinite(a).all():
                raise AssertionError(f"fused_xent {name}: {tuple(a.shape)} "
                                     f"{a.dtype} at {tuple(h.shape)} V {v}")
            e = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            if name in ("loss", "lse"):
                rel = e / max(1.0, top)
                tol, key = TOL_XENT_LOSS, "loss"
            elif h.dtype == torch.float32:
                rel, tol, key = e / max(top, 1e-30), TOL_XENT_F32, "f32"
            elif name == "dh" or a.dtype == torch.bfloat16:
                rel, tol, key = e / max(top, 1e-30), TOL_XENT_BF16_DH, \
                    "bf16_dh"
            else:
                rel, tol, key = e / max(top, 1e-30), TOL_XENT_BF16_SUM, \
                    "bf16_sums"
            worst[key] = max(worst[key], rel)
            err = max(err, e)
            if rel > tol:
                raise AssertionError(
                    f"fused_xent kernel disagrees with its plain version at "
                    f"{tuple(h.shape)} V {w.shape[1]} {h.dtype} w "
                    f"{w.dtype}: {name} err {e} of {top}")
        return got, err

    dtypes = (torch.float32, torch.bfloat16)
    cases = [(n, d, v, MLM_CHUNK, dt, torch.float32, {}) for dt in dtypes]
    cases += [(n, d, v, MLM_CHUNK, torch.bfloat16, torch.bfloat16, {})]
    cases += [(nn_, dd, vv, ch, dt, torch.float32, {})
              for nn_, dd, vv, ch in XENT_EDGE for dt in dtypes]
    cases += [(300, 40, 777, 100, torch.bfloat16, torch.bfloat16, {})]
    cases += [(512, 96, 3001, 128, dt, torch.float32, kw) for dt in dtypes
              for kw in ({"flat_row": True}, {"scale": 100.0})]
    for nn_, dd, vv, ch, dt, wdt, kw in cases:
        check(*xent_inputs(gen, nn_, dd, vv, dt, wdt, **kw), ch)
    # no atomics: one input, identical bits
    for dt in dtypes:
        inputs = xent_inputs(gen, n, d, v, dt, scale=100.0)
        first, _ = check(*inputs, MLM_CHUNK)
        again, _ = check(*inputs, MLM_CHUNK)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"fused_xent: two runs at {dt} differ")

    # times at the recipe's shape: bf16 activations with the f32 head
    # kernel (the recipe's), and f32
    timings = []
    for dt in dtypes:
        h, w, bias, labels = xent_inputs(gen, n, d, v, dt)
        _, err = check(h, w, bias, labels, MLM_CHUNK)
        loss, lse = fx.fused_xent_fwd(h, w, bias, labels, MLM_CHUNK)
        g = torch.tensor(1.0, device="cuda")
        lib_h, lib_w, lib_b = (t.detach().requires_grad_()
                               for t in (h, w, bias))

        def lib_fwd():
            return torch.nn.functional.cross_entropy(
                lib_h @ lib_w.to(dt) + lib_b, labels)

        lib_out = lib_fwd()
        for direction, kernel, plain, library in (
                ("fwd",
                 lambda: fx.fused_xent_fwd(h, w, bias, labels, MLM_CHUNK),
                 lambda: fx.fused_xent_reference(h, w, bias, labels,
                                                 MLM_CHUNK),
                 lib_fwd),
                ("bwd",
                 lambda: fx.fused_xent_bwd(h, w, bias, labels, lse, g,
                                           MLM_CHUNK),
                 lambda: fx.fused_xent_bwd_reference(h, w, bias, labels, lse,
                                                     g, MLM_CHUNK),
                 lambda: torch.autograd.grad(lib_out, (lib_h, lib_w, lib_b),
                                             retain_graph=True))):
            ms, plain_ms, library_ms = (cuda_ms(f, iters=10)
                                        for f in (kernel, plain, library))
            dev_ms, plain_dev_ms, library_dev_ms = (
                device_ms(f, iters=10) for f in (kernel, plain, library))
            bound_ms, bound_by = xent_bound(n, d, v, h.element_size(),
                                            w.element_size(), direction)
            fma_ms = xent_bound(n, d, v, 4, w.element_size(), direction,
                                fma=True)[0] if dt == torch.float32 else None
            timings.append({
                "kernel": XENT_KERNEL, "direction": direction, "n": n,
                "design": fx.bwd_design(dt) if direction == "bwd"
                else fx.fwd_design(dt),
                "d": d, "v": v, "chunk": MLM_CHUNK,
                "dtype": str(dt).replace("torch.", ""),
                "w_dtype": str(w.dtype).replace("torch.", ""),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "device_ms": dev_ms,
                "plain_device_ms": plain_dev_ms,
                "library_device_ms": library_dev_ms,
                "library": "F.cross_entropy(h @ w.to(h.dtype) + b, labels)"
                           + (" and its autograd.grad over (h, w, b)"
                              if direction == "bwd" else ""),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "fma_bound_ms": fma_ms,
                "device_share_of_bound": bound_ms / dev_ms})
        del lib_h, lib_w, lib_b, lib_out, h, w
        torch.cuda.empty_cache()
    res = {"phase": "fused_xent", "cases": len(cases) + 2 * len(dtypes),
           "edge_shapes": XENT_EDGE, "worst": worst,
           "tolerances": {"loss_lse_rel_to_max1": TOL_XENT_LOSS,
                          "f32_rel_to_max": TOL_XENT_F32,
                          "bf16_dh_rel_to_max": TOL_XENT_BF16_DH,
                          "bf16_dw_db_rel_to_max": TOL_XENT_BF16_SUM},
           "repeat_bitwise_identical": True, "timings": timings}
    emit(res)
    return res


class MlmEncoder(torch.nn.Module):
    """bench.py's ``bench_bert`` ``Encoder`` at BERT-base width, in the JAX
    tree's names (``tok/embeddings``, ``pos``, ``block{i}/...``,
    ``head/kernel``, ``head/bias``): the token embedding plus ``pos`` in
    ``dtype``, ``layers`` post-LN ``TransformerLayer``s with
    ``remat_attention=True``, then the vocab head: applied (``fused=False``,
    logits for ``sparse_categorical_crossentropy``) or handed to the loss as
    ``(h, head.kernel, head.bias)`` for ``fused_softmax_xent``.
    ``flash=True`` puts the flash-attention kernels in the blocks' attention
    (no remat: the flash core keeps no attention map); ``cfg`` and ``seq``
    (``MLM``'s and ``SEQ`` by default) size it."""

    def __init__(self, layers, dtype, fused, flash=False, cfg=None,
                 seq=SEQ):
        super().__init__()
        from analytics_zoo_tpu_torch import nn as tnn
        cfg = cfg or MLM
        d, v = cfg["d_model"], cfg["vocab"]
        self.dtype, self.fused = dtype, fused
        self.tok = tnn.Embedding(v, d)
        self.pos = torch.nn.Parameter(torch.empty(1, seq, d))
        self.blocks = [f"block{i}" for i in range(layers)]
        for name in self.blocks:
            self.add_module(name, tnn.TransformerLayer(
                d, cfg["heads"], use_flash=flash,
                remat_attention=not flash))
        self.head = tnn.Dense(d, v)

    def forward(self, ids):
        x = (self.tok(ids) + self.pos).to(self.dtype)
        for name in self.blocks:
            x = getattr(self, name)(x)
        if self.fused:
            return x, self.head.kernel, self.head.bias
        return self.head(x)


def mlm_loss(fused, chunk=MLM_CHUNK):
    """The recipe's loss: per-token sparse cross-entropy on the logits, or
    the same function through ``fused_softmax_xent`` (a loss callable)."""
    if not fused:
        return "sparse_categorical_crossentropy"
    from analytics_zoo_tpu_torch.ops import fused_softmax_xent

    def loss(out, y):
        return fused_softmax_xent(out[0], out[1], y, chunk, bias=out[2])

    return loss


def mlm_flops_per_token(layers) -> tuple:
    """(forward FLOP per token of the encoder and the head, the recompute's
    FLOP per token): the encoder as ``bert_flops_per_token`` at ``layers``
    layers, the head's 2 D V, and remat_attention's second pass over the two
    attention products (4 SEQ D a layer)."""
    d = MLM["d_model"]
    encoder = layers * (2.0 * 12 * d * d + 4.0 * SEQ * d)
    return encoder + 2.0 * d * MLM["vocab"], layers * 4.0 * SEQ * d


def read_xent_counts(fx, what, **per_dtype) -> dict:
    """The fused_xent launch counts since ``reset_launches``: every pass of
    the dtypes in ``per_dtype`` that many times, no other."""
    counts = dict(fx.KERNEL_LAUNCHES)
    want = {name: per_dtype.get(name.rsplit("_", 1)[1], 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{what}: fused_xent launches {counts}; want "
                             f"{want}")
    return counts


def read_xent_designs(fx, what, fwd=None, bwd=None, calls=0) -> tuple:
    """The fused_xent calls of each direction by design since
    ``reset_launches``, (forward's, backward's): ``calls`` of ``fwd`` and
    of ``bwd``, none of another design."""
    got = []
    for direction, counts, designs, design in (
            ("forward", fx.FWD_LAUNCHES, fx.FWD_DESIGNS, fwd),
            ("backward", fx.BWD_LAUNCHES, fx.BWD_DESIGNS, bwd)):
        want = dict.fromkeys(designs, 0)
        if design is not None:
            want[design] = calls
        if counts != want:
            raise AssertionError(f"{what}: fused_xent {direction} calls by "
                                 f"design {counts}; want {want}")
        got.append(dict(counts))
    return tuple(got)


def phase_bert_mlm_train(fa, fx) -> dict:
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.data import as_feed
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    t0 = time.perf_counter()
    states = {layers: from_jax_variables(random_bert_variables(
        MlmEncoder(layers, torch.float32, False), SEED))
        for layers in (MLM_CHECK_LAYERS, MLM["layers"])}
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    vocab = MLM["vocab"]

    def model(layers, dtype, fused):
        m = MlmEncoder(layers, dtype, fused)
        m.load_state_dict(states[layers], strict=True)
        return m.cuda()

    def estimator(m, fused, accum, graphs=False):
        return Estimator.from_keras(m, loss=mlm_loss(fused), optimizer="adamw",
                                    learning_rate=TRAIN_LR, seed=SEED,
                                    grad_accum=accum, cuda_graphs=graphs)

    def tokens(rows):
        return (rng.integers(0, vocab, (rows, SEQ)).astype(np.int32),
                rng.integers(0, vocab, (rows, SEQ)).astype(np.int32))

    # (a) f32, 2 layers at full width: the plain and the fused head's
    # gradients on one micro-batch, then 3 steps of global batch 8 =
    # grad_accum 2 x 4 each
    xa, ya = tokens(MLM_MICRO)
    xt, yt = torch.from_numpy(xa).cuda(), torch.from_numpy(ya).cuda()
    grads, loss0 = {}, {}
    for fused in (False, True):
        m = model(MLM_CHECK_LAYERS, torch.float32, fused).train()
        est = estimator(m, fused, 1)
        names = [k for k, _ in m.named_parameters()]
        loss = est.loss_fn(m(xt), yt)
        grads[fused] = dict(zip(names, torch.autograd.grad(
            loss, list(m.parameters()), allow_unused=True)))
        loss0[fused] = float(loss.detach())
        del m, est, loss
    worst_rel, worst_head = 0.0, 0.0
    for name, ref in grads[False].items():
        got = grads[True][name]
        if ref is None or got is None:
            raise AssertionError(f"bert_mlm_train f32: no gradient of {name}")
        top = ref.abs().max().item()
        if top == 0.0:  # embedding rows of absent tokens
            continue
        rel = (got - ref).abs().max().item() / top
        worst_rel = max(worst_rel, rel)
        if name.startswith("head."):
            worst_head = max(worst_head, rel)
        if rel > TOL_TRAIN_GRAD:
            raise AssertionError(f"bert_mlm_train f32: {name}'s gradient "
                                 f"differs by {rel} of its max (fused vs "
                                 f"plain head)")
    del grads
    x3, y3 = tokens(MLM_MICRO * MLM_CHECK_ACCUM * CHECK_STEPS)
    hist = {}
    for fused in (False, True):
        est = estimator(model(MLM_CHECK_LAYERS, torch.float32, fused), fused,
                        MLM_CHECK_ACCUM)
        hist[fused], _ = record_steps(est)
        fx.reset_launches()
        est.fit((x3, y3), epochs=1, batch_size=MLM_MICRO * MLM_CHECK_ACCUM,
                verbose=False)
        calls = MLM_CHECK_ACCUM * CHECK_STEPS
        counts = read_xent_counts(fx, "bert_mlm_train f32",
                                  **({"f32": calls} if fused else {}))
        designs = read_xent_designs(
            fx, "bert_mlm_train f32",
            **(dict(fwd="scalar", bwd="wgmma_tf32", calls=calls) if fused
               else {}))
        if fused:
            f32_launches, f32_designs = counts, designs
        del est
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(hist[True], hist[False]))
    if loss_err > TOL_TRAIN_LOSS or not all(map(math.isfinite, hist[True])):
        raise AssertionError(f"bert_mlm_train f32: loss history {hist[True]}"
                             f" (fused head) vs {hist[False]} (plain)")
    f32_check = {"layers": MLM_CHECK_LAYERS, "micro_batch": MLM_MICRO,
                 "grad_accum": MLM_CHECK_ACCUM, "steps": CHECK_STEPS,
                 "first_loss": {"plain": loss0[False], "fused": loss0[True]},
                 "grad_worst_rel_to_tensor_max": worst_rel,
                 "head_grad_worst_rel_to_tensor_max": worst_head,
                 "grad_tol": TOL_TRAIN_GRAD, "loss_plain": hist[False],
                 "loss_fused": hist[True], "loss_worst_rel": loss_err,
                 "loss_tol": TOL_TRAIN_LOSS, "launches": f32_launches,
                 "fwd_launches_by_design": f32_designs[0],
                 "bwd_launches_by_design": f32_designs[1]}
    torch.cuda.empty_cache()

    # (b) plain head and (c) fused head: bench.py's recipe, bf16, 12
    # layers, global batch 32 = grad_accum 8 x 4, 10 steps on one seeded
    # batch.  The step is host-bound and the host's time swings between
    # fits of one code, so the two heads take turns: plain, fused, fused,
    # plain; each fit must launch as it should and lower the loss
    x, y = tokens(MLM_BATCH)
    fwd_flops, recompute_flops = mlm_flops_per_token(MLM["layers"])
    d = MLM["d_model"]
    runs = {}
    for fused in (False, True, True, False):
        name = "fused" if fused else "plain"
        est = estimator(model(MLM["layers"], torch.bfloat16, fused), fused,
                        MLM_ACCUM)
        inner = est._train_step
        step_losses, step_ms = record_steps(est)
        fx.reset_launches()
        reset_counts(fa)
        t0 = time.perf_counter()
        losses = est.fit((x, y), epochs=MLM_STEPS, batch_size=MLM_BATCH,
                         verbose=False)["loss"]
        fit_s = time.perf_counter() - t0
        launches = read_xent_counts(
            fx, f"bert_mlm_train {name}",
            **({"bf16": MLM_ACCUM * MLM_STEPS} if fused else {}))
        designs = read_xent_designs(
            fx, f"bert_mlm_train {name}",
            **(dict(fwd="wgmma", bwd="wgmma", calls=MLM_ACCUM * MLM_STEPS)
               if fused else {}))
        read_counts(fa, "bert_mlm_train (dense attention)")
        if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
            raise AssertionError(f"bert_mlm_train {name}: loss {losses} did "
                                 f"not fall")
        fit = {"loss": losses, "fit_s": fit_s,
               "step_ms_last10": step_ms[-10:],
               "step_ms_p50": float(np.median(step_ms[-10:]))}
        if name in runs:  # the variant's second turn
            run = runs[name]
            run["fits"].append(fit)
            run["step_ms_p50"] = float(np.median(
                [t for f in run["fits"] for t in f["step_ms_last10"]]))
            tokens_per_s = MLM_BATCH * SEQ / (run["step_ms_p50"] / 1e3)
            run["tokens_per_s"] = tokens_per_s
            run["model_tflop_per_s"] = 3 * fwd_flops * tokens_per_s / 1e12
            run["recompute_tflop_per_s"] = (recompute_flops + (
                2.0 * d * MLM["vocab"] if fused else 0.0)) \
                * tokens_per_s / 1e12
            run["profiled_step"]["idle_share_of_p50_step"] = 1.0 - \
                run["profiled_step"]["device_busy_ms"] / run["step_ms_p50"]
            del est, inner
            torch.cuda.empty_cache()
            continue
        batch = next(as_feed((x, y), MLM_BATCH, seed=SEED).epoch(
            est.device, 0))
        profiled = profile_call(lambda: inner(batch),
                                {"xent": ("xent_",)})
        # the head and its loss alone, forward and backward on one
        # micro-batch's activations, times the micro-batches of a step
        h = torch.randn(MLM_MICRO, SEQ, d, device="cuda").to(torch.bfloat16)
        h.requires_grad_()
        yb = batch["y"][:MLM_MICRO]
        head = est.model.head

        def head_and_loss():
            out = (h, head.kernel, head.bias) if fused else head(h)
            loss = est.loss_fn(out, yb)
            return torch.autograd.grad(loss, (h, head.kernel, head.bias))

        head_ms = device_ms(head_and_loss, iters=5)
        runs[name] = {
            "fits": [fit], "launches": launches,
            "fwd_launches_by_design": designs[0],
            "bwd_launches_by_design": designs[1], "profiled_step": profiled,
            "head_and_loss_device_ms_per_micro": head_ms,
            "head_and_loss_share_of_busy":
                MLM_ACCUM * head_ms / profiled["device_busy_ms"]}
        del est, inner, h, head
        torch.cuda.empty_cache()
    captured = mlm_captured(
        fa, fx, lambda graphs: estimator(
            model(MLM["layers"], torch.bfloat16, True), True, MLM_ACCUM,
            graphs), x, y, fwd_flops, runs["fused"])
    res = {"phase": "bert_mlm_train", "config": dict(MLM, seq=SEQ),
           "dtype": "bfloat16", "optimizer": "adamw",
           "learning_rate": TRAIN_LR, "global_batch": MLM_BATCH,
           "grad_accum": MLM_ACCUM, "micro_batch": MLM_MICRO,
           "steps": MLM_STEPS, "chunk": MLM_CHUNK, "setup_s": setup_s,
           "flop_convention": "model: 3 x forward FLOP per token (encoder "
                              "GEMMs and attention products as "
                              "bert_flops_per_token, plus the head's 2 D V); "
                              "recompute: remat_attention's second pass of "
                              "the attention products (4 SEQ D a layer) and, "
                              "for the fused head, its logits recomputed in "
                              "the backward (2 D V)",
           "plain": runs["plain"], "fused": runs["fused"],
           "fused_vs_plain_step_p50": runs["fused"]["step_ms_p50"]
           / runs["plain"]["step_ms_p50"],
           "f32_check": f32_check, "captured": captured}
    emit(res)
    return res


def mlm_captured(fa, fx, make, x, y, fwd_flops, eager_run) -> dict:
    """bert_mlm_train (d): bench.py's ``bench_bert`` (the fused head) from
    CUDA graphs.  The eager step's window of ``MLM_CMP_STEPS`` steps on
    the seeded batch (its losses the yardstick) and a second, warm one (its
    time), then ``_multi_step(batch, MLM_RESIDENT[0])`` once to warm (its
    first ``MLM_CMP_STEPS`` losses against the eager ones) and three times
    timed, 8 launches of each ``fused_xent`` pass a step counted from the
    replays, a profiled window, peak memory; then bench.py's streaming
    phase: 8 worker threads decode token batches, ``_multi_step_data``
    over chunks of 10."""
    from analytics_zoo_tpu_torch.data import StreamingDataFeed

    batch = {"x": torch.from_numpy(x).cuda(), "y": torch.from_numpy(y).cuda()}
    steps, repeats = MLM_RESIDENT
    chunk_steps, n_chunks = MLM_STREAM
    vocab = MLM["vocab"]
    torch.cuda.empty_cache()
    eager = make(False)
    # the first window's losses are the yardstick; its time includes the
    # first step's costs (Adam's state, the allocator's growth), so the
    # eager step is timed over a second, warm window
    eager_cold_ms, eager_losses = window_ms(
        lambda: eager._multi_step(batch, MLM_CMP_STEPS), MLM_CMP_STEPS)
    eager_ms, _ = window_ms(
        lambda: eager._multi_step(batch, MLM_CMP_STEPS), MLM_CMP_STEPS)
    del eager
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    est = make(True)
    fx.reset_launches()
    reset_counts(fa)
    warm_ms, warm = window_ms(lambda: est._multi_step(batch, steps), steps)
    against = losses_against_eager(warm[:MLM_CMP_STEPS], eager_losses,
                                   "bert_mlm_train (d)")
    read_xent_counts(fx, "bert_mlm_train (d) warm",
                     bf16=MLM_ACCUM * steps)
    fx.reset_launches()
    windows = [window_ms(lambda: est._multi_step(batch, steps), steps)[0]
               for _ in range(repeats)]
    calls = MLM_ACCUM * steps * repeats
    launches = read_xent_counts(fx, "bert_mlm_train (d)", bf16=calls)
    designs = read_xent_designs(fx, "bert_mlm_train (d)", fwd="wgmma",
                                bwd="wgmma", calls=calls)
    read_counts(fa, "bert_mlm_train (d) (dense attention)")
    profiled = profiled_window(lambda: est._multi_step(batch, 5), 5,
                               {"xent": ("xent_",)})
    peak = torch.cuda.max_memory_allocated()

    def load_sample(i, rng=None):  # bench_bert's loader, int32 tokens
        r = np.random.default_rng(i)
        return {"x": r.integers(0, vocab, (SEQ,)).astype(np.int32),
                "y": r.integers(0, vocab, (SEQ,)).astype(np.int32)}

    feed = StreamingDataFeed(
        num_samples=(n_chunks + 2) * chunk_steps * MLM_BATCH,
        load_sample=load_sample, batch_size=MLM_BATCH, shuffle=False,
        num_workers=MLM_STREAM_WORKERS, prefetch_batches=STREAM_PREFETCH)
    fx.reset_launches()
    stream = stream_chunks(est, feed, chunk_steps, n_chunks)
    stream["launches"] = read_xent_counts(
        fx, "bert_mlm_train (d) streaming",
        bf16=MLM_ACCUM * chunk_steps * (n_chunks + 1))
    caps = captures(est, "bert_mlm_train (d)")
    del est
    torch.cuda.empty_cache()
    ms = float(np.median(windows))
    idle_of(profiled, ms)
    stream["vs_resident"] = stream["step_ms"] / ms
    stream["within_bench_acceptance"] = \
        stream["step_ms"] <= (1 + STREAM_WITHIN) * ms
    tokens_per_s = MLM_BATCH * SEQ / (ms / 1e3)
    return {"losses_against_eager": against, "warm_window_step_ms": warm_ms,
            "window_step_ms": windows, "step_ms": ms,
            "eager_step_ms": eager_ms, "eager_cold_step_ms": eager_cold_ms,
            "eager_step_ms_p50_c": eager_run["step_ms_p50"],
            "tokens_per_s": tokens_per_s,
            "model_tflop_per_s": 3 * fwd_flops * tokens_per_s / 1e12,
            "launches": launches, "fwd_launches_by_design": designs[0],
            "bwd_launches_by_design": designs[1], "profiled": profiled,
            "peak_memory_bytes": peak, "streaming": stream, **caps}


# the recommenders (bench.py's bench_ncf and bench_recsys, uncut):
# string events through the Friesian pipeline, NeuralCF through the
# Estimator from CUDA graphs (adam 1e-3, batch 2,048)
NCF_EVENTS = (200_000, 2000, 1500)   # rows, users, items (bench_ncf)
NCF_BATCH = 2048
NCF_EPOCHS = 3                       # the captured fit; its loss must fall
RECSYS_EVENTS = (60_000, 5000, 2000)  # bench_recsys
RECSYS_K = 20                        # candidates a request
RECSYS_TRACE = 512                   # zipf(1.5) requests, cycled
RECSYS_CLIENTS = 4
RECSYS_SECONDS = 2.5
RECSYS_MIN_GATHER_RATIO = 4.0        # bench_recsys: naive / deduped bytes
RECSYS_BATCH = 8                     # the server's batch size


def record_losses(est) -> list:
    """Make ``est``'s train step keep each step's loss (a device clone)."""
    losses, inner = [], est._train_step

    def step(batch):
        loss = inner(batch)
        losses.append(loss.clone())
        return loss

    est._train_step = step
    return losses


def ncf_estimator(model_cls, kw, state, graphs, **ekw):
    """A NeuralCF of ``kw`` holding ``state`` under an Estimator on the
    card (adam 1e-3, bench.py's), from CUDA graphs or eager."""
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    model = model_cls(**kw)
    model.load_state_dict(state)
    return Estimator.from_keras(model, loss="sparse_categorical_crossentropy",
                                optimizer="adam", learning_rate=1e-3,
                                cuda_graphs=graphs, seed=SEED, **ekw)


def fit_epoch(est, xy, batch) -> tuple:
    """(ms a step, the epoch's mean loss) of one ``fit`` epoch: host clock
    from the call to its end (``fit`` reads the epoch's loss back once)."""
    steps = len(xy[1]) // batch
    t0 = time.perf_counter()
    hist = est.fit(xy, epochs=1, batch_size=batch, verbose=False)
    return (time.perf_counter() - t0) * 1e3 / steps, hist["loss"][0]


def phase_ncf_train() -> dict:
    """bench.py's ``bench_ncf`` uncut: 200,000 string events, encoded and
    negatively sampled (2 a row) by ``FeatureTable``, ``NeuralCF(2001,
    1501)`` through the Estimator at batch 2,048, one epoch eagerly and
    three from CUDA graphs from one seeded init: the captured step losses
    of the first epoch against the eager ones, one capture, step ms and
    examples/s of a warm epoch each way, a profiled epoch's card busy and
    idle share, peak memory; the captured fit's loss must fall."""
    import pandas as pd

    from analytics_zoo_tpu_torch.friesian import FeatureTable
    from analytics_zoo_tpu_torch.models import NeuralCF

    t_phase = time.perf_counter()
    n_rows, n_users, n_items = NCF_EVENTS
    rng = np.random.default_rng(SEED)
    users = rng.integers(0, n_users, n_rows)
    half = n_items // 2
    items = np.where(users % 2 == 0, rng.integers(0, half, n_rows),
                     rng.integers(half, n_items, n_rows))
    df = pd.DataFrame({"user": [f"u{u}" for u in users],
                       "item": [f"i{i}" for i in items]})
    t_feat = time.perf_counter()
    tbl = FeatureTable.from_pandas(df)
    tbl, _ = tbl.encode_string("user")
    tbl, _ = tbl.encode_string("item")
    tbl = tbl.negative_sample(n_items, item_col="item", neg_num=2)
    feat_s = time.perf_counter() - t_feat
    pdf = tbl.to_pandas()
    xy = (np.stack([pdf["user"].to_numpy(), pdf["item"].to_numpy()], 1)
          .astype(np.int32), pdf["label"].to_numpy().astype(np.int32))
    kw = dict(user_count=n_users + 1, item_count=n_items + 1, class_num=2)
    state = NeuralCF(**kw).init_weights(
        torch.Generator().manual_seed(SEED)).state_dict()
    steps = len(xy[1]) // NCF_BATCH

    eager = ncf_estimator(NeuralCF, kw, state, False)
    eager_losses = record_losses(eager)
    eager.fit(xy, epochs=1, batch_size=NCF_BATCH, verbose=False)
    eager_losses = [float(v) for v in eager_losses]
    del eager._train_step  # the class's step again
    eager_ms, _ = fit_epoch(eager, xy, NCF_BATCH)
    del eager
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    est = ncf_estimator(NeuralCF, kw, state, True)
    cap_losses = record_losses(est)
    first = est.fit(xy, epochs=1, batch_size=NCF_BATCH, verbose=False)
    against = losses_against_eager(cap_losses, eager_losses, "ncf_train")
    against = {k: v for k, v in against.items()
               if k not in ("captured", "eager")}
    del est._train_step
    ms, second = fit_epoch(est, xy, NCF_BATCH)
    profiled = profiled_window(
        lambda: est.fit(xy, epochs=1, batch_size=NCF_BATCH, verbose=False),
        steps, {"embedding": ("embedding", "index"),
                "gemm": ("gemm", "nvjet", "cutlass")})
    idle_of(profiled, ms)
    epoch_losses = [first["loss"][0], second,
                    float(est.fit(xy, epochs=1, batch_size=NCF_BATCH,
                                  verbose=False)["loss"][0])]
    peak = torch.cuda.max_memory_allocated()
    caps = captures(est, "ncf_train")
    if not epoch_losses[-1] < epoch_losses[0]:
        raise AssertionError(f"ncf_train: the loss did not fall over "
                             f"{NCF_EPOCHS} captured epochs: "
                             f"{epoch_losses}")
    res = {"phase": "ncf_train", "rows_after_negative_sampling": len(xy[1]),
           "feature_pipeline_s": feat_s, "batch": NCF_BATCH,
           "steps_an_epoch": steps, "step_ms": ms, "eager_step_ms": eager_ms,
           "examples_per_s": NCF_BATCH / (ms / 1e3),
           "eager_examples_per_s": NCF_BATCH / (eager_ms / 1e3),
           "losses_against_eager": against,
           "epoch_losses_captured": epoch_losses[:NCF_EPOCHS],
           "profiled": profiled, "peak_memory_bytes": peak, **caps,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return res


def dedup_rows(x: np.ndarray, columns) -> list:
    """(deduped, naive) rows of each table for one served batch ``x`` of
    ``[user | k items]`` rows, as ``CachedEmbeddingModel.predict`` looks
    them up: a user column repeats each user k times."""
    x = np.asarray(x, np.int64)
    k = x.shape[1] - 1
    out = []
    for _, which in columns:
        ids = np.repeat(x[:, 0], k) if which == "user" else x[:, 1:]
        ids = ids.reshape(-1)
        ids = ids[ids >= 0]
        out.append((int(np.unique(ids).size), int(ids.size)))
    return out


def _zipf_trace(rng, n_users, n_items) -> np.ndarray:
    """bench_recsys's request trace: a zipf(1.5) user and RECSYS_K zipf
    items a request, as raw string events."""
    zu = np.minimum(rng.zipf(1.5, RECSYS_TRACE), n_users) - 1
    zi = np.minimum(rng.zipf(1.5, (RECSYS_TRACE, RECSYS_K)), n_items) - 1
    return np.array([[f"u{u}"] + [f"i{i}" for i in row]
                     for u, row in zip(zu, zi)], dtype="<U8")


def table_allocations(est, batch, tables) -> list:
    """The allocations of ``est``'s first train step on ``batch`` (its
    eager run and its capture) whose size is a table's ``rows x dim`` f32
    bytes (up to the allocator's 512-byte rounding): none is expected."""
    sizes = [(p.numel() * 4, -(-p.numel() * 4 // 512) * 512)
             for p in tables]
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=200_000)
    try:
        est._train_step(batch)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    allocs = [e["size"] for trace in snap["device_traces"] for e in trace
              if e["action"] == "alloc"]
    if not allocs:
        raise AssertionError("recsys: the memory history recorded no "
                             "allocation of the first step")
    return [a for a in allocs if any(lo <= a <= hi for lo, hi in sizes)]


def phase_recsys() -> dict:
    """bench.py's ``bench_recsys`` uncut: 60,000 string events through
    ``FeatureTable`` (``gen_string_idx``, ``encode_string``,
    ``negative_sample``), a ShardedEmbedding ``NeuralCF`` (16-wide tables,
    MLP 32/16) trained one epoch on the sparse path under
    ``embedding_row_rules()`` from CUDA graphs and one more profiled (the
    card's busy time a step, its idle share, the top kernels); its first
    step's allocations (none of a table's bytes) and each table's
    ``.grad`` (None); then ``serving_split``, the tail in ``InferenceModel``, and
    ``CachedEmbeddingModel(EmbedCache(200_000))`` behind
    ``ClusterServing(batch_size=8, batch_timeout_ms=2,
    inference_workers=2)`` with the fitted ``FeaturePipeline``: 4
    closed-loop clients for 2.5 s over a zipf(1.5) trace of k = 20
    candidates.  Every reply must equal the eager adapter's ranking of
    its row (the tail served eagerly, no cache).

    The dedup is held on two counts.  The rows gathered in the window
    must equal, exactly, the unique ids of each table in each batch the
    server formed (recorded as the adapter receives them).  The window's
    naive / deduped ratio is reported only: it is set by how many
    requests the 2 ms batch window groups (3.65 at one a batch, 4.47 at
    two, over this trace), which the host's pace decides.  The 4x bar
    (bench.py's) holds on the same trace replayed in the server's full
    batches of 8 through an uncached adapter, whose rankings must equal
    the eager ones too."""
    import pandas as pd

    from analytics_zoo_tpu_torch.core import metrics as metrics_lib
    from analytics_zoo_tpu_torch.friesian import (FeaturePipeline,
                                                  FeatureTable)
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.parallel import embedding_row_rules
    from analytics_zoo_tpu_torch.serving import (CachedEmbeddingModel,
                                                 ClusterServing, EmbedCache,
                                                 InferenceModel, InputQueue,
                                                 OutputQueue)

    t_phase = time.perf_counter()
    # what else runs on the host: its pace sets how many requests the 2 ms
    # window groups into a batch, and so the window's gather ratio
    host = {"threads_at_start": sorted(t.name for t in threading.enumerate()
                                       if t is not threading.main_thread()),
            "loadavg_1m_at_start": os.getloadavg()[0]}
    n_rows, n_users, n_items = RECSYS_EVENTS
    rng = np.random.default_rng(SEED)
    df = pd.DataFrame({
        "user": [f"u{u}" for u in rng.integers(0, n_users, n_rows)],
        "item": [f"i{i}" for i in rng.integers(0, n_items, n_rows)]})
    t_feat = time.perf_counter()
    tbl = FeatureTable.from_pandas(df)
    user_idx, item_idx = tbl.gen_string_idx(["user", "item"])
    tbl, _ = tbl.encode_string(["user", "item"], [user_idx, item_idx])
    tbl = tbl.negative_sample(item_idx.size, item_col="item", neg_num=2)
    feat_s = time.perf_counter() - t_feat
    pdf = tbl.to_pandas()
    xy = (np.stack([pdf["user"].to_numpy(), pdf["item"].to_numpy()], 1)
          .astype(np.int32), pdf["label"].to_numpy().astype(np.int32))
    kw = dict(user_count=user_idx.size, item_count=item_idx.size,
              class_num=2, user_embed=16, item_embed=16,
              hidden_layers=(32, 16), mf_embed=16, sharded_embeddings=True)
    state = NeuralCF(**kw).init_weights(
        torch.Generator().manual_seed(SEED)).state_dict()
    est = ncf_estimator(NeuralCF, kw, state, True,
                        sharding=embedding_row_rules())
    tables = list(est._sparse.values())
    first = {"x": torch.from_numpy(xy[0][:NCF_BATCH]).cuda(),
             "y": torch.from_numpy(xy[1][:NCF_BATCH]).cuda()}
    table_allocs = table_allocations(est, first, tables)
    steps = len(xy[1]) // NCF_BATCH
    ms, loss = fit_epoch(est, xy, NCF_BATCH)
    profiled = profiled_window(
        lambda: est.fit(xy, epochs=1, batch_size=NCF_BATCH, verbose=False),
        steps, {"sort": ("sort", "radix"), "gemm": ("gemm", "nvjet",
                                                    "cutlass")})
    idle_of(profiled, ms)
    grads = [p.grad for p in tables]
    if table_allocs or any(g is not None for g in grads):
        raise AssertionError(f"recsys: a table gradient: allocations of a "
                             f"table's bytes {table_allocs}, .grad "
                             f"{[g is not None for g in grads]}")
    caps = captures(est, "recsys")

    variables = est.get_model()
    tab, tail, tail_vars = est.model.serving_split(variables)
    im = InferenceModel().load(tail, tail_vars)
    im.warm([(tail.input_dim(),)], dtype=np.float32)
    eager_im = InferenceModel(cuda_graphs=False).load(
        est.model.serving_split(variables)[1], tail_vars)
    reg = metrics_lib.get_registry()
    reg.reset()
    adapter = CachedEmbeddingModel(tab, est.model.embedding_columns(), im,
                                   cache=EmbedCache(capacity=200_000))
    eager_adapter = CachedEmbeddingModel(
        tab, est.model.embedding_columns(), eager_im,
        metrics=metrics_lib.MetricsRegistry())
    pipe = (FeaturePipeline().encode_string(user_idx)
            .encode_string(item_idx))
    tf = pipe.as_server_transform(["user"] + ["item"] * RECSYS_K,
                                  dtype=np.int64)
    trace = _zipf_trace(rng, n_users, n_items)
    lat, replies, errors = [], [], []
    served = []            # each batch as the server hands it over
    serve_batch = adapter.predict

    def recording(x):
        served.append(np.array(x, copy=True))
        return serve_batch(x)

    adapter.predict = recording
    with ClusterServing(models={"recsys": adapter},
                        pipelines={"recsys": tf}, batch_size=RECSYS_BATCH,
                        batch_timeout_ms=2, inference_workers=2) as srv:
        barrier = threading.Barrier(RECSYS_CLIENTS + 1)

        def client(c: int) -> None:
            iq = InputQueue(srv.host, srv.port)
            oq = OutputQueue(input_queue=iq)
            try:
                barrier.wait()
                i = 0
                while time.monotonic() < deadline:
                    row = (c * 131 + i) % RECSYS_TRACE
                    t1 = time.perf_counter()
                    out = oq.query(iq.enqueue(f"c{c}-{i}", model="recsys",
                                              t=trace[row]), timeout=60.0)
                    if out is None:
                        errors.append(f"client {c}: request {i} timed out")
                        return
                    lat.append((time.perf_counter() - t1) * 1e3)
                    replies.append((row, out))
                    i += 1
            except Exception as e:  # noqa: BLE001 - recorded, raised below
                errors.append(f"client {c}: {type(e).__name__}: {e}")
            finally:
                iq.close()

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(RECSYS_CLIENTS)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + RECSYS_SECONDS
        barrier.wait()
        t0, cpu0 = time.monotonic(), time.process_time()
        for t in threads:
            t.join(timeout=120)
        wall = time.monotonic() - t0
        host["process_cpu_s_per_s"] = (time.process_time() - cpu0) / wall
        st = srv.stats()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"recsys: {errors[:3] or 'a client hung'}")
    check_served(st, "recsys", len(lat))
    snap = reg.snapshot()
    hits, misses = snap["embed.cache_hits"], snap["embed.cache_misses"]
    want = eager_adapter.predict(tf(trace))
    wrong = [row for row, out in replies
             if not np.array_equal(out, want[row])]
    if wrong:
        raise AssertionError(f"recsys: {len(wrong)} of {len(replies)} "
                             f"replies differ from the eager adapter's "
                             f"ranking (rows {wrong[:5]})")
    ratio = (snap["embed.gather_bytes_naive"]
             / max(1, snap["embed.gather_bytes"]))
    cols = est.model.embedding_columns()
    want_rows = [0, 0]     # deduped, naive
    for x in served:
        for part in dedup_rows(x, cols):
            want_rows[0] += part[0]
            want_rows[1] += part[1]
    got_rows = [snap["embed.gather_rows"], snap["embed.gather_rows_naive"]]
    if got_rows != want_rows or sum(len(x) for x in served) != len(lat):
        raise AssertionError(f"recsys: rows gathered (deduped, naive) "
                             f"{got_rows}, the served batches' unique ids "
                             f"give {want_rows}; {len(served)} batches of "
                             f"{sum(len(x) for x in served)} rows for "
                             f"{len(lat)} requests")
    replay_reg = metrics_lib.MetricsRegistry()
    replay = CachedEmbeddingModel(tab, cols, eager_im, metrics=replay_reg)
    rows = tf(trace)
    ranked = np.concatenate([replay.predict(rows[i:i + RECSYS_BATCH])
                             for i in range(0, len(rows), RECSYS_BATCH)])
    rsnap = replay_reg.snapshot()
    full_ratio = (rsnap["embed.gather_bytes_naive"]
                  / max(1, rsnap["embed.gather_bytes"]))
    if not np.array_equal(ranked, want):
        raise AssertionError("recsys: the replay in batches of "
                             f"{RECSYS_BATCH} ranks differently from the "
                             "eager adapter")
    if full_ratio < RECSYS_MIN_GATHER_RATIO:
        raise AssertionError(f"recsys: gather-bytes ratio {full_ratio:.3f} "
                             f"over the trace in batches of {RECSYS_BATCH} "
                             f"< {RECSYS_MIN_GATHER_RATIO} (bench.py's "
                             f"bar): the dedup saves less than it should")
    res = {"phase": "recsys", "rows_after_negative_sampling": len(xy[1]),
           "feature_pipeline_s": feat_s,
           "table_rows": {"user": user_idx.size, "item": item_idx.size},
           "sparse_step_ms": ms, "steps": steps, "epoch_loss": loss,
           "profiled": profiled,
           "table_allocations_in_step": len(table_allocs),
           "table_grads": [g is not None for g in grads], **caps,
           **latency_summary(lat, wall), "clients": RECSYS_CLIENTS,
           "candidates_per_request": RECSYS_K,
           "cache_hit_rate": hits / max(1, hits + misses),
           "gather_bytes_ratio": ratio,
           "served_batches": len(served),
           "served_mean_batch": len(lat) / max(1, len(served)),
           "gather_bytes_ratio_full_batches": full_ratio,
           "replies_equal_eager": len(replies),
           "tail_compile_count": im.compile_count, "host": host,
           "seconds": time.perf_counter() - t_phase}
    res.pop("tokens_per_s")
    emit(res)
    return res


# -- state_plane ------------------------------------------------------------

# bench.py's bench_checkpoint, uncut: a sharded NCF (20,000 + 10,000 rows of
# 64 in each of its four tables), 4,096 seeded rows at batch 128, adam 1e-2,
# seed 7, a trigger every 2 steps
CKPT_NCF = dict(user_count=20_000, item_count=10_000, class_num=2,
                user_embed=64, item_embed=64, hidden_layers=(64, 32),
                mf_embed=64, sharded_embeddings=True)
CKPT_ROWS = 4096
CKPT_BATCH = 128
CKPT_EVERY = 2
CKPT_CLEAN = 1.15     # bench.py's acceptance ratio: reported, not asserted
SP_IMAGES = 512       # state_plane (b): 4 steps an epoch at batch 128
SP_SQUAD = (5, 10)    # state_plane (c): the first fit's epochs, the total
SP_WARMUP = 4         # (c)'s warmup_cosine schedule, over its 20 steps
SP_SERVE = 16         # requests to the zoo-serving child
SP_STALL_STEPS = 4    # steps a side of the stall windows
SP_STALL_SAVES = 4    # windows with a save, between two without
SP_PREEMPT_EPOCHS = 8  # the preempted fit's epochs (the signal comes first)


class StatePlaneSizes:
    """The phase's shapes: the card's by default; the CPU rehearsal of the
    phase (tests and debugging) shrinks them."""

    def __init__(self, device="cuda", **kw):
        self.device = device
        self.ncf = dict(CKPT_NCF)
        self.rows, self.batch = CKPT_ROWS, CKPT_BATCH
        self.resnet = dict(RESNET, norm="batch", dtype="bfloat16")
        self.image, self.images, self.resnet_batch = (IMAGE, SP_IMAGES,
                                                      RESNET_BATCH)
        self.bert = dict(BERT_BASE)
        self.seq, self.examples, self.squad_batch = (SEQ, TRAIN_EXAMPLES,
                                                     TRAIN_BATCH)
        self.__dict__.update(kw)


def sp_sync(sizes) -> None:
    if sizes.device == "cuda":
        torch.cuda.synchronize()


def sp_free(sizes) -> None:
    """Give back what estimators dropped before this held on the card (a
    train-step wrapper holds its estimator in a reference cycle, graphs
    and their memory pools with it), so the next one's allocations and
    snapshots do not run into the allocator releasing its cache."""
    import gc
    gc.collect()
    if sizes.device == "cuda":
        torch.cuda.empty_cache()


def sp_tree_equal(a, b, what: str) -> int:
    """Two checkpoint trees bit for bit (leaf paths, shapes, dtypes and
    bytes); returns the leaves compared."""
    from analytics_zoo_tpu_torch.core import checkpoint as ckpt_io
    pa, pb = ckpt_io.leaf_paths(a), ckpt_io.leaf_paths(b)
    if pa != pb:
        raise AssertionError(f"{what}: leaf paths differ: {pa[:5]} vs "
                             f"{pb[:5]}")
    for path, x, y in zip(pa, ckpt_io.flatten(a)[0], ckpt_io.flatten(b)[0]):
        x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.reshape(-1).view(torch.uint8),
                y.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"{what}: leaf {path} differs")
    return len(pa)


def sp_train_state(est) -> dict:
    """What a resume must restore: parameters, buffers, the optimizer's
    state in optax's layout, the step."""
    tree = est._save_tree()
    return {k: tree[k] for k in ("params", "state", "opt_state", "step")}


def sp_dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, files in os.walk(path) for f in files)


def sp_stall(est, batch, sizes) -> dict:
    """What a snapshot costs the steps around it: ms of 2 x
    SP_STALL_STEPS train steps on one batch (synchronised at the window's
    ends) without and with a trigger save between the halves, in turns
    (without, with x SP_STALL_SAVES, without), and the host ms of each
    save call.  The first saves of a manager allocate its snapshot
    buffers; later ones reuse them (a save that finds both sets still
    held by the writer makes a third)."""
    def window(save: bool):
        sp_sync(sizes)
        t0 = time.perf_counter()
        for _ in range(SP_STALL_STEPS):
            est._train_step(batch)
        call = None
        if save:
            t1 = time.perf_counter()
            est._trigger_save()
            call = (time.perf_counter() - t1) * 1e3
        for _ in range(SP_STALL_STEPS):
            est._train_step(batch)
        sp_sync(sizes)
        return (time.perf_counter() - t0) * 1e3, call

    runs = [window(save) for save in
            (False,) + (True,) * SP_STALL_SAVES + (False,)]
    if est._ckpt_mgr is not None:
        est._ckpt_mgr.flush(raise_error=True)
    plain = [runs[0][0], runs[-1][0]]
    base = sum(plain) / len(plain)
    saved = [ms for ms, _ in runs[1:-1]]
    return {"window_steps": 2 * SP_STALL_STEPS, "plain_ms": plain,
            "with_save_ms": saved, "stall_ms": [s - base for s in saved],
            "save_call_ms": [call for _, call in runs[1:-1]],
            "step_ms": base / (2 * SP_STALL_STEPS)}


def sp_write_errors() -> float:
    from analytics_zoo_tpu_torch.core import metrics
    return metrics.get_registry().snapshot().get("ckpt.write_errors", 0)


def sp_checkpoint_bench(sizes, root: str) -> dict:
    """state_plane (a): bench.py's bench_checkpoint.  Three modes (no
    checkpoint, sync saves, the async manager), each one warm epoch then
    one timed, a trigger every 2 steps; the step timed at the
    ``_train_step`` call boundary (so a sync save's stall lands in the
    interval after it); then the async run's generations, a fresh
    estimator's restore, and its state against the live one."""
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.orca.learn import Estimator, \
        SeveralIteration

    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, sizes.ncf["user_count"], sizes.rows),
                  rng.integers(0, sizes.ncf["item_count"], sizes.rows)],
                 1).astype(np.int32)
    y = (rng.random(sizes.rows) < 0.5).astype(np.int32)
    init = NeuralCF(**sizes.ncf).init_weights(
        torch.Generator().manual_seed(7)).state_dict()

    def ncf():
        m = NeuralCF(**sizes.ncf)
        m.load_state_dict(init)
        return m

    kw = dict(loss="sparse_categorical_crossentropy", optimizer="adam",
              learning_rate=1e-2, seed=7, device=sizes.device)
    modes = {}
    for mode in ("none", "sync", "async"):
        d = os.path.join(root, f"ncf_{mode}")
        est = Estimator.from_keras(
            ncf(), model_dir=None if mode == "none" else d,
            checkpoint_async=mode == "async", **kw)
        trig = None if mode == "none" else SeveralIteration(CKPT_EVERY)
        est.fit((x, y), epochs=1, batch_size=sizes.batch, verbose=False,
                checkpoint_trigger=trig)
        if est._ckpt_mgr is not None:
            est._ckpt_mgr.flush(raise_error=True)
        stamps, inner = [], est._train_step

        def timed(batch, _inner=inner, _s=stamps):
            _s.append(time.perf_counter())
            return _inner(batch)

        est._train_step = timed
        t0 = time.perf_counter()
        est.fit((x, y), epochs=1, batch_size=sizes.batch, verbose=False,
                checkpoint_trigger=trig)
        wall = time.perf_counter() - t0
        est._train_step = inner
        if est._ckpt_mgr is not None:
            est._ckpt_mgr.flush(raise_error=True)
        diffs = np.diff(np.asarray(stamps)) * 1e3
        res = {"steps": len(stamps), "wall_s": wall,
               "step_p50_ms": float(np.percentile(diffs, 50)),
               "step_p99_ms": float(np.percentile(diffs, 99))}
        if mode == "async":
            mgr = est._ckpt_mgr
            gens = mgr.generations()
            fulls = [r["bytes"] for r in gens if r["kind"] == "full"]
            deltas = [r["bytes"] for r in gens if r["kind"] == "delta"]
            if not deltas:
                raise AssertionError(f"state_plane (a): no delta "
                                     f"generation among {gens}")
            errors = mgr.verify()
            if errors:
                raise AssertionError(f"state_plane (a): verify() {errors}")
            res.update({
                "generations": [r["kind"] for r in gens],
                "full_bytes_mean": float(np.mean(fulls)),
                "delta_bytes_mean": float(np.mean(deltas)),
                "delta_to_full_ratio": float(np.mean(deltas)
                                             / np.mean(fulls)),
                "verify": errors})
            sp_sync(sizes)
            r0 = time.perf_counter()
            rest = Estimator.from_keras(ncf(), model_dir=d,
                                        checkpoint_async=True, **kw)
            rest.load(d)
            sp_sync(sizes)
            res["restore_ms"] = (time.perf_counter() - r0) * 1e3
            res["restored_leaves_equal"] = sp_tree_equal(
                sp_train_state(rest), sp_train_state(est),
                "state_plane (a) restored vs live")
            del rest
        modes[mode] = res
        del est
        sp_free(sizes)
    base = modes["none"]["step_p99_ms"]
    sync_ratio = modes["sync"]["step_p99_ms"] / base
    async_ratio = modes["async"]["step_p99_ms"] / base
    return {"modes": modes, "sync_p99_ratio": sync_ratio,
            "async_p99_ratio": async_ratio,
            "clean": not (async_ratio > CKPT_CLEAN
                          and sync_ratio <= CKPT_CLEAN),
            "trigger_every_steps": CKPT_EVERY}


def sp_resnet(bn, sizes, root: str) -> dict:
    """state_plane (b): bench.py's ResNet-50, norm="batch", bf16, sgd 0.1,
    from CUDA graphs under cuDNN's deterministic algorithms, over seeded
    images (4 steps an epoch): 2 epochs straight; 1 epoch saved at its end
    and a fresh estimator's auto_resume to 2, sync and async (step losses,
    parameters and running statistics equal the straight run's bit for
    bit; 53 launches of each batch-norm kernel a resumed step); an
    in-place load into the straight run's estimator, then one more epoch;
    a SIGTERM mid-fit (``Preempted.step`` is the checkpoint's, the
    restored state the live one); the save's, the snapshot's and the
    restore's times and the checkpoint's bytes."""
    import signal
    import threading

    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.core.failover import Preempted
    from analytics_zoo_tpu_torch.data import as_feed
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    card = sizes.device == "cuda"
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(SEED + 9)
    init = from_jax_variables(random_resnet_variables(
        TrainNet(**sizes.resnet), SEED))
    xy = (rng.integers(0, 256, (sizes.images, sizes.image, sizes.image, 3),
                       dtype=np.uint8),
          rng.integers(0, sizes.resnet["class_num"],
                       sizes.images).astype(np.int32))
    steps = sizes.images // sizes.resnet_batch

    def est(**kw):
        m = TrainNet(**sizes.resnet)
        m.load_state_dict(init, strict=True)
        return Estimator.from_keras(
            m, loss="sparse_categorical_crossentropy", optimizer="sgd",
            learning_rate=RESNET_LR, seed=SEED, device=sizes.device, **kw)

    def fit(e, epochs, **kw):
        losses = record_losses(e)
        e.fit(xy, epochs=epochs, batch_size=sizes.resnet_batch,
              verbose=False, **kw)
        return [float(v) for v in losses]

    def weights(e):
        return {k: v.detach().clone() for k, v in
                e.model.state_dict().items()}

    def same_weights(a, b, what):
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        if bad:
            raise AssertionError(f"{what}: {len(bad)} tensors differ "
                                 f"({bad[:3]})")

    try:
        straight = est()
        want = fit(straight, 2)
        want_w = weights(straight)
        out = {"steps_an_epoch": steps, "straight_losses": want}
        for mode in ("sync", "async"):
            d = os.path.join(root, f"resnet_{mode}")
            first = est(model_dir=d, checkpoint_async=mode == "async")
            fit(first, 1, checkpoint_trigger="every_epoch")
            if first._ckpt_mgr is not None:
                first._ckpt_mgr.flush(raise_error=True)
            del first
            sp_free(sizes)
            resumed = est(model_dir=d, checkpoint_async=mode == "async")
            if card:
                bn.reset_launches()
            got = fit(resumed, 2, auto_resume=True)
            launches = (read_bn_counts(bn, f"state_plane (b) {mode}",
                                       bf16=steps) if card else None)
            if got != want[steps:]:
                raise AssertionError(f"state_plane (b) {mode}: resumed "
                                     f"losses {got}, straight "
                                     f"{want[steps:]}")
            same_weights(weights(resumed), want_w,
                         f"state_plane (b) {mode} resumed")
            out[mode] = {"resumed_losses": got, "launches": launches,
                         "captures": resumed.capture_count,
                         "checkpoint_bytes": sp_dir_bytes(d)}
            batch = next(as_feed(xy, sizes.resnet_batch,
                                 shuffle=False).epoch(sizes.device, 0))
            if mode == "sync":  # keep d's epoch-1 save for the load below
                resumed.model_dir = d + "_stall"
            out[mode]["stall"] = sp_stall(resumed, batch, sizes)
            del resumed
            sp_free(sizes)
        # in place: a load into the straight run's captured estimator
        straight.load(os.path.join(root, "resnet_sync"))
        again = fit(straight, 1)
        if again != want[steps:]:
            raise AssertionError(f"state_plane (b): after an in-place load "
                                 f"{again}, want {want[steps:]}")
        out["in_place_load_losses_equal"] = True
        out["in_place_captures"] = straight.capture_count
        sp_sync(sizes)
        t0 = time.perf_counter()
        straight.save(os.path.join(root, "resnet_save"))
        out["save_ms"] = (time.perf_counter() - t0) * 1e3
        out["save_bytes"] = sp_dir_bytes(os.path.join(root, "resnet_save"))
        del straight
        sp_free(sizes)
        fresh = est()
        sp_sync(sizes)
        t0 = time.perf_counter()
        fresh.load(os.path.join(root, "resnet_save"))
        sp_sync(sizes)
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        del fresh
        # preemption: SIGTERM from a timer thread in the second epoch
        d = os.path.join(root, "resnet_preempt")
        pre = est(model_dir=d, preemption_checkpoint=True,
                  preemption_sync_every=1)
        inner, timer = pre._train_step, []

        def step(batch):
            loss = inner(batch)
            if pre._py_step == steps + 1 and not timer:
                timer.append(threading.Timer(
                    0.0, os.kill, (os.getpid(), signal.SIGTERM)))
                timer[0].start()
            return loss

        pre._train_step = step
        try:
            pre.fit(xy, epochs=SP_PREEMPT_EPOCHS, batch_size=sizes.resnet_batch,
                    verbose=False)
            raise AssertionError("state_plane (b): no Preempted")
        except Preempted as e:
            preempted = e
        finally:
            pre._preempt.uninstall()
            for t in timer:
                t.join()
        from analytics_zoo_tpu_torch.core import checkpoint as ckpt_io
        saved_step = ckpt_io.latest_step(d)
        if not (preempted.durable and preempted.step == saved_step
                == pre._py_step):
            raise AssertionError(f"state_plane (b): Preempted at "
                                 f"{preempted.step}, saved {saved_step}, "
                                 f"live {pre._py_step}")
        back = est()
        back.load(d)
        out["preempted"] = {
            "step": preempted.step, "epoch": pre._epoch,
            "restored_leaves_equal": sp_tree_equal(
                sp_train_state(back), sp_train_state(pre),
                "state_plane (b) preempted")}
        del pre, back
        sp_free(sizes)
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def sp_squad(fa, sizes, root: str) -> dict:
    """state_plane (c): BERT-base BERTSQuAD (bf16, dropout 0.1, adamw on
    warmup_cosine) through fit(prefetch=2) from CUDA graphs: 10 epochs
    straight; 5 epochs saved by the async manager at each epoch's end and a
    fresh estimator's auto_resume to 10 (its 10 step losses and weights
    equal the straight run's last 10 bit for bit; 12 + 12 flash launches a
    resumed step); the snapshot's stall; ``save_model`` served by
    ``load_zoo_model`` against ``load_estimator`` at buckets 1 and 16; and
    a ``zoo-serving --model-dir`` child answering SP_SERVE requests."""
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.core import launcher
    from analytics_zoo_tpu_torch.data import as_feed
    from analytics_zoo_tpu_torch.models import BERTSQuAD, squad_span_loss
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    from analytics_zoo_tpu_torch.serving import (InferenceModel, InputQueue,
                                                 OutputQueue)

    card = sizes.device == "cuda"
    cfg = dict(sizes.bert, dropout=0.1, dtype=torch.bfloat16)
    init = from_jax_variables(random_bert_variables(
        BERTSQuAD(use_flash=True, **sizes.bert), SEED))
    rng = np.random.default_rng(SEED + 11)
    ids = rng.integers(0, sizes.bert["vocab_size"],
                       (sizes.examples, sizes.seq)).astype(np.int32)
    start = rng.integers(0, sizes.seq // 2, sizes.examples)
    spans = np.stack([start, start + rng.integers(1, sizes.seq // 2,
                                                  sizes.examples)],
                     1).astype(np.int32)
    first_epochs, total = SP_SQUAD
    steps = sizes.examples // sizes.squad_batch
    sched = {"schedule": "warmup_cosine", "peak": TRAIN_LR,
             "warmup_steps": SP_WARMUP, "decay_steps": total * steps}

    def est(**kw):
        m = BERTSQuAD(use_flash=True, **cfg)
        m.load_state_dict(init, strict=True)
        return Estimator.from_keras(m, loss=squad_span_loss,
                                    optimizer="adamw", learning_rate=sched,
                                    seed=SEED, device=sizes.device, **kw)

    def fit(e, epochs, **kw):
        losses = record_losses(e)
        e.fit((ids, spans), epochs=epochs, batch_size=sizes.squad_batch,
              verbose=False, prefetch=2, **kw)
        return [float(v) for v in losses]

    straight = est()
    want = fit(straight, total)
    want_w = {k: v.clone() for k, v in straight.model.state_dict().items()}
    del straight
    sp_free(sizes)
    d = os.path.join(root, "squad")
    ckw = dict(model_dir=d, checkpoint_async=True, checkpoint_keep_last=1)
    first = est(**ckw)
    fit(first, first_epochs, checkpoint_trigger="every_epoch")
    first._ckpt_mgr.flush(raise_error=True)
    del first
    sp_free(sizes)
    resumed = est(**ckw)
    if card:
        reset_counts(fa)
    got = fit(resumed, total, auto_resume=True)
    n = (total - first_epochs) * steps
    launches = (read_counts(fa, "state_plane (c)",
                            **{BF16_KERNEL: n, BWD_KERNEL: n})
                if card else None)
    if got != want[first_epochs * steps:]:
        raise AssertionError(f"state_plane (c): resumed losses {got}, "
                             f"straight {want[first_epochs * steps:]}")
    bad = [k for k, v in resumed.model.state_dict().items()
           if not torch.equal(v, want_w[k])]
    if bad:
        raise AssertionError(f"state_plane (c): {len(bad)} tensors differ "
                             f"from the straight run's ({bad[:3]})")
    out = {"steps": n, "resumed_losses": got, "launches": launches,
           "captures": resumed.capture_count,
           "checkpoint_bytes": sp_dir_bytes(d)}
    batch = next(as_feed((ids, spans), sizes.squad_batch,
                         shuffle=False).epoch(sizes.device, 0))
    out["stall"] = sp_stall(resumed, batch, sizes)
    # the saved model, served
    mdir = os.path.join(root, "squad_model")
    resumed.model.save_model(mdir)
    zoo = InferenceModel(device=sizes.device).load_zoo_model(
        mdir, dtype=torch.bfloat16)
    direct = InferenceModel(device=sizes.device).load_estimator(
        resumed, dtype=torch.bfloat16)
    for b in (1, 16):
        a, e = zoo.predict(ids[:b]), direct.predict(ids[:b])
        if not np.array_equal(a, e):
            raise AssertionError(f"state_plane (c): load_zoo_model's logits "
                                 f"at bucket {b} differ from "
                                 f"load_estimator's by "
                                 f"{np.abs(a - e).max()}")
    out["zoo_model_equals_estimator_at_buckets"] = [1, 16]
    del resumed, zoo, direct
    sp_free(sizes)
    ref = InferenceModel(device=sizes.device).load_zoo_model(mdir)
    want_rows = ref.predict(ids[:SP_SERVE])
    port = launcher._free_port()
    log = os.path.join(root, "zoo_serving.log")
    cmd = [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.server",
           "--model-dir", mdir, "--port", str(port), "--batch-size",
           str(SP_SERVE)]
    if not card:
        cmd += ["--device", sizes.device]
    with open(log, "w") as errf:
        proc = subprocess.Popen(
            cmd, stdout=subprocess.DEVNULL, stderr=errf,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            t0 = time.perf_counter()
            if not launcher.wait_serving_ready("127.0.0.1", port, proc=proc,
                                               timeout=300.0):
                raise AssertionError(f"state_plane (c): zoo-serving never "
                                     f"answered (rc {proc.poll()})")
            ready_s = time.perf_counter() - t0
            iq = InputQueue("127.0.0.1", port)
            oq = OutputQueue(input_queue=iq)
            try:
                uids = [iq.enqueue(f"r{i}", t=ids[i])
                        for i in range(SP_SERVE)]
                rows = [oq.query(u, timeout=120.0) for u in uids]
            finally:
                iq.close()
        finally:
            launcher._terminate_gang([proc], 10.0)
    if any(r is None for r in rows):
        with open(log) as f:
            raise AssertionError(f"state_plane (c): zoo-serving left "
                                 f"requests unanswered: {f.read()[-2000:]}")
    rows = np.stack(rows)
    top = max(1.0, float(np.abs(want_rows).max()))
    worst = float(np.abs(rows - want_rows).max()) / top
    if worst > TOL_SERVE_BF16:
        raise AssertionError(f"state_plane (c): zoo-serving's replies lie "
                             f"{worst} of max(1, |logit|) from predict")
    out["zoo_serving"] = {"requests": SP_SERVE, "ready_s": ready_s,
                          "bitwise_equal": bool(np.array_equal(
                              rows, want_rows)),
                          "worst_rel": worst, "tol": TOL_SERVE_BF16,
                          "returncode": proc.returncode}
    return out


def phase_state_plane(fa, bn, sizes=None) -> dict:
    """The state plane: (a) bench_checkpoint, (b) ResNet-50 resumed, (c)
    BERT-base SQuAD resumed and its saved model served (see the module
    docstring).  Checkpoints under a temporary directory, removed after;
    the manager's write errors must stay 0."""
    import shutil
    import tempfile

    sizes = sizes or StatePlaneSizes()
    t_phase = time.perf_counter()
    errors0 = sp_write_errors()
    root = tempfile.mkdtemp(prefix="zoo-state-plane-")
    try:
        sp_free(sizes)
        res = {"phase": "state_plane",
               "checkpoint_bench": sp_checkpoint_bench(sizes, root)}
        sp_free(sizes)
        res["resnet"] = sp_resnet(bn, sizes, root)
        sp_free(sizes)
        res["squad"] = sp_squad(fa, sizes, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if sp_write_errors() != errors0:
        raise AssertionError("state_plane: an async checkpoint write "
                             "failed (ckpt.write_errors)")
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


# -- autots -------------------------------------------------------------------

# bench.py's bench_autots, uncut: 2,000 hourly points of sin(2 pi t / 24) +
# 0.1 N(0, 1) from default_rng(0), the first 90% scaled, AutoTSEstimator(
# model=["lstm", "tcn"], past_seq_len=24, future_seq_len=4).fit(epochs=1,
# n_sampling=8, max_concurrent=2) at the forecasters' default widths
AUTOTS_POINTS = 2000
AUTOTS_PAST, AUTOTS_FUTURE = 24, 4
AUTOTS_TRIALS, AUTOTS_CONCURRENT = 8, 2
AUTOTS_BATCH = 32
AUTOTS_TCMF = (50, 500)          # (d): the TCMF panel, series x steps
AUTOTS_SESSIONS = 2048           # (d): SessionRecommender's seeded sessions
AUTOTS_ITEMS = 5000
# (a) trunks on the card against the same trunks on the CPU, f32 with TF32
# off (main() turns it off for the whole script): outputs, and the
# gradients of sum(out * r) over the input and every parameter, each within
# TOL_TRUNK of max(1, max |CPU|) of its tensor: the same arithmetic in
# another summation order (cuBLAS, cuDNN and the CPU's BLAS), carried
# through up to 24 recurrent steps
TOL_TRUNK = 1e-4
# bytes that may stay allocated on the card once the phase's estimators
# are dropped and cuBLAS's workspaces (one a stream) cleared
AUTOTS_FREED_SLACK = 1 << 20


class AutotsSizes:
    """The phase's shapes: the card's by default; the CPU rehearsal of the
    phase (tests and debugging) shrinks them."""

    def __init__(self, device="cuda", **kw):
        self.device = device
        self.points, self.trials = AUTOTS_POINTS, AUTOTS_TRIALS
        self.past, self.future = AUTOTS_PAST, AUTOTS_FUTURE
        self.hidden, self.channels = 32, (32, 32)
        self.tcmf, self.sessions, self.items = (AUTOTS_TCMF, AUTOTS_SESSIONS,
                                                AUTOTS_ITEMS)
        self.session_kw = {}
        self.vocab = 1000
        self.__dict__.update(kw)


def autots_series(points: int):
    """bench_autots's training split: the scaled first 90% of the series."""
    import pandas as pd

    from analytics_zoo_tpu_torch.chronos import TSDataset
    t_idx = pd.date_range("2024-01-01", periods=points, freq="h")
    rng = np.random.default_rng(0)
    value = (np.sin(np.arange(points) * (2 * np.pi / 24))
             + 0.1 * rng.normal(size=points))
    df = pd.DataFrame({"timestamp": t_idx, "value": value})
    train, _, _ = TSDataset.from_pandas(df, dt_col="timestamp",
                                        target_col="value", with_split=True,
                                        test_ratio=0.1)
    return train.scale()


def numpy_state(model: torch.nn.Module, seed: int) -> dict:
    """A ``state_dict`` for ``model`` drawn from numpy in the JAX tree's
    layout (N(0, 0.2^2) a leaf) and converted (``convert.py``)."""
    from analytics_zoo_tpu_torch.convert import (buffer_names,
                                                 from_jax_variables,
                                                 to_jax_variables)
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return (0.2 * rng.normal(size=node.shape)).astype(node.dtype)

    return from_jax_variables(draw(to_jax_variables(
        model.state_dict(), buffer_names(model))))


def autots_trunks(sizes) -> dict:
    """(name -> (trunk, input)) at the bench's shapes: batch 32, lookback
    24, horizon 4, one feature, the default widths; SessionRecommender and
    Seq2seq (attention) at theirs; Bidirectional(LSTM) in each merge
    mode."""
    from analytics_zoo_tpu_torch import nn as tnn
    from analytics_zoo_tpu_torch.chronos.forecaster import (_TCN,
                                                            _Seq2SeqTS,
                                                            _VanillaLSTM)
    from analytics_zoo_tpu_torch.chronos.mtnet import _MTNet
    from analytics_zoo_tpu_torch.models import Seq2seq, SessionRecommender
    rng = np.random.default_rng(SEED)
    b, t, h = AUTOTS_BATCH, sizes.past, sizes.hidden
    x = rng.normal(size=(b, t, 1)).astype(np.float32)
    head = dict(dropout=0.0, output_dim=1, horizon=sizes.future)
    sess = SessionRecommender(sizes.items, **sizes.session_kw)
    s2s = Seq2seq(sizes.vocab, use_attention=True)
    cases = {
        "lstm": (_VanillaLSTM(1, hidden_dim=h, **head), x),
        "seq2seq_lstm": (_Seq2SeqTS(1, h, rnn_type="lstm", **head), x),
        "seq2seq_gru": (_Seq2SeqTS(1, h, rnn_type="gru", **head), x),
        "tcn": (_TCN(1, sizes.channels, **head), x),
        "mtnet": (_MTNet(1, long_num=3, time_step=t // 4, cnn_hid_size=h,
                         rnn_hid_size=h, **head), x),
        "session_recommender": (sess, rng.integers(
            0, sizes.items, (b, sess.session_length)).astype(np.int64)),
        "seq2seq_attention": (s2s, rng.integers(
            0, sizes.vocab, (b, s2s.encoder_length + s2s.decoder_length)
        ).astype(np.int64)),
    }
    for mode in ("concat", "sum", "mul", "ave"):
        cases[f"bidirectional_{mode}"] = (tnn.Bidirectional(
            tnn.LSTM(1, h, return_sequences=True), mode), x)
    return cases


def trunk_grads(model, x, r, device):
    """(output, {name: gradient}) of sum(out * r) over ``x`` (when float)
    and every parameter, on ``device``."""
    xt = torch.from_numpy(x).to(device)
    if xt.is_floating_point():
        xt.requires_grad_(True)
    out = model(xt)
    names = [n for n, _ in model.named_parameters()]
    wrt = list(model.parameters()) + ([xt] if xt.requires_grad else [])
    grads = torch.autograd.grad((out * torch.from_numpy(r).to(device)).sum(),
                                wrt)
    got = {n: g.detach().cpu().numpy() for n, g in zip(names, grads)}
    if xt.requires_grad:
        got["input"] = grads[-1].cpu().numpy()
    return out.detach().cpu().numpy(), got


def autots_trunk_checks(sizes) -> dict:
    """(a): every trunk on the card against itself on the CPU, one numpy
    draw of weights, dropout 0."""
    import copy
    res = {}
    for i, (name, (model, x)) in enumerate(autots_trunks(sizes).items()):
        model.load_state_dict(numpy_state(model, SEED + i), strict=True)
        model.train()
        card = copy.deepcopy(model).to(sizes.device)
        with torch.no_grad():
            probe = model(torch.from_numpy(x))
        r = np.random.default_rng(SEED + 100 + i).normal(
            size=tuple(probe.shape)).astype(np.float32)
        want_out, want = trunk_grads(model, x, r, "cpu")
        got_out, got = trunk_grads(card, x, r, sizes.device)
        worst = {}
        for what, g, w in [("output", got_out, want_out)] + [
                (k, got[k], want[k]) for k in want]:
            err = float(np.abs(g - w).max()) / max(1.0,
                                                   float(np.abs(w).max()))
            worst[what] = err
            if not err <= TOL_TRUNK:
                raise AssertionError(f"autots (a) {name}: {what} on the "
                                     f"card differs from the CPU by {err} "
                                     f"of max(1, max |ref|) > {TOL_TRUNK}")
        res[name] = {"input_shape": list(x.shape),
                     "output_shape": list(want_out.shape),
                     "tensors": len(worst),
                     "worst_rel": max(worst.values()),
                     "worst_tensor": max(worst, key=worst.get)}
    return {"tol": TOL_TRUNK, "tf32": False, "trunks": res}


def device_ops_per_step(fn, steps: int) -> dict:
    """The card's operations a step over ``fn`` (``steps`` train steps)
    under ``torch.profiler``: kernels, and copies and memsets apart."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(e.count for e in events
                 if e.key.lower().startswith(("memcpy", "memset")))
    kernels = sum(e.count for e in events) - copies
    return {"kernels_per_step": kernels / steps,
            "copies_and_memsets_per_step": copies / steps}


def allocated(sizes) -> int:
    """The card's allocated bytes once dropped objects are collected."""
    import gc
    gc.collect()
    if sizes.device != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def recording_forecasters(autots_mod, out: list, sizes) -> dict:
    """``autots``'s model classes, each subclassed so that every ``fit``
    appends its estimator's captures to ``out`` (nothing of the forecaster
    is kept); returns the originals."""
    saved = dict(autots_mod._MODELS)

    def recorded(name, cls):
        class Recorded(cls):
            def fit(self, *args, **kwargs):
                est, first = self.est, []
                inner = est._train_step

                def step(batch):  # the first: an eager step, the capture
                    t1 = time.perf_counter()
                    loss = inner(batch)
                    if not first:
                        sp_sync(sizes)
                        first.append(time.perf_counter() - t1)
                    return loss

                est._train_step = step
                t0 = time.perf_counter()
                try:
                    hist = super().fit(*args, **kwargs)
                finally:
                    del est._train_step
                out.append({"model": name,
                            "capture_count": est.capture_count,
                            "batch_keys": len(est._graphs),
                            "steps": est._py_step,
                            "fit_s": time.perf_counter() - t0,
                            "first_step_s": first[0]})
                return hist

            def evaluate(self, *args, **kwargs):
                t0 = time.perf_counter()
                metrics = super().evaluate(*args, **kwargs)
                out.append({"model": name, "evaluate_s":
                            time.perf_counter() - t0})
                return metrics
        Recorded.__name__ = cls.__name__
        return Recorded

    autots_mod._MODELS.update({k: recorded(k, v) for k, v in saved.items()})
    return saved


def autots_search(sizes, train) -> tuple:
    """(b): bench_autots uncut through AutoTSEstimator on ``sizes.device``:
    (result, the fitted pipeline)."""
    from analytics_zoo_tpu_torch.chronos import AutoTSEstimator
    from analytics_zoo_tpu_torch.chronos import autots as autots_mod
    fits: list = []
    saved = recording_forecasters(autots_mod, fits, sizes)
    before = allocated(sizes)
    try:
        auto = AutoTSEstimator(model=["lstm", "tcn"],
                               past_seq_len=sizes.past,
                               future_seq_len=sizes.future,
                               device=sizes.device)
        t0 = time.perf_counter()
        pipeline = auto.fit(train, epochs=1, n_sampling=sizes.trials,
                            max_concurrent=AUTOTS_CONCURRENT)
        dt = time.perf_counter() - t0
    finally:
        autots_mod._MODELS.update(saved)
    after = allocated(sizes)
    trials = [{"trial": t.trial_id, "status": t.status,
               "model": t.config["model"], "metric": t.metric,
               "duration_s": t.duration_s, "error": t.error}
              for t in auto.trials]
    if [t["status"] for t in trials] != ["done"] * sizes.trials:
        raise AssertionError(f"autots (b): trials {trials}")
    one = int(sizes.device == "cuda")  # the CPU runs the eager step
    if any(f["capture_count"] != one or f["batch_keys"] != one
           for f in fits if "fit_s" in f):
        raise AssertionError(f"autots (b): captures per trial estimator "
                             f"{fits}")
    train.roll(pipeline.config["past_seq_len"], sizes.future)
    x, _ = train.to_numpy()
    pred = pipeline.predict(x)
    if pred.shape != (len(x), sizes.future, 1) or not np.all(
            np.isfinite(pred)):
        raise AssertionError(f"autots (b): the pipeline predicts "
                             f"{pred.shape}, finite {np.isfinite(pred).all()}")
    return {"n_trials": len(auto.trials), "search_s": dt,
            "autots_search_trials_per_hour": 3600.0 * len(auto.trials) / dt,
            "max_concurrent": AUTOTS_CONCURRENT,
            "best_config": auto.best_config, "trials": trials,
            "fits": fits, "allocated_bytes_before": before,
            "allocated_bytes_after": after,
            "pipeline_windows": len(x)}, pipeline


def autots_captured_vs_eager(sizes, train) -> dict:
    """(c): an LSTM and a TCN forecaster at the bench's shapes (batch 32,
    lookback 24, horizon 4, 1 feature, dropout 0.1), one seed: one ``fit``
    epoch eagerly and one from CUDA graphs under cuDNN's deterministic
    algorithms, their step losses bit for bit; then a warm epoch each way
    on the default algorithms (ms a step), the card's operations a step
    and a profiled epoch's idle share."""
    from analytics_zoo_tpu_torch.chronos import LSTMForecaster, TCNForecaster
    train.roll(sizes.past, sizes.future)
    xy = train.to_numpy()
    steps = len(xy[0]) // AUTOTS_BATCH
    on_card = sizes.device == "cuda"
    res = {"windows": len(xy[0]), "steps_an_epoch": steps}
    for name, cls, kw in (
            ("lstm", LSTMForecaster, {"hidden_dim": sizes.hidden}),
            ("tcn", TCNForecaster, {"num_channels": sizes.channels})):
        runs = {}
        for mode in ("eager", "captured"):
            fc = cls(sizes.past, sizes.future, 1, 1, seed=SEED,
                     device=sizes.device, **kw)
            fc.est.cuda_graphs = on_card and mode == "captured"
            losses = record_losses(fc.est)
            # the compared epochs under cuDNN's deterministic algorithms:
            # its default weight-gradient algorithms may add in another
            # order from run to run (on the H100 the TCN's eager and
            # captured epochs then differed by about 1e-7 of the loss);
            # the timed epochs after run on the defaults
            torch.backends.cudnn.deterministic = True
            try:
                fc.fit(xy, epochs=1, batch_size=AUTOTS_BATCH)
            finally:
                torch.backends.cudnn.deterministic = False
            del fc.est._train_step  # the class's step again
            ms, _ = fit_epoch(fc.est, xy, AUTOTS_BATCH) if on_card else \
                (None, None)
            run = {"step_ms": ms, "losses": losses,
                   "capture_count": fc.est.capture_count}
            if on_card:
                def epoch():
                    fc.fit(xy, epochs=1, batch_size=AUTOTS_BATCH)
                run.update(device_ops_per_step(epoch, steps))
                profiled = profiled_window(epoch, steps, {})
                idle_of(profiled, ms)
                run["profiled"] = profiled
            runs[mode] = run
        against = losses_against_eager(runs["captured"].pop("losses"),
                                       runs["eager"].pop("losses"),
                                       f"autots (c) {name}")
        if on_card and not against["bitwise_equal"]:
            raise AssertionError(f"autots (c) {name}: captured losses are "
                                 f"not the eager ones bit for bit: "
                                 f"{against}")
        res[name] = {**runs, "losses_against_eager": {
            k: v for k, v in against.items()
            if k not in ("captured", "eager")}}
    return res


def autots_saved_models(sizes, pipeline, root: str) -> dict:
    """(d): the pipeline saved and loaded on the card predicts equal bits;
    each forecaster family fits an epoch from CUDA graphs and predicts; a
    TCMFForecaster fits and predicts a 50 x 500 panel; SessionRecommender
    fits an epoch and its top-5 rows are a softmax of its predict;
    Seq2seq's greedy decode beside the CPU's."""
    import copy
    import os

    from analytics_zoo_tpu_torch.chronos import (
        LSTMForecaster, MTNetForecaster, Seq2SeqForecaster, TCMFForecaster,
        TSPipeline)
    from analytics_zoo_tpu_torch.models import Seq2seq, SessionRecommender
    res = {}
    train = autots_series(sizes.points)
    train.roll(pipeline.config["past_seq_len"], sizes.future)
    x, y = train.to_numpy()
    path = pipeline.save(os.path.join(root, "pipeline"))
    loaded = TSPipeline.load(path, device=sizes.device)
    want, got = pipeline.predict(x), loaded.predict(x)
    if not np.array_equal(got, want):
        raise AssertionError("autots (d): the loaded pipeline's predictions "
                             "are not the saved one's bit for bit")
    res["pipeline_reload_bitwise_equal"] = True
    res["pipeline_eval"] = loaded.evaluate((x, y))
    train.roll(sizes.past, sizes.future)
    xy = train.to_numpy()
    families = {}
    for name, cls, kw in (
            ("seq2seq_lstm", Seq2SeqForecaster, {"rnn_type": "lstm"}),
            ("seq2seq_gru", Seq2SeqForecaster, {"rnn_type": "gru"}),
            ("mtnet", MTNetForecaster, {"long_series_num": 3}),
            ("lstm_2_layers", LSTMForecaster, {"layer_num": 2})):
        fc = cls(sizes.past, sizes.future, 1, 1, seed=SEED,
                 device=sizes.device, **kw)
        t0 = time.perf_counter()
        hist = fc.fit(xy, epochs=1, batch_size=AUTOTS_BATCH)
        fit_s = time.perf_counter() - t0
        pred = fc.predict(xy[0])
        if not (np.isfinite(hist["loss"][0]) and np.all(np.isfinite(pred))):
            raise AssertionError(f"autots (d) {name}: loss {hist}, "
                                 f"predictions finite "
                                 f"{np.isfinite(pred).all()}")
        families[name] = {"epoch_loss": hist["loss"][0], "fit_s": fit_s,
                          "capture_count": fc.est.capture_count,
                          "mse": fc.evaluate(xy)["mse"]}
    res["families"] = families
    # TCMF on a 50 x 500 panel of seeded low-rank series
    rng = np.random.default_rng(SEED)
    n, t = sizes.tcmf
    tt = np.arange(t)
    panel = (rng.normal(size=(n, 3)) @ np.stack(
        [np.sin(tt * 2 * np.pi / 24), np.cos(tt * 2 * np.pi / 168),
         tt / t]) + 0.05 * rng.normal(size=(n, t))).astype(np.float32)
    tcmf = TCMFForecaster(device=sizes.device)
    t0 = time.perf_counter()
    factor_loss = tcmf.fit({"y": panel[:, :-24]})
    fit_s = time.perf_counter() - t0
    pred = tcmf.predict(horizon=24)
    if pred.shape != (n, 24) or not np.all(np.isfinite(pred)):
        raise AssertionError(f"autots (d) tcmf: predictions {pred.shape}")
    res["tcmf"] = {"panel": [n, t], "factor_loss": factor_loss,
                   "fit_s": fit_s, "tcn_capture_count":
                   tcmf._tcn_est.capture_count,
                   "holdout_mae": float(np.abs(pred - panel[:, -24:]).mean())}
    # SessionRecommender: an epoch from CUDA graphs, then its top 5
    sess = SessionRecommender(sizes.items, **sizes.session_kw)
    sess.init_weights(torch.Generator().manual_seed(SEED))
    sess.compile(loss="sparse_categorical_crossentropy", optimizer="adam",
                 learning_rate=1e-3, device=sizes.device)
    ids = rng.integers(0, sizes.items, (sizes.sessions,
                                        sess.session_length + 1))
    hist = sess.fit((ids[:, :-1].astype(np.int32),
                     ids[:, -1].astype(np.int32)), epochs=1,
                    batch_size=min(256, sizes.sessions), verbose=False)
    rows = sess.recommend_for_session(ids[:8, :-1], max_items=5)
    probs = torch.softmax(torch.from_numpy(
        sess.predict(ids[:8, :-1]).astype(np.float32)), dim=-1).numpy()
    for row, p in zip(rows, probs):
        top = np.argsort(-p)[:5]
        if [i for i, _ in row] != [int(i) for i in top] or \
                [q for _, q in row] != [float(p[i]) for i in top]:
            raise AssertionError("autots (d): recommend_for_session's rows "
                                 "are not the top 5 of a softmax of predict")
    res["session_recommender"] = {
        "epoch_loss": hist["loss"][0],
        "capture_count": sess.estimator.capture_count,
        "rows": len(rows), "top5_equal_softmax_of_predict": True}
    # Seq2seq's greedy decode on the card beside the same weights' on the CPU
    s2s = Seq2seq(sizes.vocab, use_attention=True)
    s2s.load_state_dict(numpy_state(s2s, SEED), strict=True)
    cpu = copy.deepcopy(s2s)
    s2s.compile(loss="sparse_categorical_crossentropy", device=sizes.device)
    cpu.compile(loss="sparse_categorical_crossentropy", device="cpu")
    enc = rng.integers(0, sizes.vocab, (16, s2s.encoder_length))
    got, want = s2s.infer(enc, start_id=1), cpu.infer(enc, start_id=1)
    if got.shape != (16, s2s.decoder_length) or got.min() < 0 or \
            got.max() >= sizes.vocab:
        raise AssertionError(f"autots (d): Seq2seq.infer gave {got.shape}")
    res["seq2seq_infer"] = {"shape": list(got.shape),
                            "ids_equal_cpu_share": float(np.mean(got == want))}
    return res


def autots_kernel_counts(fa, bn, fx) -> dict:
    """Every kernel's launch count since ``autots_reset_counts``."""
    counts = dict(fa.KERNEL_LAUNCHES)
    counts.update({f"{BN_KERNEL}_{k}": v
                   for k, v in bn.KERNEL_LAUNCHES.items()})
    counts.update({f"{BN_KERNEL}_{k}": v
                   for k, v in bn.SPLIT_KERNEL_LAUNCHES.items()})
    counts.update({f"{XENT_KERNEL}_{k}": v
                   for k, v in fx.KERNEL_LAUNCHES.items()})
    return counts


def autots_reset_counts(fa, bn, fx) -> None:
    reset_counts(fa)
    bn.reset_launches()
    fx.reset_launches()


def phase_autots(fa, bn, fx, sizes=None) -> dict:
    """Forecasting and AutoML (see the module docstring): (a) the trunks on
    the card against the CPU, then the main path with every kernel count
    set to 0 just before it: (b) bench_autots uncut, (c) captured against
    eager forecasters, (d) saved models and the other entry points; no
    kernel of the port lies on it, so every count must still be 0."""
    import shutil
    import tempfile

    sizes = sizes or AutotsSizes()
    t_phase = time.perf_counter()
    res = {"phase": "autots"}
    root = tempfile.mkdtemp(prefix="zoo-autots-")
    done = False
    try:
        res["trunks"] = autots_trunk_checks(sizes)
        autots_reset_counts(fa, bn, fx)
        res["search"], pipeline = autots_search(sizes, autots_series(
            sizes.points))
        res["captured_vs_eager"] = autots_captured_vs_eager(
            sizes, autots_series(sizes.points))
        res["saved_models"] = autots_saved_models(sizes, pipeline, root)
        done = True
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if not done:  # what ran before the failure, for its reader
            emit({**res, "failed": True})
    counts = autots_kernel_counts(fa, bn, fx)
    if any(counts.values()):
        raise AssertionError(f"autots: a kernel of the port launched on a "
                             f"path with none: {counts}")
    res["kernel_launches"] = counts
    # the search's graphs and pools, and the pipeline's, freed once dropped
    del pipeline
    res["search"]["allocated_bytes_dropped"] = allocated(sizes)
    if sizes.device == "cuda":
        torch._C._cuda_clearCublasWorkspaces()
    res["search"]["allocated_bytes_dropped_cublas_cleared"] = \
        allocated(sizes)
    grown = res["search"]["allocated_bytes_dropped_cublas_cleared"] - \
        res["search"]["allocated_bytes_before"]
    if grown > AUTOTS_FREED_SLACK:
        raise AssertionError(f"autots: {grown} bytes still allocated on the "
                             f"card once the search's estimators were "
                             f"dropped")
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


# -- readers: the input readers and the models they feed ---------------------

READERS_IMAGES = 3000       # seeded 256 x 256 JPEGs over 100 class dirs
READERS_CLASSES = 100
READERS_SIDE = 256
READERS_READAHEAD = 8       # FileReadahead depth of each decode worker
READERS_EPOCHS = 2          # the timed ImageSet fit, after a capturing one
READERS_CMP_STEPS = 4       # captured against eager, one decode worker
READERS_RESIDENT = 20       # the resident _multi_step window of the fit's
#                             estimator
NEWS20 = dict(docs=4096, words=(100, 1000), vocab=20000, classes=20)
NEWS20_SEQ = 500
TEXT_BATCH = 128
# TextClassifier's steps: compared (captured against eager) and timed
# (the window), by encoder; the recurrent ones are 500-step Python loops
TEXT_CMP_STEPS = {"cnn": 8, "lstm": 2, "gru": 2}
TEXT_WINDOW = {"cnn": 20, "lstm": 3, "gru": 3}
WIKIQA = dict(text1_length=10, text2_length=40, embed_size=300,
              kernel_num=21)
WIKIQA_ROWS = 4096
SSD = dict(class_num=21, backbone_depth=18, image_size=300)
SSD_BATCH = 8
SSD_SCORE = 0.1             # predict_image_set's score threshold here
SSD_HEAD_GAIN = 0.05        # the heads' kernels x he-normal: O(1) outputs
TOL_SSD = 1e-4              # of max(1, |CPU|): the card's raw outputs
IP_FILES, IP_SIDE, IP_BATCH = 96, 224, 64   # bench_input_pipeline


class ReadersSizes:
    """The phase's shapes: the card's by default; the CPU rehearsal of the
    phase (tests and debugging) shrinks them."""

    def __init__(self, device="cuda", **kw):
        self.device = device
        self.images, self.classes, self.side = (READERS_IMAGES,
                                                READERS_CLASSES, READERS_SIDE)
        self.crop, self.batch = IMAGE, RESNET_BATCH
        self.resnet = dict(norm="batch", dtype="bfloat16")
        self.workers = max(4, min(16, os.cpu_count() or 8))
        self.epochs, self.cmp_steps, self.resident = (
            READERS_EPOCHS, READERS_CMP_STEPS, READERS_RESIDENT)
        self.news20, self.seq, self.text_batch = (dict(NEWS20), NEWS20_SEQ,
                                                  TEXT_BATCH)
        self.text = dict(token_length=200, encoder_output_dim=256)
        self.text_cmp, self.text_window = (dict(TEXT_CMP_STEPS),
                                           dict(TEXT_WINDOW))
        self.wikiqa, self.knrm_rows = dict(WIKIQA), WIKIQA_ROWS
        self.knrm_steps = (8, 20)  # compared, window
        self.ssd, self.ssd_batch = dict(SSD), SSD_BATCH
        self.ip = (IP_FILES, IP_SIDE, IP_BATCH)
        self.missing = None  # {package: part}; None probes the imports
        self.__dict__.update(kw)


def rd_window(sizes, fn, steps: int) -> float:
    """ms a step of ``fn()`` (``steps`` train steps), synchronised at its
    ends only."""
    sp_sync(sizes)
    t0 = time.perf_counter()
    float(fn()[-1])
    return (time.perf_counter() - t0) * 1e3 / steps


def rd_missing(sizes) -> dict:
    """The parts of the phase whose package is not installed, by
    package."""
    if sizes.missing is not None:
        return dict(sizes.missing)
    import importlib.util
    parts = {"PIL": "JPEG decode (ImageSet, NNImageReader, the detector's "
                    "images)",
             "pyarrow": "read_parquet"}
    return {pkg: part for pkg, part in parts.items()
            if importlib.util.find_spec(pkg) is None}


def write_jpegs(root: str, n: int, classes: int, side: int,
                seed: int = SEED) -> None:
    """``n`` seeded JPEGs of ``side`` x ``side`` over ``classes`` class
    directories: a smooth random field (8 x 8 upsampled) plus pixel noise,
    so that they compress and decode like photographs, not like noise."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)
    noise = rng.integers(-12, 13, (n, side, side, 3), dtype=np.int16)
    for c in range(classes):
        os.makedirs(os.path.join(root, f"class{c:03d}"), exist_ok=True)

    def one(i):
        img = np.asarray(Image.fromarray(coarse[i]).resize(
            (side, side), Image.BILINEAR), np.int16) + noise[i]
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(root, f"class{i % classes:03d}", f"{i:05d}.jpg"),
            quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(n)))


class RawImageLoader:
    """bench.py's ``_RawImageLoader`` on the port's ``FileReadahead``: raw
    uint8 files read through a per-worker readahead and "decoded" by a
    numpy flip and brightness jitter (a GIL-holding stand-in for JPEG
    decode); the streaming feed's ``hint_indices``/``feed_stats``
    protocols as ImageSet's."""

    def __init__(self, paths, size, readahead=8, classes=1000):
        self.paths = list(paths)
        self.size = size
        self.readahead = readahead
        self.classes = classes
        self._ra_lock = threading.Lock()

    def _reader(self):
        from analytics_zoo_tpu_torch.data import FileReadahead
        ra = self.__dict__.get("_ra")
        if ra is not None and ra.pid == os.getpid():
            return ra
        with self._ra_lock:  # worker threads share one reader
            ra = self.__dict__.get("_ra")
            if ra is None or ra.pid != os.getpid():
                ra = FileReadahead(depth=self.readahead)
                self.__dict__["_ra"] = ra
            return ra

    def hint_indices(self, indices):
        self._reader().hint([self.paths[i % len(self.paths)]
                             for i in indices])

    def feed_stats(self):
        return {"io_wait_ms": self._reader().wait_ms}

    def load(self, i, rng=None):
        raw = self._reader().get(self.paths[i % len(self.paths)])
        img = np.frombuffer(raw, np.uint8).reshape(self.size, self.size, 3)
        img = img[:, ::-1]                        # flip
        img = np.clip(img.astype(np.int16) + (i % 7), 0, 255)  # jitter
        return {"x": img.astype(np.uint8),
                "y": np.int32(i % self.classes)}


def write_raw(root: str, n: int, side: int) -> list:
    """``n`` seeded raw uint8 ``side`` x ``side`` x 3 images (bench.py's
    input-pipeline files)."""
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(root, f"img{i:03d}.raw")
        rng.integers(0, 256, (side, side, 3), dtype=np.uint8).tofile(p)
        paths.append(p)
    return paths


def stage_p50(snap: dict, name: str, field: str = "p50") -> float:
    v = snap.get(name)
    return v[field] if isinstance(v, dict) and v.get("count") else 0.0


def readers_image_feed(sizes, root: str, missing: dict, n=None,
                       workers=None, **kw):
    """The readers' image feed: ``ImageSet.read`` -> resize to the side,
    random crop, random flip -> ``to_feed`` on decode processes with
    readahead; without PIL, bench.py's raw-file loader at the crop's size
    on the same feed (no decoder needed)."""
    from analytics_zoo_tpu_torch.data import (ImageRandomCrop,
                                              ImageRandomFlip, ImageResize,
                                              ImageSet, StreamingDataFeed)
    kw = dict(batch_size=sizes.batch, shuffle=True, seed=SEED,
              num_workers=workers or sizes.workers, workers="process", **kw)
    if "PIL" not in missing:
        iset = ImageSet.read(os.path.join(root, "jpeg")).transform(
            ImageResize(sizes.side, sizes.side),
            ImageRandomCrop(sizes.crop, sizes.crop), ImageRandomFlip())
        if n is not None:
            iset = ImageSet(iset.paths[:n], iset.labels[:n],
                            transforms=iset.transforms)
        return iset.to_feed(readahead=READERS_READAHEAD, **kw)
    loader = RawImageLoader(write_raw(os.path.join(root, "raw"), 96,
                                      sizes.crop), sizes.crop,
                            READERS_READAHEAD, sizes.classes)
    return StreamingDataFeed(n or sizes.images, loader.load, **kw)


def readers_imageset_fit(fa, bn, fx, sizes, root: str,
                         missing: dict) -> dict:
    """The kernel path: the ImageSet feed into bench.py's ResNet-50
    (``TrainNet``, bf16, sgd 0.1) through ``Estimator.fit(prefetch=2)``
    from CUDA graphs: a capturing epoch, then ``sizes.epochs`` timed with
    every kernel count set to 0 just before them (53 launches a step each
    way from the replays); the resident ``_multi_step`` window of the same
    estimator on one of the feed's batches; the feed's stage p50s; then
    the captured fit against the eager fit over the same images and seed
    (one decode worker, so that the augmentation draws the same) under
    cuDNN's deterministic algorithms, equal bits."""
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.core import metrics as metrics_lib
    from analytics_zoo_tpu_torch.nn import BatchNormalization
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    card = sizes.device == "cuda"
    variables = random_resnet_variables(TrainNet(**sizes.resnet), SEED)

    def estimator(graphs=True):
        m = TrainNet(**sizes.resnet)
        m.load_state_dict(from_jax_variables(variables), strict=True)
        return Estimator.from_keras(
            m, loss="sparse_categorical_crossentropy", optimizer="sgd",
            learning_rate=RESNET_LR, seed=SEED, device=sizes.device,
            cuda_graphs=graphs)

    n_bn = sum(isinstance(m, BatchNormalization)
               for m in TrainNet(**sizes.resnet).modules())
    sfx = "bf16" if sizes.resnet.get("dtype") == "bfloat16" else "f32"
    steps = sizes.images // sizes.batch
    est = estimator()
    t0 = time.perf_counter()
    est.fit(readers_image_feed(sizes, root, missing), epochs=1,
            batch_size=sizes.batch, verbose=False, prefetch=2)
    capture_epoch_s = time.perf_counter() - t0
    calls = []
    inner = est._train_step

    def step(batch):
        calls.append(time.perf_counter())
        return inner(batch)

    est._train_step = step
    reg = metrics_lib.get_registry()
    reg.reset()
    autots_reset_counts(fa, bn, fx)
    t0 = time.perf_counter()
    hist = est.fit(readers_image_feed(sizes, root, missing),
                   epochs=sizes.epochs, batch_size=sizes.batch,
                   verbose=False, prefetch=2)
    fit_s = time.perf_counter() - t0
    counts = autots_kernel_counts(fa, bn, fx)
    want = {k: 0 for k in counts}
    if card:
        for p in ("fwd", "bwd"):
            want[f"{BN_KERNEL}_{p}_{sfx}"] = n_bn * steps * sizes.epochs
    if counts != want:
        raise AssertionError(f"readers imageset fit: launches {counts}; "
                             f"want {want}")
    snap = reg.snapshot()
    del est._train_step
    if len(calls) != steps * sizes.epochs or not all(
            map(math.isfinite, hist["loss"])):
        raise AssertionError(f"readers imageset fit: {len(calls)} steps, "
                             f"loss {hist['loss']}")
    feed_it = readers_image_feed(sizes, root, missing).epoch(
        est.device, 0, place=False)
    try:
        host = next(feed_it)
        b0 = {k: torch.from_numpy(np.array(v)).to(est.device)
              for k, v in host.items()}
        getattr(host, "release", lambda: None)()
    finally:
        feed_it.close()
    bn.reset_launches()
    resident_ms = rd_window(
        sizes, lambda: est._multi_step(b0, sizes.resident), sizes.resident)
    resident_counts = dict(bn.KERNEL_LAUNCHES)
    if card and resident_counts[f"fwd_{sfx}"] != n_bn * sizes.resident:
        raise AssertionError(f"readers resident window: launches "
                             f"{resident_counts}")
    caps = captures(est, "readers imageset fit")
    gaps = np.diff(calls) * 1e3
    images_s = steps * sizes.epochs * sizes.batch / fit_s
    del est, b0
    sp_free(sizes)
    # captured against eager over the same images, one decoder
    cmp = {}
    torch.backends.cudnn.deterministic = True
    try:
        for graphs in (False, True):
            e = estimator(graphs)
            losses = record_losses(e)
            e.fit(readers_image_feed(sizes, root, missing,
                                     n=sizes.cmp_steps * sizes.batch,
                                     workers=1),
                  epochs=1, batch_size=sizes.batch, verbose=False,
                  prefetch=2)
            cmp[graphs] = [float(v) for v in losses]
            del e
            sp_free(sizes)
    finally:
        torch.backends.cudnn.deterministic = False
    against = losses_against_eager(cmp[True], cmp[False],
                                   "readers imageset captured vs eager")
    if card and not against["bitwise_equal"]:
        raise AssertionError(f"readers imageset: captured losses are not "
                             f"the eager ones bit for bit: {against}")
    return {
        "source": "ImageSet JPEG" if "PIL" not in missing
        else "raw uint8 files (no PIL)",
        "images": sizes.images, "classes": sizes.classes,
        "side": sizes.side, "crop": sizes.crop, "batch": sizes.batch,
        "decode_workers": sizes.workers, "backend": "process",
        "readahead": READERS_READAHEAD, "host_cores": os.cpu_count(),
        "steps_an_epoch": steps, "epochs_timed": sizes.epochs,
        "capture_epoch_s": capture_epoch_s, "fit_s": fit_s,
        "ms_a_step": fit_s * 1e3 / (steps * sizes.epochs),
        "step_call_gap_ms_p50": float(np.median(gaps)) if len(gaps) else
        None, "images_per_s": images_s,
        "resident_window_ms_a_step": resident_ms,
        "vs_resident": fit_s * 1e3 / (steps * sizes.epochs) / resident_ms,
        "loss": hist["loss"],
        "feed_stage_p50_ms": {
            "io_wait": stage_p50(snap, "feed.io_wait_ms"),
            "decode_batch": stage_p50(snap, "feed.decode_ms"),
            "load_sample": stage_p50(snap, "feed.load_ms"),
            "h2d": stage_p50(snap, "feed.h2d_ms"),
            "data_wait": stage_p50(snap, "train.data_wait_ms")},
        "launches": counts, "launches_a_step_each_way": n_bn if card else 0,
        "resident_launches": resident_counts,
        "losses_against_eager": {k: v for k, v in against.items()
                                 if k not in ("captured", "eager")},
        **caps}


def readers_input_pipeline(sizes, root: str) -> dict:
    """bench.py's ``bench_input_pipeline`` uncut on the port: raw uint8
    files through ``FileReadahead`` and a numpy flip and jitter, each
    backend's images/s with the batches placed on the card, the stage
    p50s and the stage that caps the pipeline (decode is per worker, so
    its share divides by the workers)."""
    from analytics_zoo_tpu_torch.core import metrics as metrics_lib
    from analytics_zoo_tpu_torch.data import StreamingDataFeed
    n_files, size, batch = sizes.ip
    n_workers = max(2, min(8, os.cpu_count() or 1))
    prefetch = 4
    warm = n_workers + prefetch
    meas = 3 * warm
    loader = RawImageLoader(write_raw(os.path.join(root, "ip"), n_files,
                                      size), size)
    reg = metrics_lib.get_registry()

    def run(backend):
        reg.reset()
        feed = StreamingDataFeed(
            num_samples=(warm + meas + 2) * batch, load_sample=loader.load,
            batch_size=batch, shuffle=False, num_workers=n_workers,
            prefetch_batches=prefetch, workers=backend)
        it = feed.epoch(torch.device(sizes.device), 0)  # h2d on the clock
        try:
            for _ in range(warm):
                next(it)
            t0 = time.perf_counter()
            for _ in range(meas):
                b = next(it)
            sp_sync(sizes)
            dt = time.perf_counter() - t0
        finally:
            it.close()
        snap = reg.snapshot()
        load_mean = stage_p50(snap, "feed.load_ms", "mean")
        decode_mean = stage_p50(snap, "feed.decode_ms", "mean")
        del b
        return meas * batch / dt, {
            "io_wait_ms_p50": stage_p50(snap, "feed.io_wait_ms"),
            "decode_ms_p50": stage_p50(snap, "feed.decode_ms"),
            "load_ms_p50_per_sample": stage_p50(snap, "feed.load_ms"),
            "assemble_ms_mean": max(0.0, decode_mean - load_mean * batch),
            "h2d_ms_p50": stage_p50(snap, "feed.h2d_ms")}

    out = {"batch": batch, "num_workers": n_workers, "image_size": size,
           "host_cores": os.cpu_count(), "files": n_files}
    for backend in ("thread", "process"):
        ips, stages = run(backend)
        out[backend] = {"images_per_s": ips, "stages": stages}
    best = max(("thread", "process"), key=lambda b: out[b]["images_per_s"])
    per_batch_ms = 1000.0 * batch / out[best]["images_per_s"]
    st = out[best]["stages"]
    shares = {"io": st["io_wait_ms_p50"] / n_workers / per_batch_ms,
              "decode": st["decode_ms_p50"] / n_workers / per_batch_ms,
              "h2d": st["h2d_ms_p50"] / per_batch_ms}
    out.update(process_over_thread=out["process"]["images_per_s"]
               / max(out["thread"]["images_per_s"], 1e-9),
               stage_shares_of_batch=shares,
               bottleneck_stage=max(shares, key=shares.get))
    return out


def _slot_passes(pool, src, out) -> None:
    """In a forked decoder: fill slot 0 row by row twice, timing each
    pass."""
    views = pool.views(0)["x"]
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        for k in range(len(views)):
            views[k] = src
        times.append((time.perf_counter() - t0) * 1e3)
    out.put(times)


def readers_slot_passes(sizes, repeats: int = 3) -> dict:
    """ROADMAP's question on the streaming feed's first chunks: a forked
    decoder's first and second pass over one fresh shared-memory slot of
    one ResNet batch (``batch`` x crop x crop x 3 uint8), each pool made
    anew; the first pass faults the slot's pages in.  Forked, not
    spawned: the feed's process backend forks its decoders, and this
    measures one of them."""
    import multiprocessing as mp
    from analytics_zoo_tpu_torch.data.shm_pool import ShmBatchPool
    ctx = mp.get_context("fork")
    src = np.random.default_rng(SEED).integers(
        0, 256, (sizes.crop, sizes.crop, 3), dtype=np.uint8)
    passes = []
    for _ in range(repeats):
        p = None
        pool = ShmBatchPool(2, sizes.batch,
                            {"x": ((sizes.crop, sizes.crop, 3), np.uint8)})
        try:
            out = ctx.SimpleQueue()
            p = ctx.Process(target=_slot_passes, args=(pool, src, out))
            p.start()
            passes.append(out.get())  # drained before the join
            p.join(timeout=60)
        finally:
            if p is not None and p.is_alive():
                p.kill()
                p.join()
            pool.close()
    first, second = [p[0] for p in passes], [p[1] for p in passes]
    return {"slot_bytes": sizes.batch * sizes.crop * sizes.crop * 3,
            "first_pass_ms": first, "second_pass_ms": second,
            "first_minus_second_ms": [a - b for a, b in zip(first, second)]}


def news20_csv(sizes, path: str) -> None:
    """A news20-shaped CSV: documents of 100-1,000 words drawn Zipf-like
    (p ~ 1 / rank^1.07) from a 20,000-word vocabulary, 20 labels."""
    import pandas as pd
    n = sizes.news20
    rng = np.random.default_rng(SEED + 19)
    p = 1.0 / np.arange(1, n["vocab"] + 1) ** 1.07
    lens = rng.integers(n["words"][0], n["words"][1] + 1, n["docs"])
    ids = rng.choice(n["vocab"], size=int(lens.sum()), p=p / p.sum())
    words = np.asarray([f"w{i}" for i in range(n["vocab"])])
    cuts = np.cumsum(lens)[:-1]
    texts = [" ".join(words[part]) for part in np.split(ids, cuts)]
    pd.DataFrame({"text": texts,
                  "label": rng.integers(0, n["classes"], n["docs"])}
                 ).to_csv(path, index=False)


def captured_and_eager(sizes, make, loss, xy, cmp_steps, window, lr=1e-3):
    """A model built by ``make()`` (one init) fitted eagerly and from CUDA
    graphs over the first ``cmp_steps`` batches under cuDNN's
    deterministic algorithms (step losses, equal bits on the card), then
    each estimator's window of ``window`` steps on one batch (ms a step;
    on the card its kernels a step and the busy and idle share of a
    profiled step or five), and the captured one's fit over all of ``xy``
    (one epoch, ms a step)."""
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    card = sizes.device == "cuda"
    init = make().state_dict()
    x, y = xy
    n = cmp_steps * sizes.text_batch
    b0 = {"x": torch.from_numpy(x[:sizes.text_batch]).to(sizes.device),
          "y": torch.from_numpy(y[:sizes.text_batch]).to(sizes.device)}
    runs = {}
    for graphs in (False, True):
        model = make()
        model.load_state_dict(init)
        est = Estimator.from_keras(model, loss=loss, optimizer="adam",
                                   learning_rate=lr, seed=SEED,
                                   device=sizes.device,
                                   cuda_graphs=graphs)
        losses = record_losses(est)
        torch.backends.cudnn.deterministic = True
        t0 = time.perf_counter()
        try:
            est.fit((x[:n], y[:n]), epochs=1, batch_size=sizes.text_batch,
                    verbose=False)
        finally:
            torch.backends.cudnn.deterministic = False
        run = {"compared_fit_s": time.perf_counter() - t0,
               "losses": [float(v) for v in losses]}
        del est._train_step
        run["window_ms_a_step"] = rd_window(
            sizes, lambda: est._multi_step(b0, window), window)
        if card:  # the card's kernels a step, busy and idle, profiled
            # over a step or five (a recurrent step is 18,000-26,000
            # kernels, whose trace the profiler takes seconds to read)
            steps = 1 if window < 5 else 5
            run["profiled"] = profiled_window(
                lambda: est._multi_step(b0, steps), steps, {})
            idle_of(run["profiled"], run["window_ms_a_step"])
            run["kernels_per_step"] = \
                run["profiled"]["device_ops"]["kernels"] / steps
        if graphs:
            steps = len(x) // sizes.text_batch
            t0 = time.perf_counter()
            hist = est.fit((x, y), epochs=1, batch_size=sizes.text_batch,
                           verbose=False)
            run["fit_ms_a_step"] = (time.perf_counter() - t0) * 1e3 / steps
            run["fit_steps"] = steps
            run["fit_loss"] = hist["loss"][0]
            if not math.isfinite(hist["loss"][0]):
                raise AssertionError(f"readers: fit loss {hist['loss']}")
            run.update(captures(est, "readers text"))
        runs[graphs] = run
        del est
        sp_free(sizes)
    against = losses_against_eager(runs[True].pop("losses"),
                                   runs[False].pop("losses"),
                                   "readers captured vs eager")
    if card and not against["bitwise_equal"]:
        raise AssertionError(f"readers: captured losses are not the eager "
                             f"ones bit for bit: {against}")
    return {"captured": runs[True], "eager": runs[False],
            "compared_steps": cmp_steps, "window_steps": window,
            "losses_against_eager": {k: v for k, v in against.items()
                                     if k not in ("captured", "eager")}}


def readers_text(sizes, root: str) -> dict:
    """news20: ``TextSet.read_csv`` -> tokenize -> normalize ->
    ``word2idx(max_words_num=20000)`` -> ``shape_sequence(500)`` ->
    ``generate_sample``, into ``TextClassifier`` (20 classes, tokens 200,
    encoder width 256; its table 20,000 words + PAD + OOV) with each
    encoder; WikiQA-shaped query/doc ids into ``KNRM`` (10 + 40 ids,
    embed 300, 21 kernels), first on the card against itself on the CPU
    at the same weights, then fitted captured and eager."""
    from analytics_zoo_tpu_torch.data import TextSet
    from analytics_zoo_tpu_torch.models import KNRM, TextClassifier
    path = os.path.join(root, "news20.csv")
    news20_csv(sizes, path)
    t0 = time.perf_counter()
    ts = (TextSet.read_csv(path).tokenize().normalize()
          .word2idx(max_words_num=sizes.news20["vocab"])
          .shape_sequence(sizes.seq).generate_sample())
    x, y = ts.to_numpy()
    pipeline_s = time.perf_counter() - t0
    vocab = ts.vocab_size()
    if x.shape != (sizes.news20["docs"], sizes.seq) or x.max() >= vocab:
        raise AssertionError(f"readers: TextSet ids {x.shape}, max "
                             f"{x.max()} for a table of {vocab}")
    out = {"docs": len(x), "seq": sizes.seq, "vocab_rows": vocab,
           "textset_pipeline_s": pipeline_s,
           "pad_share": float((x == 0).mean())}
    gen = torch.Generator().manual_seed(SEED)
    for enc in ("cnn", "lstm", "gru"):
        def make(enc=enc):
            return TextClassifier(
                class_num=sizes.news20["classes"], vocab_size=vocab,
                sequence_length=sizes.seq, encoder=enc,
                **sizes.text).init_weights(gen)
        out[f"text_classifier_{enc}"] = captured_and_eager(
            sizes, make, "sparse_categorical_crossentropy", (x, y),
            sizes.text_cmp[enc], sizes.text_window[enc])
    # WikiQA-shaped ids: Zipf-like over the same vocabulary; half the
    # pairs share three query tokens with their document
    rng = np.random.default_rng(SEED + 20)
    w = sizes.wikiqa
    p = 1.0 / np.arange(1, vocab - 1) ** 1.07
    ids = 2 + rng.choice(vocab - 2, size=(sizes.knrm_rows, w["text1_length"]
                                          + w["text2_length"]),
                         p=p / p.sum())
    pos = rng.random(sizes.knrm_rows) < 0.5
    for r in np.where(pos)[0]:
        slots = rng.choice(w["text2_length"], 3, replace=False)
        ids[r, w["text1_length"] + slots] = ids[r, rng.choice(
            w["text1_length"], 3, replace=False)]
    kx = ids.astype(np.int32)
    ky = pos.astype(np.float32)[:, None]

    def make_knrm():
        return KNRM(vocab_size=vocab, **w).init_weights(gen)

    model = make_knrm().eval()
    with torch.no_grad():
        ref = model(torch.from_numpy(kx[:256])).numpy()
        got = model.to(sizes.device)(torch.from_numpy(kx[:256]).to(
            sizes.device)).cpu().numpy()
    err = float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))
    if err > TOL_SSD:
        raise AssertionError(f"readers: KNRM on the card vs the CPU {err}")
    out["knrm"] = {"rows": len(kx), "card_vs_cpu_rel_err": err,
                   **captured_and_eager(sizes, make_knrm,
                                        "binary_crossentropy", (kx, ky),
                                        *sizes.knrm_steps)}
    return out


def detector_variables(model, seed: int) -> dict:
    """``random_resnet_variables`` with the box and class heads' kernels
    ``SSD_HEAD_GAIN`` times as wide: loc deltas and logits O(1), as a
    trained detector's are (at he-normal heads on this trunk they reach
    1e2, and decode's exp turns rounding into whole pixels)."""
    tree = random_resnet_variables(model, seed)
    for name, node in tree["params"]["ssd"].items():
        if name.startswith(("loc_", "cls_")):
            node["kernel"] = node["kernel"] * np.float32(SSD_HEAD_GAIN)
    return tree


def same_detections(got, want, thr: float) -> dict:
    """Detections of each image against the reference's: the same labels
    and count, scores and boxes within TOL_SSD of max(1, |ref|); a
    detection whose reference score lies within TOL_SSD of the threshold
    may be on either side of it."""
    worst, n = 0.0, 0
    for g, w in zip(got, want):
        key = lambda d: (str(d[0]), tuple(np.round(d[2], 3)))  # noqa: E731
        w = [d for d in w if abs(d[1] - thr) > TOL_SSD]
        g = [d for d in g if abs(d[1] - thr) > TOL_SSD]
        g, w = sorted(g, key=key), sorted(w, key=key)
        if [d[0] for d in g] != [d[0] for d in w]:
            raise AssertionError(f"readers detector: labels "
                                 f"{[d[0] for d in g]} against "
                                 f"{[d[0] for d in w]}")
        for a, b in zip(g, w):
            top = max(1.0, float(np.abs(b[2]).max()))
            worst = max(worst, abs(a[1] - b[1]),
                        float(np.abs(a[2] - b[2]).max()) / top)
        n += len(g)
    if worst > TOL_SSD:
        raise AssertionError(f"readers detector: detections differ by "
                             f"{worst}")
    return {"detections": n, "worst_rel": worst, "tol": TOL_SSD}


def readers_detector(sizes, root: str, missing: dict) -> dict:
    """``ObjectDetector.predict_image_set`` at 300 (ResNet-18 trunk, 21
    classes, maps 38/19/10/5) over decoded JPEGs on the card, against the
    same model's raw outputs and post-processing on the CPU."""
    import copy
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.data import (ImageNormalize, ImageResize,
                                              ImageSet)
    from analytics_zoo_tpu_torch.models import ObjectDetector
    s = sizes.ssd["image_size"]
    if "PIL" in missing:
        x = np.random.default_rng(SEED).normal(
            size=(sizes.ssd_batch, s, s, 3)).astype(np.float32)
    else:
        iset = ImageSet.read(os.path.join(root, "jpeg"))
        iset = ImageSet(iset.paths[:sizes.ssd_batch]).transform(
            ImageResize(s, s), ImageNormalize())
        x = iset.to_shards(1).concatenated()["x"]
    det = ObjectDetector(**sizes.ssd)
    det.load_state_dict(from_jax_variables(
        detector_variables(det, SEED)), strict=True)
    cpu = copy.deepcopy(det)
    cpu.compile(loss="mse", device="cpu")
    ref = cpu.predict(x, batch_size=sizes.ssd_batch)
    det.compile(loss="mse", device=sizes.device)
    raw = det.predict(x, batch_size=sizes.ssd_batch)
    err = float(np.abs(raw - ref).max() / max(1.0, np.abs(ref).max()))
    if raw.shape != (len(x), len(det.ssd.anchors), 4 + det.class_num) \
            or err > TOL_SSD:
        raise AssertionError(f"readers detector: raw {raw.shape}, "
                             f"{err} of max(1, |CPU|)")
    sp_sync(sizes)
    t0 = time.perf_counter()
    dets = det.predict_image_set(x, score_threshold=SSD_SCORE)
    ms = (time.perf_counter() - t0) * 1e3
    return {"images": len(x), "image_size": s, "fm_sizes": det.ssd.fm_sizes,
            "anchors": len(det.ssd.anchors), "raw_rel_err": err,
            "tol": TOL_SSD, "predict_image_set_ms": ms,
            "score_threshold": SSD_SCORE,
            **same_detections(dets, cpu.postprocess(ref, SSD_SCORE),
                              SSD_SCORE)}


def readers_frames(sizes, root: str, missing: dict) -> dict:
    """``NNImageReader.readImages`` -> ``NNClassifier.fit/transform`` (its
    column against ``Estimator.predict``); ``AnomalyDetector`` over
    ``unroll``ed series; ``read_csv/json/parquet/npz`` and
    ``FeatureTable.read_csv`` row counts and frames against pandas; the
    iterator, torch ``Dataset`` and ``DataLoader`` feeds into ``fit``,
    ``evaluate`` and ``predict`` on the card."""
    import glob
    import pandas as pd
    from analytics_zoo_tpu_torch import nn as tnn
    from analytics_zoo_tpu_torch.data import (ImageNormalize, ImageResize,
                                              from_iterator, from_tf_dataset,
                                              from_torch_dataloader,
                                              from_torch_dataset, read_csv,
                                              read_json, read_npz,
                                              read_parquet)
    from analytics_zoo_tpu_torch.friesian import FeatureTable
    from analytics_zoo_tpu_torch.models import AnomalyDetector, unroll
    from analytics_zoo_tpu_torch.nnframes import NNClassifier, NNImageReader
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    dev = sizes.device
    gen = torch.Generator().manual_seed(SEED)
    out = {}
    if "PIL" not in missing:
        d = os.path.join(root, "frames")
        write_jpegs(d, 128, 4, 64, seed=SEED + 21)
        df = NNImageReader.readImages(
            d, transforms=[ImageResize(32, 32), ImageNormalize()])
        model = tnn.Sequential([tnn.Flatten(),
                                tnn.Dense(32 * 32 * 3, 64, activation="relu"),
                                tnn.Dense(64, 4)])
        for m in model.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        nnm = (NNClassifier(model, device=dev).setFeaturesCol("image")
               .setBatchSize(32).setMaxEpoch(3).setLearningRate(1e-3)
               .fit(df))
        col = np.asarray(nnm.transform(df)["prediction"].tolist())
        pred = nnm.estimator.predict(np.stack(df["image"].tolist()),
                                     batch_size=32)
        if not np.array_equal(col, np.argmax(pred, -1)):
            raise AssertionError("readers: NNClassifier's transform column "
                                 "is not Estimator.predict's argmax")
        out["nnclassifier"] = {"rows": len(df), "transform_equals_predict":
                               True, "accuracy": float(
                                   (col == df["label"].to_numpy()).mean())}
    t = np.arange(2000, dtype=np.float32)
    series = np.sin(t / 10) + 0.05 * np.random.default_rng(SEED).normal(
        size=2000)
    series[[500, 1200, 1800]] += 5.0
    ax, ay = unroll(series, unroll_length=24)
    ad = AnomalyDetector(feature_shape=(24, 1)).init_weights(gen)
    ad.compile(loss="mse", learning_rate=1e-3, device=dev)
    hist = ad.fit((ax, ay[:, None]), epochs=2, batch_size=128, verbose=False)
    apred = ad.predict(ax, batch_size=128)
    found = ad.detect_anomalies(ay, apred, anomaly_fraction=0.01)
    if not (np.isfinite(apred).all() and all(map(math.isfinite,
                                                 hist["loss"]))):
        raise AssertionError(f"readers: AnomalyDetector loss {hist}")
    out["anomaly_detector"] = {"windows": len(ax), "loss": hist["loss"],
                               "anomalies": len(found),
                               "capture_count": ad.estimator.capture_count}
    # the readers' frames against pandas
    rng = np.random.default_rng(SEED + 22)
    fdir = os.path.join(root, "tables")
    os.makedirs(fdir, exist_ok=True)

    def frame(n):
        return pd.DataFrame({"user": rng.integers(0, 50, n),
                             "item": [f"i{v}" for v in rng.integers(0, 9, n)],
                             "rating": rng.normal(size=n)})

    for i in range(3):
        frame(1000).to_csv(os.path.join(fdir, f"part{i}.csv"), index=False)
    frame(500).to_json(os.path.join(fdir, "events.json"), orient="records")
    for i in range(2):
        np.savez(os.path.join(fdir, f"arr{i}.npz"), x=rng.normal(
            size=(300, 4)), y=rng.integers(0, 2, 300))
    csvs = sorted(glob.glob(os.path.join(fdir, "*.csv")))
    checks = {"csv": (read_csv(fdir), [pd.read_csv(f) for f in csvs]),
              "json": (read_json(os.path.join(fdir, "events.json")),
                       [pd.read_json(os.path.join(fdir, "events.json"))]),
              "feature_table_csv": (FeatureTable.read_csv(
                  os.path.join(fdir, "part*.csv")).shards,
                  [pd.read_csv(f) for f in csvs])}
    if "pyarrow" not in missing:
        for i in range(2):
            frame(700).to_parquet(os.path.join(fdir, f"p{i}.parquet"))
        pqs = sorted(glob.glob(os.path.join(fdir, "*.parquet")))
        checks["parquet"] = (read_parquet(fdir),
                             [pd.read_parquet(f) for f in pqs])
    rows = {}
    for name, (shards, frames) in checks.items():
        for a, b in zip(shards.collect(), frames):
            pd.testing.assert_frame_equal(a, b)
        if len(shards) != sum(map(len, frames)):
            raise AssertionError(f"readers: {name} {len(shards)} rows")
        rows[name] = len(shards)
    npz = read_npz(fdir)
    rows["npz"] = sum(len(s["x"]) for s in npz.collect())
    if rows["npz"] != 600:
        raise AssertionError(f"readers: npz {rows['npz']} rows")
    out["read_rows_equal_pandas"] = rows
    # foreign feeds into fit / evaluate / predict
    def gen_rows(n, seed):
        r = np.random.default_rng(seed)
        for _ in range(n):
            v = r.normal(size=4).astype(np.float32)
            yield v, np.asarray([v.sum()], np.float32)

    est = Estimator.from_keras(tnn.Sequential([tnn.Dense(4, 1)]),
                               loss="mse", learning_rate=5e-2,
                               metrics=["mae"], device=dev, seed=SEED)
    hist = est.fit(from_iterator(lambda e: gen_rows(650, e), 64), epochs=3,
                   batch_size=64, verbose=False)
    res = est.evaluate(from_iterator(lambda e: gen_rows(1000, 7), 64),
                       batch_size=64)
    ex = np.stack([v for v, _ in gen_rows(1000, 7)])
    ey = np.stack([s for _, s in gen_rows(1000, 7)])
    p = est.predict(ex, batch_size=64)[:, 0]
    via = est.predict(from_iterator(lambda e: gen_rows(1000, 7), 64),
                      batch_size=64)[:, 0]
    mse = float(np.square(p - ey[:, 0]).mean())
    mae = float(np.abs(p - ey[:, 0]).mean())
    if not (np.array_equal(p, via) and abs(res["loss"] - mse) <= 1e-5 * mse
            and abs(res["mae"] - mae) <= 1e-5 * mae):
        raise AssertionError(f"readers: evaluate {res} against predict's "
                             f"{mse}, {mae}")

    class Rows(torch.utils.data.Dataset):
        def __len__(self):
            return 512

        def __getitem__(self, i):
            return torch.from_numpy(ex[i]), torch.tensor(ey[i])

    est.fit(from_torch_dataset(Rows(), batch_size=64, num_workers=2),
            epochs=1, batch_size=64, verbose=False)
    loader = torch.utils.data.DataLoader(Rows(), batch_size=50)
    dl = est.evaluate(from_torch_dataloader(loader, batch_size=64),
                      batch_size=64)
    out["interop"] = {"iterator_fit_loss": hist["loss"],
                      "evaluate_masked_tail": res, "mse_from_predict": mse,
                      "predict_rows": len(via), "dataloader_evaluate": dl,
                      "capture_count": est.capture_count}
    import importlib.util
    out["interop"]["tf"] = (
        "installed (from_tf_dataset not driven here)"
        if importlib.util.find_spec("tensorflow") is not None
        else "tensorflow not installed: from_tf_dataset not run")
    return out


def phase_readers(fa, bn, fx, sizes=None) -> dict:
    """The readers and the models they feed (see the module docstring):
    a line naming any part whose package is missing, first; then, from
    seeded files in a temp dir, the ImageSet fit (the kernel path), the
    input-pipeline breakdown and the slot passes, the text models, the
    detector, and the frames, readers and foreign feeds.  Every kernel
    count but the batch norm's stays 0 over the phase."""
    import shutil
    import tempfile
    sizes = sizes or ReadersSizes()
    missing = rd_missing(sizes)
    if missing:
        emit({"phase": "readers", "missing_packages": {
            pkg: f"{part}: not run ({pkg} is not installed)"
            for pkg, part in missing.items()}})
    t_phase = time.perf_counter()
    res = {"phase": "readers", "missing_packages": sorted(missing)}
    root = tempfile.mkdtemp(prefix="zoo-readers-")
    done = False
    try:
        if "PIL" not in missing:
            t0 = time.perf_counter()
            write_jpegs(os.path.join(root, "jpeg"), sizes.images,
                        sizes.classes, sizes.side)
            res["write_jpegs_s"] = time.perf_counter() - t0
            res["jpeg_bytes_mean"] = float(np.mean([
                os.path.getsize(f) for f in
                __import__("glob").glob(os.path.join(root, "jpeg", "*",
                                                     "*.jpg"))]))
        part_s = res["part_seconds"] = {}

        def part(name, fn):
            t0 = time.perf_counter()
            out = fn()
            part_s[name] = time.perf_counter() - t0
            return out

        res["imageset_fit"] = part("imageset_fit", lambda: (
            readers_imageset_fit(fa, bn, fx, sizes, root, missing)))
        autots_reset_counts(fa, bn, fx)
        res["input_pipeline"] = part(
            "input_pipeline", lambda: readers_input_pipeline(sizes, root))
        res["slot_passes"] = part("slot_passes",
                                  lambda: readers_slot_passes(sizes))
        res["text"] = part("text", lambda: readers_text(sizes, root))
        res["detector"] = part("detector", lambda: readers_detector(
            sizes, root, missing))
        res.update(part("frames", lambda: readers_frames(sizes, root,
                                                         missing)))
        done = True
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if not done:  # what ran before the failure, for its reader
            emit({**res, "failed": True})
    counts = autots_kernel_counts(fa, bn, fx)
    if any(counts.values()):
        raise AssertionError(f"readers: a kernel launched off the ImageSet "
                             f"fit: {counts}")
    res["kernel_launches"] = res["imageset_fit"]["launches"]
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


# -- foreign: a torch ResNet-50 converted, transfer learning, DCGAN ---------

FOREIGN_BATCH = 32
FOREIGN_LR = 0.1
FOREIGN_STEPS = 10        # the timed window of captured steps
FOREIGN_CMP_STEPS = 3     # captured against eager
FOREIGN_TRANSFER_STEPS = 4
FOREIGN_CLASSES_NEW = 10  # the transfer head's classes
# f32 with TF32 off on both sides; the converted net runs channels-last
# through other cuDNN algorithms than torch's NCHW module, so the two eval
# forwards' sums differ in order: held at this share of the largest logit
FOREIGN_FWD_TOL = 1e-4
TV_RESNET50_PARAMS = 25_557_032  # torchvision's resnet50()
# DCGAN (Radford et al. 2016; PyTorch's examples/dcgan): z 100, 64x64x3
DCGAN = dict(nz=100, ngf=64, ndf=64, nc=3, size=64)
DCGAN_BATCH = 128
DCGAN_LR = 2e-4
DCGAN_B1 = 0.5            # the paper's Adam beta1
DCGAN_STEPS = 10          # timed D and G steps each
DCGAN_CMP_STEPS = 3       # D/G pairs, captured against eager
DCGAN_FIT_IMAGES = 4 * DCGAN_BATCH


class TvBottleneck(torch.nn.Module):
    """torchvision's ``Bottleneck`` (stride on the 3x3), written out: the
    card machine has no torchvision."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 downsample=None):
        super().__init__()
        tnn = torch.nn
        self.conv1 = tnn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.conv2 = tnn.Conv2d(width, width, 3, stride=stride, padding=1,
                                bias=False)
        self.bn2 = tnn.BatchNorm2d(width)
        self.conv3 = tnn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(width * 4)
        self.relu = tnn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        out += identity
        return self.relu(out)


class TvResNet(torch.nn.Module):
    """torchvision's ``ResNet`` over ``TvBottleneck`` (``layers`` (3, 4, 6,
    3) and ``width`` 64 are ``resnet50()``): 7x7/2 stem, 3x3/2 max pool,
    four stages, global average pool, ``fc``."""

    def __init__(self, layers=(3, 4, 6, 3), classes: int = 1000,
                 width: int = 64):
        super().__init__()
        tnn = torch.nn
        self.conv1 = tnn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.relu = tnn.ReLU(inplace=True)
        self.maxpool = tnn.MaxPool2d(3, stride=2, padding=1)
        cin = width
        for i, n in enumerate(layers):
            w = width * 2 ** i
            blocks = []
            for j in range(n):
                stride = 2 if (j == 0 and i > 0) else 1
                down = None
                if j == 0:
                    down = tnn.Sequential(
                        tnn.Conv2d(cin, w * 4, 1, stride=stride, bias=False),
                        tnn.BatchNorm2d(w * 4))
                blocks.append(TvBottleneck(cin, w, stride, down))
                cin = w * 4
            setattr(self, f"layer{i + 1}", tnn.Sequential(*blocks))
        self.avgpool = tnn.AdaptiveAvgPool2d(1)
        self.fc = tnn.Linear(cin, classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(torch.flatten(self.avgpool(x), 1))


@torch.no_grad()
def tv_resnet(seed: int, **kw) -> TvResNet:
    """A ``TvResNet`` with a seeded init: convs He-normal over fan out
    (torchvision's), batch norms' scales, shifts and running statistics
    drawn away from 1 and 0 so that the eval forward has teeth, ``fc``
    uniform in +-1/sqrt(fan in)."""
    m = TvResNet(**kw).eval()
    g = torch.Generator().manual_seed(seed)
    for mod in m.modules():
        if isinstance(mod, torch.nn.Conv2d):
            fan_out = mod.out_channels * mod.kernel_size[0] * \
                mod.kernel_size[1]
            mod.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
        elif isinstance(mod, torch.nn.BatchNorm2d):
            mod.weight.uniform_(0.5, 1.5, generator=g)
            mod.bias.uniform_(-0.1, 0.1, generator=g)
            mod.running_mean.uniform_(-0.2, 0.2, generator=g)
            mod.running_var.uniform_(0.5, 2.0, generator=g)
        elif isinstance(mod, torch.nn.Linear):
            lim = 1.0 / math.sqrt(mod.in_features)
            mod.weight.uniform_(-lim, lim, generator=g)
            mod.bias.uniform_(-lim, lim, generator=g)
    return m


def dcgan(nz: int = 100, ngf: int = 64, ndf: int = 64, nc: int = 3,
          size: int = 64):
    """DCGAN's generator and discriminator from the port's layers (the
    paper's and PyTorch's examples/dcgan at ``size`` 64): G takes ``z``
    through ``Reshape`` to 1x1xnz, a 4x4 transposed conv to ``ngf *
    2^(k-1)`` channels at 4x4, then stride-2 4x4 transposed convs halving
    the channels to ``ngf``, batch norm and ReLU after each, and one more
    to ``nc`` channels with tanh; D mirrors it with stride-2 4x4 convs from
    ``ndf`` up and LeakyReLU(0.2) (no batch norm on the first), then a
    4x4 valid conv to one logit.  Batch norms take torch's defaults
    (momentum 0.1, so 0.9 here; epsilon 1e-5); no conv has a bias.
    Channel-last: G gives ``[B, size, size, nc]``, D takes it."""
    from analytics_zoo_tpu_torch import nn as P
    n_up = int(math.log2(size)) - 2
    bn = dict(momentum=0.9, epsilon=1e-5)
    ch = ngf * 2 ** (n_up - 1)
    g = [P.Reshape((1, 1, nz)),
         P.Conv2DTranspose(nz, ch, 4, padding="valid", use_bias=False),
         P.BatchNormalization(ch, **bn), P.Activation("relu")]
    for _ in range(n_up - 1):
        g += [P.Conv2DTranspose(ch, ch // 2, 4, strides=2, use_bias=False),
              P.BatchNormalization(ch // 2, **bn), P.Activation("relu")]
        ch //= 2
    g += [P.Conv2DTranspose(ch, nc, 4, strides=2, use_bias=False),
          P.Activation("tanh")]
    d = [P.Conv2D(nc, ndf, 4, strides=2, use_bias=False), P.LeakyReLU(0.2)]
    ch = ndf
    for _ in range(n_up - 1):
        d += [P.Conv2D(ch, ch * 2, 4, strides=2, use_bias=False),
              P.BatchNormalization(ch * 2, **bn), P.LeakyReLU(0.2)]
        ch *= 2
    d += [P.Conv2D(ch, 1, 4, padding="valid", use_bias=False), P.Flatten()]
    return P.Sequential(g), P.Sequential(d)


@torch.no_grad()
def dcgan_init(model: torch.nn.Module, seed: int) -> None:
    """DCGAN's init: conv kernels N(0, 0.02), batch-norm scales N(1,
    0.02), shifts 0."""
    from analytics_zoo_tpu_torch import nn as P
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (P.Conv2D, P.Conv2DTranspose)):
            m.kernel.normal_(0.0, 0.02, generator=g)
        elif isinstance(m, P.BatchNormalization):
            m.gamma.normal_(1.0, 0.02, generator=g)
            m.beta.zero_()


def foreign_bn_maps(sizes=None) -> dict:
    """Every distinct (rows, C) the foreign phase's f32 batch norms see,
    with how many norms see it: the torch ResNet-50's 53 (the converted
    net's norms take the same activations channel-last) at the phase's
    batch, then DCGAN's G and D at its batch (one example through each on
    the phase's device)."""
    from analytics_zoo_tpu_torch.nn import BatchNormalization
    sizes = sizes or ForeignSizes()
    dev = torch.device(sizes.device)
    maps: dict = {}

    def hook(batch, channels_last):
        def record(_m, inp, _out):
            shape = inp[0].shape
            c = shape[-1] if channels_last else shape[1]
            spatial = shape[1:-1] if channels_last else shape[2:]
            key = (batch * math.prod(spatial), c)
            maps[key] = maps.get(key, 0) + 1
        return record

    m = TvResNet(**sizes.resnet).to(dev).eval()
    g, d = dcgan(**sizes.gan)
    g, d = g.to(dev).eval(), d.to(dev).eval()
    hooks = [b.register_forward_hook(hook(sizes.batch, False))
             for b in m.modules() if isinstance(b, torch.nn.BatchNorm2d)]
    hooks += [b.register_forward_hook(hook(sizes.gan_batch, True))
              for net in (g, d) for b in net.modules()
              if isinstance(b, BatchNormalization)]
    side, nc = sizes.gan["size"], sizes.gan["nc"]
    try:
        with torch.no_grad():
            m(torch.zeros(1, 3, sizes.image, sizes.image, device=dev))
            g(torch.zeros(1, sizes.gan["nz"], device=dev))
            d(torch.zeros(1, side, side, nc, device=dev))
    finally:
        for h in hooks:
            h.remove()
    return maps


class ForeignSizes:
    """The phase's shapes: the card's by default; the CPU rehearsal
    (tests) shrinks them."""

    def __init__(self, device="cuda", **kw):
        self.device = device
        self.batch, self.image, self.lr = FOREIGN_BATCH, IMAGE, FOREIGN_LR
        self.resnet = dict(layers=(3, 4, 6, 3), classes=1000, width=64)
        self.steps, self.cmp_steps = FOREIGN_STEPS, FOREIGN_CMP_STEPS
        self.transfer_steps = FOREIGN_TRANSFER_STEPS
        self.new_classes = FOREIGN_CLASSES_NEW
        self.gan = dict(DCGAN)
        self.gan_batch, self.gan_steps = DCGAN_BATCH, DCGAN_STEPS
        self.gan_cmp_steps = DCGAN_CMP_STEPS
        self.gan_fit_images = DCGAN_FIT_IMAGES
        self.__dict__.update(kw)


def fg_check(bn, sizes, what: str, fwd: int, bwd: int) -> dict:
    """The batch-norm counts since the last reset, one-launch and split
    entries: ``fwd`` and ``bwd`` f32 one-launch launches on the card, every
    other count 0 (every count on the CPU)."""
    counts = dict(bn.KERNEL_LAUNCHES, **bn.SPLIT_KERNEL_LAUNCHES)
    want = dict.fromkeys(counts, 0)
    if sizes.device == "cuda":
        want.update(fwd_f32=fwd, bwd_f32=bwd)
    if counts != want:
        raise AssertionError(f"foreign {what}: fused_bn launches {counts}; "
                             f"want {want}")
    return counts


def fg_window(sizes, fn, steps: int) -> tuple:
    """``window_ms`` on the card; on the CPU the host's time and the
    values."""
    if sizes.device == "cuda":
        return window_ms(fn, steps)
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3 / steps, out


def foreign_convert(sizes, m, x) -> dict:
    """(a) ``Net.load_torch`` of the torch ResNet-50 into a
    ``ForeignGraphNet``, moved to the card; its eval forward against the
    torch module's own on the card at the batch, held at FOREIGN_FWD_TOL
    of the largest logit."""
    import copy
    from analytics_zoo_tpu_torch.models import ForeignGraphNet, Net
    from analytics_zoo_tpu_torch.nn import BatchNormalization
    t0 = time.perf_counter()
    net = Net.load_torch(m, x[:2])
    convert_s = time.perf_counter() - t0
    if not isinstance(net, ForeignGraphNet):
        raise AssertionError(f"foreign: converted to {type(net).__name__}")
    n_bn = sum(isinstance(b, BatchNormalization) for b in net.modules())
    dev = torch.device(sizes.device)
    ref = copy.deepcopy(m).to(dev).eval()
    net = net.to(dev).eval()
    xd = torch.from_numpy(x).to(dev)
    with torch.no_grad():
        want = ref(xd)
        got = net(xd)
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    if not err <= FOREIGN_FWD_TOL * scale:
        raise AssertionError(f"foreign: the converted ResNet-50's eval "
                             f"forward is {err} from torch's (largest "
                             f"logit {scale})")
    nodes = len(net.nodes)
    del ref, net
    return {"convert_s": convert_s, "batch_norms": n_bn, "nodes": nodes,
            "max_abs_err": err, "largest_logit": scale,
            "tol": FOREIGN_FWD_TOL * scale}


def foreign_train(bn, sizes, m, x, y) -> dict:
    """(b) ``Estimator.from_torch`` of the torch module, f32, sgd, from
    CUDA graphs: captured against eager step losses under cuDNN's
    deterministic algorithms (equal bits); then a warm call, a timed
    window of replays with every count set to 0 just before it (one f32
    batch-norm launch each way a norm a step), and a profiled window."""
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    card = sizes.device == "cuda"
    dev = torch.device(sizes.device)
    b0 = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}

    def estimator(graphs=True):
        return Estimator.from_torch(
            model=m, example_input=x[:2],
            loss="sparse_categorical_crossentropy", optimizer="sgd",
            learning_rate=sizes.lr, seed=SEED, device=sizes.device,
            cuda_graphs=graphs)

    cmp = {}
    torch.backends.cudnn.deterministic = True
    try:
        for graphs in (False, True):
            e = estimator(graphs)
            cmp[graphs] = [float(v) for v in
                           e._multi_step(b0, sizes.cmp_steps)]
            del e
            sp_free(sizes)
    finally:
        torch.backends.cudnn.deterministic = False
    against = losses_against_eager(cmp[True], cmp[False],
                                   "foreign from_torch captured vs eager")
    if card and not against["bitwise_equal"]:
        raise AssertionError(f"foreign from_torch: captured losses are not "
                             f"the eager ones bit for bit: {against}")
    est = estimator()
    n_bn = sum(1 for k in est.model.state_dict() if k.endswith(".var"))
    float(est._multi_step(b0, 1)[-1])  # warm: the capture
    bn.reset_launches()
    step_ms, losses = fg_window(
        sizes, lambda: est._multi_step(b0, sizes.steps), sizes.steps)
    launches = fg_check(bn, sizes, "from_torch replays",
                        n_bn * sizes.steps, n_bn * sizes.steps)
    losses = [float(v) for v in losses]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"foreign from_torch: losses {losses}")
    profiled = None
    if card:
        profiled = profiled_window(
            lambda: est._multi_step(b0, 5), 5,
            {"batch_norm": ("bn_fwd_kernel", "bn_bwd_kernel")})
        idle_of(profiled, step_ms)
    caps = captures(est, "foreign from_torch")
    del est
    sp_free(sizes)
    return {"batch": sizes.batch, "step_ms": step_ms,
            "images_per_s": sizes.batch / (step_ms / 1e3),
            "losses": losses, "losses_against_eager": {
                k: v for k, v in against.items()
                if k not in ("captured", "eager")},
            "launches": launches,
            "launches_a_step_each_way": n_bn if card else 0,
            "profiled": profiled, **caps}


class TransferNet(torch.nn.Module):
    """(c)'s model: the converted net cut at ``node`` by ``GraphNet``
    (``base``), a global average pool and a new ``Dense`` head."""

    def __init__(self, net, node: str, channels: int, classes: int):
        super().__init__()
        from analytics_zoo_tpu_torch import nn as P
        from analytics_zoo_tpu_torch.models import GraphNet
        self.base = GraphNet(net, [node])
        self.pool = P.GlobalAveragePooling2D()
        self.head = P.Dense(channels, classes)

    def forward(self, x):
        return self.head(self.pool(self.base(x)))


def foreign_transfer(bn, sizes, m, x) -> dict:
    """(c) The converted net cut at its last stage's output node, a new
    pool and head, ``frozen=["base"]``: a few captured steps; the backbone
    equal bit for bit after them, the head moved, the backbone's norms
    still launched forward (running statistics are state) and never
    backward."""
    from analytics_zoo_tpu_torch.models import Net
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    net = Net.load_torch(m, x[:2])
    node = [n["name"] for n in net.nodes if n["module"]
            and n["name"].startswith("layer4")][-1]
    channels = net.fc.kernel.shape[0]
    model = TransferNet(net, node, channels, sizes.new_classes)
    est = Estimator.from_keras(model, loss="sparse_categorical_crossentropy",
                               optimizer="sgd", learning_rate=sizes.lr,
                               seed=SEED, device=sizes.device,
                               frozen=["base"])
    n_bn = sum(1 for k in net.state_dict() if k.endswith(".var"))
    dev = torch.device(sizes.device)
    y = np.random.default_rng(SEED + 3).integers(
        0, sizes.new_classes, len(x)).astype(np.int32)
    b0 = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}
    base = {k: v.detach().clone() for k, v in net.named_parameters()}
    head = model.head.kernel.detach().clone()
    float(est._multi_step(b0, 1)[-1])  # warm: the capture
    bn.reset_launches()
    step_ms, losses = fg_window(
        sizes, lambda: est._multi_step(b0, sizes.transfer_steps),
        sizes.transfer_steps)
    launches = fg_check(bn, sizes, "transfer replays",
                        n_bn * sizes.transfer_steps, 0)
    moved = [k for k, v in net.named_parameters()
             if not torch.equal(v, base[k])]
    if moved:
        raise AssertionError(f"foreign transfer: frozen backbone moved: "
                             f"{moved[:5]}")
    if torch.equal(model.head.kernel, head):
        raise AssertionError("foreign transfer: the new head did not train")
    losses = [float(v) for v in losses]
    caps = captures(est, "foreign transfer")
    out = {"node": node, "frozen": ["base"], "step_ms": step_ms,
           "losses": losses, "backbone_bitwise_equal": True,
           "trainable_params": sum(p.numel() for p in est._params),
           "frozen_params": sum(v.numel() for v in base.values()),
           "launches": launches, **caps}
    del est, model, net
    sp_free(sizes)
    return out


def foreign_dcgan(bn, sizes) -> dict:
    """(d) ``GANEstimator`` at DCGAN's widths, adam at DCGAN_LR (beta1
    0.5): ``fit`` over seeded images in [-1, 1]; D/G step pairs from CUDA
    graphs against eager (equal bits, deterministic cuDNN); timed D and G
    windows of replays with the counts set to 0 before each (D: two
    forwards a step, so two launches a norm each way; G: one); then
    ``generate(64)`` finite and in [-1, 1]."""
    from analytics_zoo_tpu_torch.nn import BatchNormalization
    from analytics_zoo_tpu_torch.orca.learn import GANEstimator, optimizers
    card = sizes.device == "cuda"
    g0, d0 = dcgan(**sizes.gan)
    dcgan_init(g0, SEED)
    dcgan_init(d0, SEED + 1)
    g_state, d_state = g0.state_dict(), d0.state_dict()
    n_g = sum(isinstance(b, BatchNormalization) for b in g0.modules())
    n_d = sum(isinstance(b, BatchNormalization) for b in d0.modules())

    def gan(graphs=True):
        g, d = dcgan(**sizes.gan)
        g.load_state_dict(g_state)
        d.load_state_dict(d_state)
        return GANEstimator(
            g, d, generator_optimizer=optimizers.adam(DCGAN_LR, b1=DCGAN_B1),
            discriminator_optimizer=optimizers.adam(DCGAN_LR, b1=DCGAN_B1),
            noise_dim=sizes.gan["nz"], seed=SEED, device=sizes.device,
            cuda_graphs=graphs)

    side = sizes.gan["size"]
    images = np.random.default_rng(SEED + 4).uniform(
        -1.0, 1.0, (sizes.gan_fit_images, side, side, sizes.gan["nc"])) \
        .astype(np.float32)
    dev = torch.device(sizes.device)
    real = torch.from_numpy(images[:sizes.gan_batch]).to(dev)
    cmp = {}
    torch.backends.cudnn.deterministic = True
    try:
        for graphs in (False, True):
            e = gan(graphs)
            pairs = []
            for _ in range(sizes.gan_cmp_steps):
                pairs += [e.d_step(real), e.g_step(real)]
            cmp[graphs] = [float(v) for v in pairs]
            del e
            sp_free(sizes)
    finally:
        torch.backends.cudnn.deterministic = False
    against = losses_against_eager(cmp[True], cmp[False],
                                   "foreign dcgan captured vs eager")
    if card and not against["bitwise_equal"]:
        raise AssertionError(f"foreign dcgan: captured losses are not the "
                             f"eager ones bit for bit: {against}")
    est = gan()
    t0 = time.perf_counter()
    hist = est.fit(images, epochs=1, batch_size=sizes.gan_batch,
                   verbose=False)
    fit_s = time.perf_counter() - t0
    if not all(map(math.isfinite, hist["d_loss"] + hist["g_loss"])):
        raise AssertionError(f"foreign dcgan: fit losses {hist}")
    windows = {}
    for kind, n_bn, calls in (("d", n_d, 2), ("g", n_g, 1)):
        step = est.d_step if kind == "d" else est.g_step
        bn.reset_launches()
        ms, losses = fg_window(sizes, lambda: torch.stack(
            [step(real) for _ in range(sizes.gan_steps)]), sizes.gan_steps)
        windows[kind] = {"step_ms": ms, "launches": fg_check(
            bn, sizes, f"dcgan {kind} replays", calls * n_bn * sizes.gan_steps,
            calls * n_bn * sizes.gan_steps),
            "launches_a_step_each_way": calls * n_bn if card else 0}
        if card:
            prof = profiled_window(
                lambda: [step(real) for _ in range(5)], 5,
                {"batch_norm": ("bn_fwd_kernel", "bn_bwd_kernel")})
            idle_of(prof, ms)
            windows[kind]["profiled"] = prof
    samples = est.generate(64)
    if not (np.isfinite(samples).all() and np.abs(samples).max() <= 1.0):
        raise AssertionError("foreign dcgan: generate(64) is not finite "
                             "in [-1, 1]")
    out = {"widths": sizes.gan, "batch": sizes.gan_batch, "lr": DCGAN_LR,
           "fit_s": fit_s, "fit_history": hist, "steps": est.step,
           "d_step": windows["d"], "g_step": windows["g"],
           "losses_against_eager": {k: v for k, v in against.items()
                                    if k not in ("captured", "eager")},
           "generate": {"shape": list(samples.shape),
                        "min": float(samples.min()),
                        "max": float(samples.max())},
           "capture_count": est.capture_count,
           "params": {"g": sum(p.numel() for p in est.generator.parameters()),
                      "d": sum(p.numel() for p in
                               est.discriminator.parameters())}}
    del est
    sp_free(sizes)
    return out


def phase_foreign(bn, sizes=None) -> dict:
    """Foreign models and transfer learning (see the module docstring):
    (a) conversion, (b) the ``from_torch`` fit from CUDA graphs, (c) the
    frozen-backbone transfer, (d) DCGAN.  Only the f32 batch-norm kernels
    launch, and only in the counted windows' parts."""
    sizes = sizes or ForeignSizes()
    t_phase = time.perf_counter()
    m = tv_resnet(SEED, **sizes.resnet)
    n_params = sum(p.numel() for p in m.parameters())
    if sizes.resnet == dict(layers=(3, 4, 6, 3), classes=1000, width=64) \
            and n_params != TV_RESNET50_PARAMS:
        raise AssertionError(f"foreign: the torch ResNet-50 has {n_params} "
                             f"parameters, not {TV_RESNET50_PARAMS}")
    rng = np.random.default_rng(SEED + 2)
    x = rng.standard_normal((sizes.batch, 3, sizes.image, sizes.image),
                            dtype=np.float32)
    y = rng.integers(0, sizes.resnet["classes"], sizes.batch).astype(np.int32)
    res = {"phase": "foreign", "torch_params": n_params,
           "part_seconds": {}}

    def part(name, fn):
        t0 = time.perf_counter()
        res[name] = fn()
        res["part_seconds"][name] = time.perf_counter() - t0

    bn.reset_launches()
    part("convert", lambda: foreign_convert(sizes, m, x))
    fg_check(bn, sizes, "eval forwards", 0, 0)
    part("from_torch", lambda: foreign_train(bn, sizes, m, x, y))
    part("transfer", lambda: foreign_transfer(bn, sizes, m, x))
    part("dcgan", lambda: foreign_dcgan(bn, sizes))
    total = {k: res["from_torch"]["launches"][k]
             + res["transfer"]["launches"][k]
             + res["dcgan"]["d_step"]["launches"][k]
             + res["dcgan"]["g_step"]["launches"][k]
             for k in res["from_torch"]["launches"]}
    res["kernel_launches"] = {f"{BN_KERNEL}_{k}": v for k, v in total.items()}
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res

# -- train_knobs -----------------------------------------------------------------

# the Estimator's single-device knobs on the card (see the module docstring)
KNOBS_MLM_STEPS = 4      # (a): fit steps over distinct batches, eager and captured
KNOBS_WINDOW = 10        # (a): replays a timed window, with and without the guard
KNOBS_RESNET_STEPS = 4   # (b): batches of the poisoned fit
KNOBS_POISON = 2         # (b): the step step.nan poisons (from 0)
KNOBS_LARS_LR = 0.1
KNOBS_TRACE = (2, 4)     # (e): the profiler's window of steps [start, end)
KNOBS_SCALARS = ("loss", "throughput", "samples_per_sec", "step_time_ms",
                 "data_wait_ms", "compute_ms", "bad_steps")


class TrainKnobsSizes:
    """The phase's shapes: the card's by default; the CPU rehearsal (tests)
    shrinks them."""

    def __init__(self, device="cuda", **kw):
        self.device = device
        self.mlm, self.seq = dict(MLM), SEQ
        self.micro, self.accum, self.chunk = MLM_MICRO, MLM_ACCUM, MLM_CHUNK
        self.mlm_steps, self.window = KNOBS_MLM_STEPS, KNOBS_WINDOW
        self.resnet = dict(RESNET, norm="batch", dtype="bfloat16")
        self.image, self.batch = IMAGE, RESNET_BATCH
        self.resnet_steps, self.poison = KNOBS_RESNET_STEPS, KNOBS_POISON
        self.bn_norms = RESNET_BN
        self.bn_map = (RESNET_BATCH * 56 * 56, 64)  # rows, C: stage 0's
        self.__dict__.update(kw)


def kn_counts(fa, bn, fx) -> dict:
    """The launches of the kernels line's entries since
    ``autots_reset_counts``, by entry: the flash forward by source, its
    backward by dtype (f32: the wgmma_tf32 design; bf16: the others at
    d <= 64), the batch norm's passes (one-launch and split) and the
    cross-entropy passes by dtype."""
    bwd_f32 = fa.BWD_LAUNCHES["wgmma_tf32"]
    counts = {"flash_attention_fwd_bf16": fa.KERNEL_LAUNCHES[BF16_KERNEL],
              "flash_attention_fwd_f32": fa.KERNEL_LAUNCHES[F32_KERNEL],
              "flash_attention_bwd_bf16":
                  fa.KERNEL_LAUNCHES[BWD_KERNEL] - bwd_f32,
              "flash_attention_bwd_f32": bwd_f32}
    counts.update({f"{BN_KERNEL}_{k}": v
                   for k, v in bn.KERNEL_LAUNCHES.items()})
    counts.update({f"{BN_KERNEL}_{k}": v
                   for k, v in bn.SPLIT_KERNEL_LAUNCHES.items()})
    counts.update({f"{XENT_KERNEL}_{k}": v
                   for k, v in fx.KERNEL_LAUNCHES.items()})
    return counts


def kn_expect(fa, bn, fx, sizes, what: str, **want: int) -> dict:
    """The counts since the reset: ``want``'s entries as given, every
    other 0 (on the card; the CPU launches nothing)."""
    got = kn_counts(fa, bn, fx)
    if sizes.device == "cuda":
        full = {k: want.get(k, 0) for k in got}
        if got != full:
            raise AssertionError(f"train_knobs {what}: launches {got}; "
                                 f"want {full}")
    return got


def kn_window(sizes, fn, steps: int) -> float:
    """ms a step of ``fn()`` (``steps`` steps), synchronised at its ends."""
    sp_sync(sizes)
    t0 = time.perf_counter()
    losses = fn()
    float(losses[-1])
    return (time.perf_counter() - t0) * 1e3 / steps


def kn_mlm(fa, bn, fx, sizes) -> dict:
    """train_knobs (a): bench.py's BERT-base MLM recipe (the fused head,
    grad_accum 8 x 4 x 512, bf16) with flash attention, under LAMB and
    nan_policy="skip_step": a fit over distinct batches eagerly, then from
    CUDA graphs (its step losses against the eager ones, bad_steps 0, one
    capture), then timed windows of replays with the guard and without it
    (an estimator with no policy), in turns; the flash and cross-entropy
    launches of the captured runs."""
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.data import as_feed
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    cfg, gbatch = sizes.mlm, sizes.micro * sizes.accum
    layers = cfg["layers"]
    state = from_jax_variables(random_bert_variables(MlmEncoder(
        layers, torch.float32, True, flash=True, cfg=cfg, seq=sizes.seq),
        SEED))
    rng = np.random.default_rng(SEED + 21)
    shape = (gbatch * sizes.mlm_steps, sizes.seq)
    x = rng.integers(0, cfg["vocab"], shape).astype(np.int32)
    y = rng.integers(0, cfg["vocab"], shape).astype(np.int32)

    def make(policy, graphs=True):
        m = MlmEncoder(layers, torch.bfloat16, True, flash=True, cfg=cfg,
                       seq=sizes.seq)
        m.load_state_dict(state, strict=True)
        return Estimator.from_keras(
            m, loss=mlm_loss(True, sizes.chunk), optimizer="lamb",
            learning_rate=TRAIN_LR, seed=SEED, grad_accum=sizes.accum,
            cuda_graphs=graphs, device=sizes.device, nan_policy=policy)

    def fit(est):
        losses = record_losses(est)
        hist = est.fit((x, y), epochs=1, batch_size=gbatch, verbose=False)
        return [float(v) for v in losses], hist

    eager = make("skip_step", graphs=False)
    eager_losses, _ = fit(eager)
    del eager
    sp_free(sizes)
    autots_reset_counts(fa, bn, fx)
    est = make("skip_step")
    captured, hist = fit(est)
    against = losses_against_eager(captured, eager_losses,
                                   "train_knobs (a) lamb")
    batch = next(as_feed((x, y), gbatch, seed=SEED).epoch(est.device, 0))
    plain = make(None)
    plain._train_step(batch)
    ms = {"skip_step": [], "none": []}
    w = sizes.window
    for name, e in (("skip_step", est), ("none", plain), ("none", plain),
                    ("skip_step", est)):
        ms[name].append(kn_window(sizes, lambda: e._multi_step(batch, w), w))
    steps = sizes.mlm_steps + 4 * w + 1
    launches = kn_expect(
        fa, bn, fx, sizes, "(a)",
        flash_attention_fwd_bf16=layers * sizes.accum * steps,
        flash_attention_bwd_bf16=layers * sizes.accum * steps,
        **{f"{XENT_KERNEL}_{p}_bf16": sizes.accum * steps
           for p in ("fwd", "dl", "dh", "dw")})
    bad = int(est._bad_steps)
    if bad or hist["bad_steps"] != [0] or est.bad_steps:
        raise AssertionError(f"train_knobs (a): bad_steps {bad}, history "
                             f"{hist['bad_steps']}")
    caps = {"skip_step": captures(est, "train_knobs (a)"),
            "none": captures(plain, "train_knobs (a) no policy")}
    one = int(sizes.device == "cuda")  # the CPU captures nothing
    if est.capture_count != one or plain.capture_count != one:
        raise AssertionError(f"train_knobs (a): captures {caps}")
    del est, plain
    sp_free(sizes)
    skip_ms = float(np.median(ms["skip_step"]))
    none_ms = float(np.median(ms["none"]))
    return {"config": dict(cfg, seq=sizes.seq), "flash": True,
            "optimizer": "lamb", "learning_rate": TRAIN_LR,
            "nan_policy": "skip_step", "global_batch": gbatch,
            "grad_accum": sizes.accum, "micro_batch": sizes.micro,
            "losses_against_eager": against, "epoch_loss": hist["loss"],
            "bad_steps": bad, "window_step_ms": ms,
            "step_ms": {"skip_step": skip_ms, "none": none_ms},
            "guard_ms": skip_ms - none_ms, "captures": caps,
            "steps_counted": steps, "launches": launches}


def kn_resnet_data(sizes, steps: int, seed: int) -> tuple:
    """Seeded float images (``step.nan`` poisons float leaves only) in
    [0, 255] for TrainNet's normalisation, and labels."""
    rng = np.random.default_rng(seed)
    n = sizes.batch * steps
    return (rng.uniform(0.0, 255.0, (n, sizes.image, sizes.image, 3)
                        ).astype(np.float32),
            rng.integers(0, sizes.resnet["class_num"], n).astype(np.int32))


def kn_resnet_maker(sizes):
    """A factory of resnet_train's ResNet-50 (norm="batch", bf16) under
    LARS from one seeded init, and an unshuffled feed of given rows."""
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.data import DataFeed
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    init = from_jax_variables(random_resnet_variables(
        TrainNet(**sizes.resnet), SEED))

    def make(**kw):
        m = TrainNet(**sizes.resnet)
        m.load_state_dict(init, strict=True)
        return Estimator.from_keras(
            m, loss="sparse_categorical_crossentropy", optimizer="lars",
            learning_rate=KNOBS_LARS_LR, seed=SEED, device=sizes.device,
            **kw)

    def feed(x, y):
        return DataFeed({"x": x, "y": y}, sizes.batch, shuffle=False,
                        seed=SEED)

    return make, feed


def kn_state(est) -> dict:
    """Parameters, buffers and the optimizer's state (optax's layout)."""
    tree = est._save_tree()
    return {k: tree[k] for k in ("params", "state", "opt_state")}


def kn_resnet(fa, bn, fx, sizes) -> dict:
    """train_knobs (b): ResNet-50 (norm="batch", bf16) under LARS and
    nan_policy="skip_step" from CUDA graphs (cuDNN deterministic), with
    step.nan armed once at step ``poison``: bad_steps 1, one capture (the
    poisoned step a replay like the others), and the parameters, running
    statistics and LARS state equal, bit for bit, a second run (no
    policy) on the same batches with the poisoned one left out; then
    windows of replays of both in turns (the guard's ms a step); 53
    launches of each batch-norm kernel a step."""
    from analytics_zoo_tpu_torch.core import faults

    torch.backends.cudnn.deterministic = True
    make, feed = kn_resnet_maker(sizes)
    x, y = kn_resnet_data(sizes, sizes.resnet_steps, SEED + 22)
    b = sizes.batch
    keep = np.r_[0:sizes.poison * b, (sizes.poison + 1) * b:len(y)]
    reg = faults.get_registry()
    autots_reset_counts(fa, bn, fx)
    fired = reg.fired("step.nan")
    poisoned = make(nan_policy="skip_step")
    losses = record_losses(poisoned)
    with reg.armed("step.nan", times=1, after=sizes.poison):
        hist = poisoned.fit(feed(x, y), epochs=1, batch_size=b,
                            verbose=False)
    step_losses = [float(v) for v in losses]
    if reg.fired("step.nan") - fired != 1:
        raise AssertionError("train_knobs (b): step.nan did not fire once")
    clean = make()  # no policy: the guard's yardstick too
    clean_hist = clean.fit(feed(x[keep], y[keep]), epochs=1, batch_size=b,
                           verbose=False)
    bad = int(poisoned._bad_steps)
    if (bad != 1 or poisoned.bad_steps != 1 or hist["bad_steps"] != [1]
            or clean.bad_steps != 0):
        raise AssertionError(f"train_knobs (b): bad_steps {bad} "
                             f"({hist['bad_steps']}), clean "
                             f"{clean.bad_steps}")
    if math.isfinite(step_losses[sizes.poison]) or not all(
            math.isfinite(v) for i, v in enumerate(step_losses)
            if i != sizes.poison) or not math.isfinite(hist["loss"][0]):
        raise AssertionError(f"train_knobs (b): step losses {step_losses}")
    caps = captures(poisoned, "train_knobs (b)")
    if poisoned.capture_count != int(sizes.device == "cuda"):
        raise AssertionError(f"train_knobs (b): {caps} (the poisoned step "
                             f"captured anew)")
    leaves = sp_tree_equal(kn_state(poisoned), kn_state(clean),
                           "train_knobs (b) poisoned vs without the batch")
    batch = next(feed(x, y).epoch(poisoned.device, 0))
    ms = {"skip_step": [], "none": []}
    w = sizes.window
    for name, e in (("skip_step", poisoned), ("none", clean),
                    ("none", clean), ("skip_step", poisoned)):
        ms[name].append(kn_window(sizes, lambda: e._multi_step(batch, w), w))
    steps = 2 * sizes.resnet_steps - 1 + 4 * w
    launches = kn_expect(fa, bn, fx, sizes, "(b)",
                         **{f"{BN_KERNEL}_{d}_bf16": sizes.bn_norms * steps
                            for d in ("fwd", "bwd")})
    del poisoned, clean
    sp_free(sizes)
    return {"config": sizes.resnet, "optimizer": "lars",
            "learning_rate": KNOBS_LARS_LR, "batch": b,
            "steps": sizes.resnet_steps, "poisoned_step": sizes.poison,
            "step_losses": step_losses, "epoch_loss": hist["loss"],
            "epoch_loss_without_the_batch": clean_hist["loss"],
            "bad_steps": bad, "captures": caps,
            "leaves_equal_bit_for_bit": leaves, "window_step_ms": ms,
            "step_ms": {k: float(np.median(v)) for k, v in ms.items()},
            "guard_ms": float(np.median(ms["skip_step"])
                              - np.median(ms["none"])),
            "steps_counted": steps, "launches": launches}


def kn_same_nonfinite(got, want, what: str) -> dict:
    """The kernel's outputs against the plain version's on an input with a
    NaN: the same set of non-finite positions in every output (and some in
    each)."""
    counts = []
    for i, (g, w) in enumerate(zip(got, want)):
        gb = ~torch.isfinite(g.float())
        wb = ~torch.isfinite(w.float())
        if not wb.any():
            raise AssertionError(f"train_knobs (c) {what}: output {i} of the "
                                 f"plain version kept no NaN")
        if not torch.equal(gb, wb):
            raise AssertionError(
                f"train_knobs (c) {what}: output {i} has {int(gb.sum())} "
                f"non-finite values, the plain version {int(wb.sum())}; "
                f"{int((gb ^ wb).sum())} positions differ")
        counts.append([int(wb.sum()), wb.numel()])
    return {"nonfinite_of_size": counts}


def kn_nan(fa, bn, fx, sizes) -> dict:
    """train_knobs (c): each of the six bf16 kernel entries of this path
    on an input with one NaN against its plain version on the same input,
    at the path's shapes: the flash forward and backward (a NaN row of q),
    the batch-norm forward (a NaN in x) and backward (a NaN in dy), the
    cross-entropy forward and backward (a NaN row of h)."""
    dev = sizes.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    bf = torch.bfloat16
    cfg = sizes.mlm
    bh, t = sizes.micro * cfg["heads"], sizes.seq
    d = cfg["d_model"] // cfg["heads"]
    q, k, v, dout = (torch.randn(bh, t, d, generator=gen, device=dev
                                 ).to(bf) for _ in range(4))
    q[bh // 2, t // 3] = float("nan")
    res = {"shapes": {"flash": [bh, t, d], "bn": list(sizes.bn_map),
                      "xent": [sizes.micro * t, cfg["d_model"],
                               cfg["vocab"]]}}
    out_k, lse_k = fa.flash_attention_fwd(q, k, v)
    out_r, lse_r = fa.flash_attention_fwd_reference(q, k, v)
    res["flash_fwd"] = kn_same_nonfinite((out_k, lse_k), (out_r, lse_r),
                                         "flash forward")
    res["flash_bwd"] = kn_same_nonfinite(
        fa.flash_attention_bwd(q, k, v, out_k, lse_k, dout),
        fa.flash_attention_bwd_reference(q, k, v, out_r, lse_r, dout),
        "flash backward")
    rows, c = sizes.bn_map
    x = torch.randn(rows, c, generator=gen, device=dev).to(bf)
    gamma = torch.ones(c, device=dev)
    beta = torch.zeros(c, device=dev)
    xn = x.clone()
    xn[rows // 2, c // 3] = float("nan")
    res["bn_fwd"] = kn_same_nonfinite(
        bn.bn_train_fwd(xn, gamma, beta, 1e-5),
        bn.bn_train_fwd_reference(xn, gamma, beta, 1e-5), "bn forward")
    _, mean, var = bn.bn_train_fwd_reference(x, gamma, beta, 1e-5)
    dy = torch.randn(rows, c, generator=gen, device=dev).to(bf)
    dy[rows // 2, c // 3] = float("nan")
    zero = torch.zeros(c, device=dev)
    res["bn_bwd"] = kn_same_nonfinite(
        bn.bn_train_bwd(x, gamma, mean, var, dy, zero, zero, 1e-5),
        bn.bn_train_bwd_reference(x, gamma, mean, var, dy, zero, zero,
                                  1e-5), "bn backward")
    n, dm, vocab = sizes.micro * t, cfg["d_model"], cfg["vocab"]
    h = torch.randn(n, dm, generator=gen, device=dev).to(bf)
    h[n // 2] = float("nan")
    w = 0.02 * torch.randn(dm, vocab, generator=gen, device=dev)
    bias = torch.zeros(vocab, device=dev)
    labels = torch.randint(0, vocab, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    loss_k, lse_k = fx.fused_xent_fwd(h, w, bias, labels, sizes.chunk)
    loss_r, lse_r = fx.fused_xent_reference(h, w, bias, labels, sizes.chunk)
    res["xent_fwd"] = kn_same_nonfinite((loss_k, lse_k), (loss_r, lse_r),
                                        "cross-entropy forward")
    g = torch.ones((), device=dev)
    res["xent_bwd"] = kn_same_nonfinite(
        fx.fused_xent_bwd(h, w, bias, labels, lse_k, g, sizes.chunk),
        fx.fused_xent_bwd_reference(h, w, bias, labels, lse_r, g,
                                    sizes.chunk), "cross-entropy backward")
    return res


def kn_rollback(fa, bn, fx, sizes, root: str) -> dict:
    """train_knobs (d): (b)'s model under nan_policy="rollback" with an
    every-epoch checkpoint, step.nan on the first step of epoch 2: right
    after the rollback the parameters, buffers and LARS state equal a
    fresh estimator's load of the checkpoint bit for bit; the fit ends its
    2 epochs finite, one rollback.  Then nan_policy="raise":
    NonFiniteLossError, and the flight record in model_dir."""
    import json as json_lib

    from analytics_zoo_tpu_torch.core import faults
    from analytics_zoo_tpu_torch.orca.learn import NonFiniteLossError

    make, feed = kn_resnet_maker(sizes)
    x, y = kn_resnet_data(sizes, 2, SEED + 24)
    b = sizes.batch
    reg = faults.get_registry()
    d1 = os.path.join(root, "rollback")
    est = make(nan_policy="rollback", model_dir=d1)
    checked = {}
    rollback = est._rollback_to_checkpoint

    def checked_rollback():
        rollback()
        ref = make()
        ref.load(d1)
        checked["leaves"] = sp_tree_equal(
            kn_state(est), kn_state(ref),
            "train_knobs (d) rolled back vs the checkpoint")
        checked["step"] = est._py_step
        del ref

    est._rollback_to_checkpoint = checked_rollback
    with reg.armed("step.nan", times=1, after=2):
        hist = est.fit(feed(x, y), epochs=2, batch_size=b, verbose=False,
                       checkpoint_trigger="every_epoch")
    finite = all(bool(torch.isfinite(p).all())
                 for p in est.model.parameters())
    if (est._rollbacks != 1 or "leaves" not in checked or est._py_step != 4
            or len(hist["loss"]) != 2 or not finite
            or not all(map(math.isfinite, hist["loss"]))):
        raise AssertionError(f"train_knobs (d) rollback: {est._rollbacks} "
                             f"rollbacks, step {est._py_step}, history "
                             f"{hist}, finite {finite}")
    caps = captures(est, "train_knobs (d)")
    del est
    sp_free(sizes)
    d2 = os.path.join(root, "raise")
    est = make(nan_policy="raise", model_dir=d2)
    raised = None
    with reg.armed("step.nan", times=1, after=1):
        try:
            est.fit(feed(x, y), epochs=1, batch_size=b, verbose=False)
        except NonFiniteLossError as e:
            raised = str(e)
    path = os.path.join(d2, f"flightrec_{os.getpid()}.json")
    if raised is None or not os.path.exists(path):
        raise AssertionError(f"train_knobs (d) raise: raised {raised!r}, "
                             f"flight record {os.path.exists(path)}")
    with open(path) as f:
        record = json_lib.load(f)
    if record["reason"] != "train.NonFiniteLossError":
        raise AssertionError(f"train_knobs (d): flight record's reason "
                             f"{record['reason']}")
    del est
    sp_free(sizes)
    return {"rollback": {"history": hist, "rolled_back_to_step":
                         checked["step"], "leaves_equal_checkpoint":
                         checked["leaves"], "captures": caps},
            "raise": {"error": raised, "flight_record_reason":
                      record["reason"],
                      "flight_record_spans": len(record.get("spans", []))}}


def kn_profile(fa, bn, fx, sizes, root: str) -> dict:
    """train_knobs (e): (b)'s model with profile= (a trace window over
    steps [2, 4), flops_per_sample and the bf16 peak) and log_dir: the
    Chrome trace holds the replayed batch-norm kernels of the window's
    steps (53 of each a step), train.compiles counts the one capture,
    train.mfu is set, scalars.jsonl has every per-epoch tag."""
    import json as json_lib

    from analytics_zoo_tpu_torch.core import metrics as telemetry

    make, feed = kn_resnet_maker(sizes)
    x, y = kn_resnet_data(sizes, sizes.resnet_steps, SEED + 25)
    probe = TrainNet(**sizes.resnet).to(sizes.device)
    fwd_flops = model_flops_per_image(
        probe, torch.from_numpy(x[:2]).to(sizes.device))
    del probe
    tdir, ldir = os.path.join(root, "trace"), os.path.join(root, "logs")
    est = make(nan_policy="skip_step", log_dir=ldir, profile={
        "trace_dir": tdir, "trace_steps": KNOBS_TRACE,
        "flops_per_sample": 3.0 * fwd_flops, "peak_flops": PEAK_BF16_FLOPS})
    compiles0 = telemetry.get_registry().snapshot().get("train.compiles", 0)
    hist = est.fit(feed(x, y), epochs=1, batch_size=sizes.batch,
                   verbose=False)
    snap = telemetry.get_registry().snapshot()
    compiles = snap["train.compiles"] - compiles0
    mfu = snap["train.mfu"]["value"]
    if len(est.trace_files) != 1 or compiles != 1 or est.compile_count != 1 \
            or not mfu > 0:
        raise AssertionError(f"train_knobs (e): traces {est.trace_files}, "
                             f"compiles {compiles}, mfu {mfu}")
    with open(est.trace_files[0]) as f:
        events = json_lib.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    in_trace = {d: sum(f"bn_{d}_kernel" in n for n in kernels)
                for d in ("fwd", "bwd")}
    window = KNOBS_TRACE[1] - KNOBS_TRACE[0]
    if sizes.device == "cuda" and in_trace != {
            d: sizes.bn_norms * window for d in in_trace}:
        raise AssertionError(f"train_knobs (e): the trace of {window} "
                             f"replays holds {in_trace} batch-norm kernels")
    with open(os.path.join(ldir, "train", "scalars.jsonl")) as f:
        tags = sorted({json_lib.loads(line)["tag"] for line in f})
    if tags != sorted(KNOBS_SCALARS):
        raise AssertionError(f"train_knobs (e): summary tags {tags}")
    summary = est.get_train_summary("step_time_ms")
    del est
    sp_free(sizes)
    return {"trace_steps": list(KNOBS_TRACE), "trace_kernels": len(kernels),
            "trace_bn_kernels": in_trace,
            "trace_bytes": os.path.getsize(os.path.join(
                tdir, os.listdir(tdir)[0])),
            "compiles": compiles, "mfu": mfu,
            "flops_per_image": 3.0 * fwd_flops, "epoch_loss": hist["loss"],
            "summary_tags": tags, "step_time_ms_summary": summary}


def phase_train_knobs(fa, bn, fx, sizes=None) -> dict:
    """The Estimator's single-device knobs (see the module docstring): (a)
    BERT MLM under LAMB, (b) ResNet-50 under LARS with a poisoned step,
    (c) NaN through the six bf16 kernel entries, (d) rollback and raise,
    (e) the profiler's trace and the summaries.  ``kernel_launches`` is
    (a)'s and (b)'s runs: the main path, not (c)'s comparisons."""
    import shutil
    import tempfile

    sizes = sizes or TrainKnobsSizes()
    t_phase = time.perf_counter()
    res = {"phase": "train_knobs", "part_seconds": {},
           "card": nvidia_smi() if sizes.device == "cuda" else "cpu"}
    root = tempfile.mkdtemp(prefix="zoo-train-knobs-")

    def part(name, fn):
        t0 = time.perf_counter()
        res[name] = fn()
        res["part_seconds"][name] = time.perf_counter() - t0

    try:
        sp_free(sizes)
        part("mlm_lamb", lambda: kn_mlm(fa, bn, fx, sizes))
        part("resnet_lars", lambda: kn_resnet(fa, bn, fx, sizes))
        part("nan_propagation", lambda: kn_nan(fa, bn, fx, sizes))
        part("rollback_raise", lambda: kn_rollback(fa, bn, fx, sizes, root))
        part("profile_summaries",
             lambda: kn_profile(fa, bn, fx, sizes, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["kernel_launches"] = {
        k: res["mlm_lamb"]["launches"][k] + res["resnet_lars"]["launches"][k]
        for k in res["mlm_lamb"]["launches"]}
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res



# -- scaleout: the Estimator over several processes ---------------------------

SCALEOUT_STRATEGIES = ("dp", "fsdp", "tp", "2d")
SCALEOUT_BERT_EXAMPLES = 64     # (a): 2 steps an epoch at batch 32
SCALEOUT_BERT_EPOCHS = 2        # (a): the captured fit, 4 steps
SCALEOUT_WINDOW = 5             # (a), (b): replays of a timed window
SCALEOUT_COMPRESSION = (None, "none", "bf16", "int8")
SCALEOUT_RESNET_IMAGES = 256    # (b): 2 steps an epoch at batch 128
SCALEOUT_GANG_RANKS = 2         # (d): both on the one card
SCALEOUT_GANG_EPOCHS = 5        # (d): one global batch of 128 an epoch
SCALEOUT_GANG_LR = 1e-3
SCALEOUT_GANG_KILL = 3          # (d): rank 1 dies before its 4th step
# (d) against the one-process run of the same 5 steps: bf16 activations
# summed in another order (two ranks' partial sums, gloo's all-reduce of
# the f32 gradients) move a loss by about 1e-3 of it
TOL_SCALEOUT_GANG = 2e-2
TOL_SPLIT_BN_F32 = 2e-5         # (c): of max(1, |ref|), split vs one-launch
TOL_SPLIT_BN_BF16 = 2e-2        # (c): one bf16 ulp of the output at most
SCALEOUT_TIMEOUT = 400          # one child gang's attempt, seconds


def so_counts(fa, bn, fx, what: str, **want: int) -> dict:
    """``kn_counts`` since the last ``autots_reset_counts``: ``want``'s
    entries as given, every other 0."""
    got = kn_counts(fa, bn, fx)
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"scaleout {what}: launches {got}; want {full}")
    return got


def so_bert(fa, bn, fx, rng) -> dict:
    """(a): BERT-base SQuAD (bf16, flash, batch 32, seq 512) under each
    strategy at world size 1, against the same Estimator made before the
    context: the captured fit's step losses, the flash launches a step
    (every other kernel's 0) and the ms a step of a window of replays."""
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.core.context import (init_orca_context,
                                                      OrcaContext)
    from analytics_zoo_tpu_torch.data import as_feed
    from analytics_zoo_tpu_torch.models import BERTSQuAD, squad_span_loss
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    state = from_jax_variables(random_bert_variables(
        BERTSQuAD(use_flash=True, **BERT_BASE), SEED))
    x, y = squad_examples(rng, SCALEOUT_BERT_EXAMPLES)
    steps = SCALEOUT_BERT_EPOCHS * (SCALEOUT_BERT_EXAMPLES // TRAIN_BATCH)

    def run(sharding):
        m = BERTSQuAD(use_flash=True, **dict(BERT_BASE, dropout=0.1,
                                             dtype=torch.bfloat16))
        m.load_state_dict(state, strict=True)
        kw = {} if sharding is None else {"sharding": sharding}
        est = Estimator.from_keras(m.cuda(), loss=squad_span_loss,
                                   optimizer="adamw",
                                   learning_rate=TRAIN_LR, seed=SEED, **kw)
        losses = []
        inner = est._train_step
        est._train_step = lambda b: losses.append(inner(b)) or losses[-1]
        autots_reset_counts(fa, bn, fx)
        est.fit((x, y), epochs=SCALEOUT_BERT_EPOCHS, batch_size=TRAIN_BATCH,
                verbose=False)
        launches = read_counts(fa, f"scaleout (a) {sharding}", **{
            BF16_KERNEL: steps, BWD_KERNEL: steps})
        per_layer = BERT_BASE["n_layers"] * steps
        counts = so_counts(fa, bn, fx, f"(a) {sharding}",
                           flash_attention_fwd_bf16=per_layer,
                           flash_attention_bwd_bf16=per_layer)
        est._train_step = inner
        batch = next(as_feed((x, y), TRAIN_BATCH, seed=SEED).epoch(
            est.device, 0))
        ms, _ = window_ms(lambda: est._multi_step(batch, SCALEOUT_WINDOW),
                          SCALEOUT_WINDOW)
        out = {"step_losses": [float(v) for v in losses],
               "captured": est.cuda_graphs and est.capture_count == 1,
               "capture_refused": est.capture_refused,
               "ms_per_step": ms,
               "flash_launches_per_step": {
                   k: v / steps for k, v in launches.items()},
               "launches": launches, "counts": counts}
        del est, m
        torch.cuda.empty_cache()
        return out

    base = run(None)  # no context yet
    mesh = init_orca_context("multihost")
    res = {"world": mesh.size, "backend": mesh.backend, "mesh": mesh.shape,
           "no_context": base, "strategies": {}}
    for strategy in SCALEOUT_STRATEGIES:
        r = run(strategy)
        gap = max(abs(a - b) for a, b in zip(r["step_losses"],
                                             base["step_losses"]))
        r["loss_gap_to_no_context"] = gap
        r["equal_bits"] = r["step_losses"] == base["step_losses"]
        if not all(map(math.isfinite, r["step_losses"])):
            raise AssertionError(f"scaleout (a) {strategy}: losses "
                                 f"{r['step_losses']}")
        res["strategies"][strategy] = r
    res["context"] = OrcaContext.config.cluster_mode
    return res


def so_resnet_data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8),
            rng.integers(0, RESNET["class_num"], n).astype(np.int32))


def so_resnet_model(bn, variables, **kw):
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    m = TrainNet(norm="batch", **dict({"dtype": "bfloat16"}, **kw))
    m.load_state_dict(from_jax_variables(variables), strict=True)
    return m.cuda()


def so_compression(fa, bn, fx) -> dict:
    """(b): resnet_train's ResNet-50 (bf16, batch 128, batch norm) under
    each grad_compression at world size 1: the captured fit's losses, the
    batch-norm launches a step, ms a step, train.grad_bytes, the int8
    residuals."""
    from analytics_zoo_tpu_torch.core import metrics as telemetry
    from analytics_zoo_tpu_torch.data import as_feed
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    variables = random_resnet_variables(TrainNet(norm="batch"), SEED)
    x, y = so_resnet_data(SCALEOUT_RESNET_IMAGES, SEED + 30)
    steps = SCALEOUT_RESNET_IMAGES // RESNET_BATCH
    res = {}
    for comp in SCALEOUT_COMPRESSION:
        est = Estimator.from_keras(
            so_resnet_model(bn, variables),
            loss="sparse_categorical_crossentropy", optimizer="sgd",
            learning_rate=RESNET_LR, seed=SEED, grad_compression=comp)
        losses = []
        inner = est._train_step
        est._train_step = lambda b: losses.append(inner(b)) or losses[-1]
        telemetry.get_registry().reset()
        autots_reset_counts(fa, bn, fx)
        est.fit((x, y), epochs=1, batch_size=RESNET_BATCH, verbose=False)
        counts = read_bn_counts(bn, f"scaleout (b) {comp}", bf16=steps)
        every = so_counts(fa, bn, fx, f"(b) {comp}", **{
            f"{BN_KERNEL}_{p}_bf16": RESNET_BN * steps for p in bn.PASSES})
        snap = telemetry.get_registry().snapshot()
        est._train_step = inner
        batch = next(as_feed((x, y), RESNET_BATCH, seed=SEED).epoch(
            est.device, 0))
        ms, _ = window_ms(lambda: est._multi_step(batch, SCALEOUT_WINDOW),
                          SCALEOUT_WINDOW)
        r = {"step_losses": [float(v) for v in losses], "ms_per_step": ms,
             "captured": est.cuda_graphs and est.capture_count == 1,
             "bn_launches": counts, "counts": every,
             "bn_launches_per_step": {k: v / steps for k, v in counts.items()
                                      if v},
             "grad_bytes": snap.get("train.grad_bytes"),
             "comm_ms": snap.get("train.comm_ms")}
        if comp == "int8":
            ef = est._scale.ef
            r["residuals_finite"] = bool(all(
                torch.isfinite(e).all().item() for e in ef))
            r["residuals_nonzero"] = bool(any(
                e.abs().sum().item() > 0 for e in ef))
            r["residual_leaves"] = len(ef)
        res[str(comp)] = r
        del est
        torch.cuda.empty_cache()
    if res["none"]["step_losses"] != res["None"]["step_losses"]:
        raise AssertionError(f"scaleout (b): grad_compression='none' losses "
                             f"{res['none']['step_losses']} are not None's "
                             f"{res['None']['step_losses']}")
    ratio = res["none"]["grad_bytes"] / res["int8"]["grad_bytes"]
    if ratio < 4.0:
        raise AssertionError(f"scaleout (b): int8 grad_bytes only {ratio}x "
                             f"smaller than none's")
    if not (res["int8"]["residuals_finite"]
            and res["int8"]["residuals_nonzero"]):
        raise AssertionError("scaleout (b): int8 residuals not finite and "
                             "nonzero")
    for comp, r in res.items():
        if not all(map(math.isfinite, r["step_losses"])):
            raise AssertionError(f"scaleout (b) {comp}: {r['step_losses']}")
    res["grad_bytes_none_over_int8"] = ratio
    return res


def split_two_ranks(bn, x, g, b, dy, dmean, dvar, eps) -> dict:
    """The split entries as (d)'s two ranks run them, each on its half of
    the batch (n = 2 x its rows), with the group's all-reduces as f32 sums
    of the halves' partials and nonzero dmean and dvar: each entry against
    its plain version on the same inputs, and the halves' y, mean, var and
    dx against the one-launch entries over the whole batch.  The worst
    error of each check, relative to max(1, |ref|)."""
    half, n = x.shape[0] // 2, x.shape[0]
    xs, dys = (x[:half], x[half:]), (dy[:half], dy[half:])
    shift = x[0].float().clone()
    worst = {}

    def check(key, got, ref):
        e = ((got.float() - ref.float()).abs().max()
             / max(1.0, ref.float().abs().max().item())).item()
        worst[key] = max(worst.get(key, 0.0), e)

    parts = [bn.split_fwd_stats(p, shift) for p in xs]
    for p, s in zip(xs, parts):
        check("fwd_stats", s, bn.split_fwd_stats_reference(p, shift))
    sums = parts[0] + parts[1]
    outs = [bn.split_fwd_apply(p, g, b, sums, shift, n, eps) for p in xs]
    for p, o in zip(xs, outs):
        for a, r in zip(o, bn.split_fwd_apply_reference(p, g, b, sums, shift,
                                                        n, eps)):
            check("fwd_apply", a, r)
    mean, var = outs[0][1], outs[0][2]
    if not (torch.equal(mean, outs[1][1]) and torch.equal(var, outs[1][2])):
        raise AssertionError("split_fwd_apply: the two ranks' moments differ")
    parts = [bn.split_bwd_stats(p, mean, var, d, eps) for p, d in zip(xs, dys)]
    for p, d, s in zip(xs, dys, parts):
        check("bwd_stats", s, bn.split_bwd_stats_reference(p, mean, var, d,
                                                           eps))
    sums = torch.cat([parts[0] + parts[1], dmean[None], dvar[None]])
    dxs = [bn.split_bwd_apply(p, g, mean, var, d, sums, n, eps)
           for p, d in zip(xs, dys)]
    for p, d, dx in zip(xs, dys, dxs):
        check("bwd_apply", dx, bn.split_bwd_apply_reference(
            p, g, mean, var, d, sums, n, eps))
    y1, m1, v1 = bn.bn_train_fwd(x, g, b, eps)
    dx1 = bn.bn_train_bwd(x, g, m1, v1, dy, dmean, dvar, eps)[0]
    for a, r in ((torch.cat([o[0] for o in outs]), y1), (mean, m1),
                 (var, v1), (torch.cat(dxs), dx1)):
        check("vs_one_launch", a, r)
    return worst


def so_split_bn(bn) -> dict:
    """(c): the split entries at group size 1 (an explicit one-rank group)
    at every ResNet-50 map at batch 128, bf16 and f32, forward and
    backward, against the plain split version and the one-launch kernel;
    at the same maps as two ranks of 64 images (``split_two_ranks``: global
    n, nonzero dmean and dvar); then their times (CUDA events) beside the bytes bound and
    nn.SyncBatchNorm at world size 1 at three maps."""
    import torch.distributed as dist
    group = dist.new_group([0])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    eps = 1e-3
    maps = resnet_bn_maps(RESNET_BATCH)
    worst = {"bfloat16": {"plain": 0.0, "one_launch": 0.0},
             "float32": {"plain": 0.0, "one_launch": 0.0}}
    worst_abs = {"bfloat16": 0.0, "float32": 0.0}  # against the plain split

    def err(a, b):
        return ((a.float() - b.float()).abs().max()
                / max(1.0, b.float().abs().max().item())).item()

    two_ranks = {"bfloat16": {}, "float32": {}}
    for (rows, c) in maps:
        for dtype in (torch.bfloat16, torch.float32):
            x, g, b, dy, dmean, dvar = bn_inputs(gen, rows, c, dtype)
            key = str(dtype).replace("torch.", "")
            for check, e in split_two_ranks(bn, x, g, b, dy, dmean, dvar,
                                            eps).items():
                two_ranks[key][check] = max(two_ranks[key].get(check, 0.0),
                                            e)
            outs = {}
            for kind in ("split", "plain", "one_launch"):
                xr = x.clone().requires_grad_()
                gr, br = g.clone().requires_grad_(), b.clone().requires_grad_()
                if kind == "one_launch":
                    yv, m, v = bn.bn_train(xr, gr, br, eps)
                else:
                    yv, m, v = bn.bn_train_split(xr, gr, br, eps, group,
                                                 plain=kind == "plain")
                (yv.float() * dy.float()).sum().backward()
                outs[kind] = (yv, m, v, xr.grad, gr.grad, br.grad)
            for ref in ("plain", "one_launch"):
                e = max(err(a, r) for a, r in zip(outs["split"], outs[ref]))
                worst[key][ref] = max(worst[key][ref], e)
            worst_abs[key] = max(worst_abs[key], max(
                (a.float() - r.float()).abs().max().item()
                for a, r in zip(outs["split"], outs["plain"])))
            del outs, x, dy
    for key, w in worst.items():
        tol = TOL_SPLIT_BN_BF16 if key == "bfloat16" else TOL_SPLIT_BN_F32
        if max(w.values()) > tol or max(two_ranks[key].values()) > tol:
            raise AssertionError(f"scaleout (c) {key}: split batch norm off "
                                 f"by {w}, as two ranks by "
                                 f"{two_ranks[key]} > {tol}")
    bn.reset_launches()
    order = list(maps)
    timed_maps = {"stem": order[0],
                  "most_norms": max(maps, key=maps.get), "stage3": order[-1]}
    timings = []
    for label, (rows, c) in timed_maps.items():
        for dtype in (torch.bfloat16, torch.float32):
            x, g, b, dy, _, _ = bn_inputs(gen, rows, c, dtype)
            itemsize = x.element_size()
            sync = torch.nn.SyncBatchNorm(c, eps=eps, momentum=0.01).cuda()
            if dtype == torch.bfloat16:
                sync = sync.to(torch.bfloat16)
            xs = x.reshape(RESNET_BATCH, -1, c).permute(0, 2, 1)
            xr = x.clone().requires_grad_()
            gr, br = g.clone().requires_grad_(), b.clone().requires_grad_()

            def fwd():
                return bn.bn_train_split(x, g, b, eps, group)

            def fwd_plain():
                return bn.bn_train_split(x, g, b, eps, group, plain=True)

            def fwd_one():
                return bn.bn_train(x, g, b, eps)

            def fwd_sync():
                return sync(xs)

            def fwd_bwd(kind):
                def f():
                    xr.grad = gr.grad = br.grad = None
                    if kind == "sync":
                        yv = sync(xr.reshape(RESNET_BATCH, -1, c)
                                  .permute(0, 2, 1))
                        yv.backward(dy.reshape(RESNET_BATCH, -1, c)
                                    .permute(0, 2, 1))
                        return
                    yv, _, _ = bn.bn_train_split(xr, gr, br, eps, group,
                                                 plain=kind == "plain")
                    yv.backward(dy)
                return f

            shift = x[0].float().clone()
            sums = bn.split_fwd_stats(x, shift)
            _, mean, var = bn.split_fwd_apply(x, g, b, sums, shift, rows, eps)
            sums4 = torch.cat([bn.split_bwd_stats(x, mean, var, dy, eps),
                               torch.zeros(2, c, device="cuda")])

            def fwd_kernels():  # the stats and apply launches alone
                bn.split_fwd_apply(x, g, b, bn.split_fwd_stats(x, shift),
                                   shift, rows, eps)

            def bwd_kernels():
                bn.split_bwd_stats(x, mean, var, dy, eps)
                bn.split_bwd_apply(x, g, mean, var, dy, sums4, rows, eps)

            with torch.no_grad():
                t = {"fwd": cuda_ms(fwd), "fwd_plain": cuda_ms(fwd_plain),
                     "fwd_one_launch": cuda_ms(fwd_one),
                     "fwd_library": cuda_ms(fwd_sync),
                     "fwd_kernels": cuda_ms(fwd_kernels),
                     "bwd_kernels": cuda_ms(bwd_kernels)}
            t["fwd_bwd"] = cuda_ms(fwd_bwd("split"))
            t["fwd_bwd_plain"] = cuda_ms(fwd_bwd("plain"))
            t["fwd_bwd_library"] = cuda_ms(fwd_bwd("sync"))
            t["bwd"] = t["fwd_bwd"] - t["fwd"]
            t["bwd_plain"] = t["fwd_bwd_plain"] - t["fwd_plain"]
            t["bwd_library"] = t["fwd_bwd_library"] - t["fwd_library"]
            fb, by = bn_bound(rows, c, itemsize, "fwd")
            bb, _ = bn_bound(rows, c, itemsize, "bwd")
            timings.append(dict(t, map=label, rows=rows, c=c,
                                dtype=str(dtype).replace("torch.", ""),
                                fwd_bound_ms=fb, bwd_bound_ms=bb,
                                bound_by=by))
            del x, dy, sync, xs, xr
    bn.reset_launches()
    return {"maps": len(maps), "worst_rel_err": worst,
            "two_ranks_worst_rel_err": two_ranks,
            "worst_abs_err_to_plain": worst_abs,
            "tol": {"bfloat16": TOL_SPLIT_BN_BF16,
                    "float32": TOL_SPLIT_BN_F32},
            "timings": timings}


def so_gang_reference(fa, bn, fx, variables, x, y) -> dict:
    """The one-process run (d) is held to: the same ResNet-50, images,
    seed and learning rate, the whole batch of 128 a step, eager."""
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    est = Estimator.from_keras(
        so_resnet_model(bn, variables),
        loss="sparse_categorical_crossentropy", optimizer="sgd",
        learning_rate=SCALEOUT_GANG_LR, seed=SEED, cuda_graphs=False)
    losses = []
    inner = est._train_step

    def step(batch):
        loss = inner(batch)
        losses.append(float(loss))
        return loss

    est._train_step = step
    autots_reset_counts(fa, bn, fx)
    est.fit((x, y), epochs=SCALEOUT_GANG_EPOCHS, batch_size=RESNET_BATCH,
            verbose=False)
    counts = read_bn_counts(bn, "scaleout reference", bf16=SCALEOUT_GANG_EPOCHS)
    every = so_counts(fa, bn, fx, "reference", **{
        f"{BN_KERNEL}_{p}_bf16": RESNET_BN * SCALEOUT_GANG_EPOCHS
        for p in bn.PASSES})
    del est
    torch.cuda.empty_cache()
    return {"step_losses": losses, "bn_launches": counts, "counts": every}


def so_single_child(out_path: str) -> int:
    """The world-size-1 child: (a), (b), (c) and (d)'s reference, each
    kernel count read in this process; the results to ``out_path``."""
    import importlib
    fa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")
    bn = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_bn")
    fx = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_xent")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    res = {"bert": so_bert(fa, bn, fx, np.random.default_rng(SEED + 20))}
    res["bert_s"] = time.perf_counter() - t0
    res["compression"] = so_compression(fa, bn, fx)
    res["split_bn"] = so_split_bn(bn)
    variables = random_resnet_variables(TrainNet(norm="batch"), SEED)
    x, y = so_resnet_data(RESNET_BATCH, SEED + 32)
    res["gang_reference"] = so_gang_reference(fa, bn, fx, variables, x, y)
    res["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def so_gang_child(out_dir: str) -> int:
    """One rank of (d): ResNet-50 bf16 dp over the gang, 64 rows a rank of
    each global batch of 128, eager (gloo), a checkpoint every epoch and
    auto_resume; rank 1 of the first attempt dies before its 4th step.
    Each step's loss and the rank's kernel counts go to a jsonl file
    as they happen."""
    import importlib
    from analytics_zoo_tpu_torch.core import faults
    from analytics_zoo_tpu_torch.core.context import init_orca_context
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    fa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")
    bn = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_bn")
    fx = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_xent")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = init_orca_context("multihost")
    attempt = int(os.environ.get("ZOO_RESTART_COUNT", "0"))
    variables = random_resnet_variables(TrainNet(norm="batch"), SEED)
    x, y = so_resnet_data(RESNET_BATCH, SEED + 32)
    est = Estimator.from_keras(
        so_resnet_model(bn, variables),
        loss="sparse_categorical_crossentropy", optimizer="sgd",
        learning_rate=SCALEOUT_GANG_LR, seed=SEED,
        model_dir=os.path.join(out_dir, "ckpt"))
    log = open(os.path.join(out_dir, f"rank{mesh.rank}.jsonl"), "a")
    inner = est._train_step

    def step(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = inner(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        log.write(json.dumps({
            "attempt": attempt, "rank": mesh.rank, "step": est._py_step,
            "loss": float(loss), "ms": ms, "backend": mesh.backend,
            "cuda_graphs": est.cuda_graphs,
            "capture_refused": est.capture_refused,
            "split_launches": dict(bn.SPLIT_KERNEL_LAUNCHES),
            "one_launch": dict(bn.KERNEL_LAUNCHES),
            "counts": kn_counts(fa, bn, fx)}) + "\n")
        log.flush()
        return loss

    est._train_step = step
    if attempt == 0 and mesh.rank == 1:
        faults.get_registry().enable("worker.crash", times=1,
                                     after=SCALEOUT_GANG_KILL)
    autots_reset_counts(fa, bn, fx)
    est.fit((x, y), epochs=SCALEOUT_GANG_EPOCHS, batch_size=RESNET_BATCH,
            verbose=False, checkpoint_trigger="every_epoch",
            auto_resume=True)
    log.write(json.dumps({"attempt": attempt, "rank": mesh.rank,
                          "done": True, "epoch": est._epoch}) + "\n")
    log.close()
    return 0


def phase_scaleout(bn) -> dict:
    """The Estimator over several processes: (a), (b), (c) in one child
    process that ``launch`` starts as a world of 1 over NCCL, then (d), a
    2-process gang on the one card over gloo under the supervisor, with a
    rank killed after a checkpoint and the gang restarted."""
    import shutil
    import tempfile
    from analytics_zoo_tpu_torch.core import launcher
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    me = os.path.abspath(__file__)
    root = tempfile.mkdtemp(prefix="zoo_scaleout_")
    try:
        out = os.path.join(root, "single.json")
        rc = launcher.launch(me, ["--scaleout-child", "single", out], 1,
                             platform="cuda", timeout=SCALEOUT_TIMEOUT)
        if rc != 0:
            raise AssertionError(f"scaleout: the world-1 child exited {rc}")
        with open(out) as f:
            single = json.load(f)
        t_single = time.perf_counter() - t0
        gang_dir = os.path.join(root, "gang")
        metrics_dir = os.path.join(root, "metrics")
        os.makedirs(gang_dir)
        events = []
        rc = launcher.launch(
            me, ["--scaleout-child", "gang", gang_dir], SCALEOUT_GANG_RANKS,
            platform="cuda", timeout=SCALEOUT_TIMEOUT, max_restarts=1,
            heartbeat_timeout=120, status_interval=1.0,
            metrics_dir=metrics_dir,
            on_event=lambda kind, info: events.append([kind, info]))
        if rc != 0:
            raise AssertionError(f"scaleout (d): the gang exited {rc} "
                                 f"({events})")
        ranks = []
        for r in range(SCALEOUT_GANG_RANKS):
            with open(os.path.join(gang_dir, f"rank{r}.jsonl")) as f:
                ranks.append([json.loads(line) for line in f])
        gang_lines = []
        gm = os.path.join(metrics_dir, "gang_metrics.jsonl")
        if os.path.exists(gm):
            with open(gm) as f:
                gang_lines = [json.loads(line) for line in f]
        from analytics_zoo_tpu_torch.core.launcher import \
            aggregate_worker_metrics
        gang_snapshot = aggregate_worker_metrics(metrics_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # rank 0's steps: the killed attempt's, then the resumed ones; the
    # resumed attempt starts at the last checkpoint's step
    steps = {}
    for rec in ranks[0]:
        if "loss" in rec:
            steps[rec["step"]] = rec  # a later attempt's step wins
    losses = [steps[s]["loss"] for s in sorted(steps)]
    ref = single["gang_reference"]["step_losses"]
    if len(losses) != len(ref):
        raise AssertionError(f"scaleout (d): rank 0 ran steps "
                             f"{sorted(steps)}, want {len(ref)}")
    gap = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(losses, ref))
    if gap > TOL_SCALEOUT_GANG or not all(map(math.isfinite, losses)):
        raise AssertionError(f"scaleout (d): gang losses {losses} vs one "
                             f"process {ref} (worst {gap} > "
                             f"{TOL_SCALEOUT_GANG})")
    kinds = [k for k, _ in events]
    if kinds != ["crash", "restart", "ok"]:
        raise AssertionError(f"scaleout (d): supervisor events {events}")
    done = [rec for rank in ranks for rec in rank if rec.get("done")]
    if len(done) != SCALEOUT_GANG_RANKS or any(
            rec["attempt"] != 1 or rec["epoch"] != SCALEOUT_GANG_EPOCHS
            for rec in done):
        raise AssertionError(f"scaleout (d): finished ranks {done}")
    per_rank = {}
    for r, recs in enumerate(ranks):
        by_attempt = {}
        for rec in recs:
            if "split_launches" in rec:
                by_attempt[rec["attempt"]] = rec
        per_rank[r] = {a: {"steps": sum(1 for x in recs if "loss" in x
                                        and x["attempt"] == a),
                           "split_launches": rec["split_launches"],
                           "one_launch": rec["one_launch"],
                           "counts": rec["counts"],
                           "backend": rec["backend"],
                           "cuda_graphs": rec["cuda_graphs"],
                           "capture_refused": rec["capture_refused"]}
                       for a, rec in by_attempt.items()}
        for a, rec in per_rank[r].items():
            want = RESNET_BN * rec["steps"]
            got = {k: v for k, v in rec["split_launches"].items() if v}
            every = {k: v for k, v in rec["counts"].items() if v}
            if got != {f"{p}_bf16": want for p in bn.SPLIT_PASSES} or any(
                    rec["one_launch"].values()) or every != {
                        f"{BN_KERNEL}_{k}": v for k, v in got.items()}:
                raise AssertionError(f"scaleout (d) rank {r} attempt {a}: "
                                     f"split launches {got}, one-launch "
                                     f"{rec['one_launch']}, all {every}; "
                                     f"want {want} of each bf16 split "
                                     "entry, no other launch")
    split_total = {k: sum(rec["split_launches"][k]
                          for rank in per_rank.values()
                          for rec in rank.values())
                   for k in bn.SPLIT_KERNEL_LAUNCHES}
    counts_total = {k: sum(rec["counts"][k] for rank in per_rank.values()
                           for rec in rank.values())
                    for k in ranks[0][0]["counts"]}
    step_ms = {r: [rec["ms"] for rec in recs if "ms" in rec]
               for r, recs in enumerate(ranks)}
    res = {"phase": "scaleout", "single": single, "gang": {
        "ranks": SCALEOUT_GANG_RANKS, "global_batch": RESNET_BATCH,
        "lr": SCALEOUT_GANG_LR, "step_losses": losses,
        "step_ms_by_rank": step_ms,
        "step_ms_p50": float(np.median([v for r in step_ms.values()
                                        for v in r[1:]])),
        "reference_losses": ref, "worst_rel_gap": gap,
        "tol": TOL_SCALEOUT_GANG, "events": events,
        "per_rank": per_rank, "split_launches": split_total,
        "counts": counts_total,
        "gang_metrics_lines": len(gang_lines),
        "gang_metrics_last": gang_lines[-1] if gang_lines else None,
        "gang_snapshot_series": sorted(gang_snapshot)},
        "single_child_s": t_single,
        "seconds": time.perf_counter() - t0}
    emit(res)
    return res


def phase_devices() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "devices", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def kernel_entry(name, design, launches, path, replaces, x) -> dict:
    """One entry of the ``kernels`` line from a timing record ``x``."""
    return {"name": name, "design": design, "route": "cuda",
            "source": f"analytics_zoo_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "path": path, "launches": launches,
            "max_abs_err": x["max_abs_err"], "ms": x["ms"],
            "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
            "bound_by": x["bound_by"], "fma_bound_ms": x.get("fma_bound_ms"),
            "library_ms": x["library_ms"],
            "device_ms": x["device_ms"],
            "plain_device_ms": x["plain_device_ms"],
            "library_device_ms": x["library_device_ms"]}


def main(argv) -> int:
    only = []
    if argv[:1] == ["--scaleout-child"] and len(argv) == 3:
        # a process that phase_scaleout's launcher started
        return (so_single_child if argv[1] == "single"
                else so_gang_child)(argv[2])
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = argv[1].split(",")
    elif argv:
        print("usage: chip_smoke.py [--only phase,phase,...]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import importlib
    from analytics_zoo_tpu_torch.ops import _build
    fa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")
    bn = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_bn")
    fx = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_xent")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_script = t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:  # one nvcc per source, together
        list(pool.map(_build.build, (BF16_KERNEL, F32_KERNEL, BWD_KERNEL,
                                     BN_KERNEL, XENT_KERNEL)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    if only:  # a subset of the phases, for iterating on one: no last line
        phases = {"kernel": lambda: phase_kernel(fa),
                  "fused_bn": lambda: phase_fused_bn(bn),
                  "bert_serve": lambda: phase_bert_serve(fa),
                  "int8_serve": lambda: phase_int8_serve(fa),
                  "cluster_serve": lambda: phase_cluster_serve(fa),
                  "bert_train": lambda: phase_bert_train(fa),
                  "resnet_train": lambda: phase_resnet_train(bn),
                  "fused_xent": lambda: phase_fused_xent(fx),
                  "bert_mlm_train": lambda: phase_bert_mlm_train(fa, fx),
                  "ncf_train": phase_ncf_train,
                  "recsys": phase_recsys,
                  "state_plane": lambda: phase_state_plane(fa, bn),
                  "autots": lambda: phase_autots(fa, bn, fx),
                  "readers": lambda: phase_readers(fa, bn, fx),
                  "foreign": lambda: phase_foreign(bn),
                  "train_knobs": lambda: phase_train_knobs(fa, bn, fx),
                  "scaleout": lambda: phase_scaleout(bn)}
        for name in only:
            phases[name]()
        return 0
    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        emit({"phase_seconds": name, "seconds": time.perf_counter() - t})
        return out

    kern = timed("kernel", phase_kernel, fa)
    bn_kern = timed("fused_bn", phase_fused_bn, bn)
    serve = timed("bert_serve", phase_bert_serve, fa)
    int8 = timed("int8_serve", phase_int8_serve, fa)
    cluster = timed("cluster_serve", phase_cluster_serve, fa)
    train = timed("bert_train", phase_bert_train, fa)
    resnet = timed("resnet_train", phase_resnet_train, bn)
    xent_kern = timed("fused_xent", phase_fused_xent, fx)
    mlm = timed("bert_mlm_train", phase_bert_mlm_train, fa, fx)
    timed("ncf_train", phase_ncf_train)
    timed("recsys", phase_recsys)
    state = timed("state_plane", phase_state_plane, fa, bn)
    autots = timed("autots", phase_autots, fa, bn, fx)
    readers = timed("readers", phase_readers, fa, bn, fx)
    foreign = timed("foreign", phase_foreign, bn)
    knobs = timed("train_knobs", phase_train_knobs, fa, bn, fx)
    scaleout = timed("scaleout", phase_scaleout, bn)
    smi = phase_devices()
    print(smi, flush=True)
    timed = {x["kernel"]: x for x in kern["timings"]
             if x["bh"] == TIMED_SHAPE["b"] * TIMED_SHAPE["h"]
             and not x["causal"]}
    timed.update({(BWD_KERNEL, x["dtype"]): x for x in kern["bwd_timings"]})
    fwd_src = "analytics_zoo_tpu/ops/flash_attention.py:44"
    bwd_src = "analytics_zoo_tpu/ops/flash_attention.py:187"
    bn_src = "analytics_zoo_tpu/ops/fused_bn.py:76"
    entries = []
    for name, key, design, launches, path, replaces in (
            (BF16_KERNEL, BF16_KERNEL,
             "bf16: wgmma fed by a 2-stage TMA ring, one warpgroup a block "
             "of 64 q rows (d 33-64); mma.sync with a cp.async ring for "
             "the other heads up to 256",
             serve["flash_launches"][BF16_KERNEL], "bert_serve bf16",
             fwd_src),
            (F32_KERNEL, F32_KERNEL,
             "f32: wgmma in 3xTF32 (big and small tf32 parts, three "
             "products per f32 product) after a split pass (q's and k's "
             "parts as they are, v's transposed), one warpgroup a block of "
             "64 q rows streaming 32-key tiles through a 2-stage TMA ring, "
             "two blocks an SM, P split in registers into the A fragments "
             "of P V (d <= 64); scalar FMAs for d 65-256, the wide kernel "
             "above", serve["f32_flash_launches"][F32_KERNEL],
             "bert_serve f32", fwd_src),
            (BWD_KERNEL, (BWD_KERNEL, "bfloat16"),
             "bf16: wgmma fed by a 2-stage TMA ring, one warpgroup a "
             "block (d 33-64); mma.sync with a cp.async ring for d <= 32, "
             "scalar f32 above 64; delta, dK/dV and dQ passes, no atomics",
             train["launches"][BWD_KERNEL], "bert_train bf16", bwd_src),
            (BWD_KERNEL, (BWD_KERNEL, "float32"),
             "f32: wgmma in 3xTF32 (big and small tf32 parts, three "
             "products per f32 product) fed by a 2-stage TMA ring of "
             "32-row tiles, one warpgroup a block of 64 keys or q rows, one "
             "block an SM (d <= 64; scalar FMAs above); a split pass "
             "writes each operand's parts, transposed where a product's "
             "depth is T; then delta, dK/dV and dQ passes, no atomics",
             train["f32_check"]["launches"][BWD_KERNEL], "bert_train f32",
             bwd_src)):
        x = timed[key]
        entry = kernel_entry(name, design, launches, path, replaces, x)
        entry["shape"] = {k: x[k] for k in ("bh", "t", "d", "dtype")}
        entries.append(entry)
    entries[0]["launches_bert_train_bf16"] = train["launches"][BF16_KERNEL]
    entries[0]["launches_bert_train_captured"] = \
        train["captured"]["launches"][BF16_KERNEL]
    entries[2]["launches_bert_train_captured"] = \
        train["captured"]["launches"][BWD_KERNEL]
    for mode, run in int8["bert"].items():
        entries[0][f"launches_int8_serve_{mode}"] = \
            run["flash_launches"][BF16_KERNEL]
    entries[0]["launches_cluster_serve"] = \
        cluster["flash_launches"][BF16_KERNEL]
    # the resumed SQuAD fit of state_plane (c), from its replays
    entries[0]["launches_state_plane"] = \
        state["squad"]["launches"][BF16_KERNEL]
    entries[2]["launches_state_plane"] = \
        state["squad"]["launches"][BWD_KERNEL]
    entries[0]["launches_by_design_cluster_serve"] = \
        cluster["fwd_launches_by_design"]
    entries[0]["launches_by_design"] = serve["fwd_launches_by_design"]
    entries[0]["launches_by_design_bert_train_bf16"] = \
        train["fwd_launches_by_design"]
    entries[1]["launches_by_design"] = serve["f32_fwd_launches_by_design"]
    entries[1]["launches_by_design_bert_train_f32"] = \
        train["f32_check"]["fwd_launches_by_design"]
    entries[1]["at_bert_train_f32"] = {
        k: x[k] for x in kern["timings"]
        if x["dtype"] == "float32"
        and x["bh"] == CHECK_BATCH * TRAIN_SHAPE["h"]
        for k in ("bh", "ms", "plain_ms", "library_ms", "device_ms",
                  "plain_device_ms", "library_device_ms", "bound_ms",
                  "fma_bound_ms", "max_abs_err")}
    entries[2]["launches_by_design"] = train["bwd_launches_by_design"]
    entries[3]["launches_by_design"] = \
        train["f32_check"]["bwd_launches_by_design"]
    entries[1]["launches_bert_train_f32"] = \
        train["f32_check"]["launches"][F32_KERNEL]
    # fused batch norm: one entry per direction and dtype, timed at the
    # stem's shape (the last stage's beside it), launches of the main path
    # run of that dtype (bf16: resnet_train (b); f32: (a)'s fit)
    bn_times = {(x["direction"], x["dtype"], x["shape"]): x
                for x in bn_kern["timings"]}
    for direction, passes in (("fwd", ("fwd",)), ("bwd", ("bwd",))):
        for dtype, sfx, counts, path in (
                ("bfloat16", "bf16", resnet["batch"]["launches"],
                 "resnet_train bf16"),
                ("float32", "f32", resnet["f32_check"]["launches"],
                 "resnet_train f32")):
            x = bn_times[(direction, dtype, "stem")]
            entry = kernel_entry(
                BN_KERNEL, f"{dtype}, {direction}: one persistent "
                "cooperative launch, a 512-thread block an SM over "
                "(16-byte channel vectors x row ranges): f32 partials, one "
                "grid barrier, each block's own finalize, then the output; "
                "up to 200 KB of each block's rows kept in shared memory "
                "(cp.async.bulk) between the phases, the rest re-read in "
                "reverse; no atomics", counts[f"{passes[0]}_{sfx}"], path,
                bn_src, x)
            entry["launches_by_pass"] = {p: counts[f"{p}_{sfx}"]
                                         for p in passes}
            # the readers' ImageSet fit (bf16, from the replays)
            entry["launches_readers"] = readers["kernel_launches"][
                f"{BN_KERNEL}_{passes[0]}_{sfx}"]
            if sfx == "bf16":  # resnet_train (d), norm="batch"
                entry["launches_resnet_train_captured"] = resnet[
                    "captured"]["batch"]["launches"][f"{passes[0]}_{sfx}"]
                # state_plane (b)'s resumed fits, sync and async
                entry["launches_state_plane"] = {
                    mode: state["resnet"][mode]["launches"][
                        f"{passes[0]}_{sfx}"] for mode in ("sync", "async")}
            entry["shape"] = {"rows": x["rows"], "c": x["c"],
                              "dtype": dtype}
            for label in ("most_norms", "stage3"):
                y = bn_times[(direction, dtype, label)]
                entry[f"at_{label}"] = {k: y[k] for k in (
                    "rows", "c", "ms", "plain_ms", "library_ms",
                    "device_ms", "plain_device_ms", "library_device_ms",
                    "bound_ms", "max_abs_err")}
            entries.append(entry)
    # fused softmax cross-entropy: one entry per direction and activation
    # dtype, timed at the recipe's head shape, launches of the main path
    # run of that dtype (bf16: bert_mlm_train (c); f32: (a)'s fused fit)
    xent_times = {(x["direction"], x["dtype"]): x
                  for x in xent_kern["timings"]}
    xent_src = "analytics_zoo_tpu/ops/fused_xent.py:50"
    bwd_designs = {
        "wgmma": "bf16, wgmma m64n128k16 fed by a TMA ring, two warpgroups "
                 "a 128 x 128 tile; over every token: dl, dh (split-K, "
                 "reduced in order) and dW (f32 sum in registers, written "
                 "once) passes, then db",
        "wgmma_tf32": "f32: the dl pass's logits on scalar FMAs in the "
                      "forward's summation order, then dh (split-K, "
                      "reduced in order) and dW (f32 sum in registers) on "
                      "wgmma m64n128k8 in 3xTF32 (A from registers, split "
                      "there; B as tf32 parts from split passes of W and "
                      "h^T) fed by a 2-stage TMA ring of 64-deep slices, "
                      "two warpgroups a 128 x 128 tile; over every token; "
                      "then db"}
    for direction, passes in (("fwd", ("fwd",)), ("bwd", ("dl", "dh", "dw"))):
        for dtype, sfx, counts, path in (
                ("bfloat16", "bf16", mlm["fused"]["launches"],
                 "bert_mlm_train bf16 (fused head)"),
                ("float32", "f32", mlm["f32_check"]["launches"],
                 "bert_mlm_train f32 (fused head)")):
            x = xent_times[(direction, dtype)]
            if direction == "fwd":
                design = x["design"] + (
                    ": bf16, the bf16 backward's dl main loop (wgmma "
                    "m64n128k16 fed by a 3-stage TMA ring, two warpgroups a "
                    "128 x 128 tile, two blocks an SM; W packed once and "
                    "handed to the backward)" if sfx == "bf16"
                    else ": f32, scalar FMAs, 128 x 256 tiles")
                design += ("; fwd: logit tiles' max / sum-exp / label "
                           "logit, per-token finalize, mean; logits never "
                           "written")
            else:
                design = f"{x['design']}: {bwd_designs[x['design']]}"
            entry = kernel_entry(
                XENT_KERNEL, design + "; no atomics",
                counts[f"{passes[0]}_{sfx}"], path, xent_src, x)
            entry["launches_by_pass"] = {p: counts[f"{p}_{sfx}"]
                                         for p in passes}
            entry["launches_by_design"] = (
                mlm["fused"] if sfx == "bf16" else mlm["f32_check"]
            )[f"{direction}_launches_by_design"]
            if sfx == "bf16":  # bert_mlm_train (d)
                entry["launches_bert_mlm_train_captured"] = {
                    p: mlm["captured"]["launches"][f"{p}_{sfx}"]
                    for p in passes}
            entry["shape"] = {k: x[k] for k in ("n", "d", "v", "chunk",
                                                "dtype", "w_dtype")}
            entries.append(entry)
    # the autots path launches no kernel of the port (phase_autots holds
    # every count to 0 over it); the readers' path only the batch norm's
    # (set above), every other count 0
    def mine(k, entry):  # the split entries' counts are theirs alone
        return k.startswith(entry["name"]) and "_split_" not in k

    for entry in entries:
        entry["launches_autots"] = sum(
            n for k, n in autots["kernel_launches"].items()
            if mine(k, entry))
        entry.setdefault("launches_readers", sum(
            n for k, n in readers["kernel_launches"].items()
            if mine(k, entry)))
        # the foreign phase's counted windows: the converted ResNet-50's
        # replays, the transfer's and DCGAN's D and G steps (f32 batch
        # norm only)
        entry["launches_foreign"] = 0
        if entry["name"] == BN_KERNEL:
            direction = next(iter(entry["launches_by_pass"]))
            sfx = "bf16" if entry["shape"]["dtype"] == "bfloat16" else "f32"
            entry["launches_foreign"] = foreign["kernel_launches"][
                f"{BN_KERNEL}_{direction}_{sfx}"]
    # train_knobs: (a)'s and (b)'s captured runs, by entry
    flash_keys = ("flash_attention_fwd_bf16", "flash_attention_fwd_f32",
                  "flash_attention_bwd_bf16", "flash_attention_bwd_f32")
    keys = []  # each entry's key in kn_counts
    for i, entry in enumerate(entries):
        if i < len(flash_keys):
            key = flash_keys[i]
        else:
            sfx = "bf16" if entry["shape"]["dtype"] == "bfloat16" else "f32"
            key = (f"{entry['name']}_{next(iter(entry['launches_by_pass']))}"
                   f"_{sfx}")
        keys.append(key)
        entry["launches_train_knobs"] = knobs["kernel_launches"][key]
    # scaleout: (a)'s captured fits, (b)'s, (d)'s one-process reference
    # and (d)'s gang, every kernel counted in each
    single = scaleout["single"]
    so_runs = ([single["bert"]["no_context"]]
               + list(single["bert"]["strategies"].values())
               + [r for r in single["compression"].values()
                  if isinstance(r, dict) and "counts" in r]
               + [single["gang_reference"], scaleout["gang"]])

    def so_launches(key):
        return sum(r["counts"][key] for r in so_runs)

    for key, entry in zip(keys, entries):
        entry["launches_scaleout"] = so_launches(key)
    split = single["split_bn"]
    split_times = {(x["map"], x["dtype"]): x for x in split["timings"]}
    for direction in ("fwd", "bwd"):
        for dtype, sfx in (("bfloat16", "bf16"), ("float32", "f32")):
            x = split_times[("stem", dtype)]
            key = f"{BN_KERNEL}_split_{direction}_stats_{sfx}"
            launches = scaleout["gang"]["counts"][key]
            entry = {
                "name": f"{BN_KERNEL}_split_{direction}", "route": "cuda",
                "design": f"{dtype}, {direction}, over a batch split across "
                          "processes: a stats launch (a (channel tile x row "
                          "split) grid of 512-thread blocks writing f32 "
                          "partials, then a per-channel sum of the splits "
                          "in order), an all_reduce of the sums over the "
                          "data group, an apply launch (the one-launch "
                          "kernel's finalize and element pass); no atomics",
                "source": f"analytics_zoo_tpu_torch/csrc/{BN_KERNEL}.cu",
                "replaces": bn_src,
                "path": "scaleout (d) bf16 gang" if sfx == "bf16" else
                        "none (the (d) gang is bf16; checked in (c))",
                "launches": launches,
                "launches_by_pass": {
                    p: scaleout["gang"]["split_launches"][f"{p}_{sfx}"]
                    for p in bn.SPLIT_PASSES if direction in p},
                "launches_scaleout": so_launches(key),
                "launches_autots": autots["kernel_launches"][key],
                "launches_readers": readers["kernel_launches"][key],
                "launches_foreign": foreign["kernel_launches"][key],
                "launches_train_knobs": knobs["kernel_launches"][key],
                "launches_by_rank": {
                    r: {a: rec["split_launches"] for a, rec in att.items()}
                    for r, att in scaleout["gang"]["per_rank"].items()},
                "max_abs_err": split["worst_abs_err_to_plain"][dtype],
                "max_rel_err": split["worst_rel_err"][dtype]["plain"],
                "max_rel_err_to_one_launch":
                    split["worst_rel_err"][dtype]["one_launch"],
                "max_rel_err_two_ranks":
                    split["two_ranks_worst_rel_err"][dtype],
                "ms": x[direction], "plain_ms": x[f"{direction}_plain"],
                "kernels_ms": x[f"{direction}_kernels"],
                "bound_ms": x[f"{direction}_bound_ms"],
                "bound_by": x["bound_by"],
                "library_ms": x[f"{direction}_library"],
                "library": "torch.nn.SyncBatchNorm at world size 1",
                "shape": {"rows": x["rows"], "c": x["c"], "dtype": dtype},
                "at_other_maps": {
                    label: {k: split_times[(label, dtype)][k] for k in (
                        "rows", "c", direction, f"{direction}_plain",
                        f"{direction}_library", f"{direction}_bound_ms")}
                    for label in ("most_norms", "stage3")}}
            entries.append(entry)
    emit({"phase": "total", "seconds": time.perf_counter() - t_script})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
