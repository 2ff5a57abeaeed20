#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving and training paths on one CUDA card,
end to end: the static BERT program, the wide&deep CTR program, the
flagship dygraph ``BertForPretraining`` step, paged decode, the static
book tier (MNIST LeNet), the dygraph ResNet-50 step, the Transformer NMT
step and MobileNetV2 (with VGG16 and MobileNetV1 evaluated), the BoxPS
CTR trainer (``bench.py:547 main_ctr``), the 2.0 dygraph loop (the
PTB LSTM language model and the dygraph WideDeep and DeepFM), ``hapi``'s
``Model.fit``, the static training surface (the BERT recipe of the
Paddle 1.8 era, fp32 master weights, the fluid optimizers and control
flow), the dygraph-to-static tier (``paddle.jit.to_static``,
``jit.save`` / ``jit.load``, static AMP's loss scaling), the deployment
path, and the rest of the serving surface (speculative paged decode, the
serving engine's deadlines, pause, instruments, spans, flight recorder
and metrics export).

    python3 chip_smoke.py

Phases (each one fails the run on error; nothing is caught and passed
over):

1. device  -- the card's name, the device count, and nvidia-smi's name
   and power limit.  No CUDA device: exit 1 before anything else.
2. build   -- nvcc compiles every ``paddle_tpu_torch/csrc/*.cu`` for
   sm_90a into ``paddle_tpu_torch/build/``, one process per source, all
   started together; ptxas's register and shared-memory lines are printed.
3. kernels -- each kernel of the two paths against its plain PyTorch
   version at the shapes the paths give it, with the tolerance printed.
   Flash attention forward and backward: q, k, v (and dO) the permuted
   [32,12,128,64] views transpose2 leaves behind, a [32,1,1,128] padding
   bias, float32 and bfloat16, the served batch of 1 row, plus causal
   cases, ragged T = 100 at head dims 32, 64 and 128, head dim 40 (not a
   multiple of the bf16 mma depth) and the bias the BERT program builds,
   (m - 10000) * 10000, in both dtypes; the forward's softmax statistics
   (row max and sum) too.  Their times are device ms from the profiler,
   the library's backward that of SDPA's backward kernels alone.  Fused Adam:
   one multi-tensor launch over the BERT-base bucket's 99 parameters
   (51,790,850 values) where they lie, ``torch.equal`` to the per-param
   ``adam`` lowering on all five outputs over two steps, timed by the
   profiler's device ms with the op's wall ms beside.  The CTR kernels at the
   training path's shapes, [4096, 5] ids into a [1e6, D] table for D = 16
   and 128, with uniform ids, Zipf(1.1) ids and a Length-masked AVERAGE
   weight with a padding id: the gather-pool forward within 1e-6 of its
   plain version and bit-exact on dyadic values, timed cold and warm at
   [4096, 5], the serve batch's [512, 5] and [1, 5] beside an empty
   kernel's device ms (the floor of any launch); the scatter-add gradient
   bit-identical across two launches and to the host's ``index_add_``,
   its device ms split into zero-fill, sort and segments.
   Fused Momentum: ``torch.equal`` to the per-param ``momentum`` lowering
   over the CTR bucket (32 parameters, 416,013,807 values), plain,
   Nesterov and l2_decay; the op's one kernel a call, read where the
   bucket lies (the profiler sees no copy).  Times by CUDA events, the
   kernel's beside the op's, beside the least time
   the card could take (the bound) and one PyTorch library call
   computing the same function where there is one (timed here only,
   never called by the port).  Flash attention at the NMT step's shapes
   (NMT_FLASH_CASES, [32,16,T,64]): the decoder's causal ``[1,1,64,64]``
   bias of -1e9 (read with stride 0 over B and H), the encoder's
   unmasked 64 tokens and a cross-attention of 64 queries over 96 keys,
   forward (and its statistics) and backward, float32 and bfloat16, each
   timed beside its bound and SDPA's.
3e. dropout -- the five dropout kernels (``csrc/fused_dropout.cu``:
   dropout, its mask, dropout-add, act-dropout and its backward) against
   their plain Philox versions at [8192, 768] and [8192, 3072], float32
   and bfloat16, rates 0.1 and 0.5, upscale and downgrade, gelu and
   relu: masks, dropout and dropout-add ``torch.equal``, act-dropout
   within ACT_TOL, the kept fraction within 6 sigma of 1 - rate, the
   backwards (through the ops' autograd Functions) equal to g · Mask ·
   scale (· act'(x)), a twin of seed + 1 must miss.  Device ms per call
   from the profiler, beside the bound (the largest of bytes, float32
   ops and Philox4x32-10's integer work per group of four, 20 FMA-pipe
   and 24 ALU-pipe operations at 64 lanes a pipe and 128 issued per
   clock per SM, at the SM clock nvidia-smi reports), the plain version's,
   ``torch.nn.functional.dropout``'s and, for the mask, a uint8
   ``bernoulli_``'s (other bits); the log line also gives each as a
   share of its recorded time (DROPOUT_RECORDED_MS); the mask also cold
   and beside a uint8 ``fill_`` of its size.  Then the NMT step's shapes
   in bfloat16: dropout, its mask and dropout-add at [2048, 1024], relu
   act-dropout and its backward at [2048, 4096], the same checks, each
   timed.  Then the PTB step's shape, [20, 35, 1500] at rate 0.65, in
   float32 and bfloat16 under both implementations, the same checks,
   and dropout and its mask timed under ``downgrade_in_infer``.
3f. paged attention -- the paged decode-attention kernel against its
   plain version at 1, 8 and 32 slots of 512 positions over a
   16,400-row pool of width 768, five masks (all valid, ragged,
   non-prefix, an all-masked row, 300 valid), within 1e-5 of the largest
   |out|; a twin with the page table rolled by one page must miss.
   Device ms cold (a 64 MB buffer read before each call flushes the
   L2) and warm, beside the bound, the plain version's and the library
   pair's (two ``index_select`` + ``scaled_dot_product_attention``).
   On the serve, train and dygraph paths the flash wrappers must copy
   no input for 16-byte alignment (their ``copies`` counts read 0).
4. serve   -- the static BERT program at BERT-base width (vocab 30522,
   hidden 768, 12 heads, 12 layers, seq 128, dropout 0.1, padding mask),
   random weights from a seed, frozen, ``fuse_attention`` applied, served
   by ``ServingEngine(max_batch=32)``: warmup, then 16 requests of mixed
   row counts.  The kernels' launch counts are set to 0 just before the
   requests and read just after; every kernel of the path must have run,
   flash attention once per layer per dispatched batch.  Two requests
   are run again on the host (plain versions) and must agree; weights
   scaled so that the first layers' attention is far from uniform, and a
   uniform-attention twin that must disagree, show that this comparison
   sees the scores.
4b. train -- the static BERT training program at the same width with
   dropout 0, padding mask on, Adam lr 1e-3, batch 32: random weights as
   in phase 4, ``fuse_attention`` (12 rewrites, train rules) and
   ``fuse_optimizer`` (one ``fused_adam``) applied, one warm-up step and
   10 timed steps through ``Executor.run(CompiledProgram)``.  The launch
   counts are set to 0 just before the timed steps and read just after:
   per step 24 flash-attention forward launches (12 in the forward ops,
   12 recomputed inside ``generic_grad``'s vjp), 12 backward calls and 1
   fused-Adam launch.  Then 2 steps at 4 rows on the card and on the host
   from the same weights and state: losses within rtol 1e-4, first-step
   gradients of the embedding and of every layer's query and key weights
   within 1e-3 of the largest such gradient; a host twin whose attention
   backward drops dQ and dK must miss that tolerance.
4c. serve CTR -- the wide&deep CTR program at Criteo width (26 slots,
   dim 16, 5 ids per slot, 1,000,000 rows per table, 13 dense features),
   random weights from a seed, frozen at the logit,
   ``fuse_sparse_embedding`` applied (26 rewrites), served by
   ``ServingEngine(max_batch=512)``: 16 requests of 1 to 500 rows with
   Zipf ids; 26 gather-pool launches per dispatched batch.  Two requests
   rerun on the host agree within 1e-5 of the largest logit; a twin
   that pools only each slot's first id must miss by 10 times that.
4d. train CTR -- the same program with its loss and Momentum (lr 0.05,
   mu 0.9), ``fuse_sparse_embedding`` and ``fuse_optimizer`` (26 rewrites,
   one ``fused_momentum``), batch 4096: one warm-up step and 10 timed
   steps, exactly 260 forward, 260 gradient and 10 Momentum launches.
   Then 2 steps on the card and on the host from one state at vocab
   100,000 (everything else at full width): losses within rtol 1e-5,
   first-step dW of every slot and every parameter and velocity after
   2 steps within 1e-6 of their largest entry; a twin whose gradient
   keeps only the last of each repeated id must miss on every slot.
4e. train dygraph -- ``BertForPretraining`` at BERT-base width
   (``bench.py``'s full configuration: vocab 30522, hidden 768, 12
   layers of 12 heads, FFN 3072, seq 128, batch 64, dropout and attention
   dropout 0.1, Adam lr 1e-4, bf16 autocast), built under the card's
   dygraph tracer from seeded initializers, trained by
   ``torch.func.grad_and_value(functional_loss(...))`` and
   ``make_fused_adam``: one warm-up step, 10 timed steps, each kernel's
   launches exactly DY_LAUNCHES a step.  The bf16 first step's loss
   within BF16_LOSS_RTOL of a float32 step's from the same weights and
   seeds.  Float32 at 4 rows, dropout live: 2 steps on the card and on
   the host from the same weights, seeds and Adam state, losses within
   rtol 1e-4 and first-step gradients within 1e-3 of their group's
   largest; a host twin whose masks use seed + 1 must miss; one tape
   step (``loss.backward()``) on the card within 1e-5 of the functional
   gradients.
4g. static e2e / LeNet -- the six cases of ``tests/test_static_e2e.py``
   on ``CUDAPlace(0)`` with their assertions (fit-a-line, LeNet 40 Adam
   steps, batch norm's moving statistics, save and load of the
   persistables, ``clone(for_test=True)``, Momentum with
   ``GradientClipByGlobalNorm``).  Then MNIST LeNet at the repo's width
   (51,806 parameters) on the seeded synthetic digits, batch 64, through
   ``CompiledProgram`` with ``kernel_tier``: one ``fused_optimizer``
   rewrite, 40 steps with exactly one ``fused_adam`` launch and no
   ``adam`` lowering a step, loss < 0.5 and accuracy > 0.9.  Card
   against host from one state (3 steps, LeNet and a batch-norm variant):
   losses within rtol 1e-4, first-step gradients within 1e-4 of the
   largest; host twins (conv padding all on the low side; batch norm on
   the moving statistics in training) must miss.  The kernel tier against
   the plain program on the card, 3 steps: bit for bit.  50 rows
   bucketed to 64 against the unbucketed step (both variants, moving
   statistics too): rtol 1e-4, atol 1e-5.  The clip case through the
   kernel tier: one ``fused_momentum`` launch a step.  ``fused_adam`` at
   LeNet's eight segments and ``fused_momentum`` at the clip case's
   bucket, ``torch.equal`` to their plain versions, device ms beside the
   plain, library and bound.
4h. train dygraph ResNet-50 -- ``vision.models.resnet50`` at
   ``bench.py:449``'s full width (1000 classes, NHWC, batch 128 of
   224x224x3 images and labels from seed 0, bf16 autocast), through both
   of the repo's entry points: (a) ``functional_loss`` +
   ``torch.func.grad_and_value`` and SGD with momentum 0.9, lr 0.1, on
   the values (``bench.py:134``'s step), RESNET_STEPS steps on one fixed
   batch whose losses must be finite and fall; (b) the eager loop,
   ``loss.backward()``, ``MomentumOptimizer(0.1, 0.9).minimize`` and
   ``clear_gradients``; then one eval forward on the moving statistics.
   Host ms a step, images/s and peak memory for each; no hand-written
   kernel runs on this path (every count stays 0: convolutions and
   pooling are cuDNN's, the fc cuBLAS's, and (b) updates each of the 161
   parameters with its own ``momentum`` op, as the reference does).  Card
   against host at RESNET_HOST (depth 50, 64x64, batch 4, 10 classes,
   float32, one state carried by ``interop.layer_from_numpy``): the
   losses within rtol 1e-4, the first-step gradients as a whole (cosine
   >= 0.99, norms within 2%) and the fc layer's within 1e-3 of their
   largest (the largest error over the largest gradient is printed
   beside: float32 moves the first layers' gradients of a 50-layer
   batch-norm net by about 1e-2 of the largest between two summation
   orders), the moving statistics after one eager step within 1e-4 of
   each buffer's largest, eval logits (initial weights, the step's
   moving statistics) within 1e-4 of the largest; a host twin whose batch
   norm normalizes training by the moving statistics must miss.
4i. train Transformer NMT -- ``models.TransformerModel`` at
   ``bench.py:479 main_nmt``'s full width (vocab 32000, d_model 1024, 16
   heads, 6 + 6 layers, FFN 4096, batch 32 of 64 tokens, dropout 0.1,
   max_len 65, 274,693,376 parameters, bf16 autocast, ids from
   ``RandomState(0)`` as the bench draws them): ``functional_loss`` +
   ``torch.func.grad_and_value`` and the update ``v - 1e-4 g``; the
   first step's bf16 loss within BF16_LOSS_RTOL of a float32 step's; 3
   warm-up and 20 timed steps, the launch counts exactly NMT_LAUNCHES a
   step (per step 18 flash forward and 18 backward, ``pt_dropout`` 66 =
   18 attention-output dropouts + 18 of their backwards + 30 dropout-adds'
   x, 18 masks, 30 dropout-adds, 12 relu act-dropouts forward and 12
   backward); tokens/s with bench.py's 3 x 422,576,128 FLOP a token, ms
   a step, peak memory; one eval forward (18 flash forward launches,
   nothing else).  Card against host at NMT_HOST (vocab 1000, d_model
   128, 4 heads, 2 + 2 layers, FFN 256, source 24 and target 16 tokens,
   batch 4, float32, every parameter drawn from a seed, dropout 0.1 live
   from fixed tracer seeds): losses within rtol 1e-4, eval logits within
   1e-4 of the largest, the whole gradient's cosine at least 0.9999 and
   its norm within 1e-3; a host twin whose decoder drops the causal mask
   must miss.
4j. train MobileNetV2 -- ``vision.models.mobilenet_v2`` at full width
   (scale 1.0, 1000 classes, NCHW, batch 128 of 224x224x3, bf16
   autocast), phase 4h's functional step (SGD momentum 0.9, lr 0.1): one
   warm-up and 3 timed steps (images/s, peak memory; no hand-written
   kernel launches: the depthwise convolutions are PyTorch's library
   kernels),
   one eval forward.  Card against host at 64x64, batch 4, 10 classes,
   float32: the loss within rtol 1e-4, the whole gradient's cosine at
   least 0.99 and norms within 2%, eval logits within 1e-4 of the
   largest; a host twin whose depthwise convolutions read their filters
   transposed must miss.  VGG16 (224², batch 2) and MobileNetV1 (64²,
   batch 4), 1000 classes: eval logits card against host within 1e-4 of
   the largest.
4k. train CTR through BoxPS -- ``bench.py:547 main_ctr`` at its full
   width (26 slots, dim 16, 13 dense features, batch 4096, 3 warm-up and
   20 timed steps, ids from ``RandomState(0)`` over a 2^40 feasign space
   as ``bench.py:617`` draws them): one ``begin_pass`` over all 23
   batches (about 2,449,408 unique ids, a 2^22-row cache of 256 MiB on
   the card, its staging time printed), the program through
   ``CompiledProgram`` with ``fuse_elewise_add_act_ops`` and
   ``constant_folding`` (``ops_per_step`` 42 -> 38, as the reference),
   steps through ``AsyncStepRunner(...).submit(f).lazy(0)``; the loss
   over the leg's batches must fall.  Then the bf16 leg through
   ``BuildStrategy.amp`` (``amp.ops_cast`` AMP_CASTS_REFERENCE, 38 ops;
   its first loss within rtol 0.05, atol 0.05 of an fp32 step's from
   one state).  Host ms a step, examples/s, peak memory and a profiled
   step (busy ms, idle share, classes) of each leg; neither launches a
   hand-written kernel.  ``end_pass``: the host store's rows equal the
   card's trained cache.  The kernel-tier leg (``bench.py:677``):
   ``build_ctr_train_program(slots=26, dim=16)`` with Adam at batch
   256, exactly 26 gather-pool, 26 scatter-add and 1 fused-Adam launches
   a step, losses within BOX_TIER_RTOL of the unrewritten program's; then
   its three kernels on the leg's own ids, tables and Adam bucket against
   their plain versions (forward rtol=atol=1e-6, gradient and Adam
   ``torch.equal``).  Card against host at BOX_HOST (batch 256, 3 steps,
   ids from a 2048-value space so that each repeats about three times a
   batch, one box state): losses within rtol 1e-5, trained rows within
   1e-6 of the largest, a twin feeding ``slots_of(ids) + 1`` must miss,
   and the same model over a dense ``embedding`` holding the cache agrees
   with the box program within rtol 1e-5.  The dataset route: MultiSlot
   files written from a seed (ids from a 4096-value space) into a
   temporary directory, ``InMemoryDataset``, two passes sharing ids
   through ``train_from_dataset`` pass by pass and through
   ``train_passes``: bit for bit.
4l. the 2.0 dygraph loop -- ``models.PtbLm`` at PTB's full width
   (Zaremba, Sutskever and Vinyals' "large" LSTM LM: vocab 10,000, hidden
   1,500, 2 layers, 35 steps, batch 20, dropout 0.65, 66,034,000
   parameters uniform in +-0.04), the users' eager loop on the tape:
   ``loss.backward(); opt.step(); opt.clear_grad()`` through
   ``optimizer.SGD`` over ``PiecewiseDecay`` with
   ``ClipGradByGlobalNorm(10)``; 3 warm-up and 20 timed steps, exactly
   PTB_LAUNCHES a step (3 dropout forwards, their 3 backwards and 3
   masks), ms a step, tokens/s, peak memory, a profiled step (busy ms,
   idle share).  The same under bf16 ``amp.auto_cast`` with
   ``amp.GradScaler`` (the identity: no scale, no finite check), its
   first loss within BF16_LOSS_RTOL of a float32 forward's from one
   state and seeds.  An eval forward (no dropout launch) and its
   perplexity; ``save_dygraph`` / ``load_dygraph`` / ``set_dict`` into a
   fresh model: eval logits bit for bit.  One LSTM layer at the PTB
   width through ``rnn_scan``'s step loop and through cuDNN's fused
   LSTM (the route not taken), timed.  Card against host at PTB_HOST
   (vocab 1000, hidden 128, batch 4, dropout live, 3 steps): losses
   rtol 1e-4, first-step gradients' cosine 0.9999 and norm 1e-3; a host
   twin whose LSTM swaps its input and forget gates must miss.  Then
   dygraph ``WideDeep`` and ``DeepFM`` at DYCTR's width (26 slots of
   1,000,000 ids, dim 16, 13 dense features, batch 4096; the sigmoid
   output's squared error, ``optimizer.Adam`` over a ``LinearWarmup``):
   3 warm-up and 10 timed steps with no hand-written kernel launch,
   examples/s, peak memory, a profiled step; card against host at 26 x
   1000, batch 256, the same bounds, a twin fed ids without their slot
   offsets must miss.
4n. the static training surface -- (a) the BERT recipe of the Paddle
   1.8 era at BERT-base width (32 rows, dropout 0): linear warmup (3
   steps) then linear decay to step 13 from base 1e-4, built with
   ``Switch`` over ``autoincreased_step_counter``, ``L2Decay(0.01)``,
   ``GradientClipByGlobalNorm(1.0)`` and Adam, through fuse_attention
   and fuse_optimizer (two ``conditional_block``, one ``fused_adam``);
   3 + 10 steps, the launches of the timed steps against
   RECIPE_LAUNCHES, the host syncs a step (torch's sync debug mode and
   ``control_flow.host_reads``), each step's rate against the float32
   closed form (1e-7 relative; the Switch's arms swapped must miss), a
   profiled step; card against host at 2 layers and 4 rows over 3
   steps (rtol 1e-4; a swapped-arms host twin must miss).  (b) LAMB on
   it: one ``fused_lamb``, card against host.  (c) 24 bfloat16 FFN
   weights of BERT-base (56,623,104 values) under Adam and Momentum with
   ``multi_precision=True``, 5 steps fused and unfused: every master,
   moment or velocity and bf16 parameter ``torch.equal``; each master
   kernel ``torch.equal`` to its plain version and timed beside its
   bound (28 and 20 bytes a value) and ``torch._fused_adam_`` /
   ``torch._fused_sgd_`` over the fp32 masters.  (d) the 19 optimizer
   classes that append ops on LeNet (3 steps), a ``while_loop`` of 20
   trips of a [64, 768] x [768, 768] product and a normalisation,
   ``cond`` and ``switch_case``, a ``StaticRNN`` over 35 steps and the
   eight schedules (30 runs, rtol 1e-6: the card's pow, exp and cos
   differ from the host's by an ulp), card against host.
4o. the dygraph-to-static tier -- (a) ``BertForPretraining`` at
   ``bench.py:1171``'s width (batch 64 x 128, dropout 0.1, bf16
   ``auto_cast``), its loss under ``paddle.jit.to_static``, trained by
   the 2.0 eager loop (``loss.backward()``, ``optimizer.Adam.step()``,
   ``clear_grad()``), 3 + 10 steps: one ``run_program`` tape entry a
   step, DY_LAUNCHES a step (phase 4e's; fused Adam 0), tokens/s, peak
   memory, a profiled step; card against host in float32 at 4 rows,
   dropout live, 2 steps (losses rtol 1e-4, first-step gradients 1e-3 of
   their group's largest; a seed + 1 masks twin must miss); to_static
   against the eager tape at dropout 0 (1e-5).  (b) a to_static
   function with a tensor ``while`` (20 trips of a [64, 768] x
   [768, 768] product and a normalisation), a tensor ``if`` and a
   ``for`` over a tensor range: card against host (1e-4 of the
   largest; a 19-trip twin must miss), ``dy2static.host_reads`` a call
   as predicted.  (c) ResNet-50 at batch 32 of 224², bf16, 3 to_static
   steps: the moving statistics written back as plain tensors, after
   one step within D2S_BN_RTOL of the eager loop's (the statistics not
   written back must miss).  (d) BERT-base's ``BertModel`` in eval
   (float32, 32 x 128) through ``paddle.jit.save`` and
   ``paddle.jit.load``: the exported graph holds the flash custom op
   once a layer, a call launches the flash forward 12 times, within
   1e-3 of the largest of the eager forward's (rolled ids must miss), a
   profiled call.  (e) the static BERT program at BERT-base width, 32
   rows, dropout 0, under ``amp.decorate(Adam, init_loss_scaling=2**15,
   use_dynamic_loss_scaling=True, decr_ratio=0.5)`` through
   fuse_attention (which no longer matches after the folded casts, as
   in the reference) and fuse_optimizer, 3 + 10 steps: one fused Adam a
   step, a profiled step; an overflowing step (an infinite mask value)
   sets FoundInfinite and zeroes every gradient; card against host at 2
   layers and 4 rows over 4 overflowing and 2 good steps: the (scale,
   good, bad) trajectory equal exactly (a decr_ratio 0.8 twin must
   differ).  (e) runs with the static phases, before 4e.
4p. deployment -- the inference artifacts, in a temporary directory
   the phase removes.  (a) phase 4's served BERT-base program (frozen,
   12 ``fuse_attention`` rewrites) through ``fluid.io.
   save_inference_model`` with a combined params file and a fresh
   ``AnalysisPredictor`` on the card: 12 fused ops in the loaded
   program, 12 flash-forward launches a run at 1, 8 and 32 rows, the
   logits equal to the in-memory program's bit for bit (two layers'
   query weights swapped must miss by 10x 1e-5 of the largest logit);
   then ``set_precision(Bfloat16)``: every weight in bf16, 12 flash
   launches a run, within DEPLOY_BF16_TOL of float32 in relative L2
   (the swapped twin in bf16 must miss it; at these weights bf16 moves
   the logits as far as the twin does, so no 10x margin).  (b) ``save_aot_model``
   of (a)'s predictor at bucket edges (1, 8, 32), ``load_aot_model`` on
   the card: every exported graph holds ``paddle_tpu_torch::
   flash_attention_fwd`` 12 times, a call launches it 12 times, outputs
   within 1e-5 of the largest of (a)'s logits (the swapped twin must
   miss by 10x); ``ServingEngine`` over the artifact answers 48 requests
   of 1 to 32 rows, each equal bit for bit to its rows through the
   bucket program its batch rode in (the twin artifact's answers must
   miss by 10x 1e-5), and each against one artifact call on its rows
   (their own bucket's program) within 1e-5 or reported.  (c) phase 4c's CTR program
   (26 ``fused_embedding_pool`` ops in ``__model__``) through both, 26
   gather-pool launches a run or call at 1, 64 and 512 rows, within
   1e-5 of the largest logit of the in-memory program phase 4c served
   (two slots' tables swapped must miss by 10x).  (d) the reference's
   ``tests/fixtures/ref_fc_model`` (per-var params) on the card against
   the host (a rolled-bias twin must miss), re-exported with
   ``params_filename`` and loaded back bit for bit.  Host ms, busy ms
   and rows/s per batch size; the save's seconds and bytes, the
   artifact's bytes (weights once) and load seconds; latency p50/p99.
4q. speculative decode and the SLO surface -- after 4f, on its model and
   traffic (DECODE width, 48 requests).  (a) ``DecodeEngine(paged=True,
   prefix_cache=True, max_batch=32, draft_model=model, spec_k=4)``, the
   target drafting for itself, and a plain paged engine, both at the one
   decode bucket 32: every token equal to 4f's output, every logit equal
   to the plain engine's bit for bit (a float32 product and the paged
   kernel's split depend on the batch, so only steps of one size agree
   bitwise; against 4f's buckets within 1e-4 of the largest logit), every
   proposal accepted, 4 paged-kernel launches a verify round and 4
   ``fuse_paged_attention`` rewrites in the verify program; one verify
   round profiled at 32 slots.  (b) a half-width draft (d_model 384, seed
   + 1) at 4f's buckets: tokens equal to 4f's, the accept rate printed.
   Card against host: 2 requests through a host speculative engine (16
   tokens, identical tokens, logits 1e-4); a twin reading each verify
   block's logits one position late must miss by 10x.  (c) phase 4's
   BERT-base program under ``ServingEngine(name="chip_slo",
   max_inflight=2)``: 48 requests of 1 to 32 rows equal bit for bit to
   the same batches with ``max_inflight=1``; histogram counts equal the
   requests and batches; one ``serving::batch`` span a batch in the
   exported trace; every request's ``trace_id`` in the flight recorder;
   8 requests with ``deadline_ms=50`` held by ``pause()`` all rejected
   with ``DeadlineExceededError``; ``stats_payload()`` holds the engine
   and the decode block's ``spec_*`` keys; ``prometheus_text()`` parses
   back; a BERT batch's host ms at 1 and 32 rows with the flight
   recorder on and off.  No HTTP server is started.
5. profile -- host and device time of one dispatched batch at 1, 8 and
   32 rows and of one training step at 32 rows, the device's idle share,
   and device time by kernel class; the same for the CTR program at 1,
   64 and 512 rows served and 4096 rows trained, for one dygraph BERT
   step, for a paged decode step at 1, 8 and 32 slots, and for a
   kernel-tier LeNet step at 64 and 512 rows; for the ResNet-50
   step (a), step (b) and the eval forward at 128 rows; for one NMT step
   (with the host ms each forward's causal mask takes to reach the card)
   and one MobileNetV2 step.
6. report  -- one ``{"kernels": [...]}`` line (each kernel's
   ``boxps_launches`` are phase 4k's kernel-tier leg's, its
   ``boxps_legs_launches`` those of 4k's fp32 and bf16 legs, its
   ``ptb_launches`` those of 4l's timed float32 PTB steps, the dropout
   rows' ``ptb`` their times at the PTB shape, ``recipe_launches`` those
   of 4n's timed recipe steps, ``to_static_launches`` those of 4o (a)'s
   timed steps, of one 4o (d) call and of 4o (e)'s timed steps,
   ``deploy_launches`` those of phase 4p's counted runs,
   ``speculative_launches`` those of each of phase 4q's legs, and the
   rows ``fused_adam_master`` and ``fused_momentum_master``, launched by
   4n (c)), then the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import tempfile
import time
import warnings

import numpy as np

SEED = 0
BERT_BASE = dict(vocab=30522, hidden=768, heads=12, seq=128, layers=12,
                 dropout=0.1, with_mask=True)
MAX_BATCH = 32
N_REQUESTS = 16
ROW_CHOICES = (1, 3, 5, 8, 13, 21, 32)
TRAIN = dict(BERT_BASE, dropout=0.0, lr=1e-3, train=True)
TRAIN_ROWS = 32
TRAIN_STEPS = 10
HOST_ROWS = 4          # the card-vs-host training check's batch
# the wide&deep CTR program at the width of the repo's CTR bench
# (bench.py main_ctr: 26 slots, dim 16, batch 4096, 5 ids per slot, as
# DLRM's Criteo-Kaggle setting) with 1,000,000 rows per slot's table
CTR = dict(slots=26, vocab=1_000_000, dim=16, seq=5)
CTR_MAX_BATCH = 512
CTR_ROW_CHOICES = (1, 16, 64, 100, 256, 500)   # a page's ad candidates
CTR_TRAIN = dict(CTR, train=True, optimizer="momentum", lr=0.05)
CTR_TRAIN_ROWS = 4096
CTR_HOST_VOCAB = 100_000   # the card-vs-host training check's one cut
ZIPF_A = 1.1
# the flagship dygraph step at bench.py:1171's full width (nothing cut):
# BertForPretraining with its dropout 0.1 defaults, batch 64 of seq 128,
# Adam lr 1e-4, bf16 autocast
DY = dict(vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12,
          intermediate_size=3072, max_position=128)
DY_BATCH, DY_SEQ, DY_LR, DY_STEPS = 64, 128, 1e-4, 10
DY_HOST_ROWS = 4       # the card-vs-host check's batch
DROPOUT_ROWS = DY_BATCH * DY_SEQ
# kernel launches per dygraph step, predicted from the model's structure
DY_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
               "fused_dropout": 50, "dropout_mask": 13,
               "fused_dropout_add": 24, "fused_act_dropout": 12,
               "fused_act_dropout_bwd": 12}
# the decode path: the repo's one decode model family (the demo
# single-layer attention LM of serving/decode.py) at the widths of the
# BERT-base model the other phases run: vocab 30522, d_model 768 (one
# head), BERT's 512 positions as max_len, pages of 16 rows
DECODE = dict(vocab=30522, d_model=768, max_len=512, page_size=16)
DECODE_MAX_BATCH = 32      # the engine's default pool: 32 x 32 + 1 pages
DECODE_REQUESTS = 48
DECODE_SHARED = 0.6        # share of requests with an 8-page shared prefix
DECODE_QK_GAIN = 250.0     # Q and K weights' scale over the initializers'
DECODE_HOST_NEW = 16       # the card-vs-host check's tokens per request
DECODE_HOST_POOL = 65      # its host engine's pool (2 slots x 32 pages + 1)
DECODE_PROFILE_POS = 300   # valid positions per slot in the step profile
# phase 3f: the paged-attention kernel at the decode path's shapes
PAGED = dict(slots=(1, 8, 32), seq=512, rows=16_400, d=768, page_size=16)
# phase 4g: the static book tier (tests/test_static_e2e.py), MNIST LeNet
# at the repo's width (tests/test_static_e2e.py:38) on the reference
# tests' seeded synthetic digits, Adam 1e-3
LENET_BATCH, LENET_STEPS = 64, 40
LENET_RAGGED = 50          # the ragged batch, bucketed to 64
LENET_PROFILE_ROWS = (64, 512)
# LeNet's eight parameters: conv 6@3x3 and 16@5x5, fc 400x120 and 120x10,
# weights and biases
LENET_SEGMENTS = (54, 6, 2400, 16, 48000, 120, 1200, 10)
CLIP_STEPS = 50            # the Momentum-with-clipping case's steps
# phase 4h: bench.py:449 main_resnet's ResNet-50 step (BASELINE.md config
# 2) at its full width, nothing cut: 1000 classes, NHWC, batch 128 of
# 224x224x3 synthetic images, bf16 autocast, SGD with momentum 0.9 at
# lr 0.1; the card-vs-host check at a reduced size (RESNET_HOST)
RESNET = dict(num_classes=1000, data_format="NHWC")
RESNET_BATCH, RESNET_SIZE, RESNET_LR, RESNET_MU = 128, 224, 0.1, 0.9
RESNET_STEPS = 10          # functional steps on one fixed batch
RESNET_TAPE_STEPS = 3      # eager steps (loss.backward() + minimize)
RESNET_HOST = dict(depth=50, num_classes=10, size=64, batch=4)
# phase 4i: bench.py:479 main_nmt's Transformer NMT step (BASELINE.md
# config 4) at its full width, nothing cut: vocab 32000, d_model 1024, 16
# heads of 64, 6 + 6 layers, FFN 4096, batch 32 of 64 tokens, dropout 0.1,
# max_len 65, bf16 autocast, the update v - 1e-4 g, 3 warm-up and 20
# timed steps; the card-vs-host check at NMT_HOST (source 24 and target
# 16 tokens: Tq != Tk in the cross-attention), float32, dropout live
NMT = dict(src_vocab=32000, tgt_vocab=32000, d_model=1024, nhead=16,
           num_encoder_layers=6, num_decoder_layers=6, dim_feedforward=4096,
           dropout=0.1, max_len=65)
NMT_BATCH, NMT_SEQ, NMT_LR, NMT_WARMUP, NMT_STEPS = 32, 64, 1e-4, 3, 20
NMT_ROWS = NMT_BATCH * NMT_SEQ
# kernel launches per NMT training step, from the model's structure: 18
# attentions (6 encoder self-attentions, 6 decoder self-attentions under
# the causal bias, 6 cross-attentions), each one flash forward and one
# backward, and one dropout (mask and all) on its output; 30 residual
# dropout-adds (2 an encoder layer, 3 a decoder layer), whose backward
# runs ``pt_dropout`` for x; 12 relu FFNs, act-dropout and its backward;
# so ``pt_dropout`` 18 forward + 18 + 30 backward.  No embedding dropout.
NMT_LAUNCHES = {"flash_attention_fwd": 18, "flash_attention_bwd": 18,
                "fused_dropout": 66, "dropout_mask": 18,
                "fused_dropout_add": 30, "fused_act_dropout": 12,
                "fused_act_dropout_bwd": 12}
NMT_HOST = dict(NMT, src_vocab=1000, tgt_vocab=1000, d_model=128, nhead=4,
                num_encoder_layers=2, num_decoder_layers=2,
                dim_feedforward=256, max_len=25)
NMT_HOST_BATCH, NMT_HOST_SRC, NMT_HOST_TGT = 4, 24, 16
# phase 3's NMT attention cases: (label, Tq, Tk, bias) at [32,16,T,64]
NMT_FLASH_CASES = (("decoder causal bias", 64, 64, "causal"),
                   ("encoder", 64, 64, None),
                   ("cross Tq=64 Tk=96", 64, 96, None))
# phase 4j: MobileNetV2 at the model zoo's full width (scale 1.0, 1000
# classes), NCHW as the reference builds it, batch 128 of 224x224x3, bf16
# autocast, trained as phase 4h trains ResNet-50 (the functional step,
# SGD momentum 0.9 at lr 0.1), 3 timed steps; the card-vs-host checks at
# MOBILENET_HOST (float32), and VGG16 and MobileNetV1 eval logits
MOBILENET = dict(scale=1.0, num_classes=1000)
MOBILENET_BATCH, MOBILENET_SIZE, MOBILENET_STEPS = 128, 224, 3
MOBILENET_HOST = dict(num_classes=10, size=64, batch=4)
EVAL_HOST = (("vgg16", 224, 2), ("mobilenet_v1", 64, 4))
# phase 4k: bench.py:547 main_ctr at its full width (:564), nothing cut
BOX = dict(slots=26, dim=16, batch=4096, steps=20, warmup=3)
BOX_ID_SPACE = 2 ** 40         # bench.py:617's feasign draws
AMP_CASTS_REFERENCE = 32       # the reference's amp.ops_cast on this program
# the card-vs-host check's one cut; its ids, and the dataset route's, come
# from a small feasign space so that ids repeat many times a batch and the
# cache gradient sums them
BOX_HOST = dict(batch=256, steps=3, ids=2048)
BOX_TIER_BATCH, BOX_TIER_WARMUP, BOX_TIER_STEPS = 256, 2, 10  # bench.py:677
BOX_TIER_RTOL = 1e-4           # kernel tier against the unrewritten losses
BOX_DATASET = dict(passes=2, records=512, batch=256, ids=4096)
# phase 4l: the PTB LSTM language model at the "large" width of Zaremba,
# Sutskever and Vinyals 2014 (arXiv:1409.2329, section 4; Paddle's
# ptb_lm "large" config), nothing cut: vocab 10,000, hidden 1,500, 2
# layers, 35 steps unrolled, batch 20, dropout 0.65 (the dygraph
# Dropout's downgrade_in_infer), weights uniform in +-0.04, SGD at lr 1.0
# (decayed by 1/1.15 after a boundary) with the gradients clipped to a
# global norm of 10
PTB = dict(vocab_size=10000, hidden_size=1500, num_layers=2, dropout=0.65)
PTB_PARAMS = 66_034_000
PTB_BATCH, PTB_T, PTB_INIT, PTB_CLIP = 20, 35, 0.04, 10.0
PTB_LR_BOUNDS, PTB_LR_VALUES = [12], [1.0, 1.0 / 1.15]
PTB_WARMUP, PTB_STEPS = 3, 20
# per step: three dropouts (on the embedding, between the layers, before
# the output), each one pt_dropout forward, one pt_dropout backward (the
# op's own gradient: the tape reruns no dropout) and one mask
PTB_LAUNCHES = {"fused_dropout": 6, "dropout_mask": 3}
PTB_HOST = dict(PTB, vocab_size=1000, hidden_size=128)
# the card-vs-host check's weights are uniform in +-0.3: at +-0.04 every
# gate sits near sigmoid(0) and an LSTM with two gates swapped computes
# nearly the same loss
PTB_HOST_BATCH, PTB_HOST_STEPS, PTB_HOST_INIT = 4, 3, 0.3
# phase 4l's dygraph CTR models (models/ctr.py) at the CTR cells' width,
# DLRM's Criteo-Kaggle one: 26 slots of 1,000,000 ids, dim 16, 13 dense
# features, the reference's default towers, batch 4096 (bench.py:547
# main_ctr's), Adam 1e-3 over a 5-step LinearWarmup
DYCTR = dict(num_slots=26, vocab_per_slot=1_000_000, embed_dim=16,
             dense_dim=13)
DYCTR_HIDDEN = {"WideDeep": (400, 400, 400), "DeepFM": (400, 400)}
DYCTR_BATCH, DYCTR_WARMUP, DYCTR_STEPS = 4096, 3, 10
DYCTR_LR, DYCTR_WARMUP_STEPS = 1e-3, 5
DYCTR_HOST = dict(DYCTR, vocab_per_slot=1000)
DYCTR_HOST_BATCH, DYCTR_HOST_STEPS = 256, 3
# phase 4m: the 2.0 API surface on the card.  (a) and (b): MNIST LeNet
# as tests/test_static_e2e.py:38 builds it, as a Layer, through
# Model.fit's static and dygraph adapters: 2 epochs of 1,024 synthetic
# digits at batch 64, Adam 1e-3, both from one set of weights; the
# dygraph trajectory within HAPI_LENET_RTOL of the static one a batch
HAPI_LENET_IMAGES, HAPI_LENET_BATCH, HAPI_LENET_EPOCHS = 1024, 64, 2
HAPI_LENET_RTOL = 1e-3
# (c) NMT at NMT's full width (config 4, nothing cut, dropout 0.1, bf16
# amp_level O1, paddle.optimizer.Adam 1e-4) through Model.fit's dygraph
# adapter on the tape: HAPI_NMT_WARMUP steps, then HAPI_NMT_STEPS timed
HAPI_NMT_WARMUP, HAPI_NMT_STEPS, HAPI_NMT_LR = 3, 20, 1e-4
# launches per Model.fit step, from the code: on the tape each op's
# backward is generic_grad, a vjp that reruns the op's forward unless the
# op has a custom_grad.  fused_multihead_attention has none: its flash
# forward launches twice (the eager forward and the vjp's rerun) and its
# backward once, for each of the 18 attentions.  The dropout op on each
# attention output has one: pt_dropout forward and mask, then
# pt_dropout on the cotangent.  The 30 dropout-adds and 12 act-dropouts
# have none: their forward kernel launches twice, and their backward
# runs pt_dropout (dx of a dropout-add) or pt_act_dropout_bwd
HAPI_NMT_LAUNCHES = {"flash_attention_fwd": 36, "flash_attention_bwd": 18,
                     "fused_dropout": 66, "dropout_mask": 18,
                     "fused_dropout_add": 60, "fused_act_dropout": 24,
                     "fused_act_dropout_bwd": 12}
# the card-vs-path check: the first train_batch (dropout 0, bf16 O1)
# against phase 4i's functional step from the same weights and batch
HAPI_NMT_LOSS_RTOL, HAPI_NMT_COSINE = 1e-4, 0.9999
# (d) paddle.grad's gradient penalty over a small MLP
HAPI_GP = dict(rows=64, d_in=32, hidden=64, seed=61)
HAPI_GP_RTOL = 1e-5
DEPLOY_BERT_ROWS = (1, 8, 32)      # 4p: the BERT runs and bucket edges
DEPLOY_CTR_ROWS = (1, 64, 512)     # 4p: the CTR runs and bucket edges
DEPLOY_REQUESTS = 48               # 4p: requests to the engine over (b)
DEPLOY_TOL = 1e-5                  # 4p: of the largest logit
DECODE_SPEC_K = 4                  # 4q: verify blocks a round
DECODE_DRAFT = dict(DECODE, d_model=384)   # 4q (b): the half-width draft
DECODE_DRAFT_REQUESTS = DECODE_REQUESTS    # 4q (b): of 4f's traffic
SLO_REQUESTS = 48                  # 4q (c): requests of ROW_CHOICES rows
SLO_PAUSED = 8                     # 4q (c): requests held past a deadline
SLO_DEADLINE_MS = 50.0
SLO_RECORDER_ITERS = 20            # 4q (c): runs a flight-recorder block
# 4p: bf16 against float32, relative L2 (the first chip run: 0.0739
# unpadded, 0.1939 padded, where bf16 also loses the padding mask)
DEPLOY_BF16_TOL = {"full-length": 0.1, "padded": 0.25}
ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"        # where phase 3 makes its inputs
# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
TF32_FLOPS_PER_S = 495e12


def _p(*args):
    print(*args, flush=True)


def _ms(fn, iters, warmup=3):
    """Mean device time of ``fn`` in ms, by CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# the flash wrappers' copies of inputs the kernels' 16-byte cp.async
# cannot read, per main path (0 expected: every path's q, k, v views are
# 16-byte aligned)
FLASH_COPIES = {}


def _flash_copies_zero():
    from paddle_tpu_torch.ops import cuda_kernels
    for fn in (cuda_kernels.flash_attention_fwd,
               cuda_kernels.flash_attention_bwd):
        fn.copies = 0


def _flash_copies_check(path):
    """Record and print the flash wrappers' copy counts of ``path``'s
    run; fail the run if any input was copied."""
    from paddle_tpu_torch.ops import cuda_kernels
    copies = {fn.__name__: fn.copies
              for fn in (cuda_kernels.flash_attention_fwd,
                         cuda_kernels.flash_attention_bwd)}
    FLASH_COPIES[path] = copies
    _p(f"{path}: flash input copies for 16-byte alignment {copies} "
       f"(0 expected)")
    if any(copies.values()):
        raise SystemExit(f"chip_smoke: the {path} path handed the flash "
                         f"kernels a view that had to be copied")


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this "
                         "script measures the card and has no host mode")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    _p(f"device: {kind}  count={count}")
    _p(card)
    return kind, count, card


def phase_build():
    from paddle_tpu_torch.ops import cuda_kernels
    t0 = time.perf_counter()
    built = cuda_kernels.build()
    _p(f"build: {len(built)} source(s) in "
       f"{time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)")
    for stem, info in built.items():
        _p(f"  {stem}: {info['seconds']:.1f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "smem", "spill",
                                       "Compiling entry")):
                _p(f"    {line.strip()}")


def _attention_inputs(b, h, t, d, dtype, seed, masked=True,
                      program_bias=False):
    """q, k, v as permuted [B,H,T,D] views of [B,T,H,D] tensors (what
    transpose2 hands the fused op) and a [B,1,1,T] padding bias:
    (m - 1) * 10000, or with ``program_bias`` (m - 10000) * 10000, the
    bias the static BERT program builds (``scale`` with its bias before
    the scale), about -1e8, where float32 keeps only multiples of 8."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    qkv = [torch.randn(b, t, h, d, generator=g, device=DEVICE)
           .to(dtype).permute(0, 2, 1, 3) for _ in range(3)]
    mask = None
    if masked:
        lengths = torch.randint(1, t + 1, (b,), generator=g, device=DEVICE)
        m = (torch.arange(t, device=DEVICE)[None, :]
             < lengths[:, None]).float()
        shift = 10000.0 if program_bias else 1.0
        mask = ((m - shift) * 10000.0).reshape(b, 1, 1, t)
    return qkv, mask


def _ops_ms(flops, dtype):
    """Least ms for ``flops`` products of ``dtype`` on this card.  float32
    takes the faster of the card's two routes at about float32 accuracy:
    FMAs outside the tensor cores (67 TFLOP/s) and the 3xTF32 split, three
    TF32 products per product on the tensor cores (495 TFLOP/s); so
    float32 counts ``min(flops / 67e12, 3 · flops / 495e12)``.  The flash
    kernels take the FMA route (``csrc/flash_common.cuh`` says why), so
    their float32 bound lies below what their own route allows."""
    dtype = str(dtype).removeprefix("torch.")
    t = flops / FLOPS_PER_S[dtype]
    if dtype == "float32":
        t = min(t, 3 * flops / TF32_FLOPS_PER_S)
    return t * 1e3


def _flash_bound(q, k, v, mask):
    """Least time for the function on this card: the larger of its bytes
    (q, k, v, bias read once, o written once) over HBM bandwidth and its
    operations (4·B·H·Tq·Tk·D) over the peak rate for its type
    (``_ops_ms``: float32 at the 3xTF32 rate)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) \
        * q.element_size() + (mask.numel() * 4 if mask is not None else 0)
    flops = 4.0 * b * h * tq * tk * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = _ops_ms(flops, q.dtype)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def _flash_cases(b, t, d, forward):
    """(label, dtype, B, T, D, causal, masked, timed) of the flash phases:
    the main paths' [B,12,T,D] in both dtypes (timed), the served batch
    of 1 (timed), causal, ragged T at the head dims 32, 40 (not a
    multiple of bf16's mma depth 16) and 128, and the static BERT
    program's bias in both dtypes."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("fp32", f32, b, t, d, False, True, True),
             ("bf16", bf16, b, t, d, False, True, True),
             ("B=1 fp32", f32, 1, t, d, False, True, True),
             ("B=1 bf16", bf16, 1, t, d, False, True, True),
             ("fp32 causal", f32, b, t, d, True, False, False)]
    if forward:
        cases.append(("bf16 causal", bf16, b, t, d, True, True, False))
    cases += [("fp32 ragged T=100", f32, b, 100, d, False, True, False),
              ("fp32 ragged T=100 D=32", f32, b, 100, 32, False, True,
               False),
              ("bf16 ragged T=100 D=32", bf16, b, 100, 32, False, True,
               False),
              ("fp32 ragged T=100 D=128", f32, b, 100, 128, False, True,
               False),
              ("bf16 ragged T=100 D=128", bf16, b, 100, 128, False, True,
               False),
              ("fp32 D=40", f32, b, t, 40, False, True, False),
              ("bf16 D=40", bf16, b, t, 40, False, True, False),
              ("fp32 program bias", f32, b, t, d, False, "program", False),
              ("bf16 program bias", bf16, b, t, d, False, "program", False)]
    return cases


def phase_kernels():
    """Flash attention forward against its plain version; returns its
    rows by case (the kernels line takes float32, the dtype of both
    programs, with bfloat16 and the served batch of 1 beside it).  Times
    are device ms from the profiler."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.ops.attention import _reference_attention, \
        _reference_stats

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash = cuda_kernels.flash_attention_fwd
    b, h, t, d = MAX_BATCH, BERT_BASE["heads"], BERT_BASE["seq"], \
        BERT_BASE["hidden"] // BERT_BASE["heads"]
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 0.0)}
    rows = {}
    for label, dtype, bb, tt, dd, causal, masked, timed in _flash_cases(
            b, t, d, forward=True):
        scale = dd ** -0.5
        (q, k, v), mask = _attention_inputs(bb, h, tt, dd, dtype, SEED,
                                            bool(masked),
                                            masked == "program")
        out = flash(q, k, v, mask, scale, causal)
        ref = _reference_attention(q, k, v, mask, scale, causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        atol, rtol = tol[dtype]
        ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
        _p(f"flash_attention_fwd {label} [{bb},{h},{tt},{dd}]: max |err| "
           f"vs plain = {err:.3e} (atol={atol}, rtol={rtol})")
        if not ok or not np.isfinite(err):
            raise SystemExit(f"chip_smoke: flash_attention_fwd {label} "
                             f"disagrees with its plain version")
        # the softmax statistics the backward reads (training path only)
        _, m, l = flash(q, k, v, mask, scale, causal, return_stats=True)
        for name, got, want in zip(("row max", "row sum"), (m, l),
                                   _reference_stats(q, k, mask, scale,
                                                    causal)):
            s_err = (got - want).abs().max().item()
            _p(f"  {name}: max |err| = {s_err:.3e} (atol=rtol=1e-4)")
            if not torch.allclose(got, want, atol=1e-4, rtol=1e-4):
                raise SystemExit(f"chip_smoke: flash_attention_fwd {label} "
                                 f"{name} disagrees with its plain version")
        if not timed:
            continue
        lib_mask = mask.to(dtype) if mask is not None else None
        # device ms from the profiler: at a few tens of us, back-to-back
        # CUDA events would time the ctypes wrapper's host work instead
        ms = _profile(lambda: flash(q, k, v, mask, scale, causal), 50)[1]
        plain_ms = _profile(lambda: _reference_attention(
            q, k, v, mask, scale, causal), 10)[1]
        library_ms = _profile(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask, scale=scale), 50)[1]
        bound_ms, bound_by = _flash_bound(q, k, v, mask)
        rows[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": library_ms}
        _p(f"  kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
           f"library (scaled_dot_product_attention) {library_ms:.4f} ms | "
           f"bound {bound_ms * 1e3:.2f} us ({bound_by})")
    return rows


def _flash_bwd_bound(q, k, mask):
    """Least time for dQ, dK, dV on this card: the larger of the bytes
    (q, k, v, o, dO and the row statistics read once, dq, dk, dv written
    once, the bias read once) over HBM bandwidth and the five products
    (QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q, dS·K: 5 · 2·B·H·Tq·Tk·D) over the peak
    rate for the type (``_ops_ms``: float32 at the 3xTF32 rate, three
    TF32 products per product, when that is the faster route)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    nbytes = 4 * (q.numel() + k.numel()) * q.element_size() \
        + 2 * b * h * tq * 4 + (mask.numel() * 4 if mask is not None else 0)
    flops = 5 * 2.0 * b * h * tq * tk * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = _ops_ms(flops, q.dtype)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def phase_kernels_bwd():
    """The flash-attention backward kernel against
    ``_reference_attention_bwd`` on the same o and statistics (those of
    the forward kernel); returns its rows by case.  The library call is
    the backward of ``scaled_dot_product_attention`` on the same inputs
    (autograd of one forward; its backward kernels' device time).  Every
    time is device ms from the profiler."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.ops.attention import _reference_attention_bwd

    fwd, bwd = cuda_kernels.flash_attention_fwd, \
        cuda_kernels.flash_attention_bwd
    b, h, t, d = MAX_BATCH, BERT_BASE["heads"], BERT_BASE["seq"], \
        BERT_BASE["hidden"] // BERT_BASE["heads"]
    # float32: FMA chains against cuBLAS sums; bfloat16: one rounding of
    # each output
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
    rows = {}
    for label, dtype, bb, tt, dd, causal, masked, timed in _flash_cases(
            b, t, d, forward=False):
        scale = dd ** -0.5
        (q, k, v), mask = _attention_inputs(bb, h, tt, dd, dtype, SEED,
                                            bool(masked),
                                            masked == "program")
        (do, _, _), _ = _attention_inputs(bb, h, tt, dd, dtype, SEED + 1,
                                          masked=False)
        o, m, l = fwd(q, k, v, mask, scale, causal, return_stats=True)
        got = bwd(q, k, v, mask, scale, causal, o, m, l, do)
        want = _reference_attention_bwd(q, k, v, mask, scale, o, m, l, do,
                                        causal)
        torch.cuda.synchronize()
        atol, rtol = tol[dtype]
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        ok = all(torch.allclose(g.float(), w.float(), atol=atol, rtol=rtol)
                 for g, w in zip(got, want))
        _p(f"flash_attention_bwd {label} [{bb},{h},{tt},{dd}]: max |err| of "
           f"dq, dk, dv vs plain = {err:.3e} (atol={atol}, rtol={rtol})")
        if not ok or not np.isfinite(err):
            raise SystemExit(f"chip_smoke: flash_attention_bwd {label} "
                             f"disagrees with its plain version")
        if not timed:
            continue
        ms = _profile(lambda: bwd(q, k, v, mask, scale, causal, o, m, l,
                                  do), 50)[1]
        plain_ms = _profile(lambda: _reference_attention_bwd(
            q, k, v, mask, scale, o, m, l, do, causal), 10)[1]
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(
                *leaves, attn_mask=mask.to(dtype) if mask is not None
                else None, scale=scale)
        # the device time of SDPA's backward kernels alone (the forward
        # ran once, above)
        library_ms = _profile(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), 50)[1]
        bound_ms, bound_by = _flash_bwd_bound(q, k, mask)
        split = _flash_bwd_split(lambda: bwd(q, k, v, mask, scale, causal,
                                             o, m, l, do), 50)
        rows[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": library_ms, "split_ms": split}
        _p(f"  kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | library "
           f"(scaled_dot_product_attention backward) {library_ms:.4f} ms | "
           f"bound {bound_ms * 1e3:.2f} us ({bound_by})")
        _p("  kernel by launch: " + " | ".join(
            f"{n} {t:.4f} ms" for n, t in split.items()))
    return rows


def _bert_param_shapes():
    """The shapes of the BERT program's 99 parameters: the embedding,
    per layer the query, key, value and relu fc (weight, bias), the
    classifier fc."""
    v, hd = BERT_BASE["vocab"], BERT_BASE["hidden"]
    per_layer = [(hd, hd), (hd,)] * 4
    return [(v, hd)] + per_layer * BERT_BASE["layers"] + [(hd, 2), (2,)]


def phase_kernels_adam():
    """``fused_adam`` over the BERT-base bucket: the op lowering (one
    multi-tensor kernel call over the 99 parameters where they lie, its
    outputs handed out as views) against the per-param ``adam``
    lowering, ``torch.equal`` on every output, over two steps, the
    second fed the first's outputs; returns its row.  Device ms per call
    from the profiler for the kernel, its plain version
    (``_plain_fused_adam`` on the card: flatten, broadcast lr_t, the
    formula, unflatten) and the library call, ``torch._fused_adam_`` over
    the same 99 tensors: it computes ``p - lr/bc1 · m'/(sqrt(v')/sqrt(bc2)
    + eps')``, with ``bc = 1 - beta^t``, which with ``eps' =
    eps/sqrt(bc2)`` is this update, ``p - lr·sqrt(bc2)/bc1 ·
    m'/(sqrt(v') + eps)``, up to rounding.  The op's wall ms per call
    by CUDA events beside the kernel's."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.ops.optimizer_ops import _plain_fused_adam
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    dev = torch.device(DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    shapes = _bert_param_shapes()
    n = sum(math.prod(s) for s in shapes)

    def draw(shape, std):
        return std * torch.randn(shape, generator=g, device=dev)

    ins = {"Param": [draw(s, 0.05) for s in shapes],
           "Grad": [draw(s, 1e-3) for s in shapes],
           "Moment1": [draw(s, 1e-4) for s in shapes],
           "Moment2": [draw(s, 1e-4).square() for s in shapes],
           "Beta1Pow": [torch.full((1,), 0.9 ** 3, device=dev)
                        for _ in shapes],
           "Beta2Pow": [torch.full((1,), 0.999 ** 3, device=dev)
                        for _ in shapes],
           "LearningRate": [torch.full((1,), TRAIN["lr"], device=dev)]}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    ctx = LoweringContext(dev)
    fused_op = get_op("fused_adam").fn
    state = {"ParamOut": "Param", "Moment1Out": "Moment1",
             "Moment2Out": "Moment2", "Beta1PowOut": "Beta1Pow",
             "Beta2PowOut": "Beta2Pow"}
    step_ins, err = ins, 0.0
    for step in range(2):
        before = cuda_kernels.fused_adam.launches
        fused = fused_op(step_ins, attrs, ctx)
        if cuda_kernels.fused_adam.launches != before + 1:
            raise SystemExit("chip_smoke: the fused_adam op did not launch "
                             "its kernel once on the BERT-base bucket")
        equal = True
        for i in range(len(shapes)):
            one = get_op("adam").fn(
                {s: [v[0] if s == "LearningRate" else v[i]]
                 for s, v in step_ins.items()}, attrs, ctx)
            for slot, outs in one.items():
                equal &= torch.equal(fused[slot][i], outs[0])
                err = max(err, (fused[slot][i] - outs[0]).abs().max().item())
        _p(f"fused_adam BERT-base bucket ({len(shapes)} params, {n} values)"
           f", step {step + 1}: torch.equal to the per-param adam on all "
           f"five outputs = {equal} (max |err| {err:.3e}; tolerance: "
           f"bit-identical)")
        if not equal:
            raise SystemExit("chip_smoke: fused_adam is not bit-identical "
                             "to the per-param adam lowering")
        if step == 0:
            first = fused
            step_ins = dict(ins, **{s: fused[o] for o, s in state.items()})
    del step_ins, fused

    def kernel():
        return cuda_kernels.fused_adam(
            ins["Param"], ins["Grad"], ins["Moment1"], ins["Moment2"],
            ins["LearningRate"][0], ins["Beta1Pow"], ins["Beta2Pow"], b1, b2,
            eps)

    def plain():
        return _plain_fused_adam(
            ins["Param"], ins["Grad"], ins["Moment1"], ins["Moment2"],
            ins["LearningRate"][0], ins["Beta1Pow"], ins["Beta2Pow"], b1, b2,
            eps)

    ms = _profile(kernel, 20)[1]
    plain_ms = _profile(plain, 10)[1]
    op_ms = _ms(lambda: fused_op(ins, attrs, ctx), 10)
    kernel_call_ms = _ms(kernel, 10)

    # the library: torch's fused Adam over the same 99 tensors, in place
    lib = [[x.clone() for x in ins[s]]
           for s in ("Param", "Grad", "Moment1", "Moment2")]
    step = 3                                  # Beta1Pow = beta1 ** 3
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    steps = [torch.full((), float(step), device=dev) for _ in shapes]

    def library():
        torch._fused_adam_(*lib, [], steps, lr=TRAIN["lr"], beta1=b1,
                           beta2=b2, weight_decay=0.0,
                           eps=eps / math.sqrt(bc2), amsgrad=False,
                           maximize=False)

    # the same function to float32 precision: torch rounds the betas to
    # float32 on the card, so its (1 - beta2) is off by 1.3e-5 relative,
    # and where sqrt(v') is near eps the update carries that error; the
    # parameters are compared by their updates, within a few float32
    # roundings of the parameters themselves
    library()
    lib_err = 0.0
    for got, slot in zip((lib[0], lib[2], lib[3]),
                         ("ParamOut", "Moment1Out", "Moment2Out")):
        for a, want, old in zip(got, first[slot], ins["Param"]):
            lib_err = max(lib_err, (a - want).abs().max().item())
            atol = 1e-6 * want.abs().max().item()
            if slot == "ParamOut":
                a, want = a - old, want - old
            if not torch.allclose(a, want, rtol=1e-4, atol=atol):
                raise SystemExit(f"chip_smoke: torch._fused_adam_ does not "
                                 f"compute fused_adam's {slot}")
    del first
    library_ms = _profile(library, 10)[1]
    del lib
    torch.cuda.empty_cache()
    # p, g, m, v read once, p', m', v' written once: 28 bytes a value
    nbytes = 7 * 4 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 12.0 * n / FLOPS_PER_S["float32"] * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"
    _p(f"  device per call: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
       f"library (torch._fused_adam_, eps/sqrt(bc2), max |diff| from the "
       f"op {lib_err:.3e}, rtol=1e-4) {library_ms:.4f} ms | bound "
       f"{bound_ms:.4f} ms ({bound_by}, 28 bytes a value); wall per call: "
       f"op lowering {op_ms:.4f} ms | kernel wrapper {kernel_call_ms:.4f} "
       f"ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "op_ms": op_ms,
            "call_ms": kernel_call_ms, "values": n}


# ---------------------------------------------------------------------------
# the CTR path's kernels (phase 3)
# ---------------------------------------------------------------------------

def _zipf_ids(rng, shape, vocab, perm):
    """Zipf(1.1) ids through a seeded permutation of the vocab: a few hot
    ids, a long tail, and the hot ids scattered over the table."""
    return perm[(rng.zipf(ZIPF_A, shape) - 1) % vocab].astype(np.int64)


def _emb_inputs(d, case, dyadic=False):
    """w [V, d], ids [B, S] int64, wgt [B, S] and g [B, d] on DEVICE for
    one case at the training path's shapes: ``uniform`` ids, ``zipf``
    ids, or ``length_avg``: uniform ids, a third of the rows with the
    padding id 7 at position 2, and a Length-masked AVERAGE weight.  The
    first two have no weight (None), as the path's unmasked SUM slots.
    With ``dyadic``, w and g are small multiples of 1/8 and the weights
    0 or 1/4, so every sum is exact."""
    import torch
    b, s, v = CTR_TRAIN_ROWS, CTR["seq"], CTR["vocab"]
    rng = np.random.default_rng(SEED + d)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + d)
    if dyadic:
        w = torch.randint(-64, 64, (v, d), generator=gen,
                          device=DEVICE).float() / 8
        g = torch.randint(-64, 64, (b, d), generator=gen,
                          device=DEVICE).float() / 8
    else:
        w = torch.randn((v, d), generator=gen, device=DEVICE)
        g = torch.randn((b, d), generator=gen, device=DEVICE)
    if case == "zipf":
        ids = _zipf_ids(rng, (b, s), v, rng.permutation(v))
    else:
        ids = rng.integers(0, v, (b, s))
    wgt = None
    if case == "length_avg":
        ids[rng.random(b) < 1 / 3, 2] = 7
        length = rng.integers(0, s + 1, b)
        keep = (np.arange(s)[None, :] < length[:, None]) & (ids != 7)
        denom = 4.0 if dyadic else np.maximum(length, 1)[:, None]
        wgt = torch.from_numpy((keep / denom).astype(np.float32)).to(DEVICE)
    return w, torch.from_numpy(ids).to(DEVICE), wgt, g


def _emb_bounds(ids, wgt, d, vocab):
    """Least times of the two embedding kernels on this card, each the
    larger of its bytes over HBM bandwidth and its 2·B·S·D operations
    over the float32 peak.  Forward: ids and weights (where there are
    any) read once, each distinct table row this batch names read once,
    the output written once.  Gradient: ids, weights and g read once,
    the dense dW written once."""
    import torch
    n, b = ids.numel(), ids.shape[0]
    rows = torch.unique(ids).numel()
    per_id = 8 + (0 if wgt is None else 4)
    t_ops = 2.0 * n * d / FLOPS_PER_S["float32"] * 1e3
    out = []
    for nbytes in (n * per_id + rows * d * 4 + b * d * 4,
                   n * per_id + b * d * 4 + vocab * d * 4):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out.append((max(t_bytes, t_ops),
                    "bytes" if t_bytes >= t_ops else "operations"))
    return out


# the gather-pool forward's batches: the training step's, the serve
# batch's and one row
EMB_FWD_ROWS = (CTR_TRAIN_ROWS, CTR_MAX_BATCH, 1)


def _emb_fwd_by_rows(w, ids, flush):
    """Device ms per call of the gather-pool forward over the first b rows
    of ``ids`` (no weight, as the path's unmasked SUM slots) for b in
    EMB_FWD_ROWS: its profiler class cold (``flush`` before each call)
    and warm, beside its bound."""
    from paddle_tpu_torch.ops import cuda_kernels

    label = "embedding_pool_fwd (csrc)"
    v, d = w.shape
    out = {}
    for b in EMB_FWD_ROWS:
        sub = ids[:b].contiguous()

        def call(sub=sub):
            return cuda_kernels.embedding_pool_fwd(w, sub, None)

        bound, by = _emb_bounds(sub, None, d, v)[0]
        out[b] = {"cold_ms": _cold_ms(call, flush, 0.0, 50, label),
                  "warm_ms": _profile(call, 50)[4].get(label, 0.0),
                  "bound_ms": bound, "bound_by": by}
    return out


def phase_kernels_ctr():
    """The embedding gather-pool and scatter-add gradient kernels at the
    training path's shapes, [4096, 5] ids into a [1e6, D] table, D = 16
    (the program's) and 128, for uniform ids, Zipf ids and a
    Length-masked AVERAGE weight with a padding id.  Forward: within
    rtol = atol = 1e-6 of the plain version on the card, and
    ``torch.equal`` to it on dyadic values.  Gradient: two launches
    ``torch.equal``, and ``torch.equal`` to the plain version computed on
    the host, whose ``index_add_`` adds in (i, j) order.  The library
    calls, timed here only: ``embedding_bag(mode="sum",
    per_sample_weights=wgt)`` and the weight gradient of it.  Wall ms
    per back-to-back call by CUDA events for every case; for the Zipf
    cases, the path's, also the device ms per call from the profiler
    (the forward's call is host-bound); for the forward there also cold
    (the L2 flushed before each call) and warm at [4096, 5], the serve
    batch's [512, 5] and [1, 5], beside an empty kernel's device ms, the
    floor of any launch.  Returns the rows by (D, case)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.ops.ctr_ops import _reference_embedding_pool, \
        _reference_embedding_pool_grad

    fwd, grad = cuda_kernels.embedding_pool_fwd, \
        cuda_kernels.embedding_pool_grad
    v = CTR["vocab"]
    flush = _l2_flush()
    # torch.cuda._sleep(0) launches a kernel that returns at once
    floor_ms = _profile(lambda: torch.cuda._sleep(0), 50)[1]
    _p(f"  launch floor: an empty kernel (torch.cuda._sleep(0)) takes "
       f"{floor_ms:.4f} device ms")
    rows = {}
    for d in (CTR["dim"], 128):
        for case in ("uniform", "zipf", "length_avg"):
            label = f"D={d} {case}"
            w, ids, wgt, g = _emb_inputs(d, case)
            out = fwd(w, ids, wgt)
            ref = _reference_embedding_pool(w, ids, wgt)
            lib_out = F.embedding_bag(ids, w, mode="sum",
                                      per_sample_weights=wgt)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            lib_err = (lib_out - out).abs().max().item()
            dy = _emb_inputs(d, case, dyadic=True)
            exact = torch.equal(fwd(*dy[:3]), _reference_embedding_pool(
                *dy[:3]))
            _p(f"embedding_pool_fwd {label} [{CTR_TRAIN_ROWS},"
               f"{CTR['seq']}] ids into [{v},{d}]: max |err| vs plain = "
               f"{err:.3e} (rtol=atol=1e-6); dyadic values bit-exact = "
               f"{exact}; library max |diff| {lib_err:.3e}")
            if not torch.allclose(out, ref, rtol=1e-6, atol=1e-6) \
                    or not exact:
                raise SystemExit(f"chip_smoke: embedding_pool_fwd {label} "
                                 f"disagrees with its plain version")
            if not torch.allclose(lib_out, out, rtol=1e-5, atol=1e-5):
                raise SystemExit("chip_smoke: embedding_bag does not "
                                 "compute embedding_pool_fwd's function")

            dw = grad(g, ids, wgt, v)
            again = grad(g, ids, wgt, v)
            host = _reference_embedding_pool_grad(
                g.cpu(), ids.cpu(), None if wgt is None else wgt.cpu(), v)
            same = torch.equal(dw, again)
            host_equal = torch.equal(dw.cpu(), host)
            g_err = (dw.cpu() - host).abs().max().item()
            wl = w.detach().requires_grad_()
            with torch.enable_grad():
                lib_fwd = F.embedding_bag(ids, wl, mode="sum",
                                          per_sample_weights=wgt)
            lib_dw, = torch.autograd.grad(lib_fwd, wl, g, retain_graph=True)
            lib_g_err = (lib_dw - dw).abs().max().item()
            _p(f"embedding_pool_grad {label}: two launches torch.equal = "
               f"{same}; torch.equal to the host's index_add_ = "
               f"{host_equal} (max |err| {g_err:.3e}); library max |diff| "
               f"{lib_g_err:.3e}")
            if not (same and host_equal):
                raise SystemExit(f"chip_smoke: embedding_pool_grad {label} "
                                 f"is not deterministic or disagrees with "
                                 f"the host")
            # atomics add a hot id's thousands of terms in any order
            if not torch.allclose(lib_dw, dw, rtol=1e-5,
                                  atol=1e-5 * dw.abs().max().item()):
                raise SystemExit("chip_smoke: the embedding_bag gradient "
                                 "does not compute embedding_pool_grad's "
                                 "function")
            del host, again, lib_dw
            (f_bound, f_by), (g_bound, g_by) = _emb_bounds(ids, wgt, d, v)
            calls = {
                "forward": (lambda: fwd(w, ids, wgt),
                            lambda: _reference_embedding_pool(w, ids, wgt),
                            lambda: F.embedding_bag(
                                ids, w, mode="sum", per_sample_weights=wgt)),
                "gradient": (lambda: grad(g, ids, wgt, v),
                             lambda: _reference_embedding_pool_grad(
                                 g, ids, wgt, v),
                             lambda: torch.autograd.grad(
                                 lib_fwd, wl, g, retain_graph=True))}
            timed = {}
            for name, (kernel, plain, library) in calls.items():
                # wall ms per back-to-back call (the forward's is its
                # wrapper's host time); where the kernels line reads this
                # case, device ms per call from the profiler
                r = {"call_ms": _ms(kernel, 50),
                     "plain_call_ms": _ms(plain, 20),
                     "library_call_ms": _ms(library, 20)}
                if case == "zipf" or name == "gradient":
                    prof = _profile(kernel, 20)
                    r.update(ms=prof[1], plain_ms=_profile(plain, 20)[1],
                             library_ms=_profile(library, 20)[1])
                if name == "gradient":
                    # the zero-fill, sort and segments kernels apart
                    r["split_ms"] = prof[4]
                timed[name] = r
                dev = (f"; device: kernel {r['ms']:.4f} ms | plain "
                       f"{r['plain_ms']:.4f} ms | library "
                       f"{r['library_ms']:.4f} ms" if "ms" in r else "")
                _p(f"  {name}, wall per call: kernel {r['call_ms']:.4f} ms "
                   f"| plain {r['plain_call_ms']:.4f} ms | library "
                   f"{r['library_call_ms']:.4f} ms{dev} | bound "
                   f"{(f_bound if name == 'forward' else g_bound) * 1e3:.2f}"
                   f" us ({f_by if name == 'forward' else g_by})")
                if "split_ms" in r:
                    _p("  gradient device ms by kernel: " + " | ".join(
                        f"{c} {t:.4f}" for c, t in r["split_ms"].items()))
            if case == "zipf":
                by_rows = _emb_fwd_by_rows(w, ids, flush)
                timed["forward"].update(by_rows=by_rows,
                                        launch_floor_ms=floor_ms)
                for b, r in by_rows.items():
                    _p(f"  forward D={d} [{b},{CTR['seq']}] Zipf: device "
                       f"cold {r['cold_ms']:.4f} ms, warm "
                       f"{r['warm_ms']:.4f} ms | bound "
                       f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}) | "
                       f"launch floor {floor_ms:.4f} ms")
            rows[(d, case)] = (
                dict(timed["forward"], max_abs_err=err, bound_ms=f_bound,
                     bound_by=f_by),
                dict(timed["gradient"], max_abs_err=g_err, bound_ms=g_bound,
                     bound_by=g_by))
            del w, g, wl, lib_fwd, out, ref, lib_out, dw, dy
            torch.cuda.empty_cache()
    return rows


def _ctr_param_shapes():
    """The shapes of the Criteo-width CTR program's 32 parameters: the 26
    tables, then the relu tower fc, the wide fc and the head fc (weight,
    bias)."""
    s, v, d = CTR["slots"], CTR["vocab"], CTR["dim"]
    return [(v, d)] * s + [(s * d + 13, 32), (32,), (13, 1), (1,),
                           (32, 1), (1,)]


MOMENTUM_CASES = {
    "plain": {"mu": 0.9, "use_nesterov": False},
    "nesterov": {"mu": 0.9, "use_nesterov": True},
    "l2_decay": {"mu": 0.9, "use_nesterov": False,
                 "regularization_method": "l2_decay",
                 "regularization_coeff": 1e-4},
}


def phase_kernels_momentum():
    """``fused_momentum`` over the CTR bucket (32 parameters, 416,013,807
    values), plain, Nesterov and l2_decay: the op lowering (one
    multi-tensor kernel call over the 32 tensors where they lie, its
    outputs handed out as views) against the per-param ``momentum``
    lowering, ``torch.equal`` on every output; the profiler must see the
    op launch that one kernel and nothing else (no copy of the bucket).
    Returns the plain case's row.  The kernel, the op and the plain
    version (``_plain_fused_momentum`` on the card: flatten, the formula,
    unflatten) timed by CUDA events.  The library call is
    ``torch._fused_sgd_`` over the same 32 tensors (``dampening=0``,
    ``weight_decay=0``), held to rtol 1e-6 (atol 1e-6 of each tensor's
    largest value): its FMAs may round differently."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.ops.optimizer_ops import _plain_fused_momentum
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    shapes = _ctr_param_shapes()
    n = sum(math.prod(s) for s in shapes)
    lr = CTR_TRAIN["lr"]
    ins = {s: [std * torch.randn(shape, generator=gen, device=dev)
               for shape in shapes]
           for s, std in (("Param", 1.0), ("Grad", 1e-2),
                          ("Velocity", 1e-2))}
    ins["LearningRate"] = [torch.full((1,), lr, device=dev)]
    ctx = LoweringContext(dev)
    fused_op, per_param = get_op("fused_momentum").fn, get_op("momentum").fn
    err = 0.0
    for label, attrs in MOMENTUM_CASES.items():
        before = cuda_kernels.fused_momentum.launches
        fused = fused_op(ins, attrs, ctx)
        if cuda_kernels.fused_momentum.launches != before + 1:
            raise SystemExit("chip_smoke: the fused_momentum op did not "
                             "launch its kernel on the CTR bucket")
        equal = True
        for i in range(len(shapes)):
            one = per_param({s: [v[0] if s == "LearningRate" else v[i]]
                             for s, v in ins.items()}, attrs, ctx)
            for slot, outs in one.items():
                equal &= torch.equal(fused[slot][i], outs[0])
                err = max(err, (fused[slot][i] - outs[0]).abs().max().item())
        _p(f"fused_momentum {label}, CTR bucket ({len(shapes)} params, {n} "
           f"values): torch.equal to the per-param momentum = {equal} "
           f"(tolerance: bit-identical)")
        if not equal:
            raise SystemExit(f"chip_smoke: fused_momentum ({label}) is not "
                             f"bit-identical to the per-param lowering")
        if label == "plain":
            plain_out = fused
        else:
            del fused

    # the library: torch's fused SGD with momentum, in place
    lib = [[x.clone() for x in ins[s]] for s in ("Param", "Grad",
                                                 "Velocity")]

    def library():
        torch._fused_sgd_(*lib, weight_decay=0.0, momentum=0.9, lr=lr,
                          dampening=0.0, nesterov=False, maximize=False,
                          is_first_step=False)

    library()
    lib_err = 0.0
    for got, slot in ((lib[0], "ParamOut"), (lib[2], "VelocityOut")):
        for a, want in zip(got, plain_out[slot]):
            lib_err = max(lib_err, (a - want).abs().max().item())
            atol = 1e-6 * want.abs().max().item()
            if not torch.allclose(a, want, rtol=1e-6, atol=atol):
                raise SystemExit(f"chip_smoke: torch._fused_sgd_ does not "
                                 f"compute fused_momentum's {slot}")
    del plain_out
    library_ms = _ms(library, 10)
    del lib
    torch.cuda.empty_cache()
    ps, gs, vs = ins["Param"], ins["Grad"], ins["Velocity"]
    lr_t = ins["LearningRate"][0]

    def op():
        return fused_op(ins, MOMENTUM_CASES["plain"], ctx)

    # the op launches the kernel once and copies nothing
    _, _, _, op_kernels, op_classes = _profile(op, 3)
    _p(f"  profiler: {op_kernels:.0f} kernels a call of the op, device ms "
       f"by class {op_classes}")
    if op_kernels != 1 or set(op_classes) != {"fused_momentum (csrc)"}:
        raise SystemExit("chip_smoke: the fused_momentum op launched more "
                         "than its one kernel")
    ms = _ms(lambda: cuda_kernels.fused_momentum(ps, gs, vs, lr_t, 0.9, 0.0,
                                                 False), 20)
    op_ms = _ms(op, 20)
    plain_ms = _ms(lambda: _plain_fused_momentum(ps, gs, vs, lr_t, 0.9, 0.0,
                                                 False), 10)
    torch.cuda.empty_cache()
    t_bytes = 5 * 4 * n / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * n / FLOPS_PER_S["float32"] * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"
    _p(f"  kernel {ms:.4f} ms | op lowering {op_ms:.4f} ms (op less kernel "
       f"{op_ms - ms:.4f} ms) | plain {plain_ms:.4f} ms | library "
       f"(torch._fused_sgd_, max |diff| from the op {lib_err:.3e}, "
       f"rtol=1e-6) {library_ms:.4f} ms | bound {bound_ms:.4f} ms "
       f"({bound_by}, {bound_ms / ms:.1%} reached)")
    del ins, ps, gs, vs
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "op_ms": op_ms, "values": n}


# ---------------------------------------------------------------------------
# the dropout kernels (phase 3e)
# ---------------------------------------------------------------------------

# the ops per element the kernels do in float32; gelu's erff and expf
# counted as about 20 and 10
_DROPOUT_FLOPS = {"fused_dropout": 1, "dropout_mask": 0,
                  "fused_dropout_add": 2, "fused_act_dropout": 26,
                  "fused_act_dropout_bwd": 40}
# Philox4x32-10's integer work per group of four elements: ten rounds of
# two 32x32->64 multiplies (IMAD.WIDE, on the FMA pipe) and two three-way
# xors (LOP3, on the ALU pipe), then four threshold compares (ISETP, ALU).
# The key schedule is the same for every group of a call, so it is not
# counted per group; nor are the loop's counter and address arithmetic,
# which a kernel may spend but the function does not need.
PHILOX_FMA_PIPE_OPS = 20
PHILOX_ALU_PIPE_OPS = 24
# per SM and clock on compute capability 9.0: 64 results on each of the
# FMA and ALU pipes (4 schedulers x 16 lanes), 128 lanes issued in all (4
# schedulers x one warp instruction); times the SMs at the SM clock
# nvidia-smi reports
PIPE_LANES_PER_CLOCK = 64
ISSUE_LANES_PER_CLOCK = 128


def _philox_clocks_per_group():
    """SM clocks a group of four's Philox work takes at the least: the
    busier pipe's count at PIPE_LANES_PER_CLOCK, or the sum at
    ISSUE_LANES_PER_CLOCK, whichever is longer."""
    return max(PHILOX_FMA_PIPE_OPS / PIPE_LANES_PER_CLOCK,
               PHILOX_ALU_PIPE_OPS / PIPE_LANES_PER_CLOCK,
               (PHILOX_FMA_PIPE_OPS + PHILOX_ALU_PIPE_OPS)
               / ISSUE_LANES_PER_CLOCK)


def _sm_count():
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def _sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def _dropout_bound(name, n, element_size, clock_hz):
    """Least time on this card: the largest of the bytes (each input read
    once, the output written once; the mask kernel reads nothing and
    writes one byte an element) over HBM bandwidth, the float32 ops over
    the float32 peak, and Philox's integer work per group of four
    (``_philox_clocks_per_group``) over the SMs at ``clock_hz``.  Returns
    (ms, "bytes" | "operations", which of the three binds)."""
    streams = {"fused_dropout": 2, "fused_dropout_add": 3,
               "fused_act_dropout": 2, "fused_act_dropout_bwd": 3}
    nbytes = n if name == "dropout_mask" else streams[name] * n * element_size
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "float32 ops": _DROPOUT_FLOPS[name] * n
             / FLOPS_PER_S["float32"] * 1e3,
             "integer ops": -(-n // 4) * _philox_clocks_per_group()
             / (_sm_count() * clock_hz) * 1e3}
    which = max(times, key=times.get)
    return (times[which], "bytes" if which == "bytes" else "operations",
            which)


def _dropout_checks(label, dtype, rate, upscale, shape, seed):
    """dropout, its mask and dropout-add against the plain Philox
    versions: ``torch.equal``; the kept fraction within 6 sigma; the
    backwards (through the ops' autograd Functions, so the launches are
    the path's) equal to ``g · Mask · scale`` and, for the residual,
    ``g``; a twin whose seed is one more must give another mask.
    Returns the max |err| (0 when equal)."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels, nn_ops

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x, r, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    k0, k1 = nn_ops._key_words(seed)
    thr, scale = nn_ops._threshold_for(rate), nn_ops._scale_for(rate,
                                                                 upscale)
    out = cuda_kernels.fused_dropout(x, seed, thr, scale)
    mask = cuda_kernels.dropout_mask(x, seed, thr)
    add = cuda_kernels.fused_dropout_add(x, r, seed, thr, scale)
    keep = nn_ops._reference_keep(x.shape, k0, k1, thr, dev)
    plain = nn_ops._reference_dropout(x, k0, k1, thr, scale)
    plain_add = nn_ops._reference_dropout_add(x, r, k0, k1, thr, scale)
    xs = [t.detach().requires_grad_() for t in (x, x, r)]
    with torch.enable_grad():
        dx, = torch.autograd.grad(nn_ops._Dropout.apply(xs[0], k0, k1, thr,
                                                        scale), xs[0], g)
        dxa, dr = torch.autograd.grad(nn_ops._DropoutAdd.apply(
            xs[1], xs[2], k0, k1, thr, scale), xs[1:], g)
    want_dx = (g.float() * mask.float() * scale).to(dtype)
    twin = cuda_kernels.dropout_mask(x, seed + 1, thr)
    torch.cuda.synchronize()
    n = x.numel()
    kept = int(mask.sum())
    sigma = math.sqrt(n * rate * (1 - rate))
    checks = {"mask": torch.equal(mask, keep.to(torch.uint8)),
              "dropout": torch.equal(out, plain),
              "dropout-add": torch.equal(add, plain_add),
              "fraction": abs(kept - n * (1 - rate)) < 6 * sigma,
              "backward": torch.equal(dx, want_dx)
              and torch.equal(dxa, want_dx) and torch.equal(dr, g),
              "twin misses": not torch.equal(twin, mask)}
    err = max((out.float() - plain.float()).abs().max().item(),
              (add.float() - plain_add.float()).abs().max().item())
    _p(f"dropout {label} {list(shape)} rate {rate} "
       f"{'upscale' if upscale else 'downgrade'}: kept {kept / n:.5f} "
       f"(1 - rate {1 - rate}, 6 sigma {6 * sigma / n:.5f}); "
       + ", ".join(f"{k} {v}" for k, v in checks.items())
       + " (masks, outputs and backwards torch.equal)")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: the dropout kernels {label} rate "
                         f"{rate} disagree with their plain versions")
    return err


# act-dropout against its plain version: float32 a few ulp (erff and
# expf against torch's erf and exp), bfloat16 one ulp of the output
ACT_TOL = {"float32": (1e-6, 1e-6), "bfloat16": (2 ** -7, 1e-6)}


def _act_dropout_checks(label, dtype, act, rate, shape, seed):
    """act-dropout forward and backward against the plain versions
    within ACT_TOL, zeros where the mask drops, the backward through the
    op's autograd Function equal to the backward kernel; returns the max
    |err| of forward and backward."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels, nn_ops

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    k0, k1 = nn_ops._key_words(seed)
    thr, scale = nn_ops._threshold_for(rate), nn_ops._scale_for(rate, True)
    out = cuda_kernels.fused_act_dropout(x, seed, thr, scale, act)
    dx = cuda_kernels.fused_act_dropout_bwd(x, g, seed, thr, scale, act)
    want = nn_ops._reference_act_dropout(x, k0, k1, thr, scale, act)
    want_dx = nn_ops._reference_act_dropout_bwd(x, g, k0, k1, thr, scale,
                                                act)
    xg = x.detach().requires_grad_()
    with torch.enable_grad():
        dx_fn, = torch.autograd.grad(nn_ops._ActDropout.apply(
            xg, k0, k1, thr, scale, act), xg, g)
    keep = nn_ops._reference_keep(x.shape, k0, k1, thr, dev)
    twin = cuda_kernels.fused_act_dropout(x, seed + 1, thr, scale, act)
    torch.cuda.synchronize()
    rtol, atol = ACT_TOL[str(dtype).removeprefix("torch.")]
    checks = {
        "forward": torch.allclose(out.float(), want.float(), rtol=rtol,
                                  atol=atol),
        "backward": torch.allclose(dx.float(), want_dx.float(), rtol=rtol,
                                   atol=atol),
        "dropped are 0": not (torch.any(out[~keep]) or torch.any(dx[~keep])),
        "autograd = kernel": torch.equal(dx_fn, dx),
        "twin misses": not torch.equal(twin != 0, out != 0)}
    err = max((out.float() - want.float()).abs().max().item(),
              (dx.float() - want_dx.float()).abs().max().item())
    _p(f"act-dropout {label} {act} {list(shape)} rate {rate}: max |err| "
       f"vs plain {err:.3e} (rtol={rtol}, atol={atol}); "
       + ", ".join(f"{k} {v}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: the act-dropout kernels {label} "
                         f"{act} disagree with their plain versions")
    return err


def _dropout_calls(x, r, xa, ga, seed, rate, act):
    """name -> (kernel, plain version, library call or None, the input
    whose size sets the bound) of the five dropout kernels: dropout, its
    mask and dropout-add on ``x`` (and ``r``), act-dropout and its
    backward on ``xa`` (and ``ga``), at ``rate`` upscaled."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels, nn_ops

    dev = x.device
    k0, k1 = nn_ops._key_words(seed)
    thr, scale = nn_ops._threshold_for(rate), nn_ops._scale_for(rate, True)
    return {
        "fused_dropout": (
            lambda: cuda_kernels.fused_dropout(x, seed, thr, scale),
            lambda: nn_ops._reference_dropout(x, k0, k1, thr, scale),
            lambda: F.dropout(x, rate, training=True), x),
        "dropout_mask": (
            lambda: cuda_kernels.dropout_mask(x, seed, thr),
            lambda: nn_ops._reference_keep(x.shape, k0, k1, thr,
                                           dev).to(torch.uint8),
            lambda: torch.empty(x.shape, dtype=torch.uint8,
                                device=dev).bernoulli_(1 - rate), x),
        "fused_dropout_add": (
            lambda: cuda_kernels.fused_dropout_add(x, r, seed, thr, scale),
            lambda: nn_ops._reference_dropout_add(x, r, k0, k1, thr,
                                                  scale), None, x),
        "fused_act_dropout": (
            lambda: cuda_kernels.fused_act_dropout(xa, seed, thr, scale,
                                                   act),
            lambda: nn_ops._reference_act_dropout(xa, k0, k1, thr, scale,
                                                  act), None, xa),
        "fused_act_dropout_bwd": (
            lambda: cuda_kernels.fused_act_dropout_bwd(xa, ga, seed, thr,
                                                       scale, act),
            lambda: nn_ops._reference_act_dropout_bwd(xa, ga, k0, k1, thr,
                                                      scale, act),
            None, xa)}


# the five kernels' recorded device ms at these shapes (PERF.md's kernel
# table, before the mask's redesign; float32, bfloat16 or None): the log
# line prints this run's time as a share of it, the kernels line never
DROPOUT_RECORDED_MS = {"fused_dropout": (0.0162, 0.0096),
                       "dropout_mask": (0.0078, None),
                       "fused_dropout_add": (0.0250, 0.0112),
                       "fused_act_dropout": (0.0755, 0.0589),
                       "fused_act_dropout_bwd": (0.1031, 0.0671)}


def phase_kernels_dropout():
    """The five dropout kernels against their plain Philox versions at
    the dygraph step's shapes, [8192, 768] (dropout, mask, dropout-add)
    and [8192, 3072] (act-dropout), float32 and bfloat16, rates 0.1 and
    0.5, upscale and downgrade, gelu and relu.  Times: device ms per call
    from the profiler (these kernels take tens of microseconds, less
    than their wrappers' host time), beside the bound, the plain
    version's and, for dropout, ``torch.nn.functional.dropout``'s (timed
    here only), and in the log each as a share of its recorded time
    (DROPOUT_RECORDED_MS); the mask also cold (the L2 flushed before
    each call).  Returns the rows by kernel name, float32, with the
    bfloat16 row beside."""
    import torch

    errs = {}
    for dtype, label in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for rate, upscale in ((0.1, True), (0.1, False), (0.5, True),
                              (0.5, False)):
            e = _dropout_checks(label, dtype, rate, upscale,
                                (DROPOUT_ROWS, DY["hidden_size"]),
                                SEED + 11)
            errs[label] = max(errs.get(label, 0.0), e)
        for act, rate in (("gelu", 0.1), ("relu", 0.1), ("gelu", 0.5)):
            e = _act_dropout_checks(label, dtype, act, rate,
                                    (DROPOUT_ROWS, DY["intermediate_size"]),
                                    SEED + 12)
            errs["act " + label] = max(errs.get("act " + label, 0.0), e)

    dev = torch.device(DEVICE)
    rows = {}
    flush = _l2_flush()
    clock_hz = _sm_clock_hz()
    _p(f"  Philox's integer work per group of four: "
       f"{PHILOX_FMA_PIPE_OPS} FMA-pipe and {PHILOX_ALU_PIPE_OPS} ALU-pipe "
       f"operations, {_philox_clocks_per_group():g} SM clocks at "
       f"{PIPE_LANES_PER_CLOCK} lanes a pipe and {ISSUE_LANES_PER_CLOCK} "
       f"issued per clock, SM clock {clock_hz / 1e6:.0f} MHz")
    seed, rate = SEED + 13, 0.1
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    for dtype, label in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        x, r = (torch.randn(DROPOUT_ROWS, DY["hidden_size"], generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        xa, ga = (torch.randn(DROPOUT_ROWS, DY["intermediate_size"],
                              generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        calls = _dropout_calls(x, r, xa, ga, seed, rate, "gelu")
        for name, (kernel, plain, library, t) in calls.items():
            ms = _profile(kernel, 20)[1]
            plain_ms = _profile(plain, 5)[1]
            library_ms = _profile(library, 20)[1] if library else None
            bound_ms, bound_by, binds = _dropout_bound(
                name, t.numel(), t.element_size(), clock_hz)
            err = errs["act " + label] if "act" in name else errs[label]
            then = DROPOUT_RECORDED_MS[name][label == "bf16"]
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "binds": binds,
                   "library_ms": library_ms, "shape": list(t.shape)}
            cold = ""
            if name == "dropout_mask":
                row["cold_ms"] = _cold_ms(kernel, flush, 0.0, 20,
                                          "dropout mask (csrc)")
                # what one launch takes to write the mask's bytes with no
                # generator: PyTorch's fill_ of a uint8 tensor of its size
                ones = torch.empty(x.shape, dtype=torch.uint8, device=dev)
                row["write_floor_ms"] = _profile(lambda: ones.fill_(1),
                                                 20)[1]
                cold = (f" (cold {row['cold_ms']:.4f} ms; a uint8 fill_ "
                        f"of its size {row['write_floor_ms']:.4f} ms)")
            if label == "fp32":
                rows[name] = dict(row, dtype="float32")
            else:
                rows[name]["bf16"] = row
            lib_name = ("F.dropout" if name == "fused_dropout" else
                        "uint8 bernoulli_, other bits")
            lib = (f" | library ({lib_name}) {library_ms:.4f} ms"
                   if library else "")
            was = (f" | recorded {then:.4f} ms, now {ms / then:.3f} of it"
                   if then else "")
            _p(f"  {name} {label} {list(t.shape)}: kernel {ms:.4f} ms"
               f"{cold} | plain {plain_ms:.4f} ms{lib} | bound "
               f"{bound_ms * 1e3:.2f} us ({binds}){was}")
        del x, r, xa, ga
    torch.cuda.empty_cache()
    return rows


def _served_weights(params, layers, seed):
    """Random weights for the served program, drawn with numpy from
    ``seed``.  At the initializers' (Xavier) scale every layer's scores
    come out near 0 and its softmax uniform over the attended keys, so a
    comparison of answers could not see the scores.  Here the embedding
    has unit scale and each fc weight ``gain / sqrt(fan_in)``: gain 3 for
    the query and key products, so that the first layers' attention is
    far from uniform, sqrt(2) for the relu product and 1 elsewhere.  The
    program has no residual and no LayerNorm, so the rows of a request
    grow alike with depth and the deeper layers' attention still turns
    uniform; larger gains keep it apart longer but make the answers
    chaotic, so that float32 rounding alone moves them past the check's
    tolerance.  The serve phase prints each layer's spread.  Parameters
    come in builder order: the embedding, then per layer the query, key,
    value and relu fc (weight, bias), then the classifier fc."""
    if len(params) != 1 + 8 * layers + 2:
        raise SystemExit("chip_smoke: the BERT program's parameters are "
                         "not in the order this script draws them")
    gains = (3.0, 3.0, 1.0, math.sqrt(2.0))
    rng = np.random.RandomState(seed)
    weights = {}
    for i, p in enumerate(params):
        shape = tuple(p.shape)
        if len(shape) == 1:
            std = 0.1
        elif i == 0:
            std = 1.0
        else:
            gain = gains[(i - 1) // 2 % 4] if i <= 8 * layers else 1.0
            std = gain / np.sqrt(shape[0])
        weights[p.name] = (std * rng.standard_normal(shape)) \
            .astype(np.float32)
    query = [params[1 + 8 * l + j].name for l in range(layers)
             for j in (0, 1)]
    return weights, query


def _attention_spread(scores, attn_mask):
    """Per layer, over heads and attended query positions: the mean of
    the largest probability times the attended key count (1.0 when
    attention is uniform, the key count when it is one-hot), and the mean
    standard deviation of the scores over the attended keys."""
    keep = attn_mask.astype(bool)
    out = []
    for s in scores:                       # [n, H, T, T], bias included
        sharp, spread = [], []
        for r, k in enumerate(keep):
            sr = s[r][:, k][:, :, k].astype(np.float64)
            pr = np.exp(sr - sr.max(-1, keepdims=True))
            pr /= pr.sum(-1, keepdims=True)
            sharp.append((pr.max(-1) * k.sum()).mean())
            spread.append(sr.std(-1).mean())
        out.append((float(np.mean(sharp)), float(np.mean(spread))))
    return out


def phase_serve(card):
    """The served path; returns the launch count of each kernel and what
    the profile phase needs of the served program."""
    import torch
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.fluid import trace
    from paddle_tpu_torch.models.static_graphs import \
        build_bert_train_program
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.serving import ServingEngine, freeze_program

    layers = BERT_BASE["layers"]
    feeds = ["ids", "attn_mask"]
    t0 = time.perf_counter()
    main, startup, logits = build_bert_train_program(**BERT_BASE,
                                                     train=False)
    startup.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    params = main.all_parameters()
    weights, query = _served_weights(params, layers, SEED)
    interop.scope_from_numpy(weights, scope, fluid.CUDAPlace(0))
    n_params = sum(w.size for w in weights.values())
    frozen = freeze_program(main, feeds, [logits], scope=scope)
    bs = fluid.BuildStrategy()
    bs.fuse_attention = True
    program = fluid.CompiledProgram(frozen, bs)
    _p(f"serve: BERT-base width program, {len(params)} parameters "
       f"({n_params / 1e6:.1f} M values), startup run on the card, "
       f"weights drawn from seed {SEED} loaded, in "
       f"{time.perf_counter() - t0:.1f} s")

    rewrites = trace.metrics().counter("kernel_tier.fuse_attention.rewrites")
    r0 = rewrites.value
    eng = ServingEngine(program, scope=scope, max_batch=MAX_BATCH)
    try:
        warm = eng.warmup()
        n_rewrites = rewrites.value - r0
        fused = [op.type for op in frozen.global_block().ops].count(
            "fused_multihead_attention")
        _p(f"serve: fuse_attention rewrites = {n_rewrites}, fused ops = "
           f"{fused} (layers = {layers}); warmup of buckets "
           f"{warm['buckets']} took {warm['seconds']:.2f} s")
        if n_rewrites != layers or fused != layers:
            raise SystemExit("chip_smoke: fuse_attention did not rewrite "
                             "every attention block")

        rng = np.random.RandomState(SEED)
        requests = []
        for n in rng.choice(ROW_CHOICES, N_REQUESTS):
            seq = BERT_BASE["seq"]
            lengths = rng.randint(1, seq + 1, n)
            requests.append({
                "ids": rng.randint(0, BERT_BASE["vocab"], (n, seq))
                .astype("int64"),
                "attn_mask": (np.arange(seq)[None, :] < lengths[:, None])
                .astype("float32")})

        torch.cuda.synchronize()
        counted = [cuda_kernels.flash_attention_fwd]
        for fn in counted:
            fn.launches = 0
        _flash_copies_zero()
        b0 = eng.batches
        t0 = time.perf_counter()
        futures = [eng.submit(r) for r in requests]
        answers = [f.result(timeout=600)[logits.name] for f in futures]
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        batches = eng.batches - b0
    finally:
        eng.close()

    rows = [len(r["ids"]) for r in requests]
    for n, a in zip(rows, answers):
        if a.shape != (n, 2) or not np.isfinite(a).all():
            raise SystemExit(f"chip_smoke: a {n}-row request was answered "
                             f"with shape {a.shape} or non-finite values")
    lat = np.array([f.timing["latency_us"] for f in futures]) / 1e3
    _p(f"serve: {len(answers)} requests answered ({sum(rows)} rows: "
       f"{rows}) in {batches} batches; request latency p50 "
       f"{np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} "
       f"ms; {sum(rows) / wall:.1f} rows/s over {wall:.3f} s  [{card}]")
    flash_n = launches["flash_attention_fwd"]
    _p(f"serve: flash_attention_fwd launches = {flash_n}, "
       f"{layers} x batches = {layers * batches}")
    if batches < 1 or flash_n != layers * batches:
        raise SystemExit("chip_smoke: the served path did not launch the "
                         "flash-attention kernel once per layer per batch")
    _flash_copies_check("serve")

    # the host: the card's weights on the CPU, plain versions, CPU
    # summation order.  Three programs answer each sampled request: the
    # same frozen, fused program; the frozen program without
    # fuse_attention (the naive score chain, whose scores it also
    # fetches); and the fused program with every query product zeroed,
    # which makes every score 0 and so attention uniform over the
    # attended keys -- the answer a kernel blind to QK^T would give.
    host_weights = interop.scope_to_numpy(scope, [p.name for p in params])
    cpu_scope = interop.scope_from_numpy(host_weights, fluid.Scope(),
                                         fluid.CPUPlace())
    uniform_scope = interop.scope_from_numpy(
        {**host_weights, **{n: np.zeros_like(host_weights[n])
                            for n in query}},
        fluid.Scope(), fluid.CPUPlace())
    naive = freeze_program(main, feeds, [logits], scope=cpu_scope)
    score_names = [op.input("X")[0] for op in naive.global_block().ops
                   if op.type == "softmax"]
    host = fluid.Executor(fluid.CPUPlace())
    by_rows = np.argsort(rows, kind="stable")
    # the smallest request and the median one
    for i in (by_rows[0], by_rows[len(by_rows) // 2]):
        feed = requests[i]
        want = host.run(program, feed=feed, fetch_list=[logits],
                        scope=cpu_scope)[0]
        want_naive, *scores = host.run(naive, feed=feed,
                                       fetch_list=[logits] + score_names,
                                       scope=cpu_scope)
        uniform = host.run(program, feed=feed, fetch_list=[logits],
                           scope=uniform_scope)[0]
        spread = _attention_spread(scores, feed["attn_mask"])
        _p(f"serve: request {i} ({rows[i]} rows) attention per layer, "
           f"largest probability x attended keys (1 = uniform): "
           f"{[round(a, 2) for a, _ in spread]}; score std over attended "
           f"keys: {[round(b, 2) for _, b in spread]}")
        if spread[0][0] < 2.0:
            raise SystemExit("chip_smoke: the first layer's attention is "
                             "near uniform, so the answers cannot check "
                             "the kernel's scores")
        scale = float(np.abs(want).max())
        # 1e-3 of the answer's largest value, and never more than 1e-3
        atol = 1e-3 * min(scale, 1.0)
        for label, ref in (("fused", want), ("naive", want_naive)):
            err = float(np.abs(answers[i] - ref).max())
            _p(f"serve: request {i} card vs host ({label} program) max "
               f"|err| = {err:.3e} against max |logit| = {scale:.3e} "
               f"(rtol=1e-3, atol={atol:.3e})")
            np.testing.assert_allclose(answers[i], ref, rtol=1e-3,
                                       atol=atol)
        off = float(np.abs(answers[i] - uniform).max())
        _p(f"serve: request {i} card vs host with uniform attention max "
           f"|diff| = {off:.3e} (must fail the same tolerance)")
        if np.allclose(answers[i], uniform, rtol=1e-3, atol=atol):
            raise SystemExit("chip_smoke: the card-vs-host check cannot "
                             "tell the answers from uniform attention")
    return launches, (program, frozen, scope, logits)


def _train_feed(rng, rows):
    """ids, labels and a padding mask whose rows attend to random
    prefixes, drawn from ``rng``."""
    seq = BERT_BASE["seq"]
    lengths = rng.randint(1, seq + 1, rows)
    return {"ids": rng.randint(0, BERT_BASE["vocab"], (rows, seq))
            .astype("int64"),
            "labels": rng.randint(0, 2, (rows, 1)).astype("int64"),
            "attn_mask": (np.arange(seq)[None, :] < lengths[:, None])
            .astype("float32")}


@contextlib.contextmanager
def _attention_blind_to_qk():
    """The fused attention op with Q and K cut out of autodiff: its
    backward gives dQ = dK = 0, the gradients of a backward kernel that
    dropped them.  The forward is unchanged."""
    from paddle_tpu_torch.ops import attention
    plain = attention.flash_attention

    def blind(q, k, v, *args, **kwargs):
        return plain(q.detach(), k.detach(), v, *args, **kwargs)

    attention.flash_attention = blind
    try:
        yield
    finally:
        attention.flash_attention = plain


def _train_card_vs_host(main, loss, init, params, layers, card):
    """Two steps at HOST_ROWS rows on the card and on the host from the
    same weights and optimizer state, through the same rewritten program.
    The losses agree within rtol 1e-4.  The first step's gradients of the
    embedding and of every layer's query and key weights agree within
    1e-3 of the largest magnitude among them (the embedding against its
    own): deeper in this program, which has no residual and no LayerNorm,
    the query and key gradients shrink by orders of magnitude layer by
    layer until they are float32 rounding noise, which no tolerance
    relative to themselves can hold, while the first layers carry most of
    the gradient.  A host twin whose attention backward drops dQ and dK
    must miss the tolerance."""
    from paddle_tpu_torch import fluid, interop

    feed = _train_feed(np.random.RandomState(SEED + 2), HOST_ROWS)
    emb = params[0].name
    qk = [params[1 + 8 * l + j].name for l in range(layers) for j in (0, 2)]
    fetch = [loss.name] + [n + "@GRAD" for n in [emb] + qk]

    def two_steps(place):
        scope = interop.scope_from_numpy(init, fluid.Scope(), place)
        exe = fluid.Executor(place)
        first = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        second = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        return ([float(first[0]), float(second[0])],
                dict(zip([emb] + qk, first[1:])))

    t0 = time.perf_counter()
    card_loss, card_g = two_steps(fluid.CUDAPlace(0))
    host_loss, host_g = two_steps(fluid.CPUPlace())
    with _attention_blind_to_qk():
        twin_loss, twin_g = two_steps(fluid.CPUPlace())
    _p(f"train: card vs host, {HOST_ROWS} rows x 2 steps, in "
       f"{time.perf_counter() - t0:.1f} s: losses card {card_loss}, host "
       f"{host_loss} (rtol=1e-4)  [{card}]")
    if not np.allclose(card_loss, host_loss, rtol=1e-4, atol=0.0):
        raise SystemExit("chip_smoke: the card's training losses disagree "
                         "with the host's")

    def misses(grads):
        """Names whose gradient misses the tolerance against the card."""
        scale = max(float(np.abs(host_g[n]).max()) for n in qk)
        bad = []
        for n in [emb] + qk:
            atol = 1e-3 * (float(np.abs(host_g[emb]).max()) if n == emb
                           else scale)
            if not np.allclose(card_g[n], grads[n], rtol=0.0, atol=atol):
                bad.append(n)
        return bad

    errs = [float(np.abs(card_g[n] - host_g[n]).max()) for n in [emb] + qk]
    _p(f"train: first-step grads, max |card - host|: embedding "
       f"{errs[0]:.3e} (max |g| {np.abs(host_g[emb]).max():.3e}); query "
       f"and key weights per layer {[f'{e:.2e}' for e in errs[1:]]} "
       f"against 1e-3 x {max(np.abs(host_g[n]).max() for n in qk):.3e}")
    for label, grads in (("card", card_g), ("host", host_g),
                         ("twin (dQ = dK = 0)", twin_g)):
        norms = [float(np.linalg.norm(grads[n])) for n in qk[0::2]]
        _p(f"train: query-weight grad norm per layer, {label}: "
           f"{[f'{x:.3e}' for x in norms]}")
    bad = misses(host_g)
    if bad:
        raise SystemExit(f"chip_smoke: the card's gradients of {bad} "
                         f"disagree with the host's")
    twin_bad = misses(twin_g)
    _p(f"train: the twin misses the tolerance at {len(twin_bad)} of "
       f"{1 + len(qk)} gradients (must be at least the first layer's); "
       f"twin losses {twin_loss}")
    if qk[0] not in twin_bad or qk[1] not in twin_bad:
        raise SystemExit("chip_smoke: the card-vs-host gradient check "
                         "cannot tell dQ and dK from zero")


def phase_train(card):
    """The training path; returns the launch count of each kernel per
    the timed steps and what the profile phase needs."""
    import torch
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.fluid import trace
    from paddle_tpu_torch.models.static_graphs import \
        build_bert_train_program
    from paddle_tpu_torch.ops import cuda_kernels

    layers = TRAIN["layers"]
    t0 = time.perf_counter()
    main, startup, loss = build_bert_train_program(**TRAIN)
    startup.random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    params = main.all_parameters()
    weights, _ = _served_weights(params, layers, SEED)
    interop.scope_from_numpy(weights, scope, fluid.CUDAPlace(0))
    init = interop.scope_to_numpy(
        scope, [n for n, v in main.global_block().vars.items()
                if v.persistable])
    bs = fluid.BuildStrategy()
    bs.fuse_attention = bs.fuse_optimizer = True
    program = fluid.CompiledProgram(main, bs)
    counters = [trace.metrics().counter(f"kernel_tier.{n}.rewrites")
                for n in ("fuse_attention", "fuse_optimizer")]
    before = [c.value for c in counters]
    program._apply_ir_passes([loss.name])
    rewrites = [c.value - b for c, b in zip(counters, before)]
    types = [op.type for op in main.global_block().ops]
    _p(f"train: BERT-base width training program ({len(params)} "
       f"parameters, dropout 0, Adam lr {TRAIN['lr']}), built, startup run "
       f"and weights from seed {SEED} loaded in "
       f"{time.perf_counter() - t0:.1f} s; fuse_attention rewrites = "
       f"{rewrites[0]}, fuse_optimizer rewrites = {rewrites[1]}; ops: "
       f"{types.count('fused_multihead_attention')} fused attention, "
       f"{types.count('fused_adam')} fused_adam, {types.count('softmax')} "
       f"softmax, {types.count('adam')} adam, {len(types)} in all")
    if rewrites != [layers, 1] or types.count("fused_adam") != 1 \
            or "softmax" in types or "adam" in types:
        raise SystemExit("chip_smoke: the training program was not "
                         "rewritten onto the kernels")

    feed = _train_feed(np.random.RandomState(SEED), TRAIN_ROWS)

    def step():
        return exe.run(program, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]

    step()
    torch.cuda.synchronize()
    counted = [cuda_kernels.flash_attention_fwd,
               cuda_kernels.flash_attention_bwd, cuda_kernels.fused_adam]
    for fn in counted:
        fn.launches = 0
    _flash_copies_zero()
    t0 = time.perf_counter()
    losses = [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    losses = [float(x) for x in losses]
    tokens = TRAIN_ROWS * BERT_BASE["seq"] * TRAIN_STEPS
    _p(f"train: {TRAIN_STEPS} steps at {TRAIN_ROWS} rows in {wall:.3f} s: "
       f"{wall / TRAIN_STEPS * 1e3:.2f} ms/step, {tokens / wall:.0f} "
       f"tokens/s; losses {[round(x, 4) for x in losses]}  [{card}]")
    want = {"flash_attention_fwd": 2 * layers * TRAIN_STEPS,
            "flash_attention_bwd": layers * TRAIN_STEPS,
            "fused_adam": TRAIN_STEPS}
    _p(f"train: launches in the timed steps {launches}, expected {want} "
       f"(per step: {2 * layers} forward = {layers} forward ops + {layers} "
       f"recomputed in generic_grad's vjp, {layers} backward, 1 fused "
       f"Adam)")
    if launches != want:
        raise SystemExit("chip_smoke: the training step did not run "
                         "through every kernel as expected")
    _flash_copies_check("train")
    if not np.isfinite(losses).all():
        raise SystemExit("chip_smoke: a training loss is not finite")
    _train_card_vs_host(main, loss, init, params, layers, card)
    return launches, (program, main, scope, loss, feed)


# ---------------------------------------------------------------------------
# the CTR path: serve (phase 4c) and train (phase 4d)
# ---------------------------------------------------------------------------

def _ctr_weights(params, seed):
    """Random weights for the CTR program, drawn with numpy from
    ``seed``, one array per parameter in builder order: the tables at
    unit scale, each fc weight ``gain / sqrt(fan_in)`` (sqrt(2) for the
    relu tower, 1 for the wide and head fc), biases 0.1.  Logits come
    out of order 1, so the sigmoid is far from saturated."""
    slots = sum(p.name.startswith("embedding") for p in params)
    if len(params) != slots + 6:
        raise SystemExit("chip_smoke: the CTR program's parameters are not "
                         "in the order this script draws them")
    rng = np.random.default_rng(seed)
    out = []
    for i, p in enumerate(params):
        shape = tuple(p.shape)
        if len(shape) == 1:
            out.append(np.full(shape, 0.1, np.float32))
        elif i < slots:
            out.append(rng.standard_normal(shape, dtype=np.float32))
        else:
            gain = math.sqrt(2.0) if i == slots else 1.0
            w = rng.standard_normal(shape, dtype=np.float32)
            out.append(w * np.float32(gain / math.sqrt(shape[0])))
    return out


def _ctr_feed(rng, rows, vocab, perm, labels=False):
    """Dense features N(0, 1), Zipf ids per slot and, with ``labels``,
    0/1 labels."""
    feed = {"dense": rng.standard_normal((rows, 13), dtype=np.float32)}
    if labels:
        feed["label"] = rng.integers(0, 2, (rows, 1)).astype(np.float32)
    for i in range(CTR["slots"]):
        feed[f"ids_{i}"] = _zipf_ids(rng, (rows, CTR["seq"]), vocab, perm)
    return feed


@contextlib.contextmanager
def _pool_first_id_only():
    """The plain gather-pool with every position but the first weighted
    0: the answer of a kernel that pooled nothing, the host twin of the
    served check."""
    import torch
    from paddle_tpu_torch.ops import ctr_ops
    plain = ctr_ops._reference_embedding_pool

    def first_only(w, ids, wgt, padding_idx=-1):
        first = (torch.arange(ids.shape[1], device=w.device) == 0).to(
            w.dtype).expand(ids.shape)
        return plain(w, ids, first if wgt is None else wgt * first,
                     padding_idx)

    ctr_ops._reference_embedding_pool = first_only
    try:
        yield
    finally:
        ctr_ops._reference_embedding_pool = plain


@contextlib.contextmanager
def _grad_last_write_wins():
    """The plain gradient with ``index_copy_`` in place of
    ``index_add_``: of each repeated id only the last position counts,
    the gradient of a scatter that dropped its collisions.  The host
    twin of the training check."""
    import torch
    from paddle_tpu_torch.ops import ctr_ops
    plain = ctr_ops._reference_embedding_pool_grad

    def last_wins(g, ids, wgt, vocab):
        dw = torch.zeros((vocab, g.shape[-1]), dtype=g.dtype,
                         device=g.device)
        return dw.index_copy_(0, ids.reshape(-1).long(),
                              ctr_ops._emb_grad_rows(g, ids, wgt))

    ctr_ops._reference_embedding_pool_grad = last_wins
    try:
        yield
    finally:
        ctr_ops._reference_embedding_pool_grad = plain


def phase_serve_ctr(card):
    """The served CTR path; returns the forward kernel's launch count,
    the weights (for the training phase) and what the profile phase
    needs of the served program."""
    import torch
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.fluid import trace
    from paddle_tpu_torch.models.static_graphs import \
        build_ctr_train_program
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.serving import ServingEngine, freeze_program

    slots, vocab = CTR["slots"], CTR["vocab"]
    feeds = ["dense"] + [f"ids_{i}" for i in range(slots)]
    t0 = time.perf_counter()
    main, startup, logit = build_ctr_train_program(**CTR, train=False)
    startup.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    params = main.all_parameters()
    arrays = _ctr_weights(params, SEED)
    interop.scope_from_numpy({p.name: a for p, a in zip(params, arrays)},
                             scope, fluid.CUDAPlace(0))
    n_params = sum(a.size for a in arrays)
    frozen = freeze_program(main, feeds, [logit], scope=scope)
    bs = fluid.BuildStrategy()
    bs.fuse_sparse_embedding = True
    program = fluid.CompiledProgram(frozen, bs)
    _p(f"serve CTR: wide&deep program, {slots} slots x [{vocab},"
       f"{CTR['dim']}] tables, {len(params)} parameters ({n_params} "
       f"values), startup run on the card, weights drawn from seed {SEED} "
       f"loaded, in {time.perf_counter() - t0:.1f} s")

    rewrites = trace.metrics().counter(
        "kernel_tier.fuse_sparse_embedding.rewrites")
    r0 = rewrites.value
    eng = ServingEngine(program, scope=scope, max_batch=CTR_MAX_BATCH)
    try:
        warm = eng.warmup()
        n_rewrites = rewrites.value - r0
        types = [op.type for op in frozen.global_block().ops]
        _p(f"serve CTR: fuse_sparse_embedding rewrites = {n_rewrites}, "
           f"fused ops = {types.count('fused_embedding_pool')} (slots = "
           f"{slots}); warmup of buckets {warm['buckets']} took "
           f"{warm['seconds']:.2f} s")
        if n_rewrites != slots or types.count("fused_embedding_pool") \
                != slots or "lookup_table_v2" in types:
            raise SystemExit("chip_smoke: fuse_sparse_embedding did not "
                             "rewrite every slot")
        rng = np.random.default_rng(SEED)
        perm = rng.permutation(vocab)
        requests = [_ctr_feed(rng, int(n), vocab, perm)
                    for n in rng.choice(CTR_ROW_CHOICES, N_REQUESTS)]
        torch.cuda.synchronize()
        cuda_kernels.embedding_pool_fwd.launches = 0
        b0 = eng.batches
        t0 = time.perf_counter()
        futures = [eng.submit(r) for r in requests]
        answers = [f.result(timeout=600)[logit.name] for f in futures]
        wall = time.perf_counter() - t0
        launches = cuda_kernels.embedding_pool_fwd.launches
        batches = eng.batches - b0
    finally:
        eng.close()

    rows = [len(r["dense"]) for r in requests]
    for n, a in zip(rows, answers):
        if a.shape != (n, 1) or not np.isfinite(a).all():
            raise SystemExit(f"chip_smoke: a {n}-row CTR request was "
                             f"answered with shape {a.shape} or non-finite "
                             f"values")
    lat = np.array([f.timing["latency_us"] for f in futures]) / 1e3
    _p(f"serve CTR: {len(answers)} requests answered ({sum(rows)} rows: "
       f"{rows}) in {batches} batches; request latency p50 "
       f"{np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} "
       f"ms; {sum(rows) / wall:.1f} rows/s over {wall:.3f} s  [{card}]")
    _p(f"serve CTR: embedding_pool_fwd launches = {launches}, {slots} x "
       f"batches = {slots * batches}")
    if batches < 1 or launches != slots * batches:
        raise SystemExit("chip_smoke: the served CTR path did not launch "
                         "the gather-pool kernel once per slot per batch")

    # the host: the card's weights on the CPU, plain versions; the twin
    # pools only the first id of each slot
    cpu_scope = interop.scope_from_numpy(
        interop.scope_to_numpy(scope, [p.name for p in params]),
        fluid.Scope(), fluid.CPUPlace())
    host = fluid.Executor(fluid.CPUPlace())
    by_rows = np.argsort(rows, kind="stable")
    for i in (by_rows[0], by_rows[len(by_rows) // 2]):
        want = host.run(program, feed=requests[i], fetch_list=[logit],
                        scope=cpu_scope)[0]
        with _pool_first_id_only():
            twin = host.run(program, feed=requests[i], fetch_list=[logit],
                            scope=cpu_scope)[0]
        tol = 1e-5 * float(np.abs(want).max())
        err = float(np.abs(answers[i] - want).max())
        off = float(np.abs(answers[i] - twin).max())
        _p(f"serve CTR: request {i} ({rows[i]} rows) card vs host max "
           f"|err| = {err:.3e} against 1e-5 x max |logit| = {tol:.3e}; "
           f"the first-id-only twin misses by {off:.3e} (must be at least "
           f"10x the tolerance)")
        if err > tol:
            raise SystemExit("chip_smoke: the card's CTR answers disagree "
                             "with the host's")
        if off < 10 * tol:
            raise SystemExit("chip_smoke: the CTR card-vs-host check cannot "
                             "tell the answers from a pool of one id")
    del cpu_scope
    return launches, arrays, (program, frozen, scope, logit)


def _ctr_train_card_vs_host(bs, card):
    """Two steps at CTR_TRAIN_ROWS rows on the card and on the host from
    one state, with the tables cut to CTR_HOST_VOCAB rows (the one cut:
    the host's copy of the bucket stays under 2 GB), everything else at
    full width and Zipf ids, so many ids repeat.  The losses agree within
    rtol 1e-5; the first step's dense dW of every slot within 1e-6 of
    its largest entry; every parameter and velocity after 2 steps within
    1e-6 of its largest entry.  A host twin whose gradient keeps only the
    last of each repeated id must miss the dW check on every slot."""
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.models.static_graphs import \
        build_ctr_train_program

    t0 = time.perf_counter()
    main, startup, loss = build_ctr_train_program(
        **dict(CTR_TRAIN, vocab=CTR_HOST_VOCAB))
    startup.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    params = main.all_parameters()
    interop.scope_from_numpy(
        {p.name: a for p, a in zip(params, _ctr_weights(params, SEED + 1))},
        scope, fluid.CUDAPlace(0))
    state = [n for n, v in main.global_block().vars.items() if v.persistable]
    init = interop.scope_to_numpy(scope, state)
    fluid.CompiledProgram(main, bs)._apply_ir_passes([loss.name])
    rng = np.random.default_rng(SEED + 2)
    feed = _ctr_feed(rng, CTR_TRAIN_ROWS, CTR_HOST_VOCAB,
                     rng.permutation(CTR_HOST_VOCAB), labels=True)
    tables = [p.name for p in params if p.name.startswith("embedding")]
    fetch = [loss.name] + [t + "@GRAD" for t in tables]

    def two_steps(place):
        s = interop.scope_from_numpy(init, fluid.Scope(), place)
        exe = fluid.Executor(place)
        first = exe.run(main, feed=feed, fetch_list=fetch, scope=s)
        second = exe.run(main, feed=feed, fetch_list=[loss], scope=s)
        return ([float(first[0]), float(second[0])],
                dict(zip(tables, first[1:])), interop.scope_to_numpy(s, state))

    card_loss, card_g, card_state = two_steps(fluid.CUDAPlace(0))
    host_loss, host_g, host_state = two_steps(fluid.CPUPlace())
    with _grad_last_write_wins():
        _, twin_g, _ = two_steps(fluid.CPUPlace())
    _p(f"train CTR: card vs host at vocab {CTR_HOST_VOCAB}, "
       f"{CTR_TRAIN_ROWS} rows x 2 steps, in {time.perf_counter() - t0:.1f} "
       f"s: losses card {card_loss}, host {host_loss} (rtol=1e-5)  [{card}]")
    if not np.allclose(card_loss, host_loss, rtol=1e-5, atol=0.0):
        raise SystemExit("chip_smoke: the card's CTR training losses "
                         "disagree with the host's")

    def worst(got, want):
        """max over names of max |got - want| / max |want|."""
        return max(float(np.abs(got[n] - want[n]).max())
                   / max(float(np.abs(want[n]).max()), 1e-30) for n in want)

    g_err = worst(card_g, host_g)
    misses = sum(worst({n: twin_g[n]}, {n: card_g[n]}) > 1e-6
                 for n in tables)
    s_err = worst({n: card_state[n] for n in state if "@" not in n},
                  {n: host_state[n] for n in state if "@" not in n})
    _p(f"train CTR: first-step dW, max over slots of max |card - host| / "
       f"max |dW| = {g_err:.3e} (tolerance 1e-6); parameters and "
       f"velocities after 2 steps, the same = {s_err:.3e} (1e-6); the "
       f"last-write-wins twin misses the dW check on {misses} of "
       f"{len(tables)} slots (must be all)")
    if g_err > 1e-6 or s_err > 1e-6:
        raise SystemExit("chip_smoke: the card's CTR gradients or state "
                         "disagree with the host's")
    if misses != len(tables):
        raise SystemExit("chip_smoke: the CTR gradient check cannot tell "
                         "an index_add_ from an index_copy_")


def phase_train_ctr(arrays, card):
    """The CTR training path; returns the launch count of each kernel
    over the timed steps and what the profile phase needs."""
    import torch
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.fluid import trace
    from paddle_tpu_torch.models.static_graphs import \
        build_ctr_train_program
    from paddle_tpu_torch.ops import cuda_kernels

    slots, vocab = CTR["slots"], CTR["vocab"]
    t0 = time.perf_counter()
    main, startup, loss = build_ctr_train_program(**CTR_TRAIN)
    startup.random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    params = main.all_parameters()
    interop.scope_from_numpy({p.name: a for p, a in zip(params, arrays)},
                             scope, fluid.CUDAPlace(0))
    bs = fluid.BuildStrategy()
    bs.fuse_sparse_embedding = bs.fuse_optimizer = True
    program = fluid.CompiledProgram(main, bs)
    counters = [trace.metrics().counter(f"kernel_tier.{n}.rewrites")
                for n in ("fuse_sparse_embedding", "fuse_optimizer")]
    before = [c.value for c in counters]
    program._apply_ir_passes([loss.name])
    rewrites = [c.value - b for c, b in zip(counters, before)]
    types = [op.type for op in main.global_block().ops]
    _p(f"train CTR: Criteo-width program ({len(params)} parameters, "
       f"Momentum lr {CTR_TRAIN['lr']} mu 0.9), built, startup run and "
       f"weights from seed {SEED} loaded in {time.perf_counter() - t0:.1f} "
       f"s; fuse_sparse_embedding rewrites = {rewrites[0]}, fuse_optimizer "
       f"rewrites = {rewrites[1]}; ops: "
       f"{types.count('fused_embedding_pool')} fused_embedding_pool, "
       f"{types.count('fused_momentum')} fused_momentum, "
       f"{types.count('lookup_table_v2')} lookup_table_v2, "
       f"{types.count('momentum')} momentum, {len(types)} in all")
    if rewrites != [slots, 1] or types.count("fused_momentum") != 1 \
            or types.count("fused_embedding_pool") != slots \
            or {"lookup_table_v2", "sequence_pool", "momentum"} & set(types):
        raise SystemExit("chip_smoke: the CTR training program was not "
                         "rewritten onto the kernels")

    rng = np.random.default_rng(SEED)
    feed = _ctr_feed(rng, CTR_TRAIN_ROWS, vocab, rng.permutation(vocab),
                     labels=True)

    def step():
        return exe.run(program, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]

    step()
    torch.cuda.synchronize()
    counted = [cuda_kernels.embedding_pool_fwd,
               cuda_kernels.embedding_pool_grad, cuda_kernels.fused_momentum]
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _p(f"train CTR: {TRAIN_STEPS} steps at {CTR_TRAIN_ROWS} rows in "
       f"{wall:.3f} s: {wall / TRAIN_STEPS * 1e3:.2f} ms/step, "
       f"{CTR_TRAIN_ROWS * TRAIN_STEPS / wall:.0f} rows/s; peak device "
       f"memory {peak:.2f} GiB; losses {[round(x, 4) for x in losses]}  "
       f"[{card}]")
    want = {"embedding_pool_fwd": slots * TRAIN_STEPS,
            "embedding_pool_grad": slots * TRAIN_STEPS,
            "fused_momentum": TRAIN_STEPS}
    _p(f"train CTR: launches in the timed steps {launches}, expected "
       f"{want} (per step: {slots} forward, {slots} gradient, 1 fused "
       f"Momentum)")
    if launches != want:
        raise SystemExit("chip_smoke: the CTR training step did not run "
                         "through every kernel as expected")
    if not np.isfinite(losses).all():
        raise SystemExit("chip_smoke: a CTR training loss is not finite")
    _ctr_train_card_vs_host(bs, card)
    return launches, (program, main, scope, loss, feed)


# ---------------------------------------------------------------------------
# the flagship dygraph BERT pretraining step (phase 4e)
# ---------------------------------------------------------------------------

def _dy_inputs(rows):
    """ids, MLM labels and NSP labels as bench.py draws them (numpy
    RandomState(0), every position labelled), the first ``rows`` rows,
    as int64 tensors on the card."""
    import torch
    rng = np.random.RandomState(SEED)
    shape = (DY_BATCH, DY_SEQ)
    drawn = (rng.randint(0, DY["vocab_size"], shape),
             rng.randint(0, DY["vocab_size"], shape),
             rng.randint(0, 2, (DY_BATCH,)))
    return [torch.from_numpy(a[:rows].astype("int64")).to(DEVICE)
            for a in drawn]


def _dy_group(name):
    """A gradient's group for the card-vs-host tolerance: the embeddings,
    each encoder layer, the pooler, the MLM head, the NSP head."""
    parts = name.split(".")
    if parts[0] != "bert":
        return parts[0]
    return ".".join(parts[:4] if parts[1] == "encoder" else parts[:2])


def _dy_steps(model, tracer, inputs, steps, amp=False):
    """``steps`` functional steps (grad program, then fused Adam) from the
    model's own weights, the tracer's seeds reset to a fixed point first
    so two runs draw the same masks; returns the losses and the first
    step's gradients by parameter name (host numpy)."""
    import torch
    from paddle_tpu_torch.dygraph.functional import functional_loss
    from paddle_tpu_torch.optimizer.fused import make_fused_adam

    tracer._seed, tracer._seed_ctr = SEED + 7, 0
    tracer._amp_enabled = amp

    def loss_fn(i, m, n):
        return model.loss(*model(i), m, n)

    pv, lfn = functional_loss(model, loss_fn)
    grad_fn = torch.func.grad_and_value(lfn)
    state, _, update = make_fused_adam(pv, lr=DY_LR)
    params, losses, first = pv, [], None
    for _ in range(steps):
        grads, loss = grad_fn(params, *inputs)
        losses.append(float(loss))
        if first is None:
            names = [n for n, _ in model.named_parameters()]
            first = {n: g.detach().cpu().numpy()
                     for n, g in zip(names, grads)}
        state, params = update(state, grads)
    return losses, first


@contextlib.contextmanager
def _masks_seed_plus_one():
    """The host's plain Philox masks drawn with every op's seed one
    more: the masks of another seed, everything else unchanged."""
    from paddle_tpu_torch.ops import nn_ops
    plain = nn_ops._reference_keep

    def shifted(shape, k0, k1, threshold, device):
        return plain(shape, (k0 + 1) & 0xFFFFFFFF, k1, threshold, device)

    nn_ops._reference_keep = shifted
    try:
        yield
    finally:
        nn_ops._reference_keep = plain


def _group_misses(grads, want, rel):
    """(the gradients off by more than ``rel`` of their group's largest,
    each group's worst |got - want| over its largest)."""
    scale = {}
    for n, g in want.items():
        grp = _dy_group(n)
        scale[grp] = max(scale.get(grp, 0.0), float(np.abs(g).max()))
    bad, worst = [], {}
    for n, g in want.items():
        grp = _dy_group(n)
        err = float(np.abs(grads[n] - g).max())
        worst[grp] = max(worst.get(grp, 0.0), err / scale[grp])
        if err > rel * scale[grp]:
            bad.append(n)
    return bad, worst


def _dy_card_vs_host(model, tracer, init, card):
    """Float32 (autocast off), dropout 0.1 live, DY_HOST_ROWS rows: two
    steps on the card and on the host from the same weights, seeds and
    Adam state (the host's plain Philox draws the card's masks): losses
    within rtol 1e-4, first-step gradients within 1e-3 of the largest of
    their group.  A host twin whose masks use seed + 1 must miss.  One
    tape step (``loss.backward()``) on the card gives the functional
    path's gradients within 1e-5 of the largest of their group."""
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.models.bert import BertForPretraining

    t0 = time.perf_counter()
    inputs = _dy_inputs(DY_HOST_ROWS)
    card_loss, card_g = _dy_steps(model, tracer, inputs, 2)
    host_inputs = [t.cpu() for t in inputs]
    with dybase.guard(fluid.CPUPlace()):
        host_tracer = dybase._dygraph_tracer()
        host = BertForPretraining(**DY)
        host.train()
        interop.layer_from_numpy(host, init)
        host_loss, host_g = _dy_steps(host, host_tracer, host_inputs, 2)
        with _masks_seed_plus_one():
            twin_loss, twin_g = _dy_steps(host, host_tracer, host_inputs, 1)
    _p(f"dygraph: card vs host, float32, dropout 0.1 live, {DY_HOST_ROWS} "
       f"rows x 2 steps, in {time.perf_counter() - t0:.1f} s: losses card "
       f"{card_loss}, host {host_loss} (rtol=1e-4); twin (masks of seed "
       f"+ 1) {twin_loss}  [{card}]")
    if not np.allclose(card_loss, host_loss, rtol=1e-4, atol=0.0):
        raise SystemExit("chip_smoke: the dygraph step's losses on the card "
                         "disagree with the host's")
    misses = _group_misses
    bad, worst = misses(card_g, host_g, 1e-3)
    _p("dygraph: first-step grads, max |card - host| / largest of group: "
       + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    if bad:
        raise SystemExit(f"chip_smoke: the card's dygraph gradients of "
                         f"{bad[:5]} disagree with the host's")
    twin_bad, _ = misses(twin_g, host_g, 1e-3)
    _p(f"dygraph: the seed + 1 twin misses at {len(twin_bad)} of "
       f"{len(host_g)} gradients (must miss)")
    if not twin_bad:
        raise SystemExit("chip_smoke: the card-vs-host dygraph check cannot "
                         "tell the masks of another seed")

    # the tape path on the card from the same seeds
    tracer._seed, tracer._seed_ctr = SEED + 7, 0
    model.clear_gradients()
    loss = model.loss(*model(dybase.to_variable(inputs[0])),
                      dybase.to_variable(inputs[1]),
                      dybase.to_variable(inputs[2]))
    loss.backward()
    tape_g = {n: p.gradient_var.detach().cpu().numpy()
              for n, p in model.named_parameters()}
    model.clear_gradients()
    bad, worst = misses(tape_g, card_g, 1e-5)
    _p(f"dygraph: tape step (loss.backward()) loss {float(loss)} against "
       f"the functional {card_loss[0]}; grads, max |tape - functional| / "
       f"largest of group: {max(worst.values()):.2e} (tolerance 1e-5)")
    if bad or not np.isclose(float(loss), card_loss[0], rtol=1e-6):
        raise SystemExit(f"chip_smoke: the tape path's gradients of "
                         f"{bad[:5]} disagree with the functional path's")
    _dy_tape_cost(model, tracer, inputs, card)


def _dy_tape_cost(model, tracer, inputs, card, reps=3):
    """Wall ms of one gradient by the tape (forward with the tape on,
    then ``loss.backward()``: ``generic_grad`` reruns each op's forward
    inside its vjp) and by the functional path (``torch.func``'s one
    autograd pass), float32 at the check's rows, in turns."""
    import torch
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.dygraph.functional import functional_loss

    def loss_fn(i, m, n):
        return model.loss(*model(i), m, n)

    pv, lfn = functional_loss(model, loss_fn)
    grad_fn = torch.func.grad(lfn)
    variables = [dybase.to_variable(t) for t in inputs]

    def tape():
        loss_fn(*variables).backward()
        model.clear_gradients()

    times = {"tape": [], "functional": []}
    for _ in range(reps):
        for name, fn in (("tape", tape),
                         ("functional", lambda: grad_fn(pv, *inputs))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    _p(f"dygraph: one gradient at {DY_HOST_ROWS} rows, float32, wall ms "
       f"by turns: tape {[round(t, 2) for t in times['tape']]}, functional "
       f"{[round(t, 2) for t in times['functional']]}  [{card}]")


# bf16 keeps 8 significant bits: each matmul input and gray op output is
# rounded to 2^-9 relative.  The loss at these weights is a mean over
# 8,192 tokens of a log-softmax near log(30522), and the roundings are of
# random sign; 2^-6 is 8 times one rounding of the loss itself.
BF16_LOSS_RTOL = 2 ** -6


def phase_train_dygraph(card):
    """The flagship step: ``BertForPretraining`` at BERT-base width
    under the card's dygraph tracer, ``functional_loss``, the grad
    program ``torch.func.grad_and_value`` and ``make_fused_adam``'s
    update, bf16 autocast on, batch 64 of seq 128, dropout 0.1.  One
    warm-up step, then DY_STEPS timed steps with the launch counts set to
    0 before and read after: each must be its prediction.  The bf16
    warm-up step's loss against a float32 step from the same weights and
    seeds; then ``_dy_card_vs_host``.  Returns the launches and what the
    profile phase needs."""
    import torch
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.dygraph.functional import functional_loss
    from paddle_tpu_torch.fluid.framework import _dygraph_tracer
    from paddle_tpu_torch.models.bert import BertForPretraining
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.optimizer.fused import make_fused_adam

    t0 = time.perf_counter()
    np.random.seed(SEED)
    dybase.enable_dygraph()               # the card: CUDAPlace(0)
    tracer = _dygraph_tracer()
    model = BertForPretraining(**DY)
    model.train()
    init = model.state_dict()
    n_params = sum(a.size for a in init.values())

    def loss_fn(i, m, n):
        return model.loss(*model(i), m, n)

    pv, lfn = functional_loss(model, loss_fn)
    grad_fn = torch.func.grad_and_value(lfn)
    state, _, update = make_fused_adam(pv, lr=DY_LR)
    inputs = _dy_inputs(DY_BATCH)
    box = {"state": state, "params": update.params_of(state)}

    def step():
        grads, loss = grad_fn(box["params"], *inputs)
        box["state"], box["params"] = update(box["state"], grads)
        return loss

    _p(f"dygraph: BertForPretraining at BERT-base width ({n_params} "
       f"parameters, {len(pv)} tensors; vocab {DY['vocab_size']}, hidden "
       f"{DY['hidden_size']}, {DY['num_layers']} layers, "
       f"{DY['num_heads']} heads, FFN {DY['intermediate_size']}, dropout "
       f"0.1), built on the card in {time.perf_counter() - t0:.1f} s")
    tracer._seed, tracer._seed_ctr = SEED + 5, 0
    tracer._amp_enabled = True
    t0 = time.perf_counter()
    bf16_loss = float(step())
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    # the same first step in float32 from the same weights and seeds
    tracer._seed, tracer._seed_ctr = SEED + 5, 0
    tracer._amp_enabled = False
    _, f32_loss = grad_fn(update.params_of(state), *inputs)
    f32_loss = float(f32_loss)
    tracer._amp_enabled = True
    _p(f"dygraph: warm-up step {warm:.2f} s; first-step loss bf16 "
       f"{bf16_loss}, float32 {f32_loss} (rtol {BF16_LOSS_RTOL})")
    if not (np.isfinite(bf16_loss) and np.isclose(
            bf16_loss, f32_loss, rtol=BF16_LOSS_RTOL, atol=0.0)):
        raise SystemExit("chip_smoke: the bf16 dygraph step's loss is not "
                         "finite or not near the float32 step's")

    counted = [cuda_kernels.flash_attention_fwd,
               cuda_kernels.flash_attention_bwd, cuda_kernels.fused_dropout,
               cuda_kernels.dropout_mask, cuda_kernels.fused_dropout_add,
               cuda_kernels.fused_act_dropout,
               cuda_kernels.fused_act_dropout_bwd]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    _flash_copies_zero()
    t0 = time.perf_counter()
    losses = [step() for _ in range(DY_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = DY_BATCH * DY_SEQ * DY_STEPS
    _p(f"dygraph: {DY_STEPS} steps at {DY_BATCH} x {DY_SEQ} in {wall:.3f} "
       f"s: {wall / DY_STEPS * 1e3:.2f} ms/step, {tokens / wall:.0f} "
       f"tokens/s, peak memory {peak:.2f} GiB; losses "
       f"{[round(x, 4) for x in losses]}  [{card}]")
    want = {k: v * DY_STEPS for k, v in DY_LAUNCHES.items()}
    _p(f"dygraph: launches in the timed steps {launches}, expected {want} "
       f"(per step: flash 12 forward, 12 backward; dropout 13 forward = 12 "
       f"attention-output + 1 embedding, 37 backward = 13 dropouts + 24 "
       f"dropout-adds' x; 13 masks; 24 dropout-adds; 12 act-dropout "
       f"forward, 12 backward)")
    if launches != want:
        raise SystemExit("chip_smoke: the dygraph step did not run through "
                         "every kernel as predicted")
    _flash_copies_check("dygraph")
    if not np.isfinite(losses).all():
        raise SystemExit("chip_smoke: a dygraph training loss is not finite")
    # the first three steps from the initial weights and the same seeds,
    # bf16 and float32, side by side (printed, not held: past the first
    # step the two trajectories part)
    traj = {amp: _dy_steps(model, tracer, inputs, 3, amp=amp)[0]
            for amp in (True, False)}
    _p(f"dygraph: first 3 steps from the initial weights, losses bf16 "
       f"{traj[True]}, float32 {traj[False]}")
    _dy_card_vs_host(model, tracer, init, card)
    tracer._seed, tracer._seed_ctr = SEED + 5, 0
    tracer._amp_enabled = True
    return launches, step


def _dy_product_flops():
    """2·M·K·N of the step's cuBLAS products (forward, and twice that
    for the two gradients of each): per token, each layer's q, k, v,
    output and two FFN products, the MLM transform and decoder, the
    pooler and NSP head on the first token.  Attention's products are in
    the flash kernels."""
    h, f, v = DY["hidden_size"], DY["intermediate_size"], DY["vocab_size"]
    tokens = DY_BATCH * DY_SEQ
    per_token = DY["num_layers"] * (4 * h * h + 2 * h * f) + h * h + h * v
    return 3 * 2.0 * (tokens * per_token + DY_BATCH * (h * h + 2 * h))


def phase_profile_dygraph(step, card, iters=5):
    """Where the dygraph step's time goes, as ``phase_profile`` measures
    it: host ms unprofiled, device busy ms, the idle share and device ms
    by kernel class of one step (grad program and fused Adam)."""
    import torch

    def one():
        return step().cpu()

    host_ms, busy_ms, idle, n_kern, by_class = _profile(one, iters)
    cublas_ms = by_class.get("matmul (cuBLAS)", 0.0)
    gflop = _dy_product_flops() / 1e9
    tokens = DY_BATCH * DY_SEQ
    _p(f"profile: dygraph BERT step, {DY_BATCH} x {DY_SEQ}, bf16: host "
       f"{host_ms:.3f} ms/step ({tokens / host_ms * 1e3:.0f} tokens/s), "
       f"device busy {busy_ms:.3f} ms/step, idle share {idle:.4f}, "
       f"{n_kern:.0f} kernels/step; products {gflop:.1f} GFLOP at "
       f"{gflop / cublas_ms if cublas_ms else float('nan'):.1f} TFLOP/s  "
       f"[{card}]")
    _print_classes(by_class, "step")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the dygraph ResNet-50 step (4h) and its profile
# ---------------------------------------------------------------------------

def _resnet_loss(model):
    from paddle_tpu_torch.fluid import layers as L

    def loss_fn(images, labels):
        return L.nn.mean(L.softmax_with_cross_entropy(model(images), labels))
    return loss_fn


def _resnet_batch(batch, size, classes, device, seed=SEED):
    """bench.py's synthetic batch: NHWC images ``randn`` and labels
    ``randint`` from ``RandomState(seed)``, as tensors on ``device``."""
    import torch
    rng = np.random.RandomState(seed)
    images = rng.randn(batch, size, size, 3).astype("float32")
    labels = rng.randint(0, classes, (batch, 1)).astype("int64")
    return (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))


def _functional_resnet_step(model):
    """bench.py:134's step on the port: the grad program of
    ``functional_loss`` by ``torch.func.grad_and_value``, then SGD with
    momentum on the values (``v = mu v + g``, ``p = p - lr v``).  Returns
    ``step(images, labels) -> (loss, grads)``; the values live in a box
    and are written back into the model after each step."""
    import torch
    from paddle_tpu_torch.dygraph.functional import functional_loss

    lr, mu = RESNET_LR, RESNET_MU
    pv, lfn = functional_loss(model, _resnet_loss(model))
    grad_fn = torch.func.grad_and_value(lfn)
    box = {"p": pv, "v": [torch.zeros_like(p, dtype=torch.float32)
                          for p in pv]}

    def step(images, labels):
        grads, loss = grad_fn(box["p"], images, labels)
        box["v"] = torch._foreach_add(torch._foreach_mul(box["v"], mu),
                                      [g.float() for g in grads])
        box["p"] = [(p.float() - lr * v).to(p.dtype)
                    for p, v in zip(box["p"], box["v"])]
        for param, value in zip(model.parameters(), box["p"]):
            param._value = value
        return loss, grads
    return step


def _eager_resnet_step(model):
    """The user's eager loop: ``loss.backward()``, a fluid
    ``MomentumOptimizer(parameter_list=...).minimize(loss)`` (one
    ``momentum`` op a parameter), ``model.clear_gradients()``."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as dybase

    opt = fluid.optimizer.MomentumOptimizer(
        RESNET_LR, RESNET_MU, parameter_list=model.parameters())
    loss_fn = _resnet_loss(model)

    def step(images, labels):
        loss = loss_fn(dybase.to_variable(images),
                       dybase.to_variable(labels))
        loss.backward()
        opt.minimize(loss)
        model.clear_gradients()
        return loss.value()
    return step


def _timed_steps(label, fn, steps, batch, card):
    """``steps`` calls of ``fn`` of ``batch`` images each: wall ms a step,
    images/s and peak memory printed; returns the calls' results."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = [fn() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = wall / steps * 1e3
    _p(f"{label}: {steps} x {batch} images in {wall:.3f} s: {ms:.2f} "
       f"ms/step, {batch / ms * 1e3:.1f} images/s, peak memory {peak:.2f} "
       f"GiB  [{card}]")
    return out


def _cosine(a, b):
    a = np.concatenate([x.ravel() for x in a]).astype(np.float64)
    b = np.concatenate([x.ravel() for x in b]).astype(np.float64)
    return (float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))),
            float(np.linalg.norm(a) / np.linalg.norm(b)))


def _resnet_run(place, init, twin=None):
    """At RESNET_HOST from ``init``: one functional step's loss and
    gradients, one eager step's loss and moving statistics, then eval
    logits from the initial weights and those statistics.  ``twin``, a
    context manager, is held around all of it."""
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.vision.models import ResNet

    h = RESNET_HOST
    twin = twin or contextlib.nullcontext
    with dybase.guard(place), twin():
        tracer = dybase._dygraph_tracer()
        model = ResNet(h["depth"], num_classes=h["num_classes"],
                       data_format="NHWC")
        interop.layer_from_numpy(model, init)
        model.train()
        images, labels = _resnet_batch(h["batch"], h["size"],
                                       h["num_classes"], tracer.device,
                                       seed=SEED + 41)
        loss_a, grads = _functional_resnet_step(model)(images, labels)
        out = {"loss_a": float(loss_a),
               "grads": [g.detach().cpu().numpy() for g in grads]}
        interop.layer_from_numpy(model, init)
        out["loss_b"] = float(_eager_resnet_step(model)(images, labels))
        names = [n for n, _ in model.named_parameters()]
        stats = {n: v for n, v in model.state_dict().items()
                 if n not in names}
        out["stats"] = stats
        interop.layer_from_numpy(model, dict(init, **stats))
        model.eval()
        with dybase.no_grad():
            out["logits"] = model(dybase.to_variable(images)).numpy()
        out["names"] = names
    return out


def _resnet_card_vs_host(card):
    """RESNET_HOST on the card and on the host from one state, float32:
    losses (a) and (b) within rtol 1e-4; the first-step gradients as a
    whole (cosine >= 0.99, norms within 2%) and the fc layer's within
    1e-3 of their largest; the moving statistics after the eager step
    within 1e-4 of each buffer's largest; eval logits within 1e-4 of the
    largest.  A host twin whose batch norm normalizes training by the
    moving statistics must miss."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.vision.models import ResNet

    t0 = time.perf_counter()
    h = RESNET_HOST
    np.random.seed(SEED + 40)
    with dybase.guard(fluid.CUDAPlace(0)):
        init = ResNet(h["depth"], num_classes=h["num_classes"],
                      data_format="NHWC").state_dict()
    card_r = _resnet_run(fluid.CUDAPlace(0), init)
    host_r = _resnet_run(fluid.CPUPlace(), init)
    twin_r = _resnet_run(fluid.CPUPlace(), init,
                         twin=_bn_moving_stats_in_training)

    def margins(got, want):
        """Each check's error over its tolerance (under 1 passes)."""
        loss = max(abs(got[k] - want[k]) / abs(want[k])
                   for k in ("loss_a", "loss_b")) / 1e-4
        cos, norm = _cosine(got["grads"], want["grads"])
        fc = max(float(np.abs(g - w).max()) / float(np.abs(w).max())
                 for g, w, n in zip(got["grads"], want["grads"],
                                    want["names"]) if n.startswith("fc."))
        stats = max(float(np.abs(got["stats"][n] - w).max())
                    / float(np.abs(w).max())
                    for n, w in want["stats"].items()) / 1e-4
        logits = float(np.abs(got["logits"] - want["logits"]).max()) \
            / float(np.abs(want["logits"]).max()) / 1e-4
        largest = max(float(np.abs(w).max()) for w in want["grads"])
        worst = max(float(np.abs(g - w).max()) for g, w in
                    zip(got["grads"], want["grads"])) / largest
        return {"losses": loss, "gradient cosine": (1 - cos) / 0.01,
                "gradient norms": abs(norm - 1) / 0.02, "fc": fc / 1e-3,
                "moving statistics": stats, "eval logits": logits}, \
            {"cosine": cos, "norm ratio": norm,
             "max |err| / largest gradient": worst}

    ok, ok_info = margins(card_r, host_r)
    miss, miss_info = margins(twin_r, host_r)
    fmt = ", ".join
    _p(f"resnet: card vs host, depth {h['depth']}, {h['size']}x{h['size']}, "
       f"batch {h['batch']}, {h['num_classes']} classes, float32, in "
       f"{time.perf_counter() - t0:.1f} s: losses card "
       f"{[card_r['loss_a'], card_r['loss_b']]}, host "
       f"{[host_r['loss_a'], host_r['loss_b']]}, twin "
       f"{[twin_r['loss_a'], twin_r['loss_b']]}  [{card}]")
    _p("resnet: card vs host, error / tolerance (under 1 passes): "
       + fmt(f"{k} {v:.3e}" for k, v in ok.items()) + "; "
       + fmt(f"{k} {v:.6g}" for k, v in ok_info.items()))
    _p("resnet: the batch norm on moving statistics twin, error / "
       "tolerance (must miss, over 1): "
       + fmt(f"{k} {v:.3e}" for k, v in miss.items()) + "; "
       + fmt(f"{k} {v:.6g}" for k, v in miss_info.items()))
    if max(ok.values()) > 1:
        raise SystemExit("chip_smoke: ResNet-50 on the card disagrees with "
                         "the host")
    if max(miss.values()) <= 1:
        raise SystemExit("chip_smoke: the ResNet-50 card-vs-host check "
                         "cannot see the twin")
    return ok, miss


def _counted_kernels():
    from paddle_tpu_torch.ops import cuda_kernels
    return [getattr(cuda_kernels, n) for n in (
        "flash_attention_fwd", "flash_attention_bwd", "fused_adam",
        "embedding_pool_fwd", "embedding_pool_grad", "fused_momentum",
        "fused_dropout", "dropout_mask", "fused_dropout_add",
        "fused_act_dropout", "fused_act_dropout_bwd", "paged_attention",
        "fused_adam_master", "fused_momentum_master")]


def phase_train_resnet(card):
    """The ResNet-50 step at RESNET's full width through (a) and (b),
    then the eval forward, each with its host ms, images/s and peak
    memory; (a)'s losses on one fixed batch must be finite and fall;
    no hand-written kernel launches; then ``_resnet_card_vs_host``.
    Returns what the profile phase needs."""
    import torch
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.fluid.framework import _dygraph_tracer
    from paddle_tpu_torch.vision.models import resnet50

    # a dygraph user gets torch's cuDNN defaults (the tracer sets only
    # TF32 off); phase 4g's executor set deterministic algorithms
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    np.random.seed(SEED)
    dybase.enable_dygraph()               # the card: CUDAPlace(0)
    tracer = _dygraph_tracer()
    tracer._amp_enabled = True
    model = resnet50(**RESNET)
    model.train()
    n_params = sum(p.value().numel() for p in model.parameters())
    images, labels = _resnet_batch(RESNET_BATCH, RESNET_SIZE,
                                   RESNET["num_classes"], tracer.device)
    _p(f"resnet: resnet50(num_classes={RESNET['num_classes']}, "
       f"data_format={RESNET['data_format']!r}), {n_params} parameters in "
       f"{len(model.parameters())} tensors, {len(model.buffers())} "
       f"buffers, built on the card in {time.perf_counter() - t0:.1f} s; "
       f"batch {RESNET_BATCH} of {RESNET_SIZE}x{RESNET_SIZE}x3, bf16 "
       f"autocast, SGD momentum {RESNET_MU} lr {RESNET_LR}; cuDNN "
       f"deterministic={torch.backends.cudnn.deterministic}, "
       f"benchmark={torch.backends.cudnn.benchmark}, TF32 "
       f"{torch.backends.cudnn.allow_tf32}")
    counted = _counted_kernels()
    stats0 = [b._value.clone() for b in model.buffers()]
    fstep = _functional_resnet_step(model)

    def timed(label, fn, steps):
        return _timed_steps("resnet " + label, fn, steps, RESNET_BATCH, card)

    t = time.perf_counter()
    first = float(fstep(images, labels)[0])
    torch.cuda.synchronize()
    _p(f"resnet (a): warm-up step {time.perf_counter() - t:.2f} s, loss "
       f"{first}")
    for fn in counted:
        fn.launches = 0
    losses = [float(loss) for loss, _ in timed(
        "(a) functional step", lambda: fstep(images, labels),
        RESNET_STEPS)]
    launches = {fn.__name__: fn.launches for fn in counted}
    _p(f"resnet (a): losses {[round(x, 4) for x in [first] + losses]}; "
       f"hand-written kernel launches {launches} (none expected)")
    if not np.isfinite(losses).all() or not losses[-1] < first:
        raise SystemExit("chip_smoke: the ResNet-50 functional steps' "
                         "losses are not finite or do not fall")
    if any(launches.values()):
        raise SystemExit("chip_smoke: the ResNet-50 path launched a "
                         "hand-written kernel")
    if not all(torch.equal(b._value, s)
               for b, s in zip(model.buffers(), stats0)):
        raise SystemExit("chip_smoke: a functional step moved a buffer")

    estep = _eager_resnet_step(model)
    t = time.perf_counter()
    loss_b0 = float(estep(images, labels))
    torch.cuda.synchronize()
    _p(f"resnet (b): warm-up step {time.perf_counter() - t:.2f} s, loss "
       f"{loss_b0}")
    for fn in counted:
        fn.launches = 0
    tape = [float(x) for x in timed(
        "(b) loss.backward() + minimize", lambda: estep(images, labels),
        RESNET_TAPE_STEPS)]
    launches = {fn.__name__: fn.launches for fn in counted}
    moved = sum(not torch.equal(b._value, s)
                for b, s in zip(model.buffers(), stats0))
    _p(f"resnet (b): losses {[round(x, 4) for x in [loss_b0] + tape]}; "
       f"{moved} of {len(stats0)} moving statistics moved; hand-written "
       f"kernel launches {launches} (none expected)")
    if not np.isfinite(tape).all() or moved != len(stats0) \
            or any(launches.values()):
        raise SystemExit("chip_smoke: the ResNet-50 eager steps failed")

    model.eval()

    def evaluate():
        with dybase.no_grad():
            return model(dybase.to_variable(images)).value()

    logits = timed("eval forward", evaluate, 1)[0]
    if tuple(logits.shape) != (RESNET_BATCH, RESNET["num_classes"]) \
            or not bool(torch.isfinite(logits).all()):
        raise SystemExit("chip_smoke: the ResNet-50 eval logits are not "
                         "finite or not of their shape")
    model.train()
    _resnet_card_vs_host(card)
    tracer._amp_enabled = True
    return model, fstep, estep, evaluate, (images, labels)


def _resnet_flops_per_image():
    """2·MACs of ResNet-50's convolutions and fc at RESNET_SIZE² (4.1e9
    MACs at 224, the published count), forward only."""
    return 2 * 4.1e9 * (RESNET_SIZE / 224) ** 2


def phase_profile_resnet(trained, card, iters=3):
    """Where the ResNet-50 step's time goes, as ``phase_profile``
    measures it: (a), (b) and the eval forward at RESNET_BATCH rows, with
    each one's peak memory; the "copies and casts" class is where a
    layout copy of an NHWC activation would show."""
    import torch

    model, fstep, estep, evaluate, (images, labels) = trained
    gflop = _resnet_flops_per_image() * RESNET_BATCH / 1e9
    model.train()
    for label, fn, flops in (
            ("(a) functional step", lambda: fstep(images, labels)[0].cpu(),
             3 * gflop),
            ("(b) loss.backward() + minimize",
             lambda: estep(images, labels).cpu(), 3 * gflop),
            ("eval forward", lambda: evaluate().cpu(), gflop)):
        if label == "eval forward":
            model.eval()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        host_ms, busy_ms, idle, n_kern, by_class = _profile(fn, iters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _p(f"profile: ResNet-50 {label}, {RESNET_BATCH} x {RESNET_SIZE}^2, "
           f"bf16: host {host_ms:.3f} ms/step ({RESNET_BATCH / host_ms * 1e3:.1f} "
           f"images/s), device busy {busy_ms:.3f} ms/step, idle share "
           f"{idle:.4f}, {n_kern:.0f} kernels/step, peak memory {peak:.2f} "
           f"GiB; {flops:.0f} GFLOP of convolutions and fc at "
           f"{flops / busy_ms if busy_ms else float('nan'):.1f} TFLOP/s "
           f"of busy time  [{card}]")
        _print_classes(by_class, "step")
    model.train()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the NMT path: its attention and dropout shapes (phase 3), the Transformer
# NMT step (4i) and its profile
# ---------------------------------------------------------------------------

def _nmt_attention_inputs(tq, tk, dtype, bias, seed):
    """q and dO ``[B,H,Tq,D]``, k and v ``[B,H,Tk,D]`` at the NMT step's
    batch and heads, permuted views of ``[B,T,H,D]`` tensors as the
    model's heads are, and the bias: None, or with "causal" the decoder's
    ``[1,1,Tq,Tk]`` additive mask of -1e9 above the diagonal, in
    ``dtype`` as autocast hands it to the op (the wrappers read it as
    float32, broadcast over B and H with stride 0)."""
    import torch
    b, h = NMT_BATCH, NMT["nhead"]
    d = NMT["d_model"] // h
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q, do = (torch.randn(b, tq, h, d, generator=g, device=DEVICE)
             .to(dtype).permute(0, 2, 1, 3) for _ in range(2))
    k, v = (torch.randn(b, tk, h, d, generator=g, device=DEVICE)
            .to(dtype).permute(0, 2, 1, 3) for _ in range(2))
    mask = None
    if bias == "causal":
        mask = torch.triu(torch.full((tq, tk), -1e9, device=DEVICE),
                          1)[None, None].to(dtype)
    return q, k, v, do, mask


def phase_kernels_flash_nmt():
    """The flash kernels at the NMT step's attention shapes
    (NMT_FLASH_CASES: the decoder's causal bias, the encoder, a
    cross-attention with Tq != Tk), forward, its statistics and backward,
    float32 and bfloat16, against the plain versions at phase 3's
    tolerances; each timed by the profiler's device ms beside its bound,
    the plain version's and SDPA's forward or backward.  Returns rows by
    direction, case and dtype."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.ops.attention import _reference_attention, \
        _reference_attention_bwd, _reference_stats

    fwd, bwd = cuda_kernels.flash_attention_fwd, \
        cuda_kernels.flash_attention_bwd
    tol = {"forward": {torch.float32: (1e-4, 1e-4),
                       torch.bfloat16: (2e-2, 0.0)},
           "backward": {torch.float32: (1e-4, 1e-4),
                        torch.bfloat16: (2e-2, 1e-2)}}
    rows = {"forward": {}, "backward": {}}
    for label, tq, tk, bias in NMT_FLASH_CASES:
        for dtype, dname in ((torch.float32, "fp32"),
                             (torch.bfloat16, "bf16")):
            q, k, v, do, mask = _nmt_attention_inputs(tq, tk, dtype, bias,
                                                      SEED + 21)
            scale = q.shape[-1] ** -0.5
            out = fwd(q, k, v, mask, scale, False)
            o, m, l = fwd(q, k, v, mask, scale, False, return_stats=True)
            got = bwd(q, k, v, mask, scale, False, o, m, l, do)
            pairs = {
                "forward": [(out, _reference_attention(q, k, v, mask, scale,
                                                       False))],
                "backward": list(zip(got, _reference_attention_bwd(
                    q, k, v, mask, scale, o, m, l, do)))}
            stats = list(zip((m, l), _reference_stats(q, k, mask, scale,
                                                      False)))
            torch.cuda.synchronize()
            shape = f"q [{NMT_BATCH},{q.shape[1]},{tq},{q.shape[-1]}], " \
                    f"k/v Tk={tk}"
            errs = {}
            for direction, prs in pairs.items():
                atol, rtol = tol[direction][dtype]
                errs[direction] = max((g.float() - w.float()).abs().max()
                                      .item() for g, w in prs)
                ok = all(torch.allclose(g.float(), w.float(), atol=atol,
                                        rtol=rtol) for g, w in prs)
                if direction == "forward":
                    ok = ok and all(torch.allclose(g, w, atol=1e-4,
                                                   rtol=1e-4)
                                    for g, w in stats)
                _p(f"flash_attention {direction} NMT {label} {dname} "
                   f"{shape}: max |err| vs plain = {errs[direction]:.3e} "
                   f"(atol={atol}, rtol={rtol}; statistics 1e-4)")
                if not ok or not np.isfinite(errs[direction]):
                    raise SystemExit(f"chip_smoke: flash_attention "
                                     f"{direction} NMT {label} {dname} "
                                     f"disagrees with its plain version")
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            with torch.enable_grad():
                lib_out = F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask, scale=scale)
            timed = {
                "forward": (
                    lambda: fwd(q, k, v, mask, scale, False),
                    lambda: _reference_attention(q, k, v, mask, scale,
                                                 False),
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=scale),
                    _flash_bound(q, k, v, mask)),
                "backward": (
                    lambda: bwd(q, k, v, mask, scale, False, o, m, l, do),
                    lambda: _reference_attention_bwd(q, k, v, mask, scale,
                                                     o, m, l, do),
                    lambda: torch.autograd.grad(lib_out, leaves, do,
                                                retain_graph=True),
                    _flash_bwd_bound(q, k, mask))}
            for direction, (kernel, plain, library, bound) in timed.items():
                row = {"max_abs_err": errs[direction],
                       "ms": _profile(kernel, 50)[1],
                       "plain_ms": _profile(plain, 10)[1],
                       "library_ms": _profile(library, 50)[1],
                       "bound_ms": bound[0], "bound_by": bound[1],
                       "q": list(q.shape), "kv": list(k.shape),
                       "bias": "[1,1,Tq,Tk] -1e9 causal" if bias else None}
                rows[direction].setdefault(label, {})[dname] = row
                _p(f"  {direction} {dname}: kernel {row['ms']:.4f} ms | "
                   f"plain {row['plain_ms']:.4f} ms | library "
                   f"(scaled_dot_product_attention) "
                   f"{row['library_ms']:.4f} ms | bound "
                   f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
            del lib_out, leaves
    torch.cuda.empty_cache()
    return rows


def phase_kernels_dropout_nmt():
    """The dropout kernels at the NMT step's shapes in bfloat16 (its
    layers' dtype under autocast), rate 0.1 upscaled: dropout, its mask
    and dropout-add at [2048, 1024], relu act-dropout and its backward at
    [2048, 4096]; phase 3e's checks, then device ms beside the bound, the
    plain version's and, for dropout, ``F.dropout``'s.  Returns the rows
    by kernel name."""
    import torch

    err = _dropout_checks("bf16 NMT", torch.bfloat16, 0.1, True,
                          (NMT_ROWS, NMT["d_model"]), SEED + 14)
    act_err = _act_dropout_checks("bf16 NMT", torch.bfloat16, "relu", 0.1,
                                  (NMT_ROWS, NMT["dim_feedforward"]),
                                  SEED + 15)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    x, r = (torch.randn(NMT_ROWS, NMT["d_model"], generator=gen,
                        device=DEVICE).to(torch.bfloat16) for _ in range(2))
    xa, ga = (torch.randn(NMT_ROWS, NMT["dim_feedforward"], generator=gen,
                          device=DEVICE).to(torch.bfloat16)
              for _ in range(2))
    clock_hz = _sm_clock_hz()
    rows = {}
    for name, (kernel, plain, library, t) in _dropout_calls(
            x, r, xa, ga, SEED + 16, 0.1, "relu").items():
        bound_ms, bound_by, binds = _dropout_bound(
            name, t.numel(), t.element_size(), clock_hz)
        rows[name] = row = {
            "max_abs_err": act_err if "act" in name else err,
            "ms": _profile(kernel, 20)[1], "plain_ms": _profile(plain, 5)[1],
            "library_ms": (_profile(library, 20)[1]
                           if name == "fused_dropout" else None),
            "bound_ms": bound_ms, "bound_by": bound_by, "binds": binds,
            "dtype": "bfloat16", "shape": list(t.shape),
            "act": "relu" if "act" in name else None}
        lib = (f" | library (F.dropout) {row['library_ms']:.4f} ms"
               if row["library_ms"] is not None else "")
        _p(f"  {name} bf16 NMT {list(t.shape)}: kernel {row['ms']:.4f} ms | "
           f"plain {row['plain_ms']:.4f} ms{lib} | bound "
           f"{bound_ms * 1e3:.2f} us ({binds})")
    del x, r, xa, ga
    torch.cuda.empty_cache()
    return rows


def _nmt_ids(batch, src_t, tgt_t, vocab, device, seed=SEED):
    """Source, target-in and target-out ids as bench.py draws them (three
    ``randint`` of ``RandomState(seed)``), int64 tensors on ``device``."""
    import torch
    rng = np.random.RandomState(seed)
    drawn = (rng.randint(0, vocab, (batch, src_t)),
             rng.randint(0, vocab, (batch, tgt_t)),
             rng.randint(0, vocab, (batch, tgt_t)))
    return [torch.from_numpy(a.astype("int64")).to(device) for a in drawn]


def _nmt_loss(model, vocab):
    """bench.py's loss: mean token cross-entropy of the logits."""
    from paddle_tpu_torch.fluid import layers as L

    def loss_fn(src, tgt_in, tgt_out):
        logits = model(src, tgt_in)
        return L.mean(L.softmax_with_cross_entropy(
            L.reshape(logits, [-1, vocab]), L.reshape(tgt_out, [-1, 1])))
    return loss_fn


def _nmt_fwd_flops_per_token():
    """bench.py main_nmt's forward FLOP a token: per encoder layer the q,
    k, v, output and FFN products and the attention's two products, per
    decoder layer those of two attentions, and the output projection
    (422,576,128 at NMT's width; a step counts 3 times this a token)."""
    d, f, seq = NMT["d_model"], NMT["dim_feedforward"], NMT_SEQ
    enc = 2 * (4 * d * d + 2 * d * f) + 2 * 2 * seq * d
    dec = 2 * (8 * d * d + 2 * d * f) + 2 * (2 * 2 * seq * d)
    return NMT["num_encoder_layers"] * (enc + dec) \
        + 2 * d * NMT["tgt_vocab"]


def _nmt_grad(model):
    """(param values, ``grad(values, src, tgt_in, tgt_out) -> (grads,
    loss)``) of bench.py's loss by ``torch.func.grad_and_value``."""
    import torch
    from paddle_tpu_torch.dygraph.functional import functional_loss

    pv, lfn = functional_loss(model, _nmt_loss(model, model.out_proj.weight
                                               .shape[1]))
    return pv, torch.func.grad_and_value(lfn)


@contextlib.contextmanager
def _nmt_without_causal_mask():
    """A broken twin: ``TransformerModel.forward`` hands the decoder no
    ``tgt_mask``, so its self-attention sees the future."""
    from paddle_tpu_torch.fluid import layers as L
    from paddle_tpu_torch.models import transformer

    orig = transformer.TransformerModel.forward

    def forward(self, src_ids, tgt_ids):
        scale = math.sqrt(self.d_model)
        src = self.pos(L.scale(self.src_emb(src_ids), scale=scale))
        tgt = self.pos(L.scale(self.tgt_emb(tgt_ids), scale=scale))
        return self.out_proj(self.transformer(src, tgt))

    transformer.TransformerModel.forward = forward
    try:
        yield
    finally:
        transformer.TransformerModel.forward = orig


def _nmt_seeded_state(state, seed):
    """Every parameter of ``state`` drawn anew from ``seed`` (matrices
    N(0, 1 / rows), LayerNorm scales 1 + N(0, 0.1²), biases N(0, 0.02²)),
    so that no two layers are equal; the sinusoid table kept."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, v in state.items():
        if name.endswith(".pe"):
            out[name] = v
        elif v.ndim == 2:
            out[name] = rng.randn(*v.shape) / np.sqrt(v.shape[0])
        elif "norm" in name and name.endswith("weight"):
            out[name] = 1 + 0.1 * rng.randn(*v.shape)
        else:
            out[name] = 0.02 * rng.randn(*v.shape)
        out[name] = np.asarray(out[name], "float32")
    return out


def _nmt_run(place, state, twin=None):
    """At NMT_HOST from ``state``, float32, dropout 0.1 live from fixed
    tracer seeds: one functional step's loss and gradients, then the
    eval logits.  ``twin``, a context manager, is held around it all."""
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.models import TransformerModel

    twin = twin or contextlib.nullcontext
    with dybase.guard(place), twin():
        tracer = dybase._dygraph_tracer()
        tracer._amp_enabled = False
        model = TransformerModel(**NMT_HOST)
        interop.layer_from_numpy(model, state)
        model.train()
        ids = _nmt_ids(NMT_HOST_BATCH, NMT_HOST_SRC, NMT_HOST_TGT,
                       NMT_HOST["tgt_vocab"], tracer.device, seed=SEED + 42)
        pv, grad_fn = _nmt_grad(model)
        tracer._seed, tracer._seed_ctr = SEED + 9, 0
        grads, loss = grad_fn(pv, *ids)
        out = {"loss": float(loss),
               "grads": [g.detach().cpu().numpy() for g in grads]}
        model.eval()
        with dybase.no_grad():
            out["logits"] = model(dybase.to_variable(ids[0]),
                                  dybase.to_variable(ids[1])).numpy()
    return out


def _nmt_card_vs_host(card):
    """NMT_HOST on the card and on the host from one seeded state,
    float32, dropout 0.1 live (the host's plain Philox draws the card's
    masks): losses within rtol 1e-4, the eval logits within 1e-4 of the
    largest, the whole first-step gradient's cosine at least 0.9999 and
    its norm within 1e-3.  A host twin whose decoder drops the causal
    mask must miss."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.models import TransformerModel

    t0 = time.perf_counter()
    np.random.seed(SEED + 40)
    with dybase.guard(fluid.CPUPlace()):
        state = _nmt_seeded_state(TransformerModel(**NMT_HOST).state_dict(),
                                  SEED + 43)
    card_r = _nmt_run(fluid.CUDAPlace(0), state)
    host_r = _nmt_run(fluid.CPUPlace(), state)
    twin_r = _nmt_run(fluid.CPUPlace(), state, twin=_nmt_without_causal_mask)

    def margins(got, want):
        """Each check's error over its tolerance (under 1 passes)."""
        cos, norm = _cosine(got["grads"], want["grads"])
        return {"loss": abs(got["loss"] - want["loss"])
                / abs(want["loss"]) / 1e-4,
                "eval logits": float(np.abs(got["logits"] - want["logits"])
                                     .max())
                / float(np.abs(want["logits"]).max()) / 1e-4,
                "gradient cosine": (1 - cos) / 1e-4,
                "gradient norm": abs(norm - 1) / 1e-3}

    ok, miss = margins(card_r, host_r), margins(twin_r, host_r)
    fmt = ", ".join
    _p(f"nmt: card vs host at vocab {NMT_HOST['tgt_vocab']}, d_model "
       f"{NMT_HOST['d_model']}, {NMT_HOST['nhead']} heads, "
       f"{NMT_HOST['num_encoder_layers']} + {NMT_HOST['num_decoder_layers']}"
       f" layers, FFN {NMT_HOST['dim_feedforward']}, source {NMT_HOST_SRC} "
       f"and target {NMT_HOST_TGT} tokens, batch {NMT_HOST_BATCH}, float32, "
       f"dropout 0.1 live, in {time.perf_counter() - t0:.1f} s: losses card "
       f"{card_r['loss']}, host {host_r['loss']}, no-mask twin "
       f"{twin_r['loss']}  [{card}]")
    _p("nmt: card vs host, error / tolerance (under 1 passes): "
       + fmt(f"{k} {v:.3e}" for k, v in ok.items()))
    _p("nmt: the no-causal-mask twin, error / tolerance (must miss, over "
       "1): " + fmt(f"{k} {v:.3e}" for k, v in miss.items()))
    if max(ok.values()) > 1:
        raise SystemExit("chip_smoke: the NMT step on the card disagrees "
                         "with the host")
    if max(miss.values()) <= 1:
        raise SystemExit("chip_smoke: the NMT card-vs-host check cannot "
                         "see the causal mask")
    return ok, miss


def phase_train_nmt(card):
    """bench.py's NMT step at NMT's full width under the card's dygraph
    tracer, bf16 autocast: ``functional_loss``, the grad program
    ``torch.func.grad_and_value`` and the update ``v - 1e-4 g`` (plain
    torch: the reference's is no kernel).  The first step's bf16 loss
    against a float32 step from the same weights and seeds; NMT_WARMUP
    warm-up steps, then NMT_STEPS timed steps with the launch counts set
    to 0 before and read after, each NMT_LAUNCHES a step; tokens/s (and
    bench.py's FLOP count), step ms, peak memory; then one eval forward
    (dropout off: 18 flash forward launches and nothing else) on the
    trained values; then ``_nmt_card_vs_host``.  Returns the launches
    and what the profile phase needs."""
    import torch
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.fluid.framework import _dygraph_tracer
    from paddle_tpu_torch.models import TransformerModel

    t0 = time.perf_counter()
    np.random.seed(SEED)
    dybase.enable_dygraph()               # the card: CUDAPlace(0)
    tracer = _dygraph_tracer()
    model = TransformerModel(**NMT)
    model.train()
    n_params = sum(p.value().numel() for p in model.parameters())
    ids = _nmt_ids(NMT_BATCH, NMT_SEQ, NMT_SEQ, NMT["tgt_vocab"],
                   tracer.device)
    pv, grad_fn = _nmt_grad(model)
    box = {"v": pv}

    def step():
        grads, loss = grad_fn(box["v"], *ids)
        box["v"] = torch._foreach_add(box["v"], grads, alpha=-NMT_LR)
        return loss

    fwd_tok = _nmt_fwd_flops_per_token()
    flops_tok = 3 * fwd_tok
    _p(f"nmt: TransformerModel({', '.join(f'{k}={v}' for k, v in NMT.items())}"
       f"), {n_params} parameters in {len(pv)} tensors, built on the card "
       f"in {time.perf_counter() - t0:.1f} s; batch {NMT_BATCH} of "
       f"{NMT_SEQ} tokens, bf16 autocast, update v - {NMT_LR} g; 3 x "
       f"{fwd_tok} FLOP a token, {flops_tok * NMT_ROWS / 1e12:.3f} TFLOP "
       f"a step (bench.py's count)")
    tracer._seed, tracer._seed_ctr = SEED + 5, 0
    tracer._amp_enabled = True
    t = time.perf_counter()
    bf16_loss = float(step())
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    tracer._seed, tracer._seed_ctr = SEED + 5, 0
    tracer._amp_enabled = False
    f32_loss = float(grad_fn(pv, *ids)[1])
    tracer._amp_enabled = True
    _p(f"nmt: first step {warm:.2f} s; its loss bf16 {bf16_loss}, float32 "
       f"{f32_loss} (rtol {BF16_LOSS_RTOL})")
    if not (np.isfinite(bf16_loss) and np.isclose(
            bf16_loss, f32_loss, rtol=BF16_LOSS_RTOL, atol=0.0)):
        raise SystemExit("chip_smoke: the bf16 NMT step's loss is not "
                         "finite or not near the float32 step's")
    for _ in range(NMT_WARMUP - 1):
        step()

    counted = _counted_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    _flash_copies_zero()
    t0 = time.perf_counter()
    losses = [step() for _ in range(NMT_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tok_s = NMT_ROWS * NMT_STEPS / wall
    _p(f"nmt: {NMT_STEPS} steps at {NMT_BATCH} x {NMT_SEQ} in {wall:.3f} s: "
       f"{wall / NMT_STEPS * 1e3:.2f} ms/step, {tok_s:.0f} tokens/s, "
       f"{tok_s * flops_tok / 1e12:.2f} TFLOP/s by bench.py's count, peak "
       f"memory {peak:.2f} GiB; losses {[round(x, 4) for x in losses]}  "
       f"[{card}]")
    want = {fn.__name__: NMT_LAUNCHES.get(fn.__name__, 0) * NMT_STEPS
            for fn in counted}
    _p(f"nmt: launches in the timed steps {launches}, expected {want} (per "
       f"step {NMT_LAUNCHES})")
    if launches != want:
        raise SystemExit("chip_smoke: the NMT step did not run through "
                         "every kernel as predicted")
    _flash_copies_check("nmt")
    if not np.isfinite(losses).all():
        raise SystemExit("chip_smoke: an NMT training loss is not finite")

    for param, value in zip(model.parameters(), box["v"]):
        param._value = value
    model.eval()
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    with dybase.no_grad():
        logits = model(dybase.to_variable(ids[0]),
                       dybase.to_variable(ids[1])).value()
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t) * 1e3
    eval_launches = {fn.__name__: fn.launches for fn in counted}
    eval_want = {fn.__name__: 18 if fn.__name__ == "flash_attention_fwd"
                 else 0 for fn in counted}
    _p(f"nmt: eval forward on the trained values {eval_ms:.2f} ms, logits "
       f"{tuple(logits.shape)} {logits.dtype}; launches {eval_launches}")
    if tuple(logits.shape) != (NMT_BATCH, NMT_SEQ, NMT["tgt_vocab"]) \
            or not bool(torch.isfinite(logits).all()) \
            or eval_launches != eval_want:
        raise SystemExit("chip_smoke: the NMT eval forward failed")
    model.train()
    _nmt_card_vs_host(card)
    tracer._seed, tracer._seed_ctr = SEED + 5, 0
    tracer._amp_enabled = True
    return launches, step


def phase_profile_nmt(step, card, iters=5):
    """Where the NMT step's time goes, as ``phase_profile`` measures it
    (host ms unprofiled, device busy ms, the idle share, device ms by
    kernel class), and the host ms each forward's causal mask takes to
    reach the card (``to_variable`` of a numpy array: a copy from pageable
    memory, which the host waits on)."""
    import torch
    from paddle_tpu_torch.models import transformer

    host_ms, busy_ms, idle, n_kern, by_class = _profile(
        lambda: step().cpu(), iters)
    cublas_ms = by_class.get("matmul (cuBLAS)", 0.0)
    tflop = 3 * _nmt_fwd_flops_per_token() * NMT_ROWS / 1e12
    _p(f"profile: NMT step, {NMT_BATCH} x {NMT_SEQ}, bf16: host "
       f"{host_ms:.3f} ms/step ({NMT_ROWS / host_ms * 1e3:.0f} tokens/s), "
       f"device busy {busy_ms:.3f} ms/step, idle share {idle:.4f}, "
       f"{n_kern:.0f} kernels/step; bench.py's {tflop:.3f} TFLOP at "
       f"{tflop / busy_ms * 1e3:.1f} TFLOP/s of busy time, cuBLAS "
       f"{cublas_ms:.3f} ms  [{card}]")
    _print_classes(by_class, "step")
    _print_top_kernels("step", iters)
    orig, spent = transformer.to_variable, []

    def timed_to_variable(value, *args, **kwargs):
        t = time.perf_counter()
        out = orig(value, *args, **kwargs)
        spent.append((time.perf_counter() - t) * 1e3)
        return out

    transformer.to_variable = timed_to_variable
    try:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    finally:
        transformer.to_variable = orig
    _p(f"profile: NMT causal mask to the card, host ms a forward "
       f"{[round(x, 4) for x in spent]}  [{card}]")
    return {"host_ms": host_ms, "busy_ms": busy_ms, "idle": idle,
            "mask_host_ms": spent}


# ---------------------------------------------------------------------------
# the vision tail: MobileNetV2 training (4j), VGG16 and MobileNetV1
# ---------------------------------------------------------------------------

def _nchw_batch(batch, size, classes, device, seed=SEED):
    """NCHW images ``randn`` and labels ``randint`` from
    ``RandomState(seed)``, as tensors on ``device``."""
    import torch
    rng = np.random.RandomState(seed)
    images = rng.randn(batch, 3, size, size).astype("float32")
    labels = rng.randint(0, classes, (batch, 1)).astype("int64")
    return (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))


@contextlib.contextmanager
def _depthwise_filters_transposed():
    """A broken twin: every grouped convolution (the depthwise ones)
    reads its filter with kh and kw swapped."""
    from paddle_tpu_torch.ops.registry import get_op

    opdef = get_op("conv2d")
    fn = opdef.fn

    def swapped(ins, attrs, ctx):
        if attrs.get("groups", 1) == 1:
            return fn(ins, attrs, ctx)
        return fn(dict(ins, Filter=[ins["Filter"][0].transpose(-1, -2)]),
                  attrs, ctx)

    opdef.fn = swapped
    try:
        yield
    finally:
        opdef.fn = fn


def _mobilenet_run(place, init, twin=None):
    """At MOBILENET_HOST from ``init``, float32: one functional step's
    loss and gradients, then eval logits from the initial weights."""
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.vision.models import mobilenet_v2

    h = MOBILENET_HOST
    twin = twin or contextlib.nullcontext
    with dybase.guard(place), twin():
        tracer = dybase._dygraph_tracer()
        model = mobilenet_v2(num_classes=h["num_classes"])
        interop.layer_from_numpy(model, init)
        model.train()
        images, labels = _nchw_batch(h["batch"], h["size"], h["num_classes"],
                                     tracer.device, seed=SEED + 44)
        loss, grads = _functional_resnet_step(model)(images, labels)
        out = {"loss": float(loss),
               "grads": [g.detach().cpu().numpy() for g in grads]}
        interop.layer_from_numpy(model, init)
        model.eval()
        with dybase.no_grad():
            out["logits"] = model(dybase.to_variable(images)).numpy()
    return out


def _mobilenet_card_vs_host(card):
    """MOBILENET_HOST on the card and on the host from one state, float32:
    the loss within rtol 1e-4, the first-step gradient as a whole (cosine
    >= 0.99, norms within 2%: phase 4h's limits), eval logits within 1e-4
    of the largest.  A host twin whose depthwise convolutions read their
    filters transposed must miss."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.vision.models import mobilenet_v2

    t0 = time.perf_counter()
    h = MOBILENET_HOST
    np.random.seed(SEED + 46)
    with dybase.guard(fluid.CUDAPlace(0)):
        init = mobilenet_v2(num_classes=h["num_classes"]).state_dict()
    runs = {"card": _mobilenet_run(fluid.CUDAPlace(0), init),
            "host": _mobilenet_run(fluid.CPUPlace(), init),
            "twin": _mobilenet_run(fluid.CPUPlace(), init,
                                   twin=_depthwise_filters_transposed)}

    def margins(got, want):
        cos, norm = _cosine(got["grads"], want["grads"])
        return {"loss": abs(got["loss"] - want["loss"])
                / abs(want["loss"]) / 1e-4,
                "gradient cosine": (1 - cos) / 0.01,
                "gradient norms": abs(norm - 1) / 0.02,
                "eval logits": float(np.abs(got["logits"] - want["logits"])
                                     .max())
                / float(np.abs(want["logits"]).max()) / 1e-4}

    ok = margins(runs["card"], runs["host"])
    miss = margins(runs["twin"], runs["host"])
    fmt = ", ".join
    _p(f"mobilenet: card vs host, MobileNetV2 {h['size']}x{h['size']}, "
       f"batch {h['batch']}, {h['num_classes']} classes, float32, in "
       f"{time.perf_counter() - t0:.1f} s: losses "
       + fmt(f"{k} {r['loss']}" for k, r in runs.items()) + f"  [{card}]")
    _p("mobilenet: card vs host, error / tolerance (under 1 passes): "
       + fmt(f"{k} {v:.3e}" for k, v in ok.items()))
    _p("mobilenet: the transposed-depthwise-filter twin, error / tolerance "
       "(must miss, over 1): " + fmt(f"{k} {v:.3e}" for k, v in miss.items()))
    if max(ok.values()) > 1:
        raise SystemExit("chip_smoke: MobileNetV2 on the card disagrees "
                         "with the host")
    if max(miss.values()) <= 1:
        raise SystemExit("chip_smoke: the MobileNetV2 card-vs-host check "
                         "cannot see the depthwise convolutions")


def _eval_card_vs_host(card):
    """EVAL_HOST's models (VGG16 at 224², batch 2; MobileNetV1 at 64²,
    batch 4; 1000 classes) built on the card, their weights carried to
    the host: eval logits within 1e-4 of the largest, float32."""
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.vision import models

    for name, size, batch in EVAL_HOST:
        t0 = time.perf_counter()
        np.random.seed(SEED + 47)
        logits, state = {}, None
        for key, place in (("card", fluid.CUDAPlace(0)),
                           ("host", fluid.CPUPlace())):
            with dybase.guard(place):
                model = getattr(models, name)(num_classes=1000)
                if state is None:
                    state = model.state_dict()
                interop.layer_from_numpy(model, state)
                model.eval()
                images, _ = _nchw_batch(batch, size, 1000,
                                        dybase._dygraph_tracer().device,
                                        seed=SEED + 48)
                with dybase.no_grad():
                    logits[key] = model(dybase.to_variable(images)).numpy()
            del model
        err = float(np.abs(logits["card"] - logits["host"]).max()) \
            / float(np.abs(logits["host"]).max())
        _p(f"{name}: eval logits at {size}x{size}, batch {batch}, float32, "
           f"card vs host: max |err| / largest {err:.3e} (tolerance 1e-4), "
           f"in {time.perf_counter() - t0:.1f} s  [{card}]")
        if not err <= 1e-4:
            raise SystemExit(f"chip_smoke: {name}'s eval logits on the card "
                             f"disagree with the host's")


def phase_train_mobilenet(card):
    """MobileNetV2 at MOBILENET's full width, NCHW, bf16 autocast, the
    functional step of phase 4h on one fixed batch of MOBILENET_BATCH:
    one warm-up step, MOBILENET_STEPS timed steps (host ms, images/s,
    peak memory; finite losses; no hand-written kernel launches: the
    depthwise convolutions are PyTorch's library kernels, relu6 and batch
    norm PyTorch ops), then one eval forward; then ``_mobilenet_card_vs_host``
    and ``_eval_card_vs_host``.  Returns what the profile phase needs."""
    import torch
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.fluid.framework import _dygraph_tracer
    from paddle_tpu_torch.vision.models import mobilenet_v2

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    np.random.seed(SEED)
    dybase.enable_dygraph()               # the card: CUDAPlace(0)
    tracer = _dygraph_tracer()
    tracer._amp_enabled = True
    model = mobilenet_v2(**MOBILENET)
    model.train()
    n_params = sum(p.value().numel() for p in model.parameters())
    images, labels = _nchw_batch(MOBILENET_BATCH, MOBILENET_SIZE,
                                 MOBILENET["num_classes"], tracer.device)
    _p(f"mobilenet: mobilenet_v2({', '.join(f'{k}={v}' for k, v in MOBILENET.items())}), "
       f"{n_params} parameters in {len(model.parameters())} tensors, "
       f"{len(model.buffers())} buffers, built on the card in "
       f"{time.perf_counter() - t0:.1f} s; batch {MOBILENET_BATCH} of "
       f"{MOBILENET_SIZE}x{MOBILENET_SIZE}x3 NCHW, bf16 autocast, SGD "
       f"momentum {RESNET_MU} lr {RESNET_LR}")
    counted = _counted_kernels()
    fstep = _functional_resnet_step(model)
    t = time.perf_counter()
    first = float(fstep(images, labels)[0])
    torch.cuda.synchronize()
    _p(f"mobilenet: warm-up step {time.perf_counter() - t:.2f} s, loss "
       f"{first}")
    for fn in counted:
        fn.launches = 0
    losses = [float(loss) for loss, _ in _timed_steps(
        "mobilenet functional step", lambda: fstep(images, labels),
        MOBILENET_STEPS, MOBILENET_BATCH, card)]
    launches = {fn.__name__: fn.launches for fn in counted}
    _p(f"mobilenet: losses {[round(x, 4) for x in [first] + losses]}; "
       f"hand-written kernel launches {launches} (none expected)")
    if not np.isfinite(losses).all() or any(launches.values()):
        raise SystemExit("chip_smoke: the MobileNetV2 steps failed")
    model.eval()

    def evaluate():
        with dybase.no_grad():
            return model(dybase.to_variable(images)).value()

    logits = _timed_steps("mobilenet eval forward", evaluate, 1,
                          MOBILENET_BATCH, card)[0]
    if tuple(logits.shape) != (MOBILENET_BATCH, MOBILENET["num_classes"]) \
            or not bool(torch.isfinite(logits).all()):
        raise SystemExit("chip_smoke: the MobileNetV2 eval logits are not "
                         "finite or not of their shape")
    model.train()
    _mobilenet_card_vs_host(card)
    _eval_card_vs_host(card)
    tracer._amp_enabled = True
    return model, fstep, (images, labels)


def phase_profile_mobilenet(trained, card, iters=3):
    """Where the MobileNetV2 step's time goes, as ``phase_profile``
    measures it, with its peak memory."""
    import torch

    model, fstep, (images, labels) = trained
    model.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host_ms, busy_ms, idle, n_kern, by_class = _profile(
        lambda: fstep(images, labels)[0].cpu(), iters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _p(f"profile: MobileNetV2 functional step, {MOBILENET_BATCH} x "
       f"{MOBILENET_SIZE}^2, bf16: host {host_ms:.3f} ms/step "
       f"({MOBILENET_BATCH / host_ms * 1e3:.1f} images/s), device busy "
       f"{busy_ms:.3f} ms/step, idle share {idle:.4f}, {n_kern:.0f} "
       f"kernels/step, peak memory {peak:.2f} GiB  [{card}]")
    _print_classes(by_class, "step")
    _print_top_kernels("step", iters)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the decode path: paged attention (3f), decode serving (4f), its profile
# ---------------------------------------------------------------------------

def _paged_inputs(b, case, seed):
    """q ``[b, d]``, K/V pools ``[R, d]``, a page table ``[b, S]`` int32
    that gives each slot S / page_size distinct pages of a random page
    permutation (page 0, the scratch page, left out) and a float32 mask
    ``[b, S]``: every position valid (``full``), ragged prefix lengths 1
    to S (``ragged``), a random non-prefix mask with one valid position
    at least (``non-prefix``), ragged with row 0 all masked
    (``all-masked row``), or the first DECODE_PROFILE_POS positions of
    every slot (``300 valid``, the decode step profile's mask)."""
    import torch
    d, s, r, ps = (PAGED["d"], PAGED["seq"], PAGED["rows"],
                   PAGED["page_size"])
    dev = torch.device(DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(b, d, generator=g, device=dev)
    kp = torch.randn(r, d, generator=g, device=dev)
    vp = torch.randn(r, d, generator=g, device=dev)
    per_seq = s // ps
    perm = torch.randperm(r // ps - 1, generator=g, device=dev) + 1
    pages = perm[:b * per_seq].reshape(b, per_seq)
    idx = (pages[:, :, None] * ps
           + torch.arange(ps, device=dev)).reshape(b, s).int()
    pos = torch.arange(s, device=dev)[None, :]
    if case == "full":
        valid = torch.ones(b, s, device=dev)
    elif case == "300 valid":
        valid = (pos < DECODE_PROFILE_POS).float().expand(b, s)
    elif case == "non-prefix":
        valid = (torch.rand(b, s, generator=g, device=dev) < 0.5).float()
        valid[:, 0] = 1.0
    else:
        lengths = torch.randint(1, s + 1, (b, 1), generator=g, device=dev)
        valid = (pos < lengths).float()
        if case == "all-masked row":
            valid[0] = 0.0
    return q, kp, vp, idx, valid.contiguous()


def _paged_bound(b, valid):
    """Least time of one paged-attention call on this card: the bytes it
    must move, the K and V rows of the valid positions (this run's
    masks) plus q, out, the page table and the mask, at HBM bandwidth;
    its operations (4·B·S·d, counted over every position) at the float32
    peak.  Bytes bind."""
    d, s = PAGED["d"], PAGED["seq"]
    n_valid = float(valid.sum())
    nbytes = n_valid * d * 8 + 2 * b * d * 4 + 2 * b * s * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * b * s * d / FLOPS_PER_S["float32"] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def _l2_flush():
    """A call that reads a 64 MB scratch buffer, more than the card's 50
    MB L2, so that the next kernel finds its inputs in device memory as
    a decode step does (each step's head product alone reads 94 MB of
    weights); it writes nothing back, so the next kernel pays for no
    dirty lines."""
    import torch
    buf = torch.zeros(16 * 2 ** 20, dtype=torch.float32, device=DEVICE)
    return buf.argmax


def _cold_ms(fn, flush, flush_ms, iters, label=None):
    """Device ms per call of ``fn`` with the L2 flushed before each call:
    the profiler's ``label`` class, or the busy ms of flush and call
    less ``flush_ms``, the flush's own busy ms per call."""
    _, busy, _, _, by_class = _profile(lambda: (flush(), fn()), iters)
    return by_class.get(label, 0.0) if label else busy - flush_ms


PAGED_CASES = ("full", "ragged", "non-prefix", "all-masked row", "300 valid")


def phase_kernels_paged(card):
    """The paged-attention kernel against its plain version
    (``_paged_reference``) at the decode path's shapes: B in PAGED
    ["slots"], S = 512 positions, pools of R = 16,400 rows of d = 768,
    float32, a random page permutation; masks all valid, ragged, non-
    prefix, with an all-masked row, and 300 of 512 valid.  Tolerance:
    1e-5 of the largest |out|.  A twin whose page table is rolled by one
    page must miss by 10 times that.  Device ms per call from the
    profiler, cold (the L2 flushed before each call, the decode step's
    case) and warm (back to back on the same inputs),
    beside the bound, the plain version's and the library pair's (two
    ``index_select`` and ``scaled_dot_product_attention`` with a boolean
    mask over the gathered rows, timed here only), all valid at every B
    and 300 valid at the largest.  Returns the rows by B and, under
    ``(B, "300 valid")``, the partly valid row."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.ops.attention import _paged_reference

    d, s = PAGED["d"], PAGED["seq"]
    scale, neg = d ** -0.5, 1e30
    kernel = cuda_kernels.paged_attention
    flush = _l2_flush()
    _, flush_ms, _, flush_kernels, flush_classes = _profile(flush, 50)
    rows = {}
    for b in PAGED["slots"]:
        for case in PAGED_CASES:
            q, kp, vp, idx, valid = _paged_inputs(b, case, SEED + 31 + b)
            out = kernel(q, kp, vp, idx, valid, scale, neg)
            ref = _paged_reference(q, kp, vp, idx, valid, scale, neg)
            twin = kernel(q, kp, vp, torch.roll(idx, PAGED["page_size"], 1)
                          .contiguous(), valid, scale, neg)
            torch.cuda.synchronize()
            tol = 1e-5 * ref.abs().max().item()
            err = (out - ref).abs().max().item()
            # a roll of the page table keeps the set of rows an all-valid
            # or all-masked row reads, and so its answer: the twin is read
            # on the other rows
            n_valid = valid.sum(1)
            mixed = (n_valid > 0) & (n_valid < s)
            off = ((twin - ref)[mixed].abs().max().item() if bool(mixed.any())
                   else None)
            _p(f"paged_attention B={b} {case} [S={s}, R={PAGED['rows']}, "
               f"d={d}]: max |err| vs plain = {err:.3e} against 1e-5 x max "
               f"|out| = {tol:.3e}; the rolled-page twin misses by "
               + (f"{off:.3e}" if off is not None else "(no partly masked "
                  "row)"))
            if not np.isfinite(err) or err > tol:
                raise SystemExit(f"chip_smoke: paged_attention B={b} {case} "
                                 f"disagrees with its plain version")
            if off is not None and off < 10 * tol:
                raise SystemExit(f"chip_smoke: the paged_attention check "
                                 f"B={b} {case} cannot tell the right "
                                 f"pages from the wrong ones")
            if case != "full" and (case, b) != ("300 valid",
                                                max(PAGED["slots"])):
                continue
            ii = idx.reshape(-1).long()
            vb = valid.bool().reshape(b, 1, 1, s)

            def library():
                kg = kp.index_select(0, ii).reshape(b, 1, s, d)
                vg = vp.index_select(0, ii).reshape(b, 1, s, d)
                return F.scaled_dot_product_attention(
                    q.reshape(b, 1, 1, d), kg, vg, attn_mask=vb, scale=scale)

            def call():
                return kernel(q, kp, vp, idx, valid, scale, neg)

            def plain():
                return _paged_reference(q, kp, vp, idx, valid, scale, neg)

            lib_err = (library().reshape(b, d) - ref).abs().max().item()
            label = "paged_attention (csrc)"
            row = {"max_abs_err": err,
                   "ms": _cold_ms(call, flush, flush_ms, 50, label),
                   "warm_ms": _profile(call, 50)[1],
                   "plain_ms": _cold_ms(plain, flush, flush_ms, 10),
                   "plain_warm_ms": _profile(plain, 10)[1],
                   "library_ms": _cold_ms(library, flush, flush_ms, 50),
                   "library_warm_ms": _profile(library, 50)[1],
                   "n_valid": int(n_valid.sum().item())}
            row["bound_ms"], row["bound_by"] = _paged_bound(b, valid)
            rows[b if case == "full" else (b, case)] = row
            _p(f"  B={b} {case}: kernel cold {row['ms']:.4f} ms, warm "
               f"{row['warm_ms']:.4f} | plain cold {row['plain_ms']:.4f}, "
               f"warm {row['plain_warm_ms']:.4f} | library (2 x "
               f"index_select + scaled_dot_product_attention, max |err| "
               f"{lib_err:.1e}) cold {row['library_ms']:.4f}, warm "
               f"{row['library_warm_ms']:.4f} | bound "
               f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}; "
               f"{row['n_valid']} valid positions)  [{card}]")
    _p(f"  (cold: a 64 MB buffer read before each call; the kernel's "
       f"cold ms is its own class, the plain and library cold ms the "
       f"window's busy ms less the flush's alone, {flush_ms:.4f} ms in "
       f"{flush_kernels:g} kernels a call: "
       + ", ".join(f"{c} {ms:.4f}" for c, ms in flush_classes.items())
       + ")")
    torch.cuda.empty_cache()
    return rows


def _decode_model(executor, scope):
    """The demo decode model at DECODE width, as a user plugs a model
    into ``DecodeModel``: the demo's decode and prefill programs as they
    are, and paged and verify builders that apply ``fuse_paged_attention``
    (the BuildStrategy knob's pass list) to the demo's paged program and
    to its speculative verify program, so each step's, and each verify
    block's, attention is one ``paged_attention`` op.  Returns the model
    and a dict that lists the programs built: ``"paged"`` their pool rows,
    ``"verify"`` (pool rows, k, the pass's rewrites, paged_attention ops,
    softmax ops) of each."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import trace
    from paddle_tpu_torch.fluid.passes import (PassPipeline,
                                               passes_for_build_strategy)
    from paddle_tpu_torch.serving import decode

    demo = decode.build_demo_decode_model(seed=SEED, executor=executor,
                                          scope=scope, **DECODE)
    built = {"paged": [], "verify": []}
    bs = fluid.BuildStrategy()
    bs.fuse_paged_attention = True
    rewrites = trace.metrics().counter(
        "kernel_tier.fuse_paged_attention.rewrites")

    def paged_builder(pool_rows):
        prog, logits_name = demo.paged_program(pool_rows)
        PassPipeline(passes_for_build_strategy(bs)).apply(
            prog, targets=[logits_name])
        built["paged"].append(pool_rows)
        return prog, logits_name

    def verify_builder(pool_rows, k):
        prog, names = demo.verify_program(pool_rows, k)
        r0 = rewrites.value
        PassPipeline(passes_for_build_strategy(bs)).apply(prog,
                                                          targets=names)
        types = [op.type for op in prog.global_block().ops]
        built["verify"].append((pool_rows, k, rewrites.value - r0,
                                types.count("paged_attention"),
                                types.count("softmax")))
        return prog, names

    model = decode.DecodeModel(
        executor, scope, demo.decode_program, demo.logits_name,
        demo.vocab, demo.d_model, demo.max_len, demo.prefill_program,
        paged_builder=paged_builder, verify_builder=verify_builder,
        page_size=demo.page_size)
    return model, built


def _decode_attention_peaks(arrays, prompts):
    """The largest attention probability of each prompt's last query
    over its own positions, from the weights in ``arrays`` (host numpy,
    float64): 1/len when attention is uniform, 1 when one-hot."""
    out = []
    scale = DECODE["d_model"] ** -0.5
    for p in prompts:
        x = arrays["dec_emb"][np.asarray(p)].astype(np.float64)
        q = x[-1] @ arrays["dec_wq"] + arrays["dec_bq"]
        k = x @ arrays["dec_wk"] + arrays["dec_bk"]
        s = k @ q * scale
        e = np.exp(s - s.max())
        out.append((len(p), float(e.max() / e.sum())))
    return out


def _decode_traffic():
    """DECODE_REQUESTS prompts and budgets from SEED: a DECODE_SHARED
    share repeat a prefix of 8 full pages plus one unique tail token
    (tools/serve_bench.py decode_workload's page-granular sharing), the
    rest are unique prompts of 16 to 256 tokens; max_new 32 to 128."""
    rng = np.random.default_rng(SEED + 41)
    vocab, ps = DECODE["vocab"], DECODE["page_size"]
    prefix = rng.integers(0, vocab, 8 * ps).tolist()
    n_shared = int(round(DECODE_SHARED * DECODE_REQUESTS))
    shared = set(rng.permutation(DECODE_REQUESTS)[:n_shared].tolist())
    prompts, budgets = [], []
    for i in range(DECODE_REQUESTS):
        if i in shared:
            prompts.append(prefix + [int(rng.integers(0, vocab))])
        else:
            prompts.append(rng.integers(
                0, vocab, int(rng.integers(16, 257))).tolist())
        budgets.append(int(rng.integers(32, 129)))
    return prompts, budgets, sorted(shared)


def _host_decode(arrays, prompts, twin=False):
    """Decode ``prompts`` (DECODE_HOST_NEW tokens each) on the host with
    the card's weights: the same fused paged model on ``CPUPlace``, the
    plain versions, a DECODE_HOST_POOL-page pool.  The ``twin`` reads
    each slot through a page table rolled by one page: its writes land in
    the right rows, its reads in the wrong ones."""
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.serving import decode

    host = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    model, _ = _decode_model(host, scope)
    interop.scope_from_numpy(arrays, scope, fluid.CPUPlace())
    eng = decode.DecodeEngine(model, max_batch=len(prompts),
                              collect_logits=True, paged=True,
                              prefix_cache=True,
                              pool_pages=DECODE_HOST_POOL)
    if twin:
        import torch
        rebuild = eng._rebuild_buffers

        def rolled():
            rebuild()
            pt = eng._scope.find_var(model.pt_name)
            eng._scope.set_var(model.pt_name, torch.roll(
                pt, eng.page_size, 1).contiguous())

        eng._rebuild_buffers = rolled
    with eng:
        futs = [eng.submit(p, max_new_tokens=DECODE_HOST_NEW)
                for p in prompts]
        return [f.result(timeout=600) for f in futs]


def _same_decode(label, got, want, tol_rel, n=None):
    """(tokens equal, max |logit err|, tolerance) of two decode results,
    over their first ``n`` tokens."""
    n = n or len(want["tokens"])
    toks = np.array_equal(got["tokens"][:n], want["tokens"][:n])
    err = float(np.abs(got["logits"][:n] - want["logits"][:n]).max())
    tol = tol_rel * float(np.abs(want["logits"][:n]).max())
    _p(f"  {label}: tokens {'identical' if toks else 'DIFFER'}, max "
       f"|logit err| {err:.3e} against {tol_rel} x max |logit| = "
       f"{tol:.3e}")
    return toks and err <= tol, err


def phase_serve_decode(card):
    """The decode path at DECODE width on the card: the demo model with
    its Q and K projections scaled by DECODE_QK_GAIN, ``fuse_paged_
    attention`` applied (one rewrite per paged program built), served by
    ``DecodeEngine(paged=True, prefix_cache=True, max_batch=32)`` with
    its default pool of 1025 pages.  Warmup, then DECODE_REQUESTS
    requests, half at once and half after the first tokens; the kernel's
    launches must equal the engine's paged steps.  Card against card: 4
    requests through ``decode_sequential`` (the dense program, no
    kernel); card against host: 2 requests on a host paged engine; a
    host twin with wrong page tables must miss.  Returns the launches
    and what the profile needs."""
    import torch
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.fluid import trace
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.serving import decode

    t0 = time.perf_counter()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    model, built_all = _decode_model(exe, scope)
    for name in ("dec_wq", "dec_wk"):
        scope.find_var(name).mul_(DECODE_QK_GAIN)
    arrays = interop.scope_to_numpy(
        scope, [p.name for p in model.decode_program.all_parameters()])
    prompts, budgets, shared = _decode_traffic()
    peaks = _decode_attention_peaks(arrays, [prompts[shared[0]]] + [
        prompts[i] for i in range(DECODE_REQUESTS) if i not in shared][:2])
    _p(f"serve decode: demo model vocab {DECODE['vocab']}, d_model "
       f"{DECODE['d_model']}, max_len {DECODE['max_len']}, page "
       f"{DECODE['page_size']}; startup on the card (seed {SEED}), Q and K "
       f"weights x {DECODE_QK_GAIN}, in {time.perf_counter() - t0:.1f} s; "
       f"largest attention probability of a prompt's last query: "
       + ", ".join(f"{p:.4f} over {n} positions (uniform {1 / n:.4f})"
                   for n, p in peaks))

    rewrites = trace.metrics().counter(
        "kernel_tier.fuse_paged_attention.rewrites")
    r0 = rewrites.value
    eng = decode.DecodeEngine(model, max_batch=DECODE_MAX_BATCH,
                              collect_logits=True, name="chip_smoke",
                              paged=True, prefix_cache=True)
    warm = eng.warmup()
    prog, _ = model.paged_program(eng._pool_rows)
    types = [op.type for op in prog.global_block().ops]
    n_rewrites = rewrites.value - r0
    built = built_all["paged"]
    _p(f"serve decode: pool {eng.pool_pages} pages x {eng.page_size} rows "
       f"x {DECODE['d_model']} (k and v {eng._pool_rows * DECODE['d_model'] * 4 / 1e6:.1f} "
       f"MB each); paged programs built {len(built)}, fuse_paged_attention "
       f"rewrites {n_rewrites}, paged_attention ops "
       f"{types.count('paged_attention')}; warmup of decode buckets "
       f"{warm['decode_buckets']} and prefill buckets "
       f"{warm['prefill_buckets']} took {warm['seconds']:.2f} s")
    if n_rewrites != len(built) or len(built) != 1 \
            or types.count("paged_attention") != 1 or "softmax" in types:
        raise SystemExit("chip_smoke: fuse_paged_attention did not rewrite "
                         "the paged program's attention")
    torch.cuda.synchronize()
    cuda_kernels.paged_attention.launches = 0
    half = DECODE_REQUESTS // 2
    with eng:
        t0 = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts[:half], budgets[:half])]
        # the first tokens back (or a failed loop, which rejects them)
        while eng.stats()["tokens"] == 0 and not any(f.done()
                                                     for f in futs):
            time.sleep(0.001)
        futs += [eng.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts[half:], budgets[half:])]
        out = [f.result(timeout=900) for f in futs]
        wall = time.perf_counter() - t0
        st = eng.stats()
    launches = cuda_kernels.paged_attention.launches
    for r, p, n in zip(out, prompts, budgets):
        if r["tokens"].shape != (n,) or r["logits"].shape != \
                (n, DECODE["vocab"]) or not np.isfinite(r["logits"]).all():
            raise SystemExit("chip_smoke: a decode request came back with "
                             "the wrong shape or non-finite logits")
    tokens = sum(budgets)
    ttft, step = st["ttft_seconds"], st["step_seconds"]
    _p(f"serve decode: {len(out)} requests ({len(shared)} share a "
       f"{8 * DECODE['page_size']}-token prefix), {tokens} tokens in "
       f"{wall:.3f} s = {tokens / wall:.1f} tokens/s; TTFT p50 "
       f"{ttft['p50'] * 1e3:.2f} ms, p99 {ttft['p99'] * 1e3:.2f} ms, step "
       f"p50 {step['p50'] * 1e3:.2f} ms (histogram estimates); steps "
       f"{st['steps']}, prefills {st['prefills']}, peak slots "
       f"{st['peak_active']}, prefix hits {st['paged']['prefix_hits']} "
       f"pages, pages in use after {st['paged']['kv_pages_in_use']}  "
       f"[{card}]")
    _p(f"serve decode: paged_attention launches = {launches}, paged steps "
       f"= {st['steps']}")
    if st["tokens"] != tokens or launches != st["steps"] or launches < 1:
        raise SystemExit("chip_smoke: the decode path did not launch the "
                         "paged-attention kernel once per paged step")
    if st["paged"]["prefix_hits"] < 1:
        raise SystemExit("chip_smoke: no request hit the prefix cache")

    # card against card: decode_sequential, the dense program
    picks = shared[-2:] + [i for i in range(DECODE_REQUESTS)
                           if i not in shared][-2:]
    seq = decode.decode_sequential(model, [prompts[i] for i in picks],
                                   max_new_tokens=[budgets[i] for i in picks])
    ok = True
    for i, want in zip(picks, seq):
        ok &= _same_decode(f"request {i} (prompt {len(prompts[i])}, "
                           f"{budgets[i]} new) paged card vs sequential "
                           f"card", out[i], want, 1e-4)[0]
    if not ok:
        raise SystemExit("chip_smoke: paged decode on the card disagrees "
                         "with decode_sequential on the card")

    # card against host, and the host twin that reads the wrong pages
    picks = [shared[-1], picks[-1]]
    host = _host_decode(arrays, [prompts[i] for i in picks])
    twin = _host_decode(arrays, [prompts[i] for i in picks], twin=True)
    ok, missed = True, True
    for i, h, t in zip(picks, host, twin):
        ok &= _same_decode(f"request {i} card vs host ({DECODE_HOST_NEW} "
                           f"tokens)", out[i], h, 1e-4, DECODE_HOST_NEW)[0]
        missed &= not _same_decode(f"request {i} card vs the wrong-page "
                                   f"twin", out[i], t, 1e-4,
                                   DECODE_HOST_NEW)[0]
    if not ok:
        raise SystemExit("chip_smoke: paged decode on the card disagrees "
                         "with the host")
    if not missed:
        raise SystemExit("chip_smoke: the decode card-vs-host check cannot "
                         "tell the right pages from the wrong ones")
    return launches, (model, eng), {"out": out, "arrays": arrays,
                                    "built": built_all, "wall": wall,
                                    "stats": st}


def _zero_counts():
    for fn in _counted_kernels():
        fn.launches = 0


def _read_counts():
    return {fn.__name__: fn.launches for fn in _counted_kernels()}


def _spec_serve(eng, prompts, budgets):
    """Phase 4f's traffic through ``eng`` (made with ``auto_start=False``):
    half the requests queued before its loop starts, so they are admitted
    together, and the rest after the first tokens.  Returns (results,
    wall s, stats)."""
    half = len(prompts) // 2
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(prompts[:half], budgets[:half])]
    with eng:
        while eng.stats()["tokens"] == 0 and not any(f.done()
                                                     for f in futs):
            time.sleep(0.001)
        futs += [eng.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts[half:], budgets[half:])]
        out = [f.result(timeout=900) for f in futs]
        wall = time.perf_counter() - t0
        st = eng.stats()
    if not all(f.trace_id and f.trace_id.startswith("dec-") for f in futs):
        raise SystemExit("chip_smoke: a decode future has no trace_id")
    return out, wall, st


def _logit_agreement(out, ref):
    """(every request's logits bit for bit, requests bit for bit, max
    |logit err|, max |logit|) of two decode results whose tokens agree."""
    same = [np.array_equal(a["logits"], b["logits"])
            for a, b in zip(out, ref)]
    err = max(float(np.abs(a["logits"] - b["logits"]).max())
              for a, b in zip(out, ref))
    scale = max(float(np.abs(b["logits"]).max()) for b in ref)
    return all(same), sum(same), err, scale


def _spec_report(label, out, ref, wall, st, counts, card):
    """Print a speculative leg's throughput, TTFT, rounds, accept rate and
    whether its tokens equal phase 4f's; returns that."""
    sp = st["paged"]
    tokens = sum(len(r["tokens"]) for r in ref)
    toks_ok = all(np.array_equal(a["tokens"], b["tokens"])
                  for a, b in zip(out, ref))
    ttft, step = st["ttft_seconds"], st["step_seconds"]
    _p(f"{label}: {len(out)} requests, {tokens} tokens in {wall:.3f} s = "
       f"{tokens / wall:.1f} tokens/s; TTFT p50 {ttft['p50'] * 1e3:.2f} ms, "
       f"p99 {ttft['p99'] * 1e3:.2f} ms; verify rounds {st['steps']}, "
       f"round p50 {step['p50'] * 1e3:.2f} ms (histogram estimates), "
       f"prefills {st['prefills']}, prefix hits {sp['prefix_hits']} pages; "
       f"proposed {sp['spec_proposed']}, accepted {sp['spec_accepted']}, "
       f"accept rate {sp['spec_accept_rate']}  [{card}]")
    _p(f"{label}: tokens {'identical to' if toks_ok else 'DIFFER from'} "
       f"phase 4f's paged output for all {len(out)} requests; launches "
       f"{counts}")
    return toks_ok


def _shifted_verify_executor():
    """A host executor whose verify runs hand back each block's logits
    one position late: block j gets block j + 1's (the last block the
    first's), the off-by-one a verify that mislabels its windows makes."""
    from paddle_tpu_torch import fluid

    class Shifted(fluid.Executor):
        def run(self, program=None, feed=None, **kw):
            out = super().run(program, feed=feed, **kw)
            if feed and "toks" in feed:
                out = list(out[1:]) + list(out[:1])
            return out

    return Shifted(fluid.CPUPlace())


def _host_spec_decode(arrays, prompts, twin=False):
    """Decode ``prompts`` (DECODE_HOST_NEW tokens each) on the host with
    the card's weights through a self-drafting speculative engine: the
    fused model on ``CPUPlace``, the plain versions, a DECODE_HOST_POOL-
    page pool.  The ``twin`` reads each verify block's logits one position
    late."""
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.serving import decode

    host = _shifted_verify_executor() if twin \
        else fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    model, _ = _decode_model(host, scope)
    interop.scope_from_numpy(arrays, scope, fluid.CPUPlace())
    eng = decode.DecodeEngine(model, max_batch=len(prompts),
                              collect_logits=True, paged=True,
                              prefix_cache=True, draft_model=model,
                              spec_k=DECODE_SPEC_K,
                              pool_pages=DECODE_HOST_POOL)
    with eng:
        futs = [eng.submit(p, max_new_tokens=DECODE_HOST_NEW)
                for p in prompts]
        return [f.result(timeout=900) for f in futs]


def _verify_round_profile(model, eng, card, iters=20):
    """One verify program at DECODE_MAX_BATCH slots, each holding
    DECODE_PROFILE_POS valid positions on its own pages, as phase 5's
    decode profile runs the plain step."""
    import torch
    from paddle_tpu_torch import fluid

    prog, names = model.verify_program(eng._pool_rows, DECODE_SPEC_K)
    scope = fluid.Scope(parent=model.scope)
    dev = model.executor.device
    for name in (model.k_pool_name, model.v_pool_name):
        scope.set_var(name, torch.randn(eng._pool_rows, model.d_model,
                                        device=dev))
    ps, s, n, k = model.page_size, model.max_len, DECODE_MAX_BATCH, \
        DECODE_SPEC_K
    per_seq = s // ps
    rng = np.random.RandomState(SEED + 71)
    pages = rng.permutation(eng.pool_pages - 1)[:n * per_seq] + 1
    pt = (pages.reshape(n, per_seq, 1) * ps
          + np.arange(ps)).reshape(n, s).astype(np.int32)
    scope.set_var(model.pt_name, torch.from_numpy(pt).to(dev))
    pos = DECODE_PROFILE_POS
    feed = {"toks": rng.randint(0, model.vocab, (n, k)).astype(np.int64),
            "widx": pt[:, pos:pos + k].astype(np.int64),
            "pos": np.full((n, 1), float(pos), np.float32),
            "arange": np.arange(s, dtype=np.float32)[None, :]}

    def step():
        return model.executor.run(prog, feed=feed, fetch_list=names,
                                  scope=scope, return_numpy=True)

    host_ms, busy_ms, idle, n_kern, by_class = _profile(step, iters)
    pool_mb = eng._pool_rows * model.d_model * 4 / 1e6
    _p(f"speculative: one verify round of {k} blocks at {n} slots, "
       f"position {pos}: host {host_ms:.3f} ms, device busy {busy_ms:.3f} "
       f"ms, idle share {idle:.4f}, {n_kern:.0f} kernels; each block "
       f"rewrites both pools ({2 * pool_mb:.1f} MB), a round moves at least "
       f"{2 * 2 * k * pool_mb:.1f} MB of pool traffic  [{card}]")
    _print_classes(by_class, "round")
    return host_ms, busy_ms


def _bert_request(rng, n):
    """One request of ``n`` rows to phase 4's program: random ids, each
    row attending to a random prefix."""
    seq = BERT_BASE["seq"]
    lengths = rng.randint(1, seq + 1, n)
    return {"ids": rng.randint(0, BERT_BASE["vocab"], (n, seq))
            .astype("int64"),
            "attn_mask": (np.arange(seq)[None, :] < lengths[:, None])
            .astype("float32")}


def _slo_requests():
    rng = np.random.RandomState(SEED + 61)
    return [_bert_request(rng, n)
            for n in rng.choice(ROW_CHOICES, SLO_REQUESTS)]


def _slo_run(program, scope, logits, requests, window, name):
    """Every request queued before the batcher starts and a formation
    deadline no batch reaches, so the batches form alike in every run:
    FIFO, up to MAX_BATCH rows each, the tail at close().  Returns the
    engine, the futures and the answers."""
    import torch
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(program, scope=scope, max_batch=MAX_BATCH,
                        max_wait_us=10_000_000, max_inflight=window,
                        auto_start=False, name=name)
    futs = [eng.submit(r) for r in requests]
    torch.cuda.synchronize()
    _zero_counts()
    eng.start()
    eng.close()                     # drains: every batch answered
    counts = _read_counts()
    return eng, futs, [f.result(timeout=0)[logits.name] for f in futs], \
        counts


def _recorder_cost(program, scope, logits, card):
    """Host ms of one BERT batch (``Executor.run`` with the logits fetched
    to the host) at 1 and MAX_BATCH rows with the flight recorder on and
    off, in alternating blocks of SLO_RECORDER_ITERS runs."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import flight_recorder

    exe = fluid.Executor(fluid.CUDAPlace(0))
    rng = np.random.RandomState(SEED + 62)
    out = {}
    try:
        for rows in (1, MAX_BATCH):
            feed = _bert_request(rng, rows)
            for _ in range(3):
                exe.run(program, feed=feed, fetch_list=[logits], scope=scope)
            ms = {True: [], False: []}
            for on in (True, False, True, False):
                flight_recorder.configure(enabled=on)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(SLO_RECORDER_ITERS):
                    exe.run(program, feed=feed, fetch_list=[logits],
                            scope=scope)
                ms[on].append((time.perf_counter() - t0)
                              / SLO_RECORDER_ITERS * 1e3)
            out[rows] = ms
            _p(f"slo: BERT batch of {rows} rows, host ms a run with the "
               f"flight recorder on {[round(v, 3) for v in ms[True]]}, off "
               f"{[round(v, 3) for v in ms[False]]} ({SLO_RECORDER_ITERS} "
               f"runs a block, blocks alternated)  [{card}]")
    finally:
        flight_recorder.configure(enabled=True)
    return out


def _phase_slo(served, card):
    """(c) The SLO surface on the card: phase 4's BERT-base program under
    a named engine with a window of 2, against a window of 1."""
    import tempfile
    from paddle_tpu_torch.fluid import flight_recorder, metrics_export, trace
    from paddle_tpu_torch.serving import DeadlineExceededError, \
        ServingEngine

    program, _, scope, logits = served
    requests = _slo_requests()
    rows = [len(r["ids"]) for r in requests]
    flight_recorder.reset()
    trace.reset()
    trace.enable()
    try:
        eng, futs, answers, counts = _slo_run(program, scope, logits,
                                              requests, 2, "chip_slo")
    finally:
        trace.disable()
    with tempfile.TemporaryDirectory() as d:
        doc = json.load(open(trace.export_chrome_trace(
            os.path.join(d, "slo_trace.json"))))
    trace.reset()
    ref_eng, _, ref_answers, _ = _slo_run(program, scope, logits, requests,
                                          1, "chip_slo_window1")
    st, ref_st = eng.stats(), ref_eng.stats()
    same = all(np.array_equal(a, b) for a, b in zip(answers, ref_answers))
    good = all(a.shape == (n, 2) and np.isfinite(a).all()
               for a, n in zip(answers, rows))
    lat = np.array([f.timing["latency_us"] for f in futs]) / 1e3
    spans = [e for e in doc["traceEvents"] if e.get("name") ==
             "serving::batch"]
    req_ids = {e["args"]["trace_id"] for e in doc["traceEvents"]
               if e.get("name") == "serving::request"}
    recs = {r["trace_id"] for r in flight_recorder.recorder().snapshot()
            if r.get("kind") == "request" and r.get("outcome") == "ok"}
    ids = [f.trace_id for f in futs]
    _p(f"slo: {len(requests)} requests ({sum(rows)} rows) through "
       f"ServingEngine(name='chip_slo', max_inflight=2): {st['batches']} "
       f"batches (window 1: {ref_st['batches']}), answers "
       f"{'bit for bit' if same else 'NOT bit for bit'} against the window "
       f"of 1; latency p50 {np.percentile(lat, 50):.2f} ms, p99 "
       f"{np.percentile(lat, 99):.2f} ms (a queued burst); histogram counts "
       f"latency {st['latency_seconds']['count']}, queue "
       f"{st['queue_seconds']['count']}, device "
       f"{st['device_seconds']['count']}, batch size "
       f"{st['batch_size']['count']}; serving::batch spans {len(spans)}; "
       f"trace ids in the flight recorder {len(set(ids) & recs)} of "
       f"{len(ids)}, in serving::request spans {len(set(ids) & req_ids)}; "
       f"launches {counts}  [{card}]")
    ok = (same and good and st["batches"] == ref_st["batches"] >= 2
          and st["latency_seconds"]["count"] == len(requests)
          and st["queue_seconds"]["count"] == len(requests)
          and st["device_seconds"]["count"] == st["batches"]
          and st["batch_size"]["count"] == st["batches"]
          and len(spans) == st["batches"]
          and set(ids) <= recs and set(ids) <= req_ids
          and counts["flash_attention_fwd"]
          == BERT_BASE["layers"] * st["batches"]
          and trace.metrics().gauge("executor.inflight_steps").value == 0)
    if not ok:
        raise SystemExit("chip_smoke: the SLO engine's answers, instruments, "
                         "spans or flight-recorder records are not right")

    # deadlines while paused
    eng = ServingEngine(program, scope=scope, max_batch=MAX_BATCH,
                        max_wait_us=0, name="chip_slo_paused")
    one = _bert_request(np.random.RandomState(SEED + 63), 1)
    with eng:
        eng.pause()
        held = [eng.submit(one, deadline_ms=SLO_DEADLINE_MS)
                for _ in range(SLO_PAUSED)]
        time.sleep(3 * SLO_DEADLINE_MS / 1e3)
        paused = eng.paused()
        eng.resume()
        errs = [f.exception(timeout=60) for f in held]
        after = eng.infer(one, timeout=60)[logits.name]
        pst = eng.stats()
    timed_out = sum(isinstance(e, DeadlineExceededError) for e in errs)
    _p(f"slo: {SLO_PAUSED} requests with deadline_ms={SLO_DEADLINE_MS} "
       f"while paused (paused() = {paused}): {timed_out} rejected with "
       f"DeadlineExceededError, timeouts = {pst['timeouts']}; one request "
       f"after resume answered {after.shape}")
    if timed_out != SLO_PAUSED or pst["timeouts"] != SLO_PAUSED \
            or not paused or after.shape != (1, 2):
        raise SystemExit("chip_smoke: deadlines under pause did not reject")

    # the export plane, without a server
    payload = metrics_export.stats_payload()
    dec = payload.get("decode", {})
    text = metrics_export.prometheus_text()
    fams = metrics_export.parse_prometheus_text(text)
    n_inst = len(trace.metrics().items())
    counters = {metrics_export.sanitize_metric_name(n): i.value
                for n, i in trace.metrics().items()
                if isinstance(i, trace.Counter)}
    parsed = {f["name"]: f["samples"][0][2] for f in fams
              if f["type"] == "counter"}
    _p(f"slo: stats_payload engines {sorted(payload.get('engines', {}))}, "
       f"decode block spec_proposed {dec.get('spec_proposed')}, "
       f"spec_accepted {dec.get('spec_accepted')}; prometheus_text "
       f"{len(text.splitlines())} lines parse back to {len(fams)} families "
       f"for {n_inst} instruments")
    if "chip_slo" not in payload.get("engines", {}) \
            or payload["engines"]["chip_slo"]["batches"] != st["batches"] \
            or not {"spec_proposed", "spec_accepted"} <= set(dec) \
            or len(fams) != n_inst \
            or any(parsed.get(n) != v for n, v in counters.items()):
        raise SystemExit("chip_smoke: the metrics export does not hold the "
                         "engines or does not parse back")
    _recorder_cost(program, scope, logits, card)
    return counts


def phase_speculative(decode_served, decode_ref, served, card):
    """Phase 4q: speculative paged decode at DECODE width and the serving
    engine's SLO surface.  (a) A self-draft (the target drafts for
    itself) over phase 4f's traffic: every token and logit equal to 4f's
    paged output, every proposal accepted, DECODE_SPEC_K paged-kernel
    launches a verify round and DECODE_SPEC_K rewrites in each verify
    program; one verify round profiled.  (b) A half-width draft from
    seed SEED + 1: the tokens equal 4f's, the accept rate printed.
    Card against host: 2 requests through a host speculative engine, and
    a twin that reads each verify block's logits one position late, which
    must miss by 10 times the tolerance or more.  (c) The SLO surface on
    phase 4's BERT-base program.  Returns the launches of each leg."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.serving import decode

    model, eng4f = decode_served
    ref, arrays, built = decode_ref["out"], decode_ref["arrays"], \
        decode_ref["built"]
    prompts, budgets, shared = _decode_traffic()
    k = DECODE_SPEC_K
    launches = {}

    # (a) the self-draft, and plain paged decode, both at one decode
    # bucket: a float32 product's rounding of a row, and the paged
    # kernel's split of a slot's positions, depend on the batch size, so
    # logits agree bit for bit only between steps of one size
    one = (DECODE_MAX_BATCH,)
    plain = decode.DecodeEngine(model, max_batch=DECODE_MAX_BATCH,
                                collect_logits=True, name="chip_paged_one",
                                paged=True, prefix_cache=True,
                                batch_edges=one, auto_start=False)
    plain.warmup()
    bitref, _, _ = _spec_serve(plain, prompts, budgets)
    eng = decode.DecodeEngine(model, max_batch=DECODE_MAX_BATCH,
                              collect_logits=True, name="chip_spec",
                              paged=True, prefix_cache=True,
                              draft_model=model, spec_k=k,
                              batch_edges=one, auto_start=False)
    warm = eng.warmup()
    _p(f"speculative: self-draft engine, spec_k {k}; verify programs "
       f"built (pool rows, k, fuse_paged_attention rewrites, paged_"
       f"attention ops, softmax ops): {built['verify']}; warmup "
       f"{warm['seconds']:.2f} s")
    if not built["verify"] or any(v[1:] != (k, k, k, 0)
                                  for v in built["verify"]):
        raise SystemExit("chip_smoke: fuse_paged_attention did not rewrite "
                         "every block of the verify program")
    torch.cuda.synchronize()
    _zero_counts()
    out, wall, st = _spec_serve(eng, prompts, budgets)
    launches["self_draft"] = counts = _read_counts()
    toks_ok = _spec_report("speculative (a) self-draft", out, ref, wall, st,
                           counts, card)
    bits, n_bits, _, _ = _logit_agreement(out, bitref)
    toks_one = all(np.array_equal(a["tokens"], b["tokens"])
                   for a, b in zip(out, bitref))
    _, n_4f, err, scale = _logit_agreement(out, ref)
    _p(f"speculative (a): against plain paged decode at the same one "
       f"bucket, tokens {'identical' if toks_one else 'DIFFER'}, logits of "
       f"{n_bits} of {len(out)} requests bit for bit; against phase 4f's "
       f"output (buckets {list(eng4f.batch_edges)}) {n_4f} of {len(out)} bit for bit, max |logit err| {err:.3e} "
       f"against 1e-4 x max |logit| = {1e-4 * scale:.3e}")
    sp = st["paged"]
    others = sum(v for n, v in counts.items() if n != "paged_attention")
    if not (toks_ok and toks_one):
        raise SystemExit("chip_smoke: speculative decode's tokens differ "
                         "from plain paged decode's")
    if not bits or err > 1e-4 * scale:
        raise SystemExit("chip_smoke: speculative decode's logits are not "
                         "plain paged decode's bit for bit at one bucket")
    if not sp["spec_accepted"] == sp["spec_proposed"] > 0:
        raise SystemExit("chip_smoke: a self-draft did not accept every "
                         "proposal")
    if counts["paged_attention"] != k * st["steps"] or others:
        raise SystemExit("chip_smoke: the verify rounds did not launch the "
                         "paged-attention kernel spec_k times each")
    _verify_round_profile(model, eng, card)

    # (b) a half-width draft
    t0 = time.perf_counter()
    draft = decode.build_demo_decode_model(
        seed=SEED + 1, executor=model.executor, scope=fluid.Scope(),
        **DECODE_DRAFT)
    n_b = DECODE_DRAFT_REQUESTS
    eng_b = decode.DecodeEngine(model, max_batch=DECODE_MAX_BATCH,
                                collect_logits=True, name="chip_spec_draft",
                                paged=True, prefix_cache=True,
                                draft_model=draft, spec_k=k,
                                auto_start=False)
    eng_b.warmup()
    _p(f"speculative: half-width draft (d_model {DECODE_DRAFT['d_model']}, "
       f"seed {SEED + 1}) built on the card in "
       f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    _zero_counts()
    out_b, wall_b, st_b = _spec_serve(eng_b, prompts[:n_b], budgets[:n_b])
    launches["half_width_draft"] = counts_b = _read_counts()
    toks_b = _spec_report("speculative (b) half-width draft", out_b,
                          ref[:n_b], wall_b, st_b, counts_b, card)
    if not toks_b:
        raise SystemExit("chip_smoke: speculative decode with a half-width "
                         "draft changed the tokens")
    if counts_b["paged_attention"] != k * st_b["steps"]:
        raise SystemExit("chip_smoke: the half-width draft's verify rounds "
                         "did not launch the paged kernel spec_k times each")

    # card against host, and the twin that reads one position too far
    picks = [shared[-1], [i for i in range(DECODE_REQUESTS)
                          if i not in shared][-1]]
    host = _host_spec_decode(arrays, [prompts[i] for i in picks])
    twin = _host_spec_decode(arrays, [prompts[i] for i in picks], twin=True)
    ok, missed = True, True
    for i, h, t in zip(picks, host, twin):
        ok &= _same_decode(f"speculative request {i} card vs host "
                           f"({DECODE_HOST_NEW} tokens)", out[i], h, 1e-4,
                           DECODE_HOST_NEW)[0]
        n = DECODE_HOST_NEW
        t_err = float(np.abs(out[i]["logits"][:n]
                             - t["logits"][:n]).max())
        tol = 1e-4 * float(np.abs(t["logits"][:n]).max())
        _p(f"  request {i} card vs the one-position-late twin: tokens "
           f"{'identical' if np.array_equal(out[i]['tokens'][:n], t['tokens'][:n]) else 'differ'}"
           f", max |logit err| {t_err:.3e} = {t_err / tol:.1f} x the "
           f"tolerance")
        missed &= t_err >= 10 * tol
    if not ok:
        raise SystemExit("chip_smoke: speculative decode on the card "
                         "disagrees with the host")
    if not missed:
        raise SystemExit("chip_smoke: the speculative card-vs-host check "
                         "cannot tell each block's logits from the next's")

    # (c) the SLO surface
    launches["slo"] = _phase_slo(served, card)
    return launches


def phase_profile_decode(served, card, iters=20):
    """Where one paged decode step's time goes, as ``phase_profile``
    measures it: ``Executor.run`` of the fused paged program with the
    logits fetched to the host, at 1, 8 and 32 live slots, each slot
    holding DECODE_PROFILE_POS valid positions on its own pages."""
    import torch
    from paddle_tpu_torch import fluid

    model, eng = served
    prog, logits_n = model.paged_program(eng._pool_rows)
    scope = fluid.Scope(parent=model.scope)
    dev = model.executor.device
    for name in (model.k_pool_name, model.v_pool_name):
        scope.set_var(name, torch.randn(eng._pool_rows, model.d_model,
                                        device=dev))
    ps, s = model.page_size, model.max_len
    per_seq = s // ps
    rng = np.random.default_rng(SEED + 51)
    for n in (1, 8, DECODE_MAX_BATCH):
        pages = rng.permutation(eng.pool_pages - 1)[:n * per_seq] + 1
        pt = (pages.reshape(n, per_seq, 1) * ps
              + np.arange(ps)).reshape(n, s).astype(np.int32)
        scope.set_var(model.pt_name, torch.from_numpy(pt).to(dev))
        pos = DECODE_PROFILE_POS
        feed = {"tok": rng.integers(0, model.vocab, (n, 1)),
                "widx": pt[:, pos:pos + 1].astype(np.int64),
                "pos": np.full((n, 1), float(pos), np.float32),
                "arange": np.arange(s, dtype=np.float32)[None, :]}

        def step():
            return model.executor.run(prog, feed=feed, fetch_list=[logits_n],
                                      scope=scope, return_numpy=True)[0]

        host_ms, busy_ms, idle, n_kern, by_class = _profile(step, iters)
        _p(f"profile decode: {n} slots at position {pos}: host "
           f"{host_ms:.3f} ms/step ({n / host_ms * 1e3:.1f} tokens/s), "
           f"device busy {busy_ms:.3f} ms/step, idle share {idle:.4f}, "
           f"{n_kern:.0f} kernels/step  [{card}]")
        _print_classes(by_class, "step")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the static book tier: MNIST LeNet and tests/test_static_e2e.py (phase 4g)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fresh_fluid_globals():
    """Fresh default programs, global scope and name counters, as the
    reference's tests get them from their conftest."""
    from paddle_tpu_torch.fluid import core, framework

    prev = (framework._main_program, framework._startup_program,
            core._global_scope)
    framework._main_program = framework.Program()
    framework._startup_program = framework.Program()
    core._global_scope = core.Scope()
    framework.reset_unique_name()
    try:
        yield
    finally:
        (framework._main_program, framework._startup_program,
         core._global_scope) = prev


def _host(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else np.asarray(v)


def _blob_data(rng, n=LENET_BATCH):
    """The reference tests' seeded synthetic digits
    (tests/test_static_e2e.py:9): noise with an 8x8 bright square whose
    offset is the label."""
    labels = rng.randint(0, 10, n).astype("int64")
    images = rng.randn(n, 1, 28, 28).astype("float32") * 0.3
    for i in range(n):
        y = labels[i]
        images[i, 0, y:y + 8, y:y + 8] += 2.0
    return images, labels[:, None]


def _book_fit_a_line(fluid, place, rng):
    x = fluid.data("x", [-1, 13])
    y = fluid.data("y", [-1, 1])
    pred = fluid.layers.fc(x, 1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGDOptimizer(0.01).minimize(loss)
    exe = fluid.Executor(place)
    exe.run(fluid.default_startup_program())
    w_true = rng.randn(13, 1).astype("float32")
    xs = rng.randn(256, 13).astype("float32")
    ys = xs @ w_true + 0.01 * rng.randn(256, 1).astype("float32")
    losses = [float(exe.run(feed={"x": xs, "y": ys}, fetch_list=[loss])[0])
              for _ in range(100)]
    return losses[-1] < losses[0] * 0.1, \
        f"loss {losses[0]:.4f} -> {losses[-1]:.6f} (< a tenth)"


def _book_lenet(fluid, place, rng):
    loss, acc = _lenet(fluid)
    exe = fluid.Executor(place)
    exe.run(fluid.default_startup_program())
    images, labels = _blob_data(rng)
    for _ in range(40):
        lv, av = exe.run(feed={"img": images, "label": labels},
                         fetch_list=[loss, acc])
    return float(lv) < 0.5 and float(av) > 0.9, \
        f"40 steps: loss {float(lv):.4f} (< 0.5), accuracy {float(av):.4f} " \
        f"(> 0.9)"


def _book_batch_norm(fluid, place, rng):
    x = fluid.data("x", [-1, 4, 3, 3])
    out = fluid.layers.batch_norm(x, momentum=0.5)
    loss = fluid.layers.mean(out)
    fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    exe = fluid.Executor(place)
    exe.run(fluid.default_startup_program())
    scope = fluid.global_scope()
    exe.run(feed={"x": rng.randn(8, 4, 3, 3).astype("float32") + 5.0},
            fetch_list=[loss])
    prog = fluid.default_main_program()
    means = [_host(scope.find_var(v.name))
             for v in prog.global_block().vars.values()
             if v.persistable and "batch_norm" in v.name]
    moved = [float(np.abs(m).mean()) for m in means if m.shape == (4,)]
    return max(moved) > 0.5, \
        f"moving statistics' mean |value| after one step {moved} (one > 0.5)"


def _book_save_load(fluid, place, rng):
    import tempfile

    x = fluid.data("x", [-1, 8])
    loss = fluid.layers.mean(fluid.layers.fc(x, 4))
    fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    exe = fluid.Executor(place)
    exe.run(fluid.default_startup_program())
    exe.run(feed={"x": rng.randn(4, 8).astype("float32")},
            fetch_list=[loss])
    scope = fluid.global_scope()
    params = {n: _host(scope.find_var(n)) for n in scope.local_var_names()}
    with tempfile.TemporaryDirectory() as d:
        fluid.save_persistables(exe, d)
        for n in params:
            scope.set_var(n, params[n] * 0 + 99.0)
        fluid.load_persistables(exe, d)
    same = all(np.array_equal(_host(scope.find_var(n)), want)
               for n, want in params.items())
    on_card = all(scope.find_var(n).device.type == place.device_kind
                  for n in params)
    return same and on_card, \
        f"{len(params)} persistables restored equal, on the place: {on_card}"


def _book_clone_for_test(fluid, place, rng):
    x = fluid.data("x", [-1, 8])
    loss = fluid.layers.mean(fluid.layers.fc(x, 4))
    fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    types = [op.type for op in fluid.default_main_program()
             .clone(for_test=True).global_block().ops]
    return "generic_grad" not in types and "sgd" not in types, \
        f"test program ops {types}"


def _clip_case(fluid):
    x = fluid.data("x", [-1, 10])
    y = fluid.data("y", [-1, 1])
    h = fluid.layers.fc(x, 16, act="tanh")
    pred = fluid.layers.fc(h, 1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.MomentumOptimizer(
        0.05, 0.9,
        grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)).minimize(loss)
    return loss


def _clip_feed(rng):
    xs = rng.randn(64, 10).astype("float32")
    return {"x": xs, "y": (xs.sum(1, keepdims=True) > 0).astype("float32")}


def _book_clip(fluid, place, rng):
    loss = _clip_case(fluid)
    exe = fluid.Executor(place)
    exe.run(fluid.default_startup_program())
    feed = _clip_feed(rng)
    losses = [float(exe.run(feed=feed, fetch_list=[loss])[0])
              for _ in range(50)]
    return losses[-1] < losses[0], \
        f"50 steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}"


BOOK_CASES = (("fit_a_line", _book_fit_a_line),
              ("recognize_digits_lenet", _book_lenet),
              ("batch_norm_running_stats_update", _book_batch_norm),
              ("save_load_persistables", _book_save_load),
              ("program_clone_for_test_drops_grads", _book_clone_for_test),
              ("exponential_decay_training", _book_clip))


def _lenet(fluid, optimizer="adam", bn=False):
    """MNIST LeNet as tests/test_static_e2e.py:38 builds it: 1x28x28, conv
    6@3x3 pad 1 + relu + 2x2 max-pool, conv 16@5x5 + relu + 2x2 max-pool,
    flatten to 400, fc 120 relu, fc 10, softmax cross entropy, mean,
    accuracy, Adam 1e-3 (or SGD 0.1).  With ``bn``, conv1 has no bias and
    a batch_norm (then the relu) follows it."""
    img = fluid.data("img", [-1, 1, 28, 28])
    label = fluid.data("label", [-1, 1], dtype="int64")
    conv1 = fluid.layers.conv2d(img, 6, 3, padding=1,
                                bias_attr=False if bn else None,
                                act=None if bn else "relu")
    if bn:
        conv1 = fluid.layers.batch_norm(conv1, act="relu")
    pool1 = fluid.layers.pool2d(conv1, 2, "max", 2)
    conv2 = fluid.layers.conv2d(pool1, 16, 5, act="relu")
    pool2 = fluid.layers.pool2d(conv2, 2, "max", 2)
    fc1 = fluid.layers.fc(fluid.layers.flatten(pool2), 120, act="relu")
    logits = fluid.layers.fc(fc1, 10)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    acc = fluid.layers.accuracy(logits, label)
    if optimizer == "adam":
        fluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
    else:
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    return loss, acc


def _book_program(build, kernel_tier, **kw):
    """(main, startup, fetches, CompiledProgram or main) of one build
    under fresh names, the startup seeded; with ``kernel_tier`` the
    passes are applied at once, seeded by the fetches."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.framework import reset_unique_name

    reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        fetches = build(fluid, **kw)
    fetches = fetches if isinstance(fetches, tuple) else (fetches,)
    startup.random_seed = SEED
    program = main
    if kernel_tier:
        bs = fluid.BuildStrategy()
        bs.kernel_tier = True
        program = fluid.CompiledProgram(main, bs)
        program._apply_ir_passes([f.name for f in fetches])
    return main, startup, fetches, program


def _startup_state(main, startup, place):
    """The persistables after the startup program ran on ``place``, as
    host arrays."""
    from paddle_tpu_torch import fluid, interop

    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    return interop.scope_to_numpy(
        scope, [n for n, v in main.global_block().vars.items()
                if v.persistable])


def _steps(program, main, fetch, init, place, feeds, bucketing=False):
    """Run ``feeds`` from ``init`` on ``place``: (each step's fetches as
    host arrays, the persistables after the last step)."""
    from paddle_tpu_torch import fluid, interop

    main._hints["shape_bucketing"] = bucketing
    scope = interop.scope_from_numpy(init, fluid.Scope(), place)
    exe = fluid.Executor(place)
    try:
        outs = [exe.run(program, feed=f, fetch_list=fetch, scope=scope)
                for f in feeds]
    finally:
        main._hints["shape_bucketing"] = False
    return outs, interop.scope_to_numpy(scope, list(init))


@contextlib.contextmanager
def _count_lowering(op_type):
    """Count the calls of one op's lowering (its ``OpDef.fn``)."""
    from paddle_tpu_torch.ops.registry import get_op

    opdef = get_op(op_type)
    fn, calls = opdef.fn, [0]

    def counted(*args):
        calls[0] += 1
        return fn(*args)

    opdef.fn = counted
    try:
        yield calls
    finally:
        opdef.fn = fn


@contextlib.contextmanager
def _conv_pads_all_low():
    """A broken twin: conv2d puts all of each dim's padding on the low
    side (the output keeps its shape, the feature maps shift)."""
    from paddle_tpu_torch.ops import nn_ops

    orig = nn_ops._conv_pad

    def low(*args):
        return [(lo + hi, 0) for lo, hi in orig(*args)]

    nn_ops._conv_pad = low
    try:
        yield
    finally:
        nn_ops._conv_pad = orig


@contextlib.contextmanager
def _bn_moving_stats_in_training():
    """A broken twin: batch_norm normalizes a training step by the moving
    statistics, as if ``use_global_stats`` were set.  (torch.var's
    unbiased default is no twin here: over LeNet's 64 x 28 x 28 values a
    channel it scales the variance by 1 + 2e-5, and moved the losses by
    9e-6 in a CPU rehearsal, under the tolerance.)"""
    from paddle_tpu_torch.ops.registry import get_op

    opdef = get_op("batch_norm")
    fn = opdef.fn
    opdef.fn = lambda ins, attrs, ctx: fn(
        ins, dict(attrs, use_global_stats=True), ctx)
    try:
        yield
    finally:
        opdef.fn = fn


def _worst(got, want):
    """max |got - want| over the named arrays, over the largest |want|."""
    scale = max(float(np.abs(want[n]).max()) for n in want)
    return max(float(np.abs(got[n] - want[n]).max()) for n in want) \
        / max(scale, 1e-30)


def _lenet_card_vs_host(bn, twin, card):
    """LeNet (or its batch-norm variant) on the card and on the host from
    one state, the kernel-tier program, 3 Adam steps at LENET_BATCH rows:
    the losses within rtol 1e-4, the first step's gradients within 1e-4
    of the largest.  A broken host twin must miss one of the two."""
    from paddle_tpu_torch import fluid

    main, startup, (loss, acc), program = _book_program(
        _lenet, True, bn=bn)
    init = _startup_state(main, startup, fluid.CUDAPlace(0))
    grads = [p.name + "@GRAD" for p in main.all_parameters() if p.trainable]
    images, labels = _blob_data(np.random.RandomState(SEED + 61))
    feeds = [{"img": images, "label": labels}] * 3
    fetch = [loss.name, acc.name] + grads

    def run(place):
        outs, _ = _steps(program, main, fetch, init, place, feeds)
        return ([float(o[0]) for o in outs],
                dict(zip(grads, outs[0][2:])))

    card_l, card_g = run(fluid.CUDAPlace(0))
    host_l, host_g = run(fluid.CPUPlace())
    with twin():
        twin_l, twin_g = run(fluid.CPUPlace())
    l_err = max(abs(a - b) / abs(b) for a, b in zip(card_l, host_l))
    g_err = _worst(card_g, host_g)
    twin_l_err = max(abs(a - b) / abs(b) for a, b in zip(card_l, twin_l))
    twin_g_err = _worst(twin_g, card_g)
    name = "LeNet + batch_norm" if bn else "LeNet"
    _p(f"static e2e: {name} card vs host, {LENET_BATCH} rows x 3 Adam "
       f"steps from one state: losses card {card_l}, host {host_l}, max "
       f"rel err {l_err:.3e} (rtol 1e-4); first-step gradients max |card - "
       f"host| / max |grad| = {g_err:.3e} (1e-4); the {twin.__name__} twin: "
       f"losses {twin_l_err:.3e}, gradients {twin_g_err:.3e} (must miss "
       f"one)  [{card}]")
    if l_err > 1e-4 or g_err > 1e-4:
        raise SystemExit(f"chip_smoke: {name} on the card disagrees with "
                         f"the host")
    if twin_l_err <= 1e-4 and twin_g_err <= 1e-4:
        raise SystemExit(f"chip_smoke: the {name} card-vs-host check "
                         f"cannot see the {twin.__name__} twin")


def _lenet_tier_vs_plain(card):
    """The kernel-tier LeNet (one fused_adam) against the plain program
    (eight adam ops) on the card, 3 steps from one state: losses,
    accuracies and every persistable bit for bit (the bucketed against
    per-param contract, ops/optimizer_ops.py)."""
    from paddle_tpu_torch import fluid

    main, startup, (loss, acc), tier = _book_program(_lenet, True)
    plain_main, _, (p_loss, p_acc), _ = _book_program(_lenet, False)
    init = _startup_state(main, startup, fluid.CUDAPlace(0))
    images, labels = _blob_data(np.random.RandomState(SEED + 62))
    feeds = [{"img": images, "label": labels}] * 3
    got, got_state = _steps(tier, main, [loss.name, acc.name], init,
                            fluid.CUDAPlace(0), feeds)
    want, want_state = _steps(plain_main, plain_main,
                              [p_loss.name, p_acc.name], init,
                              fluid.CUDAPlace(0), feeds)
    same = all(np.array_equal(a, b) for x, y in zip(got, want)
               for a, b in zip(x, y))
    same_state = all(np.array_equal(got_state[n], want_state[n])
                     for n in want_state)
    _p(f"static e2e: LeNet kernel tier vs plain program on the card, 3 "
       f"steps: losses and accuracies equal = {same}, {len(want_state)} "
       f"persistables equal = {same_state} (tolerance: bit-identical)  "
       f"[{card}]")
    if not (same and same_state):
        raise SystemExit("chip_smoke: the kernel-tier LeNet step is not "
                         "bit-identical to the plain program's")


def _lenet_ragged(bn, card):
    """A ragged batch of LENET_RAGGED rows bucketed to LENET_BATCH against
    the unbucketed step, 2 Adam steps of the kernel-tier program from one
    state: losses, accuracies, parameters and the moving statistics
    within rtol 1e-4, atol 1e-5."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import compile_cache

    main, startup, (loss, acc), program = _book_program(
        _lenet, True, bn=bn)
    init = _startup_state(main, startup, fluid.CUDAPlace(0))
    images, labels = _blob_data(np.random.RandomState(SEED + 63),
                                LENET_RAGGED)
    feeds = [{"img": images, "label": labels}] * 2
    fetch = [loss.name, acc.name]
    padded, p_state = _steps(program, main, fetch, init, fluid.CUDAPlace(0),
                             feeds, bucketing=True)
    plain, u_state = _steps(program, main, fetch, init, fluid.CUDAPlace(0),
                            feeds)
    bucket = compile_cache.bucket_for(LENET_RAGGED)
    pairs = [(a, b) for x, y in zip(padded, plain) for a, b in zip(x, y)]
    pairs_state = [(p_state[n], u_state[n]) for n in u_state]
    err = max(float(np.abs(a - b).max()) for a, b in pairs)
    s_err = max(float(np.abs(a - b).max()) for a, b in pairs_state)
    ok = all(np.allclose(a, b, rtol=1e-4, atol=1e-5)
             for a, b in pairs + pairs_state)
    stats = [n for n in u_state if "batch_norm" in n and ".w_" in n]
    name = "LeNet + batch_norm" if bn else "LeNet"
    _p(f"static e2e: {name}, {LENET_RAGGED} rows bucketed to {bucket} vs "
       f"unbucketed, 2 steps: losses {[float(o[0]) for o in padded]} vs "
       f"{[float(o[0]) for o in plain]}; max |diff| over losses and "
       f"accuracies {err:.3e}, over {len(u_state)} persistables "
       f"({len(stats)} batch_norm vars) {s_err:.3e}; within rtol 1e-4, "
       f"atol 1e-5: {ok}  [{card}]")
    if bucket == LENET_RAGGED or not ok:
        raise SystemExit(f"chip_smoke: the bucketed {name} step disagrees "
                         f"with the unbucketed one")


def _bucket_shapes(main, op_type):
    """The parameter shapes of the one ``op_type`` op of ``main``, in the
    op's order."""
    op, = [op for op in main.global_block().ops if op.type == op_type]
    return [tuple(main.global_block().var(n).shape)
            for n in op.input("Param")]


def _lenet_kernel_checks(adam_shapes, momentum_shapes, card):
    """fused_adam at LeNet's eight segments and fused_momentum at the clip
    case's bucket, each op on the card against its plain version on the
    card, ``torch.equal``, with device ms per call from the profiler
    beside the plain version's, the library call's and the bound."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.ops.optimizer_ops import (_plain_fused_adam,
                                                    _plain_fused_momentum)
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 64)
    shapes = adam_shapes
    if sorted(math.prod(s) for s in shapes) != sorted(LENET_SEGMENTS):
        raise SystemExit("chip_smoke: LeNet's Adam segments are not the "
                         "model's")
    n = sum(LENET_SEGMENTS)

    def draw(shape, std):
        return std * torch.randn(shape, generator=gen, device=dev)

    ins = {"Param": [draw(s, 0.1) for s in shapes],
           "Grad": [draw(s, 1e-2) for s in shapes],
           "Moment1": [draw(s, 1e-3) for s in shapes],
           "Moment2": [draw(s, 1e-3).square() for s in shapes],
           "Beta1Pow": [torch.full((1,), 0.9 ** 2, device=dev)
                        for _ in shapes],
           "Beta2Pow": [torch.full((1,), 0.999 ** 2, device=dev)
                        for _ in shapes],
           "LearningRate": [torch.full((1,), 1e-3, device=dev)]}
    b1, b2, eps = 0.9, 0.999, 1e-8
    attrs = {"beta1": b1, "beta2": b2, "epsilon": eps}
    args = [ins[s] for s in ("Param", "Grad", "Moment1", "Moment2")] + \
        [ins["LearningRate"][0], ins["Beta1Pow"], ins["Beta2Pow"], b1, b2,
         eps]
    before = cuda_kernels.fused_adam.launches
    fused = get_op("fused_adam").fn(ins, attrs, LoweringContext(dev))
    if cuda_kernels.fused_adam.launches != before + 1:
        raise SystemExit("chip_smoke: fused_adam did not launch its kernel "
                         "at LeNet's segments")
    plain = _plain_fused_adam(*args)
    equal, err = True, 0.0
    for slot, outs in plain.items():
        for got, want in zip(fused[slot], outs):
            equal &= torch.equal(got, want)
            err = max(err, (got - want).abs().max().item())
    ms = _profile(lambda: cuda_kernels.fused_adam(*args), 50)[1]
    plain_ms = _profile(lambda: _plain_fused_adam(*args), 20)[1]
    lib = [[x.clone() for x in ins[s]]
           for s in ("Param", "Grad", "Moment1", "Moment2")]
    steps = [torch.full((), 2.0, device=dev) for _ in shapes]
    bc2 = 1 - b2 ** 2
    library_ms = _profile(lambda: torch._fused_adam_(
        *lib, [], steps, lr=1e-3, beta1=b1, beta2=b2, weight_decay=0.0,
        eps=eps / math.sqrt(bc2), amsgrad=False, maximize=False), 20)[1]
    t_bytes = 7 * 4 * n / HBM_BYTES_PER_S * 1e3
    t_ops = 12.0 * n / FLOPS_PER_S["float32"] * 1e3
    adam = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "values": n,
            "segments": list(LENET_SEGMENTS)}
    _p(f"fused_adam at LeNet's 8 segments ({n} values): torch.equal to "
       f"the plain version on the card = {equal} (max |err| {err:.3e}; "
       f"tolerance: bit-identical); device per call: kernel {ms:.4f} ms | "
       f"plain {plain_ms:.4f} ms | library (torch._fused_adam_) "
       f"{library_ms:.4f} ms | bound {adam['bound_ms']:.6f} ms "
       f"({adam['bound_by']})  [{card}]")
    if not equal:
        raise SystemExit("chip_smoke: fused_adam at LeNet's segments is not "
                         "its plain version")

    shapes = momentum_shapes
    n = sum(math.prod(s) for s in shapes)
    ins = {s: [std * torch.randn(shape, generator=gen, device=dev)
               for shape in shapes]
           for s, std in (("Param", 0.3), ("Grad", 1e-1),
                          ("Velocity", 1e-2))}
    ins["LearningRate"] = [torch.full((1,), 0.05, device=dev)]
    attrs = {"mu": 0.9, "use_nesterov": False}
    before = cuda_kernels.fused_momentum.launches
    fused = get_op("fused_momentum").fn(ins, attrs, LoweringContext(dev))
    if cuda_kernels.fused_momentum.launches != before + 1:
        raise SystemExit("chip_smoke: fused_momentum did not launch its "
                         "kernel at the clip case's bucket")
    ps, gs, vs = ins["Param"], ins["Grad"], ins["Velocity"]
    lr = ins["LearningRate"][0]
    plain = _plain_fused_momentum(ps, gs, vs, lr, 0.9, 0.0, False)
    equal, err = True, 0.0
    for slot, outs in plain.items():
        for got, want in zip(fused[slot], outs):
            equal &= torch.equal(got, want)
            err = max(err, (got - want).abs().max().item())
    ms = _profile(lambda: cuda_kernels.fused_momentum(ps, gs, vs, lr, 0.9,
                                                      0.0, False), 50)[1]
    plain_ms = _profile(lambda: _plain_fused_momentum(ps, gs, vs, lr, 0.9,
                                                      0.0, False), 20)[1]
    lib = [[x.clone() for x in ins[s]] for s in ("Param", "Grad",
                                                 "Velocity")]
    library_ms = _profile(lambda: torch._fused_sgd_(
        *lib, weight_decay=0.0, momentum=0.9, lr=0.05, dampening=0.0,
        nesterov=False, maximize=False, is_first_step=False), 20)[1]
    t_bytes = 5 * 4 * n / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * n / FLOPS_PER_S["float32"] * 1e3
    momentum = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms, "values": n}
    _p(f"fused_momentum at the clip case's bucket ({len(shapes)} params, "
       f"{n} values): torch.equal to the plain version on the card = "
       f"{equal} (max |err| {err:.3e}; tolerance: bit-identical); device "
       f"per call: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | library "
       f"(torch._fused_sgd_) {library_ms:.4f} ms | bound "
       f"{momentum['bound_ms']:.6f} ms ({momentum['bound_by']})  [{card}]")
    if not equal:
        raise SystemExit("chip_smoke: fused_momentum at the clip case's "
                         "bucket is not its plain version")
    return {"fused_adam": adam, "fused_momentum": momentum}


def phase_static_book(card):
    """Phase 4g: the static book tier on the card.  Returns the launches
    of fused_adam over the kernel-tier LeNet's timed steps and of
    fused_momentum over the clip case's, the kernel checks at their
    shapes, and the programs phase 5 profiles."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import trace
    from paddle_tpu_torch.ops import cuda_kernels

    place = fluid.CUDAPlace(0)
    for name, case in BOOK_CASES:
        t0 = time.perf_counter()
        with _fresh_fluid_globals():
            ok, said = case(fluid, place, np.random.RandomState(42))
        _p(f"static e2e: {name} on the card: {said}, in "
           f"{time.perf_counter() - t0:.1f} s")
        if not ok:
            raise SystemExit(f"chip_smoke: the book case {name} failed on "
                             f"the card")

    # LeNet at batch 64 through the kernel tier: the main path
    rewrites = trace.metrics().counter("kernel_tier.fuse_optimizer.rewrites")
    before = rewrites.value
    main, startup, (loss, acc), program = _book_program(_lenet, True)
    n_rewrites = rewrites.value - before
    types = [op.type for op in main.global_block().ops]
    n_params = sum(math.prod(p.shape) for p in main.all_parameters())
    _p(f"static e2e: LeNet ({n_params} parameters), kernel tier: "
       f"fuse_optimizer rewrites = {n_rewrites}; ops: "
       f"{types.count('fused_adam')} fused_adam, {types.count('adam')} "
       f"adam, {types.count('conv2d')} conv2d, {types.count('pool2d')} "
       f"pool2d, {len(types)} in all")
    if n_rewrites != 1 or types.count("fused_adam") != 1 \
            or "adam" in types or n_params != sum(LENET_SEGMENTS):
        raise SystemExit("chip_smoke: LeNet's Adam updates were not "
                         "bucketed into one fused_adam")
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    images, labels = _blob_data(np.random.RandomState(42))
    feed = {"img": images, "label": labels}
    torch.cuda.synchronize()
    cuda_kernels.fused_adam.launches = 0
    with _count_lowering("adam") as adam_calls:
        t0 = time.perf_counter()
        outs = [exe.run(program, feed=feed, fetch_list=[loss, acc],
                        scope=scope, return_numpy=False)
                for _ in range(LENET_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lenet_launches = cuda_kernels.fused_adam.launches
    lv, av = (float(x) for x in outs[-1])
    _p(f"static e2e: LeNet, {LENET_STEPS} steps at {LENET_BATCH} rows in "
       f"{wall:.3f} s: {wall / LENET_STEPS * 1e3:.2f} ms/step, "
       f"{LENET_BATCH * LENET_STEPS / wall:.0f} examples/s; loss "
       f"{lv:.4f} (< 0.5), accuracy {av:.4f} (> 0.9); fused_adam launches "
       f"{lenet_launches} (expected {LENET_STEPS}), adam lowerings "
       f"{adam_calls[0]} (expected 0)  [{card}]")
    if lenet_launches != LENET_STEPS or adam_calls[0] != 0:
        raise SystemExit("chip_smoke: the LeNet step did not run through "
                         "fused_adam once a step")
    if not (lv < 0.5 and av > 0.9):
        raise SystemExit("chip_smoke: LeNet did not learn the digits on "
                         "the card")

    _lenet_card_vs_host(False, _conv_pads_all_low, card)
    _lenet_card_vs_host(True, _bn_moving_stats_in_training, card)
    _lenet_tier_vs_plain(card)
    _lenet_ragged(False, card)
    _lenet_ragged(True, card)

    # the Momentum-with-clipping case through the kernel tier
    c_main, c_startup, (c_loss,), c_program = _book_program(_clip_case,
                                                            True)
    c_types = [op.type for op in c_main.global_block().ops]
    if c_types.count("fused_momentum") != 1 or "momentum" in c_types:
        raise SystemExit("chip_smoke: the clip case's Momentum updates were "
                         "not bucketed into one fused_momentum")
    c_scope = fluid.Scope()
    exe.run(c_startup, scope=c_scope)
    c_feed = _clip_feed(np.random.RandomState(42))
    torch.cuda.synchronize()
    cuda_kernels.fused_momentum.launches = 0
    c_losses = [exe.run(c_program, feed=c_feed, fetch_list=[c_loss],
                        scope=c_scope, return_numpy=False)[0]
                for _ in range(CLIP_STEPS)]
    torch.cuda.synchronize()
    clip_launches = cuda_kernels.fused_momentum.launches
    c_first, c_last = float(c_losses[0]), float(c_losses[-1])
    _p(f"static e2e: Momentum with GradientClipByGlobalNorm(1.0), kernel "
       f"tier, {CLIP_STEPS} steps: {c_types.count('elementwise_mul')} "
       f"elementwise_mul between the grads and one fused_momentum; loss "
       f"{c_first:.4f} -> {c_last:.4f}; fused_momentum launches "
       f"{clip_launches} (expected {CLIP_STEPS})  [{card}]")
    if clip_launches != CLIP_STEPS or not c_last < c_first:
        raise SystemExit("chip_smoke: the clip case did not run through "
                         "fused_momentum once a step, or did not learn")
    kernel_rows = _lenet_kernel_checks(_bucket_shapes(main, "fused_adam"),
                                       _bucket_shapes(c_main,
                                                      "fused_momentum"),
                                       card)
    torch.cuda.empty_cache()
    return ({"fused_adam": lenet_launches, "fused_momentum": clip_launches},
            kernel_rows, _lenet_profile_setups())


def _lenet_profile_setups():
    """The kernel-tier LeNet program, its state after the startup
    program and a feed, at each of LENET_PROFILE_ROWS rows, built while
    the static mode is on (phase 4e turns the dygraph tracer on)."""
    from paddle_tpu_torch import fluid

    setups = []
    for n in LENET_PROFILE_ROWS:
        main, startup, (loss, _), program = _book_program(_lenet, True)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        images, labels = _blob_data(np.random.RandomState(SEED + 65), n)
        setups.append((n, exe, program, scope, loss,
                       {"img": images, "label": labels}))
    return setups


def phase_profile_lenet(setups, card, iters=20):
    """Where a kernel-tier LeNet training step's time goes, as
    ``phase_profile`` measures it, at each of LENET_PROFILE_ROWS rows:
    ``Executor.run`` with the loss fetched to the host."""
    import torch

    for n, exe, program, scope, loss, feed in setups:
        def step():
            return exe.run(program, feed=feed, fetch_list=[loss],
                           scope=scope, return_numpy=False)[0].numpy()

        host_ms, busy_ms, idle, n_kern, by_class = _profile(step, iters)
        _p(f"profile LeNet: train step, rows={n}: host {host_ms:.3f} "
           f"ms/step ({n / host_ms * 1e3:.0f} examples/s), device busy "
           f"{busy_ms:.3f} ms/step, idle share {idle:.4f}, {n_kern:.0f} "
           f"kernels/step  [{card}]")
        _print_classes(by_class, "step")
    torch.cuda.empty_cache()


_CLASSES = (("paged_attention", "paged_attention (csrc)"),
            ("embedding_pool_fwd", "embedding_pool_fwd (csrc)"),
            ("embedding_pool_grad_fill",
             "embedding_pool_grad zero-fill + tile sorts (csrc)"),
            ("embedding_pool_grad_merge", "embedding_pool_grad merge (csrc)"),
            ("embedding_pool_grad_segments",
             "embedding_pool_grad segments (csrc)"),
            ("radixsort", "CUB radix sort (embedding_pool_grad's past "
                          "32,768 positions; torch.sort)"),
            ("fused_momentum", "fused_momentum (csrc)"),
            ("flash_fwd", "flash_attention_fwd (csrc)"),
            ("flash_bwd", "flash_attention_bwd (csrc)"),
            ("fused_adam", "fused_adam (csrc)"),
            ("dropout_mask_kernel", "dropout mask (csrc)"),
            ("dropout_kernel", "dropout family (csrc)"),
            ("conv_depthwise", "depthwise convolution (PyTorch)"),
            ("wgrad", "convolution backward filter (cuDNN)"),
            ("dgrad", "convolution backward data (cuDNN)"),
            ("fprop", "convolution forward (cuDNN)"),
            ("convolve", "convolution, other (cuDNN)"),
            ("cudnn", "convolution, other (cuDNN)"),
            ("nchwtonhwc", "convolution layout (cuDNN)"),
            ("nhwctonchw", "convolution layout (cuDNN)"),
            ("pool", "pooling"),
            ("gemm", "matmul (cuBLAS)"), ("xmma", "matmul (cuBLAS)"),
            ("nvjet", "matmul (cuBLAS)"),
            ("cutlass", "matmul (cuBLAS)"), ("catarray", "concatenations"),
            ("memcpy", "host copies"), ("memset", "host copies"),
            ("direct_copy", "copies and casts"),
            ("index", "embedding gather/scatter"),
            ("reduce", "reductions"), ("softmax", "softmax"),
            ("elementwise", "elementwise"), ("vectorized", "elementwise"))


def _kernel_class(name):
    n = name.lower()
    return next((label for key, label in _CLASSES if key in n), "other")


def _union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total


def _product_flops(program, rows):
    """2·M·K·N summed over the program's ``mul`` ops (the fc products
    that go to cuBLAS), with the batch dim set to ``rows``."""
    blk = program.global_block()
    total = 0.0
    for op in blk.ops:
        if op.type != "mul":
            continue
        xs = [rows if d == -1 else d for d in blk.var(op.input("X")[0]).shape]
        ys = blk.var(op.input("Y")[0]).shape
        xk, yk = op.attr("x_num_col_dims", 1), op.attr("y_num_col_dims", 1)
        total += 2.0 * math.prod(xs[:xk]) * math.prod(xs[xk:]) \
            * math.prod(ys[yk:])
    return total


# the last ``_profile`` window's kernels by name: [device ms per call,
# launches in the window]
PROFILE_BY_NAME = {}


def _profile(fn, iters):
    """(host ms per call with no profiler attached, device busy ms per
    call, profiled idle share, kernels per call, device ms per call by
    kernel class) over ``iters`` calls after 3 warm-up calls; the
    window's kernels by name are left in PROFILE_BY_NAME."""
    import torch
    from torch.autograd import DeviceType

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # now and then a profiled window comes back with no device events at
    # all (seen on the card in phase 3e's timings, once twice in a row);
    # such a window is measured again, up to four times, and a fifth
    # empty one fails the run
    for attempt in range(5):
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - w0) * 1e6
        kern = [e for e in prof.events()
                if e.device_type == DeviceType.CUDA]
        if kern:
            break
        _p(f"profile: window {attempt + 1} recorded no device event; "
           f"measuring again")
    if not kern:
        raise SystemExit("chip_smoke: the profiler saw no kernel on the "
                         "card")
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kern])
    by_class = {}
    PROFILE_BY_NAME.clear()
    for e in kern:
        c = _kernel_class(e.name)
        ms = (e.time_range.end - e.time_range.start) / iters / 1e3
        by_class[c] = by_class.get(c, 0.0) + ms
        calls = PROFILE_BY_NAME.setdefault(e.name, [0.0, 0])
        calls[0] += ms
        calls[1] += 1
    return (host_ms, busy_us / iters / 1e3, 1.0 - busy_us / window_us,
            len(kern) / iters, by_class)


def _flash_bwd_split(fn, iters):
    """Device ms per call of each of the backward's three kernels (Δ,
    dK/dV, dQ) over ``iters`` profiled calls after 3 warm-up calls."""
    import re
    import torch
    from torch.autograd import DeviceType

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        name = re.search(r"flash_bwd_(\w+?)_kernel", e.name)
        if e.device_type == DeviceType.CUDA and name:
            key = name.group(1)
            split[key] = split.get(key, 0.0) + \
                (e.time_range.end - e.time_range.start) / iters / 1e3
    return split


def _print_classes(by_class, unit):
    for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        _p(f"    {c:28s} {ms:.4f} ms/{unit}")


def _print_top_kernels(unit, iters, n=10):
    """The last profiled window's ``n`` longest kernels by name: device ms
    per ``unit`` and launches per ``unit``."""
    top = sorted(PROFILE_BY_NAME.items(), key=lambda kv: -kv[1][0])[:n]
    for name, (ms, count) in top:
        _p(f"      {ms:.4f} ms/{unit}, {count / iters:g} launches/{unit}: "
           f"{name[:150]}")


def phase_profile(served, trained, card, iters=20, train_iters=5):
    """Where the time goes: one dispatched batch (``Executor.run`` of the
    served program on the card plus the host copy of the logits) at 1, 8
    and 32 rows, and one training step (``Executor.run`` of the rewritten
    training program, loss fetched to the host) at 32 rows.  Host ms is
    the mean wall time with no profiler attached; device busy ms is the
    union of the kernels' intervals from ``torch.profiler``, and the idle
    share is ``1 - busy / window`` over the profiled window (the profiler
    slows the host, so it is an upper bound of the unprofiled share)."""
    from paddle_tpu_torch import fluid

    program, frozen, scope, logits = served
    exe = fluid.Executor(fluid.CUDAPlace(0))
    rng = np.random.RandomState(SEED)
    seq = BERT_BASE["seq"]
    for n in (1, 8, MAX_BATCH):
        lengths = rng.randint(1, seq + 1, n)
        feed = {"ids": rng.randint(0, BERT_BASE["vocab"], (n, seq))
                .astype("int64"),
                "attn_mask": (np.arange(seq)[None, :] < lengths[:, None])
                .astype("float32")}

        def batch():
            return exe.run(program, feed=feed, fetch_list=[logits],
                           scope=scope, return_numpy=False)[0].numpy()

        host_ms, busy_ms, idle, n_kern, by_class = _profile(batch, iters)
        cublas_ms = by_class.get("matmul (cuBLAS)", 0.0)
        gflop = _product_flops(frozen, n) / 1e9
        _p(f"profile: rows={n}: host {host_ms:.3f} ms/batch "
           f"({n / host_ms * 1e3:.1f} rows/s), device busy "
           f"{busy_ms:.3f} ms/batch, idle share {idle:.4f}, {n_kern:.0f} "
           f"kernels/batch; fc products {gflop:.2f} GFLOP at "
           f"{gflop / cublas_ms if cublas_ms else float('nan'):.1f} "
           f"TFLOP/s  [{card}]")
        _print_classes(by_class, "batch")

    program, main, scope, loss, feed = trained

    def step():
        return exe.run(program, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0].numpy()

    host_ms, busy_ms, idle, n_kern, by_class = _profile(step, train_iters)
    cublas_ms = by_class.get("matmul (cuBLAS)", 0.0)
    # each fc product runs forward, again inside generic_grad's vjp, and
    # twice more for its two gradients
    gflop = 4 * _product_flops(main, TRAIN_ROWS) / 1e9
    tokens = TRAIN_ROWS * seq
    _p(f"profile: train step, rows={TRAIN_ROWS}: host {host_ms:.3f} "
       f"ms/step ({tokens / host_ms * 1e3:.0f} tokens/s), device busy "
       f"{busy_ms:.3f} ms/step, idle share {idle:.4f}, {n_kern:.0f} "
       f"kernels/step; fc products {gflop:.2f} GFLOP at "
       f"{gflop / cublas_ms if cublas_ms else float('nan'):.1f} TFLOP/s  "
       f"[{card}]")
    _print_classes(by_class, "step")


# ---------------------------------------------------------------------------
# phase 4k: bench.py:547 main_ctr, the BoxPS CTR trainer
# ---------------------------------------------------------------------------
def _bench_ctr_program(fluid, table, slots=BOX["slots"], dim=BOX["dim"],
                       embed="box", vocab=None):
    """bench.py:571-589's program: pull_box_sparse over the pass cache
    ``<table>@HBMCACHE``, reshape, concat with the 13 dense features, fc
    256 relu, fc 128 relu, a wide fc, the sigmoid cross-entropy mean and
    SGD(0.01).  ``embed="dense"`` builds the same model over a dense
    ``[vocab, dim]`` embedding named ``table`` (the box-against-dense
    check); the parameters take the same names in both."""
    from paddle_tpu_torch.distributed.ps.box import get_box_wrapper
    from paddle_tpu_torch.fluid.framework import reset_unique_name

    reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    box = None
    with fluid.program_guard(main, startup):
        ids = fluid.data("ids", [-1, slots], dtype="int64")
        dense = fluid.data("dense", [-1, 13])
        label = fluid.data("label", [-1, 1])
        if embed == "box":
            box = get_box_wrapper(table, dim=dim, init_kind="gaussian",
                                  init_scale=0.01)
            emb = fluid.layers.pull_box_sparse(ids, dim, table_name=table)
        else:
            emb = fluid.layers.embedding(
                ids, [vocab, dim], param_attr=fluid.ParamAttr(name=table))
        flat = fluid.layers.reshape(emb, [-1, slots * dim])
        deep = fluid.layers.concat([flat, dense], axis=1)
        h = fluid.layers.fc(deep, 256, act="relu")
        h = fluid.layers.fc(h, 128, act="relu")
        wide = fluid.layers.fc(dense, 1)
        logit = fluid.layers.fc(h, 1) + wide
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(logit, label))
        fluid.optimizer.SGDOptimizer(0.01).minimize(loss)
    return main, startup, loss, box


def _bench_strategies(fluid):
    """bench.py:604-605 and :655-656: the fp32 leg's fusion and folding,
    the bf16 leg's AMP."""
    bs = fluid.BuildStrategy()
    bs.fuse_elewise_add_act_ops = True
    bs.constant_folding = True
    bs.auto_tune = bool(fluid.core.get_flag("auto_tune"))
    bs2 = fluid.BuildStrategy()
    bs2.amp = True
    return bs, bs2


def _box_feeds(box, all_ids, rng):
    """bench.py:622-627: cache slots of each batch's raw ids, dense
    features and labels drawn after the ids from the same RandomState."""
    _, batch, slots = all_ids.shape
    return [{"ids": box.slots_of(b.reshape(-1)).reshape(batch, slots),
             "dense": rng.randn(batch, 13).astype("float32"),
             "label": rng.randint(0, 2, (batch, 1)).astype("float32")}
            for b in all_ids]


def _ops_counted(main, loss):
    """bench.py:599-603's ops_per_step before the passes: the step's
    fetch-reachable ops, state writes kept."""
    from paddle_tpu_torch.fluid.framework import prune_ops
    gb = main.global_block()
    return len(prune_ops(gb, [op for op in gb.ops
                              if op.type not in ("feed", "fetch")],
                         targets=[loss.name], keep_state_writes=True))


def _box_leg(label, runner, feeds, start, base, card):
    """bench.py's timed_run over ``runner.submit(f).lazy(0)``: BOX's
    warm-up steps, then its timed steps, the float() of the last lazy
    loss the only wait; returns (losses, host ms a step, examples/s, peak
    GiB above ``base``, the bytes earlier phases still hold)."""
    import torch
    n = len(feeds)
    lazies = [runner.submit(feeds[(start + i) % n]).lazy(0)
              for i in range(BOX["warmup"])]
    float(lazies[-1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(BOX["steps"]):
        lazies.append(runner.submit(
            feeds[(start + BOX["warmup"] + i) % n]).lazy(0))
    float(lazies[-1])
    wall = time.perf_counter() - t0
    runner.drain()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    losses = [float(x) for x in lazies]
    ms = wall / BOX["steps"] * 1e3
    ex_s = BOX["steps"] * BOX["batch"] / wall
    _p(f"BoxPS CTR {label}: {BOX['steps']} timed steps of {BOX['batch']} "
       f"examples in {wall:.3f} s: {ms:.3f} host ms/step, {ex_s:.1f} "
       f"examples/s, peak device memory {peak:.3f} GiB above the "
       f"{base / 2 ** 30:.3f} GiB earlier phases hold; losses "
       f"{[round(x, 5) for x in losses]}  [{card}]")
    if not np.isfinite(losses).all():
        raise SystemExit(f"chip_smoke: BoxPS CTR {label} losses are not "
                         f"finite")
    return losses, ms, ex_s, peak


def _box_profile(label, exe, program, feed, loss, card):
    def step():
        return exe.run(program, feed=feed, fetch_list=[loss],
                       return_numpy=False)[0].numpy()

    host_ms, busy_ms, idle, n_kern, by_class = _profile(step, 5)
    _p(f"profile BoxPS CTR {label}: host {host_ms:.3f} ms/step "
       f"({BOX['batch'] / host_ms * 1e3:.0f} examples/s), device busy "
       f"{busy_ms:.3f} ms/step, idle share {idle:.4f}, {n_kern:.0f} "
       f"kernels/step  [{card}]")
    _print_classes(by_class, "step")
    return dict(host_ms=host_ms, busy_ms=busy_ms, idle=idle,
                kernels=n_kern, by_class=by_class)


def _box_kernel_tier_leg(card):
    """bench.py:677's kernel-tier leg (``_kernel_tier_variant``, :351):
    ``build_ctr_train_program(slots=26, dim=16)`` (Adam) and
    ``ctr_demo_feed(RandomState(1), batch=256)``, unrewritten and through
    ``kernel_tier``, BOX_TIER_WARMUP + BOX_TIER_STEPS steps each from one
    init.  Returns the tier run's launches over its timed steps; the
    launch counts of the plain run must read 0, the tier's exactly 26
    gather-pool forwards, 26 scatter-add gradients and 1 fused_adam a
    step; the losses within BOX_TIER_RTOL.  Then, after those counts are
    read, ``_box_tier_kernel_checks`` holds the three kernels against
    their plain versions on the leg's own inputs."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import trace
    from paddle_tpu_torch.fluid.framework import reset_unique_name
    from paddle_tpu_torch.models.static_graphs import (
        build_ctr_train_program, ctr_demo_feed)

    slots = BOX["slots"]
    feed = ctr_demo_feed(np.random.RandomState(1), batch=BOX_TIER_BATCH,
                         slots=slots)
    counted = _counted_kernels()

    def run(tier):
        reset_unique_name()
        main, startup, loss = build_ctr_train_program(slots=slots,
                                                      dim=BOX["dim"])
        startup.random_seed = SEED
        prog = main
        if tier:
            bs = fluid.BuildStrategy()
            bs.kernel_tier = True
            prog = fluid.CompiledProgram(main, build_strategy=bs)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        for _ in range(BOX_TIER_WARMUP):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        outs = [exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                        return_numpy=False)[0]
                for _ in range(BOX_TIER_STEPS)]
        losses = [float(x) for x in outs]
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        ops = int(trace.metrics().gauge("executor.ops_per_step").value)
        return losses, ops, launches, wall, main, scope

    base_losses, base_ops, base_launches, base_wall, _, _ = run(False)
    losses, ops, launches, wall, main, scope = run(True)
    want = {fn.__name__: 0 for fn in counted}
    want.update(embedding_pool_fwd=slots * BOX_TIER_STEPS,
                embedding_pool_grad=slots * BOX_TIER_STEPS,
                fused_adam=BOX_TIER_STEPS)
    err = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
    _p(f"BoxPS CTR kernel-tier leg ({slots} slots, dim {BOX['dim']}, "
       f"[{BOX_TIER_BATCH}, 5] ids into [128, 16], Adam): unrewritten "
       f"{base_ops} ops/step, {base_wall / BOX_TIER_STEPS * 1e3:.3f} ms/step; "
       f"kernel tier {ops} ops/step, {wall / BOX_TIER_STEPS * 1e3:.3f} "
       f"ms/step; launches in its {BOX_TIER_STEPS} timed steps "
       f"{ {k: v for k, v in launches.items() if v} } (per step {slots} "
       f"gather-pool, {slots} scatter-add, 1 fused_adam), unrewritten run "
       f"{sum(base_launches.values())}; losses tier {losses[-1]:.6f}, "
       f"unrewritten {base_losses[-1]:.6f}, max relative difference "
       f"{err:.3e} (rtol {BOX_TIER_RTOL})  [{card}]")
    if launches != want or any(base_launches.values()):
        raise SystemExit("chip_smoke: the kernel-tier CTR leg did not run "
                         "through its kernels exactly as expected")
    if err > BOX_TIER_RTOL or not np.isfinite(losses).all():
        raise SystemExit("chip_smoke: the kernel-tier CTR leg's losses "
                         "disagree with the unrewritten program's")
    checks = _box_tier_kernel_checks(main, scope, feed, card)
    return launches, dict(ops=ops, base_ops=base_ops,
                          ms=wall / BOX_TIER_STEPS * 1e3,
                          base_ms=base_wall / BOX_TIER_STEPS * 1e3,
                          loss_rel_err=err, **checks)


def _box_tier_kernel_checks(main, scope, feed, card):
    """The kernel-tier leg's three kernels on the leg's own inputs, each
    against its plain version: per slot, the gather-pool forward over the
    slot's [256, 5] ids into its trained [128, 16] table, prepared as the
    lowering prepares them (rtol=atol=1e-6, as phase 3), and the
    scatter-add gradient of a seeded [256, 16] cotangent (``torch.equal``
    to the host's ``index_add_``, as phase 3); ``fused_adam`` over the
    program's parameter bucket as the run left it (parameters, moments,
    beta powers and lr from the scope, a seeded gradient), the op
    ``torch.equal`` to ``_plain_fused_adam``.  Made after the leg's
    launch counts were read, so they count in no path."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.ops.ctr_ops import (
        _emb_pool_prep, _reference_embedding_pool,
        _reference_embedding_pool_grad)
    from paddle_tpu_torch.ops.optimizer_ops import _plain_fused_adam
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    gb = main.global_block()
    pools = [op for op in gb.ops if op.type == "fused_embedding_pool"]
    adams = [op for op in gb.ops if op.type == "fused_adam"]
    if len(pools) != BOX["slots"] or len(adams) != 1:
        raise SystemExit("chip_smoke: the kernel-tier CTR program does not "
                         "hold 26 fused pools and one fused_adam")
    fwd_err, fwd_ok, grad_equal, grad_err = 0.0, True, True, 0.0
    for op in pools:
        w, ids, wgt = _emb_pool_prep(
            {"W": [scope.find_var(op.input("W")[0])],
             "Ids": [torch.as_tensor(feed[op.input("Ids")[0]],
                                     device=dev)]}, op.attrs)
        ids = ids.long()
        out = cuda_kernels.embedding_pool_fwd(w, ids, wgt)
        ref = _reference_embedding_pool(w, ids, wgt,
                                        op.attr("padding_idx", -1))
        fwd_ok &= torch.allclose(out, ref, rtol=1e-6, atol=1e-6)
        fwd_err = max(fwd_err, (out - ref).abs().max().item())
        g = torch.randn((ids.shape[0], w.shape[1]), generator=gen,
                        device=dev)
        dw = cuda_kernels.embedding_pool_grad(g, ids, wgt, w.shape[0])
        host = _reference_embedding_pool_grad(
            g.cpu(), ids.cpu(), None if wgt is None else wgt.cpu(),
            w.shape[0])
        grad_equal &= torch.equal(dw.cpu(), host)
        grad_err = max(grad_err, (dw.cpu() - host).abs().max().item())
    op, = adams
    ins = {slot: [scope.find_var(n) for n in op.input(slot)]
           for slot in ("Param", "Moment1", "Moment2", "Beta1Pow",
                        "Beta2Pow", "LearningRate")}
    ins["Grad"] = [1e-2 * torch.randn(p.shape, generator=gen, device=dev)
                   for p in ins["Param"]]
    b1, b2, eps = (op.attr("beta1"), op.attr("beta2"), op.attr("epsilon"))
    before = cuda_kernels.fused_adam.launches
    fused = get_op("fused_adam").fn(ins, op.attrs, LoweringContext(dev))
    launched = cuda_kernels.fused_adam.launches - before
    plain = _plain_fused_adam(
        ins["Param"], ins["Grad"], ins["Moment1"], ins["Moment2"],
        ins["LearningRate"][0], ins["Beta1Pow"], ins["Beta2Pow"], b1, b2,
        eps)
    adam_equal, adam_err = True, 0.0
    for slot, outs in plain.items():
        for got, want in zip(fused[slot], outs):
            adam_equal &= torch.equal(got, want)
            adam_err = max(adam_err, (got - want).abs().max().item())
    n = sum(p.numel() for p in ins["Param"])
    _p(f"BoxPS CTR kernel-tier leg's kernels on its own inputs: "
       f"embedding_pool_fwd over {len(pools)} slots' [{BOX_TIER_BATCH}, 5] "
       f"ids into their trained tables, max |err| vs plain {fwd_err:.3e} "
       f"(rtol=atol=1e-6); embedding_pool_grad torch.equal to the host's "
       f"index_add_ = {grad_equal} (max |err| {grad_err:.3e}); fused_adam "
       f"over the program's {len(ins['Param'])} parameters ({n} values), "
       f"{launched} launch, torch.equal to its plain version = "
       f"{adam_equal} (max |err| {adam_err:.3e})  [{card}]")
    if not fwd_ok:
        raise SystemExit("chip_smoke: embedding_pool_fwd disagrees with its "
                         "plain version on the kernel-tier CTR leg's inputs")
    if not grad_equal:
        raise SystemExit("chip_smoke: embedding_pool_grad disagrees with "
                         "the host on the kernel-tier CTR leg's inputs")
    if launched != 1 or not adam_equal:
        raise SystemExit("chip_smoke: fused_adam disagrees with its plain "
                         "version on the kernel-tier CTR leg's bucket")
    return dict(pool_fwd_max_abs_err=fwd_err, pool_grad_max_abs_err=grad_err,
                adam_max_abs_err=adam_err)


def _box_state_names(main):
    """The program's persistable state but the pass cache: the
    parameters and the learning rate."""
    return [n for n, v in main.global_block().vars.items()
            if v.persistable and not n.endswith("@HBMCACHE")]


def _worst_rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _box_card_vs_host(card):
    """At BOX_HOST (26 slots, dim 16, batch 256, 3 steps, ids from a
    2048-value space, so each repeats about three times a batch and the
    cache gradient sums them) from one state (the fc weights of one
    startup, the cache staged once from a seed):
    the card's losses within rtol 1e-5 of the host's and its trained
    cache rows within 1e-6 of their largest; a twin on the card that
    feeds ``slots_of(ids) + 1`` (the same shapes, the wrong rows) must
    miss; and the same model over a dense ``embedding`` table holding
    the cache on the card agrees with the box program within rtol 1e-5
    (tests/test_box_ps.py:146) and 1e-6 of the largest row."""
    from paddle_tpu_torch import fluid, interop

    t0 = time.perf_counter()
    bs, _ = _bench_strategies(fluid)
    main, startup, loss, box = _bench_ctr_program(fluid, "box_host_check")
    fluid.CompiledProgram(main, build_strategy=bs)._apply_ir_passes(
        [loss.name])
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    init = interop.scope_to_numpy(scope, _box_state_names(main))
    rng = np.random.RandomState(SEED + 5)
    all_ids = rng.randint(0, BOX_HOST["ids"], (BOX_HOST["steps"],
                                               BOX_HOST["batch"],
                                               BOX["slots"]),
                          dtype=np.int64)
    repeats = min(np.unique(b, return_counts=True)[1].max() for b in all_ids)
    if repeats < 2:
        raise SystemExit("chip_smoke: the BoxPS card-vs-host ids do not "
                         "repeat within a batch")
    cache = box.begin_pass(all_ids)
    n = box.pass_size
    feeds = _box_feeds(box, all_ids, rng)
    cname = "box_host_check@HBMCACHE"

    def steps(program, place, feeds, table=cname):
        """Losses and trained rows of the table (the box cache, or the
        dense embedding that holds the same values) from one state."""
        s = interop.scope_from_numpy(dict(init, **{table: cache}),
                                     fluid.Scope(), place)
        exe = fluid.Executor(place)
        losses = [float(exe.run(program, feed=f, fetch_list=[loss.name],
                                scope=s)[0]) for f in feeds]
        return losses, interop.scope_to_numpy(s, [table])[table][:n]

    card_l, card_c = steps(main, fluid.CUDAPlace(0), feeds)
    host_l, host_c = steps(main, fluid.CPUPlace(), feeds)
    twin = [dict(f, ids=(f["ids"] + 1) % len(cache)) for f in feeds]
    twin_l, twin_c = steps(main, fluid.CUDAPlace(0), twin)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_l, host_l))
    rows_err = _worst_rel(card_c, host_c)
    twin_loss = max(abs(a - b) / abs(b) for a, b in zip(twin_l, host_l))
    twin_rows = _worst_rel(twin_c, host_c)
    dmain, _, dloss, _ = _bench_ctr_program(
        fluid, "dense_emb", embed="dense", vocab=len(cache))
    fluid.CompiledProgram(dmain, build_strategy=bs)._apply_ir_passes(
        [dloss.name])
    dense_l, dense_c = steps(dmain, fluid.CUDAPlace(0), feeds,
                             table="dense_emb")
    dense_err = max(abs(a - b) / abs(b) for a, b in zip(card_l, dense_l))
    dense_rows = _worst_rel(card_c, dense_c)
    _p(f"BoxPS CTR card vs host at {BOX_HOST['batch']} x {BOX['slots']} "
       f"slots, dim {BOX['dim']}, {BOX_HOST['steps']} steps, {all_ids.size} "
       f"ids over {n} unique in a {len(cache)}-row cache (every batch "
       f"holds some id {repeats} times or more), in "
       f"{time.perf_counter() - t0:.1f} s: "
       f"losses card {card_l}, host {host_l}, max relative difference "
       f"{loss_err:.3e} (rtol 1e-5); trained rows max |card - host| / max "
       f"|row| {rows_err:.3e} (1e-6); the slots + 1 twin {twin_loss:.3e} "
       f"(losses), {twin_rows:.3e} (rows), must miss; the dense-embedding "
       f"model on the card {dense_err:.3e} (losses, rtol 1e-5), "
       f"{dense_rows:.3e} (rows, 1e-6)  [{card}]")
    box.abandon_pass()
    if loss_err > 1e-5 or rows_err > 1e-6:
        raise SystemExit("chip_smoke: the card's BoxPS CTR steps disagree "
                         "with the host's")
    if twin_loss <= 1e-5 and twin_rows <= 1e-6:
        raise SystemExit("chip_smoke: the BoxPS card-vs-host check cannot "
                         "tell the right cache rows from the wrong ones")
    if dense_err > 1e-5 or dense_rows > 1e-6:
        raise SystemExit("chip_smoke: the box program disagrees with the "
                         "same model over a dense embedding")
    return dict(loss_rel_err=loss_err, rows_rel_err=rows_err,
                twin_loss_rel=twin_loss, twin_rows_rel=twin_rows,
                dense_loss_rel_err=dense_err, dense_rows_rel_err=dense_rows)


def _write_multislot(path, ids, dense, labels):
    """MultiSlot text (tests/test_box_ps.py:60-73): per record the id
    slot's count and ids, the 13 dense values, the label."""
    with open(path, "w") as f:
        for r, d, y in zip(ids, dense, labels):
            f.write(" ".join([str(len(r))] + [str(int(v)) for v in r]
                             + ["13"] + ["%r" % float(v) for v in d]
                             + ["1", "%r" % float(y)]) + "\n")


def _box_dataset_route(card):
    """The dataset-driven trainer on the card: BOX_DATASET["passes"]
    passes of MultiSlot files written from a seed into a temporary
    directory (half of each later pass's ids shared with the pass before),
    loaded by ``InMemoryDataset`` and trained (the BoxPS program, batch
    BOX_DATASET["batch"]; ids from a BOX_DATASET["ids"]-value space, so
    they repeat within a batch) by ``exe.train_from_dataset`` one pass at a
    time
    (begin_pass and end_pass around each) and by ``exe.train_passes``
    (pass N+1 staged while pass N trains) from one state: every loss and
    every host row bit for bit."""
    import tempfile
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.distributed.ps.box import get_box_wrapper

    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 9)
    slots, recs = BOX["slots"], BOX_DATASET["records"]
    place = fluid.CUDAPlace(0)
    with tempfile.TemporaryDirectory() as tmp:
        passes, prev = [], None
        for p in range(BOX_DATASET["passes"]):
            ids = rng.randint(0, BOX_DATASET["ids"], (recs, slots),
                              dtype=np.int64)
            if prev is not None:
                ids[: recs // 2] = prev[rng.permutation(recs)[: recs // 2]]
            prev = ids
            paths = []
            for k in range(2):
                path = os.path.join(tmp, f"pass{p}-part{k}")
                part = slice(k * recs // 2, (k + 1) * recs // 2)
                _write_multislot(path, ids[part],
                                 rng.randn(recs // 2, 13),
                                 rng.randint(0, 2, recs // 2))
                paths.append(path)
            passes.append(paths)

        def run(table, piped):
            main, startup, loss, _ = _bench_ctr_program(fluid, table)
            exe = fluid.Executor(place)
            exe.run(startup)
            interop.scope_from_numpy(init, fluid.global_scope(), place)
            gb = main.global_block()
            dss = []
            for paths in passes:
                ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
                ds.set_batch_size(BOX_DATASET["batch"])
                ds.set_use_var([gb.var("ids"), gb.var("dense"),
                                gb.var("label")])
                ds.set_filelist(paths)
                ds.load_into_memory()
                dss.append(ds)
            if piped:
                res = exe.train_passes(main, dss, fetch_list=[loss],
                                       print_period=1)
            else:
                res = [exe.train_from_dataset(main, ds, fetch_list=[loss],
                                              print_period=1)
                       for ds in dss]
            losses = [float(np.asarray(o[0]).ravel()[0])
                      for r in res for o in r]
            box = get_box_wrapper(table)
            host = interop.box_to_numpy(box)
            return losses, host, box

        main, startup, _, _ = _bench_ctr_program(fluid, "box_ds_init")
        s = fluid.Scope()
        fluid.Executor(place).run(startup, scope=s)
        init = interop.scope_to_numpy(s, _box_state_names(main))
        serial_l, serial_h, _ = run("box_ds_serial", False)
        piped_l, piped_h, box = run("box_ds_piped", True)
    same = (serial_l == piped_l
            and np.array_equal(serial_h["host_ids"], piped_h["host_ids"])
            and np.array_equal(serial_h["host_vals"], piped_h["host_vals"]))
    n_steps = BOX_DATASET["passes"] * recs // BOX_DATASET["batch"]
    _p(f"BoxPS CTR dataset route: {BOX_DATASET['passes']} passes of {recs} "
       f"MultiSlot records (half of pass 2's ids from pass 1), batch "
       f"{BOX_DATASET['batch']}, in {time.perf_counter() - t0:.1f} s: "
       f"train_from_dataset losses {serial_l}, train_passes {piped_l}; "
       f"{len(piped_h['host_ids'])} host rows; bit for bit: {same}  "
       f"[{card}]")
    if not same or len(piped_l) != n_steps or box.pass_size != 0:
        raise SystemExit("chip_smoke: train_passes on the card is not bit "
                         "for bit the serial begin/end pass loop")
    return dict(steps=n_steps, host_rows=len(piped_h["host_ids"]))


def phase_train_boxps(card):
    """bench.py:547 main_ctr on the card at its full width: the BoxPS fp32
    leg, the bf16 leg, the kernel-tier leg, the card-vs-host and
    box-vs-dense checks and the dataset-driven trainer.  Returns the
    kernel-tier leg's launches over its timed steps, the fp32 and bf16
    legs' launches (each must read 0) and what the summary and PERF.md
    read."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed.ps.box import reset_box_wrappers
    from paddle_tpu_torch.fluid import trace

    m = trace.metrics()
    counted = _counted_kernels()
    out = {}
    reset_box_wrappers()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with _fresh_fluid_globals():
        main, startup, loss, box = _bench_ctr_program(fluid, "bench_box")
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        scope = fluid.global_scope()
        ops_before = _ops_counted(main, loss)
        bs, bs2 = _bench_strategies(fluid)
        train_prog = fluid.CompiledProgram(main, build_strategy=bs)
        rng = np.random.RandomState(0)
        n_batches = BOX["steps"] + BOX["warmup"]
        all_ids = rng.randint(0, BOX_ID_SPACE,
                              (n_batches, BOX["batch"], BOX["slots"]),
                              dtype=np.int64)
        t0 = time.perf_counter()
        cache = box.begin_pass(all_ids)
        staging_s = time.perf_counter() - t0
        cname = "bench_box@HBMCACHE"
        scope.set_var(cname, cache)
        feeds = _box_feeds(box, all_ids, rng)
        _p(f"BoxPS CTR: begin_pass over {all_ids.size} ids of a 2^40 space "
           f"in {staging_s:.3f} s (host): {box.pass_size} unique ids, "
           f"{box.cache_rows} cache rows x {BOX['dim']} float32 = "
           f"{cache.nbytes / 2 ** 20:.1f} MiB on the card")
        out.update(staging_s=staging_s, unique_ids=box.pass_size,
                   cache_rows=box.cache_rows, cache_mib=cache.nbytes / 2 ** 20)
        if box.cache_rows != 1 << int(np.ceil(np.log2(box.pass_size))):
            raise SystemExit("chip_smoke: the BoxPS cache is not the pass's "
                             "unique ids padded to a power of two")
        del cache

        # the fp32 leg: the BoxPS legs launch no hand-written kernel.
        # Its labels are random, so a step's loss moves with its batch;
        # what must fall is the loss over all the leg's batches, read by
        # the forward program before and after the leg
        test_prog = main.clone(for_test=True)

        def dataset_loss():
            return float(np.mean([
                float(exe.run(test_prog, feed=f, fetch_list=[loss])[0])
                for f in feeds]))

        before = dataset_loss()
        for fn in counted:
            fn.launches = 0
        runner = fluid.AsyncStepRunner(exe, train_prog, [loss])
        fp32_l, fp32_ms, fp32_ex, fp32_peak = _box_leg(
            "fp32 leg", runner, feeds, 0, base, card)
        ops_after = int(m.gauge("executor.ops_per_step").value)
        after = dataset_loss()
        _p(f"BoxPS CTR: ops_per_step {ops_before} -> {ops_after} "
           f"(bench.py:650; the reference's 42 -> 38); the loss over the "
           f"leg's {len(feeds)} batches falls {before:.6f} -> {after:.6f}")
        if (ops_before, ops_after) != (42, 38) or not after < before:
            raise SystemExit("chip_smoke: the BoxPS fp32 leg did not run "
                             "the reference's fused program, or did not "
                             "train")
        out["fp32"] = dict(ms=fp32_ms, examples_s=fp32_ex, peak_gib=fp32_peak,
                           profile=_box_profile("fp32 leg", exe, train_prog,
                                                feeds[0], loss, card))

        # the bf16 leg's first step against an fp32 step from one state
        state = [n for n, v in main.global_block().vars.items()
                 if v.persistable and scope.find_var(n) is not None]
        snap = {n: scope.find_var(n).clone() for n in state}
        l32 = float(exe.run(train_prog, feed=feeds[n_batches % len(feeds)],
                            fetch_list=[loss])[0])
        for n in state:
            scope.set_var(n, snap[n])
        del snap
        c0 = m.counter("amp.ops_cast").value
        amp_prog = fluid.CompiledProgram(main, build_strategy=bs2)
        amp_runner = fluid.AsyncStepRunner(exe, amp_prog, [loss])
        bf16_l, bf16_ms, bf16_ex, bf16_peak = _box_leg(
            "bf16 leg", amp_runner, feeds, n_batches, base, card)
        casts = m.counter("amp.ops_cast").value - c0
        amp_ops = int(m.gauge("executor.ops_per_step").value)
        boxps_launches = {fn.__name__: fn.launches for fn in counted}
        _p(f"BoxPS CTR bf16 leg: amp.ops_cast {casts} (the reference's "
           f"{AMP_CASTS_REFERENCE}), ops_per_step {amp_ops}; first loss "
           f"{bf16_l[0]:.6f} against fp32 {l32:.6f} from one state (rtol "
           f"0.05, atol 0.05); amp speed-up {bf16_ex / fp32_ex:.3f}; "
           f"hand-written kernel launches in both legs "
           f"{sum(boxps_launches.values())} (must be 0)")
        if casts != AMP_CASTS_REFERENCE or amp_ops != 38 \
                or not np.isclose(bf16_l[0], l32, rtol=0.05, atol=0.05):
            raise SystemExit("chip_smoke: the BoxPS bf16 leg parts from "
                             "the reference's")
        if any(boxps_launches.values()):
            raise SystemExit("chip_smoke: a BoxPS leg launched a "
                             "hand-written kernel the reference's does not")
        out["bf16"] = dict(ms=bf16_ms, examples_s=bf16_ex, peak_gib=bf16_peak,
                           first_loss=bf16_l[0], fp32_loss=l32,
                           profile=_box_profile("bf16 leg", exe, amp_prog,
                                                feeds[0], loss, card))
        out.update(ops_before=ops_before, ops_after=ops_after,
                   amp_casts=casts)

        # end_pass: the host store holds exactly the card's trained rows
        cache_t = scope.find_var(cname)
        uniq = box.pass_ids.copy()
        trained = cache_t[: len(uniq)].cpu().numpy()
        t0 = time.perf_counter()
        box.end_pass(cache_t)
        end_s = time.perf_counter() - t0
        host = box.host.pull(uniq)
        same = np.array_equal(host, trained)
        _p(f"BoxPS CTR: end_pass in {end_s:.3f} s (host); host rows "
           f"{box.host_rows()}, equal to the card's trained cache: {same}; "
           f"pass closed: {box.pass_size == 0}")
        if not same or box.pass_size != 0:
            raise SystemExit("chip_smoke: end_pass did not write the card's "
                             "trained rows back")
        out["end_pass_s"] = end_s
        del cache_t, trained, host
        scope.erase(cname)
        torch.cuda.empty_cache()

        tier_launches, out["tier"] = _box_kernel_tier_leg(card)
        out["host_check"] = _box_card_vs_host(card)
        out["dataset"] = _box_dataset_route(card)
    reset_box_wrappers()
    return tier_launches, boxps_launches, out


def phase_profile_ctr(served, trained, card, iters=20, train_iters=5):
    """Where the CTR path's time goes, as ``phase_profile`` measures it:
    one dispatched batch of the served program at 1, 64 and 512 rows and
    one training step at CTR_TRAIN_ROWS rows."""
    from paddle_tpu_torch import fluid

    program, frozen, scope, logit = served
    exe = fluid.Executor(fluid.CUDAPlace(0))
    rng = np.random.default_rng(SEED + 3)
    perm = rng.permutation(CTR["vocab"])
    for n in (1, 64, CTR_MAX_BATCH):
        feed = _ctr_feed(rng, n, CTR["vocab"], perm)

        def batch():
            return exe.run(program, feed=feed, fetch_list=[logit],
                           scope=scope, return_numpy=False)[0].numpy()

        host_ms, busy_ms, idle, n_kern, by_class = _profile(batch, iters)
        _p(f"profile CTR: rows={n}: host {host_ms:.3f} ms/batch "
           f"({n / host_ms * 1e3:.1f} rows/s), device busy {busy_ms:.3f} "
           f"ms/batch, idle share {idle:.4f}, {n_kern:.0f} kernels/batch  "
           f"[{card}]")
        _print_classes(by_class, "batch")

    program, main, scope, loss, feed = trained

    def step():
        return exe.run(program, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0].numpy()

    host_ms, busy_ms, idle, n_kern, by_class = _profile(step, train_iters)
    _p(f"profile CTR: train step, rows={CTR_TRAIN_ROWS}: host {host_ms:.3f} "
       f"ms/step ({CTR_TRAIN_ROWS / host_ms * 1e3:.0f} rows/s), device busy "
       f"{busy_ms:.3f} ms/step, idle share {idle:.4f}, {n_kern:.0f} "
       f"kernels/step  [{card}]")
    _print_classes(by_class, "step")


# ---------------------------------------------------------------------------
# phase 4l: the 2.0 dygraph loop -- the PTB LSTM LM and the dygraph CTR
# models
# ---------------------------------------------------------------------------

def _ptb_ids(batch, vocab, device, seed):
    """Input ids and next-token labels [batch, PTB_T], int64 on
    ``device``, from one ``RandomState(seed)`` draw of PTB_T + 1 tokens a
    row."""
    import torch
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randint(0, vocab, (batch, PTB_T + 1))
                              .astype("int64")).to(device)
    return tokens[:, :-1].contiguous(), tokens[:, 1:].contiguous()


def _ptb_flops_per_token(cfg):
    """Forward FLOP a token: each layer's input and recurrent products
    (2 · H · 4H each) and the output product (2 · H · V)."""
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    return cfg["num_layers"] * 2 * (2 * h * 4 * h) + 2 * h * v


def _ptb_optimizer(model):
    """The users' optimizer: SGD over PiecewiseDecay, the gradients
    clipped to a global norm of PTB_CLIP."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    sched = optimizer.PiecewiseDecay(PTB_LR_BOUNDS, PTB_LR_VALUES)
    return sched, optimizer.SGD(learning_rate=sched,
                                parameters=model.parameters(),
                                grad_clip=ClipGradByGlobalNorm(PTB_CLIP))


def _ptb_step(model, sched, opt, ids, lbl, scaler=None):
    """One step of the users' eager loop (``scaler``: under bf16
    ``auto_cast`` through ``GradScaler``); returns the loss."""
    from paddle_tpu_torch import amp

    def step():
        if scaler is None:
            loss = model.loss(model(ids), lbl)
            loss.backward()
            opt.step()
        else:
            with amp.auto_cast():
                loss = model.loss(model(ids), lbl)
            scaler.scale(loss).backward()
            scaler.minimize(opt, loss)
        opt.clear_grad()
        sched.step()
        return loss
    return step


def _ptb_timed(label, step, card):
    """PTB_WARMUP warm-up steps, then PTB_STEPS timed ones with the launch
    counts set to 0 before and read after (exactly PTB_LAUNCHES a step);
    ms a step, tokens/s, peak memory.  Returns the launches and the
    numbers."""
    import torch

    first = float(step())
    for _ in range(PTB_WARMUP - 1):
        step()
    counted = _counted_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    losses = [step() for _ in range(PTB_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = PTB_BATCH * PTB_T
    fwd = _ptb_flops_per_token(PTB) * tokens
    out = {"ms": wall / PTB_STEPS * 1e3,
           "tokens_s": tokens * PTB_STEPS / wall, "peak_gib": peak,
           "first_loss": first, "losses": losses}
    _p(f"ptb {label}: {PTB_STEPS} steps of {PTB_BATCH} x {PTB_T} tokens in "
       f"{wall:.3f} s: {out['ms']:.2f} ms/step, {out['tokens_s']:.0f} "
       f"tokens/s, {3 * fwd * PTB_STEPS / wall / 1e12:.3f} TFLOP/s by the "
       f"3 x forward count ({3 * fwd / 1e9:.1f} GFLOP a step; the tape "
       f"runs {4 * fwd / 1e9:.1f}), peak memory {peak:.2f} GiB; first loss "
       f"{first:.4f}, losses {[round(x, 4) for x in losses]}  [{card}]")
    want = {fn.__name__: PTB_LAUNCHES.get(fn.__name__, 0) * PTB_STEPS
            for fn in counted}
    _p(f"ptb {label}: launches in the timed steps {launches}, expected "
       f"{want} (per step {PTB_LAUNCHES})")
    if launches != want:
        raise SystemExit(f"chip_smoke: the PTB {label} step did not run "
                         f"through the dropout kernels as predicted")
    if not np.isfinite(losses).all() or not losses[-1] < first:
        raise SystemExit(f"chip_smoke: the PTB {label} losses are not "
                         f"finite or did not fall")
    return launches, out


@contextlib.contextmanager
def _lstm_gates_swapped():
    """A broken twin: ``rnn_scan``'s LSTM reads its input and forget gates
    in each other's places."""
    import torch
    from paddle_tpu_torch.fluid.layers import rnn

    orig = rnn._scan_one_direction

    def swapped(mode, wi, wh, bi, bh, *args, **kwargs):
        if mode == "LSTM":
            wi, wh, bi, bh = (torch.cat([w.chunk(4)[i] for i in (1, 0, 2, 3)])
                              for w in (wi, wh, bi, bh))
        return orig(mode, wi, wh, bi, bh, *args, **kwargs)

    rnn._scan_one_direction = swapped
    try:
        yield
    finally:
        rnn._scan_one_direction = orig


def _ptb_run(place, state, twin=None):
    """At PTB_HOST from ``state``, float32, dropout live from fixed tracer
    seeds: PTB_HOST_STEPS steps of the users' loop, each loss, and the
    first step's gradients."""
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.models import PtbLm

    twin = twin or contextlib.nullcontext
    with dybase.guard(place), twin():
        tracer = dybase._dygraph_tracer()
        model = PtbLm(**PTB_HOST)
        interop.layer_from_numpy(model, state)
        ids, lbl = _ptb_ids(PTB_HOST_BATCH, PTB_HOST["vocab_size"],
                            tracer.device, SEED + 55)
        ids, lbl = dybase.to_variable(ids), dybase.to_variable(lbl)
        sched, opt = _ptb_optimizer(model)
        tracer._seed, tracer._seed_ctr = SEED + 56, 0
        losses, grads = [], None
        for _ in range(PTB_HOST_STEPS):
            loss = model.loss(model(ids), lbl)
            loss.backward()
            if grads is None:
                grads = [p.gradient() for p in model.parameters()]
            opt.step()
            opt.clear_grad()
            sched.step()
            losses.append(float(loss))
    return {"losses": losses, "grads": grads}


def _margins(got, want):
    """Each card-vs-host check's error over its tolerance (under 1
    passes): every step's loss to rtol 1e-4, the whole first-step
    gradient's cosine to 1e-4 of 1 and its norm to 1e-3."""
    cos, norm = _cosine(got["grads"], want["grads"])
    out = {f"loss {i}": abs(g - w) / abs(w) / 1e-4
           for i, (g, w) in enumerate(zip(got["losses"], want["losses"]))}
    out.update({"gradient cosine": (1 - cos) / 1e-4,
                "gradient norm": abs(norm - 1) / 1e-3})
    return out


def _card_vs_host_report(label, ok, miss, detail, card):
    fmt = ", ".join
    _p(f"{label}: card vs host {detail}  [{card}]")
    _p(f"{label}: card vs host, error / tolerance (under 1 passes): "
       + fmt(f"{k} {v:.3e}" for k, v in ok.items()))
    _p(f"{label}: the twin, error / tolerance (must miss, over 1): "
       + fmt(f"{k} {v:.3e}" for k, v in miss.items()))
    if max(ok.values()) > 1:
        raise SystemExit(f"chip_smoke: {label} on the card disagrees with "
                         f"the host")
    if max(miss.values()) <= 1:
        raise SystemExit(f"chip_smoke: the {label} card-vs-host check "
                         f"cannot see its twin's fault")


def _ptb_card_vs_host(card):
    """PTB_HOST on the card and on the host from one state (uniform in
    +-PTB_HOST_INIT from a seed), float32, dropout live (the host's plain
    Philox draws the card's masks): _margins; a host twin whose LSTM
    swaps its input and forget gates must miss."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.models import PtbLm

    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 54)
    with dybase.guard(fluid.CPUPlace()):
        shapes = {k: v.shape for k, v in PtbLm(**PTB_HOST).state_dict()
                  .items()}
    state = {k: rng.uniform(-PTB_HOST_INIT, PTB_HOST_INIT, s)
             .astype("float32")
             for k, s in shapes.items()}
    card_r = _ptb_run(fluid.CUDAPlace(0), state)
    host_r = _ptb_run(fluid.CPUPlace(), state)
    twin_r = _ptb_run(fluid.CPUPlace(), state, twin=_lstm_gates_swapped)
    ok, miss = _margins(card_r, host_r), _margins(twin_r, host_r)
    _card_vs_host_report(
        "ptb", ok, miss,
        f"at vocab {PTB_HOST['vocab_size']}, hidden "
        f"{PTB_HOST['hidden_size']}, {PTB_HOST['num_layers']} layers, "
        f"{PTB_T} steps, batch {PTB_HOST_BATCH}, dropout "
        f"{PTB_HOST['dropout']} live, {PTB_HOST_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s: losses card {card_r['losses']}, "
        f"host {host_r['losses']}, gate-swapped twin {twin_r['losses']}",
        card)
    return ok, miss


def _lstm_routes(card):
    """One LSTM layer at the PTB width, [20, 35, 1500] float32, forward
    and backward: ``rnn_scan``'s step loop (the route kept) against
    cuDNN's fused LSTM (``torch._VF.lstm``, the route not taken), device
    ms by CUDA events, outputs compared."""
    import torch
    from paddle_tpu_torch.fluid.layers import rnn

    h = PTB["hidden_size"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 57)

    def u(*shape):
        return (torch.rand(shape, generator=gen, device=DEVICE) * 2 - 1) \
            * PTB_INIT

    x = u(PTB_BATCH, PTB_T, h).requires_grad_()
    ws = [u(4 * h, h).requires_grad_(), u(4 * h, h).requires_grad_(),
          u(4 * h).requires_grad_(), u(4 * h).requires_grad_()]
    h0 = torch.zeros(1, PTB_BATCH, h, device=DEVICE)
    g = u(PTB_BATCH, PTB_T, h)

    def scan():
        out = rnn._rnn_scan({"Input": [x], "WeightList": ws,
                             "PreState": [h0, h0]},
                            {"mode": "LSTM", "num_layers": 1}, None)
        return out["Out"][0]

    def cudnn():
        # the four weights are separate tensors, as rnn_scan takes them:
        # cuDNN copies them into one buffer each call, and warns so
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch._VF.lstm(x, (h0, h0), ws, True, 1, 0.0, True,
                                  False, True)[0]

    def fwd_bwd(fn):
        return lambda: torch.autograd.backward(fn(), g)

    with torch.enable_grad():
        err = float((scan() - cudnn()).detach().abs().max())
        rows = {"scan_fwd_ms": _ms(scan, 5), "cudnn_fwd_ms": _ms(cudnn, 5),
                "scan_fwd_bwd_ms": _ms(fwd_bwd(scan), 5),
                "cudnn_fwd_bwd_ms": _ms(fwd_bwd(cudnn), 5),
                "max_abs_err": err}
    _p(f"ptb: one LSTM layer [{PTB_BATCH}, {PTB_T}, {h}] float32: rnn_scan's "
       f"step loop {rows['scan_fwd_ms']:.3f} ms forward, "
       f"{rows['scan_fwd_bwd_ms']:.3f} ms forward + backward; cuDNN's "
       f"fused LSTM (the route not taken) {rows['cudnn_fwd_ms']:.3f} and "
       f"{rows['cudnn_fwd_bwd_ms']:.3f} ms; outputs within {err:.2e}  "
       f"[{card}]")
    if not err < 1e-5:
        raise SystemExit("chip_smoke: rnn_scan disagrees with cuDNN's LSTM")
    return rows


def phase_kernels_dropout_ptb():
    """The dropout kernels at the PTB step's shape, [20, 35, 1500], rate
    0.65, float32 (the path's dtype: autocast leaves the LSTMs' inputs in
    float32) and bfloat16, ``downgrade_in_infer`` (the path's: kept
    values unscaled) and ``upscale_in_train``: phase 3e's checks, then
    dropout and its mask under ``downgrade_in_infer`` timed by the
    profiler's device ms beside the bound, the plain version's and the
    library call's.  Returns the rows by kernel name."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels, nn_ops

    shape = (PTB_BATCH, PTB_T, PTB["hidden_size"])
    rate = PTB["dropout"]
    err = 0.0
    for dtype, label in ((torch.float32, "fp32 PTB"),
                         (torch.bfloat16, "bf16 PTB")):
        for upscale in (False, True):
            err = max(err, _dropout_checks(label, dtype, rate, upscale,
                                           shape, SEED + 58))
    seed = SEED + 59
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=DEVICE)
    k0, k1 = nn_ops._key_words(seed)
    thr = nn_ops._threshold_for(rate)
    calls = {
        "fused_dropout": (
            lambda: cuda_kernels.fused_dropout(x, seed, thr, 1.0),
            lambda: nn_ops._reference_dropout(x, k0, k1, thr, 1.0),
            lambda: F.dropout(x, rate, training=True)),
        "dropout_mask": (
            lambda: cuda_kernels.dropout_mask(x, seed, thr),
            lambda: nn_ops._reference_keep(x.shape, k0, k1, thr,
                                           x.device).to(torch.uint8),
            lambda: torch.empty(x.shape, dtype=torch.uint8,
                                device=x.device).bernoulli_(1 - rate))}
    clock_hz = _sm_clock_hz()
    rows = {}
    for name, (kernel, plain, library) in calls.items():
        bound_ms, bound_by, binds = _dropout_bound(
            name, x.numel(), x.element_size(), clock_hz)
        rows[name] = row = {
            "max_abs_err": err, "ms": _profile(kernel, 20)[1],
            "plain_ms": _profile(plain, 5)[1],
            "library_ms": _profile(library, 20)[1],
            "bound_ms": bound_ms, "bound_by": bound_by, "binds": binds,
            "dtype": "float32", "shape": list(shape), "rate": rate,
            "implementation": "downgrade_in_infer"}
        _p(f"  {name} fp32 PTB {list(shape)} downgrade_in_infer: kernel "
           f"{row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | library "
           f"{row['library_ms']:.4f} ms | bound {bound_ms * 1e3:.2f} us "
           f"({binds})")
    del x
    torch.cuda.empty_cache()
    return rows


def _dyctr_batch(cfg, batch, device, seed, offsets=True):
    """Ids [batch, slots] (offset by slot unless ``offsets`` is False),
    dense features [batch, dense_dim] and 0/1 labels [batch, 1] from
    ``RandomState(seed)``, as tensors on ``device``."""
    import torch
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg["vocab_per_slot"], (batch, cfg["num_slots"]))
    if offsets:
        ids = ids + np.arange(cfg["num_slots"]) * cfg["vocab_per_slot"]
    dense = rng.randn(batch, cfg["dense_dim"]).astype("float32")
    label = rng.randint(0, 2, (batch, 1)).astype("float32")
    return [torch.from_numpy(a).to(device)
            for a in (ids.astype("int64"), dense, label)]


def _dyctr_optimizer(model):
    """``optimizer.Adam`` over a ``LinearWarmup`` to DYCTR_LR."""
    from paddle_tpu_torch import optimizer

    sched = optimizer.LinearWarmup(DYCTR_LR, DYCTR_WARMUP_STEPS, 0.0,
                                   DYCTR_LR)
    return sched, optimizer.Adam(learning_rate=sched,
                                 parameters=model.parameters())


def _dyctr_loss(model, sparse, dense, label):
    """The mean squared error of the sigmoid output against the label, as
    ``tests/ps_ctr_trainer.py`` trains WideDeep."""
    from paddle_tpu_torch.fluid import layers as L
    return L.mean(L.square(model(sparse, dense) - label))


def _dyctr_step(model, batch):
    """One step of the dygraph CTR loop on ``batch``; returns the loss."""
    from paddle_tpu_torch.dygraph import base as dybase

    sparse, dense, label = (dybase.to_variable(t) for t in batch)
    sched, opt = _dyctr_optimizer(model)

    def step():
        loss = _dyctr_loss(model, sparse, dense, label)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss
    return step


def _dyctr_state(shapes, seed):
    """A state of ``shapes`` from ``seed``: embedding rows N(0, 0.1²),
    matrices N(0, 1 / rows), biases N(0, 0.02²)."""
    rng = np.random.RandomState(seed)

    def draw(name, shape):
        if name.startswith("embed"):
            return 0.1 * rng.randn(*shape)
        if len(shape) == 2:
            return rng.randn(*shape) / np.sqrt(shape[0])
        return 0.02 * rng.randn(*shape)
    return {k: draw(k, s).astype("float32") for k, s in shapes.items()}


def _dyctr_run(place, cls, state, twin_ids=False):
    """At DYCTR_HOST from ``state``: DYCTR_HOST_STEPS steps, each loss and
    the first step's gradients; ``twin_ids`` feeds the ids without their
    slot offsets."""
    from paddle_tpu_torch import interop, models
    from paddle_tpu_torch.dygraph import base as dybase

    with dybase.guard(place):
        tracer = dybase._dygraph_tracer()
        model = getattr(models, cls)(hidden=DYCTR_HIDDEN[cls], **DYCTR_HOST)
        interop.layer_from_numpy(model, state)
        sparse, dense, label = (dybase.to_variable(t) for t in _dyctr_batch(
            DYCTR_HOST, DYCTR_HOST_BATCH, tracer.device, SEED + 61,
            offsets=not twin_ids))
        sched, opt = _dyctr_optimizer(model)
        losses, grads = [], None
        for _ in range(DYCTR_HOST_STEPS):
            loss = _dyctr_loss(model, sparse, dense, label)
            loss.backward()
            if grads is None:
                grads = [p.gradient() for p in model.parameters()]
            opt.step()
            opt.clear_grad()
            sched.step()
            losses.append(float(loss))
    return {"losses": losses, "grads": grads}


def _dyctr_card_vs_host(cls, card):
    """DYCTR_HOST on the card and on the host from one seeded state:
    _margins; a host twin fed ids without their slot offsets (every slot
    reads slot 0's rows) must miss."""
    from paddle_tpu_torch import fluid, models
    from paddle_tpu_torch.dygraph import base as dybase

    t0 = time.perf_counter()
    with dybase.guard(fluid.CPUPlace()):
        shapes = {k: v.shape for k, v in getattr(models, cls)(
            hidden=DYCTR_HIDDEN[cls], **DYCTR_HOST).state_dict().items()}
    state = _dyctr_state(shapes, SEED + 60)
    card_r = _dyctr_run(fluid.CUDAPlace(0), cls, state)
    host_r = _dyctr_run(fluid.CPUPlace(), cls, state)
    twin_r = _dyctr_run(fluid.CPUPlace(), cls, state, twin_ids=True)
    ok, miss = _margins(card_r, host_r), _margins(twin_r, host_r)
    _card_vs_host_report(
        cls, ok, miss,
        f"at {DYCTR_HOST['num_slots']} slots x "
        f"{DYCTR_HOST['vocab_per_slot']}, dim {DYCTR_HOST['embed_dim']}, "
        f"batch {DYCTR_HOST_BATCH}, {DYCTR_HOST_STEPS} Adam steps in "
        f"{time.perf_counter() - t0:.1f} s: losses card "
        f"{card_r['losses']}, host {host_r['losses']}, unoffset-ids twin "
        f"{twin_r['losses']}", card)
    return ok, miss


def _dyctr_leg(cls, card):
    """``cls`` at DYCTR's full width on the card: DYCTR_WARMUP warm-up
    and DYCTR_STEPS timed steps (no hand-written kernel launches: the
    dygraph ``Embedding`` is a gather and its gradient dense),
    examples/s, peak memory, and a profiled step."""
    import torch
    from paddle_tpu_torch import models
    from paddle_tpu_torch.dygraph import base as dybase

    t0 = time.perf_counter()
    tracer = dybase._dygraph_tracer()
    model = getattr(models, cls)(hidden=DYCTR_HIDDEN[cls], **DYCTR)
    n_params = sum(p.value().numel() for p in model.parameters())
    batch = _dyctr_batch(DYCTR, DYCTR_BATCH, tracer.device, SEED + 62)
    step = _dyctr_step(model, batch)
    table = DYCTR["num_slots"] * DYCTR["vocab_per_slot"] * DYCTR["embed_dim"]
    _p(f"{cls}: {n_params} parameters ({table} in the table, "
       f"{table * 4 / 2 ** 30:.2f} GiB float32), towers "
       f"{DYCTR_HIDDEN[cls]}, built on the card in "
       f"{time.perf_counter() - t0:.1f} s; batch {DYCTR_BATCH}, Adam "
       f"{DYCTR_LR} over LinearWarmup({DYCTR_WARMUP_STEPS})")
    first = float(step())
    for _ in range(DYCTR_WARMUP - 1):
        step()
    counted = _counted_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    losses = [step() for _ in range(DYCTR_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host_ms, busy_ms, idle, n_kern, by_class = _profile(step, 3)
    out = {"ms": wall / DYCTR_STEPS * 1e3,
           "examples_s": DYCTR_BATCH * DYCTR_STEPS / wall, "peak_gib": peak,
           "host_ms": host_ms, "busy_ms": busy_ms, "idle": idle,
           "launches": launches}
    _p(f"{cls}: {DYCTR_STEPS} steps in {wall:.3f} s: {out['ms']:.2f} "
       f"ms/step, {out['examples_s']:.0f} examples/s, peak memory "
       f"{peak:.2f} GiB; first loss {first:.5f}, losses "
       f"{[round(x, 5) for x in losses]}; launches {launches}  [{card}]")
    _p(f"profile: {cls} step, batch {DYCTR_BATCH}: host {host_ms:.3f} "
       f"ms/step, device busy {busy_ms:.3f} ms/step, idle share "
       f"{idle:.4f}, {n_kern:.0f} kernels/step  [{card}]")
    _print_classes(by_class, "step")
    _print_top_kernels("step", 3)
    if any(launches.values()):
        raise SystemExit(f"chip_smoke: the dygraph {cls} step launched a "
                         f"hand-written kernel")
    if not np.isfinite(losses).all() or not losses[-1] < first:
        raise SystemExit(f"chip_smoke: the {cls} losses are not finite or "
                         f"did not fall")
    del model, step, batch
    torch.cuda.empty_cache()
    return out


def phase_train_ptb_ctr(card):
    """Phase 4l, the 2.0 dygraph loop on the card.  (a) PtbLm at PTB's
    full width (66,034,000 parameters, uniform in +-PTB_INIT), the users'
    loop: ``loss.backward(); opt.step(); opt.clear_grad()`` through
    ``optimizer.SGD`` over a ``PiecewiseDecay`` with
    ``ClipGradByGlobalNorm``; (b) the same under bf16 ``auto_cast`` and
    ``GradScaler`` (the identity in bf16), its first loss within
    BF16_LOSS_RTOL of a float32 forward's from one state and seeds; each
    leg PTB_WARMUP + PTB_STEPS steps, PTB_LAUNCHES a step, and profiled;
    an eval forward (no dropout launch) and its perplexity; (e) the
    model through ``save_dygraph`` / ``load_dygraph`` / ``set_dict`` into
    a fresh one: its eval logits bit for bit; the route not taken for
    the LSTM; (d) card against host.  (c) dygraph WideDeep and DeepFM at
    DYCTR's width, and (d) for each.  Returns the fp32 leg's launches
    and the numbers."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as dybase

    # a tracer of its own on the card; the earlier phases' steps, which
    # phase 5 profiles, keep theirs
    with dybase.guard(fluid.CUDAPlace(0)):
        return _train_ptb_ctr(card)


def _train_ptb_ctr(card):
    import tempfile
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.dygraph.checkpoint import (load_dygraph,
                                                     save_dygraph)
    from paddle_tpu_torch.fluid.framework import _dygraph_tracer
    from paddle_tpu_torch.models import PtbLm

    t0 = time.perf_counter()
    np.random.seed(SEED)
    tracer = _dygraph_tracer()
    tracer._amp_enabled = False
    model = PtbLm(**PTB)
    gen = torch.Generator(device=tracer.device).manual_seed(SEED + 50)
    for p in model.parameters():
        p.value().uniform_(-PTB_INIT, PTB_INIT, generator=gen)
    n_params = sum(p.value().numel() for p in model.parameters())
    ids, lbl = (dybase.to_variable(t) for t in _ptb_ids(
        PTB_BATCH, PTB["vocab_size"], tracer.device, SEED + 51))
    _p(f"ptb: PtbLm({', '.join(f'{k}={v}' for k, v in PTB.items())}), "
       f"{n_params} parameters, uniform in +-{PTB_INIT}, built on the card "
       f"in {time.perf_counter() - t0:.1f} s; batch {PTB_BATCH} x {PTB_T}; "
       f"SGD over PiecewiseDecay({PTB_LR_BOUNDS}, {PTB_LR_VALUES}), "
       f"ClipGradByGlobalNorm({PTB_CLIP})")
    if n_params != PTB_PARAMS:
        raise SystemExit(f"chip_smoke: PtbLm has {n_params} parameters, "
                         f"not {PTB_PARAMS}")
    sched, opt = _ptb_optimizer(model)
    step = _ptb_step(model, sched, opt, ids, lbl)
    tracer._seed, tracer._seed_ctr = SEED + 52, 0
    launches, fp32 = _ptb_timed("fp32", step, card)
    prof = _profile(step, 3)
    fp32["profile"] = prof[:4]
    _p(f"profile: PTB fp32 step: host {prof[0]:.3f} ms/step, device busy "
       f"{prof[1]:.3f} ms/step, idle share {prof[2]:.4f}, {prof[3]:.0f} "
       f"kernels/step  [{card}]")
    _print_classes(prof[4], "step")
    _print_top_kernels("step", 3)

    # (b) bf16 autocast and GradScaler
    with dybase.no_grad():
        tracer._seed, tracer._seed_ctr = SEED + 53, 0
        f32_loss = float(model.loss(model(ids), lbl))
        tracer._seed, tracer._seed_ctr = SEED + 53, 0
        with amp.auto_cast():
            bf16_loss = float(model.loss(model(ids), lbl))
    _p(f"ptb bf16: first loss {bf16_loss}, float32 {f32_loss} from one "
       f"state and seeds (rtol {BF16_LOSS_RTOL})")
    if not (np.isfinite(bf16_loss) and np.isclose(
            bf16_loss, f32_loss, rtol=BF16_LOSS_RTOL, atol=0.0)):
        raise SystemExit("chip_smoke: the bf16 PTB loss is not finite or "
                         "not near the float32 one")
    scaler = amp.GradScaler()
    amp_step = _ptb_step(model, sched, opt, ids, lbl, scaler=scaler)
    bf16_launches, bf16 = _ptb_timed("bf16", amp_step, card)
    if scaler.is_enable() or scaler.get_scale() != 1.0:
        raise SystemExit("chip_smoke: GradScaler scaled a bf16 run")
    prof = _profile(amp_step, 3)
    bf16["profile"] = prof[:4]
    _p(f"profile: PTB bf16 step: host {prof[0]:.3f} ms/step, device busy "
       f"{prof[1]:.3f} ms/step, idle share {prof[2]:.4f}, {prof[3]:.0f} "
       f"kernels/step  [{card}]")
    _print_classes(prof[4], "step")

    # eval, then (e) the round trip
    counted = _counted_kernels()
    for fn in counted:
        fn.launches = 0
    model.eval()
    with dybase.no_grad():
        logits = model(ids)
        ppl = model.perplexity(logits, lbl)
    eval_launches = {fn.__name__: fn.launches for fn in counted}
    _p(f"ptb: eval forward, logits {logits.shape}, perplexity {ppl:.2f}; "
       f"launches {eval_launches}")
    if any(eval_launches.values()) or not np.isfinite(ppl):
        raise SystemExit("chip_smoke: the PTB eval forward failed")
    t = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = save_dygraph(model.state_dict(), os.path.join(d, "ptb"))
        size = os.path.getsize(path)
        params, _ = load_dygraph(os.path.join(d, "ptb"))
    fresh = PtbLm(**PTB)
    fresh.set_dict(params)
    fresh.eval()
    with dybase.no_grad():
        again = fresh(ids)
    same = torch.equal(again.value(), logits.value())
    _p(f"ptb: save_dygraph / load_dygraph / set_dict round trip of "
       f"{size} bytes in {time.perf_counter() - t:.2f} s: eval logits bit "
       f"for bit {same}")
    if not same:
        raise SystemExit("chip_smoke: the PTB round trip changed the "
                         "model's logits")
    del fresh, params, logits, again
    model.train()
    routes = _lstm_routes(card)
    ptb_ok = _ptb_card_vs_host(card)
    del model, opt, step, amp_step
    torch.cuda.empty_cache()

    # (c) and (d): the dygraph CTR models
    ctr = {}
    for cls in ("WideDeep", "DeepFM"):
        ctr[cls] = _dyctr_leg(cls, card)
        ctr[cls]["card_vs_host"] = _dyctr_card_vs_host(cls, card)
    return launches, {"fp32": fp32, "bf16": bf16,
                      "bf16_launches": bf16_launches, "routes": routes,
                      "card_vs_host": ptb_ok, "ctr": ctr}


# ---------------------------------------------------------------------------
# phase 4m: the 2.0 API surface, hapi.Model.fit through both adapters and
# paddle.grad
# ---------------------------------------------------------------------------
def _hapi_lenet():
    """tests/test_static_e2e.py:38's LeNet as a Layer, which runs in a
    program and on the tape alike: conv 6@3x3 pad 1 + relu + 2x2 max-pool,
    conv 16@5x5 + relu + 2x2 max-pool, flatten, fc 120 relu, fc 10."""
    from paddle_tpu_torch import nn
    return nn.Sequential(
        nn.Conv2D(1, 6, 3, padding=1), nn.ReLU(), nn.MaxPool2D(2, 2),
        nn.Conv2D(6, 16, 5), nn.ReLU(), nn.MaxPool2D(2, 2), nn.Flatten(),
        nn.Linear(400, 120), nn.ReLU(), nn.Linear(120, 10))


def _hapi_digits():
    images, labels = _blob_data(np.random.RandomState(SEED + 70),
                                HAPI_LENET_IMAGES)
    return [(x, y) for x, y in zip(images, labels)]


class _StepLosses:
    """A hapi callback that keeps each batch's loss and the host clock
    at its end (each ``train_batch`` reads its loss, so the step is done
    by then)."""

    def __init__(self):
        self.losses = []
        self.ends = []

    def set_model(self, model):
        self.model = model

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))
        self.ends.append(time.perf_counter())


def _hapi_fit_lenet(static, init, data, card, twin=False):
    """LeNet through Model.fit (static or dygraph adapter) from ``init``
    (arrays in parameter order): per-batch losses, steps/s, launches,
    and the model."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import hapi, interop, nn, optimizer as opt

    net = _hapi_lenet()
    model = paddle.Model(
        net, inputs=[hapi.Input([-1, 1, 28, 28], "float32", "img")],
        labels=[hapi.Input([-1, 1], "int64", "label")])
    model.prepare(optimizer=opt.Adam(1e-3, parameters=model.parameters()),
                  loss=nn.CrossEntropyLoss(),
                  metrics=[paddle.metric.Accuracy()])
    init = list(init)
    if twin:        # conv1's filters 0 and 1 swapped
        init[0] = init[0][[1, 0] + list(range(2, init[0].shape[0]))]
    interop.model_from_numpy(model, init)
    counted = _counted_kernels()
    for fn in counted:
        fn.launches = 0
    rec = _StepLosses()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(data, batch_size=HAPI_LENET_BATCH, epochs=HAPI_LENET_EPOCHS,
              verbose=0, shuffle=False, callbacks=[rec])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    # the last epoch's steps/s: the first batch builds the programs
    per_epoch = len(rec.ends) // HAPI_LENET_EPOCHS
    last = rec.ends[-per_epoch - 1:]
    rates = (len(rec.losses) / wall, (len(last) - 1) / (last[-1] - last[0]))
    return rec.losses, rates, launches, model


def _hapi_lenet_legs(card):
    """(a) the static adapter, with evaluate and save/load bit for bit,
    and (b) the dygraph adapter from the same weights, its trajectory
    held to (a)'s, with a swapped-filters twin that must miss."""
    import tempfile
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.fluid.framework import (_dygraph_tracer,
                                                  _set_dygraph_tracer)

    data = _hapi_digits()
    rng = np.random.RandomState(SEED + 71)
    with dybase.guard(fluid.CPUPlace()):
        shapes = [p.shape for p in _hapi_lenet().parameters()]
    init = [(rng.randn(*s) * 0.1).astype("float32") for s in shapes]
    prev = _dygraph_tracer()
    _set_dygraph_tracer(None)           # a program: the static adapter
    try:
        with _fresh_fluid_globals():
            t0 = time.perf_counter()
            s_losses, s_rate, s_launch, model = _hapi_fit_lenet(
                True, init, data, card)
            ev = model.evaluate(data, batch_size=HAPI_LENET_BATCH,
                                verbose=0)
            x = np.stack([d[0] for d in data[:HAPI_LENET_BATCH]])
            before = model.predict_batch([x])[0]
            with tempfile.TemporaryDirectory() as d:
                model.save(os.path.join(d, "lenet"))
                state = model._adapter.state_dict()
                model._adapter.set_state_dict(
                    {k: np.zeros_like(v) for k, v in state.items()})
                zeroed = model.predict_batch([x])[0]
                model.load(os.path.join(d, "lenet"))
            after = model.predict_batch([x])[0]
            s_wall = time.perf_counter() - t0
    finally:
        _set_dygraph_tracer(prev)
    steps = len(s_losses)
    _p(f"hapi: (a) LeNet through Model.fit, static adapter: {steps} steps "
       f"of {HAPI_LENET_BATCH} in {HAPI_LENET_EPOCHS} epochs, "
       f"{s_rate[0]:.1f} steps/s over the fit (the programs' build at the "
       f"first batch included), {s_rate[1]:.1f} over its last epoch; "
       f"losses first {s_losses[0]:.5f}, last "
       f"{s_losses[-1]:.5f}; evaluate {ev}; launches {s_launch}; "
       f"{s_wall:.1f} s with evaluate and save/load  [{card}]")
    _p("hapi: (a) fused_adam launches 0 a step, where phase 4g's kernel "
       "tier has 1: Model's static adapter runs the plain train program "
       "(it applies BuildStrategy passes only for amp_level, as the "
       "reference's does), so no fuse_optimizer pass makes the op")
    if not (np.isfinite(s_losses).all() and s_losses[-1] < s_losses[0]):
        raise SystemExit("chip_smoke: the static hapi LeNet did not train")
    if not np.array_equal(before, after) or np.array_equal(before, zeroed):
        raise SystemExit("chip_smoke: the static hapi save/load did not "
                         "give the predictions back bit for bit")
    if any(s_launch.values()):
        raise SystemExit("chip_smoke: the static hapi LeNet launched a "
                         "kernel none of its ops has")
    with dybase.guard(fluid.CUDAPlace(0)):
        d_losses, d_rate, d_launch, _ = _hapi_fit_lenet(False, init, data,
                                                        card)
        t_losses, _, _, _ = _hapi_fit_lenet(False, init, data, card,
                                            twin=True)

    def worst(got):
        return float(np.max(np.abs(np.subtract(got, s_losses))
                            / np.abs(s_losses))) / HAPI_LENET_RTOL

    ok, miss = worst(d_losses), worst(t_losses)
    _p(f"hapi: (b) the same LeNet through the dygraph adapter: "
       f"{d_rate[0]:.1f} steps/s over the fit, {d_rate[1]:.1f} over its "
       f"last epoch, launches {d_launch}; its {steps} losses "
       f"against the static adapter's, worst error / tolerance (rtol "
       f"{HAPI_LENET_RTOL}) {ok:.3e}; the swapped-filters twin's "
       f"{miss:.3e} (must be over 10)  [{card}]")
    if ok > 1 or miss <= 10:
        raise SystemExit("chip_smoke: the dygraph hapi LeNet's trajectory "
                         "does not hold to the static adapter's, or the "
                         "twin cannot be told apart")
    return s_launch, {"static_steps_per_s": s_rate[1],
                      "dygraph_steps_per_s": d_rate[1],
                      "trajectory_margin": ok, "twin_margin": miss}


class _GradTap:
    """An optimizer stand-in for the card-vs-path check: ``step`` keeps
    each parameter's gradient (float32, on the host) and updates
    nothing."""

    def __init__(self, params):
        self._params = params
        self.grads = None

    def step(self):
        self.grads = [p._grad.float().cpu().numpy() for p in self._params]

    def clear_grad(self):
        for p in self._params:
            p.clear_gradient()


def _hapi_nmt_check(card):
    """The first train_batch through Model (dropout 0, bf16 O1) against
    phase 4i's functional step from the same weights and batch: the
    loss within HAPI_NMT_LOSS_RTOL, the whole gradient's cosine above
    HAPI_NMT_COSINE; a twin whose labels are each shifted one id
    (``(label + 1) % vocab``) must miss.  (Labels rolled one position
    along the sequence are no twin: each row keeps its multiset of
    labels, and at random weights the gradient barely moves.)"""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.fluid.framework import _dygraph_tracer
    from paddle_tpu_torch.models import TransformerModel

    tracer = _dygraph_tracer()
    np.random.seed(SEED + 72)
    net = TransformerModel(**dict(NMT, dropout=0.0))
    ids = _nmt_ids(NMT_BATCH, NMT_SEQ, NMT_SEQ, NMT["tgt_vocab"],
                   tracer.device)
    pv, grad_fn = _nmt_grad(net)
    tracer._amp_enabled = True
    grads, loss = grad_fn(pv, *ids)
    tracer._amp_enabled = False
    want_loss = float(loss)
    want = [g.float().cpu().numpy() for g in grads]
    del grads, loss
    tap = _GradTap(net.parameters())
    model = paddle.Model(net)
    model.prepare(optimizer=tap, loss=nn.CrossEntropyLoss(),
                  amp_level="O1")
    src, tgt_in, tgt_out = ids
    got_loss = model.train_batch([src, tgt_in], [tgt_out[..., None]])[0]
    got = tap.grads
    twin_loss = model.train_batch(
        [src, tgt_in], [((tgt_out + 1) % NMT["tgt_vocab"])[..., None]])[0]
    twin = tap.grads
    cos, norm = _cosine(got, want)
    tcos, tnorm = _cosine(twin, want)
    ok = {"loss": abs(got_loss - want_loss) / abs(want_loss)
          / HAPI_NMT_LOSS_RTOL,
          "gradient cosine": (1 - cos) / (1 - HAPI_NMT_COSINE)}
    miss = {"loss": abs(twin_loss - want_loss) / abs(want_loss)
            / HAPI_NMT_LOSS_RTOL,
            "gradient cosine": (1 - tcos) / (1 - HAPI_NMT_COSINE)}
    _p(f"hapi: (c) NMT check, first train_batch (dropout 0, bf16 O1) "
       f"against phase 4i's functional step: losses {got_loss} and "
       f"{want_loss}, gradient cosine {cos:.7f}, norm ratio {norm:.6f}; "
       f"error / tolerance {ok}; the shifted-ids twin's (loss "
       f"{twin_loss}, cosine {tcos:.5f}) {miss}  [{card}]")
    del net, model, pv, grad_fn, want, got, twin
    if max(ok.values()) > 1:
        raise SystemExit("chip_smoke: the NMT train_batch on the tape "
                         "disagrees with the functional step")
    if max(miss.values()) <= 10:
        raise SystemExit("chip_smoke: the NMT hapi check cannot see "
                         "shifted label ids")
    return ok, miss


def _hapi_nmt_leg(card):
    """(c) NMT at NMT's full width through Model.fit's dygraph adapter,
    dropout 0.1, bf16 O1, paddle.optimizer.Adam: HAPI_NMT_WARMUP steps,
    then HAPI_NMT_STEPS timed ones with the launch counts set to 0 before
    and read after; tokens/s, host ms a step, peak memory; then the
    profiler's busy ms and idle share of train_batch."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer as opt
    from paddle_tpu_torch.fluid.framework import _dygraph_tracer
    from paddle_tpu_torch.models import TransformerModel

    tracer = _dygraph_tracer()
    np.random.seed(SEED)
    tracer._seed, tracer._seed_ctr = SEED + 5, 0
    t0 = time.perf_counter()
    net = TransformerModel(**NMT)
    model = paddle.Model(net)
    model.prepare(optimizer=opt.Adam(HAPI_NMT_LR,
                                     parameters=net.parameters()),
                  loss=nn.CrossEntropyLoss(), amp_level="O1")
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED)
    v = NMT["tgt_vocab"]
    src, tgt_in, tgt_out = (rng.randint(0, v, (NMT_BATCH, NMT_SEQ))
                            .astype("int64") for _ in range(3))
    batch = list(zip(src, tgt_in, tgt_out[..., None]))
    data = batch * (HAPI_NMT_WARMUP + HAPI_NMT_STEPS)
    counted = _counted_kernels()
    clock = {}

    class _Clock(_StepLosses):
        def on_train_batch_begin(self, step, logs=None):
            if step == HAPI_NMT_WARMUP:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for fn in counted:
                    fn.launches = 0
                _flash_copies_zero()
                clock["t0"] = time.perf_counter()

        def on_train_end(self, logs=None):
            torch.cuda.synchronize()
            clock["wall"] = time.perf_counter() - clock["t0"]
            clock["launches"] = {fn.__name__: fn.launches
                                 for fn in counted}
            clock["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30

    rec = _Clock()
    model.fit(data, batch_size=NMT_BATCH, epochs=1, verbose=0,
              shuffle=False, callbacks=[rec])
    wall = clock["wall"]
    losses = rec.losses
    host_ms = wall / HAPI_NMT_STEPS * 1e3
    tok_s = NMT_ROWS * HAPI_NMT_STEPS / wall
    _p(f"hapi: (c) NMT through Model.fit on the tape, "
       f"TransformerModel({', '.join(f'{k}={x}' for k, x in NMT.items())})"
       f" built in {build_s:.1f} s, batch {NMT_BATCH} of {NMT_SEQ} tokens, "
       f"bf16 O1, Adam {HAPI_NMT_LR}: {HAPI_NMT_STEPS} timed steps in "
       f"{wall:.3f} s, {host_ms:.2f} ms/step, {tok_s:.0f} tokens/s, peak "
       f"memory {clock['peak']:.2f} GiB; losses "
       f"{[round(x, 4) for x in losses]}  [{card}]")
    want = {fn.__name__: HAPI_NMT_LAUNCHES.get(fn.__name__, 0)
            * HAPI_NMT_STEPS for fn in counted}
    _p(f"hapi: (c) launches in the timed steps {clock['launches']}, "
       f"expected {want} (per step {HAPI_NMT_LAUNCHES})")
    if clock["launches"] != want:
        raise SystemExit("chip_smoke: the NMT Model.fit step did not run "
                         "through every kernel as predicted")
    _flash_copies_check("hapi nmt")
    if not np.isfinite(losses).all() or losses[-1] >= losses[0]:
        raise SystemExit("chip_smoke: the NMT Model.fit losses are not "
                         "finite or did not fall")
    ins = [paddle.to_tensor(src), paddle.to_tensor(tgt_in)]
    lbs = [paddle.to_tensor(tgt_out[..., None])]
    p_host, busy, idle, n_kern, by_class = _profile(
        lambda: model.train_batch(ins, lbs), 3)
    _p(f"profile: NMT Model.fit step: host {p_host:.3f} ms/step, device "
       f"busy {busy:.3f} ms/step, idle share {idle:.4f}, {n_kern:.0f} "
       f"kernels/step  [{card}]")
    _print_classes(by_class, "step")
    return clock["launches"], {
        "tokens_per_s": tok_s, "host_ms": host_ms, "busy_ms": busy,
        "idle": idle, "peak_gib": clock["peak"], "build_s": build_s}


def _hapi_grad_penalty(place, detach=False):
    """A gradient penalty over a small tanh MLP through paddle.grad
    (create_graph) and backward(): the parameters' gradients, as numpy;
    ``detach`` takes the penalty on a detached gradient instead."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.fluid import layers as L

    rng = np.random.RandomState(SEED + HAPI_GP["seed"])
    n, d, h = HAPI_GP["rows"], HAPI_GP["d_in"], HAPI_GP["hidden"]
    arrays = (rng.randn(n, d), rng.randn(d, h) / np.sqrt(d),
              0.1 * rng.randn(h), rng.randn(h, 1) / np.sqrt(h))
    with dybase.guard(place):
        x, w1, b1, w2 = (dybase.to_variable(a.astype("float32"))
                         for a in arrays)
        for v in (x, w1, b1, w2):
            v.stop_gradient = False
        y = L.reduce_sum(L.matmul(L.tanh(L.elementwise_add(
            L.matmul(x, w1), b1)), w2))
        (g,) = paddle.grad([y], [x], create_graph=not detach)
        norm = L.sqrt(L.reduce_sum(L.square(g), dim=1))
        L.reduce_mean(L.square(norm - 1.0)).backward()
        return [np.zeros(a.shape, "float32") if v.gradient_var is None
                else v.gradient_var.cpu().numpy()
                for v, a in zip((w1, b1, w2), arrays[1:])], arrays


def _torch_grad_penalty(arrays, device):
    """The same penalty's parameter gradients by torch.autograd.grad's
    double backward."""
    import torch
    x, w1, b1, w2 = (torch.tensor(a, dtype=torch.float32, device=device,
                                  requires_grad=True) for a in arrays)
    y = torch.sum(torch.tanh(x @ w1 + b1) @ w2)
    (g,) = torch.autograd.grad(y, x, create_graph=True)
    pen = torch.mean((torch.sqrt(torch.sum(g * g, dim=1)) - 1.0) ** 2)
    return [t.cpu().numpy() for t in
            torch.autograd.grad(pen, [w1, b1, w2])]


def _hapi_grad_leg(card):
    """(d) paddle.grad on the card: the gradient penalty's parameter
    gradients within HAPI_GP_RTOL of torch's double backward (each
    tensor's worst error over its largest value); the detached twin must
    miss."""
    from paddle_tpu_torch import fluid

    place = fluid.CUDAPlace(0)
    got, arrays = _hapi_grad_penalty(place)
    twin, _ = _hapi_grad_penalty(place, detach=True)
    want = _torch_grad_penalty(arrays, place.torch_device())

    def err(a):
        return max(float(np.abs(g - w).max() / np.abs(w).max())
                   for g, w in zip(a, want)) / HAPI_GP_RTOL

    ok, miss = err(got), err(twin)
    _p(f"hapi: (d) paddle.grad gradient penalty on the card ({arrays[0].shape}"
       f" rows, hidden {HAPI_GP['hidden']}): parameter gradients against "
       f"torch.autograd.grad's double backward, worst error / tolerance "
       f"(rtol {HAPI_GP_RTOL}) {ok:.3e}; the detached twin's {miss:.3e}  "
       f"[{card}]")
    if ok > 1 or miss <= 10:
        raise SystemExit("chip_smoke: paddle.grad's double backward on the "
                         "card disagrees with torch's, or the twin cannot "
                         "be told apart")
    return ok, miss


def phase_hapi(card):
    """Phase 4m: (a) LeNet through Model.fit's static adapter, (b) its
    dygraph adapter, (c) NMT at full width through the dygraph adapter
    (after the card-vs-path check), (d) paddle.grad's double backward.
    Returns the launches of (c)'s timed steps and (a)'s fit, and the
    numbers."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as dybase

    lenet_launches, lenet = _hapi_lenet_legs(card)
    with dybase.guard(fluid.CUDAPlace(0)):
        check = _hapi_nmt_check(card)
        nmt_launches, nmt = _hapi_nmt_leg(card)
    grad = _hapi_grad_leg(card)
    return {"nmt_fit": nmt_launches, "lenet_static_fit": lenet_launches,
            "numbers": dict(lenet=lenet, nmt=nmt, check=check, grad=grad)}


# ---------------------------------------------------------------------------
# the static training surface (phase 4n)
# ---------------------------------------------------------------------------

# the BERT recipe of the Paddle 1.8 era: linear warmup, then linear decay,
# by a Switch over the step counter; L2 decay, global-norm clip, Adam
RECIPE = dict(BERT_BASE, warmup=3, total=13, base_lr=1e-4, decay=0.01)
RECIPE_ROWS = 32
RECIPE_WARM, RECIPE_TIMED = 3, 10
RECIPE_HOST = dict(layers=2, rows=4, steps=3)    # the card-vs-host check
RECIPE_LR_RTOL = 1e-7
RECIPE_LOSS_RTOL = 1e-4
# launches a step, predicted in PERF.md section 6 (PR 17) before the first
# chip call: phase 4b's, the schedule and the regularization adding none
RECIPE_LAUNCHES = {"flash_attention_fwd": 24, "flash_attention_bwd": 12,
                   "fused_adam": 1}
# the FFN weights of BERT-base: 12 x [768, 3072] and 12 x [3072, 768]
MASTER_SHAPES = [(768, 3072), (3072, 768)] * 12
MASTER_ROWS, MASTER_STEPS = 64, 5
STATIC_OPT_RTOL = 1e-5
LOOP = dict(rows=64, width=768, trips=20)
STATIC_RNN = dict(batch=20, steps=35, width=200)
SCHEDULE_RTOL = 1e-6


def _recipe_program(fluid, vocab, hidden, heads, seq, layers, warmup,
                    total, base_lr, decay, optimizer="adam", swap=False):
    """The recipe in fluid's spelling over the BERT body of
    ``models/static_graphs``; ``swap`` swaps the Switch's arms (a twin).
    Returns (loss, lr)."""
    from paddle_tpu_torch.models import static_graphs as sg

    L = fluid.layers
    ids = fluid.data("ids", [-1, seq], dtype="int64")
    labels = fluid.data("labels", [-1, 1], dtype="int64")
    am = L.reshape(fluid.data("attn_mask", [-1, seq]), [0, 1, 1, seq])
    mask = L.scale(am, scale=10000.0, bias=-10000.0, bias_after_scale=False)
    lr = L.create_global_var([1], 0.0, "float32", persistable=True,
                             name="scheduled_learning_rate")
    step = L.cast(L.autoincreased_step_counter(begin=1), "float32")

    def warm():
        L.assign(step * (base_lr / warmup), lr)

    def cool():
        L.assign((1.0 - step / total) * base_lr, lr)

    with L.Switch() as sw:
        with sw.case(L.less_than(step, L.fill_constant([1], "float32",
                                                       warmup))):
            (cool if swap else warm)()
        with sw.default():
            (warm if swap else cool)()
    h = L.embedding(ids, size=[vocab, hidden])
    for _ in range(layers):
        h = sg._naive_attention(h, hidden, heads, mask=mask)
        h = L.fc(h, hidden, num_flatten_dims=2, act="relu")
    logits = L.fc(L.reduce_mean(h, dim=[1]), 2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, labels))
    opt = fluid.optimizer.LambOptimizer if optimizer == "lamb" \
        else fluid.optimizer.AdamOptimizer
    opt(lr, regularization=fluid.regularizer.L2Decay(decay),
        grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)).minimize(loss)
    return loss, lr


def _recipe_lr(step, swap=False):
    """The schedule's closed form in float32, in the program's op order
    (``swap``: the twin's arms)."""
    f = np.float32
    s, w = f(step), RECIPE["warmup"]
    warm = s * f(RECIPE["base_lr"] / w)
    cool = (f(1.0) - s / f(RECIPE["total"])) * f(RECIPE["base_lr"])
    return (cool if swap else warm) if s < f(w) else (warm if swap
                                                      else cool)


def _recipe_built(optimizer="adam", swap=False, **over):
    """(main, startup, loss, lr, CompiledProgram) of the recipe under
    fresh names, fuse_attention and fuse_optimizer applied."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.framework import reset_unique_name

    cfg = {k: v for k, v in RECIPE.items() if k != "dropout"}
    cfg.update(over)
    reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss, lr = _recipe_program(fluid, optimizer=optimizer, swap=swap,
                                   **{k: cfg[k] for k in (
                                       "vocab", "hidden", "heads", "seq",
                                       "layers", "warmup", "total",
                                       "base_lr", "decay")})
    startup.random_seed = SEED
    bs = fluid.BuildStrategy()
    bs.fuse_attention = bs.fuse_optimizer = True
    program = fluid.CompiledProgram(main, bs)
    program._apply_ir_passes([loss.name, lr.name])
    return main, startup, loss, lr, program


def _recipe_card_vs_host(optimizer, card):
    """HOST rows, HOST layers, full width otherwise, ``steps`` steps from
    one init on the card and on the host through the same rewritten
    program: the losses within RECIPE_LOSS_RTOL; a host twin with the
    Switch's arms swapped must miss.  Returns the worst margins."""
    from paddle_tpu_torch import fluid

    layers, rows, steps = (RECIPE_HOST[k] for k in ("layers", "rows",
                                                     "steps"))
    feed = _train_feed(np.random.RandomState(SEED + 5), rows)
    main, startup, loss, lr, program = _recipe_built(optimizer,
                                                     layers=layers)
    fused = "fused_lamb" if optimizer == "lamb" else "fused_adam"
    types = [op.type for op in main.global_block().ops]
    if types.count(fused) != 1 or optimizer in types:
        raise SystemExit(f"chip_smoke: fuse_optimizer did not make one "
                         f"{fused} of the recipe's {optimizer} updates")
    init = _startup_state(main, startup, fluid.CPUPlace())
    t0 = time.perf_counter()
    card, _ = _steps(program, main, [loss], init, fluid.CUDAPlace(0),
                     [feed] * steps)
    host, _ = _steps(program, main, [loss], init, fluid.CPUPlace(),
                     [feed] * steps)
    tmain, _, tloss, _, tprog = _recipe_built(optimizer, swap=True,
                                              layers=layers)
    twin, _ = _steps(tprog, tmain, [tloss], init, fluid.CPUPlace(),
                     [feed] * steps)
    card, host, twin = ([float(o[0]) for o in x] for x in (card, host,
                                                            twin))
    margin = max(abs(c - h) / (RECIPE_LOSS_RTOL * abs(h))
                 for c, h in zip(card, host))
    twin_margin = max(abs(c - t) / (RECIPE_LOSS_RTOL * abs(t))
                      for c, t in zip(card, twin))
    _p(f"4n {optimizer}: card vs host, {layers} layers x {rows} rows x "
       f"{steps} steps in {time.perf_counter() - t0:.1f} s: losses card "
       f"{card}, host {host} (rtol {RECIPE_LOSS_RTOL}): worst |diff| "
       f"{margin:.3f} of the tolerance; the swapped-arms twin {twin} "
       f"misses by {twin_margin:.1f} times it  [{card}]")
    if margin > 1.0 or not np.isfinite(card).all():
        raise SystemExit(f"chip_smoke: the recipe's {optimizer} losses on "
                         f"the card disagree with the host's")
    if twin_margin <= 1.0:
        raise SystemExit("chip_smoke: the recipe's card-vs-host check "
                         "cannot tell the Switch's arms apart")
    return margin, twin_margin


def _count_syncs(fn):
    """(fn's value, the CUDA host syncs it made), counted by torch's
    sync debug mode, which warns at every synchronizing call."""
    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    return out, len(syncs), sorted({str(w.message)[:90] for w in syncs})


def _recipe_leg(card):
    """(a): the recipe at BERT-base width, RECIPE_ROWS rows, 3 + 10
    steps.  Returns (launches over the timed steps, the row of numbers)."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import trace
    from paddle_tpu_torch.ops import cuda_kernels

    t0 = time.perf_counter()
    main, startup, loss, lr, program = _recipe_built()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    types = [op.type for op in main.global_block().ops]
    _p(f"4n recipe: BERT-base width ({len(main.all_parameters())} "
       f"parameters, 12 layers, dropout 0), warmup {RECIPE['warmup']}, "
       f"total {RECIPE['total']}, base lr {RECIPE['base_lr']}, L2Decay "
       f"{RECIPE['decay']}, global-norm clip 1.0, Adam; built and started "
       f"in {time.perf_counter() - t0:.1f} s; ops: "
       f"{types.count('conditional_block')} conditional_block, "
       f"{types.count('fused_multihead_attention')} fused attention, "
       f"{types.count('fused_adam')} fused_adam, {types.count('adam')} "
       f"adam, {len(types)} in all")
    if types.count("fused_adam") != 1 or "adam" in types \
            or types.count("conditional_block") != 2 \
            or types.count("fused_multihead_attention") != RECIPE["layers"]:
        raise SystemExit("chip_smoke: the recipe was not rewritten onto "
                         "the kernels as expected")
    feed = _train_feed(np.random.RandomState(SEED), RECIPE_ROWS)

    def step():
        return exe.run(program, feed=feed, fetch_list=[loss, lr],
                       scope=scope, return_numpy=False)

    got = [step() for _ in range(RECIPE_WARM)]
    torch.cuda.synchronize()
    counted = _counted_kernels()
    for fn in counted:
        fn.launches = 0
    _flash_copies_zero()
    reads = trace.metrics().counter("control_flow.host_reads")
    reads0 = reads.value

    def timed():
        out = [step() for _ in range(RECIPE_TIMED)]
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    timed_out, syncs, kinds = _count_syncs(timed)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    host_reads = reads.value - reads0
    got += timed_out
    losses = [float(o[0]) for o in got]
    lrs = [float(o[1]) for o in got]
    want = {n: RECIPE_LAUNCHES.get(n, 0) * RECIPE_TIMED
            for n in launches}
    _p(f"4n recipe: {RECIPE_TIMED} timed steps at {RECIPE_ROWS} rows in "
       f"{wall:.3f} s ({wall / RECIPE_TIMED * 1e3:.2f} ms a step, with "
       f"the sync counting on); losses {[round(x, 5) for x in losses]}; "
       f"launches {launches}, expected {want}; host syncs a step "
       f"{syncs / RECIPE_TIMED} {kinds}, control-flow host reads "
       f"{host_reads}  [{card}]")
    if launches != want:
        raise SystemExit("chip_smoke: the recipe's step did not run "
                         "through the kernels as predicted")
    _flash_copies_check("recipe")
    if not np.isfinite(losses).all():
        raise SystemExit("chip_smoke: a recipe loss is not finite")
    closed = [float(_recipe_lr(k + 1)) for k in range(len(lrs))]
    twin = [float(_recipe_lr(k + 1, swap=True)) for k in range(len(lrs))]
    # the last step's rate is exactly 0 (step = total)
    err = max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(lrs, closed))
    twin_miss = max(abs(g - t) / (RECIPE_LR_RTOL * max(abs(t), 1e-30))
                    for g, t in zip(lrs, twin))
    _p(f"4n recipe: learning rate per step {lrs}; closed form (float32, "
       f"the program's op order) {closed}: worst relative error {err:.3e} "
       f"(tolerance {RECIPE_LR_RTOL}); the swapped-arms twin misses by "
       f"{twin_miss:.3e} times the tolerance")
    if err > RECIPE_LR_RTOL or twin_miss < 10:
        raise SystemExit("chip_smoke: the recipe's learning rate is not "
                         "the schedule's closed form")
    host_ms, busy_ms, idle, kernels, by_class = _profile(step, 5)
    top = sorted(by_class.items(), key=lambda kv: -kv[1])[:6]
    _p(f"4n recipe step, profiled: host {host_ms:.3f} ms, busy "
       f"{busy_ms:.3f} ms, idle {idle:.4f}, {kernels:.0f} kernels a step; "
       f"{', '.join(f'{c} {ms:.4f}' for c, ms in top)} (phase 4b at a "
       f"constant rate, PERF.md: 179.1 host, 32.6 busy ms)  [{card}]")
    return launches, {"host_ms": host_ms, "busy_ms": busy_ms, "idle": idle,
                      "kernels": kernels, "syncs_per_step":
                      syncs / RECIPE_TIMED, "host_reads": host_reads,
                      "lr_err": err, "lr_twin_miss": twin_miss,
                      "step_ms": wall / RECIPE_TIMED * 1e3}


def _master_program(fluid, opt_cls):
    """bfloat16 FFN weights made by ``create_parameter(dtype=
    "bfloat16")`` in the reference's spelling (tests/test_kernel_tier.py:
    320-352), chained over a float32 input, the mean square as loss,
    under ``opt_cls(multi_precision=True)``."""
    L = fluid.layers
    x = fluid.data("x", [-1, MASTER_SHAPES[0][0]])
    gb = fluid.default_main_program().global_block()
    sb = fluid.default_startup_program().global_block()
    h = x
    for i, shape in enumerate(MASTER_SHAPES):
        name = f"ffn_w{i}_lo"
        gb.create_parameter(name, list(shape), dtype="bfloat16")
        sb.create_var(name=name, shape=list(shape), dtype="bfloat16",
                      persistable=True)
        sb.append_op("fill_constant", outputs={"Out": [name]},
                     attrs={"shape": list(shape), "dtype": "bfloat16",
                            "value": 0.0})
        h = L.matmul(h, gb.vars[name])
    loss = L.mean(L.square(h))
    kw = {"momentum": 0.9} if opt_cls == "MomentumOptimizer" else {}
    getattr(fluid.optimizer, opt_cls)(1e-3, multi_precision=True,
                                      **kw).minimize(loss)
    return loss


def _master_runs(opt_cls, card):
    """(c) for one optimizer: MASTER_STEPS steps fused and unfused from
    one init; every master, moment or velocity and bf16 parameter
    ``torch.equal`` between them.  Returns the fused run's launches and
    its last step's op inputs (for the kernel checks)."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.framework import reset_unique_name
    from paddle_tpu_torch.ops import cuda_kernels

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    init = None
    states, launches = [], None
    for fuse in (False, True):
        reset_unique_name()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            loss = _master_program(fluid, opt_cls)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        if init is None:
            # weights scaled so the chain keeps its scale; each master the
            # exact widening of its bf16 parameter, as the startup's cast
            init = {}
            for i, shape in enumerate(MASTER_SHAPES):
                w = (torch.randn(shape, generator=g, device=DEVICE)
                     / math.sqrt(shape[0])).to(torch.bfloat16)
                init[f"ffn_w{i}_lo"] = w
        master_of = {}
        for n in main.global_block().vars:
            if "_master_weight_" in n:
                master_of[n] = n.split("_master_weight_")[1]
        for n, w in init.items():
            scope.set_var(n, w.clone())
        for m, p in master_of.items():
            scope.set_var(m, init[p].float())
        program = main
        if fuse:
            bs = fluid.BuildStrategy()
            bs.fuse_optimizer = True
            program = fluid.CompiledProgram(main, bs)
            program._apply_ir_passes([loss.name])
            fused = [op for op in main.global_block().ops
                     if op.type.startswith("fused_")]
            if len(fused) != 1 or len(fused[0].inputs["MasterParam"]) != \
                    len(MASTER_SHAPES):
                raise SystemExit(f"chip_smoke: fuse_optimizer did not make "
                                 f"one bucket of the {opt_cls} masters")
            for fn in (cuda_kernels.fused_adam_master,
                       cuda_kernels.fused_momentum_master):
                fn.launches = 0
        rng = np.random.RandomState(SEED + 7)
        for _ in range(MASTER_STEPS):
            exe.run(program, feed={"x": rng.randn(
                MASTER_ROWS, MASTER_SHAPES[0][0]).astype("float32")},
                fetch_list=[loss], scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        if fuse:
            launches = {n: getattr(cuda_kernels, n).launches
                        for n in ("fused_adam_master",
                                  "fused_momentum_master")}
        states.append({n: scope.find_var(n).clone() for n, v in
                       main.global_block().vars.items()
                       if v.persistable and scope.find_var(n) is not None})
    off, on = states
    equal = sorted(off) == sorted(on) and all(
        off[n].dtype == on[n].dtype and torch.equal(off[n], on[n])
        for n in off)
    moved = sum(not torch.equal(on[n], init[n]) for n in init)
    _p(f"4n masters, {opt_cls}(multi_precision=True): {len(MASTER_SHAPES)} "
       f"bf16 FFN weights ({sum(math.prod(s) for s in MASTER_SHAPES)} "
       f"values), {MASTER_STEPS} steps fused and unfused: every master, "
       f"moment or velocity and bf16 parameter torch.equal = {equal}; "
       f"{moved} of {len(init)} bf16 parameters moved; fused launches "
       f"{launches}  [{card}]")
    if not equal or moved == 0:
        raise SystemExit(f"chip_smoke: the fused {opt_cls} master path is "
                         f"not bit-identical to the per-param ops")
    return launches, on


def _master_kernel_row(kind, state, card):
    """A master kernel at the (c) bucket: against its plain version on
    the same inputs (``torch.equal``), timed beside its bound (28 or 20
    bytes a value) and the library call over the fp32 masters."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.ops.optimizer_ops import _plain_fused_adam, \
        _plain_fused_momentum

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    names = [f"ffn_w{i}_lo" for i in range(len(MASTER_SHAPES))]
    opt = "AdamOptimizer" if kind == "adam" else "MomentumOptimizer"
    masters = [state[f"{opt}_master_weight_{n}"] for n in names]
    lows = [state[n] for n in names]
    grads = [(1e-3 * torch.randn(m.shape, generator=g, device=DEVICE))
             .to(torch.bfloat16) for m in masters]
    lr = torch.full((1,), 1e-3, device=DEVICE)
    n = sum(m.numel() for m in masters)
    if kind == "adam":
        m1s = [state[f"{opt}_moment1_{x}"] for x in names]
        vs = [state[f"{opt}_moment2_{x}"] for x in names]
        b1ps = [state[f"{opt}_beta1_pow_{x}"] for x in names]
        b2ps = [state[f"{opt}_beta2_pow_{x}"] for x in names]

        def kernel():
            return cuda_kernels.fused_adam_master(
                masters, grads, m1s, vs, lr, b1ps, b2ps, 0.9, 0.999, 1e-8,
                torch.bfloat16)

        def plain():
            return _plain_fused_adam(masters, grads, m1s, vs, lr, b1ps, b2ps,
                                     0.9, 0.999, 1e-8, lo=lows)

        po, mo, vo, plo, _ = kernel()
        want = plain()
        got = {"MasterParamOut": po, "Moment1Out": mo, "Moment2Out": vo,
               "ParamOut": plo}
        lib = [[x.clone() for x in masters], [x.float() for x in grads],
               [x.clone() for x in m1s], [x.clone() for x in vs]]
        step = round(math.log(float(b1ps[0])) / math.log(0.9))
        bc2 = 1 - 0.999 ** step
        steps = [torch.full((), float(step), device=DEVICE) for _ in lib[0]]

        def library():
            torch._fused_adam_(*lib, [], steps, lr=1e-3, beta1=0.9,
                               beta2=0.999, weight_decay=0.0,
                               eps=1e-8 / math.sqrt(bc2), amsgrad=False,
                               maximize=False)
        per_value, flops, libname = 28, 12.0, "torch._fused_adam_"
    else:
        vs = [state[f"{opt}_velocity_{x}"] for x in names]

        def kernel():
            return cuda_kernels.fused_momentum_master(
                masters, grads, vs, lr, 0.9, 0.0, False, torch.bfloat16)

        def plain():
            return _plain_fused_momentum(masters, grads, vs, lr, 0.9, 0.0,
                                         False, lo=lows)

        po, vo, plo = kernel()
        want = plain()
        got = {"MasterParamOut": po, "VelocityOut": vo, "ParamOut": plo}
        lib = [[x.clone() for x in masters], [x.float() for x in grads],
               [x.clone() for x in vs]]

        def library():
            torch._fused_sgd_(*lib, weight_decay=0.0, momentum=0.9, lr=1e-3,
                              dampening=0.0, nesterov=False, maximize=False,
                              is_first_step=False)
        per_value, flops, libname = 20, 4.0, "torch._fused_sgd_"
    from paddle_tpu_torch.ops.optimizer_ops import _view_specs, _views
    specs = _view_specs(tuple(m.shape for m in masters))
    err, equal = 0.0, True
    for slot, buf in got.items():
        for a, b in zip(_views(buf, specs), want[slot]):
            equal &= torch.equal(a, b)
            err = max(err, (a.float() - b.float()).abs().max().item())
    name = f"fused_{kind}_master"
    _p(f"  {name} at the (c) bucket ({len(masters)} params, {n} values, "
       f"bf16 grads and params): torch.equal to its plain version on "
       f"every output = {equal} (max |err| {err:.3e}; tolerance: "
       f"bit-identical)")
    if not equal:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                         f"version")
    ms = _profile(kernel, 20)[1]
    plain_ms = _profile(plain, 10)[1]
    library_ms = _profile(library, 10)[1]
    # the wrapper's wall time a call by CUDA events, beside the profiler's
    # device time: a cross-check of the kernel's time against its bound
    call_ms = _ms(kernel, 20)
    t_bytes = per_value * n / HBM_BYTES_PER_S * 1e3
    t_ops = flops * n / FLOPS_PER_S["float32"] * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"
    _p(f"  {name} device per call: kernel {ms:.4f} ms "
       f"({per_value * n / ms / 1e9:.2f} TB/s at {per_value} bytes a "
       f"value) | plain {plain_ms:.4f} ms | library ({libname} over the "
       f"fp32 masters, fp32 grads) {library_ms:.4f} ms | bound "
       f"{bound_ms:.4f} ms ({bound_by}); the wrapper's wall per call "
       f"(CUDA events) {call_ms:.4f} ms  [{card}]")
    del lib
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "values": n, "call_ms": call_ms,
            "bytes_per_value": per_value, "library": libname}


# (d): the optimizer classes that append ops, on LeNet at phase 4g's width
STATIC_OPTIMIZERS = {
    "SGD": lambda O: O.SGDOptimizer(0.1),
    "Momentum": lambda O: O.MomentumOptimizer(0.1, 0.9, use_nesterov=True),
    "LarsMomentum": lambda O: O.LarsMomentumOptimizer(0.1, 0.9),
    "Adam": lambda O: O.AdamOptimizer(1e-3),
    "AdamW": lambda O: O.AdamWOptimizer(1e-3, weight_decay=0.1),
    "Adagrad": lambda O: O.AdagradOptimizer(0.01),
    "RMSProp": lambda O: O.RMSPropOptimizer(1e-3, momentum=0.5,
                                            centered=True),
    "Lamb": lambda O: O.LambOptimizer(1e-3),
    "Ftrl": lambda O: O.FtrlOptimizer(0.01, l1=0.001, l2=0.001),
    "Dpsgd": lambda O: O.DpsgdOptimizer(0.1, clip=1.0, sigma=0.0),
    "Adamax": lambda O: O.AdamaxOptimizer(1e-3),
    "Adadelta": lambda O: O.AdadeltaOptimizer(1.0),
    "DecayedAdagrad": lambda O: O.DecayedAdagradOptimizer(0.01),
    "DGCMomentum": lambda O: O.DGCMomentumOptimizer(
        0.1, 0.9, rampup_begin_step=1, sparsity=[0.5]),
    "GradientMerge": lambda O: O.GradientMergeOptimizer(
        O.AdamOptimizer(1e-3), k_steps=2),
    "Lookahead": lambda O: O.LookaheadOptimizer(O.SGDOptimizer(0.1),
                                                alpha=0.5, k=2),
    "ModelAverage": "sgd + ModelAverage",
    "Recompute": lambda O: O.RecomputeOptimizer(O.AdamOptimizer(1e-3)),
    "Pipeline": lambda O: O.PipelineOptimizer(
        O.MomentumOptimizer(0.1, 0.9), num_microbatches=2),
}


def _lenet_with(fluid, name):
    """LeNet (phase 4g's) under the optimizer ``name``."""
    L = fluid.layers
    img = fluid.data("img", [-1, 1, 28, 28])
    label = fluid.data("label", [-1, 1], dtype="int64")
    conv1 = L.conv2d(img, 6, 3, padding=1, act="relu")
    pool1 = L.pool2d(conv1, 2, "max", 2)
    conv2 = L.conv2d(pool1, 16, 5, act="relu")
    pool2 = L.pool2d(conv2, 2, "max", 2)
    fc1 = L.fc(L.flatten(pool2), 120, act="relu")
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(fc1, 10), label))
    O = fluid.optimizer
    make = STATIC_OPTIMIZERS[name]
    if name == "ModelAverage":
        O.SGDOptimizer(0.1).minimize(loss)
        O.ModelAverage(0.5, min_average_window=2, max_average_window=3)
    else:
        make(O).minimize(loss)
    return loss


def _card_vs_host(label, build, feeds, rtol, card, init=None):
    """Build under fresh names, the startup's state on the host as the
    shared init, the runs on the card and on the host: every fetch
    within ``rtol`` relative to the host's largest |value| of it.
    Returns the worst error over ``rtol``."""
    from paddle_tpu_torch import fluid

    main, startup, fetches, program = _book_program(build, False)
    init = _startup_state(main, startup, fluid.CPUPlace()) if init is None \
        else init
    card_out, _ = _steps(program, main, list(fetches), init,
                         fluid.CUDAPlace(0), feeds)
    host_out, _ = _steps(program, main, list(fetches), init,
                         fluid.CPUPlace(), feeds)
    worst = 0.0
    for c, h in zip(card_out, host_out):
        for a, b in zip(c, h):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            scale = max(float(np.abs(b).max()), 1e-30)
            worst = max(worst, float(np.abs(a - b).max()) / (rtol * scale))
    if worst > 1.0 or not all(np.isfinite(np.asarray(x, np.float64)).all()
                              for c in card_out for x in c):
        raise SystemExit(f"chip_smoke: {label} on the card disagrees with "
                         f"the host (worst {worst:.3f} of rtol {rtol})")
    return worst


def _loop_program(fluid):
    L = fluid.layers
    x = fluid.data("x", [LOOP["rows"], LOOP["width"]])
    w = L.create_parameter([LOOP["width"], LOOP["width"]], "float32",
                           name="loop_w")
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", LOOP["trips"])

    def body(i, x):
        y = L.matmul(x, w)
        y = y / L.reshape(L.sqrt(L.reduce_sum(L.square(y))), [1])
        return [L.increment(i, 1, in_place=False), y]

    i, x = L.while_loop(lambda i, x: L.less_than(i, n), body, [i, x])
    return x, i


def _branch_program(fluid):
    """A cond and a switch_case over a fed index, on the loop's width."""
    L = fluid.layers
    x = fluid.data("x", [LOOP["rows"], LOOP["width"]])
    idx = fluid.data("idx", [1], dtype="int64")
    pred = L.less_than(L.reshape(L.reduce_sum(x), [1]),
                       L.fill_constant([1], "float32", 0.0))
    a = L.cond(pred, lambda: L.tanh(x), lambda: L.scale(x, scale=0.5))
    b = L.switch_case(idx, {0: lambda: L.exp(L.scale(x, scale=0.1)),
                            2: lambda: L.sigmoid(x)},
                      default=lambda: L.square(x))
    return a, b


def _rnn_program(fluid):
    L = fluid.layers
    b, t, d = (STATIC_RNN[k] for k in ("batch", "steps", "width"))
    x = fluid.data("x", [b, t, d])
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        hp = rnn.memory(shape=[-1, d], batch_ref=x)
        h = L.tanh(L.elementwise_add(L.fc(xt, d, bias_attr=False),
                                     L.fc(hp, d)))
        rnn.update_memory(hp, h)
        rnn.step_output(h)
    return (rnn(),)


SCHEDULE_BUILDERS = {
    "exponential_decay": lambda L: L.exponential_decay(0.1, 7, 0.5, True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 5, 0.3),
    "inverse_time_decay": lambda L: L.inverse_time_decay(0.1, 4, 0.5,
                                                         True),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 20, 0.001, 2.0,
                                                     cycle=True),
    "piecewise_decay": lambda L: L.piecewise_decay(
        [5, 12, 20], [0.1, 0.05, 0.01, 0.001]),
    "noam_decay": lambda L: L.noam_decay(512, 8),
    "cosine_decay": lambda L: L.cosine_decay(0.1, 3, 10),
    "linear_lr_warmup": lambda L: L.linear_lr_warmup(0.1, 6, 0.0, 0.1),
}


def _surface_leg(card):
    """(d): the optimizer classes on LeNet, the control flow at the
    loop's width and the eight schedules, card against host."""
    from paddle_tpu_torch.fluid import trace

    rng = np.random.RandomState(SEED + 3)
    img, lbl = _blob_data(rng, LENET_BATCH)
    feeds = [{"img": img, "label": lbl}] * 3
    worst = {}
    for name in STATIC_OPTIMIZERS:
        worst[name] = _card_vs_host(
            f"LeNet under {name}", lambda fluid, n=name: _lenet_with(fluid,
                                                                     n),
            feeds, STATIC_OPT_RTOL, card)
    _p(f"4n optimizers on LeNet, batch {LENET_BATCH}, 3 steps card vs "
       f"host (rtol {STATIC_OPT_RTOL} of each fetch's largest |value|): "
       + ", ".join(f"{n} {w:.3f}" for n, w in worst.items()) + f"  [{card}]")
    x = rng.randn(LOOP["rows"], LOOP["width"]).astype("float32")
    reads = trace.metrics().counter("control_flow.host_reads")
    before = reads.value
    loop = _card_vs_host("while_loop", _loop_program, [{"x": x}], 1e-4,
                         card)
    trips = (reads.value - before) // 2
    branches = [_card_vs_host(f"cond + switch_case, index {k}",
                              _branch_program,
                              [{"x": x * s, "idx": np.array([k], "int64")}],
                              1e-5, card)
                for k, s in ((0, 1.0), (2, -1.0), (7, 1.0))]
    seq = rng.randn(STATIC_RNN["batch"], STATIC_RNN["steps"],
                    STATIC_RNN["width"]).astype("float32")
    rnn = _card_vs_host("StaticRNN", _rnn_program, [{"x": seq}], 1e-4, card)
    _p(f"4n control flow card vs host: while_loop ({LOOP['trips']} trips "
       f"of a [{LOOP['rows']}, {LOOP['width']}] x [{LOOP['width']}, "
       f"{LOOP['width']}] product and a normalisation; {trips} host reads "
       f"a run, rtol 1e-4) {loop:.3f}; cond + switch_case (rtol 1e-5) "
       f"{[round(b, 3) for b in branches]}; StaticRNN ({STATIC_RNN['steps']}"
       f" steps, width {STATIC_RNN['width']}, rtol 1e-4) {rnn:.3f}")
    # the card's pow, exp and cos round differently from the host's by
    # an ulp (PR 17's first chip run: polynomial_decay's pow 1.017 times
    # 1e-7); the closed form's 1e-7 is the recipe leg's check
    sched = {}
    for name, make in SCHEDULE_BUILDERS.items():
        sched[name] = _card_vs_host(
            name, lambda fluid, m=make: (m(fluid.layers),), [{}] * 30,
            SCHEDULE_RTOL, card)
    _p(f"4n schedules, 30 runs card vs host (rtol {SCHEDULE_RTOL}): "
       + ", ".join(f"{n} {w:.3f}" for n, w in sched.items()))
    return {"optimizers": worst, "while_loop": loop, "branches": branches,
            "static_rnn": rnn, "schedules": sched,
            "while_host_reads": trips}


def phase_static_training(card):
    """Phase 4n: the static training surface.  (a) the BERT recipe at
    BERT-base width through the kernel tier, (b) LAMB on it, (c) fp32
    master weights through the two kernels' master paths, (d) the
    optimizer classes, the control flow and the schedules.  Returns the
    recipe's launches over its timed steps, the master rows and the
    master legs' launches."""
    launches, recipe = _recipe_leg(card)
    recipe["card_vs_host"] = _recipe_card_vs_host("adam", card)
    recipe["lamb_card_vs_host"] = _recipe_card_vs_host("lamb", card)
    rows, master_launches = {}, {}
    for kind, opt in (("adam", "AdamOptimizer"),
                      ("momentum", "MomentumOptimizer")):
        got, state = _master_runs(opt, card)
        master_launches[f"fused_{kind}_master"] = \
            got[f"fused_{kind}_master"]
        if got[f"fused_{kind}_master"] != MASTER_STEPS:
            raise SystemExit(f"chip_smoke: fused_{kind}_master launched "
                             f"{got} times in {MASTER_STEPS} steps")
        rows[f"fused_{kind}_master"] = _master_kernel_row(kind, state, card)
        del state
    recipe["surface"] = _surface_leg(card)
    return launches, rows, master_launches, recipe


# ---------------------------------------------------------------------------
# the dygraph-to-static tier (phase 4o)
# ---------------------------------------------------------------------------

D2S_WARM, D2S_STEPS = 3, 10
# (b): a tensor while of 20 trips of a [64, 768] x [768, 768] product and
# a normalisation, a tensor if, a for over a tensor range of 5
D2S_LOOP = dict(rows=64, width=768, trips=20, range=5)
D2S_LOOP_RTOL = 1e-4
# (c): ResNet-50 (config 2) at batch 32 of 224², bf16
D2S_RESNET_BATCH, D2S_RESNET_STEPS = 32, 3
# bf16 activations feed the statistics: one bf16 rounding (2^-9 relative)
# of a mean over 32 x 112² values at most moves them by that share
D2S_BN_RTOL = 1e-3
# (d): BERT-base's BertModel in eval, float32, 32 x 128, jit.save / load
D2S_SERVE_ROWS, D2S_SERVE_RTOL = 32, 1e-3
# (e): the static BERT program at BERT-base width under decorate
D2S_AMP = dict(rows=32, lr=1e-4, init_scale=2.0 ** 15, decr_ratio=0.5)
D2S_AMP_HOST = dict(layers=2, rows=4, poisoned=4, good=2)
D2S_AMP_LOSS_RTOL = 0.05       # the reference's own bf16 bound
# fuse_attention does not match after decorate's folded casts, in either
# package (tests/test_torch_static_amp.py): fused Adam is the one kernel
D2S_AMP_LAUNCHES = {"fused_adam": 1}


def _d2s_loss(model, ids, mlm, nsp):
    return model.loss(*model(ids), mlm, nsp)


def _d2s_steps(model, tracer, inputs, steps, to_static=True):
    """``steps`` steps of the 2.0 eager loop (``loss.backward()``, a
    fresh ``paddle.optimizer.Adam``'s ``step()``, ``clear_grad()``) from
    the model's own weights, the tracer's seeds reset so two runs draw
    the same masks: the losses and the first step's gradients by name."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.dygraph import base as dybase

    loss_fn = paddle.jit.to_static(_d2s_loss) if to_static else _d2s_loss
    tracer._seed, tracer._seed_ctr = SEED + 7, 0
    opt = paddle.optimizer.Adam(learning_rate=DY_LR,
                                parameters=model.parameters())
    variables = [dybase.to_variable(t) for t in inputs]
    losses, first = [], None
    for _ in range(steps):
        loss = loss_fn(model, *variables)
        loss.backward()
        if first is None:
            first = {n: p.gradient_var.detach().cpu().numpy()
                     for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, first


def _d2s_card_vs_host(model, tracer, init, card):
    """(a)'s checks.  Float32, dropout 0.1 live, DY_HOST_ROWS rows, two
    steps on the card and on the host from the same weights, seeds and
    Adam state: losses within rtol 1e-4, first-step gradients within 1e-3
    of their group's largest; a host twin whose masks use seed + 1 must
    miss.  Then, dropout 0, the to_static step's loss and gradients on
    the card within 1e-5 of the eager tape's from the same state; the
    tape step of the dropout-0.1 model is that check's twin."""
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.models.bert import BertForPretraining

    t0 = time.perf_counter()
    inputs = _dy_inputs(DY_HOST_ROWS)
    model.set_state_dict(init)
    card_loss, card_g = _d2s_steps(model, tracer, inputs, 2)
    host_inputs = [t.cpu() for t in inputs]
    with dybase.guard(fluid.CPUPlace()):
        host_tracer = dybase._dygraph_tracer()
        host = BertForPretraining(**DY)
        host.train()
        interop.layer_from_numpy(host, init)
        host_loss, host_g = _d2s_steps(host, host_tracer, host_inputs, 2)
        interop.layer_from_numpy(host, init)
        with _masks_seed_plus_one():
            twin_loss, twin_g = _d2s_steps(host, host_tracer, host_inputs,
                                           1)
    loss_margin = max(abs(c - h) / (1e-4 * abs(h))
                      for c, h in zip(card_loss, host_loss))
    twin_loss_margin = abs(twin_loss[0] - host_loss[0]) / (
        1e-4 * abs(host_loss[0]))
    bad, worst = _group_misses(card_g, host_g, 1e-3)
    twin_bad, twin_worst = _group_misses(twin_g, host_g, 1e-3)
    twin_margin = max(twin_worst.values()) / 1e-3
    _p(f"4o (a): card vs host, float32, dropout 0.1 live, {DY_HOST_ROWS} "
       f"rows x 2 to_static steps in {time.perf_counter() - t0:.1f} s: "
       f"losses card {card_loss}, host {host_loss}: worst {loss_margin:.3f}"
       f" of rtol 1e-4; first-step grads, worst |card - host| / largest of "
       f"group {max(worst.values()):.2e} (tolerance 1e-3); the seed + 1 "
       f"twin: loss {twin_loss[0]} ({twin_loss_margin:.1f} times the "
       f"loss tolerance), grads miss at {len(twin_bad)} of "
       f"{len(host_g)}, worst {twin_margin:.1f} times the tolerance  "
       f"[{card}]")
    if loss_margin > 1.0 or bad:
        raise SystemExit(f"chip_smoke: the to_static step's losses or the "
                         f"gradients of {bad[:5]} on the card disagree with "
                         f"the host's")
    if twin_margin < 10.0:
        raise SystemExit("chip_smoke: the to_static card-vs-host check "
                         "cannot tell the masks of another seed")

    # dropout 0: to_static against the eager tape on the card
    np.random.seed(SEED)
    m0 = BertForPretraining(**DY, dropout=0.0, attn_dropout=0.0)
    m0.train()
    m0.set_state_dict(init)
    static_loss, static_g = _d2s_steps(m0, tracer, inputs, 1)
    m0.set_state_dict(init)
    tape_loss, tape_g = _d2s_steps(m0, tracer, inputs, 1, to_static=False)
    model.set_state_dict(init)
    twin_tape_loss, twin_tape_g = _d2s_steps(model, tracer, inputs, 1,
                                             to_static=False)
    del m0
    bad, worst = _group_misses(static_g, tape_g, 1e-5)
    _, twin_worst = _group_misses(twin_tape_g, tape_g, 1e-5)
    rel = abs(static_loss[0] - tape_loss[0]) / abs(tape_loss[0])
    _p(f"4o (a): dropout 0, to_static vs the eager tape on the card: loss "
       f"{static_loss[0]} vs {tape_loss[0]} (relative {rel:.2e}), grads "
       f"worst {max(worst.values()):.2e} of their group's largest "
       f"(tolerance 1e-5); twin (the tape at dropout 0.1) worst "
       f"{max(twin_worst.values()):.2e}, "
       f"{max(twin_worst.values()) / 1e-5:.1f} times the tolerance  "
       f"[{card}]")
    if bad or rel > 1e-5:
        raise SystemExit(f"chip_smoke: the to_static gradients of "
                         f"{bad[:5]} disagree with the eager tape's")
    if max(twin_worst.values()) < 10 * 1e-5:
        raise SystemExit("chip_smoke: the to_static-vs-tape check cannot "
                         "tell dropout 0.1 from 0")
    return {"loss_margin": loss_margin, "grad_worst": max(worst.values()),
            "twin_margin": twin_margin}


def _d2s_train_leg(card):
    """(a): BertForPretraining at bench.py:1171's width, its loss under
    ``paddle.jit.to_static``, the 2.0 eager loop (``loss.backward()``,
    ``paddle.optimizer.Adam.step()``, ``clear_grad()``) under bf16
    ``auto_cast``, D2S_WARM + D2S_STEPS steps: one ``run_program`` tape
    entry a step, DY_LAUNCHES a step (fused Adam 0: the eager Adam runs
    an ``adam`` op a parameter).  Returns the launches over the timed
    steps and the numbers."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.fluid.framework import _dygraph_tracer
    from paddle_tpu_torch.models.bert import BertForPretraining

    t0 = time.perf_counter()
    np.random.seed(SEED)
    tracer = _dygraph_tracer()
    model = BertForPretraining(**DY)
    model.train()
    init = model.state_dict()
    loss_fn = paddle.jit.to_static(_d2s_loss)
    opt = paddle.optimizer.Adam(learning_rate=DY_LR,
                                parameters=model.parameters())
    inputs = [dybase.to_variable(t) for t in _dy_inputs(DY_BATCH)]
    tapes = []

    def step():
        loss = loss_fn(model, *inputs)
        tapes.append([e.op_type for e in tracer._tape])
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.value()

    _p(f"4o (a): BertForPretraining at BERT-base width (dropout 0.1), its "
       f"loss under paddle.jit.to_static, built in "
       f"{time.perf_counter() - t0:.1f} s")
    tracer._seed, tracer._seed_ctr = SEED + 5, 0
    with paddle.amp.auto_cast():
        for _ in range(D2S_WARM):
            step()
        torch.cuda.synchronize()
        counted = _counted_kernels()
        for fn in counted:
            fn.launches = 0
        _flash_copies_zero()
        tapes.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [step() for _ in range(D2S_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(x) for x in losses]
        host_ms, busy_ms, idle, kernels, by_class = _profile(step, 5)
    tokens = DY_BATCH * DY_SEQ * D2S_STEPS
    want = {n: DY_LAUNCHES.get(n, 0) * D2S_STEPS for n in launches}
    entries = sorted({tuple(t) for t in tapes})
    _p(f"4o (a): {D2S_STEPS} steps at {DY_BATCH} x {DY_SEQ}, bf16, in "
       f"{wall:.3f} s: {wall / D2S_STEPS * 1e3:.2f} ms/step, "
       f"{tokens / wall:.0f} tokens/s, peak memory {peak:.2f} GiB; losses "
       f"{[round(x, 4) for x in losses]}; tape entries a step before "
       f"backward {entries}; launches {launches}, expected {want}  [{card}]")
    top = sorted(by_class.items(), key=lambda kv: -kv[1])[:6]
    _p(f"4o (a) step, profiled: host {host_ms:.3f} ms, busy {busy_ms:.3f} "
       f"ms, idle {idle:.4f}, {kernels:.0f} kernels a step; "
       f"{', '.join(f'{c} {ms:.4f}' for c, ms in top)} (phase 4e's "
       f"functional step, PERF.md: 172.1 host, 51.4 busy ms)  [{card}]")
    if entries != [("run_program",)]:
        raise SystemExit("chip_smoke: the to_static step is not one "
                         "run_program tape entry")
    if launches != want:
        raise SystemExit("chip_smoke: the to_static step did not run "
                         "through the kernels as predicted")
    _flash_copies_check("to_static")
    if not np.isfinite(losses).all():
        raise SystemExit("chip_smoke: a to_static training loss is not "
                         "finite")
    check = _d2s_card_vs_host(model, tracer, init, card)
    return launches, dict(check, host_ms=host_ms, busy_ms=busy_ms,
                          idle=idle, kernels=kernels, peak_gib=peak,
                          tokens_per_s=tokens / wall,
                          step_ms=wall / D2S_STEPS * 1e3)


def _d2s_control(L, x, w, n, m):
    """(b)'s function: a tensor while (``n`` trips of a product and a
    normalisation), a tensor if, a for over a tensor range."""
    i = 0.0
    while i < n:
        y = L.matmul(x, w)
        x = y / L.sqrt(L.reduce_sum(L.square(y)))
        i = i + 1.0
    if L.reduce_mean(x) > 0:
        z = x * 2.0
    else:
        z = x - 1.0
    acc = z * 0.0
    for k in range(m):
        acc = acc + z
    return acc, i


def _d2s_control_run(place, trips):
    """(b)'s outputs and host reads on ``place``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.fluid import layers as L, trace

    rows, width = D2S_LOOP["rows"], D2S_LOOP["width"]
    rng = np.random.RandomState(SEED + 11)
    x = rng.randn(rows, width).astype("float32")
    w = (rng.randn(width, width) / np.sqrt(width)).astype("float32")
    reads = trace.metrics().counter("dy2static.host_reads")
    with dybase.guard(place):
        fn = paddle.jit.to_static(_d2s_control)
        args = [dybase.to_variable(a) for a in (
            x, w, np.float32(trips), np.int32(D2S_LOOP["range"]))]
        fn(L, *args)                     # the first call probes the else
        r0 = reads.value
        acc, i = fn(L, *args)
        return acc.numpy(), float(i.numpy()), reads.value - r0


def _d2s_control_leg(card):
    """(b): the card against the host, a twin of one trip fewer that
    must miss; host reads a call predicted: trips + 1 for the while, 1
    for the if, range + 1 for the for."""
    from paddle_tpu_torch import fluid

    t0 = time.perf_counter()
    trips = D2S_LOOP["trips"]
    card_acc, card_i, card_reads = _d2s_control_run(fluid.CUDAPlace(0),
                                                    trips)
    host_acc, host_i, host_reads = _d2s_control_run(fluid.CPUPlace(), trips)
    twin_acc, _, _ = _d2s_control_run(fluid.CPUPlace(), trips - 1)
    scale = float(np.abs(host_acc).max())
    err = float(np.abs(card_acc - host_acc).max()) / scale
    twin = float(np.abs(twin_acc - host_acc).max()) / scale
    want_reads = trips + 1 + 1 + D2S_LOOP["range"] + 1
    _p(f"4o (b): tensor while ({trips} trips of [{D2S_LOOP['rows']}, "
       f"{D2S_LOOP['width']}] x [{D2S_LOOP['width']}, {D2S_LOOP['width']}]"
       f" and a normalisation), tensor if, for over a tensor range of "
       f"{D2S_LOOP['range']}, in {time.perf_counter() - t0:.1f} s: card vs "
       f"host worst |diff| / largest {err:.2e} (tolerance {D2S_LOOP_RTOL}),"
       f" trips card {card_i}, host {host_i}; the {trips - 1}-trip twin "
       f"{twin:.2e} ({twin / D2S_LOOP_RTOL:.0f} times the tolerance); "
       f"host reads a call card {card_reads}, host {host_reads}, predicted "
       f"{want_reads}  [{card}]")
    if err > D2S_LOOP_RTOL or card_i != trips or host_i != trips:
        raise SystemExit("chip_smoke: to_static control flow on the card "
                         "disagrees with the host")
    if twin < 10 * D2S_LOOP_RTOL:
        raise SystemExit("chip_smoke: the control-flow check cannot tell "
                         "one trip fewer")
    if card_reads != want_reads or host_reads != want_reads:
        raise SystemExit("chip_smoke: dy2static.host_reads is not as "
                         "predicted")
    return {"err": err, "twin": twin, "host_reads": card_reads}


def _d2s_resnet_loss(model, images, labels):
    from paddle_tpu_torch.fluid import layers as L
    return L.nn.mean(L.softmax_with_cross_entropy(model(images), labels))


def _plain_tensor(t):
    import torch
    return type(t) is torch.Tensor and \
        not torch._C._functorch.is_functorch_wrapped_tensor(t)


def _d2s_resnet_leg(card):
    """(c): ResNet-50 at batch 32 of 224², bf16, its loss under
    to_static, SGD with momentum.  One step from the initial state by
    to_static and one by the eager tape: every moving statistic written
    back a plain tensor, within D2S_BN_RTOL of its largest of the eager
    loop's; the statistics not written back (the initial ones) are the
    twin.  Then D2S_RESNET_STEPS timed to_static steps; no hand-written
    kernel launches."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.fluid.framework import _dygraph_tracer
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.vision.models import resnet50

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    np.random.seed(SEED)
    tracer = _dygraph_tracer()
    model = resnet50(**RESNET)
    model.train()
    init = model.state_dict()
    images, labels = (dybase.to_variable(t) for t in _resnet_batch(
        D2S_RESNET_BATCH, RESNET_SIZE, RESNET["num_classes"],
        tracer.device))
    loss_fn = paddle.jit.to_static(_d2s_resnet_loss)

    def one_step(fn, opt):
        loss = fn(model, images, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.value()

    def optimizer():
        return paddle.optimizer.Momentum(
            learning_rate=RESNET_LR, momentum=RESNET_MU,
            parameters=model.parameters())

    before = [b.numpy() for b in model.buffers()]
    with paddle.amp.auto_cast():
        one_step(loss_fn, optimizer())
        stats = [b.numpy() for b in model.buffers()]
        plain = all(_plain_tensor(b.value()) for b in model.buffers())
        model.set_state_dict(init)
        one_step(_d2s_resnet_loss, optimizer())
        eager = [b.numpy() for b in model.buffers()]

        def worst(got):
            return max(float(np.abs(g - e).max()) / float(np.abs(e).max())
                       for g, e in zip(got, eager))
        err, twin = worst(stats), worst(before)
        model.set_state_dict(init)
        counted = _counted_kernels()
        for fn in counted:
            fn.launches = 0
        opt = optimizer()
        _timed_steps(f"4o (c) ResNet-50 to_static, bf16",
                     lambda: one_step(loss_fn, opt), D2S_RESNET_STEPS,
                     D2S_RESNET_BATCH, card)
        launches = {fn.__name__: fn.launches for fn in counted}
    model.eval()
    model(images)                        # an eval forward reads them
    model.train()
    _p(f"4o (c): ResNet-50, batch {D2S_RESNET_BATCH} of {RESNET_SIZE}², "
       f"bf16, in {time.perf_counter() - t0:.1f} s: {len(eager)} moving "
       f"statistics written back as plain tensors: {plain}; one to_static "
       f"step against one eager step from the same state, worst |diff| / "
       f"largest {err:.2e} (tolerance {D2S_BN_RTOL}); the statistics not "
       f"written back miss by {twin / D2S_BN_RTOL:.0f} times it; launches "
       f"{ {k: v for k, v in launches.items() if v} } (none predicted)  "
       f"[{card}]")
    if not plain or err > D2S_BN_RTOL:
        raise SystemExit("chip_smoke: to_static's moving statistics are "
                         "not the eager loop's plain tensors")
    if twin < 10 * D2S_BN_RTOL:
        raise SystemExit("chip_smoke: the statistics check cannot tell "
                         "statistics not written back")
    if any(launches.values()):
        raise SystemExit("chip_smoke: ResNet-50 launched a hand-written "
                         "kernel")
    return {"err": err, "twin": twin}


def _d2s_serve_leg(card):
    """(d): BERT-base's BertModel in eval, float32, D2S_SERVE_ROWS x 128,
    through ``paddle.jit.save`` and ``paddle.jit.load`` in one process:
    the exported graph holds the flash op once a layer, a call of the
    loaded artifact launches the flash forward once a layer and nothing
    else, its outputs within D2S_SERVE_RTOL of the largest of the eager
    forward's; the eager forward on the ids rolled by one position is
    the twin.  Returns the launches of one call and the numbers."""
    import tempfile
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.models.bert import BertModel

    t0 = time.perf_counter()
    np.random.seed(SEED)
    model = BertModel(**DY)
    model.eval()
    ids_np = np.random.RandomState(SEED + 13).randint(
        0, DY["vocab_size"], (D2S_SERVE_ROWS, DY_SEQ)).astype("int64")
    ids = dybase.to_variable(ids_np)
    want = [o.numpy() for o in model(ids)]
    twin = [o.numpy() for o in model(dybase.to_variable(
        np.roll(ids_np, 1, axis=1)))]
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        paddle.jit.save(model, d, input_spec=[ids_np])
        save_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        served = paddle.jit.load(d)
        load_s = time.perf_counter() - t1
        size = sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d))
    ops = [str(n.target) for n in served._exported.graph.nodes
           if n.op == "call_function"]
    in_graph = ops.count("paddle_tpu_torch.flash_attention_fwd.default")
    counted = _counted_kernels()
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    _flash_copies_zero()
    got = [o.numpy() for o in served(ids)]
    launches = {fn.__name__: fn.launches for fn in counted}
    _flash_copies_check("jit.load")
    scale = max(float(np.abs(w).max()) for w in want)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want)) / scale
    miss = max(float(np.abs(t - w).max())
               for t, w in zip(twin, want)) / scale
    host_ms, busy_ms, idle, kernels, by_class = _profile(
        lambda: served(ids), 10)
    top = sorted(by_class.items(), key=lambda kv: -kv[1])[:5]
    want_launches = {n: (DY["num_layers"] if n == "flash_attention_fwd"
                         else 0) for n in launches}
    _p(f"4o (d): BertModel (BERT-base) eval, float32, {D2S_SERVE_ROWS} x "
       f"{DY_SEQ}: jit.save {save_s:.1f} s ({size / 2 ** 20:.0f} MiB "
       f"written), jit.load {load_s:.1f} s; the exported graph holds "
       f"{in_graph} paddle_tpu_torch::flash_attention_fwd; a call launches "
       f"{ {k: v for k, v in launches.items() if v} }; worst |served - "
       f"eager| / largest {err:.2e} (tolerance {D2S_SERVE_RTOL}); the "
       f"rolled-ids twin {miss / D2S_SERVE_RTOL:.0f} times it; a call: host"
       f" {host_ms:.3f} ms ({D2S_SERVE_ROWS / host_ms * 1e3:.1f} rows/s), "
       f"busy {busy_ms:.3f} ms, idle {idle:.4f}, {kernels:.0f} kernels; "
       f"{', '.join(f'{c} {ms:.4f}' for c, ms in top)} (total "
       f"{time.perf_counter() - t0:.1f} s)  [{card}]")
    if in_graph != DY["num_layers"] or launches != want_launches:
        raise SystemExit("chip_smoke: the loaded artifact does not run "
                         "through the flash kernel once a layer")
    if err > D2S_SERVE_RTOL:
        raise SystemExit("chip_smoke: the loaded artifact disagrees with "
                         "the eager forward")
    if miss < 10 * D2S_SERVE_RTOL:
        raise SystemExit("chip_smoke: the deployment check cannot tell "
                         "rolled ids")
    return launches, {"err": err, "host_ms": host_ms, "busy_ms": busy_ms,
                      "idle": idle, "save_s": save_s, "load_s": load_s}


def phase_dy2static(card):
    """Phase 4o (a) to (d), the dygraph-to-static tier on the card's
    tracer.  Returns the launches of (a)'s timed steps and of one (d)
    call, and the numbers."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as dybase

    with dybase.guard(fluid.CUDAPlace(0)):
        train_launches, train = _d2s_train_leg(card)
        control = _d2s_control_leg(card)
        resnet = _d2s_resnet_leg(card)
        serve_launches, serve = _d2s_serve_leg(card)
    return {"train": train_launches, "jit_load": serve_launches,
            "numbers": dict(train=train, control=control, resnet=resnet,
                            serve=serve)}


def _d2s_amp_built(layers=BERT_BASE["layers"], decr_ratio=None):
    """(main, startup, loss, scaling vars, CompiledProgram): the static
    BERT program (BERT-base width, ``layers`` layers, dropout 0) under
    ``decorate(Adam, init_loss_scaling=2**15, use_dynamic_loss_scaling
    =True, decr_ratio)``, fuse_attention and fuse_optimizer applied."""
    from paddle_tpu_torch import amp, fluid
    from paddle_tpu_torch.fluid.framework import reset_unique_name
    from paddle_tpu_torch.models import static_graphs as sg

    b = BERT_BASE
    reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        ids = fluid.data("ids", [-1, b["seq"]], dtype="int64")
        labels = fluid.data("labels", [-1, 1], dtype="int64")
        am = L.reshape(fluid.data("attn_mask", [-1, b["seq"]]),
                       [0, 1, 1, b["seq"]])
        mask = L.scale(am, scale=10000.0, bias=-10000.0,
                       bias_after_scale=False)
        h = L.embedding(ids, size=[b["vocab"], b["hidden"]])
        for _ in range(layers):
            h = sg._naive_attention(h, b["hidden"], b["heads"], mask=mask)
            h = L.fc(h, b["hidden"], num_flatten_dims=2, act="relu")
        logits = L.fc(L.reduce_mean(h, dim=[1]), 2)
        loss = L.mean(L.softmax_with_cross_entropy(logits, labels))
        opt = amp.decorate(
            fluid.optimizer.AdamOptimizer(D2S_AMP["lr"]),
            init_loss_scaling=D2S_AMP["init_scale"],
            use_dynamic_loss_scaling=True,
            decr_ratio=decr_ratio or D2S_AMP["decr_ratio"])
        opt.minimize(loss)
    startup.random_seed = SEED
    scaling = [main.global_block().var(n)
               for n in ("loss_scaling", "good_steps", "bad_steps")]
    bs = fluid.BuildStrategy()
    bs.fuse_attention = bs.fuse_optimizer = True
    program = fluid.CompiledProgram(main, bs)
    program._apply_ir_passes([loss.name])
    return main, startup, loss, scaling, program


def _poisoned_feed(feed):
    """One infinite value in the attention mask: its bias makes a row of
    scores infinite, and every gradient overflows."""
    feed = dict(feed, attn_mask=feed["attn_mask"].copy())
    feed["attn_mask"].flat[0] = np.inf
    return feed


def _d2s_amp_host_check(card):
    """D2S_AMP_HOST's layers and rows: D2S_AMP_HOST["poisoned"]
    overflowing steps then good ones, on the card and on the host from
    one init: the (scale, good steps, bad steps) trajectory equal exactly,
    the good steps' losses within D2S_AMP_LOSS_RTOL; a host twin built
    with decr_ratio 0.8 must differ."""
    from paddle_tpu_torch import fluid

    h = D2S_AMP_HOST
    feed = _train_feed(np.random.RandomState(SEED + 5), h["rows"])
    feeds = [_poisoned_feed(feed)] * h["poisoned"] + [feed] * h["good"]
    main, startup, loss, scaling, program = _d2s_amp_built(h["layers"])
    init = _startup_state(main, startup, fluid.CPUPlace())
    runs = {}
    for name, place in (("card", fluid.CUDAPlace(0)),
                        ("host", fluid.CPUPlace())):
        runs[name], _ = _steps(program, main, [loss] + scaling, init, place,
                               feeds)
    tmain, _, tloss, tscaling, tprog = _d2s_amp_built(h["layers"], 0.8)
    runs["twin"], _ = _steps(tprog, tmain, [tloss] + tscaling, init,
                             fluid.CPUPlace(), feeds)
    traj = {k: [[float(np.ravel(_host(v))[0]) for v in out[1:]]
                for out in outs] for k, outs in runs.items()}
    losses = {k: [float(np.ravel(_host(out[0]))[0]) for out in outs]
              for k, outs in runs.items()}
    good = slice(h["poisoned"], None)
    margin = max(abs(c - o) / (D2S_AMP_LOSS_RTOL * abs(o)) for c, o in zip(
        losses["card"][good], losses["host"][good]))
    _p(f"4o (e): card vs host at {h['layers']} layers x {h['rows']} rows, "
       f"{h['poisoned']} overflowing steps then {h['good']}: (scale, good, "
       f"bad) card {traj['card']}, host {traj['host']}; good steps' losses "
       f"card {losses['card'][good]}, host {losses['host'][good]} (worst "
       f"{margin:.3f} of rtol {D2S_AMP_LOSS_RTOL}); the decr_ratio 0.8 "
       f"twin {traj['twin']}  [{card}]")
    if traj["card"] != traj["host"] or margin > 1.0:
        raise SystemExit("chip_smoke: static AMP's loss scaling on the card "
                         "is not the host's")
    if traj["twin"] == traj["host"]:
        raise SystemExit("chip_smoke: the loss-scaling check cannot tell "
                         "decr_ratio 0.8")
    s = D2S_AMP["init_scale"]
    if [t[0] for t in traj["card"][:2]] != [s, s * D2S_AMP["decr_ratio"]]:
        raise SystemExit("chip_smoke: the scale did not halve after two "
                         "bad steps")
    return {"trajectory": traj["card"], "loss_margin": margin}


def phase_static_amp(card):
    """Phase 4o (e): static AMP with dynamic loss scaling on the static
    BERT program at BERT-base width, D2S_AMP["rows"] rows, dropout 0,
    through fuse_attention and fuse_optimizer, D2S_WARM + D2S_STEPS
    steps; an overflowing step at full width sets FoundInfinite and zeroes
    every gradient; then ``_d2s_amp_host_check``.  Returns the launches
    over the timed steps and the numbers."""
    import torch
    from paddle_tpu_torch import fluid

    t0 = time.perf_counter()
    main, startup, loss, scaling, program = _d2s_amp_built()
    ops = main.global_block().ops
    types = [op.type for op in ops]
    count = {t: types.count(t) for t in (
        "fused_multihead_attention", "fused_adam", "adam",
        "check_finite_and_unscale", "update_loss_scaling")}
    _p(f"4o (e): the static BERT program at BERT-base width under "
       f"decorate(Adam({D2S_AMP['lr']}), init_loss_scaling="
       f"{D2S_AMP['init_scale']}, use_dynamic_loss_scaling=True, "
       f"decr_ratio={D2S_AMP['decr_ratio']}), fuse_attention + "
       f"fuse_optimizer, built in {time.perf_counter() - t0:.1f} s: "
       f"{count}, {len(types)} ops")
    if count != {"fused_multihead_attention": 0, "fused_adam": 1, "adam": 0,
                 "check_finite_and_unscale": 1, "update_loss_scaling": 1}:
        raise SystemExit("chip_smoke: the decorated program was not "
                         "rewritten as predicted")
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = _train_feed(np.random.RandomState(SEED), D2S_AMP["rows"])

    def step(f=feed, fetch=(loss, *scaling)):
        return exe.run(program, feed=f, fetch_list=list(fetch), scope=scope,
                       return_numpy=False)

    got = [step() for _ in range(D2S_WARM)]
    torch.cuda.synchronize()
    counted = _counted_kernels()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    timed = [step() for _ in range(D2S_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    got += timed
    losses = [float(_host(o[0]).ravel()[0]) for o in got]
    goods = [float(_host(o[2]).ravel()[0]) for o in got]
    want = {n: D2S_AMP_LAUNCHES.get(n, 0) * D2S_STEPS for n in launches}
    host_ms, busy_ms, idle, kernels, by_class = _profile(step, 5)
    top = sorted(by_class.items(), key=lambda kv: -kv[1])[:6]
    tokens = D2S_AMP["rows"] * BERT_BASE["seq"]
    _p(f"4o (e): {D2S_STEPS} timed steps at {D2S_AMP['rows']} rows in "
       f"{wall:.3f} s ({wall / D2S_STEPS * 1e3:.2f} ms a step, "
       f"{tokens * D2S_STEPS / wall:.0f} tokens/s); losses "
       f"{[round(x, 5) for x in losses]}; good steps {goods}; launches "
       f"{launches}, expected {want}; profiled: host {host_ms:.3f} ms, busy "
       f"{busy_ms:.3f} ms, idle {idle:.4f}, {kernels:.0f} kernels a step; "
       f"{', '.join(f'{c} {ms:.4f}' for c, ms in top)}  [{card}]")
    if launches != want:
        raise SystemExit("chip_smoke: the decorated step did not run "
                         "through the kernels as predicted")
    if not np.isfinite(losses).all() or goods != list(
            map(float, range(1, len(goods) + 1))):
        raise SystemExit("chip_smoke: a decorated step overflowed or lost "
                         "a good step")
    upd = next(op for op in ops if op.type == "update_loss_scaling")
    grads = upd.outputs["Out"]
    found = upd.inputs["FoundInfinite"][0]
    over = step(_poisoned_feed(feed), [found, *scaling] + grads)
    zero = all(not np.any(_host(g)) for g in over[4:])
    _p(f"4o (e): an overflowing step at full width: FoundInfinite "
       f"{bool(_host(over[0]).ravel()[0])}, all {len(grads)} gradients "
       f"zero: {zero}, (scale, good, bad) "
       f"{[float(_host(v).ravel()[0]) for v in over[1:4]]}")
    if not bool(_host(over[0]).ravel()[0]) or not zero:
        raise SystemExit("chip_smoke: an overflowing step was not caught")
    check = _d2s_amp_host_check(card)
    return launches, dict(check, host_ms=host_ms, busy_ms=busy_ms,
                          idle=idle, kernels=kernels,
                          step_ms=wall / D2S_STEPS * 1e3)


# ---------------------------------------------------------------------------
# phase 4p: the deployment path
# ---------------------------------------------------------------------------

def _counts_zero():
    for fn in _counted_kernels():
        fn.launches = 0


def _counts():
    return {fn.__name__: fn.launches for fn in _counted_kernels()}


def _counted_run(label, fn, want):
    """Run ``fn`` with every count set to 0 just before and read just
    after; fail unless the launches are ``want`` ({name: n}; None: the
    caller checks that count) and every other counted kernel's 0.
    Returns (fn's result, the counts)."""
    import torch
    torch.cuda.synchronize()
    _counts_zero()
    out = fn()
    torch.cuda.synchronize()
    counts = _counts()
    bad = {k: v for k, v in counts.items()
           if (v != 0 if k not in want else
               want[k] is not None and v != want[k])}
    if bad:
        raise SystemExit(f"chip_smoke: {label} launched {bad}, expected "
                         f"{want} and no other counted kernel")
    return out, counts


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _serve_predictor(pred, feed):
    for n in pred.get_input_names():
        pred.get_input_handle(n).copy_from_cpu(feed[n])
    pred.run()
    return pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()


def _bert_request(rng, rows):
    seq = BERT_BASE["seq"]
    lengths = rng.randint(1, seq + 1, rows)
    return {"ids": rng.randint(0, BERT_BASE["vocab"], (rows, seq))
            .astype("int64"),
            "attn_mask": (np.arange(seq)[None, :] < lengths[:, None])
            .astype("float32")}


@contextlib.contextmanager
def _swapped(values, a, b):
    """``values[a]`` and ``values[b]`` swapped (a scope's vars by name, or
    an artifact's weight list by index) for the block's duration."""
    values_get = values.find_var if hasattr(values, "find_var") \
        else values.__getitem__
    values_set = values.set_var if hasattr(values, "set_var") \
        else values.__setitem__
    va, vb = values_get(a), values_get(b)
    values_set(a, vb)
    values_set(b, va)
    try:
        yield
    finally:
        values_set(a, va)
        values_set(b, vb)


def _twin_misses(label, got, twin, tol):
    off = float(np.abs(got - twin).max())
    _p(f"deploy: {label} twin misses by {off:.3e} (must be at least 10 x "
       f"{tol:.3e})")
    if off < 10 * tol:
        raise SystemExit(f"chip_smoke: the {label} check cannot tell the "
                         f"answers from its twin's")


def _predictor_profile(label, fn, rows, card, iters=20):
    host_ms, busy_ms, idle, kernels, by_class = _profile(fn, iters)
    top = sorted(by_class.items(), key=lambda kv: -kv[1])[:4]
    _p(f"deploy: {label} at {rows} rows: host {host_ms:.3f} ms, busy "
       f"{busy_ms:.3f} ms, idle {idle:.4f}, {kernels:.0f} kernels, "
       f"{rows / host_ms * 1e3:.1f} rows/s; "
       + ", ".join(f"{c} {ms:.4f}" for c, ms in top) + f"  [{card}]")
    return dict(host_ms=host_ms, busy_ms=busy_ms, idle=idle,
                kernels=kernels, rows_per_s=rows / host_ms * 1e3)


def _artifact_at(art, feed, edge):
    """``feed``'s rows through the artifact's ``edge``-row program (the
    bucket a larger batch would take), sliced back."""
    import torch
    names = art.get_input_names()
    n = len(feed[names[0]])
    args = [art._arg(k, feed[k], edge, n) for k in names]
    args.append(torch.tensor(n, dtype=torch.int32, device=art.device))
    outs = art._call(edge, args)
    return dict(zip(art.get_output_names(),
                    [o[:n].float().cpu().numpy() for o in outs]))


def _deploy_bert(served, card, tmp):
    """(a) and (b); returns {run: launches} and the measurements."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.inference import (AnalysisConfig, create_predictor,
                                            load_aot_model, save_aot_model)
    from paddle_tpu_torch.inference.predictor import PrecisionType
    from paddle_tpu_torch.serving import ServingEngine

    _, frozen, scope, logits = served
    layers = BERT_BASE["layers"]
    feeds = ["ids", "attn_mask"]
    params = frozen.all_parameters()
    if len(params) != 1 + 8 * layers + 2:
        raise SystemExit("chip_smoke: the BERT program's parameters are "
                         "not in the order this phase reads them")
    q0, q1 = params[1].name, params[9].name      # layers 0 and 1's query
    exe = fluid.Executor(fluid.CUDAPlace(0))
    model_dir = os.path.join(tmp, "bert")
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(model_dir, feeds, [logits], exe,
                                      main_program=frozen,
                                      params_filename="params")
    save_s = time.perf_counter() - t0
    save_bytes = _dir_bytes(model_dir)
    _p(f"deploy: BERT-base save_inference_model {save_s:.2f} s, "
       f"{save_bytes} bytes (__model__ "
       f"{os.path.getsize(os.path.join(model_dir, '__model__'))}, "
       f"combined params "
       f"{os.path.getsize(os.path.join(model_dir, 'params'))}, params.npz "
       f"{os.path.getsize(os.path.join(model_dir, 'params.npz'))})")
    flash = {"flash_attention_fwd": layers}
    rng = np.random.RandomState(SEED + 20)
    feed_at = {n: _bert_request(rng, n) for n in DEPLOY_BERT_ROWS}
    want = {n: exe.run(frozen, feed=f, fetch_list=[logits], scope=scope)[0]
            for n, f in feed_at.items()}
    launches, out = {}, {"save_s": save_s, "save_bytes": save_bytes}

    pscope = fluid.Scope()
    with fluid.scope_guard(pscope):
        t0 = time.perf_counter()
        pred = create_predictor(AnalysisConfig(
            model_dir, params_file=os.path.join(model_dir, "params")))
        out["load_s"] = time.perf_counter() - t0
        fused = [op.type for op in pred._program.global_block().ops] \
            .count("fused_multihead_attention")
        _p(f"deploy: AnalysisPredictor loaded on {pred._exe.device} in "
           f"{out['load_s']:.2f} s, {fused} fused_multihead_attention ops")
        if fused != layers:
            raise SystemExit("chip_smoke: the loaded BERT program lost its "
                             "fused attention ops")
        got = {}
        for n, f in feed_at.items():
            got[n], c = _counted_run(f"the BERT predictor at {n} rows",
                                     lambda: _serve_predictor(pred, f),
                                     flash)
            launches[f"bert_predictor_{n}"] = c
            exact = np.array_equal(got[n], want[n])
            _p(f"deploy: BERT predictor at {n} rows: flash launches "
               f"{c['flash_attention_fwd']}, logits equal to the in-memory "
               f"program's bit for bit: {exact}")
            if got[n].shape != (n, 2) or not exact:
                raise SystemExit("chip_smoke: the loaded BERT program "
                                 "answers otherwise than the in-memory one")
        tol8 = DEPLOY_TOL * float(np.abs(want[8]).max())
        with _swapped(pscope, q0, q1):
            _twin_misses("BERT predictor (query weights of layers 0 and 1 "
                         "swapped)", got[8], _serve_predictor(pred, feed_at[8]),
                         tol8)
        out["predictor"] = {n: _predictor_profile(
            "BERT predictor", lambda f=f: _serve_predictor(pred, f), n, card)
            for n, f in feed_at.items()}
        # bf16 rounds the program's padding bias, (m - 10000) * 10000, to
        # one value for m = 0 and 1: the bf16 check also runs unpadded rows
        full32 = dict(feed_at[32], attn_mask=np.ones_like(
            feed_at[32]["attn_mask"]))
        got_full32 = _serve_predictor(pred, full32)

        # (b) the artifact, exported from the predictor's scope
        aot_dir = os.path.join(tmp, "bert_aot")
        t0 = time.perf_counter()
        meta = save_aot_model(aot_dir, pred, feed_at[8],
                              bucket_edges=DEPLOY_BERT_ROWS)
        out["export_s"] = time.perf_counter() - t0
    out["aot_bytes"] = _dir_bytes(aot_dir)
    w_bytes = os.path.getsize(os.path.join(aot_dir, meta["weights_file"]))
    t0 = time.perf_counter()
    art = load_aot_model(aot_dir)
    for e in DEPLOY_BERT_ROWS:
        art._module(e)
    out["aot_load_s"] = time.perf_counter() - t0
    _p(f"deploy: save_aot_model (edges {DEPLOY_BERT_ROWS} and the 8-row "
       f"example) {out['export_s']:.2f} s, {out['aot_bytes']} bytes on "
       f"disk ({w_bytes} of them the weights, once); load_aot_model on "
       f"{art.device} {out['aot_load_s']:.2f} s")
    for e in DEPLOY_BERT_ROWS:
        held = [str(nd.target) for nd in art._module(e).graph.nodes
                if nd.op == "call_function"].count(
            "paddle_tpu_torch.flash_attention_fwd.default")
        if held != layers:
            raise SystemExit(f"chip_smoke: the {e}-row exported graph holds "
                             f"the flash op {held} times, not {layers}")
    _p(f"deploy: each exported graph holds paddle_tpu_torch::"
       f"flash_attention_fwd {layers} times")
    i0, i1 = meta["param_names"].index(q0), meta["param_names"].index(q1)
    worst = 0.0
    for n, f in feed_at.items():
        a, c = _counted_run(f"the BERT artifact at {n} rows",
                            lambda: art(f)[logits.name], flash)
        launches[f"bert_aot_{n}"] = c
        err = float(np.abs(a - got[n]).max())
        tol = DEPLOY_TOL * float(np.abs(got[n]).max())
        worst = max(worst, err / tol)
        _p(f"deploy: BERT artifact at {n} rows: flash launches "
           f"{c['flash_attention_fwd']}, max |err| against the predictor "
           f"{err:.3e} (tolerance {tol:.3e}; exact: {err == 0.0})")
        if err > tol:
            raise SystemExit("chip_smoke: the BERT artifact disagrees with "
                             "the predictor")
    with _swapped(art._weights, i0, i1):
        twin8 = art(feed_at[8])[logits.name]
    _twin_misses("BERT artifact (query weights swapped)", got[8], twin8, tol8)
    out["aot"] = {n: _predictor_profile(
        "BERT artifact", lambda f=f: art(f), n, card)
        for n, f in feed_at.items()}

    # bf16 in a scope of its own: the cast replaces the scope's weights
    with fluid.scope_guard(fluid.Scope()):
        cfg = AnalysisConfig(model_dir,
                             params_file=os.path.join(model_dir, "params"))
        cfg.set_precision(PrecisionType.Bfloat16)
        p16 = create_predictor(cfg)
        bscope = fluid.global_scope()
        held = {str(bscope.find_var(v.name).dtype)
                for v in p16._program.global_block().vars.values()
                if v.persistable and bscope.find_var(v.name) is not None}
        if held != {"torch.bfloat16"}:
            raise SystemExit(f"chip_smoke: the bf16 predictor holds {held}")

        def rel(a, b):
            return float(np.linalg.norm(a - b) / np.linalg.norm(b))
        errs = {}
        for label, f, ref in (("padded", feed_at[32], got[32]),
                              ("full-length", full32, got_full32)):
            g16, c = _counted_run(f"the bf16 BERT predictor ({label})",
                                  lambda: _serve_predictor(p16, f), flash)
            launches[f"bert_bf16_{label}"] = c
            errs[label] = rel(g16, ref)
        with _swapped(bscope, q0, q1):
            errs["twin"] = rel(_serve_predictor(p16, full32), got_full32)
        tol = DEPLOY_BF16_TOL["full-length"]
        _p(f"deploy: bf16 predictor (every weight bfloat16, 12 flash "
           f"launches a run) at 32 rows, relative L2 error against "
           f"float32: padded requests {errs['padded']:.4f}, full-length "
           f"{errs['full-length']:.4f} (tolerances {DEPLOY_BF16_TOL}); the "
           f"query-swapped twin, full-length, {errs['twin']:.4f} "
           f"({errs['twin'] / tol:.2f} x the tolerance: must miss it)")
        if errs["padded"] > DEPLOY_BF16_TOL["padded"] \
                or errs["full-length"] > tol or errs["twin"] <= tol:
            raise SystemExit("chip_smoke: the bf16 predictor strays past "
                             "its tolerance, or nearer its twin")
        out["bf16_err"] = errs
        out["bf16"] = _predictor_profile(
            "bf16 BERT predictor", lambda: _serve_predictor(p16, feed_at[32]),
            32, card)
        del p16

    # the engine over the artifact
    reqs = [_bert_request(rng, int(n))
            for n in rng.randint(1, MAX_BATCH + 1, DEPLOY_REQUESTS)]
    eng = ServingEngine(art, max_batch=MAX_BATCH)
    try:
        eng.warmup()
        b0 = eng.batches

        def burst():
            t0 = time.perf_counter()
            futs = [eng.submit(r) for r in reqs]
            answers = [f.result(timeout=600)[logits.name] for f in futs]
            return futs, answers, time.perf_counter() - t0
        (futs, answers, wall), c = _counted_run(
            "the engine over the BERT artifact", burst,
            {"flash_attention_fwd": None})
        batches = eng.batches - b0
    finally:
        eng.close()
    launches["bert_engine"] = c
    if c["flash_attention_fwd"] != layers * batches:
        raise SystemExit("chip_smoke: the engine over the artifact did not "
                         "launch flash once a layer a batch")
    rows = [len(r["ids"]) for r in reqs]
    # each answer against its rows through the bucket program its batch
    # rode in (the same bits: no row reads another) and through their own
    # bucket's.  A program of another batch shape may run other cuBLAS
    # kernels, and the program's padding bias, (m - 10000) * 10000, keeps
    # float32 scores only to steps of 8, where a last-bit difference can
    # move a score by 8: the own-bucket comparison is reported, the exact
    # one carries the check
    worst_engine, over, exact = 0.0, [], 0
    with _swapped(art._weights, i0, i1):
        twins = [art(reqs[i])[logits.name] for i in range(3)]
    for i, (r, a) in enumerate(zip(reqs, answers)):
        n = len(r["ids"])
        if a.shape != (n, 2):
            raise SystemExit(f"chip_smoke: the engine answered request {i} "
                             f"with shape {a.shape}")
        one = art(r)[logits.name]
        tol = DEPLOY_TOL * float(np.abs(one).max())
        err = float(np.abs(a - one).max())
        worst_engine = max(worst_engine, err / tol)
        if err > tol:
            over.append((i, n, round(err / tol, 2)))
        if not any(np.array_equal(a, _artifact_at(art, r, e)[logits.name])
                   for e in DEPLOY_BERT_ROWS if e >= n):
            raise SystemExit(f"chip_smoke: the engine's answer to request "
                             f"{i} is no bucket program's on its rows")
        exact += 1
        if i < 3:
            _twin_misses(f"engine request {i}", a, twins[i], tol)
    _p(f"deploy: engine answers: {exact} of {len(reqs)} equal bit for bit "
       f"to their rows through a bucket program; against one artifact call "
       f"on their rows (their own bucket) worst {worst_engine:.3f} of "
       f"1e-5 of the largest logit, over it {over}")
    lat = np.array([f.timing["latency_us"] for f in futs]) / 1e3
    out["engine"] = dict(requests=len(reqs), rows=sum(rows), batches=batches,
                         rows_per_s=sum(rows) / wall,
                         p50_ms=float(np.percentile(lat, 50)),
                         p99_ms=float(np.percentile(lat, 99)),
                         worst_err_over_tol=worst_engine, over=over)
    _p(f"deploy: ServingEngine over the artifact answered {len(reqs)} "
       f"requests ({sum(rows)} rows) in {batches} batches, flash launches "
       f"{c['flash_attention_fwd']} = {layers} x {batches}; p50 "
       f"{out['engine']['p50_ms']:.2f} ms, p99 "
       f"{out['engine']['p99_ms']:.2f} ms, {sum(rows) / wall:.1f} rows/s  "
       f"[{card}]")
    out["aot_worst_err_over_tol"] = worst
    del art
    return launches, out


def _deploy_ctr(ctr_served, card, tmp):
    """(c); returns {run: launches} and the measurements."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.proto import framework_pb2
    from paddle_tpu_torch.inference import (AnalysisConfig, create_predictor,
                                            load_aot_model, save_aot_model)

    _, frozen, scope, logit = ctr_served
    slots, vocab = CTR["slots"], CTR["vocab"]
    feeds = ["dense"] + [f"ids_{i}" for i in range(slots)]
    tables = {op.input("Ids")[0]: op.input("W")[0]
              for op in frozen.global_block().ops
              if op.type == "fused_embedding_pool"}
    t0_, t1_ = tables["ids_0"], tables["ids_1"]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    model_dir = os.path.join(tmp, "ctr")
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(model_dir, feeds, [logit], exe,
                                      main_program=frozen,
                                      params_filename="params")
    out = {"save_s": time.perf_counter() - t0,
           "save_bytes": _dir_bytes(model_dir)}
    with open(os.path.join(model_dir, "__model__"), "rb") as f:
        desc = framework_pb2.ProgramDesc.FromString(f.read())
    in_model = [op.type for op in desc.blocks[0].ops].count(
        "fused_embedding_pool")
    _p(f"deploy: CTR save_inference_model {out['save_s']:.2f} s, "
       f"{out['save_bytes']} bytes; __model__ holds {in_model} "
       f"fused_embedding_pool ops")
    if in_model != slots:
        raise SystemExit("chip_smoke: the saved CTR program lost its fused "
                         "gather-pool ops")
    pool = {"embedding_pool_fwd": slots}
    rng = np.random.default_rng(SEED + 20)
    perm = rng.permutation(vocab)
    feed_at = {n: _ctr_feed(rng, n, vocab, perm) for n in DEPLOY_CTR_ROWS}
    want = {n: exe.run(frozen, feed=f, fetch_list=[logit], scope=scope)[0]
            for n, f in feed_at.items()}
    launches = {}
    pscope = fluid.Scope()
    with fluid.scope_guard(pscope):
        t0 = time.perf_counter()
        pred = create_predictor(AnalysisConfig(
            model_dir, params_file=os.path.join(model_dir, "params")))
        out["load_s"] = time.perf_counter() - t0
        got = {}
        for n, f in feed_at.items():
            got[n], c = _counted_run(f"the CTR predictor at {n} rows",
                                     lambda: _serve_predictor(pred, f), pool)
            launches[f"ctr_predictor_{n}"] = c
            tol = DEPLOY_TOL * float(np.abs(want[n]).max())
            err = float(np.abs(got[n] - want[n]).max())
            _p(f"deploy: CTR predictor at {n} rows: gather-pool launches "
               f"{c['embedding_pool_fwd']}, max |err| against phase 4c's "
               f"program {err:.3e} (tolerance {tol:.3e})")
            if got[n].shape != (n, 1) or err > tol:
                raise SystemExit("chip_smoke: the CTR predictor disagrees "
                                 "with the served program")
        n = DEPLOY_CTR_ROWS[-1]
        tol = DEPLOY_TOL * float(np.abs(want[n]).max())
        with _swapped(pscope, t0_, t1_):
            _twin_misses("CTR predictor (slots 0 and 1's tables swapped)",
                         got[n], _serve_predictor(pred, feed_at[n]), tol)
        out["predictor"] = {n: _predictor_profile(
            "CTR predictor", lambda f=f: _serve_predictor(pred, f), n, card)
            for n, f in feed_at.items()}
        aot_dir = os.path.join(tmp, "ctr_aot")
        t0 = time.perf_counter()
        meta = save_aot_model(aot_dir, pred, feed_at[64],
                              bucket_edges=DEPLOY_CTR_ROWS)
        out["export_s"] = time.perf_counter() - t0
        del pred
    out["aot_bytes"] = _dir_bytes(aot_dir)
    t0 = time.perf_counter()
    art = load_aot_model(aot_dir)
    for e in DEPLOY_CTR_ROWS:
        art._module(e)
    out["aot_load_s"] = time.perf_counter() - t0
    _p(f"deploy: CTR save_aot_model {out['export_s']:.2f} s, "
       f"{out['aot_bytes']} bytes on disk, load {out['aot_load_s']:.2f} s")
    for e in DEPLOY_CTR_ROWS:
        held = [str(nd.target) for nd in art._module(e).graph.nodes
                if nd.op == "call_function"].count(
            "paddle_tpu_torch.embedding_pool_fwd.default")
        if held != slots:
            raise SystemExit(f"chip_smoke: the {e}-row CTR graph holds the "
                             f"gather-pool op {held} times, not {slots}")
    for n, f in feed_at.items():
        a, c = _counted_run(f"the CTR artifact at {n} rows",
                            lambda: art(f)[logit.name], pool)
        launches[f"ctr_aot_{n}"] = c
        tol = DEPLOY_TOL * float(np.abs(want[n]).max())
        err = float(np.abs(a - want[n]).max())
        _p(f"deploy: CTR artifact at {n} rows: gather-pool launches "
           f"{c['embedding_pool_fwd']}, max |err| against phase 4c's "
           f"program {err:.3e} (tolerance {tol:.3e}; exact: {err == 0.0})")
        if err > tol:
            raise SystemExit("chip_smoke: the CTR artifact disagrees")
    names = meta["param_names"]
    n = DEPLOY_CTR_ROWS[-1]
    with _swapped(art._weights, names.index(t0_), names.index(t1_)):
        twin = art(feed_at[n])[logit.name]
    _twin_misses("CTR artifact (tables swapped)", got[n], twin,
                 DEPLOY_TOL * float(np.abs(want[n]).max()))
    out["aot"] = {n: _predictor_profile(
        "CTR artifact", lambda f=f: art(f), n, card)
        for n, f in feed_at.items()}
    del art
    return launches, out


def _deploy_fixture(card, tmp):
    """(d): the reference's own saved model on the card."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor

    src = os.path.join(ROOT, "tests", "fixtures", "ref_fc_model")
    x = np.random.RandomState(SEED + 3).randn(6, 4).astype("float32")
    with fluid.scope_guard(fluid.Scope()):
        cfg = AnalysisConfig(src)
        cfg.disable_gpu()
        host_pred = create_predictor(cfg)
        want = _serve_predictor(host_pred, {"x": x})
        b = fluid.global_scope().find_var("b")
        fluid.global_scope().set_var("b", b.roll(1))
        twin = _serve_predictor(host_pred, {"x": x})
    with fluid.scope_guard(fluid.Scope()):
        pred = create_predictor(AnalysisConfig(src))
        got, c = _counted_run("the fixture's predictor",
                              lambda: _serve_predictor(pred, {"x": x}), {})
        tol = DEPLOY_TOL * float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        _p(f"deploy: ref_fc_model (feed -> mul -> elementwise_add -> "
           f"softmax -> fetch, per-var params) on {pred._exe.device}: max "
           f"|err| against the host {err:.3e} (tolerance {tol:.3e})")
        if got.shape != (6, 3) or err > tol:
            raise SystemExit("chip_smoke: the reference's model serves "
                             "otherwise on the card")
        _twin_misses("fixture (bias rolled)", got, twin, tol)
        again = os.path.join(tmp, "fixture")
        block = pred._program.global_block()
        fluid.io.save_inference_model(
            again, pred.get_input_names(),
            [block.var(n) for n in pred.get_output_names()], pred._exe,
            main_program=pred._program, params_filename="params")
    with fluid.scope_guard(fluid.Scope()):
        back = create_predictor(AnalysisConfig(
            again, params_file=os.path.join(again, "params")))
        reloaded = _serve_predictor(back, {"x": x})
    _p(f"deploy: re-exported with params_filename and loaded back: equal "
       f"bit for bit {np.array_equal(reloaded, got)}")
    if not np.array_equal(reloaded, got):
        raise SystemExit("chip_smoke: the re-exported fixture answers "
                         "otherwise")
    return {"fixture": c}, {"err": err}


def phase_deploy(served, ctr_served, card):
    """Phase 4p; returns {run: {kernel: launches}} and the measurements."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    try:
        launches, out = {}, {}
        for key, (l, o) in (("bert", _deploy_bert(served, card, tmp)),
                            ("ctr", _deploy_ctr(ctr_served, card, tmp)),
                            ("fixture", _deploy_fixture(card, tmp))):
            launches.update(l)
            out[key] = o
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, out


def _kernel_row(name, source, replaces, launches, row, **extra):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, **{k: row[k] for k in keys}, **extra)


def _timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    _p(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    import torch  # noqa: F401
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    kind, count, card = phase_device()
    _timed("2 build", phase_build)
    fwd_rows = _timed("3 flash forward", phase_kernels)
    bwd_rows = _timed("3 flash backward", phase_kernels_bwd)
    nmt_flash_rows = _timed("3 flash at the NMT shapes",
                            phase_kernels_flash_nmt)
    adam_row = _timed("3 fused Adam", phase_kernels_adam)
    ctr_rows = _timed("3 embedding kernels", phase_kernels_ctr)
    momentum_row = _timed("3 fused Momentum", phase_kernels_momentum)
    dropout_rows = _timed("3e dropout kernels", phase_kernels_dropout)
    nmt_dropout_rows = _timed("3e dropout kernels at the NMT shapes",
                              phase_kernels_dropout_nmt)
    ptb_dropout_rows = _timed("3e dropout kernels at the PTB shape",
                              phase_kernels_dropout_ptb)
    serve_launches, served = _timed("4 serve", phase_serve, card)
    train_launches, trained = _timed("4b train", phase_train, card)
    ctr_serve_launches, arrays, ctr_served = _timed(
        "4c serve CTR", phase_serve_ctr, card)
    ctr_launches, ctr_trained = _timed("4d train CTR", phase_train_ctr,
                                       arrays, card)
    del arrays
    paged_rows = _timed("3f paged attention", phase_kernels_paged, card)
    # 4f builds static programs, so it runs before 4e turns dygraph on
    decode_launches, decode_served, decode_ref = _timed(
        "4f serve decode", phase_serve_decode, card)
    # 4q builds static programs too, and reads 4f's outputs
    spec_launches = _timed("4q speculative decode and the SLO surface",
                           phase_speculative, decode_served, decode_ref,
                           served, card)
    del decode_ref
    book_launches, book_kernels, book_profiled = _timed(
        "4g static e2e / LeNet", phase_static_book, card)
    # 4n and 4k build static programs too: before 4e turns dygraph on
    recipe_launches, master_rows, master_launches, _ = _timed(
        "4n static training surface", phase_static_training, card)
    amp_launches, _ = _timed("4o (e) static AMP", phase_static_amp, card)
    # 4p saves and loads static programs: before 4e turns dygraph on
    deploy_launches, _ = _timed("4p deployment", phase_deploy, served,
                                ctr_served, card)
    box_launches, box_legs_launches, box = _timed(
        "4k train CTR through BoxPS", phase_train_boxps, card)
    dy_launches, dy_step = _timed("4e train dygraph BERT",
                                  phase_train_dygraph, card)
    resnet = _timed("4h train dygraph ResNet-50", phase_train_resnet, card)
    nmt_launches, nmt_step = _timed("4i train Transformer NMT",
                                    phase_train_nmt, card)
    mobilenet = _timed("4j train MobileNetV2", phase_train_mobilenet, card)
    ptb_launches, _ = _timed("4l train PTB LM and dygraph CTR",
                             phase_train_ptb_ctr, card)
    hapi = _timed("4m hapi Model.fit and paddle.grad", phase_hapi, card)
    d2s = _timed("4o dygraph-to-static", phase_dy2static, card)
    _timed("5 profile", phase_profile, served, trained, card)
    _timed("5 profile CTR", phase_profile_ctr, ctr_served, ctr_trained,
           card)
    _timed("5 profile dygraph", phase_profile_dygraph, dy_step, card)
    _timed("5 profile decode", phase_profile_decode, decode_served, card)
    _timed("5 profile LeNet", phase_profile_lenet, book_profiled, card)
    _timed("5 profile ResNet-50", phase_profile_resnet, resnet, card)
    _timed("5 profile NMT", phase_profile_nmt, nmt_step, card)
    _timed("5 profile MobileNetV2", phase_profile_mobilenet, mobilenet, card)
    shape = [MAX_BATCH, BERT_BASE["heads"], BERT_BASE["seq"],
             BERT_BASE["hidden"] // BERT_BASE["heads"]]
    # the forward runs on both paths: "launches" stays the served path's
    # count, as in the first slice's line, and "train_launches" is the
    # training path's; the other kernels run on the training path only
    fp32 = fwd_rows["fp32"]
    kernels = [
        _kernel_row("flash_attention_fwd",
                    "paddle_tpu_torch/csrc/flash_attention.cu",
                    "paddle_tpu/ops/pallas_kernels.py:41",
                    serve_launches["flash_attention_fwd"], fp32,
                    train_launches=train_launches["flash_attention_fwd"],
                    dygraph_launches=dy_launches["flash_attention_fwd"],
                    max_err=fp32["max_abs_err"],
                    bound_us=fp32["bound_ms"] * 1e3,
                    dtype="float32", shape=shape, bf16=fwd_rows["bf16"],
                    b1={"float32": fwd_rows["B=1 fp32"],
                        "bfloat16": fwd_rows["B=1 bf16"]},
                    copies={p: c["flash_attention_fwd"]
                            for p, c in FLASH_COPIES.items()}),
        _kernel_row("flash_attention_bwd",
                    "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                    "paddle_tpu/ops/pallas_kernels.py:41",
                    train_launches["flash_attention_bwd"], bwd_rows["fp32"],
                    dygraph_launches=dy_launches["flash_attention_bwd"],
                    dtype="float32", shape=shape, bf16=bwd_rows["bf16"],
                    b1={"float32": bwd_rows["B=1 fp32"],
                        "bfloat16": bwd_rows["B=1 bf16"]},
                    copies={p: c["flash_attention_bwd"]
                            for p, c in FLASH_COPIES.items()}),
        _kernel_row("fused_adam", "paddle_tpu_torch/csrc/fused_adam.cu",
                    "paddle_tpu/ops/pallas_kernels.py:647",
                    train_launches["fused_adam"], adam_row,
                    dtype="float32", values=adam_row["values"],
                    op_ms=adam_row["op_ms"], call_ms=adam_row["call_ms"],
                    bytes_per_value=28, library="torch._fused_adam_",
                    lenet_launches=book_launches["fused_adam"],
                    lenet=book_kernels["fused_adam"])]
    # the CTR rows: the path's D = 16 and Zipf ids; the forward's
    # "launches" is the served count, "train_launches" the training one's
    fwd16, grad16 = ctr_rows[(CTR["dim"], "zipf")]
    emb_shape = [CTR_TRAIN_ROWS, CTR["seq"], CTR["vocab"], CTR["dim"]]
    kernels += [
        _kernel_row("embedding_pool_fwd",
                    "paddle_tpu_torch/csrc/embedding_pool.cu",
                    "paddle_tpu/ops/pallas_kernels.py:455",
                    ctr_serve_launches, fwd16,
                    train_launches=ctr_launches["embedding_pool_fwd"],
                    call_ms=fwd16["call_ms"],
                    also_replaces="paddle_tpu/ops/pallas_kernels.py:506",
                    dtype="float32", shape=emb_shape, ids="zipf",
                    library="embedding_bag",
                    by_rows=fwd16["by_rows"],
                    launch_floor_ms=fwd16["launch_floor_ms"],
                    d128=ctr_rows[(128, "zipf")][0]),
        _kernel_row("embedding_pool_grad",
                    "paddle_tpu_torch/csrc/embedding_pool_grad.cu",
                    "paddle_tpu/ops/pallas_kernels.py:550",
                    ctr_launches["embedding_pool_grad"], grad16,
                    call_ms=grad16["call_ms"], split_ms=grad16["split_ms"],
                    also_replaces="paddle_tpu/ops/pallas_kernels.py:603",
                    dtype="float32", shape=emb_shape, ids="zipf",
                    library="embedding_bag weight gradient",
                    d128=ctr_rows[(128, "zipf")][1]),
        _kernel_row("fused_momentum",
                    "paddle_tpu_torch/csrc/fused_momentum.cu",
                    "paddle_tpu/ops/pallas_kernels.py:678",
                    ctr_launches["fused_momentum"], momentum_row,
                    dtype="float32", values=momentum_row["values"],
                    op_ms=momentum_row["op_ms"],
                    library="torch._fused_sgd_",
                    clip_case_launches=book_launches["fused_momentum"],
                    clip_case=book_kernels["fused_momentum"])]
    # the dropout rows: the dygraph step's shapes in float32 (its
    # embedding dropout's dtype) with bfloat16 (the encoder's) beside;
    # launches per the 10 timed dygraph steps
    src = "paddle_tpu/ops/pallas_kernels.py"
    replaces = {
        "fused_dropout": (":175", ":693 fused_dropout_tpu; :203 and :271, "
                          "the backward of dropout and of dropout-add's x"),
        "dropout_mask": (":706", None),
        "fused_dropout_add": (":246", ":280 fused_dropout_add_tpu"),
        "fused_act_dropout": (":348", ":392 fused_act_dropout_tpu"),
        "fused_act_dropout_bwd": (":370", None)}
    for name, (site, also) in replaces.items():
        extra = {"also_replaces": src + also} if also else {}
        if name == "fused_dropout":
            extra["library"] = "torch.nn.functional.dropout"
        elif name == "dropout_mask":
            extra["library"] = ("torch.empty(uint8).bernoulli_(1 - rate), "
                                "which draws other bits")
            extra["cold_ms"] = dropout_rows[name]["cold_ms"]
            extra["write_floor_ms"] = dropout_rows[name]["write_floor_ms"]
        row = dropout_rows[name]
        kernels.append(_kernel_row(
            name, "paddle_tpu_torch/csrc/fused_dropout.cu", src + site,
            dy_launches[name], row,
            dtype=row["dtype"], shape=row["shape"], bf16=row["bf16"],
            **extra))
    # the paged row: the decode path's 32 slots, all 512 positions valid,
    # cold (the L2 flushed before each call); launches from phase 4f's
    # requests; warm times and the 300-valid case beside
    b = max(PAGED["slots"])
    keys = ("ms", "warm_ms", "plain_ms", "plain_warm_ms", "bound_ms",
            "library_ms", "library_warm_ms")
    kernels.append(_kernel_row(
        "paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/pallas_kernels.py:117", decode_launches,
        paged_rows[b], dtype="float32", timing="cold",
        warm_ms=paged_rows[b]["warm_ms"],
        shape=[b, PAGED["seq"], PAGED["rows"], PAGED["d"]],
        library="index_select x 2 + scaled_dot_product_attention",
        by_slots={n: {k: r[k] for k in keys}
                  for n, r in paged_rows.items() if isinstance(n, int)},
        valid300={k: paged_rows[(b, "300 valid")][k]
                  for k in keys + ("max_abs_err", "n_valid")}))
    # the NMT step's launches over its NMT_STEPS timed steps, and the
    # flash and dropout kernels at its shapes
    for row in kernels:
        row["nmt_launches"] = nmt_launches[row["name"]]
    for row in kernels[:2]:
        row["nmt"] = nmt_flash_rows[
            "forward" if row["name"] == "flash_attention_fwd"
            else "backward"]
    for row in kernels:
        if row["name"] in nmt_dropout_rows:
            row["nmt"] = nmt_dropout_rows[row["name"]]
    # the BoxPS slice (phase 4k): its kernel-tier leg's launches over its
    # timed steps, and those of its fp32 and bf16 legs
    for row in kernels:
        row["boxps_launches"] = box_launches[row["name"]]
        row["boxps_legs_launches"] = box_legs_launches[row["name"]]
    # the 2.0 dygraph loop (phase 4l): the PTB step's launches over its
    # PTB_STEPS timed float32 steps, and the dropout kernels at its shape
    for row in kernels:
        row["ptb_launches"] = ptb_launches[row["name"]]
        if row["name"] in ptb_dropout_rows:
            row["ptb"] = ptb_dropout_rows[row["name"]]
    # the 2.0 surface (phase 4m): launches over the NMT Model.fit's
    # HAPI_NMT_STEPS timed steps and over the static LeNet fit
    for row in kernels:
        row["hapi_launches"] = {
            "nmt_fit": hapi["nmt_fit"][row["name"]],
            "lenet_static_fit": hapi["lenet_static_fit"][row["name"]]}
    # the static training surface (phase 4n): the recipe's launches over
    # its timed steps on every row; the two master paths' rows, launched
    # once a step by (c)'s fused runs
    for row in kernels:
        row["recipe_launches"] = recipe_launches[row["name"]]
    # the dygraph-to-static tier (phase 4o): launches over (a)'s timed
    # to_static steps, of one call of (d)'s loaded artifact and over (e)'s
    # timed decorated steps
    for row in kernels:
        row["to_static_launches"] = {
            "train": d2s["train"][row["name"]],
            "jit_load": d2s["jit_load"][row["name"]],
            "static_amp": amp_launches[row["name"]]}
    for opt, line in (("adam", ":647"), ("momentum", ":678")):
        name = f"fused_{opt}_master"
        row = master_rows[name]
        kernels.append(_kernel_row(
            name, f"paddle_tpu_torch/csrc/fused_{opt}.cu",
            "paddle_tpu/ops/pallas_kernels.py" + line,
            master_launches[name], row, dtype="bfloat16 params, float32 "
            "masters", values=row["values"],
            bytes_per_value=row["bytes_per_value"], library=row["library"],
            call_ms=row["call_ms"], recipe_launches=recipe_launches[name],
            to_static_launches={
                "train": d2s["train"][name],
                "jit_load": d2s["jit_load"][name],
                "static_amp": amp_launches[name]}))
    # the deployment path (phase 4p): each counted run's launches
    for row in kernels:
        row["deploy_launches"] = {run: c[row["name"]]
                                  for run, c in deploy_launches.items()}
    # the speculative path and the SLO engine (phase 4q): each leg's
    for row in kernels:
        row["speculative_launches"] = {leg: c[row["name"]]
                                       for leg, c in spec_launches.items()}
    _p(json.dumps({"kernels": kernels}))
    _p(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": count}}))


if __name__ == "__main__":
    main()
