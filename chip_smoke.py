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
and metrics export), the PaddleBox CTR tier's join tower through
BoxPS, the quantization tier (QAT of static BERT-base, frozen and
served; PTQ; the dygraph QAT), and the fused inference tier (BERT-base in
Paddle Inference's fused ERNIE form, served).

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
4r. the static RNN tier -- after 4k, static programs before 4e's
   tracer.  (a) the PTB LM at Zaremba's "large" width (phase 4l's PTB
   constants, 66,034,000 parameters) as a static program: embedding,
   dropout 0.65, ``fluid.layers.lstm`` (the ``cudnn_lstm`` op on
   cuDNN's RNN kernels), dropout, fc, the mean per-token
   ``softmax_with_cross_entropy``, SGD over 4l's piecewise decay with
   the global-norm clip, LastH and LastC fed back as the next step's
   state; PTB_WARMUP steps, PTB_STEPS timed with STATIC_PTB_LAUNCHES a
   step and every other counted kernel at 0, profiled: cuDNN's cell
   kernels a step (two forwards, the op's and generic_grad's vjp's),
   its LSTM backward kernels, no TF32 kernel, the weight copies; card
   against host at PTB_HOST, dropout live, states fed back: losses to
   rtol 1e-4, first-step gradient cosine to 1e-4 and norm to 1e-3, a
   twin with each layer's i and f gate blocks of W swapped must miss;
   the tape's gradient against ``torch.func.vjp``'s at full width (a
   twin without LastC's cotangent must miss); two 3-step runs from one
   state bit for bit (a twin with another program seed must differ).
   (b) the book's ``stacked_lstm_net`` (emb 128, hid 512, 3 stacked
   ``dynamic_lstm`` of alternating direction, max-pooled, fc 2,
   Adagrad 0.002) at batch 128 of 100 ids: timed, profiled, no counted
   launch; card against host at 16 rows, a twin whose ``lstm`` op never
   reverses must miss.  (c) ``dynamic_decode(BeamSearchDecoder)`` over
   two ``LSTMCell(512)``, vocabulary 7,709, beam 10, batch 128, up to 64
   steps under the tracer: steps, ms a step, tokens/s; 4 rows on the
   card and on the host: every token equal, the smallest margin at the
   beam's edge printed, a twin that does not reorder the beams' states
   must differ.  (d) ``lstm``, ``lstmp``, ``gru``, ``gru_unit``,
   ``row_conv``, ``conv_shift``, ``beam_search``, ``gather_tree`` and
   ``beam_search_decode`` once each on the card against the host, and
   ``sampling_id``'s contract.
4u. the detection tier -- static programs before 4e's tracer.  (a)
   MobileNet-SSD (PaddleCV ``ssd``: MobileNet v1 to conv13, the four
   extra blocks, 3x3 heads over six maps, 1,917 priors) at 64 of 3 x
   300², 21 classes: ``ssd_loss`` once an image, summed, RMSProp over a
   piecewise decay with L2Decay; 8 images served through
   ``detection_output`` from the startup state, profiled; SEQ_TIMED
   steps timed and profiled with every counted kernel at 0; card against
   host at SSD_HOST (loss, gradients, detections past a score margin)
   with a twin whose priors put the max size first; two full-width steps
   bit for bit.  (b) YOLOv3 DarkNet-53 (PaddleDetection
   ``yolov3_darknet``) at 8 of 608², 80 classes, one ``yolov3_loss`` a
   scale, Momentum: the same, YOLO_SERVE images served through
   ``yolo_box`` on each scale and ``matrix_nms``, the twin reading its
   anchor masks reversed.  (c)
   the tier's 34 op types on the card, each timed, against the host
   forward and through ``generic_grad`` at Faster R-CNN R50-FPN's,
   R-FCN's, (a)'s and (b)'s shapes; the gathering ops' gradients twice
   bit for bit; ``multiclass_nms`` and ``multiclass_nms2`` raise.
4v. the PaddleBox CTR tier -- a static program before 4e's tracer.  (a)
   A join tower at BASELINE.md config 5's width (26 slots of 5 ids, dim
   16, 13 dense features, batch 4096; ids Zipf(1.1) over 1e6 values a
   slot, placed at slot * 2^32 + id) through ``pull_box_sparse``,
   ``contrib.layers.fused_seqpool_cvm``, ``data_norm``,
   ``cross_norm_layer_hadamard``, ``batch_fc``, ``rank_attention``,
   ``scaled_fc``, fc 256 and 128, the sigmoid cross-entropy weighed by
   ``filter_by_instag``, ``auc`` and ``ctr_metric_bundle``, Adam through
   ``BuildStrategy(fuse_optimizer=True)``: one ``begin_pass`` over the
   JOIN["warmup"] + JOIN["steps"] training and JOIN["eval_batches"]
   held-out batches (the pass must fit phase 4k's 2^22-row cache), the
   timed steps with one ``fused_adam`` launch a step and no other, the
   loss falling and finite, a profiled step, peak memory; two full-width
   steps from one state bit for bit; ``end_pass``'s host rows equal to
   the trained cache; ``fused_adam`` on the step's bucket (the cache
   among its 17 parameters) ``torch.equal`` to its plain version.  (b)
   ``main.clone(for_test=True)`` over the held-out batches: data_norm's
   statistics unchanged, the AUC histograms grown by their rows, the AUC
   and the bundle printed.  (c) The tier's other op types on the card
   against the host within 1e-4 of each output's largest |value|,
   forward and ``generic_grad``, each timed: ``hash`` over 2^40 ids,
   ``pyramid_hash``, ``rank_attention``, ``tdm_child`` over a tree of 2^17
   leaves, ``merge_ids``, ``ps_lookup_rows``, the fused pools,
   ``partial_concat``/``partial_sum``, ``cvm``, ``scaled_int8fc`` at
   [4096, 1293] x [1293, 512], ``pull_box_extended_sparse`` with ``W``
   fed; the three gathering ops' gradients bit for bit in two card runs;
   ``tdm_sampler`` and ``shuffle_batch`` held to their contracts.  (d)
   JOIN_HOST (4 slots, dim 8, batch 256, 3 steps, ids from 2048 values)
   on the card and on the host from one box state and one scope: losses,
   the first step's gradient cosine and norm, data_norm's statistics and
   the AUC within JOIN_HOST_RTOL; a twin reading rank_offset's pairs
   swapped must miss by 10 times or more on some criterion, and those it
   misses by that much are printed.
4w. the quantization tier -- static programs before 4e's tracer (the
   dygraph leg under its own guard).  (a) static BERT-base at QAT's width
   (phase 4b's, dropout 0.1) built forward only by ``qat_bert_program``,
   then ``contrib.slim.quantization.quant_aware``, then Adam, through
   ``BuildStrategy(kernel_tier=True)``: the op types (a fake
   quant-dequant before every activation and weight, no fused attention,
   one ``fused_adam``), QAT_WARMUP and TRAIN_STEPS timed steps of
   TRAIN_ROWS with exactly 2 ``pt_dropout`` and 1 mask a layer and one
   ``fused_adam`` a step, a profiled step, two full-width steps from one
   state bit for bit, ``fused_adam`` on the bucket against its plain
   version.  (b) ``convert`` of ``main.clone(for_test=True)``, frozen
   and fused for serving, ``save_inference_model``, ``AnalysisPredictor``
   at 1, 8 and 32 rows: 12 flash launches a run, the logits equal to the
   frozen program's bit for bit; the QAT test program at 24 bits within
   1e-4 of them, at 8 bits farther.  (c) PTQ of the float program under
   abs_max and the histogram, card against host.  (d)
   ``ImperativeQuantAware().quantize(LeNet())`` trained 5 steps: only the
   last layer's bias moves (the reference's quirk); a forward's host
   ms in train mode (a host read an observer) and in eval mode;
   ``save_quantized_model`` and ``jit.load`` bit for bit.  (e) the
   slice's 35 op types at BERT-base's shapes against the host, forward
   and ``generic_grad``, each timed.  (f) QAT_HOST, 3 steps card against
   host (losses, gradient cosine and norm, scales), a 7-bit activation
   twin must miss by 10 times or more.
4x. the fused inference tier -- static programs before 4e's tracer (the
   eager model under its own guard).  (a) BertModel-base (4o (d)'s model:
   vocab 30522, hidden 768, 12 layers, 12 heads, FFN 3072, seq 128) made
   on the card from the seed, its ``state_dict`` packed into
   ``ernie_fused_program``, Paddle Inference's fused ERNIE form
   (``fused_embedding_eltwise_layernorm``, then a layer: ``fc`` to the
   packed QKV, ``multihead_matmul`` through the flash kernel, ``fc``,
   ``skip_layernorm``, ``fc`` and ``gelu``,
   ``fused_fc_elementwise_layernorm``; the pooler's ``fc`` with
   ``tanh``), ``save_inference_model``, ``load_inference_model`` into a
   fresh scope and ``AnalysisPredictor`` with ir_optim on at 1, 8 and 32
   rows: exactly 12 ``flash_attention_fwd`` launches a run and no other
   counted kernel, sequence and pooled outputs within 1e-4 of the largest
   |value| of the eager forward's (``input_mask`` in {9999, 10000}, a
   bias of -1e4 and 0); the twin with Q and K swapped in every packed
   weight must miss by 10 times or more; each batch's run profiled.  (b)
   the slice's 35 op types at their users' shapes (ResNet-50's [128, 256,
   56, 56], the PTB width, MobileNet-SSD's loc heads, BERT-base's 32 x
   128) against the host, forward and ``generic_grad``, each timed;
   ``multihead_matmul`` launches the flash kernel once on the packed
   QKV's strided views with no copy, ``py_func`` copies its input to the
   host and its output back.
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
   ``speculative_launches`` those of each of phase 4q's legs,
   ``ctr_tier_launches`` those of 4v (a)'s timed steps,
   ``qat_launches`` those of 4w (a)'s timed steps and
   ``qat_serve_launches`` those of each of 4w (b)'s predictor runs,
   ``fused_serve_launches`` those of each of 4x (a)'s predictor runs, and
   the rows ``fused_adam_master`` and ``fused_momentum_master``, launched by
   4n (c)), then the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import importlib
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
HAPI_NMT_WARMUP, HAPI_NMT_STEPS, HAPI_NMT_LR = 3, 10, 1e-4
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


def phase_profile_dygraph(step, card, iters=2):
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


def phase_profile_resnet(trained, card, iters=1):
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


def phase_profile_nmt(step, card, iters=2):
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


def phase_profile_mobilenet(trained, card, iters=1):
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


def phase_profile_decode(served, card, iters=10):
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


def phase_profile_lenet(setups, card, iters=10):
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


_CLASSES = (("elemwisernncell", "RNN cell (cuDNN)"),
            ("lstm_elementwise", "LSTM backward cell (cuDNN)"),
            ("paged_attention", "paged_attention (csrc)"),
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
# the last ``_profile`` window's kernel launches that have no device
# record
PROFILE_LOST = {"launches": 0}
# the calls of the CUDA runtime and of libcuda that launch a kernel, as
# the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
# seconds the card stays idle between a profiler session's throwaway
# kernels and the window it measures
PROFILE_MARGIN_S = 0.1


def _open_window():
    """Inside a new profiler session, before the work it measures.  Late
    in this script's process the profiler kept no device record of a
    session's first 4 to 5 ms of work, however long the session and
    however long the card had idled in it first: a window of static PTB
    steps lost 23 of its first launches and copies, one cuDNN cell kernel
    among them, whether it held 1, 3 or 6 steps.  So a session starts
    with throwaway kernels (64 short ones, then one of about 20 ms), the
    card idles, and the window is what starts after.  Returns the
    window's start, in ns since the epoch, the profiler's clock."""
    import torch

    torch.cuda.synchronize()
    for _ in range(64):
        torch.cuda._sleep(1000)
    torch.cuda._sleep(40_000_000)
    torch.cuda.synchronize()
    time.sleep(PROFILE_MARGIN_S)
    return time.time_ns()


def _window_kernels(prof, start_ns):
    """A session's device events from ``_open_window``'s start on, and the
    kernel launches from then on that have no device record."""
    from torch.autograd import DeviceType

    trace_ns = prof.profiler.kineto_results.trace_start_ns()
    cut_us = (start_ns - trace_ns) / 1e3 - PROFILE_MARGIN_S / 2 * 1e6
    events = [e for e in prof.events() if e.time_range.start >= cut_us]
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    ids = {e.id for e in kern}
    lost = sum(e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS
               and e.id not in ids for e in events)
    return kern, lost


def _profile(fn, iters, warmup=3, host_ops=True):
    """(host ms per call with no profiler attached, device busy ms per
    call, profiled idle share, kernels per call, device ms per call by
    kernel class) over ``iters`` calls after ``warmup`` warm-up calls;
    the window's kernels by name are left in PROFILE_BY_NAME.  Without
    ``host_ops`` the profiler records the card's activity and the launch
    calls but not the host's ops: gathering a step of 40,000 kernels
    then takes seconds instead of about half a minute."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    acts = [torch.profiler.ProfilerActivity.CUDA] + (
        [torch.profiler.ProfilerActivity.CPU] if host_ops else [])
    # now and then a profiled window comes back with no device events at
    # all (seen on the card in phase 3e's timings, once twice in a row);
    # such a window is measured again, up to four times, and a fifth
    # empty one fails the run
    for attempt in range(5):
        with torch.profiler.profile(activities=acts) as prof:
            start_ns = _open_window()
            w0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - w0) * 1e6
        kern, PROFILE_LOST["launches"] = _window_kernels(prof, start_ns)
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

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        start_ns = _open_window()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in _window_kernels(prof, start_ns)[0]:
        name = re.search(r"flash_bwd_(\w+?)_kernel", e.name)
        if name:
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


def phase_profile(served, trained, card, iters=10, train_iters=2):
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
    _p(f"BoxPS CTR kernel-tier leg's kernels on its own inputs: "
       f"embedding_pool_fwd over {len(pools)} slots' [{BOX_TIER_BATCH}, 5] "
       f"ids into their trained tables, max |err| vs plain {fwd_err:.3e} "
       f"(rtol=atol=1e-6); embedding_pool_grad torch.equal to the host's "
       f"index_add_ = {grad_equal} (max |err| {grad_err:.3e})  [{card}]")
    if not fwd_ok:
        raise SystemExit("chip_smoke: embedding_pool_fwd disagrees with its "
                         "plain version on the kernel-tier CTR leg's inputs")
    if not grad_equal:
        raise SystemExit("chip_smoke: embedding_pool_grad disagrees with "
                         "the host on the kernel-tier CTR leg's inputs")
    adam_err = _adam_bucket_check(main, scope, gen,
                                  "the kernel-tier CTR leg", card)
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


def phase_profile_ctr(served, trained, card, iters=10, train_iters=2):
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
    # the module: fluid.layers.rnn is also the name of the rnn() builder
    rnn = importlib.import_module("paddle_tpu_torch.fluid.layers.rnn")

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


def _margins(got, want, cos_tol=1e-4):
    """Each card-vs-host check's error over its tolerance (under 1
    passes): every step's loss to rtol 1e-4, the whole first-step
    gradient's cosine to ``cos_tol`` of 1 and its norm to 1e-3."""
    cos, norm = _cosine(got["grads"], want["grads"])
    out = {f"loss {i}": abs(g - w) / abs(w) / 1e-4
           for i, (g, w) in enumerate(zip(got["losses"], want["losses"]))}
    out.update({"gradient cosine": (1 - cos) / cos_tol,
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
    # the module: fluid.layers.rnn is also the name of the rnn() builder
    rnn = importlib.import_module("paddle_tpu_torch.fluid.layers.rnn")

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


# ---------------------------------------------------------------------------
# phase 4r: the static RNN tier -- the PTB LM through fluid.layers.lstm
# (cudnn_lstm on cuDNN), the book's stacked dynamic_lstm net, and beam
# search over a two-LSTMCell stack
# ---------------------------------------------------------------------------
# counted launches a static PTB step: each of the two training dropout ops
# launches its mask and its dropout, and its backward (the op's custom
# grad) the dropout again from the same seed
STATIC_PTB_LAUNCHES = {"fused_dropout": 4, "dropout_mask": 2}
# cuDNN's RNN kernels by name: the forward cell (one a step a layer, in the
# forward op and again in generic_grad's vjp) and the backward's
CUDNN_RNN_FWD, CUDNN_RNN_BWD = "elemWiseRNNcell", "LSTM_elementWise_bp"
# the book's stacked_lstm_net (test_understand_sentiment.py) at its
# widths; the dictionary is the data's, here 5,000 ids from the seed
BOOK = dict(vocab=5000, emb=128, hid=512, stacked=3, classes=2, lr=0.002)
BOOK_BATCH, BOOK_WORDS, BOOK_STEPS = 128, 100, 10
BOOK_HOST_BATCH, BOOK_HOST_STEPS = 16, 3
# the first step's gradient cosine, card against host: max-pooling over
# 100 steps sends each feature's gradient to one step, and a maximum
# whose top two values lie within float32 rounding (1 of the 8,192 at
# BOOK_HOST_BATCH, the card's values 6e-8 off the host's) picks another
# step on the card, which moves 1 - cosine by about 1e-4 (with average
# pooling every gradient agrees within 1e-4 relative); the twin misses
# this by about 200 times, the losses' rtol 1e-4 by 4 to 6
BOOK_GRAD_COS_TOL = 1e-3
# PaddleNLP's seq2seq at its base width (IWSLT'15 en-vi, no attention)
SEQ2SEQ = dict(hidden=512, vocab=7709, beam=10, batch=128, max_step=64,
               start=0, end=1, gain=30.0)
SEQ2SEQ_HOST_BATCH = 16
# two scores closer than this may swap under float32 rounding between
# the card and the host (about 10x the drift 64 steps of sums can gather)
BEAM_SCORE_TOL = 1e-3
# the final beam scores of a row whose tokens agree: card against host
BEAM_SCORE_RTOL = 1e-4
RNN_CARD_TOL = 1e-5      # (d): of each output's largest |value|


def _static_ptb_program(fluid, cfg, batch, init, rate):
    """Phase 4r (a)'s program: embedding, dropout (``upscale_in_train``),
    time major, ``layers.lstm`` (the ``cudnn_lstm`` op), dropout, fc to the
    vocabulary, the mean per-token ``softmax_with_cross_entropy``, SGD
    over 4l's piecewise decay with the global-norm clip.  Returns (loss,
    last_h, last_c, params_grads)."""
    L = fluid.layers
    h, v, n = cfg["hidden_size"], cfg["vocab_size"], cfg["num_layers"]
    ids = fluid.data("ids", [batch, PTB_T], "int64")
    lbl = fluid.data("lbl", [batch, PTB_T], "int64")
    h0 = fluid.data("init_h", [n, batch, h])
    c0 = fluid.data("init_c", [n, batch, h])
    uni = fluid.initializer.UniformInitializer(-init, init)
    attr = fluid.ParamAttr(initializer=uni)
    emb = L.dropout(L.embedding(ids, [v, h], param_attr=attr), rate,
                    dropout_implementation="upscale_in_train")
    out, last_h, last_c = L.lstm(L.transpose(emb, [1, 0, 2]), h0, c0,
                                 PTB_T, h, n, default_initializer=uni)
    out = L.dropout(L.transpose(out, [1, 0, 2]), rate,
                    dropout_implementation="upscale_in_train")
    logits = L.fc(out, v, num_flatten_dims=2, param_attr=attr,
                  bias_attr=fluid.ParamAttr(initializer=uni))
    loss = L.mean(L.softmax_with_cross_entropy(
        L.reshape(logits, [-1, v]), L.reshape(lbl, [-1, 1])))
    opt = fluid.optimizer.SGD(
        learning_rate=L.piecewise_decay(PTB_LR_BOUNDS, PTB_LR_VALUES),
        grad_clip=fluid.clip.GradientClipByGlobalNorm(PTB_CLIP))
    _, pg = opt.minimize(loss)
    return loss, last_h, last_c, pg


def _ptb_runner(main, fetch, exe, scope, ids, lbl, state):
    """One static PTB step a call: feeds the ids, the labels and the last
    step's states (kept on the executor's device), returns the fetches
    (the loss first, on the host) with the states left on the device."""
    def step():
        outs = exe.run(main, feed={"ids": ids, "lbl": lbl,
                                   "init_h": state[0], "init_c": state[1]},
                       fetch_list=fetch, scope=scope, return_numpy=False)
        state[0], state[1] = outs[1], outs[2]
        return [float(outs[0])] + outs[3:]
    return step


def _gates_if_swapped(init, w_name, cfg):
    """``init`` with each layer's i and f gate blocks of the flat ``W``
    (wi, wh, bi, bh) in each other's places: a broken twin."""
    h, n = cfg["hidden_size"], cfg["num_layers"]
    w, out, off = init[w_name], [], 0
    for layer in range(n):
        for rows in (h, h, 1, 1):
            cols = h if rows == h else 1
            size = 4 * h * cols
            blocks = w[off:off + size].reshape(4, h * cols)
            out.append(blocks[[1, 0, 2, 3]].reshape(-1))
            off += size
    return dict(init, **{w_name: np.concatenate(out)})


def _static_ptb_run(place, init, main, fetches, steps, batch, vocab, seed):
    """``steps`` static PTB steps on ``place`` from ``init``: each loss,
    the first step's gradients, and the persistables after."""
    import torch
    from paddle_tpu_torch import fluid, interop

    loss, last_h, last_c, pg = fetches
    device = place.torch_device()
    scope = interop.scope_from_numpy(init, fluid.Scope(), place)
    exe = fluid.Executor(place)
    ids, lbl = _ptb_ids(batch, vocab, device, seed)
    shape = last_h.shape
    state = [torch.zeros(shape, device=device),
             torch.zeros(shape, device=device)]
    step = _ptb_runner(main, [loss, last_h, last_c] + [g for _, g in pg],
                       exe, scope, ids, lbl, state)
    losses, grads = [], None
    for _ in range(steps):
        out = step()
        losses.append(out[0])
        if grads is None:
            grads = [_host(g) for g in out[1:]]
    return {"losses": losses, "grads": grads,
            "state": interop.scope_to_numpy(scope, list(init))}


def _static_ptb_card_vs_host(card):
    """PTB_HOST on the card and on the host from one state (uniform in
    +-PTB_HOST_INIT), dropout live (the host's plain Philox draws the
    card's masks), the states fed back: _margins over PTB_HOST_STEPS
    steps; a host twin whose flat W holds each layer's i and f gate
    blocks swapped must miss."""
    from paddle_tpu_torch import fluid

    t0 = time.perf_counter()
    main, startup, fetches, _ = _book_program(
        _static_ptb_program, False, cfg=PTB_HOST, batch=PTB_HOST_BATCH,
        init=PTB_HOST_INIT, rate=PTB_HOST["dropout"])
    init = _startup_state(main, startup, fluid.CPUPlace())
    w_name = next(p.name for p in main.global_block().all_parameters()
                  if len(p.shape) == 1 and p.shape[0] > PTB_HOST[
                      "hidden_size"] * 8)
    args = (main, fetches, PTB_HOST_STEPS, PTB_HOST_BATCH,
            PTB_HOST["vocab_size"], SEED + 61)
    card_r = _static_ptb_run(fluid.CUDAPlace(0), init, *args)
    host_r = _static_ptb_run(fluid.CPUPlace(), init, *args)
    twin_r = _static_ptb_run(fluid.CPUPlace(),
                             _gates_if_swapped(init, w_name, PTB_HOST),
                             *args)
    ok, miss = _margins(card_r, host_r), _margins(twin_r, host_r)
    _card_vs_host_report(
        "static ptb", ok, miss,
        f"at vocab {PTB_HOST['vocab_size']}, hidden "
        f"{PTB_HOST['hidden_size']}, {PTB_HOST['num_layers']} layers, "
        f"{PTB_T} steps, batch {PTB_HOST_BATCH}, dropout "
        f"{PTB_HOST['dropout']} live, {PTB_HOST_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s: losses card {card_r['losses']}, "
        f"host {host_r['losses']}, gate-swapped twin {twin_r['losses']}",
        card)
    return ok, miss


def _tape_against_func(card):
    """ROADMAP item 7's condition: the ``cudnn_lstm`` lowering at PTB's
    width on the card, its gradients into the input and the flat W by
    the tape (``torch.autograd.grad``) and by ``torch.func.vjp`` (the
    route ``generic_grad`` and the dygraph tape take) from one random
    cotangent: the largest difference over 1e-6 of each gradient's
    largest |value| (under 1 passes); a twin vjp that drops LastC's
    cotangent must miss."""
    import torch
    from paddle_tpu_torch.ops import rnn_ops

    h, n = PTB["hidden_size"], PTB["num_layers"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 62)

    def u(*shape):
        return (torch.rand(shape, generator=gen, device=DEVICE) * 2 - 1) \
            * PTB_INIT

    size = sum(4 * h * h + 4 * h * h + 8 * h for _ in range(n))
    x, w = u(PTB_T, PTB_BATCH, h), u(size)
    h0, c0 = u(n, PTB_BATCH, h), u(n, PTB_BATCH, h)
    cots = (torch.randn(PTB_T, PTB_BATCH, h, generator=gen, device=DEVICE),
            torch.randn(n, PTB_BATCH, h, generator=gen, device=DEVICE),
            torch.randn(n, PTB_BATCH, h, generator=gen, device=DEVICE))
    attrs = {"num_layers": n, "hidden_size": h}

    def lstm(x, w):
        o = rnn_ops._cudnn_lstm({"Input": [x], "W": [w], "InitH": [h0],
                                 "InitC": [c0]}, attrs, None)
        return o["Out"][0], o["LastH"][0], o["LastC"][0]

    with torch.enable_grad():
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        tape = torch.autograd.grad(lstm(xl, wl), (xl, wl), cots)
    _, vjp = torch.func.vjp(lstm, x, w)
    func = vjp(cots)
    twin = vjp((cots[0], cots[1], torch.zeros_like(cots[2])))

    def err(a, b):
        return max(float((p - q).abs().max()) / (1e-6 * float(q.abs().max()))
                   for p, q in zip(a, b))
    out = {"err": err(func, tape), "twin": err(twin, tape),
           "bits_equal": all(torch.equal(p, q) for p, q in zip(func, tape))}
    _p(f"cudnn_lstm [{PTB_T}, {PTB_BATCH}, {h}] x {n} layers: the tape's "
       f"gradients against torch.func.vjp's, error / 1e-6 of the largest "
       f"|value| (under 1 passes) {out['err']:.3e}, bit for bit "
       f"{out['bits_equal']}; the twin without LastC's cotangent (must "
       f"miss, over 1) {out['twin']:.3e}  [{card}]")
    if out["err"] > 1 or out["twin"] <= 1:
        raise SystemExit("chip_smoke: cudnn_lstm's gradient under "
                         "torch.func disagrees with the tape's, or the "
                         "check cannot see its twin")
    return out


def _cudnn_rnn_counts(iters):
    """From the last ``_profile`` window: cuDNN's RNN cell kernels, its
    LSTM backward kernels and TF32 kernels a call, and the device-to-
    device copies (cuDNN's weight compaction among them) a call, with
    their ms."""
    def per_call(key):
        return sum(c for name, (_, c) in PROFILE_BY_NAME.items()
                   if key in name) / iters
    copies = [(ms, c) for name, (ms, c) in PROFILE_BY_NAME.items()
              if "Memcpy DtoD" in name]
    return {"cell": per_call(CUDNN_RNN_FWD), "bwd": per_call(CUDNN_RNN_BWD),
            "tf32": sum(c for name, (_, c) in PROFILE_BY_NAME.items()
                        if "tf32" in name.lower()) / iters,
            "dtod": sum(c for _, c in copies) / iters,
            "dtod_ms": sum(ms for ms, _ in copies)}


def _static_ptb_leg(card):
    """(a) at PTB's full width: the program built, its startup on the
    card, PTB_WARMUP steps, then PTB_STEPS timed with the counts set to 0
    just before and read just after (STATIC_PTB_LAUNCHES a step, every
    other counted kernel 0), then profiled: cuDNN's kernels a step, no
    TF32 kernel.  Returns (the launches, the numbers)."""
    import torch
    from paddle_tpu_torch import fluid

    t0 = time.perf_counter()
    main, startup, fetches, _ = _book_program(
        _static_ptb_program, False, cfg=PTB, batch=PTB_BATCH, init=PTB_INIT,
        rate=PTB["dropout"])
    n_params = sum(math.prod(p.shape)
                   for p in main.global_block().all_parameters())
    if n_params != PTB_PARAMS:
        raise SystemExit(f"chip_smoke: the static PTB program has "
                         f"{n_params} parameters, not {PTB_PARAMS}")
    place = fluid.CUDAPlace(0)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    loss, last_h, last_c, _ = fetches
    ids, lbl = _ptb_ids(PTB_BATCH, PTB["vocab_size"], DEVICE, SEED + 51)
    state = [torch.zeros(last_h.shape, device=DEVICE),
             torch.zeros(last_h.shape, device=DEVICE)]
    step = _ptb_runner(main, [loss, last_h, last_c], exe, scope, ids, lbl,
                       state)
    ops = [op.type for op in main.global_block().ops]
    _p(f"static ptb: {n_params} parameters, uniform in +-{PTB_INIT}, "
       f"{len(ops)} ops ({ops.count('cudnn_lstm')} cudnn_lstm, "
       f"{ops.count('dropout')} dropout, {ops.count('generic_grad')} "
       f"generic_grad), built and initialised on the card in "
       f"{time.perf_counter() - t0:.1f} s; batch {PTB_BATCH} x {PTB_T}")
    first = step()[0]
    for _ in range(PTB_WARMUP - 1):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = {k: v * PTB_STEPS for k, v in STATIC_PTB_LAUNCHES.items()}
    t = time.perf_counter()
    losses, launches = _counted_run(
        "the static PTB step", lambda: [step()[0] for _ in range(PTB_STEPS)],
        want)
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = PTB_BATCH * PTB_T
    out = {"ms": wall / PTB_STEPS * 1e3, "tokens_s": tokens * PTB_STEPS /
           wall, "peak_gib": peak, "first_loss": first, "losses": losses}
    _p(f"static ptb: {PTB_STEPS} steps in {wall:.3f} s: {out['ms']:.2f} "
       f"ms/step, {out['tokens_s']:.0f} tokens/s (phase 4l's dygraph step "
       f"was recorded at 14,187 tokens/s, 23.2 busy ms), peak memory "
       f"{peak:.2f} GiB; first loss {first:.4f}, losses "
       f"{[round(x, 4) for x in losses]}; launches {launches} (per step "
       f"{STATIC_PTB_LAUNCHES})  [{card}]")
    if not np.isfinite(losses).all() or not losses[-1] < first:
        raise SystemExit("chip_smoke: the static PTB losses are not finite "
                         "or did not fall")
    iters = 3
    prof = _profile(step, iters)
    out["profile"] = prof[:4]
    cudnn = _cudnn_rnn_counts(iters)
    out["cudnn"] = cudnn
    _p(f"profile: static PTB step: host {prof[0]:.3f} ms/step, device "
       f"busy {prof[1]:.3f} ms/step, idle share {prof[2]:.4f}, "
       f"{prof[3]:g} kernels/step; cuDNN RNN cell kernels "
       f"{cudnn['cell']:g}/step, LSTM backward kernels {cudnn['bwd']:g}/"
       f"step, TF32 kernels {cudnn['tf32']:g}/step, device-to-device "
       f"copies {cudnn['dtod']:g}/step ({cudnn['dtod_ms'] / iters:.4f} "
       f"ms/step), kernel launches with no device record "
       f"{PROFILE_LOST['launches']}  [{card}]")
    _print_classes(prof[4], "step")
    _print_top_kernels("step", iters)
    layers = PTB["num_layers"]
    if cudnn["cell"] != 2 * PTB_T * layers or \
            cudnn["bwd"] < PTB_T * layers or cudnn["tf32"]:
        raise SystemExit(
            f"chip_smoke: the static PTB step did not run on cuDNN's RNN "
            f"kernels in float32 as predicted ({2 * PTB_T * layers} cell "
            f"kernels a step, at least {PTB_T * layers} backward ones, no "
            f"TF32): {cudnn}, kernel launches with no device record "
            f"{PROFILE_LOST['launches']}")
    return launches, out, main, startup, fetches


def _static_ptb_determinism(main, startup, fetches, card):
    """Two runs of 3 static PTB steps at full width from one state and
    seeds: losses and every persistable after, bit for bit; a run whose
    program seed differs (other dropout masks) must differ."""
    from paddle_tpu_torch import fluid

    init = _startup_state(main, startup, fluid.CUDAPlace(0))
    args = (main, fetches, 3, PTB_BATCH, PTB["vocab_size"], SEED + 63)
    runs = [_static_ptb_run(fluid.CUDAPlace(0), init, *args)
            for _ in range(2)]
    seed, main.random_seed = main.random_seed, SEED + 1
    twin = _static_ptb_run(fluid.CUDAPlace(0), init, *args)
    main.random_seed = seed

    def differ(a, b):
        return sum(not np.array_equal(a["state"][k], b["state"][k])
                   for k in a["state"]) + sum(
            x != y for x, y in zip(a["losses"], b["losses"]))
    out = {"differ": differ(*runs), "twin_differ": differ(twin, runs[0]),
           "values": len(runs[0]["state"]) + 3}
    _p(f"static ptb determinism: two runs of 3 steps from one state, "
       f"{out['differ']} of {out['values']} persistables and losses differ "
       f"in any bit; the twin with another program seed differs in "
       f"{out['twin_differ']}  [{card}]")
    if out["differ"] or not out["twin_differ"]:
        raise SystemExit("chip_smoke: two static PTB runs from one state "
                         "differ, or the check cannot see its twin")
    return out


def _stacked_lstm_program(fluid, cfg, batch):
    """The book's ``stacked_lstm_net`` over padded rows: embedding, fc,
    ``dynamic_lstm``, then for each further layer an fc over the last (fc,
    lstm) pair and a ``dynamic_lstm`` of the other direction; both max-
    pooled over time into an fc of ``classes``; the mean
    ``softmax_with_cross_entropy`` (``cross_entropy`` is ROADMAP item
    5's); Adagrad.  Returns (loss, params_grads)."""
    L = fluid.layers
    data = fluid.data("words", [batch, BOOK_WORDS], "int64")
    label = fluid.data("label", [batch, 1], "int64")
    emb = L.embedding(data, [cfg["vocab"], cfg["emb"]], is_sparse=True)
    fc1 = L.fc(emb, cfg["hid"], num_flatten_dims=2)
    lstm1, _ = L.dynamic_lstm(fc1, cfg["hid"])
    inputs = [fc1, lstm1]
    for i in range(2, cfg["stacked"] + 1):
        fc = L.fc(inputs, cfg["hid"], num_flatten_dims=2)
        lstm, _ = L.dynamic_lstm(fc, cfg["hid"], is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    pooled = [L.sequence_pool(x, pool_type="max") for x in inputs]
    logits = L.fc(pooled, cfg["classes"])
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    _, pg = fluid.optimizer.AdagradOptimizer(cfg["lr"]).minimize(loss)
    return loss, pg


def _stacked_feed(batch, device, seed):
    import torch
    rng = np.random.RandomState(seed)
    words = rng.randint(0, BOOK["vocab"], (batch, BOOK_WORDS))
    label = rng.randint(0, BOOK["classes"], (batch, 1))
    return {"words": torch.from_numpy(words.astype("int64")).to(device),
            "label": torch.from_numpy(label.astype("int64")).to(device)}


@contextlib.contextmanager
def _lstm_never_reversed():
    """A broken twin: the ``lstm`` op runs every sequence forward,
    whatever ``is_reverse`` asks."""
    from paddle_tpu_torch.ops import rnn_ops

    orig = rnn_ops._time_major, rnn_ops._batch_major
    rnn_ops._time_major = lambda x, reverse: orig[0](x, False)
    rnn_ops._batch_major = lambda steps, reverse: orig[1](steps, False)
    try:
        yield
    finally:
        rnn_ops._time_major, rnn_ops._batch_major = orig


def _stacked_run(place, init, main, fetch, twin=None):
    from paddle_tpu_torch import fluid, interop

    feed = _stacked_feed(BOOK_HOST_BATCH, place.torch_device(), SEED + 65)
    scope = interop.scope_from_numpy(init, fluid.Scope(), place)
    exe = fluid.Executor(place)
    losses, grads = [], None
    with (twin or contextlib.nullcontext)():
        for _ in range(BOOK_HOST_STEPS):
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            losses.append(float(out[0]))
            grads = grads or [np.asarray(g) for g in out[1:]]
    return {"losses": losses, "grads": grads}


def _stacked_leg(card):
    """(b) at the book's width, batch BOOK_BATCH of BOOK_WORDS ids:
    PTB_WARMUP steps, BOOK_STEPS timed with every counted kernel at 0,
    profiled; card against host at BOOK_HOST_BATCH rows from one state
    (_margins, the cosine to BOOK_GRAD_COS_TOL), a host twin whose
    ``lstm`` op never runs in reverse must miss.
    Returns (the launches, the numbers)."""
    import torch
    from paddle_tpu_torch import fluid

    main, startup, (loss, pg), _ = _book_program(
        _stacked_lstm_program, False, cfg=BOOK, batch=BOOK_BATCH)
    n_params = sum(math.prod(p.shape)
                   for p in main.global_block().all_parameters())
    place = fluid.CUDAPlace(0)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = _stacked_feed(BOOK_BATCH, DEVICE, SEED + 64)

    def step():
        return float(exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope)[0])
    t0 = time.perf_counter()
    first = step()
    for _ in range(PTB_WARMUP - 1):
        step()
    t = time.perf_counter()
    losses, launches = _counted_run(
        "the stacked LSTM step", lambda: [step() for _ in range(BOOK_STEPS)],
        {})
    wall = time.perf_counter() - t
    out = {"ms": wall / BOOK_STEPS * 1e3,
           "rows_s": BOOK_BATCH * BOOK_STEPS / wall, "first_loss": first,
           "losses": losses}
    # one profiled step: about 22,000 kernels, whose events the profiler
    # takes seconds to gather
    prof = _profile(step, 1)
    out["profile"] = prof[:4]
    _p(f"book stacked_lstm_net ({time.perf_counter() - t0:.1f} s): "
       f"{n_params} parameters, batch {BOOK_BATCH} "
       f"x {BOOK_WORDS} words, {BOOK_STEPS} steps in {wall:.3f} s: "
       f"{out['ms']:.2f} ms/step, {out['rows_s']:.0f} rows/s; host "
       f"{prof[0]:.3f} ms/step, device busy {prof[1]:.3f} ms/step, idle "
       f"share {prof[2]:.4f}, {prof[3]:.0f} kernels/step; first loss "
       f"{first:.4f}, last {losses[-1]:.4f}; launches {launches}  [{card}]")
    _print_classes(prof[4], "step")
    if not np.isfinite(losses).all():
        raise SystemExit("chip_smoke: the stacked LSTM losses are not "
                         "finite")

    # card against host
    t0 = time.perf_counter()
    hmain, hstart, (hloss, hpg), _ = _book_program(
        _stacked_lstm_program, False, cfg=BOOK, batch=BOOK_HOST_BATCH)
    init = _startup_state(hmain, hstart, fluid.CPUPlace())
    fetch = [hloss] + [g for _, g in hpg]
    card_r = _stacked_run(fluid.CUDAPlace(0), init, hmain, fetch)
    host_r = _stacked_run(fluid.CPUPlace(), init, hmain, fetch)
    twin_r = _stacked_run(fluid.CPUPlace(), init, hmain, fetch,
                       twin=_lstm_never_reversed)
    ok, miss = (_margins(card_r, host_r, BOOK_GRAD_COS_TOL),
                _margins(twin_r, host_r, BOOK_GRAD_COS_TOL))
    rel = sorted(((float(np.linalg.norm(a - b) / max(np.linalg.norm(b),
                                                      1e-30)), p.name)
                  for (p, _), a, b in zip(hpg, card_r["grads"],
                                          host_r["grads"])), reverse=True)
    _card_vs_host_report(
        "book stacked_lstm_net", ok, miss,
        f"at batch {BOOK_HOST_BATCH}, full width, {BOOK_HOST_STEPS} Adagrad "
        f"steps in {time.perf_counter() - t0:.1f} s: losses card "
        f"{card_r['losses']}, host {host_r['losses']}, never-reversed twin "
        f"{twin_r['losses']}; the first step's gradients, largest relative "
        f"L2 errors {[(n, f'{e:.2e}') for e, n in rel[:4]]}", card)
    out["card_vs_host"] = (ok, miss)
    return launches, out


class _CellStack:
    """The seq2seq decoder's two ``LSTMCell``s, one over the other;
    states [h0, c0, h1, c1]."""

    def __init__(self, L, hidden):
        self.cells = [L.LSTMCell(hidden), L.LSTMCell(hidden)]

    def __call__(self, x, states):
        new = []
        for i, cell in enumerate(self.cells):
            x, (h, c) = cell(x, states[2 * i:2 * i + 2])
            new += [h, c]
        return x, new


def _beam_decode(place, rows, params=None, twin=None, margins=None):
    """``dynamic_decode(BeamSearchDecoder(...))`` under the tracer on
    ``place``: SEQ2SEQ's stack, its embedding and output weights and the
    first ``rows`` initial states from the seed (the cells' parameters
    from ``params`` when given, else made by the tracer and returned).
    ``margins``, a list, gets each step's smallest gap between
    neighbouring scores among the top beam + 1 candidates, a row each.
    Returns (ids [rows, steps, beam], the final scores [rows, beam],
    steps, seconds, the cells' parameters)."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as dybase
    from paddle_tpu_torch.fluid.framework import _dygraph_tracer

    cfg = SEQ2SEQ
    h, v = cfg["hidden"], cfg["vocab"]
    rng = np.random.RandomState(SEED + 66)
    emb = rng.uniform(-0.1, 0.1, (v, h)).astype("float32")
    proj = rng.uniform(-1, 1, (h, v)).astype("float32") * cfg["gain"] \
        / np.sqrt(h)
    states = [rng.uniform(-0.5, 0.5, (cfg["batch"], h)).astype("float32")[
        :rows] for _ in range(4)]
    nn_mod = importlib.import_module("paddle_tpu_torch.fluid.layers.nn")
    topk = nn_mod.topk

    def topk_with_margin(x, k, name=None):
        vals = topk(x, k + 1)[0].numpy()
        margins.append((vals[:, :-1] - vals[:, 1:]).min(axis=1))
        return topk(x, k)

    with dybase.guard(place):
        L = fluid.layers
        tracer = _dygraph_tracer()
        tracer._seed, tracer._seed_ctr = SEED + 67, 0
        emb_w, proj_w = dybase.to_variable(emb), dybase.to_variable(proj)
        cell = _CellStack(L, h)
        for c in cell.cells:
            c._params(h)
        if params is None:
            params = [(c._w.numpy(), c._b.numpy()) for c in cell.cells]
        else:
            for c, (w, b) in zip(cell.cells, params):
                c._w.set_value(w)
                c._b.set_value(b)
        dec = L.BeamSearchDecoder(
            cell, cfg["start"], cfg["end"], cfg["beam"],
            embedding_fn=lambda ids: L.gather(emb_w, ids),
            output_fn=lambda o: L.matmul(o, proj_w))
        inits = [dybase.to_variable(s) for s in states]
        if margins is not None:
            nn_mod.topk = topk_with_margin
        try:
            with dybase.no_grad(), (twin or contextlib.nullcontext)():
                if place.torch_device().type == "cuda":
                    torch.cuda.synchronize()
                t = time.perf_counter()
                (_, ids), (_, scores, _), steps = L.dynamic_decode(
                    dec, inits, max_step_num=cfg["max_step"])
                ids = ids.numpy()
                secs = time.perf_counter() - t
        finally:
            nn_mod.topk = topk
    return ids, scores.numpy().reshape(rows, -1), steps, secs, params


@contextlib.contextmanager
def _beams_not_reordered():
    """A broken twin: each beam keeps its own states, whatever parent its
    new token came from."""
    rnn = importlib.import_module("paddle_tpu_torch.fluid.layers.rnn")
    orig = rnn.BeamSearchDecoder._reorder
    rnn.BeamSearchDecoder._reorder = staticmethod(lambda states, idx: states)
    try:
        yield
    finally:
        rnn.BeamSearchDecoder._reorder = orig


def _beam_misses(got, want, margins):
    """(rows equal, rows whose first differing step is a near tie on the
    host, rows whose first differing step is not): a near tie is a step
    where two of the row's top beam + 1 scores lie within
    BEAM_SCORE_TOL, where float32 rounding can swap tokens."""
    equal = excused = missed = 0
    for r in range(want.shape[0]):
        steps = min(got.shape[1], want.shape[1])
        diff = np.flatnonzero((got[r, :steps] != want[r, :steps]).any(-1))
        first = diff[0] if diff.size else (
            None if got.shape[1] == want.shape[1] else steps)
        if first is None:
            equal += 1
        elif first < len(margins) and margins[first][r] < BEAM_SCORE_TOL:
            excused += 1
        else:
            missed += 1
    return equal, excused, missed


def _beam_leg(card):
    """(c) beam search at SEQ2SEQ's width on the card under the tracer,
    every counted kernel at 0: steps, ms a step, tokens/s; then the first
    SEQ2SEQ_HOST_BATCH rows on the card and on the host from the same
    parameters: every row's tokens equal up to its first near tie
    (_beam_misses), the near ties counted, and the final scores of the
    rows whose tokens agree within BEAM_SCORE_RTOL; a host twin that does
    not reorder the beams' states must miss both."""
    from paddle_tpu_torch import fluid

    cfg = SEQ2SEQ
    (ids, _, steps, secs, params), launches = _counted_run(
        "beam search", lambda: _beam_decode(fluid.CUDAPlace(0),
                                            cfg["batch"]), {})
    out = {"steps": steps, "ms_step": secs / steps * 1e3,
           "tokens_s": cfg["batch"] * steps / secs,
           "beam_tokens_s": cfg["batch"] * cfg["beam"] * steps / secs,
           "ids_shape": list(ids.shape)}
    _p(f"beam search: dynamic_decode(BeamSearchDecoder) over two "
       f"LSTMCell({cfg['hidden']}), vocab {cfg['vocab']}, beam "
       f"{cfg['beam']}, batch {cfg['batch']}: {steps} steps in {secs:.3f} "
       f"s, {out['ms_step']:.2f} ms/step, {out['tokens_s']:.0f} tokens/s "
       f"({out['beam_tokens_s']:.0f} beam tokens/s); ids {ids.shape}; "
       f"launches {launches}  [{card}]")
    rows = SEQ2SEQ_HOST_BATCH
    margins = []
    card_ids, card_sc = _beam_decode(fluid.CUDAPlace(0), rows, params)[:2]
    host_ids, host_sc = _beam_decode(fluid.CPUPlace(), rows, params,
                                     margins=margins)[:2]
    twin_ids, twin_sc = _beam_decode(fluid.CPUPlace(), rows, params,
                                     twin=_beams_not_reordered)[:2]
    card_rows = _beam_misses(card_ids, host_ids, margins)
    twin_rows = _beam_misses(twin_ids, host_ids, margins)

    def score_err(ids, sc):
        same = [r for r in range(rows) if ids.shape == host_ids.shape
                and np.array_equal(ids[r], host_ids[r])] or range(rows)
        return max(float(np.abs(sc[r] - host_sc[r]).max()
                         / (BEAM_SCORE_RTOL * np.abs(host_sc[r]).max()))
                   for r in same)
    out["score_err"], out["twin_score_err"] = (score_err(card_ids, card_sc),
                                               score_err(twin_ids, twin_sc))
    ties = int(sum((m < BEAM_SCORE_TOL).sum() for m in margins))
    smallest = float(min(m.min() for m in margins))
    out.update(card_rows=card_rows, twin_rows=twin_rows, near_ties=ties,
               min_margin=smallest,
               tokens_differ=int((card_ids != host_ids).sum())
               if card_ids.shape == host_ids.shape else None)
    _p(f"beam search card vs host at {rows} rows, {len(margins)} steps: "
       f"rows equal / past a near tie / missed {card_rows} (none may "
       f"miss), {out['tokens_differ']} of {host_ids.size} tokens differ; "
       f"{ties} of {rows * len(margins)} row steps hold a near tie (two of "
       f"the top {SEQ2SEQ['beam'] + 1} scores within {BEAM_SCORE_TOL}), "
       f"the smallest gap {smallest:.3e}; final scores of the rows whose "
       f"tokens agree, error / {BEAM_SCORE_RTOL} of the largest (under 1 "
       f"passes) {out['score_err']:.3e}; the twin that keeps each beam's "
       f"own states: {twin_rows}, scores {out['twin_score_err']:.3e} (must "
       f"miss)  [{card}]")
    if card_rows[2] or not twin_rows[2] or not card_rows[0] \
            or out["score_err"] > 1 or out["twin_score_err"] <= 1:
        raise SystemExit("chip_smoke: beam search on the card disagrees "
                         "with the host, or the check cannot see its twin")
    return launches, out


def _rnn_op_cases():
    """(d): each new op type at a small shape, inputs from a seed."""
    rng = np.random.RandomState(SEED + 68)

    def r(*shape):
        return rng.uniform(-1, 1, shape).astype("float32")
    b, t, h, v, beam = 3, 6, 8, 11, 4
    pre_ids = rng.randint(0, v, (2 * beam, 1)).astype("int64")
    pre_ids[1] = 1
    tree = (rng.randint(0, v, (t, 2, beam)).astype("int64"),
            rng.randint(0, beam, (t, 2, beam)).astype("int64"))
    return {
        "lstm": ({"Input": r(b, t, 4 * h), "Weight": r(h, 4 * h),
                  "Bias": r(1, 7 * h)}, {"is_reverse": True}),
        "lstmp": ({"Input": r(b, t, 4 * h), "Weight": r(5, 4 * h),
                   "ProjWeight": r(h, 5), "Bias": r(1, 4 * h)}, {}),
        "gru": ({"Input": r(b, t, 3 * h), "Weight": r(h, 3 * h),
                 "Bias": r(1, 3 * h), "H0": r(b, h)},
                {"origin_mode": True}),
        "gru_unit": ({"Input": r(b, 3 * h), "HiddenPrev": r(b, h),
                      "Weight": r(h, 3 * h), "Bias": r(1, 3 * h)},
                     {"activation": 3}),
        "row_conv": ({"X": r(b, t, h), "Filter": r(3, h)}, {}),
        "conv_shift": ({"X": r(b, 9), "Y": r(b, 3)}, {}),
        "beam_search": ({"pre_ids": pre_ids, "pre_scores": r(2 * beam, 1),
                         "ids": np.zeros((2 * beam, 1), "int64"),
                         "scores": r(2 * beam, v)},
                        {"beam_size": beam, "end_id": 1}),
        "gather_tree": ({"Ids": tree[0], "Parents": tree[1]}, {}),
        "beam_search_decode": ({"Ids": tree[0], "ParentIdx": tree[1],
                                "Scores": r(t, 2, beam)},
                               {"beam_size": beam, "end_id": 1}),
    }


def _rnn_ops_on_the_card(card):
    """(d) each new op type once on the card against the host: every
    output within RNN_CARD_TOL of its largest |value| (ids equal);
    ``sampling_id`` by its contract: ids in range, a class of probability
    0 never drawn, one-hot rows their class, 20,000 draws' frequencies
    within 6 sigma."""
    import torch
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    worst = {}
    for op, (ins, attrs) in _rnn_op_cases().items():
        outs = [get_op(op).fn(
            {k: [torch.from_numpy(a).to(dev)] for k, a in ins.items()},
            dict(attrs), LoweringContext(device=dev))
            for dev in (DEVICE, "cpu")]
        err = 0.0
        for slot, vals in outs[1].items():
            want, got = _host(vals[0]), _host(outs[0][slot][0])
            if want.dtype.kind == "f":
                err = max(err, float(np.abs(got - want).max()) / (
                    RNN_CARD_TOL * max(float(np.abs(want).max()), 1e-30)))
            elif not np.array_equal(got, want):
                err = float("inf")
        worst[op] = err
    p = torch.tensor([0.5, 0.0, 0.3, 0.2, 0.0], device=DEVICE)
    n = 20000
    ctx = LoweringContext(device=DEVICE, base_seed=SEED)
    ids = _host(get_op("sampling_id").fn({"X": [p.expand(n, 5)]},
                                         {"op_seed": 3}, ctx)["Out"][0])
    freq = np.bincount(ids, minlength=5) / n
    pn = _host(p)
    sigma = np.sqrt(pn * (1 - pn) / n)
    onehot = torch.eye(5, device=DEVICE)[[2, 0, 4]]
    got = _host(get_op("sampling_id").fn({"X": [onehot]}, {"op_seed": 4},
                                         ctx)["Out"][0])
    contract = bool(ids.min() >= 0 and ids.max() < 5
                    and freq[pn == 0].sum() == 0
                    and (np.abs(freq - pn) <= 6 * sigma + 1e-12).all()
                    and list(got) == [2, 0, 4])
    _p(f"new op types on the card against the host, error / "
       f"{RNN_CARD_TOL} of the largest |value| (under 1 passes): "
       + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
       + f"; sampling_id's contract {contract} (frequencies "
       f"{np.round(freq, 4).tolist()})  [{card}]")
    if max(worst.values()) > 1 or not contract:
        raise SystemExit("chip_smoke: a new op type disagrees with the "
                         "host on the card")
    return {"worst": worst, "sampling_id_contract": contract}


def phase_static_rnn(card):
    """Phase 4r, the static RNN tier.  (a) the PTB LM (Zaremba's large
    config, phase 4l's PTB constants, 66,034,000 parameters) as a static
    program through ``fluid.layers.lstm``, the ``cudnn_lstm`` op on
    cuDNN: timed, profiled (cuDNN's cell kernels a step, no TF32 kernel,
    the weight copies), card against host at PTB_HOST with a gate-swapped
    twin, the tape's gradient against ``torch.func``'s, two runs from one
    state bit for bit; (b) the book's ``stacked_lstm_net``, timed,
    profiled, card against host; (c) beam search at PaddleNLP seq2seq's
    base width under the tracer, card against host; (d) the other new op
    types once each.  Returns the counted launches of (a)'s timed steps,
    (b)'s and (c)'s runs, and the numbers."""
    import torch

    t = time.perf_counter()
    launches, ptb, main, startup, fetches = _static_ptb_leg(card)
    ptb["card_vs_host"] = _static_ptb_card_vs_host(card)
    ptb["tape_vs_func"] = _tape_against_func(card)
    ptb["determinism"] = _static_ptb_determinism(main, startup, fetches,
                                                 card)
    del main, startup, fetches
    torch.cuda.empty_cache()
    _p(f"phase 4r (a): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    book_launches, book = _stacked_leg(card)
    _p(f"phase 4r (b): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    beam_launches, beam = _beam_leg(card)
    ops = _rnn_ops_on_the_card(card)
    _p(f"phase 4r (c) and (d): {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    return ({"ptb": launches, "book": book_launches, "beam": beam_launches},
            {"ptb": ptb, "book": book, "beam": beam, "ops": ops})


# ---------------------------------------------------------------------------
# phase 4s: the image layers -- CycleGAN (Zhu et al., ICCV 2017,
# arXiv:1703.10593, appendix 7.2) trained at the paper's 256x256 width
# through the dygraph 2.0 loop, its generator as a static program, and
# every op type of the image layers on the card against the host
# ---------------------------------------------------------------------------
# the paper's ResNet generator (c7s1-64, d128, d256, R256 x 9, u128, u64,
# c7s1-3) and 70x70 PatchGAN (C64-C128-C256-C512) at batch 1 of 256^2
CYCLEGAN = dict(ngf=64, ndf=64, blocks=9, size=256, batch=1)
CYCLEGAN_HOST = dict(ngf=8, ndf=8, blocks=2, size=64, batch=1)
CYCLEGAN_PARAMS = 28_310_408
CYCLEGAN_LAMBDA = 10.0          # the cycle loss's weight; identity 0.5 of it
CYCLEGAN_LR, CYCLEGAN_BETA1 = 2e-4, 0.5
CYCLEGAN_WARMUP, CYCLEGAN_STEPS = 3, 5
CYCLEGAN_HOST_STEPS = 2
CYCLEGAN_LOSSES = ("gan", "cycle", "identity", "discriminator")
IMAGE_CARD_TOL = 1e-4           # (c): of each output's largest |value|


def cyclegan_nets(pd, cfg, conv_t=None):
    """The four CycleGAN networks of ``cfg`` in package ``pd`` (the port,
    or another package of the same API): generators A->B and B->A
    (reflection padding, ``InstanceNorm2D``, ReLU, tanh; each u-k layer a
    3x3 transposed convolution of stride 2 through
    ``F.conv2d_transpose(..., output_padding=1)`` over parameters the
    layer makes, ``conv_t`` in its place when given) and the two 70x70
    PatchGAN discriminators (4x4 kernels, ``InstanceNorm2D`` from C128,
    LeakyReLU 0.2).  Returns (G_A, G_B, D_A, D_B)."""
    nn = pd.nn
    conv_t = conv_t or pd.nn.functional.conv2d_transpose

    class Up(nn.Layer):
        def __init__(self, cin, cout):
            super().__init__()
            self.weight = self.create_parameter([cin, cout, 3, 3])
            self.bias = self.create_parameter([cout], is_bias=True)

        def forward(self, x):
            return conv_t(x, self.weight, self.bias, stride=2, padding=1,
                          output_padding=1)

    class Residual(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.body = nn.Sequential(
                nn.Pad2D(1, mode="reflect"), nn.Conv2D(c, c, 3),
                nn.InstanceNorm2D(c), nn.ReLU(),
                nn.Pad2D(1, mode="reflect"), nn.Conv2D(c, c, 3),
                nn.InstanceNorm2D(c))

        def forward(self, x):
            return x + self.body(x)

    def generator():
        f = cfg["ngf"]
        layers = [nn.Pad2D(3, mode="reflect"), nn.Conv2D(3, f, 7),
                  nn.InstanceNorm2D(f), nn.ReLU()]
        for c in (f, 2 * f):
            layers += [nn.Conv2D(c, 2 * c, 3, stride=2, padding=1),
                       nn.InstanceNorm2D(2 * c), nn.ReLU()]
        layers += [Residual(4 * f) for _ in range(cfg["blocks"])]
        for c in (4 * f, 2 * f):
            layers += [Up(c, c // 2), nn.InstanceNorm2D(c // 2), nn.ReLU()]
        layers += [nn.Pad2D(3, mode="reflect"), nn.Conv2D(f, 3, 7),
                   nn.Tanh()]
        return nn.Sequential(*layers)

    def discriminator():
        f = cfg["ndf"]
        layers = [nn.Conv2D(3, f, 4, stride=2, padding=1), nn.LeakyReLU(0.2)]
        for c, stride in ((f, 2), (2 * f, 2), (4 * f, 1)):
            layers += [nn.Conv2D(c, 2 * c, 4, stride=stride, padding=1),
                       nn.InstanceNorm2D(2 * c), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2D(8 * f, 1, 4, stride=1, padding=1))
        return nn.Sequential(*layers)

    return generator(), generator(), discriminator(), discriminator()


def cyclegan_step(pd, nets, opts, real_a, real_b, grads=None):
    """One CycleGAN training step under ``pd``'s tracer: the generators'
    LSGAN, cycle (CYCLEGAN_LAMBDA) and identity (half that) losses
    through six generator and two discriminator forwards, backward, their
    Adam step; then the discriminators' loss (real against the detached
    fakes, halved), backward, their Adam step.  ``grads``, a list, gets
    the generators' and then the discriminators' gradients as host
    arrays.  Returns the four losses as tensors."""
    g_a, g_b, d_a, d_b = nets
    opt_g, opt_d = opts
    L = pd.fluid.layers
    mse, l1 = pd.nn.MSELoss(), pd.nn.L1Loss()

    def lsgan(pred, target):
        fill = L.ones_like if target else L.zeros_like
        return mse(pred, fill(pred))

    fake_b, fake_a = g_a(real_a), g_b(real_b)
    rec_a, rec_b = g_b(fake_b), g_a(fake_a)
    idt_a, idt_b = g_a(real_b), g_b(real_a)
    gan = lsgan(d_a(fake_b), True) + lsgan(d_b(fake_a), True)
    cycle = (l1(rec_a, real_a) + l1(rec_b, real_b)) * CYCLEGAN_LAMBDA
    idt = (l1(idt_a, real_b) + l1(idt_b, real_a)) * (0.5 * CYCLEGAN_LAMBDA)
    (gan + cycle + idt).backward()
    if grads is not None:
        grads += [np.asarray(p.gradient()) for p in
                  g_a.parameters() + g_b.parameters()]
    opt_g.step()
    opt_g.clear_grad()
    opt_d.clear_grad()
    disc = (lsgan(d_a(real_b), True) + lsgan(d_a(fake_b.detach()), False)
            + lsgan(d_b(real_a), True)
            + lsgan(d_b(fake_a.detach()), False)) * 0.5
    disc.backward()
    if grads is not None:
        grads += [np.asarray(p.gradient()) for p in
                  d_a.parameters() + d_b.parameters()]
    opt_d.step()
    opt_d.clear_grad()
    return gan, cycle, idt, disc


def cyclegan_optimizers(pd, nets):
    g_a, g_b, d_a, d_b = nets
    return tuple(pd.optimizer.Adam(
        learning_rate=CYCLEGAN_LR, beta1=CYCLEGAN_BETA1, parameters=ps)
        for ps in (g_a.parameters() + g_b.parameters(),
                   d_a.parameters() + d_b.parameters()))


def cyclegan_images(cfg, seed):
    """Two images of domains A and B, uniform in [-1, 1] (tanh's range),
    [batch, 3, size, size] from ``seed``."""
    rng = np.random.RandomState(seed)
    shape = (cfg["batch"], 3, cfg["size"], cfg["size"])
    return (rng.uniform(-1, 1, shape).astype("float32"),
            rng.uniform(-1, 1, shape).astype("float32"))


def cyclegan_generator_program(fluid, cfg, conv_t=None, train=True):
    """The generator as a static program: ``fluid.layers.pad2d``
    (reflect), ``conv2d``, ``instance_norm``, ``relu`` and, for each u-k
    layer, ``conv2d_transpose(output_size=...)`` (``conv_t`` in its place
    when given), tanh; the loss the mean |G(A) - B|, with ``train`` Adam
    by ``append_backward``.  Its parameters come in the order of
    ``cyclegan_nets``'s generator's.  Returns (fake, loss,
    params_grads)."""
    L = fluid.layers
    conv_t = conv_t or L.conv2d_transpose
    f, size = cfg["ngf"], cfg["size"]
    real_a = fluid.data("real_a", [cfg["batch"], 3, size, size])
    real_b = fluid.data("real_b", [cfg["batch"], 3, size, size])

    def conv(x, n, k, stride=1, padding=0, reflect=0):
        if reflect:
            x = L.pad2d(x, [reflect] * 4, mode="reflect")
        return L.conv2d(x, n, k, stride=stride, padding=padding)

    x = L.relu(L.instance_norm(conv(real_a, f, 7, reflect=3)))
    for c in (2 * f, 4 * f):
        x = L.relu(L.instance_norm(conv(x, c, 3, 2, 1)))
    for _ in range(cfg["blocks"]):
        y = L.relu(L.instance_norm(conv(x, 4 * f, 3, reflect=1)))
        x = x + L.instance_norm(conv(y, 4 * f, 3, reflect=1))
    for c, side in ((2 * f, size // 2), (f, size)):
        x = L.relu(L.instance_norm(conv_t(
            x, c, output_size=[side, side], filter_size=3, stride=2,
            padding=1)))
    fake = L.tanh(conv(x, 3, 7, reflect=3))
    loss = L.reduce_mean(L.abs(fake - real_b))
    pg = []
    if train:
        _, pg = fluid.optimizer.AdamOptimizer(
            CYCLEGAN_LR, beta1=CYCLEGAN_BETA1).minimize(loss)
    return fake, loss, pg


def _cyclegan_flops(cfg):
    """Multiply-adds times 2 of one generator's and one discriminator's
    convolutions at ``cfg`` (99.1 and 6.3 GFLOP at the paper's width)."""
    f, s = cfg["ngf"], cfg["size"]
    macs = [s * s * f * 3 * 49, (s // 2) ** 2 * 2 * f * f * 9,
            (s // 4) ** 2 * 4 * f * 2 * f * 9]
    macs += [(s // 4) ** 2 * (4 * f) ** 2 * 9] * (2 * cfg["blocks"])
    macs += [(s // 4) ** 2 * 4 * f * 2 * f * 9, (s // 2) ** 2 * 2 * f * f * 9,
             s * s * 3 * f * 49]
    d, side, dmacs = cfg["ndf"], s // 2, [(s // 2) ** 2 * cfg["ndf"] * 48]
    for c, stride in ((d, 2), (2 * d, 2), (4 * d, 1)):
        side = side // stride if stride == 2 else side - 1
        dmacs.append(side * side * 2 * c * c * 16)
    dmacs.append((side - 1) ** 2 * 8 * d * 16)
    return 2 * sum(macs), 2 * sum(dmacs)


def _scalar(v):
    return float(np.asarray(v.numpy()).ravel()[0])


def _cyclegan_state(cfg, seed):
    """The four networks' parameters from ``seed``, made on the host, as
    numpy state dicts."""
    import paddle_tpu_torch as pd
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as dybase

    np.random.seed(seed)
    with dybase.guard(fluid.CPUPlace()):
        return [{k: np.asarray(v) for k, v in n.state_dict().items()}
                for n in cyclegan_nets(pd, cfg)]


def _cyclegan_run(place, cfg, state, steps, seed, twin=None, grads=False):
    """``steps`` CycleGAN steps on ``place`` from ``state`` over the
    images of ``seed``: each step's four losses, with ``grads`` the first
    step's gradients, and the networks' parameters after."""
    import torch
    import paddle_tpu_torch as pd
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.dygraph import base as dybase

    images = cyclegan_images(cfg, seed)
    with dybase.guard(place), (twin or contextlib.nullcontext)():
        device = dybase._dygraph_tracer().device
        nets = cyclegan_nets(pd, cfg)
        for net, s in zip(nets, state):
            interop.layer_from_numpy(net, s)
        opts = cyclegan_optimizers(pd, nets)
        real_a, real_b = [dybase.to_variable(torch.from_numpy(x).to(device))
                          for x in images]
        losses, first = [], []
        for i in range(steps):
            out = cyclegan_step(pd, nets, opts, real_a, real_b,
                                first if grads and i == 0 else None)
            losses += [_scalar(v) for v in out]
        after = [{k: np.asarray(v) for k, v in n.state_dict().items()}
                 for n in nets]
    return {"losses": losses, "grads": first, "state": after}


@contextlib.contextmanager
def _reflect_as_edge():
    """A broken twin: reflection padding repeats the edge instead."""
    from paddle_tpu_torch.ops import manipulation

    orig = manipulation._pad_axis
    manipulation._pad_axis = lambda x, dim, lo, hi, mode: orig(
        x, dim, lo, hi, "edge" if mode == "reflect" else mode)
    try:
        yield
    finally:
        manipulation._pad_axis = orig


@contextlib.contextmanager
def _extra_row_low():
    """A broken twin: a transposed convolution's extra output row (its
    ``output_padding`` or ``output_size`` rows) on the low edge."""
    from paddle_tpu_torch.ops import nn_ops

    orig = nn_ops._conv_transpose
    nn_ops._conv_transpose = lambda x, w, s, d, crops, g: orig(
        x, w, s, d, [(hi, lo) for lo, hi in crops], g)
    try:
        yield
    finally:
        nn_ops._conv_transpose = orig


CYCLEGAN_TWINS = (("reflection-as-edge", _reflect_as_edge),
                  ("extra-row-low", _extra_row_low))


def _twins_report(label, run_twin, host_r, card_r, card,
                  twins=CYCLEGAN_TWINS, margins=None):
    """card_r against host_r, each twin's run against host_r: every
    criterion's error over its tolerance (``margins``, by default
    ``_image_margins``); fails unless the card passes and each twin
    misses by 10 times or more on at least one criterion."""
    margins = margins or _image_margins
    ok = margins(card_r, host_r)
    misses = {twin_label: margins(run_twin(twin), host_r)
              for twin_label, twin in twins}
    fmt = ", ".join
    _p(f"{label}: card vs host, error / tolerance (under 1 passes): "
       + fmt(f"{k} {v:.3e}" for k, v in ok.items()) + f"  [{card}]")
    for twin_label, miss in misses.items():
        _p(f"{label}: the {twin_label} twin, error / tolerance (must miss "
           f"by 10 or more): " + fmt(f"{k} {v:.3e}" for k, v in miss.items()))
    if max(ok.values()) > 1:
        raise SystemExit(f"chip_smoke: {label} on the card disagrees with "
                         f"the host")
    if min(max(m.values()) for m in misses.values()) < 10:
        raise SystemExit(f"chip_smoke: a twin of the {label} card-vs-host "
                         f"check misses by less than 10 times")
    return ok, misses


def _image_margins(got, want):
    """``_margins`` (every loss, the first-step gradient's cosine and
    norm) and, where given, the output to 1e-4 of its largest value."""
    out = _margins(got, want)
    if want.get("fake") is not None:
        out["output"] = float(np.abs(got["fake"] - want["fake"]).max()) / (
            1e-4 * float(np.abs(want["fake"]).max()))
    return out


def _cyclegan_leg(card):
    """(a) at CYCLEGAN's width: CYCLEGAN_WARMUP steps, CYCLEGAN_STEPS timed
    with every counted kernel at 0, profiled; card against host at
    CYCLEGAN_HOST with its two twins; two 2-step runs at full width from
    one state bit for bit (a twin with other images must differ).
    Returns (the launches, the numbers, G_A's state and its output on
    the first image of A)."""
    import torch
    import paddle_tpu_torch as pd
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.dygraph import base as dybase

    t0 = time.perf_counter()
    # reproducible training: cuDNN's deterministic algorithms, as the
    # Executor sets them (the tracer leaves torch's defaults), the fastest
    # of them by cuDNN's own search: its heuristic alone picked FFT
    # convolutions here (21,778 kernels and 1,322 ms a step, 98 of its
    # 269 busy ms in complex gemv, on an H100 80GB HBM3 at 700 W)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = True
    init = _cyclegan_state(CYCLEGAN, SEED + 70)
    n_params = sum(v.size for s in init for v in s.values())
    if n_params != CYCLEGAN_PARAMS:
        raise SystemExit(f"chip_smoke: CycleGAN has {n_params} parameters, "
                         f"not {CYCLEGAN_PARAMS}")
    gf, df = _cyclegan_flops(CYCLEGAN)
    step_flops = 3 * (6 * gf + 6 * df)
    with dybase.guard(fluid.CUDAPlace(0)):
        tracer = dybase._dygraph_tracer()
        nets = cyclegan_nets(pd, CYCLEGAN)
        for net, s in zip(nets, init):
            interop.layer_from_numpy(net, s)
        opts = cyclegan_optimizers(pd, nets)
        images = cyclegan_images(CYCLEGAN, SEED + 71)
        real_a, real_b = [dybase.to_variable(
            torch.from_numpy(x).to(tracer.device)) for x in images]

        def step():
            return cyclegan_step(pd, nets, opts, real_a, real_b)
        _p(f"cyclegan: 2 ResNet generators ({CYCLEGAN['blocks']} blocks, ngf "
           f"{CYCLEGAN['ngf']}) and 2 PatchGANs (ndf {CYCLEGAN['ndf']}), "
           f"{n_params} parameters, made on the card in "
           f"{time.perf_counter() - t0:.1f} s; batch {CYCLEGAN['batch']} of "
           f"{CYCLEGAN['size']}^2, float32, TF32 "
           f"{torch.backends.cudnn.allow_tf32}, cuDNN deterministic "
           f"{torch.backends.cudnn.deterministic}, benchmark "
           f"{torch.backends.cudnn.benchmark}; Adam lr {CYCLEGAN_LR}, "
           f"beta1 {CYCLEGAN_BETA1}; {gf / 1e9:.1f} GFLOP a generator "
           f"forward, {df / 1e9:.2f} a discriminator's, about "
           f"{step_flops / 1e12:.2f} TFLOP a step")
        t = time.perf_counter()
        first = [_scalar(v) for v in step()]
        for _ in range(CYCLEGAN_WARMUP - 1):
            step()
        torch.cuda.synchronize()
        _p(f"cyclegan: {CYCLEGAN_WARMUP} warm-up steps in "
           f"{time.perf_counter() - t:.2f} s; first losses "
           f"{dict(zip(CYCLEGAN_LOSSES, first))}")
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out, launches = _counted_run(
            "the CycleGAN step", lambda: [step() for _ in
                                          range(CYCLEGAN_STEPS)], {})
        losses = [[_scalar(v) for v in o] for o in out]
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = wall / CYCLEGAN_STEPS * 1e3
        images_s = 2 * CYCLEGAN["batch"] / ms * 1e3
        res = {"ms": ms, "images_s": images_s, "peak_gib": peak,
               "first": first, "losses": losses, "params": n_params,
               "step_tflop": step_flops / 1e12}
        _p(f"cyclegan: {CYCLEGAN_STEPS} steps in {wall:.3f} s: {ms:.2f} "
           f"ms/step, {images_s:.2f} images/s (one of each domain a "
           f"step), peak memory {peak:.2f} GiB; last losses "
           f"{dict(zip(CYCLEGAN_LOSSES, losses[-1]))}; counted launches "
           f"{launches} (none expected)  [{card}]")
        if not np.isfinite(losses).all() or not losses[-1][1] < first[1]:
            raise SystemExit("chip_smoke: the CycleGAN losses are not "
                             "finite, or the cycle loss did not fall")
        # one profiled step: thousands of kernels, whose events the
        # profiler takes seconds to gather
        iters = 1
        prof = _profile(lambda: step()[3].numpy(), iters)
        res["profile"] = prof[:4]
        _p(f"profile: CycleGAN step: host {prof[0]:.3f} ms/step, device "
           f"busy {prof[1]:.3f} ms/step ({step_flops / 1e9 / prof[1]:.1f} "
           f"TFLOP/s of busy time), idle share {prof[2]:.4f}, "
           f"{prof[3]:g} kernels/step, kernel launches with no device "
           f"record {PROFILE_LOST['launches']}  [{card}]")
        _print_classes(prof[4], "step")
        _print_top_kernels("step", iters)
        g_a = nets[0]
        with dybase.no_grad():
            fake = _host(g_a(real_a).value())
        g_state = {k: np.asarray(v) for k, v in g_a.state_dict().items()}
    del nets, opts
    torch.cuda.empty_cache()

    # card against host at CYCLEGAN_HOST, two steps, two twins
    t = time.perf_counter()
    host_init = _cyclegan_state(CYCLEGAN_HOST, SEED + 72)
    args = (CYCLEGAN_HOST, host_init, CYCLEGAN_HOST_STEPS, SEED + 73)
    card_r = _cyclegan_run(fluid.CUDAPlace(0), *args, grads=True)
    host_r = _cyclegan_run(fluid.CPUPlace(), *args, grads=True)
    res["card_vs_host"] = _twins_report(
        "cyclegan", lambda twin: _cyclegan_run(fluid.CPUPlace(), *args,
                                               twin=twin, grads=True),
        host_r, card_r, card)
    _p(f"cyclegan: card vs host at ngf {CYCLEGAN_HOST['ngf']}, "
       f"{CYCLEGAN_HOST['blocks']} blocks, {CYCLEGAN_HOST['size']}^2, "
       f"{CYCLEGAN_HOST_STEPS} steps in {time.perf_counter() - t:.1f} s: "
       f"losses card {card_r['losses']}, host {host_r['losses']}")

    # determinism at full width
    t = time.perf_counter()
    runs = [_cyclegan_run(fluid.CUDAPlace(0), CYCLEGAN, init, 2, SEED + 74)
            for _ in range(2)]
    twin = _cyclegan_run(fluid.CUDAPlace(0), CYCLEGAN, init, 2, SEED + 75)

    def differ(a, b):
        return sum(not np.array_equal(x[k], y[k])
                   for x, y in zip(a["state"], b["state"]) for k in x) + \
            sum(x != y for x, y in zip(a["losses"], b["losses"]))
    det = {"differ": differ(*runs), "twin_differ": differ(twin, runs[0]),
           "values": sum(len(s) for s in runs[0]["state"])
           + len(runs[0]["losses"])}
    res["determinism"] = det
    _p(f"cyclegan determinism: two runs of 2 steps at full width from one "
       f"state, {det['differ']} of {det['values']} parameters and losses "
       f"differ in any bit; the twin with other images differs in "
       f"{det['twin_differ']} ({time.perf_counter() - t:.1f} s)  [{card}]")
    if det["differ"] or not det["twin_differ"]:
        raise SystemExit("chip_smoke: two CycleGAN runs from one state "
                         "differ, or the check cannot see its twin")
    torch.cuda.empty_cache()
    return launches, res, g_state, (images, fake)


def _generator_program(cfg, train):
    main, startup, (fake, loss, pg), _ = _book_program(
        cyclegan_generator_program, False, cfg=cfg, train=train)
    return main, startup, fake, loss, pg


def _static_generator_leg(g_state, g_out, card):
    """(b): the generator program at CYCLEGAN's width with (a)'s G_A's
    weights (its parameters in creation order), its output against (a)'s
    generator on the same image within 1e-4 of the largest value, then
    one Adam step through ``append_backward`` on the Executor (every
    counted kernel at 0); card against host at CYCLEGAN_HOST over two
    steps with the two twins.  Returns (the launches, the numbers)."""
    import torch
    from paddle_tpu_torch import fluid, interop

    t0 = time.perf_counter()
    images, want = g_out
    place = fluid.CUDAPlace(0)
    out = {}
    for train in (False, True):
        main, startup, fake, loss, pg = _generator_program(CYCLEGAN, train)
        params = main.global_block().all_parameters()
        values = list(g_state.values())
        if [tuple(p.shape) for p in params] != [v.shape for v in values]:
            raise SystemExit("chip_smoke: the generator program's parameters "
                             "are not the dygraph generator's")
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        interop.scope_from_numpy({p.name: v for p, v in zip(params, values)},
                                 scope, place)
        feed = {"real_a": images[0], "real_b": images[1]}
        if not train:
            got = np.asarray(exe.run(main, feed=feed, fetch_list=[fake],
                                     scope=scope)[0])
            out["error"] = float(np.abs(got - want).max()) / (
                1e-4 * float(np.abs(want).max()))
            continue
        ops = [op.type for op in main.global_block().ops]
        torch.cuda.synchronize()
        t = time.perf_counter()
        vals, launches = _counted_run(
            "the static generator step",
            lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope),
            {})
        out["step_ms"] = (time.perf_counter() - t) * 1e3
        out["loss"] = float(np.asarray(vals[0]))
        out["generic_grad"] = ops.count("generic_grad")
        out["ops"] = len(ops)
    _p(f"static generator: {out['ops']} ops ({out['generic_grad']} "
       f"generic_grad, pad2d, conv2d, instance_norm, conv2d_transpose with "
       f"output_size), output against (a)'s generator, error / 1e-4 of the "
       f"largest |value| (under 1 passes) {out['error']:.3e}; one Adam step "
       f"{out['step_ms']:.1f} ms (the first, on the card), loss "
       f"{out['loss']:.5f}; launches {launches} (none expected); "
       f"{time.perf_counter() - t0:.1f} s  [{card}]")
    if out["error"] > 1 or not np.isfinite(out["loss"]) \
            or not out["generic_grad"]:
        raise SystemExit("chip_smoke: the static generator disagrees with "
                         "the dygraph one, or its step failed")

    t = time.perf_counter()
    main, startup, fake, loss, pg = _generator_program(CYCLEGAN_HOST, True)
    init = _startup_state(main, startup, fluid.CPUPlace())
    feeds = [dict(zip(("real_a", "real_b"),
                      cyclegan_images(CYCLEGAN_HOST, SEED + 76)))] * 2
    fetch = [fake, loss] + [g for _, g in pg]

    def run(p, twin=None):
        with (twin or contextlib.nullcontext)():
            outs, _ = _steps(main, main, fetch, init, p, feeds)
        return {"losses": [float(np.asarray(o[1])) for o in outs],
                "grads": [np.asarray(g) for g in outs[0][2:]],
                "fake": np.asarray(outs[0][0])}
    card_r, host_r = run(fluid.CUDAPlace(0)), run(fluid.CPUPlace())
    out["card_vs_host"] = _twins_report(
        "static generator", lambda twin: run(fluid.CPUPlace(), twin), host_r,
        card_r, card)
    _p(f"static generator: card vs host at ngf {CYCLEGAN_HOST['ngf']}, "
       f"{CYCLEGAN_HOST['size']}^2 in {time.perf_counter() - t:.1f} s: "
       f"losses card {card_r['losses']}, host {host_r['losses']}")
    return launches, out


def _image_op_cases():
    """(c): every op type of the image layers at a small shape from a
    seed, the convolutions, pools, pads and interpolations also at a 3-d
    one: {label: (op, inputs, attrs)}."""
    rng = np.random.RandomState(SEED + 77)

    def r(*shape):
        return rng.uniform(-1, 1, shape).astype("float32")
    x4, x5 = r(2, 4, 7, 6), r(1, 4, 5, 6, 4)
    ids = np.array([[1], [3], [0]], "int64")
    cases = {
        "conv2d_transpose": ({"Input": x4, "Filter": r(4, 3, 3, 3)},
                             {"strides": [2, 2], "paddings": [1, 1],
                              "output_padding": [1, 1]}),
        "conv2d_transpose grouped": (
            {"Input": x4, "Filter": r(4, 3, 3, 3)},
            {"strides": [2, 1], "paddings": [1, 0, 2, 1], "groups": 2}),
        "conv3d": ({"Input": x5, "Filter": r(3, 4, 3, 3, 3)},
                   {"paddings": [1, 1, 1], "strides": [2, 1, 1]}),
        "conv3d_transpose": ({"Input": x5, "Filter": r(4, 2, 3, 3, 3)},
                             {"strides": [2, 2, 2], "paddings": [1, 1, 1],
                              "output_padding": [1, 1, 1]}),
        "sync_batch_norm": ({"X": x4, "Scale": r(4), "Bias": r(4),
                             "Mean": r(4), "Variance": r(4) + 2}, {}),
        "instance_norm": ({"X": x4, "Scale": r(4), "Bias": r(4)}, {}),
        "group_norm": ({"X": x5, "Scale": r(4), "Bias": r(4)},
                       {"groups": 2}),
        "norm": ({"X": x4}, {"axis": 1}),
        "nearest_interp": ({"X": x4}, {"out_h": 9, "out_w": 4}),
        "bilinear_interp": ({"X": x4}, {"out_h": 9, "out_w": 4,
                                        "align_mode": 0}),
        "bicubic_interp": ({"X": x4}, {"out_h": 9, "out_w": 4,
                                       "align_corners": True}),
        "trilinear_interp": ({"X": x5}, {"out_d": 7, "out_h": 3,
                                         "out_w": 6}),
        "grid_sampler": ({"X": x4, "Grid": r(2, 3, 5, 2) * 1.2}, {}),
        "affine_channel": ({"X": x4, "Scale": r(4), "Bias": r(4)}, {}),
        "temporal_shift": ({"X": r(6, 4, 3, 3)}, {"seg_num": 3}),
        "pad2d": ({"X": x4}, {"paddings": [3, 1, 2, 5], "mode": "reflect"}),
        "pad3d": ({"X": x5}, {"paddings": [1, 2, 0, 3, 2, 1],
                              "mode": "reflect"}),
        "pixel_shuffle": ({"X": r(2, 8, 3, 3)}, {"upscale_factor": 2}),
        "unfold": ({"X": x4}, {"kernel_sizes": [3, 2], "strides": [2, 1],
                               "paddings": [1, 1, 0, 2]}),
        "bilinear_tensor_product": ({"X": r(3, 4), "Y": r(3, 5),
                                     "Weight": r(2, 4, 5), "Bias": r(1, 2)},
                                    {}),
        "pool3d": ({"X": x5}, {"pooling_type": "max", "ksize": [2, 3, 2],
                               "strides": [1, 2, 2], "paddings": [1, 1, 0]}),
        "pool3d avg": ({"X": x5}, {"pooling_type": "avg", "ksize": [3, 3, 3],
                                   "strides": [2, 1, 1],
                                   "paddings": [1, 1, 1]}),
        "spectral_norm": ({"Weight": r(3, 5, 2), "U": r(3), "V": r(10)},
                          {"power_iters": 2}),
        "teacher_student_sigmoid_loss": (
            {"X": r(4, 1), "Label": np.array([[-0.5], [1.0], [0.0], [-2.0]],
                                             "float32")}, {}),
        "max_pool2d_with_index": ({"X": x4}, {"ksize": [2, 3],
                                              "strides": [2, 2],
                                              "paddings": [1, 1]}),
        "cross_entropy": ({"X": np.abs(r(3, 5)) + 0.1, "Label": ids}, {}),
        "smooth_l1_loss": ({"X": r(3, 4), "Y": r(3, 4)}, {"sigma": 2.0}),
        "hinge_loss": ({"Logits": r(4, 1), "Labels": (r(4, 1) > 0)
                        .astype("float32")}, {}),
        "rank_loss": ({"Label": (r(4, 1) > 0).astype("float32"),
                       "Left": r(4, 1), "Right": r(4, 1)}, {}),
        "margin_rank_loss": ({"Label": np.sign(r(4, 1)), "X1": r(4, 1),
                              "X2": r(4, 1)}, {"margin": 0.2}),
        "bpr_loss": ({"X": r(3, 5), "Label": ids}, {}),
        "affine_grid": ({"Theta": r(2, 2, 3)}, {"output_shape": [2, 3, 4, 5]}),
        "sigmoid_focal_loss": ({"X": r(3, 4), "Label": ids,
                                "FgNum": np.array([2], "int32")}, {}),
        "brelu": ({"X": r(3, 4) * 30}, {"t_min": 1.0, "t_max": 20.0}),
    }
    return cases


def _op_run(op, ins, attrs, dev, grad_of=None):
    """One op's lowering on ``dev`` from numpy inputs (a list for a
    variadic slot); with ``grad_of`` = (slots, cotangents) its
    ``generic_grad`` instead."""
    import torch
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    ctx = LoweringContext(device=torch.device(dev))
    t = {k: [torch.from_numpy(np.array(a)).to(dev)
             for a in (v if isinstance(v, list) else [v])]
         for k, v in ins.items()}
    if grad_of is None:
        return get_op(op).fn(t, dict(attrs), ctx)
    slots, cots = grad_of
    gins = {"I_" + k: v for k, v in t.items()}
    gins.update({"G_" + k: [torch.from_numpy(c).to(dev)]
                 for k, c in cots.items()})
    return get_op("generic_grad").fn(
        gins, {"fwd_type": op, "fwd_attrs": dict(attrs),
               "grad_slots": slots, "in_slots": list(ins)}, ctx)


def _op_err(got, want, tol):
    """The largest float error over ``tol`` of each output's largest
    |value|; an integer output that differs is infinitely wrong."""
    e = 0.0
    for slot, vals in want.items():
        w, g = _host(vals[0]), _host(got[slot][0])
        if w.dtype.kind == "f":
            if w.size:
                e = max(e, float(np.abs(g - w).max()) / (
                    tol * max(float(np.abs(w).max()), 1e-30)))
        elif not np.array_equal(g, w):
            e = float("inf")
    return e


def _op_card_err(op, ins, attrs, tol, rng, kink=0.0, grad_f64=False):
    """``op`` on the card against the host, forward and, where it is
    differentiable, ``generic_grad`` from one random cotangent of each
    float output: the larger error over ``tol``.  With ``kink`` > 0 the
    cotangent is 0 where the host's output is within ``kink`` of an
    activation's kink at 0 (ReLU's), where the two devices may take
    different branches.  With ``grad_f64`` the gradients run in float64
    on both devices, for ops whose inner ReLUs no output cotangent
    reaches: float32 rounding flips a few of them."""
    from paddle_tpu_torch.ops.registry import get_op

    host = _op_run(op, ins, attrs, "cpu")
    e = _op_err(_op_run(op, ins, attrs, DEVICE), host, tol)
    opdef = get_op(op)
    if opdef.differentiable:
        slots = [k for k, v in ins.items() if k not in opdef.nondiff_inputs
                 and np.asarray(v[0] if isinstance(v, list) else v)
                 .dtype.kind == "f"]
        if isinstance(rng, np.random.Generator):   # float32 draws, faster
            def draw(shape):
                return rng.standard_normal(shape, dtype=np.float32)
        else:
            def draw(shape):
                return np.asarray(rng.randn(*shape), "float32")
        cots = {k: draw(_host(v[0]).shape)
                for k, v in host.items() if k not in opdef.nondiff_outputs
                and _host(v[0]).dtype.kind == "f"}
        if kink:
            cots = {k: c * (np.abs(_host(host[k][0])) >= kink)
                    for k, c in cots.items()}
        if grad_f64:
            ins = {k: [np.asarray(a, "float64")
                       if np.asarray(a).dtype.kind == "f" else a
                       for a in (v if isinstance(v, list) else [v])]
                   for k, v in ins.items()}
            cots = {k: c.astype("float64") for k, c in cots.items()}
        e = max(e, _op_err(_op_run(op, ins, attrs, DEVICE, (slots, cots)),
                           _op_run(op, ins, attrs, "cpu", (slots, cots)),
                           tol))
    return e


def _image_ops_on_the_card(card):
    """(c) each op type of the image layers on the card against the host:
    every output within IMAGE_CARD_TOL of its largest |value| (ints
    equal), and for the differentiable ones every input gradient through
    ``generic_grad`` from one cotangent; a host twin with the transposed
    convolution's extra row low must miss; ``dropout_nd`` by its
    contract, the card's mask equal to the host's (one Philox stream)."""
    import torch
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    worst, rng = {}, np.random.RandomState(SEED + 78)
    covered = set()
    for label, (ins, attrs) in _image_op_cases().items():
        op = label.split()[0]
        covered.add(op)
        worst[label] = _op_card_err(op, ins, attrs, IMAGE_CARD_TOL, rng)
    ins, attrs = _image_op_cases()["conv2d_transpose"]
    card_out = _op_run("conv2d_transpose", ins, attrs, DEVICE)
    with _extra_row_low():
        twin = _op_err(_op_run("conv2d_transpose", ins, attrs, "cpu"),
                       card_out, IMAGE_CARD_TOL)
    # dropout_nd: whole channels, the kept share, Out = X Mask / (1 - p)
    x = np.random.RandomState(SEED + 79).rand(64, 64, 2, 2) \
        .astype("float32") + 1.0
    attrs = {"dropout_prob": 0.3, "axis": [0, 1], "op_seed": 5}
    ctx = LoweringContext(device=torch.device(DEVICE), base_seed=SEED)
    d = get_op("dropout_nd").fn({"X": [torch.from_numpy(x).to(DEVICE)]},
                                attrs, ctx)
    hd = get_op("dropout_nd").fn(
        {"X": [torch.from_numpy(x)]}, attrs,
        LoweringContext(device=torch.device("cpu"), base_seed=SEED))
    o, m = _host(d["Out"][0]), _host(d["Mask"][0])
    per = m.reshape(64, 64, -1)
    kept = float(per[..., 0].mean())
    contract = bool((per == per[..., :1]).all()
                    and abs(kept - 0.7) < 6 * np.sqrt(0.21 / per[..., 0].size)
                    and np.allclose(o, x * m / np.float32(0.7), rtol=1e-6)
                    and np.array_equal(m, _host(hd["Mask"][0])))
    covered.add("dropout_nd")
    _p(f"image-layer op types on the card against the host "
       f"({len(covered)} types), forward and generic_grad, error / "
       f"{IMAGE_CARD_TOL} of the largest |value| (under 1 passes): "
       + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
       + f"; the extra-row-low twin (must miss) {twin:.3e}; dropout_nd's "
       f"contract {contract} (kept {kept:.4f} of whole channels, the "
       f"card's mask the host's)  [{card}]")
    if max(worst.values()) > 1 or twin <= 10 or not contract:
        raise SystemExit("chip_smoke: an image-layer op type disagrees with "
                         "the host on the card")
    return {"worst": worst, "twin": twin, "dropout_nd_contract": contract,
            "types": len(covered)}


def phase_image_layers(card):
    """Phase 4s, the image layers: (a) CycleGAN at the paper's width
    through the dygraph 2.0 loop, timed, profiled, card against host,
    determinism; (b) its generator as a static program, against (a)'s
    generator, one Adam step, card against host; (c) every new op type
    on the card against the host.  Returns the counted launches of (a)'s
    timed steps and (b)'s step, and the numbers."""
    import torch
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    t = time.perf_counter()
    try:
        launches, cyc, g_state, g_out = _cyclegan_leg(card)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = flags
    _p(f"phase 4s (a): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    static_launches, static = _static_generator_leg(g_state, g_out, card)
    _p(f"phase 4s (b): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ops = _image_ops_on_the_card(card)
    _p(f"phase 4s (c): {time.perf_counter() - t:.1f} s")
    return ({"cyclegan": launches, "static_generator": static_launches},
            {"cyclegan": cyc, "static_generator": static, "ops": ops})


# --- phase 4t: the sequence tier --------------------------------------------
# the PaddlePaddle book's label_semantic_roles (chapter 7, db_lstm) at
# CoNLL-05's dictionaries; ids, lengths and labels are drawn from the seed
SRL = dict(words=44068, preds=3162, labels=59, marks=2, word_dim=32,
           mark_dim=5, hidden=512, depth=8, lr=0.01, decay_steps=100000,
           decay_rate=0.5, crf_lr=1e-3)
SRL_BATCH, SRL_STEPS, SRL_MIN_LEN = 10, 64, 16
SRL_HOST = dict(SRL, words=2000, preds=300, hidden=128, depth=4)
SRL_HOST_BATCH, SRL_HOST_STEPS = 4, 32
SRL_WORDS = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")
# PaddleCV ocr_recognition's crnn_ctc_model at its input width: 95 classes
# and the blank, labels of 4 to 24 from the seed
CRNN = dict(classes=95, channels=(16, 32, 64, 128), hidden=200, height=48,
            width=512, lr=1e-3, momentum=0.9, l2=4e-4, min_label=4,
            max_label=24)
CRNN_BATCH = 32
CRNN_HOST = dict(CRNN, channels=(8, 8, 16, 16), hidden=32, width=128,
                 max_label=8)
CRNN_HOST_BATCH = 4
SEQ_TIMED, SEQ_HOST_STEPS = 3, 2
SEQ_CARD_TOL = 1e-4           # (c): of each output's largest |value|
VITERBI_MARGIN = 1e-3         # paths closer than this may swap on the card
ARGMAX_MARGIN = 1e-4          # (b)'s logits: about 100x their card-host gap


def srl_program(fluid, cfg, batch, steps, train=True):
    """The book's ``db_lstm`` over padded rows: the six word inputs share
    the untrainable ``emb``, the predicate and the mark have their own;
    each of the eight embeddings through an fc with tanh, summed;
    ``depth`` ``dynamic_lstm`` layers of alternating direction (relu
    candidates, sigmoid gates and cells), each fed by the sum of two fcs
    over the last (mix, lstm) pair; two fcs to the labels summed as the
    emission; ``linear_chain_crf`` (``crfw`` at learning rate
    ``crf_lr``), SGD over ``exponential_decay``; ``crf_decoding`` on
    ``crfw`` and ``chunk_eval`` in IOB.  Returns (loss, emission, path,
    chunk outputs, params_grads)."""
    L = fluid.layers
    ids = {n: fluid.data(n, [batch, steps], "int64")
           for n in SRL_WORDS + ("verb", "mark", "target")}
    length = fluid.data("length", [batch], "int64")
    embs = [L.embedding(ids[n], [cfg["words"], cfg["word_dim"]],
                        param_attr=fluid.ParamAttr(name="emb",
                                                   trainable=False))
            for n in SRL_WORDS]
    embs.append(L.embedding(ids["verb"], [cfg["preds"], cfg["word_dim"]],
                            is_sparse=True, param_attr="vemb"))
    embs.append(L.embedding(ids["mark"], [cfg["marks"], cfg["mark_dim"]],
                            is_sparse=True))
    hid = cfg["hidden"]

    def fc(x, size):
        return L.fc(x, size, num_flatten_dims=2, act="tanh")

    def lstm(x, reverse):
        return L.dynamic_lstm(x, hid, candidate_activation="relu",
                              gate_activation="sigmoid",
                              cell_activation="sigmoid",
                              is_reverse=reverse)[0]
    mix = L.sums([fc(e, hid) for e in embs])
    pair = [mix, lstm(mix, False)]
    for i in range(1, cfg["depth"]):
        mix = L.sums([fc(pair[0], hid), fc(pair[1], hid)])
        pair = [mix, lstm(mix, i % 2 == 1)]
    emission = L.sums([fc(pair[0], cfg["labels"]),
                       fc(pair[1], cfg["labels"])])
    loss = L.mean(L.linear_chain_crf(
        emission, ids["target"], length=length,
        param_attr=fluid.ParamAttr(name="crfw",
                                   learning_rate=cfg["crf_lr"])))
    pg = []
    if train:
        lr = L.exponential_decay(cfg["lr"], cfg["decay_steps"],
                                 cfg["decay_rate"], staircase=True)
        _, pg = fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    path = L.crf_decoding(emission, param_attr=fluid.ParamAttr(name="crfw"),
                          length=length)
    chunks = L.chunk_eval(path, ids["target"], "IOB",
                          num_chunk_types=math.ceil((cfg["labels"] - 1) / 2),
                          seq_length=length)
    return loss, emission, path, chunks, pg


def srl_feed(cfg, batch, steps, seed):
    """One batch as numpy: ids of each input, labels and lengths in
    [SRL_MIN_LEN, steps] (at most ``steps``), 0 past a row's length."""
    rng = np.random.RandomState(seed)
    length = rng.randint(min(SRL_MIN_LEN, steps), steps + 1, batch)
    valid = np.arange(steps)[None] < length[:, None]
    highs = dict({n: cfg["words"] for n in SRL_WORDS}, verb=cfg["preds"],
                 mark=cfg["marks"], target=cfg["labels"])
    feed = {n: np.where(valid, rng.randint(0, h, (batch, steps)), 0)
            .astype("int64") for n, h in highs.items()}
    feed["length"] = length.astype("int64")
    return feed


def crnn_program(fluid, cfg, batch, train=True):
    """``crnn_ctc_model.py``'s ``ctc_train_net``: ``ocr_convs`` (four
    groups of two 3x3 conv2d, each with batch_norm and relu, a 2x2 max
    pool of stride 2 after each of the first three; the model pools with
    ``ceil_mode=True``, which the port refuses by design, and at these
    sizes every pooled side is even, so floor and ceil agree and the
    program passes none), ``im2sequence`` with a filter the features'
    height by 1, the patch rows back to [B, W/8, C · H/8], two fcs of
    3 · hidden, ``dynamic_gru`` forward and reversed (relu candidates),
    an fc over both to classes + 1, ``warpctc`` (the blank last,
    ``norm_by_times``) summed, Momentum with L2 decay on every
    parameter; ``ctc_greedy_decoder``, and ``ctc_align`` again through a
    ``LayerHelper`` for its lengths, which ``edit_distance`` reads.
    Returns (loss, decoded, decoded lengths, distances, the builder's
    decoded rows, params_grads)."""
    L = fluid.layers
    layer_helper = importlib.import_module(fluid.__name__ + ".layer_helper")
    h, w, hid = cfg["height"], cfg["width"], cfg["hidden"]
    images = fluid.data("pixel", [batch, 1, h, w])
    label = fluid.data("label", [batch, cfg["max_label"]], "int64")
    label_len = fluid.data("label_length", [batch], "int64")
    l2 = fluid.regularizer.L2Decay(cfg["l2"])

    def attr(std, lr=1.0):
        return fluid.ParamAttr(
            regularizer=l2, learning_rate=lr,
            initializer=fluid.initializer.Normal(0.0, std))
    x = images
    for g, ch in enumerate(cfg["channels"]):
        for i in range(2):
            x = L.conv2d(x, ch, 3, padding=1,
                         param_attr=attr(0.0005 if g == i == 0 else 0.01),
                         bias_attr=attr(0.0))
            x = L.batch_norm(x, act="relu", param_attr=attr(0.01),
                             bias_attr=attr(0.0))
        if g < 3:
            x = L.pool2d(x, 2, "max", pool_stride=2)
    feat_h, steps = h // 8, w // 8
    seq = L.im2sequence(x, filter_size=[feat_h, 1], stride=[1, 1])
    seq = L.reshape(seq, [batch, steps, cfg["channels"][-1] * feat_h])
    fc_1 = L.fc(seq, 3 * hid, num_flatten_dims=2, param_attr=attr(0.02),
                bias_attr=attr(0.02))
    fc_2 = L.fc(seq, 3 * hid, num_flatten_dims=2, param_attr=attr(0.02),
                bias_attr=attr(0.02))
    gru_f = L.dynamic_gru(fc_1, hid, param_attr=attr(0.02),
                          bias_attr=attr(0.02, 2.0),
                          candidate_activation="relu")
    gru_b = L.dynamic_gru(fc_2, hid, is_reverse=True, param_attr=attr(0.02),
                          bias_attr=attr(0.02, 2.0),
                          candidate_activation="relu")
    logits = L.fc([gru_f, gru_b], cfg["classes"] + 1, num_flatten_dims=2,
                  param_attr=attr(0.02), bias_attr=attr(0.0))
    loss = L.reduce_sum(L.warpctc(logits, label, blank=cfg["classes"],
                                  norm_by_times=True,
                                  label_length=label_len))
    pg = []
    if train:
        _, pg = fluid.optimizer.Momentum(
            learning_rate=cfg["lr"], momentum=cfg["momentum"]).minimize(loss)
    greedy = L.ctc_greedy_decoder(logits, blank=cfg["classes"])
    helper = layer_helper.LayerHelper("ctc_greedy_decoder")
    decoded = helper.create_variable_for_type_inference("int64")
    decoded_len = helper.create_variable_for_type_inference("int64")
    helper.append_op("ctc_align", inputs={"Input": [L.argmax(logits, -1)]},
                     outputs={"Output": [decoded],
                              "OutputLength": [decoded_len]},
                     attrs={"blank": cfg["classes"], "merge_repeated": True})
    dist, _ = L.edit_distance(decoded, label, input_length=decoded_len,
                              label_length=label_len)
    return loss, decoded, decoded_len, dist, greedy, pg


def crnn_feed(cfg, batch, seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(cfg["min_label"], cfg["max_label"] + 1, batch)
    label = rng.randint(0, cfg["classes"], (batch, cfg["max_label"]))
    label = np.where(np.arange(cfg["max_label"])[None] < n[:, None], label, 0)
    pixel = rng.rand(batch, 1, cfg["height"], cfg["width"]) \
        .astype("float32")
    return {"pixel": pixel, "label": label.astype("int64"),
            "label_length": n.astype("int64")}


@contextlib.contextmanager
def _swapped_op(op_type, fn):
    """A broken twin: ``op_type``'s lowering replaced by ``fn(orig)``."""
    from paddle_tpu_torch.ops.registry import get_op

    opdef = get_op(op_type)
    orig = opdef.fn
    opdef.fn = fn(orig)
    try:
        yield
    finally:
        opdef.fn = orig


def _crf_start_stop_swapped():
    """The twin of (a): the CRF and its decode read the transition's
    start and stop rows the other way round."""
    def wrap(orig):
        def fn(ins, attrs, ctx):
            t = ins["Transition"][0]
            return orig(dict(ins, Transition=[t[[1, 0] + list(
                range(2, t.shape[0]))]]), attrs, ctx)
        return fn

    @contextlib.contextmanager
    def both():
        with _swapped_op("linear_chain_crf", wrap), \
                _swapped_op("crf_decoding", wrap):
            yield
    return both()


def _patches_kh_major():
    """The twin of (b): ``im2sequence``'s patch features in (kh, C) order
    instead of (C, kh)."""
    def wrap(orig):
        def fn(ins, attrs, ctx):
            out = orig(ins, attrs, ctx)["Out"][0]
            c, (kh, kw) = ins["X"][0].shape[1], attrs["kernels"]
            out = out.reshape(-1, c, kh * kw).transpose(1, 2)
            return {"Out": [out.reshape(-1, c * kh * kw)]}
        return fn
    return _swapped_op("im2sequence", wrap)


def _viterbi_margin(em, trans, length):
    """Each row's best CRF score less the best score of a path that
    differs from it somewhere (max-marginals, float64)."""
    start, stop, tr = (np.asarray(a, "float64") for a in
                       (trans[0], trans[1], trans[2:]))
    out = []
    for e, n in zip(np.asarray(em, "float64"), length):
        alpha = [start + e[0]]
        for t in range(1, n):
            alpha.append((alpha[-1][:, None] + tr).max(0) + e[t])
        beta = [stop]
        for t in range(n - 1, 0, -1):
            beta.insert(0, (tr + (e[t] + beta[0])[None]).max(1))
        marg = np.stack([a + b for a, b in zip(alpha, beta)])
        top = marg.argmax(1)
        other = np.where(np.arange(marg.shape[1])[None] == top[:, None],
                         -np.inf, marg).max()
        out.append(marg.max() - other)
    return np.array(out)


def _path_scores(em, trans, paths, length):
    """Each row's CRF score of ``paths`` over its first ``length`` steps
    (float64)."""
    start, stop, tr = (np.asarray(a, "float64") for a in
                       (trans[0], trans[1], trans[2:]))
    out = []
    for e, p, n in zip(np.asarray(em, "float64"), paths, length):
        s = start[p[0]] + e[0, p[0]] + stop[p[n - 1]]
        out.append(s + sum(tr[p[t - 1], p[t]] + e[t, p[t]]
                           for t in range(1, n)))
    return np.array(out)


def _seq_margins(exact):
    """``_margins`` (each loss to rtol 1e-4, the first step's gradient
    cosine to 1e-4 of 1 and norm to 1e-3) and ``exact(got, want)``'s
    criteria."""
    def margins(got, want):
        out = _margins(got, want)
        out.update(exact(got, want))
        return out
    return margins


def _srl_clear_rows(run):
    """The rows whose Viterbi path beats every other by VITERBI_MARGIN
    under ``run``'s emission and transition."""
    return _viterbi_margin(run["emission"], run["crfw"], run["length"]) \
        > VITERBI_MARGIN


def _srl_exact(got, want):
    """The paths equal on the host's clear rows (each differing step
    counts 1, none passes); every path's score under the host's emission
    and transition within 1e-5 of the host path's; chunk_eval's three
    counts equal."""
    clear = _srl_clear_rows(want)
    args = want["emission"], want["crfw"]
    g = _path_scores(*args, got["path"], want["length"])
    w = _path_scores(*args, want["path"], want["length"])
    return {"viterbi paths": float((got["path"][clear]
                                    != want["path"][clear]).sum()),
            "viterbi scores": float(np.abs(g - w).max()
                                    / (1e-5 * np.abs(w).max())),
            "chunk counts": float((got["chunks"] != want["chunks"]).sum())}


def _crnn_clear_rows(run):
    """The rows whose every step's best class beats the runner-up by
    ARGMAX_MARGIN (an argmax closer than that may flip on the card)."""
    top2 = np.sort(run["logits"], axis=-1)[..., -2:]
    return ((top2[..., 1] - top2[..., 0]) > ARGMAX_MARGIN).all(1)


def _crnn_exact(got, want):
    """The first step's logits within 1e-4 of their largest |value|; on
    the host's clear rows the decoded rows, their lengths and the edit
    distances equal (each differing entry counts 1)."""
    clear = _crnn_clear_rows(want)
    return {"logits": float(np.abs(got["logits"] - want["logits"]).max()
                            / (1e-4 * np.abs(want["logits"]).max())),
            "decoded rows": float(sum(
                (got[k][clear] != want[k][clear]).sum()
                for k in ("decoded", "decoded_len", "dist")))}


def _seq_run(main, fetch, init, place, feeds, unpack, twin=None):
    """``feeds`` as steps from ``init`` on ``place``; ``unpack(first
    step's fetches)`` gives the outputs compared, and the losses of
    every step are added."""
    with (twin or contextlib.nullcontext)():
        outs, _ = _steps(main, main, fetch, init, place, feeds)
    run = unpack([np.asarray(v) for v in outs[0]])
    run["losses"] = [float(np.asarray(o[0])) for o in outs]
    return run


def _seq_timed(label, step, units, unit_name, card):
    """One profiled step (``_profile``: a warm-up step, one timed, one
    profiled without the host's ops), then SEQ_TIMED timed with every
    counted kernel at 0.  Returns (the launches, the numbers)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prof = _profile(step, 1, warmup=1, host_ops=False)
    t = time.perf_counter()
    losses, launches = _counted_run(
        label, lambda: [step() for _ in range(SEQ_TIMED)], {})
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {"ms": wall / SEQ_TIMED * 1e3, "rate": units * SEQ_TIMED / wall,
           "losses": losses, "peak_gib": peak, "host_ms": prof[0],
           "busy_ms": prof[1], "idle": prof[2], "kernels": prof[3],
           "launches": launches}
    _p(f"{label} ({time.perf_counter() - t0:.1f} s): {SEQ_TIMED} steps in "
       f"{wall:.3f} s: {out['ms']:.2f} ms/step, {out['rate']:.1f} "
       f"{unit_name}/s; host {prof[0]:.3f} ms/step, device busy "
       f"{prof[1]:.3f} ms/step, idle share {prof[2]:.4f}, {prof[3]:.0f} "
       f"kernels/step; peak {peak:.2f} GiB; losses {losses}; launches "
       f"{launches} (none expected)  [{card}]")
    _print_classes(prof[4], "step")
    if not np.isfinite(losses).all():
        raise SystemExit(f"chip_smoke: {label}'s losses are not finite")
    return launches, out


def _seq_determinism(label, main, startup, fetch, feed, card):
    """Two runs of one full-width step from one state on the card: the
    loss and every persistable after, bit for bit.  Returns the names of
    the values that differ."""
    from paddle_tpu_torch import fluid

    init = _startup_state(main, startup, fluid.CUDAPlace(0))
    runs = [_steps(main, main, fetch, init, fluid.CUDAPlace(0), [feed])
            for _ in range(2)]
    differ = [k for k in runs[0][1]
              if not np.array_equal(runs[0][1][k], runs[1][1][k])]
    if not np.array_equal(np.asarray(runs[0][0][0][0]),
                          np.asarray(runs[1][0][0][0])):
        differ.append("the loss")
    _p(f"{label} determinism: two runs of one full-width step from one "
       f"state, {len(differ)} of {len(runs[0][1]) + 1} persistables and "
       f"the loss differ in any bit {differ}  [{card}]")
    return differ


def _worst_grads(pg, got, want, n=4):
    """The ``n`` parameters whose first-step gradients differ most, by
    relative L2 error."""
    rel = sorted(((float(np.linalg.norm(a - b)
                         / max(np.linalg.norm(b), 1e-30)), p.name)
                  for (p, _), a, b in zip(pg, got["grads"], want["grads"])),
                 reverse=True)
    return [(name, f"{e:.2e}") for e, name in rel[:n]]


def _srl_leg(card):
    """(a) at the book's width: SRL_BATCH sentences padded to SRL_STEPS,
    timed and profiled; card against host at SRL_HOST (the host's
    startup values on both) with the start/stop-swapped twin; two
    full-width runs bit for bit.  Returns (the launches, the numbers)."""
    import torch
    from paddle_tpu_torch import fluid

    t0 = time.perf_counter()
    main, startup, (loss, emission, path, chunks, pg), _ = _book_program(
        srl_program, False, cfg=SRL, batch=SRL_BATCH, steps=SRL_STEPS)
    n_params = sum(math.prod(p.shape)
                   for p in main.global_block().all_parameters())
    place = fluid.CUDAPlace(0)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = srl_feed(SRL, SRL_BATCH, SRL_STEPS, SEED + 80)
    tokens = int(feed["length"].sum())
    dev_feed = {k: torch.from_numpy(v).to(DEVICE) for k, v in feed.items()}
    last = {}

    def step():
        last["loss"], last["f1"] = exe.run(
            main, feed=dev_feed, fetch_list=[loss, chunks[2]], scope=scope)
        return float(last["loss"])
    launches, out = _seq_timed("SRL db_lstm step", step, tokens, "tokens",
                               card)
    f1 = float(np.asarray(last["f1"]).reshape(-1)[0])
    out.update(params=n_params, tokens=tokens, f1=f1)
    _p(f"SRL db_lstm: {n_params} parameters, {SRL_BATCH} sentences of "
       f"{tokens} tokens padded to {SRL_STEPS}, chunk_eval F1 {f1:.4f} "
       f"(the reference's simplified IOB: the O tag opens a chunk at "
       f"every token)  [{card}]")

    # card against host at SRL_HOST
    t = time.perf_counter()
    hmain, hstart, (hloss, hem, hpath, hchunks, hpg), _ = _book_program(
        srl_program, False, cfg=SRL_HOST, batch=SRL_HOST_BATCH,
        steps=SRL_HOST_STEPS)
    init = _startup_state(hmain, hstart, fluid.CPUPlace())
    feeds = [srl_feed(SRL_HOST, SRL_HOST_BATCH, SRL_HOST_STEPS, SEED + 81 + i)
             for i in range(SEQ_HOST_STEPS)]
    crfw = hmain.global_block().var("crfw")
    hfetch = [hloss, hem, hpath, crfw] + list(hchunks[3:]) \
        + [g for _, g in hpg]

    def unpack(v):
        return {"emission": v[1], "path": v[2], "crfw": v[3],
                "chunks": np.concatenate([np.ravel(c) for c in v[4:7]]),
                "grads": v[7:], "length": feeds[0]["length"]}

    def run(p, twin=None):
        return _seq_run(hmain, hfetch, init, p, feeds, unpack, twin)
    card_r, host_r = run(fluid.CUDAPlace(0)), run(fluid.CPUPlace())
    ok, misses = _twins_report(
        "SRL db_lstm", lambda twin: run(fluid.CPUPlace(), twin), host_r,
        card_r, card, twins=(("start/stop-swapped", _crf_start_stop_swapped),),
        margins=_seq_margins(_srl_exact))
    clear = int(_srl_clear_rows(host_r).sum())
    _p(f"SRL db_lstm: card vs host at hidden {SRL_HOST['hidden']}, depth "
       f"{SRL_HOST['depth']}, {SRL_HOST_BATCH} rows of {SRL_HOST_STEPS}, "
       f"{SEQ_HOST_STEPS} SGD steps in {time.perf_counter() - t:.1f} s: "
       f"losses card {card_r['losses']}, host {host_r['losses']}; Viterbi "
       f"paths held exactly on {clear} of {SRL_HOST_BATCH} rows (the rest "
       f"by their scores); chunk counts card {card_r['chunks'].tolist()}, "
       f"host {host_r['chunks'].tolist()}; the first step's gradients, "
       f"largest relative L2 errors {_worst_grads(hpg, card_r, host_r)}")
    out["card_vs_host"] = {"ok": ok, "misses": misses, "exact_rows": clear}
    out["differ"] = _seq_determinism(
        "SRL db_lstm", main, startup, [loss],
        srl_feed(SRL, SRL_BATCH, SRL_STEPS, SEED + 83), card)
    _p(f"phase 4t (a): {time.perf_counter() - t0:.1f} s")
    return launches, out


def _ctc_yardstick(card):
    """At (b)'s step shape: the ``warpctc`` op's forward and its
    ``generic_grad``, beside ``F.ctc_loss`` (time-major log-probabilities,
    the same lengths) forward and forward with backward, by CUDA events;
    the two losses must agree to rtol 1e-4 (norm_by_times off)."""
    import torch
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    rng = np.random.RandomState(SEED + 86)
    steps, c = CRNN["width"] // 8, CRNN["classes"] + 1
    feed = crnn_feed(CRNN, CRNN_BATCH, SEED + 87)
    logits = torch.from_numpy(rng.randn(CRNN_BATCH, steps, c)
                              .astype("float32")).to(DEVICE)
    label = torch.from_numpy(feed["label"]).to(DEVICE)
    n = torch.from_numpy(feed["label_length"]).to(DEVICE)
    t_len = torch.full((CRNN_BATCH,), steps, dtype=torch.long, device=DEVICE)
    ins = {"Logits": [logits], "Label": [label], "LabelLength": [n]}
    attrs = {"blank": CRNN["classes"]}
    ctx = LoweringContext(device=torch.device(DEVICE))
    op, grad = get_op("warpctc").fn, get_op("generic_grad").fn
    g = torch.ones((CRNN_BATCH, 1), device=DEVICE)
    gins = {"I_Logits": [logits], "I_Label": [label], "I_LabelLength": [n],
            "G_Loss": [g]}
    gattrs = {"fwd_type": "warpctc", "fwd_attrs": attrs,
              "grad_slots": ["Logits"],
              "in_slots": ["Logits", "Label", "LabelLength"]}
    lib_x = logits.detach().clone().requires_grad_()

    def lib():
        return torch.nn.functional.ctc_loss(
            torch.log_softmax(lib_x, -1).transpose(0, 1), label, t_len, n,
            blank=CRNN["classes"], reduction="none")

    def lib_both():
        return torch.autograd.grad(lib().sum(), lib_x)
    ours = _host(op(ins, attrs, ctx)["Loss"][0]).reshape(-1)
    want = _host(lib()).reshape(-1)
    err = float(np.abs(ours - want).max() / (1e-4 * np.abs(want).max()))
    ours_g = _host(grad(gins, gattrs, ctx)["GI_Logits"][0])
    want_g = _host(lib_both()[0])
    err_g = float(np.abs(ours_g - want_g).max()
                  / (1e-4 * np.abs(want_g).max()))
    out = {"warpctc_ms": _ms(lambda: op(ins, attrs, ctx), 10),
           "warpctc_grad_ms": _ms(lambda: grad(gins, gattrs, ctx), 10),
           "ctc_loss_ms": _ms(lib, 10),
           "ctc_loss_fwd_bwd_ms": _ms(lib_both, 10),
           "loss_err": err, "grad_err": err_g}
    _p(f"warpctc at [{CRNN_BATCH}, {steps}, {c}], labels of "
       f"{CRNN['min_label']} to {CRNN['max_label']}: the op's forward "
       f"{out['warpctc_ms']:.3f} ms, its generic_grad "
       f"{out['warpctc_grad_ms']:.3f} ms; F.ctc_loss forward "
       f"{out['ctc_loss_ms']:.3f} ms, forward and backward "
       f"{out['ctc_loss_fwd_bwd_ms']:.3f} ms; loss / 1e-4 of the largest "
       f"{err:.3e}, gradient {err_g:.3e} (under 1 passes)  [{card}]")
    if err > 1 or err_g > 1:
        raise SystemExit("chip_smoke: warpctc disagrees with F.ctc_loss")
    return out


def _crnn_leg(card):
    """(b) at ocr_recognition's width: CRNN_BATCH images of
    [1, 48, 512], timed and profiled; card against host at CRNN_HOST with
    the (kh, C) twin; two full-width runs bit for bit; then the CTC
    yardstick.  Returns (the launches, the numbers)."""
    import torch
    from paddle_tpu_torch import fluid

    t0 = time.perf_counter()
    main, startup, (loss, dec, dec_len, dist, greedy, pg), _ = _book_program(
        crnn_program, False, cfg=CRNN, batch=CRNN_BATCH)
    n_params = sum(math.prod(p.shape)
                   for p in main.global_block().all_parameters())
    place = fluid.CUDAPlace(0)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = crnn_feed(CRNN, CRNN_BATCH, SEED + 84)
    dev_feed = {k: torch.from_numpy(v).to(DEVICE) for k, v in feed.items()}

    def step():
        return float(exe.run(main, feed=dev_feed, fetch_list=[loss],
                             scope=scope)[0])
    launches, out = _seq_timed("CRNN-CTC step", step, CRNN_BATCH, "images",
                               card)
    d, g = exe.run(main, feed=dev_feed, fetch_list=[dec, greedy],
                   scope=scope)
    out["params"] = n_params
    _p(f"CRNN-CTC: {n_params} parameters, batch {CRNN_BATCH} of "
       f"[1, {CRNN['height']}, {CRNN['width']}], {CRNN['width'] // 8} steps "
       f"of {CRNN['channels'][-1] * CRNN['height'] // 8} features; the "
       f"builder's decoded rows equal the helper's: "
       f"{np.array_equal(np.asarray(d), np.asarray(g))}  [{card}]")
    if not np.array_equal(np.asarray(d), np.asarray(g)):
        raise SystemExit("chip_smoke: ctc_greedy_decoder's rows are not "
                         "ctc_align's")

    t = time.perf_counter()
    hmain, hstart, (hloss, hdec, hlen, hdist, _, hpg), _ = _book_program(
        crnn_program, False, cfg=CRNN_HOST, batch=CRNN_HOST_BATCH)
    init = _startup_state(hmain, hstart, fluid.CPUPlace())
    # the model's batch_norm scales, N(0, 0.01), shrink the features about
    # 100 times a layer (the convolutions' outputs lie far below the
    # norm's epsilon) to 1e-10 at the eighth: the logits would not see the
    # images; and its N(0, 0.01) filters make each norm divide by a tiny
    # deviation, so the gradient of a convolution's bias (0 in exact
    # arithmetic: the norm takes out the mean) is float32 noise as large
    # as the rest.  The check carries scales of 1 (batch_norm's default)
    # and He's N(0, 2 / fan-in) filters
    rng = np.random.RandomState(SEED + 92)
    for op in hmain.global_block().ops:
        if op.type == "batch_norm":
            name = op.inputs["Scale"][0]
            init[name] = np.ones_like(init[name])
        elif op.type == "conv2d":
            name = op.inputs["Filter"][0]
            shape = init[name].shape
            init[name] = (rng.randn(*shape) * np.sqrt(
                2 / math.prod(shape[1:]))).astype("float32")
    feeds = [crnn_feed(CRNN_HOST, CRNN_HOST_BATCH, SEED + 85 + i)
             for i in range(SEQ_HOST_STEPS)]
    logits = [op for op in hmain.global_block().ops
              if op.type == "warpctc"][0].inputs["Logits"][0]
    hfetch = [hloss, hdec, hlen, hdist, logits] + [g for _, g in hpg]

    def unpack(v):
        return {"decoded": v[1], "decoded_len": v[2].reshape(-1),
                "dist": v[3].reshape(-1), "logits": v[4], "grads": v[5:]}

    def run(p, twin=None):
        return _seq_run(hmain, hfetch, init, p, feeds, unpack, twin)
    card_r, host_r = run(fluid.CUDAPlace(0)), run(fluid.CPUPlace())
    ok, misses = _twins_report(
        "CRNN-CTC", lambda twin: run(fluid.CPUPlace(), twin), host_r, card_r,
        card, twins=(("(kh, C) patch order", _patches_kh_major),),
        margins=_seq_margins(_crnn_exact))
    clear = int(_crnn_clear_rows(host_r).sum())
    _p(f"CRNN-CTC: card vs host at channels {CRNN_HOST['channels']}, "
       f"hidden {CRNN_HOST['hidden']}, {CRNN_HOST_BATCH} images of "
       f"[1, {CRNN_HOST['height']}, {CRNN_HOST['width']}], {SEQ_HOST_STEPS} "
       f"Momentum steps in {time.perf_counter() - t:.1f} s: losses card "
       f"{card_r['losses']}, host {host_r['losses']}; decoded rows, lengths "
       f"and edit distances held exactly on {clear} of {CRNN_HOST_BATCH} "
       f"rows; distances card {card_r['dist'].tolist()}, host "
       f"{host_r['dist'].tolist()}; the first step's gradients, largest "
       f"relative L2 errors {_worst_grads(hpg, card_r, host_r)}")
    out["card_vs_host"] = {"ok": ok, "misses": misses, "exact_rows": clear}
    out["differ"] = _seq_determinism(
        "CRNN-CTC", main, startup, [loss],
        crnn_feed(CRNN, CRNN_BATCH, SEED + 88), card)
    out["ctc"] = _ctc_yardstick(card)
    _p(f"phase 4t (b): {time.perf_counter() - t0:.1f} s")
    return launches, out


def _seq_op_cases():
    """(c): the 27 deterministic op types of the sequence tier at small
    shapes from a seed: {label: (op, inputs, attrs)}."""
    rng = np.random.RandomState(SEED + 89)

    def r(*shape):
        return rng.uniform(-1, 1, shape).astype("float32")

    def ids(hi, *shape):
        return rng.randint(0, hi, shape).astype("int64")
    n5 = np.array([5, 3, 1], "int64")
    return {
        "sequence_conv": ({"X": r(3, 5, 4), "Filter": r(12, 6),
                           "Length": n5},
                          {"contextLength": 3, "contextStart": -1}),
        "sequence_expand_as": ({"X": r(3, 4), "Y": r(3, 5, 2)}, {}),
        "sequence_pad": ({"X": r(3, 5, 4), "PadValue": r(1),
                          "Length": n5}, {"padded_length": 7}),
        "sequence_unpad": ({"X": r(3, 5, 4), "Length": n5}, {}),
        "sequence_slice": ({"X": r(3, 5, 4),
                            "Offset": np.array([1, 0, 3], "int64"),
                            "Length": np.array([3, 2, 2], "int64")}, {}),
        "sequence_erase": ({"X": ids(6, 3, 7)}, {"tokens": [2, 4]}),
        "sequence_enumerate": ({"X": ids(8, 3, 5)}, {"win_size": 3}),
        "sequence_scatter": ({"X": r(3, 4),
                              "Ids": np.array([0, 2, 2, 1], "int64"),
                              "Updates": r(4, 4)}, {}),
        "sequence_mask": ({"X": n5}, {"maxlen": 6}),
        "sequence_softmax": ({"X": r(3, 5), "Length": n5}, {}),
        "sequence_expand": ({"X": r(3, 4), "Y": r(3, 5)}, {}),
        "sequence_reverse": ({"X": r(3, 5, 4), "Length": n5}, {}),
        "sequence_concat": ({"X": [r(3, 2, 4), r(3, 3, 4)]}, {}),
        "sequence_reshape": ({"X": r(3, 4, 6)}, {"new_dim": 8}),
        "sequence_topk_avg_pooling": ({"X": r(2, 3, 6)}, {"topks": [1, 3]}),
        "linear_chain_crf": ({"Emission": r(3, 5, 4), "Transition": r(6, 4),
                              "Label": ids(4, 3, 5), "Length": n5}, {}),
        "crf_decoding": ({"Emission": r(3, 5, 4) * 4,
                          "Transition": r(6, 4) * 4, "Length": n5}, {}),
        "chunk_eval": ({"Inference": ids(6, 3, 6), "Label": ids(6, 3, 6),
                        "SeqLength": np.array([6, 4, 2], "int64")}, {}),
        "warpctc": ({"Logits": r(3, 6, 5),
                     "Label": np.array([[1, 2, 0], [3, 3, 1], [0, 0, 0]],
                                       "int64"),
                     "LogitsLength": np.array([6, 5, 4], "int64"),
                     "LabelLength": np.array([2, 3, 0], "int64")},
                    {"blank": 0, "norm_by_times": True}),
        "ctc_align": ({"Input": ids(4, 3, 8)}, {"blank": 0}),
        "edit_distance": ({"Hyps": ids(4, 3, 5), "Refs": ids(4, 3, 4),
                           "HypsLength": np.array([5, 2, 0], "int64"),
                           "RefsLength": np.array([4, 4, 1], "int64")}, {}),
        "hierarchical_sigmoid": ({"X": r(4, 5), "W": r(6, 5),
                                  "Bias": r(1, 6),
                                  "Label": np.array([[0], [6], [3], [5]],
                                                    "int64")},
                                 {"num_classes": 7}),
        "im2sequence": ({"X": r(2, 3, 5, 6)},
                        {"kernels": [3, 2], "strides": [2, 1],
                         "paddings": [1, 0, 0, 1]}),
        "match_matrix_tensor": ({"X": r(2, 3, 4), "Y": r(2, 5, 4),
                                 "W": r(4, 2, 4)}, {}),
        "var_conv_2d": ({"X": r(2, 2, 5, 6), "W": r(3, 12)},
                        {"output_channel": 3, "input_channel": 2,
                         "kernel_h": 3, "kernel_w": 2, "stride_h": 2,
                         "stride_w": 3}),
        "tree_conv": ({"NodesVector": r(2, 5, 3),
                       "EdgeSet": np.array([[[0, 1], [0, 2], [1, 3], [1, 4]],
                                            [[0, 1], [1, 2], [0, 0],
                                             [0, 0]]], "int64"),
                       "Filter": r(3, 2, 2, 4)}, {}),
        "center_loss": ({"X": r(5, 4),
                         "Label": np.array([[0], [2], [2], [1], [0]],
                                           "int64"),
                         "Centers": r(3, 4),
                         "CenterUpdateRate": np.array([0.3], "float32")},
                        {"need_update": True}),
    }


def _sampled_contracts(card):
    """``nce`` and ``sample_logits`` on the card by ground rule 5's
    contract: the costs and sampled logits are the numpy formula of the
    card's own samples, the negatives lie in [0, V) and are uniform
    within 6 sigma, the true classes come first, and another seed draws
    other samples."""
    rng = np.random.RandomState(SEED + 90)
    x, w = rng.randn(4000, 6).astype("float32"),         rng.randn(20, 6).astype("float32")
    b, lbl = rng.randn(20).astype("float32"), rng.randint(0, 20, (4000, 1))
    attrs = {"num_total_classes": 20, "num_neg_samples": 10, "op_seed": 3}
    out = {k: _host(v[0]) for k, v in _op_run(
        "nce", {"Input": x, "Weight": w, "Bias": b, "Label": lbl}, attrs,
        DEVICE).items()}
    s = out["SampleLabels"]
    neg = s[:, 1:]
    hist = np.bincount(neg.reshape(-1), minlength=20)
    logits = np.einsum("bd,bsd->bs", x, w[s]) + b[s]
    shifted = logits - np.log(10 / 20)
    cost = -np.where(np.arange(11)[None] < 1, -np.logaddexp(0, -shifted),
                     -np.logaddexp(0, shifted)).sum(1, keepdims=True)
    nce_ok = bool(np.array_equal(s[:, :1], lbl) and neg.min() >= 0
                  and neg.max() < 20
                  and np.abs(hist - neg.size / 20).max()
                  < 6 * np.sqrt(neg.size / 20 * 0.95)
                  and np.allclose(out["SampleLogits"], logits, rtol=1e-4,
                                  atol=1e-4)
                  and np.allclose(out["Cost"], cost, rtol=1e-4, atol=1e-4))
    other = _host(_op_run("nce", {"Input": x, "Weight": w, "Bias": b,
                                  "Label": lbl}, dict(attrs, op_seed=4),
                          DEVICE)["SampleLabels"][0])
    nce_ok = nce_ok and not np.array_equal(other, s)
    logit_in = rng.randn(2000, 30).astype("float32")
    labels = rng.randint(0, 30, (2000, 2))
    sl = {k: _host(v[0]) for k, v in _op_run(
        "sample_logits", {"Logits": logit_in, "Labels": labels},
        {"num_samples": 8, "op_seed": 5}, DEVICE).items()}
    s2 = sl["Samples"]
    hist2 = np.bincount(s2[:, 2:].reshape(-1), minlength=30)
    want = np.take_along_axis(logit_in, s2, 1) \
        - np.log(np.float32(1 / 30) * 8 + 1e-20)
    sl_ok = bool(np.array_equal(s2[:, :2], labels) and s2.min() >= 0
                 and s2.max() < 30
                 and np.abs(hist2 - s2[:, 2:].size / 30).max()
                 < 6 * np.sqrt(s2[:, 2:].size / 30 * (29 / 30))
                 and np.allclose(sl["SampledLogits"], want, rtol=1e-5,
                                 atol=1e-5))
    _p(f"nce on the card by its contract: {nce_ok}; sample_logits: "
       f"{sl_ok} (4,000 x 10 and 2,000 x 8 Philox draws)  [{card}]")
    return nce_ok and sl_ok


def _seq_ops_on_the_card(card):
    """(c) the 27 deterministic op types on the card against the host,
    forward and ``generic_grad``, within SEQ_CARD_TOL of each output's
    largest |value| (ints equal; ``crf_decoding``'s emissions scaled so
    no row is near a tie); ``nce`` and ``sample_logits`` by their
    contract."""
    worst, rng = {}, np.random.RandomState(SEED + 91)
    for op, (ins, attrs) in _seq_op_cases().items():
        worst[op] = _op_card_err(op, ins, attrs, SEQ_CARD_TOL, rng)
    contract = _sampled_contracts(card)
    _p(f"sequence-tier op types on the card against the host "
       f"({len(worst) + 2} types), forward and generic_grad, error / "
       f"{SEQ_CARD_TOL} of the largest |value| (under 1 passes): "
       + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
       + f"; nce and sample_logits by contract {contract}  [{card}]")
    if max(worst.values()) > 1 or not contract:
        raise SystemExit("chip_smoke: a sequence-tier op type disagrees "
                         "with the host on the card")
    return {"worst": worst, "contract": contract, "types": len(worst) + 2}


def phase_sequence_tier(card):
    """Phase 4t, the sequence tier: (a) the book's SRL (db_lstm through
    linear_chain_crf, crf_decoding and chunk_eval) at CoNLL-05's width as
    a static program; (b) CRNN-CTC at ocr_recognition's width; (c) the 29
    op types on the card against the host.  Returns the counted launches
    of (a)'s and (b)'s timed steps, and the numbers."""
    srl_launches, srl = _srl_leg(card)
    crnn_launches, crnn = _crnn_leg(card)
    t = time.perf_counter()
    ops = _seq_ops_on_the_card(card)
    _p(f"phase 4t (c): {time.perf_counter() - t:.1f} s")
    return ({"srl": srl_launches, "crnn": crnn_launches},
            {"srl": srl, "crnn": crnn, "ops": ops})


# --- phase 4u: the detection tier -------------------------------------------
# PaddlePaddle/models PaddleCV/ssd (mobilenet_ssd.py, train.py) on PASCAL
# VOC: MobileNet v1 to conv13 and its four extra blocks, heads over the
# 19², 10², 5², 3², 2² and 1² maps (the first map without a max size),
# RMSProp over a piecewise decay with L2Decay(5e-5)
SSD = dict(classes=21, size=300, scale=1.0, gts=8, lr=0.001, l2=5e-5,
           boundaries=[40000, 60000], lr_scales=[1.0, 0.5, 0.25],
           min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
           max_sizes=[150.0, 195.0, 240.0, 285.0, 300.0],
           nms_threshold=0.45, nms_top_k=400, keep_top_k=200, score=0.01)
SSD_BATCH, SSD_SERVE, SSD_PRIORS = 64, 8, 1917
# the card-vs-host check: a quarter of the width at 96² with the prior
# sizes scaled to it, 4 images (batch norm over the 1x1 maps of 2 images
# moves the loss 1e-3 between two float32 runs), one step (RMSProp's
# first step moves every weight by about lr·√10 whatever the size of its
# gradient, so a second loss inherits the sign of gradients that are
# float32 noise), the gradients' cosine to 1e-3 (batch norm over maps of
# 1 to 9 values; MobileNetV2's check holds 1e-2)
SSD_HOST = dict(SSD, scale=0.25, size=96,
                min_sizes=[s * 96 / 300 for s in SSD["min_sizes"]],
                max_sizes=[s * 96 / 300 for s in SSD["max_sizes"]],
                host_batch=4, host_steps=1, cos_tol=1e-3)
# PaddleDetection configs/yolov3_darknet.yml on COCO: DarkNet-53, the
# three-scale head, Momentum 0.9 with L2Decay(5e-4)
YOLO = dict(classes=80, size=608, width=32, stages=(1, 2, 8, 8, 4), gts=8,
            anchors=[10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116,
                     90, 156, 198, 373, 326],
            masks=[[6, 7, 8], [3, 4, 5], [0, 1, 2]], downsample=[32, 16, 8],
            ignore_thresh=0.7, lr=0.001, momentum=0.9, l2=5e-4,
            conf_thresh=0.005, score=0.01, keep_top_k=100)
YOLO_BATCH = 8
# images served a batch: matrix NMS over 22,743 boxes x 80 classes takes
# about 0.41 s an image on the card (3.29 s for 8, H100 80GB HBM3 at 700 W)
YOLO_SERVE = 2
# the card-vs-host check: an eighth of the width at 128², 2 images, one
# step, the gradients' cosine to 1e-3: batch norm over the 4x4 maps of 2
# images leaves some pre-activations within float32 noise of 0, and leaky
# ReLU's slope there is 1 on one side and 0.1 on the other (one element's
# flip moved the whole gradient's cosine 1.6e-4 on the card, and the
# second step's loss 1.1e-3)
YOLO_HOST = dict(YOLO, size=128, width=8, stages=(1, 1, 1, 1, 1),
                 host_batch=2, host_steps=1, cos_tol=1e-3)
DET_CARD_TOL = 1e-4           # of each output's largest |value|
DET_SCORE_MARGIN = 1e-3       # detections this close to the threshold may
#                               fall either side of it on the card
DET_OP_CHECK_ROIS = 32        # (c): the RoIs the host recomputes


def _conv_bn(L, x, size, filters, stride, groups=1, act="relu"):
    y = L.conv2d(x, filters, size, stride=stride, padding=(size - 1) // 2,
                 groups=groups, bias_attr=False)
    return L.batch_norm(y, act=act)


def mobilenet_ssd_body(L, img, scale):
    """mobilenet_ssd.py's body: MobileNet v1 to conv13 (the 19² map is
    conv11's) and the four extra blocks; the six maps."""
    def dws(x, f1, f2, stride):
        x = _conv_bn(L, x, 3, int(f1 * scale), stride, groups=int(f1 * scale))
        return _conv_bn(L, x, 1, int(f2 * scale), 1)

    def extra(x, f1, f2):
        x = _conv_bn(L, x, 1, int(f1 * scale), 1)
        return _conv_bn(L, x, 3, int(f2 * scale), 2)
    x = _conv_bn(L, img, 3, int(32 * scale), 2)
    for f1, f2, stride in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                           (128, 256, 2), (256, 256, 1), (256, 512, 2),
                           (512, 512, 1), (512, 512, 1), (512, 512, 1),
                           (512, 512, 1), (512, 512, 1)):
        x = dws(x, f1, f2, stride)
    maps = [x]
    x = dws(x, 512, 1024, 2)
    maps.append(dws(x, 1024, 1024, 1))
    for f1, f2 in ((256, 512), (128, 256), (128, 256), (64, 128)):
        maps.append(extra(maps[-1], f1, f2))
    return maps


def ssd_program(fluid, cfg, batch, train=True):
    """MobileNet-SSD: the body, priors and 3x3 loc/conf heads over the
    six maps (the first map's composed as ``multi_box_head`` composes
    them, since the reference's head takes a max size for every map;
    ratio 1.0 passed, since its ``prior_box`` starts from none), and
    ``detection_output`` over the softmaxed confidences as [B, C, P].
    With ``train``: ``ssd_loss`` once an image over its slices (the
    reference's takes one image), summed; RMSProp over the piecewise
    decay with L2Decay.  Batch norm reads the batch's statistics, served
    too (``_det_leg``).  Returns (nmsed, priors) or (loss, nmsed, priors,
    params_grads)."""
    L = fluid.layers
    c, size = cfg["classes"], cfg["size"]
    img = fluid.data("image", [batch, 3, size, size])
    maps = mobilenet_ssd_body(L, img, cfg["scale"])
    box0, var0 = L.prior_box(maps[0], img, [cfg["min_sizes"][0]],
                             aspect_ratios=[1.0, 2.0], flip=True, clip=True)
    n0 = box0.shape[2]

    def rows(t, k):
        return L.reshape(L.transpose(t, [0, 2, 3, 1]), [batch, -1, k])
    loc0 = rows(L.conv2d(maps[0], n0 * 4, 3, padding=1), 4)
    conf0 = rows(L.conv2d(maps[0], n0 * c, 3, padding=1), c)
    locs, confs, box, var = L.multi_box_head(
        maps[1:], img, size, c, [[1.0, 2.0, 3.0]] * 5,
        min_sizes=cfg["min_sizes"][1:], max_sizes=cfg["max_sizes"],
        flip=True, clip=True)
    locs = L.concat([loc0, locs], 1)
    confs = L.concat([conf0, confs], 1)
    box = L.concat([L.reshape(box0, [-1, 4]), box], 0)
    var = L.concat([L.reshape(var0, [-1, 4]), var], 0)
    nmsed = L.detection_output(
        locs, L.transpose(L.softmax(confs), [0, 2, 1]), box, var,
        nms_threshold=cfg["nms_threshold"], nms_top_k=cfg["nms_top_k"],
        keep_top_k=cfg["keep_top_k"], score_threshold=cfg["score"])
    if not train:
        return nmsed, box
    g = cfg["gts"]
    gt_box = fluid.data("gt_box", [batch, g, 4])
    gt_label = fluid.data("gt_label", [batch, g, 1], "int64")

    def image(t, i, shape=None):
        t = L.slice(t, axes=[0], starts=[i], ends=[i + 1])
        return t if shape is None else L.reshape(t, shape)
    loss = L.sums([L.reduce_sum(L.ssd_loss(
        image(locs, i), image(confs, i), image(gt_box, i, [g, 4]),
        image(gt_label, i, [g, 1]), box, var)) for i in range(batch)])
    lr = L.piecewise_decay(cfg["boundaries"],
                           [cfg["lr"] * s for s in cfg["lr_scales"]])
    _, pg = fluid.optimizer.RMSProp(
        learning_rate=lr,
        regularization=fluid.regularizer.L2Decay(cfg["l2"])).minimize(loss)
    return loss, nmsed, box, pg


def ssd_feed(cfg, batch, seed, train=True):
    """Images from the seed; 1 to ``gts`` ground-truth boxes an image in
    [0, 1]² with labels in [1, classes), the rest zero rows."""
    rng = np.random.RandomState(seed)
    size, g = cfg["size"], cfg["gts"]
    feed = {"image": rng.randn(batch, 3, size, size).astype("float32")}
    if not train:
        return feed
    box = np.zeros((batch, g, 4), "float32")
    label = np.zeros((batch, g, 1), "int64")
    for i in range(batch):
        n = rng.randint(1, g + 1)
        xy = rng.uniform(0.0, 0.7, (n, 2))
        wh = rng.uniform(0.1, 0.5, (n, 2))
        box[i, :n] = np.clip(np.concatenate([xy, xy + wh], 1), 0.0, 1.0)
        label[i, :n, 0] = rng.randint(1, cfg["classes"], n)
    feed.update(gt_box=box, gt_label=label)
    return feed


def _darknet_conv(L, x, filters, size, stride):
    y = L.conv2d(x, filters, size, stride=stride, padding=(size - 1) // 2,
                 bias_attr=False)
    return L.leaky_relu(L.batch_norm(y), alpha=0.1)


def darknet53(L, img, width, stages):
    """DarkNet-53: a 3x3 stem, then a stride-2 conv and residual blocks
    (1x1 halving, 3x3 back) a stage; the last three stages' outputs
    (strides 8, 16, 32)."""
    x = _darknet_conv(L, img, width, 3, 1)
    outs = []
    for i, n in enumerate(stages):
        ch = width * 2 ** (i + 1)
        x = _darknet_conv(L, x, ch, 3, 2)
        for _ in range(n):
            y = _darknet_conv(L, x, ch // 2, 1, 1)
            x = L.elementwise_add(x, _darknet_conv(L, y, ch, 3, 1))
        outs.append(x)
    return outs[-3:]


def _yolo_anchors(cfg, mask):
    return [cfg["anchors"][2 * k + j] for k in mask for j in (0, 1)]


def yolov3_program(fluid, cfg, batch, train=True):
    """YOLOv3: DarkNet-53 and PaddleDetection's head (at each scale from
    stride 32 down, a detection block of 1x1/3x3 pairs, the output conv
    to A (5 + C) channels, the route to the next scale upsampled 2x and
    concatenated); ``yolo_box`` on each scale and ``matrix_nms`` over
    the class-major scores.  With ``train``: one ``yolov3_loss`` a
    scale, each averaged over the batch, summed; Momentum with L2Decay.
    Batch norm reads the batch's statistics, served too.  Returns
    (nmsed,) or (loss, nmsed, params_grads)."""
    L = fluid.layers
    c, size = cfg["classes"], cfg["size"]
    img = fluid.data("image", [batch, 3, size, size])
    blocks = darknet53(L, img, cfg["width"], cfg["stages"])[::-1]
    na = len(cfg["masks"][0])
    outputs, route = [], None
    for i, x in enumerate(blocks):
        if i > 0:
            x = L.concat([route, x], axis=1)
        ch = cfg["width"] * 16 // 2 ** i
        for _ in range(2):
            x = _darknet_conv(L, x, ch, 1, 1)
            x = _darknet_conv(L, x, ch * 2, 3, 1)
        route = _darknet_conv(L, x, ch, 1, 1)
        tip = _darknet_conv(L, route, ch * 2, 3, 1)
        outputs.append(L.conv2d(tip, na * (5 + c), 1))
        if i < len(blocks) - 1:
            route = L.resize_nearest(
                _darknet_conv(L, route, ch // 2, 1, 1), scale=2.0)
    im_size = fluid.data("im_size", [batch, 2], "int32")
    boxes, scores = [], []
    for out, mask, down in zip(outputs, cfg["masks"], cfg["downsample"]):
        b, s = L.yolo_box(out, im_size, _yolo_anchors(cfg, mask), c,
                          cfg["conf_thresh"], down)
        boxes.append(b)
        scores.append(L.transpose(s, [0, 2, 1]))
    nmsed = L.matrix_nms(L.concat(boxes, 1), L.concat(scores, 2),
                         cfg["score"], cfg["score"], -1, cfg["keep_top_k"],
                         background_label=-1, return_rois_num=False)
    if not train:
        return (nmsed,)
    gt_box = fluid.data("gt_box", [batch, cfg["gts"], 4])
    gt_label = fluid.data("gt_label", [batch, cfg["gts"]], "int64")
    loss = L.sums([L.reduce_mean(L.yolov3_loss(
        out, gt_box, gt_label, cfg["anchors"], mask, c,
        cfg["ignore_thresh"], down))
        for out, mask, down in zip(outputs, cfg["masks"],
                                   cfg["downsample"])])
    _, pg = fluid.optimizer.Momentum(
        learning_rate=cfg["lr"], momentum=cfg["momentum"],
        regularization=fluid.regularizer.L2Decay(cfg["l2"])).minimize(loss)
    return loss, nmsed, pg


def yolov3_feed(cfg, batch, seed, train=True):
    """Images from the seed, ``im_size`` the input's; 1 to ``gts``
    ground truths an image as (cx, cy, w, h) in [0, 1] with labels in
    [0, classes), the rest zero rows."""
    rng = np.random.RandomState(seed)
    size, g = cfg["size"], cfg["gts"]
    feed = {"image": rng.randn(batch, 3, size, size).astype("float32"),
            "im_size": np.full((batch, 2), size, "int32")}
    if not train:
        return feed
    box = np.zeros((batch, g, 4), "float32")
    label = np.zeros((batch, g), "int64")
    for i in range(batch):
        n = rng.randint(1, g + 1)
        box[i, :n] = np.concatenate([rng.uniform(0.1, 0.9, (n, 2)),
                                     rng.uniform(0.05, 0.5, (n, 2))], 1)
        label[i, :n] = rng.randint(0, cfg["classes"], n)
    feed.update(gt_box=box, gt_label=label)
    return feed


def kept_detections(out, thr):
    """{image x 1,000,003 + class: rows [score, x1, y1, x2, y2]} of the
    NMS rows [B, N, 6] scoring past ``thr``."""
    out = np.asarray(out)
    b, n = np.nonzero(out[..., 1] > thr)
    rows = out[b, n]
    keys = b.astype(np.int64) * 1_000_003 + rows[:, 0].astype(np.int64)
    order = np.argsort(keys, kind="stable")
    keys, rows = keys[order], rows[order, 1:]
    uniq, start = np.unique(keys, return_index=True)
    return dict(zip(uniq.tolist(), np.split(rows, start[1:])))


def detection_error(got, want, thr, margin, tol, window=16):
    """Each detection scoring past ``thr + margin`` in one run matched in
    the other's past ``thr`` by its box (same image and class; sought
    among the ``window`` rows nearest in x1).  Returns the largest box
    error over ``tol`` of the largest |coordinate| (1e6 where a group has
    no counterpart: rows this close to the threshold may fall either side
    of it), and the share of matched rows whose score moved more than
    ``tol``, over 1e-3: matrix NMS decays a score by its IoU with the
    better-scored boxes, and where two overlapping boxes' scores tie
    within float32 noise the two runs order them differently (2 rows of
    160,165 in YOLOv3's host check on the CPU)."""
    scale = tol * max(1.0, float(np.abs(np.asarray(want)[..., 2:]).max()))
    box_err, moved, rows_seen = 0.0, 0, 0
    for a, b in ((got, want), (want, got)):
        strict, loose = kept_detections(a, thr + margin), \
            kept_detections(b, thr)
        for key, rows in strict.items():
            other = loose.get(key)
            if other is None:
                return 1e6, 1e6
            other = other[np.argsort(other[:, 1], kind="stable")]
            pos = np.searchsorted(other[:, 1], rows[:, 1])
            cand = np.clip(pos[:, None] + np.arange(-window // 2, window // 2),
                           0, len(other) - 1)
            d = np.abs(rows[:, None, 1:] - other[cand][..., 1:]).max(-1)
            best = d.argmin(1)
            box_err = max(box_err, float(d.min(1).max()) / scale)
            score = other[cand[np.arange(len(rows)), best], 0]
            moved += int((np.abs(rows[:, 0] - score) > tol).sum())
            rows_seen += len(rows)
    return min(box_err, 1e6), moved / max(rows_seen, 1) / 1e-3


@contextlib.contextmanager
def _priors_max_first():
    """The twin of (a): the max size's square first in each cell (the
    order of Paddle's own priors), so the heads pair with other
    priors."""
    import torch

    def wrap(orig):
        def fn(ins, attrs, ctx):
            out = orig(ins, attrs, ctx)
            if not attrs.get("max_sizes"):
                return out
            return {k: [torch.cat([v[0][:, :, -1:], v[0][:, :, :-1]], 2)]
                    for k, v in out.items()}
        return fn
    with _swapped_op("prior_box", wrap):
        yield


@contextlib.contextmanager
def _yolo_masks_reversed():
    """The twin of (b): ``yolov3_loss`` reads its mask's anchors in
    reverse order, so each ground truth trains another anchor's
    channels."""
    def wrap(orig):
        return lambda ins, attrs, ctx: orig(
            ins, dict(attrs, anchor_mask=list(attrs["anchor_mask"])[::-1]),
            ctx)
    with _swapped_op("yolov3_loss", wrap):
        yield


def _det_margins(cfg):
    """``_margins`` at ``cfg``'s cosine tolerance, and the first step's
    detections' boxes and scores (``detection_error``)."""
    def margins(got, want):
        out = _margins(got, want, cfg["cos_tol"])
        out["detection boxes"], out["detection scores"] = detection_error(
            got["nmsed"], want["nmsed"], cfg["score"], DET_SCORE_MARGIN,
            DET_CARD_TOL)
        return out
    return margins


def _det_leg(label, build, cfg, batch, feed_fn, host_cfg, twin, seed,
             serve, card):
    """One detector: ``serve`` images through its NMS head from the
    startup state, profiled, batch norm on the batch's statistics (the
    weights are random, and with the startup's moving statistics, 0 and
    1, DarkNet-53's 75 layers overflow float32; a few steps on one batch
    do not settle them); the training step at full width (SEQ_TIMED steps
    timed and profiled by ``_seq_timed``, every counted kernel at 0);
    card against host at ``host_cfg`` (its ``host_batch`` images,
    ``host_steps`` steps from the host's startup values: losses, the
    first step's gradients, the first step's detections) with ``twin``;
    two full-width steps from one state bit for bit.  Returns (the
    launches, the numbers)."""
    import torch
    from paddle_tpu_torch import fluid

    t0 = time.perf_counter()
    main, startup, fetches, _ = _book_program(build, False, cfg=cfg,
                                              batch=batch)
    n_params = sum(math.prod(p.shape)
                   for p in main.global_block().all_parameters())
    place = fluid.CUDAPlace(0)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)

    smain, _, sfetch, _ = _book_program(build, False, cfg=cfg, batch=serve,
                                        train=False)
    sfeed = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             feed_fn(cfg, serve, seed + 1, train=False).items()}
    served = {}

    def serve_call():
        served["out"] = exe.run(smain, feed=sfeed, fetch_list=[sfetch[0]],
                                scope=scope)[0]
    (host_ms, busy, idle, kern, by_class), serve_launches = _counted_run(
        f"{label} serving", lambda: _profile(serve_call, 1, warmup=1,
                                             host_ops=False), {})
    kept = np.asarray(served["out"])
    n_kept = int((kept[..., 1] > cfg["score"]).sum())
    serving = {"host_ms": host_ms, "busy_ms": busy, "idle": idle,
               "kernels": kern, "rate": serve / host_ms * 1e3,
               "rows": list(kept.shape), "kept": n_kept}
    _p(f"{label} serving: {serve} images through the NMS head from the "
       f"startup state, host {host_ms:.3f} ms a batch, device busy "
       f"{busy:.3f} ms, idle share {idle:.4f}, {kern:.0f} kernels, "
       f"{serve / host_ms * 1e3:.1f} images/s; rows {list(kept.shape)}, "
       f"{n_kept} past the score threshold {cfg['score']}  [{card}]")
    _print_classes(by_class, "batch")
    if not np.isfinite(kept).all():
        raise SystemExit(f"chip_smoke: {label}'s detections are not finite")

    loss = fetches[0]
    feed = feed_fn(cfg, batch, seed)
    dev_feed = {k: torch.from_numpy(v).to(DEVICE) for k, v in feed.items()}

    def step():
        return float(exe.run(main, feed=dev_feed, fetch_list=[loss],
                             scope=scope)[0])
    launches, out = _seq_timed(f"{label} step", step, batch, "images", card)
    out.update(params=n_params, serve=serving)
    extra = ""
    if build is ssd_program:
        out["priors"] = int(fetches[2].shape[0])
        extra = (f", {out['priors']} priors (the published head: "
                 f"{SSD_PRIORS})")
    _p(f"{label}: {n_params} parameters, batch {batch} of 3 x "
       f"{cfg['size']}^2, {cfg['classes']} classes{extra}  [{card}]")

    t = time.perf_counter()
    hb = host_cfg["host_batch"]
    hmain, hstart, hfetch, _ = _book_program(build, False, cfg=host_cfg,
                                             batch=hb)
    hpg = hfetch[-1]
    init = _startup_state(hmain, hstart, fluid.CPUPlace())
    feeds = [feed_fn(host_cfg, hb, seed + 2 + i)
             for i in range(host_cfg["host_steps"])]
    fetch = [hfetch[0], hfetch[1]] + [g for _, g in hpg]

    def unpack(v):
        return {"nmsed": v[1], "grads": v[2:]}

    def run(p, twin_cm=None):
        return _seq_run(hmain, fetch, init, p, feeds, unpack, twin_cm)
    card_r, host_r = run(fluid.CUDAPlace(0)), run(fluid.CPUPlace())
    ok, misses = _twins_report(
        label, lambda tw: run(fluid.CPUPlace(), tw), host_r, card_r, card,
        twins=(twin,), margins=_det_margins(host_cfg))
    n_host = sum(len(v) for v in kept_detections(
        host_r["nmsed"], host_cfg["score"] + DET_SCORE_MARGIN).values())
    _p(f"{label}: card vs host at {host_cfg['size']}^2, {hb} images, "
       f"{len(feeds)} steps in {time.perf_counter() - t:.1f} s: losses card "
       f"{card_r['losses']}, host {host_r['losses']}; {n_host} host "
       f"detections past the margin; the first step's gradients, largest "
       f"relative L2 errors {_worst_grads(hpg, card_r, host_r)}")
    out["card_vs_host"] = {"ok": ok, "misses": misses, "detections": n_host}
    out["differ"] = _seq_determinism(label, main, startup, [loss],
                                     feed_fn(cfg, batch, seed + 4), card)
    if out["differ"]:
        raise SystemExit(f"chip_smoke: two {label} steps from one state "
                         f"differ in {out['differ']}")
    _p(f"phase 4u {label}: {time.perf_counter() - t0:.1f} s")
    return {"train": launches, "serve": serve_launches}, out


def _fpn_anchors(level):
    """Faster R-CNN R50-FPN at 800 x 1333 (padded to 800 x 1344): level
    ``level``'s map and its anchors (size 2^(level+3), ratios 0.5, 1,
    2, stride 2^level) as [H, W, 3, 4]."""
    stride = 2 ** level
    h, w = -(-800 // stride), -(-1344 // stride)
    ys, xs = np.meshgrid((np.arange(h) + 0.5) * stride,
                         (np.arange(w) + 0.5) * stride, indexing="ij")
    size = 2.0 ** (level + 3)
    base = np.array([[-size * r ** 0.5 / 2, -size / r ** 0.5 / 2,
                      size * r ** 0.5 / 2, size / r ** 0.5 / 2]
                     for r in (0.5, 1.0, 2.0)])
    ctr = np.stack([xs, ys, xs, ys], -1)[:, :, None]
    return h, w, (ctr + base).astype("float32")


def _det_boxes(rng, n, extent, size=(16.0, 400.0)):
    xy = rng.uniform(0, extent - size[0], (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, extent)], 1) \
        .astype("float32")


def _det_op_cases():
    """(c): the 34 op types at the shapes of the slice's paths: the RPN,
    RoI and FPN ops at Faster R-CNN R50-FPN's (800 x 1333, 512 RoIs an
    image, 256 channels, 7 x 7; R-FCN's 81 x 49 position-sensitive maps
    at stride 16), the rest at (a)'s and (b)'s.  {label: (op, inputs,
    attrs, the inputs the host recomputes or None)}."""
    rng = np.random.RandomState(SEED + 95)

    def r(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype("float32")

    def u(*shape):
        return rng.uniform(0, 1, shape).astype("float32")
    # the P2 to P6 maps' 89,523 positions as one map of 3 anchors each
    all_anchors = np.concatenate([_fpn_anchors(level)[2].reshape(-1, 4)
                                  for level in range(2, 7)])
    n = len(all_anchors) // 3
    rpn = {"Scores": r(1, 3, n, 1), "BboxDeltas": r(1, 12, n, 1, scale=0.1),
           "ImInfo": np.array([[800, 1344, 1]], "float32"),
           "Anchors": all_anchors.reshape(n, 1, 3, 4),
           "Variances": np.ones((n, 1, 3, 4), "float32")}
    rpn_attrs = {"pre_nms_topN": 2000, "post_nms_topN": 1000,
                 "nms_thresh": 0.7}
    cases = {"generate_proposals": ("generate_proposals", rpn, rpn_attrs,
                                    None)}
    gts = _det_boxes(rng, 8, 800.0)
    rois = _det_boxes(rng, 512, 800.0)
    quads = rois[:, [0, 1, 2, 1, 2, 3, 0, 3]] + r(512, 8, scale=4.0)

    def sub(ins, k=DET_OP_CHECK_ROIS):
        return {s: (v[:k] if s in ("ROIs", "Trans") else v)
                for s, v in ins.items()}
    p2 = r(1, 256, 200, 336)
    c4 = r(1, 256, 50, 84)
    ps = r(1, 81 * 49, 50, 84)
    pool = {"pooled_height": 7, "pooled_width": 7}
    cases.update({
        "rpn_target_assign": ("rpn_target_assign",
                              {"Anchor": all_anchors, "GtBoxes": gts},
                              {"rpn_positive_overlap": 0.7,
                               "rpn_negative_overlap": 0.3}, None),
        "roi_align": ("roi_align", {"X": p2, "ROIs": rois},
                      dict(pool, spatial_scale=0.25, sampling_ratio=2), "sub"),
        "roi_pool": ("roi_pool", {"X": c4, "ROIs": rois},
                     dict(pool, spatial_scale=1 / 16), "sub"),
        "prroi_pool": ("prroi_pool", {"X": c4, "ROIs": rois},
                       dict(pool, spatial_scale=1 / 16), "sub"),
        "psroi_pool": ("psroi_pool", {"X": ps, "ROIs": rois},
                       dict(pool, spatial_scale=1 / 16, output_channels=81),
                       "sub"),
        "deformable_psroi_pooling": (
            "deformable_psroi_pooling",
            {"X": ps, "ROIs": rois, "Trans": r(512, 2, 7, 7, scale=0.1)},
            dict(pool, spatial_scale=1 / 16, output_dim=81, trans_std=0.1),
            "sub"),
        "roi_perspective_transform": (
            "roi_perspective_transform", {"X": c4, "ROIs": quads},
            {"transformed_height": 7, "transformed_width": 7,
             "spatial_scale": 1 / 16}, "sub"),
        "distribute_fpn_proposals": (
            "distribute_fpn_proposals",
            {"FpnRois": _det_boxes(rng, 2000, 1333.0, (8.0, 800.0))},
            {"min_level": 2, "max_level": 5, "refer_level": 4,
             "refer_scale": 224}, None),
        "collect_fpn_proposals": (
            "collect_fpn_proposals",
            {"MultiLevelRois": [_det_boxes(rng, 1000, 800.0)
                                for _ in range(5)],
             "MultiLevelScores": [u(1000, 1) for _ in range(5)]},
            {"post_nms_topN": 2000}, None),
        "generate_proposal_labels": (
            "generate_proposal_labels",
            {"RpnRois": _det_boxes(rng, 2000, 800.0), "GtClasses":
             rng.randint(1, 81, (8, 1)).astype("int64"),
             "IsCrowd": np.zeros((8, 1), "int64"), "GtBoxes": gts,
             "ImInfo": np.array([[800, 1344, 1]], "float32")},
            {"batch_size_per_im": 512, "fg_fraction": 0.25}, None),
        "generate_mask_labels": (
            "generate_mask_labels",
            {"Rois": rois, "GtSegms": (u(8, 800, 1344) > 0.5)
             .astype("int64"), "LabelsInt32": rng.randint(
                 0, 81, (512, 1)).astype("int64"),
             "MatchIndices": rng.randint(0, 8, 512).astype("int64")},
            {"resolution": 28}, None),
        "box_decoder_and_assign": (
            "box_decoder_and_assign",
            {"PriorBox": rois, "PriorBoxVar": np.tile(
                [[0.1, 0.1, 0.2, 0.2]], (512, 1)).astype("float32"),
             "TargetBox": r(512, 81 * 4, scale=0.5),
             "BoxScore": u(512, 81)}, {"box_clip": 4.135}, None),
        "box_clip": ("box_clip", {"Input": _det_boxes(rng, 1000, 1500.0),
                                  "ImInfo": np.array([[800, 1333, 1]],
                                                     "float32")}, {}, None),
        "anchor_generator": ("anchor_generator", {"Input": p2},
                             {"anchor_sizes": [32.0],
                              "aspect_ratios": [0.5, 1.0, 2.0],
                              "stride": [4.0, 4.0]}, None),
        "generate_proposals_v2": ("generate_proposals_v2", rpn, rpn_attrs,
                                  None),
    })
    # RetinaNet at 800 x 1333: P3 to P7, 9 anchors a cell, 80 classes
    hw = [(-(-800 // 2 ** l), -(-1344 // 2 ** l)) for l in range(3, 8)]
    cases["retinanet_detection_output"] = (
        "retinanet_detection_output",
        {"BBoxes": [_det_boxes(rng, 9 * h * w, 800.0)[None] for h, w in hw],
         "Scores": [u(1, 9 * h * w, 80) * 0.2 for h, w in hw],
         "Anchors": [_det_boxes(rng, 9 * h * w, 800.0) for h, w in hw],
         "ImInfo": np.array([[800, 1344, 1]], "float32")},
        {"score_threshold": 0.05, "keep_top_k": 100}, None)
    # (a)'s shapes: 1,917 priors, 8 ground truths, 21 classes
    priors = np.clip(_det_boxes(rng, SSD_PRIORS, 1.0, (0.05, 0.9)), 0, 1)
    pvar = np.tile([[0.1, 0.1, 0.2, 0.2]], (SSD_PRIORS, 1)) \
        .astype("float32")
    gt = np.clip(_det_boxes(rng, 8, 1.0, (0.1, 0.5)), 0, 1)
    iou = _np_iou(gt, priors)
    match = np.where(iou.max(0) > 0.5, iou.argmax(0), -1)[None]
    cases.update({
        "prior_box": ("prior_box", {"Input": r(1, 512, 19, 19),
                                    "Image": r(1, 3, 300, 300)},
                      {"min_sizes": [60.0], "aspect_ratios": [1.0, 2.0],
                       "flip": True}, None),
        "density_prior_box": ("density_prior_box",
                              {"Input": r(1, 512, 19, 19),
                               "Image": r(1, 3, 300, 300)},
                              {"fixed_sizes": [30.0, 60.0],
                               "densities": [2, 1],
                               "fixed_ratios": [1.0, 2.0]}, None),
        "iou_similarity": ("iou_similarity", {"X": gt, "Y": priors}, {},
                           None),
        "bipartite_match": ("bipartite_match",
                            {"DistMat": iou.astype("float32")},
                            {"match_type": "per_prediction",
                             "dist_threshold": 0.5}, None),
        "target_assign": ("target_assign",
                          {"X": gt[None], "MatchIndices":
                           match.astype("int64")}, {"mismatch_value": 0.0},
                          None),
        "box_coder": ("box_coder", {"PriorBox": priors, "PriorBoxVar": pvar,
                                    "TargetBox": r(SSD_BATCH, SSD_PRIORS, 4,
                                                   scale=0.3)},
                      {"code_type": "decode_center_size"}, None),
        "mine_hard_examples": ("mine_hard_examples",
                               {"ClsLoss": u(SSD_BATCH, SSD_PRIORS),
                                "MatchIndices": np.repeat(
                                    match, SSD_BATCH, 0).astype("int64")},
                               {"neg_pos_ratio": 3.0}, None),
        "matrix_nms": ("matrix_nms",
                       {"BBoxes": np.repeat(priors[None], SSD_SERVE, 0),
                        "Scores": u(SSD_SERVE, 21, SSD_PRIORS)},
                       {"score_threshold": 0.01}, None),
        "locality_aware_nms": ("locality_aware_nms",
                               {"BBoxes": priors[None],
                                "Scores": u(1, 21, SSD_PRIORS)},
                               {"nms_threshold": 0.45,
                                "score_threshold": 0.01}, None),
        "detection_map": ("detection_map",
                          {"DetectRes": np.concatenate(
                              [rng.randint(0, 21, (200, 1)), u(200, 1),
                               _det_boxes(rng, 200, 1.0, (0.05, 0.5))],
                              1).astype("float32"),
                           "Label": np.concatenate(
                               [rng.randint(0, 21, (40, 1)),
                                _det_boxes(rng, 40, 1.0, (0.05, 0.5))],
                               1).astype("float32")},
                          {"overlap_threshold": 0.5}, None),
    })
    # (b)'s shapes: the stride-8 head of 8 images at 608², 80 classes
    c = 3 * (5 + 80)
    cases.update({
        "yolo_box": ("yolo_box", {"X": r(YOLO_BATCH, c, 76, 76),
                                  "ImgSize": np.full((YOLO_BATCH, 2), 608,
                                                     "int32")},
                     {"anchors": YOLO["anchors"][:6], "class_num": 80,
                      "conf_thresh": 0.005, "downsample_ratio": 8}, None),
        "yolov3_loss": ("yolov3_loss",
                        {"X": r(YOLO_BATCH, c, 76, 76),
                         "GTBox": yolov3_feed(dict(YOLO, size=8), YOLO_BATCH,
                                              SEED + 96)["gt_box"],
                         "GTLabel": rng.randint(0, 80, (YOLO_BATCH, 8))
                         .astype("int64")},
                        {"anchors": YOLO["anchors"], "anchor_mask": [0, 1, 2],
                         "class_num": 80, "ignore_thresh": 0.7,
                         "downsample_ratio": 8}, None),
        "polygon_box_transform": ("polygon_box_transform",
                                  {"Input": r(YOLO_BATCH, 8, 152, 152)}, {},
                                  None),
        "deformable_conv": ("deformable_conv",
                            {"Input": r(2, 256, 38, 38),
                             "Offset": r(2, 18, 38, 38, scale=0.7),
                             "Mask": u(2, 9, 38, 38),
                             "Filter": r(256, 256, 3, 3, scale=0.02)},
                            {"strides": [1, 1], "paddings": [1, 1]}, None),
        "deformable_conv_v1": ("deformable_conv_v1",
                               {"Input": r(2, 256, 38, 38),
                                "Offset": r(2, 18, 38, 38, scale=0.7),
                                "Filter": r(256, 256, 3, 3, scale=0.02)},
                               {"strides": [1, 1], "paddings": [1, 1]},
                               None),
    })
    return {k: (op, ins, attrs, sub(ins) if check == "sub" else None)
            for k, (op, ins, attrs, check) in cases.items()}


def _np_iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), -1)
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter,
                              1e-10)


# the pooled and sampled ops whose gradients gather: two card runs of
# each generic_grad bit for bit
DET_GATHER_GRADS = ("roi_align", "roi_pool", "prroi_pool", "psroi_pool",
                    "deformable_psroi_pooling", "roi_perspective_transform",
                    "deformable_conv", "deformable_conv_v1", "yolov3_loss")


def _det_ops_on_the_card(card):
    """(c) the 34 op types on the card: each one's forward ms at the
    case's shapes (CUDA events); against the host, forward and
    ``generic_grad``, within DET_CARD_TOL of each output's largest
    |value| (the RoI ops on their first DET_OP_CHECK_ROIS RoIs, which the
    host recomputes); the gathering ops' gradients twice on the card, bit
    for bit; ``multiclass_nms`` and ``multiclass_nms2`` raise."""
    from paddle_tpu_torch.ops.registry import get_op

    import torch
    from paddle_tpu_torch.ops.registry import LoweringContext

    worst, ms, same = {}, {}, {}
    rng = np.random.RandomState(SEED + 97)
    ctx = LoweringContext(device=torch.device(DEVICE))
    for label, (op, ins, attrs, check) in _det_op_cases().items():
        dev_ins = {k: [torch.from_numpy(np.array(a)).to(DEVICE)
                       for a in (v if isinstance(v, list) else [v])]
                   for k, v in ins.items()}
        ms[label] = _ms(lambda: get_op(op).fn(dev_ins, dict(attrs), ctx), 3,
                        warmup=1)
        del dev_ins
        worst[label] = _op_card_err(op, check or ins, attrs, DET_CARD_TOL,
                                    rng)
        if op in DET_GATHER_GRADS:
            opdef = get_op(op)
            slots = [k for k, v in ins.items()
                     if k not in opdef.nondiff_inputs
                     and np.asarray(v).dtype.kind == "f"]
            outs = _op_run(op, ins, attrs, DEVICE)
            cots = {k: rng.randn(*v[0].shape).astype("float32")
                    for k, v in outs.items()
                    if k not in opdef.nondiff_outputs
                    and v[0].is_floating_point()}
            g = [{k: _host(v[0]) for k, v in _op_run(
                op, ins, attrs, DEVICE, (slots, cots)).items()}
                for _ in range(2)]
            same[label] = all(np.array_equal(g[0][k], g[1][k]) for k in g[0])
    raised = []
    for op in ("multiclass_nms", "multiclass_nms2"):
        try:
            _op_run(op, {"BBoxes": np.zeros((1, 4, 4), "float32"),
                         "Scores": np.zeros((1, 2, 4), "float32")}, {},
                    DEVICE)
        except NotImplementedError:
            raised.append(op)
    types = {c[0] for c in _det_op_cases().values()} | set(raised)
    _p(f"detection op types on the card ({len(types)} types), forward ms "
       + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f"  [{card}]")
    _p("detection op types on the card against the host, forward and "
       f"generic_grad, error / {DET_CARD_TOL} of the largest |value| (under "
       "1 passes): " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
       + f"; gradients bit for bit in two card runs: {same}; raising "
       f"{raised}  [{card}]")
    if max(worst.values()) > 1 or not all(same.values()) \
            or len(raised) != 2 or len(types) != 34:
        raise SystemExit("chip_smoke: a detection op type disagrees with "
                         "the host, is not deterministic on the card or "
                         "does not raise")
    return {"worst": worst, "ms": ms, "same": same, "types": len(types)}


def phase_detection_tier(card):
    """Phase 4u, the detection tier: (a) MobileNet-SSD at 300², trained
    and served through ``detection_output``; (b) YOLOv3 DarkNet-53 at
    608², trained and served through ``yolo_box`` and ``matrix_nms``;
    (c) the 34 op types on the card against the host.  Returns the
    counted launches of (a)'s and (b)'s timed steps and serving, and the
    numbers."""
    ssd_launches, ssd = _det_leg(
        "MobileNet-SSD", ssd_program, SSD, SSD_BATCH, ssd_feed, SSD_HOST,
        ("max-size-first priors", _priors_max_first), SEED + 100, SSD_SERVE,
        card)
    yolo_launches, yolo = _det_leg(
        "YOLOv3", yolov3_program, YOLO, YOLO_BATCH, yolov3_feed, YOLO_HOST,
        ("reversed anchor masks", _yolo_masks_reversed), SEED + 110,
        YOLO_SERVE, card)
    t = time.perf_counter()
    ops = _det_ops_on_the_card(card)
    _p(f"phase 4u (c): {time.perf_counter() - t:.1f} s")
    return ({"ssd": ssd_launches["train"], "yolov3": yolo_launches["train"],
             "ssd_serve": ssd_launches["serve"],
             "yolov3_serve": yolo_launches["serve"]},
            {"ssd": ssd, "yolov3": yolo, "ops": ops})


# --- phase 4v: the PaddleBox CTR tier ----------------------------------------
# BASELINE.md config 5's width: 26 slots of 5 ids, dim 16, 13 dense
# features, batch 4096; ids Zipf(1.1) over 1e6 values a slot, placed in
# the 2^40 feasign space as slot * 2^32 + id
JOIN = dict(slots=26, dim=16, seq=5, dense=13, batch=4096, warmup=3,
            steps=20, eval_batches=4, ids=1_000_000, max_rank=3, rank_fc=64,
            rank_out=32, batch_fc=8, hidden=(512, 256, 128), lr=1e-3,
            table="ctr_join")
JOIN_TAGS, JOIN_FILTER_TAGS = 8, (1, 4, 6)   # two tags a row of 8 values
JOIN_RANK0 = 0.1               # the share of instances of rank 0
JOIN_HOST = dict(JOIN, slots=4, dim=8, batch=256, steps=3, ids=2048,
                 table="ctr_join_host")
JOIN_CACHE_ROWS = 1 << 22      # phase 4k's cache: the pass must fit it
JOIN_HOST_RTOL = dict(loss=1e-4, cosine=1e-4, norm=1e-4, stats=1e-5,
                      auc=1e-4)
CTR_CARD_TOL = 1e-4            # (c): of each output's largest |value|
CTR_GATHER_GRADS = ("rank_attention", "pyramid_hash",
                    "fused_embedding_seq_pool")


def ctr_join_program(fluid, cfg, train=True):
    """A PaddleBox join tower over BoxPS (``fluid.layers`` and
    ``fluid.contrib.layers`` only): ``pull_box_sparse`` of the slots,
    ``fused_seqpool_cvm``, ``data_norm`` (slot_dim = dim, scale and
    shift), ``cross_norm_layer_hadamard`` over the pooled slots,
    ``batch_fc`` over them stacked, ``rank_attention`` over an fc of the
    normalised features, ``scaled_fc`` over the five joined, fc 256 and
    128 ReLU, a logit; the sigmoid cross-entropy weighed by
    ``filter_by_instag``'s LossWeight, its mean; ``auc`` and ``ctr_metric_bundle``; Adam.  Returns (loss,
    auc, the bundle's four sums, the auc state, [(param, grad)])."""
    L, CL = fluid.layers, fluid.contrib.layers
    s, d, seq, mr = cfg["slots"], cfg["dim"], cfg["seq"], cfg["max_rank"]
    ids = [fluid.data(f"slot{i}", [-1, seq], dtype="int64")
           for i in range(s)]
    show_click = fluid.data("show_click", [-1, 2])
    dense = fluid.data("dense", [-1, cfg["dense"]])
    ins_tag = fluid.data("ins_tag", [-1, 2], dtype="int64")
    filter_tag = fluid.data("filter_tag", [len(JOIN_FILTER_TAGS)],
                            dtype="int64")
    rank_offset = fluid.data("rank_offset", [-1, 1 + 2 * mr], dtype="int32")
    label = fluid.data("label", [-1, 1])
    embs = L.pull_box_sparse(ids, d, table_name=cfg["table"])
    pooled = CL.fused_seqpool_cvm(embs, "sum", show_click)
    x = L.concat(pooled, axis=1)
    normed = L.data_norm(x, name="join_dn", slot_dim=d,
                         enable_scale_and_shift=True)
    cross = CL.cross_norm_layer_hadamard(x, fields_num=s // 2, embed_dim=d)
    per_slot = CL.batch_fc(L.stack(pooled, axis=0), [s, d, cfg["batch_fc"]],
                           None, [s, cfg["batch_fc"]], None, act="relu")
    per_slot = L.reshape(L.transpose(per_slot, [1, 0, 2]),
                         [-1, s * cfg["batch_fc"]])
    ranked = CL.rank_attention(
        L.fc(normed, cfg["rank_fc"]), rank_offset,
        [mr * mr, cfg["rank_fc"] * cfg["rank_out"]], None, max_rank=mr)
    h = L.concat([normed, cross, per_slot, ranked, dense], axis=1)
    h = CL.scaled_fc(h, cfg["hidden"][0], 0.5, 0.5, 1.0)
    for width in cfg["hidden"][1:]:
        h = L.fc(h, width, act="relu")
    logit = L.fc(h, 1)
    xent = L.sigmoid_cross_entropy_with_logits(logit, label)
    # filter_by_instag is no differentiable op in either package (its Out
    # carries no gradient): its LossWeight weighs the rows, as the
    # reference's lowering means it to
    _, weight, _ = L.filter_by_instag(xent, ins_tag, filter_tag, False)
    loss = L.mean(xent * weight)
    p = L.sigmoid(logit)
    auc, _, auc_state = L.auc(L.concat([L.scale(p, -1.0, 1.0), p], axis=1),
                              label)
    bundle = CL.ctr_metric_bundle(p, label)
    pg = []
    if train:
        _, pg = fluid.optimizer.AdamOptimizer(cfg["lr"]).minimize(loss)
    return (loss, auc) + tuple(bundle) + (auc_state, pg)


def _bounded_zipf(rng, shape, vocab, perm):
    """Zipf(ZIPF_A) over ``vocab`` values (P(k) ~ k^-a for k <= vocab)
    by its inverse CDF, through a seeded permutation of the values."""
    cdf = np.cumsum(np.arange(1, vocab + 1, dtype=np.float64) ** -ZIPF_A)
    k = np.searchsorted(cdf / cdf[-1], rng.random_sample(shape))
    return perm[np.minimum(k, vocab - 1)].astype(np.int64)


def ctr_join_raw_ids(cfg, batches, seed):
    """[batches, B, slots, seq] raw feasigns, slot * 2^32 + id: Zipf ids
    over ``cfg['ids']`` values a slot (uniform for a small host space)."""
    rng = np.random.RandomState(seed)
    shape = (batches, cfg["batch"], cfg["slots"], cfg["seq"])
    if cfg["ids"] > 100_000:
        ids = _bounded_zipf(rng, shape, cfg["ids"],
                            rng.permutation(cfg["ids"]))
    else:
        ids = rng.randint(0, cfg["ids"], shape, dtype=np.int64)
    return ids + (np.arange(cfg["slots"], dtype=np.int64) << 32)[
        None, None, :, None]


def ctr_join_feed(cfg, slots, seed):
    """One batch's feed from the cache slots of its raw ids ([B, slots,
    seq]): ``show_click``, two instance tags a row of JOIN_TAGS values and
    the filter tags, ``rank_offset`` (rank 0 for about JOIN_RANK0 of the
    instances, else 1 to max_rank, each other rank's pair present with
    probability 0.8, pointing at block (rank - 1) * max_rank + other - 1),
    the dense features and a label drawn from a logistic model of them, so
    there is something to learn."""
    rng = np.random.RandomState(seed)
    b, mr = cfg["batch"], cfg["max_rank"]
    feed = {f"slot{i}": np.ascontiguousarray(slots[:, i])
            for i in range(cfg["slots"])}
    shows = rng.randint(1, 20, (b, 1)).astype("float32")
    feed["show_click"] = np.concatenate(
        [shows, rng.binomial(shows.astype(int), 0.2).astype("float32")], 1)
    feed["ins_tag"] = rng.randint(0, JOIN_TAGS, (b, 2)).astype("int64")
    feed["filter_tag"] = np.array(JOIN_FILTER_TAGS, "int64")
    rank = rng.randint(1, mr + 1, b)
    rank[rng.random_sample(b) < JOIN_RANK0] = 0
    ro = np.full((b, 1 + 2 * mr), -1, "int32")
    ro[:, 0] = rank
    for j in range(mr):
        live = (rank > 0) & (rng.random_sample(b) < 0.8)
        ro[live, 1 + 2 * j] = j + 1
        ro[live, 2 + 2 * j] = (rank[live] - 1) * mr + j
    feed["rank_offset"] = ro
    dense = rng.randn(b, cfg["dense"]).astype("float32")
    feed["dense"] = dense
    z = dense[:, 0] + 0.5 * dense[:, 1] - 0.5
    feed["label"] = (rng.random_sample(b) < 1 / (1 + np.exp(-2 * z))) \
        .astype("float32")[:, None]
    return feed


def _adam_bucket_check(main, scope, gen, what, card):
    """``fused_adam`` over ``main``'s one bucket as its run left it (the
    parameters, moments, beta powers and lr from ``scope``, a seeded
    gradient), its op ``torch.equal`` to ``_plain_fused_adam``; made
    after the path's launch counts were read, so it counts in no path.
    Returns the largest |error|."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.ops.optimizer_ops import _plain_fused_adam
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    dev = torch.device(DEVICE)
    op, = [op for op in main.global_block().ops if op.type == "fused_adam"]
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
    equal, err = True, 0.0
    for slot, outs in plain.items():
        for got, want in zip(fused[slot], outs):
            equal &= torch.equal(got, want)
            err = max(err, (got - want).abs().max().item())
    n = sum(p.numel() for p in ins["Param"])
    _p(f"{what}: fused_adam over the program's {len(ins['Param'])} "
       f"parameters ({n} values), {launched} launch, torch.equal to its "
       f"plain version = {equal} (max |err| {err:.3e})  [{card}]")
    if launched != 1 or not equal:
        raise SystemExit(f"chip_smoke: fused_adam disagrees with its plain "
                         f"version on {what}'s bucket")
    return err


def _join_built(cfg, place, train=True):
    """(main, startup, fetches, the CompiledProgram through
    ``fuse_optimizer``) of the join tower at ``cfg``'s width."""
    from paddle_tpu_torch import fluid

    main, startup, fetches, _ = _book_program(ctr_join_program, False,
                                              cfg=cfg, train=train)
    bs = fluid.BuildStrategy()
    bs.fuse_optimizer = True
    return main, startup, fetches, fluid.CompiledProgram(main, bs)


def _join_pass(cfg, batches, seed):
    """A box wrapper for ``cfg``'s table, begin_pass over ``batches``
    batches of raw ids, their feeds.  Returns (box, cache, feeds, the
    begin_pass seconds)."""
    from paddle_tpu_torch.distributed.ps.box import get_box_wrapper

    box = get_box_wrapper(cfg["table"], dim=cfg["dim"],
                          init_kind="gaussian", init_scale=0.01)
    raw = ctr_join_raw_ids(cfg, batches, seed)
    t0 = time.perf_counter()
    cache = box.begin_pass(raw)
    begin_s = time.perf_counter() - t0
    feeds = [ctr_join_feed(cfg, box.slots_of(r.reshape(-1)).reshape(
        r.shape), seed + 100 + i) for i, r in enumerate(raw)]
    return box, cache, feeds, begin_s


def _join_snapshot(main, scope):
    """Every persistable of ``main`` in ``scope`` (the cache's Adam
    moments too), cloned where it lies."""
    import torch
    return {n: scope.find_var(n).clone()
            for n, v in main.global_block().vars.items()
            if v.persistable and isinstance(scope.find_var(n), torch.Tensor)}


def _join_train(card):
    """4v (a) and (b): the tower at JOIN's width through BoxPS (one
    begin_pass over the warm-up, timed and held-out batches), the timed
    steps with exactly one fused_adam a step, a profiled step, the eval
    pass through ``main.clone(for_test=True)``, two full-width steps
    from one state bit for bit, end_pass, and fused_adam on the bucket
    against its plain version.  Returns (the launches, the numbers)."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed.ps.box import reset_box_wrappers

    cfg = JOIN
    reset_box_wrappers()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out = {}
    with _fresh_fluid_globals():
        place = fluid.CUDAPlace(0)
        main, startup, fetches, prog = _join_built(cfg, place)
        loss, auc, bundle, auc_state = (fetches[0], fetches[1],
                                        fetches[2:6], fetches[6])
        n_params = sum(math.prod(p.shape)
                       for p in main.global_block().all_parameters()
                       if min(p.shape) > 0)
        n_train = cfg["warmup"] + cfg["steps"]
        box, cache, feeds, begin_s = _join_pass(
            cfg, n_train + cfg["eval_batches"], SEED + 120)
        n_ids = (n_train + cfg["eval_batches"]) * cfg["batch"] \
            * cfg["slots"] * cfg["seq"]
        _p(f"CTR join tower: begin_pass over {n_ids} ids of "
           f"{cfg['slots']} slots in {begin_s:.3f} s (host): "
           f"{box.pass_size} unique ids, {box.cache_rows} cache rows x "
           f"{cfg['dim']} (phase 4k's cache: {JOIN_CACHE_ROWS} rows); "
           f"{n_params} dense parameters")
        if box.cache_rows > JOIN_CACHE_ROWS:
            raise SystemExit("chip_smoke: the join tower's pass does not fit "
                             "phase 4k's cache")
        dev_feeds = [{k: torch.from_numpy(v).to(DEVICE)
                      for k, v in f.items()} for f in feeds]
        exe, scope = fluid.Executor(place), fluid.global_scope()
        exe.run(startup)
        cname = cfg["table"] + "@HBMCACHE"
        scope.set_var(cname, cache)
        del cache

        def step(f, fetch=(loss, auc)):
            return exe.run(prog, feed=f, fetch_list=list(fetch),
                           return_numpy=False)

        warm = [step(f) for f in dev_feeds[:cfg["warmup"]]]
        float(warm[-1][0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        timed, launches = _counted_run(
            "the CTR join tower's timed steps",
            lambda: [step(f) for f in dev_feeds[cfg["warmup"]:n_train]],
            {"fused_adam": cfg["steps"]})
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        losses = [float(o[0]) for o in warm + timed]
        aucs = [float(o[1]) for o in warm + timed]
        ms = wall / cfg["steps"] * 1e3
        head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
        _p(f"CTR join tower: {cfg['steps']} timed steps of {cfg['batch']} "
           f"in {wall:.3f} s: {ms:.3f} host ms/step, "
           f"{cfg['steps'] * cfg['batch'] / wall:.1f} examples/s; peak "
           f"{peak:.3f} GiB above the {base / 2 ** 30:.3f} GiB earlier "
           f"phases hold; launches {launches} (fused_adam 1 a step, every "
           f"other 0); losses {[round(x, 5) for x in losses]} (the first "
           f"five's mean {head:.5f}, the last five's {tail:.5f}); "
           f"streaming AUC {aucs[-1]:.5f}  [{card}]")
        if not np.isfinite(losses).all() or not tail < head:
            raise SystemExit("chip_smoke: the join tower's loss did not fall "
                             "or is not finite")
        prof = _profile(lambda: float(step(dev_feeds[0])[0]), 1, warmup=1,
                        host_ops=False)
        _p(f"profile CTR join tower: host {prof[0]:.3f} ms/step, device "
           f"busy {prof[1]:.3f} ms/step, idle share {prof[2]:.4f}, "
           f"{prof[3]:.0f} kernels/step  [{card}]")
        _print_classes(prof[4], "step")
        out.update(ms=ms, examples_s=cfg["steps"] * cfg["batch"] / wall,
                   peak_gib=peak, losses=losses, host_ms=prof[0],
                   busy_ms=prof[1], idle=prof[2], kernels=prof[3],
                   by_class=prof[4], begin_s=begin_s,
                   unique_ids=box.pass_size, cache_rows=box.cache_rows,
                   params=n_params)

        # (b) the eval pass: the statistics frozen, the AUC state grows
        stats = [n for n in main.global_block().vars
                 if n.startswith("join_dn.batch_")]
        before = {n: scope.find_var(n).clone() for n in stats}
        counted0 = sum(float(scope.find_var(v.name).sum()) for v in auc_state)
        test_prog = main.clone(for_test=True)
        evals = [exe.run(test_prog, feed=f, fetch_list=[auc] + list(bundle))
                 for f in dev_feeds[n_train:]]
        frozen = all(torch.equal(before[n], scope.find_var(n))
                     for n in stats)
        counted = sum(float(scope.find_var(v.name).sum())
                      for v in auc_state) - counted0
        rows = cfg["eval_batches"] * cfg["batch"]
        sq, ab, pr, q = (sum(float(e[i]) for e in evals) for i in (1, 2, 3, 4))
        _p(f"CTR join tower eval pass ({cfg['eval_batches']} held-out "
           f"batches through main.clone(for_test=True)): data_norm's "
           f"statistics unchanged: {frozen}; the AUC histograms grew by "
           f"{counted:.0f} rows (want {rows}); AUC {float(evals[-1][0]):.5f}; "
           f"bundle: MSE {sq / rows:.5f}, MAE {ab / rows:.5f}, predicted "
           f"CTR {pr / rows:.5f}, q {q:.3f}  [{card}]")
        if not frozen or counted != rows:
            raise SystemExit("chip_smoke: the join tower's eval pass moved "
                             "data_norm's statistics or missed the AUC")
        out["eval"] = dict(auc=float(evals[-1][0]), mse=sq / rows,
                           mae=ab / rows, ctr=pr / rows)

        # two full-width steps from one state, bit for bit
        snap = _join_snapshot(main, scope)
        runs = []
        for _ in range(2):
            s = fluid.Scope()
            for n, v in snap.items():
                s.set_var(n, v.clone())
            l = exe.run(prog, feed=dev_feeds[0], fetch_list=[loss], scope=s,
                        return_numpy=False)[0]
            runs.append((float(l), _join_snapshot(main, s)))
            del s
        differ = [n for n in snap if not torch.equal(runs[0][1][n],
                                                      runs[1][1][n])]
        if runs[0][0] != runs[1][0]:
            differ.append("the loss")
        _p(f"CTR join tower determinism: two full-width steps from one "
           f"state, {len(differ)} of {len(snap) + 1} persistables and the "
           f"loss differ in any bit {differ}  [{card}]")
        out["differ"] = differ
        del snap, runs
        if differ:
            raise SystemExit("chip_smoke: two join tower steps from one "
                             "state differ")

        # end_pass: the host store holds exactly the trained cache
        cache_t = scope.find_var(cname)
        uniq = box.pass_ids.copy()
        trained = cache_t[: len(uniq)].cpu().numpy()
        t0 = time.perf_counter()
        box.end_pass(cache_t)
        end_s = time.perf_counter() - t0
        same = np.array_equal(box.host.pull(uniq), trained)
        _p(f"CTR join tower: end_pass in {end_s:.3f} s (host); host rows "
           f"equal to the trained cache: {same}  [{card}]")
        if not same:
            raise SystemExit("chip_smoke: end_pass did not write the join "
                             "tower's trained rows back")
        out["end_s"] = end_s
        del trained
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 121)
        out["adam_max_abs_err"] = _adam_bucket_check(
            main, scope, gen, "the CTR join tower", card)
    reset_box_wrappers()
    torch.cuda.empty_cache()
    return launches, out


def _join_margins(got, want):
    """4v (d)'s criteria, each error over its tolerance (under 1
    passes): every loss to rtol 1e-4, the first step's gradient cosine
    and norm to 1e-4, data_norm's statistics to 1e-5 of their largest
    value, every step's AUC to 1e-4."""
    t = JOIN_HOST_RTOL
    cos, norm = _cosine(got["grads"], want["grads"])
    out = {"losses": max(abs(g - w) / abs(w) for g, w in
                         zip(got["losses"], want["losses"])) / t["loss"],
           "gradient cosine": (1 - cos) / t["cosine"],
           "gradient norm": abs(norm - 1) / t["norm"],
           "statistics": max(_worst_rel(got["stats"][n], want["stats"][n])
                             for n in want["stats"]) / t["stats"],
           "auc": max(abs(g - w) for g, w in zip(got["aucs"],
                                                   want["aucs"])) / t["auc"]}
    return out


def _join_card_vs_host(card):
    """4v (d): JOIN_HOST (4 slots, dim 8, batch 256, 3 steps, ids from a
    2048-value space, so they repeat) on the card and on the host from
    one box state and one scope; a twin reading rank_offset's pairs
    swapped (the block index as the other rank) must miss."""
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.distributed.ps.box import reset_box_wrappers

    t0 = time.perf_counter()
    cfg = JOIN_HOST
    reset_box_wrappers()
    main, startup, fetches, prog = _join_built(cfg, fluid.CPUPlace())
    box, cache, feeds, _ = _join_pass(cfg, cfg["steps"], SEED + 140)
    box.abandon_pass()
    reset_box_wrappers()
    init = _startup_state(main, startup, fluid.CPUPlace())
    init[cfg["table"] + "@HBMCACHE"] = np.asarray(cache)
    pg = fetches[-1]
    fetch = [fetches[0], fetches[1]] + [g for _, g in pg]
    stats = [n for n in main.global_block().vars
             if n.startswith("join_dn.batch_")]

    def run(place, feeds):
        scope = interop.scope_from_numpy(init, fluid.Scope(), place)
        exe = fluid.Executor(place)
        outs = [exe.run(prog, feed=f, fetch_list=fetch, scope=scope)
                for f in feeds]
        return {"losses": [float(o[0]) for o in outs],
                "aucs": [float(o[1]) for o in outs],
                "grads": [np.asarray(g) for g in outs[0][2:]],
                "stats": interop.scope_to_numpy(scope, stats)}

    host = run(fluid.CPUPlace(), feeds)
    got = run(fluid.CUDAPlace(0), feeds)
    swapped = []
    for f in feeds:
        ro = f["rank_offset"].copy()
        ro[:, 1::2], ro[:, 2::2] = f["rank_offset"][:, 2::2], \
            f["rank_offset"][:, 1::2]
        swapped.append(dict(f, rank_offset=ro))
    twin = run(fluid.CUDAPlace(0), swapped)
    ok, miss = _join_margins(got, host), _join_margins(twin, host)
    fmt = ", ".join
    _p(f"CTR join tower card vs host at {cfg['slots']} slots, dim "
       f"{cfg['dim']}, batch {cfg['batch']}, {cfg['steps']} steps, ids from "
       f"{cfg['ids']} values a slot, in {time.perf_counter() - t0:.1f} s: "
       f"losses card {got['losses']}, host {host['losses']}; AUC card "
       f"{got['aucs']}, host {host['aucs']}  [{card}]")
    _p("CTR join tower card vs host, error / tolerance (under 1 passes): "
       + fmt(f"{k} {v:.3e}" for k, v in ok.items()))
    _p("CTR join tower, the swapped-rank-offset twin, error / tolerance "
       "(10 or more misses): " + fmt(f"{k} {v:.3e}" for k, v in miss.items()))
    if max(ok.values()) > 1:
        raise SystemExit("chip_smoke: the join tower on the card disagrees "
                         "with the host")
    if max(miss.values()) < 10:
        raise SystemExit("chip_smoke: the join tower's card-vs-host check "
                         "cannot see the swapped rank offsets")
    carry = sorted(k for k, v in miss.items() if v >= 10)
    _p(f"CTR join tower: the criteria the twin misses by 10 or more: "
       f"{carry}; by less: {sorted(set(miss) - set(carry))}")
    return {"ok": ok, "miss": miss, "carry": carry}


def _tdm_tree(depth):
    """A complete binary tree of 2^depth leaves in heap order (root 1,
    node k's children 2k and 2k + 1, 0 the null node): TreeInfo rows
    [item, layer, parent, child0, child1], each leaf's travel path below
    the root, and each layer's nodes padded with 0."""
    n = 1 << (depth + 1)
    k = np.arange(n, dtype=np.int64)
    layer_of = np.zeros(n, np.int64)
    layer_of[1:] = np.floor(np.log2(k[1:])).astype(np.int64)
    leaf = k >= (1 << depth)
    tree = np.stack([np.where(leaf, k - (1 << depth) + 1, 0), layer_of,
                     k // 2, np.where(leaf, 0, 2 * k),
                     np.where(leaf, 0, 2 * k + 1)], 1)
    tree[0] = 0
    leaves = np.arange(1 << depth, 1 << (depth + 1), dtype=np.int64)
    travel = np.stack([leaves >> (depth - d) for d in range(1, depth + 1)],
                      1)
    layer = np.zeros((depth, 1 << depth), np.int64)
    for d in range(1, depth + 1):
        layer[d - 1, : 1 << d] = np.arange(1 << d, 1 << (d + 1))
    return tree, travel, layer


def _ctr_op_cases():
    """(c): the tier's other op types at the tower's shapes (26 slots of
    [4096, 5] ids, dim 16).  {label: (op, inputs, attrs)}."""
    rng = np.random.RandomState(SEED + 150)
    b, s, seq, d = JOIN["batch"], JOIN["slots"], JOIN["seq"], JOIN["dim"]

    def r(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype("float32")

    slots = [r(b, seq, d) for _ in range(s)]
    pooled = [r(b, d) for _ in range(s)]
    ids = _bounded_zipf(rng, (b, seq), JOIN["ids"],
                        rng.permutation(JOIN["ids"]))
    table = r(JOIN["ids"], d, scale=0.01)
    tree, travel, layer = _tdm_tree(17)
    merge = rng.randint(0, 1 << 40, b * s, dtype=np.int64)
    ro = ctr_join_feed(dict(JOIN), np.zeros((b, s, seq), np.int64),
                       SEED + 151)["rank_offset"]
    rows = r(b * seq, d)
    return {
        "hash": ("hash", {"X": rng.randint(0, 1 << 40, (b, s),
                                           dtype=np.int64)},
                 {"num_hash": 2, "mod_by": 1_000_000}),
        "pyramid_hash": ("pyramid_hash",
                         {"X": rng.randint(0, 100_000, (256, 32),
                                           dtype=np.int64),
                          "W": r(1_000_000, d, scale=0.01)},
                         {"num_emb": d, "space_len": 1_000_000,
                          "pyramid_layer": 2}),
        "rank_attention": ("rank_attention",
                           {"X": r(b, JOIN["rank_fc"]), "RankOffset": ro,
                            "RankParam": r(JOIN["max_rank"] ** 2,
                                           JOIN["rank_fc"]
                                           * JOIN["rank_out"], scale=0.1)},
                           {"MaxRank": JOIN["max_rank"]}),
        "tdm_child": ("tdm_child", {"X": rng.randint(1, len(tree), (b, 1)),
                                    "TreeInfo": tree}, {"child_nums": 2}),
        "merge_ids": ("merge_ids", {"Ids": merge, "X": [
            r(int((merge % 4 == k).sum()), d) for k in range(4)]}, {}),
        "ps_lookup_rows": ("ps_lookup_rows", {"Ids": ids, "Rows": rows},
                           {"padding_idx": int(ids[0, 0])}),
        "fused_embedding_seq_pool (sum)": (
            "fused_embedding_seq_pool", {"W": table, "Ids": ids},
            {"combiner": "sum"}),
        "fused_embedding_seq_pool (mean)": (
            "fused_embedding_seq_pool", {"W": table, "Ids": ids},
            {"combiner": "mean"}),
        "fusion_seqpool_concat": ("fusion_seqpool_concat", {"X": slots},
                                  {"pooltype": "SUM"}),
        "fusion_seqpool_cvm_concat": ("fusion_seqpool_cvm_concat",
                                      {"X": slots}, {"use_cvm": False}),
        "fused_seqpool_cvm_with_pcoc": ("fused_seqpool_cvm_with_pcoc",
                                        {"X": slots}, {"use_cvm": False}),
        "partial_concat": ("partial_concat", {"X": pooled},
                           {"start_index": 2, "length": 8}),
        "partial_sum": ("partial_sum", {"X": pooled},
                        {"start_index": 2, "length": 8}),
        "cvm": ("cvm", {"X": np.abs(pooled[0]), "CVM": r(b, 2)},
                {"use_cvm": True}),
        "scaled_int8fc": ("scaled_int8fc",
                          {"Input": r(b, 1293), "W": r(1293, 512,
                                                       scale=0.05),
                           "Bias": r(512)},
                          {"input_scale": 0.05, "weight_scale": 0.001}),
        "pull_box_extended_sparse": (
            "pull_box_extended_sparse",
            {"W": r(1 << 16, d),
             "Ids": [rng.randint(0, 1 << 16, (b, seq)) for _ in range(s)]},
            {"emb_extended_size": 8}),
        "tdm_sampler": ("tdm_sampler",
                        {"X": rng.randint(0, len(travel), (b, 1)),
                         "Travel": travel, "Layer": layer},
                        {"neg_samples_num_list": [1] * 17, "op_seed": 7}),
        "shuffle_batch": ("shuffle_batch", {"X": r(b, s * d)},
                          {"op_seed": 8}),
    }


def _listed_err(got, want, tol):
    """``_op_err`` over every tensor of every output slot."""
    return max(_op_err({k: [g]}, {k: [w]}, tol)
               for k, ws in want.items() for w, g in zip(ws, got[k]))


def _ctr_op_grads(op, ins, attrs, dev, cots):
    """``generic_grad`` of ``op`` on ``dev`` from ``cots`` ({slot: [one
    array an output]}), over each float input it differentiates."""
    import torch
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    opdef = get_op(op)
    t = {k: [torch.from_numpy(np.array(a)).to(dev)
             for a in (v if isinstance(v, list) else [v])]
         for k, v in ins.items()}
    slots = [k for k, v in t.items() if k not in opdef.nondiff_inputs
             and v[0].is_floating_point()]
    gins = {"I_" + k: v for k, v in t.items()}
    gins.update({"G_" + k: [torch.from_numpy(c).to(dev) for c in cs]
                 for k, cs in cots.items()})
    return get_op("generic_grad").fn(
        gins, {"fwd_type": op, "fwd_attrs": dict(attrs),
               "grad_slots": slots, "in_slots": list(ins)},
        LoweringContext(device=torch.device(dev)))


def _ctr_contracts(outs, ins, label):
    """tdm_sampler's and shuffle_batch's contracts on the card's
    outputs; returns what failed."""
    if label == "tdm_sampler":
        out, lab, mask = (_host(outs[k][0])[..., 0]
                          for k in ("Out", "Labels", "Mask"))
        x, travel, layer = (ins["X"][:, 0], ins["Travel"], ins["Layer"])
        bad = []
        if not np.array_equal(out[:, 0::2], travel[x]):
            bad.append("the travel path")
        if any(not np.isin(out[:, 2 * li + 1], layer[li]).all()
               for li in range(layer.shape[0])):
            bad.append("a negative outside its layer")
        if not np.array_equal(lab, np.tile([1, 0], (len(x), layer.shape[0]))):
            bad.append("the labels")
        if not np.array_equal(mask, (out != 0).astype(mask.dtype)):
            bad.append("the mask")
        return bad
    idx = _host(outs["ShuffleIdx"][0])
    x = ins["X"]
    bad = []
    if sorted(idx.tolist()) != list(range(len(x))):
        bad.append("not a permutation")
    if not np.array_equal(_host(outs["Out"][0]), x[idx]):
        bad.append("Out != X[ShuffleIdx]")
    g = np.random.RandomState(SEED + 152).randn(*x.shape).astype("float32")
    grads = _ctr_op_grads("shuffle_batch", ins, {"op_seed": 8}, DEVICE,
                          {"Out": [g]})
    want = np.zeros_like(g)
    want[idx] = g
    if not np.array_equal(_host(grads["GI_X"][0]), want):
        bad.append("the gradient does not scatter back")
    return bad


def _ctr_ops_on_the_card(card):
    """4v (c): each op type's forward ms on the card (CUDA events);
    against the host, forward and ``generic_grad`` where it is
    differentiable, within CTR_CARD_TOL of each output's largest |value|;
    the three gathering ops' gradients twice on the card bit for bit;
    ``tdm_sampler`` and ``shuffle_batch`` held to their contracts."""
    import torch
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    worst, ms, same, broken = {}, {}, {}, {}
    rng = np.random.RandomState(SEED + 153)
    ctx = LoweringContext(device=torch.device(DEVICE))
    for label, (op, ins, attrs) in _ctr_op_cases().items():
        dev_ins = {k: [torch.from_numpy(np.array(a)).to(DEVICE)
                       for a in (v if isinstance(v, list) else [v])]
                   for k, v in ins.items()}
        ms[label] = _ms(lambda: get_op(op).fn(dev_ins, dict(attrs), ctx), 3,
                        warmup=1)
        del dev_ins
        card_out = _op_run(op, ins, attrs, DEVICE)
        if op in ("tdm_sampler", "shuffle_batch"):
            broken[label] = _ctr_contracts(card_out, ins, label)
            continue
        host = _op_run(op, ins, attrs, "cpu")
        worst[label] = _listed_err(card_out, host, CTR_CARD_TOL)
        opdef = get_op(op)
        if not opdef.differentiable:
            continue
        cots = {k: [rng.randn(*_host(v).shape).astype("float32")
                    for v in vs] for k, vs in host.items()
                if k not in opdef.nondiff_outputs
                and _host(vs[0]).dtype.kind == "f"}
        g_card = _ctr_op_grads(op, ins, attrs, DEVICE, cots)
        worst[label] = max(worst[label], _listed_err(
            g_card, _ctr_op_grads(op, ins, attrs, "cpu", cots),
            CTR_CARD_TOL))
        if op in CTR_GATHER_GRADS:
            again = _ctr_op_grads(op, ins, attrs, DEVICE, cots)
            same[label] = all(np.array_equal(_host(a), _host(b))
                              for k in g_card
                              for a, b in zip(g_card[k], again[k]))
    _p("CTR op types on the card, forward ms: "
       + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f"  [{card}]")
    _p(f"CTR op types on the card against the host, forward and "
       f"generic_grad, error / {CTR_CARD_TOL} of the largest |value| (under "
       "1 passes): " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
       + f"; gathering gradients bit for bit in two card runs: {same}; "
       f"contracts broken: {broken}  [{card}]")
    if max(worst.values()) > 1 or len(same) != 4 \
            or not all(same.values()) or any(broken.values()):
        raise SystemExit("chip_smoke: a CTR op type disagrees with the "
                         "host, is not deterministic on the card or breaks "
                         "its contract")
    return {"worst": worst, "ms": ms, "same": same}


def phase_ctr_tier(card):
    """Phase 4v, the PaddleBox CTR tier: (a) the join tower at config 5's
    width through BoxPS, (b) its eval pass, (c) the tier's other op types
    on the card against the host, (d) card against host with a twin.
    Returns the counted launches of (a)'s timed steps, and the
    numbers."""
    launches, train = _join_train(card)
    t = time.perf_counter()
    ops = _ctr_ops_on_the_card(card)
    _p(f"phase 4v (c): {time.perf_counter() - t:.1f} s")
    host = _join_card_vs_host(card)
    return launches, {"train": train, "ops": ops, "host": host}


# ---------------------------------------------------------------------------
# the quantization tier: QAT of static BERT-base, frozen and served; PTQ;
# the dygraph QAT (phase 4w)
# ---------------------------------------------------------------------------
QAT = dict(BERT_BASE, dropout=0.1, lr=1e-3)
QAT_HOST = dict(vocab=64, hidden=32, heads=4, seq=16, layers=2, dropout=0.1,
                lr=1e-3)


def qat_bert_attention(L, x, hidden, heads, mask, dropout):
    """One attention block as ``models/static_graphs.py``'s
    ``_naive_attention`` spells it: fc, reshape2, transpose2 per Q, K and
    V, then matmul, scale, the bias, softmax, dropout, matmul."""
    dh = hidden // heads

    def split(t):
        return L.transpose(L.reshape(t, [0, 0, heads, dh]), [0, 2, 1, 3])

    q, k, v = (split(L.fc(x, hidden, num_flatten_dims=2)) for _ in range(3))
    s = L.scale(L.matmul(q, k, transpose_y=True), scale=dh ** -0.5) + mask
    p = L.softmax(s)
    if dropout:
        p = L.dropout(p, dropout, dropout_implementation="upscale_in_train")
    ctx = L.transpose(L.matmul(p, v), [0, 2, 1, 3])
    return L.reshape(ctx, [0, 0, hidden])


def qat_bert_program(fluid, cfg, train=True, quant=True, bits=(8, 8)):
    """The static BERT classifier of ``build_bert_train_program`` (the
    padding bias, ``cfg['layers']`` blocks of ``qat_bert_attention`` and a
    ReLU fc, the mean over tokens, a 2-way fc and its cross-entropy), built
    forward only; then ``contrib.slim.quantization.quant_aware`` at
    (weight, activation) ``bits`` and, to train, Adam: QAT comes before
    ``minimize``, so the backward runs through the straight-through
    ops.  Returns (loss, logits, [(param, grad)])."""
    L = fluid.layers
    seq, hidden = cfg["seq"], cfg["hidden"]
    ids = fluid.data("ids", [-1, seq], dtype="int64")
    labels = fluid.data("labels", [-1, 1], dtype="int64")
    am = L.reshape(fluid.data("attn_mask", [-1, seq]), [0, 1, 1, seq])
    mask = L.scale(am, scale=10000.0, bias=-10000.0, bias_after_scale=False)
    h = L.embedding(ids, size=[cfg["vocab"], hidden])
    for _ in range(cfg["layers"]):
        h = qat_bert_attention(L, h, hidden, cfg["heads"], mask,
                               cfg["dropout"])
        h = L.fc(h, hidden, num_flatten_dims=2, act="relu")
    logits = L.fc(L.reduce_mean(h, dim=[1]), 2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, labels))
    if quant:
        fluid.contrib.slim.quantization.quant_aware(
            fluid.default_main_program(), weight_bits=bits[0],
            activation_bits=bits[1])
    pg = []
    if train:
        _, pg = fluid.optimizer.AdamOptimizer(cfg["lr"]).minimize(loss)
    return loss, logits, pg


QAT_WARMUP = 2
QAT_SERVE_ROWS = (1, 8, 32)    # (b): the predictor's batches
QAT_FINE_BITS = 24             # (b): a step below float32's rounding of
QAT_FINE_TOL = 1e-4            # the scaled values: relative L2 to the frozen
QAT_PTQ = dict(rows=4, batches=4, hist_batches=1)
QAT_PTQ_RTOL = 1e-4            # (c): abs_max scales, card against host
QAT_PTQ_BINS = 2               # (c): histogram cuts, in bins of the range
QAT_LENET = dict(batch=64, steps=5, lr=1e-3)
QAT_FWD_CALLS = 20             # (d): forwards timed in each mode
QAT_CARD_TOL = 1e-4            # (e): of each output's largest |value|
QAT_ONE_STEP_SHARE = 1e-3      # (e): codes one quant step apart, at most
QAT_HOST_RTOL = dict(loss=1e-4, cosine=1e-4, norm=1e-4, scales=1e-4)
QAT_HOST_STEPS = 3


def _qat_types_check(main, layers, where):
    """The op types that QAT and the kernel tier leave, against what
    ``layers`` blocks make: a fake quant-dequant before every activation
    (the block's input, both matmuls' X, the ReLU fc's; the classifier's)
    and a channel-wise one before every weight (4 muls' and both
    matmuls' Y a block; the classifier's), no fused attention (the fake
    ops break the chain ``fuse_attention`` matches, as in the
    reference), one ``fused_adam``."""
    types = [op.type for op in main.global_block().ops]
    want = {"fake_quantize_dequantize_abs_max": 4 * layers + 1,
            "fake_channel_wise_quantize_dequantize_abs_max": 6 * layers + 1,
            "fused_multihead_attention": 0, "fused_adam": 1, "adam": 0,
            "softmax": layers, "dropout": layers}
    got = {k: types.count(k) for k in want}
    _p(f"{where}: {len(types)} ops after quant_aware, minimize and the "
       f"kernel tier: {got}")
    if got != want:
        raise SystemExit(f"chip_smoke: {where} holds {got}, expected "
                         f"{want}")
    return got


def _qat_built(cfg, bits=(8, 8), train=True, quant=True, tier=True):
    """(main, startup, loss, logits, [(param, grad)], the program to run:
    through ``BuildStrategy(kernel_tier=True)`` with ``tier``)."""
    from paddle_tpu_torch import fluid

    main, startup, (loss, logits, pg), _ = _book_program(
        qat_bert_program, False, cfg=cfg, train=train, quant=quant,
        bits=bits)
    program = main
    if tier:
        bs = fluid.BuildStrategy()
        bs.kernel_tier = True
        program = fluid.CompiledProgram(main, bs)
        program._apply_ir_passes([loss.name])
    return main, startup, loss, logits, pg, program


def _qat_feed(cfg, rows, seed):
    """ids, labels and a padding mask attending to random prefixes."""
    rng = np.random.RandomState(seed)
    seq = cfg["seq"]
    lengths = rng.randint(1, seq + 1, rows)
    return {"ids": rng.randint(0, cfg["vocab"], (rows, seq)).astype("int64"),
            "labels": rng.randint(0, 2, (rows, 1)).astype("int64"),
            "attn_mask": (np.arange(seq)[None, :] < lengths[:, None])
            .astype("float32")}


def _qat_train(card):
    """4w (a) and (b): QAT of static BERT-base at TRAIN_ROWS rows (QAT's
    width, dropout 0.1), the timed steps' launches, a profiled step, two
    full-width steps from one state bit for bit, the frozen program
    served, and ``fused_adam`` on the step's bucket against its plain
    version.  Returns ((a)'s launches, (b)'s, the numbers)."""
    import torch
    from paddle_tpu_torch import fluid

    cfg, layers = QAT, QAT["layers"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out = {}
    with _fresh_fluid_globals():
        t0 = time.perf_counter()
        main, startup, loss, logits, pg, prog = _qat_built(cfg)
        build_s = time.perf_counter() - t0
        out["types"] = _qat_types_check(main, layers,
                                        "QAT BERT-base (card)")
        place = fluid.CUDAPlace(0)
        exe, scope = fluid.Executor(place), fluid.global_scope()
        exe.run(startup)
        n_params = sum(math.prod(p.shape) for p, _ in pg)
        feed = _qat_feed(cfg, TRAIN_ROWS, SEED + 160)

        def step():
            return exe.run(prog, feed=feed, fetch_list=[loss],
                           return_numpy=False)[0]

        warm = [float(step()) for _ in range(QAT_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = {"fused_dropout": 2 * layers * TRAIN_STEPS,
                "dropout_mask": layers * TRAIN_STEPS,
                "fused_adam": TRAIN_STEPS}
        t0 = time.perf_counter()
        timed, launches = _counted_run(
            "the QAT BERT-base timed steps",
            lambda: [step() for _ in range(TRAIN_STEPS)], want)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        losses = warm + [float(x) for x in timed]
        tokens = TRAIN_ROWS * cfg["seq"] * TRAIN_STEPS
        _p(f"QAT BERT-base: built (quant_aware, then Adam) and passed in "
           f"{build_s:.1f} s, {len(pg)} parameters ({n_params} values); "
           f"{TRAIN_STEPS} timed steps of {TRAIN_ROWS} rows in {wall:.3f} "
           f"s: {wall / TRAIN_STEPS * 1e3:.3f} host ms/step, "
           f"{tokens / wall:.0f} tokens/s; peak {peak:.3f} GiB above the "
           f"{base / 2 ** 30:.3f} GiB earlier phases hold; launches "
           f"{launches} (a step: {2 * layers} pt_dropout, the attention "
           f"dropouts' forward and their custom grad, {layers} masks, 1 "
           f"fused Adam); losses {[round(x, 5) for x in losses]}  [{card}]")
        if not np.isfinite(losses).all():
            raise SystemExit("chip_smoke: a QAT BERT-base loss is not "
                             "finite")
        prof = _profile(lambda: float(step()), 1, warmup=1, host_ops=False)
        _p(f"profile QAT BERT-base step: host {prof[0]:.3f} ms/step, "
           f"device busy {prof[1]:.3f} ms/step, idle share {prof[2]:.4f}, "
           f"{prof[3]:.0f} kernels/step  [{card}]")
        _print_classes(prof[4], "step")
        out.update(ms=wall / TRAIN_STEPS * 1e3, tokens_s=tokens / wall,
                   peak_gib=peak, losses=losses, host_ms=prof[0],
                   busy_ms=prof[1], idle=prof[2], kernels=prof[3],
                   by_class=prof[4], params=n_params)

        # two full-width steps from one state, bit for bit (each by an
        # executor of its own: the dropout masks are keyed by its step)
        snap = _join_snapshot(main, scope)
        runs = []
        for _ in range(2):
            s = fluid.Scope()
            for n, v in snap.items():
                s.set_var(n, v.clone())
            lv = fluid.Executor(place).run(prog, feed=feed, fetch_list=[loss],
                                           scope=s, return_numpy=False)[0]
            runs.append((float(lv), _join_snapshot(main, s)))
            del s
        differ = [n for n in snap if not torch.equal(runs[0][1][n],
                                                      runs[1][1][n])]
        if runs[0][0] != runs[1][0]:
            differ.append("the loss")
        _p(f"QAT BERT-base determinism: two full-width steps from one "
           f"state, {len(differ)} of {len(snap) + 1} persistables and the "
           f"loss differ in any bit {differ}  [{card}]")
        del snap, runs
        if differ:
            raise SystemExit("chip_smoke: two QAT BERT-base steps from one "
                             "state differ")
        out["differ"] = differ

        serve_launches, out["serve"] = _qat_freeze_serve(
            main, logits, exe, scope, card)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 162)
        out["adam_max_abs_err"] = _adam_bucket_check(
            main, scope, gen, "the QAT BERT-base step", card)
    torch.cuda.empty_cache()
    return launches, serve_launches, out


def _qat_freeze_serve(main, logits, exe, scope, card):
    """4w (b): ``convert`` of ``main.clone(for_test=True)``, frozen for
    serving (``serving.freeze_program``) with ``fuse_attention``, as
    phase 4 serves (no fake op is left in its way), and
    ``save_inference_model``; then ``AnalysisPredictor`` at
    QAT_SERVE_ROWS: its logits equal to the executor's run of the frozen
    program bit for bit.  The un-frozen QAT test program differs from
    them by its quantization noise alone: with every fake op at
    QAT_FINE_BITS bits (a step under float32's rounding) within
    QAT_FINE_TOL (relative L2), so ``convert`` dropped nothing else; at
    8 bits more than that (printed: attention probabilities under half a
    step of 1/127 round to 0)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.contrib.slim.quantization import convert
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    from paddle_tpu_torch.serving import freeze_program

    layers = QAT["layers"]
    feeds = ["ids", "attn_mask"]
    qat_test = main.clone(for_test=True)
    qat_fine = main.clone(for_test=True)
    for op in qat_fine.global_block().ops:
        if op.type.startswith("fake_"):
            op.attrs["bit_length"] = QAT_FINE_BITS
    frozen = convert(main.clone(for_test=True))
    served = freeze_program(frozen, feeds, [logits], scope=scope)
    bs = fluid.BuildStrategy()
    bs.fuse_attention = True
    fluid.CompiledProgram(served, bs)._apply_ir_passes([logits.name])
    types = [op.type for op in served.global_block().ops]
    _p(f"QAT BERT-base frozen: {len(frozen._quant_scales)} scales "
       f"recorded, {sum(t.startswith('fake_') for t in types)} fake ops "
       f"left, {types.count('fused_multihead_attention')} fused attention "
       f"ops after the serving passes and fuse_attention")
    if types.count("fused_multihead_attention") != layers \
            or any(t.startswith("fake_") for t in types):
        raise SystemExit("chip_smoke: the frozen QAT BERT-base program "
                         "kept a fake op or missed its fused attention")
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "qat_bert")
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(model_dir, feeds, [logits], exe,
                                          main_program=served,
                                          params_filename="params")
        out["save_s"] = time.perf_counter() - t0
        pscope = fluid.Scope()
        with fluid.scope_guard(pscope):
            pred = create_predictor(AnalysisConfig(
                model_dir, params_file=os.path.join(model_dir, "params")))
            for rows in QAT_SERVE_ROWS:
                f = _qat_feed(QAT, rows, SEED + 161 + rows)
                got, c = _counted_run(
                    f"the frozen QAT BERT-base predictor at {rows} rows",
                    lambda: _serve_predictor(pred, f),
                    {"flash_attention_fwd": layers})
                launches[rows] = c
                want = exe.run(served, feed={k: f[k] for k in feeds},
                               fetch_list=[logits], scope=scope)[0]
                noise = {}
                for bits, prog in ((8, qat_test), (QAT_FINE_BITS, qat_fine)):
                    q = exe.run(prog, feed=f, fetch_list=[logits],
                                scope=scope)[0]
                    noise[bits] = float(np.linalg.norm(q - got)
                                        / np.linalg.norm(got))
                exact = got.shape == (rows, 2) and np.array_equal(got, want)
                _p(f"QAT BERT-base predictor at {rows} rows: "
                   f"{c['flash_attention_fwd']} flash launches, logits equal "
                   f"to the frozen program's bit for bit: {exact}; the QAT "
                   f"test program's relative L2 from them at 8 bits "
                   f"{noise[8]:.4e}, at {QAT_FINE_BITS} bits "
                   f"{noise[QAT_FINE_BITS]:.4e} (at most {QAT_FINE_TOL})  "
                   f"[{card}]")
                out[rows] = dict(exact=exact, noise=noise)
                if not exact or noise[QAT_FINE_BITS] > QAT_FINE_TOL \
                        or not noise[8] > noise[QAT_FINE_BITS]:
                    raise SystemExit("chip_smoke: the frozen QAT BERT-base "
                                     "serves otherwise than its program, or "
                                     "differs from QAT by more than its "
                                     "quantization")
    _p(f"QAT BERT-base: save_inference_model {out['save_s']:.2f} s")
    return launches, out


def _ptq_scales(main, logits, init, place, batches, algo):
    """``PostTrainingQuantization`` of ``main`` from ``init`` on ``place``
    over ``batches``; the ``quant_scales.json`` it saves."""
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.contrib.slim.quantization import \
        PostTrainingQuantization

    scope = interop.scope_from_numpy(init, fluid.Scope(), place)
    exe = fluid.Executor(place)
    with fluid.scope_guard(scope), tempfile.TemporaryDirectory() as tmp:
        ptq = PostTrainingQuantization(
            exe, main, ["ids", "attn_mask"], [logits],
            data_loader=lambda: iter(batches), batch_nums=len(batches),
            algo=algo)
        ptq.quantize()
        ptq.save_quantized_model(tmp)
        with open(os.path.join(tmp, "quant_scales.json")) as f:
            return json.load(f)


def _qat_ptq(card):
    """4w (c): PTQ of the float BERT-base program (no QAT, the test
    clone) from seed 0's startup, QAT_PTQ["batches"] calibration batches
    under abs_max and QAT_PTQ["hist_batches"] under the histogram, on the
    card and on the host: the same keys, abs_max scales within
    QAT_PTQ_RTOL, the histogram's cuts within QAT_PTQ_BINS bins of their
    range, the weight scales equal."""
    from paddle_tpu_torch import fluid

    with _fresh_fluid_globals():
        main, startup, _, logits, _, _ = _qat_built(QAT, train=False,
                                                   quant=False, tier=False)
    init = _startup_state(main, startup, fluid.CUDAPlace(0))
    test = main.clone(for_test=True)
    batches = [{k: v for k, v in _qat_feed(QAT, QAT_PTQ["rows"],
                                          SEED + 170 + i).items()
                if k != "labels"} for i in range(QAT_PTQ["batches"])]
    runs = {}
    for algo, n in (("abs_max", QAT_PTQ["batches"]),
                    ("hist", QAT_PTQ["hist_batches"])):
        for where, place in (("card", fluid.CUDAPlace(0)),
                             ("host", fluid.CPUPlace())):
            t0 = time.perf_counter()
            runs[(algo, where)] = _ptq_scales(test, logits, init, place,
                                              batches[:n], algo)
            _p(f"PTQ {algo} on the {where}: {n} batches of "
               f"{QAT_PTQ['rows']} rows in {time.perf_counter() - t0:.1f} s")
    out = {}
    for algo in ("abs_max", "hist"):
        got, want = runs[(algo, "card")], runs[(algo, "host")]
        keys = sorted(got) == sorted(want) and all(
            sorted(got[k]) == sorted(want[k])
            for k in ("activations", "weights"))
        act = {n: abs(got["activations"][n] - v) for n, v in
               want["activations"].items()}
        if algo == "abs_max":
            err = max(act[n] / (QAT_PTQ_RTOL * abs(v))
                      for n, v in want["activations"].items())
        else:
            err = max(act[n] / (QAT_PTQ_BINS * abs(v) / 2048)
                      for n, v in want["activations"].items())
        weights = all(np.array_equal(got["weights"][n], v)
                      for n, v in want["weights"].items())
        _p(f"PTQ {algo}: card against host, {len(want['activations'])} "
           f"activation and {len(want['weights'])} weight scales, keys "
           f"equal {keys}, activations' error / tolerance {err:.3e} (under "
           f"1 passes), weights equal {weights}  [{card}]")
        if not keys or err > 1 or not weights:
            raise SystemExit(f"chip_smoke: PTQ {algo}'s scales on the card "
                             f"disagree with the host's")
        out[algo] = dict(err=err, activations=len(want["activations"]))
    return out


def _qat_imperative(card):
    """4w (d): ``ImperativeQuantAware().quantize(LeNet())`` on the card,
    QAT_LENET["steps"] Adam steps at MNIST's 1 x 28 x 28: the reference's
    quirk, every quantized weight and every bias but the last layer's
    bit for bit where it started; ``save_quantized_model`` and
    ``jit.load``: the eval logits bit for bit."""
    import torch
    from paddle_tpu_torch import fluid, jit
    from paddle_tpu_torch.contrib.slim.quantization import \
        ImperativeQuantAware
    from paddle_tpu_torch.dygraph import base as dy
    from paddle_tpu_torch.vision.models import LeNet

    cfg = QAT_LENET
    rng = np.random.RandomState(SEED + 180)
    x = rng.randn(cfg["batch"], 1, 28, 28).astype("float32")
    y = rng.randint(0, 10, (cfg["batch"], 1)).astype("int64")
    L = fluid.layers
    with dy.guard(fluid.CUDAPlace(0)), tempfile.TemporaryDirectory() as tmp:
        net = ImperativeQuantAware().quantize(LeNet())
        swapped = sorted({type(l).__name__ for l in net.sublayers()
                          if type(l).__name__.startswith("Quantized")})
        before = {n: p.numpy().copy() for n, p in net.named_parameters()}
        opt = fluid.optimizer.AdamOptimizer(
            cfg["lr"], parameter_list=net.parameters())
        xv, yv = dy.to_variable(x), dy.to_variable(y)
        losses = []
        t0 = time.perf_counter()
        for _ in range(cfg["steps"]):
            loss = L.mean(L.softmax_with_cross_entropy(net(xv), yv))
            loss.backward()
            opt.minimize(loss)
            net.clear_gradients()
            losses.append(float(loss.numpy()))
        step_ms = (time.perf_counter() - t0) / cfg["steps"] * 1e3
        moved = sorted(n for n, p in net.named_parameters()
                       if not np.array_equal(p.numpy(), before[n]))
        # the observers' host reads: a training forward reads each
        # quantized layer's activation abs max back to the host, an eval
        # forward reads none
        reads = sum(type(l).__name__ == "FakeQuantMovingAverage"
                    for l in net.sublayers())
        fwd_ms = {}
        for mode in ("train", "eval"):
            getattr(net, mode)()
            net(xv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(QAT_FWD_CALLS):
                net(xv)
            torch.cuda.synchronize()
            fwd_ms[mode] = (time.perf_counter() - t0) / QAT_FWD_CALLS * 1e3
        net.train()
        ImperativeQuantAware().save_quantized_model(net, tmp, [xv])
        net.eval()
        want = net(xv).numpy()
        net.train()
        loaded = jit.load(tmp)
        got = loaded(x).numpy()
    exact = np.array_equal(got, want)
    _p(f"dygraph QAT LeNet forward, {QAT_FWD_CALLS} calls each: train "
       f"{fwd_ms['train']:.3f} host ms ({reads} host reads of the "
       f"observers' scales), eval {fwd_ms['eval']:.3f} (none): "
       f"{(fwd_ms['train'] - fwd_ms['eval']) / reads:.3f} ms a read (with "
       f"its abs max)  "
       f"[{card}]")
    _p(f"dygraph QAT LeNet: {swapped}, {cfg['steps']} Adam steps of "
       f"{cfg['batch']} in {step_ms:.1f} ms each, losses "
       f"{[round(v, 5) for v in losses]}; parameters that moved {moved} "
       f"(the reference's quirk: only the last layer's bias); "
       f"save_quantized_model -> jit.load, the eval logits equal bit for "
       f"bit: {exact} (max |err| {float(np.abs(got - want).max()):.3e})  "
       f"[{card}]")
    if moved != ["fc.3._inner.bias"] or not exact \
            or not np.isfinite(losses).all():
        raise SystemExit("chip_smoke: the dygraph QAT LeNet moved other "
                         "parameters, or its saved model answers otherwise")
    return dict(losses=losses, moved=moved, step_ms=step_ms, fwd_ms=fwd_ms,
                reads=reads)


def _qat_op_cases():
    """4w (e): the slice's 35 op types at the QAT path's shapes (BERT-base's
    [4096, 768] activations, its [768, 768] weights, [32, 12, 128, 64]
    heads), {label: (op, inputs, attrs, the step of one code in ``Out``
    or None)}."""
    rng = np.random.RandomState(SEED + 190)
    rows, d, h = TRAIN_ROWS * QAT["seq"], QAT["hidden"], QAT["heads"]

    def r(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype("float32")

    x, w = r(rows, d), r(d, d, scale=0.03)
    amax = float(np.abs(x).max())
    cw = np.abs(w).max(axis=0)
    codes = rng.randint(-127, 128, (rows, d))
    state = {"InScale": np.array([0.8 * amax], "float32"),
             "InAccum": np.array([2.5], "float32"),
             "InState": np.array([1.9], "float32")}
    heads = (TRAIN_ROWS * h, QAT["seq"], d // h)
    return {
        "fake_quantize_abs_max": ("fake_quantize_abs_max", {"X": x}, {}, 1.0),
        "fake_quantize_dequantize_abs_max": (
            "fake_quantize_dequantize_abs_max", {"X": x}, {}, amax / 127),
        "fake_channel_wise_quantize_abs_max": (
            "fake_channel_wise_quantize_abs_max", {"X": w},
            {"quant_axis": 1}, 1.0),
        "fake_channel_wise_quantize_dequantize_abs_max": (
            "fake_channel_wise_quantize_dequantize_abs_max", {"X": w},
            {"quant_axis": 1}, cw / 127),
        "fake_quantize_range_abs_max": (
            "fake_quantize_range_abs_max",
            {"X": x, "InScale": state["InScale"],
             "Iter": np.array([3], "int64")}, {}, 1.0),
        "fake_quantize_moving_average_abs_max": (
            "fake_quantize_moving_average_abs_max", dict(state, X=x), {},
            1.0),
        "fake_quantize_dequantize_moving_average_abs_max": (
            "fake_quantize_dequantize_moving_average_abs_max",
            dict(state, X=x), {}, None),
        "moving_average_abs_max_scale": (
            "moving_average_abs_max_scale",
            {"X": x, "InAccum": state["InAccum"],
             "InState": state["InState"]}, {}, None),
        "fake_dequantize_max_abs": (
            "fake_dequantize_max_abs",
            {"X": codes.astype("float32"),
             "Scale": np.array([amax], "float32")}, {"max_range": 127.0},
            None),
        "fake_channel_wise_dequantize_max_abs": (
            "fake_channel_wise_dequantize_max_abs",
            {"X": codes[:d].astype("float32"), "Scales": [cw]},
            {"quant_bits": [8], "quant_axis": 1}, None),
        "dequantize_abs_max": (
            "dequantize_abs_max", {"X": codes.astype("int8"),
                                   "Scale": np.array([amax], "float32")},
            {"max_range": 127.0}, None),
        "dequantize_log": (
            "dequantize_log",
            {"X": rng.randint(-128, 128, (rows, d)).astype("int8"),
             "Dict": np.exp2(np.linspace(-7, 0, 128)).astype("float32")},
            {}, None),
        "quantize": ("quantize", {"Input": x},
                     {"Scale": 100.0 / amax, "Shift": 3.0}, None),
        "dequantize": ("dequantize", {"Input": codes.astype("int8")},
                       {"Scale": 41.5, "Shift": 2.0}, None),
        "requantize": ("requantize", {"Input": codes.astype("int8")},
                       {"Scale_in": 40.0, "Scale_out": 25.0}, None),
        "bmm": ("bmm", {"X": r(*heads), "Y": r(heads[0], heads[2],
                                                heads[1])}, {}, None),
        "cos_sim": ("cos_sim", {"X": x, "Y": r(rows, d)}, {}, None),
        "isfinite": ("isfinite", {"X": [x, w]}, {}, None),
        "l1_norm": ("l1_norm", {"X": x}, {}, None),
        "pow": ("pow", {"X": np.abs(x) + 0.1}, {"factor": 2.5}, None),
        "squared_l2_distance": ("squared_l2_distance",
                                {"X": x, "Y": r(1, d)}, {}, None),
        "squared_l2_norm": ("squared_l2_norm", {"X": w}, {}, None),
        "diag_embed": ("diag_embed", {"Input": r(TRAIN_ROWS, QAT["seq"])},
                       {}, None),
        "size": ("size", {"Input": x}, {}, None),
        "space_to_depth": ("space_to_depth", {"X": r(TRAIN_ROWS, 64, 56,
                                                     56)},
                           {"blocksize": 2}, None),
        "squeeze": ("squeeze", {"X": r(TRAIN_ROWS, 1, d)}, {"axes": [1]},
                    None),
        "unsqueeze": ("unsqueeze", {"X": r(TRAIN_ROWS, d)}, {"axes": [1]},
                      None),
        "unique_with_counts": ("unique_with_counts", {
            "X": rng.randint(0, QAT["vocab"], rows).astype("int64")}, {},
            None),
        "top_k_v2": ("top_k_v2", {"X": np.round(r(256, QAT["vocab"]), 1)},
                     {"k": 5}, None),
        "kthvalue": ("kthvalue", {"X": np.round(r(rows, 64), 1)}, {"k": 7},
                     None),
        "precision_recall": ("precision_recall", {
            "MaxProbs": rng.rand(rows, 1).astype("float32"),
            "Indices": rng.randint(0, 10, (rows, 1)),
            "Labels": rng.randint(0, 10, (rows, 1))},
            {"class_number": 10}, None),
        "mean_iou": ("mean_iou", {
            "Predictions": rng.randint(0, 21, (8, 256, 256)),
            "Labels": rng.randint(0, 21, (8, 256, 256))},
            {"num_classes": 21}, None),
        "seed": ("seed", {}, {"seed": 7}, None),
        "lookup_table_dequant": ("lookup_table_dequant", {
            "W": np.concatenate([r(100_000, 2), rng.randint(
                0, 256, (100_000, 16)).astype("float32")], 1),
            "Ids": rng.randint(0, 100_000, (rows, 1))}, {}, None),
        "random_crop": ("random_crop", {"X": r(TRAIN_ROWS, 3, 64, 64)},
                        {"shape": [3, 56, 56], "op_seed": 9}, None),
    }


def _code_err(got, want, step):
    """``Out``'s error over QAT_CARD_TOL of its largest |value|, elements
    exactly one quant ``step`` apart set aside; and their share."""
    got, want = _host(got).astype(np.float64), _host(want).astype(np.float64)
    d = np.abs(got - want)
    tol = QAT_CARD_TOL * max(float(np.abs(want).max()), 1e-30)
    one = np.abs(d - np.broadcast_to(step, d.shape)) <= 1e-5 * \
        np.broadcast_to(step, d.shape)
    rest = np.where(one & (d > tol), 0.0, d)
    return float(rest.max()) / tol, float((one & (d > tol)).mean())


def _qat_ops_on_the_card(card):
    """4w (e): each op type's forward ms on the card (CUDA events) and,
    against the host, its forward and ``generic_grad`` where it is
    differentiable, within QAT_CARD_TOL of each output's largest |value|
    (quantized outputs: elements one quant step apart set aside, at most
    QAT_ONE_STEP_SHARE of them); ``lookup_table_dequant``'s gradient over
    repeated ids twice bit for bit; ``random_crop`` held to its
    contract."""
    import torch
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    worst, ms, share, broken = {}, {}, {}, []
    rng = np.random.RandomState(SEED + 191)
    ctx = LoweringContext(device=torch.device(DEVICE))
    cases = _qat_op_cases()
    for label, (op, ins, attrs, step) in cases.items():
        dev_ins = {k: [torch.from_numpy(np.array(a)).to(DEVICE)
                       for a in (v if isinstance(v, list) else [v])]
                   for k, v in ins.items()}
        ms[label] = _ms(lambda: get_op(op).fn(dev_ins, dict(attrs), ctx), 3,
                        warmup=1)
        del dev_ins
        card_out = _op_run(op, ins, attrs, DEVICE)
        if op == "random_crop":
            out = _host(card_out["Out"][0])
            again = _host(_op_run(op, ins, attrs, DEVICE)["Out"][0])
            xs = ins["X"]
            hits = [(i, j) for i in range(xs.shape[2] - 55)
                    for j in range(xs.shape[3] - 55)
                    if np.array_equal(out, xs[:, :, i:i + 56, j:j + 56])]
            if len(hits) != 1 or not np.array_equal(out, again):
                broken.append(label)
            continue
        host = _op_run(op, ins, attrs, "cpu")
        if step is not None:
            worst[label], share[label] = _code_err(card_out["Out"][0],
                                                  host["Out"][0], step)
            rest = {k: v for k, v in host.items() if k != "Out"}
            if rest:
                worst[label] = max(worst[label],
                                   _listed_err(card_out, rest, QAT_CARD_TOL))
        else:
            worst[label] = _listed_err(card_out, host, QAT_CARD_TOL)
        opdef = get_op(op)
        if not opdef.differentiable:
            continue
        cots = {k: [np.asarray(rng.randn(*_host(v).shape), "float32")
                    for v in vs] for k, vs in host.items()
                if k not in opdef.nondiff_outputs
                and _host(vs[0]).dtype.kind == "f"}
        g_card = _ctr_op_grads(op, ins, attrs, DEVICE, cots)
        worst[label] = max(worst[label], _listed_err(
            g_card, _ctr_op_grads(op, ins, attrs, "cpu", cots),
            QAT_CARD_TOL))
        if op == "lookup_table_dequant":
            again = _ctr_op_grads(op, ins, attrs, DEVICE, cots)
            if not all(np.array_equal(_host(a), _host(b)) for k in g_card
                       for a, b in zip(g_card[k], again[k])):
                broken.append(label + " (gradient not bit for bit)")
    _p("quant tier op types on the card, forward ms: "
       + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f"  [{card}]")
    _p(f"quant tier op types on the card against the host, forward and "
       f"generic_grad, error / {QAT_CARD_TOL} of the largest |value| (under "
       "1 passes): " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
       + f"; codes one quant step apart, share {share} (at most "
       f"{QAT_ONE_STEP_SHARE}); broken {broken}  [{card}]")
    if max(worst.values()) > 1 or broken or len(cases) != 35 \
            or max(share.values()) > QAT_ONE_STEP_SHARE:
        raise SystemExit("chip_smoke: a quant tier op type disagrees with "
                         "the host or breaks its contract")
    return {"worst": worst, "ms": ms, "share": share}


def _qat_margins(got, want):
    """4w (f)'s criteria, each error over its tolerance (under 1 passes):
    every loss to rtol, the first step's gradient cosine and norm, every
    ``@QUANT_SCALE`` of the first step to rtol."""
    t = QAT_HOST_RTOL
    cos, norm = _cosine(got["grads"], want["grads"])
    return {"losses": max(abs(g - w) / abs(w) for g, w in
                          zip(got["losses"], want["losses"])) / t["loss"],
            "gradient cosine": (1 - cos) / t["cosine"],
            "gradient norm": abs(norm - 1) / t["norm"],
            "scales": max(_worst_rel(got["scales"][n], w) for n, w in
                          want["scales"].items()) / t["scales"]}


def _qat_card_vs_host(card):
    """4w (f): QAT_HOST (2 layers, hidden 32, dropout 0.1: the dropout
    masks are Philox's on either device) QAT_HOST_STEPS steps on the card
    and on the host from one startup state; a twin whose activations are
    quantized at bit_length 7 must miss by 10 times or more."""
    from paddle_tpu_torch import fluid, interop

    t0 = time.perf_counter()
    cfg = QAT_HOST
    feeds = [_qat_feed(cfg, 8, SEED + 200 + i) for i in range(QAT_HOST_STEPS)]

    def run(place, bits=(8, 8), init=None):
        with _fresh_fluid_globals():
            main, startup, loss, _, pg, prog = _qat_built(cfg, bits=bits)
            if init is None:
                _qat_types_check(main, cfg["layers"],
                                 "QAT at the host width (host)")
                init = _startup_state(main, startup, fluid.CPUPlace())
            scales = sorted(n for n in main.global_block().vars
                            if n.endswith("@QUANT_SCALE"))
            scope = interop.scope_from_numpy(init, fluid.Scope(), place)
            exe = fluid.Executor(place)
            outs = [exe.run(prog, feed=f, fetch_list=[loss] +
                            [g for _, g in pg] + scales, scope=scope)
                    for f in feeds]
        n = len(pg)
        return init, {"losses": [float(np.ravel(o[0])[0]) for o in outs],
                      "grads": [np.asarray(g) for g in outs[0][1:1 + n]],
                      "scales": dict(zip(scales, outs[0][1 + n:]))}

    init, host = run(fluid.CPUPlace())
    _, got = run(fluid.CUDAPlace(0), init=init)
    _, twin = run(fluid.CUDAPlace(0), bits=(8, 7), init=init)
    ok, miss = _qat_margins(got, host), _qat_margins(twin, host)
    fmt = ", ".join
    _p(f"QAT card vs host at {cfg['layers']} layers, hidden "
       f"{cfg['hidden']}, 8 rows, {QAT_HOST_STEPS} steps, in "
       f"{time.perf_counter() - t0:.1f} s: losses card {got['losses']}, "
       f"host {host['losses']}  [{card}]")
    _p("QAT card vs host, error / tolerance (under 1 passes): "
       + fmt(f"{k} {v:.3e}" for k, v in ok.items()))
    _p("QAT, the 7-bit activation twin, error / tolerance (10 or more "
       "misses): " + fmt(f"{k} {v:.3e}" for k, v in miss.items()))
    if max(ok.values()) > 1:
        raise SystemExit("chip_smoke: QAT on the card disagrees with the "
                         "host")
    if max(miss.values()) < 10:
        raise SystemExit("chip_smoke: the QAT card-vs-host check cannot see "
                         "7-bit activations")
    carry = sorted(k for k, v in miss.items() if v >= 10)
    _p(f"QAT: the criteria the twin misses by 10 or more: {carry}; by "
       f"less: {sorted(set(miss) - set(carry))}")
    return {"ok": ok, "miss": miss, "carry": carry}


def phase_quant_tier(card):
    """Phase 4w, the quantization tier: (a) QAT of static BERT-base and (b)
    its frozen program served, (c) PTQ card against host, (d) the dygraph
    QAT, (e) the slice's op types on the card, (f) card against host with
    a twin.  Returns (a)'s launches, (b)'s and the numbers."""
    launches, serve_launches, train = _qat_train(card)
    out = {"train": train}
    for name, fn in (("(c)", _qat_ptq), ("(d)", _qat_imperative),
                     ("(e)", _qat_ops_on_the_card),
                     ("(f)", _qat_card_vs_host)):
        t = time.perf_counter()
        out[name] = fn(card)
        _p(f"phase 4w {name}: {time.perf_counter() - t:.1f} s")
    return launches, serve_launches, out


# --- phase 4x: the fused inference tier -------------------------------------
# BertModel-base (phase 4o (d)'s model: vocab 30522, hidden 768, 12
# layers, 12 heads, FFN 3072, seq 128) in Paddle Inference's fused ERNIE
# form, served through AnalysisPredictor
ERNIE = dict(vocab=DY["vocab_size"], hidden=DY["hidden_size"],
             heads=DY["num_heads"], layers=DY["num_layers"],
             ffn=DY["intermediate_size"], positions=DY["max_position"],
             types=2, seq=DY_SEQ)
ERNIE_FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask")
ERNIE_ROWS = (1, 8, 32)        # (a): the predictor's batches
ERNIE_TOL = 1e-4               # (a): of each output's largest |value|
ERNIE_EPS = 1e-5               # the eager model's LayerNorm epsilon
ERNIE_PROFILED = 10            # (a): profiled runs at each batch
FUSED_CARD_TOL = 1e-4          # (b): of each output's largest |value|
# (b): the cotangent of a ReLU-activated output is 0 within this of the
# kink: over ResNet-50's 102.8 M activations some land within float32
# rounding of 0 and take the other branch on the card
FUSED_KINK = {"fused_bn_add_activation": 1e-3, "inplace_abn": 1e-3,
              "conv_fusion": 1e-3, "fusion_conv_inception": 1e-3,
              "fusion_seqconv_eltadd_relu": 1e-3}
# (b): ReLUs between the layers, which no output cotangent reaches: the
# gradients compared in float64 (over 3.1 M inner activations a float32
# run flips one now and then, 84 times the tolerance in one row)
FUSED_GRAD_F64 = {"fusion_repeated_fc_relu"}
# the eager model's dropouts off: its embedding Dropout is fluid's
# downgrade_in_infer, which scales the eval output by 1 - p (0.9 at
# BertModel's default), where ERNIE's dropouts upscale in training and its
# inference graph has none
ERNIE_EAGER_DROPOUT = dict(dropout=0.0, attn_dropout=0.0)


def ernie_fused_program(fluid, cfg):
    """BERT-base as Paddle Inference's ERNIE passes leave it, its fused
    ops appended by ``block.append_op``: ``fused_embedding_eltwise_
    layernorm`` over the feeds ``src_ids``, ``pos_ids`` and ``sent_ids``;
    a layer: ``fc`` to the packed QKV (``in_num_col_dims`` 2),
    ``multihead_matmul`` with BiasQK ``[B, 1, 1, T]`` made from
    ``input_mask`` by the model's own ``scale`` ((m - 10000)·10000),
    ``fc``, ``skip_layernorm``, ``fc`` to the FFN width and a ``gelu`` op
    (the erf form), ``reshape2`` to [B·T, FFN] (the reference's
    ``fused_fc_elementwise_layernorm`` flattens X by its first axis) and
    ``fused_fc_elementwise_layernorm`` with the residual as [B·T,
    hidden], ``reshape2`` back; the pooler a ``slice`` of the first token
    and ``fc`` with ``tanh``.  Returns (sequence output, pooled
    output)."""
    L = fluid.layers
    seq, hidden = cfg["seq"], cfg["hidden"]
    block = fluid.default_main_program().global_block()

    def param(name, *shape):
        return L.create_parameter(list(shape), "float32", name=name)

    def op(op_type, ins, **attrs):
        out = block.create_var(
            name=fluid.unique_name.generate(op_type + ".tmp"),
            dtype="float32")
        block.append_op(op_type, inputs=ins, outputs={"Out": [out]},
                        attrs=attrs)
        return out

    def fc(x, name, n_in, n_out, ncol=2, **attrs):
        return op("fc", {"Input": [x],
                         "W": [param(name + ".w_0", n_in, n_out)],
                         "Bias": [param(name + ".b_0", n_out)]},
                  in_num_col_dims=ncol, **attrs)

    def norm(name):
        return ([param(name + "_scale", hidden)],
                [param(name + "_bias", hidden)])

    ids = [fluid.data(n, [-1, seq], dtype="int64") for n in ERNIE_FEEDS[:3]]
    mask = fluid.data(ERNIE_FEEDS[3], [-1, seq], dtype="float32")
    bias_qk = L.scale(L.reshape(mask, [-1, 1, 1, seq]), scale=10000.0,
                      bias=-10000.0, bias_after_scale=False)
    scale, bias = norm("pre_encoder_layer_norm")
    h = op("fused_embedding_eltwise_layernorm",
           {"Ids": ids,
            "Embs": [param("word_embedding", cfg["vocab"], hidden),
                     param("pos_embedding", cfg["positions"], hidden),
                     param("sent_embedding", cfg["types"], hidden)],
            "Scale": scale, "Bias": bias}, epsilon=ERNIE_EPS)
    for i in range(cfg["layers"]):
        p = f"encoder_layer_{i}_"
        qkv = fc(h, p + "multi_head_att_qkv", hidden, 3 * hidden)
        ctx = op("multihead_matmul", {"Input": [qkv], "BiasQK": [bias_qk]},
                 head_number=cfg["heads"],
                 alpha=(hidden // cfg["heads"]) ** -0.5)
        att = fc(ctx, p + "multi_head_att_output_fc", hidden, hidden)
        scale, bias = norm(p + "post_att_layer_norm")
        h1 = op("skip_layernorm", {"X": [att], "Y": [h], "Scale": scale,
                                   "Bias": bias}, epsilon=ERNIE_EPS)
        ffn = L.reshape(L.gelu(fc(h1, p + "ffn_fc_0", hidden, cfg["ffn"])),
                        [-1, cfg["ffn"]])
        scale, bias = norm(p + "post_ffn_layer_norm")
        out = op("fused_fc_elementwise_layernorm",
                 {"X": [ffn],
                  "W": [param(p + "ffn_fc_1.w_0", cfg["ffn"], hidden)],
                  "Bias0": [param(p + "ffn_fc_1.b_0", hidden)],
                  "Y": [L.reshape(h1, [-1, hidden])], "Scale": scale,
                  "Bias1": bias}, epsilon=ERNIE_EPS)
        h = L.reshape(out, [-1, seq, hidden])
    first = L.slice(h, axes=[1], starts=[0], ends=[1])
    pooled = fc(first, "pooled_fc", hidden, hidden, ncol=1,
                activation_type="tanh")
    # shape inference loses the batch axis through the reshape2 to
    # [B·T, FFN] (the placeholder batch times T reads as a static dim), in
    # both packages: the outputs are declared batch-major, so a batch the
    # executor pads to a bucket is sliced back
    h.shape, pooled.shape = (-1, seq, hidden), (-1, hidden)
    return h, pooled


def ernie_fused_params(state):
    """``ernie_fused_program``'s parameters from a ``BertModel``
    ``state_dict`` of numpy arrays: the packed QKV weight is concat(Wq,
    Wk, Wv) on axis 1, its bias concat(bq, bk, bv)."""
    out = {}

    def put(name, key):
        out[name] = np.asarray(state[key], "float32")

    e = "embeddings."
    put("word_embedding", e + "word_embeddings.weight")
    put("pos_embedding", e + "position_embeddings.weight")
    put("sent_embedding", e + "token_type_embeddings.weight")
    put("pre_encoder_layer_norm_scale", e + "layer_norm.weight")
    put("pre_encoder_layer_norm_bias", e + "layer_norm.bias")
    layers = sorted({int(k.split(".")[2]) for k in state
                     if k.startswith("encoder.layers.")})
    for i in layers:
        s, p = f"encoder.layers.{i}.", f"encoder_layer_{i}_"
        for kind, suffix in (("weight", "w_0"), ("bias", "b_0")):
            out[p + "multi_head_att_qkv." + suffix] = np.concatenate(
                [np.asarray(state[f"{s}self_attn.{n}_proj.{kind}"],
                            "float32") for n in "qkv"], axis=-1)
            put(p + "multi_head_att_output_fc." + suffix,
                f"{s}self_attn.out_proj.{kind}")
            put(p + "ffn_fc_0." + suffix, f"{s}linear1.{kind}")
            put(p + "ffn_fc_1." + suffix, f"{s}linear2.{kind}")
        for n, norm in (("post_att_layer_norm", "norm1"),
                        ("post_ffn_layer_norm", "norm2")):
            put(p + n + "_scale", f"{s}{norm}.weight")
            put(p + n + "_bias", f"{s}{norm}.bias")
    put("pooled_fc.w_0", "pooler.dense.weight")
    put("pooled_fc.b_0", "pooler.dense.bias")
    return out


def ernie_feed(cfg, rows, seed):
    """ERNIE inference's four feeds: random ids, positions 0..T-1, the
    second sentence from a random step on, and ``input_mask`` m in
    {9999, 10000}: the model's (m - 10000)·10000 then gives a bias of
    -1e4 past a random length and 0 before it (with m in {0, 1} the bias
    is about -1e8, where float32 keeps scores only in steps of 8)."""
    rng = np.random.RandomState(seed)
    seq = cfg["seq"]
    steps = np.arange(seq)[None, :]
    lengths = rng.randint(1, seq + 1, (rows, 1))
    return {"src_ids": rng.randint(0, cfg["vocab"], (rows, seq))
            .astype("int64"),
            "pos_ids": np.repeat(steps, rows, axis=0).astype("int64"),
            "sent_ids": (steps >= rng.randint(1, seq + 1, (rows, 1)))
            .astype("int64"),
            "input_mask": np.where(steps < lengths, 10000.0, 9999.0)
            .astype("float32")}


def ernie_eager(model, to_variable, feed):
    """The eager ``BertModel``'s (sequence, pooled) outputs for an ERNIE
    feed, as host arrays."""
    seq, pooled = model(to_variable(feed["src_ids"]),
                        to_variable(feed["sent_ids"]),
                        to_variable(feed["input_mask"]),
                        to_variable(feed["pos_ids"]))
    return seq.numpy(), pooled.numpy()


def ernie_fused_types(layers):
    """The op types ``ernie_fused_program`` appends for ``layers``."""
    return {"fused_embedding_eltwise_layernorm": 1, "fc": 3 * layers + 1,
            "multihead_matmul": layers, "skip_layernorm": layers,
            "gelu": layers, "fused_fc_elementwise_layernorm": layers,
            "reshape2": 3 * layers + 1, "scale": 1, "slice": 1}


def ernie_qk_swapped(params, hidden):
    """The twin's weights: Q's and K's columns of every packed QKV weight
    and bias swapped."""
    out = dict(params)
    for n, v in params.items():
        if "multi_head_att_qkv" in n:
            out[n] = np.concatenate([v[..., hidden:2 * hidden],
                                     v[..., :hidden], v[..., 2 * hidden:]],
                                    axis=-1)
    return out


def ernie_err(got, want):
    """The worst |got - want| over the largest |want|, over both
    outputs."""
    return max(float(np.abs(np.asarray(g) - w).max())
               / float(np.abs(w).max()) for g, w in zip(got, want))


def _ernie_serve(pred, feed):
    for n in pred.get_input_names():
        pred.get_input_handle(n).copy_from_cpu(feed[n])
    pred.run()
    return [pred.get_output_handle(n).copy_to_cpu()
            for n in pred.get_output_names()]


def _ernie_leg(card):
    """4x (a): the eager ``BertModel`` (4o (d)'s, its dropouts off:
    ERNIE_EAGER_DROPOUT) at ERNIE's width made on the card from the seed,
    its ``state_dict`` packed by
    ``ernie_fused_params`` into ``ernie_fused_program``,
    ``save_inference_model``, ``load_inference_model`` into a fresh scope
    (its run against the eager forward) and ``AnalysisPredictor`` with
    ir_optim on at ERNIE_ROWS: exactly one ``flash_attention_fwd`` launch
    a layer a run and no other counted kernel, no input copied for
    alignment, sequence and pooled outputs within ERNIE_TOL of the
    largest |value| of the eager forward's; the twin with Q and K
    swapped in every packed weight must miss by 10 times or more; each
    batch's run profiled.  Returns the launches of each predictor run and
    the numbers."""
    import torch
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.dygraph import base as dy
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    from paddle_tpu_torch.models.bert import BertModel

    cfg, layers = ERNIE, ERNIE["layers"]
    rows_max = max(ERNIE_ROWS)
    t0 = time.perf_counter()
    feeds = {rows: ernie_feed(cfg, rows, SEED + 220 + rows)
             for rows in ERNIE_ROWS}
    place = fluid.CUDAPlace(0)
    with dy.guard(place):
        np.random.seed(SEED)
        model = BertModel(**DY, **ERNIE_EAGER_DROPOUT)
        model.eval()
        state = model.state_dict()
        want = {rows: ernie_eager(model, dy.to_variable, f)
                for rows, f in feeds.items()}
    del model
    params = ernie_fused_params(state)
    twin_qkv = {n: v for n, v in ernie_qk_swapped(params, cfg["hidden"])
                .items() if "multi_head_att_qkv" in n}
    del state
    out, launches = {"eager_s": time.perf_counter() - t0}, {}
    with _fresh_fluid_globals(), tempfile.TemporaryDirectory() as tmp:
        main, _, (seq, pooled), _ = _book_program(ernie_fused_program,
                                                  False, cfg=cfg)
        types = [op.type for op in main.global_block().ops]
        got_types = {k: types.count(k) for k in ernie_fused_types(layers)}
        if got_types != ernie_fused_types(layers) \
                or len(types) != sum(got_types.values()):
            raise SystemExit(f"chip_smoke: the fused ERNIE program holds "
                             f"{types}")
        exe = fluid.Executor(place)
        model_dir = os.path.join(tmp, "ernie_fused")
        t1 = time.perf_counter()
        scope = interop.scope_from_numpy(params, fluid.Scope(), place)
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(
                model_dir, list(ERNIE_FEEDS), [seq, pooled], exe,
                main_program=main, params_filename="params")
        del scope, params
        out["save_s"] = time.perf_counter() - t1
        out["bytes"] = _dir_bytes(model_dir)
        # load_inference_model into a fresh scope, one executor run
        with fluid.scope_guard(fluid.Scope()):
            prog, feed_names, fetches = fluid.io.load_inference_model(
                model_dir, exe, params_filename="params")
            f = feeds[rows_max]
            out["loaded_err"] = ernie_err(
                exe.run(prog, feed={n: f[n] for n in feed_names},
                        fetch_list=fetches), want[rows_max])
        pscope = fluid.Scope()
        with fluid.scope_guard(pscope):
            config = AnalysisConfig(model_dir, params_file=os.path.join(
                model_dir, "params"))
            config.switch_ir_optim(True)
            pred = create_predictor(config)
            served_types = [op.type for op in
                            pred._program.global_block().ops]
            _flash_copies_zero()
            for rows, f in feeds.items():
                got, c = _counted_run(
                    f"the fused ERNIE predictor at {rows} rows",
                    lambda: _ernie_serve(pred, f),
                    {"flash_attention_fwd": layers})
                launches[rows] = c
                out[rows] = {"err": ernie_err(got, want[rows]),
                             "shapes": [list(g.shape) for g in got]}
            _flash_copies_check("4x fused ERNIE predictor")
            for rows, f in feeds.items():
                prof = _profile(lambda: _ernie_serve(pred, f),
                                ERNIE_PROFILED, warmup=2)
                out[rows].update(host_ms=prof[0], busy_ms=prof[1],
                                 idle=prof[2], kernels=prof[3],
                                 by_class=prof[4],
                                 rows_s=rows / prof[0] * 1e3)
            # the twin: Q and K swapped in every packed weight, in place
            for n, v in twin_qkv.items():
                pscope.find_var(n).copy_(torch.from_numpy(v))
            out["twin"] = ernie_err(_ernie_serve(pred, feeds[rows_max]),
                                    want[rows_max])
        del pred, pscope
    torch.cuda.empty_cache()
    out["total_s"] = time.perf_counter() - t0
    served = {t: served_types.count(t) for t in sorted(set(served_types))}
    _p(f"4x (a): fused ERNIE-form BERT-base, {len(types)} ops {got_types}; "
       f"after the predictor's passes {served}; the eager BertModel's "
       f"forwards {out['eager_s']:.1f} s; save_inference_model "
       f"{out['save_s']:.1f} s ({out['bytes'] / 1e6:.0f} MB); "
       f"load_inference_model's run at {rows_max} rows against the eager "
       f"forward {out['loaded_err']:.2e} of the largest |value| (tolerance "
       f"{ERNIE_TOL})  [{card}]")
    for rows in ERNIE_ROWS:
        _p(f"4x (a): AnalysisPredictor at {rows} rows: outputs "
           f"{out[rows]['shapes']}, launches "
           f"{ {k: v for k, v in launches[rows].items() if v} }, worst "
           f"|served - eager| / largest {out[rows]['err']:.2e} (tolerance "
           f"{ERNIE_TOL})  [{card}]")
    _p(f"4x (a): the Q/K-swapped twin misses by "
       f"{out['twin'] / ERNIE_TOL:.0f} times the tolerance (10 or more "
       f"misses)")
    for rows in ERNIE_ROWS:
        r = out[rows]
        _p(f"profile fused ERNIE predictor, {rows} rows: host "
           f"{r['host_ms']:.3f} ms/run ({r['rows_s']:.1f} rows/s), device "
           f"busy {r['busy_ms']:.3f} ms/run, idle share {r['idle']:.4f}, "
           f"{r['kernels']:.0f} kernels/run  [{card}]")
        _print_classes(r["by_class"], "run")
    bad = [r for r in ERNIE_ROWS if out[r]["err"] > ERNIE_TOL
           or out[r]["shapes"] != [[r, cfg["seq"], cfg["hidden"]],
                                   [r, cfg["hidden"]]]]
    if bad or out["loaded_err"] > ERNIE_TOL \
            or served.get("multihead_matmul") != layers:
        raise SystemExit("chip_smoke: the fused ERNIE program disagrees "
                         "with the eager BertModel")
    if out["twin"] < 10 * ERNIE_TOL:
        raise SystemExit("chip_smoke: the fused ERNIE check cannot tell Q "
                         "from K")
    return launches, out


def _fused_op_cases():
    """4x (b): the slice's 35 op types at the shapes their users give
    them, {label: (op, inputs, attrs)}: the ERNIE ops at BERT-base's
    MAX_BATCH x 128 (``multihead_matmul`` launches the flash kernel on the packed
    QKV's strided views), ``conv_fusion``, ``fused_bn_add_activation``
    and ``inplace_abn`` at ResNet-50's [128, 256, 56, 56], the recurrent
    fusions and ``rnn`` at the PTB width (batch 20, 35 steps, hidden
    1500), ``fusion_transpose_flatten_concat`` over MobileNet-SSD's six
    loc heads, ``correlation`` at FlowNetC's [1, 256, 48, 64] (21 x 21
    displacements), ``bilateral_slice`` at HDRnet's 16 x 16 x 8 grid over
    256² guides, ``fsp`` and the interpolations on [MAX_BATCH / 4, 256,
    28, 28] maps, the rest at their models' widths."""
    from paddle_tpu_torch.ops.catalog_tail_ops import register_py_func

    rng = np.random.default_rng(SEED + 230)

    def r(*shape, scale=1.0):
        x = rng.standard_normal(shape, dtype=np.float32)
        return x * np.float32(scale) if scale != 1.0 else x

    b, t, hd, ffn = MAX_BATCH, ERNIE["seq"], ERNIE["hidden"], ERNIE["ffn"]
    # FlowNetC's correlation on one image pair, HDRnet on 4 guides, the
    # distillation maps and the decoder's upsampling at a quarter batch
    flow_b, hdr_b, map_b = 1, max(1, b // 8), max(1, b // 4)
    mask = np.where(np.arange(t)[None, :] < rng.integers(1, t + 1, (b, 1)),
                    0.0, -1e4).astype("float32").reshape(b, 1, 1, t)
    pos = np.repeat(np.arange(t)[None, :], b, 0).astype("int64")
    ids = [rng.integers(0, ERNIE["vocab"], (b, t)).astype("int64"), pos,
           (pos >= t // 2).astype("int64")]
    bn = {"Scale": r(256), "Bias": r(256), "Mean": r(256, scale=0.1),
          "Variance": np.abs(r(256)) + 0.5}
    # one ResNet-50 conv2_x map feeds the three ops that take one
    img, img_z = r(RESNET_BATCH, 256, 56, 56), r(RESNET_BATCH, 256, 56, 56)
    pb, pt, ph = PTB_BATCH, PTB_T, PTB["hidden_size"]
    w = 0.02
    # max-unpooling indices: each pooled cell's argmax inside its 2x2
    # window of the [8, 64, 224, 224] map
    ii, jj = np.meshgrid(np.arange(112), np.arange(112), indexing="ij")
    di, dj = rng.integers(0, 2, (2, 8, 64, 112, 112))
    unpool_idx = ((2 * ii + di) * 224 + 2 * jj + dj).astype("int32")
    # MobileNet-SSD's loc heads: 4 x priors channels over its six maps
    heads = [(12, 19), (24, 10), (24, 5), (24, 3), (24, 2), (24, 1)]
    fid = register_py_func(np.tanh)
    return {
        "multihead_matmul": (
            "multihead_matmul", {"Input": r(b, t, 3 * hd), "BiasQK": mask},
            {"head_number": ERNIE["heads"],
             "alpha": (hd // ERNIE["heads"]) ** -0.5}),
        "fused_embedding_eltwise_layernorm": (
            "fused_embedding_eltwise_layernorm",
            {"Ids": ids, "Embs": [r(ERNIE["vocab"], hd, scale=w),
                                  r(t, hd, scale=w), r(2, hd, scale=w)],
             "Scale": r(hd), "Bias": r(hd)}, {"epsilon": ERNIE_EPS}),
        "fc": ("fc", {"Input": r(b, t, hd), "W": r(hd, 3 * hd, scale=w),
                      "Bias": r(3 * hd)}, {"in_num_col_dims": 2}),
        "fc tanh (pooler)": (
            "fc", {"Input": r(b, 1, hd), "W": r(hd, hd, scale=w),
                   "Bias": r(hd)},
            {"in_num_col_dims": 1, "activation_type": "tanh"}),
        "skip_layernorm": (
            "skip_layernorm", {"X": r(b, t, hd), "Y": r(b, t, hd),
                               "Scale": r(hd), "Bias": r(hd)},
            {"epsilon": ERNIE_EPS}),
        "fused_fc_elementwise_layernorm": (
            "fused_fc_elementwise_layernorm",
            {"X": r(b * t, ffn), "W": r(ffn, hd, scale=w), "Bias0": r(hd),
             "Y": r(b * t, hd), "Scale": r(hd), "Bias1": r(hd)},
            {"epsilon": ERNIE_EPS}),
        "add_position_encoding": ("add_position_encoding",
                                  {"X": r(b, t, hd)},
                                  {"alpha": 1.0, "beta": 1.0}),
        "fusion_seqexpand_concat_fc": (
            "fusion_seqexpand_concat_fc",
            {"X": [r(b, t, hd), r(b, hd)],
             "FCWeight": r(2 * hd, hd, scale=w), "FCBias": r(hd)},
            {"fc_activation": "tanh"}),
        "fusion_seqconv_eltadd_relu": (
            "fusion_seqconv_eltadd_relu",
            {"X": r(b, t, hd), "Filter": r(3 * hd, hd, scale=w),
             "Bias": r(hd)}, {"contextLength": 3, "contextStart": -1}),
        "segment_pool": ("segment_pool",
                         {"X": r(b * t, hd),
                          "SegmentIds": np.repeat(np.arange(b), t)},
                         {"pooltype": "MEAN"}),
        "conv_fusion": ("conv_fusion",
                        {"Input": img, "Filter": r(64, 256, 1, 1,
                                                     scale=w),
                         "Bias": r(64)}, {"activation": "relu"}),
        "fused_bn_add_activation": ("fused_bn_add_activation",
                                    dict(bn, X=img, Z=img_z),
                                    {"act_type": "relu"}),
        "inplace_abn": ("inplace_abn", dict(bn, X=img),
                        {"activation": "leaky_relu"}),
        "fsp": ("fsp", {"X": r(map_b, 256, 28, 28),
                        "Y": r(map_b, 256, 28, 28)}, {}),
        "interpolate": ("interpolate", {"X": r(map_b, 256, 28, 28)},
                        {"interp_method": "bilinear", "out_h": 56,
                         "out_w": 56}),
        "interpolate_v2": ("interpolate_v2", {"X": r(map_b, 256, 28, 28)},
                           {"interp_method": "nearest", "out_h": 56,
                            "out_w": 56}),
        "frobenius_norm": ("frobenius_norm", {"X": r(hd, ffn)}, {}),
        "fusion_conv_inception": (
            "fusion_conv_inception",
            {"Input": r(b, 192, 28, 28),
             "Filter": [r(64, 192, 1, 1, scale=w),
                        r(128, 192, 3, 3, scale=w),
                        r(32, 192, 5, 5, scale=w)],
             "Bias": [r(64), r(128), r(32)]}, {}),
        "unpool": ("unpool", {"X": r(8, 64, 112, 112),
                              "Indices": unpool_idx},
                   {"unpooled_height": 224, "unpooled_width": 224}),
        "crop": ("crop", {"X": r(b, 3, 256, 256), "Y": r(b, 3, 224, 224),
                          "Offsets": np.array([0, 0, 16, 16], "int32")},
                 {}),
        "expand_as": ("expand_as", {"X": r(b, 1, hd),
                                    "target_tensor": r(b, t, hd)}, {}),
        "similarity_focus": ("similarity_focus", {"X": r(b, 3, 56, 56)},
                             {"axis": 1, "indexes": [0, 2]}),
        "correlation": ("correlation", {"Input1": r(flow_b, 256, 48, 64),
                                        "Input2": r(flow_b, 256, 48, 64)},
                        {"pad_size": 20, "kernel_size": 1,
                         "max_displacement": 20, "stride1": 1,
                         "stride2": 2}),
        "bilateral_slice": ("bilateral_slice",
                            {"X": r(hdr_b, 3, 256, 256),
                             "Grid": r(hdr_b, 12, 8, 16, 16),
                             "Guide": rng.random((hdr_b, 256, 256),
                                                 dtype=np.float32)},
                            {"has_offset": False}),
        "fusion_transpose_flatten_concat": (
            "fusion_transpose_flatten_concat",
            {"X": [r(SSD_BATCH, c, s, s) for c, s in heads]},
            {"trans_axis": [0, 2, 3, 1], "flatten_axis": 1,
             "concat_axis": 1}),
        "fusion_repeated_fc_relu": (
            "fusion_repeated_fc_relu",
            {"X": r(4096, 416), "W": [r(416, 512, scale=w),
                                      r(512, 256, scale=w),
                                      r(256, 128, scale=w)],
             "Bias": [r(512), r(256), r(128)]}, {}),
        "fusion_squared_mat_sub": (
            "fusion_squared_mat_sub",
            {"X": r(4096, 416), "Y": r(416, 16, scale=w)}, {"scalar": 0.5}),
        "lstm_unit": ("lstm_unit", {"X": r(pb, 4 * ph),
                                    "C_prev": r(pb, ph)},
                      {"forget_bias": 0.0}),
        "fusion_lstm": ("fusion_lstm",
                        {"X": r(pb, pt, ph),
                         "WeightX": r(ph, 4 * ph, scale=w),
                         "WeightH": r(ph, 4 * ph, scale=w),
                         "Bias": r(1, 4 * ph, scale=w)}, {}),
        "fusion_gru": ("fusion_gru",
                       {"X": r(pb, pt, ph),
                        "WeightX": r(ph, 3 * ph, scale=w),
                        "WeightH": r(ph, 3 * ph, scale=w),
                        "Bias": r(1, 3 * ph, scale=w)}, {}),
        "rnn": ("rnn", {"Input": r(pb, pt, ph),
                        "WeightList": [r(ph, 4 * ph, scale=w),
                                       r(4 * ph, ph, scale=w),
                                       r(4 * ph, scale=w),
                                       r(4 * ph, scale=w)] * 2},
                {"mode": "LSTM", "num_layers": 2, "hidden_size": ph}),
        "multi_gru": ("multi_gru",
                      {"X": r(pb, pt, ph),
                       "WeightX": [r(ph, 3 * ph, scale=w)] * 2,
                       "WeightH": [r(ph, 3 * ph, scale=w)] * 2,
                       "Bias": [r(1, 3 * ph, scale=w)] * 2}, {}),
        "fused_embedding_fc_lstm": (
            "fused_embedding_fc_lstm",
            {"Ids": rng.integers(0, PTB["vocab_size"], (pb, pt))
             .astype("int64"),
             "Embeddings": r(PTB["vocab_size"], 4 * ph, scale=w),
             "WeightH": r(ph, 4 * ph, scale=w),
             "Bias": r(1, 4 * ph, scale=w)}, {}),
        "attention_lstm": ("attention_lstm",
                           {"X": r(b, 50, 256),
                            "AttentionWeight": r(512, 1, scale=w),
                            "LSTMWeight": r(512, 1024, scale=w),
                            "LSTMBias": r(1, 1024, scale=w)}, {}),
        "fusion_group": ("fusion_group",
                         {"Inputs": [r(b, t, hd), r(b, hd)]}, {}),
        "py_func": ("py_func", {"X": r(b, t, hd)},
                    {"forward_callable_id": fid,
                     "out_shapes": [[b, t, hd]],
                     "out_dtypes": ["float32"]}),
    }


def _fused_ops_on_the_card(card):
    """4x (b): each op type's forward ms on the card (CUDA events) and,
    against the host, its forward and ``generic_grad`` where it is
    differentiable (``_op_card_err``; FUSED_KINK's cotangents 0 near
    ReLU's kink, FUSED_GRAD_F64's gradients in float64), within FUSED_CARD_TOL of each output's largest |value|;
    ``multihead_matmul``'s card run launches
    the flash kernel once, with no copy of its strided Q, K and V;
    ``py_func``'s card run copies its input to the host and its output
    back (2 copies)."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels
    from paddle_tpu_torch.ops.catalog_tail_ops import _py_func
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    worst, ms, secs, broken = {}, {}, {}, []
    rng = np.random.default_rng(SEED + 231)
    ctx = LoweringContext(device=torch.device(DEVICE))
    cases = _fused_op_cases()
    flash = cuda_kernels.flash_attention_fwd
    for label, (op, ins, attrs) in cases.items():
        dev_ins = {k: [torch.from_numpy(np.array(a)).to(DEVICE)
                       for a in (v if isinstance(v, list) else [v])]
                   for k, v in ins.items()}
        fwd = get_op(op).fn
        ms[label] = _ms(lambda: fwd(dev_ins, dict(attrs), ctx), 3, warmup=1)
        del dev_ins
        if op in ("multihead_matmul", "py_func"):
            flash.launches = flash.copies = _py_func.copies = 0
            _op_run(op, ins, attrs, DEVICE)
            counts = (flash.launches, flash.copies, _py_func.copies)
            if counts != ((1, 0, 0) if op == "multihead_matmul"
                          else (0, 0, 2)):
                broken.append(f"{label}: (flash launches, flash copies, "
                              f"py_func copies) {counts}")
        t0 = time.perf_counter()
        worst[label] = _op_card_err(op, ins, attrs, FUSED_CARD_TOL, rng,
                                    kink=FUSED_KINK.get(op, 0.0),
                                    grad_f64=op in FUSED_GRAD_F64)
        secs[label] = time.perf_counter() - t0
    types = {op for op, _, _ in cases.values()}
    _p("fused tier op types on the card, forward ms: "
       + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f"  [{card}]")
    _p("fused tier op types, s of each card-against-host check: "
       + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    _p(f"fused tier op types on the card against the host ({len(types)} "
       f"types), forward and generic_grad, error / {FUSED_CARD_TOL} of the "
       "largest |value| (under 1 passes): "
       + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
       + f"; broken {broken}  [{card}]")
    if max(worst.values()) > 1 or broken or len(types) != 35:
        raise SystemExit("chip_smoke: a fused tier op type disagrees with "
                         "the host on the card")
    return {"worst": worst, "ms": ms}


def phase_fused_tier(card):
    """Phase 4x, the fused inference tier: (a) BERT-base in Paddle
    Inference's fused ERNIE form served by ``AnalysisPredictor`` against
    the eager ``BertModel``, with a twin and a profile; (b) the slice's op
    types on the card against the host.  Returns (a)'s launches of each
    predictor run and the numbers."""
    t = time.perf_counter()
    launches, ernie = _ernie_leg(card)
    _p(f"phase 4x (a): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ops = _fused_ops_on_the_card(card)
    _p(f"phase 4x (b): {time.perf_counter() - t:.1f} s")
    return launches, {"ernie": ernie, "ops": ops}


# ---------------------------------------------------------------------------
# phase 4y: the plumbing tail.  (a) Static BERT-base training checkpointed
# and resumed through Paddle 1.8's save_vars / load_vars programs; (b) the
# slice's other op types at their users' widths, card against host
# ---------------------------------------------------------------------------
CKPT_STEPS = 4                 # (a): the uninterrupted run's steps
CKPT_AT = 2                    # (a): steps before the checkpoint
CKPT_HOST_RTOL = 1e-4          # (a): the host step, 4b's card-vs-host rtol
CKPT_TWIN_MISS = 10 * CKPT_HOST_RTOL   # (a): the twin's least miss
PLUMB_CARD_TOL = 1e-4          # (b): of each output's largest |value|
# (b): the sparse-table ops at phase 4v's CTR width: 26 slots of [4096, 5]
# Zipf ids over 1e6 values a slot, rows of 16
PLUMB_TABLE = dict(slots=JOIN["slots"], batch=JOIN["batch"], seq=JOIN["seq"],
                   dim=JOIN["dim"], ids=JOIN["ids"], lr=1e-3)


def checkpoint_vars(main, scope):
    """The persistable vars of ``main`` that ``scope`` holds, sorted by
    name: what Paddle 1.8's ``save_persistables`` hands ``save_vars``
    (the parameters, Adam's moments, the beta powers, the learning
    rate)."""
    return sorted(n for n, v in main.global_block().vars.items()
                  if v.persistable and scope.find_var(n) is not None)


def checkpoint_program(fluid, main, names, dirname, save, combine=True):
    """The program Paddle 1.8's ``fluid.io.save_vars`` (``save``) or
    ``load_vars`` builds over ``names`` (vars of ``main``), in that
    order: one ``save_combine`` (``load_combine``) over them all to
    ``dirname/__params__``, or (``combine`` False) one ``save``
    (``load``) op a var to ``dirname/<name>``.  Either package's
    ``fluid``."""
    prog = fluid.Program()
    block = prog.global_block()
    src = main.global_block()
    vs = [block.create_var(name=n, shape=src.vars[n].shape,
                           dtype=src.vars[n].dtype, persistable=True)
          for n in names]
    groups = [(os.path.join(dirname, "__params__"), vs)] if combine else \
        [(os.path.join(dirname, v.name), [v]) for v in vs]
    for path, group in groups:
        if save:
            block.append_op(type="save_combine" if combine else "save",
                            inputs={"X": group}, outputs={},
                            attrs={"file_path": path})
        else:
            block.append_op(type="load_combine" if combine else "load",
                            inputs={}, outputs={"Out": group},
                            attrs={"file_path": path})
    return prog


def bert_train_steps(exe, program, loss, scope, feed, n):
    """``n`` steps; their losses as Python floats."""
    return [float(np.asarray(exe.run(program, feed=feed, fetch_list=[loss],
                                      scope=scope)[0]).ravel()[0])
            for _ in range(n)]


def bert_resumed(fluid, place, built, init, feed, dirname, combine=True,
                 skip=()):
    """The port's checkpointed run: CKPT_AT steps from ``init`` (numpy
    persistables), the save program over ``checkpoint_vars``, then a fresh
    ``Scope`` with the startup program run in it, the load program over
    the same vars, and the steps to CKPT_STEPS; the vars named in ``skip``
    are neither saved nor loaded.  ``built``:
    (main, startup, program, loss).  Returns the resumed steps' losses,
    the saved vars as the scope held them (numpy, by name), and the
    save's and load's seconds."""
    from paddle_tpu_torch import interop
    main, startup, program, loss = built
    exe = fluid.Executor(place)
    scope = interop.scope_from_numpy(init, fluid.Scope(), place)
    bert_train_steps(exe, program, loss, scope, feed, CKPT_AT)
    names = [n for n in checkpoint_vars(main, scope) if n not in skip]
    saved = interop.scope_to_numpy(scope, names)
    t0 = time.perf_counter()
    exe.run(checkpoint_program(fluid, main, names, dirname, True, combine),
            scope=scope)
    t_save = time.perf_counter() - t0
    fresh = fluid.Scope()
    exe.run(startup, scope=fresh)
    t0 = time.perf_counter()
    exe.run(checkpoint_program(fluid, main, names, dirname, False, combine),
            scope=fresh)
    t_load = time.perf_counter() - t0
    losses = bert_train_steps(exe, program, loss, fresh, feed,
                              CKPT_STEPS - CKPT_AT)
    return losses, saved, (t_save, t_load)


def _same_bytes(got, want):
    """Names whose arrays differ from ``want``'s in dtype, shape or any
    byte."""
    return sorted(n for n, w in want.items()
                  if got[n].dtype != w.dtype or got[n].shape != w.shape
                  or got[n].tobytes() != w.tobytes())


def _checkpoint_leg(card):
    """4y (a): phase 4b's program and strategy, CKPT_STEPS steps from one
    state uninterrupted, then checkpointed after CKPT_AT steps and resumed
    through save_combine/load_combine and through save/load a var; the
    resumed losses equal the uninterrupted ones bit for bit, the files
    load on the host byte for byte, a host step from them at HOST_ROWS
    agrees with the card's, and a load that leaves Adam's moments out
    misses.  Returns the launches of the uninterrupted run."""
    import tempfile

    import torch
    from paddle_tpu_torch import fluid, interop
    from paddle_tpu_torch.models.static_graphs import \
        build_bert_train_program
    from paddle_tpu_torch.ops import plumbing_ops

    layers = TRAIN["layers"]
    t0 = time.perf_counter()
    main, startup, loss = build_bert_train_program(**TRAIN)
    startup.random_seed = SEED
    card_place = fluid.CUDAPlace(0)
    scope = fluid.Scope()
    exe = fluid.Executor(card_place)
    exe.run(startup, scope=scope)
    weights, _ = _served_weights(main.all_parameters(), layers, SEED)
    interop.scope_from_numpy(weights, scope, card_place)
    bs = fluid.BuildStrategy()
    bs.fuse_attention = bs.fuse_optimizer = True
    program = fluid.CompiledProgram(main, bs)
    program._apply_ir_passes([loss.name])
    init = interop.scope_to_numpy(scope, checkpoint_vars(main, scope))
    built = (main, startup, program, loss)
    feed = _train_feed(np.random.RandomState(SEED + 29), TRAIN_ROWS)
    _p(f"checkpoint: BERT-base training program built, {len(init)} "
       f"persistables ({sum(a.nbytes for a in init.values())} bytes) in "
       f"{time.perf_counter() - t0:.1f} s")
    per_step = {"flash_attention_fwd": 2 * layers,
                "flash_attention_bwd": layers, "fused_adam": 1}
    _flash_copies_zero()
    t0 = time.perf_counter()
    want, launches = _counted_run(
        "the uninterrupted run",
        lambda: bert_train_steps(
            exe, program, loss, interop.scope_from_numpy(
                init, fluid.Scope(), card_place), feed, CKPT_STEPS),
        {k: v * CKPT_STEPS for k, v in per_step.items()})
    wall = time.perf_counter() - t0
    _flash_copies_check("checkpoint")
    _p(f"checkpoint: uninterrupted {CKPT_STEPS} steps at {TRAIN_ROWS} rows "
       f"in {wall:.3f} s, losses {want}; launches {launches}  [{card}]")
    results = {}
    with tempfile.TemporaryDirectory() as d:
        for combine in (True, False):
            label = "save_combine/load_combine" if combine else "save/load"
            path = os.path.join(d, "combine" if combine else "each")
            plumbing_ops.HOST_COPIES.update(to_host=0, to_card=0)
            (got, saved, (t_save, t_load)), resumed = _counted_run(
                f"the run resumed through {label}",
                lambda: bert_resumed(fluid, card_place, built, init, feed,
                                     path, combine),
                {k: v * CKPT_STEPS for k, v in per_step.items()})
            copies = dict(plumbing_ops.HOST_COPIES)
            nbytes = _dir_bytes(path)
            _p(f"checkpoint: resumed through {label}: losses of steps "
               f"{CKPT_AT + 1}-{CKPT_STEPS} {got} against {want[CKPT_AT:]} "
               f"(bit for bit); save {t_save:.3f} s, load {t_load:.3f} s, "
               f"{nbytes} bytes in {len(os.listdir(path))} files; host "
               f"copies {copies} for {len(saved)} vars; launches {resumed} "
               f"(the save and load programs none)  [{card}]")
            if got != want[CKPT_AT:]:
                raise SystemExit(f"chip_smoke: the run resumed through "
                                 f"{label} lost the uninterrupted losses")
            crossed = len(saved) if torch.device(DEVICE).type == "cuda" \
                else 0      # a host tensor crosses nothing
            if copies != {"to_host": crossed, "to_card": crossed}:
                raise SystemExit(f"chip_smoke: the {label} programs did "
                                 f"not copy each var once each way")
            results[label] = dict(losses=got, save_s=t_save, load_s=t_load,
                                  bytes=nbytes, vars=len(saved))
            if not combine:
                continue
            # the files on the host: byte for byte, then one host step
            # from them against one card step, both at HOST_ROWS
            host_place = fluid.CPUPlace()
            host_feed = _train_feed(np.random.RandomState(SEED + 30),
                                    HOST_ROWS)
            names = sorted(saved)
            rows = {}
            for place in (host_place, card_place):
                s = fluid.Scope()
                fluid.Executor(place).run(checkpoint_program(
                    fluid, main, names, path, False), scope=s)
                if place is host_place:
                    diff = _same_bytes(interop.scope_to_numpy(s, names),
                                       saved)
                rows[place is host_place] = bert_train_steps(
                    fluid.Executor(place), program, loss, s, host_feed, 1)[0]
            _p(f"checkpoint: the card's file loaded on the host, vars "
               f"differing in any byte {diff}; one step at {HOST_ROWS} rows "
               f"from it, card {rows[False]}, host {rows[True]} "
               f"(rtol {CKPT_HOST_RTOL})  [{card}]")
            if diff or not np.isclose(rows[False], rows[True],
                                      rtol=CKPT_HOST_RTOL, atol=0.0):
                raise SystemExit("chip_smoke: the card's checkpoint does "
                                 "not give the host the card's state")
        # the twin: what saving only the parameters gives, Adam's moment
        # accumulators left at the startup program's zeros.  Step 3's loss
        # is computed before step 3's update, the first the moments move,
        # so the twin is held at step 4
        moments = [n for n in init if "_moment" in n]
        twin, _, _ = bert_resumed(fluid, card_place, built, init, feed,
                                  os.path.join(d, "twin"), skip=moments)
    miss = abs(twin[-1] - want[-1]) / abs(want[-1])
    _p(f"checkpoint: the twin without the {len(moments)} moment "
       f"accumulators: losses {twin} against {want[CKPT_AT:]}; step "
       f"{CKPT_STEPS} misses by {miss:.3e} relative, at least "
       f"{CKPT_TWIN_MISS:.0e} needed  [{card}]")
    if miss < CKPT_TWIN_MISS:
        raise SystemExit("chip_smoke: the checkpoint check cannot tell a "
                         "load without Adam's moments")
    # one step of the run profiled (4b's step, here from the checkpoint
    # leg's state)
    prof_scope = interop.scope_from_numpy(init, fluid.Scope(), card_place)
    host_ms, busy_ms, idle, n_kern, by_class = _profile(
        lambda: exe.run(program, feed=feed, fetch_list=[loss],
                        scope=prof_scope, return_numpy=False), 2)
    top = sorted(by_class.items(), key=lambda kv: -kv[1])[:6]
    _p(f"checkpoint: a step profiled, {TRAIN_ROWS} rows: host "
       f"{host_ms:.3f} ms, busy {busy_ms:.3f} ms, idle {idle:.4f}, "
       f"{n_kern:.0f} kernels; "
       + ", ".join(f"{k} {v:.4f}" for k, v in top) + f"  [{card}]")
    torch.cuda.synchronize()
    return launches, dict(results, uninterrupted=want, twin=twin,
                          twin_miss=miss, step_s=wall / CKPT_STEPS,
                          host_ms=host_ms, busy_ms=busy_ms, idle=idle)


def _plumb_op_cases():
    """4y (b): {label: (op, inputs, attrs)} at their users' widths: the
    gradient bucket of BERT-base, SPP-net's conv5 map, ShuffleNetV2's
    stage-2 map, a ranking batch of 4096 rows, a 1e6 x 16 table, the SRL
    tier's [10, 64, 512] activations, phase 4v's CTR ids."""
    rng = np.random.default_rng(SEED + 290)

    def f(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    t = PLUMB_TABLE
    n_ids = t["slots"] * t["batch"] * t["seq"]
    ids = rng.integers(0, t["ids"], n_ids).astype(np.int64)
    srl = (SRL_BATCH, SRL_STEPS, SRL["hidden"])
    mask = (rng.random((SRL_BATCH, 1)) < 0.5).astype(np.int64)
    ranked = 4096
    heav = f(4096, 768)
    heav[rng.random(heav.shape) < 0.1] = 0.0
    return {
        "coalesce_tensor, BERT-base's gradients": (
            "coalesce_tensor",
            {"Input": [f(*s) for s in _bert_param_shapes()]}, {}),
        "spp, SPP-net conv5 [64, 256, 13, 13], 3 levels, max": (
            "spp", {"X": f(64, 256, 13, 13)},
            {"pyramid_height": 3, "pooling_type": "max"}),
        "spp, avg": ("spp", {"X": f(64, 256, 13, 13)},
                     {"pyramid_height": 3, "pooling_type": "avg"}),
        "shuffle_channel, ShuffleNetV2 [128, 116, 28, 28], 2 groups": (
            "shuffle_channel", {"X": f(128, 116, 28, 28)}, {"group": 2}),
        "positive_negative_pair, 4096 rows of 128 queries": (
            "positive_negative_pair",
            {"Score": np.round(f(ranked, 1), 2),
             "Label": rng.integers(0, 4, (ranked, 1)).astype(np.float32),
             "QueryID": np.repeat(np.arange(128), ranked // 128)
             .reshape(ranked, 1).astype(np.int64)}, {}),
        "proximal_gd, [1e6, 16]": (
            "proximal_gd", {"Param": f(t["ids"], t["dim"]),
                            "Grad": f(t["ids"], t["dim"]),
                            "LearningRate": np.array([0.01], np.float32)},
            {"l1": 1e-3, "l2": 1e-3}),
        "proximal_adagrad, [1e6, 16]": (
            "proximal_adagrad",
            {"Param": f(t["ids"], t["dim"]), "Grad": f(t["ids"], t["dim"]),
             "Moment": np.abs(f(t["ids"], t["dim"])),
             "LearningRate": np.array([0.01], np.float32)},
            {"l1": 1e-3, "l2": 1e-3}),
        "minus, [4096, 768]": ("minus", {"X": f(4096, 768),
                                         "Y": f(4096, 768)}, {}),
        "elementwise_heaviside, [4096, 768]": (
            "elementwise_heaviside", {"X": heav, "Y": f(4096, 768)}, {}),
        "modified_huber_loss, CTR logits [4096, 1]": (
            "modified_huber_loss",
            {"X": 2 * f(4096, 1),
             "Y": rng.integers(0, 2, (4096, 1)).astype(np.float32)}, {}),
        "fill_diagonal, [768, 768]": ("fill_diagonal", {"X": f(768, 768)},
                                      {"value": 1.0}),
        "pad_constant_like, [32, 100, 768] to [32, 128, 768]": (
            "pad_constant_like", {"X": f(32, 128, 768), "Y": f(32, 100, 768)},
            {"pad_value": 0.5}),
        "diag, 768": ("diag", {"Diagonal": f(768)}, {}),
        "lod_reset, SRL [10, 64, 512]": (
            "lod_reset", {"X": f(*srl), "Y": np.full((SRL_BATCH,), SRL_STEPS,
                                                    np.int64)}, {}),
        "split_lod_tensor, SRL": ("split_lod_tensor",
                                  {"X": f(*srl), "Mask": mask}, {}),
        "merge_lod_tensor, SRL": ("merge_lod_tensor",
                                  {"InTrue": f(*srl), "InFalse": f(*srl),
                                   "Mask": mask}, {}),
        "rnn_memory_helper, SRL [10, 512]": (
            "rnn_memory_helper", {"X": f(SRL_BATCH, SRL["hidden"])}, {}),
        **{f"{op}, SRL": (op, {"X": f(*srl)}, {})
           for op in ("memcpy", "memcpy_h2d", "memcpy_d2h")},
        **{f"{op}, a CTR gradient [{n_ids}, 16]": (
            op, {"X": f(n_ids, t["dim"])}, {})
           for op in ("merge_selected_rows", "get_tensor_from_selected_rows")},
        "split_selected_rows, the BERT-base embedding in 4": (
            "split_selected_rows", {"X": f(BERT_BASE["vocab"],
                                          BERT_BASE["hidden"])},
            {"height_sections": [7631, 7631, 7630, 7630]}),
        "slice_multi_tensor, SRL": ("slice_multi_tensor",
                                    {"X": [f(*srl), f(*srl)]},
                                    {"begin": 2, "end": 8}),
        "split_ids, CTR ids in 4 shards": ("split_ids", {"Ids": ids},
                                           {"num": 4}),
        "lookup_sparse_table_grad_split, CTR in 4 shards": (
            "lookup_sparse_table_grad_split",
            {"Ids": ids, "Grad": f(n_ids, t["dim"])}, {"num": 4}),
        "pull_sparse_v2, CTR [1e6, 16]": (
            "pull_sparse_v2",
            {"W": f(t["ids"], t["dim"]),
             "Ids": [a.reshape(t["batch"], t["seq"])
                     for a in ids.reshape(t["slots"], -1)]}, {}),
        "empty, [4096, 768]": ("empty", {}, {"shape": [4096, 768],
                                             "dtype": "float32"}),
        "fill, 768 values": ("fill", {}, {"value": [float(v) for v in
                                                    f(768)],
                                          "shape": [768],
                                          "dtype": "float32"}),
        "fake_init, [1e6, 16]": ("fake_init", {}, {"shape": [t["ids"],
                                                             t["dim"]]}),
        "delete_var": ("delete_var", {}, {}),
    }


def _lod_array_ops(dev, x):
    """The tensor-array and rank-table ops over SRL activations ``x``
    [B, T, H] on ``dev``: X as an array of its B rows, back to a tensor,
    stacked on axis 1, the rank table's max length, the memory shrunk at
    three steps.  Returns {label: numpy output}."""
    import torch
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    ctx = LoweringContext(device=torch.device(dev))

    def run(op, ins, attrs=None):
        return get_op(op).fn(ins, dict(attrs or {}), ctx)

    t = torch.from_numpy(x).to(dev)
    arr = run("lod_tensor_to_array", {"X": [t]})["Out"][0]
    table = run("lod_rank_table", {"X": [t]})["Out"][0]
    out = {"array_to_lod_tensor": run("array_to_lod_tensor",
                                      {"X": [arr]})["Out"][0],
           "max_sequence_len": run("max_sequence_len",
                                   {"RankTable": [table]})["Out"][0]}
    stacked = run("tensor_array_to_tensor", {"X": [arr]},
                  {"axis": 1, "use_stack": True})
    out["tensor_array_to_tensor"] = stacked["Out"][0]
    out["tensor_array_to_tensor OutIndex"] = stacked["OutIndex"][0]
    for step in (0, x.shape[1] // 2, x.shape[1]):
        out[f"shrink_rnn_memory at step {step}"] = run(
            "shrink_rnn_memory",
            {"X": [t[:, 0]], "I": [torch.tensor([step], device=dev)],
             "RankTable": [table]})["Out"][0]
    return {k: _host(v) for k, v in out.items()}


def _sparse_table_chain(dev, name, ids, grads, values):
    """The sparse-table ops in a pass's order on ``dev`` over table
    ``name``: made (adam, PLUMB_TABLE's lr), pulled by
    ``distributed_lookup_table`` ([slots, B, seq] ids), read flat, the
    grads merged by id and pushed by ``lookup_sparse_table_fuse_adam``
    (the unique rows only), the first rows set by
    ``lookup_sparse_table_write``, read again.  Returns ({op: numpy
    output}, {op: ms}) and leaves the table in the registry."""
    import torch
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    ctx = LoweringContext(device=torch.device(dev))
    t = PLUMB_TABLE
    attrs = {"table_name": name, "dim": t["dim"]}
    dids = torch.from_numpy(ids).to(dev)
    flat = dids.reshape(-1)
    outs, ms = {}, {}

    def run(op, ins, extra=None):
        t0 = time.perf_counter()
        o = get_op(op).fn(ins, dict(attrs, **(extra or {})), ctx)
        if dev != "cpu":
            torch.cuda.synchronize()
        ms[op] = (time.perf_counter() - t0) * 1e3
        return o

    run("lookup_sparse_table_init", {}, {"optimizer": "adam",
                                         "lr": t["lr"]})
    outs["distributed_lookup_table"] = run(
        "distributed_lookup_table", {"Ids": [dids]})["Out"][0]
    outs["lookup_sparse_table_read"] = run(
        "lookup_sparse_table_read", {"Ids": [flat]})["Out"][0]
    merged = run("lookup_sparse_table_merge",
                 {"Ids": [flat], "Grad": [torch.from_numpy(grads).to(dev)]})
    outs["lookup_sparse_table_merge Ids"] = merged["Ids"][0]
    outs["lookup_sparse_table_merge Out"] = merged["Out"][0]
    n = int((merged["Ids"][0] >= 0).sum().item())
    run("lookup_sparse_table_fuse_adam",
        {"Ids": [merged["Ids"][0][:n]], "Grad": [merged["Out"][0][:n]]},
        {"lr": t["lr"]})
    run("lookup_sparse_table_write",
        {"Ids": [flat[:len(values)]],
         "Value": [torch.from_numpy(values).to(dev)]})
    outs["read after the push and the write"] = get_op(
        "lookup_sparse_table_read").fn({"Ids": [flat]}, dict(attrs),
                                       ctx)["Out"][0]
    return {k: _host(v) for k, v in outs.items()}, ms


def _random_like_contract(card):
    """The two ``*_batch_size_like`` random ops on the card at [4096,
    768] from a [4096, 5] input (ground rule 5): shape, range, moments
    within 4 standard errors, the same numbers from the same seed and
    step, others from another seed.  Returns the broken checks."""
    import torch
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    x = torch.zeros((4096, 5), device=DEVICE)
    broken = []
    for op, attrs, mean, std in (
            ("uniform_random_batch_size_like",
             {"shape": [-1, 768], "min": -2.0, "max": 3.0}, 0.5,
             5.0 / math.sqrt(12.0)),
            ("gaussian_random_batch_size_like",
             {"shape": [-1, 768], "mean": 1.0, "std": 2.0}, 1.0, 2.0)):
        def draw(seed, op_seed=7):
            ctx = LoweringContext(device=torch.device(DEVICE),
                                  base_seed=seed)
            return _host(get_op(op).fn({"Input": [x]},
                                       dict(attrs, op_seed=op_seed),
                                       ctx)["Out"][0])
        a, b, c = draw(1), draw(1), draw(2)
        se = std / math.sqrt(a.size)
        if a.shape != (4096, 768) or a.dtype != np.float32:
            broken.append(f"{op}: shape {a.shape}, dtype {a.dtype}")
        if op.startswith("uniform") and (a.min() < -2.0 or a.max() >= 3.0):
            broken.append(f"{op}: range [{a.min()}, {a.max()}]")
        if abs(a.mean() - mean) > 4 * se or abs(a.std() - std) > 0.01 * std:
            broken.append(f"{op}: mean {a.mean()}, std {a.std()}")
        if not np.array_equal(a, b) or np.array_equal(a, c):
            broken.append(f"{op}: not repeatable for a seed")
    _p(f"plumbing: the *_batch_size_like random ops on the card at [4096, "
       f"768]: broken {broken}  [{card}]")
    return broken


def _queue_contract(card):
    """``queue_generator``, ``enqueue`` and ``dequeue`` on the card over
    BERT-base activations [32, 128, 768]: 8 tensors queued, each then
    overwritten in place, come back as queued, cast to ``dtype``; a
    ``shape`` other than the tensor's raises.  Returns the broken
    checks."""
    import torch
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    ctx = LoweringContext(device=torch.device(DEVICE))
    shape = [32, BERT_BASE["seq"], BERT_BASE["hidden"]]
    get_op("queue_generator").fn({}, {"names": ["plumb_q"],
                                      "capacity": 8}, ctx)
    xs = [torch.randn(shape, device=DEVICE) for _ in range(8)]
    want = [_host(x).astype(np.float16) for x in xs]
    for x in xs:
        get_op("enqueue").fn({"X": [x]}, {"queue_name": "plumb_q"}, ctx)
        x.add_(1.0)
    got = [get_op("dequeue").fn({}, {"queue_name": "plumb_q",
                                     "shape": shape, "dtype": "float16"},
                                ctx)["Out"][0] for _ in xs]
    broken = [i for i, (g, w) in enumerate(zip(got, want))
              if g.device.type != torch.device(DEVICE).type
              or not np.array_equal(_host(g), w)]
    get_op("enqueue").fn({"X": [xs[0]]}, {"queue_name": "plumb_q"}, ctx)
    try:
        get_op("dequeue").fn({}, {"queue_name": "plumb_q",
                                  "shape": [32, 128], "dtype": "float32"},
                             ctx)
        broken.append("a dequeue of the wrong shape did not raise")
    except ValueError:
        pass
    _p(f"plumbing: 8 queued [32, 128, 768] tensors through the queue ops "
       f"on the card, each updated in place after its enqueue: broken "
       f"{broken}  [{card}]")
    return broken


def _plumb_ops_on_the_card(card):
    """4y (b): each tensor op type of ``_plumb_op_cases`` on the card
    against the host, forward and ``generic_grad`` where it is
    differentiable, within PLUMB_CARD_TOL of each output's largest
    |value|, with its forward ms on the card; the tensor-array and
    rank-table ops at the SRL shapes, the sparse-table chain at the CTR
    width (its outputs and the table's rows, moments and steps equal to
    the host's exactly), the queues and the random contract."""
    import torch
    from paddle_tpu_torch.ops import plumbing_ops
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op

    worst, ms, broken = {}, {}, []
    rng = np.random.default_rng(SEED + 291)
    ctx = LoweringContext(device=torch.device(DEVICE))
    cases = _plumb_op_cases()
    for label, (op, ins, attrs) in cases.items():
        dev_ins = {k: [torch.from_numpy(np.array(a)).to(DEVICE)
                       for a in (v if isinstance(v, list) else [v])]
                   for k, v in ins.items()}
        fwd = get_op(op).fn
        ms[label] = _ms(lambda: fwd(dev_ins, dict(attrs), ctx), 3, warmup=1)
        del dev_ins
        worst[label] = _op_card_err(op, ins, attrs, PLUMB_CARD_TOL, rng)
    types = {op for op, _, _ in cases.values()}
    x = rng.standard_normal((SRL_BATCH, SRL_STEPS, SRL["hidden"]),
                            dtype=np.float32)
    arrays = _lod_array_ops("cpu", x)
    for k, v in _lod_array_ops(DEVICE, x).items():
        worst[k] = _op_err({"Out": [v]}, {"Out": [arrays[k]]},
                           PLUMB_CARD_TOL)
    t = PLUMB_TABLE
    shape = (t["slots"], t["batch"], t["seq"])
    ids = ctr_join_raw_ids(dict(JOIN, batch=t["batch"]), 1, SEED + 292)[0] \
        .transpose(1, 0, 2).copy()
    grads = rng.standard_normal((ids.size, t["dim"]), dtype=np.float32)
    values = rng.standard_normal((t["batch"], t["dim"]), dtype=np.float32)
    plumbing_ops._SPARSE_TABLES.clear()
    card_outs, table_ms = _sparse_table_chain(DEVICE, "plumb_card", ids,
                                              grads, values)
    host_outs, _ = _sparse_table_chain("cpu", "plumb_host", ids, grads,
                                       values)
    tables = [plumbing_ops._SPARSE_TABLES[n] for n in ("plumb_card",
                                                       "plumb_host")]
    state = [tb.row_state(tb.all_ids()) for tb in tables]
    table_diff = sorted(k for k in state[1]
                        if not np.array_equal(state[0][k], state[1][k]))
    out_diff = sorted(k for k in host_outs
                      if not np.array_equal(card_outs[k], host_outs[k]))
    _p(f"plumbing: the sparse-table ops at {shape} ids ({ids.size} a pass, "
       f"{len(state[1]['ids'])} rows), dim {t['dim']}, adam: ms on the card "
       + ", ".join(f"{k} {v:.1f}" for k, v in table_ms.items())
       + f"; outputs differing from the host's {out_diff}, table state "
       f"differing {table_diff}  [{card}]")
    if out_diff or table_diff or tables[0].optimizer != "adam":
        broken.append("the sparse-table chain differs from the host's")
    plumbing_ops._SPARSE_TABLES.clear()
    broken += _random_like_contract(card) + _queue_contract(card)
    _p("plumbing op types on the card, forward ms: "
       + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f"  [{card}]")
    _p(f"plumbing op types on the card against the host ({len(types)} "
       f"tensor types and the array and rank-table ops), forward and "
       f"generic_grad, error / {PLUMB_CARD_TOL} of the largest |value| "
       "(under 1 passes): "
       + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
       + f"; broken {broken}  [{card}]")
    if max(worst.values()) > 1 or broken:
        raise SystemExit("chip_smoke: a plumbing op type disagrees with "
                         "the host on the card")
    return {"worst": worst, "ms": ms, "table_ms": table_ms}


def phase_plumbing_tier(card):
    """Phase 4y, the plumbing tail: (a) static BERT-base training
    checkpointed and resumed through save_combine/load_combine and
    save/load programs, with a twin; (b) the slice's other op types on the
    card against the host.  Returns (a)'s launches of its uninterrupted
    run and the numbers."""
    t = time.perf_counter()
    launches, ckpt = _checkpoint_leg(card)
    _p(f"phase 4y (a): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ops = _plumb_ops_on_the_card(card)
    _p(f"phase 4y (b): {time.perf_counter() - t:.1f} s")
    return launches, {"checkpoint": ckpt, "ops": ops}


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
    # 4r builds static programs too: before 4e turns dygraph on
    rnn_launches, _ = _timed("4r static RNN tier", phase_static_rnn, card)
    image_launches, _ = _timed("4s image layers: CycleGAN", phase_image_layers,
                               card)
    # 4t builds static programs too: before 4e turns dygraph on
    seq_launches, _ = _timed("4t sequence tier: SRL and CRNN-CTC",
                             phase_sequence_tier, card)
    # 4u builds static programs too: before 4e turns dygraph on
    det_launches, _ = _timed("4u detection tier: MobileNet-SSD and YOLOv3",
                             phase_detection_tier, card)
    # 4v builds static programs too: before 4e turns dygraph on
    ctr_tier_launches, _ = _timed("4v PaddleBox CTR tier: the join tower",
                                  phase_ctr_tier, card)
    # 4w builds static programs too (its dygraph leg under its own
    # guard): before 4e turns dygraph on
    qat_launches, qat_serve_launches, _ = _timed(
        "4w quantization tier: QAT BERT-base, PTQ, dygraph QAT",
        phase_quant_tier, card)
    # 4x builds static programs too (its eager model under its own
    # guard): before 4e turns dygraph on
    fused_launches, _ = _timed(
        "4x fused inference tier: ERNIE-form BERT-base served",
        phase_fused_tier, card)
    # 4y builds static programs too: before 4e turns dygraph on
    plumb_launches, _ = _timed(
        "4y plumbing tail: BERT-base checkpointed and resumed",
        phase_plumbing_tier, card)
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
    # the static RNN tier (phase 4r): launches over (a)'s timed static PTB
    # steps, (b)'s timed stacked-LSTM steps and (c)'s beam search
    for row in kernels:
        row["static_rnn_launches"] = {leg: c[row["name"]]
                                      for leg, c in rnn_launches.items()}
    # the image layers (phase 4s): launches over (a)'s timed CycleGAN steps
    # and (b)'s static generator step (none expected)
    for row in kernels:
        row["image_launches"] = {leg: c[row["name"]]
                                 for leg, c in image_launches.items()}
    # the sequence tier (phase 4t): launches over (a)'s timed SRL steps and
    # (b)'s timed CRNN-CTC steps (none expected)
    for row in kernels:
        row["sequence_launches"] = {leg: c[row["name"]]
                                    for leg, c in seq_launches.items()}
    # the detection tier (phase 4u): launches over (a)'s and (b)'s timed
    # steps and over their serving (none expected)
    for row in kernels:
        row["detection_launches"] = {leg: c[row["name"]]
                                     for leg, c in det_launches.items()}
    # the PaddleBox CTR tier (phase 4v): launches over (a)'s timed join
    # tower steps (fused_adam once a step, every other kernel none)
    for row in kernels:
        row["ctr_tier_launches"] = ctr_tier_launches[row["name"]]
    # the quantization tier (phase 4w): launches over (a)'s timed QAT
    # BERT-base steps (pt_dropout and its mask on the attention dropouts,
    # fused_adam once a step, no flash), and over each of (b)'s predictor
    # runs of the frozen program (flash once a layer)
    for row in kernels:
        row["qat_launches"] = qat_launches[row["name"]]
        row["qat_serve_launches"] = {rows: c[row["name"]] for rows, c in
                                     qat_serve_launches.items()}
    # the fused inference tier (phase 4x): launches over each of (a)'s
    # predictor runs of the fused ERNIE-form BERT-base (flash once a
    # layer, every other kernel none)
    for row in kernels:
        row["fused_serve_launches"] = {rows: c[row["name"]] for rows, c in
                                       fused_launches.items()}
    # the plumbing tail (phase 4y): launches over (a)'s uninterrupted
    # CKPT_STEPS steps of static BERT-base (24 flash forward, 12 flash
    # backward and one fused_adam a step, every other kernel none)
    for row in kernels:
        row["plumbing_launches"] = plumb_launches[row["name"]]
    _p(json.dumps({"kernels": kernels}))
    _p(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": count}}))


if __name__ == "__main__":
    main()
