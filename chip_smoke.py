#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``bigdl_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 15,17,18 # those phases alone

Phases, each printing JSON lines (``--phases`` runs any of phases 15,
17 and 18 -- data parallelism; the model-parallel strategies; the
pipelines, pp+tp, the heterogeneous pipeline and serving their
checkpoints -- after the build, then the device line, with no kernels
line):

1. environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions, TF32 switched off;
2. build: the CUDA kernels compiled from ``bigdl_tpu_torch/csrc``, the
   compiler's registers, spills and static shared memory of every
   instantiation (``-Xptxas -v``), and the tensor-core instructions of
   every K1 and K1-bwd kernel (HMMA) and of K6's two kernels (GMMA for
   the wgmma kernel, IMMA for the gather kernel) counted in ``cuobjdump
   -sass`` of the libraries (none fails);
3. kernels: K1 ``flash_attention``, K2 ``flash_decode_attention`` and K3
   ``flash_paged_decode_attention`` held against their plain PyTorch
   versions at the serving path's shapes (fp32, H 12, D 64), with kernel,
   plain and library device times (CUDA-graph replays, so no host work
   sits between launches) and the least time the card could take (K1
   also at the training step's B8 T1024, in fp32 and in bf16; K1 and
   K1-bwd bounded by the 3xTF32 tensor-core rate, 495/3 TFLOP/s, in fp32
   and by the bf16 rate, 989 TFLOP/s, in bf16, held to 2e-2); K2's and
   K3's rows give
   their split count (from the card's SM count) and cluster shape, and
   an empty kernel launched as K2 is and as K3 is (and one of a single
   block) gives each launch's fixed cost, the floor under K2's, K3's and
   K3q's times;
4. end to end: TransformerLM "small" (random weights from a seed) served
   by three engines -- paged (kernels), contiguous (kernels) and paged
   with the plain attention -- on the same greedy prompts, plus sampled
   requests and ``predict``; each engine builds its generation steps in
   ``precompile()`` (one CUDA graph per shape) and serves by replaying
   them; every kernel's launch count (counted through the replays) must
   rise on this main path, the greedy streams must agree and ``predict``
   must match the plain model;
5. served steps: one more greedy burst through the two kernel engines in
   which every replay of a built step is also run by the plain model's
   step on a copy of the cache taken just before it, the logits of real
   rows held to 1e-4.  With random weights the greedy streams repeat a
   few tokens, so equal streams alone show little; these logits carry
   the evidence.  Then each engine's graphs row: steps built in
   ``precompile()`` and after it (held at 0), replays, the host's launch
   calls per decode tick (profiler), tokens/s, TTFT and peak memory;
6. training kernels: K4 ``fused_softmax_cross_entropy`` and K5 (its
   backward) at the training step's (8192, 32000) fp32 logits, and
   K1-bwd ``flash_attention_bwd`` at B8 H12 D64 causal, T 1024 and a
   ragged T 200, each held to its plain version (1e-4; K5 elementwise
   relative, at an upstream gradient of order 1), and K1-bwd in bf16 at
   T 1024 (2e-2), each timed beside its bound, its plain version and the
   library call (a backward through autograd by its kernels' device time
   under the profiler, the CUDA-event wall beside it);
7. training end to end: TransformerLM "small" (vocab 32000, max_len
   1024, random weights from seed 0) on ``synthetic_corpus(64, 1024,
   32000)``: (a) one batch's loss and the gradient of every parameter
   through the kernels against a second model on the same weights with
   plain attention and the plain cross-entropy (loss 1e-4, relative L2
   1e-4 per parameter, no zero gradient); (b) 8 iterations of
   ``Optimizer(...).optimize()`` with ``Adam(1e-4)`` on both, per-step
   losses within 1e-5 relative, the last below the first, and the first
   batch's loss lower after the 8 steps than before; (c) the training path's
   launches: K1 and K1-bwd 12 a step, K4 and K5 one a step, none on the
   plain model; then the bf16 leg, ``compute_dtype=torch.bfloat16`` on
   the same weights: (a) one batch's loss and gradients through the
   kernels against the plain path in bf16 and the loss against the fp32
   kernel path's, (b) 8 iterations of ``Optimizer(...)
   .set_compute_dtype(torch.bfloat16).optimize()``, per-step losses
   against the fp32 run's, the loss falling, tokens/s and peak memory,
   (c) its launches: the bf16 K1 and K1-bwd 12 a step, K4 and K5 (on
   fp32 logits) one a step, no fp32 K1 and no call of the plain
   attention (tolerances: ``BF16_*`` below).  Every step of both runs
   (and of the plain model's) is one replay of the compiled step, one
   CUDA graph per batch shape (``optim.CompiledTrainStep``): each run
   builds one and replays it 8 times, and the kernels' launches are
   counted through the replays.  For fp32 and for bf16 phase 7 then
   shows (a) the same 8 batches through the eager ``make_train_step``
   from the same weights: per-step losses and the parameters after them
   within ``COMPILED_RTOL``, and whether they are bitwise equal; (b) the
   host's CUDA calls a step (profiler: one ``cudaGraphLaunch``, no other
   launch, plus copies) and no capture after a shape's first step; (d)
   tokens/s and the device's idle share at ``set_sync_every`` 1 and 4;
   and, in fp32, (e) two more 8-step runs, ``SGD(momentum=0.9)`` under
   ``SequentialSchedule(Warmup, Poly)`` and a ``CompositeOptimMethod``
   (SGD for the embedding table, Adam for every other subtree), their
   ``LearningRate`` scalars held to the same formulas in float64 (1e-6
   relative);
8. int8 kernel: K3q, ``flash_paged_decode_attention`` on int8 pools with
   their fp32 scales (``ops.quantization.quantize_blockwise``), at phase
   3's K3 shapes, held against its plain version (1e-4) and timed beside
   its bound (2 * H * (D + 4) bytes a visible position) and its plain
   version, with its split count and cluster shape; no PyTorch call reads
   int8 K/V through block tables, so it has no library time;
9. int8 serving: TransformerLM "small" (phase 4's weights and prompts)
   through three engines: (a) ``kv_cache_dtype="int8"``; (b)
   ``quantize=True`` with an ``accuracy_gate``, fp32 KV; (c)
   ``speculative=4`` over int8 KV.  Held: K3q launched by (a) and (c), K3
   never by (a), counted through the replays; every replay of (a) and of
   (c)'s verifier against the plain model on a copy of the pool (1e-4;
   the twin's steps, in (b) and (c)'s drafter, are not reproducible run
   to run: ``check_replays``); each engine's graphs row, as phase 5; the
   int8 pool's allocator-measured bytes per block at 136/512 of the fp32
   pool's; the gate's measured agreement and RMSE within the stated
   tolerances, and a gate at half the measured RMSE refusing the engine;
   (c)'s greedy streams equal to (a)'s (the fp32 model decoding alone
   over int8 KV) except at stated near-ties; K6q (``act_quant``, the
   int8 twin's activation quantization ahead of every ``torch._int_mm``)
   launched by (b) and by (c)'s drafter, its small route among them,
   never by (a), counted by route, and its small route held bitwise
   against its plain version and timed beside its three-node route at
   every input shape the built steps gave it;
10. evaluation, checkpoints and L-BFGS: TransformerLM "small" (seed 0),
    29 held-out sequences of 1024 tokens (``synthetic_corpus`` seed 1) at
    batch 8, three full batches and a ragged one of 5: (a) ``validate``
    with ``Loss`` (K4), ``Top1Accuracy`` and ``Top5Accuracy`` through the
    compiled eval step, one CUDA graph per batch shape built by the first
    pass and none by the second, K1 12 and K4 1 a batch counted through
    the replays, no K1-bwd or K5; each batch held against the plain
    model's eager eval (Loss 1e-5 relative, a differing top-1 or top-5
    token only at a near-tie of ``TIE_MARGIN``), eval tokens/s compiled
    and eager, the pass's wall and the eval pool's bytes; the same in
    bf16 (K1 bf16, Loss within ``BF16_FP32_LOSS_RTOL``); (b) 8 steps of
    ``SGD(1e-4, momentum=0.9)`` under ``Plateau(monitor="Loss",
    patience=1)`` with validation and a checkpoint every 4 iterations
    (``checkpoint.4.pkl`` and ``checkpoint.8.pkl``: the trigger fires
    at ``neval`` 4 and 8, after steps 3 and 7, as in the JAX package),
    each manifest verified, the Plateau fed at each validation, each
    checkpoint's bytes and write and verify seconds, and the eval graph
    after training against an eager eval of the trained weights; (c) a
    fresh model (other weights) and optimizer resumed from
    ``checkpoint.4.pkl`` alone run to step 8: per-step losses,
    parameters and ``lr_factor`` within ``RESUME_RTOL`` of the straight
    run's (bitwise equality printed), its launches counted; then a run
    whose dataset raises once at the 6th batch, which ``optimize()``
    restores from its own checkpoint and finishes with the same result;
    (d) ``Predictor(batch_size=8)`` over the 29 sequences through the
    same graphs (the tail padded to 8: no graph built), each batch
    against the step's output on the unpadded batch, the host's launch
    calls a batch (one ``cudaGraphLaunch``), and two
    ``predict_minibatch`` results of one shape, the first kept after the
    second call, with the time of the copy that keeps it; (e)
    ``LBFGS(max_iter=3, n_correction=4)`` on the flat parameters with a
    ``feval`` through the kernels: its first loss and gradient against
    the plain model's (``LBFGS_TOL``), the loss falling, the history's
    bytes, K1, K1-bwd, K4 and K5 once a ``feval`` each (K1 and K1-bwd
    12).
11. "large": first the head_dim 96 kernel rows (H 16): K1 and K1-bwd at
    B8 T1024 in fp32 and bf16, K2 at B9 T1024, K3 and K3q at B8 bs16,
    each held to its plain version (fp32 1e-4, bf16 2e-2) beside its
    bound and library time; then TransformerLM "large" (1536 wide, 16
    heads of 96, 36 layers, vocab 32000, random weights from seed 0) at
    B8 x T1024 through ``Optimizer(...).optimize()`` and the compiled
    step, 4 steps a leg: (a) fp32, scanned (the recipe's default, every
    layer rematerialised), its first loss against plain attention on the
    same weights (``LARGE_LOSS_RTOL``) and its compiled steps against the
    eager step bit for bit; (b) bf16 scanned with the policy unset; (c)
    bf16 scanned under ``dots_saveable``, losses bitwise (b)'s; (d) bf16
    unrolled without remat, losses within ``LARGE_BF16_LAYOUT_RTOL`` of
    (b)'s and peak memory above (b)'s.  Each leg prints tokens/s, peak
    allocated and reserved memory, the graph pool and K1's and K1-bwd's
    launches a step through the replays (72 and 36 under remat, 36 and 36
    without).  Then 4 prompts of 16 new tokens through the fp32 paged
    engine by the scanned and the unrolled model (equal greedy streams,
    K3 at D 96 launched), and by the scanned model through the contiguous
    (K2) and int8-KV (K3q) engines.
12. ResNet-50 (1000 classes, full width and depth, random weights from
    seed 0; no kernel of the port is on this path: convolutions, pooling
    and BatchNorm are cuDNN and PyTorch ops, as they are XLA ops in the
    JAX package): (a) ``__graft_entry__.entry``'s forward, batch 4 at 224
    x 224 in eval mode with the running statistics of one training
    forward, through the compiled eval step in fp32 and bf16, against
    the same model on the CPU in fp32 (``RESNET_FWD_TOL``); (b) four
    ``Optimizer(...).optimize()`` legs at ``bench.py`` ``_bench_one``'s
    setting (batch 128, 224 x 224, standard normal images and labels
    from numpy seed 0, 4 batches cycled, ``SGD(0.02, momentum 0.9,
    weight decay 1e-4)``, ``CrossEntropyCriterion``) of 10 compiled steps
    each: fp32, bf16, bf16 with ``remat=True``, bf16 with
    ``stem_s2d=True`` and ``Fused(SGD)``; each prints images/s over steps
    1-6, the device's idle share and its time by kind (convolutions,
    layout transforms, copies, reductions, elementwise) over steps 7-9
    under the profiler, the optimizer update's device time, peak
    allocated and reserved memory, the graph pool and a derived
    model-FLOPs share (24.5 GFLOP an image over 989 TFLOP/s bf16, 67
    fp32); held: batch 0's loss falling at its returns (steps 4, 8); with
    ``cudnn.deterministic`` (cuDNN's default backward algorithms are not
    deterministic), 3 compiled fp32 steps against 3 eager ones from the
    same weights (``COMPILED_RTOL``: losses, parameters and running
    statistics), the timed leg's first 3 steps printed beside an eager
    run with the default algorithms; the remat leg's statistics after
    one step against the plain bf16 leg's; the s2d stem against the
    plain stem in fp32 and the s2d leg's first loss against the plain
    leg's; (c) ``validate`` with
    ``Top1Accuracy`` and ``Predictor`` over 64 held-out images in fp32
    and bf16 on the trained fp32 model against its eager eval; (d) a
    checkpoint with BatchNorm state at neval 5 of an 8-step bf16 run,
    resumed into a fresh model to step 8, against the straight run, both
    with ``cudnn.deterministic`` (``RESUME_RTOL``); (e) ``lenet-train``, ``vgg-train``,
    ``resnet-train --depth 20`` and ``inception-train --version v1``, 4
    iterations each through ``models/run.py``; the phase launches no K7
    (the float models keep their modules; counted).
13. int8 inference of the CNN zoo and the recipes' host services: (a) K6
    ``int8_conv`` (``csrc/int8_conv.cu``: the ``wgmma`` s8 implicit GEMM
    over the packed K-major weight, and the byte-gather ``mma.sync``
    kernel for the stem) at ResNet-50's shapes at batch 128 (the 7 x 7 /
    2 stem, 1 x 1 256 -> 64, 3 x 3 64 -> 64, 3 x 3 / 2 256 -> 256, the
    1 x 1 / 2 512 -> 1024 shortcut) and two coverage rows at batch 8
    (AlexNet's grouped 5 x 5, a SAME 3 x 3 / 2 with dilation 2), each
    bitwise equal to its plain version (``F.conv2d`` in float64 over the
    int8 values), timed beside its bound (the larger of bytes / 3.35 TB/s
    and int8 operations / 1,979 TOPS), its share of it, the time of the
    ``mma.sync`` kernel it replaced, its
    plain version, im2col plus ``torch._int_mm`` (the same int32 sums,
    checked exact) and cuDNN's bf16 channels-last convolution of the
    float layer; then one eager forward of the fused int8 twin at batch
    128 records its K7 sites and K6q's quantizations by route; K7
    ``bn_act`` (``csrc/bn_act.cu``: eval BatchNorm, the residual add and
    ReLU in one pass, leaving max |y| for K6q) at each distinct (shape,
    form) of those sites, ``y``'s bits and the absmax bitwise its plain
    version, timed beside its bound (x, the residual and the BatchNorms'
    buffers read once, y written once) and its plain version; K6q
    ``act_quant`` (``csrc/act_quant.cu``) at each (shape, route) of those
    quantizations -- the given route on a K7 output, the three-node route
    (with its two-pass floor: 9 bytes where x and x_q do not fit in L2
    together) -- and its small route at the head's input beside the
    three-node route, ``x_q`` and ``x_scale`` bitwise its plain version,
    timed beside its bound (x read once, x_q written once: 5 bytes an
    fp32 element) and its plain version; (b) ResNet-50 (seed 0, the
    running statistics of one training forward) quantized by
    ``quantize_model`` and by ``quantize()`` on a copy (bitwise-equal
    logits), its fused plan's site counts (49 K7 sites, no BatchNorm left
    to its module), 228 images through ``Predictor`` and the compiled eval
    step at batch 128 (a batch: 52 wgmma K6 launches, 1 gather K6 launch,
    49 K7 launches and 50 K6q launches, 47 of them the given route,
    counted through the replays, none of another kernel; the ragged batch
    against the twin's eager eval of the same padded batch), held bitwise
    against the twin with every plain version (the plain quantizer, K7's
    and K6's; else the first convolution that differs) and against the
    unfused twin with plain versions, and against the fp32 model (relative
    logit error, top-1 agreement, ``AccuracyDeltaGate``); images/s of the
    compiled int8, fp32 and bf16 eval (the float ones without a K7
    launch), K6's, K6q's and K7's shares of the
    int8 forward's device time and the time by kind, the kernels of one
    replay against the same graph with the quantizer as PyTorch passes, no
    abs / round / amax kernel left in the replay, the parameters' bytes
    fp32 / int8 (at least 3.5, as JAX's bench holds), the packed weight
    copies' bytes beside them and the int8 bytes the card holds, and peak
    memory; (c) ``ServingEngine(resnet50, quantize=True,
    accuracy_gate=...)``: 8 ``predict`` requests one at a time, each
    bitwise the twin's eager eval of the request padded to its rung, K6
    53, K7 49 and K6q 50 times a forward (47 given, the image, the
    max-pool's output and the head's input small or three-node by their
    size);
    (d)
    ``resnet-imagenet-train`` (bf16, batch 128, 12 iterations) through
    ``models/run.py`` with neither flag, with ``--summaryDir`` and with
    ``--numWorkers 4 --queueDepth 4 --summaryDir``: equal batch digests,
    images/s and the data-wait share a step, 12 ``Loss``, ``Throughput``
    and ``LearningRate`` points, no prefetch thread left, then the
    ``g++``-built ``NativeBatcher``'s rate for 128 x 224 x 224 x 3
    batches against numpy's output; (e) ``RunSupervisor.run_process``: a
    child training ``ResNetCifar(20)`` on the card with
    ``cudnn.deterministic`` and a checkpoint every 2 iterations is
    SIGKILLed by ``ChaosKillTrigger(5)``, restarted from its snapshot and
    finishes at step 10, its parameters and statistics against a straight
    child's (``RESUME_RTOL``), and the recovery event.
14. the serving engine (``serving/engine.py``: ``predict`` as one CUDA
    graph per (batch rung, length rung), staging, refresh, the memory
    ledger, ``optim.PredictionService``): (a) ``ServingEngine(resnet50,
    quantize=True, accuracy_gate=..., max_batch_size=32)`` (seed 0, the
    statistics of one training forward, 224 x 224): ``precompile``
    captures one graph a rung (6); 64 requests in mixed bursts from 8
    threads capture none, each tick's outputs bitwise a replay of its
    padded batch, the twin's eager eval of it and the twin with every
    int8 layer through its plain version (K6, K7 and K6q held at the
    shapes the main path gave them, and a replay at each rung), a
    request that rode alone bitwise ``predict_at`` (the activation scale
    is taken over the
    whole padded batch, so a request sharing a tick is reproducible only
    with its tick's batch), K6 52 + 1, K7 49 and K6q 50 launches a replay
    counted through the replays, requests/s and the graph pools' bytes;
    the batch-1 request time (median of 50 sequential calls) through
    ``predict``, ``predict_at`` and the twin's eager eval (the old
    ``predict`` path); the served rate over a window of 4,096 requests,
    and at each rung a tick's copy in, replay, copy out and whole eval
    timed apart; (b) TransformerLM "small" (seed 0) through an fp32
    engine (with paged generation) and a ``compute_dtype=torch.bfloat16``
    one, ``length_ladder`` rungs 64-1024 and batch rungs 1-4: captures
    equal to batch rungs x length rungs (plus generation's), none after
    ``precompile`` under 16 mixed-length requests from 8 threads, each
    result bitwise ``predict_at`` of its request zero-padded to its
    result's length rung, K1 once a layer a replay and held against its
    plain version at every (batch rung, length rung), a request against
    the plain model (1e-4), the served rate over 320 requests and a
    tick's parts at the smallest and largest rung; (c) on (a)'s engine, a candidate from seed 1:
    ``eval_staged`` bitwise the candidate twin's eager eval, a canary of
    0.25 serving 2 of 8 sequential ticks on it, ``commit_staged`` making
    the replay bitwise the candidate twin's eager eval (K6's packed copy
    re-packed in place), the ``capture_staged`` handle rolling back
    bitwise, a truncated tree refused by ``refresh_params`` with the
    outputs unchanged, ``refresh_from_snapshot`` of the checkpoint of one
    ``LocalOptimizer`` step bitwise the trained twin's eager eval; the
    commit and rollback again on an fp32 and a bf16 ResNet-50 engine,
    bitwise against the candidate's own graph and within
    ``ENGINE_EAGER_RTOL`` of its eager eval; each commit's time;
    (d) on (b)'s fp32 engine: two prompts on a shared 256-token prefix
    (the second hits the cache), a candidate (seed 1) committed, the
    cache flushed and not hit after it, the next greedy stream (K3
    counted) equal to a fresh engine's on the candidate except at a
    ``TIE_MARGIN`` near-tie, the predict replay bitwise the candidate's
    own graph, the rollback bitwise, and the memory ledger (params, the
    KV block split, the graphs' pools, the staged handles, the card's
    headroom); (e) ``PredictionService`` on (b)'s model, 16 requests of
    128 tokens from 8 threads, on the semaphore path and with
    ``coalesce=True``: each output bitwise ``predict_at`` at the rung it
    rode, no capture.
15. data-parallel training (``optim/distri_optimizer.py``): (a) "small"
    at phase 7's setting through ``Optimizer(distributed=True)`` at a
    world of one on NCCL, fp32 then bf16, 8 steps each against
    ``LocalOptimizer`` on the same weights and batches (per-step losses
    and parameters within ``DISTRI_W1_RTOL``, bitwise equality printed),
    K1, K1-bwd, K4 and K5 counted through the replays (12, 12, 1 and 1 a
    step), the step one CUDA graph with NCCL's collectives captured in
    it, its time and tokens/s beside ``LocalOptimizer``'s over steps
    5-8 and both graph pools' bytes; the fp32 run checkpoints after 4
    steps; one DP step on the plain model (plain attention and
    cross-entropy) against the kernels' first loss; the bf16 wire and
    the int8 wire with error feedback, with and without the compressed
    weight gather, 3 steps each at world 1, captured on NCCL and bitwise
    the same legs eager on a gloo group, run while (b)-(d) run; (b) a
    world of two processes sharing the card on gloo (this script with
    ``--distri-rank``), eager, four rows a rank: 4 steps on each wire
    (fp32 against (a)'s losses and its checkpointed parameters; bf16,
    int8 with error feedback, and with the compressed weight gather,
    against the fp32 wire within JAX's own bounds), every wire's
    parameters relative to its reference's update (``DISTRI_UPD_*``;
    a leg with no update reads 1), each wire's
    ``wire_summary``, labelled as host-routed correctness runs; (c)
    SyncBN ResNet-50 one step at global batch 16 on the two ranks
    against ``LocalOptimizer`` at the full batch (first loss and running
    statistics within ``DISTRI_SYNCBN_RTOL``); (d) the int8-EF world's
    checkpoint (after 2 steps) resumed at world 1 (the 2 -> 1 refit and
    the residual's repartition) and (a)'s resumed at world 2, each
    against its straight run (losses within ``DISTRI_W2_LOSS_RTOL``,
    parameters relative to the straight run's update; a resume that
    loads nothing reads 350).
16. the serving fleet (``serving/transport.py``, ``worker.py``,
    ``fleet.py``, ``deploy.py``): replica 0 in this process and two
    ``SubprocessReplica`` workers (this script, ``--fleet-worker``, each
    a fresh interpreter on the card serving "small" from seed 0 behind
    two replica servers sharing its weights, fp32 KV and int8 KV) over
    the binary wire with a minted run token; every engine has batch
    rungs 1-4 and length rungs 128-512.  (a) The main path: 64
    ``predict`` and 16 ``generate`` requests from 8 client threads
    through ``ServingFleet`` (the smoke burst), then the same 16
    prompts through the int8-KV servers of the three processes in turn;
    each prediction against replica 0's ``predict_at`` at batch rung 1
    (``FLEET_TOL`` relative, bitwise equality counted), each greedy
    stream equal to replica 0's except at a ``TIE_MARGIN`` near-tie; K1,
    K3 and K3q counted inside each worker (read by the worker role's
    ``smoke`` verb) and required of each; then the served rates:
    windows of 256 predicts and 64 generations, results dropped, taken
    by the fleet and by replica 0's engine alone in turns, each one's
    requests/s over all its windows and p50 / p99 over all their
    requests; (b) worker 1 SIGKILLed after 12 of 48 predictions:
    zero failed requests, one ``FleetSupervisor`` restart, the rejoined
    worker's probe digest equal to replica 0's; (c) a seed-1 candidate
    registered, shadowed and canaried on replica 0 and rolled across the
    fleet on the int8 weight wire (every replica then serves the tree as
    the wire delivers it): every digest equal, outputs within
    ``FLEET_TOL`` of a fresh engine on that tree, the wire's fp32 and
    int8 bytes and each commit's seconds; then a seed-2 candidate whose
    gate fails on worker 1 rolls back replica 0 only, every digest as
    before; (d) each worker's boot seconds (spawn to port file) and each
    process's card memory (allocator and ``nvidia-smi``).

17. the collective model-parallel strategies
    (``optim/strategy_optimizer.py`` over ``parallel/tp.py``,
    ``sequence.py``, ``ring_attention.py``, ``ulysses.py``, ``ep.py``):
    first the vocabulary-parallel K4/K5 rows (K4's shard pass and K5 on
    a shard with shard-local labels, the sentinel -1 off the shard) at
    (8192, 32000) and (8192, 16000) against their plain versions, timed
    beside their bounds; (a) "small" at phase 7's setting (B8 T1024,
    fp32, ``Adam(1e-4)``, seed 0) through ``Optimizer(strategy=...)`` at
    a world of one on NCCL, 4 steps a leg: tp on ``("data", "model")``,
    sp with ring and with Ulysses attention on ``("data", "seq")``, and
    ``MoETransformerLM`` at "small"'s widths (8 experts, k 2, capacity
    factor 1.25; the JAX package names no MoE config beyond its dry
    run's tiny one) with ep on ``("data", "expert")``; each against its
    one-process reference on the same weights and batches
    (``LocalOptimizer``; for ep the task loss plus 0.01 x the aux loss
    in an eager loop): per-step losses within ``STRAT_W1_LOSS_RTOL``,
    the parameters relative to the reference's update within
    ``STRAT_W1_UPD``; K1, K1-bwd, K4 and K5 counted through the replays
    (12 / 12 / 1 / 1 a step on tp -- K4 and K5 as the shard route --,
    Ulysses and ep, 0 / 0 / 1 / 1 on the ring, whose hops are plain as
    in JAX); the step one CUDA graph with NCCL's collectives captured;
    step time, tokens/s and peak memory beside the reference's; (b) a
    world of two processes sharing the card on gloo (this script with
    ``--strategy-rank``, started and killed as phase 15's), eager and
    labelled correctness-only: each leg on a ``(1, 2)`` mesh for 3 steps
    against (a)'s leg after 3 steps (``STRAT_W2_*``), and the
    vocabulary-parallel K4/K5 on half of (8192, 32000) logits against
    their plain versions and against K4/K5 on the whole logits
    (``STRAT_CE_TOL``); (c) the tp world-2 checkpoint (after 2 steps)
    carries JAX's ``layout`` block, and resumed at the same layout, and
    at world 1 (redistributed onto tp (1, 1)), it continues the
    straight run.

18. pipeline parallelism (``parallel/pp.py`` and ``pp_het.py`` behind
    ``Optimizer(strategy="pp")``): (a) "small" at phase 7's setting
    (B8 T1024, fp32, ``Adam(1e-4)``, seed 0) at a world of one on NCCL
    on ``("data", "pipe")`` = (1, 1), 4 microbatches, GPipe and 1F1B, 4
    steps each, against ``LocalOptimizer`` on the same weights and
    batches (``PP_LOSS_RTOL``, ``PP_UPD``); the step one CUDA graph; K1,
    K1-bwd, K4 and K5 counted through the replays against the counts
    JAX's schedules give (``PP_WANT``); step time, tokens/s, peak memory
    (1F1B's below GPipe's) and the graph pool; (b) a world of two gloo
    processes sharing the card (``--pp-rank``), "small"'s width at depth
    4 (two blocks a stage), 3 steps of each schedule on (1, 2), against
    (a)'s code at world 1 on the same model; (c) (b)'s GPipe checkpoint
    (after 2 steps, JAX's pp layout block) resumed at world 1 as pp
    (1, 1) and as tp (1, 1), against the straight world-2 run; (d) pp
    with tensor parallelism (``tensor_parallel=True`` on ``("data",
    "pipe", "model")``): "small" as in (a) on (1, 1, 1), both
    schedules, against the same ``LocalOptimizer`` run, one graph a
    step, K1 / K1-bwd / K4 / K5 at (a)'s counts and no shard-form
    K4/K5 (the tail stays whole); four gloo ranks (``--pp-rank``, world
    4) on (1, 2, 2) at depth 4, both schedules, against (b)'s world-1
    runs (``PP_TP_W4_RTOL``), at the same time as the world-2 ranks;
    their GPipe checkpoint resumed as pp (1, 2) and pp+tp (1, 2, 1) by
    the world-2 ranks (their last legs, once it is written) and as pp+tp
    (1, 1, 1); (e) the
    heterogeneous Sequential pipeline (``parallel/pp_het.py``) on
    ``AlexNetOWT(1000, has_dropout=False)``, batch 128 of 224 x 224 x 3
    in 4 microbatches, SGD: world 1 on (1, 1) against
    ``LocalOptimizer`` (``HET_LOSS_RTOL``; also timed at the
    microbatch's batch, 32), one graph a step, bf16
    against fp32, a same-layout resume; the world-2 ranks with the
    automatic cut and an explicit uneven one (``HET_BOUNDARIES``)
    against world 1, and a resume of the world-1 checkpoint on (1, 2),
    refused; (f) a "small"-width paged engine (4 layers) refreshed
    through ``refresh_from_snapshot`` from (d)'s pp+tp checkpoint and
    (b)'s pp one, against an engine built on the weights each holds:
    greedy streams, ``predict``, the weights bitwise, no capture after
    ``precompile()``, K1 and K3 counted through the replays.  The
    gloo legs time their checkpoints (gathers, write, barrier); (c)'s
    world-1 resumes and (f) run here while the gloo worlds work, once
    those have written their checkpoints.

Then one ``{"kernels": [...]}`` line and, last, the device line.  Any
failure raises and exits non-zero; without a CUDA card the script exits
non-zero before printing any result.
"""

import collections
import contextlib
import ctypes
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

#: published H100 SXM rates (NVIDIA data sheet): HBM bytes/s and the
#: fp32 CUDA-core FLOP/s (the decode and cross-entropy kernels)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
#: K1 and K1-bwd run fp32 inputs on the TF32 tensor cores (495 TFLOP/s
#: dense) as three TF32 products per product (3xTF32), so their fp32 rate
#: is a third of it; bf16 inputs take the dense bf16 rate (m16n8k16)
TF32X3_FLOPS_PER_S = 495e12 / 3
TF32X3 = "operations (3xTF32 tensor cores)"
BF16_FLOPS_PER_S = 989e12
BF16_OPS = "operations (bf16 tensor cores)"
ATOL = RTOL = 1e-4
#: a bf16 kernel output against its plain version on the same bf16
#: inputs: both round to 8 mantissa bits, the kernel also its
#: probabilities before P.V (as the card tests)
BF16_TOL = 2e-2

HEADS, HEAD_DIM = 12, 64
#: the serving runs of phases 4, 5 and 9: vocab and new tokens a request
SERVE_VOCAB, SERVE_NEW = 32000, 32
#: the kernels the serving path (phase 4) launches
SERVING_KERNELS = ("flash_attention", "flash_decode_attention",
                   "flash_paged_decode_attention")
#: the training step of phase 7: TransformerLM "small", batch 8 x 1024
VOCAB, SEQ, BATCH, TRAIN_ITERS = 32000, 1024, 8, 8
#: per-step losses of the kernel and plain paths, relative: a hundredth of
#: a step's fall at lr 1e-4, so a drift of the kernel path shows
STEP_LOSS_RTOL = 1e-5
#: phase 7's bf16 leg (``set_compute_dtype(torch.bfloat16)``), set before
#: its first run from bf16's unit roundoff (2^-8 = 3.9e-3): the kernel
#: path and the plain path differ only inside attention (the kernel rounds
#: P to bf16 for P.V, the plain path computes it in fp32), so one batch's
#: losses within half a roundoff of each other, relative ...
BF16_LOSS_RTOL = 2e-3
#: ... every gradient within 5e-2 relative L2 (about 13 roundoffs, summed
#: over 12 layers' backward) ...
BF16_GRAD_REL_L2 = 5e-2
#: ... and the bf16 losses (one batch, and each of the 8 steps) within
#: 5e-3 of the fp32 kernel path's at the same weights and batches
BF16_FP32_LOSS_RTOL = 5e-3
#: phase 7 (a): the compiled step's per-step losses and its parameters
#: after 8 steps against the eager step's from the same weights, relative
#: (the same kernels in the same order; a capture may pick other library
#: algorithms, which sum in another order)
COMPILED_RTOL = {None: 1e-6, torch.bfloat16: 1e-5}
#: phase 9: the accuracy gate of engine (b), the fp32 model against its
#: int8 twin on 8 held-out sequences of 128 tokens.  Measured on the H100
#: (PERF.md, the int8 findings): logit RMSE 0.0164, top-1 agreement 0.75
#: (6 of 8 rows; random weights give near-flat logits).  The limits sit
#: one step above that: RMSE 1.5x, one more row lost
GATE_MAX_LOGIT_RMSE = 0.025
GATE_MIN_TOP1_AGREEMENT = 0.625
#: phase 9: a greedy token of the fp32 model's stream over int8 KV may
#: differ between engines (a) and (c), or between rounds, only where the
#: two tokens' logits, recomputed by the plain model, lie within this of
#: each other (random weights at vocab 32000 give near-flat logits; the
#: verify forward, the decode kernel and other prefill chunks sum in other
#: orders, and an int8 pool can turn that into a whole code)
TIE_MARGIN = 1e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def device_ms(fn, iters=20, reps=7):
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, so no host work sits between the launches, the graph
    replayed ``reps`` times and each replay timed by CUDA events.
    Returns the median, least and largest ms per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def backward_ms(out, inputs, grad, iters=20, reps=7):
    """Time of one backward of ``out`` alone (autograd, graph retained):
    ``(device ms, wall ms)``.  The device time is the union of the
    call's kernels' intervals under the profiler, so the host's dispatch
    between kernels does not count (a backward through autograd is not
    captured in a CUDA graph here); the wall is the median of ``reps``
    CUDA-event spans over ``iters`` calls, which includes that dispatch
    wherever the kernels are shorter than it."""
    def run():
        torch.autograd.grad(out, inputs, grad, retain_graph=True)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    times.sort()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    busy = union_us([(e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA])
    return busy / 1e3 / iters, times[len(times) // 2]


def bound(n_bytes, flops, flops_per_s=FP32_FLOPS_PER_S,
          ops="operations"):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the FLOPs over ``flops_per_s``; ``ops``
    names the units when the operations bound it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, ops)


def kernel_name(mangled):
    """``flash_attn_kernel<fLi64ELi4>`` for a mangled kernel name whose
    template arguments are plain (type, ints); the name itself else."""
    m = re.search(r"([a-z_]+_kernel)I(\w+?)EEEv", mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled


def ptxas_report(log):
    """Each kernel's registers and spills from a ``-Xptxas=-v`` log."""
    report, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = kernel_name(m.group(1))
        elif kernel and ("Used" in line or "spill" in line):
            report.setdefault(kernel, []).append(
                line.split(":", 1)[-1].strip())
    return report


#: the kernels that must run on the tensor cores, by function name, and
#: the SASS instruction that shows it: HMMA (mma.sync fp16/bf16/tf32),
#: IMMA (mma.sync int8), GMMA (wgmma: IGMMA for int8)
TENSOR_CORE_KERNELS = {"flash_attn_kernel": "HMMA", "bwd_dkdv_kernel": "HMMA",
                       "bwd_dq_kernel": "HMMA",
                       "int8_conv_wgmma_kernel": "GMMA",
                       "int8_conv_gather_kernel": "IMMA"}


def tensor_core_instructions(build, libs):
    """Phase 2: tensor-core instructions in each instantiation of
    ``TENSOR_CORE_KERNELS``, counted in ``cuobjdump -sass`` of the built
    libraries; fails where one has none."""
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    counts = {}
    for lib in libs:
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        kernel = op = None
        for line in sass.splitlines():
            if "Function :" in line:
                mangled = line.split("Function :")[-1].strip()
                op = next((o for k, o in TENSOR_CORE_KERNELS.items()
                           if k in mangled), None)
                kernel = kernel_name(mangled) if op else None
                if kernel:
                    counts[kernel] = 0
            elif kernel and op in line:
                counts[kernel] += 1
    missing = [k for k in TENSOR_CORE_KERNELS
               if not any(k in name for name in counts)]
    idle = [name for name, n in counts.items() if n == 0]
    if missing or idle:
        raise AssertionError(f"no tensor-core code: missing {missing}, "
                             f"none in {idle}")
    return counts


def check_close(name, got, want, atol=ATOL, rtol=RTOL):
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got).all()) or bool(bad.any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err.max().item()})")
    return err.max().item()


def kernel_phase(fa, card):
    """Phase 3: each kernel against its plain version, timed."""
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    rows = {}

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def k1_row(b, t, label, dtype=torch.float32):
        # q, k, v are views of one fused qkv buffer exactly as the
        # projection produces them
        qkv = rand(b, t, 3 * HEADS * HEAD_DIM).to(dtype)
        q, k, v = (x.unflatten(-1, (HEADS, HEAD_DIM))
                   for x in qkv.split(HEADS * HEAD_DIM, dim=-1))
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.flash_attention_reference(q, k, v, causal=True)
        tol = BF16_TOL if dtype == torch.bfloat16 else ATOL
        err = check_close(f"flash_attention {label}", got, want, tol, tol)
        ms, lo, hi = device_ms(lambda: fa.flash_attention(q, k, v, True))
        plain = device_ms(lambda: fa.flash_attention_reference(
            q, k, v, True))[0]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = device_ms(lambda: torch.nn.functional
                        .scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True))[0]
        n = b * t * HEADS * HEAD_DIM
        bms, by = bound(4 * n * q.element_size(),
                        4 * b * HEADS * HEAD_DIM * t * (t + 1) / 2,
                        *tensor_core_rate(dtype))
        row = dict(name="flash_attention", case=label, dtype=str(dtype),
                   max_abs_err=err, ms=ms, ms_min=lo, ms_max=hi,
                   plain_ms=plain, bound_ms=bms, bound_by=by,
                   library_ms=lib, card=card)
        emit({"phase": "kernel", **row})
        rows.setdefault(kernel_key("flash_attention", dtype), row)

    # K1 at the prefill / predict shapes (the training step's comes last)
    k1_row(2, 1024, "causal_T1024")
    k1_row(1, 200, "ragged_T200")

    # K2: 8 slots plus the trash row against a 1024-position cache
    b, t = 9, 1024
    q = rand(b, 1, HEADS, HEAD_DIM)
    k, v = rand(b, t, HEADS, HEAD_DIM), rand(b, t, HEADS, HEAD_DIM)
    pos = torch.randint(0, t, (b,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[0], pos[1] = 0, t - 1
    got = fa.flash_decode_attention(q, k, v, pos)
    want = fa.flash_decode_attention_reference(q, k, v, pos)
    err = check_close("flash_decode_attention", got, want)
    ms, lo, hi = device_ms(lambda: fa.flash_decode_attention(q, k, v, pos))
    plain = device_ms(lambda: fa.flash_decode_attention_reference(
        q, k, v, pos))[0]
    mask = (torch.arange(t, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = device_ms(lambda: torch.nn.functional
                    .scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask))[0]
    vis = int((pos.long() + 1).clamp(max=t).sum())
    row_bytes = HEADS * HEAD_DIM * 4
    bms, by = bound(2 * vis * row_bytes + 2 * b * row_bytes + 4 * b,
                    4 * vis * HEADS * HEAD_DIM)
    sms = fa.sm_count(dev)
    k2_grid = (b * HEADS, fa.decode_splits(b * HEADS, t, sms))
    rows["flash_decode_attention"] = dict(
        name="flash_decode_attention", case="B9_T1024", max_abs_err=err,
        ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib, splits=k2_grid[1],
        cluster=[k2_grid[1], 1, 1], sms=sms, card=card)
    emit({"phase": "kernel", **rows["flash_decode_attention"]})

    # K3: 8 rows over pools sized like the engine's default, shuffled
    # tables (unmapped entries name the trash block), random frontiers
    b, max_len = 8, 1024
    for bs in (16, 128):
        mb = max_len // bs
        nb = b * mb + 1
        trash = nb - 1
        kp, vp = rand(nb, bs, HEADS, HEAD_DIM), rand(nb, bs, HEADS, HEAD_DIM)
        perm = torch.randperm(nb - 1, generator=g, device=dev)
        tables = perm.reshape(b, mb).to(torch.int32)
        pos = torch.randint(0, max_len, (b,), generator=g, device=dev,
                            dtype=torch.int32)
        pos[0] = 0
        used = (pos.long() // bs + 1)[:, None]
        tables = torch.where(torch.arange(mb, device=dev)[None, :] < used,
                             tables, torch.full_like(tables, trash))
        q = rand(b, 1, HEADS, HEAD_DIM)
        got = fa.flash_paged_decode_attention(q, kp, vp, tables, pos)
        want = fa.flash_paged_decode_attention_reference(q, kp, vp, tables,
                                                         pos)
        err = check_close(f"flash_paged_decode_attention bs{bs}", got, want)
        ms, lo, hi = device_ms(lambda: fa.flash_paged_decode_attention(
            q, kp, vp, tables, pos))
        plain = device_ms(lambda: fa
                          .flash_paged_decode_attention_reference(
                              q, kp, vp, tables, pos))[0]
        vis = int((pos.long() + 1).sum())
        bms, by = bound(2 * vis * row_bytes + 2 * b * row_bytes + 4 * b
                        + 4 * int(used.sum()), 4 * vis * HEADS * HEAD_DIM)
        splits = fa.decode_splits(b * HEADS, mb * bs, sms)
        # no single PyTorch call reads K/V through block tables
        row = dict(name="flash_paged_decode_attention", case=f"B8_bs{bs}",
                   max_abs_err=err, ms=ms, ms_min=lo, ms_max=hi,
                   plain_ms=plain, bound_ms=bms,
                   bound_by=by, library_ms=None, splits=splits,
                   cluster=[splits, 1, 1], card=card)
        emit({"phase": "kernel", **row})
        rows.setdefault("flash_paged_decode_attention", row)
    empty_kernel_floor(card, {
        "K2": k2_grid,
        "K3": (b * HEADS, fa.decode_splits(b * HEADS, max_len, sms))})

    # K1 at the training step's shape, last: its inputs and its plain
    # version's (B, H, T, T) temporaries would otherwise change what the
    # decode rows draw and where their caches lie, and so their times
    k1_row(BATCH, SEQ, f"causal_B{BATCH}_T{SEQ}")
    k1_row(BATCH, SEQ, f"bf16_causal_B{BATCH}_T{SEQ}", torch.bfloat16)
    return rows


def tensor_core_rate(dtype):
    """K1's and K1-bwd's peak rate for ``dtype`` inputs and its label."""
    if dtype == torch.bfloat16:
        return BF16_FLOPS_PER_S, BF16_OPS
    return TF32X3_FLOPS_PER_S, TF32X3


def kernel_key(name, dtype):
    """The kernels line's name of K1's or K1-bwd's row in ``dtype``."""
    return f"{name}_bf16" if dtype == torch.bfloat16 else name


def launch_empty_kernel(clusters, splits):
    """One launch of an empty kernel of K2's and K3's block width as they
    are launched: ``clusters`` clusters of ``splits`` blocks."""
    from bigdl_tpu_torch.ops import _build

    rc = _build.load().bigdl_empty_cluster_launch(
        clusters, splits,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"empty cluster launch failed ({rc})")


def empty_kernel_floor(card, grids):
    """The fixed cost of a launch in phase 3's graph harness: the empty
    kernel in a single block and in each of ``grids`` (kernel label ->
    ``(clusters, splits)``: clusters of splits blocks)."""
    cases = [(1, 1, "one_block")] + [
        (c, s, f"{label}_grid_{c}x{s}") for label, (c, s) in grids.items()]
    for c, s, case in cases:
        ms, lo, hi = device_ms(lambda: launch_empty_kernel(c, s))
        emit({"phase": "kernel_floor", "name": "empty_kernel", "case": case,
              "clusters": c, "splits": s, "ms": ms, "ms_min": lo,
              "ms_max": hi, "card": card})


def clone_tree(tree):
    """A copy of nested dicts of tensors (a cache, an optimizer state)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


#: knob names of a paged step's static inputs
KNOBS = ("temperature", "top_k", "top_p", "seed")


def check_replays(gen, ref, note):
    """Phases 5 and 9: wrap the scheduler ``gen``'s step runner so that
    every replay of a built step is also run eagerly by model ``ref``'s
    own step on a copy of the pool taken just before the replay, on the
    same static inputs, and the logits of its real rows are passed to
    ``note(kind, replayed, reference)``.  A padding row reads the trash
    block or row, where duplicate writes land in no set order, so it is
    not held.  A speculative scheduler's drafter steps are not held: the
    int8 twin takes one activation scale over every row of a step, the
    padding rows' included, so even two eager runs of the same drafter
    step differ (``max abs`` 0.07-0.39 on "small"; PERF.md, PR 8).
    Returns the function that unwraps."""
    from bigdl_tpu_torch.serving import generation as g

    graphs = gen._graphs
    run = graphs.run
    paged = hasattr(gen, "block_size")
    if paged:
        chunk, decode, _ = g.paged_generate_steps(ref)
        trash = gen._alloc.trash
    else:
        prefill, cdecode = g.generate_steps(ref)
    if hasattr(gen, "spec_k"):
        verify = g.speculative_verify_step(ref)

    def checked(key):
        inp = graphs.step(key).inputs.dev
        kind, sample = key[0], key[-1] == "sampled"
        if kind == "draft":
            return run(key)
        knobs = {n: inp[n] for n in KNOBS if n in inp}
        before = clone_tree(gen._cache)
        out = run(key)
        with torch.no_grad():
            if kind == "chunk":
                want = chunk(before, **inp, sample=sample)[1]
                real, kind = inp["lengths"] > 0, "paged_chunk_prefill"
            elif kind == "decode" and paged:
                want = decode(before, **inp, sample=sample)[1]
                real, kind = inp["tables"][:, 0] != trash, "paged_decode"
            elif kind == "prefill":
                want = prefill(before, **inp)[1]
                real = inp["slot_ids"] != gen._trash
                kind = "contiguous_prefill"
            elif kind == "decode":
                want = cdecode(before, **inp)[1]
                real = torch.arange(want.shape[0], device=want.device) \
                    != gen._trash
                kind = "contiguous_decode"
            else:                                   # verify
                want = verify(before, inp["last"], gen._drafts[:gen.spec_k],
                              inp["pos"], inp["tables"], **knobs,
                              sample=sample)[1]
                real = inp["tables"][:, 0] != trash
        note(kind, out[1][real], want[real])
        return out

    graphs.run = checked

    def unwrap():
        del graphs.run
    return unwrap


def served_step_errors(engines, refs, prompts, max_new):
    """Phase 5 (and phase 9's check): one greedy burst through each engine
    of ``engines`` (label -> engine) with ``check_replays`` on its
    scheduler against ``refs[label]``, the plain model, logits held to
    1e-4.  With random weights the greedy streams repeat a few tokens, so
    equal streams alone show little; these logits carry the evidence.
    Returns the largest abs logit error of each engine's kinds of step
    and the streams."""
    errs = {}

    def noter(label):
        def note(kind, got, want):
            err = check_close(f"{label}: replayed {kind} logits", got, want)
            errs.setdefault(label, {})
            errs[label][kind] = max(errs[label].get(kind, 0.0), err)
        return note

    unwraps = [check_replays(eng._gen, refs[label], noter(label))
               for label, eng in engines.items()]
    streams = {}
    try:
        for label, eng in engines.items():
            futs = [eng.generate(p, max_new_tokens=max_new)
                    for p in prompts]
            streams[label] = [f.result(600) for f in futs]
    finally:
        for unwrap in unwraps:
            unwrap()
    for label, eng in engines.items():
        kinds = {"paged_chunk_prefill", "verify"} \
            if hasattr(eng._gen, "spec_k") \
            else {"paged_chunk_prefill", "paged_decode"} \
            if eng.kv_cache == "paged" \
            else {"contiguous_prefill", "contiguous_decode"}
        if set(errs.get(label, ())) != kinds:
            raise AssertionError(f"{label}: replayed steps checked: "
                                 f"{sorted(errs.get(label, ()))}, want "
                                 f"{sorted(kinds)}")
    return errs, streams


#: the host's launch calls (CUDA runtime and driver API), as the profiler
#: names them: kernel launches, cluster launches and graph launches
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def host_calls_per_decode_tick(eng, prompt, new_tokens):
    """The host's CUDA calls per decode tick (a speculative engine's: per
    round), from two profiled requests of one prompt shorter than a KV
    block (no prefix hit): one of ``new_tokens`` tokens less one of a
    single token (its prefill alone), over their difference in ticks.
    Returns the calls by name and the decode ticks counted."""
    gen = eng._gen
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    counts = []
    for n in (1, new_tokens):
        ticks = gen.stats()["ticks"]
        with torch.profiler.profile(activities=acts) as prof:
            eng.generate(prompt, max_new_tokens=n).result(600)
            torch.cuda.synchronize()
        calls = collections.Counter(
            e.name for e in prof.events()
            if e.name in LAUNCH_CALLS or e.name.startswith("cudaMemcpy"))
        counts.append((calls, gen.stats()["ticks"] - ticks))
    (c1, t1), (cn, tn) = counts
    ticks = tn - t1
    per = {name: (cn[name] - c1[name]) / ticks for name in set(cn) | set(c1)}
    return per, ticks


def engine_graph_row(label, eng, built, bursts, card, prompt, **extra):
    """One engine's row: steps built in ``precompile()`` and after it,
    replays, the host's launch calls per decode tick, and the bursts'
    tokens/s, TTFT and peak memory (``bursts``: rows of ``timed_burst``).
    Fails if anything was built after ``precompile()``."""
    graphs = eng.stats()["generate"]["graphs"]
    if graphs["captured_after_precompile"]:
        raise AssertionError(f"{label}: steps built after precompile(): "
                             f"{graphs}")
    calls, ticks = host_calls_per_decode_tick(eng, prompt, 17)
    row = {"phase": "graphs", "engine": label, "captured_in_precompile":
           built, **graphs,
           "host_launches_per_decode_tick": sum(
               calls.get(n, 0) for n in LAUNCH_CALLS),
           "host_calls_per_decode_tick": calls, "decode_ticks_profiled":
           ticks, "tokens_per_s": [b["tokens_per_s"] for b in bursts],
           "ttft_median_s": [b["ttft_median_s"] for b in bursts],
           "peak_memory_bytes": [b["peak_memory_bytes"] for b in bursts],
           **extra, "card": card}
    emit(row)
    return row


def serving_models():
    """TransformerLM "small" from seed 0, with the kernels and with plain
    attention (the same weights): the models of phases 4, 5 and 9."""
    from bigdl_tpu_torch.models import transformer_lm

    t0 = time.perf_counter()
    model = transformer_lm("small", vocab_size=SERVE_VOCAB, device="cuda",
                           seed=0)
    plain_model = transformer_lm("small", vocab_size=SERVE_VOCAB,
                                 device="cuda", seed=0, use_flash="never")
    emit({"phase": "e2e_setup", "model": "small",
          "params": sum(p.numel() for p in model.parameters()),
          "init_s": time.perf_counter() - t0})
    return model, plain_model


def serving_prompts(seed):
    """8 greedy prompts of 17 to 700 tokens (``synthetic_corpus``)."""
    from bigdl_tpu_torch.models import synthetic_corpus

    toks, _ = synthetic_corpus(8, 700, SERVE_VOCAB, seed=seed)
    lengths = np.linspace(17, 700, 8).astype(int)
    return [toks[i, :n] for i, n in enumerate(lengths)]


def timed_burst(eng, prompts, max_new, label, card, phase="e2e_generate",
                **extra):
    """One burst of greedy requests, all submitted at once; emits and
    returns its streams and its row: tokens/s (host clock), TTFT and the
    peak memory allocated during the burst."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    futs = [eng.generate(p, max_new_tokens=max_new) for p in prompts]
    out = [f.result(600) for f in futs]
    wall = time.perf_counter() - t0
    n_tok = sum(len(s) for s in out)
    ttft = sorted(f.first_token_s for f in futs)
    row = {"phase": phase, "engine": label, **extra,
           "requests": len(futs), "tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "ttft_median_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
           "prefix_hit_tokens": sum(f.prefix_hit_tokens for f in futs),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "card": card}
    emit(row)
    return out, row


def e2e_phase(fa, card, model, plain_model):
    """Phase 4: TransformerLM "small" through three engines and predict.
    Returns the main path's launches and the fp32 paged engine's tokens/s
    in each round."""
    from bigdl_tpu_torch.models import synthetic_corpus
    from bigdl_tpu_torch.serving import ServingEngine

    vocab, max_new = SERVE_VOCAB, SERVE_NEW
    prompts = serving_prompts(1)
    seq512, _ = synthetic_corpus(1, 512, vocab, seed=2)
    seq200, _ = synthetic_corpus(1, 200, vocab, seed=3)
    # fresh prompts for phase 5, so no prefix-cache hit shortens prefill
    prompts5 = serving_prompts(4)

    engines = {
        "paged": ServingEngine(model, decode_slots=8, decode_max_len=1024),
        "contiguous": ServingEngine(model, decode_slots=8,
                                    decode_max_len=1024,
                                    kv_cache="contiguous"),
        "paged_plain": ServingEngine(plain_model, decode_slots=8,
                                     decode_max_len=1024),
    }
    try:
        built = {label: eng.precompile() for label, eng in engines.items()}
        streams, sampled, bursts = {}, {}, {}
        fa.reset_launch_counts()
        # ---- the main path: counts read right after it ----------------
        # two rounds in turn (paged, contiguous, plain, paged, ...): the
        # first rounds' numbers carry the first use of each shape
        for rnd in (0, 1):
            for label, eng in engines.items():
                streams[(label, rnd)], bursts[(label, rnd)] = timed_burst(
                    eng, prompts, max_new, label, card, round=rnd)
        eng = engines["paged"]
        for seed in (11, 12):
            sampled[seed] = eng.generate(prompts[seed % 8], max_new_tokens=
                                         max_new, temperature=0.8, top_k=50,
                                         seed=seed).result(600)
        replay = eng.generate(prompts[11 % 8], max_new_tokens=max_new,
                              temperature=0.8, top_k=50,
                              seed=11).result(600)
        logits512 = eng.predict(seq512[0], timeout=600)
        logits200 = eng.predict(seq200[0], timeout=600)
        torch.cuda.synchronize()
        launches = {k: fa.LAUNCHES[k] for k in SERVING_KERNELS}
        # -----------------------------------------------------------------
        peak = max(torch.cuda.max_memory_allocated(),
                   *(r["peak_memory_bytes"] for r in bursts.values()))
        step_errs, streams5 = served_step_errors(
            {k: engines[k] for k in ("paged", "contiguous")},
            {"paged": plain_model, "contiguous": plain_model}, prompts5,
            max_new)
        for label, eng in engines.items():
            engine_graph_row(label, eng, built[label],
                             [bursts[(label, rnd)] for rnd in (0, 1)],
                             card, prompts5[0][:8])
    finally:
        for e in engines.values():
            e.close()

    first = streams[("paged", 0)]
    if any(out != first for out in streams.values()):
        raise AssertionError(f"greedy streams differ across engines: "
                             f"{streams}")
    if not all(len(s) == max_new for s in first):
        raise AssertionError("a greedy stream stopped short")
    if replay != sampled[11]:
        raise AssertionError(f"sampled request did not replay: "
                             f"{sampled[11]} vs {replay}")
    if not all(0 <= t < vocab for s in sampled.values() for t in s):
        raise AssertionError("sampled token out of the vocabulary")
    errs = {}
    with torch.no_grad():
        for name, seq, got in (("predict_T512", seq512, logits512),
                               ("predict_T200", seq200, logits200)):
            want = plain_model(torch.as_tensor(seq, device="cuda"))[0]
            if got.shape != tuple(want.shape):
                raise AssertionError(f"{name}: shape {got.shape}")
            errs[name] = check_close(name, torch.as_tensor(got), want.cpu())
    if streams5["paged"] != streams5["contiguous"]:
        raise AssertionError(f"phase 5 greedy streams differ: {streams5}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was never launched on the main "
                                 f"path ({launches})")
    emit({"phase": "e2e_check", "greedy_streams_equal": True,
          "sampled_replay_equal": True, "max_abs_err_vs_plain": errs,
          "launches": launches, "peak_memory_bytes": peak,
          "distinct_greedy_tokens": len({t for s in first for t in s}),
          "first_stream": first[0][:8], "card": card})
    emit({"phase": "served_steps", "max_abs_err_vs_plain": step_errs,
          "greedy_streams_equal": True,
          "distinct_greedy_tokens": len({t for s in streams5["paged"]
                                         for t in s}), "card": card})
    return launches, [bursts[("paged", rnd)]["tokens_per_s"]
                      for rnd in (0, 1)]


def training_kernel_phase(fa, ce, card):
    """Phase 6: K4, K5 and K1-bwd at the training step's shapes against
    their plain versions, timed."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(6)
    dev = "cuda"
    rows = {}
    n, v = BATCH * SEQ, VOCAB
    x = torch.randn(n, v, generator=g, device=dev)
    y = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    yl = y.long()

    loss, lse = ce.fused_softmax_cross_entropy_fwd(x, y)
    want_loss, want_lse = ce.fused_softmax_cross_entropy_reference(x, y)
    err = max(check_close("fused_softmax_cross_entropy loss", loss,
                          want_loss),
              check_close("fused_softmax_cross_entropy lse", lse, want_lse))
    ms, lo, hi = device_ms(lambda: ce.fused_softmax_cross_entropy_fwd(x, y))
    plain = device_ms(lambda: ce.fused_softmax_cross_entropy_reference(
        x, y))[0]
    lib = device_ms(lambda: F.cross_entropy(x, yl, reduction="none"))[0]
    bms, by = bound(n * v * 4 + n * 4 + 2 * n * 4, 4 * n * v)
    rows["fused_softmax_cross_entropy"] = dict(
        name="fused_softmax_cross_entropy", case=f"N{n}_V{v}",
        max_abs_err=err, ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=lib, card=card)
    emit({"phase": "kernel", **rows["fused_softmax_cross_entropy"]})

    # K5 held at an upstream gradient of order 1 that differs per row, so
    # dx is of the order of the softmax; every element to 1e-4 of its own
    # size (no absolute floor: the softmax terms are 1e-7 to 1e-3)
    gr = torch.rand(n, generator=g, device=dev) + 0.5
    dx = ce.fused_softmax_cross_entropy_bwd(x, y, lse, gr)
    err = check_close("fused_softmax_cross_entropy_bwd", dx,
                      ce.fused_softmax_cross_entropy_grad_reference(
                          x, y, lse, gr), atol=0.0)
    del dx
    # timed with a mean's upstream gradient, 1/N per row
    gr = torch.full((n,), 1.0 / n, device=dev)
    ms, lo, hi = device_ms(lambda: ce.fused_softmax_cross_entropy_bwd(
        x, y, lse, gr))
    plain = device_ms(lambda: ce.fused_softmax_cross_entropy_grad_reference(
        x, y, lse, gr))[0]
    xg = x.detach().requires_grad_(True)
    lib, lib_wall = backward_ms(F.cross_entropy(xg, yl, reduction="none"),
                                xg, gr)
    del xg
    bms, by = bound(2 * n * v * 4 + 3 * n * 4, 4 * n * v)
    rows["fused_softmax_cross_entropy_bwd"] = dict(
        name="fused_softmax_cross_entropy_bwd", case=f"N{n}_V{v}",
        max_abs_err=err, ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=lib,
        library_event_wall_ms=lib_wall, card=card)
    emit({"phase": "kernel", **rows["fused_softmax_cross_entropy_bwd"]})
    del x

    # K1-bwd on q/k/v views of one fused buffer, as the model gives them;
    # the bf16 case is the bf16 training step's
    for t, label, dtype in (
            (SEQ, f"causal_B{BATCH}_T{SEQ}", torch.float32),
            (200, f"ragged_B{BATCH}_T200", torch.float32),
            (SEQ, f"bf16_causal_B{BATCH}_T{SEQ}", torch.bfloat16)):
        qkv = torch.randn(BATCH, t, 3 * HEADS * HEAD_DIM, generator=g,
                          device=dev).to(dtype)
        q, k, v_ = (z.unflatten(-1, (HEADS, HEAD_DIM))
                    for z in qkv.split(HEADS * HEAD_DIM, dim=-1))
        do = torch.randn(BATCH, t, HEADS, HEAD_DIM, generator=g,
                         device=dev).to(dtype)
        out, lse = fa._flash_forward(q, k, v_, True, with_lse=True)
        got = fa.flash_attention_bwd(q, k, v_, out, lse, do, True)
        want = fa.flash_attention_bwd_reference(q, k, v_, do, True)
        tol = BF16_TOL if dtype == torch.bfloat16 else ATOL
        err = max(check_close(f"flash_attention_bwd {label} d{w}", a, b,
                              tol, tol)
                  for w, a, b in zip("qkv", got, want))
        del got, want
        ms, lo, hi = device_ms(lambda: fa.flash_attention_bwd(
            q, k, v_, out, lse, do, True))
        leaves = [z.detach().requires_grad_(True) for z in (q, k, v_)]
        plain, plain_wall = backward_ms(
            fa.flash_attention_reference(*leaves, True), leaves, do)
        tr = [z.detach().transpose(1, 2).requires_grad_(True)
              for z in (q, k, v_)]
        lib, lib_wall = backward_ms(
            F.scaled_dot_product_attention(*tr, is_causal=True), tr,
            do.transpose(1, 2))
        del leaves, tr
        elems = BATCH * t * HEADS * HEAD_DIM
        # q, k, v, out, dout read and dq, dk, dv written; the fp32 lse read
        bms, by = bound(8 * elems * q.element_size() + BATCH * HEADS * t * 4,
                        10 * BATCH * HEADS * HEAD_DIM * t * (t + 1) / 2,
                        *tensor_core_rate(dtype))
        row = dict(name="flash_attention_bwd", case=label, dtype=str(dtype),
                   max_abs_err=err, ms=ms, ms_min=lo, ms_max=hi,
                   plain_ms=plain, plain_event_wall_ms=plain_wall,
                   bound_ms=bms, bound_by=by, library_ms=lib,
                   library_event_wall_ms=lib_wall, card=card)
        emit({"phase": "kernel", **row})
        rows.setdefault(kernel_key("flash_attention_bwd", dtype), row)
    torch.cuda.empty_cache()
    return rows


class _Losses:
    """Train summary that keeps each step's scalars (loss, throughput,
    learning rates) by tag."""

    def __init__(self):
        self.scalars = {"Loss": [], "Throughput": []}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append(value)


def union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals (us)."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def eager_vs_compiled(x, y, dtype, compiled_model, compiled_losses, card):
    """Phase 7 (a): the main path's 8 batches (the dataset's first epoch,
    in order) through the eager ``make_train_step`` on a second model
    from the same weights (seed 0), against the compiled run's per-step
    losses and its parameters after the 8 steps."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models import transformer_lm

    model = transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                           seed=0)
    adam = optim.Adam(learning_rate=1e-4)
    state = adam.init_state(dict(model.named_parameters()))
    step = optim.make_train_step(
        model, nn.TimeDistributedCriterion(
            nn.FusedSoftmaxCrossEntropyCriterion()), adam,
        compute_dtype=dtype)
    losses = []
    for i in range(TRAIN_ITERS):
        xb = torch.as_tensor(x[i * BATCH:(i + 1) * BATCH], device="cuda")
        yb = torch.as_tensor(y[i * BATCH:(i + 1) * BATCH], device="cuda")
        losses.append(step(state, xb, yb)[1].item())
    step_rel = [abs(a - b) / abs(b) for a, b in zip(compiled_losses, losses)]
    rel, bitwise = {}, compiled_losses == losses
    with torch.no_grad():
        for (name, pc), (_, pe) in zip(compiled_model.named_parameters(),
                                       model.named_parameters()):
            rel[name] = rel_l2(pc, pe)
            bitwise = bitwise and torch.equal(pc, pe)
    worst = max(rel, key=rel.get)
    tol = COMPILED_RTOL[dtype]
    row = {"phase": "train_compiled_vs_eager",
           "compute_dtype": "bf16" if dtype else "fp32",
           "eager_losses": losses, "compiled_losses": compiled_losses,
           "max_step_loss_rel": max(step_rel), "worst_param": worst,
           "worst_param_rel_l2": rel[worst], "bitwise_equal": bitwise,
           "tolerance": tol, "card": card}
    emit(row)
    if len(compiled_losses) != TRAIN_ITERS or max(step_rel) > tol or \
            rel[worst] > tol:
        raise AssertionError(f"compiled step against eager: {row}")
    del model, state, step
    torch.cuda.empty_cache()
    return row


class StepClock:
    """An end trigger that also marks ``opt``'s loop: the loop calls it
    at the top of every step with its own state dict (the staging
    probe passes a copy, which is not marked), and it ends the run after
    ``steps`` steps counted from its first call.  At step ``i`` (0 = the
    first; ``steps`` = the call that ends the run) it syncs the card when
    ``i`` is in ``sync_at``, records the time and the captures so far in
    ``marks[i]``, then runs ``then[i]()``.  Each ``optimize()`` builds its
    compiled step anew, so the marks time and profile the steps after a
    run's first one (its warm-up and capture) within that run."""

    def __init__(self, opt, steps, sync_at=(), then=None):
        self.opt, self.steps = opt, steps
        self.sync_at, self.then = set(sync_at), then or {}
        self.first, self.marks = None, {}

    def __call__(self, state):
        if self.first is None:
            self.first = state["neval"]
        i = state["neval"] - self.first
        if state is self.opt.driver_state and i not in self.marks:
            from bigdl_tpu_torch.utils import cuda_graphs

            if i in self.sync_at:
                torch.cuda.synchronize()
            self.marks[i] = (time.perf_counter(),
                             cuda_graphs.capture_count())
            if i in self.then:
                self.then[i]()
        return i >= self.steps


def compiled_step_rates(opt, label, card, steps=8, profiled=3):
    """Phase 7 (b) and (d), continuing a trained optimizer without a train
    summary, each run a fresh compiled step: in a run of ``profiled + 3``
    steps, steps 3 to ``profiled + 2`` under the profiler (the host's CUDA
    calls by name and the device's busy time, per step; captures after
    the run's first step: 0; ``compiled``: the graphs each run captured);
    then runs of ``steps + 1`` steps at
    ``set_sync_every`` 1 and 4, timed over the ``steps`` after the first
    (tokens/s, the idle share against the profiled busy time).  At the
    end of the sync-1 run, with its graph alive, the memory it keeps:
    the graph pool's bytes, and what the allocator reserves once its
    cache is emptied, beside the run's peak allocation (its eager warm-up
    included)."""
    opt.set_train_summary(None)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    clock = StepClock(opt, profiled + 3, sync_at=(2, profiled + 2),
                      then={2: prof.start, profiled + 2: prof.stop})
    opt.set_end_when(clock)
    opt.optimize()
    torch.cuda.synchronize()
    captures_after_first = clock.marks[profiled + 2][1] - clock.marks[1][1]
    compiled = [opt.compiled_stats["captured"]]
    calls = collections.Counter(
        e.name for e in prof.events()
        if e.name in LAUNCH_CALLS or e.name.startswith("cudaMemcpy"))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = union_us([(e.time_range.start, e.time_range.end)
                       for e in kernels]) / 1e6 / profiled
    rates, memory = {}, {}

    def keeps():
        memory["allocated_bytes"] = torch.cuda.memory_allocated()
        torch.cuda.empty_cache()
        memory["reserved_with_graph_bytes"] = torch.cuda.memory_reserved()

    for k in (1, 4):
        opt.set_sync_every(k)
        clock = StepClock(opt, steps + 1, sync_at=(1, steps + 1),
                          then={steps + 1: keeps} if k == 1 else None)
        opt.set_end_when(clock)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        opt.optimize()
        torch.cuda.synchronize()
        wall = (clock.marks[steps + 1][0] - clock.marks[1][0]) / steps
        captures_after_first += clock.marks[steps + 1][1] - clock.marks[1][1]
        compiled.append(opt.compiled_stats["captured"])
        rates[k] = {"step_s": wall, "tokens_per_s": BATCH * SEQ / wall,
                    "device_idle_share": 1.0 - busy_s / wall}
        if k == 1:
            memory.update(
                graph_pool_bytes=opt.compiled_stats["pool_bytes"],
                peak_allocated_bytes=torch.cuda.max_memory_allocated(),
                peak_reserved_bytes=torch.cuda.max_memory_reserved())
    opt.set_sync_every(1)
    row = {"phase": "train_compiled_rates", "path": label,
           "host_calls_per_step": {n: c / profiled for n, c in calls.items()},
           "host_launches_per_step": sum(
               calls.get(n, 0) for n in LAUNCH_CALLS) / profiled,
           "device_kernels_per_step": len(kernels) / profiled,
           "device_busy_s_per_step": busy_s,
           "captures_after_first_step": captures_after_first,
           "compiled": compiled,
           "sync_every": {str(k): r for k, r in rates.items()},
           "memory": memory, "card": card}
    emit(row)
    if row["captures_after_first_step"] or set(compiled) != {1} or \
            calls.get("cudaGraphLaunch", 0) != profiled or any(
                calls.get(n, 0) for n in LAUNCH_CALLS
                if n != "cudaGraphLaunch") or not memory["graph_pool_bytes"]:
        raise AssertionError(f"the compiled step relaunched or recaptured: "
                             f"{row}")
    return row


def schedule_legs(fa, ce, card, x, y):
    """Phase 7 (e): 8 compiled fp32 steps of "small" with ``SGD(momentum=
    0.9)`` under ``SequentialSchedule(Warmup, Poly)``, and 8 with a
    ``CompositeOptimMethod`` (SGD under ``Exponential`` for the embedding
    table ``wte``, Adam with ``learning_rate_decay`` for every other
    subtree).  Each step's ``LearningRate`` scalars against the same
    formulas in float64 on the host (1e-6 relative), the launches through
    replays, finite losses.  ``set_optim_methods`` by submodule names
    refuses this model: ``wte``, ``wpe`` and ``head`` are its own leaves,
    which no submodule name reaches (the reference's cover rule), so the
    composite is built from paths."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.models import transformer_lm
    from bigdl_tpu_torch.utils.errors import ConfigurationError

    lr0, delta, warm, power, horizon = 0.01, 0.002, 3, 2.0, 50

    def scheduled():
        sched = optim.SequentialSchedule().add(optim.Warmup(delta), warm) \
            .add(optim.Poly(power, horizon), 1000)
        want = {"LearningRate": [
            lr0 + delta * s if s < warm else
            lr0 * (1.0 - (s - warm) / horizon) ** power
            for s in range(1, TRAIN_ITERS + 1)]}
        return optim.SGD(learning_rate=lr0, momentum=0.9,
                         learning_rate_schedule=sched), want

    def composite():
        keys = ["wpe", "head", *(f"block{i}" for i in range(12)), "ln_f"]
        adam = optim.Adam(learning_rate=1e-4, learning_rate_decay=0.01)
        method = optim.CompositeOptimMethod(
            [("embedding", ("wte",), optim.SGD(
                learning_rate=0.05, momentum=0.9,
                learning_rate_schedule=optim.Exponential(4, 0.5)))]
            + [(k, (k,), adam) for k in keys])
        # logged after each step: the rate of the step after it
        steps = range(1, TRAIN_ITERS + 1)
        want = {"LearningRate/embedding": [0.05 * 0.5 ** (s / 4)
                                           for s in steps]}
        want.update({f"LearningRate/{k}": [1e-4 / (1 + s * 0.01)
                                           for s in steps] for k in keys})
        return method, want

    rows = []
    for label, make in (("sgd_warmup_poly", scheduled),
                        ("composite_sgd_embedding_adam_rest", composite)):
        model = transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                               seed=0)
        crit = nn.TimeDistributedCriterion(
            nn.FusedSoftmaxCrossEntropyCriterion())
        method, want = make()
        if label.startswith("composite"):
            try:
                optim.build_composite_method(
                    model, dict(model.named_parameters()),
                    {str(b.name): method for b in model.blocks})
                raise AssertionError("set_optim_methods covered the model")
            except ConfigurationError as e:
                refusal = str(e)
        opt = optim.Optimizer(model, array_dataset(x, y)
                              >> SampleToMiniBatch(BATCH), crit, method)
        opt.set_end_when(optim.Trigger.max_iteration(TRAIN_ITERS))
        summary = _Losses()
        opt.set_train_summary(summary)
        fa.reset_launch_counts()
        ce.reset_launch_counts()
        opt.optimize()
        torch.cuda.synchronize()
        launches = {**fa.LAUNCHES, **ce.LAUNCHES}
        worst = max(abs(g - w) / abs(w) for tag, ws in want.items()
                    for g, w in zip(summary.scalars[tag], ws))
        losses = summary.scalars["Loss"]
        row = {"phase": "train_schedule_leg", "leg": label,
               "losses": losses, "learning_rates": {
                   tag: summary.scalars[tag][:TRAIN_ITERS]
                   for tag in list(want)[:2]},
               "max_lr_rel_err_vs_float64": worst,
               "compiled": opt.compiled_stats["captured"],
               "launches": {k: launches[k] for k in TRAIN_KERNELS},
               "card": card}
        if label.startswith("composite"):
            row["set_optim_methods_refusal"] = refusal
        emit(row)
        if worst > 1e-6 or not all(np.isfinite(losses)) or \
                len(losses) != TRAIN_ITERS or any(
                    len(summary.scalars[t]) != TRAIN_ITERS for t in want) \
                or row["launches"] != TRAIN_WANT or row["compiled"] != 1:
            raise AssertionError(f"schedule leg {label}: {row}")
        rows.append(row)
        del model, opt, method
        torch.cuda.empty_cache()
    return rows


#: the training path's kernels and their launches over phase 7's 8 steps
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd",
                 "fused_softmax_cross_entropy",
                 "fused_softmax_cross_entropy_bwd")
TRAIN_WANT = {"flash_attention": 12 * TRAIN_ITERS,
              "flash_attention_bwd": 12 * TRAIN_ITERS,
              "fused_softmax_cross_entropy": TRAIN_ITERS,
              "fused_softmax_cross_entropy_bwd": TRAIN_ITERS}


def training_phase(fa, ce, card):
    """Phase 7: TransformerLM "small" trained through the kernels and
    through the plain path on the same weights and batches, each step one
    replay of the compiled step; then the compiled step against the eager
    one, its host calls, rates and schedule legs."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.models import synthetic_corpus, transformer_lm

    t0 = time.perf_counter()
    x, y = synthetic_corpus(64, SEQ, VOCAB)
    models = {
        "kernels": (transformer_lm("small", VOCAB, max_len=SEQ,
                                   device="cuda", seed=0),
                    nn.TimeDistributedCriterion(
                        nn.FusedSoftmaxCrossEntropyCriterion())),
        "plain": (transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                                 seed=0, use_flash="never"),
                  nn.TimeDistributedCriterion(nn.CrossEntropyCriterion())),
    }
    emit({"phase": "train_setup", "model": "small", "vocab": VOCAB,
          "seq_len": SEQ, "batch": BATCH, "init_s": time.perf_counter() - t0})

    # (a) one batch: the loss and every parameter's gradient
    xb = torch.as_tensor(x[:BATCH], device="cuda")
    yb = torch.as_tensor(y[:BATCH], device="cuda")
    losses, grads = {}, {}
    for label, (model, crit) in models.items():
        model.zero_grad(set_to_none=True)
        loss = crit.apply(model(xb), yb)
        loss.backward()
        losses[label] = loss.item()
        grads[label] = {k: p.grad for k, p in model.named_parameters()}
    if abs(losses["kernels"] - losses["plain"]) > ATOL:
        raise AssertionError(f"training loss: kernels {losses['kernels']} vs "
                             f"plain {losses['plain']}")
    rel = {}
    for name, gk in grads["kernels"].items():
        gp = grads["plain"][name]
        if gk is None or gp is None:
            raise AssertionError(f"no gradient reached {name}")
        nk, np_ = gk.norm().item(), gp.norm().item()
        if nk == 0.0 or np_ == 0.0:
            raise AssertionError(f"zero gradient for {name} (kernels "
                                 f"{nk}, plain {np_})")
        rel[name] = ((gk - gp).norm() / gp.norm()).item()
    worst = max(rel, key=rel.get)
    if rel[worst] > RTOL:
        raise AssertionError(f"gradient of {worst}: relative L2 error "
                             f"{rel[worst]} > {RTOL}")
    emit({"phase": "train_grads", "params": len(rel),
          "loss_kernels": losses["kernels"], "loss_plain": losses["plain"],
          "worst_param": worst, "worst_rel_l2": rel[worst],
          "median_rel_l2": sorted(rel.values())[len(rel) // 2],
          "card": card})
    for model, _ in models.values():
        model.zero_grad(set_to_none=True)
    # the last loss holds its autograd graph, whose gradient accumulators
    # are bound to the stream of that eager forward: a captured backward
    # would run them there
    del grads, loss

    # (b) Optimizer.optimize() on both; (c) the kernel path's launches
    from bigdl_tpu_torch.utils import cuda_graphs

    runs, kept = {}, {}
    for label, (model, crit) in models.items():
        ds = array_dataset(x, y) >> SampleToMiniBatch(BATCH)
        opt = optim.Optimizer(model, ds, crit,
                              optim.Adam(learning_rate=1e-4))
        opt.set_end_when(optim.Trigger.max_iteration(TRAIN_ITERS))
        summary = _Losses()
        opt.set_train_summary(summary)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        ce.reset_launch_counts()
        captures = cuda_graphs.capture_count()
        # ---- the training main path: counts read right after it --------
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**fa.LAUNCHES, **ce.LAUNCHES}
        # -----------------------------------------------------------------
        kept[label] = opt
        compiled = dict(opt.compiled_stats,
                        captures=cuda_graphs.capture_count() - captures)
        with torch.no_grad():   # the first batch again, after training
            after = crit.apply(model(xb), yb).item()
        tok_s = sorted(r * SEQ for r in summary.scalars["Throughput"][1:])
        runs[label] = dict(losses=summary.scalars["Loss"],
                           first_batch_loss_before=losses[label],
                           first_batch_loss_after=after, launches=launches,
                           wall_s=wall,
                           tokens_per_s=TRAIN_ITERS * BATCH * SEQ / wall,
                           step_tokens_per_s_median=tok_s[len(tok_s) // 2],
                           peak_memory_bytes=torch.cuda.max_memory_allocated(),
                           allocated_after_bytes=torch.cuda.memory_allocated(),
                           reserved_after_bytes=torch.cuda.memory_reserved(),
                           captured=compiled["captured"],
                           replays=compiled["replays"],
                           graph_pool_bytes=compiled["pool_bytes"],
                           warmup_launches=compiled["warmup_launches"])
        emit({"phase": "train_run", "path": label, **runs[label],
              "card": card})
        if compiled["captured"] != 1 or compiled["captures"] != 1 or \
                compiled["replays"] != TRAIN_ITERS:
            raise AssertionError(f"{label}: not one graph replayed every "
                                 f"step: {compiled}")

    lk, lp = runs["kernels"]["losses"], runs["plain"]["losses"]
    if len(lk) != TRAIN_ITERS or len(lp) != TRAIN_ITERS:
        raise AssertionError(f"steps run: {len(lk)}, {len(lp)}")
    step_rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    if max(step_rel) > STEP_LOSS_RTOL:
        raise AssertionError(f"per-step losses differ: {lk} vs {lp}")
    # each step sees another batch, so the per-step losses carry the
    # batches' spread; the first batch's loss before and after the 8 steps
    # shows the fall without it
    falls = {label: (r["first_batch_loss_before"],
                     r["first_batch_loss_after"]) for label, r in runs.items()}
    if not all(after < before for before, after in falls.values()) or \
            not lk[-1] < lk[0]:
        raise AssertionError(f"the loss did not fall: {falls}, {lk}")
    ak, ap = falls["kernels"][1], falls["plain"][1]
    if abs(ak - ap) > STEP_LOSS_RTOL * abs(ap):
        raise AssertionError(f"losses after training differ: {ak} vs {ap}")
    want = TRAIN_WANT
    got = runs["kernels"]["launches"]
    if any(got[k] != n for k, n in want.items()):
        raise AssertionError(f"training launches {got}, want {want}")
    if any(runs["plain"]["launches"].values()):
        raise AssertionError(f"the plain model launched kernels: "
                             f"{runs['plain']['launches']}")
    emit({"phase": "train_check", "first_batch_loss": falls["kernels"],
          "max_step_rel_err": max(step_rel), "launches": got, "card": card})
    kmodel = models["kernels"][0]
    # the plain run and its optimizer go, so what follows has the memory
    del models, model, crit, opt, kept["plain"]
    torch.cuda.empty_cache()
    eager_vs_compiled(x, y, None, kmodel, lk, card)         # (a)
    compiled_step_rates(kept.pop("kernels"), "fp32", card)  # (b), (d)
    del kmodel
    torch.cuda.empty_cache()
    schedule_legs(fa, ce, card, x, y)                       # (e)
    bf16 = training_bf16_phase(fa, ce, card, x, y, losses["kernels"],
                               runs["kernels"])
    return {k: got[k] for k in want}, bf16


def rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def training_bf16_phase(fa, ce, card, x, y, fp32_loss, fp32_run):
    """Phase 7's bf16 leg: TransformerLM "small" from seed 0 trained with
    ``compute_dtype=torch.bfloat16``.  (a) One batch through the kernel
    path and the plain path (``use_flash="never"``, plain cross-entropy)
    on the same weights: the losses, each against the other and against
    the fp32 kernel path's ``fp32_loss``, and every parameter's fp32
    gradient.  (b) 8 iterations of ``Optimizer(...).set_compute_dtype(
    torch.bfloat16).optimize()``: the per-step losses against the fp32
    kernel run ``fp32_run``, the loss falling, tokens/s, wall and peak
    memory.  (c) That run's launches: the bf16 K1 and K1-bwd 12 a step,
    K4 and K5 (fp32 logits) one a step, no fp32 K1 and no plain
    attention.  Returns (c)'s counts under the kernels line's names."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.models import transformer_lm
    from bigdl_tpu_torch.utils import cuda_graphs

    bf16 = torch.bfloat16
    models = {
        "kernels": (transformer_lm("small", VOCAB, max_len=SEQ,
                                   device="cuda", seed=0),
                    nn.TimeDistributedCriterion(
                        nn.FusedSoftmaxCrossEntropyCriterion())),
        "plain": (transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                                 seed=0, use_flash="never"),
                  nn.TimeDistributedCriterion(nn.CrossEntropyCriterion())),
    }
    # (a) one batch through the train step at learning rate 0: the
    # gradients stay on the parameters, which do not move
    xb = torch.as_tensor(x[:BATCH], device="cuda")
    yb = torch.as_tensor(y[:BATCH], device="cuda")
    losses, grads = {}, {}
    for label, (model, crit) in models.items():
        sgd = optim.SGD(learning_rate=0.0)
        step = optim.make_train_step(model, crit, sgd, compute_dtype=bf16)
        _, loss = step(sgd.init_state(dict(model.named_parameters())), xb,
                       yb)
        losses[label] = loss.item()
        grads[label] = {k: p.grad for k, p in model.named_parameters()}
    lk, lp = losses["kernels"], losses["plain"]
    if abs(lk - lp) > BF16_LOSS_RTOL * abs(lp) or \
            abs(lk - fp32_loss) > BF16_FP32_LOSS_RTOL * abs(fp32_loss):
        raise AssertionError(f"bf16 loss: kernels {lk}, plain {lp}, fp32 "
                             f"kernels {fp32_loss}")
    rel = {}
    for name, gk in grads["kernels"].items():
        gp = grads["plain"][name]
        if gk is None or gp is None or gk.dtype != torch.float32:
            raise AssertionError(f"{name}: no fp32 gradient ("
                                 f"{None if gk is None else gk.dtype})")
        if gk.norm().item() == 0.0 or gp.norm().item() == 0.0:
            raise AssertionError(f"zero bf16 gradient for {name}")
        rel[name] = rel_l2(gk, gp)
    worst = max(rel, key=rel.get)
    if rel[worst] > BF16_GRAD_REL_L2:
        raise AssertionError(f"bf16 gradient of {worst}: relative L2 "
                             f"{rel[worst]} > {BF16_GRAD_REL_L2}")
    emit({"phase": "train_bf16_grads", "params": len(rel), "loss_kernels": lk,
          "loss_plain": lp, "loss_fp32_kernels": fp32_loss,
          "loss_rel_kernels_plain": abs(lk - lp) / abs(lp),
          "loss_rel_bf16_fp32": abs(lk - fp32_loss) / abs(fp32_loss),
          "worst_param": worst, "worst_rel_l2": rel[worst],
          "median_rel_l2": sorted(rel.values())[len(rel) // 2],
          "loss_rtol": BF16_LOSS_RTOL, "fp32_loss_rtol": BF16_FP32_LOSS_RTOL,
          "grad_rel_l2_limit": BF16_GRAD_REL_L2, "card": card})
    model, crit = models["kernels"]
    del models, grads, step      # the step holds the plain model too
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # (b) optimize() in bf16 from the same weights; (c) its launches, and
    # every call of the plain attention body counted
    ds = array_dataset(x, y) >> SampleToMiniBatch(BATCH)
    opt = optim.Optimizer(model, ds, crit, optim.Adam(learning_rate=1e-4))
    opt.set_end_when(optim.Trigger.max_iteration(TRAIN_ITERS))
    opt.set_compute_dtype(bf16)
    summary = _Losses()
    opt.set_train_summary(summary)
    plain_calls = [0]
    masked_attention = fa.masked_attention

    def counted(*args, **kw):
        plain_calls[0] += 1
        return masked_attention(*args, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ce.reset_launch_counts()
    captures = cuda_graphs.capture_count()
    fa.masked_attention = counted
    try:
        # ---- the bf16 training main path: counts read right after it --
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {f"{k}_{dt}": n for k in fa.BF16_LAUNCHES
                    for dt, n in (("bf16", fa.BF16_LAUNCHES[k]),
                                  ("fp32", fa.LAUNCHES[k]
                                   - fa.BF16_LAUNCHES[k]))}
        launches.update(ce.LAUNCHES, plain_attention_calls=plain_calls[0])
        # -----------------------------------------------------------------
    finally:
        fa.masked_attention = masked_attention
    compiled = dict(opt.compiled_stats,
                    captures=cuda_graphs.capture_count() - captures)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():   # the first batch again, after training
        after = crit.apply(optim.make_eval_step(model, bf16)(xb), yb).item()
    steps = summary.scalars["Loss"]
    tok_s = sorted(r * SEQ for r in summary.scalars["Throughput"][1:])
    fp32_steps = fp32_run["losses"]
    step_rel = [abs(a - b) / abs(b) for a, b in zip(steps, fp32_steps)]
    emit({"phase": "train_bf16_run", "losses": steps,
          "fp32_losses": fp32_steps, "step_rel_to_fp32": step_rel,
          "first_batch_loss_before": lk, "first_batch_loss_after": after,
          "wall_s": wall, "tokens_per_s": TRAIN_ITERS * BATCH * SEQ / wall,
          "step_tokens_per_s_median": tok_s[len(tok_s) // 2],
          "fp32_tokens_per_s": fp32_run["tokens_per_s"],
          "peak_memory_bytes": peak,
          "fp32_peak_memory_bytes": fp32_run["peak_memory_bytes"],
          "captured": compiled["captured"], "replays": compiled["replays"],
          "graph_pool_bytes": compiled["pool_bytes"],
          "warmup_launches": compiled["warmup_launches"],
          "launches": launches, "card": card})
    if compiled["captured"] != 1 or compiled["captures"] != 1 or \
            compiled["replays"] != TRAIN_ITERS:
        raise AssertionError(f"bf16: not one graph replayed every step: "
                             f"{compiled}")
    if len(steps) != TRAIN_ITERS or max(step_rel) > BF16_FP32_LOSS_RTOL:
        raise AssertionError(f"bf16 per-step losses {steps} against fp32 "
                             f"{fp32_steps}")
    if not (after < lk and steps[-1] < steps[0]):
        raise AssertionError(f"the bf16 loss did not fall: {lk} -> {after}, "
                             f"{steps}")
    want = {"flash_attention_bf16": 12 * TRAIN_ITERS,
            "flash_attention_bwd_bf16": 12 * TRAIN_ITERS,
            "flash_attention_fp32": 0, "flash_attention_bwd_fp32": 0,
            "fused_softmax_cross_entropy": TRAIN_ITERS,
            "fused_softmax_cross_entropy_bwd": TRAIN_ITERS,
            "plain_attention_calls": 0}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"bf16 training launches {launches}, want "
                             f"{want}")
    emit({"phase": "train_bf16_check", "max_step_rel_to_fp32": max(step_rel),
          "first_batch_loss": [lk, after], "launches": launches,
          "card": card})
    eager_vs_compiled(x, y, bf16, model, steps, card)      # (a)
    compiled_step_rates(opt, "bf16", card)                 # (b), (d)
    del model, opt
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("flash_attention_bf16",
                                     "flash_attention_bwd_bf16",
                                     "fused_softmax_cross_entropy",
                                     "fused_softmax_cross_entropy_bwd")}


def int8_kernel_phase(fa, card):
    """Phase 8: K3q on int8 pools at phase 3's K3 shapes, against its
    plain version, timed."""
    from bigdl_tpu_torch.ops.quantization import quantize_blockwise

    g = torch.Generator(device="cuda").manual_seed(8)
    dev = "cuda"
    row = None
    b, max_len = 8, 1024
    for bs in (16, 128):
        mb = max_len // bs
        nb = b * mb + 1
        trash = nb - 1
        pools = []
        for _ in range(2):
            x = torch.randn(nb, bs, HEADS, HEAD_DIM, generator=g, device=dev)
            q8, sc = quantize_blockwise(x.reshape(-1), HEAD_DIM,
                                        scale_dtype=torch.float32)
            pools += [q8.reshape(x.shape), sc.reshape(nb, bs, HEADS, 1)]
        k8, ks, v8, vs = pools
        perm = torch.randperm(nb - 1, generator=g, device=dev)
        tables = perm.reshape(b, mb).to(torch.int32)
        pos = torch.randint(0, max_len, (b,), generator=g, device=dev,
                            dtype=torch.int32)
        pos[0] = 0
        used = (pos.long() // bs + 1)[:, None]
        tables = torch.where(torch.arange(mb, device=dev)[None, :] < used,
                             tables, torch.full_like(tables, trash))
        q = torch.randn(b, 1, HEADS, HEAD_DIM, generator=g, device=dev)

        def kernel():
            return fa.flash_paged_decode_attention(q, k8, v8, tables, pos,
                                                   k_scale=ks, v_scale=vs)

        got = kernel()
        want = fa.flash_paged_decode_attention_reference(q, k8, v8, tables,
                                                         pos, ks, vs)
        if got.dtype != torch.float32:
            raise AssertionError(f"K3q wrote {got.dtype}, not fp32")
        err = check_close(f"flash_paged_decode_attention_int8 bs{bs}", got,
                          want)
        ms, lo, hi = device_ms(kernel)
        plain = device_ms(lambda: fa.flash_paged_decode_attention_reference(
            q, k8, v8, tables, pos, ks, vs))[0]
        vis = int((pos.long() + 1).sum())
        # each visible position: an int8 K and V row and their fp32 scales
        n_bytes = 2 * vis * HEADS * (HEAD_DIM + 4) \
            + 2 * b * HEADS * HEAD_DIM * 4 + 4 * b + 4 * int(used.sum())
        bms, by = bound(n_bytes, 4 * vis * HEADS * HEAD_DIM)
        splits = fa.decode_splits(b * HEADS, mb * bs, fa.sm_count(dev))
        # no PyTorch call reads int8 K/V through block tables
        r = dict(name="flash_paged_decode_attention_int8", case=f"B8_bs{bs}",
                 max_abs_err=err, ms=ms, ms_min=lo, ms_max=hi,
                 plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                 visible_positions=vis, splits=splits,
                 cluster=[splits, 1, 1], card=card)
        emit({"phase": "kernel", **r})
        row = row or r
    return {"flash_paged_decode_attention_int8": row}


def pool_bytes_per_block(eng):
    return eng._gen._alloc.stats()["bytes_per_block"]


def tie_check(plain_model, prompt, common, tok_a, tok_c):
    """The logits of the step where two greedy streams part, recomputed
    by the plain model over a fresh int8 pool: the gap between the two
    streams' tokens and each one's distance from the largest logit."""
    seq = np.concatenate([prompt, np.asarray(common, np.int32)])
    n = len(seq)
    bs = 16
    mb = -(-n // bs)
    dev = plain_model.device
    pool = plain_model.init_paged_cache(mb, bs, torch.int8)
    tables = torch.arange(mb, dtype=torch.int32, device=dev)[None]
    with torch.no_grad():
        logits, _ = plain_model.apply_paged(
            torch.as_tensor(seq[None], device=dev), pool, tables,
            pos=torch.zeros(1, dtype=torch.int32, device=dev),
            lengths=torch.tensor([n], dtype=torch.int32, device=dev))
    row = logits[0, -1]
    top = row.max().item()
    return {"gap": abs(row[tok_a].item() - row[tok_c].item()),
            "below_max": max(top - row[tok_a].item(),
                             top - row[tok_c].item())}


def int8_serving_phase(fa, card, model, plain_model, fp32_tok_s):
    """Phase 9: TransformerLM "small" served from int8 KV blocks, by its
    int8 twin, and speculatively, two rounds of phase 4's prompts each,
    as phase 4 (``fp32_tok_s``: its paged engine's tokens/s by round);
    each engine's launches read right after its own bursts."""
    from bigdl_tpu_torch.models import synthetic_corpus
    from bigdl_tpu_torch.nn.quantized import model_bytes
    from bigdl_tpu_torch.ops import act_quant as k6q
    from bigdl_tpu_torch.serving import ServingEngine

    prompts = serving_prompts(1)                  # phase 4's prompts
    prompts_check = serving_prompts(9)            # fresh: no prefix hit
    feats, _ = synthetic_corpus(8, 128, SERVE_VOCAB, seed=5)
    gate = {"features": feats, "min_top1_agreement": GATE_MIN_TOP1_AGREEMENT,
            "max_logit_rmse": GATE_MAX_LOGIT_RMSE}
    kw = dict(decode_slots=8, decode_max_len=1024, kv_block_size=16,
              device=model.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engines = {
        "a_int8_kv": ServingEngine(model, kv_cache_dtype="int8", **kw),
        "b_int8_twin": ServingEngine(model, quantize=True,
                                     accuracy_gate=gate, **kw),
        "c_speculative4_int8_kv": ServingEngine(
            model, speculative=4, kv_cache_dtype="int8", **kw),
    }
    streams, bursts = {}, {}
    launches = {label: collections.Counter() for label in engines}
    try:
        detail = engines["b_int8_twin"]._gate_detail
        emit({"phase": "int8_gate", **detail,
              "max_logit_rmse": GATE_MAX_LOGIT_RMSE,
              "min_top1_agreement": GATE_MIN_TOP1_AGREEMENT, "card": card})
        # the gate bites: half the measured RMSE refuses the same twin
        try:
            ServingEngine(model, quantize=True, **kw, accuracy_gate={
                "features": feats, "min_top1_agreement": None,
                "max_logit_rmse": detail["logit_rmse"] / 2})
        except ValueError as e:
            if "accuracy gate refused" not in str(e):
                raise
        else:
            raise AssertionError("a gate at half the measured RMSE passed")
        # the twins' built steps call K6q at the shapes their path gives it
        quant_shapes, act_quant = [], k6q.act_quant

        def recorded(x):
            quant_shapes.append((tuple(x.shape), x.dtype))
            return act_quant(x)

        k6q.act_quant = recorded
        try:
            built = {label: eng.precompile()
                     for label, eng in engines.items()}
        finally:
            k6q.act_quant = act_quant
        # ---- the int8 serving path, engine by engine ----------------------
        for rnd in (0, 1):
            for label, eng in engines.items():
                fa.reset_launch_counts()
                k6q.reset_launch_counts()
                streams[(label, rnd)], bursts[(label, rnd)] = timed_burst(
                    eng, prompts, SERVE_NEW, label, card,
                    phase="int8_generate", round=rnd,
                    fp32_paged_tokens_per_s=fp32_tok_s[rnd])
                torch.cuda.synchronize()
                launches[label].update(fa.LAUNCHES)
                launches[label].update(k6q.LAUNCHES)
        # -------------------------------------------------------------------
        peak = max(torch.cuda.max_memory_allocated(),
                   *(r["peak_memory_bytes"] for r in bursts.values()))
        tok_s = {k: r["tokens_per_s"] for k, r in bursts.items()}
        spec = engines["c_speculative4_int8_kv"]._gen.stats()["speculative"]
        ratio = pool_bytes_per_block(engines["a_int8_kv"]) \
            / pool_bytes_per_block(engines["b_int8_twin"])
        twin_bytes = engines["b_int8_twin"].serving_model_bytes()
        # not the twin's steps: see check_replays
        step_errs, _ = served_step_errors(
            {k: engines[k] for k in ("a_int8_kv", "c_speculative4_int8_kv")},
            {"a_int8_kv": plain_model, "c_speculative4_int8_kv": plain_model},
            prompts_check, SERVE_NEW)
        for label, eng in engines.items():
            engine_graph_row(label, eng, built[label],
                             [bursts[(label, rnd)] for rnd in (0, 1)],
                             card, prompts_check[0][:8])
    finally:
        for e in engines.values():
            e.close()

    k3q, k3 = "flash_paged_decode_attention_int8", \
        "flash_paged_decode_attention"
    for label in ("a_int8_kv", "c_speculative4_int8_kv"):
        if launches[label][k3q] < 1:
            raise AssertionError(f"{label} never launched K3q: "
                                 f"{launches[label]}")
    if launches["a_int8_kv"][k3]:
        raise AssertionError(f"the int8-KV engine launched K3: "
                             f"{launches['a_int8_kv']}")
    if any(launches["a_int8_kv"][route] for route in k6q.ROUTES) or any(
            launches[label]["act_quant_small"] < 1
            for label in ("b_int8_twin", "c_speculative4_int8_kv")):
        raise AssertionError(f"K6q launches: the twin and the drafter "
                             f"quantize their activations (their small "
                             f"inputs by the small route), the fp32 model "
                             f"never: {launches}")
    # K6q at every input shape of the twins' steps (decode, prefill chunks
    # and drafts; the hidden width and the MLP's), after the counts were
    # read: both routes a random input can take, the small one and the
    # three nodes, each bitwise against the plain version and timed, so
    # the route the size picks on the main path is held at every shape
    g = torch.Generator(device="cuda").manual_seed(9)
    quant_rows = []
    for shape, dtype in dict.fromkeys(quant_shapes):
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        row = act_quant_row(card, x, "int8_serving", "act_quant_small")
        row["main_path_route"] = k6q.select_route(x)[0]
        if row["main_path_route"] not in ("act_quant_small", "act_quant"):
            raise AssertionError(f"K6q {shape}: a random input takes "
                                 f"{row['main_path_route']}")
        quant_rows.append(row)
    small_row = max((r for r in quant_rows
                     if r["main_path_route"] == "act_quant_small"),
                    key=lambda r: r["elements"])
    want_ratio = (HEAD_DIM + 4) / (4 * HEAD_DIM)
    if abs(ratio - want_ratio) > 1e-9:
        raise AssertionError(f"int8/fp32 pool bytes per block {ratio}, "
                             f"want {want_ratio}")
    if not all(len(s) == SERVE_NEW for st in streams.values() for s in st):
        raise AssertionError("an int8 stream stopped short")
    # (a) and (c) stream the fp32 model's own tokens over int8 KV: (c)
    # against (a), and each engine's rounds against each other (round 1
    # prefills after prefix hits, in other chunks); a stream is compared
    # up to where it parts, which only a near-tie may explain.  The twin
    # quantizes its activations per tensor over the whole step, so (b)'s
    # stream moves with what shares a step and is held to no other
    ties = []
    a0 = streams[("a_int8_kv", 0)]
    for label, rnd in (("c_speculative4_int8_kv", 0), ("a_int8_kv", 1),
                       ("c_speculative4_int8_kv", 1)):
        for p, sa, sx in zip(prompts, a0, streams[(label, rnd)]):
            j = next((i for i, (x, y) in enumerate(zip(sa, sx)) if x != y),
                     None)
            if j is None:
                continue
            t = tie_check(plain_model, p, sa[:j], sa[j], sx[j])
            if t["gap"] > TIE_MARGIN or t["below_max"] > TIE_MARGIN:
                raise AssertionError(
                    f"{label} round {rnd} parts from the fp32 model's own "
                    f"int8-KV stream at token {j} with no tie: {t}")
            ties.append({"engine": label, "round": rnd, "index": j, **t})
    emit({"phase": "int8_check", "launches": launches,
          "twin_act_quant_shapes": [r["shape"] for r in quant_rows],
          "twin_act_quant_routes": [r["main_path_route"]
                                    for r in quant_rows],
          "twin_act_quant_bitwise_small_three_node": [
              [r["bitwise_equal_plain"], r["three_node_bitwise_equal_plain"]]
              for r in quant_rows],
          "twin_act_quant_small_ms": [r["ms"] for r in quant_rows],
          "twin_act_quant_three_node_ms": [r["three_node_ms"]
                                           for r in quant_rows],
          "pool_bytes_ratio_int8_fp32": ratio,
          "twin_model_bytes": twin_bytes,
          "fp32_model_bytes": model_bytes(model.parameters_tree()),
          "speculative": spec, "speculative_tie_count": len(ties),
          "speculative_ties": ties,
          "tie_margin": TIE_MARGIN, "max_abs_err_vs_plain": step_errs,
          "tokens_per_s": {f"{label}_round{rnd}": v
                           for (label, rnd), v in tok_s.items()},
          "fp32_paged_tokens_per_s": fp32_tok_s,
          "peak_memory_bytes": peak, "card": card})
    return {k: sum(c[k] for c in launches.values())
            for k in launches["a_int8_kv"]}, small_row


#: phase 10: held-out sequences (another seed of the corpus) validated and
#: predicted at batch 8: three full batches and a ragged one of 5
EVAL_SEQS, EVAL_BATCH = 29, 8
#: phase 10: the compiled eval's Loss against the plain model's eager
#: eval (K1 and K4 against plain attention and the plain cross-entropy,
#: the same weights), relative
EVAL_LOSS_RTOL = 1e-5
#: phase 10 (b)-(c): checkpoints and validations every 4 iterations of an
#: 8-step run; the resumed run's losses, parameters and Plateau factor
#: against the straight run's, relative
CKPT_EVERY, RESUME_RTOL = 4, 1e-6
#: phase 10 (e): L-BFGS's first loss (absolute) and gradient (relative
#: L2) through the kernels against the plain model's
LBFGS_TOL = 1e-4


def _eval_methods(nn, optim, criterion):
    return [optim.Loss(nn.TimeDistributedCriterion(criterion)),
            optim.Top1Accuracy(), optim.Top5Accuracy()]


def _near_tie_violations(out_k, out_p, margin=TIE_MARGIN):
    """Positions where the kernel path's top-1 or top-5 differ from the
    plain path's and the plain logits of the tokens at stake lie further
    apart than ``margin``: a difference is allowed only at a near-tie."""
    bad = 0
    pk, pp = out_k.argmax(-1), out_p.argmax(-1)
    diff = pk != pp
    if bool(diff.any()):
        a = out_p.gather(-1, pk[..., None])[..., 0]
        b = out_p.gather(-1, pp[..., None])[..., 0]
        bad += int(((a - b).abs() > margin)[diff].sum())
    top_k = torch.topk(out_k, 6, dim=-1)
    top_p = torch.topk(out_p, 6, dim=-1)
    # a token in one top-5 and not the other must sit within the margin
    # of the plain path's 5th value
    fifth = top_p.values[..., 4:5]
    in_p = (top_k.indices[..., :5, None] == top_p.indices[..., None, :5]) \
        .any(-1)
    val = out_p.gather(-1, top_k.indices[..., :5])
    bad += int(((~in_p) & ((val - fifth).abs() > margin)).sum())
    in_k = (top_p.indices[..., :5, None] == top_k.indices[..., None, :5]) \
        .any(-1)
    bad += int(((~in_k) & ((top_p.values[..., :5] - fifth).abs() > margin))
               .sum())
    return bad


def eval_validation(fa, ce, card, model, plain_model, dataset, dtype):
    """Phase 10 (a): ``validate`` through the compiled eval step (its
    first pass builds one graph per batch shape, the second replays
    them), counted launches, and each batch held against the plain
    model's eager eval; forward tokens/s compiled and eager."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.optim.local_optimizer import _to_device
    from bigdl_tpu_torch.utils import cuda_graphs

    methods = _eval_methods(nn, optim,
                            nn.FusedSoftmaxCrossEntropyCriterion())
    label = "bf16" if dtype else "fp32"
    captures = cuda_graphs.capture_count()
    t0 = time.perf_counter()
    optim.validate(model, dataset, methods, dtype)          # builds graphs
    torch.cuda.synchronize()
    first_pass_s = time.perf_counter() - t0
    built = cuda_graphs.capture_count() - captures
    fa.reset_launch_counts()
    ce.reset_launch_counts()
    captures = cuda_graphs.capture_count()
    # ---- the eval main path: counts read right after it --------------
    t0 = time.perf_counter()
    results = optim.validate(model, dataset, methods, dtype)
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    launches = {**fa.LAUNCHES, **ce.LAUNCHES}
    bf16_k1 = fa.BF16_LAUNCHES["flash_attention"]
    # -----------------------------------------------------------------
    after = cuda_graphs.capture_count() - captures
    step = optim.compiled_eval_step(model, dtype)
    batches = list(dataset.data(train=False))
    n_batches = len(batches)
    eager = optim.make_eval_step(model, dtype)
    plain_methods = _eval_methods(nn, optim, nn.CrossEntropyCriterion())
    plain_totals, ties = [None] * 3, 0
    rates = {}
    with torch.no_grad():
        for b in batches:
            x = _to_device(b.get_input(), "cuda")
            t = _to_device(b.get_target(), "cuda")
            out_k = step(x)
            out_p = plain_model(x)
            ties += _near_tie_violations(out_k, out_p)
            for i, m in enumerate(plain_methods):
                r = m(out_p, t)
                plain_totals[i] = r if plain_totals[i] is None else \
                    plain_totals[i] + r
            del out_k, out_p
        xs = [_to_device(b.get_input(), "cuda") for b in batches]
        for name, fn in (("compiled", step), ("eager", eager)):
            fn(xs[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x in xs:
                fn(x)
            torch.cuda.synchronize()
            rates[name] = EVAL_SEQS * SEQ / (time.perf_counter() - t0)
    got = {m.name: r.result()[0] for m, r in zip(methods, results)}
    plain = {m.name: r.result()[0] for m, r in zip(plain_methods,
                                                     plain_totals)}
    loss_rel = abs(got["Loss"] - plain["Loss"]) / abs(plain["Loss"])
    stats = step.stats()
    row = {"phase": "eval_validate", "compute_dtype": label,
           "results": got, "plain_results": plain,
           "loss_rel_to_plain": loss_rel,
           "counts": {m.name: r.numerator for m, r in zip(methods, results)},
           "plain_counts": {m.name: r.numerator
                            for m, r in zip(plain_methods, plain_totals)},
           "near_tie_violations": ties, "graphs_built": built,
           "graphs_built_after_first_pass": after, "replays":
           stats["replays"], "eval_pool_bytes": stats["pool_bytes"],
           "first_pass_s": first_pass_s, "validation_pass_s": pass_s,
           "batches": n_batches,
           "eval_tokens_per_s": rates, "launches": launches,
           "flash_attention_bf16": bf16_k1, "card": card}
    emit(row)
    k1 = "flash_attention"
    want = {k1: 12 * n_batches, "fused_softmax_cross_entropy": n_batches,
            "flash_attention_bwd": 0, "fused_softmax_cross_entropy_bwd": 0}
    tol = BF16_FP32_LOSS_RTOL if dtype else EVAL_LOSS_RTOL
    if built != 2 or after or any(launches[k] != n for k, n in want.items()) \
            or bf16_k1 != (12 * n_batches if dtype else 0) or \
            loss_rel > tol or (not dtype and ties):
        raise AssertionError(f"eval path ({label}): {row}")
    return row


class _FailOnce:
    """A training dataset whose ``at``-th fetched batch raises, once
    (a fault the retry loop must survive)."""

    def __init__(self, base, at):
        self.base, self.at, self.fetched, self.failed = base, at, 0, False

    def size(self):
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()

    def position_state(self):
        return self.base.position_state()

    def restore_position(self, state):
        self.base.restore_position(state)

    def data(self, train):
        it = self.base.data(train)

        def gen():
            for b in it:
                if train:
                    self.fetched += 1
                    if not self.failed and self.fetched == self.at:
                        self.failed = True
                        raise RuntimeError("injected fault: batch fetch")
                yield b
        return gen()


def _sgd_plateau(optim):
    return optim.SGD(learning_rate=1e-4, momentum=0.9,
                     learning_rate_schedule=optim.Plateau(monitor="Loss",
                                                          patience=1))


def _checkpoint_run(fa, ce, model, dataset, val_ds, ckpt, resume_from=None):
    """One run of phase 10 (b)/(c): 8 iterations of SGD(momentum) under
    Plateau, validation and a checkpoint every 4; returns the optimizer,
    per-step losses by iteration, the Plateau feeds, the checkpoint
    writes, the launches and the times (the run's wall; for a resume,
    resolving and unpickling the snapshot, and copying it in place)."""
    from bigdl_tpu_torch import nn, optim

    crit = nn.TimeDistributedCriterion(nn.FusedSoftmaxCrossEntropyCriterion())
    opt = optim.Optimizer(model, dataset, crit, _sgd_plateau(optim))
    opt.set_end_when(optim.Trigger.max_iteration(TRAIN_ITERS))
    opt.set_validation(optim.Trigger.several_iteration(CKPT_EVERY), val_ds,
                       _eval_methods(nn, optim,
                                     nn.FusedSoftmaxCrossEntropyCriterion()))
    opt.set_checkpoint(str(ckpt), optim.Trigger.several_iteration(CKPT_EVERY))
    feeds, writes, losses, times = [], [], {}, {}
    if resume_from is not None:
        t0 = time.perf_counter()
        opt.resume_from_checkpoint(str(resume_from))
        times["resolve_and_load_s"] = time.perf_counter() - t0
        load = opt._load_snapshot

        def timed_load(snap, opt_state):
            t0 = time.perf_counter()
            load(snap, opt_state)
            torch.cuda.synchronize()
            times["copy_in_place_s"] = time.perf_counter() - t0

        opt._load_snapshot = timed_load

    class _Summary:
        def add_scalar(self, tag, value, step):
            if tag == "Loss":
                losses[step] = value

    opt.set_train_summary(_Summary())
    feed, write = opt._feed_plateau, opt._checkpoint

    def fed(state, opt_state):
        out = feed(state, opt_state)
        feeds.append({"neval": state["neval"], "Loss": state.get("Loss"),
                      "lr_factor": float(opt_state["lr_factor"])})
        return out

    def timed(opt_state):
        t0 = time.perf_counter()
        path = write(opt_state)
        writes.append((path, time.perf_counter() - t0))
        return path

    opt._feed_plateau, opt._checkpoint = fed, timed
    fa.reset_launch_counts()
    ce.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    times["wall_s"] = time.perf_counter() - t0
    return opt, losses, feeds, writes, {**fa.LAUNCHES, **ce.LAUNCHES}, times


def checkpoint_phase(fa, ce, card, x, y, val_ds):
    """Phase 10 (b)-(c): the straight run with validation, Plateau's feed
    and checkpoints; a fresh model and optimizer resumed from the first
    checkpoint; and a run whose dataset raises once, which the retry
    loop restores from its checkpoint.  Returns the resumed run's
    launches."""
    import shutil
    import tempfile

    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.models import transformer_lm
    from bigdl_tpu_torch.utils import file_io

    def ds():
        return array_dataset(x, y) >> SampleToMiniBatch(BATCH)

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        model = transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                               seed=0)
        straight, s_losses, s_feeds, s_writes, s_launch, s_times = \
            _checkpoint_run(fa, ce, model, ds(), val_ds, root / "straight")
        names = sorted(Path(p).name for p, _ in s_writes)
        want_names = [f"checkpoint.{n}.pkl" for n in
                      range(CKPT_EVERY, TRAIN_ITERS + 1, CKPT_EVERY)]
        ckpts = []
        for path, write_s in s_writes:
            t0 = time.perf_counter()
            reason = file_io.verify_snapshot(path)
            ckpts.append({"name": Path(path).name,
                          "bytes": file_io.getsize(path),
                          "write_s": write_s,
                          "verify_s": time.perf_counter() - t0,
                          "verified": reason is None})
        # the eval graph reads the weights training left: its Loss now
        # equals an eager eval's on them
        from bigdl_tpu_torch import nn
        from bigdl_tpu_torch.optim.local_optimizer import _to_device
        vb = next(val_ds.data(train=False))
        crit = nn.TimeDistributedCriterion(
            nn.FusedSoftmaxCrossEntropyCriterion())
        with torch.no_grad():
            xv = _to_device(vb.get_input(), "cuda")
            yv = _to_device(vb.get_target(), "cuda")
            graph_loss = crit.apply(optim.compiled_eval_step(model)(xv),
                                    yv).item()
            eager_loss = crit.apply(optim.make_eval_step(model)(xv),
                                    yv).item()
        row = {"phase": "ckpt_straight", "losses": s_losses,
               "plateau_feeds": s_feeds, "checkpoints": ckpts,
               "eval_graph_after_training_loss": graph_loss,
               "eager_loss_same_weights": eager_loss,
               "wall_s": s_times["wall_s"],
               "train_pool_bytes": straight.compiled_stats["pool_bytes"],
               "eval_pool_bytes": optim.compiled_eval_step(model).stats()[
                   "pool_bytes"],
               "launches": s_launch, "card": card}
        emit(row)
        if names != want_names or not all(c["verified"] for c in ckpts) or \
                len(s_feeds) != TRAIN_ITERS // CKPT_EVERY or \
                abs(graph_loss - eager_loss) > RESUME_RTOL * abs(eager_loss):
            raise AssertionError(f"straight run: {row}")

        # (c) resume: a fresh model (other weights) and optimizer from the
        # first checkpoint alone
        first = root / "first"
        first.mkdir()
        for suffix in ("", file_io.MANIFEST_SUFFIX):
            shutil.copy(root / "straight" / (want_names[0] + suffix), first)
        fresh = transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                               seed=1)
        t0 = time.perf_counter()
        resumed, r_losses, r_feeds, _, r_launch, r_times = _checkpoint_run(
            fa, ce, fresh, ds(), val_ds, root / "resumed", resume_from=first)
        resume_s = time.perf_counter() - t0
        # (c) the retry loop, from the straight run's weights: the 6th
        # batch's fetch raises once
        flaky = _FailOnce(ds(), at=6)
        retried_model = transformer_lm("small", VOCAB, max_len=SEQ,
                                       device="cuda", seed=0)
        retried, t_losses, _, t_writes, t_launch, _ = _checkpoint_run(
            fa, ce, retried_model, flaky, val_ds, root / "retry")

        def against(run_model, run_losses, run_opt):
            steps = sorted(run_losses)
            loss_rel = max(abs(run_losses[s] - s_losses[s]) /
                           abs(s_losses[s]) for s in steps)
            rel, bitwise = {}, all(run_losses[s] == s_losses[s]
                                   for s in steps)
            with torch.no_grad():
                for (k, a), (_, b) in zip(run_model.named_parameters(),
                                          model.named_parameters()):
                    rel[k] = rel_l2(a, b)
                    bitwise = bitwise and torch.equal(a, b)
            fa_ = float(run_opt.optim_method.state["lr_factor"])
            fb = float(straight.optim_method.state["lr_factor"])
            worst = max(rel, key=rel.get)
            return {"steps": steps, "max_step_loss_rel": loss_rel,
                    "worst_param": worst, "worst_param_rel_l2": rel[worst],
                    "lr_factor": [fa_, fb], "bitwise_equal": bitwise,
                    "neval": run_opt.driver_state["neval"]}

        res = against(fresh, r_losses, resumed)
        ret = against(retried_model, t_losses, retried)
        row = {"phase": "ckpt_resume", "resumed": res,
               "resume_wall_s": resume_s, "resume_times": r_times,
               "plateau_feeds": r_feeds,
               "retried": ret, "retry_fetches": flaky.fetched,
               "retry_checkpoints": [Path(p).name for p, _ in t_writes],
               "launches_resumed": r_launch, "launches_retried": t_launch,
               "card": card}
        emit(row)
        for r, first_step in ((res, CKPT_EVERY), (ret, 1)):
            if r["steps"] != list(range(first_step, TRAIN_ITERS + 1)) or \
                    r["max_step_loss_rel"] > RESUME_RTOL or \
                    r["worst_param_rel_l2"] > RESUME_RTOL or \
                    r["lr_factor"][0] != r["lr_factor"][1] or \
                    r["neval"] != TRAIN_ITERS + 1:
                raise AssertionError(f"resume: {row}")
        if not flaky.failed:
            raise AssertionError("the injected fault never fired")
        steps_resumed = TRAIN_ITERS - CKPT_EVERY + 1
        want = {"flash_attention": 12 * steps_resumed,
                "flash_attention_bwd": 12 * steps_resumed,
                "fused_softmax_cross_entropy": steps_resumed,
                "fused_softmax_cross_entropy_bwd": steps_resumed}
        # the resumed run validates once (4 batches): K1 12 and K4 1 a batch
        n_val = EVAL_SEQS // EVAL_BATCH + 1
        want["flash_attention"] += 12 * n_val
        want["fused_softmax_cross_entropy"] += n_val
        if any(r_launch[k] != n for k, n in want.items()):
            raise AssertionError(f"resumed run launches {r_launch}, want "
                                 f"{want}")
        del straight, resumed, retried, fresh, retried_model, model
        return {k: r_launch[k] for k in want}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def predict_phase(fa, card, model, xv):
    """Phase 10 (d): ``Predictor(batch_size=8)`` over the held-out
    sequences through the model's compiled eval step (the ragged tail
    padded to 8: no new graph), each batch's rows against the step's own
    output on the unpadded batch, and the host's launch calls a batch."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.utils import cuda_graphs

    step = optim.compiled_eval_step(model)
    graphs = step.executables()
    n_batches = -(-EVAL_SEQS // EVAL_BATCH)
    captures = cuda_graphs.capture_count()
    pred = optim.Predictor(model, batch_size=EVAL_BATCH)
    t0 = time.perf_counter()
    rows = pred.predict(list(xv))
    wall = time.perf_counter() - t0
    built = cuda_graphs.capture_count() - captures
    err = 0.0
    with torch.no_grad():
        for i in range(0, EVAL_SEQS, EVAL_BATCH):
            want = step(torch.as_tensor(xv[i:i + EVAL_BATCH], device="cuda"))
            got = torch.as_tensor(np.stack(rows[i:i + EVAL_BATCH]),
                                  device="cuda")
            err = max(err, check_close("predict", got, want))
    del rows
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pred.predict(list(xv))
        torch.cuda.synchronize()
    calls = collections.Counter(
        e.name for e in prof.events()
        if e.name in LAUNCH_CALLS or e.name.startswith("cudaMemcpy"))
    # predict_minibatch returns a copy of the graph's static output: two
    # results of one shape, the first kept after the second call; the
    # copy's time (CUDA events around one clone of the B8 logits)
    from bigdl_tpu_torch.dataset import MiniBatch
    from bigdl_tpu_torch.optim.validation import _tree_clone

    first = pred.predict_minibatch(MiniBatch(xv[:EVAL_BATCH]))
    second = pred.predict_minibatch(MiniBatch(xv[EVAL_BATCH:2 * EVAL_BATCH]))
    static = step(torch.as_tensor(xv[:EVAL_BATCH], device="cuda"))
    kept = torch.equal(first, static) and not torch.equal(first, second)
    clone_ms = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        copy = _tree_clone(static)
        end.record()
        end.synchronize()
        clone_ms.append(start.elapsed_time(end))
        del copy
    clone_ms.sort()
    row = {"phase": "predict", "sequences": EVAL_SEQS,
           "wall_s_per_batch": wall / n_batches, "graphs_built": built,
           "graphs": [graphs, step.executables()], "max_abs_err": err,
           "host_calls_per_batch": {n: c / n_batches
                                    for n, c in calls.items()},
           "minibatch_results_kept": kept,
           "minibatch_copy_bytes": static.numel() * static.element_size(),
           "minibatch_copy_ms": clone_ms[len(clone_ms) // 2],
           "minibatch_copy_ms_range": [clone_ms[0], clone_ms[-1]],
           "card": card}
    emit(row)
    del first, second, static
    if not kept or built or calls.get("cudaGraphLaunch", 0) != n_batches \
            or any(calls.get(n, 0) for n in LAUNCH_CALLS
                   if n != "cudaGraphLaunch"):
        raise AssertionError(f"predict: {row}")
    return row


def lbfgs_phase(fa, ce, card, x, y):
    """Phase 10 (e): ``LBFGS(max_iter=3, n_correction=4)`` on the flat
    parameters of "small", ``feval`` one forward and backward through the
    kernels on the first batch; its first loss and gradient against the
    plain model's ``feval`` at the same point, the loss falling, the
    history's bytes and the kernels' launches."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models import transformer_lm

    xb = torch.as_tensor(x[:BATCH], device="cuda")
    yb = torch.as_tensor(y[:BATCH], device="cuda")

    def make_feval(model, crit, count):
        params = list(model.parameters())
        sizes = [p.numel() for p in params]

        def feval(flat):
            with torch.no_grad():
                torch._foreach_copy_(params, [s.view(p.shape) for s, p in zip(
                    torch.split(flat, sizes), params)])
            model.zero_grad(set_to_none=True)
            loss = crit.apply(model(xb), yb)
            loss.backward()
            count[0] += 1
            g = torch.cat([p.grad.reshape(-1) for p in params])
            model.zero_grad(set_to_none=True)
            return loss.detach(), g
        return feval, params

    kmodel = transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                            seed=0)
    pmodel = transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                            seed=0, use_flash="never")
    kc, pc = [0], [0]
    kfeval, kparams = make_feval(kmodel, nn.TimeDistributedCriterion(
        nn.FusedSoftmaxCrossEntropyCriterion()), kc)
    pfeval, _ = make_feval(pmodel, nn.TimeDistributedCriterion(
        nn.CrossEntropyCriterion()), pc)
    x0 = torch.cat([p.detach().reshape(-1) for p in kparams])
    fp, gp = pfeval(x0)
    fp = fp.item()
    del pmodel, pfeval
    torch.cuda.empty_cache()
    lbfgs = optim.LBFGS(max_iter=3, n_correction=4)
    first = {}

    def kernels_feval(flat):
        f, g = kfeval(flat)
        if not first:
            first["f"], first["g_rel_l2"] = f.item(), rel_l2(g, gp)
        return f, g

    fa.reset_launch_counts()
    ce.reset_launch_counts()
    t0 = time.perf_counter()
    # ---- the L-BFGS main path: counts read right after it ----------
    _, hist = lbfgs.optimize(kernels_feval, x0)
    torch.cuda.synchronize()
    launches = {**fa.LAUNCHES, **ce.LAUNCHES}
    # -----------------------------------------------------------------
    wall = time.perf_counter() - t0
    row = {"phase": "lbfgs", "f_history": hist, "fevals": kc[0],
           "first_f": first["f"], "plain_first_f": fp,
           "first_g_rel_l2_to_plain": first["g_rel_l2"],
           "history_bytes": lbfgs.history_bytes(),
           "params": x0.numel(), "wall_s": wall, "launches": launches,
           "card": card}
    emit(row)
    want = {"flash_attention": 12 * kc[0], "flash_attention_bwd": 12 * kc[0],
            "fused_softmax_cross_entropy": kc[0],
            "fused_softmax_cross_entropy_bwd": kc[0]}
    if abs(first["f"] - fp) > LBFGS_TOL or first["g_rel_l2"] > LBFGS_TOL or \
            not hist[-1] < hist[0] or \
            any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"L-BFGS: {row}")
    del kmodel, lbfgs, gp, x0
    torch.cuda.empty_cache()
    return {k: launches[k] for k in want}


def eval_phase(fa, ce, card):
    """Phase 10: TransformerLM "small" (seed 0) evaluated, trained with
    validation and checkpoints, resumed, predicted and minimised by
    L-BFGS.  Returns each part's launches by the kernels line's names."""
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.models import synthetic_corpus, transformer_lm

    x, y = synthetic_corpus(64, SEQ, VOCAB)
    xv, yv = synthetic_corpus(EVAL_SEQS, SEQ, VOCAB, seed=1)
    val_ds = array_dataset(xv, yv, shuffle_on_epoch=False) >> \
        SampleToMiniBatch(EVAL_BATCH, drop_remainder=False)
    model = transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                           seed=0)
    plain_model = transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                                 seed=0, use_flash="never")
    paths = {}
    fp32 = eval_validation(fa, ce, card, model, plain_model, val_ds, None)
    bf16 = eval_validation(fa, ce, card, model, plain_model, val_ds,
                           torch.bfloat16)
    paths["eval"] = {"flash_attention": fp32["launches"]["flash_attention"],
                     "fused_softmax_cross_entropy":
                     fp32["launches"]["fused_softmax_cross_entropy"]}
    paths["eval_bf16"] = {
        "flash_attention_bf16": bf16["flash_attention_bf16"],
        "fused_softmax_cross_entropy":
        bf16["launches"]["fused_softmax_cross_entropy"]}
    predict_phase(fa, card, model, xv)
    del model, plain_model
    torch.cuda.empty_cache()
    paths["resume"] = checkpoint_phase(fa, ce, card, x, y, val_ds)
    torch.cuda.empty_cache()
    paths["lbfgs"] = lbfgs_phase(fa, ce, card, x, y)
    return paths


# --------------------------------------------------------------------------- #
# Phase 11: TransformerLM "large" (head_dim 96), scanned and rematerialised
# --------------------------------------------------------------------------- #

#: "large": 1536 wide, 16 heads of 96, 36 layers, at the training shape
LARGE_HEADS, LARGE_HEAD_DIM, LARGE_LAYERS = 16, 96, 36
LARGE_STEPS = 4
#: (a)'s first loss through the kernels against plain attention, relative
LARGE_LOSS_RTOL = 1e-4
#: (d)'s per-step losses (bf16, unrolled, no remat) against (b)'s
LARGE_BF16_LAYOUT_RTOL = 1e-4
LARGE_PROMPTS, LARGE_NEW = 4, 16


def large_kernel_rows(fa, card):
    """Phase 11's kernel rows: K1 and K1-bwd at B8 T1024 (fp32 and bf16),
    K2 at B9 T1024, K3 and K3q at B8 bs16, all at H 16 D 96 ("large"),
    each against its plain version, timed beside its bound and library
    call.  Returns the rows by the kernels line's names."""
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops.quantization import quantize_blockwise

    h, d = LARGE_HEADS, LARGE_HEAD_DIM
    g = torch.Generator(device="cuda").manual_seed(11)
    dev = "cuda"
    rows = {}

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def keep(name, row):
        row = dict(name=name, head_dim=d, heads=h, card=card, **row)
        emit({"phase": "kernel_d96", **row})
        rows[name] = row

    for dtype in (torch.float32, torch.bfloat16):
        tag = "_bf16" if dtype == torch.bfloat16 else ""
        tol = BF16_TOL if tag else ATOL
        b, t = BATCH, SEQ
        qkv = rand(b, t, 3 * h * d).to(dtype)
        q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, -1))
        got = fa.flash_attention(q, k, v, causal=True)
        err = check_close(f"flash_attention d96{tag}", got,
                          fa.flash_attention_reference(q, k, v, True),
                          tol, tol)
        ms, lo, hi = device_ms(lambda: fa.flash_attention(q, k, v, True))
        plain = device_ms(lambda: fa.flash_attention_reference(
            q, k, v, True))[0]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))[0]
        n = b * t * h * d
        bms, by = bound(4 * n * q.element_size(),
                        4 * b * h * d * t * (t + 1) / 2,
                        *tensor_core_rate(dtype))
        keep(f"flash_attention{tag}_d96",
             dict(case=f"causal_B{b}_T{t}", dtype=str(dtype),
                  max_abs_err=err, ms=ms, ms_min=lo, ms_max=hi,
                  plain_ms=plain, bound_ms=bms, bound_by=by,
                  library_ms=lib))
        do = rand(b, t, h, d).to(dtype)
        out, lse = fa._flash_forward(q, k, v, True, with_lse=True)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
        want = fa.flash_attention_bwd_reference(q, k, v, do, True)
        err = max(check_close(f"flash_attention_bwd d96{tag} d{w}", x, y,
                              tol, tol) for w, x, y in zip("qkv", got, want))
        del got, want
        ms, lo, hi = device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, True))
        leaves = [z.detach().requires_grad_(True) for z in (q, k, v)]
        plain, _ = backward_ms(fa.flash_attention_reference(*leaves, True),
                               leaves, do)
        tr = [z.detach().transpose(1, 2).requires_grad_(True)
              for z in (q, k, v)]
        lib, _ = backward_ms(F.scaled_dot_product_attention(
            *tr, is_causal=True), tr, do.transpose(1, 2))
        del leaves, tr
        bms, by = bound(8 * n * q.element_size() + b * h * t * 4,
                        10 * b * h * d * t * (t + 1) / 2,
                        *tensor_core_rate(dtype))
        keep(f"flash_attention_bwd{tag}_d96",
             dict(case=f"causal_B{b}_T{t}", dtype=str(dtype),
                  max_abs_err=err, ms=ms, ms_min=lo, ms_max=hi,
                  plain_ms=plain, bound_ms=bms, bound_by=by,
                  library_ms=lib))
        del qkv, q, k, v, do, out, lse
        torch.cuda.empty_cache()

    sms = fa.sm_count(dev)
    row_bytes = h * d * 4
    # K2: 8 slots and the trash row against a 1024-position cache
    b, t = 9, 1024
    q = rand(b, 1, h, d)
    k, v = rand(b, t, h, d), rand(b, t, h, d)
    pos = torch.randint(0, t, (b,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[0], pos[1] = 0, t - 1
    err = check_close("flash_decode_attention d96",
                      fa.flash_decode_attention(q, k, v, pos),
                      fa.flash_decode_attention_reference(q, k, v, pos))
    ms, lo, hi = device_ms(lambda: fa.flash_decode_attention(q, k, v, pos))
    plain = device_ms(lambda: fa.flash_decode_attention_reference(
        q, k, v, pos))[0]
    mask = (torch.arange(t, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))[0]
    vis = int((pos.long() + 1).clamp(max=t).sum())
    bms, by = bound(2 * vis * row_bytes + 2 * b * row_bytes + 4 * b,
                    4 * vis * h * d)
    keep("flash_decode_attention_d96",
         dict(case="B9_T1024", max_abs_err=err, ms=ms, ms_min=lo, ms_max=hi,
              plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
              splits=fa.decode_splits(b * h, t, sms)))

    # K3 and K3q: 8 rows through shuffled tables of 16-position blocks
    b, bs, max_len = 8, 16, 1024
    mb = max_len // bs
    nb = b * mb + 1
    perm = torch.randperm(nb - 1, generator=g, device=dev)
    tables = perm.reshape(b, mb).to(torch.int32)
    pos = torch.randint(0, max_len, (b,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[0] = 0
    used = (pos.long() // bs + 1)[:, None]
    tables = torch.where(torch.arange(mb, device=dev)[None, :] < used,
                         tables, torch.full_like(tables, nb - 1))
    q = rand(b, 1, h, d)
    kp, vp = rand(nb, bs, h, d), rand(nb, bs, h, d)
    vis = int((pos.long() + 1).sum())
    splits = fa.decode_splits(b * h, mb * bs, sms)
    for quant in (False, True):
        if quant:
            pools = []
            for x in (kp, vp):
                q8, sc = quantize_blockwise(x.reshape(-1), d,
                                            scale_dtype=torch.float32)
                pools += [q8.reshape(x.shape), sc.reshape(nb, bs, h, 1)]
            k8, ks, v8, vs = pools
            args = (q, k8, v8, tables, pos)
            kw = dict(k_scale=ks, v_scale=vs)
            name = "flash_paged_decode_attention_int8_d96"
            n_bytes = 2 * vis * h * (d + 4)
        else:
            args, kw = (q, kp, vp, tables, pos), {}
            name = "flash_paged_decode_attention_d96"
            n_bytes = 2 * vis * row_bytes
        err = check_close(name, fa.flash_paged_decode_attention(*args, **kw),
                          fa.flash_paged_decode_attention_reference(
                              *args, *kw.values()))
        ms, lo, hi = device_ms(lambda: fa.flash_paged_decode_attention(
            *args, **kw))
        plain = device_ms(lambda: fa.flash_paged_decode_attention_reference(
            *args, *kw.values()))[0]
        bms, by = bound(n_bytes + 2 * b * row_bytes + 4 * b
                        + 4 * int(used.sum()), 4 * vis * h * d)
        # no PyTorch call reads (int8) K/V through block tables
        keep(name, dict(case="B8_bs16", max_abs_err=err, ms=ms, ms_min=lo,
                        ms_max=hi, plain_ms=plain, bound_ms=bms,
                        bound_by=by, library_ms=None, splits=splits))
    torch.cuda.empty_cache()
    return rows


def _restore(model, saved):
    """Copy ``saved`` (name -> host tensor) into ``model``'s parameters."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(saved[name], non_blocking=True)
    torch.cuda.synchronize()


def large_leg(fa, ce, card, label, model, x, y, dtype):
    """One ``optimize()`` of ``LARGE_STEPS`` steps of "large" with Adam
    from the model's current weights: per-step losses, tokens/s over the
    steps after the first (its warm-up and capture), peak allocated and
    reserved memory, the graph pool, and K1's and K1-bwd's launches a
    step counted through the replays (in ``dtype``'s count table)."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset

    ds = array_dataset(x, y, shuffle_on_epoch=False) >> \
        SampleToMiniBatch(BATCH)
    opt = optim.Optimizer(model, ds, nn.TimeDistributedCriterion(
        nn.FusedSoftmaxCrossEntropyCriterion()),
        optim.Adam(learning_rate=1e-4))
    if dtype is not None:
        opt.set_compute_dtype(dtype)
    summary = _Losses()
    opt.set_train_summary(summary)
    clock = StepClock(opt, LARGE_STEPS, sync_at=(1, LARGE_STEPS))
    opt.set_end_when(clock)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ce.reset_launch_counts()
    # ---- the main path: counts read right after it ------------------------
    opt.optimize()
    torch.cuda.synchronize()
    launches = {**fa.LAUNCHES, **ce.LAUNCHES}
    bf16 = dict(fa.BF16_LAUNCHES)
    # ---------------------------------------------------------------------
    steps = LARGE_STEPS - 1
    wall = (clock.marks[LARGE_STEPS][0] - clock.marks[1][0]) / steps
    table = bf16 if dtype == torch.bfloat16 else launches
    row = {"phase": "large_leg", "leg": label,
           "compute_dtype": "bf16" if dtype else "fp32",
           "layout": "scanned" if model.scan is not None else "unrolled",
           "remat_policy": model.remat_policy,
           "losses": summary.scalars["Loss"], "step_s": wall,
           "tokens_per_s": BATCH * SEQ / wall,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "graph_pool_bytes": opt.compiled_stats["pool_bytes"],
           "captured": opt.compiled_stats["captured"],
           "replays": opt.compiled_stats["replays"],
           "k1_per_step": table["flash_attention"] / LARGE_STEPS,
           "k1_bwd_per_step": table["flash_attention_bwd"] / LARGE_STEPS,
           "launches": launches, "bf16_launches": bf16, "card": card}
    emit(row)
    remat = model.scan is not None or model.remat_policy is not None
    want_k1 = 2 * LARGE_LAYERS if remat and \
        model.remat_policy != "everything_saveable" else LARGE_LAYERS
    if len(row["losses"]) != LARGE_STEPS or row["captured"] != 1 or \
            row["replays"] != LARGE_STEPS or \
            row["k1_per_step"] != want_k1 or \
            row["k1_bwd_per_step"] != LARGE_LAYERS or \
            not all(np.isfinite(row["losses"])):
        raise AssertionError(f"large leg {label}: {row}")
    del opt
    torch.cuda.empty_cache()
    return row


def large_serving(fa, card, scanned, unrolled):
    """Phase 11's serving: 4 prompts of 16 new tokens through the fp32
    paged engine by the scanned model and by the unrolled one (the same
    weights): equal greedy streams, K3 launched at D 96; then the scanned
    model through the contiguous engine (K2) and the int8-KV engine
    (K3q).  Returns the launches by the kernels line's names."""
    from bigdl_tpu_torch.models import synthetic_corpus
    from bigdl_tpu_torch.serving import ServingEngine

    toks, _ = synthetic_corpus(LARGE_PROMPTS, 200, VOCAB, seed=5)
    prompts = [toks[i, :n] for i, n in
               enumerate(np.linspace(17, 200, LARGE_PROMPTS).astype(int))]
    runs, counts = {}, {}
    for label, model, kw in (
            ("paged_scanned", scanned, {}),
            ("paged_unrolled", unrolled, {}),
            ("contiguous_scanned", scanned, {"kv_cache": "contiguous"}),
            ("int8_kv_scanned", scanned, {"kv_cache_dtype": "int8"})):
        with ServingEngine(model, decode_slots=LARGE_PROMPTS,
                           decode_max_len=256, **kw) as eng:
            fa.reset_launch_counts()
            out, row = timed_burst(eng, prompts, LARGE_NEW, label, card,
                                   phase="large_generate")
            torch.cuda.synchronize()
            counts[label] = dict(fa.LAUNCHES)
        bad = [s for s in out if len(s) != LARGE_NEW
               or not all(0 <= t < VOCAB for t in s)]
        if bad:
            raise AssertionError(f"{label}: malformed streams {out}")
        runs[label] = out
    same = runs["paged_scanned"] == runs["paged_unrolled"]
    emit({"phase": "large_serving_check",
          "scanned_equals_unrolled": same,
          "contiguous_equals_paged":
          runs["contiguous_scanned"] == runs["paged_scanned"],
          "launches": counts, "card": card})
    if not same:
        raise AssertionError(f"scanned and unrolled greedy streams differ: "
                             f"{runs}")
    need = {"paged_scanned": "flash_paged_decode_attention",
            "paged_unrolled": "flash_paged_decode_attention",
            "contiguous_scanned": "flash_decode_attention",
            "int8_kv_scanned": "flash_paged_decode_attention_int8"}
    if any(not counts[k].get(n) for k, n in need.items()):
        raise AssertionError(f"a decode kernel was not launched: {counts}")
    return {"flash_attention_d96": sum(c["flash_attention"]
                                       for c in counts.values()),
            "flash_paged_decode_attention_d96":
            counts["paged_scanned"]["flash_paged_decode_attention"]
            + counts["paged_unrolled"]["flash_paged_decode_attention"],
            "flash_decode_attention_d96":
            counts["contiguous_scanned"]["flash_decode_attention"],
            "flash_paged_decode_attention_int8_d96":
            counts["int8_kv_scanned"]["flash_paged_decode_attention_int8"]}


def large_phase(fa, ce, card):
    """Phase 11: TransformerLM "large" (1536 wide, 16 heads of 96, 36
    layers, vocab 32000, seed 0) at B8 x T1024: (a) fp32 scanned (the
    recipe's default, every layer rematerialised), its first loss against
    plain attention on the same weights and its compiled steps against
    eager ones; (b) bf16 scanned, policy unset; (c) bf16 scanned under
    ``dots_saveable``, losses bitwise (b)'s; (d) bf16 unrolled without
    remat, losses within ``LARGE_BF16_LAYOUT_RTOL`` of (b)'s; then
    serving.  Returns the main path's launches by the kernels line's
    names."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.interop import load_jax_params, to_jax_params
    from bigdl_tpu_torch.models import synthetic_corpus, transformer_lm

    x, y = synthetic_corpus(BATCH * LARGE_STEPS, SEQ, VOCAB, seed=11)
    t0 = time.perf_counter()
    model = transformer_lm("large", VOCAB, max_len=SEQ, device="cuda",
                           seed=0)
    init = {k: p.detach().cpu() for k, p in model.named_parameters()}
    emit({"phase": "large_setup", "layout": "scanned",
          "params": sum(p.numel() for p in model.parameters()),
          "stacked_leaves": sum(1 for k, _ in model.named_parameters()
                                if k.startswith("blocks.")),
          "init_s": time.perf_counter() - t0, "card": card})
    if model.scan is None or model.blocks[0].attn.head_dim != 96:
        raise AssertionError("'large' is not the scanned, head_dim 96 model")

    # (a) the first batch's loss through the kernels and through plain
    # attention (the layers' shared attention module switched), no grad
    crit = nn.TimeDistributedCriterion(nn.FusedSoftmaxCrossEntropyCriterion())
    xb = torch.as_tensor(x[:BATCH], device="cuda")
    yb = torch.as_tensor(y[:BATCH], device="cuda")
    first = {}
    with torch.no_grad():
        for use in ("never", "auto"):
            model.blocks[0].attn.use_flash = use
            first[use] = crit.apply(model(xb), yb).item()
    rel = abs(first["auto"] - first["never"]) / abs(first["never"])
    emit({"phase": "large_first_loss", "kernels": first["auto"],
          "plain_attention": first["never"], "rel": rel,
          "tolerance": LARGE_LOSS_RTOL, "card": card})
    if rel > LARGE_LOSS_RTOL:
        raise AssertionError(f"large first loss: {first}")

    paths = {}
    legs = {"a": large_leg(fa, ce, card, "a_fp32_scanned", model, x, y,
                           None)}
    if abs(legs["a"]["losses"][0] - first["auto"]) > \
            LARGE_LOSS_RTOL * abs(first["auto"]):
        raise AssertionError(f"the compiled step's first loss "
                             f"{legs['a']['losses'][0]} against {first}")
    paths["large_fp32"] = {
        "flash_attention_d96": legs["a"]["launches"]["flash_attention"],
        "flash_attention_bwd_d96": legs["a"]["launches"]
        ["flash_attention_bwd"]}
    # (a) the same 4 batches through the eager step from the same weights
    trained = {k: p.detach().clone() for k, p in model.named_parameters()}
    _restore(model, init)
    adam = optim.Adam(learning_rate=1e-4)
    state = adam.init_state(dict(model.named_parameters()))
    step = optim.make_train_step(model, crit, adam)
    eager = []
    for i in range(LARGE_STEPS):
        eager.append(step(state, torch.as_tensor(
            x[i * BATCH:(i + 1) * BATCH], device="cuda"), torch.as_tensor(
            y[i * BATCH:(i + 1) * BATCH], device="cuda"))[1].item())
    bitwise = eager == legs["a"]["losses"] and all(
        torch.equal(p, trained[k]) for k, p in model.named_parameters())
    emit({"phase": "large_compiled_vs_eager", "eager_losses": eager,
          "compiled_losses": legs["a"]["losses"], "bitwise_equal": bitwise,
          "card": card})
    if not bitwise:
        raise AssertionError("large: the compiled steps are not the eager "
                             "steps bit for bit")
    del trained, state, step, adam
    torch.cuda.empty_cache()

    # (b), (c): bf16, scanned, the policy unset and dots_saveable
    for leg, policy in (("b", None), ("c", "dots_saveable")):
        _restore(model, init)
        # the policy is read at each forward: one model serves both legs
        model.remat_policy = model.scan.policy = policy
        legs[leg] = large_leg(fa, ce, card, f"{leg}_bf16_scanned_{policy}",
                              model, x, y, torch.bfloat16)
    model.remat_policy = model.scan.policy = None
    _restore(model, init)
    # (d): bf16, unrolled (the same seed draws the same weights), no remat
    unrolled = transformer_lm("large", VOCAB, max_len=SEQ, device="cuda",
                              seed=0, scan_layers=False)
    legs["d"] = large_leg(fa, ce, card, "d_bf16_unrolled", unrolled, x, y,
                          torch.bfloat16)
    rel = [abs(a - b) / abs(b) for a, b in zip(legs["d"]["losses"],
                                               legs["b"]["losses"])]
    check = {"b_equals_c_bitwise": legs["b"]["losses"] == legs["c"]["losses"],
             "d_vs_b_max_rel": max(rel),
             "peak_allocated_gb": {k: r["peak_allocated_bytes"] / 1e9
                                   for k, r in legs.items()},
             "remat_below_no_remat":
             legs["b"]["peak_allocated_bytes"]
             < legs["d"]["peak_allocated_bytes"]}
    emit({"phase": "large_check", **check, "card": card})
    if not check["b_equals_c_bitwise"] or max(rel) > LARGE_BF16_LAYOUT_RTOL \
            or not check["remat_below_no_remat"]:
        raise AssertionError(f"large legs: {check}")
    paths["large_bf16"] = {
        "flash_attention_bf16_d96": sum(legs[k]["bf16_launches"]
                                        ["flash_attention"] for k in "bcd"),
        "flash_attention_bwd_bf16_d96": sum(
            legs[k]["bf16_launches"]["flash_attention_bwd"]
            for k in "bcd")}
    # the unrolled model takes the scanned one's weights through the
    # bridge, which unstacks them
    load_jax_params(unrolled, to_jax_params(model))
    paths["large_serving"] = large_serving(fa, card, model.eval(),
                                           unrolled.eval())
    del model, unrolled, init
    torch.cuda.empty_cache()
    return paths


# --------------------------------------------------------------------------- #
# Phase 12: ResNet-50 (the CNN zoo's flagship), trained and evaluated
# --------------------------------------------------------------------------- #

#: bench.py ``_bench_one``'s training setting: ResNet-50 at batch 128 on
#: 224 x 224 images, 4 batches cycled
RESNET_BATCH, RESNET_SIDE, RESNET_BATCHES = 128, 224, 4
#: steps a training leg: step 0 builds the graph; steps 1-6 are timed
#: without the profiler, 7-9 under it
RESNET_STEPS, RESNET_TIMED, RESNET_PROFILED = 10, 6, 3
#: bench.py:1948's estimate of a training image's work (3 x 2 x 4.09e9)
RESNET_FLOP_PER_IMAGE = 3 * 2 * 4.09e9
#: (a) the flagship forward on the card against the CPU, relative L2
RESNET_FWD_TOL = {None: 1e-4, torch.bfloat16: 3e-2}
#: (b) the s2d stem against the plain 7x7/s2 stem on the first batch in
#: fp32, relative L2 (``tests/test_conv.py``'s 2e-4), and the s2d leg's
#: first bf16 loss against the plain bf16 leg's, relative: the stem sums
#: its 147 taps in another order and rounds to bf16, and train-mode
#: BatchNorm at fresh init grows such a difference through 53 layers
RESNET_S2D_STEM_TOL, RESNET_S2D_LOSS_RTOL = 2e-4, 5e-2
#: (c) the compiled eval step against the eager one on the same model,
#: logits relative L2 (the same kernels; cuDNN may pick others in a
#: capture)
RESNET_EVAL_TOL = {None: 1e-5, torch.bfloat16: 1e-3}
#: (d) checkpoint every 4 steps of an 8-step bf16 run (neval 5)
RESNET_CKPT_STEPS, RESNET_CKPT_AT = 8, 5
#: held-out images for (c), and the eval batch
RESNET_HELD_OUT, RESNET_EVAL_BATCH = 64, 32

#: kernel-name patterns of the device time by kind (lower case, first
#: match wins): cuDNN's layout transforms (``nchwToNhwc`` and kin, of
#: activations or of the HWIO weights), the convolution and GEMM
#: kernels, PyTorch's strided (non-vectorized) elementwise kernels, which
#: run on non-contiguous views and casts, its vectorized elementwise
#: kernels (BatchNorm's normalisation, ReLU, the residual adds, the
#: update), its reductions (BatchNorm's statistics and their gradients)
RESNET_KINDS = (
    ("layout_transform", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("convolution", ("conv", "xmma", "implicit_gemm", "dgrad", "wgrad",
                     "fprop", "cudnn", "cutlass", "gemm")),
    ("strided_elementwise", ("at::native::elementwise_kernel",
                             "unrolled_elementwise")),
    ("elementwise", ("vectorized_elementwise", "elementwise")),
    ("reduction", ("reduce_kernel", "reduce", "norm")),
    ("copy", ("copy", "memcpy", "memset", "fill", "cat", "split")),
)


def kernel_kind(name):
    low = name.lower()
    for kind, keys in RESNET_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def resnet_data(seed=0, batches=RESNET_BATCHES):
    """``_bench_one``'s inputs: standard normal images and labels in [0,
    1000) from numpy seed 0, ``batches`` batches of 128."""
    rng = np.random.default_rng(seed)
    n = batches * RESNET_BATCH
    x = rng.standard_normal((n, RESNET_SIDE, RESNET_SIDE, 3),
                            dtype=np.float32)
    y = rng.integers(0, 1000, n)
    return x, y


def resnet_flagship_forward(card):
    """(a) ``__graft_entry__.entry``'s work: ResNet-50 (seed 0) in eval
    mode on 4 images of 224 x 224, its running statistics those of one
    training-mode forward on the card (not the init's), through the
    compiled eval step in fp32 and bf16, against the same model on the
    CPU in fp32."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.models import ResNet

    model = ResNet(50, 1000, device="cuda", seed=0)
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.standard_normal(
        (8, RESNET_SIDE, RESNET_SIDE, 3), dtype=np.float32))
    with torch.no_grad():
        model.train()(xs[:4].cuda())
    model.eval()
    cpu = ResNet(50, 1000, device="cpu", seed=0)
    cpu.load_state_tree(model.state_tree())
    with torch.no_grad():
        want = cpu.eval()(xs[4:])
    rows = {}
    for dtype in (None, torch.bfloat16):
        got = optim.compiled_eval_step(model, dtype)(xs[4:].cuda()).cpu()
        err = rel_l2(got, want)
        rows["bf16" if dtype else "fp32"] = err
        if not torch.isfinite(got).all() or got.shape != (4, 1000) or \
                err > RESNET_FWD_TOL[dtype]:
            raise AssertionError(f"ResNet-50 forward {dtype}: rel L2 {err}")
    var = model._modules["1"].running_var
    row = {"phase": "resnet_forward", "batch": 4, "side": RESNET_SIDE,
           "rel_l2_vs_cpu_fp32": rows, "tolerance": {
               "fp32": RESNET_FWD_TOL[None],
               "bf16": RESNET_FWD_TOL[torch.bfloat16]},
           "stem_bn_running_var_mean": float(var.mean()), "card": card}
    emit(row)
    del model, cpu
    torch.cuda.empty_cache()
    return row


def resnet_leg(card, label, x, y, dtype, fused=False, snap_at=(), **kw):
    """One ``optimize()`` of ``RESNET_STEPS`` steps of ResNet-50 (seed 0,
    ``kw`` its options) at bench.py's setting: images/s over steps 1-6
    (host clock, a sync at each end), the device's busy time and its kinds
    over steps 7-9 under the profiler, idle = 1 - busy / step, peak memory
    and the graph pool, the optimizer update's device time, and the
    model's parameters and buffers at each step of ``snap_at`` (cloned
    after a sync).  Returns ``(row, model, snapshots)``."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.models import ResNet

    model = ResNet(50, 1000, device="cuda", seed=0, **kw)
    method = optim.SGD(learning_rate=0.02, momentum=0.9, dampening=0.0,
                       weight_decay=1e-4)
    if fused:
        method = optim.Fused(method)
    ds = array_dataset(x, y, shuffle_on_epoch=False) >> \
        SampleToMiniBatch(RESNET_BATCH)
    opt = optim.Optimizer(model, ds, nn.CrossEntropyCriterion(), method)
    if dtype is not None:
        opt.set_compute_dtype(dtype)
    summary = _Losses()
    opt.set_train_summary(summary)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    first = 1 + RESNET_TIMED
    snaps = {}

    def snapshot(i):
        def take():
            snaps[i] = ({k: p.detach().clone()
                         for k, p in model.named_parameters()},
                        {k: b.detach().clone()
                         for k, b in model.named_buffers()})
        return take

    then = {first: prof.start, RESNET_STEPS: prof.stop}
    for i in snap_at:
        then.setdefault(i, snapshot(i))
    clock = StepClock(opt, RESNET_STEPS,
                      sync_at=(1, first, RESNET_STEPS, *snap_at), then=then)
    opt.set_end_when(clock)
    # earlier phases' models and graphs can wait in reference cycles:
    # collected here, the peak is this leg's
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_s = (clock.marks[first][0] - clock.marks[1][0]) / RESNET_TIMED
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = union_us([(e.time_range.start, e.time_range.end)
                       for e in kernels]) / 1e6 / RESNET_PROFILED
    by_kind, by_name = collections.Counter(), collections.Counter()
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_kind[kernel_kind(e.name)] += us / 1e3 / RESNET_PROFILED
        by_name[e.name[:90]] += us / 1e3 / RESNET_PROFILED
    images_s = RESNET_BATCH / step_s
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    # the optimizer update alone: one call on the trained weights with
    # their gradients' shapes (a copy of the state, so the run's is kept)
    params = dict(model.named_parameters())
    grads = {k: torch.randn_like(p) * 1e-3 for k, p in params.items()}
    state = clone_tree(method.state)
    saved = {k: p.detach().clone() for k, p in params.items()}
    update_ms = device_ms(lambda: method.update(grads, state, params),
                          iters=5, reps=5)[0]
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(saved[k])
    del grads, state, saved
    row = {"phase": "resnet_leg", "leg": label,
           "compute_dtype": "bf16" if dtype else "fp32",
           "remat": bool(kw.get("remat")), "stem_s2d":
           bool(kw.get("stem_s2d")), "fused_update": fused,
           "batch": RESNET_BATCH, "losses": summary.scalars["Loss"],
           "step_s": step_s, "images_per_s": images_s,
           "device_busy_s_per_step": busy_s,
           "device_idle_share": 1.0 - busy_s / step_s,
           "device_ms_per_step_by_kind": dict(by_kind),
           "top_kernels_ms_per_step": dict(by_name.most_common(12)),
           "optimizer_update_device_ms": update_ms,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "graph_pool_bytes": opt.compiled_stats["pool_bytes"],
           "captured": opt.compiled_stats["captured"],
           "replays": opt.compiled_stats["replays"],
           "model_flops_share_derived": RESNET_FLOP_PER_IMAGE * images_s
           / peak,
           "model_flops_share_peak_tflops": peak / 1e12,
           "cudnn": {"benchmark": torch.backends.cudnn.benchmark,
                     "deterministic": torch.backends.cudnn.deterministic,
                     "allow_tf32": torch.backends.cudnn.allow_tf32},
           "wall_s": wall, "card": card}
    emit(row)
    losses = row["losses"]
    # batch 0 comes back at steps 4 and 8: its loss falls
    if len(losses) != RESNET_STEPS or not all(np.isfinite(losses)) or \
            row["captured"] != 1 or row["replays"] != RESNET_STEPS or \
            not losses[8] < losses[4] < losses[0]:
        raise AssertionError(f"ResNet-50 leg {label}: {row}")
    del opt, prof
    return row, model, snaps


def resnet_s2d_stem(x):
    """The s2d stem against the plain stem on the same weights (seed 0's
    stem) and batch, fp32 on the card: relative L2."""
    from bigdl_tpu_torch import nn

    g = torch.Generator().manual_seed(0)
    plain = nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, with_bias=False,
                                  generator=g).cuda()
    s2d = nn.SpaceToDepthStem(3, 64, 7).cuda()
    s2d.load_parameters_tree(plain.parameters_tree())
    xb = torch.as_tensor(x, device="cuda")
    with torch.no_grad():
        return rel_l2(s2d(xb), plain(xb))


def _global_rel(a, b):
    """Relative L2 of two ``{name: tensor}`` dicts as one vector."""
    num = sum(float((a[k].detach().double() - b[k].detach().double())
                    .norm() ** 2) for k in b)
    den = sum(float(b[k].detach().double().norm() ** 2) for k in b)
    return (num / max(den, 1e-300)) ** 0.5


def _run_steps(x, y, steps, compiled):
    """``steps`` fp32 steps of ResNet-50 (seed 0) on the first batches,
    eager (``make_train_step``) or through ``CompiledTrainStep``; returns
    the losses and the parameters and buffers after them."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models import ResNet

    model = ResNet(50, 1000, device="cuda", seed=0)
    sgd = optim.SGD(learning_rate=0.02, momentum=0.9, dampening=0.0,
                    weight_decay=1e-4)
    state = sgd.init_state(dict(model.named_parameters()))
    crit = nn.CrossEntropyCriterion()
    if compiled:
        step = optim.CompiledTrainStep(model, crit, sgd, state,
                                       next(model.parameters()).device)
        run = step.run
    else:
        step = optim.make_train_step(model, crit, sgd)
        run = lambda xb, yb: step(state, xb, yb)[1]  # noqa: E731
    losses = []
    for i in range(steps):
        sl = slice(i * RESNET_BATCH, (i + 1) * RESNET_BATCH)
        losses.append(run(torch.as_tensor(x[sl], device="cuda"),
                          torch.as_tensor(y[sl], device="cuda")).item())
    out = (losses, {k: p.detach().clone()
                    for k, p in model.named_parameters()},
           {k: b.detach().clone() for k, b in model.named_buffers()})
    del model, state, step
    torch.cuda.empty_cache()
    return out


def resnet_eager_check(card, x, y, leg_row, leg_snap):
    """(b) compiled against eager, 3 fp32 steps from the same weights.
    cuDNN's default backward algorithms are not deterministic, and
    BatchNorm's biases take gradients small against their terms, so two
    eager runs already part: with ``cudnn.deterministic`` the compiled
    step (a ``CompiledTrainStep`` run) is held to the eager step within
    ``COMPILED_RTOL`` (losses; parameters and running statistics as one
    vector each), bitwise equality printed; then the timed fp32 leg's
    first 3 steps (default algorithms) are set beside a second eager run
    with default algorithms, to show the spread of those."""
    torch.backends.cudnn.deterministic = True
    try:
        e_losses, e_params, e_bufs = _run_steps(x, y, 3, False)
        c_losses, c_params, c_bufs = _run_steps(x, y, 3, True)
    finally:
        torch.backends.cudnn.deterministic = False
    step_rel = [abs(a - b) / abs(b) for a, b in zip(c_losses, e_losses)]
    p_rel, b_rel = _global_rel(c_params, e_params), _global_rel(c_bufs,
                                                                e_bufs)
    bitwise = c_losses == e_losses and p_rel == 0 and b_rel == 0
    n_losses, n_params, n_bufs = _run_steps(x, y, 3, False)
    leg_params, leg_bufs = leg_snap
    tol = COMPILED_RTOL[None]
    row = {"phase": "resnet_compiled_vs_eager",
           "deterministic": {"eager_losses": e_losses,
                             "compiled_losses": c_losses,
                             "max_step_loss_rel": max(step_rel),
                             "params_rel_l2": p_rel,
                             "buffers_rel_l2": b_rel,
                             "bitwise_equal": bitwise, "tolerance": tol},
           "default_algorithms": {
               "eager_losses": n_losses,
               "timed_leg_losses": leg_row["losses"][:3],
               "eager_vs_deterministic_eager_params_rel_l2":
               _global_rel(n_params, e_params),
               "timed_leg_vs_eager_params_rel_l2":
               _global_rel(leg_params, n_params),
               "timed_leg_vs_eager_buffers_rel_l2":
               _global_rel(leg_bufs, n_bufs)},
           "card": card}
    emit(row)
    if max(step_rel) > tol or p_rel > tol or b_rel > tol:
        raise AssertionError(f"ResNet-50 compiled against eager: {row}")
    return row


def resnet_eval(card, model):
    """(c) ``validate`` with ``Top1Accuracy`` and ``Predictor`` over 64
    held-out images (numpy seed 1) through the compiled eval step, fp32
    and bf16, against an eager eval of the trained model with its
    current statistics: the logits (``RESNET_EVAL_TOL``), the Top1 count
    (a differing argmax only at a near-tie of ``TIE_MARGIN``) and
    ``Predictor``'s rows."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset

    xv, yv = resnet_data(seed=1, batches=1)
    xv, yv = xv[:RESNET_HELD_OUT], yv[:RESNET_HELD_OUT]
    rows = {}
    for dtype in (None, torch.bfloat16):
        tag = "bf16" if dtype else "fp32"
        ds = array_dataset(xv, yv) >> SampleToMiniBatch(RESNET_EVAL_BATCH)
        t0 = time.perf_counter()
        (top1,) = optim.validate(model, ds, [optim.Top1Accuracy()], dtype)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
        pred = np.stack(optim.Predictor(model, RESNET_EVAL_BATCH,
                                        compute_dtype=dtype)
                        .predict(list(xv)))
        with torch.no_grad():
            eager = torch.cat([optim.make_eval_step(model, dtype)(
                torch.as_tensor(xv[i:i + RESNET_EVAL_BATCH],
                                device="cuda")).cpu()
                for i in range(0, RESNET_HELD_OUT, RESNET_EVAL_BATCH)])
        err = rel_l2(torch.from_numpy(pred), eager)
        want = (eager.argmax(-1).numpy() == yv)
        got = (pred.argmax(-1) == yv)
        top2 = torch.topk(eager, 2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1]).numpy() < TIE_MARGIN
        mismatched = int(((got != want) & ~near).sum())
        rows[tag] = {"top1": top1.result()[0], "count": top1.result()[1],
                     "eager_top1": float(want.mean()),
                     "predictor_rel_l2": err, "non_tie_mismatches":
                     mismatched, "validate_s": val_s,
                     "eval_pool_bytes": optim.compiled_eval_step(
                         model, dtype).stats()["pool_bytes"]}
        if err > RESNET_EVAL_TOL[dtype] or mismatched or \
                top1.result()[1] != RESNET_HELD_OUT or \
                abs(top1.result()[0] - float(got.mean())) > 1e-9:
            raise AssertionError(f"ResNet-50 eval {tag}: {rows[tag]}")
    row = {"phase": "resnet_eval", "held_out": RESNET_HELD_OUT, **rows,
           "card": card}
    emit(row)
    return row


def _resnet_ckpt_run(model, x, y, ckpt, resume=False):
    """8 bf16 steps of ResNet-50 with SGD, a checkpoint at neval 5;
    returns the optimizer, per-step losses by iteration and the writes
    (path, seconds)."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset

    opt = optim.Optimizer(
        model, array_dataset(x, y, shuffle_on_epoch=False) >>
        SampleToMiniBatch(RESNET_BATCH), nn.CrossEntropyCriterion(),
        optim.SGD(learning_rate=0.02, momentum=0.9, dampening=0.0,
                  weight_decay=1e-4))
    opt.set_compute_dtype(torch.bfloat16)
    opt.set_end_when(optim.Trigger.max_iteration(RESNET_CKPT_STEPS))
    opt.set_checkpoint(str(ckpt),
                       optim.Trigger.several_iteration(RESNET_CKPT_AT))
    losses, writes = {}, []

    class _Summary:
        def add_scalar(self, tag, value, step):
            if tag == "Loss":
                losses[step] = value

    opt.set_train_summary(_Summary())
    write = opt._checkpoint

    def timed(opt_state):
        t0 = time.perf_counter()
        path = write(opt_state)
        writes.append((path, time.perf_counter() - t0))
        return path

    opt._checkpoint = timed
    if resume:
        opt.resume_from_checkpoint()
    opt.optimize()
    torch.cuda.synchronize()
    return opt, losses, writes


def resnet_checkpoint(card, x, y):
    """(d) a checkpoint with BatchNorm state after step 4 of an 8-step bf16
    run, resumed into a fresh model (seed 1) to step 8: its bytes and
    write time, per-step losses, parameters and running statistics
    against the straight run's (``RESUME_RTOL``; bitwise printed)."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.utils import file_io

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_resnet_ckpt_"))
    # deterministic algorithms: the straight and the resumed runs are two
    # runs, which cuDNN's default backward algorithms would part
    torch.backends.cudnn.deterministic = True
    try:
        straight = ResNet(50, 1000, device="cuda", seed=0)
        _, s_losses, writes = _resnet_ckpt_run(straight, x, y, root)
        (path, write_s), = writes
        snap = file_io.load(path)
        if not snap["model_state"]["1"]["running_mean"].any():
            raise AssertionError("the checkpoint holds no statistics")
        resumed = ResNet(50, 1000, device="cuda", seed=1)
        _, r_losses, _ = _resnet_ckpt_run(resumed, x, y, root, resume=True)
        params = lambda m: dict(m.named_parameters())  # noqa: E731
        p_rel = _global_rel(params(resumed), params(straight))
        b_rel = _global_rel(dict(resumed.named_buffers()),
                            dict(straight.named_buffers()))
        steps = sorted(r_losses)
        step_rel = [abs(r_losses[s] - s_losses[s]) / abs(s_losses[s])
                    for s in steps]
        bitwise = all(r_losses[s] == s_losses[s] for s in steps) and \
            p_rel == 0 and b_rel == 0
        row = {"phase": "resnet_checkpoint", "checkpoint": Path(path).name,
               "bytes": file_io.getsize(path), "write_s": write_s,
               "straight_losses": s_losses, "resumed_losses": r_losses,
               "max_step_loss_rel": max(step_rel), "params_rel_l2": p_rel,
               "buffers_rel_l2": b_rel, "bitwise_equal": bitwise,
               "cudnn_deterministic": True, "tolerance": RESUME_RTOL,
               "card": card}
        emit(row)
        if steps != list(range(RESNET_CKPT_AT, RESNET_CKPT_STEPS + 1)) or \
                max(step_rel) > RESUME_RTOL or p_rel > RESUME_RTOL or \
                b_rel > RESUME_RTOL:
            raise AssertionError(f"ResNet-50 resume: {row}")
        return row
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def cnn_recipes(card):
    """(e) ``lenet-train``, ``vgg-train``, ``resnet-train --depth 20`` and
    ``inception-train --version v1``, 4 iterations each through
    ``models/run.py`` on the card."""
    from bigdl_tpu_torch.models import run

    rows = {}
    for argv in (["lenet-train"], ["vgg-train"],
                 ["resnet-train", "--depth", "20"],
                 ["inception-train", "--version", "v1"]):
        t0 = time.perf_counter()
        opt = run.main(argv + ["--maxIteration", "4"])
        torch.cuda.synchronize()
        rows[argv[0]] = {"loss": opt.driver_state["loss"],
                         "neval": opt.driver_state["neval"],
                         "wall_s": time.perf_counter() - t0,
                         "captured": opt.compiled_stats["captured"]}
        if opt.driver_state["neval"] != 5 or \
                not np.isfinite(opt.driver_state["loss"]):
            raise AssertionError(f"recipe {argv}: {rows[argv[0]]}")
        del opt
        torch.cuda.empty_cache()
    emit({"phase": "cnn_recipes", "recipes": rows, "card": card})
    return rows


def resnet_phase(card):
    """Phase 12: ResNet-50 at full width and depth (module docstring)."""
    t0 = time.perf_counter()
    resnet_flagship_forward(card)
    x, y = resnet_data()
    emit({"phase": "resnet_data", "images": len(x),
          "seconds": time.perf_counter() - t0, "card": card})
    legs = {}
    legs["fp32"], fp32_model, fp32_snaps = resnet_leg(
        card, "fp32", x, y, None, snap_at=(3,))
    resnet_eager_check(card, x, y, legs["fp32"], fp32_snaps[3])
    del fp32_snaps
    legs["bf16"], bf16_model, bf16_snaps = resnet_leg(
        card, "bf16", x, y, torch.bfloat16, snap_at=(1,))
    del bf16_model
    torch.cuda.empty_cache()
    legs["bf16_remat"], model, remat_snaps = resnet_leg(
        card, "bf16_remat", x, y, torch.bfloat16, snap_at=(1,), remat=True)
    del model
    torch.cuda.empty_cache()
    legs["bf16_s2d_fused"], model, _ = resnet_leg(
        card, "bf16_s2d_fused", x, y, torch.bfloat16, fused=True,
        stem_s2d=True)
    del model
    torch.cuda.empty_cache()
    # the remat leg's statistics after one step against the plain leg's
    # (buffer names differ by the Remat "0" level; the order is the same)
    plain_b = list(bf16_snaps[1][1].values())
    remat_b = list(remat_snaps[1][1].values())
    stat_rel = max(rel_l2(a, b) for a, b in zip(remat_b, plain_b))
    stat_bitwise = all(torch.equal(a, b) for a, b in zip(remat_b, plain_b))
    s2d_rel = abs(legs["bf16_s2d_fused"]["losses"][0]
                  - legs["bf16"]["losses"][0]) / abs(legs["bf16"]["losses"][0])
    stem_rel = resnet_s2d_stem(x[:RESNET_BATCH])
    check = {"phase": "resnet_legs_check",
             "remat_stats_after_step1_rel_l2": stat_rel,
             "remat_stats_bitwise": stat_bitwise,
             "s2d_first_loss_rel": s2d_rel,
             "s2d_loss_tolerance": RESNET_S2D_LOSS_RTOL,
             "s2d_stem_fp32_rel_l2": stem_rel,
             "s2d_stem_tolerance": RESNET_S2D_STEM_TOL,
             "images_per_s": {k: r["images_per_s"] for k, r in legs.items()},
             "peak_allocated_gb": {k: r["peak_allocated_bytes"] / 1e9
                                   for k, r in legs.items()},
             "remat_below_plain": legs["bf16_remat"]["peak_allocated_bytes"]
             < legs["bf16"]["peak_allocated_bytes"], "card": card}
    emit(check)
    del bf16_snaps, remat_snaps
    if len(plain_b) != len(remat_b) or stat_rel > COMPILED_RTOL[None] or \
            s2d_rel > RESNET_S2D_LOSS_RTOL or stem_rel > RESNET_S2D_STEM_TOL:
        raise AssertionError(f"ResNet-50 legs: {check}")
    resnet_eval(card, fp32_model)
    del fp32_model
    torch.cuda.empty_cache()
    resnet_checkpoint(card, x, y)
    del x, y
    cnn_recipes(card)
    return legs


# --------------------------------------------------------------------------- #
# Phase 13: int8 ResNet-50 through K6; the recipes' summaries, prefetch
# workers and the run supervisor
# --------------------------------------------------------------------------- #

#: published H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12
INT8_OPS = "operations (int8 tensor cores)"
#: (a) K6's rows: (label, batch, input side, cin, cout, kernel, stride,
#: pads ("SAME": TF-style), dilation, groups); ResNet-50's shapes at batch
#: 128, then two coverage rows at a small batch
INT8_CONV_ROWS = (
    ("stem 7x7/2 3->64 @224", 128, 224, 3, 64, 7, 2, ((3, 3), (3, 3)), 1,
     1),
    ("1x1 256->64 @56", 128, 56, 256, 64, 1, 1, ((0, 0), (0, 0)), 1, 1),
    ("3x3 64->64 @56", 128, 56, 64, 64, 3, 1, ((1, 1), (1, 1)), 1, 1),
    ("3x3/2 256->256 @28", 128, 28, 256, 256, 3, 2, ((1, 1), (1, 1)), 1, 1),
    ("1x1/2 512->1024 @28", 128, 28, 512, 1024, 1, 2, ((0, 0), (0, 0)), 1,
     1),
    ("alexnet 5x5 96->256 g2 @27", 8, 27, 96, 256, 5, 1, ((2, 2), (2, 2)), 1,
     2),
    ("SAME 3x3/2 d2 64->64 @28", 8, 28, 64, 64, 3, 2, "SAME", 2, 1),
)
#: (a) each row's time on the ``mma.sync`` kernel that the wgmma kernel
#: replaced (PERF.md's kernel table, NVIDIA H100 80GB HBM3, 700.00 W)
INT8_CONV_MMA_SYNC_MS = {
    "stem 7x7/2 3->64 @224": 0.7154, "1x1 256->64 @56": 0.1547,
    "3x3 64->64 @56": 0.2155, "3x3/2 256->256 @28": 0.1753,
    "1x1/2 512->1024 @28": 0.1980, "alexnet 5x5 96->256 g2 @27": 0.0419,
    "SAME 3x3/2 d2 64->64 @28": 0.0216}
#: the rows the ``{"kernels": ...}`` line reports for K6's two kernels
INT8_CONV_KEY_ROW = "3x3 64->64 @56"
INT8_GATHER_KEY_ROW = "stem 7x7/2 3->64 @224"
#: ... for K6q's routes: the given route at a block's output, the
#: three-node route at the max-pool's output (the small route's row is
#: phase 9's: ``int8_serving_phase``); and for K7 at a block's tail
ACT_QUANT_KEY_ROWS = {"act_quant_given": "(128, 56, 56, 256)",
                      "act_quant": "(128, 56, 56, 64)"}
#: (a) the head's input, where K6q's small route is also timed against
#: the three-node route
RESNET_HEAD_INPUT = (128, 2048)
BN_ACT_KEY_ROW = "(128, 56, 56, 256) BN + add + ReLU"
#: (b) K6 launches in one ResNet-50 forward: the stem (the gather
#: kernel), 16 bottlenecks of three convolutions, 4 projection shortcuts
#: (the wgmma kernel)
RESNET_CONVS = 53
#: (b) the fused plan of the twin (``nn/fused.py``): K7 launches a forward
#: (the stem, two BatchNorm + ReLU sites and the tail of each of the 16
#: bottlenecks, the 4 projection shortcuts' BatchNorms folded into their
#: tails), and K6q's quantizations a forward: one for each distinct input
#: of the 53 convolutions and the head (a downsampling block's conv1 and
#: shortcut share theirs), 47 of them K7 outputs (the given route)
RESNET_K7_SITES = 49
RESNET_QUANTIZATIONS = 50
RESNET_GIVEN = 47
#: K7's forms, by the number ``resnet50_fused_sites`` gives them
K7_FORMS = {1: "BN + ReLU", 2: "BN + add + ReLU",
            3: "BN + BN(shortcut) + add + ReLU"}
#: (b) Predictor batches of 128 through the compiled eval step (the
#: second one ragged: 100 images padded to 128)
INT8_PREDICT_IMAGES = 228
#: (b) eval replays timed per dtype
INT8_EVAL_REPS = 5
#: (c) requests sent one at a time to the int8 engine
INT8_SERVE_REQUESTS = 8
#: (b) the compiled (graph) int8 forward against its eager run on the
#: same padded batch, logits relative L2: the same operations on the same
#: inputs (the twin with both halves plain is held bitwise)
INT8_PLAIN_RTOL = 1e-6
#: (b) kernels of the activation quantization as PyTorch passes, by name:
#: none may be left in the replay
QUANT_PASS_KERNELS = ("abs_kernel", "round_kernel", "MaxOps")
#: (b), (c) the accuracy gate of the int8 twin against the fp32 model.
#: Measured on the H100 (PERF.md, the int8 CNN findings): logit RMSE
#: 9.33 over 128 rows and 9.26 over the engine's 8 (random weights give
#: logits of order 100), top-1 agreement 1.0 on both.  The limits sit one
#: step above that: RMSE 1.5x, one of the engine's 8 rows lost
INT8_GATE_TOP1, INT8_GATE_RMSE = 0.875, 14.0
#: (d) the recipe's iterations per run
RECIPE_ITERS = 12
#: (e) the supervised child: iterations, checkpoint cadence, chaos step
SUP_STEPS, SUP_EVERY, SUP_CHAOS = 10, 2, 5
SUP_DEVICE = "cuda"


def _im2col_int8(x_q, kernel, stride, pads, dilation):
    """The ``(N * Ho * Wo, kh * kw * C)`` patch matrix of an int8 NHWC
    batch: a strided view of the padded batch, copied once."""
    (ph0, ph1), (pw0, pw1) = pads
    x = torch.nn.functional.pad(x_q, (0, 0, pw0, pw1, ph0, ph1))
    n, hp, wp, c = x.shape
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    ho = (hp - (kh - 1) * dh - 1) // sh + 1
    wo = (wp - (kw - 1) * dw - 1) // sw + 1
    s = x.stride()
    view = x.as_strided((n, ho, wo, kh, kw, c),
                        (s[0], sh * s[1], sw * s[2], dh * s[1], dw * s[2],
                         s[3]))
    return view.reshape(n * ho * wo, kh * kw * c)


def int8_conv_rows(card):
    """(a) K6 against its plain version at each row's shape, bitwise, with
    the device times of K6 (the wgmma kernel over the packed weight, or
    the gather kernel: the shape picks), the plain version and two library
    computations (CUDA-graph replays): im2col plus ``torch._int_mm`` for
    the same int32 sums, and cuDNN's bf16 ``F.conv2d`` (channels-last) of
    the float layer; beside the replaced ``mma.sync`` kernel's time."""
    from bigdl_tpu_torch.nn import quantized as tq
    from bigdl_tpu_torch.nn.conv import same_pads
    from bigdl_tpu_torch.ops import int8_conv as k6

    rows = {}
    g = np.random.default_rng(13)
    for (label, n, side, cin, cout, k, stride, pads, dil,
         groups) in INT8_CONV_ROWS:
        if pads == "SAME":
            pads = tuple(same_pads(side, k, stride, dil) for _ in range(2))
        x = torch.from_numpy(g.standard_normal(
            (n, side, side, cin), dtype=np.float32)).cuda()
        w_q = torch.from_numpy(g.integers(
            -127, 128, (k, k, cin // groups, cout), dtype=np.int8)).cuda()
        scale = torch.from_numpy(
            g.uniform(1e-3, 2e-2, cout).astype(np.float32)).cuda()
        x_q, x_scale = tq._quantize_activation(x)
        args = (x_q, w_q, scale, x_scale, None, (stride, stride), pads,
                (dil, dil), groups, torch.float32)
        wgmma = k6.uses_wgmma(cin // groups)
        packed = k6.pack_weight(w_q, groups) if wgmma else None
        path = "int8_conv" if wgmma else "int8_conv_gather"
        before = k6.LAUNCHES[path]
        got = k6.int8_conv_nhwc(*args, packed)
        want = k6.int8_conv_nhwc_reference(*args)
        torch.cuda.synchronize()
        if k6.LAUNCHES[path] != before + 1:
            raise AssertionError(f"K6 {label}: not launched as {path}")
        bitwise = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        m, cout_g = got.shape[0] * got.shape[1] * got.shape[2], cout // groups
        kk = k * k * (cin // groups)
        n_bytes = (x_q.numel() + w_q.numel() + 4 * (cout + 1)
                   + 4 * got.numel())
        ops = 2 * m * cout * kk
        bound_ms, bound_by = bound(n_bytes, ops, INT8_OPS_PER_S, INT8_OPS)
        ms = device_ms(lambda: k6.int8_conv_nhwc(*args, packed))
        plain_ms = device_ms(lambda: k6.int8_conv_nhwc_reference(*args),
                             iters=5, reps=5)[0]
        # the library computations, on the same inputs
        w_t = [w_q[..., j * cout_g:(j + 1) * cout_g].reshape(kk, cout_g)
               .t().contiguous() for j in range(groups)]
        cin_g = cin // groups

        def int_mm():
            return [tq._int_mm(_im2col_int8(
                x_q[..., j * cin_g:(j + 1) * cin_g], (k, k),
                (stride, stride), pads, (dil, dil)), w_t[j])
                for j in range(groups)]

        acc_lib = torch.cat(int_mm(), dim=1)
        acc_ref = k6.int8_conv_acc_reference(x_q, w_q, (stride, stride),
                                             pads, (dil, dil), groups)
        lib_exact = bool(torch.equal(acc_lib, acc_ref.reshape(m, cout)))
        int_mm_ms = device_ms(int_mm, iters=5, reps=5)[0]
        (ph0, ph1), (pw0, pw1) = pads
        x_bf = torch.nn.functional.pad(
            x.to(torch.bfloat16), (0, 0, pw0, pw1, ph0, ph1)).permute(
            0, 3, 1, 2)
        w_bf = (w_q.float() * scale).to(torch.bfloat16).permute(
            3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        cudnn_ms = device_ms(lambda: torch.nn.functional.conv2d(
            x_bf, w_bf, stride=stride, dilation=dil, groups=groups),
            iters=10, reps=5)[0]
        row = {"phase": "int8_conv", "shape": label, "batch": n,
               "pads": pads, "kernel": path, "bitwise_equal_plain": bitwise,
               "max_abs_err": err, "ms": ms[0], "ms_range": ms[1:],
               "mma_sync_ms": INT8_CONV_MMA_SYNC_MS[label],
               "speedup_vs_mma_sync": INT8_CONV_MMA_SYNC_MS[label] / ms[0],
               "bound_ms": bound_ms, "bound_by": bound_by,
               "share_of_bound": bound_ms / ms[0], "plain_ms": plain_ms,
               "library_ms": int_mm_ms, "library": "im2col + torch._int_mm",
               "library_exact": lib_exact,
               "int_mm_over_kernel": int_mm_ms / ms[0],
               "cudnn_bf16_ms": cudnn_ms,
               "int8_tops": ops / ms[0] / 1e9, "card": card}
        emit(row)
        rows[label] = row
        del x, w_q, x_q, got, want, acc_lib, acc_ref, x_bf, w_bf, w_t, packed
        torch.cuda.empty_cache()
        if not bitwise or not lib_exact:
            raise AssertionError(f"K6 {label}: {row}")
    return rows


def resnet50_fused_sites(batch=RESNET_BATCH):
    """One eager forward of ResNet-50's int8 twin (``quantize_model``,
    seed 0, default statistics) at ``batch`` on a random image, with K7's
    and K6q's wrappers recorded: the distinct ``(shape, form)`` of its K7
    sites and ``(shape, route)`` of its quantizations, in the order the
    forward meets them, K6q's quantizations a forward by route, and K7's
    launches a forward."""
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn import quantized as tq
    from bigdl_tpu_torch.ops import act_quant as k6q
    from bigdl_tpu_torch.ops import bn_act as k7

    twin, _ = tq.quantize_model(ResNet(50, 1000, device="cuda",
                                       seed=0).eval())
    k7_sites, routes = [], []
    real_k7, real_route = k7.bn_act, k6q.quantize_route

    def k7_spy(x, bn, residual=None, residual_bn=None, relu=True, **kw):
        form = 1 if residual is None else 2 if residual_bn is None else 3
        k7_sites.append((tuple(x.shape), form))
        return real_k7(x, bn, residual, residual_bn, relu, **kw)

    def route_spy(x, route, absmax=None):
        routes.append((tuple(x.shape), route))
        return real_route(x, route, absmax)

    k7.bn_act, k6q.quantize_route = k7_spy, route_spy
    try:
        g = torch.Generator(device="cuda").manual_seed(15)
        with torch.no_grad():
            twin(torch.randn((batch, RESNET_SIDE, RESNET_SIDE, 3),
                             generator=g, device="cuda"))
        torch.cuda.synchronize()
    finally:
        k7.bn_act, k6q.quantize_route = real_k7, real_route
    del twin
    torch.cuda.empty_cache()
    return (list(dict.fromkeys(k7_sites)), list(dict.fromkeys(routes)),
            dict(collections.Counter(r for _, r in routes)), len(k7_sites))


def l2_bytes():
    """The card's L2 cache in bytes (H100 SXM: 50 MiB)."""
    return getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                   0) or 50 * 2 ** 20


def _random_bn(c, g):
    """An eval-mode BatchNorm on the card with random statistics and
    affine parameters from the CUDA generator ``g``."""
    from bigdl_tpu_torch import nn

    bn = nn.SpatialBatchNormalization(c).cuda().eval().requires_grad_(False)
    with torch.no_grad():
        bn.running_mean.normal_(generator=g)
        bn.running_var.uniform_(0.05, 3.0, generator=g)
        bn.weight.uniform_(-2.0, 2.0, generator=g)
        bn.bias.normal_(generator=g)
    return bn


def bn_act_row(card, shape, form, seed):
    """(a) K7 against its plain version at one of ResNet-50's K7 sites:
    ``y``'s bits and the absmax it hands to K6q equal, the device times of
    K7 and of the plain version (CUDA-graph replays), the bound (x, the
    residual and the BatchNorms' buffers read once, y written once).
    Raises where they differ."""
    from bigdl_tpu_torch.ops import act_quant as k6q
    from bigdl_tpu_torch.ops import bn_act as k7

    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device="cuda") * 3
    r = torch.randn(shape, generator=g, device="cuda") if form > 1 else None
    bns = [_random_bn(c, g) for _ in range(1 + (form == 3))]
    args = (x, bns[0], r, bns[1] if form == 3 else None, True)
    got = k7.bn_act(*args, absmax=True)
    want = k7.bn_act_reference(*args)
    absmax = k6q.handed_off_absmax(got)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(got.view(torch.int32),
                               want.view(torch.int32))) and \
        bool(torch.equal(absmax, want.abs().amax().reshape(1)
                         .view(torch.int32)))
    ms = device_ms(lambda: k7.bn_act(*args, absmax=True))
    plain_ms = device_ms(lambda: k7.bn_act_reference(*args), iters=5,
                         reps=5)[0]
    n_bytes = x.nbytes * (2 + (r is not None)) + 16 * c * len(bns)
    bound_ms, bound_by = bound(n_bytes, 0)
    label = f"{shape} {K7_FORMS[form]}"
    row = {"phase": "bn_act", "shape": str(shape), "form": K7_FORMS[form],
           "elements": x.numel(), "bitwise_equal_plain": bitwise,
           "max_abs_err": float((got - want).abs().max()),
           "ms": ms[0], "ms_range": ms[1:], "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes_per_element": n_bytes / x.numel(),
           "share_of_bound": bound_ms / ms[0], "plain_ms": plain_ms,
           "library_ms": None, "card": card}
    emit(row)
    del x, r, got, want
    if not bitwise:
        raise AssertionError(f"K7 {label}: {row}")
    return label, row


def act_quant_row(card, x, path, route, absmax=None):
    """K6q's ``route`` against its plain version on ``x`` (``absmax``: the
    bits K7 handed off, for the given route): ``x_q`` and ``x_scale``
    bitwise, the device times of the route and of the plain version
    (CUDA-graph replays) and the bound (``x`` read once, ``x_q`` written
    once: no PyTorch call computes this quantization); for the three-node
    route also its two-pass floor (``x`` read twice from HBM unless ``x``
    and ``x_q`` fit in L2 together), for the small route the three-node
    route on the same ``x``, bitwise against the plain version too, and
    its time.  Raises where any of them differs."""
    from bigdl_tpu_torch.ops import act_quant as k6q

    got_q, got_s = k6q.quantize_route(x, route, absmax)
    want_q, want_s = k6q.act_quant_reference(x)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(got_q, want_q)) and \
        bool(torch.equal(got_s, want_s))
    ms = device_ms(lambda: k6q.quantize_route(x, route, absmax))
    plain_ms = device_ms(lambda: k6q.act_quant_reference(x), iters=5,
                         reps=5)[0]
    n, size = x.numel(), x.element_size()
    bound_ms, bound_by = bound((size + 1) * n, 0)
    row = {"phase": "act_quant", "path": path, "route": route,
           "shape": str(tuple(x.shape)), "dtype": str(x.dtype),
           "elements": n, "bitwise_equal_plain": bitwise,
           "max_abs_err": float((got_q.int() - want_q.int()).abs().max()),
           "x_scale": float(got_s), "ms": ms[0], "ms_range": ms[1:],
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms[0], "plain_ms": plain_ms,
           "library_ms": None, "card": card}
    if route == "act_quant":
        in_l2 = (size + 1) * n <= l2_bytes()
        two_pass_ms, _ = bound((size + 1 + (0 if in_l2 else size)) * n, 0)
        row.update(x_and_x_q_fit_l2=in_l2, two_pass_bound_ms=two_pass_ms,
                   share_of_two_pass_bound=two_pass_ms / ms[0])
    if route == "act_quant_small":
        three_q, three_s = k6q.quantize_route(x, "act_quant")
        torch.cuda.synchronize()
        three_bitwise = bool(torch.equal(three_q, want_q)) and \
            bool(torch.equal(three_s, want_s))
        three = device_ms(lambda: k6q.quantize_route(x, "act_quant"))
        row.update(blocks=k6q.small_blocks(n),
                   three_node_bitwise_equal_plain=three_bitwise,
                   three_node_ms=three[0], three_node_ms_range=three[1:],
                   small_over_three_node=ms[0] / three[0])
        bitwise = bitwise and three_bitwise
        del three_q
    emit(row)
    del got_q, want_q
    if not bitwise:
        raise AssertionError(f"K6q {route} {tuple(x.shape)}: {row}")
    return row


def act_quant_rows(card, quant_sites):
    """(a) K6q at each ``(shape, route)`` of ResNet-50's quantizations at
    batch 128 (``resnet50_fused_sites``): the given route on a K7 output
    (BatchNorm + ReLU of a random input, its absmax handed off), the
    other routes on a random input."""
    from bigdl_tpu_torch.ops import act_quant as k6q
    from bigdl_tpu_torch.ops import bn_act as k7

    rows = {}
    g = torch.Generator(device="cuda").manual_seed(14)
    for shape, route in quant_sites:
        x = torch.randn(shape, generator=g, device="cuda")
        absmax = None
        if route == "act_quant_given":
            x = k7.bn_act(x, _random_bn(shape[-1], g), absmax=True)
            absmax = k6q.handed_off_absmax(x)
        rows[(str(shape), route)] = act_quant_row(card, x, "int8_resnet",
                                                  route, absmax)
        del x, absmax
        torch.cuda.empty_cache()
    head = torch.randn(RESNET_HEAD_INPUT, generator=g, device="cuda")
    rows[(str(RESNET_HEAD_INPUT), "act_quant_small")] = act_quant_row(
        card, head, "int8_resnet", "act_quant_small")
    return rows


def _conv_outputs(model, x):
    """Each convolution's output (by module name) in one eager forward."""
    from bigdl_tpu_torch import nn

    outs, hooks = {}, []
    for name, m in model.named_modules():
        if type(m) in (nn.SpatialConvolution, nn.QuantizedSpatialConvolution):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o, name=name: outs.__setitem__(
                    name, o.detach().clone())))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return outs


@contextlib.contextmanager
def _plain_int8(conv=True):
    """The int8 layers through the plain versions on the card: K6q's
    always, K6's and K7's with ``conv`` (the comparison's reference; never
    the main path)."""
    from bigdl_tpu_torch.ops import act_quant as k6q
    from bigdl_tpu_torch.ops import bn_act as k7
    from bigdl_tpu_torch.ops import int8_conv as k6

    real = k6._on_cpu, k7._on_cpu, k6q.act_quant
    if conv:
        k6._on_cpu = k7._on_cpu = lambda *ts: True
    k6q.act_quant = k6q.act_quant_reference
    try:
        yield
    finally:
        k6._on_cpu, k7._on_cpu, k6q.act_quant = real


def _eval_rate(step, x, reps=INT8_EVAL_REPS):
    """Images/s of compiled eval replays (host clock around ``reps``
    calls, a sync at each end); the first call builds the graph."""
    step(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(x)
    torch.cuda.synchronize()
    return reps * x.shape[0] / (time.perf_counter() - t0)


#: (b) the hand-written kernels of the int8 forward, by profiler name
INT8_KERNEL_NAMES = {"int8_conv": ("int8_conv_wgmma_kernel",),
                     "int8_conv_gather": ("int8_conv_gather_kernel",),
                     "act_quant": ("absmax_kernel", "quantize_kernel",
                                   "act_quant_small_kernel"),
                     "bn_act": ("bn_act_kernel",)}


def _device_share(fn):
    """Device time of one call of ``fn`` under the profiler: the busy ms,
    the share of it in each of ``INT8_KERNEL_NAMES``' kernels, the ms by
    kind, and the device kernels and memsets themselves."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    # one profiled warm-up call first: after the earlier phases' profiles,
    # a window's first kernels were missing from its events
    with torch.profiler.profile(
            activities=acts, schedule=torch.profiler.schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # (the schedule's step annotation spans the step on the device too)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and
               not e.name.startswith("ProfilerStep")]
    busy = union_us([(e.time_range.start, e.time_range.end)
                     for e in kernels]) / 1e3

    def kind(name):
        return next((label for label, parts in INT8_KERNEL_NAMES.items()
                     if any(p in name for p in parts)), None) or \
            kernel_kind(name)

    by_kind = collections.Counter()
    for e in kernels:
        by_kind[kind(e.name)] += (e.time_range.end - e.time_range.start) / 1e3
    shares = {label: by_kind.get(label, 0.0) / max(busy, 1e-9)
              for label in INT8_KERNEL_NAMES}
    return busy, shares, dict(by_kind), kernels


def _int8_launches():
    from bigdl_tpu_torch.ops import act_quant as k6q
    from bigdl_tpu_torch.ops import bn_act as k7
    from bigdl_tpu_torch.ops import int8_conv as k6

    return dict(k6.LAUNCHES, **k6q.LAUNCHES, **k7.LAUNCHES)


def _reset_int8_launches():
    from bigdl_tpu_torch.ops import act_quant as k6q
    from bigdl_tpu_torch.ops import bn_act as k7
    from bigdl_tpu_torch.ops import int8_conv as k6

    for mod in (k6, k6q, k7):
        mod.reset_launch_counts()


def int8_resnet(card, quantizations):
    """(b) ResNet-50 (seed 0, the running statistics of one training
    forward) quantized by ``quantize_model`` and by ``quantize()`` on a
    copy (bitwise-equal logits), its fused eval plan's site counts, then
    batch 128 through ``Predictor`` and the compiled eval step (K6's, K7's
    and K6q's launches by route counted through the replays: 52 wgmma, 1
    gather, 49 K7 and ``quantizations``, K6q's a forward by route, a
    batch); held bitwise against the twin with every plain version (else
    the first layer that differs) and against the unfused twin with plain
    versions, and against the fp32 model (relative logit error, top-1
    agreement, the gate's details); images/s int8, fp32 and bf16, K6's,
    K6q's and K7's shares of the int8 forward and its device time by
    kind, the kernels of one replay against the same graph with the
    quantizer as PyTorch passes, the parameters' bytes, the packed weight
    copies' bytes and peak memory.  Returns the row, the models and the
    launches."""
    import copy

    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn import fused
    from bigdl_tpu_torch.nn import quantized as tq
    from bigdl_tpu_torch.ops import cross_entropy as ce
    from bigdl_tpu_torch.ops import flash_attention as fa

    model = ResNet(50, 1000, device="cuda", seed=0)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        model.train()(torch.from_numpy(rng.standard_normal(
            (4, RESNET_SIDE, RESNET_SIDE, 3), dtype=np.float32)).cuda())
    model.eval()
    xs = rng.standard_normal((INT8_PREDICT_IMAGES, RESNET_SIDE,
                              RESNET_SIDE, 3), dtype=np.float32)
    x = torch.from_numpy(xs[:RESNET_BATCH]).cuda()
    t0 = time.perf_counter()
    twin, qparams = tq.quantize_model(model)
    quantize_s = time.perf_counter() - t0
    legacy = copy.deepcopy(model).quantize()
    n_q = sum(type(m).__name__ == "QuantizedSpatialConvolution"
              for m in legacy.modules())
    with torch.no_grad():
        same_quantizers = bool(torch.equal(twin(x), legacy(x)))
    del legacy
    sites = fused.site_counts(twin)
    step = optim.compiled_eval_step(twin)
    step(x)                               # builds the graph
    # the main path: Predictor over 228 images (a full batch, then 100
    # padded to 128) through the compiled eval step
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ce.reset_launch_counts()
    _reset_int8_launches()
    preds = np.stack(optim.Predictor(twin, RESNET_BATCH).predict(list(xs)))
    torch.cuda.synchronize()
    launches = _int8_launches()
    peak = torch.cuda.max_memory_allocated()
    kernel_launches = sum(fa.LAUNCHES.values()) + sum(ce.LAUNCHES.values())
    got = torch.from_numpy(preds[:RESNET_BATCH])
    # the ragged batch against the twin's eager eval of the same padded
    # batch (the activation scale is taken over the padded rows too)
    tail = np.zeros((RESNET_BATCH, RESNET_SIDE, RESNET_SIDE, 3), np.float32)
    tail[:INT8_PREDICT_IMAGES - RESNET_BATCH] = xs[RESNET_BATCH:]
    with torch.no_grad():
        tail_eager = twin(torch.from_numpy(tail).cuda()).cpu()
    ragged = INT8_PREDICT_IMAGES - RESNET_BATCH
    tail_rel = rel_l2(torch.from_numpy(preds[RESNET_BATCH:]),
                      tail_eager[:ragged])
    with _plain_int8(), torch.no_grad():
        plain = twin(x).cpu()
        with fused.unfused():
            unfused_plain = twin(x).cpu()
    plain_equal = bool(torch.equal(got, plain))
    unfused_equal = bool(torch.equal(got, unfused_plain))
    first_diff = None if plain_equal else _first_int8_diff(twin, x)
    with torch.no_grad():
        fp32 = model(x).cpu()
    agree = float((fp32.argmax(-1) == got.argmax(-1)).float().mean())
    gate = optim.AccuracyDeltaGate(xs[:RESNET_BATCH],
                                   min_top1_agreement=INT8_GATE_TOP1,
                                   max_logit_rmse=INT8_GATE_RMSE)
    gate_ok, gate_detail = gate.check(lambda v: fp32, lambda v: got)
    rates = {"int8": _eval_rate(step, x)}
    # the fp32 and bf16 models keep their modules: no K7 launch
    k7_before = _int8_launches()["bn_act"]
    rates.update(fp32=_eval_rate(optim.compiled_eval_step(model), x),
                 bf16=_eval_rate(optim.compiled_eval_step(
                     model, torch.bfloat16), x))
    float_k7 = _int8_launches()["bn_act"] - k7_before
    busy_ms, shares, by_kind, replay = _device_share(lambda: step(x))
    # the same graph with the quantizer as PyTorch passes
    with _plain_int8(conv=False):
        torch_quant_step = optim.CompiledEvalStep(twin)
        torch_quant_step(x)
    torch_quant_busy, _, torch_quant_by_kind, torch_quant_replay = \
        _device_share(lambda: torch_quant_step(x))
    del torch_quant_step
    quant_passes = sorted({e.name for e in replay
                           if any(k in e.name for k in QUANT_PASS_KERNELS)})
    by_name = {name: sum(any(p in e.name for p in parts) for e in replay)
               for name, parts in INT8_KERNEL_NAMES.items()}
    # the profiler's names show which kernels ran; LAUNCHES counts them
    # exactly (a profile may miss a window's first few kernels)
    expected_names = {
        "int8_conv": RESNET_CONVS - 1, "int8_conv_gather": 1,
        "act_quant": quantizations.get("act_quant_given", 0) +
        quantizations.get("act_quant_small", 0) +
        2 * quantizations.get("act_quant", 0),
        "bn_act": RESNET_K7_SITES}
    want_launches = {"int8_conv": 2 * (RESNET_CONVS - 1),
                     "int8_conv_gather": 2, "bn_act": 2 * RESNET_K7_SITES,
                     **{route: 2 * quantizations.get(route, 0)
                        for route in ("act_quant", "act_quant_given",
                                      "act_quant_small")}}
    fp32_bytes = tq.model_bytes(model.parameters_tree())
    int8_bytes = tq.model_bytes(qparams)
    packed_bytes = tq.packed_weight_bytes(twin)   # beside the parameters
    row = {"phase": "int8_resnet", "batch": RESNET_BATCH,
           "quantized_convolutions": n_q, "quantize_model_s": quantize_s,
           "quantizers_bitwise_equal": same_quantizers,
           "launches": launches, "launches_expected": want_launches,
           "k6q_quantizations_a_forward": quantizations,
           "plan_sites": sites,
           "predict_batches": 2, "other_kernel_launches": kernel_launches,
           "ragged_batch_vs_eager_padded_rel_l2": tail_rel,
           "kernel_vs_plain_bitwise": plain_equal,
           "kernel_vs_plain_rel_l2": rel_l2(got, plain),
           "kernel_vs_plain_max_abs": float((got - plain).abs().max()),
           "kernel_vs_unfused_plain_bitwise": unfused_equal,
           "first_difference": first_diff,
           "vs_fp32_rel_l2": rel_l2(got, fp32),
           "vs_fp32_top1_agreement": agree, "gate_ok": gate_ok,
           "gate": gate_detail, "images_per_s": rates,
           "k7_launches_fp32_bf16_eval": float_k7,
           "int8_forward_device_ms": busy_ms,
           "k6_share": shares["int8_conv"] + shares["int8_conv_gather"],
           "k6q_share": shares["act_quant"], "k7_share": shares["bn_act"],
           "shares": shares,
           "int8_forward_ms_by_kind": by_kind,
           "replay_kernels": len(replay),
           "replay_kernels_pytorch_quantizer": len(torch_quant_replay),
           "pytorch_quantizer_forward_device_ms": torch_quant_busy,
           "pytorch_quantizer_ms_by_kind": torch_quant_by_kind,
           "quantizer_passes_in_replay": quant_passes,
           "replay_kernels_by_name": by_name,
           "replay_kernels_by_name_expected": expected_names,
           "model_bytes_fp32": fp32_bytes, "model_bytes_int8": int8_bytes,
           "bytes_ratio": fp32_bytes / int8_bytes,
           "packed_weight_bytes": packed_bytes,
           "int8_bytes_on_card": int8_bytes + packed_bytes,
           "bytes_ratio_on_card": fp32_bytes / (int8_bytes + packed_bytes),
           "peak_allocated_bytes": peak, "card": card}
    emit(row)
    if not (same_quantizers and n_q == RESNET_CONVS and
            tail_rel <= INT8_PLAIN_RTOL and plain_equal and unfused_equal and
            sites == {"fused_sites": RESNET_K7_SITES, "unfused_sites": 0} and
            sum(quantizations.values()) == RESNET_QUANTIZATIONS and
            float_k7 == 0 and
            quantizations.get("act_quant_given") == RESNET_GIVEN and
            launches == want_launches and
            all(0 < by_name[k] <= n for k, n in expected_names.items()) and
            not quant_passes and kernel_launches == 0 and gate_ok and
            fp32_bytes / int8_bytes >= 3.5 and packed_bytes > 0 and
            torch.isfinite(got).all() and got.shape == (RESNET_BATCH, 1000)):
        raise AssertionError(f"int8 ResNet-50: {row}")
    return row, model, twin, xs


def int8_serving(card, model, xs):
    """(c) ``ServingEngine(resnet50, quantize=True, accuracy_gate=...)``:
    8 ``predict`` requests one at a time, each against the twin's eager
    eval of the request padded to the rung it rode in (the activation
    scale is taken over the padded rows too), bitwise; K6's launches
    counted from the engine's construction (its gate) to its close, and
    K6q's."""
    from bigdl_tpu_torch.ops import cross_entropy as ce
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.serving.buckets import pad_batch_axis

    gate = {"features": xs[:8], "min_top1_agreement": INT8_GATE_TOP1,
            "max_logit_rmse": INT8_GATE_RMSE}
    fa.reset_launch_counts()
    ce.reset_launch_counts()
    _reset_int8_launches()
    t0 = time.perf_counter()
    served = []
    with ServingEngine(model, max_batch_size=8, quantize=True,
                       accuracy_gate=gate) as eng:
        start_s = time.perf_counter() - t0
        for i in range(INT8_SERVE_REQUESTS):
            req = xs[RESNET_BATCH + i]
            fut = eng.submit(req)
            served.append((req, fut.result(timeout=300), fut))
        twin, detail = eng._qmodel, eng._gate_detail
    torch.cuda.synchronize()
    launches = _int8_launches()
    other = sum(fa.LAUNCHES.values()) + sum(ce.LAUNCHES.values())
    mismatched = []
    for i, (req, got, fut) in enumerate(served):
        with torch.no_grad():
            want = twin(torch.from_numpy(pad_batch_axis(
                req[None], fut.bucket)).cuda())[0].cpu().numpy()
        if not np.array_equal(got, want):
            mismatched.append((i, float(np.abs(got - want).max())))
    results = [{"bucket": fut.bucket, "latency_s": fut.latency_s}
               for _, _, fut in served]
    row = {"phase": "int8_serving", "requests": INT8_SERVE_REQUESTS,
           "engine_start_s": start_s, "served": results,
           "mismatched": mismatched, "gate": detail,
           "launches": launches, "other_kernel_launches": other,
           "card": card}
    emit(row)
    # a forward each for the gate's batch and each request; the image, the
    # max-pool's output and the head's input take the small route or the
    # three-node route by their size, which the rung sets
    forwards = INT8_SERVE_REQUESTS + 1
    if mismatched or other or {k: launches[k] for k in (
            "int8_conv", "int8_conv_gather", "bn_act",
            "act_quant_given")} != {
            "int8_conv": (RESNET_CONVS - 1) * forwards,
            "int8_conv_gather": forwards,
            "bn_act": RESNET_K7_SITES * forwards,
            "act_quant_given": RESNET_GIVEN * forwards} or \
            launches["act_quant"] + launches["act_quant_small"] != \
            (RESNET_QUANTIZATIONS - RESNET_GIVEN) * forwards:
        raise AssertionError(f"int8 serving: {row}")
    return row


def _recipe_run(argv):
    """One ``resnet-imagenet-train`` run through ``models/run.py`` in bf16
    (the recipe has no dtype flag: the harness sets the optimizer's), with
    each step's throughput and data wait and a digest of each batch."""
    import hashlib

    from bigdl_tpu_torch.models import run
    from bigdl_tpu_torch.optim import local_optimizer as lo

    steps, digests = [], []
    build, log_progress = run._build_optimizer, lo.BaseOptimizer._log_progress
    stage = lo._Stager.stage

    def bf16_build(*a, **kw):
        return build(*a, **kw).set_compute_dtype(torch.bfloat16)

    def record(self, loss, throughput, data_wait_s, sync_skew=0):
        steps.append((throughput, data_wait_s))
        return log_progress(self, loss, throughput, data_wait_s, sync_skew)

    def digest(self, batch):
        x = batch.get_input()
        digests.append(hashlib.sha256(
            np.ascontiguousarray(x[:, ::7, ::7]).tobytes() +
            np.asarray(batch.get_target()).tobytes()).hexdigest()[:16])
        return stage(self, batch)

    run._build_optimizer, lo.BaseOptimizer._log_progress = bf16_build, record
    lo._Stager.stage = digest
    try:
        t0 = time.perf_counter()
        opt = run.main(["resnet-imagenet-train", "-b", str(RESNET_BATCH),
                        "--maxIteration", str(RECIPE_ITERS)] + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        run._build_optimizer, lo.BaseOptimizer._log_progress = \
            build, log_progress
        lo._Stager.stage = stage
    timed = steps[2:]                     # past the capture
    img_s = [t for t, _ in timed]
    share = [w * t / RESNET_BATCH for t, w in timed]
    return opt, {"argv": argv, "wall_s": wall, "neval":
                 opt.driver_state["neval"],
                 "images_per_s_median": float(np.median(img_s)),
                 "data_wait_share_median": float(np.median(share)),
                 "data_wait_ms_median": float(np.median(
                     [w for _, w in timed])) * 1e3,
                 "loss": opt.driver_state["loss"]}, digests


def recipe_services(card):
    """(d) ``resnet-imagenet-train`` (bf16, batch 128, 12 iterations)
    through ``models/run.py`` with neither flag, with ``--summaryDir``
    alone, and with ``--numWorkers 4 --queueDepth 4 --summaryDir``: the
    same batches in the same order, images/s and the data-wait share a
    step, 12 ``Loss``, ``Throughput`` and ``LearningRate`` points in the
    summary; then the ``g++``-built ``NativeBatcher``'s assembly rate
    for 128 x 224 x 224 x 3 batches against numpy's output."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.dataset import PrefetchDataSet
    from bigdl_tpu_torch.dataset import native_loader as nl
    from bigdl_tpu_torch.visualization import read_scalar

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_summaries_"))
    runs, digests = {}, {}
    try:
        for label, argv in (
                ("plain", []),
                ("summary", ["--summaryDir", str(root / "s")]),
                ("workers_summary", ["--numWorkers", "4", "--queueDepth",
                                     "4", "--summaryDir", str(root / "w")])):
            opt, runs[label], digests[label] = _recipe_run(argv)
            runs[label]["prefetch"] = isinstance(opt.dataset,
                                                 PrefetchDataSet)
            del opt
            gc.collect()
            torch.cuda.empty_cache()
        points = {tag: len(read_scalar(str(root / "w" / "bigdl_tpu" /
                                           "train"), tag))
                  for tag in ("Loss", "Throughput", "LearningRate",
                              "DataWaitSeconds")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same_order = digests["plain"] == digests["summary"] == \
        digests["workers_summary"]
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("bigdl-prefetch")]
    # the native batch assembler, built by g++ from native/
    pool = np.random.default_rng(5).standard_normal(
        (4 * RESNET_BATCH, RESNET_SIDE, RESNET_SIDE, 3), dtype=np.float32)
    labels = np.arange(len(pool), dtype=np.int32)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    batcher = nl.NativeBatcher(pool, labels, mean, std)
    idx = np.random.default_rng(6).permutation(len(pool))[:RESNET_BATCH]
    xb, yb = batcher.batch(idx)
    t0 = time.perf_counter()
    for _ in range(5):
        batcher.batch(idx)
    native_s = (time.perf_counter() - t0) / 5
    want = (pool[idx] - np.float32(mean)) / np.float32(std)
    native = {"library": None if batcher.lib is None else
              Path(batcher.lib._name).name,
              "threads": batcher.n_threads, "batch_s": native_s,
              "gb_per_s": xb.nbytes / native_s / 1e9,
              "max_rel_err_vs_numpy": float(np.abs(xb - want).max() /
                                            np.abs(want).max()),
              "labels_equal": bool(np.array_equal(yb, labels[idx]))}
    row = {"phase": "recipe_services", "runs": runs,
           "same_batch_order": same_order, "summary_points": points,
           "prefetch_threads_left": alive, "native_batcher": native,
           "summary_cost_share": 1.0 - runs["summary"]["images_per_s_median"]
           / runs["plain"]["images_per_s_median"], "card": card}
    emit(row)
    if not same_order or alive or batcher.lib is None or \
            not native["labels_equal"] or \
            native["max_rel_err_vs_numpy"] > 1e-6 or \
            not runs["workers_summary"]["prefetch"] or \
            any(r["neval"] != RECIPE_ITERS + 1 for r in runs.values()) or \
            any(points[t] != RECIPE_ITERS for t in
                ("Loss", "Throughput", "LearningRate")):
        raise AssertionError(f"recipe services: {row}")
    return row


SUPERVISED_CHILD = '''
import sys

import numpy as np
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.models import ResNetCifar
from bigdl_tpu_torch.optim import ChaosKillTrigger
from bigdl_tpu_torch.visualization import TrainSummary

ckpt, chaos, out, steps, every, device = (
    sys.argv[1], int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
    int(sys.argv[5]), sys.argv[6])
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.allow_tf32 = False
rng = np.random.default_rng(8)
x = rng.standard_normal((256, 32, 32, 3)).astype(np.float32)
y = rng.integers(0, 10, 256).astype(np.int32)
model = ResNetCifar(20, device=device, seed=0)
opt = optim.Optimizer(model, array_dataset(x, y) >> SampleToMiniBatch(64),
                      nn.CrossEntropyCriterion(),
                      optim.SGD(learning_rate=0.05, momentum=0.9,
                                dampening=0.0), device=device)
end = optim.Trigger.max_iteration(steps)
if chaos:
    end = optim.Trigger.or_(ChaosKillTrigger(chaos), end)
opt.set_end_when(end)
if ckpt != "-":
    opt.set_train_summary(TrainSummary(ckpt, "child"))
    opt.set_checkpoint(ckpt, optim.Trigger.several_iteration(every))
    opt.resume_from_checkpoint()
opt.optimize()
torch.save({"neval": opt.driver_state["neval"],
            "params": {k: v.cpu() for k, v in model.named_parameters()},
            "buffers": {k: v.cpu() for k, v in model.named_buffers()}}, out)
'''


def supervisor_drill(card):
    """(e) ``RunSupervisor.run_process``: a child training ``ResNetCifar(20)``
    on the card (``cudnn.deterministic``, a checkpoint every 2 iterations)
    is SIGKILLed by ``ChaosKillTrigger(5)`` on its first attempt,
    restarted from its last snapshot and finishes at step 10; its
    parameters and running statistics against a straight run in another
    child (``RESUME_RTOL``), and the recovery event."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.optim import RunSupervisor
    from bigdl_tpu_torch.visualization import read_scalar

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_supervisor_"))
    script = root / "child.py"
    script.write_text(SUPERVISED_CHILD)
    ckpt = root / "ckpt"
    ckpt.mkdir()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    procs = []

    def launch(ckpt_dir, chaos, out):
        proc = subprocess.Popen(
            [sys.executable, str(script), str(ckpt_dir), str(chaos),
             str(out), str(SUP_STEPS), str(SUP_EVERY), SUP_DEVICE], env=env)
        procs.append(proc)
        return proc

    def probe():
        done = read_scalar(str(ckpt / "child" / "train"), "Loss")
        return max(s for s, _, _ in done) + 1 if done else None

    try:
        t0 = time.perf_counter()
        sup = RunSupervisor(max_restarts=2, backoff_base_s=0.5)
        restarts = sup.run_process(
            lambda attempt: launch(ckpt, SUP_CHAOS if attempt == 0 else 0,
                                   root / "resumed.pt"),
            checkpoint_path=str(ckpt), probe_step=probe)
        supervised_s = time.perf_counter() - t0
        rcs = [p.returncode for p in procs]
        t0 = time.perf_counter()
        straight_rc = launch("-", 0, root / "straight.pt").wait()
        straight_s = time.perf_counter() - t0
        a = torch.load(root / "straight.pt")
        b = torch.load(root / "resumed.pt")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    p_rel = _global_rel(b["params"], a["params"])
    s_rel = _global_rel(b["buffers"], a["buffers"])
    event = sup.events[0] if sup.events else None
    row = {"phase": "supervisor", "restarts": restarts, "child_rcs": rcs,
           "straight_rc": straight_rc, "event": event,
           "resumed_neval": b["neval"], "params_rel_l2": p_rel,
           "buffers_rel_l2": s_rel, "bitwise_equal": p_rel == 0 and
           s_rel == 0, "tolerance": RESUME_RTOL,
           "supervised_s": supervised_s, "straight_s": straight_s,
           "card": card}
    emit(row)
    if restarts != 1 or rcs[0] != -9 or rcs[1] != 0 or straight_rc != 0 or \
            b["neval"] != SUP_STEPS + 1 or event["cause"] != \
            "process_death" or p_rel > RESUME_RTOL or s_rel > RESUME_RTOL:
        raise AssertionError(f"supervisor: {row}")
    return row


def int8_phase(card):
    """Phase 13 (module docstring): K6's, K7's and K6q's rows, int8
    ResNet-50, serving, the recipe's host services and the supervisor.
    Returns the rows the kernel line reports and the main path's K6, K7
    and K6q launches by leg."""
    t0 = time.perf_counter()
    conv_rows = int8_conv_rows(card)
    k7_sites, quant_sites, quantizations, k7_launches = \
        resnet50_fused_sites()
    emit({"phase": "int8_fused_sites", "k7_sites": [
        [str(shape), K7_FORMS[form]] for shape, form in k7_sites],
        "k6q_sites": [[str(shape), route] for shape, route in quant_sites],
        "k6q_quantizations_a_forward": quantizations,
        "k7_launches_a_forward": k7_launches, "card": card})
    if k7_launches != RESNET_K7_SITES:
        raise AssertionError(f"K7 sites a forward: {k7_launches}")
    k7_rows = dict(bn_act_row(card, (RESNET_BATCH,) + shape[1:], form, i)
                   for i, (shape, form) in enumerate(k7_sites))
    torch.cuda.empty_cache()
    quant_rows = act_quant_rows(card, [((RESNET_BATCH,) + shape[1:], route)
                                       for shape, route in quant_sites])
    resnet, model, twin, xs = int8_resnet(card, quantizations)
    del twin
    serving = int8_serving(card, model, xs)
    del model, xs
    gc.collect()
    torch.cuda.empty_cache()
    recipe_services(card)
    supervisor_drill(card)
    emit({"phase": "int8_phase_done", "seconds": time.perf_counter() - t0,
          "card": card})
    rows = {"int8_conv": conv_rows[INT8_CONV_KEY_ROW],
            "int8_conv_gather": conv_rows[INT8_GATHER_KEY_ROW],
            "bn_act": k7_rows[BN_ACT_KEY_ROW],
            **{route: quant_rows[(shape, route)]
               for route, shape in ACT_QUANT_KEY_ROWS.items()}}
    return rows, {"int8_resnet": resnet["launches"],
                  "int8_resnet_serving": serving["launches"]}


# --------------------------------------------------------------------------- #
# Phase 14: the serving engine's predict graphs, staging and the service
# --------------------------------------------------------------------------- #

#: (a) int8 ResNet-50's engine: its largest rung, the requests of the
#: mixed bursts and the threads sending them, the burst sizes each thread
#: cycles through, and the sequential calls of the batch-1 timing
ENGINE_RESNET_MAX_BATCH = 32
ENGINE_REQUESTS, ENGINE_THREADS = 64, 8
ENGINE_BURSTS = (1, 3, 4)
ENGINE_B1_CALLS = 50
#: the served-rate windows after each engine's checked main path: int8
#: ResNet-50's requests (its 64 images in turn) and each LM engine's (its
#: request lengths in turn), a few seconds each; and the sequential calls
#: that time each part of one tick at a rung
ENGINE_RATE_REQUESTS, ENGINE_LM_RATE_REQUESTS = 4096, 320
ENGINE_TICK_CALLS = 20
#: (b) TransformerLM "small"'s engines: the length ladder's rungs (64,
#: 128, 256, 512, 1024), the largest batch rung, the request lengths
#: (two of each, mixed over the rungs) and (e)'s service requests
ENGINE_LENGTHS = (64, 1024)
ENGINE_LM_MAX_BATCH = 4
ENGINE_LM_REQUEST_LENGTHS = (17, 64, 100, 200, 300, 513, 700, 1000) * 2
ENGINE_SERVICE_REQUESTS, ENGINE_SERVICE_LEN = 16, 128
#: (d) the shared prefix of the two generations and their new tokens
ENGINE_PREFIX, ENGINE_NEW = 256, 16
#: (c) the fp32 and bf16 ResNet-50 engines' logits after a commit against
#: the candidate's eager eval, relative to the largest logit (a capture may
#: pick other cuBLAS algorithms for the head; the check that holds the
#: commit is bitwise against the candidate's own graph)
ENGINE_EAGER_RTOL = {None: 1e-5, torch.bfloat16: 2e-2}


def _resnet50_with_stats(seed):
    """ResNet-50 (1000 classes) from ``seed`` on the card in eval mode,
    its running statistics those of one training forward on 4 images."""
    from bigdl_tpu_torch.models import ResNet

    model = ResNet(50, 1000, device="cuda", seed=seed)
    rng = np.random.default_rng(100 + seed)
    with torch.no_grad():
        model.train()(torch.from_numpy(rng.standard_normal(
            (4, RESNET_SIDE, RESNET_SIDE, 3), dtype=np.float32)).cuda())
    return model.eval()


def _padded(x, bucket):
    batch = np.zeros((bucket,) + x.shape, x.dtype)
    batch[0] = x
    return batch


def _eager_rows(model, batch, dtype=None):
    """``model``'s eager eval of a padded numpy batch, numpy out."""
    from bigdl_tpu_torch import optim

    out = optim.make_eval_step(model, dtype)(torch.from_numpy(batch).cuda())
    return out.cpu().numpy()


def _max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _median_ms(fn, calls):
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def _mixed_bursts(eng, features, threads=ENGINE_THREADS, keep=True):
    """``features`` sent from ``threads`` threads, each cycling bursts of
    ``ENGINE_BURSTS`` requests (submitted together, then awaited); returns
    ``(result, bucket)`` a request, in order (the result None unless
    ``keep``), and the wall seconds."""
    out = [None] * len(features)
    errors = []

    def worker(k):
        mine = list(range(k, len(features), threads))
        i = 0
        try:
            while i < len(mine):
                size = ENGINE_BURSTS[(k + i) % len(ENGINE_BURSTS)]
                burst = mine[i:i + size]
                futs = [(j, eng.submit(features[j])) for j in burst]
                for j, fut in futs:
                    y = fut.result(timeout=600)
                    out[j] = (y if keep else None, fut.bucket)
                i += size
        except Exception as e:            # re-raised on the main thread
            errors.append(e)

    workers = [threading.Thread(target=worker, args=(k,))
               for k in range(threads)]
    t0 = time.perf_counter()
    for t in workers:
        t.start()
    for t in workers:
        t.join(900)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in workers):
        raise AssertionError(f"mixed bursts failed: {errors}")
    return out, wall


def _settle(eng, timeout=60.0):
    """Wait until ``eng`` holds no request and runs no tick: a tick's
    shadow runs after its results are delivered, inside the tick."""
    deadline = time.perf_counter() + timeout
    while True:
        st = eng.stats()
        if not (st["pending"] or st["in_tick"]):
            return
        if time.perf_counter() > deadline:
            raise AssertionError(f"engine still busy: {st}")
        time.sleep(0.001)


def _rate_window(eng, features):
    """The served rate over ``features`` in mixed bursts from
    ``ENGINE_THREADS`` threads, the results dropped as they come (no
    shadow, no check): requests/s, the wall seconds, the ticks and the
    rungs they rode."""
    before = eng.stats()["ticks"]
    out, wall = _mixed_bursts(eng, features, keep=False)
    ticks = eng.stats()["ticks"] - before
    return {"requests": len(features), "wall_s": wall,
            "requests_per_s": len(features) / wall, "ticks": ticks,
            "requests_per_tick": len(features) / max(ticks, 1),
            "request_buckets": collections.Counter(b for _, b in out)}


def _tick_breakdown(eng, batch, calls=ENGINE_TICK_CALLS):
    """One tick's parts at ``batch``'s rung, host-clock medians of
    ``calls`` calls (median, min, max ms), each synced: the pageable copy
    of the padded batch to the card, the replay alone (its input already
    there), the copy of its output to the host, and the engine's whole
    eval of the batch (the three in turn, under the step's lock)."""
    step = eng._backend.step
    xd = torch.as_tensor(batch, device="cuda")

    def copy_in():
        torch.as_tensor(batch, device="cuda")
        torch.cuda.synchronize()

    def replay():
        with step.lock:
            step(xd)
            torch.cuda.synchronize()

    with step.lock:
        out = step(xd)
        torch.cuda.synchronize()
        copy_out = _median_ms(lambda: out.cpu(), calls)
    return {"rung": list(batch.shape[:2]), "bytes_in": batch.nbytes,
            "bytes_out": out.numel() * out.element_size(),
            "copy_in_ms": _median_ms(copy_in, calls),
            "replay_ms": _median_ms(replay, calls),
            "copy_out_ms": copy_out,
            "eval_ms": _median_ms(lambda: eng._backend.eval(batch), calls)}


def _plain_int8_rows(twin, batch):
    """The int8 twin's eval of a numpy batch with every int8 layer through
    its plain version (K6's, K7's and K6q's), numpy out."""
    with _plain_int8(), torch.no_grad():
        return twin(torch.from_numpy(batch).cuda()).cpu().numpy()


def _first_int8_diff(twin, x):
    """The first convolution whose output differs between the kernels and
    the plain versions on the card tensor ``x``, with its largest
    difference, or None."""
    kernel_outs = _conv_outputs(twin, x)
    with _plain_int8():
        plain_outs = _conv_outputs(twin, x)
    for name, o in kernel_outs.items():
        d = float((o - plain_outs[name]).abs().max())
        if d:
            return {"layer": name, "max_abs": d}
    return None


def engine_int8(card):
    """(a) ``ServingEngine(resnet50, quantize=True, accuracy_gate=...,
    max_batch_size=32)``: ``precompile`` captures a graph a rung; 64
    requests in mixed bursts from 8 threads (the main path: K6, K7 and
    K6q launches counted through its replays) capture nothing; every
    tick's outputs are bitwise a replay of its padded batch, the twin's
    eager eval of it and the twin's eval with every int8 layer through
    its plain version (the kernels held at the shapes the main path gave
    them; a replay at each rung too), and a request that rode alone is
    bitwise ``predict_at``; one replay's K6, K7 and K6q launches; the
    batch-1 request time through the replayed graph against the twin's
    eager eval, the old ``predict`` path; the served rate over
    ``ENGINE_RATE_REQUESTS`` requests, and one tick's copies against its
    replay at each rung.  Returns the engine, its model, the images, the
    row and the main path's launches."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.ops import cross_entropy as ce
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.serving import ServingEngine

    model = _resnet50_with_stats(0)
    rng = np.random.default_rng(14)
    images = rng.standard_normal((ENGINE_REQUESTS + 8, RESNET_SIDE,
                                  RESNET_SIDE, 3), dtype=np.float32)
    gate = {"features": images[-8:], "min_top1_agreement": INT8_GATE_TOP1,
            "max_logit_rmse": INT8_GATE_RMSE}
    t0 = time.perf_counter()
    eng = ServingEngine(model, quantize=True, accuracy_gate=gate,
                        max_batch_size=ENGINE_RESNET_MAX_BATCH)
    start_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    built = eng.precompile(example_feature=images[0])
    precompile_s = time.perf_counter() - t0
    step_stats = eng._backend.step.stats()
    if built != len(eng.ladder) or eng.executables() != built:
        raise AssertionError(f"int8 engine: precompile built {built}, "
                             f"ladder {list(eng.ladder)}")
    ticks = []
    eng.set_shadow(lambda x, y, bucket, n, tick:
                   ticks.append((x, y, bucket, n)), 1.0)
    feats = list(images[:ENGINE_REQUESTS])
    gc.collect()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    ce.reset_launch_counts()
    _reset_int8_launches()
    # ---- the int8 engine's main path: counts read right after it ------
    served, wall = _mixed_bursts(eng, feats)
    _settle(eng)
    torch.cuda.synchronize()
    launches = _int8_launches()
    other = sum(fa.LAUNCHES.values()) + sum(ce.LAUNCHES.values())
    # ---------------------------------------------------------------------
    eng.set_shadow(None)
    replays = len(ticks)
    twin = eng._qmodel
    tick_mismatch, alone_mismatch, alone, shared_equal = [], [], 0, 0
    plain_mismatch = []
    row_of = {x[i].tobytes(): (t, i) for t, (x, _, _, n) in enumerate(ticks)
              for i in range(n)}
    for t, (x, y, bucket, n) in enumerate(ticks):
        again = eng._backend.eval(x)
        eager = _eager_rows(twin, x)
        if not (np.array_equal(again, y) and np.array_equal(eager, y)):
            tick_mismatch.append((t, bucket, _max_rel(eager, y)))
        if not np.array_equal(_plain_int8_rows(twin, x), y):
            plain_mismatch.append({"tick": t, "bucket": bucket,
                                   "first": _first_int8_diff(
                                       twin, torch.from_numpy(x).cuda())})
    # every rung's replay, full of images, against the plain versions
    for b in eng.ladder:
        x = np.ascontiguousarray(images[:b])
        if not np.array_equal(_plain_int8_rows(twin, x),
                              eng._backend.eval(x)):
            plain_mismatch.append({"rung": b, "first": _first_int8_diff(
                twin, torch.from_numpy(x).cuda())})
    for j, (y, bucket) in enumerate(served):
        t, i = row_of[feats[j].tobytes()]
        at = eng.predict_at(feats[j], bucket)
        if ticks[t][3] == 1:
            alone += 1
            if not np.array_equal(y, at):
                alone_mismatch.append(j)
        else:
            shared_equal += bool(np.array_equal(y, at))
        if not np.array_equal(y, ticks[t][1][i]):
            tick_mismatch.append(("row", j))
    _reset_int8_launches()
    eng.predict_at(images[0], 1)
    torch.cuda.synchronize()
    one = _int8_launches()
    per_replay = {"int8_conv": one["int8_conv"] + one["int8_conv_gather"],
                  "bn_act": one["bn_act"],
                  "act_quant": one["act_quant"] + one["act_quant_given"]
                  + one["act_quant_small"]}
    # the batch-1 request: the engine's predict (queue, max_wait_ms, the
    # replay, the copy to the host), predict_at (the replay and the copy)
    # and the twin's eager eval of the same padded request (the old path)
    x1 = images[1]
    eager_step = optim.make_eval_step(twin)
    torch.cuda.synchronize()
    b1 = {"predict": _median_ms(lambda: eng.predict(x1), ENGINE_B1_CALLS),
          "predict_at": _median_ms(lambda: eng.predict_at(x1, 1),
                                   ENGINE_B1_CALLS),
          "eager": _median_ms(
              lambda: eager_step(torch.from_numpy(x1[None]).cuda())
              .cpu().numpy(), ENGINE_B1_CALLS)}
    # the served rate over a window of seconds, then a tick's parts
    rate = _rate_window(eng, [images[j % ENGINE_REQUESTS]
                              for j in range(ENGINE_RATE_REQUESTS)])
    ticks_parts = [_tick_breakdown(eng, np.ascontiguousarray(images[:b]))
                   for b in eng.ladder]
    captured_after = eng.executables() - built
    row = {"phase": "engine_int8_resnet50", "engine_start_s": start_s,
           "precompile_s": precompile_s, "ladder": list(eng.ladder),
           "captured": built, "captured_after_precompile": captured_after,
           "graph_pool_bytes": step_stats["pool_bytes"],
           "requests": ENGINE_REQUESTS, "threads": ENGINE_THREADS,
           "bursts": ENGINE_BURSTS, "wall_s": wall,
           "requests_per_s": ENGINE_REQUESTS / wall, "ticks": replays,
           "tick_buckets": collections.Counter(b for _, _, b, _ in ticks),
           "tick_mismatch": tick_mismatch,
           "plain_mismatch": plain_mismatch,
           "rungs_held_against_plain": list(eng.ladder),
           "rate_window": rate, "tick_parts": ticks_parts,
           "requests_alone": alone,
           "alone_mismatch": alone_mismatch,
           "shared_tick_requests_equal_to_predict_at": shared_equal,
           "launches": launches, "other_kernel_launches": other,
           "launches_one_replay": per_replay,
           "batch1_ms_median_min_max": b1, "max_wait_ms":
           eng.max_wait_s * 1e3, "gate": eng._gate_detail, "card": card}
    emit(row)
    want_path = {"int8_conv": (RESNET_CONVS - 1) * replays,
                 "int8_conv_gather": replays,
                 "bn_act": RESNET_K7_SITES * replays,
                 "act_quant_given": RESNET_GIVEN * replays}
    if captured_after or tick_mismatch or plain_mismatch or \
            alone_mismatch or other or \
            {k: launches[k] for k in want_path} != want_path or \
            launches["act_quant"] + launches["act_quant_small"] != \
            (RESNET_QUANTIZATIONS - RESNET_GIVEN) * replays or \
            per_replay != {"int8_conv": RESNET_CONVS,
                           "bn_act": RESNET_K7_SITES,
                           "act_quant": RESNET_QUANTIZATIONS} or \
            any(not np.isfinite(y).all() or y.shape != (1000,)
                for y, _ in served):
        raise AssertionError(f"int8 engine: {row}")
    return eng, model, images, row, launches


def _commit_check(eng, label, cand_eval, x, bucket, dtype, card):
    """Stage ``cand_eval``'s model as the candidate, commit it, hold the
    replay against the candidate's own graph (bitwise) and its eager
    eval, roll back through a captured handle (bitwise); the commit's
    time."""
    batch = _padded(x, bucket)
    y0 = eng.predict_at(x, bucket)
    execs = eng._executables()
    back = eng.capture_staged()
    cand = cand_eval["ref"]
    t0 = time.perf_counter()
    h = eng.stage_weights(cand.parameters_tree(), cand.state_tree())
    stage_s = time.perf_counter() - t0
    staged_y = eng.eval_staged(h, batch)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.commit_staged(h)
    commit_s = time.perf_counter() - t0
    got = eng.predict_at(x, bucket)
    eager = _eager_rows(cand_eval["eval"], batch, dtype)[0]
    t0 = time.perf_counter()
    eng.commit_staged(back)
    rollback_s = time.perf_counter() - t0
    rolled = eng.predict_at(x, bucket)
    row = {"phase": "engine_commit", "engine": label, "bucket": bucket,
           "stage_s": stage_s, "commit_s": commit_s,
           "rollback_s": rollback_s,
           "staged_captures": h["staged"].step.executables(),
           "staged_pool_bytes": h["staged"].step.stats()["pool_bytes"],
           "committed_equals_staged_graph": bool(np.array_equal(got,
                                                               staged_y)),
           "committed_equals_eager": bool(np.array_equal(got, eager)),
           "committed_vs_eager_rel": _max_rel(got, eager),
           "changed": not bool(np.array_equal(got, y0)),
           "rollback_bitwise": bool(np.array_equal(rolled, y0)),
           "captured_on_live_step": eng._executables() - execs,
           "card": card}
    emit(row)
    bitwise_eager = dtype is None and eng.quantized
    if not (row["committed_equals_staged_graph"] and row["changed"]
            and row["rollback_bitwise"] and not row["captured_on_live_step"]
            and (row["committed_equals_eager"] if bitwise_eager else
                 row["committed_vs_eager_rel"] <= ENGINE_EAGER_RTOL[dtype])):
        raise AssertionError(f"commit on the {label} engine: {row}")
    return h, row


def engine_staging(card, eng, model, images):
    """(c) staging on (a)'s engine (a candidate from seed 1): the staged
    eval bitwise the candidate twin's eager eval; a canary of 0.25 serving
    1 tick in 4 on it; a commit making the replay bitwise the candidate
    twin's eager eval (so K6's packed copies were re-packed in place);
    the captured handle rolling back bitwise; a truncated tree refused by
    ``refresh_params`` with the outputs unchanged; ``refresh_from_snapshot``
    of a checkpoint the port's ``LocalOptimizer`` wrote; the commit check
    again on an fp32 and a bf16 engine (the compute copy re-cast in
    place)."""
    import shutil
    import tempfile

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.nn import quantized as tq
    from bigdl_tpu_torch.optim.train_step import compute_copy
    from bigdl_tpu_torch.serving import ServingEngine

    cand = _resnet50_with_stats(1)
    cand_twin = tq.quantize_model(cand)[0]
    x = images[2]
    h, commit = _commit_check(eng, "int8", {"ref": cand, "eval": cand_twin},
                              x, 4, None, card)
    staged = eng.eval_staged(h, _padded(x, 4))[0]
    want = _eager_rows(cand_twin, _padded(x, 4))[0]
    # the canary: 8 sequential requests, each its own tick of rung 1
    live1 = eng.predict_at(x, 1)
    cand1 = eng.eval_staged(h, _padded(x, 1))[0]
    eng.set_canary(h, 0.25, version=2)
    outs = [eng.predict(x) for _ in range(8)]
    canary = eng.canary_stats()
    eng.set_canary(None)
    on_cand = sum(np.array_equal(o, cand1) for o in outs)
    on_live = sum(np.array_equal(o, live1) for o in outs)
    # a half-written tree: refused, nothing changes
    y0 = eng.predict_at(x, 4)
    params = model.parameters_tree()
    truncated = {k: v for k, v in params.items() if k != list(params)[-1]}
    try:
        eng.refresh_params(truncated)
        refused = None
    except ValueError as e:
        refused = str(e)[:200]
    unchanged = bool(np.array_equal(eng.predict_at(x, 4), y0))
    # a checkpoint the port's LocalOptimizer wrote: one SGD step of
    # another ResNet-50 on 2 images, its snapshot at neval 2
    trained = _resnet50_with_stats(2)
    rng = np.random.default_rng(15)
    xt = rng.standard_normal((2, RESNET_SIDE, RESNET_SIDE, 3),
                             dtype=np.float32)
    yt = rng.integers(0, 1000, 2)
    ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_engine_"))
    try:
        opt = optim.Optimizer(
            trained, array_dataset(xt, yt, shuffle_on_epoch=False) >>
            SampleToMiniBatch(2), nn.CrossEntropyCriterion(),
            optim.SGD(learning_rate=1e-3))
        opt.set_end_when(optim.Trigger.max_iteration(1))
        opt.set_checkpoint(str(ckpt), optim.Trigger.several_iteration(2))
        opt.optimize()
        snaps = sorted(os.listdir(ckpt))
        t0 = time.perf_counter()
        eng.refresh_from_snapshot(str(ckpt))
        refresh_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    trained.eval()
    got = eng.predict_at(x, 4)
    want_trained = _eager_rows(tq.quantize_model(trained)[0],
                               _padded(x, 4))[0]
    row = {"phase": "engine_staging", "staged_equals_eager_twin":
           bool(np.array_equal(staged, want)),
           "canary_stats": canary, "canary_outputs_on_candidate": on_cand,
           "canary_outputs_on_live": on_live, "truncated_refused": refused,
           "outputs_unchanged_after_refusal": unchanged,
           "snapshot_files": snaps, "refresh_from_snapshot_s": refresh_s,
           "refreshed_equals_eager_twin": bool(np.array_equal(
               got, want_trained)), "gate": eng._gate_detail, "card": card}
    emit(row)
    if not (row["staged_equals_eager_twin"] and canary["ticks"] == 2
            and canary["failures"] == 0 and on_cand == 2 and on_live == 6
            and refused and unchanged
            and row["refreshed_equals_eager_twin"]):
        raise AssertionError(f"int8 staging: {row}")
    del h
    commits = {"int8": commit}
    for dtype, label in ((None, "fp32"), (torch.bfloat16, "bf16")):
        with ServingEngine(model, max_batch_size=4,
                           compute_dtype=dtype) as other:
            other.precompile(example_feature=images[0])
            ref_eval = cand if dtype is None else compute_copy(cand, dtype)
            _, commits[label] = _commit_check(
                other, label, {"ref": cand, "eval": ref_eval}, x, 4, dtype,
                card)
        del ref_eval
    gc.collect()
    torch.cuda.empty_cache()
    return row, commits


def _lm_requests(seed, lengths):
    from bigdl_tpu_torch.models import synthetic_corpus

    toks, _ = synthetic_corpus(len(lengths), max(lengths), SERVE_VOCAB,
                               seed=seed)
    return [toks[i, :n].astype(np.int32) for i, n in enumerate(lengths)]


def engine_lm(card, model, plain_model, dtype, engine_kw):
    """(b) TransformerLM "small" through an engine with the length ladder
    (fp32, or ``compute_dtype``): ``precompile`` captures batch rungs x
    length rungs (plus generation's, fp32); mixed lengths from 8 threads
    capture none (the main path: K1 counted through its replays); each
    result is bitwise ``predict_at`` of its request zero-padded to the
    result's length rung, at its tick's batch rung; one replay launches K1
    once a layer; K1 held against its plain version at every (batch rung,
    length rung) the engine's graphs run it at; a request against the
    plain model (fp32); the served rate over ``ENGINE_LM_RATE_REQUESTS``
    requests, and one tick's copies against its replay at the smallest
    and the largest rung.  Returns the engine, the row and the main
    path's launches."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.serving import BucketLadder, ServingEngine

    label = "bf16" if dtype else "fp32"
    ladder = BucketLadder(ENGINE_LENGTHS[1], min_size=ENGINE_LENGTHS[0])
    t0 = time.perf_counter()
    eng = ServingEngine(model, max_batch_size=ENGINE_LM_MAX_BATCH,
                        length_ladder=ladder, compute_dtype=dtype,
                        **engine_kw)
    reqs = _lm_requests(20, ENGINE_LM_REQUEST_LENGTHS)
    built = eng.precompile(example_feature=reqs[0])
    precompile_s = time.perf_counter() - t0
    predict_built = eng._executables()
    step_stats = eng._backend.step.stats()
    gen = eng.stats().get("generate", {}).get("graphs", {})
    execs = eng.executables()
    gc.collect()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    # ---- the LM engine's main path: counts read right after it --------
    served, wall = _mixed_bursts(eng, reqs)
    torch.cuda.synchronize()
    bf16_k1 = fa.BF16_LAUNCHES["flash_attention"]
    fp32_k1 = fa.LAUNCHES["flash_attention"] - bf16_k1
    k1 = {kernel_key("flash_attention", dtype):
          bf16_k1 if dtype else fp32_k1}
    k1_other = fp32_k1 if dtype else bf16_k1
    # ---------------------------------------------------------------------
    mismatched = []
    for j, (y, bucket) in enumerate(served):
        x = np.zeros(y.shape[0], np.int32)
        x[:len(reqs[j])] = reqs[j]
        if not np.array_equal(y, eng.predict_at(x, bucket)) or \
                not np.isfinite(y).all():
            mismatched.append(j)
    fa.reset_launch_counts()
    eng.predict_at(reqs[0], 1)
    torch.cuda.synchronize()
    one = fa.BF16_LAUNCHES["flash_attention"] if dtype \
        else fa.LAUNCHES["flash_attention"]
    plain_rel = None
    if dtype is None:
        n = len(reqs[2])
        with torch.no_grad():
            want = plain_model(torch.from_numpy(reqs[2][None]).cuda())[0]
        got = eng.predict_at(reqs[2], 1)[:n]
        plain_rel = _max_rel(got, want.cpu().numpy())
    # K1 at every shape the graphs run it at, on random q, k, v views of
    # one fused qkv buffer in the engine's dtype
    g = torch.Generator(device="cuda").manual_seed(16)
    tol = BF16_TOL if dtype else ATOL
    k1_err = {}
    for b in eng.ladder:
        for t in eng.length_ladder:
            qkv = torch.randn(b, t, 3 * HEADS * HEAD_DIM, generator=g,
                              device="cuda").to(dtype or torch.float32)
            q, k, v = (a.unflatten(-1, (HEADS, HEAD_DIM))
                       for a in qkv.split(HEADS * HEAD_DIM, dim=-1))
            k1_err[f"B{b}_T{t}"] = check_close(
                f"flash_attention {label} B{b} T{t}",
                fa.flash_attention(q, k, v, causal=True),
                fa.flash_attention_reference(q, k, v, causal=True), tol, tol)
    del qkv, q, k, v
    # the served rate over a window of seconds, then a tick's parts
    rate = _rate_window(eng, [reqs[j % len(reqs)]
                              for j in range(ENGINE_LM_RATE_REQUESTS)])
    parts = []
    rungs, lengths = list(eng.ladder), list(eng.length_ladder)
    for b, t in ((rungs[0], lengths[0]), (rungs[-1], lengths[-1])):
        parts.append(_tick_breakdown(eng, np.stack(_lm_requests(25,
                                                                (t,) * b))))
    captured_after = eng.executables() - execs
    combos = len(eng.ladder) * len(eng.length_ladder)
    row = {"phase": "engine_lm", "dtype": label, "ladder": list(eng.ladder),
           "length_ladder": list(eng.length_ladder), "captured": built,
           "predict_captured": predict_built, "batch_x_length_rungs": combos,
           "generation_captured": gen.get("captured", 0),
           "precompile_s": precompile_s,
           "captured_after_precompile": captured_after,
           "predict_graph_pool_bytes": step_stats["pool_bytes"],
           "requests": len(reqs), "wall_s": wall,
           "requests_per_s": len(reqs) / wall, "rate_window": rate,
           "tick_parts": parts, "k1_vs_plain_max_abs": k1_err,
           "k1_tolerance": tol,
           "result_lengths": sorted({y.shape[0] for y, _ in served}),
           "mismatched": mismatched, "launches": k1,
           "other_k1_launches": k1_other, "k1_one_replay": one,
           "vs_plain_model_rel": plain_rel, "card": card}
    emit(row)
    from bigdl_tpu_torch.nn.attention import MultiHeadAttention

    layers = sum(isinstance(m, MultiHeadAttention) for m in model.modules())
    if predict_built != combos or captured_after or mismatched or \
            one != layers or k1_other or not next(iter(k1.values())) or \
            (plain_rel is not None and plain_rel > RTOL):
        raise AssertionError(f"LM engine ({label}): {row}")
    return eng, row, k1


def engine_swap_generation(card, eng, model, images_unused=None):
    """(d) generation on (b)'s fp32 engine across a commit: a prompt with
    a shared prefix leaves cached blocks; a candidate (seed 1) is
    committed (the cache flushed, no hit after it); the next prompt's
    greedy stream equals a fresh engine's on the candidate, except at a
    near-tie (``TIE_MARGIN``, the candidate's plain model); the predict
    replay is bitwise the candidate's own graph and rolls back bitwise;
    the memory ledger's snapshot.  Returns the row and the main path's
    launches (the generation after the commit)."""
    from bigdl_tpu_torch.models import transformer_lm
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.serving import ServingEngine

    prefix = _lm_requests(21, (ENGINE_PREFIX,))[0]
    tails = _lm_requests(22, (5, 6, 7))
    p0, p1, p2 = (np.concatenate([prefix, t]) for t in tails)
    # the second prompt maps the first one's prefix blocks (a hit)
    for p in (p0, p1):
        eng.generate(p, max_new_tokens=ENGINE_NEW).result(timeout=600)
    kv = eng.stats()["generate"]["kv"]
    cached_before, hits_before = kv["blocks_cached"], kv["prefix_hits"]
    cand = transformer_lm("small", vocab_size=SERVE_VOCAB, device="cuda",
                          seed=1)
    back = eng.capture_staged()
    h = eng.stage_weights(cand.parameters_tree())
    # a request off its length rung, zero-padded to it for eval_staged
    x = _lm_requests(23, (ENGINE_LENGTHS[0] * 3 // 2,))[0]
    rung = eng.length_ladder.bucket_for(len(x))
    y0 = eng.predict_at(x, 2)
    staged_y = eng.eval_staged(h, _padded(np.pad(x, (0, rung - len(x))),
                                          2))[0]
    t0 = time.perf_counter()
    eng.commit_staged(h, version=2)
    commit_s = time.perf_counter() - t0
    kv = eng.stats()["generate"]["kv"]
    cached_after, hits = kv["blocks_cached"], kv["prefix_hits"]
    committed_y = eng.predict_at(x, 2)
    fa.reset_launch_counts()
    # ---- generation on the committed weights: counts read after it ----
    stream = eng.generate(p2, max_new_tokens=ENGINE_NEW).result(timeout=600)
    torch.cuda.synchronize()
    launches = {k: n for k, n in fa.LAUNCHES.items() if n}
    # ---------------------------------------------------------------------
    hits_after = eng.stats()["generate"]["kv"]["prefix_hits"]
    ledger = eng.memory_ledger().snapshot()
    handle_bytes = {"candidate": h["staged"].nbytes(),
                    "rollback": back["staged"].nbytes()}
    headroom = eng.memory_headroom()
    with ServingEngine(cand, decode_slots=eng.decode_slots,
                       decode_max_len=eng.decode_max_len) as fresh:
        want = fresh.generate(p2, max_new_tokens=ENGINE_NEW).result(
            timeout=600)
    ties = []
    if stream != want:
        k = next(i for i, (a, b) in enumerate(zip(stream, want)) if a != b)
        plain = transformer_lm("small", vocab_size=SERVE_VOCAB,
                               device="cuda", seed=1, use_flash="never")
        seq = np.concatenate([p2, np.asarray(stream[:k], np.int32)])
        with torch.no_grad():
            row_logits = plain(torch.from_numpy(seq[None]).cuda())[0, -1]
        ties.append({"at": k, "gap": abs(row_logits[stream[k]].item()
                                         - row_logits[want[k]].item())})
        del plain
    eng.commit_staged(back, version=1)
    rolled = eng.predict_at(x, 2)
    subsystems = {k: (v if k != "kv_cache" else {
        kk: vv for kk, vv in v.items()}) for k, v in
        ledger["subsystems"].items()}
    row = {"phase": "engine_swap_generation", "prefix_tokens": ENGINE_PREFIX,
           "blocks_cached_before_commit": cached_before,
           "blocks_cached_after_commit": cached_after,
           "prefix_hits": {"before_commit": hits_before,
                           "at_commit": hits, "after_commit": hits_after},
           "commit_s": commit_s, "stream": stream, "fresh_stream": want,
           "ties": ties, "launches": launches,
           "committed_equals_staged_graph": bool(np.array_equal(
               committed_y, staged_y)),
           "rollback_bitwise": bool(np.array_equal(rolled, y0)),
           "staged_handle_bytes": handle_bytes,
           "ledger": {"subsystems": subsystems,
                      "attributed_bytes": ledger["attributed_bytes"],
                      "live_bytes": ledger["live_bytes"],
                      "limit_bytes": ledger["limit_bytes"],
                      "residual_bytes": ledger["residual_bytes"],
                      "headroom_bytes": ledger["headroom_bytes"]},
           "headroom": headroom, "card": card}
    emit(row)
    kvl = subsystems["kv_cache"]
    if not (cached_before > 0 and hits_before > 0 and cached_after == 0
            and hits == hits_after
            and all(t["gap"] <= TIE_MARGIN for t in ties)
            and len(stream) == ENGINE_NEW
            and row["committed_equals_staged_graph"]
            and row["rollback_bitwise"]
            and launches.get("flash_paged_decode_attention")
            and ledger["headroom_bytes"] is not None
            and subsystems["staged"]["handles"] >= 1
            and kvl["blocks_total"] > 0
            and kvl["active_bytes"] + kvl["cached_bytes"]
            + kvl["free_bytes"] > 0):
        raise AssertionError(f"generation across a commit: {row}")
    del h, back, cand
    return row, launches


def engine_service(card, eng, model):
    """(e) ``PredictionService`` on (b)'s fp32 model, 16 requests of 128
    tokens from 8 threads: the semaphore path (the shared compiled step at
    batch 1) bitwise ``predict_at`` at rung 1, and ``coalesce=True`` (an
    engine on the same model and step) bitwise ``predict_at`` at the rung
    each rode; no capture on either."""
    from bigdl_tpu_torch.optim import PredictionService
    from bigdl_tpu_torch.serving import BucketLadder

    reqs = _lm_requests(24, (ENGINE_SERVICE_LEN,) * ENGINE_SERVICE_REQUESTS)
    execs = eng._executables()
    at1 = [eng.predict_at(x, 1) for x in reqs]

    def run(svc):
        out = [None] * len(reqs)

        def worker(k):
            for j in range(k, len(reqs), ENGINE_THREADS):
                out[j] = svc.predict(reqs[j])

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(ENGINE_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        return out, time.perf_counter() - t0

    with PredictionService(model, num_threads=4) as svc:
        sem_out, sem_wall = run(svc)
    buckets = []
    with PredictionService(model, coalesce=True,
                           max_batch_size=ENGINE_LM_MAX_BATCH,
                           length_ladder=BucketLadder(
                               ENGINE_LENGTHS[1],
                               min_size=ENGINE_LENGTHS[0]),
                           decode_slots=0) as svc:
        svc.engine.set_shadow(lambda x, y, b, n, t: buckets.append(b), 1.0)
        co_out, co_wall = run(svc)
        _settle(svc.engine)
        rungs = sorted(set(buckets))
        ats = {b: [svc.engine.predict_at(x, b) for x in reqs]
               for b in rungs}
    sem_bad = [j for j, y in enumerate(sem_out)
               if y is None or not np.array_equal(y, at1[j])]
    co_bad = [j for j, y in enumerate(co_out) if y is None or not any(
        np.array_equal(y, ats[b][j]) for b in rungs)]
    row = {"phase": "engine_prediction_service",
           "requests": len(reqs), "threads": ENGINE_THREADS,
           "semaphore_wall_s": sem_wall, "coalesced_wall_s": co_wall,
           "coalesced_tick_buckets": collections.Counter(buckets),
           "semaphore_mismatched": sem_bad, "coalesced_mismatched": co_bad,
           "captured": eng._executables() - execs, "card": card}
    emit(row)
    if sem_bad or co_bad or row["captured"]:
        raise AssertionError(f"PredictionService: {row}")
    return row


def engine_phase(card):
    """Phase 14 (module docstring).  Returns the main paths' launches."""
    t0 = time.perf_counter()
    eng, model, images, row_a, int8_launches = engine_int8(card)
    staging, commits = engine_staging(card, eng, model, images)
    eng.close()
    del eng, model, images
    gc.collect()
    torch.cuda.empty_cache()
    lm, plain_model = serving_models()
    fp32, row_b, k1 = engine_lm(card, lm, plain_model, None,
                                dict(decode_slots=4, decode_max_len=1024))
    bf16, row_b16, k1_bf16 = engine_lm(card, lm, plain_model,
                                       torch.bfloat16, dict(decode_slots=0))
    bf16.close()
    del bf16, plain_model
    gc.collect()
    torch.cuda.empty_cache()
    row_d, gen_launches = engine_swap_generation(card, fp32, lm)
    row_e = engine_service(card, fp32, lm)
    fp32.close()
    del fp32, lm
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "engine_phase_done", "seconds": time.perf_counter() - t0,
          "batch1_ms": row_a["batch1_ms_median_min_max"],
          "checked_burst_requests_per_s": {
              "int8_resnet50": row_a["requests_per_s"],
              "lm_fp32": row_b["requests_per_s"],
              "lm_bf16": row_b16["requests_per_s"]},
          "rate_window_requests_per_s": {
              "int8_resnet50": row_a["rate_window"]["requests_per_s"],
              "lm_fp32": row_b["rate_window"]["requests_per_s"],
              "lm_bf16": row_b16["rate_window"]["requests_per_s"]},
          "captures": {"int8_resnet50": row_a["captured"],
                       "lm_fp32": row_b["captured"],
                       "lm_bf16": row_b16["captured"]},
          "graph_pool_bytes": {
              "int8_resnet50": row_a["graph_pool_bytes"],
              "lm_fp32_predict": row_b["predict_graph_pool_bytes"],
              "lm_bf16_predict": row_b16["predict_graph_pool_bytes"]},
          "commit_s": {k: v["commit_s"] for k, v in commits.items()},
          "card": card})
    return {"engine_int8_resnet": int8_launches, "engine_lm_fp32": k1,
            "engine_lm_bf16": k1_bf16, "engine_swap_generate": gen_launches}


# --------------------------------------------------------------------------- #
# Phase 15: data-parallel training (optim/distri_optimizer.py)
# --------------------------------------------------------------------------- #

#: (a) the world-1 run against LocalOptimizer: per-step losses and the
#: parameters' relative L2 after phase 7's 8 steps (at world 1 the
#: reduce is an identity; the update runs on the flat chunk)
DISTRI_W1_RTOL = 1e-5
#: (a) checkpoint after 4 steps (neval 5), which (d) resumes at world 2
DISTRI_CKPT_AT = 5
#: (b) steps of each wire at world 2, and the int8-EF world's checkpoint
#: (neval 3, after 2 steps) that (d) resumes at world 1
DISTRI_W2_STEPS, DISTRI_W2_CKPT_AT = 4, 3
#: (b), (d): world 2 against world 1 on the fp32 wire: two 4-row halves'
#: gradients summed against one 8-row batch's (other GEMM shapes, so
#: other cuBLAS algorithms and summation orders), through Adam, which
#: moves a noise-size gradient by the full rate: per-step losses, and
#: the parameters' relative L2
DISTRI_W2_LOSS_RTOL, DISTRI_W2_PARAM_REL = 1e-4, 1e-3
#: (b) the compressed wires against the fp32 wire at world 2, JAX's own
#: bounds (tests/test_quant_collectives.py:313, 336, 362): bf16 per step;
#: int8 with error feedback at the last step and over the run; with the
#: compressed weight gather over the run
DISTRI_CAST_RTOL = 1e-2
DISTRI_INT8_LAST_RTOL, DISTRI_INT8_RTOL, DISTRI_GATHER_RTOL = \
    5e-3, 2e-2, 5e-2
#: (c) SyncBN ResNet-50 at world 2 (8 rows a rank) against world 1 at the
#: full batch 16: the first loss and the running statistics, relative
#: (JAX claims about 1e-6 on its CPU mesh; cuDNN may pick other
#: algorithms for 8 and 16 rows)
DISTRI_SYNCBN_RTOL, DISTRI_SYNCBN_BATCH = 1e-4, 16
#: the int8 wire of (a), (b) and (d)
DISTRI_EF = {"wire": "int8", "block_size": 256, "error_feedback": True}
#: (a) steps of each compressed wire at world 1 (bf16, int8-EF with and
#: without the compressed weight gather), captured on NCCL and eager on
#: a gloo group of the same rank; the two routes' losses and parameters
#: are held to this relative L2 (0: bitwise)
DISTRI_WIRE_W1_STEPS, DISTRI_ROUTE_REL = 3, 0.0
#: the parameters of a run against its reference run, relative to the
#: update the reference applied since its start (``_update_rel``; a run
#: that applies no update reads 1, a resume that loads nothing 350):
#: (b) the fp32 wire against (a), each other wire against the fp32 wire;
#: (d) each resume against its straight run.  Each limit lies between
#: the sound reading on the H100 (3.6e-5, 7.5e-3, 4.1e-2, 4.1e-2; 7.9e-6,
#: 1.4e-2; PERF.md) and the control's
DISTRI_UPD_FP32, DISTRI_UPD_BF16, DISTRI_UPD_INT8, DISTRI_UPD_GATHER = \
    1e-3, 5e-2, 0.25, 0.25
DISTRI_UPD_RESUME_FP32, DISTRI_UPD_RESUME_INT8 = 1e-3, 0.1
#: the children's own limit
DISTRI_CHILD_TIMEOUT_S = 420


def _distri_opt(model, x, y, batch, crit, method, **kw):
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset

    ds = array_dataset(x, y) >> SampleToMiniBatch(batch)
    return optim.DistriOptimizer(model, ds, crit, method, **kw)


def _lm_crit(plain=False):
    from bigdl_tpu_torch import nn

    return nn.TimeDistributedCriterion(
        nn.CrossEntropyCriterion() if plain
        else nn.FusedSoftmaxCrossEntropyCriterion())


def _flat_params(model):
    """``model``'s parameters in the JAX tree's order, one fp32 vector
    (``parallel.zero.FlatParamSpace``, unpadded)."""
    from bigdl_tpu_torch.parallel.zero import FlatParamSpace

    params = dict(model.named_parameters())
    return FlatParamSpace(params, 1).flatten(params)


def _update_rel(got, want, start):
    """``|got - want| / |want - start|`` (L2, over the true size): the
    distance of a run's parameters from its reference run's, relative to
    the update the reference applied since ``start``.  A run that
    applies no update reads 1."""
    n = min(got.size, want.size, start.size)
    got, want, start = got[:n], want[:n], start[:n]
    return float(np.linalg.norm(got - want) / np.linalg.norm(want - start))


def _timed_run(opt, steps, first=0, ckpt=None):
    """``opt.optimize()`` for ``steps`` steps with a loss summary; the
    mean step time over the steps after ``first`` (each a replay)."""
    summary = _Losses()
    opt.set_train_summary(summary)
    clock = StepClock(opt, steps, sync_at=(first, steps))
    opt.set_end_when(clock)
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt),
                           lambda s: s["neval"] == DISTRI_CKPT_AT)
    torch.cuda.synchronize()
    opt.optimize()
    torch.cuda.synchronize()
    step_s = (clock.marks[steps][0] - clock.marks[first][0]) \
        / (steps - first)
    return summary.scalars["Loss"], step_s


def distri_world1(fa, ce, card, root, x, y):
    """Phase 15 (a): "small" through ``Optimizer(distributed=True)`` at a
    world of one on NCCL, fp32 then bf16, against LocalOptimizer on the
    same weights and batches; the DP step's launches, its graph and
    whether NCCL's collectives were captured in it; one step with the
    kernels swapped for their plain versions."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.models import transformer_lm
    from bigdl_tpu_torch.utils import cuda_graphs

    paths = {}
    # the timed window: steps 5-8, after (a)'s checkpoint at neval 5
    first = DISTRI_CKPT_AT - 1
    for dtype in (None, torch.bfloat16):
        label = "bf16" if dtype else "fp32"
        runs = {}
        for route in ("local", "distri"):
            model = transformer_lm("small", VOCAB, max_len=SEQ,
                                   device="cuda", seed=0)
            opt = optim.Optimizer(
                model, array_dataset(x, y) >> SampleToMiniBatch(BATCH),
                _lm_crit(), optim.Adam(learning_rate=1e-4),
                distributed=route == "distri")
            opt.set_compute_dtype(dtype)
            fa.reset_launch_counts()
            ce.reset_launch_counts()
            captures = cuda_graphs.capture_count()
            # ---- the data-parallel main path: counts read right after
            losses, step_s = _timed_run(
                opt, TRAIN_ITERS, first,
                ckpt=root / "a" if route == "distri" and dtype is None
                else None)
            launches = {k: n - fa.BF16_LAUNCHES.get(k, 0)
                        for k, n in fa.LAUNCHES.items()}
            launches.update({f"{k}_bf16": n
                             for k, n in fa.BF16_LAUNCHES.items()})
            launches.update(ce.LAUNCHES)
            # ------------------------------------------------------------
            stats = opt.compiled_stats
            runs[route] = {
                "losses": losses, "step_s": step_s,
                "tokens_per_s": BATCH * SEQ / step_s,
                "graphs": stats["captured"], "replays": stats["replays"],
                "graph_pool_bytes": stats["pool_bytes"],
                "captures": cuda_graphs.capture_count() - captures,
                "launches": launches,
                "flat": _flat_params(model).detach()}
            if route == "distri":
                runs[route].update(
                    captured_route=opt.captured_route,
                    nccl_captured=opt.captured_route == "nccl-graph"
                    and stats["captured"] == 1,
                    wire_summary=opt.wire_summary)
            del model, opt
            torch.cuda.empty_cache()
        d, l = runs["distri"], runs["local"]
        step_rel = [abs(a - b) / abs(b) for a, b in zip(d["losses"],
                                                        l["losses"])]
        param_rel = rel_l2(d["flat"], l["flat"])
        bitwise = d["losses"] == l["losses"] and torch.equal(d["flat"],
                                                              l["flat"])
        # the path's kernels under the kernels line's names: bf16 K1 and
        # K1-bwd in the bf16 run, where no fp32 K1 may launch
        names = [f"{k}_bf16" if dtype is not None and k.startswith("flash")
                 else k for k in TRAIN_KERNELS]
        kernels = {k: d["launches"].get(k, 0) for k in names}
        want = {k: n for k, n in zip(names, TRAIN_WANT.values())}
        if dtype is not None:
            kernels.update(flash_attention=d["launches"]["flash_attention"],
                           flash_attention_bwd=d["launches"][
                               "flash_attention_bwd"])
            want.update(flash_attention=0, flash_attention_bwd=0)
        row = {"phase": "distri_world1", "compute_dtype": label,
               "world": 1, "backend": torch.distributed.get_backend(),
               "nccl_captured_in_graph": d["nccl_captured"],
               "route": d["captured_route"], "graphs": d["graphs"],
               "captures": d["captures"], "replays": d["replays"],
               "graph_pool_bytes": d["graph_pool_bytes"],
               "step_s": d["step_s"], "tokens_per_s": d["tokens_per_s"],
               "local_step_s": l["step_s"],
               "local_tokens_per_s": l["tokens_per_s"],
               "local_graph_pool_bytes": l["graph_pool_bytes"],
               "losses": d["losses"], "local_losses": l["losses"],
               "max_step_loss_rel": max(step_rel),
               "param_rel_l2": param_rel, "bitwise_equal": bitwise,
               "tolerance": DISTRI_W1_RTOL, "launches": kernels,
               "wire_summary": d["wire_summary"], "card": card}
        emit(row)
        if len(d["losses"]) != TRAIN_ITERS or \
                max(step_rel) > DISTRI_W1_RTOL or \
                param_rel > DISTRI_W1_RTOL:
            raise AssertionError(f"DP world 1 against LocalOptimizer: {row}")
        if not d["nccl_captured"] or d["graphs"] != 1 or \
                d["replays"] != TRAIN_ITERS:
            raise AssertionError(f"the NCCL step was not one captured "
                                 f"graph: {row}")
        if any(kernels[k] != n for k, n in want.items()):
            raise AssertionError(f"DP launches {kernels}, want {want}")
        paths["distri" if dtype is None else "distri_bf16"] = {
            k: kernels[k] for k in names}
        if dtype is None:
            final_fp32 = d["flat"]
            fp32_losses = d["losses"]
        del runs, d, l
        torch.cuda.empty_cache()

    # one step of the DP graph on the plain model (attention and the
    # cross-entropy in plain PyTorch), against the kernels' first step
    model = transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                           seed=0, use_flash="never")
    opt = _distri_opt(model, x, y, BATCH, _lm_crit(plain=True),
                      optim.Adam(learning_rate=1e-4))
    fa.reset_launch_counts()
    ce.reset_launch_counts()
    summary = _Losses()
    opt.set_train_summary(summary)
    opt.set_end_when(optim.Trigger.max_iteration(1))
    opt.optimize()
    plain = {"loss": summary.scalars["Loss"][0],
             "kernels_loss": fp32_losses[0],
             "launches": sum(fa.LAUNCHES.values()) + sum(
                 ce.LAUNCHES.values()),
             "graphs": opt.compiled_stats["captured"]}
    emit({"phase": "distri_plain_step", **plain, "tolerance": ATOL,
          "card": card})
    if abs(plain["loss"] - plain["kernels_loss"]) > ATOL or \
            plain["launches"] or plain["graphs"] != 1:
        raise AssertionError(f"DP step, plain against kernels: {plain}")
    del model, opt
    torch.cuda.empty_cache()
    return paths, final_fp32.cpu(), fp32_losses


def distri_world1_wires(card, x, y):
    """Phase 15 (a), the compressed wires on NCCL: the bf16 leg and the
    int8-EF legs, with and without the compressed weight gather, at a
    world of one, captured in the step's graph (``all_to_all_single`` of
    the payload and the scales, ``all_gather_into_tensor`` of the int8
    delta), held against the same legs on a gloo group of the same
    rank, which runs them eagerly through ``all_reduce``."""
    import torch.distributed as dist

    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.models import transformer_lm
    from bigdl_tpu_torch.ops.quantization import CompressionSpec

    gloo = dist.new_group(backend="gloo")
    legs = {}
    try:
        wires = (("bf16", "bf16"),
                 ("int8_ef", CompressionSpec(**DISTRI_EF)),
                 ("int8_ef_gather", CompressionSpec(
                     **DISTRI_EF, compress_weight_gather=True)))
        for label, wire in wires:
            for route, mesh in (("nccl", None), ("gloo", gloo)):
                model = transformer_lm("small", VOCAB, max_len=SEQ,
                                       device="cuda", seed=0)
                opt = _distri_opt(model, x, y, BATCH, _lm_crit(),
                                  optim.Adam(learning_rate=1e-4), mesh=mesh,
                                  grad_compression=wire)
                summary = _Losses()
                opt.set_train_summary(summary)
                opt.set_end_when(optim.Trigger.max_iteration(
                    DISTRI_WIRE_W1_STEPS))
                t0 = time.perf_counter()
                opt.optimize()
                torch.cuda.synchronize()
                legs[label, route] = {
                    "losses": summary.scalars["Loss"],
                    "wall_s": time.perf_counter() - t0,
                    "route": opt.captured_route,
                    "graphs": opt.compiled_stats["captured"],
                    "replays": opt.compiled_stats["replays"],
                    "flat": _flat_params(model).cpu().numpy()}
                del model, opt
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group(gloo)
    row = {"phase": "distri_world1_wires", "world": 1,
           "steps": DISTRI_WIRE_W1_STEPS, "tolerance": DISTRI_ROUTE_REL,
           "card": card}
    bad = []
    for label in ("bf16", "int8_ef", "int8_ef_gather"):
        nc, gl = legs[label, "nccl"], legs[label, "gloo"]
        rel = float(np.linalg.norm(nc["flat"] - gl["flat"])
                    / np.linalg.norm(gl["flat"]))
        loss_rel = _max_step_rel(nc["losses"], gl["losses"])
        row[label] = {
            "nccl_losses": nc["losses"], "gloo_losses": gl["losses"],
            "max_step_loss_rel": loss_rel, "param_rel_l2": rel,
            "bitwise_equal": nc["losses"] == gl["losses"]
            and np.array_equal(nc["flat"], gl["flat"]),
            "nccl_route": nc["route"], "nccl_graphs": nc["graphs"],
            "nccl_replays": nc["replays"], "gloo_route": gl["route"],
            "nccl_wall_s": nc["wall_s"], "gloo_wall_s": gl["wall_s"]}
        if nc["route"] != "nccl-graph" or nc["graphs"] != 1 or \
                nc["replays"] != DISTRI_WIRE_W1_STEPS or \
                gl["route"] != "eager" or \
                len(nc["losses"]) != DISTRI_WIRE_W1_STEPS or \
                not np.isfinite(nc["flat"]).all() or \
                loss_rel > DISTRI_ROUTE_REL or rel > DISTRI_ROUTE_REL:
            bad.append(label)
    emit(row)
    if bad:
        raise AssertionError(f"wires, NCCL captured against gloo: "
                             f"{bad}: {row}")


def distri_child(rank, world, init, job_path, out):
    """Phase 15 (b)-(d), one rank of the gloo world sharing the card:
    each wire for ``DISTRI_W2_STEPS`` steps (the int8-EF leg writes its
    checkpoint), (a)'s checkpoint resumed to step 8, and SyncBN
    ResNet-50 for one step.  Results to ``out/rank<r>.json`` and, from
    rank 0, each leg's and the resume's final parameters."""
    import torch.distributed as dist

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.interop import to_jax_state
    from bigdl_tpu_torch.models import ResNet, synthetic_corpus, \
        transformer_lm
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops.quantization import CompressionSpec

    torch.cuda.set_device(0)
    _build.load()
    with open(job_path) as f:
        job = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=world, rank=rank)
    out = Path(out)
    res = {}
    try:
        x, y = synthetic_corpus(64, SEQ, VOCAB)
        legs = [("fp32", None), ("bf16", "bf16"),
                ("int8_ef", CompressionSpec(**DISTRI_EF)),
                ("int8_ef_gather", CompressionSpec(
                    **DISTRI_EF, compress_weight_gather=True))]
        for label, wire in legs:
            model = transformer_lm("small", VOCAB, max_len=SEQ,
                                   device="cuda", seed=0)
            opt = _distri_opt(model, x, y, BATCH, _lm_crit(),
                              optim.Adam(learning_rate=1e-4),
                              grad_compression=wire)
            summary = _Losses()
            opt.set_train_summary(summary)
            opt.set_end_when(optim.Trigger.max_iteration(DISTRI_W2_STEPS))
            if label == "int8_ef":
                opt.set_checkpoint(job["ckpt_w2"], lambda s: s["neval"]
                                   == DISTRI_W2_CKPT_AT)
            t0 = time.perf_counter()
            opt.optimize()
            torch.cuda.synchronize()
            res[label] = {"losses": summary.scalars["Loss"],
                          "wall_s": time.perf_counter() - t0,
                          "route": opt.captured_route,
                          "wire_summary": opt.wire_summary}
            if rank == 0:
                np.save(out / f"flat_{label}.npy",
                        _flat_params(model).cpu().numpy())
            del model, opt
            torch.cuda.empty_cache()
        # (d): (a)'s checkpoint (world 1, after 4 steps) resumed here
        model = transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                               seed=1)
        opt = _distri_opt(model, x, y, BATCH, _lm_crit(),
                          optim.Adam(learning_rate=1e-4))
        summary = _Losses()
        opt.set_train_summary(summary)
        opt.resume_from_checkpoint(job["ckpt_a"])
        opt.set_end_when(optim.Trigger.max_iteration(TRAIN_ITERS))
        opt.optimize()
        res["resume_a"] = {"losses": summary.scalars["Loss"],
                           "neval": opt.driver_state["neval"]}
        if rank == 0:
            np.save(out / "flat_resume.npy",
                    _flat_params(model).cpu().numpy())
        del model, opt
        torch.cuda.empty_cache()
        # (c): SyncBN ResNet-50, one step
        xr, yr = job_resnet_data()
        model = ResNet(50, class_num=1000, device="cuda", seed=0)
        opt = _distri_opt(model, xr, yr, DISTRI_SYNCBN_BATCH,
                          nn.CrossEntropyCriterion(),
                          optim.SGD(learning_rate=0.1, momentum=0.9,
                                    dampening=0.0))
        opt.set_sync_batchnorm()
        summary = _Losses()
        opt.set_train_summary(summary)
        opt.set_end_when(optim.Trigger.max_iteration(1))
        opt.optimize()
        res["syncbn"] = {"loss": summary.scalars["Loss"][0]}
        if rank == 0:
            np.save(out / "syncbn_state.npy", _state_vector(
                to_jax_state(model)))
    finally:
        dist.destroy_process_group()
    with open(out / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    return 0


def job_resnet_data():
    """(c)'s 16 images at 224 and labels (numpy seed 15)."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((DISTRI_SYNCBN_BATCH, RESNET_SIDE,
                             RESNET_SIDE, 3), dtype=np.float32)
    return x, rng.integers(0, 1000, DISTRI_SYNCBN_BATCH)


def _state_vector(tree):
    """The leaves of a model-state tree in the JAX order, one vector."""
    from bigdl_tpu_torch.optim.local_optimizer import _tree_leaves

    return np.concatenate([np.ravel(v) for _, v in _tree_leaves(tree)])


def _spawn_world2(root, job, meanwhile=None):
    """Start the two gloo ranks (this script, ``--distri-rank``), run
    ``meanwhile()`` here while they work, wait for them under
    ``DISTRI_CHILD_TIMEOUT_S``, kill both on a hang or a failure;
    returns their results."""
    out = root / "w2"
    out.mkdir()
    job_path = root / "job.json"
    job_path.write_text(json.dumps(job))
    init = root / "rendezvous"
    logs = [out / f"rank{r}.log" for r in range(2)]
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--distri-rank", str(r), "2", str(init),
                     str(job_path), str(out)],
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DISTRI_CHILD_TIMEOUT_S
        if meanwhile is not None:
            meanwhile()
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"world-2 rank {bad[0]} failed:\n"
                             f"{logs[bad[0]].read_text()[-3000:]}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(2)], out


def _max_step_rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def distri_phase(fa, ce, card):
    """Phase 15: the data-parallel path."""
    import shutil
    import tempfile

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.interop import to_jax_state
    from bigdl_tpu_torch.models import ResNet, synthetic_corpus, \
        transformer_lm
    from bigdl_tpu_torch.ops.quantization import CompressionSpec
    from bigdl_tpu_torch.utils import file_io
    from bigdl_tpu_torch.utils.engine import Engine

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_distri_"))
    try:
        Engine.init()                  # NCCL, a world of one on the card
        x, y = synthetic_corpus(64, SEQ, VOCAB)
        paths, final_a, losses_a = distri_world1(fa, ce, card, root, x, y)
        ckpt_a = root / "a" / f"checkpoint.{DISTRI_CKPT_AT}.pkl"
        flat_a4 = np.asarray(file_io.load(str(ckpt_a))["model_params"]
                             ["model_params_flat"])
        # the weights every seed-0 run starts from
        theta0 = _flat_params(transformer_lm(
            "small", VOCAB, max_len=SEQ, device="cuda", seed=0)).cpu().numpy()
        gc.collect()
        torch.cuda.empty_cache()

        # (b)-(d) in a world of two processes sharing the card, on gloo,
        # while (a)'s compressed wires run here (correctness legs: their
        # wall times share the card)
        t0 = time.perf_counter()
        ranks, out = _spawn_world2(root, {
            "ckpt_a": str(root / "a"), "ckpt_w2": str(root / "w2_ckpt")},
            meanwhile=lambda: distri_world1_wires(card, x, y))
        world2_s = time.perf_counter() - t0
        r0 = ranks[0]
        for r in ranks[1:]:
            for leg in ("fp32", "bf16", "int8_ef", "int8_ef_gather",
                        "resume_a"):
                if r[leg]["losses"] != r0[leg]["losses"]:
                    raise AssertionError(f"ranks' {leg} losses differ")
        fp32 = r0["fp32"]["losses"]
        wires = ("fp32", "bf16", "int8_ef", "int8_ef_gather")
        flats = {leg: np.load(out / f"flat_{leg}.npy") for leg in wires}
        flat_fp32 = flats["fp32"]
        n = flat_a4.size
        # each wire's parameters against the fp32 wire's, relative to
        # the fp32 wire's update; the fp32 wire against (a)'s after the
        # same 4 steps; a leg that applies no update reads 1
        upd = {leg: _update_rel(flats[leg], flat_fp32, theta0)
               for leg in wires[1:]}
        upd["fp32_vs_world1"] = _update_rel(flat_fp32, flat_a4, theta0)
        upd["no_update"] = _update_rel(theta0, flat_fp32, theta0)
        upd_limits = {"fp32_vs_world1": DISTRI_UPD_FP32,
                      "bf16": DISTRI_UPD_BF16, "int8_ef": DISTRI_UPD_INT8,
                      "int8_ef_gather": DISTRI_UPD_GATHER}
        b_row = {
            "phase": "distri_world2_wires", "world": 2, "backend": "gloo",
            "note": "host-routed correctness runs (gloo on CUDA tensors, "
                    "eager), not NCCL's speed",
            "rows_per_rank": BATCH // 2,
            "fp32_vs_world1_max_step_loss_rel": _max_step_rel(
                fp32, losses_a[:DISTRI_W2_STEPS]),
            "fp32_vs_world1_param_rel_l2": float(
                np.linalg.norm(flat_fp32[:n] - flat_a4[:n])
                / np.linalg.norm(flat_a4[:n])),
            "bf16_max_step_rel": _max_step_rel(r0["bf16"]["losses"], fp32),
            "int8_ef_last_rel": _max_step_rel(
                r0["int8_ef"]["losses"][-1:], fp32[-1:]),
            "int8_ef_max_step_rel": _max_step_rel(r0["int8_ef"]["losses"],
                                                  fp32),
            "int8_ef_gather_max_step_rel": _max_step_rel(
                r0["int8_ef_gather"]["losses"], fp32),
            "param_update_rel": upd, "param_update_limits": upd_limits,
            "fp32_update_rel_l2": float(
                np.linalg.norm(flat_fp32[:n] - theta0[:n])
                / np.linalg.norm(theta0[:n])),
            "losses": {leg: r0[leg]["losses"] for leg in
                       ("fp32", "bf16", "int8_ef", "int8_ef_gather")},
            "wall_s": {leg: r0[leg]["wall_s"] for leg in
                       ("fp32", "bf16", "int8_ef", "int8_ef_gather")},
            "routes": {leg: r0[leg]["route"] for leg in
                       ("fp32", "bf16", "int8_ef", "int8_ef_gather")},
            "wire_summary": {leg: r0[leg]["wire_summary"] for leg in
                             ("fp32", "bf16", "int8_ef", "int8_ef_gather")},
            "tolerances": {"fp32_loss": DISTRI_W2_LOSS_RTOL,
                           "fp32_param": DISTRI_W2_PARAM_REL,
                           "bf16": DISTRI_CAST_RTOL,
                           "int8_ef_last": DISTRI_INT8_LAST_RTOL,
                           "int8_ef": DISTRI_INT8_RTOL,
                           "int8_ef_gather": DISTRI_GATHER_RTOL},
            "world2_wall_s": world2_s, "card": card}
        emit(b_row)
        if b_row["fp32_vs_world1_max_step_loss_rel"] > DISTRI_W2_LOSS_RTOL \
                or b_row["fp32_vs_world1_param_rel_l2"] > \
                DISTRI_W2_PARAM_REL or \
                b_row["bf16_max_step_rel"] > DISTRI_CAST_RTOL or \
                b_row["int8_ef_last_rel"] > DISTRI_INT8_LAST_RTOL or \
                b_row["int8_ef_max_step_rel"] > DISTRI_INT8_RTOL or \
                b_row["int8_ef_gather_max_step_rel"] > DISTRI_GATHER_RTOL \
                or any(upd[k] > lim for k, lim in upd_limits.items()) \
                or set(b_row["routes"].values()) != {"eager"} or \
                not all(np.isfinite(v).all()
                        for v in b_row["losses"].values()):
            raise AssertionError(f"world-2 wires: {b_row}")

        # (c) SyncBN against world 1 at the full batch
        xr, yr = job_resnet_data()
        model = ResNet(50, class_num=1000, device="cuda", seed=0)
        opt = optim.LocalOptimizer(
            model, array_dataset(xr, yr)
            >> SampleToMiniBatch(DISTRI_SYNCBN_BATCH),
            nn.CrossEntropyCriterion(),
            optim.SGD(learning_rate=0.1, momentum=0.9, dampening=0.0))
        summary = _Losses()
        opt.set_train_summary(summary)
        opt.set_end_when(optim.Trigger.max_iteration(1))
        opt.optimize()
        want_state = _state_vector(to_jax_state(model))
        got_state = np.load(out / "syncbn_state.npy")
        c_row = {"phase": "distri_syncbn", "model": "ResNet-50",
                 "world": 2, "backend": "gloo",
                 "global_batch": DISTRI_SYNCBN_BATCH,
                 "loss_world2": r0["syncbn"]["loss"],
                 "loss_world1": summary.scalars["Loss"][0],
                 "loss_rel": abs(r0["syncbn"]["loss"]
                                 - summary.scalars["Loss"][0])
                 / abs(summary.scalars["Loss"][0]),
                 "running_stats_rel_l2": float(
                     np.linalg.norm(got_state - want_state)
                     / np.linalg.norm(want_state)),
                 "tolerance": DISTRI_SYNCBN_RTOL, "card": card}
        emit(c_row)
        if ranks[1]["syncbn"]["loss"] != r0["syncbn"]["loss"] or \
                c_row["loss_rel"] > DISTRI_SYNCBN_RTOL or \
                c_row["running_stats_rel_l2"] > DISTRI_SYNCBN_RTOL:
            raise AssertionError(f"SyncBN world 2 against world 1: {c_row}")
        del model, opt
        torch.cuda.empty_cache()

        # (d) resumes: (b)'s int8-EF checkpoint at world 1 (the 2 -> 1
        # refit and the residual's repartition), (a)'s at world 2
        model = transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                               seed=1)
        # what a resume that loads nothing would continue from
        theta1 = _flat_params(model).cpu().numpy()
        opt = _distri_opt(model, x, y, BATCH, _lm_crit(),
                          optim.Adam(learning_rate=1e-4),
                          grad_compression=CompressionSpec(**DISTRI_EF))
        summary = _Losses()
        opt.set_train_summary(summary)
        opt.resume_from_checkpoint(str(root / "w2_ckpt"))
        opt.set_end_when(optim.Trigger.max_iteration(DISTRI_W2_STEPS))
        opt.optimize()
        resumed_w1 = summary.scalars["Loss"]
        straight = r0["int8_ef"]["losses"][DISTRI_W2_CKPT_AT - 1:]
        flat_w2_ckpt = np.asarray(file_io.load(str(
            root / "w2_ckpt" / f"checkpoint.{DISTRI_W2_CKPT_AT}.pkl"))
            ["model_params"]["model_params_flat"])
        flat_resume_w1 = _flat_params(model).cpu().numpy()
        flat_resume = np.load(out / "flat_resume.npy")
        final = final_a.numpy()
        d_row = {
            "phase": "distri_resume",
            "int8_ef_world2_to_world1": {
                "losses": resumed_w1, "straight_world2": straight,
                "max_step_rel": _max_step_rel(resumed_w1, straight),
                "param_update_rel": _update_rel(
                    flat_resume_w1, flats["int8_ef"], flat_w2_ckpt),
                "param_rel_l2": float(
                    np.linalg.norm(flat_resume_w1 - flats["int8_ef"])
                    / np.linalg.norm(flats["int8_ef"])),
                "no_load_update_rel": _update_rel(
                    theta1, flats["int8_ef"], flat_w2_ckpt),
                "tolerances": [DISTRI_W2_LOSS_RTOL,
                               DISTRI_UPD_RESUME_INT8]},
            "fp32_world1_to_world2": {
                "losses": r0["resume_a"]["losses"],
                "straight_world1": losses_a[DISTRI_CKPT_AT - 1:],
                "max_step_rel": _max_step_rel(
                    r0["resume_a"]["losses"],
                    losses_a[DISTRI_CKPT_AT - 1:]),
                "param_rel_l2": float(np.linalg.norm(flat_resume - final)
                                      / np.linalg.norm(final)),
                "param_update_rel": _update_rel(flat_resume, final,
                                                flat_a4),
                "tolerances": [DISTRI_W2_LOSS_RTOL, DISTRI_W2_PARAM_REL,
                               DISTRI_UPD_RESUME_FP32]},
            "card": card}
        emit(d_row)
        a, b = d_row["int8_ef_world2_to_world1"], \
            d_row["fp32_world1_to_world2"]
        if len(resumed_w1) != len(straight) or \
                a["max_step_rel"] > DISTRI_W2_LOSS_RTOL or \
                a["param_update_rel"] > DISTRI_UPD_RESUME_INT8 or \
                len(b["losses"]) != TRAIN_ITERS - DISTRI_CKPT_AT + 1 or \
                b["max_step_rel"] > DISTRI_W2_LOSS_RTOL or \
                b["param_rel_l2"] > DISTRI_W2_PARAM_REL or \
                b["param_update_rel"] > DISTRI_UPD_RESUME_FP32:
            raise AssertionError(f"DP resume: {d_row}")
        del model, opt
        torch.cuda.empty_cache()
        emit({"phase": "distri_done",
              "seconds": time.perf_counter() - t_phase, "card": card})
        return paths
    finally:
        Engine.reset()
        shutil.rmtree(root, ignore_errors=True)


#: phase 16: the fleet's engines -- batch rungs 1-4 and length rungs
#: 128-512 (three sets of graphs fit on the card and build in time), 8
#: decode slots of up to 512 positions
FLEET_MAX_BATCH, FLEET_LENGTHS, FLEET_DECODE_LEN = 4, (128, 512), 512
#: phase 16 (a): the traffic of the fleet's main path
FLEET_PREDICTS, FLEET_GENERATES, FLEET_THREADS, FLEET_NEW = 64, 16, 8, 16
FLEET_PREDICT_LENGTHS = (17, 100, 128, 200, 256, 300, 480, 512)
FLEET_PROMPT_LENGTHS = (9, 33, 60, 120, 200, 17, 80, 150)
#: phase 16: a fleet prediction against replica 0's ``predict_at`` at
#: batch rung 1, relative to the largest logit (another batch rung may
#: reduce in another order)
FLEET_TOL = 1e-5
#: phase 16 (a): the served-rate windows, (predicts, generations) each,
#: taken by the fleet and by replica 0's engine alone in turns
FLEET_RATE_WINDOW, FLEET_RATE_WINDOWS = (256, 64), 2
#: phase 16 (b): predictions of the chaos window, and the request count
#: at which worker 1 is SIGKILLed
FLEET_CHAOS_PREDICTS, FLEET_KILL_AT = 48, 12
#: seconds a worker may take from spawn to its port file, and a rejoin
FLEET_BOOT_TIMEOUT_S, FLEET_REJOIN_TIMEOUT_S = 300, 300


def _fleet_engine(model, kv):
    from bigdl_tpu_torch.serving import BucketLadder, ServingEngine

    return ServingEngine(model, max_batch_size=FLEET_MAX_BATCH,
                         max_wait_ms=1.0,
                         length_ladder=BucketLadder(FLEET_LENGTHS[1],
                                                    min_size=FLEET_LENGTHS[0]),
                         decode_max_len=FLEET_DECODE_LEN,
                         kv_cache_dtype=kv)


def _fleet_probe_rows():
    return _lm_requests(41, (FLEET_LENGTHS[0],) * 4)


def _process_memory():
    return {"pid": os.getpid(),
            "allocated_bytes": torch.cuda.memory_allocated(),
            "max_allocated_bytes": torch.cuda.max_memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved()}


def fleet_worker(rid, port_file, registry):
    """Phase 16, one worker process on the card (this script,
    ``--fleet-worker``): "small" from seed 0 behind two replica servers
    on 127.0.0.1:0 sharing its weights, fp32 KV and int8 KV; boots the
    registry's committed version; the port file (written atomically)
    holds the fp32 server's port.  A ``smoke`` verb of this role reads
    (and resets) the process's kernel launches and reports its card
    memory and the int8 server's port."""
    from tools.torch_serve_fleet import exit_with_parent, write_port_file

    from bigdl_tpu_torch.models import transformer_lm
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.serving.worker import (ReplicaServer,
                                                boot_from_registry)

    exit_with_parent()
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    _build.load()
    servers = {}

    class SmokeServer(ReplicaServer):
        def _op_smoke(self, req):
            torch.cuda.synchronize()
            out = {"launches": {k: n for k, n in fa.LAUNCHES.items() if n},
                   "memory": _process_memory(),
                   "int8_port": servers["int8"].port}
            if req.get("reset"):
                fa.reset_launch_counts()
            return out

    t0 = time.perf_counter()
    model = transformer_lm("small", vocab_size=SERVE_VOCAB, device="cuda",
                           seed=0)
    probe = _fleet_probe_rows()
    engines = {kv: _fleet_engine(model, kv) for kv in ("fp32", "int8")}
    for eng in engines.values():
        eng.precompile(example_feature=probe[0])
    booted = boot_from_registry(engines["fp32"], registry)
    for kv, eng in engines.items():
        servers[kv] = SmokeServer(eng, port=0, probe_features=probe,
                                  probe_bucket=FLEET_MAX_BATCH)
    servers["int8"].start()
    write_port_file(port_file, servers["fp32"].port)
    print(json.dumps({"worker": rid, "boot_s": time.perf_counter() - t0,
                      "booted": booted,
                      "ports": [s.port for s in servers.values()]}),
          flush=True)
    servers["fp32"].serve_forever()
    servers["int8"].close()
    for eng in engines.values():
        eng.close()
    return 0


class _FleetWorkers:
    """The phase's worker processes: ``spawn(rid)`` is the ``spawn(attempt)
    -> (proc, port)`` that ``SubprocessReplica`` wants (the drill tool's
    environment and port-file wait), each spawn's boot seconds (spawn to
    port file) kept aside.  ``start(rid)`` starts a worker ahead of its
    first spawn, so several boot at once."""

    def __init__(self, root, registry, token):
        self.root, self.registry, self.token = root, registry, token
        self.boot_s, self.procs, self._started = [], [], {}

    def _popen(self, rid):
        from tools.torch_serve_live import child_env

        port_file = self.root / f"worker{rid}.port"
        if port_file.exists():
            port_file.unlink()
        with open(self.root / f"worker{rid}.log", "a") as log:
            proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--fleet-worker", str(rid), str(port_file),
                 str(self.registry)], stdout=log, stderr=subprocess.STDOUT,
                env=dict(child_env(), BIGDL_RUN_TOKEN=self.token))
        self.procs.append(proc)
        return proc, port_file, time.perf_counter()

    def start(self, rid):
        self._started[rid] = self._popen(rid)

    def spawn(self, rid):
        from tools.torch_serve_fleet import wait_port_file

        def spawn(attempt):
            proc, port_file, t0 = self._started.pop(rid, None) \
                or self._popen(rid)
            log = self.root / f"worker{rid}.log"
            try:
                port = wait_port_file(proc, str(port_file),
                                      f"fleet worker {rid}", log.name,
                                      timeout=FLEET_BOOT_TIMEOUT_S)
            except RuntimeError as e:
                raise AssertionError(f"{e}:\n{log.read_text()[-3000:]}") \
                    from e
            self.boot_s.append({"replica": rid,
                                "seconds": time.perf_counter() - t0})
            return proc, port
        return spawn

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait(30)


class _Recorder:
    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append({"kind": kind, **fields})

    def set_serving_info(self, info):
        pass


def _percentiles(lat):
    from bigdl_tpu_torch.observability.profiling import percentile

    s = sorted(lat)
    return {"p50_ms": percentile(s, 50.0) * 1e3,
            "p99_ms": percentile(s, 99.0) * 1e3}


def _fleet_traffic(predict, generate, reqs, threads=FLEET_THREADS,
                   keep=True):
    """``reqs`` (("predict" | "generate", tokens)) from ``threads``
    threads, each taking every ``threads``-th; returns each result (None
    where not ``keep``), each request's latency, the wall seconds and
    the failures."""
    out, lat = [None] * len(reqs), [None] * len(reqs)
    failures = []

    def client(k):
        for j in range(k, len(reqs), threads):
            kind, toks = reqs[j]
            t0 = time.perf_counter()
            try:
                y = predict(toks) if kind == "predict" else generate(toks)
                out[j] = y if keep else None
            except Exception as e:
                failures.append(f"{kind} {j}: {type(e).__name__}: {e}")
            lat[j] = time.perf_counter() - t0

    workers = [threading.Thread(target=client, args=(k,))
               for k in range(threads)]
    t0 = time.perf_counter()
    for t in workers:
        t.start()
    for t in workers:
        t.join(900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in workers):
        raise AssertionError("phase 16: a client thread hung")
    return out, lat, wall, failures


def _traffic_row(reqs, lat, wall):
    kinds = {k: [l for (kk, _), l in zip(reqs, lat) if kk == k]
             for k in ("predict", "generate")}
    return {"requests": len(reqs), "wall_s": wall,
            "requests_per_s": len(reqs) / wall,
            **{k: {"requests": len(v), **_percentiles(v)}
               for k, v in kinds.items() if v}}


def _fleet_requests(seed, n_predict, n_generate):
    """The fleet's traffic mix: predicts over the length rungs' range and
    greedy generations, shuffled."""
    lengths = FLEET_PREDICT_LENGTHS
    feats = _lm_requests(seed, tuple(lengths[j % len(lengths)]
                                     for j in range(n_predict)))
    prompts = _lm_requests(seed + 1, tuple(
        FLEET_PROMPT_LENGTHS[j % len(FLEET_PROMPT_LENGTHS)]
        for j in range(n_generate)))
    reqs = [("predict", f) for f in feats] + \
        [("generate", p) for p in prompts]
    order = np.random.default_rng(seed + 2).permutation(len(reqs))
    return [reqs[j] for j in order]


def _rate_windows(targets, windows):
    """Served rates of several targets (name -> (predict, generate)),
    taken in turns over the same windows of requests, results dropped:
    per target the rate of all requests over all windows' wall time and
    the tails over all of them, beside each window's own row."""
    rows = {name: {"windows": [], "reqs": [], "lat": [], "wall": 0.0}
            for name in targets}
    for reqs in windows:
        for name, (predict, generate) in targets.items():
            _, lat, wall, failures = _fleet_traffic(predict, generate, reqs,
                                                    keep=False)
            if failures:
                raise AssertionError(f"{name} rate window: {failures[:3]}")
            r = rows[name]
            r["windows"].append(_traffic_row(reqs, lat, wall))
            r["reqs"] += reqs
            r["lat"] += lat
            r["wall"] += wall
    return {name: {**_traffic_row(r["reqs"], r["lat"], r["wall"]),
                   "windows": [{k: w[k] for k in ("requests", "wall_s",
                                                  "requests_per_s")}
                               for w in r["windows"]]}
            for name, r in rows.items()}


def _stream_tie(model, prompt, ref, got):
    """None where two greedy streams agree; else where they part and the
    gap between the two tokens' logits there (the served model's own
    forward over the reference prefix)."""
    if got == ref:
        return None
    k = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
             min(len(ref), len(got)))
    if k >= min(len(ref), len(got)):
        return {"at": k, "gap": float("inf"), "lengths": [len(ref),
                                                          len(got)]}
    seq = np.concatenate([prompt, np.asarray(ref[:k], np.int32)])
    with torch.no_grad():
        logits = model(torch.from_numpy(seq[None]).cuda())[0, -1]
    return {"at": k, "gap": abs(logits[ref[k]].item()
                                - logits[got[k]].item())}


def _smoke(rep, reset=False):
    return rep._call("smoke", reset=reset, rpc_timeout=60.0)


def fleet_phase(fa, card):
    """Phase 16: the serving fleet on the card.  Returns the main path's
    launches (replica 0's and every worker's)."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.interop.jax_params import to_jax_params
    from bigdl_tpu_torch.models import transformer_lm
    from bigdl_tpu_torch.serving import (FleetSupervisor, InProcessReplica,
                                         ModelRegistry, RolloutController,
                                         ServingEngine, ServingFleet,
                                         SubprocessReplica)
    from bigdl_tpu_torch.serving.transport import (call_once,
                                                   dequantize_wire_tree,
                                                   mint_run_token,
                                                   quantize_tree_for_wire,
                                                   tree_wire_bytes)
    from bigdl_tpu_torch.serving.worker import probe_digest
    from bigdl_tpu_torch.utils import file_io

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="fleet_"))
    registry_path = root / "registry.json"
    token = mint_run_token()         # the workers' handshake secret
    workers = _FleetWorkers(root, registry_path, token)
    engines, fleet = [], None
    try:
        for rid in (1, 2):               # the two boot while replica 0 does
            workers.start(rid)
        model = transformer_lm("small", vocab_size=SERVE_VOCAB,
                               device="cuda", seed=0)
        probe = _fleet_probe_rows()
        t0 = time.perf_counter()
        eng0 = _fleet_engine(model, "fp32")
        eng0_i8 = _fleet_engine(model, "int8")
        engines += [eng0, eng0_i8]
        built = [e.precompile(example_feature=probe[0]) for e in engines]
        boot0_s = time.perf_counter() - t0
        reps = [InProcessReplica(eng0, rid=0)]
        for rid in (1, 2):
            rep = SubprocessReplica(workers.spawn(rid), rid=rid,
                                    request_timeout_s=120.0, token=token)
            rep.start(0)
            reps.append(rep)
        fleet = ServingFleet(reps, probe_features=probe,
                             probe_bucket=FLEET_MAX_BATCH,
                             default_timeout_s=120.0, breaker_reset_s=1.0,
                             retry_backoff_s=0.02,
                             wire_flush_every=10 ** 9, weight_wire="int8")
        emit({"phase": "fleet_boot", "replica0_engines_s": boot0_s,
              "replica0_captured": built, "workers": workers.boot_s,
              "card": card})

        # ---- (a) the fleet's main path: counts reset just before ------
        reqs = _fleet_requests(42, FLEET_PREDICTS, FLEET_GENERATES)
        prompts = [t for k, t in reqs if k == "generate"]
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        for rep in reps[1:]:
            _smoke(rep, reset=True)
        out, lat, wall, failures = _fleet_traffic(
            lambda t: fleet.predict(t, timeout=120.0),
            lambda t: fleet.generate(t, max_new_tokens=FLEET_NEW,
                                     timeout=120.0), reqs)
        # the int8-KV servers of the same processes: the same prompts,
        # each process's in turn
        i8_gen = [lambda t: eng0_i8.generate(
            t, max_new_tokens=FLEET_NEW).result(120.0)] + [
            lambda t, _port=_smoke(rep)["int8_port"]: call_once(
                "127.0.0.1", _port, "generate", rpc_timeout=125.0,
                auth_token=token, prompt=[int(v) for v in t],
                max_new_tokens=FLEET_NEW, timeout=120.0)
            for rep in reps[1:]]
        i8_out, _, i8_wall, i8_failures = _fleet_traffic(
            None, lambda jt: i8_gen[jt[0] % len(i8_gen)](jt[1]),
            [("generate", (j, p)) for j, p in enumerate(prompts)])
        torch.cuda.synchronize()
        parent_launches = {k: n for k, n in fa.LAUNCHES.items() if n}
        worker_reports = {rep.rid: _smoke(rep) for rep in reps[1:]}
        # ------------------------------------------------------------------
        launches = dict(parent_launches)
        for r in worker_reports.values():
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
        need = ("flash_attention", "flash_paged_decode_attention",
                "flash_paged_decode_attention_int8")
        for rid, r in worker_reports.items():
            missing = [k for k in need if not r["launches"].get(k)]
            if missing:
                raise AssertionError(f"fleet worker {rid} launched no "
                                     f"{missing}: {r['launches']}")
        if failures or i8_failures:
            raise AssertionError(f"fleet requests failed: "
                                 f"{(failures + i8_failures)[:5]}")
        # each prediction against replica 0's predict_at at batch rung 1
        # of the request zero-padded to its result's length rung (a tick
        # pads its requests to the longest one's rung)
        errs, bitwise = [], 0
        for (kind, toks), y in zip(reqs, out):
            if kind != "predict":
                continue
            x = np.zeros(y.shape[0], np.int32)
            x[:len(toks)] = toks
            want = eng0.predict_at(x, 1)
            if y.shape != want.shape or not np.isfinite(y).all():
                raise AssertionError(f"fleet predict: {y.shape} against "
                                     f"{want.shape}")
            errs.append(_max_rel(y, want))
            bitwise += bool(np.array_equal(y, want))
        ties = []
        for label, eng, streams in (("fp32_kv", eng0, [
                y for (k, _), y in zip(reqs, out) if k == "generate"]),
                                    ("int8_kv", eng0_i8, i8_out)):
            for p, got in zip(prompts, streams):
                ref = eng.generate(p, max_new_tokens=FLEET_NEW).result(600)
                tie = _stream_tie(model, p, ref, got)
                if tie is not None:
                    if tie["gap"] > TIE_MARGIN:
                        raise AssertionError(f"fleet {label} stream parts "
                                             f"from replica 0's: {tie}")
                    ties.append({"kv": label, **tie})
        if max(errs) > FLEET_TOL:
            raise AssertionError(f"fleet predict off replica 0's "
                                 f"predict_at by {max(errs)}")
        served = {rid: {k: d[k] for k in ("served", "failed", "breaker")}
                  for rid, d in fleet.replica_states().items()}
        emit({"phase": "fleet_serving", "requests": len(reqs),
              "predict_max_rel_err": max(errs),
              "predict_bitwise": f"{bitwise}/{len(errs)}",
              "tolerance": FLEET_TOL, "stream_ties": ties,
              "tie_margin": TIE_MARGIN, "replicas": served,
              "smoke_burst": _traffic_row(reqs, lat, wall),
              "int8_kv_generations": {"requests": len(prompts),
                                      "wall_s": i8_wall},
              "launches": {"replica0": parent_launches,
                           **{f"worker{rid}": r["launches"]
                              for rid, r in worker_reports.items()}},
              "counters": fleet.counters(), "card": card})
        # served rates: the fleet and replica 0's engine alone in turns
        # over the same windows, results dropped
        t0 = time.perf_counter()
        rates = _rate_windows({
            "fleet": (lambda t: fleet.predict(t, timeout=120.0),
                      lambda t: fleet.generate(t, max_new_tokens=FLEET_NEW,
                                               timeout=120.0)),
            "engine_alone": (lambda t: eng0.predict(t, timeout=120.0),
                             lambda t: eng0.generate(
                                 t, max_new_tokens=FLEET_NEW).result(120.0))},
            [_fleet_requests(50 + 3 * w, *FLEET_RATE_WINDOW)
             for w in range(FLEET_RATE_WINDOWS)])
        emit({"phase": "fleet_rates", **rates,
              "seconds": time.perf_counter() - t0, "card": card})

        # ---- (b) chaos: worker 1 SIGKILLed mid-traffic -----------------
        sup = FleetSupervisor(fleet, max_restarts=2, backoff_base_s=0.2,
                              backoff_max_s=2.0, jitter=0.0).start()
        chaos_feats = _lm_requests(45, tuple(
            FLEET_PREDICT_LENGTHS[j % len(FLEET_PREDICT_LENGTHS)]
            for j in range(FLEET_CHAOS_PREDICTS)))
        done = {"n": 0}
        lock = threading.Lock()
        killed = {}
        victim = fleet._by_id(1)

        def predict_and_maybe_kill(t):
            y = fleet.predict(t, timeout=240.0)
            with lock:
                done["n"] += 1
                if done["n"] == FLEET_KILL_AT:
                    killed["pid"] = victim.proc.pid
                    killed["t"] = time.perf_counter()
                    os.kill(victim.proc.pid, 9)
            return y

        try:
            _, c_lat, c_wall, c_failures = _fleet_traffic(
                predict_and_maybe_kill, None,
                [("predict", f) for f in chaos_feats])
            deadline = time.perf_counter() + FLEET_REJOIN_TIMEOUT_S
            while not (victim.state == "serving" and victim.alive()
                       and victim.proc.pid != killed.get("pid")):
                if time.perf_counter() > deadline:
                    raise AssertionError(f"worker 1 did not rejoin: "
                                         f"{victim.describe()}")
                time.sleep(0.1)
            rejoin_s = time.perf_counter() - killed["t"]
        finally:
            sup.close()
        rejoined = victim.probe(features=probe, bucket=FLEET_MAX_BATCH)
        digest0 = probe_digest(eng0, probe, FLEET_MAX_BATCH)
        chaos_row = {"phase": "fleet_chaos", "killed_pid": killed["pid"],
                     "killed_after_requests": FLEET_KILL_AT,
                     "requests": len(chaos_feats), "failed": c_failures,
                     "restarts": sup.events, "rejoin_s": rejoin_s,
                     "rejoined_pid": victim.proc.pid,
                     "rejoined_digest": rejoined, "replica0_digest": digest0,
                     "window": _traffic_row(
                         [("predict", f) for f in chaos_feats], c_lat,
                         c_wall),
                     "counters": fleet.counters(), "card": card}
        emit(chaos_row)
        if c_failures or len(sup.events) != 1 or rejoined != digest0:
            raise AssertionError(f"fleet chaos: {chaos_row}")

        # ---- (c) rollouts over the int8 weight wire ---------------------
        rec = _Recorder()
        registry = ModelRegistry(str(registry_path))
        ckpt = root / "ckpt"
        ctl = RolloutController(
            fleet, registry, str(ckpt), telemetry=rec, shadow_fraction=1.0,
            shadow_min_rows=8, min_top1_agreement=None,
            max_logit_rmse=100.0, canary_fraction=0.5, canary_min_ticks=2,
            stage_timeout_s=300.0, drain_timeout_s=60.0)
        ctl.baseline()
        commit_s = []
        real_commit = fleet.commit_replica

        def timed_commit(rid, handle, version=None, digest=None):
            t0 = time.perf_counter()
            real_commit(rid, handle, version=version, digest=digest)
            commit_s.append({"replica": rid, "version": version,
                             "seconds": time.perf_counter() - t0})

        fleet.commit_replica = timed_commit

        def snapshot(seed, tag):
            cand = transformer_lm("small", vocab_size=SERVE_VOCAB,
                                  device="cpu", seed=seed)
            ckpt.mkdir(exist_ok=True)
            target = str(ckpt / f"checkpoint.{tag}.pkl")
            file_io.atomic_save({"model_params": to_jax_params(cand),
                                 "model_state": None}, target)
            file_io.write_snapshot_manifest(target)
            return target

        def rollout():
            stop = threading.Event()
            errors = []

            def traffic():
                i = 0
                while not stop.is_set():
                    try:
                        fleet.predict(probe[i % len(probe)], timeout=240.0)
                    except Exception as e:
                        errors.append(f"{type(e).__name__}: {e}")
                    i += 1

            ts = [threading.Thread(target=traffic) for _ in range(2)]
            for t in ts:
                t.start()
            try:
                t0 = time.perf_counter()
                v = ctl.poll_once()
                return v, time.perf_counter() - t0, errors
            finally:
                stop.set()
                for t in ts:
                    t.join(300)

        path1 = snapshot(1, 1)
        p1, _ = eng0._load_snapshot_weights(
            ServingEngine._resolve_snapshot(path1))
        wire = {"fp32_bytes": tree_wire_bytes(p1),
                "int8_bytes": tree_wire_bytes(quantize_tree_for_wire(p1))}
        v2, roll_s, r_errors = rollout()
        stage_wire = fleet.wire_stats().get("stage_tree", {})
        digests = {0: probe_digest(eng0, probe, FLEET_MAX_BATCH)}
        for rep in reps[1:]:
            digests[rep.rid] = rep.probe(features=probe,
                                         bucket=FLEET_MAX_BATCH)
        # a fresh engine on the candidate as the int8 wire delivers it
        fresh_model = transformer_lm("small", vocab_size=SERVE_VOCAB,
                                     device="cuda", seed=1)
        fresh = _fleet_engine(fresh_model, "fp32")
        fresh.refresh_params(dequantize_wire_tree(
            quantize_tree_for_wire(p1)))
        cand_err = 0.0
        for row in probe:
            want = fresh.predict_at(row, 1)
            got = [eng0.predict_at(row, 1)] + [
                rep._call("predict", feature=row, timeout=120.0)
                for rep in reps[1:]]
            cand_err = max([cand_err] + [_max_rel(g, want) for g in got])
        fresh.close()
        del fresh, fresh_model
        deploys1 = [(e["version"], e["stage"], e["verdict"],
                     e.get("replica")) for e in ctl.events]
        # then a candidate whose gate fails on worker 1
        ctl.replica_gate = lambda rid, flt, h: (
            (False, "injected failing gate") if rid == 1
            else flt.gate_replica(rid, h))
        snapshot(2, 2)
        v3, roll3_s, r3_errors = rollout()
        after = {0: probe_digest(eng0, probe, FLEET_MAX_BATCH)}
        for rep in reps[1:]:
            after[rep.rid] = rep.probe(features=probe,
                                       bucket=FLEET_MAX_BATCH)
        deploys2 = [(e["version"], e["stage"], e["verdict"],
                     e.get("replica")) for e in ctl.events][len(deploys1):]
        rb = [e for e in ctl.events if e["stage"] == "rollback"]
        roll_row = {"phase": "fleet_rollouts", "wire": wire,
                    "stage_tree_wire": {k: stage_wire.get(k) for k in (
                        "calls", "bytes_sent", "rtt_s")},
                    "commit_s": commit_s, "rollout_s": roll_s,
                    "failgate_rollout_s": roll3_s,
                    "promoted": [v2.version, v2.stage],
                    "failgate": [v3.version, v3.stage],
                    "digests_after_promotion": digests,
                    "digests_after_failgate": after,
                    "candidate_max_rel_err": cand_err,
                    "tolerance": FLEET_TOL, "deploys": deploys1 + deploys2,
                    "rolled_back_replicas": rb[0]["replicas"] if rb else None,
                    "traffic_failures": r_errors + r3_errors,
                    "registry_live": registry.live.version, "card": card}
        emit(roll_row)
        if not (v2.stage == "live" and len(set(digests.values())) == 1
                and cand_err <= FLEET_TOL and v3.stage == "rejected"
                and after == digests and registry.live.version == v2.version
                and rb and rb[0]["replicas"] == [0]
                and ("cutover", "rejected", 1) in [
                    (s, vd, r) for _, s, vd, r in deploys2]
                and not any(r == 2 for _, s, _, r in deploys2
                            if s == "cutover")
                and not r_errors and not r3_errors):
            raise AssertionError(f"fleet rollouts: {roll_row}")

        # ---- (d) each process's card memory -----------------------------
        memory = {"replica0": _process_memory(),
                  **{f"worker{rep.rid}": _smoke(rep)["memory"]
                     for rep in reps[1:]}}
        emit({"phase": "fleet_memory", "processes": memory,
              "seconds": time.perf_counter() - t_phase, "card": card})
        return {"fleet": launches}
    finally:
        if fleet is not None:
            fleet.close()
        for e in engines:
            e.close()
        workers.close()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# Phase 17: the collective model-parallel strategies
# (optim/strategy_optimizer.py, parallel/tp.py, sequence.py, ep.py)
# --------------------------------------------------------------------------- #

#: (a) steps of each world-1 leg; (b) steps of each world-2 leg, and the
#: tp world-2 checkpoint (neval 3, after 2 steps) that (c) resumes
STRAT_STEPS, STRAT_W2_STEPS, STRAT_W2_CKPT_AT = 4, 3, 3
#: the legs: name, mesh axes, sequence mode
STRAT_LEGS = (("tp", ("data", "model"), None),
              ("sp_ring", ("data", "seq"), "ring"),
              ("sp_ulysses", ("data", "seq"), "ulysses"),
              ("ep", ("data", "expert"), None))
#: phase 17's MoE: "small"'s widths with the class's defaults
STRAT_MOE = {"num_experts": 8, "k": 2, "capacity_factor": 1.25}
STRAT_AUX_WEIGHT = 0.01
#: the kernels each leg launches a step (through the replays)
_K1, _K1B = "flash_attention", "flash_attention_bwd"
_K4, _K5 = "fused_softmax_cross_entropy", "fused_softmax_cross_entropy_bwd"
_K4S, _K5S = _K4 + "_shard", _K5 + "_shard"
STRAT_WANT = {"tp": {_K1: 12, _K1B: 12, _K4S: 1, _K5S: 1, _K4: 0, _K5: 0},
              "sp_ring": {_K1: 0, _K1B: 0, _K4: 1, _K5: 1, _K4S: 0,
                          _K5S: 0},
              "sp_ulysses": {_K1: 12, _K1B: 12, _K4: 1, _K5: 1, _K4S: 0,
                             _K5S: 0},
              "ep": {_K1: 12, _K1B: 12, _K4: 1, _K5: 1, _K4S: 0, _K5S: 0}}
#: (a) each leg against its one-process reference (LocalOptimizer; for
#: ep the same loss in an eager loop): per-step losses, and the
#: parameters relative to the update the reference applied
#: (``_update_rel``; no update reads 1).  Sound readings on the H100
#: (PERF.md): losses 9.1e-8; updates 2.7e-5 (tp), 4.1e-4 (the
#: ring's online softmax), 0 (Ulysses, ep)
STRAT_W1_LOSS_RTOL, STRAT_W1_UPD = 1e-5, 1e-2
#: (b) each world-2 leg against (a)'s leg after the same steps (sound:
#: losses 1.8e-7, updates 4.3e-5); (c) the resumed tp run against the
#: straight world-2 run (bitwise there)
STRAT_W2_LOSS_RTOL, STRAT_W2_UPD = 1e-5, 5e-3
#: (b) the vocabulary-parallel K4/K5 at (8192, 32000) over two shards
#: against their plain versions and against K4/K5 on the whole logits
STRAT_CE_TOL = 1e-4
STRAT_CHILD_TIMEOUT_S = 480


def _strategy_model(leg, seed=0):
    from bigdl_tpu_torch.models import transformer_lm
    from bigdl_tpu_torch.nn.moe import MoETransformerLM

    if leg == "ep":
        return MoETransformerLM(VOCAB, 768, HEADS, 12, max_len=SEQ,
                                device="cuda", seed=seed, **STRAT_MOE)
    mode = dict((n, m) for n, _, m in STRAT_LEGS)[leg]
    return transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                          seed=seed,
                          seq_axis_name="seq" if mode else None,
                          seq_mode=mode or "ring")


def _strategy_opt(leg, model, x, y, mesh):
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset

    strategy = leg.split("_")[0]
    kw = {"aux_weight": STRAT_AUX_WEIGHT} if strategy == "ep" else {}
    return optim.Optimizer(
        model, array_dataset(x, y) >> SampleToMiniBatch(BATCH), _lm_crit(),
        optim.Adam(learning_rate=1e-4), strategy=strategy, mesh=mesh, **kw)


def _moe_reference(model, x, y, steps):
    """The ep legs' one-process reference: task loss plus
    ``STRAT_AUX_WEIGHT`` x the aux loss, Adam(1e-4), eager, on the
    batches the strategy run takes (the first epoch in order); returns
    the task losses and the flat parameters after ``STRAT_W2_STEPS`` and
    after ``steps`` steps."""
    from bigdl_tpu_torch import optim

    crit, method = _lm_crit(), optim.Adam(learning_rate=1e-4)
    params = dict(model.named_parameters())
    state = method.init_state(params)
    losses, snap = [], None
    model.train()
    for i in range(steps):
        xb = torch.from_numpy(x[i * BATCH:(i + 1) * BATCH]).cuda()
        yb = torch.from_numpy(y[i * BATCH:(i + 1) * BATCH]).cuda()
        model.zero_grad(set_to_none=True)
        logits, aux = model(xb, return_aux=True)
        task = crit.apply(logits.float(), yb)
        (task + STRAT_AUX_WEIGHT * aux).backward()
        method.update({k: p.grad for k, p in params.items()}, state, params)
        losses.append(float(task.detach()))
        if i + 1 == STRAT_W2_STEPS:
            snap = _flat_params(model).detach().clone()
    return losses, snap, _flat_params(model).detach().clone()


def _strategy_counts(fa, ce):
    launches = {k: n - fa.BF16_LAUNCHES.get(k, 0)
                for k, n in fa.LAUNCHES.items()}
    launches.update(ce.LAUNCHES)
    return launches


def strategy_world1(fa, ce, card, x, y):
    """Phase 17 (a): each strategy at a world of one on NCCL, 4 steps,
    against its one-process reference; launches counted through the
    replays, the step one CUDA graph with NCCL's collectives in it, step
    time, tokens/s and peak memory beside the reference's.  Returns the
    launch counts by path, each leg's losses and its parameters after
    ``STRAT_W2_STEPS`` and ``STRAT_STEPS`` steps (on the host)."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.utils import cuda_graphs
    from bigdl_tpu_torch.utils.engine import Engine

    # the dense legs' reference: LocalOptimizer on the same weights
    model = _strategy_model("tp")
    start = _flat_params(model).detach().cpu()
    opt = optim.Optimizer(model, array_dataset(x, y) >> SampleToMiniBatch(
        BATCH), _lm_crit(), optim.Adam(learning_rate=1e-4))
    torch.cuda.reset_peak_memory_stats()
    # the snapshot stays on the card until the run ends: a copy to the
    # host inside the timed window would be timed
    snaps = {}
    clock_then = {STRAT_W2_STEPS: lambda: snaps.__setitem__(
        "local", _flat_params(model).detach().clone())}
    dense = _strategy_timed(opt, clock_then)
    dense.update(flat=_flat_params(model).detach().cpu(),
                 snap=snaps.pop("local").cpu(), start=start,
                 peak_bytes=torch.cuda.max_memory_allocated())
    del model, opt
    torch.cuda.empty_cache()
    model = _strategy_model("ep")
    moe_start = _flat_params(model).detach().cpu()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, snap, flat = _moe_reference(model, x, y, STRAT_STEPS)
    torch.cuda.synchronize()
    moe = {"losses": losses, "snap": snap.cpu(), "flat": flat.cpu(),
           "start": moe_start, "wall_s": time.perf_counter() - t0,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del model, flat, snap
    torch.cuda.empty_cache()

    paths, legs = {}, {}
    for leg, axes, _ in STRAT_LEGS:
        ref = moe if leg == "ep" else dense
        mesh = Engine.build_mesh((1, 1), axes)
        model = _strategy_model(leg)
        opt = _strategy_opt(leg, model, x, y, mesh)
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        ce.reset_launch_counts()
        captures = cuda_graphs.capture_count()
        snap = {}
        # ---- the strategy's main path: counts read right after --------
        run = _strategy_timed(opt, {STRAT_W2_STEPS: lambda: snap.update(
            flat=_flat_params(opt.plan.local).detach().clone())})
        launches = _strategy_counts(fa, ce)
        # ----------------------------------------------------------------
        stats = opt.compiled_stats
        flat = _flat_params(model).detach().cpu()
        step_rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                        ref["losses"])]
        upd = _update_rel(flat.numpy(), ref["flat"].numpy(),
                          ref["start"].numpy())
        want = {k: n * STRAT_STEPS for k, n in STRAT_WANT[leg].items()}
        got = {k: launches.get(k, 0) for k in want}
        row = {"phase": "strategy_world1", "leg": leg,
               "mesh": dict(mesh.shape), "world": 1,
               "backend": torch.distributed.get_backend(),
               "route": opt.captured_route,
               "nccl_captured_in_graph": opt.captured_route == "nccl-graph"
               and stats["captured"] == 1,
               "graphs": stats["captured"], "replays": stats["replays"],
               "captures": cuda_graphs.capture_count() - captures,
               "graph_pool_bytes": stats["pool_bytes"],
               "step_s": run["step_s"],
               "tokens_per_s": BATCH * SEQ / run["step_s"],
               "reference": "eager MoE loop" if leg == "ep"
               else "LocalOptimizer",
               "reference_step_s": ref.get("step_s"),
               "reference_tokens_per_s": ref.get("tokens_per_s"),
               "reference_wall_s": ref.get("wall_s"),
               "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
               "reference_peak_allocated_bytes": ref["peak_bytes"],
               "losses": run["losses"], "reference_losses": ref["losses"],
               "max_step_loss_rel": max(step_rel),
               "param_rel_l2": rel_l2(flat, ref["flat"]),
               "param_update_rel": upd,
               "tolerance": {"loss": STRAT_W1_LOSS_RTOL,
                             "update": STRAT_W1_UPD},
               "launches": got, "card": card}
        emit(row)
        if len(run["losses"]) != STRAT_STEPS or \
                max(step_rel) > STRAT_W1_LOSS_RTOL or upd > STRAT_W1_UPD:
            raise AssertionError(f"{leg} world 1 against its reference: "
                                 f"{row}")
        if not row["nccl_captured_in_graph"] or \
                stats["replays"] != STRAT_STEPS:
            raise AssertionError(f"{leg}: the NCCL step was not one "
                                 f"captured graph: {row}")
        if got != want:
            raise AssertionError(f"{leg} launches {got}, want {want}")
        paths[f"strategy_{leg}"] = {k: n for k, n in got.items() if n}
        legs[leg] = {"losses": run["losses"], "snap": snap.pop("flat").cpu(),
                     "flat": flat, "start": ref["start"]}
        del model, opt, mesh
        gc.collect()
        torch.cuda.empty_cache()
    return paths, legs


def _strategy_timed(opt, then):
    """``opt.optimize()`` for ``STRAT_STEPS`` steps with a loss summary,
    ``then[i]`` run at the top of step ``i`` after a sync; the mean step
    time over steps 2 to the last (each a replay)."""
    summary = _Losses()
    opt.set_train_summary(summary)
    first = 1
    clock = StepClock(opt, STRAT_STEPS,
                      sync_at=(first, STRAT_STEPS, *then), then=then)
    opt.set_end_when(clock)
    torch.cuda.synchronize()
    opt.optimize()
    torch.cuda.synchronize()
    step_s = (clock.marks[STRAT_STEPS][0] - clock.marks[first][0]) \
        / (STRAT_STEPS - first)
    return {"losses": summary.scalars["Loss"], "step_s": step_s,
            "tokens_per_s": BATCH * SEQ / step_s}


def _vocab_parallel_check(ce, coll):
    """(b)'s vocabulary-parallel K4/K5 on this rank's half of (8192,
    32000) logits: the shard pass against its plain version, the
    combined loss and lse against K4 on the whole logits, and K5 on the
    shard against its plain version and against K5's columns of the
    whole logits."""
    n, v = BATCH * SEQ, VOCAB
    g = torch.Generator(device="cuda").manual_seed(17)
    full = torch.randn(n, v, generator=g, device="cuda")
    labels = torch.randint(0, v, (n,), generator=g, device="cuda")
    gr = torch.rand(n, generator=g, device="cuda") + 0.5
    vs = v // coll.world
    off = coll.rank * vs
    x = full[:, off:off + vs].contiguous()
    local = ce.shard_labels(labels, off, vs)
    lse_l, picked_l = ce.fused_softmax_cross_entropy_shard_fwd(x, local)
    want_lse_l, want_picked_l = ce.fused_softmax_cross_entropy_shard_reference(
        x, local)
    err = {"shard_lse": check_close("K4 shard lse", lse_l, want_lse_l),
           "shard_picked": check_close("K4 shard picked", picked_l,
                                       want_picked_l)}
    lse, picked = ce.combine_shard_stats(lse_l, picked_l, coll)
    loss_full, lse_full = ce.fused_softmax_cross_entropy_fwd(full, labels)
    err["global_loss_vs_whole"] = check_close(
        "vocab-parallel loss", lse - picked, loss_full, STRAT_CE_TOL,
        STRAT_CE_TOL)
    err["global_lse_vs_whole"] = check_close(
        "vocab-parallel lse", lse, lse_full, STRAT_CE_TOL, STRAT_CE_TOL)
    dx = ce.fused_softmax_cross_entropy_bwd(
        x, local, lse, gr, name="fused_softmax_cross_entropy_bwd_shard")
    err["shard_grad"] = check_close(
        "K5 shard", dx, ce.fused_softmax_cross_entropy_grad_reference(
            x, local, lse, gr), atol=0.0)
    whole = ce.fused_softmax_cross_entropy_bwd(full, labels, lse_full, gr)
    err["shard_grad_vs_whole"] = check_close(
        "K5 shard against the whole", dx, whole[:, off:off + vs],
        STRAT_CE_TOL, STRAT_CE_TOL)
    sentinel = int((local == -1).sum())
    return {"shape": [n, vs], "offset": off, "sentinel_rows": sentinel,
            "errors": err}


def strategy_child(rank, world, init, job_path, out):
    """Phase 17 (b)-(c), one rank of the gloo world sharing the card:
    each leg for ``STRAT_W2_STEPS`` steps on a (1, 2) mesh (the tp leg
    writes its checkpoint), the vocabulary-parallel K4/K5 check, and the
    tp checkpoint resumed at the same layout.  Results to
    ``out/rank<r>.json`` and, from rank 0, each leg's parameters."""
    import torch.distributed as dist

    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.models import synthetic_corpus
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import cross_entropy as ce
    from bigdl_tpu_torch.utils import file_io
    from bigdl_tpu_torch.utils.engine import Engine

    torch.cuda.set_device(0)
    _build.load()
    with open(job_path) as f:
        job = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=world, rank=rank)
    out = Path(out)
    res = {}
    try:
        x, y = synthetic_corpus(64, SEQ, VOCAB)
        for leg, axes, _ in STRAT_LEGS:
            mesh = Engine.build_mesh((1, world), axes)
            model = _strategy_model(leg)
            opt = _strategy_opt(leg, model, x, y, mesh)
            summary = _Losses()
            opt.set_train_summary(summary)
            opt.set_end_when(optim.Trigger.max_iteration(STRAT_W2_STEPS))
            if leg == "tp":
                opt.set_checkpoint(job["ckpt"], lambda s: s["neval"]
                                   == STRAT_W2_CKPT_AT)
            t0 = time.perf_counter()
            opt.optimize()
            torch.cuda.synchronize()
            res[leg] = {"losses": summary.scalars["Loss"],
                        "wall_s": time.perf_counter() - t0,
                        "route": opt.captured_route,
                        "mesh": dict(mesh.shape)}
            if rank == 0:
                np.save(out / f"flat_{leg}.npy",
                        _flat_params(model).cpu().numpy())
            del model, opt, mesh
            gc.collect()
            torch.cuda.empty_cache()
            if leg == "tp":
                res["vocab_parallel_ce"] = _vocab_parallel_check(
                    ce, Engine.build_mesh((1, world), axes).collectives(
                        "model"))
                torch.cuda.empty_cache()
        # (c): the tp checkpoint resumed at the same layout
        intact, _ = file_io.scan_checkpoints(job["ckpt"])
        res["tp_layout"] = file_io.read_manifest(intact[0])["layout"]
        mesh = Engine.build_mesh((1, world), ("data", "model"))
        model = _strategy_model("tp", seed=1)
        opt = _strategy_opt("tp", model, x, y, mesh)
        summary = _Losses()
        opt.set_train_summary(summary)
        opt.resume_from_checkpoint(job["ckpt"])
        opt.set_end_when(optim.Trigger.max_iteration(STRAT_W2_STEPS))
        opt.optimize()
        res["tp_resume"] = {"losses": summary.scalars["Loss"],
                            "neval": opt.driver_state["neval"]}
        if rank == 0:
            np.save(out / "flat_tp_resume.npy",
                    _flat_params(model).cpu().numpy())
    finally:
        dist.destroy_process_group()
    with open(out / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    return 0


def _spawn_strategy_world(root, job):
    """Start the two gloo ranks (this script, ``--strategy-rank``), wait
    for them under ``STRAT_CHILD_TIMEOUT_S``, kill both on a hang or a
    failure; returns their results."""
    out = root / "w2"
    out.mkdir()
    job_path = root / "job.json"
    job_path.write_text(json.dumps(job))
    init = root / "rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--strategy-rank",
         str(r), "2", str(init), str(job_path), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [None, None]
    try:
        deadline = time.monotonic() + STRAT_CHILD_TIMEOUT_S
        for r, p in enumerate(procs):
            logs[r] = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"phase 17 world-2 rank {bad[0]} failed:\n"
                             f"{(logs[bad[0]] or '')[-3000:]}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(2)], out


def vocab_parallel_rows(ce, card):
    """The vocabulary-parallel K4/K5 rows of the kernels line: the shard
    pass and K5 on a shard with shard-local labels (about half of them
    the sentinel) at the main path's (8192, 32000) (tp at world 1: one
    shard) and at world 2's (8192, 16000), against their plain versions,
    timed beside their bounds.  No single PyTorch call gives a shard's
    lse and picked logit, or K5's gradient from a global lse: no library
    time."""
    g = torch.Generator(device="cuda").manual_seed(18)
    n = BATCH * SEQ
    rows = {}
    for shards in (1, 2):
        v = VOCAB // shards
        x = torch.randn(n, v, generator=g, device="cuda")
        labels = torch.randint(0, VOCAB, (n,), generator=g, device="cuda")
        local = ce.shard_labels(labels, 0, v)
        lse, picked = ce.fused_softmax_cross_entropy_shard_fwd(x, local)
        want = ce.fused_softmax_cross_entropy_shard_reference(x, local)
        err = max(check_close("K4 shard lse", lse, want[0]),
                  check_close("K4 shard picked", picked, want[1]))
        ms, lo, hi = device_ms(
            lambda: ce.fused_softmax_cross_entropy_shard_fwd(x, local))
        plain = device_ms(
            lambda: ce.fused_softmax_cross_entropy_shard_reference(
                x, local))[0]
        # the shard read once, the labels read, loss, lse and picked out
        bms, by = bound(n * v * 4 + n * 4 + 3 * n * 4, 4 * n * v)
        row = dict(name=_K4S, case=f"N{n}_V{v} ({shards} shard"
                   f"{'s' if shards > 1 else ''})", max_abs_err=err, ms=ms,
                   ms_min=lo, ms_max=hi, plain_ms=plain, bound_ms=bms,
                   bound_by=by, library_ms=None,
                   sentinel_rows=int((local == -1).sum()), card=card)
        emit({"phase": "kernel", **row})
        rows.setdefault(_K4S, row)
        gr = torch.rand(n, generator=g, device="cuda") + 0.5
        dx = ce.fused_softmax_cross_entropy_bwd(x, local, lse, gr,
                                                name=_K5S)
        err = check_close("K5 shard", dx,
                          ce.fused_softmax_cross_entropy_grad_reference(
                              x, local, lse, gr), atol=0.0)
        del dx
        gr = torch.full((n,), 1.0 / n, device="cuda")
        ms, lo, hi = device_ms(lambda: ce.fused_softmax_cross_entropy_bwd(
            x, local, lse, gr, name=_K5S))
        plain = device_ms(
            lambda: ce.fused_softmax_cross_entropy_grad_reference(
                x, local, lse, gr))[0]
        bms, by = bound(2 * n * v * 4 + 3 * n * 4, 4 * n * v)
        row = dict(name=_K5S, case=f"N{n}_V{v} ({shards} shard"
                   f"{'s' if shards > 1 else ''})", max_abs_err=err, ms=ms,
                   ms_min=lo, ms_max=hi, plain_ms=plain, bound_ms=bms,
                   bound_by=by, library_ms=None, card=card)
        emit({"phase": "kernel", **row})
        rows.setdefault(_K5S, row)
        del x
        torch.cuda.empty_cache()
    return rows


def strategy_phase(fa, ce, card):
    """Phase 17: the model-parallel strategies.  Returns the launch
    counts by path and the vocabulary-parallel K4/K5 rows."""
    import shutil
    import tempfile

    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.models import synthetic_corpus
    from bigdl_tpu_torch.utils.engine import Engine

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_strategies_"))
    try:
        rows = vocab_parallel_rows(ce, card)
        Engine.init()                  # NCCL, a world of one on the card
        x, y = synthetic_corpus(64, SEQ, VOCAB)
        paths, legs = strategy_world1(fa, ce, card, x, y)

        # (b), (c): the gloo world of two sharing the card
        t0 = time.perf_counter()
        ckpt = root / "ckpt_tp"
        ranks, out = _spawn_strategy_world(root, {"ckpt": str(ckpt)})
        w2_s = time.perf_counter() - t0
        for leg, _, _ in STRAT_LEGS:
            ref = legs[leg]
            flat = torch.from_numpy(np.load(out / f"flat_{leg}.npy"))
            losses = [r[leg]["losses"] for r in ranks]
            step_rel = _max_step_rel(losses[0], ref["losses"])
            upd = _update_rel(flat.numpy(), ref["snap"].numpy(),
                              ref["start"].numpy())
            row = {"phase": "strategy_world2", "leg": leg,
                   "label": "correctness only: two gloo ranks sharing "
                            "one card, eager, host-routed collectives",
                   "mesh": ranks[0][leg]["mesh"],
                   "routes": [r[leg]["route"] for r in ranks],
                   "losses": losses[0],
                   "world1_losses": ref["losses"][:STRAT_W2_STEPS],
                   "ranks_agree": losses[0] == losses[1],
                   "max_step_loss_rel": step_rel,
                   "param_rel_l2": rel_l2(flat, ref["snap"]),
                   "param_update_rel": upd,
                   "wall_s": [r[leg]["wall_s"] for r in ranks],
                   "tolerance": {"loss": STRAT_W2_LOSS_RTOL,
                                 "update": STRAT_W2_UPD}, "card": card}
            emit(row)
            if len(losses[0]) != STRAT_W2_STEPS or \
                    not row["ranks_agree"] or \
                    step_rel > STRAT_W2_LOSS_RTOL or upd > STRAT_W2_UPD or \
                    row["routes"] != ["eager", "eager"]:
                raise AssertionError(f"{leg} world 2 against world 1: "
                                     f"{row}")
        ce_rows = [r["vocab_parallel_ce"] for r in ranks]
        emit({"phase": "strategy_vocab_parallel_ce", "ranks": ce_rows,
              "tolerance": STRAT_CE_TOL, "card": card})
        if any(e > STRAT_CE_TOL for r in ce_rows
               for e in r["errors"].values()) or \
                any(not r["sentinel_rows"] for r in ce_rows):
            raise AssertionError(f"vocabulary-parallel K4/K5: {ce_rows}")

        # (c) the checkpoint: JAX's layout block; resumed at the same
        # layout, and at world 1 (redistributed), it continues the
        # straight run
        from bigdl_tpu_torch.parallel.reshard import LayoutSpec
        from bigdl_tpu_torch.parallel.tp import TRANSFORMER_TP_RULES

        want_layout = LayoutSpec.tp({"data": 1, "model": 2},
                                    rules=TRANSFORMER_TP_RULES,
                                    block_layout="unrolled").to_manifest()
        resumed = [r["tp_resume"]["losses"] for r in ranks]
        straight = [r["tp"]["losses"] for r in ranks]
        flat_r = torch.from_numpy(np.load(out / "flat_tp_resume.npy"))
        flat_s = torch.from_numpy(np.load(out / "flat_tp.npy"))
        mesh = Engine.build_mesh((1, 1), ("data", "model"))
        model = _strategy_model("tp", seed=1)
        opt = _strategy_opt("tp", model, x, y, mesh)
        summary = _Losses()
        opt.set_train_summary(summary)
        opt.resume_from_checkpoint(str(ckpt))
        opt.set_end_when(optim.Trigger.max_iteration(STRAT_W2_STEPS))
        opt.optimize()
        world1 = {"losses": summary.scalars["Loss"],
                  "neval": opt.driver_state["neval"],
                  "param_update_rel": _update_rel(
                      _flat_params(model).detach().cpu().numpy(),
                      flat_s.numpy(), legs["tp"]["start"].numpy())}
        del model, opt, mesh
        gc.collect()
        torch.cuda.empty_cache()
        c_row = {"phase": "strategy_checkpoint",
                 "layout": ranks[0]["tp_layout"],
                 "layout_is_jax": ranks[0]["tp_layout"] == want_layout,
                 "resumed_losses": resumed[0],
                 "straight_tail": straight[0][STRAT_W2_CKPT_AT - 1:],
                 "resumed_neval": ranks[0]["tp_resume"]["neval"],
                 "resumed_param_rel_l2": rel_l2(flat_r, flat_s),
                 "bitwise": resumed[0] == straight[0][STRAT_W2_CKPT_AT - 1:]
                 and torch.equal(flat_r, flat_s),
                 "world1_resumed": world1, "card": card}
        emit(c_row)
        if not c_row["layout_is_jax"] or \
                c_row["resumed_neval"] != STRAT_W2_STEPS + 1 or \
                _max_step_rel(resumed[0], c_row["straight_tail"]) > \
                STRAT_W2_LOSS_RTOL or \
                c_row["resumed_param_rel_l2"] > STRAT_W2_LOSS_RTOL or \
                world1["neval"] != STRAT_W2_STEPS + 1 or \
                _max_step_rel(world1["losses"], c_row["straight_tail"]) > \
                STRAT_W2_LOSS_RTOL or world1["param_update_rel"] > \
                STRAT_W2_UPD:
            raise AssertionError(f"strategy checkpoints: {c_row}")
        emit({"phase": "strategy_done", "world2_s": w2_s,
              "seconds": time.perf_counter() - t_phase, "card": card})
        return paths, rows
    finally:
        Engine.reset()
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------- #
# Phase 18: pipeline parallelism (parallel/pp.py, parallel/pp_het.py,
# strategy="pp"), and serving a pipelined run's checkpoint
# --------------------------------------------------------------------------- #

#: (a) steps a schedule at world 1; (b) steps at world 2, the GPipe
#: leg's checkpoint (neval 3, after 2 steps) that (c) resumes
PP_STEPS, PP_W2_STEPS, PP_CKPT_AT = 4, 3, 3
#: microbatches a step, and the depth of (b)'s model (two blocks a stage)
PP_MICRO, PP_W2_LAYERS = 4, 4
PP_SCHEDULES = ("gpipe", "1f1b")
#: the kernels a step launches (derived from JAX's schedules, not
#: measured): every block once a microbatch forward (1F1B twice: its
#: forward and the recompute for the backward leg) and once backward;
#: the tail's K4 and K5 once a step over the concatenated microbatches
#: (GPipe), once a microbatch (1F1B).  pp+tp (d) launches the same
#: counts: its tail is the plain, whole-vocabulary K4/K5
PP_WANT = {"gpipe": {_K1: 12 * PP_MICRO, _K1B: 12 * PP_MICRO, _K4: 1,
                     _K5: 1},
           "1f1b": {_K1: 2 * 12 * PP_MICRO, _K1B: 12 * PP_MICRO,
                    _K4: PP_MICRO, _K5: PP_MICRO}}
#: (a) against LocalOptimizer (phase 17's tolerances: losses, and the
#: parameters relative to the reference's update); (b) world 2 against
#: (a)'s code at world 1 on the same 4-layer model; (c) a resume across
#: layouts against the straight world-2 run
PP_LOSS_RTOL, PP_UPD, PP_W2_UPD = 1e-5, 1e-2, 5e-3
#: (d) the four gloo ranks' pp+tp (1, 2, 2) losses against pp at world 1
#: on the same 4-layer model
PP_TP_W4_RTOL = 1e-6
PP_AXES, PP_AXES3 = ("data", "pipe"), ("data", "pipe", "model")
#: (e) the heterogeneous pipeline: AlexNetOWT (no dropout), batch 128 of
#: 224 x 224 x 3 images in 4 microbatches, SGD; losses against
#: LocalOptimizer (the convolutions see batch 32 where the reference
#: sees 128: cuDNN may pick other algorithms, so the bound is looser
#: than (a)'s), bf16 against fp32, the gloo ranks against world 1
HET_BATCH, HET_SIDE, HET_STEPS, HET_CKPT_AT = 128, 224, 4, 3
HET_LOSS_RTOL, HET_BF16_RTOL, HET_W2_RTOL = 1e-4, 5e-2, 1e-5
#: (e) the explicit uneven cut of the gloo ranks: stage 1 from conv4
HET_BOUNDARIES = [8]
#: (f) the refreshed engine: decode slots (one prompt each), cache
#: length, the longest prompt, new tokens a request
PP_SERVE_SLOTS, PP_SERVE_LEN = 4, 256
PP_SERVE_PROMPT, PP_SERVE_NEW = 200, 16
PP_CHILD_TIMEOUT_S = 300


def _pp_model(layers=12, seed=0):
    from bigdl_tpu_torch.nn import TransformerLM

    return TransformerLM(VOCAB, 768, HEADS, layers, max_len=SEQ,
                         device="cuda", seed=seed)


def _pp_opt(model, x, y, mesh, schedule, strategy="pp",
            tensor_parallel=False):
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset

    kw = {"n_microbatches": PP_MICRO, "schedule": schedule} \
        if strategy == "pp" else {}
    if tensor_parallel:
        kw["tensor_parallel"] = True
    return optim.Optimizer(
        model, array_dataset(x, y) >> SampleToMiniBatch(BATCH), _lm_crit(),
        optim.Adam(learning_rate=1e-4), strategy=strategy, mesh=mesh, **kw)


def _pp_timed(opt, steps):
    """``opt.optimize()`` for ``steps`` steps; the losses and the mean
    step time over steps 2 to the last (each a replay on NCCL)."""
    summary = _Losses()
    opt.set_train_summary(summary)
    clock = StepClock(opt, steps, sync_at=(1, steps))
    opt.set_end_when(clock)
    torch.cuda.synchronize()
    opt.optimize()
    torch.cuda.synchronize()
    step_s = (clock.marks[steps][0] - clock.marks[1][0]) / (steps - 1)
    return {"losses": summary.scalars["Loss"], "step_s": step_s}


def _free():
    """Collect what the caller dropped and hand the cached blocks back."""
    gc.collect()
    torch.cuda.empty_cache()


def _pp_leg(fa, ce, card, x, y, ref, start, schedule, tensor_parallel):
    """One world-1 leg of (a) or (d): 12-layer "small" through
    ``strategy="pp"`` on NCCL, against ``ref`` (LocalOptimizer); returns
    its row, launches and peak memory (and raises on a miss)."""
    from bigdl_tpu_torch.utils import cuda_graphs
    from bigdl_tpu_torch.utils.engine import Engine

    shape, axes = ((1, 1, 1), PP_AXES3) if tensor_parallel \
        else ((1, 1), PP_AXES)
    mesh = Engine.build_mesh(shape, axes)
    model = _pp_model()
    opt = _pp_opt(model, x, y, mesh, schedule,
                  tensor_parallel=tensor_parallel)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ce.reset_launch_counts()
    captures = cuda_graphs.capture_count()
    # ---- the pipeline's main path: counts read right after ----------
    run = _pp_timed(opt, PP_STEPS)
    launches = _strategy_counts(fa, ce)
    # ------------------------------------------------------------------
    stats = opt.compiled_stats
    peak = torch.cuda.max_memory_allocated()
    flat = _flat_params(model).detach().cpu()
    step_rel = _max_step_rel(run["losses"], ref["losses"])
    upd = _update_rel(flat.numpy(), ref["flat"].numpy(), start.numpy())
    want = {k: n * PP_STEPS for k, n in PP_WANT[schedule].items()}
    if tensor_parallel:
        want.update({_K4S: 0, _K5S: 0})
    got = {k: launches.get(k, 0) for k in want}
    row = {"phase": "pp_tp_world1" if tensor_parallel else "pp_world1",
           "schedule": schedule, "mesh": dict(mesh.shape),
           "microbatches": PP_MICRO,
           "backend": torch.distributed.get_backend(),
           "route": opt.captured_route, "graphs": stats["captured"],
           "replays": stats["replays"],
           "captures": cuda_graphs.capture_count() - captures,
           "graph_pool_bytes": stats["pool_bytes"],
           "step_s": run["step_s"],
           "tokens_per_s": BATCH * SEQ / run["step_s"],
           "reference_step_s": ref["step_s"],
           "reference_tokens_per_s": BATCH * SEQ / ref["step_s"],
           "peak_allocated_bytes": peak,
           "reference_peak_allocated_bytes": ref["peak_bytes"],
           "losses": run["losses"], "reference_losses": ref["losses"],
           "max_step_loss_rel": step_rel, "param_update_rel": upd,
           "tolerance": {"loss": PP_LOSS_RTOL, "update": PP_UPD},
           "launches": got, "want": want, "card": card}
    emit(row)
    what = f"pp{'+tp' if tensor_parallel else ''} {schedule}"
    if len(run["losses"]) != PP_STEPS or step_rel > PP_LOSS_RTOL or \
            upd > PP_UPD:
        raise AssertionError(f"{what} world 1 against LocalOptimizer: "
                             f"{row}")
    if stats["captured"] != 1 or stats["replays"] != PP_STEPS or \
            opt.captured_route != "nccl-graph":
        raise AssertionError(f"{what}: the step was not one captured "
                             f"graph: {row}")
    if got != want:
        raise AssertionError(f"{what} launches {got}, want {want}")
    del model, opt, mesh
    _free()
    return got, peak


def pp_world1(fa, ce, card, x, y):
    """Phase 18 (a) and (d)'s world-1 legs: "small" pipelined at a world
    of one on NCCL, GPipe and 1F1B, then with tensor parallelism on
    (1, 1, 1), each against LocalOptimizer on the same weights and
    batches; launches counted through the replays.  Returns the launch
    counts by path and each leg's peak memory."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset

    model = _pp_model()
    start = _flat_params(model).detach().cpu()
    opt = optim.Optimizer(model, array_dataset(x, y) >> SampleToMiniBatch(
        BATCH), _lm_crit(), optim.Adam(learning_rate=1e-4))
    torch.cuda.reset_peak_memory_stats()
    ref = _pp_timed(opt, PP_STEPS)
    ref.update(flat=_flat_params(model).detach().cpu(),
               peak_bytes=torch.cuda.max_memory_allocated())
    del model, opt
    _free()
    paths, peaks = {}, {}
    for tp in (False, True):
        for schedule in PP_SCHEDULES:
            name = f"pp_{'tp_' if tp else ''}{schedule}"
            paths[name], peaks[name] = _pp_leg(fa, ce, card, x, y, ref,
                                               start, schedule, tp)
    if peaks["pp_1f1b"] >= peaks["pp_gpipe"]:
        raise AssertionError(f"1F1B's peak {peaks['pp_1f1b']} is not below "
                             f"GPipe's {peaks['pp_gpipe']} at M={PP_MICRO}")
    return paths, peaks


def pp_shallow(x, y, schedule, steps=PP_W2_STEPS, mesh_shape=(1, 1),
               ckpt=None, resume=None, strategy="pp", tensor_parallel=False):
    """(b)'s 4-layer model at full width through ``strategy`` on a mesh
    of ``mesh_shape`` over the current world (``("data", "pipe",
    "model")`` for three axes): its losses, wall seconds and final
    parameters (flat, on the host)."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.utils.engine import Engine

    axes = (PP_AXES3 if len(mesh_shape) == 3 else PP_AXES) \
        if strategy == "pp" else ("data", "model")
    mesh = Engine.build_mesh(mesh_shape, axes)
    model = _pp_model(PP_W2_LAYERS)
    opt = _pp_opt(model, x, y, mesh, schedule, strategy, tensor_parallel)
    summary = _Losses()
    opt.set_train_summary(summary)
    opt.set_end_when(optim.Trigger.max_iteration(steps))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, lambda s: s["neval"] == PP_CKPT_AT)
    if resume is not None:
        opt.resume_from_checkpoint(resume)
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    out = {"losses": summary.scalars["Loss"],
           "wall_s": time.perf_counter() - t0, "route": opt.captured_route,
           "neval": opt.driver_state["neval"],
           "flat": _flat_params(model).detach().cpu()}
    del model, opt, mesh
    _free()
    return out


def _het_data(n=2 * HET_BATCH):
    """``n`` images (NHWC, from seed 0 on the host) and their classes."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((n, HET_SIDE, HET_SIDE, 3), generator=g)
    y = torch.randint(0, 1000, (n,), generator=g, dtype=torch.int32)
    return x.numpy(), y.numpy()


def het_run(x, y, steps, mesh_shape=None, compute_dtype=None,
            boundaries=None, ckpt=None, resume=None, clock=False,
            batch=HET_BATCH):
    """AlexNetOWT (no dropout, seed 0) through the heterogeneous pipeline
    on a ``("data", "pipe")`` mesh of ``mesh_shape`` over the current
    world (None: LocalOptimizer), SGD with momentum, ``batch`` a step
    in 4 microbatches: its losses, wall seconds, route, graph stats,
    peak memory and final parameters (flat, on the host); with
    ``clock`` the mean step time over steps 2 to the last."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.models.alexnet import AlexNetOWT
    from bigdl_tpu_torch.utils.engine import Engine

    model = AlexNetOWT(1000, has_dropout=False, device="cuda", seed=0)
    ds = array_dataset(x, y) >> SampleToMiniBatch(batch)
    method = optim.SGD(learning_rate=0.01, momentum=0.9)
    mesh = None
    if mesh_shape is None:
        opt = optim.Optimizer(model, ds, nn.ClassNLLCriterion(), method)
    else:
        mesh = Engine.build_mesh(mesh_shape, PP_AXES)
        kw = {"n_microbatches": 4}
        if boundaries is not None:
            kw["boundaries"] = boundaries
        opt = optim.Optimizer(model, ds, nn.ClassNLLCriterion(), method,
                              strategy="pp", mesh=mesh, **kw)
    if compute_dtype is not None:
        opt.set_compute_dtype(compute_dtype)
    if ckpt is not None:
        opt.set_checkpoint(ckpt, lambda s: s["neval"] == HET_CKPT_AT)
    if resume is not None:
        opt.resume_from_checkpoint(resume)
    summary = _Losses()
    opt.set_train_summary(summary)
    marks = StepClock(opt, steps, sync_at=(1, steps)) if clock else None
    opt.set_end_when(marks or optim.Trigger.max_iteration(steps))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    out = {"losses": summary.scalars["Loss"],
           "wall_s": time.perf_counter() - t0,
           "route": getattr(opt, "captured_route", None),
           "stats": getattr(opt, "compiled_stats", None),
           "neval": opt.driver_state["neval"],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "flat": _flat_params(model).detach().cpu()}
    if marks is not None:
        out["step_s"] = (marks.marks[steps][0] - marks.marks[1][0]) \
            / (steps - 1)
    plan = getattr(opt, "plan", None)
    if plan is not None:
        out["slices"] = plan.slices
    del model, opt, mesh, plan
    _free()
    return out


@contextlib.contextmanager
def _checkpoint_clock():
    """Host seconds spent in ``StrategyOptimizer._checkpoint`` (the
    gathers, rank 0's write, the barrier) and in its
    ``file_io.save_checkpoint`` (the write alone), summed over the
    block: ``{"checkpoint_s": ..., "write_s": ...}``."""
    from bigdl_tpu_torch.optim import strategy_optimizer as so
    from bigdl_tpu_torch.utils import file_io

    spent = {"checkpoint_s": 0.0, "write_s": 0.0}
    saved = so.StrategyOptimizer._checkpoint, file_io.save_checkpoint

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    so.StrategyOptimizer._checkpoint = timed(saved[0], "checkpoint_s")
    file_io.save_checkpoint = timed(saved[1], "write_s")
    try:
        yield spent
    finally:
        so.StrategyOptimizer._checkpoint, file_io.save_checkpoint = saved


def pp_child(rank, world, init, job_path, out):
    """Phase 18 (b), (d) and (e), one rank of a gloo world sharing the
    card.  World 2: GPipe (writing (c)'s checkpoint) and 1F1B on a
    (1, 2) mesh, ``PP_W2_STEPS`` steps each, (e)'s heterogeneous
    pipeline on (1, 2) with the automatic and the explicit cut, and its
    world-1 checkpoint resumed on (1, 2), which must raise, then (d)'s
    pp+tp checkpoint (from world 4, running at the same time) resumed
    as pp (1, 2) and as pp+tp (1, 2, 1).  World 4: pp+tp on (1, 2, 2),
    GPipe (writing its checkpoint) and 1F1B.  Results to
    ``out/rank<r>.json``; rank 0 also saves each leg's parameters."""
    import torch.distributed as dist

    from bigdl_tpu_torch.models import synthetic_corpus
    from bigdl_tpu_torch.ops import _build

    torch.cuda.set_device(0)
    _build.load()
    with open(job_path) as f:
        job = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=world, rank=rank)
    out = Path(out)
    res = {}

    def keep(name, r):
        flat = r.pop("flat")
        if rank == 0:
            np.save(out / f"flat_{name}.npy", flat.numpy())
        r.pop("stats", None)
        res[name] = r

    try:
        x, y = synthetic_corpus(64, SEQ, VOCAB)
        if world == 4:
            for schedule in PP_SCHEDULES:
                with _checkpoint_clock() as spent:
                    keep(f"pptp_{schedule}", pp_shallow(
                        x, y, schedule, mesh_shape=(1, 2, 2),
                        tensor_parallel=True, ckpt=job["ckpt_pptp"]
                        if schedule == "gpipe" else None))
                res[f"pptp_{schedule}"].update(spent)
        else:
            for schedule in PP_SCHEDULES:
                with _checkpoint_clock() as spent:
                    keep(schedule, pp_shallow(
                        x, y, schedule, mesh_shape=(1, world),
                        ckpt=job["ckpt"] if schedule == "gpipe" else None))
                res[schedule].update(spent)
            hx, hy = _het_data()
            keep("het_auto", het_run(hx, hy, PP_W2_STEPS, (1, world)))
            keep("het_cut", het_run(hx, hy, PP_W2_STEPS, (1, world),
                                    boundaries=HET_BOUNDARIES))
            try:
                het_run(hx, hy, PP_W2_STEPS, (1, world),
                        resume=job["ckpt_het"])
                res["het_cross"] = None
            except NotImplementedError as e:
                res["het_cross"] = f"{type(e).__name__}: {e}"
            # the four-rank world runs at the same time: its pp+tp
            # checkpoint is complete once its manifest is there
            _await_snapshot(job["ckpt_pptp"])
            keep("pp_from_pptp", pp_shallow(x, y, "gpipe",
                                            resume=job["ckpt_pptp"],
                                            mesh_shape=(1, world)))
            keep("pptp_from_pptp", pp_shallow(
                x, y, "gpipe", resume=job["ckpt_pptp"],
                mesh_shape=(1, world, 1), tensor_parallel=True))
    finally:
        dist.destroy_process_group()
    with open(out / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    return 0


def _await_snapshot(path, procs=(), timeout=PP_CHILD_TIMEOUT_S):
    """Wait until the checkpoint directory ``path`` holds the snapshot of
    neval ``PP_CKPT_AT`` with its manifest (written after the snapshot
    itself, so the snapshot is then whole); raise as soon as one of
    ``procs`` (its writers) has failed."""
    from bigdl_tpu_torch.utils import file_io

    target = str(Path(path) / f"checkpoint.{PP_CKPT_AT}.pkl")
    deadline = time.monotonic() + timeout
    while file_io.read_manifest(target) is None:
        if any(p.poll() not in (None, 0) for p in procs):
            raise AssertionError(f"a writer of {target} failed")
        if time.monotonic() > deadline:
            raise TimeoutError(f"no snapshot {target} within {timeout} s")
        time.sleep(0.2)


def _spawn_pp_worlds(root, jobs, meanwhile=None):
    """Start a gloo world of ``--pp-rank`` processes of this script for
    each ``{world: job}``, all at once and sharing the card; run
    ``meanwhile(procs)`` here (``procs``: ``{world: [Popen]}``) while
    they work; wait for them under ``PP_CHILD_TIMEOUT_S`` and kill every
    one on a hang or a failure.  Returns ``{world: (results by rank,
    output directory)}``, each world's seconds from the start and what
    ``meanwhile`` returned."""
    t0 = time.perf_counter()
    procs, outs, seconds = {}, {}, {}
    try:
        for world, job in jobs.items():
            outs[world] = out = root / f"w{world}"
            out.mkdir()
            job_path = root / f"job{world}.json"
            job_path.write_text(json.dumps(job))
            init = root / f"rendezvous{world}"
            procs[world] = []
            for r in range(world):
                with open(out / f"rank{r}.log", "w") as log:
                    procs[world].append(subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()),
                         "--pp-rank", str(r), str(world), str(init),
                         str(job_path), str(out)],
                        stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + PP_CHILD_TIMEOUT_S
        done = meanwhile(procs) if meanwhile is not None else None
        for world, ps in procs.items():
            for p in ps:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            seconds[world] = time.perf_counter() - t0
            bad = [r for r, p in enumerate(ps) if p.returncode != 0]
            if bad:
                log = (outs[world] / f"rank{bad[0]}.log").read_text()
                raise AssertionError(
                    f"phase 18 world-{world} rank {bad[0]} failed:\n"
                    f"{log[-3000:]}")
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return {world: ([json.loads((outs[world] / f"rank{r}.json").read_text())
                     for r in range(world)], outs[world])
            for world in jobs}, seconds, done


def _world_row(phase, leg, ranks, out, ref, start, tol, upd_tol, card,
               **extra):
    """A gloo world's leg against its world-1 reference ``ref``: the row
    (emitted) and whether it holds."""
    flat = np.load(out / f"flat_{leg}.npy")
    losses = [r[leg]["losses"] for r in ranks]
    step_rel = _max_step_rel(losses[0], ref["losses"])
    row = {"phase": phase, "leg": leg,
           "label": "correctness only: gloo ranks sharing one card, eager, "
                    "host-routed hops",
           "ranks": len(ranks), "routes": [r[leg]["route"] for r in ranks],
           "checkpoint_s": [r[leg].get("checkpoint_s") for r in ranks],
           "checkpoint_write_s": [r[leg].get("write_s") for r in ranks],
           "losses": losses[0], "world1_losses": ref["losses"],
           "ranks_agree": all(l == losses[0] for l in losses),
           "max_step_loss_rel": step_rel,
           "param_update_rel": _update_rel(flat, ref["flat"].numpy(),
                                           start),
           "wall_s": [r[leg]["wall_s"] for r in ranks],
           "world1_wall_s": ref["wall_s"],
           "tolerance": {"loss": tol, "update": upd_tol}, "card": card,
           **extra}
    emit(row)
    ok = len(losses[0]) == len(ref["losses"]) and row["ranks_agree"] and \
        step_rel <= tol and row["param_update_rel"] <= upd_tol and \
        set(row["routes"]) == {"eager"}
    return row, ok


def _het_start():
    """AlexNetOWT's initial parameters (seed 0), flat, on the host."""
    from bigdl_tpu_torch.models.alexnet import AlexNetOWT

    return _flat_params(AlexNetOWT(1000, has_dropout=False, device="cpu",
                                   seed=0)).numpy()


def het_world1(card, x, y, ckpt):
    """Phase 18 (e) at a world of one on NCCL: AlexNetOWT through the
    heterogeneous pipeline on (1, 1) against LocalOptimizer (losses,
    parameters, one graph a step, step time over steps without a
    checkpoint), in bf16 against fp32, and a ``PP_W2_STEPS`` run (the
    gloo ranks' reference) writing its checkpoint at ``HET_CKPT_AT``,
    resumed at the same layout against it.  Returns the fp32 run's peak
    memory and the ``PP_W2_STEPS`` run."""
    ref = het_run(x, y, HET_STEPS, clock=True)
    # LocalOptimizer at the microbatch's size: what the pipeline's four
    # microbatch steps a step cost at world 1 (cuDNN picks its fp32
    # algorithms by batch size)
    micro = het_run(x, y, HET_STEPS, clock=True, batch=HET_BATCH // 4)
    start = _het_start()
    run = het_run(x, y, HET_STEPS, (1, 1), clock=True)
    bf16 = het_run(x, y, HET_STEPS, (1, 1), compute_dtype=torch.bfloat16,
                   clock=True)
    short = het_run(x, y, PP_W2_STEPS, (1, 1), ckpt=ckpt)
    resumed = het_run(x, y, PP_W2_STEPS, (1, 1), resume=ckpt)
    stats = run["stats"]
    row = {"phase": "het_world1", "model": "AlexNetOWT(1000, "
           "has_dropout=False)", "batch": HET_BATCH, "microbatches": 4,
           "slices": run["slices"],
           "backend": torch.distributed.get_backend(),
           "route": run["route"], "graphs": stats["captured"],
           "replays": stats["replays"], "graph_pool_bytes":
           stats["pool_bytes"], "step_s": run["step_s"],
           "images_per_s": HET_BATCH / run["step_s"],
           "reference_step_s": ref["step_s"],
           "reference_images_per_s": HET_BATCH / ref["step_s"],
           "reference_microbatch_step_s": micro["step_s"],
           "peak_allocated_bytes": run["peak_allocated_bytes"],
           "reference_peak_allocated_bytes": ref["peak_allocated_bytes"],
           "losses": run["losses"], "reference_losses": ref["losses"],
           "max_step_loss_rel": _max_step_rel(run["losses"],
                                              ref["losses"]),
           "param_update_rel": _update_rel(run["flat"].numpy(),
                                           ref["flat"].numpy(), start),
           "bf16_losses": bf16["losses"], "bf16_step_s": bf16["step_s"],
           "bf16_max_step_loss_rel": _max_step_rel(bf16["losses"],
                                                   run["losses"]),
           "bf16_masters": str(bf16["flat"].dtype),
           "resumed_losses": resumed["losses"],
           "resumed_neval": resumed["neval"],
           "resumed_max_step_loss_rel": _max_step_rel(
               resumed["losses"], short["losses"][HET_CKPT_AT - 1:]),
           "resumed_param_update_rel": _update_rel(
               resumed["flat"].numpy(), short["flat"].numpy(), start),
           "tolerance": {"loss": HET_LOSS_RTOL, "update": PP_UPD,
                         "bf16_loss": HET_BF16_RTOL,
                         "resume_loss": PP_LOSS_RTOL,
                         "resume_update": PP_W2_UPD},
           "card": card}
    emit(row)
    if len(run["losses"]) != HET_STEPS or \
            row["max_step_loss_rel"] > HET_LOSS_RTOL or \
            row["param_update_rel"] > PP_UPD:
        raise AssertionError(f"het world 1 against LocalOptimizer: {row}")
    if stats["captured"] != 1 or stats["replays"] != HET_STEPS or \
            run["route"] != "nccl-graph":
        raise AssertionError(f"het: the step was not one captured graph: "
                             f"{row}")
    if row["bf16_max_step_loss_rel"] > HET_BF16_RTOL or \
            row["bf16_masters"] != "torch.float32":
        raise AssertionError(f"het bf16 against fp32: {row}")
    if resumed["neval"] != PP_W2_STEPS + 1 or \
            len(resumed["losses"]) != PP_W2_STEPS - HET_CKPT_AT + 1 or \
            row["resumed_max_step_loss_rel"] > PP_LOSS_RTOL or \
            row["resumed_param_update_rel"] > PP_W2_UPD:
        raise AssertionError(f"het same-layout resume: {row}")
    return run["peak_allocated_bytes"], short


def pp_serving(fa, card, ckpts):
    """Phase 18 (f): a "small"-width fp32 paged engine (4 layers, other
    random weights) refreshed through ``refresh_from_snapshot`` from
    each checkpoint directory of ``ckpts`` (``{name: dir}``, pipelined
    runs of the same model), against an engine built on the weights the
    checkpoint holds (its stage-stacked tree unstacked by
    ``interop.load_jax_pp_params``): greedy streams and ``predict``
    equal, the refreshed engine's weights bitwise, no capture after
    ``precompile()``; K1 and K3 counted through the replays.  Returns
    the launch counts by checkpoint."""
    from bigdl_tpu_torch.interop import load_jax_pp_params
    from bigdl_tpu_torch.models import synthetic_corpus
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.utils import cuda_graphs, file_io

    toks, _ = synthetic_corpus(PP_SERVE_SLOTS, PP_SERVE_PROMPT, VOCAB,
                               seed=5)
    prompts = [toks[i, :n] for i, n in enumerate(np.linspace(
        PP_SERVE_PROMPT // 8, PP_SERVE_PROMPT, PP_SERVE_SLOTS).astype(int))]
    seq, _ = synthetic_corpus(1, PP_SERVE_PROMPT // 2, VOCAB, seed=6)

    def engine(model):
        return ServingEngine(model, decode_slots=PP_SERVE_SLOTS,
                             decode_max_len=PP_SERVE_LEN)

    def serve(eng):
        streams = [eng.generate(p, max_new_tokens=PP_SERVE_NEW).result(600)
                   for p in prompts]
        logits = eng.predict(seq[0], timeout=600)
        torch.cuda.synchronize()
        return streams, np.asarray(logits)

    paths = {}
    eng = engine(_pp_model(PP_W2_LAYERS, seed=7))
    try:
        built = eng.precompile(example_feature=seq[0])
        for name, path in ckpts.items():
            intact, _ = file_io.scan_checkpoints(str(path))
            snap = file_io.load(intact[0])
            ref_model = load_jax_pp_params(_pp_model(PP_W2_LAYERS, seed=7),
                                           snap["model_params"])
            with engine(ref_model) as ref:
                want_streams, want_logits = serve(ref)
            captures = cuda_graphs.capture_count()
            steps = eng.executables()
            t0 = time.perf_counter()
            eng.refresh_from_snapshot(str(path))
            refresh_s = time.perf_counter() - t0
            fa.reset_launch_counts()
            # ---- the refreshed engine's path: counts read right after --
            streams, logits = serve(eng)
            launches = {k: fa.LAUNCHES[k] for k in
                        ("flash_attention", "flash_paged_decode_attention")}
            # ------------------------------------------------------------
            same_weights = all(torch.equal(a, b) for a, b in zip(
                eng.model.parameters(), ref_model.parameters()))
            row = {"phase": "pp_serving", "checkpoint": name,
                   "layout": file_io.read_manifest(intact[0])["layout"],
                   "steps_built_by_precompile": built,
                   "refresh_s": refresh_s,
                   "captures_after_refresh":
                       cuda_graphs.capture_count() - captures,
                   "steps_built_after_refresh": eng.executables() - steps,
                   "weights_bitwise": same_weights,
                   "greedy_streams_equal": streams == want_streams,
                   "predict_max_abs_err": float(np.abs(
                       logits - want_logits).max()),
                   "launches": launches, "card": card}
            emit(row)
            del ref_model
            _free()
            if not same_weights or streams != want_streams or \
                    row["predict_max_abs_err"] > ATOL or \
                    row["captures_after_refresh"] or \
                    row["steps_built_after_refresh"] or \
                    min(launches.values()) < 1:
                raise AssertionError(f"serving the {name} checkpoint: "
                                     f"{row}")
            paths[f"pp_serving_{name}"] = launches
    finally:
        eng.close()
    return paths


def pp_phase(fa, ce, card):
    """Phase 18: the pipeline.  Returns the launch counts by path."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.models import synthetic_corpus
    from bigdl_tpu_torch.parallel.reshard import LayoutSpec
    from bigdl_tpu_torch.utils import file_io
    from bigdl_tpu_torch.utils.engine import Engine

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_pp_"))
    ck = {k: str(root / f"ckpt_{k}") for k in ("pp", "pptp", "het")}
    try:
        Engine.init()                  # NCCL, a world of one on the card
        x, y = synthetic_corpus(64, SEQ, VOCAB)
        paths, peaks = pp_world1(fa, ce, card, x, y)
        t_a = time.perf_counter() - t_phase

        # (e) at world 1 first: its checkpoint is the world-2 ranks'
        # cross-layout resume
        t0 = time.perf_counter()
        hx, hy = _het_data()
        peaks["het"], het_w1 = het_world1(card, hx, hy, ck["het"])
        het_s = time.perf_counter() - t0

        # the world-1 references of the gloo worlds, on the same 4-layer
        # model: pp (1, 1), for (b) and for (d) (pp+tp at world 1 runs
        # the same arithmetic: (a) and (d) above, losses within 1e-7)
        start = _flat_params(_pp_model(PP_W2_LAYERS)).detach().cpu().numpy()
        shallow = {s: pp_shallow(x, y, s) for s in PP_SCHEDULES}

        # (d), four gloo ranks with pp+tp on (1, 2, 2), and (b) and (e),
        # two gloo ranks, at the same time on the card; meanwhile, once
        # their GPipe legs have written the checkpoints, (c)'s resumes at
        # world 1 and (f) run here
        def meanwhile(procs):
            _await_snapshot(ck["pp"], procs[2])
            _await_snapshot(ck["pptp"], procs[4])
            resumed = {"pp": {}, "pptp": {}}
            for name, strategy, tp in (("pp", "pp", False),
                                       ("pp", "tp", False),
                                       ("pptp", "pp", True)):
                resumed[name][f"{strategy}{'+tp' if tp else ''}"] = \
                    pp_shallow(x, y, "gpipe", resume=ck[name],
                               strategy=strategy, tensor_parallel=tp,
                               mesh_shape=(1, 1, 1) if tp else (1, 1))
            t0 = time.perf_counter()
            served = pp_serving(fa, card, {"pptp": ck["pptp"],
                                           "pp": ck["pp"]})
            return resumed, served, time.perf_counter() - t0

        worlds, spawn_s, (resumed, served, serve_s) = _spawn_pp_worlds(
            root, {4: {"ckpt_pptp": ck["pptp"]},
                   2: {"ckpt": ck["pp"], "ckpt_pptp": ck["pptp"],
                       "ckpt_het": ck["het"]}}, meanwhile)
        paths.update(served)
        ranks4, out4 = worlds[4]
        ranks, out = worlds[2]
        ok = True
        for s in PP_SCHEDULES:
            _, held = _world_row("pp_tp_world4", f"pptp_{s}", ranks4, out4,
                                 shallow[s], start, PP_TP_W4_RTOL,
                                 PP_W2_UPD, card,
                                 mesh={"data": 1, "pipe": 2, "model": 2})
            ok = ok and held
        if not ok:
            raise AssertionError("pp+tp (1, 2, 2) against world 1")

        for s in PP_SCHEDULES:
            _, held = _world_row("pp_world2", s, ranks, out, shallow[s],
                                 start, PP_LOSS_RTOL, PP_W2_UPD, card,
                                 layers=PP_W2_LAYERS,
                                 mesh={"data": 1, "pipe": 2})
            ok = ok and held
        het_start = _het_start()
        for leg in ("het_auto", "het_cut"):
            _, held = _world_row("het_world2", leg, ranks, out,
                                 het_w1, het_start, HET_W2_RTOL,
                                 PP_W2_UPD, card,
                                 slices=ranks[0][leg]["slices"])
            ok = ok and held
        cross = [r["het_cross"] for r in ranks]
        emit({"phase": "het_cross_layout_resume", "errors": cross,
              "card": card})
        if not ok or not all(c and c.startswith("UnsupportedFeatureError")
                             and "cannot be re-cut" in c for c in cross):
            raise AssertionError("phase 18 world-2 legs: see the rows")

        # (c): the pp (1, 2) checkpoint resumed at world 1 as pp (1, 1)
        # and as tp (1, 1), against the straight world-2 run; and (d)'s
        # pp+tp (1, 2, 2) checkpoint resumed as pp (1, 2) and pp+tp
        # (1, 2, 1) (world 2, above) and as pp+tp (1, 1, 1), against the
        # straight (1, 2, 2) run
        for leg, label in (("pp_from_pptp", "pp_world2"),
                           ("pptp_from_pptp", "pp+tp_world2")):
            r = dict(ranks[0][leg])
            r["flat"] = torch.from_numpy(np.load(out / f"flat_{leg}.npy"))
            resumed["pptp"][label] = r
        c_row = {"phase": "pp_checkpoint", "card": card}
        for name, straight, flat_s, want in (
                ("pp", ranks[0]["gpipe"]["losses"],
                 np.load(out / "flat_gpipe.npy"),
                 LayoutSpec.pp({"data": 1, "pipe": 2}, 2)),
                ("pptp", ranks4[0]["pptp_gpipe"]["losses"],
                 np.load(out4 / "flat_pptp_gpipe.npy"),
                 LayoutSpec.pp({"data": 1, "pipe": 2, "model": 2}, 2,
                               "pipe", True))):
            intact, _ = file_io.scan_checkpoints(ck[name])
            layout = file_io.read_manifest(intact[0])["layout"]
            c_row[f"{name}_layout"] = layout
            ok = ok and layout == want.to_manifest()
            tail = straight[PP_CKPT_AT - 1:]
            for label, r in resumed[name].items():
                res = c_row[f"{name}_as_{label}"] = {
                    "losses": r["losses"], "neval": r["neval"],
                    "max_step_loss_rel": _max_step_rel(r["losses"], tail),
                    "param_update_rel": _update_rel(
                        r["flat"].numpy(), flat_s, start)}
                ok = ok and r["neval"] == PP_W2_STEPS + 1 and \
                    len(r["losses"]) == PP_W2_STEPS - PP_CKPT_AT + 1 and \
                    res["max_step_loss_rel"] <= PP_LOSS_RTOL and \
                    res["param_update_rel"] <= PP_W2_UPD
        emit(c_row)
        if not ok:
            raise AssertionError(f"pp checkpoints across layouts: {c_row}")
        emit({"phase": "pp_done", "world1_s": t_a, "het_world1_s": het_s,
              "world4_s": spawn_s[4], "worlds_s": max(spawn_s.values()),
              "serving_s": serve_s,
              "peak_allocated_bytes": peaks,
              "seconds": time.perf_counter() - t_phase, "card": card})
        return paths
    finally:
        Engine.reset()
        shutil.rmtree(root, ignore_errors=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--fleet-worker":
        # one worker process of phase 16's fleet (started by _FleetWorkers)
        return fleet_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if len(sys.argv) > 1 and sys.argv[1] == "--strategy-rank":
        # one rank of phase 17's gloo world (started by
        # _spawn_strategy_world)
        return strategy_child(int(sys.argv[2]), int(sys.argv[3]),
                              *sys.argv[4:7])
    if len(sys.argv) > 1 and sys.argv[1] == "--distri-rank":
        # one rank of phase 15's gloo world (started by _spawn_world2)
        return distri_child(int(sys.argv[2]), int(sys.argv[3]),
                            *sys.argv[4:7])
    if len(sys.argv) > 1 and sys.argv[1] == "--pp-rank":
        # one rank of phase 18's gloo worlds (started by _spawn_pp_worlds)
        return pp_child(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    only = None
    if len(sys.argv) > 2 and sys.argv[1] == "--phases":
        # a selection of the multi-rank phases alone, after the build
        # (15: data parallelism; 17: tp, sp, ep; 18: pp, pp+tp, pp_het,
        # serving their snapshots)
        only = set(sys.argv[2].split(","))
        if not only <= {"15", "17", "18"}:
            raise SystemExit(f"--phases takes 15, 17 and/or 18, not "
                             f"{sys.argv[2]}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from bigdl_tpu_torch.ops import _build, bn_act
    from bigdl_tpu_torch.ops import cross_entropy as ce
    from bigdl_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    libs = _build.build()          # one nvcc per source, all at once
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [lib.name for lib in libs],
          "ptxas": {stem: ptxas_report(log)
                    for stem, log in _build.build_logs().items()}})
    emit({"phase": "sass",
          "tensor_core_instructions": tensor_core_instructions(_build,
                                                               libs)})
    if only is not None:
        paths = {}
        if "15" in only:
            paths.update(distri_phase(fa, ce, card))
        if "17" in only:
            paths.update(strategy_phase(fa, ce, card)[0])
        if "18" in only:
            paths.update(pp_phase(fa, ce, card))
        emit({"selected_phases": sorted(only), "launches_by_path": paths})
        return _device_line()

    rows = kernel_phase(fa, card)
    serving, fp32_tok_s = e2e_phase(fa, card, *serving_models())
    rows.update(training_kernel_phase(fa, ce, card))
    training, training_bf16 = training_phase(fa, ce, card)
    rows.update(int8_kernel_phase(fa, card))
    # the same weights again (seed 0), so the training phases' peak
    # memory holds no serving model
    int8_serving, rows["act_quant_small"] = int8_serving_phase(
        fa, card, *serving_models(), fp32_tok_s)
    phase10 = eval_phase(fa, ce, card)
    rows.update(large_kernel_rows(fa, card))
    phase11 = large_phase(fa, ce, card)
    # the float CNN path (phase 12's training legs and eval) keeps its
    # modules: no K7 launch
    bn_act.reset_launch_counts()
    resnet_phase(card)
    emit({"phase": "resnet_float_k7_launches",
          "bn_act": bn_act.LAUNCHES["bn_act"], "card": card})
    if bn_act.LAUNCHES["bn_act"]:
        raise AssertionError("phase 12's float ResNet-50 launched K7")
    int8_rows, phase13 = int8_phase(card)
    rows.update(int8_rows)
    phase14 = engine_phase(card)
    phase15 = distri_phase(fa, ce, card)
    phase16 = fleet_phase(fa, card)
    phase17, strategy_rows = strategy_phase(fa, ce, card)
    rows.update(strategy_rows)
    phase18 = pp_phase(fa, ce, card)

    attn = "bigdl_tpu_torch/csrc/flash_attention.cu"
    bwd = "bigdl_tpu_torch/csrc/flash_attention_bwd.cu"
    k1_grad = ("bigdl_tpu/ops/flash_attention.py:63 (its gradient; the TPU "
               "kernel has no VJP)")
    kernels_of = {
        "flash_attention": (attn, "bigdl_tpu/ops/flash_attention.py:63"),
        "flash_attention_bf16": (attn, "bigdl_tpu/ops/flash_attention.py:63"
                                 " (bf16 inputs, m16n8k16)"),
        "flash_attention_bwd": (bwd, k1_grad),
        "flash_attention_bwd_bf16": (bwd, k1_grad + ", bf16"),
        "flash_decode_attention": (attn,
                                   "bigdl_tpu/ops/flash_attention.py:135"),
        "flash_paged_decode_attention": (
            attn, "bigdl_tpu/ops/flash_attention.py:236"),
        "flash_paged_decode_attention_int8": (
            attn, "bigdl_tpu/ops/flash_attention.py:236 (quantized=True)"),
        "fused_softmax_cross_entropy": (
            "bigdl_tpu_torch/csrc/cross_entropy.cu",
            "bigdl_tpu/ops/cross_entropy.py:77"),
        "fused_softmax_cross_entropy_bwd": (
            "bigdl_tpu_torch/csrc/cross_entropy.cu",
            "bigdl_tpu/ops/cross_entropy.py:126"),
        "fused_softmax_cross_entropy_shard": (
            "bigdl_tpu_torch/csrc/cross_entropy.cu",
            "bigdl_tpu/ops/cross_entropy.py:77 (a vocabulary shard under "
            "GSPMD tensor parallelism, bigdl_tpu/parallel/tp.py:31)"),
        "fused_softmax_cross_entropy_bwd_shard": (
            "bigdl_tpu_torch/csrc/cross_entropy.cu",
            "bigdl_tpu/ops/cross_entropy.py:126 (a vocabulary shard under "
            "GSPMD tensor parallelism, bigdl_tpu/parallel/tp.py:31)"),
        "int8_conv": ("bigdl_tpu_torch/csrc/int8_conv.cu",
                      "bigdl_tpu/nn/quantized.py:110 (int8_conv: an XLA "
                      "conv_general_dilated, no pallas_call)"),
        "int8_conv_gather": ("bigdl_tpu_torch/csrc/int8_conv.cu",
                             "bigdl_tpu/nn/quantized.py:110 (int8_conv, cin "
                             "a group off 16: the stem; no pallas_call)"),
    }
    quantizer = ("bigdl_tpu/nn/quantized.py:88 _quantize_activation (pure "
                 "JAX in int8_conv :110 and int8_matmul :96, no "
                 "pallas_call)")
    for route, what in (("act_quant", "the three-node route"),
                        ("act_quant_given", "the given route, after K7"),
                        ("act_quant_small", "the small route, one cluster")):
        kernels_of[route] = ("bigdl_tpu_torch/csrc/act_quant.cu",
                             f"{quantizer}: {what}")
    kernels_of["bn_act"] = (
        "bigdl_tpu_torch/csrc/bn_act.cu",
        "none: bigdl_tpu/nn/normalization.py:102 (BatchNormalization's "
        "eval output), nn/activations.py:33 (ReLU) and "
        "nn/containers.py:150 (CAddTable), fused by XLA, no pallas_call")
    # the head_dim 96 instantiations ("large"), launched by phase 11 only
    for name in ("flash_attention", "flash_attention_bf16",
                 "flash_attention_bwd", "flash_attention_bwd_bf16",
                 "flash_decode_attention", "flash_paged_decode_attention",
                 "flash_paged_decode_attention_int8"):
        source, replaces = kernels_of[name]
        kernels_of[f"{name}_d96"] = (source, replaces + ", head_dim 96")
    paths = (("serving", serving), ("training", training),
             ("training_bf16", training_bf16), ("int8_serving", int8_serving),
             *phase10.items(), *phase11.items(), *phase13.items(),
             *phase14.items(), *phase15.items(), *phase16.items(),
             *phase17.items(), *phase18.items())
    if len(dict(paths)) != len(paths):
        raise AssertionError(f"two paths share a name: "
                             f"{[p for p, _ in paths]}")
    kernels = []
    for name, (source, replaces) in kernels_of.items():
        row = rows[name]
        by_path = {path: counts[name] for path, counts in paths
                   if counts.get(name)}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    return _device_line()


def _device_line():
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
