#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase, as a release check
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,kernels,train_parity,train   # the training slice
    python3 chip_smoke.py --phases build,kernels,moe_parity,moe_engine,vit_train,dit
    python3 chip_smoke.py --phases build,server,disagg   # the serving front
    python3 chip_smoke.py --phases build,runtime   # the host runtime and the GPU actor
    python3 chip_smoke.py --phases build,serve     # the Serve runtime: replicas, proxy, dispatcher
    python3 chip_smoke.py --phases build,chaos     # ActorPool, Queue, placement groups, chaos schedules
    python3 chip_smoke.py --phases build,data      # batch inference, the train on-ramp, the host pipeline
    python3 chip_smoke.py --phases build,dag       # plans, StageGroup gangs, compiled DAGs
    python3 chip_smoke.py --phases build,profile   # one profiled train step (not in the default run)
    python3 chip_smoke.py --phases build,parallel  # the parallel layer, ranks sharing the card
    python3 chip_smoke.py --phases build,tp_serve  # the tensor-parallel engine on 2 ranks
    python3 chip_smoke.py --phases build,trainer   # trainers, TrainController, collective groups
    python3 chip_smoke.py --phases build,tune      # Tune: ASHA, Train-on-Tune, restore
    python3 chip_smoke.py --phases build,jobs      # submitted GPU jobs, a durable workflow, state
    python3 chip_smoke.py --phases build,cli       # the rt CLI, scripts/, the autoscaler, rt lint
    python3 chip_smoke.py --phases build,multinode # the head service and a node agent with the card
    python3 chip_smoke.py --phases build,rllib     # rllib: PPO at 4096 envs, runners, DQN, SAC
    python3 chip_smoke.py --phases build,rllib_contrib  # rllib part 2: DreamerV3, DT, ES, the rest

Phases, each printing one JSON line; any failure exits non-zero:

1. ``build``   — nvcc builds every kernel from ``ray_tpu_torch/ops/csrc``;
   ``-Xptxas -v`` must report no spills for the tensor-core kernels (K3,
   K4, K5: ``wgmma``; K6: ``mma``), and where the toolkit has ``cuobjdump``
   the count of tensor-core instructions per kernel (``HGMMA`` for wgmma,
   ``HMMA`` for mma.sync) must be non-zero for them and zero for the rest.
2. ``kernel``  — one line per kernel: the kernel against its plain PyTorch
   version on the card, at the main paths' shapes plus edge cases, in f32
   (atol 1e-4: only the summation order differs; the int8 matmul, whose
   K-term sums grow with K, atol 1e-5 x max|plain|) and bf16 (atol and rtol
   2e-2: bf16 keeps about 3 digits); K3, K4, K5 and K6 report each route
   (bf16 on the tensor cores, f32 scalar; K6's ragged bf16 shapes scalar
   too) with its errors and check that each input moved only its route's
   counter; every kernel also runs twice and must give the same bits;
   device times of the kernel, the plain version and (where one PyTorch
   call computes the same function) that call, and the least time the card
   could take (``bound_ms``). K3, K4 and K5 are also checked and timed at
   the ViT train step's shape (``[128, 12, 197, 64]`` non-causal: ``vit_*``
   keys, beside ``scaled_dot_product_attention(is_causal=False)`` and its
   backward). K1 and K2 run every n_rep (1, 2, 3, 4, 16),
   D 64 and 128, zero, ragged and clamped lengths, and (K1) a garbage page
   0 full of NaN, and are timed at three shapes of the serving decoder's
   cache (``variant_probe.DECODE_SHAPES``, whose cases and input builder
   they share: a decode step of 8 rows of 64-96 positions, the same at
   960-1024, and 64 rows at 960-1024) cold (the L2 flushed between calls)
   and warm, beside the event floor of a trivial kernel. The int8 matmul is
   timed on weight copies that together exceed the 50 MB L2, as a decode
   step finds each layer's weights. Also checked: the flash kernels at a
   negative and a zero scale.
3. ``forward_parity`` — the 284M serving decoder (``llm_bench`` config:
   vocab 32000, d_model 1024, 16 layers, 16 heads / 8 kv heads, d_ff 4096)
   in f32 activations from a seeded generator: a paged prefill + 4 paged
   decode steps and a dense prefill + decode steps, through the kernels and
   through the plain path; logits within atol 1e-3, greedy tokens identical,
   and ``generate()`` equal to the plain greedy tokens. Then the same with
   the layers quantized (``quantize_layers``, min_size 4096): through the
   kernels with ``layer_scales`` (K1/K2/K3 + the int8 matmul, 6 launches a
   layer per forward) against the plain path on the dequantized weights.
4. ``engine``  — the paged ``LLMEngine`` at full width in bf16 serving 8
   concurrent requests (prompt 64, 32 tokens, greedy), then the dense
   engine, then both again with ``quantize=True`` (int8 layer linears);
   launch counters are zeroed just before each run and read just after, and
   every kernel of the run must have launched; every K6 launch on the
   tensor cores.
4b. ``server`` — ``LLMServer`` on the same decoder in bf16 answers the
   engine phase's burst from 8 streaming clients, paged (its tokens must
   equal the paged engine phase's), dense (K2, K3; one blocking and one
   streaming request must give the burst's tokens) and paged with
   ``quantize=True`` (every K6 launch on the tensor cores); tokens/s and
   client TTFT beside the engine's own sketches (TTFT, inter-token and
   queue-wait p50/p99 over the burst) and the median of each phase of the
   burst's request traces, started around each call as the Serve proxy
   starts them. Then ``OpenAICompatLLMServer`` with
   the JAX tests' toy tokenizer: a completion, a chat and a streamed chat
   (envelopes, usage counts, finish reasons), and ``top_p=0.5`` refused.
4c. ``disagg`` — disaggregated prefill/decode on the same decoder: (a) a
   ``role="prefill"`` and a ``role="decode"`` engine in this process, f32
   activations with TF32 off, eight 64-token prompts exported, pulled and
   adopted: greedy tokens identical to one co-located engine's, every rung
   the in-process ``"host"`` one, K1 on the decode side only (16 a decode
   step); the first prompt again pulls zero blocks (the decode side's
   prefix cache). (b) The prefill engine in a spawned process, pulls over
   the CUDA IPC transfer server: every rung ``"device"``, tokens equal to
   (a)'s, every block over one connection; pull ms and GB/s a block, split
   into connecting, opening the peer's block (IPC handle) and copying it. (c) The bf16 burst through an
   in-process pair of ``LLMServer`` instances, float and int8: tokens/s and TTFT
   beside the co-located paged server's, migration ms a request and a
   block, GB/s; the export alone launches no K1 (and, under int8, K6 six
   times a layer), its decode K1 16 times a decode step.
4d. ``runtime`` — the host runtime (``ray_tpu_torch.init`` and friends) on
   the card: ``init(num_cpus=8)`` reports one ``GPU``; a 256 MiB bf16 CUDA
   tensor ``put`` lands in the device tier (``hbm_used`` rises by its bytes,
   ``get`` returns the same storage); a task given it runs in process and
   returns a ``cuda:0`` result; a process-tier task given it receives a CPU
   copy whose float32 sum equals the card's, in a worker that created no
   CUDA context; task round trips (median of 200) in process and in a
   process worker. A GPU actor (``num_gpus=1``) holds the paged
   ``LLMEngine`` on the serving decoder, float and then ``quantize=True``,
   and answers the engine phase's burst through ``actor.generate.remote``
   and one streaming-generator task, with tokens identical to an instance of
   the same class driven directly and K1 (16 a decode step) and K6 (96 a
   forward) launches equal to the direct run's; the actor-call round trip;
   tokens/s through the actor and direct. After ``shutdown`` no worker
   process is left and the device memory the runtime held is freed (within
   the per-thread cuBLAS workspaces). Then, with
   ``object_store_hbm_fraction`` at 2.5 tensors, three puts spill the
   oldest to the host bit for bit and free its device bytes (spill GB/s).
4e. ``serve`` — the Serve runtime (``ray_tpu_torch.serve``) on the card,
   one ``init(num_cpus=8)`` and ``serve.start()``: (a) ``serve.run`` of
   ``LLMServer`` with ``ray_actor_options={"num_gpus": 1}`` and no device
   (the replica's engine takes the card), float then ``quantize=True``,
   answering the engine phase's burst over HTTP (8 SSE clients through the
   proxy) and through a ``DeploymentHandle``: tokens and K1/K6 launches
   equal to an ``LLMServer`` driven directly by the same 8 streaming
   clients (every K6 launch on the tensor cores); tokens/s and client TTFT
   beside the direct server's, the engine phase's paged engine's and the
   runtime phase's GPU actor's (where those phases ran), and the
   median of each phase of the proxy-born request traces. (b)
   ``OpenAICompatLLMServer`` behind the proxy: a completion and a streamed
   chat equal the direct server's envelopes (ids and timestamps aside). (c)
   ``roles={"prefill": 1, "decode": 1}``, half the card each, bf16, through
   ``DisaggDispatcher``: the burst's tokens equal (a)'s float ones; the
   dispatcher's counters and the cluster's migration audit count 8 staged
   and 8 adopted; the halves alone run K1 only on the decode replica (16 a
   decode step). Then ``chaos_kill_replica(role="decode", index=0)`` once
   mid-burst: each request finishes with co-located tokens or fails with
   ``KVMigrationError``, and the audit's terminals (adopted, failed,
   re-prefills) match. (d) After ``serve.shutdown()`` and the runtime's
   ``shutdown()``: no CUDA tensor of 1 MiB or more beyond the weights, no
   ``serve-*`` thread, no worker process.
4f. ``chaos`` — the utilities and the chaos fabric (``ray_tpu_torch.util``,
   ``ray_tpu_torch.chaos``) with GPU actors, on the serving decoder in bf16
   at full width and ``CUT_LAYERS`` (2) of its 16 layers (the script's time;
   every check is against a direct run at the same depth):
   (a) + (c) a ``STRICT_PACK`` placement group of two ``{"GPU": 0.5, "CPU":
   1}`` bundles holds the whole card; an engine actor in each bundle
   (``PlacementGroupSchedulingStrategy``) and an ``ActorPool`` of the two map
   the burst's 8 prompts (64 tokens, 32 new, one request an item) with
   ``map`` and ``map_unordered``: tokens equal one engine's serving them one
   at a time (the same set for ``map_unordered``), K1 ``CUT_LAYERS`` a
   decode step of each actor; ``remove_placement_group`` gives the card back. (b) a
   producer GPU actor puts 16 CUDA tensors of 4 MiB into a ``util.Queue``
   while a consumer GPU actor gets them: on the card, the same storage,
   bitwise; ms a put/get pair. (d) three seeded schedules through
   ``ChaosRunner``, each twice on a fresh ``init``: both runs ``ok``, fault
   logs byte-identical. ``disagg-decode-kill`` (``tests/test_disagg.py``,
   seed 41): ``roles={"prefill": 1, "decode": 2}``, 0.3 of the card each,
   ``kill_decode_replica`` at t=0.8, then ``disagg.decode_call=raise(0.4)``
   over 5 sequential requests: tokens equal co-located ones computed before
   the runs (or a typed ``KVMigrationError``), invariant 13 sweeps >= 5
   migrations, K1 only on the decode replicas. ``lose-device-objects``: 32
   GPU tasks return 4 MiB drawn on the card, ``lose_objects`` (0.5) at t=1.0,
   lineage rebuilds them bitwise on the card, ``memory_allocated`` back
   within 1 MiB after the refs go. ``gpu-actor-node-kill``: an int8 engine
   actor on an added ``{"CPU": 2, "GPU": 1}`` node, the node killed at t=8
   and replaced: the restarted actor's tokens equal the direct int8
   engine's, invariant 7 holds, K1 and K6 launch. (e) after the last
   ``shutdown``: no new CUDA storage of 1 MiB or more, no worker process,
   no failpoint armed.
4g. ``data`` — the data library (``ray_tpu_torch.data``) on the card: (a)
   ``from_items`` of 64 seeded prompts of 64 tokens in 4 blocks, then
   ``map_batches(LLMPredictor, fn_constructor_args=(factory,), batch_size=16,
   concurrency=2, num_gpus=0.5)`` on the serving decoder in bf16 at full
   width and ``CUT_LAYERS`` (2) of its 16 layers (the script's time; 32 new
   tokens, greedy), float then ``quantize=True``: the two in-process GPU
   actors find one cached engine (the factory is one object), warmed
   before; every row's tokens equal a direct ``LLMEngine`` (the same
   kwargs and depth) fed all 64 prompts at once; K1 2 a decode step, K6 12 a forward
   on the tensor cores; rows/s, tokens/s and the engine's TTFT sketch
   beside the direct burst's. After ``clear_engine_cache()`` and
   ``shutdown``: no engine, engine thread, actor or worker, and
   ``memory_allocated`` back within the runtime phase's slack. (b) a seeded
   ``int32[30, 2048]`` token table through ``from_numpy``,
   ``random_shuffle`` and ``iter_device_batches(batch_size=6, dtypes=int64,
   device="cuda")`` into the 602M train step (the train phase's config) for
   5 steps: each batch bitwise equal to the host ``iter_batches`` rows, each
   loss bitwise equal to the same step given the host tensor directly from
   a copy of the same state (deterministic algorithms on), K3/K4/K5 16/8/8 a
   step on the tensor cores; the iterator's ms a batch beside the step's.
   (c) ``range(16_777_216, parallelism=16)`` with a seeded int64 key column
   (256 MiB), then ``random_shuffle``, ``sort``, ``groupby(key % 1024).sum()``
   and ``write_numpy`` / ``read_numpy`` through a temporary directory: the
   multiset, the order and the sums equal numpy's, blocks reach the workers
   through the shm arena; rows/s an operation and the peak resident size.
4h. ``dag`` — the compiled-graph layer (``ray_tpu_torch.dag``) on the card,
   one ``init(num_cpus=8)``: (a) a plan of three in-process actors, a prompt
   stage (text to a token tensor on the card), a GPU actor holding the
   paged ``LLMEngine`` on the serving decoder's widths at ``CUT_LAYERS`` (2)
   layers (the phase's depth cut since ``multinode`` (g) serves the same
   graph at full depth across processes; ``num_gpus=0.5``,
   ``max_restarts=1``) and a detokenising stage, compiled with
   ``compile_plan``; 64 prompts of the engine phase's form (64 tokens, 32
   new, greedy) through ``execute_async``, 8 an iteration (the engine
   phase's burst), float then ``quantize=True``: tokens equal an instance of
   the engine class driven directly (a batch a call, as the stage calls it)
   and the same batches sent by ``.remote()`` to the same actors; zero
   TaskSpecs over the 8 iterations (the counters
   ``tests/test_plans.py`` reads); every channel ``device`` in
   ``snapshot()``; K1 16 a decode step, K6 96 a forward on the tensor
   cores; requests/s and tokens/s of the plan, ``.remote()`` and direct
   (direct at the same depth). (c) under an empty chaos schedule: the float plan's engine actor killed
   with the next prompt in flight: ``ActorDiedError`` within 120 s, the plan
   BROKEN, ``repair()`` onto the restarted actor, tokens equal direct; then
   a fresh engine under ``auto_repair=True``, killed the same way, heals
   itself; invariant 8 counts 6 legal transitions. (d) a ``matmul → relu``
   function DAG on bf16 CUDA tensors in the inline walk (``jit``) equal to
   ``torch.relu(x @ w)`` bitwise, and ``fuse="none"`` over two GPU actors'
   methods equal to their ``.remote()`` calls, and the same two calls as a
   plan (ms a call alone and pipelined); after ``shutdown``,
   ``memory_allocated`` back within the runtime phase's slack. (b) the train
   phase's 602M decoder (bf16, flash attention): two in-process GPU actors
   sharing one copy of the weights as ``StageGroup([a, b], "forward",
   split_axis=0, warmup=((8, 1024), "int32"))`` over the input, 20
   iterations on seeded ``[8, 1024]`` batches: the assembled logits within
   atol = rtol = 2e-2 of one module's forward of the whole batch (bitwise
   printed), no tensor pickled, every channel ``device``, 20 group
   executions, K3 8 layers x 2 members x 21 (the warm-up included) on
   ``wgmma_bf16``; ms an iteration beside one module's forward.
4i. ``tp_serve`` — the tensor-parallel engine (``LLMEngine(mesh=)``) on the
   serving decoder at full width and ``CUT_LAYERS`` (2) layers (the
   phase's depth cut, for the script's time), ``{"tp": 2}``: two rank processes share
   ``cuda:0`` over gloo (``run_ranks``), rank 0 drives and rank 1
   ``follow()``s. (a) f32 with TF32 off: a prefill of the first prompt
   through ``forward_with_cache`` on each rank's shards against the
   single-device dense engine's (the flash kernel) within atol 1e-3, then
   the greedy tokens of 4 prompts (64 tokens, 32 new) equal the
   single-device dense engine's. (b) bf16: the engine phase's burst (8 x 64
   x 32) through the tp engine and through the single-device dense engine
   in rank 0: tokens/s and TTFT (median, max) of both, and per decode step
   the collectives and the bytes of CUDA tensors they carry through the
   host, beside the step broadcasts of the engine's channel. No kernel runs on
   the tp path (K1-K6 launch 0 times on every rank, as in the JAX engine
   under a mesh). (c) After the ranks exit: no rank process, no process
   group in this process, and the card's free memory back within the
   runtime phase's slack.
5. ``train_parity`` — the 602M train-step decoder of ``bench.py`` (vocab
   32000, d_model 2048, 8 layers, 16 heads, d_ff 8192, T 2048), batch 1:
   loss and every gradient leaf through the flash kernels
   (``attention="flash"``) against the einsum attention
   (``attention="dense"``). In f32 activations (the scalar route): loss
   within 1e-4, each leaf's max error within 1e-3 of that leaf's largest
   gradient. In bf16 activations (the tensor-core route, P and dS rounded
   to bf16 as the TPU's MXU passes round them): loss within 1e-2, each
   leaf's relative Frobenius error ||g_flash - g_dense|| / ||g_dense||
   within 2e-2.
6. ``train``   — the same decoder as ``bench.py`` trains it (bf16, batch 6,
   ``remat="dots"``): 5 AdamW steps on a repeated batch, counters zeroed
   before and read after each step (K4 = K5 = 8, K3 = 16 a step, every K3,
   K4 and K5 launch on the tensor-core route), every loss
   finite and the last below the first; step ms (CUDA events), tokens/s and
   the model FLOP share of 989 TFLOP/s. Then the resume check, the same
   ``run_train`` for 3 steps on the same widths at ``CUT_LAYERS`` (2) layers
   (the phase's depth cut: the 8-layer state's 7.2 GB checkpoint took 80
   s): the state after step 2 is saved through ``Checkpoint.from_pytree``
   and restored into a fresh state; step 3 from both, with deterministic
   algorithms on, gives bitwise equal losses.
7. ``moe_parity`` — ``forward_parity`` on the serving decoder with 8
   experts, top-2 (1,693,877,248 params; dense dispatch): the same checks,
   K6 three times a layer per forward under int8 (``wq``, ``wk``, ``wv``;
   ``wo``, the router and the experts dequantized).
8. ``moe_engine`` — the engine phase's four runs on that MoE config.
9. ``vit_train`` — ViT-B/16 (224/16, d_model 768, 12 layers, 12 heads, d_ff
   3072, 1000 classes; bf16, batch 128, flash attention, no remat): one
   step's loss and gradients through the flash kernels against the einsum
   attention (the train_parity bf16 limits), then 5 AdamW steps, counters
   zeroed before and read after each (K3, K4, K5 12 times a step, all on
   the tensor cores), losses finite and falling; step ms, images/s, model
   FLOP share of 989 TFLOP/s.
10. ``dit`` — DiT-S/2 (d_model 384, 12 layers, 6 heads, patch 2 on 32x32x4
   latents, 1000 classes; bf16): 3 train steps at batch 32 and a 10-step
   DDIM sample of 8 images with guidance 4.0 (finite), and the f32 forward
   on the card against the CPU's on 2 images (atol 1e-4). No kernel runs
   here: its attention is the plain one, as in the JAX package.
11. ``parallel`` — the parallel layer (``ray_tpu_torch/parallel``), ranks
   that share the card as processes over gloo (NCCL refuses two ranks on
   one GPU; gloo carries the collectives, and ``ppermute``'s staged
   send/receive, through host memory, so step times measure the mechanism,
   not scaling): (a) K3 causal and non-causal, K4 and K5 at the ``{"sp":
   2}`` shard ``[6,16,1024,128]``, and causal at the ``{"tp": 2}`` shard
   ``[6,8,2048,128]``, bf16, against their plain versions (atol = rtol =
   2e-2) on the tensor cores, timed beside SDPA and the bound; (b)
   ``ring_attention_sharded`` on 2 ranks, causal bf16 global
   ``[6,16,2048,128]``: rank r launches r + 1 of each of K3, K4, K5; the
   output (2e-2) and the gradients (relative Frobenius 2e-2) against
   ``flash_attention`` on the full tensors; (c) the train phase's 602M
   widths at ``CUT_LAYERS`` (2) layers (the phase's depth cut, for the
   script's time) for 3 steps on ``{"sp": 2}`` (ring) and ``{"tp": 2}``
   (flash): losses within ``LOSS_RTOL`` (2e-3) relative of one device's at
   that depth,
   K3/K4/K5 launches a step per rank, step ms (median after each rank's
   first step), tokens/s, peak memory and the bytes carried through the
   host; (d) the same widths at 2 layers on ``{"dp": 2, "sp": 2}`` (4
   ranks) and with 8 experts, top-2, dense dispatch, on ``{"ep": 2}``, each
   within ``LOSS_RTOL`` of one device's, and the collective layer's ops on a
   world-size-1 NCCL group; (e) a planted fault the limit must catch: (d)'s
   widths on ``{"sp": 2}`` (ring) with the gradient sum over sp left out of
   ``sum_replicas_`` in the rank processes, so each rank updates its
   replicated params with its own half-sequence's gradient; each rank's
   losses must stray from one device's by more than ``LOSS_RTOL``.
12. ``trainer`` — the training library (``ray_tpu_torch.train``) on the
   train phase's 602M decoder, one ``init(num_cpus=8)``, deterministic
   algorithms on for (a) and (b): (a) ``DeviceTrainer`` with one GPU rank
   on the decoder cut to ``CUT_LAYERS`` (2) layers (its widths kept):
   a seeded ``int32[24, 2048]`` token table through ``from_numpy`` and the
   rank's ``get_dataset_shard("train").iter_device_batches(batch_size=6)``
   into ``make_train_step`` on the rank's device, ``train.report`` a step;
   after step 2 one framed checkpoint of the train state (params, mu, nu:
   2.4 GB at 2 layers) is reported and the loop raises once; ``FailureConfig(
   max_failures=1)`` restarts the gang from that checkpoint on to step 4.
   The four losses equal a direct ``make_train_step`` from the same state
   on the same batches bitwise; K3/K4/K5 2/1/1 a layer and step on
   ``wgmma_bf16``;
   step ms beside the direct run's and the train phase's, the checkpoint's
   save and restore seconds, the restart's wall seconds. (b)
   ``TrainController`` gangs of in-process GPU actors on the 602M widths at
   ``CUT_LAYERS`` (2) layers, the loss over
   the flat f32 row (its leaves views of it), one 2048-token row a member a
   step drawn from a seeded float32 dataset: 4 steps at world 1 and at
   world 2 from the same seed, the curves within ``LOSS_RTOL``; a
   checkpoint after step 2 (params and momentum, 1.6 GB at 2 layers), then
   ``preempt_member(1, graceful=False)``: the typed error, ``recover()``
   (the member is gone for good, so the ladder shrinks), 2 more steps
   bitwise ``replay``'s and invariant 12 green. K3/K4/K5 2/1/1 a layer and
   member step, warm-ups included and counted apart, as are the replays'; gang
   step ms beside world 1's, peak memory, checkpoint and recovery seconds;
   the params and momentum stay on the card. (c) ``TorchTrainer``: two
   process ranks sharing ``cuda:0`` over gloo run ``tests/test_train.py``'s
   allreduce and DDP loops with the model on ``get_device()``: ``reduced
   == 3.0``, ``w0_spread == 0.0``, every rank's tensors on ``cuda:0``. (d)
   an actor collective group of two in-process GPU actors allreduces a 64
   MiB f32 CUDA tensor: bitwise the member-order sum, on the card; ms a
   call.
13. ``tune`` — Tune (``ray_tpu_torch.tune``) over the train phase's 602M
   step, one ``init(num_cpus=8)``, deterministic algorithms on: (a)
   ``AsyncHyperBandScheduler`` (max_t 4, grace 1, reduction 2) over a grid
   of four learning rates, two ``{"GPU": 0.5}`` trials at a time, each a
   function trainable given the one seeded train state by
   ``with_parameters``: it trains a copy (the put state is shared by every
   trial) and reports the loss every step. At least one trial stops before
   max_t; every loss is finite; the best trial's losses are bitwise a
   direct run's from the same state at its rate; the put state's digest is
   unchanged; K3/K4/K5 16/8/8 for every step the trials took, on
   ``wgmma_bf16``; each trial's step ms beside the train phase's, the
   experiment's wall seconds and peak memory. (b) Train-on-Tune: a
   ``DeviceTrainer`` whose one rank holds half the card, two learning rates
   two trials at a time, 2 steps each: every terminal loss bitwise a direct
   run's, ``get_best_result()`` the lower, the launches counted. (c) an
   experiment interrupted when its first trial finishes, then
   ``Tuner.restore``: only the unfinished trials run, the interrupted one
   from its checkpoint. Each experiment is waited on at most 600 s.
13b. ``jobs`` — jobs, workflows, state and usage on the card, one
   ``init(num_cpus=8, include_dashboard=True)``: (a) ``JobSubmissionClient``
   submits a driver (``job_driver``) by ``runtime_env={"working_dir": ...,
   "env_vars": {seed, mode}}``; in its own process it builds the serving
   decoder at full width and ``CUT_LAYERS`` (2) of its 16 layers (the
   script's time) from the serving phases' seed, serves the engine phase's
   burst through a GPU actor of its own runtime, float and int8, and prints
   each run's token digest and K1/K6 launches: the job ``SUCCEEDED``, the
   digests equal this process's own burst on the same decoder, K1
   ``CUT_LAYERS`` a decode step, K6 ``6 x CUT_LAYERS`` a forward on
   ``mma_bf16``, the kernels loaded from the build phase's libraries (none
   rebuilt); job start to first token. (b) a second GPU job decodes in a
   loop; ``stop_job`` while it runs gives ``STOPPED``, its process group is
   gone and the card's free memory is back within 1 GiB within 10 s. (c) a
   job whose ``env_vars`` hide the card asks for it: ``FAILED`` with the
   engine's refusal. (d) a durable workflow: a step waiting on
   ``wait_for_event`` (released over the head's HTTP event route), float and
   int8 generation of the burst in GPU steps through two GPU engine actors,
   (the same 2-layer decoder) and a comparison that fails once (a marker
   file); ``workflow.resume``
   reruns only the comparison, with no new K1 or K6 launch, and its output
   equals the direct tokens. (e) ``/api/cluster_status`` and
   ``state.list_nodes`` show the node's GPU, ``list_actors`` the engine
   actors with their shares, ``list_tasks`` the GPU steps ``FINISHED``; a
   ``num_gpus`` task with a ``profiling`` runtime env runs on the card in a
   worker of its own and writes a loadable ``.prof``; ``usage_stats.json``
   is in the session directory after ``shutdown``, and no job's process is
   left.
13c. ``cli`` — the operator surface on the card, over the serving decoder
   from the serving phases' seed: (a) under ``init(include_dashboard=True)``
   ``rt serve deploy`` of a YAML with the ``LLMServer`` float and int8 at
   ``CLI_SHARE`` of the card each; the burst over HTTP (8 requests, prompt
   64, 32 greedy tokens) equal to the engine phase's tokens, K1 16 a decode
   step, K6 96 a forward on ``mma_bf16``; during a burst ``rt llm`` shows
   the engine ``cache=paged`` with blocks in use and ``rt status`` the GPU;
   after it ``rt requests``, ``rt metrics``, ``rt summary tasks`` and ``rt
   serve status`` exit 0; ``rt serve shutdown`` frees the replicas' memory.
   (b) a runtime whose head holds no GPU: a ``num_gpus=1`` engine actor
   waits until a ``Monitor`` over an ``InProcessNodeProvider`` launches a
   ``{"CPU": 2, "GPU": 1}`` node (max 1); it serves the burst, tokens equal
   direct, K1 16 a decode step; after the kill the idle timeout terminates
   the node; ``sdk.request_resources(bundles=[{"GPU": 1}])`` launches one
   again and clearing it terminates it. (c) ``python -m
   ray_tpu_torch.scripts.llm_bench`` at full width: tokens/s, the card's
   name, K1 16 a decode step of its waves. (d) ``python -m
   ray_tpu_torch.scripts.kernel_bench``: K2 and K3 at long shapes against
   their plain versions, then timed beside them and their bounds. (e) ``rt
   microbenchmark --quick --only`` ``CLI_MICROBENCH_ROWS`` (the LLM rows on
   the head_dim-64 decoder; the multi-node rows spawn a node agent and
   relay through four data servers), every row with its unit; the LLM rows' in-row
   guards hold, except that a missed chunked-prefill or prefix-cache timing
   floor (``TimingFloorMissed``) is reported with the row's value. (f) ``rt lint``: zero violations over ``ray_tpu_torch/``. (g)
   ``python -m ray_tpu_torch start`` and ``stop`` as processes: the port's
   own address file, ``rt status`` reads the head, the card's memory free
   again after the stop.
13d. ``multinode`` — the multi-node runtime core on the card: this process
   is the head (``init(num_cpus=2, num_gpus=0, head_port=0)``) and one node
   agent (``python -m ray_tpu_torch.runtime.agent --num-gpus 1``, its stderr
   to a file printed if the phase fails) joins it over TCP. (a) a
   ``num_gpus=1`` actor on the agent builds the serving decoder from the
   serving phases' seed on the card and serves the engine phase's burst,
   float (int8 runs in (i), through the thin client), opened in one call
   and read token by token from here:
   tokens equal the engine phase's, K1 16 a decode step and K6 96 a forward
   on ``mma_bf16``, counted in the agent's process, whose pid is not this
   one's; tokens/s beside the engine phase's, TTFT seen from here. (b) a
   task on the agent makes a 1 GiB bf16 CUDA tensor; this process gets it
   over the data plane (a lazy commit: the control connection carries its
   size, not its bytes), digest equal, GB/s and whether CUDA IPC (card to
   card), shared memory or a socket carried it; this process's 256 MiB CUDA tensor is a ``num_gpus``
   task's argument on the agent, moved to ``cuda:0`` there, digest equal.
   (c) 200 repeat-shape tasks to the agent one at a time: one lease grant,
   then pushes on the data plane with no head-side pick; the round trip's
   median ms. (d) a collective group, one rank in this process and one in
   a GPU actor on the agent, allreduces 64 MiB of ``cuda:0`` f32 over the
   data plane: bitwise the sum; ms a call. (e) ``kill -9`` of the agent
   while a burst runs on its GPU actor: ``ActorDiedError`` within the
   health check's bound, the node dead in the table, the card's free memory
   (``mem_get_info`` here) back within 1 GiB of its level before the agent
   started, with the seconds each took; a new agent joins and a fresh GPU
   actor on it serves the float burst with the same tokens. (f) ``python -m
   ray_tpu_torch start --head`` (with ``--num-gpus 0``) and ``start
   --address <it> --num-gpus 1`` as processes: ``status`` shows two nodes
   and one GPU, ``stop`` ends the head and the agent leaves with it. (g)
   a compiled plan ``encode → generate_batch → decode`` (the ``dag``
   phase's graph) whose engine stage is a ``num_gpus=1`` actor in the
   second agent's process, at full depth, built there from the seed;
   encode and decode in this process, so both edges cross processes:
   tokens equal the engine phase's for its 8 prompts, every iteration; K1
   counted in the agent 16 a decode step; ms an ``execute`` and tokens/s
   beside the ``dag`` phase's in-process plan (2 layers) and the engine
   phase's; the rung each edge took (CUDA IPC pulls counted on each
   consumer's side), which must be CUDA IPC on both. Then ``kill -9`` of that agent during an
   ``execute``: a typed error (``ActorDiedError`` / ``WorkerCrashedError``)
   and the plan ``BROKEN`` within the health check's bound, the card's
   free memory back. (h) ``rt up`` on the ``local`` provider: a
   ``ClusterLauncher`` from a dict config with one node type ``{"CPU": 1,
   "GPU": 1}`` and ``min_workers`` 1 spawns a port agent with
   ``--num-gpus 1``, which joins with the card: seconds from ``up`` to the
   join. (i) a separate Python process connects with
   ``ray_tpu_torch.util.connect`` to a ``ClientServer`` of this head,
   creates a GPU actor on (h)'s node and runs the int8 burst: tokens equal
   the engine phase's int8 tokens, K6 96 a forward on ``mma_bf16`` and K1
   16 a decode step in the agent; tokens/s and client TTFT beside the
   engine phase's. Then the port's native C++ client (built by
   ``native/_build.py`` from ``tests/torch_cpp_client_main.cpp``) pings,
   puts, gets and calls Python functions by name (``chip_smoke:format_sum``,
   ``chip_smoke:reverse_bytes`` with a ref argument) against the same server.
   Then (h)'s ``down`` terminates the agent and the card's memory returns:
   the seconds.
13e. ``rllib`` — the RL library on the card; it runs no kernel of the
   repo (MLPs, envs and losses are PyTorch operations), so it adds no
   launches. (a) CartPole and Pendulum, 4096 envs for 500 steps, each step
   from the CPU env's state with the same actions: terminated and truncated
   flags equal, observations, rewards and states within 1e-5; the PPO loss,
   its gradients and one Learner update at an 8,192-row minibatch on
   ``cuda:0`` against the CPU (loss 1e-5, gradients, params and Adam
   ``mu`` within 1e-4 of their leaf's largest). (b) PPO on CartPole, 4096
   envs x 128 steps (524,288 env steps), 4 epochs of 8,192-row minibatches
   (256 updates), 10 iterations: the episode return above ``max(60, 1.5 x
   the first)`` (the JAX test's criterion); env steps/s while sampling, the
   median ms of a Learner update, the seconds of an iteration. (c) the same
   with two runners of 2,048 envs, remote (GPU actors holding half a card
   each) against inline, 2 iterations each of one epoch (64 updates). (d) DQN and SAC at the JAX
   tests' configurations (``tests/test_rllib.py``): DQN's return above 15
   after 25 iterations, SAC's critic loss finite after 4. (e) (b)'s
   algorithm saved, revived on the card and on the CPU
   (``from_checkpoint(device="cpu")``): greedy actions on 1,024 seeded
   observations equal (but where the two logits lie within 1e-5: a tie).
13f. ``rllib_contrib`` — ``rllib`` part 2 on the card (no kernel of the
   repo: DT's attention is two ``einsum``s and a softmax, as the JAX
   package's). (a) SimpleSpread, DiscreteSpread (3 agents) and
   LinearBanditEnv, 4096 envs for 200 steps, each step from the CPU env's
   state with the same actions: flags equal, values within 1e-5; the PG,
   A2C, SimpleQ, Ape-X and R2D2 losses and gradients; DDPG, TD3 (with and
   without the policy step), CRR (warm-up and actor), MADDPG, QMIX, DT,
   DreamerV3 (half widths), ES and ARS updates from one state and the same
   draws; 200 LinUCB and LinTS pulls: all on ``cuda:0`` against the CPU
   (losses 1e-5, gradients and params within 1e-4 of their leaf's largest,
   arms and ES ranks equal). (b) DreamerV3 at the JAX package's widths
   (deter 256, units 256, 16 x 16 latents) and the published batch (16
   sequences x 64 steps, horizon 15; 16 CartPole envs, 4 updates an
   iteration), 10 iterations: the world-model loss on a fixed probe batch
   and fixed draws falls (the JAX test's criterion); ms an update, its
   device launches (``torch.profiler``), env steps/s collecting. (c) DT at
   the published gym setting (3 layers, 1 head, embedding 128, context 20,
   batch 64) on the JAX test's mixed offline CartPole data, 5 iterations of
   60 updates: ``bc_loss`` falls and the return at target 200 is above 60;
   ms an update. (d) ES at its JAX test's configuration for 10 iterations
   to that test's criterion (above ``max(1.5 x the first, 40)``); every
   other part-2 algorithm 2 iterations at its JAX test's configuration with
   finite statistics. (e) (b)'s and (c)'s algorithms saved on the card and
   revived with ``from_checkpoint(device="cpu")`` (DT with its config, which
   carries the data): greedy actions on 1,024 seeded observations equal, but
   where two logits lie within 1e-5.
14. ``{"kernels": [...]}`` — per kernel: route, source, the TPU kernel it
   replaces, launches in the main-path runs (engine, server, disagg,
   runtime, serve, chaos, data, dag, jobs, cli, multinode, tp_serve, train,
   moe_engine, vit_train, parallel, trainer, tune) in all and by phase, max
   error, device ms, plain ms, bound ms and what bounds it, library ms;
   K1/K2 also the event floor and each timed shape; K3/K4/K5 also the parallel phase's
   shard shapes (``parallel_<shape>_*``).

Then the card's name and power limit (``nvidia-smi``), and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is present or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import glob
import hashlib
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from typing import Optional

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

PHASES = ("build", "kernels", "forward_parity", "engine", "server", "disagg", "runtime",
          "serve", "chaos", "data", "dag", "tp_serve", "train_parity",
          "train", "moe_parity", "moe_engine", "vit_train", "dit", "parallel", "trainer",
          "tune", "jobs", "cli", "multinode", "rllib", "rllib_contrib")
OPTIONAL_PHASES = ("profile",)


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``script_s``, the seconds since
    the script started, so the lines give each phase's share of the run."""
    if "phase" in obj:
        obj = {**obj, "script_s": round(time.perf_counter() - _T0, 3)}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------
def kernel_label(mangled: str) -> str:
    """``flash_fwd_wgmma_kernel<128,2>`` from a mangled kernel name (its
    identifier and template arguments), else the name itself."""
    i = mangled.find("_ZN") + 3
    while i > 2 and i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j: j + int(mangled[i:j])], j + int(mangled[i:j])
        if name.endswith("_kernel") and mangled.startswith("I", i):
            args = re.findall(r"Li(\d+)E|^(f)|13(__nv_bfloat16)|(DenseRows|PagedRows)",
                              mangled[i + 1: mangled.find("EEv", i)])
            args = ["float" if a[1] else a[0] or a[2] or a[3] for a in args]
            return f"{name}<{','.join(args)}>"
    return mangled


def ptxas_report(logs: dict) -> dict:
    """{kernel: {"registers": n, "spill_bytes": n}} from ``-Xptxas -v``."""
    out, fn = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = kernel_label(m.group(1))
                out[fn] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and fn:
                out[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m and fn:
                out[fn]["registers"] = int(m.group(1))
    return out


def hgmma_counts(libs: dict):
    """{kernel: number of tensor-core instructions in its SASS: HGMMA (wgmma)
    or HMMA (mma.sync)}, from ``cuobjdump -sass`` of each built library; None
    without cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    counts, fn = {}, None
    for lib in libs.values():
        sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                fn = kernel_label(m.group(1))
                counts[fn] = 0
            elif fn and ("HGMMA" in ln or "HMMA" in ln):
                counts[fn] += 1
    return counts


def is_tensor_core_kernel(name: str) -> bool:
    return "wgmma" in name or "_mma_" in name


def check_tensor_core_build(ptxas: dict, hgmma) -> None:
    """The tensor-core kernels (K3, K4, K5: wgmma; K6: mma) are all built,
    spill nothing and run tensor-core instructions; the others run none. The
    decode kernels (K1, K2), register-resident by design, spill nothing."""
    tc = [k for k in ptxas if is_tensor_core_kernel(k)]
    for stem in ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma", "int8_matmul_mma"):
        if not any(stem in k for k in tc):
            raise AssertionError(f"build: no {stem} kernel among {tc}")
    decode = [k for k in ptxas if k.startswith("decode_kernel")]
    if len(decode) != 24:  # f32/bf16 x D 64/128 x R 1/2/4 x dense/paged
        raise AssertionError(f"build: {len(decode)} decode kernels, want 24: {decode}")
    spilled = {k: ptxas[k] for k in tc + decode if ptxas[k].get("spill_bytes", 1) != 0}
    if spilled:
        raise AssertionError(f"build: kernels spill: {spilled}")
    if hgmma is not None:
        wrong = {k: n for k, n in hgmma.items() if (n > 0) != is_tensor_core_kernel(k)}
        if wrong or not all(hgmma.get(k) for k in tc):
            raise AssertionError(f"build: tensor-core instruction counts off: {wrong or hgmma}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def device_ms(fn, reps: int = 25, between=None) -> float:
    """Median device time of one ``fn()`` call, the stream pre-filled so no
    host launch cost is counted (``ray_tpu_torch.ops.variant_probe``)."""
    from ray_tpu_torch.ops.variant_probe import device_ms as timed

    return timed(fn, reps, between)


def bound(nbytes: int, flops: int, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, atol: float, rtol: float, what: str) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements off, max abs err {float(err.max()):.3e}"
        )
    return float(err.max())


TOLS = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 2e-2)}

# attention inside the train step of bench.py model_mfu: batch 6, 16 heads,
# T 2048, head_dim 128
TRAIN_ATTN = (6, 16, 2048, 128)
# attention inside the ViT-B/16 train step (vit_train): batch 128, 12 heads,
# T 197 (196 patches and the CLS token), head_dim 64, non-causal
VIT_ATTN = (128, 12, 197, 64)


def attention_work(B, H, T, D, causal: bool):
    """(visible (q, k) pairs, one bf16 [B, H, T, D] tensor's bytes, the f32
    [B, H, T] side tensor's bytes) of an attention call."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    return pairs, B * H * T * D * 2, B * H * T * 4


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
L2_BYTES = 50 * 2**20


def check_decode_cases(torch, fn, run, cases: dict, mk) -> dict:
    """Every case in f32 and bf16: one kernel launch against the plain
    version, and a second launch bitwise equal. Returns {"case/dtype": max
    abs err}."""
    errs = {}
    for dt in ("float32", "bfloat16"):
        atol, rtol = TOLS[dt]
        for name, shape in cases.items():
            case = mk(*shape, getattr(torch, dt))
            n = fn.launches
            got = run(case, None)
            if fn.launches != n + 1:
                raise AssertionError(f"{fn.__name__} {name} {dt}: {fn.launches - n} launches")
            errs[f"{name}/{dt}"] = max_err(got, run(case, False), atol, rtol,
                                           f"{fn.__name__} {name} {dt}")
            if not torch.equal(got, run(case, None)):
                raise AssertionError(f"{fn.__name__} {name} {dt}: two launches gave different bits")
            del case, got
    return errs


def time_decode(torch, run, case, nbytes: int, flops: int, library=None, plain=None) -> dict:
    """Device ms of one bf16 shape: cold (the L2 flushed by reading 2x its
    size between calls, as a decode step finds each layer's cache) and warm
    (the same inputs back to back), beside the bound; the library call and
    the plain version where given (warm)."""
    flush = torch.empty(2 * L2_BYTES // 4, device="cuda")
    cold = lambda: flush.sum()  # noqa: E731
    out = dict(kernel_ms=device_ms(lambda: run(case, None), between=cold),
               warm_kernel_ms=device_ms(lambda: run(case, None)))
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, "bfloat16")
    if library is not None:
        out["library_ms"] = device_ms(library, between=cold)
        out["warm_library_ms"] = device_ms(library)
    if plain is not None:
        out["plain_ms"] = device_ms(plain)
    return out


def decode_entry(name, source, replaces, shapes, errs, timed, floor_ms, **extra):
    """A K1/K2 line: ``ms`` at the main shape warm (the same inputs back to
    back, as the other kernels are timed), with every timed shape (cold and
    warm) beside it."""
    main = timed["main"]
    return dict(name=name, source=source, replaces=replaces, shapes=shapes, errs=errs,
                max_abs_err=errs["main/bfloat16"],
                kernel_ms=main["warm_kernel_ms"], cold_ms=main["kernel_ms"],
                plain_ms=main["plain_ms"], library_ms=main.get("warm_library_ms"),
                bound=(main["bound_ms"], main["bound_by"]), event_floor_ms=floor_ms,
                timed_shapes=timed, **extra)


def kernel_paged_decode(torch, g):
    from ray_tpu_torch.ops.decode_attention import _paged_decode_plain, paged_decode_attention
    from ray_tpu_torch.ops.variant_probe import DECODE_SHAPES, decode_cases, decode_inputs

    def run(case, use_kernel):
        q, kp, vp, bt, ln = case
        return paged_decode_attention(q, kp, vp, bt, ln, use_kernel=use_kernel)

    cases = decode_cases()
    mk = lambda *shape: decode_inputs(True, *shape, g)  # noqa: E731
    errs = check_decode_cases(torch, paged_decode_attention, run, cases, mk)
    # garbage page 0 full of NaN: never read, so the output is finite and
    # equals the plain version's on the same pool with page 0 zeroed
    for dt in ("float32", "bfloat16"):
        q, kp, vp, bt, ln = mk(*cases["main"], getattr(torch, dt))
        kp[0], vp[0] = float("nan"), float("nan")
        got = run((q, kp, vp, bt, ln), None)
        kp[0], vp[0] = 0.0, 0.0
        errs[f"nan_page0/{dt}"] = max_err(got, run((q, kp, vp, bt, ln), False), *TOLS[dt],
                                          f"paged_decode nan_page0 {dt}")
    torch.cuda.synchronize()
    timed = {}
    for name in DECODE_SHAPES:
        case = mk(*cases[name], torch.bfloat16)
        q, kp, vp, bt, ln = case
        (B, H, D), (_, bs, Hkv, _) = q.shape, kp.shape
        n_tok = int(ln.sum())
        pages = int((-(-ln.long() // bs)).sum())  # table entries a launch needs
        nbytes = 2 * q.numel() * 2 + n_tok * Hkv * D * 2 * 2 + pages * 4 + B * 4
        timed[name] = time_decode(
            torch, run, case, nbytes, 4 * n_tok * H * D,
            plain=lambda: _paged_decode_plain(q, kp, vp, bt, ln, D ** -0.5))
        timed[name]["shape"] = f"q[{B},{H},{D}] pages[{kp.shape[0]},{bs},{Hkv},{D}] " \
                               f"tables[{B},{bt.shape[1]}] lengths " \
                               f"{min(ln.tolist())}-{max(ln.tolist())} bf16"
        del case, q, kp, vp, bt, ln
    return decode_entry(
        "paged_decode_attention", "ray_tpu_torch/ops/csrc/decode_attention.cu",
        "ray_tpu/ops/decode_attention.py:158 _paged_decode_kernel (pallas_call at :290)",
        timed["main"]["shape"], errs, timed, event_floor(torch))


def kernel_dense_decode(torch, g):
    import torch.nn.functional as F

    from ray_tpu_torch.ops.decode_attention import _decode_plain, decode_attention
    from ray_tpu_torch.ops.variant_probe import DECODE_SHAPES, decode_cases, decode_inputs

    def run(case, use_kernel):
        q, k, v, ln = case
        return decode_attention(q, k, v, ln, use_kernel=use_kernel)

    cases = decode_cases()
    mk = lambda *shape: decode_inputs(False, *shape, g)  # noqa: E731
    errs = check_decode_cases(torch, decode_attention, run, cases, mk)
    timed = {}
    for name in DECODE_SHAPES:
        case = mk(*cases[name], torch.bfloat16)
        q, k, v, ln = case
        (B, H, D), Hkv = q.shape, k.shape[1]
        n_tok = int(ln.sum())
        nbytes = 2 * q.numel() * 2 + n_tok * Hkv * D * 2 * 2 + B * 4
        # the yardstick: one SDPA call over the same cache, lengths as a mask;
        # it reads K/V repeated to the H query heads, twice the bytes
        mask = (torch.arange(k.shape[2], device="cuda")[None, :] < ln[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        kr = k.repeat_interleave(H // Hkv, dim=1)
        vr = v.repeat_interleave(H // Hkv, dim=1)
        timed[name] = time_decode(
            torch, run, case, nbytes, 4 * n_tok * H * D,
            library=lambda: F.scaled_dot_product_attention(q4, kr, vr, attn_mask=mask),
            plain=lambda: _decode_plain(q, k, v, ln, D ** -0.5))
        timed[name]["shape"] = f"q[{B},{H},{D}] k/v[{B},{Hkv},{k.shape[2]},{D}] lengths " \
                               f"{min(ln.tolist())}-{max(ln.tolist())} bf16"
        del case, q, k, v, ln, kr, vr, mask, q4
    return decode_entry(
        "decode_attention", "ray_tpu_torch/ops/csrc/decode_attention.cu",
        "ray_tpu/ops/decode_attention.py:47 _decode_kernel (pallas_call at :134)",
        timed["main"]["shape"], errs, timed, event_floor(torch),
        library_call="scaled_dot_product_attention(q, k/v repeated to H heads, attn_mask): "
                     "reads twice the K/V bytes")


def event_floor(torch) -> float:
    """The event-timed floor of a trivial kernel under ``device_ms``."""
    z = torch.zeros(1, device="cuda")
    return device_ms(lambda: z.add_(1))


ROUTE_OF = {"bfloat16": "wgmma_bf16", "float32": "simt_f32"}


def check_route(fn, before: dict, dt: str, what: str, route: str = None) -> None:
    """One launch of ``fn`` on ``dt`` inputs moved its route's counter
    (``route``, by default the attention kernels' route of ``dt``), and only
    that one."""
    route = route or ROUTE_OF[dt]
    moved = {r: n - before[r] for r, n in fn.launches_by_route.items() if n != before[r]}
    if moved != {route: 1}:
        raise AssertionError(f"{what} {dt}: route counters moved {moved}, want {{{route!r}: 1}}")


def route_errs(errs: dict) -> dict:
    """Worst error of each route over its cases ({"case/dtype": err})."""
    out = {}
    for key, e in errs.items():
        r = ROUTE_OF[key.rsplit("/", 1)[1]]
        out[r] = max(out.get(r, 0.0), e)
    return {r: {"max_abs_err": e} for r, e in out.items()}


def kernel_flash_forward(torch, g):
    import torch.nn.functional as F

    from ray_tpu_torch.ops.attention import _flash_forward_plain, flash_attention_with_lse

    def mk(B, H, Tq, Tk, D, dtype):
        q = torch.randn(B, H, Tq, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, H, Tk, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, H, Tk, D, generator=g, device="cuda").to(dtype)
        return q, k, v

    cases = {  # (B, H, Tq, Tk, D, causal, window)
        "main": (1, 16, 64, 64, 64, True, None),
        "ragged_causal": (2, 4, 100, 100, 64, True, None),
        "ragged_noncausal": (2, 4, 37, 100, 64, False, None),
        "window_causal": (1, 4, 200, 200, 64, True, 16),
        "window_noncausal": (1, 4, 150, 150, 64, False, 40),
        "window_noncausal_empty_rows": (1, 4, 150, 60, 64, False, 40),  # rows >= 99 see no key
        "d128": (1, 8, 77, 77, 128, True, None),
        "t1024_d128": (1, 2, 1024, 1024, 128, True, None),
        "train_shape": (*TRAIN_ATTN[:3], TRAIN_ATTN[2], TRAIN_ATTN[3], True, None),
        "vit_noncausal": (*VIT_ATTN[:3], VIT_ATTN[2], VIT_ATTN[3], False, None),
        # any scale: a negative one flips Q's sign in the bf16 kernel
        "negative_scale": (2, 4, 77, 77, 64, True, None, -0.125),
        "zero_scale": (2, 4, 77, 77, 128, False, 16, 0.0),
    }
    errs = {}
    for dt in ("float32", "bfloat16"):
        atol, rtol = TOLS[dt]
        for name, (B, H, Tq, Tk, D, causal, window, *scale) in cases.items():
            scale = scale[0] if scale else None
            q, k, v = mk(B, H, Tq, Tk, D, getattr(torch, dt))
            before = dict(flash_attention_with_lse.launches_by_route)
            o_k, lse_k = flash_attention_with_lse(q, k, v, scale, causal, window=window)
            o_p, lse_p = flash_attention_with_lse(q, k, v, scale, causal, window=window,
                                                  use_kernel=False)
            errs[f"{name}/{dt}"] = max_err(o_k, o_p, atol, rtol, f"flash {name} {dt}")
            max_err(lse_k, lse_p, 1e-4, 1e-5, f"flash lse {name} {dt}")
            check_route(flash_attention_with_lse, before, dt, f"flash {name}")
            o_2, lse_2 = flash_attention_with_lse(q, k, v, scale, causal, window=window)
            if not (torch.equal(o_k, o_2) and torch.equal(lse_k, lse_2)):
                raise AssertionError(f"flash {name} {dt}: two launches gave different bits")
            del q, k, v, o_k, lse_k, o_p, lse_p, o_2, lse_2

    def measure(B, H, T, D, causal=True):
        q, k, v = mk(B, H, T, T, D, torch.bfloat16)
        pairs, elem, side = attention_work(B, H, T, D, causal)
        return dict(
            kernel_ms=device_ms(lambda: flash_attention_with_lse(q, k, v, None, causal)),
            plain_ms=device_ms(lambda: _flash_forward_plain(q, k, v, D ** -0.5, causal)),
            library_ms=device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)),
            bound=bound(4 * elem + side, 4 * D * pairs, "bfloat16"),
        )

    # the serving path's prefill shape, the train step's (bench.py
    # model_mfu) and the ViT train step's (non-causal)
    train = measure(*TRAIN_ATTN)
    train["bound_ms"], train["bound_by"] = train.pop("bound")
    vit = measure(*VIT_ATTN, causal=False)
    vit["bound_ms"], vit["bound_by"] = vit.pop("bound")
    B, H, T, D = 1, 16, 64, 64
    return dict(
        name="flash_attention_forward",
        source="ray_tpu_torch/ops/csrc/attention.cu",
        replaces="ray_tpu/ops/attention.py:62 _attn_fwd_kernel (pallas_call at :156)",
        shapes=f"q/k/v[{B},{H},{T},{D}] causal bf16",
        errs=errs, max_abs_err=errs["main/bfloat16"], by_route=route_errs(errs),
        library_call="scaled_dot_product_attention(q, k, v, is_causal=True)",
        **measure(B, H, T, D),
        train_shape="q/k/v[{},{},{},{}] causal bf16".format(*TRAIN_ATTN),
        **{f"train_{k}": x for k, x in train.items()},
        vit_shape="q/k/v[{},{},{},{}] non-causal bf16".format(*VIT_ATTN),
        vit_library_call="scaled_dot_product_attention(q, k, v, is_causal=False)",
        **{f"vit_{k}": x for k, x in vit.items()},
    )


def kernel_flash_backward(torch, g):
    """K4 and K5, each against its plain version (same q, k, v, dO, lse,
    delta), with a non-zero lse cotangent folded into delta, on both routes
    (bf16: tensor cores, f32: scalar)."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    def mk(B, H, Tq, Tk, D, causal, window, *scale, dtype):
        scale = scale[0] if scale else D ** -0.5
        q, g_out = (torch.randn(B, H, Tq, D, generator=g, device="cuda").to(dtype)
                    for _ in range(2))
        k, v = (torch.randn(B, H, Tk, D, generator=g, device="cuda").to(dtype) for _ in range(2))
        g_lse = torch.randn(B, H, Tq, generator=g, device="cuda")
        out, lse = A.flash_attention_with_lse(q, k, v, scale, causal, window=window)
        return (q, k, v, g_out, lse, A._delta(out, g_out, g_lse), scale, causal, window)

    cases = {  # (B, H, Tq, Tk, D, causal, window)
        "main": (*TRAIN_ATTN[:3], TRAIN_ATTN[2], TRAIN_ATTN[3], True, None),
        "ragged_causal": (2, 4, 100, 100, 64, True, None),
        "ragged_noncausal": (2, 4, 37, 100, 64, False, None),
        "window_causal": (1, 4, 200, 200, 64, True, 16),
        "window_noncausal": (1, 4, 150, 150, 64, False, 40),
        "window_noncausal_empty_rows": (1, 4, 150, 60, 64, False, 40),  # rows >= 99 see no key
        "d128": (1, 8, 77, 77, 128, True, None),
        "t1024_d128": (1, 2, 1024, 1024, 128, True, None),
        "window_causal_d128": (1, 4, 200, 200, 128, True, 16),
        "noncausal_d128_tq_ne_tk": (1, 2, 300, 130, 128, False, None),
        "vit_noncausal": (*VIT_ATTN[:3], VIT_ATTN[2], VIT_ATTN[3], False, None),
        # the lse of a forward at any scale (a negative one flips Q's sign there)
        "negative_scale": (2, 4, 77, 77, 64, True, None, -0.125),
        "zero_scale": (2, 4, 77, 77, 128, False, 16, 0.0),
    }
    errs = {"dq": {}, "dkv": {}}
    for dt in ("float32", "bfloat16"):
        atol, rtol = TOLS[dt]
        for name, shape in cases.items():
            a = mk(*shape, dtype=getattr(torch, dt))
            before = dict(A.flash_attention_backward_dq.launches_by_route)
            dq = A.flash_attention_backward_dq(*a)
            check_route(A.flash_attention_backward_dq, before, dt, f"backward dq {name}")
            before = dict(A.flash_attention_backward_dkv.launches_by_route)
            dk, dv = A.flash_attention_backward_dkv(*a)
            check_route(A.flash_attention_backward_dkv, before, dt, f"backward dkv {name}")
            dq_p = A._bwd_dq_plain(*a)
            dk_p, dv_p = A._bwd_dkv_plain(*a)
            what = f"{name} {dt}"
            errs["dq"][f"{name}/{dt}"] = max_err(dq, dq_p, atol, rtol, f"backward dq {what}")
            errs["dkv"][f"{name}/{dt}"] = max(max_err(dk, dk_p, atol, rtol, f"backward dk {what}"),
                                              max_err(dv, dv_p, atol, rtol, f"backward dv {what}"))
            # no atomics: a second launch on the same inputs gives the same bits
            dk2, dv2 = A.flash_attention_backward_dkv(*a)
            if not (torch.equal(dq, A.flash_attention_backward_dq(*a))
                    and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                raise AssertionError(f"backward {what}: two launches gave different bits")
            del a, dq, dk, dv, dq_p, dk_p, dv_p, dk2, dv2
    def measure(B, H, T, D, causal):
        """Device ms of K4 and K5 at one bf16 shape, their plain versions
        and their bounds, and the backward of one SDPA call on the same q,
        k, v (the yardstick of both)."""
        a = mk(B, H, T, T, D, causal, None, dtype=torch.bfloat16)
        q, k, v, g_out = a[:4]
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        library_ms = device_ms(
            lambda: torch.autograd.grad(o, (ql, kl, vl), g_out, retain_graph=True))
        pairs, elem, side = attention_work(B, H, T, D, causal)
        side *= 2  # lse and delta
        return (
            dict(kernel_ms=device_ms(lambda: A.flash_attention_backward_dq(*a)),
                 plain_ms=device_ms(lambda: A._bwd_dq_plain(*a)), library_ms=library_ms,
                 bound=bound(5 * elem + side, 6 * D * pairs, "bfloat16")),
            dict(kernel_ms=device_ms(lambda: A.flash_attention_backward_dkv(*a)),
                 plain_ms=device_ms(lambda: A._bwd_dkv_plain(*a)), library_ms=library_ms,
                 bound=bound(6 * elem + side, 8 * D * pairs, "bfloat16")),
        )

    B, H, T, D = TRAIN_ATTN
    main = measure(B, H, T, D, True)
    vit = measure(*VIT_ATTN, False)
    for m in vit:
        m["bound_ms"], m["bound_by"] = m.pop("bound")
    common = dict(shapes=f"q/k/v/dO[{B},{H},{T},{D}] causal bf16, non-zero g_lse",
                  library_call="backward of scaled_dot_product_attention(q, k, v, "
                               "is_causal=True): dq, dk and dv in one call",
                  vit_shape="q/k/v/dO[{},{},{},{}] non-causal bf16, non-zero g_lse".format(
                      *VIT_ATTN),
                  vit_library_call="backward of scaled_dot_product_attention(q, k, v, "
                                   "is_causal=False): dq, dk and dv in one call")
    return [
        dict(name="flash_attention_backward_dq",
             source="ray_tpu_torch/ops/csrc/attention_bwd.cu",
             replaces="ray_tpu/ops/attention.py:188 _bwd_dq_kernel (pallas_call at :319)",
             errs=errs["dq"], max_abs_err=errs["dq"]["main/bfloat16"],
             by_route=route_errs(errs["dq"]), **main[0],
             **{f"vit_{k}": x for k, x in vit[0].items()}, **common),
        dict(name="flash_attention_backward_dkv",
             source="ray_tpu_torch/ops/csrc/attention_bwd.cu",
             replaces="ray_tpu/ops/attention.py:237 _bwd_dkv_kernel (pallas_call at :342)",
             errs=errs["dkv"], max_abs_err=errs["dkv"]["main/bfloat16"],
             by_route=route_errs(errs["dkv"]), **main[1],
             **{f"vit_{k}": x for k, x in vit[1].items()}, **common),
    ]


# the int8 products of the llm_bench decoder, (M, K, N) at a decode step of
# 8 rows: wv has wk's shape, w3 has w1's; wo is dequantized, not a K6 product
K6_DECODE = {"wq": (8, 1024, 1024), "wk": (8, 1024, 512), "w1": (8, 1024, 4096),
             "w2": (8, 4096, 1024)}
K6_PER_LAYER = {"wq": 1, "wk": 2, "w1": 2, "w2": 1}


def kernel_int8_matmul(torch, g, n_layers: int = 16):
    from ray_tpu_torch.ops.quantization import (
        _int8_matmul_cuda,
        _int8_matmul_plain,
        dequantize_int8,
        int8_matmul,
        matmul_route,
        quantize_int8,
    )

    def mk(M, K, N, dtype, zero_col=None):
        x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
        w = torch.randn(K, N, generator=g, device="cuda")
        if zero_col is not None:
            w[:, zero_col] = 0  # quantizes to scale 1 and int8 zeros
        w_q, s = quantize_int8(w, axis=0)
        return x, w_q, s

    cases = {**{f"decode_{k}": v for k, v in K6_DECODE.items()},
             "prefill_w1": (64, 1024, 4096), "ragged": (100, 300, 50), "m1": (1, 1024, 1024),
             "zero_column": (8, 1024, 512),
             # the tensor-core route's row tiles (8, 16, 32, 64 and several of 64)
             **{f"m{m}": (m, 1024, 4096) for m in (16, 63, 64, 65, 200)},
             "m32_w2": (32, 4096, 1024),      # K over a cluster at a 32-row tile
             "ragged_k": (20, 328, 512),      # K % 16 != 0: a half-filled last step
             "ragged_n": (20, 256, 1000),     # N % 16 != 0: falls to the 4-byte loads
             # wide outputs: the 8- and 16-byte loads at each row tile (on 132 SMs)
             **{f"m{m}_n{n}": (m, 256, n) for m in (8, 16, 32) for n in (8448, 16896)}}
    errs, by_route = {}, {}
    for dt in ("float32", "bfloat16"):
        for name, (M, K, N) in cases.items():
            x, w_q, s = mk(M, K, N, getattr(torch, dt), 5 if name == "zero_column" else None)
            want = _int8_matmul_plain(x, w_q, s, x.dtype)
            atol, rtol = TOLS[dt]
            if dt == "float32":
                # f32 sums over K terms in another order: the error grows
                # like sqrt(K) * 2^-24 * |partial sums|, i.e. with the output
                atol = 1e-5 * float(want.abs().max())
            # the route the wrapper takes, and every other route that takes the case
            route = matmul_route(x.dtype, M, K, N)
            if route != ("mma_bf16" if dt == "bfloat16" and N % 16 == 0 and K % 8 == 0
                         else "simt"):
                raise AssertionError(f"int8_matmul {name} {dt}: route {route}")
            before = dict(int8_matmul.launches_by_route)
            got = int8_matmul(x, w_q, s)
            check_route(int8_matmul, before, dt, f"int8_matmul {name}", route)
            outs = {route: got}
            if route != "simt":
                outs["simt"] = _int8_matmul_cuda(x, w_q, s.reshape(N).float(), x.dtype,
                                                 route="simt")
            for r, y in outs.items():
                e = max_err(y, want, atol, rtol, f"int8_matmul {name} {dt} {r}")
                by_route[r] = max(by_route.get(r, 0.0), e)
                if name == "zero_column" and y[:, 5].any():
                    raise AssertionError(f"int8_matmul {dt} {r}: the zero column is not zero")
            errs[f"{name}/{dt}"] = max_err(got, want, atol, rtol, f"int8_matmul {name} {dt}")
            if not torch.equal(got, int8_matmul(x, w_q, s)):
                raise AssertionError(f"int8_matmul {name} {dt}: two launches gave different bits")
    torch.cuda.synchronize()

    def measure(M, K, N, library: bool):
        """Device ms at one bf16 shape, each call on the next of several
        weight copies that together exceed the L2 (a decode step reads
        every layer's weights once, cold)."""
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        n = max(2, -(-2 * L2_BYTES // (K * N)))
        ws = [quantize_int8(torch.randn(K, N, generator=g, device="cuda"), axis=0)
              for _ in range(n)]
        nxt = itertools.cycle(ws).__next__
        nbytes = K * N + M * K * 2 + N * 4 + M * N * 2
        out = dict(kernel_ms=device_ms(lambda: int8_matmul(x, *nxt())),
                   bound=bound(nbytes, 2 * M * K * N, "bfloat16"))
        if not library:
            return out
        out["warm_kernel_ms"] = device_ms(lambda: int8_matmul(x, *ws[0]))  # weights in L2
        # the same shape on the scalar route (what f32 and ragged shapes take)
        flat = [(w_q, s.reshape(N).float()) for w_q, s in ws]
        nxt_flat = itertools.cycle(flat).__next__
        out["simt_route_ms"] = device_ms(
            lambda: _int8_matmul_cuda(x, *nxt_flat(), torch.bfloat16, route="simt"))
        out["plain_ms"] = device_ms(lambda: _int8_matmul_plain(x, *nxt(), torch.bfloat16))
        # the JAX package's route: dequantize to param_dtype, cast, matmul
        out["jax_route_ms"] = device_ms(
            lambda: x @ dequantize_int8(*nxt(), torch.float32).to(torch.bfloat16))
        # the yardstick: one bf16 matmul on weights dequantized ahead of
        # time (the same product; it reads 2x the weight bytes)
        deq = [dequantize_int8(w_q, s, torch.bfloat16)
               for w_q, s in ws[: max(2, -(-2 * L2_BYTES // (2 * K * N)))]]
        nxt_deq = itertools.cycle(deq).__next__
        out["library_ms"] = device_ms(lambda: torch.matmul(x, nxt_deq()))
        del deq
        # PyTorch's own int8-weight product, where this build has it on CUDA
        w_q, s = ws[0]
        try:
            packed = [(w_q.t().contiguous(), s.reshape(-1).to(torch.bfloat16)) for w_q, s in ws]
            nxt_pk = itertools.cycle(packed).__next__
            y = torch._weight_int8pack_mm(x, *packed[0])
            out["int8pack_max_abs_err"] = float(
                (y.float() - _int8_matmul_plain(x, w_q, s, torch.float32)).abs().max())
            out["int8pack_ms"] = device_ms(lambda: torch._weight_int8pack_mm(x, *nxt_pk()))
        except Exception as exc:  # noqa: BLE001 — reported, never on the path
            out["int8pack_ms"] = None
            out["int8pack_error"] = f"{type(exc).__name__}: {str(exc)[:160]}"
        return out

    main = measure(*K6_DECODE["w1"], library=True)
    prefill = measure(*cases["prefill_w1"], library=True)
    per_shape = {k: measure(*v, library=False) for k, v in K6_DECODE.items()}
    # the weight-streaming rate on 128 MB of int8 weights (decode rows), and
    # the event-timed floor of a trivial kernel under device_ms
    stream = measure(8, 4096, 32768, library=False)
    floor_ms = event_floor(torch)
    step_ms = n_layers * sum(c * per_shape[k]["kernel_ms"] for k, c in K6_PER_LAYER.items())
    step_bound = n_layers * sum(c * per_shape[k]["bound"][0] for k, c in K6_PER_LAYER.items())
    M, K, N = K6_DECODE["w1"]
    return dict(
        name="int8_matmul",
        source="ray_tpu_torch/ops/csrc/int8_matmul.cu",
        replaces="ray_tpu/ops/quantization.py:49 _int8_matmul_kernel (pallas_call at :105)",
        shapes=f"x[{M},{K}] bf16 @ int8 w[{K},{N}] * f32 scales[{N}] (w1 at decode)",
        errs=errs, max_abs_err=errs["decode_w1/bfloat16"],
        by_route={r: {"max_abs_err": e} for r, e in by_route.items()},
        library_call="torch.matmul(x, w dequantized to bf16 ahead of time): the same "
                     "product, reading 2x the weight bytes",
        **main,
        prefill_shape="x[64,1024] bf16 @ int8 w[1024,4096] (w1 at a prompt-64 prefill)",
        **{f"prefill_{k}": v for k, v in prefill.items() if k != "bound"},
        prefill_bound_ms=prefill["bound"][0], prefill_bound_by=prefill["bound"][1],
        decode_shapes_ms={k: v["kernel_ms"] for k, v in per_shape.items()},
        decode_shapes_bound_ms={k: v["bound"][0] for k, v in per_shape.items()},
        decode_step_launches=n_layers * sum(K6_PER_LAYER.values()),
        decode_step_kernel_ms=step_ms, decode_step_bound_ms=step_bound,
        stream_shape="x[8,4096] bf16 @ int8 w[4096,32768]", stream_kernel_ms=stream["kernel_ms"],
        stream_bound_ms=stream["bound"][0],
        stream_weight_tb_s=4096 * 32768 / (stream["kernel_ms"] * 1e-3) / 1e12,
        event_floor_ms=floor_ms,
    )


# each returns the entries of the kernels line it checks
KERNEL_CHECKS = (
    lambda torch, g: [kernel_paged_decode(torch, g)],
    lambda torch, g: [kernel_dense_decode(torch, g)],
    lambda torch, g: [kernel_flash_forward(torch, g)],
    kernel_flash_backward,
    lambda torch, g: [kernel_int8_matmul(torch, g)],
)


# ---------------------------------------------------------------------------
# full-width model phases
# ---------------------------------------------------------------------------
def k6_per_layer(cfg) -> int:
    """int8_matmul launches a layer per forward under ``quantize=True``: the
    linears whose scales are per output column (wq, wk, wv and a dense
    FFN's w1, w3, w2); wo and a MoE layer's router and experts are
    dequantized."""
    return 3 if cfg.num_experts else 6


def serving_config(torch):
    from ray_tpu_torch.models.transformer import TransformerConfig

    # ray_tpu/scripts/llm_bench.py: the serving-class decoder (~284M params)
    return TransformerConfig(
        vocab_size=32000, d_model=1024, n_layers=16, n_heads=16, n_kv_heads=8,
        d_ff=4096, max_seq_len=1024, attention="dense", dtype=torch.bfloat16,
    )


def moe_config(torch):
    # the llm_bench decoder with 8 experts, top-2 (Mixtral 8x7B's expert
    # count and top-k: Jiang et al. 2024, Table 1), dense dispatch (the JAX
    # default, moe_capacity_factor 0): 1,693,877,248 params
    return dataclasses.replace(serving_config(torch), num_experts=8, expert_top_k=2)


def forward_parity(torch, cfg, params):
    from ray_tpu_torch.models import generation as gen
    from ray_tpu_torch.ops.quantization import dequantize_int8, int8_matmul, quantize_layers

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    B, Tp, steps = 2, 64, 4
    lengths = torch.tensor([64, 40], device=dev)
    prompt = torch.randint(1, cfg.vocab_size, (B, Tp), generator=g, device=dev)
    bs, M = 16, cfg.max_seq_len // 16
    perm = torch.randperm(B * M, generator=g, device=dev) + 1
    tables = perm.reshape(B, M).to(torch.int32)
    positions = torch.arange(Tp, device=dev)[None, :].expand(B, Tp)
    valid = positions < lengths[:, None]
    report = {}

    def paged(p, kernel: bool, **kw):
        cache = gen.init_paged_cache(cfg, B * M + 1, bs, device=dev)
        logits, _ = gen.paged_forward_with_cache(
            cfg, p, cache, tables, prompt, positions, valid=valid,
            use_decode_kernel=False, **kw,
        )
        out = [logits[torch.arange(B), lengths - 1]]
        for t in range(steps):
            tok = out[-1].argmax(-1)
            lg, _ = gen.paged_decode_step(
                cfg, p, cache, tok, lengths + t, tables, use_decode_kernel=kernel, **kw
            )
            out.append(lg)
        return out

    def dense(p, kernel: bool, **kw):
        cache = gen.init_cache(cfg, B, Tp + steps + 1, device=dev)
        last, _ = gen.prefill(cfg, p, cache, prompt, lengths,
                              use_prefill_kernel=kernel, use_decode_kernel=kernel, **kw)
        out = [last]
        for t in range(steps):
            tok = out[-1].argmax(-1)
            lg, _ = gen.decode_step(cfg, p, cache, tok, lengths + t,
                                    use_decode_kernel=kernel, **kw)
            out.append(lg)
        return out

    def compare(name, got, want):
        errs = [max_err(a, b, 1e-3, 0.0, f"{name} logits step {i}")
                for i, (a, b) in enumerate(zip(got, want))]
        t_got = [x.argmax(-1).tolist() for x in got]
        t_want = [x.argmax(-1).tolist() for x in want]
        if t_got != t_want:
            raise AssertionError(f"{name}: greedy tokens differ {t_got} vs {t_want}")
        report[name] = {"max_abs_err_per_step": errs, "tokens": t_got}

    with torch.inference_mode():
        for name, fn in (("paged", paged), ("dense", dense)):
            compare(name, fn(params, True), fn(params, False))
        out, lens = gen.generate(cfg, params, prompt, lengths, max_new_tokens=steps + 1,
                                 temperature=0)
        want = [[report["dense"]["tokens"][s][b] for s in range(steps + 1)] for b in range(B)]
        got = [out[b, int(lengths[b]): int(lengths[b]) + steps + 1].tolist() for b in range(B)]
        if got != want:
            raise AssertionError(f"generate(): {got} vs plain greedy {want}")
        report["generate_tokens"] = got

        # int8 layers: the kernels (K6 in six products a layer, three in a
        # MoE layer) against the plain path on the dequantized weights (the
        # JAX test's oracle)
        q_layers, scales = quantize_layers(params["layers"], min_size=4096)
        qparams = {**params, "layers": q_layers}
        deq = {**params, "layers": {k: dequantize_int8(w, scales[k]) if w.dtype == torch.int8
                                    else w for k, w in q_layers.items()}}
        per_forward = k6_per_layer(cfg) * cfg.n_layers
        for name, fn in (("paged_int8", paged), ("dense_int8", dense)):
            int8_matmul.launches = 0
            got = fn(qparams, True, layer_scales=scales)
            torch.cuda.synchronize()
            n = int8_matmul.launches
            if n != per_forward * (steps + 1):
                raise AssertionError(f"{name}: int8_matmul launched {n} times in {steps + 1} "
                                     f"forwards, want {per_forward} a forward")
            compare(name, got, fn(deq, False))
            report[name]["int8_matmul_launches"] = n
        report["int8_matmul_launches_per_forward"] = per_forward
        report["int8_layers"] = sorted(k for k, w in q_layers.items() if w.dtype == torch.int8)
    return report


def zero_counters(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0
        for r in getattr(fn, "launches_by_route", ()):
            fn.launches_by_route[r] = 0


def read_counters(counters: dict):
    """({kernel: launches}, {kernel: {route: launches}} for the kernels with
    routes: K3, K4, K5, K6)."""
    return ({name: fn.launches for name, fn in counters.items()},
            {name: dict(fn.launches_by_route) for name, fn in counters.items()
             if hasattr(fn, "launches_by_route")})


def run_engine(torch, cfg, params, cache_kind: str, n_req: int, prompt_len: int,
               max_tokens: int, counters: dict, quantize: bool = False):
    """Serve ``n_req`` concurrent streaming requests; ``counters`` ({kernel
    name: wrapper}) are zeroed just before the burst and read just after."""
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params, device="cuda", max_batch_size=8,
                    max_seq_len=cfg.max_seq_len, kv_block_size=16, cache_kind=cache_kind,
                    quantize=quantize)
    try:
        layers = eng.params["layers"]
        weight_bytes = {  # what the engine holds for the layers, against f32
            "layer_weight_bytes": sum(t.numel() * t.element_size() for t in layers.values()),
            "layer_scale_bytes": sum(t.numel() * t.element_size()
                                     for t in (eng._layer_scales or {}).values()),
            "layer_weight_bytes_f32": sum(t.numel() * 4 for t in layers.values()),
        }
        eng.generate([5] * prompt_len, max_tokens=2)  # warm-up: cuBLAS handles, kernel load
        torch.cuda.synchronize()
        prompts = burst_prompts(cfg, n_req, prompt_len)
        results = [None] * n_req
        ttft = [None] * n_req

        def client(i):
            t0 = time.perf_counter()
            toks = []
            for tok in eng.submit_stream(prompts[i], max_tokens=max_tokens):
                if not toks:
                    ttft[i] = time.perf_counter() - t0
                toks.append(tok)
            results[i] = toks

        zero_counters(counters)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_req)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, by_route = read_counters(counters)
    finally:
        eng.shutdown()
    for i, r in enumerate(results):
        if r is None or len(r) != max_tokens:
            raise AssertionError(f"{cache_kind} request {i} returned {r!r}")
        if not all(0 <= t < cfg.vocab_size for t in r):
            raise AssertionError(f"{cache_kind} request {i}: token out of range")
    n_tok = sum(len(r) for r in results)
    return {
        "cache_kind": cache_kind, "quantize": quantize, "requests": n_req,
        "prompt_len": prompt_len, "max_tokens": max_tokens, "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
        "launches": launches, "launches_by_route": by_route, **weight_bytes,
        "request_tokens": results,
    }


def burst_prompts(cfg, n_req: int, prompt_len: int):
    """The engine phase's burst: ``n_req`` distinct prompts (no shared prefix)."""
    return [[(7 * i + j) % (cfg.vocab_size - 2) + 1 for j in range(prompt_len)]
            for i in range(n_req)]


def run_engines(torch, cfg, params, kernels_of: dict):
    """The engine runs on ``cfg``: the paged and the dense engine, float and
    then ``quantize=True`` (8 and 2 concurrent requests; prompt 64, 32
    tokens, greedy), each yielded after its launch checks: every kernel of
    the run launched; the paged decode kernel once a layer in each of the 31
    decode steps at least; under int8, K6 ``k6_per_layer(cfg)`` times a
    layer and decode step (paged), every launch on the tensor cores (bf16
    activations)."""
    need = cfg.n_layers * 31  # decode steps after the prefill's first token
    for quantize in (False, True):
        for kind, n_req in (("paged", 8), ("dense", 2)):
            names = (["paged_decode_attention"] if kind == "paged"
                     else ["decode_attention", "flash_attention_forward"])
            if quantize:
                names.append("int8_matmul")
            run = run_engine(torch, cfg, params, kind, n_req, 64, 32,
                             {n: kernels_of[n] for n in names}, quantize=quantize)
            n = run["launches"]
            what = f"{'quantized ' if quantize else ''}{kind} engine"
            if min(n.values()) < 1:
                raise AssertionError(f"{what} skipped a kernel: {n}")
            if kind == "paged" and n["paged_decode_attention"] < need:
                raise AssertionError(f"{what}: paged decode kernel launched {n} < {need} times")
            if quantize:
                if kind == "paged" and n["int8_matmul"] < k6_per_layer(cfg) * need:
                    raise AssertionError(f"{what} launched {n}: want int8_matmul >= "
                                         f"{k6_per_layer(cfg) * need}")
                r = run["launches_by_route"]["int8_matmul"]
                if r != {"mma_bf16": n["int8_matmul"], "simt": 0}:
                    raise AssertionError(f"{what}: K6 routes {r}")
            yield run


# ---------------------------------------------------------------------------
# the serving front: LLMServer, OpenAICompatLLMServer, disaggregated pairs
# ---------------------------------------------------------------------------
class ToyTokenizer:
    """The JAX tests' toy tokenizer (tests/test_serve_llm.py): 1 char = 1 id."""

    def encode(self, s):
        return [ord(c) % 80 + 1 for c in s]

    def decode(self, ids):
        return "".join(chr((i - 1) % 80 + 97) for i in ids)


def sketch_delta(before: dict, after: dict) -> dict:
    """Percentiles of the observations an engine sketch took between two
    ``to_dict()`` readings (the max is the later reading's)."""
    from ray_tpu_torch.observability.sketch import LatencySketch

    return LatencySketch.from_dict({
        "boundaries": after["boundaries"],
        "counts": [a - b for a, b in zip(after["counts"], before["counts"])],
        "total": after["total"] - before["total"], "sum": after["sum"] - before["sum"],
        "max": after["max"],
    }).percentiles()


def engine_sketches(eng) -> dict:
    return {name: sk.to_dict() for name, sk in eng._sketches.items()}


def traced_stream(call, deployment: str):
    """What the Serve proxy does around a streamed request, for a server
    called directly: start the request's trace, put it in the context while
    ``call()`` submits, and finish it when the stream ends."""
    from ray_tpu_torch.observability import reqtrace
    from ray_tpu_torch.runtime.context import pop_request_trace, push_request_trace

    trace = reqtrace.start_trace(route="/", deployment=deployment)
    token = push_request_trace(trace)
    try:
        events = call()
    finally:
        pop_request_trace(token)
    try:
        yield from events
    finally:
        reqtrace.finish_trace(trace)


def trace_phases(store, n: int, max_tokens: int) -> dict:
    """Median ms of each request-trace phase over the ``n`` traces ``store``
    finished last (the proxy, or ``traced_stream``, starts one a request),
    after checking each: outcome ``ok``, ``max_tokens`` tokens, phases
    summing to e2e."""
    done = [store.find(d["id"]) for d in store.snapshot(limit=n)["recent"]]
    by_phase = {}
    for t in done:
        spans = t.phases()
        if (t.outcome != "ok" or t.tokens != max_tokens
                or abs(sum(b - a for _, a, b in spans) - t.e2e_s) > 1e-9):
            raise AssertionError(f"request trace {t.to_dict()}")
        for phase, a, b in spans:
            by_phase.setdefault(phase, []).append((b - a) * 1e3)
    if len(done) != n:
        raise AssertionError(f"{len(done)} request traces finished, not {n}")
    return {p: statistics.median(v) for p, v in by_phase.items()}


def stream_burst(prompts, max_tokens: int, ask):
    """One client thread a prompt; ``ask(i)`` returns request i's event
    iterator (``{"token": t}`` events, then ``{"done": ...}``). Returns
    (tokens per request, client TTFT per request, wall seconds)."""
    n = len(prompts)
    results, ttft, done = [None] * n, [None] * n, [None] * n

    def client(i):
        t0 = time.perf_counter()
        toks = []
        for ev in ask(i):
            if "token" in ev:
                if not toks:
                    ttft[i] = time.perf_counter() - t0
                toks.append(ev["token"])
            else:
                done[i] = ev
        results[i] = toks

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    for i, (r, d) in enumerate(zip(results, done)):
        if r is None or len(r) != max_tokens or d != {"done": True, "num_generated": max_tokens}:
            raise AssertionError(f"request {i} returned {r!r}, then {d!r}")
    return results, ttft, wall


def check_openai(torch, cfg, params) -> dict:
    """A completion, a chat and a streamed chat through
    ``OpenAICompatLLMServer`` (toy tokenizer, greedy): envelopes, usage
    counts, finish reasons; ``top_p=0.5`` is refused."""
    from ray_tpu_torch.serve.llm import OpenAICompatLLMServer

    tok = ToyTokenizer()
    srv = OpenAICompatLLMServer(lambda: (cfg, params, tok), device="cuda", max_batch_size=8,
                                max_seq_len=cfg.max_seq_len)
    try:
        text = "once upon a time"
        comp = srv({"model": "llm_bench", "prompt": text, "max_tokens": 16, "temperature": 0})
        msgs = [{"role": "user", "content": "tell me a story"}]
        chat = srv({"model": "llm_bench", "messages": msgs, "max_tokens": 16, "temperature": 0})
        chunks = list(srv({"model": "llm_bench", "messages": msgs, "max_tokens": 16,
                           "temperature": 0, "stream": True}))
        try:
            srv({"model": "llm_bench", "prompt": text, "top_p": 0.5, "temperature": 0})
            refused = None
        except ValueError as exc:
            refused = str(exc)
    finally:
        srv.engine.shutdown()
    chat_prompt = len(tok.encode("user: tell me a story\nassistant:"))
    for resp, obj, prefix, n_prompt in ((comp, "text_completion", "cmpl-", len(text)),
                                        (chat, "chat.completion", "chatcmpl-", chat_prompt)):
        c = resp["choices"][0]
        body = c["text"] if obj == "text_completion" else c["message"]["content"]
        if (resp["object"] != obj or not resp["id"].startswith(prefix)
                or resp["model"] != "llm_bench" or c["finish_reason"] != "length"
                or len(c["token_ids"]) != 16 or body != tok.decode(c["token_ids"])
                or resp["usage"] != {"prompt_tokens": n_prompt, "completion_tokens": 16,
                                     "total_tokens": n_prompt + 16}):
            raise AssertionError(f"{obj}: envelope {resp}")
    if chat["choices"][0]["message"]["role"] != "assistant":
        raise AssertionError(f"chat message {chat['choices'][0]}")
    ids = {c["id"] for c in chunks}
    pieces = [c["choices"][0]["delta"].get("content") for c in chunks[:-1]]
    if (len(ids) != 1 or not ids.pop().startswith("chatcmpl-") or len(pieces) != 16
            or any(c["object"] != "chat.completion.chunk" for c in chunks)
            or chunks[-1]["choices"][0] != {"delta": {}, "index": 0, "finish_reason": "length"}):
        raise AssertionError(f"streamed chat chunks {chunks}")
    if refused is None or "top_p=0.5" not in refused:
        raise AssertionError(f"top_p=0.5 was not refused: {refused!r}")
    return {"completion_text": comp["choices"][0]["text"],
            "chat_content": chat["choices"][0]["message"]["content"],
            "streamed_chat_content": "".join(pieces),
            "streamed_equals_blocking_chat": "".join(pieces) == chat["choices"][0]["message"]["content"],
            "usage": {"completion": comp["usage"], "chat": chat["usage"]},
            "top_p_refused": refused}


def run_servers(torch, cfg, params, kernels_of: dict, engine_tokens: dict):
    """``LLMServer`` at full width in bf16 answers the engine phase's burst
    (8 streaming clients, prompt 64, 32 tokens, greedy): paged, dense and
    paged with ``quantize=True``, each yielded after its checks (every
    kernel of the run launched; K1 at least once a layer in each of 31
    decode steps; every K6 launch on the tensor cores). The paged server's
    tokens must equal the paged engine phase's; on the dense server one
    blocking and one streaming request for the first prompt must give its
    burst tokens. Each burst's request traces (started around each call as
    the Serve proxy starts them) give the median of every phase. Then
    ``check_openai``."""
    from ray_tpu_torch.observability import reqtrace
    from ray_tpu_torch.serve.llm import LLMServer

    prompts = burst_prompts(cfg, 8, 64)
    need = cfg.n_layers * 31
    for kind, quantize in (("paged", False), ("dense", False), ("paged", True)):
        names = (["paged_decode_attention"] if kind == "paged"
                 else ["decode_attention", "flash_attention_forward"])
        if quantize:
            names.append("int8_matmul")
        counters = {n: kernels_of[n] for n in names}
        srv = LLMServer(lambda: (cfg, params), device="cuda", max_batch_size=8,
                        max_seq_len=cfg.max_seq_len, kv_block_size=16, cache_kind=kind,
                        quantize=quantize)
        try:
            srv({"prompt": [5] * 64, "max_tokens": 2})  # warm-up: the loop's cuBLAS handle
            torch.cuda.synchronize()
            before = engine_sketches(srv.engine)
            reqtrace.global_trace_store().reset()
            zero_counters(counters)
            tokens, ttft, wall = stream_burst(
                prompts, 32, lambda i: traced_stream(
                    lambda: srv({"prompt": prompts[i], "max_tokens": 32, "stream": True}),
                    "LLMServer"))
            torch.cuda.synchronize()
            launches, by_route = read_counters(counters)
            lat = {k: sketch_delta(before[k], v) for k, v in engine_sketches(srv.engine).items()}
            phases = trace_phases(reqtrace.global_trace_store(), len(prompts), 32)
            extra = {}
            if kind == "dense":
                blocking = srv({"prompt": prompts[0], "max_tokens": 32})
                events = list(srv({"prompt": prompts[0], "max_tokens": 32, "stream": True}))
                streamed = [e["token"] for e in events if "token" in e]
                if not (blocking["tokens"] == streamed == tokens[0]
                        and events[-1] == {"done": True, "num_generated": 32}):
                    raise AssertionError(f"dense server: stream {streamed} vs blocking "
                                         f"{blocking['tokens']} vs burst {tokens[0]}")
                extra["stream_equals_blocking"] = True
            stats = srv.stats()
        finally:
            srv.engine.shutdown()
        what = f"{'quantized ' if quantize else ''}{kind} server"
        if min(launches.values()) < 1:
            raise AssertionError(f"{what} skipped a kernel: {launches}")
        if kind == "paged" and launches["paged_decode_attention"] < need:
            raise AssertionError(f"{what}: K1 launched {launches} < {need} times")
        if quantize and by_route["int8_matmul"] != {"mma_bf16": launches["int8_matmul"],
                                                    "simt": 0}:
            raise AssertionError(f"{what}: K6 routes {by_route['int8_matmul']}")
        ref = engine_tokens.get((kind, quantize))
        if (kind, quantize) == ("paged", False) and tokens != ref:
            raise AssertionError(f"{what}: tokens differ from the paged engine's {tokens} vs {ref}")
        if any(not all(0 <= t < cfg.vocab_size for t in r) for r in tokens):
            raise AssertionError(f"{what}: token out of range")
        n_tok = sum(len(r) for r in tokens)
        yield {
            "server": "LLMServer", "cache_kind": kind, "quantize": quantize, "requests": 8,
            "prompt_len": 64, "max_tokens": 32, "tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall, "ttft_s_median": statistics.median(ttft),
            "ttft_s_max": max(ttft),
            "engine_ttft_s": {k: lat["ttft"][k] for k in ("count", "p50", "p99")},
            "engine_inter_token_s": {k: lat["inter_token"][k] for k in ("count", "p50", "p99")},
            "engine_queue_wait_s": {k: lat["queue_wait"][k] for k in ("count", "p50", "p99")},
            "trace_phase_ms_median": phases,
            "equal_to_engine_phase": None if ref is None else (
                tokens == ref if kind == "paged" else tokens[:len(ref)] == ref),
            "launches": launches, "launches_by_route": by_route,
            "prefix_cache_blocks": stats["prefix_cache_blocks"], **extra,
        }
    yield {"server": "OpenAICompatLLMServer", **check_openai(torch, cfg, params)}


def run_disagg(torch, cfg, params, kernels_of: dict, colocated: dict):
    """The disagg phase: (a) in process and (b) over CUDA IPC in f32 with TF32
    off, (c) the bf16 burst through an in-process pair, float and int8.
    Yields one report each, with its K1 (and K6) launches."""
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    a = disagg_in_process(torch, f32, params, kernels_of["paged_decode_attention"])
    tokens = a.pop("tokens")
    yield {"part": "a_in_process_f32", **a,
           "launches": {"paged_decode_attention": a["k1_launches_decode_side"]}}
    torch.cuda.empty_cache()
    yield {"part": "b_cuda_ipc_f32",
           **disagg_cuda_ipc(torch, f32, params, tokens, kernels_of["paged_decode_attention"])}
    torch.cuda.empty_cache()
    for quantize in (False, True):
        yield {"part": "c_burst_bf16", **disagg_burst(
            torch, cfg, params, kernels_of, quantize, colocated.get(quantize))}
        torch.cuda.empty_cache()


def _prefill_worker(cfg, prompts, mig_prefix, conn):
    """The prefill engine of a spawned process (disagg phase, part b): the
    serving decoder's weights from the same seed, f32 with TF32 off; export
    every prompt, send the tickets, keep the staged blocks until the parent
    names the migrations to release, report, exit."""
    import torch

    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.runtime import device_plane
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    eng = LLMEngine(cfg, params, device="cuda", max_batch_size=8,
                    max_seq_len=cfg.max_seq_len, kv_block_size=16, role="prefill")
    try:
        futs = [eng.prefill_export(p, mig_id=f"{mig_prefix}/{i}") for i, p in enumerate(prompts)]
        conn.send([f.result(timeout=300) for f in futs])
        for mig_id in conn.recv():
            eng.release_migration(mig_id)
        server = device_plane.transfer_server()
        conn.send({"pulls_served": server.pulls_served, "staged_left": server.staged_count(),
                   "stats": eng.stats()})
    finally:
        eng.shutdown()


def migrate_burst(prompts, prefix: str, p_eng, d_eng, max_tokens: int):
    """Every prompt through export → pulls of the blocks ``d_eng`` lacks →
    adoption, one client thread a prompt. Returns (tokens, rungs per
    request, pull seconds per request)."""
    from ray_tpu_torch.serve import disagg

    n = len(prompts)
    tokens, rungs, pull_s = [None] * n, [None] * n, [None] * n

    def client(i):
        ticket = p_eng.prefill_export(prompts[i], mig_id=f"{prefix}/{i}").result(timeout=300)
        t0 = time.perf_counter()
        arrays, r = {}, []
        for b in range(d_eng.peek_prefix_match(prompts[i]) // d_eng.kv_block_size,
                       ticket["n_blocks"]):
            arrays[b], rung = disagg.pull_block(ticket, b)
            r.append(rung)
        pull_s[i] = time.perf_counter() - t0
        rungs[i] = r
        tokens[i] = d_eng.adopt_migration(ticket, arrays,
                                          max_tokens=max_tokens).future.result(timeout=300)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    for i in range(n):
        p_eng.release_migration(f"{prefix}/{i}")
    if any(t is None for t in tokens):
        raise AssertionError(f"{prefix}: a migrated request failed: {tokens}")
    return tokens, rungs, pull_s


def assert_no_leak(eng, what: str) -> None:
    st = eng.stats()
    if st["kv_blocks_in_use"] != st["prefix_cache_blocks"] or st["staged_migrations"]:
        raise AssertionError(f"{what}: pages held outside the prefix cache: {st}")
    eng.flush_prefix_cache()
    if eng.stats()["kv_blocks_in_use"]:
        raise AssertionError(f"{what}: pages leaked: {eng.stats()}")


def disagg_in_process(torch, cfg, params, k1) -> dict:
    """(a) A prefill and a decode engine in this process, f32 activations
    with TF32 off: eight 64-token prompts exported, pulled (every rung the
    in-process ``"host"`` one) and adopted; greedy tokens identical to one
    co-located engine's; K1 only on the decode side, 16 a decode step. Then
    the first prompt again: zero blocks pulled (the decode side's prefix
    cache), the same tokens."""
    from ray_tpu_torch.serve.llm import LLMEngine

    prompts = burst_prompts(cfg, 8, 64)
    kw = dict(device="cuda", max_batch_size=8, max_seq_len=cfg.max_seq_len, kv_block_size=16)
    co = LLMEngine(cfg, params, **kw)
    try:
        futs = [co.submit(p, max_tokens=32) for p in prompts]
        ref = [f.result(timeout=300) for f in futs]
    finally:
        co.shutdown()
    p_eng = LLMEngine(cfg, params, role="prefill", **kw)
    d_eng = LLMEngine(cfg, params, role="decode", **kw)
    try:
        k1.launches = 0  # an export alone (another prompt): no decode on this side
        p_eng.prefill_export(prompts[0][::-1], mig_id="probe").result(timeout=300)
        torch.cuda.synchronize()
        k1_prefill = k1.launches
        p_eng.release_migration("probe")
        k1.launches = 0
        tokens, rungs, _ = migrate_burst(prompts, "a", p_eng, d_eng, 32)
        torch.cuda.synchronize()
        k1_burst = k1.launches
        again, again_rungs, _ = migrate_burst(prompts[:1], "a2", p_eng, d_eng, 32)
        if tokens != ref:
            raise AssertionError(f"migrated tokens differ from co-located: {tokens} vs {ref}")
        if {r for rr in rungs for r in rr} != {"host"} or any(len(rr) != 4 for rr in rungs):
            raise AssertionError(f"in-process rungs {rungs}")
        if again != ref[:1] or again_rungs != [[]]:
            raise AssertionError(f"warm prefix: pulled {again_rungs}, tokens {again} vs {ref[:1]}")
        if k1_prefill != 0 or k1_burst % cfg.n_layers or k1_burst < cfg.n_layers * 31:
            raise AssertionError(f"K1 launches: prefill side {k1_prefill}, decode {k1_burst}")
        assert_no_leak(p_eng, "prefill engine")
        assert_no_leak(d_eng, "decode engine")
        return {"tokens_equal_colocated": True, "rungs": sorted({r for rr in rungs for r in rr}),
                "blocks_pulled": sum(len(rr) for rr in rungs), "warm_prefix_blocks_pulled": 0,
                "k1_launches_prefill_side": k1_prefill, "k1_launches_decode_side": k1_burst,
                "k1_per_decode_step": cfg.n_layers, "tokens": tokens}
    finally:
        p_eng.shutdown()
        d_eng.shutdown()


def disagg_cuda_ipc(torch, cfg, params, want_tokens, k1) -> dict:
    """(b) The prefill engine in a spawned process; this process's decode
    engine pulls every block over the transfer server (CUDA IPC): every rung
    ``"device"``, the tokens equal (a)'s, one connection for every block.
    Pull ms and GB/s a block; connect, IPC-open and copy ms apart."""
    import multiprocessing

    from ray_tpu_torch.runtime import device_plane
    from ray_tpu_torch.serve import disagg
    from ray_tpu_torch.serve.llm import LLMEngine

    prompts = burst_prompts(cfg, 8, 64)
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_prefill_worker, args=(cfg, prompts, "b", child), daemon=True)
    t0 = time.perf_counter()
    proc.start()
    d_eng = LLMEngine(cfg, params, device="cuda", max_batch_size=8,
                      max_seq_len=cfg.max_seq_len, kv_block_size=16, role="decode")
    try:
        if not parent.poll(600):
            raise AssertionError("the prefill process sent no tickets")
        tickets = parent.recv()
        child_s = time.perf_counter() - t0
        k1.launches = 0
        stats0 = device_plane.stats.snapshot()
        pull_ms, rungs, futs = [], [], []
        for t in tickets:
            arrays = {}
            for b in range(t["n_blocks"]):
                t1 = time.perf_counter()
                arrays[b], rung = disagg.pull_block(t, b)
                pull_ms.append((time.perf_counter() - t1) * 1e3)
                rungs.append(rung)
            futs.append(d_eng.adopt_migration(t, arrays, max_tokens=32).future)
        tokens = [f.result(timeout=300) for f in futs]
        torch.cuda.synchronize()
        k1_decode = k1.launches
        pulled = {k: v - stats0[k] for k, v in device_plane.stats.snapshot().items()}
        parent.send([t["mig_id"] for t in tickets])
        if not parent.poll(300):
            raise AssertionError("the prefill process did not report")
        report = parent.recv()
        assert_no_leak(d_eng, "decode engine (CUDA IPC)")
    finally:
        d_eng.shutdown()
        proc.join(timeout=120)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=30)
    if proc.exitcode != 0:
        raise AssertionError(f"the prefill process exited with {proc.exitcode}")
    if set(rungs) != {"device"}:
        raise AssertionError(f"CUDA IPC rungs {rungs}")
    if k1_decode % cfg.n_layers or k1_decode < cfg.n_layers * 31:
        raise AssertionError(f"CUDA IPC decode engine: K1 launched {k1_decode} times")
    if tokens != want_tokens:
        raise AssertionError(f"CUDA IPC tokens differ from in-process: {tokens} vs {want_tokens}")
    if report["pulls_served"] != len(rungs) or report["staged_left"]:
        raise AssertionError(f"prefill process report {report}")
    if pulled["connects"] != 1 or pulled["ici_pulls"] != len(rungs):
        raise AssertionError(f"the pulls did not ride one connection: {pulled}")
    shape = tickets[0]["block_shape"]
    block_bytes = math.prod(shape) * getattr(torch, tickets[0]["block_dtype"]).itemsize
    med = statistics.median(pull_ms)
    return {"rungs": sorted(set(rungs)), "tokens_equal_in_process": True,
            "blocks_pulled": len(rungs), "block_shape": list(shape),
            "block_dtype": tickets[0]["block_dtype"], "block_bytes": block_bytes,
            "pull_ms_median": med, "pull_ms_max": max(pull_ms),
            "pull_gb_per_s_median": block_bytes / med / 1e6,
            "child_start_to_tickets_s": child_s, "device_pulls": pulled,
            "connect_ms": pulled["connect_s"] * 1e3,
            "open_ms_per_block": pulled["open_s"] * 1e3 / len(rungs),
            "copy_ms_per_block": pulled["copy_s"] * 1e3 / len(rungs),
            "launches": {"paged_decode_attention": k1_decode},
            "prefill_process": {"pulls_served": report["pulls_served"],
                                "migrations_out": report["stats"]["migrations_out"]}}


def disagg_burst(torch, cfg, params, kernels_of: dict, quantize: bool, colocated):
    """(c) The engine phase's bf16 burst through an in-process pair of
    ``LLMServer`` instances (``disagg_prefill`` → ``disagg_decode`` streaming →
    ``disagg_release``): tokens/s and client TTFT (to the first token the
    decode side streams) beside the co-located paged server's, migration ms
    a request and a block (ticket in hand → first streamed token: pulls,
    admission, the write into the pool) and GB/s. Then the halves alone:
    one export (K1 none; under int8 K6 on the prefill forward) and its
    decode (K1 16 a decode step; under int8 K6 too)."""
    from ray_tpu_torch.serve.llm import LLMServer

    names = ["paged_decode_attention"] + (["int8_matmul"] if quantize else [])
    counters = {n: kernels_of[n] for n in names}
    kw = dict(device="cuda", max_batch_size=8, max_seq_len=cfg.max_seq_len, kv_block_size=16,
              quantize=quantize)
    srv_p = LLMServer(lambda: (cfg, params), role="prefill", **kw)
    srv_d = LLMServer(lambda: (cfg, params), role="decode", **kw)
    prompts = burst_prompts(cfg, 8, 64)
    mig_s = [None] * 8
    try:
        warm = {"prompt": [5] * 64, "max_tokens": 2}
        srv_d.disagg_decode(warm, srv_p.disagg_prefill(warm, "c/warm"))
        srv_p.disagg_release("c/warm")
        torch.cuda.synchronize()

        def ask(i):
            req = {"prompt": prompts[i], "max_tokens": 32, "stream": True}
            ticket = srv_p.disagg_prefill(req, f"c/{i}")
            t0 = time.perf_counter()
            resp = srv_d.disagg_decode(req, ticket)
            if resp.get("_migration_rung") != "host":
                raise AssertionError(f"in-process pair rung {resp}")
            first = True
            for ev in resp["_stream"]:
                if first:
                    mig_s[i] = time.perf_counter() - t0
                    first = False
                yield ev
            srv_p.disagg_release(f"c/{i}")

        zero_counters(counters)
        tokens, ttft, wall = stream_burst(prompts, 32, ask)
        torch.cuda.synchronize()
        launches, by_route = read_counters(counters)
        # the halves alone: the export, then its decode
        zero_counters(counters)
        ticket = srv_p.disagg_prefill({"prompt": prompts[0][::-1]}, "c/half")
        torch.cuda.synchronize()
        prefill_half = read_counters(counters)[0]
        zero_counters(counters)
        srv_d.disagg_decode({"prompt": prompts[0][::-1], "max_tokens": 32}, ticket)
        torch.cuda.synchronize()
        decode_half = read_counters(counters)[0]
        srv_p.disagg_release("c/half")
        block_bytes = 2 * cfg.n_layers * 16 * cfg.kv_heads * cfg.head_dim * 2  # bf16
        assert_no_leak(srv_p.engine, "prefill server")
        assert_no_leak(srv_d.engine, "decode server")
    finally:
        srv_p.engine.shutdown()
        srv_d.engine.shutdown()
    per_layer = k6_per_layer(cfg) * cfg.n_layers
    if prefill_half.get("paged_decode_attention") != 0 or \
            decode_half.get("paged_decode_attention") != cfg.n_layers * 31:
        raise AssertionError(f"K1 by half: prefill {prefill_half}, decode {decode_half}")
    if quantize and (prefill_half["int8_matmul"] != per_layer
                     or decode_half["int8_matmul"] != per_layer * 31
                     or by_route["int8_matmul"] != {"mma_bf16": launches["int8_matmul"],
                                                    "simt": 0}):
        raise AssertionError(f"K6 by half: prefill {prefill_half}, decode {decode_half}, "
                             f"routes {by_route}")
    if launches["paged_decode_attention"] % cfg.n_layers:
        raise AssertionError(f"K1 launches {launches} not 16 a decode step")
    n_tok = sum(len(r) for r in tokens)
    med = statistics.median(mig_s)
    return {
        "pair": "LLMServer prefill + LLMServer decode, in process", "quantize": quantize,
        "requests": 8, "prompt_len": 64, "max_tokens": 32, "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall, "ttft_s_median": statistics.median(ttft),
        "ttft_s_max": max(ttft), "colocated": colocated,
        "migration_ms_per_request_median": med * 1e3, "migration_ms_per_request_max":
        max(mig_s) * 1e3, "migration_ms_per_block_median": med * 1e3 / 4,
        "block_bytes": block_bytes, "migration_gb_per_s": 4 * block_bytes / med / 1e9,
        "launches_burst": launches, "launches_by_route": by_route,
        "launches_prefill_half": prefill_half, "launches_decode_half": decode_half,
        "launches": {n: launches[n] + prefill_half[n] + decode_half[n] for n in launches},
    }


# ---------------------------------------------------------------------------
# the host runtime: tasks, objects and a GPU actor (ray_tpu_torch.api)
# ---------------------------------------------------------------------------
RUNTIME_SHAPE = (8192, 16384)  # 128M bf16 elements: 256 MiB
RUNTIME_RTT_REPS = 200
# per-thread cuBLAS workspaces (CUBLAS_WORKSPACE_CONFIG :4096:8 = 32 MiB a
# handle) of the threads that ran kernels may outlive shutdown
RUNTIME_MEMORY_SLACK = 256 << 20
# the runtime phase's figures before the native tier (in-band pickling;
# PERF.md section 5): printed beside this run's
RUNTIME_BEFORE_NATIVE = {"host_copy_to_worker_gb_per_s": [0.26, 0.34],
                         "task_rtt_ms_median": {"in_process": [0.34, 0.61],
                                                "process": [0.63, 1.09]}}


def rt_noop(x):
    """The round-trip task: in process or in a process worker."""
    return x


def rt_device_task(x):
    """Given a CUDA tensor, the runtime runs this in process: it doubles the
    tensor on the card and names the process it ran in."""
    return x * 2, os.getpid()


def rt_host_view(x):
    """Given a CUDA tensor in a process worker: what arrived (a CPU copy),
    its float32 sum, and whether this process touched CUDA."""
    import torch

    return {"type": type(x).__name__, "device": x.device.type,
            "dtype": str(x.dtype).removeprefix("torch."), "shape": list(x.shape),
            "sum_f32": float(x.float().sum()), "pid": os.getpid(),
            "cuda_initialized": torch.cuda.is_initialized(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


def rt_stream_tokens(actor, prompt, max_tokens):
    """A streaming generator task that yields the actor's tokens as its
    engine emits them (the runtime streams tasks, not actor methods, as the
    JAX package does)."""
    import ray_tpu_torch as rt

    sid = rt.get(actor.open_stream.remote(prompt, max_tokens))
    while True:
        tok = rt.get(actor.next_token.remote(sid))
        if tok is None:
            return
        yield tok


rt_stream_tokens._rt_device = True  # in process, beside the actor


class EngineActor:
    """The runtime phase's GPU actor: an ``LLMEngine`` on the card (paged
    cache). The direct run drives an instance of the same class without the
    runtime, so both submit the burst the same way. ``decode_steps`` counts
    the engine loop's decode steps (K1 launches once a layer in each)."""

    def __init__(self, cfg, params, quantize: bool):
        from ray_tpu_torch.serve.llm import LLMEngine

        self.engine = LLMEngine(cfg, params, device="cuda", max_batch_size=8,
                                max_seq_len=cfg.max_seq_len, kv_block_size=16,
                                cache_kind="paged", quantize=quantize)
        # the count lives outside self: the engine's loop thread holds the
        # engine, and through a closure over self it would hold the actor
        # for ever (a killed actor's engine must stop when it is dropped)
        steps = self._steps = [0]
        step = self.engine._step

        def counted_step():
            steps[0] += 1
            step()

        self.engine._step = counted_step
        self._streams = {}

    def warm(self, prompt_len: int) -> bool:
        import torch

        self.engine.generate([5] * prompt_len, max_tokens=2)  # cuBLAS handles, kernel load
        torch.cuda.synchronize()
        return True

    def generate(self, prompts, max_tokens: int):
        futures = [self.engine.submit(p, max_tokens=max_tokens) for p in prompts]
        return [f.result(timeout=600) for f in futures]

    def open_stream(self, prompt, max_tokens: int) -> int:
        sid = len(self._streams)
        self._streams[sid] = iter(self.engine.submit_stream(prompt, max_tokens=max_tokens))
        return sid

    def next_token(self, sid: int):
        return next(self._streams[sid], None)

    def decode_steps(self) -> int:
        return self._steps[0]

    def placement_group_id(self):
        """The placement group this actor was scheduled into (hex), or None."""
        from ray_tpu_torch.util import get_current_placement_group

        pg = get_current_placement_group()
        return None if pg is None else pg.id.hex()

    def ping(self):
        return None

    def close(self) -> bool:
        self.engine.shutdown()
        self._streams.clear()
        return True

    def __del__(self):
        # a killed actor is dropped without close(): stop its engine's loop
        engine = getattr(self, "engine", None)
        if engine is not None:
            engine.shutdown()


def median_rtt_s(call, reps: int = RUNTIME_RTT_REPS) -> float:
    """Median seconds of ``call()`` (a submit and a blocking get), after 20
    warm-up calls."""
    for _ in range(20):
        call()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def worker_processes() -> list:
    """Live (non-zombie) children of this process that run the port's
    worker (``ray_tpu_torch.runtime.worker_main``)."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if (int(stat[1]) == os.getpid() and stat[0] != "Z"
                and b"ray_tpu_torch.runtime.worker_main" in cmd):
            out.append(int(pid))
    return out


def live_cuda_tensors(torch, min_bytes: int = 1 << 20) -> list:
    """What still holds device memory: each live CUDA tensor of at least
    ``min_bytes`` with the types of the objects that refer to it."""
    import gc

    out = []
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.is_cuda:
            nbytes = obj.untyped_storage().nbytes()
            if nbytes >= min_bytes:
                out.append({"shape": list(obj.shape), "bytes": nbytes,
                             "held_by": sorted({type(r).__name__ for r in gc.get_referrers(obj)})})
    return out


@contextlib.contextmanager
def encoded_as():
    """The kinds of the values this process encodes for process workers
    while inside (``ShmRef``: through the native shm arena); of a dict, the
    kinds of its values (a data block's columns)."""
    from ray_tpu_torch.runtime import protocol

    kinds, real = [], protocol.encode_value

    def spy(value, shm_store, id_factory):
        out = real(value, shm_store, id_factory)
        kinds.extend(type(v).__name__ for v in (out.values() if isinstance(out, dict) else [out]))
        return out

    protocol.encode_value = spy
    try:
        yield kinds
    finally:
        protocol.encode_value = real


def native_tier(rt) -> dict:
    """In this tree the runtime runs the port's native tier: the C frame
    codec, the C ids and the shm store (never the pure-Python tiers)."""
    from ray_tpu_torch.core import ids
    from ray_tpu_torch.native import hotpath
    from ray_tpu_torch.native.shm_store import SEGMENT_PREFIX
    from ray_tpu_torch.runtime import protocol

    store = rt.get_cluster().shm_store
    if protocol._native is not hotpath or store is None or ids.ObjectID is not hotpath.ObjectID \
            or ids.ObjectID.__module__ != "ray_tpu_torch.core.ids" \
            or not store.name.startswith(SEGMENT_PREFIX):
        raise AssertionError(f"native tier: codec {protocol._native}, store {store}, "
                             f"ObjectID {ids.ObjectID!r} from {ids.ObjectID.__module__}")
    return {"frame_codec": hotpath._mod.__name__, "ids": ids.ObjectID.__module__,
            "shm_segment": store.name, "shm_capacity": store.capacity}


def runtime_objects(torch, rt, smoke, card: str) -> dict:
    """Device tier, device task, process task and the round trips, on a
    runtime that ``init`` started with the card detected."""
    nbytes = RUNTIME_SHAPE[0] * RUNTIME_SHAPE[1] * 2
    g = torch.Generator(device="cuda").manual_seed(3)
    # small integers in bf16: every float32 sum of them is exact in any order
    t = torch.randint(-8, 9, RUNTIME_SHAPE, generator=g, device="cuda",
                      dtype=torch.int16).to(torch.bfloat16)
    torch.cuda.synchronize()
    store = rt.get_cluster().head_node.store
    used0 = store.stats()["hbm_used"]
    t0 = time.perf_counter()
    ref = rt.put(t)
    put_s = time.perf_counter() - t0
    info = store.entry_info(ref.id())
    if info["tier"] != "device" or store.stats()["hbm_used"] - used0 != nbytes:
        raise AssertionError(f"put of a CUDA tensor: {info}, hbm_used {store.stats()}")
    t0 = time.perf_counter()
    got = rt.get(ref)
    get_s = time.perf_counter() - t0
    if got.data_ptr() != t.data_ptr():
        raise AssertionError("get of a device-tier object returned another storage")
    del got

    driver = os.getpid()
    out, pid = rt.get(rt.remote(smoke.rt_device_task).remote(t))
    out_ref, pid_ref = rt.get(rt.remote(smoke.rt_device_task).remote(ref))
    if pid != driver or pid_ref != driver:
        raise AssertionError(f"a CUDA-tensor task ran in process {pid}/{pid_ref}, not {driver}")
    if out.device != torch.device("cuda", 0) or not torch.equal(out, t * 2) \
            or not torch.equal(out_ref, out):
        raise AssertionError(f"device task: result on {out.device}, or wrong")
    del out, out_ref

    host = rt.remote(smoke.rt_host_view).options(execution="process")
    rt.get(host.remote(torch.ones(4, device="cuda")))  # the worker imports torch
    want_sum = float(t.float().sum())
    copies = []
    for _ in range(3):
        t0 = time.perf_counter()
        with encoded_as() as kinds:
            seen = rt.get(host.remote(t))
        copies.append(time.perf_counter() - t0)
        if kinds != ["ShmRef"]:
            raise AssertionError(f"the 256 MiB tensor went to the worker as {kinds}, "
                                 "not through the shm arena")
        if seen != {"type": "Tensor", "device": "cpu", "dtype": "bfloat16",
                    "shape": list(RUNTIME_SHAPE), "sum_f32": want_sum, "pid": seen["pid"],
                    "cuda_initialized": False, "cuda_visible_devices": ""} \
                or seen["pid"] == driver:
            raise AssertionError(f"process task saw {seen}, want a CPU copy summing "
                                 f"to {want_sum} in another process without CUDA")
    noop_thread = rt.remote(smoke.rt_noop).options(execution="thread")
    noop_proc = rt.remote(smoke.rt_noop).options(execution="process")
    rtt_thread = median_rtt_s(lambda: rt.get(noop_thread.remote(1)))
    rtt_proc = median_rtt_s(lambda: rt.get(noop_proc.remote(1)))
    del t, ref
    return {
        "card": card, "tensor_shape": list(RUNTIME_SHAPE), "tensor_dtype": "bfloat16",
        "tensor_bytes": nbytes, "device_tier": True, "same_storage": True,
        "put_ms": put_s * 1e3, "get_ms": get_s * 1e3,
        "device_task_in_process": True, "process_task_sum_f32": want_sum,
        "process_task_worker_pid": seen["pid"],
        "host_copy_to_worker_s": copies, "host_copy_to_worker_via": "ShmRef",
        "host_copy_to_worker_gb_per_s": nbytes / min(copies) / 1e9,
        "task_rtt_ms_median": {"in_process": rtt_thread * 1e3, "process": rtt_proc * 1e3,
                               "reps": RUNTIME_RTT_REPS},
    }


def runtime_spill(torch, rt) -> dict:
    """Three 256 MiB tensors against a device tier that holds two and a
    half: the third put spills the oldest to the host, bit for bit, and
    frees its device memory."""
    nbytes = RUNTIME_SHAPE[0] * RUNTIME_SHAPE[1] * 2
    _free, total = torch.cuda.mem_get_info()
    rt.init(num_cpus=2, _system_config={"object_store_hbm_fraction": 2.5 * nbytes / total})
    try:
        store = rt.get_cluster().head_node.store
        budget = store.stats()["hbm_budget"]
        if not 2 * nbytes < budget < 3 * nbytes:
            raise AssertionError(f"hbm budget {budget} does not hold 2.5 tensors")
        g = torch.Generator(device="cuda").manual_seed(4)
        hosts, refs = [], []
        for i in range(3):
            x = torch.randn(RUNTIME_SHAPE, generator=g, device="cuda", dtype=torch.bfloat16)
            hosts.append(x.cpu())
            torch.cuda.synchronize()
            before, spills0 = torch.cuda.memory_allocated(), store.stats()["spills"]
            t0 = time.perf_counter()
            refs.append(rt.put(x))
            put_s = time.perf_counter() - t0
            del x
        after = torch.cuda.memory_allocated()
        stats = store.stats()
        tiers = [store.entry_info(r.id())["tier"] for r in refs]
        if stats["spills"] != spills0 + 1 or tiers != ["host", "device", "device"]:
            raise AssertionError(f"spill: {stats}, tiers {tiers}")
        if before - after != nbytes:
            raise AssertionError(f"spill freed {before - after} bytes of device memory, "
                                 f"want {nbytes}")
        back = [rt.get(r) for r in refs]
        if [b.device.type for b in back] != ["cpu", "cuda", "cuda"] or not all(
                torch.equal(b.cpu().view(torch.int16), h.view(torch.int16))
                for b, h in zip(back, hosts)):
            raise AssertionError("spilled values differ from the originals")
        del back, refs
        return {"hbm_budget": budget, "spills": stats["spills"], "tiers_after": tiers,
                "device_bytes_freed": before - after, "spill_put_ms": put_s * 1e3,
                "spill_gb_per_s": nbytes / put_s / 1e9, "bit_for_bit": True}
    finally:
        rt.shutdown()


def runtime_actor_runs(torch, rt, cfg, params, kernels_of: dict, card: str):
    """The GPU actor serves the engine phase's burst, float then int8, and
    one streaming call; each run against an instance of the same class
    driven directly. Yields one report per run."""
    prompts = burst_prompts(cfg, 8, 64)
    for quantize in (False, True):
        names = ["paged_decode_attention"] + (["int8_matmul"] if quantize else [])
        counters = {n: kernels_of[n] for n in names}
        direct = EngineActor(cfg, params, quantize)
        try:
            direct.warm(64)
            steps0 = direct.decode_steps()
            zero_counters(counters)
            t0 = time.perf_counter()
            want = direct.generate(prompts, 32)
            direct_s = time.perf_counter() - t0
            direct_launches, _ = read_counters(counters)
            direct_steps = direct.decode_steps() - steps0
            want_stream = direct.generate(prompts[:1], 32)[0]
        finally:
            direct.close()
        del direct
        torch.cuda.empty_cache()

        actor = rt.remote(EngineActor).options(num_gpus=1).remote(cfg, params, quantize)
        try:
            rt.get(actor.warm.remote(64))
            steps0 = rt.get(actor.decode_steps.remote())
            zero_counters(counters)
            t0 = time.perf_counter()
            got = rt.get(actor.generate.remote(prompts, 32))
            actor_s = time.perf_counter() - t0
            launches, by_route = read_counters(counters)
            steps = rt.get(actor.decode_steps.remote()) - steps0
            stream = rt.remote(rt_stream_tokens).options(num_returns="streaming")
            t0 = time.perf_counter()
            streamed, first_s = [], None
            for r in stream.remote(actor, prompts[0], 32):
                streamed.append(rt.get(r))
                if first_s is None:
                    first_s = time.perf_counter() - t0
            rtt_actor = median_rtt_s(lambda: rt.get(actor.ping.remote()))
            rt.get(actor.close.remote())
        finally:
            rt.kill(actor)
        del actor
        torch.cuda.empty_cache()
        what = f"{'int8 ' if quantize else ''}GPU actor"
        if got != want:
            raise AssertionError(f"{what}: tokens differ from the direct engine's")
        if streamed != want_stream:
            raise AssertionError(f"{what}: streamed {streamed} vs {want_stream}")
        if launches != direct_launches or steps != direct_steps:
            raise AssertionError(f"{what}: launches {launches} over {steps} decode steps, "
                                 f"direct {direct_launches} over {direct_steps}")
        per_step = cfg.n_layers
        if launches["paged_decode_attention"] != per_step * steps or steps < 31:
            raise AssertionError(f"{what}: K1 {launches} over {steps} decode steps, "
                                 f"want {per_step} a step")
        per_forward = k6_per_layer(cfg) * cfg.n_layers
        if quantize and (launches["int8_matmul"] % per_forward
                         or launches["int8_matmul"] < per_forward * steps
                         or by_route["int8_matmul"] != {"mma_bf16": launches["int8_matmul"],
                                                        "simt": 0}):
            raise AssertionError(f"{what}: K6 {launches} {by_route}, want {per_forward} "
                                 "a forward on the tensor cores")
        n_tok = sum(len(r) for r in got)
        yield {
            "part": "gpu_actor", "card": card, "quantize": quantize, "requests": len(prompts),
            "prompt_len": 64, "max_tokens": 32, "tokens_equal_direct": True,
            "decode_steps": steps, "launches": launches, "launches_by_route": by_route,
            "launches_direct": direct_launches,
            "k1_per_decode_step": launches["paged_decode_attention"] / steps,
            **({"k6_forwards": launches["int8_matmul"] // per_forward} if quantize else {}),
            "tokens_per_s_actor": n_tok / actor_s, "tokens_per_s_direct": n_tok / direct_s,
            "actor_wall_s": actor_s, "direct_wall_s": direct_s,
            "stream_tokens": len(streamed), "stream_equals_direct": True,
            "stream_first_token_s": first_s,
            "actor_call_rtt_ms_median": rtt_actor * 1e3,
        }


def run_runtime(torch, cfg, params, kernels_of: dict, card: str):
    """The runtime phase (``ray_tpu_torch.api`` on the card): ``init`` sees
    the GPU; objects, tasks and round trips; the GPU actor's runs; a spill;
    and nothing left after ``shutdown``. Yields one report per part."""
    import gc

    import chip_smoke as smoke  # process-tier functions by module name
    import ray_tpu_torch as rt

    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rt.init(num_cpus=8)
    init_s = time.perf_counter() - t0
    pool = rt.get_cluster().head_node.worker_pool
    try:
        resources = rt.cluster_resources()
        if resources.get("GPU") != 1 or resources.get("TPU"):
            raise AssertionError(f"init on the card: resources {resources}")
        native = native_tier(rt)
        rep = runtime_objects(torch, rt, smoke, card)
        gc.collect()
        yield {"part": "objects", "init_s": init_s, "resources": resources, "native": native,
               **rep, "before_native_tier": RUNTIME_BEFORE_NATIVE,
               "device_bytes_held_after_part": torch.cuda.memory_allocated() - base}
        yield from runtime_actor_runs(torch, rt, cfg, params, kernels_of, card)
        procs = [w.proc for w in list(pool._all.values())]
    finally:
        rt.shutdown()
    del pool
    gc.collect()
    left = [p.pid for p in procs if p.poll() is None] + worker_processes()
    held = torch.cuda.memory_allocated() - base
    if left or held > RUNTIME_MEMORY_SLACK:
        raise AssertionError(f"after shutdown: workers {left} alive, {held} device bytes held "
                             f"by {live_cuda_tensors(torch)}")
    if os.path.exists("/dev/shm" + native["shm_segment"]):
        raise AssertionError(f"after shutdown: shm segment {native['shm_segment']} remains")
    yield {"part": "shutdown", "card": card, "workers_spawned": len(procs),
           "workers_left": 0, "device_bytes_held_after": held,
           "shm_segment_unlinked": native["shm_segment"]}
    yield {"part": "spill", "card": card, **runtime_spill(torch, rt)}
    gc.collect()
    held = torch.cuda.memory_allocated() - base
    left = worker_processes()
    if held > RUNTIME_MEMORY_SLACK or left:
        raise AssertionError(f"after the spill runtime's shutdown: workers {left} alive, "
                             f"{held} device bytes held by {live_cuda_tensors(torch)}")


# ---------------------------------------------------------------------------
# the Serve runtime: serve.run, the HTTP proxy, the router and the dispatcher
# ---------------------------------------------------------------------------
SERVE_TEARDOWN_WAIT_S = 15.0


def http_events(url: str, body: dict):
    """POST ``body`` and yield the server-sent events of the response (the
    proxy's SSE stream), one dict a ``data:`` frame."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.headers["Content-Type"] != "text/event-stream":
            raise AssertionError(f"{url}: {resp.headers['Content-Type']}, not an SSE stream")
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: "):
                yield json.loads(line[6:])


def http_json(url: str, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def cuda_storages(torch, min_bytes: int = 1 << 20) -> set:
    """Device pointers of the live CUDA tensors' storages of at least
    ``min_bytes`` (the serve phase's baseline: the weights it serves)."""
    import gc

    return {obj.untyped_storage().data_ptr() for obj in gc.get_objects()
            if isinstance(obj, torch.Tensor) and obj.is_cuda
            and obj.untyped_storage().nbytes() >= min_bytes}


def served_burst(prompts, ask, counters: dict):
    """``stream_burst`` of the engine phase's burst with ``counters`` zeroed
    just before and read just after."""
    zero_counters(counters)
    tokens, ttft, wall = stream_burst(prompts, 32, ask)
    launches, by_route = read_counters(counters)
    n_tok = sum(len(r) for r in tokens)
    return tokens, launches, by_route, {
        "tokens_per_s": n_tok / wall, "wall_s": wall,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft)}


def serve_replicas(torch, rt, serve, cfg, params, kernels_of: dict, actor_tps: dict,
                   engine_nums: dict):
    """(a) ``serve.run`` of ``LLMServer`` with ``num_gpus=1`` (no device: the
    replica's engine takes the card), float then int8: the burst over HTTP
    through the proxy (8 SSE clients) and through a ``DeploymentHandle``,
    against an ``LLMServer`` instance driven directly by the same 8 streaming
    clients. Tokens and K1/K6 launches equal the direct run's."""
    from ray_tpu_torch.observability import reqtrace
    from ray_tpu_torch.serve.llm import LLMServer

    prompts = burst_prompts(cfg, 8, 64)
    url = serve.proxy_url() + "/llm"
    kw = dict(max_batch_size=8, max_seq_len=cfg.max_seq_len, kv_block_size=16,
              cache_kind="paged")
    for quantize in (False, True):
        names = ["paged_decode_attention"] + (["int8_matmul"] if quantize else [])
        counters = {n: kernels_of[n] for n in names}
        direct = LLMServer(lambda: (cfg, params), device="cuda", quantize=quantize, **kw)
        try:
            direct({"prompt": [5] * 64, "max_tokens": 2})  # the loop's cuBLAS handle
            torch.cuda.synchronize()
            want, direct_launches, _, direct_nums = served_burst(
                prompts, lambda i: direct({"prompt": prompts[i], "max_tokens": 32,
                                           "stream": True}), counters)
        finally:
            direct.engine.shutdown()
        del direct
        torch.cuda.empty_cache()

        name = "llm_int8" if quantize else "llm_float"
        app = serve.deployment(LLMServer, name=name, ray_actor_options={"num_gpus": 1}).bind(
            lambda: (cfg, params), quantize=quantize, **kw)
        t0 = time.perf_counter()
        handle = serve.run(app, name=name, route_prefix="/llm")
        handle.remote({"prompt": [5] * 64, "max_tokens": 2}).result(timeout=600)
        deploy_s = time.perf_counter() - t0
        if rt.available_resources().get("GPU", 0) != 0:
            raise AssertionError(f"{name}: the replica holds no GPU: {rt.available_resources()}")
        store = reqtrace.global_trace_store()
        store.reset()
        runs = {}
        for via, ask in (
                ("http", lambda i: http_events(url, {"prompt": prompts[i], "max_tokens": 32,
                                                     "stream": True})),
                ("handle", lambda i: handle.remote({"prompt": prompts[i], "max_tokens": 32,
                                                    "stream": True}).result(timeout=600))):
            tokens, launches, by_route, nums = served_burst(prompts, ask, counters)
            if via == "http":
                nums["trace_phase_ms_median"] = trace_phases(store, len(prompts), 32)
            what = f"{name} over {via}"
            if tokens != want:
                raise AssertionError(f"{what}: tokens differ from the direct server's")
            if launches != direct_launches:
                raise AssertionError(f"{what}: launches {launches}, direct {direct_launches}")
            steps, rem = divmod(launches["paged_decode_attention"], cfg.n_layers)
            if rem or steps < 31:
                raise AssertionError(f"{what}: K1 {launches}, not {cfg.n_layers} a decode step")
            per_forward = k6_per_layer(cfg) * cfg.n_layers
            if quantize and (launches["int8_matmul"] % per_forward
                             or launches["int8_matmul"] < per_forward * steps
                             or by_route["int8_matmul"] != {"mma_bf16": launches["int8_matmul"],
                                                            "simt": 0}):
                raise AssertionError(f"{what}: K6 {launches} {by_route}")
            runs[via] = {**nums, "decode_steps": steps, "launches": launches,
                         "launches_by_route": by_route}
        serve.delete(name)
        torch.cuda.empty_cache()
        yield {
            "_tokens": want,
            "part": "a_gpu_replica", "deployment": name, "quantize": quantize,
            "ray_actor_options": {"num_gpus": 1}, "requests": 8, "prompt_len": 64,
            "max_tokens": 32, "deploy_s": deploy_s, "tokens_equal_direct": True,
            "launches_equal_direct": True, "launches_direct": direct_launches,
            "direct": direct_nums, "http": runs["http"], "handle": runs["handle"],
            "tokens_per_s_gpu_actor": actor_tps.get(quantize),
            "engine_phase": engine_nums.get(quantize),
            "launches": {n: runs["http"]["launches"][n] + runs["handle"]["launches"][n]
                         for n in names},
            "launches_by_route": {n: {r: runs["http"]["launches_by_route"][n][r]
                                      + runs["handle"]["launches_by_route"][n][r]
                                      for r in runs["http"]["launches_by_route"][n]}
                                  for n in runs["http"]["launches_by_route"]},
        }


def serve_openai(torch, serve, cfg, params) -> dict:
    """(b) ``OpenAICompatLLMServer`` behind the proxy: a completion and a
    streamed chat over HTTP give the direct server's envelopes (ids and
    timestamps aside)."""
    from ray_tpu_torch.serve.llm import OpenAICompatLLMServer

    tok = ToyTokenizer()
    comp_body = {"model": "llm_bench", "prompt": "once upon a time", "max_tokens": 16,
                 "temperature": 0}
    chat_body = {"model": "llm_bench", "messages": [{"role": "user", "content": "tell me a story"}],
                 "max_tokens": 16, "temperature": 0, "stream": True}
    kw = dict(max_batch_size=8, max_seq_len=cfg.max_seq_len)
    direct = OpenAICompatLLMServer(lambda: (cfg, params, tok), device="cuda", **kw)
    try:
        want_comp = direct(comp_body)
        want_chunks = list(direct(chat_body))
    finally:
        direct.engine.shutdown()
    del direct
    app = serve.deployment(OpenAICompatLLMServer, name="llm_openai",
                           ray_actor_options={"num_gpus": 1}).bind(
        lambda: (cfg, params, tok), **kw)
    serve.run(app, name="llm_openai", route_prefix="/v1")
    base = serve.proxy_url()
    comp = http_json(base + "/v1/completions", comp_body)
    chunks = list(http_events(base + "/v1/chat/completions", chat_body))
    serve.delete("llm_openai")
    torch.cuda.empty_cache()

    def strip(d):
        return {k: v for k, v in d.items() if k not in ("id", "created")}

    if strip(comp) != strip(want_comp) or not comp["id"].startswith("cmpl-"):
        raise AssertionError(f"completion over HTTP {comp} vs direct {want_comp}")
    if [strip(c) for c in chunks] != [strip(c) for c in want_chunks] \
            or len({c["id"] for c in chunks}) != 1:
        raise AssertionError(f"streamed chat over HTTP {chunks} vs direct {want_chunks}")
    return {"part": "b_openai_http", "completion_text": comp["choices"][0]["text"],
            "completion_usage": comp["usage"], "chat_chunks": len(chunks),
            "chat_finish_reason": chunks[-1]["choices"][0]["finish_reason"],
            "equal_to_direct": True}


def serve_split(torch, rt, serve, cfg, params, kernels_of: dict, colocated: list,
                colocated_nums: dict):
    """(c) ``roles={"prefill": 1, "decode": 1}``, bf16, each replica half the
    card, through ``DisaggDispatcher``: the burst's tokens equal co-located
    serving; the halves alone show K1 only on the decode replica; the
    dispatcher's migration counters and the cluster's audit match the
    request count. Then a decode-replica kill mid-burst
    (``chaos_kill_replica``): each request finishes through the re-prefill
    ladder or fails with ``KVMigrationError``, as the audit records."""
    from ray_tpu_torch.serve import api as serve_api
    from ray_tpu_torch.serve.disagg import KVMigrationError
    from ray_tpu_torch.serve.llm import LLMServer

    k1 = {"paged_decode_attention": kernels_of["paged_decode_attention"]}
    prompts = burst_prompts(cfg, 8, 64)
    name = "llm_split"
    app = serve.deployment(LLMServer, name=name, roles={"prefill": 1, "decode": 1},
                           ray_actor_options={"num_gpus": 0.5}).bind(
        lambda: (cfg, params), max_batch_size=8, max_seq_len=cfg.max_seq_len, kv_block_size=16)
    handle = serve.run(app, name=name, route_prefix=None)
    handle.remote({"prompt": [5] * 64, "max_tokens": 2}).result(timeout=600)
    router = handle._router
    cluster = rt.get_cluster()
    audits0 = len(cluster.kv_migration_audits)
    snap0 = router.disagg_snapshot() or {"dispatched": {"prefill": 0, "decode": 0},
                                         "migrations": {}}
    tokens, launches, _, nums = served_burst(
        prompts, lambda i: handle.remote({"prompt": prompts[i], "max_tokens": 32,
                                          "stream": True}).result(timeout=600), k1)
    if tokens != colocated:
        raise AssertionError("split deployment: tokens differ from co-located serving")
    snap = router.disagg_snapshot()
    audits = list(cluster.kv_migration_audits)[audits0:]
    staged = [a for a in audits if a["event"] == "staged"]
    released = [a for a in audits if a["event"] == "released"]
    dispatched = {r: snap["dispatched"][r] - snap0["dispatched"].get(r, 0) for r in snap["dispatched"]}
    migrated = {o: snap["migrations"][o] - snap0["migrations"].get(o, 0) for o in snap["migrations"]}
    if (len(staged) != 8 or sorted(a["mig_id"] for a in staged)
            != sorted(a["mig_id"] for a in released)
            or any(a["outcome"] != "adopted" for a in released)
            or dispatched != {"prefill": 8, "decode": 8}
            or migrated != {"device": 0, "host": 8, "reprefill": 0, "failed": 0}):
        raise AssertionError(f"split burst: dispatched {dispatched}, migrations {migrated}, "
                             f"audit {audits}")
    steps, rem = divmod(launches["paged_decode_attention"], cfg.n_layers)
    # the halves alone, through the dispatcher's own primitives
    p = router.pick_role_replica(name, "prefill")
    d = router.pick_role_replica(name, "decode")
    zero_counters(k1)
    ticket = router.call_replica(name, p, "disagg_prefill", ({"prompt": prompts[1][::-1]}, "c/half"))
    prefill_half = read_counters(k1)[0]
    zero_counters(k1)
    router.call_replica(name, d, "disagg_decode",
                        ({"prompt": prompts[1][::-1], "max_tokens": 32}, ticket))
    decode_half = read_counters(k1)[0]
    router.call_replica(name, p, "disagg_release", ("c/half",))
    if rem or prefill_half["paged_decode_attention"] != 0 \
            or decode_half["paged_decode_attention"] != cfg.n_layers * 31:
        raise AssertionError(f"K1 in the burst {launches}, prefill half {prefill_half}, "
                             f"decode half {decode_half}")
    yield {"part": "c_split_bf16", "deployment": name, "roles": {"prefill": 1, "decode": 1},
           "ray_actor_options": {"num_gpus": 0.5}, "requests": 8, "prompt_len": 64,
           "max_tokens": 32, "tokens_equal_colocated": True, **nums,
           "colocated": colocated_nums, "decode_steps": steps,
           "dispatched": dispatched, "migrations": migrated, "audit_staged": len(staged),
           "audit_released_adopted": len(released),
           "launches_prefill_half": prefill_half, "launches_decode_half": decode_half,
           "launches": {"paged_decode_attention": launches["paged_decode_attention"]
                        + decode_half["paged_decode_attention"]}}

    # the chaos hook of the reference's kill_decode_replica kind, mid-burst
    ctl = next(iter(cluster.serve_controllers.values()))
    audits0 = len(cluster.kv_migration_audits)
    snap0 = router.disagg_snapshot()
    results = [None] * 8

    def client(i):
        try:
            results[i] = handle.remote({"prompt": prompts[i], "max_tokens": 32}).result(
                timeout=600)["tokens"]
        except KVMigrationError as exc:
            results[i] = exc

    zero_counters(k1)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 120
    while (router.disagg_snapshot()["dispatched"]["decode"] - snap0["dispatched"]["decode"] < 2
           and time.monotonic() < deadline):
        time.sleep(0.005)
    killed = ctl.chaos_kill_replica(name, role="decode", index=0)
    for t in threads:
        t.join(timeout=600)
    if not killed or any(r is None for r in results):
        raise AssertionError(f"chaos: killed {killed}, results {results}")
    t0 = time.perf_counter()
    while ctl.pool_status()[name]["decode"]["replicas"] != 1 and time.perf_counter() - t0 < 120:
        time.sleep(0.05)
    heal_s = time.perf_counter() - t0
    router._refresh(force=True)
    after = handle.remote({"prompt": prompts[0], "max_tokens": 32}).result(timeout=600)["tokens"]
    launches = read_counters(k1)[0]
    audits = list(cluster.kv_migration_audits)[audits0:]
    outcomes = {}
    for a in audits:
        if a["event"] == "released":
            outcomes[a["outcome"]] = outcomes.get(a["outcome"], 0) + 1
    ok = [i for i, r in enumerate(results) if not isinstance(r, BaseException)]
    failed = [i for i, r in enumerate(results) if isinstance(r, BaseException)]
    snap = router.disagg_snapshot()
    migrated = {o: snap["migrations"][o] - snap0["migrations"][o] for o in snap["migrations"]}
    if any(results[i] != colocated[i] for i in ok) or after != colocated[0]:
        raise AssertionError("chaos: a finished request's tokens differ from co-located serving")
    # every request ends in exactly one terminal: adopted (first try or
    # after a re-prefill) or failed (the ladder exhausted, typed)
    if (outcomes.get("adopted", 0) != len(ok) + 1 or outcomes.get("failed", 0) != len(failed)
            or outcomes.get("reprefill", 0) != migrated["reprefill"]
            or migrated["failed"] != len(failed)):
        raise AssertionError(f"chaos: {len(ok)} finished, {len(failed)} failed, audit "
                             f"terminals {outcomes}, migrations {migrated}")
    yield {"part": "c_split_decode_kill", "deployment": name, "killed": True,
           "requests": 8, "finished": len(ok), "failed_typed": len(failed),
           "failed_errors": sorted({type(results[i]).__name__ for i in failed}),
           "audit_terminals": outcomes, "migrations": migrated, "heal_s": heal_s,
           "after_heal_equals_colocated": True, "launches": launches}
    serve.delete(name)


def run_serve(torch, cfg, params, kernels_of: dict, card: str, actor_tps: dict,
              engine_nums: dict):
    """The serve phase: (a) GPU replicas, float and int8, over HTTP and a
    handle; (b) the OpenAI server behind the proxy; (c) the split pair and
    its decode-replica kill; (d) after ``serve.shutdown()`` and the
    runtime's ``shutdown()``: no new CUDA tensor of 1 MiB or more, no
    ``serve-*`` thread, no worker process."""
    import gc

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    baseline = cuda_storages(torch)
    threads0 = set(threading.enumerate())
    rt.init(num_cpus=8)
    pool = rt.get_cluster().head_node.worker_pool
    colocated = None
    try:
        serve.start(http_port=0)
        for rep in serve_replicas(torch, rt, serve, cfg, params, kernels_of, actor_tps,
                                  engine_nums):
            tokens = rep.pop("_tokens")
            if not rep["quantize"]:  # what the split pair is held to
                colocated = (tokens, {k: rep["handle"][k] for k in (
                    "tokens_per_s", "ttft_s_median", "ttft_s_max")})
            yield {"card": card, **rep}
        yield {"card": card, **serve_openai(torch, serve, cfg, params)}
        for rep in serve_split(torch, rt, serve, cfg, params, kernels_of, *colocated):
            yield {"card": card, **rep}
        procs = [w.proc for w in list(pool._all.values())]
    finally:
        serve.shutdown()
        rt.shutdown()
    del pool
    t0 = time.perf_counter()
    while True:
        gc.collect()
        new = cuda_storages(torch) - baseline
        threads = sorted(t.name for t in threading.enumerate()
                         if t.name.startswith("serve-") and t not in threads0)
        left = [p.pid for p in procs if p.poll() is None] + worker_processes()
        if not (new or threads or left) or time.perf_counter() - t0 > SERVE_TEARDOWN_WAIT_S:
            break
        time.sleep(0.1)
    if new or threads or left:
        raise AssertionError(f"after shutdown: {len(new)} CUDA tensors of >= 1 MiB "
                             f"({live_cuda_tensors(torch)}), serve threads {threads}, "
                             f"workers {left}")
    yield {"card": card, "part": "d_teardown", "new_cuda_tensors_1mib": 0, "serve_threads": [],
           "workers_left": 0, "teardown_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the utilities and the chaos fabric: ActorPool, Queue and placement groups
# of GPU actors; seeded schedules against the split pair, device-tier
# objects and a GPU actor on a killed node
# ---------------------------------------------------------------------------
CHAOS_QUEUE_ITEMS = 16
CHAOS_QUEUE_BYTES = 4 << 20
CHAOS_FANOUT = 32
CHAOS_FANOUT_BYTES = 4 << 20
CHAOS_MEMORY_SLACK = 1 << 20
# tests/test_disagg.py: the decode-replica kill's prompt and seed
CHAOS_PROMPT = [5, 3, 7, 1, 9, 2, 8, 4, 6, 1, 2, 3, 4, 5, 6, 7, 8, 9]
CHAOS_DISAGG_SEED = 41
CHAOS_LOSE_SEED = 23
CHAOS_NODE_KILL_SEED = 29
CHAOS_KILL_AT_S = 8.0  # the node kill, after the actor's first burst


def tensor_digest(t) -> str:
    """sha256 of a tensor's bytes: bitwise identity, whatever the dtype."""
    import torch

    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def chaos_draw(i: int, n: int):
    """(d)'s GPU task: ``n`` normal floats on the card from a generator
    seeded by ``i`` (a rebuild by lineage draws the same bits)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(i)
    return torch.randn(n, generator=g, device="cuda")


class QueueProducer:
    """(b)'s producer GPU actor: draws CUDA tensors and puts them into a
    ``util.Queue``."""

    def produce(self, queue, n: int, nbytes: int, seed: int) -> list:
        import torch

        out = []
        for i in range(n):
            g = torch.Generator(device="cuda").manual_seed(seed + i)
            t = torch.randint(-(1 << 31), (1 << 31) - 1, (nbytes // 4,), generator=g,
                              device="cuda", dtype=torch.int32)
            digest = tensor_digest(t)
            t0 = time.perf_counter()
            queue.put(t)
            out.append({"digest": digest, "ptr": t.data_ptr(),
                        "put_s": time.perf_counter() - t0})
        return out


class QueueConsumer:
    """(b)'s consumer GPU actor: gets them back and says what arrived."""

    def consume(self, queue, n: int) -> list:
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            t = queue.get(timeout=120)
            get_s = time.perf_counter() - t0
            out.append({"type": type(t).__name__, "device": str(t.device),
                        "digest": tensor_digest(t), "ptr": t.data_ptr(), "get_s": get_s})
        return out


@contextlib.contextmanager
def decode_steps_by_role():
    """Count each paged engine's decode steps by its ``role`` while inside
    (``"prefill"``, ``"decode"``, ``""`` co-located): each step launches K1
    once a layer, so this says which replicas the K1 launches came from."""
    from ray_tpu_torch.serve.llm import LLMEngine

    counts, lock = {}, threading.Lock()
    real = LLMEngine._decode_k_paged

    def counted(self, *args):
        with lock:
            counts[self.role] = counts.get(self.role, 0) + self.decode_chunk
        return real(self, *args)

    LLMEngine._decode_k_paged = counted
    try:
        yield counts
    finally:
        LLMEngine._decode_k_paged = real


def chaos_pool(torch, rt, util, cfg, params, kernels_of: dict) -> dict:
    """(a) + (c): a STRICT_PACK placement group of two ``{"GPU": 0.5, "CPU":
    1}`` bundles, an engine actor in each through
    ``PlacementGroupSchedulingStrategy``, and an ``ActorPool`` of the two
    mapping the burst's prompts one request an item (``map``, then
    ``map_unordered``); tokens against one engine serving the prompts one
    at a time; removing the group frees both bundles."""
    prompts = burst_prompts(cfg, 8, 64)
    k1 = {"paged_decode_attention": kernels_of["paged_decode_attention"]}
    direct = EngineActor(cfg, params, False)
    try:
        direct.warm(64)
        t0 = time.perf_counter()
        want = [direct.generate([p], 32)[0] for p in prompts]
        direct_s = time.perf_counter() - t0
    finally:
        direct.close()
    del direct
    torch.cuda.empty_cache()

    free0 = rt.available_resources()
    pg = util.placement_group([{"GPU": 0.5, "CPU": 1}] * 2, strategy="STRICT_PACK",
                              name="chaos_pool")
    if not pg.wait(60):
        raise AssertionError(f"(c) placement group not placed: {util.placement_group_table(pg)}")
    held = rt.available_resources()
    actors = [rt.remote(EngineActor).options(
        num_gpus=0.5, num_cpus=1, scheduling_strategy=util.PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=i)).remote(cfg, params, False) for i in range(2)]
    try:
        rt.get([a.warm.remote(64) for a in actors])
        in_pg = rt.get([a.placement_group_id.remote() for a in actors])
        steps0 = rt.get([a.decode_steps.remote() for a in actors])
        pool = util.ActorPool(actors)
        zero_counters(k1)
        t0 = time.perf_counter()
        got = [r[0] for r in pool.map(lambda a, p: a.generate.remote([p], 32), prompts)]
        map_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        unordered = [r[0] for r in pool.map_unordered(lambda a, p: a.generate.remote([p], 32),
                                                      prompts)]
        unordered_s = time.perf_counter() - t0
        launches = read_counters(k1)[0]
        steps = [s - s0 for s, s0 in zip(rt.get([a.decode_steps.remote() for a in actors]), steps0)]
        rt.get([a.close.remote() for a in actors])
    finally:
        for a in actors:
            rt.kill(a)
    del actors
    table = util.placement_group_table(pg)
    util.remove_placement_group(pg)
    t0 = time.perf_counter()
    while rt.available_resources() != free0 and time.perf_counter() - t0 < 30:
        time.sleep(0.05)
    freed = rt.available_resources()
    torch.cuda.empty_cache()
    if got != want:
        raise AssertionError("(a) ActorPool.map: tokens differ from one engine's, one at a time")
    if sorted(unordered) != sorted(want):
        raise AssertionError("(a) ActorPool.map_unordered: not the same set of answers")
    if launches["paged_decode_attention"] != cfg.n_layers * sum(steps) or min(steps) <= 0:
        raise AssertionError(f"(a) K1 {launches} over {steps} decode steps of the two actors")
    if in_pg != [pg.id.hex()] * 2 or held.get("GPU", 0) != 0 or table["strategy"] != "STRICT_PACK" \
            or len(table["bundle_placements"]) != 2:
        raise AssertionError(f"(c) actors in {in_pg}, not {pg.id.hex()}; available while "
                             f"held {held}; table {table}")
    if freed != free0 or util.placement_group_table(pg)["state"] != "REMOVED":
        raise AssertionError(f"(c) after remove_placement_group: {freed}, before {free0}")
    n_tok = sum(len(r) for r in got)
    return {
        "a_actor_pool": {
            "actors": 2, "num_gpus_each": 0.5, "requests": len(prompts), "prompt_len": 64,
            "max_tokens": 32, "tokens_equal_one_at_a_time": True,
            "map_unordered_same_set": True, "tokens_per_s_map": n_tok / map_s,
            "tokens_per_s_map_unordered": n_tok / unordered_s,
            "tokens_per_s_one_engine_one_at_a_time": n_tok / direct_s, "map_wall_s": map_s,
            "map_unordered_wall_s": unordered_s, "decode_steps_by_actor": steps,
            "k1_launches": launches["paged_decode_attention"],
            "k1_launches_by_actor": [cfg.n_layers * s for s in steps]},
        "c_placement_group": {
            "bundles": [{"GPU": 0.5, "CPU": 1}] * 2, "strategy": "STRICT_PACK",
            "actors_in_group": True, "gpu_available_while_held": held.get("GPU", 0),
            "freed_on_remove": True},
        "launches": launches,
    }


def chaos_queue(torch, rt, util) -> dict:
    """(b) a producer GPU actor puts 16 CUDA tensors of 4 MiB into a
    ``util.Queue``; a consumer GPU actor gets them, concurrently."""
    q = util.Queue()
    producer = rt.remote(QueueProducer).options(num_gpus=0.5).remote()
    consumer = rt.remote(QueueConsumer).options(num_gpus=0.5).remote()
    try:
        t0 = time.perf_counter()
        got_ref = consumer.consume.remote(q, CHAOS_QUEUE_ITEMS)
        put = rt.get(producer.produce.remote(q, CHAOS_QUEUE_ITEMS, CHAOS_QUEUE_BYTES, 0),
                     timeout=300)
        got = rt.get(got_ref, timeout=300)
        wall = time.perf_counter() - t0
        left = q.qsize()
    finally:
        q.shutdown()
        rt.kill(producer)
        rt.kill(consumer)
    bad = [i for i, (p, g) in enumerate(zip(put, got))
           if g["type"] != "Tensor" or not g["device"].startswith("cuda")
           or g["digest"] != p["digest"]]
    if bad or len(got) != CHAOS_QUEUE_ITEMS or left:
        raise AssertionError(f"(b) items {bad} arrived off the card or changed: "
                             f"{[got[i] for i in bad]}; {left} left in the queue")
    return {"b_queue": {
        "items": CHAOS_QUEUE_ITEMS, "bytes_each": CHAOS_QUEUE_BYTES, "all_cuda": True,
        "bitwise_equal": True,
        "same_storage": sum(p["ptr"] == g["ptr"] for p, g in zip(put, got)),
        "ms_per_put_get_pair": wall * 1e3 / CHAOS_QUEUE_ITEMS,
        "put_ms_median": statistics.median(p["put_s"] for p in put) * 1e3,
        "get_ms_median": statistics.median(g["get_s"] for g in got) * 1e3,
        "wall_s": wall}}


def run_schedule_twice(rt, name: str, seed: int, events: list, make_workload,
                       check) -> dict:
    """One seeded schedule through ``ChaosRunner`` twice, each on a fresh
    ``init(num_cpus=8)``: both runs ``ok``, fault logs byte-identical;
    ``check(result, seen)`` holds the run's own contract and returns its
    numbers."""
    from ray_tpu_torch.chaos import ChaosEvent, ChaosRunner, ChaosSchedule
    from ray_tpu_torch.runtime import failpoints

    runs = []
    for _ in range(2):
        failpoints.reset()
        rt.init(num_cpus=8)
        try:
            schedule = ChaosSchedule([ChaosEvent(t, kind, **p) for t, kind, p in events],
                                     seed=seed, name=name)
            seen = {}
            t0 = time.perf_counter()
            result = ChaosRunner(schedule, quiesce_timeout=300).run(make_workload(seen))
            wall = time.perf_counter() - t0
            if not result.ok:
                raise AssertionError(f"{name}: {result.workload_error!r}, invariants "
                                     f"{result.invariants.violations}")
            nums = check(result, seen)
        finally:
            rt.shutdown()
        log = json.dumps(result.faults, sort_keys=True).encode()
        runs.append({"wall_s": wall, "digest": hashlib.sha256(log).hexdigest(), "faults": len(result.faults),
                     "events_applied": result.events_applied,
                     "invariants_checked": result.invariants.checked, **nums})
    if runs[0]["digest"] != runs[1]["digest"]:
        raise AssertionError(f"{name}: same seed, fault logs differ: {runs}")
    return {"seed": seed, "runs": runs,
            "fault_log_digests": [r["digest"] for r in runs]}


def chaos_disagg(torch, rt, serve, cfg, params, kernels_of: dict) -> dict:
    """``disagg-decode-kill`` (tests/test_disagg.py:376-450, seed 41) on GPU
    replicas of the serving decoder in bf16: ``roles={"prefill": 1,
    "decode": 2}``, 0.3 of the card each; ``kill_decode_replica`` at t=0.8,
    then ``disagg.decode_call=raise(0.4)`` over 5 sequential requests.
    Co-located tokens are computed before the runs."""
    from ray_tpu_torch.runtime import failpoints
    from ray_tpu_torch.serve.disagg import KVMigrationError
    from ray_tpu_torch.serve.llm import LLMServer

    kw = dict(max_batch_size=4, max_seq_len=64)
    prompts = [CHAOS_PROMPT] + [CHAOS_PROMPT + [i + 1] for i in range(5)]
    direct = LLMServer(lambda: (cfg, params), device="cuda", **kw)
    try:
        want = {tuple(p): direct({"prompt": p, "max_tokens": 4 if i == 0 else 3})["tokens"]
                for i, p in enumerate(prompts)}
    finally:
        direct.engine.shutdown()
    del direct
    torch.cuda.empty_cache()
    k1 = {"paged_decode_attention": kernels_of["paged_decode_attention"]}

    def make_workload(seen):
        def workload():
            t_start = time.perf_counter()
            serve.start(http_port=0)
            app = serve.deployment(LLMServer, roles={"prefill": 1, "decode": 2},
                                   ray_actor_options={"num_gpus": 0.3}).bind(
                lambda: (cfg, params), **kw)
            handle = serve.run(app, route_prefix=None)
            ctls = list(rt.get_cluster().serve_controllers.values())
            deadline = time.perf_counter() + 60
            while (ctls[0].pool_status().get("LLMServer", {}).get("decode", {})
                   .get("replicas", 0) < 2 and time.perf_counter() < deadline):
                time.sleep(0.02)
            seen["deployed_s"] = time.perf_counter() - t_start
            handle._router._refresh(force=True)
            try:  # races the scheduled kill
                r = handle.remote({"prompt": CHAOS_PROMPT, "max_tokens": 4}).result(timeout=120)
                seen["phase1"] = "equal" if r["tokens"] == want[tuple(CHAOS_PROMPT)] else r
            except KVMigrationError:
                seen["phase1"] = "KVMigrationError"
            time.sleep(max(0.0, 2.0 - (time.perf_counter() - t_start)))
            handle._router._refresh(force=True)
            failpoints.arm("disagg.decode_call=raise(0.4)")
            seen["phase2"] = []
            for p in prompts[1:]:
                try:
                    r = handle.remote({"prompt": p, "max_tokens": 3}).result(timeout=120)
                    seen["phase2"].append("equal" if r["tokens"] == want[tuple(p)] else r)
                except KVMigrationError:
                    seen["phase2"].append("KVMigrationError")
            serve.shutdown()
            return seen["phase2"].count("KVMigrationError")
        return workload

    def check(result, seen):
        kills = [e for e in result.events_applied if e["kind"] == "kill_decode_replica"]
        if len(kills) != 1 or "skipped" in kills[0]:
            raise AssertionError(f"disagg-decode-kill: the kill was {kills}")
        if seen["phase1"] not in ("equal", "KVMigrationError") or any(
                x not in ("equal", "KVMigrationError") for x in seen["phase2"]):
            raise AssertionError(f"disagg-decode-kill: tokens differ from co-located: {seen}")
        if result.invariants.checked["kv_migrations"] < 5:
            raise AssertionError(f"disagg-decode-kill: invariant 13 swept "
                                 f"{result.invariants.checked}")
        return {"phase1": seen["phase1"], "phase2": seen["phase2"],
                "deployed_s": seen["deployed_s"]}

    with decode_steps_by_role() as by_role:
        zero_counters(k1)
        out = run_schedule_twice(
            rt, "disagg-decode-kill", CHAOS_DISAGG_SEED,
            [(0.8, "kill_decode_replica", {"deployment": "LLMServer", "role": "decode",
                                            "index": 0})],
            make_workload, check)
        launches = read_counters(k1)[0]
        steps = dict(by_role)
    if (steps.get("prefill", 0) != 0 or steps.get("decode", 0) <= 0 or set(steps) - {"prefill", "decode"}
            or launches["paged_decode_attention"] != cfg.n_layers * steps["decode"]):
        raise AssertionError(f"disagg-decode-kill: K1 {launches}, decode steps by role {steps}")
    return {**out, "replicas": {"prefill": 1, "decode": 2}, "num_gpus_each": 0.3,
            "decode_steps_by_role": {"prefill": 0, **steps},
            "k1_launches_decode_replicas": launches["paged_decode_attention"],
            "k1_launches_prefill_replica": 0, "launches": launches}


def chaos_lose_objects(torch, rt) -> dict:
    """``lose-device-objects``: 32 GPU tasks (``num_gpus=0.1``,
    ``max_retries=2``) each return 4 MiB drawn on the card; at t=1.0
    ``lose_objects`` drops half of them, lineage rebuilds them on the card
    bitwise; invariants 1-5 hold; the device memory is back at its baseline
    after the refs are dropped."""
    import gc

    n = CHAOS_FANOUT_BYTES // 4

    def make_workload(seen):
        def workload():
            t0 = time.perf_counter()
            seen["base"] = torch.cuda.memory_allocated()
            f = rt.remote(chaos_draw).options(num_gpus=0.1, max_retries=2, execution="thread")
            refs = [f.remote(i, n) for i in range(CHAOS_FANOUT)]
            first = rt.get(refs, timeout=300)
            seen["devices"] = sorted({str(t.device) for t in first})
            seen["first"] = [tensor_digest(t) for t in first]
            del first
            time.sleep(max(0.0, 1.5 - (time.perf_counter() - t0)))  # past the loss
            again = rt.get(refs, timeout=300)
            seen["again_devices"] = sorted({str(t.device) for t in again})
            seen["again"] = [tensor_digest(t) for t in again]
            del again
            return refs
        return workload

    def check(result, seen):
        lose = next(e for e in result.events_applied if e["kind"] == "lose_objects")
        gc.collect()
        t0 = time.perf_counter()
        while (torch.cuda.memory_allocated() - seen["base"] > CHAOS_MEMORY_SLACK
               and time.perf_counter() - t0 < 15):
            time.sleep(0.05)
            gc.collect()
        held = torch.cuda.memory_allocated() - seen["base"]
        want = [tensor_digest(chaos_draw(i, n)) for i in range(CHAOS_FANOUT)]
        if lose["lost"] <= 0 or seen["first"] != want or seen["again"] != want \
                or seen["devices"] != ["cuda:0"] or seen["again_devices"] != ["cuda:0"]:
            raise AssertionError(f"lose-device-objects: lost {lose}, rebuilt bitwise "
                                 f"{seen['again'] == want}, devices {seen['devices']} "
                                 f"{seen['again_devices']}")
        if held > CHAOS_MEMORY_SLACK:
            raise AssertionError(f"lose-device-objects: {held} device bytes held after the refs "
                                 f"were dropped: {live_cuda_tensors(torch)}")
        return {"lost": lose["lost"], "of": lose["of"], "rebuilt_bitwise": True,
                "device_bytes_held_after": held}

    return run_schedule_twice(rt, "lose-device-objects", CHAOS_LOSE_SEED,
                              [(1.0, "lose_objects", {"fraction": 0.5})], make_workload, check)


def chaos_node_kill(torch, rt, cfg, params, kernels_of: dict) -> dict:
    """``gpu-actor-node-kill``: ``add_node({"CPU": 2, "GPU": 1})``, an int8
    engine actor there (``max_restarts=1``), then ``kill_node`` of that
    node and a replacement ``add_node``: the actor restarts, reloads its
    weights, and its greedy tokens equal the direct int8 engine's;
    invariant 7 holds."""
    from ray_tpu_torch.exceptions import RayActorError
    from ray_tpu_torch.runtime.scheduler import NodeAffinitySchedulingStrategy

    prompts = burst_prompts(cfg, 2, 64)
    direct = EngineActor(cfg, params, True)
    try:
        want = direct.generate(prompts, 32)
    finally:
        direct.close()
    del direct
    torch.cuda.empty_cache()
    names = ("paged_decode_attention", "int8_matmul")
    counters = {n: kernels_of[n] for n in names}

    def make_workload(seen):
        def workload():
            cluster = rt.get_cluster()
            node = next(n for n in cluster.nodes.values()
                        if not n.dead and n is not cluster.head_node)
            actor = rt.remote(EngineActor).options(
                num_gpus=0.5, max_restarts=1,
                scheduling_strategy=NodeAffinitySchedulingStrategy(node.node_id, soft=True),
            ).remote(cfg, params, True)
            try:
                seen["before"] = rt.get(actor.generate.remote(prompts, 32), timeout=300) == want
            except RayActorError as exc:  # the kill landed first
                seen["before"] = type(exc).__name__
            while not node.dead:
                time.sleep(0.05)
            t0 = time.perf_counter()
            while True:
                try:
                    after = rt.get(actor.generate.remote(prompts, 32), timeout=300)
                    break
                except RayActorError:
                    if time.perf_counter() - t0 > 300:
                        raise
                    time.sleep(0.1)
            seen["restart_s"] = time.perf_counter() - t0
            seen["after"] = after
            seen["restarts"] = [(a.max_restarts, a.num_restarts)
                                for a in cluster.control.actors.list_actors()]
            rt.get(actor.close.remote())
            rt.kill(actor)
            return []
        return workload

    def check(result, seen):
        kinds = [e["kind"] for e in result.events_applied]
        if kinds != ["add_node", "kill_node", "add_node"] or any(
                "skipped" in e for e in result.events_applied):
            raise AssertionError(f"gpu-actor-node-kill: events {result.events_applied}")
        if seen["after"] != want or seen["before"] not in (True, "ActorDiedError",
                                                           "RayActorError"):
            raise AssertionError(f"gpu-actor-node-kill: tokens after the restart differ from the "
                                 f"direct int8 engine's ({seen['before']})")
        if not any(n == 1 for m, n in seen["restarts"]):
            raise AssertionError(f"gpu-actor-node-kill: no restart {seen['restarts']}")
        return {"tokens_before_equal_direct": seen["before"],
                "tokens_after_restart_equal_direct": True, "restart_s": seen["restart_s"],
                "restarts": seen["restarts"]}

    zero_counters(counters)
    out = run_schedule_twice(
        rt, "gpu-actor-node-kill", CHAOS_NODE_KILL_SEED,
        [(0.0, "add_node", {"resources": {"CPU": 2, "GPU": 1}}),
         (CHAOS_KILL_AT_S, "kill_node", {"index": 0}),
         (CHAOS_KILL_AT_S + 0.5, "add_node", {"resources": {"CPU": 2, "GPU": 1}})],
        make_workload, check)
    launches, by_route = read_counters(counters)
    if min(launches.values()) <= 0:
        raise AssertionError(f"gpu-actor-node-kill: launches {launches}")
    return {**out, "launches": launches, "launches_by_route": by_route}


def run_chaos(torch, cfg, params, kernels_of: dict, card: str) -> dict:
    """The chaos phase: (a) + (c) and (b) on one runtime, then (d)'s three
    schedules, each twice on fresh runtimes; (e) after the last
    ``shutdown``: no new CUDA storage of 1 MiB or more, no worker process,
    no failpoint armed. Returns the phase's one report."""
    import gc

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve, util
    from ray_tpu_torch.runtime import failpoints

    # the serving decoder's widths at CUT_LAYERS layers (the script's time):
    # its first layers' weights, and every check against a direct run here
    cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    params = {**params, "layers": {k: v[:CUT_LAYERS] for k, v in params["layers"].items()}}
    baseline = cuda_storages(torch)
    t_phase = time.perf_counter()
    rep = {"card": card, "layers": CUT_LAYERS}
    rt.init(num_cpus=8)
    try:
        if rt.cluster_resources().get("GPU") != 1:
            raise AssertionError(f"init on the card: {rt.cluster_resources()}")
        pool = chaos_pool(torch, rt, util, cfg, params, kernels_of)
        launches = pool.pop("launches")
        rep.update(pool)
        rep.update(chaos_queue(torch, rt, util))
    finally:
        rt.shutdown()
    disagg = chaos_disagg(torch, rt, serve, cfg, params, kernels_of)
    lose = chaos_lose_objects(torch, rt)
    node_kill = chaos_node_kill(torch, rt, cfg, params, kernels_of)
    rep["d_schedules"] = {"disagg-decode-kill": disagg, "lose-device-objects": lose,
                          "gpu-actor-node-kill": node_kill}
    for n, x in (*disagg.pop("launches").items(), *node_kill.pop("launches").items()):
        launches[n] = launches.get(n, 0) + x
    by_route = node_kill.pop("launches_by_route")
    t0 = time.perf_counter()
    while True:
        gc.collect()
        new = cuda_storages(torch) - baseline
        left = worker_processes()
        if not (new or left) or time.perf_counter() - t0 > SERVE_TEARDOWN_WAIT_S:
            break
        time.sleep(0.1)
    armed = failpoints.armed_spec()
    if new or left or armed:
        raise AssertionError(f"after shutdown: {len(new)} CUDA storages of >= 1 MiB "
                             f"({live_cuda_tensors(torch)}), workers {left}, armed {armed}")
    rep["e_teardown"] = {"new_cuda_storages_1mib": 0, "workers_left": 0,
                         "failpoints_armed": armed or None,
                         "teardown_s": time.perf_counter() - t0}
    rep["launches"] = launches
    rep["launches_by_route"] = by_route
    rep["seconds"] = time.perf_counter() - t_phase
    return rep


DATA_PROMPTS = 64
DATA_PROMPT_LEN = 64
DATA_MAX_TOKENS = 32
DATA_BATCH = 16
DATA_SEED = 14
DATA_ENGINE_KW = {"max_batch_size": 32, "max_seq_len": 128, "kv_block_size": 16,
                  "cache_kind": "paged"}
DATA_TABLE = (30, 2048)  # part (b): the token table, 5 batches of run_train's [6, 2048]
DATA_ROWS = 16_777_216  # part (c): two int64 columns, 256 MiB
DATA_PARALLELISM = 16
DATA_GROUPS = 1024


def data_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(DATA_SEED)
    return rng.integers(1, cfg.vocab_size - 1, (DATA_PROMPTS, DATA_PROMPT_LEN)).tolist()


def data_direct_burst(torch, cfg, params, prompts, quantize: bool) -> dict:
    """A direct ``LLMEngine`` with the predictor's engine kwargs, warmed, fed
    every prompt at once: the tokens the map is held to, and its numbers."""
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params, device="cuda", quantize=quantize, **DATA_ENGINE_KW)
    try:
        eng.generate([5] * DATA_PROMPT_LEN, max_tokens=2)  # cuBLAS handles, kernel load
        torch.cuda.synchronize()
        before = engine_sketches(eng)
        t0 = time.perf_counter()
        futures = [eng.submit(p, max_tokens=DATA_MAX_TOKENS) for p in prompts]
        tokens = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ttft = sketch_delta(before["ttft"], engine_sketches(eng)["ttft"])
    finally:
        eng.shutdown()
    n_tok = sum(len(t) for t in tokens)
    return {"tokens": tokens, "wall_s": wall, "rows_per_s": len(prompts) / wall,
            "tokens_per_s": n_tok / wall, "ttft_s": ttft}


def data_inference(torch, rt, cfg, params, kernels_of: dict, quantize: bool) -> dict:
    """(a), one dtype: ``map_batches(LLMPredictor, ...)`` over the seeded
    prompts on two in-process GPU actors of half the card each, against a
    direct engine's burst; K1 (and K6) zeroed just before the map and read
    just after."""
    from ray_tpu_torch.data import LLMPredictor, llm_inference
    from ray_tpu_torch.runtime.control import ActorState

    prompts = data_prompts(cfg)
    direct = data_direct_burst(torch, cfg, params, prompts, quantize)
    torch.cuda.empty_cache()
    names = ["paged_decode_attention"] + (["int8_matmul"] if quantize else [])
    counters = {n: kernels_of[n] for n in names}
    factory = lambda: (cfg, params)  # noqa: E731 - one object: the actors share its engine
    kw = {"max_tokens": DATA_MAX_TOKENS, "device": "cuda", "quantize": quantize, **DATA_ENGINE_KW}
    # build and warm the cached engine the map's in-process actors will find
    warm = LLMPredictor(factory, **kw)
    warm.engine.generate([5] * DATA_PROMPT_LEN, max_tokens=2)
    torch.cuda.synchronize()
    before = engine_sketches(warm.engine)
    del warm
    ds = rt.data.from_items([{"prompt": p} for p in prompts], parallelism=DATA_PROMPTS // DATA_BATCH)
    actors0 = set(rt.get_cluster().control.actors._actors)
    with decode_steps_by_role() as steps:
        zero_counters(counters)
        t0 = time.perf_counter()
        rows = ds.map_batches(LLMPredictor, fn_constructor_args=(factory,),
                              fn_constructor_kwargs=kw, batch_size=DATA_BATCH, concurrency=2,
                              num_gpus=0.5).take_all()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, by_route = read_counters(counters)
    engines = [e for _, e, _ in llm_inference._engine_cache.values()]
    ttft = sketch_delta(before["ttft"], engine_sketches(engines[0])["ttft"])
    workers = [a for aid, a in rt.get_cluster().control.actors._actors.items()
               if aid not in actors0]
    what = f"(a) {'int8 ' if quantize else ''}map_batches(LLMPredictor)"
    got = {tuple(int(t) for t in r["prompt"]): [int(t) for t in r["generated"]] for r in rows}
    if len(rows) != len(prompts) or [got.get(tuple(p)) for p in prompts] != direct["tokens"]:
        raise AssertionError(f"{what}: tokens differ from a direct engine's")
    if len(engines) != 1 or len(workers) != 2 or any(
            a.state != ActorState.DEAD for a in workers):
        raise AssertionError(f"{what}: {len(engines)} engines for the two actors, actors "
                             f"{[(a.class_name, a.state) for a in workers]}")
    n_steps = steps.get("", 0)
    if launches["paged_decode_attention"] != cfg.n_layers * n_steps or n_steps < DATA_MAX_TOKENS - 1:
        raise AssertionError(f"{what}: K1 {launches} over {n_steps} decode steps, want "
                             f"{cfg.n_layers} a step")
    per_forward = k6_per_layer(cfg) * cfg.n_layers
    if quantize and (launches["int8_matmul"] % per_forward
                     or launches["int8_matmul"] < per_forward * n_steps
                     or by_route["int8_matmul"] != {"mma_bf16": launches["int8_matmul"],
                                                    "simt": 0}):
        raise AssertionError(f"{what}: K6 {launches} {by_route}, want {per_forward} a forward "
                             "on the tensor cores")
    llm_inference.clear_engine_cache()
    del engines
    n_tok = sum(len(t) for t in direct["tokens"])
    return {
        "quantize": quantize, "rows": len(prompts), "prompt_len": DATA_PROMPT_LEN,
        "max_tokens": DATA_MAX_TOKENS, "batch_size": DATA_BATCH, "actors": 2,
        "num_gpus_each": 0.5, "engines_on_card": 1, "tokens_equal_direct": True,
        "decode_steps": n_steps, "launches": launches, "launches_by_route": by_route,
        "k1_per_decode_step": launches["paged_decode_attention"] / n_steps,
        **({"k6_forwards": launches["int8_matmul"] // per_forward} if quantize else {}),
        "map_wall_s": wall, "rows_per_s_map": len(prompts) / wall,
        "tokens_per_s_map": n_tok / wall, "ttft_s_map": ttft,
        "direct_wall_s": direct["wall_s"], "rows_per_s_direct": direct["rows_per_s"],
        "tokens_per_s_direct": direct["tokens_per_s"], "ttft_s_direct": direct["ttft_s"],
        "map_over_direct_tokens_per_s": (n_tok / wall) / direct["tokens_per_s"],
    }


def run_data_inference(torch, cfg, params, kernels_of: dict, card: str):
    """(a): batch inference float then int8 on one runtime; after
    ``clear_engine_cache()`` and ``shutdown`` no engine, actor or worker is
    left and ``memory_allocated`` is back (within the engine threads'
    cuBLAS workspaces). Yields one report a dtype, then the teardown's."""
    import gc

    import ray_tpu_torch as rt

    # the serving decoder's widths at CUT_LAYERS layers (the script's time):
    # its first layers' weights, the map held to a direct engine here
    cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    params = {**params, "layers": {k: v[:CUT_LAYERS] for k, v in params["layers"].items()}}
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    rt.init(num_cpus=8)
    try:
        if rt.cluster_resources().get("GPU") != 1:
            raise AssertionError(f"init on the card: {rt.cluster_resources()}")
        for quantize in (False, True):
            rep = data_inference(torch, rt, cfg, params, kernels_of, quantize)
            yield {"part": "a_batch_inference", "card": card, "layers": CUT_LAYERS, **rep}
    finally:
        rt.shutdown()
    from ray_tpu_torch.data import llm_inference

    t0 = time.perf_counter()
    while True:
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - mem0
        threads = [t.name for t in threading.enumerate() if t.name == "llm-engine"]
        left = worker_processes()
        if (held <= RUNTIME_MEMORY_SLACK and not threads and not left) \
                or time.perf_counter() - t0 > SERVE_TEARDOWN_WAIT_S:
            break
        time.sleep(0.1)
    if llm_inference._engine_cache or threads or left or held > RUNTIME_MEMORY_SLACK \
            or rt.is_initialized():
        raise AssertionError(f"(a) after clear_engine_cache and shutdown: "
                             f"{len(llm_inference._engine_cache)} cached engines, threads "
                             f"{threads}, workers {left}, {held} device bytes held by "
                             f"{live_cuda_tensors(torch)}")
    yield {"part": "a_teardown", "card": card, "engines_left": 0, "engine_threads_left": 0,
           "workers_left": 0, "memory_allocated_delta_bytes": held,
           "teardown_s": time.perf_counter() - t0}


def data_on_ramp(torch, kernels_of: dict, card: str) -> dict:
    """(b): a seeded token table through ``from_numpy``, ``random_shuffle``
    and ``iter_device_batches`` into the 602M train step for 5 steps. Each
    device batch equals the host ``iter_batches`` rows bitwise; each step's
    loss equals the same step given the same tensor directly, from the same
    state (deterministic algorithms on for both); K3/K4/K5 launches a step
    on the tensor cores."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.models.transformer import init_params, make_train_step, new_train_state
    from ray_tpu_torch.parallel.pipeline import tree_map

    cfg = train_config(torch)
    attention = {n: kernels_of[n] for n in ("flash_attention_forward",
                                            "flash_attention_backward_dq",
                                            "flash_attention_backward_dkv")}
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    _, train_step = make_train_step(cfg, device="cuda")
    state = new_train_state(params)
    del params
    table = np.random.default_rng(DATA_SEED).integers(0, cfg.vocab_size, DATA_TABLE,
                                                      dtype=np.int32)
    L = cfg.n_layers
    want_routes = {"flash_attention_forward": {"wgmma_bf16": 2 * L, "simt_f32": 0},
                   "flash_attention_backward_dq": {"wgmma_bf16": L, "simt_f32": 0},
                   "flash_attention_backward_dkv": {"wgmma_bf16": L, "simt_f32": 0}}
    losses, direct_losses, iter_ms, step_ms, launches, routes = [], [], [], [], [], []
    rt.init(num_cpus=8)
    torch.use_deterministic_algorithms(True)
    try:
        ds = rt.data.from_numpy(table).random_shuffle(seed=DATA_SEED).materialize()
        host = [b["data"] for b in ds.iter_batches(batch_size=6, drop_last=True)]
        it = ds.iter_device_batches(batch_size=6, dtypes={"data": torch.int64}, device="cuda",
                                    drop_last=True)
        for i in range(len(host)):
            t0 = time.perf_counter()
            batch = next(it)["data"]
            torch.cuda.synchronize()
            iter_ms.append((time.perf_counter() - t0) * 1e3)
            direct = torch.from_numpy(host[i]).to("cuda").long()
            if batch.device.type != "cuda" or batch.dtype != torch.int64 \
                    or not torch.equal(batch, direct):
                raise AssertionError(f"(b) batch {i}: {batch.dtype} on {batch.device} differs "
                                     "from the host iter_batches rows")
            snapshot = tree_map(torch.clone, state)
            zero_counters(attention)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            state, loss = train_step(state, batch)
            e1.record()
            torch.cuda.synchronize()
            n, by_route = read_counters(attention)
            if by_route != want_routes or n["flash_attention_backward_dq"] != L:
                raise AssertionError(f"(b) step {i + 1}: launches {n}, routes {by_route}")
            snapshot, loss_direct = train_step(snapshot, direct)
            if not torch.equal(loss, loss_direct):
                raise AssertionError(f"(b) step {i + 1}: loss {float(loss)!r} from the "
                                     f"iterator, {float(loss_direct)!r} given the tensor")
            del snapshot
            losses.append(float(loss))
            direct_losses.append(float(loss_direct))
            step_ms.append(e0.elapsed_time(e1))
            launches.append(n)
            routes.append(by_route)
        if next(it, None) is not None:
            raise AssertionError("(b) the iterator yielded more than its 5 batches")
    finally:
        torch.use_deterministic_algorithms(False)
        rt.shutdown()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(b) losses {losses}")
    del state
    torch.cuda.empty_cache()
    return {"part": "b_on_ramp", "card": card, "table": list(DATA_TABLE), "batch": 6,
            "steps": len(losses), "losses": losses, "losses_bitwise_equal_direct": True,
            "batches_bitwise_equal_host": True, "iter_ms": iter_ms,
            "iter_ms_median": statistics.median(iter_ms), "step_ms": step_ms,
            "step_ms_median": statistics.median(step_ms),
            "iter_over_step": statistics.median(iter_ms) / statistics.median(step_ms),
            "launches_per_step": launches, "launches_by_route_per_step": routes}


def data_key_column(ids, seed: int):
    """The pipeline's seeded second column: a 64-bit mix of the row id
    (splitmix64), kept to 31 bits so sums stay exact in int64."""
    import numpy as np

    z = ids.astype(np.uint64) + np.uint64(seed * 0x9E3779B97F4A7C15 % (1 << 64))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(33)).astype(np.int64)


@contextlib.contextmanager
def peak_rss(interval_s: float = 0.05):
    """The largest resident size (bytes) this process and its workers held
    together while inside, sampled every ``interval_s``, and the size on
    entry (``before_bytes``). Pages of the shm arena count once in each
    process that maps them."""
    page = os.sysconf("SC_PAGE_SIZE")

    def rss(pid) -> int:
        try:
            with open(f"/proc/{pid}/statm") as f:
                return int(f.read().split()[1]) * page
        except OSError:
            return 0

    def total() -> int:
        return rss(os.getpid()) + sum(rss(p) for p in worker_processes())

    peak, stop = {"bytes": total()}, threading.Event()
    peak["before_bytes"] = peak["bytes"]

    def sample():
        while not stop.wait(interval_s):
            peak["bytes"] = max(peak["bytes"], total())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield peak
    finally:
        stop.set()
        thread.join()


def data_host_pipeline(rt, rows: int, card: str) -> dict:
    """(c): ``range(rows, parallelism=16)`` with a seeded int64 key column,
    then ``random_shuffle``, ``sort``, ``groupby(key % 1024).sum()`` and
    ``write_numpy`` / ``read_numpy`` through a temporary directory: the
    multiset, the order and the sums against numpy's; blocks reach the
    workers through the shm arena. One operator's output is held at a
    time."""
    import numpy as np

    rd = rt.data
    native = native_tier(rt)
    ids = np.arange(rows, dtype=np.int64)
    keys = data_key_column(ids, DATA_SEED)
    seed = DATA_SEED

    def with_key(b):
        return {"id": b["id"], "key": data_key_column(b["id"], seed)}

    base = rd.range(rows, parallelism=DATA_PARALLELISM).map_batches(with_key)
    rate, wall = {}, {}

    def timed(name, run):
        t0 = time.perf_counter()
        out = run()
        wall[name] = time.perf_counter() - t0
        rate[name] = rows / wall[name]
        return out

    def columns(mat):
        blocks = [rt.get(r) for r in mat.get_internal_block_refs()]
        return (np.concatenate([b["id"] for b in blocks if len(b.get("id", ()))]),
                np.concatenate([b["key"] for b in blocks if len(b.get("key", ()))]))

    with encoded_as() as kinds, peak_rss() as peak:
        mat = timed("materialize", base.materialize)
        got_id, got_key = columns(mat)  # blocks in completion order
        order = np.argsort(got_id, kind="stable")
        if not (np.array_equal(got_id[order], ids) and np.array_equal(got_key[order], keys)):
            raise AssertionError("(c) range + key column differ from numpy's")
        del got_id, got_key, order
        shuffled = timed("random_shuffle", mat.random_shuffle(seed=seed).materialize)
        s_id, s_key = columns(shuffled)
        order = np.argsort(s_id, kind="stable")
        if np.array_equal(s_id, ids) or not (np.array_equal(s_id[order], ids)
                                             and np.array_equal(s_key[order], keys)):
            raise AssertionError("(c) random_shuffle: not a permutation of the rows")
        del shuffled, s_id, s_key, order
        by_key = timed("sort", mat.sort("key").materialize)
        k_id, k_key = columns(by_key)
        if not (np.array_equal(k_key, np.sort(keys)) and np.array_equal(keys[k_id], k_key)
                and np.array_equal(np.sort(k_id), ids)):
            raise AssertionError("(c) sort: keys out of order or rows lost")
        del by_key, k_id, k_key
        groups = timed("groupby_sum", lambda: mat.map_batches(
            lambda b: {"g": b["key"] % DATA_GROUPS, "key": b["key"]}).groupby("g").sum(
            "key").take_all())
        # float64 sums are exact here: each is below 2**24 * 2**31 < 2**53
        want = np.bincount(keys % DATA_GROUPS, weights=keys, minlength=DATA_GROUPS)
        got = {int(r["g"]): int(r["sum(key)"]) for r in groups}
        if got != {g: int(want[g]) for g in range(DATA_GROUPS)}:
            raise AssertionError("(c) groupby(key % 1024).sum(): sums differ from numpy's")
        with tempfile.TemporaryDirectory() as tmp:
            timed("write_numpy", lambda: mat.write_numpy(tmp, column="key"))
            files = sorted(os.listdir(tmp))
            back = timed("read_numpy", lambda: rd.read_numpy(tmp).materialize())
            blocks = [rt.get(r) for r in back.get_internal_block_refs()]
            read = np.concatenate([b["data"] for b in blocks if len(b.get("data", ()))])
            if not np.array_equal(np.sort(read), np.sort(keys)) or read.shape != keys.shape:
                raise AssertionError("(c) write_numpy / read_numpy: the key column differs")
            del back, blocks, read
        del mat
    if "ShmRef" not in kinds:
        raise AssertionError(f"(c) no block reached a worker through the shm arena: {set(kinds)}")
    return {"part": "c_host_pipeline", "card": card, "rows": rows,
            "parallelism": DATA_PARALLELISM, "columns": ["id int64", "key int64"],
            "bytes": rows * 16, "groups": DATA_GROUPS, "cut_from_rows": (
                DATA_ROWS if rows != DATA_ROWS else None),
            "rows_per_s": rate, "wall_s": wall, "files_written": len(files),
            "shm_refs_sent": kinds.count("ShmRef"), "native": native,
            "peak_rss_gib_driver_and_workers": peak["bytes"] / 2**30,
            "rss_gib_driver_and_workers_before": peak["before_bytes"] / 2**30,
            "multiset_order_sums_equal_numpy": True}


def run_data_pipeline(torch, card: str, rows: int = DATA_ROWS) -> dict:
    import ray_tpu_torch as rt

    rt.init(num_cpus=8)
    try:
        return data_host_pipeline(rt, rows, card)
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# the compiled-graph layer: plans, StageGroup gangs and compiled DAGs
# ---------------------------------------------------------------------------
DAG_PROMPTS = 64  # the engine phase's burst form (burst_prompts), 64 of them
DAG_BATCH = 8  # prompts an iteration: the engine phase's burst, 8 iterations
DAG_PROMPT_LEN = 64
DAG_MAX_TOKENS = 32
DAG_GANG_BATCH = (8, 1024)
DAG_GANG_ITERS = 20
DAG_GANG_SEED = 15
DAG_TIMEOUT_S = 120.0  # a killed stage's typed error on the output channel within this
# (d): after teardown and shutdown, memory_allocated within the actor threads'
# cuBLAS workspaces (the runtime phase's slack)
DAG_MEMORY_SLACK = RUNTIME_MEMORY_SLACK


class DagPrompt:
    """(a)'s first stage: a batch of prompt texts (token ids, space
    separated) to one token tensor on the card."""

    def encode(self, texts):
        import torch

        return torch.tensor([[int(t) for t in text.split()] for text in texts],
                            dtype=torch.int32, device="cuda")


class DagEngine(EngineActor):
    """(a)'s GPU stage: the runtime phase's engine actor; a call (a plan
    stage's iteration) submits a batch of prompts at once, as the engine
    phase's burst does, and returns their tokens as a tensor on the card."""

    def generate_batch(self, tokens):
        import torch

        out = self.generate(tokens.tolist(), DAG_MAX_TOKENS)
        return torch.tensor(out, dtype=torch.int32, device=tokens.device)


class DagDetok:
    """(a)'s last stage: the token tensor to each prompt's ids and text."""

    def decode(self, tokens):
        return [(ids, ToyTokenizer().decode(ids)) for ids in tokens.tolist()]


class GangMember:
    """(b)'s gang member: the 602M decoder's forward on its rows, weights
    shared with the other member (one copy on the card)."""

    def __init__(self, cfg, params):
        self.cfg, self.params = cfg, params

    def forward(self, tokens):
        import torch

        from ray_tpu_torch.models.transformer import forward

        with torch.inference_mode():
            return forward(self.cfg, self.params, tokens)


class DagScale:
    """(d)'s GPU actors: one elementwise op each on a CUDA tensor."""

    def __init__(self, k: float):
        self.k = k

    def scale(self, x):
        return x * self.k

    def shift(self, x):
        return x + self.k


def dag_matmul(x, w):
    return x @ w


def dag_relu(x):
    import torch

    return torch.relu(x)


def zero_taskspec_counters():
    """The counters ``tests/test_plans.py`` reads for 'zero TaskSpecs':
    tasks and actor calls submitted, scheduler dispatches."""
    from ray_tpu_torch.observability import metric_defs as md

    return (md.TASKS_SUBMITTED.series(), md.ACTOR_CALLS_SUBMITTED.series(),
            md.SCHEDULER_TASKS_DISPATCHED.series())


def dag_serving_plan(torch, rt, cfg, params, kernels_of: dict, quantize: bool, card: str):
    """(a) at one dtype: the three-stage plan over the engine actor, the
    64 prompts through ``execute_async`` (8 an iteration), against the same
    batches by ``.remote()`` to the same actors and against an instance of
    the engine class driven directly, a batch a call each. Returns the
    report, the plan, its stages, the batches and the direct tokens."""
    from ray_tpu_torch.dag import InputNode

    prompts = burst_prompts(cfg, DAG_PROMPTS, DAG_PROMPT_LEN)
    texts = [[" ".join(map(str, p)) for p in prompts[i:i + DAG_BATCH]]
             for i in range(0, DAG_PROMPTS, DAG_BATCH)]
    names = ["paged_decode_attention"] + (["int8_matmul"] if quantize else [])
    counters = {n: kernels_of[n] for n in names}
    what = f"dag (a) {'int8' if quantize else 'float'}"

    direct = DagEngine(cfg, params, quantize)
    try:
        direct.warm(DAG_PROMPT_LEN)
        t0 = time.perf_counter()
        want = [direct.generate_batch(DagPrompt().encode(t)).tolist() for t in texts]
        torch.cuda.synchronize()
        direct_s = time.perf_counter() - t0
    finally:
        direct.close()
    del direct
    torch.cuda.empty_cache()

    prompt = rt.remote(DagPrompt).options(execution="inproc").remote()
    engine = rt.remote(DagEngine).options(num_gpus=0.5, max_restarts=1).remote(
        cfg, params, quantize)
    detok = rt.remote(DagDetok).options(execution="inproc").remote()
    rt.get(engine.warm.remote(DAG_PROMPT_LEN))
    with InputNode() as inp:
        graph = detok.decode.bind(engine.generate_batch.bind(prompt.encode.bind(inp)))
    plan = graph.compile_plan(name=f"serve-{'int8' if quantize else 'float'}")
    try:
        snap = plan.snapshot()
        kinds = sorted(set(snap["channel_kinds"].values()))
        if kinds != ["device"] or len(snap["channels"]) != 4:
            raise AssertionError(f"{what}: channels {snap['channel_kinds']}")
        steps0 = rt.get(engine.decode_steps.remote())
        before = zero_taskspec_counters()
        zero_counters(counters)
        t0 = time.perf_counter()
        futs = [plan.execute_async(t) for t in texts]
        got = [f.result(timeout=600) for f in futs]
        plan_s = time.perf_counter() - t0
        launches, by_route = read_counters(counters)
        if zero_taskspec_counters() != before:
            raise AssertionError(f"{what}: plan.execute created TaskSpecs")
        steps = rt.get(engine.decode_steps.remote()) - steps0
        executions = plan.snapshot()["executions"]
    except BaseException:
        plan.teardown()
        raise
    t0 = time.perf_counter()
    refs = [detok.decode.remote(engine.generate_batch.remote(prompt.encode.remote(t)))
            for t in texts]
    by_remote = rt.get(refs, timeout=600)
    remote_s = time.perf_counter() - t0
    if [[ids for ids, _ in batch] for batch in got] != want \
            or [[ids for ids, _ in batch] for batch in by_remote] != want:
        raise AssertionError(f"{what}: tokens differ from the direct engine's")
    if executions != len(texts):
        raise AssertionError(f"{what}: {executions} plan executions")
    if launches["paged_decode_attention"] != cfg.n_layers * steps \
            or steps < (DAG_MAX_TOKENS - 1) * len(texts):
        raise AssertionError(f"{what}: K1 {launches} over {steps} decode steps, "
                             f"want {cfg.n_layers} a step")
    per_forward = k6_per_layer(cfg) * cfg.n_layers
    if quantize and (launches["int8_matmul"] % per_forward
                     or launches["int8_matmul"] < per_forward * steps
                     or by_route["int8_matmul"] != {"mma_bf16": launches["int8_matmul"],
                                                    "simt": 0}):
        raise AssertionError(f"{what}: K6 {launches} {by_route}, want {per_forward} "
                             "a forward on the tensor cores")
    n_tok = DAG_PROMPTS * DAG_MAX_TOKENS
    rep = {
        "part": "a_serving_plan", "card": card, "quantize": quantize, "layers": cfg.n_layers,
        "prompts": DAG_PROMPTS,
        "prompts_per_iteration": DAG_BATCH, "iterations": len(texts),
        "prompt_len": DAG_PROMPT_LEN, "max_tokens": DAG_MAX_TOKENS,
        "tokens_equal_direct": True, "remote_tokens_equal_direct": True,
        "taskspecs_per_iteration": 0, "channel_kinds": snap["channel_kinds"],
        "decode_steps": steps, "launches": launches, "launches_by_route": by_route,
        "k1_per_decode_step": launches["paged_decode_attention"] / steps,
        **({"k6_forwards": launches["int8_matmul"] // per_forward} if quantize else {}),
        "requests_per_s": {"plan": DAG_PROMPTS / plan_s, "remote": DAG_PROMPTS / remote_s,
                           "direct": DAG_PROMPTS / direct_s},
        "tokens_per_s": {"plan": n_tok / plan_s, "remote": n_tok / remote_s,
                         "direct": n_tok / direct_s},
        "plan_over_remote": remote_s / plan_s, "plan_over_direct": direct_s / plan_s,
        "ms_per_request": {"plan": plan_s / DAG_PROMPTS * 1e3,
                           "remote": remote_s / DAG_PROMPTS * 1e3,
                           "direct": direct_s / DAG_PROMPTS * 1e3},
        "text_sample": got[0][0][1][:16],
    }
    return rep, plan, (prompt, engine, detok), texts, want


def dag_kill_and_repair(torch, rt, plan, stages, texts, want, auto_repair_plan_of):
    """(c): the engine stage killed with an iteration in flight: the output
    gives ``ActorDiedError`` within ``DAG_TIMEOUT_S``, the plan is BROKEN,
    ``repair()`` reinstalls on the restarted actor and its tokens equal the
    direct engine's again. Then a fresh engine actor under a plan with
    ``auto_repair=True``, killed the same way, heals itself. Run under an
    empty chaos schedule: invariant 8 audits the plans' transitions."""
    from ray_tpu_torch import chaos
    from ray_tpu_torch.exceptions import ActorDiedError

    seen = {}

    def tokens_of(batch):
        return [ids for ids, _ in batch]

    def kill_mid_plan(p, actor, tag):
        futs = [p.execute_async(t) for t in texts[:3]]
        futs[0].result(timeout=DAG_TIMEOUT_S)  # the engine stage now holds the next prompt
        t_kill = time.perf_counter()
        rt.kill(actor, no_restart=False)  # restartable: the FSM brings it back
        errors = []
        for f in futs[1:]:
            try:
                f.result(timeout=DAG_TIMEOUT_S)
            except ActorDiedError as exc:
                errors.append(type(exc).__name__)
        seen[f"{tag}_error_s"] = time.perf_counter() - t_kill
        if not errors:
            raise AssertionError(f"dag (c) {tag}: no ActorDiedError from the killed stage")
        seen[f"{tag}_errors"] = errors

    def workload():
        kill_mid_plan(plan, stages[1], "repair")
        if plan.state != "BROKEN":
            raise AssertionError(f"dag (c): plan {plan.state} after the kill")
        t0 = time.perf_counter()
        plan.repair(timeout=DAG_TIMEOUT_S)
        seen["repair_s"] = time.perf_counter() - t0
        again = tokens_of(plan.execute(texts[0]))
        if again != want[0] or plan.state_history != ["READY", "BROKEN", "READY"]:
            raise AssertionError(f"dag (c): after repair {plan.state_history}, tokens equal "
                                 f"{again == want[0]}")
        plan.teardown()
        auto, engine = auto_repair_plan_of()
        try:
            if tokens_of(auto.execute(texts[0])) != want[0]:
                raise AssertionError("dag (c): the auto-repair plan's tokens differ")
            kill_mid_plan(auto, engine, "auto")
            t0 = time.perf_counter()
            while auto.state != "READY" or auto.state_history[-1] != "READY" \
                    or "BROKEN" not in auto.state_history:
                if time.perf_counter() - t0 > DAG_TIMEOUT_S:
                    raise AssertionError(f"dag (c): auto repair stuck at {auto.state_history}")
                time.sleep(0.05)
            seen["auto_repair_s"] = time.perf_counter() - t0
            healed = tokens_of(auto.execute(texts[0]))
            if healed != want[0]:
                raise AssertionError("dag (c): tokens after the auto repair differ")
            seen["auto_history"] = list(auto.state_history)
        finally:
            auto.teardown()
            rt.kill(engine)
        return []

    schedule = chaos.ChaosSchedule([], seed=0, name="dag-stage-kill-repair")
    result = chaos.ChaosRunner(schedule, quiesce_timeout=600).run(workload)
    inv = result.invariants.to_dict() if result.invariants else {}
    if not result.ok:
        raise AssertionError(f"dag (c): {result.workload_error!r} {inv.get('violations')}")
    transitions = inv["checked"]["plan_transitions"]
    # repair plan READY->BROKEN->READY->TORN_DOWN, auto the same
    if transitions != 6 or inv["violations"]:
        raise AssertionError(f"dag (c): invariant 8 counted {transitions} transitions, "
                             f"violations {inv['violations']}")
    return {"part": "c_kill_and_repair", "prompts_after_repair": len(texts[0]),
            "tokens_equal_direct_after_repair": True, "plan_transitions": transitions,
            "invariant_violations": 0, **seen}


def dag_compiled(torch, rt) -> dict:
    """(d): a pure-function DAG on bf16 CUDA tensors takes the inline walk
    (``jit``) and equals ``torch.relu(x @ w)`` bitwise; ``fuse="none"`` over
    two GPU actors' methods equals the same calls by ``.remote()``."""
    from ray_tpu_torch.dag import InputNode

    g = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn(2048, 2048, generator=g, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(2048, 2048, generator=g, device="cuda", dtype=torch.bfloat16)
    mm, act = rt.remote(dag_matmul), rt.remote(dag_relu)
    with InputNode() as inp:
        graph = act.bind(mm.bind(inp.x, inp.w))
    compiled = graph.experimental_compile()
    mode = compiled.mode
    out = compiled.execute(x=x, w=w)
    want = torch.relu(x @ w)
    if mode != "jit" or not out.is_cuda or not torch.equal(out, want):
        raise AssertionError(f"dag (d): mode {mode}, equal {torch.equal(out, want)}")
    reps = 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        compiled.execute(x=x, w=w)
    torch.cuda.synchronize()
    jit_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.relu(x @ w)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / reps * 1e3
    compiled.teardown()

    a = rt.remote(DagScale).options(num_gpus=0.5).remote(2.0)
    b = rt.remote(DagScale).options(num_gpus=0.5).remote(1.0)
    with InputNode() as inp:
        chain = b.shift.bind(a.scale.bind(inp))
    direct = chain.experimental_compile(fuse="none")
    got = direct.execute(x)
    by_remote = rt.get(b.shift.remote(a.scale.remote(x)))
    if direct.mode != "direct" or not torch.equal(got, by_remote) or not got.is_cuda:
        raise AssertionError(f"dag (d): fuse='none' {direct.mode}, equal "
                             f"{torch.equal(got, by_remote)}")
    t0 = time.perf_counter()
    for _ in range(reps):
        direct.execute(x)
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        rt.get(b.shift.remote(a.scale.remote(x)))
    torch.cuda.synchronize()
    remote_ms = (time.perf_counter() - t0) / reps * 1e3
    direct.teardown()
    # the same two calls as a plan: what a plan adds to a call (the entry,
    # the hand-off between the stages and the output channel, two stage
    # threads woken), alone and with iterations in flight
    plan = chain.compile_plan(name="two-actors")
    try:
        if not torch.equal(plan.execute(x), by_remote):
            raise AssertionError("dag (d): the plan's result differs from .remote()'s")
        t0 = time.perf_counter()
        for _ in range(reps):
            plan.execute(x)
        torch.cuda.synchronize()
        plan_ms = (time.perf_counter() - t0) / reps * 1e3
        t0 = time.perf_counter()
        futs = [plan.execute_async(x) for _ in range(reps)]
        for f in futs:
            f.result(timeout=60)
        torch.cuda.synchronize()
        plan_pipelined_ms = (time.perf_counter() - t0) / reps * 1e3
    finally:
        plan.teardown()
    rt.kill(a)
    rt.kill(b)
    return {"part": "d_compiled_dag", "jit_mode": mode, "jit_equal_bitwise": True,
            "shape": [2048, 2048], "dtype": "bfloat16", "jit_ms": jit_ms,
            "eager_ms": eager_ms, "direct_mode": "direct", "direct_equal_remote": True,
            "direct_ms": direct_ms, "remote_ms": remote_ms, "plan_ms": plan_ms,
            "plan_pipelined_ms": plan_pipelined_ms}


def run_dag_serving(torch, cfg, kernels_of: dict, card: str):
    """(a) float and int8, (c) on (a)'s float plan, (d), on one runtime,
    (a) and (c) on ``cfg``'s widths at ``CUT_LAYERS`` layers (weights from
    the serving phases' seed); after ``shutdown`` nothing is left and
    ``memory_allocated`` is back within ``DAG_MEMORY_SLACK``. Yields one
    report a part."""
    import gc

    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models.transformer import init_params

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    rt.init(num_cpus=8)
    try:
        if rt.cluster_resources().get("GPU") != 1:
            raise AssertionError(f"init on the card: {rt.cluster_resources()}")
        rep, plan, stages, texts, want = dag_serving_plan(
            torch, rt, cfg, params, kernels_of, False, card)
        yield rep
        try:
            rep, plan_q, stages_q, _, _ = dag_serving_plan(
                torch, rt, cfg, params, kernels_of, True, card)
            plan_q.teardown()
            for actor in stages_q:
                rt.kill(actor)
            yield rep

            def auto_repair_plan():
                engine = rt.remote(DagEngine).options(num_gpus=0.5, max_restarts=1).remote(
                    cfg, params, False)
                rt.get(engine.warm.remote(DAG_PROMPT_LEN))
                with InputNode() as inp:
                    graph = stages[2].decode.bind(engine.generate_batch.bind(
                        stages[0].encode.bind(inp)))
                return graph.compile_plan(name="serve-auto", auto_repair=True), engine

            rep = dag_kill_and_repair(torch, rt, plan, stages, texts, want, auto_repair_plan)
            yield {"card": card, **rep}
        finally:
            plan.teardown()
            for actor in stages:
                rt.kill(actor)
        yield {"card": card, **dag_compiled(torch, rt)}
    finally:
        rt.shutdown()
    # a plan holds its cluster and its stages' actor instances (engines, the
    # object store) until it is dropped, torn down or not
    del plan, stages, plan_q, stages_q, params
    t0 = time.perf_counter()
    while True:
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - mem0
        left = worker_processes()
        if (held <= DAG_MEMORY_SLACK and not left) \
                or time.perf_counter() - t0 > SERVE_TEARDOWN_WAIT_S:
            break
        time.sleep(0.1)
    if held > DAG_MEMORY_SLACK or left or rt.is_initialized():
        raise AssertionError(f"dag after teardown and shutdown: workers {left}, {held} device "
                             f"bytes held by {live_cuda_tensors(torch)}")
    yield {"part": "d_teardown", "card": card, "memory_allocated_delta_bytes": held,
           "memory_slack_bytes": DAG_MEMORY_SLACK, "workers_left": 0,
           "teardown_s": time.perf_counter() - t0}


def run_dag_gang(torch, kernels_of: dict, card: str) -> dict:
    """(b): two in-process GPU actors sharing one copy of the 602M decoder's
    weights form a ``StageGroup`` over the input; 20 iterations on seeded
    ``[8, 1024]`` batches against one module's forward of the whole batch."""
    from ray_tpu_torch.dag import InputNode, StageGroup
    from ray_tpu_torch.models.transformer import forward, init_params
    from ray_tpu_torch.observability import metric_defs
    from ray_tpu_torch.runtime import device_plane

    import ray_tpu_torch as rt

    cfg = train_config(torch)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for _, p in named_leaves(params))
    g = torch.Generator(device="cuda").manual_seed(DAG_GANG_SEED)
    batches = [torch.randint(0, cfg.vocab_size, DAG_GANG_BATCH, generator=g, device="cuda",
                             dtype=torch.int32) for _ in range(DAG_GANG_ITERS)]
    k3 = {"flash_attention_forward": kernels_of["flash_attention_forward"]}
    rt.init(num_cpus=8)
    try:
        members = [rt.remote(GangMember).options(num_gpus=0.5).remote(cfg, params)
                   for _ in range(2)]
        gang = StageGroup(members, "forward", split_axis=0,
                          warmup=(DAG_GANG_BATCH, "int32"))
        with InputNode() as inp:
            node = gang.bind(inp)
        zero_counters(k3)
        plan = node.compile_plan(name="gang-602m")  # the warm-up runs here
        try:
            packed0 = device_plane.stats.arrays_packed
            execs0 = metric_defs.PLAN_STAGE_GROUP_EXECUTIONS.get()
            kinds = sorted(set(plan.snapshot()["channel_kinds"].values()))
            outs, ms = [], []
            for tokens in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(plan.execute(tokens))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            launches, by_route = read_counters(k3)
            packed = device_plane.stats.arrays_packed - packed0
            execs = metric_defs.PLAN_STAGE_GROUP_EXECUTIONS.get() - execs0
            stages = plan.snapshot()["stages"]
        finally:
            plan.teardown()
        for m in members:
            rt.kill(m)
    finally:
        rt.shutdown()
    ref_ms, worst, bitwise = [], 0.0, True
    with torch.inference_mode():
        for tokens, got in zip(batches, outs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = forward(cfg, params, tokens)
            torch.cuda.synchronize()
            ref_ms.append((time.perf_counter() - t0) * 1e3)
            worst = max(worst, max_err(got, want, 2e-2, 2e-2, "dag (b) gang logits"))
            bitwise = bitwise and torch.equal(got, want)
            del want
    del outs, params
    torch.cuda.empty_cache()
    want_k3 = cfg.n_layers * 2 * (DAG_GANG_ITERS + 1)
    if launches["flash_attention_forward"] != want_k3 \
            or by_route["flash_attention_forward"].get("wgmma_bf16") != want_k3:
        raise AssertionError(f"dag (b): K3 {launches} {by_route}, want {want_k3} on wgmma_bf16")
    if packed or kinds != ["device"] or execs != DAG_GANG_ITERS \
            or [s["group"] for s in stages] != [2]:
        raise AssertionError(f"dag (b): {packed} tensors pickled, kinds {kinds}, "
                             f"{execs} group executions, stages {stages}")
    return {"part": "b_stage_group", "card": card, "params": n_params,
            "batch": list(DAG_GANG_BATCH), "iterations": DAG_GANG_ITERS,
            "members": 2, "logits_max_abs_err": worst, "logits_bitwise": bitwise,
            "tolerance": {"atol": 2e-2, "rtol": 2e-2}, "arrays_packed": packed,
            "channel_kinds": kinds, "group_executions": execs,
            "launches": launches, "launches_by_route": by_route,
            "ms_per_iteration_median": statistics.median(ms),
            "one_module_forward_ms_median": statistics.median(ref_ms),
            "gang_over_one_module": statistics.median(ref_ms) / statistics.median(ms)}

def train_config(torch):
    from ray_tpu_torch.models.transformer import TransformerConfig

    # bench.py model_mfu: the single-chip train step (602.6M params), as it
    # runs there on a TPU: bf16 activations, f32 params, flash attention,
    # remat="dots", unrolled layers
    return TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=8, n_heads=16, d_ff=8192,
        max_seq_len=2048, dtype=torch.bfloat16, attention="flash", remat="dots",
        scan_layers=False,
    )


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in named_leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def grad_rel_errs(grads_k, grads_p, of_largest: bool = False) -> dict:
    """{leaf: ||g_k - g_p|| / ||g_p||}, or with ``of_largest`` {leaf:
    max|g_k - g_p| / max|g_p|}; raises unless every leaf of ``grads_k`` is
    finite."""
    import torch

    rel = {}
    for (name, a), (_, b) in zip(named_leaves(grads_k), named_leaves(grads_p)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite grad {name}")
        a, b = a.float(), b.float()
        if of_largest:
            rel[name] = float((a - b).abs().max() / b.abs().max())
        else:
            rel[name] = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    return rel


def train_parity(torch, cfg, params):
    """Loss and every gradient leaf through the flash kernels against the
    einsum attention, batch 1: in f32 activations (K3/K4/K5 on the scalar
    route) and in bf16 (on the tensor-core route)."""
    from ray_tpu_torch.models.transformer import loss_and_grads
    from ray_tpu_torch.ops.attention import (
        flash_attention_backward_dkv,
        flash_attention_backward_dq,
        flash_attention_with_lse,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (1, cfg.max_seq_len), generator=g, device="cuda")
    counters = {"flash_attention_forward": flash_attention_with_lse,
                "flash_attention_backward_dq": flash_attention_backward_dq,
                "flash_attention_backward_dkv": flash_attention_backward_dkv}
    report = {}
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=getattr(torch, dt))
        zero_counters(counters)
        loss_k, grads_k = loss_and_grads(dataclasses.replace(c, attention="flash"), params, tokens)
        _, by_route = read_counters(counters)
        if any(r[ROUTE_OF[dt]] == 0 or sum(r.values()) != r[ROUTE_OF[dt]]
               for r in by_route.values()):
            raise AssertionError(f"train_parity {dt}: routes {by_route}")
        loss_p, grads_p = loss_and_grads(dataclasses.replace(c, attention="dense"), params, tokens)
        loss_err = abs(float(loss_k) - float(loss_p))
        if not (torch.isfinite(loss_k) and loss_err <= (1e-4 if dt == "float32" else 1e-2)):
            raise AssertionError(f"train_parity {dt}: loss {float(loss_k)} vs {float(loss_p)}")
        # f32: max error over the leaf's largest element; bf16: relative
        # Frobenius error
        rel = grad_rel_errs(grads_k, grads_p, of_largest=dt == "float32")
        limit = 1e-3 if dt == "float32" else 2e-2
        bad = {name: e for name, e in rel.items() if e > limit}
        if bad:
            raise AssertionError(f"train_parity {dt}: grads off by {bad} (limit {limit})")
        key = "" if dt == "float32" else "bf16_"
        report.update({f"{key}loss_flash": float(loss_k), f"{key}loss_dense": float(loss_p),
                       f"{key}loss_abs_err": loss_err, f"{key}grad_max_rel_err": max(rel.values()),
                       f"{key}grad_rel_err": rel, f"{key}launches_by_route": by_route})
        del grads_k, grads_p
        torch.cuda.empty_cache()
    return report


#: the depth (widths kept) of the 602M decoder where a phase checkpoints its
#: state: the train phase's resume check and ``trainer`` (a) and (b). At the
#: full 8 layers the train state's checkpoint is 7.2 GB (PERF.md section 4)
CUT_LAYERS = 2


def run_train(torch, cfg, params, counters: dict, steps: int = 5, batch: int = 6,
              resume_after: Optional[int] = None):
    """``steps`` AdamW steps on a repeated batch, counters zeroed before
    and read after each. With ``resume_after``, the state after that step
    is checkpointed and the next step is taken again from the restored copy
    (deterministic algorithms on for both): the two losses must be bitwise
    equal."""
    from ray_tpu_torch.models.transformer import make_train_step, new_train_state
    from ray_tpu_torch.train.checkpoint import Checkpoint

    _, train_step = make_train_step(cfg, device="cuda")
    state = new_train_state(params)
    n_params = sum(p.numel() for _, p in named_leaves(params))
    T = cfg.max_seq_len
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, T), generator=g, device="cuda")
    losses, step_ms, launches, routes = [], [], [], []

    def one_step(state):
        zero_counters(counters)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        state, loss = train_step(state, tokens)
        t1.record()
        torch.cuda.synchronize()
        n, by_route = read_counters(counters)
        L = cfg.n_layers
        if not (n["flash_attention_backward_dq"] == n["flash_attention_backward_dkv"] == L
                and n["flash_attention_forward"] >= L):
            raise AssertionError(f"step {len(losses) + 1}: launches {n}")
        # bf16 activations: every K3 launch (forward and its recompute) and
        # every K4 and K5 launch on the tensor cores
        want = {"flash_attention_forward": {"wgmma_bf16": 2 * L, "simt_f32": 0},
                "flash_attention_backward_dq": {"wgmma_bf16": L, "simt_f32": 0},
                "flash_attention_backward_dkv": {"wgmma_bf16": L, "simt_f32": 0}}
        if by_route != want:
            raise AssertionError(f"step {len(losses) + 1}: routes {by_route}, want {want}")
        losses.append(loss)
        step_ms.append(t0.elapsed_time(t1))
        launches.append(n)
        routes.append(by_route)
        return state

    torch.cuda.reset_peak_memory_stats()
    resume = {}
    for i in range(steps):
        if i != resume_after:
            state = one_step(state)
            continue
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ckpt = Checkpoint.from_pytree(state, base_dir=tmp)
            save_s = time.perf_counter() - t0
            torch.use_deterministic_algorithms(True)
            try:
                state = one_step(state)  # the uninterrupted step
                t0 = time.perf_counter()
                restored = ckpt.to_pytree(device="cuda")
                restore_s = time.perf_counter() - t0
                restored, loss_resumed = train_step(restored, tokens)
            finally:
                torch.use_deterministic_algorithms(False)
            if not torch.equal(loss_resumed, losses[i]):
                raise AssertionError(f"resumed step {i + 1} loss {float(loss_resumed)!r} != "
                                     f"{float(losses[i])!r}")
            del restored
        resume = {"resume_loss_bitwise_equal": True, "checkpoint_save_s": save_s,
                  "checkpoint_restore_s": restore_s, "resumed_step_deterministic": True}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state
    torch.cuda.empty_cache()
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses}")
    ms = statistics.median(step_ms)
    tokens_per_s = batch * T / (ms / 1e3)
    # bench.py model_mfu's count: fwd+bwd ~= 6 FLOPs/param/token + attention
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.d_model * T
    return {
        "params": n_params, "batch": batch, "seq": T, "remat": cfg.remat, "losses": losses,
        "step_ms": step_ms, "step_ms_median": ms, "tokens_per_s": tokens_per_s,
        "model_flops_per_token": flops_per_token,
        "flop_share_of_989_tflops": tokens_per_s * flops_per_token / PEAK_FLOPS["bfloat16"],
        "launches_per_step": launches, "launches_by_route_per_step": routes,
        "peak_mem_gb": peak_gb, **resume,
    }


def vit_config(torch):
    from ray_tpu_torch.models.vit import ViTConfig

    # ViT-B/16 (Dosovitskiy et al. 2021, Table 1) in the repo's recipe
    # (RMSNorm, SwiGLU, CLS token): 114,775,296 params; the flash kernels
    # non-causal at T = 197
    return ViTConfig(image_size=224, patch_size=16, channels=3, num_classes=1000,
                     d_model=768, n_layers=12, n_heads=12, d_ff=3072,
                     dtype=torch.bfloat16, attention="flash", remat=False)


def run_vit_train(torch, cfg, counters: dict, steps: int = 5, batch: int = 128):
    """One bf16 step's loss and gradients through the flash kernels against
    the einsum attention, both also against the f32 truth (f32 activations,
    einsum attention, TF32 off): the flash loss within 1e-2 of the einsum
    one, and each leaf's relative Frobenius error against the truth within
    2e-2 or within 1.5x the bf16 einsum path's own error, whichever is
    larger (at this depth and batch the bf16 einsum path itself is more
    than 2e-2 from the truth: PERF.md section 2). Then ``steps`` AdamW steps
    on a repeated batch:
    counters zeroed before and read after each (K3, K4 and K5 once a layer,
    all on the tensor cores), losses finite and falling; step ms (CUDA
    events), images/s and the model FLOP share of 989 TFLOP/s."""
    from ray_tpu_torch.models.transformer import new_train_state, value_and_grad
    from ray_tpu_torch.models.vit import init_vit_params, make_vit_train_step, vit_loss_fn

    g = torch.Generator(device="cuda").manual_seed(4)
    params = init_vit_params(cfg, g)
    n_params = sum(p.numel() for _, p in named_leaves(params))
    images = torch.randn(batch, cfg.image_size, cfg.image_size, cfg.channels, generator=g,
                         device="cuda")
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=g, device="cuda")
    L = cfg.n_layers
    want = {name: {"wgmma_bf16": L, "simt_f32": 0} for name in counters}

    zero_counters(counters)
    loss_k, grads_k = value_and_grad(lambda p: vit_loss_fn(cfg, p, images, labels), params)
    torch.cuda.synchronize()
    _, by_route = read_counters(counters)
    if by_route != want:
        raise AssertionError(f"vit parity step: routes {by_route}, want {want}")
    dense = dataclasses.replace(cfg, attention="dense")
    loss_p, grads_p = value_and_grad(lambda p: vit_loss_fn(dense, p, images, labels), params)
    loss_err = abs(float(loss_k) - float(loss_p))
    rel = grad_rel_errs(grads_k, grads_p)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    truth = dataclasses.replace(dense, dtype=torch.float32)
    loss_t, grads_t = value_and_grad(lambda p: vit_loss_fn(truth, p, images, labels), params)
    rel_flash, rel_dense = grad_rel_errs(grads_k, grads_t), grad_rel_errs(grads_p, grads_t)
    worse = {n: (rel_flash[n], rel_dense[n]) for n in rel_flash
             if rel_flash[n] > max(2e-2, 1.5 * rel_dense[n])}
    if not (math.isfinite(float(loss_k)) and loss_err <= 1e-2 and not worse):
        raise AssertionError(f"vit parity: loss {float(loss_k)} vs {float(loss_p)}; leaves "
                             f"whose flash error against f32 exceeds the limit: {worse}")
    del grads_k, grads_p, grads_t
    torch.cuda.empty_cache()

    _, train_step = make_vit_train_step(cfg, device="cuda")
    state = new_train_state(params)
    losses, step_ms, routes = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        zero_counters(counters)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        state, loss = train_step(state, images, labels)
        t1.record()
        torch.cuda.synchronize()
        _, by_route = read_counters(counters)
        if by_route != want:
            raise AssertionError(f"vit step {i + 1}: routes {by_route}, want {want}")
        losses.append(float(loss))
        step_ms.append(t0.elapsed_time(t1))
        routes.append(by_route)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"vit_train: losses {losses}")
    T = cfg.num_patches + 1
    ms = statistics.median(step_ms)
    # bench.py model_mfu's count per token (6 x params + attention), T tokens an image
    flops_per_step = batch * T * (6 * n_params + 12 * L * cfg.d_model * T)
    return {
        "params": n_params, "batch": batch, "seq": T, "remat": cfg.remat,
        "parity_loss_flash": float(loss_k), "parity_loss_dense": float(loss_p),
        "parity_loss_f32": float(loss_t), "parity_loss_abs_err": loss_err,
        "parity_grad_max_rel_err": max(rel.values()), "parity_grad_rel_err": rel,
        "parity_grad_rel_err_flash_vs_f32": rel_flash,
        "parity_grad_rel_err_dense_vs_f32": rel_dense,
        "losses": losses, "step_ms": step_ms, "step_ms_median": ms,
        "images_per_s": batch / (ms / 1e3), "model_flops_per_step": flops_per_step,
        "flop_share_of_989_tflops": flops_per_step / (ms / 1e3) / PEAK_FLOPS["bfloat16"],
        "launches_by_route_per_step": routes,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def dit_config(torch):
    from ray_tpu_torch.models.dit import DiTConfig

    # DiT-S/2 (Peebles & Xie 2023, Table 1) on 32x32x4 latents (256-pixel
    # images), 1000 classes: 32,914,560 params
    return DiTConfig(image_size=32, patch_size=2, channels=4, num_classes=1000, d_model=384,
                     n_layers=12, n_heads=6, mlp_ratio=4, dtype=torch.bfloat16)


def run_dit(torch, cfg, steps: int = 3, batch: int = 32, num: int = 8, ddim_steps: int = 10,
            guidance: float = 4.0):
    """``steps`` train steps and a guided DDIM sample (CUDA events; losses
    and samples finite), then the f32 forward on the card against the same
    on the CPU, on 2 images with every adaLN-Zero leaf drawn non-zero
    (atol 1e-4; no kernel is on this path)."""
    from ray_tpu_torch.models.dit import ddim_sample, dit_forward, make_dit_train_step
    from ray_tpu_torch.models.transformer import _leaves, _rebuild

    init_state, step = make_dit_train_step(cfg, device="cuda")
    state = init_state(5)
    params = state["params"]
    n_params = sum(p.numel() for _, p in named_leaves(params))
    g = torch.Generator(device="cuda").manual_seed(6)
    shape = (cfg.image_size, cfg.image_size, cfg.channels)
    images = torch.randn(batch, *shape, generator=g, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=g, device="cuda")
    losses, step_ms = [], []
    for _ in range(steps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        state, loss = step(state, images, labels, g)
        t1.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        step_ms.append(t0.elapsed_time(t1))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"dit: losses {losses}")
    sample_labels = torch.arange(num, device="cuda") % cfg.num_classes
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    x = ddim_sample(cfg, params, g, num=num, steps=ddim_steps, labels=sample_labels,
                    guidance_scale=guidance)
    t1.record()
    torch.cuda.synchronize()
    if x.shape != (num, *shape) or not torch.isfinite(x).all():
        raise AssertionError(f"dit: ddim sample {tuple(x.shape)}, finite "
                             f"{bool(torch.isfinite(x).all())}")
    sample_ms = t0.elapsed_time(t1)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = dict(params)
    layers = dict(params["layers"])
    for name in ("ada", "ada_b"):
        layers[name] = torch.randn(layers[name].shape, generator=g, device="cuda") * 0.02
    for name in ("final_ada", "final_ada_b", "head"):
        ref[name] = torch.randn(ref[name].shape, generator=g, device="cuda") * 0.02
    ref["layers"] = layers
    xs, ts = images[:2], torch.tensor([3, 700], device="cuda")
    with torch.no_grad():
        on_card = dit_forward(f32, ref, xs, ts, labels[:2])
        on_cpu = dit_forward(f32, _rebuild(ref, [t.cpu() for t in _leaves(ref)]), xs.cpu(),
                             ts.cpu(), labels[:2].cpu())
    err = max_err(on_card, on_cpu.cuda(), 1e-4, 0.0, "dit forward card vs cpu")
    if float(on_cpu.abs().max()) < 0.1:
        raise AssertionError("dit: the forward's output is too small to compare")
    return {
        "params": n_params, "batch": batch, "tokens_per_image": cfg.num_patches,
        "losses": losses, "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
        "ddim_images": num, "ddim_steps": ddim_steps, "guidance_scale": guidance,
        "ddim_ms": sample_ms, "ddim_ms_per_step": sample_ms / ddim_steps,
        "sample_abs_max": float(x.abs().max()), "forward_card_vs_cpu_max_abs_err": err,
    }


def profile_train_step(torch, cfg, params, batch: int = 6):
    """One train step (after a warm-up step) under ``torch.profiler``:
    device time by kernel, by group and by PyTorch op, and the device's busy
    share of the step."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.transformer import make_train_step, new_train_state

    _, train_step = make_train_step(cfg, device="cuda")
    state = new_train_state(params)
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=g,
                           device="cuda")
    state, _ = train_step(state, tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = train_step(state, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    groups = {}
    for name, t, _ in rows:
        if "rtt::" in name:  # the port's kernels, by kernel name
            group = re.search(r"::(\w+)<", name).group(1)
        elif any(w in name for w in ("nvjet", "gemm", "cutlass", "sm90_xmma")):
            group = "cublas_matmul"
        else:
            group = "other (elementwise, reductions, copies, optimizer)"
        groups[group] = groups.get(group, 0.0) + t
    busy = sum(r[1] for r in rows)
    # the same device time by the PyTorch op that launched it (the port's
    # kernels launch through ctypes, outside any op, and are not in this list)
    ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    ops.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
            "device_ms_by_group": groups,
            "device_ms_by_op": [{"op": n[:80], "device_ms": t, "calls": c} for n, t, c in ops[:20]],
            "top": [{"name": n[:120], "device_ms": t, "calls": c} for n, t, c in rows[:15]]}


# ---------------------------------------------------------------------------
# the parallel layer: ranks sharing the card over gloo
# ---------------------------------------------------------------------------
# the attention shards of the parallel phase's meshes on the train step of
# bench.py: {"sp": 2} gives each rank T/2 = 1024 rows of all 16 heads (the
# ring's steps), {"tp": 2} all 2048 rows of 8 heads
SHARD_ATTN = {"sp_causal": ((6, 16, 1024, 128), True),
              "sp_noncausal": ((6, 16, 1024, 128), False),
              "tp_causal": ((6, 8, 2048, 128), True)}
RING_GLOBAL = (6, 16, 2048, 128)  # part (b): the ring's global q/k/v
PARALLEL_TIMEOUT_S = 600.0
# the sharded steps' losses against one device's, relative: the sound runs
# read at most 4.6e-4 (the bf16 {"tp": 2} step 3, whose wo/w2 partial sums
# meet in a different order); the planted fault of part (e) must read above
# it
LOSS_RTOL = 2e-3


def attention_counters():
    from ray_tpu_torch.ops.attention import (
        flash_attention_backward_dkv,
        flash_attention_backward_dq,
        flash_attention_with_lse,
    )

    return {"flash_attention_forward": flash_attention_with_lse,
            "flash_attention_backward_dq": flash_attention_backward_dq,
            "flash_attention_backward_dkv": flash_attention_backward_dkv}


def shard_shape_kernels(torch, g) -> dict:
    """(a) K3, K4 and K5 at the parallel meshes' shard shapes, bf16: each
    launch against its plain version (atol = rtol = 2e-2, lse 1e-4), on the
    tensor-core route, timed beside SDPA (forward, and its backward for K4
    and K5) and the bound."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    atol, rtol = TOLS["bfloat16"]
    out = {}
    for name, ((B, H, T, D), causal) in SHARD_ATTN.items():
        q, k, v, g_out = (torch.randn(B, H, T, D, generator=g, device="cuda").to(torch.bfloat16)
                          for _ in range(4))
        scale = D ** -0.5
        before = dict(A.flash_attention_with_lse.launches_by_route)
        o, lse = A.flash_attention_with_lse(q, k, v, None, causal)
        check_route(A.flash_attention_with_lse, before, "bfloat16", f"parallel {name} K3")
        o_p, lse_p = A.flash_attention_with_lse(q, k, v, None, causal, use_kernel=False)
        err3 = max_err(o, o_p, atol, rtol, f"parallel {name} K3")
        max_err(lse, lse_p, 1e-4, 1e-5, f"parallel {name} K3 lse")
        a = (q, k, v, g_out, lse, A._delta(o, g_out, None), scale, causal, None)
        before = dict(A.flash_attention_backward_dq.launches_by_route)
        dq = A.flash_attention_backward_dq(*a)
        check_route(A.flash_attention_backward_dq, before, "bfloat16", f"parallel {name} K4")
        before = dict(A.flash_attention_backward_dkv.launches_by_route)
        dk, dv = A.flash_attention_backward_dkv(*a)
        check_route(A.flash_attention_backward_dkv, before, "bfloat16", f"parallel {name} K5")
        err4 = max_err(dq, A._bwd_dq_plain(*a), atol, rtol, f"parallel {name} K4")
        dk_p, dv_p = A._bwd_dkv_plain(*a)
        err5 = max(max_err(dk, dk_p, atol, rtol, f"parallel {name} K5 dk"),
                   max_err(dv, dv_p, atol, rtol, f"parallel {name} K5 dv"))
        del o_p, lse_p, dk_p, dv_p
        pairs, elem, side = attention_work(B, H, T, D, causal)
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        sdpa_bwd = device_ms(
            lambda: torch.autograd.grad(o_lib, (ql, kl, vl), g_out, retain_graph=True))
        out[name] = {
            "shape": f"q/k/v[{B},{H},{T},{D}] {'causal' if causal else 'non-causal'} bf16",
            "flash_attention_forward": dict(
                max_abs_err=err3,
                kernel_ms=device_ms(lambda: A.flash_attention_with_lse(q, k, v, None, causal)),
                plain_ms=device_ms(lambda: A._flash_forward_plain(q, k, v, scale, causal)),
                library_ms=device_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)),
                bound=bound(4 * elem + side, 4 * D * pairs, "bfloat16")),
            "flash_attention_backward_dq": dict(
                max_abs_err=err4, kernel_ms=device_ms(lambda: A.flash_attention_backward_dq(*a)),
                plain_ms=device_ms(lambda: A._bwd_dq_plain(*a)), library_ms=sdpa_bwd,
                bound=bound(5 * elem + 2 * side, 6 * D * pairs, "bfloat16")),
            "flash_attention_backward_dkv": dict(
                max_abs_err=err5,
                kernel_ms=device_ms(lambda: A.flash_attention_backward_dkv(*a)),
                plain_ms=device_ms(lambda: A._bwd_dkv_plain(*a)), library_ms=sdpa_bwd,
                bound=bound(6 * elem + 2 * side, 8 * D * pairs, "bfloat16")),
        }
        for r in out[name].values():
            if isinstance(r, dict):
                r["bound_ms"], r["bound_by"] = r.pop("bound")
        del q, k, v, g_out, o, lse, a, dq, dk, dv, ql, kl, vl, o_lib
        torch.cuda.empty_cache()
    return out


def rel_frobenius(torch, got, want) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite values")
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def _ring_rank(shape, seed: int):
    """(b) One rank of ``ring_attention_sharded`` on a causal bf16 global
    q/k/v: forward and backward with the launches counted, then (rank 0)
    the gathered output and gradients against ``flash_attention`` on the
    full tensors in this process."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel import MeshManager, collective, gather_array, shard_array
    from ray_tpu_torch.parallel import ring_attention_sharded

    counters = attention_counters()
    mesh = MeshManager().create_mesh({"sp": dist.get_world_size()})
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g_out = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                      for _ in range(4))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    with mesh:
        g_local = shard_array(g_out, mesh, None, None, "sp", None)
    collective.reset_staged()
    zero_counters(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ring_attention_sharded(*ins, mesh, "sp", causal=True)
    out.backward(g_local)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, routes = read_counters(counters)
    staged = dict(collective.staged)
    with mesh:  # each rank holds its share of each full gradient
        grads = [collective.allreduce(t.grad.float(), "sp") for t in ins]
    full = gather_array(out.detach(), mesh, None, None, "sp", None)
    rep = {"rank": dist.get_rank(), "launches": launches, "launches_by_route": routes,
           "staged_bytes": staged, "fwd_bwd_s": seconds}
    if dist.get_rank() == 0:
        ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = flash_attention(*ref_ins, None, True)
        ref.backward(g_out)
        atol, rtol = TOLS["bfloat16"]
        rep["out_max_abs_err"] = max_err(full, ref.detach(), atol, rtol, "ring output")
        rep["grad_rel_err"] = {n: rel_frobenius(torch, gr, r.grad)
                               for n, gr, r in zip("qkv", grads, ref_ins)}
    return rep


def _train_rank(cfg_kw: dict, axes: dict, step_kw: dict, steps: int, batch: int,
                skip_axis: Optional[str] = None):
    """(c), (d) One rank of the sharded train step: the params drawn from
    the train phase's seed (cuda generator 0), the train phase's tokens
    (cuda generator 3), ``steps`` AdamW steps with the counters zeroed
    before and read after each. ``skip_axis`` plants a fault: the step's
    gradient sum over the replicas of each leaf leaves that axis out."""
    import types

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig, make_train_step
    from ray_tpu_torch.parallel import MeshManager, collective

    if skip_axis is not None:
        sound = transformer.sum_replicas_

        def without_axis(grads, specs, mesh):
            names = tuple(a for a in mesh.axis_names if a != skip_axis)
            sound(grads, specs, types.SimpleNamespace(axis_names=names, shape=mesh.shape,
                                                      group=mesh.group))

        transformer.sum_replicas_ = without_axis

    free_before = torch.cuda.mem_get_info()[0]
    counters = attention_counters()
    cfg = TransformerConfig(**cfg_kw, dtype=torch.bfloat16)
    mesh = MeshManager().create_mesh(axes)
    init_state, step = make_train_step(cfg, mesh=mesh, **step_kw)
    state = init_state(0)
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=g,
                           device="cuda")
    local = step.shard_batch(tokens)
    torch.cuda.reset_peak_memory_stats()
    collective.reset_staged()
    losses, step_ms, launches, routes = [], [], [], []
    for _ in range(steps):
        zero_counters(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, local)
        losses.append(float(loss))  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
        n, r = read_counters(counters)
        launches.append(n)
        routes.append(r)
    return {"rank": dist.get_rank(), "coords": mesh.coords(), "losses": losses,
            "step_ms": step_ms, "launches_per_step": launches,
            "launches_by_route_per_step": routes,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "free_gb_before": free_before / 1e9,
            "staged_bytes_per_step": {k: x / steps for k, x in collective.staged.items()}}


def _nccl_rank():
    """(d) The collective layer's ops on a world-size-1 NCCL group."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshManager, collective as C

    if dist.get_backend() != "nccl":
        raise AssertionError(f"backend {dist.get_backend()}")
    mesh = MeshManager().create_mesh({"x": 1})
    x = torch.arange(8.0, device="cuda").reshape(2, 4)
    with mesh:
        got = {"allreduce": C.allreduce(x, "x"), "allreduce_mean": C.allreduce_mean(x, "x"),
               "allgather": C.allgather(x, "x"), "reducescatter": C.reducescatter(x, "x"),
               "broadcast": C.broadcast(x, "x"), "all_to_all": C.all_to_all(x, "x", 0, 1),
               "ppermute": C.ppermute(x, "x", [(0, 0)]), "send_recv": C.send_recv(x, "x")}
        barrier = int(C.barrier("x"))
    torch.cuda.synchronize()
    bad = [n for n, y in got.items() if not (y.is_cuda and torch.equal(y, x))]
    if bad or barrier != 0:
        raise AssertionError(f"nccl world size 1: {bad}, barrier {barrier}")
    return {"backend": "nccl", "ops": sorted(got) + ["barrier"]}


def one_device_losses(torch, cfg_kw: dict, steps: int, batch: int) -> list:
    """The losses of ``steps`` one-device steps from the parallel ranks'
    seed and tokens."""
    from ray_tpu_torch.models.transformer import TransformerConfig, make_train_step

    cfg = TransformerConfig(**cfg_kw, dtype=torch.bfloat16)
    init_state, step = make_train_step(cfg, device="cuda")
    state = init_state(0)
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=g,
                           device="cuda")
    losses = [float(step(state, tokens)[1]) for _ in range(steps)]
    del state
    torch.cuda.empty_cache()
    return losses


def check_launches(rep: dict, want: dict, what: str) -> None:
    """Every step of a rank launched K3/K4/K5 ``want`` times, all on the
    tensor cores."""
    for n, routes in zip(rep["launches_per_step"], rep["launches_by_route_per_step"]):
        if n != want or any(r["simt_f32"] for r in routes.values()):
            raise AssertionError(f"{what} rank {rep['rank']}: launches {n} {routes}, want {want}")


def warm_median(reps: list) -> float:
    """The median step ms over every rank's steps after its first (the
    first also sets up the group's connections and the allocator)."""
    return statistics.median(x for rep in reps for x in rep["step_ms"][1:])


def loss_gaps(got: list, want: list) -> list:
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def check_losses(got: list, want: list, what: str) -> list:
    rel = loss_gaps(got, want)
    if len(got) != len(want) or not all(math.isfinite(x) for x in got) or max(rel) > LOSS_RTOL:
        raise AssertionError(f"{what}: losses {got} vs one device {want}")
    return rel


def run_parallel(torch):
    """The parallel phase: (a) the shard shapes' kernels; (b) ring attention
    on 2 ranks; (c) the full-width 602M step at ``CUT_LAYERS`` layers on
    {"sp": 2} (ring) and {"tp": 2} (flash); (d) {"dp": 2, "sp": 2} at 2 layers, a 2-rank
    {"ep": 2} MoE step, and a world-size-1 NCCL group; (e) a planted fault
    the loss limit must catch. The ranks are
    processes sharing ``cuda:0`` over gloo (the caller names the backend:
    NCCL refuses two ranks on one GPU); gloo carries their collectives
    through host memory, so the step times measure the mechanism, not
    scaling. Yields each part's report as it ends."""
    from ray_tpu_torch.parallel import run_ranks

    g = torch.Generator(device="cuda").manual_seed(11)
    t0 = time.perf_counter()
    shards = shard_shape_kernels(torch, g)
    yield {"part": "a", "shard_shapes": shards, "seconds": time.perf_counter() - t0}

    def ranks(fn, n, *args):
        torch.cuda.empty_cache()
        print(f"backend: gloo, {n} ranks on one card", flush=True)
        return run_ranks(fn, n, *args, timeout_s=PARALLEL_TIMEOUT_S, device="cuda",
                         backend="gloo")

    def show(rep: dict) -> None:
        print(f"rank {rep['rank']}: launches by route "
              f"{rep.get('launches_by_route', rep.get('launches_by_route_per_step'))}, "
              f"bytes staged through the host {rep.get('staged_bytes', rep.get('staged_bytes_per_step'))}",
              flush=True)

    # (b) ring attention: rank r launches r + 1 of K3, K4 and K5
    t0 = time.perf_counter()
    ring = ranks(_ring_rank, 2, RING_GLOBAL, 5)
    for rep in ring:
        show(rep)
        r = rep["rank"]
        want = {k: r + 1 for k in attention_counters()}
        if rep["launches"] != want or any(x["simt_f32"] for x in rep["launches_by_route"].values()):
            raise AssertionError(f"ring rank {r}: launches {rep['launches_by_route']}, want {want}")
    if max(ring[0]["grad_rel_err"].values()) > 2e-2:
        raise AssertionError(f"ring gradients: {ring[0]['grad_rel_err']}")
    yield {"part": "b", "global_shape": "q/k/v[{},{},{},{}] causal bf16".format(*RING_GLOBAL),
           "ranks": ring, "seconds": time.perf_counter() - t0}

    # (c) the 602M train step's widths on two meshes, at CUT_LAYERS layers
    # (the script's time: 8 layers took 89 s of the phase), held to one
    # device's losses at the same depth, which (d) and (e) are held to too
    tc = dataclasses.asdict(train_config(torch))
    tc.pop("dtype")
    tc.pop("param_dtype")
    small = dict(tc, n_layers=CUT_LAYERS)
    L, T, batch, steps = CUT_LAYERS, tc["max_seq_len"], 6, 3
    ring_want = one_device_losses(torch, dict(small, attention="flash"), steps, batch)
    for axes, attention in (({"sp": 2}, "ring"), ({"tp": 2}, "flash")):
        t0 = time.perf_counter()
        reps = ranks(_train_rank, 2, dict(small, attention=attention), axes, {}, steps, batch)
        for rep in reps:
            show(rep)
            j = rep["coords"].get("sp", 0) + 1 if attention == "ring" else 1
            check_launches(rep, {"flash_attention_forward": 2 * j * L,
                                 "flash_attention_backward_dq": j * L,
                                 "flash_attention_backward_dkv": j * L}, f"{axes}")
        rel = check_losses(reps[0]["losses"], ring_want, f"{axes} {attention}")
        ms = warm_median(reps)
        yield {"part": "c", "mesh": axes, "attention": attention, "layers": L, "batch": batch,
               "seq": T, "losses": reps[0]["losses"], "one_device_losses": ring_want,
               "loss_rel_err": rel, "step_ms_median": ms, "tokens_per_s": batch * T / (ms / 1e3),
               "ranks": reps, "seconds": time.perf_counter() - t0,
               "note": "two ranks share one card and gloo carries the collectives through "
                       "host memory: the mechanism, not scaling"}

    # (d) four ranks at 2 layers, the expert-parallel MoE step, NCCL
    t0 = time.perf_counter()
    reps = ranks(_train_rank, 4, dict(small, attention="ring"), {"dp": 2, "sp": 2}, {},
                 steps, batch)
    for rep in reps:
        show(rep)
        j = rep["coords"]["sp"] + 1
        check_launches(rep, {"flash_attention_forward": 4 * j, "flash_attention_backward_dq": 2 * j,
                             "flash_attention_backward_dkv": 2 * j}, "dp2 sp2")
    rel = check_losses(reps[0]["losses"], ring_want, "dp2 sp2 ring")
    ms = warm_median(reps)
    yield {"part": "d", "mesh": {"dp": 2, "sp": 2}, "attention": "ring", "layers": 2,
           "losses": reps[0]["losses"], "one_device_losses": ring_want, "loss_rel_err": rel,
           "step_ms_median": ms, "ranks": reps, "seconds": time.perf_counter() - t0}
    moe = dict(small, attention="flash", num_experts=8, expert_top_k=2)
    t0 = time.perf_counter()
    want = one_device_losses(torch, moe, steps, batch)
    reps = ranks(_train_rank, 2, moe, {"ep": 2}, {"ep": "ep"}, steps, batch)
    for rep in reps:
        show(rep)
        check_launches(rep, {"flash_attention_forward": 4, "flash_attention_backward_dq": 2,
                             "flash_attention_backward_dkv": 2}, "ep2 moe")
    rel = check_losses(reps[0]["losses"], want, "ep2 moe")
    ms = warm_median(reps)
    yield {"part": "d", "mesh": {"ep": 2}, "attention": "flash", "layers": 2, "num_experts": 8,
           "expert_top_k": 2, "dispatch": "dense", "losses": reps[0]["losses"],
           "one_device_losses": want, "loss_rel_err": rel, "step_ms_median": ms,
           "ranks": reps, "seconds": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    nccl = run_ranks(_nccl_rank, 1, timeout_s=120.0, device="cuda", backend="nccl")[0]
    yield {"part": "d", "nccl_world_size_1": nccl}
    # (e) the planted fault; its launches stay out of the main path's counts
    t0 = time.perf_counter()
    reps = ranks(_train_rank, 2, dict(small, attention="ring"), {"sp": 2}, {}, steps, batch,
                 "sp")
    gaps = [loss_gaps(rep["losses"], ring_want) for rep in reps]
    if not all(max(g) > LOSS_RTOL for g in gaps):
        raise AssertionError(f"the planted fault passed the {LOSS_RTOL} limit: {gaps}")
    yield {"part": "e", "mesh": {"sp": 2}, "attention": "ring", "layers": 2,
           "fault": "no gradient sum over sp", "one_device_losses": ring_want,
           "losses_by_rank": [rep["losses"] for rep in reps], "loss_rel_err_by_rank": gaps,
           "loss_rtol": LOSS_RTOL, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the tensor-parallel engine: LLMEngine(mesh=) on ranks that share the card
# ---------------------------------------------------------------------------
TP_SERVE_TIMEOUT_S = 600.0
TP_F32_PROMPTS = 4


def _tp_burst(eng, prompts, max_tokens: int):
    """The burst through ``eng`` (one streaming client a prompt): tokens,
    TTFT per request, wall seconds."""
    results, ttft = [None] * len(prompts), [None] * len(prompts)

    def client(i):
        t0 = time.perf_counter()
        toks = []
        for tok in eng.submit_stream(prompts[i], max_tokens=max_tokens):
            if not toks:
                ttft[i] = time.perf_counter() - t0
            toks.append(tok)
        results[i] = toks

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    for i, r in enumerate(results):
        if r is None or len(r) != max_tokens:
            raise AssertionError(f"tp_serve request {i} returned {r!r}")
    return results, ttft, wall


def _tp_serve_rank(max_tokens: int):
    """One rank of the tp_serve phase. Every rank builds the same engine
    from the serving decoder's seed; rank 0 drives it and also runs the
    single-device dense engine it is held to, the others follow. Returns
    this rank's report (rank 0's with the tokens and numbers)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models.generation import forward_with_cache, init_cache
    from ray_tpu_torch.models.transformer import _layout, init_params
    from ray_tpu_torch.ops.attention import (
        flash_attention_backward_dkv,
        flash_attention_backward_dq,
        flash_attention_with_lse,
    )
    from ray_tpu_torch.ops.decode_attention import decode_attention, paged_decode_attention
    from ray_tpu_torch.ops.quantization import int8_matmul
    from ray_tpu_torch.parallel import MeshManager, collective
    from ray_tpu_torch.parallel.mesh import shard_tree
    from ray_tpu_torch.serve.llm import LLMEngine

    counters = {"paged_decode_attention": paged_decode_attention,
                "decode_attention": decode_attention,
                "flash_attention_forward": flash_attention_with_lse,
                "flash_attention_backward_dq": flash_attention_backward_dq,
                "flash_attention_backward_dkv": flash_attention_backward_dkv,
                "int8_matmul": int8_matmul}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    mesh = MeshManager().create_mesh({"tp": dist.get_world_size()})
    rep = {"rank": rank}
    kw = dict(device="cuda", max_batch_size=8, cache_kind="dense")

    # (a) f32: the shards' prefill logits, then the greedy tokens
    # the serving decoder's widths at CUT_LAYERS layers (the script's time)
    cfg = dataclasses.replace(serving_config(torch), dtype=torch.float32, n_layers=CUT_LAYERS)
    kw["max_seq_len"] = cfg.max_seq_len
    full = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompts = burst_prompts(cfg, TP_F32_PROMPTS, 64)
    toks = torch.tensor(prompts[:1], device="cuda")
    pos = torch.arange(toks.shape[1], device="cuda")[None, :]
    lay = _layout(cfg, mesh, dp=None, sp=None, tp="tp")
    shards = shard_tree(full, lay.specs, mesh)
    zero_counters(counters)
    with torch.inference_mode():
        tp_logits, _ = forward_with_cache(cfg, shards, init_cache(cfg, 1, 64, device="cuda",
                                                                  lay=lay),
                                          toks, pos, use_decode_kernel=False, lay=lay)
    del shards
    eng = LLMEngine(cfg, full, mesh=mesh, **kw)
    if rank != 0:
        eng.follow()
    else:
        try:
            tp_tokens = [f.result(timeout=600)
                         for f in [eng.submit(p, max_tokens=max_tokens) for p in prompts]]
        finally:
            eng.shutdown()
    rep["f32_launches"], _ = read_counters(counters)
    del eng
    if rank == 0:
        with torch.inference_mode():
            one_logits, _ = forward_with_cache(cfg, full, init_cache(cfg, 1, 64, device="cuda"),
                                               toks, pos, use_prefill_kernel=True)
        one = LLMEngine(cfg, full, **kw)
        try:
            one_tokens = [f.result(timeout=600)
                          for f in [one.submit(p, max_tokens=max_tokens) for p in prompts]]
        finally:
            one.shutdown()
        rep.update(f32_prefill_max_abs_err=float((tp_logits - one_logits).abs().max()),
                   f32_tokens=tp_tokens, f32_one_device_tokens=one_tokens)
        del one, one_logits
    del full, tp_logits
    torch.cuda.empty_cache()

    # (b) bf16: the engine phase's burst, the tp engine and one device
    cfg = dataclasses.replace(serving_config(torch), n_layers=CUT_LAYERS)
    full = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompts = burst_prompts(cfg, 8, 64)
    eng = LLMEngine(cfg, full, mesh=mesh, **kw)
    zero_counters(counters)
    if rank != 0:
        eng.follow()
        rep["bf16_launches"], _ = read_counters(counters)
        return rep
    try:
        eng.generate([5] * 64, max_tokens=2)  # warm-up: every rank's first forward
        decode_calls = [0]
        step = {"collectives": {}, "host_bytes": {}, "broadcasts": 0, "broadcast_bytes": 0}
        decode_k = eng._decode_k

        def counted(*a):
            # what one decode call carries: the model's collectives and the
            # bytes of CUDA tensors they move through the host, the step
            # channel's broadcasts (only the loop thread runs collectives)
            c0, s0 = dict(collective.calls), dict(collective.staged)
            b0, y0 = eng._tp.broadcasts, eng._tp.bytes
            out = decode_k(*a)
            for key, now, was in (("collectives", collective.calls, c0),
                                  ("host_bytes", collective.staged, s0)):
                for k, x in now.items():
                    step[key][k] = step[key].get(k, 0) + x - was.get(k, 0)
            step["broadcasts"] += eng._tp.broadcasts - b0
            step["broadcast_bytes"] += eng._tp.bytes - y0
            decode_calls[0] += 1
            return out

        eng._decode_k = counted
        collective.reset_staged()
        torch.cuda.synchronize()
        tokens, ttft, wall = _tp_burst(eng, prompts, max_tokens)
    finally:
        eng.shutdown()
    rep["bf16_launches"], _ = read_counters(counters)
    del eng
    torch.cuda.empty_cache()
    one = LLMEngine(cfg, full, **kw)
    try:
        one.generate([5] * 64, max_tokens=2)
        torch.cuda.synchronize()
        one_tokens, one_ttft, one_wall = _tp_burst(one, prompts, max_tokens)
    finally:
        one.shutdown()
    n_tok = sum(len(r) for r in tokens)
    rep.update(
        bf16_tokens_per_s=n_tok / wall, bf16_ttft_s_median=statistics.median(ttft),
        bf16_ttft_s_max=max(ttft), bf16_wall_s=wall, bf16_decode_steps=decode_calls[0],
        bf16_one_device_tokens_per_s=n_tok / one_wall,
        bf16_one_device_ttft_s_median=statistics.median(one_ttft),
        bf16_one_device_ttft_s_max=max(one_ttft),
        bf16_tokens_equal_one_device=sum(a == b for a, b in zip(tokens, one_tokens)),
        per_decode_step={
            "collectives": {k: x / decode_calls[0] for k, x in step["collectives"].items()},
            "collectives_total": sum(step["collectives"].values()) / decode_calls[0],
            "host_bytes": {k: x / decode_calls[0] for k, x in step["host_bytes"].items()},
            "host_bytes_total": sum(step["host_bytes"].values()) / decode_calls[0],
            "step_broadcasts": step["broadcasts"] / decode_calls[0],
            "step_broadcast_bytes": step["broadcast_bytes"] / decode_calls[0]})
    return rep


def run_tp_serve(torch, card: str):
    """The tp_serve phase: two ranks on the card (gloo), (a) f32 parity,
    (b) the bf16 burst, (c) nothing left after. Yields each part."""
    import multiprocessing

    from ray_tpu_torch.parallel import run_ranks

    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    print("backend: gloo, 2 ranks on one card (tp_serve)", flush=True)
    reps = run_ranks(_tp_serve_rank, 2, 32, timeout_s=TP_SERVE_TIMEOUT_S, device="cuda",
                     backend="gloo")
    seconds = time.perf_counter() - t0
    r0 = reps[0]
    for r in reps:
        for part in ("f32_launches", "bf16_launches"):
            if any(r[part].values()):
                raise AssertionError(f"tp_serve rank {r['rank']}: kernels launched on the tp "
                                     f"path: {r[part]}")
    if r0["f32_prefill_max_abs_err"] > 1e-3:
        raise AssertionError(f"tp_serve f32 prefill logits {r0['f32_prefill_max_abs_err']} "
                             "from the single-device engine's")
    if r0["f32_tokens"] != r0["f32_one_device_tokens"]:
        raise AssertionError(f"tp_serve f32 tokens {r0['f32_tokens']} != one device's "
                             f"{r0['f32_one_device_tokens']}")
    yield {"part": "a", "card": card, "mesh": {"tp": 2}, "dtype": "float32",
           "prompts": TP_F32_PROMPTS, "prompt_len": 64, "max_tokens": 32,
           "prefill_max_abs_err": r0["f32_prefill_max_abs_err"], "tokens_equal_one_device": True,
           "launches_by_rank": [r["f32_launches"] for r in reps]}
    yield {"part": "b", "card": card, "mesh": {"tp": 2}, "dtype": "bfloat16", "requests": 8,
           "prompt_len": 64, "max_tokens": 32,
           **{k.removeprefix("bf16_"): x for k, x in r0.items()
              if k.startswith("bf16_") and k != "bf16_launches"},
           "per_decode_step": r0["per_decode_step"],
           "launches_by_rank": [r["bf16_launches"] for r in reps], "seconds": seconds,
           "note": "two ranks share one card and gloo carries every collective through "
                   "host memory: the mechanism, not scaling"}
    alive = multiprocessing.active_children()
    torch.cuda.empty_cache()
    held = free0 - torch.cuda.mem_get_info()[0]
    if alive or torch.distributed.is_initialized() or held > RUNTIME_MEMORY_SLACK:
        raise AssertionError(f"after tp_serve: ranks {alive} alive, process group "
                             f"{torch.distributed.is_initialized()}, {held} device bytes held")
    yield {"part": "c", "card": card, "ranks_left": 0, "process_group": False,
           "device_bytes_held_after": held,
           "launches": {n: sum(r["f32_launches"][n] + r["bf16_launches"][n] for r in reps)
                        for n in reps[0]["f32_launches"]}}


# --------------------------------------------------------------------------
# the trainer phase: the training library on the 602M step
# --------------------------------------------------------------------------
TRAINER_SEED = 16
TRAINER_TABLE = (24, 2048)  # (a): four batches of the train phase's [6, 2048]
TRAINER_BATCH = 6
TRAINER_STEPS = 4
TRAINER_GANG_ROWS = (16, 2048)  # (b): token rows as float32, one a member a step
TRAINER_GANG_LR = 1e-2
TRAINER_AR_BYTES = 64 << 20  # (d): the allreduced f32 tensor
TRAINER_AR_REPS = 10


def attention_want(n_layers: int) -> dict:
    """K3/K4/K5 launches of one 602M step (``remat="dots"``), by route."""
    return {"flash_attention_forward": {"wgmma_bf16": 2 * n_layers, "simt_f32": 0},
            "flash_attention_backward_dq": {"wgmma_bf16": n_layers, "simt_f32": 0},
            "flash_attention_backward_dkv": {"wgmma_bf16": n_layers, "simt_f32": 0}}


def counter_delta(before, after):
    (n0, r0), (n1, r1) = before, after
    return ({k: n1[k] - n0[k] for k in n1},
            {k: {r: r1[k][r] - r0[k].get(r, 0) for r in r1[k]} for k in r1})


def check_per_call(what: str, delta, calls: int, want: dict) -> None:
    """``delta`` (launches, routes) is ``calls`` times one step's ``want``."""
    n, routes = delta
    want_routes = {k: {r: x * calls for r, x in per.items()} for k, per in want.items()}
    want_n = {k: sum(per.values()) for k, per in want_routes.items()}
    if n != want_n or routes != want_routes:
        raise AssertionError(f"trainer {what}: launches {n} {routes} over {calls} member "
                             f"steps, want {want_routes}")


def trainer_user_loop(torch, rt, cfg, counters: dict, card: str, train_step_ms) -> dict:
    """(a): ``DeviceTrainer`` with one GPU rank: the 602M step over
    ``iter_device_batches`` of a seeded token table, a framed checkpoint of
    the train state at step 2, one injected failure, the restart from that
    checkpoint on to step 4; the four losses bitwise those of a direct
    ``make_train_step`` from the same state on the same batches
    (deterministic algorithms on for both); K3/K4/K5 16/8/8 a step."""
    import shutil

    import numpy as np

    from ray_tpu_torch import train
    from ray_tpu_torch.models.transformer import make_train_step

    table = np.random.default_rng(TRAINER_SEED).integers(0, cfg.vocab_size, TRAINER_TABLE,
                                                         dtype=np.int32)
    want = attention_want(cfg.n_layers)
    log = {"steps": {}, "t": {}}
    tmp = tempfile.mkdtemp(prefix="trainer_a_")

    def loop(config):
        ctx = train.get_context()
        dev = ctx.get_devices()[0]
        init_state, step = make_train_step(cfg, device=dev)
        ckpt = train.get_checkpoint()
        if ckpt is None:
            state, start = init_state(TRAINER_SEED), 0
        else:
            log["t"]["restart_begin"] = time.perf_counter()
            t0 = time.perf_counter()
            state = ckpt.to_pytree(device=dev)
            torch.cuda.synchronize()
            log["t"]["restore_s"] = time.perf_counter() - t0
            start = int(state["step"])
        shard = train.get_dataset_shard("train")
        batches = shard.iter_device_batches(batch_size=TRAINER_BATCH,
                                            dtypes={"data": torch.int64}, device=dev,
                                            drop_last=True)
        for i, batch in enumerate(batches):
            if i < start:
                continue
            before = read_counters(counters)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            state, loss = step(state, batch["data"])
            e1.record()
            torch.cuda.synchronize()
            log["steps"][i + 1] = {"loss": float(loss), "ms": e0.elapsed_time(e1),
                                   "delta": counter_delta(before, read_counters(counters)),
                                   "device": str(batch["data"].device),
                                   "attempt": ctx.get_restart_count()}
            out = None
            if i + 1 == 2 and ctx.get_restart_count() == 0:
                t0 = time.perf_counter()
                out = train.Checkpoint.from_pytree(state, base_dir=tmp)
                log["t"]["save_s"] = time.perf_counter() - t0
            train.report({"step": i + 1, "loss": float(loss)}, checkpoint=out)
            if out is not None:
                time.sleep(1.0)  # the driver drains reports every 0.2 s
                log["t"]["raise"] = time.perf_counter()
                raise RuntimeError("injected failure after the step-2 checkpoint")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True)
    try:
        ds = rt.data.from_numpy(table)
        trainer = train.DeviceTrainer(
            loop, scaling_config=train.ScalingConfig(num_workers=1), datasets={"train": ds},
            run_config=train.RunConfig(name="trainer-a", storage_path=tmp,
                                       failure_config=train.FailureConfig(max_failures=1)))
        zero_counters(counters)
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
        launches, by_route = read_counters(counters)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        init_state, step = make_train_step(cfg, device="cuda")
        state = init_state(TRAINER_SEED)
        direct, direct_ms = [], []
        for i in range(TRAINER_STEPS):
            batch = torch.from_numpy(table[i * TRAINER_BATCH:(i + 1) * TRAINER_BATCH]).to("cuda").long()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            state, loss = step(state, batch)
            e1.record()
            torch.cuda.synchronize()
            direct.append(float(loss))
            direct_ms.append(e0.elapsed_time(e1))
        del state
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    steps = [log["steps"].get(i + 1) for i in range(TRAINER_STEPS)]
    if result.error is not None or None in steps or "restore_s" not in log["t"]:
        raise AssertionError(f"trainer (a): error {result.error!r}, steps {sorted(log['steps'])}, "
                             f"times {log['t']}")
    losses = [s["loss"] for s in steps]
    if losses != direct or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"trainer (a): losses {losses} through the trainer, {direct} direct")
    if [s["attempt"] for s in steps] != [0, 0, 1, 1] or result.metrics.get("step") != 4 \
            or any(s["device"] != "cuda:0" for s in steps):
        raise AssertionError(f"trainer (a): steps {steps}, metrics {result.metrics}")
    for i, s in enumerate(steps):
        check_per_call(f"(a) step {i + 1}", s["delta"], 1, want)
    check_per_call("(a) fit", (launches, by_route), TRAINER_STEPS, want)
    ms = [s["ms"] for s in steps]
    return {"part": "a_device_trainer", "card": card, "n_layers": cfg.n_layers,
            "table": list(TRAINER_TABLE),
            "batch": TRAINER_BATCH, "steps": TRAINER_STEPS, "losses": losses,
            "losses_bitwise_equal_direct": True, "attempts": [s["attempt"] for s in steps],
            "step_ms": ms, "step_ms_median": statistics.median(ms),
            "direct_step_ms": direct_ms, "direct_step_ms_median": statistics.median(direct_ms),
            "train_phase_step_ms_median": train_step_ms,
            "checkpoint_save_s": log["t"]["save_s"], "checkpoint_restore_s": log["t"]["restore_s"],
            "restart_wall_s": log["t"]["restart_begin"] - log["t"]["raise"], "fit_s": fit_s,
            "peak_mem_gb": peak_gb, "launches": launches, "launches_by_route": by_route,
            "launches_per_step": [s["delta"][0] for s in steps]}


def gang_loss(torch, cfg):
    """(b)'s ``loss_fn`` and ``param_init`` over the 602M decoder's flat f32
    row: the leaves are views of it (in ``named_leaves`` order), the loss
    the batch's mean next-token loss times its rows (the sum the controller
    wants), the tokens the batch's float32 values."""
    from ray_tpu_torch.models.transformer import init_params, loss_fn

    def draw(seed):
        return init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))

    specs = [(name, tuple(p.shape)) for name, p in named_leaves(draw(0))]
    sizes = [math.prod(shape) for _, shape in specs]
    torch.cuda.empty_cache()

    def unflatten(flat):
        tree = {}
        for (name, shape), leaf in zip(specs, torch.split(flat, sizes)):
            *parents, last = name.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = leaf.view(shape)
        return tree

    def param_init(seed):
        return torch.cat([p.reshape(-1) for _, p in named_leaves(draw(seed))])

    def loss(flat, batch):
        return loss_fn(cfg, unflatten(flat), batch.long()) * batch.shape[0]

    return loss, param_init, sum(sizes)


def timed_steps(ctl, n: int) -> list:
    """``n`` controller steps, wall ms each (a step ends on the loss's
    ``.item()``, a device sync)."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        ctl.step()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def trainer_gang(torch, rt, cfg, counters: dict, card: str) -> dict:
    """(b): ``TrainController`` gangs of in-process GPU actors on the 602M
    loss over the flat row, one 2048-token row a member a step: 4 steps at
    world 1 and at world 2 from the same seed (the curves within
    ``LOSS_RTOL``); then member 1 killed after the step-2 checkpoint
    (``preempt_member(graceful=False)``): the typed error, ``recover()``,
    2 more steps bitwise ``replay``'s, invariant 12 green."""
    import shutil

    import numpy as np

    from ray_tpu_torch import exceptions
    from ray_tpu_torch.chaos import invariants
    from ray_tpu_torch.train import TrainController

    want = attention_want(cfg.n_layers)
    loss, param_init, n_params = gang_loss(torch, cfg)
    rows = np.random.default_rng(TRAINER_SEED + 1).integers(
        0, cfg.vocab_size, TRAINER_GANG_ROWS).astype(np.float32)
    tmp = tempfile.mkdtemp(prefix="trainer_b_")
    main_n, main_r = {k: 0 for k in counters}, {k: {} for k in counters}
    calls, warm, gpu_held = {}, {}, {}

    def account(name: str, n_calls: int, delta) -> None:
        """``delta``'s launches must be its ``n_calls`` member steps'
        (16/8/8 each); they add to the main path's counts."""
        calls[name] = n_calls
        check_per_call(f"(b) {name}", delta, n_calls, want)
        n, routes = delta
        for k in n:
            main_n[k] += n[k]
            for r, x in routes[k].items():
                main_r[k][r] = main_r[k].get(r, 0) + x

    def segment(name: str, ctl, fn):
        zero_counters(counters)
        c0 = ctl.step_fn.calls
        out = fn()
        account(name, ctl.step_fn.calls - c0, read_counters(counters))
        return out

    def build(key: str, name: str, world: int, **extra):
        """A controller; its construction warms every member up once."""
        zero_counters(counters)
        free = rt.available_resources().get("GPU", 0)
        box[key] = TrainController(name, world_size=world, dataset=ds,
                                   checkpoint_dir=os.path.join(tmp, key), **extra, **kw)
        gpu_held[key] = free - rt.available_resources().get("GPU", 0)
        delta = read_counters(counters)
        account(f"{key}_warmup", box[key].step_fn.calls, delta)
        warm[key] = delta[0]
        return box[key]

    kw = dict(batch_size=2, seed=TRAINER_SEED, learning_rate=TRAINER_GANG_LR, loss_fn=loss,
              param_init=param_init, checkpoint_period=10**9, device="cuda")
    box = {}
    # what earlier parts left on the card, before and after a collection
    # of reference cycles (a failed attempt's frames, say)
    held_gb = torch.cuda.memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    held_after_gc_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True)
    try:
        ds = rt.data.from_numpy(rows)
        baseline = invariants.snapshot_baseline()
        one = build("w1", "gang602m-w1", 1)
        w1_ms = segment("w1_steps", one, lambda: timed_steps(one, 4))
        w1_losses = one.losses()
        box.pop("w1").shutdown()
        del one
        torch.cuda.empty_cache()
        # world 2, preemptible; a checkpoint after step 2
        ctl = build("w2", "gang602m", 2, preemptible=True)
        w2_ms = segment("w2_steps_1_2", ctl, lambda: timed_steps(ctl, 2))
        t0 = time.perf_counter()
        ctl.save_checkpoint()
        save_s = time.perf_counter() - t0
        w2_ms += segment("w2_steps_3_4", ctl, lambda: timed_steps(ctl, 2))
        w2_losses = ctl.losses()
        rel = check_losses(w2_losses, w1_losses, "trainer (b) world 2 against world 1")
        # member 1 killed: the typed error, then the recovery ladder
        ctl.preempt_member(1, graceful=False)

        def failing_step():
            try:
                ctl.run(1, auto_repair=False)
            except (exceptions.RayActorError, exceptions.WorkerCrashedError) as exc:
                return exc
            raise AssertionError("trainer (b): a step with member 1 dead did not raise")

        err = segment("killed_step", ctl, failing_step)
        t0 = time.perf_counter()
        outcome = segment("recover", ctl, lambda: ctl.recover(error=err))
        recover_s = time.perf_counter() - t0
        post_ms = segment("post_repair_steps", ctl, lambda: timed_steps(ctl, 2))
        audit = rt.get_cluster().train_repair_audits[-1]
        post = list(audit["losses"])
        if ctl.step_count != 4 or ctl.losses()[2:] != post or len(post) != 2:
            raise AssertionError(f"trainer (b): step {ctl.step_count}, losses {ctl.losses()}, "
                                 f"audit {post}")
        # the comparisons' launches are counted apart
        zero_counters(counters)
        c0 = ctl.step_fn.calls
        replayed = ctl.replay(audit["state"], audit["world_size"], 2)
        report = invariants.check_invariants(refs=[], baseline=baseline)
        compare_n, compare_r = read_counters(counters)
        calls["compare"] = ctl.step_fn.calls - c0
        check_per_call("(b) replay and invariant 12", (compare_n, compare_r), calls["compare"], want)
        if np.asarray(replayed, np.float32).tobytes() != np.asarray(post, np.float32).tobytes():
            raise AssertionError(f"trainer (b): post-repair losses {post}, replay {replayed}")
        if not report.ok or report.checked.get("train_repairs", 0) < 1 \
                or report.checked.get("train_replayed_steps", 0) < 2:
            raise AssertionError(f"trainer (b): invariants {report.violations} {report.checked}")
        on_card = ctl._params.is_cuda and ctl._mom.is_cuda
        world_after = ctl.world_size
        history = list(ctl.repair_history)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        torch.use_deterministic_algorithms(False)
        for c in box.values():
            c.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    box.clear()
    torch.cuda.empty_cache()
    # the preempted member is killed for good (no_restart), as in the JAX
    # package: the ladder cannot repair in place and shrinks to one member
    if not on_card or outcome != "shrunk" or world_after != 1:
        raise AssertionError(f"trainer (b): outcome {outcome}, world {world_after}, "
                             f"state on the card {on_card}")
    # each gang holds the controller's card: 1/world of it a member
    if any(abs(g - 1.0) > 1e-9 for g in gpu_held.values()):
        raise AssertionError(f"trainer (b): the gangs hold {gpu_held} of the card")
    return {"part": "b_train_controller", "card": card, "params": n_params,
            "rows": list(TRAINER_GANG_ROWS), "batch": 2, "learning_rate": TRAINER_GANG_LR,
            "world1_losses": w1_losses, "world2_losses": w2_losses, "loss_rel_gaps": rel,
            "loss_rtol": LOSS_RTOL, "world1_step_ms": w1_ms,
            "world1_step_ms_median": statistics.median(w1_ms), "world2_step_ms": w2_ms,
            "world2_step_ms_median": statistics.median(w2_ms),
            "gang_over_one_device": statistics.median(w2_ms) / statistics.median(w1_ms),
            "error_type": type(err).__name__, "recover_outcome": outcome,
            "world_after_recover": world_after, "repair_history": history,
            "recover_s": recover_s, "post_repair_losses": post, "post_repair_step_ms": post_ms,
            "replay_bitwise_equal": True, "invariant12": {
                k: report.checked.get(k) for k in ("train_repairs", "train_replayed_steps")},
            "checkpoint_save_s": save_s, "checkpoint_gb": 2 * 4 * n_params / 1e9,
            "state_on_card": on_card, "gpu_held": gpu_held, "peak_mem_gb": peak_gb, "held_at_start_gb": held_gb,
            "held_after_gc_gb": held_after_gc_gb,
            "member_steps": calls,
            "warmup_launches": warm, "launches": main_n, "launches_by_route": main_r,
            "compare_launches": compare_n}


def trainer_ddp_loop(config):
    """(c)'s loop (``tests/test_train.py``'s two TorchTrainer loops, the
    model on ``get_device()``); it travels to the rank processes by value."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.train.torch import get_device, prepare_model

    dev = get_device()
    rank = train.get_context().get_world_rank()
    t = torch.tensor([float(rank + 1)], device=dev)
    dist.all_reduce(t)  # 1 + 2 = 3 across both ranks
    torch.manual_seed(42)  # same init on every rank
    model = prepare_model(torch.nn.Linear(4, 1).to(dev))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    rng = np.random.default_rng(rank)  # different data per rank
    for _ in range(5):
        x = torch.tensor(rng.normal(size=(8, 4)), dtype=torch.float32, device=dev)
        loss = ((model(x) - x.sum(dim=1, keepdim=True)) ** 2).mean()
        opt.zero_grad()
        loss.backward()  # DDP all-reduces grads here
        opt.step()
    w = model.module.weight if hasattr(model, "module") else model.weight
    gathered = [torch.zeros(1) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, torch.tensor([w[0, 0].item()]))
    devices = [None] * dist.get_world_size()
    dist.all_gather_object(devices, [str(dev), str(t.device), str(w.device), os.getpid()])
    train.report({"reduced": float(t.item()), "world": dist.get_world_size(),
                  "loss": float(loss.item()), "w0": float(w[0, 0].item()),
                  "w0_spread": float(max(g.item() for g in gathered)
                                     - min(g.item() for g in gathered)),
                  "ddp": hasattr(model, "module"), "ranks": devices})


def trainer_torch(torch, card: str) -> dict:
    """(c): ``TorchTrainer``, two process ranks sharing ``cuda:0`` over
    gloo: the rank allreduce gives 3.0, DDP keeps the weights identical."""
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    t0 = time.perf_counter()
    result = TorchTrainer(trainer_ddp_loop, scaling_config=ScalingConfig(num_workers=2)).fit()
    fit_s = time.perf_counter() - t0
    m = result.metrics
    pids = {r[3] for r in m.get("ranks", [])}
    if result.error is not None or m.get("reduced") != 3.0 or m.get("w0_spread") != 0.0 \
            or not m.get("ddp") or os.getpid() in pids or len(pids) != 2 \
            or any(r[:3] != ["cuda:0"] * 3 for r in m["ranks"]) or not math.isfinite(m["loss"]):
        raise AssertionError(f"trainer (c): error {result.error!r}, metrics {m}")
    return {"part": "c_torch_trainer", "card": card, "reduced": m["reduced"],
            "w0_spread": m["w0_spread"], "loss": m["loss"], "ranks": m["ranks"], "fit_s": fit_s}


class TrainerAllreduceRank:
    """(d)'s member: one rank of an actor collective group, holding a
    seeded f32 tensor on the card."""

    def __init__(self, rank: int, seed: int):
        import torch

        from ray_tpu_torch.util import collective

        collective.init_collective_group(2, rank, group_name="trainer-ar")
        g = torch.Generator(device="cuda").manual_seed(seed + rank)
        self.x = torch.randn(TRAINER_AR_BYTES // 4, generator=g, device="cuda")
        self.rank = rank

    def value(self):
        return self.x

    def allreduce(self):
        import torch

        from ray_tpu_torch.util import collective

        out = collective.allreduce(self.x, group_name="trainer-ar", rank=self.rank)
        torch.cuda.current_stream().synchronize()
        return out


def trainer_collective(torch, rt, card: str) -> dict:
    """(d): an actor collective group of two in-process GPU actors
    allreduces a 64 MiB f32 CUDA tensor: bitwise the member-order sum, on
    the card; ms a call."""
    from ray_tpu_torch.parallel import collective

    ranks = [rt.remote(TrainerAllreduceRank).options(num_gpus=0.5).remote(r, TRAINER_SEED)
             for r in range(2)]
    try:
        xs = rt.get([a.value.remote() for a in ranks])
        want = xs[0] + xs[1]
        ms, outs = [], None
        for _ in range(TRAINER_AR_REPS):
            t0 = time.perf_counter()
            outs = rt.get([a.allreduce.remote() for a in ranks])
            ms.append((time.perf_counter() - t0) * 1e3)
        routing = collective._registry.get("trainer-ar").routing
        ok = all(o.is_cuda and torch.equal(o, want) for o in outs)
    finally:
        for a in ranks:
            rt.kill(a)
        collective.destroy_collective_group("trainer-ar")
    if not ok:
        raise AssertionError(f"trainer (d): allreduce not the member-order sum on the card "
                             f"({[str(o.device) for o in outs]})")
    del xs, want, outs
    torch.cuda.empty_cache()
    return {"part": "d_collective_group", "card": card, "bytes": TRAINER_AR_BYTES,
            "members": 2, "bitwise_member_order_sum": True, "on_card": True,
            "routing": routing, "ms_per_call": ms, "ms_per_call_median": statistics.median(ms)}


def run_trainer(torch, counters: dict, card: str, train_step_ms=None):
    """The trainer phase: (a)-(d) under one ``init(num_cpus=8)``."""
    import ray_tpu_torch as rt

    cfg = train_config(torch)
    rt.init(num_cpus=8)
    try:
        yield trainer_user_loop(torch, rt, dataclasses.replace(cfg, n_layers=CUT_LAYERS),
                                counters, card, train_step_ms)
        yield trainer_gang(torch, rt, dataclasses.replace(cfg, n_layers=CUT_LAYERS),
                           counters, card)
        yield trainer_torch(torch, card)
        yield trainer_collective(torch, rt, card)
    finally:
        rt.shutdown()


TUNE_SEED = 17
# (a): the ASHA grid. Every trial's first loss is the same (the step reports
# the loss before its update); at rung 2 the later trials (1e-3, 3e-3) reach
# a rung that already holds 3e-4's lower loss and are pruned
TUNE_RATES = (1e-4, 3e-4, 1e-3, 3e-3)
TUNE_MAX_T = 4  # (a): ASHA's max_t, the steps a trial may take
TUNE_TOT_RATES = (3e-4, 1e-3)  # (b): the Train-on-Tune grid
TUNE_TOT_STEPS = 2
TUNE_WAIT_S = 600.0  # the bound on each experiment; a hang fails the phase


def state_digest(torch, tree) -> str:
    """A digest of a train state's bits, computed on the card: each leaf's
    bit patterns summed plain and weighted by position (any in-place update
    moves both)."""
    parts = []

    def walk(t, name):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{name}/{k}")
            return
        flat = t.detach().reshape(-1)
        bits = flat.view(torch.int32 if flat.element_size() == 4 else torch.int16).long()
        w = torch.arange(bits.numel(), device=bits.device) % 1000003 + 1
        parts.append(f"{name}:{int(bits.sum())}:{int((bits * w).sum())}")

    walk(tree, "")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def bounded(what: str, fn, timeout_s: float = TUNE_WAIT_S):
    """``fn()`` on a daemon thread, waited on at most ``timeout_s``: an
    experiment that waits for ever (two demands on one card) fails the
    phase instead of hanging the script."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            box["err"] = exc

    t = threading.Thread(target=run, name=f"tune-{what}", daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise AssertionError(f"tune {what}: not done within {timeout_s} s")
    if "err" in box:
        raise box["err"]
    return box["out"]


def direct_losses(torch, cfg, state, tokens, lr: float, steps: int) -> list:
    """``steps`` of ``make_train_step`` at ``lr`` from a copy of ``state``."""
    from ray_tpu_torch.models.transformer import make_train_step

    _, step = make_train_step(cfg, learning_rate=lr, device="cuda")
    st, out = copy.deepcopy(state), []
    for _ in range(steps):
        st, loss = step(st, tokens)
        out.append(float(loss))
    del st
    torch.cuda.empty_cache()
    return out


def tune_asha(torch, rt, cfg, counters: dict, card: str, train_step_ms) -> dict:
    """(a): ASHA over a function trainable that trains the 602M step, two
    half-card trials at a time, every trial from the one put state."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.models.transformer import make_train_step

    init_state, _ = make_train_step(cfg, device="cuda")
    state = init_state(TUNE_SEED)
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (6, cfg.max_seq_len), generator=g, device="cuda")
    before = state_digest(torch, state)
    log = {}  # learning rate -> [(loss, step ms)], every step a trial took

    def step_trial(config, state=None):
        # the put state is shared by every trial: train a copy of it
        lr = config["learning_rate"]
        st = copy.deepcopy(state)
        _, step = make_train_step(cfg, learning_rate=lr, device="cuda")
        rows = log.setdefault(lr, [])
        for _ in range(TUNE_MAX_T):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            st, loss = step(st, tokens)
            e1.record()
            e1.synchronize()
            rows.append((float(loss), e0.elapsed_time(e1), str(loss.device)))
            tune.report({"loss": rows[-1][0]})

    trainable = tune.with_resources(tune.with_parameters(step_trial, state=state), {"GPU": 0.5})
    sched = tune.AsyncHyperBandScheduler(time_attr="training_iteration", max_t=TUNE_MAX_T,
                                         grace_period=1, reduction_factor=2)
    tuner = tune.Tuner(trainable,
                       param_space={"learning_rate": tune.grid_search(list(TUNE_RATES))},
                       tune_config=tune.TuneConfig(metric="loss", mode="min",
                                                   max_concurrent_trials=2, scheduler=sched))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    t0 = time.perf_counter()
    grid = bounded("asha", tuner.fit)
    wall_s = time.perf_counter() - t0
    launches, by_route = read_counters(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    after = state_digest(torch, state)
    if grid.errors or len(grid) != len(TUNE_RATES):
        raise AssertionError(f"tune (a): {len(grid)} trials, errors {grid.errors}")
    trials = {}
    for i in range(len(grid)):
        r = grid[i]
        lr = r.config["learning_rate"]
        took = log.get(lr, [])
        reported = [row["loss"] for row in r.metrics_dataframe]
        if not took or reported != [x for x, _, _ in took[:len(reported)]]:
            raise AssertionError(f"tune (a) lr {lr}: reported {reported}, took {took}")
        trials[lr] = {"steps": len(took), "reported": len(reported),
                      "losses": [x for x, _, _ in took],
                      "step_ms": [ms for _, ms, _ in took],
                      "step_ms_median": statistics.median(ms for _, ms, _ in took),
                      "devices": sorted({d for _, _, d in took})}
    steps = sum(t["steps"] for t in trials.values())
    if any(t["devices"] != ["cuda:0"] for t in trials.values()):
        raise AssertionError(f"tune (a): devices {trials}")
    if not all(math.isfinite(x) for t in trials.values() for x in t["losses"]):
        raise AssertionError(f"tune (a): losses {trials}")
    early = sorted(lr for lr, t in trials.items() if t["steps"] < TUNE_MAX_T)
    if not early:
        raise AssertionError(f"tune (a): ASHA stopped no trial before max_t {TUNE_MAX_T}: "
                             f"{ {lr: t['losses'] for lr, t in trials.items()} }")
    if after != before:
        raise AssertionError("tune (a): the put state changed during the experiment")
    check_per_call("tune (a)", (launches, by_route), steps, attention_want(cfg.n_layers))
    best = grid.get_best_result()
    best_lr = best.config["learning_rate"]
    want = direct_losses(torch, cfg, state, tokens, best_lr, trials[best_lr]["steps"])
    if trials[best_lr]["losses"] != want:
        raise AssertionError(f"tune (a): best lr {best_lr} losses {trials[best_lr]['losses']}, "
                             f"direct {want}")
    del state
    torch.cuda.empty_cache()
    return {"part": "a_asha", "card": card, "rates": list(TUNE_RATES), "max_t": TUNE_MAX_T,
            "trials": {str(lr): t for lr, t in sorted(trials.items())},
            "stopped_early": early, "best_learning_rate": best_lr,
            "best_losses_bitwise_equal_direct": True, "put_state_unchanged": True,
            "put_state_digest": before, "steps": steps,
            "train_phase_step_ms_median": train_step_ms, "wall_s": wall_s,
            "peak_mem_gb": peak_gb, "launches": launches, "launches_by_route": by_route}


def tune_train_on_tune(torch, rt, cfg, counters: dict, card: str) -> dict:
    """(b): Train-on-Tune: a ``DeviceTrainer`` per trial, its one rank on a
    half card, two trials at a time."""
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.models.transformer import make_train_step

    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (6, cfg.max_seq_len), generator=g, device="cuda")
    devices = []

    def loop(config):
        dev = train.get_context().get_devices()[0]
        devices.append(str(dev))
        init_state, step = make_train_step(cfg, learning_rate=config["learning_rate"], device=dev)
        st = init_state(TUNE_SEED)
        for i in range(TUNE_TOT_STEPS):
            st, loss = step(st, tokens)
            train.report({"step": i + 1, "loss": float(loss)})

    trainer = train.DeviceTrainer(loop, scaling_config=train.ScalingConfig(
        num_workers=1, num_devices_per_worker=0.5))
    tuner = tune.Tuner(trainer, param_space={"train_loop_config": {
        "learning_rate": tune.grid_search(list(TUNE_TOT_RATES))}},
        tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=2))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    t0 = time.perf_counter()
    grid = bounded("train_on_tune", tuner.fit)
    wall_s = time.perf_counter() - t0
    launches, by_route = read_counters(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if grid.errors or len(grid) != len(TUNE_TOT_RATES):
        raise AssertionError(f"tune (b): {len(grid)} trials, errors {grid.errors}")
    init_state, _ = make_train_step(cfg, device="cuda")
    state = init_state(TUNE_SEED)
    terminal = {}
    for i in range(len(grid)):
        r = grid[i]
        lr = r.config["learning_rate"]
        want = direct_losses(torch, cfg, state, tokens, lr, TUNE_TOT_STEPS)
        terminal[lr] = r.metrics["loss"]
        if r.metrics["loss"] != want[-1] or r.metrics.get("step") != TUNE_TOT_STEPS:
            raise AssertionError(f"tune (b) lr {lr}: terminal {r.metrics}, direct {want}")
    del state
    torch.cuda.empty_cache()
    best_lr = grid.get_best_result().config["learning_rate"]
    if best_lr != min(terminal, key=terminal.get):
        raise AssertionError(f"tune (b): best {best_lr}, terminal losses {terminal}")
    if devices != ["cuda:0"] * len(TUNE_TOT_RATES):
        raise AssertionError(f"tune (b): rank devices {devices}")
    check_per_call("tune (b)", (launches, by_route), TUNE_TOT_STEPS * len(TUNE_TOT_RATES),
                   attention_want(cfg.n_layers))
    return {"part": "b_train_on_tune", "card": card, "rates": list(TUNE_TOT_RATES),
            "steps": TUNE_TOT_STEPS, "terminal_losses": {str(k): v for k, v in terminal.items()},
            "terminal_bitwise_equal_direct": True, "best_learning_rate": best_lr,
            "rank_devices": devices, "wall_s": wall_s, "peak_mem_gb": peak_gb,
            "launches": launches, "launches_by_route": by_route}


def tune_restore(torch, rt, card: str) -> dict:
    """(c): an experiment interrupted (``KeyboardInterrupt`` from a callback)
    when its first trial finishes, then ``Tuner.restore``: the finished
    trial keeps its result, the interrupted one resumes from its checkpoint,
    the one never started runs whole."""
    from ray_tpu_torch import train, tune

    tmp = tempfile.mkdtemp(prefix="tune_c_")
    ran = []  # (stage, x, i): every step any trial took
    stage = {"now": "first"}
    released = threading.Event()

    def trainable(config):
        ckpt = tune.get_checkpoint()
        start = ckpt.to_dict()["i"] + 1 if ckpt is not None else 0
        for i in range(start, 4):
            if config["x"] == 20 and i == 2 and stage["now"] == "first":
                released.wait(60.0)  # held until the experiment is interrupted
            v = torch.full((1024,), float(config["x"] + i), device="cuda")
            ran.append((stage["now"], config["x"], i, float(v.sum()), str(v.device)))
            time.sleep(0.1 if config["x"] == 10 else 0.01)
            tune.report({"i": i, "v": float(v.sum())},
                        checkpoint=train.Checkpoint.from_dict({"i": i}))

    class Interrupt(tune.Callback):
        def on_trial_complete(self, trial):
            raise KeyboardInterrupt("interrupted after the first trial finished")

    space = {"x": tune.grid_search([10, 20, 30])}
    cfg = dict(metric="i", mode="max", max_concurrent_trials=2)
    t0 = time.perf_counter()
    try:
        tune.Tuner(trainable, param_space=space, tune_config=tune.TuneConfig(**cfg),
                   run_config=train.RunConfig(name="exp", storage_path=tmp,
                                              callbacks=[Interrupt()])).fit()
        raise AssertionError("tune (c): the experiment was not interrupted")
    except KeyboardInterrupt:
        pass
    released.set()
    deadline = time.monotonic() + 60
    while (20, 3) not in {(x, i) for _, x, i, _, _ in ran} and time.monotonic() < deadline:
        time.sleep(0.05)  # the interrupted run's trial thread finishes its loop
    stage["now"] = "restore"
    path = os.path.join(tmp, "exp")
    if not tune.Tuner.can_restore(path):
        raise AssertionError(f"tune (c): nothing to restore in {path}")
    grid = bounded("restore", tune.Tuner.restore(path, trainable, param_space=space,
                                                 tune_config=tune.TuneConfig(**cfg)).fit)
    wall_s = time.perf_counter() - t0
    again = sorted((x, i) for s, x, i, _, _ in ran if s == "restore")
    by_x = sorted((r.config["x"], r.metrics["i"]) for r in grid)
    want = [(20, 2), (20, 3), (30, 0), (30, 1), (30, 2), (30, 3)]
    if again != want or by_x != [(10, 3), (20, 3), (30, 3)] or grid.errors:
        raise AssertionError(f"tune (c): restore ran {again}, results {by_x}, "
                             f"errors {grid.errors}")
    if any(d != "cuda:0" or v != 1024 * (x + i) for _, x, i, v, d in ran):
        raise AssertionError(f"tune (c): steps {ran}")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return {"part": "c_restore", "card": card, "first_run": sorted(
        (x, i) for s, x, i, _, _ in ran if s == "first"), "restore_ran": again,
        "results": by_x, "wall_s": wall_s}


def run_tune(torch, counters: dict, card: str, train_step_ms=None):
    """The tune phase: (a)-(c) under one ``init(num_cpus=8)``, deterministic
    algorithms on (the bitwise checks against direct runs)."""
    import ray_tpu_torch as rt

    cfg = train_config(torch)
    rt.init(num_cpus=8)
    torch.use_deterministic_algorithms(True)
    try:
        yield tune_asha(torch, rt, cfg, counters, card, train_step_ms)
        yield tune_train_on_tune(torch, rt, cfg, counters, card)
        yield tune_restore(torch, rt, card)
    finally:
        torch.use_deterministic_algorithms(False)
        rt.shutdown()


# ---------------------------------------------------------------------------
# jobs: submitted GPU jobs, a durable workflow of GPU steps, state and usage
# ---------------------------------------------------------------------------
JOBS_SEED = 0  # the serving phases' params seed: a job's tokens equal theirs
JOBS_EVENT = "chip-smoke-release"  # the workflow's gate, released over HTTP
JOBS_TIMEOUT_S = 300.0  # the bound on each job and on the workflow
JOBS_FREE_SLACK = 1 << 30  # (b): free memory back within this of before
JOBS_FREE_WAIT_S = 10.0  # (b): ... within this many seconds of the stop
JOBS_PROFILE_N = 2048  # (e): the profiled task's matmul side
_WF_ENGINES = {}  # quantize -> the GPU engine actor the workflow's steps drive


def tokens_digest(tokens) -> str:
    """sha256 of a burst's greedy tokens (a list of token lists)."""
    return hashlib.sha256(json.dumps(tokens).encode()).hexdigest()


def job_report(**fields) -> None:
    print("JOBREPORT " + json.dumps(fields), flush=True)


def job_reports(logs: str) -> list:
    return [json.loads(line[len("JOBREPORT "):]) for line in logs.splitlines()
            if line.startswith("JOBREPORT ")]


def jobs_config(torch):
    """The serving decoder's widths at ``CUT_LAYERS`` layers (the script's
    time): what a jobs-phase job and its direct runs serve."""
    return dataclasses.replace(serving_config(torch), n_layers=CUT_LAYERS)


def job_driver() -> int:
    """What a jobs-phase job runs (``driver.py`` of its working dir calls
    it). ``JOB_MODE=serve``: the serving decoder from ``JOB_SEED`` serves the
    burst through a GPU actor of this process's runtime, float then int8,
    one ``JOBREPORT`` line a run (token digest, K1/K6 launches, decode
    steps); ``loop``: the float engine decodes until the job is stopped;
    ``hidden``: the engine asks for the card by its default device."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.decode_attention import paged_decode_attention
    from ray_tpu_torch.ops.quantization import int8_matmul
    from ray_tpu_torch.serve.llm import LLMEngine

    mode = os.environ["JOB_MODE"]
    cfg = jobs_config(torch)
    if mode == "hidden":
        rt.init(num_cpus=1)
        try:
            job_report(mode=mode, gpus=rt.cluster_resources().get("GPU", 0),
                       cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"))
            LLMEngine(cfg, {})  # no device named: the card, or the engine refuses
            job_report(mode=mode, served=True)
        finally:
            rt.shutdown()
        return 0
    from ray_tpu_torch.models.transformer import init_params

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(int(os.environ["JOB_SEED"])))
    prompts = burst_prompts(cfg, 8, 64)
    if mode == "loop":
        eng = LLMEngine(cfg, params, device="cuda", max_batch_size=8,
                        max_seq_len=cfg.max_seq_len, kv_block_size=16, cache_kind="paged")
        eng.generate(prompts[0], max_tokens=2)
        torch.cuda.synchronize()
        job_report(mode=mode, ready=True, pid=os.getpid(),
                   device_bytes=torch.cuda.memory_reserved())
        while True:
            futures = [eng.submit(p, max_tokens=32) for p in prompts]
            [f.result(timeout=600) for f in futures]
    counters = {"paged_decode_attention": paged_decode_attention, "int8_matmul": int8_matmul}
    rt.init(num_cpus=2)
    try:
        for quantize in (False, True):
            actor = rt.remote(EngineActor).options(num_gpus=1).remote(cfg, params, quantize)
            sid = rt.get(actor.open_stream.remote(prompts[0], 2))
            first = rt.get(actor.next_token.remote(sid))  # warm: cuBLAS, kernels, first token
            first_token_unix = time.time()
            while rt.get(actor.next_token.remote(sid)) is not None:
                pass
            steps0 = rt.get(actor.decode_steps.remote())
            zero_counters(counters)
            t0 = time.perf_counter()
            tokens = rt.get(actor.generate.remote(prompts, 32))
            wall = time.perf_counter() - t0
            launches, by_route = read_counters(counters)
            steps = rt.get(actor.decode_steps.remote()) - steps0
            rt.get(actor.close.remote())
            rt.kill(actor)
            del actor
            torch.cuda.empty_cache()
            job_report(mode=mode, quantize=quantize, digest=tokens_digest(tokens),
                       n_tokens=sum(len(t) for t in tokens), launches=launches,
                       launches_by_route=by_route, decode_steps=steps, wall_s=wall,
                       first_token=first, first_token_unix=first_token_unix, pid=os.getpid(),
                       libs={n: lib._name for n, lib in _build._libs.items()})
    finally:
        rt.shutdown()
    return 0


def wf_generate(gate, quantize: bool, prompts, max_tokens: int):
    """A workflow's GPU step: the burst through the engine actor of
    ``_WF_ENGINES`` (tokens as lists: a step's result is pickled)."""
    import ray_tpu_torch as rt

    if gate.get("release") is not True:
        raise ValueError(f"gate payload {gate!r}")
    return rt.get(_WF_ENGINES[quantize].generate.remote(prompts, max_tokens), timeout=600)


def wf_compare(got_float, got_int8, want_float: str, want_int8: str, marker: str):
    """The workflow's last step: fails once while ``marker`` exists (it
    removes it), then compares the GPU steps' digests with the direct runs'."""
    if os.path.exists(marker):
        os.unlink(marker)
        raise RuntimeError("the comparison step fails once")
    return {"float": tokens_digest(got_float), "int8": tokens_digest(got_int8),
            "float_equal": tokens_digest(got_float) == want_float,
            "int8_equal": tokens_digest(got_int8) == want_int8}


def jobs_profiled_matmul(n: int):
    """(e): a ``num_gpus`` task's body in its worker that sees the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(JOBS_SEED)
    x = torch.randn(n, n, device="cuda", generator=g)
    y = (x @ x).sum().item()
    return {"pid": os.getpid(), "flag": os.environ.get("JOBS_FLAG"),
            "device": torch.cuda.get_device_name(0), "finite": math.isfinite(y)}


def lib_stamps() -> dict:
    """{kernel library path: mtime ns} of the build directory."""
    from ray_tpu_torch.ops import _build

    return {p: os.stat(p).st_mtime_ns for p in glob.glob(os.path.join(_build.BUILD, "*", "lib*.so"))}


def wait_for(what: str, pred, timeout_s: float, interval_s: float = 0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(interval_s)
    raise AssertionError(f"jobs: {what} not within {timeout_s} s")


def check_job_burst(cfg, rep: dict, want_digest: str, what: str) -> None:
    per_forward = k6_per_layer(cfg) * cfg.n_layers
    n, steps = rep["launches"], rep["decode_steps"]
    if rep["digest"] != want_digest:
        raise AssertionError(f"{what}: token digest {rep['digest']} != this process's {want_digest}")
    if steps < 31 or n["paged_decode_attention"] != cfg.n_layers * steps:
        raise AssertionError(f"{what}: K1 {n} over {steps} decode steps, want {cfg.n_layers} a step")
    if rep["quantize"]:
        k6 = n["int8_matmul"]
        if (k6 % per_forward or k6 < per_forward * steps
                or rep["launches_by_route"]["int8_matmul"] != {"mma_bf16": k6, "simt": 0}):
            raise AssertionError(f"{what}: K6 {n} {rep['launches_by_route']}, want "
                                 f"{per_forward} a forward on mma_bf16")
    elif n["int8_matmul"]:
        raise AssertionError(f"{what}: K6 launched {n} in the float run")


def jobs_submitted(torch, rt, cfg, client, workdir: str, want: dict, libs: dict) -> dict:
    """(a) the serving job, with (c) the hidden-card job beside it."""
    env = {"JOB_SEED": str(JOBS_SEED)}
    t_submit = time.time()
    sid = client.submit_job(entrypoint=f"{sys.executable} driver.py",
                            runtime_env={"working_dir": workdir,
                                         "env_vars": {**env, "JOB_MODE": "serve"}},
                            metadata={"phase": "jobs", "part": "a"})
    sid_hidden = client.submit_job(
        entrypoint=f"{sys.executable} driver.py",
        runtime_env={"working_dir": workdir,
                     "env_vars": {**env, "JOB_MODE": "hidden", "CUDA_VISIBLE_DEVICES": ""}})
    info = client.wait_until_finished(sid, timeout=JOBS_TIMEOUT_S)
    logs = client.get_job_logs(sid)
    if info["status"] != "SUCCEEDED":
        raise AssertionError(f"jobs (a): {info['status']} {info['message']}\n{logs[-4000:]}")
    reps = job_reports(logs)
    if [r.get("quantize") for r in reps] != [False, True]:
        raise AssertionError(f"jobs (a): reports {reps}\n{logs[-4000:]}")
    for rep in reps:
        check_job_burst(cfg, rep, tokens_digest(want[rep["quantize"]]),
                        f"jobs (a) {'int8' if rep['quantize'] else 'float'}")
        if rep["pid"] == os.getpid():
            raise AssertionError("jobs (a): the job ran in this process")
        if not set(rep["libs"].values()) <= set(libs):
            raise AssertionError(f"jobs (a): the job loaded {rep['libs']}, not the build's {libs}")
    if lib_stamps() != libs:
        raise AssertionError("jobs (a): a kernel library was rebuilt while the job ran")
    hidden = client.wait_until_finished(sid_hidden, timeout=JOBS_TIMEOUT_S)
    hidden_logs = client.get_job_logs(sid_hidden)
    hreps = job_reports(hidden_logs)
    refusal = "runs on CUDA by default and no CUDA device is available"
    if (hidden["status"] != "FAILED" or refusal not in hidden_logs
            or any(r.get("served") for r in hreps) or hreps[:1] != [
                {"mode": "hidden", "gpus": 0, "cuda_visible_devices": ""}]):
        raise AssertionError(f"jobs (c): {hidden['status']} {hreps}\n{hidden_logs[-4000:]}")
    return {
        "job_status": info["status"], "job_wall_s": info["end_time"] - info["start_time"],
        "job_start_to_first_token_s": reps[0]["first_token_unix"] - t_submit,
        "digests_equal_in_process": True,
        "launches": {k: reps[0]["launches"][k] + reps[1]["launches"][k]
                     for k in reps[0]["launches"]},
        "launches_by_route": {"int8_matmul": reps[1]["launches_by_route"]["int8_matmul"]},
        "decode_steps": [r["decode_steps"] for r in reps],
        "k1_per_decode_step": [r["launches"]["paged_decode_attention"] / r["decode_steps"]
                               for r in reps],
        "k6_forwards": reps[1]["launches"]["int8_matmul"] // (k6_per_layer(cfg) * cfg.n_layers),
        "burst_tokens_per_s": [r["n_tokens"] / r["wall_s"] for r in reps],
        "libraries_reused": sorted(os.path.basename(p) for p in reps[-1]["libs"].values()),
        "hidden_job": {"status": hidden["status"], "refusal": refusal,
                       "gpus_seen": hreps[0]["gpus"]},
    }


def jobs_stop(torch, rt, client, workdir: str) -> dict:
    """(b) stop a GPU job while it decodes: its group goes, the card's free
    memory comes back."""
    from ray_tpu_torch.job.manager import group_members

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    sid = client.submit_job(entrypoint=f"{sys.executable} driver.py",
                            runtime_env={"working_dir": workdir, "env_vars": {
                                "JOB_SEED": str(JOBS_SEED), "JOB_MODE": "loop"}})
    def ready():
        if client.get_job_status(sid) != "RUNNING":
            return "ended"
        return "ready" if any(r.get("ready") for r in job_reports(client.get_job_logs(sid))) else None

    if wait_for("the loop job's ready line", ready, JOBS_TIMEOUT_S, 0.2) != "ready":
        raise AssertionError(f"jobs (b): {client.get_job_status(sid)}\n"
                             f"{client.get_job_logs(sid)[-4000:]}")
    free_running = torch.cuda.mem_get_info()[0]
    pgid = os.getpgid(rt.get_cluster().dashboard.job_manager._jobs[sid].proc.pid)
    t0 = time.perf_counter()
    if not client.stop_job(sid):
        raise AssertionError("jobs (b): stop_job refused")
    info = client.wait_until_finished(sid, timeout=30)
    stopped_s = time.perf_counter() - t0
    wait_for("the stopped job's group to go", lambda: not group_members(pgid), JOBS_FREE_WAIT_S)
    gone_s = time.perf_counter() - t0
    def freed():
        f = torch.cuda.mem_get_info()[0]
        return f if f >= free0 - JOBS_FREE_SLACK else None

    free = wait_for("the card's memory to come back", freed,
                    max(0.0, JOBS_FREE_WAIT_S - (time.perf_counter() - t0)))
    free_s = time.perf_counter() - t0
    if info["status"] != "STOPPED":
        raise AssertionError(f"jobs (b): {info}")
    return {"status": info["status"], "free_before_gb": free0 / 1e9,
            "free_running_gb": free_running / 1e9, "free_after_gb": free / 1e9,
            "held_by_job_gb": (free0 - free_running) / 1e9,
            "stop_to_stopped_s": stopped_s, "stop_to_group_gone_s": gone_s,
            "stop_to_free_s": free_s}


def jobs_workflow(torch, rt, cfg, params, counters: dict, want: dict, workdir: str, url: str):
    """(d) the durable workflow; returns its report and the engine actors
    (left alive for (e))."""
    import chip_smoke as smoke  # the steps by module name: the DAG is pickled
    from ray_tpu_torch import workflow

    actors = {q: rt.remote(EngineActor).options(num_gpus=0.25).remote(cfg, params, q)
              for q in (False, True)}
    rt.get([a.warm.remote(64) for a in actors.values()])
    smoke._WF_ENGINES.update(actors)
    workflow.init(os.path.join(workdir, "workflows"))
    prompts = burst_prompts(cfg, 8, 64)
    marker = os.path.join(workdir, "compare_fails_once")
    open(marker, "w").close()
    gate = workflow.wait_for_event(workflow.QueueEventListener, JOBS_EVENT, 120.0)
    gen = rt.remote(smoke.wf_generate).options(num_gpus=0.25, execution="thread")
    cmp = rt.remote(smoke.wf_compare).options(execution="thread")
    dag = cmp.bind(gen.bind(gate, False, prompts, 32), gen.bind(gate, True, prompts, 32),
                   tokens_digest(want[False]), tokens_digest(want[True]), marker)
    steps0 = {q: rt.get(a.decode_steps.remote()) for q, a in actors.items()}
    zero_counters(counters)
    err = {}

    def run():
        try:
            workflow.run(dag, workflow_id="chip_smoke_jobs")
        except Exception as exc:  # noqa: BLE001 - the comparison's first failure
            err["error"] = exc

    t0 = time.perf_counter()
    runner = threading.Thread(target=run, name="jobs-workflow", daemon=True)
    runner.start()
    refused = 0
    while True:
        try:
            delivered = http_json(f"{url}/api/workflows/events/{JOBS_EVENT}", {"release": True})
            break
        except Exception as exc:  # noqa: BLE001 - 404 until the gate waits
            if getattr(exc, "code", None) != 404 or time.perf_counter() - t0 > 60:
                raise
            refused += 1
            time.sleep(0.05)
    runner.join(timeout=JOBS_TIMEOUT_S)
    run_s = time.perf_counter() - t0
    if runner.is_alive() or "error" not in err or workflow.get_status("chip_smoke_jobs") != "FAILED":
        raise AssertionError(f"jobs (d): the first run ended {workflow.get_status('chip_smoke_jobs')}"
                             f" with {err}")
    launches, by_route = read_counters(counters)
    steps = {q: rt.get(a.decode_steps.remote()) - steps0[q] for q, a in actors.items()}
    recorded = workflow.get_metadata("chip_smoke_jobs")["step_names"]
    t0 = time.perf_counter()
    out = workflow.resume("chip_smoke_jobs")
    resume_s = time.perf_counter() - t0
    after, after_route = read_counters(counters)
    resumed_steps = {q: rt.get(a.decode_steps.remote()) - steps0[q] for q, a in actors.items()}
    if not (out["float_equal"] and out["int8_equal"]):
        raise AssertionError(f"jobs (d): the workflow's tokens differ from the direct runs: {out}")
    if after != launches or resumed_steps != steps:
        raise AssertionError(f"jobs (d): resume launched {after} over {resumed_steps} steps, "
                             f"the run {launches} over {steps}")
    if recorded != ["step_0000", "step_0001", "step_0002"]:
        raise AssertionError(f"jobs (d): durable steps after the failure {recorded}")
    per_forward = k6_per_layer(cfg) * cfg.n_layers
    total_steps = sum(steps.values())
    if (launches["paged_decode_attention"] != cfg.n_layers * total_steps
            or launches["int8_matmul"] % per_forward
            or launches["int8_matmul"] < per_forward * steps[True]
            or by_route["int8_matmul"] != {"mma_bf16": launches["int8_matmul"], "simt": 0}):
        raise AssertionError(f"jobs (d): launches {launches} {by_route} over steps {steps}")
    return {"status": workflow.get_status("chip_smoke_jobs"), "output": out,
            "trigger_refusals_before_wait": refused, "trigger": delivered,
            "steps_durable_after_failure": recorded, "run_s": run_s, "resume_s": resume_s,
            "decode_steps": {"float": steps[False], "int8": steps[True]},
            "launches": launches, "launches_by_route": by_route,
            "launches_after_resume": after}, actors


def jobs_state(torch, rt, url: str, workdir: str) -> dict:
    """(e) the state API and the head on the card; a profiled GPU task."""
    import pstats
    import urllib.request

    import chip_smoke as smoke
    from ray_tpu_torch import state

    with urllib.request.urlopen(url + "/api/cluster_status", timeout=60) as resp:
        status = json.loads(resp.read())
    nodes = state.list_nodes()
    engines = [a for a in state.list_actors() if a["class_name"] == "EngineActor"
               and a["state"] == "ALIVE"]
    steps = [t for t in state.list_tasks() if t["name"].endswith("wf_generate")]
    if status["resources_total"].get("GPU") != 1 or [n["resources_total"].get("GPU")
                                                      for n in nodes] != [1]:
        raise AssertionError(f"jobs (e): GPU totals {status} {nodes}")
    if sorted(a["resources"].get("GPU") for a in engines) != [0.25, 0.25]:
        raise AssertionError(f"jobs (e): engine actors {engines}")
    if [t["state"] for t in steps] != ["FINISHED", "FINISHED"]:
        raise AssertionError(f"jobs (e): the workflow's GPU steps {steps}")
    prof_dir = os.path.join(workdir, "profiles")
    t0 = time.perf_counter()
    got = rt.get(rt.remote(smoke.jobs_profiled_matmul).options(
        num_gpus=0.5, runtime_env={"profiling": {"dir": prof_dir},
                                   "env_vars": {"JOBS_FLAG": "on"}}).remote(JOBS_PROFILE_N),
        timeout=JOBS_TIMEOUT_S)
    task_s = time.perf_counter() - t0
    profs = glob.glob(os.path.join(prof_dir, "*jobs_profiled_matmul_*.prof"))
    if (got["pid"] == os.getpid() or got["flag"] != "on" or not got["finite"]
            or got["device"] != torch.cuda.get_device_name(0) or len(profs) != 1):
        raise AssertionError(f"jobs (e): profiled task {got}, profiles {profs}")
    calls = pstats.Stats(profs[0]).total_calls
    if calls <= 0:
        raise AssertionError(f"jobs (e): {profs[0]} holds no calls")
    return {"cluster_gpu_total": status["resources_total"]["GPU"],
            "node_gpu_total": nodes[0]["resources_total"]["GPU"],
            "engine_actor_shares": [a["resources"] for a in engines],
            "gpu_steps_finished": len(steps), "profiled_task_s": task_s,
            "profile_calls": calls, "profiled_task_device": got["device"]}


def run_jobs(torch, kernels_of: dict, card: str):
    """The jobs phase: (a)-(e) under one ``init(num_cpus=8,
    include_dashboard=True)``, then ``shutdown`` with the usage report
    written and no job's process left. Yields one report per part."""
    import gc as _gc

    import ray_tpu_torch as rt
    from ray_tpu_torch.job.manager import group_members
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.models.transformer import init_params

    t_phase = time.perf_counter()
    # the jobs' decoder (CUT_LAYERS layers) as they build it, and this
    # process's own burst on it: what each job's digests are held to
    cfg = jobs_config(torch)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(JOBS_SEED))
    want = {q: run_engine(torch, cfg, params, "paged", 8, 64, 32, {}, quantize=q)[
        "request_tokens"] for q in (False, True)}
    torch.cuda.empty_cache()
    libs = lib_stamps()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_jobs_")
    with open(os.path.join(workdir, "driver.py"), "w") as f:
        f.write("import sys\n\nimport chip_smoke\n\nsys.exit(chip_smoke.job_driver())\n")
    counters = {n: kernels_of[n] for n in ("paged_decode_attention", "int8_matmul")}
    rt.init(num_cpus=8, include_dashboard=True)
    actors = {}
    try:
        cluster = rt.get_cluster()
        url = cluster.dashboard.url
        client = JobSubmissionClient(url)
        session_dir = cluster.session_dir
        rep = jobs_submitted(torch, rt, cfg, client, workdir, want, libs)
        yield {"part": "submitted_job", "card": card, **rep}
        yield {"part": "stopped_job", "card": card, **jobs_stop(torch, rt, client, workdir)}
        rep, actors = jobs_workflow(torch, rt, cfg, params, counters, want, workdir, url)
        yield {"part": "workflow", "card": card, **rep}
        yield {"part": "state", "card": card, **jobs_state(torch, rt, url, workdir)}
        pgids = [os.getpgid(e.proc.pid) for e in cluster.dashboard.job_manager._jobs.values()
                 if e.proc is not None and e.proc.poll() is None]
        jobs = cluster.dashboard.job_manager.list_jobs()
        for a in actors.values():
            rt.get(a.close.remote())
            rt.kill(a)
    finally:
        import chip_smoke as smoke

        smoke._WF_ENGINES.clear()
        actors.clear()
        rt.shutdown()
    _gc.collect()
    torch.cuda.empty_cache()
    left = [g for g in pgids if group_members(g)]
    usage = os.path.join(session_dir, "usage_stats.json")
    with open(usage) as f:
        report = json.load(f)
    if left or report.get("source") != "ray_tpu_torch":
        raise AssertionError(f"jobs: after shutdown job groups {left} remain, usage {report}")
    yield {"part": "shutdown", "card": card, "layers": CUT_LAYERS,
           "jobs": sorted(j["status"] for j in jobs),
           "job_groups_left": 0, "usage_stats": {k: report[k] for k in ("source", "version")},
           "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the operator surface: the rt CLI, scripts/, the autoscaler, analysis/
# ---------------------------------------------------------------------------
CLI_SHARE = 0.5  # (a): the card's share each Serve replica holds
CLI_TIMEOUT_S = 300.0  # the bound on each wait of the phase
CLI_FREE_SLACK = 64 << 20  # (a): allocated bytes back within this after shutdown
CLI_IDLE_TIMEOUT_S = 2.0  # (b): the autoscaler's idle timeout
CLI_BENCH_TIMEOUT_S = 600.0  # (c), (d), (g): the bound on each subprocess
#: (e): the rows of ``rt microbenchmark`` the phase runs on the card, in
#: one call, and the LLM rows, each in a call of its own
CLI_MICROBENCH_ROWS = ("single_client_tasks_sync", "1_1_actor_calls_sync",
                       "single_client_put_calls", "single_client_get_calls",
                       "xproc_object_gigabytes", "hbm_put_gigabytes", "hbm_get_gigabytes",
                       "broadcast_64mb_to_n", "broadcast_root_egress_x")
CLI_LLM_ROWS = ("llm_paged_capacity_x", "llm_chunked_prefill_stall_p99",
                "llm_concurrent_streams_x", "llm_prefix_cache_ttft_x",
                "llm_disagg_intertoken_p99")
CLI_APPS = types.SimpleNamespace()  # (a): the applications the YAML's import paths name


def cli_run(argv) -> tuple:
    """(exit code, stdout) of ``rt <argv>`` run in this process."""
    import contextlib
    import io

    from ray_tpu_torch.scripts import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    return rc, out.getvalue()


def cli_ok(argv) -> str:
    rc, out = cli_run(argv)
    if rc != 0:
        raise AssertionError(f"cli: `rt {' '.join(argv)}` exited {rc}: {out[-2000:]}")
    return out


def cli_module(argv, timeout_s: float = CLI_BENCH_TIMEOUT_S, **kw):
    """``python -m ray_tpu_torch...`` from the checkout's root."""
    return subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                          timeout=timeout_s, cwd=os.path.dirname(os.path.abspath(__file__)), **kw)


def busy_paged_engine(out: str) -> bool:
    """``rt llm``'s text lists an engine with ``cache=paged`` that holds
    blocks while it serves: slots active, requests queued or a prefill in
    flight."""
    for block in re.split(r"(?m)^(?=engine \d+:)", out):
        head = re.match(r"engine \d+: cache=paged,.* (\d+)/\d+ slots, (\d+) queued", block)
        pool = re.search(r"kv pool: (\d+)/\d+ blocks in use", block)
        prefill = re.search(r"prefill: (\d+) in flight", block)
        if head and pool and int(pool.group(1)) > 0 and (
                int(head.group(1)) > 0 or int(head.group(2)) > 0
                or (prefill and int(prefill.group(1)) > 0)):
            return True
    return False


def cli_serve(torch, rt, cfg, params, kernels_of: dict, want: dict, workdir: str) -> dict:
    """(a) ``rt serve deploy`` of a YAML holding the ``LLMServer`` float and
    int8 at a share of the card each, the burst over HTTP, the operator
    commands during and after it, and ``rt serve shutdown``."""
    import gc as _gc

    import chip_smoke as smoke
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import LLMServer

    kw = dict(max_batch_size=8, max_seq_len=cfg.max_seq_len, kv_block_size=16,
              cache_kind="paged")
    for quantize in (False, True):
        name = "llm_int8" if quantize else "llm_float"
        setattr(smoke.CLI_APPS, name, serve.deployment(LLMServer, name=name).bind(
            lambda: (cfg, params), quantize=quantize, **kw))
    # YAML in its JSON form (JSON is YAML)
    path = os.path.join(workdir, "serve.yaml")
    with open(path, "w") as f:
        json.dump({"applications": [
            {"name": name, "route_prefix": "/" + name,
             "import_path": f"chip_smoke:CLI_APPS.{name}",
             "deployments": [{"name": name, "ray_actor_options": {"num_gpus": CLI_SHARE}}]}
            for name in ("llm_float", "llm_int8")]}, f, indent=2)
    url = rt.get_cluster().dashboard.url
    _gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    deployed = json.loads(cli_ok(["serve", "deploy", path]))["deployed"]
    deploy_s = time.perf_counter() - t0
    if sorted(deployed) != ["llm_float", "llm_int8"]:
        raise AssertionError(f"cli (a): deployed {deployed}")
    prompts = burst_prompts(cfg, 8, 64)
    runs = {}
    launches_all, routes_all = {}, {}
    for quantize in (False, True):
        name = "llm_int8" if quantize else "llm_float"
        names = ["paged_decode_attention"] + (["int8_matmul"] if quantize else [])
        counters = {n: kernels_of[n] for n in names}
        http = serve.proxy_url() + "/" + name
        http_json(http, {"prompt": [5] * 64, "max_tokens": 2})  # the loop's cuBLAS handle
        seen = {}
        burst = {}

        def run_burst():
            try:
                burst["out"] = served_burst(prompts, lambda i: http_events(
                    http, {"prompt": prompts[i], "max_tokens": 32, "stream": True}), counters)
            except BaseException as exc:  # noqa: BLE001 - raised below
                burst["error"] = exc

        th = threading.Thread(target=run_burst)
        th.start()
        while th.is_alive() and "llm" not in seen:
            out = cli_ok(["llm", "--address", url])
            if busy_paged_engine(out):
                seen["llm"] = out
                seen["status"] = cli_ok(["status", "--address", url])
            time.sleep(0.05)
        th.join(timeout=CLI_TIMEOUT_S)
        if "error" in burst:
            raise burst["error"]
        tokens, launches, by_route, nums = burst["out"]
        what = f"cli (a) {name}"
        if "llm" not in seen or not re.search(r"\n\s+[\d.]+/1 GPU used", seen["status"]):
            raise AssertionError(f"{what}: during the burst `rt llm` / `rt status` showed {seen}")
        if tokens != want[quantize]:
            raise AssertionError(f"{what}: tokens differ from the engine phase's")
        steps, rem = divmod(launches["paged_decode_attention"], cfg.n_layers)
        if rem or steps < 31:
            raise AssertionError(f"{what}: K1 {launches}, not {cfg.n_layers} a decode step")
        per_forward = k6_per_layer(cfg) * cfg.n_layers
        if quantize and (launches["int8_matmul"] % per_forward
                         or launches["int8_matmul"] < per_forward * steps
                         or by_route["int8_matmul"] != {"mma_bf16": launches["int8_matmul"],
                                                        "simt": 0}):
            raise AssertionError(f"{what}: K6 {launches} {by_route}")
        runs[name] = {**nums, "decode_steps": steps, "launches": launches,
                      "launches_by_route": by_route,
                      "rt_llm_during_burst": seen["llm"].strip().splitlines()}
        for n, x in launches.items():
            launches_all[n] = launches_all.get(n, 0) + x
        for n, per in by_route.items():
            routes_all[n] = {r: routes_all.get(n, {}).get(r, 0) + x for r, x in per.items()}
    t0 = time.perf_counter()
    after = {" ".join(argv): len(cli_ok(argv + extra)) for argv, extra in (
        (["requests"], ["--address", url]), (["metrics"], ["--address", url]),
        (["summary", "tasks"], ["--address", url]), (["serve", "status"], []))}
    commands_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cli_ok(["serve", "shutdown"])
    smoke.CLI_APPS.__dict__.clear()

    def freed():
        _gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() <= base + CLI_FREE_SLACK

    wait_for("cli (a): the replicas' memory freed after `rt serve shutdown`", freed,
             SERVE_TEARDOWN_WAIT_S)
    shutdown_s = time.perf_counter() - t0
    return {"yaml_apps": sorted(deployed), "num_gpus_each": CLI_SHARE, "deploy_s": deploy_s,
            "requests": 8, "prompt_len": 64, "max_tokens": 32, "runs": runs,
            "tokens_equal_engine_phase": True, "commands_after_burst_bytes": after,
            "commands_after_burst_s": commands_s,
            "freed_gb": (held - torch.cuda.memory_allocated()) / 1e9,
            "serve_shutdown_s": shutdown_s, "launches": launches_all,
            "launches_by_route": routes_all}


def cli_autoscaler(torch, cfg, params, kernels_of: dict, want_tokens) -> dict:
    """(b) a runtime whose head holds no GPU: a ``num_gpus=1`` engine actor
    waits until a ``Monitor`` over an ``InProcessNodeProvider`` launches the
    ``{"CPU": 2, "GPU": 1}`` node type (max 1); it serves the burst; after
    the kill the idle timeout terminates the node; ``request_resources``
    launches one again and clearing it terminates it."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import (AutoscalerConfig, InProcessNodeProvider, Monitor,
                                          NodeTypeConfig, sdk)

    k1 = {"paged_decode_attention": kernels_of["paged_decode_attention"]}
    rt.init(num_cpus=4, num_gpus=0)
    monitor = None
    try:
        cluster = rt.get_cluster()
        if rt.cluster_resources().get("GPU", 0) != 0:
            raise AssertionError(f"cli (b): the head holds a GPU: {rt.cluster_resources()}")
        provider = InProcessNodeProvider(cluster)
        monitor = Monitor(cluster, AutoscalerConfig(
            node_types={"gpu": NodeTypeConfig("gpu", {"CPU": 2, "GPU": 1}, max_workers=1)},
            idle_timeout_s=CLI_IDLE_TIMEOUT_S, update_interval_s=0.1), provider=provider)
        scaler = monitor.autoscaler
        t_demand = time.perf_counter()
        actor = rt.remote(EngineActor).options(num_gpus=1).remote(cfg, params, False)
        monitor.start()
        wait_for("cli (b): the GPU node's launch", lambda: scaler.num_launches >= 1,
                 CLI_TIMEOUT_S)
        t_launch = time.perf_counter()
        rt.get(actor.warm.remote(64), timeout=CLI_TIMEOUT_S)
        sid = rt.get(actor.open_stream.remote(burst_prompts(cfg, 1, 64)[0], 1))
        rt.get(actor.next_token.remote(sid))
        t_first = time.perf_counter()
        steps0 = rt.get(actor.decode_steps.remote())
        zero_counters(k1)
        tokens = rt.get(actor.generate.remote(burst_prompts(cfg, 8, 64), 32),
                        timeout=CLI_TIMEOUT_S)
        steps = rt.get(actor.decode_steps.remote()) - steps0
        launches, _ = read_counters(k1)
        if tokens != want_tokens:
            raise AssertionError("cli (b): the autoscaled actor's tokens differ from direct")
        if launches["paged_decode_attention"] != cfg.n_layers * steps:
            raise AssertionError(f"cli (b): K1 {launches} over {steps} decode steps")
        gpu_node = [n for n in cluster.nodes.values()
                    if not n.dead and n.pool.total.to_dict().get("GPU") == 1]
        rt.get(actor.close.remote())
        rt.kill(actor)
        del actor
        t_kill = time.perf_counter()
        wait_for("cli (b): the idle GPU node's termination",
                 lambda: not provider.non_terminated_nodes(), CLI_TIMEOUT_S)
        idle_s = time.perf_counter() - t_kill
        t0 = time.perf_counter()
        sdk.request_resources(bundles=[{"GPU": 1}])
        wait_for("cli (b): request_resources' launch",
                 lambda: len(provider.non_terminated_nodes()) == 1, CLI_TIMEOUT_S)
        request_s = time.perf_counter() - t0
        sdk.request_resources()
        t0 = time.perf_counter()
        wait_for("cli (b): the cleared request's termination",
                 lambda: not provider.non_terminated_nodes(), CLI_TIMEOUT_S)
        clear_s = time.perf_counter() - t0
    finally:
        if monitor is not None:
            monitor.stop()
        rt.shutdown()
    return {"head_gpu": 0, "node_type": {"CPU": 2, "GPU": 1}, "gpu_nodes_launched": len(gpu_node),
            "launches_total": scaler.num_launches, "terminations_total": scaler.num_terminations,
            "demand_to_launch_s": t_launch - t_demand, "launch_to_first_token_s": t_first - t_launch,
            "decode_steps": steps, "tokens_equal_direct": True, "idle_to_terminate_s": idle_s,
            "request_to_launch_s": request_s, "clear_to_terminate_s": clear_s,
            "launches": launches, "launches_by_route": {}}


def cli_llm_bench(torch, cfg, workdir: str) -> dict:
    """(c) ``python -m ray_tpu_torch.scripts.llm_bench <out.json>``."""
    out_path = os.path.join(workdir, "llm_bench.json")
    t0 = time.perf_counter()
    p = cli_module(["ray_tpu_torch.scripts.llm_bench", out_path])
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"cli (c): llm_bench exited {p.returncode}: {p.stderr[-3000:]}")
    with open(out_path) as f:
        rep = json.load(f)
    x = rep["extra"]
    if (rep["unit"] != "tokens/s" or not rep["value"] > 0 or x["cache_kind"] != "paged"
            or x["device"] != torch.cuda.get_device_name(0)
            or x["k1_launches"] != cfg.n_layers * x["decode_steps"]
            or x["total_tokens"] != 3 * 8 * 128):
        raise AssertionError(f"cli (c): llm_bench {rep}")
    # the subprocess's own K1 counter, over its timed waves
    return {"llm_bench": rep, "wall_s": wall,
            "launches": {"paged_decode_attention": x["k1_launches"]}, "launches_by_route": {}}


def cli_kernel_bench(torch) -> dict:
    """(d) ``python -m ray_tpu_torch.scripts.kernel_bench`` with its
    defaults: K2 and K3 held against their plain versions, then timed."""
    t0 = time.perf_counter()
    p = cli_module(["ray_tpu_torch.scripts.kernel_bench"])
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"cli (d): kernel_bench exited {p.returncode}: {p.stderr[-3000:]}")
    rep = json.loads(p.stdout.strip().splitlines()[-1])
    tile = rep["flash_tile"]
    routes = rep["flash_launches_by_route"]
    if (rep["device"] != torch.cuda.get_device_name(0) or f"flash_{tile}_ms" not in rep
            or not rep["decode_kernel_us"] > 0 or rep["flash_blocks_requested"] == []
            or rep["decode_launches"] < 1
            or routes != {"wgmma_bf16": rep["flash_launches"], "simt_f32": 0}
            or rep["flash_launches"] < 1):
        raise AssertionError(f"cli (d): kernel_bench {rep}")
    # the subprocess's own K2 / K3 counters (its checks and timed calls)
    return {"kernel_bench": rep, "wall_s": wall,
            "launches": {"decode_attention": rep["decode_launches"],
                         "flash_attention_forward": rep["flash_launches"]},
            "launches_by_route": {"flash_attention_forward": routes}}


def microbench_rows(out: str, names) -> dict:
    """{row: {value, unit}} of ``rt microbenchmark``'s printed table."""
    rows = {}
    for line in out.splitlines():
        parts = line.split()
        if parts and parts[0] in names:
            rows[parts[0]] = {"value": float(parts[1]), "unit": parts[2]}
    return rows


def cli_microbenchmark(kernels_of: dict) -> dict:
    """(e) ``rt microbenchmark --quick --only ...`` in this process: every
    runtime, copy and LLM row back with its unit. Of the LLM rows' in-row
    guards only the two timing floors that the host-bound engine misses in
    some runs (``TimingFloorMissed``: the chunked-prefill stall p99 and the
    prefix-cache TTFT ratio) are reported rather than raised, with the row's
    value and unit from the exception; every other guard (tokens, leaked
    blocks, streams, migrations, the other floors) fails the phase."""
    from ray_tpu_torch.scripts.microbench import BASELINES, TimingFloorMissed

    counters = {n: kernels_of[n] for n in ("paged_decode_attention", "decode_attention")}
    t0 = time.perf_counter()
    rows = microbench_rows(cli_ok(["microbenchmark", "--quick", "--only",
                                   ",".join(CLI_MICROBENCH_ROWS)]), CLI_MICROBENCH_ROWS)
    if sorted(rows) != sorted(CLI_MICROBENCH_ROWS):
        raise AssertionError(f"cli (e): rows {sorted(rows)} of {CLI_MICROBENCH_ROWS}")
    for name, base in BASELINES.items():
        if name in rows and rows[name]["unit"] != base[1]:
            raise AssertionError(f"cli (e): {name} in {rows[name]['unit']}, not {base[1]}")
    zero_counters(counters)
    guards = {}
    for row in CLI_LLM_ROWS:
        try:
            got = microbench_rows(cli_ok(["microbenchmark", "--quick", "--only", row]), [row])
            guards[row] = "held"
        except TimingFloorMissed as exc:
            if exc.row != row:
                raise
            got = {row: {"value": exc.value, "unit": exc.unit}}
            guards[row] = f"timing floor missed: {exc}"
        if sorted(got) != [row] or not got[row]["unit"]:
            raise AssertionError(f"cli (e): {row} came back as {got}")
        rows.update(got)
    launches, _ = read_counters(counters)
    if min(launches.values()) < 1:
        raise AssertionError(f"cli (e): the LLM rows on the card launched {launches}")
    return {"rows": rows, "llm_guards": guards, "wall_s": time.perf_counter() - t0,
            "launches": launches, "launches_by_route": {}}


def cli_lint() -> dict:
    """(f) ``rt lint`` over ``ray_tpu_torch/``: zero violations."""
    t0 = time.perf_counter()
    rc, out = cli_run(["lint", "--json"])
    lint_s = time.perf_counter() - t0
    violations = json.loads(out)
    if rc != 0 or violations:
        raise AssertionError(f"cli (f): rt lint exited {rc}: {violations}")
    return {"violations": 0, "lint_s": lint_s}


def cli_start_stop(torch) -> dict:
    """(g) ``rt start`` and ``rt stop`` as processes: the head comes up on
    the port's own address file, ``rt status`` reads it, ``rt stop`` ends it
    and the card's memory is free again."""
    from ray_tpu_torch.scripts import cli

    free0, _ = torch.cuda.mem_get_info()
    if os.path.exists(cli.ADDRESS_FILE):
        os.unlink(cli.ADDRESS_FILE)
    t0 = time.perf_counter()
    head = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", "start", "--num-cpus", "2",
                             "--dashboard-port", "0"],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        wait_for("cli (g): the head's address file", lambda: os.path.exists(cli.ADDRESS_FILE),
                 CLI_TIMEOUT_S, interval_s=0.2)
        start_s = time.perf_counter() - t0
        with open(cli.ADDRESS_FILE) as f:
            info = json.load(f)
        if info["pid"] != head.pid or not cli._pid_is_head(head.pid):
            raise AssertionError(f"cli (g): address file {info}, head pid {head.pid}")
        status = cli_module(["ray_tpu_torch", "status"], timeout_s=CLI_TIMEOUT_S)
        if status.returncode != 0 or not re.search(r"/1 GPU used", status.stdout):
            raise AssertionError(f"cli (g): rt status {status.returncode}: {status.stdout}"
                                 f"{status.stderr[-2000:]}")
        t1 = time.perf_counter()
        stop = cli_module(["ray_tpu_torch", "stop"], timeout_s=CLI_TIMEOUT_S)
        rc = head.wait(timeout=CLI_TIMEOUT_S)
        stop_s = time.perf_counter() - t1
    finally:
        if head.poll() is None:
            head.kill()
            head.wait()
    if stop.returncode != 0 or rc != 0 or os.path.exists(cli.ADDRESS_FILE):
        raise AssertionError(f"cli (g): rt stop {stop.returncode} {stop.stdout}, head rc {rc}")
    free1 = wait_for("cli (g): the card's memory free again",
                     lambda: (lambda f: f if f >= free0 - CLI_FREE_SLACK else None)(
                         torch.cuda.mem_get_info()[0]), CLI_TIMEOUT_S)
    return {"start_s": start_s, "stop_s": stop_s, "address_file": cli.ADDRESS_FILE,
            "status_lines": status.stdout.strip().splitlines(),
            "free_gb_before": free0 / 1e9, "free_gb_after": free1 / 1e9}


def run_cli(torch, cfg, params, kernels_of: dict, engine_tokens: dict, card: str):
    """The cli phase: (a) and (b) in this process over the serving decoder,
    (c) and (d) as subprocesses, (e) and (f) in this process, (g) as
    subprocesses. Yields one report per part."""
    import shutil

    import ray_tpu_torch as rt

    t_phase = time.perf_counter()
    want = {}  # quantize -> this process's own burst: the engine phase's, or run now
    for q in (False, True):
        want[q] = engine_tokens.get(("paged", q)) or run_engine(
            torch, cfg, params, "paged", 8, 64, 32, {}, quantize=q)["request_tokens"]
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        rt.init(num_cpus=8, include_dashboard=True)
        try:
            rep = cli_serve(torch, rt, cfg, params, kernels_of, want, workdir)
        finally:
            rt.shutdown()
        yield {"part": "a_serve_deploy", "card": card, **rep}
        torch.cuda.empty_cache()
        yield {"part": "b_autoscaler", "card": card,
               **cli_autoscaler(torch, cfg, params, kernels_of, want[False])}
        torch.cuda.empty_cache()
        yield {"part": "c_llm_bench", "card": card, **cli_llm_bench(torch, cfg, workdir)}
        yield {"part": "d_kernel_bench", "card": card, **cli_kernel_bench(torch)}
        yield {"part": "e_microbenchmark", "card": card, **cli_microbenchmark(kernels_of)}
        torch.cuda.empty_cache()
        yield {"part": "f_lint", "card": card, **cli_lint()}
        yield {"part": "g_start_stop", "card": card, **cli_start_stop(torch)}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    yield {"part": "done", "card": card, "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the multi-node runtime core: a head here, node agents as processes
# ---------------------------------------------------------------------------
MULTINODE_OBJECT_SHAPE = (16384, 32768)  # (b): 512M bf16 elements, 1 GiB, made on the agent
MULTINODE_ARG_SHAPE = (8192, 16384)  # (b): 128M bf16 elements, 256 MiB, the driver's argument
MULTINODE_PUSH_TASKS = 200  # (c): repeat-shape tasks to the agent
MULTINODE_AR_BYTES = 64 << 20  # (d): the allreduced f32 tensor
MULTINODE_AR_REPS = 3
MULTINODE_SEED = 43
MULTINODE_JOIN_S = 120.0  # the bound on an agent's join
MULTINODE_FREE_SLACK = 1 << 30  # (e): the card's free memory back within 1 GiB
MULTINODE_FREE_WAIT_S = 60.0
MULTINODE_DIGEST_CHUNK = 1 << 26  # elements a step of card_digest
MULTINODE_PLAN_ITERS = 4  # (g): executes of the engine phase's 8 prompts, one after another
MULTINODE_KILL_INFLIGHT = 3  # (g): executes in flight when the agent is killed after the first


def card_digest(x) -> str:
    """A digest of a tensor's bits computed on the card, in chunks: the bit
    patterns summed plain and weighted by position."""
    import torch

    flat = x.detach().contiguous().reshape(-1)
    bits = flat.view(torch.int32 if flat.element_size() == 4 else torch.int16)
    plain = weighted = 0
    for lo in range(0, bits.numel(), MULTINODE_DIGEST_CHUNK):
        part = bits[lo:lo + MULTINODE_DIGEST_CHUNK].long()
        w = torch.arange(lo, lo + part.numel(), device=part.device) % 1000003 + 1
        plain += int(part.sum())
        weighted += int((part * w).sum())
    return hashlib.sha256(f"{x.dtype}:{tuple(x.shape)}:{plain}:{weighted}".encode()).hexdigest()


def mn_make_object(shape, seed: int):
    """(b): a bf16 CUDA tensor made on the agent, and its digest."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.empty(shape, device="cuda", dtype=torch.bfloat16)
    for row in range(0, shape[0], 1024):  # f32 draws a slab at a time: no 2 GiB temporary
        x[row:row + 1024] = torch.randn((min(1024, shape[0] - row), shape[1]), generator=g,
                                        device="cuda").to(torch.bfloat16)
    return x, card_digest(x)


mn_make_object._rt_device = True  # in the agent's process, beside the card


def mn_digest_on_card(x):
    """(b): the driver's tensor, moved to ``cuda:0`` on the agent."""
    import os as _os

    y = x.to("cuda:0")
    return card_digest(y), str(y.device), str(x.device), _os.getpid()


mn_digest_on_card._rt_device = True


def mn_nine():
    """(c): the repeat-shape task."""
    return 9


class AgentEngine:
    """(a) and (e)'s GPU actor on the agent: it builds the serving decoder
    from the serving phases' seed on the card (the weights never cross the
    wire) and serves the burst, opened in one call and read token by token
    from the driver. K1 and K6 are counted here, in the agent's process."""

    def __init__(self, quantize: bool):
        import torch

        from ray_tpu_torch.models.transformer import init_params

        cfg = serving_config(torch)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        self.inner = EngineActor(cfg, params, quantize)
        del params
        self.quantize = quantize
        self.queues = []
        self.pumps = []

    def warm(self) -> int:
        self.inner.warm(64)
        return os.getpid()

    def open_burst(self, prompts, max_tokens: int) -> int:
        import queue

        from ray_tpu_torch.ops.decode_attention import paged_decode_attention
        from ray_tpu_torch.ops.quantization import int8_matmul

        self.counters = {"paged_decode_attention": paged_decode_attention}
        if self.quantize:
            self.counters["int8_matmul"] = int8_matmul
        zero_counters(self.counters)
        self.steps0 = self.inner.decode_steps()
        self.queues = [queue.Queue() for _ in prompts]
        streams = [self.inner.engine.submit_stream(p, max_tokens=max_tokens) for p in prompts]

        def pump(q, stream):
            try:
                for tok in stream:
                    q.put(tok)
            finally:
                q.put(None)

        self.pumps = [threading.Thread(target=pump, args=(q, s), daemon=True)
                      for q, s in zip(self.queues, streams)]
        for t in self.pumps:
            t.start()
        return os.getpid()

    def next_tokens(self, i: int):
        """At least one token of request ``i`` (waiting for it), and any
        more already there; None ends the stream."""
        import queue

        q = self.queues[i]
        out = [q.get(timeout=600)]
        while out[-1] is not None:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                break
        return out

    def burst_counts(self) -> dict:
        for t in self.pumps:
            t.join(timeout=600)
        launches, by_route = read_counters(self.counters)
        return {"launches": launches, "launches_by_route": by_route,
                "decode_steps": self.inner.decode_steps() - self.steps0, "pid": os.getpid()}

    def close(self) -> bool:
        self.inner.close()
        return True


class AgentDagEngine(DagEngine):
    """(g)'s engine stage in the agent's process: the ``dag`` phase's
    engine actor on the serving decoder at full depth, built there from the
    serving phases' seed on the card (the weights never cross the wire).
    K1 and the CUDA IPC pulls of the plan's inbound edge are counted here."""

    def __init__(self):
        import torch

        from ray_tpu_torch.models.transformer import init_params
        from ray_tpu_torch.ops.decode_attention import paged_decode_attention

        cfg = serving_config(torch)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        super().__init__(cfg, params, False)
        del params
        self.counters = {"paged_decode_attention": paged_decode_attention}
        self.steps0 = self.pulls0 = 0

    def zero(self) -> int:
        from ray_tpu_torch.runtime import device_plane

        zero_counters(self.counters)
        self.steps0 = self.decode_steps()
        self.pulls0 = device_plane.stats.snapshot()["ici_pulls"]
        return os.getpid()

    def counts(self) -> dict:
        from ray_tpu_torch.runtime import device_plane

        launches, _ = read_counters(self.counters)
        return {"launches": launches, "decode_steps": self.decode_steps() - self.steps0,
                "ici_pulls": device_plane.stats.snapshot()["ici_pulls"] - self.pulls0,
                "pid": os.getpid()}


class MultinodeRank:
    """(d)'s member: one rank of a collective group holding a seeded f32
    tensor on the card of its process."""

    def __init__(self, rank: int, seed: int):
        import torch

        from ray_tpu_torch.util import collective

        collective.init_collective_group(2, rank, group_name="mn-ar")
        g = torch.Generator(device="cuda").manual_seed(seed + rank)
        self.x = torch.randn(MULTINODE_AR_BYTES // 4, generator=g, device="cuda")
        self.rank = rank

    def where(self):
        return os.getpid()

    def value(self):
        return self.x

    def allreduce(self):
        import torch

        from ray_tpu_torch.util import collective

        out = collective.allreduce(self.x, group_name="mn-ar", rank=self.rank)
        torch.cuda.current_stream().synchronize()
        return out


def mn_spawn_agent(address: str, log_dir: str, tag: str):
    """A node agent process with the card: ``--num-gpus 1``, stderr to a
    file of its own (printed if the phase fails)."""
    path = os.path.join(log_dir, f"agent_{tag}.log")
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with open(path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.runtime.agent", "--address", address,
             "--num-cpus", "2", "--num-gpus", "1", "--resources", '{"agent": 4}'],
            env=env, stdout=subprocess.DEVNULL, stderr=log)
    return proc, path


def mn_wait_nodes(cluster, n: int, procs) -> float:
    """Seconds until ``n`` nodes are live, bounded; fails at once if an
    agent process exits."""
    t0 = time.perf_counter()
    while sum(1 for node in cluster.nodes.values() if not node.dead) < n:
        for p in procs:
            if p.poll() is not None:
                raise AssertionError(f"agent pid {p.pid} exited with {p.returncode} before joining")
        if time.perf_counter() - t0 > MULTINODE_JOIN_S:
            raise AssertionError(f"no {n} live nodes within {MULTINODE_JOIN_S} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


def mn_agent_id(cluster):
    return next(nid for nid, node in cluster.nodes.items()
                if nid != cluster.head_node.node_id and not node.dead)


def mn_burst(rt, actor, prompts, max_tokens: int):
    """The burst through the agent's actor: opened in one call, each
    request read by a driver thread. Returns (tokens, TTFT seconds a
    request seen from here, wall seconds, the actor's counts)."""
    n = len(prompts)
    toks = [[] for _ in range(n)]
    ttft = [None] * n
    errors = []
    t0 = time.perf_counter()
    rt.get(actor.open_burst.remote(prompts, max_tokens), timeout=600)

    def client(i):
        try:
            while True:
                got = rt.get(actor.next_tokens.remote(i), timeout=600)
                if ttft[i] is None:
                    ttft[i] = time.perf_counter() - t0
                toks[i] += [t for t in got if t is not None]
                if got[-1] is None:
                    return
        except BaseException as exc:  # noqa: BLE001 — surfaced below, typed
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return toks, ttft, wall, rt.get(actor.burst_counts.remote(), timeout=600)


def mn_serve(torch, rt, cfg, quantize: bool, want, engine_nums: dict, card: str) -> dict:
    """(a) one run: a ``num_gpus=1`` actor on the agent builds the decoder
    and serves the burst; tokens equal the engine phase's, K1 16 a decode
    step and K6 96 a forward, counted in the agent's process."""
    import chip_smoke as smoke

    prompts = burst_prompts(cfg, 8, 64)
    t0 = time.perf_counter()
    actor = rt.remote(smoke.AgentEngine).options(num_gpus=1, max_concurrency=16).remote(quantize)
    try:
        pid = rt.get(actor.warm.remote(), timeout=600)
        build_s = time.perf_counter() - t0
        got, ttft, wall, counts = mn_burst(rt, actor, prompts, 32)
        rt.get(actor.close.remote(), timeout=120)
    finally:
        rt.kill(actor)
    what = f"multinode (a) {'int8' if quantize else 'float'}"
    if pid == os.getpid() or counts["pid"] != pid:
        raise AssertionError(f"{what}: the actor ran in pid {pid}/{counts['pid']}, the driver "
                             f"is {os.getpid()}")
    if got != want:
        raise AssertionError(f"{what}: tokens differ from the engine phase's")
    launches, by_route, steps = counts["launches"], counts["launches_by_route"], counts["decode_steps"]
    if steps < 31 or launches["paged_decode_attention"] != cfg.n_layers * steps:
        raise AssertionError(f"{what}: K1 {launches} over {steps} decode steps, want "
                             f"{cfg.n_layers} a step")
    per_forward = k6_per_layer(cfg) * cfg.n_layers
    if quantize and (launches["int8_matmul"] % per_forward
                     or launches["int8_matmul"] < per_forward * steps
                     or by_route["int8_matmul"] != {"mma_bf16": launches["int8_matmul"],
                                                    "simt": 0}):
        raise AssertionError(f"{what}: K6 {launches} {by_route}, want {per_forward} a forward "
                             "on the tensor cores")
    n_tok = sum(len(r) for r in got)
    return {"part": "a_agent_engine", "card": card, "quantize": quantize, "requests": 8,
            "prompt_len": 64, "max_tokens": 32, "tokens_equal_engine_phase": True,
            "agent_pid": pid, "driver_pid": os.getpid(), "actor_build_s": build_s,
            "decode_steps": steps, "launches": launches, "launches_by_route": by_route,
            "k1_per_decode_step": launches["paged_decode_attention"] / steps,
            **({"k6_forwards": launches["int8_matmul"] // per_forward} if quantize else {}),
            "tokens_per_s_agent_actor": n_tok / wall,
            "tokens_per_s_engine_phase": engine_nums.get(quantize, {}).get("tokens_per_s"),
            "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
            "ttft_s_engine_phase": {k: v for k, v in engine_nums.get(quantize, {}).items()
                                    if k.startswith("ttft")},
            "wall_s": wall}


def mn_objects(torch, rt, cluster, card: str) -> dict:
    """(b): a 1 GiB bf16 CUDA tensor made on the agent reaches the driver
    on the data plane (its digest equal); the driver's 256 MiB CUDA tensor
    is a ``num_gpus`` task's argument on the agent."""
    import chip_smoke as smoke

    from ray_tpu_torch.runtime import device_plane

    client = cluster.head_service.data_client
    ref, digest_ref = rt.remote(smoke.mn_make_object).options(
        num_gpus=1, num_returns=2, resources={"agent": 1}).remote(MULTINODE_OBJECT_SHAPE,
                                                                 MULTINODE_SEED)
    want = rt.get(digest_ref, timeout=600)
    size = cluster.directory.object_size(ref.id())
    s0, d0 = client.stats.snapshot(), device_plane.stats.snapshot()
    t0 = time.perf_counter()
    x = rt.get(ref, timeout=600)
    torch.cuda.synchronize()
    get_s = time.perf_counter() - t0
    s1, d1 = client.stats.snapshot(), device_plane.stats.snapshot()
    got = card_digest(x)
    nbytes = x.numel() * x.element_size()
    where = str(x.device)
    del x
    shm = s1["shm_handoffs"] - s0["shm_handoffs"]
    streamed = s1["bytes_received"] - s0["bytes_received"]  # framed bytes read
    ipc = d1["ici_pulls"] - d0["ici_pulls"]  # CUDA IPC, card to card
    if got != want:
        raise AssertionError("multinode (b): the 1 GiB tensor's digest differs on the driver")
    if s1["pulls_issued"] - s0["pulls_issued"] < 1 or size < nbytes or (
            shm < 1 and ipc < 1 and streamed < nbytes):
        # a lazy commit (size recorded from the completion notice) and a
        # data-plane pull: the control connection carried metadata only
        raise AssertionError(f"multinode (b): the bytes did not ride the data plane: size "
                             f"{size}, stats {s0} -> {s1}")
    g = torch.Generator(device="cuda").manual_seed(MULTINODE_SEED + 1)
    arg = torch.randn(MULTINODE_ARG_SHAPE, generator=g, device="cuda").to(torch.bfloat16)
    arg_digest = card_digest(arg)
    t0 = time.perf_counter()
    back = rt.get(rt.remote(smoke.mn_digest_on_card).options(
        num_gpus=1, resources={"agent": 1}).remote(arg), timeout=600)
    arg_s = time.perf_counter() - t0
    del arg
    torch.cuda.empty_cache()
    if back[0] != arg_digest or back[1] != "cuda:0" or back[3] == os.getpid():
        raise AssertionError(f"multinode (b): the argument arrived as {back}")
    return {"part": "b_objects", "card": card, "object_bytes": nbytes,
            "object_digest_equal": True, "object_on_driver": where,
            "driver_get_s": get_s, "driver_get_gb_per_s": nbytes / get_s / 1e9,
            "by": "CUDA IPC" if ipc else "shared memory" if shm else "socket",
            "cuda_ipc_pulls": ipc, "shm_handoffs": shm,
            "pulls": s1["pulls_issued"] - s0["pulls_issued"],
            "data_plane_bytes_received": streamed, "directory_size": size,
            "control_carried_payload": False,
            "arg_bytes": MULTINODE_ARG_SHAPE[0] * MULTINODE_ARG_SHAPE[1] * 2,
            "arg_digest_equal": True, "arg_arrived_on": back[2], "arg_on": back[1],
            "arg_task_s": arg_s}


def mn_leased(rt, cluster, card: str) -> dict:
    """(c): 200 repeat-shape tasks to the agent, one at a time: one lease
    grant, then pushes on the data plane with no head-side pick."""
    import chip_smoke as smoke
    from ray_tpu_torch.observability import metric_defs

    nine = rt.remote(smoke.mn_nine).options(resources={"agent": 1}, num_cpus=0)
    g0 = cluster.lease_manager.snapshot()["grants"]
    if rt.get(nine.remote(), timeout=120) != 9:  # the grant, and a warm worker
        raise AssertionError("multinode (c): the first task")
    g1 = cluster.lease_manager.snapshot()["grants"]
    picks0 = cluster.cluster_scheduler.num_picks
    pushes0 = metric_defs.DIRECT_PUSHES.get(tags={"transport": "data_plane"})
    rtt = []
    for _ in range(MULTINODE_PUSH_TASKS):
        t0 = time.perf_counter()
        if rt.get(nine.remote(), timeout=120) != 9:
            raise AssertionError("multinode (c): a pushed task's result")
        rtt.append(time.perf_counter() - t0)
    snap = cluster.lease_manager.snapshot()
    picks = cluster.cluster_scheduler.num_picks - picks0
    pushes = metric_defs.DIRECT_PUSHES.get(tags={"transport": "data_plane"}) - pushes0
    if g1 - g0 != 1 or snap["grants"] != g1 or picks > 2 or pushes < MULTINODE_PUSH_TASKS // 2:
        raise AssertionError(f"multinode (c): grants {g0}->{g1}->{snap['grants']}, picks "
                             f"{picks}, data-plane pushes {pushes}")
    return {"part": "c_leased_pushes", "card": card, "tasks": MULTINODE_PUSH_TASKS,
            "grants": g1 - g0, "grants_after": snap["grants"] - g1,
            "reuse_hits": snap["reuse_hits"], "head_picks": picks,
            "data_plane_pushes": pushes,
            "rtt_ms_median": statistics.median(rtt) * 1e3, "rtt_ms_max": max(rtt) * 1e3}


def mn_collective(torch, rt, cluster, card: str) -> dict:
    """(d): a collective group with one rank in this process and one in a
    GPU actor on the agent allreduces 64 MiB of ``cuda:0`` f32 over the
    data plane: bitwise the sum on each."""
    import chip_smoke as smoke
    from ray_tpu_torch.runtime.scheduler import NodeAffinitySchedulingStrategy

    r0 = rt.remote(smoke.MultinodeRank).options(
        execution="inproc",
        scheduling_strategy=NodeAffinitySchedulingStrategy(cluster.head_node.node_id),
    ).remote(0, MULTINODE_SEED)
    r1 = rt.remote(smoke.MultinodeRank).options(num_gpus=1).remote(1, MULTINODE_SEED)
    ranks = [r0, r1]
    try:
        pids = rt.get([a.where.remote() for a in ranks], timeout=300)
        xs = rt.get([a.value.remote() for a in ranks], timeout=300)
        want = xs[0].cuda() + xs[1].cuda()
        ms, outs = [], None
        for _ in range(MULTINODE_AR_REPS):
            t0 = time.perf_counter()
            outs = rt.get([a.allreduce.remote() for a in ranks], timeout=300)
            ms.append((time.perf_counter() - t0) * 1e3)
        ok = all(torch.equal(o.cuda(), want) for o in outs)
    finally:
        for a in ranks:
            rt.kill(a)
    if pids[0] != os.getpid() or pids[1] == os.getpid() or not ok:
        raise AssertionError(f"multinode (d): ranks in {pids}, bitwise sum {ok}")
    del xs, want, outs
    torch.cuda.empty_cache()
    return {"part": "d_collective", "card": card, "bytes": MULTINODE_AR_BYTES,
            "rank_pids": pids, "bitwise_sum": True, "ms_per_call": ms,
            "ms_per_call_median": statistics.median(ms)}


def mn_kill(torch, rt, cluster, agent, free0: int, card: str):
    """(e) first half: ``kill -9`` the agent while a burst runs on its GPU
    actor: ``ActorDiedError`` within the health check's bound, the node
    dead in the table, the card's free memory back within 1 GiB."""
    import chip_smoke as smoke
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.exceptions import ActorDiedError

    cfg_rt = get_config()
    bound = (cfg_rt.health_check_period_s * cfg_rt.health_check_failure_threshold
             + cfg_rt.health_check_ping_timeout_s)
    agent_id = mn_agent_id(cluster)
    actor = rt.remote(smoke.AgentEngine).options(num_gpus=1, max_concurrency=16).remote(False)
    rt.get(actor.warm.remote(), timeout=600)
    prompts = burst_prompts(serving_config(torch), 8, 64)
    rt.get(actor.open_burst.remote(prompts, 32), timeout=600)
    rt.get(actor.next_tokens.remote(0), timeout=600)  # the burst is decoding
    t_kill = time.perf_counter()
    agent.kill()
    err = None
    try:
        # tokens already queued may still arrive before the death is seen
        while time.perf_counter() - t_kill < bound + 30:
            rt.get(actor.next_tokens.remote(1), timeout=bound + 30)
    except ActorDiedError as exc:
        err = exc
    died_s = time.perf_counter() - t_kill
    agent.wait(timeout=30)
    node_dead_s = None
    while time.perf_counter() - t_kill < bound + 30:
        if cluster.nodes[agent_id].dead:
            node_dead_s = time.perf_counter() - t_kill
            break
        time.sleep(0.05)
    free_s, free = None, torch.cuda.mem_get_info()[0]
    while time.perf_counter() - t_kill < MULTINODE_FREE_WAIT_S:
        free = torch.cuda.mem_get_info()[0]
        if free >= free0 - MULTINODE_FREE_SLACK:
            free_s = time.perf_counter() - t_kill
            break
        time.sleep(0.05)
    if err is None or died_s > bound or node_dead_s is None or free_s is None:
        raise AssertionError(f"multinode (e): error {err!r} after {died_s:.2f} s (bound "
                             f"{bound} s), node dead after {node_dead_s}, free memory "
                             f"{free} vs {free0} before the agent")
    return {"part": "e_agent_kill", "card": card, "error": type(err).__name__,
            "kill_to_typed_error_s": died_s, "health_check_bound_s": bound,
            "kill_to_node_dead_s": node_dead_s, "kill_to_card_free_s": free_s,
            "free_gb_before_agent": free0 / 1e9, "free_gb_after_kill": free / 1e9}


def mn_free_after(torch, t0: float, free0: int):
    """Seconds after ``t0`` until the card's free memory is back within
    ``MULTINODE_FREE_SLACK`` of ``free0`` (None if it is not within
    ``MULTINODE_FREE_WAIT_S``), and the free bytes last seen."""
    free = torch.cuda.mem_get_info()[0]
    while time.perf_counter() - t0 < MULTINODE_FREE_WAIT_S:
        free = torch.cuda.mem_get_info()[0]
        if free >= free0 - MULTINODE_FREE_SLACK:
            return time.perf_counter() - t0, free
        time.sleep(0.05)
    return None, free


def mn_plan(torch, rt, cluster, agent, free0: int, want, engine_nums: dict, dag_nums: dict,
            card: str) -> dict:
    """(g): the ``dag`` phase's graph as a compiled plan whose engine stage
    is a ``num_gpus=1`` actor in ``agent``'s process (full depth), encode
    and decode in this process; ``MULTINODE_PLAN_ITERS`` executes of the
    engine phase's 8 prompts, tokens equal ``want`` each time, K1 16 a
    decode step in the agent, both edges on the CUDA IPC rung (a CUDA IPC
    pull an execute on each side); then ``kill -9`` of the
    agent during an execute: a typed error and ``BROKEN`` within the health
    check's bound, the card freed."""
    import chip_smoke as smoke
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.exceptions import ActorDiedError, WorkerCrashedError
    from ray_tpu_torch.runtime import device_plane
    from ray_tpu_torch.runtime.scheduler import NodeAffinitySchedulingStrategy

    cfg = serving_config(torch)
    texts = [" ".join(map(str, p)) for p in burst_prompts(cfg, 8, 64)]
    here = dict(execution="inproc", num_cpus=0,
                scheduling_strategy=NodeAffinitySchedulingStrategy(cluster.head_node.node_id))
    prompt = rt.remote(smoke.DagPrompt).options(**here).remote()
    detok = rt.remote(smoke.DagDetok).options(**here).remote()
    t0 = time.perf_counter()
    engine = rt.remote(smoke.AgentDagEngine).options(num_gpus=1).remote()
    rt.get(engine.warm.remote(DAG_PROMPT_LEN), timeout=600)
    build_s = time.perf_counter() - t0
    with InputNode() as inp:
        graph = detok.decode.bind(engine.generate_batch.bind(prompt.encode.bind(inp)))
    t0 = time.perf_counter()
    plan = graph.compile_plan(name="agent-serve")
    install_s = time.perf_counter() - t0
    try:
        snap = plan.snapshot()
        kinds = sorted(set(snap["channel_kinds"].values()))
        stage_procs = sorted({d.proc for d in plan._stages})
        if kinds != ["device"] or len(snap["channels"]) != 4 or len(stage_procs) != 2:
            raise AssertionError(f"multinode (g): channels {snap['channel_kinds']}, stage "
                                 f"processes {stage_procs}")
        pid = rt.get(engine.zero.remote(), timeout=60)
        pulls0 = device_plane.stats.snapshot()["ici_pulls"]
        ms, got = [], []
        for _ in range(MULTINODE_PLAN_ITERS):
            t1 = time.perf_counter()
            got.append(plan.execute(texts))
            ms.append((time.perf_counter() - t1) * 1e3)
        counts = rt.get(engine.counts.remote(), timeout=60)
        back_pulls = device_plane.stats.snapshot()["ici_pulls"] - pulls0
    except BaseException:
        plan.teardown()
        raise
    if pid == os.getpid() or counts["pid"] != pid or pid != agent.pid:
        raise AssertionError(f"multinode (g): the engine stage ran in pid {pid}/{counts['pid']}, "
                             f"the agent is {agent.pid}, the driver {os.getpid()}")
    if any([ids for ids, _ in batch] != want for batch in got):
        raise AssertionError("multinode (g): tokens differ from the engine phase's")
    steps, launches = counts["decode_steps"], counts["launches"]
    if steps < (DAG_MAX_TOKENS - 1) * MULTINODE_PLAN_ITERS \
            or launches["paged_decode_attention"] != cfg.n_layers * steps:
        raise AssertionError(f"multinode (g): K1 {launches} over {steps} decode steps, want "
                             f"{cfg.n_layers} a step")

    def rung(pulls):
        return "cuda_ipc" if pulls >= MULTINODE_PLAN_ITERS else "host_staged" if not pulls \
            else f"mixed ({pulls} CUDA IPC pulls)"

    edges = {"encode->generate_batch (driver to agent)": rung(counts["ici_pulls"]),
             "generate_batch->decode (agent to driver)": rung(back_pulls)}
    if set(edges.values()) != {"cuda_ipc"}:
        raise AssertionError(f"multinode (g): a plan edge left the CUDA IPC rung: {edges}")
    n_tok = 8 * DAG_MAX_TOKENS
    # kill -9 of the agent during an execute
    cfg_rt = get_config()
    bound = (cfg_rt.health_check_period_s * cfg_rt.health_check_failure_threshold
             + cfg_rt.health_check_ping_timeout_s)
    futs = [plan.execute_async(texts) for _ in range(MULTINODE_KILL_INFLIGHT)]
    futs[0].result(timeout=600)  # the engine stage now holds the next execute
    t_kill = time.perf_counter()
    agent.kill()
    err, untyped = None, []
    for f in futs[1:]:
        try:
            f.result(timeout=bound + 30)
        except (ActorDiedError, WorkerCrashedError) as exc:
            err = err or exc
        except BaseException as exc:  # noqa: BLE001 — anything untyped fails below
            untyped.append(repr(exc))
    error_s = time.perf_counter() - t_kill
    broken_s = None
    while time.perf_counter() - t_kill < bound + 30:
        if plan.state == "BROKEN":
            broken_s = time.perf_counter() - t_kill
            break
        time.sleep(0.01)
    again = None
    try:
        plan.execute(texts)
    except (ActorDiedError, WorkerCrashedError) as exc:
        again = type(exc).__name__
    plan.teardown()
    rt.kill(prompt)
    rt.kill(detok)
    agent.wait(timeout=30)
    free_s, free = mn_free_after(torch, t_kill, free0)
    if err is None or untyped or error_s > bound \
            or broken_s is None or again is None or free_s is None:
        raise AssertionError(f"multinode (g): after the kill {err!r} {untyped} in "
                             f"{error_s:.2f} s (bound "
                             f"{bound} s), BROKEN after {broken_s}, the next execute "
                             f"{again}, free memory {free} vs {free0}")
    execute_s = statistics.median(ms) / 1e3
    return {"part": "g_plan_on_agent", "card": card, "layers": cfg.n_layers,
            "prompts_per_execute": 8, "executes": MULTINODE_PLAN_ITERS,
            "tokens_equal_engine_phase": True, "stage_pid": pid, "agent_pid": agent.pid,
            "driver_pid": os.getpid(), "stage_processes": stage_procs,
            "channel_kinds": snap["channel_kinds"], "edge_rungs": edges,
            "cuda_ipc_pulls": {"agent": counts["ici_pulls"], "driver": back_pulls},
            "engine_build_s": build_s, "install_s": install_s,
            "decode_steps": steps, "launches": launches, "launches_by_route": {},
            "k1_per_decode_step": launches["paged_decode_attention"] / steps,
            "ms_per_execute": ms, "ms_per_execute_median": statistics.median(ms),
            "tokens_per_s_plan_on_agent": n_tok / execute_s,
            "tokens_per_s_dag_phase_plan": dag_nums.get("tokens_per_s", {}).get("plan"),
            "dag_phase_plan_layers": dag_nums.get("layers"),
            "tokens_per_s_engine_phase": engine_nums.get(False, {}).get("tokens_per_s"),
            "kill_error": type(err).__name__, "kill_to_typed_error_s": error_s,
            "kill_to_broken_s": broken_s, "execute_after_broken": again,
            "health_check_bound_s": bound, "kill_to_card_free_s": free_s,
            "free_gb_after_kill": free / 1e9}


def mn_launcher_up(torch, rt, cluster, card: str):
    """(h) first half: ``rt up`` on the ``local`` provider from a dict
    config (one ``{"CPU": 1, "GPU": 1}`` node type, ``min_workers`` 1): a
    port agent with ``--num-gpus 1`` joins with the card. Returns the
    launcher and the report."""
    from ray_tpu_torch.autoscaler.launcher import ClusterLauncher

    config = {"cluster_name": "chip-smoke", "provider": {"type": "local"},
              "available_node_types": {"gpu_worker": {"resources": {"CPU": 1, "GPU": 1},
                                                      "min_workers": 1, "max_workers": 1}},
              "max_workers": 1, "idle_timeout_s": 600}
    launcher = ClusterLauncher(config)
    t0 = time.perf_counter()
    try:
        launcher.up(timeout_s=MULTINODE_JOIN_S)
    except BaseException:
        launcher.down()
        raise
    up_s = time.perf_counter() - t0
    (provider_id, proc), = launcher.provider._procs.items()
    argv = proc.args
    labeled = [n for n in cluster.nodes.values() if not n.dead
               and (getattr(n, "labels", None) or {}).get("rt_provider_id") == provider_id]
    resources = rt.cluster_resources()
    if len(labeled) != 1 or resources.get("GPU") != 1 \
            or argv[argv.index("--num-gpus") + 1] != "1":
        launcher.down()
        raise AssertionError(f"multinode (h): nodes {labeled}, resources {resources}, "
                             f"agent {argv}")
    return launcher, {"part": "h_rt_up", "card": card, "provider": "local",
                      "agent_argv": argv[1:], "agent_pid": proc.pid,
                      "up_to_join_s": up_s, "resources": resources}


def mn_launcher_down(torch, rt, cluster, launcher, free0: int, card: str) -> dict:
    """(h) second half: ``down`` terminates the agent; its node dies in the
    table and the card's memory returns."""
    (_, proc), = launcher.provider._procs.items()
    nid = next(nid for nid, n in cluster.nodes.items() if not n.dead
               and nid != cluster.head_node.node_id)
    t0 = time.perf_counter()
    launcher.down()
    down_s = time.perf_counter() - t0
    node_dead_s = None
    while time.perf_counter() - t0 < MULTINODE_JOIN_S:
        if cluster.nodes[nid].dead:
            node_dead_s = time.perf_counter() - t0
            break
        time.sleep(0.05)
    free_s, free = mn_free_after(torch, t0, free0)
    if proc.poll() is None or node_dead_s is None or free_s is None:
        raise AssertionError(f"multinode (h): after down the agent {proc.poll()}, node dead "
                             f"{node_dead_s}, free memory {free} vs {free0}")
    return {"part": "h_rt_down", "card": card, "agent_exit": proc.returncode,
            "down_s": down_s, "down_to_node_dead_s": node_dead_s, "down_to_card_free_s": free_s,
            "free_gb_after_down": free / 1e9}


def format_sum(a: int, b: int, label: str) -> str:
    """(i)'s native client calls this by name (``chip_smoke:format_sum``):
    the script's module is importable wherever the runtime runs a task,
    where a ``tests`` package of the machine's site-packages may shadow the
    checkout's ``tests/``."""
    return f"{label}={a + b}"


def reverse_bytes(data: bytes) -> bytes:
    """(i)'s native client's ref-argument call (``chip_smoke:reverse_bytes``)."""
    return bytes(reversed(data))


def mn_client_main(address: str, spec_path: str) -> int:
    """(i)'s client process: ``util.connect`` to the head's
    ``ClientServer``, a ``num_gpus=1`` actor (``AgentEngine``, int8) made
    through the session, the burst read token by token; prints one JSON
    line. Imports no torch: the client needs no card."""
    from ray_tpu_torch import util

    with open(spec_path) as f:
        spec = json.load(f)
    t0 = time.perf_counter()
    ctx = util.connect(address)
    connect_s = time.perf_counter() - t0
    try:
        actor = ctx.remote(AgentEngine).options(num_gpus=1, max_concurrency=16).remote(True)
        t0 = time.perf_counter()
        pid = ctx.get(actor.warm.remote(), timeout=600)
        build_s = time.perf_counter() - t0
        toks, ttft, wall, counts = mn_burst(ctx, actor, spec["prompts"], spec["max_tokens"])
        ctx.get(actor.close.remote(), timeout=120)
        ctx.kill(actor)
    finally:
        ctx.disconnect()
    print(json.dumps({"client_pid": os.getpid(), "connect_s": connect_s, "actor_pid": pid,
                      "actor_build_s": build_s, "tokens": toks, "ttft": ttft, "wall_s": wall,
                      "counts": counts, "torch_imported": "torch" in sys.modules}), flush=True)
    return 0


def mn_client(torch, cfg, server, agent_pid: int, want, engine_nums: dict, card: str) -> dict:
    """(i): the thin client from a separate Python process, then the port's
    native C++ client against the same server."""
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mn_client_")
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump({"prompts": burst_prompts(cfg, 8, 64), "max_tokens": 32}, f)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                        f"sys.exit(chip_smoke.mn_client_main({server.address!r}, {spec!r}))"],
                       cwd=root, env=env, capture_output=True, text=True, timeout=900)
    client_s = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"multinode (i): the client process exited {p.returncode}: "
                             f"{p.stderr[-4000:]}")
    out = json.loads(p.stdout.strip().splitlines()[-1])
    counts = out["counts"]
    launches, by_route, steps = counts["launches"], counts["launches_by_route"], \
        counts["decode_steps"]
    if out["actor_pid"] != agent_pid or counts["pid"] != agent_pid:
        raise AssertionError(f"multinode (i): the actor ran in pid {out['actor_pid']}, (h)'s "
                             f"agent is {agent_pid}")
    if out["tokens"] != want:
        raise AssertionError("multinode (i): int8 tokens differ from the engine phase's")
    per_forward = k6_per_layer(cfg) * cfg.n_layers
    if steps < 31 or launches["paged_decode_attention"] != cfg.n_layers * steps \
            or launches["int8_matmul"] % per_forward \
            or launches["int8_matmul"] < per_forward * steps \
            or by_route["int8_matmul"] != {"mma_bf16": launches["int8_matmul"], "simt": 0}:
        raise AssertionError(f"multinode (i): {launches} {by_route} over {steps} decode steps, "
                             f"want K1 {cfg.n_layers} a step, K6 {per_forward} a forward on "
                             "the tensor cores")
    n_tok = sum(len(r) for r in out["tokens"])
    rep = {"part": "i_thin_client", "card": card, "client_pid": out["client_pid"],
           "client_imported_torch": out["torch_imported"], "server": server.address,
           "actor_pid": out["actor_pid"], "connect_s": out["connect_s"],
           "actor_build_s": out["actor_build_s"], "client_process_s": client_s,
           "requests": 8, "prompt_len": 64, "max_tokens": 32, "quantize": True,
           "tokens_equal_engine_phase": True, "decode_steps": steps, "launches": launches,
           "launches_by_route": by_route,
           "k1_per_decode_step": launches["paged_decode_attention"] / steps,
           "k6_forwards": launches["int8_matmul"] // per_forward,
           "tokens_per_s_client": n_tok / out["wall_s"],
           "tokens_per_s_engine_phase": engine_nums.get(True, {}).get("tokens_per_s"),
           "ttft_s_median": statistics.median(out["ttft"]), "ttft_s_max": max(out["ttft"]),
           "ttft_s_engine_phase": {k: v for k, v in engine_nums.get(True, {}).items()
                                   if k.startswith("ttft")}}
    from ray_tpu_torch.native import _build as native_build

    t0 = time.perf_counter()
    exe = native_build.program(os.path.join(root, "tests", "torch_cpp_client_main.cpp"),
                               "torch_cpp_client_main")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = subprocess.run([exe, server.host, str(server.port), "chip_smoke"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    if p.returncode != 0 or "CPP CLIENT OK" not in p.stdout:
        raise AssertionError(f"multinode (i): the native client exited {p.returncode}: "
                             f"{p.stdout!r} {p.stderr[-2000:]!r}")
    rep["native_client"] = {"build_s": build_s, "run_s": time.perf_counter() - t0,
                            "calls": [ln for ln in p.stdout.splitlines() if ln.endswith("ok")]}
    return rep



def mn_cli(card: str) -> dict:
    """(f): ``python -m ray_tpu_torch start --head`` and ``start --address
    <it> --num-gpus 1`` as processes; ``status`` shows two nodes and one
    GPU; ``stop`` ends the head and the agent leaves with it."""
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mn_cli_")
    env = dict(os.environ, TMPDIR=tmp)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["RAY_TPU_AGENT_RECONNECT_TIMEOUT_S"] = "0"  # the agent leaves with its head
    mod = [sys.executable, "-m", "ray_tpu_torch"]
    t0 = time.perf_counter()
    head = subprocess.Popen(mod + ["start", "--head", "--num-cpus", "1", "--num-gpus", "0",
                                   "--dashboard-port", "0"],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    agent = None
    try:
        lines = []
        for line in head.stdout:
            lines.append(line)
            if line.startswith("Join more nodes with:"):
                break
        if not lines or not lines[-1].startswith("Join more nodes with:"):
            raise AssertionError(f"multinode (f): the head printed {lines}")
        address = lines[-1].split("--address", 1)[1].strip()
        agent_log = os.path.join(tmp, "agent.log")
        with open(agent_log, "w") as log:
            agent = subprocess.Popen(mod + ["start", "--address", address, "--num-cpus", "1",
                                            "--num-gpus", "1"],
                                     cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=log)
        out = ""
        while time.perf_counter() - t0 < MULTINODE_JOIN_S:
            p = subprocess.run(mod + ["status"], cwd=root, env=env, capture_output=True,
                               text=True, timeout=60)
            out = p.stdout
            if "Nodes: 2" in out:
                break
            if agent.poll() is not None:
                raise AssertionError(f"multinode (f): the agent exited: {open(agent_log).read()}")
            time.sleep(0.2)
        up_s = time.perf_counter() - t0
        if "Nodes: 2" not in out or "/1 GPU used" not in out:
            raise AssertionError(f"multinode (f): status {out!r}")
        p = subprocess.run(mod + ["stop"], cwd=root, env=env, capture_output=True, text=True,
                           timeout=60)
        head_rc = head.wait(timeout=30)
        agent_rc = agent.wait(timeout=60)
        if p.returncode or head_rc or agent_rc:
            raise AssertionError(f"multinode (f): stop {p.returncode} {p.stdout!r}, head "
                                 f"{head_rc}, agent {agent_rc}")
    finally:
        for proc in (head, agent):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    return {"part": "f_cli", "card": card, "join_address": address,
            "status_lines": out.strip().splitlines(), "up_s": up_s,
            "stopped_s": time.perf_counter() - t0}


def run_multinode(torch, cfg, params, engine_tokens: dict, engine_nums: dict, dag_nums: dict,
                  card: str):
    """The multinode phase: a head in this process (``init(head_port=0)``)
    and a node agent process with the card; (a)-(e), (g) on (e)'s second
    agent, (h) and (i) under that head, (f) with the CLI's own processes.
    Yields one report per part; prints an agent's log if the phase fails."""
    import chip_smoke as smoke  # noqa: F401 — the actor and task classes by module name
    import ray_tpu_torch as rt

    t_phase = time.perf_counter()
    want = {}  # quantize -> this process's own burst: the engine phase's, or run now
    for q in (False, True):
        want[q] = engine_tokens.get(("paged", q)) or run_engine(
            torch, cfg, params, "paged", 8, 64, 32, {}, quantize=q)["request_tokens"]
    torch.cuda.empty_cache()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_mn_")
    logs = []
    agents = []
    free0 = torch.cuda.mem_get_info()[0]
    rt.init(num_cpus=2, num_gpus=0, head_port=0)
    try:
        cluster = rt.get_cluster()
        address = "127.0.0.1:" + cluster.head_service.address.rsplit(":", 1)[1]
        agent, log = mn_spawn_agent(address, log_dir, "a")
        agents.append(agent)
        logs.append(log)
        join_s = mn_wait_nodes(cluster, 2, [agent])
        resources = rt.cluster_resources()
        if resources.get("GPU") != 1:
            raise AssertionError(f"multinode: resources {resources}, want the agent's one GPU")
        yield {"part": "join", "card": card, "join_s": join_s, "agent_pid": agent.pid,
               "resources": resources}
        # int8 through an agent's GPU actor runs in (i), from the thin client
        yield mn_serve(torch, rt, cfg, False, want[False], engine_nums, card)
        yield mn_objects(torch, rt, cluster, card)
        yield mn_leased(rt, cluster, card)
        yield mn_collective(torch, rt, cluster, card)
        torch.cuda.empty_cache()
        yield mn_kill(torch, rt, cluster, agent, free0, card)
        agent, log = mn_spawn_agent(address, log_dir, "b")
        agents.append(agent)
        logs.append(log)
        rejoin_s = mn_wait_nodes(cluster, 2, [agent])
        rep = mn_serve(torch, rt, cfg, False, want[False], engine_nums, card)
        rep["part"] = "e_rejoin"
        rep["rejoin_s"] = rejoin_s
        yield rep
        torch.cuda.empty_cache()
        yield mn_plan(torch, rt, cluster, agent, free0, want[False], engine_nums, dag_nums, card)
        launcher, rep = mn_launcher_up(torch, rt, cluster, card)
        try:
            yield rep
            from ray_tpu_torch.util.client import ClientServer

            server = ClientServer(port=0).start()
            try:
                yield mn_client(torch, cfg, server, rep["agent_pid"], want[True], engine_nums,
                                card)
            finally:
                server.stop()
        except BaseException:
            launcher.down()
            raise
        yield mn_launcher_down(torch, rt, cluster, launcher, free0, card)
    except BaseException:
        for path in logs:
            with open(path) as f:
                print(f"--- {path}\n{f.read()[-20000:]}", file=sys.stderr)
        raise
    finally:
        rt.shutdown()
        for p in agents:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    torch.cuda.empty_cache()
    yield mn_cli(card)
    yield {"part": "total", "card": card, "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# rllib
# ---------------------------------------------------------------------------
RLLIB_SEED = 0
RLLIB_ENVS = 4096  # PPO's main path: 4096 envs x 128 steps, 524,288 env steps an iteration
RLLIB_ROLLOUT = 128
RLLIB_MINIBATCH = 8192  # 4 epochs of 64 minibatches: 256 learner updates an iteration
RLLIB_ITERS = 10
RLLIB_ENV_STEPS = 500
RLLIB_REMOTE_ITERS = 2
RLLIB_FWD = (1e-5, 1e-5)  # float32 forwards on the card against the CPU (atol, rtol)
RLLIB_GRAD_REL = 1e-4  # gradients and an Adam step, relative to their leaf's largest
RLLIB_TIE = 1e-5  # greedy actions whose two logits are this close are ties


def rllib_close(got, want, what: str) -> float:
    """The card's tensor against the CPU's within ``RLLIB_FWD``."""
    got, want = got.detach().float().cpu(), want.detach().float()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    atol, rtol = RLLIB_FWD
    if not bool(((got - want).abs() <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"rllib {what}: card against CPU max abs err {err}")
    return err


def rllib_tree_rel(got, want, what: str) -> float:
    """Leaf by leaf, the largest error over the leaf's largest magnitude."""
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    worst = 0.0
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        b = b.detach().float().cpu()
        rel = float((a.detach().float().cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if rel > RLLIB_GRAD_REL:
            raise AssertionError(f"rllib {what}[{i}]: relative error {rel}")
        worst = max(worst, rel)
    return worst


def rllib_env_parity(torch, rllib) -> dict:
    """(a) CartPole and Pendulum, 4096 envs for 500 steps: each step the card
    steps from the CPU env's state with the same actions; flags equal,
    observations, rewards and states within ``RLLIB_FWD``."""
    from ray_tpu_torch.rllib.env_runner import _tree_where

    out = {}
    for name, env in (("cartpole", rllib.CartPole()),
                      ("pendulum", rllib.Pendulum(max_episode_steps=50))):
        g = torch.Generator().manual_seed(RLLIB_SEED)
        state, _ = env.reset(g, RLLIB_ENVS, "cpu")
        err, ends, flags = 0.0, 0, 0
        for _ in range(RLLIB_ENV_STEPS):
            if env.discrete:
                action = torch.randint(0, 2, (RLLIB_ENVS,), generator=g)
            else:
                action = torch.rand((RLLIB_ENVS, 1), generator=g) * 5.0 - 2.5
            cpu = env.step(state, action)
            card = env.step({k: v.cuda() for k, v in state.items()}, action.cuda())
            for c, d in zip(cpu[1:3], card[1:3]):
                err = max(err, rllib_close(d, c, f"{name} step"))
            for k in cpu[0]:
                err = max(err, rllib_close(card[0][k], cpu[0][k].float(), f"{name} {k}"))
            for c, d in zip(cpu[3:], card[3:]):
                if not torch.equal(d.cpu(), c):
                    raise AssertionError(f"rllib {name}: the card's flags differ from the CPU's")
                flags += int(c.sum())
            done = cpu[3] | cpu[4]
            ends += int(done.sum())
            fresh, _ = env.reset(g, RLLIB_ENVS, "cpu")
            state = _tree_where(done, fresh, cpu[0])
        if ends < RLLIB_ENVS:
            raise AssertionError(f"rllib {name}: only {ends} episode ends in {RLLIB_ENV_STEPS} steps")
        out[name] = {"envs": RLLIB_ENVS, "steps": RLLIB_ENV_STEPS, "episode_ends": ends,
                     "max_abs_err": err, "flags_equal": True}
    return out


def rllib_ppo_parity(torch, rllib) -> dict:
    """(a) The PPO loss, its gradients and one Learner update on ``cuda:0``
    against the same on the CPU, at the main path's minibatch (8192 rows)
    and the module's widths."""
    import numpy as np

    from ray_tpu_torch.rllib import learner
    from ray_tpu_torch.rllib.algorithms.ppo import _ppo_loss
    from ray_tpu_torch.rllib.rl_module import tree_map

    module = rllib.ActorCriticModule(4, 2)
    params = module.init(torch.Generator().manual_seed(RLLIB_SEED))
    rng = np.random.default_rng(RLLIB_SEED)
    m = RLLIB_MINIBATCH
    batch = {"obs": rng.normal(size=(m, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, m).astype(np.int32),
             "logp": np.log(rng.uniform(0.3, 0.7, m)).astype(np.float32),
             "advantages": rng.normal(size=m).astype(np.float32),
             "returns": rng.uniform(0, 50, m).astype(np.float32)}
    loss = _ppo_loss(module, 0.2, 0.01, 0.5)
    out = {}
    grads = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev), params)
        tb = {k: learner.to_tensor(v, dev) for k, v in batch.items()}
        (value, stats), grads[dev] = learner.value_and_grad(loss, p, tb)
        out[dev] = {"loss": value, **stats}
    for k, v in out["cpu"].items():
        rllib_close(out["cuda"][k].reshape(1), v.reshape(1), f"ppo {k}")
    grad_rel = rllib_tree_rel(grads["cuda"], grads["cpu"], "ppo grads")
    learners = {}
    for dev in ("cpu", "cuda"):
        lrn = learner.Learner(module, loss, lr=3e-4, seed=RLLIB_SEED, device=dev)
        lrn.set_state({"params": params, "opt_state": lrn.opt_state})
        stats = lrn.update(rllib.SampleBatch(batch))
        learners[dev] = (lrn, stats)
    update_rel = rllib_tree_rel(learners["cuda"][0].params, learners["cpu"][0].params,
                                "ppo update params")
    mu_rel = rllib_tree_rel(learners["cuda"][0].opt_state[1]["mu"],
                            learners["cpu"][0].opt_state[1]["mu"], "ppo update mu")
    return {"rows": m, "loss": float(out["cpu"]["loss"]),
            "loss_card": float(out["cuda"]["loss"]), "grad_rel_err": grad_rel,
            "update_param_rel_err": update_rel, "update_mu_rel_err": mu_rel,
            "grad_norm": learners["cuda"][1]["grad_norm"]}


def rllib_timed(torch, fn, sink: list):
    """``fn`` with each call's seconds (synchronized) appended to ``sink``."""
    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    return call


def rllib_ppo_run(torch, rllib, iters: int, num_epochs: int = 4, **runners) -> tuple:
    """PPO on CartPole at the main path's size on the card: ``iters``
    iterations; -> (algo, numbers)."""
    cfg = (rllib.PPOConfig().environment(rllib.CartPole())
           .env_runners(rollout_length=RLLIB_ROLLOUT, **runners)
           .training(num_epochs=num_epochs, minibatch_size=RLLIB_MINIBATCH)
           .debugging(seed=RLLIB_SEED).resources(device="cuda"))
    algo = cfg.build()
    sample_s, update_s, iter_s, returns = [], [], [], []
    algo.runners.sample = rllib_timed(torch, algo.runners.sample, sample_s)
    algo.learners.update = rllib_timed(torch, algo.learners.update, update_s)
    for _ in range(iters):
        t0 = time.perf_counter()
        result = algo.train()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t0)
        returns.append(result["episode_return_mean"])
        for k, v in result["learners"].items():
            if not math.isfinite(v):
                raise AssertionError(f"rllib PPO: learner stat {k} = {v}")
    steps = RLLIB_ROLLOUT * cfg.num_envs_per_runner * max(1, cfg.num_env_runners)
    if result["num_env_steps_sampled_lifetime"] != iters * steps:
        raise AssertionError("rllib PPO: env steps miscounted")
    updates = len(update_s) // iters
    steady = slice(1, None) if iters > 1 else slice(None)
    return algo, {
        "env_steps_per_iter": steps, "updates_per_iter": updates,
        "env_steps_per_s_sampling": steps / statistics.median(sample_s[steady]),
        "sample_s_median": statistics.median(sample_s[steady]),
        "update_ms_median": 1e3 * statistics.median(update_s[updates:] or update_s),
        "iteration_s_median": statistics.median(iter_s[steady]),
        "first_iteration_s": iter_s[0],
        "learner_s_per_iter": sum(update_s[updates:] or update_s) / max(1, iters - 1),
        "episode_return_mean": returns,
    }


def rllib_greedy_equal(torch, ref, other, obs) -> dict:
    """Greedy actions of ``other`` against ``ref``'s on ``obs``: equal,
    but where ``ref``'s two logits lie within ``RLLIB_TIE`` (a tie that the
    summation order may break either way)."""
    want, got = ref.compute_actions(obs), other.compute_actions(obs)
    with torch.no_grad():
        logits = ref.module.logits(ref.learners.params,
                                   torch.as_tensor(obs, device=ref.device)).cpu()
    gap = (logits[:, 0] - logits[:, 1]).abs().numpy()
    bad = (got != want) & (gap > RLLIB_TIE)
    if bad.any():
        raise AssertionError(f"rllib checkpoint: {int(bad.sum())} greedy actions differ")
    return {"observations": len(obs), "equal": int((got == want).sum()),
            "ties": int(((got != want) & (gap <= RLLIB_TIE)).sum())}


def run_rllib(torch, card: str):
    """The ``rllib`` phase: (a) card against CPU, (b) PPO's main path, (c)
    remote runners against inline, (d) DQN and SAC at the JAX tests'
    configurations, (e) a checkpoint from the card revived on the card and on
    the CPU."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.algorithm import Algorithm

    t0 = time.perf_counter()
    envs = rllib_env_parity(torch, rllib)
    yield {"part": "a_card_against_cpu", "card": card, "envs": envs,
           "ppo": rllib_ppo_parity(torch, rllib), "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    algo, nums = rllib_ppo_run(torch, rllib, RLLIB_ITERS, num_envs_per_runner=RLLIB_ENVS)
    rets = nums["episode_return_mean"]
    first = next(r for r in rets if not math.isnan(r))
    want = max(60.0, 1.5 * first)
    if not rets[-1] > want:
        raise AssertionError(f"rllib PPO: return {rets[-1]} after {RLLIB_ITERS} iterations, "
                             f"not above {want}")
    yield {"part": "b_ppo_cartpole", "card": card, "envs": RLLIB_ENVS,
           "rollout_length": RLLIB_ROLLOUT, "minibatch": RLLIB_MINIBATCH,
           "iterations": RLLIB_ITERS, "return_floor": want, **nums,
           "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = algo.save(os.path.join(tmp, "ppo.pkl"))
        obs = np.random.default_rng(RLLIB_SEED).normal(scale=0.1, size=(1024, 4)).astype(
            np.float32)
        on_card = Algorithm.from_checkpoint(path)
        on_cpu = Algorithm.from_checkpoint(path, device="cpu")
    if on_card.device.type != "cuda" or on_cpu.device.type != "cpu":
        raise AssertionError("rllib checkpoint: revived on the wrong device")
    ckpt = {"revived_on_card": rllib_greedy_equal(torch, algo, on_card, obs),
            "revived_on_cpu": rllib_greedy_equal(torch, algo, on_cpu, obs)}
    algo.stop()
    del algo, on_card, on_cpu
    ckpt_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    rt.init(num_cpus=4)
    try:
        runs = {}
        for mode in ("inline", "remote"):
            a, nums = rllib_ppo_run(torch, rllib, RLLIB_REMOTE_ITERS, num_epochs=1,
                                    num_env_runners=2,
                                    num_envs_per_runner=RLLIB_ENVS // 2,
                                    remote=mode == "remote")
            if mode == "remote":
                gpus = rt.available_resources().get("GPU", 0)
                if gpus != torch.cuda.device_count() - 1:
                    raise AssertionError(f"rllib remote runners: {gpus} GPU left, not "
                                         "two half shares taken")
            a.stop()
            runs[mode] = {k: v for k, v in nums.items() if k != "episode_return_mean"}
    finally:
        rt.shutdown()
    yield {"part": "c_remote_runners", "card": card, "runners": 2,
           "envs_per_runner": RLLIB_ENVS // 2, "iterations": RLLIB_REMOTE_ITERS,
           "num_epochs": 1, **runs,
           "remote_over_inline_sampling": runs["remote"]["env_steps_per_s_sampling"]
           / runs["inline"]["env_steps_per_s_sampling"],
           "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    dqn = (rllib.DQNConfig().environment(rllib.CartPole())
           .env_runners(num_envs_per_runner=8, rollout_length=64)
           .training(learning_starts=500, num_updates_per_iter=32, epsilon_decay_steps=2500)
           .debugging(seed=0).resources(device="cuda").build())
    for _ in range(25):
        dqn_result = dqn.train()
    dqn.stop()
    if "td_error_mean" not in dqn_result["learners"] or not (
            dqn_result["episode_return_mean"] > 15.0):
        raise AssertionError(f"rllib DQN: return {dqn_result['episode_return_mean']}")
    dqn_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    sac = (rllib.SACConfig().environment(rllib.Pendulum())
           .env_runners(num_envs_per_runner=4, rollout_length=64)
           .training(learning_starts=200, num_updates_per_iter=4)
           .debugging(seed=0).resources(device="cuda").build())
    for _ in range(4):
        sac_result = sac.train()
    sac.stop()
    if not math.isfinite(sac_result["learners"].get("critic_loss", math.nan)):
        raise AssertionError(f"rllib SAC: {sac_result['learners']}")
    yield {"part": "d_dqn_sac", "card": card,
           "dqn": {"iterations": 25, "episode_return_mean": dqn_result["episode_return_mean"],
                   "learners": dqn_result["learners"], "seconds": dqn_s},
           "sac": {"iterations": 4, "learners": sac_result["learners"],
                   "seconds": time.perf_counter() - t1},
           "seconds": time.perf_counter() - t0}
    yield {"part": "e_checkpoint", "card": card, **ckpt, "seconds": ckpt_s}



# ---------------------------------------------------------------------------
# rllib_contrib: rllib part 2 (PG/A2C/A3C, SimpleQ/Ape-X, DDPG/TD3, ES/ARS,
# the bandits, CRR, R2D2, MADDPG, QMIX, DT, DreamerV3)
# ---------------------------------------------------------------------------
RC_SEED = 0
RC_ENVS = 4096  # (a): the multi-agent and bandit envs, stepped card against CPU
RC_ENV_STEPS = 200
RC_PULLS = 200  # (a): bandit pulls, card against CPU
RC_DREAMER_ITERS = 10  # (b)
RC_DT_ITERS = 5  # (c): the JAX test's first iteration and four more, 60 updates each
RC_ES_ITERS = 10  # (d)
RC_OTHER_ITERS = 2  # (d): every other algorithm


def rc_dreamer_config(rllib, device: str, **widths):
    """DreamerV3 at the JAX package's widths (deter 256, units 256, 16 x 16
    latents, 63 bins) and the published training batch (Hafner et al. 2023:
    16 sequences x 64 steps, imagination horizon 15): 16 CartPole envs, one
    replay chunk of 16 sequences an update, 4 updates an iteration."""
    from ray_tpu_torch.rllib.algorithms import DreamerV3Config

    cfg = DreamerV3Config().environment(rllib.CartPole()).debugging(seed=RC_SEED).resources(
        device=device)
    cfg.num_envs, cfg.seq_len, cfg.batch_size_seqs, cfg.horizon = 16, 64, 1, 15
    cfg.updates_per_iter = 4
    for k, v in widths.items():
        setattr(cfg, k, v)
    return cfg


def rc_dt_config(rllib, device: str, data):
    """DT at the published gym setting (Chen et al. 2021: 3 layers, 1 head,
    embedding 128, context 20, batch 64; no dropout: ``DTModule`` has none),
    lr 1e-3, 60 updates an iteration, target return 200 (the JAX test's)."""
    return (rllib.DTConfig().environment(rllib.CartPole())
            .training(context_length=20, d_model=128, n_layers=3, n_heads=1,
                      train_batch_size=64, updates_per_iter=60, target_return=200.0)
            .debugging(seed=RC_SEED).offline_data(data).resources(device=device))


def rc_cartpole_offline_data(torch, rllib, T: int = 200, n_good: int = 5, n_random: int = 5):
    """The JAX test's mixed-quality offline data (``tests/test_rllib_contrib.py:514``)
    from the port's CartPole on the CPU: time-major [T, B] columns of 5
    lean-following episodes' streams and 5 random ones."""
    import numpy as np

    from ray_tpu_torch.rllib.env_runner import _tree_where

    env, B = rllib.CartPole(), n_good + n_random
    g = torch.Generator().manual_seed(RC_SEED)
    rng = np.random.default_rng(RC_SEED)
    state, obs = env.reset(g, B, "cpu")
    cols = {k: [] for k in ("obs", "actions", "rewards", "dones", "truncateds")}
    for _ in range(T):
        o = obs.numpy()
        act = np.where(np.arange(B) < n_good, (o[:, 2] + 0.5 * o[:, 3] > 0).astype(np.int64),
                       rng.integers(0, 2, B))
        state, nxt, r, term, trunc = env.step(state, torch.as_tensor(act))
        for k, v in zip(cols, (o, act.astype(np.int32), r.numpy(), term.numpy(),
                               trunc.numpy())):
            cols[k].append(v)
        done = term | trunc
        fresh, fresh_obs = env.reset(g, B, "cpu")
        state = _tree_where(done, fresh, state)
        obs = torch.where(done[:, None], fresh_obs, nxt)
    return rllib.SampleBatch({k: np.stack(v) for k, v in cols.items()})


def rc_env_parity(torch, rllib) -> dict:
    """(a) SimpleSpread, DiscreteSpread (3 agents) and LinearBanditEnv at
    4096 envs for 200 steps: each step the card steps from the CPU env's
    state with the same actions; flags equal, observations, rewards and
    states within ``RLLIB_FWD``."""
    from ray_tpu_torch.rllib.env_runner import _tree_where

    out = {}
    for name, env in (("simple_spread", rllib.SimpleSpread(n_agents=3)),
                      ("discrete_spread", rllib.DiscreteSpread(n_agents=3)),
                      ("linear_bandit", rllib.LinearBanditEnv())):
        g = torch.Generator().manual_seed(RC_SEED)
        state, _ = env.reset(g, RC_ENVS, "cpu")
        err, ends = 0.0, 0
        for _ in range(RC_ENV_STEPS):
            if name == "simple_spread":
                action = torch.rand((RC_ENVS, 3, 2), generator=g) * 3.0 - 1.5
            else:
                n = 5 if name == "discrete_spread" else env.num_arms
                shape = (RC_ENVS, 3) if name == "discrete_spread" else (RC_ENVS,)
                action = torch.randint(0, n, shape, generator=g)
            cpu = env.step(state, action)
            card = env.step({k: v.cuda() for k, v in state.items()}, action.cuda())
            for c, d in zip(cpu[1:3], card[1:3]):
                err = max(err, rllib_close(d, c, f"{name} step"))
            for k in cpu[0]:
                if cpu[0][k].is_floating_point():
                    err = max(err, rllib_close(card[0][k], cpu[0][k], f"{name} {k}"))
                elif not torch.equal(card[0][k].cpu(), cpu[0][k]):
                    raise AssertionError(f"rllib_contrib {name}: the card's {k} differs")
            for c, d in zip(cpu[3:], card[3:]):
                if not torch.equal(d.cpu(), c):
                    raise AssertionError(f"rllib_contrib {name}: the card's flags differ")
            done = cpu[3] | cpu[4]
            ends += int(done.sum())
            if name == "linear_bandit":
                state = cpu[0]  # horizon 1: the step's state is the next pull's
            else:
                fresh, _ = env.reset(g, RC_ENVS, "cpu")
                state = _tree_where(done, fresh, cpu[0])
        out[name] = {"envs": RC_ENVS, "steps": RC_ENV_STEPS, "episode_ends": ends,
                     "max_abs_err": err, "flags_equal": True}
    return out


def rc_loss_pairs(torch, rllib) -> dict:
    """(a) PG, A2C, SimpleQ, Ape-X and R2D2: each loss and its gradients on
    the card against the CPU from the same params and batch."""
    import numpy as np

    from ray_tpu_torch.rllib import learner
    from ray_tpu_torch.rllib.algorithms import pg, r2d2, simple_q
    from ray_tpu_torch.rllib.rl_module import tree_map

    rng = np.random.default_rng(RC_SEED)
    m = 8192
    flat = {"obs": rng.normal(size=(m, 4)).astype(np.float32),
            "next_obs": rng.normal(size=(m, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, m).astype(np.int32),
            "rewards": rng.normal(size=m).astype(np.float32),
            "dones": rng.random(m) < 0.05,
            "advantages": rng.normal(size=m).astype(np.float32),
            "returns": rng.uniform(0, 50, m).astype(np.float32),
            "weights": rng.uniform(0.2, 1.0, m).astype(np.float32)}
    B, T = 64, 16
    seq = {"obs": rng.normal(size=(B, T, 4)).astype(np.float32),
           "next_obs": rng.normal(size=(B, T, 4)).astype(np.float32),
           "actions": rng.integers(0, 2, (B, T)).astype(np.int32),
           "rewards": rng.normal(size=(B, T)).astype(np.float32),
           "dones": rng.random((B, T)) < 0.05, "truncateds": rng.random((B, T)) < 0.05}
    ac, q, gru = (rllib.ActorCriticModule(4, 2), rllib.QModule(4, 2),
                  rllib.GRUQModule(4, 2, 64))
    cases = {"pg": (ac, pg._pg_loss(ac), flat, False),
             "a2c": (ac, pg._a2c_loss(ac, 0.01, 0.5), flat, False),
             "simple_q": (q, simple_q._simple_q_loss(q, 0.99), flat, True),
             "apex": (q, simple_q._apex_loss(q, 0.99), flat, True),
             "r2d2": (gru, r2d2._r2d2_loss(gru, 0.99, 4), seq, True)}
    out = {}
    for name, (module, loss, batch, target) in cases.items():
        params = module.init(torch.Generator().manual_seed(RC_SEED))
        tparams = tree_map(lambda x: 0.9 * x, params)
        got = {}
        for dev in ("cpu", "cuda"):
            aux = {"target_params": tree_map(lambda x: x.to(dev), tparams)} if target else {}
            (value, stats), grads = learner.value_and_grad(
                loss, tree_map(lambda x: x.to(dev), params),
                {k: learner.to_tensor(v, dev) for k, v in batch.items()}, **aux)
            got[dev] = (value, stats, grads)
        rllib_close(got["cuda"][0].reshape(1), got["cpu"][0].reshape(1), f"{name} loss")
        for k, v in got["cpu"][1].items():
            rllib_close(got["cuda"][1][k], v, f"{name} {k}")
        out[name] = {"loss": float(got["cpu"][0]),
                     "grad_rel_err": rllib_tree_rel(got["cuda"][2], got["cpu"][2],
                                                    f"{name} grads")}
    return out


def rc_same_state(algo_cpu, algo_card) -> None:
    """``algo_card`` takes ``algo_cpu``'s state (every tensor to the card)."""
    from ray_tpu_torch.rllib.learner import to_device

    algo_card.set_state(to_device(algo_cpu.get_state(), algo_card.device))


def rc_peaked_heads(torch, algo) -> None:
    """Give DreamerV3's reward head and critics a last-layer bias peaked at
    one bin. They start at zero (as the JAX package's), where
    ``twohot_mean`` is the rounding of the bins' sum (+-22025 cancelling)
    and the actor's advantages are that rounding, which differs between
    devices; peaked, the imagined rewards and values are O(1)."""
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import _linspace_bins

    lin = _linspace_bins().to(algo.device)
    for head, c in ((algo.state["wm"]["reward"], 1.0), (algo.state["critic"], 0.5),
                    (algo.state["critic_slow"], 0.6)):
        head[-1]["b"] = -2.0 * (lin - c) ** 2


def rc_update_pairs(torch, rllib) -> dict:
    """(a) DDPG, TD3, CRR, MADDPG, QMIX, DT, DreamerV3, ES and ARS: updates
    on the card against the same on the CPU, from one state and the same
    draws (drawn on the CPU): losses within ``RLLIB_FWD``, params within
    ``RLLIB_GRAD_REL`` of their leaf's largest."""
    import numpy as np

    from ray_tpu_torch.rllib import learner
    from ray_tpu_torch.rllib.algorithms import ddpg, es, maddpg, qmix
    from ray_tpu_torch.rllib.learner import to_device, to_tensor
    from ray_tpu_torch.rllib.rl_module import DDPGModule, tree_leaves

    rng = np.random.default_rng(RC_SEED + 1)
    g = torch.Generator().manual_seed(RC_SEED + 1)
    out = {}

    def stats_close(name, got, want):
        for k, v in want.items():
            rllib_close(torch.as_tensor(float(got[k])).reshape(1),
                        torch.as_tensor(float(v)).reshape(1), f"{name} {k}")

    # DDPG and TD3: two updates (TD3: the critic alone, then the policy step)
    cont = {"obs": 0.1 * rng.normal(size=(256, 3)).astype(np.float32),
            "next_obs": 0.1 * rng.normal(size=(256, 3)).astype(np.float32),
            "actions": rng.uniform(-1.9, 1.9, (256, 1)).astype(np.float32),
            "rewards": rng.normal(size=256).astype(np.float32),
            "dones": rng.random(256) < 0.1}
    for name, cfg in (("ddpg", rllib.DDPGConfig()), ("td3", rllib.TD3Config())):
        mod = DDPGModule(3, 1, -2.0, 2.0)
        pair = {dev: ddpg._DDPGLearner(mod, cfg, dev) for dev in ("cpu", "cuda")}
        pair["cuda"].set_state(pair["cpu"].get_state())
        for step in range(2):
            noise = torch.randn((256, 1), generator=g)
            want = pair["cpu"].update(rllib.SampleBatch(cont), noise)
            got = pair["cuda"].update(rllib.SampleBatch(cont), noise.cuda())
            stats_close(name, got, want)
        out[name] = {"param_rel_err": rllib_tree_rel(pair["cuda"].params, pair["cpu"].params,
                                                     f"{name} params"), **want}
    # CRR: a critic warm-up update, then one with the actor step
    crr = {dev: (rllib.CRRConfig().environment(rllib.Pendulum()).offline_data(
        rllib.SampleBatch(cont)).debugging(seed=RC_SEED).resources(device=dev).build())
        for dev in ("cpu", "cuda")}
    rc_same_state(crr["cpu"], crr["cuda"])
    for do_actor in (False, True):
        noise = {"next": torch.randn((256, 1), generator=g),
                 "adv": torch.randn((4, 256, 1), generator=g)}
        want = crr["cpu"]._update({k: to_tensor(v, "cpu") for k, v in cont.items()}, noise,
                                  do_actor)
        got = crr["cuda"]._update({k: to_tensor(v, "cuda") for k, v in cont.items()},
                                  to_device(noise, "cuda"), do_actor)
        stats_close("crr", got, want)
    out["crr"] = {"param_rel_err": rllib_tree_rel(crr["cuda"].params, crr["cpu"].params,
                                                  "crr params"), **learner.floats(want)}
    # MADDPG and QMIX: three agents, one update
    for name, env, update in (("maddpg", rllib.SimpleSpread(n_agents=3), maddpg._maddpg_update),
                              ("qmix", rllib.DiscreteSpread(n_agents=3), qmix._qmix_update)):
        cfg_of = rllib.MADDPGConfig if name == "maddpg" else rllib.QMIXConfig
        algos = {dev: cfg_of().environment(env).debugging(seed=RC_SEED).resources(
            device=dev).build() for dev in ("cpu", "cuda")}
        N, O = 3, env.observation_size
        batch = {"obs": rng.normal(size=(512, N, O)).astype(np.float32),
                 "next_obs": rng.normal(size=(512, N, O)).astype(np.float32)}
        if name == "maddpg":
            batch.update(actions=rng.uniform(-1, 1, (512, N, 2)).astype(np.float32),
                         rewards=np.repeat(rng.normal(size=(512, 1)), N, 1).astype(np.float32),
                         dones=np.zeros((512, N), bool))
        else:
            batch.update(actions=rng.integers(0, 5, (512, N)).astype(np.int32),
                         rewards=rng.normal(size=512).astype(np.float32),
                         dones=rng.random(512) < 0.05,
                         global_state=rng.normal(size=(512, 18)).astype(np.float32),
                         next_global_state=rng.normal(size=(512, 18)).astype(np.float32))
        res = {}
        for dev, a in algos.items():
            tx = (a.actor_tx, a.critic_tx) if name == "maddpg" else a.tx
            res[dev] = update(a.config, a.nets, tx, to_device(algos["cpu"]._state(), dev),
                              {k: to_tensor(v, dev) for k, v in batch.items()})
        stats_close(name, learner.floats(res["cuda"][1]), learner.floats(res["cpu"][1]))
        out[name] = {"param_rel_err": rllib_tree_rel(res["cuda"][0]["params"],
                                                     res["cpu"][0]["params"], f"{name} params"),
                     **learner.floats(res["cpu"][1])}
    # DT: one AdamW step at the (c) widths, from a state three steps in (a
    # first Adam step is g / (|g| + eps): where a gradient is near 0, its
    # rounding moves the step by up to lr, so the state has seen gradients)
    data = rc_cartpole_offline_data(torch, rllib)
    dts = {dev: rc_dt_config(rllib, dev, data).build() for dev in ("cpu", "cuda")}
    n_windows = len(dts["cpu"]._window_index)
    for _ in range(3):
        dts["cpu"]._update(*(to_tensor(w, "cpu") for w in dts["cpu"]._gather_windows(
            rng.integers(0, n_windows, 64))))
    rc_same_state(dts["cpu"], dts["cuda"])
    windows = dts["cpu"]._gather_windows(rng.integers(0, n_windows, 64))
    losses = {dev: a._update(*(to_tensor(w, dev) for w in windows)) for dev, a in dts.items()}
    rllib_close(losses["cuda"].reshape(1), losses["cpu"].reshape(1), "dt loss")
    out["dt"] = {"loss": float(losses["cpu"]),
                 "param_rel_err": rllib_tree_rel(dts["cuda"].params, dts["cpu"].params,
                                                 "dt params")}
    # DreamerV3: one update at half the (b) widths, from one replay chunk
    small = dict(deter_size=128, units=128, latent_cats=8, latent_classes=8, seq_len=32,
                 num_envs=8, updates_per_iter=1)
    drs = {dev: rc_dreamer_config(rllib, dev, **small).build() for dev in ("cpu", "cuda")}
    for _ in range(3):  # replay chunks, and a state three updates in (as DT's)
        drs["cpu"].train()
    rc_peaked_heads(torch, drs["cpu"])
    rc_same_state(drs["cpu"], drs["cuda"])
    batch = drs["cpu"]._replay[0]
    noise = drs["cpu"].draw_noise(32, 8)
    res = {dev: a._update(a.state, a._tensors(batch), to_device(noise, dev))
           for dev, a in drs.items()}
    stats_close("dreamerv3", learner.floats(res["cuda"][1]), learner.floats(res["cpu"][1]))
    out["dreamerv3"] = {
        "param_rel_err": max(rllib_tree_rel(res["cuda"][0][p], res["cpu"][0][p],
                                            f"dreamerv3 {p}")
                             for p in ("wm", "actor", "critic", "critic_slow")),
        **learner.floats(res["cpu"][1])}
    # ES and ARS: an update from the same perturbations and (tied) returns
    for name, cfg in (("es", rllib.ESConfig().training(population_size=64, hidden=(16,))),
                      ("ars", rllib.ARSConfig().training(population_size=32))):
        cfg = cfg.environment(rllib.CartPole()).debugging(seed=RC_SEED)
        a = cfg.copy().resources(device="cpu").build()
        half = cfg.population_size // 2
        eps = [torch.randn((half,) + tuple(x.shape), generator=g) for x in tree_leaves(a.theta)]
        returns = torch.randint(8, 40, (cfg.population_size,), generator=g).float()
        res = {}
        for dev in ("cpu", "cuda"):
            theta, e = to_device(a.theta, dev), [x.to(dev) for x in eps]
            if name == "es":
                res[dev] = es._es_update(cfg, a.tx, theta, to_device(a.opt_state, dev), e,
                                         returns.to(dev))[0]
            else:
                res[dev] = es._ars_update(cfg, theta, e, returns.to(dev))
        if not torch.equal(es._stable_argsort(returns.cuda()).cpu(), es._stable_argsort(returns)):
            raise AssertionError(f"rllib_contrib {name}: the card's ranks differ")
        rllib_close(es._centered_ranks(returns.cuda()), es._centered_ranks(returns),
                    f"{name} shaped ranks")
        out[name] = {"theta_rel_err": rllib_tree_rel(res["cuda"], res["cpu"], f"{name} theta"),
                     "distinct_returns": len(set(returns.tolist()))}
    return out


def rc_bandit_pulls(torch, rllib) -> dict:
    """(a) LinUCB and LinTS: 200 pulls on the card and on the CPU from the
    same contexts, rewards and posterior noise: arms equal, the statistics
    within ``RLLIB_GRAD_REL`` of their largest."""
    from ray_tpu_torch.rllib.algorithms import bandit

    out = {}
    for name in ("LinUCB", "LinTS"):
        env = rllib.LinearBanditEnv(num_arms=4, context_dim=6, noise=0.05, env_seed=3)
        cfg = getattr(rllib, name + "Config")().environment(env)
        g = torch.Generator().manual_seed(RC_SEED)
        st = {dev: (cfg.copy().resources(device=dev).build()) for dev in ("cpu", "cuda")}
        stats = {dev: (a.A, a.b) for dev, a in st.items()}
        state, ctx = env.reset(g, RC_PULLS, "cpu")
        noise = torch.randn((RC_PULLS, 4), generator=g)
        arms = []
        for i in range(RC_PULLS):
            arm = {}
            for dev in ("cpu", "cuda"):
                A, b = stats[dev]
                arm[dev] = bandit._select(cfg, A, b, ctx[i].to(dev), noise[i].to(dev))
            if int(arm["cuda"]) != int(arm["cpu"]):
                raise AssertionError(f"rllib_contrib {name}: pull {i} arms differ")
            reward = env.step({"ctx": ctx[i:i + 1], "key": state["key"][i:i + 1]},
                              arm["cpu"][None])[2][0]
            for dev in ("cpu", "cuda"):
                A, b = stats[dev]
                stats[dev] = bandit._update(A, b, arm[dev], ctx[i].to(dev), reward.to(dev))
            arms.append(int(arm["cpu"]))
        out[name] = {"pulls": RC_PULLS, "arms_equal": True, "arms_used": len(set(arms)),
                     "A_rel_err": rllib_tree_rel([stats["cuda"][0]], [stats["cpu"][0]],
                                                 f"{name} A"),
                     "b_rel_err": rllib_tree_rel([stats["cuda"][1]], [stats["cpu"][1]],
                                                 f"{name} b")}
    return out


def rc_device_launches(torch, fn) -> dict:
    """The device launches of one ``fn()`` (kernels, copies and sets in a
    ``torch.profiler`` trace of the CUDA activity) and the host's
    kernel-launch calls, counted on the trace's raw events (building the
    profiler's event tree for ~10^4 events takes seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    device = sum(1 for e in events if e.device_type() == DeviceType.CUDA)
    calls = sum(1 for e in events if e.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                                  "cuLaunchKernel", "cuLaunchKernelEx"))
    return {"device_events": device or None, "host_launch_calls": calls or None}


def rc_dreamer_greedy(torch, algo, obs):
    """Greedy actions of a DreamerV3 policy from a fresh recurrent state:
    the posterior's mode as the latent, the actor's argmax; -> (actions,
    the smallest top-two gap of the latents' and the actor's logits)."""
    import torch.nn.functional as F

    from ray_tpu_torch.rllib.algorithms import dreamerv3 as dv3

    cfg, wm = algo.config, algo.state["wm"]
    with torch.no_grad():
        x = torch.as_tensor(obs, device=algo.device)
        h = torch.zeros((x.shape[0], cfg.deter_size), device=algo.device)
        post = dv3._mlp(wm["post"], torch.cat([h, dv3._mlp(wm["encoder"], dv3.symlog(x))], -1))
        probs = algo._logits_to_probs(post)
        z = F.one_hot(probs.argmax(-1), cfg.latent_classes).float().reshape(x.shape[0], -1)
        logits = dv3._mlp(algo.state["actor"], torch.cat([h, z], -1))
        top2 = torch.cat([probs.log().topk(2, -1).values.reshape(x.shape[0], -1, 2),
                          logits.topk(2, -1).values[:, None]], 1)
        gap = (top2[..., 0] - top2[..., 1]).amin(-1)
    return logits.argmax(-1).cpu().numpy(), gap.cpu().numpy()


def rc_dt_greedy(torch, algo, obs):
    """Greedy first actions of a DT policy at its target return; -> (actions,
    the top-two gap of the logits)."""
    cfg = algo.config
    with torch.no_grad():
        n, K = obs.shape[0], cfg.context_length
        rtg = torch.zeros((n, K), device=algo.device)
        rtg[:, 0] = cfg.target_return
        o = torch.zeros((n, K, obs.shape[1]), device=algo.device)
        o[:, 0] = torch.as_tensor(obs, device=algo.device)
        act = torch.full((n, K), algo.module.num_actions, device=algo.device, dtype=torch.long)
        logits = algo.module.action_logits(algo.params, rtg, o, act)[:, 0]
        top2 = logits.topk(2, -1).values
    return logits.argmax(-1).cpu().numpy(), (top2[:, 0] - top2[:, 1]).cpu().numpy()


def rc_greedy_equal(torch, greedy, ref, other, obs) -> dict:
    want, gap = greedy(torch, ref, obs)
    got, _ = greedy(torch, other, obs)
    bad = (got != want) & (gap > RLLIB_TIE)
    if bad.any():
        raise AssertionError(f"rllib_contrib checkpoint: {int(bad.sum())} greedy actions differ")
    return {"observations": len(obs), "equal": int((got == want).sum()),
            "ties": int(((got != want) & (gap <= RLLIB_TIE)).sum())}


def rc_finite(name: str, stats: dict) -> dict:
    bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
    if bad or not stats:
        raise AssertionError(f"rllib_contrib {name}: learner statistics {stats}")
    return stats


def rc_others(torch, rllib) -> dict:
    """(d) every other part-2 algorithm, 2 iterations at its JAX test's
    configuration (``tests/test_rllib_contrib.py``): finite statistics."""
    import numpy as np

    cp, pend = rllib.CartPole(), rllib.Pendulum()
    rng = np.random.default_rng(RC_SEED)
    n = 4000
    acts = rng.uniform(-0.95, 0.95, (n, 1)).astype(np.float32)
    obs = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    crr_data = rllib.SampleBatch({"obs": obs, "actions": acts,
                                  "rewards": (-(acts[:, 0] - 0.5) ** 2).astype(np.float32),
                                  "dones": np.ones(n, bool), "next_obs": obs})
    configs = {
        "PG": rllib.PGConfig().environment(cp).env_runners(num_envs_per_runner=16,
                                                            rollout_length=128),
        "A2C": rllib.A2CConfig().environment(cp).env_runners(
            num_envs_per_runner=16, rollout_length=128).training(lr=2e-3, gae_lambda=0.95),
        "A3C": rllib.A3CConfig().environment(cp).env_runners(
            num_env_runners=2, num_envs_per_runner=4, rollout_length=32),
        "DDPG": rllib.DDPGConfig().environment(pend).env_runners(
            num_envs_per_runner=4, rollout_length=64).training(learning_starts=200,
                                                               num_updates_per_iter=4),
        "TD3": rllib.TD3Config().environment(pend).env_runners(
            num_envs_per_runner=2, rollout_length=32).training(learning_starts=50,
                                                               num_updates_per_iter=2),
        "SimpleQ": rllib.SimpleQConfig().environment(cp).env_runners(
            num_envs_per_runner=8, rollout_length=64).training(
            learning_starts=100, num_updates_per_iter=8, target_update_freq=8),
        "APEX": rllib.ApexDQNConfig().environment(cp).env_runners(
            num_env_runners=4, num_envs_per_runner=4, rollout_length=32).training(
            learning_starts=200, num_updates_per_iter=4),
        "ARS": rllib.ARSConfig().environment(cp).training(
            population_size=32, noise_std=0.1, lr=0.1, top_directions=8, eval_length=200),
        "BanditLinUCB": rllib.LinUCBConfig().environment(rllib.LinearBanditEnv(
            num_arms=4, context_dim=6, noise=0.05, env_seed=3)).training(steps_per_iter=64),
        "BanditLinTS": rllib.LinTSConfig().environment(rllib.LinearBanditEnv(
            num_arms=3, context_dim=4, env_seed=1)).training(steps_per_iter=32),
        "R2D2": rllib.R2D2Config().environment(rllib.CartPole(max_episode_steps=50)).env_runners(
            num_envs_per_runner=4, rollout_length=40).training(
            sequence_length=20, burn_in=4, learning_starts=8, num_updates_per_iter=2,
            train_batch_size=8, hidden_size=32),
        "MADDPG": rllib.MADDPGConfig().environment(rllib.SimpleSpread(n_agents=2)).training(
            learning_starts=200, num_updates_per_iter=8, train_batch_size=128,
            exploration_noise=0.3, hidden=(64, 64)),
        "QMIX": rllib.QMIXConfig().environment(rllib.DiscreteSpread(n_agents=2)).training(
            learning_starts=200, num_updates_per_iter=8, train_batch_size=128,
            hidden=(64, 64)),
        "CRR": rllib.CRRConfig().environment(pend).offline_data(crr_data).training(
            updates_per_iter=100, train_batch_size=256, hidden=(64, 64),
            critic_warmup_updates=400),
    }
    out = {}
    for name, cfg in configs.items():
        t0 = time.perf_counter()
        algo = cfg.debugging(seed=RC_SEED).resources(device="cuda").build()
        for _ in range(RC_OTHER_ITERS):
            result = algo.train()
        torch.cuda.synchronize()
        algo.stop()
        out[name] = {"learners": rc_finite(name, result["learners"]),
                     "episode_return_mean": result["episode_return_mean"],
                     "seconds": time.perf_counter() - t0}
    return out


def run_rllib_contrib(torch, card: str):
    """The ``rllib_contrib`` phase: (a) card against CPU, (b) DreamerV3 at
    its widths and the published batch, (c) DT at the published gym
    setting, (d) ES to its JAX test's criterion and every other part-2
    algorithm for 2 iterations, (e) (b)'s and (c)'s algorithms saved on
    the card and revived on the CPU."""
    import numpy as np

    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.algorithm import Algorithm
    from ray_tpu_torch.rllib.learner import value_and_grad

    t0 = time.perf_counter()
    yield {"part": "a_card_against_cpu", "card": card, "envs": rc_env_parity(torch, rllib),
           "losses": rc_loss_pairs(torch, rllib), "updates": rc_update_pairs(torch, rllib),
           "bandits": rc_bandit_pulls(torch, rllib), "seconds": time.perf_counter() - t0}
    torch.cuda.empty_cache()

    # (b) DreamerV3
    t0 = time.perf_counter()
    dream = rc_dreamer_config(rllib, "cuda").build()
    update_s, collect_s = [], []
    dream._update = rllib_timed(torch, dream._update, update_s)
    dream._collect = rllib_timed(torch, dream._collect, collect_s)
    first = dream.train()["learners"]
    probe = dream._replay[0]
    T, B = probe["action"].shape
    gz = dream.draw_noise(T, B, torch.Generator(device="cuda").manual_seed(RC_SEED + 123))["obs_z"]
    before = float(dream._observe_loss(dream.state["wm"], gz, probe))
    for _ in range(RC_DREAMER_ITERS - 1):
        last = dream.train()["learners"]
    after = float(dream._observe_loss(dream.state["wm"], gz, probe))
    rc_finite("dreamerv3", last)
    if not after < before:
        raise AssertionError(f"rllib_contrib dreamerv3: probe loss {before} -> {after}")
    batch = dream._tensors(probe)
    launches = rc_device_launches(torch, lambda: dream._update(
        dream.state, batch, dream.draw_noise(T, B)))
    # where an update's time goes: the world model's step (the posterior
    # pass over 64 steps, its heads, their backward) against the whole
    wm_s = []
    wm_step = rllib_timed(torch, lambda: value_and_grad(
        lambda wm: dream._observe(wm, batch, dream.draw_noise(T, B)["obs_z"]), dream.state["wm"]),
        wm_s)
    for _ in range(3):
        wm_step()
    collect_launches = rc_device_launches(torch, dream._collect)
    steps = dream.config.seq_len * dream.config.num_envs
    yield {"part": "b_dreamerv3", "card": card, "iterations": RC_DREAMER_ITERS,
           "widths": {k: getattr(dream.config, k) for k in (
               "deter_size", "units", "latent_cats", "latent_classes")},
           "batch": [T, B], "horizon": dream.config.horizon,
           "updates_per_iter": dream.config.updates_per_iter,
           "probe_world_model_loss": [before, after], "first": first, "last": last,
           "update_ms_median": 1e3 * statistics.median(update_s[4:]),
           "first_update_ms": 1e3 * update_s[0], "launches_per_update": launches,
           "world_model_grad_ms_median": 1e3 * statistics.median(wm_s),
           "world_model_grad_launches": rc_device_launches(torch, wm_step),
           "env_steps_per_s_collecting": steps / statistics.median(collect_s[1:-1]),
           "launches_per_collect": collect_launches, "env_steps_per_collect": steps,
           "seconds": time.perf_counter() - t0}
    torch.cuda.empty_cache()

    # (c) DT
    t0 = time.perf_counter()
    dt_cfg = rc_dt_config(rllib, "cuda", rc_cartpole_offline_data(torch, rllib))
    dt = dt_cfg.build()
    dt_update_s = []
    dt._update = rllib_timed(torch, dt._update, dt_update_s)
    losses = [dt.train()["learners"]["bc_loss"] for _ in range(RC_DT_ITERS)]
    t_eval = time.perf_counter()
    ev = dt.evaluate(num_episodes=5)["evaluation"]
    eval_s = time.perf_counter() - t_eval
    if not (losses[-1] < losses[0] and ev["episode_return_mean"] > 60.0):
        raise AssertionError(f"rllib_contrib dt: bc_loss {losses}, evaluation {ev}")
    yield {"part": "c_dt", "card": card, "iterations": RC_DT_ITERS,
           "updates": len(dt_update_s), "bc_loss": losses, "evaluation": ev,
           "evaluation_s": eval_s,
           "update_ms_median": 1e3 * statistics.median(dt_update_s[10:]),
           "launches_per_update": rc_device_launches(torch, lambda: dt._update(
               *rc_dt_windows(dt))),
           "seconds": time.perf_counter() - t0}

    # (d) ES to its JAX test's criterion, the others for 2 iterations
    t0 = time.perf_counter()
    es = (rllib.ESConfig().environment(rllib.CartPole())
          .training(population_size=64, noise_std=0.1, lr=0.05, eval_length=200, hidden=(16,))
          .debugging(seed=RC_SEED).resources(device="cuda").build())
    es_iter_s, fitness = [], []
    for _ in range(RC_ES_ITERS):
        t1 = time.perf_counter()
        fitness.append(es.train()["learners"]["fitness_mean"])
        es_iter_s.append(time.perf_counter() - t1)
    want = max(fitness[0] * 1.5, 40.0)
    if not fitness[-1] > want:
        raise AssertionError(f"rllib_contrib es: fitness {fitness}, not above {want} at the end")
    yield {"part": "d_es_and_others", "card": card,
           "es": {"iterations": RC_ES_ITERS, "fitness_mean": fitness, "criterion": want,
                  "iteration_s_median": statistics.median(es_iter_s[1:]),
                  "first_iteration_s": es_iter_s[0]},
           "others": rc_others(torch, rllib), "seconds": time.perf_counter() - t0}

    # (e) checkpoints from the card revived on the CPU
    t0 = time.perf_counter()
    obs = np.random.default_rng(RC_SEED).normal(scale=0.1, size=(1024, 4)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        d_cpu = Algorithm.from_checkpoint(dream.save(os.path.join(tmp, "dreamer.pkl")),
                                          device="cpu")
        t_cpu = Algorithm.from_checkpoint(dt.save(os.path.join(tmp, "dt.pkl")), config=dt_cfg,
                                          device="cpu")
    if d_cpu.device.type != "cpu" or t_cpu.device.type != "cpu":
        raise AssertionError("rllib_contrib checkpoint: revived on the wrong device")
    yield {"part": "e_checkpoint", "card": card,
           "dreamerv3": rc_greedy_equal(torch, rc_dreamer_greedy, dream, d_cpu, obs),
           "dt": rc_greedy_equal(torch, rc_dt_greedy, dt, t_cpu, obs),
           "seconds": time.perf_counter() - t0}


def rc_dt_windows(dt):
    """One minibatch of DT windows on its device."""
    import numpy as np

    from ray_tpu_torch.rllib.learner import to_tensor

    idx = np.random.default_rng(RC_SEED).integers(0, len(dt._window_index),
                                                  dt.config.train_batch_size)
    return [to_tensor(w, dt.device) for w in dt._gather_windows(idx)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES + OPTIONAL_PHASES)}")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if phases - set(PHASES + OPTIONAL_PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES + OPTIONAL_PHASES))}")

    # cuBLAS reads this when CUDA starts; deterministic algorithms (the
    # resume check of the train phase) need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ray_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the ray_tpu_torch package is missing ({exc})", file=sys.stderr)
        return 1
    from ray_tpu_torch.ops.attention import (
        flash_attention_backward_dkv,
        flash_attention_backward_dq,
        flash_attention_with_lse,
    )
    from ray_tpu_torch.ops.decode_attention import decode_attention, paged_decode_attention
    from ray_tpu_torch.ops.quantization import int8_matmul

    kernels_of = {"paged_decode_attention": paged_decode_attention,
                  "decode_attention": decode_attention,
                  "flash_attention_forward": flash_attention_with_lse,
                  "flash_attention_backward_dq": flash_attention_backward_dq,
                  "flash_attention_backward_dkv": flash_attention_backward_dkv,
                  "int8_matmul": int8_matmul}
    attention_kernels = {n: kernels_of[n] for n in ("flash_attention_forward",
                                                      "flash_attention_backward_dq",
                                                      "flash_attention_backward_dkv")}
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_report(_build.build_logs())
    hgmma = hgmma_counts(libs)
    check_tensor_core_build(ptxas, hgmma)
    emit({"phase": "build", "ok": True, "seconds": build_s, "card": card, "ptxas": ptxas,
          "hgmma_per_kernel": hgmma})

    kernels = {}
    if "kernels" in phases:
        g = torch.Generator(device="cuda").manual_seed(0)
        for check in KERNEL_CHECKS:
            for r in check(torch, g):
                r["bound_ms"], r["bound_by"] = r.pop("bound")
                kernels[r["name"]] = r
                emit({"phase": "kernel", "ok": True, "card": card, **r})
            torch.cuda.empty_cache()

    if "rllib" in phases:
        # first after the kernels: it needs no other phase, and runs in a
        # process that no runtime phase has loaded with threads yet
        t0 = time.perf_counter()
        for rep in run_rllib(torch, card):
            emit({"phase": "rllib", "ok": True, **rep})
        emit({"phase": "rllib", "ok": True, "card": card, "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    if "rllib_contrib" in phases:
        t0 = time.perf_counter()
        for rep in run_rllib_contrib(torch, card):
            emit({"phase": "rllib_contrib", "ok": True, **rep})
        emit({"phase": "rllib_contrib", "ok": True, "card": card,
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()

    train_step_ms = None  # the train phase's median step, beside the trainer phase's
    launches = {}  # kernel -> launches over the main-path runs
    by_path = {}  # kernel -> {phase: launches}
    by_route = {}  # K3, K4, K5, K6 -> {route: launches} over the same runs

    def count(path: str, n: dict, routes: dict) -> None:
        for name, x in n.items():
            launches[name] = launches.get(name, 0) + x
            by_path.setdefault(name, {}).setdefault(path, 0)
            by_path[name][path] += x
        for name, per in routes.items():
            for r, x in per.items():
                by_route.setdefault(name, {}).setdefault(r, 0)
                by_route[name][r] += x
    if phases & {"forward_parity", "engine", "server", "disagg", "runtime", "serve", "chaos",
                  "data", "dag", "jobs", "cli", "multinode"}:
        cfg = serving_config(torch)
        from ray_tpu_torch.models.transformer import init_params

        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in [params["embed"], params["final_norm"],
                                           *params["layers"].values()])
        init_s = time.perf_counter() - t0
        if "forward_parity" in phases:
            rep = forward_parity(torch, dataclasses.replace(cfg, dtype=torch.float32), params)
            emit({"phase": "forward_parity", "ok": True, "params": n_params,
                  "init_s": init_s, **rep})
        engine_tokens = {}  # (cache kind, quantize) -> the burst's tokens
        engine_nums = {}  # quantize -> the paged engine's tokens/s and TTFT
        dag_nums = {}  # the dag phase's in-process float plan: its depth, tokens/s
        if "engine" in phases:
            for run in run_engines(torch, cfg, params, kernels_of):
                engine_tokens[(run["cache_kind"], run["quantize"])] = run.pop("request_tokens")
                if run["cache_kind"] == "paged":
                    engine_nums[run["quantize"]] = {k: run[k] for k in (
                        "tokens_per_s", "ttft_s_median", "ttft_s_max")}
                emit({"phase": "engine", "ok": True, "card": card, "params": n_params, **run})
                count("engine", run["launches"], run["launches_by_route"])
        colocated = {}  # quantize -> the paged server's burst numbers
        if "server" in phases:
            if ("paged", False) not in engine_tokens:  # the reference the server is held to
                engine_tokens[("paged", False)] = run_engine(
                    torch, cfg, params, "paged", 8, 64, 32, {})["request_tokens"]
            for run in run_servers(torch, cfg, params, kernels_of, engine_tokens):
                emit({"phase": "server", "ok": True, "card": card, **run})
                if "launches" in run:
                    count("server", run["launches"], run["launches_by_route"])
                if run.get("cache_kind") == "paged":
                    colocated[run["quantize"]] = {k: run[k] for k in (
                        "tokens_per_s", "ttft_s_median", "ttft_s_max")}
            torch.cuda.empty_cache()
        if "disagg" in phases:
            for rep in run_disagg(torch, cfg, params, kernels_of, colocated):
                emit({"phase": "disagg", "ok": True, "card": card, **rep})
                count("disagg", rep["launches"], rep.get("launches_by_route", {}))
        actor_tps = {}  # quantize -> the runtime phase's GPU-actor tokens/s
        if "runtime" in phases:
            torch.cuda.empty_cache()
            for rep in run_runtime(torch, cfg, params, kernels_of, card):
                emit({"phase": "runtime", "ok": True, **rep})
                if "launches" in rep:
                    count("runtime", rep["launches"], rep["launches_by_route"])
                if rep.get("part") == "gpu_actor":
                    actor_tps[rep["quantize"]] = rep["tokens_per_s_actor"]
        if "serve" in phases:
            torch.cuda.empty_cache()
            for rep in run_serve(torch, cfg, params, kernels_of, card, actor_tps, engine_nums):
                emit({"phase": "serve", "ok": True, **rep})
                if "launches" in rep:
                    count("serve", rep["launches"], rep.get("launches_by_route", {}))
        if "chaos" in phases:
            torch.cuda.empty_cache()
            rep = run_chaos(torch, cfg, params, kernels_of, card)
            emit({"phase": "chaos", "ok": True, **rep})
            count("chaos", rep["launches"], rep["launches_by_route"])
        if "data" in phases:
            torch.cuda.empty_cache()
            for rep in run_data_inference(torch, cfg, params, kernels_of, card):
                emit({"phase": "data", "ok": True, **rep})
                if "launches" in rep:
                    count("data", rep["launches"], rep["launches_by_route"])
        if "dag" in phases:
            torch.cuda.empty_cache()
            t_dag = time.perf_counter()
            for rep in run_dag_serving(torch, cfg, kernels_of, card):
                emit({"phase": "dag", "ok": True, **rep})
                if "launches" in rep:
                    count("dag", rep["launches"], rep["launches_by_route"])
                if rep.get("part") == "a_serving_plan" and not rep["quantize"]:
                    dag_nums = {"layers": rep["layers"], "tokens_per_s": rep["tokens_per_s"],
                                "ms_per_request": rep["ms_per_request"]}
        if "jobs" in phases:
            torch.cuda.empty_cache()
            for rep in run_jobs(torch, kernels_of, card):
                emit({"phase": "jobs", "ok": True, **rep})
                if "launches" in rep:
                    count("jobs", rep["launches"], rep["launches_by_route"])
        if "cli" in phases:
            torch.cuda.empty_cache()
            for rep in run_cli(torch, cfg, params, kernels_of, engine_tokens, card):
                emit({"phase": "cli", "ok": True, **rep})
                if "launches" in rep:
                    count("cli", rep["launches"], rep["launches_by_route"])
        if "multinode" in phases:
            torch.cuda.empty_cache()
            for rep in run_multinode(torch, cfg, params, engine_tokens, engine_nums, dag_nums,
                                     card):
                emit({"phase": "multinode", "ok": True, **rep})
                if "launches" in rep:
                    count("multinode", rep["launches"], rep["launches_by_route"])
        del params
        torch.cuda.empty_cache()
    if "data" in phases:
        rep = data_on_ramp(torch, kernels_of, card)
        emit({"phase": "data", "ok": True, **rep})
        for n, routes in zip(rep["launches_per_step"], rep["launches_by_route_per_step"]):
            count("data", n, routes)
        emit({"phase": "data", "ok": True, **run_data_pipeline(torch, card)})
    if "dag" in phases:
        rep = run_dag_gang(torch, kernels_of, card)
        emit({"phase": "dag", "ok": True, **rep})
        count("dag", rep["launches"], rep["launches_by_route"])
        emit({"phase": "dag", "ok": True, "card": card, "seconds": time.perf_counter() - t_dag})
        torch.cuda.empty_cache()
    if "tp_serve" in phases:
        for rep in run_tp_serve(torch, card):
            emit({"phase": "tp_serve", "ok": True, **rep})
            if "launches" in rep:
                count("tp_serve", rep["launches"], {})
    if phases & {"train_parity", "train", "profile"}:
        cfg = train_config(torch)
        from ray_tpu_torch.models.transformer import init_params

        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        if "train_parity" in phases:
            rep = train_parity(torch, cfg, params)
            emit({"phase": "train_parity", "ok": True, "card": card, **rep})
            torch.cuda.empty_cache()
        if "profile" in phases:
            rep = profile_train_step(torch, cfg, params)  # updates params in place
            emit({"phase": "profile", "ok": True, "card": card, **rep})
            params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        if "train" in phases:
            rep = run_train(torch, cfg, params, attention_kernels)
            train_step_ms = rep["step_ms_median"]
        del params
        torch.cuda.empty_cache()
        if "train" in phases:
            # the resume check at CUT_LAYERS: 2.4 GB of state, not 7.2
            cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
            resume = run_train(torch, cut, init_params(cut, torch.Generator(device="cuda")
                                                       .manual_seed(0)),
                               attention_kernels, steps=3, resume_after=2)
            emit({"phase": "train", "ok": True, "card": card, **rep,
                  "resume": {"layers": CUT_LAYERS, **resume}})
            for r in (rep, resume):
                for n, routes in zip(r["launches_per_step"], r["launches_by_route_per_step"]):
                    count("train", n, routes)
            torch.cuda.empty_cache()
    if phases & {"moe_parity", "moe_engine"}:
        cfg = moe_config(torch)
        from ray_tpu_torch.models.transformer import init_params

        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for _, p in named_leaves(params))
        init_s = time.perf_counter() - t0
        if "moe_parity" in phases:
            rep = forward_parity(torch, dataclasses.replace(cfg, dtype=torch.float32), params)
            emit({"phase": "moe_parity", "ok": True, "card": card, "params": n_params,
                  "init_s": init_s, **rep})
            torch.cuda.empty_cache()
        if "moe_engine" in phases:
            for run in run_engines(torch, cfg, params, kernels_of):
                emit({"phase": "moe_engine", "ok": True, "card": card, "params": n_params,
                      "num_experts": cfg.num_experts, "expert_top_k": cfg.expert_top_k, **run})
                count("moe_engine", run["launches"], run["launches_by_route"])
        del params
        torch.cuda.empty_cache()
    if "vit_train" in phases:
        rep = run_vit_train(torch, vit_config(torch), attention_kernels)
        emit({"phase": "vit_train", "ok": True, "card": card, **rep})
        for routes in rep["launches_by_route_per_step"]:
            count("vit_train", {n: sum(r.values()) for n, r in routes.items()}, routes)
        torch.cuda.empty_cache()
    if "dit" in phases:
        rep = run_dit(torch, dit_config(torch))
        emit({"phase": "dit", "ok": True, "card": card, **rep})
    shard_shapes = {}  # the parallel phase's (a): {shape: {kernel: numbers}}
    if "parallel" in phases:
        t0 = time.perf_counter()
        for rep in run_parallel(torch):
            emit({"phase": "parallel", "ok": True, "card": card, **rep})
            shard_shapes.update(rep.get("shard_shapes", {}))
            for r in rep.get("ranks", []):
                if "launches_per_step" in r:
                    for n, routes in zip(r["launches_per_step"], r["launches_by_route_per_step"]):
                        count("parallel", n, routes)
                else:
                    count("parallel", r["launches"], r["launches_by_route"])
        emit({"phase": "parallel", "ok": True, "card": card,
              "seconds": time.perf_counter() - t0})
    if "trainer" in phases:
        t0 = time.perf_counter()
        for rep in run_trainer(torch, attention_kernels, card, train_step_ms):
            emit({"phase": "trainer", "ok": True, **rep})
            if "launches" in rep:
                count("trainer", rep["launches"], rep["launches_by_route"])
        emit({"phase": "trainer", "ok": True, "card": card,
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    if "tune" in phases:
        t0 = time.perf_counter()
        for rep in run_tune(torch, attention_kernels, card, train_step_ms):
            emit({"phase": "tune", "ok": True, **rep})
            if "launches" in rep:
                count("tune", rep["launches"], rep["launches_by_route"])
        emit({"phase": "tune", "ok": True, "card": card, "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    if kernels:
        # the K3 entry's ms/bound are its serving prefill shape; train_* keys
        # hold the same numbers at the train step's shape, vit_* (K3, K4,
        # K5) at the ViT train step's. K6's are its w1
        # decode shape, with prefill_* at a prompt-64 prefill beside them.
        # K1's and K2's are the serving decode shape, warm, with each timed
        # shape (main, long, wide) cold and warm in timed_shapes.
        emit({"kernels": [
            {"name": n, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
             "launches": launches.get(n), "launches_by_path": by_path.get(n),
             "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"],
             **{k: x for k, x in r.items()
                if k.startswith(("train_", "prefill_", "vit_"))
                and not k.endswith(("_shape", "_call"))},
             # K1/K2: the event floor, the main shape cold, every timed shape
             **{k: r[k] for k in ("event_floor_ms", "cold_ms", "timed_shapes") if k in r},
             # K3/K4/K5 at the parallel meshes' shard shapes
             **{f"parallel_{shape}_{k}": x for shape, per in shard_shapes.items()
                if n in per for k, x in {"shape": per["shape"], **per[n]}.items()},
             # K3-K6: each route's worst error and its launches on the main path
             **({"by_route": {rt: {**e, "launches": by_route.get(n, {}).get(rt)}
                              for rt, e in r["by_route"].items()}} if "by_route" in r else {})}
            for n, r in kernels.items()
        ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
